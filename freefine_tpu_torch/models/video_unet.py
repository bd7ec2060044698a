"""SV3D_p's video UNet in PyTorch (mirrors `freefine_tpu.models.video_unet`).

The denoiser of the SV3D coarse 3D edit: in 8 channels (the noisy latent
and the conditioning frame's latent), 320 base channels, mult (1, 2, 4, 4),
2 res blocks a level, attention at the three finest levels and in the mid
block with heads of 64, a 1024-d CLIP image context, 1280-d vector
conditioning added to the timestep embedding, and temporal mixing after
every spatial res block and transformer:

  * `VideoResBlock` — a spatial ResBlock, then a temporal ResBlock whose
    (3, 1, 1) convolutions run over the frames and whose GroupNorms reduce
    over all frames of a clip at once, blended by `AlphaBlender`;
  * `VideoSpatialTransformer` — a spatial transformer (self-attention
    through `ops.attention.masked_sdpa`, so the `flash_sdpa` kernel on the
    card; cross-attention to the one CLIP token as plain math), then
    `TemporalAttentionBlock`, a per-pixel transformer over the frames with
    a frame-position embedding, blended the same way.

Module names and tensor shapes are the sgm checkpoint's
(`model.diffusion_model.*` of sv3d_p.safetensors: `input_blocks.i.j`,
`in_layers` / `emb_layers` / `out_layers`, `time_stack`,
`time_mixer.mix_factor`, `time_pos_embed`, `label_emb.0.0`, `out.0`; the
temporal convolutions keep their 5-D [out, in, 3, 1, 1] weights), so the
published file loads with `load_state_dict`.

The forward takes and returns NHWC [B*T, H, W, C] frames, as the JAX
module does; inside, the convolutions run on the channels-last NCHW view
of that memory.  Folding the frames into the rows of a channels-last
tensor ([B*T, H, W, C] -> [B, T*H, W, C]) is a view, so the temporal
GroupNorms reach the `group_norm_silu` kernel without a copy.
Norms are float32; SiLU follows each norm after the cast back to the
compute dtype, as in the JAX module.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.layers import FeedForward, GroupNorm32, LayerNorm32, timestep_embedding
from freefine_tpu_torch.ops.attention import masked_sdpa, sdpa


@dataclasses.dataclass(frozen=True)
class VideoUNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_levels: Tuple[bool, ...] = (True, True, True, False)
    num_head_channels: int = 64
    context_dim: int = 1024
    adm_in_channels: int = 1280
    num_frames: int = 21
    norm_num_groups: int = 32
    dtype: torch.dtype = torch.bfloat16


def sv3d_config() -> VideoUNetConfig:
    """SV3D_p (sv3d_p.yaml): 21 frames at a 72^2 latent, bf16."""
    return VideoUNetConfig()


class AlphaBlender(nn.Module):
    """Learned spatial/temporal blend: a * spatial + (1 - a) * temporal with
    a = sigmoid(mix_factor) (sgm's "learned_with_images" on video frames)."""

    def __init__(self, device=None):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.zeros(1, dtype=torch.float32, device=device))

    def forward(self, spatial: torch.Tensor, temporal: torch.Tensor) -> torch.Tensor:
        a = torch.sigmoid(self.mix_factor[0]).to(spatial.dtype)
        return a * spatial + (1.0 - a) * temporal


def _to_frames(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """An NCHW tensor's memory in NHWC order, reshaped to `shape` (C last) and
    returned as the NCHW view of that: a view where x is channels-last."""
    return x.permute(0, 2, 3, 1).reshape(*shape).permute(0, 3, 1, 2)


class TemporalResBlock(nn.Module):
    """sgm's ResBlock with dims=3 over [B, C, T, H, W]: its GroupNorms reduce
    over (C/g, T, H, W) jointly, its convolutions have (3, 1, 1) kernels
    with padding (1, 0, 0) over the frames, its skip is the identity."""

    def __init__(self, channels: int, temb_ch: int, num_frames: int, groups: int, dtype,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_frames = num_frames
        self.in_layers = nn.ModuleList([
            GroupNorm32(groups, channels, 1e-5, device), nn.SiLU(),
            nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0), **kw)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), nn.Linear(temb_ch, channels, **kw)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(groups, channels, 1e-5, device), nn.SiLU(), nn.Identity(),
            nn.Conv3d(channels, channels, (3, 1, 1), padding=(1, 0, 0), **kw)])

    def _norm(self, norm: GroupNorm32, y: torch.Tensor) -> torch.Tensor:
        """GroupNorm of frames y [B*T, C, H, W] with statistics over each
        clip's T frames: the frames folded into the rows, [B, C, T*H, W]."""
        bt, c, h, w = y.shape
        rows = _to_frames(y, bt // self.num_frames, self.num_frames * h, w, c)
        return _to_frames(norm(rows), bt, h, w, c)

    def _conv(self, conv: nn.Conv3d, y: torch.Tensor) -> torch.Tensor:
        """The (3, 1, 1) convolution of frames y [B*T, C, H, W] over T: a
        (3, 1) convolution of the [B, C, T, H*W] view with the 5-D weight's
        [out, in, 3, 1] slice (the same function)."""
        bt, c, h, w = y.shape
        t = self.num_frames
        out = F.conv2d(_to_frames(y, bt // t, t, h * w, c), conv.weight[..., 0], conv.bias,
                       padding=(1, 0))
        return _to_frames(out, bt, h, w, out.shape[1])

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        y = self._conv(self.in_layers[2], F.silu(self._norm(self.in_layers[0], x)))
        y = y + self.emb_layers[1](F.silu(temb))[:, :, None, None]
        y = self._conv(self.out_layers[3], F.silu(self._norm(self.out_layers[0], y)))
        return x + y


class VideoResBlock(nn.Module):
    """Spatial ResBlock (GN/SiLU/conv twice, the timestep projection added
    between, a 1x1 skip where the channels change), then `time_stack` (a
    `TemporalResBlock`) blended with it by `time_mixer`."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int, num_frames: int, groups: int,
                 dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.in_layers = nn.ModuleList([
            GroupNorm32(groups, in_ch, 1e-5, device), nn.SiLU(),
            nn.Conv2d(in_ch, out_ch, 3, padding=1, **kw)])
        self.emb_layers = nn.ModuleList([nn.SiLU(), nn.Linear(temb_ch, out_ch, **kw)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(groups, out_ch, 1e-5, device), nn.SiLU(), nn.Identity(),
            nn.Conv2d(out_ch, out_ch, 3, padding=1, **kw)])
        self.skip_connection = nn.Conv2d(in_ch, out_ch, 1, **kw) if in_ch != out_ch else None
        self.time_stack = TemporalResBlock(out_ch, temb_ch, num_frames, groups, dtype, device)
        self.time_mixer = AlphaBlender(device)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[2](F.silu(self.in_layers[0](x)))
        h = h + self.emb_layers[1](F.silu(temb))[:, :, None, None]
        h = self.out_layers[3](F.silu(self.out_layers[0](h)))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        spatial = x + h
        return self.time_mixer(spatial, self.time_stack(spatial, temb))


class Attention(nn.Module):
    """to_q / to_k / to_v (bias-free) and to_out.0 of one attention layer."""

    def __init__(self, dim: int, context_dim: int, heads: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False, **kw)
        self.to_k = nn.Linear(context_dim, dim, bias=False, **kw)
        self.to_v = nn.Linear(context_dim, dim, bias=False, **kw)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim, **kw)])


class SpatialBlock(nn.Module):
    """transformer_blocks.0: self-attention over a frame's H*W tokens
    (`masked_sdpa`: the `flash_sdpa` kernel on the card), cross-attention
    to the frame's CLIP token (plain math, as JAX's `sdpa`), GEGLU
    feed-forward, each behind a LayerNorm."""

    def __init__(self, dim: int, context_dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.norm1 = LayerNorm32(dim, device=device)
        self.attn1 = Attention(dim, dim, heads, dtype, device)
        self.norm2 = LayerNorm32(dim, device=device)
        self.attn2 = Attention(dim, context_dim, heads, dtype, device)
        self.norm3 = LayerNorm32(dim, device=device)
        self.ff = FeedForward(dim, dtype, device)

    def forward(self, h: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        a = self.attn1
        y = self.norm1(h)
        h = h + a.to_out[0](masked_sdpa(a.to_q(y), a.to_k(y), a.to_v(y), a.heads))
        a = self.attn2
        y = self.norm2(h)
        h = h + a.to_out[0](sdpa(a.to_q(y), a.to_k(context), a.to_v(context), a.heads))
        return h + self.ff(self.norm3(h))


class TemporalAttentionBlock(nn.Module):
    """time_stack.0, sgm's VideoTransformerBlock as SV3D configures it, over
    per-pixel sequences of the T frames: GEGLU `ff_in` with a residual,
    temporal self-attention, temporal cross-attention to the clip's
    conditioning-frame context, GEGLU feed-forward, each behind a
    LayerNorm.  Self-attention over T keys is plain math, as JAX's `sdpa`.
    The cross-attention has one key, so its softmax is exactly 1 and its
    output is to_out(to_v(context)) for every query: computed once a clip
    and broadcast, which is the same function as attending to the context
    repeated per pixel."""

    def __init__(self, dim: int, context_dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.norm_in = LayerNorm32(dim, device=device)
        self.ff_in = FeedForward(dim, dtype, device)
        self.norm1 = LayerNorm32(dim, device=device)
        self.attn1 = Attention(dim, dim, heads, dtype, device)
        self.norm2 = LayerNorm32(dim, device=device)
        self.attn2 = Attention(dim, context_dim, heads, dtype, device)
        self.norm3 = LayerNorm32(dim, device=device)
        self.ff = FeedForward(dim, dtype, device)

    def forward(self, xt: torch.Tensor, time_context: torch.Tensor) -> torch.Tensor:
        """xt [B*S, T, C] (frame positions added), time_context [B, 1, ctx]."""
        xt = xt + self.ff_in(self.norm_in(xt))
        a = self.attn1
        y = self.norm1(xt)
        xt = xt + a.to_out[0](sdpa(a.to_q(y), a.to_k(y), a.to_v(y), a.heads))
        a = self.attn2
        cross = a.to_out[0](a.to_v(time_context))  # [B, 1, C]
        b = time_context.shape[0]
        xt = (xt.reshape(b, -1, *xt.shape[1:]) + cross[:, None]).reshape(xt.shape)
        return xt + self.ff(self.norm3(xt))


class VideoSpatialTransformer(nn.Module):
    """sgm's SpatialVideoTransformer (depth 1, linear projections): GroupNorm,
    proj_in, the spatial block; the temporal block over each pixel's
    frames after the frame-position MLP `time_pos_embed`; blended by
    `time_mixer`; proj_out; the residual."""

    def __init__(self, ch: int, heads: int, context_dim: int, num_frames: int, groups: int,
                 dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_frames = num_frames
        self.norm = GroupNorm32(groups, ch, 1e-6, device)
        self.proj_in = nn.Linear(ch, ch, **kw)
        self.transformer_blocks = nn.ModuleList([SpatialBlock(ch, context_dim, heads, dtype,
                                                              device)])
        self.time_stack = nn.ModuleList([TemporalAttentionBlock(ch, context_dim, heads, dtype,
                                                                device)])
        self.time_pos_embed = nn.Sequential(nn.Linear(ch, 4 * ch, **kw), nn.SiLU(),
                                            nn.Linear(4 * ch, ch, **kw))
        self.time_mixer = AlphaBlender(device)
        self.proj_out = nn.Linear(ch, ch, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        bt, c, hh, ww = x.shape
        t, s = self.num_frames, hh * ww
        b = bt // t
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(bt, s, c))
        h = self.transformer_blocks[0](h, context)
        xt = h.reshape(b, t, s, c).transpose(1, 2).reshape(b * s, t, c)
        pos = timestep_embedding(torch.arange(t, device=x.device), c).to(h.dtype)
        xt = self.time_stack[0](xt + self.time_pos_embed(pos)[None],
                                context.reshape(b, t, *context.shape[1:])[:, 0])
        temporal = xt.reshape(b, s, t, c).transpose(1, 2).reshape(bt, s, c)
        h = self.proj_out(self.time_mixer(h, temporal))
        return x + h.reshape(bt, hh, ww, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    """Stride-2 3x3 conv padded (1, 1) (`op`)."""

    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x upsample (an integer scale, where torch's "nearest" is
    JAX's) + 3x3 conv (`conv`)."""

    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VideoUNet(nn.Module):
    """SV3D video UNet.

    sample  [B*T, H, W, in]  noisy latent ++ conditioning-frame latent
    t_cont  [B*T]            continuous noise level (EDM c_noise)
    context [B*T, 1, ctx]    CLIP image token per frame
    y       [B*T, adm]       vector conditioning (cond_aug, polar, azimuth)
    -> [B*T, H, W, out] in the config's dtype."""

    def __init__(self, config: VideoUNetConfig, device=None):
        super().__init__()
        self.config = cfg = config
        kw = dict(dtype=cfg.dtype, device=device)
        ch0, t, g = cfg.model_channels, cfg.num_frames, cfg.norm_num_groups
        temb = 4 * ch0

        def res(cin, cout):
            return VideoResBlock(cin, cout, temb, t, g, cfg.dtype, device)

        def attn(ch):
            return VideoSpatialTransformer(ch, ch // cfg.num_head_channels, cfg.context_dim, t,
                                           g, cfg.dtype, device)

        self.time_embed = nn.Sequential(nn.Linear(ch0, temb, **kw), nn.SiLU(),
                                        nn.Linear(temb, temb, **kw))
        self.label_emb = nn.Sequential(nn.Sequential(
            nn.Linear(cfg.adm_in_channels, temb, **kw), nn.SiLU(), nn.Linear(temb, temb, **kw)))
        self.input_blocks = nn.ModuleList([nn.ModuleList([
            nn.Conv2d(cfg.in_channels, ch0, 3, padding=1, **kw)])])
        n = len(cfg.channel_mult)
        ch, skips = ch0, [ch0]
        for lvl, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, ch0 * mult)]
                ch = ch0 * mult
                if cfg.attention_levels[lvl]:
                    layers.append(attn(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                skips.append(ch)
            if lvl < n - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch, cfg.dtype, device)]))
                skips.append(ch)
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for lvl in reversed(range(n)):
            for j in range(cfg.num_res_blocks + 1):
                layers = [res(ch + skips.pop(), ch0 * cfg.channel_mult[lvl])]
                ch = ch0 * cfg.channel_mult[lvl]
                if cfg.attention_levels[lvl]:
                    layers.append(attn(ch))
                if lvl > 0 and j == cfg.num_res_blocks:
                    layers.append(Upsample(ch, cfg.dtype, device))
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.ModuleList([GroupNorm32(g, ch, 1e-5, device), nn.SiLU(),
                                  nn.Conv2d(ch, cfg.out_channels, 3, padding=1, **kw)])

    @staticmethod
    def _run(block: nn.ModuleList, h, temb, context):
        for layer in block:
            if isinstance(layer, VideoResBlock):
                h = layer(h, temb)
            elif isinstance(layer, VideoSpatialTransformer):
                h = layer(h, context)
            else:
                h = layer(h)
        return h

    def forward(self, sample, t_cont, context, y) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        x = sample.to(dt).permute(0, 3, 1, 2)
        context = context.to(dt)
        temb = self.time_embed(timestep_embedding(t_cont, cfg.model_channels).to(dt))
        temb = temb + self.label_emb(y.to(dt))
        h = self.input_blocks[0][0](x)
        hs = [h]
        for block in self.input_blocks[1:]:
            h = self._run(block, h, temb, context)
            hs.append(h)
        h = self._run(self.middle_block, h, temb, context)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), temb, context)
        h = self.out[2](F.silu(self.out[0](h)))
        return h.permute(0, 2, 3, 1)
