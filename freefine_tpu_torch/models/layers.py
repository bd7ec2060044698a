"""Building blocks of the SD UNet / VAE in PyTorch (mirrors
`freefine_tpu.models.layers`).

Parameter names are the diffusers state-dict keys.  Convolution stacks run
in NCHW; transformer blocks on [B, S, C] tokens (row-major over H, W, as
the JAX package's NHWC reshape).  Linear/conv weights live in the serving
dtype; norm parameters are float32 and the norms compute in float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.edit import TCA_SCOPE, EditConfig, EditState
from freefine_tpu_torch.ops import attention as attn_ops
from freefine_tpu_torch.ops.group_norm import group_norm_reference, group_norm_silu_diff, use_fused


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers `get_timestep_embedding`),
    always float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin], -1) if flip_sin_to_cos else torch.cat([sin, cos], -1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class GroupNorm32(nn.Module):
    """GroupNorm with float32 statistics, optional fused SiLU, output in the
    input dtype.  NCHW input.  Where `use_fused` selects it
    (FREEFINE_FUSED_GN; by default on a CUDA tensor) the norm is the
    `group_norm_silu` kernel (differentiable through `GroupNormSiLU`), else
    the two-pass `group_norm_reference` math, as JAX's GroupNorm32 routes."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        kw = dict(num_groups=self.num_groups, eps=self.eps, apply_silu=silu)
        if use_fused(x.shape, self.num_groups, x.device):
            return group_norm_silu_diff(x, self.weight, self.bias, **kw)
        return group_norm_reference(x, self.weight, self.bias, **kw)


class LayerNorm32(nn.Module):
    """LayerNorm in float32 (eps 1e-5), output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class RMSNorm(nn.Module):
    """T5's scale-only norm in float32 (weight float32), output in the
    input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        return (self.weight * x32 / torch.sqrt(var + self.eps)).to(x.dtype)


class LayerScale(nn.Module):
    """DINOv2's per-channel residual scale `gamma` (float32), output in the
    input dtype (JAX multiplies by the float32 parameter)."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * self.gamma).to(x.dtype)


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of an NCHW map in float32 (EfficientSAM's neck),
    output in the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(1, keepdim=True)
        var = (xf - mu).square().mean(1, keepdim=True)
        y = (xf - mu) / torch.sqrt(var + self.eps)
        return (y * self.weight[:, None, None] + self.bias[:, None, None]).to(x.dtype)


class PlainGroupNorm(nn.Module):
    """GroupNorm of an NCHW map in float32 by `F.group_norm`, output in the
    input dtype: flax's `nn.GroupNorm`, which the JAX package leaves to XLA
    (EfficientSAM's decoder), so no kernel of the port's either."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype)


class FrozenBatchNorm2d(nn.Module):
    """Inference-mode BatchNorm of an NCHW map: (x - running_mean) /
    sqrt(running_var + eps) * weight + bias in float32, output in the input
    dtype, whatever the module's train/eval mode.  Its tensors are
    BatchNorm2d's but for `num_batches_tracked`, which inference never
    reads (U^2-Net's `bn_s1`)."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, dtype=torch.float32, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, dtype=torch.float32, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = (1, -1, 1, 1)
        y = (x.float() - self.running_mean.reshape(c)) / torch.sqrt(
            self.running_var.reshape(c) + self.eps)
        return (y * self.weight.reshape(c) + self.bias.reshape(c)).to(x.dtype)


# the norms (and DINOv2's LayerScale) whose weight `weights.random_weights`
# fills with 1
NORM_TYPES = (GroupNorm32, LayerNorm32, RMSNorm, LayerScale, LayerNorm2d, PlainGroupNorm,
              FrozenBatchNorm2d)


class TimestepEmbedding(nn.Module):
    """time_proj + time_embedding MLP (Linear / SiLU / Linear)."""

    def __init__(self, base_dim: int, embed_dim: int, flip_sin_to_cos: bool,
                 freq_shift: float, dtype, device=None):
        super().__init__()
        self.base_dim, self.flip_sin_to_cos, self.freq_shift = base_dim, flip_sin_to_cos, freq_shift
        self.linear_1 = nn.Linear(base_dim, embed_dim, dtype=dtype, device=device)
        self.linear_2 = nn.Linear(embed_dim, embed_dim, dtype=dtype, device=device)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        emb = timestep_embedding(
            timesteps, self.base_dim, self.flip_sin_to_cos, self.freq_shift
        ).to(self.linear_1.weight.dtype)
        return self.linear_2(F.silu(self.linear_1(emb)))


class ResnetBlock2D(nn.Module):
    """SD ResnetBlock2D: GN/SiLU/Conv x2 with optional timestep injection.

    fused_silu=True applies SiLU inside the f32 norm (UNet); False applies
    it after the cast back to the compute dtype (VAE), as the JAX modules
    do."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int], groups: int,
                 eps: float, fused_silu: bool, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.fused_silu = fused_silu
        self.norm1 = GroupNorm32(groups, in_ch, eps, device)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, **kw)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch, **kw) if temb_ch else None
        self.norm2 = GroupNorm32(groups, out_ch, eps, device)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, **kw)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1, **kw) if in_ch != out_ch else None

    def _norm_act(self, norm: GroupNorm32, x: torch.Tensor) -> torch.Tensor:
        return norm(x, silu=True) if self.fused_silu else F.silu(norm(x))

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self._norm_act(self.norm1, x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self._norm_act(self.norm2, h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv.  pad_mode 'symmetric' pads (1, 1) (UNet, torch
    Conv2d(padding=1)); 'right' pads (0, 1) before a VALID conv (VAE)."""

    def __init__(self, ch: int, pad_mode: str, dtype, device=None):
        super().__init__()
        self.pad_mode = pad_mode
        pad = 1 if pad_mode == "symmetric" else 0
        self.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=pad, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_mode == "right":
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv."""

    def __init__(self, ch: int, dtype, device=None):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class GEGLU(nn.Module):
    def __init__(self, dim: int, out_dim: int, dtype, device=None):
        super().__init__()
        self.proj = nn.Linear(dim, out_dim * 2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        value, gate = self.proj(x).chunk(2, dim=-1)
        # flax nn.gelu defaults to the tanh approximation
        return value * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype, device=None):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(dim, dim * 4, dtype, device),
            nn.Identity(),
            nn.Linear(dim * 4, dim, dtype=dtype, device=device),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class EditAttention(nn.Module):
    """One attention layer (to_q/to_k/to_v, with bias where `qkv_bias`: the
    DiT's; to_out.0) with the edit dispatch: self-attention through
    `edit_self_attention`, text cross-attention through
    `edit_cross_attention`.  Under `edit_cfg.store_kv` (the
    shared-reference capture pass, batch 1) each self-attention that TCA
    would modulate writes its (k, v) [S, E] into `edit_state.ref_kv` under
    its block index.  Under `edit_cfg.store_attention` / `sow_token_attn`
    it adds its maps to `edit_state.intermediates` under (`path`..., name);
    the backbone sets `path` to the layer's module path.  A cross-attention
    given IP-Adapter layers (`add_ip_layers`) adds, where
    `edit_cfg.ip_scale > 0`, ip_scale * attention over the image tokens
    `context_image` through its own to_k_ip / to_v_ip, before to_out."""

    def __init__(self, dim: int, context_dim: int, heads: int, is_cross: bool, dtype,
                 device=None, qkv_bias: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.heads, self.is_cross = heads, is_cross
        self.path: tuple = ()
        self.to_q = nn.Linear(dim, dim, bias=qkv_bias, **kw)
        self.to_k = nn.Linear(context_dim, dim, bias=qkv_bias, **kw)
        self.to_v = nn.Linear(context_dim, dim, bias=qkv_bias, **kw)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim, **kw)])
        self.to_k_ip = self.to_v_ip = None

    def add_ip_layers(self, image_dim: int) -> None:
        """IP-Adapter's decoupled K/V projections of the image tokens
        (bias-free, the layer's dtype and device, weights zero until
        loaded)."""
        if not self.is_cross:
            raise ValueError("IP-Adapter layers belong to a cross-attention")
        w = self.to_q.weight
        dim = w.shape[0]
        self.to_k_ip = nn.Linear(image_dim, dim, bias=False, dtype=w.dtype, device=w.device)
        self.to_v_ip = nn.Linear(image_dim, dim, bias=False, dtype=w.dtype, device=w.device)
        nn.init.zeros_(self.to_k_ip.weight)
        nn.init.zeros_(self.to_v_ip.weight)

    def forward(self, x, context=None, *, edit_cfg: EditConfig,
                edit_state: Optional[EditState], block_index: int, place: str,
                context_extra: Optional[torch.Tensor] = None,
                context_image: Optional[torch.Tensor] = None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if (edit_cfg.store_kv and not self.is_cross and place in TCA_SCOPE
                and edit_cfg.block_gated(block_index)):
            edit_state.ref_kv[block_index] = (k[0], v[0])
        if edit_cfg.store_attention and q.shape[1] <= 32 * 32:
            edit_state.intermediates.setdefault(self.path + ("attn_probs",), []).append(
                attn_ops.attention_probs(q, k, self.heads))
        if (self.is_cross and edit_cfg.sow_token_attn and edit_state is not None
                and edit_state.token_select is not None):
            edit_state.intermediates.setdefault(self.path + (f"token_attn_{place}",), []).append(
                attn_ops.token_attention_maps(q, k, self.heads, edit_state.token_select))
        if self.is_cross:
            k_extra = v_extra = None
            if context_extra is not None:  # compose region prompts [P, L, D]
                k_extra, v_extra = self.to_k(context_extra), self.to_v(context_extra)
            h = attn_ops.edit_cross_attention(q, k, v, self.heads, edit_cfg, edit_state,
                                              k_extra=k_extra, v_extra=v_extra)
            if edit_cfg.ip_scale > 0:
                if context_image is None or self.to_k_ip is None:
                    raise ValueError("ip_scale > 0 needs context_image tokens and the "
                                     "IP-Adapter layers (models.ip_adapter.add_ip_adapter)")
                img = context_image.to(q.dtype)
                h = h + edit_cfg.ip_scale * attn_ops.sdpa(q, self.to_k_ip(img),
                                                          self.to_v_ip(img), self.heads)
        else:
            h = attn_ops.edit_self_attention(
                q, k, v, self.heads, edit_cfg, edit_state, block_index, place
            )
        return self.to_out[0](h)


class BasicTransformerBlock(nn.Module):
    """Self-attn + cross-attn + GEGLU feed-forward with pre-LayerNorms."""

    def __init__(self, dim: int, context_dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.norm1 = LayerNorm32(dim, device=device)
        self.attn1 = EditAttention(dim, dim, heads, False, dtype, device)
        self.norm2 = LayerNorm32(dim, device=device)
        self.attn2 = EditAttention(dim, context_dim, heads, True, dtype, device)
        self.norm3 = LayerNorm32(dim, device=device)
        self.ff = FeedForward(dim, dtype, device)

    def forward(self, x, context, *, edit_cfg, edit_state, block_index, place,
                context_extra=None, context_image=None):
        kw = dict(edit_cfg=edit_cfg, edit_state=edit_state, block_index=block_index,
                  place=place)
        x = x + self.attn1(self.norm1(x), **kw)
        x = x + self.attn2(self.norm2(x), context, context_extra=context_extra,
                           context_image=context_image, **kw)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GN -> proj_in -> depth x block -> proj_out +
    skip.  The projections are 1x1 convolutions (SD-1.5) or, with
    use_linear (SDXL, SD-2.x), Linear layers on the tokens.  Block d gets
    block_index + d."""

    def __init__(self, ch: int, context_dim: int, heads: int, groups: int, depth: int,
                 dtype, device=None, use_linear: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.use_linear = use_linear
        self.norm = GroupNorm32(groups, ch, 1e-6, device)
        self.proj_in = nn.Linear(ch, ch, **kw) if use_linear else nn.Conv2d(ch, ch, 1, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(ch, context_dim, heads, dtype, device) for _ in range(depth)
        ])
        self.proj_out = nn.Linear(ch, ch, **kw) if use_linear else nn.Conv2d(ch, ch, 1, **kw)

    def forward(self, x, context, *, edit_cfg, edit_state, block_index, place,
                context_extra=None, context_image=None):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if self.use_linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for d, blk in enumerate(self.transformer_blocks):
            h = blk(h, context, edit_cfg=edit_cfg, edit_state=edit_state,
                    block_index=block_index + d, place=place, context_extra=context_extra,
                    context_image=context_image)
        if self.use_linear:
            return self.proj_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2) + x
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj_out(h) + x
