"""The PixArt-α DiT editing backbone in PyTorch (mirrors
`freefine_tpu.models.dit`).

patchify -> AdaLN-single modulated blocks of self-attention,
cross-attention and feed-forward -> unpatchify.  The attention layers are
the UNet's `EditAttention`, so every editing mechanism (TCA, masked local
CFG, the shared-reference capture, the attention instruments, the
IP-Adapter branch) runs on it unchanged: its self-attentions go through
`edit_self_attention` and so through the `flash_sdpa` and `tca_flash`
kernels.  A DiT has no down / mid / up split: every block reports place
"up", and `EditConfig.layer_range` gates a fraction of the depth.

Module names are diffusers' `PixArtTransformer2DModel` (key manifest
tests/fixtures/pixart_xl2_keys.txt): `pos_embed.proj` (the patchify
conv), `adaln_single.emb.timestep_embedder` and `adaln_single.linear`
(the shared 6·D modulation), `caption_projection.linear_{1,2}`,
`transformer_blocks.{i}` with its `scale_shift_table` [6, D], `attn1`,
`attn2` and `ff.net.{0.proj,2}`, the top-level `scale_shift_table` [2, D]
and `proj_out`.  The 2-D sin-cos position table is computed from numpy in
float64 and is no parameter (diffusers' `pos_embed.pos_embed` buffer is
ignored on load).  The forward takes and returns NCHW, as the UNet does,
so `FreeFine.unet_apply` serves both backbones.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.config import DiTConfig
from freefine_tpu_torch.edit import EditConfig, EditState, none_config
from freefine_tpu_torch.models.layers import EditAttention, TimestepEmbedding


def _sincos_2d(embed_dim: int, grid: int) -> np.ndarray:
    """Fixed 2-D sin-cos position table [grid*grid, embed_dim] float64
    (diffusers `get_2d_sincos_pos_embed` on a square grid): tokens
    row-major, the first half of the channels the column coordinate, the
    second half the row coordinate."""
    pos = np.arange(grid, dtype=np.float64)
    omega = 1.0 / 10000 ** (np.arange(embed_dim // 4) / (embed_dim / 4.0))
    out = np.einsum("p,d->pd", pos, omega)                     # [grid, D/4]
    emb1 = np.concatenate([np.sin(out), np.cos(out)], axis=1)  # [grid, D/2]
    y = np.repeat(emb1, grid, axis=0)                          # row coordinate
    x = np.tile(emb1, (grid, 1))                               # column coordinate
    return np.concatenate([x, y], axis=1)


def _ln(x: torch.Tensor) -> torch.Tensor:
    """Affine-free LayerNorm (eps 1e-6) in float32, output in x's dtype
    (AdaLN supplies the scale and shift)."""
    return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-6).to(x.dtype)


class _GELUProj(nn.Module):
    """diffusers `GELU(approximate="tanh")`: Linear then tanh-GELU."""

    def __init__(self, dim: int, out: int, dtype, device=None):
        super().__init__()
        self.proj = nn.Linear(dim, out, dtype=dtype, device=device)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class DiTBlock(nn.Module):
    """AdaLN-single block: gated self-attention on the modulated norm,
    cross-attention on the un-normed stream (PixArt), gated feed-forward."""

    def __init__(self, dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.scale_shift_table = nn.Parameter(
            torch.randn(6, dim, dtype=torch.float32, device=device) * dim**-0.5)
        self.attn1 = EditAttention(dim, dim, heads, False, dtype, device, qkv_bias=True)
        self.attn2 = EditAttention(dim, dim, heads, True, dtype, device, qkv_bias=True)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([_GELUProj(dim, 4 * dim, dtype, device), nn.Identity(),
                                     nn.Linear(4 * dim, dim, dtype=dtype, device=device)])

    def forward(self, x, context, t6, *, edit_cfg, edit_state, block_index,
                context_extra=None, context_image=None):
        mod = (self.scale_shift_table[None] + t6.float()).to(x.dtype)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            mod[:, i : i + 1] for i in range(6))
        kw = dict(edit_cfg=edit_cfg, edit_state=edit_state, block_index=block_index, place="up")
        x = x + gate_msa * self.attn1(_ln(x) * (1 + scale_msa) + shift_msa, **kw)
        x = x + self.attn2(x, context, context_extra=context_extra,
                           context_image=context_image, **kw)
        h = _ln(x) * (1 + scale_mlp) + shift_mlp
        return x + gate_mlp * self.ff.net[2](self.ff.net[0](h))


class DiT2DCondition(nn.Module):
    """Text-conditioned latent DiT with the UNet's call signature."""

    def __init__(self, config: DiTConfig, device=None):
        super().__init__()
        cfg = self.config = config
        dt, d, p = cfg.dtype, cfg.hidden_size, cfg.patch_size
        kw = dict(dtype=dt, device=device)
        self.pos_embed = nn.Module()
        self.pos_embed.proj = nn.Conv2d(cfg.in_channels, d, p, stride=p, **kw)
        self.adaln_single = nn.Module()
        self.adaln_single.emb = nn.Module()
        self.adaln_single.emb.timestep_embedder = TimestepEmbedding(256, d, True, 0.0, dt, device)
        self.adaln_single.linear = nn.Linear(d, 6 * d, **kw)
        self.caption_projection = nn.Module()
        self.caption_projection.linear_1 = nn.Linear(cfg.cross_attention_dim, d, **kw)
        self.caption_projection.linear_2 = nn.Linear(d, d, **kw)
        self.transformer_blocks = nn.ModuleList(
            [DiTBlock(d, cfg.num_heads, dt, device) for _ in range(cfg.depth)])
        self.scale_shift_table = nn.Parameter(
            torch.randn(2, d, dtype=torch.float32, device=device) * d**-0.5)
        out_c = cfg.out_channels * (2 if cfg.learn_sigma else 1)
        self.proj_out = nn.Linear(d, p * p * out_c, **kw)
        grid = cfg.sample_size // p
        self.register_buffer("pos_table", torch.tensor(_sincos_2d(d, grid), dtype=dt,
                                                       device=device), persistent=False)
        for name, mod in self.named_modules():
            if isinstance(mod, EditAttention):
                mod.path = tuple(name.split("."))

    def _caption(self, z: torch.Tensor) -> torch.Tensor:
        c = self.caption_projection
        return c.linear_2(F.gelu(c.linear_1(z.to(self.config.dtype)), approximate="tanh"))

    def forward(
        self,
        sample: torch.Tensor,
        timestep,
        encoder_hidden_states: torch.Tensor,
        *,
        edit_cfg: EditConfig = none_config(),
        edit_state: Optional[EditState] = None,
        return_features: bool = False,
        context_extra: Optional[torch.Tensor] = None,
        added_cond: Optional[torch.Tensor] = None,
        context_image: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """sample [B, C, H, W] (H = W = sample_size); timestep int, 0-d or
        [B]; context [B, L, cross_attention_dim]; context_extra optional
        [P, L, cross_attention_dim] compose region prompts (through the same
        caption projection); context_image IP-Adapter tokens.  Returns the
        eps half of the projection [B, C_out, H, W] float32."""
        if added_cond is not None:
            raise ValueError("the DiT backbone has no added conditioning")
        if return_features:
            raise NotImplementedError("the DiT backbone has no UNet feature taps")
        cfg = self.config
        dt, d, p = cfg.dtype, cfg.hidden_size, cfg.patch_size
        b, _, hh, ww = sample.shape
        if not hh == ww == cfg.sample_size:
            raise ValueError(f"DiT sample {tuple(sample.shape)} vs sample_size {cfg.sample_size}")
        grid = hh // p
        x = self.pos_embed.proj(sample.to(dt)).flatten(2).transpose(1, 2)   # [B, g*g, D]
        x = x + self.pos_table[None]
        t = torch.as_tensor(timestep, device=sample.device)
        if t.ndim == 0:
            t = t.expand(b)
        temb = self.adaln_single.emb.timestep_embedder(t)
        t6 = self.adaln_single.linear(F.silu(temb)).reshape(b, 6, d)
        ctx = self._caption(encoder_hidden_states)
        if context_extra is not None:
            context_extra = self._caption(context_extra)
        for i, blk in enumerate(self.transformer_blocks):
            x = blk(x, ctx, t6, edit_cfg=edit_cfg, edit_state=edit_state, block_index=i,
                    context_extra=context_extra, context_image=context_image)
        # the final modulation from the raw embedded timestep (no projection)
        fmod = (self.scale_shift_table[None] + temb[:, None].float()).to(dt)
        x = _ln(x) * (1 + fmod[:, 1:2]) + fmod[:, 0:1]
        x = self.proj_out(x)
        out_c = x.shape[-1] // (p * p)
        x = x.reshape(b, grid, grid, p, p, out_c).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(b, out_c, hh, ww)[:, : cfg.out_channels].float()
