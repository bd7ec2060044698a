"""SD AutoencoderKL in PyTorch (mirrors `freefine_tpu.models.vae`).

Module names are diffusers' (encoder/decoder with down_blocks, mid_block,
up_blocks; quant_conv, post_quant_conv).  NCHW inside; `encode`/`decode`
take and return NHWC as the JAX package's public functions do.  The
mid-block attention runs through `masked_sdpa` (the `flash_sdpa` kernel on
the card) with float32 q/k/v, one head of width C.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.config import VAEConfig
from freefine_tpu_torch.models.layers import Downsample2D, GroupNorm32, ResnetBlock2D, Upsample2D
from freefine_tpu_torch.ops.attention import masked_sdpa


def _resnet(in_ch, out_ch, cfg: VAEConfig, device):
    return ResnetBlock2D(in_ch, out_ch, None, cfg.norm_num_groups, 1e-6, False, cfg.dtype, device)


class VAEAttention(nn.Module):
    """Single-head full self-attention at the VAE bottleneck."""

    def __init__(self, ch: int, groups: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.group_norm = GroupNorm32(groups, ch, 1e-6, device)
        self.to_q = nn.Linear(ch, ch, **kw)
        self.to_k = nn.Linear(ch, ch, **kw)
        self.to_v = nn.Linear(ch, ch, **kw)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = (proj(y).float() for proj in (self.to_q, self.to_k, self.to_v))
        out = masked_sdpa(q, k, v, 1).to(x.dtype)
        out = self.to_out[0](out)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


def _mid_block(ch: int, cfg: VAEConfig, device) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([_resnet(ch, ch, cfg, device) for _ in range(2)])
    mid.attentions = nn.ModuleList([VAEAttention(ch, cfg.norm_num_groups, cfg.dtype, device)])
    return mid


def _run_mid(mid: nn.Module, h: torch.Tensor) -> torch.Tensor:
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        dt = cfg.dtype
        ch = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1, dtype=dt, device=device)
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, out_ch in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(_resnet(prev, out_ch, cfg, device))
                prev = out_ch
            if i < len(ch) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(out_ch, "right", dt, device)])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(ch[-1], cfg, device)
        self.conv_norm_out = GroupNorm32(cfg.norm_num_groups, ch[-1], 1e-6, device)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1, dtype=dt,
                                  device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None):
        super().__init__()
        dt = cfg.dtype
        rev = list(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1, dtype=dt,
                                 device=device)
        self.mid_block = _mid_block(rev[0], cfg, device)
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, out_ch in enumerate(rev):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(_resnet(prev, out_ch, cfg, device))
                prev = out_ch
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(out_ch, dt, device)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm32(cfg.norm_num_groups, rev[-1], 1e-6, device)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1, dtype=dt,
                                  device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """Encoder + decoder with the SD latent scaling convention; encode is
    the deterministic posterior mode (as the reference's editing path)."""

    def __init__(self, config: VAEConfig, device=None):
        super().__init__()
        self.config = config
        c2 = 2 * config.latent_channels
        self.encoder = Encoder(config, device)
        self.decoder = Decoder(config, device)
        self.quant_conv = nn.Conv2d(c2, c2, 1, dtype=config.dtype, device=device)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1,
                                         dtype=config.dtype, device=device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[-1, 1] RGB [B, H, W, 3] -> scaled latents [B, H/8, W/8, 4]
        (model dtype)."""
        h = x.to(self.config.dtype).permute(0, 3, 1, 2)
        moments = self.quant_conv(self.encoder(h))
        mean = moments[:, : self.config.latent_channels]
        return (mean * self.config.scaling_factor).permute(0, 2, 3, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents [B, h, w, 4] -> [-1, 1] RGB [B, H, W, 3]."""
        h = (z / self.config.scaling_factor).to(self.config.dtype).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(h)).permute(0, 2, 3, 1)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float image -> uint8 ((x/2 + 0.5).clamp(0, 1) * 255, rounded)."""
    x = torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
    return torch.round(x * 255.0).to(torch.uint8)


def from_uint8(img: torch.Tensor) -> torch.Tensor:
    """uint8 HWC/BHWC -> [-1, 1] float32 BHWC."""
    x = img.float() / 127.5 - 1.0
    return x[None] if x.ndim == 3 else x
