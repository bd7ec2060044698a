"""DINOv2 ViT (patch 14) in PyTorch (mirrors `freefine_tpu.models.dinov2`).

Patch embedding (a 14x14 stride-14 conv), a class token, position
embeddings (interpolated by torch's bicubic when the patch grid is not the
native 37x37 one), pre-LN blocks of fused-qkv attention and MLP each behind
a LayerScale, a final LayerNorm.  Norms in float32; every block's
attention goes through `ops.attention.masked_sdpa` with no key mask, so the
`flash_sdpa` kernel runs it on the card and its plain twin on the CPU.

Module names are torchhub's facebookresearch/dinov2 ones (`patch_embed.proj`,
`cls_token`, `pos_embed`, `blocks.{i}.{norm1,attn.qkv,attn.proj,ls1.gamma,
norm2,mlp.fc1,mlp.fc2,ls2.gamma}`, `norm`), the layout
`freefine_tpu.weights.convert_dinov2` reads.  The forward takes NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.layers import LayerNorm32, LayerScale
from freefine_tpu_torch.ops.attention import masked_sdpa
from freefine_tpu_torch.ops.resize import interpolate_bicubic


@dataclasses.dataclass(frozen=True)
class DINOv2Config:
    dim: int = 384
    depth: int = 12
    heads: int = 6
    patch_size: int = 14
    mlp_ratio: int = 4
    pos_embed_size: int = 37  # the 518 / 14 grid of the pretrained models
    dtype: torch.dtype = torch.float32


def dinov2_vits14() -> DINOv2Config:
    return DINOv2Config(dim=384, depth=12, heads=6)


def dinov2_vitb14() -> DINOv2Config:
    return DINOv2Config(dim=768, depth=12, heads=12)


def dinov2_vitl14() -> DINOv2Config:
    return DINOv2Config(dim=1024, depth=24, heads=16)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = nn.Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        return self.proj(masked_sdpa(q, k, v, self.heads))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, device=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int, dtype, device=None):
        super().__init__()
        self.norm1 = LayerNorm32(dim, 1e-6, device=device)
        self.attn = Attention(dim, heads, dtype, device)
        self.ls1 = LayerScale(dim, device)
        self.norm2 = LayerNorm32(dim, 1e-6, device=device)
        self.mlp = Mlp(dim, dim * mlp_ratio, dtype, device)
        self.ls2 = LayerScale(dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DINOv2(nn.Module):
    def __init__(self, config: DINOv2Config, device=None):
        super().__init__()
        c = self.config = config
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, c.dim, c.patch_size, stride=c.patch_size,
                                          dtype=c.dtype, device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.dim, dtype=torch.float32,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.zeros(1, c.pos_embed_size**2 + 1, c.dim,
                                                  dtype=torch.float32, device=device))
        self.blocks = nn.ModuleList(Block(c.dim, c.heads, c.mlp_ratio, c.dtype, device)
                                    for _ in range(c.depth))
        self.norm = LayerNorm32(c.dim, 1e-6, device=device)

    def forward(self, x: torch.Tensor, num_intermediate: int = 0):
        """x [B, 3, H, W] with H, W multiples of the patch size.

        num_intermediate == 0: (patch tokens [B, N, C], cls [B, C]) of the
        final normed output.  Otherwise the last `num_intermediate` blocks'
        (patch tokens, cls), each through the final norm (dinov2's
        `get_intermediate_layers(..., norm=True)`)."""
        c = self.config
        b, _, h, w = x.shape
        gh, gw = h // c.patch_size, w // c.patch_size
        tokens = self.patch_embed.proj(x.to(c.dtype)).flatten(2).transpose(1, 2)
        cls_pos, patch_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        if (gh, gw) != (c.pos_embed_size, c.pos_embed_size):
            g = c.pos_embed_size
            grid = interpolate_bicubic(patch_pos.reshape(1, g, g, c.dim), (gh, gw))
            patch_pos = grid.reshape(1, gh * gw, c.dim)
        x = torch.cat([self.cls_token.to(c.dtype).expand(b, -1, -1), tokens], dim=1)
        x = x + torch.cat([cls_pos, patch_pos], dim=1).to(c.dtype)

        outputs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        take_from = c.depth - max(num_intermediate, 0)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if num_intermediate and i >= take_from:
                y = self.norm(x)
                outputs.append((y[:, 1:], y[:, 0]))
        if num_intermediate:
            return outputs
        y = self.norm(x)
        return y[:, 1:], y[:, 0]
