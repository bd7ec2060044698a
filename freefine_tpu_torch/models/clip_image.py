"""CLIP image tower in PyTorch (mirrors `freefine_tpu.models.clip_image`).

A ViT: a bias-free patch convolution, a class token, position
embeddings, `ln_pre`, pre-LN blocks of attention and MLP, `ln_post` on the
class token, the visual projection.  Module names are open_clip's
`VisionTransformer` ones (`conv1`, `class_embedding`,
`positional_embedding`, `ln_pre`, `transformer.resblocks.N.{ln_1,
attn.in_proj_weight, attn.in_proj_bias, attn.out_proj, ln_2, mlp.c_fc,
mlp.c_proj}`, `ln_post`, `proj`), the layout of SV3D's conditioner
(sv3d_p.safetensors' `conditioner.embedders.0.open_clip.model.visual.*`)
and of HPSv2.1, which `freefine_tpu.weights.convert_open_clip_vision`
reads.  `clip_vit_h14` (SV3D's and HPSv2.1's ViT-H/14) has exact GELU,
OpenAI's `clip_vit_b32` QuickGELU.  Float32 by default, as the JAX
package configures both; the attention is plain math, as JAX's
`CLIPEncoderLayer`'s (no Pallas kernel there).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.layers import LayerNorm32
from freefine_tpu_torch.models.text_encoder import clip_activation, clip_attention
from freefine_tpu_torch.ops.resize import resize


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    projection_dim: int = 512
    # OpenAI towers use QuickGELU; OpenCLIP-trained ones (ViT-H/14) exact GELU
    activation: str = "quick_gelu"
    dtype: torch.dtype = torch.float32


def clip_vit_b32() -> CLIPVisionConfig:
    return CLIPVisionConfig()


def clip_vit_h14() -> CLIPVisionConfig:
    """OpenCLIP ViT-H/14: 32 layers of 1280, 16 heads, projection 1024,
    exact GELU."""
    return CLIPVisionConfig(patch_size=14, hidden_size=1280, intermediate_size=5120,
                            num_layers=32, num_heads=16, projection_dim=1024,
                            activation="gelu")


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_clip(img_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """uint8 RGB [H, W, 3] -> [1, size, size, 3] float32 on its device: the
    short side resized to `size` by JAX's "bicubic" (Keys' cubic, a = -0.5,
    antialiased when shrinking), a centre crop, CLIP's normalisation."""
    x = img_uint8.float() / 255.0
    h, w = x.shape[:2]
    scale = size / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = resize(x, (nh, nw), "cubic")
    top, left = (nh - size) // 2, (nw - size) // 2
    x = x[top : top + size, left : left + size]
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return ((x - mean) / std)[None]


class _MultiheadAttention(nn.Module):
    """open_clip's `nn.MultiheadAttention` tensors (fused `in_proj_weight`
    [3E, E] and `in_proj_bias`, `out_proj`), computed as JAX's
    `CLIPAttention` does (`clip_attention`, no mask)."""

    def __init__(self, dim: int, heads: int, dtype, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim, dtype=dtype, device=device))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim, dtype=dtype, device=device))
        self.out_proj = nn.Linear(dim, dim, dtype=dtype, device=device)
        nn.init.normal_(self.in_proj_weight, std=0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        return self.out_proj(clip_attention(q, k, v, self.heads))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, device=device)
        self.activation = cfg.activation
        self.ln_1 = LayerNorm32(cfg.hidden_size, device=device)
        self.attn = _MultiheadAttention(cfg.hidden_size, cfg.num_heads, cfg.dtype, device)
        self.ln_2 = LayerNorm32(cfg.hidden_size, device=device)
        self.mlp = nn.Module()
        self.mlp.c_fc = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.mlp.c_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        h = clip_activation(self.mlp.c_fc(self.ln_2(x)), self.activation)
        return x + self.mlp.c_proj(h)


class CLIPImageEncoder(nn.Module):
    """[B, S, S, 3] preprocessed (NHWC) -> [B, projection_dim] image
    features; with `penultimate=True` the token sequence [B, 1 + g^2,
    hidden] that enters the last block (no final LayerNorm; the last block
    does not run)."""

    def __init__(self, config: CLIPVisionConfig, device=None):
        super().__init__()
        self.config = cfg = config
        kw = dict(dtype=cfg.dtype, device=device)
        g = cfg.image_size // cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, stride=cfg.patch_size,
                               bias=False, **kw)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size, **kw))
        self.positional_embedding = nn.Parameter(torch.zeros(g * g + 1, cfg.hidden_size, **kw))
        self.ln_pre = LayerNorm32(cfg.hidden_size, device=device)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(cfg, device) for _ in range(cfg.num_layers)])
        self.ln_post = LayerNorm32(cfg.hidden_size, device=device)
        self.proj = nn.Parameter(torch.zeros(cfg.hidden_size, cfg.projection_dim, **kw))

    def forward(self, x: torch.Tensor, penultimate: bool = False) -> torch.Tensor:
        cfg = self.config
        b = x.shape[0]
        h = self.conv1(x.to(cfg.dtype).permute(0, 3, 1, 2))
        h = h.flatten(2).transpose(1, 2)
        cls = self.class_embedding.to(cfg.dtype).expand(b, 1, -1)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding[None].to(cfg.dtype)
        h = self.ln_pre(h)
        blocks = self.transformer.resblocks
        for block in blocks[:-1]:
            h = block(h)
        if penultimate:
            return h
        h = blocks[-1](h)
        pooled = self.ln_post(h[:, 0])
        return pooled @ self.proj.to(pooled.dtype)
