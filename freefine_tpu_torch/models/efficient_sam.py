"""EfficientSAM (ViT-T/S) in PyTorch (mirrors
`freefine_tpu.models.efficient_sam`): box- or point-prompted masks.

A ViT image encoder with a conv neck, a random-frequency prompt encoder, a
two-way transformer mask decoder, and the predict path with point
rescaling, IoU sorting and torch-bicubic mask upsampling.  The encoder's
global attention goes through `ops.attention.masked_sdpa` with no key mask
(the `flash_sdpa` kernel on the card, its twin on the CPU); the decoder's
two-way attentions (a handful of tokens, head dim 16) are plain math, as
the JAX package leaves them to XLA, and so is the decoder's GroupNorm.

Module names are the reference EfficientSam's state-dict keys, the layout
`freefine_tpu.weights.convert_efficient_sam` reads (`image_encoder.
{patch_embed.proj,pos_embed,blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,
mlp.fc1,mlp.fc2},neck.{0..3}}`, `prompt_encoder.{pe_layer.
positional_encoding_gaussian_matrix,invalid_points,point_embeddings,
bbox_*_embeddings}`, `mask_decoder.{iou_token,mask_tokens,transformer.*,
final_output_upscaling_layers.{i}.{0,1},output_hypernetworks_mlps.{i},
iou_prediction_head}`), so `weights.load_efficient_sam` loads a published
checkpoint as it is.  Images are NCHW in [0, 1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.dinov2 import Attention, Mlp
from freefine_tpu_torch.models.layers import LayerNorm2d, LayerNorm32, PlainGroupNorm
from freefine_tpu_torch.ops.attention import sdpa
from freefine_tpu_torch.ops.resize import interpolate_bicubic, resize


@dataclasses.dataclass(frozen=True)
class EfficientSAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    patch_embed_dim: int = 384      # vits; vitt: 192
    depth: int = 12
    num_heads: int = 6              # vits; vitt: 3
    mlp_ratio: float = 4.0
    neck_dim: int = 256
    decoder_max_points: int = 6
    decoder_depth: int = 2
    decoder_mlp_dim: int = 2048
    decoder_heads: int = 8
    num_multimask_outputs: int = 3
    upscaling_dims: Tuple[int, ...] = (64, 32)
    iou_hidden_dim: int = 256
    dtype: torch.dtype = torch.float32


def efficient_sam_vits() -> EfficientSAMConfig:
    return EfficientSAMConfig(patch_embed_dim=384, num_heads=6)


def efficient_sam_vitt() -> EfficientSAMConfig:
    return EfficientSAMConfig(patch_embed_dim=192, num_heads=3)


class ViTBlock(nn.Module):
    """DINOv2's block without the LayerScales (the same attention and MLP
    modules and names)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, dtype, device=None):
        super().__init__()
        self.norm1 = LayerNorm32(dim, 1e-6, device=device)
        self.attn = Attention(dim, heads, dtype, device)
        self.norm2 = LayerNorm32(dim, 1e-6, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ImageEncoder(nn.Module):
    def __init__(self, config: EfficientSAMConfig, device=None):
        super().__init__()
        c = self.config = config
        dim, p, dt = c.patch_embed_dim, c.patch_size, c.dtype
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, p, stride=p, dtype=dt, device=device)
        # the pretraining grid, 224 / 16 = 14 x 14, and a class slot
        num_pos = (224 // p) ** 2 + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, num_pos, dim, dtype=torch.float32,
                                                  device=device))
        self.blocks = nn.ModuleList(ViTBlock(dim, c.num_heads, c.mlp_ratio, dt, device)
                                    for _ in range(c.depth))
        self.neck = nn.Sequential(
            nn.Conv2d(dim, c.neck_dim, 1, bias=False, dtype=dt, device=device),
            LayerNorm2d(c.neck_dim, device=device),
            nn.Conv2d(c.neck_dim, c.neck_dim, 3, padding=1, bias=False, dtype=dt,
                      device=device),
            LayerNorm2d(c.neck_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        g = c.img_size // c.patch_size
        x = self.patch_embed.proj(x.to(c.dtype)).permute(0, 2, 3, 1)      # NHWC
        g0 = int(math.sqrt(self.pos_embed.shape[1] - 1))
        grid = self.pos_embed[:, 1:].reshape(1, g0, g0, c.patch_embed_dim)
        x = x + interpolate_bicubic(grid, (g, g)).to(c.dtype)
        b = x.shape[0]
        x = x.reshape(b, g * g, c.patch_embed_dim)
        for blk in self.blocks:
            x = blk(x)
        x = x.reshape(b, g, g, c.patch_embed_dim).permute(0, 3, 1, 2)
        return self.neck(x)


class _PELayer(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.zeros(2, channels // 2, dtype=torch.float32, device=device))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        c = (2 * coords01 - 1) @ self.positional_encoding_gaussian_matrix
        c = 2 * np.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class PromptEncoder(nn.Module):
    """Random-frequency position encoding plus label-type embeddings.
    Labels: -1 padding, 1 point, 2 box top-left, 3 box bottom-right."""

    def __init__(self, config: EfficientSAMConfig, device=None):
        super().__init__()
        self.config = config
        c = config.neck_dim
        self.pe_layer = _PELayer(c, device)
        for name in ("invalid_points", "point_embeddings", "bbox_top_left_embeddings",
                     "bbox_bottom_right_embeddings"):
            setattr(self, name, nn.Embedding(1, c, device=device))

    def dense_pe(self) -> torch.Tensor:
        g = self.config.img_size // self.config.patch_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        ticks = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        grid = torch.stack(torch.meshgrid(ticks, ticks, indexing="xy"), dim=-1)
        return self.pe_layer(grid)                                        # [g, g, C]

    def forward(self, points: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """points [B, N, 2] in encoder pixels, labels [B, N]."""
        emb = self.pe_layer((points + 0.5) / self.config.img_size)
        for value, table in ((-1, self.invalid_points), (1, self.point_embeddings),
                             (2, self.bbox_top_left_embeddings),
                             (3, self.bbox_bottom_right_embeddings)):
            emb = emb + table.weight[0] * (labels == value)[..., None]
        return emb


class TwoWayAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int, dtype, device=None):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        kw = dict(dtype=dtype, device=device)
        self.q_proj = nn.Linear(dim, inner, **kw)
        self.k_proj = nn.Linear(dim, inner, **kw)
        self.v_proj = nn.Linear(dim, inner, **kw)
        self.out_proj = nn.Linear(inner, dim, **kw)

    def forward(self, q, k, v):
        return self.out_proj(sdpa(self.q_proj(q), self.k_proj(k), self.v_proj(v), self.heads))


class MLPBlock(nn.Module):
    """`num_layers` hidden Linear-GELU layers, then `fc`."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            nn.Sequential(nn.Linear(dim if i == 0 else hidden, hidden, **kw), nn.GELU())
            for i in range(num_layers))
        self.fc = nn.Linear(hidden, out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return self.fc(x)


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, skip_first_pe: bool, dtype,
                 device=None):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = TwoWayAttention(dim, heads, 1, dtype, device)
        self.norm1 = LayerNorm32(dim, device=device)
        self.cross_attn_token_to_image = TwoWayAttention(dim, heads, 2, dtype, device)
        self.norm2 = LayerNorm32(dim, device=device)
        self.mlp = MLPBlock(dim, mlp_dim, dim, 1, dtype, device)
        self.norm3 = LayerNorm32(dim, device=device)
        self.norm4 = LayerNorm32(dim, device=device)
        self.cross_attn_image_to_token = TwoWayAttention(dim, heads, 2, dtype, device)

    def forward(self, queries, keys, query_pe, key_pe):
        if not self.skip_first_pe:
            queries = queries + query_pe
        queries = self.norm1(queries + self.self_attn(queries, queries, queries))
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, config: EfficientSAMConfig, device=None):
        super().__init__()
        cfg = self.config = config
        c, dt = cfg.neck_dim, cfg.dtype
        n_tokens = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, c, device=device)
        self.mask_tokens = nn.Embedding(n_tokens, c, device=device)
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            TwoWayBlock(c, cfg.decoder_heads, cfg.decoder_mlp_dim, i == 0, dt, device)
            for i in range(cfg.decoder_depth))
        self.transformer.final_attn_token_to_image = TwoWayAttention(
            c, cfg.decoder_heads, 2, dt, device)
        self.transformer.norm_final_attn = LayerNorm32(c, device=device)
        dims = list(cfg.upscaling_dims)
        ups = []
        for i, (cin, dim) in enumerate(zip([c] + dims[:-1], dims)):
            layer = [nn.ConvTranspose2d(cin, dim, 2, stride=2, dtype=dt, device=device)]
            if i < len(dims) - 1:
                layer.append(PlainGroupNorm(1, dim, device=device))
            ups.append(nn.Sequential(*layer, nn.GELU()))
        self.final_output_upscaling_layers = nn.ModuleList(ups)
        # two hidden layers (the reference hard-codes num_layers=2 here)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLPBlock(c, c, dims[-1], 2, dt, device) for _ in range(n_tokens))
        self.iou_prediction_head = MLPBlock(c, cfg.iou_hidden_dim, n_tokens, 2, dt, device)

    def forward(self, image_embeddings, image_pe, sparse_embeddings):
        """image_embeddings [B, C, g, g]; image_pe [g, g, C]; sparse
        [B, N, C].  -> (masks [B, M, 4g, 4g], iou [B, M])."""
        cfg = self.config
        n_tokens = cfg.num_multimask_outputs + 1
        b, c, g, _ = image_embeddings.shape
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse_embeddings], dim=1)
        keys = image_embeddings.flatten(2).transpose(1, 2)
        key_pe = image_pe.reshape(1, g * g, c).expand(b, -1, -1)
        queries = tokens
        for layer in self.transformer.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = queries + self.transformer.final_attn_token_to_image(q, k, keys)
        queries = self.transformer.norm_final_attn(queries)
        iou_out, mask_out = queries[:, 0], queries[:, 1 : 1 + n_tokens]

        up = keys.transpose(1, 2).reshape(b, c, g, g)
        for layer in self.final_output_upscaling_layers:
            up = layer(up)
        hyper = torch.stack([mlp(mask_out[:, i])
                             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bmd,bdhw->bmhw", hyper, up)
        return masks, self.iou_prediction_head(iou_out)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class EfficientSAM(nn.Module):
    """images [B, 3, H, W] in [0, 1] plus point prompts -> masks.

    points [B, Q, N, 2] in input-image pixels (x, y); labels [B, Q, N]
    (1 point, 2 top-left, 3 bottom-right, -1 padding).  Returns (masks
    [B, Q, M, h', w'] logits sorted by IoU, descending and stable; iou
    [B, Q, M])."""

    def __init__(self, config: EfficientSAMConfig, device=None):
        super().__init__()
        self.config = config
        self.image_encoder = ImageEncoder(config, device)
        self.prompt_encoder = PromptEncoder(config, device)
        self.mask_decoder = MaskDecoder(config, device)

    def embed_image(self, images01: torch.Tensor) -> torch.Tensor:
        s = self.config.img_size
        mean = torch.tensor(IMAGENET_MEAN, device=images01.device)[:, None, None]
        std = torch.tensor(IMAGENET_STD, device=images01.device)[:, None, None]
        x = (images01.float() - mean) / std
        if x.shape[2:] != (s, s):
            # bilinear without antialiasing: torch's F.interpolate(bilinear,
            # align_corners=False), the reference's preprocessing
            x = resize(x, (s, s), "linear", antialias=False, axes=(2, 3))
        return self.image_encoder(x)

    def forward(self, images01, points, labels):
        cfg = self.config
        b, _, in_h, in_w = images01.shape
        q, n = points.shape[1], points.shape[2]
        emb = self.embed_image(images01)
        scale = torch.tensor([cfg.img_size / in_w, cfg.img_size / in_h],
                             dtype=torch.float32, device=points.device)
        pts = torch.where(points >= 0, points * scale, torch.full_like(points, -1.0))
        labels = labels.float()
        m = cfg.decoder_max_points
        if n > m:
            pts, labels = pts[:, :, :m], labels[:, :, :m]
        elif n < m:
            pts = F.pad(pts, (0, 0, 0, m - n), value=-1.0)
            labels = F.pad(labels, (0, m - n), value=-1.0)
        sparse = self.prompt_encoder(pts.reshape(b * q, m, 2), labels.reshape(b * q, m))
        masks, iou = self.mask_decoder(emb.repeat_interleave(q, dim=0),
                                       self.prompt_encoder.dense_pe(), sparse)
        # multimask output: the first (single-mask) token is dropped
        masks, iou = masks[:, 1:], iou[:, 1:]
        order = torch.argsort(-iou, dim=-1, stable=True)
        iou = torch.take_along_dim(iou, order, dim=-1)
        masks = torch.take_along_dim(masks, order[:, :, None, None], dim=1)
        nm = masks.shape[1]
        return (masks.reshape(b, q, nm, *masks.shape[-2:]), iou.reshape(b, q, nm))


@torch.no_grad()
def segment_with_box(model: EfficientSAM, image_uint8, xyxy) -> np.ndarray:
    """Box-prompted segmentation: the box's two labelled corners -> the
    best mask, torch-bicubic resized to the image, uint8 0/255 [H, W]."""
    dev = model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.device
    img = torch.as_tensor(np.asarray(image_uint8), device=dev).float() / 255.0
    x0, y0, x1, y1 = (float(v) for v in xyxy)
    pts = torch.tensor([[[[x0, y0], [x1, y1]]]], dtype=torch.float32, device=dev)
    lbl = torch.tensor([[[2.0, 3.0]]], device=dev)
    masks, _ = model(img.permute(2, 0, 1)[None], pts, lbl)
    h, w = img.shape[:2]
    best = interpolate_bicubic(masks[0, 0, 0][..., None], (h, w))[..., 0]
    return (best > 0).to(torch.uint8).mul_(255).cpu().numpy()
