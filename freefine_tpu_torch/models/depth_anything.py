"""Depth-Anything (a DPT head on DINOv2) in PyTorch (mirrors
`freefine_tpu.models.depth_anything`), NCHW inside.

DINOv2's last four blocks' patch tokens -> per-level 1x1 projections ->
the resize stack (x4 and x2 transposed convs, identity, a stride-2 conv)
-> 3x3 convs to `features` channels -> four RefineNet-style fusion blocks
with align-corners bilinear upsampling -> the conv head -> ReLU depth at
the input resolution.

Module names are transformers' `DepthAnythingForDepthEstimation` ones for
the neck and head (`neck.reassemble_stage.layers.{i}.{projection,resize}`,
`neck.convs.{i}`, `neck.fusion_stage.layers.{j}.{residual_layer1,
residual_layer2}.convolution{1,2}` and `.projection`, `head.conv{1,2,3}`)
and torchhub's DINOv2 names under `backbone.` (fused qkv, so one matmul
feeds the attention kernel); `weights.load_depth_anything` renames a
transformers checkpoint's backbone on load.  Fusion layer 0 gets no
residual input, so it has no `residual_layer1` (a transformers checkpoint
carries one, never used; the loader drops it).

The resize stack's transposed convs are torch's `ConvTranspose2d`, as the
checkpoint's are (ROADMAP C9: the JAX package's converter hands flax these
kernels unflipped, so its Depth-Anything computes them mirrored).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.dinov2 import (
    DINOv2,
    DINOv2Config,
    dinov2_vitb14,
    dinov2_vitl14,
    dinov2_vits14,
)
from freefine_tpu_torch.ops.resize import resize


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """[B, C, H, W] -> [B, C, h, w], bilinear with align_corners=True."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    backbone: DINOv2Config = dataclasses.field(default_factory=dinov2_vits14)
    features: int = 64
    out_channels: Tuple[int, ...] = (48, 96, 192, 384)


def depth_anything_vits() -> DepthAnythingConfig:
    return DepthAnythingConfig()


def depth_anything_vitb() -> DepthAnythingConfig:
    return DepthAnythingConfig(backbone=dinov2_vitb14(), features=128,
                               out_channels=(96, 192, 384, 768))


def depth_anything_vitl() -> DepthAnythingConfig:
    return DepthAnythingConfig(backbone=dinov2_vitl14(), features=256,
                               out_channels=(256, 512, 1024, 1024))


class PreActResidual(nn.Module):
    """ReLU-conv-ReLU-conv plus the input (DPT's ResidualConvUnit)."""

    def __init__(self, features: int, dtype, device=None):
        super().__init__()
        kw = dict(padding=1, dtype=dtype, device=device)
        self.convolution1 = nn.Conv2d(features, features, 3, **kw)
        self.convolution2 = nn.Conv2d(features, features, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class FusionLayer(nn.Module):
    def __init__(self, features: int, takes_residual: bool, dtype, device=None):
        super().__init__()
        if takes_residual:
            self.residual_layer1 = PreActResidual(features, dtype, device)
        self.residual_layer2 = PreActResidual(features, dtype, device)
        self.projection = nn.Conv2d(features, features, 1, dtype=dtype, device=device)

    def forward(self, x, residual=None, size=None):
        if residual is not None:
            x = x + self.residual_layer1(residual)
        x = self.residual_layer2(x)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        return self.projection(resize_bilinear_align_corners(x, size))


class ReassembleLayer(nn.Module):
    def __init__(self, dim: int, channels: int, level: int, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.projection = nn.Conv2d(dim, channels, 1, **kw)
        if level in (0, 1):
            f = 4 if level == 0 else 2
            self.resize = nn.ConvTranspose2d(channels, channels, f, stride=f, **kw)
        elif level == 3:
            # torch's explicit pad of 1 (== SAME only at odd patch grids)
            self.resize = nn.Conv2d(channels, channels, 3, stride=2, padding=1, **kw)
        else:
            self.resize = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resize(self.projection(x))


class DPTNeck(nn.Module):
    def __init__(self, config: DepthAnythingConfig, device=None):
        super().__init__()
        c, dt = config, config.backbone.dtype
        self.reassemble_stage = nn.Module()
        self.reassemble_stage.layers = nn.ModuleList(
            ReassembleLayer(c.backbone.dim, ch, i, dt, device)
            for i, ch in enumerate(c.out_channels))
        self.convs = nn.ModuleList(
            nn.Conv2d(ch, c.features, 3, padding=1, bias=False, dtype=dt, device=device)
            for ch in c.out_channels)
        self.fusion_stage = nn.Module()
        self.fusion_stage.layers = nn.ModuleList(
            FusionLayer(c.features, j > 0, dt, device) for j in range(len(c.out_channels)))

    def forward(self, features, patch_h: int, patch_w: int) -> torch.Tensor:
        rn = []
        for (tokens, _cls), layer, conv in zip(features, self.reassemble_stage.layers,
                                               self.convs):
            b, n, ch = tokens.shape
            x = tokens.transpose(1, 2).reshape(b, ch, patch_h, patch_w)
            rn.append(conv(layer(x)))
        fuse = self.fusion_stage.layers
        path = fuse[0](rn[3], size=rn[2].shape[2:])
        path = fuse[1](path, rn[2], size=rn[1].shape[2:])
        path = fuse[2](path, rn[1], size=rn[0].shape[2:])
        return fuse[3](path, rn[0])


class DepthHead(nn.Module):
    def __init__(self, config: DepthAnythingConfig, device=None):
        super().__init__()
        f, kw = config.features, dict(dtype=config.backbone.dtype, device=device)
        self.conv1 = nn.Conv2d(f, f // 2, 3, padding=1, **kw)
        self.conv2 = nn.Conv2d(f // 2, 32, 3, padding=1, **kw)
        self.conv3 = nn.Conv2d(32, 1, 1, **kw)

    def forward(self, x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
        x = resize_bilinear_align_corners(self.conv1(x), size)
        return F.relu(self.conv3(F.relu(self.conv2(x))))


class DepthAnything(nn.Module):
    """Monocular depth: normalised RGB [B, 3, H, W] -> [B, H, W] relative
    disparity (ReLU'd), H and W multiples of the patch size."""

    def __init__(self, config: DepthAnythingConfig, device=None):
        super().__init__()
        self.config = config
        self.backbone = DINOv2(config.backbone, device=device)
        self.neck = DPTNeck(config, device)
        self.head = DepthHead(config, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        p = self.config.backbone.patch_size
        if h % p or w % p:
            raise ValueError(f"H, W must be multiples of {p}, got {h}x{w}")
        feats = self.backbone(x, num_intermediate=4)
        return self.head(self.neck(feats, h // p, w // p), (h, w))[:, 0]


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_depth_input(img_uint8, size: int = 518, device=None) -> torch.Tensor:
    """uint8 RGB [H, W, 3] -> normalised float32
    [1, 3, h', w'], the shorter side scaled to about `size` and both sides
    rounded to multiples of 14 (Depth-Anything's Resize transform), by
    `jax.image.resize`'s antialiased Keys cubic as the JAX package does
    (`F.interpolate`'s bicubic is another kernel)."""
    x = torch.as_tensor(img_uint8, device=device).float() / 255.0
    h, w = x.shape[:2]
    scale = size / min(h, w)
    nh = int(round(h * scale / 14)) * 14
    nw = int(round(w * scale / 14)) * 14
    x = resize(x, (nh, nw), "cubic")
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(2, 0, 1)[None].contiguous()
