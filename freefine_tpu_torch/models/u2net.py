"""U^2-Net salient-object matting in PyTorch (mirrors
`freefine_tpu.models.u2net`): the re-matting step of the SV3D coarse 3D
edit, which finds the object in the novel view.

Six RSU (ReSidual U-block) encoder stages, five decoder stages, six side
outputs resized to the input and fused into the saliency map.
`u2netp_config()` is the lightweight u2netp, `u2net_config()` the full
model.  Module names are the official U-2-Net ones (`stageN.rebnconv*.
conv_s1` / `bn_s1`, `stageNd`, `sideN`, `outconv`), so the published
u2net.pth / u2netp.pth load as they are.  Max pooling is 2x2 stride 2
with ceil mode (JAX's "SAME" pooling at odd sizes); every upsampling is
the port's counterpart of `jax.image.resize`'s "linear"; the BatchNorms
run in inference mode (eps 1e-5).  Float32 by default.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.layers import FrozenBatchNorm2d
from freefine_tpu_torch.ops.resize import resize

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class ConvBNReLU(nn.Module):
    """U-2-Net's REBNCONV: 3x3 conv (dilated, padded by its dilation),
    inference BatchNorm, ReLU."""

    def __init__(self, cin: int, cout: int, dilation: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv_s1 = nn.Conv2d(cin, cout, 3, padding=dilation, dilation=dilation, dtype=dtype,
                                 device=device)
        self.bn_s1 = FrozenBatchNorm2d(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn_s1(self.conv_s1(x)))


def _down(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _up_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return resize(x, ref.shape[2:], "linear", axes=(2, 3)).to(x.dtype)


class RSU(nn.Module):
    """ReSidual U-block of `depth` levels (RSU7 ... RSU4)."""

    def __init__(self, depth: int, cin: int, mid: int, out: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.depth = depth
        self.rebnconvin = ConvBNReLU(cin, out, **kw)
        self.rebnconv1 = ConvBNReLU(out, mid, **kw)
        for i in range(2, depth):
            setattr(self, f"rebnconv{i}", ConvBNReLU(mid, mid, **kw))
        setattr(self, f"rebnconv{depth}", ConvBNReLU(mid, mid, 2, **kw))
        for i in range(depth - 1, 1, -1):
            setattr(self, f"rebnconv{i}d", ConvBNReLU(2 * mid, mid, **kw))
        self.rebnconv1d = ConvBNReLU(2 * mid, out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        enc = [self.rebnconv1(hxin)]
        h = enc[0]
        for i in range(2, self.depth):
            h = getattr(self, f"rebnconv{i}")(_down(h))
            enc.append(h)
        h = getattr(self, f"rebnconv{self.depth}")(enc[-1])
        for i in range(self.depth - 1, 1, -1):
            h = getattr(self, f"rebnconv{i}d")(torch.cat([h, enc[i - 1]], 1))
            h = _up_to(h, enc[i - 2])
        return self.rebnconv1d(torch.cat([h, enc[0]], 1)) + hxin


class RSU4F(nn.Module):
    """The dilation-only RSU (dilations 1, 2, 4, 8; no resolution change)."""

    def __init__(self, cin: int, mid: int, out: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.rebnconvin = ConvBNReLU(cin, out, **kw)
        self.rebnconv1 = ConvBNReLU(out, mid, 1, **kw)
        self.rebnconv2 = ConvBNReLU(mid, mid, 2, **kw)
        self.rebnconv3 = ConvBNReLU(mid, mid, 4, **kw)
        self.rebnconv4 = ConvBNReLU(mid, mid, 8, **kw)
        self.rebnconv3d = ConvBNReLU(2 * mid, mid, 4, **kw)
        self.rebnconv2d = ConvBNReLU(2 * mid, mid, 2, **kw)
        self.rebnconv1d = ConvBNReLU(2 * mid, out, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hxin = self.rebnconvin(x)
        h1 = self.rebnconv1(hxin)
        h2 = self.rebnconv2(h1)
        h3 = self.rebnconv3(h2)
        h4 = self.rebnconv4(h3)
        h3d = self.rebnconv3d(torch.cat([h4, h3], 1))
        h2d = self.rebnconv2d(torch.cat([h3d, h2], 1))
        return self.rebnconv1d(torch.cat([h2d, h1], 1)) + hxin


@dataclasses.dataclass(frozen=True)
class U2NetConfig:
    # (depth, mid, out) per encoder stage; depth 0 is an RSU4F
    stages: Tuple[Tuple[int, int, int], ...] = (
        (7, 32, 64), (6, 32, 128), (5, 64, 256), (4, 128, 512),
        (0, 256, 512), (0, 256, 512),
    )
    # decoder (depth, mid, out), stage5d to stage1d
    dstages: Tuple[Tuple[int, int, int], ...] = (
        (0, 256, 512), (4, 128, 256), (5, 64, 128), (6, 32, 64), (7, 16, 64),
    )
    dtype: torch.dtype = torch.float32


def u2net_config() -> U2NetConfig:
    return U2NetConfig()


def u2netp_config() -> U2NetConfig:
    """The lightweight u2netp (rembg's default)."""
    return U2NetConfig(
        stages=((7, 16, 64), (6, 16, 64), (5, 16, 64), (4, 16, 64),
                (0, 16, 64), (0, 16, 64)),
        dstages=((0, 16, 64), (4, 16, 64), (5, 16, 64), (6, 16, 64),
                 (7, 16, 64)),
    )


def _block(depth: int, cin: int, mid: int, out: int, dtype, device) -> nn.Module:
    return RSU4F(cin, mid, out, dtype, device) if depth == 0 else RSU(depth, cin, mid, out,
                                                                      dtype, device)


class U2Net(nn.Module):
    """[B, H, W, 3] in [0, 1] (NHWC) -> [B, H, W] float32 saliency in (0, 1)."""

    def __init__(self, config: U2NetConfig, device=None):
        super().__init__()
        self.config = cfg = config
        n = len(cfg.stages)
        cin = 3
        for i, (depth, mid, out) in enumerate(cfg.stages):
            setattr(self, f"stage{i + 1}", _block(depth, cin, mid, out, cfg.dtype, device))
            cin = out
        for i, (depth, mid, out) in enumerate(cfg.dstages):
            skip = cfg.stages[n - 2 - i][2]
            setattr(self, f"stage{n - 1 - i}d",
                    _block(depth, cin + skip, mid, out, cfg.dtype, device))
            cin = out
        side_ch = [d[2] for d in reversed(cfg.dstages)] + [cfg.stages[-1][2]]
        for i, ch in enumerate(side_ch):
            setattr(self, f"side{i + 1}", nn.Conv2d(ch, 1, 3, padding=1, dtype=cfg.dtype,
                                                    device=device))
        self.outconv = nn.Conv2d(len(side_ch), 1, 1, dtype=cfg.dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        n = len(cfg.stages)
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        h = ((x.float() - mean) / std).to(cfg.dtype).permute(0, 3, 1, 2)
        full = h.shape[2:]
        encs = []
        for i in range(n):
            h = getattr(self, f"stage{i + 1}")(h)
            encs.append(h)
            if i < n - 1:
                h = _down(h)
        sides = [encs[-1]]
        for i in range(len(cfg.dstages)):
            skip = encs[n - 2 - i]
            h = torch.cat([_up_to(h, skip), skip], 1)
            h = getattr(self, f"stage{n - 1 - i}d")(h)
            sides.append(h)
        outs = [resize(getattr(self, f"side{i + 1}")(s), full, "linear", axes=(2, 3))
                .to(cfg.dtype) for i, s in enumerate(reversed(sides))]
        fused = self.outconv(torch.cat(outs, 1))
        return torch.sigmoid(fused[:, 0].float())


@torch.no_grad()
def get_mask_from_saliency(model: U2Net, image_uint8: np.ndarray, size: int = 320,
                           threshold: float = 0.5) -> np.ndarray:
    """rembg-style object mask on the model's device: the image resized to
    size^2 (antialiased "linear"), its saliency min-max normalised, resized
    back, thresholded.  -> uint8 0/255 [H, W]."""
    h, w = image_uint8.shape[:2]
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(image_uint8), device=dev).float()[None] / 255.0
    sal = model(resize(x, (size, size), "linear", axes=(1, 2)))[0]
    sal = (sal - sal.min()) / torch.clamp(sal.max() - sal.min(), min=1e-8)
    sal = resize(sal, (h, w), "linear")
    return (sal.cpu().numpy() > threshold).astype(np.uint8) * 255
