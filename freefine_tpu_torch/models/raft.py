"""RAFT optical flow in PyTorch, NCHW inside: the MotionGuidance flow
backbone (mirrors `freefine_tpu.models.raft`, the basic variant of the
reference's in-tree RAFT).

An instance-norm feature encoder and a frozen-batch-norm context encoder
(both 256 channels at 1/8 resolution), the all-pairs correlation pyramid
(`ops.flow`, plain ops as in the JAX package), and the iterative SepConvGRU
update block with convex 8x flow upsampling.  Inference only: the batch
norms use their running statistics.  The iterations are a Python loop,
differentiable end to end (MotionGuidance takes its energy gradient through
the whole network); as in the JAX package, the coordinates are not detached
between iterations.

Parameter names are the reference checkpoint's (`raft-things.pth` with the
`module.` prefix stripped): what `freefine_tpu.models.raft._torch_key`
gives.  The reference registers each shortcut BatchNorm twice, as `norm3`
and inside `downsample.1`; the port keeps the `downsample.1` name alone
(`weights.load_raft` drops the alias).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch
import torch.nn.functional as F
from torch import nn

from freefine_tpu_torch.models.layers import FrozenBatchNorm2d
from freefine_tpu_torch.ops.flow import corr_lookup, corr_pyramid, correlation_volume


@dataclasses.dataclass(frozen=True)
class RAFTConfig:
    hidden_dim: int = 128
    context_dim: int = 128
    corr_levels: int = 4
    corr_radius: int = 4
    iters: int = 5          # the reference's flow_utils.RAFT wrapper default
    dtype: torch.dtype = torch.float32


class InstanceNorm(nn.Module):
    """`nn.InstanceNorm2d(affine=False)`: per sample and channel over H, W,
    biased variance, eps 1e-5; no parameters."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps)


def _norm(norm_fn: str, features: int, device) -> nn.Module:
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "batch":
        return FrozenBatchNorm2d(features, device=device)
    raise ValueError(norm_fn)


def _conv(cin, cout, k, stride=1, padding=0, *, dtype, device) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, dtype=dtype, device=device)


class ResidualBlock(nn.Module):
    """Two 3x3 convolutions (the first at `stride`, padded (1, 1) as torch
    pads: flax's "SAME" would pad a stride-2 input asymmetrically) and a
    1x1 shortcut with its norm where the shape changes."""

    def __init__(self, cin: int, planes: int, norm_fn: str, stride: int = 1, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.conv1 = _conv(cin, planes, 3, stride, 1, dtype=dtype, device=device)
        self.conv2 = _conv(planes, planes, 3, 1, 1, dtype=dtype, device=device)
        self.norm1 = _norm(norm_fn, planes, device)
        self.norm2 = _norm(norm_fn, planes, device)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(_conv(cin, planes, 1, stride, dtype=dtype,
                                                  device=device),
                                            _norm(norm_fn, planes, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """A 7x7/2 stem, three residual stages (64, 96 and 128 channels, the
    last two at stride 2) and a 1x1 output: 1/8 resolution."""

    def __init__(self, output_dim: int, norm_fn: str, dtype=torch.float32, device=None):
        super().__init__()
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype=dtype, device=device)
        self.norm1 = _norm(norm_fn, 64, device)
        cin = 64
        for i, (dim, stride) in enumerate([(64, 1), (96, 2), (128, 2)]):
            setattr(self, f"layer{i + 1}", nn.Sequential(
                ResidualBlock(cin, dim, norm_fn, stride, dtype, device),
                ResidualBlock(dim, dim, norm_fn, 1, dtype, device)))
            cin = dim
        self.conv2 = _conv(128, output_dim, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.norm1(self.conv1(x)))
        h = self.layer3(self.layer2(self.layer1(h)))
        return self.conv2(h)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.convc1 = _conv(corr_planes, 256, 1, **kw)
        self.convc2 = _conv(256, 192, 3, 1, 1, **kw)
        self.convf1 = _conv(2, 128, 7, 1, 3, **kw)
        self.convf2 = _conv(128, 64, 3, 1, 1, **kw)
        self.conv = _conv(64 + 192, 128 - 2, 3, 1, 1, **kw)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], dim=1)))
        return torch.cat([out, flow], dim=1)


class SepConvGRU(nn.Module):
    """A GRU over a horizontal (1x5) then a vertical (5x1) pass."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        cin = hidden_dim + input_dim
        for suffix, kern, pad in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{suffix}", _conv(cin, hidden_dim, kern, 1, pad, **kw))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for suffix in "12":
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
            q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, hidden_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv1 = _conv(hidden_dim, 256, 3, 1, 1, dtype=dtype, device=device)
        self.conv2 = _conv(256, 2, 3, 1, 1, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, config: RAFTConfig, device=None):
        super().__init__()
        cfg, dt = config, config.dtype
        corr_planes = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
        self.encoder = BasicMotionEncoder(corr_planes, dt, device)
        self.gru = SepConvGRU(cfg.hidden_dim, cfg.context_dim + 128, dt, device)
        self.flow_head = FlowHead(cfg.hidden_dim, dt, device)
        self.mask = nn.Sequential(_conv(cfg.hidden_dim, 256, 3, 1, 1, dtype=dt, device=device),
                                  nn.ReLU(),
                                  _conv(256, 64 * 9, 1, dtype=dt, device=device))

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling: flow [B, H, W, 2] at 1/8
    resolution and mask [B, H, W, 64*9] -> [B, 8H, 8W, 2]."""
    b, h, w, _ = flow.shape
    m = torch.softmax(mask.reshape(b, h, w, 9, 8, 8), dim=3)
    fp = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    # the 9 shifted neighbour copies (the 3x3 unfold)
    neigh = torch.stack([fp[:, dy : dy + h, dx : dx + w, :] for dy in range(3)
                         for dx in range(3)], dim=3)                  # [B, H, W, 9, 2]
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", m, neigh)               # [B, H, W, 8, 8, 2]
    return up.permute(0, 1, 3, 2, 4, 5).reshape(b, 8 * h, 8 * w, 2)


class RAFT(nn.Module):
    """images [B, H, W, 3] in [0, 1] -> flow [B, H, W, 2] in (x, y) pixels
    (NHWC at the interface, as the JAX package; NCHW inside).  H and W
    multiples of 8.  Made on `device` ("cuda" by default; raises without a
    card)."""

    def __init__(self, config: RAFTConfig = RAFTConfig(),
                 device: Union[str, torch.device] = "cuda"):
        from freefine_tpu_torch.pipeline import resolve_device

        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.fnet = BasicEncoder(256, "instance", cfg.dtype, device)
        self.cnet = BasicEncoder(cfg.hidden_dim + cfg.context_dim, "batch", cfg.dtype, device)
        self.update_block = BasicUpdateBlock(cfg, device)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor, iters: int = 0) -> torch.Tensor:
        cfg = self.config
        iters = iters or cfg.iters
        dt = cfg.dtype
        x1 = (2.0 * image1 - 1.0).permute(0, 3, 1, 2).to(dt)
        x2 = (2.0 * image2 - 1.0).permute(0, 3, 1, 2).to(dt)
        fmap1, fmap2 = self.fnet(x1), self.fnet(x2)
        pyr = corr_pyramid(correlation_volume(fmap1.permute(0, 2, 3, 1),
                                              fmap2.permute(0, 2, 3, 1)), cfg.corr_levels)
        cnet = self.cnet(x1)
        net = torch.tanh(cnet[:, : cfg.hidden_dim])
        inp = F.relu(cnet[:, cfg.hidden_dim :])

        b, _, h, w = fmap1.shape
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=x1.device),
                                torch.arange(w, dtype=torch.float32, device=x1.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], dim=-1)[None].expand(b, h, w, 2)
        coords1 = coords0
        up_mask = None
        for _ in range(iters):
            corr = corr_lookup(pyr, coords1, cfg.corr_radius)
            flow = coords1 - coords0
            net, up_mask, delta = self.update_block(
                net, inp, corr.permute(0, 3, 1, 2).to(dt), flow.permute(0, 3, 1, 2).to(dt))
            coords1 = coords1 + delta.permute(0, 2, 3, 1).float()
        # only the last iteration's upsampled flow is returned, so it alone is made
        return upsample_flow_convex(coords1 - coords0, up_mask.permute(0, 2, 3, 1).float())
