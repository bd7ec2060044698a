"""RAFT's all-pairs correlation volume and its windowed lookup as plain
PyTorch ops (mirrors `freefine_tpu.ops.flow`, which leaves them to XLA: no
TPU kernel, so none here).

The volume is one batched matrix product, the pyramid average pooling, and
the lookup a bilinear gather.  The gather is `map_coordinates_linear`, a
step-for-step copy of `jax.scipy.ndimage.map_coordinates(order=1)`: floor
the coordinate, weight the two neighbours by (1 - frac, frac), zero (or,
in mode "mirror", reflect about the edge pixels' centres; in mode
"nearest", clamp them to the border) the neighbours outside the image,
multiply the two axes' weights before the value and add the four corners
in JAX's order.  `F.grid_sample` is not used: its
normalise-and-back round trip moves integer coordinates by an ulp, and with
them which corners carry weight.  Under autograd the gather's backward is a
scatter-add (atomics on CUDA, so a gradient varies in its last bits from
run to run).

Layout is NHWC at every public function, as in the JAX package.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence

import torch


def correlation_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs correlation: fmap1/fmap2 [B, H, W, C] -> [B, H1, W1, H2, W2]
    float32, scaled by 1/sqrt(C)."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c).float()
    f2 = fmap2.reshape(b, h * w, c).float()
    corr = torch.bmm(f1, f2.transpose(1, 2)) / torch.sqrt(torch.tensor(float(c)))
    return corr.reshape(b, h, w, h, w)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over the trailing two dims of [N, H, W];
    odd trailing rows/cols are dropped, as `F.avg_pool2d(2, 2)` drops them."""
    n, h, w = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))


def corr_pyramid(corr: torch.Tensor, num_levels: int = 4) -> List[torch.Tensor]:
    """Pool the target dims of the volume into a pyramid: [B*H1*W1, H2/2^i,
    W2/2^i] per level."""
    b, h1, w1, h2, w2 = corr.shape
    level = corr.reshape(b * h1 * w1, h2, w2)
    out = [level]
    for _ in range(num_levels - 1):
        level = avg_pool2(level)
        out.append(level)
    return out


def _linear_nodes(coord: torch.Tensor, size: int, mode: str):
    """The two (index, valid, weight) interpolation nodes of one axis, as
    JAX's `_linear_indices_and_weights` and index fixers make them."""
    lower = torch.floor(coord)
    upper_w = coord - lower
    lower_w = 1 - upper_w
    index = lower.long()
    nodes = []
    for i, w in ((index, lower_w), (index + 1, upper_w)):
        if mode == "constant":
            nodes.append((i.clamp(0, size - 1), (i >= 0) & (i < size), w))
        elif mode == "nearest":  # the border pixel's value outside
            nodes.append((i.clamp(0, size - 1), None, w))
        else:  # mirror: reflect about the edge pixels' centres
            s = size - 1
            nodes.append((torch.abs(torch.remainder(i + s, 2 * s) - s), None, w))
    return nodes


def map_coordinates_linear(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor,
                           mode: str = "constant") -> torch.Tensor:
    """`jax.scipy.ndimage.map_coordinates(img[n], [yy[n], xx[n]], order=1,
    mode=mode, cval=0)` for each n: img [N, H, W], yy/xx [N, ...] -> [N, ...].
    mode "constant" (zeros outside), "nearest" (the index clamped to the
    border) or "mirror"."""
    if mode not in ("constant", "nearest", "mirror"):
        raise ValueError(f"mode {mode!r}: 'constant', 'nearest' or 'mirror'")
    n, h, w = img.shape
    flat = img.reshape(n, h * w)
    total = None
    for (iy, vy, wy), (ix, vx, wx) in itertools.product(_linear_nodes(yy, h, mode),
                                                        _linear_nodes(xx, w, mode)):
        v = torch.gather(flat, 1, (iy * w + ix).reshape(n, -1)).reshape(yy.shape)
        if mode == "constant":
            v = torch.where(vy & vx, v, torch.zeros((), dtype=v.dtype, device=v.device))
        term = (wy * wx) * v
        total = term if total is None else total + term
    return total


def bilinear_sample_2d(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [H, W] (or a batch [N, H, W] with yy/xx [N, ...])
    at fractional (yy, xx), zero outside: RAFT's `bilinear_sampler`."""
    if img.ndim == 2:
        return map_coordinates_linear(img[None], yy[None], xx[None])[0]
    return map_coordinates_linear(img, yy, xx)


def corr_lookup(pyramid: Sequence[torch.Tensor], coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """Windowed pyramid lookup: coords [B, H1, W1, 2] in (x, y) pixels of
    level 0 -> [B, H1, W1, num_levels * (2r+1)^2].

    RAFT enumerates the window transposed: the offset pair (dy[a], dx[b])
    is added to the (x, y) centre, so the x offset runs along the first
    window axis; trained checkpoints encode that order in the motion
    encoder's first convolution."""
    n_win = 2 * radius + 1
    b, h1, w1, _ = coords.shape
    flat = coords.reshape(b * h1 * w1, 2)
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    dyy, dxx = torch.meshgrid(offs, offs, indexing="ij")
    out = []
    for i, level in enumerate(pyramid):
        centers = flat / (2.0 ** i)
        yy = centers[:, 1, None, None] + dxx
        xx = centers[:, 0, None, None] + dyy
        win = map_coordinates_linear(level, yy, xx)          # [BHW, 2r+1, 2r+1]
        out.append(win.reshape(b, h1, w1, n_win * n_win))
    return torch.cat(out, dim=-1)


def corr_block(fmap1: torch.Tensor, fmap2: torch.Tensor, coords: torch.Tensor,
               num_levels: int = 4, radius: int = 4) -> torch.Tensor:
    """Volume, pyramid and lookup in one call."""
    pyr = corr_pyramid(correlation_volume(fmap1, fmap2), num_levels)
    return corr_lookup(pyr, coords, radius)
