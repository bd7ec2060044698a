"""Separable resampling as weight matmuls (mirrors `freefine_tpu.ops.resize`
and the `jax.image.resize` calls of the JAX package).

Two conventions, each exact on its own terms:

  * torch's `F.interpolate(mode="bicubic", align_corners=False)`: the
    cubic-convolution kernel with A = -0.75, half-pixel centres, taps
    clamped at the border, no antialiasing (`torch_cubic_weight_matrix`,
    `interpolate_bicubic`) — the models re-hosted from torch (DINOv2's and
    EfficientSAM's position tables, EfficientSAM's output mask);
  * `jax.image.resize` for "linear", "cubic" and "lanczos3"
    (`resize_weights`, `resize`): one scale-and-translate weight function
    with three kernels (the triangle, Keys' cubic with a = -0.5, Lanczos of
    radius 3), each stretched by the inverse scale when shrinking if
    `antialias` (JAX's default), columns renormalised, samples outside the
    input zeroed.  `F.interpolate` matches none of these when shrinking.

Every weight matrix is built in float32 on the tensor's device and applied
with one contraction per resized axis; axes whose size does not change are left
alone, as JAX leaves them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


@lru_cache(maxsize=None)
def torch_cubic_weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] row-stochastic float32 matrix reproducing torch's 1-D
    upsample_bicubic (align_corners=False, antialias=False, A=-0.75)."""
    a = -0.75
    out = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        t = src - i0
        w = np.empty(4, np.float64)
        w[0] = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
        w[1] = ((a + 2) * t - (a + 3)) * t * t + 1
        w[2] = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) ** 2 + 1
        w[3] = 1.0 - w[0] - w[1] - w[2]
        for tap, wt in zip(range(i0 - 1, i0 + 3), w):
            out[o, min(max(tap, 0), n_in - 1)] += wt
    return out.astype(np.float32)


def _apply(x: torch.Tensor, weights: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract `x`'s `axis` with weights [n_in, n_out]; the new axis takes
    the old one's place."""
    return torch.movedim(torch.tensordot(x, weights, dims=([axis], [0])), -1, axis)


def interpolate_bicubic(x: torch.Tensor, size: Sequence[int], h_axis: int = -3,
                        w_axis: int = -2) -> torch.Tensor:
    """torch `F.interpolate(mode="bicubic", align_corners=False)` on two
    axes of `x` (by default NHWC's H and W), computed in float32 and
    returned in x's dtype.  `size` is (out_h, out_w)."""
    h_axis %= x.ndim
    w_axis %= x.ndim
    y = x.float()
    for axis, n in ((h_axis, int(size[0])), (w_axis, int(size[1]))):
        wts = torch.from_numpy(torch_cubic_weight_matrix(y.shape[axis], n)).to(x.device)
        y = _apply(y, wts.T, axis)
    return y.to(x.dtype)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel, a = -0.5 (JAX's "cubic")."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    """3 sin(pi x) sin(pi x / 3) / (pi x)^2, 1 below 1e-3, 0 beyond 3."""
    pi = torch.tensor(np.pi, dtype=torch.float32)
    y = 3.0 * torch.sin(pi * x) * torch.sin(pi * x / 3.0)
    k = torch.where(x > 1e-3, y / torch.where(x != 0, pi**2 * x**2, torch.ones_like(x)),
                    torch.ones_like(x))
    return torch.where(x > 3.0, torch.zeros_like(k), k)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic, "lanczos3": _lanczos3}


def resize_weights(in_size: int, out_size: int, method: str, antialias: bool = True,
                   device=None) -> torch.Tensor:
    """The [in_size, out_size] float32 weights with which `jax.image.resize`
    resamples one axis with `method`: output i samples the input at
    (i + 0.5) / scale - 0.5, scale = out_size / in_size, through the
    method's kernel, stretched by max(1 / scale, 1) when `antialias`; each
    column is divided by its sum (zero where that sum is about 0), and a
    column whose sample lies outside [-0.5, in_size - 0.5] is zero."""
    kernel = _KERNELS[method]
    inv_scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if antialias
                    else torch.tensor(1.0)).to(device)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale.to(device) - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    k = kernel(x.abs() / kernel_scale)
    total = k.sum(dim=0, keepdim=True)
    k = torch.where(total.abs() > 1000.0 * _EPS32,
                    k / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(k))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], k, torch.zeros_like(k))


def resize(x: torch.Tensor, size: Sequence[int], method: str, antialias: bool = True,
           axes: Sequence[int] = (0, 1)) -> torch.Tensor:
    """`jax.image.resize` of `x`'s `axes` to `size` (one entry per axis)
    with "linear", "cubic" or "lanczos3", in float32, on x's device; an
    axis whose size does not change is not resampled."""
    y = x.float()
    for axis, n in zip(axes, size):
        axis %= y.ndim
        if y.shape[axis] != int(n):
            y = _apply(y, resize_weights(y.shape[axis], int(n), method, antialias, y.device),
                       axis)
    return y


def lanczos3_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """`resize_weights` of `jax.image.resize(..., method="lanczos3")`
    (antialiased, its default)."""
    return resize_weights(in_size, out_size, "lanczos3", device=device)


def resize_lanczos3(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H, W, C] -> float32 [height, width, C], `jax.image.resize`'s
    antialiased lanczos3 on the axes whose size changes, on img's device;
    the channel axis is never resized."""
    return resize(img, (height, width), "lanczos3")
