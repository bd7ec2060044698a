"""Fused GroupNorm(+SiLU) of the port: the kernel wrapper, its plain twin,
the two-pass reference math and the autograd function.

  * `group_norm_silu` — GroupNorm over an NCHW tensor with float32
    statistics, the per-channel affine and an optional SiLU, output in x's
    dtype (CUDA kernel `csrc/group_norm.cu`; replaces the Pallas
    `_gn_kernel`, freefine_tpu/ops/group_norm.py:86, reached through
    `_fused_gn_impl` :187).
  * `group_norm_silu_reference` — its plain twin, with the TPU kernel's
    formula (:107-135): float32 sums and sums of squares per (batch,
    group), var = E[x^2] - mean^2, rsqrt(var + eps), the affine, the SiLU.
  * `group_norm_reference` — the two-pass float32 math (`F.group_norm` on
    the float32 cast), the route `GroupNorm32` takes when the kernel is off.
  * `GroupNormSiLU` — differentiable `group_norm_silu`: the forward is the
    kernel, the backward pulls the cotangent through `group_norm_reference`
    as JAX's `_fused_gn_bwd` (:153) does; there is no backward kernel, as in
    JAX.  `group_norm_silu_diff` takes it only under differentiation.

Routing (`use_fused`, read at call time): FREEFINE_FUSED_GN "1" on, any
other value (the default "0") off.  JAX's "auto" (on the TPU) has no
counterpart: the route is chosen by the user, not by the device.  JAX also keeps the plain math where the NHWC slab would not fit its
kernel's VMEM tile or H is not a multiple of 8 (`_tile_bytes`,
`_ROW_CHUNK`); those rules describe the TPU tile, not the function, so the
port fuses every 4-D norm whose channels split into the groups, the 512^2
VAE slabs included (ROADMAP C: a route deviation that changes rounding
only).

Dispatch: a tensor on the CPU goes to the plain twin; a CUDA tensor
launches the kernel or raises.  The kernel works on the channels-last
layout (NHWC in memory), which every call on the SD-1.5 paths has: the
convolutions pass the pipeline's NHWC latents' layout on.  Any other input
(an NCHW-contiguous tensor of the tests or the tiny config) is copied to
it first; y is channels-last.  `LAUNCHES` counts calls of the op (three
kernel launches each) and `LAUNCH_SHAPES` the same calls by shape.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import Sequence

import torch
import torch.nn.functional as F

from freefine_tpu_torch.ops import cuda_build

KERNELS = ("group_norm_silu",)
LAUNCHES = {name: 0 for name in KERNELS}
# (kernel, batch, channels, height, width, groups, eps, dtype name, silu)
#  -> launches
LAUNCH_SHAPES: Counter = Counter()

# Statistics pass of the kernel (csrc/group_norm.cu): each batch's
# positions are split over enough blocks to give each of the H100's 132 SMs
# about eight, each split at least 64 positions.
_TARGET_BLOCKS = 8 * 132
_VEC = {torch.bfloat16: 8, torch.float32: 4}  # elements per 16-byte load
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


def use_fused(shape: Sequence[int], num_groups: int = 32) -> bool:
    """Whether a norm over an NCHW activation of `shape` takes
    `group_norm_silu` (FREEFINE_FUSED_GN, read at every call)."""
    return (os.environ.get("FREEFINE_FUSED_GN", "0") == "1" and len(shape) == 4
            and shape[1] % num_groups == 0)


# ---------------------------------------------------------------------------
# Plain math
# ---------------------------------------------------------------------------


def _affine_shape(x: torch.Tensor) -> tuple:
    return (1, x.shape[1]) + (1,) * (x.ndim - 2)


def group_norm_reference(x, scale, bias, *, num_groups: int, eps: float,
                         apply_silu: bool) -> torch.Tensor:
    """Two-pass GroupNorm in float32 (`F.group_norm` on the cast), optional
    SiLU, output cast back to x's dtype.  x [B, C, ...]."""
    y = F.group_norm(x.float(), num_groups, scale.float(), bias.float(), eps)
    if apply_silu:
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_silu_reference(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5,
                              apply_silu: bool = True) -> torch.Tensor:
    """Plain twin of `group_norm_silu`, the TPU kernel's formula: float32
    sums per (batch, group), var = E[x^2] - mean^2, then
    (x - mean) * rsqrt(var + eps) * scale + bias and y * sigmoid(y)."""
    b = x.shape[0]
    xf = x.float().reshape(b, num_groups, -1)
    n = xf.shape[-1]
    mean = xf.sum(-1, keepdim=True) / n
    var = (xf * xf).sum(-1, keepdim=True) / n - mean * mean
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * scale.float().reshape(_affine_shape(x)) + bias.float().reshape(_affine_shape(x))
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def launch_plan(x: torch.Tensor) -> dict:
    """How the kernel covers a channels-last x [B, C, H, W]: the load width
    `vec` (16 bytes where the channels allow), and `nsplit` position splits
    of `chunk` positions per batch, each the statistics of one block per 32
    vectors of channels, with the float32 scratch they need."""
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm_silu: the kernel takes a channels_last tensor")
    b, c, h, w = x.shape
    hw = h * w
    vec = _VEC[x.dtype]
    if c % vec or x.data_ptr() % 16:
        vec = 1
    col_blocks = -(-(c // vec) // 32)
    nsplit = max(1, min(-(-_TARGET_BLOCKS // (col_blocks * b)), -(-hw // 64)))
    chunk = -(-hw // nsplit)
    nsplit = -(-hw // chunk)
    return dict(vec=vec, nsplit=nsplit, chunk=chunk, scratch=b * nsplit * c * 3 + b * c * 2)


def _check(x, scale, bias, num_groups: int) -> None:
    if x.ndim != 4:
        raise ValueError(f"group_norm_silu: expected an NCHW tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"group_norm_silu: dtype {x.dtype} not supported (float32, bfloat16)")
    c = x.shape[1]
    if num_groups <= 0 or c % num_groups:
        raise ValueError(f"group_norm_silu: {c} channels do not split into {num_groups} groups")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"group_norm_silu: {name} must be float32 [{c}] on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def group_norm_silu(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5,
                    apply_silu: bool = True) -> torch.Tensor:
    """GroupNorm(+SiLU) of x [B, C, H, W] with float32 scale and bias [C];
    output in x's dtype.  Not differentiable (see `group_norm_silu_diff`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        raise RuntimeError(
            "group_norm_silu: called under grad mode on an operand that requires grad, but "
            "the kernel has no backward and its output would be cut from autograd. Use "
            "group_norm_silu_diff (GroupNormSiLU) for gradients, or call it under "
            "torch.no_grad().")
    _check(x, scale, bias, num_groups)
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, scale, bias, num_groups=num_groups, eps=eps,
                                         apply_silu=apply_silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("group_norm_silu: scale and bias must be contiguous")
    b, c, h, w = x.shape
    if b * num_groups > 65535:
        raise ValueError(f"group_norm_silu: {b * num_groups} (batch, group) pairs exceed the grid")
    x = x.contiguous(memory_format=torch.channels_last)
    plan = launch_plan(x)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    scratch = torch.empty(plan["scratch"], dtype=torch.float32, device=x.device)
    lib = cuda_build.library("group_norm")
    code = lib.group_norm_silu_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), scratch.data_ptr(),
        b, c, h * w, num_groups, float(eps), plan["nsplit"], plan["chunk"], int(apply_silu),
        _DTYPE_CODE[x.dtype], plan["vec"], torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(lib, "group_norm_silu", code)
    LAUNCHES["group_norm_silu"] += 1
    LAUNCH_SHAPES[("group_norm_silu", b, c, h, w, num_groups, float(eps),
                   str(x.dtype).removeprefix("torch."), bool(apply_silu))] += 1
    return y


class GroupNormSiLU(torch.autograd.Function):
    """Differentiable `group_norm_silu` (JAX's custom VJP `_fused_gn`): the
    kernel forward; the backward recomputes `group_norm_reference` under
    autograd and pulls the cotangent through it to x, scale and bias."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, apply_silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = dict(num_groups=num_groups, eps=eps, apply_silu=apply_silu)
        return group_norm_silu(x, scale, bias, **ctx.cfg)

    @staticmethod
    def backward(ctx, ct):
        # autograd calls this only when at least one of x, scale, bias needs a gradient
        leaves = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            y = group_norm_reference(*leaves, **ctx.cfg)
            grads = iter(torch.autograd.grad(y, [t for t in leaves if t.requires_grad], ct))
        return (*(next(grads) if t.requires_grad else None for t in leaves), None, None, None)


def group_norm_silu_diff(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5,
                         apply_silu: bool = True) -> torch.Tensor:
    """`group_norm_silu` with a gradient: `GroupNormSiLU` under
    differentiation (grad mode on and an operand that requires grad), the
    plain wrapper otherwise."""
    kw = dict(num_groups=num_groups, eps=eps, apply_silu=apply_silu)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        return GroupNormSiLU.apply(x, scale, bias, *kw.values())
    return group_norm_silu(x, scale, bias, **kw)
