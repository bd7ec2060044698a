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

Routing (`use_fused`, read at call time): FREEFINE_FUSED_GN "1" on, "0"
off, "auto" (the default) on for a tensor on a CUDA device and off
elsewhere, as JAX's "auto" fuses on the TPU only; any other value raises.
On the CPU "auto" is the "0" route.  JAX also keeps the plain math where
the NHWC slab would not fit its kernel's VMEM tile or H is not a multiple
of 8 (`_tile_bytes`, `_ROW_CHUNK`); those rules describe the TPU tile,
not the function, so the port fuses every 4-D norm whose channels split
into the groups, the 512^2 VAE slabs included (ROADMAP C: a route
deviation that changes rounding only).

Dispatch: a tensor on the CPU goes to the plain twin; a CUDA tensor
launches the kernel or raises.  The kernel works on the channels-last
layout (NHWC in memory), which every call on the SD-1.5 paths has: the
convolutions pass the pipeline's NHWC latents' layout on.  Any other input
(an NCHW-contiguous tensor of the tests or the tiny config) is copied to
it first; y is channels-last.  Each call is one launch of one cluster
kernel (`launch_plan` says how it covers the tensor).  `LAUNCHES` counts
calls of the op and `LAUNCH_SHAPES` the same calls by shape.

`group_norm_reference` returns its result in the memory format of its
input (channels-last in, channels-last out), so that the convolution
after it does not transpose; its values do not depend on the layout.
"""

from __future__ import annotations

import functools
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

_VEC = {torch.bfloat16: 8, torch.float32: 4}  # elements per 16-byte load
_ES = {torch.bfloat16: 2, torch.float32: 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The cluster kernel (csrc/group_norm.cu) and the H100 it is sized for.
_THREADS = 256              # threads per CTA
_MAX_CLUSTER = 16           # CTAs per cluster (above 8: non-portable)
_MAX_BOX = 256              # TMA box edge, elements
_SMEM_MAX = 232448          # dynamic shared memory of one CTA (227 KB)
_SMS = 132
_MIN_CTA_BYTES = 16384      # a CTA below this much of x is not worth a cluster rank
_MIN_ROW_BYTES = 64         # the resident route's narrowest block row (narrower costs more a byte)
_MAX_CTAS = 192             # the resident route's most CTAs (beyond, cluster launches cost more)
_STREAM_UNIT_BYTES = 524288  # a unit above this much of x streams
_STREAM_UNITS = 4           # the streamed route's fewest units (clusters of 16)
_RING_BYTES = 98304         # the streamed route's ring of TMA boxes, bytes per CTA


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


FUSED_GN_MODES = ("0", "1", "auto")


def fused_gn_mode() -> str:
    """FREEFINE_FUSED_GN: "0", "1" or "auto" (unset: "auto"); any other
    value raises."""
    mode = os.environ.get("FREEFINE_FUSED_GN", "auto")
    if mode not in FUSED_GN_MODES:
        raise ValueError(f"FREEFINE_FUSED_GN={mode!r}: expected one of {FUSED_GN_MODES}")
    return mode


def fused_gn_route(device) -> str:
    """The route FREEFINE_FUSED_GN resolves to for a tensor on `device`:
    "1" (the kernel) or "0" (the two-pass math)."""
    mode = fused_gn_mode()
    if mode == "auto":
        return "1" if torch.device(device).type == "cuda" else "0"
    return mode


def use_fused(shape: Sequence[int], num_groups: int = 32, device="cpu") -> bool:
    """Whether a norm over an NCHW activation of `shape` on `device` takes
    `group_norm_silu` (FREEFINE_FUSED_GN, read at every call)."""
    return (fused_gn_route(device) == "1" and len(shape) == 4
            and shape[1] % num_groups == 0)


# ---------------------------------------------------------------------------
# Plain math
# ---------------------------------------------------------------------------


def _affine_shape(x: torch.Tensor) -> tuple:
    return (1, x.shape[1]) + (1,) * (x.ndim - 2)


def group_norm_reference(x, scale, bias, *, num_groups: int, eps: float,
                         apply_silu: bool) -> torch.Tensor:
    """Two-pass GroupNorm in float32 (`F.group_norm` on the cast), optional
    SiLU, output cast back to x's dtype in x's memory format.  x [B, C, ...].
    (On CUDA `F.group_norm` computes on an NCHW copy and returns NCHW; the
    cast back also restores a channels-last input's layout, in one copy.)"""
    y = F.group_norm(x.float(), num_groups, scale.float(), bias.float(), eps)
    if apply_silu:
        y = F.silu(y)
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return y.to(x.dtype, memory_format=torch.channels_last)
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


def smem_bytes(stages: int, stage_bytes: int, stat_floats: int, block_channels: int,
               groups_per_block: int) -> int:
    """Dynamic shared memory of one CTA (`gn::smem_bytes`): the ring of
    TMA boxes, the per-thread sums (two slots per channel and position
    phase), the channels' shifts, the CTA's per-group partials and the
    groups' mean and rstd, one mbarrier per stage."""
    floats = 2 * stat_floats + max(_THREADS, block_channels) + 5 * groups_per_block
    return stages * stage_bytes + -(-floats * 4 // 8) * 8 + 8 * stages


def launch_plan(x: torch.Tensor, num_groups: int) -> dict:
    """How one launch of the cluster kernel covers a channels-last x
    [B, C, H, W]:

      * a unit is one image times a block of `groups_per_block` whole
        groups (`block_channels` channels); `units` = B * blocks, one
        cluster each, of `cluster` CTAs, CTA r taking positions
        [r * rows_per_cta, (r + 1) * rows_per_cta) of the H * W;
      * route "resident": each CTA's positions stay in shared memory as
        `stages` TMA boxes of `box_rows` positions (x read once);
        "streamed": they pass twice through a ring of `stages` boxes (x
        read twice, one launch); "plain": the layout is no TMA operand (a
        position's channels, or every group block, not a multiple of 16
        bytes, or x not 16-byte aligned): one element per thread, ordinary
        loads, x read twice;
      * `smem_bytes`: dynamic shared memory per CTA.

    The choice follows the kernel's times on an H100 over the plans at
    every SD-1.5 shape (`scripts/gn_plan_sweep.py`): a block row narrower
    than 64 bytes costs more a byte, and more than about 192 CTAs of
    clusters cost launch time; the streamed route is bound by the card's
    traffic, so it wants the widest rows over enough clusters.  So: a unit above 512 KB (at the narrowest block of 64 bytes
    or more) streams, in clusters of 16 over the widest block that leaves
    at least 4 units and whose ring of two boxes or more fits; any other
    stays resident at that narrowest block, in the largest cluster (of 1
    to 16 CTAs) that keeps to 192 CTAs and 16 KB of x a CTA (else the
    smallest cluster whose boxes fit).  No global scratch on any route."""
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("group_norm_silu: the kernel takes a channels_last tensor")
    b, c, h, w = x.shape
    return dict(_plan(b, c, h * w, num_groups, x.dtype, x.data_ptr() % 16 == 0))


def group_blocks(c: int, groups: int, dtype: torch.dtype) -> list:
    """Groups per block of the TMA routes, narrowest first: whole groups
    whose row is a multiple of 16 bytes and at most 256 elements."""
    es, cpg = _ES[dtype], c // groups
    return [k for k in range(1, groups + 1)
            if groups % k == 0 and k * cpg * es % 16 == 0 and k * cpg <= _MAX_BOX]


def layout(b: int, c: int, hw: int, groups: int, dtype: torch.dtype, gb: int, n: int,
           route: str):
    """The TMA-route plan of `route` ("resident" or "streamed") for blocks
    of gb groups in clusters of n CTAs, or None where it does not apply (a
    CTA without positions, a resident CTA of less than 16 KB in a cluster,
    a ring of fewer than two boxes) or its shared memory does not fit."""
    es, cpg = _ES[dtype], c // groups
    cb, units = gb * cpg, b * (groups // gb)
    per = -(-hw // n)
    boxes = -(-per // _MAX_BOX)
    box = min((-(-per // boxes) + 7) // 8 * 8, hw)  # equal boxes of a multiple of 8 rows
    rows = boxes * box
    stage_bytes = -(-box * cb * es // 128) * 128
    if (n - 1) * rows >= hw:
        return None
    if route == "resident":
        if n > 1 and rows * cb * es < _MIN_CTA_BYTES:
            return None
        stages = boxes
    else:
        if boxes <= 2:
            return None
        stages = max(2, min(boxes - 1, _RING_BYTES // stage_bytes))
    smem = smem_bytes(stages, stage_bytes, _THREADS * _VEC[dtype], cb, gb)
    if smem > _SMEM_MAX:
        return None
    return dict(route=route, cluster=n, rows_per_cta=rows, box_rows=box, stages=stages,
                smem_bytes=smem, vec=_VEC[dtype], groups_per_block=gb, block_channels=cb,
                units=units)


@functools.lru_cache(maxsize=None)
def _plan(b: int, c: int, hw: int, groups: int, dtype: torch.dtype, aligned: bool) -> tuple:
    es, cpg = _ES[dtype], c // groups
    blocks = group_blocks(c, groups, dtype)
    if not blocks or c * es % 16 or not aligned:
        return _plain_plan(b, c, hw, groups)
    narrow = next((gb for gb in blocks if gb * cpg * es >= _MIN_ROW_BYTES), blocks[-1])
    wide = [gb for gb in blocks if b * (groups // gb) >= _STREAM_UNITS] or blocks[:1]
    streamed = [p for p in (layout(b, c, hw, groups, dtype, gb, _MAX_CLUSTER, "streamed")
                            for gb in reversed(wide)) if p]
    if streamed and hw * narrow * cpg * es > _STREAM_UNIT_BYTES:
        return tuple(streamed[0].items())
    resident = [p for p in (layout(b, c, hw, groups, dtype, narrow, n, "resident")
                            for n in range(1, _MAX_CLUSTER + 1)) if p]
    few = [p for p in resident if p["units"] * p["cluster"] <= _MAX_CTAS]
    plan = few[-1] if few else resident[0] if resident else streamed[0] if streamed else None
    return tuple(plan.items()) if plan else _plain_plan(b, c, hw, groups)


def _plain_plan(b: int, c: int, hw: int, groups: int) -> tuple:
    """The plain-load route: one group per block, one element per thread,
    a cluster of up to 8 CTAs of at least 32 positions each."""
    cpg = c // groups
    units = b * groups
    n = 1
    while n < 8 and units * n < _SMS and hw // (2 * n) >= 32:
        n *= 2
    return tuple(dict(route="plain", cluster=n, rows_per_cta=-(-hw // n), box_rows=0, stages=0,
                      smem_bytes=smem_bytes(0, 0, max(_THREADS, cpg), cpg, 1), vec=1,
                      groups_per_block=1, block_channels=cpg, units=units).items())


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
    x = x.contiguous(memory_format=torch.channels_last)
    plan = launch_plan(x, num_groups)
    if plan["units"] > 65535:
        raise ValueError(f"group_norm_silu: {plan['units']} (batch, group block) units exceed "
                         "the grid")
    y = torch.empty_like(x, memory_format=torch.channels_last)
    lib = cuda_build.library("group_norm")
    code = lib.group_norm_silu_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), b, c, h * w, num_groups,
        float(eps), plan["groups_per_block"], plan["cluster"], plan["rows_per_cta"],
        plan["box_rows"], plan["stages"], plan["smem_bytes"], int(apply_silu),
        _DTYPE_CODE[x.dtype], plan["vec"], torch.cuda.current_stream(x.device).cuda_stream,
    )
    if code:
        cuda_build.check(lib, f"group_norm_silu {tuple(x.shape)} {x.dtype} plan {plan}", code)
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
