#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`freefine_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure raises and exits non-zero; nothing is caught):
  1. print the card's name and power limit; build the CUDA kernels from
     `freefine_tpu_torch/csrc` (one nvcc per source, in parallel) and print
     each instantiation's registers, stack and spills;
  2. hold each kernel against its plain PyTorch twin on the card at every
     shape of the two SD-1.5 512^2 paths (bf16, and f32 at the VAE shape),
     plus fully masked, ragged and f32 cases, within limits scaled to each
     output tensor, with teeth (the twin with a key or query tile dropped
     must fail); time the kernel, the twin and, as a yardstick only, the
     PyTorch call that computes the same (`F.scaled_dot_product_attention`,
     its forward or its autograd backward); check one gradient through
     `flash_sdpa_diff` on the card against the twin's autograd gradient;
  3. the tiny config end to end on CUDA and on the CPU with the same f32
     weights and noise (TF32 off), `generation` and `guided_generation`,
     final latents compared;
  4. the full-width SD-1.5 512^2 edit: `re_edit_2d`, then `generation` with
     50 DDIM steps, start 35, guidance 7.5, eta 1.0, TCA, bf16 random
     weights; one warm-up and two timed edits, launch counters checked
     against the expected per-edit counts, and the launches by call shape
     against the shapes of phase 2;
  5. the full-width SD-1.5 512^2 energy-guided edit: `guided_generation`
     with its defaults (50 steps, start 25, energy on the first 0.6 of the
     25 regeneration steps, energy scale 2.0, TCA); one warm-up and two
     timed edits, the same checks; one more edit measures the forward of the
     differentiated pass that no gradient reads (up blocks 2-3, conv_out);
  6. the result lines: the `kernels` JSON line (launches and per-edit times
     per path: each shape's time weighted by its launches counted in phases
     4 and 5), the nvidia-smi line, and last `{"ok": true, "device": {...}}`.

A JSON record of the whole run is written to chiprun_out/chip_smoke.json.
Exits with code 2 and prints no result when CUDA is not available.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet; dense): the bound of a call is
# the larger of bytes / HBM rate and its operations over the peak of their
# type, exponentials counted at 16 SFU ops/clk/SM x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SFU_EXPS_PER_S = 16 * 132 * 1.98e9

# Each kernel is held to its twin, per shape, on two counts:
#  * max |out - ref| <= ABS_OF_MAX[dtype] * max |ref|: the limit scales with
#    the output (bf16 keeps 8 significant bits, so 2^-5 is 4 to 8 units in
#    the last place of the largest output), and one wrong row fails it;
#  * ||out - ref|| / ||ref|| <= REL_TOL[dtype] over the whole output.
# Both twins round P to bf16 before P.V as the kernels do, so in bf16 what
# remains is the output's own rounding; in f32 the summation order and the
# fast exp.  At every main-path shape the script also checks that the twin
# with its first DROP_KEYS keys left out fails these limits (`_teeth`).
ABS_OF_MAX = {"bfloat16": 2.0**-5, "float32": 1e-4}
REL_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
DROP_KEYS = 32  # the smallest key tile of either kernel

def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, exps: float, dtype: str) -> dict:
    """Least time of a call (ms) and what sets it."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * max(flops / PEAK_FLOPS[dtype], exps / SFU_EXPS_PER_S)
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def ptxas_report(libs) -> list:
    """Registers, stack and spills of every kernel instantiation, from the
    ptxas report that `cuda_build` keeps beside each library."""
    rows = []
    for name, lib in sorted(libs.items()):
        lines = lib.with_suffix(".log").read_text().splitlines()
        for i, line in enumerate(lines):
            if "Function properties for" not in line:
                continue
            fn = line.split("Function properties for", 1)[1].strip()
            props = lines[i + 1].strip() if i + 1 < len(lines) else ""
            used = next((ln.split("Used", 1)[1].strip() for ln in lines[i + 2 : i + 4]
                         if "Used" in ln), "")
            rows.append(dict(library=name, function=fn, properties=props, used=used))
    if rows and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r["function"] for r in rows),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        for r, n in zip(rows, names):
            r["function"] = n
    for r in rows:
        log(f"  ptxas {r['library']}: {r['function'].split('(')[0]}: {r['properties']}; "
            f"{r['used']}")
    return rows


# ---------------------------------------------------------------------------
# Phase 2: kernels against their twins
# ---------------------------------------------------------------------------

# (batch, heads, seq, head_dim, dtype) of every call on the two SD-1.5 512^2
# paths: inversion batch 2, regeneration batch 3 outside the TCA window, the
# energy's no-grad reference-feature pass batch 1, VAE mid-block f32 one
# head of 512.  Phases 4 and 5 count the launches at each shape and fail on
# a shape not timed here, or a shape timed here that neither launches.
FLASH_SHAPES = [
    (2, 8, 4096, 40, "bfloat16"), (2, 8, 1024, 80, "bfloat16"),
    (2, 8, 256, 160, "bfloat16"), (2, 8, 64, 160, "bfloat16"),
    (3, 8, 4096, 40, "bfloat16"), (3, 8, 1024, 80, "bfloat16"),
    (3, 8, 256, 160, "bfloat16"), (3, 8, 64, 160, "bfloat16"),
    (1, 8, 4096, 40, "bfloat16"), (1, 8, 1024, 80, "bfloat16"),
    (1, 8, 256, 160, "bfloat16"), (1, 8, 64, 160, "bfloat16"),
    (2, 1, 4096, 512, "float32"),
]
# check-only: masked keys with fully masked rows, ragged lengths
FLASH_EXTRA = [(2, 8, 1000, 80, "bfloat16"), (2, 1, 300, 512, "float32"),
               (3, 2, 77, 16, "float32"), (3, 2, 77, 16, "bfloat16"), (1, 2, 5, 24, "bfloat16")]
# TCA after the head-parity split: batch 2*3 streams, 4 heads
TCA_SHAPES = [(6, 4, 1024, 80, "bfloat16"), (6, 4, 4096, 40, "bfloat16")]
TCA_EXTRA = [(6, 4, 1000, 40, "bfloat16"), (6, 1, 64, 16, "float32"),
             (6, 1, 64, 16, "bfloat16"), (4, 2, 33, 24, "bfloat16")]
# The differentiated pass of energy guidance: batch 1, every self-attention
# of the plain UNet (forward with logsumexp; the backward reaches the 10
# layers upstream of the feature taps: down 6, mid 1, up block 1 3).
GRAD_SHAPES = [(1, 8, 4096, 4096, 40, "bfloat16"), (1, 8, 1024, 1024, 80, "bfloat16"),
               (1, 8, 256, 256, 160, "bfloat16"), (1, 8, 64, 64, 160, "bfloat16")]
# check-only, all masked with one fully masked batch row: ragged Sq != Sk,
# and f32 at the tiny configuration's head dims (16, 32, 64)
GRAD_EXTRA = [(2, 2, 1024, 1024, 80, "bfloat16"), (2, 2, 300, 77, 40, "bfloat16"),
              (2, 2, 100, 260, 160, "bfloat16"), (2, 2, 5, 7, 24, "bfloat16"),
              (2, 2, 64, 64, 16, "float32"), (2, 2, 16, 16, 32, "float32"),
              (2, 2, 50, 33, 64, "float32"), (2, 2, 4, 4, 64, "float32")]
AUTOGRAD_SHAPE = (1, 8, 1024, 80, "bfloat16")


def _inputs(gen, b, h, s, d, dtype, n):
    import torch

    dt = getattr(torch, dtype)
    return [torch.randn(b, s, h * d, generator=gen, device=gen.device).to(dt) for _ in range(n)]


def _parity_rows(gen, b, s, frac):
    """[b, s] rows: the even half random 0/1, the odd half ones (the
    head-parity split's unmasked block)."""
    import torch

    rows = torch.ones(b, s, device=gen.device)
    rows[: b // 2] = (torch.rand(b // 2, s, generator=gen, device=gen.device) > frac).float()
    return rows


def compare(out, ref) -> dict:
    diff = out.float() - ref.float()
    return dict(max_abs_err=float(diff.abs().max()), max_ref=float(ref.float().abs().max()),
                rel_err=float(diff.norm() / ref.float().norm()),
                finite=bool(out.float().isfinite().all()))


def err_over_tol(c: dict, dtype: str) -> float:
    """The larger of the two errors over its limit: <= 1 passes."""
    return max(c["max_abs_err"] / (ABS_OF_MAX[dtype] * c["max_ref"]),
               c["rel_err"] / REL_TOL[dtype])


def _hold(name, out, ref, row, dtype=None, tensor=None):
    """Hold one output tensor to its twin; with several outputs per kernel
    (`tensor` names each) the row keeps each one's numbers and the worst."""
    c = compare(out, ref)
    c["err_over_tol"] = err_over_tol(c, dtype or row["dtype"])
    if tensor is None:
        row.update(c)
    else:
        row.setdefault("tensors", {})[tensor] = c
        for key in ("max_abs_err", "rel_err", "err_over_tol"):
            row[key] = max(row.get(key, 0.0), c[key])
        row["max_ref"] = max(row.get("max_ref", 0.0), c["max_ref"])
        row["finite"] = row.get("finite", True) and c["finite"]
    if not c["finite"] or not c["err_over_tol"] <= 1.0:
        raise AssertionError(f"{name} disagrees with its twin ({tensor or 'out'}): {row}")


def _teeth(name, ref, dropped, row, what="key", tensor=None):
    """The limits must reject the twin with its first DROP_KEYS keys (or
    queries) left out, as a kernel that skipped one tile would give.  The
    row keeps the weakest such margin (and each tensor's under `tensors`)."""
    e = err_over_tol(compare(dropped, ref), row["dtype"])
    row["dropped_tile_err_over_tol"] = min(row.get("dropped_tile_err_over_tol", e), e)
    if tensor is not None:
        row["tensors"][tensor][f"dropped_{what}_tile_err_over_tol"] = e
    if e <= 1.0:
        raise AssertionError(f"{name}: the limits accept a dropped {what} tile "
                             f"({tensor or 'out'}): {row}")


def check_flash(gen, shape, timed: bool):
    import torch
    import torch.nn.functional as F

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, s, d, dtype = shape
    q, k, v = _inputs(gen, b, h, s, d, dtype, 3)
    mask = None
    if not timed:
        mask = (torch.rand(b, s, generator=gen, device=gen.device) > 0.5).float()
        mask[b - 1] = 0.0  # a fully masked row block
    out = FA.flash_sdpa(q, k, v, mask, heads=h)
    ref = FA.flash_sdpa_reference(q, k, v, mask, heads=h)
    torch.cuda.synchronize()
    row = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype,
               masked=mask is not None)
    _hold("flash_sdpa", out, ref, row)
    if timed:
        n = min(DROP_KEYS, s // 2)
        _teeth("flash_sdpa", ref, FA.flash_sdpa_reference(q, k[:, n:], v[:, n:], heads=h), row)
        itemsize = q.element_size()
        nbytes = 4 * b * s * h * d * itemsize
        row.update(bound(nbytes, 4.0 * b * h * s * s * d, float(b * h * s * s), dtype))
        n = 3 if s >= 4096 else 10
        row["kernel_ms"] = cuda_ms(lambda: FA.flash_sdpa(q, k, v, heads=h), n)
        row["plain_ms"] = cuda_ms(lambda: FA.flash_sdpa_reference(q, k, v, heads=h), n)
        qh, kh, vh = (x.reshape(b, s, h, d).transpose(1, 2).contiguous() for x in (q, k, v))
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), n)
    return row


def check_tca(gen, shape, timed: bool):
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, s, d, dtype = shape
    q, ks, vs, km, vm = _inputs(gen, b, h, s, d, dtype, 5)
    fg = _parity_rows(gen, b, s, 0.5)
    tq = _parity_rows(gen, b, s, 0.4)
    cg = 0.7
    out = FA.tca_flash(q, ks, vs, km, vm, fg, tq, cg, heads=h)
    ref = FA.tca_flash_reference(q, ks, vs, km, vm, fg, tq, cg, heads=h)
    torch.cuda.synchronize()
    row = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype, masked=True)
    _hold("tca_flash", out, ref, row)
    if timed:
        n = min(DROP_KEYS, s // 2)
        _teeth("tca_flash", ref, FA.tca_flash_reference(
            q, ks[:, n:], vs[:, n:], km[:, n:], vm[:, n:], fg[:, n:], tq, cg, heads=h), row)
        itemsize = q.element_size()
        nbytes = 6 * b * s * h * d * itemsize + 2 * b * s * 4
        row.update(bound(nbytes, 10.0 * b * h * s * s * d, 3.0 * b * h * s * s, dtype))
        n = 3 if s >= 4096 else 10
        row["kernel_ms"] = cuda_ms(lambda: FA.tca_flash(q, ks, vs, km, vm, fg, tq, cg, heads=h), n)
        row["plain_ms"] = cuda_ms(
            lambda: FA.tca_flash_reference(q, ks, vs, km, vm, fg, tq, cg, heads=h), n)
        row["library_ms"] = None
    return row


def _sdpa_heads(x, h):
    b, s, e = x.shape
    return x.reshape(b, s, h, e // h).transpose(1, 2).contiguous()


def check_grad(gen, shape, timed: bool):
    """The three kernels of the differentiable attention at one shape:
    {kernel name: row}.  The backward kernels and their twins get the same
    residuals (the twin's out and lse) and the same dO."""
    import torch
    import torch.nn.functional as F

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, sq, sk, d, dtype = shape
    q, do = _inputs(gen, b, h, sq, d, dtype, 2)
    k, v = _inputs(gen, b, h, sk, d, dtype, 2)
    mask = None
    if not timed:
        mask = (torch.rand(b, sk, generator=gen, device=gen.device) > 0.5).float()
        mask[b - 1] = 0.0  # a fully masked row block
    base = dict(batch=b, heads=h, seq_q=sq, seq_k=sk, head_dim=d, dtype=dtype,
                masked=mask is not None)
    rows = {n: dict(base) for n in ("flash_sdpa_fwd_lse", "flash_sdpa_bwd_dq",
                                    "flash_sdpa_bwd_dkv")}
    out, lse = FA.flash_sdpa_fwd_lse(q, k, v, mask, heads=h)
    ref_out, ref_lse = FA.flash_sdpa_fwd_lse_reference(q, k, v, mask, heads=h)
    delta = FA.row_delta(ref_out, do, h)
    res = (q, k, v, mask, do, ref_lse, delta)
    dq = FA.flash_sdpa_bwd_dq(*res, heads=h)
    dk, dv = FA.flash_sdpa_bwd_dkv(*res, heads=h)
    ref_dq = FA.flash_sdpa_bwd_dq_reference(*res, heads=h)
    ref_dk, ref_dv = FA.flash_sdpa_bwd_dkv_reference(*res, heads=h)
    torch.cuda.synchronize()
    r = rows["flash_sdpa_fwd_lse"]
    _hold("flash_sdpa_fwd_lse", out, ref_out, r, tensor="out")
    _hold("flash_sdpa_fwd_lse", lse, ref_lse, r, dtype="float32", tensor="lse")
    _hold("flash_sdpa_bwd_dq", dq, ref_dq, rows["flash_sdpa_bwd_dq"], tensor="dq")
    _hold("flash_sdpa_bwd_dkv", dk, ref_dk, rows["flash_sdpa_bwd_dkv"], tensor="dk")
    _hold("flash_sdpa_bwd_dkv", dv, ref_dv, rows["flash_sdpa_bwd_dkv"], tensor="dv")
    if not timed:
        return rows

    n = min(DROP_KEYS, sk // 2, sq // 2)
    _teeth("flash_sdpa_fwd_lse", ref_out, FA.flash_sdpa_fwd_lse_reference(
        q, k[:, n:], v[:, n:], heads=h)[0], r, tensor="out")
    _teeth("flash_sdpa_bwd_dq", ref_dq, FA.flash_sdpa_bwd_dq_reference(
        q, k[:, n:], v[:, n:], None, do, ref_lse, delta, heads=h), rows["flash_sdpa_bwd_dq"])
    dropped = FA.flash_sdpa_bwd_dkv_reference(q[:, n:], k, v, None, do[:, n:],
                                              ref_lse[..., n:].contiguous(),
                                              delta[..., n:].contiguous(), heads=h)
    for name, ref_t, drop_t in (("dk", ref_dk, dropped[0]), ("dv", ref_dv, dropped[1])):
        _teeth("flash_sdpa_bwd_dkv", ref_t, drop_t, rows["flash_sdpa_bwd_dkv"], what="query",
               tensor=name)

    it = q.element_size()
    bh, work = b * h, float(b * h * sq * sk)
    rows["flash_sdpa_fwd_lse"].update(bound(
        (2 * sq + 2 * sk) * bh * d * it + bh * sq * 4, 4.0 * work * d, work, dtype))
    rows["flash_sdpa_bwd_dq"].update(bound(
        (3 * sq + 2 * sk) * bh * d * it + 2 * bh * sq * 4, 6.0 * work * d, work, dtype))
    rows["flash_sdpa_bwd_dkv"].update(bound(
        (2 * sq + 4 * sk) * bh * d * it + 2 * bh * sq * 4, 8.0 * work * d, work, dtype))
    iters = 3 if sq >= 4096 else 10
    timings = {
        "flash_sdpa_fwd_lse": (lambda: FA.flash_sdpa_fwd_lse(q, k, v, heads=h),
                               lambda: FA.flash_sdpa_fwd_lse_reference(q, k, v, heads=h)),
        "flash_sdpa_bwd_dq": (lambda: FA.flash_sdpa_bwd_dq(*res, heads=h),
                              lambda: FA.flash_sdpa_bwd_dq_reference(*res, heads=h)),
        "flash_sdpa_bwd_dkv": (lambda: FA.flash_sdpa_bwd_dkv(*res, heads=h),
                               lambda: FA.flash_sdpa_bwd_dkv_reference(*res, heads=h)),
    }
    for name, (kern, plain) in timings.items():
        rows[name]["kernel_ms"] = cuda_ms(kern, iters)
        rows[name]["plain_ms"] = cuda_ms(plain, iters)
    qh, kh, vh = (_sdpa_heads(x, h).requires_grad_() for x in (q, k, v))
    rows["flash_sdpa_fwd_lse"]["library_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(qh.detach(), kh.detach(), vh.detach()), iters)
    o = F.scaled_dot_product_attention(qh, kh, vh)
    doh = _sdpa_heads(do, h)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(o, (qh, kh, vh), doh, retain_graph=True), iters)
    for name in ("flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"):
        rows[name]["library_ms"] = bwd_ms
        rows[name]["library_call"] = ("autograd backward of F.scaled_dot_product_attention "
                                      "(dq, dk and dv in one call)")
    return rows


def check_autograd(record):
    """One gradient through `flash_sdpa_diff` on the card (forward with
    logsumexp, dQ and dK/dV kernels, wired by `FlashSDPA`) against the same
    autograd call on the CPU, where the function runs its plain twins."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    b, h, s, d, dtype = AUTOGRAD_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = _inputs(gen, b, h, s, d, dtype, 4)
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        out = FA.flash_sdpa_diff(*leaves, heads=h)
        if out.grad_fn is None:
            raise AssertionError("flash_sdpa_diff under grad mode returned no grad_fn")
        grads[dev] = torch.autograd.grad(out, leaves, do.to(dev))
    torch.cuda.synchronize()
    row = dict(batch=b, heads=h, seq_q=s, seq_k=s, head_dim=d, dtype=dtype, masked=False)
    for name, got, want in zip(("dq", "dk", "dv"), grads["cuda"], grads["cpu"]):
        _hold("flash_sdpa_diff autograd", got.cpu(), want, row, tensor=name)
    record["autograd_check"] = row
    log(f"  flash_sdpa_diff autograd on the card vs the CPU twin {AUTOGRAD_SHAPE}: "
        f"{row['err_over_tol']:.3f} of tol")


# name, timed shapes, check-only shapes, source, TPU kernel replaced
KERNELS = (
    ("flash_sdpa", FLASH_SHAPES, FLASH_EXTRA,
     "freefine_tpu_torch/csrc/flash_sdpa.cu", "freefine_tpu/ops/flash_attention.py:80"),
    ("tca_flash", TCA_SHAPES, TCA_EXTRA,
     "freefine_tpu_torch/csrc/tca_flash.cu", "freefine_tpu/ops/flash_attention.py:175"),
    ("flash_sdpa_fwd_lse", GRAD_SHAPES, GRAD_EXTRA,
     "freefine_tpu_torch/csrc/flash_sdpa.cu", "freefine_tpu/ops/flash_attention.py:307"),
    ("flash_sdpa_bwd_dq", GRAD_SHAPES, GRAD_EXTRA,
     "freefine_tpu_torch/csrc/flash_sdpa_bwd.cu", "freefine_tpu/ops/flash_attention.py:344"),
    ("flash_sdpa_bwd_dkv", GRAD_SHAPES, GRAD_EXTRA,
     "freefine_tpu_torch/csrc/flash_sdpa_bwd.cu", "freefine_tpu/ops/flash_attention.py:378"),
)


def _log_row(name, r, timed):
    shape = (r["batch"], r["heads"], r["seq_q"], r["seq_k"], r["head_dim"], r["dtype"])
    msg = (f"  {name} {shape}{'' if timed else ' masked/ragged'}: err {r['max_abs_err']:.3g} "
           f"(max|ref| {r['max_ref']:.3g}, rel {r['rel_err']:.3g}, "
           f"{r['err_over_tol']:.3f} of tol)")
    if timed:
        lib = r["library_ms"]
        msg += (f"; dropped tile {r['dropped_tile_err_over_tol']:.3g} of tol; kernel "
                f"{r['kernel_ms']:.4f} ms plain {r['plain_ms']:.4f} ms library "
                f"{'-' if lib is None else f'{lib:.4f}'} ms bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})")
    log(msg)


def phase_kernels(record):
    """Every kernel at every path shape (timed) and every extra case:
    {name: (rows, checks)}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {name: ([], []) for name, *_ in KERNELS}
    for name, fn, shapes, extra in (("flash_sdpa", check_flash, FLASH_SHAPES, FLASH_EXTRA),
                                    ("tca_flash", check_tca, TCA_SHAPES, TCA_EXTRA)):
        for timed, group in ((True, shapes), (False, extra)):
            for shape in group:
                r = fn(gen, shape, timed=timed)
                out[name][0 if timed else 1].append(r)
                _log_row(name, r, timed)
    for timed, group in ((True, GRAD_SHAPES), (False, GRAD_EXTRA)):
        for shape in group:
            for name, r in check_grad(gen, shape, timed).items():
                out[name][0 if timed else 1].append(r)
                _log_row(name, r, timed)
    check_autograd(record)
    return out


TIMES = ("kernel_ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms")


def summarize(name, source, replaces, rows, checks, counts_by_path):
    """One kernel's entry of the `kernels` line.  For each path (phase 4
    `generation`, phase 5 `guided`) the per-edit times weight each timed
    shape by the launches counted at that shape in one edit of that path
    (`counts_by_path`: {path: LAUNCH_SHAPES of one edit}); the top-level
    launches and times are one edit of each path together.  Without the
    edits (--skip-sd15) they are null."""
    timed = {(r["batch"], r["heads"], r["seq_q"], r["seq_k"], r["head_dim"], r["dtype"],
              r["masked"]): r for r in rows}
    paths = None
    if counts_by_path is not None:
        paths, launched = {}, set()
        for path, counts in counts_by_path.items():
            counted = {key[1:]: n for key, n in counts.items() if key[0] == name}
            if set(counted) - set(timed):
                raise AssertionError(f"{name}: shapes launched in the {path} edit "
                                     f"{sorted(set(counted) - set(timed))} are not timed")
            launched |= set(counted)
            entry = dict(launches=sum(counted.values()))
            for field in TIMES:
                vals = [timed[key][field] for key in counted]
                entry[field.replace("kernel_ms", "ms")] = (
                    None if any(x is None for x in vals)
                    else sum(timed[key][field] * n for key, n in counted.items()))
            paths[path] = entry
            for key, n in counted.items():
                timed[key].setdefault("launches", {})[path] = n
        if launched != set(timed):
            raise AssertionError(f"{name}: shapes timed but launched on no path: "
                                 f"{sorted(set(timed) - launched)}")

    def total(field):
        if paths is None or any(p[field] is None for p in paths.values()):
            return None
        return sum(p[field] for p in paths.values())

    both = rows + checks
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=total("launches"),
        max_abs_err=max(r["max_abs_err"] for r in both),
        max_rel_err=max(r["rel_err"] for r in both),
        err_over_tol=max(r["err_over_tol"] for r in both),
        tol=dict(max_abs_err_of_max_ref=ABS_OF_MAX, rel_err=REL_TOL),
        ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
        bound_by=None if paths is None else (
            "operations" if total("ops_ms") >= total("bytes_ms") else "bytes"),
        library_ms=total("library_ms"),
        library_call=next((r["library_call"] for r in rows if "library_call" in r),
                          None if rows[0]["library_ms"] is None
                          else "F.scaled_dot_product_attention"),
        per="one edit of each path together; per path under `paths`",
        paths=paths, shapes=rows, checks=checks,
    )


# ---------------------------------------------------------------------------
# Phases 3 to 5: the pipeline
# ---------------------------------------------------------------------------

TINY_TOL = 2e-3  # final latents, CUDA vs CPU, float32 with TF32 off


def _case(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4 : h // 2, w // 4 : w // 2] = 255
    return img, mask


def _capture_latents(pipe, store):
    orig = pipe.latent_to_image

    def cap(lat):
        store["lat"] = lat.detach().float().cpu()
        return orig(lat)

    pipe.latent_to_image = cap


def phase_tiny(record):
    """`generation` and `guided_generation` on the tiny config, CUDA against
    the CPU with the same weights and noise."""
    import torch

    from freefine_tpu_torch.config import tiny_pipeline_config
    from freefine_tpu_torch.ops.geometry import re_edit_2d
    from freefine_tpu_torch.pipeline import FreeFine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_pipeline_config()
    cpu = FreeFine(cfg, seed=0, device="cpu")
    gpu = FreeFine(cfg, params={n: m.state_dict() for n, m in cpu.components().items()},
                   device="cuda")
    h, w = cfg.height, cfg.width
    img, mask = _case(h, w, 1)
    coarse_c, tm_c, _ = re_edit_2d(img, mask, dx=10, rotation=15, device="cpu")
    coarse_g, tm_g, _ = re_edit_2d(img, mask, dx=10, rotation=15, device="cuda")
    assert np.abs(coarse_c.astype(int) - coarse_g.astype(int)).max() <= 1
    assert np.array_equal(tm_c, tm_g)
    num_step, start_step = 8, 4
    k = num_step - start_step
    rng = np.random.default_rng(2)
    noise = [rng.standard_normal((2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
             for _ in range(k)]
    cons = np.zeros((h, w), np.uint8)
    runs = {
        "generation": dict(num_step=num_step, start_step=start_step, end_step=1,
                           use_auto_draw=True, cons_area=cons, reduce_inp_artifacts=True),
        "guided_generation": dict(num_step=num_step, start_step=start_step, end_step=1,
                                  energy_fraction=0.5, cons_area=cons),
    }
    stores = {name: {} for name in ("cpu", "cuda")}
    for name, pipe in (("cpu", cpu), ("cuda", gpu)):
        _capture_latents(pipe, stores[name])
    record["tiny"] = {}
    for entry, kw in runs.items():
        lats, outs = {}, {}
        for name, pipe in (("cpu", cpu), ("cuda", gpu)):
            outs[name] = getattr(pipe, entry)(
                img, mask, coarse_c, tm_c, "a photo",
                noise=[torch.from_numpy(z).to(name) for z in noise], **kw)
            lats[name] = stores[name]["lat"]
        err = float((lats["cpu"] - lats["cuda"]).abs().max())
        img_err = int(np.abs(outs["cpu"].astype(int) - outs["cuda"].astype(int)).max())
        record["tiny"][entry] = dict(latent_max_abs_err=err, latent_tol=TINY_TOL,
                                     image_max_level_diff=img_err,
                                     finite=bool(torch.isfinite(lats["cuda"]).all()))
        log(f"  tiny {entry} CUDA vs CPU: latents max |diff| {err:.3g} (tol {TINY_TOL}), "
            f"image {img_err} levels")
        if not err <= TINY_TOL or img_err > 1 or not record["tiny"][entry]["finite"]:
            raise AssertionError(f"tiny {entry}: CUDA and CPU disagree: {record['tiny'][entry]}")


def profile_edit(run, out_name):
    """One edit under torch.profiler: device time by kernel name, device
    busy share of the edit's wall time; the table goes to
    chiprun_out/<out_name>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device-side events only: an aten op's own entry repeats its kernels' time
    kernels = [e for e in events
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.key, dev_us(e), e.count) for e in kernels if dev_us(e) > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) / 1e6
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", out_name), "w") as f:
        f.write(f"wall {wall:.4f} s, device busy {busy:.4f} s\n")
        for name, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {name}\n")
    top = [dict(name=n[:120], ms=us / 1e3, count=c) for n, us, c in rows[:25]]
    log(f"  profiled edit: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {1 - busy / wall:.3f})")
    for r in top[:12]:
        log(f"    {r['ms']:10.2f} ms {r['count']:6d}  {r['name']}")
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall, top=top)


def timed_edits(record, key, run, expect, timed_runs, store, hw):
    """One warm-up and `timed_runs` timed edits of one path; the launch
    counters are set to 0 just before each edit and read just after, and
    must equal `expect`.  Returns the launches of one edit by call shape."""
    import torch

    from freefine_tpu_torch.ops import flash_attention as FA

    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    record[f"{key}_warmup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    secs, first_shapes = [], None
    for _ in range(timed_runs):
        FA.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = dict(FA.LAUNCHES)
        if launches != expect:
            raise AssertionError(f"{key}: launch counts {launches} != expected per edit {expect}")
        shapes = dict(FA.LAUNCH_SHAPES)
        if first_shapes is not None and shapes != first_shapes:
            raise AssertionError(f"{key}: launches by shape differ between edits: {shapes}")
        first_shapes = shapes
        if out.shape != (*hw, 3) or out.dtype != np.uint8:
            raise AssertionError(f"{key}: output {out.shape} {out.dtype}")
        if not torch.isfinite(store["lat"]).all():
            raise AssertionError(f"{key}: non-finite final latents")
    peak = torch.cuda.max_memory_allocated()
    record[key] = dict(
        seconds_per_edit=secs, edits_per_min=60.0 / float(np.mean(secs)),
        peak_memory_bytes=peak, launches=launches, expected_launches=expect,
        launches_by_shape=[[*k, n] for k, n in sorted(shapes.items())],
    )
    log(f"  {key}: {record[key]['edits_per_min']:.3f} edits/min, s/edit {secs}, "
        f"peak {peak / 2**30:.2f} GiB, launches {launches} [{record['card']}]")
    return shapes


def sd15_setup(record):
    import torch

    from freefine_tpu_torch.config import sd15_pipeline_config
    from freefine_tpu_torch.ops.geometry import re_edit_2d
    from freefine_tpu_torch.pipeline import FreeFine

    cfg = sd15_pipeline_config()
    t0 = time.perf_counter()
    pipe = FreeFine(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    record["sd15_setup_s"] = time.perf_counter() - t0
    h, w = cfg.height, cfg.width
    img, mask = _case(h, w, 3)
    coarse, tm, _ = re_edit_2d(img, mask, dx=40, dy=-20, rotation=10, scale_x=1.1,
                               scale_y=1.1, device="cuda")
    store = {}
    _capture_latents(pipe, store)
    return pipe, (img, mask, coarse, tm), store


def _expected(cfg, pipe, k_inv, k_edit, energy_steps=0, feature_indices=(1, 2)):
    """Launches per edit worked out from the config: every self-attention
    of each inversion pass; the layers outside the TCA window of each
    regeneration pass (`tca_flash` inside it); per energy step the no-grad
    reference-feature pass (`flash_sdpa`), the differentiated pass (forward
    with logsumexp) and two gradient pulls through the layers upstream of
    the deepest feature tap used; 2 VAE calls."""
    u = cfg.unet
    nb = len(u.block_out_channels)
    n_layers, _ = u.attn_layer_layout
    lo, hi = pipe._layer_range
    down = sum(u.transformer_depth[i] * u.layers_per_block for i in range(nb)
               if u.down_block_has_attn[i])
    up = sum(u.transformer_depth[nb - 1 - i] * (u.layers_per_block + 1)
             for i in range(max(feature_indices)) if u.up_block_has_attn[i])
    upstream = down + u.transformer_depth[nb - 1] + up
    return {
        "flash_sdpa": k_inv * n_layers + k_edit * (n_layers - (hi - lo))
        + energy_steps * n_layers + 2,
        "tca_flash": k_edit * (hi - lo),
        "flash_sdpa_fwd_lse": energy_steps * n_layers,
        "flash_sdpa_bwd_dq": energy_steps * 2 * upstream,
        "flash_sdpa_bwd_dkv": energy_steps * 2 * upstream,
    }


def phase_sd15(record, pipe, case, store, timed_runs, profile):
    """The full-width `generation` edit (GeoBench-2D protocol)."""
    img, mask, coarse, tm = case
    h, w = pipe.config.height, pipe.config.width
    num_step, start_step = 50, 35
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=10, method_type="tca", use_auto_draw=True,
              cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True, seed=42)
    k = num_step - start_step

    def run():
        return pipe.generation(img, mask, coarse, tm, "a photo of a cat", **kw)

    shapes = timed_edits(record, "sd15", run, _expected(pipe.config, pipe, k, k), timed_runs,
                         store, (h, w))
    record["sd15"]["protocol"] = ("SD-1.5 512^2, 50-step DDIM, start 35, guidance 7.5, eta 1.0, "
                                  "TCA, bf16 random weights, batch 1")
    if profile:
        record["sd15_profile"] = profile_edit(run, "profile_sd15.txt")
    return shapes


def unused_tail_ms(pipe, run):
    """Device-stream time, per edit, of the forward of the differentiated
    energy pass (grad mode on) in total and from up block 2 to conv_out,
    which no gradient reads (the features tapped are up blocks 0 and 1),
    from CUDA events recorded by forward hooks during one edit."""
    import torch

    unet = pipe.unet
    marks = {"start": [], "tail": [], "end": []}

    def mark(name):
        def hook(*_):
            if torch.is_grad_enabled():
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks[name].append(ev)
        return hook

    handles = [unet.register_forward_pre_hook(mark("start")),
               unet.up_blocks[2].resnets[0].register_forward_pre_hook(mark("tail")),
               unet.conv_out.register_forward_hook(mark("end"))]
    try:
        run()
    finally:
        for hd in handles:
            hd.remove()
    torch.cuda.synchronize()
    if not marks["start"] or not len(marks["start"]) == len(marks["tail"]) == len(marks["end"]):
        seen = {k: len(v) for k, v in marks.items()}
        raise AssertionError(f"differentiated passes not seen: {seen}")
    total = sum(a.elapsed_time(b) for a, b in zip(marks["start"], marks["end"]))
    tail = sum(a.elapsed_time(b) for a, b in zip(marks["tail"], marks["end"]))
    return dict(passes=len(marks["start"]), forward_ms=total, unused_tail_ms=tail,
                unused_share=tail / total)


def phase_guided(record, pipe, case, store, timed_runs, profile):
    """The full-width energy-guided edit with `guided_generation`'s defaults."""
    img, mask, coarse, tm = case
    h, w = pipe.config.height, pipe.config.width
    num_step, start_step, fraction = 50, 25, 0.6
    kw = dict(energy_scale=2.0, energy_fraction=fraction, guidance_scale=7.5, eta=1.0,
              num_step=num_step, start_step=start_step, end_step=10, method_type="tca",
              seed=42)
    k = num_step - start_step
    energy_steps = int(round(k * fraction))

    def run():
        return pipe.guided_generation(img, mask, coarse, tm, "a photo of a cat", **kw)

    expect = _expected(pipe.config, pipe, k, k, energy_steps)
    shapes = timed_edits(record, "sd15_guided", run, expect, timed_runs, store, (h, w))
    record["sd15_guided"]["protocol"] = (
        "SD-1.5 512^2, guided_generation defaults: 50-step DDIM, start 25, energy on the first "
        f"{energy_steps} of {k} steps, energy scale 2.0, guidance 7.5, eta 1.0, TCA, bf16 "
        "random weights, batch 1")
    tail = unused_tail_ms(pipe, run)
    record["sd15_guided"]["differentiated_forward"] = tail
    log(f"  differentiated forward: {tail['forward_ms']:.1f} ms per edit over "
        f"{tail['passes']} passes, of which up blocks 2-3 and conv_out (read by no gradient) "
        f"{tail['unused_tail_ms']:.1f} ms ({tail['unused_share']:.3f}) [{record['card']}]")
    if profile:
        record["sd15_guided_profile"] = profile_edit(run, "profile_sd15_guided.txt")
    return shapes


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-sd15", action="store_true",
                    help="stop after phase 3 (kernel and tiny checks only)")
    ap.add_argument("--timed-runs", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one SD-1.5 edit of each path (torch.profiler)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        sys.exit(2)
    from freefine_tpu_torch.ops import cuda_build

    record = {"argv": sys.argv[1:]}
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    log(f"phase 1: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    record["build_s"] = time.perf_counter() - t0
    log(f"  built {sorted(p.name for p in libs.values())} in {record['build_s']:.1f} s")

    record["ptxas"] = ptxas_report(libs)

    log("phase 2: kernels against their twins")
    checked = phase_kernels(record)
    log("phase 3: tiny config, CUDA vs CPU")
    phase_tiny(record)
    counts = None
    if not args.skip_sd15:
        pipe, case, store = sd15_setup(record)
        log("phase 4: SD-1.5 512^2 edit (generation)")
        counts = {"generation": phase_sd15(record, pipe, case, store, args.timed_runs,
                                           args.profile)}
        log("phase 5: SD-1.5 512^2 energy-guided edit (guided_generation)")
        counts["guided"] = phase_guided(record, pipe, case, store, args.timed_runs,
                                        args.profile)
    kernels = [summarize(name, source, replaces, *checked[name], counts)
               for name, _, _, source, replaces in KERNELS]
    record["kernels"] = kernels
    record["seconds"] = time.perf_counter() - t0

    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k not in ("shapes", "checks")}
                                  for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
