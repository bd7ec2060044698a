#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`freefine_tpu_torch`) on one
NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure raises and exits non-zero; nothing is caught):
  1. print the card's name and power limit; build the CUDA kernels from
     `freefine_tpu_torch/csrc` (one nvcc per source, in parallel) and print
     each instantiation's registers, stack and spills;
  2. hold each kernel against its plain PyTorch twin on the card at every
     shape of the SD-1.5 512^2 main path (bf16, and f32 at the VAE shape),
     plus fully masked and ragged cases, within limits scaled to the
     output; time the kernel, the twin and, as a yardstick only,
     `F.scaled_dot_product_attention`;
  3. the tiny config end to end on CUDA and on the CPU with the same f32
     weights and noise (TF32 off), final latents compared;
  4. the full-width SD-1.5 512^2 edit: `re_edit_2d`, then `generation` with
     50 DDIM steps, start 35, guidance 7.5, eta 1.0, TCA, bf16 random
     weights; one warm-up and two timed edits, launch counters checked
     against the expected per-edit counts, and the launches by call shape
     against the shapes of phase 2;
  5. the result lines: the `kernels` JSON line (per-edit times weight each
     shape's time by its launches counted in phase 4), the nvidia-smi line,
     and last `{"ok": true, "device": {...}}`.

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

# (batch, heads, seq, head_dim, dtype) of every call on the SD-1.5 512^2 main
# path: inversion batch 2, regeneration batch 3 outside the TCA window, VAE
# mid-block f32 one head of 512.  Phase 4 counts the launches at each shape
# and fails unless they are exactly these.
FLASH_SHAPES = [
    (2, 8, 4096, 40, "bfloat16"), (2, 8, 1024, 80, "bfloat16"),
    (2, 8, 256, 160, "bfloat16"), (2, 8, 64, 160, "bfloat16"),
    (3, 8, 4096, 40, "bfloat16"), (3, 8, 1024, 80, "bfloat16"),
    (3, 8, 256, 160, "bfloat16"), (3, 8, 64, 160, "bfloat16"),
    (2, 1, 4096, 512, "float32"),
]
# check-only: masked keys with fully masked rows, ragged lengths
FLASH_EXTRA = [(2, 8, 1000, 80, "bfloat16"), (2, 1, 300, 512, "float32"),
               (3, 2, 77, 16, "float32"), (3, 2, 77, 16, "bfloat16"), (1, 2, 5, 24, "bfloat16")]
# TCA after the head-parity split: batch 2*3 streams, 4 heads
TCA_SHAPES = [(6, 4, 1024, 80, "bfloat16"), (6, 4, 4096, 40, "bfloat16")]
TCA_EXTRA = [(6, 4, 1000, 40, "bfloat16"), (6, 1, 64, 16, "float32"),
             (6, 1, 64, 16, "bfloat16"), (4, 2, 33, 24, "bfloat16")]


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


def _hold(name, out, ref, row):
    row.update(compare(out, ref))
    row["err_over_tol"] = err_over_tol(row, row["dtype"])
    if not row["finite"] or not row["err_over_tol"] <= 1.0:
        raise AssertionError(f"{name} disagrees with its twin: {row}")


def _teeth(name, ref, dropped, row):
    """The limits must reject the twin with its first DROP_KEYS keys left
    out, as a kernel that skipped one key tile would give."""
    row["dropped_tile_err_over_tol"] = err_over_tol(compare(dropped, ref), row["dtype"])
    if row["dropped_tile_err_over_tol"] <= 1.0:
        raise AssertionError(f"{name}: the limits accept a dropped key tile: {row}")


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
    row = dict(batch=b, heads=h, seq=s, head_dim=d, dtype=dtype, masked=mask is not None)
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
    row = dict(batch=b, heads=h, seq=s, head_dim=d, dtype=dtype, masked=True)
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


KERNELS = (
    ("flash_sdpa", FLASH_SHAPES, FLASH_EXTRA, check_flash,
     "freefine_tpu_torch/csrc/flash_sdpa.cu", "freefine_tpu/ops/flash_attention.py:80"),
    ("tca_flash", TCA_SHAPES, TCA_EXTRA, check_tca,
     "freefine_tpu_torch/csrc/tca_flash.cu", "freefine_tpu/ops/flash_attention.py:175"),
)


def phase_kernels():
    """Every kernel at every main-path shape (timed) and every extra case:
    {name: (rows, checks)}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for name, shapes, extra, fn, _, _ in KERNELS:
        rows = []
        for shape in shapes:
            r = fn(gen, shape, timed=True)
            rows.append(r)
            log(f"  {name} {shape}: err {r['max_abs_err']:.3g} (max|ref| {r['max_ref']:.3g}, "
                f"rel {r['rel_err']:.3g}, {r['err_over_tol']:.3f} of tol; dropped tile "
                f"{r['dropped_tile_err_over_tol']:.3g} of tol) kernel {r['kernel_ms']:.4f} ms "
                f"plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        checks = [fn(gen, shape, timed=False) for shape in extra]
        for r in checks:
            log(f"  {name} {r['batch'], r['heads'], r['seq'], r['head_dim'], r['dtype']} "
                f"masked/ragged: err {r['max_abs_err']:.3g} (max|ref| {r['max_ref']:.3g}, "
                f"rel {r['rel_err']:.3g}, {r['err_over_tol']:.3f} of tol)")
        out[name] = (rows, checks)
    return out


def summarize(name, source, replaces, rows, checks, shape_counts):
    """One kernel's entry of the `kernels` line.  Per-edit times weight each
    timed shape by the launches counted at that shape in one edit of phase 4
    (`shape_counts`); without that edit they and the launches are null."""
    launches = None
    if shape_counts is not None:
        counted = {key[1:]: n for key, n in shape_counts.items() if key[0] == name}
        timed = {(r["batch"], r["heads"], r["seq"], r["seq"], r["head_dim"], r["dtype"],
                  r["masked"]): r for r in rows}
        if set(counted) != set(timed):
            raise AssertionError(f"{name}: shapes launched in the edit {sorted(counted)} are "
                                 f"not the shapes timed {sorted(timed)}")
        for key, r in timed.items():
            r["launches"] = counted[key]
        launches = sum(counted.values())

    def per_edit(key):
        if launches is None or any(r[key] is None for r in rows):
            return None
        return sum(r[key] * r["launches"] for r in rows)

    both = rows + checks
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, launches_per_edit=launches,
        max_abs_err=max(r["max_abs_err"] for r in both),
        max_rel_err=max(r["rel_err"] for r in both),
        err_over_tol=max(r["err_over_tol"] for r in both),
        tol=dict(max_abs_err_of_max_ref=ABS_OF_MAX, rel_err=REL_TOL),
        ms=per_edit("kernel_ms"), kernel_ms=per_edit("kernel_ms"),
        plain_ms=per_edit("plain_ms"), bound_ms=per_edit("bound_ms"),
        bound_by=None if launches is None else (
            "operations" if per_edit("ops_ms") >= per_edit("bytes_ms") else "bytes"),
        library_ms=per_edit("library_ms"),
        per="edit (sum over the main-path launches of one edit)",
        shapes=rows, checks=checks,
    )


# ---------------------------------------------------------------------------
# Phases 3 and 4: the pipeline
# ---------------------------------------------------------------------------


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
    kw = dict(num_step=num_step, start_step=start_step, end_step=1, use_auto_draw=True,
              cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True)
    lats = {}
    outs = {}
    for name, pipe, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        store = {}
        _capture_latents(pipe, store)
        outs[name] = pipe.generation(img, mask, coarse_c, tm_c, "a photo",
                                     noise=[torch.from_numpy(z).to(dev) for z in noise], **kw)
        lats[name] = store["lat"]
    err = float((lats["cpu"] - lats["cuda"]).abs().max())
    img_err = int(np.abs(outs["cpu"].astype(int) - outs["cuda"].astype(int)).max())
    record["tiny"] = dict(latent_max_abs_err=err, latent_tol=2e-3, image_max_level_diff=img_err)
    log(f"  tiny CUDA vs CPU: latents max |diff| {err:.3g} (tol 2e-3), image {img_err} levels")
    if not err <= 2e-3 or img_err > 1:
        raise AssertionError(f"tiny end to end: CUDA and CPU disagree: {record['tiny']}")


def profile_edit(pipe, run):
    """One edit under torch.profiler: device time by kernel name, device
    busy share of the edit's wall time; the table goes to
    chiprun_out/profile_sd15.txt."""
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
    with open(os.path.join(HERE, "chiprun_out", "profile_sd15.txt"), "w") as f:
        f.write(f"wall {wall:.4f} s, device busy {busy:.4f} s\n")
        for name, us, n in rows:
            f.write(f"{us / 1e3:12.3f} ms {n:8d}  {name}\n")
    top = [dict(name=n[:120], ms=us / 1e3, count=c) for n, us, c in rows[:25]]
    log(f"  profiled edit: wall {wall:.3f} s, device busy {busy:.3f} s "
        f"(idle share {1 - busy / wall:.3f})")
    for r in top[:12]:
        log(f"    {r['ms']:10.2f} ms {r['count']:6d}  {r['name']}")
    return dict(wall_s=wall, device_busy_s=busy, idle_share=1 - busy / wall, top=top)


def phase_sd15(record, timed_runs: int, profile: bool = False):
    """The full-width edit; returns the launches of one edit by call shape
    (`FA.LAUNCH_SHAPES`), the same in every timed edit."""
    import torch

    from freefine_tpu_torch.config import sd15_pipeline_config
    from freefine_tpu_torch.ops import flash_attention as FA
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
    num_step, start_step = 50, 35
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=10, method_type="tca", use_auto_draw=True,
              cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True, seed=42)
    k = num_step - start_step
    n_layers, _ = cfg.unet.attn_layer_layout
    lo, hi = pipe._layer_range
    expect = {"flash_sdpa": k * n_layers + k * (n_layers - (hi - lo)) + 2,
              "tca_flash": k * (hi - lo)}
    store = {}
    first_shapes = None
    _capture_latents(pipe, store)

    t0 = time.perf_counter()
    pipe.generation(img, mask, coarse, tm, "a photo of a cat", **kw)
    torch.cuda.synchronize()
    record["sd15_warmup_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(timed_runs):
        FA.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.generation(img, mask, coarse, tm, "a photo of a cat", **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = dict(FA.LAUNCHES)
        if launches != expect:
            raise AssertionError(f"launch counts {launches} != expected per edit {expect}")
        shapes = dict(FA.LAUNCH_SHAPES)
        if first_shapes is not None and shapes != first_shapes:
            raise AssertionError(f"launches by shape differ between edits: {shapes}")
        first_shapes = shapes
        if out.shape != (h, w, 3) or out.dtype != np.uint8:
            raise AssertionError(f"output {out.shape} {out.dtype}")
        if not torch.isfinite(store["lat"]).all():
            raise AssertionError("non-finite final latents")
    peak = torch.cuda.max_memory_allocated()
    if profile:
        record["sd15_profile"] = profile_edit(pipe, lambda: pipe.generation(
            img, mask, coarse, tm, "a photo of a cat", **kw))
    record["sd15"] = dict(
        seconds_per_edit=secs, edits_per_min=60.0 / float(np.mean(secs)),
        peak_memory_bytes=peak, launches=launches, expected_launches=expect,
        launches_by_shape=[[*key, n] for key, n in sorted(shapes.items())],
        protocol="SD-1.5 512^2, 50-step DDIM, start 35, guidance 7.5, eta 1.0, TCA, bf16 "
                 "random weights, batch 1",
    )
    log(f"  SD-1.5 512^2 edit: {record['sd15']['edits_per_min']:.3f} edits/min, "
        f"s/edit {secs}, peak {peak / 2**30:.2f} GiB, launches {launches} "
        f"[{record['card']}]")
    return shapes


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-sd15", action="store_true",
                    help="stop after phase 3 (kernel and tiny checks only)")
    ap.add_argument("--timed-runs", type=int, default=2)
    ap.add_argument("--profile", action="store_true",
                    help="also profile one SD-1.5 edit (torch.profiler)")
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
    checked = phase_kernels()
    log("phase 3: tiny config, CUDA vs CPU")
    phase_tiny(record)
    shape_counts = None
    if not args.skip_sd15:
        log("phase 4: SD-1.5 512^2 edit")
        shape_counts = phase_sd15(record, args.timed_runs, args.profile)
    kernels = [summarize(name, source, replaces, *checked[name], shape_counts)
               for name, _, _, _, source, replaces in KERNELS]
    record["kernels"] = kernels

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
