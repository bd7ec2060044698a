#!/usr/bin/env python3
"""Throughput benchmark of the PyTorch port: edits/min at 512^2, 50-step
DDIM, on one CUDA card (the port of `bench.py`'s SD-1.5 lanes), with
`--sdxl` on the SDXL backbone at 1024^2, and with `--dit` on the DiT
backbone at 512^2.

The protocol is the reference's 2D GeoBench inference envelope: SD-1.5,
512^2, num_step 50, start_step 35 (15 inversion UNet passes, 15
regeneration passes on the deduped [u_e, r, c_e] batch), guidance 7.5,
eta 1.0, TCA, end_step 10.  Weights are random (`init_random=True`, seed
0): the same FLOPs and memory as the real checkpoint, no quality claim.

    python3 bench_torch.py                     # shared-source lane, batch 16
    python3 bench_torch.py --no-shared --batch 8   # per-case lane, batch 8
    python3 bench_torch.py --batch 1           # FreeFine.generation
    python3 bench_torch.py --tiny --device cpu --steps 2 --repeats 1   # smoke
    python3 bench_torch.py --sdxl              # SDXLFreeFine.generation, 1024^2
    python3 bench_torch.py --tiny --sdxl --device cpu --steps 2 --repeats 1
    python3 bench_torch.py --dit               # FreeFine.generation on the DiT, 512^2
    python3 bench_torch.py --tiny --dit --device cpu --steps 2 --repeats 1

Lanes, as in `bench.py`: with no flags, the shared-source lane
(`BatchedFreeFine.generation_shared_source`) at batch 16: cases share one
source image, whose reference stream is inverted and run once per step
for the whole batch.  An explicit `--batch N` selects the per-case lane
(`BatchedFreeFine.generation`), `--shared` the shared one; batch 1 calls
`FreeFine.generation`.  `--sdxl` runs `SDXLFreeFine` (`sdxl_pipeline_config`,
1024^2; the tiny SDXL config with `--tiny`) with the same protocol, per
case at batch 1 unless `--batch` / `--shared` ask for a batched lane.
`--dit` runs `FreeFine` on `dit_pipeline_config` (the PixArt-XL-2 DiT at
SD-1.5's VAE and CLIP tower, 512^2; the tiny DiT config with `--tiny`), as
`bench.py --dit` does, per case at batch 1 by default.
`--profile` times the stages of the batched lane (`StageTimer`; the
breakdown goes to stderr).

Timing: one warm-up call, then `--repeats` timed calls, each closed by a
device synchronise; s/edit = a call's seconds / batch.

Prints ONE JSON line with `bench.py`'s keys
  {"metric", "value" (edits/min), "unit", "vs_baseline" (value / 20.0, the
   20 edits/min/chip build target of BASELINE.json, no measurement),
   "lane"}
and the port's own: the backbone ("sd15", "sdxl" or "dit"), the median and the
slowest call's seconds per edit, `torch.cuda.max_memory_allocated` in
GiB, the GroupNorm route that
`FREEFINE_FUSED_GN` resolves to on the device ("0" or "1"; unset, "auto"
gives "1" on a card), and the card's name and power limit as nvidia-smi
reports them.  Name the route (FREEFINE_FUSED_GN=0 or 1) to compare with
numbers taken before "auto" became the default.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

NOT_PORTED = {"mesh": "mesh serving (ROADMAP A15)",
              "sp": "sequence-parallel serving (ROADMAP A15)"}


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=50, help="num DDIM steps")
    ap.add_argument("--start-step", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=3, help="timed calls")
    ap.add_argument("--tiny", action="store_true", help="tiny config smoke run")
    ap.add_argument("--batch", type=int, default=None,
                    help="cases per call (BatchedFreeFine); default 16 on the flagship "
                         "SD-1.5 512^2 lane, 1 elsewhere")
    ap.add_argument("--profile", action="store_true",
                    help="per-stage timing via StageTimer (batched lane; stderr)")
    ap.add_argument("--shared", action=argparse.BooleanOptionalAction, default=None,
                    help="the shared-source lane (generation_shared_source); default on for "
                         "the flagship lane, --no-shared for the per-case lane")
    ap.add_argument("--weights-dtype", choices=["f32", "bf16"], default="bf16",
                    help="the model dtype (bf16, the serving layout; f32 the comparison "
                         "layout)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default); cpu only for a --tiny smoke run")
    ap.add_argument("--sdxl", action="store_true",
                    help="the SDXL backbone (SDXLFreeFine, 1024^2; per case, batch 1 by default)")
    ap.add_argument("--dit", action="store_true",
                    help="the DiT backbone (dit_pipeline_config, 512^2; per case, batch 1 by "
                         "default)")
    ap.add_argument("--sp", action="store_true", help=f"not ported: {NOT_PORTED['sp']}")
    ap.add_argument("--mesh", type=str, default=None, help=f"not ported: {NOT_PORTED['mesh']}")
    args = ap.parse_args()

    for flag, what in NOT_PORTED.items():
        if getattr(args, flag) not in (None, False):
            ap.exit(2, f"bench_torch.py: --{flag} is not ported yet: {what}\n")
    if args.device != "cuda" and not args.tiny:
        ap.error("--device cpu is for the --tiny smoke run only")
    if args.sdxl and args.dit:
        ap.error("--sdxl and --dit are two backbones; pick one")

    flagship = not (args.tiny or args.profile or args.sdxl or args.dit)
    batch_defaulted = args.batch is None
    if batch_defaulted:
        args.batch = 16 if (flagship and args.shared is not False) else 1
        if args.shared and args.batch == 1:
            args.batch = 8  # an explicit --shared on an opt-in lane
    if args.shared is None:
        # an explicit --batch N means the per-case lane; only the all-default
        # flagship invocation (and an explicit --shared) runs shared-source
        args.shared = flagship and batch_defaulted and args.batch > 1
    if args.shared and args.batch == 1:
        ap.error("--shared needs --batch > 1 (one reference pass amortised over a batch)")

    import torch

    from freefine_tpu_torch import config as C
    from freefine_tpu_torch.ops.group_norm import fused_gn_route
    from freefine_tpu_torch.pipeline import BatchedFreeFine, FreeFine
    from freefine_tpu_torch.sdxl import SDXLFreeFine

    device = torch.device(args.device)
    dtype = torch.float32 if args.weights_dtype == "f32" else None
    if args.sdxl:
        cls = SDXLFreeFine
        cfg = C.tiny_sdxl_pipeline_config() if args.tiny else C.sdxl_pipeline_config(dtype=dtype)
    elif args.dit:
        cls = FreeFine
        cfg = C.tiny_dit_pipeline_config() if args.tiny else C.dit_pipeline_config(dtype=dtype)
    else:
        cls = FreeFine
        cfg = C.tiny_pipeline_config() if args.tiny else C.sd15_pipeline_config(dtype=dtype)
    pipe = cls(cfg, init_random=True, seed=0, device=device)

    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(42)
    ori = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    coarse = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    ori_mask = np.zeros((h, w), np.uint8)
    ori_mask[h // 4 : h // 2, w // 4 : w // 2] = 255
    tgt_mask = np.zeros((h, w), np.uint8)
    tgt_mask[h // 3 : h // 3 + h // 4, w // 3 : w // 3 + w // 4] = 255
    cons = np.zeros((h, w), np.uint8)

    num_step = args.steps
    start_step = (args.start_step if args.start_step is not None
                  else max(1, int(round(num_step * 0.7))))  # 35/50, the 2D eval setting
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=num_step, start_step=start_step,
              end_step=max(1, num_step // 5))

    timer = None
    if args.profile:
        from freefine_tpu_torch.utils.profiling import StageTimer

        timer = StageTimer()

    if args.batch > 1 or args.profile:
        batched = BatchedFreeFine(pipe)
        cases = [dict(ori_img=ori, ori_mask=ori_mask, coarse_input=coarse, target_mask=tgt_mask,
                      guidance_text="a photo of an object") for _ in range(args.batch)]
        gen = batched.generation_shared_source if args.shared else batched.generation

        def one_call(seed):
            return gen(cases, seed=seed, timer=timer, **kw)[0]
    else:
        def one_call(seed):
            return pipe.generation(ori, ori_mask, coarse, tgt_mask, "a photo of an object",
                                   use_auto_draw=True, cons_area=cons, reduce_inp_artifacts=True,
                                   seed=seed, **kw)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    one_call(0)  # warm-up: builds the kernels, warms the allocator and cuDNN
    sync()
    warmup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    secs = []
    for i in range(args.repeats):
        t0 = time.perf_counter()
        out = one_call(i + 1)
        sync()
        secs.append(time.perf_counter() - t0)
    per_edit = [s / args.batch for s in secs]
    epm = 60.0 / statistics.median(per_edit)

    metric = ("edits/min (tiny smoke)" if args.tiny else
              f"edits/min/chip @{h}^2 {num_step}-step" + (" SDXL" if args.sdxl else "")
              + (" DiT" if args.dit else ""))
    lane = ("shared-source" if args.shared else "per-case") + f" batch {args.batch}"
    result = {
        "metric": metric,
        "value": round(epm, 3),
        "unit": "edits/min",
        "vs_baseline": round(epm / 20.0, 3),
        "lane": lane,
        "backbone": "sdxl" if args.sdxl else "dit" if args.dit else "sd15",
        "median_s_per_edit": statistics.median(per_edit),
        "max_s_per_edit": max(per_edit),
        "s_per_call": secs,
        "peak_memory_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None),
        "fused_gn": fused_gn_route(device),
        "card": card_line() if device.type == "cuda" else None,
        "device": str(device),
        "weights_dtype": args.weights_dtype,
    }
    print(f"# device={device} warmup={warmup_s:.1f}s per_edit={per_edit} steps={num_step} "
          f"start={start_step} batch={args.batch} out={out.shape}", file=sys.stderr)
    if timer is not None:
        for stage, rec in timer.summary().items():
            # min_s is the steady-state cost (the first call holds the warm-up)
            print(f"# stage {stage}: steady={rec['min_s']:.3f}s mean={rec['mean_s']:.3f}s "
                  f"total={rec['total_s']:.3f}s count={rec['count']}", file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
