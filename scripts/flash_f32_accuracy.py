#!/usr/bin/env python3
"""Accuracy of the float32 route of `flash_sdpa` (row 1 of PERF.md's
kernel table, split-TF32 products on mma.sync) against a float64
reference, beside the plain twin's, at the VAE mid-block's shapes: one
head of 512 at S 4096 (SD-1.5 512^2) and S 16384 (SDXL 1024^2), batch 1
and 2, random normal q, k, v.

    python3 scripts/flash_f32_accuracy.py [CHECKOUT]

CHECKOUT (default: this repository) is the root of a checkout whose
`freefine_tpu_torch` is measured, with its kernels built into its own
`build/kernels/`; run a parent and a change in turns in one call on one
card.  Needs one CUDA card.  Prints one line per shape: max and relative
(Frobenius) error of the kernel and of the twin against float64, the
kernel against the twin as a share of `chip_smoke.py`'s float32 limits
(1e-4 of max |twin| absolute, 1e-4 relative), and the kernel's time
(CUDA events, mean of 3 calls after one warm-up).
"""

import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(b, s) for s in (4096, 16384) for b in (1, 2)]
D = 512


def main():
    sys.path.insert(0, os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE))
    import torch

    if not torch.cuda.is_available():
        sys.exit("flash_f32_accuracy: needs a CUDA card")
    from freefine_tpu_torch.ops import flash_attention as FA

    print(f"package {FA.__file__}")
    for b, s in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(s + b)
        q, k, v = (torch.randn(b, s, D, generator=gen, device="cuda") for _ in range(3))
        out = FA.flash_sdpa(q, k, v, None, heads=1)
        twin = FA.flash_sdpa_reference(q, k, v, None, heads=1)
        logits = torch.matmul(q.double(), k.double().transpose(-1, -2)) / D**0.5
        ref = torch.matmul(torch.softmax(logits, -1), v.double())
        del logits

        def err(x):
            d = x.double() - ref
            return f"max {float(d.abs().max()):.3g} rel {float(d.norm() / ref.norm()):.3g}"

        dk = out.double() - twin.double()
        share = max(float(dk.abs().max()) / (1e-4 * float(twin.abs().max())),
                    float(dk.norm() / twin.double().norm()) / 1e-4)
        FA.flash_sdpa(q, k, v, None, heads=1)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(3):
            FA.flash_sdpa(q, k, v, None, heads=1)
        end.record()
        torch.cuda.synchronize()
        print(f"S {s} b {b}: kernel vs f64 {err(out)}; twin vs f64 {err(twin)}; kernel vs twin "
              f"{share:.3f} of the limits; kernel {start.elapsed_time(end) / 3:.2f} ms",
              flush=True)


if __name__ == "__main__":
    main()
