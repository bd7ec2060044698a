#!/usr/bin/env python3
"""The GroupNorm routes on the port's differentiated paths, paired in one
process on one CUDA card: FREEFINE_FUSED_GN "0" (the two-pass math) against
the default "auto" (the `group_norm_silu` kernel on the card; under
differentiation `GroupNormSiLU`, whose backward recomputes the two-pass
math and pulls the cotangent through it).

    python3 scripts/gn_route_paired.py

SD-1.5 512^2, bf16 random weights (seed 0), chip_smoke.py's edit case.
In turns "0", "auto", "auto", "0" (one warm-up per route first):
  * E: one `guided_generation` edit at its defaults (50 steps, start 25,
    energy on 15 of the 25 steps), seconds and peak memory;
  * D: five differentiated TCA passes (chip_smoke.py phase 8's), median s;
  * N: the 61 GroupNorms of one UNet pass at batch 3 (`norm_calls`), each
    forward and backward to x and the affine, host clock around all 61
    with a synchronise, median of five.
Prints one JSON line with the card's name and power limit.
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("gn_route_paired: needs a CUDA card")
    import chip_smoke as cs
    from freefine_tpu_torch.models.layers import GroupNorm32
    from freefine_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    pipe, case, store = cs.sd15_setup({})
    cfg = pipe.config
    img, mask, coarse, tm = case
    kw = dict(energy_scale=2.0, energy_fraction=0.6, guidance_scale=7.5, eta=1.0, num_step=50,
              start_step=25, end_step=10, method_type="tca", seed=42)
    inputs = cs.tca_pass_inputs(pipe, case, "edit", 35)
    w = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    norms = []
    for c, h, wd, g, eps, silu in cs.norm_calls(cfg, "unet"):
        mod = GroupNorm32(g, c, eps, device="cuda")
        x = torch.randn((3, c, h, wd), generator=gen, device="cuda", dtype=torch.bfloat16)
        norms.append((mod, x.contiguous(memory_format=torch.channels_last).requires_grad_(),
                      silu))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def e_edit():
        return pipe.guided_generation(img, mask, coarse, tm, "a photo of a cat", **kw)

    def d_pass():
        return cs.tca_grad_pass(pipe, inputs, w)

    def n_pass():
        for mod, x, silu in norms:
            y = mod(x, silu)
            torch.autograd.grad(y, [x, mod.weight, mod.bias], torch.ones_like(y))

    routes = {"0": "0", "auto": None}
    res = {r: {"E_s": [], "E_peak_gib": [], "D_s": [], "N_ms": []} for r in routes}
    for r, mode in routes.items():  # one warm-up per route
        with cs.fused_gn(mode):
            e_edit(), d_pass(), n_pass()
    order = ["0", "auto", "auto", "0"]
    for r in order:
        with cs.fused_gn(routes[r]):
            torch.cuda.reset_peak_memory_stats()
            res[r]["E_s"].append(timed(e_edit))
            res[r]["E_peak_gib"].append(torch.cuda.max_memory_allocated() / 2**30)
            res[r]["D_s"].append(float(np.median([timed(d_pass) for _ in range(5)])))
            res[r]["N_ms"].append(1e3 * float(np.median([timed(n_pass) for _ in range(5)])))
    print(json.dumps({"card": cs.card_line(), "order": order, "routes": res}))


if __name__ == "__main__":
    main()
