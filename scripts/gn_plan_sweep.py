#!/usr/bin/env python3
"""CUDA-graph times of the cluster GroupNorm (row 9 of PERF.md's kernel
table) at every TMA-route plan of every SD-1.5 path shape, beside the plan
`group_norm.launch_plan` picks.

    python3 scripts/gn_plan_sweep.py

For each shape of `chip_smoke.gn_shapes` it times, in CUDA graphs
(`chip_smoke.graph_ms`), every block of whole groups (`group_blocks`) in
resident clusters of 1 to 16 CTAs and a streamed cluster of 16
(`layout`), each held to the plain twin within `chip_smoke`'s limits first;
it prints the picked plan's time and the best one's per shape, and their
sums over the shapes.  Needs one CUDA card.  The full table goes to
chiprun_out/gn_plan_sweep.json.
"""

import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("gn_plan_sweep: needs a CUDA card")
    import chip_smoke as cs
    from freefine_tpu_torch.config import sd15_pipeline_config
    from freefine_tpu_torch.ops import cuda_build
    from freefine_tpu_torch.ops import group_norm as G

    lib = cuda_build.library("group_norm")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, picked_sum, best_sum = [], 0.0, 0.0
    print(cs.card_line())
    for shape in cs.gn_shapes(sd15_pipeline_config()):
        b, c, h, w, g, eps, dtype, silu = shape
        x, scale, bias = cs._gn_inputs(gen, b, c, h, w, dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        y = torch.empty_like(x)
        ref = G.group_norm_silu_reference(x, scale, bias, num_groups=g, eps=eps, apply_silu=silu)
        picked = G.launch_plan(x, g)
        plans = [p for gb in G.group_blocks(c, g, x.dtype)
                 for n, route in [(n, "resident") for n in range(1, 17)] + [(16, "streamed")]
                 if (p := G.layout(b, c, h * w, g, x.dtype, gb, n, route))]
        timed = []
        for plan in plans:
            def call(plan=plan):
                code = lib.group_norm_silu_fwd(
                    x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), b, c, h * w,
                    g, eps, plan["groups_per_block"], plan["cluster"], plan["rows_per_cta"],
                    plan["box_rows"], plan["stages"], plan["smem_bytes"], int(silu),
                    G._DTYPE_CODE[x.dtype], plan["vec"], torch.cuda.current_stream().cuda_stream)
                cuda_build.check(lib, f"group_norm_silu {shape} {plan}", code)

            call()
            torch.cuda.synchronize()
            err = cs.err_over_tol(cs.compare(y, ref), dtype, "group_norm_silu")
            if not err <= 1.0:
                raise AssertionError(f"{shape} {plan}: {err} of the limits")
            timed.append(dict(plan, ms=cs.graph_ms(call), err_over_tol=err,
                              picked=plan == picked))
        mine = next(t for t in timed if t["picked"])
        best = min(timed, key=lambda t: t["ms"])
        picked_sum += mine["ms"]
        best_sum += best["ms"]
        rows.append(dict(shape=shape, plans=timed))

        def name(p):
            return (f"{p['route']} {p['block_channels'] * x.element_size()} B x {p['cluster']}: "
                    f"{1e3 * p['ms']:.1f} us")

        print(f"{shape}: picked {name(mine)} | best {name(best)}", flush=True)
    print(json.dumps(dict(picked_ms=picked_sum, best_ms=best_sum, shapes=len(rows))))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "gn_plan_sweep.json"), "w") as f:
        json.dump(rows, f)


if __name__ == "__main__":
    main()
