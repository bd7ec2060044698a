#!/usr/bin/env python3
"""CUDA-graph times of the port's TCA kernels (rows 2 and 6-8 of PERF.md's
kernel table) at the SD-1.5 path shapes, for the port in a given checkout.

    python3 scripts/tca_graph_times.py [CHECKOUT]

CHECKOUT (default: this repository) is the root of a checkout whose
`freefine_tpu_torch` is timed, with its own kernels built into its own
`build/kernels/`.  The inputs, the masks (`chip_smoke.tca_layouts`: the
edit and bggen layouts, and random parity rows) and the timer
(`chip_smoke.graph_ms`) come from this repository's `chip_smoke.py`, so two
checkouts, a parent and a change, are timed alike: run them in turns in one
call on one card.  Needs one CUDA card.  Prints one JSON line: ms per call
(rows 2, 7 and 8 at each layout, row 6 at the parity rows, whose results
do not depend on the masks' layout), and per edit of each path (row 2 at
the launches and masks of G, E and R; rows 6-8 per differentiated pass D,
rows 7-8 at the edit masks D passes).
"""

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# `tca_flash` launches per edit at each of S 1024 and S 4096 (PERF.md §4:
# 90, 150 and 294 launches split evenly) and the masks each path passes;
# the TCA VJP kernels launch 3 times at each S per differentiated pass.
ROW2_PATHS = (("G", 45, "edit"), ("E", 75, "edit"), ("R", 147, "bggen"))
D_LAUNCHES = 3


def main():
    checkout = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path.insert(0, checkout)
    import torch

    if not torch.cuda.is_available():
        sys.exit("tca_graph_times: needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from freefine_tpu_torch.ops import cuda_build
    from freefine_tpu_torch.ops import flash_attention as FA

    cuda_build.build_all(["tca_flash", "tca_flash_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    ms = {}
    for b, h, s, d, dtype in cs.TCA_EDIT_SHAPES:
        q, ks, vs, km, vm, do = cs._inputs(gen, b, h, s, d, dtype, 6)
        masks = dict(cs.tca_layouts(s), parity=cs._tca_masks(gen, b, s, "parity"))
        for name, (fg, tq) in masks.items():
            ops = (q, ks, vs, km, vm, fg, tq, 0.7)
            ms[f"tca_flash {s} {name}"] = cs.graph_ms(lambda: FA.tca_flash(*ops, heads=h))
            _, parts, lse = FA.tca_flash_fwd_lse_reference(*ops, heads=h)
            res = (*ops, do, lse, FA.tca_row_deltas(parts, do, tq, 0.7, heads=h))
            del parts
            for kern in ("tca_flash_bwd_dq", "tca_flash_bwd_dkv"):
                fn = getattr(FA, kern)
                ms[f"{kern} {s} {name}"] = cs.graph_ms(lambda: fn(*res, heads=h))
        ms[f"tca_flash_fwd_lse {s}"] = cs.graph_ms(lambda: FA.tca_flash_fwd_lse(*ops, heads=h))
    sizes = [shape[2] for shape in cs.TCA_EDIT_SHAPES]
    per_edit = {f"tca_flash {path}": n * sum(ms[f"tca_flash {s} {masks}"] for s in sizes)
                for path, n, masks in ROW2_PATHS}
    per_edit["tca_flash_fwd_lse D"] = D_LAUNCHES * sum(ms[f"tca_flash_fwd_lse {s}"]
                                                       for s in sizes)
    for name in ("tca_flash_bwd_dq", "tca_flash_bwd_dkv"):
        per_edit[f"{name} D"] = D_LAUNCHES * sum(ms[f"{name} {s} edit"] for s in sizes)
    print(json.dumps({"checkout": checkout, "card": cs.card_line(), "per_call_ms": ms,
                      "per_edit_ms": per_edit}))


if __name__ == "__main__":
    main()
