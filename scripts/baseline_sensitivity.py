#!/usr/bin/env python3
"""JAX's own one-level sensitivity of the tiny DiffusionHandles edit and
DragDiffusion drag at GeoBench's loss terms, beside the port's distance
to JAX (CPU only).

    JAX_PLATFORMS=cpu python3 scripts/baseline_sensitivity.py [OUT.json]

On the tiny configuration and the weights, cases and draws of
tests/test_torch_diffusion_handles.py and tests/test_torch_drag_diffusion.py
(DiffusionHandles at the protocol's loss weights, DragDiffusion with the
union mask): JAX's edit of the case, JAX's edit of the case with one input
pixel moved one level, and the port's edit of the case; prints the largest
|difference| of the final latents of JAX against its nudged self and of
the port against JAX.  Both baselines take their first gradient at an
L1 term's exact zero residual (ROADMAP C13).  Runs the JAX package, so it
is a tool of the CPU tests' machine, not of the card's.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import torch  # noqa: E402

import test_torch_diffusion_handles as TDH  # noqa: E402
import test_torch_drag_diffusion as TDD  # noqa: E402
from test_torch_bggen import _capture  # noqa: E402


def _nudged(img):
    out = img.copy()
    out[0, 0, 0] ^= 1
    return out


def dh_case(kw):
    cfg, mods = TDH.tiny_modules(83)
    jpipe, tpipe = TDH.make_pipes(mods, cfg, TDH.jax_tiny_config())
    img, depth, mask = TDH.edit_case(cfg.height, cfg.width)
    lats = {}
    for name, pipe, mod, im, to_np in (
            ("jax", jpipe, TDH.JDH, img, np.asarray),
            ("jax_nudged", jpipe, TDH.JDH, _nudged(img), np.asarray),
            ("port", tpipe, TDH.DH, img, lambda a: a.numpy())):
        store = {}
        _capture(pipe, store, to_np)
        mod.DiffusionHandles(pipe).edit(im, depth, mask, TDH.EDIT_PARAM, **kw)
        lats[name] = np.asarray(store["lat"])
    return lats


def dd_case():
    cfg, mods = TDD.tiny_modules(85)
    jpipe, tpipe = TDD.make_pipes(mods, cfg, TDD.jax_tiny_config())
    h, w = cfg.height, cfg.width
    img = np.random.default_rng(21).integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = TDD._mask(h, w)
    handles, targets = TDD._drag_points_from_case(mask, mask, TDD.DRAG_PARAM, seed=TDD.SEED)
    kw = dict(TDD.DRAG_KW, mask=TDD._union(mask))
    lats = {}
    jdd = TDD.JDD.DragDiffusion(jpipe)
    for name, im in (("jax", img), ("jax_nudged", _nudged(img))):
        store = {}
        _capture(jpipe, store, np.asarray)
        jdd.drag(im, handles, targets, TDD.PROMPT, train_lora_steps=TDD.LORA_STEPS,
                 lora_rank=TDD.RANK, lora_lr=TDD.LORA_LR, **kw)
        lats[name] = np.asarray(store["lat"])
    init = TDD.lora_from_flax(TDD.JDD.init_lora(jpipe.params["unet"], TDD.RANK,
                                                jax.random.key(TDD.SEED)))
    lora = TDD.DD.train_lora(tpipe, img, TDD.PROMPT, rank=TDD.RANK, steps=TDD.LORA_STEPS,
                             lr=TDD.LORA_LR, init=init,
                             draws=TDD.jax_lora_draws(TDD.SEED, (1, cfg.latent_height,
                                                                 cfg.latent_width, 4),
                                                      TDD.LORA_STEPS))
    store = {}
    _capture(tpipe, store, lambda a: a.numpy())
    TDD.DD.DragDiffusion(tpipe).drag(img, handles, targets, TDD.PROMPT, lora=lora, **kw)
    lats["port"] = store["lat"]
    return lats


def summary(lats):
    ref = lats["jax"]
    return dict(max_abs_ref=float(np.abs(ref).max()),
                jax_one_level=float(np.abs(lats["jax_nudged"] - ref).max()),
                port_vs_jax=float(np.abs(lats["port"] - ref).max()))


def main():
    torch.set_num_threads(4)
    out = {}
    for name, run in (("diffusion_handles", lambda: dh_case(TDH.EDIT_KW)),
                      ("drag_diffusion_union_mask", dd_case)):
        t0 = time.perf_counter()
        out[name] = dict(summary(run()), seconds=time.perf_counter() - t0)
        print(name, json.dumps(out[name]), flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
