"""The SDXL backbone's batched lanes: the port's
`BatchedFreeFine(SDXLFreeFine).generation` and `generation_shared_source`
at two cases against the JAX package's, on `tiny_sdxl_pipeline_config`
with the same weights and JAX's own per-case draws (case i's `split` ->
`normal` chain from `jax.random.key(seed[i])`), 6 steps from start 3.
The SDXL (context, added) conditioning stacks case by case as JAX's
pytrees do.  Final latents within 2e-3 absolute; uint8 images within JAX's
own bound for its batched lanes (mean |diff| < 1, max 12).  Case i of a
batch against the port's single edit with the same seed within 1e-4 (as
`test_torch_batched.py`: the small GEMMs round differently at another
batch).
"""

import numpy as np
import pytest
import torch

from freefine_tpu import pipeline as JP
from freefine_tpu_torch import pipeline as P
from test_torch_bggen import _capture
from test_torch_sdxl_pipeline import TOL, _edit, _noise, pipes  # noqa: F401

torch.set_num_threads(2)

NUM_STEP, START = 6, 3
SINGLE_ATOL = 1e-4
SEEDS = [4, 9]


def _cases(cfg, shared):
    h, w = cfg.height, cfg.width
    out = []
    for c in range(2):
        img, mask, coarse, tm = _edit(cfg, c)
        if not shared:
            img = np.random.default_rng(30 + c).integers(0, 255, (h, w, 3), dtype=np.uint8)
        out.append(dict(ori_img=img, ori_mask=mask, coarse_input=coarse, target_mask=tm,
                        guidance_text=f"a cat {c}"))
    return out


@pytest.mark.parametrize("entry", ["generation", "generation_shared_source"])
def test_batched_lanes_match_jax(pipes, entry):
    cfg, jpipe, tpipe = pipes
    cases = _cases(cfg, entry == "generation_shared_source")
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=SEEDS)
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = getattr(JP.BatchedFreeFine(jpipe), entry)(cases, **kw)
    got = getattr(P.BatchedFreeFine(tpipe), entry)(
        cases, noise=[_noise(cfg, s, 2) for s in SEEDS], **kw)
    assert len(got) == 2 and tstore["lat"].shape == (2, cfg.latent_height, cfg.latent_width, 4)
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=TOL, rtol=0)
    for g, w in zip(got, want):
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.mean() < 1.0 and diff.max() <= 12, (diff.mean(), diff.max())


def test_case_of_a_batch_is_the_single_edit(pipes):
    cfg, _, tpipe = pipes
    h, w = cfg.height, cfg.width
    cases = _cases(cfg, False)
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1)
    store = {}
    _capture(tpipe, store, lambda a: a.numpy())
    imgs = P.BatchedFreeFine(tpipe).generation(cases, seed=SEEDS, **kw)
    batch_lat = store["lat"]
    for c, case in enumerate(cases):
        img = tpipe.generation(case["ori_img"], case["ori_mask"], case["coarse_input"],
                               case["target_mask"], case["guidance_text"], use_auto_draw=True,
                               reduce_inp_artifacts=True, cons_area=np.zeros((h, w), np.uint8),
                               seed=SEEDS[c], **kw)
        np.testing.assert_allclose(batch_lat[c], store["lat"][0], atol=SINGLE_ATOL, rtol=0)
        assert np.abs(img.astype(int) - imgs[c].astype(int)).max() <= 1


