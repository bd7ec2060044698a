"""The shared-source entry points of the port,
`BatchedFreeFine.generation_shared_source` and
`background_generation_shared_source`, against the JAX package's on
`tiny_pipeline_config` with the same weights (carried through
`freefine_tpu.weights.convert_*`) and JAX's own per-case draws (2-row
[case, ref] draws): two cases, 6 steps, start 3; final latents within 2e-3
absolute, uint8 images within mean |diff| < 1 and max 12 (JAX's own bound
for its batched lanes).  Also: one capture pass (batch 1) and one UNet
call over every case per step, and a mixed-source batch or a method other
than tca/mmsa refused.
"""

import numpy as np
import pytest
import torch

from freefine_tpu import pipeline as JP
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu_torch import pipeline as P
from test_torch_bggen import _capture, jax_noise
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

CASES = 2
NUM_STEP, START = 6, 3
K = NUM_STEP - START


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(61)
    jcfg = jax_tiny_config()
    jpipe = JP.FreeFine(config=jcfg,
                        params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = P.FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def _edit_cases(cfg, ori):
    h, w = cfg.height, cfg.width
    cases = []
    for c in range(CASES):
        rr = np.random.default_rng(20 + c)
        m = np.zeros((h, w), np.uint8)
        m[8:24, 8 + 4 * c : 24 + 4 * c] = 255
        tm = np.zeros((h, w), np.uint8)
        tm[16 + 6 * c : 32 + 6 * c, 16:32] = 255
        cases.append(dict(ori_img=ori, ori_mask=m, target_mask=tm, guidance_text=f"a cat {c}",
                          coarse_input=rr.integers(0, 255, (h, w, 3), dtype=np.uint8)))
    return cases


def _unet_batches(tpipe, run):
    """The batch of every UNet call `run` makes."""
    seen = []
    handle = tpipe.unet.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[0]))
    try:
        run()
    finally:
        handle.remove()
    return seen


@pytest.mark.parametrize("entry", ["generation_shared_source",
                                   "background_generation_shared_source"])
def test_shared_source_entry_points_match_jax(pipes, entry):
    cfg, jpipe, tpipe = pipes
    h, w = cfg.height, cfg.width
    ori = np.random.default_rng(7).integers(0, 255, (h, w, 3), dtype=np.uint8)
    cases = _edit_cases(cfg, ori)
    if entry.startswith("background"):
        cases = [dict(ori_img=ori, ori_mask=c["ori_mask"], guidance_text=c["guidance_text"])
                 for c in cases]
    seeds = [3, 8]
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=seeds)
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = getattr(JP.BatchedFreeFine(jpipe), entry)(cases, **kw)
    noise = [jax_noise(s, K, (2, cfg.latent_height, cfg.latent_width, 4)) for s in seeds]
    batched = P.BatchedFreeFine(tpipe)
    got = getattr(batched, entry)(cases, noise=noise, **kw)
    assert len(got) == CASES and got[0].shape == (h, w, 3) and got[0].dtype == np.uint8
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=2e-3, rtol=0)
    for g, w_ in zip(got, want):
        diff = np.abs(g.astype(np.int32) - w_.astype(np.int32))
        assert diff.mean() < 1.0 and diff.max() <= 12, (diff.mean(), diff.max())

    # per step one capture pass (batch 1) and one UNet call over both cases
    inversions = [CASES] * K + [1] * K if entry == "generation_shared_source" else [1] * K
    assert _unet_batches(tpipe, lambda: getattr(batched, entry)(cases, **kw)) == \
        inversions + [1, 2 * CASES] * K

    bad = [cases[0], dict(cases[1], ori_img=255 - ori)]
    with pytest.raises(ValueError, match="one ori_img"):
        getattr(batched, entry)(bad, **kw)
    with pytest.raises(ValueError, match="tca/mmsa"):
        getattr(batched, entry)(cases, method_type="sdsa", **kw)
