"""The energy-guided edit as a whole: the port's
`FreeFine.guided_generation` against the JAX package's on
`tiny_pipeline_config`, same weights (carried through
`freefine_tpu.weights.convert_*`), JAX's own noise draws replayed into the
port (the `split` -> `normal` chain of `sample_guided_loop`).

6 steps from start 3 with energy_fraction 0.6: the energy gradient is added
on the first 2 of the 3 regeneration steps, so both the guided and the
skipped step run.  Tolerance: final latents within 2e-3 absolute (float32
on both sides; summation-order differences compound over 3 inversion and 3
regeneration passes and 2 energy gradients), uint8 images within 1 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.ops.geometry import re_edit_2d as j_re_edit_2d
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

NUM_STEP, START, FRACTION = 6, 3, 0.6
K = NUM_STEP - START


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(41)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def _capture(pipe, store, to_np):
    orig = pipe.latent_to_image

    def cap(lat):
        store["lat"] = to_np(lat)
        return orig(lat)

    pipe.latent_to_image = cap


def test_guided_generation_matches_jax(pipes):
    cfg, jpipe, tpipe = pipes
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(6)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[12:36, 16:40] = 255
    coarse, tm, _ = j_re_edit_2d(img, mask, dx=12, dy=-4, rotation=15)
    coarse, tm = np.asarray(coarse), np.asarray(tm)
    seed = 5
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, energy_fraction=FRACTION,
              energy_scale=2.0, seed=seed)
    assert 0 < int(round(K * FRACTION)) < K
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda x: x.numpy())
    want = jpipe.guided_generation(img, mask, coarse, tm, "a cat", **kw)

    key = jax.random.key(seed)
    noise = []
    for _ in range(K):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (2, cfg.latent_height, cfg.latent_width, 4), jnp.float32))))
    got = tpipe.guided_generation(img, mask, coarse, tm, "a cat", noise=noise, **kw)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    assert np.isfinite(tstore["lat"]).all()
    # the port decodes the edit stream alone; JAX decodes [edit, reference]
    assert tstore["lat"].shape == jstore["lat"][:1].shape
    np.testing.assert_allclose(tstore["lat"], jstore["lat"][:1], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the energy is live: without it the latents move by far more than the tolerance
    guided = tstore["lat"]
    tpipe.guided_generation(img, mask, coarse, tm, "a cat", noise=noise,
                            **dict(kw, energy_fraction=0.0))
    assert np.abs(tstore["lat"] - guided).max() > 10 * 2e-3
