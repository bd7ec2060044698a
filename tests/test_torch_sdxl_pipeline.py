"""The SDXL backbone as a whole: the port's `SDXLFreeFine` entry points
against the JAX package's `SDXLFreeFine`, on
`tiny_sdxl_pipeline_config` with the same weights (carried through the JAX
package's SDXL converters, `test_torch_sdxl_models.jax_sdxl_params`) and
JAX's own noise draws replayed into the port (the `split` -> `normal`
chain of each loop).  `test_torch_sdxl_batched.py` holds the batched lanes.

6 steps from start 3 (composition with 2 sources).  Tolerance: final
latents within 2e-3 absolute (the standing whole-path tolerance: float32 on
both sides, summation order compounding over the inversion and
regeneration passes), uint8 images within 1 level.  The SDXL conditioning
rides through every loop: the added conditioning reaches every UNet call,
row for row with the context.
"""

import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_sdxl_pipeline_config as jax_tiny_sdxl_config
from freefine_tpu.ops.geometry import re_edit_2d as j_re_edit_2d
from freefine_tpu.sdxl import SDXLFreeFine as JSDXL
from freefine_tpu_torch.sdxl import SDXLFreeFine
from test_torch_bggen import _capture, jax_noise
from test_torch_sdxl_models import jax_sdxl_params, sdxl_modules

torch.set_num_threads(2)

NUM_STEP, START = 6, 3
K = NUM_STEP - START
TOL = 2e-3


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = sdxl_modules(81)
    jcfg = jax_tiny_sdxl_config()
    jpipe = JSDXL(config=jcfg, params={k: jax_sdxl_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = SDXLFreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()},
                         device="cpu")
    return cfg, jpipe, tpipe


def _box(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 255
    return m


def _edit(cfg, c=0):
    h, w = cfg.height, cfg.width
    img = np.random.default_rng(6).integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = _box(h, w, 12, 36, 16, 40)
    coarse, tm, _ = j_re_edit_2d(img, mask, dx=10 - 6 * c, dy=4 + 2 * c, rotation=20 - 8 * c)
    return img, mask, np.asarray(coarse), np.asarray(tm)


def _noise(cfg, seed, rows):
    return jax_noise(seed, K, (rows, cfg.latent_height, cfg.latent_width, 4))


def _added_rows(tpipe, run):
    """(context rows, added-conditioning rows) of every UNet call `run` makes."""
    seen = []

    def hook(_, args, kwargs):
        seen.append((args[2].shape[0], kwargs["added_cond"].shape[0]))

    handle = tpipe.unet.register_forward_pre_hook(hook, with_kwargs=True)
    try:
        run()
    finally:
        handle.remove()
    return seen


# `guided_generation` is held to JAX nowhere: the JAX package's energy
# guidance hands SDXL's (context, added) pair to its UNet whole, and fails
# (ROADMAP C6); `test_guided_generation_carries_the_conditioning` runs the
# port's alone
ENTRIES = ("generation", "background_generation", "cross_image_composition")


def _run(pipe, entry, cfg, **kw):
    h, w = cfg.height, cfg.width
    img, mask, coarse, tm = _edit(cfg)
    if entry == "generation":
        return pipe.generation(img, mask, coarse, tm, "a cat", use_auto_draw=True,
                               cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True,
                               **kw)
    if entry == "guided_generation":
        return pipe.guided_generation(img, mask, coarse, tm, "a cat", energy_fraction=0.6, **kw)
    if entry == "background_generation":
        return pipe.background_generation(img, mask, "a wall", **kw)
    src2 = np.random.default_rng(8).integers(0, 255, (h, w, 3), dtype=np.uint8)
    return pipe.cross_image_composition([img, src2], [mask, _box(h, w, 34, 60, 34, 60)],
                                        [tm, _box(h, w, 36, 58, 4, 28)], coarse,
                                        ["a cat", "a dog"], dil_factor=5, **kw)


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_match_jax(pipes, entry):
    cfg, jpipe, tpipe = pipes
    seed = 5
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=seed)
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = _run(jpipe, entry, cfg, **kw)
    rows = 1 if entry == "cross_image_composition" else 2
    got = {}
    calls = _added_rows(tpipe, lambda: got.setdefault("img", _run(
        tpipe, entry, cfg, noise=_noise(cfg, seed, rows), **kw)))
    got = got["img"]
    assert got.shape == (cfg.height, cfg.width, 3) and got.dtype == np.uint8
    assert np.isfinite(tstore["lat"]).all()
    # the port decodes the edit stream alone
    n = tstore["lat"].shape[0]
    np.testing.assert_allclose(tstore["lat"], jstore["lat"][:n], atol=TOL, rtol=0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # every UNet call of the path carries the added conditioning row for row
    assert calls and all(c == a for c, a in calls), calls


def test_guided_generation_carries_the_conditioning(pipes):
    """The port's energy-guided edit on SDXL: finite, seeded runs equal,
    the added conditioning in every UNet call (the energy's feature passes
    included), and the energy live (it moves the latents by more than the
    parity tolerance)."""
    cfg, _, tpipe = pipes
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=5)
    store = {}
    _capture(tpipe, store, lambda a: a.numpy())
    calls = _added_rows(tpipe, lambda: _run(tpipe, "guided_generation", cfg, **kw))
    guided = store["lat"]
    assert np.isfinite(guided).all()
    assert calls and all(c == a for c, a in calls), calls
    assert len(calls) > 2 * K  # the energy's feature passes ran
    _run(tpipe, "guided_generation", cfg, **kw)
    np.testing.assert_array_equal(store["lat"], guided)
    tpipe.guided_generation(*_edit(cfg), "a cat", energy_fraction=0.0, **kw)
    assert np.abs(store["lat"] - guided).max() > TOL


def test_constructor_needs_weights_and_a_second_tower():
    from freefine_tpu_torch.config import tiny_pipeline_config, tiny_sdxl_pipeline_config

    with pytest.raises(ValueError, match="init_random"):
        SDXLFreeFine(tiny_sdxl_pipeline_config(), device="cpu")
    with pytest.raises(ValueError, match="second text tower"):
        SDXLFreeFine(tiny_pipeline_config(), init_random=True, device="cpu")
