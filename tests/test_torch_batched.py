"""The batched per-case lanes of the port (`BatchedFreeFine.generation`,
`background_generation`, `cross_image_composition`) against the JAX
package's, on `tiny_pipeline_config` with the same weights (carried
through `freefine_tpu.weights.convert_*`) and JAX's own per-case draws
(case i's `split` -> `normal` chain from `jax.random.key(seed[i])`):
two cases, 6 steps, start 3; final latents within 2e-3 absolute (as the
single-edit whole-path tests), uint8 images within mean |diff| < 1 and
max 12 (JAX's own bound for its batched lanes).

Also: each step is one UNet call over every case; case i of a batch
against the port's single-edit entry point with the same seed (final
latents within 1e-4 absolute: float32 on the CPU, where the small
time-embedding GEMMs already round differently at batch 3 and 6, about
1e-8, and the inversion compounds it to about 2e-5); the per-case
`ctrl_step` bit for bit against each case's own step; the per-case
generators; and the stage timer.
"""

import numpy as np
import pytest
import torch

from freefine_tpu import pipeline as JP
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu_torch import pipeline as P
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, ctrl_step
from freefine_tpu_torch.utils.profiling import StageTimer
from test_torch_bggen import _capture, jax_noise
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

CASES = 2
NUM_STEP, START = 6, 3
K = NUM_STEP - START
SEEDS = [4, 9]
SINGLE_ATOL = 1e-4


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(71)
    jcfg = jax_tiny_config()
    jpipe = JP.FreeFine(config=jcfg,
                        params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = P.FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def _box(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 255
    return m


def _cases(cfg, entry):
    """Two cases of an entry point, each with its own images and masks."""
    h, w = cfg.height, cfg.width
    out = []
    for c in range(CASES):
        rr = np.random.default_rng(30 + c)
        img, coarse, src2 = (rr.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(3))
        m = _box(h, w, 8 + 4 * c, 26 + 4 * c, 10, 30)
        tm = _box(h, w, 20, 44, 16 + 6 * c, 40 + 6 * c)
        if entry == "generation":
            out.append(dict(ori_img=img, ori_mask=m, coarse_input=coarse, target_mask=tm,
                            guidance_text=f"a cat {c}"))
        elif entry == "background_generation":
            out.append(dict(ori_img=img, ori_mask=m, guidance_text=f"a wall {c}"))
        else:
            out.append(dict(img_lists=[img, src2], ori_mask_lists=[m, _box(h, w, 34, 60, 34, 60)],
                            tgt_mask_lists=[tm, _box(h, w, 36, 58, 4, 28)], coarse_input=coarse,
                            guidance_text_list=[f"a cat {c}", "a dog"]))
    return out


# entry point: (per-step draw rows, UNet batch per case in inversion and in sampling)
ENTRIES = {"generation": (2, 2, 3), "background_generation": (2, 1, 3),
           "cross_image_composition": (1, 3, 4)}
EXTRA = {"cross_image_composition": dict(dil_factor=5)}


def _unet_batches(tpipe, run):
    seen = []
    handle = tpipe.unet.register_forward_pre_hook(lambda m, a: seen.append(a[0].shape[0]))
    try:
        run()
    finally:
        handle.remove()
    return seen


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_per_case_entry_points_match_jax(pipes, entry):
    cfg, jpipe, tpipe = pipes
    rows, inv_batch, edit_batch = ENTRIES[entry]
    cases = _cases(cfg, entry)
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=SEEDS, **EXTRA.get(entry, {}))
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = getattr(JP.BatchedFreeFine(jpipe), entry)(cases, **kw)
    noise = [jax_noise(s, K, (rows, cfg.latent_height, cfg.latent_width, 4)) for s in SEEDS]
    batched = P.BatchedFreeFine(tpipe)
    got = getattr(batched, entry)(cases, noise=noise, **kw)
    assert len(got) == CASES and got[0].shape == (cfg.height, cfg.width, 3)
    assert tstore["lat"].shape == (CASES, cfg.latent_height, cfg.latent_width, 4)
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=2e-3, rtol=0)
    for g, w in zip(got, want):
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.mean() < 1.0 and diff.max() <= 12, (diff.mean(), diff.max())
    # one UNet call per step over every case's streams
    assert _unet_batches(tpipe, lambda: getattr(batched, entry)(cases, **kw)) == \
        [CASES * inv_batch] * K + [CASES * edit_batch] * K


def _single(tpipe, entry, case, seed, **kw):
    if entry == "generation":
        h, w = tpipe.config.height, tpipe.config.width
        return tpipe.generation(case["ori_img"], case["ori_mask"], case["coarse_input"],
                                case["target_mask"], case["guidance_text"], use_auto_draw=True,
                                reduce_inp_artifacts=True, cons_area=np.zeros((h, w), np.uint8),
                                seed=seed, **kw)
    if entry == "background_generation":
        return tpipe.background_generation(case["ori_img"], case["ori_mask"],
                                           case["guidance_text"], seed=seed, **kw)
    return tpipe.cross_image_composition(case["img_lists"], case["ori_mask_lists"],
                                         case["tgt_mask_lists"], case["coarse_input"],
                                         case["guidance_text_list"], seed=seed, **kw)


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_case_of_a_batch_is_the_single_edit(pipes, entry):
    """A sequence of seeds gives case i the single-edit entry point's
    generator, so case i of the batch is that edit alone."""
    cfg, _, tpipe = pipes
    cases = _cases(cfg, entry)
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, **EXTRA.get(entry, {}))
    store = {}
    _capture(tpipe, store, lambda a: a.numpy())
    imgs = getattr(P.BatchedFreeFine(tpipe), entry)(cases, seed=SEEDS, **kw)
    batch_lat = store["lat"]
    for c, case in enumerate(cases):
        img = _single(tpipe, entry, case, SEEDS[c], **kw)
        np.testing.assert_allclose(batch_lat[c], store["lat"][0], atol=SINGLE_ATOL, rtol=0)
        assert np.abs(img.astype(int) - imgs[c].astype(int)).max() <= 1


def test_ctrl_step_per_case_is_each_case_step():
    rng = np.random.default_rng(3)
    sched = DDIMSchedule.create(num_inference_steps=NUM_STEP)
    x, eps, noise = (torch.from_numpy(rng.normal(size=(3, 2, 8, 8, 4)).astype(np.float32))
                     for _ in range(3))
    mask = torch.from_numpy((rng.random((3, 8, 8)) > 0.5).astype(np.float32))
    t = int(sched.timesteps[START])
    got, got_x0 = ctrl_step(sched, eps, t, x, mask, 1.0, noise, ddim_streams_from=1)
    for c in range(3):
        want, want_x0 = ctrl_step(sched, eps[c], t, x[c], mask[c], 1.0, noise[c],
                                  ddim_streams_from=1)
        assert torch.equal(got[c], want) and torch.equal(got_x0[c], want_x0)


def test_case_generators():
    draws = [torch.randn(4, generator=g) for g in P._case_rngs([5, 7], 2, "cpu")]
    for s, d in zip((5, 7), draws):
        assert torch.equal(d, torch.randn(4, generator=torch.Generator().manual_seed(s)))
    a = [torch.randn(4, generator=g) for g in P._case_rngs(42, 3, "cpu")]
    b = [torch.randn(4, generator=g) for g in P._case_rngs(42, 3, "cpu")]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[1], a[2])
    with pytest.raises(ValueError):
        P._case_rngs([1, 2, 3], 2, "cpu")


def test_stage_timer_times_each_stage(pipes):
    cfg, _, tpipe = pipes
    timer = StageTimer()
    P.BatchedFreeFine(tpipe).generation(_cases(cfg, "generation"), num_step=4, start_step=2,
                                        end_step=1, timer=timer)
    stages = timer.summary()
    assert sorted(stages) == sorted(["prep_images", "vae_encode", "text_encode", "mask_prep",
                                     "edit", "decode"])
    assert all(s["count"] == 1 and s["total_s"] >= 0 for s in stages.values())
    assert "edit" in timer.report()
