"""Energy guidance of the port (`freefine_tpu_torch.ops.guidance`) against
`freefine_tpu.ops.guidance` on the CPU: the resize, the cosine energies and
the feature warp on random inputs, and `move_energy` / `energy_guidance`
through the tiny UNet with the same weights (carried through
`freefine_tpu.weights.convert_unet`), the setup of tests/test_guidance.py
with random latents.

Tolerances: the nearest resize is exact; cosines within 1e-6; the warp
within 1e-5 (bilinear weights computed in float32 by two formulas); the
energies within 1e-5 relative and the guidance gradient within 1e-3 of
max|g| (float32 on both sides; the gradient runs back through ~30 layers
of the UNet, summed in another order by XLA and ATen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.models.unet import UNet2DCondition as JUNet
from freefine_tpu.ops import guidance as JG
from freefine_tpu_torch.ops import guidance as G
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)


@pytest.mark.parametrize("src,dst", [((2, 2), (16, 16)), ((4, 4), (16, 16)),
                                     ((6, 5), (16, 16)), ((16, 16), (6, 10))],
                         ids=["x8", "x4", "non_integer_up", "non_integer_down"])
def test_resize_matches_jax(src, dst):
    f = np.random.default_rng(1).normal(size=(1, *src, 3)).astype(np.float32)
    want = np.asarray(JG._resize(jnp.asarray(f), dst))
    got = G._resize(torch.from_numpy(f), dst)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask_kind", ["random", "soft", "all_zero"])
def test_cosines_match_jax(mask_kind):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(6, 7, 8)).astype(np.float32)
    b = rng.normal(size=(6, 7, 8)).astype(np.float32)
    if mask_kind == "random":
        m1, m2 = ((rng.random((6, 7)) > 0.5).astype(np.float32) for _ in range(2))
    elif mask_kind == "soft":
        m1, m2 = (rng.random((6, 7)).astype(np.float32) for _ in range(2))
    else:
        m1 = m2 = np.zeros((6, 7), np.float32)
    ja, jb, j1, j2 = (jnp.asarray(x) for x in (a, b, m1, m2))
    ta, tb, t1, t2 = (torch.from_numpy(x) for x in (a, b, m1, m2))
    got = [G.masked_cosine(ta, tb, t1), G.global_masked_cosine(ta, tb, t1, t2)]
    want = [JG.masked_cosine(ja, jb, j1), JG.global_masked_cosine(ja, jb, j1, j2)]
    for g, w in zip(got, want):
        assert np.isfinite(float(g))
        np.testing.assert_allclose(float(g), float(w), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(G.masked_cosine(ta, ta, torch.ones(6, 7))), 1.0, atol=1e-6)


@pytest.mark.parametrize("kind", ["identity", "rotation"])
def test_warp_features_matches_jax(kind):
    h, w = 9, 11
    f = np.random.default_rng(3).normal(size=(h, w, 4)).astype(np.float32)
    if kind == "identity":
        m = np.array([[1, 0, 0], [0, 1, 0]], np.float32)
    else:
        # 30 degrees about a point off centre, shifted: part of the grid
        # samples outside the source and must come out zero
        c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
        m = np.array([[c, -s, 2.5], [s, c, -3.0]], np.float32)
    want = np.asarray(JG.warp_features(jnp.asarray(f), jnp.asarray(m)))
    got = G.warp_features(torch.from_numpy(f), torch.from_numpy(m)).numpy()
    if kind == "identity":
        np.testing.assert_allclose(got, f, atol=1e-6)
    else:
        assert (np.abs(want).sum(-1) == 0).any()  # some samples fall outside
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def energy_setup():
    cfg, mods = tiny_modules(31)
    jcfg = jax_tiny_config()
    jparams = jax_params(mods["unet"], "unet", jcfg)
    junet = JUNet(config=jcfg.unet)

    def j_apply(p, s, t, emb, return_features=False):
        return junet.apply(p, s, t, emb, return_features=return_features)

    pipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    lh = cfg.latent_height
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(1, lh, lh, 4)).astype(np.float32)
    ref = rng.normal(size=(1, lh, lh, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 77, cfg.unet.cross_attention_dim)).astype(np.float32)
    hw = (2 * lh, 2 * lh)
    mask_cur = np.zeros(hw, np.float32)
    mask_cur[4:10, 4:10] = 1.0
    mask_no = np.zeros(hw, np.float32)
    mask_no[10:14, 9:15] = 1.0
    masks = (mask_cur, 1.0 - mask_cur, mask_no)
    guide = np.zeros((lh, lh), np.float32)
    guide[2:5, 2:5] = 1.0
    return dict(j_apply=j_apply, jparams=jparams, pipe=pipe, lat=lat, ref=ref, ctx=ctx, hw=hw,
                masks=masks, guide=guide)


def _j(e, *names):
    return [jnp.asarray(e[n]) for n in names]


def _kw(e, to):
    mc, mo, mn = (to(x) for x in e["masks"])
    return dict(feature_indices=(1, 2), target_hw=e["hw"], inv_warp=None, mask_cur=mc,
                mask_other=mo, mask_non_overlap=mn)


def test_move_energy_split_matches_jax(energy_setup):
    e = energy_setup

    @jax.jit
    def energy(p, lat, ref, ctx):
        return JG.move_energy(e["j_apply"], p, lat, ref, jnp.int32(100), ctx, split=True,
                              **_kw(e, jnp.asarray))

    want = energy(e["jparams"], *_j(e, "lat", "ref", "ctx"))
    with torch.no_grad():
        got = G.move_energy(e["pipe"].unet_apply, torch.from_numpy(e["lat"]),
                            torch.from_numpy(e["ref"]), 100, torch.from_numpy(e["ctx"]),
                            split=True, **_kw(e, torch.from_numpy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=0)
    total = G.move_energy(e["pipe"].unet_apply, torch.from_numpy(e["lat"]),
                          torch.from_numpy(e["ref"]), 100, torch.from_numpy(e["ctx"]),
                          **_kw(e, torch.from_numpy))
    np.testing.assert_allclose(float(total), float(want[0] + want[1]), rtol=1e-5)


def test_energy_guidance_matches_jax(energy_setup):
    e = energy_setup

    @jax.jit
    def guidance(p, lat, ref, ctx, guide):
        return JG.energy_guidance(e["j_apply"], p, lat, ref, jnp.int32(100), ctx,
                                  energy_scale=2.0, guidance_mask=guide, **_kw(e, jnp.asarray))

    want = np.asarray(guidance(e["jparams"], *_j(e, "lat", "ref", "ctx", "guide")))
    got = G.energy_guidance(
        e["pipe"].unet_apply, torch.from_numpy(e["lat"]), torch.from_numpy(e["ref"]), 100,
        torch.from_numpy(e["ctx"]), energy_scale=2.0, guidance_mask=torch.from_numpy(e["guide"]),
        **_kw(e, torch.from_numpy))
    assert got.shape == want.shape and got.grad_fn is None
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3 * np.abs(want).max(), rtol=0)
    # the pipeline's weights are frozen: the energy graph recorded none
    assert all(p.grad is None and not p.requires_grad for p in e["pipe"].unet.parameters())
