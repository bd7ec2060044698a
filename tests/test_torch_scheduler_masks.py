"""Host-side pieces of the port against the JAX package: the DDIM
scheduler, the mask engine, the mask pyramid and the coarse 2D edit.

Masks are compared bit for bit; scheduler steps within 1e-6 (float32 on
both sides, the same scalar arithmetic); the warped image within one level
of uint8 (bilinear weights may differ in the last float32 bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import edit as JE
from freefine_tpu import masks as JM
from freefine_tpu.ops import geometry as JG
from freefine_tpu.pipeline import _method_and_gates
from freefine_tpu.schedulers import ddim as JD
from freefine_tpu_torch import edit as E
from freefine_tpu_torch import masks as M
from freefine_tpu_torch.ops import geometry as G
from freefine_tpu_torch.schedulers import ddim as D

torch.set_num_threads(2)


@pytest.mark.parametrize("steps", [50, 8])
def test_schedule_tables_match(steps):
    j = JD.DDIMSchedule.create(num_inference_steps=steps)
    t = D.DDIMSchedule.create(num_inference_steps=steps)
    np.testing.assert_array_equal(t.alphas_cumprod, np.asarray(j.alphas_cumprod))
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    assert t.final_alpha_cumprod == np.asarray(j.final_alpha_cumprod)
    for ts in (981, 21, 1, 0, -19):
        assert np.float32(t.variance(ts)) == pytest.approx(float(j.variance(jnp.int32(ts))),
                                                            rel=1e-6)


@pytest.mark.parametrize("timestep", [1, 21, 961, 981])
def test_inv_step_matches(timestep):
    rng = np.random.default_rng(timestep)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    sched_j = JD.DDIMSchedule.create()
    want = JD.inv_step(sched_j, jnp.asarray(eps), jnp.int32(timestep), jnp.asarray(x))
    got = D.inv_step(D.DDIMSchedule.create(), torch.from_numpy(eps), timestep,
                     torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("timestep,eta", [(281, 1.0), (21, 1.0), (1, 1.0), (501, 0.0)])
def test_ctrl_step_matches_with_jax_noise(timestep, eta):
    rng = np.random.default_rng(timestep)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    eps = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    mask = (rng.random((8, 8)) > 0.5).astype(np.float32)
    key = jax.random.key(3)
    sched_j = JD.DDIMSchedule.create()
    want = JD.ctrl_step(sched_j, jnp.asarray(eps), jnp.int32(timestep), jnp.asarray(x),
                        jnp.asarray(mask), eta, key, ddim_streams_from=1)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    got = D.ctrl_step(D.DDIMSchedule.create(), torch.from_numpy(eps), timestep,
                      torch.from_numpy(x), torch.from_numpy(mask), eta,
                      torch.from_numpy(noise.copy()), ddim_streams_from=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("method", ["tca", "mmsa", "mmsa_es", "ssa"])
def test_method_and_gates_match(method):
    want = _method_and_gates(method, 35, 10, 50, 0.5)
    got = D.method_and_gates(method, 35, 10, 50, 0.5)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def _masks(h, w, seed):
    rng = np.random.default_rng(seed)
    shifted = np.zeros((h, w), np.uint8)
    shifted[h // 3 : h // 2 + 7, w // 4 : w // 2 + 3] = 255
    ori = np.zeros((h, w), np.uint8)
    ori[h // 5 : h // 2, w // 3 : 2 * w // 3] = 255
    draw = (rng.random((h, w)) > 0.7).astype(np.uint8) * 255
    cons = np.zeros((h, w), np.uint8)
    cons[: h // 6, : w // 2] = 255
    return shifted, ori, draw, cons


@pytest.mark.parametrize("auto_draw", [False, True])
@pytest.mark.parametrize("reduce", [False, True])
def test_prepare_various_mask_bit_exact(auto_draw, reduce):
    h = w = 96
    shifted, ori, draw, cons = _masks(h, w, 1)
    args = (shifted, ori, None if auto_draw else draw)
    want = JM.prepare_various_mask(*(None if a is None else jnp.asarray(a) for a in args),
                                   h, w, 12, 12, use_auto_draw=auto_draw,
                                   cons_area=jnp.asarray(cons), reduce_inp_artifacts=reduce)
    got = M.prepare_various_mask(*(None if a is None else torch.from_numpy(a) for a in args),
                                 h, w, 12, 12, use_auto_draw=auto_draw,
                                 cons_area=torch.from_numpy(cons), reduce_inp_artifacts=reduce)
    for name, g, wnt in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt), err_msg=name)


@pytest.mark.parametrize("factor", [2, 3, 15, 30])
def test_dilate_erode_bit_exact(factor):
    rng = np.random.default_rng(factor)
    m = (rng.random((40, 33)) > 0.8).astype(np.float32)
    np.testing.assert_array_equal(M.dilate(torch.from_numpy(m), factor).numpy(),
                                  np.asarray(JM.dilate(jnp.asarray(m), factor)))
    np.testing.assert_array_equal(M.erode(torch.from_numpy(m), factor).numpy(),
                                  np.asarray(JM.erode(jnp.asarray(m), factor)))


@pytest.mark.parametrize("size", [(64, 64), (512, 512), (100, 60)])
def test_mask_pyramid_bit_exact(size):
    h, w = size
    rng = np.random.default_rng(0)
    m = (rng.random((h, w)) > 0.5).astype(np.float32)
    lh, lw = h // 8, w // 8
    assert E.attention_resolutions(lh, lw) == JE.attention_resolutions(lh, lw)
    want = JE.build_mask_pyramid(jnp.asarray(m), lh, lw)
    got = E.build_mask_pyramid(torch.from_numpy(m), lh, lw)
    assert set(got) == set(want)
    for s in want:
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want[s]))


@pytest.mark.parametrize(
    "kw",
    [dict(dx=10, dy=-6), dict(rotation=30, scale_x=1.2, scale_y=0.8),
     dict(edit_param=[5, 3, 0, 0, 0, -45, 0.7, 0.7, 1])],
)
def test_re_edit_2d_matches(kw):
    h = w = 64
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[16:40, 20:44] = 255
    want = JG.re_edit_2d(img, mask, **kw)
    got = G.re_edit_2d(img, mask, device="cpu", **kw)
    np.testing.assert_array_equal(got[1], want[1])  # target mask: bit exact
    for g, wnt in ((got[0], want[0]), (got[2], want[2])):
        assert np.abs(g.astype(int) - np.asarray(wnt).astype(int)).max() <= 1
