"""The port's RegionDrag baseline (`freefine_tpu_torch.baselines.region_drag`)
and the drag attention mode against the JAX package's.

  * `region_pair_to_pts` and `pad_points` bit-equal, on region pairs whose
    target is larger than the source, so that many target pixels map onto
    one source pixel;
  * the cycle-SDE steps and `reverse_step` within 1e-6 of max |ref|, on a
    stand-in denoiser and JAX's own Gaussian draw;
  * `copy_paste` bit-equal and `blur_points` within 1e-6, with pad rows
    and repeated indices (the port keeps the last row of a repeated index,
    as JAX's CPU scatter does);
  * the drag dispatch's three branches (out of scope, in scope without a
    state, in scope with the gate on and off) within 2e-4;
  * `RegionDrag.drag_regions` in both methods on `tiny_pipeline_config`
    (64^2, 4 steps, start 0.5, end 0.25; weights carried through
    `freefine_tpu.weights.convert_*`; JAX's draws replayed: its `split`
    chain's forward draws, then the blur draw): final latents within 2e-3
    absolute, uint8 images within 1.

JAX's attention runs its einsum route (`FREEFINE_FLASH` unset on the CPU);
the port's kernel wrappers run their plain twins on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.baselines import region_drag as JRD
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.ops import attention as JA
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu.schedulers.ddim import DDIMSchedule as JSchedule
from freefine_tpu_torch.baselines import region_drag as RD
from freefine_tpu_torch.edit import EditConfig, EditState
from freefine_tpu_torch.ops import attention as A
from freefine_tpu_torch.pipeline import FreeFine
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule
from test_torch_bggen import _capture
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

SIDE = 64
STEPS, START_T, END_T = 4, 0.5, 0.25


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _regions(side, seed):
    """A source region and a larger, shifted target region: the target's
    pixels map many-to-one onto the source's."""
    rng = np.random.default_rng(seed)
    src = np.zeros((side, side), np.uint8)
    trg = np.zeros((side, side), np.uint8)
    y0, x0 = rng.integers(2, side // 4, 2)
    src[y0: y0 + side // 5, x0: x0 + side // 6] = 255
    src[y0 + 2: y0 + side // 4, x0 + 3: x0 + side // 5] = 255
    trg[side // 2 - 4: side // 2 + side // 3, side // 3: side // 3 + side // 2] = 255
    return src, trg


@pytest.fixture(scope="module")
def pipes():
    """The tiny config's JAX and port pipelines on the same weights."""
    cfg, mods = tiny_modules(61)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


@pytest.mark.parametrize("scale", [1.0, 1 / 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_region_pair_to_pts_is_bit_equal(scale, seed):
    src, trg = _regions(256, seed)
    want_s, want_t = JRD.region_pair_to_pts(src, trg, scale)
    got_s, got_t = RD.region_pair_to_pts(src, trg, scale)
    assert np.array_equal(got_s, want_s) and np.array_equal(got_t, want_t)
    assert len(np.unique(got_s, axis=0)) < len(got_s)  # repeated source points
    n = len(got_t) + 5
    assert np.array_equal(RD.pad_points(got_t, n, 99), JRD.pad_points(want_t, n, 99))
    assert np.array_equal(RD.pad_points(got_t, 3, 99), JRD.pad_points(want_t, 3, 99))


def test_cycle_steps_match_jax():
    jsched = JSchedule.create(num_inference_steps=10)
    sched = DDIMSchedule.create(num_inference_steps=10)
    x = np.asarray(jax.random.normal(jax.random.key(1), (1, 8, 8, 4), jnp.float32))
    rng = jax.random.key(0)
    z = torch.from_numpy(np.array(jax.random.normal(rng, x.shape, jnp.float32)))

    def j_eps(v, t):
        return 0.1 * v + 0.01 * jnp.asarray(t).astype(jnp.float32)

    def t_eps(v, t):
        return 0.1 * v + 0.01 * float(np.float32(t))

    for t in (1, 301, 801, 881):
        want = JRD.forward_sde_step(jsched, j_eps, jnp.int32(t), jnp.asarray(x), rng)
        got = RD.forward_sde_step(sched, t_eps, t, torch.from_numpy(x), z)
        for g, w in zip(got, want):
            _close(g, w, 1e-6)
        tn = t + sched.step_delta
        eps = t_eps(got[0], tn)
        back = RD.reverse_step(sched, eps, tn, got[0], got[1], sde=True)
        _close(back, JRD.reverse_step(jsched, j_eps(want[0], tn), jnp.int32(tn), want[0], want[1],
                                      sde=True), 1e-6)
        _close(back, x, 1e-4)  # cycle consistency
        want = JRD.forward_ode_step(jsched, j_eps, jnp.int32(t), jnp.asarray(x))
        got = RD.forward_ode_step(sched, t_eps, t, torch.from_numpy(x))
        _close(got[0], want[0], 1e-6)
        assert not got[1].any()
        _close(RD.reverse_step(sched, got[0], tn, got[0], got[1], sde=False),
               JRD.reverse_step(jsched, want[0], jnp.int32(tn), want[0], want[1], sde=False), 1e-6)


def test_copy_paste_and_blur_points_with_pad_rows_and_repeats():
    rng = np.random.default_rng(3)
    lat = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    dst = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    src, trg = _regions(64, 2)
    s, t = RD.region_pair_to_pts(src, trg, 1 / 8)
    n = 64
    sp, tp = RD.pad_points(s, n, 8), RD.pad_points(t, n, 8)
    assert len(s) < n and len(np.unique(s, axis=0)) < len(s)
    want = JRD.copy_paste(jnp.asarray(lat), jnp.asarray(dst), jnp.asarray(sp), jnp.asarray(tp))
    got = RD.copy_paste(torch.from_numpy(lat), torch.from_numpy(dst), torch.from_numpy(sp),
                        torch.from_numpy(tp))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # blur at the repeated source points, then at target ++ source (the ODE method)
    for pts in (sp, RD.pad_points(np.concatenate([t, s]), 2 * n, 8)):
        key = jax.random.key(5)
        noise = torch.from_numpy(np.array(jax.random.normal(key, (len(pts), 4), jnp.float32)))
        for scale in (1.0, 0.6):
            want = JRD.blur_points(jnp.asarray(lat), jnp.asarray(pts), scale, key)
            got = RD.blur_points(torch.from_numpy(lat), torch.from_numpy(pts), scale, noise)
            _close(got, want, 1e-6)
            assert not np.array_equal(got.numpy(), lat)


def _drag_inputs(seed, b=2, seq=64, e=32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, seq, e)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("branch", ["out_of_scope", "no_state", "gate_on", "gate_off"])
def test_drag_dispatch_matches_jax(branch):
    q, k, v = _drag_inputs(4)
    heads = 2
    scope = dict(layer_range=(0, 10 ** 6), tca_scope=("down", "mid", "up"))
    if branch == "out_of_scope":
        scope = dict(layer_range=(10, 16))
    jcfg = JEditConfig(mode="drag", method=None, local_cfg=False, num_streams=2, **scope)
    tcfg = EditConfig(mode="drag", method=None, local_cfg=False, **scope)
    jstate = tstate = None
    if branch.startswith("gate"):
        g = 1.0 if branch == "gate_on" else 0.0
        jstate, tstate = JEditState(share_gate=jnp.float32(g)), EditState(share_gate=g)
    want = JA.edit_self_attention(*(jnp.asarray(x) for x in (q, k, v)), heads, jcfg, jstate, 3,
                                  "down")
    got = A.edit_self_attention(*(torch.from_numpy(x) for x in (q, k, v)), heads, tcfg, tstate, 3,
                                "down")
    _close(got, want, 2e-4)
    plain = JA.sdpa(*(jnp.asarray(x) for x in (q, k, v)), heads)
    replaced = branch in ("no_state", "gate_on")
    assert (np.abs(np.asarray(want) - np.asarray(plain)).max() > 1e-3) == replaced


def jax_draws(seed, k, lh, lw, n_blur, sde):
    """JAX's draws of `drag`: the forward pass's per-step normals (SDE),
    then the blur draw."""
    rng = jax.random.key(seed)
    rng, r_fwd, r_blur = jax.random.split(rng, 3)
    fwd = None
    if sde:
        fwd, r = [], r_fwd
        for _ in range(k):
            r, sub = jax.random.split(r)
            fwd.append(torch.from_numpy(np.array(
                jax.random.normal(sub, (1, lh, lw, 4), jnp.float32))))
    blur = torch.from_numpy(np.array(jax.random.normal(r_blur, (n_blur, 4), jnp.float32)))
    return fwd, blur


@pytest.mark.parametrize("method", ["encode_then_cp", "cp_then_encode"])
def test_drag_regions_matches_jax(pipes, method):
    cfg, jpipe, tpipe = pipes
    lh, lw = cfg.latent_height, cfg.latent_width
    rng = np.random.default_rng(8)
    img = rng.integers(0, 255, (SIDE, SIDE, 3), dtype=np.uint8)
    src, trg = _regions(SIDE, 4)
    s, t = RD.region_pair_to_pts(src, trg, 1 / 8)
    assert len(np.unique(s, axis=0)) < len(s)
    seed = 6
    kw = dict(steps=STEPS, start_t=START_T, end_t=END_T, seed=seed, method=method)
    if method == "cp_then_encode":
        kw["preview_image"] = rng.integers(0, 255, (SIDE, SIDE, 3), dtype=np.uint8)
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = JRD.RegionDrag(jpipe).drag_regions(img, src, trg, "a cat", **kw)
    n_pts = int(2 ** np.ceil(np.log2(len(t))))
    n_blur = n_pts if method == "encode_then_cp" else 2 * n_pts
    noise = jax_draws(seed, int(START_T * STEPS), lh, lw, n_blur, method == "encode_then_cp")
    got = RD.RegionDrag(tpipe).drag_regions(img, src, trg, "a cat", noise=noise, **kw)
    assert got.shape == (SIDE, SIDE, 3) and got.dtype == np.uint8
    assert np.isfinite(tstore["lat"]).all()
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1
