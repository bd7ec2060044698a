"""The port's SelfGuidance baseline (`freefine_tpu_torch.baselines.self_guidance`)
against the JAX package's.

  * the energies (`normalize` ... `get_centroid`, `attn_diff_norm` with
    padded token rows, `soft_centroid`) within 1e-5 of max |ref|, the
    scalar energies `fix_shapes_l1`, `fix_sizes` and `position_deltas`
    (differences of terms of order 1 to 4) within 1e-5 absolute;
  * `silhouette_loss` and its gradients to the edit maps and the edit
    feature tap against `jax.grad`, within 1e-4 of max |ref|, at several
    transforms;
  * `guidance_gates`, `_ref_transform_gate` and `token_select` equal;
    `ddpm_step` within 1e-6 of max |ref| with JAX's draw;
  * one CFG pass with the token maps and the guidance tap recorded
    (`apply_sow` against JAX's `_apply_sow`): eps, each up-block map and
    the tap within 2e-4;
  * `SelfGuidance.edit` on `tiny_pipeline_config` (64^2, 4 steps: the
    gates 1, 1, 1, 0, so the port takes 3 gradients and skips the fourth)
    at GeoBench's weights, JAX's draws replayed (per step the original
    stream's, then the edit stream's): final latents within 2e-3
    absolute, uint8 images within 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.baselines import self_guidance as JSG
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu.schedulers.ddim import DDIMSchedule as JSchedule
from freefine_tpu_torch.baselines import self_guidance as SG
from freefine_tpu_torch.pipeline import FreeFine
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule
from test_torch_bggen import _capture
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

SIDE, STEPS = 64, 4
EDIT_PARAM = (0.1, -0.05, 0, 0, 0, 15, 1.2, 0.9, 1)


@pytest.fixture(scope="module")
def pipes():
    """The tiny config's JAX and port pipelines on the same weights."""
    cfg, mods = tiny_modules(73)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _maps(seed, n=2, side=8, k=3):
    return np.random.default_rng(seed).random((n, side * side, k)).astype(np.float32)


def test_energies_match_jax():
    o, e = _maps(1), _maps(2)
    valid = np.array([1, 1, 0], bool)
    a4 = e.reshape(2, 8, 8, 3)
    pairs = [
        (SG.normalize, JSG.normalize, (e,)),
        (SG.threshold_attention, JSG.threshold_attention, (e,)),
        (SG.get_shape, JSG.get_shape, (e,)),
        (SG.get_size, JSG.get_size, (e,)),
        (SG.get_centroid, JSG.get_centroid, (e,)),
        (SG.soft_centroid, JSG.soft_centroid, (a4,)),
        (SG.fix_appearances_by_feature, JSG.fix_appearances_by_feature, (o, e)),
    ]
    for got_fn, want_fn, args in pairs:
        _close(got_fn(*(torch.from_numpy(x) for x in args)),
               want_fn(*(jnp.asarray(x) for x in args)), 1e-5)
    for tv in (None, valid):
        for hard in (False, True):
            want = JSG.attn_diff_norm(jnp.asarray(a4), hard, token_valid=None if tv is None
                                      else jnp.asarray(tv))
            got = SG.attn_diff_norm(torch.from_numpy(a4), hard, token_valid=None if tv is None
                                    else torch.from_numpy(tv))
            _close(got, want, 1e-5)
    lists = ([torch.from_numpy(o)], [torch.from_numpy(e)]), ([jnp.asarray(o)], [jnp.asarray(e)])
    # scalar differences of terms of order 1 (centroids of order 4): absolute
    for name in ("fix_shapes_l1", "fix_sizes", "position_deltas"):
        got, want = getattr(SG, name)(*lists[0]), getattr(JSG, name)(*lists[1])
        assert abs(float(got) - float(want)) <= 1e-5


@jax.jit
def _silhouette_value_and_grad(maps, feats, ref, ori_f, transform, valid):
    """JAX's silhouette loss and its gradients to the edit maps and tap,
    compiled once for every transform (passed traced, as JAX's loop does)."""
    def loss(m, f):
        return JSG.silhouette_loss(m, ref, ori_f, f, 0.8, *transform, token_valid=valid)

    return jax.value_and_grad(loss, argnums=(0, 1))(maps, feats)


@pytest.mark.parametrize("transform", [(15.0, 1.2, 0.9, -0.05, 0.1), (0.0, 1.0, 1.0, 0.2, 0.0),
                                       (-40.0, 0.7, 1.3, 0.0, -0.25)])
def test_silhouette_loss_and_gradients_match_jax(transform):
    edit = [_maps(3), _maps(4, side=4)]
    ref = [_maps(5), _maps(6, side=4)]
    rng = np.random.default_rng(7)
    ori_f, edit_f = (rng.normal(size=(1, 16, 8, 8)).astype(np.float32) for _ in range(2))
    valid = np.array([1, 1, 0], bool)

    want, wgrad = _silhouette_value_and_grad(
        [jnp.asarray(m) for m in edit], jnp.asarray(edit_f), [jnp.asarray(r) for r in ref],
        jnp.asarray(ori_f), jnp.asarray(transform, jnp.float32), jnp.asarray(valid))
    maps = [torch.from_numpy(m).requires_grad_() for m in edit]
    feats = torch.from_numpy(edit_f).requires_grad_()
    got = SG.silhouette_loss(maps, [torch.from_numpy(r) for r in ref], torch.from_numpy(ori_f),
                             feats, 0.8, *transform, token_valid=torch.from_numpy(valid))
    _close(got, want, 1e-5)
    grads = torch.autograd.grad(got, maps + [feats])
    for g, w in zip(grads, list(wgrad[0]) + [wgrad[1]]):
        assert np.abs(np.asarray(w)).max() > 0
        _close(g, w, 1e-4)


def test_gates_steps_and_token_select_match_jax(pipes):
    for n in (4, 16, 50, 51):
        for sched in ("ddpm", "ddim"):
            assert np.array_equal(SG.guidance_gates(n, sched), JSG.guidance_gates(n, sched))
    for tr in ((0, 1, 1, 0, 0), (0, 1, 1, 1, 1), (5, 1, 1, 1, 1)):
        assert SG._ref_transform_gate(*tr) == JSG._ref_transform_gate(*tr)
    jsched, sched = JSchedule.create(num_inference_steps=10), DDIMSchedule.create(
        num_inference_steps=10)
    rng = np.random.default_rng(8)
    x, eps = (rng.normal(size=(1, 8, 8, 4)).astype(np.float32) for _ in range(2))
    key = jax.random.key(3)
    z = torch.from_numpy(np.array(jax.random.normal(key, x.shape, jnp.float32)))
    for t in (901, 501, 1):
        want = JSG.ddpm_step(jsched, jnp.asarray(eps), jnp.int32(t), jnp.asarray(x), key)
        _close(SG.ddpm_step(sched, torch.from_numpy(eps), t, torch.from_numpy(x), z), want, 1e-6)
    _, jpipe, tpipe = pipes
    for prompt, obj in (("a photo of a red cat", "red cat"), ("a dog", "cat"), ("cat cat", "cat")):
        assert np.array_equal(SG.SelfGuidance(tpipe).token_select(prompt, obj),
                              JSG.SelfGuidance(jpipe).token_select(prompt, obj))


def test_sow_pass_matches_jax(pipes):
    cfg, jpipe, tpipe = pipes
    rng = np.random.default_rng(9)
    lat = rng.normal(size=(2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
    prompt = "a photo of a red cat"
    ctx2 = np.concatenate([np.asarray(jpipe.encode_text([" "])),
                           np.asarray(jpipe.encode_text([prompt]))])
    jsg = JSG.SelfGuidance(jpipe)
    sel = jsg.token_select(prompt, "red cat")
    eps2, maps, feat = jax.jit(jsg._apply_sow)(jpipe.params, jnp.asarray(lat), jnp.int32(401),
                                               jnp.asarray(ctx2), jnp.asarray(sel))
    g_eps2, g_maps, g_feat = SG.SelfGuidance(tpipe).apply_sow(
        torch.from_numpy(lat), 401, torch.from_numpy(ctx2), torch.from_numpy(sel))
    _close(g_eps2, eps2, 2e-4)
    assert len(g_maps) == len(maps) == 9
    for g, w in zip(g_maps, maps):
        _close(g, w, 2e-4)
    _close(g_feat.permute(0, 2, 3, 1), feat, 2e-4)


def jax_draws(seed, steps, shape):
    """JAX's draws of the guided loop: per step the original stream's, then
    the edit stream's."""
    rng = jax.random.key(seed)
    out = np.zeros((steps, 2) + shape, np.float32)
    for i in range(steps):
        rng, r_ori, r_edit = jax.random.split(rng, 3)
        out[i, 0] = np.asarray(jax.random.normal(r_ori, shape, jnp.float32))
        out[i, 1] = np.asarray(jax.random.normal(r_edit, shape, jnp.float32))
    return torch.from_numpy(out)


def test_self_guidance_edit_matches_jax(pipes):
    cfg, jpipe, tpipe = pipes
    img = np.random.default_rng(10).integers(0, 255, (SIDE, SIDE, 3), dtype=np.uint8)
    seed, prompt = 3, "a photo of a red cat"
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = JSG.SelfGuidance(jpipe).edit(img, prompt, "red cat", EDIT_PARAM, steps=STEPS,
                                        seed=seed)
    noise = jax_draws(seed, STEPS, (1, cfg.latent_height, cfg.latent_width, 4))
    grads = []
    orig = torch.autograd.grad

    def spy(outputs, inputs, *a, **k):
        out = orig(outputs, inputs, *a, **k)
        grads.append(out[0].detach().clone())
        return out

    torch.autograd.grad = spy
    try:
        got = SG.SelfGuidance(tpipe).edit(img, prompt, "red cat", EDIT_PARAM, steps=STEPS,
                                          noise=noise)
    finally:
        torch.autograd.grad = orig
    assert got.shape == (SIDE, SIDE, 3) and got.dtype == np.uint8
    assert list(SG.guidance_gates(STEPS)) == [1, 1, 1, 0] and len(grads) == 3
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1
