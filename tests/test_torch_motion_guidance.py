"""The port's MotionGuidance baseline
(`freefine_tpu_torch.baselines.motion_guidance`) against the JAX
package's: `gen_flow` (equal), `warp` and its gradients, `occlusion_mask`
on `gen_flow`'s translate, rotate and scale flows (bit-equal: it keeps the
pixels whose self-warp gradient is exactly 0), `make_flow_loss`'s value and
gradient through the full-width RAFT at `iters` 2, the gradient through
the tiny VAE's `decode`, and one whole `MotionGuidance.edit` on
`tiny_pipeline_config` (64^2; steps 2, recursion 2; weights carried
through `freefine_tpu.weights.convert_*` and `convert_raft`; JAX's own
draws replayed: the `split` chain of its sampler, z_T then per recursive
step the pinning noise and the re-noise).

The whole edit is held at guidance weight 0: its 4 energy gradients are
taken, clipped and added at weight 0, so the sampler (CFG, pinning,
recursion, re-noise, DDIM) is held exactly, and the gradient's pieces are
held one by one (RAFT in tests/test_torch_raft.py; the flow loss, decode
and, in the other tests, the UNet).  At the protocol's weight 300 no
tolerance holds the two frameworks' edits together: the L1 energy's
gradient is discontinuous (where a flow equals its target), so JAX's own
gradient moves by 1.2 % of its largest entry when the decoded image moves
by 8.5e-6, the port's distance from JAX's decode, and the weight and the
clip of 200 carry that into latents 0.5 apart after 4 gradients.

Tolerances: `warp`, the flow loss and the decode's gradient within 1e-4 of
max |ref| (the loss and its gradient against `jax.value_and_grad` in
float64, as tests/test_torch_raft.py holds RAFT's gradient); the edit's final latents within
2e-3 absolute (float32 on both sides; summation order), uint8 images
within 1.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.baselines import motion_guidance as JMG
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.models import raft as JR
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch.baselines import motion_guidance as MG
from freefine_tpu_torch.models import raft as R
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_raft import assert_close, np_state, randomize
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

TOL = 1e-4
SIDE, ITERS = 64, 2
STEPS, RECURSIVE = 2, 2
# GeoBench edit_params (dx, dy, dz, rx, ry, rz, scale) of each flow kind
EDITS = {"translate": (7, -3, 0, 0, 0, 0, 1), "rotate": (0, 0, 0, 0, 0, 25, 1),
         "scale": (0, 0, 0, 0, 0, 0, 1.3)}


def object_mask(side=SIDE):
    m = np.zeros((side, side), np.uint8)
    m[18:44, 14:40] = 255
    m[30:50, 34:46] = 255
    return m


@pytest.fixture(scope="module")
def raft():
    model = randomize(R.RAFT(R.RAFTConfig(iters=ITERS), device="cpu"), 3).eval()
    model.requires_grad_(False)
    jmodel = JR.RAFT(JR.RAFTConfig(iters=ITERS))
    z = jax.ShapeDtypeStruct((1, SIDE, SIDE, 3), jnp.float32)
    tmpl = jax.eval_shape(functools.partial(jmodel.init, iters=1), jax.random.key(0), z, z)
    return model, jmodel, JR.convert_raft(tmpl, np_state(model))


@pytest.fixture(scope="module")
def pipes():
    """The tiny config's JAX and port pipelines on the same weights."""
    cfg, mods = tiny_modules(43)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


@pytest.mark.parametrize("kind", [*EDITS, "none"])
def test_gen_flow_matches_jax(kind):
    p = EDITS.get(kind, (0, 0, 0, 0, 0, 0, 1))
    want = JMG.gen_flow(p, object_mask())
    got = MG.gen_flow(p, object_mask())
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (np.abs(got).sum() > 0) == (kind != "none")


def test_warp_and_its_gradients_match_jax():
    rng = np.random.default_rng(0)
    im = rng.random((2, 20, 24, 3)).astype(np.float32)
    flow = (6 * rng.standard_normal((2, 20, 24, 2))).astype(np.float32)
    flow[:, ::4] = np.round(flow[:, ::4])
    cot = rng.standard_normal((2, 20, 24, 3)).astype(np.float32)
    want = JMG.warp(jnp.asarray(im), jnp.asarray(flow))
    wgrad = jax.grad(lambda a, f: jnp.sum(JMG.warp(a, f) * cot), argnums=(0, 1))(
        jnp.asarray(im), jnp.asarray(flow))
    a, f = (torch.from_numpy(x).requires_grad_() for x in (im, flow))
    got = MG.warp(a, f)
    assert_close(got, want, TOL)
    for g, w in zip(torch.autograd.grad(torch.sum(got * torch.from_numpy(cot)), (a, f)), wgrad):
        assert_close(g, w, TOL)


@pytest.mark.parametrize("kind", list(EDITS))
def test_occlusion_mask_is_bit_equal(kind):
    flow = MG.gen_flow(EDITS[kind], object_mask())
    want = np.asarray(JMG.occlusion_mask(jnp.asarray(flow)))
    got = MG.occlusion_mask(torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape == (1, SIDE, SIDE, 1)
    assert 0 < (got == 0).sum() < got.size
    assert np.array_equal(got, want)


def test_flow_loss_value_and_gradient_match_jax(raft):
    model, jmodel, params = raft
    rng = np.random.default_rng(1)
    pred = (2 * rng.random((1, SIDE, SIDE, 3)) - 1).astype(np.float32)
    src = (2 * rng.random((1, SIDE, SIDE, 3)) - 1).astype(np.float32)
    flow = MG.gen_flow(EDITS["rotate"], object_mask())
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
        j64 = JR.RAFT(JR.RAFTConfig(iters=ITERS, dtype=jnp.float64))
        loss64 = JMG.make_flow_loss(lambda a, b: j64.apply(p64, a, b),
                                    jnp.asarray(flow, jnp.float64))
        want, wgrad = jax.jit(jax.value_and_grad(loss64))(jnp.asarray(pred, jnp.float64),
                                                          jnp.asarray(src, jnp.float64))
        want, wgrad = float(want), np.asarray(wgrad)
    x = torch.from_numpy(pred).requires_grad_()
    loss = MG.make_flow_loss(model, torch.from_numpy(flow))(x, torch.from_numpy(src))
    assert abs(float(loss.detach()) - want) <= TOL * abs(want)
    g, = torch.autograd.grad(loss, x)
    assert np.abs(wgrad).max() > 0
    assert_close(g, wgrad, TOL)


def jax_draws(seed, shape):
    """The draws of JAX's sampler: z_T, then [steps, recursive, 2, ...]."""
    rng = jax.random.key(seed)
    rng, r0 = jax.random.split(rng)
    z = np.array(jax.random.normal(r0, shape, jnp.float32))
    draws = np.zeros((STEPS, RECURSIVE, 2) + shape, np.float32)
    for i in range(STEPS):
        for j in range(RECURSIVE):
            rng, r1, r2 = jax.random.split(rng, 3)
            draws[i, j, 0] = np.asarray(jax.random.normal(r1, shape, jnp.float32))
            draws[i, j, 1] = np.asarray(jax.random.normal(r2, shape, jnp.float32))
    return torch.from_numpy(z), torch.from_numpy(draws)


def _capture(pipe, store, to_np):
    orig = pipe.latent_to_image

    def cap(lat):
        store["lat"] = to_np(lat)
        return orig(lat)

    pipe.latent_to_image = cap


def test_motion_guidance_edit_matches_jax(raft, pipes):
    model, jmodel, params = raft
    cfg, jpipe, tpipe = pipes
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (SIDE, SIDE, 3), dtype=np.uint8)
    mask = object_mask()
    edit_mask = np.full((SIDE, SIDE), 255, np.uint8)
    edit_mask[10:56, 8:54] = 0   # pinned to the source outside the edit region
    seed = 4
    kw = dict(steps=STEPS, num_recursive=RECURSIVE, edit_mask=edit_mask, seed=seed,
              guidance_weight=0.0)
    jstore, tstore = {}, {}
    for pipe, store, to_np in ((jpipe, jstore, np.asarray), (tpipe, tstore, lambda x: x.numpy())):
        _capture(pipe, store, to_np)
    want = JMG.MotionGuidance(jpipe, jmodel, params).edit(img, EDITS["translate"], mask,
                                                           "a cat", **kw)
    noise = jax_draws(seed, (1, cfg.latent_height, cfg.latent_width, 4))
    got = MG.MotionGuidance(tpipe, model).edit(img, EDITS["translate"], mask, "a cat",
                                               noise=noise, **kw)
    assert got.shape == (SIDE, SIDE, 3) and got.dtype == np.uint8
    assert np.isfinite(tstore["lat"]).all() and np.abs(tstore["lat"]).max() > 0
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1


def test_decode_gradient_matches_jax(pipes):
    cfg, jpipe, tpipe = pipes
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((1, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
    cot = rng.standard_normal((1, SIDE, SIDE, 3)).astype(np.float32)
    decode = functools.partial(jpipe.vae.apply, jpipe.params["vae"], method=jpipe.vae.decode)
    want = np.asarray(jax.jit(lambda x, c: jax.vjp(decode, x)[1](c)[0])(jnp.asarray(x0),
                                                                        jnp.asarray(cot)))
    x = torch.from_numpy(x0).requires_grad_()
    got, = torch.autograd.grad(tpipe.vae.decode(x), x, torch.from_numpy(cot))
    assert_close(got, want, TOL)


def test_guided_edit_runs_and_its_gradient_is_live(raft, pipes):
    """At the protocol's weight the port's edit is finite, moves away from
    the unguided edit, and each energy gradient is non-zero inside the
    unpinned region."""
    model = raft[0]
    cfg, _, tpipe = pipes
    img = np.random.default_rng(2).integers(0, 255, (SIDE, SIDE, 3), dtype=np.uint8)
    grads = []
    mg = MG.MotionGuidance(tpipe, model)
    orig = torch.autograd.grad

    def spy(outputs, inputs, *a, **k):
        out = orig(outputs, inputs, *a, **k)
        if out[0].shape[-1] == 4:  # the energy's, not the occlusion mask's
            grads.append(out[0].detach().clone())
        return out

    noise = jax_draws(4, (1, cfg.latent_height, cfg.latent_width, 4))
    kw = dict(steps=STEPS, num_recursive=RECURSIVE, noise=noise)
    plain = mg.edit(img, EDITS["translate"], object_mask(), "a cat", guidance_weight=0.0, **kw)
    torch.autograd.grad = spy
    try:
        guided = mg.edit(img, EDITS["translate"], object_mask(), "a cat", **kw)
    finally:
        torch.autograd.grad = orig
    assert len(grads) == STEPS * RECURSIVE
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    assert np.abs(guided.astype(int) - plain.astype(int)).max() > 1


def test_motion_guidance_needs_raft_on_the_pipe_device(pipes):
    tpipe = pipes[2]
    with pytest.raises(ValueError, match="RAFT on"):
        MG.MotionGuidance(tpipe, R.RAFT(device="meta"))
