"""The port's GeoDiffuser baseline (`freefine_tpu_torch.baselines.geo_diffuser`)
and the geodiff attention mode against the JAX package's.

  * `warp_coord_pyramid`, `warp_mask` and `adaptive_removal_schedule`
    equal; `_sum_geodiff_losses` within 1e-6 of max |ref| on recorded
    losses (JAX's nested intermediates, the port's by module path);
  * `_coord_distance_grid`, `_warp_feature_map` and `_box_smooth_tokens`
    within 1e-6 of max |ref|; `_interpolate_from_mask` within 1e-6 on an
    object whose positions tie in distance from most queries (JAX's
    `lax.top_k` takes the lower index first; the port sorts stably);
  * `geodiff_attention`, self and cross, with every loss: the output and
    each loss within 2e-4 of max |ref|, and each loss's gradient to the
    queries and keys against `jax.grad` within 2e-4 of max |ref| (the
    base stream's row of the port's gradient is 0, as JAX's is: every
    path from the losses to it is cut);
  * the tiny UNet (`tiny_pipeline_config`) in geodiff mode over [base,
    edit]: eps within 2e-4, the weighted loss within 2e-4 and its gradient
    to the edit latent against `jax.grad` within 2e-4 of max |ref|;
  * `GeoDiffuser.edit` (64^2, 4 steps at GeoBench's weights, lr 0.03; the
    adaptive controller on): final latents within 2e-3 absolute, uint8
    images within 1.  DDIM with eta 0 draws no noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.baselines import geo_diffuser as JGD
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.edit import build_mask_pyramid as j_build_mask_pyramid
from freefine_tpu.ops import attention as JA
from freefine_tpu.ops.geometry import edit_affine_matrix
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch.baselines import geo_diffuser as GD
from freefine_tpu_torch.edit import EditState, build_mask_pyramid
from freefine_tpu_torch.ops import attention as A
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_bggen import _capture
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

SIDE, STEPS = 64, 4
EDIT_PARAM = (9, -5, 0, 0, 0, 20, 1.1, 1.1, 1)


@pytest.fixture(scope="module")
def pipes():
    """The tiny config's JAX and port pipelines on the same weights."""
    cfg, mods = tiny_modules(79)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _object(side=SIDE):
    m = np.zeros((side, side), np.float32)
    m[18:40, 14:34] = 1.0
    m[30:46, 28:40] = 1.0
    return m


def _matrix(mask, p=EDIT_PARAM):
    from freefine_tpu.ops.geometry import mask_bbox_center
    return edit_affine_matrix(mask_bbox_center(mask), p[0], p[1], p[5], p[6], p[7])


def test_warps_schedule_and_loss_sum_match_jax():
    m = _object()
    mat = _matrix(m)
    assert np.array_equal(GD.warp_mask(m, mat), JGD.warp_mask(m, mat))
    want = JGD.warp_coord_pyramid(mat, 8, 8)
    got = GD.warp_coord_pyramid(mat, 8, 8)
    assert set(got) == set(want) == {64, 16, 4, 1}
    for s in got:
        assert np.array_equal(got[s].numpy(), np.asarray(want[s]))
    for steps in (4, 50):
        for r in (-1.5, -0.7):
            for g, w in zip(GD.adaptive_removal_schedule(steps, removal_in=r),
                            JGD.adaptive_removal_schedule(steps, removal_in=r)):
                assert np.array_equal(g, w)
    rng = np.random.default_rng(1)
    names = ["sim", "movement", "smooth", "removal", "amodal"]
    paths = [("up_blocks_1_attentions_0", "transformer_blocks_0", "attn1"),
             ("up_blocks_1_attentions_0", "transformer_blocks_0", "attn2"),
             ("up_blocks_3_attentions_2", "transformer_blocks_0", "attn1")]
    jtree, flat = {}, {}
    for path in paths:
        node = jtree
        for part in path:
            node = node.setdefault(part, {})
        for name in names:
            v = np.float32(rng.normal())
            node[f"geodiff_{name}"] = (jnp.float32(v),)
            flat[("up_blocks", path[0].split("_")[2], "attentions",
                  path[0].split("_")[4], "transformer_blocks", "0", path[2],
                  f"geodiff_{name}")] = [torch.tensor(v)]
    for mult in (1.0, 1.7):
        want = JGD._sum_geodiff_losses(jtree, removal_self_mult=jnp.float32(mult))
        got = GD._sum_geodiff_losses(flat, removal_self_mult=mult)
        for g, w in zip(got, want):
            _close(g, w, 1e-6)


def test_geodiff_helpers_match_jax():
    rng = np.random.default_rng(2)
    dist_w = np.asarray(JA._coord_distance_grid(8, 8))
    dist = A._coord_distance_grid(8, 8)
    _close(dist, dist_w, 1e-6)
    feats = rng.normal(size=(64, 12)).astype(np.float32)
    coords = (rng.random((8, 8, 2)) * 10 - 1).astype(np.float32)
    _close(A._warp_feature_map(torch.from_numpy(feats), torch.from_numpy(coords)),
           JA._warp_feature_map(jnp.asarray(feats), jnp.asarray(coords)), 1e-6)
    _close(A._box_smooth_tokens(torch.from_numpy(feats), 8, 8),
           JA._box_smooth_tokens(jnp.asarray(feats), 8, 8), 1e-6)
    # a ring of object positions: most queries see ties among them
    fg = np.zeros((8, 8), np.float32)
    fg[2, 2:6] = fg[5, 2:6] = fg[2:6, 2] = fg[2:6, 5] = 1.0
    fg = fg.reshape(-1)
    interp_w, w_w = JA._interpolate_from_mask(jnp.asarray(feats), jnp.asarray(fg),
                                              jnp.asarray(dist_w))
    interp, w = A._interpolate_from_mask(torch.from_numpy(feats), torch.from_numpy(fg), dist)
    _close(interp, interp_w, 1e-6)
    _close(w, w_w, 1e-6)
    d = dist_w * 256.0 + 1e5 * (1.0 - fg)[None]
    assert (np.sort(d, -1)[:, 3] == np.sort(d, -1)[:, 4]).sum() > 10  # ties at the 4th


def _attention_case(seed, is_cross, s=64, e=16, heads=2, sk=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, s, e)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk or s, e)).astype(np.float32) for _ in range(2))
    side = int(np.sqrt(s))
    ys, xs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    warp = np.stack([ys - 1.5 + 0.3 * xs / side, xs + 2.25], -1).astype(np.float32)
    m_obj = np.zeros(s, np.float32)
    m_obj[[9, 10, 17, 18, 19, 26]] = 1.0
    m_warp = np.zeros(s, np.float32)
    m_warp[[12, 13, 20, 21, 22, 29]] = 1.0
    m_amodal = np.zeros(s, np.float32)
    m_amodal[[4, 5, 11, 14, 28, 30, 36, 37]] = 1.0
    return q, k, v, heads, warp, m_obj, m_warp, m_amodal


@pytest.mark.parametrize("is_cross", [False, True])
def test_geodiff_attention_and_loss_gradients_match_jax(is_cross):
    q, k, v, heads, warp, m_obj, m_warp, m_amodal = _attention_case(3, is_cross,
                                                                   sk=12 if is_cross else None)
    fixed = [jnp.asarray(x) for x in (warp, m_obj, m_warp)]

    def jrun(qq, kk):
        return JA.geodiff_attention(qq, kk, jnp.asarray(v), heads, *fixed, jnp.float32(1.0),
                                    is_cross, True, True, m_amodal=jnp.asarray(m_amodal))

    want_out, want_losses = jrun(jnp.asarray(q), jnp.asarray(k))
    want_grads = jax.jit(jax.jacrev(lambda a, b: jrun(a, b)[1], argnums=(0, 1)))(
        jnp.asarray(q), jnp.asarray(k))
    tq, tk = (torch.from_numpy(x).requires_grad_() for x in (q, k))
    got_out, got_losses = A.geodiff_attention(
        tq, tk, torch.from_numpy(v), heads, *(torch.from_numpy(x) for x in (warp, m_obj, m_warp)),
        1.0, is_cross, True, True, m_amodal=torch.from_numpy(m_amodal))
    _close(got_out, want_out, 2e-4)
    assert sorted(got_losses) == sorted(want_losses) == sorted(
        ["sim", "movement", "smooth", "removal", "amodal"])
    for name, val in got_losses.items():
        _close(val, want_losses[name], 2e-4)
        wq, wk = want_grads[name]
        gq, gk = torch.autograd.grad(val, (tq, tk), allow_unused=True, retain_graph=True)
        gq = torch.zeros_like(tq) if gq is None else gq
        gk = torch.zeros_like(tk) if gk is None else gk
        assert np.abs(np.asarray(wq)).max() > 0 and not np.asarray(wq)[0].any()
        _close(gq, wq, 2e-4)
        if np.abs(np.asarray(wk)).max() > 0:
            _close(gk, wk, 2e-4)
        else:
            assert not gk.any()
    # the shared output without the gate: the live output alone
    plain, _ = A.geodiff_attention(tq, tk, torch.from_numpy(v), heads,
                                   *(torch.from_numpy(x) for x in (warp, m_obj, m_warp)), 0.0,
                                   is_cross, False, False)
    want_plain, _ = JA.geodiff_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                         *fixed, jnp.float32(0.0), is_cross, False, False)
    _close(plain, want_plain, 2e-4)


def _unet_inputs(cfg):
    m = _object()
    mat = _matrix(m)
    m_warp = GD.warp_mask(m, mat)
    ring = np.clip(np.asarray(GD.dilate(torch.from_numpy(m_warp), 2)) - m_warp, 0, 1)
    lh, lw = cfg.latent_height, cfg.latent_width
    jstate = JEditState(fg_ref=j_build_mask_pyramid(jnp.asarray(m), lh, lw),
                        fg_retain=j_build_mask_pyramid(jnp.asarray(m_warp), lh, lw),
                        local_region=j_build_mask_pyramid(jnp.asarray(ring), lh, lw),
                        warp_coords=JGD.warp_coord_pyramid(mat, lh, lw),
                        share_gate=jnp.float32(1.0))
    tstate = EditState(fg_ref=build_mask_pyramid(torch.from_numpy(m), lh, lw),
                       fg_retain=build_mask_pyramid(torch.from_numpy(m_warp), lh, lw),
                       local_region=build_mask_pyramid(torch.from_numpy(ring), lh, lw),
                       warp_coords=GD.warp_coord_pyramid(mat, lh, lw), share_gate=1.0)
    return jstate, tstate


def test_geodiff_unet_loss_and_latent_gradient_match_jax(pipes):
    cfg, jpipe, tpipe = pipes
    jstate, tstate = _unet_inputs(cfg)
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
    ctx = np.asarray(jpipe.encode_text([""]))
    ctx2 = np.concatenate([ctx, ctx])
    loss_seq = cfg.latent_height * cfg.latent_width // 4
    jcfg = JEditConfig(mode="geodiff", method=None, local_cfg=False, num_streams=2,
                       geodiff_loss_seq=loss_seq)

    @jax.jit
    def jrun(p, z):
        def f(z_edit):
            eps, inter = jpipe.unet.apply(p["unet"], jnp.concatenate([jnp.asarray(lat[:1]), z_edit]),
                                          jnp.int32(601), jnp.asarray(ctx2), edit_cfg=jcfg,
                                          edit_state=jstate, mutable=["intermediates"])
            total, removal = JGD._sum_geodiff_losses(inter, removal_self_mult=jnp.float32(1.3))
            return total, (eps, removal)
        return jax.value_and_grad(f, has_aux=True)(z)

    (want, (want_eps, want_rem)), want_grad = jrun(jpipe.params, jnp.asarray(lat[1:]))
    gd = GD.GeoDiffuser(tpipe)
    z = torch.from_numpy(lat[1:]).requires_grad_()
    with torch.enable_grad():
        eps, total, removal = gd._unet_losses(gd.edit_config(), torch.cat(
            [torch.from_numpy(lat[:1]), z]), 601, torch.from_numpy(ctx2), tstate, np.float32(1.3))
        grad, = torch.autograd.grad(total, z)
    _close(eps, want_eps, 2e-4)
    _close(total, want, 2e-4)
    _close(removal, want_rem, 2e-4)
    assert np.abs(np.asarray(want_grad)).max() > 0
    _close(grad, want_grad, 2e-4)


def test_geo_diffuser_edit_matches_jax(pipes):
    cfg, jpipe, tpipe = pipes
    img = np.random.default_rng(5).integers(0, 255, (SIDE, SIDE, 3), dtype=np.uint8)
    mask = (_object() * 255).astype(np.uint8)
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = JGD.GeoDiffuser(jpipe).edit(img, mask, EDIT_PARAM, steps=STEPS)
    got = GD.GeoDiffuser(tpipe).edit(img, mask, EDIT_PARAM, steps=STEPS)
    assert got.shape == (SIDE, SIDE, 3) and got.dtype == np.uint8
    assert np.isfinite(tstore["lat"]).all()
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1
