"""The port's DiffusionHandles baseline
(`freefine_tpu_torch.baselines.diffusion_handles`) against the JAX
package's, on `tiny_pipeline_config` with the weights carried across.

  * bit for bit: `process_correspondences` (multiplicities, padding with
    index `grid`, truncation at `max_pts`, no pairs) and the foreground
    gather at the padding rows (JAX's gather clamps them; the port clamps
    explicitly); `geobench_dh_depth` against the eval driver's lines;
  * within 1e-6 of max |ref|: both losses and their gradients to the taps;
    the taps' bilinear resize against `jax.image.resize`;
  * within 2e-4 of max |ref|: `null_text_invert` (2 steps, 2 iterations)
    on the inputs JAX's own edit passed it, and the guided pass's latent
    gradient against `jax.grad`;
  * within 1e-6 of max |ref|: both losses' gradients at an exact zero
    residual, where `jnp.abs`'s gradient is +1 (ROADMAP C13);
  * within 2e-3 absolute: the final latents of the whole tiny edit
    (`DiffusionHandles.edit`, 2 steps, 2 null-text iterations, 2 latent
    steps, guidance through step 1, the protocol's loss weights), uint8
    images within 1.  The 5-channel
    UNet (SD-2-depth's input) is in `test_torch_diffusion_handles_depth.py`.

JAX compiles each of its loops once: one JAX edit per pipe, whose
null-text inversion's inputs and outputs are kept for the inversion test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.baselines import diffusion_handles as JDH
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch.baselines import diffusion_handles as DH
from freefine_tpu_torch.baselines.eval import geobench_dh_depth
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_bggen import _capture
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

EDIT_PARAM = [0.1, -0.05, 0, 0, 0, 10, 1.1, 1.1, 1]
# the protocol's loss weights (foreground 1.5, background 1.25); the guided
# pass starts on the recorded latent, where each unmoved pair's L1 residual
# is exactly 0 (ROADMAP C13)
EDIT_KW = dict(prompt="a photo", steps=2, num_optsteps=2, nti_iters=2, guidance_max_step=1)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def make_pipes(mods, cfg, jcfg):
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return jpipe, tpipe


def edit_case(h, w, seed=3):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    depth = rng.uniform(2.0, 6.0, (h, w)).astype(np.float32)
    mask = np.zeros((h, w), np.uint8)
    mask[16:32, 16:32] = 255
    mask[28:36, 24:30] = 255
    return img, depth, mask


def run_edits(jpipe, tpipe):
    """JAX's edit and the port's on the same case -> {"jax", "port": final
    latent and image; "nti": JAX's null-text inversion's (args, outputs)}."""
    h, w = jpipe.config.height, jpipe.config.width
    img, depth, mask = edit_case(h, w)
    out = {"nti": []}
    orig = JDH.null_text_invert

    def keep(*args, **kw):
        res = orig(*args, **kw)
        out["nti"].append((args, kw, res))
        return res

    JDH.null_text_invert = keep
    try:
        for name, pipe, mod, to_np in (("jax", jpipe, JDH, np.asarray),
                                       ("port", tpipe, DH, lambda a: a.numpy())):
            store = {}
            _capture(pipe, store, to_np)
            res = mod.DiffusionHandles(pipe).edit(img, depth, mask, EDIT_PARAM, **EDIT_KW)
            out[name] = (store["lat"], np.asarray(res))
    finally:
        JDH.null_text_invert = orig
    return out


def check_nti(tpipe, edits):
    """The port's null-text inversion on the inputs JAX's edit passed its
    own: the embeddings and the trajectory within 2e-4 of max |ref|."""
    (args, kw, (want_us, want_traj)), = edits["nti"]
    _, latent, cond_ctx, steps = args
    depth = kw.get("depth_ch")
    got_us, got_traj = DH.null_text_invert(
        tpipe, torch.from_numpy(np.asarray(latent)), torch.from_numpy(np.asarray(cond_ctx)),
        steps, kw["guidance_scale"], kw["iters"],
        depth_ch=None if depth is None else torch.from_numpy(np.asarray(depth)))
    assert got_us.shape == (steps, 1, 77, tpipe.config.unet.cross_attention_dim)
    # the embeddings moved off "" (the gradient is not zero)
    assert np.abs(np.asarray(want_us)[0] - np.asarray(want_us)[1]).max() > 0
    _close(got_us, want_us, 2e-4)
    _close(got_traj, want_traj, 2e-4)


def check_edit(edits, shape):
    (got_lat, got_img), (want_lat, want_img) = edits["port"], edits["jax"]
    assert got_img.shape == shape and got_img.dtype == np.uint8
    assert np.isfinite(got_lat).all()
    np.testing.assert_allclose(got_lat, want_lat, atol=2e-3, rtol=0)
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1


def guided_gradient(jpipe, tpipe, seed=5):
    """One guided-pass gradient at step 0's timestep: the port's
    `guidance_loss` and its latent gradient against JAX's loss built from
    the same pieces (`_unet`, `_tap`, the losses) under `jax.grad`."""
    cfg = tpipe.config
    g = cfg.latent_height
    h = cfg.height
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(1, g, g, 4)).astype(np.float32)
    z_orig = rng.normal(size=(1, g, g, 4)).astype(np.float32)
    img, d, mask = edit_case(h, cfg.width)
    corr_map = np.asarray(JDH.compute_correspondence(d, mask > 0, EDIT_PARAM))
    corr = JDH.process_correspondences(corr_map, h, grid=g)
    assert (corr["fg_valid"] > 1).any()
    ctx = np.asarray(jpipe.encode_text(["a photo"]))
    fgw = np.array([45.0, 45.0, 45.0], np.float32) * np.float32(2.5)
    bgw = np.array([37.5, 37.5, 37.5], np.float32) * np.float32(1.25)
    t = 981
    jdh = JDH.DiffusionHandles(jpipe)

    def jloss(zz):
        _, feats = jdh._unet(jpipe.params, zz, t, jnp.asarray(ctx), None, True)
        acts = jdh._tap(feats)
        _, feats_o = jdh._unet(jpipe.params, jnp.asarray(z_orig), t, jnp.asarray(ctx), None,
                               True)
        acts_o = [jax.lax.stop_gradient(a) for a in jdh._tap(feats_o)]
        loss = jnp.float32(0.0)
        for li in range(3):
            loss = loss + fgw[li] * JDH.foreground_loss(
                acts[li], acts_o[li], corr["fg_orig"], corr["fg_trans"], corr["fg_valid"])
            loss = loss + bgw[li] * JDH.background_loss(acts[li], acts_o[li], corr["bg_orig"],
                                                        corr["bg_trans"])
        return loss

    want, want_grad = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(z))
    dh = DH.DiffusionHandles(tpipe)
    tctx = torch.from_numpy(ctx)
    with torch.no_grad():
        _, feats_o = dh._unet(torch.from_numpy(z_orig), t, tctx, None, True)
    acts_o = dh._tap(feats_o)
    tcorr = {k: torch.from_numpy(v) for k, v in corr.items()}
    zz = torch.from_numpy(z).requires_grad_()
    loss = dh.guidance_loss(zz, t, tctx, None, acts_o, tcorr, fgw, bgw)
    grad, = torch.autograd.grad(loss, zz)
    _close(loss, want, 2e-4)
    assert np.abs(np.asarray(want_grad)).max() > 0
    _close(grad, want_grad, 2e-4)


# -- module fixtures -----------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    """The tiny config's JAX and port pipelines on the same weights."""
    cfg, mods = tiny_modules(83)
    jpipe, tpipe = make_pipes(mods, cfg, jax_tiny_config())
    return cfg, jpipe, tpipe


@pytest.fixture(scope="module")
def edits(pipes):
    _, jpipe, tpipe = pipes
    return run_edits(jpipe, tpipe)


# -- tests ---------------------------------------------------------------------


def _corr_map(img_res, seed):
    """A dense correspondence with NaN outside a blob, targets past the
    image on some pixels, and a scale that maps several fine pixels to one
    coarse pair."""
    rng = np.random.default_rng(seed)
    c = np.full((img_res, img_res, 2), np.nan)
    ys, xs = np.mgrid[10:40, 12:44]
    c[ys, xs, 0] = ys * 1.3 + 5 + rng.uniform(-2, 2, ys.shape)
    c[ys, xs, 1] = xs * 1.1 + 20 + rng.uniform(-2, 2, xs.shape)
    return c


@pytest.mark.parametrize("img_res,grid,max_pts", [(64, 8, 4096), (64, 16, 4096), (64, 16, 37)])
def test_process_correspondences_matches_jax(img_res, grid, max_pts):
    c = _corr_map(img_res, grid + max_pts)
    assert (c[..., 1] >= img_res).any()              # some targets leave the image
    want = JDH.process_correspondences(c, img_res, grid=grid, max_pts=max_pts)
    got = DH.process_correspondences(c, img_res, grid=grid, max_pts=max_pts)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], np.asarray(want[k])), k
    v = got["fg_valid"]
    assert (v > 1).any() and (v[-1] == 0 or max_pts < 100)
    assert (got["fg_orig"][v == 0] == grid).all()
    empty = DH.process_correspondences(np.full((64, 64, 2), np.nan), 64, grid=8, max_pts=5)
    want_empty = JDH.process_correspondences(np.full((64, 64, 2), np.nan), 64, grid=8, max_pts=5)
    for k in want_empty:
        assert np.array_equal(empty[k], np.asarray(want_empty[k])), k


def _acts(seed, g=8, c=6):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(g, g, c)).astype(np.float32) for _ in range(2)]


def test_losses_gather_and_gradients_match_jax():
    act, act_o = _acts(7)
    corr = DH.process_correspondences(_corr_map(64, 1), 64, grid=8, max_pts=128)
    assert (corr["fg_valid"] == 0).any()              # padding rows index `grid`
    tc = {k: torch.from_numpy(v) for k, v in corr.items()}
    # the padding rows' gather: JAX clamps index `grid` to the last cell
    want_rows = jnp.asarray(act_o)[corr["fg_orig"][:, 0], corr["fg_orig"][:, 1]]
    assert np.array_equal(DH._gather_clamped(torch.from_numpy(act_o), tc["fg_orig"]).numpy(),
                          np.asarray(want_rows))

    def jfg(a):
        return JDH.foreground_loss(a, jnp.asarray(act_o), corr["fg_orig"], corr["fg_trans"],
                                   corr["fg_valid"])

    def jbg(a):
        return JDH.background_loss(a, jnp.asarray(act_o), corr["bg_orig"], corr["bg_trans"])

    for jfn, tfn in ((jfg, lambda a: DH.foreground_loss(
            a, torch.from_numpy(act_o), tc["fg_orig"], tc["fg_trans"], tc["fg_valid"])),
                     (jbg, lambda a: DH.background_loss(
            a, torch.from_numpy(act_o), tc["bg_orig"], tc["bg_trans"]))):
        want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(act))
        a = torch.from_numpy(act).requires_grad_()
        got = tfn(a)
        got_grad, = torch.autograd.grad(got, a)
        _close(got, want, 1e-6)
        assert np.abs(np.asarray(want_grad)).max() > 0
        _close(got_grad, want_grad, 1e-6)


def test_losses_at_a_zero_residual_push_as_jax():
    """The guided pass's first gradient compares each tap with its own
    record: every unmoved pair's residual, and the background averages',
    is exactly 0, where `jnp.abs`'s gradient is +1 (`torch.abs`'s 0).  Both
    losses' gradients there (30 of 40 pairs unmoved, 5 padding rows)
    against `jax.grad` within 1e-6 of max |ref|."""
    act, _ = _acts(8)
    rng = np.random.default_rng(10)
    fg_orig = rng.integers(0, 8, (40, 2)).astype(np.int32)
    fg_trans = fg_orig.copy()
    fg_trans[:10] = rng.integers(0, 8, (10, 2))
    fg_valid = rng.integers(1, 4, 40).astype(np.float32)
    fg_orig[-5:], fg_trans[-5:], fg_valid[-5:] = 8, 8, 0.0
    bg = (rng.random((8, 8)) > 0.5).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(o=fg_orig, t=fg_trans, v=fg_valid, bg=bg).items()}
    pairs = (
        (lambda a: JDH.foreground_loss(a, jnp.asarray(act), fg_orig, fg_trans, fg_valid),
         lambda a: DH.foreground_loss(a, torch.from_numpy(act), t["o"], t["t"], t["v"])),
        (lambda a: JDH.background_loss(a, jnp.asarray(act), bg, bg),
         lambda a: DH.background_loss(a, torch.from_numpy(act), t["bg"], t["bg"])))
    for jfn, tfn in pairs:
        want = jax.grad(jfn)(jnp.asarray(act))
        a = torch.from_numpy(act).requires_grad_()
        got, = torch.autograd.grad(tfn(a), a)
        assert np.abs(np.asarray(want)).max() > 0
        _close(got, want, 1e-6)


def test_taps_resize_like_jax(pipes):
    """`_tap`'s bilinear upsample of the decoder taps to the grid against
    `jax.image.resize` (a tap already at the grid passes unchanged)."""
    rng = np.random.default_rng(9)
    feats = [rng.normal(size=(1, s, s, c)).astype(np.float32) for s, c in
             ((2, 5), (4, 3), (8, 4), (8, 2))]
    dh = DH.DiffusionHandles(pipes[2])
    assert dh.grid == 8
    got = dh._tap([torch.from_numpy(f) for f in feats])
    for g, f in zip(got, feats[-3:]):
        want = jax.image.resize(jnp.asarray(f), (1, 8, 8, f.shape[-1]), "bilinear")[0]
        _close(g, want, 1e-6)
    assert np.array_equal(got[-1].numpy(), feats[-1][0])


def test_geobench_depth_matches_the_driver():
    rng = np.random.default_rng(12)
    raw = rng.uniform(0.5, 9.0, (32, 40)).astype(np.float32)
    mask = np.zeros((32, 40), np.uint8)
    mask[8:20, 10:30] = 255
    # eval.py's lines for diffusion_handles, applied to the same estimate
    d = raw / (raw.max() + 1e-8) + 1e-2
    d[d > 0.95] = 1.0
    d[mask > 127] = 0.5
    got = geobench_dh_depth(raw, mask)
    assert got.dtype == np.float32 and np.array_equal(got, d)
    assert (got == 1.0).any() and (got == 0.5).sum() == 12 * 20


def test_null_text_invert_matches_jax(pipes, edits):
    check_nti(pipes[2], edits)


def test_guided_latent_gradient_matches_jax(pipes):
    _, jpipe, tpipe = pipes
    guided_gradient(jpipe, tpipe)


def test_diffusion_handles_edit_matches_jax(pipes, edits):
    cfg = pipes[0]
    check_edit(edits, (cfg.height, cfg.width, 3))
