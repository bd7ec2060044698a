"""The port's DragDiffusion baseline
(`freefine_tpu_torch.baselines.drag_diffusion`) and the GeoBench pieces
of its protocol against the JAX package's, on `tiny_pipeline_config` with
the weights carried across.

  * LoRA: the adapted projections (128 on the tiny UNet, as on SD-1.5),
    JAX's factors carried across by `weights.lora_from_flax`, the merge
    W + (a @ b)^T (identity at init, bit for bit; within 1e-6 of max |ref|
    with b moved; the base weights untouched), and one step's loss and
    gradient to the factors against `jax.value_and_grad` within 2e-4 of
    max |ref| (at init, where every `a` gets an exact zero gradient on
    both sides, and after b moved);
  * `torch.optim.Adam` against `optax.adam` on given gradients (zeros
    among them) over 3 steps: each step's update within 1e-6 absolute
    (lr 5e-4; optax forms its bias corrections in float32, where
    1 - 0.999 is 1.3e-5 off), an entry with a zero gradient at the first
    step left exactly in place on both sides;
  * `sample_patch` (mode "nearest", coordinates past the border) within
    1e-6, `track_points` against JAX's `track_point` at the borders and on
    exact ties equal, the
    "nearest" mask resizes bit for bit;
  * `_drag_points_from_case` and `transform_coordinates` bit for bit;
  * `motion_loss` with a union mask and its latent gradient against the
    same terms of JAX's drag loop under `jax.value_and_grad`, within 2e-4
    of max |ref|, the anchor's x_prev_0 off zero and at an exact zero
    residual (ROADMAP C13), the anchor mask bit for bit;
  * the whole tiny `drag` (64^2, a LoRA of rank 2 trained 2 steps on
    JAX's initialisation and draws, 3 drag iterations, GeoBench's points
    and union mask): final latents within 2e-3 absolute, uint8 images
    within 1; the same with the loop stopped by its `done` rule at its
    first iteration (every handle within 2 pixels) and at its second
    (tracking brings them there).  The trained LoRA's change of each
    factor within 2e-2 of its max, on the entries whose gradients are
    not rounding noise (Adam's first steps are about lr times a
    gradient's sign).

JAX compiles its drag once (one JAX `DragDiffusion` per module, its
loops reused by the stopped drags).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from freefine_tpu.baselines import drag_diffusion as JDD
from freefine_tpu.baselines.eval import _drag_points_from_case as j_drag_points
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.metrics import md as JMD
from freefine_tpu.schedulers.ddim import DDIMSchedule as JSchedule
from freefine_tpu_torch.baselines import drag_diffusion as DD
from freefine_tpu_torch.baselines.eval import _drag_points_from_case
from freefine_tpu_torch.metrics import md as MD
from freefine_tpu_torch.ops.resize import resize
from freefine_tpu_torch.weights import lora_from_flax
from test_torch_bggen import _capture
from test_torch_diffusion_handles import make_pipes
from test_torch_weights import tiny_modules

torch.set_num_threads(2)

RANK, LORA_STEPS, LORA_LR, SEED = 2, 2, 5e-4, 42
DRAG_PARAM = (6, -4, 0, 0, 0, 0, 1)
PROMPT = "image of object"
DRAG_KW = dict(n_pix_step=3, max_points=32, seed=SEED)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def _mask(h, w):
    m = np.zeros((h, w), np.uint8)
    m[16:32, 18:36] = 255
    m[30:38, 22:28] = 255
    return m


def _union(mask):
    """GeoBench's drag mask: the object's mask and its target's (DRAG_PARAM
    moves it 6 right, 4 up), as float32."""
    return ((mask > 0) | (np.roll(mask, (-4, 6), axis=(0, 1)) > 0)).astype(np.float32)


def jax_lora_draws(seed, shape, steps):
    """JAX's `train_lora` draws: per step (t, noise) from key(seed + 1)."""
    rng = jax.random.key(seed + 1)
    out = []
    for _ in range(steps):
        rng, r = jax.random.split(rng)
        r_t, r_n = jax.random.split(r)
        t = int(jax.random.randint(r_t, (), 0, 1000))
        out.append((t, torch.from_numpy(np.array(jax.random.normal(r_n, shape, jnp.float32)))))
    return out


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(85)
    jpipe, tpipe = make_pipes(mods, cfg, jax_tiny_config())
    return cfg, jpipe, tpipe


@pytest.fixture(scope="module")
def drags(pipes):
    """JAX's `drag` with a LoRA trained inside it, and the port's: its LoRA
    trained by `train_lora` on JAX's initialisation and draws, then
    `drag(lora=...)`.  -> {"jax", "port": (final latent, image, LoRA)}, the
    port's `info`, the case, JAX's `DragDiffusion` (its loops compiled) and
    trained LoRA, and the initialisation and draws."""
    cfg, jpipe, tpipe = pipes
    h, w = cfg.height, cfg.width
    img = np.random.default_rng(21).integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = _mask(h, w)
    handles, targets = _drag_points_from_case(mask, mask, DRAG_PARAM, seed=SEED)
    out = {}
    orig = JDD.train_lora
    trained = []

    def keep(*args, **k):
        trained.append(orig(*args, **k))
        return trained[-1]

    JDD.train_lora = keep
    jdd = JDD.DragDiffusion(jpipe)
    try:
        store = {}
        _capture(jpipe, store, np.asarray)
        res = jdd.drag(img, handles, targets, PROMPT, mask=_union(mask),
                       train_lora_steps=LORA_STEPS, lora_rank=RANK, lora_lr=LORA_LR, **DRAG_KW)
        out["jax"] = (store["lat"], np.asarray(res), lora_from_flax(trained[0]))
    finally:
        JDD.train_lora = orig
    init = lora_from_flax(JDD.init_lora(jpipe.params["unet"], RANK, jax.random.key(SEED)))
    lat_shape = (1, cfg.latent_height, cfg.latent_width, 4)
    draws = jax_lora_draws(SEED, lat_shape, LORA_STEPS)
    lora = DD.train_lora(tpipe, img, PROMPT, rank=RANK, steps=LORA_STEPS, lr=LORA_LR, init=init,
                         draws=draws)
    store, info = {}, {}
    _capture(tpipe, store, lambda a: a.numpy())
    res = DD.DragDiffusion(tpipe).drag(img, handles, targets, PROMPT, mask=_union(mask),
                                       lora=lora, info=info, **DRAG_KW)
    out["port"] = (store["lat"], res, lora)
    out.update(info=info, img=img, mask=mask, jdd=jdd, jax_lora=trained[0], init=init,
               draws=draws)
    return out


def _both_drags(pipes, drags, handles, targets, mask):
    """JAX's drag (its loops compiled by the `drags` fixture, its trained
    LoRA) and the port's (its own trained LoRA) of the fixture's image at
    other points or mask.  -> (port's latent, image, info), (JAX's latent,
    image)."""
    _, jpipe, tpipe = pipes
    kw = {**DRAG_KW, "mask": mask}
    store = {}
    _capture(jpipe, store, np.asarray)
    want = drags["jdd"].drag(drags["img"], handles, targets, PROMPT, lora=drags["jax_lora"],
                             **kw)
    want = (store["lat"], np.asarray(want))
    store, info = {}, {}
    _capture(tpipe, store, lambda a: a.numpy())
    got = DD.DragDiffusion(tpipe).drag(drags["img"], handles, targets, PROMPT,
                                       lora=drags["port"][2], info=info, **kw)
    return (store["lat"], got, info), want


# -- LoRA ----------------------------------------------------------------------


def test_lora_paths_init_merge_and_carry_over(pipes):
    cfg, jpipe, tpipe = pipes
    unet = tpipe.unet
    jl = JDD.init_lora(jpipe.params["unet"], RANK, jax.random.key(0))
    lora = lora_from_flax(jl)
    paths = DD.lora_paths(unet)
    assert len(paths) == 128 == len(JDD.lora_paths(jpipe.params["unet"]))
    assert sorted(lora) == paths
    params = dict(unet.named_parameters())
    for k in paths:
        n_out, n_in = params[k].shape
        assert lora[k]["a"].shape == (n_in, RANK) and lora[k]["b"].shape == (RANK, n_out)
    # the port's own draw has the same layout
    own = DD.init_lora(unet, RANK, torch.Generator().manual_seed(0))
    assert sorted(own) == paths and all(not ab["b"].any() for ab in own.values())
    base = {k: v.clone() for k, v in unet.state_dict().items()}
    merged = DD.merge_lora(unet, lora)
    assert all(torch.equal(merged[k], base[k]) for k in paths)        # b = 0: identity
    key = paths[5]
    flax_key = next(k for k in jl if lora_from_flax({k: jl[k]}).keys() == {key})
    jl[flax_key]["b"] = jax.random.normal(jax.random.key(3), jl[flax_key]["b"].shape)
    want = JDD.merge_lora(jpipe.params["unet"], jl)
    from flax import traverse_util
    want_w = np.asarray(traverse_util.flatten_dict(want["params"])[tuple(flax_key.split("/"))])
    got = DD.merge_lora(unet, lora_from_flax(jl))[key]
    _close(got, want_w.T, 1e-6)
    assert not torch.equal(got, base[key])
    assert all(torch.equal(v, base[k]) for k, v in unet.state_dict().items())  # untouched


def test_lora_step_gradient_matches_jax(pipes):
    """`lora_loss` and its gradient to every factor against JAX's training
    objective under `jax.value_and_grad`, at init (b = 0: the a gradients
    are exact zeros on both sides) and with b moved."""
    cfg, jpipe, tpipe = pipes
    unet_params = jpipe.params["unet"]
    rng = np.random.default_rng(31)
    lat = rng.normal(size=(1, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
    noise = rng.normal(size=lat.shape).astype(np.float32)
    ctx = jpipe.encode_text([PROMPT])
    sched = JSchedule.create(num_inference_steps=50)
    t = 437

    @jax.jit
    def jstep(lora):
        def loss_fn(lo):
            a_t = sched.alphas_cumprod[t]
            noisy = jnp.sqrt(a_t) * jnp.asarray(lat) + jnp.sqrt(1.0 - a_t) * jnp.asarray(noise)
            pred = jpipe.unet.apply(JDD.merge_lora(unet_params, lo), noisy, t, ctx)
            return jnp.mean((pred.astype(jnp.float32) - jnp.asarray(noise)) ** 2)
        return jax.value_and_grad(loss_fn)(lora)

    jl = JDD.init_lora(unet_params, RANK, jax.random.key(1))
    moved = {k: {"a": v["a"], "b": 0.05 * jax.random.normal(jax.random.key(i), v["b"].shape)}
             for i, (k, v) in enumerate(jl.items())}
    alphas = torch.as_tensor(sched.alphas_cumprod)
    for lo, at_init in ((jl, True), (moved, False)):
        want, want_grads = jstep(lo)
        tl = {k: {n: x.requires_grad_() for n, x in ab.items()}
              for k, ab in lora_from_flax(lo).items()}
        got = DD.lora_loss(tpipe, tl, torch.from_numpy(lat), torch.from_numpy(np.asarray(ctx)), t,
                           torch.from_numpy(noise), alphas)
        keys = sorted(tl)
        grads = torch.autograd.grad(got, [tl[k][n] for k in keys for n in ("a", "b")])
        _close(got, want, 2e-4)
        wg = lora_from_flax({k: {n: want_grads[k][n] for n in ("a", "b")} for k in want_grads})
        for n, off in (("a", 0), ("b", 1)):
            g = torch.cat([grads[2 * i + off].reshape(-1) for i in range(len(keys))])
            w = np.concatenate([wg[k][n].numpy().reshape(-1) for k in keys])
            if n == "a" and at_init:
                assert not w.any() and not g.any()
            else:
                assert np.abs(w).max() > 0
                _close(g, w, 2e-4)


def test_adam_matches_optax():
    rng = np.random.default_rng(33)
    params = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (2, 5))]
    grads = [[(rng.normal(size=p.shape) * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
              for p in params] for _ in range(3)]
    grads[0][1][:] = 0.0                     # b's zero gradient at the first LoRA step
    grads[1][0][0] = 0.0
    tx = optax.adam(LORA_LR)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt = torch.optim.Adam(tp, lr=LORA_LR, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state)
        old = [p.detach().clone() for p in tp]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for p, o, u, x in zip(tp, old, updates, g):
            assert np.abs((p.detach() - o).numpy() - np.asarray(u)).max() <= 1e-6
            if g is grads[0]:
                assert np.array_equal((p.detach() - o).numpy() == 0, x == 0)
        jp = optax.apply_updates(jp, updates)
    for p, q in zip(tp, jp):
        assert np.abs(p.detach().numpy() - np.asarray(q)).max() <= 1e-6


# -- point tools -----------------------------------------------------------------


def test_sample_patch_track_point_and_nearest_resizes_match_jax():
    rng = np.random.default_rng(35)
    feat = rng.normal(size=(12, 10, 5)).astype(np.float32)
    centers = np.array([[0.3, 0.7], [11.6, 9.2], [5.5, 4.0], [-1.2, 3.3]], np.float32)
    for r in (1, 2):
        yy, xx = DD._patch_coords(torch.from_numpy(centers[:, 0]), torch.from_numpy(centers[:, 1]),
                                  r)
        for i, (cy, cx) in enumerate(centers):
            jy, jx = JDD._patch_coords(jnp.float32(cy), jnp.float32(cx), r)
            assert np.array_equal(yy[i].numpy(), np.asarray(jy))
            assert np.array_equal(xx[i].numpy(), np.asarray(jx))
            for sy, sx in ((jy, jx), (jnp.round(jy), jnp.round(jx)), (jy + 0.6, jx - 0.8)):
                want = JDD.sample_patch(jnp.asarray(feat), sy, sx)
                got = DD.sample_patch(torch.from_numpy(feat), torch.from_numpy(np.asarray(sy)),
                                      torch.from_numpy(np.asarray(sx)))
                _close(got, want, 1e-6)
    # tracking: windows clamped at each border, and exact ties (the same
    # vector at several cells of a window: the first in row-major order)
    feat2 = rng.normal(size=(16, 14, 6)).astype(np.float32)
    f0 = feat2[3, 4].copy()
    feat2[1, 6] = feat2[5, 2] = f0 + 0.25
    feat2[3, 4] = f0 + 0.25
    points = np.array([[3.4, 4.9], [0.2, 0.6], [15.7, 13.1], [1.0, 12.5], [14.2, 0.0],
                       [7.9, 7.1]], np.float32)
    f0s = np.stack([f0, feat2[0, 0], feat2[15, 13], feat2[2, 11], feat2[12, 1], feat2[9, 9]])
    got = DD.track_points(torch.from_numpy(f0s), torch.from_numpy(feat2),
                          torch.from_numpy(points), 3)
    for i, p in enumerate(points):
        want = JDD.track_point(jnp.asarray(f0s[i]), jnp.asarray(feat2), jnp.asarray(p), 3)
        assert np.array_equal(got[i].numpy(), np.asarray(want)), (i, got[i], want)
    assert got[0].tolist() == [1.0, 6.0]          # the tie: first of three in the window
    # the "nearest" mask resizes of the protocol (to sup res, to the latent)
    m = (rng.random((64, 50)) > 0.6).astype(np.float32)
    for size in ((32, 25), (8, 8), (37, 61), (64, 50)):
        want = jax.image.resize(jnp.asarray(m), size, "nearest")
        assert np.array_equal(resize(torch.from_numpy(m), size, "nearest").numpy(),
                              np.asarray(want)), size


# -- GeoBench points ---------------------------------------------------------------


@pytest.mark.parametrize("param", [(6, -4, 0, 0, 0, 0, 1), (0, 0, 0, 0, 0, 25, 1),
                                   (0, 0, 0, 0, 0, 0, 1.3), (40, 0, 0, 0, 0, 0, 1)])
def test_drag_points_and_transform_coordinates_match_jax(param):
    m = _mask(64, 64)
    for size, mm in (((64, 64), m), ((48, 64), m[8:56])):
        want = JMD.transform_coordinates(param, size, (mm > 0).astype(float))
        got = MD.transform_coordinates(param, size, (mm > 0).astype(float))
        assert got.dtype == want.dtype and np.array_equal(got, want)
        for n in (30, 1000):
            jh, jt = j_drag_points(mm, mm, param, n_points=n, seed=SEED)
            h, t = _drag_points_from_case(mm, mm, param, n_points=n, seed=SEED)
            assert np.array_equal(h, jh) and np.array_equal(t, jt)
    assert MD.center_of_mass(m > 0) == JMD.center_of_mass(m > 0)
    h, t = _drag_points_from_case(np.zeros((8, 8)), None, param)
    assert h.shape == t.shape == (0, 2)


# -- the whole drag ------------------------------------------------------------------


def test_trained_lora_matches_jax(pipes, drags):
    """The training's change of every factor against JAX's, within 2e-2 of
    the change's max |ref|, on the entries whose gradient at every step is
    an exact zero or passes 1e-3 of its factor's max (the port's gradients
    at the same steps).  Adam's first steps are about lr times the
    gradient's sign, so an entry whose gradient is rounding noise moves by
    about lr either way; at most 5 % of the entries are left out so.  The
    smallest held gradients (near 1e-8) meet Adam's eps, where a step
    depends on |g| and so on its rounding: 1.1e-2 of the change at most
    here.  An update skipped or of the wrong sign is 1 or 2 of it."""
    _, _, tpipe = pipes
    want, got, init, draws = drags["jax"][2], drags["port"][2], drags["init"], drags["draws"]
    keys = sorted(init)
    assert sorted(got) == sorted(want) == keys
    latent = tpipe.image_to_latent(drags["img"])
    ctx = tpipe.encode_text([PROMPT])
    alphas = torch.as_tensor(JSchedule.create(num_inference_steps=50).alphas_cumprod)
    held = {}
    for i, (t, noise) in enumerate(draws):
        lora = init if i == 0 else DD.train_lora(tpipe, drags["img"], PROMPT, rank=RANK,
                                                 steps=i, lr=LORA_LR, init=init,
                                                 draws=draws[:i])
        lo = {k: {n: x.clone().requires_grad_() for n, x in lora[k].items()} for k in keys}
        loss = DD.lora_loss(tpipe, lo, latent, ctx, t, noise, alphas)
        grads = torch.autograd.grad(loss, [lo[k][n] for k in keys for n in ("a", "b")])
        for j, n in enumerate(("a", "b")):
            sure = torch.cat([((g == 0) | (g > 1e-3 * g.max())).reshape(-1) for g in
                              (grads[2 * m + j].abs() for m in range(len(keys)))])
            held[n] = sure & held[n] if n in held else sure
    assert not torch.cat([ab["b"].reshape(-1) for ab in init.values()]).any()
    for n in ("a", "b"):
        change_got = torch.cat([(got[k][n] - init[k][n]).reshape(-1) for k in keys])
        change_want = torch.cat([(want[k][n] - init[k][n]).reshape(-1) for k in keys])
        assert held[n].float().mean() >= 0.95, (n, held[n].float().mean())
        assert change_want[held[n]].abs().max() > 0       # a moves at the second step
        _close(change_got[held[n]], change_want[held[n]].numpy(), 2e-2)


def test_motion_loss_with_the_union_mask_matches_jax(pipes):
    """`motion_loss` with a union mask, through the LoRA-merged UNet, and
    its gradient to the latent, against the same terms of JAX's drag loop
    (the patch L1 of every handle, one of them within 2 pixels of its
    target and so gated off; the anchor outside the mask, x_prev_0 taken at
    another latent, then at the latent itself) under `jax.value_and_grad`,
    within 2e-4 of max |ref|.  The anchor mask (`anchor_mask` after the
    "nearest" resize to sup res) bit for bit; the anchor moves the
    gradient in both cases."""
    cfg, jpipe, tpipe = pipes
    h, w = cfg.height, cfg.width
    lh, lw = cfg.latent_height, cfg.latent_width
    sup = (h // 2, w // 2)
    mask = _mask(h, w)
    tm = np.roll(mask, (-4, 12), axis=(0, 1))
    union = ((mask > 0) | (tm > 0)).astype(np.float32)
    hs, ts = _drag_points_from_case(mask, tm, (12, -4, 0, 0, 0, 0, 1), seed=SEED)

    def to_sup(p):
        return np.stack([p[:, 1] / h * sup[0], p[:, 0] / w * sup[1]], -1).astype(np.float32)

    handles, targets = to_sup(hs), to_sup(ts)
    targets[0] = handles[0] + np.float32([1.2, -0.9])
    rng = np.random.default_rng(37)
    code, other = (rng.normal(size=(1, lh, lw, 4)).astype(np.float32) for _ in range(2))
    sched = JSchedule.create(num_inference_steps=50)
    t = int(np.asarray(sched.timesteps)[15])
    jl = JDD.init_lora(jpipe.params["unet"], RANK, jax.random.key(4))
    jl = {k: {"a": v["a"], "b": 0.05 * jax.random.normal(jax.random.key(i), v["b"].shape)}
          for i, (k, v) in enumerate(jl.items())}
    merged = JDD.merge_lora(jpipe.params["unet"], jl)
    jctx = jpipe.encode_text([PROMPT])
    idx = len(cfg.unet.block_out_channels)
    mask_lat = jax.image.resize(jax.image.resize(jnp.asarray(union), sup, "nearest"), (lh, lw),
                                "nearest")[None, :, :, None]

    # the pieces of JAX's `_drag_loop` at its timestep, as written there
    def features(c):
        eps, feats = jpipe.unet.apply(merged, c, jnp.int32(t), jctx, return_features=True)
        f = feats[idx]
        f = jax.image.resize(f.astype(jnp.float32), (f.shape[0], *sup, f.shape[-1]), "bilinear")
        return eps, f[0]

    def ddim_prev(eps, c):
        a_t = sched.alpha_at(jnp.int32(t))
        a_p = sched.alpha_prev_strict(jnp.int32(t) - sched.step_delta)
        x0 = (c.astype(jnp.float32) - jnp.sqrt(1.0 - a_t) * eps.astype(jnp.float32)) / jnp.sqrt(
            a_t)
        return jnp.sqrt(a_p) * x0 + jnp.sqrt(1.0 - a_p) * eps.astype(jnp.float32)

    def jloss(c, x_prev_0):
        eps, f1 = features(c)

        def point_loss(p, tg):
            d = tg - p
            dist = jnp.linalg.norm(d)
            di = d / jnp.maximum(dist, 1e-8)
            yy, xx = JDD._patch_coords(p[0], p[1], 1)
            f_now = jax.lax.stop_gradient(JDD.sample_patch(f1, jnp.round(yy), jnp.round(xx)))
            f_moved = JDD.sample_patch(f1, yy + di[0], xx + di[1])
            return (dist >= 2.0) * 9 * jnp.abs(f_now - f_moved).mean()

        pl = jax.vmap(point_loss)(jnp.asarray(handles), jnp.asarray(targets))
        anchor = jnp.abs((ddim_prev(eps, c) - x_prev_0) * (1.0 - mask_lat)).sum()
        return pl.sum() + 0.1 * anchor

    @jax.jit
    def jstep(c, o):
        eps0, _ = features(o)
        return jax.value_and_grad(jloss)(c, ddim_prev(eps0, o))

    dd = DD.DragDiffusion(tpipe)
    tsched = dd._schedule()
    weights = DD.merge_lora(tpipe.unet, lora_from_flax(jl))
    ctx = tpipe.encode_text([PROMPT])
    anchor = dd.anchor_mask(resize(torch.from_numpy(union), sup, "nearest"), (lh, lw))
    assert np.array_equal(anchor.numpy(), np.asarray(mask_lat))
    assert not np.array_equal(anchor[0, ..., 0].numpy(), anchor[0, ..., 0].numpy().T)
    # x_prev_0 at another latent (off zero), then at the latent itself: the
    # first drag iteration's exact zero residual, where `jnp.abs`'s
    # gradient is +1 (ROADMAP C13)
    for ref in (other, code):
        want, want_grad = jstep(jnp.asarray(code), jnp.asarray(ref))
        with torch.no_grad():
            eps0, _ = dd.features(weights, torch.from_numpy(ref), t, ctx, sup)
            x_prev_0 = DD.ddim_prev(tsched, eps0, t, torch.from_numpy(ref))
        grads = []
        for m in (anchor, None):
            c = torch.from_numpy(code).requires_grad_()
            eps, f1 = dd.features(weights, c, t, ctx, sup)
            loss = dd.motion_loss(tsched, eps, f1, c, t, torch.from_numpy(handles),
                                  torch.from_numpy(targets), x_prev_0, m, 1, 0.1)
            grads += torch.autograd.grad(loss, c)
            if m is anchor:
                _close(loss, want, 2e-4)
        _close(grads[0], want_grad, 2e-4)
        assert (grads[0] - grads[1]).abs().max() > 0.1 * grads[0].abs().max()


def test_drag_stops_at_the_first_iteration_like_jax(pipes, drags):
    """Every handle starts within 2 pixels of its target: the loop stops at
    its first iteration with no update (JAX's `done` gate set from the
    start), so the drag is the MasaCtrl denoise of the inverted latent.
    Final latents within 2e-3 absolute, images within 1."""
    cfg = pipes[0]
    mask = drags["mask"]
    handles, _ = _drag_points_from_case(mask, mask, DRAG_PARAM, seed=SEED)
    targets = handles + np.array([2.0, -1.5])            # 1.25 pixels at sup res
    (got_lat, got_img, info), (want_lat, want_img) = _both_drags(pipes, drags, handles, targets,
                                                                  _union(mask))
    assert info == {"iterations": 1, "updates": 0}
    assert got_img.shape == (cfg.height, cfg.width, 3) and np.isfinite(got_lat).all()
    np.testing.assert_allclose(got_lat, want_lat, atol=2e-3, rtol=0)
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1


def test_drag_stops_once_tracking_arrives_like_jax(pipes, drags):
    """Each handle starts 2.1-2.9 pixels (sup res) from its target, which
    lies 1.1 pixels up and left of the cell the handle floors to: the
    first iteration steps, the second re-locates every handle on its own
    cell, within 2 pixels, and the loop stops there.  The code from after
    the one update is returned (JAX freezes it at the same iteration; two
    more updates of lr 0.01 would not pass the check).  Final latents
    within 2e-3 absolute, images within 1."""
    mask = drags["mask"]
    hs, _ = _drag_points_from_case(mask, mask, DRAG_PARAM, seed=SEED)
    handles = hs + 0.8                                   # sup res: k + 0.4 or k + 0.9
    targets = 2.0 * (np.floor(handles / 2.0) - 1.1)
    assert (np.linalg.norm(handles - targets, axis=-1) / 2.0 >= 2.0).all()
    (got_lat, got_img, info), (want_lat, want_img) = _both_drags(pipes, drags, handles, targets,
                                                                  _union(mask))
    assert info == {"iterations": 2, "updates": 1}
    np.testing.assert_allclose(got_lat, want_lat, atol=2e-3, rtol=0)
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1
