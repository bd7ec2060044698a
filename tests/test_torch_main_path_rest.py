"""The rest of the port's main path against the JAX package, on
`tiny_pipeline_config` with the same weights (carried through
`freefine_tpu.weights.convert_*`):

  * `_prep_image`'s lanczos3 resize against JAX's (`jax.image.resize`):
    uint8 within 1 level everywhere and equal at >= 99.9 % of the pixels;
    the float32 values before rounding within 1e-3;
  * `generation(return_intermediates=True)` against JAX's with JAX's
    draws replayed: K preview frames within 1 level; the final image bit
    for bit the port's own run without the flag; the three loops'
    intermediates;
  * `FreeFine.attention_maps` against JAX's: eps within 2e-3, the same keys
    and map counts, each map within 1e-4, eps bit for bit the probe-free
    pass; `AttentionStore` on the same maps equal to JAX's;
  * the 2D leftovers `flip_object` and `get_constrain_areas` bit for bit,
    and `EditConfig.uses_tca`.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import edit as JE
from freefine_tpu import masks as JM
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.ops import geometry as JG
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu.utils import attn_store as JS
from freefine_tpu.utils.vis import latent_to_preview as jax_preview
from freefine_tpu_torch import masks as M
from freefine_tpu_torch.config import tiny_pipeline_config
from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_pyramid
from freefine_tpu_torch.ops import geometry as G
from freefine_tpu_torch.pipeline import (FreeFine, sample_bggen_loop, sample_compose_loop,
                                         sample_edit_loop)
from freefine_tpu_torch.utils import attn_store as S
from freefine_tpu_torch.utils.vis import latent_to_preview
from test_torch_bggen import jax_noise
from test_torch_pipeline import _case
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

NUM_STEP, START = 6, 3
K = NUM_STEP - START


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(41)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


# -- the lanczos3 resize ---------------------------------------------------------


@pytest.mark.parametrize("shape", [(96, 80, 3), (40, 48, 3), (64, 90, 3), (30, 64, 3),
                                   (50, 70)],
                         ids=["down", "up", "width-only", "height-only", "2d"])
def test_prep_image_matches_jax(shape):
    jcfg, cfg = jax_tiny_config(), tiny_pipeline_config()
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    want = JFreeFine._prep_image(types.SimpleNamespace(config=jcfg), img)
    got = FreeFine._prep_image(types.SimpleNamespace(config=cfg, device=torch.device("cpu")),
                               img)
    assert got.dtype == np.uint8 and got.shape == (cfg.height, cfg.width, 3) == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    a = np.stack([img] * 3, -1) if img.ndim == 2 else img
    ref = np.asarray(jax.image.resize(jnp.asarray(a, jnp.float32), (cfg.height, cfg.width, 3),
                                      method="lanczos3"))
    np.testing.assert_allclose(G.resize_lanczos3(torch.from_numpy(a), cfg.height,
                                                 cfg.width).numpy(), ref, atol=1e-3, rtol=0)


def test_prep_image_keeps_pipeline_sized_input():
    cfg = tiny_pipeline_config()
    img = np.random.default_rng(0).integers(0, 256, (cfg.height, cfg.width, 3), dtype=np.uint8)
    pipe = types.SimpleNamespace(config=cfg, device=torch.device("cpu"))
    np.testing.assert_array_equal(FreeFine._prep_image(pipe, img), img)
    np.testing.assert_array_equal(FreeFine._prep_image(pipe, img[..., 0]), img[..., [0, 0, 0]])


# -- return_intermediates ----------------------------------------------------------


def test_generation_intermediates_match_jax(pipes):
    cfg, jpipe, tpipe = pipes
    img, mask, coarse, tm = _case(cfg)
    h, w = cfg.height, cfg.width
    seed = 5
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=seed, use_auto_draw=True,
              cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True)
    want_img, want_frames = jpipe.generation(img, mask, coarse, tm, "a cat",
                                             return_intermediates=True, **kw)
    noise = jax_noise(seed, K, (2, cfg.latent_height, cfg.latent_width, 4))
    got_img, got_frames = tpipe.generation(img, mask, coarse, tm, "a cat", noise=noise,
                                           return_intermediates=True, **kw)
    assert got_frames.shape == (K, cfg.latent_height, cfg.latent_width, 3) == want_frames.shape
    assert got_frames.dtype == np.uint8
    assert np.abs(got_frames.astype(int) - want_frames.astype(int)).max() <= 1
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1
    plain = tpipe.generation(img, mask, coarse, tm, "a cat", noise=noise, **kw)
    np.testing.assert_array_equal(got_img, plain)
    a, ori, frames = tpipe.generation(img, mask, coarse, tm, "a cat", noise=noise,
                                      return_ori=True, return_intermediates=True, **kw)
    np.testing.assert_array_equal(a, plain)
    np.testing.assert_array_equal(frames, got_frames)
    assert ori.shape == plain.shape


def test_latent_to_preview_matches_jax():
    lat = np.random.default_rng(2).normal(size=(3, 8, 8, 4)).astype(np.float32) * 2
    got = latent_to_preview(torch.from_numpy(lat))
    want = jax_preview(jnp.asarray(lat))
    assert got.dtype == np.uint8 and got.shape == (3, 8, 8, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def _fake_unet(lat, t, ctx, ecfg=None, state=None, ctx_extra=None):
    """A deterministic stand-in for the UNet (the loops' bookkeeping only)."""
    return torch.tanh(lat * 0.3 + 0.001 * t)


@pytest.mark.parametrize("loop", ["edit", "bggen", "compose"])
def test_loops_return_intermediates(pipes, loop):
    """Each loop's frames: one per step, the last the final edit stream; the
    final latents equal the run without the flag."""
    cfg, _, tpipe = pipes
    lh, lw = cfg.latent_height, cfg.latent_width
    rng = np.random.default_rng(6)
    streams = {"edit": 2, "bggen": 1, "compose": 3}[loop]
    traj = torch.from_numpy(rng.normal(size=(K + 1, streams, lh, lw, 4)).astype(np.float32))
    text = torch.zeros(4 if loop == "compose" else 3, 77, 32)
    ones = torch.ones(lh, lw)
    rows = 1 if loop == "compose" else 2
    noise = [torch.from_numpy(rng.normal(size=(rows, lh, lw, 4)).astype(np.float32))
             for _ in range(K)]
    kw = dict(start_step=START, guidance_scale=7.5, eta=1.0, local_text_edit=True,
              local_perturbation=True)
    cg = gates = np.ones(K, np.float32)
    sched, ecfg, state = tpipe._schedule(NUM_STEP), EditConfig(), EditState()
    if loop == "edit":
        run = lambda **x: sample_edit_loop(_fake_unet, sched, ecfg, traj, text, state, cg,  # noqa
                                           gates, ones, ones, noise, **kw, **x)
    elif loop == "bggen":
        run = lambda **x: sample_bggen_loop(_fake_unet, sched, ecfg, traj, text, state, cg,  # noqa
                                            gates, ones, ones, noise, **kw, **x)
    else:
        run = lambda **x: sample_compose_loop(_fake_unet, sched, ecfg, traj, text,  # noqa
                                              text[:2], state, cg, gates, ones, ones, noise,
                                              **kw, **x)
    final = run()
    final2, frames = run(return_intermediates=True)
    assert torch.equal(final, final2)
    assert frames.shape == (K, lh, lw, 4)
    assert torch.equal(frames[-1], final[0])


def test_batch_of_one_equals_single_edit(pipes):
    """C5: `BatchedFreeFine.generation` of one case is `generation` of the
    same case and seed bit for bit (final latents and image): each
    single-edit loop is its batched loop with one case, and the single
    edit encodes its text as a batch of one does."""
    from freefine_tpu_torch.pipeline import BatchedFreeFine

    cfg, _, tpipe = pipes
    img, mask, coarse, tm = _case(cfg)
    h, w = cfg.height, cfg.width
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1)
    store = {}
    orig = tpipe.latent_to_image
    tpipe.latent_to_image = lambda lat: (store.__setitem__("lat", lat.clone()), orig(lat))[1]
    try:
        batched = BatchedFreeFine(tpipe).generation(
            [dict(ori_img=img, ori_mask=mask, coarse_input=coarse, target_mask=tm,
                  guidance_text="a cat")], seed=[42], **kw)[0]
        lat_b = store["lat"]
        single = tpipe.generation(img, mask, coarse, tm, "a cat", use_auto_draw=True,
                                  cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True,
                                  seed=42, **kw)
        lat_s = store["lat"]
    finally:
        tpipe.latent_to_image = orig
    assert torch.equal(lat_b[0], lat_s[0])
    np.testing.assert_array_equal(batched, single)


# -- attention maps ----------------------------------------------------------------


def _edit_state(cfg, np_masks, jax_side):
    lh, lw = cfg.latent_height, cfg.latent_width
    fg, tgt = np_masks
    if jax_side:
        return JE.EditState(fg_retain=JE.build_mask_pyramid(jnp.asarray(tgt), lh, lw),
                            fg_ref=JE.build_mask_pyramid(jnp.asarray(fg), lh, lw),
                            local_region=JE.build_mask_pyramid(jnp.asarray(tgt), lh, lw),
                            context_guidance=jnp.float32(0.6))
    t = lambda m: build_mask_pyramid(torch.from_numpy(m), lh, lw)  # noqa: E731
    return EditState(fg_retain=t(tgt), fg_ref=t(fg), local_region=t(tgt), context_guidance=0.6)


@pytest.mark.parametrize("edit", [False, True], ids=["plain", "tca-edit"])
def test_attention_maps_match_jax(pipes, edit):
    cfg, jpipe, tpipe = pipes
    lh, lw = cfg.latent_height, cfg.latent_width
    rng = np.random.default_rng(9)
    batch = 3 if edit else 2
    sample = rng.normal(size=(batch, lh, lw, 4)).astype(np.float32)
    jctx = jnp.asarray(np.asarray(jpipe.encode_text(["", "a cat"])))
    ctx = tpipe.encode_text(["", "a cat"])
    if edit:
        jctx, ctx = jnp.stack([jctx[0], jctx[0], jctx[1]]), torch.stack([ctx[0], ctx[0], ctx[1]])
    jargs, targs = (), ()
    if edit:
        fg = np.zeros((cfg.height, cfg.width), np.float32)
        fg[8:40, 10:36] = 1
        tgt = np.roll(fg, 12, axis=1)
        jargs = (jpipe._edit_config(mode="edit", method="tca", local_cfg=True),
                 _edit_state(cfg, (fg, tgt), True))
        targs = (EditConfig(mode="edit", method="tca", local_cfg=True,
                            layer_range=tpipe._layer_range), _edit_state(cfg, (fg, tgt), False))
    t = 401
    jeps, jmaps = jpipe.attention_maps(jnp.asarray(sample), jnp.int32(t), jctx, *jargs)
    eps, maps = tpipe.attention_maps(torch.from_numpy(sample), t, ctx, *targs)
    np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), atol=2e-3, rtol=0)
    assert sorted(maps) == sorted(jmaps)
    assert {k: len(v) for k, v in maps.items()} == {k: len(v) for k, v in jmaps.items()}
    for key in jmaps:
        for got, want in zip(maps[key], jmaps[key]):
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
            np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)
    # the probe reads q and k beside the layer's route: eps unchanged
    plain = tpipe.unet_apply(torch.from_numpy(sample), t, ctx, *targs)
    assert torch.equal(eps, plain)
    # the same maps through both stores, two steps
    jstore, tstore = JS.AttentionStore(), S.AttentionStore()
    for _ in range(2):
        nested = {}
        for key, maps_k in jmaps.items():
            for i, m in enumerate(maps_k):
                nested.setdefault(f"{key}_{i}", {})["attn1" if key.endswith("self")
                                                     else "attn2"] = {"attn_probs": (m,)}
        jstore.update({f"{k.split('_')[0]}_blocks_{k}": v for k, v in nested.items()})
        flat = {(f"{key.split('_')[0]}_blocks", str(i), "attn1" if key.endswith("self")
                 else "attn2", "attn_probs"): [torch.from_numpy(np.array(m))]
                for key, maps_k in jmaps.items() for i, m in enumerate(maps_k)}
        tstore.update(flat)
    ja, ta = jstore.get_average_attention(), tstore.get_average_attention()
    assert sorted(ja) == sorted(ta) and tstore.cur_step == jstore.cur_step == 2
    for key in ja:
        assert len(ja[key]) == len(ta[key])
        for a, b in zip(ja[key], ta[key]):
            np.testing.assert_array_equal(a, b)


def test_classify_layer_matches_jax():
    for port_path, jax_path in [
        (("down_blocks", "0", "attentions", "1", "transformer_blocks", "0", "attn1", "attn_probs"),
         ("down_blocks_0_attentions_1", "transformer_blocks_0", "attn1", "attn_probs")),
        (("up_blocks", "2", "attentions", "0", "transformer_blocks", "0", "attn2", "attn_probs"),
         ("up_blocks_2_attentions_0", "transformer_blocks_0", "attn2", "attn_probs")),
        (("mid_block", "attentions", "0", "transformer_blocks", "0", "attn1", "attn_probs"),
         ("mid_block_attentions_0", "transformer_blocks_0", "attn1", "attn_probs")),
    ]:
        assert S.classify_layer(port_path) == JS.classify_layer(jax_path)


def test_token_attention_maps_match_jax():
    from freefine_tpu.ops import attention as JA
    from freefine_tpu_torch.ops import attention as TA

    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 16, 32)).astype(np.float32)
    k = rng.normal(size=(2, 77, 32)).astype(np.float32)
    sel = np.zeros((3, 77), np.float32)
    sel[0, 2] = sel[1, 5] = 1
    want = np.asarray(JA.token_attention_maps(jnp.asarray(q), jnp.asarray(k), 2,
                                              jnp.asarray(sel)))
    got = TA.token_attention_maps(torch.from_numpy(q), torch.from_numpy(k), 2,
                                  torch.from_numpy(sel)).numpy()
    assert got.shape == want.shape == (4, 16, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(TA.attention_probs(torch.from_numpy(q), torch.from_numpy(k),
                                                  2).numpy(),
                               np.asarray(JA.attention_probs(jnp.asarray(q), jnp.asarray(k), 2)),
                               atol=1e-6, rtol=0)


def test_sow_token_attn_records_selected_tokens(pipes):
    cfg, _, tpipe = pipes
    lh, lw = cfg.latent_height, cfg.latent_width
    sample = torch.from_numpy(np.random.default_rng(1).normal(size=(1, lh, lw, 4))
                              .astype(np.float32))
    sel = torch.zeros(2, 77)
    sel[0, 1] = 1
    state = EditState(token_select=sel, intermediates={})
    ecfg = EditConfig(sow_token_attn=True)
    eps = tpipe.unet_apply(sample, 11, tpipe.encode_text(["a cat"]), ecfg, state)
    assert torch.equal(eps, tpipe.unet_apply(sample, 11, tpipe.encode_text(["a cat"])))
    recs = {p: v for p, v in state.intermediates.items() if p[-1].startswith("token_attn_")}
    n_layers, _ = cfg.unet.attn_layer_layout
    assert len(recs) == n_layers and all(p[-2] == "attn2" for p in recs)
    for p, (m,) in recs.items():
        assert m.shape[0] == cfg.unet.num_attention_heads and m.shape[2] == 2
        assert p[-1] == f"token_attn_{p[0].split('_')[0]}"
        assert torch.all(m[..., 1] == 0)


# -- the 2D leftovers -------------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(12)
    img = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
    mask = np.zeros((48, 64), np.uint8)
    mask[10:30, 8:27] = 255
    return img, mask


@pytest.mark.parametrize("horizontal", [True, False])
def test_flip_object_matches_jax(scene, horizontal):
    img, mask = scene
    inp = np.full_like(img, 7)
    for kw in ({}, {"inp_cur": inp}):
        want = JG.flip_object(img, mask, horizontal=horizontal, **kw)
        got = G.flip_object(img, mask, horizontal=horizontal, device="cpu", **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    got3 = G.flip_object(img, np.stack([mask] * 3, -1), horizontal=horizontal, device="cpu")
    np.testing.assert_array_equal(got3[1], want[1])


def test_get_constrain_areas_matches_jax():
    a = np.zeros((16, 16), np.uint8)
    a[:4] = 255
    b = np.zeros((16, 16), np.uint8)
    b[:, :4] = 1
    c = np.zeros((32, 32, 3), np.uint8)
    c[20:, 20:] = 9
    for masks, hw in (([a, b], (16, 16)), ([a, b, c], (16, 16)), ([c], (8, 24))):
        want = np.asarray(JM.get_constrain_areas([jnp.asarray(m) for m in masks], *hw))
        got = M.get_constrain_areas([torch.from_numpy(m) for m in masks], *hw).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", [None, "tca", "mmsa", "ssa", "sdsa"])
def test_uses_tca_matches_jax(method):
    mode = "none" if method is None else "edit"
    assert EditConfig(mode=mode, method=method).uses_tca == \
        JE.EditConfig(mode=mode, method=method).uses_tca
    assert dataclasses.replace(EditConfig(), store_attention=True).store_attention
