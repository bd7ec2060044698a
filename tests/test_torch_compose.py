"""Multi-image composition and style-aligned attention in the port against
the JAX package: the composition masks bit-exact, the compose TCA, the
compose cross-attention with region prompts and ssa/sdsa in edit mode with
the JAX einsum route (FREEFINE_FLASH=0), and as whole paths on
`tiny_pipeline_config` (same weights carried through
`freefine_tpu.weights.convert_*`, JAX's own noise draws):
`FreeFine.cross_image_composition` with N = 2 sources, and
`FreeFine.generation` with method_type "sdsa".

Tolerances: attention 3e-5 absolute (float32); final latents 2e-3 absolute
(summation order compounds over the inversion and regeneration passes),
uint8 images within 1 level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import masks as JM
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.edit import build_mask_stack_pyramid as j_build_mask_stack_pyramid
from freefine_tpu.ops import attention as JA
from freefine_tpu.ops.geometry import re_edit_2d as j_re_edit_2d
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch import masks as M
from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_stack_pyramid
from freefine_tpu_torch.ops import attention as A
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_bggen import _capture, jax_noise
from test_torch_pipeline import capture_decodes
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

SEQ, HEADS, DIM = 64, 4, 16
N = 2
ATOL = 3e-5


def _box(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.float32)
    m[y0:y1, x0:x1] = 255.0
    return m


def _compose_masks(h=64, w=64):
    ori = [_box(h, w, 8, 30, 10, 28), _box(h, w, 30, 60, 34, 60)]
    tgt = [_box(h, w, 12, 34, 30, 50), _box(h, w, 36, 58, 6, 30)]
    draw = [_box(h, w, 10, 40, 26, 56), _box(h, w, 34, 62, 2, 34)]
    return ori, tgt, draw


@pytest.mark.parametrize("branch", ["plain", "plain_dil", "appearance", "draw"])
def test_prepare_composition_masks_matches_jax(branch):
    ori, tgt, draw = _compose_masks()
    kw = dict(dil_completion=branch == "plain_dil", dil_factor=7,
              appearance_transfer=branch == "appearance")
    want = JM.prepare_composition_masks(
        [jnp.asarray(m) for m in ori], [jnp.asarray(m) for m in tgt], 64, 64, 8, 8,
        draw_masks=[jnp.asarray(m) for m in draw] if branch == "draw" else None, **kw)
    got = M.prepare_composition_masks(
        [torch.from_numpy(m) for m in ori], [torch.from_numpy(m) for m in tgt], 64, 64, 8, 8,
        draw_masks=[torch.from_numpy(m) for m in draw] if branch == "draw" else None, **kw)
    for name in M.ComposeMasks._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_build_mask_stack_pyramid_matches_jax():
    rng = np.random.default_rng(0)
    masks = rng.random((3, 64, 64)).astype(np.float32)
    want = j_build_mask_stack_pyramid(jnp.asarray(masks), 8, 8)
    got = build_mask_stack_pyramid(torch.from_numpy(masks), 8, 8)
    assert set(got) == set(want) == {64, 16, 4, 1}
    for s in want:
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(want[s]))


def _qkv(seed, b, seq=SEQ):
    rng = np.random.default_rng(seed)
    return rng, [rng.normal(size=(b, seq, HEADS * DIM)).astype(np.float32) for _ in range(3)]


def _compose_states(rng, cg, p):
    src = (rng.random((N, SEQ)) > 0.5).astype(np.float32)
    tgt = rng.random((max(N + 1, p), SEQ)).astype(np.float32)
    j = JEditState(src_masks={SEQ: jnp.asarray(src)}, tgt_masks={SEQ: jnp.asarray(tgt)},
                   context_guidance=jnp.float32(cg))
    t = EditState(src_masks={SEQ: torch.from_numpy(src)}, tgt_masks={SEQ: torch.from_numpy(tgt)},
                  context_guidance=cg)
    return j, t


@pytest.mark.parametrize("method,block_index", [("tca", 12), ("mmsa", 15), ("tca", 9),
                                                ("ssa", 12)])
def test_compose_self_attention_matches_jax(method, block_index, monkeypatch):
    """`_tca_compose` in the TCA window (plain outside it, and plain for
    ssa in compose mode, as JAX dispatches)."""
    monkeypatch.setattr(JA, "FLASH_MODE", "0")
    rng, (q, k, v) = _qkv(1, N + 2)
    jstate, tstate = _compose_states(rng, 0.6, N + 1)
    kw = dict(mode="compose", method=method, num_sources=N, prompt_length=N + 1)
    want = JA.edit_self_attention(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                                  JEditConfig(num_streams=N + 2, **kw), jstate, block_index, "up")
    got = A.edit_self_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                EditConfig(**kw), tstate, block_index, "up")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_compose_cross_attention_matches_jax():
    p = N + 1
    rng = np.random.default_rng(2)
    q = rng.normal(size=(N + 2, SEQ, HEADS * DIM)).astype(np.float32)
    k, v, k_extra, v_extra = (rng.normal(size=(b, 77, HEADS * DIM)).astype(np.float32)
                              for b in (N + 2, N + 2, p, p))
    jstate, tstate = _compose_states(rng, 0.5, p)
    kw = dict(mode="compose", method="tca", num_sources=N, prompt_length=p)
    want = JA.edit_cross_attention(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                                   JEditConfig(num_streams=N + 2, **kw), jstate,
                                   k_extra=jnp.asarray(k_extra), v_extra=jnp.asarray(v_extra))
    got = A.edit_cross_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                 EditConfig(**kw), tstate, k_extra=torch.from_numpy(k_extra),
                                 v_extra=torch.from_numpy(v_extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("method,place", [("ssa", "down"), ("ssa", "up"), ("sdsa", "mid"),
                                          ("sdsa", "up")])
def test_style_align_edit_matches_jax(method, place, monkeypatch):
    monkeypatch.setattr(JA, "FLASH_MODE", "0")
    rng, (q, k, v) = _qkv(3, 3)
    fg = (rng.random(SEQ) > 0.5).astype(np.float32)
    jstate = JEditState(fg_ref={SEQ: jnp.asarray(fg)}, fg_retain={SEQ: jnp.asarray(fg)})
    tstate = EditState(fg_ref={SEQ: torch.from_numpy(fg)}, fg_retain={SEQ: torch.from_numpy(fg)})
    want = JA.edit_self_attention(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                                  JEditConfig(mode="edit", method=method), jstate, 4, place)
    got = A.edit_self_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                EditConfig(mode="edit", method=method), tstate, 4, place)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_compose_rejects_a_wrong_stream_count():
    _, (q, k, v) = _qkv(4, N + 1)
    _, tstate = _compose_states(np.random.default_rng(4), 0.5, N + 1)
    with pytest.raises(ValueError):
        A._tca_compose(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                       EditConfig(mode="compose", method="tca", num_sources=N), tstate)


# ---------------------------------------------------------------------------
# Whole paths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(51)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def _check(cfg, tstore, jstore, got, want):
    assert got.shape == (cfg.height, cfg.width, 3) and got.dtype == np.uint8
    assert np.isfinite(tstore["lat"]).all()
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("appearance", [False, True])
def test_cross_image_composition_matches_jax(pipes, appearance):
    cfg, jpipe, tpipe = pipes
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for _ in range(N)]
    coarse = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    ori, tgt, _ = _compose_masks(h, w)
    num_step, start = 6, 3
    seed = 13
    kw = dict(num_step=num_step, start_step=start, end_step=4, seed=seed, dil_factor=7,
              appearance_transfer=appearance)
    texts = ["a red apple", "a blue cup"]
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda x: x.numpy())
    want = jpipe.cross_image_composition(imgs, ori, tgt, coarse, texts, **kw)
    noise = jax_noise(seed, num_step - start, (1, cfg.latent_height, cfg.latent_width, 4))
    got = tpipe.cross_image_composition(imgs, ori, tgt, coarse, texts, noise=noise, **kw)
    assert tstore["lat"].shape == (1, cfg.latent_height, cfg.latent_width, 4)
    _check(cfg, tstore, jstore, got, want)


@pytest.mark.parametrize("method", ["sdsa", "ssa"])
def test_generation_style_aligned_matches_jax(pipes, method):
    cfg, jpipe, tpipe = pipes
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(12)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = _box(h, w, 12, 36, 16, 40).astype(np.uint8)
    coarse, tm, _ = j_re_edit_2d(img, mask, dx=10, dy=4, rotation=20)
    coarse, tm = np.asarray(coarse), np.asarray(tm)
    num_step, start = 6, 3
    seed = 15
    kw = dict(num_step=num_step, start_step=start, end_step=1, seed=seed, method_type=method,
              use_auto_draw=True, cons_area=np.zeros((h, w), np.uint8))
    jstore = {}
    _capture(jpipe, jstore, np.asarray)
    decoded = capture_decodes(tpipe, lambda x: x.numpy())
    want, want_ori = jpipe.generation(img, mask, coarse, tm, "a cat", return_ori=True, **kw)
    noise = jax_noise(seed, num_step - start, (2, cfg.latent_height, cfg.latent_width, 4))
    got, got_ori = tpipe.generation(img, mask, coarse, tm, "a cat", noise=noise, return_ori=True,
                                    **kw)
    # both streams' final latents: the edit image's decode, then the reference's
    _check(cfg, {"lat": np.concatenate(decoded)}, jstore, got, want)
    assert np.abs(got_ori.astype(int) - want_ori.astype(int)).max() <= 1
