"""Background generation (object removal) in the port against the JAX
package: its masks bit-exact, its attention with the JAX einsum route
(FREEFINE_FLASH=0), and `FreeFine.background_generation` as a whole on
`tiny_pipeline_config` with the same weights (carried through
`freefine_tpu.weights.convert_*`) and JAX's own noise draws (the `split` ->
`normal` chain of `sample_bggen_loop`, 2-stream draws).

Tolerances: attention 3e-5 absolute (float32); final latents 2e-3 absolute
(summation order compounds over 5 inversion and 5 regeneration passes),
uint8 images within 1 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import masks as JM
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.ops import attention as JA
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch import masks as M
from freefine_tpu_torch.edit import EditConfig, EditState
from freefine_tpu_torch.ops import attention as A
from freefine_tpu_torch.ops import flash_attention as FA
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

SEQ, HEADS, DIM = 64, 4, 16
ATOL = 3e-5


def _mask(h, w, box):
    m = np.zeros((h, w), np.float32)
    y0, y1, x0, x1 = box
    m[y0:y1, x0:x1] = 255.0
    return m


@pytest.mark.parametrize("shape", [(64, 64), (96, 80), (32, 48, 3)])
def test_prepare_mask_bggen_matches_jax(shape):
    rng = np.random.default_rng(1)
    m = (rng.random(shape) > 0.7).astype(np.float32) * 255
    want = JM.prepare_mask_bggen(jnp.asarray(m), 64, 64, 8, 8)
    got = M.prepare_mask_bggen(torch.from_numpy(m), 64, 64, 8, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("box,rate", [((10, 30, 20, 44), 0.5), ((0, 5, 60, 64), 0.5),
                                      ((20, 50, 2, 9), 1.5), (None, 0.5)])
def test_prepare_surrounding_mask_matches_jax(box, rate):
    m = np.zeros((64, 64), np.float32) if box is None else _mask(64, 64, box)
    cons = _mask(64, 64, (0, 20, 0, 30))
    want = JM.prepare_surrounding_mask(jnp.asarray(m), jnp.asarray(cons), rate)
    got = M.prepare_surrounding_mask(torch.from_numpy(m), torch.from_numpy(cons), rate)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert box is None or got.sum() > 0


def _qkv(seed, b=3):
    rng = np.random.default_rng(seed)
    return rng, [rng.normal(size=(b, SEQ, HEADS * DIM)).astype(np.float32) for _ in range(3)]


def _states(rng, cg):
    obj = (rng.random(SEQ) > 0.6).astype(np.float32)
    j = JEditState(fg_retain={SEQ: jnp.asarray(obj)}, fg_ref={SEQ: jnp.asarray(obj)},
                   local_region={SEQ: jnp.asarray(obj)}, context_guidance=jnp.float32(cg))
    t = EditState(fg_retain={SEQ: torch.from_numpy(obj)}, fg_ref={SEQ: torch.from_numpy(obj)},
                  local_region={SEQ: torch.from_numpy(obj)}, context_guidance=cg)
    return j, t


@pytest.mark.parametrize("method,block_index,place", [
    ("tca", 12, "up"), ("mmsa", 14, "up"), ("tca", 3, "down"),
    ("ssa", 3, "down"), ("sdsa", 6, "mid"), ("sdsa", 12, "up")])
def test_bggen_self_attention_matches_jax(method, block_index, place, monkeypatch):
    """`_tca_bggen` inside the TCA window (and plain outside it); ssa/sdsa
    in bggen mode in every scope."""
    monkeypatch.setattr(JA, "FLASH_MODE", "0")
    rng, (q, k, v) = _qkv(1)
    jstate, tstate = _states(rng, 0.7)
    want = JA.edit_self_attention(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                                  JEditConfig(mode="bggen", method=method), jstate,
                                  block_index, place)
    FA.reset_launch_counts()
    got = A.edit_self_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                EditConfig(mode="bggen", method=method), tstate,
                                block_index, place)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not any(FA.LAUNCHES.values())


def test_tca_bggen_is_background_attention():
    """With cg = 1 the even heads of every stream attend only to the
    reference stream's background keys."""
    rng, (q, k, v) = _qkv(2)
    _, tstate = _states(rng, 1.0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = A._tca_bggen(tq, tk, tv, HEADS, EditConfig(mode="bggen", method="tca"), tstate)
    bg = 1.0 - tstate.fg_retain[SEQ]
    ref_k, ref_v = tk[[1, 1, 1]], tv[[1, 1, 1]]
    even = A._split_parity(tq, HEADS)[:3]
    want = FA.flash_sdpa_reference(even, A._split_parity(ref_k, HEADS)[:3],
                                   A._split_parity(ref_v, HEADS)[:3], bg[None].expand(3, -1),
                                   heads=HEADS // 2)
    np.testing.assert_allclose(A._split_parity(got, HEADS)[:3].numpy(), want.numpy(),
                               atol=ATOL, rtol=0)


def test_bggen_cross_attention_matches_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, SEQ, HEADS * DIM)).astype(np.float32)
    k = rng.normal(size=(3, 77, HEADS * DIM)).astype(np.float32)
    v = rng.normal(size=(3, 77, HEADS * DIM)).astype(np.float32)
    jstate, tstate = _states(rng, 0.5)
    want = JA.edit_cross_attention(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                                   JEditConfig(mode="bggen", method="tca"), jstate)
    got = A.edit_cross_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                 EditConfig(mode="bggen", method="tca"), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# The whole path
# ---------------------------------------------------------------------------

NUM_STEP, START = 6, 1
K = NUM_STEP - START


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(31)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def _capture(pipe, store, to_np):
    orig = pipe.latent_to_image

    def cap(lat):
        store["lat"] = to_np(lat)
        return orig(lat)

    pipe.latent_to_image = cap


def jax_noise(seed, k, shape):
    """JAX's per-step draws of a sampling loop: split, then normal."""
    key = jax.random.key(seed)
    out = []
    for _ in range(k):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


@pytest.mark.parametrize("method", ["tca", "sdsa"])
def test_background_generation_matches_jax(pipes, method):
    cfg, jpipe, tpipe = pipes
    h, w = cfg.height, cfg.width
    img = np.random.default_rng(7).integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = _mask(h, w, (14, 40, 18, 46)).astype(np.uint8)
    seed = 9
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=3, seed=seed, method_type=method)
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda x: x.numpy())
    want = jpipe.background_generation(img, mask, "a wooden table", **kw)
    noise = jax_noise(seed, K, (2, cfg.latent_height, cfg.latent_width, 4))
    got = tpipe.background_generation(img, mask, "a wooden table", noise=noise, **kw)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    assert tstore["lat"].shape == (1, cfg.latent_height, cfg.latent_width, 4)
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_seeded_background_generation_is_deterministic(pipes):
    cfg, _, tpipe = pipes
    h, w = cfg.height, cfg.width
    img = np.random.default_rng(8).integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = _mask(h, w, (10, 30, 10, 30))
    kw = dict(num_step=4, start_step=1, end_step=2, seed=4)
    a = tpipe.background_generation(img, mask, "grass", **kw)
    b = tpipe.background_generation(img, mask, "grass", **kw)
    np.testing.assert_array_equal(a, b)
