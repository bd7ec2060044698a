"""Attention dispatch of the port against `freefine_tpu.ops.attention`.

The JAX side runs its Pallas kernels in interpret mode
(`FLASH_MODE = "1"`, as tests/test_flash_attention.py forces it) and its
einsum path; the port runs its kernel wrappers, which on CPU tensors are
the plain twins.  Layouts are the main path's: the deduped 3-stream batch
[u_e, r, c_e] with head-parity rows.

Tolerance: 3e-5 absolute (float32, streaming vs materialised softmax).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.ops import attention as JA
from freefine_tpu_torch.edit import EditConfig, EditState
from freefine_tpu_torch.ops import attention as A
from freefine_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(2)

SEQ, HEADS, DIM = 64, 4, 16
ATOL = 3e-5


def _qkv(seed, b=3, seq=SEQ):
    rng = np.random.default_rng(seed)
    return rng, [rng.normal(size=(b, seq, HEADS * DIM)).astype(np.float32) for _ in range(3)]


def _states(rng, cg):
    fg = (rng.random(SEQ) > 0.5).astype(np.float32)
    tgt = rng.random(SEQ).astype(np.float32) * (rng.random(SEQ) > 0.3)
    local = (rng.random(SEQ) > 0.5).astype(np.float32)
    j = JEditState(fg_ref={SEQ: jnp.asarray(fg)}, fg_retain={SEQ: jnp.asarray(tgt)},
                   local_region={SEQ: jnp.asarray(local)}, context_guidance=jnp.float32(cg))
    t = EditState(fg_ref={SEQ: torch.from_numpy(fg)}, fg_retain={SEQ: torch.from_numpy(tgt)},
                  local_region={SEQ: torch.from_numpy(local)}, context_guidance=cg)
    return j, t


@pytest.mark.parametrize("flash_mode", ["1", "0"])
@pytest.mark.parametrize("method", ["tca", "mmsa"])
def test_tca_edit_matches_jax(flash_mode, method, monkeypatch):
    monkeypatch.setattr(JA, "FLASH_MODE", flash_mode)
    rng, (q, k, v) = _qkv(1)
    jstate, tstate = _states(rng, 0.6)
    want = JA.edit_self_attention(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                                  JEditConfig(mode="edit", method=method), jstate, 12, "up")
    FA.reset_launch_counts()
    got = A.edit_self_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                EditConfig(mode="edit", method=method), tstate, 12, "up")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not any(FA.LAUNCHES.values())


@pytest.mark.parametrize("block_index,place", [(3, "down"), (6, "mid"), (9, "up")])
def test_ungated_self_attention_is_plain(block_index, place, monkeypatch):
    """Outside the TCA window (layer range 10..15, up scope) the edit mode
    is plain attention, in both packages."""
    monkeypatch.setattr(JA, "FLASH_MODE", "1")
    rng, (q, k, v) = _qkv(2)
    jstate, tstate = _states(rng, 0.9)
    want = JA.edit_self_attention(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                                  JEditConfig(mode="edit", method="tca"), jstate,
                                  block_index, place)
    got = A.edit_self_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                EditConfig(mode="edit", method="tca"), tstate,
                                block_index, place)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seq", [64, 16, 4, 1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("flash_mode", ["1", "0"])
def test_masked_sdpa_matches_jax(seq, masked, flash_mode, monkeypatch):
    """Ragged lengths (the tiny config's S in {64, 16, 4, 1}).  JAX's
    Pallas route pads S to 128 and masks the padded keys, so a row whose
    real keys are all masked spreads over the padding there; the port and
    JAX's einsum route exclude padded keys.  Rows keep one live key in the
    Pallas comparison and may be fully masked in the einsum one."""
    monkeypatch.setattr(JA, "FLASH_MODE", flash_mode)
    rng, (q, k, v) = _qkv(3, b=2, seq=seq)
    rows = None
    if masked:
        rows = (rng.random((2, seq)) > 0.5).astype(np.float32)
        if flash_mode == "1":
            rows[:, 0] = 1.0
        else:
            rows[1] = 0.0
    want = JA.masked_sdpa(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                          None if rows is None else jnp.asarray(rows))
    FA.reset_launch_counts()
    got = A.masked_sdpa(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                        None if rows is None else torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert not any(FA.LAUNCHES.values())  # CPU tensors: the twin


@pytest.mark.parametrize("b", [3, 4])
def test_edit_cross_attention_local_cfg_matches_jax(b):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(b, SEQ, HEADS * DIM)).astype(np.float32)
    k = rng.normal(size=(b, 77, HEADS * DIM)).astype(np.float32)
    v = rng.normal(size=(b, 77, HEADS * DIM)).astype(np.float32)
    jstate, tstate = _states(rng, 0.5)
    want = JA.edit_cross_attention(*(jnp.asarray(x) for x in (q, k, v)), HEADS,
                                   JEditConfig(mode="edit", method="tca"), jstate)
    got = A.edit_cross_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                 EditConfig(mode="edit", method="tca"), tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_parity_layout_matches_jax():
    rng, (q, _, _) = _qkv(5)
    per_token = (rng.random(SEQ) > 0.5).astype(np.float32)
    sp = A._split_parity(torch.from_numpy(q), HEADS)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(JA._split_parity(jnp.asarray(q), HEADS)))
    assert torch.equal(A._merge_parity(sp, HEADS), torch.from_numpy(q))
    np.testing.assert_array_equal(
        A._parity_rows(torch.from_numpy(per_token), 3).numpy(),
        np.asarray(JA._parity_rows(jnp.asarray(per_token), 3)),
    )
    for b in (3, 4):
        x = rng.normal(size=(b, 2, 2)).astype(np.float32)
        np.testing.assert_array_equal(A._ref_stream_gather(torch.from_numpy(x)).numpy(),
                                      np.asarray(JA._ref_stream_gather(jnp.asarray(x))))
    with pytest.raises(ValueError):
        A._ref_stream_gather(torch.zeros(2, 2, 2))


def test_sdpa_and_key_bias_match_jax():
    rng, (q, k, v) = _qkv(6, b=2)
    rows = (rng.random((2, SEQ)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(A.key_bias(torch.from_numpy(rows)).numpy(),
                                  np.asarray(JA.key_bias(jnp.asarray(rows))))
    want = JA.sdpa(*(jnp.asarray(x) for x in (q, k, v)), HEADS, JA.key_bias(jnp.asarray(rows)))
    got = A.sdpa(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                 A.key_bias(torch.from_numpy(rows)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_unported_modes_raise():
    """Every JAX mode is ported: drag, design and geodiff, the baselines'
    (tests/test_torch_{region_drag,design_edit,geo_diffuser}.py), beside
    bggen, compose, ssa and sdsa (tests/test_torch_bggen.py,
    tests/test_torch_compose.py).  A mode or method outside JAX's is an
    error."""
    for mode in ("drag", "design", "geodiff"):
        assert EditConfig(mode=mode, method=None).mode == mode
    for mode in ("xyz", "warp"):
        with pytest.raises(ValueError):
            EditConfig(mode=mode, method=None)
    with pytest.raises(ValueError):
        EditConfig(mode="edit", method="xyz")
    assert EditConfig(mode="bggen", method="sdsa").uses_share_attention
