"""The port's differentiable attention on the CPU: the plain twins of the
three flash-VJP kernels against the JAX package's Pallas kernels run in
interpret mode at blocks of 64 (`_flash_fwd_lse`, `_flash_sdpa_bwd`), and
`flash_sdpa_diff` gradients against `jax.vjp(flash_sdpa_diff)` and against
torch autograd through `flash_sdpa_reference`.

Tolerances: float32 forward out within 3e-5 absolute and lse within 1e-4
(streaming vs materialised softmax); float32 gradients within 1e-4 of
max|ref| (summation order only); bfloat16 within 3e-2 absolute (one bf16
rounding of the probabilities and of each output).

A fully masked row (every key masked) is special in the JAX VJP: its
logits all round to -1e9, the saved lse rounds to -1e9 too (an f32 ulp
there is 64), so the recomputed P is 1 for every key and its gradients are
Sk times those of autograd through the materialised softmax.  The port
recomputes P in the same order and keeps JAX's values; those rows are held
to JAX and to finiteness, not to autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.ops.flash_attention import _flash_fwd_lse as j_fwd_lse
from freefine_tpu.ops.flash_attention import _flash_sdpa_bwd as j_bwd
from freefine_tpu.ops.flash_attention import flash_sdpa_diff as j_flash_sdpa_diff
from freefine_tpu_torch.ops import flash_attention as FA
from torch_spy import spy

torch.set_num_threads(2)

B, S, HEADS, D = 2, 128, 2, 16
CASES = ["unmasked", "random_mask", "fully_masked_rows", "cross_len"]


def _inputs(case, seed=1):
    rng = np.random.default_rng(seed)
    sk = 2 * S if case == "cross_len" else S
    q = rng.normal(size=(B, S, HEADS * D)).astype(np.float32)
    k = rng.normal(size=(B, sk, HEADS * D)).astype(np.float32)
    v = rng.normal(size=(B, sk, HEADS * D)).astype(np.float32)
    do = rng.normal(size=(B, S, HEADS * D)).astype(np.float32)
    mask = np.ones((B, sk), np.float32)
    if case in ("random_mask", "fully_masked_rows", "cross_len"):
        mask = (rng.random((B, sk)) > 0.5).astype(np.float32)
    if case == "fully_masked_rows":
        mask[1] = 0.0
    return q, k, v, do, mask


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _same(a, b):
    return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_fwd_lse_twin_matches_pallas(case, monkeypatch):
    q, k, v, _, mask = _inputs(case)
    out, lse = j_fwd_lse(*_j(q, k, v, mask), HEADS, 64, 64)
    got_out, got_lse = FA.flash_sdpa_fwd_lse_reference(*_t(q, k, v, mask), heads=HEADS)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (B, HEADS, S)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=3e-5, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0].reshape(B, HEADS, S),
                               atol=1e-4, rtol=0)
    # the plain forward is the same function of the same inputs: both twins
    # take their output as _attend(_logits(q, k, bias), v) ...
    logits = spy(monkeypatch, FA, "_logits")
    attends = spy(monkeypatch, FA, "_attend")
    twin = spy(monkeypatch, FA, "flash_sdpa_fwd_lse_reference")
    plain = FA.flash_sdpa_reference(*_t(q, k, v, mask), heads=HEADS)
    wrapped = FA.flash_sdpa_fwd_lse(*_t(q, k, v, mask), heads=HEADS)
    assert len(logits) == len(attends) == 2
    assert all(_same(a, b) for a, b in zip(logits[0][0], logits[1][0]))
    for (args, _, result), (_, _, lg) in zip(attends, logits):
        assert args[0] is lg and torch.equal(args[1], torch.from_numpy(v))
    assert torch.equal(plain, attends[0][2].to(plain.dtype))
    assert torch.equal(wrapped[0], attends[1][2].to(plain.dtype))
    # ... and the wrapper on CPU returns the twin's own result
    assert len(twin) == 1 and wrapped is twin[0][2]


@pytest.mark.parametrize("case", CASES)
def test_bwd_twin_matches_pallas(case, monkeypatch):
    """Fed the same residuals (JAX's own out and lse)."""
    q, k, v, do, mask = _inputs(case, seed=2)
    jq, jk, jv, jm = _j(q, k, v, mask)
    out, lse = j_fwd_lse(jq, jk, jv, jm, HEADS, 64, 64)
    want = j_bwd(HEADS, 64, 64, (jq, jk, jv, jm, out, lse), jnp.asarray(do))
    tl = torch.from_numpy(np.array(lse)[..., 0].reshape(B, HEADS, S))
    args = (*_t(q, k, v, mask), torch.from_numpy(np.array(out)), tl)
    got = FA.flash_sdpa_bwd_reference(*args, torch.from_numpy(do), heads=HEADS)
    for g, w in zip(got, want[:3]):
        _close(g, w)
    assert not np.asarray(want[3]).any()  # the mask's cotangent in JAX is zero
    # the wrapper on CPU returns the twins' own results, which match JAX too
    dq = spy(monkeypatch, FA, "flash_sdpa_bwd_dq_reference")
    dkv = spy(monkeypatch, FA, "flash_sdpa_bwd_dkv_reference")
    wrapped = FA.flash_sdpa_bwd(*args, torch.from_numpy(do), heads=HEADS)
    assert wrapped[0] is dq[0][2] and all(a is b for a, b in zip(wrapped[1:], dkv[0][2]))
    for g, w in zip(wrapped, want[:3]):
        _close(g, w)


def test_bwd_twin_bf16_matches_pallas():
    q, k, v, do, mask = _inputs("random_mask", seed=3)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jm = jnp.asarray(mask)
    out, lse = j_fwd_lse(jq, jk, jv, jm, HEADS, 64, 64)
    want = j_bwd(HEADS, 64, 64, (jq, jk, jv, jm, out, lse), jdo)

    def tb(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).bfloat16()

    tl = torch.from_numpy(np.array(lse)[..., 0].reshape(B, HEADS, S))
    got = FA.flash_sdpa_bwd_reference(tb(jq), tb(jk), tb(jv), torch.from_numpy(mask), tb(out),
                                      tl, tb(jdo), heads=HEADS)
    for g, w in zip(got, want[:3]):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=3e-2,
                                   rtol=0)


def _diff_grads(q, k, v, mask, do):
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    tm = torch.from_numpy(mask).requires_grad_()
    out = FA.flash_sdpa_diff(tq, tk, tv, tm, heads=HEADS)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    return out, tq.grad, tk.grad, tv.grad, tm.grad


@pytest.mark.parametrize("case", CASES)
def test_flash_sdpa_diff_grads_match_jax_vjp(case):
    q, k, v, do, mask = _inputs(case, seed=4)
    want_out, pull = jax.vjp(lambda a, b, c: j_flash_sdpa_diff(a, b, c, jnp.asarray(mask), HEADS,
                                                                64, 64), *_j(q, k, v))
    want = pull(jnp.asarray(do))
    out, gq, gk, gv, gm = _diff_grads(q, k, v, mask, do)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=3e-5, rtol=0)
    for g, w in zip((gq, gk, gv), want):
        _close(g, w)
    assert gm is None  # the mask gets no gradient


@pytest.mark.parametrize("case", ["unmasked", "random_mask", "cross_len"])
def test_flash_sdpa_diff_grads_match_autograd_of_reference(case):
    q, k, v, do, mask = _inputs(case, seed=5)
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    FA.flash_sdpa_reference(tq, tk, tv, torch.from_numpy(mask), heads=HEADS).backward(
        torch.from_numpy(do))
    _, gq, gk, gv, _ = _diff_grads(q, k, v, mask, do)
    for g, w in zip((gq, gk, gv), (tq.grad, tk.grad, tv.grad)):
        _close(g, w.numpy())


def test_fully_masked_rows_give_finite_grads_scaled_by_key_count():
    q, k, v, do, mask = _inputs("fully_masked_rows", seed=6)
    _, gq, gk, gv, _ = _diff_grads(q, k, v, mask, do)
    assert all(torch.isfinite(g).all() for g in (gq, gk, gv))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    FA.flash_sdpa_reference(tq, tk, tv, torch.from_numpy(mask), heads=HEADS).backward(
        torch.from_numpy(do))
    # row block 1 is fully masked: S times autograd's gradient there (see
    # the module docstring); row block 0 is partly masked and agrees
    _close(gq[1] / S, tq.grad[1].numpy())
    _close(gv[1] / S, tv.grad[1].numpy())
    _close(gq[0], tq.grad[0].numpy())


def test_flash_sdpa_diff_without_grad_is_the_plain_kernel(monkeypatch):
    q, k, v, _, _ = _inputs("unmasked", seed=7)
    tq, tk, tv = _t(q, k, v)
    FA.reset_launch_counts()
    plain = spy(monkeypatch, FA, "flash_sdpa")
    out = FA.flash_sdpa_diff(tq, tk, tv, heads=HEADS)
    assert out.grad_fn is None
    assert len(plain) == 1 and out is plain[0][2]
    with torch.no_grad():
        assert FA.flash_sdpa_diff(tq.requires_grad_(), tk, tv, heads=HEADS) is plain[1][2]
    assert len(plain) == 2 and not any(FA.LAUNCHES.values())


def test_backward_accepts_non_contiguous_f32_cotangent(monkeypatch):
    """JAX casts the cotangent to q's dtype; the port also makes it
    contiguous (a transposed view reaches the kernel as a copy)."""
    q, k, v, do, _ = _inputs("unmasked", seed=8)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v))
    out = FA.flash_sdpa_diff(tq, tk, tv, heads=HEADS)
    g = torch.from_numpy(np.ascontiguousarray(do.transpose(1, 0, 2))).transpose(0, 1)
    assert not g.is_contiguous() and g.dtype == torch.float32
    dq = spy(monkeypatch, FA, "flash_sdpa_bwd_dq")
    dkv = spy(monkeypatch, FA, "flash_sdpa_bwd_dkv")
    gq, gk, gv = torch.autograd.grad(out, (tq, tk, tv), g)
    # both backward kernels got the cotangent as q's dtype, contiguous, same values
    for calls in (dq, dkv):
        do_in = calls[0][0][4]
        assert do_in.dtype == torch.bfloat16 and do_in.is_contiguous()
        assert torch.equal(do_in, g.contiguous().bfloat16())
    assert gq is dq[0][2] or torch.equal(gq, dq[0][2])
    for a in (gq, gk, gv):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
