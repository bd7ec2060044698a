"""The port's differentiable TCA on the CPU: the plain twins of the three
TCA-VJP kernels against the JAX package's Pallas kernels run in interpret
mode at blocks of 64 (`_tca_fwd_lse`, `_tca_diff_bwd`); `tca_flash_diff`
gradients against `jax.vjp(tca_flash_diff)` and against torch autograd
through `tca_flash_reference`; the edit self-attention dispatch and the
tiny UNet's latent gradient in mode "edit" against `jax.grad` with
`FLASH_MODE = "1"`; the dispatch and the launch counters.

Layout: B = 4 rows as after the head-parity split (rows 0-1 the even-head
block, 2-3 the odd one), S = 128, 2 heads of 16.  Cases: random masks; the
parity layout (odd block fg = tq = 1, so its BG pass masks every key with
weight 0); a fully masked FG row (no fg key in batch row 0, weight
cg * tq != 0); bggen-style tq = 1; and, for the checks of the bf16
kernels' shortcuts, "blocks" (the parity layout with tq 1 on rows
[S/4, S/2) of the even block and 0 elsewhere, as an object's rows give it:
one 64-row tile with FG dead).

The bf16 backward kernels (csrc/tca_flash_bwd.cu) skip the exponentials
of a pass whose weight is 0 over a 64-query tile, and take one exponential
per k_mod logit where the row's live logsumexps are real; the twin-level
identities those shortcuts rest on are held here bit for bit.

Tolerances: float32 forward composite and partials within 3e-5 absolute,
logsumexps within 1e-4 (streaming vs materialised softmax); float32
gradients within 1e-4 of max|ref| (summation order only); bfloat16
gradients within 3e-2 absolute (one bf16 rounding of the probabilities and
of each output); the dispatch gradient 5e-4 absolute, as JAX's own
`test_dispatch_tca_grad_through_flash`; the tiny UNet 1e-3 of max|ref|
(float32 through about 40 layers, XLA vs ATen).

A fully masked row is special in the VJP (as for the flash VJP, see
tests/test_torch_flash_grad.py): its logits and lse all round to -1e9, the
recomputed P is 1 per key, and where its weight is not 0 (an FG row with
no fg key) its gradients are Sk times those of autograd through the
materialised softmax.  The port keeps JAX's values: those rows are held to
JAX and to finiteness, not to autograd.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.edit import build_mask_pyramid as j_build_mask_pyramid
from freefine_tpu.models.unet import UNet2DCondition as JUNet
from freefine_tpu.ops import attention as JA
from freefine_tpu.ops.flash_attention import _tca_diff_bwd as j_bwd
from freefine_tpu.ops.flash_attention import _tca_fwd_lse as j_fwd_lse
from freefine_tpu.ops.flash_attention import tca_flash_diff as j_tca_flash_diff
from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_pyramid
from freefine_tpu_torch.ops import attention as A
from freefine_tpu_torch.ops import flash_attention as FA
from test_torch_weights import jax_params, tiny_modules
from torch_spy import spy

torch.set_num_threads(2)

B, S, HEADS, D = 4, 128, 2, 16
CG = 0.7
CASES = ["random", "parity", "empty_fg", "bggen"]
SKIP_CASES = ["random", "parity", "bggen", "empty_fg", "blocks"]


def _inputs(case, seed):
    """q, k_self, v_self, k_mod, v_mod, dO [B, S, H*D] and fg, tq [B, S]."""
    rng = np.random.default_rng(seed)
    q, ks, vs, km, vm, do = (rng.normal(size=(B, S, HEADS * D)).astype(np.float32)
                             for _ in range(6))
    fg = (rng.random((B, S)) > 0.5).astype(np.float32)
    tq = (rng.random((B, S)) > 0.4).astype(np.float32)
    if case == "random":
        tq = rng.random((B, S)).astype(np.float32)  # soft per-query weights
    else:
        fg[B // 2:] = 1.0
        tq[B // 2:] = 1.0
    if case == "empty_fg":
        fg[0] = 0.0
    if case == "bggen":
        tq[:] = 1.0
    if case == "blocks":
        tq[: B // 2] = 0.0
        tq[: B // 2, S // 4 : S // 2] = 1.0
    return (q, ks, vs, km, vm, fg, tq), do


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _unheads(x):
    """JAX's per-head [B*H, S, d] (or [B*H, S, 1]) -> the port's layout."""
    x = np.asarray(x, np.float32)
    if x.shape[-1] == 1:
        return x[..., 0].reshape(B, HEADS, S)
    return x.reshape(B, HEADS, S, D).transpose(0, 2, 1, 3).reshape(B, S, HEADS * D)


def _close(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(), rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_residuals(case):
    """The case's inputs and JAX's forward with residuals (shared by the
    forward and backward twin tests)."""
    ops, do = _inputs(case, 1)
    jops = _j(*ops)
    out, res = j_fwd_lse(*jops, jnp.float32(CG), HEADS, 64, 64)
    return ops, do, jops, out, res


@pytest.mark.parametrize("case", CASES)
def test_fwd_lse_twin_matches_pallas(case, monkeypatch):
    ops, _, _, out, res = _jax_residuals(case)
    calls = spy(monkeypatch, FA, "tca_flash_fwd_lse_reference")
    got = FA.tca_flash_fwd_lse(*_t(*ops), CG, heads=HEADS)
    assert len(calls) == 1 and got is calls[0][2]  # the CPU wrapper returns the twin's result
    got_out, parts, lse = got
    assert parts.shape == (3, B, S, HEADS * D) and lse.shape == (3, B, HEADS, S)
    assert parts.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out), atol=3e-5, rtol=0)
    for i in range(3):
        np.testing.assert_allclose(parts[i].numpy(), _unheads(res[i]), atol=3e-5, rtol=0)
        np.testing.assert_allclose(lse[i].numpy(), _unheads(res[3 + i]), atol=1e-4, rtol=0)
    masked = (lse == FA.NEG_INF).sum(dim=(2, 3)).tolist()
    # fully masked rows: the parity layout's odd block in the BG pass (and
    # the FG pass of the empty batch row), each logsumexp exactly -1e9
    want_masked = {"random": [0, 0, 0], "parity": [0, 0, 2 * HEADS * S],
                   "empty_fg": [0, HEADS * S, 2 * HEADS * S], "bggen": [0, 0, 2 * HEADS * S]}
    assert [sum(m) for m in masked] == want_masked[case]


@pytest.mark.parametrize("case", CASES)
def test_bwd_twins_match_pallas(case, monkeypatch):
    """Fed the same residuals (JAX's own partials and logsumexps)."""
    ops, do, jops, _, res = _jax_residuals(case)
    want = j_bwd(HEADS, 64, 64, (*jops, jnp.float32(CG), *res), jnp.asarray(do))
    parts = torch.from_numpy(np.stack([_unheads(r) for r in res[:3]]))
    lse = torch.from_numpy(np.stack([_unheads(r) for r in res[3:]]))
    dq_calls = spy(monkeypatch, FA, "tca_flash_bwd_dq_reference")
    dkv_calls = spy(monkeypatch, FA, "tca_flash_bwd_dkv_reference")
    got = FA.tca_flash_bwd(*_t(*ops), CG, parts, lse, torch.from_numpy(do), heads=HEADS)
    # the CPU wrappers return the twins' own results
    assert got[0] is dq_calls[0][2] and all(a is b for a, b in zip(got[1:], dkv_calls[0][2]))
    for g, w in zip(got, want[:5]):
        _close(g, w)
    assert not any(np.asarray(z).any() for z in want[5:])  # masks and cg: zero in JAX
    # the backward's row sums: rowsum(o_x * dO) times the pass's weight
    delta = dq_calls[0][0][10]
    rowsum = np.einsum("absgd,bsgd->abgs", parts.numpy().reshape(3, B, S, HEADS, D),
                       do.reshape(B, S, HEADS, D))
    tqh = ops[6][:, None, :]  # per query, shared by the heads of its batch row
    weights = np.stack([np.full_like(tqh, 1.0 - CG), CG * tqh, CG * (1.0 - tqh)])
    np.testing.assert_allclose(delta.numpy(), rowsum * weights, atol=1e-4, rtol=0)


def test_bwd_twin_bf16_matches_pallas():
    ops, do = _inputs("parity", 3)
    jops = [jnp.asarray(x, jnp.bfloat16) for x in ops[:5]] + _j(*ops[5:])
    out, res = j_fwd_lse(*jops, jnp.float32(CG), HEADS, 64, 64)
    jdo = jnp.asarray(do, jnp.bfloat16)
    want = j_bwd(HEADS, 64, 64, (*jops, jnp.float32(CG), *res), jdo)

    def tb(x):
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).bfloat16()

    parts = torch.from_numpy(np.stack([_unheads(r) for r in res[:3]]))
    lse = torch.from_numpy(np.stack([_unheads(r) for r in res[3:]]))
    got = FA.tca_flash_bwd_reference(*(tb(x) for x in jops[:5]), *_t(*ops[5:]), CG, parts, lse,
                                     tb(jdo), heads=HEADS)
    for g, w in zip(got, want[:5]):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=3e-2,
                                   rtol=0)


def _diff_grads(ops, do, dtype=torch.float32):
    leaves = [x.to(dtype).requires_grad_() for x in _t(*ops[:5])]
    fg, tq = (x.requires_grad_() for x in _t(*ops[5:]))
    out = FA.tca_flash_diff(*leaves, fg, tq, CG, heads=HEADS)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do).to(dtype))
    assert fg.grad is None and tq.grad is None  # the masks get no gradient
    return out, [x.grad for x in leaves]


def _jax_vjp(ops, do, dtype=jnp.float32):
    fg, tq = _j(*ops[5:])
    out, pull = jax.vjp(lambda *a: j_tca_flash_diff(*a, fg, tq, jnp.float32(CG), HEADS, 64, 64),
                        *(jnp.asarray(x, dtype) for x in ops[:5]))
    return out, pull(jnp.asarray(do, dtype))


@pytest.mark.parametrize("case", CASES)
def test_tca_flash_diff_grads_match_jax_vjp(case):
    ops, do = _inputs(case, 4)
    want_out, want = _jax_vjp(ops, do)
    out, grads = _diff_grads(ops, do)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=3e-5, rtol=0)
    for g, w in zip(grads, want):
        _close(g, w)


def test_tca_flash_diff_bf16_matches_jax_vjp():
    ops, do = _inputs("parity", 5)
    _, want = _jax_vjp(ops, do, jnp.bfloat16)
    _, grads = _diff_grads(ops, do, torch.bfloat16)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), atol=3e-2,
                                   rtol=0)


@pytest.mark.parametrize("case", ["random", "parity", "bggen", "empty_fg"])
def test_tca_flash_diff_grads_match_autograd_of_reference(case):
    """Everywhere but the fully masked FG row block (batch row 0 of
    "empty_fg"), which keeps JAX's values (module docstring)."""
    ops, do = _inputs(case, 6)
    leaves = [x.requires_grad_() for x in _t(*ops[:5])]
    FA.tca_flash_reference(*leaves, *_t(*ops[5:]), CG, heads=HEADS).backward(
        torch.from_numpy(do))
    _, grads = _diff_grads(ops, do)
    rows = slice(1, None) if case == "empty_fg" else slice(None)
    for g, w in zip(grads, leaves):
        assert torch.isfinite(g).all()
        _close(g[rows], w.grad[rows].numpy())
    if case == "empty_fg":  # P = 1 per key in row block 0: not autograd's values
        assert not np.allclose(grads[0][0].numpy(), leaves[0].grad[0].numpy(), atol=1e-2)


def _states(rng, seq, mode):
    fg = (rng.random(seq) > 0.5).astype(np.float32)
    tgt = rng.random(seq).astype(np.float32)
    local = (rng.random(seq) > 0.5).astype(np.float32)
    if mode == "bggen":
        tgt = (tgt > 0.5).astype(np.float32)  # the removed object
    j = JEditState(fg_ref={seq: jnp.asarray(fg)}, fg_retain={seq: jnp.asarray(tgt)},
                   local_region={seq: jnp.asarray(local)}, context_guidance=jnp.float32(0.6))
    t = EditState(fg_ref={seq: torch.from_numpy(fg)}, fg_retain={seq: torch.from_numpy(tgt)},
                  local_region={seq: torch.from_numpy(local)}, context_guidance=0.6)
    return j, t


@pytest.mark.parametrize("mode", ["edit", "bggen"])
def test_edit_self_attention_grad_matches_jax(mode, monkeypatch):
    """jax.grad through the TCA dispatch with the Pallas route forced, as
    tests/test_flash_attention.py::test_dispatch_tca_grad_through_flash
    takes it, against torch autograd through the port's dispatch (its
    `_tca_fused` -> `tca_flash_diff`)."""
    monkeypatch.setattr(JA, "FLASH_MODE", "1")
    seq, heads = 64, 4
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(3, seq, heads * D)).astype(np.float32) for _ in range(3))
    jstate, tstate = _states(rng, seq, mode)

    def jloss(q, k, v):
        out = JA.edit_self_attention(q, k, v, heads, JEditConfig(mode=mode, method="tca"),
                                     jstate, 12, "up")
        return jnp.sum(out ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    calls = spy(monkeypatch, FA.TCAFlash, "apply")
    out = A.edit_self_attention(*leaves, heads, EditConfig(mode=mode, method="tca"), tstate, 12,
                                "up")
    (out ** 2).sum().backward()
    assert len(calls) == 1  # the gated layer went through the differentiable TCA
    for g, w in zip(leaves, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=5e-4, rtol=0)


def test_tiny_unet_edit_latent_grad_matches_jax(monkeypatch):
    """The latent gradient of a fixed-cotangent loss on the edit streams'
    eps, one tiny UNet pass in mode "edit" over [u_e, r, c_e], against
    jax.grad through `unet.apply` with the same converted weights.  JAX's
    TCA layers take the Pallas route that `FLASH_MODE = "1"` gives them
    (`_tca_fused` -> `tca_flash_diff`, interpret mode); its other attention
    takes the einsum route, whose gradient the flash VJP's equals
    (tests/test_flash_attention.py).  The gradient is compiled as a whole:
    run eagerly it takes twice as long."""
    monkeypatch.setattr(JA, "FLASH_MODE", "0")
    routed = []

    def pallas_tca(q, k_self, v_self, k_mod, v_mod, fg_rows, tq_rows, ecg, heads):
        routed.append(q.shape)
        return j_tca_flash_diff(q, k_self, v_self, k_mod, v_mod, fg_rows, tq_rows,
                                jnp.asarray(ecg, jnp.float32), heads)

    monkeypatch.setattr(JA, "_tca_fused", pallas_tca)
    cfg, mods = tiny_modules(11)
    jcfg = jax_tiny_config()
    jparams = jax_params(mods["unet"], "unet", jcfg)
    lh, lw = cfg.latent_height, cfg.latent_width
    rng = np.random.default_rng(8)
    lat = rng.normal(size=(2, lh, lw, 4)).astype(np.float32)
    ctx = rng.normal(size=(3, 77, cfg.unet.cross_attention_dim)).astype(np.float32)
    w = rng.normal(size=(2, lh, lw, 4)).astype(np.float32)
    fg_retain = np.zeros((cfg.height, cfg.width), np.float32)
    fg_retain[20:44, 16:40] = 1
    fg_ref = np.zeros((cfg.height, cfg.width), np.float32)
    fg_ref[8:30, 24:52] = 1
    cg, t = 0.375, 501
    jstate = JEditState(fg_retain=j_build_mask_pyramid(jnp.asarray(fg_retain), lh, lw),
                        fg_ref=j_build_mask_pyramid(jnp.asarray(fg_ref), lh, lw),
                        local_region=j_build_mask_pyramid(jnp.asarray(fg_retain), lh, lw),
                        context_guidance=jnp.float32(cg))
    junet = JUNet(config=jcfg.unet)

    def jloss(x):
        sample = jnp.concatenate([x, jnp.asarray(lat[1:]), x])
        eps = junet.apply(jparams, sample, jnp.int32(t), jnp.asarray(ctx),
                          edit_cfg=JEditConfig(mode="edit", method="tca"), edit_state=jstate)
        return jnp.sum(eps[jnp.array([0, 2])] * jnp.asarray(w))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(lat[:1])))
    assert len(routed) == 6  # the six gated layers of the TCA window
    state = EditState(fg_retain=build_mask_pyramid(torch.from_numpy(fg_retain), lh, lw),
                      fg_ref=build_mask_pyramid(torch.from_numpy(fg_ref), lh, lw),
                      local_region=build_mask_pyramid(torch.from_numpy(fg_retain), lh, lw),
                      context_guidance=cg)
    x = torch.from_numpy(lat[:1]).requires_grad_()
    sample = torch.cat([x, torch.from_numpy(lat[1:]), x]).permute(0, 3, 1, 2)
    calls = spy(monkeypatch, FA.TCAFlash, "apply")
    eps = mods["unet"](sample, t, torch.from_numpy(ctx), edit_cfg=EditConfig(
        mode="edit", method="tca"), edit_state=state).permute(0, 2, 3, 1)
    (eps[[0, 2]] * torch.from_numpy(w)).sum().backward()
    assert len(calls) == 6  # the six gated layers of the TCA window
    _close(x.grad, want, rel=1e-3)


@pytest.mark.parametrize("kernel", ["tca_flash_fwd_lse", "tca_flash_bwd_dq",
                                    "tca_flash_bwd_dkv"])
def test_raw_kernels_refuse_grad_mode(kernel):
    ops, do = _inputs("parity", 9)
    args = _t(*ops)
    parts, lse = FA.tca_flash_fwd_lse(*args, CG, heads=HEADS)[1:]
    delta = FA.tca_row_deltas(parts, torch.from_numpy(do), args[6], CG, heads=HEADS)
    rest = () if kernel == "tca_flash_fwd_lse" else (torch.from_numpy(do), lse, delta)
    fn = getattr(FA, kernel)
    leaf = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward.*tca_flash_diff"):
        fn(leaf, *args[1:], CG, *rest, heads=HEADS)
    with torch.no_grad():
        fn(leaf, *args[1:], CG, *rest, heads=HEADS)


def test_tca_flash_diff_outside_differentiation_is_tca_flash(monkeypatch):
    """No grad mode, or no operand that requires grad: the plain
    `tca_flash` (one call, its result returned as it is), never
    `TCAFlash`; under differentiation `TCAFlash` and never `tca_flash`."""
    ops, _ = _inputs("parity", 10)
    args = _t(*ops)
    plain = spy(monkeypatch, FA, "tca_flash")
    diff = spy(monkeypatch, FA.TCAFlash, "apply")
    out = FA.tca_flash_diff(*args, CG, heads=HEADS)
    assert len(plain) == 1 and out is plain[0][2] and out.grad_fn is None
    leaf = args[0].clone().requires_grad_()
    with torch.no_grad():
        out = FA.tca_flash_diff(leaf, *args[1:], CG, heads=HEADS)
    assert len(plain) == 2 and out is plain[1][2] and not diff
    out = FA.tca_flash_diff(leaf, *args[1:], CG, heads=HEADS)
    assert len(plain) == 2 and len(diff) == 1 and out.grad_fn is not None


def test_cpu_calls_never_count_launches():
    assert {"tca_flash_fwd_lse", "tca_flash_bwd_dq", "tca_flash_bwd_dkv"} <= set(FA.KERNELS)
    FA.reset_launch_counts()
    ops, do = _inputs("random", 11)
    leaves = [x.requires_grad_() for x in _t(*ops[:5])]
    FA.tca_flash_diff(*leaves, *_t(*ops[5:]), CG, heads=HEADS).backward(torch.from_numpy(do))
    with torch.no_grad():
        FA.tca_flash_diff(*leaves, *_t(*ops[5:]), CG, heads=HEADS)
    assert set(FA.LAUNCHES) == set(FA.KERNELS)
    assert FA.LAUNCHES == {name: 0 for name in FA.KERNELS} and not FA.LAUNCH_SHAPES


def test_wrappers_reject_bad_operands():
    ops, do = _inputs("parity", 12)
    args = _t(*ops)
    tdo = torch.from_numpy(do)
    lse = torch.zeros(3, B, HEADS, S)
    for fn in (FA.tca_flash_bwd_dq, FA.tca_flash_bwd_dkv):
        with pytest.raises(ValueError):  # logsumexps of one pass only
            fn(*args, CG, tdo, lse[0], lse, heads=HEADS)
        with pytest.raises(ValueError):  # dO in another dtype than q
            fn(*args, CG, tdo.double(), lse, lse, heads=HEADS)
    with pytest.raises(ValueError):
        FA.tca_flash_fwd_lse(*args[:6], args[6][:, 1:], CG, heads=HEADS)
    with pytest.raises(ValueError):
        FA.tca_flash_fwd_lse(*args, CG, heads=3)


def _residual_tensors(case):
    """The case's operands, dO, and JAX's partials and logsumexps (interpret
    mode) in the port's layout, with the backward's row sums."""
    ops, do, _, _, res = _jax_residuals(case)
    args = _t(*ops)
    parts = torch.from_numpy(np.stack([_unheads(r) for r in res[:3]]))
    lse = torch.from_numpy(np.stack([_unheads(r) for r in res[3:]]))
    tdo = torch.from_numpy(do)
    delta = FA.tca_row_deltas(parts, tdo, args[6], CG, heads=HEADS)
    return args, tdo, lse, delta


def _grads_from_probs(probs, args, tdo, delta):
    terms = FA.tca_grad_terms(probs, args[2], args[4], args[6], CG, tdo, delta, heads=HEADS)
    return (FA.tca_dq_from_terms(terms, args[0], args[1], args[3], heads=HEADS),
            *FA.tca_dkv_from_terms(terms, args[0], tdo, *args[1:5], heads=HEADS))


@pytest.mark.parametrize("case", SKIP_CASES)
def test_tile_skipping_twin_equals_the_full_twin(case):
    """Point 3 of the bf16 kernels: the twin with each dead pass's P zeroed
    over its 64-query tiles (`tca_dead_passes`), and with P zeroed on every
    row whose pass weight is 0 (the kernels give such rows lse = +inf),
    gives dQ, dK and dV bit for bit."""
    args, tdo, lse, delta = _residual_tensors(case)
    want = (FA.tca_flash_bwd_dq_reference(*args, CG, tdo, lse, delta, heads=HEADS),
            *FA.tca_flash_bwd_dkv_reference(*args, CG, tdo, lse, delta, heads=HEADS))
    probs = FA.tca_probs(args[0], args[1], args[3], args[5], lse, heads=HEADS)
    dead = FA.tca_dead_passes(args[6]).repeat_interleave(FA.TCA_TILE_ROWS, dim=1)[:, :S]
    assert bool(dead.any()) == (case != "random")  # soft tq: no tile is dead
    skipped = [p.masked_fill(dead[:, None, :, None, x], 0.0) for x, p in enumerate(probs)]
    # what is skipped is not already zero (the odd block's BG P is 1 per key)
    assert all(bool(p[dead[:, None, :, None, x].expand_as(p)].ne(0).any())
               for x, p in enumerate(probs) if dead[..., x].any())
    for got, w in zip(_grads_from_probs(skipped, args, tdo, delta), want):
        assert torch.equal(got, w)
    weights = FA._tca_weights(args[6], CG)[:, :, :, :, None]  # [3, B, 1, S, 1]
    zero_w = [p.masked_fill(weights[x] == 0, 0.0) for x, p in enumerate(probs)]
    for got, w in zip(_grads_from_probs(zero_w, args, tdo, delta), want):
        assert torch.equal(got, w)


def _mod_probs(case):
    args, _, lse, _ = _residual_tensors(case)
    _, p_fg, p_bg = FA.tca_probs(args[0], args[1], args[3], args[5], lse, heads=HEADS)
    # the one k_mod logit (scaled, unmasked) and the lse of the key's live pass
    logits = FA._logits(args[0], args[3], None, HEADS)
    fg = args[5][:, None, None, :] == 1.0
    lse_sel = torch.where(fg, lse[1][..., None], lse[2][..., None])
    real = (lse[1] > FA.TCA_REAL_LSE) & (lse[2] > FA.TCA_REAL_LSE)  # [B, H, S] rows
    return p_fg, p_bg, logits, lse_sel, real


@pytest.mark.parametrize("case", SKIP_CASES)
def test_one_exponential_per_mod_logit_on_real_rows(case):
    """Point 4: on rows whose FG and BG softmaxes are both real, at most
    one of P_fg and P_bg is non-zero per key, and their sum is
    exp(logit - lse_sel) with lse_sel = fg ? lse_fg : lse_bg, bit for bit;
    logsumexps from JAX's `_tca_fwd_lse` in interpret mode."""
    p_fg, p_bg, logits, lse_sel, real = _mod_probs(case)
    assert bool(real.any())
    assert torch.equal((p_fg * p_bg)[real], torch.zeros_like(p_fg[real]))
    assert torch.equal((p_fg + p_bg)[real], torch.exp(logits - lse_sel)[real])


@pytest.mark.parametrize("case", SKIP_CASES)
def test_fully_masked_rows_need_both_exponentials(case):
    """On a fully masked row (a pass's lse is -1e9: the odd block's BG
    rows, the FG rows of "empty_fg") P is 1 per key in that pass and the
    other pass's P is not 0: the identity of point 4 fails on every such
    row, so the kernels take both exponentials there.  The random masks
    have no such row."""
    p_fg, p_bg, logits, lse_sel, real = _mod_probs(case)
    full = ~real
    assert bool(full.any()) == (case != "random")
    both = (p_fg * p_bg).ne(0).any(-1)
    assert bool(both[full].all())
    assert bool((p_fg + p_bg).ne(torch.exp(logits - lse_sel)).any(-1)[full].all())


_CSRC = Path(FA.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("d", range(8, 81, 8))
def test_every_bf16_head_dim_reaches_a_tca_bwd_instantiation(d):
    """The FF_TCA_BWD_CONFIGS table of csrc/tca_flash_bwd.cu, parsed: every
    bf16 head dim the wrappers admit maps to a wgmma instantiation whose
    widths hopper.cuh has, with 64-query dK/dV tiles (the dead-pass unit),
    and the mma.sync kernels are gone."""
    src = (_CSRC / "tca_flash_bwd.cu").read_text()
    table = re.search(r"#define FF_TCA_BWD_CONFIGS\(X\)(.*?)\n\n", src, re.S).group(1)
    rows = [tuple(int(v) for v in m.split(",")) for m in re.findall(r"X\(([^)]*)\)", table)]
    hopper = (_CSRC / "hopper.cuh").read_text()
    ss = {int(n) for n in re.findall(r"struct Wgmma<(\d+)> \{", hopper)}
    rs = {int(n) for n in re.findall(r"struct WgmmaRS<(\d+)> \{", hopper)}
    assert FA._MAX_HEAD_DIM["tca_flash_bwd_dq"][torch.bfloat16] == 80
    assert FA._MAX_HEAD_DIM["tca_flash_bwd_dkv"][torch.bfloat16] == 80
    dk, dv, bk, sk, bk3, sk3, bq, sq, sq3 = next(r for r in rows if d <= r[1])
    assert d <= dv <= dk and dk % 16 == 0 and dv in rs
    assert bk in ss and sk >= 2 and (bk3 == 0 or (bk3 in ss and sk3 >= 2))
    assert bq == FA.TCA_TILE_ROWS and bq in ss and sq >= 2 and (sq3 == 0 or sq3 >= 2)
    assert "mma.sync" not in src and "mma_bf16" not in src
    assert float(re.search(r"kRealLse = ([-0-9.e]+)f;", src).group(1)) == FA.TCA_REAL_LSE
