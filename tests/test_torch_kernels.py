"""The port's kernel modules on the CPU: the plain twins
(`flash_sdpa_reference`, `tca_flash_reference`) and the wrappers'
CPU dispatch, against the JAX package's Pallas kernels run in interpret
mode (`freefine_tpu.ops.flash_attention.flash_sdpa` / `tca_flash`).

Tolerance: 3e-5 absolute in float32 (streaming vs materialised softmax,
as tests/test_flash_attention.py holds the Pallas kernels to the einsum
path); 3e-2 in bfloat16 (one bf16 rounding of the probabilities and of
the output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.ops.flash_attention import flash_sdpa as j_flash_sdpa
from freefine_tpu.ops.flash_attention import tca_flash as j_tca_flash
from freefine_tpu_torch.ops import flash_attention as FA
from torch_spy import spy

torch.set_num_threads(2)

B, S, HEADS, D = 4, 128, 2, 16


def _qkv(seed, sq=S, sk=S, b=B, e=HEADS * D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, e)).astype(np.float32)
    k = rng.normal(size=(b, sk, e)).astype(np.float32)
    v = rng.normal(size=(b, sk, e)).astype(np.float32)
    return rng, q, k, v


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("case", ["unmasked", "random_mask", "fully_masked_rows", "cross_len"])
def test_flash_twin_matches_pallas(case, monkeypatch):
    sk = 2 * S if case == "cross_len" else S
    rng, q, k, v = _qkv(1, sk=sk)
    mask = None
    if case == "random_mask":
        mask = (rng.random((B, sk)) > 0.5).astype(np.float32)
    elif case == "fully_masked_rows":
        mask = (rng.random((B, sk)) > 0.5).astype(np.float32)
        mask[1] = 0.0
        mask[3] = 0.0
    jm = None if mask is None else jnp.asarray(mask)
    want = j_flash_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, heads=HEADS,
                        block_q=64, block_k=64)
    tq, tk, tv = _t(q, k, v)
    tm = None if mask is None else torch.from_numpy(mask)
    got = FA.flash_sdpa_reference(tq, tk, tv, tm, heads=HEADS)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=0)
    # the wrapper on CPU tensors returns the twin's own result (a spy, not a
    # second call compared bit for bit, which would depend on the threading)
    twin = spy(monkeypatch, FA, "flash_sdpa_reference")
    assert FA.flash_sdpa(tq, tk, tv, tm, heads=HEADS) is twin[0][2]


def test_flash_twin_bf16_matches_pallas():
    _, q, k, v = _qkv(2)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = j_flash_sdpa(jq, jk, jv, heads=HEADS, block_q=64, block_k=64)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
                  for x in (jq, jk, jv))
    got = FA.flash_sdpa_reference(tq, tk, tv, heads=HEADS)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2,
                               rtol=0)


def _layout_rows(case):
    """fg and tq rows [B, S] of the parity split as the SD-1.5 paths give
    them, with contiguous object rows so that whole 64-row tiles have tq 0
    or 1 (the tiles where the bf16 kernel skips a pass); the odd block all
    ones.  "edit_layout": fg the source object's rows, tq the target's;
    "bggen_layout": fg = 1 - the object's rows, tq = 1 everywhere."""
    fg = np.ones((B, S), np.float32)
    tq = np.ones((B, S), np.float32)
    obj = np.zeros(S, np.float32)
    obj[40:100] = 1.0
    if case == "edit_layout":
        fg[: B // 2] = obj
        tq[0] = 0.0
        tq[0, 64:] = 1.0  # tiles tq = 0 and tq = 1
        tq[1] = 0.0
        tq[1, 50:] = 1.0  # a mixed tile, then a tq = 1 tile
    else:
        fg[: B // 2] = 1.0 - obj
    return fg, tq


@pytest.mark.parametrize("case", ["random", "parity_rows", "edit_layout", "bggen_layout"])
def test_tca_twin_matches_pallas(case, monkeypatch):
    rng, q, ks, vs = _qkv(3)
    _, _, km, vm = _qkv(4)
    fg = (rng.random((B, S)) > 0.5).astype(np.float32)
    tq = (rng.random((B, S)) > 0.4).astype(np.float32)
    if case == "parity_rows":
        # the odd-head block after the parity split: fg = 1 everywhere, so
        # the BG pass masks every key; tq = 1 gives it weight 0
        fg[B // 2:] = 1.0
        tq[B // 2:] = 1.0
    elif case == "random":
        tq = rng.random((B, S)).astype(np.float32)  # soft per-query weights
    else:
        fg, tq = _layout_rows(case)
    cg = 0.7
    want = j_tca_flash(*(jnp.asarray(x) for x in (q, ks, vs, km, vm, fg, tq)),
                       jnp.float32(cg), heads=HEADS, block_q=64, block_k=64)
    args = _t(q, ks, vs, km, vm, fg, tq)
    got = FA.tca_flash_reference(*args, cg, heads=HEADS)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5, rtol=0)
    twin = spy(monkeypatch, FA, "tca_flash_reference")
    assert FA.tca_flash(*args, cg, heads=HEADS) is twin[0][2]


@pytest.mark.parametrize("case", ["edit_layout", "bggen_layout"])
def test_zero_weight_pass_contributes_nothing(case):
    """The premise of the bf16 kernel's skip: where `tca_dead_passes` finds
    a pass of weight 0 over a 64-row tile, the composite with that pass's
    partial replaced by zeros is the twin's composite bit for bit."""
    _, q, ks, vs = _qkv(3)
    _, _, km, vm = _qkv(4)
    fg, tq = _t(*_layout_rows(case))
    cg = 0.7
    _, parts, _ = FA.tca_flash_fwd_lse_reference(*_t(q, ks, vs, km, vm), fg, tq, cg, heads=HEADS)
    dead = FA.tca_dead_passes(tq).repeat_interleave(FA.TCA_TILE_ROWS, dim=1)[:, :S]
    assert dead[..., 1:].any()  # the layout lets the kernel skip somewhere
    zeroed = parts.clone()
    for p in range(3):
        zeroed[p][dead[..., p]] = 0.0
    want = FA._tca_composite(parts, tq, cg)
    assert torch.equal(FA._tca_composite(zeroed, tq, cg), want)
    # zeroing a live mod pass instead is visible
    swapped = parts.clone()
    swapped[1][dead[..., 2]] = 0.0
    swapped[2][dead[..., 1]] = 0.0
    assert (FA._tca_composite(swapped, tq, cg) - want).abs().max() > 0.1


def test_tca_dead_passes_per_tile():
    # [B = 2, S = 150]: three tiles of 64 rows, the last one 22 rows long
    tq = torch.zeros(2, 150)
    tq[0, 64:128] = 1.0         # tile 1 all ones: BG dead
    tq[0, 128:] = 1.0           # the ragged tile: rows past S do not count
    tq[1, :64] = 0.5            # soft weights: nothing dead
    tq[1, 64:127] = 1.0         # one row of tq = 0 keeps both mod passes
    tq[1, 128:] = 0.0           # FG dead
    dead = FA.tca_dead_passes(tq)
    assert dead.shape == (2, 3, 3) and dead.dtype == torch.bool
    self_, fg, bg = dead.unbind(-1)
    assert not self_.any()
    assert fg.tolist() == [[True, False, False], [False, False, True]]
    assert bg.tolist() == [[False, True, True], [False, False, False]]
    # every row tq = 1: only BG is dead
    assert FA.tca_dead_passes(torch.ones(1, 64)).tolist() == [[[False, False, True]]]


def test_fully_masked_row_is_uniform_attention():
    _, q, k, v = _qkv(5, b=1)
    got = FA.flash_sdpa_reference(*_t(q, k, v), torch.zeros(1, S), heads=HEADS)
    mean_v = torch.from_numpy(v).mean(dim=1, keepdim=True).expand_as(got)
    np.testing.assert_allclose(got.numpy(), mean_v.numpy(), atol=1e-5, rtol=0)


def test_cpu_dispatch_never_counts_launches():
    FA.reset_launch_counts()
    _, q, k, v = _qkv(6)
    args = _t(q, k, v)
    FA.flash_sdpa(*args, heads=HEADS)
    rows = torch.ones(B, S)
    FA.tca_flash(*args, *args[1:], rows, rows, 0.5, heads=HEADS)
    out, lse = FA.flash_sdpa_fwd_lse(*args, heads=HEADS)
    FA.flash_sdpa_bwd(*args, None, out, lse, args[0], heads=HEADS)
    tq, tk, tv = (x.clone().requires_grad_() for x in args)
    FA.flash_sdpa_diff(tq, tk, tv, heads=HEADS).sum().backward()
    assert set(FA.LAUNCHES) == set(FA.KERNELS)
    assert FA.LAUNCHES == {name: 0 for name in FA.KERNELS}
    assert not FA.LAUNCH_SHAPES


@pytest.mark.parametrize("kernel", ["flash_sdpa", "tca_flash"])
def test_raw_kernels_refuse_grad_mode(kernel, monkeypatch):
    """A raw kernel's output has no grad_fn: under grad mode an operand that
    requires grad raises (on the CPU as on the card) instead of cutting the
    gradient; the same call under no_grad is unchanged."""
    _, q, k, v = _qkv(9)
    tq, tk, tv = _t(q, k, v)
    rows = torch.ones(B, S)
    if kernel == "flash_sdpa":
        def call(x):
            return FA.flash_sdpa(x, tk, tv, heads=HEADS)
    else:
        def call(x):
            return FA.tca_flash(x, tk, tv, tk, tv, rows, rows, 0.5, heads=HEADS)
    leaf = tq.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        call(leaf)
    if kernel == "tca_flash":
        with pytest.raises(RuntimeError, match="tca_flash_diff"):
            call(leaf)
    twin = spy(monkeypatch, FA, f"{kernel}_reference")
    with torch.no_grad():
        assert call(leaf) is twin[0][2]


def test_wrapper_rejects_bad_operands():
    _, q, k, v = _qkv(7)
    tq, tk, tv = _t(q, k, v)
    with pytest.raises(ValueError):
        FA.flash_sdpa(tq, tk.double(), tv, heads=HEADS)
    with pytest.raises(ValueError):
        FA.flash_sdpa(tq, tk, tv, heads=3)
    with pytest.raises(ValueError):
        FA.flash_sdpa(tq, tk, tv, torch.ones(B, S, dtype=torch.float64), heads=HEADS)
    with pytest.raises(ValueError):
        FA.tca_flash(tq, tk, tv, tk, tv, torch.ones(B, S), torch.ones(B, S - 1), 0.5,
                     heads=HEADS)


# (dtype, head dim, seq_q, seq_k) of every `flash_sdpa` / `flash_sdpa_fwd_lse`
# call on the SD-1.5 512^2 paths: the UNet's self-attentions in bf16 at each
# resolution (the shapes of chip_smoke.py's FLASH_SHAPES and GRAD_SHAPES) and
# the VAE mid-block's single f32 head
SD15_FLASH_CALLS = [(torch.bfloat16, d, s, s)
                    for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))]
SD15_FLASH_CALLS += [(torch.float32, 512, 4096, 4096)]


@pytest.mark.parametrize("dtype, d, sq, sk", SD15_FLASH_CALLS)
def test_sd15_flash_shapes_take_the_hopper_routes(dtype, d, sq, sk):
    want = "bf16_wgmma" if dtype == torch.bfloat16 else "f32_tf32x3"
    assert FA.FLASH_ROUTES[FA.flash_route(dtype, d)] == want


# (dtype, head dim, seq_q, seq_k) of every `flash_sdpa_bwd_dq` / `_dkv` call
# on the SD-1.5 512^2 paths (the shapes of chip_smoke.py's GRAD_SHAPES):
# the self-attentions upstream of the energy taps and outside the TCA window
SD15_FLASH_BWD_CALLS = [(torch.bfloat16, d, s, s)
                        for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160))]


@pytest.mark.parametrize("dtype, d, sq, sk", SD15_FLASH_BWD_CALLS)
def test_sd15_flash_bwd_shapes_take_the_wgmma_route(dtype, d, sq, sk):
    assert FA.FLASH_BWD_ROUTES[FA.flash_bwd_route(dtype, d)] == "bf16_wgmma"


@pytest.mark.parametrize("kernel", ["flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"])
def test_vae_mid_block_bwd_takes_the_f32_fma_route(kernel):
    """A gradient through `vae.decode` reaches the backward kernels at the
    VAE mid-block's single f32 head of 512; 520 stays refused."""
    assert FA._MAX_HEAD_DIM[kernel][torch.float32] == 512
    assert FA.FLASH_BWD_ROUTES[FA.flash_bwd_route(torch.float32, 512)] == "f32_fma"
    with pytest.raises(ValueError):
        FA.flash_bwd_route(torch.float32, 520)


@pytest.mark.parametrize("kernel", ["flash_sdpa_bwd_dq", "flash_sdpa_bwd_dkv"])
def test_every_admitted_flash_bwd_head_dim_has_a_route(kernel):
    for dtype, limit in FA._MAX_HEAD_DIM[kernel].items():
        want = "bf16_wgmma" if dtype == torch.bfloat16 else "f32_fma"
        for d in range(8, limit + 1, 8):
            assert FA.FLASH_BWD_ROUTES[FA.flash_bwd_route(dtype, d)] == want
        for d in (limit + 8, 12):
            with pytest.raises(ValueError):
                FA.flash_bwd_route(dtype, d)


@pytest.mark.parametrize("kernel", ["flash_sdpa", "flash_sdpa_fwd_lse"])
def test_every_admitted_flash_head_dim_has_a_route(kernel):
    for dtype, limit in FA._MAX_HEAD_DIM[kernel].items():
        for d in range(8, limit + 1, 8):
            assert FA.flash_route(dtype, d) in FA.FLASH_ROUTES
        for d in (limit + 8, 12):
            with pytest.raises(ValueError):
                FA.flash_route(dtype, d)
