"""Attention kernels of the port and their plain PyTorch twins.

  * `flash_sdpa` — streaming softmax attention with an optional per-key
    0/1 mask (CUDA kernel `csrc/flash_sdpa.cu`; replaces the Pallas
    `_flash_kernel`, freefine_tpu/ops/flash_attention.py:80).
  * `tca_flash`  — the fused TCA step: self, FG-masked and BG-masked
    attention in one key sweep, composited by the per-query target mask and
    blended by context guidance (CUDA kernel `csrc/tca_flash.cu`; replaces
    the Pallas `_tca_kernel`, freefine_tpu/ops/flash_attention.py:175).
  * `flash_sdpa_fwd_lse` — `flash_sdpa` that also returns the per-row
    logsumexp (`csrc/flash_sdpa.cu`; replaces `_flash_fwd_lse_kernel`, :307).
  * `flash_sdpa_bwd_dq` / `flash_sdpa_bwd_dkv` — the flash backward, each
    recomputing P from the saved logsumexp (`csrc/flash_sdpa_bwd.cu`;
    replace `_flash_bwd_dq_kernel` :344 and `_flash_bwd_dkv_kernel` :378).
    `flash_sdpa_bwd` runs both.
  * `flash_sdpa_diff` — differentiable attention (`FlashSDPA`, the port of
    the JAX custom VJP `flash_sdpa_diff`, :426).
  * `tca_flash_fwd_lse` — `tca_flash` that also returns the three partial
    outputs (float32) and their logsumexps (`csrc/tca_flash.cu`; replaces
    `_tca_fwd_lse_kernel`, :569).
  * `tca_flash_bwd_dq` / `tca_flash_bwd_dkv` — the TCA backward from the
    saved logsumexps and the weighted row sums of `tca_row_deltas`
    (`csrc/tca_flash_bwd.cu`; replace `_tca_bwd_dq_kernel` :636 and
    `_tca_bwd_dkv_kernel` :696).  `tca_flash_bwd` runs both.
  * `tca_flash_diff` — differentiable TCA (`TCAFlash`, the port of the JAX
    custom VJP `tca_flash_diff`, :833).

The raw kernels (every name above but the two `_diff` functions) have no
backward: they raise when grad mode is on and an operand requires grad, on
every device, so no attention output is ever silently cut from autograd.
Gradients go through `flash_sdpa_diff` and `tca_flash_diff`.

Layout: q/k/v [B, S, H*D]; masks per batch row [B, S] float32; logsumexp
and the backward's row sums delta [B, H, Sq] float32 (TCA: [3, B, H, S],
passes self, fg, bg in that order, as the partial outputs [3, B, S, H*D]).
Logits, softmax and accumulation are float32; with bf16 operands the
probabilities are cast to bf16 before the P.V product (f32 accumulation).
A masked key gets a finite -1e9 bias added to the scaled logit, so a fully
masked row degrades to uniform attention instead of NaN.

Dispatch: a tensor on the CPU goes to the plain twin; a CUDA tensor
launches the kernel or raises.  `LAUNCHES` counts kernel launches and
`LAUNCH_SHAPES` the same launches by call shape.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from freefine_tpu_torch.ops import cuda_build

NEG_INF = -1e9

KERNELS = ("flash_sdpa", "tca_flash", "flash_sdpa_fwd_lse", "flash_sdpa_bwd_dq",
           "flash_sdpa_bwd_dkv", "tca_flash_fwd_lse", "tca_flash_bwd_dq", "tca_flash_bwd_dkv")
LAUNCHES = {name: 0 for name in KERNELS}
# (kernel, batch, heads, seq_q, seq_k, head_dim, dtype name, masked) -> launches
LAUNCH_SHAPES: Counter = Counter()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


def _count_launch(name: str, b: int, heads: int, sq: int, sk: int, d: int,
                  dtype: torch.dtype, masked: bool) -> None:
    LAUNCHES[name] += 1
    LAUNCH_SHAPES[(name, b, heads, sq, sk, d, str(dtype).removeprefix("torch."), masked)] += 1


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, e = x.shape
    return x.reshape(b, s, heads, e // heads).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _mask_bias(key_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """[B, Sk] 0/1 mask -> additive bias (0 -> -1e9, 1 -> 0), or None."""
    return None if key_mask is None else (key_mask.float() - 1.0) * -NEG_INF


def _logits(q, k, bias: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """[B, H, Sq, Sk] float32: q k^T scaled first, the per-key bias [B, Sk]
    added second, the order every kernel keeps (forward and backward must
    round a masked logit to the same -1e9)."""
    d = q.shape[2] // heads
    logits = torch.matmul(_heads(q, heads).float(), _heads(k, heads).float().transpose(-1, -2))
    logits = logits * (1.0 / d**0.5)
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    return logits


def _attend(logits: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(logits) v in float32, probabilities cast to v's dtype before
    the product.  -> [B, Sq, E] f32."""
    probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
    return _unheads(torch.matmul(probs, _heads(v, heads).float()))


def _attend_f32(q, k, v, bias: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v; bias [B, Sk] or None.  -> [B, Sq, E] f32."""
    return _attend(_logits(q, k, bias, heads), v, heads)


def flash_sdpa_reference(q, k, v, key_mask=None, *, heads: int) -> torch.Tensor:
    """Plain twin of `flash_sdpa` (materialises the logits)."""
    return _attend_f32(q, k, v, _mask_bias(key_mask), heads).to(q.dtype)


def flash_sdpa_fwd_lse_reference(q, k, v, key_mask=None, *, heads: int):
    """Plain twin of `flash_sdpa_fwd_lse`: (out [B, Sq, E] in q's dtype, the
    same values as `flash_sdpa_reference`; lse [B, H, Sq] float32)."""
    logits = _logits(q, k, _mask_bias(key_mask), heads)
    return _attend(logits, v, heads).to(q.dtype), torch.logsumexp(logits, dim=-1)


def _probs_and_ds(q, k, v, key_mask, do, lse, delta, heads: int):
    """P recomputed from the saved logsumexp, exp(logits - lse), and
    dS = P * (dO V^T - delta); both [B, H, Sq, Sk] float32."""
    p = torch.exp(_logits(q, k, _mask_bias(key_mask), heads) - lse[..., None])
    dp = torch.matmul(_heads(do, heads).float(), _heads(v, heads).float().transpose(-1, -2))
    return p, p * (dp - delta[..., None])


def flash_sdpa_bwd_dq_reference(q, k, v, key_mask, do, lse, delta, *, heads: int):
    """Plain twin of `flash_sdpa_bwd_dq`: dQ = dS K / sqrt(d), in q's dtype."""
    d = q.shape[2] // heads
    _, ds = _probs_and_ds(q, k, v, key_mask, do, lse, delta, heads)
    dq = torch.matmul(ds, _heads(k, heads).float()) * (1.0 / d**0.5)
    return _unheads(dq).to(q.dtype)


def flash_sdpa_bwd_dkv_reference(q, k, v, key_mask, do, lse, delta, *, heads: int):
    """Plain twin of `flash_sdpa_bwd_dkv`: (dK = dS^T Q / sqrt(d),
    dV = P^T dO), in k's and v's dtypes."""
    d = q.shape[2] // heads
    p, ds = _probs_and_ds(q, k, v, key_mask, do, lse, delta, heads)
    dk = torch.matmul(ds.transpose(-1, -2), _heads(q, heads).float()) * (1.0 / d**0.5)
    dv = torch.matmul(p.transpose(-1, -2), _heads(do, heads).float())
    return _unheads(dk).to(k.dtype), _unheads(dv).to(v.dtype)


def row_delta(out: torch.Tensor, do: torch.Tensor, heads: int) -> torch.Tensor:
    """delta = rowsum(out * dO) per head, [B, H, Sq] float32 (plain math on
    every device, as the JAX package leaves it to XLA)."""
    return (_heads(out, heads).float() * _heads(do, heads).float()).sum(-1).contiguous()


def flash_sdpa_bwd_reference(q, k, v, key_mask, out, lse, do, *, heads: int):
    """Plain twin of `flash_sdpa_bwd` -> (dq, dk, dv)."""
    do = do.to(q.dtype)
    delta = row_delta(out, do, heads)
    dq = flash_sdpa_bwd_dq_reference(q, k, v, key_mask, do, lse, delta, heads=heads)
    dk, dv = flash_sdpa_bwd_dkv_reference(q, k, v, key_mask, do, lse, delta, heads=heads)
    return dq, dk, dv


def _tca_logits(q, k_self, k_mod, fg_key_mask, heads: int):
    """The logits of the three TCA passes, [B, H, S, S] float32 each: self
    over k_self; FG over k_mod with the fg = 0 keys biased by -1e9; BG over
    k_mod with the fg = 1 keys biased (JAX's `(fg - 1) * -NEG_INF` and
    `fg * NEG_INF`, added after the scale as the kernels add them)."""
    fg = fg_key_mask.float()
    return (_logits(q, k_self, None, heads), _logits(q, k_mod, (fg - 1.0) * -NEG_INF, heads),
            _logits(q, k_mod, fg * NEG_INF, heads))


def _tca_weights(tq_mask, context_guidance) -> torch.Tensor:
    """Each pass's share of the output per query, [3, B, 1, S] float32:
    (1 - cg), cg * tq, cg * (1 - tq)."""
    tq = tq_mask.float()
    cg = float(context_guidance)
    return torch.stack([torch.full_like(tq, 1.0 - cg), cg * tq, cg * (1.0 - tq)])[:, :, None]


def _tca_composite(parts, tq_mask, context_guidance) -> torch.Tensor:
    """cg * (tq * o_fg + (1 - tq) * o_bg) + (1 - cg) * o_self, float32."""
    o_self, o_fg, o_bg = parts
    tq = tq_mask.float()[:, :, None]
    cg = float(context_guidance)
    return cg * (tq * o_fg + (1.0 - tq) * o_bg) + (1.0 - cg) * o_self


def tca_flash_reference(
    q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, *, heads: int
) -> torch.Tensor:
    """Plain twin of `tca_flash`:
    cg * (tq * attn_fg + (1 - tq) * attn_bg) + (1 - cg) * attn_self."""
    logits = _tca_logits(q, k_self, k_mod, fg_key_mask, heads)
    parts = [_attend(x, v, heads) for x, v in zip(logits, (v_self, v_mod, v_mod))]
    return _tca_composite(parts, tq_mask, context_guidance).to(q.dtype)


def tca_flash_fwd_lse_reference(
    q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, *, heads: int
):
    """Plain twin of `tca_flash_fwd_lse`: (out [B, S, E] in q's dtype, the
    values of `tca_flash_reference`; partial outputs [3, B, S, E] float32;
    logsumexps [3, B, H, S] float32), passes in the order self, fg, bg."""
    logits = _tca_logits(q, k_self, k_mod, fg_key_mask, heads)
    parts = torch.stack([_attend(x, v, heads) for x, v in zip(logits, (v_self, v_mod, v_mod))])
    lse = torch.stack([torch.logsumexp(x, dim=-1) for x in logits])
    return _tca_composite(parts, tq_mask, context_guidance).to(q.dtype), parts, lse


# Query rows per consumer warpgroup of the bf16 `tca_flash` kernel
# (csrc/tca_flash.cu), and per tile of the bf16 TCA backward kernels
# (csrc/tca_flash_bwd.cu): the unit over which they skip a pass.
TCA_TILE_ROWS = 64


def tca_dead_passes(tq_mask: torch.Tensor) -> torch.Tensor:
    """The passes the bf16 `tca_flash` kernel skips, per 64-query tile of
    each batch row, as it decides on the device: [B, ceil(S/64), 3] bool
    (self, fg, bg).  BG where every tq of the tile is 1 (its weight
    cg * (1 - tq) is 0), else FG where every tq is 0; self never; rows past
    S do not count.  `tca_flash_fwd_lse` skips nothing; the bf16 backward
    kernels (`tca_flash_bwd_dq`, `tca_flash_bwd_dkv`) skip the same passes
    per 64-query tile.  Plain math, for the live-pass bounds and the checks
    of chip_smoke.py."""
    b, s = tq_mask.shape
    n = -(-s // TCA_TILE_ROWS)
    pad = n * TCA_TILE_ROWS - s
    tq = tq_mask.float()
    ones = torch.nn.functional.pad(tq, (0, pad), value=1.0).reshape(b, n, -1).eq(1.0).all(-1)
    zeros = torch.nn.functional.pad(tq, (0, pad), value=0.0).reshape(b, n, -1).eq(0.0).all(-1)
    return torch.stack([torch.zeros_like(ones), zeros & ~ones, ones], dim=-1)


# A pass's logsumexp above this is a real softmax's (within a few thousand
# of 0); at or below it, a fully masked row's (-1e9 to f32 rounding).  The
# bf16 TCA backward kernels take one exponential per k_mod logit only where
# every row's live passes are above it (`kRealLse`, csrc/tca_flash_bwd.cu).
TCA_REAL_LSE = -5e8


def tca_row_deltas(parts, do, tq_mask, context_guidance, *, heads: int) -> torch.Tensor:
    """The TCA backward's row sums, [3, B, H, S] float32: rowsum(o_x * dO)
    times each pass's share of the output, (1 - cg), cg * tq and
    cg * (1 - tq), tq per query and shared by the heads of its batch row
    (JAX `_tca_diff_bwd`, :872-879).  Plain math on every device."""
    deltas = torch.stack([row_delta(p, do, heads) for p in parts])
    return (deltas * _tca_weights(tq_mask, context_guidance)).contiguous()


def tca_probs(q, k_self, k_mod, fg_key_mask, lse, *, heads: int):
    """P of the three passes recomputed from the saved logsumexps,
    [self, fg, bg] each [B, H, S, S] float32: exp(logit - lse) of the
    logits of `_tca_logits`.  A fully masked row recomputes P = 1 per key,
    as JAX does."""
    return [torch.exp(x - lse[i][..., None]) for i, x in
            enumerate(_tca_logits(q, k_self, k_mod, fg_key_mask, heads))]


def tca_grad_terms(probs, v_self, v_mod, tq_mask, context_guidance, do, delta, *, heads: int):
    """The backward's per-(query, key) terms from the passes' P (`tca_probs`):
    (P_self * w_self, w_fg * P_fg + w_bg * P_bg, dS_self, dS_mod), each
    [B, H, S, S] float32, with dS_x = P_x * (w_x * dO V^T - delta_x) and
    dS_mod the sum of the FG and BG terms (both read V_mod).  Where a
    pass's weight is 0 (the BG pass of an fg = 1 row) its terms are exactly
    0, whatever its P."""
    p_self, p_fg, p_bg = probs
    w = _tca_weights(tq_mask, context_guidance)[..., None]
    dof = _heads(do, heads).float()
    dp_self = torch.matmul(dof, _heads(v_self, heads).float().transpose(-1, -2))
    dp_mod = torch.matmul(dof, _heads(v_mod, heads).float().transpose(-1, -2))
    ds_self = p_self * (w[0] * dp_self - delta[0][..., None])
    ds_mod = (p_fg * (w[1] * dp_mod - delta[1][..., None])
              + p_bg * (w[2] * dp_mod - delta[2][..., None]))
    return p_self * w[0], w[1] * p_fg + w[2] * p_bg, ds_self, ds_mod


def tca_dq_from_terms(terms, q, k_self, k_mod, *, heads: int):
    """dQ = (dS_self K_self + dS_mod K_mod) / sqrt(d) from `tca_grad_terms`,
    in q's dtype."""
    d = q.shape[2] // heads
    _, _, ds_self, ds_mod = terms
    dq = (torch.matmul(ds_self, _heads(k_self, heads).float())
          + torch.matmul(ds_mod, _heads(k_mod, heads).float())) * (1.0 / d**0.5)
    return _unheads(dq).to(q.dtype)


def tca_dkv_from_terms(terms, q, do, k_self, v_self, k_mod, v_mod, *, heads: int):
    """(dK_self, dV_self, dK_mod, dV_mod) from `tca_grad_terms`:
    dK_x = dS_x^T Q / sqrt(d), dV_x = (weighted P_x)^T dO, in the operands'
    dtypes."""
    d = q.shape[2] // heads
    pw_self, pw_mod, ds_self, ds_mod = terms
    qf, dof = _heads(q, heads).float(), _heads(do, heads).float()
    out = []
    for ds, pw, k, v in ((ds_self, pw_self, k_self, v_self), (ds_mod, pw_mod, k_mod, v_mod)):
        dk = torch.matmul(ds.transpose(-1, -2), qf) * (1.0 / d**0.5)
        dv = torch.matmul(pw.transpose(-1, -2), dof)
        out += [_unheads(dk).to(k.dtype), _unheads(dv).to(v.dtype)]
    return tuple(out)


def tca_flash_bwd_dq_reference(q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask,
                               context_guidance, do, lse, delta, *, heads: int):
    """Plain twin of `tca_flash_bwd_dq`:
    dQ = (dS_self K_self + dS_mod K_mod) / sqrt(d), in q's dtype."""
    probs = tca_probs(q, k_self, k_mod, fg_key_mask, lse, heads=heads)
    terms = tca_grad_terms(probs, v_self, v_mod, tq_mask, context_guidance, do, delta,
                           heads=heads)
    return tca_dq_from_terms(terms, q, k_self, k_mod, heads=heads)


def tca_flash_bwd_dkv_reference(q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask,
                                context_guidance, do, lse, delta, *, heads: int):
    """Plain twin of `tca_flash_bwd_dkv`: (dK_self, dV_self, dK_mod, dV_mod)
    with dK_x = dS_x^T Q / sqrt(d) and dV_x = (weighted P_x)^T dO, in the
    operands' dtypes."""
    probs = tca_probs(q, k_self, k_mod, fg_key_mask, lse, heads=heads)
    terms = tca_grad_terms(probs, v_self, v_mod, tq_mask, context_guidance, do, delta,
                           heads=heads)
    return tca_dkv_from_terms(terms, q, do, k_self, v_self, k_mod, v_mod, heads=heads)


def tca_flash_bwd_reference(q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask,
                            context_guidance, parts, lse, do, *, heads: int):
    """Plain twin of `tca_flash_bwd` -> (dq, dk_self, dv_self, dk_mod, dv_mod)."""
    do = do.to(q.dtype)
    delta = tca_row_deltas(parts, do, tq_mask, context_guidance, heads=heads)
    args = (q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, do, lse,
            delta)
    return (tca_flash_bwd_dq_reference(*args, heads=heads),
            *tca_flash_bwd_dkv_reference(*args, heads=heads))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Kernel routes of `flash_sdpa` and `flash_sdpa_fwd_lse` (csrc/flash_sdpa.cu):
# 0 the float32 kernel with split-TF32 products, 1 the bf16 wgmma kernel with its
# TMA ring.
FLASH_ROUTES = {0: "f32_tf32x3", 1: "bf16_wgmma"}


def flash_route(dtype: torch.dtype, d: int) -> int:
    """The kernel route of a `flash_sdpa` / `flash_sdpa_fwd_lse` call on
    CUDA operands of `dtype` and head dim `d` (a multiple of 8 within
    `_MAX_HEAD_DIM`): bf16 takes the wgmma kernel at every such head dim,
    float32 the split-TF32 kernel."""
    limit = _MAX_HEAD_DIM["flash_sdpa"][dtype]
    if d % 8 or not 0 < d <= limit:
        raise ValueError(f"flash_sdpa: {dtype} head dim {d} must be a multiple of 8, <= {limit}")
    return 1 if dtype == torch.bfloat16 else 0


# Kernel routes of `flash_sdpa_bwd_dq` and `flash_sdpa_bwd_dkv`
# (csrc/flash_sdpa_bwd.cu): 0 the float32 FMA kernels, 1 the bf16 wgmma kernels
# with their TMA rings.
FLASH_BWD_ROUTES = {0: "f32_fma", 1: "bf16_wgmma"}


def flash_bwd_route(dtype: torch.dtype, d: int) -> int:
    """The kernel route of a `flash_sdpa_bwd_dq` / `flash_sdpa_bwd_dkv` call
    on CUDA operands of `dtype` and head dim `d` (a multiple of 8 within
    `_MAX_HEAD_DIM`, the same for both kernels): bf16 takes the wgmma kernels
    at every such head dim, float32 the FMA kernels."""
    limit = _MAX_HEAD_DIM["flash_sdpa_bwd_dq"][dtype]
    if d % 8 or not 0 < d <= limit:
        raise ValueError(
            f"flash_sdpa_bwd: {dtype} head dim {d} must be a multiple of 8, <= {limit}")
    return 1 if dtype == torch.bfloat16 else 0


# Head dims the kernels are built for: bf16 runs on the tensor cores, float32
# on the FMA pipes (csrc/tca_flash.cu, csrc/flash_sdpa_bwd.cu, csrc/tca_flash_bwd.cu)
# or, for flash_sdpa, in split-TF32 products on the tensor cores (csrc/flash_sdpa.cu).
# The flash family takes float32 up to d 512, forward and backward: the SD VAE's
# mid-block attention is one head of 512, and a gradient through `vae.decode`
# reaches the backward kernels at that head dim.
_MAX_HEAD_DIM = {
    "flash_sdpa": {torch.bfloat16: 160, torch.float32: 512},
    "flash_sdpa_fwd_lse": {torch.bfloat16: 160, torch.float32: 512},
    "flash_sdpa_bwd_dq": {torch.bfloat16: 160, torch.float32: 512},
    "flash_sdpa_bwd_dkv": {torch.bfloat16: 160, torch.float32: 512},
    "tca_flash": {torch.bfloat16: 80, torch.float32: 160},
    "tca_flash_fwd_lse": {torch.bfloat16: 80, torch.float32: 160},
    "tca_flash_bwd_dq": {torch.bfloat16: 80, torch.float32: 128},
    "tca_flash_bwd_dkv": {torch.bfloat16: 80, torch.float32: 128},
}


def _refuse_grad(name: str, hint: str, *tensors: Optional[torch.Tensor]) -> None:
    """A raw kernel's output has no grad_fn: under grad mode, an operand
    that requires grad would have its gradient silently cut.  Raise instead,
    on every device."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: called under grad mode on an operand that requires grad, but the "
            f"kernel has no backward and its output would be cut from autograd. {hint}"
        )


def _check_qkv(name: str, heads: int, q: torch.Tensor, *kv: torch.Tensor) -> int:
    """Validate the kernel operands; return the head dim."""
    for t in (q, *kv):
        if t.device != q.device:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: operand dtypes differ ({t.dtype} vs {q.dtype})")
        if t.ndim != 3 or t.shape[0] != q.shape[0] or t.shape[2] != q.shape[2]:
            raise ValueError(f"{name}: expected [B, S, H*D] operands, got {tuple(t.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    e = q.shape[2]
    if e % heads:
        raise ValueError(f"{name}: width {e} not divisible by {heads} heads")
    return e // heads


def _check_rows(name: str, rows: torch.Tensor, shape: tuple, device) -> None:
    if rows.dtype != torch.float32 or tuple(rows.shape) != shape or rows.device != device:
        raise ValueError(
            f"{name}: rows must be float32 {list(shape)} on {device}, got "
            f"{rows.dtype} {tuple(rows.shape)} on {rows.device}"
        )


def _check_flash(name: str, q, k, v, key_mask, heads: int) -> int:
    """Operands of the flash family; returns the head dim."""
    if k.shape[1] != v.shape[1]:
        raise ValueError(f"{name}: k and v lengths differ")
    d = _check_qkv(name, heads, q, k, v)
    if key_mask is not None:
        _check_rows(name, key_mask, (q.shape[0], k.shape[1]), q.device)
    return d


def _check_bwd(name: str, q, do, lse, delta, heads: int) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: dO must match q ({tuple(q.shape)} {q.dtype}), got "
                         f"{tuple(do.shape)} {do.dtype}")
    rows = (q.shape[0], heads, q.shape[1])
    _check_rows(name, lse, rows, q.device)
    _check_rows(name, delta, rows, q.device)


def _cuda_library(name: str, source: str, d: int, *tensors: Optional[torch.Tensor]):
    """The kernel library for CUDA operands, after the checks the kernels
    need (head dim, contiguity, alignment)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    limit = _MAX_HEAD_DIM[name][q.dtype]
    if d % 8 or d > limit:
        raise ValueError(f"{name}: {q.dtype} head dim {d} must be a multiple of 8, <= {limit}")
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    return cuda_build.library(source)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_NO_BACKWARD = "Use flash_sdpa_diff for gradients, or call it under torch.no_grad()."


def flash_sdpa(q, k, v, key_mask=None, *, heads: int) -> torch.Tensor:
    """Streaming attention.  q [B, Sq, H*D]; k/v [B, Sk, H*D]; key_mask
    [B, Sk] float32 in {0, 1} (0 = masked out) or None.  -> [B, Sq, H*D].
    Not differentiable (see `flash_sdpa_diff`)."""
    _refuse_grad("flash_sdpa", _NO_BACKWARD, q, k, v, key_mask)
    d = _check_flash("flash_sdpa", q, k, v, key_mask, heads)
    if q.device.type == "cpu":
        return flash_sdpa_reference(q, k, v, key_mask, heads=heads)
    lib = _cuda_library("flash_sdpa", "flash_sdpa", d, q, k, v, key_mask)
    out = torch.empty_like(q)
    b, sq, _ = q.shape
    code = lib.flash_sdpa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask), out.data_ptr(),
        b, heads, sq, k.shape[1], d, 1.0 / d**0.5, flash_route(q.dtype, d), _stream(q),
    )
    cuda_build.check(lib, "flash_sdpa", code)
    _count_launch("flash_sdpa", b, heads, sq, k.shape[1], d, q.dtype, key_mask is not None)
    return out


def flash_sdpa_fwd_lse(q, k, v, key_mask=None, *, heads: int):
    """`flash_sdpa` that also returns the per-row logsumexp of the masked,
    scaled logits: (out [B, Sq, H*D], lse [B, H, Sq] float32)."""
    _refuse_grad("flash_sdpa_fwd_lse", _NO_BACKWARD, q, k, v, key_mask)
    d = _check_flash("flash_sdpa_fwd_lse", q, k, v, key_mask, heads)
    if q.device.type == "cpu":
        return flash_sdpa_fwd_lse_reference(q, k, v, key_mask, heads=heads)
    lib = _cuda_library("flash_sdpa_fwd_lse", "flash_sdpa", d, q, k, v, key_mask)
    b, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, sq, dtype=torch.float32, device=q.device)
    code = lib.flash_sdpa_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask), out.data_ptr(),
        lse.data_ptr(), b, heads, sq, k.shape[1], d, 1.0 / d**0.5, flash_route(q.dtype, d),
        _stream(q),
    )
    cuda_build.check(lib, "flash_sdpa_fwd_lse", code)
    _count_launch("flash_sdpa_fwd_lse", b, heads, sq, k.shape[1], d, q.dtype,
                  key_mask is not None)
    return out, lse


def flash_sdpa_bwd_dq(q, k, v, key_mask, do, lse, delta, *, heads: int) -> torch.Tensor:
    """dQ of `flash_sdpa` from the saved lse and delta = rowsum(out * dO)
    ([B, H, Sq] float32 each); dO in q's dtype.  -> dq like q."""
    _refuse_grad("flash_sdpa_bwd_dq", _NO_BACKWARD, q, k, v, key_mask, do)
    d = _check_flash("flash_sdpa_bwd_dq", q, k, v, key_mask, heads)
    _check_bwd("flash_sdpa_bwd_dq", q, do, lse, delta, heads)
    if q.device.type == "cpu":
        return flash_sdpa_bwd_dq_reference(q, k, v, key_mask, do, lse, delta, heads=heads)
    lib = _cuda_library("flash_sdpa_bwd_dq", "flash_sdpa_bwd", d, q, k, v, key_mask, do, lse,
                        delta)
    b, sq, _ = q.shape
    dq = torch.empty_like(q)
    code = lib.flash_sdpa_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, heads, sq, k.shape[1], d,
        1.0 / d**0.5, flash_bwd_route(q.dtype, d), _stream(q),
    )
    cuda_build.check(lib, "flash_sdpa_bwd_dq", code)
    _count_launch("flash_sdpa_bwd_dq", b, heads, sq, k.shape[1], d, q.dtype, key_mask is not None)
    return dq


def flash_sdpa_bwd_dkv(q, k, v, key_mask, do, lse, delta, *, heads: int):
    """dK and dV of `flash_sdpa` from the saved lse and delta.  Keys past
    the sequence end do not exist here; masked keys get the gradient of
    their -1e9 logit (zero unless the row is fully masked).  -> (dk, dv)."""
    _refuse_grad("flash_sdpa_bwd_dkv", _NO_BACKWARD, q, k, v, key_mask, do)
    d = _check_flash("flash_sdpa_bwd_dkv", q, k, v, key_mask, heads)
    _check_bwd("flash_sdpa_bwd_dkv", q, do, lse, delta, heads)
    if q.device.type == "cpu":
        return flash_sdpa_bwd_dkv_reference(q, k, v, key_mask, do, lse, delta, heads=heads)
    lib = _cuda_library("flash_sdpa_bwd_dkv", "flash_sdpa_bwd", d, q, k, v, key_mask, do, lse,
                        delta)
    b, sq, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    code = lib.flash_sdpa_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(key_mask), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, heads, sq,
        k.shape[1], d, 1.0 / d**0.5, flash_bwd_route(q.dtype, d), _stream(q),
    )
    cuda_build.check(lib, "flash_sdpa_bwd_dkv", code)
    _count_launch("flash_sdpa_bwd_dkv", b, heads, sq, k.shape[1], d, q.dtype,
                  key_mask is not None)
    return dk, dv


def flash_sdpa_bwd(q, k, v, key_mask, out, lse, do, *, heads: int):
    """The flash backward (JAX `_flash_sdpa_bwd`): dO cast to q's dtype,
    delta = rowsum(out * dO) in plain math, then the dQ and the dK/dV
    kernels, each recomputing P from lse.  -> (dq, dk, dv)."""
    do = do.to(q.dtype).contiguous()
    delta = row_delta(out, do, heads)
    dq = flash_sdpa_bwd_dq(q, k, v, key_mask, do, lse, delta, heads=heads)
    dk, dv = flash_sdpa_bwd_dkv(q, k, v, key_mask, do, lse, delta, heads=heads)
    return dq, dk, dv


class FlashSDPA(torch.autograd.Function):
    """Differentiable `flash_sdpa` (JAX `flash_sdpa_diff`'s custom VJP):
    the forward keeps the logsumexp, the backward recomputes P from it.
    The mask and `heads` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, heads):
        out, lse = flash_sdpa_fwd_lse(q, k, v, key_mask, heads=heads)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.heads = heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_sdpa_bwd(q, k, v, key_mask, out, lse, do, heads=ctx.heads)
        return dq, dk, dv, None, None


def flash_sdpa_diff(q, k, v, key_mask=None, *, heads: int) -> torch.Tensor:
    """Differentiable streaming attention, same arguments and values as
    `flash_sdpa`.  Outside differentiation (no grad mode, or no operand
    that requires grad) it is the plain `flash_sdpa` kernel, as JAX calls
    the primal body; under differentiation the forward with logsumexp and
    the backward kernels (`FlashSDPA`)."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, key_mask)
    ):
        return FlashSDPA.apply(q, k, v, key_mask, heads)
    return flash_sdpa(q, k, v, key_mask, heads=heads)


_NO_TCA_BACKWARD = "Use tca_flash_diff for gradients, or call it under torch.no_grad()."


def _check_tca(name: str, q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask,
               heads: int) -> int:
    """Operands of the TCA family; returns the head dim."""
    d = _check_qkv(name, heads, q, k_self, v_self, k_mod, v_mod)
    b, s, _ = q.shape
    for t in (k_self, v_self, k_mod, v_mod):
        if t.shape[1] != s:
            raise ValueError(f"{name}: q and k/v sequence lengths differ")
    _check_rows(name, fg_key_mask, (b, s), q.device)
    _check_rows(name, tq_mask, (b, s), q.device)
    return d


def tca_flash(
    q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, *, heads: int
) -> torch.Tensor:
    """Fused TCA: cg * (tq*attn_fg + (1-tq)*attn_bg) + (1-cg) * attn_self.

    attn_self over (k_self, v_self); attn_fg / attn_bg over (k_mod, v_mod)
    restricted to fg / 1-fg keys.  q/k/v [B, S, H*D]; fg_key_mask, tq_mask
    [B, S] float32; context_guidance a python float.  -> [B, S, H*D].
    Not differentiable (see `tca_flash_diff`)."""
    tensors = (q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask)
    _refuse_grad("tca_flash", _NO_TCA_BACKWARD, *tensors)
    d = _check_tca("tca_flash", *tensors, heads)
    if q.device.type == "cpu":
        return tca_flash_reference(*tensors, context_guidance, heads=heads)
    lib = _cuda_library("tca_flash", "tca_flash", d, *tensors)
    out = torch.empty_like(q)
    b, s, _ = q.shape
    code = lib.tca_flash_fwd(
        *(t.data_ptr() for t in tensors), float(context_guidance), out.data_ptr(), b, heads, s,
        d, 1.0 / d**0.5, _DTYPE_CODE[q.dtype], _stream(q),
    )
    cuda_build.check(lib, "tca_flash", code)
    _count_launch("tca_flash", b, heads, s, s, d, q.dtype, True)
    return out


def tca_flash_fwd_lse(
    q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, *, heads: int
):
    """`tca_flash` that also returns the residuals of its backward:
    (out [B, S, H*D] in q's dtype; partial outputs [3, B, S, H*D] float32
    and their logsumexps [3, B, H, S] float32, passes self, fg, bg)."""
    tensors = (q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask)
    _refuse_grad("tca_flash_fwd_lse", _NO_TCA_BACKWARD, *tensors)
    d = _check_tca("tca_flash_fwd_lse", *tensors, heads)
    if q.device.type == "cpu":
        return tca_flash_fwd_lse_reference(*tensors, context_guidance, heads=heads)
    lib = _cuda_library("tca_flash_fwd_lse", "tca_flash", d, *tensors)
    b, s, e = q.shape
    out = torch.empty_like(q)
    parts = torch.empty(3, b, s, e, dtype=torch.float32, device=q.device)
    lse = torch.empty(3, b, heads, s, dtype=torch.float32, device=q.device)
    code = lib.tca_flash_fwd_lse(
        *(t.data_ptr() for t in tensors), float(context_guidance), out.data_ptr(),
        parts.data_ptr(), lse.data_ptr(), b, heads, s, d, 1.0 / d**0.5, _DTYPE_CODE[q.dtype],
        _stream(q),
    )
    cuda_build.check(lib, "tca_flash_fwd_lse", code)
    _count_launch("tca_flash_fwd_lse", b, heads, s, s, d, q.dtype, True)
    return out, parts, lse


def _check_tca_bwd(name: str, q, do, lse, delta, heads: int) -> None:
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: dO must match q ({tuple(q.shape)} {q.dtype}), got "
                         f"{tuple(do.shape)} {do.dtype}")
    rows = (3, q.shape[0], heads, q.shape[1])
    _check_rows(name, lse, rows, q.device)
    _check_rows(name, delta, rows, q.device)


def tca_flash_bwd_dq(q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance,
                     do, lse, delta, *, heads: int) -> torch.Tensor:
    """dQ of `tca_flash` from the saved logsumexps and the weighted row
    sums of `tca_row_deltas` ([3, B, H, S] float32 each); dO in q's
    dtype.  -> dq like q."""
    tensors = (q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask)
    _refuse_grad("tca_flash_bwd_dq", _NO_TCA_BACKWARD, *tensors, do)
    d = _check_tca("tca_flash_bwd_dq", *tensors, heads)
    _check_tca_bwd("tca_flash_bwd_dq", q, do, lse, delta, heads)
    if q.device.type == "cpu":
        return tca_flash_bwd_dq_reference(*tensors, context_guidance, do, lse, delta,
                                          heads=heads)
    lib = _cuda_library("tca_flash_bwd_dq", "tca_flash_bwd", d, *tensors, do, lse, delta)
    b, s, _ = q.shape
    dq = torch.empty_like(q)
    code = lib.tca_flash_bwd_dq(
        *(t.data_ptr() for t in tensors), float(context_guidance), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, heads, s, d, 1.0 / d**0.5,
        _DTYPE_CODE[q.dtype], _stream(q),
    )
    cuda_build.check(lib, "tca_flash_bwd_dq", code)
    _count_launch("tca_flash_bwd_dq", b, heads, s, s, d, q.dtype, True)
    return dq


def tca_flash_bwd_dkv(q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance,
                      do, lse, delta, *, heads: int):
    """dK and dV of both key sets of `tca_flash` from the saved logsumexps
    and weighted row sums.  Masks get no gradient; a masked key gets the
    gradient of its -1e9 logit (zero unless its row is fully masked).
    -> (dk_self, dv_self, dk_mod, dv_mod)."""
    tensors = (q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask)
    _refuse_grad("tca_flash_bwd_dkv", _NO_TCA_BACKWARD, *tensors, do)
    d = _check_tca("tca_flash_bwd_dkv", *tensors, heads)
    _check_tca_bwd("tca_flash_bwd_dkv", q, do, lse, delta, heads)
    if q.device.type == "cpu":
        return tca_flash_bwd_dkv_reference(*tensors, context_guidance, do, lse, delta,
                                           heads=heads)
    lib = _cuda_library("tca_flash_bwd_dkv", "tca_flash_bwd", d, *tensors, do, lse, delta)
    b, s, _ = q.shape
    grads = (torch.empty_like(k_self), torch.empty_like(v_self), torch.empty_like(k_mod),
             torch.empty_like(v_mod))
    code = lib.tca_flash_bwd_dkv(
        *(t.data_ptr() for t in tensors), float(context_guidance), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads), b, heads, s, d,
        1.0 / d**0.5, _DTYPE_CODE[q.dtype], _stream(q),
    )
    cuda_build.check(lib, "tca_flash_bwd_dkv", code)
    _count_launch("tca_flash_bwd_dkv", b, heads, s, s, d, q.dtype, True)
    return grads


def tca_flash_bwd(q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance,
                  parts, lse, do, *, heads: int):
    """The TCA backward (JAX `_tca_diff_bwd`): dO cast to q's dtype, the
    weighted row sums in plain math (`tca_row_deltas`), then the dQ and
    the dK/dV kernels, each recomputing P from the saved logsumexps.
    -> (dq, dk_self, dv_self, dk_mod, dv_mod)."""
    do = do.to(q.dtype).contiguous()
    delta = tca_row_deltas(parts, do, tq_mask, context_guidance, heads=heads)
    args = (q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, do, lse,
            delta)
    return (tca_flash_bwd_dq(*args, heads=heads), *tca_flash_bwd_dkv(*args, heads=heads))


class TCAFlash(torch.autograd.Function):
    """Differentiable `tca_flash` (JAX `tca_flash_diff`'s custom VJP): the
    forward keeps the three partial outputs and logsumexps, the backward
    recomputes each pass's P from them.  The masks, cg and `heads` get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance,
                heads):
        out, parts, lse = tca_flash_fwd_lse(q, k_self, v_self, k_mod, v_mod, fg_key_mask,
                                            tq_mask, context_guidance, heads=heads)
        ctx.save_for_backward(q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, parts, lse)
        ctx.context_guidance, ctx.heads = float(context_guidance), heads
        return out

    @staticmethod
    def backward(ctx, do):
        *operands, parts, lse = ctx.saved_tensors
        grads = tca_flash_bwd(*operands, ctx.context_guidance, parts, lse, do, heads=ctx.heads)
        return (*grads, None, None, None, None)


def tca_flash_diff(
    q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, *, heads: int
) -> torch.Tensor:
    """Differentiable fused TCA, same arguments and values as `tca_flash`.
    Outside differentiation (no grad mode, or no operand that requires
    grad) it is the plain `tca_flash` kernel, as JAX calls the primal body;
    under differentiation the forward with the partial outputs and
    logsumexps and the backward kernels (`TCAFlash`)."""
    tensors = (q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return TCAFlash.apply(*tensors, context_guidance, heads)
    return tca_flash(*tensors, context_guidance, heads=heads)
