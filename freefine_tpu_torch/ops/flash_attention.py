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

`flash_sdpa` and `tca_flash` are raw kernels with no backward: they raise
when grad mode is on and an operand requires grad, on every device, so no
attention output is ever silently cut from autograd.  Gradients go through
`flash_sdpa_diff`; `tca_flash` has none until its backward is ported.

Layout: q/k/v [B, S, H*D]; masks per batch row [B, S] float32; logsumexp
and the backward's row sums delta [B, H, Sq] float32.  Logits, softmax and
accumulation are float32; with bf16 operands the probabilities are cast to
bf16 before the P.V product (f32 accumulation).  A masked key gets a finite
-1e9 bias added to the scaled logit, so a fully masked row degrades to
uniform attention instead of NaN.

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
           "flash_sdpa_bwd_dkv")
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


def tca_flash_reference(
    q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, *, heads: int
) -> torch.Tensor:
    """Plain twin of `tca_flash`:
    cg * (tq * attn_fg + (1 - tq) * attn_bg) + (1 - cg) * attn_self."""
    fg = fg_key_mask.float()
    o_self = _attend_f32(q, k_self, v_self, None, heads)
    o_fg = _attend_f32(q, k_mod, v_mod, (fg - 1.0) * -NEG_INF, heads)
    o_bg = _attend_f32(q, k_mod, v_mod, fg * NEG_INF, heads)
    tq = tq_mask.float()[:, :, None]
    cg = float(context_guidance)
    out = cg * (tq * o_fg + (1.0 - tq) * o_bg) + (1.0 - cg) * o_self
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Head dims the kernels are built for: bf16 runs on the tensor cores, float32
# on the FMA pipes (csrc/flash_sdpa.cu, csrc/tca_flash.cu, csrc/flash_sdpa_bwd.cu).
_MAX_HEAD_DIM = {
    "flash_sdpa": {torch.bfloat16: 160, torch.float32: 512},
    "flash_sdpa_fwd_lse": {torch.bfloat16: 160, torch.float32: 512},
    "flash_sdpa_bwd_dq": {torch.bfloat16: 160, torch.float32: 128},
    "flash_sdpa_bwd_dkv": {torch.bfloat16: 160, torch.float32: 128},
    "tca_flash": {torch.bfloat16: 80, torch.float32: 160},
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
        b, heads, sq, k.shape[1], d, 1.0 / d**0.5, _DTYPE_CODE[q.dtype], _stream(q),
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
        lse.data_ptr(), b, heads, sq, k.shape[1], d, 1.0 / d**0.5, _DTYPE_CODE[q.dtype],
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
        1.0 / d**0.5, _DTYPE_CODE[q.dtype], _stream(q),
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
        k.shape[1], d, 1.0 / d**0.5, _DTYPE_CODE[q.dtype], _stream(q),
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


def tca_flash(
    q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, *, heads: int
) -> torch.Tensor:
    """Fused TCA: cg * (tq*attn_fg + (1-tq)*attn_bg) + (1-cg) * attn_self.

    attn_self over (k_self, v_self); attn_fg / attn_bg over (k_mod, v_mod)
    restricted to fg / 1-fg keys.  q/k/v [B, S, H*D]; fg_key_mask, tq_mask
    [B, S] float32; context_guidance a python float.  -> [B, S, H*D].
    Not differentiable: its backward kernels are not ported yet."""
    _refuse_grad(
        "tca_flash",
        "tca_flash has no backward until the TCA backward kernels are ported "
        "(ROADMAP B4); call it under torch.no_grad().",
        q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask,
    )
    d = _check_qkv("tca_flash", heads, q, k_self, v_self, k_mod, v_mod)
    b, s, _ = q.shape
    for t in (k_self, v_self, k_mod, v_mod):
        if t.shape[1] != s:
            raise ValueError("tca_flash: q and k/v sequence lengths differ")
    _check_rows("tca_flash", fg_key_mask, (b, s), q.device)
    _check_rows("tca_flash", tq_mask, (b, s), q.device)
    if q.device.type == "cpu":
        return tca_flash_reference(
            q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance,
            heads=heads,
        )
    lib = _cuda_library("tca_flash", "tca_flash", d, q, k_self, v_self, k_mod, v_mod,
                        fg_key_mask, tq_mask)
    out = torch.empty_like(q)
    code = lib.tca_flash_fwd(
        q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(), k_mod.data_ptr(),
        v_mod.data_ptr(), fg_key_mask.data_ptr(), tq_mask.data_ptr(),
        float(context_guidance), out.data_ptr(), b, heads, s, d, 1.0 / d**0.5,
        _DTYPE_CODE[q.dtype], _stream(q),
    )
    cuda_build.check(lib, "tca_flash", code)
    _count_launch("tca_flash", b, heads, s, s, d, q.dtype, True)
    return out
