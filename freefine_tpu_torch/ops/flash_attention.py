"""Attention kernels of the port and their plain PyTorch twins.

  * `flash_sdpa` — streaming softmax attention with an optional per-key
    0/1 mask (CUDA kernel `csrc/flash_sdpa.cu`; replaces the Pallas
    `_flash_kernel`, freefine_tpu/ops/flash_attention.py:80).
  * `tca_flash`  — the fused TCA step: self, FG-masked and BG-masked
    attention in one key sweep, composited by the per-query target mask and
    blended by context guidance (CUDA kernel `csrc/tca_flash.cu`; replaces
    the Pallas `_tca_kernel`, freefine_tpu/ops/flash_attention.py:175).

Layout: q/k/v [B, S, H*D]; masks per batch row [B, S] float32.  Logits,
softmax and accumulation are float32; with bf16 operands the probabilities
are cast to bf16 before the P.V product (f32 accumulation).  A masked key
gets a finite -1e9 bias, so a fully masked row degrades to uniform
attention instead of NaN.

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

LAUNCHES = {"flash_sdpa": 0, "tca_flash": 0}
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


def _attend_f32(q, k, v, bias: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias) v in float32, probabilities cast to
    v's dtype before the product.  bias [B, Sk] or None.  -> [B, Sq, E] f32."""
    b, sq, e = q.shape
    d = e // heads
    qh, kh, vh = _heads(q, heads).float(), _heads(k, heads).float(), _heads(v, heads)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / d**0.5)
    if bias is not None:
        logits = logits + bias[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(vh.dtype).float()
    out = torch.matmul(probs, vh.float())
    return out.transpose(1, 2).reshape(b, sq, e)


def flash_sdpa_reference(q, k, v, key_mask=None, *, heads: int) -> torch.Tensor:
    """Plain twin of `flash_sdpa` (materialises the logits)."""
    bias = None if key_mask is None else (key_mask.float() - 1.0) * -NEG_INF
    return _attend_f32(q, k, v, bias, heads).to(q.dtype)


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
# on the FMA pipes (csrc/flash_sdpa.cu, csrc/tca_flash.cu).
_MAX_HEAD_DIM = {
    "flash_sdpa": {torch.bfloat16: 160, torch.float32: 512},
    "tca_flash": {torch.bfloat16: 80, torch.float32: 160},
}


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


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def _check_rows(name: str, rows: torch.Tensor, b: int, s: int, device) -> None:
    if rows.dtype != torch.float32 or tuple(rows.shape) != (b, s) or rows.device != device:
        raise ValueError(
            f"{name}: mask rows must be float32 [{b}, {s}] on {device}, got "
            f"{rows.dtype} {tuple(rows.shape)} on {rows.device}"
        )


def flash_sdpa(q, k, v, key_mask=None, *, heads: int) -> torch.Tensor:
    """Streaming attention.  q [B, Sq, H*D]; k/v [B, Sk, H*D]; key_mask
    [B, Sk] float32 in {0, 1} (0 = masked out) or None.  -> [B, Sq, H*D]."""
    if k.shape[1] != v.shape[1]:
        raise ValueError("flash_sdpa: k and v lengths differ")
    d = _check_qkv("flash_sdpa", heads, q, k, v)
    if key_mask is not None:
        _check_rows("flash_sdpa", key_mask, q.shape[0], k.shape[1], q.device)
    if q.device.type == "cpu":
        return flash_sdpa_reference(q, k, v, key_mask, heads=heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_sdpa: unsupported device {q.device}")
    limit = _MAX_HEAD_DIM["flash_sdpa"][q.dtype]
    if d % 8 or d > limit:
        raise ValueError(f"flash_sdpa: {q.dtype} head dim {d} must be a multiple of 8, <= {limit}")
    ops = (q, k, v) if key_mask is None else (q, k, v, key_mask)
    _check_cuda("flash_sdpa", *ops)
    lib = cuda_build.library("flash_sdpa")
    out = torch.empty_like(q)
    b, sq, _ = q.shape
    code = lib.flash_sdpa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(), out.data_ptr(),
        b, heads, sq, k.shape[1], d, 1.0 / d**0.5, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, "flash_sdpa", code)
    _count_launch("flash_sdpa", b, heads, sq, k.shape[1], d, q.dtype, key_mask is not None)
    return out


def tca_flash(
    q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance, *, heads: int
) -> torch.Tensor:
    """Fused TCA: cg * (tq*attn_fg + (1-tq)*attn_bg) + (1-cg) * attn_self.

    attn_self over (k_self, v_self); attn_fg / attn_bg over (k_mod, v_mod)
    restricted to fg / 1-fg keys.  q/k/v [B, S, H*D]; fg_key_mask, tq_mask
    [B, S] float32; context_guidance a python float.  -> [B, S, H*D]."""
    d = _check_qkv("tca_flash", heads, q, k_self, v_self, k_mod, v_mod)
    b, s, _ = q.shape
    for t in (k_self, v_self, k_mod, v_mod):
        if t.shape[1] != s:
            raise ValueError("tca_flash: q and k/v sequence lengths differ")
    _check_rows("tca_flash", fg_key_mask, b, s, q.device)
    _check_rows("tca_flash", tq_mask, b, s, q.device)
    if q.device.type == "cpu":
        return tca_flash_reference(
            q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask, context_guidance,
            heads=heads,
        )
    if q.device.type != "cuda":
        raise ValueError(f"tca_flash: unsupported device {q.device}")
    limit = _MAX_HEAD_DIM["tca_flash"][q.dtype]
    if d % 8 or d > limit:
        raise ValueError(f"tca_flash: {q.dtype} head dim {d} must be a multiple of 8, <= {limit}")
    _check_cuda("tca_flash", q, k_self, v_self, k_mod, v_mod, fg_key_mask, tq_mask)
    lib = cuda_build.library("tca_flash")
    out = torch.empty_like(q)
    code = lib.tca_flash_fwd(
        q.data_ptr(), k_self.data_ptr(), v_self.data_ptr(), k_mod.data_ptr(),
        v_mod.data_ptr(), fg_key_mask.data_ptr(), tq_mask.data_ptr(),
        float(context_guidance), out.data_ptr(), b, heads, s, d, 1.0 / d**0.5,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    cuda_build.check(lib, "tca_flash", code)
    _count_launch("tca_flash", b, heads, s, s, d, q.dtype, True)
    return out
