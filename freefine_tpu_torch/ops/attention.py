"""Edit-aware attention for the PyTorch port (mirrors
`freefine_tpu.ops.attention` for the 'none' and 'edit' modes).

All functions take q, k, v of shape [B, S, E] with E = heads * head_dim
and return [B, Sq, E].  Masks are per-key [B, Sk] rows (rank-1 additive
biases) and per-query rows (output blends); no S x S mask is built.

Routing: every self-attention goes through a kernel wrapper of
`ops.flash_attention` (`masked_sdpa` -> `flash_sdpa_diff`, the TCA layers
-> `tca_flash`), which runs the CUDA kernel on a CUDA tensor and the plain
twin on a CPU tensor.  `flash_sdpa_diff` is the plain `flash_sdpa` kernel
outside differentiation and the forward-with-logsumexp and backward kernels
under it (energy guidance differentiates the plain UNet).  Text
cross-attention (`sdpa`) is plain math, as in the JAX package, where it is
left to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from freefine_tpu_torch.edit import TCA_SCOPE, EditConfig, EditState
from freefine_tpu_torch.ops.flash_attention import NEG_INF, flash_sdpa_diff, tca_flash


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D]."""
    b, s, e = x.shape
    return x.reshape(b, s, heads, e // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def key_bias(key_mask: torch.Tensor) -> torch.Tensor:
    """Per-key 0/1 mask [B, Sk] -> additive bias [B, 1, 1, Sk]
    (0 -> -1e9, 1 -> 0)."""
    return (key_mask[:, None, None, :] - 1.0) * -NEG_INF


def sdpa(q, k, v, heads: int, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention with float32 logits and softmax; the
    probabilities are cast to v's dtype before the P.V product (f32 sum).
    bias broadcastable to [B, H, Sq, Sk]."""
    dtype = q.dtype
    qh, kh, vh = split_heads(q, heads), split_heads(k, heads), split_heads(v, heads)
    scale = 1.0 / float(torch.sqrt(torch.tensor(float(qh.shape[-1]), dtype=torch.float32)))
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(vh.dtype)
    out = torch.matmul(probs.float(), vh.float())
    return merge_heads(out).to(dtype)


def masked_sdpa(q, k, v, heads: int, key_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention with an optional per-key [B, Sk] 0/1 mask, through the
    differentiable `flash_sdpa_diff` at every sequence length."""
    rows = None if key_rows is None else key_rows.float().contiguous()
    return flash_sdpa_diff(q.contiguous(), k.contiguous(), v.contiguous(), rows, heads=heads)


def _tca_fused(q, k_self, v_self, k_mod, v_mod, fg_rows, tq_rows, ecg: float, heads: int):
    """Fused TCA: ecg*(tq*attn_fg + (1-tq)*attn_bg) + (1-ecg)*self."""
    return tca_flash(
        q.contiguous(), k_self.contiguous(), v_self.contiguous(), k_mod.contiguous(),
        v_mod.contiguous(), fg_rows.float().contiguous(), tq_rows.float().contiguous(),
        float(ecg), heads=heads,
    )


# Stream index of the reference K/V source per edit-layout batch size:
#   4-stream [u_e, u_r, c_e, c_r] -> [u_r, u_r, c_r, c_r] (legacy layout);
#   3-stream [u_e, r, c_e]        -> [r, r, r]  (deduped layout).
_REF_GATHER = {3: (1, 1, 1), 4: (1, 1, 3, 3)}


def _ref_stream_gather(x: torch.Tensor) -> torch.Tensor:
    """K/V replacement: every stream attends to the reference stream of its
    CFG half (reference `cross_manner_attention_modulate`)."""
    if x.shape[0] not in _REF_GATHER:
        raise ValueError(
            "edit attention expects the deduped 3-stream [u_e, r, c_e] or legacy "
            f"4-stream [u_e, u_r, c_e, c_r] batch layout, got batch {x.shape[0]}"
        )
    return x[list(_REF_GATHER[x.shape[0]])]


# -- head-parity mask layout (reference-exact) ------------------------------
#
# The reference consumes its per-stream masks per (batch*head) row after
# torch `.repeat(heads, ...)` tiles the [m, 1, m, 1] pattern, while
# `head_to_batch_dim` orders rows batch-major.  With an even head count the
# effective mask is head parity: even heads take the masked/modulated path,
# odd heads unmasked reference-key attention, in every stream (the
# repeat-vs-repeat_interleave bug, replicated on purpose).  Heads are
# regrouped into two virtual batch blocks [even-head streams; odd-head
# streams] so the per-row masks and the fused kernel apply unchanged.


def _split_parity(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [2B, S, (H/2)*D]: even-head halves, then odd."""
    b, s, e = x.shape
    d = e // heads
    xh = x.reshape(b, s, heads // 2, 2, d)
    return torch.cat(
        [xh[:, :, :, 0].reshape(b, s, -1), xh[:, :, :, 1].reshape(b, s, -1)], dim=0
    )


def _merge_parity(x: torch.Tensor, heads: int) -> torch.Tensor:
    """Inverse of `_split_parity`: [2B, S, (H/2)*D] -> [B, S, H*D]."""
    b2, s, e2 = x.shape
    b = b2 // 2
    d = e2 // (heads // 2)
    xe = x[:b].reshape(b, s, heads // 2, 1, d)
    xo = x[b:].reshape(b, s, heads // 2, 1, d)
    return torch.cat([xe, xo], dim=3).reshape(b, s, -1)


def _parity_rows(per_token: torch.Tensor, b: int) -> torch.Tensor:
    """[S] mask -> [2B, S] rows: even-head block masked, odd-head block
    unmasked."""
    return torch.cat(
        [per_token[None].expand(b, -1), torch.ones_like(per_token)[None].expand(b, -1)], dim=0
    )


def _check_parity_heads(heads: int) -> None:
    if heads % 2:
        raise ValueError(
            "reference-exact TCA masking is head-parity interleaved and needs an "
            f"even head count, got {heads}"
        )


def _effective_cg(cfg: EditConfig, state: EditState) -> float:
    """ecg = share_gate * context_guidance (tca) or share_gate (mmsa)."""
    cg = float(state.context_guidance) if cfg.method == "tca" else 1.0
    return float(state.share_gate) * cg


def edit_self_attention(q, k, v, heads: int, cfg: EditConfig, state: Optional[EditState],
                        block_index: int, place: str) -> torch.Tensor:
    """Self-attention dispatch by editing mode (modes none / edit)."""
    if cfg.mode == "none" or cfg.method is None or state is None:
        return masked_sdpa(q, k, v, heads)
    if place not in TCA_SCOPE or not cfg.block_gated(block_index):
        return masked_sdpa(q, k, v, heads)
    if cfg.mode == "edit":
        return _tca_edit(q, k, v, heads, cfg, state)
    raise NotImplementedError(f"edit mode {cfg.mode!r} is not ported yet")


def _tca_edit(q, k, v, heads: int, cfg: EditConfig, state: EditState) -> torch.Tensor:
    """Temporal-contextual attention, edit mode (reference attention.py:
    1043-1091).  Every stream attends to the reference stream of its CFG
    half; even heads composite an FG- and a BG-restricted reference
    attention by the target mask, odd heads take unmasked reference-key
    attention; both blend with self-attention by context guidance."""
    _check_parity_heads(heads)
    b, seq, _ = q.shape
    fg_ref = state.fg_ref[seq].to(q.device)
    tgt = state.fg_retain[seq].to(q.device)
    kc, vc = _ref_stream_gather(k), _ref_stream_gather(v)
    if cfg.method == "tca":
        tgt = (tgt > 0).float()  # binarised (attention.py:1071)

    qp, kp, vp = (_split_parity(x, heads) for x in (q, k, v))
    kcp, vcp = _split_parity(kc, heads), _split_parity(vc, heads)
    rows_fg = _parity_rows(fg_ref, b)
    rows_tgt = _parity_rows(tgt, b)
    fused = _tca_fused(qp, kp, vp, kcp, vcp, rows_fg, rows_tgt,
                       _effective_cg(cfg, state), heads // 2)
    return _merge_parity(fused, heads)


def edit_cross_attention(q, k, v, heads: int, cfg: EditConfig,
                         state: Optional[EditState]) -> torch.Tensor:
    """Text cross-attention with local CFG (edit mode, reference
    modulate_local_cross_attn): the conditional edit stream is localised to
    the edit region, out = [u_e, u_r, local*c_e + (1-local)*u_e (, u_r)]."""
    if cfg.mode == "none" or not cfg.local_cfg or state is None:
        return sdpa(q, k, v, heads)
    seq = q.shape[1]
    local = state.local_region[seq].to(q.device)[:, None]
    h = sdpa(q, k, v, heads)
    u_e, u_r, c_e = h[0], h[1], h[2]
    mod_c_e = (local * c_e.float() + (1.0 - local) * u_e.float()).to(h.dtype)
    if q.shape[0] == 3:
        return torch.stack([u_e, u_r, mod_c_e])
    return torch.stack([u_e, u_r, mod_c_e, u_r])
