"""Edit-aware attention for the PyTorch port (mirrors
`freefine_tpu.ops.attention` for the 'none', 'edit', 'bggen' and 'compose'
modes and the tca, mmsa, ssa and sdsa methods).

All functions take q, k, v of shape [B, S, E] with E = heads * head_dim
and return [B, Sq, E].  Masks are per-key [B, Sk] rows (rank-1 additive
biases) and per-query rows (output blends); no S x S mask is built.

Routing: every self-attention goes through a kernel wrapper of
`ops.flash_attention` (`masked_sdpa` -> `flash_sdpa_diff`, the TCA layers
-> `tca_flash_diff`; composition and style alignment are `masked_sdpa`
calls with per-key rows), which runs the CUDA kernel on a CUDA tensor and
the plain twin on a CPU tensor.  Each `_diff` function is its plain kernel
(`flash_sdpa`, `tca_flash`) outside differentiation and the
forward-with-logsumexp and backward kernels under it (energy guidance
differentiates the plain UNet; a gradient through the edit UNet reaches
the TCA ones).  Text
cross-attention (`sdpa`) is plain math, as in the JAX package, where it is
left to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from freefine_tpu_torch.edit import STYLE_ALIGN_SCOPE, TCA_SCOPE, EditConfig, EditState
from freefine_tpu_torch.ops.flash_attention import NEG_INF, flash_sdpa_diff, tca_flash_diff


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
    """Fused TCA: ecg*(tq*attn_fg + (1-tq)*attn_bg) + (1-ecg)*self, through
    the differentiable `tca_flash_diff` (the plain kernel outside
    differentiation), as JAX routes it."""
    return tca_flash_diff(
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


def _blend_with_self(modulated: torch.Tensor, self_h: torch.Tensor, cfg: EditConfig,
                     state: EditState) -> torch.Tensor:
    """ecg * modulated + (1 - ecg) * self in float32, in self's dtype."""
    ecg = _effective_cg(cfg, state)
    return (ecg * modulated.float() + (1.0 - ecg) * self_h.float()).to(self_h.dtype)


def edit_self_attention(q, k, v, heads: int, cfg: EditConfig, state: Optional[EditState],
                        block_index: int, place: str) -> torch.Tensor:
    """Self-attention dispatch by editing mode and method."""
    if cfg.mode == "none" or cfg.method is None or state is None:
        return masked_sdpa(q, k, v, heads)
    if cfg.uses_share_attention:
        if place not in STYLE_ALIGN_SCOPE or cfg.mode == "compose":
            return masked_sdpa(q, k, v, heads)
        return _style_align_attention(q, k, v, heads, cfg, state)
    if place not in TCA_SCOPE or not cfg.block_gated(block_index):
        return masked_sdpa(q, k, v, heads)
    if cfg.mode == "edit":
        return _tca_edit(q, k, v, heads, cfg, state)
    if cfg.mode == "bggen":
        return _tca_bggen(q, k, v, heads, cfg, state)
    return _tca_compose(q, k, v, heads, cfg, state)


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


def _tca_bggen(q, k, v, heads: int, cfg: EditConfig, state: EditState) -> torch.Tensor:
    """Background-generation TCA (reference attention.py:1284-1324): even
    heads attend to the reference keys outside the removed object, odd
    heads to all reference keys; blended with self-attention.  The fused
    kernel with FG keys = 1 - obj and tq = 1 is exactly that."""
    _check_parity_heads(heads)
    b, seq, _ = q.shape
    obj = state.fg_retain[seq].to(q.device)
    kc, vc = _ref_stream_gather(k), _ref_stream_gather(v)
    qp, kp, vp = (_split_parity(x, heads) for x in (q, k, v))
    kcp, vcp = _split_parity(kc, heads), _split_parity(vc, heads)
    rows_bg = _parity_rows(1.0 - obj, b)
    ones_tq = torch.ones(2 * b, seq, device=q.device)
    fused = _tca_fused(qp, kp, vp, kcp, vcp, rows_bg, ones_tq,
                       _effective_cg(cfg, state), heads // 2)
    return _merge_parity(fused, heads)


def _tca_compose(q, k, v, heads: int, cfg: EditConfig, state: EditState) -> torch.Tensor:
    """Composition TCA (reference attention.py:1092-1140).  Streams
    [e, r_1..r_N, c_e]: for each source i the two edit streams attend to
    source i's keys inside src_mask_i, weighted per query by tgt_mask_i and
    summed over sources, then blended with self-attention; the reference
    streams stay vanilla.  The N per-source attentions run as one
    `masked_sdpa` over [2N, S]."""
    n = cfg.num_sources
    b, seq, _ = q.shape
    if b != n + 2:
        raise ValueError(f"compose attention expects [e, r_1..r_{n}, c_e], got batch {b}")
    src = state.src_masks[seq].to(q.device)          # [N, S] key masks
    tgt = state.tgt_masks[seq][:n].to(q.device)      # [N, S] query weights

    self_h = masked_sdpa(q, k, v, heads)
    qn = torch.stack([q[0], q[b - 1]]).repeat_interleave(n, dim=0)  # [2N, S, E]
    kn = k[1 : n + 1].repeat(2, 1, 1)
    vn = v[1 : n + 1].repeat(2, 1, 1)
    per_src = masked_sdpa(qn, kn, vn, heads, src.repeat(2, 1))
    w = tgt.repeat(2, 1)[:, :, None]
    summed = (per_src.float() * w).reshape(2, n, seq, -1).sum(1)
    hu_e = _blend_with_self(summed[0], self_h[0], cfg, state)
    hc_e = _blend_with_self(summed[1], self_h[b - 1], cfg, state)
    return torch.cat([hu_e[None], self_h[1 : b - 1], hc_e[None]], dim=0)


def _style_align_attention(q, k, v, heads: int, cfg: EditConfig,
                           state: EditState) -> torch.Tensor:
    """StyleAligned shared attention, ssa/sdsa (reference attention.py:
    1142-1238): keys and values become [own; ref] (Sk = 2 Sq), ref the
    reference stream of each CFG half.  sdsa restricts the appended keys on
    the even heads (head-parity rows, as the TCA masks): in edit mode to the
    source object, in bggen mode to the reference background, own keys
    blocked."""
    seq = q.shape[1]
    k_cat = torch.cat([k, _ref_stream_gather(k)], dim=1)
    v_cat = torch.cat([v, _ref_stream_gather(v)], dim=1)
    if cfg.method != "sdsa":
        return masked_sdpa(q, k_cat, v_cat, heads)
    _check_parity_heads(heads)
    ones = torch.ones(seq, device=q.device)
    if cfg.mode == "bggen":
        allowed = 1.0 - torch.cat([ones, state.fg_retain[seq].to(q.device)])
    else:
        allowed = torch.cat([ones, state.fg_ref[seq].to(q.device)])
    out = masked_sdpa(_split_parity(q, heads), _split_parity(k_cat, heads),
                      _split_parity(v_cat, heads), heads // 2,
                      _parity_rows(allowed, q.shape[0]))
    return _merge_parity(out, heads)


def edit_cross_attention(q, k, v, heads: int, cfg: EditConfig, state: Optional[EditState],
                         k_extra: Optional[torch.Tensor] = None,
                         v_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Text cross-attention with local CFG.

    edit / bggen (reference modulate_local_cross_attn{,_bg}): the
    conditional edit stream is localised to the edit region,
    out = [u_e, u_r, local*c_e + (1-local)*u_e (, u_r)].
    compose (modulate_local_cross_attn_compose): the unconditional streams
    attend to their own text; the conditional edit stream is the sum over
    regions of tgt_mask_i * attn(q_ce, prompt_i), the region prompts' K/V
    passed as k_extra / v_extra [P, 77, E]."""
    if cfg.mode == "none" or not cfg.local_cfg or state is None:
        return sdpa(q, k, v, heads)
    b, seq, _ = q.shape
    if cfg.mode == "compose":
        p = cfg.prompt_length
        if b != cfg.num_sources + 2 or k_extra is None or p < 1:
            raise ValueError("compose cross-attention needs the [e, r_1..r_N, c_e] batch and "
                             "the region prompts' k_extra / v_extra")
        hu = sdpa(q[: b - 1], k[: b - 1], v[: b - 1], heads)
        tgt = state.tgt_masks[seq][:p].to(q.device)               # [P, S]
        per_prompt = sdpa(q[b - 1 : b].expand(p, -1, -1), k_extra, v_extra, heads)
        hc = (per_prompt.float() * tgt[:, :, None]).sum(0)
        return torch.cat([hu, hc[None].to(q.dtype)], dim=0)
    local = state.local_region[seq].to(q.device)[:, None]
    h = sdpa(q, k, v, heads)
    u_e, u_r, c_e = h[0], h[1], h[2]
    mod_c_e = (local * c_e.float() + (1.0 - local) * u_e.float()).to(h.dtype)
    if b == 3:
        return torch.stack([u_e, u_r, mod_c_e])
    return torch.stack([u_e, u_r, mod_c_e, u_r])
