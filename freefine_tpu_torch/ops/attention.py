"""Edit-aware attention for the PyTorch port (mirrors
`freefine_tpu.ops.attention`: the 'none', 'edit', 'bggen' and 'compose'
modes with the tca, mmsa, ssa and sdsa methods, and the baselines' 'drag'
K/V replacement and 'geodiff' attention sharing with its losses).

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
left to XLA.  `geodiff_attention` routes its three self-attentions through
`masked_sdpa` (JAX computes them with the plain `sdpa`, the same function)
so that no [H, S, S] probabilities are kept for the backward; its removal
loss's full probabilities (`_probs_headwise`, at one grid) and its text
cross-attention stay plain.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from freefine_tpu_torch.edit import STYLE_ALIGN_SCOPE, EditConfig, EditState
from freefine_tpu_torch.ops.flash_attention import NEG_INF, flash_sdpa_diff, tca_flash_diff
from freefine_tpu_torch.ops.flow import map_coordinates_linear


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


def _probs(q: torch.Tensor, k: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax attention probabilities [B, H, Sq, Sk] in float32."""
    qh, kh = split_heads(q, heads).float(), split_heads(k, heads).float()
    scale = 1.0 / float(torch.sqrt(torch.tensor(float(qh.shape[-1]), dtype=torch.float32)))
    return torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * scale, dim=-1)


def attention_probs(q: torch.Tensor, k: torch.Tensor, heads: int) -> torch.Tensor:
    """Head-averaged softmax attention probabilities [B, Sq, Sk] in float32:
    what the attention-map instrument (`EditConfig.store_attention`)
    records.  Averaged over heads, as in the JAX package (the reference
    keeps [B*H, Sq, Sk])."""
    return _probs(q, k, heads).mean(dim=1)


def token_attention_maps(q: torch.Tensor, k: torch.Tensor, heads: int,
                         token_select: torch.Tensor) -> torch.Tensor:
    """Head-resolved cross-attention probabilities reduced to selected
    tokens: q [B, Sq, E], k [B, Sk, E], token_select [T, Sk] (one-hot rows,
    zero rows padding) -> [B*H, Sq, T] float32 (`EditConfig.sow_token_attn`)."""
    sel = torch.einsum("bhqk,tk->bhqt", _probs(q, k, heads), token_select.float())
    b, h, s, t = sel.shape
    return sel.reshape(b * h, s, t)


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


# Stream index of the reference K/V source per edit-layout stream count:
#   4-stream [u_e, u_r, c_e, c_r] -> [u_r, u_r, c_r, c_r] (legacy layout);
#   3-stream [u_e, r, c_e]        -> [r, r, r]  (deduped layout);
#   1-stream [r]                  -> [r]  (a standalone reference pass).
_REF_GATHER = {1: (0,), 3: (1, 1, 1), 4: (1, 1, 3, 3)}

# Which streams are edit streams per layout (1 = edit, 0 = reference);
# consulted only under EditConfig.ref_vanilla.
_EDIT_STREAMS = {1: (0,), 3: (1, 0, 1), 4: (1, 0, 1, 0)}


def _num_cases(mask: torch.Tensor) -> int:
    """Cases stacked in a mask pyramid entry: its leading axis, or 1 for an
    entry [S] of one case."""
    return mask.shape[0] if mask.ndim > 1 else 1


def _ref_stream_gather(x: torch.Tensor, cases: int = 1) -> torch.Tensor:
    """K/V replacement: within each case, every stream attends to the
    reference stream of its CFG half (reference
    `cross_manner_attention_modulate`).  x [cases * streams, S, E]."""
    streams = x.shape[0] // cases
    if streams * cases != x.shape[0] or streams not in _REF_GATHER:
        raise ValueError(
            "edit attention expects per case the deduped 3-stream [u_e, r, c_e] or legacy "
            f"4-stream [u_e, u_r, c_e, c_r] batch layout, got batch {x.shape[0]} for "
            f"{cases} case(s)"
        )
    idx = list(_REF_GATHER[streams])
    return x.reshape(cases, streams, *x.shape[1:])[:, idx].reshape(x.shape)


def _reference_kv(k, v, cfg: EditConfig, state: EditState, block_index, cases: int):
    """The keys and values every stream attends to as its reference, and
    whether only the edit streams' even heads are masked.  Shared-reference
    layout: the captured `state.ref_kv` of this layer, broadcast to every
    stream of every case (all of them edit streams)."""
    if cfg.shared_ref:
        if state.ref_kv is None or block_index not in state.ref_kv:
            raise ValueError("the shared_ref layout needs EditState.ref_kv captured at every "
                             f"TCA-gated layer (missing block {block_index})")
        rk, rv = state.ref_kv[block_index]
        return rk[None].to(k.dtype).expand(k.shape), rv[None].to(v.dtype).expand(v.shape), False
    return _ref_stream_gather(k, cases), _ref_stream_gather(v, cases), cfg.ref_vanilla


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


def _parity_rows(per_token: torch.Tensor, b: int, edit_only: bool = False) -> torch.Tensor:
    """[S] mask, or [C, S] per-case masks -> [2B, S] rows over a batch of B
    = C * streams: the even-head block masked (each case's rows by its own
    mask), the odd-head block unmasked.  edit_only (EditConfig.ref_vanilla):
    mask only the edit streams' even heads."""
    rows = per_token.reshape(-1, per_token.shape[-1])
    cases = rows.shape[0]
    ones = torch.ones_like(rows[0])
    if edit_only:
        pattern = _EDIT_STREAMS[b // cases]
        even = torch.stack([rows[c] if e else ones for c in range(cases) for e in pattern])
    else:
        even = rows.repeat_interleave(b // cases, dim=0)
    return torch.cat([even, ones[None].expand(b, -1)], dim=0)


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
    if cfg.mode == "drag":
        return _drag_attention(q, k, v, heads, cfg, state, block_index, place)
    if cfg.mode == "none" or cfg.method is None or state is None:
        return masked_sdpa(q, k, v, heads)
    if cfg.uses_share_attention:
        if place not in STYLE_ALIGN_SCOPE or cfg.mode == "compose":
            return masked_sdpa(q, k, v, heads)
        return _style_align_attention(q, k, v, heads, cfg, state)
    if place not in cfg.tca_scope or not cfg.block_gated(block_index):
        return masked_sdpa(q, k, v, heads)
    if cfg.mode == "edit":
        return _tca_edit(q, k, v, heads, cfg, state, block_index)
    if cfg.mode == "bggen":
        return _tca_bggen(q, k, v, heads, cfg, state, block_index)
    return _tca_compose(q, k, v, heads, cfg, state)


def _drag_attention(q, k, v, heads: int, cfg: EditConfig, state: Optional[EditState],
                    block_index: int, place: str) -> torch.Tensor:
    """Stream K/V replacement (JAX's drag branch): inside `cfg.tca_scope`
    and `layer_range` every stream attends with stream
    `cfg.kv_source_stream`'s K/V (RegionDrag: 1, the hook latent), unless a
    state's `share_gate` is 0; elsewhere plain self-attention.  The source
    stream's K/V are broadcast to the batch and made contiguous, the layout
    the kernel takes."""
    if place not in cfg.tca_scope or not cfg.block_gated(block_index):
        return masked_sdpa(q, k, v, heads)
    if state is not None and not float(state.share_gate) > 0:
        return masked_sdpa(q, k, v, heads)
    src = cfg.kv_source_stream
    return masked_sdpa(q, k[src:src + 1].expand_as(k), v[src:src + 1].expand_as(v), heads)


def _tca_edit(q, k, v, heads: int, cfg: EditConfig, state: EditState,
              block_index: Optional[int] = None) -> torch.Tensor:
    """Temporal-contextual attention, edit mode (reference attention.py:
    1043-1091).  Every stream attends to the reference stream of its CFG
    half; even heads composite an FG- and a BG-restricted reference
    attention by the target mask, odd heads take unmasked reference-key
    attention; both blend with self-attention by context guidance.
    Shared-reference layout (cfg.shared_ref): streams [u_e, c_e] per case,
    the reference K/V from state.ref_kv[block_index]."""
    _check_parity_heads(heads)
    b, seq, _ = q.shape
    fg_ref = state.fg_ref[seq].to(q.device)
    tgt = state.fg_retain[seq].to(q.device)
    kc, vc, edit_only = _reference_kv(k, v, cfg, state, block_index, _num_cases(fg_ref))
    if cfg.method == "tca":
        tgt = (tgt > 0).float()  # binarised (attention.py:1071)

    qp, kp, vp = (_split_parity(x, heads) for x in (q, k, v))
    kcp, vcp = _split_parity(kc, heads), _split_parity(vc, heads)
    rows_fg = _parity_rows(fg_ref, b, edit_only)
    rows_tgt = _parity_rows(tgt, b, edit_only)
    fused = _tca_fused(qp, kp, vp, kcp, vcp, rows_fg, rows_tgt,
                       _effective_cg(cfg, state), heads // 2)
    return _merge_parity(fused, heads)


def _tca_bggen(q, k, v, heads: int, cfg: EditConfig, state: EditState,
               block_index: Optional[int] = None) -> torch.Tensor:
    """Background-generation TCA (reference attention.py:1284-1324): even
    heads attend to the reference keys outside the removed object, odd
    heads to all reference keys; blended with self-attention.  The fused
    kernel with FG keys = 1 - obj and tq = 1 is exactly that.
    Shared-reference layout: streams [u_g, c_g] per case, as `_tca_edit`."""
    _check_parity_heads(heads)
    b, seq, _ = q.shape
    obj = state.fg_retain[seq].to(q.device)
    kc, vc, edit_only = _reference_kv(k, v, cfg, state, block_index, _num_cases(obj))
    qp, kp, vp = (_split_parity(x, heads) for x in (q, k, v))
    kcp, vcp = _split_parity(kc, heads), _split_parity(vc, heads)
    rows_bg = _parity_rows(1.0 - obj, b, edit_only)
    ones_tq = torch.ones(2 * b, seq, device=q.device)
    fused = _tca_fused(qp, kp, vp, kcp, vcp, rows_bg, ones_tq,
                       _effective_cg(cfg, state), heads // 2)
    return _merge_parity(fused, heads)


def _compose_masks(state: EditState, seq: int, device):
    """Compose's per-source key masks [C, N, S] and per-region query masks
    [C, N+1, S] (an unstacked state is one case)."""
    src = state.src_masks[seq].to(device)
    tgt = state.tgt_masks[seq].to(device)
    if src.ndim == 2:
        src, tgt = src[None], tgt[None]
    return src, tgt


def _by_case(x: torch.Tensor, cases: int) -> torch.Tensor:
    """[C * streams, ...] -> [C, streams, ...]."""
    return x.reshape(cases, x.shape[0] // cases, *x.shape[1:])


def _tca_compose(q, k, v, heads: int, cfg: EditConfig, state: EditState) -> torch.Tensor:
    """Composition TCA (reference attention.py:1092-1140).  Streams
    [e, r_1..r_N, c_e] per case: for each source i the two edit streams
    attend to source i's keys inside src_mask_i, weighted per query by
    tgt_mask_i and summed over sources, then blended with self-attention;
    the reference streams stay vanilla.  The per-source attentions of every
    case run as one `masked_sdpa` over [C * 2N, S]."""
    n = cfg.num_sources
    b, seq, _ = q.shape
    src, tgt = _compose_masks(state, seq, q.device)
    cases = src.shape[0]
    if b != cases * (n + 2):
        raise ValueError(f"compose attention expects [e, r_1..r_{n}, c_e] per case, got batch "
                         f"{b} for {cases} case(s)")
    self_h = _by_case(masked_sdpa(q, k, v, heads), cases)
    qc, kc, vc = (_by_case(x, cases) for x in (q, k, v))
    qn = torch.stack([qc[:, 0], qc[:, -1]], dim=1).repeat_interleave(n, dim=1)
    kn = kc[:, 1 : n + 1].repeat(1, 2, 1, 1)
    vn = vc[:, 1 : n + 1].repeat(1, 2, 1, 1)
    per_src = masked_sdpa(*(x.reshape(-1, seq, x.shape[-1]) for x in (qn, kn, vn)), heads,
                          src.repeat(1, 2, 1).reshape(-1, seq))
    w = tgt[:, :n].repeat(1, 2, 1).reshape(-1, seq)[:, :, None]
    summed = (per_src.float() * w).reshape(cases, 2, n, seq, -1).sum(2)
    hu_e = _blend_with_self(summed[:, 0], self_h[:, 0], cfg, state)
    hc_e = _blend_with_self(summed[:, 1], self_h[:, -1], cfg, state)
    return torch.cat([hu_e[:, None], self_h[:, 1:-1], hc_e[:, None]], dim=1).reshape(b, seq, -1)


def _style_align_attention(q, k, v, heads: int, cfg: EditConfig,
                           state: EditState) -> torch.Tensor:
    """StyleAligned shared attention, ssa/sdsa (reference attention.py:
    1142-1238): keys and values become [own; ref] (Sk = 2 Sq), ref the
    reference stream of each CFG half.  sdsa restricts the appended keys on
    the even heads (head-parity rows, as the TCA masks): in edit mode to the
    source object, in bggen mode to the reference background, own keys
    blocked."""
    seq = q.shape[1]
    cases = _num_cases(state.fg_retain[seq])
    k_cat = torch.cat([k, _ref_stream_gather(k, cases)], dim=1)
    v_cat = torch.cat([v, _ref_stream_gather(v, cases)], dim=1)
    if cfg.method != "sdsa":
        return masked_sdpa(q, k_cat, v_cat, heads)
    _check_parity_heads(heads)
    if cfg.mode == "bggen":
        obj = state.fg_retain[seq].to(q.device)
        allowed = 1.0 - torch.cat([torch.ones_like(obj), obj], dim=-1)
    else:
        fg = state.fg_ref[seq].to(q.device)
        allowed = torch.cat([torch.ones_like(fg), fg], dim=-1)
    out = masked_sdpa(_split_parity(q, heads), _split_parity(k_cat, heads),
                      _split_parity(v_cat, heads), heads // 2,
                      _parity_rows(allowed, q.shape[0], cfg.ref_vanilla))
    return _merge_parity(out, heads)


# -- GeoDiffuser attention sharing and losses --------------------------------


def _warp_feature_map(x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """A [S, E] token map sampled bilinearly at [h, w, 2] (y, x)
    coordinates, zeros outside (JAX's per-channel `map_coordinates` order
    1, mode constant), in x's dtype."""
    h, w, _ = coords.shape
    m = x.reshape(h, w, -1).permute(2, 0, 1)
    e = m.shape[0]
    yy = coords[..., 0].to(torch.float32).expand(e, h, w)
    xx = coords[..., 1].to(torch.float32).expand(e, h, w)
    out = map_coordinates_linear(m, yy, xx, "constant")
    return out.permute(1, 2, 0).reshape(h * w, -1).to(x.dtype)


def _coord_distance_grid(h: int, w: int, device=None) -> torch.Tensor:
    """[S, S] pairwise distances in affine_grid's normalised coordinates
    (per axis 2 * delta / size), float32."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device) * (2.0 / h),
                            torch.arange(w, dtype=torch.float32, device=device) * (2.0 / w),
                            indexing="ij")
    pts = torch.stack([ys.reshape(-1), xs.reshape(-1)], -1)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    return torch.sqrt(d2 + 1e-12)


def _interpolate_from_mask(feats: torch.Tensor, fg: torch.Tensor, dist: torch.Tensor):
    """Inverse-distance interpolation of feats [S, E] from the 4 nearest
    fg positions -> (interpolated [S, E], distance weights [S]).  The 4
    are the largest inverse distances, ties to the lower index (JAX's
    `lax.top_k`): a stable descending sort."""
    d = dist * 256.0 + 1e5 * (1.0 - fg)[None, :]
    inv = 1.0 / (d + 1e-4)
    vals, idx = torch.sort(inv, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :4], idx[:, :4]
    sel = feats[idx]
    interp = (sel * vals[..., None]).sum(-2) / (vals.sum(-1)[..., None] + 1e-12)
    w = torch.exp(-(1.0 / torch.clamp(vals.amax(-1), min=1e-12)) / 5.0)
    return interp, w


def _box_smooth_tokens(feats: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The 5 x 5 Gaussian smoothing of a [S, E] token map per channel
    (sigma 2/3, the exponent exp(-(d / (2 sigma))^2), normalised, zero
    padding)."""
    d = torch.arange(5, dtype=torch.float32, device=feats.device) - 2.0
    sigma = (5 // 2 * 2) / 6.0
    k1 = torch.exp(-((d / (2.0 * sigma)) ** 2))
    k2 = k1[:, None] * k1[None, :]
    k2 = k2 / k2.sum()
    c = feats.shape[-1]
    m = feats.reshape(1, h, w, c).permute(0, 3, 1, 2)
    out = F.conv2d(m, k2.to(m.dtype).expand(c, 1, 5, 5), padding=2, groups=c)
    return out.permute(0, 2, 3, 1).reshape(feats.shape)


def _probs_headwise(q: torch.Tensor, k: torch.Tensor, heads: int) -> torch.Tensor:
    """Softmax probabilities of batch row 0, [H, Sq, Sk] float32."""
    return _probs(q, k, heads)[0]


def geodiff_attention(q, k, v, heads: int, warp_yx: torch.Tensor, m_obj: torch.Tensor,
                      m_warp: torch.Tensor, share_gate, is_cross: bool, compute_losses: bool,
                      compute_removal: bool, m_amodal: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GeoDiffuser attention sharing for a [base, edit] batch (JAX's
    `geodiff_attention`).  The output the edit should have (`edit_out`,
    no gradient) is the base stream's queries warped by `warp_yx` inside
    the warped object, attending to the base K/V; the edit stream's live
    output (`replace_out`) attends with the base keys (self) or its own
    text keys (cross) to the base values, both held constant.  Losses
    (float32 scalars, with JAX's stop-gradients): sim (L1 over the
    background), movement (L1 over the warped object), smooth (spatial
    gradient L1), at `compute_removal` removal (attention correlation over
    the vacated hole) and, given `m_amodal`, amodal.  The edit output is
    shared inside the warped object while `share_gate` > 0.

    The base stream's attention is taken without a gradient: every path
    from the edit stream's losses to the base stream is cut, so the
    gradient JAX carries through it is zero at the edit latent.
    Self-attention runs `masked_sdpa` (the kernels on the card), text
    cross-attention the plain `sdpa`.  -> ([base_out, edit_out] in q's
    dtype, {loss name: value})."""
    seq = q.shape[1]
    dev = q.device
    m_obj, m_warp = m_obj.to(dev).float(), m_warp.to(dev).float()
    m_wo_edit = torch.clamp(1.0 - m_obj - m_warp, 0.0, 1.0)
    m_inpaint = torch.clamp(m_obj - m_warp, 0.0, 1.0)
    attend = sdpa if is_cross else masked_sdpa
    q_b, q_e = q[0:1], q[1:2]
    k_b, v_b = k[0:1].detach(), v[0:1].detach()

    with torch.no_grad():
        q_warp = _warp_feature_map(q_b[0], warp_yx.to(dev))
        q_ref = (1.0 - m_warp[:, None]) * q_b[0] + m_warp[:, None] * q_warp
        edit_out = attend(q_ref[None].to(q.dtype), k_b, v_b, heads).float()

    k_live = k[1:2] if is_cross else k_b
    replace_out = attend(q_e, k_live, v_b, heads).float()

    losses = {}
    if compute_losses:
        wo = m_wo_edit[None, :, None]
        we = m_warp[None, :, None]
        diff = torch.abs(edit_out - replace_out)
        e = replace_out.shape[-1]
        losses["sim"] = torch.sum(diff * wo) / (torch.sum(wo) * e + 1e-8)
        losses["movement"] = torch.sum(diff * we) / (torch.sum(we) * e + 1e-8)
        h_side = warp_yx.shape[0]
        maps = replace_out.reshape(1, h_side, -1, e)
        losses["smooth"] = (torch.abs(maps[:, 1:] - maps[:, :-1]).mean()
                            + torch.abs(maps[:, :, 1:] - maps[:, :, :-1]).mean())
        if compute_removal:
            probs_e = _probs_headwise(q_e, k_live, heads)
            with torch.no_grad():
                probs_b = _probs_headwise(q_b, k_b, heads)
            corr = torch.einsum("hrk,hck->hrc", probs_e, probs_b)
            dist = _coord_distance_grid(h_side, seq // h_side, dev)
            c_in = corr * m_inpaint[None, None, :]
            c_wo = corr * m_wo_edit[None, None, :]
            # amax splits a tie's gradient evenly, as JAX's max does
            p_in = torch.amax(c_in, -1)
            p_wo = torch.amax(c_wo, -1)
            idx_wo = torch.argmax(c_wo, -1)
            d_wo = torch.exp(-dist[torch.arange(seq, device=dev)[None], idx_wo]).detach()
            rows = m_inpaint[None, :]
            f = probs_e.shape[0]
            losses["removal"] = torch.sum(
                rows * d_wo * (-torch.log(p_wo + 1e-4) + torch.log(p_in + 1e-4))
            ) / (torch.sum(m_inpaint) * f + 1e-8)
            if m_amodal is not None:
                interp, iw = _interpolate_from_mask(edit_out[0], m_warp, dist)
                interp = torch.where(m_warp[:, None] > 0.5, edit_out[0], interp)
                interp = _box_smooth_tokens(interp, h_side, seq // h_side)
                am = (m_amodal.to(dev).float() * iw)[:, None]
                losses["amodal"] = torch.sum(
                    torch.abs(interp.detach() - replace_out[0]) * am
                ) / (torch.sum(am) * e + 1e-8)

    if float(share_gate) > 0:
        out_e = m_warp[None, :, None] * edit_out + (1.0 - m_warp[None, :, None]) * replace_out
    else:
        out_e = replace_out
    with torch.no_grad():
        base_out = attend(q_b, k_b, v_b, heads)
    return torch.cat([base_out, out_e.to(q.dtype)], dim=0), losses


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
    passed as k_extra / v_extra [P, L, E]."""
    if cfg.mode == "none" or not cfg.local_cfg or state is None:
        return sdpa(q, k, v, heads)
    b, seq, _ = q.shape
    if cfg.mode == "compose":
        p = cfg.prompt_length
        _, tgt = _compose_masks(state, seq, q.device)
        cases = tgt.shape[0]
        if b != cases * (cfg.num_sources + 2) or k_extra is None or p < 1:
            raise ValueError("compose cross-attention needs the [e, r_1..r_N, c_e] batch per "
                             "case and the region prompts' k_extra / v_extra")
        qc, kc, vc = (_by_case(x, cases) for x in (q, k, v))
        hu = sdpa(*(x[:, :-1].reshape(-1, *x.shape[2:]) for x in (qc, kc, vc)), heads)
        qe = qc[:, -1:].expand(-1, p, -1, -1).reshape(cases * p, seq, -1)
        per_prompt = sdpa(qe, k_extra, v_extra, heads)                   # [C * P, S, E]
        hc = (per_prompt.float().reshape(cases, p, seq, -1) * tgt[:, :p, :, None]).sum(1)
        return torch.cat([_by_case(hu, cases), hc[:, None].to(q.dtype)], dim=1).reshape(
            b, seq, -1)
    local = state.local_region[seq].to(q.device)
    cases = _num_cases(local)
    local = local.reshape(cases, seq, 1)
    h = sdpa(q, k, v, heads)
    hc = _by_case(h, cases)
    if cfg.shared_ref:  # [u_e, c_e] per case, no reference stream
        u_e, c_e = hc[:, 0], hc[:, 1]
    else:
        u_e, u_r, c_e = hc[:, 0], hc[:, 1], hc[:, 2]
    mod_c_e = (local * c_e.float() + (1.0 - local) * u_e.float()).to(h.dtype)
    if cfg.shared_ref:
        out = [u_e, mod_c_e]
    else:
        out = [u_e, u_r, mod_c_e] + ([u_r] if hc.shape[1] == 4 else [])
    return torch.stack(out, dim=1).reshape(h.shape)
