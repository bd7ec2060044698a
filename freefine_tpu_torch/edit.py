"""Editing configuration and state for the PyTorch port.

`EditConfig` is the static description of the editing mode; `EditState`
carries the per-call tensors (mask pyramids keyed by attention sequence
length, per-step scalars).  Mirrors `freefine_tpu.edit` for every mode:
'none', 'edit' (geometric edit), 'bggen' (background generation),
'compose' (multi-image composition) and the baselines' 'drag' (RegionDrag),
'design' (DesignEdit) and 'geodiff' (GeoDiffuser).

Stream layouts: edit / bggen the deduped [u_e, r, c_e] (or legacy
[u_e, u_r, c_e, c_r]); compose [e, r_1 .. r_N, c_e]; drag [x, hook];
design [u_1 .. u_n, c_1 .. c_n]; geodiff [base, edit].
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

DEFAULT_LAYER_RANGE = (10, 16)
# UNet stages whose self-attention TCA modulates (the decoder).
TCA_SCOPE = ("up",)
# UNet stages whose self-attention ssa / sdsa share (all of them).
STYLE_ALIGN_SCOPE = ("down", "mid", "up")
MODES = ("none", "edit", "bggen", "compose", "drag", "design", "geodiff")
METHODS = (None, "tca", "mmsa", "ssa", "sdsa")


@dataclasses.dataclass(frozen=True)
class EditConfig:
    """mode 'none' (vanilla), 'edit', 'bggen', 'compose', or a baseline's:
    'drag' (every stream attends with stream `kv_source_stream`'s K/V in
    the self-attentions of `tca_scope` and `layer_range`, gated by
    `EditState.share_gate` where a state is given), 'design' (stream
    `kv_source_stream` computes its self-attention keys from hidden states
    zeroed outside `EditState.local_region`, the gate scaling the zeroing)
    or 'geodiff' (`ops.attention.geodiff_attention` in every attention
    whose sequence length `EditState.warp_coords` holds); method 'tca',
    'mmsa' (masked reference attention, blended or not with self-attention)
    or 'ssa' / 'sdsa' (StyleAligned shared attention, sdsa with the
    appended reference keys masked).

    tca_scope     : the UNet stages whose self-attention TCA (and drag)
                    modulates.
    kv_source_stream : drag, the stream whose K/V every stream attends
                    with; design, the stream whose keys are masked.
    geodiff_loss_seq : geodiff, the losses are computed at sequence lengths
                    >= this, the removal and amodal losses at exactly it.

    num_sources   : compose, the N reference images.
    prompt_length : compose, region prompts including the trailing "".
    shared_ref    : the shared-reference layout: each case runs the 2
                    streams [u_e, c_e] (bggen [u_g, c_g]) and the reference
                    stream's K/V arrive in `EditState.ref_kv`, captured once
                    per step by a standalone reference pass and shared by
                    every case of one source image.  The capture pass runs
                    the reference stream vanilla, so this layout implies
                    `ref_vanilla`.
    ref_vanilla   : the intent semantics of the reference stream: only the
                    edit streams' even heads are masked, the reference
                    streams stay unmasked.  False (default) keeps the
                    reference-exact head-parity masks on every stream.
    store_kv      : the capture pass: each self-attention that TCA would
                    modulate (`TCA_SCOPE`, `layer_range`) writes its batch-1
                    (k, v) into `EditState.ref_kv`, keyed by block index.
    store_attention : the attention-map instrument: every attention layer
                    with at most 32 x 32 queries adds its head-averaged
                    probabilities [B, Sq, Sk] to `EditState.intermediates`
                    (`FreeFine.attention_maps`, `utils.attn_store`).  The
                    layer's output is unchanged.
    sow_token_attn : every cross-attention adds its maps of the tokens
                    `EditState.token_select` selects [B*H, Sq, T] to
                    `EditState.intermediates`.
    ip_scale      : IP-Adapter image-prompt strength: > 0 makes every
                    cross-attention add ip_scale * attention over the
                    `context_image` tokens through its to_k_ip / to_v_ip
                    (`models.ip_adapter.add_ip_adapter` attaches them).
    """

    mode: str = "none"
    method: Optional[str] = None
    local_cfg: bool = True
    layer_range: Tuple[int, int] = DEFAULT_LAYER_RANGE
    tca_scope: Tuple[str, ...] = TCA_SCOPE
    kv_source_stream: int = 1
    geodiff_loss_seq: int = 1024
    num_sources: int = 0
    prompt_length: int = 0
    shared_ref: bool = False
    ref_vanilla: bool = False
    store_kv: bool = False
    store_attention: bool = False
    sow_token_attn: bool = False
    ip_scale: float = 0.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown edit mode {self.mode!r}")
        if self.method not in METHODS:
            raise ValueError(f"unknown edit method {self.method!r}")

    @property
    def uses_share_attention(self) -> bool:
        return self.method in ("ssa", "sdsa")

    @property
    def uses_tca(self) -> bool:
        return self.method in ("tca", "mmsa")

    def block_gated(self, block_index: int) -> bool:
        """Static layer gate (reference `cur_att_layer // 2 in layer_idx`)."""
        lo, hi = self.layer_range
        return lo <= block_index < hi


def none_config() -> EditConfig:
    return EditConfig(mode="none", method=None, local_cfg=False)


@dataclasses.dataclass
class EditState:
    """Per-call editing tensors threaded through the UNet.

    fg_retain    : {S: [S]} target-region query mask (bggen: the object).
    fg_ref       : {S: [S]} source-object key mask.
    local_region : {S: [S]} local cross-attention CFG region.
    src_masks    : compose, {S: [N, S]} per-source key masks.
    tgt_masks    : compose, {S: [N+1, S]} per-region query masks (last =
                   background).
    context_guidance, share_gate : per-step scalars (python floats or 0-d
                   tensors), shared by every case.
    ref_kv       : shared-reference layout, {block_index: (k [S, E],
                   v [S, E])}: the reference stream's self-attention K/V at
                   each TCA-gated layer (the capture pass writes it).
    token_select : [T, L] one-hot rows (zero rows padding) selecting the
                   tokens whose cross-attention maps `sow_token_attn` keeps.
    warp_coords  : geodiff, {S: [h, w, 2]} the inverse warp's absolute
                   (y, x) source coordinates at each attention grid.
    intermediates : where the instruments write, the port's form of flax's
                   "intermediates" collection: {(module path..., name):
                   [tensor per call]} (name "attn_probs",
                   "token_attn_{place}", "geodiff_{loss}", or the UNet's
                   ("guidance_feature",)).

    Case axis: the batched lanes stack C cases, and every mask pyramid
    entry gains a leading case axis ([C, S]; compose [C, N, S]).  The UNet
    batch is then the C cases' streams, case-major.  This stands in for
    the JAX package's `jax.vmap` over cases.
    """

    fg_retain: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    fg_ref: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    local_region: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    src_masks: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    tgt_masks: Dict[int, torch.Tensor] = dataclasses.field(default_factory=dict)
    context_guidance: float = 0.0
    share_gate: float = 1.0
    ref_kv: Optional[Dict[int, Tuple[torch.Tensor, torch.Tensor]]] = None
    token_select: Optional[torch.Tensor] = None
    warp_coords: Optional[Dict[int, torch.Tensor]] = None
    intermediates: Optional[Dict[tuple, list]] = None


def attention_resolutions(latent_h: int, latent_w: int) -> Tuple[Tuple[int, int], ...]:
    """Self-attention (h, w) grids of the SD UNet for a latent size
    (ceil-division chain of the reference's `get_down_h_w`)."""
    out = []
    h, w = latent_h, latent_w
    for _ in range(4):
        out.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return tuple(out)


def nearest_resize(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[H, W] -> [h, w] nearest resize anchored top-left (torch
    `F.interpolate(mode='nearest')`: src = floor(dst * in / out)), computed
    in float32 index math as the JAX package does."""
    mh, mw = mask.shape
    dev = mask.device
    rows = torch.floor(
        torch.arange(h, device=dev, dtype=torch.float32) * torch.tensor(mh / h, dtype=torch.float32)
    ).long()
    cols = torch.floor(
        torch.arange(w, device=dev, dtype=torch.float32) * torch.tensor(mw / w, dtype=torch.float32)
    ).long()
    return mask.float()[rows][:, cols]


def downsample_mask(mask: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Nearest downsample to (h, w), flattened to [h*w]."""
    return nearest_resize(mask, h, w).reshape(-1)


def build_mask_pyramid(
    mask: torch.Tensor, latent_h: int, latent_w: int
) -> Dict[int, torch.Tensor]:
    """Full-res [H, W] mask -> {seq_len: [seq_len] float32} pyramid."""
    return {
        h * w: downsample_mask(mask, h, w)
        for h, w in attention_resolutions(latent_h, latent_w)
    }


def build_mask_stack_pyramid(
    masks: torch.Tensor, latent_h: int, latent_w: int
) -> Dict[int, torch.Tensor]:
    """[N, H, W] mask stack -> {seq_len: [N, seq_len] float32} pyramid."""
    return {
        h * w: torch.stack([downsample_mask(m, h, w) for m in masks])
        for h, w in attention_resolutions(latent_h, latent_w)
    }
