"""Mask engine of the edit, background-generation and composition tasks
(mirrors `freefine_tpu.masks`).

float32 [H, W] tensors in {0, 1} (soft where the reference is soft).
Dilation/erosion are max/min pools with cv2's even-kernel anchor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from freefine_tpu_torch.edit import nearest_resize


def binarize(mask: torch.Tensor) -> torch.Tensor:
    """>0 -> 1.0 (the reference's `mask[mask>0]=1`)."""
    return (mask > 0).float()


def prepare_mask(mask: torch.Tensor, h: int, w: int, binary: bool = True) -> torch.Tensor:
    """Reference `prepare_tensor_mask`: [H, W] or [H, W, C] (channel 0) ->
    nearest-resized [h, w] float32, binarised (>0) or max-normalised."""
    m = mask
    if m.ndim == 3:
        m = m[:, :, 0]
    m = m.float()
    if tuple(m.shape) != (h, w):
        m = nearest_resize(m, h, w)
    if binary:
        return binarize(m)
    return m / torch.clamp(m.max(), min=1e-8)


def _pool(mask: torch.Tensor, factor: int, sign: float) -> torch.Tensor:
    """factor x factor max pool of sign * mask, cv2 anchor (k//2, k//2):
    the window covers offsets [-k//2, k - k//2 - 1]."""
    lo = factor // 2
    hi = factor - lo - 1
    x = (sign * mask.float())[None, None]
    x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return sign * F.max_pool2d(x, factor, stride=1)[0, 0]


def dilate(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """cv2.dilate with a `factor` x `factor` all-ones kernel."""
    if factor <= 1:
        return mask
    return _pool(mask, factor, 1.0)


def erode(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """cv2.erode analogue (min pool)."""
    if factor <= 1:
        return mask
    return _pool(mask, factor, -1.0)


def to_latent_res(mask: torch.Tensor, lh: int, lw: int) -> torch.Tensor:
    """Nearest-downsample a full-res mask to the latent grid."""
    return nearest_resize(mask.float(), lh, lw)


class EditMasks(NamedTuple):
    """Mask family of the `generation` task."""

    fg_retain: torch.Tensor       # full-res TCA query mask == local CFG region
    fg_retain_st2: torch.Tensor   # full-res bare target mask
    fg_ref: torch.Tensor          # full-res source-object key mask
    completion_cfg: torch.Tensor  # latent-res local CFG multiplier
    local_var: torch.Tensor       # latent-res DDPM perturbation region


def prepare_various_mask(
    shifted_mask: torch.Tensor,
    ori_mask: torch.Tensor,
    draw_mask: Optional[torch.Tensor],
    h: int,
    w: int,
    latent_h: int,
    latent_w: int,
    use_auto_draw: bool = False,
    cons_area: Optional[torch.Tensor] = None,
    reduce_inp_artifacts: bool = False,
) -> EditMasks:
    """The four-branch mask builder for geometric edits (reference
    model.py:1432-1512)."""
    shifted = prepare_mask(shifted_mask, h, w)
    ori = prepare_mask(ori_mask, h, w)

    if not use_auto_draw:
        if draw_mask is None:
            raise ValueError("draw_mask required when use_auto_draw=False")
        flexible = prepare_mask(draw_mask, h, w) * (1.0 - shifted)
        fg = binarize(flexible + shifted)
        complete = flexible
        if not reduce_inp_artifacts:
            local_var = flexible
        else:
            if cons_area is None:
                raise ValueError("cons_area required with reduce_inp_artifacts")
            dil_ori = prepare_mask(dilate(prepare_mask(ori_mask, h, w), 30), h, w)
            cons = prepare_mask(cons_area, h, w)
            local_var = binarize((1.0 - cons) * (1.0 - shifted) * dil_ori + flexible)
    else:
        if cons_area is None:
            raise ValueError("cons_area required with use_auto_draw")
        dil_tgt = prepare_mask(dilate(prepare_mask(shifted_mask, h, w), 15), h, w)
        cons = prepare_mask(cons_area, h, w) - ori  # may go negative, as in ref
        fg = shifted
        if not reduce_inp_artifacts:
            complete = (1.0 - cons) * (1.0 - shifted) * dil_tgt
        else:
            dil_ori = prepare_mask(dilate(prepare_mask(ori_mask, h, w), 30), h, w)
            complete = binarize(dil_ori + dil_tgt) * (1.0 - cons) * (1.0 - shifted)
        local_var = complete

    return EditMasks(
        fg_retain=fg,
        fg_retain_st2=shifted,
        fg_ref=ori,
        completion_cfg=to_latent_res(complete, latent_h, latent_w),
        local_var=to_latent_res(local_var, latent_h, latent_w),
    )


class ComposeMasks(NamedTuple):
    """Mask family of the composition task (reference
    prepare_composition_masks, model.py:1515-1609)."""

    tgt_masks: torch.Tensor       # [N+1, H, W] per-region query masks (last = background)
    src_masks: torch.Tensor       # [N, H, W] per-source key masks
    local_var: torch.Tensor       # latent-res DDPM region
    completion_cfg: torch.Tensor  # latent-res local CFG multiplier


def prepare_composition_masks(
    ori_masks: Sequence[torch.Tensor],
    tgt_masks: Sequence[torch.Tensor],
    h: int,
    w: int,
    latent_h: int,
    latent_w: int,
    dil_completion: bool = False,
    dil_factor: int = 15,
    draw_masks: Optional[Sequence[torch.Tensor]] = None,
    appearance_transfer: bool = False,
) -> ComposeMasks:
    """Per-source key masks, per-region query masks and the perturbation /
    local-CFG regions: appearance transfer (dilated targets), plain
    composition, or composition with user draw masks."""
    src = torch.stack([prepare_mask(m, h, w) for m in ori_masks])
    dev = src.device

    if appearance_transfer:
        tgt_list = []
        local_pert = torch.zeros((h, w), device=dev)
        for m in tgt_masks:
            d = prepare_mask(dilate(prepare_mask(m, h, w), dil_factor), h, w)
            tgt_list.append(d)
            local_pert = local_pert + d
        local_pert = binarize(local_pert)
        tgt_list.append(1.0 - local_pert)
        lv = to_latent_res(local_pert, latent_h, latent_w)
        return ComposeMasks(torch.stack(tgt_list), src, lv, lv)

    tgt_list = []
    local_pert = torch.zeros((h, w), device=dev)
    fg = torch.zeros((h, w), device=dev)
    if draw_masks is None:
        for m in tgt_masks:
            sm = prepare_mask(m, h, w)
            dm = prepare_mask(dilate(sm, dil_factor), h, w)
            tgt_list.append(dm if dil_completion else sm)
            fg = fg + sm
            local_pert = local_pert + dm
        fg = binarize(fg)
        local_pert = binarize(local_pert)
        tgt_list.append(1.0 - (fg if dil_completion else local_pert))
        lv = to_latent_res(local_pert * (1.0 - fg), latent_h, latent_w)
        return ComposeMasks(torch.stack(tgt_list), src, lv,
                            lv if dil_completion else torch.zeros_like(lv))

    # user draw masks aligned with the target masks
    for m, d in zip(tgt_masks, draw_masks):
        sm = prepare_mask(m, h, w)
        dm = binarize(prepare_mask(d, h, w) + sm)
        tgt_list.append(dm)
        fg = fg + sm
        local_pert = local_pert + dm
    fg = binarize(fg)
    local_pert = binarize(local_pert)
    tgt_list.append(1.0 - local_pert)
    lv = to_latent_res(local_pert * (1.0 - fg), latent_h, latent_w)
    return ComposeMasks(torch.stack(tgt_list), src, lv, lv)


def prepare_mask_bggen(
    mask: torch.Tensor, h: int, w: int, latent_h: int, latent_w: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(full-res object mask, latent-res perturbation mask)
    (reference model.py:1611-1620)."""
    m = prepare_mask(mask, h, w)
    return m, to_latent_res(m, latent_h, latent_w)


def prepare_surrounding_mask(
    shifted_mask: torch.Tensor, cons_area: torch.Tensor, rate: float = 0.5
) -> torch.Tensor:
    """The object's bounding box grown by `rate` of its size on each side,
    minus the object and the constrained area (reference
    model.py:1392-1426); an empty mask gives zeros."""
    m = binarize(shifted_mask)
    h, w = m.shape
    if not bool(m.max() > 0):
        return torch.zeros_like(m)
    dev = m.device
    ridx = torch.arange(h, dtype=torch.float32, device=dev)
    cidx = torch.arange(w, dtype=torch.float32, device=dev)
    rows, cols = ridx[m.amax(dim=1) > 0], cidx[m.amax(dim=0) > 0]
    y_min, y_max, x_min, x_max = rows.min(), rows.max(), cols.min(), cols.max()
    jx = torch.floor(rate * (x_max - x_min))
    jy = torch.floor(rate * (y_max - y_min))
    nx0 = torch.clamp(x_min - jx, min=0.0)
    ny0 = torch.clamp(y_min - jy, min=0.0)
    nx1 = torch.clamp(x_max + jx, max=w - 1.0)
    ny1 = torch.clamp(y_max + jy, max=h - 1.0)
    region = (
        (ridx[:, None] >= ny0) & (ridx[:, None] <= ny1)
        & (cidx[None, :] >= nx0) & (cidx[None, :] <= nx1)
    ).float()
    return region * (1.0 - binarize(cons_area)) * (1.0 - m)


def get_constrain_areas(mask_list: Sequence[torch.Tensor], h: int, w: int) -> torch.Tensor:
    """Union of instance masks to protect from edits (reference
    src/utils/vis_utils.py:183-193): each mask `prepare_mask`ed to (h, w),
    summed and binarised."""
    out = torch.zeros((h, w), dtype=torch.float32,
                      device=mask_list[0].device if len(mask_list) else None)
    for m in mask_list:
        out = out + prepare_mask(m, h, w)
    return binarize(out)
