"""Coarse 2D geometric edit (mirrors `freefine_tpu.ops.geometry`).

The O(1) affine matrix math runs in numpy on the host; the [H, W]
resampling (`warp_affine`) is a torch gather on the requested device, with
`map_coordinates` semantics: bilinear or nearest (half away from zero),
constant 0 outside the source.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def mask_bbox_center(mask: np.ndarray) -> Tuple[float, float]:
    """(cx, cy) of the mask bounding box."""
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    ys, xs = np.where(np.asarray(mask) > 0)
    if len(ys) == 0:
        h, w = mask.shape[:2]
        return (w - 1) / 2.0, (h - 1) / 2.0
    return (xs.max() + xs.min()) / 2.0, (ys.max() + ys.min()) / 2.0


def edit_affine_matrix(
    center: Tuple[float, float],
    dx: float,
    dy: float,
    rotation: float,
    scale_x: float,
    scale_y: float,
) -> np.ndarray:
    """2x3 forward affine matrix as the reference builds it:
    cv2.getRotationMatrix2D(center, -rotation, 1), translation +=
    (dx + (1-sx)*cx, dy + (1-sy)*cy), then the diagonal *= (sx, sy)."""
    cx, cy = center
    theta = np.deg2rad(-rotation)
    a, b = np.cos(theta), np.sin(theta)
    m = np.array(
        [[a, b, (1 - a) * cx - b * cy],
         [-b, a, b * cx + (1 - a) * cy]],
        np.float64,
    )
    m[0, 2] += dx + (1 - scale_x) * cx
    m[1, 2] += dy + (1 - scale_y) * cy
    m[0, 0] *= scale_x
    m[1, 1] *= scale_y
    return m


def invert_affine(m: np.ndarray) -> np.ndarray:
    """Invert a 2x3 affine (dst -> src sampling)."""
    full = np.vstack([m, [0.0, 0.0, 1.0]])
    return np.linalg.inv(full)[:2]


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def warp_affine(img: torch.Tensor, inv_matrix: np.ndarray, method: str = "linear") -> torch.Tensor:
    """cv2.warpAffine-equivalent resampling with a dst->src matrix.

    img [H, W] or [H, W, C]; returns float32 of the same shape; outside
    the source -> 0."""
    h, w = img.shape[:2]
    dev = img.device
    m = torch.as_tensor(np.asarray(inv_matrix, np.float32), device=dev)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev, dtype=torch.float32),
        torch.arange(w, device=dev, dtype=torch.float32),
        indexing="ij",
    )
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    x = img.float()
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]

    def gather(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        v = x[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, torch.zeros_like(v))

    if method == "linear":
        y0, x0 = torch.floor(sy), torch.floor(sx)
        wy1, wx1 = sy - y0, sx - x0
        wy0, wx0 = 1 - wy1, 1 - wx1
        iy, ix = y0.long(), x0.long()
        out = (
            (wy0 * wx0)[..., None] * gather(iy, ix)
            + (wy0 * wx1)[..., None] * gather(iy, ix + 1)
            + (wy1 * wx0)[..., None] * gather(iy + 1, ix)
            + (wy1 * wx1)[..., None] * gather(iy + 1, ix + 1)
        )
    else:
        out = gather(_round_half_away(sy).long(), _round_half_away(sx).long())
    return out[:, :, 0] if squeeze else out


def re_edit_2d(
    src_img: np.ndarray,
    src_mask: np.ndarray,
    edit_param: Optional[Sequence[float]] = None,
    inp_cur: Optional[np.ndarray] = None,
    *,
    dx: float = 0.0,
    dy: float = 0.0,
    rotation: float = 0.0,
    scale_x: float = 1.0,
    scale_y: float = 1.0,
    device: str | torch.device = "cuda",
):
    """Coarse 2D edit: cut the object, affine-transform it, paste it over
    `inp_cur` (defaults to the source).  edit_param is the 5-param
    [dx, dy, rz, sx, sy] or GeoBench 9-param layout.

    Returns (final_image, target_mask_u8_255, trans_hole_image) as numpy."""
    if edit_param is not None:
        p = list(map(float, edit_param))
        if len(p) == 5:
            dx, dy, rotation, scale_x, scale_y = p
        elif len(p) == 9:
            dx, dy, _, _, _, rotation, scale_x, scale_y, _ = p
        else:
            raise ValueError(f"edit_param must have 5 or 9 entries, got {len(p)}")
    src_img = np.asarray(src_img)
    src_mask = np.asarray(src_mask)
    if src_mask.ndim == 3:
        src_mask = src_mask[:, :, 0]
    if inp_cur is None:
        inp_cur = src_img

    center = mask_bbox_center(src_mask)
    inv = invert_affine(edit_affine_matrix(center, dx, dy, rotation, scale_x, scale_y))
    dev = torch.device(device)
    timg = warp_affine(torch.as_tensor(src_img, device=dev), inv, method="linear")
    tmask = warp_affine(
        torch.as_tensor((src_mask > 0).astype(np.uint8), device=dev), inv, method="nearest"
    )
    tmask_b = (tmask.cpu().numpy() > 0)[:, :, None]
    timg_u8 = np.clip(timg.cpu().numpy(), 0, 255).astype(np.uint8)

    image_with_hole = np.where(src_mask[:, :, None] > 0, 0, src_img)
    trans_hole = np.where(tmask_b, timg_u8, image_with_hole)
    final = np.where(tmask_b, timg_u8, np.asarray(inp_cur))
    return final, (tmask_b[:, :, 0].astype(np.uint8) * 255), trans_hole


def flip_object(
    src_img: np.ndarray,
    src_mask: np.ndarray,
    horizontal: bool = True,
    inp_cur: Optional[np.ndarray] = None,
    *,
    device: str | torch.device = "cuda",
):
    """Mirror the object about its bbox center, horizontally or vertically,
    and paste it over `inp_cur` (defaults to the source).  Returns
    (final_image, target_mask_u8_255) as numpy."""
    src_img = np.asarray(src_img)
    src_mask = np.asarray(src_mask)
    if src_mask.ndim == 3:
        src_mask = src_mask[:, :, 0]
    if inp_cur is None:
        inp_cur = src_img
    cx, cy = mask_bbox_center(src_mask)
    if horizontal:
        m = np.array([[-1.0, 0.0, 2 * cx], [0.0, 1.0, 0.0]])
    else:
        m = np.array([[1.0, 0.0, 0.0], [0.0, -1.0, 2 * cy]])
    inv = invert_affine(m)
    dev = torch.device(device)
    timg = np.clip(warp_affine(torch.as_tensor(src_img, device=dev), inv).cpu().numpy(),
                   0, 255).astype(np.uint8)
    tmask = warp_affine(torch.as_tensor((src_mask > 0).astype(np.uint8), device=dev), inv,
                        method="nearest").cpu().numpy()
    tb = (tmask > 0)[:, :, None]
    final = np.where(tb, timg, np.asarray(inp_cur))
    return final, tb[:, :, 0].astype(np.uint8) * 255


def lanczos3_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """The [in_size, out_size] float32 weights with which
    `jax.image.resize(..., method="lanczos3")` (antialiased, its default)
    resamples one axis: output i samples the input at
    (i + 0.5) / scale - 0.5, scale = out_size / in_size, through the
    Lanczos kernel of radius 3, 3 sin(pi x) sin(pi x / 3) / (pi x)^2 (1
    below 1e-3, 0 beyond 3), stretched by max(1 / scale, 1) when shrinking;
    each column is divided by its sum (zero where that sum is about 0), and
    a column whose sample lies outside [-0.5, in_size - 0.5] is zero."""
    inv_scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0).to(device)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale.to(device) - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None])
    x = x.abs() / kernel_scale
    pi = torch.tensor(np.pi, dtype=torch.float32)
    y = 3.0 * torch.sin(pi * x) * torch.sin(pi * x / 3.0)
    k = torch.where(x > 1e-3, y / torch.where(x != 0, pi**2 * x**2, torch.ones_like(x)),
                    torch.ones_like(x))
    k = torch.where(x > 3.0, torch.zeros_like(k), k)
    total = k.sum(dim=0, keepdim=True)
    k = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    k / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(k))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], k, torch.zeros_like(k))


def resize_lanczos3(img: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[H, W, C] -> float32 [height, width, C], `jax.image.resize`'s
    antialiased lanczos3 (`lanczos3_weights`) on the axes whose size
    changes, on img's device; the channel axis is never resized."""
    x = img.float()
    if x.shape[0] != height:
        x = torch.einsum("hwc,hy->ywc", x, lanczos3_weights(x.shape[0], height, x.device))
    if x.shape[1] != width:
        x = torch.einsum("hwc,wx->hxc", x, lanczos3_weights(x.shape[1], width, x.device))
    return x
