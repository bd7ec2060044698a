"""Depth-based 3D editing: back-projection, rigid transform, point splatting
(mirrors `freefine_tpu.ops.point_splat`).

Same numpy-in / numpy-out entry points as the JAX package; the [H, W]
work runs in torch on the requested device:

  * back-projection with pinhole intrinsics, and the reference's flip ->
    centre -> translate, rotate (Euler XYZ, applied as p @ R), scale ->
    un-centre -> un-flip chain, with masked statistics;
  * a softmax-z bilinear forward splat: every point adds into its four
    neighbouring pixels with the weight exp(-(z - z_min) / (tau z_range)),
    by `index_add_` (on the card float atomics, in no fixed order, so a
    pixel near the coverage threshold can differ from run to run);
  * hole filling by iterative partial convolution (window sums of shifted
    slices: exact float32 adds whatever the TF32 settings);
  * fast-marching inpainting as JAX's boundary-peel while loop, its mask
    checked on the host once every `FMM_CHECK_EVERY` iterations (the body
    is a no-op once the mask is empty) and never past h + w iterations.

Re-projection goes through the back-projection's own intrinsics, as in the
JAX package (an identity transform reproduces the input pixels).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from freefine_tpu_torch import masks as mask_ops

# inpaint_fmm's iterations between host checks of its mask
FMM_CHECK_EVERY = 16


def euler_xyz_matrix(rx, ry, rz, device=None) -> torch.Tensor:
    """R = Rx @ Ry @ Rz (PyTorch3D's euler_angles_to_matrix, convention
    XYZ), float32, angles in radians; applied as p @ R."""
    c = [torch.cos(torch.as_tensor(a, dtype=torch.float32, device=device)) for a in (rx, ry, rz)]
    s = [torch.sin(torch.as_tensor(a, dtype=torch.float32, device=device)) for a in (rx, ry, rz)]
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])
    rx_m = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, c[0], -s[0]]),
                        torch.stack([zero, s[0], c[0]])])
    ry_m = torch.stack([torch.stack([c[1], zero, s[1]]), torch.stack([zero, one, zero]),
                        torch.stack([-s[1], zero, c[1]])])
    rz_m = torch.stack([torch.stack([c[2], -s[2], zero]), torch.stack([s[2], c[2], zero]),
                        torch.stack([zero, zero, one])])
    return rx_m @ ry_m @ rz_m


def pixel_grid(h: int, w: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    j, i = torch.meshgrid(torch.arange(h, device=device), torch.arange(w, device=device),
                          indexing="ij")
    return j, i


def backproject(depth: torch.Tensor, fx: float, fy: float) -> torch.Tensor:
    """[H, W] depth -> [H*W, 3] camera-space points (OpenCV convention:
    x = (i - w/2) z / fx, y = (j - h/2) z / fy)."""
    h, w = depth.shape
    j, i = pixel_grid(h, w, depth.device)
    z = depth.float()
    x = (i - w / 2.0) * z / fx
    y = (j - h / 2.0) * z / fy
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def transform_object_points(points: torch.Tensor, weights: torch.Tensor,
                            transforms: Sequence[float]) -> torch.Tensor:
    """The flip -> centre -> translate / rotate / scale -> un-centre ->
    un-flip chain; `weights` [N] (1 = object point) gives the masked mean
    and extent.  transforms: (dx, dy, dz, rx, ry, rz, sx, sy, sz), the
    translations relative to the object's extent, the angles in degrees."""
    dev = points.device
    dx, dy, dz, rx, ry, rz, sx, sy, sz = [torch.tensor(float(t), dtype=torch.float32,
                                                       device=dev) for t in transforms]
    flip = torch.tensor([-1.0, -1.0, 1.0], device=dev)
    p = points.float() * flip
    wsum = torch.clamp(weights.sum(), min=1.0)
    center = (p * weights[:, None]).sum(0) / wsum
    p = p - center
    on = weights[:, None] > 0
    big = torch.tensor(1e30, device=dev)
    extent = torch.where(on, p, -big).amax(0) - torch.where(on, p, big).amin(0)
    t = extent * torch.stack([dx, dy, dz])
    r = euler_xyz_matrix(torch.deg2rad(rx), torch.deg2rad(ry), torch.deg2rad(rz), dev)
    # translate first, then rotate, then scale
    p = ((p + t) @ r) * torch.stack([sx, sy, sz])
    return (p + center) * flip


def bilinear_taps(u: torch.Tensor, v: torch.Tensor, h: int, w: int):
    """The four (pixel index, bilinear weight, inside) taps of each point."""
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    for du, dv, kw in ((0, 0, (1 - fu) * (1 - fv)), (1, 0, fu * (1 - fv)),
                       (0, 1, (1 - fu) * fv), (1, 1, fu * fv)):
        uu, vv = u0 + du, v0 + dv
        inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        idx = (torch.clamp(vv, 0, h - 1).long() * w + torch.clamp(uu, 0, w - 1).long())
        yield idx, kw, inside.float()


def splat_points(points: torch.Tensor, rgb: torch.Tensor, weights: torch.Tensor, *,
                 h: int, w: int, fx: float, fy: float, tau: float = 0.02
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-z bilinear forward splat -> ([h, w, 3] image, [h, w] mask):
    nearer points dominate a shared pixel without a sort."""
    p = points.float()
    z = torch.clamp(p[:, 2], min=1e-6)
    u = p[:, 0] * fx / z + w / 2.0
    v = p[:, 1] * fy / z + h / 2.0
    on = weights > 0
    inf = torch.tensor(float("inf"), device=p.device)
    zmin = torch.where(on, z, inf).min()
    zmax = torch.where(on, z, -inf).max()
    zrange = torch.clamp(zmax - zmin, min=1e-6)
    occ = torch.exp(-(z - zmin) / (tau * zrange)) * weights

    img_acc = torch.zeros(h * w, 3, device=p.device)
    w_acc = torch.zeros(h * w, device=p.device)
    cov_acc = torch.zeros(h * w, device=p.device)
    colour = rgb.float()
    for idx, kw, inside in bilinear_taps(u, v, h, w):
        wgt = kw * occ * inside
        img_acc.index_add_(0, idx, wgt[:, None] * colour)
        w_acc.index_add_(0, idx, wgt)
        cov_acc.index_add_(0, idx, kw * weights * inside)
    img = img_acc / torch.clamp(w_acc[:, None], min=1e-8)
    mask = (cov_acc > 0.05).float()
    return (img * mask[:, None]).reshape(h, w, 3), mask.reshape(h, w)


def _window_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window sums with zero padding over the first two axes."""
    pad = k // 2
    h, w = x.shape[:2]
    p = F.pad(x.movedim((0, 1), (-2, -1)), (pad, pad, pad, pad)).movedim((-2, -1), (0, 1))
    out = torch.zeros_like(x)
    for dy in range(k):
        for dx in range(k):
            out = out + p[dy:dy + h, dx:dx + w]
    return out


def fill_holes_partial_conv(img: torch.Tensor, known: torch.Tensor, iterations: int = 8,
                            kernel: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative partial-convolution hole filling: each round an unknown
    pixel with a known neighbour takes the mean of its known window, and
    the known set grows.  img [H, W, C], known [H, W] in {0, 1} -> (filled,
    known')."""
    x, m = img.float(), known.float()
    for _ in range(iterations):
        msum = _window_sum(m, kernel)
        xsum = _window_sum(x * m[:, :, None], kernel)
        fill = xsum / torch.clamp(msum[:, :, None], min=1e-8)
        grow = (msum > 0).float()
        x = x * m[:, :, None] + fill * (1 - m[:, :, None]) * grow[:, :, None]
        m = torch.maximum(m, grow)
    return x, m


def _neighbour_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 edge-clipped neighbours ([H, W] or [H, W, C])."""
    p = F.pad(x.movedim((0, 1), (-2, -1)), (1, 1, 1, 1)).movedim((-2, -1), (0, 1))
    return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]


def inpaint_fmm(img: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
    """Fast-marching inpainting as boundary peeling: each round the hole
    pixels with a known 4-neighbour take the mean of their known
    neighbours, in parallel, until the hole is empty or h + w rounds have
    run.  img [H, W, C]; hole [H, W] in {0, 1} (1 = repair)."""
    h, w = hole.shape
    x, m = img.float(), hole.float()
    done = 0
    while done < h + w and bool(m.sum() > 0):
        for _ in range(min(FMM_CHECK_EVERY, h + w - done)):
            known = 1.0 - m
            cnt = _neighbour_sum(known)
            fill = _neighbour_sum(x * known[:, :, None]) / torch.clamp(cnt[:, :, None], min=1e-8)
            newly = (m > 0) & (cnt > 0)
            x = torch.where(newly[:, :, None], fill, x)
            m = torch.where(newly, torch.zeros_like(m), m)
        done += min(FMM_CHECK_EVERY, h + w - done)
    return x


def _object_weights(mask: np.ndarray, device) -> torch.Tensor:
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[:, :, 0]
    return torch.as_tensor((m > 0).reshape(-1).astype(np.float32), device=device)


def _nine(edit_param: Sequence[float]) -> list:
    p9 = [float(v) for v in edit_param]
    if len(p9) != 9:
        raise ValueError(f"3D edit_param must be 9 values, got {len(p9)}")
    return p9


def re_edit_3d_depth(
    src_img: np.ndarray,
    src_mask: np.ndarray,
    depth: np.ndarray,
    edit_param: Sequence[float],
    inp_cur: Optional[np.ndarray] = None,
    focal_length_x: float = 470.4,
    focal_length_y: float = 470.4,
    fill_iters: int = 8,
    *,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Depth-based coarse 3D edit.  edit_param: (dx, dy, dz, rx, ry, rz, sx,
    sy, sz), relative translations, degrees, scales.  Returns
    (final_image, target_mask_255, rendered_object) as numpy."""
    src_img = np.asarray(src_img)
    src_mask = np.asarray(src_mask)
    if src_mask.ndim == 3:
        src_mask = src_mask[:, :, 0]
    if inp_cur is None:
        inp_cur = src_img
    h, w = src_mask.shape
    dev = torch.device(device)
    p9 = _nine(edit_param)
    pts = backproject(torch.as_tensor(np.asarray(depth, np.float32), device=dev),
                      focal_length_x, focal_length_y)
    weights = _object_weights(src_mask, dev)
    rgb = torch.as_tensor(src_img.reshape(-1, 3).astype(np.float32), device=dev)
    pts_t = transform_object_points(pts, weights, p9)
    img_r, mask_r = splat_points(pts_t, rgb, weights, h=h, w=w, fx=focal_length_x,
                                 fy=focal_length_y)
    filled, known = fill_holes_partial_conv(img_r, mask_r, iterations=fill_iters)
    # the final mask: close small gaps, then keep the filled interior
    closed = mask_ops.erode(mask_ops.dilate(mask_r, 5), 5)
    keep = torch.maximum(mask_r, closed * known)
    rendered = torch.nan_to_num(filled).clamp(0, 255).to(torch.uint8).cpu().numpy()
    tmask = (keep > 0).cpu().numpy()[:, :, None]
    final = np.where(tmask, rendered, np.asarray(inp_cur))
    return final, tmask[:, :, 0].astype(np.uint8) * 255, rendered


def compute_correspondence(
    depth: np.ndarray,
    mask: np.ndarray,
    edit_param: Sequence[float],
    focal_length_x: float = 470.4,
    focal_length_y: float = 470.4,
    *,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Dense source -> target pixel correspondence of a 3D edit: for every
    source pixel, the (row, col) it lands on after back-projection,
    transform and re-projection.  Returns [H, W, 2], NaN outside the
    mask."""
    h, w = np.asarray(depth).shape
    dev = torch.device(device)
    pts = backproject(torch.as_tensor(np.asarray(depth, np.float32), device=dev),
                      focal_length_x, focal_length_y)
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[:, :, 0]
    pts_t = transform_object_points(pts, _object_weights(m, dev), _nine(edit_param))
    pts_t = pts_t.cpu().numpy()
    z = np.maximum(pts_t[:, 2], 1e-6)
    u = pts_t[:, 0] * focal_length_x / z + w / 2.0
    v = pts_t[:, 1] * focal_length_y / z + h / 2.0
    corr = np.stack([v, u], axis=-1).reshape(h, w, 2)
    corr[m <= 0] = np.nan
    return corr
