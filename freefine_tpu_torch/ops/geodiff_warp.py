"""The GeoBench-3D authoring warp, GeoDiffuser conventions (mirrors
`freefine_tpu.ops.geodiff_warp`).

  * depth: normalised to [0, 1] with the far plane (> 0.95) snapped to 1,
    or the constant-depth mode (all 0.5) passed through
    (`normalize_depth`, numpy on the host);
  * a pinhole camera, focal 550 at 512^2, principal point at the centre;
    transform_in = T(t / length) @ S @ Rx @ Ry @ Rz conjugated about the
    masked points' mean (`geodiff_transform_matrix`, numpy);
  * the FULL image moves: a softmax-z bilinear splat of [rgb, mask] by
    `index_add_` (float atomics on the card, in no fixed order), the mask
    carried as a fourth channel whose weighted mean is thresholded at 0.5;
  * the mesh footprint: each quad of four masked pixels supersampled on a
    k x k lattice of its target coordinates, scattered into the pixel grid;
    md_mask = where(mesh, 0, full) is the benchmark's auto draw mask.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from freefine_tpu_torch.ops.point_splat import bilinear_taps, pixel_grid


def normalize_depth(depth: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(depth01, valid01).  A constant-depth input (sum == 0.5 H W) passes
    through as all 0.5 with everything valid."""
    d = np.asarray(depth, np.float32)
    h, w = d.shape
    if float(d.sum()) == 0.5 * h * w:
        d = np.full_like(d, 0.5)
    else:
        d = d / (d.max() + 1e-8)
        d[d > 0.95] = 1.0
    valid = (d < 0.95).astype(np.float32)
    return d, valid


def geodiff_transform_matrix(edit_param: Sequence[float], length: int = 512) -> np.ndarray:
    """4x4 float32 transform_in = T(t / length) @ S @ Rx @ Ry @ Rz for the
    GeoBench 9-tuple (tx, ty, tz, rx, ry, rz, sx, sy, sz), translations in
    pixels, angles in degrees."""
    tx, ty, tz, rx, ry, rz, sx, sy, sz = [float(v) for v in edit_param]

    def rot(deg, axis):
        r = np.radians(deg)
        c, s = np.cos(r), np.sin(r)
        m = np.eye(4)
        if axis == 0:
            m[1:3, 1:3] = [[c, -s], [s, c]]
        elif axis == 1:
            m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
        else:
            m[0:2, 0:2] = [[c, -s], [s, c]]
        return m

    t = np.eye(4)
    t[:3, 3] = [tx / length, ty / length, tz / length]
    s = np.diag([sx, sy, sz, 1.0])
    return (t @ s @ rot(rx, 0) @ rot(ry, 1) @ rot(rz, 2)).astype(np.float32)


def geodiff_warp(img: torch.Tensor, mask01: torch.Tensor, depth01: torch.Tensor,
                 valid01: torch.Tensor, background: torch.Tensor, matrix: torch.Tensor,
                 focal: float, *, supersample: int = 4, tau: float = 0.02):
    """img [H, W, 3] float 0..255, mask01 / depth01 / valid01 [H, W],
    background [H, W, 3], matrix [4, 4] -> (coarse [H, W, 3], full_mask
    [H, W], mesh_mask [H, W], coords_abs [H, W, 2] (x, y)), all float32 on
    img's device."""
    h, w = mask01.shape
    dev = img.device
    f = torch.tensor(float(focal), dtype=torch.float32, device=dev)
    cx, cy = w / 2.0, h / 2.0
    obj = mask01.float() * valid01.float()

    row, col = pixel_grid(h, w, dev)
    z = depth01.float()
    p = torch.stack([(col - cx) / f * z, (row - cy) / f * z, z], dim=-1).reshape(-1, 3)

    # the transform conjugated about the masked mean: p' = R (p - c) + t + c
    wts = obj.reshape(-1)
    center = (p * wts[:, None]).sum(0) / torch.clamp(wts.sum(), min=1.0)
    m = matrix.float()
    pt = (p - center) @ m[:3, :3].T + m[:3, 3] + center

    # re-projection with K applied before the z clamp (the principal-point
    # term rides the unclamped z)
    zt = torch.clamp(pt[:, 2], min=1e-3)
    u = (pt[:, 0] * f + cx * pt[:, 2]) / zt
    v = (pt[:, 1] * f + cy * pt[:, 2]) / zt
    coords_abs = torch.stack([u, v], dim=-1).reshape(h, w, 2)

    occ = torch.exp(-(zt - zt.min()) / (tau * torch.clamp(zt.max() - zt.min(), min=1e-6)))
    vals = torch.cat([img.reshape(-1, 3).float(), obj.reshape(-1, 1)], dim=-1)
    acc = torch.zeros(h * w, 4, device=dev)
    wacc = torch.zeros(h * w, device=dev)
    for idx, kw, inside in bilinear_taps(u, v, h, w):
        wgt = kw * occ * inside
        acc.index_add_(0, idx, wgt[:, None] * vals)
        wacc.index_add_(0, idx, wgt)
    # the weighted mean where any point lands (normalised by the true sum:
    # the exp(-z) weights can be uniformly tiny far from the z minimum)
    hit = wacc > 0
    splat = torch.where(hit[:, None], acc / torch.where(hit, wacc, torch.ones_like(wacc))[:, None],
                        torch.zeros_like(acc))
    warped = splat[:, :3].reshape(h, w, 3)
    full_mask = (splat[:, 3] > 0.5).float().reshape(h, w)

    # the mesh footprint: k x k lattice points over each fully masked quad
    k = supersample
    c00, c01 = coords_abs[:-1, :-1], coords_abs[:-1, 1:]
    c10, c11 = coords_abs[1:, :-1], coords_abs[1:, 1:]
    quad_ok = (obj[:-1, :-1] * obj[:-1, 1:] * obj[1:, :-1] * obj[1:, 1:]) > 0.5
    ta = torch.linspace(0.0, 1.0, k, device=dev)
    a = ta[None, :].repeat(k, 1).reshape(-1)   # x-fraction
    b = ta[:, None].repeat(1, k).reshape(-1)   # y-fraction
    pts = (((1 - a) * (1 - b))[None, :, None] * c00.reshape(-1, 1, 2)
           + (a * (1 - b))[None, :, None] * c01.reshape(-1, 1, 2)
           + ((1 - a) * b)[None, :, None] * c10.reshape(-1, 1, 2)
           + (a * b)[None, :, None] * c11.reshape(-1, 1, 2))
    mu, mv = torch.round(pts[..., 0]).long(), torch.round(pts[..., 1]).long()
    m_inside = (mu >= 0) & (mu < w) & (mv >= 0) & (mv < h)
    midx = torch.clamp(mv, 0, h - 1) * w + torch.clamp(mu, 0, w - 1)
    cover = (m_inside & quad_ok.reshape(-1, 1)).float()
    mesh_acc = torch.zeros(h * w, device=dev).index_add_(0, midx.reshape(-1), cover.reshape(-1))
    mesh_mask = (mesh_acc > 0).float().reshape(h, w)

    coarse = torch.where(full_mask[:, :, None] > 0, warped, background.float())
    return coarse, full_mask, mesh_mask, coords_abs


def author_case(
    ori_img: np.ndarray,       # [H, W, 3] uint8
    ori_mask: np.ndarray,      # [H, W] uint8 0/255
    depth: np.ndarray,         # [H, W] raw depth (max - disparity, or constant 0.5)
    background: np.ndarray,    # [H, W, 3] uint8
    edit_param: Sequence[float],
    focal_length: float = 550.0,
    supersample: int = 4,
    *,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One GeoBench-3D case -> (coarse uint8, full_mask u8*255, mesh_mask
    u8*255, md_mask u8*255, coords_abs [H, W, 2] float32 (x, y)), with
    md_mask = where(mesh_mask, 0, full_mask): the splat coverage the mesh
    does not explain, the benchmark's auto draw mask."""
    h, w = np.asarray(ori_mask).shape[:2]
    if len(list(edit_param)) != 9:
        raise ValueError("3D edit_param must be 9 values")
    dev = torch.device(device)
    d01, valid = normalize_depth(depth)
    m01 = (np.asarray(ori_mask) > 0).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    coarse, full, mesh, coords = geodiff_warp(
        t(ori_img), t(m01), t(d01), t(valid), t(background),
        t(geodiff_transform_matrix(edit_param, length=w)), focal_length,
        supersample=supersample)
    coarse = torch.round(coarse).clamp(0, 255).to(torch.uint8).cpu().numpy()
    full = (full > 0).cpu().numpy().astype(np.uint8) * 255
    mesh = (mesh > 0).cpu().numpy().astype(np.uint8) * 255
    md = np.where(mesh > 0, 0, full).astype(np.uint8)
    return coarse, full, mesh, md, coords.cpu().numpy().astype(np.float32)
