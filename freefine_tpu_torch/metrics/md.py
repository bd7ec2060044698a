"""The mean-distance metric's ground truth (mirrors the geometry half of
`freefine_tpu.metrics.md`): where every source pixel lands after a GeoBench
edit.  Plain numpy, as in the JAX package.

  * 2D translate: analytic pixel offsets;
  * 2D rotate / scale: the rotation or scale matrix about the mask's centre
    of mass;
  * 3D: a precomputed dense correspondence `.npy`, axes flipped.

The keypoint matching and the DIFT distance of the metric are not ported
yet (ROADMAP A15).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def center_of_mass(mask01: np.ndarray) -> Tuple[float, float]:
    """(x, y) mean of the mask's pixels above 0.5."""
    ys, xs = np.nonzero(mask01 > 0.5)
    return (float(xs.mean()), float(ys.mean()))


def transform_coordinates(
    edit_param: Sequence[float], size, mask01: np.ndarray,
    path_3d: Optional[str] = None,
) -> np.ndarray:
    """Ground-truth (row, col) [H, W, 2] float64 of every source pixel
    after the edit.  edit_param is GeoBench's [dx, dy, dz, rx, ry, rz, sx,
    ...]: a shift (dx, dy pixels) wins over a rotation (rz degrees), which
    wins over a scale (sx) about the mask's centre of mass; an edit with
    none of them reads `path_3d`."""
    p = list(map(float, edit_param))
    h, w = size
    if p[0] != 0 or p[1] != 0:
        rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        return np.stack([rr + p[1], cc + p[0]], axis=-1).astype(np.float64)
    if p[5] != 0 or p[6] != 1:
        cx, cy = center_of_mass(mask01)
        if p[5] != 0:
            theta = np.deg2rad(p[5])
            a, b = np.cos(theta), np.sin(theta)
            matrix = np.array([[a, b, (1 - a) * cx - b * cy],
                               [-b, a, b * cx + (1 - a) * cy]])
        else:
            s = p[6]
            matrix = np.array([[s, 0, (1 - s) * cx], [0, s, (1 - s) * cy]])
        # the metric's grids are built transposed: x runs down the rows
        y, x = np.meshgrid(np.arange(w), np.arange(h))
        pts = np.stack((x, y, np.ones_like(x)), axis=-1).reshape(-1, 3)
        return pts.dot(matrix.T).reshape(h, w, 2)
    if path_3d is None:
        raise ValueError("a 3D edit needs its dense correspondence .npy (path_3d)")
    return np.load(path_3d)[..., ::-1].copy()
