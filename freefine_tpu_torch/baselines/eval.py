"""Pieces of the GeoBench evaluation driver that the ported baselines'
protocols need (mirrors parts of `freefine_tpu.baselines.eval`): the
DragDiffusion point protocol and DiffusionHandles' depth normalisation.
Plain numpy.  The driver itself (case sharding, resume, the results JSON)
is not ported yet (ROADMAP A15).
"""

from __future__ import annotations

import numpy as np

from freefine_tpu_torch.metrics.md import transform_coordinates


def _drag_points_from_case(ori_mask, tgt_mask, edit_param, n_points=30, seed=42):
    """DragDiffusion's GeoBench points: at most `n_points` handles sampled
    from the source mask (numpy's `default_rng(seed)`, without
    replacement), each target its handle's analytic transform; pairs whose
    target leaves the image are dropped.  -> (handles [N, 2], targets
    [N, 2]), image-space (x, y) float64.  `tgt_mask` is unused, as in the
    protocol."""
    size = ori_mask.shape[:2]
    coords_yx = np.argwhere(ori_mask > 0)
    if len(coords_yx) == 0:
        return np.zeros((0, 2)), np.zeros((0, 2))
    if len(coords_yx) > n_points:
        rng = np.random.default_rng(seed)
        coords_yx = coords_yx[rng.choice(len(coords_yx), size=n_points, replace=False)]
    gt = transform_coordinates(edit_param, size, (ori_mask > 0).astype(float))
    handles_xy = coords_yx[:, ::-1].astype(np.float64)
    targets_xy = gt[coords_yx[:, 0], coords_yx[:, 1]][:, ::-1]
    ok = ((targets_xy[:, 0] >= 0) & (targets_xy[:, 0] < size[1])
          & (targets_xy[:, 1] >= 0) & (targets_xy[:, 1] < size[0]))
    return handles_xy[ok], targets_xy[ok]


def geobench_dh_depth(depth: np.ndarray, ori_mask: np.ndarray) -> np.ndarray:
    """DiffusionHandles' GeoBench depth: the depth estimate divided by its
    max (+ 1e-8), plus 1e-2; the far plane (> 0.95) snapped to 1; the
    object (mask > 127) set to the plane 0.5, GeoBench's edits being 2D.
    -> float32 [H, W]."""
    d = np.asarray(depth, np.float32)
    d = d / (d.max() + 1e-8) + 1e-2
    d[d > 0.95] = 1.0
    d[np.asarray(ori_mask) > 127] = 0.5
    return d
