"""GeoBench-3D dataset authoring helpers (mirrors the part of
`freefine_tpu.data.datagen` that the SV3D coarse 3D edit runs).

`generate_azimuth_angles` is the orbit of azimuths SV3D samples, so that
the requested angles are frames of it.  It is numpy, copied here so that
the port does not import the JAX package.  The rest of the dataset
authoring (`sample_instance_edits`, its 3D branch, and the command line
that writes the dataset) is not ported yet (ROADMAP A15).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def generate_azimuth_angles(
    n_views: int = 21, angle_list_3d: Optional[Sequence[float]] = None
) -> List[float]:
    """SV3D orbital azimuth list hitting the requested angles: the first
    half of `angle_list_3d` kept, the second half wrapped to 360 + a, the
    remaining views spread evenly over [0, 360), all sorted, then 0 last."""
    angle_list_3d = list(angle_list_3d or [])
    half = len(angle_list_3d) // 2
    fwd = np.array(angle_list_3d[:half], np.float64)
    bwd = np.array([360 + a for a in angle_list_3d[half:]], np.float64)
    assert len(fwd) + len(bwd) < n_views
    remaining = n_views - len(fwd) - len(bwd) - 1
    rest = (
        np.linspace(0, 360, remaining + 1)[:-1] % 360
        if remaining > 0 else np.array([])
    )
    az = np.sort(np.concatenate([fwd, bwd, rest]) % 360)
    return list(np.concatenate([az, [0.0]]))
