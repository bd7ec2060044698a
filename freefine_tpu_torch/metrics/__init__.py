"""GeoBench's metrics in the port (mirrors `freefine_tpu.metrics`): FID,
IRS, HPS, BGC, SUBC, WRAP_E, FID_DINO and FID_KD (`main`), and MD's ground
truth and distances (`md`; its SIFT keypoints are not ported)."""

from freefine_tpu_torch.metrics.common import (  # noqa: F401
    frechet_distance,
    gaussian_stats,
    polynomial_mmd,
)
from freefine_tpu_torch.metrics.wrap_error import wrap_error  # noqa: F401
