"""GeoBench baseline-method cores of the port (mirrors `freefine_tpu.baselines`):
MotionGuidance, RegionDrag, DesignEdit, SelfGuidance, GeoDiffuser, DiffusionHandles
and DragDiffusion."""

from freefine_tpu_torch.baselines.design_edit import DesignEdit
from freefine_tpu_torch.baselines.diffusion_handles import DiffusionHandles
from freefine_tpu_torch.baselines.drag_diffusion import DragDiffusion
from freefine_tpu_torch.baselines.geo_diffuser import GeoDiffuser
from freefine_tpu_torch.baselines.motion_guidance import MotionGuidance
from freefine_tpu_torch.baselines.region_drag import RegionDrag, region_pair_to_pts
from freefine_tpu_torch.baselines.self_guidance import SelfGuidance

__all__ = ["DesignEdit", "DiffusionHandles", "DragDiffusion", "GeoDiffuser", "MotionGuidance",
           "RegionDrag", "SelfGuidance", "region_pair_to_pts"]
