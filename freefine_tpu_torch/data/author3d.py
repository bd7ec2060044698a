"""GeoBench-3D input authoring: the depth factory (mirrors the part of
`freefine_tpu.data.author3d` that runs on one device).

`make_depth_fn` builds the depth predictor the authoring warp and the
depth-based 3D edit take: Depth-Anything's disparity resized to the image
and turned into depth as `max - disparity` (GeoDiffuser's
depth_predictor), or the constant-depth mode (all 0.5).  The loop over
GeoBench's cases that writes its folders (`run_geobench_author3d`) needs
the harness's file I/O and gather and is not ported yet (ROADMAP A15).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from freefine_tpu_torch.models.depth_anything import (
    DepthAnything,
    depth_anything_vitb,
    depth_anything_vitl,
    depth_anything_vits,
    preprocess_depth_input,
)
from freefine_tpu_torch.ops.resize import resize

LENGTH = 512  # the benchmark's working resolution

ENCODERS = {"vits": depth_anything_vits, "vitb": depth_anything_vitb,
            "vitl": depth_anything_vitl}


def make_depth_fn(
    mode: str = "depth_anything",
    checkpoint: Optional[str] = None,
    encoder: str = "vits",
    *,
    device: str | torch.device = "cuda",
    seed: int = 0,
    model: Optional[DepthAnything] = None,
    size: int = 518,
) -> Callable[[np.ndarray], np.ndarray]:
    """Depth predictor factory: uint8 [H, W, 3] -> float32 depth [H, W].

    "depth_anything": `model`, or a Depth-Anything of `encoder`'s size on
    `device` loaded from a transformers checkpoint (`checkpoint`) or, with
    none, given the bench's random weights from `seed`; its disparity at
    `size` (`preprocess_depth_input`) is resized to the image by
    `jax.image.resize`'s antialiased "linear" (a shrink from 518 widens the
    triangle, which `F.interpolate` does not) and becomes
    clip(max - disparity, 0).  "constant": all 0.5."""
    if mode == "constant":
        return lambda img: np.full(np.asarray(img).shape[:2], 0.5, np.float32)
    if mode != "depth_anything":
        raise ValueError(f"depth mode {mode!r}: 'depth_anything' or 'constant'")
    if model is None:
        from freefine_tpu_torch.weights import load_depth_anything, random_weights

        model = DepthAnything(ENCODERS[encoder](), device=torch.device(device)).eval()
        if checkpoint:
            load_depth_anything(model, checkpoint)
        else:
            random_weights(model, seed)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def predict(img: np.ndarray) -> np.ndarray:
        disp = model(preprocess_depth_input(img, size=size, device=dev))[0]
        h, w = np.asarray(img).shape[:2]
        disp = resize(disp, (h, w), "linear")
        return torch.clamp(disp.max() - disp, min=0.0).cpu().numpy().astype(np.float32)

    return predict
