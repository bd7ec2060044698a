"""Visualisation for the PyTorch port (mirrors `freefine_tpu.utils.vis`):
VAE-free latent previews (the reference's `Latent2RGBPreviewer`, a linear
4 -> 3 projection of SD latents) and a step-annotated GIF of them.

PIL is imported inside `save_intermediate_gif` only: nothing on the
serving path needs it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

# The SD-1.5 linear latent -> RGB factors of the reference previewer.
SD15_LATENT_RGB_FACTORS = np.array(
    [
        [0.3512, 0.2297, 0.3227],
        [0.3250, 0.4974, 0.2350],
        [-0.2829, 0.1762, 0.2721],
        [-0.2120, -0.2616, -0.7177],
    ],
    np.float32,
)


def latent_to_preview(
    latents: torch.Tensor,
    factors: Optional[np.ndarray] = None,
    bias: Optional[np.ndarray] = None,
) -> np.ndarray:
    """[..., h, w, 4] latents -> uint8 [..., h, w, 3] previews: the
    projection, ((x + 1) / 2) clamped to [0, 1], times 255, truncated."""
    f = torch.as_tensor(factors if factors is not None else SD15_LATENT_RGB_FACTORS,
                        dtype=torch.float32, device=latents.device)
    img = latents.float() @ f
    if bias is not None:
        img = img + torch.as_tensor(bias, dtype=torch.float32, device=latents.device)
    img = torch.clamp((img + 1.0) / 2.0, 0.0, 1.0) * 255.0
    return img.cpu().numpy().astype(np.uint8)


def save_intermediate_gif(
    frames: Sequence[np.ndarray],
    output_folder: str = "sd_steps_output",
    gif_name: str = "sd_progress.gif",
    duration: int = 200,
    annotate: bool = True,
) -> str:
    """Save one PNG per step and an animated GIF of them, each frame
    annotated with its step (the reference's
    save_intermediate_images_and_gif_v2).  Returns the GIF's path."""
    from PIL import Image, ImageDraw

    os.makedirs(output_folder, exist_ok=True)
    images = []
    for idx, frame in enumerate(frames):
        img = Image.fromarray(np.asarray(frame).astype(np.uint8))
        if annotate:
            ImageDraw.Draw(img).text((10, 10), f"Step = {idx}", fill=(255, 0, 0))
        img.save(os.path.join(output_folder, f"denoise_step_{idx:03d}.png"))
        images.append(img)
    gif_path = os.path.join(output_folder, gif_name)
    if images:
        images[0].save(gif_path, save_all=True, append_images=images[1:], duration=duration,
                       loop=0)
    return gif_path
