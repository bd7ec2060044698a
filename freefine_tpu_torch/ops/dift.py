"""DIFT semantic correspondence for the PyTorch port (mirrors
`freefine_tpu.ops.dift`).

Stable-Diffusion UNet up-block features as semantic descriptors: noise the
image's latents to t = 261, one UNet forward over an ensemble of 8 noise
draws (one batched pass through `return_features`), take up block
`up_ft_index`, average over the ensemble; points are matched by cosine
argmax.  On the card the pass runs the port's attention and GroupNorm
kernels (rows 1 and 9 of PERF.md's kernel table) at batch 8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from freefine_tpu_torch.ops.resize import resize


def dift_features(unet_apply, latents: torch.Tensor, text_emb: torch.Tensor, schedule,
                  noise: torch.Tensor, t: int = 261, up_ft_index: int = 1) -> torch.Tensor:
    """-> [h', w', C] float32 ensemble-averaged up-block feature map.

    unet_apply(lat, t, ctx, return_features=True) -> (eps, [mid, up_0, ...,
    up_3]) in NHWC (`FreeFine.unet_apply`); latents [1, h, w, 4] clean
    scaled VAE latents; text_emb [1, L, D]; noise [E, h, w, 4] standard
    normal, one draw per ensemble member."""
    ens = noise.shape[0]
    lat = latents.repeat(ens, 1, 1, 1)
    a = schedule.alphas_cumprod[t]
    noised = float(np.sqrt(a)) * lat + float(np.sqrt(np.float32(1.0) - a)) * noise
    emb = text_emb.repeat(ens, 1, 1)
    _, feats = unet_apply(noised, t, emb, return_features=True)
    # features: [mid, up_0, up_1, up_2, up_3]; up_ft_index counts up blocks 0..3
    return feats[1 + up_ft_index].float().mean(0)


def match_points(ft_src: torch.Tensor, ft_tgt: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """For each source point (row, col) of `points` [N, 2], the (row, col)
    of the largest cosine similarity in the target feature map [H, W, C]
    (the first on ties, as `jnp.argmax`)."""
    h, w, c = ft_tgt.shape
    tgt = ft_tgt.reshape(-1, c)
    tgt_n = tgt / (torch.linalg.norm(tgt, dim=-1, keepdim=True) + 1e-8)
    src = ft_src[points[:, 0], points[:, 1]]
    src_n = src / (torch.linalg.norm(src, dim=-1, keepdim=True) + 1e-8)
    idx = torch.argmax(src_n @ tgt_n.T, dim=-1)
    return torch.stack([idx // w, idx % w], dim=-1)


def upsample_features(f: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[h, w, C] -> [hw[0], hw[1], C]: `jax.image.resize(..., "bilinear")`."""
    return resize(f, hw, "linear")


def make_sd_featurizer(pipe, t: int = 261, up_ft_index: int = 1, ensemble_size: int = 8,
                       seed: int = 0, noise: Optional[torch.Tensor] = None):
    """DIFT featurizer over a `FreeFine` pipe's own SD UNet, on the pipe's
    device (CUDA unless the pipe was made on the CPU): VAE-encode the image,
    noise it to train step `t`, one batched UNet forward over the
    ensemble, average up block `up_ft_index`'s features, resize them
    bilinearly to the image's size.  The ensemble noise is the same at
    every call: `noise` [ensemble_size, h, w, 4], or drawn once from a
    `torch.Generator` seeded by `seed` (the JAX package reuses one key).

    Returns `featurize(img_uint8_hwc, prompt) -> np.ndarray [H, W, C]`."""
    schedule = pipe._schedule(50)  # only the full alphas_cumprod table is used
    cfg = pipe.config
    if noise is None:
        gen = torch.Generator(device=pipe.device).manual_seed(seed)
        noise = torch.randn((ensemble_size, cfg.latent_height, cfg.latent_width, 4),
                            generator=gen, device=pipe.device, dtype=torch.float32)
    noise = noise.to(pipe.device, torch.float32)

    @torch.no_grad()
    def featurize(img: np.ndarray, prompt: str) -> np.ndarray:
        h, w = img.shape[:2]
        lat = pipe.image_to_latent(pipe._prep_image(img))
        emb = pipe.encode_text([prompt])
        f = dift_features(pipe.unet_apply, lat, emb, schedule, noise, t=t,
                          up_ft_index=up_ft_index)
        return upsample_features(f, (h, w)).cpu().numpy().astype(np.float32)

    return featurize
