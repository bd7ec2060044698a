"""Energy guidance for the PyTorch port (mirrors `freefine_tpu.ops.guidance`):
DragonDiffusion-style feature-cosine energies whose gradient with respect
to the latent is taken through the plain UNet's feature taps
(`UNet2DCondition(..., return_features=True)`).

Energies (the reference's guidance_move):
  * edit     : w_edit / (1 + 4 * sim(cur@mask_cur, tar@mask_tar))
  * content  : w_content / (1 + 4 * sim(cur, tar_org) @ mask_other)
  * contrast : w_contrast * (cos+1)/2 on the non-overlap region
  * inpaint  : w_inpaint / (1 + 4 * cos(masked means))
Guidance = 8e-2 * (grad_edit * mask_edit + grad_content * (1 - mask_edit)).

Layouts are the JAX package's: latents and features NHWC, masks [h, w].
The gradient goes through autograd; every self-attention it crosses is
`flash_sdpa_diff` (the flash backward kernels on CUDA).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _resize(f: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[B, h, w, C] -> [B, hw[0], hw[1], C] nearest, sampling pixel centres
    as `jax.image.resize(method="nearest")` does (torch's "nearest-exact";
    plain "nearest" anchors top-left and agrees only at integer upsampling
    factors)."""
    x = F.interpolate(f.permute(0, 3, 1, 2), size=tuple(hw), mode="nearest-exact")
    return x.permute(0, 2, 3, 1)


def abs_l1(x: torch.Tensor) -> torch.Tensor:
    """|x| for an L1 term under autograd, with `jnp.abs`'s gradient: +1
    where x >= 0, -1 below (`torch.abs` takes 0 at x = 0).  An L1 term at
    an exact zero residual (a tap against its own record, a latent against
    its own reference) so pushes as the JAX package's does."""
    return torch.where(x >= 0, x, -x)


def _compute_type(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)  # bf16 up, f64 kept


def masked_cosine(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                  eps: float = 1e-8) -> torch.Tensor:
    """Mean over masked positions of the per-pixel channel cosine.
    a, b [h, w, C]; mask [h, w] weights.  eps clamps the denominator,
    max(den, eps), as torch.nn.CosineSimilarity does (not den + eps)."""
    ct = _compute_type(a.dtype)
    a32, b32 = a.to(ct), b.to(ct)
    num = (a32 * b32).sum(-1)
    den = torch.clamp(torch.linalg.vector_norm(a32, dim=-1) * torch.linalg.vector_norm(b32, dim=-1),
                      min=eps)
    return ((num / den) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def global_masked_cosine(a: torch.Tensor, b: torch.Tensor, mask_a: torch.Tensor,
                         mask_b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Cosine of the masked mean feature vectors (clamped eps)."""
    ct = _compute_type(a.dtype)
    ma = (a.to(ct) * mask_a[..., None]).sum((0, 1)) / torch.clamp(mask_a.sum(), min=1.0)
    mb = (b.to(ct) * mask_b[..., None]).sum((0, 1)) / torch.clamp(mask_b.sum(), min=1.0)
    den = torch.linalg.vector_norm(ma) * torch.linalg.vector_norm(mb)
    return (ma @ mb) / torch.clamp(den, min=eps)


def warp_features(f: torch.Tensor, inv_matrix: torch.Tensor) -> torch.Tensor:
    """Affine-resample a [h, w, C] feature map (dst->src matrix [2, 3] in the
    feature grid's pixel units): bilinear, zero outside the grid, as
    `map_coordinates(order=1, mode="constant")` (grid_sample with
    align_corners=True maps -1/1 to the centres of the edge pixels)."""
    h, w, _ = f.shape
    m = inv_matrix.to(torch.float32)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=f.device),
                            torch.arange(w, dtype=torch.float32, device=f.device), indexing="ij")
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    grid = torch.stack([2.0 * sx / max(w - 1, 1) - 1.0, 2.0 * sy / max(h - 1, 1) - 1.0], dim=-1)
    out = F.grid_sample(f.permute(2, 0, 1)[None], grid[None].to(f.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out[0].permute(1, 2, 0)


def move_energy(
    unet_apply: Callable,
    latent: torch.Tensor,           # [1, h, w, 4] current latent
    ref_latent: torch.Tensor,       # [1, h, w, 4] inverted reference latent
    t,
    text_emb: torch.Tensor,         # [1, L, D]
    *,
    feature_indices: Sequence[int] = (1, 2),
    target_hw: Tuple[int, int],
    inv_warp: Optional[torch.Tensor],  # dst->src affine on the feature grid
    mask_cur: torch.Tensor,         # [H', W'] target-position mask
    mask_other: torch.Tensor,       # [H', W'] content-preservation region
    mask_non_overlap: torch.Tensor,  # [H', W'] vacated region
    w_edit: float = 4.0,
    w_content: float = 6.0,
    w_contrast: float = 0.2,
    w_inpaint: float = 0.8,
    split: bool = False,
):
    """Object-move editing energy (the reference's guidance_move).

    `unet_apply(sample, t, text_emb, return_features=True)` returns (eps,
    features) with NHWC features (the pipeline's `unet_apply`); the module
    holds the weights, where the JAX function takes `params`.  The reference
    features are computed under no_grad (JAX: stop_gradient).

    Returns the scalar total, or with ``split=True`` the pair (loss_edit,
    loss_con), whose gradients are composed separately.  Per level the edit,
    content and contrast terms carry the 0.5 loss scale and the inpaint term
    does not, as in the reference."""
    loss_scale = (0.5, 0.5)
    with torch.no_grad():
        _, feats_tar = unet_apply(ref_latent, t, text_emb, return_features=True)
    feats_tar = [feats_tar[i] for i in feature_indices]
    _, feats_cur = unet_apply(latent, t, text_emb, return_features=True)
    feats_cur = [feats_cur[i] for i in feature_indices]

    loss_edit = torch.zeros((), dtype=torch.float32, device=latent.device)
    loss_con = torch.zeros((), dtype=torch.float32, device=latent.device)
    for s, fc, ft in zip(loss_scale, feats_cur, feats_tar):
        fc = _resize(fc, target_hw)[0]
        ft = _resize(ft, target_hw)[0]
        ft_warp = ft if inv_warp is None else warp_features(ft, inv_warp)

        sim_edit = masked_cosine(fc, ft_warp, mask_cur)
        loss_edit = loss_edit + s * w_edit / (1.0 + 4.0 * sim_edit)

        sim_other = masked_cosine(fc, ft, mask_other)
        loss_con = loss_con + s * w_content / (1.0 + 4.0 * sim_other)

        sim_no = (masked_cosine(fc, ft, mask_non_overlap) + 1.0) / 2.0
        loss_con = loss_con + s * w_contrast * sim_no

        sim_inp = (global_masked_cosine(fc, ft, mask_non_overlap, mask_other) + 1.0) / 2.0
        loss_con = loss_con + w_inpaint / (1.0 + 4.0 * sim_inp)
    if split:
        return loss_edit, loss_con
    return loss_edit + loss_con


def energy_guidance(
    unet_apply: Callable,
    latent: torch.Tensor,
    ref_latent: torch.Tensor,
    t,
    text_emb: torch.Tensor,
    energy_scale: float,
    guidance_mask: torch.Tensor,    # [h, w] latent-res edit mask
    **energy_kwargs,
) -> torch.Tensor:
    """d(energy)/d(latent) composed as the reference does: one forward, two
    gradient pulls (the second on the retained graph), then
    8e-2 * (grad_edit inside the edit mask + grad_con outside it), each pull
    seeded with `energy_scale`.  `guidance_mask` is the latent-resolution
    edit mask (values > 0.5 count as inside).  Runs under enable_grad on a
    detached copy of `latent`; returns a tensor with no graph."""
    z = latent.detach().requires_grad_()
    with torch.enable_grad():
        l_e, l_c = move_energy(unet_apply, z, ref_latent, t, text_emb, split=True,
                               **energy_kwargs)
        g_edit, = torch.autograd.grad(l_e, z, torch.full_like(l_e, energy_scale),
                                      retain_graph=True)
        g_con, = torch.autograd.grad(l_c, z, torch.full_like(l_c, energy_scale))
    m = (guidance_mask > 0.5).to(g_edit.dtype)[None, :, :, None]
    return 8e-2 * (g_edit * m + g_con * (1.0 - m))
