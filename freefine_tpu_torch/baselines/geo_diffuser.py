"""GeoDiffuser baseline core for the PyTorch port (mirrors
`freefine_tpu.baselines.geo_diffuser`): geometric editing by attention
sharing and latent optimisation.

  1. DDIM-invert the image (unconditional; GeoBench passes the prompt "").
  2. Denoise a [base, edit] batch whose every attention runs
     `EditConfig(mode="geodiff")` (`ops.attention.geodiff_attention`): the
     edit stream's output is the warped base queries' attention inside the
     moved object and its live attention elsewhere, and each layer at the
     top two grids records its preservation, placement, removal, amodal and
     smoothness losses in `EditState.intermediates`.
  3. On the first `optimize_steps` of the steps, the summed weighted losses
     are differentiated to the edit latent (one `torch.autograd.grad`
     through the batch-2 UNet), which takes a norm-preserving step (lr 0.03,
     doubled inside the warped object, NaNs zeroed); the base stream is
     pinned to the inversion trajectory for the first `latent_replace`; an
     adaptive controller scales the self-attention removal weight.

On the card the gradient reaches the flash VJP kernels (rows 3-5 of
PERF.md's kernel table) in each self-attention's live output, and the plain
attention kernel in its other two (`geodiff_attention`).  On the steps past
`optimize_steps` the port takes no gradient (JAX takes it and multiplies
the step by 0, which leaves the latent as it was).

Deterministic (DDIM, eta 0).  Latents are NHWC.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from freefine_tpu_torch.edit import (
    EditConfig,
    EditState,
    attention_resolutions,
    build_mask_pyramid,
)
from freefine_tpu_torch.masks import dilate
from freefine_tpu_torch.ops.geometry import edit_affine_matrix, invert_affine, mask_bbox_center
from freefine_tpu_torch.ops.resize import resize
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, _f32, ddim_prev
from freefine_tpu_torch.utils.profiling import NoStepTimer

LOSS_WEIGHTS = {
    # (self, cross) weights of GeoBench's evaluation
    "sim": (0.74, 0.5),
    "movement": (6.5, 3.34),
    "removal": (4.34, 2.67),
    "smooth": (0.0, 0.0),
    "amodal": (80.5, 3.5),
}


def warp_coord_pyramid(matrix: np.ndarray, latent_h: int, latent_w: int,
                       device="cpu") -> Dict[int, torch.Tensor]:
    """{S: [h, w, 2]} inverse-warp grids of absolute (y, x) source
    coordinates at each attention grid, from a full-resolution 2 x 3
    affine edit matrix (float32)."""
    inv = invert_affine(np.asarray(matrix, np.float64))
    out = {}
    for h, w in attention_resolutions(latent_h, latent_w):
        sy, sx = latent_h / h, latent_w / w
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        # to full-resolution pixels (the latent's factor 8 cancels in the affine)
        fx = (xs + 0.5) * sx * 8.0
        fy = (ys + 0.5) * sy * 8.0
        src_x = inv[0, 0] * fx + inv[0, 1] * fy + inv[0, 2]
        src_y = inv[1, 0] * fx + inv[1, 1] * fy + inv[1, 2]
        grid = np.stack([src_y / (sy * 8.0) - 0.5, src_x / (sx * 8.0) - 0.5], -1)
        out[h * w] = torch.as_tensor(grid.astype(np.float32), device=device)
    return out


def warp_mask(mask: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Forward-warp a full-resolution 0/1 mask by the 2 x 3 affine
    (nearest, binarised)."""
    h, w = mask.shape
    inv = invert_affine(np.asarray(matrix, np.float64))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    ix = np.clip(np.round(sx).astype(np.int64), 0, w - 1)
    iy = np.clip(np.round(sy).astype(np.int64), 0, h - 1)
    inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    return ((mask[iy, ix] > 0.5) & inside).astype(np.float32)


def _sum_geodiff_losses(inters: dict, place_weights=LOSS_WEIGHTS,
                        removal_self_mult=1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recorded geodiff losses ({(path..., "geodiff_{name}"): [values]})
    weighted by place: self-attention where the path holds "attn1", else
    cross.  -> (weighted total, the unweighted self-attention removal sum,
    which the adaptive controller reads).  `removal_self_mult` scales the
    self-attention removal weight alone."""
    total = removal_self = None
    for key, vals in inters.items():
        name = key[-1][len("geodiff_"):]
        if not key[-1].startswith("geodiff_") or name not in place_weights:
            continue
        w_self, w_cross = place_weights[name]
        is_self = "attn1" in key
        for val in vals:
            w = w_self if is_self else w_cross
            if name == "removal" and is_self:
                w = float(np.float32(w) * np.float32(removal_self_mult))
                removal_self = val if removal_self is None else removal_self + val
            total = w * val if total is None else total + w * val
    zero = torch.zeros(())
    total = zero if total is None else total
    removal_self = torch.zeros((), device=total.device) if removal_self is None else removal_self
    return total, removal_self


def adaptive_removal_schedule(steps: int, skip: int = 1,
                              removal_in: float = -1.5) -> Tuple[np.ndarray, np.ndarray]:
    """Per-step (phase, expected loss) of the adaptive removal-weight
    controller.  Phase 0 (i/N < 0.4): expected = removal_in / 1.25^r with
    r = int((0.4 - i/N) N / skip), the weight x1.3 above it and /2 far
    below it; phase 1 (0.4 < i/N < 0.8): x2 while the loss exceeds
    removal_in - 0.3, else reset; phase 2 (i/N = 0.4 or >= 0.8): reset to 1."""
    i = np.arange(steps)
    p = i / steps
    phase = np.where(p < 0.4, 0, np.where((p > 0.4) & (p < 0.8), 1, 2))
    remaining = ((0.4 - p) * steps / skip).astype(np.int64)
    expected = removal_in / (1.25 ** np.maximum(remaining, 0))
    return phase.astype(np.int32), expected.astype(np.float32)


class GeoDiffuser:
    """Attention-optimisation geometric editing over a `FreeFine` pipe, on
    the pipe's device."""

    def __init__(self, pipe):
        self.pipe = pipe

    def edit_config(self) -> EditConfig:
        """geodiff in every attention; losses at the top two grids, the
        removal and amodal ones at the second (the reference's hw >= 32^2
        gate at SD's 64^2 latent, relative to the configured latent)."""
        cfg = self.pipe.config
        return EditConfig(mode="geodiff", method=None, local_cfg=False,
                          geodiff_loss_seq=(cfg.latent_height * cfg.latent_width) // 4)

    def edit_state(self, mask: np.ndarray, edit_param):
        """The masks and warp of an edit_param's 2D affine about the mask's
        box centre -> (EditState with the object (fg_ref), warped object
        (fg_retain), amodal ring (local_region: the dilated warped object
        minus it) and warp pyramids; the full-resolution warped mask)."""
        cfg = self.pipe.config
        dev = self.pipe.device
        lh, lw = cfg.latent_height, cfg.latent_width
        m = (np.asarray(mask) > 0).astype(np.float32)
        p = list(map(float, edit_param))
        matrix = edit_affine_matrix(mask_bbox_center(m), p[0], p[1], p[5],
                                    p[6] if p[6] else 1.0, p[7] if p[7] else 1.0)
        mw_t = torch.as_tensor(warp_mask(m, matrix), device=dev)
        ring = torch.clamp(dilate(mw_t, max(cfg.height // 32, 2)) - mw_t, 0.0, 1.0)
        state = EditState(fg_ref=build_mask_pyramid(torch.as_tensor(m, device=dev), lh, lw),
                          fg_retain=build_mask_pyramid(mw_t, lh, lw),
                          local_region=build_mask_pyramid(ring, lh, lw),
                          warp_coords=warp_coord_pyramid(matrix, lh, lw, dev))
        return state, mw_t

    def _unet_losses(self, ecfg, pair, t, ctx2, state, rem_mult):
        st = EditState(fg_retain=state.fg_retain, fg_ref=state.fg_ref,
                       local_region=state.local_region, warp_coords=state.warp_coords,
                       share_gate=state.share_gate, intermediates={})
        eps = self.pipe.unet_apply(pair, t, ctx2, ecfg, st)
        total, removal_self = _sum_geodiff_losses(st.intermediates,
                                                  removal_self_mult=rem_mult)
        return eps, total, removal_self

    def _loop(self, schedule, lat2, ctx2, state, traj, gates, lr_sched, m_warp_lat,
              adapt_sched, removal_in: float, timer):
        ecfg = self.edit_config()
        mw = m_warp_lat[None, :, :, None]
        one = np.float32(1.0)
        lat, rem_mult = lat2, np.float32(1.0)
        for i, t in enumerate(schedule.timesteps):
            t = int(t)
            g_opt, g_share, g_pin = gates[i]
            st = EditState(fg_retain=state.fg_retain, fg_ref=state.fg_ref,
                           local_region=state.local_region, warp_coords=state.warp_coords,
                           share_gate=float(g_share))
            if g_pin > 0:
                lat = torch.cat([traj[len(traj) - 1 - i], lat[1:2]], dim=0)

            if g_opt > 0:
                # the edit stream's latent step: doubled inside the warped
                # object, NaNs zeroed, the latent's norm kept
                z_edit = lat[1:2].detach().requires_grad_()
                with torch.enable_grad():
                    timer.begin()
                    _, loss, removal = self._unet_losses(
                        ecfg, torch.cat([lat[0:1], z_edit], dim=0), t, ctx2, st, rem_mult)
                    timer.mark("forward")
                    grad, = torch.autograd.grad(loss, z_edit)
                    timer.mark("end")
                grad = torch.nan_to_num(grad, nan=0.0, posinf=0.0, neginf=0.0)
                z_old = lat[1:2].float()
                z_new = z_old - _f32(np.float32(g_opt) * lr_sched[i]) * (1.0 + mw) * grad.float()
                z_new = z_new * (torch.linalg.norm(z_old) / (torch.linalg.norm(z_new) + 1e-12))
                lat = torch.cat([lat[0:1], z_new.to(lat.dtype)], dim=0)

                # the adaptive removal-weight controller, on optimisation steps
                ad_on, phase, expected = adapt_sched[i]
                if ad_on > 0:
                    r = np.float32(removal.item())
                    if phase == 0:
                        new = (rem_mult * np.float32(1.3) if r > expected
                               else rem_mult / np.float32(2.0) if np.float32(2.5) * expected > r
                               else rem_mult)
                    elif phase == 1:
                        new = (rem_mult * np.float32(2.0)
                               if r > np.float32(removal_in) - np.float32(0.3) else one)
                    else:
                        new = one
                    rem_mult = np.float32(new)

            # the denoise step, with attention sharing
            with torch.no_grad():
                eps, _, _ = self._unet_losses(ecfg, lat, t, ctx2, st, rem_mult)
            lat = ddim_prev(schedule, eps, t, lat).to(lat.dtype)
        return lat

    @torch.no_grad()
    def edit(
        self,
        image: np.ndarray,
        mask: np.ndarray,
        edit_param,
        prompt: str = "",
        steps: int = 50,
        lr: float = 0.03,
        optimize_steps: float = 0.95,
        latent_replace: float = 0.6,
        share_steps: float = 0.97,
        adaptive: bool = True,
        removal_loss_value: float = -1.5,
        seed: int = 42,
        timer=None,
    ) -> np.ndarray:
        """A geometric edit by GeoBench's 9-param edit_param (the 2D affine
        of its dx, dy, rz, sx, sy) -> uint8 [H, W, 3].  `timer`: a
        `GradStepTimer` of the optimisation steps."""
        pipe = self.pipe
        cfg = pipe.config
        lh, lw = cfg.latent_height, cfg.latent_width
        schedule = DDIMSchedule.create(num_inference_steps=steps)
        state, mw_t = self.edit_state(mask, edit_param)

        traj = pipe.invert(pipe.image_to_latent(image), steps, 0)
        ctx = pipe.encode_text([prompt])
        ctx2 = torch.cat([ctx, ctx], dim=0)

        n = steps
        i = np.arange(n)
        gates = np.stack([i < optimize_steps * n, i < share_steps * n, i < latent_replace * n],
                         axis=1).astype(np.float32)
        # the decaying step: lr * (N - i) * 50 / N
        lr_sched = (lr * (n - i) * (50.0 / n)).astype(np.float32)
        m_warp_lat = resize(mw_t, (lh, lw), "nearest")
        phase, expected = adaptive_removal_schedule(steps, removal_in=removal_loss_value)
        adapt_sched = np.stack([np.full(steps, 1.0 if adaptive else 0.0, np.float32),
                                phase.astype(np.float32), expected], axis=1)

        lat2 = torch.cat([traj[-1], traj[-1]], dim=0)
        out = self._loop(schedule, lat2, ctx2, state, traj, gates, lr_sched, m_warp_lat,
                            adapt_sched, float(removal_loss_value), timer or NoStepTimer())
        return pipe.latent_to_image(out[1:2])[0]
