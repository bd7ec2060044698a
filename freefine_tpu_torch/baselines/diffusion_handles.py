"""DiffusionHandles baseline core for the PyTorch port (mirrors
`freefine_tpu.baselines.diffusion_handles`): depth-guided activation
editing.

  1. Null-text inversion (`null_text_invert`): DDIM-invert the image under
     the prompt, then per step optimise the unconditional embedding,
     restarted from "" each step, so that CFG sampling retraces the
     inversion; a record pass keeps the three last decoder taps of every
     step, bilinear-resized to the latent grid.
  2. The object's depth points are transformed and reprojected
     (`ops.point_splat.compute_correspondence`) into coarse old -> new
     pairs on the grid (`process_correspondences`).  A UNet with 5 input
     channels (SD-2-depth's layout) also reads the edited disparity: the
     vacated hole infilled (`inpaint_fmm`), the object's depth carried to
     its new pixels.
  3. The guided pass: per step, `num_optsteps` gradient steps on the latent
     pull the taps toward the recorded ones (foreground across the
     correspondence, background by global average), then one CFG step with
     the null-text embeddings.

Launches follow values, not JAX's pass count: the conditional noise of a
null-text step does not depend on the embedding and is computed once per
step (JAX computes it in every gradient step and once more); the record
pass takes it from its feature pass (JAX runs a third pass) and stops at
`guidance_max_step`, past which only zero weights read the taps; and past
`guidance_max_step` the guided pass takes no gradient, since JAX's steps
there have weight 0 and leave the latent as it was.  On the card each
gradient reaches the flash VJP kernels (rows 3-5 of PERF.md's kernel
table) and the GroupNorm forward; the text cross-attention, through which
the null-text gradient enters, is plain math, as in JAX.

Deterministic (DDIM, eta 0).  Latents and taps are NHWC.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from freefine_tpu_torch.ops.guidance import abs_l1
from freefine_tpu_torch.ops.point_splat import compute_correspondence, inpaint_fmm
from freefine_tpu_torch.ops.resize import resize
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, _f32, ddim_prev, inv_step
from freefine_tpu_torch.utils.profiling import NoStepTimer, synced_stage

# per optimisation step (fg, bg) layer weights, cycled
OPT_WEIGHTS = [
    ([2.5, 2.5, 2.5], [1.25, 1.25, 1.25]),
    ([1.25, 1.25, 1.25], [2.5, 2.5, 2.5]),
    ([1.25, 1.25, 1.25], [1.25, 1.25, 1.25]),
    ([2.5, 2.5, 2.5], [2.5, 2.5, 2.5]),
]


def process_correspondences(corr: np.ndarray, img_res: int, grid: int = 64,
                            max_pts: int = 4096) -> Dict[str, np.ndarray]:
    """Dense [H, W, 2] (row, col) correspondence (NaN outside the object)
    -> the unique coarse pairs on the `grid`^2 activation grid with their
    fine-pixel multiplicities, and the background masks.

    Returns fg_orig / fg_trans [max_pts, 2] int32 (padding rows hold
    `grid`, one past the end), fg_valid [max_pts] float32 (each pair's
    multiplicity, 0 on padding: a count-weighted mean over the unique pairs
    is the plain mean over every fine pixel's pair), bg_orig / bg_trans
    [grid, grid] float32."""
    c = np.asarray(corr)
    ys, xs = np.nonzero(np.isfinite(c[..., 0]))
    ty = c[ys, xs, 0]
    tx = c[ys, xs, 1]
    ok = (ty >= 0) & (ty < img_res) & (tx >= 0) & (tx < img_res)
    ys, xs, ty, tx = ys[ok], xs[ok], ty[ok], tx[ok]

    scale = img_res // grid
    oy, ox = ys // scale, xs // scale
    wy, wx = (ty // scale).astype(np.int64), (tx // scale).astype(np.int64)
    wy, wx = np.clip(wy, 0, grid - 1), np.clip(wx, 0, grid - 1)

    if len(oy):
        pairs, counts = np.unique(np.stack([oy, ox, wy, wx], axis=-1), axis=0,
                                  return_counts=True)
    else:
        pairs = np.zeros((0, 4), np.int64)
        counts = np.zeros((0,), np.int64)

    bg_orig = np.ones((grid, grid), bool)
    bg_trans = np.ones((grid, grid), bool)
    if len(pairs):
        bg_orig[pairs[:, 0], pairs[:, 1]] = False
        bg_trans[pairs[:, 2], pairs[:, 3]] = False

    n = min(len(pairs), max_pts)
    fg_o = np.full((max_pts, 2), grid, np.int32)
    fg_t = np.full((max_pts, 2), grid, np.int32)
    valid = np.zeros((max_pts,), np.float32)
    if n:
        fg_o[:n] = pairs[:n, 0:2]
        fg_t[:n] = pairs[:n, 2:4]
        valid[:n] = counts[:n]
    return {"fg_orig": fg_o, "fg_trans": fg_t, "fg_valid": valid,
            "bg_orig": bg_orig.astype(np.float32), "bg_trans": bg_trans.astype(np.float32)}


def _gather_clamped(act: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """act [g, g, C] at the (row, col) rows of yx [N, 2], each index clamped
    into the grid as JAX's gather clamps it (the padding rows' `grid`)."""
    y = yx[:, 0].long().clamp(0, act.shape[0] - 1)
    x = yx[:, 1].long().clamp(0, act.shape[1] - 1)
    return act[y, x]


def foreground_loss(act, act_orig, fg_orig, fg_trans, fg_valid) -> torch.Tensor:
    """The taps matched across the correspondence: the multiplicity-
    weighted mean over pairs of the channel-mean |act_orig[old] - act[new]|
    (act, act_orig [g, g, C]; padding rows have weight 0)."""
    a_o = _gather_clamped(act_orig, fg_orig)
    a_t = _gather_clamped(act, fg_trans)
    d = abs_l1(a_o - a_t).mean(-1) * fg_valid
    return torch.sum(d) / (torch.sum(fg_valid) + 1e-10)


def background_loss(act, act_orig, bg_orig, bg_trans) -> torch.Tensor:
    """The background's global averages matched: mean |mean of act_orig
    over bg_orig - mean of act over bg_trans| over channels."""
    m1 = bg_orig[..., None]
    m2 = bg_trans[..., None]
    f1 = torch.sum(act_orig * m1, (0, 1)) / (torch.sum(m1) + 1e-10)
    f2 = torch.sum(act * m2, (0, 1)) / (torch.sum(m2) + 1e-10)
    return abs_l1(f1 - f2).mean()


def _with_depth(z: torch.Tensor, depth_ch: Optional[torch.Tensor]) -> torch.Tensor:
    """The UNet input: the latent, and the disparity as a 5th channel."""
    return z if depth_ch is None else torch.cat([z, depth_ch.to(z.dtype)], dim=-1)


def nti_loss(pipe, schedule: DDIMSchedule, z: torch.Tensor, t: int, u: torch.Tensor,
             eps_c: torch.Tensor, target: torch.Tensor, guidance_scale: float,
             depth_ch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The null-text objective at one step: the CFG step from z of the
    embedding u's noise and the conditional one (eps_c, which does not
    depend on u), against the trajectory's target, mean squared."""
    eps_u = pipe.unet_apply(_with_depth(z, depth_ch), t, u)
    eps = eps_u + guidance_scale * (eps_c - eps_u)
    return torch.mean((ddim_prev(schedule, eps, t, z) - target) ** 2)


def null_text_invert(pipe, latent: torch.Tensor, cond_ctx: torch.Tensor, steps: int,
                     guidance_scale: float = 7.5, iters: int = 10, lr: float = 1e-2,
                     depth_ch: Optional[torch.Tensor] = None, timer=None):
    """Null-text inversion: the conditional DDIM inversion trajectory, then
    per step `iters` gradient steps (lr, in the embedding's dtype) on the
    unconditional embedding, restarted from "" each step, so that a CFG
    step retraces the trajectory.  -> (embeddings [steps, 1, L, D],
    trajectory [steps + 1, 1, h, w, 4], [0] the clean latent).  `timer`: a
    `GradStepTimer` of the gradient steps."""
    timer = timer or NoStepTimer()
    schedule = DDIMSchedule.create(num_inference_steps=steps)

    def unet(z, t, ctx):
        return pipe.unet_apply(_with_depth(z, depth_ch), t, ctx)

    with torch.no_grad():
        traj = [latent]
        for t in schedule.timesteps[::-1]:
            traj.append(inv_step(schedule, unet(traj[-1], int(t), cond_ctx), int(t),
                                 traj[-1])[0])
        uncond0 = pipe.encode_text([""])
    z, us = traj[-1], []
    for i, t in enumerate(schedule.timesteps):
        t = int(t)
        target = traj[steps - 1 - i]
        with torch.no_grad():
            eps_c = unet(z, t, cond_ctx)
        u = uncond0
        for _ in range(iters):
            u_opt = u.detach().requires_grad_()
            with torch.enable_grad():
                timer.begin()
                loss = nti_loss(pipe, schedule, z, t, u_opt, eps_c, target, guidance_scale,
                                depth_ch)
                timer.mark("forward")
                g, = torch.autograd.grad(loss, u_opt)
                timer.mark("end")
            u = u - lr * g
        with torch.no_grad():
            eps_u = unet(z, t, u)
            z = ddim_prev(schedule, eps_u + guidance_scale * (eps_c - eps_u), t, z).to(z.dtype)
        us.append(u)
    return torch.stack(us), torch.stack(traj)


class DiffusionHandles:
    """Depth-guided activation editing over a `FreeFine` pipe, on the pipe's
    device."""

    def __init__(self, pipe):
        self.pipe = pipe
        cfg = pipe.config
        self.grid = cfg.latent_height          # the activation grid: the latent's
        self.use_depth = cfg.unet.in_channels == 5

    def _tap(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        """The last three decoder taps, bilinear-resized to the grid in
        float32 (`jax.image.resize`'s "bilinear"), batch dropped."""
        g = self.grid
        return [resize(f, (g, g), "linear", axes=(1, 2))[0] for f in feats[-3:]]

    def _unet(self, z, t, ctx, depth_ch, want_feats: bool):
        return self.pipe.unet_apply(_with_depth(z, depth_ch), t, ctx,
                                    return_features=want_feats)

    def _record(self, schedule, z, cond_ctx, uncond_embs, depth_ch, gs: float, n_steps: int):
        """The CFG sampling pass over the null-text embeddings, keeping the
        conditional pass's taps of its first `n_steps` steps."""
        acts = []
        for i in range(n_steps):
            t = int(schedule.timesteps[i])
            eps_c, feats = self._unet(z, t, cond_ctx, depth_ch, True)
            acts.append(self._tap(feats))
            eps_u = self._unet(z, t, uncond_embs[i], depth_ch, False)
            eps = eps_u.float() + _f32(gs) * (eps_c - eps_u).float()
            z = ddim_prev(schedule, eps, t, z).to(z.dtype)
        return acts

    def guidance_loss(self, z, t: int, cond_ctx, depth_ch, acts_orig, corr, fgw, bgw):
        """The weighted foreground and background losses of the conditional
        pass's taps at latent z against the recorded `acts_orig` (fgw, bgw:
        three float32 layer weights each)."""
        _, feats = self._unet(z, t, cond_ctx, depth_ch, True)
        acts = self._tap(feats)
        loss = torch.zeros((), device=z.device)
        for li in range(3):
            loss = loss + float(fgw[li]) * foreground_loss(
                acts[li], acts_orig[li], corr["fg_orig"], corr["fg_trans"], corr["fg_valid"])
            loss = loss + float(bgw[li]) * background_loss(
                acts[li], acts_orig[li], corr["bg_orig"], corr["bg_trans"])
        return loss

    def _guided(self, schedule, z, cond_ctx, uncond_embs, depth_ch, acts_orig, corr, fgw, bgw,
                gs: float, num_optsteps: int, timer):
        """Per step the latent's gradient steps (lr 0.1) where a weight is
        non-zero, then the CFG step."""
        w = np.asarray(OPT_WEIGHTS, np.float32)
        for i, t in enumerate(schedule.timesteps):
            t = int(t)
            if fgw[i].any() or bgw[i].any():
                for j in range(num_optsteps):
                    z_opt = z.detach().requires_grad_()
                    with torch.enable_grad():
                        timer.begin()
                        loss = self.guidance_loss(z_opt, t, cond_ctx, depth_ch, acts_orig[i],
                                                  corr, fgw[i] * w[j % len(w), 0],
                                                  bgw[i] * w[j % len(w), 1])
                        timer.mark("forward")
                        g, = torch.autograd.grad(loss, z_opt)
                        timer.mark("end")
                    z = z - 0.1 * g.to(z.dtype)
            eps_u = self._unet(z, t, uncond_embs[i], depth_ch, False)
            eps_c = self._unet(z, t, cond_ctx, depth_ch, False)
            eps = eps_u.float() + _f32(gs) * (eps_c - eps_u).float()
            z = ddim_prev(schedule, eps, t, z).to(z.dtype)
        return z

    def edited_disparity(self, depth: np.ndarray, mask01: np.ndarray,
                         corr_map: np.ndarray) -> torch.Tensor:
        """The 5th input channel [1, g, g, 1]: the vacated hole infilled
        (fast marching), the object's depth carried to its new pixels
        (rounded), inverted to disparity, min-max normalised to [-1, 1] and
        resized to the grid (antialiased "linear")."""
        dev = self.pipe.device
        d = np.asarray(depth, np.float32)
        bg = inpaint_fmm(torch.as_tensor(d, device=dev)[..., None],
                         torch.as_tensor(mask01, dtype=torch.float32, device=dev))
        edited = bg[..., 0].cpu().numpy()
        ys, xs = np.nonzero(np.isfinite(corr_map[..., 0]))
        ty = np.clip(np.round(corr_map[ys, xs, 0]).astype(np.int64), 0, d.shape[0] - 1)
        tx = np.clip(np.round(corr_map[ys, xs, 1]).astype(np.int64), 0, d.shape[1] - 1)
        edited[ty, tx] = d[ys, xs]
        disp = 1.0 / np.maximum(edited, 1e-6)
        disp = (disp - disp.min()) / (disp.max() - disp.min() + 1e-8)
        g = self.grid
        return resize(torch.as_tensor(disp * 2.0 - 1.0, device=dev), (g, g),
                      "linear")[None, :, :, None]

    @torch.no_grad()
    def edit(
        self,
        image: np.ndarray,
        depth: np.ndarray,
        mask: np.ndarray,
        edit_param,
        prompt: str = "",
        steps: int = 50,
        fg_weight: float = 1.5,
        bg_weight: float = 1.25,
        num_optsteps: int = 3,
        guidance_max_step: Optional[int] = None,
        guidance_scale: float = 7.5,
        nti_iters: int = 10,
        timer=None,
        grad_timers: Optional[dict] = None,
    ) -> np.ndarray:
        """3D-edit the masked object by its depth (GeoBench's 9-param
        edit_param) -> uint8 [H, W, 3].  `timer`: a `StageTimer` of the
        stages "nti", "record", "guided" and "decode" (each synchronised on
        the card); `grad_timers`: {"nti", "guided": `GradStepTimer`} of the
        differentiated steps."""
        pipe = self.pipe
        dev = pipe.device
        grad_timers = grad_timers or {}
        if guidance_max_step is None:
            guidance_max_step = int(steps * 38 / 50)

        d = np.asarray(depth, np.float32)
        m01 = np.asarray(mask) > 0
        corr_map = compute_correspondence(d, m01, edit_param, device=dev)
        corr = {k: torch.as_tensor(v, device=dev) for k, v in
                process_correspondences(corr_map, pipe.config.height, grid=self.grid).items()}
        depth_ch = self.edited_disparity(d, m01, corr_map) if self.use_depth else None

        with synced_stage(timer, "nti", dev):
            latent = pipe.image_to_latent(image)
            cond_ctx = pipe.encode_text([prompt])
            uncond_embs, traj = null_text_invert(pipe, latent, cond_ctx, steps, guidance_scale,
                                                 nti_iters, depth_ch=depth_ch,
                                                 timer=grad_timers.get("nti"))
        schedule = DDIMSchedule.create(num_inference_steps=steps)
        on = (np.arange(steps) < guidance_max_step).astype(np.float32)
        fgw = (np.float32(30.0 * fg_weight) * on)[:, None] * np.ones((1, 3), np.float32)
        bgw = (np.float32(30.0 * bg_weight) * on)[:, None] * np.ones((1, 3), np.float32)
        with synced_stage(timer, "record", dev):
            acts_orig = self._record(schedule, traj[-1], cond_ctx, uncond_embs, depth_ch,
                                     guidance_scale, min(guidance_max_step, steps))
        with synced_stage(timer, "guided", dev):
            z = self._guided(schedule, traj[-1], cond_ctx, uncond_embs, depth_ch, acts_orig,
                             corr, fgw, bgw, guidance_scale, num_optsteps,
                             grad_timers.get("guided") or NoStepTimer())
        with synced_stage(timer, "decode", dev):
            return pipe.latent_to_image(z)[0]
