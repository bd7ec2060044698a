"""MotionGuidance baseline core for the PyTorch port (mirrors
`freefine_tpu.baselines.motion_guidance`): flow-guided diffusion sampling.

A target optical flow, built analytically from a GeoBench edit_param,
defines an energy

    E(x0) = flow_weight * |RAFT(src, x0) - target_flow|_1
          + color_weight * |src - warp(x0, RAFT(src, x0))|_1 (occlusion-masked)

whose gradient, taken through RAFT and the VAE decode, steers every denoise
step, with RePaint-style latent pinning outside the edit mask and recursive
(time-travel) resampling.

The energy is one `torch.autograd.grad` through the UNet (the pipe's dtype,
batch 2: unconditional and conditional), DDIM's x0 in float32,
`vae.decode` (whose mid-block attention is float32) and RAFT.  On the card that reaches the flash VJP kernels
(rows 3-5 of PERF.md's kernel table) in the UNet and in the VAE mid-block's
float32 head of 512, and the GroupNorm kernel's forward.

`warp` is the floor-and-gather bilinear of `ops.flow.map_coordinates_linear`
with mirror indices (JAX's `map_coordinates(mode="mirror")`, reflection
about the edge pixels' centres), so autograd through it gives the same
exact zeros as `jax.grad`: `occlusion_mask` keeps the pixels whose gradient
is exactly 0.

Noise is an input: `edit(noise=(z_T, draws))` replays given draws (the
tests replay JAX's); otherwise a `torch.Generator` seeded by `seed` draws
z_T, then per step and recursive step the pinning noise and the re-noise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from freefine_tpu_torch.ops.flow import map_coordinates_linear
from freefine_tpu_torch.ops.resize import resize
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule


# ---------------------------------------------------------------------------
# Flow utilities
# ---------------------------------------------------------------------------


def warp(im: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp [B, H, W, C] by a relative pixel flow [B, H, W, 2]
    (x, y): sample at the absolute positions (y + flow_y, x + flow_x) with
    mirror padding."""
    b, h, w, c = im.shape
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=im.device),
                            torch.arange(w, dtype=torch.float32, device=im.device),
                            indexing="ij")
    yy = (ys + flow[..., 1])[:, None].expand(b, c, h, w).reshape(b * c, h, w)
    xx = (xs + flow[..., 0])[:, None].expand(b, c, h, w).reshape(b * c, h, w)
    out = map_coordinates_linear(im.permute(0, 3, 1, 2).reshape(b * c, h, w), yy, xx, "mirror")
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def occlusion_mask(target_flow: torch.Tensor) -> torch.Tensor:
    """Occluded-region mask of the colour term: the pixels the target flow
    maps onto (disoccluded origins), found as the non-zero gradient of a
    self-warp; moving pixels (non-zero flow) stay unmasked.  [B, H, W, 2]
    -> [B, H, W, 1] float32, 0 = masked out."""
    f = target_flow.detach().float().clone().requires_grad_()
    with torch.enable_grad():
        wf = warp(f, f)
        total = torch.sum(wf * (f != wf).float())
        grad, = torch.autograd.grad(total, f)
    occ = 1.0 - (grad.abs().sum(-1, keepdim=True) != 0).float()
    moving = target_flow.abs().sum(-1, keepdim=True) != 0
    return torch.where(moving, torch.ones_like(occ), occ)


def gen_flow(edit_param, mask: np.ndarray) -> np.ndarray:
    """Analytic target flow of a GeoBench edit_param over the object mask:
    translation, z-rotation about the mask centroid, or uniform scale.
    -> [1, H, W, 2] float32 (x, y) pixels.  Numpy; the port's own copy."""
    p = list(map(float, edit_param))
    m = np.asarray(mask) > 127
    h, w = m.shape
    flow = np.zeros((1, h, w, 2), np.float32)
    if p[0] != 0 or p[1] != 0:
        flow[0, m, 0] = p[0]
        flow[0, m, 1] = p[1]
        return flow
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        return flow
    cy, cx = ys.mean(), xs.mean()
    if p[5] != 0:
        th = np.deg2rad(-p[5])
        a, b = np.cos(th), np.sin(th)
        ny = a * (ys - cy) - b * (xs - cx) + cy
        nx = b * (ys - cy) + a * (xs - cx) + cx
    elif p[6] != 1 and p[6] != 0:
        s = p[6]
        ny = s * (ys - cy) + cy
        nx = s * (xs - cx) + cx
    else:
        return flow
    flow[0, ys, xs, 0] = nx - xs
    flow[0, ys, xs, 1] = ny - ys
    return flow


# ---------------------------------------------------------------------------
# Flow energy
# ---------------------------------------------------------------------------


def make_flow_loss(raft, target_flow: torch.Tensor, flow_weight: float = 3.0,
                   color_weight: float = 100.0):
    """loss(pred_img, src_img) with images [B, H, W, 3] in [-1, 1];
    `raft(image1, image2)` gives the flow between [0, 1] images."""
    mask_occ = occlusion_mask(target_flow)

    def loss(pred, src):
        pred01 = pred / 2.0 + 0.5
        src01 = src / 2.0 + 0.5
        flow = raft(src01, pred01)
        flow_loss = torch.mean(torch.abs(target_flow - flow))
        pred_warped = warp(pred01, flow)
        color_loss = torch.mean(torch.abs(src01 * mask_occ - pred_warped * mask_occ))
        return flow_weight * flow_loss + color_weight * color_loss

    return loss


# ---------------------------------------------------------------------------
# Stage times of the energy gradient
# ---------------------------------------------------------------------------

STAGES = ("unet", "decode", "raft")


class _Mark(torch.autograd.Function):
    """Identity whose backward calls `hook` when the gradient reaches it."""

    @staticmethod
    def forward(ctx, x, hook):
        ctx.hook = hook
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.hook()
        return g, None


class _NoTimer:
    """What `edit` uses without an `EnergyTimer`: nothing recorded."""

    def begin(self):
        pass

    def mark(self, name: str):
        pass

    def tap(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return x


class EnergyTimer:
    """Device time of each energy gradient's stages (UNet, decode, RAFT with
    the loss), forward and backward, from CUDA events recorded on the stream
    at the stage boundaries: the ends of the `mg::unet`, `mg::decode` and
    `mg::raft` `record_function` ranges in the forward, and the points where
    the gradient reaches the decoded image and the UNet's output in the
    backward.  CUDA only."""

    def __init__(self):
        self.gradients = []

    def begin(self):
        self._ev = {}
        self.gradients.append(self._ev)
        self.mark("start")

    def mark(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self._ev[name] = ev

    def tap(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """x, marked so that the backward records `name` on reaching it."""
        return _Mark.apply(x, lambda: self.mark(name))

    def split_ms(self) -> list:
        """[{stage: ms, "total": ms}] per gradient (after a synchronise)."""
        out = []
        for ev in self.gradients:
            def ms(a, b):
                return ev[a].elapsed_time(ev[b])
            row = {"unet": ms("start", "unet") + ms("eps_grad", "end"),
                   "decode": ms("unet", "decode") + ms("recon_grad", "eps_grad"),
                   "raft": ms("decode", "loss") + ms("loss", "recon_grad"),
                   "total": ms("start", "end")}
            out.append(row)
        return out


# ---------------------------------------------------------------------------
# The guided sampler
# ---------------------------------------------------------------------------


class MotionGuidance:
    """Flow-guided editing over a `FreeFine` pipe and a `RAFT` on the pipe's
    device (CUDA by default, as the pipe's).

    GeoBench protocol: 50-step DDIM from pure noise, CFG 7.5, eta 0, 10
    recursive steps, guidance weight 300, gradient clip 200, energy
    `make_flow_loss` (colour 100, flow 3, occlusion-masked)."""

    def __init__(self, pipe, raft):
        dev = next(raft.parameters()).device
        if torch.empty(0, device=pipe.device).device != dev:
            raise ValueError(f"MotionGuidance: RAFT on {dev}, the pipe on {pipe.device}")
        self.pipe = pipe
        self.raft = raft

    def _energy(self, loss_fn, src_img, ctx2, schedule, cfg_scale, timer):
        pipe = self.pipe

        def stage(name):
            return torch.profiler.record_function(f"mg::{name}")

        def energy(z, t):
            """(loss, eps) of latents z [1, h, w, 4] float32 at step t."""
            timer.begin()
            with stage("unet"):
                eps2 = timer.tap(pipe.unet_apply(torch.cat([z, z], dim=0), t, ctx2), "eps_grad")
                timer.mark("unet")
            with stage("decode"):
                u, c = eps2[:1], eps2[1:]
                eps = (u + cfg_scale * (c - u)).float()
                a_t = schedule.alpha_at(t)
                x0 = (z.float() - float(np.sqrt(np.float32(1.0) - a_t)) * eps) / float(
                    np.sqrt(a_t))
                recon = timer.tap(pipe.vae.decode(x0).float(), "recon_grad")
                timer.mark("decode")
            with stage("raft"):
                loss = loss_fn(recon, src_img)
                timer.mark("loss")
            return loss, eps

        return energy

    def _sample(self, src_img, src_z0, ctx2, target_flow, edit_mask, g_sched, noise,
                *, steps, num_recursive, guidance_weight, clip_grad, cfg_scale, timer):
        schedule = DDIMSchedule.create(num_inference_steps=steps)
        loss_fn = make_flow_loss(self.raft, target_flow)
        energy = self._energy(loss_fn, src_img, ctx2, schedule, cfg_scale, timer)
        z = noise(None)
        pin = edit_mask > 0
        for i, t in enumerate(schedule.timesteps):
            t = int(t)
            a_t = schedule.alpha_at(t)
            a_p = schedule.alpha_prev_strict(t - schedule.step_delta)
            beta_t = a_t / a_p
            sqrt_a, sqrt_1m = float(np.sqrt(a_t)), float(np.sqrt(np.float32(1.0) - a_t))
            z_prev = z
            for j in range(num_recursive):
                # RePaint latent pinning
                gt = sqrt_a * src_z0 + sqrt_1m * noise((i, j, 0))
                z = torch.where(pin, gt, z)
                zz = z.detach().requires_grad_()
                with torch.enable_grad():
                    loss, eps = energy(zz, t)
                    grad, = torch.autograd.grad(loss, zz)
                timer.mark("end")
                eps = eps.detach()
                g = -grad.float() * guidance_weight * float(g_sched[i])
                gnorm = torch.linalg.norm(sqrt_1m * g)
                scale = torch.where((gnorm > clip_grad) & (clip_grad > 0),
                                    clip_grad / torch.clamp(gnorm, min=1e-12),
                                    torch.ones_like(gnorm))
                eps = eps - sqrt_1m * g * scale
                # DDIM step (eta 0), then the recursive re-noise
                x0 = (z - sqrt_1m * eps) / sqrt_a
                z_prev = float(np.sqrt(a_p)) * x0 + float(np.sqrt(np.float32(1.0) - a_p)) * eps
                z = float(np.sqrt(beta_t)) * z_prev + float(
                    np.sqrt(np.float32(1.0) - beta_t)) * noise((i, j, 1))
            z = z_prev
        return z

    @torch.no_grad()
    def edit(
        self,
        src_image: np.ndarray,
        edit_param,
        mask: np.ndarray,
        prompt: str,
        steps: int = 50,
        num_recursive: int = 10,
        guidance_weight: float = 300.0,
        clip_grad: float = 200.0,
        cfg_scale: float = 7.5,
        guidance_schedule: Optional[np.ndarray] = None,
        edit_mask: Optional[np.ndarray] = None,
        seed: int = 42,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        timer: Optional[EnergyTimer] = None,
    ) -> np.ndarray:
        """An edit of `src_image` (uint8 [H, W, 3]) whose flow from the
        source matches the analytic flow of `edit_param` over `mask`.
        -> uint8 [H, W, 3].  `noise`: (z_T [1, h, w, 4], draws [steps,
        num_recursive, 2, 1, h, w, 4]: the pinning noise, then the re-noise)
        replaces the seeded draws.  `timer`: an `EnergyTimer` that records
        each energy gradient's stage times (CUDA)."""
        pipe = self.pipe
        dev = pipe.device
        cfg = pipe.config
        lh, lw = cfg.latent_height, cfg.latent_width
        shape = (1, lh, lw, 4)

        src01 = np.asarray(src_image, np.float32) / 255.0
        src = torch.as_tensor(src01 * 2.0 - 1.0, device=dev)[None]
        src_z0 = pipe.image_to_latent(src_image)
        ctx2 = torch.cat([pipe.encode_text([""]), pipe.encode_text([prompt])], dim=0)
        flow = torch.as_tensor(gen_flow(edit_param, mask), device=dev)
        if edit_mask is None:
            em = torch.zeros(shape[:3] + (1,), device=dev)
        else:
            m = torch.as_tensor(np.asarray(edit_mask, np.float32), device=dev)
            em = resize(m, (lh, lw), "nearest")[None, :, :, None]
        g = (np.ones(steps, np.float32) if guidance_schedule is None
             else np.asarray(guidance_schedule[:steps], np.float32))

        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(seed)

            def draw(_):
                return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        else:
            z_t, draws = noise

            def draw(at):
                return (z_t if at is None else draws[at]).to(dev, torch.float32)

        z = self._sample(src, src_z0, ctx2, flow, em, g, draw, steps=steps,
                         num_recursive=num_recursive, guidance_weight=float(guidance_weight),
                         clip_grad=float(clip_grad), cfg_scale=float(cfg_scale),
                         timer=timer or _NoTimer())
        return pipe.latent_to_image(z)[0]
