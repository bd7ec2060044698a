"""DragDiffusion baseline core for the PyTorch port (mirrors
`freefine_tpu.baselines.drag_diffusion`), its per-image LoRA training
included.

  1. Per-image DreamBooth-LoRA (`train_lora`): rank-16 factors on every
     attention projection of the UNet (to_q, to_k, to_v, to_out.0 of both
     attentions of every transformer block), trained by `torch.optim.Adam`
     on the epsilon MSE of the noised image latent at a random train
     timestep.  Each step merges W + (a @ b)^T, cast to W's dtype, into the
     adapted weights and runs the UNet on them through
     `torch.func.functional_call` (`FreeFine.unet_apply(weights=...)`); the
     module's own weights never change.
  2. DDIM inversion of the source to t = inversion_strength * T.
  3. The drag loop (`_drag_loop`, `motion_loss`): Adam on the latent at
     that timestep, each iteration pulling the feature patch around every handle one unit
     toward its target (an L1 between the patch at the handle and the patch
     moved along the unit direction), with an L1 anchor of the next latent
     outside the mask, after re-locating the handles by nearest-neighbour
     feature matching.  Once every handle is within 2 pixels of its target
     the loop stops (JAX's `done` gate, which freezes the state and never
     clears, is a `break` here): the latent from before that iteration's
     update is returned, and that iteration runs its forward only.
  4. The final denoise with MasaCtrl mutual self-attention: [source,
     dragged] at batch 2, `EditConfig(mode="drag", kv_source_stream=0)`,
     the sharing gated on from step `masactrl_start_step`.

Noise is an input: `train_lora(draws=[(t, noise)] per step)` replays
draws (the tests replay JAX's `jax.random` ones); otherwise a
`torch.Generator` seeded by `seed` draws the factors' initialisation and
then each step's t and noise.  Nothing else is drawn: DDIM runs at eta 0.

On the card every gradient (the LoRA step's to the factors, the drag
loop's to the latent) reaches the flash VJP kernels (rows 3-5 of PERF.md's
kernel table) in all 16 self-attentions, and the GroupNorm forward.
Latents and features are NHWC.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from freefine_tpu_torch.edit import EditConfig, EditState
from freefine_tpu_torch.ops.flow import map_coordinates_linear
from freefine_tpu_torch.ops.guidance import abs_l1
from freefine_tpu_torch.ops.resize import resize
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_prev, inv_step
from freefine_tpu_torch.utils.profiling import NoStepTimer, synced_stage

LORA_TARGETS = ("to_q", "to_k", "to_v", "to_out.0")

Lora = Dict[str, Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------


def lora_paths(unet: torch.nn.Module) -> List[str]:
    """State-dict keys of every attention-projection weight to adapt,
    sorted."""
    return sorted(name for name, _ in unet.named_parameters()
                  if any(name.endswith(f".{t}.weight") for t in LORA_TARGETS))


def init_lora(unet: torch.nn.Module, rank: int, generator: torch.Generator) -> Lora:
    """{key: {"a": [in, rank], "b": [rank, out]}} float32 on the UNet's
    device: a ~ N(0, 1) / rank drawn from `generator` in `lora_paths`'
    order, b zero, so the adapted UNet starts exactly at the base weights."""
    params = dict(unet.named_parameters())
    out = {}
    for key in lora_paths(unet):
        n_out, n_in = params[key].shape
        dev = params[key].device
        a = torch.randn(n_in, rank, generator=generator, device=dev, dtype=torch.float32) / rank
        out[key] = {"a": a, "b": torch.zeros(rank, n_out, device=dev, dtype=torch.float32)}
    return out


def merge_lora(unet: torch.nn.Module, lora: Lora, scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """{key: W + (scale * a @ b)^T in W's dtype} for every adapted weight:
    the tensors `FreeFine.unet_apply(weights=...)` runs the UNet on (the
    rest are the module's own).  Differentiable in the factors."""
    params = dict(unet.named_parameters())
    return {key: params[key] + ((ab["a"] @ ab["b"]) * scale).T.to(params[key].dtype)
            for key, ab in lora.items()}


def lora_loss(pipe, lora: Lora, latent: torch.Tensor, ctx: torch.Tensor, t,
              noise: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """The LoRA objective at one draw: the UNet on the merged weights,
    its epsilon against the noise of sqrt(a_t) latent + sqrt(1 - a_t)
    noise, mean squared.  t: a train timestep (int or 0-d tensor); alphas:
    the schedule's alphas_cumprod as a float32 tensor on the latent's
    device."""
    a_t = alphas[t]
    noisy = torch.sqrt(a_t) * latent.float() + torch.sqrt(1.0 - a_t) * noise
    pred = pipe.unet_apply(noisy, t, ctx, weights=merge_lora(pipe.unet, lora))
    return torch.mean((pred.float() - noise) ** 2)


def train_lora(pipe, image: np.ndarray, prompt: str, rank: int = 16, steps: int = 80,
               lr: float = 5e-4, seed: int = 0, init: Optional[Lora] = None,
               draws: Optional[List[Tuple[int, torch.Tensor]]] = None, timer=None) -> Lora:
    """Per-image DreamBooth-LoRA fine-tuning: `steps` Adam steps (lr, betas
    0.9 / 0.999, eps 1e-8) on `lora_loss` at a random train timestep and
    Gaussian noise per step; only the factors receive gradients.  `init`
    (factors to start from) and `draws` ([(t, noise [1, h, w, 4])] per
    step) replace the seeded draws.  `timer`: a `GradStepTimer` of the
    steps.  -> the trained factors (detached)."""
    timer = timer or NoStepTimer()
    dev = pipe.device
    schedule = DDIMSchedule.create(num_inference_steps=50)
    alphas = torch.as_tensor(schedule.alphas_cumprod, device=dev)
    latent = pipe.image_to_latent(image)
    ctx = pipe.encode_text([prompt])
    gen = torch.Generator(device=dev).manual_seed(seed)
    if init is None:
        init = init_lora(pipe.unet, rank, gen)
    lora = {k: {n: t.detach().to(dev, torch.float32).clone().requires_grad_()
                for n, t in ab.items()} for k, ab in init.items()}
    opt = torch.optim.Adam([t for ab in lora.values() for t in ab.values()], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    for i in range(steps):
        if draws is None:
            t = torch.randint(0, schedule.num_train_timesteps, (), generator=gen, device=dev)
            noise = torch.randn(latent.shape, generator=gen, device=dev, dtype=torch.float32)
        else:
            t, noise = draws[i]
            noise = noise.to(dev, torch.float32)
        with torch.enable_grad():
            timer.begin()
            loss = lora_loss(pipe, lora, latent, ctx, t, noise, alphas)
            timer.mark("forward")
            opt.zero_grad(set_to_none=True)
            loss.backward()
            timer.mark("end")
        opt.step()
    return {k: {n: t.detach() for n, t in ab.items()} for k, ab in lora.items()}


# ---------------------------------------------------------------------------
# Point tools (the supervision grid: half the image resolution)
# ---------------------------------------------------------------------------


def _patch_coords(center_y: torch.Tensor, center_x: torch.Tensor, radius: int):
    """The (2r+1)^2 stencil around (possibly fractional) centres [...] ->
    (yy, xx) [..., 2r+1, 2r+1]."""
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=center_y.device)
    yy = center_y[..., None, None] + offs[:, None] + torch.zeros_like(offs)[None, :]
    xx = center_x[..., None, None] + offs[None, :] + torch.zeros_like(offs)[:, None]
    return yy, xx


def sample_patch(feat: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """feat [H, W, C] at fractional (yy, xx) [...] -> [..., C]: JAX's
    order-1 `map_coordinates` in mode "nearest" (the index clamped to the
    border) on each channel."""
    c = feat.shape[-1]
    img = feat.permute(2, 0, 1)
    out = map_coordinates_linear(img, yy[None].expand(c, *yy.shape),
                                 xx[None].expand(c, *xx.shape), mode="nearest")
    return out.movedim(0, -1)


def track_points(f0_vecs: torch.Tensor, feat: torch.Tensor, points: torch.Tensor,
                 r_p: int) -> torch.Tensor:
    """Nearest-neighbour re-location of each point [N, 2] (row, col) within
    the (2 r_p + 1)^2 window around it: the cell of `feat` [H, W, C] of
    least L1 distance to its feature f0_vecs [N, C], the first on a tie.
    The window is the image-truncated [p - r, p + r] range; a fixed-size
    window shifted inward at the border holds it, the cells outside the
    range at +inf."""
    h, w, _ = feat.shape
    size = 2 * r_p + 1
    dev = feat.device
    py = torch.floor(points[:, 0]).long()
    px = torch.floor(points[:, 1]).long()
    y0 = torch.clamp(py - r_p, 0, h - size)
    x0 = torch.clamp(px - r_p, 0, w - size)
    ar = torch.arange(size, device=dev)
    rows = y0[:, None] + ar                                   # [N, size]
    cols = x0[:, None] + ar
    window = feat[rows[:, :, None], cols[:, None, :]]         # [N, size, size, C]
    dist = torch.abs(window.float() - f0_vecs[:, None, None, :]).sum(-1)
    valid = ((rows >= torch.clamp(py - r_p, min=0)[:, None]) & (rows < (py + r_p + 1)[:, None]))
    valid = valid[:, :, None] & ((cols >= torch.clamp(px - r_p, min=0)[:, None])
                                 & (cols < (px + r_p + 1)[:, None]))[:, None, :]
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    flat = torch.argmin(dist.reshape(len(points), -1), dim=-1)
    return torch.stack([(y0 + flat // size).float(), (x0 + flat % size).float()], dim=-1)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class DragDiffusion:
    """DragDiffusion editing over a `FreeFine` pipe's SD backbone, on the
    pipe's device.  GeoBench's protocol: 50-step DDIM, inversion strength
    0.7, latent lr 0.01, 80 drag iterations, r_m 1, r_p 3, lam 0.1, the
    feature the last up block's output resized to half the image
    resolution, LoRA rank 16 / 80 steps / lr 5e-4, no CFG."""

    def __init__(self, pipe):
        self.pipe = pipe

    def _feature_index(self) -> int:
        # the UNet's taps are [mid, up_0 .. up_{n-1}]: the last up block
        return len(self.pipe.config.unet.block_out_channels)

    @staticmethod
    def masactrl_config() -> EditConfig:
        """Every stream attends with stream 0's (the source's) K/V in the
        self-attentions of layers 10-15 of every stage."""
        return EditConfig(mode="drag", method=None, local_cfg=False, kv_source_stream=0,
                          layer_range=(10, 16), tca_scope=("down", "mid", "up"))

    def features(self, weights, code, t: int, ctx, sup_hw):
        """(eps, the tap resized to sup_hw [sup_h, sup_w, C] float32) of one
        UNet pass."""
        eps, feats = self.pipe.unet_apply(code, t, ctx, return_features=True, weights=weights)
        return eps, resize(feats[self._feature_index()], sup_hw, "linear", axes=(1, 2))[0]

    @staticmethod
    def _schedule() -> DDIMSchedule:
        return DDIMSchedule.create(num_inference_steps=50)

    @staticmethod
    def anchor_mask(mask_sup: torch.Tensor, latent_hw) -> Optional[torch.Tensor]:
        """The mask at sup res [sup_h, sup_w] resized "nearest" to the
        latent, [1, h, w, 1]; None where it holds no masked cell."""
        if not bool(mask_sup.sum() > 0):
            return None
        return resize(mask_sup, tuple(latent_hw), "nearest")[None, :, :, None]

    def motion_loss(self, schedule, eps, f1, code, t: int, handles, targets, x_prev_0,
                    anchor_mask, r_m: int, lam: float) -> torch.Tensor:
        """The motion loss of one pass's (eps, features f1 [sup_h, sup_w,
        C]): per point at `handles` [N, 2] not yet within 2 pixels of its
        target, (2 r_m + 1)^2 times the mean L1 between the (detached) patch
        at the rounded stencil and the patch moved one unit toward the
        target; plus lam * the L1 of the next latent's change outside the
        mask (`anchor_mask` [1, h, w, 1], None without a masked area)."""
        d = targets - handles
        dist = torch.sqrt(torch.sum(d * d, dim=-1))
        di = d / torch.clamp(dist, min=1e-8)[:, None]
        yy, xx = _patch_coords(handles[:, 0], handles[:, 1], r_m)
        with torch.no_grad():
            f_now = sample_patch(f1, torch.round(yy), torch.round(xx))
        f_moved = sample_patch(f1, yy + di[:, 0, None, None], xx + di[:, 1, None, None])
        l1 = abs_l1(f_now - f_moved).mean(dim=(1, 2, 3))
        gate = (dist >= 2.0).float()
        loss = (gate * float((2 * r_m + 1) ** 2) * l1).sum()
        if anchor_mask is not None:
            x_prev = ddim_prev(schedule, eps, t, code)
            loss = loss + lam * abs_l1((x_prev - x_prev_0) * (1.0 - anchor_mask)).sum()
        return loss

    def _drag_loop(self, weights, init_code, ctx, handles, targets, mask_sup, t: int,
                   n_pix_step: int, r_m: int, r_p: int, lam: float, lr: float, sup_hw,
                   timer, info: dict):
        """Adam on the latent (lr) for at most `n_pix_step` iterations.  Each
        iteration runs the UNet on the current latent, re-locates the
        handles on its features (not at the first), stops if all are within
        2 pixels of their targets, else steps on `motion_loss`'s gradient.
        -> (latent, handles); info gets "iterations" (passes run) and
        "updates" (gradients taken)."""
        sup_h, sup_w = sup_hw
        schedule = self._schedule()
        with torch.no_grad():
            eps0, f0 = self.features(weights, init_code, t, ctx, sup_hw)
            x_prev_0 = ddim_prev(schedule, eps0, t, init_code)
            f0_vecs = f0[handles[:, 0].long().clamp(0, sup_h - 1),
                         handles[:, 1].long().clamp(0, sup_w - 1)]
        anchor = self.anchor_mask(mask_sup, init_code.shape[1:3])
        code = init_code.detach().clone().requires_grad_()
        opt = torch.optim.Adam([code], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        info.update(iterations=0, updates=0)
        for step in range(n_pix_step):
            info["iterations"] += 1
            with torch.enable_grad():
                timer.begin()
                eps, f1 = self.features(weights, code, t, ctx, sup_hw)
                if step > 0:
                    handles = track_points(f0_vecs, f1.detach(), handles, r_p)
                if bool(torch.all(torch.linalg.vector_norm(handles - targets, dim=-1) < 2.0)):
                    timer.cancel()
                    break
                loss = self.motion_loss(schedule, eps, f1, code, t, handles, targets, x_prev_0,
                                        anchor, r_m, lam)
                timer.mark("forward")
                opt.zero_grad(set_to_none=True)
                loss.backward()
                timer.mark("end")
            opt.step()
            info["updates"] += 1
        return code.detach(), handles

    def _invert(self, weights, latent, ctx, n_actual: int) -> torch.Tensor:
        schedule = self._schedule()
        x = latent
        for t in schedule.timesteps[::-1][:n_actual]:
            eps = self.pipe.unet_apply(x, int(t), ctx, weights=weights)
            x, _ = inv_step(schedule, eps, int(t), x)
        return x

    def _denoise_masactrl(self, weights, pair, ctx2, n_actual: int, start_step: int):
        schedule = self._schedule()
        ecfg = self.masactrl_config()
        x = pair
        for i, t in enumerate(schedule.timesteps[50 - n_actual:]):
            t = int(t)
            state = EditState(share_gate=1.0 if i >= start_step else 0.0)
            eps = self.pipe.unet_apply(x, t, ctx2, ecfg, state, weights=weights)
            x = ddim_prev(schedule, eps, t, x).to(x.dtype)
        return x

    @torch.no_grad()
    def drag(
        self,
        ori_image: np.ndarray,
        handle_points: np.ndarray,     # [N, 2] image-space (x, y)
        target_points: np.ndarray,     # [N, 2] image-space (x, y)
        prompt: str,
        mask: Optional[np.ndarray] = None,
        inversion_strength: float = 0.7,
        latent_lr: float = 0.01,
        n_pix_step: int = 80,
        lam: float = 0.1,
        r_m: int = 1,
        r_p: int = 3,
        lora: Optional[Lora] = None,
        train_lora_steps: int = 0,
        lora_rank: int = 16,
        lora_lr: float = 5e-4,
        masactrl_start_step: int = 4,
        max_points: int = 16,
        seed: int = 42,
        timer=None,
        grad_timers: Optional[dict] = None,
        info: Optional[dict] = None,
    ) -> np.ndarray:
        """Drag-edit `ori_image` -> uint8 [H, W, 3]: at most `max_points`
        handles, a LoRA trained for `train_lora_steps` (seeded by `seed`)
        when none is given.  `timer`: a `StageTimer` of the
        stages "lora", "invert", "drag", "denoise" and "decode" (each
        synchronised on the card); `grad_timers`: {"lora", "drag":
        `GradStepTimer`}; `info` receives the drag loop's "iterations" and
        "updates"."""
        pipe = self.pipe
        dev = pipe.device
        grad_timers = grad_timers or {}
        info = {} if info is None else info
        full_h, full_w = ori_image.shape[:2]
        sup_h, sup_w = int(0.5 * full_h), int(0.5 * full_w)
        n_actual = round(inversion_strength * 50)
        t_step = int(self._schedule().timesteps[50 - n_actual])

        if train_lora_steps and lora is None:
            with synced_stage(timer, "lora", dev):
                lora = train_lora(pipe, ori_image, prompt, rank=lora_rank,
                                  steps=train_lora_steps, lr=lora_lr, seed=seed,
                                  timer=grad_timers.get("lora"))
        weights = merge_lora(pipe.unet, {k: {n: t.to(dev) for n, t in ab.items()}
                                         for k, ab in lora.items()}) if lora else None

        def to_sup(pts):
            pts = np.asarray(pts, np.float64).reshape(-1, 2)[:max_points]
            sup = np.stack([pts[:, 1] / full_h * sup_h, pts[:, 0] / full_w * sup_w], -1)
            return torch.as_tensor(sup.astype(np.float32), device=dev)

        handles, targets = to_sup(handle_points), to_sup(target_points)
        mask_sup = (resize(torch.as_tensor(np.asarray(mask), dtype=torch.float32, device=dev),
                           (sup_h, sup_w), "nearest")
                    if mask is not None else torch.ones(sup_h, sup_w, device=dev))

        with synced_stage(timer, "invert", dev):
            latent = pipe.image_to_latent(ori_image)
            ctx = pipe.encode_text([prompt])
            invert_code = self._invert(weights, latent, ctx, n_actual)
        with synced_stage(timer, "drag", dev):
            updated_code, _ = self._drag_loop(
                weights, invert_code, ctx, handles, targets, mask_sup, t_step, n_pix_step, r_m,
                r_p, lam, latent_lr, (sup_h, sup_w), grad_timers.get("drag") or NoStepTimer(),
                info)
        with synced_stage(timer, "denoise", dev):
            out = self._denoise_masactrl(weights, torch.cat([invert_code, updated_code]),
                                         torch.cat([ctx, ctx]), n_actual, masactrl_start_step)
        with synced_stage(timer, "decode", dev):
            return pipe.latent_to_image(out[1:])[0]

