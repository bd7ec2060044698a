"""RegionDrag baseline core for the PyTorch port (mirrors
`freefine_tpu.baselines.region_drag`): region-based drag editing by
cycle-SDE inversion, latent copy-paste and self-attention K/V replay.

  1. Cycle-SDE forward: the encoded latent is noised up step by step, and
     at each step the noise is recovered that makes the reverse SDE step
     land back on the forward trajectory (`forward_sde_step`).
  2. Region copy-paste: a dense source -> target point correspondence from
     a region pair (`region_pair_to_pts`); latent values are copied from
     the forward trajectory at every reverse step while the copy gate is on.
  3. K/V replay: each reverse step runs the UNet over [x, hook], the hook
     being the forward trajectory's latent at that timestep, in
     `EditConfig(mode="drag")`: every self-attention attends with the hook
     stream's K/V (recomputed from the same input, so exact).

Points are fixed-size padded arrays: pad rows carry the index
`max(lh, lw)`, past the latent.  JAX drops scatter rows outside the array
(`mode="drop"`) and clamps gathers; here such rows are masked out of the
scatter and the gathers clamp.  A scatter with repeated indices keeps the
last row's value for each index, as JAX's CPU scatter applies its rows in
order (`blur_points` scatters at the source points, which repeat where
several target pixels map onto one source pixel); the rows that a later
row overwrites are dropped before the scatter, so the result is the same
on the card, where the order of a scatter's writes is unspecified.

Noise is an input: `drag(noise=(forward_draws, blur_draw))` replays given
draws (the tests replay JAX's); otherwise a `torch.Generator` seeded by
`seed` draws one latent per forward SDE step and the blur noise, in that
order.  The blur draw keeps JAX's [n_pts, 4] shape, pad rows included.

Latents are NHWC, as at every public function of the port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from freefine_tpu_torch.edit import EditConfig, none_config
from freefine_tpu_torch.ops.resize import resize
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, _f32

# ---------------------------------------------------------------------------
# Region -> point correspondence (host side, numpy)
# ---------------------------------------------------------------------------


def _masked_min_max(values, mask, axis=None):
    v_min = np.min(np.where(mask, values, np.inf), axis=axis)
    v_max = np.max(np.where(mask, values, -np.inf), axis=axis)
    return v_min, v_max


def _resize_mask(mask: np.ndarray, scale: float) -> np.ndarray:
    h, w = mask.shape
    nh, nw = int(h * scale), int(w * scale)
    ys = (np.arange(nh) / scale).astype(np.int64).clip(0, h - 1)
    xs = (np.arange(nw) / scale).astype(np.int64).clip(0, w - 1)
    return mask[ys][:, xs]


def region_pair_to_pts(src_region: np.ndarray, trg_region: np.ndarray,
                       scale: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Dense mapping from a target region onto a source (handle) region:
    the target's x-extent is normalised onto the source's, then per column
    its y-extent, giving every target pixel a source pixel.  -> (source
    points, target points), int [N, 2] in (x, y).  `scale=1/8` maps in SD
    latent space."""
    src = _resize_mask(np.asarray(src_region), scale).astype(bool)
    trg = _resize_mask(np.asarray(trg_region), scale).astype(bool)
    h, w = src.shape
    if not src.any() or not trg.any():
        return np.zeros((0, 2), np.int64), np.zeros((0, 2), np.int64)

    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    trg_pts = np.stack([xs[trg], ys[trg]], axis=-1)

    src_x_min, src_x_max = _masked_min_max(xs, src)
    trg_x_min, trg_x_max = _masked_min_max(xs, trg)
    scale_x = (src_x_max - src_x_min) / max(trg_x_max - trg_x_min, 1e-4)
    map_x = (xs - trg_x_min) * scale_x + src_x_min
    map_x = np.where(trg, map_x, 0.0)

    # per-column y extents; source columns indexed by the remapped x
    src_y_min, src_y_max = _masked_min_max(ys, src, axis=0)
    trg_y_min, trg_y_max = _masked_min_max(ys, trg, axis=0)
    col = np.clip(map_x.astype(np.int64), 0, w - 1)
    s_min, s_max = src_y_min[col], src_y_max[col]
    # an empty source column (inf) is hit only by rounding at the border:
    # the global source extent stands in
    g_min, g_max = _masked_min_max(ys, src)
    s_min = np.where(np.isfinite(s_min), s_min, g_min)
    s_max = np.where(np.isfinite(s_max), s_max, g_max)
    t_min = np.where(np.isfinite(trg_y_min), trg_y_min, 0.0)
    t_max = np.where(np.isfinite(trg_y_max), trg_y_max, 0.0)

    scale_y = (s_max - s_min) / np.maximum(t_max - t_min, 1e-4)
    map_y = (ys - t_min) * scale_y + s_min
    src_pts = np.stack([map_x[trg], map_y[trg]], axis=-1)

    src_pts = np.clip(src_pts, 0, [w - 1, h - 1]).astype(np.int64)
    return src_pts, trg_pts.astype(np.int64)


def pad_points(pts: np.ndarray, n: int, oob: int) -> np.ndarray:
    """[N, 2] points padded or cut to [n, 2]; pad rows get the index `oob`,
    past the latent, so the scatters drop them."""
    out = np.full((n, 2), oob, np.int32)
    m = min(len(pts), n)
    if m:
        out[:m] = pts[:m]
    return out


# ---------------------------------------------------------------------------
# Cycle-SDE steps
# ---------------------------------------------------------------------------


def _alpha(schedule: DDIMSchedule, t: int) -> np.float32:
    """alphas_cumprod[t], 1.0 outside the trained range (both boundary
    alphas of the cycle SDE are 1)."""
    if 0 <= t < schedule.num_train_timesteps:
        return schedule.alphas_cumprod[t]
    return np.float32(1.0)


def forward_sde_step(schedule: DDIMSchedule, eps_fn, t: int, x: torch.Tensor,
                     z: torch.Tensor, eta: float = 1.0):
    """x at t -> (x at t + delta, the recovered cycle noise), z the fresh
    Gaussian of the jump up.  The noise is the one that makes the reverse
    SDE step from x_{t+delta} land exactly on x_t."""
    one = np.float32(1.0)
    t_next = t + schedule.step_delta
    a_t, a_n = _alpha(schedule, t), _alpha(schedule, t_next)
    x32 = x.float()
    x_next = _f32(np.sqrt(a_n / a_t)) * x32 + _f32(np.sqrt(one - a_n / a_t)) * z.float()
    eps = eps_fn(x_next.to(x.dtype), t_next).float()
    sigma = np.float32(eta) * np.sqrt((one - a_t) / (one - a_n)) * np.sqrt(one - a_n / a_t)
    x0 = (x_next - _f32(np.sqrt(one - a_n)) * eps) / _f32(np.sqrt(a_n))
    dir_coeff = _f32(np.sqrt(one - a_t - sigma ** 2))
    noise = (x32 - _f32(np.sqrt(a_t)) * x0 - dir_coeff * eps) / _f32(sigma)
    return x_next.to(x.dtype), noise


def forward_ode_step(schedule: DDIMSchedule, eps_fn, t: int, x: torch.Tensor):
    """Deterministic DDIM inversion step x_t -> x_{t+delta}; the noise is
    zero."""
    one = np.float32(1.0)
    t_next = t + schedule.step_delta
    a_t, a_n = _alpha(schedule, t), _alpha(schedule, t_next)
    x32 = x.float()
    eps = eps_fn(x, t).float()
    x0 = (x32 - _f32(np.sqrt(one - a_t)) * eps) / _f32(np.sqrt(a_t))
    x_next = _f32(np.sqrt(a_n)) * x0 + _f32(np.sqrt(one - a_n)) * eps
    return x_next.to(x.dtype), torch.zeros_like(x32)


def reverse_step(schedule: DDIMSchedule, eps: torch.Tensor, t: int, x: torch.Tensor,
                 noise: torch.Tensor, sde: bool, eta: float = 1.0) -> torch.Tensor:
    """One reverse step x_t -> x_{t-delta}, adding sigma * `noise` (the
    recovered cycle noise) when sde."""
    one = np.float32(1.0)
    a_t, a_p = _alpha(schedule, t), _alpha(schedule, t - schedule.step_delta)
    x32 = x.float()
    eps = eps.float()
    sigma = (np.float32(eta) * np.sqrt((one - a_p) / (one - a_t)) * np.sqrt(one - a_t / a_p)
             if sde else np.float32(0.0))
    x0 = (x32 - _f32(np.sqrt(one - a_t)) * eps) / _f32(np.sqrt(a_t))
    x_prev = _f32(np.sqrt(a_p)) * x0 + _f32(np.sqrt(one - a_p - sigma ** 2)) * eps
    if sde:
        x_prev = x_prev + _f32(sigma) * noise.float()
    return x_prev.to(x.dtype)


# ---------------------------------------------------------------------------
# Latent point ops
# ---------------------------------------------------------------------------


def _scatter_rows(pts: torch.Tensor, h: int, w: int):
    """The rows of (x, y) points [N, 2] that a scatter into an [h, w] grid
    writes, and their flat indices: rows inside the grid, and of repeated
    indices only the last row."""
    x, y = pts[:, 0].long(), pts[:, 1].long()
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    flat = torch.where(inside, y * w + x, torch.full_like(x, h * w))
    order = torch.arange(len(flat), device=pts.device)
    last = torch.full((h * w + 1,), -1, dtype=torch.long, device=pts.device)
    last.scatter_reduce_(0, flat, order, reduce="amax")
    keep = inside & (last[flat] == order)
    return keep, flat


def _gather_points(latent: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """latent[0, y, x, :] for (x, y) points [N, 2], indices clamped."""
    _, h, w, _ = latent.shape
    x = pts[:, 0].long().clamp(0, w - 1)
    y = pts[:, 1].long().clamp(0, h - 1)
    return latent[0, y, x, :]


def _scatter_points(latent: torch.Tensor, pts: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """latent with latent[0, y, x, :] = vals at the points, rows past the
    grid dropped and the last of repeated indices kept."""
    _, h, w, c = latent.shape
    keep, flat = _scatter_rows(pts, h, w)
    out = latent.clone()
    out[0].reshape(h * w, c)[flat[keep]] = vals[keep].to(latent.dtype)
    return out


def copy_paste(src_latent: torch.Tensor, dst_latent: torch.Tensor, src_pts: torch.Tensor,
               tgt_pts: torch.Tensor) -> torch.Tensor:
    """dst[tgt] <- src[src] for [N, 2] (x, y) point lists, NHWC latents of
    batch 1."""
    return _scatter_points(dst_latent, tgt_pts, _gather_points(src_latent, src_pts))


def blur_points(latent: torch.Tensor, pts: torch.Tensor, noise_scale: float,
                noise: torch.Tensor) -> torch.Tensor:
    """Re-noise the latent at `pts` with `noise` [N, 4]: erases the
    source region so the reverse process resynthesises it."""
    img_scale = (1.0 - noise_scale ** 2) ** 0.5 if noise_scale < 1 else 0.0
    vals = _gather_points(latent, pts)
    new = img_scale * vals.float() + noise_scale * noise.to(latent.device, torch.float32)
    return _scatter_points(latent, pts, new)


# ---------------------------------------------------------------------------
# The drag pipeline
# ---------------------------------------------------------------------------


class RegionDrag:
    """Region-based drag editing over a `FreeFine` pipe's SD backbone, on
    the pipe's device.  `method` 'encode_then_cp' (the default, SDE: the
    original latent noised up, copy-paste at every reverse step) or
    'cp_then_encode' (ODE: a pixel-space copy-paste preview inverted for
    the hook stream, the reverse pass starting from the original image's
    inverted latent)."""

    def __init__(self, pipe):
        self.pipe = pipe

    @staticmethod
    def drag_config() -> EditConfig:
        """Every self-attention of every stage attends with the hook
        stream's K/V."""
        return EditConfig(mode="drag", method=None, local_cfg=False, kv_source_stream=1,
                          layer_range=(0, 10 ** 6), tca_scope=("down", "mid", "up"))

    def _forward(self, schedule, latent, ctx, ts_fwd, sde: bool, draw):
        """The forward pass over the ascending timesteps: (hooks, noises),
        one each per step."""
        pipe = self.pipe
        plain = none_config()

        def eps_fn(z, t):
            return pipe.unet_apply(z, t, ctx, plain)

        hooks, noises, x = [], [], latent
        for i, t in enumerate(ts_fwd):
            if sde:
                x, noise = forward_sde_step(schedule, eps_fn, int(t), x, draw(i))
            else:
                x, noise = forward_ode_step(schedule, eps_fn, int(t), x)
            hooks.append(x)
            noises.append(noise)
        return hooks, noises

    def _backward(self, schedule, start, hooks, noises, ctx, src_pts, tgt_pts, ts_bwd, cp_gates,
                  mask, sde: bool):
        """The reverse pass from `start`, consuming the hooks and noises top
        down: copy-paste while the gate is on, the hook outside the mask,
        then the UNet over [x, hook] in drag mode and a reverse step."""
        pipe = self.pipe
        ecfg = self.drag_config()
        ctx2 = torch.cat([ctx, ctx], dim=0)
        x = start
        for hook, noise, t, gate in zip(hooks[::-1], noises[::-1], ts_bwd, cp_gates):
            if gate > 0:
                x = copy_paste(hook, x, src_pts, tgt_pts)
            x = torch.where(mask > 0, x, hook)
            eps2 = pipe.unet_apply(torch.cat([x, hook], dim=0), int(t), ctx2, ecfg)
            x = reverse_step(schedule, eps2[:1], int(t), x, noise, sde=sde)
        return x

    @torch.no_grad()
    def drag(
        self,
        ori_image: np.ndarray,
        source_pts: np.ndarray,
        target_pts: np.ndarray,
        prompt: str,
        mask: Optional[np.ndarray] = None,
        steps: int = 50,
        start_t: float = 0.5,
        end_t: float = 0.2,
        noise_scale: float = 1.0,
        seed: int = 42,
        method: str = "encode_then_cp",
        preview_image: Optional[np.ndarray] = None,
        max_pts: Optional[int] = None,
        noise: Optional[Tuple[Optional[Sequence[torch.Tensor]], torch.Tensor]] = None,
    ) -> np.ndarray:
        """Drag-edit `ori_image` (uint8 [H, W, 3]) moving `source_pts` to
        `target_pts` (image-space (x, y) ints) -> uint8 [H, W, 3].  The
        defaults are GeoBench's (50 steps, start 0.5, end 0.2, noise scale
        1, CFG 1).  `noise`: (forward draws, [k, 1, lh, lw, 4] or None for
        the ODE method; the blur draw, [n_blur, 4]) in place of the seeded
        draws."""
        if method not in ("encode_then_cp", "cp_then_encode"):
            raise ValueError(f"unknown RegionDrag method {method!r}")
        sde = method == "encode_then_cp"
        pipe = self.pipe
        dev = pipe.device
        lh, lw = pipe.config.latent_height, pipe.config.latent_width
        k = int(start_t * steps)
        end_step_t = int(end_t * steps)
        schedule = DDIMSchedule.create(num_inference_steps=steps)

        src = np.asarray(source_pts) // 8
        tgt = np.asarray(target_pts) // 8
        n_pts = max_pts or int(2 ** np.ceil(np.log2(max(len(tgt), 1))))
        oob = max(lh, lw)
        shape = (1, lh, lw, 4)

        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(seed)

            def draw(_):
                return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        else:
            fwd_draws, blur_draw = noise
            if sde and fwd_draws is None:
                raise ValueError("the SDE method needs the forward draws in `noise`")

            def draw(i):
                return fwd_draws[i].to(dev, torch.float32)

        latent = pipe.image_to_latent(ori_image)
        ctx = pipe.encode_text([prompt])
        # ascending timesteps of the forward pass: the last k of the DDIM grid
        ts_fwd = schedule.timesteps[steps - k:][::-1]
        ts_bwd = ts_fwd[::-1] + schedule.step_delta

        if sde:
            blur = pad_points(src, n_pts, oob)
            copy_src = pad_points(src, n_pts, oob)
            hooks, noises = self._forward(schedule, latent, ctx, ts_fwd, True, draw)
            start = hooks[-1]
        else:
            # the preview's trajectory gives the hooks; the reverse pass
            # starts from the original image's inverted latent
            preview = preview_image if preview_image is not None else ori_image
            hooks, noises = self._forward(schedule, pipe.image_to_latent(preview), ctx, ts_fwd,
                                          False, draw)
            start = self._forward(schedule, latent, ctx, ts_fwd, False, draw)[0][-1]
            blur = pad_points(np.concatenate([tgt, src]), 2 * n_pts, oob)
            copy_src = pad_points(tgt, n_pts, oob)
        paste_tgt = pad_points(tgt, n_pts, oob)

        if noise is None:
            blur_draw = torch.randn((len(blur), 4), generator=gen, device=dev,
                                    dtype=torch.float32)
        as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        start = blur_points(start, as_t(blur), noise_scale, blur_draw)

        # copy-paste while the raw timestep >= end_t * steps (the reference
        # compares a timestep against a step-index bound)
        cp_gates = (np.asarray(ts_bwd) >= end_step_t).astype(np.float32)
        if mask is None:
            mask_l = torch.ones(1, lh, lw, 1, device=dev)
        else:
            m = torch.as_tensor(np.asarray(mask, np.float32), device=dev)
            mask_l = resize(m, (lh, lw), "nearest")[None, :, :, None]

        out = self._backward(schedule, start, hooks, noises, ctx, as_t(copy_src), as_t(paste_tgt), ts_bwd,
                             cp_gates, mask_l, sde)
        image = pipe.latent_to_image(out)[0]
        if mask is not None and not np.all(np.asarray(mask) > 0):
            m = np.asarray(mask, bool)[:, :, None]
            image = np.where(m, image, ori_image[..., :3])
        return image

    def drag_regions(self, ori_image: np.ndarray, src_region: np.ndarray,
                     trg_region: np.ndarray, prompt: str, **kwargs) -> np.ndarray:
        """GeoBench's entry: a dense region pair -> points -> `drag`."""
        src, tgt = region_pair_to_pts(src_region, trg_region, scale=1 / 8)
        return self.drag(ori_image, src * 8, tgt * 8, prompt, **kwargs)
