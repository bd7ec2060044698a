"""DDIM schedule math for the PyTorch port (mirrors
`freefine_tpu.schedulers.ddim`).

The schedule tables are built on the host in numpy (float32, as the JAX
package does) and the per-step scalars are looked up with python integer
timesteps: the port's loops are plain Python, so there is nothing to trace.
Noise is an argument of `ctrl_step`, so callers choose the generator (a
seeded `torch.Generator` in the pipeline, replayed JAX draws in the tests).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from freefine_tpu_torch.config import SchedulerConfig


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Precomputed DDIM tables; `alphas_cumprod` is always float32."""

    num_train_timesteps: int
    num_inference_steps: int
    steps_offset: int
    alphas_cumprod: np.ndarray      # float32 [num_train_timesteps]
    final_alpha_cumprod: np.float32
    timesteps: np.ndarray           # int64 [num_inference_steps], descending

    @property
    def step_delta(self) -> int:
        return self.num_train_timesteps // self.num_inference_steps

    @classmethod
    def create(
        cls, config: SchedulerConfig = SchedulerConfig(), num_inference_steps: int = 50
    ) -> "DDIMSchedule":
        betas = (
            np.linspace(
                config.beta_start**0.5,
                config.beta_end**0.5,
                config.num_train_timesteps,
                dtype=np.float64,
            )
            ** 2
        )
        alphas_cumprod = np.cumprod(1.0 - betas).astype(np.float32)
        final = np.float32(1.0) if config.set_alpha_to_one else alphas_cumprod[0]
        step_ratio = config.num_train_timesteps // num_inference_steps
        timesteps = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
        timesteps = timesteps.astype(np.int64) + config.steps_offset
        return cls(
            num_train_timesteps=config.num_train_timesteps,
            num_inference_steps=num_inference_steps,
            steps_offset=config.steps_offset,
            alphas_cumprod=alphas_cumprod,
            final_alpha_cumprod=np.float32(final),
            timesteps=timesteps.copy(),
        )

    def alpha_at(self, t: int) -> np.float32:
        """alphas_cumprod[t], final_alpha_cumprod for t < 0."""
        if t >= 0:
            return self.alphas_cumprod[min(t, self.num_train_timesteps - 1)]
        return self.final_alpha_cumprod

    def alpha_prev_strict(self, t_prev: int) -> np.float32:
        """The reference ctrl_step's strict `t_prev > 0` test."""
        if t_prev > 0:
            return self.alphas_cumprod[min(t_prev, self.num_train_timesteps - 1)]
        return self.final_alpha_cumprod

    def variance(self, t: int) -> np.float32:
        """DDPM posterior variance between t and t - step_delta (`>= 0`
        fallback convention of the reference `_get_variance`)."""
        alpha_t = self.alpha_at(t)
        alpha_prev = self.alpha_at(t - self.step_delta)
        one = np.float32(1.0)
        return ((one - alpha_prev) / (one - alpha_t)) * (one - alpha_t / alpha_prev)


def _f32(x) -> float:
    """A float32 scalar as a python float (exact)."""
    return float(np.float32(x))


def inv_step(
    schedule: DDIMSchedule, model_output: torch.Tensor, timestep: int, x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One deterministic DDIM inversion step x_t -> x_{t+delta}, with the
    reference's `min(t - delta, 999)` clamp.  Returns (x_next, pred_x0)."""
    t = min(int(timestep) - schedule.step_delta, schedule.num_train_timesteps - 1)
    alpha_t = schedule.alpha_at(t)
    alpha_next = schedule.alpha_at(int(timestep))
    dtype = x.dtype
    x32 = x.float()
    eps = model_output.float()
    pred_x0 = (x32 - _f32(np.sqrt(np.float32(1.0) - alpha_t)) * eps) / _f32(np.sqrt(alpha_t))
    x_next = _f32(np.sqrt(alpha_next)) * pred_x0 + _f32(np.sqrt(np.float32(1.0) - alpha_next)) * eps
    return x_next.to(dtype), pred_x0.to(dtype)


def ddim_prev(schedule: DDIMSchedule, model_output: torch.Tensor, timestep: int,
              x: torch.Tensor) -> torch.Tensor:
    """One deterministic DDIM step x_t -> x_{t-delta} (eta 0, the strict
    `t_prev > 0` test), in float32; the caller casts."""
    one = np.float32(1.0)
    t = int(timestep)
    alpha_t = schedule.alpha_at(t)
    alpha_prev = schedule.alpha_prev_strict(t - schedule.step_delta)
    eps = model_output.float()
    pred_x0 = (x.float() - _f32(np.sqrt(one - alpha_t)) * eps) / _f32(np.sqrt(alpha_t))
    return _f32(np.sqrt(alpha_prev)) * pred_x0 + _f32(np.sqrt(one - alpha_prev)) * eps


def ctrl_step(
    schedule: DDIMSchedule,
    model_output: torch.Tensor,
    timestep: int,
    x: torch.Tensor,
    mask: torch.Tensor,
    eta: float,
    noise: Optional[torch.Tensor],
    ddim_streams_from: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hybrid DDIM/DDPM step: DDIM everywhere, DDPM direction plus
    sigma * noise inside `mask`; streams >= `ddim_streams_from` stay pure
    DDIM with the mask treated as ones.

    model_output, x: [B, H, W, C] (NHWC, as the JAX package), streams on
    the batch axis; mask: [H, W] (1 = DDPM region); noise: [B, H, W, C]
    float32 standard normal draws (required when eta > 0).  Per case (the
    batched lanes, `jax.vmap` of the step in JAX): x, model_output and
    noise [N, B, H, W, C] with one mask per case [N, H, W].
    """
    dtype = x.dtype
    x32 = x.float()
    eps = model_output.float()
    t = int(timestep)
    alpha_t = schedule.alpha_at(t)
    alpha_prev = schedule.alpha_prev_strict(t - schedule.step_delta)
    one = np.float32(1.0)
    beta_t = one - alpha_t

    pred_x0 = (x32 - _f32(np.sqrt(beta_t)) * eps) / _f32(np.sqrt(alpha_t))
    std_dev_t = np.float32(eta) * np.sqrt(schedule.variance(t))

    lead = mask.ndim - 2  # the case axis, if any, before the streams
    mask_b = mask.float()[(slice(None),) * lead + (None, Ellipsis, None)].expand(x.shape)

    b = x.shape[lead]
    stream_shape = (1,) * lead + (b,) + (1,) * (x.ndim - lead - 1)
    std = torch.full(x.shape[:lead + 1] + (1,) * (x.ndim - lead - 1), _f32(std_dev_t),
                     device=x.device)
    if ddim_streams_from is not None:
        is_ref = (torch.arange(b, device=x.device) >= ddim_streams_from).reshape(stream_shape)
        std = torch.where(is_ref, torch.zeros_like(std), std)
        mask_b = torch.where(is_ref, torch.ones_like(mask_b), mask_b)

    a_prev = torch.tensor(float(alpha_prev), dtype=torch.float32, device=x.device)
    dir_ddpm = torch.sqrt(1.0 - a_prev - std**2) * eps * mask_b
    dir_ddim = _f32(np.sqrt(one - alpha_prev)) * eps * (1.0 - mask_b)
    x_prev = _f32(np.sqrt(alpha_prev)) * pred_x0 + dir_ddpm + dir_ddim

    if eta > 0:
        if noise is None:
            raise ValueError("ctrl_step with eta > 0 requires a noise tensor")
        x_prev = x_prev + std * noise.to(x_prev.device, torch.float32) * mask_b

    return x_prev.to(dtype), pred_x0.to(dtype)


def linear_context_guidance(
    i, start_step: int, end_step: int, num_steps: int, end_scale: float = 0.5
) -> np.ndarray:
    """TCA strength schedule, reference `linear_param`: 1.0 at start_step,
    `end_scale` at end_step, 0.0 at num_steps."""
    i = np.asarray(i, np.float32)
    first = np.where(
        end_step == start_step,
        1.0,
        1.0 + (end_scale - 1.0) / max(end_step - start_step, 1e-9) * (i - start_step),
    )
    second = end_scale + (-end_scale) / max(num_steps - end_step, 1e-9) * (i - end_step)
    return np.where(i <= end_step, first, second).astype(np.float32)


def context_guidance_schedule(
    start_step: int, end_step: int, num_steps: int, end_scale: float = 0.5
) -> np.ndarray:
    """[num_steps] context-guidance values (zeros before start)."""
    out = np.zeros(num_steps, np.float32)
    idx = np.arange(start_step, num_steps)
    out[idx] = linear_context_guidance(idx, start_step, end_step, num_steps, end_scale)
    return out


def method_and_gates(
    method_type: str, start_step: int, end_step: int, num_steps: int, end_scale: float
) -> Tuple[str, np.ndarray, np.ndarray]:
    """Static method name + per-step (context_guidance, share_gate) arrays
    (`freefine_tpu.pipeline._method_and_gates`)."""
    k = num_steps - start_step
    steps = np.arange(start_step, num_steps)
    if method_type == "tca":
        cg = context_guidance_schedule(start_step, end_step, num_steps, end_scale)[
            start_step:
        ]
        return "tca", cg, np.ones(k, np.float32)
    if method_type == "mmsa_es":
        return "mmsa", np.zeros(k, np.float32), (steps < end_step).astype(np.float32)
    return method_type, np.zeros(k, np.float32), np.ones(k, np.float32)
