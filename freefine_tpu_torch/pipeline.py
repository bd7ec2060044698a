"""FreeFine editing pipeline in PyTorch (mirrors `freefine_tpu.pipeline`
for `FreeFine.generation`, the energy-guided `FreeFine.guided_generation`,
object removal `FreeFine.background_generation` and multi-image
`FreeFine.cross_image_composition`).

The JAX package compiles each loop into one `lax.scan`; here the loops are
plain Python over eager PyTorch modules.  Public functions keep the JAX
layouts: `generation` takes and returns NHWC uint8 images, the latent
functions take and return NHWC float32 latents.

Conditioning: every loop and entry point carries the text conditioning as
a `conditioning.Cond` (the context and, for SDXL, the added conditioning
with the same leading axes); a loop also takes a bare context tensor, and
`FreeFine.unet_apply` splits the two at the UNet call.

Backbones: the denoiser is the UNet (`UNetConfig`) or the PixArt DiT
(`DiTConfig`), the text tower CLIP or T5 (PixArt's `T5Config`); the loops
and entry points are the same for each (`build_modules`).

Noise: every sampling loop draws one standard-normal tensor per step from
a `torch.Generator` seeded by `seed`, or takes an explicit per-step noise
sequence (the tests replay JAX's `split` -> `normal` chain through it).

The pipeline is inference only: its parameters never require grad.  The
one gradient it takes, energy guidance, is with respect to the latent.

The pipeline runs on CUDA unless the caller passes `device="cpu"`; asking
for CUDA on a machine without it raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from freefine_tpu_torch import masks as mask_ops
from freefine_tpu_torch.conditioning import Cond
from freefine_tpu_torch.config import DiTConfig, PipelineConfig, sd15_pipeline_config
from freefine_tpu_torch.edit import (
    DEFAULT_LAYER_RANGE,
    EditConfig,
    EditState,
    build_mask_pyramid,
    build_mask_stack_pyramid,
    nearest_resize,
    none_config,
)
from freefine_tpu_torch.models.dit import DiT2DCondition
from freefine_tpu_torch.models.t5 import T5Config, T5Encoder
from freefine_tpu_torch.models.text_encoder import CLIPTextEncoder
from freefine_tpu_torch.models.tokenizer import load_tokenizer
from freefine_tpu_torch.models.unet import UNet2DCondition
from freefine_tpu_torch.models.vae import AutoencoderKL, from_uint8, to_uint8
from freefine_tpu_torch.ops.resize import resize_lanczos3
from freefine_tpu_torch.ops.guidance import energy_guidance
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, ctrl_step, inv_step, method_and_gates
from freefine_tpu_torch.utils.attn_store import collect_maps
from freefine_tpu_torch.utils.vis import latent_to_preview
from freefine_tpu_torch.weights import random_weights

METHOD_TYPES = ("tca", "mmsa", "mmsa_es", "ssa", "sdsa")

NoiseSource = Union[torch.Generator, Sequence[torch.Tensor]]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The requested device; CUDA without a card raises (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run the plain CPU path")
    return dev


# ---------------------------------------------------------------------------
# Loops
# ---------------------------------------------------------------------------


@torch.no_grad()
def ddim_invert_loop(
    unet_apply: Callable, schedule: DDIMSchedule, latents: torch.Tensor,
    text_emb, num_actual: int,
) -> torch.Tensor:
    """DDIM inversion (guidance 1.0).  latents [B, h, w, c], text_emb the
    per-row conditioning [B, ...] -> trajectory [num_actual+1, B, h, w, c]:
    [0] the clean latent, [-1] the most noised."""
    ts = schedule.timesteps[::-1][:num_actual]
    traj = [latents]
    lat = latents
    for t in ts:
        eps = unet_apply(lat, int(t), text_emb)
        lat, _ = inv_step(schedule, eps, int(t), lat)
        traj.append(lat)
    return torch.stack(traj)


def _cfg_model_in(lat: torch.Tensor, nstr: int) -> torch.Tensor:
    """UNet input from the per-stream latents (streams on axis -4, after an
    optional case axis): deduped layout appends the edit latent as the
    conditional row ([u_e, r] -> [u_e, r, c_e]); the legacy layout doubles
    every row."""
    if nstr == lat.shape[-4] + 1:
        return torch.cat([lat, lat[..., :1, :, :, :]], dim=-4)
    return torch.cat([lat, lat], dim=-4)


def _cfg_split(eps: torch.Tensor, nstr: int):
    """(uncond, cond) stream pairs (streams on axis -4): deduped nu = [u_e,
    r], nc = [c_e, r]."""
    eps = eps.float()
    if nstr == 3:
        return eps[..., :2, :, :, :], torch.cat(
            [eps[..., 2:3, :, :, :], eps[..., 1:2, :, :, :]], dim=-4)
    return eps.chunk(2, dim=-4)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[C, streams, ...] -> [C * streams, ...] (case-major UNet batch)."""
    return x.reshape(-1, *x.shape[2:])


def _cfg_noise(nu, nc, cfg_mask, guidance_scale: float, local_text_edit: bool):
    """Classifier-free guidance, localised to cfg_mask under local_text_edit."""
    if local_text_edit:
        return nu + guidance_scale * (nc - nu) * cfg_mask
    return nu + guidance_scale * (nc - nu)


@torch.no_grad()
def sample_edit_cases(
    unet_apply: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    traj: torch.Tensor,            # [K+1, C, 2, h, w, c] inversion trajectories
    text_emb,                      # [C, 3, ...] [u, u_ref, edit] (or legacy [C, 4])
    state: EditState,              # mask pyramids [C, S] ([S] for one case)
    cg: np.ndarray,                # [K] context guidance schedule
    gates: np.ndarray,             # [K] share gates
    completion_cfg: torch.Tensor,  # [C, lh, lw] local CFG multipliers
    local_var: torch.Tensor,       # [C, lh, lw] DDPM regions
    noise: Sequence[NoiseSource],  # one per case
    *,
    start_step: int,
    guidance_scale: float,
    eta: float,
    local_text_edit: bool,
    local_perturbation: bool,
    return_intermediates: bool = False,
):
    """Geometric-edit regeneration (reference forward_sampling) of C cases
    at once: per step each case's reference stream is pinned to its
    inversion latent, ONE UNet call runs every case's [u_e, r, c_e], local
    CFG combines the streams and the hybrid `ctrl_step` steps each case's
    2-stream stack with its own draw.  Returns the final latents
    [C, 2, h, w, c], or with return_intermediates (final, each step's edit
    stream after its `ctrl_step` [K, C, h, w, c])."""
    k = traj.shape[0] - 1
    text = Cond.of(text_emb)
    cases, nstr = text.lead
    ts = schedule.timesteps[start_step : start_step + k]
    refs = torch.flip(traj[:k], dims=[0])[:, :, 1:]
    lat = traj[-1].clone()
    text = text.reshape(-1)
    cfg_mask = completion_cfg[:, None, :, :, None]
    var_mask = local_var if local_perturbation else torch.ones_like(local_var)
    inter = []
    for i in range(k):
        t = int(ts[i])
        lat[:, 1:] = refs[i]
        state.context_guidance = float(cg[i])
        state.share_gate = float(gates[i])
        eps = unet_apply(_flat(_cfg_model_in(lat, nstr)), t, text, ecfg, state)
        nu, nc = _cfg_split(eps.reshape(cases, nstr, *eps.shape[1:]), nstr)
        lat, _ = ctrl_step(schedule, _cfg_noise(nu, nc, cfg_mask, guidance_scale, local_text_edit),
                           t, lat, var_mask, eta, _draw_cases(noise, i, lat), ddim_streams_from=1)
        if return_intermediates:
            inter.append(lat[:, 0])
    return (lat, torch.stack(inter)) if return_intermediates else lat


def _one_case(out, return_intermediates: bool):
    """A `*_cases` loop's result for its one case: the final latents, or
    (final, per-step latents [K, h, w, c])."""
    if return_intermediates:
        return out[0][0], out[1][:, 0]
    return out[0]


def sample_edit_loop(unet_apply: Callable, schedule: DDIMSchedule, ecfg: EditConfig,
                     traj: torch.Tensor, text_emb, state: EditState, cg: np.ndarray,
                     gates: np.ndarray, completion_cfg: torch.Tensor, local_var: torch.Tensor,
                     noise: NoiseSource, **kw) -> torch.Tensor:
    """`sample_edit_cases` of one case: traj [K+1, 2, h, w, c], text_emb
    [3, ...], masks [lh, lw] -> the final 2-stream latents [2, h, w, c]
    (with return_intermediates, and the edit stream after each step
    [K, h, w, c])."""
    return _one_case(sample_edit_cases(unet_apply, schedule, ecfg, traj[:, None],
                                       Cond.of(text_emb)[None],
                                       state, cg, gates, completion_cfg[None], local_var[None],
                                       [noise], **kw), kw.get("return_intermediates", False))


@torch.no_grad()
def sample_bggen_cases(
    unet_apply: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    traj: torch.Tensor,            # [K+1, C, 1, h, w, c] inversion trajectories
    text_emb,                      # [C, 3, ...] [u, u_ref, cond] (or legacy [C, 4])
    state: EditState,
    cg: np.ndarray,
    gates: np.ndarray,
    local_cfg: torch.Tensor,       # [C, lh, lw] local CFG multipliers
    local_var: torch.Tensor,       # [C, lh, lw] DDPM regions
    noise: Sequence[NoiseSource],
    *,
    start_step: int,
    guidance_scale: float,
    eta: float,
    local_text_edit: bool,
    local_perturbation: bool,
    return_intermediates: bool = False,
):
    """Background generation / object removal (reference
    forward_sampling_background_gen) of C cases at once: each case's
    reference stream at step i is its inverted latent at the matching noise
    level (traj flipped), one UNet call runs every case's [u_g, r, c_g],
    local CFG combines and `ctrl_step` steps each case's [g, r] stack.
    Returns the generated latents [C, 1, h, w, c], or with
    return_intermediates (final, each step's generated stream [K, C, h, w, c])."""
    k = traj.shape[0] - 1
    text = Cond.of(text_emb)
    cases, nstr = text.lead
    ts = schedule.timesteps[start_step : start_step + k]
    refs = torch.flip(traj[1:], dims=[0])
    lat = traj[-1]
    text = text.reshape(-1)
    cfg_mask = local_cfg[:, None, :, :, None]
    var_mask = local_var if local_perturbation else torch.ones_like(local_var)
    inter = []
    for i in range(k):
        t = int(ts[i])
        lat2 = torch.cat([lat, refs[i]], dim=1)
        state.context_guidance = float(cg[i])
        state.share_gate = float(gates[i])
        eps = unet_apply(_flat(_cfg_model_in(lat2, nstr)), t, text, ecfg, state)
        nu, nc = _cfg_split(eps.reshape(cases, nstr, *eps.shape[1:]), nstr)
        lat2, _ = ctrl_step(schedule, _cfg_noise(nu, nc, cfg_mask, guidance_scale,
                                                 local_text_edit),
                            t, lat2, var_mask, eta, _draw_cases(noise, i, lat2),
                            ddim_streams_from=1)
        lat = lat2[:, :1]
        if return_intermediates:
            inter.append(lat2[:, 0])
    return (lat, torch.stack(inter)) if return_intermediates else lat


def sample_bggen_loop(unet_apply: Callable, schedule: DDIMSchedule, ecfg: EditConfig,
                      traj: torch.Tensor, text_emb, state: EditState,
                      cg: np.ndarray, gates: np.ndarray, local_cfg: torch.Tensor,
                      local_var: torch.Tensor, noise: NoiseSource, **kw) -> torch.Tensor:
    """`sample_bggen_cases` of one case: traj [K+1, 1, h, w, c] -> the
    generated latent [1, h, w, c] (with return_intermediates, and the
    generated stream after each step [K, h, w, c])."""
    return _one_case(sample_bggen_cases(unet_apply, schedule, ecfg, traj[:, None],
                                        Cond.of(text_emb)[None], state, cg, gates, local_cfg[None],
                                        local_var[None], [noise], **kw),
                     kw.get("return_intermediates", False))


@torch.no_grad()
def sample_compose_cases(
    unet_apply: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    traj: torch.Tensor,            # [K+1, C, N+1, h, w, c] inversion trajectories
    text_emb,                      # [C, N+2, ...] per-stream conditioning
    text_extra,                    # [C, P, L, D] region prompts of the cond streams
    state: EditState,
    cg: np.ndarray,
    gates: np.ndarray,
    completion_cfg: torch.Tensor,  # [C, lh, lw]
    local_var: torch.Tensor,       # [C, lh, lw]
    noise: Sequence[NoiseSource],
    *,
    start_step: int,
    guidance_scale: float,
    eta: float,
    local_text_edit: bool,
    local_perturbation: bool,
    return_intermediates: bool = False,
):
    """N-image composition (reference forward_sampling_compose) of C cases
    at once: per step each case's streams are [e, r_1..r_N, c_e], the
    sources pinned to their inversion latents; one UNet call runs every
    case, CFG combines each case's first and last stream and `ctrl_step`
    steps its edit latent.  Returns them, [C, 1, h, w, c], or with
    return_intermediates (final, each step's edit latent [K, C, h, w, c])."""
    k = traj.shape[0] - 1
    text = Cond.of(text_emb)
    cases, nstr = text.lead
    ts = schedule.timesteps[start_step : start_step + k]
    refs = torch.flip(traj[:k], dims=[0])[:, :, 1:]
    lat = traj[-1][:, :1]
    text, extra = text.reshape(-1), Cond.of(text_extra).reshape(-1)
    cfg_mask = completion_cfg[:, None, :, :, None]
    var_mask = local_var if local_perturbation else torch.ones_like(local_var)
    inter = []
    for i in range(k):
        t = int(ts[i])
        state.context_guidance = float(cg[i])
        state.share_gate = float(gates[i])
        eps = unet_apply(_flat(torch.cat([lat, refs[i], lat], dim=1)), t, text, ecfg, state,
                         ctx_extra=extra).float()
        eps = eps.reshape(cases, nstr, *eps.shape[1:])
        lat, _ = ctrl_step(schedule, _cfg_noise(eps[:, :1], eps[:, -1:], cfg_mask,
                                                guidance_scale, local_text_edit),
                           t, lat, var_mask, eta, _draw_cases(noise, i, lat))
        if return_intermediates:
            inter.append(lat[:, 0])
    return (lat, torch.stack(inter)) if return_intermediates else lat


def sample_compose_loop(unet_apply: Callable, schedule: DDIMSchedule, ecfg: EditConfig,
                        traj: torch.Tensor, text_emb, text_extra, state: EditState,
                        cg: np.ndarray, gates: np.ndarray,
                        completion_cfg: torch.Tensor, local_var: torch.Tensor,
                        noise: NoiseSource, **kw) -> torch.Tensor:
    """`sample_compose_cases` of one case: traj [K+1, N+1, h, w, c] -> the
    edit latent [1, h, w, c] (with return_intermediates, and the edit
    latent after each step [K, h, w, c])."""
    return _one_case(sample_compose_cases(unet_apply, schedule, ecfg, traj[:, None],
                                          Cond.of(text_emb)[None], Cond.of(text_extra)[None],
                                          state, cg, gates,
                                          completion_cfg[None], local_var[None], [noise], **kw),
                     kw.get("return_intermediates", False))


@torch.no_grad()
def sample_edit_loop_shared(
    unet_edit: Callable,
    unet_capture: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    ref_traj: torch.Tensor,        # [K+1, h, w, c] reference inversion trajectory
    init_lat: torch.Tensor,        # [C, h, w, c] per-case coarse traj[-1]
    text_pair,                     # [C, 2, ...] per-case [uncond, cond]
    text_ref,                      # [1, ...] uncond conditioning of the capture pass
    states: EditState,             # mask pyramids [C, S]
    cg: np.ndarray,
    gates: np.ndarray,
    completion_cfg: torch.Tensor,  # [C, lh, lw]
    local_var: torch.Tensor,       # [C, lh, lw]
    noise: Sequence[NoiseSource],
    **kw,
) -> torch.Tensor:
    """Shared-reference regeneration of C cases that edit the same source
    image.  In `sample_edit_cases` each case's reference stream is re-pinned
    to the same inverted latent every step and its stepped output is
    discarded: C copies of one computation.  Here it runs once per step as a
    capture pass (`EditConfig.store_kv`) whose TCA-layer K/V every case's
    2-stream [u_e, c_e] pass consumes (`EditConfig.shared_ref`).  The
    capture pass is vanilla, so this equals `sample_edit_cases` run with
    `ref_vanilla=True`.  Per-case draws keep their shape: `ctrl_step` steps
    a 2-row [edit, ref] stack per case.  Returns [C, h, w, c]."""
    k = ref_traj.shape[0] - 1
    refs = torch.flip(ref_traj[:k], dims=[0])
    return _shared_ref_scan(unet_edit, unet_capture, schedule, ecfg, refs, init_lat, text_pair,
                            text_ref, states, cg, gates, completion_cfg, local_var, noise, **kw)


@torch.no_grad()
def sample_bggen_loop_shared(
    unet_edit: Callable,
    unet_capture: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    ref_traj: torch.Tensor,        # [K+1, h, w, c] source inversion trajectory
    text_pair,                     # [C, 2, ...]
    text_ref,                      # [1, ...]
    states: EditState,
    cg: np.ndarray,
    gates: np.ndarray,
    local_cfg: torch.Tensor,       # [C, lh, lw]
    local_var: torch.Tensor,       # [C, lh, lw]
    noise: Sequence[NoiseSource],
    **kw,
) -> torch.Tensor:
    """Shared-source background generation of C removal cases of one
    source image: the source's inversion is every case's init and, at the
    matching noise level, its reference; the reference runs once per step
    as a capture pass and each case a 2-stream [u_g, c_g] pass consuming
    it (ref_vanilla semantics, as `sample_edit_loop_shared`).  Returns
    [C, h, w, c]."""
    refs = torch.flip(ref_traj[1:], dims=[0])
    init = ref_traj[-1][None].expand(Cond.of(text_pair).lead[0], *ref_traj.shape[1:])
    return _shared_ref_scan(unet_edit, unet_capture, schedule, ecfg, refs, init, text_pair,
                            text_ref, states, cg, gates, local_cfg, local_var, noise, **kw)


def _shared_ref_scan(
    unet_edit: Callable,
    unet_capture: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    refs: torch.Tensor,            # [K, h, w, c] per-step pinned reference latents
    init_lat: torch.Tensor,        # [C, h, w, c]
    text_pair,                     # [C, 2, ...]
    text_ref,                      # [1, ...]
    states: EditState,
    cg: np.ndarray,
    gates: np.ndarray,
    completion_cfg: torch.Tensor,
    local_var: torch.Tensor,
    noise: Sequence[NoiseSource],
    *,
    start_step: int,
    guidance_scale: float,
    eta: float,
    local_text_edit: bool,
    local_perturbation: bool,
) -> torch.Tensor:
    """The denoise loop of both shared lanes: per step ONE batch-1 capture
    pass of the reference, ONE UNet call over every case's [u, c], local
    CFG, and `ctrl_step` on each case's 2-row [case, ref] stack."""
    k = refs.shape[0]
    cases = init_lat.shape[0]
    ts = schedule.timesteps[start_step : start_step + k]
    text = Cond.of(text_pair).reshape(-1)
    cfg_mask = completion_cfg[:, :, :, None]
    var_mask = local_var if local_perturbation else torch.ones_like(local_var)
    lat = init_lat
    for i in range(k):
        t, ref = int(ts[i]), refs[i]
        states.context_guidance = float(cg[i])
        states.share_gate = float(gates[i])
        states.ref_kv = unet_capture(ref[None], t, text_ref)
        eps = unet_edit(lat.repeat_interleave(2, dim=0), t, text, ecfg, states).float()
        eps = eps.reshape(cases, 2, *eps.shape[1:])
        pred = _cfg_noise(eps[:, 0], eps[:, 1], cfg_mask, guidance_scale, local_text_edit)
        x2 = torch.stack([lat, ref.expand_as(lat)], dim=1)
        n2 = torch.stack([pred, torch.zeros_like(pred)], dim=1)
        new, _ = ctrl_step(schedule, n2, t, x2, var_mask, eta, _draw_cases(noise, i, x2),
                           ddim_streams_from=1)
        lat = new[:, 0]
    states.ref_kv = None
    return lat


def _draw(noise: NoiseSource, i: int, lat: torch.Tensor) -> torch.Tensor:
    """Step i's standard-normal draw shaped like `lat`."""
    if isinstance(noise, torch.Generator):
        return torch.randn(lat.shape, generator=noise, device=lat.device, dtype=torch.float32)
    return noise[i]


def _draw_cases(noise: Sequence[NoiseSource], i: int, lat: torch.Tensor) -> torch.Tensor:
    """Step i's draws of every case, [C, ...] like `lat`: case c's from its
    own source, shaped like lat[c], so a case draws the same alone or in a
    batch."""
    return torch.stack([_draw(src, i, x) for src, x in zip(noise, lat)])


def sample_guided_loop(
    unet_apply: Callable,          # FreeFine.unet_apply: edit pass and plain feature taps
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    traj: torch.Tensor,            # [K+1, 2, h, w, c] inversion trajectory
    text_emb,                      # [3, ...] [u, u_ref, edit]
    state: EditState,
    cg: np.ndarray,
    gates: np.ndarray,
    completion_cfg: torch.Tensor,
    local_var: torch.Tensor,
    energy_masks: tuple,           # (mask_cur, mask_other, mask_non_overlap)
    noise: NoiseSource,
    *,
    start_step: int,
    guidance_scale: float,
    eta: float,
    energy_scale: float,
    energy_until: int,
    feature_indices: Sequence[int] = (1, 2),
) -> torch.Tensor:
    """`sample_edit_loop` (local CFG, local perturbation) with
    DragonDiffusion-style energy guidance added to the edit stream's noise
    prediction for the first `energy_until` steps.

    `unet_apply` runs the edit pass with `ecfg` and the plain UNet's feature
    taps with `return_features=True` (JAX passes two applies).  The edit UNet
    pass runs under no_grad; the energy gradient is taken on a
    detached copy of the edit latent (`energy_guidance`).  JAX's scan
    computes the energy at every step and multiplies it by
    (step < energy_until); here it is computed only on those steps, which
    gives the same latents wherever the energy gradient is finite."""
    mask_cur, mask_other, mask_no = energy_masks
    target_hw = tuple(mask_cur.shape)
    k = traj.shape[0] - 1
    text = Cond.of(text_emb)
    nstr = text.lead[0]
    ts = schedule.timesteps[start_step : start_step + k]
    refs = torch.flip(traj[:k], dims=[0])[:, 1:]
    lat = traj[-1].clone()
    cfg_mask = completion_cfg[None, :, :, None]
    for i in range(k):
        t = int(ts[i])
        lat[1:] = refs[i]
        state.context_guidance = float(cg[i])
        state.share_gate = float(gates[i])
        with torch.no_grad():
            eps = unet_apply(_cfg_model_in(lat, nstr), t, text, ecfg, state)
        nu, nc = _cfg_split(eps, nstr)
        pred = nu + guidance_scale * (nc - nu) * cfg_mask
        if i < energy_until:
            g = energy_guidance(
                unet_apply, lat[:1], refs[i], t, text[2:3], energy_scale=energy_scale,
                guidance_mask=local_var, feature_indices=feature_indices, target_hw=target_hw,
                inv_warp=None, mask_cur=mask_cur, mask_other=mask_other,
                mask_non_overlap=mask_no,
            )
            pred[:1] += g
        lat, _ = ctrl_step(schedule, pred, t, lat, local_var, eta, _draw(noise, i, lat),
                           ddim_streams_from=1)
    return lat


def _guided_energy_masks(cfg: PipelineConfig, em: mask_ops.EditMasks):
    """(mask_cur, mask_other, mask_non_overlap) at the guidance feature
    resolution (2x latent)."""
    hw = (cfg.latent_height * 2, cfg.latent_width * 2)
    return (
        nearest_resize(em.fg_retain, *hw),
        nearest_resize(1.0 - torch.maximum(em.fg_retain, em.fg_ref), *hw),
        nearest_resize(em.fg_ref * (1.0 - em.fg_retain), *hw),
    )


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def build_modules(cfg: PipelineConfig) -> dict:
    """The denoiser, VAE and text tower of `cfg`, in eval mode, on the
    current default device: {"unet": the UNet or, for a `DiTConfig`, the
    DiT, "vae", "text": CLIP or, for a `T5Config`, T5}."""
    unet = DiT2DCondition(cfg.unet) if isinstance(cfg.unet, DiTConfig) else UNet2DCondition(
        cfg.unet)
    text = T5Encoder(cfg.text) if isinstance(cfg.text, T5Config) else CLIPTextEncoder(cfg.text)
    return {"unet": unet.eval(), "vae": AutoencoderKL(cfg.vae).eval(), "text": text.eval()}


class FreeFine:
    """Training-free geometric image editing, on the UNet or the DiT
    backbone (`build_modules`).

    params: {"unet", "vae", "text"} state dicts (the `components()`).
    Without them the constructor raises, as JAX's does, unless
    `init_random=True` asks for random weights (`weights.random_weights`,
    seeded by `seed`, drawn on the pipeline's device) for weight-free runs
    (tests, throughput)."""

    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        params: Optional[dict] = None,
        tokenizer_path: Optional[str] = None,
        init_random: bool = False,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        self.config = config or sd15_pipeline_config()
        self.device = resolve_device(device)
        if params is None and not init_random:
            raise ValueError("Pass state dicts as params, or init_random=True for "
                             "weight-free runs.")
        cfg = self.config
        with torch.device(self.device):
            self._build_modules()
        for i, (name, mod) in enumerate(self.components().items()):
            if params is not None:
                mod.load_state_dict(params[name])
            else:
                random_weights(mod, seed + i)
            mod.requires_grad_(False)
        self.tokenizer = load_tokenizer(
            tokenizer_path, vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length
        )
        self._schedules = {}
        # SD-1.5's reference TCA window (10, 16) as the same decoder
        # fraction of this backbone's depth-weighted layer layout (a DiT's
        # blocks: (18, 28) for PixArt-XL-2)
        lo, hi = DEFAULT_LAYER_RANGE
        total, _ = cfg.unet.attn_layer_layout
        self._layer_range = (round(lo / hi * total), total)

    def _build_modules(self) -> None:
        mods = build_modules(self.config)
        self.unet, self.vae, self.text_encoder = mods["unet"], mods["vae"], mods["text"]

    def components(self) -> dict:
        return {"unet": self.unet, "vae": self.vae, "text": self.text_encoder}

    def use_mesh(self, *args, **kwargs):
        raise NotImplementedError("mesh serving is not ported yet (ROADMAP A15)")

    def _schedule(self, num_step: int) -> DDIMSchedule:
        if num_step not in self._schedules:
            self._schedules[num_step] = DDIMSchedule.create(
                self.config.scheduler, num_inference_steps=num_step
            )
        return self._schedules[num_step]

    def unet_apply(self, lat, t, ctx, ecfg: Optional[EditConfig] = None,
                   state: Optional[EditState] = None, return_features: bool = False,
                   ctx_extra=None):
        """NHWC latents -> NHWC noise prediction (model dtype); with
        return_features, (eps, features) with NHWC features (the plain
        UNet's taps that energy guidance reads).  ctx: the conditioning
        (`Cond`, or a context [B, L, D]); ctx_extra: the compose region
        prompts [P, L, D] (of a `Cond`, its context alone)."""
        kw = {} if ecfg is None else dict(edit_cfg=ecfg, edit_state=state)
        cond = Cond.of(ctx)
        extra = None if ctx_extra is None else Cond.of(ctx_extra).ctx
        out = self.unet(lat.permute(0, 3, 1, 2), t, cond.ctx, return_features=return_features,
                        context_extra=extra, added_cond=cond.added, **kw)
        if return_features:
            eps, feats = out
            return eps.permute(0, 2, 3, 1), [f.permute(0, 2, 3, 1) for f in feats]
        return out.permute(0, 2, 3, 1)

    def make_unet_capture(self, ecfg: EditConfig) -> Callable:
        """The shared-reference capture pass for `ecfg`'s TCA layers: a
        function (lat [1, h, w, c], t, ctx [1, ...]) -> {block_index:
        (k [S, E], v [S, E])}, one vanilla UNet pass (`store_kv`) returning
        the K/V of each self-attention TCA would modulate (JAX's
        `_extract_ref_kv` of a sown pass).  The whole UNet runs; its output
        is unused."""
        cap_cfg = dataclasses.replace(none_config(), store_kv=True, layer_range=ecfg.layer_range)

        def capture(lat, t, ctx):
            store = EditState(ref_kv={})
            self.unet_apply(lat, t, ctx, cap_cfg, store)
            return store.ref_kv

        return capture

    @torch.no_grad()
    def attention_maps(self, sample: torch.Tensor, t, text_emb: torch.Tensor,
                       ecfg: Optional[EditConfig] = None, state: Optional[EditState] = None):
        """One UNet forward (`unet_apply`, NHWC) with the attention-map
        instrument on, the reference's AttentionStore probe.  Returns (eps,
        {"{place}_{self|cross}": [head-averaged maps [B, Sq, Sk] of the
        layers with Sq <= 32*32, in layer order]}).  The maps are read from
        q and k beside the layer's own route: eps is what `unet_apply`
        returns without the probe.  Without a state every layer runs its
        plain attention, as the dispatch does for a missing state.  For
        step-averaged maps over a loop, feed each step's
        `EditState.intermediates` to `utils.attn_store.AttentionStore`."""
        ecfg = dataclasses.replace(ecfg or EditConfig(), store_attention=True)
        if state is None:
            ecfg = dataclasses.replace(ecfg, mode="none", method=None)
            state = EditState()
        state = dataclasses.replace(state, intermediates={})
        eps = self.unet_apply(sample, t, text_emb, ecfg, state)
        return eps, collect_maps(state.intermediates)

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        """The denoiser's cross-attention context [B, L, D] of each text
        (L the tokenizer's length: 77 for CLIP, 120 for PixArt's T5).  T5
        masks the keys of id 0, JAX's rule (ROADMAP C8: under the hash
        tokenizer, whose bos is 0 and whose padding is eos 1, that masks
        the bos and keeps the padding)."""
        ids = torch.as_tensor(self.tokenizer.batch_encode(list(texts)), dtype=torch.long,
                              device=self.device)
        if isinstance(self.text_encoder, T5Encoder):
            return self.text_encoder(ids, (ids != 0).float())
        return self.text_encoder(ids)

    def _batch_text_embeddings(self, texts: Sequence[str]) -> Cond:
        """The conditioning [B, ...] of each text: the one hook a backbone
        with more conditioning than a context overrides (SDXL)."""
        return Cond(self.encode_text(texts))

    @torch.no_grad()
    def image_to_latent(self, image: np.ndarray) -> torch.Tensor:
        """uint8/float HWC or BHWC image -> scaled latents [B, lh, lw, 4] f32."""
        x = torch.as_tensor(np.asarray(image), device=self.device)
        x = from_uint8(x) if x.dtype == torch.uint8 else x.float()
        if x.ndim == 3:
            x = x[None]
        return self.vae.encode(x).float()

    @torch.no_grad()
    def latent_to_image(self, latents: torch.Tensor) -> np.ndarray:
        """Scaled latents [B, lh, lw, 4] -> uint8 images [B, H, W, 3]."""
        return to_uint8(self.vae.decode(latents)).cpu().numpy()

    def invert(self, latents: torch.Tensor, num_step: int, start_step: int,
               uncond=None) -> torch.Tensor:
        """DDIM-invert for (num_step - start_step) steps; returns the
        trajectory [K+1, B, h, w, c].  `uncond` is the "" conditioning (a
        `Cond` row, or a context [L, D]) an entry point has already
        encoded (else it is encoded here)."""
        emb = self._inversion_text_embeddings(latents.shape[0], uncond)
        return ddim_invert_loop(self.unet_apply, self._schedule(num_step), latents, emb,
                                num_step - start_step)

    def _inversion_text_embeddings(self, batch: int, uncond=None) -> Cond:
        """Per-stream unconditional conditioning for DDIM inversion."""
        if uncond is None:
            uncond = self._batch_text_embeddings([""])[0]
        return Cond.of(uncond).expand(batch)

    def _stream_text_embeddings(self, texts: Sequence[str]) -> Cond:
        """Per-stream conditioning of the compose loop."""
        return self._batch_text_embeddings(texts)

    def _extra_text_embeddings(self, texts: Sequence[str]) -> torch.Tensor:
        """Region prompts whose K/V feed compose's local cross-attention
        (a context alone: no added conditioning)."""
        return self.encode_text(texts)

    def _edit_text_embeddings(self, guidance_text: str) -> Cond:
        """[uncond, uncond_ref, cond_edit]: the deduped 3-stream CFG layout."""
        embs = self._batch_text_embeddings(["", guidance_text])
        return Cond.stack([embs[0], embs[0], embs[1]], 0)

    def _prep_image(self, img: np.ndarray) -> np.ndarray:
        """To [H, W, 3] uint8 at the pipeline resolution: an image of
        another size is resized as JAX's `jax.image.resize(..., "lanczos3")`
        resizes it (`resize_lanczos3`, on the pipeline's device), then
        rounded and clipped to [0, 255]."""
        cfg = self.config
        a = np.asarray(img)
        if a.ndim == 2:
            a = np.stack([a] * 3, -1)
        if a.shape[:2] != (cfg.height, cfg.width):
            t = resize_lanczos3(torch.as_tensor(np.ascontiguousarray(a), device=self.device),
                                cfg.height, cfg.width)
            a = torch.clamp(torch.round(t), 0, 255).to(torch.uint8).cpu().numpy()
        return a

    def generation(
        self,
        ori_img: np.ndarray,
        ori_mask: np.ndarray,
        coarse_input: np.ndarray,
        target_mask: np.ndarray,
        guidance_text: str,
        guidance_scale: float = 7.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 25,
        method_type: str = "tca",
        local_text_edit: bool = True,
        local_perturbation: bool = True,
        draw_mask: Optional[np.ndarray] = None,
        use_auto_draw: bool = False,
        cons_area: Optional[np.ndarray] = None,
        reduce_inp_artifacts: bool = False,
        end_scale: float = 0.5,
        seed: int = 42,
        return_ori: bool = False,
        return_intermediates: bool = False,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Geometric edit refinement (reference FreeFine_generation).
        Returns the edited uint8 image [H, W, 3], and after it the
        reconstructed reference image (decoded on its own) when return_ori
        and the per-step latent previews [K, lh, lw, 3] uint8
        (`utils.vis.latent_to_preview` of the edit stream after each step)
        when return_intermediates; a tuple when more than the image is
        asked for.  `noise` optionally replaces the seeded per-step draws
        with K tensors [2, lh, lw, 4]."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        cfg = self.config
        lh, lw = cfg.latent_height, cfg.latent_width
        dev = self.device

        coarse = self._prep_image(coarse_input)
        ori = self._prep_image(ori_img)
        lat2 = self.image_to_latent(np.stack([coarse, ori]))
        # one text-encoder call for the inversion's "" and the edit's
        # [u, u, c], as `BatchedFreeFine.generation` encodes a batch of one:
        # a case gives the same latents alone and as a batch of one
        text_emb = self._edit_text_embeddings(guidance_text)
        traj = self.invert(lat2, num_step, start_step, uncond=text_emb[0])

        def t(x):
            return None if x is None else torch.as_tensor(np.asarray(x), device=dev)

        em = mask_ops.prepare_various_mask(
            t(target_mask), t(ori_mask), t(draw_mask), cfg.height, cfg.width, lh, lw,
            use_auto_draw=use_auto_draw, cons_area=t(cons_area),
            reduce_inp_artifacts=reduce_inp_artifacts,
        )
        state = EditState(
            fg_retain=build_mask_pyramid(em.fg_retain, lh, lw),
            fg_ref=build_mask_pyramid(em.fg_ref, lh, lw),
            local_region=build_mask_pyramid(em.fg_retain, lh, lw),
        )
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = EditConfig(mode="edit", method=method, local_cfg=local_text_edit,
                          layer_range=self._layer_range)
        if noise is None:
            noise = torch.Generator(device=dev).manual_seed(seed)
        out = sample_edit_loop(
            self.unet_apply, self._schedule(num_step), ecfg, traj, text_emb, state, cg, gates,
            em.completion_cfg, em.local_var, noise, start_step=start_step,
            guidance_scale=guidance_scale, eta=eta, local_text_edit=local_text_edit,
            local_perturbation=local_perturbation, return_intermediates=return_intermediates,
        )
        lat = out[0] if return_intermediates else out
        # decode only the images returned, each as a batch of one: the edit
        # image is then the one a batch of one decodes (the VAE's rounding
        # depends on its batch), and no unused reference image is decoded
        rets = [self.latent_to_image(lat[:1])[0]]
        if return_ori:
            rets.append(self.latent_to_image(lat[1:])[0])
        if return_intermediates:
            rets.append(latent_to_preview(out[1]))
        return rets[0] if len(rets) == 1 else tuple(rets)

    def guided_generation(
        self,
        ori_img: np.ndarray,
        ori_mask: np.ndarray,
        coarse_input: np.ndarray,
        target_mask: np.ndarray,
        guidance_text: str,
        energy_scale: float = 2.0,
        energy_fraction: float = 0.6,
        guidance_scale: float = 7.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 25,
        method_type: str = "tca",
        use_auto_draw: bool = True,
        cons_area: Optional[np.ndarray] = None,
        end_scale: float = 0.5,
        seed: int = 42,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> np.ndarray:
        """Geometric edit with DragonDiffusion-parity energy guidance on top
        of the TCA regeneration: feature-cosine gradients (`ops.guidance`)
        are added to the noise prediction for the first `energy_fraction` of
        the denoise steps.  Returns the edited uint8 image [H, W, 3].
        `noise` optionally replaces the seeded per-step draws with K tensors
        [2, lh, lw, 4].  UNet backbone only: the DiT has no feature taps."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        if isinstance(self.config.unet, DiTConfig):
            raise NotImplementedError(
                "guided_generation needs the UNet backbone's intermediate feature taps for "
                "the energy gradients; the DiT backbone does not expose them.  Use a UNet "
                "pipeline config, or generation() on the DiT.")
        cfg = self.config
        lh, lw = cfg.latent_height, cfg.latent_width
        dev = self.device

        coarse = self._prep_image(coarse_input)
        ori = self._prep_image(ori_img)
        lat2 = self.image_to_latent(np.stack([coarse, ori]))
        text_emb = self._edit_text_embeddings(guidance_text)
        traj = self.invert(lat2, num_step, start_step, uncond=text_emb[0])

        if cons_area is None:
            cons_area = np.zeros((cfg.height, cfg.width), np.float32)
        em = mask_ops.prepare_various_mask(
            *(torch.as_tensor(np.asarray(x), device=dev) for x in (target_mask, ori_mask)),
            None, cfg.height, cfg.width, lh, lw, use_auto_draw=use_auto_draw,
            cons_area=torch.as_tensor(np.asarray(cons_area), device=dev),
        )
        state = EditState(
            fg_retain=build_mask_pyramid(em.fg_retain, lh, lw),
            fg_ref=build_mask_pyramid(em.fg_ref, lh, lw),
            local_region=build_mask_pyramid(em.fg_retain, lh, lw),
        )
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = EditConfig(mode="edit", method=method, local_cfg=True,
                          layer_range=self._layer_range)
        energy_until = int(round((num_step - start_step) * energy_fraction))
        if noise is None:
            noise = torch.Generator(device=dev).manual_seed(seed)
        lat = sample_guided_loop(
            self.unet_apply, self._schedule(num_step), ecfg, traj, text_emb,
            state, cg, gates, em.completion_cfg, em.local_var, _guided_energy_masks(cfg, em),
            noise, start_step=start_step, guidance_scale=guidance_scale, eta=eta,
            energy_scale=energy_scale, energy_until=energy_until,
        )
        return self.latent_to_image(lat[:1])[0]  # the edit stream alone, as `generation`

    def background_generation(
        self,
        ori_img: np.ndarray,
        ori_mask: np.ndarray,
        guidance_text: str,
        guidance_scale: float = 3.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 1,
        method_type: str = "tca",
        local_text_edit: bool = True,
        local_perturbation: bool = True,
        end_scale: float = 0.5,
        seed: int = 42,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> np.ndarray:
        """Object removal / background inpainting (reference
        FreeFine_background_generation): the masked object is regenerated
        from the background.  Returns the uint8 image [H, W, 3].  `noise`
        optionally replaces the seeded per-step draws with K tensors
        [2, lh, lw, 4]."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        cfg = self.config
        lh, lw = cfg.latent_height, cfg.latent_width
        dev = self.device

        lat = self.image_to_latent(self._prep_image(ori_img))
        text_emb = self._edit_text_embeddings(guidance_text)
        traj = self.invert(lat, num_step, start_step, uncond=text_emb[0])
        mask_full, local_var = mask_ops.prepare_mask_bggen(
            torch.as_tensor(np.asarray(ori_mask), device=dev), cfg.height, cfg.width, lh, lw)
        pyr = build_mask_pyramid(mask_full, lh, lw)
        state = EditState(fg_retain=pyr, fg_ref=pyr, local_region=pyr)
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = EditConfig(mode="bggen", method=method, local_cfg=local_text_edit,
                          layer_range=self._layer_range)
        if noise is None:
            noise = torch.Generator(device=dev).manual_seed(seed)
        out = sample_bggen_loop(
            self.unet_apply, self._schedule(num_step), ecfg, traj, text_emb, state, cg, gates,
            local_var, local_var, noise, start_step=start_step, guidance_scale=guidance_scale,
            eta=eta, local_text_edit=local_text_edit, local_perturbation=local_perturbation,
        )
        return self.latent_to_image(out)[0]

    def cross_image_composition(
        self,
        img_lists: Sequence[np.ndarray],
        ori_mask_lists: Sequence[np.ndarray],
        tgt_mask_lists: Sequence[np.ndarray],
        coarse_input: np.ndarray,
        guidance_text_list: Sequence[str],
        guidance_scale: float = 7.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 25,
        method_type: str = "tca",
        local_text_edit: bool = True,
        local_perturbation: bool = True,
        draw_mask: Optional[Sequence[np.ndarray]] = None,
        end_scale: float = 0.5,
        dil_completion: bool = False,
        dil_factor: int = 15,
        appearance_transfer: bool = False,
        seed: int = 42,
        noise: Optional[Sequence[torch.Tensor]] = None,
    ) -> np.ndarray:
        """N-image composition / appearance transfer (reference
        FreeFine_cross_image_composition): the objects of N source images,
        pasted into `coarse_input` at the target masks, are regenerated from
        their sources under per-region prompts.  Returns the uint8 image
        [H, W, 3].  `noise` optionally replaces the seeded per-step draws
        with K tensors [1, lh, lw, 4]."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        cfg = self.config
        lh, lw = cfg.latent_height, cfg.latent_width
        dev = self.device
        n = len(img_lists)

        lats = [self.image_to_latent(self._prep_image(coarse_input))]
        lats += [self.image_to_latent(self._prep_image(im)) for im in img_lists]
        traj = self.invert(torch.cat(lats, dim=0), num_step, start_step)

        def t(xs):
            return None if xs is None else [torch.as_tensor(np.asarray(m), device=dev)
                                            for m in xs]

        cm = mask_ops.prepare_composition_masks(
            t(ori_mask_lists), t(tgt_mask_lists), cfg.height, cfg.width, lh, lw,
            dil_completion=dil_completion, dil_factor=dil_factor, draw_masks=t(draw_mask),
            appearance_transfer=appearance_transfer,
        )
        state = EditState(src_masks=build_mask_stack_pyramid(cm.src_masks, lh, lw),
                          tgt_masks=build_mask_stack_pyramid(cm.tgt_masks, lh, lw))
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        prompts = list(guidance_text_list) + [""]
        if cm.tgt_masks.shape[0] < len(prompts):
            raise ValueError(f"{len(prompts)} region prompts vs {cm.tgt_masks.shape[0]} "
                             "target regions")
        ecfg = EditConfig(mode="compose", method=method, local_cfg=local_text_edit,
                          layer_range=self._layer_range, num_sources=n,
                          prompt_length=len(prompts))
        # per-stream context [uncond, prompt_1..prompt_N (padded with ""), uncond]
        stream_texts = [""] + (list(guidance_text_list) + [""] * n)[:n] + [""]
        if noise is None:
            noise = torch.Generator(device=dev).manual_seed(seed)
        out = sample_compose_loop(
            self.unet_apply, self._schedule(num_step), ecfg, traj,
            self._stream_text_embeddings(stream_texts), self._extra_text_embeddings(prompts),
            state, cg, gates,
            cm.completion_cfg, cm.local_var, noise, start_step=start_step,
            guidance_scale=guidance_scale, eta=eta, local_text_edit=local_text_edit,
            local_perturbation=local_perturbation,
        )
        return self.latent_to_image(out)[0]


# ---------------------------------------------------------------------------
# Batched multi-case editing
# ---------------------------------------------------------------------------


def _invert_cases(unet_plain: Callable, schedule: DDIMSchedule, lats: torch.Tensor,
                  text, num_actual: int) -> torch.Tensor:
    """DDIM inversion of every case's streams as one batch: lats, text
    [C, streams, ...] -> trajectories [K+1, C, streams, h, w, c]."""
    traj = ddim_invert_loop(unet_plain, schedule, _flat(lats), Cond.of(text).reshape(-1),
                            num_actual)
    return traj.reshape(traj.shape[0], *lats.shape)


def edit_case_fn(unet_plain: Callable, unet_edit: Callable, schedule: DDIMSchedule,
                 ecfg: EditConfig, *, num_actual: int, **loop_kw) -> Callable:
    """The edit compute of C cases (invert both streams of every case, then
    regenerate), each step one UNet call over all cases: the port's form of
    JAX's `jax.vmap(edit_case_fn)`.  The reference harness runs batch 1
    only (its attention controller holds per-case mutable state); here the
    state is data, so cases batch freely."""

    def fn(lat2, text2, text_s, states, cg, gates, cfg_masks, var_masks, noise):
        traj = _invert_cases(unet_plain, schedule, lat2, text2, num_actual)
        return sample_edit_cases(unet_edit, schedule, ecfg, traj, text_s, states, cg, gates,
                                 cfg_masks, var_masks, noise, **loop_kw)

    return fn


def edit_shared_fn(unet_plain: Callable, unet_edit: Callable, unet_capture: Callable,
                   schedule: DDIMSchedule, ecfg: EditConfig, *, num_actual: int,
                   **loop_kw) -> Callable:
    """The shared-source edit compute of C cases of one source image:
    invert the C coarse latents as one batch, the shared reference once,
    then `sample_edit_loop_shared`.  Per-edit UNet cost against
    `edit_case_fn`: inversion 1 + 1/C streams instead of 2, regeneration
    2 + 1/C instead of 3."""

    def fn(lat_coarse, lat_ref, text_u, text_pair, states, cg, gates, cfg_masks, var_masks,
           noise):
        text_u = Cond.of(text_u)
        traj_c = ddim_invert_loop(unet_plain, schedule, lat_coarse,
                                  text_u.expand(lat_coarse.shape[0]), num_actual)
        traj_r = ddim_invert_loop(unet_plain, schedule, lat_ref[None], text_u[None], num_actual)
        return sample_edit_loop_shared(unet_edit, unet_capture, schedule, ecfg, traj_r[:, 0],
                                       traj_c[-1], text_pair, text_u[None], states, cg, gates,
                                       cfg_masks, var_masks, noise, **loop_kw)

    return fn


def bggen_case_fn(unet_plain: Callable, unet_edit: Callable, schedule: DDIMSchedule,
                  ecfg: EditConfig, *, num_actual: int, **loop_kw) -> Callable:
    """The removal compute of C cases (invert, then the bggen loop), each
    step one UNet call over all cases."""

    def fn(lat1, text1, text_s, states, cg, gates, cfg_masks, var_masks, noise):
        traj = _invert_cases(unet_plain, schedule, lat1, text1, num_actual)
        return sample_bggen_cases(unet_edit, schedule, ecfg, traj, text_s, states, cg, gates,
                                  cfg_masks, var_masks, noise, **loop_kw)

    return fn


def bggen_shared_fn(unet_plain: Callable, unet_edit: Callable, unet_capture: Callable,
                    schedule: DDIMSchedule, ecfg: EditConfig, *, num_actual: int,
                    **loop_kw) -> Callable:
    """The shared-source removal compute of C cases of one source image:
    invert the source once (every case's init and reference), then
    `sample_bggen_loop_shared`.  Per-edit UNet cost against
    `bggen_case_fn`: inversion 1/C streams instead of 1, regeneration
    2 + 1/C instead of 3."""

    def fn(lat_ref, text_u, text_pair, states, cg, gates, cfg_masks, var_masks, noise):
        text_u = Cond.of(text_u)
        traj_r = ddim_invert_loop(unet_plain, schedule, lat_ref[None], text_u[None], num_actual)
        return sample_bggen_loop_shared(unet_edit, unet_capture, schedule, ecfg, traj_r[:, 0],
                                        text_pair, text_u[None], states, cg, gates, cfg_masks,
                                        var_masks, noise, **loop_kw)

    return fn


def compose_case_fn(unet_plain: Callable, unet_edit: Callable, schedule: DDIMSchedule,
                    ecfg: EditConfig, *, num_actual: int, **loop_kw) -> Callable:
    """The composition compute of C cases (invert every case's N+1
    streams, then the compose loop), each step one UNet call over all
    cases."""

    def fn(lats, text_inv, text_emb, text_extra, states, cg, gates, cfg_masks, var_masks, noise):
        traj = _invert_cases(unet_plain, schedule, lats, text_inv, num_actual)
        return sample_compose_cases(unet_edit, schedule, ecfg, traj, text_emb, text_extra,
                                    states, cg, gates, cfg_masks, var_masks, noise, **loop_kw)

    return fn


def _stack_states(states: Sequence[EditState]) -> EditState:
    """Per-case states -> one state whose every pyramid entry gains a
    leading case axis."""
    fields = ("fg_retain", "fg_ref", "local_region", "src_masks", "tgt_masks")
    return EditState(**{f: {s: torch.stack([getattr(st, f)[s] for st in states])
                            for s in getattr(states[0], f)} for f in fields})


def _stack_masks_np(masks, h: int, w: int) -> np.ndarray:
    """Host side: raw masks (any dtype, [H, W] or [H, W, C]) -> one
    [N, h, w] float32 stack, nearest-resized where a case is not at the
    pipeline resolution."""
    out = []
    for m in masks:
        a = np.asarray(m)
        if a.ndim == 3:
            a = a[..., 0]
        a = a.astype(np.float32)
        if a.shape != (h, w):
            a = nearest_resize(torch.from_numpy(a), h, w).numpy()
        out.append(a)
    return np.stack(out)


def edit_mask_states(cfg: PipelineConfig, device, cases, use_auto_draw: bool,
                     reduce_inp_artifacts: bool):
    """The batched edit lanes' mask prep, `prepare_various_mask` per case
    (host-side loop): the case-stacked EditState and the completion-CFG and
    local-variance masks [C, lh, lw]."""
    h, w, lh, lw = cfg.height, cfg.width, cfg.latent_height, cfg.latent_width

    def t(x):
        return None if x is None else torch.as_tensor(x, device=device)

    tgt = _stack_masks_np([c["target_mask"] for c in cases], h, w)
    ori = _stack_masks_np([c["ori_mask"] for c in cases], h, w)
    draws = [c.get("draw_mask") for c in cases]
    has_draw = any(d is not None for d in draws)
    if has_draw and not all(d is not None for d in draws):
        raise ValueError("cannot batch cases with and without draw_mask together")
    cons = _stack_masks_np([c.get("cons_area", np.zeros((h, w), np.float32)) for c in cases],
                           h, w)
    draw = _stack_masks_np(draws, h, w) if has_draw else [None] * len(cases)
    states, cfg_masks, var_masks = [], [], []
    for i in range(len(cases)):
        em = mask_ops.prepare_various_mask(
            t(tgt[i]), t(ori[i]), t(draw[i]), h, w, lh, lw, use_auto_draw=use_auto_draw,
            cons_area=t(cons[i]), reduce_inp_artifacts=reduce_inp_artifacts,
        )
        states.append(EditState(fg_retain=build_mask_pyramid(em.fg_retain, lh, lw),
                                fg_ref=build_mask_pyramid(em.fg_ref, lh, lw),
                                local_region=build_mask_pyramid(em.fg_retain, lh, lw)))
        cfg_masks.append(em.completion_cfg)
        var_masks.append(em.local_var)
    return _stack_states(states), torch.stack(cfg_masks), torch.stack(var_masks)


def bggen_mask_states(cfg: PipelineConfig, device, cases):
    """The batched removal lanes' mask prep, `prepare_mask_bggen` per case:
    the case-stacked EditState and the local masks [C, lh, lw]."""
    lh, lw = cfg.latent_height, cfg.latent_width
    masks = _stack_masks_np([c["ori_mask"] for c in cases], cfg.height, cfg.width)
    states, lvars = [], []
    for m in masks:
        full, lv = mask_ops.prepare_mask_bggen(torch.as_tensor(m, device=device), cfg.height,
                                               cfg.width, lh, lw)
        pyr = build_mask_pyramid(full, lh, lw)
        states.append(EditState(fg_retain=pyr, fg_ref=pyr, local_region=pyr))
        lvars.append(lv)
    return _stack_states(states), torch.stack(lvars)


def _case_rngs(seed, n: int, device) -> list:
    """Per-case generators of the batched lanes.  A sequence of seeds gives
    case i `torch.Generator(device).manual_seed(seed[i])`, the generator the
    single-edit entry points seed with `seed=seed[i]`, so a case's draws,
    and its output, are the same alone or in any batch.  A scalar seed
    gives case i the seed of the i-th of n integers in [0, 2^63 - 1) drawn
    by `torch.randint` from a CPU generator seeded with it."""
    if isinstance(seed, (list, tuple, np.ndarray)):
        if len(seed) != n:
            raise ValueError(f"{len(seed)} seeds for {n} cases")
        seeds = [int(s) for s in seed]
    else:
        seeds = torch.randint(2**63 - 1, (n,), generator=torch.Generator().manual_seed(int(seed)))
        seeds = seeds.tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


def _one_source(cases, name: str) -> np.ndarray:
    """The ori_img every case of a shared-source batch shares; raises on a
    mixed-source batch."""
    ori0 = np.asarray(cases[0]["ori_img"])
    for c in cases[1:]:
        if not np.array_equal(np.asarray(c["ori_img"]), ori0):
            raise ValueError(f"{name} requires every case to share one ori_img; use the "
                             "per-case lane for mixed-source batches")
    return ori0


def _shared_method(method_type: str) -> None:
    if method_type not in ("tca", "mmsa", "mmsa_es"):
        raise ValueError("the shared-source lanes support the tca/mmsa methods (the GeoBench "
                         f"protocol); got {method_type}")


class BatchedFreeFine:
    """Multi-case batched editing on top of a `FreeFine` pipeline.

    Runs C independent GeoBench-style cases per denoise step: each step is
    one UNet call over every case's streams (C * 3 in the per-case lanes,
    C * 2 plus one batch-1 capture pass in the shared-source lanes), which
    amortises the launch overheads.  The VAE encode, the text encode and
    the decode are one call per batch; the mask prep loops over the cases
    on the host side of the device path.

    Noise: `seed` a sequence gives case i the generator of
    `FreeFine.generation(seed=seed[i])`; a scalar derives one generator per
    case (`_case_rngs`).  `noise=` replaces the draws with a per-case list
    of K per-step tensors ([2, lh, lw, 4]; composition [1, lh, lw, 4]).

    Pass a `freefine_tpu_torch.utils.profiling.StageTimer` as `timer=` to
    time the stages (prep_images, vae_encode, text_encode, mask_prep, edit,
    decode); each stage then ends with a device synchronise on CUDA.
    """

    def __init__(self, pipe: FreeFine):
        self.pipe = pipe

    @contextlib.contextmanager
    def _stage(self, timer, name: str):
        if timer is None:
            yield
            return
        with timer.stage(name):
            yield
            if self.pipe.device.type == "cuda":
                torch.cuda.synchronize(self.pipe.device)

    def _uncond_and_conds(self, texts):
        """One text-encode call for [""] + the per-case prompts: the ""
        `Cond` row and the prompts' [C, ...]."""
        embs = self.pipe._batch_text_embeddings([""] + list(texts))
        return embs[0], embs[1:]

    def _noise(self, seed, noise, n: int) -> list:
        if noise is None:
            return _case_rngs(seed, n, self.pipe.device)
        if len(noise) != n:
            raise ValueError(f"noise for {len(noise)} cases, {n} cases given")
        return list(noise)

    def _edit_config(self, **kw) -> EditConfig:
        return EditConfig(layer_range=self.pipe._layer_range, **kw)

    def generation(
        self,
        cases,  # dicts with ori_img / ori_mask / coarse_input / target_mask /
                # guidance_text (+ optional draw_mask / cons_area)
        guidance_scale: float = 7.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 25,
        method_type: str = "tca",
        local_text_edit: bool = True,
        local_perturbation: bool = True,
        use_auto_draw: bool = True,
        reduce_inp_artifacts: bool = True,
        end_scale: float = 0.5,
        seed=42,
        timer=None,
        noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    ):
        """`FreeFine.generation` of C cases, per step one UNet call over
        the C * 3 streams.  Returns the C edited uint8 images."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        pipe = self.pipe
        n = len(cases)
        with self._stage(timer, "prep_images"):
            coarse = np.stack([pipe._prep_image(c["coarse_input"]) for c in cases])
            ori = np.stack([pipe._prep_image(c["ori_img"]) for c in cases])
        with self._stage(timer, "vae_encode"):
            lats = pipe.image_to_latent(np.concatenate([coarse, ori]))
            lat2 = torch.stack([lats[:n], lats[n:]], dim=1)          # [C, 2, lh, lw, 4]
        with self._stage(timer, "text_encode"):
            uncond, conds = self._uncond_and_conds([c["guidance_text"] for c in cases])
            u = uncond.expand(n)
            text2 = Cond.stack([u, u], 1)                            # inversion [C, 2, ...]
            text3 = Cond.stack([u, u, conds], 1)                     # deduped CFG [C, 3, ...]
        with self._stage(timer, "mask_prep"):
            states, cfg_masks, var_masks = edit_mask_states(
                pipe.config, pipe.device, cases, use_auto_draw, reduce_inp_artifacts)
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = self._edit_config(mode="edit", method=method, local_cfg=local_text_edit)
        fn = edit_case_fn(
            pipe.unet_apply, pipe.unet_apply, pipe._schedule(num_step), ecfg,
            num_actual=num_step - start_step, start_step=start_step,
            guidance_scale=guidance_scale, eta=eta, local_text_edit=local_text_edit,
            local_perturbation=local_perturbation,
        )
        with self._stage(timer, "edit"):
            out = fn(lat2, text2, text3, states, cg, gates, cfg_masks, var_masks,
                     self._noise(seed, noise, n))
        with self._stage(timer, "decode"):
            imgs = pipe.latent_to_image(out[:, 0])
        return list(imgs)

    def generation_shared_source(
        self,
        cases,  # as `generation`, ALL sharing one ori_img
        guidance_scale: float = 7.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 25,
        method_type: str = "tca",
        local_text_edit: bool = True,
        local_perturbation: bool = True,
        use_auto_draw: bool = True,
        reduce_inp_artifacts: bool = True,
        end_scale: float = 0.5,
        seed=42,
        timer=None,
        noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    ):
        """`generation` for C cases that edit the same source image, sharing
        one reference stream: the source is inverted once, and its per-step
        K/V are captured once and broadcast, cutting per-edit UNet work
        from 2 + 3 to (1 + 1/C) + (2 + 1/C) stream-passes.

        The capture pass runs the reference stream vanilla, so this lane
        has the intent (`EditConfig.ref_vanilla`) semantics: it equals
        `generation` run with ref_vanilla=True case by case, and differs
        from the default lane on the reference stream's even heads.  Use
        `generation` for mixed sources or strict reference parity."""
        _shared_method(method_type)
        ori0 = _one_source(cases, "generation_shared_source")
        pipe = self.pipe
        n = len(cases)
        with self._stage(timer, "prep_images"):
            coarse = np.stack([pipe._prep_image(c["coarse_input"]) for c in cases])
            ori = pipe._prep_image(ori0)
        with self._stage(timer, "vae_encode"):
            lats = pipe.image_to_latent(np.concatenate([coarse, ori[None]]))
            lat_coarse, lat_ref = lats[:n], lats[n]
        with self._stage(timer, "text_encode"):
            uncond, conds = self._uncond_and_conds([c["guidance_text"] for c in cases])
            text_pair = Cond.stack([uncond.expand(n), conds], 1)
        with self._stage(timer, "mask_prep"):
            states, cfg_masks, var_masks = edit_mask_states(
                pipe.config, pipe.device, cases, use_auto_draw, reduce_inp_artifacts)
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = self._edit_config(mode="edit", method=method, local_cfg=local_text_edit,
                                 shared_ref=True, ref_vanilla=True)
        fn = edit_shared_fn(
            pipe.unet_apply, pipe.unet_apply, pipe.make_unet_capture(ecfg),
            pipe._schedule(num_step), ecfg, num_actual=num_step - start_step,
            start_step=start_step, guidance_scale=guidance_scale, eta=eta,
            local_text_edit=local_text_edit, local_perturbation=local_perturbation,
        )
        with self._stage(timer, "edit"):
            out = fn(lat_coarse, lat_ref, uncond, text_pair, states, cg, gates, cfg_masks,
                     var_masks, self._noise(seed, noise, n))
        with self._stage(timer, "decode"):
            imgs = pipe.latent_to_image(out)
        return list(imgs)

    def background_generation(
        self,
        cases,  # dicts with ori_img / ori_mask / guidance_text
        guidance_scale: float = 3.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 1,
        method_type: str = "tca",
        local_text_edit: bool = True,
        local_perturbation: bool = True,
        end_scale: float = 0.5,
        seed=42,
        timer=None,
        noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    ):
        """`FreeFine.background_generation` of C cases, per step one UNet
        call over the C * 3 streams."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        pipe = self.pipe
        n = len(cases)
        with self._stage(timer, "prep_images"):
            ori = np.stack([pipe._prep_image(c["ori_img"]) for c in cases])
        with self._stage(timer, "vae_encode"):
            lat1 = pipe.image_to_latent(ori)[:, None]                # [C, 1, lh, lw, 4]
        with self._stage(timer, "text_encode"):
            uncond, conds = self._uncond_and_conds([c["guidance_text"] for c in cases])
            u = uncond.expand(n)
            text1 = u[:, None]
            text3 = Cond.stack([u, u, conds], 1)
        with self._stage(timer, "mask_prep"):
            states, lvars = bggen_mask_states(pipe.config, pipe.device, cases)
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = self._edit_config(mode="bggen", method=method, local_cfg=local_text_edit)
        fn = bggen_case_fn(
            pipe.unet_apply, pipe.unet_apply, pipe._schedule(num_step), ecfg,
            num_actual=num_step - start_step, start_step=start_step,
            guidance_scale=guidance_scale, eta=eta, local_text_edit=local_text_edit,
            local_perturbation=local_perturbation,
        )
        with self._stage(timer, "edit"):
            out = fn(lat1, text1, text3, states, cg, gates, lvars, lvars,
                     self._noise(seed, noise, n))
        with self._stage(timer, "decode"):
            imgs = pipe.latent_to_image(out[:, 0])
        return list(imgs)

    def background_generation_shared_source(
        self,
        cases,  # dicts with ori_img / ori_mask / guidance_text, ALL one ori_img
        guidance_scale: float = 3.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 1,
        method_type: str = "tca",
        local_text_edit: bool = True,
        local_perturbation: bool = True,
        end_scale: float = 0.5,
        seed=42,
        timer=None,
        noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    ):
        """`background_generation` for removal cases on the same source
        image: the source is encoded and inverted once (every case's init
        and per-step reference), and the reference runs once per step as a
        shared capture pass.  Per-case UNet work drops from 1 + 3 to
        2 + 2/C stream-passes.  ref_vanilla semantics, as
        `generation_shared_source`."""
        _shared_method(method_type)
        ori0 = _one_source(cases, "background_generation_shared_source")
        pipe = self.pipe
        n = len(cases)
        with self._stage(timer, "prep_images"):
            ori = pipe._prep_image(ori0)
        with self._stage(timer, "vae_encode"):
            lat_ref = pipe.image_to_latent(ori[None])[0]
        with self._stage(timer, "text_encode"):
            uncond, conds = self._uncond_and_conds([c["guidance_text"] for c in cases])
            text_pair = Cond.stack([uncond.expand(n), conds], 1)
        with self._stage(timer, "mask_prep"):
            states, lvars = bggen_mask_states(pipe.config, pipe.device, cases)
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = self._edit_config(mode="bggen", method=method, local_cfg=local_text_edit,
                                 shared_ref=True, ref_vanilla=True)
        fn = bggen_shared_fn(
            pipe.unet_apply, pipe.unet_apply, pipe.make_unet_capture(ecfg),
            pipe._schedule(num_step), ecfg, num_actual=num_step - start_step,
            start_step=start_step, guidance_scale=guidance_scale, eta=eta,
            local_text_edit=local_text_edit, local_perturbation=local_perturbation,
        )
        with self._stage(timer, "edit"):
            out = fn(lat_ref, uncond, text_pair, states, cg, gates, lvars, lvars,
                     self._noise(seed, noise, n))
        with self._stage(timer, "decode"):
            imgs = pipe.latent_to_image(out)
        return list(imgs)

    def cross_image_composition(
        self,
        cases,  # dicts with img_lists / ori_mask_lists / tgt_mask_lists /
                # coarse_input / guidance_text_list; one source count and one
                # prompt count for all
        guidance_scale: float = 7.5,
        eta: float = 1.0,
        end_step: int = 10,
        num_step: int = 50,
        start_step: int = 25,
        method_type: str = "tca",
        local_text_edit: bool = True,
        local_perturbation: bool = True,
        end_scale: float = 0.5,
        dil_completion: bool = False,
        dil_factor: int = 15,
        appearance_transfer: bool = False,
        seed=42,
        timer=None,
        noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
    ):
        """`FreeFine.cross_image_composition` of C cases, per step one UNet
        call over the C * (N + 2) streams."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        pipe = self.pipe
        cfg = pipe.config
        h, w, lh, lw = cfg.height, cfg.width, cfg.latent_height, cfg.latent_width
        n = len(cases)
        ns = len(cases[0]["img_lists"])
        n_prompts = len(cases[0]["guidance_text_list"])
        if any(len(c["img_lists"]) != ns or len(c["guidance_text_list"]) != n_prompts
               for c in cases):
            raise ValueError("batched composition cases must share the source and prompt counts")
        with self._stage(timer, "prep_images"):
            imgs = np.stack([pipe._prep_image(im) for c in cases
                             for im in [c["coarse_input"], *c["img_lists"]]])
        with self._stage(timer, "vae_encode"):
            lats = pipe.image_to_latent(imgs).reshape(n, ns + 1, lh, lw, 4)
        with self._stage(timer, "text_encode"):
            uncond, conds = self._uncond_and_conds(
                [p for c in cases for p in c["guidance_text_list"]])
            conds = conds.reshape(n, n_prompts)
            u = uncond.expand(n, 1)
            # per-stream context [uncond, prompt_1..prompt_N (padded with uncond), uncond]
            pad = u.expand(n, max(ns - n_prompts, 0))
            text_emb = Cond.cat([u, conds[:, :ns], pad, u], 1)       # [C, N+2, ...]
            text_extra = Cond.cat([conds, u], 1).ctx                 # [C, P, L, D]
            text_inv = u.expand(n, ns + 1)
        with self._stage(timer, "mask_prep"):
            def masks(ms):
                return [torch.as_tensor(m, device=pipe.device) for m in _stack_masks_np(ms, h, w)]

            states, cfg_masks, var_masks = [], [], []
            for c in cases:
                cm = mask_ops.prepare_composition_masks(
                    masks(c["ori_mask_lists"]), masks(c["tgt_mask_lists"]),
                    h, w, lh, lw, dil_completion=dil_completion, dil_factor=dil_factor,
                    appearance_transfer=appearance_transfer,
                )
                if cm.tgt_masks.shape[0] < n_prompts + 1:
                    raise ValueError(f"{n_prompts + 1} region prompts vs "
                                     f"{cm.tgt_masks.shape[0]} target regions")
                states.append(EditState(src_masks=build_mask_stack_pyramid(cm.src_masks, lh, lw),
                                        tgt_masks=build_mask_stack_pyramid(cm.tgt_masks, lh, lw)))
                cfg_masks.append(cm.completion_cfg)
                var_masks.append(cm.local_var)
            states = _stack_states(states)
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = self._edit_config(mode="compose", method=method, local_cfg=local_text_edit,
                                 num_sources=ns, prompt_length=n_prompts + 1)
        fn = compose_case_fn(
            pipe.unet_apply, pipe.unet_apply, pipe._schedule(num_step), ecfg,
            num_actual=num_step - start_step, start_step=start_step,
            guidance_scale=guidance_scale, eta=eta, local_text_edit=local_text_edit,
            local_perturbation=local_perturbation,
        )
        with self._stage(timer, "edit"):
            out = fn(lats, text_inv, text_emb, text_extra, states, cg, gates,
                     torch.stack(cfg_masks), torch.stack(var_masks), self._noise(seed, noise, n))
        with self._stage(timer, "decode"):
            imgs = pipe.latent_to_image(out[:, 0])
        return list(imgs)
