"""FreeFine editing pipeline in PyTorch (mirrors `freefine_tpu.pipeline`
for `FreeFine.generation`, the energy-guided `FreeFine.guided_generation`,
object removal `FreeFine.background_generation` and multi-image
`FreeFine.cross_image_composition`).

The JAX package compiles each loop into one `lax.scan`; here the loops are
plain Python over eager PyTorch modules.  Public functions keep the JAX
layouts: `generation` takes and returns NHWC uint8 images, the latent
functions take and return NHWC float32 latents.

Noise: every sampling loop draws one standard-normal tensor per step from
a `torch.Generator` seeded by `seed`, or takes an explicit per-step noise
sequence (the tests replay JAX's `split` -> `normal` chain through it).

The pipeline is inference only: its parameters never require grad.  The
one gradient it takes, energy guidance, is with respect to the latent.

The pipeline runs on CUDA unless the caller passes `device="cpu"`; asking
for CUDA on a machine without it raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from freefine_tpu_torch import masks as mask_ops
from freefine_tpu_torch.config import PipelineConfig, sd15_pipeline_config
from freefine_tpu_torch.edit import (
    DEFAULT_LAYER_RANGE,
    EditConfig,
    EditState,
    build_mask_pyramid,
    build_mask_stack_pyramid,
    nearest_resize,
)
from freefine_tpu_torch.models.text_encoder import CLIPTextEncoder
from freefine_tpu_torch.models.tokenizer import load_tokenizer
from freefine_tpu_torch.models.unet import UNet2DCondition
from freefine_tpu_torch.models.vae import AutoencoderKL, from_uint8, to_uint8
from freefine_tpu_torch.ops.guidance import energy_guidance
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, ctrl_step, inv_step, method_and_gates
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
    text_emb: torch.Tensor, num_actual: int,
) -> torch.Tensor:
    """DDIM inversion (guidance 1.0).  latents [B, h, w, c] -> trajectory
    [num_actual+1, B, h, w, c]: [0] the clean latent, [-1] the most noised."""
    ts = schedule.timesteps[::-1][:num_actual]
    traj = [latents]
    lat = latents
    for t in ts:
        eps = unet_apply(lat, int(t), text_emb)
        lat, _ = inv_step(schedule, eps, int(t), lat)
        traj.append(lat)
    return torch.stack(traj)


def _cfg_model_in(lat: torch.Tensor, nstr: int) -> torch.Tensor:
    """UNet input from the per-stream latents: deduped layout appends the
    edit latent as the conditional row ([u_e, r] -> [u_e, r, c_e]); the
    legacy layout doubles every row."""
    if nstr == lat.shape[0] + 1:
        return torch.cat([lat, lat[:1]], dim=0)
    return torch.cat([lat, lat], dim=0)


def _cfg_split(eps: torch.Tensor, nstr: int):
    """(uncond, cond) stream pairs: deduped nu = [u_e, r], nc = [c_e, r]."""
    eps = eps.float()
    if nstr == 3:
        return eps[:2], torch.cat([eps[2:3], eps[1:2]], dim=0)
    return eps.chunk(2, dim=0)


@torch.no_grad()
def sample_edit_loop(
    unet_apply: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    traj: torch.Tensor,            # [K+1, 2, h, w, c] inversion trajectory
    text_emb: torch.Tensor,        # [3, 77, D] [u, u_ref, edit] (or legacy [4])
    state: EditState,
    cg: np.ndarray,                # [K] context guidance schedule
    gates: np.ndarray,             # [K] share gates
    completion_cfg: torch.Tensor,  # [lh, lw] local CFG multiplier
    local_var: torch.Tensor,       # [lh, lw] DDPM region
    noise: NoiseSource,
    *,
    start_step: int,
    guidance_scale: float,
    eta: float,
    local_text_edit: bool,
    local_perturbation: bool,
) -> torch.Tensor:
    """Geometric-edit regeneration (reference forward_sampling): per step
    the reference stream is pinned to its inversion latent, the UNet runs
    on [u_e, r, c_e], local CFG combines the streams and the hybrid
    `ctrl_step` steps.  Returns the final 2-stream latents [2, h, w, c]."""
    k = traj.shape[0] - 1
    nstr = text_emb.shape[0]
    ts = schedule.timesteps[start_step : start_step + k]
    refs = torch.flip(traj[:k], dims=[0])[:, 1:]
    lat = traj[-1].clone()
    cfg_mask = completion_cfg[None, :, :, None]
    var_mask = local_var if local_perturbation else torch.ones_like(local_var)
    for i in range(k):
        t = int(ts[i])
        lat[1:] = refs[i]
        state.context_guidance = float(cg[i])
        state.share_gate = float(gates[i])
        eps = unet_apply(_cfg_model_in(lat, nstr), t, text_emb, ecfg, state)
        nu, nc = _cfg_split(eps, nstr)
        if local_text_edit:
            pred = nu + guidance_scale * (nc - nu) * cfg_mask
        else:
            pred = nu + guidance_scale * (nc - nu)
        lat, _ = ctrl_step(schedule, pred, t, lat, var_mask, eta, _draw(noise, i, lat),
                           ddim_streams_from=1)
    return lat


@torch.no_grad()
def sample_bggen_loop(
    unet_apply: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    traj: torch.Tensor,            # [K+1, 1, h, w, c] inversion trajectory
    text_emb: torch.Tensor,        # [3, 77, D] [u, u_ref, cond] (or legacy [4])
    state: EditState,
    cg: np.ndarray,
    gates: np.ndarray,
    local_cfg: torch.Tensor,       # [lh, lw] local CFG multiplier
    local_var: torch.Tensor,       # [lh, lw] DDPM region
    noise: NoiseSource,
    *,
    start_step: int,
    guidance_scale: float,
    eta: float,
    local_text_edit: bool,
    local_perturbation: bool,
) -> torch.Tensor:
    """Background generation / object removal (reference
    forward_sampling_background_gen): the reference stream at step i is the
    inverted latent at the matching noise level (traj flipped), the UNet
    runs on [u_g, r, c_g], local CFG combines and `ctrl_step` steps the
    2-stream [g, r] stack.  Returns the generated latent [1, h, w, c]."""
    k = traj.shape[0] - 1
    nstr = text_emb.shape[0]
    ts = schedule.timesteps[start_step : start_step + k]
    refs = torch.flip(traj[1:], dims=[0])
    lat = traj[-1]
    cfg_mask = local_cfg[None, :, :, None]
    var_mask = local_var if local_perturbation else torch.ones_like(local_var)
    for i in range(k):
        t = int(ts[i])
        lat2 = torch.cat([lat, refs[i]], dim=0)
        state.context_guidance = float(cg[i])
        state.share_gate = float(gates[i])
        eps = unet_apply(_cfg_model_in(lat2, nstr), t, text_emb, ecfg, state)
        nu, nc = _cfg_split(eps, nstr)
        scale = (nc - nu) * cfg_mask if local_text_edit else nc - nu
        lat2, _ = ctrl_step(schedule, nu + guidance_scale * scale, t, lat2, var_mask, eta,
                            _draw(noise, i, lat2), ddim_streams_from=1)
        lat = lat2[:1]
    return lat


@torch.no_grad()
def sample_compose_loop(
    unet_apply: Callable,
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    traj: torch.Tensor,            # [K+1, N+1, h, w, c] inversion trajectory
    text_emb: torch.Tensor,        # [N+2, 77, D] per-stream context
    text_extra: torch.Tensor,      # [P, 77, D] region prompts of the cond stream
    state: EditState,
    cg: np.ndarray,
    gates: np.ndarray,
    completion_cfg: torch.Tensor,
    local_var: torch.Tensor,
    noise: NoiseSource,
    *,
    start_step: int,
    guidance_scale: float,
    eta: float,
    local_text_edit: bool,
    local_perturbation: bool,
) -> torch.Tensor:
    """N-image composition (reference forward_sampling_compose): per step
    the streams are [e, r_1..r_N, c_e], the sources pinned to their
    inversion latents; CFG combines the first and last stream and
    `ctrl_step` steps the edit latent.  Returns it, [1, h, w, c]."""
    k = traj.shape[0] - 1
    ts = schedule.timesteps[start_step : start_step + k]
    refs = torch.flip(traj[:k], dims=[0])[:, 1:]
    lat = traj[-1][:1]
    cfg_mask = completion_cfg[None, :, :, None]
    var_mask = local_var if local_perturbation else torch.ones_like(local_var)
    for i in range(k):
        t = int(ts[i])
        state.context_guidance = float(cg[i])
        state.share_gate = float(gates[i])
        eps = unet_apply(torch.cat([lat, refs[i], lat], dim=0), t, text_emb, ecfg, state,
                         ctx_extra=text_extra).float()
        nu, nc = eps[:1], eps[-1:]
        scale = (nc - nu) * cfg_mask if local_text_edit else nc - nu
        lat, _ = ctrl_step(schedule, nu + guidance_scale * scale, t, lat, var_mask, eta,
                           _draw(noise, i, lat))
    return lat


def _draw(noise: NoiseSource, i: int, lat: torch.Tensor) -> torch.Tensor:
    """Step i's standard-normal draw shaped like `lat`."""
    if isinstance(noise, torch.Generator):
        return torch.randn(lat.shape, generator=noise, device=lat.device, dtype=torch.float32)
    return noise[i]


def sample_guided_loop(
    unet_apply: Callable,          # FreeFine.unet_apply: edit pass and plain feature taps
    schedule: DDIMSchedule,
    ecfg: EditConfig,
    traj: torch.Tensor,            # [K+1, 2, h, w, c] inversion trajectory
    text_emb: torch.Tensor,        # [3, 77, D] [u, u_ref, edit]
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
    nstr = text_emb.shape[0]
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
            eps = unet_apply(_cfg_model_in(lat, nstr), t, text_emb, ecfg, state)
        nu, nc = _cfg_split(eps, nstr)
        pred = nu + guidance_scale * (nc - nu) * cfg_mask
        if i < energy_until:
            g = energy_guidance(
                unet_apply, lat[:1], refs[i], t, text_emb[2:3], energy_scale=energy_scale,
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


class FreeFine:
    """Training-free geometric image editing, UNet backbone.

    params: {"unet", "vae", "text"} state dicts.  Without them the
    constructor raises, as JAX's does, unless `init_random=True` asks for
    random weights (`weights.random_weights`, seeded by `seed`) for
    weight-free runs (tests, throughput)."""

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
            self.unet = UNet2DCondition(cfg.unet).eval()
            self.vae = AutoencoderKL(cfg.vae).eval()
            self.text_encoder = CLIPTextEncoder(cfg.text).eval()
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
        # fraction of this backbone's depth-weighted layer layout
        lo, hi = DEFAULT_LAYER_RANGE
        total, _ = cfg.unet.attn_layer_layout
        self._layer_range = (round(lo / hi * total), total)

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
                   ctx_extra: Optional[torch.Tensor] = None):
        """NHWC latents -> NHWC noise prediction (model dtype); with
        return_features, (eps, features) with NHWC features (the plain
        UNet's taps that energy guidance reads).  ctx_extra: the compose
        region prompts [P, 77, D]."""
        kw = {} if ecfg is None else dict(edit_cfg=ecfg, edit_state=state)
        out = self.unet(lat.permute(0, 3, 1, 2), t, ctx, return_features=return_features,
                        context_extra=ctx_extra, **kw)
        if return_features:
            eps, feats = out
            return eps.permute(0, 2, 3, 1), [f.permute(0, 2, 3, 1) for f in feats]
        return out.permute(0, 2, 3, 1)

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        ids = torch.as_tensor(self.tokenizer.batch_encode(list(texts)), dtype=torch.long,
                              device=self.device)
        return self.text_encoder(ids)

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

    def invert(self, latents: torch.Tensor, num_step: int, start_step: int) -> torch.Tensor:
        """DDIM-invert for (num_step - start_step) steps; returns the
        trajectory [K+1, B, h, w, c]."""
        emb = self._inversion_text_embeddings(latents.shape[0])
        return ddim_invert_loop(self.unet_apply, self._schedule(num_step), latents, emb,
                                num_step - start_step)

    def _inversion_text_embeddings(self, batch: int) -> torch.Tensor:
        """Per-stream unconditional context for DDIM inversion."""
        return self.encode_text([""]).expand(batch, -1, -1)

    def _stream_text_embeddings(self, texts: Sequence[str]) -> torch.Tensor:
        """Per-stream context of the compose loop (the hook the SDXL
        dual-encoder pipeline overrides in JAX)."""
        return self.encode_text(texts)

    def _extra_text_embeddings(self, texts: Sequence[str]) -> torch.Tensor:
        """Region prompts whose K/V feed compose's local cross-attention."""
        return self.encode_text(texts)

    def _edit_text_embeddings(self, guidance_text: str) -> torch.Tensor:
        """[uncond, uncond_ref, cond_edit]: the deduped 3-stream CFG layout."""
        embs = self.encode_text(["", guidance_text])
        return torch.stack([embs[0], embs[0], embs[1]])

    def _prep_image(self, img: np.ndarray) -> np.ndarray:
        """To [H, W, 3] uint8 at the pipeline resolution."""
        cfg = self.config
        a = np.asarray(img)
        if a.ndim == 2:
            a = np.stack([a] * 3, -1)
        if a.shape[:2] != (cfg.height, cfg.width):
            raise NotImplementedError(
                f"input {a.shape[:2]} is not at the pipeline resolution "
                f"{(cfg.height, cfg.width)}: the lanczos3 resize is not ported yet (ROADMAP A7)"
            )
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
        Returns the edited uint8 image [H, W, 3] (and the reconstructed
        reference image when return_ori).  `noise` optionally replaces the
        seeded per-step draws with K tensors [2, lh, lw, 4]."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        if return_intermediates:
            raise NotImplementedError("return_intermediates is not ported yet (ROADMAP A7)")
        cfg = self.config
        lh, lw = cfg.latent_height, cfg.latent_width
        dev = self.device

        coarse = self._prep_image(coarse_input)
        ori = self._prep_image(ori_img)
        lat2 = self.image_to_latent(np.stack([coarse, ori]))
        traj = self.invert(lat2, num_step, start_step)

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
        text_emb = self._edit_text_embeddings(guidance_text)
        if noise is None:
            noise = torch.Generator(device=dev).manual_seed(seed)
        lat = sample_edit_loop(
            self.unet_apply, self._schedule(num_step), ecfg, traj, text_emb, state, cg, gates,
            em.completion_cfg, em.local_var, noise, start_step=start_step,
            guidance_scale=guidance_scale, eta=eta, local_text_edit=local_text_edit,
            local_perturbation=local_perturbation,
        )
        imgs = self.latent_to_image(lat)
        return (imgs[0], imgs[1]) if return_ori else imgs[0]

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
        [2, lh, lw, 4]."""
        if method_type not in METHOD_TYPES:
            raise ValueError(method_type)
        cfg = self.config
        lh, lw = cfg.latent_height, cfg.latent_width
        dev = self.device

        coarse = self._prep_image(coarse_input)
        ori = self._prep_image(ori_img)
        lat2 = self.image_to_latent(np.stack([coarse, ori]))
        traj = self.invert(lat2, num_step, start_step)

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
        text_emb = self._edit_text_embeddings(guidance_text)
        energy_until = int(round((num_step - start_step) * energy_fraction))
        if noise is None:
            noise = torch.Generator(device=dev).manual_seed(seed)
        lat = sample_guided_loop(
            self.unet_apply, self._schedule(num_step), ecfg, traj, text_emb,
            state, cg, gates, em.completion_cfg, em.local_var, _guided_energy_masks(cfg, em),
            noise, start_step=start_step, guidance_scale=guidance_scale, eta=eta,
            energy_scale=energy_scale, energy_until=energy_until,
        )
        return self.latent_to_image(lat)[0]

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
        traj = self.invert(lat, num_step, start_step)
        mask_full, local_var = mask_ops.prepare_mask_bggen(
            torch.as_tensor(np.asarray(ori_mask), device=dev), cfg.height, cfg.width, lh, lw)
        pyr = build_mask_pyramid(mask_full, lh, lw)
        state = EditState(fg_retain=pyr, fg_ref=pyr, local_region=pyr)
        method, cg, gates = method_and_gates(method_type, start_step, end_step, num_step,
                                             end_scale)
        ecfg = EditConfig(mode="bggen", method=method, local_cfg=local_text_edit,
                          layer_range=self._layer_range)
        text_emb = self._edit_text_embeddings(guidance_text)
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
