"""Self-Guidance baseline core for the PyTorch port (mirrors
`freefine_tpu.baselines.self_guidance`): energies over the UNet's
cross-attention maps (object shape, size, centroid, silhouette) and an
up-block feature tap, whose latent gradient steers the noise prediction:

    eps' = eps + g_weight * (1 - alpha_cumprod[t]) * gate * dLoss/dLatent

Every cross-attention writes its maps of the object's tokens
(`EditConfig.sow_token_attn`, `EditState.token_select`) and the UNet its
tap at up_blocks[-1].resnets[-2] into `EditState.intermediates`; the
gradient is one `torch.autograd.grad` through the UNet (batch 2:
unconditional and conditional), which on the card reaches the flash VJP
kernels (rows 3-5 of PERF.md's kernel table).

The per-step gate (`guidance_gates`) is 0 on some steps; there the port
takes no gradient (JAX takes it and multiplies it by 0) and runs the
conditional pass forward only, so those steps launch the plain attention
kernel, and the gradient steps the forward with logsumexp, dQ and dK/dV.

Noise is an input: `edit(noise=draws)` replays [steps, 2, 1, h, w, 4]
draws (per step the original stream's, then the edit stream's; the tests
replay JAX's); otherwise a `torch.Generator` seeded by `seed` draws them
in that order.

`silhouette_loss` warps maps with `ops.flow.map_coordinates_linear` (JAX's
order-1 `map_coordinates`, zeros outside) on raw pixel coordinates, with
the reference's grid_sample conventions.  Latents are NHWC.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from freefine_tpu_torch.edit import EditConfig, EditState
from freefine_tpu_torch.ops.flow import map_coordinates_linear
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, _f32, inv_step
from freefine_tpu_torch.utils.profiling import NoStepTimer

# ---------------------------------------------------------------------------
# Energy primitives
# ---------------------------------------------------------------------------


def normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - min) / (max - min) over the whole tensor."""
    lo, hi = x.amin(), x.amax()
    return (x - lo) / (hi - lo + 1e-12)


def threshold_attention(attn: torch.Tensor, s: float = 10.0) -> torch.Tensor:
    """Soft binarisation of an attention map."""
    return normalize(torch.sigmoid(s * (normalize(attn) - 0.5)))


def get_shape(attn: torch.Tensor, s: float = 20.0) -> torch.Tensor:
    return threshold_attention(attn, s)


def get_size(attn: torch.Tensor) -> torch.Tensor:
    """Normalised object area."""
    return threshold_attention(attn).sum((1, 2)).mean() / attn.shape[-2]


def get_centroid(attn: torch.Tensor) -> torch.Tensor:
    """Attention-weighted centroid [x, y] per token."""
    if attn.ndim == 2:
        attn = attn[:, :, None]
    h = w = int(math.isqrt(attn.shape[-2]))
    a = attn.mean(0).reshape(h, w, attn.shape[-1])
    hs = torch.arange(h, dtype=torch.float32, device=a.device)[:, None, None]
    ws = torch.arange(w, dtype=torch.float32, device=a.device)[None, :, None]
    weighted_w = torch.sum(ws * a, dim=(0, 1))
    weighted_h = torch.sum(hs * a, dim=(0, 1))
    return torch.stack([weighted_w, weighted_h]) / (a.sum((0, 1)) + 1e-12)


def attn_diff_norm(a: torch.Tensor, hard: bool = False, thresh: float = 0.5,
                   token_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Min/max normalise and soft binarise [n, h, w, k] token-map stacks,
    the reference's way: over dims (width, token), so each row of each map
    is normalised jointly across the object's tokens.  `token_valid` [k]
    keeps padded token rows out of the statistics and zeroes them."""
    if token_valid is None:
        v = torch.ones(1, 1, 1, a.shape[-1], dtype=torch.bool, device=a.device)
    else:
        v = token_valid.reshape(1, 1, 1, -1).bool()
    big = 3.0e38

    def mn(x):
        return torch.where(v, x, torch.full_like(x, big)).amin((2, 3), keepdim=True)

    def mx(x):
        return torch.where(v, x, torch.full_like(x, -big)).amax((2, 3), keepdim=True)

    lo, hi = mn(a), mx(a)
    t = (a - lo) / (hi - lo + 1e-4)
    if hard:
        return (t > thresh).float() * v
    b = torch.sigmoid((t - thresh) * 10.0)
    lo, hi = mn(b), mx(b)
    return torch.where(v, (b - lo) / (hi - lo + 1e-4), torch.zeros_like(b))


def soft_centroid(a: torch.Tensor) -> torch.Tensor:
    """[n, h, w, k] -> [n, k, 2] normalised (x, y) centroids."""
    n, h, w, k = a.shape
    xs = torch.arange(w, dtype=torch.float32, device=a.device) / max(w - 1, 1)
    ys = torch.arange(h, dtype=torch.float32, device=a.device) / max(h - 1, 1)
    ax = a.sum(1)
    ay = a.sum(2)

    def f(attn, lin):
        attn = attn / (attn.sum(-2, keepdim=True) + 1e-4)
        return (lin[None, :, None] * attn).sum(-2)

    return torch.stack([f(ax, xs), f(ay, ys)], -1)


def fix_appearances_by_feature(ori_feats: torch.Tensor, edit_feats: torch.Tensor) -> torch.Tensor:
    """The feature tap's MSE appearance term."""
    return torch.mean((ori_feats.float() - edit_feats.float()) ** 2)


def fix_shapes_l1(orig_maps, edit_maps, tau: float = 1.0) -> torch.Tensor:
    """Mean soft-shape delta over map lists ([n, S, T] token maps)."""
    return torch.stack([(tau * get_shape(o) - get_shape(e)).mean()
                        for o, e in zip(orig_maps, edit_maps)]).mean()


def fix_sizes(orig_maps, edit_maps, tau: float = 1.0) -> torch.Tensor:
    """Relative-size energy."""
    return torch.stack([tau * get_size(o) - get_size(e)
                        for o, e in zip(orig_maps, edit_maps)]).mean()


def position_deltas(orig_maps, edit_maps, target_centroid: Optional[torch.Tensor] = None):
    """Centroid-move energy."""
    out = []
    for o, e in zip(orig_maps, edit_maps):
        tgt = get_centroid(o) if target_centroid is None else target_centroid
        out.append((tgt - get_centroid(e)).mean())
    return torch.stack(out).mean()


def _warp_maps(maps: torch.Tensor, ref_maps: torch.Tensor, rot: float, sy: float, sx: float,
               dy: float, dx: float) -> torch.Tensor:
    """`maps` [n, h, w, k] sampled at coordinates rotated, scaled and
    shifted about the reference maps' centroids, with the reference's
    grid_sample conventions (coordinates normalised with align_corners
    True, sampled with False: position x * W / (W - 1) - 0.5) and zeros
    outside."""
    n, h, w, k = maps.shape
    dev = maps.device
    c = soft_centroid(ref_maps)[:, 0, :]
    ch = c[:, 1, None, None] * h
    cw = c[:, 0, None, None] * w
    hh, ww = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    hh = hh[None] - ch
    ww = ww[None] - cw
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    rot, sy, sx, dy, dx = (f32(x) for x in (rot, sy, sx, dy, dx))
    th = rot * (math.pi / 180.0)
    w_r = torch.cos(th) * ww + torch.sin(th) * hh
    h_r = -torch.sin(th) * ww + torch.cos(th) * hh
    h_r = h_r / sy - dy * h * sy + ch
    w_r = w_r / sx - dx * w * sx + cw
    h_r = h_r * (h / (h - 1)) - 0.5
    w_r = w_r * (w / (w - 1)) - 0.5
    flat = maps.permute(0, 3, 1, 2).reshape(n * k, h, w)
    yy = h_r[:, None].expand(n, k, h, w).reshape(n * k, h, w)
    xx = w_r[:, None].expand(n, k, h, w).reshape(n * k, h, w)
    out = map_coordinates_linear(flat, yy, xx, "constant")
    return out.reshape(n, k, h, w).permute(0, 2, 3, 1)


def silhouette_loss(edit_up_maps: Sequence[torch.Tensor], ref_up_maps: Sequence[torch.Tensor],
                    ori_feats: torch.Tensor, edit_feats: torch.Tensor, appearance_weight: float,
                    rot: float = 0.0, sy: float = 1.0, sx: float = 1.0, dy: float = 0.0,
                    dx: float = 0.0, l2: bool = False,
                    token_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GeoBench's silhouette guidance: the edit stream's up-block object
    maps, warped by the requested transform about the reference maps'
    centroid, pulled toward the reference maps, plus the feature-appearance
    term per map pair.  `token_valid` [k] keeps padded token rows out of
    the statistics and the mean."""
    loss = torch.zeros((), device=ori_feats.device)
    for e_map, r_map in zip(edit_up_maps, ref_up_maps):
        n, s, k = e_map.shape
        h = w = int(math.isqrt(s))
        tgt = attn_diff_norm(e_map.reshape(n, h, w, k), token_valid=token_valid)
        ref = attn_diff_norm(r_map.reshape(n, h, w, k), token_valid=token_valid)
        warped = _warp_maps(tgt, ref, rot, sy, sx, dy, dx)
        diff = 0.5 * (ref - warped) ** 2 if l2 else torch.abs(ref - warped)
        if token_valid is None:
            geo = diff.mean()
        else:
            v = token_valid.reshape(1, 1, 1, -1).float()
            geo = (diff * v).sum() / torch.clamp(n * h * w * token_valid.float().sum(), min=1.0)
        loss = loss + geo + appearance_weight * fix_appearances_by_feature(ori_feats, edit_feats)
    return loss


# ---------------------------------------------------------------------------
# Schedules and steps
# ---------------------------------------------------------------------------


def _ref_transform_gate(rot, sy, sx, dy, dx) -> bool:
    """The reference's has-transform check, dy and dx compared against 1:
    True for every GeoBench edit, identity included."""
    return rot != 0 or any(v != 1.0 for v in (sy, sx, dy, dx))


def guidance_gates(num_steps: int, scheduler: str = "ddpm") -> np.ndarray:
    """0/1 per-step guidance gates: every step early, alternate steps in
    the middle, none at the end."""
    t = num_steps
    i = np.arange(t)
    early = i <= ((5 * t) // 16 if scheduler == "ddpm" else (3 * t) // 16)
    late = i >= t - t // 32
    alt = (i % 2) == 0
    return np.where(late, 0, np.where(early, 1, alt)).astype(np.float32)


def ddpm_step(schedule: DDIMSchedule, eps: torch.Tensor, t: int, x: torch.Tensor,
              noise: torch.Tensor) -> torch.Tensor:
    """DDPM ancestral step over the subsampled grid (clip_sample off), the
    Gaussian `noise` added where t - delta >= 0."""
    one = np.float32(1.0)
    x32 = x.float()
    eps = eps.float()
    a_t = schedule.alpha_at(t)
    a_p = schedule.alpha_at(t - schedule.step_delta)
    alpha_cur = a_t / a_p
    beta_cur = one - alpha_cur
    x0 = (x32 - _f32(np.sqrt(one - a_t)) * eps) / _f32(np.sqrt(a_t))
    coef_x0 = np.sqrt(a_p) * beta_cur / (one - a_t)
    coef_xt = np.sqrt(alpha_cur) * (one - a_p) / (one - a_t)
    mean = _f32(coef_x0) * x0 + _f32(coef_xt) * x32
    var = max((one - a_p) / (one - a_t) * beta_cur, np.float32(1e-20))
    has_noise = np.float32(1.0 if t - schedule.step_delta >= 0 else 0.0)
    return (mean + _f32(has_noise * np.sqrt(var)) * noise.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class SelfGuidance:
    """Self-guided editing over a `FreeFine` pipe's SD backbone, on the
    pipe's device.  GeoBench's protocol: a CFG-1.5 DDIM inversion of the
    source, the object's maps at the deepest noise level as the silhouette
    reference, then a DDPM denoise from the inverted latent with silhouette
    guidance by the edit's transform on the gated steps."""

    def __init__(self, pipe, max_obj_tokens: int = 8):
        self.pipe = pipe
        self.max_obj_tokens = max_obj_tokens

    def token_select(self, prompt: str, obj: str) -> np.ndarray:
        """One-hot [T_sel, L] rows at the object's token positions in the
        prompt; zero rows pad to T_sel."""
        tok = self.pipe.tokenizer
        prompt_ids = np.asarray(tok.batch_encode([prompt])[0])
        obj_ids = [i for i in np.asarray(tok.batch_encode([obj])[0]) if i not in (tok.bos, tok.eos)]
        sel = np.zeros((self.max_obj_tokens, len(prompt_ids)), np.float32)
        r = 0
        for o in obj_ids:
            for pos in np.where(prompt_ids == o)[0]:
                if r < self.max_obj_tokens:
                    sel[r, pos] = 1.0
                    r += 1
        return sel

    @staticmethod
    def sow_config() -> EditConfig:
        return EditConfig(mode="none", method=None, local_cfg=False, sow_token_attn=True)

    def apply_sow(self, lat2: torch.Tensor, t: int, ctx2, select: torch.Tensor):
        """One CFG UNet pass with the maps and the feature tap recorded ->
        (eps2, the up blocks' token maps [H, S, T] of the conditional half,
        the tap's conditional half)."""
        state = EditState(token_select=select, intermediates={})
        eps2 = self.pipe.unet_apply(lat2, t, ctx2, self.sow_config(), state)
        up_maps = [m[m.shape[0] // 2:] for key, vals in state.intermediates.items()
                   if key[-1] == "token_attn_up" for m in vals]
        feat = state.intermediates[("guidance_feature",)][0][1:]
        return eps2, up_maps, feat

    def _invert(self, schedule: DDIMSchedule, latent, ctx2, guidance_scale: float):
        """CFG DDIM inversion over every step."""
        x = latent
        for t in schedule.timesteps[::-1]:
            eps2 = self.pipe.unet_apply(torch.cat([x, x], dim=0), int(t), ctx2)
            u, c = eps2[:1], eps2[1:]
            eps = u.float() + guidance_scale * (c - u).float()
            x, _ = inv_step(schedule, eps, int(t), x)
        return x

    def _guided_loop(self, schedule, latent, ctx2, select, ref_maps, gates, transform, draw,
                     guided: bool, guidance_scale: float, g_weight: float,
                     appearance_weight: float, timer):
        """The DDPM denoise of the original and the guided edit stream."""
        token_valid = select.sum(-1) > 0
        edit_lat = ori_lat = latent

        def eps_cfg(eps2):
            u, c = eps2[:1], eps2[1:]
            return u + guidance_scale * (c - u)

        for i, t in enumerate(schedule.timesteps):
            t = int(t)
            with torch.no_grad():
                eps_o2, _, ori_feats = self.apply_sow(torch.cat([ori_lat, ori_lat]), t, ctx2,
                                                      select)
                ori_next = ddpm_step(schedule, eps_cfg(eps_o2), t, ori_lat, draw(i, 0))
            if guided and gates[i] > 0:
                lat = edit_lat.detach().requires_grad_()
                with torch.enable_grad():
                    timer.begin()
                    eps2, up_maps, feats = self.apply_sow(torch.cat([lat, lat]), t, ctx2, select)
                    loss = silhouette_loss(up_maps, ref_maps, ori_feats, feats,
                                           appearance_weight, *transform,
                                           token_valid=token_valid)
                    timer.mark("forward")
                    grad, = torch.autograd.grad(loss, lat)
                    timer.mark("end")
                coef = np.float32(g_weight) * (np.float32(1.0) - schedule.alpha_at(t)) \
                    * np.float32(gates[i])
                eps_e = eps_cfg(eps2.detach()).float() + _f32(coef) * grad.float()
            else:
                with torch.no_grad():
                    eps_e = eps_cfg(self.pipe.unet_apply(torch.cat([edit_lat, edit_lat]), t,
                                                         ctx2))
            with torch.no_grad():
                edit_lat = ddpm_step(schedule, eps_e, t, edit_lat, draw(i, 1))
            ori_lat = ori_next
        return edit_lat, ori_lat

    @torch.no_grad()
    def edit(
        self,
        ori_image: np.ndarray,
        prompt: str,
        obj: str,
        edit_param: Sequence[float],
        steps: int = 50,
        guidance_scale: float = 7.5,
        inversion_guidance: float = 1.5,
        g_weight: float = 15.0,
        appearance_weight: float = 0.8,
        seed: int = 42,
        noise: Optional[torch.Tensor] = None,
        timer=None,
    ) -> np.ndarray:
        """GeoBench's silhouette edit -> uint8 [H, W, 3].  edit_param is the
        9-param [dx, dy, dz, rx, ry, rz, sx, sy, sz]: dx, dy fractional
        shifts, rz degrees, sx, sy scales.  `noise`: [steps, 2, 1, h, w, 4]
        draws in place of the seeded ones; `timer`: a `GradStepTimer`."""
        pipe = self.pipe
        dev = pipe.device
        cfg = pipe.config
        shape = (1, cfg.latent_height, cfg.latent_width, 4)
        schedule = DDIMSchedule.create(num_inference_steps=steps)
        select = torch.as_tensor(self.token_select(prompt, obj), device=dev)
        latent = pipe.image_to_latent(ori_image)
        ctx2 = torch.cat([pipe.encode_text([" "]), pipe.encode_text([prompt])], dim=0)

        inv_latent = self._invert(schedule, latent, ctx2, float(inversion_guidance))
        # the silhouette reference: the object maps at the deepest noise level
        _, ref_maps, _ = self.apply_sow(torch.cat([inv_latent, inv_latent]),
                                        int(schedule.timesteps[0]), ctx2, select)

        dx, dy = float(edit_param[0]), float(edit_param[1])
        rz = float(edit_param[5])
        sx, sy = float(edit_param[6]), float(edit_param[7])
        transform = (rz, sy if sy else 1.0, sx if sx else 1.0, dy, dx)
        guided = _ref_transform_gate(*transform)

        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(seed)

            def draw(i, j):
                return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        else:
            def draw(i, j):
                return noise[i, j].to(dev, torch.float32)

        edit_lat, _ = self._guided_loop(
            schedule, inv_latent, ctx2, select, ref_maps, guidance_gates(steps, "ddpm"),
            transform, draw, guided, float(guidance_scale), float(g_weight),
            float(appearance_weight), timer or NoStepTimer())
        return pipe.latent_to_image(edit_lat)[0]
