"""DesignEdit baseline core for the PyTorch port (mirrors
`freefine_tpu.baselines.design_edit`): multi-layer latent editing for
object removal, camera panning and zooming, and layer-wise object moving.

  1. DDIM-invert the (for pan and zoom, pre-warped) image; every latent
     layer starts from the inverted x_T.
  2. Denoise an n-stream CFG batch [u_1 .. u_n, c_1 .. c_n] where, per step:
       * the conditional background stream (`kv_source_stream` n + 1)
         computes its self-attention keys from hidden states zeroed inside
         the removal hole (`EditConfig(mode="design")`);
       * proximal regularisation marks the edited latents (|cond - uncond|
         above its global 0.75 quantile, dilated by 2) and pulls everything
         outside them back toward the inversion trajectory, lr 0.1, while
         t < 400;
       * layer fusion blends the background stream with the original one
         outside the hole (the first 41 steps), then composites the
         shifted foreground layer onto the canvas stream once.
  3. Decode the background stream (remove, pan, zoom) or the canvas
     stream (move).

DDIM with eta 0: no noise is drawn.  The denoiser is whatever the pipe
carries; the conditioning is a `conditioning.Cond`, so SDXL's pair stacks
as the context does.  Latents are NHWC.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from freefine_tpu_torch.conditioning import Cond
from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_pyramid, nearest_resize
from freefine_tpu_torch.masks import dilate
from freefine_tpu_torch.schedulers.ddim import DDIMSchedule, ddim_prev

# ---------------------------------------------------------------------------
# Host-side pixel warps
# ---------------------------------------------------------------------------


def panning(img: np.ndarray, op_list: Sequence[Tuple[str, float]]):
    """Shift the frame, exposing a hole -> (warped image, hole mask 0/255).
    The hole is the true one: where the reference sums two uint8 axis masks
    (wrapping to all-255 when one axis is panned), this returns the hole."""
    h, w = img.shape[:2]
    out = img.copy()
    w_mask = np.full((h, w), 255, np.uint8)
    h_mask = np.full((h, w), 255, np.uint8)
    used_w = used_h = False
    for op, scale in op_list:
        k = int(scale * (w if op in ("right", "left") else h))
        if k == 0:
            continue
        if op == "right":
            out[:, k:] = out[:, : w - k].copy()
            w_mask[:, k:] = 0
            used_w = True
        elif op == "left":
            out[:, : w - k] = out[:, k:].copy()
            w_mask[:, : w - k] = 0
            used_w = True
        elif op == "down":
            out[k:, :] = out[: h - k].copy()
            h_mask[k:, :] = 0
            used_h = True
        elif op == "up":
            out[: h - k] = out[k:].copy()
            h_mask[: h - k] = 0
            used_h = True
    mask = np.zeros((h, w), np.uint8)
    if used_w:
        mask |= w_mask
    if used_h:
        mask |= h_mask
    return out, mask


def _area_resize(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """cv2.INTER_AREA downscale: each destination pixel the exact
    fractional-area average of the source pixels its footprint covers."""
    h, w = img.shape[:2]

    def axis_weights(src: int, dst: int) -> np.ndarray:
        scale = src / dst
        wm = np.zeros((dst, src), np.float64)
        for i in range(dst):
            a, b = i * scale, (i + 1) * scale
            for j in range(int(np.floor(a)), min(int(np.ceil(b)), src)):
                wm[i, j] = max(0.0, min(b, j + 1) - max(a, j))
            wm[i] /= scale
        return wm

    wy, wx = axis_weights(h, nh), axis_weights(w, nw)
    flat = img.reshape(h, w, -1).astype(np.float64)
    out = np.einsum("ij,jkc,lk->ilc", wy, flat, wx)
    out = out.reshape((nh, nw) + img.shape[2:])
    if np.issubdtype(img.dtype, np.integer):
        return np.rint(out).clip(0, 255).astype(img.dtype)
    return out.astype(img.dtype)


def zooming(img: np.ndarray, scale: Sequence[float]):
    """Zoom out: the content shrunk into the centre (INTER_AREA), exposing
    a border hole -> (warped image, hole mask 0/255)."""
    h, w = img.shape[:2]
    nh, nw = int(h * scale[0]), int(w * scale[1])
    resized = _area_resize(img, nh, nw)
    out = img.copy()
    mask = np.full((h, w), 255, np.uint8)
    y0, x0 = (h - nh) // 2, (w - nw) // 2
    out[y0: y0 + nh, x0: x0 + nw] = resized
    mask[y0: y0 + nh, x0: x0 + nw] = 0
    return out, mask


def attend_mask(mask: Optional[np.ndarray], lh: int, lw: int, attend_scale: int = 20,
                device="cpu") -> torch.Tensor:
    """Dilate (erode if negative) and nearest-resize to the latent grid ->
    [lh, lw] float 0/1."""
    if mask is None:
        return torch.zeros(lh, lw, device=device)
    m = torch.as_tensor((np.asarray(mask) > 127).astype(np.float32), device=device)
    if attend_scale > 0:
        m = dilate(m, attend_scale)
    elif attend_scale < 0:
        m = 1.0 - dilate(1.0 - m, -attend_scale)
    return nearest_resize(m, lh, lw)


def shift_latent(x: torch.Tensor, op: str, scale: float) -> torch.Tensor:
    """Zero-fill shift of a [1, H, W, C] latent by a fraction of the
    shifted axis."""
    _, h, w, _ = x.shape
    k = int(scale * (w if op in ("right", "left") else h))
    if k == 0:
        return x
    out = torch.zeros_like(x)
    if op == "right":
        out[:, :, k:] = x[:, :, : w - k]
    elif op == "left":
        out[:, :, : w - k] = x[:, :, k:]
    elif op == "down":
        out[:, k:] = x[:, : h - k]
    elif op == "up":
        out[:, : h - k] = x[:, k:]
    else:
        raise ValueError(op)
    return out


def shift_latent_dynamic(x: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    """`shift_latent` composed over down(+)/up(-) and right(+)/left(-) by
    ky / kx pixels, as one roll and a validity mask."""
    h, w = x.shape[1], x.shape[2]
    rows = torch.arange(h, device=x.device)[None, :, None, None]
    cols = torch.arange(w, device=x.device)[None, None, :, None]
    x = torch.roll(x, (ky, kx), dims=(1, 2))
    valid_r = rows >= ky if ky >= 0 else rows < h + ky
    valid_c = cols >= kx if kx >= 0 else cols < w + kx
    return x * (valid_r & valid_c).to(x.dtype)


def _quantile_threshold(delta: torch.Tensor, q: float) -> torch.Tensor:
    """The global |delta| quantile, linear interpolation (jnp.quantile's)."""
    return torch.quantile(delta.abs().reshape(-1).float(), q)


def _dilate_latent(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Max-pool dilation of a [N, H, W, C] 0/1 mask, window 2 * radius + 1,
    centred."""
    if radius <= 0:
        return mask
    k = 2 * radius + 1
    out = F.max_pool2d(mask.permute(0, 3, 1, 2), k, stride=1, padding=radius)
    return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class DesignEdit:
    """Multi-layer latent editing over a `FreeFine` (or `SDXLFreeFine`)
    pipe, on the pipe's device.  The reference's defaults: 50 DDIM steps,
    CFG 7.5, blend window [0, 41], attention mask window (0, 40), proximal
    quantile 0.75, lr 0.1, recon_t 400, dilation radius 2."""

    def __init__(self, pipe):
        self.pipe = pipe

    def _denoise(self, schedule, lat, ctx2: Cond, remove, keep_pyr, refine_pyr, fg_mask,
                 targets, gates, op_list, guidance_scale: float):
        """lat [n, lh, lw, 4] -> the n streams after the denoise; gates
        [steps, 5] (attn, blend, move, prox, refine)."""
        pipe = self.pipe
        n = lat.shape[0]
        ecfg = EditConfig(mode="design", method=None, local_cfg=False, kv_source_stream=n + 1)
        rm = remove[None, :, :, None]
        fgm0 = fg_mask[None, :, :, None]
        x = lat
        for i, t in enumerate(schedule.timesteps):
            t = int(t)
            g_attn, g_blend, g_move, g_prox, g_ref = gates[i]
            keep = refine_pyr if g_ref > 0 else keep_pyr
            state = EditState(local_region=keep, share_gate=float(g_attn))
            eps2 = pipe.unet_apply(torch.cat([x, x], dim=0), t, ctx2, ecfg, state)
            u, c = eps2[:n], eps2[n:]
            delta = (c - u).float()
            thr = _quantile_threshold(delta, 0.75)
            mask_edit = _dilate_latent((delta.abs() > thr).float(), 2)
            eps = u.float() + guidance_scale * delta

            # DDIM step, eta 0
            x_new = ddim_prev(schedule, eps, t, x)

            # proximal realignment: the background stream's hole joins its
            # edit mask and the canvas stream is left free
            if g_prox > 0:
                me = mask_edit.clone()
                me[1] = torch.clamp(mask_edit[1] + rm[0], 0, 1)
                if n > 2:
                    me[2] = 1.0
                x_new = x_new - 0.1 * (x_new - targets[i].float()) * (1.0 - me)

            # layer fusion
            if g_blend > 0:
                x_new = x_new.clone()
                x_new[1] = x_new[1] * rm[0] + x_new[0] * (1.0 - rm[0])
            if n > 3 and g_move > 0:
                fg, fgm = x_new[3:4], fgm0
                for op, scale in op_list:
                    if scale:
                        fg = shift_latent(fg, op, scale)
                        fgm = shift_latent(fgm, op, scale)
                x_new = x_new.clone()
                x_new[2] = x_new[1] * (1.0 - fgm[0]) + fg[0] * fgm[0]
            x = x_new.to(x.dtype)
        return x

    @torch.no_grad()
    def _edit(self, images: List[np.ndarray], remove_mask_px, sample_ref_match: List[int],
              prompt: str, fg_mask_px=None, op_list=(), out_stream: int = 1, steps: int = 50,
              guidance_scale: float = 7.5, blend_end: int = 41, mask_end: int = 40,
              recon_t: int = 400, refine_mask_px=None, refine_end: int = 25) -> np.ndarray:
        pipe = self.pipe
        dev = pipe.device
        cfg = pipe.config
        lh, lw = cfg.latent_height, cfg.latent_width
        n = len(sample_ref_match)
        schedule = DDIMSchedule.create(num_inference_steps=steps)

        # every distinct source image inverted once
        lats = torch.cat([pipe.image_to_latent(img) for img in images], dim=0)
        traj = pipe.invert(lats, steps, 0)            # [steps + 1, n_inv, ...]

        remove = attend_mask(remove_mask_px, lh, lw, device=dev)
        keep_pyr = build_mask_pyramid(1.0 - remove, lh, lw)
        # the structure-completion variant: while the refine window is open
        # the key mask is the union of the hole and the draw mask
        if refine_mask_px is not None:
            union = torch.clamp(remove + attend_mask(refine_mask_px, lh, lw, device=dev), 0, 1)
            refine_pyr = build_mask_pyramid(1.0 - union, lh, lw)
        else:
            refine_pyr = keep_pyr
        fg_mask = (attend_mask(fg_mask_px, lh, lw, device=dev) if fg_mask_px is not None
                   else torch.zeros(lh, lw, device=dev))

        ref = torch.as_tensor(sample_ref_match, device=dev)
        lat0 = traj[-1][ref]
        # step i's realignment target: the inversion latent one level cleaner
        targets = traj.flip(0)[1:][:, ref]

        ts = np.asarray(schedule.timesteps)
        counters = np.arange(1, steps + 1)
        i = np.arange(steps)
        gates = np.stack([
            (i > 0) & (i < mask_end),
            counters <= blend_end,
            counters == blend_end + 1,
            ts < recon_t,
            (i > 0) & (i <= refine_end) & (refine_mask_px is not None),
        ], axis=1).astype(np.float32)

        ctx_c = pipe._stream_text_embeddings([prompt] * n)
        ctx_u = pipe._inversion_text_embeddings(n)
        ctx2 = Cond.cat([Cond.of(ctx_u), Cond.of(ctx_c)], 0)

        out = self._denoise(schedule, lat0, ctx2, remove, keep_pyr, refine_pyr, fg_mask,
                            targets, gates, list(op_list), float(guidance_scale))
        return pipe.latent_to_image(out[out_stream: out_stream + 1])[0]

    def remove(self, image: np.ndarray, mask: np.ndarray, prompt: str = "", steps: int = 50,
               refine_mask: Optional[np.ndarray] = None) -> np.ndarray:
        """Object removal: streams [original, inpaint], the inpaint stream
        decoded.  `refine_mask`: the structure-completion variant (the first
        25 steps mask the keys with the union of the hole and this mask)."""
        m = (np.asarray(mask) > 0).astype(np.uint8) * 255
        rm = None if refine_mask is None else (np.asarray(refine_mask) > 0).astype(np.uint8) * 255
        return self._edit([image], m, [0, 0], prompt, steps=steps, refine_mask_px=rm)

    def pan(self, image: np.ndarray, op_list, prompt: str = "", steps: int = 50) -> np.ndarray:
        """Camera panning: the frame pixel-shifted, the exposed hole
        inpainted."""
        warped, hole = panning(image, op_list)
        return self._edit([warped], hole, [0, 0], prompt, steps=steps)

    def zoom(self, image: np.ndarray, scale, prompt: str = "", steps: int = 50) -> np.ndarray:
        """Camera zoom-out: the content shrunk, the border inpainted."""
        warped, hole = zooming(image, scale)
        return self._edit([warped], hole, [0, 0], prompt, steps=steps)

    def move(self, image: np.ndarray, mask: np.ndarray, dx: float = 0.0, dy: float = 0.0,
             prompt: str = "", steps: int = 50) -> np.ndarray:
        """Layer-wise object move: streams [original, inpaint, canvas, fg
        layer]; the fg layer's latent and mask are shifted (dx, dy fractions
        of the size, positive right and up), then composited onto the
        canvas, which is decoded."""
        ops = []
        if dx:
            ops.append(("right", dx) if dx > 0 else ("left", -dx))
        if dy:
            ops.append(("up", dy) if dy > 0 else ("down", -dy))
        return self._edit([image, image], mask, [0, 0, 0, 1], prompt, fg_mask_px=mask,
                          op_list=ops, out_stream=2, steps=steps)
