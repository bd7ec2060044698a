"""SV3D_p inference in PyTorch: 21-frame orbital novel-view synthesis and
the SV3D coarse 3D edit (mirrors `freefine_tpu.models.sv3d`).

  * the EDM pieces: the Karras sigma schedule (`edm_sigmas`), the
    v-prediction scalings with EDM's c_noise (`v_scaling_edm_cnoise`), the
    per-frame triangle guidance scales (`triangle_guidance_scales`) and the
    orbit's vector conditioning (`build_sv3d_vector_cond`);
  * `SV3D.sample_latents`: the Euler sampler over the 21-frame orbit, two
    UNet calls a step (conditional, then unconditional with zero context
    and zero conditioning frames), the guidance blended per frame;
  * the coarse edit: crop the object to a white 576^2 square
    (`crop_object_square`), encode it, take its CLIP ViT-H token, sample
    the orbit whose azimuths include the target angle, decode the frame
    closest to it (`pick_frame_for_angle`), matte it (U^2-Net, or without
    one the near-white background rule) and paste it back over the source
    box (`paste_novel_view_back`) — `re_edit_3d_sv3d`;
  * `make_sv3d_edit_fn`: that edit on the published checkpoints, as the
    GeoBench-3D authoring backend.

Every function takes its device from its arguments (the models' device, or
`device=`, CUDA by default); noise comes from an explicit
`torch.Generator` on that device, or is replayed through `noise=`.
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from freefine_tpu_torch.data.datagen import generate_azimuth_angles
from freefine_tpu_torch.models.layers import timestep_embedding
from freefine_tpu_torch.models.video_unet import VideoUNet
from freefine_tpu_torch.ops.resize import resize


# -- EDM pieces ---------------------------------------------------------------------


def _unit_ramp(n: int, device=None) -> torch.Tensor:
    """[n] float32 from 0 to 1 as the JAX package's `jnp.linspace(0, 1, n)`
    evaluates: i times the float32 reciprocal of n - 1, the last exactly 1
    (torch.linspace rounds some points the other way: a 1-ulp ramp moves
    EDM's sigma ** 7 by a few 1e-6)."""
    if n == 1:
        return torch.zeros(1, device=device)
    ramp = torch.arange(n, dtype=torch.float32, device=device) * float(
        np.float32(1) / np.float32(n - 1))
    ramp[-1] = 1.0
    return ramp


def edm_sigmas(num_steps: int, sigma_min: float = 0.002, sigma_max: float = 700.0,
               rho: float = 7.0, device=None) -> torch.Tensor:
    """EDM's Karras schedule, descending, with a trailing 0: [num_steps + 1]
    float32."""
    ramp = _unit_ramp(num_steps, device)
    min_r = sigma_min ** (1 / rho)
    max_r = sigma_max ** (1 / rho)
    sigmas = (max_r + ramp * (min_r - max_r)) ** rho
    return torch.cat([sigmas, torch.zeros(1, device=device)])


def v_scaling_edm_cnoise(sigma: torch.Tensor):
    """c_skip = 1/(s^2+1), c_out = -s/sqrt(s^2+1), c_in = 1/sqrt(s^2+1),
    c_noise = 0.25 log(s)."""
    c_skip = 1.0 / (sigma**2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_noise = 0.25 * torch.log(sigma)
    return c_skip, c_out, c_in, c_noise


def triangle_guidance_scales(num_frames: int, max_scale: float = 2.5, min_scale: float = 1.0,
                             device=None) -> torch.Tensor:
    """Guidance per frame: min_scale at both ends of the orbit, rising
    linearly to max_scale at the middle frame.  [num_frames] float32."""
    t = _unit_ramp(num_frames, device)
    tri = 1.0 - torch.abs(2.0 * t - 1.0)
    return min_scale + (max_scale - min_scale) * tri


def build_sv3d_vector_cond(cond_aug: float, polars_rad: torch.Tensor,
                           azimuths_rad: torch.Tensor, adm_in: int = 1280) -> torch.Tensor:
    """[T, adm_in] = the sinusoid embeddings of [cond_aug | polar | azimuth]
    (256 / 512 / 512 wide at adm_in 1280), in sv3d_p.yaml's conditioner
    order."""
    t = azimuths_rad.shape[0]
    aug_dim = adm_in // 5
    ang_dim = (adm_in - aug_dim) // 2
    aug = timestep_embedding(torch.full((t,), cond_aug, device=azimuths_rad.device), aug_dim)
    pol = timestep_embedding(polars_rad, ang_dim)
    azi = timestep_embedding(azimuths_rad, adm_in - aug_dim - ang_dim)
    return torch.cat([aug, pol, azi], dim=-1)


@dataclasses.dataclass
class SV3D:
    """The SV3D_p sampler around a `VideoUNet` (which holds its weights)."""

    unet: VideoUNet
    num_frames: int = 21
    num_steps: int = 50
    sigma_max: float = 700.0
    cond_aug: float = 1e-5

    @torch.no_grad()
    def sample_latents(
        self,
        cond_latent: torch.Tensor,      # [1, h, w, 4] VAE latent of the conditioning frame
        clip_tokens: torch.Tensor,      # [1, 1, ctx] its CLIP image embedding
        azimuths_deg: Sequence[float],
        elevations_deg: Sequence[float],
        generator: Optional[torch.Generator] = None,
        max_guidance: float = 2.5,
        noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """EDM Euler sampling of the orbit -> [T, h, w, 4] float32.

        Two draws, in this order, from `generator` (on the latent's
        device): the conditioning augmentation's normal [T, h, w, 4], then
        x0's, scaled by sqrt(1 + sigma_0^2) (sgm's rule); `noise` = (aug,
        x0) replays them."""
        dev = cond_latent.device
        t = self.num_frames
        h, w = cond_latent.shape[1:3]
        sigmas = edm_sigmas(self.num_steps, sigma_max=self.sigma_max, device=dev)
        scales = triangle_guidance_scales(t, max_guidance, device=dev)[:, None, None, None]
        azim = torch.deg2rad(torch.as_tensor(azimuths_deg, dtype=torch.float32, device=dev))
        polar = math.pi / 2 - torch.deg2rad(
            torch.as_tensor(elevations_deg, dtype=torch.float32, device=dev))
        y = build_sv3d_vector_cond(self.cond_aug, polar, azim,
                                   adm_in=self.unet.config.adm_in_channels)
        shape = (t, h, w, 4)
        if noise is None:
            aug = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
            x0 = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        else:
            aug, x0 = (n.to(dev, torch.float32) for n in noise)
        cond = cond_latent.float().expand(t, -1, -1, -1) + self.cond_aug * aug
        ctx_c = clip_tokens.expand(t, -1, -1)
        ctx_u = torch.zeros_like(ctx_c)
        zeros = torch.zeros_like(cond)

        def denoise(x, sigma):
            c_skip, c_out, c_in, c_noise = v_scaling_edm_cnoise(sigma)
            t_cont = c_noise.expand(t)

            def run(ctx, cond_cat):
                out = self.unet(torch.cat([x * c_in, cond_cat], dim=-1), t_cont, ctx, y)
                return out.float() * c_out + x * c_skip

            d_c = run(ctx_c, cond)
            d_u = run(ctx_u, zeros)
            return d_u + scales * (d_c - d_u)

        x = x0 * torch.sqrt(1.0 + sigmas[0] ** 2)
        for i in range(self.num_steps):
            sigma, next_sigma = sigmas[i], sigmas[i + 1]
            d = (x - denoise(x, sigma)) / sigma
            x = x + (next_sigma - sigma) * d
        return x


# -- the coarse 3D edit -----------------------------------------------------------


def _bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    ys, xs = np.nonzero(mask)
    return ys.min(), ys.max() + 1, xs.min(), xs.max() + 1


def crop_object_square(img: np.ndarray, mask: np.ndarray, out_size: int = 576,
                       pad_ratio: float = 0.1, bg_value: int = 255,
                       device: str | torch.device = "cuda"
                       ) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Cut the object by its mask's box over a `bg_value` background, pad it
    to a square (side max(h, w) * (1 + pad_ratio)), centred, and resize to
    out_size^2 (JAX's antialiased "linear", on `device`).  -> (uint8 image,
    box (x0, y0, x1, y1))."""
    m = np.asarray(mask) > 0
    y0, y1, x0, x1 = _bbox(m)
    obj = np.where(m[y0:y1, x0:x1][..., None], np.asarray(img)[y0:y1, x0:x1], bg_value)
    h, w = obj.shape[:2]
    side = int(max(h, w) * (1 + pad_ratio))
    canvas = np.full((side, side, 3), bg_value, np.uint8)
    oy, ox = (side - h) // 2, (side - w) // 2
    canvas[oy : oy + h, ox : ox + w] = obj
    out = resize(torch.as_tensor(canvas, device=device), (out_size, out_size), "linear")
    return np.clip(out.cpu().numpy(), 0, 255).astype(np.uint8), (x0, y0, x1, y1)


def resize_nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each output sample of `jax.image.resize`'s
    "nearest": floor((i + 0.5) * n_in / n_out) in float32 (torch's
    "nearest-exact", not its "nearest")."""
    pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(n_in)
    return np.floor(pos / np.float32(n_out)).astype(np.int64)


def paste_novel_view_back(
    src_img: np.ndarray,
    src_mask: np.ndarray,
    view_img: np.ndarray,
    view_mask: np.ndarray,
    inp_background: Optional[np.ndarray] = None,
    device: str | torch.device = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Paste the novel view's object over `inp_background` (the source image
    by default), its mask's box scaled to the source mask's box: the image
    by the antialiased "linear" resize, the mask by JAX's "nearest", both
    on `device`.  An empty view mask returns the background and an empty
    mask.  -> (image, target mask 0/255)."""
    src_img = np.asarray(src_img)
    src_mask = np.asarray(src_mask)
    if src_mask.ndim == 3:
        src_mask = src_mask[:, :, 0]
    if inp_background is None:
        inp_background = src_img
    y0, y1, x0, x1 = _bbox(src_mask > 0)
    bh, bw = y1 - y0, x1 - x0
    vm = np.asarray(view_mask) > 0
    if not vm.any():
        return np.asarray(inp_background).copy(), np.zeros_like(src_mask)
    vy0, vy1, vx0, vx1 = _bbox(vm)
    crop = np.asarray(view_img)[vy0:vy1, vx0:vx1]
    mcrop = vm[vy0:vy1, vx0:vx1]
    rs_img = resize(torch.as_tensor(crop, device=device), (bh, bw), "linear").cpu().numpy()
    rows = resize_nearest_index(mcrop.shape[0], bh)
    cols = resize_nearest_index(mcrop.shape[1], bw)
    region = mcrop[rows][:, cols]
    out = np.asarray(inp_background).copy()
    out[y0:y1, x0:x1][region] = np.clip(rs_img[region], 0, 255).astype(np.uint8)
    tmask = np.zeros_like(src_mask)
    tmask[y0:y1, x0:x1] = (region * 255).astype(src_mask.dtype)
    return out, tmask


def pick_frame_for_angle(azimuths_deg: Sequence[float], target_deg: float) -> int:
    """Index of the orbit frame closest to the target azimuth (mod 360)."""
    az = np.asarray(azimuths_deg, np.float64) % 360
    t = target_deg % 360
    diff = np.minimum(np.abs(az - t), 360 - np.abs(az - t))
    return int(np.argmin(diff))


def re_edit_3d_sv3d(
    sv3d: SV3D,
    vae,                  # AutoencoderKL
    clip_image,           # CLIPImageEncoder (ViT-H) or None
    matting,              # U2Net or None
    src_img: np.ndarray,
    src_mask: np.ndarray,
    target_azimuth_deg: float,
    elevation_deg: float = 10.0,
    inp_background: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    timer=None,
    info: Optional[dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The SV3D coarse 3D edit, end to end, on the UNet's device: crop the
    object square (576^2), VAE-encode it, its CLIP token (zeros without
    `clip_image`), sample the orbit whose azimuths hold +-target (seeded by
    `generator`, 0 by default, or replayed from `noise`), decode the frame
    closest to the target, re-extract its mask (U^2-Net's saliency, or
    without `matting` every pixel darker than near-white: mean < 248), and
    paste it back over `inp_background`.  `timer` (a
    `utils.profiling.StageTimer`) times the stages "crop", "vae_encode",
    "clip", "orbit", "vae_decode", "matting", "paste"; `info`, a dict,
    gets the orbit frame used ("frame") and the view mask's share of its
    pixels ("view_mask_share": 0 takes the empty-mask branch of the paste).
    -> (coarse image, target mask 0/255)."""
    from freefine_tpu_torch.models.clip_image import preprocess_clip
    from freefine_tpu_torch.models.u2net import get_mask_from_saliency

    dev = next(sv3d.unet.parameters()).device

    @contextmanager
    def stage(name):
        if timer is None:
            yield
            return
        with timer.stage(name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    if generator is None and noise is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        with stage("crop"):
            crop, _ = crop_object_square(src_img, src_mask, out_size=576, device=dev)
        with stage("vae_encode"):
            x = torch.as_tensor(crop, device=dev).float()[None] / 127.5 - 1.0
            cond_latent = vae.encode(x)
        with stage("clip"):
            if clip_image is not None:
                tok = clip_image(preprocess_clip(torch.as_tensor(crop, device=dev)))[None]
            else:
                tok = torch.zeros(1, 1, sv3d.unet.config.context_dim, device=dev)
        azimuths = generate_azimuth_angles(sv3d.num_frames,
                                           [target_azimuth_deg, -target_azimuth_deg])
        with stage("orbit"):
            latents = sv3d.sample_latents(cond_latent, tok, azimuths,
                                          [elevation_deg] * sv3d.num_frames, generator,
                                          noise=noise)
        idx = pick_frame_for_angle(azimuths, target_azimuth_deg)
        with stage("vae_decode"):
            frame = vae.decode(latents[idx : idx + 1])
            frame_u8 = np.clip((frame[0].float().cpu().numpy() / 2.0 + 0.5) * 255.0, 0,
                               255).astype(np.uint8)
        with stage("matting"):
            if matting is not None:
                view_mask = get_mask_from_saliency(matting, frame_u8)
            else:
                view_mask = (frame_u8.mean(-1) < 248).astype(np.uint8) * 255
    if info is not None:
        info.update(frame=idx, view_mask_share=float((np.asarray(view_mask) > 0).mean()))
    with stage("paste"):
        return paste_novel_view_back(src_img, src_mask, frame_u8, view_mask, inp_background,
                                     device=dev)


def make_sv3d_edit_fn(sv3d_path: str, u2net_path: Optional[str] = None, seed: int = 0,
                      device: str | torch.device = "cuda"):
    """The SV3D coarse 3D edit as the GeoBench-3D authoring backend:
    `(img, mask, angle_deg, inp_background) -> (coarse, target mask)`.

    Reads sv3d_p.safetensors (`weights.load_sv3d`: SV3D_p's video UNet in
    bf16, its ViT-H image tower in float32, the SD VAE in bf16) and, where
    `u2net_path` is given, u2netp.pth (`weights.load_u2net`); without it
    the view is matted by the near-white background rule, as in the JAX
    package.  The modules are built on the meta device and take the
    checkpoint's tensors on `device`; every call samples its orbit with a
    generator seeded by `seed` (so two calls of the same case agree)."""
    from freefine_tpu_torch.config import VAEConfig
    from freefine_tpu_torch.models.clip_image import CLIPImageEncoder, clip_vit_h14
    from freefine_tpu_torch.models.u2net import U2Net, u2netp_config
    from freefine_tpu_torch.models.vae import AutoencoderKL
    from freefine_tpu_torch.models.video_unet import sv3d_config
    from freefine_tpu_torch.weights import load_sv3d, load_u2net

    dev = torch.device(device)
    configs = {"unet": sv3d_config(), "clip_image": clip_vit_h14(), "vae": VAEConfig()}
    sds = load_sv3d(sv3d_path, configs["unet"], configs["clip_image"], configs["vae"])
    with torch.device("meta"):
        mods = {"unet": VideoUNet(configs["unet"]),
                "clip_image": CLIPImageEncoder(configs["clip_image"]),
                "vae": AutoencoderKL(configs["vae"])}
    for name, mod in mods.items():
        mod.load_state_dict({k: v.to(dev) for k, v in sds.pop(name).items()}, assign=True)
        mod.eval()
    matting = None
    if u2net_path is not None:
        matting = load_u2net(U2Net(u2netp_config(), device=dev), u2net_path).eval()
    sv3d = SV3D(unet=mods["unet"])

    def edit_fn(img, mask, angle_deg, inp_background):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return re_edit_3d_sv3d(sv3d, mods["vae"], mods["clip_image"], matting, img, mask,
                               float(angle_deg), inp_background=inp_background, generator=gen)

    return edit_fn
