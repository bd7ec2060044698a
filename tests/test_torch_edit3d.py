"""The depth-based 3D edit end to end on `tiny_pipeline_config`, the port
against the JAX package: a tiny Depth-Anything's depth through
`make_depth_fn`'s semantics (the disparity's antialiased linear resize to
the image, then max - disparity), `re_edit_3d_depth` on it, and
`generation` at GeoBench-3D's protocol (`parallel/harness.py`: start step
15 of 50, here 3 of 8; TCA to the end, end_scale 0; no auto draw, the
rendered mask as the draw mask; cons_area the target mask;
reduce_inp_artifacts) on JAX's coarse image and masks, JAX's noise draws
replayed into the port.  Then the SV3D coarse 3D edit the same way: the
tiny `re_edit_3d_sv3d` (a tiny video UNet attending at its 36^2 level,
`tiny_pipeline_config`'s VAE, a tiny ViT and U^2-Net; a 576^2 frame, 3
Euler steps, JAX's draws replayed), then `generation` at the same protocol
on JAX's coarse image and target mask (the target mask as draw mask and
cons_area).  Both edits share one pair of pipelines, so JAX compiles
`generation` once.

Tolerances: the depth within 2e-4 of max |ref|; the depth edit's mask
equal except at <= 0.05 % of the pixels and its image within 1 level where
the masks agree; the SV3D edit's target mask equal and its image within 1
level; the final latents within 2e-3 (float32 on both sides), uint8
images within 1 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.data.author3d import make_depth_fn as j_make_depth_fn
from freefine_tpu.models import sv3d as JS
from freefine_tpu.models.depth_anything import preprocess_depth_input as j_preprocess
from freefine_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from freefine_tpu.ops.point_splat import re_edit_3d_depth as j_re_edit_3d_depth
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch.data.author3d import make_depth_fn
from freefine_tpu_torch.models import sv3d as S
from freefine_tpu_torch.ops.point_splat import re_edit_3d_depth
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_depth import assert_close, flip_deconvs, tiny_depth_model
from test_torch_pipeline import _capture, capture_decodes
from test_torch_point_splat import images_agree, masks_agree
from test_torch_sv3d import _object, jitted, tiny_u2net, tiny_video, tiny_vit
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

NUM_STEP, START = 8, 3
K = NUM_STEP - START
RY20 = (0, 0, 0, 0, 20, 0, 1, 1, 1)
DEPTH_SIZE = 56   # the tiny Depth-Anything's input side (preprocess `size`)


def _case(h, w):
    rng = np.random.default_rng(12)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[h // 4 : 3 * h // 4, w // 4 : 5 * w // 8] = 255
    return img, mask


def _jax_depth(apply, params, img):
    """`freefine_tpu.data.author3d.make_depth_fn`'s predict at the tiny
    model's input size: preprocess, disparity, linear resize, max - d."""
    disp = apply(params, j_preprocess(jnp.asarray(img), size=DEPTH_SIZE))[0]
    disp = jax.image.resize(disp, img.shape[:2], "linear")
    return np.asarray(jnp.clip(disp.max() - disp, 0.0))


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(23)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, mods, jcfg, jpipe, tpipe


@pytest.fixture(scope="module")
def chain(pipes):
    cfg, _, _, jpipe, tpipe = pipes
    img, mask = _case(cfg.height, cfg.width)
    model, apply, raw = tiny_depth_model(41)
    want_depth = _jax_depth(apply, flip_deconvs(raw), img)
    got_depth = make_depth_fn(model=model, device="cpu", size=DEPTH_SIZE)(img)
    return cfg, jpipe, tpipe, img, mask, got_depth, want_depth


def test_depth_fn_matches_jax(chain):
    *_, img, _, got, want = chain
    assert got.shape == want.shape == img.shape[:2] and got.dtype == np.float32
    assert want.std() > 0
    assert_close(got, want)
    np.testing.assert_array_equal(make_depth_fn("constant")(img),
                                  j_make_depth_fn("constant")(img))


def test_coarse_3d_edit_on_the_depth(chain):
    cfg, *_, img, mask, got_depth, want_depth = chain
    f = 0.92 * cfg.width
    want = j_re_edit_3d_depth(img, mask, want_depth.max() - want_depth + 1.0, RY20,
                              focal_length_x=f, focal_length_y=f)
    got = re_edit_3d_depth(img, mask, got_depth.max() - got_depth + 1.0, RY20,
                           focal_length_x=f, focal_length_y=f, device="cpu")
    agree = masks_agree(got[1], want[1])
    images_agree(got[0], want[0], agree)


def test_3d_generation_matches_jax(chain):
    cfg, jpipe, tpipe, img, mask, _, want_depth = chain
    f = 0.92 * cfg.width
    coarse, tm, _ = j_re_edit_3d_depth(img, mask, want_depth.max() - want_depth + 1.0, RY20,
                                       focal_length_x=f, focal_length_y=f)
    coarse, tm = np.asarray(coarse), np.asarray(tm)
    assert 0 < (tm > 0).mean() < 1
    seed = 5
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=NUM_STEP, start_step=START,
              end_step=NUM_STEP, end_scale=0.0, method_type="tca", draw_mask=tm,
              use_auto_draw=False, cons_area=tm, reduce_inp_artifacts=True, seed=seed)
    jstore = {}
    _capture(jpipe, jstore, lambda x: np.asarray(x))
    decoded = capture_decodes(tpipe, lambda x: x.numpy())
    want = jpipe.generation(img, mask, coarse, tm, "a cat", **kw)
    key, noise = jax.random.key(seed), []
    for _ in range(K):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.normal(
            sub, (2, cfg.latent_height, cfg.latent_width, 4), jnp.float32))))
    got = tpipe.generation(img, mask, coarse, tm, "a cat", noise=noise, **kw)
    # JAX decodes the edit and reference streams in one call
    np.testing.assert_allclose(decoded[0], jstore["lat"][:1], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - np.asarray(want).astype(int)).max() <= 1


# -- the SV3D coarse 3D edit, then generation -------------------------------------


@pytest.fixture(scope="module")
def sv3d_chain(pipes):
    """The tiny `re_edit_3d_sv3d` (a tiny UNet with attention at its 36^2
    level, the tiny pipeline's VAE, a tiny ViT and U^2-Net) on both sides,
    JAX's draws replayed."""
    cfg, mods, jcfg, *_ = pipes
    unet, junet, uparams = tiny_video(12, attention_levels=(False, True))
    vit, jvit, vparams = tiny_vit()
    u2, ju2, u2params = tiny_u2net()
    img, mask = _object(cfg.height, cfg.width, (16, 50, 12, 44), 10)
    key = jax.random.key(11)
    jvae = jitted(JAutoencoderKL(config=jcfg.vae), encode="encode", decode="decode")
    want = JS.re_edit_3d_sv3d(
        JS.SV3D(unet=jitted(junet, config=junet.config), unet_params=uparams, num_frames=3,
                num_steps=3), jvae,
        jax_params(mods["vae"], "vae", jcfg), jitted(jvit), vparams, (jitted(ju2), u2params),
        img, mask, 30.0, rng=key)
    draws = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(sub, (3, 72, 72, 4)))))
    got = S.re_edit_3d_sv3d(S.SV3D(unet=unet, num_frames=3, num_steps=3), mods["vae"].eval(),
                            vit, u2, img, mask, 30.0, noise=tuple(draws))
    return img, mask, got, tuple(np.asarray(x) for x in want)


def test_re_edit_3d_sv3d_matches_jax(sv3d_chain):
    *_, got, want = sv3d_chain
    np.testing.assert_array_equal(got[1], want[1])
    assert 0 < (want[1] > 0).mean() < 1
    images_agree(got[0], want[0], np.ones(want[1].shape, bool))


def test_generation_after_the_sv3d_edit_matches_jax(pipes, sv3d_chain, monkeypatch):
    """`generation` at GeoBench-3D's protocol on JAX's coarse image and
    target mask, JAX's per-step draws replayed."""
    cfg, _, _, jpipe, tpipe = pipes
    img, mask, _, (coarse, tm) = sv3d_chain
    seed = 5
    kw = dict(guidance_scale=7.5, eta=1.0, num_step=NUM_STEP, start_step=START,
              end_step=NUM_STEP, end_scale=0.0, method_type="tca", draw_mask=tm,
              use_auto_draw=False, cons_area=tm, reduce_inp_artifacts=True, seed=seed)
    jlat = []
    orig = jpipe.latent_to_image
    monkeypatch.setattr(jpipe, "latent_to_image",
                        lambda lat: (jlat.append(np.asarray(lat)), orig(lat))[1])
    monkeypatch.setattr(tpipe, "latent_to_image", tpipe.latent_to_image)
    decoded = capture_decodes(tpipe, lambda x: x.numpy())
    jpipe.generation(img, mask, coarse, tm, "a cat", **kw)
    key, noise = jax.random.key(seed), []
    for _ in range(K):
        key, sub = jax.random.split(key)
        noise.append(torch.from_numpy(np.array(jax.random.normal(
            sub, (2, cfg.latent_height, cfg.latent_width, 4), jnp.float32))))
    tpipe.generation(img, mask, coarse, tm, "a cat", noise=noise, **kw)
    assert_close(decoded[0], jlat[-1][:1], tol=2e-3)
