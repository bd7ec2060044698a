"""The slice as a whole: the port's `FreeFine.generation` against the JAX
package's on `tiny_pipeline_config`, same weights (carried through
`freefine_tpu.weights.convert_*`), JAX's own noise draws replayed into the
port (the `split` -> `normal` chain of `sample_edit_loop`).

Tolerance: final latents within 2e-3 absolute (float32 on both sides;
summation-order differences compound over 4 inversion and 4 regeneration
UNet passes), uint8 images within 1 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.ops.geometry import re_edit_2d as j_re_edit_2d
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_pyramid
from freefine_tpu_torch.pipeline import FreeFine, sample_edit_loop
from freefine_tpu_torch.schedulers.ddim import method_and_gates
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

NUM_STEP, START = 8, 4
K = NUM_STEP - START


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(21)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def _case(cfg):
    h, w = cfg.height, cfg.width
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    mask[12:36, 16:40] = 255
    coarse, tm, _ = j_re_edit_2d(img, mask, dx=10, dy=4, rotation=20)
    return img, mask, np.asarray(coarse), np.asarray(tm)


def _jax_noise(seed, shape):
    key = jax.random.key(seed)
    out = []
    for _ in range(K):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return out


def _capture(pipe, store, to_np):
    orig = pipe.latent_to_image

    def cap(lat):
        store["lat"] = to_np(lat)
        return orig(lat)

    pipe.latent_to_image = cap


def capture_decodes(pipe, to_np) -> list:
    """Record the latents of every `latent_to_image` call, in order (the
    port's `generation` decodes the edit image and, with return_ori, the
    reference image in calls of their own)."""
    seen = []
    orig = pipe.latent_to_image

    def cap(lat):
        seen.append(to_np(lat))
        return orig(lat)

    pipe.latent_to_image = cap
    return seen


@pytest.mark.parametrize("auto_draw", [True, False])
def test_generation_matches_jax(pipes, auto_draw):
    cfg, jpipe, tpipe = pipes
    img, mask, coarse, tm = _case(cfg)
    h, w = cfg.height, cfg.width
    seed = 7
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=seed,
              use_auto_draw=auto_draw, cons_area=np.zeros((h, w), np.uint8),
              reduce_inp_artifacts=auto_draw,
              draw_mask=None if auto_draw else np.asarray(tm))
    jstore = {}
    _capture(jpipe, jstore, lambda x: np.asarray(x))
    decoded = capture_decodes(tpipe, lambda x: x.numpy())
    want, want_ori = jpipe.generation(img, mask, coarse, tm, "a cat", return_ori=True, **kw)
    noise = _jax_noise(seed, (2, cfg.latent_height, cfg.latent_width, 4))
    got, got_ori = tpipe.generation(img, mask, coarse, tm, "a cat", noise=noise, return_ori=True,
                                    **kw)
    assert got.shape == (h, w, 3) and got.dtype == np.uint8
    # both streams' final latents: the edit image's decode, then the reference's
    np.testing.assert_allclose(np.concatenate(decoded), jstore["lat"], atol=2e-3, rtol=0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert np.abs(got_ori.astype(int) - want_ori.astype(int)).max() <= 1


def test_seeded_generation_is_deterministic(pipes):
    cfg, _, tpipe = pipes
    img, mask, coarse, tm = _case(cfg)
    kw = dict(num_step=6, start_step=3, end_step=1, use_auto_draw=True,
              cons_area=np.zeros((cfg.height, cfg.width), np.uint8), seed=3)
    a, ref = tpipe.generation(img, mask, coarse, tm, "a cat", return_ori=True, **kw)
    b = tpipe.generation(img, mask, coarse, tm, "a cat", **kw)
    np.testing.assert_array_equal(a, b)
    assert ref.shape == a.shape


def test_legacy_four_stream_layout_equals_deduped(pipes):
    """[u_e, u_r, c_e, c_r] with c_r == u_r gives the deduped loop's
    result (tests/test_stream_dedup.py holds the JAX loops to the same)."""
    cfg, _, tpipe = pipes
    lh, lw = cfg.latent_height, cfg.latent_width
    rng = np.random.default_rng(8)
    traj = torch.from_numpy(rng.normal(size=(K + 1, 2, lh, lw, 4)).astype(np.float32))
    emb = tpipe.encode_text(["", "a cat"])
    text3 = torch.stack([emb[0], emb[0], emb[1]])
    text4 = torch.stack([emb[0], emb[0], emb[1], emb[0]])
    m = np.zeros((cfg.height, cfg.width), np.float32)
    m[10:40, 20:50] = 1
    pyr = build_mask_pyramid(torch.from_numpy(m), lh, lw)
    _, cg, gates = method_and_gates("tca", START, 1, NUM_STEP, 0.5)
    noise = [torch.from_numpy(rng.normal(size=(2, lh, lw, 4)).astype(np.float32))
             for _ in range(K)]
    cfg_mask = torch.from_numpy((rng.random((lh, lw)) > 0.5).astype(np.float32))
    outs = []
    for text in (text3, text4):
        state = EditState(fg_retain=pyr, fg_ref=pyr, local_region=pyr)
        outs.append(sample_edit_loop(
            tpipe.unet_apply, tpipe._schedule(NUM_STEP), EditConfig(mode="edit", method="tca"),
            traj, text, state, cg, gates, cfg_mask, cfg_mask, noise, start_step=START,
            guidance_scale=7.5, eta=1.0, local_text_edit=True, local_perturbation=True,
        ))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-4, rtol=0)


def test_unported_options_raise(pipes):
    """Mesh serving is not ported.  return_intermediates and off-size
    inputs are (tests/test_torch_main_path_rest.py)."""
    _, _, tpipe = pipes
    with pytest.raises(NotImplementedError):
        tpipe.use_mesh("data=1,model=1")


def test_cuda_default_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        FreeFine(cfg_tiny())


def test_missing_params_raise_as_in_jax():
    """Without params both packages refuse to build random weights unasked."""
    with pytest.raises(ValueError, match="init_random"):
        FreeFine(cfg_tiny(), device="cpu")
    with pytest.raises(ValueError, match="init_random"):
        JFreeFine(config=jax_tiny_config())


def test_init_random_builds_the_seeded_random_weights():
    """`init_random=True` fills each component as `random_weights` does,
    seeded `seed + i` in the order unet, vae, text."""
    from freefine_tpu_torch.models.text_encoder import CLIPTextEncoder
    from freefine_tpu_torch.models.unet import UNet2DCondition
    from freefine_tpu_torch.models.vae import AutoencoderKL
    from freefine_tpu_torch.weights import random_weights

    cfg, seed = cfg_tiny(), 5
    pipe = FreeFine(cfg, init_random=True, seed=seed, device="cpu")
    want = (UNet2DCondition(cfg.unet), AutoencoderKL(cfg.vae), CLIPTextEncoder(cfg.text))
    for i, ((name, got), ref) in enumerate(zip(pipe.components().items(), want)):
        with torch.no_grad():
            random_weights(ref, seed + i)
        ref_sd, got_sd = ref.state_dict(), got.state_dict()
        assert ref_sd.keys() == got_sd.keys(), name
        for key, value in ref_sd.items():
            assert torch.equal(got_sd[key], value), f"{name}.{key}"


def cfg_tiny():
    from freefine_tpu_torch.config import tiny_pipeline_config

    return tiny_pipeline_config()
