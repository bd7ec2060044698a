"""Model parity: the port's UNet / VAE / text encoder against the JAX
package on the tiny config, float32 on the CPU, same weights (carried
through `freefine_tpu.weights.convert_*`).

Tolerance: 2e-4 absolute on outputs of order 1 — float32 on both sides,
differing only in summation order (XLA vs ATen) across ~40 layers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.edit import build_mask_pyramid as j_build_mask_pyramid
from freefine_tpu.models.text_encoder import CLIPTextEncoder as JText
from freefine_tpu.models.unet import UNet2DCondition as JUNet
from freefine_tpu.models.vae import AutoencoderKL as JVAE
from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_pyramid
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

ATOL = 2e-4


@pytest.fixture(scope="module")
def setup():
    cfg, mods = tiny_modules(11)
    return cfg, jax_tiny_config(), mods


def _edit_inputs(cfg):
    rng = np.random.default_rng(5)
    lh, lw = cfg.latent_height, cfg.latent_width
    sample = rng.normal(size=(3, lh, lw, 4)).astype(np.float32)
    ctx = rng.normal(size=(3, 77, cfg.unet.cross_attention_dim)).astype(np.float32)
    fg_retain = np.zeros((cfg.height, cfg.width), np.float32)
    fg_retain[20:44, 16:40] = 1
    fg_ref = np.zeros((cfg.height, cfg.width), np.float32)
    fg_ref[8:30, 24:52] = 1
    return sample, ctx, fg_retain, fg_ref


@pytest.mark.parametrize("mode", ["none", "edit"])
def test_unet_matches_jax(setup, mode):
    cfg, jcfg, mods = setup
    sample, ctx, fg_retain, fg_ref = _edit_inputs(cfg)
    lh, lw = cfg.latent_height, cfg.latent_width
    t = 501
    jparams = jax_params(mods["unet"], "unet", jcfg)
    jkw, tkw = {}, {}
    if mode == "edit":
        cg = 0.625
        jkw = dict(
            edit_cfg=JEditConfig(mode="edit", method="tca"),
            edit_state=JEditState(
                fg_retain=j_build_mask_pyramid(jnp.asarray(fg_retain), lh, lw),
                fg_ref=j_build_mask_pyramid(jnp.asarray(fg_ref), lh, lw),
                local_region=j_build_mask_pyramid(jnp.asarray(fg_retain), lh, lw),
                context_guidance=jnp.float32(cg),
            ),
        )
        tkw = dict(
            edit_cfg=EditConfig(mode="edit", method="tca"),
            edit_state=EditState(
                fg_retain=build_mask_pyramid(torch.from_numpy(fg_retain), lh, lw),
                fg_ref=build_mask_pyramid(torch.from_numpy(fg_ref), lh, lw),
                local_region=build_mask_pyramid(torch.from_numpy(fg_retain), lh, lw),
                context_guidance=cg,
            ),
        )
    want = JUNet(config=jcfg.unet).apply(
        jparams, jnp.asarray(sample), jnp.int32(t), jnp.asarray(ctx), **jkw
    )
    with torch.no_grad():
        got = mods["unet"](torch.from_numpy(sample).permute(0, 3, 1, 2), t,
                           torch.from_numpy(ctx), **tkw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_unet_edit_differs_from_none(setup):
    """The edit path is live: TCA changes the output of the edit streams."""
    cfg, _, mods = setup
    sample, ctx, fg_retain, fg_ref = _edit_inputs(cfg)
    lh, lw = cfg.latent_height, cfg.latent_width
    x = torch.from_numpy(sample).permute(0, 3, 1, 2)
    state = EditState(
        fg_retain=build_mask_pyramid(torch.from_numpy(fg_retain), lh, lw),
        fg_ref=build_mask_pyramid(torch.from_numpy(fg_ref), lh, lw),
        local_region=build_mask_pyramid(torch.from_numpy(fg_retain), lh, lw),
        context_guidance=1.0,
    )
    with torch.no_grad():
        a = mods["unet"](x, 501, torch.from_numpy(ctx))
        b = mods["unet"](x, 501, torch.from_numpy(ctx),
                         edit_cfg=EditConfig(mode="edit", method="tca"), edit_state=state)
    assert float((a - b).abs().max()) > 1e-3


def test_vae_encode_decode_match_jax(setup):
    cfg, jcfg, mods = setup
    rng = np.random.default_rng(9)
    img = rng.uniform(-1, 1, size=(2, cfg.height, cfg.width, 3)).astype(np.float32)
    jp = jax_params(mods["vae"], "vae", jcfg)
    jvae = JVAE(config=jcfg.vae)
    want_z = jvae.apply(jp, jnp.asarray(img), method=jvae.encode)
    want_x = jvae.apply(jp, want_z, method=jvae.decode)
    with torch.no_grad():
        got_z = mods["vae"].encode(torch.from_numpy(img))
        got_x = mods["vae"].decode(torch.from_numpy(np.array(want_z)))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL, rtol=0)


def test_text_encoder_matches_jax(setup):
    cfg, jcfg, mods = setup
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.text.vocab_size, size=(2, 77)).astype(np.int32)
    want = JText(config=jcfg.text).apply(jax_params(mods["text"], "text", jcfg),
                                         jnp.asarray(ids))
    with torch.no_grad():
        got = mods["text"](torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_unet_features_match_jax(setup):
    """`return_features=True`: (eps, [mid, up_0 .. up_3]), each up-block
    feature after its upsampler, as the JAX UNet returns them (NHWC there,
    NCHW here).  Features within 1e-4 of max(1, max|ref|)."""
    cfg, jcfg, mods = setup
    sample, ctx, _, _ = _edit_inputs(cfg)
    sample, ctx = sample[:1], ctx[:1]
    want_eps, want = JUNet(config=jcfg.unet).apply(
        jax_params(mods["unet"], "unet", jcfg), jnp.asarray(sample), jnp.int32(301),
        jnp.asarray(ctx), return_features=True)
    with torch.no_grad():
        eps, feats = mods["unet"](torch.from_numpy(sample).permute(0, 3, 1, 2), 301,
                                  torch.from_numpy(ctx), return_features=True)
    assert len(feats) == len(want) == len(cfg.unet.block_out_channels) + 1
    np.testing.assert_allclose(eps.permute(0, 2, 3, 1).numpy(), np.asarray(want_eps), atol=ATOL,
                               rtol=0)
    for got, ref in zip(feats, want):
        ref = np.asarray(ref)
        assert got.permute(0, 2, 3, 1).shape == ref.shape
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                                   atol=1e-4 * max(1.0, np.abs(ref).max()), rtol=0)
