"""The port's DiffusionHandles on a UNet with 5 input channels (SD-2-depth's
layout: the latent and the edited disparity) against the JAX package's,
on `tiny_pipeline_config` with `in_channels=5` on both sides (the repo has
no SD-2-depth configuration or weights; JAX's own test widens the tiny
config the same way).

  * `state_dict_from_flax` carries the [32, 5, 3, 3] `conv_in` kernel
    across bit for bit;
  * the edited disparity (fast-marching infill of the vacated hole, the
    object's depth carried to its new pixels, the antialiased 512 -> 64
    style downsample to the grid) within 1e-5 of max |ref| of the one
    JAX's edit passed to its null-text inversion;
  * within 2e-4 of max |ref|: `null_text_invert` with the depth channel;
  * within 2e-3 absolute: the whole tiny edit's final latents (the settings
    of `test_torch_diffusion_handles.py`, the protocol's loss weights; its
    guided gradient steps read the depth channel), uint8 images within 1.  The guided latent gradient is held against `jax.grad` at 4
    channels (`test_torch_diffusion_handles.py`): a second JAX compile of
    it here would cost about 30 s of tier-1 time.
"""

import dataclasses

import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu_torch.baselines import diffusion_handles as DH
from freefine_tpu_torch.models.unet import UNet2DCondition
from freefine_tpu_torch.weights import state_dict_from_flax
from test_torch_diffusion_handles import (
    EDIT_PARAM,
    check_edit,
    check_nti,
    edit_case,
    make_pipes,
    run_edits,
)
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)


def _widen(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, in_channels=5))


@pytest.fixture(scope="module")
def pipes():
    """The tiny modules of test_torch_diffusion_handles.py with a 5-channel
    UNet: the same weights, conv_in's 5th input channel drawn anew."""
    cfg, mods = tiny_modules(83)
    cfg5, jcfg5 = _widen(cfg), _widen(jax_tiny_config())
    unet5 = UNet2DCondition(cfg5.unet)
    sd = mods["unet"].state_dict()
    w = sd["conv_in.weight"]
    gen = torch.Generator().manual_seed(7)
    extra = 0.02 * torch.randn(w.shape[0], 1, *w.shape[2:], generator=gen)
    sd["conv_in.weight"] = torch.cat([w, extra], dim=1)
    unet5.load_state_dict(sd)
    mods["unet"] = unet5
    jpipe, tpipe = make_pipes(mods, cfg5, jcfg5)
    return cfg5, jcfg5, jpipe, tpipe


@pytest.fixture(scope="module")
def edits(pipes):
    return run_edits(pipes[2], pipes[3])


def test_five_channel_conv_in_carries_across(pipes):
    cfg5, jcfg5, _, tpipe = pipes
    unet = tpipe.unet
    assert unet.conv_in.weight.shape == (32, 5, 3, 3)
    tree = jax_params(unet, "unet", jcfg5)
    back = state_dict_from_flax(tree, unet)
    for k, v in unet.state_dict().items():
        assert torch.equal(back[k], v), k
    assert DH.DiffusionHandles(tpipe).use_depth


def test_edited_disparity_matches_jax(pipes, edits):
    _, _, _, tpipe = pipes
    (_, kw, _), = edits["nti"]
    want = np.asarray(kw["depth_ch"])
    cfg = tpipe.config
    _, depth, mask = edit_case(cfg.height, cfg.width)
    m01 = mask > 0
    corr_map = DH.compute_correspondence(depth, m01, EDIT_PARAM, device="cpu")
    got = DH.DiffusionHandles(tpipe).edited_disparity(depth, m01, corr_map)
    assert got.shape == want.shape == (1, cfg.latent_height, cfg.latent_width, 1)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_null_text_invert_with_depth_matches_jax(pipes, edits):
    (_, kw, _), = edits["nti"]
    assert kw["depth_ch"] is not None
    check_nti(pipes[3], edits)


def test_diffusion_handles_depth_edit_matches_jax(pipes, edits):
    cfg5 = pipes[0]
    check_edit(edits, (cfg5.height, cfg5.width, 3))
