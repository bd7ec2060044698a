"""The port's CLIP image tower (`freefine_tpu_torch.models.clip_image`)
against the JAX package: `CLIPImageEncoder`'s pooled projection and its
penultimate tokens, exact GELU (the ViT-H/14 family's) and QuickGELU
(OpenAI's B/32), and `preprocess_clip` (JAX's antialiased bicubic, shrinking
and growing).  The port's random weights, in open_clip's names, go through
`freefine_tpu.weights.convert_open_clip_vision` into flax, and back
through `state_dict_from_flax`.  Tolerance: 2e-4 of max |ref|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as JW
from freefine_tpu.models.clip_image import CLIPImageEncoder as JCLIPImage
from freefine_tpu.models.clip_image import CLIPVisionConfig as JCLIPVisionConfig
from freefine_tpu.models.clip_image import preprocess_clip as j_preprocess_clip
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.models.clip_image import (
    CLIPImageEncoder,
    CLIPVisionConfig,
    clip_vit_b32,
    clip_vit_h14,
    preprocess_clip,
)
from test_torch_depth import assert_close, np_state
from test_torch_sv3d import randomize_all, shapes_template

torch.set_num_threads(2)

TINY = dict(image_size=64, patch_size=16, hidden_size=32, intermediate_size=64, num_layers=3,
            num_heads=4, projection_dim=24)


@pytest.fixture(scope="module", params=["gelu", "quick_gelu"])
def towers(request):
    kw = dict(TINY, activation=request.param)
    model = randomize_all(CLIPImageEncoder(CLIPVisionConfig(**kw)), 3).eval()
    jmodel = JCLIPImage(JCLIPVisionConfig(**kw))
    tmpl = shapes_template(jmodel.init, (1, 64, 64, 3))
    params = JW.convert_open_clip_vision(
        tmpl, {f"visual.{k}": v for k, v in np_state(model.state_dict()).items()})
    return model, jmodel, params


@pytest.mark.parametrize("penultimate", [False, True])
def test_clip_image_encoder_matches_jax(towers, penultimate):
    model, jmodel, params = towers
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jmodel.apply, penultimate=penultimate))(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), penultimate=penultimate)
    assert got.shape == want.shape == ((2, 17, 32) if penultimate else (2, 24))
    assert_close(got, want)


def test_clip_image_round_trip(towers):
    model, _, params = towers
    sd = W.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), model)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


@pytest.mark.parametrize("hw", [(576, 576), (300, 200), (120, 180), (224, 224)])
def test_preprocess_clip_matches_jax(hw):
    img = np.random.default_rng(5).integers(0, 255, (*hw, 3), dtype=np.uint8)
    want = np.asarray(j_preprocess_clip(jnp.asarray(img)))
    got = preprocess_clip(torch.from_numpy(img))
    assert got.shape == want.shape == (1, 224, 224, 3)
    assert_close(got, want)


def test_configs_match_jax():
    from freefine_tpu.models import clip_image as J

    for mine, theirs in ((clip_vit_h14(), J.clip_vit_h14()), (clip_vit_b32(), J.clip_vit_b32())):
        fields = ("image_size", "patch_size", "hidden_size", "intermediate_size", "num_layers",
                  "num_heads", "projection_dim", "activation")
        assert all(getattr(mine, f) == getattr(theirs, f) for f in fields)
        assert mine.dtype == torch.float32 and theirs.dtype == jnp.float32
