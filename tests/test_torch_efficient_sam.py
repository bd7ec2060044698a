"""The port's EfficientSAM against the JAX package
(`freefine_tpu.models.efficient_sam`).

The port's random weights (seeded with numpy) go through
`freefine_tpu.weights.convert_efficient_sam` into flax.  Masks and IoUs
within 2e-4 of max |ref|, in the same order (the IoU sort is stable on
both sides); `segment_with_box` equal except at <= 0.1 % of the pixels.
Also the round trip flax -> `state_dict_from_flax` -> converter,
`load_efficient_sam` on a `torch.save`d {"model": state_dict}, and the
ViT-S checkpoint layout (tests/fixtures/efficient_sam_vits_keys.txt)
against the port's modules and the keys the JAX converter reads.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as JW
from freefine_tpu.models.efficient_sam import EfficientSAM as JEfficientSAM
from freefine_tpu.models.efficient_sam import EfficientSAMConfig as JConfig
from freefine_tpu.models.efficient_sam import efficient_sam_vits as j_vits
from freefine_tpu.models.efficient_sam import segment_with_box as j_segment_with_box
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.models.efficient_sam import (
    EfficientSAM,
    EfficientSAMConfig,
    efficient_sam_vits,
    segment_with_box,
)
from test_torch_depth import abstract_convert, assert_close, jax_template, manifest, np_state
from test_torch_depth import randomize

torch.set_num_threads(2)

TINY = dict(img_size=64, patch_size=16, patch_embed_dim=32, depth=2, num_heads=2, neck_dim=32,
            decoder_mlp_dim=64, decoder_heads=2, upscaling_dims=(16, 8), iou_hidden_dim=16)


@pytest.fixture(scope="module")
def sam():
    model = randomize(EfficientSAM(EfficientSAMConfig(**TINY)), 31).eval()
    jmodel = JEfficientSAM(JConfig(**TINY))
    tmpl = jax_template(jmodel, np.zeros((1, 64, 64, 3)), np.zeros((1, 1, 2, 2)),
                        np.ones((1, 1, 2)))
    params = JW.convert_efficient_sam(tmpl, np_state(model.state_dict()))
    return model, jmodel, params, jax.jit(jmodel.apply)


def _prompts(kind):
    if kind == "box":
        return (np.asarray([[[[10.0, 12.0], [40.0, 44.0]]]], np.float32),
                np.asarray([[[2.0, 3.0]]], np.float32))
    # two queries: one point, and three points with a padding label
    pts = np.asarray([[[[20.0, 30.0], [0, 0], [0, 0]], [[5.0, 9.0], [50.0, 41.0], [-1, -1]]]],
                     np.float32)
    lbl = np.asarray([[[1.0, -1.0, -1.0], [1.0, 1.0, -1.0]]], np.float32)
    return pts, lbl


@pytest.mark.parametrize("prompt", ["box", "points"])
@pytest.mark.parametrize("hw", [(64, 64), (48, 80)], ids=["encoder_size", "resized"])
def test_efficient_sam_matches_jax(sam, prompt, hw):
    model, _, params, apply = sam
    img = np.random.default_rng(3).random((1, *hw, 3)).astype(np.float32)
    pts, lbl = _prompts(prompt)
    want_m, want_iou = apply(params, jnp.asarray(img), jnp.asarray(pts), jnp.asarray(lbl))
    with torch.no_grad():
        got_m, got_iou = model(torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(pts),
                               torch.from_numpy(lbl))
    assert_close(got_iou, want_iou)
    assert_close(got_m, want_m)
    assert np.array_equal(np.argsort(-got_iou.numpy(), axis=-1, kind="stable"),
                          np.argsort(-np.asarray(want_iou), axis=-1, kind="stable"))


def test_segment_with_box_matches_jax(sam):
    model, _, params, apply = sam
    img = np.random.default_rng(4).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    box = (20, 15, 80, 70)
    want = j_segment_with_box(types.SimpleNamespace(apply=apply), params, img, box)
    got = segment_with_box(model, img, box)
    assert got.shape == want.shape == (90, 120) and got.dtype == np.uint8
    assert 0 < (want > 0).mean() < 1
    assert ((got > 0) != (want > 0)).mean() <= 1e-3


def test_efficient_sam_round_trip_and_loader(sam, tmp_path):
    model, _, params, _ = sam
    flat = jax.tree_util.tree_map(np.asarray, params)
    back = W.state_dict_from_flax(flat, model)
    want = model.state_dict()
    assert set(back) == set(want) and all(torch.equal(back[k], want[k]) for k in want)
    tmpl = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    again = JW.convert_efficient_sam(tmpl, np_state(back))
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    path = str(tmp_path / "efficient_sam_tiny.pt")
    torch.save({"model": want}, path)
    fresh = W.load_efficient_sam(EfficientSAM(EfficientSAMConfig(**TINY)), path)
    assert all(torch.equal(fresh.state_dict()[k], want[k]) for k in want)


def test_efficient_sam_vits_layout():
    want = manifest("efficient_sam_vits_keys.txt")
    assert len(want) == 278
    with torch.device("meta"):
        model = EfficientSAM(efficient_sam_vits())
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    tmpl = jax_template(JEfficientSAM(j_vits()), np.zeros((1, 1024, 1024, 3)),
                        np.zeros((1, 1, 2, 2)), np.ones((1, 1, 2)))
    assert abstract_convert(JW.convert_efficient_sam, tmpl, want) == set(want)
