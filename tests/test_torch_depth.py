"""The port's resampling, DINOv2 and Depth-Anything against the JAX package.

  * `ops.resize`: torch-convention bicubic (`interpolate_bicubic`) and the
    counterparts of `jax.image.resize` ("linear", "cubic"; shrinking and
    growing, antialiased and not), within 2e-4 of max |ref|.
  * DINOv2 at its native position grid and off it, Depth-Anything and
    `preprocess_depth_input`: the port's random weights go through the JAX
    converters (`convert_dinov2`; `convert_depth_anything_hf` on the
    transformers layout `hf_layout` writes), outputs
    within 2e-4 of max |ref|.  JAX's Depth-Anything converter hands flax
    the transposed-conv kernels unflipped (ROADMAP C9), so its output is
    mirrored inside each 4x4 and 2x2 upsampling block; the JAX side is
    given the flipped kernels, and a test shows the unflipped ones differ.
  * Round trips (flax -> `state_dict_from_flax` -> JAX converter gives back
    the same params), `load_depth_anything` on a transformers-layout
    safetensors file, and the ViT-L checkpoint layout
    (tests/fixtures/depth_anything_vitl_keys.txt) against the port's
    modules and against the keys the JAX converter reads.

Also home of the helpers the other perception tests import: `randomize`,
`jax_template`, `ReadKeys`, `abstract_convert`, `hf_layout`.
"""

import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as JW
from freefine_tpu.models.depth_anything import DepthAnything as JDepthAnything
from freefine_tpu.models.depth_anything import DepthAnythingConfig as JDAConfig
from freefine_tpu.models.depth_anything import depth_anything_vitl as j_depth_anything_vitl
from freefine_tpu.models.depth_anything import preprocess_depth_input as j_preprocess
from freefine_tpu.models.dinov2 import DINOv2 as JDINOv2
from freefine_tpu.models.dinov2 import DINOv2Config as JDINOv2Config
from freefine_tpu.ops.resize import interpolate_bicubic as j_interpolate_bicubic
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.models.depth_anything import (
    DepthAnything,
    DepthAnythingConfig,
    depth_anything_vitl,
    preprocess_depth_input,
)
from freefine_tpu_torch.models.dinov2 import DINOv2, DINOv2Config
from freefine_tpu_torch.models.layers import NORM_TYPES
from freefine_tpu_torch.ops.resize import interpolate_bicubic, resize

torch.set_num_threads(2)

FIXTURES = osp.join(osp.dirname(__file__), "fixtures")
TOL = 2e-4  # of max |ref|


# -- helpers ---------------------------------------------------------------------


@torch.no_grad()
def randomize(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter drawn from a numpy seed: norm weights and LayerScales
    1 + N(0, 0.1), other 1-D leaves N(0, 0.1), matrices and kernels
    N(0, 1 / fan_in), tables (tokens, position and prompt embeddings)
    N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    unit = {id(p) for m in model.modules() if isinstance(m, NORM_TYPES)
            for n, p in m.named_parameters(recurse=False) if n in ("weight", "gamma")}
    for name, p in model.named_parameters():
        if id(p) in unit:
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        elif p.ndim == 1:
            a = 0.1 * rng.standard_normal(p.shape)
        elif isinstance(model.get_submodule(name.rpartition(".")[0]),
                        (torch.nn.Linear, torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            a = rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
        else:
            a = 0.5 * rng.standard_normal(p.shape)
        p.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


def hf_layout(model: DepthAnything) -> dict:
    """A port Depth-Anything's weights in transformers'
    `DepthAnythingForDepthEstimation` layout, what `load_depth_anything`
    reads and `convert_depth_anything_hf` converts: the backbone's torchhub
    names renamed (qkv split into query, key, value), the neck and head as
    they are."""
    sd, pre = model.state_dict(), "backbone."
    hub = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    t = {k: v for k, v in sd.items() if not k.startswith(pre)}
    emb = f"{pre}embeddings."
    t.update({f"{emb}cls_token": hub["cls_token"], f"{emb}position_embeddings": hub["pos_embed"],
              f"{pre}layernorm.weight": hub["norm.weight"],
              f"{pre}layernorm.bias": hub["norm.bias"]})
    i = 0
    while f"blocks.{i}.norm1.weight" in hub:
        b, layer = f"blocks.{i}.", f"{pre}encoder.layer.{i}."
        for leaf in ("weight", "bias"):
            t[f"{emb}patch_embeddings.projection.{leaf}"] = hub[f"patch_embed.proj.{leaf}"]
            for n, part in zip(("query", "key", "value"),
                               hub[f"{b}attn.qkv.{leaf}"].chunk(3, dim=0)):
                t[f"{layer}attention.attention.{n}.{leaf}"] = part
            for hf, port in (("attention.output.dense", "attn.proj"), ("norm1", "norm1"),
                             ("norm2", "norm2"), ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
                t[f"{layer}{hf}.{leaf}"] = hub[f"{b}{port}.{leaf}"]
        t[f"{layer}layer_scale1.lambda1"] = hub[f"{b}ls1.gamma"]
        t[f"{layer}layer_scale2.lambda1"] = hub[f"{b}ls2.gamma"]
        i += 1
    return t


def np_state(sd) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()}


def jax_template(jmodel, *inputs):
    return jax.eval_shape(jmodel.init, jax.random.key(0),
                          *(jax.ShapeDtypeStruct(np.shape(x), jnp.float32) for x in inputs))


class ReadKeys(dict):
    """A tensor mapping that records every key a converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def abstract_convert(convert, template, shapes: dict):
    """Run a JAX converter over int8 stand-ins of the given shapes with its
    arrays left abstract (no full-size allocation): -> the keys it read."""
    tensors = ReadKeys({k: np.broadcast_to(np.int8(0), s) for k, s in shapes.items()})
    fake = types.SimpleNamespace(asarray=lambda a, dtype=None: jax.ShapeDtypeStruct(
        np.shape(a), dtype))
    real, JW.jnp = JW.jnp, fake
    try:
        convert(template, tensors)
    finally:
        JW.jnp = real
    return tensors.read


def manifest(name: str) -> dict:
    out = {}
    with open(osp.join(FIXTURES, name)) as f:
        for line in f:
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


def assert_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max |diff| {err:.3g} > {tol} x max |ref| {scale:.3g}"


# -- resampling ------------------------------------------------------------------


@pytest.mark.parametrize("size_in,size_out", [((14, 14), (64, 64)), ((37, 37), (40, 30)),
                                              ((64, 48), (21, 33))])
def test_interpolate_bicubic_matches_jax(size_in, size_out):
    x = np.random.default_rng(1).normal(size=(2, *size_in, 5)).astype(np.float32)
    want = np.asarray(j_interpolate_bicubic(jnp.asarray(x), size_out))
    assert_close(interpolate_bicubic(torch.from_numpy(x), size_out), want)


@pytest.mark.parametrize("method", ["linear", "cubic"])
@pytest.mark.parametrize("antialias", [True, False])
@pytest.mark.parametrize("shape_out", [(518, 518), (512, 512), (512, 300), (100, 700)])
def test_resize_matches_jax_image_resize(method, antialias, shape_out):
    """The 518 -> 512 and 512 -> 518 cases are the 3D path's (the depth
    map's linear shrink, the preprocessing's cubic growth)."""
    h, w = (518, 518) if shape_out == (512, 512) else (512, 512)
    x = np.random.default_rng(2).normal(size=(h, w, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (*shape_out, 3), method,
                                       antialias=antialias))
    assert_close(resize(torch.from_numpy(x), shape_out, method, antialias), want)


def test_resize_on_other_axes_and_identity():
    x = np.random.default_rng(3).normal(size=(1, 3, 20, 30)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 40, 30), "linear",
                                       antialias=False))
    got = resize(torch.from_numpy(x), (40, 30), "linear", antialias=False, axes=(2, 3))
    assert_close(got, want)
    assert torch.equal(resize(torch.from_numpy(x), (20, 30), "cubic", axes=(2, 3)),
                       torch.from_numpy(x))


# -- DINOv2 ----------------------------------------------------------------------

DINO = dict(dim=32, depth=3, heads=2, pos_embed_size=4)


@pytest.fixture(scope="module")
def dino():
    model = randomize(DINOv2(DINOv2Config(**DINO)), 11).eval()
    jmodel = JDINOv2(JDINOv2Config(**DINO))
    tmpl = jax_template(jmodel, np.zeros((1, 56, 56, 3)))
    apply = jax.jit(jmodel.apply, static_argnames="num_intermediate")
    return model, apply, JW.convert_dinov2(tmpl, np_state(model.state_dict()))


@pytest.mark.parametrize("hw", [(56, 56), (42, 28)], ids=["native_grid", "off_grid"])
@pytest.mark.parametrize("num_intermediate", [0, 2])
def test_dinov2_matches_jax(dino, hw, num_intermediate):
    model, apply, params = dino
    x = np.random.default_rng(4).normal(size=(2, *hw, 3)).astype(np.float32)
    want = apply(params, jnp.asarray(x), num_intermediate=num_intermediate)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2), num_intermediate=num_intermediate)
    if not num_intermediate:
        got, want = [got], [want]
    assert len(got) == len(want)
    for (gp, gc), (wp, wc) in zip(got, want):
        assert_close(gp, wp)
        assert_close(gc, wc)


def test_dinov2_round_trip(dino):
    model, _, params = dino
    back = W.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), model)
    want = model.state_dict()
    assert set(back) == set(want) and all(torch.equal(back[k], want[k]) for k in want)


# -- Depth-Anything --------------------------------------------------------------


def tiny_da_config():
    return DepthAnythingConfig(backbone=DINOv2Config(dim=32, depth=4, heads=2, pos_embed_size=4),
                               features=16, out_channels=(8, 16, 16, 32))


def tiny_jax_da_config():
    return JDAConfig(backbone=JDINOv2Config(dim=32, depth=4, heads=2, pos_embed_size=4),
                     features=16, out_channels=(8, 16, 16, 32))


def flip_deconvs(params):
    """C9: the JAX converter's Depth-Anything deconv kernels, flipped so
    flax computes torch's ConvTranspose2d."""
    head = dict(params["params"]["depth_head"])
    for name in ("resize_0", "resize_1"):
        head[name] = {**head[name], "kernel": head[name]["kernel"][::-1, ::-1]}
    return {"params": {**params["params"], "depth_head": head}}


def tiny_depth_model(seed: int = 21):
    """A random tiny Depth-Anything whose ReLU'd output is not constant
    (the final conv's bias lifted) and the JAX package's params for it."""
    model = randomize(DepthAnything(tiny_da_config()), seed).eval()
    with torch.no_grad():
        model.head.conv3.bias.add_(1.0)
    jmodel = JDepthAnything(tiny_jax_da_config())
    tmpl = jax_template(jmodel, np.zeros((1, 56, 56, 3)))
    raw = JW.convert_depth_anything_hf(tmpl, np_state(hf_layout(model)))
    return model, jax.jit(jmodel.apply), raw


@pytest.fixture(scope="module")
def depth():
    return tiny_depth_model()


def _da_input(seed, hw=(56, 56)):
    return np.random.default_rng(seed).normal(size=(1, *hw, 3)).astype(np.float32)


@pytest.mark.parametrize("hw", [(56, 56), (70, 42)], ids=["native_grid", "off_grid"])
def test_depth_anything_matches_jax(depth, hw):
    model, apply, raw = depth
    x = _da_input(5, hw)
    want = np.asarray(apply(flip_deconvs(raw), jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == want.shape == (1, *hw)
    assert want.std() > 1e-2 * np.abs(want).max()   # not a constant map
    assert_close(got, want)


def test_jax_depth_anything_converter_leaves_deconvs_mirrored(depth):
    """ROADMAP C9: with the converter's own (unflipped) kernels the JAX
    model computes another function than torch's ConvTranspose2d."""
    model, apply, raw = depth
    x = _da_input(6)
    want = np.asarray(apply(raw, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert np.abs(got - want).max() > 100 * TOL * np.abs(want).max()


def test_depth_anything_round_trip(depth):
    model, _, raw = depth
    flat = jax.tree_util.tree_map(np.asarray, raw)
    back = W.state_dict_from_flax(flat, model)
    want = model.state_dict()
    assert set(back) == set(want) and all(torch.equal(back[k], want[k]) for k in want)
    # and the converter gives the same params back
    tmpl = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), raw)
    model2 = DepthAnything(tiny_da_config())
    model2.load_state_dict(back)
    again = JW.convert_depth_anything_hf(
        tmpl, np_state(hf_layout(model2)))
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(raw)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("hw", [(100, 160), (512, 512)])
def test_preprocess_depth_input_matches_jax(hw):
    img = np.random.default_rng(7).integers(0, 256, (*hw, 3), dtype=np.uint8)
    size = 56 if hw[0] < 200 else 518
    want = np.asarray(j_preprocess(jnp.asarray(img), size=size))
    got = preprocess_depth_input(img, size=size)
    assert got.shape == (1, 3, *want.shape[1:3])
    assert_close(got.permute(0, 2, 3, 1), want)


def test_load_depth_anything_reads_the_transformers_layout(depth, tmp_path):
    model = depth[0]
    hf = hf_layout(model)
    # the two tensors a transformers checkpoint has and the forward never reads
    hf["backbone.embeddings.mask_token"] = torch.zeros(1, 32)
    for n in ("convolution1", "convolution2"):
        hf[f"neck.fusion_stage.layers.0.residual_layer1.{n}.weight"] = torch.zeros(16, 16, 3, 3)
        hf[f"neck.fusion_stage.layers.0.residual_layer1.{n}.bias"] = torch.zeros(16)
    path = str(tmp_path / "model.safetensors")
    W.write_safetensors({k: v.contiguous() for k, v in hf.items()}, path)
    fresh = W.load_depth_anything(DepthAnything(tiny_da_config()), path)
    want = model.state_dict()
    assert all(torch.equal(fresh.state_dict()[k], want[k]) for k in want)
    W.write_safetensors({**{k: v.contiguous() for k, v in hf.items()},
                         "neck.extra.weight": torch.zeros(2)}, path)
    with pytest.raises(KeyError, match="lacks"):
        W.load_depth_anything(DepthAnything(tiny_da_config()), path)


def test_depth_anything_vitl_layout():
    """The ViT-L checkpoint layout: the manifest is the port's modules'
    keys in transformers' names, it is exactly what the JAX converter
    reads, and `load_depth_anything`'s renaming maps it onto the port's
    keys one to one."""
    want = manifest("depth_anything_vitl_keys.txt")
    assert len(want) == 498
    with torch.device("meta"):
        model = DepthAnything(depth_anything_vitl())
    got = {k: tuple(v.shape) for k, v in hf_layout(model).items()}
    assert got == want
    tmpl = jax_template(JDepthAnything(j_depth_anything_vitl()), np.zeros((1, 518, 518, 3)))
    assert abstract_convert(JW.convert_depth_anything_hf, tmpl, want) == set(want)
    hub = W.hf_dinov2_to_torchhub({k: torch.empty(s, device="meta") for k, s in want.items()},
                                  "backbone.")
    renamed = {f"backbone.{k}" for k in hub} | {k for k in want if not k.startswith("backbone.")}
    assert renamed == set(model.state_dict())
