"""The SDXL (and SD-2.1) modules of the port against the JAX package's.

On `tiny_sdxl_pipeline_config`, with the port's random weights carried into
JAX through the JAX package's own converters (`_convert_tree` with
`_SDXL_UNET_REWRITES`, `convert_vae`, `convert_text_encoder`,
`convert_sdxl_text2`) and the same numpy inputs on both sides:

  * the UNet forward with `added_cond` (linear projections, added
    conditioning, mixed transformer depths);
  * the penultimate CLIP tower and `OpenCLIPTextHidden` (hidden and pooled);
  * `SDXLFreeFine._encode_dual` and `_added_cond`;
  * SD-2.1's shape (heads of a fixed dim, linear projections, the gelu text
    tower) on a tiny SD-2.1-shaped config: UNet forward and text encoder.

Tolerance: `tests/test_torch_models.py`'s ATOL 2e-4 (float32 on both
sides; summation order only).

Also: the port's flax round trip of the SDXL trees bit for bit, the full
SDXL and SD-2.1 key manifests (modules built on the meta device) against
the committed fixtures, the OpenCLIP tower's keys in transformers'
`CLIPTextModelWithProjection` names, `_layer_range` (44, 70) and the
per-level heads (5, 10, 20) at full size, and a `load_sdxl` round trip
through a diffusers directory written by the port's own writer.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as W
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.config import tiny_sdxl_pipeline_config as jax_tiny_sdxl_config
from freefine_tpu_torch.config import (
    open_clip_text_bigg,
    sd21_pipeline_config,
    sdxl_pipeline_config,
    tiny_pipeline_config,
    tiny_sdxl_pipeline_config,
)
from freefine_tpu_torch.models.open_clip_text import OpenCLIPTextHidden
from freefine_tpu_torch.models.text_encoder import CLIPTextEncoder
from freefine_tpu_torch.models.unet import UNet2DCondition
from freefine_tpu_torch.models.vae import AutoencoderKL
from freefine_tpu_torch.sdxl import SDXLFreeFine
from freefine_tpu_torch.weights import (
    _templates,
    load_sdxl,
    random_weights,
    save_pipeline,
    state_dict_from_flax,
    write_safetensors,
)
import chip_smoke
from freefine_tpu_torch.models.layers import GroupNorm32
from freefine_tpu_torch.ops import flash_attention as FA
from test_torch_weights import FIXTURES, cached_shapes, torch_tensors

torch.set_num_threads(2)

ATOL = 2e-4
KEY = jax.random.key(0)


# -- carry-across helpers (the SDXL pipeline tests import them) ---------------


def sdxl_modules(seed: int = 0):
    """Tiny-SDXL torch UNet / VAE / text towers on the CPU, every leaf
    random (biases and norms too, so the carry-across covers each)."""
    cfg = tiny_sdxl_pipeline_config()
    mods = {"unet": UNet2DCondition(cfg.unet), "vae": AutoencoderKL(cfg.vae),
            "text": CLIPTextEncoder(cfg.text), "text2": OpenCLIPTextHidden(cfg.text2)}
    g = torch.Generator().manual_seed(seed + 100)
    for i, m in enumerate(mods.values()):
        random_weights(m, seed + i)
        with torch.no_grad():
            for p in m.parameters():
                if p.ndim == 1:
                    p.add_(0.02 * torch.randn(p.shape, generator=g))
    return cfg, mods


def jax_sdxl_template(kind: str, jcfg):
    """Shape tree of the JAX SDXL module's params (no weight allocation),
    traced once per kind and config (`cached_shapes`)."""
    return cached_shapes(f"sdxl-{kind}", (kind, jcfg), lambda: _trace_sdxl_template(kind, jcfg))


def _trace_sdxl_template(kind: str, jcfg):
    from freefine_tpu.models.open_clip_text import OpenCLIPTextHidden as JText2
    from freefine_tpu.models.text_encoder import CLIPTextEncoder as JText
    from freefine_tpu.models.unet import UNet2DCondition as JUNet
    from freefine_tpu.models.vae import AutoencoderKL as JVAE

    ids = jax.ShapeDtypeStruct((1, 77), jnp.int32)
    if kind == "unet":
        c = jcfg.unet
        return jax.eval_shape(
            lambda k: JUNet(config=c).init(
                k, jnp.zeros((1, jcfg.latent_height, jcfg.latent_width, c.in_channels), c.dtype),
                jnp.int32(1), jnp.zeros((1, 77, c.cross_attention_dim), c.dtype),
                added_cond=(None if c.addition_embed_dim is None
                            else jnp.zeros((1, c.addition_embed_dim), c.dtype))), KEY)
    if kind == "vae":
        return jax.eval_shape(JVAE(config=jcfg.vae).init, KEY,
                              jax.ShapeDtypeStruct((1, jcfg.height, jcfg.width, 3), jnp.float32))
    if kind == "text":
        penultimate = jcfg.text2 is not None
        return jax.eval_shape(lambda k, i: JText(config=jcfg.text).init(
            k, i, penultimate=penultimate), KEY, ids)
    return jax.eval_shape(JText2(config=jcfg.text2).init, KEY, ids,
                          jax.ShapeDtypeStruct((1,), jnp.int32))


def jax_sdxl_params(module: torch.nn.Module, kind: str, jcfg=None):
    """The JAX package's params holding `module`'s weights (float32),
    through the JAX package's own SDXL converters."""
    jcfg = jcfg or jax_tiny_sdxl_config()
    tmpl, tensors = jax_sdxl_template(kind, jcfg), torch_tensors(module)
    if kind == "unet":
        return {"params": W._convert_tree(tmpl["params"], tensors,
                                          key_rewrites=W._SDXL_UNET_REWRITES)}
    conv = {"vae": W.convert_vae, "text": W.convert_text_encoder,
            "text2": W.convert_sdxl_text2}[kind]
    return conv(tmpl, tensors)


def tiny_sd21(base):
    """SD-2.1's shape on the tiny config (either package's): heads of 16
    per level (2, 4, 8, 8), linear projections, the gelu text tower."""
    return dataclasses.replace(
        base, unet=dataclasses.replace(base.unet, head_dim=16, use_linear_projection=True),
        text=dataclasses.replace(base.text, activation="gelu"))


@pytest.fixture(scope="module")
def xl():
    cfg, mods = sdxl_modules(5)
    jcfg = jax_tiny_sdxl_config()
    return cfg, jcfg, mods, {k: jax_sdxl_params(m, k, jcfg) for k, m in mods.items()}


def _ids(rng, b, vocab, eot):
    ids = rng.integers(2, vocab, (b, 77)).astype(np.int32)
    for row, e in zip(ids, eot):
        row[e] = 1
        row[e + 1:] = 0
    return ids


# -- the modules against JAX --------------------------------------------------


def test_unet_forward_with_added_cond_matches_jax(xl):
    from freefine_tpu.models.unet import UNet2DCondition as JUNet

    cfg, jcfg, mods, jp = xl
    rng = np.random.default_rng(1)
    lh, lw = cfg.latent_height, cfg.latent_width
    sample = rng.normal(size=(2, lh, lw, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, cfg.unet.cross_attention_dim)).astype(np.float32)
    added = rng.normal(size=(2, cfg.unet.addition_embed_dim)).astype(np.float32)
    want = np.asarray(jax.jit(JUNet(config=jcfg.unet).apply)(jp["unet"], sample, jnp.int32(501),
                                                             ctx, added_cond=added))
    with torch.no_grad():
        got = mods["unet"](torch.from_numpy(sample).permute(0, 3, 1, 2), 501,
                           torch.from_numpy(ctx), added_cond=torch.from_numpy(added))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)
    # the added conditioning is live, and a config that has it requires it
    with torch.no_grad():
        other = mods["unet"](torch.from_numpy(sample).permute(0, 3, 1, 2), 501,
                             torch.from_numpy(ctx), added_cond=torch.zeros(2, added.shape[1]))
        assert (other - got).abs().max() > 100 * ATOL
        with pytest.raises(ValueError):
            mods["unet"](torch.from_numpy(sample).permute(0, 3, 1, 2), 501, torch.from_numpy(ctx))


def test_penultimate_clip_tower_matches_jax(xl):
    from freefine_tpu.models.text_encoder import CLIPTextEncoder as JText

    cfg, jcfg, mods, jp = xl
    assert len(mods["text"].text_model.encoder.layers) == cfg.text.num_layers - 1
    assert not hasattr(mods["text"].text_model, "final_layer_norm")
    ids = _ids(np.random.default_rng(2), 3, cfg.text.vocab_size, [5, 9, 76])
    want = np.asarray(jax.jit(functools.partial(JText(config=jcfg.text).apply, penultimate=True))(
        jp["text"], ids))
    with torch.no_grad():
        got = mods["text"](torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_open_clip_tower_matches_jax(xl):
    from freefine_tpu.models.open_clip_text import OpenCLIPTextHidden as JText2

    cfg, jcfg, mods, jp = xl
    eot = np.array([3, 11, 76], np.int32)
    ids = _ids(np.random.default_rng(3), 3, cfg.text2.vocab_size, eot)
    want_h, want_p = jax.jit(JText2(config=jcfg.text2).apply)(jp["text2"], ids, eot)
    with torch.no_grad():
        got_h, got_p = mods["text2"](torch.from_numpy(ids).long(), torch.from_numpy(eot).long())
    assert got_h.shape == (3, 77, cfg.text2.width)
    assert got_p.shape == (3, cfg.text2.projection_dim)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL, rtol=0)


def test_encode_dual_and_added_cond_match_jax(xl):
    from freefine_tpu.sdxl import SDXLFreeFine as JSDXL

    cfg, jcfg, mods, jp = xl
    jpipe = JSDXL(config=jcfg, params=jp)
    tpipe = SDXLFreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    texts = ["", "a cat on a mat", "a dog"]
    ids = np.asarray(tpipe.tokenizer.batch_encode(texts))
    for a, b in zip(tpipe._openclip_ids(ids), jpipe._openclip_ids(ids)):
        np.testing.assert_array_equal(a, b)
    want_ctx, want_pooled = jpipe._encode_dual(texts)
    ctx, pooled = tpipe._encode_dual(texts)
    assert ctx.shape == (3, 77, cfg.unet.cross_attention_dim) and ctx.dtype == torch.float32
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=ATOL, rtol=0)
    added = tpipe._added_cond(pooled)
    assert added.shape == (3, cfg.unet.addition_embed_dim)
    np.testing.assert_allclose(added.numpy(), np.asarray(jpipe._added_cond(jnp.asarray(
        pooled.numpy()))), atol=ATOL, rtol=0)
    # the hooks the entry points read: context and added conditioning per row
    edit = tpipe._edit_text_embeddings("a cat on a mat")
    assert edit.lead == (3,) and torch.equal(edit.ctx[0], edit.ctx[1])
    np.testing.assert_allclose(edit.added[2].numpy(), added[1].numpy(), atol=1e-6, rtol=0)


def test_sdxl_flax_trees_round_trip(xl):
    """The JAX package's SDXL params of the port's weights come back
    through the port's `state_dict_from_flax` bit for bit."""
    _, _, mods, jp = xl
    for kind in ("unet", "text", "text2"):
        back = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp[kind]), mods[kind])
        want = mods[kind].state_dict()
        assert set(back) == set(want), kind
        for k, v in want.items():
            assert torch.equal(back[k], v), (kind, k)


@pytest.mark.parametrize("use_linear", [True, False])
def test_sd21_shape_matches_jax(use_linear):
    """SD-2.1's shape on a tiny config: heads of 16 per level (2, 4, 8, 8),
    the gelu text tower; with linear and with 1x1-conv projections."""
    from freefine_tpu.models.text_encoder import CLIPTextEncoder as JText
    from freefine_tpu.models.unet import UNet2DCondition as JUNet
    from test_torch_weights import jax_params

    cfg, jcfg = tiny_sd21(tiny_pipeline_config()), tiny_sd21(jax_tiny_config())
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, use_linear_projection=use_linear))
    jcfg = dataclasses.replace(jcfg, unet=dataclasses.replace(
        jcfg.unet, use_linear_projection=use_linear))
    assert [cfg.unet.heads(level) for level in range(4)] == [2, 4, 8, 8]
    unet, text = UNet2DCondition(cfg.unet), CLIPTextEncoder(cfg.text)
    g = torch.Generator().manual_seed(9)
    for i, m in enumerate((unet, text)):
        random_weights(m, 30 + i)
        with torch.no_grad():
            for p in m.parameters():
                if p.ndim == 1:
                    p.add_(0.02 * torch.randn(p.shape, generator=g))
    rng = np.random.default_rng(4)
    sample = rng.normal(size=(2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, cfg.unet.cross_attention_dim)).astype(np.float32)
    want = np.asarray(jax.jit(JUNet(config=jcfg.unet).apply)(jax_params(unet, "unet", jcfg),
                                                             sample, jnp.int32(301), ctx))
    with torch.no_grad():
        got = unet(torch.from_numpy(sample).permute(0, 3, 1, 2), 301, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)
    ids = _ids(rng, 2, cfg.text.vocab_size, [4, 30])
    want = np.asarray(jax.jit(JText(config=jcfg.text).apply)(jax_params(text, "text", jcfg), ids))
    with torch.no_grad():
        got = text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# -- what the card's checks count on ---------------------------------------------


@pytest.mark.parametrize("kind", ["unet", "vae_encode", "vae_decode"])
def test_chip_smoke_norm_calls_are_the_sdxl_modules(xl, kind, monkeypatch):
    """`chip_smoke.norm_calls` (from which phase G-XL works out its
    GroupNorm launches and phase 2 its shapes) lists exactly the calls the
    SDXL modules make."""
    monkeypatch.setenv("FREEFINE_FUSED_GN", "0")
    cfg, _, mods, _ = xl
    seen = []

    def hook(mod, args, kwargs):
        seen.append((tuple(args[0].shape[1:]), mod.num_groups, mod.eps,
                     bool(kwargs.get("silu", args[1] if len(args) > 1 else False))))

    model = mods["unet"] if kind == "unet" else mods["vae"]
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, GroupNorm32)]
    lh, lw = cfg.latent_height, cfg.latent_width
    with torch.no_grad():
        if kind == "unet":
            model(torch.zeros(2, 4, lh, lw), 11, torch.zeros(2, 77, cfg.unet.cross_attention_dim),
                  added_cond=torch.zeros(2, cfg.unet.addition_embed_dim))
        elif kind == "vae_encode":
            model.encode(torch.zeros(2, cfg.height, cfg.width, 3))
        else:
            model.decode(torch.zeros(2, lh, lw, 4))
    for hd in handles:
        hd.remove()
    assert seen == [((c, h, w), g, eps, silu)
                    for c, h, w, g, eps, silu in chip_smoke.norm_calls(cfg, kind)]


def test_sdxl_attention_shapes_take_the_hopper_routes():
    """Heads of 64 in bf16 take the wgmma kernels of rows 1 and 2 (their
    d 64 instantiations); the VAE's f32 head of 512 the split-TF32 route."""
    assert FA.FLASH_ROUTES[FA.flash_route(torch.bfloat16, 64)] == "bf16_wgmma"
    assert FA.FLASH_ROUTES[FA.flash_route(torch.float32, 512)] == "f32_tf32x3"
    assert 64 <= FA._MAX_HEAD_DIM["tca_flash"][torch.bfloat16]
    shapes = {(s, h * 64) for _, h, s, *_ in chip_smoke.XL_FLASH_SHAPES[:4]}
    assert shapes == {(4096, 640), (1024, 1280)}


# -- full-size structure --------------------------------------------------------


def _manifest(name):
    out = {}
    with open(os.path.join(FIXTURES, name)) as f:
        for line in f:
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name, cfg_fn, part", [
    ("sdxl_unet_keys.txt", sdxl_pipeline_config, "unet"),
    ("sd21_unet_keys.txt", sd21_pipeline_config, "unet"),
    ("sd21_text_keys.txt", sd21_pipeline_config, "text"),
])
def test_full_size_keys_match_manifests(name, cfg_fn, part):
    got = _shapes(_templates(cfg_fn())[part])
    want = _manifest(name)
    assert sorted(set(want) - set(got)) == [] and sorted(set(got) - set(want)) == []
    assert {k: v for k, v in got.items() if want[k] != v} == {}


def test_open_clip_bigg_keys_are_transformers_names():
    cfg = open_clip_text_bigg()
    got = _shapes(_templates(dataclasses.replace(sdxl_pipeline_config(), text2=cfg))["text2"])
    w, pre = cfg.width, "text_model."
    want = {f"{pre}embeddings.token_embedding.weight": (cfg.vocab_size, w),
            f"{pre}embeddings.position_embedding.weight": (cfg.context_length, w),
            f"{pre}final_layer_norm.weight": (w,), f"{pre}final_layer_norm.bias": (w,),
            "text_projection.weight": (cfg.projection_dim, w)}
    for i in range(cfg.layers):
        base = f"{pre}encoder.layers.{i}."
        for p in ("q", "k", "v", "out"):
            want[f"{base}self_attn.{p}_proj.weight"] = (w, w)
            want[f"{base}self_attn.{p}_proj.bias"] = (w,)
        for n in ("layer_norm1", "layer_norm2"):
            want[f"{base}{n}.weight"] = want[f"{base}{n}.bias"] = (w,)
        want[f"{base}mlp.fc1.weight"], want[f"{base}mlp.fc1.bias"] = (4 * w, w), (4 * w,)
        want[f"{base}mlp.fc2.weight"], want[f"{base}mlp.fc2.bias"] = (w, 4 * w), (w,)
    assert got == want


def test_full_size_layer_range_and_heads():
    """`SDXLFreeFine` at `sdxl_pipeline_config`, built on the meta device
    (its templates as params): TCA's window is the reference's 10-of-16
    start as the same decoder fraction of 70 depth-weighted layers, and
    each level's heads are its channels over 64."""
    cfg = sdxl_pipeline_config()
    pipe = SDXLFreeFine(cfg, params=_templates(cfg), device="meta")
    assert cfg.unet.attn_layer_layout == (70, 34)
    assert pipe._layer_range == (44, 70)
    assert [cfg.unet.heads(level) for level in range(3)] == [5, 10, 20]
    u = pipe.unet
    assert u.down_blocks[1].attentions[0].transformer_blocks[0].attn1.heads == 10
    assert len(u.mid_block.attentions[0].transformer_blocks) == 10
    assert u.mid_block.attentions[0].transformer_blocks[9].attn2.heads == 20
    assert u.up_blocks[1].attentions[2].transformer_blocks[1].attn1.heads == 10
    assert isinstance(u.down_blocks[1].attentions[0].proj_in, torch.nn.Linear)


def test_load_sdxl_round_trip(tmp_path):
    """A tiny SDXL pipe written in the diffusers layout by the port's own
    writer reads back bit for bit; a first tower written whole (its last
    layer and final LayerNorm, as a diffusers SDXL `text_encoder/` holds
    them) loads with those tensors ignored."""
    cfg, mods = sdxl_modules(7)
    pipe = SDXLFreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    save_pipeline(pipe, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["text_encoder", "text_encoder_2", "unet", "vae"]
    full = CLIPTextEncoder(dataclasses.replace(cfg.text, penultimate=False))
    random_weights(full, 3)
    text = {**full.state_dict(), **mods["text"].state_dict()}
    write_safetensors(text, str(tmp_path / "text_encoder" / "model.safetensors"))
    for src in (cfg, pipe):
        params = load_sdxl(src, str(tmp_path))
        assert sorted(params) == ["text", "text2", "unet", "vae"]
        for name, mod in mods.items():
            want = mod.state_dict()
            assert set(params[name]) == set(want), name
            for k, v in want.items():
                assert params[name][k].dtype == v.dtype and torch.equal(params[name][k], v), k
    with pytest.raises(ValueError):
        load_sdxl(tiny_pipeline_config(), str(tmp_path))
