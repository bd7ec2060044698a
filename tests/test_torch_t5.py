"""The PixArt caption tower and checkpoint layout of the port
(`models/t5.py`, `FreeFine.encode_text`'s T5 branch, `weights.load_pixart`,
the PixArt layout of `save_pipeline` / `load_pipeline_params`) against the
JAX package's, on the CPU.

  * `_relative_position_bucket` equals JAX's bit for bit;
  * `T5Encoder` (tiny, with a padding mask) within 2e-4 of JAX's, weights
    carried by JAX's `convert_t5_encoder` (and its tree carried back by
    `state_dict_from_flax` bit for bit);
  * the T5 `RMSNorm` is a norm of `random_weights` (weight 1): a random
    tower's output is not zero;
  * ROADMAP C8, JAX's key-mask rule copied: `ids != 0`, which under the
    hash tokenizer (bos 0, padding eos 1) masks the bos and keeps the
    padding; the port's `encode_text` equals JAX's on the tiny PixArt
    config;
  * `load_pixart` on a tiny diffusers directory in `tmp_path` (T5 in two
    shards, diffusers' extra tensors present) gives JAX's `load_pixart`
    tensors, also with `.fp16` variant files beside the full ones (JAX's
    merge: a later file wins); a missing or misshapen tensor raises; the
    PixArt layout's
    `save_pipeline` / `load_pipeline_params` round trip bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from freefine_tpu import weights as W
from freefine_tpu.config import tiny_pixart_pipeline_config as jax_tiny_pixart_config
from freefine_tpu_torch import pipeline as P
from freefine_tpu_torch.config import tiny_pixart_pipeline_config, tiny_pipeline_config
from freefine_tpu_torch.models.layers import NORM_TYPES, RMSNorm
from freefine_tpu_torch.models.t5 import T5Encoder, _relative_position_bucket
from freefine_tpu_torch.weights import (
    load_pipeline_params,
    load_pixart,
    random_weights,
    read_safetensors_dir,
    save_pipeline,
    state_dict_from_flax,
    write_safetensors,
)
from test_torch_dit import dit_modules, jax_dit_params, jax_pipe

torch.set_num_threads(2)

ATOL = 2e-4


def test_relative_position_bucket_equals_jax():
    from freefine_tpu.models.t5 import _relative_position_bucket as j_bucket

    rel = np.arange(-300, 301)[None, :] - np.arange(0, 9)[:, None] * 37
    for buckets, dist in ((32, 128), (16, 64), (8, 20)):
        got = _relative_position_bucket(rel, buckets, dist)
        np.testing.assert_array_equal(got, j_bucket(rel, buckets, dist))
        assert got.min() >= 0 and got.max() < buckets


@pytest.fixture(scope="module")
def t5():
    cfg, jcfg = tiny_pixart_pipeline_config(), jax_tiny_pixart_config()
    mod = T5Encoder(cfg.text)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():  # weights of order one: a live comparison
        for p in mod.parameters():
            p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g) if p.ndim == 1
                    else 0.3 * torch.randn(p.shape, generator=g))
    return cfg, jcfg, mod, jax_dit_params(mod, "t5", jcfg)


def _ids(rng, b, s, vocab):
    ids = rng.integers(2, vocab, (b, s)).astype(np.int32)
    ids[1, 9:] = 0
    ids[2, 4:] = 1
    return ids


def test_t5_encoder_matches_jax(t5):
    from freefine_tpu.models.t5 import T5Encoder as JT5

    cfg, jcfg, mod, jp = t5
    ids = _ids(np.random.default_rng(2), 3, cfg.text.max_length, cfg.text.vocab_size)
    mask = (ids != 0).astype(np.float32)
    apply = jax.jit(JT5(config=jcfg.text).apply)
    for m in (mask, None):
        want = np.asarray(apply(jp, ids, m))
        with torch.no_grad():
            got = mod(torch.from_numpy(ids).long(),
                      None if m is None else torch.from_numpy(m)).numpy()
        assert got.dtype == np.float32 and got.shape == (3, cfg.text.max_length, 32)
        assert np.abs(want).max() > 0.5
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    with torch.no_grad():  # the mask is live
        a = mod(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        b = mod(torch.from_numpy(ids).long())
    assert float((a[1] - b[1]).abs().max()) > 100 * ATOL


def test_t5_tree_round_trip_bit_for_bit(t5):
    _, _, mod, jp = t5
    back = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp), mod)
    want = mod.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_t5_names_are_transformers():
    mod = T5Encoder(tiny_pixart_pipeline_config().text)
    keys = set(mod.state_dict())
    assert {"shared.weight", "encoder.final_layer_norm.weight",
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            "encoder.block.1.layer.0.SelfAttention.o.weight",
            "encoder.block.1.layer.0.layer_norm.weight",
            "encoder.block.1.layer.1.layer_norm.weight",
            "encoder.block.1.layer.1.DenseReluDense.wi_0.weight",
            "encoder.block.1.layer.1.DenseReluDense.wi_1.weight",
            "encoder.block.1.layer.1.DenseReluDense.wo.weight"} <= keys
    assert not any("block.1.layer.0.SelfAttention.relative" in k for k in keys)
    assert len(keys) == 3 + 2 * 9


def test_random_t5_is_live():
    """`random_weights` fills the RMSNorm weights with 1: a random tower's
    final norm does not zero its output."""
    assert RMSNorm in NORM_TYPES
    mod = random_weights(T5Encoder(tiny_pixart_pipeline_config().text), 0)
    assert all(torch.equal(m.weight, torch.ones_like(m.weight))
               for m in mod.modules() if isinstance(m, RMSNorm))
    with torch.no_grad():
        out = mod(torch.arange(2, 18).reshape(1, 16))
    assert torch.isfinite(out).all() and float(out.abs().mean()) > 0.1


def test_key_mask_rule_is_jax_c8():
    """ROADMAP C8: the T5 key mask is `ids != 0`, JAX's rule.  The hash
    tokenizer's bos is 0 and it pads with eos 1, so the rule masks the
    bos and keeps the padding; `encode_text` is the tower under that mask
    and equals JAX's."""
    cfg, jcfg = tiny_pixart_pipeline_config(), jax_tiny_pixart_config()
    mods = dit_modules(cfg, 41)
    tpipe = P.FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    ids = tpipe.tokenizer.batch_encode(["a cat", ""])
    assert ids[0, 0] == 0 and (ids[0, 3:] == 1).all() and (ids[1, 1:] == 1).all()
    got = tpipe.encode_text(["a cat", ""])
    t = torch.from_numpy(ids).long()
    with torch.no_grad():
        np.testing.assert_array_equal(got.numpy(), tpipe.text_encoder(t, (t != 0).float()).numpy())
        real = torch.zeros_like(t, dtype=torch.float32)
        real[0, :3] = real[1, :1] = 1  # a mask of the real tokens alone differs
        assert float((tpipe.text_encoder(t, real) - got).abs().max()) > 1e-3
    want = np.asarray(jax_pipe(cfg, jcfg, mods).encode_text(["a cat", ""]))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# -- checkpoints -----------------------------------------------------------------


def _write_pixart_dir(root, mods):
    """A diffusers PixArt directory of `mods`' tensors: the transformer with
    diffusers' `pos_embed.pos_embed` buffer, the VAE, T5 in two shards with
    the tied `encoder.embed_tokens.weight`."""
    def put(folder, name, tensors):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
        write_safetensors(tensors, os.path.join(root, folder, name))

    tr = dict(mods["unet"].state_dict())
    tr["pos_embed.pos_embed"] = torch.zeros(1, 64, 32)
    put("transformer", "diffusion_pytorch_model.safetensors", tr)
    put("vae", "diffusion_pytorch_model.safetensors", mods["vae"].state_dict())
    text = dict(mods["text"].state_dict())
    text["encoder.embed_tokens.weight"] = text["shared.weight"]
    keys = sorted(text)
    put("text_encoder", "model-00001-of-00002.safetensors",
        {k: text[k] for k in keys[: len(keys) // 2]})
    put("text_encoder", "model-00002-of-00002.safetensors",
        {k: text[k] for k in keys[len(keys) // 2 :]})
    return text


def test_load_pixart_matches_jax(tmp_path):
    cfg, jcfg = tiny_pixart_pipeline_config(), jax_tiny_pixart_config()
    mods = dit_modules(cfg, 51)
    text = _write_pixart_dir(str(tmp_path), mods)
    assert set(read_safetensors_dir(str(tmp_path / "text_encoder"))) == set(text)
    got = load_pixart(cfg, str(tmp_path))
    jpipe = jax_pipe(cfg, jcfg, dit_modules(cfg, 52))  # other weights: the structure
    want = W.load_pixart(jpipe, str(tmp_path))
    for name, mod in mods.items():
        sd = mod.state_dict()
        assert set(got[name]) == set(sd)
        ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want[name]), mod)
        for k, v in sd.items():
            assert torch.equal(got[name][k], v), (name, k)
            assert torch.equal(ref[k], v), (name, k)
    pipe = P.FreeFine(cfg, params=got, device="cpu")
    assert isinstance(pipe.text_encoder, T5Encoder)


def test_load_pixart_rejects_bad_directories(tmp_path):
    cfg = tiny_pixart_pipeline_config()
    mods = dit_modules(cfg, 53)
    _write_pixart_dir(str(tmp_path), mods)
    with pytest.raises(ValueError, match="PixArt"):
        load_pixart(tiny_pipeline_config(), str(tmp_path))
    tr = dict(mods["unet"].state_dict())
    tr.pop("transformer_blocks.1.attn1.to_k.bias")
    path = os.path.join(str(tmp_path), "transformer", "diffusion_pytorch_model.safetensors")
    write_safetensors(tr, path)
    with pytest.raises(KeyError):
        load_pixart(cfg, str(tmp_path))
    tr["transformer_blocks.1.attn1.to_k.bias"] = torch.zeros(31)
    write_safetensors(tr, path)
    with pytest.raises(ValueError):
        load_pixart(cfg, str(tmp_path))


def test_load_pixart_reads_fp16_variants_as_jax(tmp_path):
    """A stock diffusers folder keeps `*.fp16.safetensors` beside the full
    file.  Both loaders merge every file in sorted order, a later file
    winning: the full transformer and VAE files sort after their `.fp16`
    variants and win; T5's `model.fp16-*` shards sort after its full
    shards, so both loaders read T5 from the variant."""
    cfg, jcfg = tiny_pixart_pipeline_config(), jax_tiny_pixart_config()
    mods = dit_modules(cfg, 55)
    _write_pixart_dir(str(tmp_path), mods)
    other = dit_modules(cfg, 56)
    for folder, name, kind in (("transformer", "diffusion_pytorch_model.fp16.safetensors", "unet"),
                               ("vae", "diffusion_pytorch_model.fp16.safetensors", "vae"),
                               ("text_encoder", "model.fp16-00001-of-00001.safetensors", "text")):
        half = {k: v.half() for k, v in other[kind].state_dict().items()}
        write_safetensors(half, os.path.join(str(tmp_path), folder, name))
    got = load_pixart(cfg, str(tmp_path))
    want = W.load_pixart(jax_pipe(cfg, jcfg, dit_modules(cfg, 57)), str(tmp_path))
    for name, mod in mods.items():
        ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want[name]), mod)
        source = other[name].half().float() if name == "text" else mod
        for k, v in source.state_dict().items():
            assert torch.equal(got[name][k], v), (name, k)
            assert torch.equal(ref[k], v), (name, k)


def test_pixart_save_and_load_round_trip(tmp_path):
    cfg = tiny_pixart_pipeline_config()
    src = P.FreeFine(cfg, init_random=True, seed=3, device="cpu")
    save_pipeline(src, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["text_encoder", "transformer", "vae"]
    dst = P.FreeFine(cfg, init_random=True, seed=4, device="cpu")
    params = load_pipeline_params(dst, str(tmp_path))
    for name, mod in src.components().items():
        for k, v in mod.state_dict().items():
            assert torch.equal(dst.components()[name].state_dict()[k], v), (name, k)
            assert torch.equal(params[name][k], v)
    np.testing.assert_array_equal(load_pixart(cfg, str(tmp_path))["text"]["shared.weight"],
                                  src.text_encoder.shared.weight.detach())


def test_pixart_templates_on_the_meta_device():
    """`load_pixart` reads any PixArt config's keys without allocating
    weights: the full PixArt config's T5-XXL tower has 4.76 B parameters."""
    from freefine_tpu_torch.config import pixart_pipeline_config
    from freefine_tpu_torch.weights import _templates

    t = _templates(pixart_pipeline_config())
    assert t["text"]["shared.weight"].is_meta
    n = sum(v.numel() for v in t["text"].values())
    assert 4.7e9 < n < 4.8e9
    assert t["text"]["encoder.block.23.layer.1.DenseReluDense.wi_0.weight"].shape == (10240, 4096)
