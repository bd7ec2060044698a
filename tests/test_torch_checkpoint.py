"""Checkpoint I/O of the PyTorch port (`freefine_tpu_torch.weights`) against
the `safetensors` package and the JAX package's loaders.

  * The port's safetensors reader and writer, held to `safetensors` 0.8:
    files it wrote (with `__metadata__`) read bit for bit, files the port
    wrote read by `safe_open` bit for bit, a folder of two shards read as
    one dict.
  * `load_sd15` on a diffusers directory written in `tmp_path` from random
    tiny weights (with a `position_ids` tensor the model does not have and
    the legacy VAE attention names stored as 1x1 convs) against
    `freefine_tpu.weights.load_sd15`, carried back through
    `state_dict_from_flax`, bit for bit (float32); a missing tensor raises
    and names its key, a misshapen one raises; `.fp16` variant files beside
    the full ones load as JAX loads them (a later file wins).
  * The LDM single-file renames against JAX's, on the tiny tensors and on
    the full SD-1.5 key sets of `tests/fixtures` (placeholder arrays);
    `load_sd15_single_file` from a .safetensors and a .ckpt file.
  * `cast_params_for_inference` and the `save_pipeline` /
    `load_pipeline_params` round trip.
"""

import os.path as osp
import types

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from freefine_tpu import weights as JW
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.config import tiny_pipeline_config
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_weights import FIXTURES, jax_template, tiny_modules

torch.set_num_threads(2)

DIRS = {"unet": "unet", "vae": "vae", "text": "text_encoder"}


def _random_tensors(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "w.bf16": torch.randn(5, 3, generator=g).bfloat16(),
        "w.f16": torch.randn(7, generator=g).half(),
        "w.f32": torch.randn(2, 3, 4, generator=g),
        "ids.i64": torch.randint(-2**40, 2**40, (9,), generator=g),
        "ids.i32": torch.randint(-2**20, 2**20, (3, 1), generator=g, dtype=torch.int32),
        "scalar": torch.tensor(1.5),
        "empty": torch.zeros(0, 4),
    }


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 1])
def test_reader_reads_files_safetensors_wrote(tmp_path, seed):
    want = _random_tensors(seed)
    path = str(tmp_path / "a.safetensors")
    save_file(want, path, metadata={"format": "pt", "seed": str(seed)})
    got = W.read_safetensors(path)
    _assert_same(got, want)  # the `__metadata__` entry is not a tensor
    got["w.f32"].add_(1.0)  # a copy-on-write view: the file is untouched
    _assert_same(W.read_safetensors(path), want)


@pytest.mark.parametrize("seed", [3, 4])
def test_writer_files_read_by_safe_open(tmp_path, seed):
    want = _random_tensors(seed)
    path = str(tmp_path / "b.safetensors")
    nbytes = W.write_safetensors(want, path)
    assert nbytes == osp.getsize(path)
    with safe_open(path, framework="pt") as f:
        got = {k: f.get_tensor(k) for k in f.keys()}
    _assert_same(got, want)
    _assert_same(W.read_safetensors(path), want)


def test_folder_of_shards_reads_as_one_dict(tmp_path):
    a, b = _random_tensors(4), _random_tensors(5)
    b = {f"second.{k}": v for k, v in b.items()}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"))
    W.write_safetensors(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    _assert_same(W.read_safetensors_dir(str(tmp_path)), {**a, **b})
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        W.read_safetensors_dir(str(tmp_path / "empty"))


# -- the diffusers layout ------------------------------------------------------


LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _write_diffusers(root, mods, legacy_vae=True, drop=None):
    """The tiny modules' weights as a diffusers checkpoint directory: the
    text encoder with a `position_ids` buffer the model does not have, the
    VAE's attention under the legacy names as 1x1 convs, the UNet in two
    shards."""
    for kind, mod in mods.items():
        sd = {k: v.detach().clone() for k, v in mod.state_dict().items() if k != drop}
        if kind == "text":
            sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
        if kind == "vae" and legacy_vae:
            for key in [k for k in sd if ".attentions.0." in k]:
                mod_path, leaf = key.rsplit(".", 1)
                for new, old in LEGACY.items():
                    if mod_path.endswith(new):
                        t = sd.pop(key)
                        sd[f"{mod_path[: -len(new)]}{old}.{leaf}"] = \
                            t[:, :, None, None] if t.ndim == 2 else t
        d = root / DIRS[kind]
        d.mkdir(parents=True, exist_ok=True)
        keys = sorted(sd)
        if kind == "unet":
            half = len(keys) // 2
            save_file({k: sd[k] for k in keys[:half]}, str(d / "a.safetensors"))
            save_file({k: sd[k] for k in keys[half:]}, str(d / "b.safetensors"))
        else:
            save_file(sd, str(d / "model.safetensors"))


@pytest.fixture(scope="module")
def tiny():
    cfg, mods = tiny_modules(11)
    jcfg = jax_tiny_config()
    jpipe = types.SimpleNamespace(params={k: jax_template(k, jcfg) for k in mods})
    return cfg, mods, jpipe


def test_load_sd15_matches_jax_loader(tiny, tmp_path):
    cfg, mods, jpipe = tiny
    _write_diffusers(tmp_path, mods)
    jparams = jax.tree_util.tree_map(np.asarray, JW.load_sd15(jpipe, str(tmp_path)))
    pipe = FreeFine(cfg, init_random=True, seed=5, device="cpu")
    for target in (cfg, pipe):
        got = W.load_sd15(target, str(tmp_path))
        assert sorted(got) == ["text", "unet", "vae"]
        for kind, mod in mods.items():
            want = W.state_dict_from_flax(jparams[kind], mod)
            _assert_same(got[kind], want)
            _assert_same(got[kind], mod.state_dict())
    loaded = FreeFine(cfg, params=W.load_sd15(cfg, str(tmp_path)), device="cpu")
    for kind, mod in loaded.components().items():
        _assert_same(mod.state_dict(), mods[kind].state_dict())


def test_load_sd15_reads_fp16_variants_as_jax(tiny, tmp_path):
    """A stock diffusers snapshot keeps `*.fp16.safetensors` beside each
    full file.  Both loaders merge every file in sorted order, a later file
    winning, so the full file (sorted after its variant) is what loads."""
    cfg, mods, jpipe = tiny
    _, other = tiny_modules(12)
    names = {"unet": "diffusion_pytorch_model", "vae": "diffusion_pytorch_model",
             "text": "model"}
    for kind, mod in mods.items():
        d = tmp_path / DIRS[kind]
        d.mkdir(parents=True)
        save_file(dict(mod.state_dict()), str(d / f"{names[kind]}.safetensors"))
        half = {k: v.half() for k, v in other[kind].state_dict().items()}
        save_file(half, str(d / f"{names[kind]}.fp16.safetensors"))
    jparams = jax.tree_util.tree_map(np.asarray, JW.load_sd15(jpipe, str(tmp_path)))
    got = W.load_sd15(cfg, str(tmp_path))
    for kind, mod in mods.items():
        _assert_same(got[kind], W.state_dict_from_flax(jparams[kind], mod))
        _assert_same(got[kind], mod.state_dict())


def test_load_sd15_casts_as_jax(tiny, tmp_path):
    cfg, mods, _ = tiny
    _write_diffusers(tmp_path, mods, legacy_vae=False)
    got = W.load_sd15(cfg, str(tmp_path), dtype=torch.bfloat16)
    for kind, mod in mods.items():
        for k, v in mod.state_dict().items():
            assert got[kind][k].dtype == torch.bfloat16
            assert torch.equal(got[kind][k], v.bfloat16()), k


def test_load_sd15_missing_and_misshapen_tensors_raise(tiny, tmp_path):
    cfg, mods, _ = tiny
    key = "down_blocks.0.resnets.0.conv1.weight"
    _write_diffusers(tmp_path / "missing", mods, drop=key)
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        W.load_sd15(cfg, str(tmp_path / "missing"))
    _write_diffusers(tmp_path / "bad", mods)
    sd = W.read_safetensors(str(tmp_path / "bad" / "text_encoder" / "model.safetensors"))
    sd = {k: v.clone() for k, v in sd.items()}
    sd["text_model.final_layer_norm.weight"] = torch.ones(3)
    save_file(sd, str(tmp_path / "bad" / "text_encoder" / "model.safetensors"))
    with pytest.raises(ValueError, match="shape mismatch"):
        W.load_sd15(cfg, str(tmp_path / "bad"))


# -- single-file LDM checkpoints -------------------------------------------------


_RES = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
        "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_VRES = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2", "conv2": "conv2",
         "conv_shortcut": "nin_shortcut"}
_VATTN = {"group_norm": "norm", "to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out"}
_U = "model.diffusion_model."
_V = "first_stage_model."


def _to_ldm(unet, vae, text, conv_attn=lambda v: v):
    """diffusers-named UNet / VAE / text tensors -> one LDM single-file
    dict (the inverse of the renames under test)."""
    sd = {}
    for k, v in unet.items():
        p = k.split(".")
        top = {"conv_in": "input_blocks.0.0", "time_embedding.linear_1": "time_embed.0",
               "time_embedding.linear_2": "time_embed.2", "conv_norm_out": "out.0",
               "conv_out": "out.2"}
        head = ".".join(p[:-1])
        if head in top:
            sd[f"{_U}{top[head]}.{p[-1]}"] = v
        elif p[0] in ("down_blocks", "up_blocks"):
            lvl, kind, j = int(p[1]), p[2], int(p[3])
            blocks = "input_blocks" if p[0] == "down_blocks" else "output_blocks"
            i = (1 + lvl * 3 + j) if p[0] == "down_blocks" else lvl * 3 + j
            if kind == "resnets":
                sd[f"{_U}{blocks}.{i}.0.{_RES[p[4]]}.{p[-1]}"] = v
            elif kind == "attentions":
                sd[f"{_U}{blocks}.{i}.1.{'.'.join(p[4:])}"] = v
            elif kind == "downsamplers":
                sd[f"{_U}input_blocks.{1 + lvl * 3 + 2}.0.op.{p[-1]}"] = v
            else:
                has_attn = any(x.startswith(f"up_blocks.{lvl}.attentions.") for x in unet)
                sd[f"{_U}output_blocks.{lvl * 3 + 2}.{2 if has_attn else 1}.conv.{p[-1]}"] = v
        elif p[0] == "mid_block":
            if p[1] == "resnets":
                sd[f"{_U}middle_block.{2 * int(p[2])}.{_RES[p[3]]}.{p[-1]}"] = v
            else:
                sd[f"{_U}middle_block.1.{'.'.join(p[3:])}"] = v
        else:
            raise KeyError(k)
    for k, v in vae.items():
        p = k.split(".")
        if k.startswith("encoder.down_blocks."):
            if p[3] == "resnets":
                sd[f"{_V}encoder.down.{p[2]}.block.{p[4]}.{_VRES[p[5]]}.{p[-1]}"] = v
            else:
                sd[f"{_V}encoder.down.{p[2]}.downsample.conv.{p[-1]}"] = v
        elif k.startswith("decoder.up_blocks."):
            lvl = 3 - int(p[2])
            if p[3] == "resnets":
                sd[f"{_V}decoder.up.{lvl}.block.{p[4]}.{_VRES[p[5]]}.{p[-1]}"] = v
            else:
                sd[f"{_V}decoder.up.{lvl}.upsample.conv.{p[-1]}"] = v
        elif ".mid_block.resnets." in k:
            n = "block_1" if p[3] == "0" else "block_2"
            sd[f"{_V}{p[0]}.mid.{n}.{_VRES[p[4]]}.{p[-1]}"] = v
        elif ".mid_block.attentions." in k:
            name = ".".join(p[4:-1])
            sd[f"{_V}{p[0]}.mid.attn_1.{_VATTN[name]}.{p[-1]}"] = \
                conv_attn(v) if name != "group_norm" else v
        elif ".conv_norm_out." in k:
            sd[f"{_V}{k.replace('conv_norm_out', 'norm_out')}"] = v
        else:
            sd[f"{_V}{k}"] = v
    for k, v in text.items():
        sd[f"cond_stage_model.transformer.{k}"] = v
    return sd


def _conv1x1(v):
    return v[:, :, None, None] if v.ndim == 2 else v


def test_ldm_renames_match_jax_on_tiny_tensors(tiny):
    _, mods, _ = tiny
    sds = {k: m.state_dict() for k, m in mods.items()}
    ldm = _to_ldm(sds["unet"], sds["vae"], sds["text"], _conv1x1)
    ldm_np = {k: v.numpy() for k, v in ldm.items()}
    for port_fn, jax_fn, kind in ((W._ldm_unet_to_diffusers, JW._ldm_unet_to_diffusers, "unet"),
                                  (W._ldm_vae_to_diffusers, JW._ldm_vae_to_diffusers, "vae")):
        got, want = port_fn(ldm), jax_fn(ldm_np)
        assert sorted(got) == sorted(want) == sorted(sds[kind])
        for k in want:
            assert np.array_equal(got[k].numpy(), want[k]), k


@pytest.mark.parametrize("kind,fixture,count", [("unet", "sd15_unet_keys.txt", 686),
                                                ("vae", "sd15_vae_keys.txt", 248)])
def test_ldm_renames_cover_the_sd15_key_sets(kind, fixture, count):
    with open(osp.join(FIXTURES, fixture)) as f:
        keys = [line.split()[0] for line in f if line.strip()]
    assert len(keys) == count
    tags = {k: np.array([i]) for i, k in enumerate(keys)}
    ldm = _to_ldm(tags, {}, {}) if kind == "unet" else _to_ldm({}, tags, {})
    assert len(ldm) == count
    fn = {"unet": (W._ldm_unet_to_diffusers, JW._ldm_unet_to_diffusers),
          "vae": (W._ldm_vae_to_diffusers, JW._ldm_vae_to_diffusers)}[kind]
    for rename in fn:
        back = rename(ldm)
        assert sorted(back) == sorted(keys)
        assert all(int(back[k][0]) == i for i, k in enumerate(keys))


@pytest.mark.parametrize("suffix", [".safetensors", ".ckpt"])
def test_load_sd15_single_file(tiny, tmp_path, suffix):
    cfg, mods, _ = tiny
    sds = {k: m.state_dict() for k, m in mods.items()}
    ldm = _to_ldm(sds["unet"], sds["vae"], sds["text"], _conv1x1)
    ldm = {k: v.contiguous() for k, v in ldm.items()}
    path = str(tmp_path / f"v1-5-tiny{suffix}")
    if suffix == ".safetensors":
        W.write_safetensors(ldm, path)
    else:
        torch.save({"state_dict": ldm, "global_step": 1}, path)
    got = W.load_sd15_single_file(cfg, path)
    for kind in mods:
        _assert_same(got[kind], sds[kind])


# -- the rest ----------------------------------------------------------------------


def test_cast_params_for_inference():
    tree = {
        "unet": {"kernel": torch.ones(4, 4), "bias": torch.ones(4), "scale": torch.ones(4),
                 "table": torch.ones(2, 3, 4), "ids": torch.ones(4, 4, dtype=torch.int32),
                 "half": torch.ones(4, 4, dtype=torch.float16)},
    }
    out = W.cast_params_for_inference(tree)["unet"]
    assert out["kernel"].dtype == torch.bfloat16 and out["table"].dtype == torch.bfloat16
    assert out["bias"].dtype == torch.float32 and out["scale"].dtype == torch.float32
    assert out["ids"].dtype == torch.int32 and out["half"].dtype == torch.float16
    assert W.cast_params_for_inference(tree, torch.float16)["unet"]["kernel"].dtype == \
        torch.float16


def test_save_pipeline_round_trip(tmp_path):
    cfg = tiny_pipeline_config()
    src = FreeFine(cfg, init_random=True, seed=3, device="cpu")
    nbytes = W.save_pipeline(src, str(tmp_path / "ckpt"))
    for folder, fname in (("unet", "diffusion_pytorch_model"), ("vae", "diffusion_pytorch_model"),
                          ("text_encoder", "model")):
        assert (tmp_path / "ckpt" / folder / f"{fname}.safetensors").is_file()
    assert nbytes == sum(p.stat().st_size for p in (tmp_path / "ckpt").rglob("*.safetensors"))
    dst = FreeFine(cfg, init_random=True, seed=9, device="cpu")
    params = W.load_pipeline_params(dst, str(tmp_path / "ckpt"))
    for kind, mod in src.components().items():
        _assert_same(params[kind], mod.state_dict())
        _assert_same(dst.components()[kind].state_dict(), mod.state_dict())
    # the same directory through load_sd15, and a dtype the pipe does not hold
    for kind, sd in W.load_sd15(cfg, str(tmp_path / "ckpt")).items():
        _assert_same(sd, src.components()[kind].state_dict())
    half = W.cast_params_for_inference({k: m.state_dict() for k, m in src.components().items()})
    other = FreeFine(cfg, params=half, device="cpu")
    for mod in other.components().values():
        mod.to(torch.bfloat16)
    W.save_pipeline(other, str(tmp_path / "bf16"))
    with pytest.raises(TypeError, match="dtype mismatch"):
        W.load_pipeline_params(dst, str(tmp_path / "bf16"))
