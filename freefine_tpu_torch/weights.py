"""Weights for the PyTorch port.

The port's modules use the diffusers / transformers state-dict keys, so a
diffusers checkpoint loads with `load_state_dict` as it is.  This module
adds:

  * `state_dict_from_flax(tree, model)` — the inverse of the JAX package's
    tree-driven converter (`freefine_tpu.weights._convert_tree`): flax
    module paths become diffusers keys through the same segment fixes and
    per-model rewrites (the port keeps its own copy of those tables), conv
    kernels HWIO -> OIHW, dense kernels IO -> OI, `scale`/`embedding` ->
    `weight`; SDXL's trees too (the add_embedding names, and the OpenCLIP
    tower's fused `in_proj` split into q/k/v and its `text_projection`
    transposed into transformers' names); the PixArt DiT's tree (diffusers'
    `PixArtTransformer2DModel` names, the AdaLN `scale_shift_table`s) and
    the T5 tower's (transformers' `T5EncoderModel` names);
  * `random_weights(model, seed)` — the random-weight scheme of the
    throughput bench: norm weights 1, other 1-D leaves 0, matrices
    N(0, 0.02) drawn in float32 from a seeded `torch.Generator` and stored
    in the module's dtype;
  * checkpoint I/O without the `safetensors` package: `read_safetensors` /
    `write_safetensors` (the format itself: an 8-byte little-endian header
    length, a JSON header of {name: {dtype, shape, data_offsets}} plus an
    optional `__metadata__`, one byte buffer; reads are `torch.frombuffer`
    views of a copy-on-write `np.memmap`, so a file is not copied twice),
    `load_sd15`, `load_sdxl` and `load_pixart` (a diffusers checkpoint
    directory; a component's shards merged),
    `load_sd15_single_file` (an LDM single-file checkpoint),
    `cast_params_for_inference`, and
    `save_pipeline` / `load_pipeline_params` (the diffusers layout, written
    by the port's own writer).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from freefine_tpu_torch.models.layers import NORM_TYPES

_SEGMENT_FIXES = [
    ("_resnets", ".resnets"),
    ("_attentions", ".attentions"),
    ("_downsamplers", ".downsamplers"),
    ("_upsamplers", ".upsamplers"),
    ("transformer_blocks_0", "transformer_blocks.0"),
    ("net_0", "net.0"),
    ("net_2", "net.2"),
    ("to_out_0", "to_out.0"),
]

_LEAF_MAP = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight",
             # PixArt's AdaLN tables are bare parameters (no .weight suffix)
             "scale_shift_table": "scale_shift_table"}

# the SDXL UNet's added-conditioning MLP (flax add_embedding_1/_2)
_UNET_REWRITES = (
    (r"add_embedding\.1$", "add_embedding.linear_1"),
    (r"add_embedding\.2$", "add_embedding.linear_2"),
)
_VAE_KEY_REWRITES = (
    (r"\.mid\.resnets", ".mid_block.resnets"),
    (r"\.mid\.attentions", ".mid_block.attentions"),
    (r"^encoder\.quant_conv$", "quant_conv"),
    (r"^decoder\.post_quant_conv$", "post_quant_conv"),
    (r"attentions\.0\.norm$", "attentions.0.group_norm"),
)
_TEXT_REWRITES = (
    (r"^token_embedding", "text_model.embeddings.token_embedding"),
    (r"^position_embedding", "text_model.embeddings.position_embedding"),
    (r"^layers\.", "text_model.encoder.layers."),
    (r"^final_layer_norm", "text_model.final_layer_norm"),
)
# the DiT's flax module paths (after `_module_to_diffusers`) -> diffusers'
# PixArtTransformer2DModel keys
_PIXART_REWRITES = (
    (r"^patch_embed", "pos_embed.proj"),
    (r"^time_embedding", "adaln_single.emb.timestep_embedder"),
    (r"^t_block", "adaln_single.linear"),
    (r"^caption_proj\.1", "caption_projection.linear_1"),
    (r"^caption_proj\.2", "caption_projection.linear_2"),
    (r"^blocks\.", "transformer_blocks."),
    (r"ff_net\.0_proj", "ff.net.0.proj"),
    (r"ff_net\.2", "ff.net.2"),
)
# T5 block sub-module -> its path in transformers' T5Block
_T5_LAYER = {"attn": "layer.0.SelfAttention", "norm_attn": "layer.0.layer_norm",
             "norm_ff": "layer.1.layer_norm", "wi_0": "layer.1.DenseReluDense.wi_0",
             "wi_1": "layer.1.DenseReluDense.wi_1", "wo": "layer.1.DenseReluDense.wo"}
# OpenCLIP block module -> transformers' CLIPEncoderLayer path
_OPEN_CLIP_LAYER = {"ln_1": "layer_norm1", "ln_2": "layer_norm2",
                    "out_proj": "self_attn.out_proj", "mlp_fc": "mlp.fc1",
                    "mlp_proj": "mlp.fc2"}


def _module_to_diffusers(seg: str) -> str:
    """One flax module-name segment -> dotted diffusers path piece."""
    for a, b in _SEGMENT_FIXES:
        seg = seg.replace(a, b)
    seg = re.sub(r"_(\d+)$", r".\1", seg)
    seg = re.sub(r"_(\d+)\.", r".\1.", seg)
    return seg.replace("linear.1", "linear_1").replace("linear.2", "linear_2")


def _flatten(tree: Mapping, prefix=()):
    for name, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (name,))
        else:
            yield prefix + (name,), val


def _rewrites_for(model: nn.Module):
    from freefine_tpu_torch.models.dit import DiT2DCondition
    from freefine_tpu_torch.models.text_encoder import CLIPTextEncoder
    from freefine_tpu_torch.models.unet import UNet2DCondition
    from freefine_tpu_torch.models.vae import AutoencoderKL

    if isinstance(model, UNet2DCondition):
        return _UNET_REWRITES
    if isinstance(model, DiT2DCondition):
        return _PIXART_REWRITES
    if isinstance(model, AutoencoderKL):
        return _VAE_KEY_REWRITES
    if isinstance(model, CLIPTextEncoder):
        return _TEXT_REWRITES
    raise TypeError(f"no flax key layout known for {type(model).__name__}")


def _flax_key(path, rewrites=()) -> str:
    """Flax param path (module names..., leaf) -> diffusers state-dict key."""
    *mods, leaf = path
    segs = [
        _module_to_diffusers(m) for m in mods if m not in ("params", "GroupNorm_0", "LayerNorm_0")
    ]
    key = ".".join(segs)
    for pat, rep in rewrites:
        key = re.sub(pat, rep, key)
    return f"{key}.{_LEAF_MAP[leaf]}" if key else _LEAF_MAP[leaf]


def _open_clip_items(tree: Mapping):
    """(state-dict key, array, flax path) of each leaf of an OpenCLIP
    tower's flax tree, in transformers' `CLIPTextModelWithProjection`
    names: the fused in_proj split into q, k, v (in that order), dense
    kernels IO -> OI, `text_projection` [width, proj] transposed into the
    bias-free Linear's weight."""
    pre = "text_model."
    for path, leaf in _flatten(tree):
        mods = [m for m in path[:-1] if m not in ("params", "LayerNorm_0")]
        name, a, where = path[-1], np.asarray(leaf), "/".join(path)
        if name == "positional_embedding":
            yield f"{pre}embeddings.position_embedding.weight", a, where
        elif name == "text_projection":
            yield "text_projection.weight", a.T, where
        elif mods == ["token_embedding"]:
            yield f"{pre}embeddings.token_embedding.weight", a, where
        elif mods == ["ln_final"]:
            yield f"{pre}final_layer_norm.{_LEAF_MAP[name]}", a, where
        else:
            block, sub = mods
            base = f"{pre}encoder.layers.{block.rsplit('_', 1)[1]}"
            leaf_name = _LEAF_MAP[name]
            if sub == "in_proj":
                for p, part in zip("qkv", np.split(a, 3, axis=-1)):
                    yield (f"{base}.self_attn.{p}_proj.{leaf_name}",
                           part.T if name == "kernel" else part, where)
            else:
                yield (f"{base}.{_OPEN_CLIP_LAYER[sub]}.{leaf_name}",
                       a.T if name == "kernel" else a, where)


def _t5_items(tree: Mapping):
    """(state-dict key, array, flax path) of each leaf of a T5 tower's flax
    tree, in transformers' `T5EncoderModel` names, dense kernels IO -> OI."""
    for path, leaf in _flatten(tree):
        mods = [m for m in path[:-1] if m != "params"]
        name, a, where = path[-1], np.asarray(leaf), "/".join(path)
        if name == "shared":
            yield "shared.weight", a, where
        elif name == "relative_attention_bias":
            yield "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", a, where
        elif mods == ["final_layer_norm"]:
            yield "encoder.final_layer_norm.weight", a, where
        else:
            block, sub, *proj = mods
            key = f"encoder.block.{block.rsplit('_', 1)[1]}.{_T5_LAYER[sub]}"
            yield (".".join([key, *proj, "weight"]), a.T if name == "kernel" else a, where)


def _flax_items(tree: Mapping, model: nn.Module):
    """(state-dict key, array in the torch layout, flax path) of each leaf."""
    from freefine_tpu_torch.models.open_clip_text import OpenCLIPTextHidden
    from freefine_tpu_torch.models.t5 import T5Encoder

    if isinstance(model, OpenCLIPTextHidden):
        yield from _open_clip_items(tree)
        return
    if isinstance(model, T5Encoder):
        yield from _t5_items(tree)
        return
    rewrites = _rewrites_for(model)
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf)
        if path[-1] == "kernel":
            if a.ndim == 4:        # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:      # IO -> OI
                a = a.T
        yield _flax_key(path, rewrites), a, "/".join(path)


def state_dict_from_flax(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax param tree of numpy arrays (as `freefine_tpu.weights.convert_*`
    return it, with or without the top-level "params") -> a state dict for
    `model`, every tensor in the model's own dtype and shape.  Raises on a
    missing, extra or misshapen key."""
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key, a, where in _flax_items(tree, model):
        if key not in want:
            raise KeyError(f"flax leaf {where} maps to {key}, not a key of the model")
        ref = want[key]
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: flax {a.shape} vs model {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a).astype(np.float32)).to(ref.dtype)
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} model keys absent from the flax tree, e.g. {missing[:5]}")
    return out


@torch.no_grad()
def random_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill `model` in place with the bench's random-weight scheme; draws
    come from a `torch.Generator` on each parameter's device."""
    norm_weights = {id(m.weight) for m in model.modules() if isinstance(m, NORM_TYPES)}
    gens: Dict[torch.device, torch.Generator] = {}
    for p in model.parameters():
        if id(p) in norm_weights:
            p.fill_(1.0)
        elif p.ndim <= 1:
            p.zero_()
        else:
            if p.device not in gens:
                gens[p.device] = torch.Generator(device=p.device).manual_seed(seed)
            draw = torch.randn(p.shape, generator=gens[p.device], device=p.device,
                               dtype=torch.float32)
            p.copy_(draw * 0.02)
    return model


# ---------------------------------------------------------------------------
# safetensors, read and written by the port itself
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> {name: CPU tensor} (its `__metadata__`
    skipped).  The tensors are views of one copy-on-write memory map of the
    file: nothing is read until a tensor is used, and writing to a tensor
    never reaches the file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    size = os.path.getsize(path)
    buf = np.memmap(path, dtype=np.uint8, mode="c") if size > 8 + n else None
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != count * itemsize or 8 + n + end > size:
            raise ValueError(f"{path}: tensor {name} has offsets {begin}..{end} for "
                             f"{count} x {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=8 + n + begin).reshape(shape)
    return out


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: str) -> int:
    """Write {name: tensor} as one .safetensors file; returns its bytes.
    Tensors go in order of falling element size, then name (the order the
    `safetensors` package writes, which keeps every tensor aligned to its
    element size), and the header is padded with spaces to 8 bytes."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"tensor {name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                f.write(t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset


def read_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Every *.safetensors file under `path`, in sorted order, as one dict:
    the shards of one model (T5-XXL ships as `model-0000i-of-0000n`).  As
    the JAX package's `_load_safetensors_dir` does, a tensor name in two
    files takes the later file's tensor: in a stock diffusers folder the
    full `diffusion_pytorch_model.safetensors` wins over the `.fp16`
    variant beside it."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {path}")
    out: Dict[str, torch.Tensor] = {}
    for f in files:
        out.update(read_safetensors(os.path.join(path, f)))
    return out


# ---------------------------------------------------------------------------
# Checkpoints -> the port's state dicts
# ---------------------------------------------------------------------------

# Folder and weight file of each component in the diffusers layout (a DiT
# denoiser's folder is "transformer": `_diffusers_files`).
_DIFFUSERS_FILES = {"unet": ("unet", "diffusion_pytorch_model.safetensors"),
                    "vae": ("vae", "diffusion_pytorch_model.safetensors"),
                    "text": ("text_encoder", "model.safetensors"),
                    "text2": ("text_encoder_2", "model.safetensors")}


def _diffusers_files(pipe) -> Dict[str, tuple]:
    """`_DIFFUSERS_FILES` for a pipe or config: the PixArt layout keeps
    the DiT under `transformer/`."""
    from freefine_tpu_torch.config import DiTConfig

    cfg = getattr(pipe, "config", pipe)
    if isinstance(cfg.unet, DiTConfig):
        return {**_DIFFUSERS_FILES, "unet": ("transformer", _DIFFUSERS_FILES["unet"][1])}
    return _DIFFUSERS_FILES

# Legacy diffusers VAE attention names (1x1-conv projections).
_VAE_ATTN_ALIASES = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _templates(pipe) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"unet", "vae", "text"[, "text2"]} -> the model's state dict (shapes
    and dtypes) of a `FreeFine` pipe or, for a `PipelineConfig`, of modules
    built on the meta device (no weights allocated)."""
    if hasattr(pipe, "components"):
        return {name: mod.state_dict() for name, mod in pipe.components().items()}
    from freefine_tpu_torch.models.open_clip_text import OpenCLIPTextHidden
    from freefine_tpu_torch.pipeline import build_modules

    with torch.device("meta"):
        mods = build_modules(pipe)
        if pipe.text2 is not None:
            mods["text2"] = OpenCLIPTextHidden(pipe.text2)
    return {name: mod.state_dict() for name, mod in mods.items()}


def _read_diffusers(names, path: str, files: Mapping[str, tuple]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The tensors of each named component's folder (`files`) of a
    diffusers checkpoint directory."""
    return {name: read_safetensors_dir(os.path.join(path, files[name][0])) for name in names}


def _convert(tensors: Mapping[str, torch.Tensor], want: Mapping[str, torch.Tensor],
             dtype: Optional[torch.dtype] = None, strict_dtype: bool = False):
    """Checkpoint tensors -> a state dict with `want`'s keys, each cast to
    `dtype` or to the model's own dtype (JAX's `dtype or leaf.dtype`).
    Tensors the model does not have are ignored; a missing one or a shape
    mismatch raises.  The legacy VAE attention names are aliases, and its
    [O, I, 1, 1] projections become [O, I].  strict_dtype: a stored dtype
    other than the model's raises instead of being cast."""
    out: Dict[str, torch.Tensor] = {}
    for key, ref in want.items():
        mod, _, leaf = key.rpartition(".")
        cand = [key] + [f"{mod[: -len(new)]}{old}.{leaf}"
                        for new, old in _VAE_ATTN_ALIASES.items() if mod.endswith(new)]
        found = next((c for c in cand if c in tensors), None)
        if found is None:
            raise KeyError(f"missing checkpoint tensor {key} (tried {cand})")
        t = tensors[found]
        if tuple(t.shape) != tuple(ref.shape):
            if t.ndim == 4 and tuple(t.shape[2:]) == (1, 1) and tuple(t.shape[:2]) == \
                    tuple(ref.shape):
                t = t.reshape(t.shape[:2])
            else:
                raise ValueError(f"shape mismatch for {found}: checkpoint {tuple(t.shape)} vs "
                                 f"model {tuple(ref.shape)}")
        if strict_dtype and t.dtype != ref.dtype:
            raise TypeError(f"dtype mismatch for {found}: checkpoint {t.dtype} vs model "
                            f"{ref.dtype}")
        out[key] = t.to(dtype or ref.dtype)
    return out


def _convert_all(pipe, tensors, dtype=None,
                 strict_dtype: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """`pipe`'s components' state dicts from `tensors` (a {name: tensors}
    mapping, or a diffusers directory to read them from)."""
    want = _templates(pipe)
    if isinstance(tensors, str):
        tensors = _read_diffusers(want, tensors, _diffusers_files(pipe))
    return {name: _convert(tensors[name], want[name], dtype, strict_dtype) for name in want}


def load_sd15(pipe, checkpoint_dir: str, dtype: Optional[torch.dtype] = None) -> dict:
    """A diffusers SD-1.5 checkpoint directory
    (`{unet,vae,text_encoder}/*.safetensors`, each folder's files one state
    dict) -> the port's {"unet", "vae", "text"} state dicts, ready for
    `FreeFine(params=...)`.  `pipe` is a `FreeFine` or a `PipelineConfig`
    (its modules give the keys, shapes and dtypes).  Read by the port's own
    reader: the `safetensors` package is not needed."""
    return _convert_all(pipe, checkpoint_dir, dtype)


def load_sdxl(pipe, checkpoint_dir: str, dtype: Optional[torch.dtype] = None) -> dict:
    """A diffusers SDXL-base checkpoint directory
    (`{unet,vae,text_encoder,text_encoder_2}/*.safetensors`) -> the port's
    {"unet", "vae", "text", "text2"} state dicts, ready for
    `SDXLFreeFine(params=...)`.  `pipe` is an `SDXLFreeFine` or an SDXL
    `PipelineConfig`.  The first tower's last layer and final LayerNorm,
    which SDXL's penultimate hidden states never reach, are not read."""
    want = _templates(pipe)
    if "text2" not in want:
        raise ValueError("load_sdxl needs an SDXL pipe or config (PipelineConfig.text2)")
    return _convert_all(pipe, checkpoint_dir, dtype)


def load_pixart(pipe, checkpoint_dir: str, dtype: Optional[torch.dtype] = None) -> dict:
    """A diffusers PixArt-α checkpoint directory
    (`{transformer,vae,text_encoder}/*.safetensors`: the PixArt transformer,
    the SD VAE and T5-XXL, whose shards are merged) -> the port's {"unet",
    "vae", "text"} state dicts, ready for `FreeFine(params=...)`.  `pipe` is
    a `FreeFine` or a `PipelineConfig` of the PixArt layout
    (`pixart_pipeline_config`).  Tensors the modules lack (diffusers'
    `pos_embed.pos_embed` buffer, the tied `encoder.embed_tokens.weight`)
    are ignored; a missing or misshapen one raises."""
    from freefine_tpu_torch.config import DiTConfig
    from freefine_tpu_torch.models.t5 import T5Config

    cfg = getattr(pipe, "config", pipe)
    if not (isinstance(cfg.unet, DiTConfig) and isinstance(cfg.text, T5Config)):
        raise ValueError("load_pixart needs a PixArt pipe or config (a DiTConfig denoiser and "
                         "a T5Config text tower)")
    return _convert_all(pipe, checkpoint_dir, dtype)


def cast_params_for_inference(params, dtype: torch.dtype = torch.bfloat16):
    """The serving cast: float32 tensors of ndim >= 2 (matmul and conv
    weights) to `dtype`; 1-D tensors (norms, biases) and tensors of any
    other dtype kept.  `params` is a nest of dicts of tensors."""
    if isinstance(params, Mapping):
        return {k: cast_params_for_inference(v, dtype) for k, v in params.items()}
    if params.ndim >= 2 and params.dtype == torch.float32:
        return params.to(dtype)
    return params


def save_pipeline(pipe, path: str) -> int:
    """Write the pipe's weights as a diffusers checkpoint directory
    (`unet/` (a DiT: `transformer/`) and
    `vae/diffusion_pytorch_model.safetensors`,
    `text_encoder/model.safetensors`, and for SDXL
    `text_encoder_2/model.safetensors`), which `load_sd15` / `load_sdxl` /
    `load_pixart` and `load_pipeline_params` read back.  Returns the bytes
    written."""
    total = 0
    files = _diffusers_files(pipe)
    for name, mod in pipe.components().items():
        folder, fname = files[name]
        os.makedirs(os.path.join(path, folder), exist_ok=True)
        total += write_safetensors(mod.state_dict(), os.path.join(path, folder, fname))
    return total


def load_pipeline_params(pipe, path: str) -> dict:
    """Read a directory `save_pipeline` wrote, check every tensor's shape
    and dtype against the pipe's modules, and load it into them.  Returns
    the state dicts."""
    params = _convert_all(pipe, path, strict_dtype=True)
    for name, mod in pipe.components().items():
        mod.load_state_dict(params[name])
    return params


# -- single-file LDM checkpoints (v1-5-pruned.safetensors style) ----------------

_LDM_UNET_PREFIX = "model.diffusion_model."
_LDM_VAE_PREFIX = "first_stage_model."
_LDM_TEXT_PREFIX = "cond_stage_model.transformer."


def _ldm_unet_to_diffusers(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Rename LDM UNet keys (model.diffusion_model.*) to diffusers naming.

    SD-1.5 structure: input_blocks 0..11 (conv_in at 0; per level 2 res[+attn]
    then a downsample block), middle_block (res, attn, res), output_blocks
    0..11 (3 per level, upsample conv appended on the last of each level but
    the final), time_embed -> time_embedding.
    """
    out: Dict[str, torch.Tensor] = {}

    def put(dst, src):
        out[dst] = sd[_LDM_UNET_PREFIX + src]

    def copy_res(dst_prefix, src_prefix):
        ren = {
            "in_layers.0": "norm1", "in_layers.2": "conv1",
            "emb_layers.1": "time_emb_proj",
            "out_layers.0": "norm2", "out_layers.3": "conv2",
            "skip_connection": "conv_shortcut",
        }
        for s, d in ren.items():
            for leaf in ("weight", "bias"):
                k = f"{_LDM_UNET_PREFIX}{src_prefix}.{s}.{leaf}"
                if k in sd:
                    out[f"{dst_prefix}.{d}.{leaf}"] = sd[k]

    def copy_attn(dst_prefix, src_prefix):
        for k in list(sd):
            if k.startswith(f"{_LDM_UNET_PREFIX}{src_prefix}."):
                suffix = k[len(f"{_LDM_UNET_PREFIX}{src_prefix}.") :]
                out[f"{dst_prefix}.{suffix}"] = sd[k]

    for leaf in ("weight", "bias"):
        put(f"conv_in.{leaf}", f"input_blocks.0.0.{leaf}")
        put(f"time_embedding.linear_1.{leaf}", f"time_embed.0.{leaf}")
        put(f"time_embedding.linear_2.{leaf}", f"time_embed.2.{leaf}")
        put(f"conv_norm_out.{leaf}", f"out.0.{leaf}")
        put(f"conv_out.{leaf}", f"out.2.{leaf}")

    # down: input_blocks i = 1..11; every 3rd (3, 6, 9) ends with a downsample
    for i in range(1, 12):
        level, j = (i - 1) // 3, (i - 1) % 3
        if j == 2:  # downsampler
            for leaf in ("weight", "bias"):
                k = f"{_LDM_UNET_PREFIX}input_blocks.{i}.0.op.{leaf}"
                if k in sd:
                    out[f"down_blocks.{level}.downsamplers.0.conv.{leaf}"] = sd[k]
            continue
        copy_res(f"down_blocks.{level}.resnets.{j}", f"input_blocks.{i}.0")
        copy_attn(f"down_blocks.{level}.attentions.{j}", f"input_blocks.{i}.1")

    copy_res("mid_block.resnets.0", "middle_block.0")
    copy_attn("mid_block.attentions.0", "middle_block.1")
    copy_res("mid_block.resnets.1", "middle_block.2")

    # up: output_blocks i = 0..11, 3 per level; upsampler on i = 2, 5, 8
    for i in range(12):
        level, j = i // 3, i % 3
        copy_res(f"up_blocks.{level}.resnets.{j}", f"output_blocks.{i}.0")
        # attention is module 1 unless this block only has an upsampler
        if f"{_LDM_UNET_PREFIX}output_blocks.{i}.1.transformer_blocks.0.attn1.to_q.weight" in sd:
            copy_attn(f"up_blocks.{level}.attentions.{j}", f"output_blocks.{i}.1")
        for mod in (1, 2):
            k = f"{_LDM_UNET_PREFIX}output_blocks.{i}.{mod}.conv.weight"
            if k in sd:
                out[f"up_blocks.{level}.upsamplers.0.conv.weight"] = sd[k]
                out[f"up_blocks.{level}.upsamplers.0.conv.bias"] = sd[
                    f"{_LDM_UNET_PREFIX}output_blocks.{i}.{mod}.conv.bias"
                ]
    return out


def _ldm_vae_to_diffusers(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """first_stage_model.* -> diffusers AutoencoderKL naming."""
    out: Dict[str, torch.Tensor] = {}
    ren_res = {"norm1": "norm1", "conv1": "conv1", "norm2": "norm2",
               "conv2": "conv2", "nin_shortcut": "conv_shortcut"}
    for k in list(sd):
        if not k.startswith(_LDM_VAE_PREFIX):
            continue
        s = k[len(_LDM_VAE_PREFIX):]
        d = None
        if s.startswith("encoder.down."):
            parts = s.split(".")
            lvl, kind = parts[2], parts[3]
            if kind == "block":
                sub = ren_res[parts[5]]
                d = f"encoder.down_blocks.{lvl}.resnets.{parts[4]}.{sub}.{parts[6]}"
            elif kind == "downsample":
                d = f"encoder.down_blocks.{lvl}.downsamplers.0.conv.{parts[5]}"
        elif s.startswith("decoder.up."):
            parts = s.split(".")
            lvl = 3 - int(parts[2])  # LDM numbers decoder ups bottom-up
            kind = parts[3]
            if kind == "block":
                sub = ren_res[parts[5]]
                d = f"decoder.up_blocks.{lvl}.resnets.{parts[4]}.{sub}.{parts[6]}"
            elif kind == "upsample":
                d = f"decoder.up_blocks.{lvl}.upsamplers.0.conv.{parts[5]}"
        elif ".mid.block_" in s:
            side, rest = s.split(".", 1)
            n = "0" if "block_1" in rest else "1"
            sub = ren_res[rest.split(".")[2]]
            d = f"{side}.mid_block.resnets.{n}.{sub}.{rest.split('.')[3]}"
        elif ".mid.attn_1." in s:
            side = s.split(".", 1)[0]
            name = s.split(".")[3]
            leaf = s.split(".")[4]
            attn_ren = {"norm": "group_norm", "q": "to_q", "k": "to_k",
                        "v": "to_v", "proj_out": "to_out.0"}
            d = f"{side}.mid_block.attentions.0.{attn_ren[name]}.{leaf}"
        elif s.startswith(("encoder.norm_out", "decoder.norm_out")):
            d = s.replace("norm_out", "conv_norm_out")
        elif s.startswith(("encoder.conv_in", "encoder.conv_out",
                           "decoder.conv_in", "decoder.conv_out",
                           "quant_conv", "post_quant_conv")):
            d = s
        if d is not None:
            out[d] = sd[k]
    return out


def load_sd15_single_file(pipe, ckpt_path: str, dtype: Optional[torch.dtype] = None) -> dict:
    """A single-file LDM checkpoint (v1-5-pruned.safetensors / sd-v1-5.ckpt
    layout) -> the port's {"unet", "vae", "text"} state dicts.  A
    .safetensors file goes through the port's own reader; any other file
    through `torch.load(weights_only=True)` (with an optional "state_dict"
    key)."""
    if ckpt_path.endswith(".safetensors"):
        sd = read_safetensors(ckpt_path)
    else:
        raw = torch.load(ckpt_path, map_location="cpu", weights_only=True)
        sd = raw.get("state_dict", raw)
    text = {k[len(_LDM_TEXT_PREFIX):]: v for k, v in sd.items()
            if k.startswith(_LDM_TEXT_PREFIX)}
    return _convert_all(pipe, {"unet": _ldm_unet_to_diffusers(sd),
                               "vae": _ldm_vae_to_diffusers(sd), "text": text}, dtype)
