"""Weights for the PyTorch port.

The port's modules use the diffusers / transformers state-dict keys, so a
diffusers checkpoint loads with `load_state_dict` as it is.  This module
adds:

  * `state_dict_from_flax(tree, model)` — the inverse of the JAX package's
    tree-driven converter (`freefine_tpu.weights._convert_tree`): flax
    module paths become diffusers keys through the same segment fixes and
    per-model rewrites (the port keeps its own copy of those tables), conv
    kernels HWIO -> OIHW, dense kernels IO -> OI, `scale`/`embedding` ->
    `weight`;
  * `random_weights(model, seed)` — the random-weight scheme of the
    throughput bench: norm weights 1, other 1-D leaves 0, matrices
    N(0, 0.02) drawn in float32 from a seeded `torch.Generator` and stored
    in the module's dtype.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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

_LEAF_MAP = {"kernel": "weight", "scale": "weight", "bias": "bias", "embedding": "weight"}

_UNET_REWRITES = ()
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
    from freefine_tpu_torch.models.text_encoder import CLIPTextEncoder
    from freefine_tpu_torch.models.unet import UNet2DCondition
    from freefine_tpu_torch.models.vae import AutoencoderKL

    if isinstance(model, UNet2DCondition):
        return _UNET_REWRITES
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


def state_dict_from_flax(tree: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Flax param tree of numpy arrays (as `freefine_tpu.weights.convert_*`
    return it, with or without the top-level "params") -> a state dict for
    `model`, every tensor in the model's own dtype and shape.  Raises on a
    missing, extra or misshapen key."""
    rewrites = _rewrites_for(model)
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        key = _flax_key(path, rewrites)
        a = np.asarray(leaf)
        if path[-1] == "kernel":
            if a.ndim == 4:        # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:      # IO -> OI
                a = a.T
        if key not in want:
            raise KeyError(f"flax leaf {'/'.join(path)} maps to {key}, not a key of the model")
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
