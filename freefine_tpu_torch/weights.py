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
    the T5 tower's (transformers' `T5EncoderModel` names); DINOv2's
    (torchhub names), Depth-Anything's and EfficientSAM's; SV3D's video
    UNet (sgm's names), the CLIP image tower (open_clip's) and U^2-Net
    (the official names);
  * `lora_from_flax(lora)` — a JAX LoRA's factors keyed by the adapted
    UNet weights' state-dict keys (DragDiffusion);
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
    by the port's own writer);
  * the perception checkpoints: `load_depth_anything` (transformers'
    `DepthAnythingForDepthEstimation` safetensors, its DINOv2 backbone
    renamed by the port's copy of `hf_dinov2_to_torchhub`) and
    `load_efficient_sam` (the published `torch.save`d file);
  * SV3D: `load_sv3d` (one sv3d_p.safetensors split into the video UNet,
    the ViT-H image tower and the VAE) and `load_u2net` (u2netp.pth);
  * RAFT: `load_raft` (raft-things.pth or a .safetensors copy), and
    RAFT's flax tree in `state_dict_from_flax`.
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
             "scale_shift_table": "scale_shift_table",
             # DINOv2's LayerScale, class token and position table, and
             # EfficientSAM's LayerNorm2d, keep their own names
             "gamma": "gamma", "cls_token": "cls_token", "pos_embed": "pos_embed",
             "weight": "weight"}

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
# DINOv2 (torchhub names), Depth-Anything (transformers' neck and head
# names, the backbone under "backbone.") and EfficientSAM (the reference's
# names): the inverses of `freefine_tpu.weights.convert_dinov2`,
# `convert_depth_anything_hf` and `convert_efficient_sam`.
_DINOV2_REWRITES = (
    (r"(^|\.)patch_embed$", r"\1patch_embed.proj"),
    (r"\.mlp_fc(\d)$", r".mlp.fc\1"),
)
_DEPTH_ANYTHING_REWRITES = (
    (r"^pretrained(\.|$)", r"backbone\1"),
    *_DINOV2_REWRITES,
    (r"^depth_head\.projects\.(\d)$", r"neck.reassemble_stage.layers.\1.projection"),
    (r"^depth_head\.resize\.(\d)$", r"neck.reassemble_stage.layers.\1.resize"),
    (r"^depth_head\.layer(\d)_rn$", lambda m: f"neck.convs.{int(m[1]) - 1}"),
    (r"^depth_head\.refinenet(\d)", lambda m: f"neck.fusion_stage.layers.{4 - int(m[1])}"),
    (r"\.resConfUnit(\d)\.conv(\d)$", r".residual_layer\1.convolution\2"),
    (r"\.out_conv$", ".projection"),
    (r"^depth_head\.output_conv1$", "head.conv1"),
    (r"^depth_head\.output_conv2\.0$", "head.conv2"),
    (r"^depth_head\.output_conv2\.2$", "head.conv3"),
)
_SAM_BARE_PARAMS = {
    "prompt_encoder.positional_encoding_gaussian_matrix":
        "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
    "prompt_encoder.invalid_points": "prompt_encoder.invalid_points.weight",
    "prompt_encoder.point_embeddings": "prompt_encoder.point_embeddings.weight",
    "prompt_encoder.bbox_top_left_embeddings": "prompt_encoder.bbox_top_left_embeddings.weight",
    "prompt_encoder.bbox_bottom_right_embeddings":
        "prompt_encoder.bbox_bottom_right_embeddings.weight",
    "mask_decoder.iou_token": "mask_decoder.iou_token.weight",
    "mask_decoder.mask_tokens": "mask_decoder.mask_tokens.weight",
}
_SAM_REWRITES = (
    (r"^image_encoder\.patch_embed$", "image_encoder.patch_embed.proj"),
    (r"\.attn_qkv$", ".attn.qkv"),
    (r"\.attn_proj$", ".attn.proj"),
    (r"\.mlp_fc(\d)$", r".mlp.fc\1"),
    (r"^mask_decoder\.layers\.", "mask_decoder.transformer.layers."),
    (r"^mask_decoder\.(final_attn_token_to_image|norm_final_attn)",
     r"mask_decoder.transformer.\1"),
    (r"^(mask_decoder\.transformer\.layers\.\d+)\.mlp\.layers\.(\d+)$", r"\1.mlp.layers.\2.0"),
    (r"^mask_decoder\.upscale\.(\d+)$", r"mask_decoder.final_output_upscaling_layers.\1.0"),
    (r"^mask_decoder\.upscale_norm\.(\d+)$",
     r"mask_decoder.final_output_upscaling_layers.\1.1"),
    (r"^mask_decoder\.hyper_mlps\.(\d+)\.layers\.(\d+)$",
     r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2.0"),
    (r"^mask_decoder\.hyper_mlps\.(\d+)\.fc$", r"mask_decoder.output_hypernetworks_mlps.\1.fc"),
    (r"^mask_decoder\.iou_prediction_head\.layers\.(\d+)$",
     r"mask_decoder.iou_prediction_head.layers.\1.0"),
)
# Transposed convs: flax [kh, kw, in, out] <-> torch [in, out, kh, kw];
# EfficientSAM's converter also flips the kernel spatially, Depth-Anything's
# does not (ROADMAP C9), and each inverse undoes exactly its converter.
_DECONV_KEYS = {_DEPTH_ANYTHING_REWRITES: r"^neck\.reassemble_stage\.layers\.[01]\.resize\.weight$",
                _SAM_REWRITES: r"final_output_upscaling_layers\.\d+\.0\.weight$"}

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
    from freefine_tpu_torch.models.depth_anything import DepthAnything
    from freefine_tpu_torch.models.dinov2 import DINOv2
    from freefine_tpu_torch.models.dit import DiT2DCondition
    from freefine_tpu_torch.models.efficient_sam import EfficientSAM
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
    if isinstance(model, DINOv2):
        return _DINOV2_REWRITES
    if isinstance(model, DepthAnything):
        return _DEPTH_ANYTHING_REWRITES
    if isinstance(model, EfficientSAM):
        return _SAM_REWRITES
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


def _torch_layout(name: str, a: np.ndarray) -> np.ndarray:
    """A flax kernel in torch's layout: conv HWIO -> OIHW, dense IO -> OI."""
    if name == "kernel":
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)
        if a.ndim == 2:
            return a.T
    return a


def _clip_image_items(tree: Mapping):
    """(state-dict key, array, flax path) of each leaf of a CLIP image
    tower's flax tree (`freefine_tpu.models.clip_image`), in open_clip's
    `VisionTransformer` names: the inverse of
    `freefine_tpu.weights.convert_open_clip_vision`.  Each layer's q, k, v
    projections are fused (in that order) into `attn.in_proj_weight` and
    `attn.in_proj_bias`."""
    bare = {"class_embedding": "class_embedding", "position_embedding": "positional_embedding",
            "visual_projection": "proj"}
    norms = {"pre_layrnorm": "ln_pre", "post_layernorm": "ln_post"}
    layer = {"layer_norm1": "ln_1", "layer_norm2": "ln_2", "out_proj": "attn.out_proj",
             "fc1": "mlp.c_fc", "fc2": "mlp.c_proj"}
    qkv: Dict[tuple, dict] = {}
    for path, leaf in _flatten(tree):
        mods = [m for m in path[:-1] if m not in ("params", "LayerNorm_0")]
        name, a, where = path[-1], np.asarray(leaf), "/".join(path)
        if name in bare:
            yield bare[name], a, where
        elif mods == ["patch_embedding"]:
            yield "conv1.weight", _torch_layout(name, a), where
        elif mods[0] in norms:
            yield f"{norms[mods[0]]}.{_LEAF_MAP[name]}", a, where
        else:
            base = f"transformer.resblocks.{mods[0].rsplit('_', 1)[1]}"
            sub = mods[-1]
            if sub in ("q_proj", "k_proj", "v_proj"):
                qkv.setdefault((base, name), {})[sub[0]] = (_torch_layout(name, a), where)
            else:
                yield f"{base}.{layer[sub]}.{_LEAF_MAP[name]}", _torch_layout(name, a), where
    for (base, name), parts in qkv.items():
        fused = np.concatenate([parts[p][0] for p in "qkv"], axis=0)
        yield (f"{base}.attn.in_proj_{'weight' if name == 'kernel' else 'bias'}", fused,
               parts["q"][1])


_U2NET_BN = {"bn_scale": "bn_s1.weight", "bn_bias": "bn_s1.bias",
             "bn_mean": "bn_s1.running_mean", "bn_var": "bn_s1.running_var"}


def _u2net_items(tree: Mapping):
    """(state-dict key, array, flax path) of each leaf of a U^2-Net's flax
    tree, in the official names (`conv_s1` / `bn_s1` under each ConvBNReLU;
    sides and `outconv` plain): the inverse of
    `freefine_tpu.weights.convert_u2net`."""
    for path, leaf in _flatten(tree):
        mods = [m for m in path[:-1] if m != "params"]
        name, a, where = path[-1], np.asarray(leaf), "/".join(path)
        if name in _U2NET_BN:
            yield ".".join(mods + [_U2NET_BN[name]]), a, where
        elif mods[-1] == "conv":
            yield ".".join(mods[:-1] + ["conv_s1", _LEAF_MAP[name]]), _torch_layout(name, a), where
        else:
            yield ".".join(mods + [_LEAF_MAP[name]]), _torch_layout(name, a), where


# the flax video UNet's res-block and transformer leaves -> sgm's names
_SGM_RES = {"norm1": "in_layers.0", "conv1": "in_layers.2", "time_emb_proj": "emb_layers.1",
            "norm2": "out_layers.0", "conv2": "out_layers.3", "conv_shortcut": "skip_connection"}
_SGM_ATTN = {"attn1_to_q": "attn1.to_q", "attn1_to_k": "attn1.to_k", "attn1_to_v": "attn1.to_v",
             "attn1_to_out": "attn1.to_out.0", "attn2_to_q": "attn2.to_q",
             "attn2_to_k": "attn2.to_k", "attn2_to_v": "attn2.to_v",
             "attn2_to_out": "attn2.to_out.0", "ff_in": "ff_in", "ff": "ff", "net_0": "net.0",
             "net_2": "net.2", "proj": "proj", "norm_in": "norm_in", "norm1": "norm1",
             "norm2": "norm2", "norm3": "norm3"}


def _sgm_block_positions(channel_mult=(1, 2, 4, 4), num_res: int = 2,
                        attention_levels=(True, True, True, False)) -> Dict[str, str]:
    """The flax video UNet's block names -> sgm's module paths
    (`input_blocks.i.j`, `middle_block.j`, `output_blocks.i.j`; an up
    level's upsampler after its attention where the level has one).  The
    port's copy of `freefine_tpu.weights_sv3d._block_positions`."""
    pos, i, n = {}, 1, len(channel_mult)
    for lvl in range(n):
        for j in range(num_res):
            pos[f"down_{lvl}_res_{j}"] = f"input_blocks.{i}.0"
            pos[f"down_{lvl}_attn_{j}"] = f"input_blocks.{i}.1"
            i += 1
        if lvl < n - 1:
            pos[f"down_{lvl}_ds"] = f"input_blocks.{i}.0.op"
            i += 1
    pos.update(mid_res_0="middle_block.0", mid_attn="middle_block.1", mid_res_1="middle_block.2")
    i = 0
    for u in range(n):
        lvl = n - 1 - u
        for j in range(num_res + 1):
            pos[f"up_{u}_res_{j}"] = f"output_blocks.{i}.0"
            pos[f"up_{u}_attn_{j}"] = f"output_blocks.{i}.1"
            if j == num_res:
                pos[f"up_{u}_us"] = f"output_blocks.{i}.{2 if attention_levels[lvl] else 1}.conv"
            i += 1
    pos.update(conv_in="input_blocks.0.0", label_emb_0="label_emb.0.0",
               label_emb_2="label_emb.0.2", out_norm="out.0", out_conv="out.2")
    return pos


def _video_unet_items(tree: Mapping, cfg):
    """(state-dict key, array, flax path) of each leaf of the flax video
    UNet's tree (`freefine_tpu.models.video_unet`), in sgm's names (the
    `model.diffusion_model.` prefix dropped): the inverse of
    `freefine_tpu.weights_sv3d.convert_sv3d_unet`.  The temporal res
    blocks' (3, 1) kernels become the checkpoint's 5-D [out, in, 3, 1, 1]."""
    pos = _sgm_block_positions(cfg.channel_mult, cfg.num_res_blocks, cfg.attention_levels)
    for path, leaf in _flatten(tree):
        top, *mods = [m for m in path[:-1] if m not in ("params", "LayerNorm_0")]
        name, a, where = path[-1], np.asarray(leaf), "/".join(path)
        if top == "time_embed":
            key = f"time_embed.{ {'linear_1': 0, 'linear_2': 2}[mods[0]] }"
        elif "_res_" in top:
            if mods and mods[0] == "time_stack":
                key = f"{pos[top]}.time_stack.{_SGM_RES[mods[1]]}"
                if name == "kernel" and a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)[..., None]
            else:
                key = ".".join([pos[top]] + [_SGM_RES.get(m, m) for m in mods])
        elif "attn" in top:
            if mods[0] in ("norm", "proj_in", "proj_out", "time_mixer"):
                key = ".".join([pos[top]] + mods)
            elif mods[0] == "time_stack" and mods[1].startswith("time_pos_embed"):
                key = f"{pos[top]}.time_pos_embed.{mods[1][-1]}"
            elif mods[0] == "time_stack":
                key = ".".join([f"{pos[top]}.time_stack.0"] + [_SGM_ATTN[m] for m in mods[1:]])
            else:
                key = ".".join([f"{pos[top]}.transformer_blocks.0"]
                               + [_SGM_ATTN[m] for m in mods])
        else:
            key = pos[top]
        leaf_name = "mix_factor" if name == "mix_factor" else _LEAF_MAP[name]
        yield f"{key}.{leaf_name}", _torch_layout(name, a), where


# RAFT's flax module and leaf names -> the reference checkpoint's
_RAFT_MODULES = {"flow_head_conv1": "flow_head.conv1", "flow_head_conv2": "flow_head.conv2",
                 "mask_0": "mask.0", "mask_2": "mask.2", "downsample": "downsample.0",
                 "norm3": "downsample.1"}
_RAFT_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _raft_items(tree: Mapping):
    """(state-dict key, array, flax path) of each leaf of a RAFT's flax tree
    (`freefine_tpu.models.raft`), in the reference checkpoint's names: the
    port's copy of that module's `_torch_key`, conv kernels HWIO -> OIHW."""
    for path, leaf in _flatten(tree):
        mods = [m for m in path[:-1] if m != "params"]
        name, a, where = path[-1], np.asarray(leaf), "/".join(path)
        parts = []
        for m in mods:
            if m.startswith("layer") and "_" in m:
                stage, idx = m[len("layer"):].split("_")
                parts.append(f"layer{stage}.{idx}")
            else:
                parts.append(_RAFT_MODULES.get(m, m))
        yield ".".join(parts + [_RAFT_BN[name] if name in _RAFT_BN else _LEAF_MAP[name]]), \
            _torch_layout(name, a), where


def _flax_items(tree: Mapping, model: nn.Module):
    """(state-dict key, array in the torch layout, flax path) of each leaf."""
    from freefine_tpu_torch.models.clip_image import CLIPImageEncoder
    from freefine_tpu_torch.models.open_clip_text import OpenCLIPTextHidden
    from freefine_tpu_torch.models.raft import RAFT
    from freefine_tpu_torch.models.t5 import T5Encoder
    from freefine_tpu_torch.models.u2net import U2Net
    from freefine_tpu_torch.models.video_unet import VideoUNet

    special = {OpenCLIPTextHidden: _open_clip_items, T5Encoder: _t5_items,
               CLIPImageEncoder: _clip_image_items, U2Net: _u2net_items, RAFT: _raft_items}
    for cls, items in special.items():
        if isinstance(model, cls):
            yield from items(tree)
            return
    if isinstance(model, VideoUNet):
        yield from _video_unet_items(tree, model.config)
        return
    rewrites = _rewrites_for(model)
    deconv = _DECONV_KEYS.get(rewrites)
    for path, leaf in _flatten(tree):
        a = np.asarray(leaf)
        bare = ".".join(m for m in path if m != "params")
        key = (_SAM_BARE_PARAMS[bare] if rewrites is _SAM_REWRITES and bare in _SAM_BARE_PARAMS
               else _flax_key(path, rewrites))
        if path[-1] == "kernel":
            if deconv and re.search(deconv, key):
                if rewrites is _SAM_REWRITES:
                    a = a[::-1, ::-1]
                a = a.transpose(2, 3, 0, 1)
            elif a.ndim == 4:      # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:      # IO -> OI
                a = a.T
        yield key, a, "/".join(path)


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


def lora_from_flax(lora: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX LoRA ({joined flax path ".../attn1/to_q/kernel": {"a": [in, r],
    "b": [r, out]}}, as `freefine_tpu.baselines.drag_diffusion.init_lora`
    draws it) -> the port's form (`baselines.drag_diffusion`): keyed by the
    adapted weight's state-dict key ("...attn1.to_q.weight",
    "...to_out.0.weight"), the factors float32 tensors as they are, since
    the port merges W + (a @ b)^T into torch's [out, in] weight."""
    out = {}
    for key, ab in lora.items():
        path = tuple(key.split("/"))
        if path[-1] != "kernel":
            raise KeyError(f"LoRA factors of {key}: not a dense kernel")
        out[_flax_key(path, _UNET_REWRITES)] = {
            n: torch.from_numpy(np.array(ab[n], np.float32)) for n in ("a", "b")}
    return out


@torch.no_grad()
def random_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill `model` in place with the bench's random-weight scheme; draws
    come from a `torch.Generator` on each parameter's device."""
    norm_weights = {id(p) for m in model.modules() if isinstance(m, NORM_TYPES)
                    for name, p in m.named_parameters(recurse=False)
                    if name in ("weight", "gamma")}
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


# ---------------------------------------------------------------------------
# Perception checkpoints: Depth-Anything (transformers) and EfficientSAM
# ---------------------------------------------------------------------------

# transformers' Dinov2 layer -> torchhub block, the tensors renamed one to one
_HF_DINOV2_BLOCK = {"attention.output.dense": "attn.proj", "norm1": "norm1", "norm2": "norm2",
                    "mlp.fc1": "mlp.fc1", "mlp.fc2": "mlp.fc2"}
_HF_QKV = ("query", "key", "value")
# tensors of a transformers Depth-Anything checkpoint that the forward never
# reads: Dinov2's mask token, and the first fusion layer's residual unit (it
# gets no residual input)
_DA_UNUSED = re.compile(r"^backbone\.embeddings\.mask_token$|"
                        r"^neck\.fusion_stage\.layers\.0\.residual_layer1\.")


def hf_dinov2_to_torchhub(sd: Mapping[str, torch.Tensor], prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """A transformers Dinov2Model / Dinov2Backbone state dict (keys under
    `prefix`) -> torchhub facebookresearch/dinov2 names (query, key and
    value fused into `qkv`); the port's copy of the JAX package's
    `hf_dinov2_to_torchhub`."""
    g = lambda k: sd[prefix + k]  # noqa: E731
    t = {"cls_token": g("embeddings.cls_token"),
         "pos_embed": g("embeddings.position_embeddings"),
         "patch_embed.proj.weight": g("embeddings.patch_embeddings.projection.weight"),
         "patch_embed.proj.bias": g("embeddings.patch_embeddings.projection.bias")}
    i = 0
    while f"{prefix}encoder.layer.{i}.norm1.weight" in sd:
        p = f"encoder.layer.{i}"
        for leaf in ("weight", "bias"):
            t[f"blocks.{i}.attn.qkv.{leaf}"] = torch.cat(
                [g(f"{p}.attention.attention.{n}.{leaf}") for n in _HF_QKV], 0)
            for hf, hub in _HF_DINOV2_BLOCK.items():
                t[f"blocks.{i}.{hub}.{leaf}"] = g(f"{p}.{hf}.{leaf}")
        t[f"blocks.{i}.ls1.gamma"] = g(f"{p}.layer_scale1.lambda1")
        t[f"blocks.{i}.ls2.gamma"] = g(f"{p}.layer_scale2.lambda1")
        i += 1
    if prefix + "layernorm.weight" in sd:
        t["norm.weight"] = g("layernorm.weight")
        t["norm.bias"] = g("layernorm.bias")
    return t


def load_depth_anything(model: nn.Module, path: str) -> nn.Module:
    """Fill a `DepthAnything` in place from a transformers
    `DepthAnythingForDepthEstimation` checkpoint (a .safetensors file, or a
    folder of them, read by the port's own reader): the backbone's tensors
    renamed by `hf_dinov2_to_torchhub`, the neck's and head's as they are,
    each cast to the model's dtype; the two never-read tensors
    (`_DA_UNUSED`) dropped.  Any other tensor the model lacks, or a missing
    or misshapen one, raises.  Returns the model."""
    sd = read_safetensors_dir(path) if os.path.isdir(path) else read_safetensors(path)
    extra = sorted(k for k in sd if not k.startswith("backbone.") and not _DA_UNUSED.match(k)
                   and k not in model.state_dict())
    if extra:
        raise KeyError(f"{len(extra)} checkpoint tensors the model lacks, e.g. {extra[:5]}")
    tensors = {f"backbone.{k}": v for k, v in hf_dinov2_to_torchhub(sd, "backbone.").items()}
    tensors.update((k, v) for k, v in sd.items() if not k.startswith("backbone."))
    model.load_state_dict(_convert(tensors, model.state_dict()))
    return model


def load_efficient_sam(model: nn.Module, path: str) -> nn.Module:
    """Fill an `EfficientSAM` in place from the published checkpoint
    (efficient_sam_vits.pt / efficient_sam_vitt.pt: a `torch.save`d
    {"model": state_dict}, read with `torch.load(weights_only=True)`), each
    tensor cast to the model's dtype.  The module names are the
    checkpoint's; a missing or misshapen tensor raises.  Returns the
    model."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(_convert(raw.get("model", raw), model.state_dict()))
    return model


# ---------------------------------------------------------------------------
# SV3D: the sgm checkpoint and U^2-Net
# ---------------------------------------------------------------------------

_SV3D_CLIP_PREFIX = "conditioner.embedders.0.open_clip.model.visual."
# a video decoder's temporal tensors (sgm's VideoDecoder: `time_stack`,
# `time_mixer`, `time_mix_conv`, ...), which the image VAE has no place for
_VIDEO_VAE_ONLY = re.compile(r"\.(time_[a-z_]+|video_time_embed)\.")


def load_sv3d(path: str, unet_config=None, clip_config=None,
              vae_config=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """sv3d_p.safetensors (one sgm checkpoint, read by the port's own
    reader) -> {"unet", "clip_image", "vae"} state dicts for
    `VideoUNet(unet_config)` (`model.diffusion_model.*`, sgm's names as they
    are), `CLIPImageEncoder(clip_config)` (the open_clip ViT-H under
    `conditioner.embedders.0.open_clip.model.visual.*`) and
    `AutoencoderKL(vae_config)` (`first_stage_model.*` through the LDM VAE
    renames).  Configs default to SV3D_p's (`sv3d_config`, `clip_vit_h14`,
    `VAEConfig()`); each tensor is cast to its module's dtype, which the
    config sets.  A missing or misshapen tensor raises, and so does a
    video decoder's temporal tensor (`_VIDEO_VAE_ONLY`): the port decodes
    with the image VAE, as the JAX package does, and would decode such a
    checkpoint otherwise than sgm's VideoDecoder."""
    from freefine_tpu_torch.config import VAEConfig
    from freefine_tpu_torch.models.clip_image import CLIPImageEncoder, clip_vit_h14
    from freefine_tpu_torch.models.vae import AutoencoderKL
    from freefine_tpu_torch.models.video_unet import VideoUNet, sv3d_config

    sd = read_safetensors(path)
    temporal = sorted(k for k in sd
                      if k.startswith(_LDM_VAE_PREFIX) and _VIDEO_VAE_ONLY.search(k))
    if temporal:
        raise ValueError(f"{path} holds a video decoder ({len(temporal)} temporal VAE tensors, "
                         f"e.g. {temporal[:3]}); the image VAE would decode it otherwise")
    with torch.device("meta"):
        want = {"unet": VideoUNet(unet_config or sv3d_config()).state_dict(),
                "clip_image": CLIPImageEncoder(clip_config or clip_vit_h14()).state_dict(),
                "vae": AutoencoderKL(vae_config or VAEConfig()).state_dict()}

    def under(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    tensors = {"unet": under(_LDM_UNET_PREFIX), "clip_image": under(_SV3D_CLIP_PREFIX),
               "vae": _ldm_vae_to_diffusers(sd)}
    return {name: _convert(tensors[name], want[name]) for name in want}


def load_u2net(model: nn.Module, path: str) -> nn.Module:
    """Fill a `U2Net` in place from the official u2net.pth / u2netp.pth (a
    `torch.save`d state dict, read with `torch.load(weights_only=True)`),
    each tensor cast to the model's dtype; the BatchNorms'
    `num_batches_tracked`, which inference never reads, is ignored.  A
    missing or misshapen tensor raises.  Returns the model."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(_convert(raw.get("state_dict", raw), model.state_dict()))
    return model


def _raft_state_dict(raw: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference RAFT state dict (raft-things.pth) in the port's names:
    the `module.` prefix stripped; the BatchNorms' `num_batches_tracked`,
    which inference never reads, dropped; and each shortcut norm's `norm3`
    alias dropped where its `downsample.1` twin is present (the reference
    registers that module under both names)."""
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in raw.items()}
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        head, sep, leaf = k.rpartition(".norm3.")
        if sep and f"{head}.downsample.1.{leaf}" in sd:
            continue
        out[k] = v
    return out


def load_raft(model: nn.Module, path: str) -> nn.Module:
    """Fill a `RAFT` in place from the reference checkpoint: a `.pth` state
    dict (`torch.load(weights_only=True)`) or a `.safetensors` file, in
    `_raft_state_dict`'s names, loaded strictly (a missing, extra or
    misshapen tensor raises); each tensor is copied into the model's dtype
    and device.  Returns the model."""
    if path.endswith(".safetensors"):
        raw = read_safetensors(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
        raw = raw.get("state_dict", raw)
    model.load_state_dict(_raft_state_dict(raw), strict=True)
    return model
