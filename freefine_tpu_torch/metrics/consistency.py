"""BGC and SUBC (mirrors `freefine_tpu.metrics.consistency`).

  * BGC: CLIP ViT-B/32's cosine similarity of the source and the edited
    image with the union of the source and target masks blanked out;
  * SUBC: DINO-v1 ViT-B/16's cosine similarity of the masked subject in
    each image.

Both take an `encode(img_uint8) -> [D]` feature function, so the metric's
math runs without checkpoints; `make_clip_encoder` and `make_dino_encoder`
build one from a model on its device (the host preprocesses with
`metrics.preprocess`, PIL's resample copied), `make_dino_batch_encoder` the
(encode_batch, preprocess) pair of FID_DINO and FID_KD.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from freefine_tpu_torch.metrics.fid import pad_to
from freefine_tpu_torch.metrics.preprocess import (
    BILINEAR,
    clip_image_transform,
    dino_subc_transform,
    fid_input_transform,
    pil_resize,
)
from freefine_tpu_torch.models.dinov2 import DINOv2Config
from freefine_tpu_torch.utils.image_io import read_png


def dino_vitb16_config() -> DINOv2Config:
    """DINO-v1 ViT-B/16 in the `DINOv2` module (SUBC's encoder): patch 16,
    the native 14^2 grid at 224^2, LayerScale left at ones."""
    return DINOv2Config(dim=768, depth=12, heads=12, patch_size=16, pos_embed_size=14)


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    a = a / max(np.linalg.norm(a), 1e-12)
    b = b / max(np.linalg.norm(b), 1e-12)
    return float(max(0.0, float(a @ b)))


def _resize_mask(mask: np.ndarray, hw) -> np.ndarray:
    """PIL's BILINEAR resize of a uint8 mask to (h, w)."""
    return pil_resize(np.asarray(mask).astype(np.uint8), (hw[1], hw[0]), BILINEAR)


def background_consistency_single(
    src_img: np.ndarray, gen_img: np.ndarray,
    src_mask: np.ndarray, tgt_mask: np.ndarray,
    encode: Callable[[np.ndarray], np.ndarray],
) -> float:
    """Blank the union of the masks (src + tgt < 128 is background), encode,
    cosine."""
    m1 = _resize_mask(src_mask, src_img.shape[:2]).astype(np.int32)
    m2 = _resize_mask(tgt_mask, src_img.shape[:2]).astype(np.int32)
    keep = ((m1 + m2) < 128).astype(np.uint8)
    a = encode(src_img * keep[..., None])
    b = encode(gen_img * keep[..., None])
    return _cos(np.asarray(a), np.asarray(b))


def subject_consistency_single(
    src_img: np.ndarray, gen_img: np.ndarray,
    src_mask: np.ndarray, tgt_mask: np.ndarray,
    encode: Callable[[np.ndarray], np.ndarray],
) -> float:
    """Keep only the masked subject in each image (> 128), encode, cosine."""
    m1 = (_resize_mask(src_mask, src_img.shape[:2]) > 128).astype(np.uint8)
    m2 = (_resize_mask(tgt_mask, gen_img.shape[:2]) > 128).astype(np.uint8)
    a = encode(src_img * m1[..., None])
    b = encode(gen_img * m2[..., None])
    return _cos(np.asarray(a), np.asarray(b))


def _iterate_pairs(data: Dict, image_label: str):
    for image in data.values():
        for instance in image["instances"].values():
            for sample in instance.values():
                yield (read_png(sample["ori_img_path"], "RGB"),
                       read_png(sample[image_label], "RGB"),
                       read_png(sample["ori_mask_path"], "L"),
                       read_png(sample["tgt_mask_path"], "L"))


def background_consistency(data: Dict, image_label: str, encode) -> float:
    vals = [background_consistency_single(*pair, encode)
            for pair in _iterate_pairs(data, image_label)]
    return float(np.mean(vals)) if vals else 0.0


def subject_consistency(data: Dict, image_label: str, encode) -> float:
    vals = [subject_consistency_single(*pair, encode)
            for pair in _iterate_pairs(data, image_label)]
    return float(np.mean(vals)) if vals else 0.0


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_clip_encoder(model) -> Callable[[np.ndarray], np.ndarray]:
    """A `CLIPImageEncoder(clip_vit_b32())` on its device -> encode(img)
    [512] float32 numpy (OpenAI CLIP's preprocess on the host)."""
    device = _device(model)

    @torch.no_grad()
    def encode(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(clip_image_transform(img)).to(device)
        return model(x)[0].float().cpu().numpy()

    return encode


def make_dino_encoder(model) -> Callable[[np.ndarray], np.ndarray]:
    """A `DINOv2` (SUBC: `dino_vitb16_config()`) on its device ->
    encode(img), the class token [768] (SUBC's Resize(224) chain, no
    crop)."""
    device = _device(model)

    @torch.no_grad()
    def encode(img: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(dino_subc_transform(img)).to(device).permute(0, 3, 1, 2)
        return model(x)[1][0].float().cpu().numpy()

    return encode


def make_dino_batch_encoder(model, batch_size: int = 64):
    """(encode_batch, preprocess) for `fid.batched_features` (FID_DINO,
    FID_KD: `dinov2_vitb14()`): one forward per batch of NHWC images (on the
    card a short one padded to `batch_size`, `fid.pad_to`), the FID family's
    Resize((224, 224)) chain."""
    device = _device(model)

    @torch.no_grad()
    def encode_batch(batch: np.ndarray) -> np.ndarray:
        x = pad_to(torch.from_numpy(batch).to(device), batch_size).permute(0, 3, 1, 2)
        return model(x)[1][:len(batch)].float().cpu().numpy()

    return encode_batch, fid_input_transform
