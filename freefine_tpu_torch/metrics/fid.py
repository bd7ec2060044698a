"""The FID family (mirrors `freefine_tpu.metrics.fid`): batched feature
extraction on the model's device, Fréchet and MMD distances on the host.

  * FID: InceptionV3's pool3 features (2048-d), generated images against
    the real-image folder, batches of 64;
  * FID_DINO: DINOv2 ViT-B/14's class token (768-d), the same distance;
  * FID_KD: the polynomial-kernel MMD over the same DINOv2 features.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from freefine_tpu_torch.metrics.common import compute_mmd_subsets, fid_from_features
from freefine_tpu_torch.metrics.preprocess import fid_input_transform
from freefine_tpu_torch.utils.image_io import read_png


def batched_features(
    paths: Sequence[str],
    encode_batch: Callable[[np.ndarray], np.ndarray],
    preprocess: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 64,
) -> np.ndarray:
    """Image files through a batch encoder, `batch_size` at a time; the
    tail batch goes to the encoder as it is (the encoders of this package
    pad it on the card, `pad_to`)."""
    feats: List[np.ndarray] = []
    buf: List[np.ndarray] = []

    def flush():
        if buf:
            feats.append(np.asarray(encode_batch(np.concatenate(buf, axis=0))))
            buf.clear()

    for p in paths:
        buf.append(np.asarray(preprocess(read_png(p, "RGB"))))
        if len(buf) == batch_size:
            flush()
    flush()
    return np.concatenate(feats, axis=0)


def pad_to(x: torch.Tensor, batch_size: int) -> torch.Tensor:
    """On the card, a short batch zero-padded to `batch_size` rows (as the
    JAX package pads every tail): one shape per encoder, since cuDNN builds
    an execution plan for each new convolution shape (InceptionV3's 94
    took about 20 s for two new batch sizes).  On the CPU, as it is."""
    if x.device.type != "cuda" or x.shape[0] >= batch_size:
        return x
    return torch.cat([x, x.new_zeros((batch_size - x.shape[0],) + x.shape[1:])])


def make_inception_encoder(model, batch_size: int = 64):
    """(encode_batch, preprocess) for an `InceptionV3FID` on its device:
    NHWC float32 batches in, [B, 2048] float32 numpy out."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def encode_batch(batch: np.ndarray) -> np.ndarray:
        x = pad_to(torch.from_numpy(batch).to(device), batch_size)
        return model(x)[:len(batch)].float().cpu().numpy()

    return encode_batch, fid_input_transform


def fid_inception(gen_paths: Sequence[str], real_paths: Sequence[str], model,
                  batch_size: int = 64) -> float:
    enc, prep = make_inception_encoder(model, batch_size)
    fg = batched_features(gen_paths, enc, prep, batch_size)
    fr = batched_features(real_paths, enc, prep, batch_size)
    return fid_from_features(fg, fr)


def fid_kd_from_features(feats_gen: np.ndarray, feats_real: np.ndarray) -> float:
    return compute_mmd_subsets(feats_real, feats_gen)
