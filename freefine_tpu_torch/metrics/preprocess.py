"""Host-side metric preprocessing (mirrors `freefine_tpu.metrics.preprocess`),
bit for bit with PIL's, without PIL.

The JAX package resizes with `PIL.Image.resize`; this module copies
Pillow's resample of 8-bit images (`Resample.c`) in numpy:

  * per output pixel i of a side: scale = in / out, filterscale =
    max(scale, 1), support = the filter's support * filterscale, center =
    (i + 0.5) * scale, taps x in [int(center - support + 0.5),
    int(center + support + 0.5)) clipped to the image, weights
    f((x - center + 0.5) / filterscale) normalised by their running sum;
  * each weight in fixed point with 22 fractional bits, rounded away from
    zero; the accumulator starts at 2^21 and is shifted right by 22 and
    clipped to 0..255;
  * the horizontal pass first, rounded to uint8, then the vertical one; a
    pass whose side keeps its size is skipped;
  * BILINEAR is the triangle (support 1), BICUBIC Keys' cubic with a = -0.5
    (support 2; the port's `ops.resize` uses torch's a = -0.75).

  * `clip_image_transform`: the short side to `size` by BICUBIC, a centre
    crop, CLIP's normalisation (BGC, HPS, IRS);
  * `dino_subc_transform`: the short side to `size` by BILINEAR, ImageNet's
    normalisation, no crop (SUBC);
  * `fid_input_transform`: a square stretch to `size` by BILINEAR, ImageNet's
    normalisation (FID, FID_DINO, FID_KD).

Each takes a uint8 RGB [H, W, 3] array and returns float32 [1, h, w, 3].
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

BILINEAR, BICUBIC = "bilinear", "bicubic"
_PRECISION_BITS = 22


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


_FILTERS = {BILINEAR: (_bilinear, 1.0), BICUBIC: (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, resample: str):
    """Pillow's `precompute_coeffs` and `normalize_coeffs_8bpc`: per output
    pixel the first tap [out] and the fixed-point weights [out, ksize]
    (zero past each pixel's last tap)."""
    fn, filter_support = _FILTERS[resample]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    taps = np.arange(ksize)
    w = fn(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # the running sum, in Pillow's order
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    k = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS), 0.5 + w * (1 << _PRECISION_BITS))
    return xmin, k.astype(np.int64)


def _pass(img: np.ndarray, axis: int, out_size: int, resample: str) -> np.ndarray:
    """One 8-bit resample pass along `axis` (0 rows, 1 columns) of uint8
    [H, W, C]."""
    xmin, k = _coeffs(img.shape[axis], out_size, resample)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :], img.shape[axis] - 1)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        acc += src[idx[:, t]] * k[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_resize(img: np.ndarray, size, resample: str) -> np.ndarray:
    """`Image.resize((w, h), resample)` of a uint8 [H, W] or [H, W, C]
    array: `size` is PIL's (width, height)."""
    a = np.asarray(img, np.uint8)
    flat = a.ndim == 2
    if flat:
        a = a[..., None]
    w, h = size
    if a.shape[1] != w:
        a = _pass(a, 1, w, resample)
    if a.shape[0] != h:
        a = _pass(a, 0, h, resample)
    return a[..., 0] if flat else a


def _rgb(img_uint8: np.ndarray) -> np.ndarray:
    """PIL's `Image.fromarray(...).convert("RGB")` of a uint8 array."""
    a = np.ascontiguousarray(np.asarray(img_uint8, np.uint8))
    if a.ndim == 2:
        return np.repeat(a[..., None], 3, axis=2)
    return a[..., :3]


def _resize_short_side(img: np.ndarray, size: int, resample: str) -> np.ndarray:
    """torchvision's Resize(int): the short side to `size`, the long side
    to int(size * long / short); an image whose short side is `size`
    already is returned as it is."""
    h, w = img.shape[:2]
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        ow, oh = int(size * w / h), size
    return pil_resize(img, (ow, oh), resample)


def _center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision's CenterCrop: offsets round((dim - size) / 2), Python's
    round (half to even)."""
    h, w = img.shape[:2]
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img[top:top + size, left:left + size]


def _normalise(img: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    x = np.asarray(img, np.float32) / 255.0
    return ((x - mean) / std)[None]


def clip_image_transform(img_uint8: np.ndarray, size: int = 224) -> np.ndarray:
    """OpenAI CLIP's preprocess (clip.load, ImageReward, hpsv2's eval)."""
    img = _resize_short_side(_rgb(img_uint8), size, BICUBIC)
    return _normalise(_center_crop(img, size), CLIP_MEAN, CLIP_STD)


def dino_subc_transform(img_uint8: np.ndarray, size: int = 224) -> np.ndarray:
    """SUBC's DINO chain: Resize(224) BILINEAR, ImageNet's normalisation, no
    crop (a non-square image keeps its aspect)."""
    img = _resize_short_side(_rgb(img_uint8), size, BILINEAR)
    return _normalise(img, IMAGENET_MEAN, IMAGENET_STD)


def fid_input_transform(img_uint8: np.ndarray, size: int = 224) -> np.ndarray:
    """The FID family's input chain: Resize((224, 224)) BILINEAR, ImageNet's
    normalisation; InceptionV3 upsamples to 299 inside the model."""
    img = pil_resize(_rgb(img_uint8), (size, size), BILINEAR)
    return _normalise(img, IMAGENET_MEAN, IMAGENET_STD)
