"""The port's metric preprocessing (`freefine_tpu_torch.metrics.preprocess`,
Pillow's 8-bit resample copied in numpy) against the JAX package's
PIL-backed functions, bit for bit: `clip_image_transform` (BICUBIC short
side, centre crop), `dino_subc_transform` (BILINEAR short side),
`fid_input_transform` (BILINEAR square stretch) and BGC/SUBC's
`_resize_mask`, over square and non-square sizes 17-700 drawn by
hypothesis (the identity size 224 among them), plus `pil_resize` against
`Image.resize` in both filters, up and down, and a side left unchanged.
Every comparison is exact: dtype, shape and every value.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from freefine_tpu.metrics import consistency as JC
from freefine_tpu.metrics import preprocess as JP
from freefine_tpu_torch.metrics import consistency as C
from freefine_tpu_torch.metrics import preprocess as P

SIDES = st.one_of(st.integers(17, 700), st.just(224))
SETTINGS = settings(max_examples=25, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])
TRANSFORMS = ("clip_image_transform", "dino_subc_transform", "fid_input_transform")


def _image(h, w, seed, channels=3):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, channels))
    if seed % 2:  # smooth: the filters' negative lobes meet real gradients
        a = np.cumsum(a // 16, axis=1) % 256
    return a.astype(np.uint8)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", TRANSFORMS)
@SETTINGS
@given(h=SIDES, w=SIDES, seed=st.integers(0, 3))
def test_transforms_match_pil(name, h, w, seed):
    img = _image(h, w, seed)
    _same(getattr(P, name)(img), getattr(JP, name)(img))


@pytest.mark.parametrize("name", TRANSFORMS)
@SETTINGS
@given(side=SIDES, seed=st.integers(0, 3))
def test_transforms_match_pil_on_squares(name, side, seed):
    img = _image(side, side, seed)
    _same(getattr(P, name)(img), getattr(JP, name)(img))


@SETTINGS
@given(h=SIDES, w=SIDES, oh=SIDES, ow=SIDES, seed=st.integers(0, 3))
def test_resize_mask_matches_pil(h, w, oh, ow, seed):
    mask = _image(h, w, seed, 1)[..., 0]
    _same(C._resize_mask(mask, (oh, ow)), JC._resize_mask(mask, (oh, ow)))


@pytest.mark.parametrize("resample", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size,out", [((300, 200), (150, 200)), ((40, 50), (40, 700)),
                                      ((224, 224), (224, 224)), ((700, 17), (19, 699))])
def test_pil_resize_matches_image_resize(resample, size, out):
    """(h, w) -> PIL's (width, height): a pass whose side keeps its size is
    skipped, as Pillow skips it."""
    img = _image(*size, 1)
    want = np.array(Image.fromarray(img).resize(
        out, {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[resample]))
    _same(P.pil_resize(img, out, resample), want)


def test_gray_and_rgba_inputs_convert_as_pil():
    """`_to_pil(...).convert("RGB")`: gray replicated, alpha dropped."""
    for channels in (1, 4):
        img = _image(50, 30, 3, channels)
        img = img[..., 0] if channels == 1 else img
        for name in TRANSFORMS:
            _same(getattr(P, name)(img), getattr(JP, name)(img))
