"""The port's flow ops (`freefine_tpu_torch.ops.flow`) against the JAX
package's (`freefine_tpu.ops.flow`): the correlation volume, the pooled
pyramid (odd sizes floored), the zero-padded bilinear sample (integer,
fractional and out-of-range coordinates), the transposed windowed lookup
and the whole correlation block, on numpy-seeded inputs; and the lookup's
gradient to the coordinates and the features against `jax.grad`.

Tolerance: within 1e-5 of max |ref| (float32; summation order only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.ops import flow as JF
from freefine_tpu_torch.ops import flow as F

torch.set_num_threads(2)

TOL = 1e-5


def assert_close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max |diff| {err:.3g} > {tol} x max |ref| {scale:.3g}"


def _fmaps(seed, b=2, h=12, w=10, c=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2)]


def _coords(seed, b, h, w, spread=3.0):
    """(x, y) pixel centres plus seeded offsets, some past the border, a
    few exactly integral."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    c = np.stack([xs, ys], -1)[None].repeat(b, 0)
    off = rng.uniform(-spread, spread, c.shape).astype(np.float32)
    off[:, ::3] = np.round(off[:, ::3])
    return c + off


def test_correlation_volume_matches_jax():
    f1, f2 = _fmaps(0)
    want = JF.correlation_volume(jnp.asarray(f1), jnp.asarray(f2))
    assert_close(F.correlation_volume(torch.from_numpy(f1), torch.from_numpy(f2)), want)


@pytest.mark.parametrize("hw", [(12, 10), (13, 9)])
def test_corr_pyramid_matches_jax(hw):
    f1, f2 = _fmaps(1, h=hw[0], w=hw[1])
    corr = np.array(JF.correlation_volume(jnp.asarray(f1), jnp.asarray(f2)))
    want = JF.corr_pyramid(jnp.asarray(corr), 3)
    got = F.corr_pyramid(torch.from_numpy(corr), 3)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    for g, w in zip(got, want):
        assert_close(g, w)


def test_bilinear_sample_2d_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.standard_normal((9, 11)).astype(np.float32)
    yy = rng.uniform(-2, 11, (40,)).astype(np.float32)
    xx = rng.uniform(-2, 13, (40,)).astype(np.float32)
    yy[:8], xx[:8] = np.round(yy[:8]), np.round(xx[:8])
    yy[8], xx[8] = 8.0, 10.0   # the last pixel: its upper neighbours lie outside
    want = JF.bilinear_sample_2d(jnp.asarray(img), jnp.asarray(yy), jnp.asarray(xx))
    got = F.bilinear_sample_2d(torch.from_numpy(img), torch.from_numpy(yy), torch.from_numpy(xx))
    assert_close(got, want)


@pytest.mark.parametrize("radius", [4, 2])
def test_corr_lookup_matches_jax(radius):
    f1, f2 = _fmaps(3)
    corr = np.array(JF.correlation_volume(jnp.asarray(f1), jnp.asarray(f2)))
    coords = _coords(4, 2, 12, 10)
    want = JF.corr_lookup(JF.corr_pyramid(jnp.asarray(corr), 4), jnp.asarray(coords), radius)
    got = F.corr_lookup(F.corr_pyramid(torch.from_numpy(corr), 4), torch.from_numpy(coords),
                        radius)
    assert got.shape == want.shape == (2, 12, 10, 4 * (2 * radius + 1) ** 2)
    assert_close(got, want)


def test_corr_lookup_window_is_transposed():
    """The x offset runs along the first window axis: a volume that is a
    ramp in x alone gives a window that varies along its first axis."""
    corr = np.broadcast_to(np.arange(10, dtype=np.float32), (1, 1, 1, 6, 10)).copy()
    coords = np.array([[[[5.0, 2.0]]]], np.float32)
    win = F.corr_lookup(F.corr_pyramid(torch.from_numpy(corr), 1), torch.from_numpy(coords),
                        1).reshape(3, 3)
    assert torch.equal(win[:, 0], torch.tensor([4.0, 5.0, 6.0]))
    assert torch.equal(win[0], torch.full((3,), 4.0))


def test_corr_block_matches_jax():
    f1, f2 = _fmaps(5, h=16, w=16)
    coords = _coords(6, 2, 16, 16)
    want = JF.corr_block(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords))
    got = F.corr_block(*(torch.from_numpy(x) for x in (f1, f2, coords)))
    assert_close(got, want)


def test_corr_lookup_gradients_match_jax():
    f1, f2 = _fmaps(7, b=1)
    coords = _coords(8, 1, 12, 10)
    cot = np.random.default_rng(9).standard_normal((1, 12, 10, 4 * 81)).astype(np.float32)

    def jloss(a, b, c):
        pyr = JF.corr_pyramid(JF.correlation_volume(a, b), 4)
        return jnp.sum(JF.corr_lookup(pyr, c, 4) * cot)

    want = jax.grad(jloss, argnums=(1, 2))(*(jnp.asarray(x) for x in (f1, f2, coords)))
    a, b, c = (torch.from_numpy(x).requires_grad_() for x in (f1, f2, coords))
    loss = torch.sum(F.corr_block(a, b, c) * torch.from_numpy(cot))
    got = torch.autograd.grad(loss, (b, c))
    for g, w in zip(got, want):
        assert_close(g, w)


def test_map_coordinates_mirror_matches_jax():
    rng = np.random.default_rng(10)
    img = rng.standard_normal((3, 7, 9)).astype(np.float32)
    yy = rng.uniform(-9, 16, (3, 5, 6)).astype(np.float32)
    xx = rng.uniform(-9, 18, (3, 5, 6)).astype(np.float32)
    yy[:, 0], xx[:, 0] = np.round(yy[:, 0]), np.round(xx[:, 0])
    want = jax.vmap(lambda i, y, x: jax.scipy.ndimage.map_coordinates(
        i, [y, x], order=1, mode="mirror"))(*(jnp.asarray(a) for a in (img, yy, xx)))
    got = F.map_coordinates_linear(*(torch.from_numpy(a) for a in (img, yy, xx)), mode="mirror")
    assert_close(got, want)
