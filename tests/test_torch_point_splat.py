"""The port's depth-based 3D edit and GeoBench-3D authoring warp against the
JAX package (`ops.point_splat`, `ops.geodiff_warp`).

Tolerances: the geometry (`euler_xyz_matrix`, `backproject`,
`transform_object_points`, `compute_correspondence`, `normalize_depth`,
`geodiff_transform_matrix`) within 1e-5 of max |ref|; the splats'
scatter-adds sum in another order, so a pixel at a coverage threshold may
flip: masks equal except at <= 0.05 % of the pixels, images within 1 level
where the masks agree; `inpaint_fmm` equal to JAX's (the port checks its
mask every FMM_CHECK_EVERY rounds, so also at other check intervals, and an
all-hole image that runs to the h + w cap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.ops import geodiff_warp as JG
from freefine_tpu.ops import point_splat as JP
from freefine_tpu_torch.ops import geodiff_warp as G
from freefine_tpu_torch.ops import point_splat as P
from test_torch_depth import assert_close

torch.set_num_threads(2)

H, W = 96, 128
GEOM_TOL = 1e-5
MASK_SHARE = 5e-4


def scene(seed=0, h=H, w=W):
    """A textured image, an elliptic object and a smooth depth (the object
    nearer than its surroundings)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.clip(128 + 60 * np.sin(xx / 7.0)[..., None] * np.cos(yy / 5.0)[..., None]
                  + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
    obj = ((yy - 0.5 * h) / (0.25 * h)) ** 2 + ((xx - 0.45 * w) / (0.2 * w)) ** 2 < 1
    mask = obj.astype(np.uint8) * 255
    depth = (4.0 + 0.8 * xx / w + 0.3 * np.sin(yy / 9.0) - 1.2 * obj).astype(np.float32)
    return img, mask, depth


EDITS = [(0, 0, 0, 0, 20, 0, 1, 1, 1), (0.2, -0.1, 0.1, 10, -25, 15, 1.2, 0.9, 1.0),
         (-0.3, 0.2, 0.0, 0, 0, 40, 0.7, 0.7, 0.7)]


def masks_agree(got, want, share=MASK_SHARE):
    differ = (np.asarray(got) > 0) != (np.asarray(want) > 0)
    assert differ.mean() <= share, f"{differ.sum()} mask pixels differ"
    return ~differ


def images_agree(got, want, where):
    diff = np.abs(np.asarray(got, int) - np.asarray(want, int))
    assert diff[where].max() <= 1


# -- geometry --------------------------------------------------------------------


@pytest.mark.parametrize("angles", [(0.3, -0.2, 1.1), (0.0, 0.349, 0.0)])
def test_euler_xyz_matrix(angles):
    want = np.asarray(JP.euler_xyz_matrix(*(jnp.float32(a) for a in angles)))
    assert_close(P.euler_xyz_matrix(*angles), want, GEOM_TOL)


@pytest.mark.parametrize("edit", EDITS)
def test_backproject_and_transform(edit):
    img, mask, depth = scene(1)
    want_pts = JP.backproject(jnp.asarray(depth), 470.4, 470.4)
    got_pts = P.backproject(torch.from_numpy(depth), 470.4, 470.4)
    assert_close(got_pts, want_pts, GEOM_TOL)
    wts = (mask > 0).reshape(-1).astype(np.float32)
    want = JP.transform_object_points(want_pts, jnp.asarray(wts), edit)
    got = P.transform_object_points(got_pts, torch.from_numpy(wts), edit)
    assert_close(got, want, GEOM_TOL)


@pytest.mark.parametrize("edit", EDITS)
def test_compute_correspondence(edit):
    _, mask, depth = scene(2)
    want = JP.compute_correspondence(depth, mask, edit, 0.92 * W, 0.92 * W)
    got = P.compute_correspondence(depth, mask, edit, 0.92 * W, 0.92 * W, device="cpu")
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert_close(got[ok], want[ok], GEOM_TOL)


@pytest.mark.parametrize("kind", ["depth", "constant"])
def test_normalize_depth_and_matrix(kind):
    _, _, depth = scene(3)
    if kind == "constant":
        depth = np.full_like(depth, 0.5)
    for got, want in zip(G.normalize_depth(depth), JG.normalize_depth(depth)):
        assert_close(got, want, GEOM_TOL)
    for edit in EDITS:
        assert_close(G.geodiff_transform_matrix(edit, 512), JG.geodiff_transform_matrix(edit, 512),
                     GEOM_TOL)


# -- splats and fills ------------------------------------------------------------


@pytest.mark.parametrize("edit", EDITS[:2])
def test_splat_points(edit):
    img, mask, depth = scene(4)
    wts = (mask > 0).reshape(-1).astype(np.float32)
    jp = JP.transform_object_points(JP.backproject(jnp.asarray(depth), 120.0, 120.0),
                                    jnp.asarray(wts), edit)
    want_img, want_mask = JP.splat_points(jp, jnp.asarray(img.reshape(-1, 3), jnp.float32),
                                          jnp.asarray(wts), h=H, w=W, fx=120.0, fy=120.0)
    got_img, got_mask = P.splat_points(torch.from_numpy(np.array(jp)),
                                       torch.from_numpy(img.reshape(-1, 3).astype(np.float32)),
                                       torch.from_numpy(wts), h=H, w=W, fx=120.0, fy=120.0)
    agree = masks_agree(got_mask, want_mask)
    assert np.asarray(want_mask).sum() > 500
    assert_close(got_img.numpy()[agree], np.asarray(want_img)[agree], 1e-5)


def test_fill_holes_partial_conv():
    img, mask, _ = scene(5)
    known = (np.random.default_rng(6).random((H, W)) > 0.7).astype(np.float32)
    x = (img * known[..., None]).astype(np.float32)
    want = JP.fill_holes_partial_conv(jnp.asarray(x), jnp.asarray(known), iterations=8)
    got = P.fill_holes_partial_conv(torch.from_numpy(x), torch.from_numpy(known), iterations=8)
    assert_close(got[0], want[0], 1e-5)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("check_every", [1, 7, 16])
@pytest.mark.parametrize("hole", ["object", "all"])
def test_inpaint_fmm(monkeypatch, check_every, hole):
    """"all": no known pixel, so JAX's loop runs to its h + w cap."""
    monkeypatch.setattr(P, "FMM_CHECK_EVERY", check_every)
    img, mask, _ = scene(7, 40, 56)
    m = (mask > 0).astype(np.float32) if hole == "object" else np.ones(mask.shape, np.float32)
    x = img.astype(np.float32)
    want = np.asarray(JP.inpaint_fmm(jnp.asarray(x), jnp.asarray(m)))
    got = P.inpaint_fmm(torch.from_numpy(x), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)


# -- the entry points -------------------------------------------------------------


@pytest.mark.parametrize("edit", EDITS)
def test_re_edit_3d_depth(edit):
    img, mask, depth = scene(8)
    bg = np.full_like(img, 30)
    want = JP.re_edit_3d_depth(img, mask, depth, edit, inp_cur=bg, focal_length_x=0.92 * W,
                               focal_length_y=0.92 * W)
    got = P.re_edit_3d_depth(img, mask, depth, edit, inp_cur=bg, focal_length_x=0.92 * W,
                             focal_length_y=0.92 * W, device="cpu")
    assert all(g.shape == np.asarray(w).shape and g.dtype == np.uint8
               for g, w in zip(got, want))
    agree = masks_agree(got[1], want[1])
    assert (want[1] > 0).sum() > 500
    images_agree(got[0], want[0], agree)
    images_agree(got[2], want[2], agree & (want[1] > 0))


@pytest.mark.parametrize("edit", [(0, 0, 0, 0, 20, 0, 1, 1, 1),
                                  (20, -10, 5, 10, -30, 5, 1.1, 0.9, 1.0)])
@pytest.mark.parametrize("depth_kind", ["depth", "constant"])
def test_author_case(edit, depth_kind):
    img, mask, depth = scene(9)
    if depth_kind == "constant":
        depth = np.full_like(depth, 0.5)
    bg = np.random.default_rng(10).integers(0, 255, img.shape, dtype=np.uint8)
    want = JG.author_case(img, mask, depth, bg, edit, focal_length=0.9 * W)
    got = G.author_case(img, mask, depth, bg, edit, focal_length=0.9 * W, device="cpu")
    coarse, full, mesh, md, coords = got
    agree_full = masks_agree(full, want[1])
    masks_agree(mesh, want[2])
    masks_agree(md, want[3])
    assert (want[1] > 0).sum() > 500 and (want[2] > 0).sum() > 500
    images_agree(coarse, want[0], agree_full)
    assert coords.dtype == np.float32
    assert_close(coords, want[4], GEOM_TOL)
