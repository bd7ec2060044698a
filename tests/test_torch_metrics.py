"""GeoBench's metrics in the port (`freefine_tpu_torch.metrics`) against the
JAX package's.

  * `common`: Gaussian statistics, the Fréchet distance (a full-rank case
    and a singular one, fewer samples than dimensions), the polynomial
    kernel and MMD, the subset MMD and `fid_from_features`, float64 on both
    sides: within 1e-10 relative;
  * BGC, SUBC, HPS, IRS and WRAP_E over a results set written in
    `tmp_path` (two images, two cases each, PNGs written by PIL), on tiny
    encoders with the port's random weights carried to JAX by its
    converters; the JAX side built as its `make_*` functions build theirs,
    at the tiny configurations: within 1e-5 absolute (cosines and scores of
    order 1; WRAP_E is the same float64 math, 1e-12);
  * `batched_features` with a tail batch (10 images, batches of 4) through
    the FID family's DINO batch encoder on a tiny DINOv2: the port's
    unpadded tail rows within 1e-5 of max |ref| of JAX's padded run and of
    the port's own rows inside a full batch; FID_DINO and FID_KD from them
    within 1e-4 relative;
  * `difficulty_level` and `filter_by_level` as JAX's; MD's pure-numpy
    rest (`default_corr_path`, `_is_2d_param`, `mean_distance_single`)
    equal to JAX's;
  * `metrics.main` end to end: `tests/test_torch_metrics_main.py`.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from freefine_tpu import weights as JW
from freefine_tpu.data import geobench as JG
from freefine_tpu.metrics import common as JCM
from freefine_tpu.metrics import consistency as JC
from freefine_tpu.metrics import fid as JF
from freefine_tpu.metrics import md as JMD
from freefine_tpu.metrics import preprocess as JP
from freefine_tpu.metrics import scoring as JS
from freefine_tpu.metrics.wrap_error import wrap_error as j_wrap_error
from freefine_tpu.models import blip as JB
from freefine_tpu.models.clip_image import CLIPImageEncoder as JCLIPImage
from freefine_tpu.models.clip_image import CLIPVisionConfig as JCLIPVisionConfig
from freefine_tpu.models.dinov2 import DINOv2 as JDINOv2
from freefine_tpu.models.dinov2 import DINOv2Config as JDINOv2Config
from freefine_tpu.models.open_clip_text import OpenCLIPText as JOpenCLIPText
from freefine_tpu.models.open_clip_text import OpenCLIPTextConfig as JOpenCLIPTextConfig
from freefine_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from freefine_tpu_torch import metrics as M
from freefine_tpu_torch.config import OpenCLIPTextConfig
from freefine_tpu_torch.data import geobench as G
from freefine_tpu_torch.metrics import common as CM
from freefine_tpu_torch.metrics import consistency as C
from freefine_tpu_torch.metrics import fid as F
from freefine_tpu_torch.metrics import main as MAIN
from freefine_tpu_torch.metrics import md as MD
from freefine_tpu_torch.metrics import scoring as S
from freefine_tpu_torch.metrics.wrap_error import wrap_error
from freefine_tpu_torch.models import blip as B
from freefine_tpu_torch.models.clip_image import CLIPImageEncoder, CLIPVisionConfig
from freefine_tpu_torch.models.dinov2 import DINOv2, DINOv2Config
from freefine_tpu_torch.models.open_clip_text import OpenCLIPText
from freefine_tpu_torch.models.tokenizer import HashTokenizer
from test_torch_blip_openclip import (
    BLIP,
    TEXT,
    cached_blip_template,
    int_template,
    open_clip_layout,
)
from test_torch_depth import jax_template, np_state, randomize

torch.set_num_threads(2)

VISION = dict(image_size=224, patch_size=32, hidden_size=32, intermediate_size=64, num_layers=2,
              num_heads=2, projection_dim=16)
DINO = dict(dim=32, depth=2, heads=2, patch_size=16, pos_embed_size=14)
PROMPTS = ("a mug on a wooden table", "a small red car parked by the road")


def _rel(got, want, tol):
    assert got is not None and want is not None
    assert abs(got - want) <= tol * max(abs(want), 1e-30), (got, want)


# -- the results set ---------------------------------------------------------------


def write_results(root, n_images=2, cases=2, side=96, seed=0):
    """A GeoBench results JSON (image -> instances -> cases) in `root`,
    every image a PNG written by PIL: source, source mask, generated,
    coarse and target mask per case; -> (json path, data)."""
    rng = np.random.default_rng(seed)
    data = {}
    yy, xx = np.mgrid[:side, :side]
    for i in range(n_images):
        src = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
        src = np.cumsum(src // 8, axis=1).astype(np.uint8)
        mask = (((yy - side // 2) ** 2 + (xx - side // 3) ** 2) < (side // 5) ** 2)
        paths = {"ori_img_path": f"{root}/src_{i}.png", "ori_mask_path": f"{root}/mask_{i}.png"}
        Image.fromarray(src).save(paths["ori_img_path"])
        Image.fromarray((mask * 255).astype(np.uint8)).save(paths["ori_mask_path"])
        inst = {}
        for c in range(cases):
            shift = 6 * (c + 1)
            tgt = np.roll(mask, shift, axis=1)
            gen = np.roll(src, shift, axis=1) // 2 + rng.integers(0, 128, src.shape).astype(
                np.uint8)
            coarse = np.where(tgt[..., None], np.roll(src, shift, axis=1), src)
            case = dict(paths, edit_param=[shift, 0, 0, 0, 0, 10 * c, 1],
                        edit_prompt=["slightly move it", "heavily move it"][c],
                        gen_img_path=f"{root}/gen_{i}_{c}.png",
                        coarse_input_path=f"{root}/coarse_{i}_{c}.png",
                        tgt_mask_path=f"{root}/tgt_{i}_{c}.png")
            Image.fromarray(gen.astype(np.uint8)).save(case["gen_img_path"])
            Image.fromarray(coarse.astype(np.uint8)).save(case["coarse_input_path"])
            Image.fromarray((tgt * 255).astype(np.uint8)).save(case["tgt_mask_path"])
            inst[str(c)] = case
        data[str(i)] = {"4v_caption": PROMPTS[i % 2], "instances": {"0": inst}}
    path = os.path.join(root, "results.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path, data


def write_real(root, n=5, side=80, seed=1):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        a = np.cumsum(rng.integers(0, 32, (side, side + 8, 3)), axis=0) % 256
        Image.fromarray(a.astype(np.uint8)).save(f"{root}/real_{i}.png")
    return root


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("geobench"))
    path, data = write_results(root)
    return path, data, write_real(os.path.join(root, "real"))


# -- common --------------------------------------------------------------------------


def test_common_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(40, 8)), rng.normal(0.3, 1.2, size=(50, 8))
    for name in ("gaussian_stats",):
        for got, want in zip(getattr(CM, name)(a), getattr(JCM, name)(a)):
            np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    m1, s1 = CM.gaussian_stats(a)
    m2, s2 = CM.gaussian_stats(b)
    _rel(CM.frechet_distance(m1, s1, m2, s2), JCM.frechet_distance(m1, s1, m2, s2), 1e-10)
    _rel(CM.fid_from_features(a, b), JCM.fid_from_features(a, b), 1e-10)
    # fewer samples than dimensions: singular covariances
    few, few2 = rng.normal(size=(5, 16)), rng.normal(size=(6, 16))
    _rel(CM.fid_from_features(few, few2), JCM.fid_from_features(few, few2), 1e-10)
    np.testing.assert_allclose(CM.polynomial_kernel(a, b), JCM.polynomial_kernel(a, b),
                               rtol=1e-10, atol=0)
    _rel(CM.polynomial_mmd(a, b), JCM.polynomial_mmd(a, b), 1e-10)
    _rel(CM.compute_mmd_subsets(a, b, n_subsets=7, subset_size=20, seed=3),
         JCM.compute_mmd_subsets(a, b, n_subsets=7, subset_size=20, seed=3), 1e-10)
    _rel(F.fid_kd_from_features(a, b), JF.fid_kd_from_features(a, b), 1e-10)
    assert M.frechet_distance is CM.frechet_distance and M.wrap_error is wrap_error


# -- the metrics on tiny encoders ------------------------------------------------------


@pytest.fixture(scope="module")
def clip_tiny():
    model = randomize(CLIPImageEncoder(CLIPVisionConfig(**VISION)), 11).eval()
    jmodel = JCLIPImage(JCLIPVisionConfig(**VISION))
    params = JW.convert_open_clip_vision(
        jax_template(jmodel, np.zeros((1, 224, 224, 3))),
        np_state({f"visual.{k}": v for k, v in model.state_dict().items()}))
    apply = jax.jit(jmodel.apply)

    def jencode(img):  # JAX's make_clip_encoder at the tiny configuration
        return np.asarray(apply(params, jnp.asarray(JP.clip_image_transform(img))))[0]

    return model, jencode


@pytest.fixture(scope="module")
def dino_tiny():
    model = randomize(DINOv2(DINOv2Config(**DINO)), 12).eval()
    jcfg = JDINOv2Config(**DINO)
    params = JW.convert_dino_v1(jax_template(JDINOv2(jcfg), np.zeros((1, 224, 224, 3))),
                                np_state(model.state_dict()))
    return model, params, jcfg


def test_bgc_matches_jax(results, clip_tiny):
    _, data, _ = results
    model, jencode = clip_tiny
    got = C.background_consistency(data, "gen_img_path", C.make_clip_encoder(model))
    want = JC.background_consistency(data, "gen_img_path", jencode)
    assert 0 < want < 1
    assert abs(got - want) <= 1e-5, (got, want)


def test_subc_matches_jax(results, dino_tiny):
    _, data, _ = results
    model, params, jcfg = dino_tiny
    got = C.subject_consistency(data, "gen_img_path", C.make_dino_encoder(model))
    want = JC.subject_consistency(data, "gen_img_path", JC.make_dino_encoder(params, jcfg))
    assert 0 < want < 1
    assert abs(got - want) <= 1e-5, (got, want)


def test_hps_matches_jax(results):
    _, data, _ = results
    vision = dict(VISION, activation="gelu")
    image = randomize(CLIPImageEncoder(CLIPVisionConfig(**vision)), 13).eval()
    text = randomize(OpenCLIPText(OpenCLIPTextConfig(**TEXT)), 14).eval()
    jimage = JCLIPImage(JCLIPVisionConfig(**vision))
    jtext = JOpenCLIPText(JOpenCLIPTextConfig(**TEXT))
    layout = np_state(open_clip_layout(text, image))
    pi = JW.convert_open_clip_vision(jax_template(jimage, np.zeros((1, 224, 224, 3))), layout)
    pt = JW.convert_open_clip_text(int_template(jtext, ((1, 77), jnp.int32)), layout, prefix="")
    ai, at = jax.jit(jimage.apply), jax.jit(jtext.apply)
    jtok = JHashTokenizer(TEXT["vocab_size"])

    def jenc_i(img):  # JAX's make_hps_encoders at the tiny configurations
        return np.asarray(ai(pi, jnp.asarray(JP.clip_image_transform(img))))[0]

    def jenc_t(prompt):
        return np.asarray(at(pt, jnp.asarray(jtok.encode(prompt))[None]))[0]

    enc_i, enc_t = S.make_hps_encoders(image, text, HashTokenizer(TEXT["vocab_size"]))
    got = S.hps(data, "gen_img_path", enc_i, enc_t)
    want = JS.hps(data, "gen_img_path", jenc_i, jenc_t)
    assert want != 0
    assert abs(got - want) <= 1e-5, (got, want)


def test_irs_matches_jax(results):
    _, data, _ = results
    cfg = dict(BLIP, image_size=224)
    model = randomize(B.ImageReward(B.BlipConfig(**cfg)), 15).eval()
    jmodel = JB.ImageReward(JB.BlipConfig(**cfg))
    params = JW.convert_blip_image_reward(cached_blip_template(jmodel),
                                          np_state(model.state_dict()))
    apply = jax.jit(jmodel.apply)
    jtok = JB.HashWordTokenizer(cfg["vocab_size"])

    def jscore(img, prompt):  # JAX's make_irs_scorer at the tiny configuration
        ids, mask = jtok.encode(prompt)
        return float(apply(params, jnp.asarray(JP.clip_image_transform(img)),
                           jnp.asarray(ids)[None], jnp.asarray(mask)[None])[0])

    got = S.irs(data, "gen_img_path",
                S.make_irs_scorer(model, B.HashWordTokenizer(cfg["vocab_size"])))
    want = JS.irs(data, "gen_img_path", jscore)
    assert want != 0
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (got, want)


def test_wrap_error_matches_jax(results):
    _, data, _ = results
    want = j_wrap_error(data)
    assert want > 0
    assert abs(wrap_error(data) - want) <= 1e-12


def test_batched_features_tail_and_fid_dino_match_jax(results, dino_tiny):
    _, data, real = results
    model, params, jcfg = dino_tiny
    paths = MAIN._collect_paths(data, "gen_img_path") + [
        os.path.join(real, f) for f in sorted(os.listdir(real))]
    paths = paths + paths[:1]
    assert len(paths) == 10
    enc, prep = C.make_dino_batch_encoder(model)
    got = F.batched_features(paths, enc, prep, batch_size=4)
    jenc, jprep = JC.make_dino_batch_encoder(params, jcfg)
    want = np.asarray(JF.batched_features(paths, jenc, jprep, batch_size=4))
    assert got.shape == want.shape == (10, DINO["dim"])
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    # the tail's rows (8, 9) as the same images' rows inside a full batch
    full = F.batched_features(paths[6:], enc, prep, batch_size=4)
    assert np.abs(got[6:] - full).max() <= 1e-5 * scale
    gen, real_f = got[:4], got[4:9]
    _rel(CM.fid_from_features(gen, real_f), JCM.fid_from_features(want[:4], want[4:9]), 1e-4)
    _rel(CM.polynomial_mmd(gen, real_f), JCM.polynomial_mmd(want[:4], want[4:9]), 1e-4)


def test_levels_filter_as_jax(results):
    _, data, _ = results
    for prompt in ("slightly move it", "move it Moderately", "heavily move it"):
        assert G.difficulty_level(prompt) == JG.difficulty_level(prompt)
    for mod in (G, JG):
        with pytest.raises(ValueError):
            mod.difficulty_level("move it")
    for level in (1, 2, 3):
        got = G.filter_by_level(json.loads(json.dumps(data)), level)
        assert got == JG.filter_by_level(json.loads(json.dumps(data)), level)


def test_md_rest_matches_jax():
    for path in ("/data/out/freefine/0/1/gen_3.png", "gen.png", "a/b/c/d.jpeg"):
        assert MD.default_corr_path(path) == JMD.default_corr_path(path)
    for p in ([0, 0, 0, 0, 0, 0, 1], [3, 0, 0, 0, 0, 0, 1], [0, 0, 0, 0, 0, 15, 1],
              [0, 0, 0, 0, 0, 0, 1.2], [0, 0, 0, 0, 20, 0, 1]):
        assert MD._is_2d_param(p) == JMD._is_2d_param(p)
    rng = np.random.default_rng(5)
    gt = rng.normal(size=(20, 24, 2)) * 10
    kps = np.stack([rng.integers(0, 20, 9), rng.integers(0, 24, 9)], -1)
    matched = rng.integers(0, 20, (9, 2))
    np.testing.assert_array_equal(MD.mean_distance_single(matched, kps, gt),
                                  JMD.mean_distance_single(matched, kps, gt))
