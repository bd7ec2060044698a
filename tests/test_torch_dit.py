"""The DiT backbone of the port (`models/dit.py`, the DiT branches of
`FreeFine` and `BatchedFreeFine`) against the JAX package's, on the CPU.

Weights: the port's random modules carried into JAX through the JAX
package's own converters (`convert_pixart_transformer`, `convert_vae`,
`convert_text_encoder`, `convert_t5_encoder`), and a JAX tree carried into
the port by `state_dict_from_flax`.  Inputs from numpy seeds; JAX's own
noise draws replayed into the port's loops.

  * `_sincos_2d` equals JAX's bit for bit;
  * `DiT2DCondition` (tiny, with and without learned sigma, with and
    without a mode-"edit" TCA mask pyramid) within 2e-4 (float32 on both
    sides, summation order only);
  * `generation`, `background_generation` and `cross_image_composition` on
    `tiny_dit_pipeline_config`, `generation` on
    `tiny_pixart_pipeline_config`, and the batched `generation` and
    `generation_shared_source` on the tiny DiT at two cases: final latents
    within 2e-3, images within 1 level (the lanes: JAX's own image bound
    for its batched lanes);
  * the layer range (PixArt's (18, 28) at depth 28), the square-only
    configs, `guided_generation`'s refusal, and the PixArt-XL-2 key
    manifest (modules built on the meta device).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import pipeline as JP
from freefine_tpu import weights as W
from freefine_tpu.config import tiny_dit_pipeline_config as jax_tiny_dit_config
from freefine_tpu.config import tiny_pixart_pipeline_config as jax_tiny_pixart_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.edit import build_mask_pyramid as j_build_mask_pyramid
from freefine_tpu.ops.geometry import re_edit_2d as j_re_edit_2d
from freefine_tpu_torch import pipeline as P
from freefine_tpu_torch.config import (
    dit_pipeline_config,
    pixart_pipeline_config,
    pixart_xl2_dit_config,
    tiny_dit_pipeline_config,
    tiny_pixart_pipeline_config,
)
from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_pyramid
from freefine_tpu_torch.models.dit import DiT2DCondition, _sincos_2d
from freefine_tpu_torch.models.t5 import T5Config
from freefine_tpu_torch.weights import random_weights, state_dict_from_flax
from test_torch_bggen import _capture, jax_noise
from test_torch_weights import FIXTURES, cached_shapes, torch_tensors

torch.set_num_threads(2)

ATOL = 2e-4
TOL = 2e-3
KEY = jax.random.key(0)
NUM_STEP, START = 6, 3
K = NUM_STEP - START


# -- carry-across helpers (the T5 and IP-Adapter tests import them) ------------


def dit_modules(cfg, seed: int = 0, spread: float = 1.0):
    """The port's modules of `cfg` on the CPU (`build_modules`), random:
    matrices N(0, 0.02 * spread), every 1-D leaf perturbed, so the
    carry-across covers each leaf."""
    mods = P.build_modules(cfg)
    g = torch.Generator().manual_seed(seed + 100)
    for i, m in enumerate(mods.values()):
        random_weights(m, seed + i)
        with torch.no_grad():
            for p in m.parameters():
                if p.ndim == 1:
                    p.add_(0.02 * torch.randn(p.shape, generator=g))
                else:
                    p.mul_(spread)
    return mods


def jax_template(kind: str, jcfg):
    """Shape tree of the JAX module's params (no weight allocation), traced
    once per kind and config (`cached_shapes`)."""
    return cached_shapes(f"dit-{kind}", (kind, jcfg), lambda: _trace_template(kind, jcfg))


def _trace_template(kind: str, jcfg):
    from freefine_tpu.models.dit import DiT2DCondition as JDiT
    from freefine_tpu.models.t5 import T5Encoder as JT5
    from freefine_tpu.models.text_encoder import CLIPTextEncoder as JText
    from freefine_tpu.models.vae import AutoencoderKL as JVAE

    if kind == "unet":
        c = jcfg.unet
        return jax.eval_shape(lambda k: JDiT(config=c).init(
            k, jnp.zeros((1, c.sample_size, c.sample_size, c.in_channels), c.dtype),
            jnp.int32(1), jnp.zeros((1, 77, c.cross_attention_dim), c.dtype)), KEY)
    if kind == "vae":
        return jax.eval_shape(JVAE(config=jcfg.vae).init, KEY,
                              jax.ShapeDtypeStruct((1, jcfg.height, jcfg.width, 3), jnp.float32))
    ids = jax.ShapeDtypeStruct((1, jcfg.text.max_length), jnp.int32)
    text = JT5 if kind == "t5" else JText
    return jax.eval_shape(text(config=jcfg.text).init, KEY, ids)


def jax_dit_params(module: torch.nn.Module, kind: str, jcfg):
    """The JAX package's params holding `module`'s weights (float32),
    through the JAX package's converters; kind "unet" (the DiT), "vae",
    "text" (CLIP) or "t5"."""
    tensors = torch_tensors(module)
    conv = {"unet": W.convert_pixart_transformer, "vae": W.convert_vae,
            "text": W.convert_text_encoder, "t5": W.convert_t5_encoder}[kind]
    return conv(jax_template(kind, jcfg), tensors)


def jax_pipe(cfg, jcfg, mods):
    """The JAX `FreeFine` holding the port modules' weights."""
    t5 = isinstance(cfg.text, T5Config)
    return JP.FreeFine(config=jcfg, params={
        k: jax_dit_params(m, "t5" if k == "text" and t5 else k, jcfg) for k, m in mods.items()})


# -- the module ------------------------------------------------------------------


@pytest.mark.parametrize("dim,grid", [(32, 8), (1152, 32), (64, 5)])
def test_sincos_table_equals_jax(dim, grid):
    from freefine_tpu.models.dit import _sincos_2d as j_sincos

    got = _sincos_2d(dim, grid)
    assert got.dtype == np.float64 and got.shape == (grid * grid, dim)
    np.testing.assert_array_equal(got, j_sincos(dim, grid))


def _sigma(cfg, learn_sigma):
    return dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, learn_sigma=learn_sigma))


@pytest.fixture(scope="module")
def dits():
    out = {}
    for sigma in (False, True):
        cfg = _sigma(tiny_dit_pipeline_config(), sigma)
        jcfg = _sigma(jax_tiny_dit_config(), sigma)
        mod = DiT2DCondition(cfg.unet)
        random_weights(mod, 3)
        g = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for p in mod.parameters():  # weights of order one: a live comparison
                p.copy_(torch.randn(p.shape, generator=g) * (0.15 if p.ndim > 1 else 0.1))
        out[sigma] = cfg, jcfg, mod, jax_dit_params(mod, "unet", jcfg)
    return out


def _dit_inputs(cfg):
    rng = np.random.default_rng(5)
    n = cfg.unet.sample_size
    sample = rng.normal(size=(3, n, n, 4)).astype(np.float32)
    ctx = rng.normal(size=(3, 77, cfg.unet.cross_attention_dim)).astype(np.float32)
    fg_retain = np.zeros((cfg.height, cfg.width), np.float32)
    fg_retain[20:44, 16:40] = 1
    fg_ref = np.zeros((cfg.height, cfg.width), np.float32)
    fg_ref[8:30, 24:52] = 1
    return sample, ctx, fg_retain, fg_ref


@pytest.mark.parametrize("mode", ["none", "edit"])
@pytest.mark.parametrize("learn_sigma", [False, True])
def test_dit_forward_matches_jax(dits, mode, learn_sigma):
    from freefine_tpu.models.dit import DiT2DCondition as JDiT

    cfg, jcfg, mod, jparams = dits[learn_sigma]
    sample, ctx, fg_retain, fg_ref = _dit_inputs(cfg)
    lh, lw = cfg.latent_height, cfg.latent_width
    jkw, tkw = {}, {}
    if mode == "edit":
        cg, lr = 0.625, (2, 4)
        jkw = dict(edit_cfg=JEditConfig(mode="edit", method="tca", layer_range=lr),
                   edit_state=JEditState(
                       fg_retain=j_build_mask_pyramid(jnp.asarray(fg_retain), lh, lw),
                       fg_ref=j_build_mask_pyramid(jnp.asarray(fg_ref), lh, lw),
                       local_region=j_build_mask_pyramid(jnp.asarray(fg_retain), lh, lw),
                       context_guidance=jnp.float32(cg)))
        tkw = dict(edit_cfg=EditConfig(mode="edit", method="tca", layer_range=lr),
                   edit_state=EditState(
                       fg_retain=build_mask_pyramid(torch.from_numpy(fg_retain), lh, lw),
                       fg_ref=build_mask_pyramid(torch.from_numpy(fg_ref), lh, lw),
                       local_region=build_mask_pyramid(torch.from_numpy(fg_retain), lh, lw),
                       context_guidance=cg))
    # JAX's apply jitted whole (eagerly, flax compiles op by op)
    apply = JDiT(config=jcfg.unet).apply
    if "edit_cfg" in jkw:
        apply = functools.partial(apply, edit_cfg=jkw.pop("edit_cfg"))
    want = np.asarray(jax.jit(apply)(jparams, jnp.asarray(sample), jnp.int32(501),
                                     jnp.asarray(ctx), **jkw))
    with torch.no_grad():
        got = mod(torch.from_numpy(sample).permute(0, 3, 1, 2), 501, torch.from_numpy(ctx),
                  **tkw)
    assert got.dtype == torch.float32 and got.shape == (3, 4, lh, lw)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)
    if mode == "edit":  # the TCA window is live on the DiT
        with torch.no_grad():
            plain = mod(torch.from_numpy(sample).permute(0, 3, 1, 2), 501, torch.from_numpy(ctx))
        assert float((plain - got).abs().max()) > 100 * ATOL


def test_dit_tree_round_trip_bit_for_bit(dits):
    """JAX's converter output carried back by `state_dict_from_flax`
    equals the port's state dict bit for bit (every key, both ways)."""
    _, _, mod, jparams = dits[True]
    back = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams), mod)
    want = mod.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_dit_refuses_added_cond_and_features(dits):
    cfg, _, mod, _ = dits[False]
    x = torch.zeros(1, 4, 8, 8)
    ctx = torch.zeros(1, 77, cfg.unet.cross_attention_dim)
    with pytest.raises(ValueError):
        mod(x, 1, ctx, added_cond=torch.zeros(1, 8))
    with pytest.raises(NotImplementedError):
        mod(x, 1, ctx, return_features=True)
    with pytest.raises(ValueError):
        mod(torch.zeros(1, 4, 16, 16), 1, ctx)


def _manifest(name):
    out = {}
    with open(os.path.join(FIXTURES, name)) as f:
        for line in f:
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


def test_pixart_key_manifest():
    """The PixArt-XL-2 DiT's state dict (built on the meta device) is
    diffusers' `PixArtTransformer2DModel` key set, shape for shape; the
    sincos table is no state-dict entry."""
    with torch.device("meta"):
        mod = DiT2DCondition(pixart_xl2_dit_config())
    got = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
    want = _manifest("pixart_xl2_keys.txt")
    assert len(want) == 603
    assert got == want


def test_layer_range_and_square_only():
    pipe = P.FreeFine(tiny_dit_pipeline_config(), init_random=True, device="cpu")
    assert pipe._layer_range == (2, 4)
    deep = dataclasses.replace(tiny_dit_pipeline_config(),
                               unet=dataclasses.replace(tiny_dit_pipeline_config().unet,
                                                        depth=28))
    assert P.FreeFine(deep, init_random=True, device="cpu")._layer_range == (18, 28)
    assert pixart_pipeline_config().unet.attn_layer_layout == (28, 0)
    for make in (dit_pipeline_config, pixart_pipeline_config):
        with pytest.raises(ValueError, match="square-only"):
            make(512, 768)
    px = pixart_pipeline_config()
    assert (px.unet.hidden_size, px.unet.depth, px.unet.num_heads, px.unet.patch_size) == (
        1152, 28, 16, 2)
    assert px.unet.hidden_size // px.unet.num_heads == 72 and px.unet.learn_sigma
    assert (px.text.d_model, px.text.num_layers, px.text.max_length) == (4096, 24, 120)


# -- the pipeline ------------------------------------------------------------------


@pytest.fixture(scope="module")
def dit_pipes():
    cfg, jcfg = tiny_dit_pipeline_config(), jax_tiny_dit_config()
    mods = dit_modules(cfg, 21)
    tpipe = P.FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jax_pipe(cfg, jcfg, mods), tpipe


@pytest.fixture(scope="module")
def pixart_pipes():
    cfg, jcfg = tiny_pixart_pipeline_config(), jax_tiny_pixart_config()
    mods = dit_modules(cfg, 31)
    tpipe = P.FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jax_pipe(cfg, jcfg, mods), tpipe


def _box(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 255
    return m


def _edit(cfg, c=0):
    h, w = cfg.height, cfg.width
    img = np.random.default_rng(6).integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = _box(h, w, 12, 36, 16, 40)
    coarse, tm, _ = j_re_edit_2d(img, mask, dx=10 - 6 * c, dy=4 + 2 * c, rotation=20 - 8 * c)
    return img, mask, np.asarray(coarse), np.asarray(tm)


def _run(pipe, entry, cfg, **kw):
    h, w = cfg.height, cfg.width
    img, mask, coarse, tm = _edit(cfg)
    if entry == "generation":
        return pipe.generation(img, mask, coarse, tm, "a cat", use_auto_draw=True,
                               cons_area=np.zeros((h, w), np.uint8), reduce_inp_artifacts=True,
                               **kw)
    if entry == "background_generation":
        return pipe.background_generation(img, mask, "a wall", **kw)
    src2 = np.random.default_rng(8).integers(0, 255, (h, w, 3), dtype=np.uint8)
    return pipe.cross_image_composition([img, src2], [mask, _box(h, w, 34, 60, 34, 60)],
                                        [tm, _box(h, w, 36, 58, 4, 28)], coarse,
                                        ["a cat", "a dog"], dil_factor=5, **kw)


def _noise(cfg, seed, rows):
    return jax_noise(seed, K, (rows, cfg.latent_height, cfg.latent_width, 4))


def _match(pipes, entry):
    cfg, jpipe, tpipe = pipes
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=5)
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = _run(jpipe, entry, cfg, **kw)
    rows = 1 if entry == "cross_image_composition" else 2
    got = _run(tpipe, entry, cfg, noise=_noise(cfg, 5, rows), **kw)
    assert got.shape == (cfg.height, cfg.width, 3) and got.dtype == np.uint8
    assert np.isfinite(tstore["lat"]).all()
    n = tstore["lat"].shape[0]  # the port decodes the edit stream alone
    np.testing.assert_allclose(tstore["lat"], jstore["lat"][:n], atol=TOL, rtol=0)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("entry", ["generation", "background_generation",
                                   "cross_image_composition"])
def test_dit_entry_points_match_jax(dit_pipes, entry):
    _match(dit_pipes, entry)


def test_pixart_generation_matches_jax(pixart_pipes):
    _match(pixart_pipes, "generation")


def test_guided_generation_refuses_the_dit(dit_pipes):
    cfg, _, tpipe = dit_pipes
    img, mask, coarse, tm = _edit(cfg)
    with pytest.raises(NotImplementedError, match="UNet backbone"):
        tpipe.guided_generation(img, mask, coarse, tm, "a cat", num_step=4, start_step=2)


@pytest.mark.parametrize("entry", ["generation", "generation_shared_source"])
def test_dit_batched_lanes_match_jax(dit_pipes, entry):
    cfg, jpipe, tpipe = dit_pipes
    h, w = cfg.height, cfg.width
    shared = entry == "generation_shared_source"
    cases = []
    for c in range(2):
        img, mask, coarse, tm = _edit(cfg, c)
        if not shared:
            img = np.random.default_rng(30 + c).integers(0, 255, (h, w, 3), dtype=np.uint8)
        cases.append(dict(ori_img=img, ori_mask=mask, coarse_input=coarse, target_mask=tm,
                          guidance_text=f"a cat {c}"))
    seeds = [4, 9]
    kw = dict(num_step=NUM_STEP, start_step=START, end_step=1, seed=seeds)
    jstore, tstore = {}, {}
    _capture(jpipe, jstore, np.asarray)
    _capture(tpipe, tstore, lambda a: a.numpy())
    want = getattr(JP.BatchedFreeFine(jpipe), entry)(cases, **kw)
    got = getattr(P.BatchedFreeFine(tpipe), entry)(
        cases, noise=[_noise(cfg, s, 2) for s in seeds], **kw)
    assert len(got) == 2 and tstore["lat"].shape == (2, cfg.latent_height, cfg.latent_width, 4)
    np.testing.assert_allclose(tstore["lat"], jstore["lat"], atol=TOL, rtol=0)
    for g, w_ in zip(got, want):
        diff = np.abs(g.astype(np.int32) - w_.astype(np.int32))
        assert diff.mean() < 1.0 and diff.max() <= 12, (diff.mean(), diff.max())


# -- what the card's checks count on ---------------------------------------------


def test_chip_smoke_px_launches_and_shapes():
    """Phase PX's expected launches, worked out from the config (`_expected`:
    692 = 15·28 + 15·18 + 2 `flash_sdpa`, 150 = 15·10 `tca_flash`, 52 =
    22 + 30 VAE GroupNorms, the DiT having none), and phase 2's PX shapes
    are the PixArt DiT's attention layout (16 heads of 72 at S 1024; 8 per
    parity block), on the wgmma routes of rows 1 and 2."""
    import types

    import chip_smoke
    from freefine_tpu_torch.ops import flash_attention as FA

    cfg = pixart_pipeline_config()
    pipe = types.SimpleNamespace(_layer_range=(18, 28))
    expect = chip_smoke._expected(cfg, pipe, 15, 15, fused=True)
    assert (expect["flash_sdpa"], expect["tca_flash"], expect["group_norm_silu"]) == (692, 150, 52)
    assert sum(expect.values()) == 692 + 150 + 52
    assert chip_smoke.norm_calls(cfg, "unet") == []
    u = cfg.unet
    tokens, heads = (u.sample_size // u.patch_size) ** 2, u.num_heads
    d = u.hidden_size // heads
    assert {(h, s, hd) for _, h, s, hd, *_ in chip_smoke.PX_FLASH_SHAPES} == {(heads, tokens, d)}
    assert {(h, s, hd) for _, h, s, hd, *_ in chip_smoke.PX_TCA_SHAPES} == {(heads // 2, tokens, d)}
    assert FA.FLASH_ROUTES[FA.flash_route(torch.bfloat16, d)] == "bf16_wgmma"
    assert d <= FA._MAX_HEAD_DIM["tca_flash"][torch.bfloat16]
    assert set(chip_smoke.gn_shapes(cfg, chip_smoke.GN_PX_PATH_BATCHES)) <= set(
        chip_smoke.gn_shapes(cfg))
