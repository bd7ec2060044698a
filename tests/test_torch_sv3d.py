"""The SV3D coarse 3D edit's port against the JAX package: the EDM pieces,
the orbit's azimuths and frame pick, the tiny video UNet, the sampler, the
crop and paste-back, the sgm checkpoint loader and `make_sv3d_edit_fn`,
the full-size key manifest, and the launches `chip_smoke.py` works out
for the card.  (The tiny `re_edit_3d_sv3d` and the `generation` after it
are in tests/test_torch_edit3d.py, beside the depth edit's, whose
pipelines they share.)

The tiny video UNet is JAX's (tests/test_sv3d.py: 16 channels, mult
(1, 2), 3 frames, 8^2 latents); its random torch weights (mix factors
included, so the blend has teeth) go through
`freefine_tpu.weights_sv3d.convert_sv3d_unet` into flax.

Tolerances: the EDM pieces, the vector conditioning (adm 24 and 1280) 1e-6
relative; the azimuths and the frame pick equal; the video UNet forward
2e-4 of max |ref| (a version with per-frame temporal GroupNorm
statistics must fail it); `sample_latents` over 3 steps with JAX's draws
2e-3 of max |ref|; crop and paste-back images within 1 level, masks
equal.
"""

import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as JW
from freefine_tpu import weights_sv3d as JWS
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.data.datagen import generate_azimuth_angles as j_azimuths
from freefine_tpu.models import sv3d as JS
from freefine_tpu.models.clip_image import CLIPImageEncoder as JCLIPImage
from freefine_tpu.models.clip_image import CLIPVisionConfig as JCLIPVisionConfig
from freefine_tpu.models.clip_image import clip_vit_h14 as j_clip_vit_h14
from freefine_tpu.models.u2net import U2Net as JU2Net
from freefine_tpu.models.u2net import U2NetConfig as JU2NetConfig
from freefine_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from freefine_tpu.models.video_unet import VideoUNet as JVideoUNet
from freefine_tpu.models.video_unet import VideoUNetConfig as JVideoUNetConfig
from freefine_tpu.models.video_unet import sv3d_config as j_sv3d_config
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.data.datagen import generate_azimuth_angles
from freefine_tpu_torch.models import sv3d as S
from freefine_tpu_torch.models.clip_image import CLIPImageEncoder, CLIPVisionConfig, clip_vit_h14
from freefine_tpu_torch.models.layers import NORM_TYPES
from freefine_tpu_torch.models.u2net import U2Net, U2NetConfig
from freefine_tpu_torch.models.video_unet import (
    TemporalResBlock,
    VideoUNet,
    VideoUNetConfig,
    sv3d_config,
)
from test_torch_checkpoint import _conv1x1, _to_ldm
from test_torch_depth import ReadKeys, assert_close, manifest, np_state
from test_torch_weights import tiny_modules

torch.set_num_threads(2)

FIXTURES = osp.join(osp.dirname(__file__), "fixtures")
UNET_PREFIX = "model.diffusion_model."
CLIP_PREFIX = "conditioner.embedders.0.open_clip.model.visual."
TINY = dict(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
            attention_levels=(True, False), num_head_channels=8, context_dim=16,
            adm_in_channels=24, num_frames=3, norm_num_groups=4)
TINY_VIT = dict(image_size=224, patch_size=32, hidden_size=32, intermediate_size=64,
                num_layers=2, num_heads=2, projection_dim=16, activation="gelu")
# a small U^2-Net of the real architecture (six stages, five decoder stages)
TINY_U2NET = dict(stages=((4, 4, 8), (3, 4, 8), (3, 4, 8), (3, 4, 8), (0, 4, 8), (0, 4, 8)),
                  dstages=((0, 4, 8), (3, 4, 8), (3, 4, 8), (3, 4, 8), (4, 4, 8)))


def exact(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0)


@torch.no_grad()
def randomize_all(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter and BatchNorm statistic from a numpy seed: norm
    weights 1 + N(0, 0.1), mix factors N(0, 1.5), other 1-D leaves
    N(0, 0.1), running variances 0.5 + U(0, 1), matrices and kernels
    N(0, 1 / fan_in), tables (class token, positions, projection)
    N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    unit = {id(p) for m in model.modules() if isinstance(m, NORM_TYPES)
            for n, p in m.named_parameters(recurse=False) if n == "weight"}
    for name, p in model.named_parameters():
        if id(p) in unit:
            a = 1.0 + 0.1 * rng.standard_normal(p.shape)
        elif name.endswith("mix_factor"):
            a = 1.5 * rng.standard_normal(p.shape)
        elif p.ndim == 1:
            a = 0.1 * rng.standard_normal(p.shape)
        elif isinstance(model.get_submodule(name.rpartition(".")[0]),
                        (torch.nn.Linear, torch.nn.Conv2d, torch.nn.Conv3d)) \
                or name.endswith("in_proj_weight"):
            a = rng.standard_normal(p.shape) / np.sqrt(p[0].numel())
        else:
            a = 0.5 * rng.standard_normal(p.shape)
        p.copy_(torch.from_numpy(a.astype(np.float32)))
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.copy_(torch.from_numpy(0.1 * rng.standard_normal(b.shape)))
        elif name.endswith("running_var"):
            b.copy_(torch.from_numpy(0.5 + rng.random(b.shape)))
    return model


def shapes_template(init, *shapes):
    return jax.eval_shape(init, jax.random.key(0),
                          *(jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes))


def video_template(jcfg):
    t = jcfg.num_frames
    return shapes_template(JVideoUNet(jcfg).init, (t, 8, 8, jcfg.in_channels), (t,),
                           (t, 1, jcfg.context_dim), (t, jcfg.adm_in_channels))


def sgm_unet(model: torch.nn.Module) -> dict:
    return {UNET_PREFIX + k: v for k, v in np_state(model.state_dict()).items()}


def tiny_video(seed=0, **over):
    kw = {**TINY, **over}
    model = randomize_all(VideoUNet(VideoUNetConfig(**kw, dtype=torch.float32)), seed)
    jcfg = JVideoUNetConfig(**kw, dtype=jnp.float32)
    params = JWS.convert_sv3d_unet(video_template(jcfg), sgm_unet(model),
                                   channel_mult=jcfg.channel_mult, num_res=jcfg.num_res_blocks)
    return model.eval(), JVideoUNet(jcfg), params


def jitted(module, **attrs):
    """A flax module whose `apply` is jitted (`method` static), for the JAX
    functions that call `module.apply` eagerly."""
    return types.SimpleNamespace(apply=jax.jit(module.apply, static_argnames=("method",)),
                                 **attrs)


def tiny_vit(seed=1):
    model = randomize_all(CLIPImageEncoder(CLIPVisionConfig(**TINY_VIT)), seed)
    jmodel = JCLIPImage(JCLIPVisionConfig(**TINY_VIT))
    tmpl = shapes_template(jmodel.init, (1, 224, 224, 3))
    params = JW.convert_open_clip_vision(tmpl, np_state(model.state_dict()), prefix="")
    return model.eval(), jmodel, params


def tiny_u2net(seed=2):
    model = randomize_all(U2Net(U2NetConfig(**TINY_U2NET)), seed)
    jmodel = JU2Net(JU2NetConfig(**TINY_U2NET))
    tmpl = shapes_template(jmodel.init, (1, 64, 64, 3))
    return model.eval(), jmodel, JW.convert_u2net(tmpl, np_state(model.state_dict()))


def video_inputs(seed, t=3, hw=8, ctx=16, adm=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, hw, hw, 8)).astype(np.float32),
            rng.uniform(-1, 2, t).astype(np.float32),
            rng.standard_normal((t, 1, ctx)).astype(np.float32),
            rng.standard_normal((t, adm)).astype(np.float32))


@pytest.fixture(scope="module")
def video():
    return tiny_video()


@pytest.fixture(scope="module")
def japply(video):
    return jax.jit(video[1].apply)


# -- the EDM pieces, the orbit's angles ---------------------------------------------


@pytest.mark.parametrize("steps", [3, 50])
def test_edm_pieces_match_jax(steps):
    exact(S.edm_sigmas(steps), JS.edm_sigmas(steps))
    exact(S.edm_sigmas(steps, sigma_max=80.0), JS.edm_sigmas(steps, sigma_max=80.0))
    sig = np.array([0.002, 0.3, 1.0, 17.5, 700.0], np.float32)
    for got, want in zip(S.v_scaling_edm_cnoise(torch.from_numpy(sig)),
                         JS.v_scaling_edm_cnoise(jnp.asarray(sig))):
        exact(got, want)
    exact(S.triangle_guidance_scales(21, 2.5), JS.triangle_guidance_scales(21, 2.5))
    exact(S.triangle_guidance_scales(3, 3.0), JS.triangle_guidance_scales(3, 3.0))


@pytest.mark.parametrize("adm", [24, 1280])
def test_vector_cond_matches_jax(adm):
    rng = np.random.default_rng(adm)
    pol = rng.uniform(0, np.pi, 21).astype(np.float32)
    azi = rng.uniform(0, 2 * np.pi, 21).astype(np.float32)
    got = S.build_sv3d_vector_cond(1e-5, torch.from_numpy(pol), torch.from_numpy(azi), adm)
    want = JS.build_sv3d_vector_cond(1e-5, jnp.asarray(pol), jnp.asarray(azi), adm)
    assert got.shape == (21, adm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,angles", [(21, [30, -30]), (21, [135.5, -20]), (3, [45, -45]),
                                      (21, []), (7, [10, 20, -5, -15])])
def test_azimuths_and_frame_pick_equal_jax(n, angles):
    got, want = generate_azimuth_angles(n, angles), j_azimuths(n, angles)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for target in (*angles, 0.0, 181.0, -90.0, 359.0):
        assert S.pick_frame_for_angle(got, target) == JS.pick_frame_for_angle(want, target)


# -- the video UNet -----------------------------------------------------------------


def test_video_unet_matches_jax(video, japply):
    model, _, params = video
    ins = video_inputs(3)
    want = np.asarray(japply(params, *map(jnp.asarray, ins)))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, ins))
    assert got.shape == want.shape == (3, 8, 8, 4)
    assert_close(got, want)


def test_per_frame_temporal_statistics_fail(video, japply, monkeypatch):
    """The temporal GroupNorm reduces over all frames of a clip at once:
    per-frame statistics must fail the same bound."""
    model, _, params = video
    ins = video_inputs(4)
    want = np.asarray(japply(params, *map(jnp.asarray, ins)))
    monkeypatch.setattr(TemporalResBlock, "_norm", lambda self, norm, y: norm(y))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, ins)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err > 10 * 2e-4, err


def test_mix_factors_change_the_output(video):
    """Every blend has a random non-zero mix factor (2 per res block, 1 per
    transformer), and flipping their signs changes the output, so the
    forward test above holds the blend's direction."""
    model, jmodel, params = video
    mixes = [p for n, p in model.named_parameters() if n.endswith("mix_factor")]
    assert len(mixes) == 2 * 3 + 2 * 2 + 2 and min(float(p.detach().abs()) for p in mixes) > 0
    ins = video_inputs(5)
    with torch.no_grad():
        before = model(*map(torch.from_numpy, ins))
        for p in mixes:
            p.neg_()
        after = model(*map(torch.from_numpy, ins))
        for p in mixes:
            p.neg_()
    assert (before - after).abs().max() > 1e-2 * before.abs().max()


def test_video_unet_round_trip(video):
    model, _, params = video
    sd = W.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), model)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_sample_latents_matches_jax_with_its_draws(video):
    model, jmodel, params = video
    rng = np.random.default_rng(6)
    cond = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    tok = rng.standard_normal((1, 1, 16)).astype(np.float32)
    az, el = [0.0, 100.0, 250.0], [10.0, 10.0, 10.0]
    key = jax.random.key(9)
    want = JS.SV3D(unet=jitted(jmodel, config=jmodel.config), unet_params=params, num_frames=3,
                   num_steps=3).sample_latents(
        jnp.asarray(cond), jnp.asarray(tok), az, el, key)
    draws = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(torch.from_numpy(np.array(jax.random.normal(sub, (3, 8, 8, 4)))))
    got = S.SV3D(unet=model, num_frames=3, num_steps=3).sample_latents(
        torch.from_numpy(cond), torch.from_numpy(tok), az, el, noise=tuple(draws))
    assert_close(got, np.asarray(want), tol=2e-3)


# -- crop and paste-back ------------------------------------------------------------


def _object(h, w, box, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), np.uint8)
    y0, y1, x0, x1 = box
    mask[y0:y1, x0:x1] = 255
    mask[y0, x0] = 0   # not a full rectangle
    return img, mask


@pytest.mark.parametrize("box,out", [((10, 30, 40, 61), 32), ((5, 60, 3, 20), 576),
                                     ((0, 64, 0, 64), 45)])
def test_crop_object_square_matches_jax(box, out):
    img, mask = _object(64, 64, box, 7)
    got, gbox = S.crop_object_square(img, mask, out_size=out, device="cpu")
    want, wbox = JS.crop_object_square(img, mask, out_size=out)
    assert gbox == wbox and got.shape == want.shape == (out, out, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("vbox,sbox", [((8, 24, 8, 24), (20, 40, 10, 30)),
                                       ((3, 50, 11, 37), (7, 20, 5, 58)),
                                       ((0, 13, 2, 9), (1, 63, 0, 41))])
def test_paste_novel_view_back_matches_jax(vbox, sbox):
    img, mask = _object(64, 64, sbox, 8)
    view, vmask = _object(64, 64, vbox, 9)
    bg = np.full_like(img, 17)
    for background in (None, bg):
        got = S.paste_novel_view_back(img, mask, view, vmask, background, device="cpu")
        want = JS.paste_novel_view_back(img, mask, view, vmask, background)
        np.testing.assert_array_equal(got[1], want[1])
        assert np.abs(got[0].astype(int) - want[0].astype(int)).max() <= 1
    empty = S.paste_novel_view_back(img, mask, view, np.zeros_like(vmask), bg, device="cpu")
    np.testing.assert_array_equal(empty[0], bg)
    assert not empty[1].any()


def test_nearest_index_is_jax_nearest():
    """jax.image.resize's "nearest" is torch's "nearest-exact" (not its
    "nearest"): 0..6 resized to 5 is [0, 2, 3, 4, 6]."""
    np.testing.assert_array_equal(S.resize_nearest_index(7, 5), [0, 2, 3, 4, 6])
    for n_in, n_out in ((7, 5), (13, 40), (40, 13), (576, 129)):
        x = np.arange(n_in, dtype=np.float32)
        want = np.asarray(jax.image.resize(jnp.asarray(x), (n_out,), "nearest"))
        np.testing.assert_array_equal(x[S.resize_nearest_index(n_in, n_out)], want)


# -- the loader and the full-size layout --------------------------------------------


def _abstract(convert, template, shapes: dict) -> set:
    """`convert` over int8 stand-ins with every `jnp.asarray` of the JAX
    weights modules left abstract: -> the keys it read.  (The open_clip
    converter copies its input with `dict(...)`; inside the call that name
    hands it the recording mapping itself.)"""
    tensors = ReadKeys({k: np.broadcast_to(np.int8(0), s) for k, s in shapes.items()})
    fake = types.SimpleNamespace(asarray=lambda a, dtype=None: jax.ShapeDtypeStruct(
        np.shape(a), dtype))
    real = JW.jnp, JWS.jnp
    JW.jnp = JWS.jnp = fake
    JW.dict = lambda mapping: mapping
    try:
        convert(template, tensors)
    finally:
        JW.jnp, JWS.jnp = real
        del JW.dict
    return tensors.read


def test_sv3d_p_layout_both_ways():
    """tests/fixtures/sv3d_p_keys.txt: the UNet's and the ViT-H's keys of
    sv3d_p.safetensors that the JAX converters read at full size (the
    converters run over int8 stand-ins, abstractly) are the port's
    full-size modules' keys and shapes (built on the meta device)."""
    want = manifest("sv3d_p_keys.txt")
    with torch.device("meta"):
        unet = VideoUNet(sv3d_config())
        vit = CLIPImageEncoder(clip_vit_h14())
    got = {UNET_PREFIX + k: tuple(v.shape) for k, v in unet.state_dict().items()}
    got.update({CLIP_PREFIX + k: tuple(v.shape) for k, v in vit.state_dict().items()})
    assert got == want
    assert sum(int(np.prod(s)) for k, s in want.items() if k.startswith(UNET_PREFIX)) > 1.5e9
    jcfg = j_sv3d_config()
    t = jcfg.num_frames
    utmpl = shapes_template(JVideoUNet(jcfg).init, (t, 72, 72, 8), (t,), (t, 1, 1024), (t, 1280))
    read = _abstract(JWS.convert_sv3d_unet, utmpl,
                     {k: s for k, s in want.items() if k.startswith(UNET_PREFIX)})
    vtmpl = shapes_template(JCLIPImage(j_clip_vit_h14()).init, (1, 224, 224, 3))
    read |= _abstract(JWS.convert_sv3d_clip_image, vtmpl,
                      {k: s for k, s in want.items() if k.startswith(CLIP_PREFIX)})
    assert read == set(want)


def test_load_sv3d_matches_jax_converters(video, tmp_path):
    """A tiny sgm-named file (UNet, ViT, LDM-named VAE) through `load_sv3d`
    equals the tensors written, and JAX's converters read the same file to
    the same weights (`state_dict_from_flax` of their trees).  A file that
    also holds a video decoder's temporal tensors raises and names them."""
    unet = video[0]
    vit = tiny_vit()[0]
    cfg, mods = tiny_modules(4)
    vae = mods["vae"]
    sd = {UNET_PREFIX + k: v for k, v in unet.state_dict().items()}
    sd.update({CLIP_PREFIX + k: v for k, v in vit.state_dict().items()})
    sd.update(_to_ldm({}, vae.state_dict(), {}, _conv1x1))
    path = str(tmp_path / "sv3d_tiny.safetensors")
    W.write_safetensors({k: v.contiguous() for k, v in sd.items()}, path)
    configs = (VideoUNetConfig(**TINY, dtype=torch.float32), CLIPVisionConfig(**TINY_VIT),
               cfg.vae)
    got = W.load_sv3d(path, *configs)
    for name, mod in (("unet", unet), ("clip_image", vit), ("vae", vae)):
        want = mod.state_dict()
        assert set(got[name]) == set(want)
        assert all(torch.equal(got[name][k], want[k]) for k in want), name
    tensors = {k: v.numpy() for k, v in W.read_safetensors(path).items()}
    jcfg = JVideoUNetConfig(**TINY, dtype=jnp.float32)
    trees = {
        "unet": JWS.convert_sv3d_unet(video_template(jcfg), tensors,
                                      channel_mult=jcfg.channel_mult,
                                      num_res=jcfg.num_res_blocks),
        "clip_image": JWS.convert_sv3d_clip_image(
            shapes_template(JCLIPImage(JCLIPVisionConfig(**TINY_VIT)).init, (1, 224, 224, 3)),
            tensors),
        "vae": JW.convert_vae(
            shapes_template(JAutoencoderKL(config=jax_tiny_config().vae).init, (1, 64, 64, 3)),
            JW._ldm_vae_to_diffusers(tensors)),
    }
    for name, mod in (("unet", unet), ("clip_image", vit), ("vae", vae)):
        back = W.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, trees[name]), mod)
        assert all(torch.equal(back[k], got[name][k]) for k in back), name
    with pytest.raises(ValueError, match="shape mismatch"):
        W.load_sv3d(path)   # SV3D_p's full-size modules do not take the tiny tensors
    temporal = ["first_stage_model.decoder.mid.attn_1.time_mixer.mix_factor",
                "first_stage_model.decoder.up.0.block.0.time_stack.in_layers.0.weight"]
    sd.update({k: torch.ones(3) for k in temporal})
    video_path = str(tmp_path / "sv3d_video_decoder.safetensors")
    W.write_safetensors({k: v.contiguous() for k, v in sd.items()}, video_path)
    with pytest.raises(ValueError, match="2 temporal VAE tensors") as err:
        W.load_sv3d(video_path, *configs)
    assert all(k in str(err.value) for k in temporal)


# -- what the card runs: the frame fold, the calls worked out for chip_smoke.py ----


def test_frame_fold_is_a_channels_last_view():
    """The temporal GroupNorm gets the frames folded into its rows,
    [B, C, T*H, W], as a channels-last view of the channels-last frames
    (no copy), which `group_norm_silu` takes as it is."""
    block = TemporalResBlock(8, 16, 3, 4, torch.float32)
    x = torch.randn(6, 8, 5, 7).contiguous(memory_format=torch.channels_last)
    seen = {}

    def norm(rows):
        seen.update(shape=tuple(rows.shape), ptr=rows.data_ptr(),
                    cl=rows.is_contiguous(memory_format=torch.channels_last))
        return rows

    y = block._norm(norm, x)
    assert seen == dict(shape=(2, 8, 15, 7), ptr=x.data_ptr(), cl=True)
    assert y.data_ptr() == x.data_ptr() and torch.equal(y, x)


def test_worked_out_calls_match_the_module(monkeypatch):
    """chip_smoke.py's `video_unet_calls` (the launches it expects per
    pass) is the full-size module's GroupNorm and `masked_sdpa` calls, in
    order: 105 norms and 16 attentions (5 at S 5184, 5 at 1296, 5 at 324,
    1 at 81), traced on the meta device."""
    import chip_smoke

    from freefine_tpu_torch.models import video_unet as V
    from freefine_tpu_torch.models.layers import GroupNorm32

    norms, attns = [], []
    monkeypatch.setattr(GroupNorm32, "forward", lambda self, x, silu=False: (
        norms.append((*x.shape, self.num_groups, self.eps)), x)[1])
    monkeypatch.setattr(V, "masked_sdpa", lambda q, k, v, heads: (
        attns.append((q.shape[0], heads, q.shape[1], q.shape[2] // heads)), q)[1])
    monkeypatch.setattr(V, "sdpa", lambda q, k, v, heads: q)
    cfg = sv3d_config()
    with torch.device("meta"):
        VideoUNet(cfg)(torch.zeros(21, 72, 72, 8), torch.zeros(21), torch.zeros(21, 1, 1024),
                       torch.zeros(21, 1280))
    assert (norms, attns) == tuple(map(list, chip_smoke.video_unet_calls(cfg, 72)))
    assert len(norms) == 105 and (1, 320, 21 * 72, 72, 32, 1e-5) in norms
    assert sorted(attns) == sorted([(21, 5, 5184, 64)] * 5 + [(21, 10, 1296, 64)] * 5
                                   + [(21, 20, 324, 64)] * 5 + [(21, 20, 81, 64)])
    timed = {s[:4] for s in chip_smoke.SV3D_FLASH_SHAPES}
    assert set(attns) | {(1, 1, 5184, 512)} == timed


def test_sv3d_norm_shapes_take_the_tma_routes():
    """Every GroupNorm shape of the SV3D path has a TMA plan; the
    frame-folded [1, 320, 1512, 72] slab (69.7 MB in bf16) streams."""
    import chip_smoke

    from freefine_tpu_torch.ops import group_norm as G

    shapes = chip_smoke.sv3d_gn_shapes()
    assert len(shapes) == 30
    plans = {s: dict(G._plan(s[0], s[1], s[2] * s[3], s[4], getattr(torch, s[6]), True))
             for s in shapes}
    assert all(p["route"] in ("resident", "streamed") for p in plans.values())
    assert plans[(1, 320, 1512, 72, 32, 1e-5, "bfloat16", False)]["route"] == "streamed"


def test_make_sv3d_edit_fn_on_a_tiny_checkpoint(tmp_path, monkeypatch):
    """`make_sv3d_edit_fn` reads an sgm file and a u2netp-layout .pth (SV3D_p's
    configs swapped for tiny ones, one Euler step) and its renderer equals
    `re_edit_3d_sv3d` on the loaded modules with a generator seeded by
    `seed`, call after call; without U^2-Net it mattes by brightness."""
    import functools

    from freefine_tpu_torch import config as C
    from freefine_tpu_torch.models import clip_image as CI
    from freefine_tpu_torch.models import u2net as U
    from freefine_tpu_torch.models import video_unet as V

    ecfg = VideoUNetConfig(**{**TINY, "attention_levels": (False, True)}, dtype=torch.float32)
    cfg, mods = tiny_modules(5)
    unet = randomize_all(VideoUNet(ecfg), 13).eval()
    vit = randomize_all(CLIPImageEncoder(CLIPVisionConfig(**TINY_VIT)), 14).eval()
    u2 = randomize_all(U2Net(U2NetConfig(**TINY_U2NET)), 15).eval()
    sd = {UNET_PREFIX + k: v for k, v in unet.state_dict().items()}
    sd.update({CLIP_PREFIX + k: v for k, v in vit.state_dict().items()})
    sd.update(_to_ldm({}, mods["vae"].state_dict(), {}, _conv1x1))
    path, u2path = str(tmp_path / "sv3d.safetensors"), str(tmp_path / "u2netp.pth")
    W.write_safetensors({k: v.contiguous() for k, v in sd.items()}, path)
    torch.save(u2.state_dict(), u2path)
    monkeypatch.setattr(V, "sv3d_config", lambda: ecfg)
    monkeypatch.setattr(CI, "clip_vit_h14", lambda: CLIPVisionConfig(**TINY_VIT))
    monkeypatch.setattr(C, "VAEConfig", lambda: cfg.vae)
    monkeypatch.setattr(U, "u2netp_config", lambda: U2NetConfig(**TINY_U2NET))
    monkeypatch.setattr(S, "SV3D", functools.partial(S.SV3D, num_frames=3, num_steps=1))
    img, mask = _object(cfg.height, cfg.width, (16, 50, 12, 44), 16)
    bg = np.full_like(img, 40)
    for matting in (u2, None):
        edit = S.make_sv3d_edit_fn(path, u2path if matting is not None else None, seed=3,
                                   device="cpu")
        got = [edit(img, mask, 30, bg) for _ in range(2 if matting is not None else 1)]
        want = S.re_edit_3d_sv3d(S.SV3D(unet=unet), mods["vae"].eval(), vit, matting, img,
                                 mask, 30.0, inp_background=bg,
                                 generator=torch.Generator().manual_seed(3))
        for g in got:
            np.testing.assert_array_equal(g[0], want[0])
            np.testing.assert_array_equal(g[1], want[1])


def test_pass_operations_counted_on_the_meta_device():
    """chip_smoke.py's `video_unet_pass_flops` (phase SV3D's bound of a
    pass) counts every part and leaves the module's functions as they
    were: 29.69 TFLOP of GEMMs and convolutions, 4.12 in the 16
    `flash_sdpa` calls, 0.027 in plain attention at SV3D_p's size."""
    import chip_smoke

    from freefine_tpu_torch.models import video_unet as V
    from freefine_tpu_torch.models.layers import GroupNorm32

    before = V.masked_sdpa, V.sdpa, GroupNorm32.forward
    f = chip_smoke.video_unet_pass_flops(sv3d_config(), 72)
    assert (V.masked_sdpa, V.sdpa, GroupNorm32.forward) == before
    assert f["flash_sdpa"] == 4 * 21 * 64 * (5 * 5 * 5184**2 + 5 * 10 * 1296**2
                                             + 5 * 20 * 324**2 + 20 * 81**2)
    assert 29.6e12 < f["gemm_conv"] < 29.8e12 and 0.02e12 < f["plain_attention"] < 0.03e12
