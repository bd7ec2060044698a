"""The IP-Adapter branch of the port (`models/ip_adapter.py`, the
`ip_scale` cross-attention branch of `EditAttention`, `context_image`
through the UNet's and the DiT's blocks) against the JAX package's, on the
CPU.

  * `Resampler` (tiny) within 2e-4 of JAX's, the weights carried by JAX's
    `convert_resampler` from the port's state dict (IP-Adapter's names);
  * `cross_attention_order` is JAX's order (diffusers' `attn_processors`:
    down, up, mid), path for path, on the tiny and SD-1.5 UNets;
  * a tiny UNet with IP tokens at ip_scale 0.5 within 2e-4 of JAX's
    `add_ip_adapter_params` + `convert_ip_adapter_unet` UNet, the adapter
    weights written as an "ip_adapter" state dict and read back by
    `load_ip_adapter`; the tiny DiT with IP tokens within 2e-4 of JAX's
    (its adapter tree carried by `state_dict_from_flax`);
  * the branch's errors: tokens or layers missing, a misshapen tensor.
"""

import dataclasses
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax import traverse_util

from freefine_tpu.config import sd15_pipeline_config as jax_sd15_config
from freefine_tpu.config import tiny_dit_pipeline_config as jax_tiny_dit_config
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.models import ip_adapter as JIP
from freefine_tpu.models.unet import UNet2DCondition as JUNet
from freefine_tpu_torch import pipeline as P
from freefine_tpu_torch.config import (
    sd15_pipeline_config,
    tiny_dit_pipeline_config,
    tiny_pipeline_config,
)
from freefine_tpu_torch.edit import EditConfig
from freefine_tpu_torch.models import ip_adapter as IP
from freefine_tpu_torch.models.dit import DiT2DCondition
from freefine_tpu_torch.weights import state_dict_from_flax
from test_torch_weights import jax_params, tiny_modules, torch_tensors

torch.set_num_threads(2)

ATOL = 2e-4


def _tiny_resampler(dtype):
    return dict(dim=32, depth=2, dim_head=8, heads=4, num_queries=4, embedding_dim=48,
                output_dim=24, ff_mult=2, dtype=dtype)


def test_resampler_matches_jax():
    cfg = IP.ResamplerConfig(**_tiny_resampler(torch.float32))
    mod = IP.Resampler(cfg)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g) + (1.0 if p.ndim == 1 else 0.0))
    keys = set(mod.state_dict())
    assert {"latents", "proj_in.weight", "layers.1.0.to_kv.weight", "layers.1.0.norm2.bias",
            "layers.1.1.0.weight", "layers.1.1.1.weight", "layers.1.1.3.weight",
            "norm_out.weight"} <= keys
    assert mod.latents.shape == (1, 4, 32)
    jcfg = JIP.ResamplerConfig(**_tiny_resampler(jnp.float32))
    x = np.random.default_rng(1).normal(size=(2, 10, 48)).astype(np.float32)
    jm = JIP.Resampler(config=jcfg)
    tmpl = jax.eval_shape(jm.init, jax.random.key(0), jax.ShapeDtypeStruct(x.shape, jnp.float32))
    jp = JIP.convert_resampler(tmpl, torch_tensors(mod), depth=cfg.depth)
    want = np.asarray(jm.apply(jp, x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 4, 24) and np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("make,jmake", [(tiny_pipeline_config, jax_tiny_config),
                                        (sd15_pipeline_config, jax_sd15_config)])
def test_cross_attention_order_is_jax(make, jmake):
    got = IP.cross_attention_order(make().unet)
    want = JIP.cross_attention_order(jmake().unet)
    # flax "down_blocks_1_attentions_0/transformer_blocks_0" -> the module path
    assert got == [re.sub(r"_(\d+)", r".\1", p).replace("_attentions", ".attentions")
                   .replace("/", ".") for p in want]
    assert len(got) == 16
    with pytest.raises(ValueError):
        IP.cross_attention_order(tiny_dit_pipeline_config().unet)


@pytest.fixture(scope="module")
def ip_unets():
    cfg, mods = tiny_modules(61)
    jcfg = jax_tiny_config()
    tpipe = P.FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    IP.add_ip_adapter(tpipe, seed=7)
    layers = IP.cross_attentions(tpipe.unet)
    g = torch.Generator().manual_seed(8)
    sd = {}
    for idx, path in enumerate(IP.cross_attention_order(cfg.unet)):
        for leaf in ("to_k_ip", "to_v_ip"):
            w = getattr(layers[f"{path}.attn2"], leaf).weight
            sd[f"{2 * idx + 1}.{leaf}.weight"] = 0.3 * torch.randn(w.shape, generator=g)
    IP.load_ip_adapter(tpipe, {"image_proj": {}, "ip_adapter": sd})
    # the part of a JAX pipe that `add_ip_adapter_params` and the UNet read
    jpipe = types.SimpleNamespace(config=jcfg, unet=JUNet(config=jcfg.unet),
                                  params={"unet": jax_params(mods["unet"], "unet", jcfg)})
    # The tree of `add_ip_adapter_params` (traced, not run: its fresh IP
    # kernels are overwritten by `convert_ip_adapter_unet`, and every other
    # leaf is the pipe's own UNet parameter, as that function keeps it).
    fresh = jax.eval_shape(lambda key: JIP.add_ip_adapter_params(jpipe, key), jax.random.key(0))
    junet = JIP.convert_ip_adapter_unet(fresh, jcfg.unet, {k: v.numpy() for k, v in sd.items()})
    base = traverse_util.flatten_dict(jpipe.params["unet"]["params"])
    flat = {k: base[k] if isinstance(v, jax.ShapeDtypeStruct) else v
            for k, v in traverse_util.flatten_dict(junet["params"]).items()}
    junet = {**junet, "params": traverse_util.unflatten_dict(flat)}
    return cfg, tpipe, jpipe, junet, sd


def _ip_inputs(cfg, width):
    rng = np.random.default_rng(9)
    lat = rng.normal(size=(2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, width)).astype(np.float32)
    tok = rng.normal(size=(2, 16, width)).astype(np.float32)
    return lat, ctx, tok


def test_ip_unet_matches_jax(ip_unets):
    cfg, tpipe, jpipe, junet, sd = ip_unets
    lat, ctx, tok = _ip_inputs(cfg, cfg.unet.cross_attention_dim)
    ecfg = dict(mode="none", method=None, local_cfg=False, ip_scale=0.5)
    want = np.asarray(jax.jit(lambda *a: jpipe.unet.apply(
        *a, edit_cfg=JEditConfig(**ecfg), context_image=tok))(junet, lat, jnp.int32(501), ctx))
    x, c, t = (torch.from_numpy(a) for a in (lat, ctx, tok))
    with torch.no_grad():
        got = tpipe.unet(x.permute(0, 3, 1, 2), 501, c, edit_cfg=EditConfig(**ecfg),
                         context_image=t).permute(0, 2, 3, 1).numpy()
        plain = tpipe.unet(x.permute(0, 3, 1, 2), 501, c).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.abs(got - plain).max() > 100 * ATOL  # the image tokens are live
    # every layer read its own tensors from the state dict
    layers = IP.cross_attentions(tpipe.unet)
    for idx, path in enumerate(IP.cross_attention_order(cfg.unet)):
        assert torch.equal(layers[f"{path}.attn2"].to_v_ip.weight,
                           sd[f"{2 * idx + 1}.to_v_ip.weight"])


def test_ip_branch_errors(ip_unets):
    cfg, tpipe, _, _, sd = ip_unets
    lat, ctx, _ = _ip_inputs(cfg, cfg.unet.cross_attention_dim)
    x, c = torch.from_numpy(lat).permute(0, 3, 1, 2), torch.from_numpy(ctx)
    with torch.no_grad(), pytest.raises(ValueError, match="context_image"):
        tpipe.unet(x, 501, c, edit_cfg=EditConfig(mode="none", method=None, ip_scale=0.5))
    bare = P.FreeFine(cfg, init_random=True, device="cpu")
    with pytest.raises(KeyError, match="add_ip_adapter"):
        IP.load_ip_adapter(bare, sd)
    IP.add_ip_adapter(bare)
    bad = dict(sd)
    bad["3.to_k_ip.weight"] = torch.zeros(5, 5)
    with pytest.raises(ValueError):
        IP.load_ip_adapter(bare, bad)


def test_ip_dit_matches_jax():
    from freefine_tpu.models.dit import DiT2DCondition as JDiT

    cfg, jcfg = tiny_dit_pipeline_config(), jax_tiny_dit_config()
    cfg, jcfg = (dataclasses.replace(c, unet=dataclasses.replace(c.unet, learn_sigma=True))
                 for c in (cfg, jcfg))
    width = cfg.unet.cross_attention_dim
    lat, ctx, tok = _ip_inputs(cfg, width)
    ecfg = dict(mode="none", method=None, local_cfg=False, ip_scale=0.5)
    jm = JDiT(config=jcfg.unet)
    tmpl = jax.eval_shape(lambda key: jm.init(key, jnp.asarray(lat), jnp.int32(1),
                                              jnp.asarray(ctx), edit_cfg=JEditConfig(**ecfg),
                                              context_image=jnp.asarray(tok)), jax.random.key(3))
    rng = np.random.default_rng(4)  # weights of order one: a live comparison
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.15 * rng.standard_normal(a.shape), a.dtype), tmpl)
    dit = DiT2DCondition(cfg.unet)
    for layer in IP.cross_attentions(dit).values():
        layer.add_ip_layers(width)
    dit.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp), dit))
    want = np.asarray(jax.jit(lambda p: jm.apply(p, lat, jnp.int32(501), ctx,
                                                 edit_cfg=JEditConfig(**ecfg),
                                                 context_image=tok))(jp))
    with torch.no_grad():
        got = dit(torch.from_numpy(lat).permute(0, 3, 1, 2), 501, torch.from_numpy(ctx),
                  edit_cfg=EditConfig(**ecfg), context_image=torch.from_numpy(tok))
        plain = dit(torch.from_numpy(lat).permute(0, 3, 1, 2), 501, torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=ATOL, rtol=0)
    assert float((got - plain).abs().max()) > 100 * ATOL
