"""Weights of the PyTorch port against the JAX package's converter.

  * Round trip: a random torch state dict goes through
    `freefine_tpu.weights.convert_{unet,vae,text_encoder}` into flax params
    and back through the port's `state_dict_from_flax`, bit for bit.
  * The SD-1.5 UNet / VAE / text modules, built on the meta device, match
    the committed diffusers manifests (tests/fixtures/sd15_*_keys.txt) in
    keys and shapes.

Also home of the carry-across helpers the other test_torch_* files import:
`jax_params(module, kind, jax_cfg)` turns a torch module's weights into
the JAX package's params through its own converter; `cached_shapes`
keeps a JAX module's traced parameter shapes on disk for later processes.
"""

import functools
import glob
import hashlib
import os
import os.path as osp
import pickle

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import weights as W
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu_torch.config import sd15_pipeline_config, tiny_pipeline_config
from freefine_tpu_torch.models.text_encoder import CLIPTextEncoder
from freefine_tpu_torch.models.unet import UNet2DCondition
from freefine_tpu_torch.models.vae import AutoencoderKL
from freefine_tpu_torch.weights import random_weights, state_dict_from_flax

torch.set_num_threads(2)

FIXTURES = osp.join(osp.dirname(__file__), "fixtures")
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
# traced parameter shapes kept across test processes (listed in .gitignore)
SHAPE_CACHE = osp.join(ROOT, ".jax_test_cache")


# -- carry-across helpers ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_sources_digest() -> str:
    """A digest of the JAX package's sources and of jax and flax's
    versions: what a traced shape tree depends on beside its key."""
    h = hashlib.sha256(f"{jax.__version__} {flax.__version__}".encode())
    for path in sorted(glob.glob(osp.join(ROOT, "freefine_tpu", "**", "*.py"), recursive=True)):
        h.update(osp.relpath(path, ROOT).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def cached_shapes(tag: str, key, build):
    """`build()`, a tree of `jax.ShapeDtypeStruct` (a `jax.eval_shape` of a
    JAX module's init), kept on disk under `tag` and `repr(key)` with the
    JAX package's sources: a test process loads what an earlier one traced
    (a tiny UNet's init takes seconds to trace).  Written atomically, so
    concurrent test workers do not read a partial file."""
    name = hashlib.sha256(f"{tag} {key!r} {_jax_sources_digest()}".encode()).hexdigest()
    path = osp.join(SHAPE_CACHE, f"shapes-{tag}-{name[:32]}.pkl")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, EOFError, pickle.UnpicklingError):
        pass
    tree = build()
    os.makedirs(SHAPE_CACHE, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(tree, f)
    os.replace(tmp, path)
    return tree


def jax_template(kind: str, jax_cfg):
    """Shape tree of the JAX module's params (no weight allocation), traced
    once per kind and config (`cached_shapes`)."""
    return cached_shapes(f"tiny-{kind}", (kind, jax_cfg), lambda: _trace_template(kind, jax_cfg))


def _trace_template(kind: str, jax_cfg):
    from freefine_tpu.models.text_encoder import CLIPTextEncoder as JText
    from freefine_tpu.models.unet import UNet2DCondition as JUNet
    from freefine_tpu.models.vae import AutoencoderKL as JVAE

    key = jax.random.key(0)
    if kind == "unet":
        c = jax_cfg.unet
        lh, lw = jax_cfg.latent_height, jax_cfg.latent_width
        return jax.eval_shape(
            JUNet(config=c).init, key,
            jax.ShapeDtypeStruct((1, lh, lw, c.in_channels), c.dtype),
            jax.ShapeDtypeStruct((), jnp.int32),
            jax.ShapeDtypeStruct((1, 77, c.cross_attention_dim), c.dtype),
        )
    if kind == "vae":
        return jax.eval_shape(
            JVAE(config=jax_cfg.vae).init, key,
            jax.ShapeDtypeStruct((1, jax_cfg.height, jax_cfg.width, 3), jax_cfg.vae.dtype),
        )
    return jax.eval_shape(
        JText(config=jax_cfg.text).init, key,
        jax.ShapeDtypeStruct((1, jax_cfg.text.max_length), jnp.int32),
    )


_CONVERTERS = {
    "unet": W.convert_unet, "vae": W.convert_vae, "text": W.convert_text_encoder,
}


def torch_tensors(module: torch.nn.Module) -> dict:
    return {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()}


def jax_params(module: torch.nn.Module, kind: str, jax_cfg=None):
    """The JAX package's params holding `module`'s weights (float32)."""
    jax_cfg = jax_cfg or jax_tiny_config()
    return _CONVERTERS[kind](jax_template(kind, jax_cfg), torch_tensors(module))


def tiny_modules(seed: int = 0):
    """Tiny-config torch UNet / VAE / text encoder on the CPU.  Biases are
    filled too (random_weights leaves them 0) so the carry-across covers
    every leaf."""
    cfg = tiny_pipeline_config()
    mods = {
        "unet": UNet2DCondition(cfg.unet), "vae": AutoencoderKL(cfg.vae),
        "text": CLIPTextEncoder(cfg.text),
    }
    g = torch.Generator().manual_seed(seed + 100)
    for i, m in enumerate(mods.values()):
        random_weights(m, seed + i)
        with torch.no_grad():
            for name, p in m.named_parameters():
                if p.ndim == 1:
                    p.add_(0.02 * torch.randn(p.shape, generator=g))
    return cfg, mods


# -- tests ---------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["unet", "vae", "text"])
def test_round_trip_through_jax_converter(kind):
    _, mods = tiny_modules(3)
    mod = mods[kind]
    flax = jax.tree_util.tree_map(np.asarray, jax_params(mod, kind))
    back = state_dict_from_flax(flax, mod)
    want = mod.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k


def test_state_dict_from_flax_rejects_bad_trees():
    _, mods = tiny_modules(0)
    flax = jax.tree_util.tree_map(np.asarray, jax_params(mods["text"], "text"))
    flax["params"]["final_layer_norm"]["LayerNorm_0"].pop("bias")
    with pytest.raises(KeyError):
        state_dict_from_flax(flax, mods["text"])


def _manifest(name):
    out = {}
    with open(osp.join(FIXTURES, name)) as f:
        for line in f:
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


@pytest.mark.parametrize(
    "kind,fixture,count",
    [("unet", "sd15_unet_keys.txt", 686), ("vae", "sd15_vae_keys.txt", 248),
     ("text", "sd15_text_keys.txt", 196)],
)
def test_sd15_modules_match_manifest(kind, fixture, count):
    cfg = sd15_pipeline_config()
    with torch.device("meta"):
        mod = {"unet": lambda: UNet2DCondition(cfg.unet), "vae": lambda: AutoencoderKL(cfg.vae),
               "text": lambda: CLIPTextEncoder(cfg.text)}[kind]()
    got = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
    want = _manifest(fixture)
    assert len(want) == count
    assert sorted(set(want) - set(got)) == [] and sorted(set(got) - set(want)) == []
    assert {k: got[k] for k in want if got[k] != want[k]} == {}


def test_random_weights_scheme():
    cfg = tiny_pipeline_config()
    a = random_weights(CLIPTextEncoder(cfg.text), seed=5)
    b = random_weights(CLIPTextEncoder(cfg.text), seed=5)
    sa, sb = a.state_dict(), b.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert torch.all(sa["text_model.final_layer_norm.weight"] == 1)
    assert torch.all(sa["text_model.encoder.layers.0.mlp.fc1.bias"] == 0)
    w = sa["text_model.encoder.layers.0.mlp.fc1.weight"]
    assert abs(float(w.std()) - 0.02) < 0.003
