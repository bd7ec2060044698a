"""The port's RAFT (`freefine_tpu_torch.models.raft`) against the JAX
package's (`freefine_tpu.models.raft`): each block (the residual blocks of
both encoders, with instance and frozen batch norms, stride 2 and the 1x1
shortcut; both encoders; the motion encoder; SepConvGRU; the update block;
the convex upsampling) and the whole flow between two 64^2 images at
`iters` 2, on the full-width network.  The port's numpy-seeded weights and
BatchNorm statistics go through JAX's `convert_raft` into flax, and back
through the port's `state_dict_from_flax`.  Also RAFT's gradient to the
second image against `jax.grad`, the reference checkpoint's key layout
(tests/fixtures/raft_things_keys.txt) against the port's module and
against the keys JAX's converter reads (over `jax.eval_shape` of the
full-size RAFT, nothing allocated), and `load_raft` on a reference-layout
.pth and .safetensors file.

Tolerances: blocks and flow within 2e-4 of max |ref|; the gradient within
1e-3 of max |ref| (float32: summation order, amplified by the iterations
and the softmaxes).  The gradient's reference is `jax.grad` run in float64
(`jax.enable_x64`, scoped to that call; the correlation volume stays
float32 as JAX's flow ops cast it): JAX's own float32 gradient at this
input lies 3.4e-3 of max |ref| from both JAX's and the port's float64
gradients, where the port's float32 one lies 3.6e-6 from them.
"""

import functools
import os.path as osp
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from freefine_tpu.models import raft as JR
from freefine_tpu_torch import weights as W
from freefine_tpu_torch.models import raft as R

torch.set_num_threads(2)

TOL = 2e-4
GRAD_TOL = 1e-3
SIDE, ITERS = 64, 2
FIXTURES = osp.join(osp.dirname(__file__), "fixtures")


def assert_close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max |diff| {err:.3g} > {tol} x max |ref| {scale:.3g}"


@torch.no_grad()
def randomize(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter and BatchNorm statistic from a numpy seed: norm
    weights 1 + N(0, 0.1), running variances 0.5 + U(0, 1), other 1-D
    leaves N(0, 0.1), kernels N(0, 1 / fan_in)."""
    rng = np.random.default_rng(seed)
    for name, t in model.state_dict(keep_vars=True).items():
        if name.endswith("running_var"):
            a = 0.5 + rng.random(t.shape)
        elif t.ndim == 1 and ".norm" in name or name.endswith("downsample.1.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(t.shape)
        elif t.ndim == 1:
            a = 0.1 * rng.standard_normal(t.shape)
        else:
            a = rng.standard_normal(t.shape) / np.sqrt(t[0].numel())
        t.copy_(torch.from_numpy(a.astype(np.float32)))
    return model


def np_state(model) -> dict:
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def images(seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.random((1, SIDE, SIDE, 3)).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def raft():
    """(port RAFT, its flax params, JAX's jitted forward, and its gradient
    to image2 of sum(flow * cot) in float64)."""
    model = randomize(R.RAFT(device="cpu"), 0).eval()
    jmodel = JR.RAFT()
    z = jax.ShapeDtypeStruct((1, SIDE, SIDE, 3), jnp.float32)
    tmpl = jax.eval_shape(functools.partial(jmodel.init, iters=1), jax.random.key(0), z, z)
    params = JR.convert_raft(tmpl, np_state(model))
    apply = jax.jit(functools.partial(jmodel.apply, iters=ITERS))

    def grad2(a, b, cot):
        with jax.enable_x64(True):
            p64 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), params)
            j64 = JR.RAFT(JR.RAFTConfig(dtype=jnp.float64))
            a, b, cot = (jnp.asarray(x, jnp.float64) for x in (a, b, cot))
            return np.asarray(jax.jit(jax.grad(
                lambda y: jnp.sum(j64.apply(p64, a, y, ITERS) * cot)))(b))

    return model, params, apply, grad2, tmpl


def test_raft_flow_matches_jax(raft):
    model, params, apply, *_ = raft
    a, b = images(1)
    want = np.asarray(apply(params, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = model(torch.from_numpy(a), torch.from_numpy(b), ITERS)
    assert got.shape == (1, SIDE, SIDE, 2)
    assert want.std() > 1e-3
    assert_close(got, want)


def test_raft_gradient_to_image2_matches_jax(raft):
    model, params, _, grad2, _ = raft
    a, b = images(2)
    cot = np.random.default_rng(3).standard_normal((1, SIDE, SIDE, 2)).astype(np.float32)
    want = grad2(a, b, cot)
    y = torch.from_numpy(b).requires_grad_()
    got, = torch.autograd.grad(torch.sum(model(torch.from_numpy(a), y, ITERS)
                                         * torch.from_numpy(cot)), y)
    assert np.abs(want).max() > 0
    assert_close(got, want, GRAD_TOL)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


# (port submodule path, flax param path, flax module, input channels, side)
BLOCKS = [
    ("fnet.layer1.0", "fnet/layer1_0", JR.ResidualBlock(64, "instance", 1), 64, 16),
    ("fnet.layer2.0", "fnet/layer2_0", JR.ResidualBlock(96, "instance", 2), 64, 16),
    ("cnet.layer3.0", "cnet/layer3_0", JR.ResidualBlock(128, "batch", 2), 96, 16),
    ("cnet.layer1.1", "cnet/layer1_1", JR.ResidualBlock(64, "batch", 1), 64, 16),
    ("fnet", "fnet", JR.BasicEncoder(256, "instance"), 3, 32),
    ("cnet", "cnet", JR.BasicEncoder(256, "batch"), 3, 32),
]


@pytest.mark.parametrize("path,jpath,jmod,cin,side", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_encoder_blocks_match_jax(raft, path, jpath, jmod, cin, side):
    model, params, *_ = raft
    x = np.random.default_rng(4).standard_normal((2, side, side, cin)).astype(np.float32)
    sub = functools.reduce(lambda t, k: t[k], jpath.split("/"), params["params"])
    want = jmod.apply({"params": sub}, jnp.asarray(x))
    with torch.no_grad():
        got = model.get_submodule(path)(_nchw(x))
    assert_close(_nhwc(got), want)


def _update_inputs(seed):
    rng = np.random.default_rng(seed)
    shape = (2, 8, 8)
    return [rng.standard_normal(shape + (c,)).astype(np.float32) for c in (128, 128, 324, 2)]


def test_update_block_parts_match_jax(raft):
    model, params, *_ = raft
    p = params["params"]["update_block"]
    net, inp, corr, flow = _update_inputs(5)
    ub = model.update_block
    with torch.no_grad():
        motion = ub.encoder(_nchw(flow), _nchw(corr))
        x = torch.cat([_nchw(inp), motion], dim=1)
        h = ub.gru(_nchw(net), x)
        out = ub(_nchw(net), _nchw(inp), _nchw(corr), _nchw(flow))
    want_motion = JR.BasicMotionEncoder(324).apply({"params": p["encoder"]}, jnp.asarray(flow),
                                                   jnp.asarray(corr))
    assert_close(_nhwc(motion), want_motion)
    want_h = JR.SepConvGRU(128).apply({"params": p["gru"]}, jnp.asarray(net),
                                      jnp.asarray(_nhwc(x)))
    assert_close(_nhwc(h), want_h)
    want = JR.BasicUpdateBlock(JR.RAFTConfig()).apply(
        {"params": p}, *(jnp.asarray(a) for a in (net, inp, corr, flow)))
    for g, w in zip(out, want):
        assert_close(_nhwc(g), w)


def test_upsample_flow_convex_matches_jax():
    rng = np.random.default_rng(6)
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 5, 7, 576)).astype(np.float32)
    want = JR.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask))
    got = R.upsample_flow_convex(torch.from_numpy(flow), torch.from_numpy(mask))
    assert got.shape == (2, 40, 56, 2)
    assert_close(got, want)


def test_state_dict_from_flax_round_trip(raft):
    model, params, *_ = raft
    jax_np = jax.tree_util.tree_map(np.asarray, params)
    sd = W.state_dict_from_flax(jax_np, R.RAFT(device="meta"))
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_raft_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="cuda"):
        R.RAFT()


# -- the reference checkpoint's layout -------------------------------------------


def manifest() -> dict:
    out = {}
    with open(osp.join(FIXTURES, "raft_things_keys.txt")) as f:
        for line in f:
            key, shape = line.split()
            out[key] = tuple(int(s) for s in shape.split(","))
    return out


def test_manifest_matches_the_port():
    sd = R.RAFT(device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == manifest()


def test_manifest_matches_the_jax_converter(raft):
    """Both ways: the converter reads every manifest key and no other, and
    finds each at the manifest's shape (run over int8 stand-ins with its
    arrays left abstract), on `jax.eval_shape` of the full-size RAFT."""
    want = manifest()
    tmpl = raft[4]
    paths = traverse_util.flatten_dict(tmpl["params"], sep="/")
    assert {JR._torch_key(p) for p in paths} == set(want)
    fake = types.SimpleNamespace(asarray=lambda a, dtype=None: jax.ShapeDtypeStruct(
        np.shape(a), dtype))
    real, JR.jnp = JR.jnp, fake
    try:
        out = JR.convert_raft(tmpl, {f"module.{k}": np.broadcast_to(np.int8(0), s)
                                     for k, s in want.items()})
    finally:
        JR.jnp = real
    assert len(traverse_util.flatten_dict(out["params"])) == len(want)


def _reference_layout(model) -> dict:
    """The port's weights as raft-things.pth holds them: `module.`
    prefixed, each shortcut norm also under `norm3`, and the BatchNorms'
    `num_batches_tracked`."""
    raw = {}
    for k, v in model.state_dict().items():
        raw[f"module.{k}"] = v.clone()
        if ".downsample.1." in k:
            raw[f"module.{k.replace('.downsample.1.', '.norm3.')}"] = v.clone()
        if k.endswith("running_var"):
            raw[f"module.{k.replace('running_var', 'num_batches_tracked')}"] = torch.tensor(0)
    return raw


@pytest.mark.parametrize("suffix", [".pth", ".safetensors"])
def test_load_raft_reads_the_reference_layout(raft, tmp_path, suffix):
    model = raft[0]
    raw = _reference_layout(model)
    assert {k[len("module."):] for k in raw} >= set(manifest())
    path = str(tmp_path / f"raft-things{suffix}")
    if suffix == ".pth":
        torch.save(raw, path)
    else:
        W.write_safetensors(raw, path)
    loaded = W.load_raft(R.RAFT(device="cpu"), path)
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    raw.pop("module.fnet.conv1.weight")
    torch.save(raw, str(tmp_path / "missing.pth"))
    with pytest.raises(RuntimeError, match="fnet.conv1.weight"):
        W.load_raft(R.RAFT(device="cpu"), str(tmp_path / "missing.pth"))
