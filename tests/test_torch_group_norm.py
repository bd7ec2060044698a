"""The port's fused GroupNorm(+SiLU) against `freefine_tpu.ops.group_norm`.

The JAX side runs `group_norm_silu` under FREEFINE_FUSED_GN=1, which on the
CPU is its Pallas kernel in interpret mode (as tests/test_group_norm.py runs
it); the port runs its wrapper, which on CPU tensors is the plain twin.
Layouts: NHWC in JAX, NCHW in the port, transposed at the boundary.

Tolerances: 1e-5 absolute in float32 (the same function, summation order
only), 2e-2 in bfloat16 (one rounding of the output), 1e-4 on the
gradients; the UNet forward within the model parity tolerance 2e-4.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.models.layers import GroupNorm32 as JGroupNorm32
from freefine_tpu.models.unet import UNet2DCondition as JUNet
from freefine_tpu.ops import group_norm as JG
from freefine_tpu_torch.config import sd15_pipeline_config
from freefine_tpu_torch.models.layers import GroupNorm32
from freefine_tpu_torch.ops import group_norm as G
from test_torch_weights import jax_params, tiny_modules
from torch_spy import spy

import chip_smoke

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _fused(monkeypatch):
    monkeypatch.setenv("FREEFINE_FUSED_GN", "1")


def _case(b=2, h=8, w=8, c=64, seed=0):
    """NHWC x, scale, bias as numpy float32."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, h, w, c)) * 2 + 0.5).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.2).astype(np.float32)
    return x, scale, bias


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("apply_silu", [False, True])
@pytest.mark.parametrize("groups", [8, 32])
def test_twin_matches_pallas(groups, apply_silu, monkeypatch):
    x, scale, bias = _case()
    want = JG.group_norm_silu(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                              num_groups=groups, apply_silu=apply_silu)
    args = (_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias))
    kw = dict(num_groups=groups, eps=1e-5, apply_silu=apply_silu)
    got = G.group_norm_silu_reference(*args, **kw)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    G.reset_launch_counts()
    # the CPU wrapper returns the twin's own result (a spy, not a second call
    # compared bit for bit, which would depend on the CPU library's threading)
    twin = spy(monkeypatch, G, "group_norm_silu_reference")
    assert G.group_norm_silu(*args, **kw) is twin[0][2]
    assert G.LAUNCHES == {"group_norm_silu": 0} and not G.LAUNCH_SHAPES
    # and both agree with the two-pass math
    np.testing.assert_allclose(got.numpy(), G.group_norm_reference(*args, **kw).numpy(),
                               atol=1e-5, rtol=0)


def test_twin_bf16_matches_pallas():
    x, scale, bias = _case(seed=1)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = JG.group_norm_silu(jx, jnp.asarray(scale), jnp.asarray(bias), num_groups=8,
                              eps=1e-6)
    tx = _nchw(np.asarray(jx.astype(jnp.float32))).bfloat16()
    got = G.group_norm_silu(tx, torch.from_numpy(scale), torch.from_numpy(bias), num_groups=8,
                            eps=1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32), atol=2e-2, rtol=0)


@pytest.mark.parametrize("apply_silu", [False, True])
def test_gradient_matches_jax(apply_silu):
    x, scale, bias = _case(c=32, seed=2)
    rng = np.random.default_rng(3)
    ct = rng.normal(size=x.shape).astype(np.float32)

    def loss(xx, sc, bb):
        y = JG.group_norm_silu(xx, sc, bb, num_groups=8, apply_silu=apply_silu)
        return jnp.sum(y * jnp.asarray(ct))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (x, scale, bias)))
    leaves = [_nchw(x).requires_grad_(), torch.from_numpy(scale).requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    y = G.group_norm_silu_diff(*leaves, num_groups=8, apply_silu=apply_silu)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * _nchw(ct)).sum(), leaves)
    np.testing.assert_allclose(_nhwc(got[0]), np.asarray(want[0]), atol=1e-4, rtol=0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    # only the inputs that require grad get one
    xs = _nchw(x).requires_grad_()
    (gx,) = torch.autograd.grad(
        G.GroupNormSiLU.apply(xs, torch.from_numpy(scale), torch.from_numpy(bias), 8, 1e-5,
                              apply_silu).sum(), [xs])
    assert gx.shape == xs.shape


@pytest.mark.parametrize("silu", [False, True])
def test_module_matches_jax(silu):
    x, scale, bias = _case(c=32, seed=4)
    want = JGroupNorm32(8, epsilon=1e-6).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x),
        silu=silu)
    mod = GroupNorm32(8, 32, eps=1e-6)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        got = mod(_nchw(x), silu=silu)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)


def test_unet_forward_fused_matches_jax():
    """The tiny UNet with FREEFINE_FUSED_GN=1 in both packages.  JAX fuses
    where its tile rule allows (H % 8 == 0) and runs the plain math
    elsewhere; the port fuses every norm."""
    cfg, mods = tiny_modules(13)
    jcfg = jax_tiny_config()
    rng = np.random.default_rng(5)
    sample = rng.normal(size=(2, cfg.latent_height, cfg.latent_width, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, cfg.unet.cross_attention_dim)).astype(np.float32)
    want = JUNet(config=jcfg.unet).apply(jax_params(mods["unet"], "unet", jcfg),
                                         jnp.asarray(sample), jnp.int32(401), jnp.asarray(ctx))
    with torch.no_grad():
        got = mods["unet"](torch.from_numpy(sample).permute(0, 3, 1, 2), 401,
                           torch.from_numpy(ctx)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_gating(monkeypatch):
    """'1' is on wherever the channels split into the groups, including the
    512^2 x 128 VAE slab that JAX keeps on the plain math (its VMEM tile
    rule; the port's documented route deviation), on any device; '0' is
    off; 'auto', the default, fuses a tensor on a CUDA device only (JAX's
    'auto' fuses on the TPU only); any other value raises."""
    cuda = torch.device("cuda")
    vae_slab = (1, 128, 512, 512)
    assert G.use_fused(vae_slab, 32)
    assert not JG.use_fused((1, 512, 512, 128), 32)  # JAX: the slab does not fit its tile
    assert G.use_fused((2, 320, 64, 64), 32) and G.use_fused((1, 64, 1, 1), 8)
    assert G.use_fused((2, 320, 64, 64), 32, cuda)
    assert not G.use_fused((2, 30, 8, 8), 32) and not G.use_fused((2, 64, 8), 8)
    monkeypatch.setenv("FREEFINE_FUSED_GN", "0")
    for dev in ("cpu", cuda):
        assert not G.use_fused(vae_slab, 32, dev) and not G.use_fused((2, 320, 64, 64), 32, dev)
    monkeypatch.setenv("FREEFINE_FUSED_GN", "auto")
    assert not G.use_fused(vae_slab, 32, "cpu") and not G.use_fused((2, 320, 64, 64), 32)
    assert G.use_fused(vae_slab, 32, cuda) and G.use_fused((2, 320, 64, 64), 32, "cuda:0")
    assert not G.use_fused((2, 30, 8, 8), 32, cuda)
    assert (G.fused_gn_route("cpu"), G.fused_gn_route(cuda)) == ("0", "1")
    monkeypatch.delenv("FREEFINE_FUSED_GN")  # unset: 'auto'
    assert G.fused_gn_mode() == "auto"
    assert not G.use_fused((2, 320, 64, 64), 32, "cpu") and G.use_fused((2, 320, 64, 64), 32, cuda)
    for bad in ("", "on", "true", "2", "AUTO"):
        monkeypatch.setenv("FREEFINE_FUSED_GN", bad)
        with pytest.raises(ValueError, match="FREEFINE_FUSED_GN"):
            G.use_fused((2, 320, 64, 64), 32)


def test_raw_kernel_refuses_grad_mode(monkeypatch):
    x, scale, bias = _case(c=32, seed=6)
    args = [_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias)]
    twin = spy(monkeypatch, G, "group_norm_silu_reference")
    for i in range(3):
        leaf = [a.clone().requires_grad_() if j == i else a for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="no backward"):
            G.group_norm_silu(*leaf, num_groups=8)
        with torch.no_grad():
            assert G.group_norm_silu(*leaf, num_groups=8) is twin[-1][2]
        assert all(a is b for a, b in zip(twin[-1][0], leaf))  # the twin got the call's operands


def test_wrapper_rejects_bad_operands():
    x, scale, bias = _case(c=32, seed=7)
    tx, ts, tb = _nchw(x), torch.from_numpy(scale), torch.from_numpy(bias)
    with pytest.raises(ValueError):
        G.group_norm_silu(tx, ts, tb, num_groups=5)
    with pytest.raises(ValueError):
        G.group_norm_silu(tx.double(), ts, tb, num_groups=8)
    with pytest.raises(ValueError):
        G.group_norm_silu(tx, ts.bfloat16(), tb, num_groups=8)
    with pytest.raises(ValueError):
        G.group_norm_silu(tx[:, :, 0], ts, tb, num_groups=8)


@pytest.mark.parametrize("shape,groups,dtype,route", [
    ((3, 320, 64, 64), 32, "bfloat16", "resident"), ((4, 960, 64, 64), 32, "bfloat16", "resident"),
    ((1, 1280, 8, 8), 32, "bfloat16", "resident"), ((4, 2560, 16, 16), 32, "bfloat16", "resident"),
    ((3, 1920, 32, 32), 32, "bfloat16", "resident"), ((1, 512, 256, 256), 32, "bfloat16", "streamed"),
    ((1, 128, 512, 512), 32, "bfloat16", "streamed"), ((2, 256, 512, 512), 32, "bfloat16", "streamed"),
    ((3, 96, 20, 20), 32, "bfloat16", "resident"), ((2, 64, 16, 16), 8, "float32", "resident"),
    ((2, 16, 64, 64), 8, "float32", "resident"), ((2, 128, 1, 1), 8, "float32", "resident"),
    ((2, 64, 7, 9), 8, "float32", "resident"), ((2, 18, 8, 8), 6, "float32", "plain"),
    ((2, 60, 30, 25), 6, "bfloat16", "plain"), ((2, 36, 3, 5), 6, "bfloat16", "plain")])
def test_launch_plan_covers_the_tensor(shape, groups, dtype, route):
    """One launch: each (image, block of whole groups) is a cluster of at
    most 16 CTAs whose position ranges cover H * W once, the blocks cover
    the channels once, a block is a 16-byte TMA box row of at most 256
    elements (else the plain-load route), and a CTA's shared memory stays
    within 227 KB; resident plans keep every box of a CTA in its own stage.
    The kernel takes channels-last tensors only (the wrapper copies any
    other layout first)."""
    b, c, h, w = shape
    x = torch.zeros(shape, dtype=getattr(torch, dtype)).contiguous(
        memory_format=torch.channels_last)
    plan = G.launch_plan(x, groups)
    assert plan["route"] == route
    cpg, es, hw = c // groups, x.element_size(), h * w
    gb, cb, n, rows = (plan[k] for k in ("groups_per_block", "block_channels", "cluster",
                                         "rows_per_cta"))
    assert cb == gb * cpg and groups % gb == 0 and plan["units"] == b * groups // gb
    channels = np.zeros(c, int)
    for blk in range(groups // gb):
        channels[blk * cb:(blk + 1) * cb] += 1
    positions = np.zeros(hw, int)
    for rank in range(n):
        positions[rank * rows:(rank + 1) * rows] += 1
    assert (channels == 1).all() and (positions == 1).all() and n * rows - rows < hw
    assert 1 <= n <= 16 and plan["smem_bytes"] <= 227 * 1024
    if route == "plain":
        assert plan["vec"] == 1 and plan["stages"] == 0 and gb == 1
        assert (c * es) % 16 or (cb * es) % 16 or cb > 256
    else:
        assert plan["vec"] * es == 16 and (cb * es) % 16 == 0 and cb <= 256
        assert 1 <= plan["box_rows"] <= 256 and rows % plan["box_rows"] == 0
        boxes = rows // plan["box_rows"]
        assert (boxes <= plan["stages"]) == (route == "resident")
        stage = -(-plan["box_rows"] * cb * es // 128) * 128
        assert plan["smem_bytes"] == G.smem_bytes(plan["stages"], stage, 256 * plan["vec"], cb, gb)
    if hw > 1 and c > 1:
        with pytest.raises(ValueError):
            G.launch_plan(x.contiguous(), groups)  # NCHW
    with pytest.raises(ValueError):
        G.launch_plan(x[:, ::2], groups // 2 or 1)  # strided channels


def test_plan_constants_are_the_kernels():
    """The plan's limits are the kernel source's (csrc/group_norm.cu)."""
    src = (Path(G.__file__).resolve().parents[1] / "csrc" / "group_norm.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == G._THREADS
    assert int(consts["kMaxCluster"]) == G._MAX_CLUSTER
    assert int(consts["kMaxSmem"]) == G._SMEM_MAX
    assert int(consts["kMaxBox"]) == G._MAX_BOX


def _path_shapes():
    cfg = sd15_pipeline_config()
    unet = {(b, *call) for b in {b for p in chip_smoke.GN_PATH_BATCHES.values()
                                 for b in p["unet"]}
            for call in chip_smoke.norm_calls(cfg, "unet")}
    return [pytest.param(shape, shape[:-2] in unet, id="-".join(map(str, shape[:5])))
            for shape in chip_smoke.gn_shapes(cfg)]


@pytest.mark.parametrize("shape,is_unet", _path_shapes())
def test_path_shapes_take_one_cluster_launch(shape, is_unet):
    """Every GroupNorm shape of the SD-1.5 paths takes the TMA route in one
    launch: every UNet shape (at most 7.9 MB an image) resident, x read
    once; the 512^2 VAE slabs (67 and 134 MB an image, more than a cluster
    holds at any block width) stream; the VAE's 128^2 and 256^2 slabs
    stream where a unit passes 512 KB."""
    b, c, h, w, g, eps, dtype, silu = shape
    x = torch.empty((b, c, h, w), dtype=getattr(torch, dtype),
                    memory_format=torch.channels_last)  # not touched: the plan reads the shape
    plan = G.launch_plan(x, g)
    if is_unet:
        assert plan["route"] == "resident"
    elif (h, w) == (512, 512):
        assert plan["route"] == "streamed"
    else:
        narrow = 64 // 2  # channels of the narrowest block of 64 bytes or more
        unit = h * w * max(narrow, c // g) * 2
        assert plan["route"] == ("streamed" if unit > 512 * 1024 else "resident")
    assert plan["units"] <= 65535 and plan["cluster"] <= 16
    assert plan["smem_bytes"] <= 227 * 1024


@pytest.mark.parametrize("apply_silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_keeps_the_input_layout(dtype, apply_silu):
    """The two-pass route returns channels-last for a channels-last input
    (the convolution after it then needs no transpose) with the values of
    the cast back alone, bit for bit; an NCHW input stays NCHW; the
    gradient through it is unchanged."""
    x, scale, bias = _case(c=32, seed=8)
    kw = dict(num_groups=8, eps=1e-6, apply_silu=apply_silu)
    nchw = _nchw(x).to(dtype)
    cl = nchw.contiguous(memory_format=torch.channels_last)
    sc, bs = torch.from_numpy(scale), torch.from_numpy(bias)

    def before(t):  # the route as it was: the cast back only
        y = torch.nn.functional.group_norm(t.float(), 8, sc, bs, 1e-6)
        return (torch.nn.functional.silu(y) if apply_silu else y).to(t.dtype)

    got = G.group_norm_reference(cl, sc, bs, **kw)
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == dtype
    assert torch.equal(got, before(cl))
    flat = G.group_norm_reference(nchw, sc, bs, **kw)
    assert flat.is_contiguous() and torch.equal(flat, before(nchw))
    leaves = [cl.clone().requires_grad_(), sc.clone().requires_grad_()]
    want = [t.clone().requires_grad_() for t in leaves]
    ct = torch.from_numpy(np.random.default_rng(9).normal(size=cl.shape).astype(np.float32))
    g_new = torch.autograd.grad(G.group_norm_reference(leaves[0], leaves[1], bs, **kw), leaves,
                                ct.to(dtype))
    y_old = torch.nn.functional.group_norm(want[0].float(), 8, want[1], bs, 1e-6)
    y_old = (torch.nn.functional.silu(y_old) if apply_silu else y_old).to(dtype)
    g_old = torch.autograd.grad(y_old, want, ct.to(dtype))
    for a, e in zip(g_new, g_old):
        torch.testing.assert_close(a, e, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["unet", "vae_encode", "vae_decode"])
def test_chip_smoke_norm_shapes_are_the_modules(kind, monkeypatch):
    """`chip_smoke.norm_calls` (the GroupNorm calls of one pass, worked out
    from the config) lists exactly the calls the modules make."""
    monkeypatch.setenv("FREEFINE_FUSED_GN", "0")
    cfg, mods = tiny_modules(17)
    seen = []

    def hook(mod, args, kwargs):
        x = args[0]
        seen.append((tuple(x.shape[1:]), mod.num_groups, mod.eps,
                     bool(kwargs.get("silu", args[1] if len(args) > 1 else False))))

    model = mods["unet"] if kind == "unet" else mods["vae"]
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in model.modules() if isinstance(m, GroupNorm32)]
    b, lh, lw = 2, cfg.latent_height, cfg.latent_width
    with torch.no_grad():
        if kind == "unet":
            model(torch.zeros(b, 4, lh, lw), 11, torch.zeros(b, 77, cfg.unet.cross_attention_dim))
        elif kind == "vae_encode":
            model.encode(torch.zeros(b, cfg.height, cfg.width, 3))
        else:
            model.decode(torch.zeros(b, lh, lw, 4))
    for hd in handles:
        hd.remove()
    want = [((c, h, w), g, eps, silu) for c, h, w, g, eps, silu in chip_smoke.norm_calls(cfg, kind)]
    assert seen == want
