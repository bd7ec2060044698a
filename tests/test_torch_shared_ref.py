"""The shared-reference lanes of the port against the JAX package, on
`tiny_pipeline_config` with the same weights (carried through
`freefine_tpu.weights.convert_*`) and JAX's own per-case draws (each case's
`split` -> `normal` chain, 2-row [case, ref] draws):

  * the capture pass's K/V at each TCA-gated block against JAX's
    `_extract_ref_kv` of a `store_kv` pass (relative 1e-4: max |diff| over
    max |ref|, float32);
  * `_tca_edit` / `_tca_bggen` with the shared layout and with
    `ref_vanilla`, two cases with different masks, and the local-CFG
    cross-attention's 2-stream layout, against JAX's functions case by
    case (relative 1e-4);
  * `sample_edit_loop_shared` (tca, mmsa) and `sample_bggen_loop_shared`
    against JAX's loops (final latents 2e-3 absolute, as the other
    whole-path tests), and against the port's own per-case loop run with
    ref_vanilla=True (1e-3, JAX's bound in tests/test_shared_ref.py).

The shared-source entry points are in tests/test_torch_shared_source.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu import pipeline as JP
from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.edit import EditConfig as JEditConfig
from freefine_tpu.edit import EditState as JEditState
from freefine_tpu.edit import none_config as j_none_config
from freefine_tpu.ops import attention as JA
from freefine_tpu_torch import pipeline as P
from freefine_tpu_torch.edit import EditConfig, EditState, build_mask_pyramid
from freefine_tpu_torch.ops import attention as A
from test_torch_bggen import jax_noise
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

SEQ, HEADS, DIM = 64, 4, 16
CASES = 2
REL = 1e-4
NUM_STEP, START = 6, 3
K = NUM_STEP - START
LOOP_KW = dict(start_step=START, guidance_scale=7.5, eta=1.0, local_text_edit=True,
               local_perturbation=True)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(61)
    jcfg = jax_tiny_config()
    jpipe = JP.FreeFine(config=jcfg,
                        params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = P.FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


# ---------------------------------------------------------------------------
# The capture pass and the attention
# ---------------------------------------------------------------------------


def test_capture_pass_matches_jax_extract_ref_kv(pipes):
    cfg, jpipe, tpipe = pipes
    lh, lw = cfg.latent_height, cfg.latent_width
    rng = np.random.default_rng(1)
    lat = rng.normal(size=(1, lh, lw, 4)).astype(np.float32)
    ctx = rng.normal(size=(1, 77, cfg.unet.cross_attention_dim)).astype(np.float32)
    ecfg = EditConfig(mode="edit", method="tca", shared_ref=True, ref_vanilla=True,
                      layer_range=tpipe._layer_range)
    jcap = dataclasses.replace(j_none_config(), store_kv=True,
                               layer_range=tuple(tpipe._layer_range))
    want = jax.jit(jpipe._make_unet_capture(jcap))(jpipe.params, jnp.asarray(lat),
                                                   jnp.int32(501), jnp.asarray(ctx))
    got = tpipe.make_unet_capture(ecfg)(torch.from_numpy(lat), 501, torch.from_numpy(ctx))
    lo, hi = tpipe._layer_range
    assert sorted(got) == sorted(want) == list(range(lo, hi))
    for block, (k, v) in got.items():
        assert k.shape == want[block][0].shape and k.ndim == 2
        _close(k.numpy(), want[block][0])
        _close(v.numpy(), want[block][1])


def _case_masks(rng):
    return [(rng.random(SEQ) > 0.5 + 0.2 * c).astype(np.float32) for c in range(CASES)]


def _states(fg, tgt, cg, ref_kv=None):
    """JAX states per case and the port's case-stacked state."""
    js = [JEditState(fg_retain={SEQ: jnp.asarray(t)}, fg_ref={SEQ: jnp.asarray(f)},
                     local_region={SEQ: jnp.asarray(t)}, context_guidance=jnp.float32(cg),
                     ref_kv=None if ref_kv is None else {
                         b: tuple(jnp.asarray(x) for x in kv) for b, kv in ref_kv.items()})
          for f, t in zip(fg, tgt)]
    ts = EditState(fg_retain={SEQ: torch.from_numpy(np.stack(tgt))},
                   fg_ref={SEQ: torch.from_numpy(np.stack(fg))},
                   local_region={SEQ: torch.from_numpy(np.stack(tgt))}, context_guidance=cg,
                   ref_kv=None if ref_kv is None else {
                       b: tuple(torch.from_numpy(x) for x in kv) for b, kv in ref_kv.items()})
    return js, ts


@pytest.mark.parametrize("layout", ["shared_ref", "ref_vanilla"])
@pytest.mark.parametrize("mode,method", [("edit", "tca"), ("edit", "mmsa"), ("bggen", "tca")])
def test_tca_with_shared_ref_and_ref_vanilla_matches_jax(layout, mode, method, monkeypatch):
    """Two cases with different masks in one call against JAX's function
    case by case (its `jax.vmap` over cases)."""
    monkeypatch.setattr(JA, "FLASH_MODE", "0")
    rng = np.random.default_rng(2)
    streams = 2 if layout == "shared_ref" else 3
    q, k, v = (rng.normal(size=(CASES * streams, SEQ, HEADS * DIM)).astype(np.float32)
               for _ in range(3))
    block = 12
    ref_kv = None
    if layout == "shared_ref":
        ref_kv = {block: tuple(rng.normal(size=(SEQ, HEADS * DIM)).astype(np.float32)
                               for _ in range(2))}
    flags = dict(shared_ref=layout == "shared_ref", ref_vanilla=True)
    js, ts = _states(_case_masks(rng), _case_masks(rng), 0.6, ref_kv)
    jfn = JA._tca_edit if mode == "edit" else JA._tca_bggen
    tfn = A._tca_edit if mode == "edit" else A._tca_bggen
    jcfg = JEditConfig(mode=mode, method=method, **flags)
    want = np.concatenate([
        np.asarray(jfn(*(jnp.asarray(x[c * streams : (c + 1) * streams]) for x in (q, k, v)),
                       HEADS, jcfg, js[c], block)) for c in range(CASES)])
    got = tfn(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
              EditConfig(mode=mode, method=method, **flags), ts, block)
    assert got.shape == want.shape
    _close(got.numpy(), want)


def test_shared_ref_without_captured_kv_raises():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(2, SEQ, HEADS * DIM)).astype(np.float32))
    _, ts = _states(_case_masks(rng)[:1], _case_masks(rng)[:1], 0.5, ref_kv={})
    with pytest.raises(ValueError, match="ref_kv"):
        A._tca_edit(q, q, q, HEADS, EditConfig(mode="edit", method="tca", shared_ref=True), ts,
                    12)


def test_parity_rows_and_gather_per_case_match_jax():
    rng = np.random.default_rng(4)
    masks = np.stack(_case_masks(rng))
    for edit_only in (False, True):
        want = [np.asarray(JA._parity_rows(jnp.asarray(m), 3, edit_only)) for m in masks]
        got = A._parity_rows(torch.from_numpy(masks), CASES * 3, edit_only).numpy()
        np.testing.assert_array_equal(got[: CASES * 3], np.concatenate([w[:3] for w in want]))
        np.testing.assert_array_equal(got[CASES * 3 :], np.concatenate([w[3:] for w in want]))
    x = rng.normal(size=(CASES * 3, 5, 8)).astype(np.float32)
    want = np.concatenate([np.asarray(JA._ref_stream_gather(jnp.asarray(x[3 * c : 3 * c + 3])))
                           for c in range(CASES)])
    np.testing.assert_array_equal(A._ref_stream_gather(torch.from_numpy(x), CASES).numpy(), want)
    single = rng.normal(size=(1, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(A._ref_stream_gather(torch.from_numpy(single)).numpy(), single)


@pytest.mark.parametrize("shared", [True, False])
def test_local_cfg_cross_attention_per_case_matches_jax(shared):
    """The 2-stream shared layout [u_e, c_e] and the 3-stream layout, two
    cases with their own local regions."""
    rng = np.random.default_rng(5)
    streams = 2 if shared else 3
    q = rng.normal(size=(CASES * streams, SEQ, HEADS * DIM)).astype(np.float32)
    k, v = (rng.normal(size=(CASES * streams, 77, HEADS * DIM)).astype(np.float32)
            for _ in range(2))
    js, ts = _states(_case_masks(rng), _case_masks(rng), 0.5)
    flags = dict(shared_ref=shared, ref_vanilla=shared)
    want = np.concatenate([
        np.asarray(JA.edit_cross_attention(
            *(jnp.asarray(x[c * streams : (c + 1) * streams]) for x in (q, k, v)), HEADS,
            JEditConfig(mode="edit", method="tca", **flags), js[c])) for c in range(CASES)])
    got = A.edit_cross_attention(*(torch.from_numpy(x) for x in (q, k, v)), HEADS,
                                 EditConfig(mode="edit", method="tca", **flags), ts)
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# The shared loops
# ---------------------------------------------------------------------------


def _loop_inputs(cfg, seed=6):
    lh = cfg.latent_height
    rng = np.random.default_rng(seed)
    d = cfg.unet.cross_attention_dim
    masks = []
    for c in range(CASES):
        m = np.zeros((lh, lh), np.float32)
        m[1 + 2 * c : 4 + 2 * c, 1 + c : 5 + c] = 1.0
        masks.append(m)
    return dict(
        uncond=rng.normal(size=(77, d)).astype(np.float32),
        conds=rng.normal(size=(CASES, 77, d)).astype(np.float32),
        ref_traj=(rng.normal(size=(K + 1, lh, lh, 4)) * 0.3).astype(np.float32),
        coarse=(rng.normal(size=(K + 1, CASES, lh, lh, 4)) * 0.3).astype(np.float32),
        masks=np.stack(masks), cg=np.linspace(1.0, 0.3, K).astype(np.float32),
        gates=np.ones(K, np.float32), seeds=[15, 16])


def _torch_states(masks, lh):
    """Per-case pyramids of latent-resolution masks, stacked."""
    pyrs = [build_mask_pyramid(torch.from_numpy(m), lh, lh) for m in masks]
    return P._stack_states([EditState(fg_retain=p, fg_ref=p, local_region=p) for p in pyrs])


def _jax_states(masks, lh):
    from freefine_tpu.edit import build_mask_pyramid as j_build_mask_pyramid

    pyrs = [j_build_mask_pyramid(jnp.asarray(m), lh, lh) for m in masks]
    return JP._stack_states([JEditState(fg_retain=p, fg_ref=p, local_region=p) for p in pyrs])


def _run_shared(tpipe, x, mode, method, ref_vanilla_cases=False):
    """The port's shared loop, or (ref_vanilla_cases) its per-case loop
    with ref_vanilla=True on the same inputs."""
    lh = tpipe.config.latent_height
    t = torch.from_numpy
    noise = [jax_noise(s, K, (2, lh, lh, 4)) for s in x["seeds"]]
    masks = t(x["masks"])
    sched = tpipe._schedule(NUM_STEP)
    uncond = t(x["uncond"])
    if ref_vanilla_cases:
        ecfg = EditConfig(mode=mode, method=method, ref_vanilla=True,
                          layer_range=tpipe._layer_range)
        text3 = torch.stack([uncond[None].expand(CASES, -1, -1)] * 2 + [t(x["conds"])], dim=1)
        if mode == "edit":
            traj = torch.stack([t(x["coarse"]), t(x["ref_traj"])[:, None].expand(
                -1, CASES, -1, -1, -1)], dim=2)
            return P.sample_edit_cases(tpipe.unet_apply, sched, ecfg, traj, text3,
                                       _torch_states(x["masks"], lh), x["cg"], x["gates"], masks,
                                       masks, noise, **LOOP_KW)[:, 0]
        traj = t(x["ref_traj"])[:, None, None].expand(-1, CASES, 1, -1, -1, -1)
        return P.sample_bggen_cases(tpipe.unet_apply, sched, ecfg, traj, text3,
                                    _torch_states(x["masks"], lh), x["cg"], x["gates"], masks,
                                    masks, noise, **LOOP_KW)[:, 0]
    ecfg = EditConfig(mode=mode, method=method, shared_ref=True, ref_vanilla=True,
                      layer_range=tpipe._layer_range)
    capture = tpipe.make_unet_capture(ecfg)
    text_pair = torch.stack([uncond[None].expand(CASES, -1, -1), t(x["conds"])], dim=1)
    states = _torch_states(x["masks"], lh)
    if mode == "edit":
        return P.sample_edit_loop_shared(tpipe.unet_apply, capture, sched, ecfg,
                                         t(x["ref_traj"]), t(x["coarse"][-1]), text_pair,
                                         uncond[None], states, x["cg"], x["gates"], masks,
                                         masks, noise, **LOOP_KW)
    return P.sample_bggen_loop_shared(tpipe.unet_apply, capture, sched, ecfg, t(x["ref_traj"]),
                                      text_pair, uncond[None], states, x["cg"], x["gates"],
                                      masks, masks, noise, **LOOP_KW)


def _run_jax_shared(jpipe, x, mode, method, lh):
    ecfg = JEditConfig(mode=mode, method=method, shared_ref=True, ref_vanilla=True,
                       layer_range=(10, 16))
    cap = dataclasses.replace(j_none_config(), store_kv=True, layer_range=(10, 16))
    u = jnp.asarray(x["uncond"])
    text_pair = jnp.stack([jnp.broadcast_to(u, (CASES,) + u.shape), jnp.asarray(x["conds"])],
                          axis=1)
    args = dict(states=_jax_states(x["masks"], lh), cg=jnp.asarray(x["cg"]),
                gates=jnp.asarray(x["gates"]))
    masks = jnp.asarray(x["masks"])
    keys = jnp.stack([jax.random.key(s) for s in x["seeds"]])
    sched = jpipe._schedule(NUM_STEP)
    fns = (jpipe._make_unet_apply(ecfg), jpipe._make_unet_capture(cap), jpipe.params, sched,
           ecfg)
    if mode == "edit":
        out = JP.sample_edit_loop_shared(*fns, jnp.asarray(x["ref_traj"]),
                                         jnp.asarray(x["coarse"][-1]), text_pair, u[None],
                                         args["states"], args["cg"], args["gates"], masks, masks,
                                         keys, **LOOP_KW)
    else:
        out = JP.sample_bggen_loop_shared(*fns, jnp.asarray(x["ref_traj"]), text_pair, u[None],
                                          args["states"], args["cg"], args["gates"], masks,
                                          masks, keys, **LOOP_KW)
    return np.asarray(out)


@pytest.mark.parametrize("mode,method", [("edit", "tca"), ("edit", "mmsa"), ("bggen", "tca")])
def test_shared_loops_match_jax_and_the_per_case_loop(pipes, mode, method):
    cfg, jpipe, tpipe = pipes
    x = _loop_inputs(cfg)
    got = _run_shared(tpipe, x, mode, method)
    want = _run_jax_shared(jpipe, x, mode, method, cfg.latent_height)
    assert got.shape == want.shape == (CASES, cfg.latent_height, cfg.latent_width, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=0)
    per_case = _run_shared(tpipe, x, mode, method, ref_vanilla_cases=True)
    np.testing.assert_allclose(got.numpy(), per_case.numpy(), atol=1e-3, rtol=0)
    assert not torch.equal(got[0], got[1])
