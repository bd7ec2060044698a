"""The port's DIFT (`freefine_tpu_torch.ops.dift`) against the JAX
package's (`freefine_tpu.ops.dift`) on `tiny_pipeline_config` with the same
weights (carried through `freefine_tpu.weights.convert_*`):
`make_sd_featurizer` end to end (VAE encode, the ensemble of 8 noised
latents at t 261, one batched UNet pass through the feature taps, up block
1 averaged, resized to the image) with JAX's own ensemble noise
(`jax.random.normal` of the featurizer's key) replayed; `upsample_features`
growing and shrinking; `match_points` (equal, ties included: the first
maximum wins, as `jnp.argmax`).

Tolerance: features within 2e-4 of max |ref| (float32 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freefine_tpu.config import tiny_pipeline_config as jax_tiny_config
from freefine_tpu.ops import dift as JD
from freefine_tpu.pipeline import FreeFine as JFreeFine
from freefine_tpu_torch.ops import dift as D
from freefine_tpu_torch.pipeline import FreeFine
from test_torch_raft import assert_close
from test_torch_weights import jax_params, tiny_modules

torch.set_num_threads(2)

TOL = 2e-4
ENSEMBLE, SEED = 8, 3


@pytest.fixture(scope="module")
def pipes():
    cfg, mods = tiny_modules(45)
    jcfg = jax_tiny_config()
    jpipe = JFreeFine(config=jcfg, params={k: jax_params(m, k, jcfg) for k, m in mods.items()})
    tpipe = FreeFine(cfg, params={k: m.state_dict() for k, m in mods.items()}, device="cpu")
    return cfg, jpipe, tpipe


def test_featurizer_matches_jax(pipes):
    cfg, jpipe, tpipe = pipes
    img = np.random.default_rng(0).integers(0, 255, (cfg.height, cfg.width, 3), dtype=np.uint8)
    want = JD.make_sd_featurizer(jpipe, ensemble_size=ENSEMBLE, seed=SEED)(img, "a cat")
    noise = np.asarray(jax.random.normal(
        jax.random.key(SEED), (ENSEMBLE, cfg.latent_height, cfg.latent_width, 4), jnp.float32))
    got = D.make_sd_featurizer(tpipe, ensemble_size=ENSEMBLE, noise=torch.from_numpy(
        noise.copy()))(img, "a cat")
    assert got.shape == want.shape and got.shape[:2] == (cfg.height, cfg.width)
    assert np.asarray(want).std() > 1e-4
    assert_close(got, want, TOL)


def test_featurizer_noise_is_seeded_and_fixed(pipes):
    cfg, _, tpipe = pipes
    img = np.random.default_rng(1).integers(0, 255, (cfg.height, cfg.width, 3), dtype=np.uint8)
    feat = D.make_sd_featurizer(tpipe, ensemble_size=2, seed=SEED)
    a, b = feat(img, "a cat"), feat(img, "a cat")
    c = D.make_sd_featurizer(tpipe, ensemble_size=2, seed=SEED + 1)(img, "a cat")
    assert np.array_equal(a, b) and not np.array_equal(a, c)


@pytest.mark.parametrize("hw,to", [((8, 8), (64, 64)), ((16, 12), (20, 7))])
def test_upsample_features_matches_jax(hw, to):
    f = np.random.default_rng(2).standard_normal((*hw, 5)).astype(np.float32)
    want = JD.upsample_features(jnp.asarray(f), to)
    assert_close(D.upsample_features(torch.from_numpy(f), to), want, TOL)


def test_match_points_matches_jax_ties_included():
    rng = np.random.default_rng(3)
    src = rng.standard_normal((6, 7, 4)).astype(np.float32)
    tgt = rng.standard_normal((6, 7, 4)).astype(np.float32)
    # ties: two target pixels share the best direction of point 0 (the
    # first in row-major order must win), and a scaled copy ties on cosine
    tgt[1, 2] = src[2, 3]
    tgt[4, 5] = src[2, 3]
    tgt[5, 0] = 3.0 * src[0, 1]
    tgt[0, 6] = 3.0 * src[0, 1]
    points = np.array([[2, 3], [0, 1], [5, 6], [3, 3]], np.int32)
    want = np.asarray(JD.match_points(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(points)))
    got = D.match_points(torch.from_numpy(src), torch.from_numpy(tgt),
                         torch.from_numpy(points).long()).numpy()
    assert np.array_equal(got, want)
    assert got[0].tolist() == [1, 2] and got[1].tolist() == [0, 6]
