"""Distribution-distance math of the FID-family metrics (mirrors
`freefine_tpu.metrics.common`): float64 numpy and `scipy.linalg.sqrtm`,
host work as in the JAX package.

The math of:
  * Fréchet distance (reference evaluation/metrics/FID/fid_score.py —
    pytorch-fid's calculate_frechet_distance, incl. the eps-on-singular
    fallback and imaginary-part check);
  * polynomial-kernel MMD, degree 3 (reference evaluation/metrics/FID/
    mmd.py:5-55, used by FID_KD).

Feature extraction plugs in separately (`metrics.fid`, `metrics.consistency`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] activations -> (mean [D], covariance [D, D])."""
    feats = np.asarray(features, np.float64)
    mu = feats.mean(0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # the JAX package passes disp=False, which newer scipy no longer takes;
    # the square root is the same either way (disp only chooses between a
    # warning and a returned error estimate)
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm(
            (sigma1 + offset).dot(sigma2 + offset)
        )
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def polynomial_kernel(
    x: np.ndarray, y: np.ndarray, degree: int = 3, gamma=None, coef0: float = 1.0
) -> np.ndarray:
    """(gamma <x, y> + coef0)^degree with gamma default 1/D
    (reference mmd.py polynomial_kernel)."""
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * x.dot(y.T) + coef0) ** degree


def polynomial_mmd(
    feats1: np.ndarray, feats2: np.ndarray, degree: int = 3, gamma=None,
    coef0: float = 1.0,
) -> float:
    """MMD^2 with a polynomial kernel: unbiased XX/YY terms, biased XY
    (exactly the reference's _mmd2_and_variance, mmd.py:34-55)."""
    x = np.asarray(feats1, np.float64)
    y = np.asarray(feats2, np.float64)
    kxx = polynomial_kernel(x, x, degree, gamma, coef0)
    kyy = polynomial_kernel(y, y, degree, gamma, coef0)
    kxy = polynomial_kernel(x, y, degree, gamma, coef0)
    m, n = kxx.shape[0], kyy.shape[0]
    np.fill_diagonal(kxx, 0)
    np.fill_diagonal(kyy, 0)
    return float(
        kxx.sum() / (m * (m - 1))
        + kyy.sum() / (n * (n - 1))
        - 2 * kxy.sum() / (m * n)
    )


def compute_mmd_subsets(
    feats1: np.ndarray,
    feats2: np.ndarray,
    n_subsets: int = 100,
    subset_size: int = 1000,
    seed: int = 0,
    **kernel_args,
) -> float:
    """Subset-averaged MMD (reference compute_mmd, mmd.py:5-18) — mean of
    `n_subsets` MMD^2 values over random equal-size subsets.  The reference
    uses the global numpy RNG; we take an explicit seed for reproducibility.
    """
    m = min(feats1.shape[0], feats2.shape[0])
    subset_size = min(subset_size, m)
    rng = np.random.default_rng(seed)
    vals = []
    for _ in range(n_subsets):
        a = feats1[rng.choice(len(feats1), subset_size, replace=False)]
        b = feats2[rng.choice(len(feats2), subset_size, replace=False)]
        vals.append(polynomial_mmd(a, b, **kernel_args))
    return float(np.mean(vals))


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray) -> float:
    m1, s1 = gaussian_stats(feats1)
    m2, s2 = gaussian_stats(feats2)
    return frechet_distance(m1, s1, m2, s2)
