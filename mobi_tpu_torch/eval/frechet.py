"""Frechet distance between Gaussian-fitted feature sets (mobi_tpu
eval/frechet.py), the shared math of FID and FRD: fit (mu, sigma) to two sets
of features and compute ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)).

numpy float64 on the host, the JAX package's arithmetic operation for
operation, so the same features give the same float. The matrix square root
is an eigendecomposition of the symmetrised matrix with negative eigenvalues
clipped, and Tr(sqrt(S1 S2)) is taken as Tr(sqrt(sqrt(S1) S2 sqrt(S1))),
which stays PSD; a non-finite trace is retried with eps on both diagonals.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def fit_gaussian(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] features -> (mu [D], sigma [D, D])."""
    features = np.asarray(features, dtype=np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Principal square root of a (near-)PSD symmetric matrix."""
    sym = (mat + mat.T) / 2
    vals, vecs = np.linalg.eigh(sym)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FD between N(mu1, sigma1) and N(mu2, sigma2)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))

    diff = mu1 - mu2
    s1_half = _sqrtm_psd(sigma1)
    inner = s1_half @ sigma2 @ s1_half
    covmean_tr = np.trace(_sqrtm_psd(inner))

    if not np.isfinite(covmean_tr):
        offset = np.eye(sigma1.shape[0]) * eps
        s1_half = _sqrtm_psd(sigma1 + offset)
        inner = s1_half @ (sigma2 + offset) @ s1_half
        covmean_tr = np.trace(_sqrtm_psd(inner))

    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * covmean_tr)


def frechet_from_features(f1: np.ndarray, f2: np.ndarray) -> float:
    return frechet_distance(*fit_gaussian(f1), *fit_gaussian(f2))
