"""Range-view value normalizations, depth and intensity (mobi_tpu
ops/ranges.py), for numpy arrays and torch tensors alike.

The object-adaptive piecewise depth stretch and the log intensity
normalization; each is written with the functions numpy and torch share.
"""
from __future__ import annotations

import numpy as np
import torch


def _where(c, a, b):
    return torch.where(c, a, b) if isinstance(c, torch.Tensor) else np.where(c, a, b)


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(x)


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi) if isinstance(x, torch.Tensor) else np.clip(x, lo, hi)


def depth_normalization(depth, min_d, max_d, alpha: float = 0.75):
    """Piecewise-linear stretch: [min_d, max_d] -> [-alpha, alpha]; [-1,
    min_d) -> [-1, -alpha), (max_d, 1] -> (alpha, 1]. min_d and max_d may be
    scalars or broadcastable arrays (per-object depth windows)."""
    mid = -alpha + 2 * alpha * (depth - min_d) / (max_d - min_d)
    low = -1 + -(alpha - 1) * (depth + 1) / (min_d + 1)
    high = alpha + (1 - alpha) * (depth - max_d) / (1 - max_d)
    return _where(depth < min_d, low, _where(depth > max_d, high, mid))


def inverse_depth_normalization(norm, min_d, max_d, alpha: float = 0.75):
    """Inverse of `depth_normalization`."""
    mid = min_d + (norm + alpha) * (max_d - min_d) / (2 * alpha)
    low = -1 + -(norm + 1) * (min_d + 1) / (alpha - 1)
    high = max_d + (norm - alpha) * (1 - max_d) / (1 - alpha)
    return _where(norm < -alpha, low, _where(norm > alpha, high, mid))


def intensity_normalization(x):
    """Intensity in [-1, 1] -> log-stretched [-1, 1]: 1 - 2 exp(-2 (x + 1))."""
    return 1.0 - 2.0 * _exp(-2.0 * (x + 1.0))


def inverse_intensity_normalization(y):
    """clip(-0.5 log(1 - (y + 1) / 2) - 1, -1, 1), the argument floored at
    1e-12."""
    arg = _clip(1.0 - (y + 1.0) / 2.0, 1e-12, None)
    return _clip(-0.5 * _log(arg) - 1.0, -1.0, 1.0)
