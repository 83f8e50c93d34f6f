"""The port's point ops (mobi_tpu_torch/ops/point_ops.py) against the JAX
package's (mobi_tpu/ops/point_ops.py) on the CPU, at seeded shapes.

Tolerances: the gathers bitwise; the contractions (three_interpolate, the
three aggregates of assign_score_withk) within 1e-6 absolute and relative,
fp32 sums in another order. three_interpolate is fed from the port's host
`native.three_nn`, as PointNet++'s feature propagation feeds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.ops import point_ops as jpo
from mobi_tpu_torch import native
from mobi_tpu_torch.ops import point_ops as tpo

ATOL = RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", [(2, 50, 7, 13), (1, 1, 1, 1), (3, 200, 64, 32)])
def test_gathers_bitwise(shape):
    b, n, c, s = shape
    rng = np.random.default_rng(n + c)
    feats = rng.standard_normal((b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, s)).astype(np.int32)
    want = np.asarray(jpo.gather_points(jnp.asarray(feats), jnp.asarray(idx)))
    got = tpo.gather_points(_t(feats), _t(idx)).numpy()
    assert got.shape == (b, s, c) and np.array_equal(got, want)
    gidx = rng.integers(0, n, (b, s, 5)).astype(np.int32)
    want = np.asarray(jpo.group_points(jnp.asarray(feats), jnp.asarray(gidx)))
    got = tpo.group_points(_t(feats), _t(gidx)).numpy()
    assert got.shape == (b, s, 5, c) and np.array_equal(got, want)


def test_three_interpolate_from_three_nn():
    rng = np.random.default_rng(3)
    b, m, n, c = 2, 64, 300, 16
    known = rng.uniform(-5, 5, (b, m, 3)).astype(np.float32)
    unknown = rng.uniform(-5, 5, (b, n, 3)).astype(np.float32)
    feats = rng.standard_normal((b, m, c)).astype(np.float32)
    idx, weight = [], []
    for i in range(b):
        d2, ix = native.three_nn(unknown[i], known[i])
        w = 1.0 / (d2 + 1e-8)
        idx.append(ix)
        weight.append((w / w.sum(axis=1, keepdims=True)).astype(np.float32))
    idx, weight = np.stack(idx), np.stack(weight)
    want = np.asarray(jpo.three_interpolate(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(weight)))
    got = tpo.three_interpolate(_t(feats), _t(idx), _t(weight)).numpy()
    assert got.shape == (b, n, c)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # the host's own interpolation of the same neighbours
    host = native.three_interpolate(feats[0], idx[0], native.three_nn(unknown[0], known[0])[0])
    np.testing.assert_allclose(got[0], host, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("aggregate", ["sum", "avg", "max"])
def test_assign_score_withk(aggregate):
    """PAConv's shapes: 4 weight banks (M), 32 output channels (D), K = 16."""
    rng = np.random.default_rng({"sum": 0, "avg": 1, "max": 2}[aggregate])
    b, n, npoint, k, m, d = 2, 128, 64, 16, 4, 32
    scores = rng.standard_normal((b, npoint, k, m)).astype(np.float32)
    point = rng.standard_normal((b, n, m, d)).astype(np.float32)
    center = rng.standard_normal((b, n, m, d)).astype(np.float32)
    knn = rng.integers(0, n, (b, npoint, k)).astype(np.int32)
    want = np.asarray(jpo.assign_score_withk(jnp.asarray(scores), jnp.asarray(point), jnp.asarray(center),
                                             jnp.asarray(knn), aggregate))
    got = tpo.assign_score_withk(_t(scores), _t(point), _t(center), _t(knn), aggregate).numpy()
    assert got.shape == (b, d, npoint, k)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_assign_score_unknown_aggregate_raises_as_jax():
    args = (np.zeros((1, 2, 3, 4), np.float32), np.zeros((1, 5, 4, 2), np.float32),
            np.zeros((1, 5, 4, 2), np.float32), np.zeros((1, 2, 3), np.int32))
    with pytest.raises(ValueError, match="unknown aggregate: median"):
        jpo.assign_score_withk(*map(jnp.asarray, args), aggregate="median")
    with pytest.raises(ValueError, match="unknown aggregate: median"):
        tpo.assign_score_withk(*map(_t, args), aggregate="median")
