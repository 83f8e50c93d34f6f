"""The port's rotated-box IoU and NMS (mobi_tpu_torch.ops.box3d) on the CPU:
the JAX package's cases (analytic overlaps, disjoint boxes, containment, a
Monte-Carlo rasterisation oracle, the z overlap, NMS's greedy order), and
`iou_bev`, `iou_3d` and `nms_3d` against mobi_tpu.ops.box3d on random boxes
(IoU within 1e-5 absolute, the keep masks equal)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.ops import box3d as JB
from mobi_tpu_torch.ops.box3d import box_corners_bev, iou_3d, iou_bev, nms_3d


def B(x, y, z, dx, dy, dz, yaw):
    return np.array([x, y, z, dx, dy, dz, yaw], np.float32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def mc_iou_bev(a, b, n=400):
    """Monte-Carlo grid oracle: the share of the union both boxes cover."""
    lo = np.minimum(a[:2] - max(a[3], a[4]), b[:2] - max(b[3], b[4]))
    hi = np.maximum(a[:2] + max(a[3], a[4]), b[:2] + max(b[3], b[4]))
    xs, ys = np.linspace(lo[0], hi[0], n), np.linspace(lo[1], hi[1], n)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], -1)

    def inside(box):
        c, s = np.cos(box[6]), np.sin(box[6])
        rel = pts - box[:2]
        return (np.abs(rel[:, 0] * c + rel[:, 1] * s) <= box[3] / 2) & (np.abs(-rel[:, 0] * s + rel[:, 1] * c) <= box[4] / 2)

    inter = (inside(a) & inside(b)).sum() * (xs[1] - xs[0]) * (ys[1] - ys[0])
    return inter / (a[3] * a[4] + b[3] * b[4] - inter)


def test_corners_shape_and_area():
    c = box_corners_bev(T(B(1, 2, 0, 4, 2, 1.5, 0.3)[None]))[0].numpy()
    assert c.shape == (4, 2)
    area = 0.5 * abs(sum(c[i, 0] * c[(i + 1) % 4, 1] - c[i, 1] * c[(i + 1) % 4, 0] for i in range(4)))
    np.testing.assert_allclose(area, 8.0, rtol=1e-5)


@pytest.mark.parametrize("case", ["identical", "axis_aligned", "octagon", "disjoint", "containment"])
def test_analytic_overlaps(case):
    a, b, want, atol = {
        "identical": (B(0, 0, 0, 4, 2, 1.5, 0.7), B(0, 0, 0, 4, 2, 1.5, 0.7), 1.0, 1e-5),
        "axis_aligned": (B(0, 0, 0, 2, 2, 2, 0), B(1, 0, 0, 2, 2, 2, 0), 2 / 6, 1e-5),
        # the unit square against itself turned 45 degrees: a regular octagon
        "octagon": (B(0, 0, 0, 1, 1, 1, 0), B(0, 0, 0, 1, 1, 1, np.pi / 4),
                    2 * (np.sqrt(2) - 1) / (2 - 2 * (np.sqrt(2) - 1)), 1e-5),
        "disjoint": (B(0, 0, 0, 2, 2, 2, 0.5), B(10, 10, 0, 2, 2, 2, 1.0), 0.0, 0.0),
        "containment": (B(0, 0, 0, 4, 4, 2, 0.3), B(0, 0, 0, 2, 2, 2, 1.2), 4 / 16, 1e-4),
    }[case]
    got = float(iou_bev(T(a[None]), T(b[None]))[0, 0])
    np.testing.assert_allclose(got, want, atol=atol)
    if case == "identical":
        np.testing.assert_allclose(float(iou_3d(T(a[None]), T(b[None]))[0, 0]), 1.0, atol=1e-5)
    if case == "disjoint":
        assert got == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_pairs_vs_monte_carlo(seed):
    rng = np.random.default_rng(seed)

    def draw():
        return B(*rng.uniform(-2, 2, 2), 0, *rng.uniform(1, 4, 2), 2, rng.uniform(0, np.pi))

    A = np.stack([draw() for _ in range(6)])
    Bx = np.stack([draw() for _ in range(6)])
    got = iou_bev(T(A), T(Bx)).numpy()
    for i in range(len(A)):
        for j in range(len(Bx)):
            np.testing.assert_allclose(got[i, j], mc_iou_bev(A[i], Bx[j]), atol=0.02, err_msg=f"pair {i},{j}")


def test_iou3d_z_overlap():
    a = B(0, 0, 0, 2, 2, 2, 0)
    np.testing.assert_allclose(float(iou_3d(T(a[None]), T(B(0, 0, 1, 2, 2, 2, 0)[None]))[0, 0]), 4.0 / 12.0,
                               atol=1e-5)
    assert float(iou_3d(T(a[None]), T(B(0, 0, 5, 2, 2, 2, 0)[None]))[0, 0]) == 0.0


def test_nms_greedy_semantics():
    boxes = np.stack([B(0, 0, 0, 4, 2, 1.5, 0.0), B(0.2, 0, 0, 4, 2, 1.5, 0.05), B(10, 0, 0, 4, 2, 1.5, 0.0),
                      B(0.1, 0.1, 0, 4, 2, 1.5, 0.0)])
    keep = nms_3d(T(boxes), T([0.9, 0.8, 0.7, 0.6]), iou_threshold=0.5).numpy()
    np.testing.assert_array_equal(keep, [True, False, True, False])


def test_nms_keeps_highest_score_regardless_of_order():
    rng = np.random.default_rng(4)
    base = B(0, 0, 0, 4, 2, 1.5, 0.2)
    boxes = np.stack([base + np.concatenate([rng.normal(0, 0.05, 2), np.zeros(5)]) for _ in range(8)])
    scores = rng.uniform(0, 1, 8).astype(np.float32)
    keep = nms_3d(T(boxes), T(scores), 0.5).numpy()
    assert keep.sum() == 1 and keep[int(np.argmax(scores))]


def random_boxes(rng, n, spread=3.0):
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
                           rng.uniform(0.5, 4, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_iou_equal_jax_on_random_boxes(seed):
    """[40, 24] pairs, boxes dense enough that most pairs overlap."""
    rng = np.random.default_rng(seed)
    a, b = random_boxes(rng, 40), random_boxes(rng, 24)
    for fn, jfn in ((iou_bev, JB.iou_bev), (iou_3d, JB.iou_3d)):
        got = fn(T(a), T(b)).numpy()
        want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == want.shape and (want > 0).mean() > 0.2
        assert np.abs(got - want).max() < 1e-5


@pytest.mark.parametrize("bev", [True, False])
def test_nms_equal_jax_on_random_boxes(bev):
    rng = np.random.default_rng(3)
    boxes = random_boxes(rng, 60, spread=6.0)
    scores = rng.uniform(0, 1, 60).astype(np.float32)
    scores[10:20] = scores[0]  # ties go by index on both sides
    got = nms_3d(T(boxes), T(scores), 0.3, bev=bev).numpy()
    want = np.asarray(JB.nms_3d(jnp.asarray(boxes), jnp.asarray(scores), 0.3, bev=bev))
    assert 0 < got.sum() < len(got) and np.array_equal(got, want)
