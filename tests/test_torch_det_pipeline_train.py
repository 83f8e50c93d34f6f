"""The training half of the port's detector host pipeline
(mobi_tpu_torch.data.det_pipeline) and its float warp (data.imgproc) against
the JAX package's and cv2, on the CPU.

Tolerances: under one seed every augmentation's points, boxes, labels,
names and matrices equal JAX's exactly, and so do build_gt_database's files,
GTDatabaseSampler's draws and train_pipeline's outputs on a synthetic raw
tree; views that pass through cv2's float resize or warp within 1e-5 of
JAX's. The warp against cv2 itself (5.0, where the tests run): within 1e-5
max-abs on [0, 1] and [-1, 1] float32 inputs at the sizes and angles of
ImageAug3D's canvas (border 0) and GridMask's mask (border 1.0), and
getRotationMatrix2D bitwise. The training CLI's runs are in
tests/test_torch_det_train_cli.py.
"""
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from mobi_tpu.data import det_pipeline as JP
from mobi_tpu.data.detection_dataset import DetectionSceneDataset as JaxDataset
from mobi_tpu.data.synthetic import build_synthetic_nuscenes_raw
from mobi_tpu_torch import train_detector
from mobi_tpu_torch.data import det_pipeline as PP
from mobi_tpu_torch.data import imgproc
from mobi_tpu_torch.data.detection_dataset import DetectionSceneDataset

torch.set_num_threads(1)

CLASSES = train_detector.NUSC_CLASSES


def scene(seed=0, n=3000, nb=6):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-30, 30, (n, 2)), rng.uniform(-4, 2, (n, 1)), rng.uniform(0, 1, (n, 1)),
                          rng.choice([0.0, 0.05, 0.1], (n, 1))], 1).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-20, 20, (nb, 2)), rng.uniform(-2, 0, (nb, 1)), rng.uniform(0.5, 5, (nb, 3)),
                            rng.uniform(-np.pi, np.pi, (nb, 1)), rng.normal(0, 1, (nb, 2))], 1).astype(np.float32)
    # points inside the boxes, so the per-object transforms move some
    inner = boxes[:, None, :3] + rng.uniform(-0.2, 0.2, (nb, 40, 3))
    extra = np.concatenate([inner.reshape(-1, 3), np.zeros((nb * 40, 2))], 1).astype(np.float32)
    return np.concatenate([pts, extra]), boxes


def equal(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            equal(x, y)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            equal(a[k], b[k])
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_scene_augmentations_equal_jax(seed):
    pts, boxes = scene(seed)
    labels = np.arange(len(boxes)) % 3
    pc = (-25.6, -25.6, -5.0, 25.6, 25.6, 3.2)
    for name, args in (("global_rot_scale_trans", (pts, boxes)), ("random_flip_3d", (pts, boxes)),
                       ("object_noise", (pts, boxes)), ("point_shuffle", (pts,)), ("frame_dropout", (pts,)),
                       ("point_sample", (pts, 500)), ("point_sample", (pts[:100], 500))):
        got = getattr(PP, name)(*args, np.random.default_rng(seed + 10))
        want = getattr(JP, name)(*args, np.random.default_rng(seed + 10))
        equal(got, want)
    equal(PP.random_flip_3d(pts, boxes, np.random.default_rng(0), 1.0, 1.0),
          JP.random_flip_3d(pts, boxes, np.random.default_rng(0), 1.0, 1.0))
    equal(PP.object_range_filter(boxes, labels, pc), JP.object_range_filter(boxes, labels, pc))
    names = ["car", "rock", "pedestrian", "bus", "car", "tree"]
    equal(PP.object_name_filter(boxes, names, CLASSES), JP.object_name_filter(boxes, names, CLASSES))
    equal(PP.background_points_filter(pts, boxes), JP.background_points_filter(pts, boxes))
    equal(PP._bev_collision(boxes[:3], boxes), JP._bev_collision(boxes[:3], boxes))
    equal(PP.box_pad_like(boxes[:, :7], boxes), JP.box_pad_like(boxes[:, :7], boxes))


@pytest.mark.parametrize("max_rotate", [1, 15])
def test_grid_mask_equal_jax(max_rotate):
    """max_rotate 1 is the CLI's; above 1 the mask goes through the float
    warp with border 1.0."""
    images = np.random.default_rng(1).uniform(-1, 1, (2, 64, 176, 3)).astype(np.float32)
    for seed in range(6):
        got = PP.grid_mask(images, np.random.default_rng(seed), prob=0.9, max_rotate=max_rotate)
        want = JP.grid_mask(images, np.random.default_rng(seed), prob=0.9, max_rotate=max_rotate)
        assert got.shape == want.shape and np.abs(got - want).max() < 1e-5


def test_image_aug_3d_training_branch_equal_jax():
    images = np.random.default_rng(2).uniform(-1, 1, (3, 90, 250, 3)).astype(np.float32)
    for seed in range(4):
        kw = dict(final_dim=(64, 176), resize_lim=(0.7, 0.9), bot_pct_lim=(0.0, 0.22), is_train=True)
        got = PP.image_aug_3d(images, np.random.default_rng(seed), **kw)
        want = JP.image_aug_3d(images, np.random.default_rng(seed), **kw)
        equal(got[1], want[1])
        assert np.abs(got[0] - want[0]).max() < 1e-5


@pytest.mark.parametrize("lo", [0.0, -1.0])
def test_float_warp_matches_cv2(lo):
    rng = np.random.default_rng(int(lo) + 5)
    cases = [((256, 704, 3), a, 0.0) for a in (-5.3, -0.7, 2.9, 5.4)]          # ImageAug3D's canvas
    cases += [((64, 176, 3), a, 0.0) for a in (-3.1, 4.4)]
    cases += [((384, 1056), float(a), 1.0) for a in (1, 7, 14)]                # GridMask's 1.5x mask
    cases += [((96, 264), 3.0, 1.0), ((37, 53, 3), -2.2, 0.0)]               # widths off a multiple of 16
    for shape, angle, border in cases:
        img = rng.uniform(lo, 1.0, shape).astype(np.float32)
        h, w = shape[:2]
        M = imgproc.get_rotation_matrix_2d((w / 2, h / 2), angle, 1.0)
        assert np.array_equal(M, cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0))
        got = imgproc.warp_affine_linear(img, M, (w, h), border_value=border)
        want = cv2.warpAffine(img, M, (w, h), borderValue=border)
        assert got.shape == want.shape and np.abs(got - want).max() < 1e-5, (shape, angle)


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("det_train_raw"))
    build_synthetic_nuscenes_raw(root, num_scenes=2, samples_per_scene=2)
    return root


@pytest.fixture(scope="module")
def gt_dbs(raw_tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("gt_db")
    port = PP.build_gt_database(DetectionSceneDataset(raw_tree, load_images=False), str(out / "port"), CLASSES)
    jax_pkl = JP.build_gt_database(JaxDataset(raw_tree, load_images=False), str(out / "jax"), CLASSES)
    return port, jax_pkl


def test_gt_database_equal_jax_file_for_file(gt_dbs):
    port, jax_pkl = gt_dbs
    with open(port, "rb") as f:
        got = pickle.load(f)
    with open(jax_pkl, "rb") as f:
        want = pickle.load(f)
    assert got == want and sum(len(v) for v in got.values()) >= 4
    pdir, jdir = os.path.dirname(port), os.path.dirname(jax_pkl)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        with open(os.path.join(pdir, name), "rb") as a, open(os.path.join(jdir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_gt_sampler_draws_equal_jax(gt_dbs):
    port, jax_pkl = gt_dbs
    groups = {"car": 3, "pedestrian": 4}
    ps, js = PP.GTDatabaseSampler(port, groups), JP.GTDatabaseSampler(jax_pkl, groups)
    for seed in range(3):
        pts, boxes = scene(seed, nb=2)
        boxes[:, :2] += 60  # away from the database's objects, so pastes go through
        labels = np.array([0, 8])
        got, want = ps(pts, boxes, labels, CLASSES), js(pts, boxes, labels, CLASSES)
        equal(got, want)
        assert len(got[1]) > len(boxes)


@pytest.mark.parametrize("with_sampler", [False, True])
def test_train_pipeline_equal_jax(raw_tree, gt_dbs, with_sampler):
    pds, jds = DetectionSceneDataset(raw_tree, load_images=False), JaxDataset(raw_tree, load_images=False)
    groups = train_detector.SAMPLE_GROUPS
    ps = PP.GTDatabaseSampler(gt_dbs[0], groups) if with_sampler else None
    js = JP.GTDatabaseSampler(gt_dbs[1], groups) if with_sampler else None
    prng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    for i in range(len(pds)):
        got = PP.train_pipeline(pds.tables.sample_record(pds._samples[i]), CLASSES, prng, sweeps_num=2, sampler=ps)
        want = JP.train_pipeline(jds.tables.sample_record(jds._samples[i]), CLASSES, jrng, sweeps_num=2, sampler=js)
        equal(got, want)
        assert got["gt_bboxes_3d"].shape[1] == 9 and len(got["points"]) > 1000
