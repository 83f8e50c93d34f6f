"""The port's camera + lidar detector (mobi_tpu_torch.models.swin, the
camera branch of models.bevfusion, convert.bevfusion_state_dict) against the
JAX package's on the CPU: the cases of tests/test_torch_detector.py on the
camera + lidar detector (2 views at 64 x 176, the JAX tests' tiny LSS grid),
and the camera path's ops (the splat, cv2's float resize of the views, the
BEV resize), in a file of their own so that each file stays within its time
under `--dist loadfile`. Tolerances as there: each block and the whole
detector within 1e-4 relative L2 of JAX in fp32 before decoding, decoded
boxes as sets within 1e-4, the conversion bitwise; the ops as stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobi_tpu.models import swin as JS
from mobi_tpu.ops import voxel_ops as JV
from mobi_tpu_torch.models import bevfusion as PB
from mobi_tpu_torch.models import swin as PS
from mobi_tpu_torch.ops import voxel_ops as PV
from tests.test_torch_detector import (
    build_case,
    check_blocks_equal_jax,
    check_bevfusion_state_dict_bitwise_equal_export,
    check_parameter_counts_match_jax,
    check_whole_detector_equal_jax,
    nchw,
    rel_l2,
)


@pytest.fixture(scope="module")
def camera_case():
    return build_case(True)


def test_blocks_equal_jax(camera_case):
    check_blocks_equal_jax(camera_case)


def test_whole_detector_equal_jax(camera_case):
    check_whole_detector_equal_jax(camera_case)


def test_parameter_counts_match_jax(camera_case):
    check_parameter_counts_match_jax(camera_case)


def test_bevfusion_state_dict_bitwise_equal_export(camera_case):
    check_bevfusion_state_dict_bitwise_equal_export(camera_case)


def test_voxel_ops_equal_jax():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(500, 7)).astype(np.float32)
    coords = np.stack([rng.integers(-1, 2, 500), rng.integers(0, 3, 500), rng.integers(0, 9, 500),
                       rng.integers(0, 8, 500)], 1).astype(np.int32)
    got = PV.bev_pool(torch.from_numpy(feats), torch.from_numpy(coords), 1, 2, 8, 8)
    want = JV.bev_pool(jnp.asarray(feats), jnp.asarray(coords), 1, 2, 8, 8)
    assert got.shape == want.shape and rel_l2(got, want) < 1e-6
    ids = rng.integers(-1, 40, 500)
    for red in ("mean", "max", "sum"):
        got = PV.dynamic_scatter(torch.from_numpy(feats), torch.from_numpy(ids), 40, red)
        want = JV.dynamic_scatter(jnp.asarray(feats), jnp.asarray(ids), 40, red)
        assert rel_l2(got, want) < 1e-6, red
    pts = rng.uniform(-6, 6, (300, 4)).astype(np.float32)
    vs, cr = (0.5, 0.5, 0.5), (-5, -5, -5, 5, 5, 5)
    assert np.array_equal(PV.dynamic_voxelize(torch.from_numpy(pts), vs, cr, (20, 20, 20)).numpy(),
                          np.asarray(JV.dynamic_voxelize_jax(jnp.asarray(pts), vs, cr, (20, 20, 20))))


# ------------------------------------------------------------ resizes


def test_resize_linear_follows_cv2_float_path():
    """The camera views' resize (image_aug_3d): cv2.resize's INTER_LINEAR on
    float32 [-1, 1] views. cv2 5.0's float arithmetic is followed to 2 ulp,
    not bitwise; its taps and weights exactly (a unit impulse gives cv2's
    weights)."""
    import cv2

    from mobi_tpu_torch.data import imgproc

    rng = np.random.default_rng(0)
    for H, W, h, w in ((225, 400, 396, 704), (900, 1600, 432, 768), (64, 176, 40, 100), (31, 45, 77, 13)):
        x = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
        got, want = imgproc.resize_linear(x, h, w), cv2.resize(x, (w, h))
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert np.abs(got - want).max() <= 2.5e-7
    imp = np.zeros((1, 176), np.float32)
    imp[0, 3] = 1.0
    assert np.abs(imgproc.resize_linear(imp, 1, 100) - cv2.resize(imp, (100, 1))).max() <= 1.2e-7


def test_bev_resize_branch_matches_jax_image_resize():
    """The detector's BEV resize (reached only when the LSS and lidar grids
    differ): half-pixel bilinear, antialiased when it shrinks, as
    jax.image.resize(..., "bilinear")."""
    x = np.random.default_rng(1).normal(size=(1, 18, 18, 5)).astype(np.float32)
    for hw in ((9, 9), (12, 15), (36, 36), (18, 24)):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *hw, 5), method="bilinear"))
        got = PB.resize_bev(torch.from_numpy(nchw(x).copy()), hw).numpy()
        assert rel_l2(got, nchw(want)) < 1e-6, hw
    a = np.random.default_rng(2).normal(size=(1, 4, 5, 3)).astype(np.float32)
    got = PS.resize_bilinear_align_corners(torch.from_numpy(nchw(a).copy()), (8, 11)).numpy()
    assert rel_l2(got, nchw(np.asarray(JS.resize_bilinear_align_corners(jnp.asarray(a), (8, 11))))) < 1e-6
