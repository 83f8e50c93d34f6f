"""The detector's evaluation-time host pipeline (mobi_tpu data/det_pipeline.py,
its eval half; the reference's mmdet3d pipelines: loading.py:84-238
LoadPointsFromMultiSweeps, transforms_3d.py:846-869 PointsRangeFilter,
transforms_3d.py:31-128 ImageAug3D at test time).

Plain numpy dicts with boxes as [N, 7+] arrays in the keyframe lidar frame,
as `DetectionSceneDataset` emits them. The camera views are resized with
`imgproc.resize_linear`, the numpy copy of cv2.resize's INTER_LINEAR on
float32 images. The training augmentations (rotations, flips, the GT
database sampler) are not here.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from mobi_tpu_torch.data import imgproc
from mobi_tpu_torch.data.nuscenes_tables import load_lidar_points


def _remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Drop ego-vehicle returns (loading.py:147-168)."""
    keep = ~((np.abs(points[:, 0]) < radius) & (np.abs(points[:, 1]) < radius))
    return points[keep]


def _with_time_channel(pts: np.ndarray) -> np.ndarray:
    if pts.shape[1] < 5:
        pts = np.concatenate([pts, np.zeros((len(pts), 5 - pts.shape[1]), np.float32)], 1)
    return pts


def load_points_multisweep(
    rec: Dict,
    sweeps_num: int = 9,
    use_dim: Sequence[int] = (0, 1, 2, 3, 4),
    pad_empty_sweeps: bool = True,
    remove_close: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """The keyframe cloud with `sweeps_num` previous sweeps, each moved into
    the keyframe lidar frame and stamped with its time lag in channel 4
    (0 for the keyframe). The keyframe is kept unfiltered; padded copies
    and sweeps lose their close returns (loading.py:184-193, 218-219).
    Returns [N, len(use_dim)]."""
    key = _with_time_channel(load_lidar_points(rec["lidar_path"]).astype(np.float32))
    key[:, 4] = 0.0
    clouds = [key]

    sweeps = rec.get("sweeps", [])
    if not sweeps and pad_empty_sweeps:
        pad = _remove_close(key) if remove_close else key
        clouds = clouds + [pad] * sweeps_num
    else:
        if len(sweeps) <= sweeps_num:
            chosen = list(range(len(sweeps)))
        elif rng is not None:
            chosen = list(rng.choice(len(sweeps), sweeps_num, replace=False))
        else:
            chosen = list(range(sweeps_num))
        for i in chosen:
            sw = sweeps[i]
            pts = _with_time_channel(load_lidar_points(sw["data_path"]).astype(np.float32))
            if remove_close:
                pts = _remove_close(pts)
            T = np.asarray(sw["sweep2lidar"], np.float32)
            pts[:, :3] = pts[:, :3] @ T[:3, :3].T + T[:3, 3]
            pts[:, 4] = float(sw["time_lag"])
            clouds.append(pts)
    return np.concatenate(clouds, axis=0)[:, list(use_dim)]


def points_range_filter(points: np.ndarray, pc_range: Sequence[float]) -> np.ndarray:
    """(PointsRangeFilter, transforms_3d.py:846-869)"""
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:6])
    keep = ((points[:, :3] >= lo) & (points[:, :3] <= hi)).all(axis=1)
    return points[keep]


def fold_img_aug(lidar2image: np.ndarray, camera_intrinsics: np.ndarray,
                 img_aug_matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fold per-view 2D affines (ImageAug3D's `img_aug_matrix` [V, 4, 4])
    into the projective matrices: (ud, vd, d) -> (a00*ud + a01*vd + tx*d,
    ...), the affine's translation in the depth column. Returns new
    (lidar2image [V, 4, 4], camera_intrinsics [V, 4, 4]), so the sparse
    depth maps and the LSS frustum need no separate aug matrix."""
    l2i = np.asarray(lidar2image, np.float64).copy()
    intr = np.asarray(camera_intrinsics, np.float64).copy()
    for v in range(img_aug_matrix.shape[0]):
        A = np.eye(4)
        A[:2, :2] = img_aug_matrix[v, :2, :2]
        A[:2, 2] = img_aug_matrix[v, :2, 3]
        l2i[v] = A @ l2i[v]
        intr[v, :3, :3] = A[:3, :3] @ intr[v, :3, :3]
    return l2i.astype(np.float32), intr.astype(np.float32)


def image_aug_3d(
    images: np.ndarray,
    rng: Optional[np.random.Generator],
    final_dim: Tuple[int, int] = (256, 704),
    resize_lim: Tuple[float, float] = (0.38, 0.55),
    bot_pct_lim: Tuple[float, float] = (0.0, 0.0),
    rot_lim: Tuple[float, float] = (-5.4, 5.4),
    rand_flip: bool = True,
    is_train: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """ImageAug3D at test time: each view resized by mean(resize_lim),
    centre-cropped horizontally and bottom-cropped by mean(bot_pct_lim),
    with the 4x4 post-homography `img_aug_matrix` the LSS transform
    consumes. images: [V, H, W, C] float; returns (aug_images
    [V, fH, fW, C], img_aug_matrix [V, 4, 4]). The random training branch
    is not ported (is_train=True raises)."""
    if is_train:
        raise NotImplementedError("image_aug_3d: only the evaluation branch (is_train=False) is ported")
    v = images.shape[0]
    H, W = images.shape[1:3]
    fH, fW = final_dim
    out_imgs = np.empty((v, fH, fW, images.shape[3]), images.dtype)
    out_mats = np.empty((v, 4, 4), np.float32)
    resize = float(np.mean(resize_lim))
    newW, newH = int(W * resize), int(H * resize)
    crop_h = int((1 - np.mean(bot_pct_lim)) * newH) - fH
    crop_w = int(max(0, newW - fW) / 2)
    for i in range(v):
        img = imgproc.resize_linear(images[i], newH, newW)
        canvas = np.zeros((fH, fW, images.shape[3]), images.dtype)
        # PIL crop semantics: a negative offset pads with black, so the patch
        # lands at output row/col -crop
        y0, x0 = max(crop_h, 0), max(crop_w, 0)
        oy, ox = -min(crop_h, 0), -min(crop_w, 0)
        patch = img[y0:crop_h + fH, x0:crop_w + fW]
        canvas[oy:oy + patch.shape[0], ox:ox + patch.shape[1]] = patch
        out_imgs[i] = canvas

        mat = np.eye(4, dtype=np.float32)
        mat[:2, :2] = np.eye(2) * resize
        mat[:2, 3] = -np.asarray([crop_w, crop_h], np.float64)
        out_mats[i] = mat
    return out_imgs, out_mats
