"""Point cloud <-> range-view projection for 32-beam nuScenes lidar
(mobi_tpu data/range_projection.py), in numpy, with the same geometry:

  * fixed 32-beam pitch table 0.0232 * [-23..8] rad, row 0 = top beam,
  * azimuth x = 0.5*(yaw/pi + 1)*W with yaw = -atan2(y, x),
  * depth z-buffering by projecting points in decreasing-depth order,
  * depth normalized to [-1, 1] over (1.4, 54) m,
  * bbox corner projection unwraps yaw around the box-center azimuth
    (lidar_converter.py:177-228) so boxes crossing the wrap seam stay
    contiguous.

Unlike the reference class (which mutates `current_W` across calls), all
functions here are pure; view-transform state lives in `RangeCropGeom`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from mobi_tpu_torch.data import imgproc

# geometry constants (lidar_converter.py:23-37)
RANGE_H = 32
RANGE_W = 1096
DEPTH_MIN = 1.4
DEPTH_MAX = 54.0
BEAM_PITCH = 0.0232 * np.arange(-23, 9, dtype=np.float64)  # ascending


def normalize_depth(depth_m: np.ndarray) -> np.ndarray:
    """meters -> [-1, 1] (lidar_converter.py:110-118)."""
    d = np.where(depth_m < 0, 0, depth_m) / DEPTH_MAX
    return np.clip(d * 2.0 - 1.0, -1.0, 1.0)


def denormalize_depth(depth_norm: np.ndarray) -> np.ndarray:
    return (depth_norm + 1.0) / 2.0 * DEPTH_MAX


def _pitch_to_row(pitch: np.ndarray) -> np.ndarray:
    lo, hi = BEAM_PITCH.min(), BEAM_PITCH.max()
    r = (pitch - lo) / (hi - lo) * (RANGE_H - 1)
    return (RANGE_H - 1) - np.round(np.clip(r, 0, RANGE_H - 1)).astype(np.int32)


def pcd_to_range(
    points: np.ndarray,
    intensity: Optional[np.ndarray] = None,
    width: int = RANGE_W,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray, np.ndarray, np.ndarray]:
    """Project [N, 3] points to the range view.

    Returns (range_depth_norm [H,W], range_int [H,W] or None,
    valid_mask [N], range_pitch [H,W], range_yaw [H,W]).
    """
    pts = np.asarray(points, dtype=np.float64)
    depth = np.linalg.norm(pts, axis=1)
    valid = (depth > DEPTH_MIN) & (depth < DEPTH_MAX)
    pts_v, depth_v = pts[valid], depth[valid]

    yaw = -np.arctan2(pts_v[:, 1], pts_v[:, 0])
    pitch = np.arcsin(pts_v[:, 2] / depth_v)

    rows = _pitch_to_row(pitch)
    cols = 0.5 * (yaw / np.pi + 1.0) * width
    cols = np.clip(np.floor(cols), 0, width - 1).astype(np.int32)

    # z-buffer: write nearest last
    order = np.argsort(depth_v)[::-1]
    rows_o, cols_o = rows[order], cols[order]
    depth_o, pitch_o, yaw_o = depth_v[order], pitch[order], yaw[order]

    # default angular grids (lidar_converter.py:86-93)
    col_frac = np.arange(width, dtype=np.float64) / width
    range_yaw = np.broadcast_to(
        np.pi * (col_frac * 2 - 1), (RANGE_H, width)
    ).copy()
    range_pitch = np.broadcast_to(
        BEAM_PITCH[::-1][:, None], (RANGE_H, width)
    ).copy()

    range_depth = np.full((RANGE_H, width), -1.0)
    range_depth[rows_o, cols_o] = depth_o
    range_pitch[rows_o, cols_o] = pitch_o
    range_yaw[rows_o, cols_o] = yaw_o

    if intensity is not None:
        lab = np.asarray(intensity, dtype=np.float64)[valid][order]
        range_int = np.zeros((RANGE_H, width))
        range_int[rows_o, cols_o] = lab
    else:
        range_int = None

    return (
        normalize_depth(range_depth).astype(np.float32),
        None if range_int is None else range_int.astype(np.float32),
        valid,
        range_pitch.astype(np.float32),
        range_yaw.astype(np.float32),
    )


def range_to_pcd(
    range_depth_norm: np.ndarray,
    range_pitch: np.ndarray,
    range_yaw: np.ndarray,
    label: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """Inverse projection (lidar_converter.py:122-175). Input depth is the
    normalized range image at native (32, 1096) resolution (callers resize
    first via `resize_range`)."""
    depth = denormalize_depth(np.asarray(range_depth_norm, dtype=np.float64))
    H, W = range_pitch.shape
    d = depth.reshape(-1)
    yaw = np.asarray(range_yaw, dtype=np.float64).reshape(-1)
    pitch = np.asarray(range_pitch, dtype=np.float64).reshape(-1)

    pcd = np.stack(
        [
            np.cos(yaw) * np.cos(pitch) * d,
            -np.sin(yaw) * np.cos(pitch) * d,
            np.sin(pitch) * d,
        ],
        axis=1,
    ).astype(np.float32)

    mask = (d > DEPTH_MIN) & (d < DEPTH_MAX)
    out_label = None if label is None else np.asarray(label).reshape(-1)[mask]
    beam_index = np.repeat(np.arange(H - 1, -1, -1), W)[mask]
    return pcd[mask], out_label, beam_index


def bbox_range_coords(bbox_3d: np.ndarray, width: int = RANGE_W) -> np.ndarray:
    """3D box corners [8, 3] -> range-view (x_pix, y_row, depth_norm) [8, 3]
    with center-yaw unwrap (lidar_converter.py:177-228)."""
    corners = np.asarray(bbox_3d, dtype=np.float64)
    depth = np.linalg.norm(corners, axis=1)

    cx, cy = corners[:, 0].mean(), corners[:, 1].mean()
    center_yaw = -np.arctan2(cy, cx)
    c, s = np.cos(center_yaw), np.sin(center_yaw)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    rotated = corners @ rot.T

    yaw = -(np.arctan2(rotated[:, 1], rotated[:, 0]) - center_yaw)
    pitch = np.arcsin(rotated[:, 2] / depth)

    x = 0.5 * (yaw / np.pi + 1.0) * width
    y = _pitch_to_row(pitch).astype(np.float64)
    d = np.clip(depth / DEPTH_MAX * 2.0 - 1.0, -1.0, 1.0)
    return np.stack([x, y, d], axis=1).astype(np.float32)


# --------------------------------------------------------------------------
# Range-view transforms (tile -> object crop -> resize) and their inverse.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RangeCropGeom:
    """Geometry of the default transform pipeline, enough to undo it."""

    crop_left: int       # left edge of the crop in TILED coordinates
    width_crop: int      # crop window width before resize
    native_w: int = RANGE_W
    native_h: int = RANGE_H


def block_mean_resize(x: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Average-pool resize when dims divide exactly (pool_resize avg,
    lidar_converter.py:8-19)."""
    h, w = x.shape
    kh, kw = h // new_h, w // new_w
    return x[: new_h * kh, : new_w * kw].reshape(new_h, kh, new_w, kw).mean(
        axis=(1, 3)
    )


def block_max_resize(x: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    h, w = x.shape
    kh, kw = h // new_h, w // new_w
    return x[: new_h * kh, : new_w * kw].reshape(new_h, kh, new_w, kw).max(
        axis=(1, 3)
    )


def nearest_resize(x: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """cv2.INTER_NEAREST nearest resize (lidar_converter.py:263-265)."""
    return imgproc.resize_nearest(x, new_h, new_w)


def resize_range(
    x: Optional[np.ndarray], new_h: int, new_w: int, mode: str = "avg"
) -> Optional[np.ndarray]:
    """Pool when dims divide exactly, nearest otherwise
    (lidar_converter.py:258-281)."""
    if x is None or x.shape == (new_h, new_w):
        return x
    h, w = x.shape
    if h % new_h == 0 and w % new_w == 0:
        f = block_max_resize if mode == "max" else block_mean_resize
        return f(x, new_h, new_w).astype(x.dtype)
    return nearest_resize(x, new_h, new_w)


def default_width_crop(coords_tiled: np.ndarray, max_width: int) -> int:
    """Power-of-two crop window >= 64 covering 1.5x the object span
    (lidar_converter.py:421-423)."""
    object_width = coords_tiled[:, 0].max() - coords_tiled[:, 0].min()
    return int(max(64, min(max_width, 2 ** np.ceil(np.log2(object_width * 1.5)))))


def apply_range_transforms(
    bbox_coords: np.ndarray,
    range_depth: Optional[np.ndarray] = None,
    range_int: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
    out_h: int = 512,
    out_w: int = 512,
    width_crop: Optional[int] = None,
    crop_left: Optional[int] = None,
    random_crop: bool = False,
    rng: Optional[np.random.Generator] = None,
):
    """tile x3 -> crop a pow2 window centered on the object -> resize
    (lidar_converter.py:387-434).

    Returns (depth, int, mask, bbox_coords, geom: RangeCropGeom).
    """
    native_w = range_depth.shape[1] if range_depth is not None else RANGE_W

    def tile3(x):
        return None if x is None else np.tile(x, 3)

    depth_t, int_t, mask_t = tile3(range_depth), tile3(range_int), tile3(mask)
    coords = np.asarray(bbox_coords, dtype=np.float32).copy()
    coords[:, 0] += native_w  # object now refers to the middle tile

    if width_crop is None:
        width_crop = default_width_crop(coords, out_w)

    center_x = int(coords[:, 0].mean())
    if crop_left is None:
        if random_crop and rng is not None:
            d_left = int(rng.integers(width_crop // 4, width_crop - width_crop // 4))
        else:
            d_left = width_crop // 2
        crop_left = center_x - d_left
    lo, hi = crop_left, crop_left + width_crop

    def crop(x):
        return None if x is None else x[:, lo:hi]

    depth_c, int_c, mask_c = crop(depth_t), crop(int_t), crop(mask_t)
    coords[:, 0] -= lo

    h_native = range_depth.shape[0] if range_depth is not None else RANGE_H
    depth_r = resize_range(depth_c, out_h, out_w, "avg")
    int_r = resize_range(int_c, out_h, out_w, "avg")
    mask_r = resize_range(mask_c, out_h, out_w, "max")
    coords[:, 0] *= out_w / width_crop
    coords[:, 1] *= out_h / h_native

    geom = RangeCropGeom(
        crop_left=crop_left, width_crop=width_crop,
        native_w=native_w, native_h=h_native,
    )
    return depth_r, int_r, mask_r, coords, geom


def undo_range_transforms(
    geom: RangeCropGeom,
    depth_crop: np.ndarray,
    depth_full: np.ndarray,
    int_crop: Optional[np.ndarray] = None,
    int_full: Optional[np.ndarray] = None,
    mask: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Paste a predicted crop back into the native range view with horizontal
    wrap-around; where `mask` is False the original pixels are kept
    (lidar_converter.py:436-485)."""
    IGNORE = -1000.0
    crop_left = geom.crop_left % depth_full.shape[-1]

    def paste(crop, full):
        crop = crop.astype(np.float64).copy()
        if mask is not None:
            crop[~mask] = IGNORE
        crop = resize_range(crop, full.shape[0], geom.width_crop, "avg")
        aux = (
            np.full_like(full, IGNORE, dtype=np.float64)
            if mask is not None
            else full.astype(np.float64).copy()
        )
        right = min(crop_left + crop.shape[1], full.shape[1])
        aux[:, crop_left:right] = crop[:, : right - crop_left]
        wrap = geom.width_crop - (right - crop_left)
        if wrap > 0:
            aux[:, :wrap] = crop[:, right - crop_left :]
        return np.where(aux == IGNORE, full, aux).astype(full.dtype)

    out_depth = paste(depth_crop, depth_full)
    out_int = None
    if int_full is not None:
        assert int_crop is not None
        out_int = paste(int_crop, int_full)
    return out_depth, out_int
