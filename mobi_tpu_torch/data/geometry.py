"""3D box geometry (mobi_tpu data/geometry.py): projection, the camera and
range-view inpaint masks, points in boxes. Host-side numpy for the input
pipeline and the test bench; the masks rasterise each projected face with
`imgproc.fill_poly_aa`, cv2's anti-aliased fill.

The collision and frustum tests serve preprocessing and stay in the JAX
package until that is ported (ROADMAP queue 1 item 9).

Corner-order convention (shared with the reference's mask polygons,
data/utils.py:153-160): bottom face [0,1,2,3], top face [4,5,6,7], vertical
edges (i, i+4); the box "front" is the face [0,1,4,5].
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mobi_tpu_torch.data.imgproc import fill_poly_aa

BOX_FACES = (
    (0, 1, 2, 3),
    (4, 5, 6, 7),
    (0, 1, 5, 4),
    (2, 3, 7, 6),
    (0, 4, 7, 3),
    (1, 5, 6, 2),
)


def expand_bbox_corners(corners: np.ndarray, expand_ratio: float = 0.1) -> np.ndarray:
    """Scale a box about its center (data/utils.py:268-278)."""
    if expand_ratio == 0:
        return corners
    center = corners.mean(axis=-2, keepdims=True)
    return (corners - center) * (1.0 + expand_ratio) + center


def rotate_bbox(corners: np.ndarray, angle_deg: float = 0.0) -> np.ndarray:
    """Rotate about the box center's vertical (z) axis (data/utils.py:75-103)."""
    if angle_deg == 0:
        return corners
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    center = corners.mean(axis=-2, keepdims=True)
    return (corners - center) @ rot.T + center


def translate_bbox(corners: np.ndarray, new_center: np.ndarray) -> np.ndarray:
    center = corners.mean(axis=-2, keepdims=True)
    return corners - center + np.asarray(new_center)


def project_to_image(
    corners: np.ndarray, lidar2image: np.ndarray, include_depth: bool = False
) -> np.ndarray:
    """[8, 3] lidar-frame corners -> [8, 2 or 3] pixel coords
    (data/utils.py:44-73); depth clamped to [1e-5, 1e5] before divide."""
    hom = np.concatenate([corners, np.ones((corners.shape[0], 1))], axis=-1)
    cam = hom @ np.asarray(lidar2image).reshape(4, 4).T
    depth = np.clip(cam[..., 2], 1e-5, 1e5)
    xy = cam[..., :2] / depth[..., None]
    if include_depth:
        return np.concatenate([xy, depth[..., None]], axis=-1)
    return xy


def get_2d_bbox(
    corners: np.ndarray, lidar2image: np.ndarray, H: int, W: int,
    expand_ratio: float = 0.1,
) -> np.ndarray:
    """Axis-aligned [x1, y1, x2, y2] of the projected box, clipped
    (data/utils.py:254-265)."""
    coords = project_to_image(expand_bbox_corners(corners, expand_ratio), lidar2image)
    lo, hi = coords.min(axis=-2), coords.max(axis=-2)
    box = np.concatenate([lo, hi]).astype(int)
    box[0::2] = np.clip(box[0::2], 0, W - 1)
    box[1::2] = np.clip(box[1::2], 0, H - 1)
    return box


def fill_box_faces(mask: np.ndarray, coords_xy: np.ndarray) -> np.ndarray:
    """Rasterize the 6 projected faces into `mask` (uint8, in-place), as
    cv2.fillPoly(mask, [pts], 1, cv2.LINE_AA) does."""
    for face in BOX_FACES:
        fill_poly_aa(mask, coords_xy[list(face)].astype(np.int32), 1)
    return mask


def get_inpaint_mask(
    corners: np.ndarray,
    lidar2image: np.ndarray,
    H: int,
    W: int,
    expand_ratio: float = 0.1,
    use_3d_edit_mask: bool = True,
) -> np.ndarray:
    """Camera edit mask: 0 inside the (expanded) projected box, 1 outside
    (data/utils.py:146-171). Returns float32 [H, W]."""
    mask = np.zeros((H, W), dtype=np.uint8)
    if use_3d_edit_mask:
        coords = project_to_image(
            expand_bbox_corners(corners, expand_ratio), lidar2image
        )
        fill_box_faces(mask, coords)
    else:
        x1, y1, x2, y2 = get_2d_bbox(corners, lidar2image, H, W, expand_ratio)
        mask[y1:y2, x1:x2] = 1
    return 1.0 - (mask > 0.5).astype(np.float32)


def get_range_inpaint_mask(
    corners: np.ndarray,
    range_height: int,
    range_width: int,
    expand_ratio: float = 0.1,
    crop_left: Optional[int] = None,
    width_crop: Optional[int] = None,
) -> np.ndarray:
    """Range-view edit mask through the same tile/crop/resize pipeline as the
    data (data/utils.py:174-197)."""
    from mobi_tpu_torch.data.range_projection import apply_range_transforms, bbox_range_coords

    coords = bbox_range_coords(expand_bbox_corners(corners, expand_ratio))
    _, _, _, coords, _ = apply_range_transforms(
        coords, out_h=range_height, out_w=range_width,
        crop_left=crop_left, width_crop=width_crop,
    )
    mask = np.zeros((range_height, range_width), dtype=np.uint8)
    fill_box_faces(mask, coords[:, :2])
    return 1.0 - (mask > 0.5).astype(np.float32)


# --------------------------------------------------------------------------
# points in boxes (vectorized numpy)
# --------------------------------------------------------------------------


def box_basis(corners: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Origin corner + the three edge vectors of a rectangular box.

    corners: [..., 8, 3] in the BOX_FACES ordering.
    Returns (origin [..., 3], edges [..., 3, 3]).
    """
    origin = corners[..., 0, :]
    edges = np.stack(
        [
            corners[..., 1, :] - origin,
            corners[..., 3, :] - origin,
            corners[..., 4, :] - origin,
        ],
        axis=-2,
    )
    return origin, edges


def points_in_bbox_corners(points: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """[N, 3+] points x [M, 8, 3] boxes -> [N, M] bool
    (box_np_ops.points_in_bbox_corners, box_np_ops.py:453-470).

    Uses the parallelepiped projection test: p is inside iff its coordinates
    in the box's edge basis all lie in [0, 1]. Exact for rectangular boxes and
    ~40x faster than the numba polygon test at nuScenes scales (no JIT warmup).
    """
    pts = np.asarray(points)[:, :3]
    corners = np.asarray(corners)
    if corners.ndim == 2:
        corners = corners[None]
    origin, edges = box_basis(corners)          # [M,3], [M,3,3]
    rel = pts[:, None, :] - origin[None]        # [N,M,3]
    # solve rel = coeff @ edges  ->  coeff = rel @ inv(edges)
    inv = np.linalg.inv(edges)                  # [M,3,3]
    coeff = np.einsum("nmj,mjk->nmk", rel, inv)
    eps = 1e-9
    return np.all((coeff >= -eps) & (coeff <= 1 + eps), axis=-1)
