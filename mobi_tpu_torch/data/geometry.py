"""3D box geometry (mobi_tpu data/geometry.py): projection, the camera and
range-view inpaint masks, points in boxes. Host-side numpy for the input
pipeline and the test bench; the masks rasterise each projected face with
`imgproc.fill_poly_aa`, cv2's anti-aliased fill.

The BEV box-collision test (separating axes) and the spherical-frustum
overlap serve preprocessing's erase-box synthesis and its `max_iou_overlap`
column (the reference's pipelines/utils.py:32-296).

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


def _box_bev_corners(corners: np.ndarray) -> np.ndarray:
    """[..., 8, 3] -> BEV footprint [..., 4, 2] (bottom face)."""
    return corners[..., :4, :2]


def _polygon_overlap_2d(poly_a: np.ndarray, poly_b: np.ndarray) -> bool:
    """Separating-axis test for two convex 2D polygons."""
    for poly in (poly_a, poly_b):
        n = len(poly)
        for i in range(n):
            edge = poly[(i + 1) % n] - poly[i]
            axis = np.array([-edge[1], edge[0]])
            pa = poly_a @ axis
            pb = poly_b @ axis
            if pa.max() < pb.min() or pb.max() < pa.min():
                return False
    return True


def box_collision_test(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """BEV footprint overlap between two corner sets
    ([N, 8, 3] x [M, 8, 3] -> [N, M] bool). Behavioral equivalent of the
    numba kernel (pipelines/utils.py:32-121) via separating-axis tests with a
    vectorized AABB prefilter."""
    a = _box_bev_corners(np.asarray(boxes))
    b = _box_bev_corners(np.asarray(qboxes))
    n, m = len(a), len(b)
    out = np.zeros((n, m), dtype=bool)
    a_lo, a_hi = a.min(axis=1), a.max(axis=1)
    b_lo, b_hi = b.min(axis=1), b.max(axis=1)
    aabb = ~(
        (a_hi[:, None, 0] < b_lo[None, :, 0])
        | (b_hi[None, :, 0] < a_lo[:, None, 0])
        | (a_hi[:, None, 1] < b_lo[None, :, 1])
        | (b_hi[None, :, 1] < a_lo[:, None, 1])
    )
    for i, j in zip(*np.nonzero(aabb)):
        out[i, j] = _polygon_overlap_2d(a[i], b[j])
    return out


def transform_to_spherical(points: np.ndarray) -> np.ndarray:
    """[N, 3] xyz -> [N, 3] (r, theta-from-Z, phi in [0, 2pi))
    (pipelines/utils.py:267-296)."""
    pts = np.asarray(points, dtype=np.float64)
    r = np.sqrt(np.sum(pts**2, axis=-1))
    with np.errstate(divide="ignore", invalid="ignore"):
        theta = np.arccos(pts[..., 2] / r)
    phi = np.arctan2(pts[..., 1], pts[..., 0]) % (2 * np.pi)
    return np.stack([r, theta, phi], axis=-1)


def get_frustum(corners: np.ndarray) -> np.ndarray:
    """Spherical viewing frustum of boxes from the sensor at the origin
    (pipelines/utils.py:225-264).

    corners: [N, 8, 3] (or [8, 3]) box corners in the lidar frame.
    Returns [N, 3, 2, 2]: axes (r, theta, phi) x (min, max) x two phi
    intervals. A box straddling the +x axis (phi wrap: max-min > pi) is split
    into [0, max-of-sub-pi-corners] and [min-of-super-pi-corners, 2pi];
    otherwise the second interval slots hold -1 (inactive).
    """
    corners = np.asarray(corners)
    if corners.ndim == 2:
        corners = corners[None]
    n = len(corners)
    pts = transform_to_spherical(corners.reshape(-1, 3)).reshape(n, 8, 3)
    fr = np.full((n, 3, 2, 2), -1.0, dtype=np.float64)
    fr[:, :, 0, 0] = pts.min(axis=1)
    fr[:, :, 1, 0] = pts.max(axis=1)
    wrap = (fr[:, 2, 1, 0] - fr[:, 2, 0, 0]) > np.pi
    for idx in np.nonzero(wrap)[0]:
        phi = pts[idx, :, 2]
        fr[idx, 2, 0, 0] = 0.0
        fr[idx, 2, 1, 1] = 2 * np.pi
        fr[idx, 2, 1, 0] = phi[phi < np.pi].max()
        fr[idx, 2, 0, 1] = phi[phi > np.pi].min()
    return fr


def frustum_iou_matrix(
    gt_frustums: np.ndarray, sp_frustums: Optional[np.ndarray] = None
) -> np.ndarray:
    """Pairwise frustum overlap PERCENTAGE (overlap area in (theta, phi)
    angle space divided by the smaller frustum's area), matching the
    reference `frustum_collision_test(..., apply_thresh=False)`
    (pipelines/utils.py:124-222; used for the dataset `max_iou_overlap`
    column, create_pbe_database.py:217-224). Vectorized over all pairs.

    Returns [N, K] float (sp defaults to gt; diagonal NOT zeroed).
    """
    gt = np.asarray(gt_frustums, dtype=np.float64)
    sp = gt if sp_frustums is None else np.asarray(sp_frustums, dtype=np.float64)

    def area(f):
        return (f[:, 1, 1, 0] - f[:, 1, 0, 0]) * (
            (f[:, 2, 1, 0] - f[:, 2, 0, 0]) + (f[:, 2, 1, 1] - f[:, 2, 0, 1])
        )

    s_gt, s_sp = area(gt), area(sp)
    # theta overlap always uses the single theta interval
    t_lo = np.maximum(gt[:, 1, 0, 0][:, None], sp[None, :, 1, 0, 0])
    t_hi = np.minimum(gt[:, 1, 1, 0][:, None], sp[None, :, 1, 1, 0])
    theta_pos = t_lo < t_hi
    theta_ov = t_hi - t_lo

    iou = np.zeros((len(gt), len(sp)), dtype=np.float64)
    for a in (0, 1):
        g_valid = np.ones(len(gt), bool) if a == 0 else gt[:, 2, 0, 1] >= 0
        for b in (0, 1):
            s_valid = np.ones(len(sp), bool) if b == 0 else sp[:, 2, 0, 1] >= 0
            lo = np.maximum(gt[:, 2, 0, a][:, None], sp[None, :, 2, 0, b])
            hi = np.minimum(gt[:, 2, 1, a][:, None], sp[None, :, 2, 1, b])
            coll = (lo < hi) & theta_pos & g_valid[:, None] & s_valid[None, :]
            iou += np.where(coll, (hi - lo) * theta_ov, 0.0)

    with np.errstate(divide="ignore", invalid="ignore"):
        out = iou / np.minimum(s_gt[:, None], s_sp[None, :])
    return np.nan_to_num(out, nan=0.0, posinf=0.0)


def frustum_collision_test(
    gt_frustums: np.ndarray,
    sp_frustums: Optional[np.ndarray] = None,
    thresh: float = 0.7,
) -> np.ndarray:
    """Thresholded frustum-IoU collision (reference apply_thresh=True path,
    default thresh 0.7 from PointAugmenting)."""
    return frustum_iou_matrix(gt_frustums, sp_frustums) > thresh
