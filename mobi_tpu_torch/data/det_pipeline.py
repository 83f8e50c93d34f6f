"""The detector's host pipeline (mobi_tpu data/det_pipeline.py; the
reference's mmdet3d pipelines of the BEVFusion configs):

  * loading.py:84-238 LoadPointsFromMultiSweeps -> `load_points_multisweep`
  * transforms_3d.py:129-163 GlobalRotScaleTrans -> `global_rot_scale_trans`
  * transforms_3d.py:252-280 RandomFlip3D -> `random_flip_3d`
  * transforms_3d.py:796-869 Object/PointsRangeFilter -> `*_range_filter`
  * transforms_3d.py:871-890 ObjectNameFilter -> `object_name_filter`
  * transforms_3d.py:789-795 PointShuffle -> `point_shuffle`
  * dbsampler.py:17-277 UnifiedDataBaseSampler -> `GTDatabaseSampler` (GT
    objects pasted from a database with BEV collision rejection,
    transforms_3d.py:281-614 UnifiedObjectSample), `build_gt_database`
  * transforms_3d.py:164-251 GridMask, 714-768 ObjectNoise, 770-787
    FrameDropout, PointSample, 994-1050 BackgroundPointsFilter
  * transforms_3d.py:31-128 ImageAug3D -> `image_aug_3d`

Plain numpy dicts with boxes as [N, 7+] arrays (x, y, z_bottom, dx, dy, dz,
yaw, [vx, vy]) in the keyframe lidar frame, as `DetectionSceneDataset`
emits them. Every random draw comes from the caller's np.random.Generator
in JAX's order, so under one seed the outputs equal JAX's. The views are
resized with `imgproc.resize_linear` and warped with
`imgproc.warp_affine_linear`, the numpy copies of cv2's float32 paths.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

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


def global_rot_scale_trans(
    points: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    rot_range: Tuple[float, float] = (-0.78539816, 0.78539816),
    scale_range: Tuple[float, float] = (0.9, 1.1),
    trans_std: Tuple[float, float, float] = (0.5, 0.5, 0.5),
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scene rotation about z, scale and translation (GlobalRotScaleTrans).
    Boxes [N, 7+], yaw at 6, velocity at 7:9. Also returns the 4x4 map
    p -> s * Rz(angle) p + t (the reference's lidar_aug_matrix,
    transforms_3d.py:155-161)."""
    points = points.copy()
    boxes = boxes.copy()
    angle = rng.uniform(*rot_range)
    scale = rng.uniform(*scale_range)
    trans = rng.normal(scale=trans_std, size=3)

    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]], np.float32)
    points[:, :2] = points[:, :2] @ R.T
    points[:, :3] = points[:, :3] * scale + trans
    if len(boxes):
        boxes[:, :2] = boxes[:, :2] @ R.T
        boxes[:, :3] = boxes[:, :3] * scale + trans
        boxes[:, 3:6] *= scale
        boxes[:, 6] += angle
        if boxes.shape[1] >= 9:
            boxes[:, 7:9] = boxes[:, 7:9] @ R.T
            boxes[:, 7:9] *= scale
    M = np.eye(4, dtype=np.float32)
    M[:2, :2] = scale * R
    M[2, 2] = scale
    M[:3, 3] = trans
    return points, boxes, M


def random_flip_3d(
    points: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    flip_ratio_horizontal: float = 0.5,
    flip_ratio_vertical: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BEV flips (RandomFlip3D): horizontal negates y, vertical x; yaw and
    velocity mirrored with them. Also returns the flip's 4x4 matrix."""
    points = points.copy()
    boxes = boxes.copy()
    M = np.eye(4, dtype=np.float32)
    if rng.uniform() < flip_ratio_horizontal:
        points[:, 1] = -points[:, 1]
        M[1, 1] = -1.0
        if len(boxes):
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
            if boxes.shape[1] >= 9:
                boxes[:, 8] = -boxes[:, 8]
    if rng.uniform() < flip_ratio_vertical:
        points[:, 0] = -points[:, 0]
        M[0, 0] = -1.0
        if len(boxes):
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = np.pi - boxes[:, 6]
            if boxes.shape[1] >= 9:
                boxes[:, 7] = -boxes[:, 7]
    return points, boxes, M


def object_range_filter(boxes: np.ndarray, labels: np.ndarray,
                        pc_range: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Boxes whose BEV centre is in range, yaw wrapped to [-pi, pi)
    (ObjectRangeFilter)."""
    lo, hi = np.asarray(pc_range[:2]), np.asarray(pc_range[3:5])
    keep = ((boxes[:, :2] >= lo) & (boxes[:, :2] <= hi)).all(axis=1)
    boxes, labels = boxes[keep].copy(), labels[keep]
    boxes[:, 6] = (boxes[:, 6] + np.pi) % (2 * np.pi) - np.pi
    return boxes, labels


def object_name_filter(boxes: np.ndarray, names: Sequence[str],
                       classes: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Boxes of the requested classes with their integer labels
    (ObjectNameFilter)."""
    keep = [i for i, n in enumerate(names) if n in classes]
    labels = np.asarray([classes.index(names[i]) for i in keep], np.int64)
    return boxes[keep], labels


def point_shuffle(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return points[rng.permutation(len(points))]


def _bev_collision(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """[A, B] overlap of the boxes' enclosing axis-aligned BEV squares: the
    paste's coarse rejection (dbsampler.py's box_collision_test; the
    enclosing square only rejects more)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), bool)

    def aabb(b):
        r = np.hypot(b[:, 3], b[:, 4]) / 2.0
        return b[:, 0] - r, b[:, 0] + r, b[:, 1] - r, b[:, 1] + r

    ax0, ax1, ay0, ay1 = aabb(boxes_a)
    bx0, bx1, by0, by1 = aabb(boxes_b)
    ox = (ax0[:, None] <= bx1[None]) & (bx0[None] <= ax1[:, None])
    oy = (ay0[:, None] <= by1[None]) & (by0[None] <= ay1[:, None])
    return ox & oy


def build_gt_database(dataset, out_dir: str, classes: Sequence[str], min_points: int = 5) -> str:
    """A GT-paste database from a DetectionSceneDataset (the reference's
    create_groundtruth_database): for each box of a listed class with at
    least `min_points` interior points, those points relative to the box's
    (x, y, z_bottom) in `<sample>_<name>_<j>.npy`, and an info row in
    `gt_db_infos.pkl` ({class: [{"path", "box", "num_points"}]}). Returns
    the pkl's path."""
    from mobi_tpu_torch.native import points_in_boxes

    os.makedirs(out_dir, exist_ok=True)
    infos: Dict[str, List[dict]] = {c: [] for c in classes}
    for i in range(len(dataset)):
        ex = dataset[i]
        pts = np.asarray(ex["points"], np.float32)
        boxes = np.asarray(ex["gt_bboxes_3d"], np.float32)
        names = list(ex["gt_names"])
        if not len(boxes):
            continue
        inside = points_in_boxes(pts[:, :3], boxes)
        for j, name in enumerate(names):
            if name not in infos:
                continue
            obj_pts = pts[inside == j].copy()
            if len(obj_pts) < min_points:
                continue
            obj_pts[:, :3] -= boxes[j, :3]
            fname = f"{ex['sample_token']}_{name}_{j}.npy"
            np.save(os.path.join(out_dir, fname), obj_pts)
            infos[name].append({"path": fname, "box": boxes[j].tolist(), "num_points": int(len(obj_pts))})
    pkl = os.path.join(out_dir, "gt_db_infos.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(infos, f)
    return pkl


class GTDatabaseSampler:
    """Pastes database objects into a scene until each class of
    `sample_groups` has its target count (UnifiedDataBaseSampler.sample_all,
    dbsampler.py:127-277): per class, up to twice the shortfall of
    candidates in a random order, each rejected when its BEV square meets an
    existing or accepted box; the accepted objects' points moved to their
    boxes, the scene's points inside pasted boxes removed. Its draws come
    from its own generator, seeded `seed`."""

    def __init__(self, db_info_path: str, sample_groups: Dict[str, int], min_points: int = 5, seed: int = 0):
        with open(db_info_path, "rb") as f:
            self.infos = pickle.load(f)
        self.root = os.path.dirname(db_info_path)
        self.sample_groups = dict(sample_groups)
        self.min_points = min_points
        self.rng = np.random.default_rng(seed)

    def __call__(self, points: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                 classes: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        from mobi_tpu_torch.native import points_in_boxes

        rng = self.rng
        new_boxes, new_labels, new_points = [], [], []
        all_boxes = boxes.copy() if len(boxes) else np.zeros((0, 7), np.float32)
        for cls, target in self.sample_groups.items():
            if cls not in self.infos or not self.infos[cls]:
                continue
            have = int((labels == classes.index(cls)).sum()) if len(labels) else 0
            need = max(target - have, 0)
            if need == 0:
                continue
            cand_idx = rng.permutation(len(self.infos[cls]))[: need * 2]
            taken = 0
            for ci in cand_idx:
                if taken >= need:
                    break
                info = self.infos[cls][int(ci)]
                box = np.asarray(info["box"], np.float32)[None, :7]
                if _bev_collision(box, all_boxes[:, :7]).any():
                    continue
                obj = np.load(os.path.join(self.root, info["path"])).copy()
                obj[:, :3] += box[0, :3]
                new_boxes.append(box[0])
                new_labels.append(classes.index(cls))
                new_points.append(obj)
                all_boxes = np.concatenate([all_boxes, box_pad_like(box, all_boxes)], 0)
                taken += 1

        if not new_boxes:
            return points, boxes, labels
        nb = np.stack(new_boxes)
        inside = points_in_boxes(points[:, :3].astype(np.float32), nb)
        points = points[inside < 0]
        np_new = np.concatenate(new_points, axis=0)
        if np_new.shape[1] < points.shape[1]:
            np_new = np.concatenate(
                [np_new, np.zeros((len(np_new), points.shape[1] - np_new.shape[1]), np.float32)], 1)
        points = np.concatenate([points, np_new[:, : points.shape[1]]], 0)
        nb_full = box_pad_like(nb, boxes)
        boxes = np.concatenate([boxes, nb_full], 0) if len(boxes) else nb_full
        labels = np.concatenate([labels, np.asarray(new_labels, labels.dtype if len(labels) else np.int64)])
        return points, boxes, labels


def box_pad_like(src: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """[N, 7] boxes zero-padded to ref's trailing width (velocity)."""
    want = ref.shape[1] if ref.ndim == 2 and ref.shape[1] > 7 else src.shape[1]
    if src.shape[1] >= want:
        return src[:, :want]
    return np.concatenate([src, np.zeros((len(src), want - src.shape[1]), src.dtype)], 1)


def train_pipeline(
    rec: Dict,
    classes: Sequence[str],
    rng: np.random.Generator,
    pc_range: Sequence[float] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
    sweeps_num: int = 9,
    sampler: Optional[GTDatabaseSampler] = None,
) -> Dict[str, np.ndarray]:
    """The BEVFusion lidar training pipeline in the order of
    configs/nuscenes/default.yaml: load the sweeps, paste, rotate / scale /
    translate, flip, the range filters, shuffle. Boxes gain the
    annotations' lidar-frame velocity (nan -> 0) as columns 7:9
    (nuscenes_dataset.py:352-356). Returns points, gt_bboxes_3d,
    gt_labels_3d and the composed lidar_aug_matrix (flip after rst), which
    the camera branch composes into cam2lidar."""
    points = load_points_multisweep(rec, sweeps_num=sweeps_num, rng=rng)
    boxes = np.asarray(rec["gt_bboxes_3d"], np.float32)
    vel = rec.get("gt_velocity")
    if vel is not None and len(boxes) and boxes.shape[1] == 7:
        vel = np.nan_to_num(np.asarray(vel, np.float32).reshape(-1, 2))
        boxes = np.concatenate([boxes, vel], 1)
    boxes, labels = object_name_filter(boxes, rec["gt_names"], classes)
    if sampler is not None:
        points, boxes, labels = sampler(points, boxes, labels, classes)
    points, boxes, M_rst = global_rot_scale_trans(points, boxes, rng)
    points, boxes, M_flip = random_flip_3d(points, boxes, rng)
    boxes, labels = object_range_filter(boxes, labels, pc_range)
    points = points_range_filter(points, pc_range)
    points = point_shuffle(points, rng)
    return {"points": points, "gt_bboxes_3d": boxes, "gt_labels_3d": labels,
            "lidar_aug_matrix": M_flip @ M_rst}


def grid_mask(images: np.ndarray, rng: np.random.Generator, prob: float = 0.7, ratio: float = 0.5,
              max_rotate: int = 1) -> np.ndarray:
    """Stripe-grid occlusion of [V, H, W, C] views (GridMask): bands of a
    random period zeroed in both axes, one mask for every view, turned by
    a random whole angle below max_rotate degrees (border 1)."""
    if rng.uniform() > prob:
        return images
    v, h, w = images.shape[:3]
    hh, ww = int(1.5 * h), int(1.5 * w)
    d = int(rng.integers(2, min(h, w)))
    band = min(max(int(d * ratio + 0.5), 1), d - 1)
    mask = np.ones((hh, ww), np.float32)
    st_h, st_w = int(rng.integers(d)), int(rng.integers(d))
    for i in range(hh // d):
        s = d * i + st_h
        mask[s:min(s + band, hh), :] = 0
    for i in range(ww // d):
        s = d * i + st_w
        mask[:, s:min(s + band, ww)] = 0
    if max_rotate > 1:
        r = float(rng.integers(max_rotate))
        M = imgproc.get_rotation_matrix_2d((ww / 2, hh / 2), r, 1.0)
        mask = imgproc.warp_affine_linear(mask, M, (ww, hh), border_value=1.0)
    mask = mask[(hh - h) // 2:(hh - h) // 2 + h, (ww - w) // 2:(ww - w) // 2 + w]
    return images * mask[None, :, :, None]


def object_noise(
    points: np.ndarray,
    boxes: np.ndarray,
    rng: np.random.Generator,
    translation_std: Sequence[float] = (0.25, 0.25, 0.25),
    rot_range: Sequence[float] = (-0.15707963, 0.15707963),
) -> Tuple[np.ndarray, np.ndarray]:
    """Each GT box and its interior points turned about its centre and
    moved, unless the moved box would meet another (ObjectNoise,
    noise_per_object_v3_ with one try)."""
    from mobi_tpu_torch.native import points_in_boxes

    if not len(boxes):
        return points, boxes
    points = points.copy()
    boxes = boxes.copy()
    inside = points_in_boxes(points[:, :3].astype(np.float32), boxes[:, :7].astype(np.float32))
    for j in range(len(boxes)):
        trans = rng.normal(scale=translation_std, size=3)
        ang = rng.uniform(*rot_range)
        cand = boxes[j].copy()
        cand[:3] += trans
        cand[6] += ang
        others = np.delete(boxes, j, axis=0)
        if len(others) and _bev_collision(cand[None, :7], others[:, :7]).any():
            continue
        sel = inside == j
        if sel.any():
            c, s = np.cos(ang), np.sin(ang)
            rel = points[sel, :2] - boxes[j, :2]
            points[sel, 0] = rel[:, 0] * c - rel[:, 1] * s + boxes[j, 0]
            points[sel, 1] = rel[:, 0] * s + rel[:, 1] * c + boxes[j, 1]
            points[sel, :3] += trans
        boxes[j] = cand
    return points, boxes


def frame_dropout(points: np.ndarray, rng: np.random.Generator, prob: float = 0.5,
                  time_dim: int = 4) -> np.ndarray:
    """Whole previous sweeps dropped by their time lag (FrameDropout); the
    keyframe (lag 0) stays."""
    keep_offsets = [off for off in np.unique(points[:, time_dim]) if off == 0 or rng.uniform() > prob]
    return points[np.isin(points[:, time_dim], keep_offsets)]


def point_sample(points: np.ndarray, num_points: int, rng: np.random.Generator) -> np.ndarray:
    """A fixed number of points drawn at random, with replacement only when
    the cloud has fewer (PointSample)."""
    choice = rng.choice(len(points), num_points, replace=len(points) < num_points)
    return points[choice]


def background_points_filter(points: np.ndarray, boxes: np.ndarray,
                             bbox_enlarge_range: float = 0.4) -> np.ndarray:
    """Points inside the boxes grown by bbox_enlarge_range a side but outside
    the boxes dropped (BackgroundPointsFilter)."""
    from mobi_tpu_torch.native import points_in_boxes

    if not len(boxes):
        return points
    p3 = points[:, :3].astype(np.float32)
    b7 = boxes[:, :7].astype(np.float32)
    enlarged = b7.copy()
    enlarged[:, 3:6] += 2 * bbox_enlarge_range
    in_orig = points_in_boxes(p3, b7) >= 0
    in_big = points_in_boxes(p3, enlarged) >= 0
    return points[in_orig | ~in_big]


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
    """Per-view resize, crop, flip and rotation with the 4x4
    post-homography `img_aug_matrix` the LSS transform consumes
    (ImageAug3D). Training (is_train with an rng) draws, per view, the
    scale in resize_lim, a flip, a rotation in rot_lim degrees, the bottom
    crop and the horizontal crop; otherwise each view is resized by
    mean(resize_lim), centre-cropped horizontally and bottom-cropped by
    mean(bot_pct_lim). images: [V, H, W, C] float; returns (aug_images
    [V, fH, fW, C], img_aug_matrix [V, 4, 4])."""
    v = images.shape[0]
    H, W = images.shape[1:3]
    fH, fW = final_dim
    out_imgs = np.empty((v, fH, fW, images.shape[3]), images.dtype)
    out_mats = np.empty((v, 4, 4), np.float32)
    for i in range(v):
        if is_train and rng is not None:
            resize = rng.uniform(*resize_lim)
            flip = rand_flip and bool(rng.integers(2))
            rotate = rng.uniform(*rot_lim)
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - rng.uniform(*bot_pct_lim)) * newH) - fH
            crop_w = int(rng.uniform(0, max(0, newW - fW)))
        else:
            resize = float(np.mean(resize_lim))
            flip, rotate = False, 0.0
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - np.mean(bot_pct_lim)) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
        img = imgproc.resize_linear(images[i], newH, newW)
        canvas = np.zeros((fH, fW, images.shape[3]), images.dtype)
        # PIL crop semantics: a negative offset pads with black, so the patch
        # lands at output row/col -crop
        y0, x0 = max(crop_h, 0), max(crop_w, 0)
        oy, ox = -min(crop_h, 0), -min(crop_w, 0)
        patch = img[y0:crop_h + fH, x0:crop_w + fW]
        canvas[oy:oy + patch.shape[0], ox:ox + patch.shape[1]] = patch
        if flip:
            canvas = canvas[:, ::-1]
        if rotate:
            M = imgproc.get_rotation_matrix_2d((fW / 2, fH / 2), -rotate, 1.0)
            canvas = imgproc.warp_affine_linear(canvas, M, (fW, fH))
        out_imgs[i] = canvas

        rot = np.eye(2) * resize
        tran = -np.asarray([crop_w, crop_h], np.float64)
        if flip:
            A = np.asarray([[-1.0, 0.0], [0.0, 1.0]])
            rot = A @ rot
            tran = A @ tran + np.asarray([fW, 0.0])
        theta = rotate / 180.0 * np.pi
        A = np.asarray([[np.cos(theta), np.sin(theta)], [-np.sin(theta), np.cos(theta)]])
        b = np.asarray([fW, fH]) / 2.0
        b = A @ (-b) + b
        rot = A @ rot
        tran = A @ tran + b
        mat = np.eye(4, dtype=np.float32)
        mat[:2, :2] = rot
        mat[:2, 3] = tran
        out_mats[i] = mat
    return out_imgs, out_mats
