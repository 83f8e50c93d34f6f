"""Synthetic mini-database fabricator (mobi_tpu data/synthetic.py).

Writes an object CSV + scene pkl + range npys + camera frames with the
schema the preprocessing pipeline emits, so the dataset and the inference
bench run end to end without nuScenes on disk. The same draws from the same
seed as the JAX builder give the same npys, pickle fields and CSV rows; the
camera frames are PNGs (`<token>_cam<i>.png`, the pixels the JAX builder
encodes as JPEG), since the port has no JPEG encoder.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from mobi_tpu_torch.data import range_projection as rp
from mobi_tpu_torch.data.geometry import points_in_bbox_corners, project_to_image
from mobi_tpu_torch.data.image_io import write_png
from mobi_tpu_torch.data.table import write_csv

CAM_TYPES = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT",
]


def _make_box(center, size, yaw=0.0):
    l, w, h = size
    base = np.array(
        [[l / 2, w / 2, 0], [l / 2, -w / 2, 0], [-l / 2, -w / 2, 0], [-l / 2, w / 2, 0]]
    )
    c, s = np.cos(yaw), np.sin(yaw)
    base[:, :2] = base[:, :2] @ np.array([[c, -s], [s, c]]).T
    bottom = base + np.array([center[0], center[1], center[2] - h / 2])
    return np.concatenate([bottom, bottom + [0, 0, h]], axis=0)


def _pinhole(cam_yaw: float, img_w=800, img_h=450, f=500.0):
    """lidar2image for a camera looking along azimuth `cam_yaw`."""
    c, s = np.cos(cam_yaw), np.sin(cam_yaw)
    # lidar -> camera: cam z = forward, x = right, y = down
    lidar2cam = np.array(
        [
            [-s, -c, 0, 0],     # x_right
            [0, 0, -1, 1.0],    # y_down (sensor 1m up)
            [c, -s, 0, 0],      # z_forward
            [0, 0, 0, 1],
        ]
    )
    K = np.array(
        [[f, 0, img_w / 2, 0], [0, f, img_h / 2, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    )
    return K @ lidar2cam


def build_synthetic_database(
    root: str,
    num_scenes: int = 2,
    objects_per_scene: int = 3,
    classes: Sequence[str] = ("car", "pedestrian"),
    img_w: int = 800,
    img_h: int = 450,
    num_erase: int = 2,
    seed: int = 0,
) -> Dict[str, str]:
    """Writes {root}/synthetic_dbinfos.csv, the scene pkl, the range npys
    and the camera frames as PNGs.

    Returns {"object_database_path": ..., "scene_database_path": ...}.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    scenes: Dict[str, dict] = {}
    rows: List[dict] = []

    for s in range(num_scenes):
        token = f"scene{s:04d}"
        sdir = os.path.join(root, token)
        os.makedirs(sdir, exist_ok=True)

        # ground-plane point cloud + a few object clusters
        n_ground = 20000
        r = rng.uniform(2.0, 50.0, n_ground)
        az = rng.uniform(-np.pi, np.pi, n_ground)
        ground = np.stack(
            [r * np.cos(az), r * np.sin(az), rng.uniform(-1.8, -1.6, n_ground)], 1
        )

        boxes, names = [], []
        pts_obj = []
        for o in range(objects_per_scene):
            cls = classes[o % len(classes)]
            size = (4.5, 1.9, 1.6) if cls == "car" else (0.7, 0.7, 1.8)
            azimuth = rng.uniform(-np.pi / 4, np.pi / 4)
            dist = rng.uniform(8, 25)
            center = np.array(
                [dist * np.cos(azimuth), dist * np.sin(azimuth), -1.0]
            )
            box = _make_box(center, size, yaw=rng.uniform(0, np.pi))
            boxes.append(box)
            names.append(cls)
            # dense points inside the box
            n = 600
            u = rng.uniform(0.05, 0.95, (n, 3))
            origin = box[0]
            e = np.stack([box[1] - origin, box[3] - origin, box[4] - origin])
            pts_obj.append(origin + u @ e)

        pts = np.concatenate([ground] + pts_obj, axis=0)
        intensity = rng.uniform(0, 255, len(pts))

        depth_n, inten, valid, pitch, yaw = rp.pcd_to_range(pts, intensity)

        # per-object instance masks via reprojection (reference
        # create_pbe_database.py:153-168)
        rec_pts, _, _ = rp.range_to_pcd(depth_n, pitch, yaw)
        inside = points_in_bbox_corners(rec_pts, np.stack(boxes))
        inst = np.full(depth_n.shape, -1, np.int32)
        flat_idx = np.flatnonzero(
            (rp.denormalize_depth(depth_n) > rp.DEPTH_MIN).reshape(-1)
            & (rp.denormalize_depth(depth_n) < rp.DEPTH_MAX).reshape(-1)
        )
        for oi in range(len(boxes)):
            inst.reshape(-1)[flat_idx[inside[:, oi]]] = oi

        paths = {}
        for name, arr in [
            ("depth", depth_n), ("intensity", inten),
            ("pitch", pitch), ("yaw", yaw), ("instance_mask", inst),
        ]:
            p = os.path.join(sdir, f"range_{name}.npy")
            np.save(p, arr)
            paths[name] = p
        # globally-unique basenames (real nuScenes sensor files are token-
        # named): the edited-samples swap resolves files by STEM, so
        # colliding basenames across scenes would all map to one edit
        lidar_p = os.path.join(sdir, f"{token}_lidar.npy")
        np.save(lidar_p, np.concatenate([pts, intensity[:, None]], 1).astype(np.float32))

        # camera frames: noise background + bright box region per camera
        image_paths, l2i, l2c = [], [], []
        for ci in range(6):
            cam_yaw = ci * np.pi / 3
            P = _pinhole(cam_yaw, img_w, img_h)
            img = rng.integers(40, 90, (img_h, img_w, 3), dtype=np.uint8)
            for box in boxes:
                xy = project_to_image(box, P, include_depth=True)
                if (xy[:, 2] > 0.5).all():
                    x1 = int(np.clip(xy[:, 0].min(), 0, img_w - 1))
                    x2 = int(np.clip(xy[:, 0].max(), 0, img_w - 1))
                    y1 = int(np.clip(xy[:, 1].min(), 0, img_h - 1))
                    y2 = int(np.clip(xy[:, 1].max(), 0, img_h - 1))
                    img[y1:y2, x1:x2] = rng.integers(120, 255, 3, dtype=np.uint8)
            p = os.path.join(sdir, f"{token}_cam{ci}.png")
            write_png(p, img)
            image_paths.append(p)
            l2i.append(P)
            l2c.append(np.eye(4))

        scenes[token] = {
            "gt_bboxes_3d_corners": np.stack(boxes).astype(np.float32),
            "gt_names": names,
            "lidar2image_transforms": np.stack(l2i).astype(np.float32),
            "lidar2camera_transforms": np.stack(l2c).astype(np.float32),
            "image_paths": image_paths,
            "cam_types": CAM_TYPES,
            "lidar_path": lidar_p,
            "range_depth_path": paths["depth"],
            "range_intensity_path": paths["intensity"],
            "range_pitch_path": paths["pitch"],
            "range_yaw_path": paths["yaw"],
            "range_instance_mask_path": paths["instance_mask"],
        }

        for oi, (box, cls) in enumerate(zip(boxes, names)):
            center = box.mean(0)
            # find the camera that sees the box
            best_cam, best_w, best_h = 0, 120, 120
            for ci in range(6):
                xy = project_to_image(box, scenes[token]["lidar2image_transforms"][ci],
                                      include_depth=True)
                if (xy[:, 2] > 0.5).all():
                    w = xy[:, 0].max() - xy[:, 0].min()
                    h = xy[:, 1].max() - xy[:, 1].min()
                    if 0 < xy[:, 0].min() and xy[:, 0].max() < img_w:
                        best_cam, best_w, best_h = ci, w, h
                        break
            d = np.linalg.norm(box, axis=1)
            rows.append(
                dict(
                    scene_token=token,
                    track_id=f"{token}_obj{oi}",
                    timestamp=1_500_000_000_000_000 + s,
                    object_class=cls,
                    scene_obj_idx=oi,
                    cam_idx=best_cam,
                    camera_visibility_mask=1.0,
                    min_distance=float(d.min()),
                    max_distance=float(d.max()),
                    reference_image_w=float(np.clip(best_w, 100, 1400)),
                    reference_image_h=float(np.clip(best_h, 100, 800)),
                    max_iou_overlap=0.0,
                    num_lidar_points=600,
                    is_raining=bool(s % 2),
                    is_night=False,
                    is_erase_box=False,
                )
            )

    # erase boxes: empty locations
    first = list(scenes.keys())[0]
    for e in range(num_erase):
        rows.append(
            dict(
                scene_token=first,
                track_id=f"erase{e}",
                timestamp=1_500_000_000_000_000,
                object_class=classes[e % len(classes)],
                scene_obj_idx=0,
                cam_idx=0,
                camera_visibility_mask=1.0,
                min_distance=10.0,
                max_distance=12.0,
                reference_image_w=200.0,
                reference_image_h=200.0,
                max_iou_overlap=0.0,
                num_lidar_points=600,
                is_raining=False,
                is_night=False,
                is_erase_box=True,
            )
        )

    csv_path = os.path.join(root, "synthetic_dbinfos.csv")
    write_csv(csv_path, list(rows[0]), list(enumerate(rows)))
    pkl_path = os.path.join(root, "synthetic_scene_infos.pkl")
    with open(pkl_path, "wb") as f:
        pickle.dump(scenes, f)
    return {
        "object_database_path": csv_path,
        "scene_database_path": pkl_path,
    }
