"""Minimal nuScenes table reader, devkit-free (mobi_tpu data/nuscenes_tables.py).

The preprocessing path's table layer (the nuscenes-devkit's table loader and
the mmdet3d converter's record walk): reads the raw JSON tables, resolves sensor
calibration/ego-pose chains, and yields per-sample records with camera paths,
lidar->image transforms, and 3D boxes in the lidar frame.

Also implements the MObI devkit patch semantics: `edited_samples_path`
swaps edited sensor files into the sample records
(the devkit's nuscenes.py:127-149).

Box corner order follows the mmdet3d convention the reference's downstream
consumers assume: corners_norm = [(0,0,0),(0,0,1),(0,1,1),(0,1,0),
(1,0,0),(1,0,1),(1,1,1),(1,1,0)] over (x=length, y=width, z=height), origin
at the bottom center.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

CAM_ORDER = [
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_BACK_RIGHT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_FRONT_LEFT",
]

CLASS_MAP = {
    "vehicle.car": "car",
    "vehicle.truck": "truck",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.construction": "construction_vehicle",
    "vehicle.trailer": "trailer",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
}

_CORNERS_NORM = np.array(
    [
        [0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
        [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0],
    ],
    dtype=np.float64,
) - np.array([0.5, 0.5, 0.0])


def quat_to_rot(q) -> np.ndarray:
    """nuScenes quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _pose_mat(rec) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(rec["rotation"])
    m[:3, 3] = rec["translation"]
    return m


def box7d_to_corners(box7d: np.ndarray) -> np.ndarray:
    """[..., 7] (x, y, z_bottom, l, w, h, yaw) -> [..., 8, 3] corners."""
    box7d = np.asarray(box7d, dtype=np.float64)
    single = box7d.ndim == 1
    if single:
        box7d = box7d[None]
    dims = box7d[:, 3:6]
    corners = _CORNERS_NORM[None] * dims[:, None, :]
    yaw = box7d[:, 6]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], -2
    )  # [N, 2, 2]
    xy = np.einsum("nij,nkj->nki", rot, corners[..., :2])
    corners = np.concatenate([xy, corners[..., 2:]], -1)
    corners = corners + box7d[:, None, :3]
    return corners[0] if single else corners


class NuScenesTables:
    def __init__(
        self,
        dataroot: str,
        version: str = "v1.0-mini",
        edited_samples_path: Optional[str] = None,
    ):
        self.dataroot = dataroot
        self.version = version
        self.tables: Dict[str, List[dict]] = {}
        self.index: Dict[str, Dict[str, dict]] = {}
        table_dir = os.path.join(dataroot, version)
        for name in [
            "category", "visibility", "instance", "sensor", "calibrated_sensor",
            "ego_pose", "log", "scene", "sample", "sample_data",
            "sample_annotation", "attribute",
        ]:
            path = os.path.join(table_dir, f"{name}.json")
            if name == "attribute" and not os.path.exists(path):
                self.tables[name] = []  # optional (synthetic test tables)
            else:
                with open(path) as f:
                    self.tables[name] = json.load(f)
            self.index[name] = {r["token"]: r for r in self.tables[name]}

        # per-sample sensor data (keyframes only)
        self._sample_sd: Dict[str, Dict[str, dict]] = {}
        for sd in self.tables["sample_data"]:
            if not sd["is_key_frame"]:
                continue
            cs = self.index["calibrated_sensor"][sd["calibrated_sensor_token"]]
            channel = self.index["sensor"][cs["sensor_token"]]["channel"]
            self._sample_sd.setdefault(sd["sample_token"], {})[channel] = sd

        self._sample_anns: Dict[str, List[dict]] = {}
        for ann in self.tables["sample_annotation"]:
            self._sample_anns.setdefault(ann["sample_token"], []).append(ann)

        # MObI patch: swap edited files in (devkit nuscenes.py:127-149)
        self._edited: Dict[str, str] = {}
        if edited_samples_path:
            root = os.path.join(dataroot, edited_samples_path)
            for dirpath, _, files in os.walk(root):
                for fname in files:
                    self._edited[fname.split(".")[0]] = os.path.join(dirpath, fname)

    def _file_path(self, sd: dict) -> str:
        path = os.path.join(self.dataroot, sd["filename"])
        stem = os.path.basename(sd["filename"]).split(".")[0]
        return self._edited.get(stem, path)

    def category_name(self, ann: dict) -> str:
        inst = self.index["instance"][ann["instance_token"]]
        return self.index["category"][inst["category_token"]]["name"]

    def samples_of_split(self) -> Iterator[dict]:
        for scene in self.tables["scene"]:
            token = scene["first_sample_token"]
            while token:
                sample = self.index["sample"][token]
                yield sample
                token = sample["next"]

    def box_velocity(
        self, ann_token: str, max_time_diff: float = 1.5
    ) -> np.ndarray:
        """Global-frame instance velocity from neighboring annotations
        (devkit nuscenes.py:403-449): centered difference over prev/next
        when both exist (allowing 2x the time window), one-sided otherwise;
        nan when unestimable."""
        ann = self.index["sample_annotation"][ann_token]
        has_prev = bool(ann.get("prev"))
        has_next = bool(ann.get("next"))
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.index["sample_annotation"][ann["prev"]] if has_prev else ann
        last = self.index["sample_annotation"][ann["next"]] if has_next else ann
        pos_diff = np.asarray(last["translation"]) - np.asarray(first["translation"])
        t_f = 1e-6 * self.index["sample"][first["sample_token"]]["timestamp"]
        t_l = 1e-6 * self.index["sample"][last["sample_token"]]["timestamp"]
        if has_prev and has_next:
            max_time_diff *= 2
        if t_l - t_f > max_time_diff or t_l == t_f:
            return np.array([np.nan, np.nan, np.nan])
        return pos_diff / (t_l - t_f)

    def sample_record(self, sample: dict) -> Dict[str, Any]:
        """Everything the preprocessing needs for one keyframe."""
        sds = self._sample_sd[sample["token"]]
        lidar_sd = sds["LIDAR_TOP"]
        lidar_cs = self.index["calibrated_sensor"][lidar_sd["calibrated_sensor_token"]]
        lidar_ego = self.index["ego_pose"][lidar_sd["ego_pose_token"]]
        lidar2ego = _pose_mat(lidar_cs)
        ego2global_l = _pose_mat(lidar_ego)
        lidar2global = ego2global_l @ lidar2ego
        global2lidar = np.linalg.inv(lidar2global)

        cam_types, image_paths, l2i, l2c, intrinsics = [], [], [], [], []
        for ch in CAM_ORDER:
            if ch not in sds:
                continue
            sd = sds[ch]
            cs = self.index["calibrated_sensor"][sd["calibrated_sensor_token"]]
            ego = self.index["ego_pose"][sd["ego_pose_token"]]
            cam2ego = _pose_mat(cs)
            ego2global_c = _pose_mat(ego)
            lidar2cam = np.linalg.inv(cam2ego) @ np.linalg.inv(ego2global_c) @ lidar2global
            K = np.eye(4)
            K[:3, :3] = np.asarray(cs["camera_intrinsic"])
            cam_types.append(ch)
            image_paths.append(self._file_path(sd))
            l2c.append(lidar2cam)
            l2i.append(K @ lidar2cam)
            intrinsics.append(K)

        boxes7d, corners, names, tokens, num_pts, vels = [], [], [], [], [], []
        for ann in self._sample_anns.get(sample["token"], []):
            name = CLASS_MAP.get(self.category_name(ann))
            if name is None:
                continue
            center_g = np.asarray(ann["translation"])
            rot_g = quat_to_rot(ann["rotation"])
            w, l, h = ann["size"]
            center_l = (global2lidar[:3, :3] @ center_g) + global2lidar[:3, 3]
            rot_l = global2lidar[:3, :3] @ rot_g
            yaw = np.arctan2(rot_l[1, 0], rot_l[0, 0])
            z_bottom = center_l[2] - h / 2
            box = np.array([center_l[0], center_l[1], z_bottom, l, w, h, yaw])
            boxes7d.append(box)
            corners.append(box7d_to_corners(box))
            names.append(name)
            tokens.append(ann["instance_token"])
            num_pts.append(ann.get("num_lidar_pts", 0))
            # global velocity rotated into the lidar frame, nan preserved
            # (reference nuscenes_converter.py:259-273)
            vel_g = self.box_velocity(ann["token"])
            vel_l = global2lidar[:3, :3] @ np.array([vel_g[0], vel_g[1], 0.0])
            vels.append(vel_l[:2])

        scene_rec = self.index["scene"][sample["scene_token"]]
        log = self.index["log"][scene_rec["log_token"]]
        sweeps = self.lidar_sweeps(sample)
        return {
            "sample_token": sample["token"],
            "timestamp": sample["timestamp"],
            "lidar_path": self._file_path(lidar_sd),
            "image_paths": image_paths,
            "cam_types": cam_types,
            "lidar2global": lidar2global,
            "lidar2image_transforms": np.stack(l2i) if l2i else np.zeros((0, 4, 4)),
            "lidar2camera_transforms": np.stack(l2c) if l2c else np.zeros((0, 4, 4)),
            "camera_intrinsics": np.stack(intrinsics) if intrinsics else np.zeros((0, 4, 4)),
            "gt_bboxes_3d": np.asarray(boxes7d).reshape(-1, 7),
            "gt_velocity": np.asarray(vels).reshape(-1, 2),
            "gt_bboxes_3d_corners": np.asarray(corners).reshape(-1, 8, 3),
            "gt_names": names,
            "ann_tokens": tokens,
            "num_lidar_pts": np.asarray(num_pts, np.int64),
            "location": log["location"],
            "description": scene_rec.get("description", ""),
            "sweeps": sweeps,
        }

    def lidar_sweeps(self, sample: dict, max_sweeps: int = 10) -> List[dict]:
        """Previous (non-keyframe) lidar sweeps for multi-sweep aggregation
        (reference nuscenes_converter.py obtain_sensor2top /
        LoadPointsFromMultiSweeps): each entry carries the file path, the
        sweep->keyframe-lidar 4x4 transform, and the time lag in seconds."""
        sds = self._sample_sd.get(sample["token"], {})
        if "LIDAR_TOP" not in sds:
            return []
        key_sd = sds["LIDAR_TOP"]
        key_cs = self.index["calibrated_sensor"][key_sd["calibrated_sensor_token"]]
        key_ego = self.index["ego_pose"][key_sd["ego_pose_token"]]
        global2key = np.linalg.inv(_pose_mat(key_ego) @ _pose_mat(key_cs))
        t0 = key_sd["timestamp"]

        sweeps = []
        token = key_sd.get("prev", "")
        while token and len(sweeps) < max_sweeps:
            sd = self.index["sample_data"][token]
            cs = self.index["calibrated_sensor"][sd["calibrated_sensor_token"]]
            ego = self.index["ego_pose"][sd["ego_pose_token"]]
            sweep2key = global2key @ _pose_mat(ego) @ _pose_mat(cs)
            sweeps.append(
                {
                    "data_path": self._file_path(sd),
                    "sweep2lidar": sweep2key,
                    "time_lag": (t0 - sd["timestamp"]) * 1e-6,
                }
            )
            token = sd.get("prev", "")
        return sweeps


def load_lidar_points(path: str) -> np.ndarray:
    """nuScenes .pcd.bin (float32 x,y,z,intensity,ring) or .npy -> [N, 4]."""
    if path.endswith(".npy"):
        arr = np.load(path)
        return arr[:, :4]
    arr = np.fromfile(path, dtype=np.float32).reshape(-1, 5)
    return arr[:, :4]
