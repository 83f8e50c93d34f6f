"""nuScenes infos-pkl converter (mobi_tpu data/infos_converter.py): the
`create_nuscenes_infos` stage of the preprocessing CLI (mmdet3d's
tools/data_converter/nuscenes_converter.py:42-365), devkit-free.

Writes `{prefix}_infos_{train,val}.pkl` with the mmdet3d schema: per keyframe
lidar path + pose chain, per-camera sensor2lidar transforms + intrinsics,
lidar sweeps, and annotations as SECOND-format boxes
[x, y, z_center, w, l, h, -yaw - pi/2] with lidar-frame velocities,
num_lidar/radar_pts, valid_flag, detection-name mapping, category
descriptions and instance (ann) tokens.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from mobi_tpu_torch.data.nuscenes_tables import (
    CAM_ORDER,
    CLASS_MAP,
    NuScenesTables,
    quat_to_rot,
)

# official v1.0-mini scene split (devkit nuscenes/utils/splits.py)
MINI_TRAIN = (
    "scene-0061", "scene-0553", "scene-0655", "scene-0757", "scene-0796",
    "scene-1077", "scene-1094", "scene-1100",
)
MINI_VAL = ("scene-0103", "scene-0916")

# the converter's camera order differs from CAM_ORDER
CAM_TYPES_INFOS = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)


def _sensor2top(tables, sd: dict, l2e_t, l2e_r, e2g_t, e2g_r, sensor_type: str):
    """sensor->top-lidar transform record (nuscenes_converter.py
    obtain_sensor2top semantics)."""
    cs = tables.index["calibrated_sensor"][sd["calibrated_sensor_token"]]
    pose = tables.index["ego_pose"][sd["ego_pose_token"]]
    s2e_r = quat_to_rot(cs["rotation"])
    s2e_t = np.asarray(cs["translation"])
    se2g_r = quat_to_rot(pose["rotation"])
    se2g_t = np.asarray(pose["translation"])

    # R = (s2e @ e2g_sensor) @ inv(e2g_lidar) @ inv(l2e)  (row-vector form of
    # the reference's R.T chain)
    rot = (
        np.linalg.inv(l2e_r) @ np.linalg.inv(e2g_r) @ se2g_r @ s2e_r
    )
    trans = np.linalg.inv(l2e_r) @ np.linalg.inv(e2g_r) @ (
        se2g_r @ s2e_t + se2g_t - e2g_t
    ) - np.linalg.inv(l2e_r) @ l2e_t
    return {
        "data_path": tables._file_path(sd),
        "type": sensor_type,
        "sample_data_token": sd["token"],
        "sensor2ego_translation": cs["translation"],
        "sensor2ego_rotation": cs["rotation"],
        "ego2global_translation": pose["translation"],
        "ego2global_rotation": pose["rotation"],
        "timestamp": sd["timestamp"],
        "sensor2lidar_rotation": rot,
        "sensor2lidar_translation": trans,
    }


def _box_velocity(
    tables, ann: dict, max_time_diff: float = 1.5
) -> np.ndarray:
    """Instance velocity from neighboring annotations (devkit
    nuscenes.box_velocity): (pos_next - pos_prev) / dt, nan if unavailable."""
    return tables.box_velocity(ann["token"], max_time_diff=max_time_diff)


def create_nuscenes_infos(
    dataroot: str,
    out_dir: str,
    version: str = "v1.0-mini",
    info_prefix: str = "nuscenes",
    max_sweeps: int = 10,
    train_scene_names: Optional[Sequence[str]] = None,
    val_scene_names: Optional[Sequence[str]] = None,
) -> Dict[str, str]:
    tables = NuScenesTables(dataroot, version)
    if train_scene_names is None:
        if "mini" in version:
            train_scene_names, val_scene_names = MINI_TRAIN, MINI_VAL
        else:
            # default: everything to train unless a split is given
            train_scene_names = [s["name"] for s in tables.tables["scene"]]
            val_scene_names = val_scene_names or ()
    train_names = set(train_scene_names)
    val_names = set(val_scene_names or ())

    train_infos: List[dict] = []
    val_infos: List[dict] = []

    for sample in tables.samples_of_split():
        sds = tables._sample_sd[sample["token"]]
        lidar_sd = sds["LIDAR_TOP"]
        cs = tables.index["calibrated_sensor"][lidar_sd["calibrated_sensor_token"]]
        pose = tables.index["ego_pose"][lidar_sd["ego_pose_token"]]
        scene = tables.index["scene"][sample["scene_token"]]
        log = tables.index["log"][scene["log_token"]]

        l2e_r = quat_to_rot(cs["rotation"])
        l2e_t = np.asarray(cs["translation"])
        e2g_r = quat_to_rot(pose["rotation"])
        e2g_t = np.asarray(pose["translation"])
        g2l_r = np.linalg.inv(l2e_r) @ np.linalg.inv(e2g_r)

        info = {
            "lidar_path": tables._file_path(lidar_sd),
            "token": sample["token"],
            "sweeps": [],
            "cams": {},
            "lidar2ego_translation": cs["translation"],
            "lidar2ego_rotation": cs["rotation"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
            "timestamp": sample["timestamp"],
            "location": log["location"],
            "description": scene.get("description", ""),
        }

        for cam in CAM_TYPES_INFOS:
            if cam not in sds:
                continue
            cam_sd = sds[cam]
            cam_cs = tables.index["calibrated_sensor"][
                cam_sd["calibrated_sensor_token"]
            ]
            rec = _sensor2top(tables, cam_sd, l2e_t, l2e_r, e2g_t, e2g_r, cam)
            rec["camera_intrinsics"] = np.asarray(cam_cs["camera_intrinsic"])
            info["cams"][cam] = rec

        # lidar sweeps: walk prev non-keyframe sample_data records
        sd_rec = lidar_sd
        sweeps = []
        while len(sweeps) < max_sweeps and sd_rec.get("prev"):
            sd_rec = tables.index["sample_data"][sd_rec["prev"]]
            sweeps.append(
                _sensor2top(tables, sd_rec, l2e_t, l2e_r, e2g_t, e2g_r, "lidar")
            )
        info["sweeps"] = sweeps

        anns = tables._sample_anns.get(sample["token"], [])
        locs, dims, yaws, vels = [], [], [], []
        names, descs, nlp, nrp, tokens = [], [], [], [], []
        for ann in anns:
            cat = tables.category_name(ann)
            center_g = np.asarray(ann["translation"])
            center_l = g2l_r @ (center_g - e2g_t) - np.linalg.inv(l2e_r) @ l2e_t
            rot_l = g2l_r @ quat_to_rot(ann["rotation"])
            yaw = float(np.arctan2(rot_l[1, 0], rot_l[0, 0]))
            locs.append(center_l)
            dims.append(ann["size"])  # (w, l, h)
            yaws.append(yaw)
            velo = _box_velocity(tables, ann)
            velo = g2l_r @ np.nan_to_num(velo)
            vels.append(velo[:2])
            names.append(CLASS_MAP.get(cat, cat))
            descs.append(cat)
            nlp.append(int(ann.get("num_lidar_pts", 0)))
            nrp.append(int(ann.get("num_radar_pts", 0)))
            tokens.append(ann["instance_token"])

        n = len(anns)
        gt_boxes = (
            np.concatenate(
                [
                    np.asarray(locs).reshape(n, 3),
                    np.asarray(dims).reshape(n, 3),
                    -np.asarray(yaws).reshape(n, 1) - np.pi / 2,  # SECOND yaw
                ],
                axis=1,
            )
            if n else np.zeros((0, 7))
        )
        info["gt_boxes"] = gt_boxes
        info["gt_names"] = np.asarray(names)
        info["gt_name_descriptions"] = np.asarray(descs)
        info["gt_velocity"] = np.asarray(vels).reshape(n, 2)
        info["num_lidar_pts"] = np.asarray(nlp)
        info["num_radar_pts"] = np.asarray(nrp)
        info["valid_flag"] = (
            np.asarray(nlp) + np.asarray(nrp) > 0
        ).astype(bool)
        info["ann_tokens"] = np.asarray(tokens)

        # reference semantics (nuscenes_converter.py:297-301): train if the
        # scene is in the train split, else val
        if scene["name"] in train_names:
            train_infos.append(info)
        else:
            val_infos.append(info)

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for split, infos in (("train", train_infos), ("val", val_infos)):
        path = os.path.join(out_dir, f"{info_prefix}_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"infos": infos, "metadata": {"version": version}}, f)
        paths[split] = path
    return paths
