"""Synthetic mini-database fabricator (mobi_tpu data/synthetic.py).

Writes an object CSV + scene pkl + range npys + camera frames with the
schema the preprocessing pipeline emits, so the dataset and the inference
bench run end to end without nuScenes on disk. The same draws from the same
seed as the JAX builder give the same npys, pickle fields and CSV rows; the
camera frames are PNGs (`<token>_cam<i>.png`, the pixels the JAX builder
encodes as JPEG), since the port has no JPEG encoder.

`build_synthetic_nuscenes_raw` fabricates a raw nuScenes tree (JSON tables,
.pcd.bin sweeps, camera frames) for the preprocessing CLI and the detection
eval.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Sequence

import numpy as np

from mobi_tpu_torch.data import range_projection as rp
from mobi_tpu_torch.data.geometry import points_in_bbox_corners, project_to_image
from mobi_tpu_torch.data.image_io import encode_png, write_png
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


def build_synthetic_nuscenes_raw(
    root: str,
    num_scenes: int = 1,
    samples_per_scene: int = 2,
    version: str = "v1.0-mini",
    img_w: int = 400,
    img_h: int = 225,
    seed: int = 0,
) -> str:
    """Fabricate a minimal raw nuScenes layout (JSON tables + .pcd.bin +
    camera frames) for exercising NuScenesTables + build_pbe_database without
    the real dataset. Returns the dataroot.

    The draws from `seed` are the JAX function's, so the tables and clouds
    are its bytes; the camera frames hold the same uint8 pixels, written as
    PNG under nuScenes' `.jpg` names (the port has no JPEG encoder;
    `image_io.read_image` picks the decoder by the magic bytes, as PIL
    does)."""
    import json

    rng = np.random.default_rng(seed)
    tdir = os.path.join(root, version)
    os.makedirs(tdir, exist_ok=True)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)

    def tok(prefix, i):
        return f"{prefix}_{i:010d}"

    categories = [
        {"token": tok("cat", 0), "name": "vehicle.car"},
        {"token": tok("cat", 1), "name": "human.pedestrian.adult"},
    ]
    sensors = [{"token": tok("sens", 0), "channel": "LIDAR_TOP", "modality": "lidar"}]
    for ci, ch in enumerate(CAM_TYPES):
        sensors.append(
            {"token": tok("sens", ci + 1), "channel": ch, "modality": "camera"}
        )

    # one calibrated sensor per physical sensor: lidar at identity, cameras
    # looking along azimuth ci*60deg
    calibrated = [
        {
            "token": tok("cs", 0),
            "sensor_token": tok("sens", 0),
            "translation": [0, 0, 1.8],
            "rotation": [1, 0, 0, 0],
            "camera_intrinsic": [],
        }
    ]
    f = 300.0
    for ci in range(6):
        a = ci * np.pi / 3
        # camera axes: z forward (azimuth a), x right, y down
        # rotation matrix columns = camera axes in ego frame
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        right = np.array([np.sin(a), -np.cos(a), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        R = np.stack([right, down, fwd], axis=1)
        # rotation matrix -> quaternion (w, x, y, z)
        t = np.trace(R)
        w = np.sqrt(max(1 + t, 1e-12)) / 2
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
        calibrated.append(
            {
                "token": tok("cs", ci + 1),
                "sensor_token": tok("sens", ci + 1),
                "translation": [0, 0, 1.6],
                "rotation": [float(w), float(x), float(y), float(z)],
                "camera_intrinsic": [
                    [f, 0, img_w / 2], [0, f, img_h / 2], [0, 0, 1]
                ],
            }
        )

    logs, scenes_t, samples_t, sds, egos, anns, insts = [], [], [], [], [], [], []
    visibility = [{"token": "4", "level": "v80-100", "description": ""}]
    ego_i = sd_i = ann_i = inst_i = 0
    last_ann_of_inst: dict = {}  # instance_token -> index into anns

    for s in range(num_scenes):
        logs.append(
            {
                "token": tok("log", s),
                "location": "boston-seaport",
                "description": "sunny day" if s % 2 == 0 else "rain night",
            }
        )
        sample_tokens = [
            tok("samp", s * 100 + i) for i in range(samples_per_scene)
        ]
        scenes_t.append(
            {
                "token": tok("scene", s),
                "log_token": tok("log", s),
                "name": f"scene-{s:04d}",
                "description": "sunny" if s % 2 == 0 else "rain night",
                "first_sample_token": sample_tokens[0],
                "last_sample_token": sample_tokens[-1],
                "nbr_samples": samples_per_scene,
            }
        )
        for i, st in enumerate(sample_tokens):
            ts = 1_500_000_000_000_000 + s * 10_000_000 + i * 500_000
            samples_t.append(
                {
                    "token": st,
                    "scene_token": tok("scene", s),
                    "timestamp": ts,
                    "next": sample_tokens[i + 1] if i + 1 < len(sample_tokens) else "",
                    "prev": sample_tokens[i - 1] if i > 0 else "",
                }
            )
            ego_tok = tok("ego", ego_i); ego_i += 1
            egos.append(
                {"token": ego_tok, "translation": [0, 0, 0], "rotation": [1, 0, 0, 0],
                 "timestamp": ts}
            )

            # objects
            boxes = []
            for o in range(2):
                cls = o % 2
                size = [1.9, 4.5, 1.6] if cls == 0 else [0.7, 0.7, 1.8]  # (w,l,h)
                az = rng.uniform(-0.4, 0.4)
                dist = rng.uniform(8, 20)
                center = [dist * np.cos(az), dist * np.sin(az), 0.9]
                boxes.append((center, size, cls))
                ann_tok = tok("ann", ann_i); ann_i += 1
                inst_tok = tok("inst", inst_i + o + s * 10)
                prev_idx = last_ann_of_inst.get(inst_tok)
                anns.append(
                    {
                        "token": ann_tok,
                        "sample_token": st,
                        "instance_token": inst_tok,
                        "translation": center,
                        "size": size,
                        "rotation": [1, 0, 0, 0],
                        "num_lidar_pts": 500,
                        "visibility_token": "4",
                        "prev": anns[prev_idx]["token"] if prev_idx is not None else "",
                        "next": "",
                    }
                )
                if prev_idx is not None:
                    anns[prev_idx]["next"] = ann_tok
                last_ann_of_inst[inst_tok] = len(anns) - 1
                if not any(x["token"] == inst_tok for x in insts):
                    insts.append(
                        {
                            "token": inst_tok,
                            "category_token": categories[cls]["token"],
                        }
                    )

            # lidar sweep: ground + object clusters (in lidar frame: ego z-1.8)
            n = 8000
            r = rng.uniform(2.5, 50, n)
            azp = rng.uniform(-np.pi, np.pi, n)
            pts = np.stack(
                [r * np.cos(azp), r * np.sin(azp), rng.uniform(-1.85, -1.75, n)], 1
            )
            for center, size, _ in boxes:
                m = 500
                offs = rng.uniform(-0.45, 0.45, (m, 3)) * np.array(
                    [size[1], size[0], size[2]]
                )
                c_lidar = np.array(center) - np.array([0, 0, 1.8])
                pts = np.concatenate([pts, c_lidar + offs], 0)
            inten = rng.uniform(0, 255, len(pts)).astype(np.float32)
            ring = np.zeros(len(pts), np.float32)
            arr = np.concatenate(
                [pts.astype(np.float32), inten[:, None], ring[:, None]], 1
            )
            lidar_file = f"samples/LIDAR_TOP_{st}.pcd.bin"
            arr.tofile(os.path.join(root, lidar_file))
            # two previous non-keyframe sweeps (~50ms apart, same pose) so
            # multi-sweep loaders have real sweep chains to aggregate
            sweep_toks = []
            for k in range(2):
                sw_ts = ts - 50_000 * (k + 1)
                n_sw = 300
                sw_pts = np.concatenate(
                    [
                        rng.uniform(-40, 40, (n_sw, 3)).astype(np.float32),
                        rng.uniform(0, 255, (n_sw, 1)).astype(np.float32),
                        np.zeros((n_sw, 1), np.float32),
                    ],
                    1,
                )
                sw_file = f"sweeps/LIDAR_TOP_{st}_{k}.pcd.bin"
                os.makedirs(os.path.join(root, "sweeps"), exist_ok=True)
                sw_pts.tofile(os.path.join(root, sw_file))
                sw_tok = tok("sd", sd_i); sd_i += 1
                sds.append(
                    {
                        "token": sw_tok,
                        "sample_token": st,
                        "calibrated_sensor_token": tok("cs", 0),
                        "ego_pose_token": ego_tok,
                        "filename": sw_file,
                        "is_key_frame": False,
                        "fileformat": "pcd",
                        "timestamp": sw_ts,
                        "prev": "",
                        "next": "",
                    }
                )
                sweep_toks.append(sw_tok)
            sd_tok = tok("sd", sd_i); sd_i += 1
            sds.append(
                {
                    "token": sd_tok,
                    "sample_token": st,
                    "calibrated_sensor_token": tok("cs", 0),
                    "ego_pose_token": ego_tok,
                    "filename": lidar_file,
                    "is_key_frame": True,
                    "fileformat": "pcd",
                    "timestamp": ts,
                    "prev": sweep_toks[0],
                    "next": "",
                }
            )
            # chain: keyframe.prev -> sweep0, sweep0.prev -> sweep1
            for a, b in zip(sweep_toks[:-1], sweep_toks[1:]):
                next(s for s in sds if s["token"] == a)["prev"] = b
            for ci in range(6):
                img = rng.integers(40, 90, (img_h, img_w, 3), dtype=np.uint8)
                img_file = f"samples/{CAM_TYPES[ci]}_{st}.jpg"
                with open(os.path.join(root, img_file), "wb") as fimg:
                    fimg.write(encode_png(img))
                sd_tok = tok("sd", sd_i); sd_i += 1
                sds.append(
                    {
                        "token": sd_tok,
                        "sample_token": st,
                        "calibrated_sensor_token": tok("cs", ci + 1),
                        "ego_pose_token": ego_tok,
                        "filename": img_file,
                        "is_key_frame": True,
                        "fileformat": "jpg",
                        "timestamp": ts,
                    }
                )

    tables = {
        "category": categories,
        "visibility": visibility,
        "instance": insts,
        "sensor": sensors,
        "calibrated_sensor": calibrated,
        "ego_pose": egos,
        "log": logs,
        "scene": scenes_t,
        "sample": samples_t,
        "sample_data": sds,
        "sample_annotation": anns,
    }
    for name, table in tables.items():
        with open(os.path.join(tdir, f"{name}.json"), "w") as fjson:
            json.dump(table, fjson)
    return root
