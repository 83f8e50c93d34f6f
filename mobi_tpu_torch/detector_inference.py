"""Run the BEVFusion detector over (edited) nuScenes scenes and write a
nuScenes-submission results.json (mobi_tpu detector_inference.py; the
inference half of the reference's `bevfusion/tools/test.py`:
nuscenes_dataset.py:380-445 _format_bbox + :630-700 output_to_nusc_box /
lidar_nusc_box_to_global).

The checkpoint is a reference-layout `.pth` ({"state_dict": ...}, mmdet3d
names), loaded strict into `models.bevfusion.BEVFusionDetector`; a fuser is
built exactly when the checkpoint has one. The host prep of sample i + 1
(dataset load, multi-sweep aggregation, view resize, voxelization, rulebook
planning, sparse depth maps, the LSS frustum's cells, the copies to the
card) runs in a thread while the card runs sample i.

Box conventions:
  * "second": what a reference checkpoint predicts: dims (w, l, h), a
    SECOND-format yaw; yaw_nusc = -yaw - pi/2 (nuscenes_dataset.py:652).
  * "nusc": dims (l, w, h) and the nuScenes lidar-frame yaw, what a
    detector trained with the JAX package's own pipeline predicts.
"""
from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

DET_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)

_DEFAULT_ATTR = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked", "bicycle": "cycle.without_rider",
    "barrier": "", "traffic_cone": "",
}


def _attr_for(name: str, vx: float, vy: float) -> str:
    """mmdet3d's speed-based attribute rule (nuscenes_dataset.py:401-422)."""
    if np.hypot(vx, vy) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return _DEFAULT_ATTR[name]
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return _DEFAULT_ATTR[name]


def _yaw_to_quat(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return [
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ]


def _rot_to_quat(R: np.ndarray) -> List[float]:
    """Shepperd's largest-pivot extraction — numerically stable for all
    rotations (the trace-only formula degenerates near 180-degree yaw,
    which real ego poses do hit)."""
    t = np.trace(R)
    if t > max(R[0, 0], R[1, 1], R[2, 2]):
        s = 2.0 * np.sqrt(1.0 + t)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s,
             (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = 2.0 * np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2])
        q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s,
             (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
    elif R[1, 1] >= R[2, 2]:
        s = 2.0 * np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2])
        q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
             0.25 * s, (R[1, 2] + R[2, 1]) / s]
    else:
        s = 2.0 * np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1])
        q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    return [float(v) for v in q]


def detections_to_nusc_results(
    decoded: Dict[str, np.ndarray],
    sample_token: str,
    lidar2global: np.ndarray,
    box_convention: str = "second",
    class_names: Sequence[str] = DET_CLASSES,
    score_threshold: float = 0.05,
    max_boxes: int = 500,
) -> List[dict]:
    """decoded: {"bboxes" [P, 9] (x, y, z_bottom, d0, d1, dz, yaw, vx, vy),
    "scores" [P], "labels" [P], "keep" [P]} in the keyframe lidar frame ->
    nuScenes submission entries in the global frame."""
    boxes = np.asarray(decoded["bboxes"], np.float64)
    scores = np.asarray(decoded["scores"], np.float64)
    labels = np.asarray(decoded["labels"], np.int64)
    keep = np.asarray(decoded["keep"], bool) & (scores > score_threshold)
    order = np.argsort(-scores * keep)[:max_boxes]
    R = np.asarray(lidar2global)[:3, :3]
    t = np.asarray(lidar2global)[:3, 3]
    q_l2g = _rot_to_quat(R)

    out = []
    for i in order:
        if not keep[i]:
            continue
        b = boxes[i]
        if box_convention == "second":
            w_, l_, h_ = b[3], b[4], b[5]
            yaw = -b[6] - np.pi / 2
        else:
            l_, w_, h_ = b[3], b[4], b[5]
            yaw = b[6]
        center_l = np.array([b[0], b[1], b[2] + h_ / 2.0])
        center_g = R @ center_l + t
        quat = _quat_mul(q_l2g, _yaw_to_quat(float(yaw)))
        vel_g = R[:2, :2] @ b[7:9]
        name = class_names[int(labels[i])]
        out.append(
            {
                "sample_token": sample_token,
                "translation": [float(x) for x in center_g],
                "size": [float(w_), float(l_), float(h_)],
                "rotation": quat,
                "velocity": [float(vel_g[0]), float(vel_g[1])],
                "detection_name": name,
                "detection_score": float(scores[i]),
                "attribute_name": _attr_for(name, vel_g[0], vel_g[1]),
            }
        )
    return out


def load_checkpoint_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference detector `.pth` -> its state dict (the `state_dict` entry
    when there is one)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["state_dict"] if "state_dict" in ckpt else ckpt


def build_detector(state_dict, use_camera: bool, voxel_size=(0.075, 0.075, 0.2),
                   pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0), image_size=(256, 704), device=None):
    """The detector for `state_dict` at this grid, loaded strict."""
    from mobi_tpu_torch.models.bevfusion import BEVFusionDetector, has_fuser

    lss_kwargs = None
    if use_camera:
        # the FPN's stride-8 level feeds the LSS transform (the reference's
        # swint det config: image (256, 704) -> features (32, 88))
        lss_kwargs = dict(image_size=tuple(image_size), feature_size=(image_size[0] // 8, image_size[1] // 8))
    model = BEVFusionDetector(
        use_camera=use_camera, lss_kwargs=lss_kwargs, fuser=has_fuser(state_dict),
        head_kwargs=dict(voxel_size=tuple(voxel_size[:2]), pc_range=tuple(pc_range[:2])), device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def camera_inputs(model, ex: Dict) -> Dict[str, torch.Tensor]:
    """A dataset item's camera arguments on the model's device: the views
    NCHW, the sparse depth maps of its cloud, and the LSS frustum's cells,
    computed on the host from camera2lidar and the 3x3 intrinsics."""
    from mobi_tpu_torch.models.bevfusion import build_sparse_depth_map

    iH, iW = ex["images"].shape[1:3]
    cells = model.encoders["camera"]["vtransform"].cells(ex["camera2lidar"], ex["camera_intrinsics"][:, :3, :3])
    return dict(
        images=torch.from_numpy(np.ascontiguousarray(ex["images"].transpose(0, 3, 1, 2))).to(model.device),
        depth_map=torch.from_numpy(build_sparse_depth_map(ex["points"], ex["lidar2image"], (iH, iW))).to(model.device),
        cells=cells.to(model.device),
    )


def detector_inputs(model, ex: Dict, voxel_size, pc_range) -> tuple:
    """One dataset item -> the detector's arguments on its device:
    ((feats, plans, out_coords, out_shape), camera kwargs)."""
    from mobi_tpu_torch.models.bevfusion import prepare_lidar_inputs

    lidar = prepare_lidar_inputs(ex["points"], voxel_size=voxel_size, pc_range=pc_range, device=model.device)
    return lidar, camera_inputs(model, ex) if model.use_camera else {}


def run_detector(
    dataroot: str,
    checkpoint: str,
    out_path: str,
    version: str = "v1.0-mini",
    edited_samples_path: Optional[str] = None,
    sweeps_num: int = 10,
    use_camera: bool = False,
    box_convention: str = "second",
    max_samples: Optional[int] = None,
    score_threshold: float = 0.05,
    voxel_size=(0.075, 0.075, 0.2),
    pc_range=(-54.0, -54.0, -5.0, 54.0, 54.0, 3.0),
    image_size=(256, 704),
    image_resize: Optional[float] = None,
    verbose: bool = False,
    device=None,
    timings: Optional[List[dict]] = None,
) -> str:
    """Load a reference-format detector checkpoint, run it over the dataset
    (lidar-only by default; camera fusion when `use_camera`) on `device`
    (CUDA unless named), and write a nuScenes results.json. Returns the
    path. `timings`, when given, gets one dict a sample: the host seconds
    its prep took in the prefetch thread, the seconds the main thread
    waited for it, the seconds of the forward and decode up to the boxes
    on the host, and the voxel count."""
    from mobi_tpu_torch.data.detection_dataset import DetectionSceneDataset

    model = build_detector(load_checkpoint_state_dict(checkpoint), use_camera, voxel_size, pc_range,
                           image_size, device)
    ds = DetectionSceneDataset(
        dataroot, version, edited_samples_path=edited_samples_path, load_images=use_camera,
        sweeps_num=sweeps_num, image_size=tuple(image_size) if use_camera else None,
        image_resize=image_resize)
    n = len(ds) if max_samples is None else min(len(ds), max_samples)

    def host_prep(i):
        t0 = time.perf_counter()
        ex = ds[i]
        inputs = detector_inputs(model, ex, voxel_size, pc_range)
        return ex, inputs, time.perf_counter() - t0

    results: Dict[str, List[dict]] = {}
    with ThreadPoolExecutor(max_workers=1) as pool, torch.no_grad():
        fut = pool.submit(host_prep, 0) if n > 0 else None
        for i in range(n):
            t0 = time.perf_counter()
            ex, (lidar, kwargs), host_s = fut.result()
            t1 = time.perf_counter()
            if i + 1 < n:
                fut = pool.submit(host_prep, i + 1)
            decoded = model.decode(model(*lidar, **kwargs))
            decoded = {k: v[0].cpu().numpy() for k, v in decoded.items()}  # batch of 1
            t2 = time.perf_counter()
            results[ex["sample_token"]] = detections_to_nusc_results(
                decoded, ex["sample_token"], ex["lidar2global"], box_convention=box_convention,
                score_threshold=score_threshold)
            if timings is not None:
                timings.append({"host_s": host_s, "wait_s": t1 - t0, "forward_s": t2 - t1,
                                "voxels": int(lidar[0].shape[0])})
            if verbose:
                print(f"# sample {i + 1}/{n}: {time.perf_counter() - t0:.2f}s "
                      f"({len(results[ex['sample_token']])} boxes)", flush=True)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"meta": {"use_camera": use_camera, "use_lidar": True, "use_radar": False,
                            "use_map": False, "use_external": False},
                   "results": results}, f)
    return out_path
