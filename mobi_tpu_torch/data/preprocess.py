"""Offline preprocessing: build the PbE object/scene databases from nuScenes
(mobi_tpu data/preprocess.py; the reference's
tools/data_converter/create_pbe_database.py:90-427, the only mandatory
offline dependency of MObI training). Host numpy, as in JAX; the image size
comes from the frame's header (`image_io.image_size`) and the object CSV is
written through `data/table.py`, so neither PIL nor pandas is needed:

  per keyframe:
    * project the lidar sweep to the 32x1096 range view and save
      depth/intensity/pitch/yaw npys (create_pbe_database.py:134-139);
    * build per-object range instance masks by re-projecting range pixels to
      3D and testing them against box corners (the pixel-label trick,
      :153-168);
    * for each camera: project boxes, compute 2D visibility percentage and
      frustum-IoU overlap, record per-object rows (:172-254);
  then:
    * synthesize erase boxes by transplanting boxes into other scenes with
      box+frustum collision rejection (:374-414, check_erase_bbox :259-273);
    * aggregate camera mask visibility across cameras (:417-420);
    * dump `{prefix}_dbinfos_pbe_{split}.csv` + `{prefix}_scene_infos_pbe_{split}.pkl`.

CLI:
  python -m mobi_tpu_torch.data.preprocess --dataroot /data/nuscenes \
      --version v1.0-mini --out-dir processed-data/nuscenes --split train
"""
from __future__ import annotations

import argparse
import copy
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from mobi_tpu_torch.data import range_projection as rp
from mobi_tpu_torch.data.geometry import (
    box_collision_test,
    fill_box_faces,
    frustum_collision_test,
    frustum_iou_matrix,
    get_frustum,
    points_in_bbox_corners,
    project_to_image,
)
from mobi_tpu_torch.data.image_io import image_size
from mobi_tpu_torch.data.nuscenes_tables import NuScenesTables, load_lidar_points
from mobi_tpu_torch.data.table import write_csv


def _area(b2d: np.ndarray) -> np.ndarray:
    return (b2d[:, 2] - b2d[:, 0]) * (b2d[:, 3] - b2d[:, 1])


def _mask_pixels(img_shape, corners, lidar2image) -> int:
    """Pixels covered by the projected 3D box (visibility aggregation uses
    the per-camera 3D mask pixel count, create_pbe_database.py:229,240)."""
    H, W = img_shape[:2]
    mask = np.zeros((H, W), dtype=np.uint8)
    coords = project_to_image(corners, lidar2image)
    fill_box_faces(mask, coords)
    return int(mask.sum())


def process_sample(
    rec: Dict[str, Any],
    database_save_path: str,
    image_shapes: Optional[List] = None,
):
    """One keyframe -> (scene_info, object rows)."""
    sample_idx = rec["sample_token"]
    corners_all = rec["gt_bboxes_3d_corners"]
    names = rec["gt_names"]
    num_obj = len(names)
    if num_obj == 0:
        return None, None

    is_raining = "rain" in rec["description"].lower()
    is_night = "night" in rec["description"].lower()
    city = rec["location"].split("-")[0]

    points = load_lidar_points(rec["lidar_path"])
    depth_n, inten, _, pitch, yaw = rp.pcd_to_range(points[:, :3], points[:, 3])

    paths = {
        k: os.path.join(database_save_path, f"sample-{sample_idx}_range_{k}.npy")
        for k in ("depth", "intensity", "pitch", "yaw", "instance_mask")
    }
    np.save(paths["depth"], depth_n)
    np.save(paths["intensity"], inten)
    np.save(paths["pitch"], pitch)
    np.save(paths["yaw"], yaw)

    # instance masks via the reprojection pixel-label trick
    pixel_label = np.arange(depth_n.size).reshape(depth_n.shape)
    pts_new, labels, _ = rp.range_to_pcd(depth_n, pitch, yaw, pixel_label)
    inside = points_in_bbox_corners(pts_new, corners_all)
    inside_orig = points_in_bbox_corners(points[:, :3], corners_all)
    inst = np.full(depth_n.size, -1.0)
    num_lidar_points = []
    for oi in range(num_obj):
        inst[labels[inside[:, oi]].astype(np.int64)] = oi
        num_lidar_points.append(int(inside_orig[:, oi].sum()))
    np.save(paths["instance_mask"], inst.reshape(depth_n.shape))

    scene_info = {
        "sample_idx": sample_idx,
        "timestamp": rec["timestamp"],
        "location": rec["location"],
        "description": rec["description"],
        "gt_bboxes_3d": rec["gt_bboxes_3d"],
        "gt_bboxes_3d_corners": corners_all,
        "gt_names": list(names),
        "range_depth_path": paths["depth"],
        "range_intensity_path": paths["intensity"],
        "range_pitch_path": paths["pitch"],
        "range_yaw_path": paths["yaw"],
        "range_instance_mask_path": paths["instance_mask"],
        "lidar2image_transforms": rec["lidar2image_transforms"],
        "lidar2camera_transforms": rec["lidar2camera_transforms"],
        "camera_intrinsics": rec["camera_intrinsics"],
        "cam_types": rec["cam_types"],
        "image_paths": rec["image_paths"],
        "lidar_path": rec["lidar_path"],
    }

    # spherical frustums once per sample (pipelines/utils.py:225-264)
    frustums = get_frustum(corners_all)

    rows: List[dict] = []
    for ci, l2i in enumerate(rec["lidar2image_transforms"]):
        if image_shapes is not None:
            H, W = image_shapes[ci][:2]
        else:
            W, H = image_size(rec["image_paths"][ci])

        coord = project_to_image(
            np.concatenate(list(corners_all), axis=0), l2i, include_depth=True
        ).reshape(num_obj, 8, 3)
        in_front = (coord[..., 2] > 0).all(axis=-1)
        if not in_front.any():
            continue

        # the per-camera visible subset, as in create_pbe_database.py:185-215:
        # frustum IoU is computed among the boxes visible in THIS camera only
        visible_idx = []
        for oi in np.nonzero(in_front)[0]:
            xy = coord[oi, :, :2]
            lo, hi = xy.min(0), xy.max(0)
            b2d = np.array([lo[0], lo[1], hi[0], hi[1]])
            b2d[0::2] = np.clip(b2d[0::2], 0, W - 1)
            b2d[1::2] = np.clip(b2d[1::2], 0, H - 1)
            if (b2d[2:] - b2d[:2] > 4).all():
                visible_idx.append(int(oi))
        if not visible_idx:
            continue
        sub = np.asarray(visible_idx)
        iou_mat = frustum_iou_matrix(frustums[sub])
        np.fill_diagonal(iou_mat, 0.0)
        max_iou_sub = dict(zip(visible_idx, iou_mat.max(axis=-1)))

        for oi in visible_idx:
            xy = coord[oi, :, :2]
            lo, hi = xy.min(0), xy.max(0)
            b2d_org = np.array([lo[0], lo[1], hi[0], hi[1]])
            b2d = b2d_org.copy()
            b2d[0::2] = np.clip(b2d[0::2], 0, W - 1)
            b2d[1::2] = np.clip(b2d[1::2], 0, H - 1)
            vis_pct = float(
                _area(b2d[None])[0] / max(_area(b2d_org[None])[0], 1e-9)
            )
            n_mask_px = _mask_pixels((H, W), corners_all[oi], l2i)
            dist = np.linalg.norm(corners_all[oi][:, :2], axis=1)
            rows.append(
                dict(
                    track_id=rec["ann_tokens"][oi],
                    scene_token=sample_idx,
                    timestamp=rec["timestamp"],
                    cam_type=rec["cam_types"][ci],
                    cam_idx=ci,
                    scene_obj_idx=int(oi),
                    object_class=names[oi],
                    camera_visibility_2d_box=vis_pct,
                    num_mask_pixels=n_mask_px,
                    max_iou_overlap=float(max_iou_sub[oi]),
                    reference_image_h=float(b2d[3] - b2d[1] + 1),
                    reference_image_w=float(b2d[2] - b2d[0] + 1),
                    num_lidar_points=num_lidar_points[oi],
                    city=city,
                    is_raining=is_raining,
                    is_night=is_night,
                    is_erase_box=False,
                    max_distance=float(dist.max()),
                    min_distance=float(dist.min()),
                )
            )
    return scene_info, rows


def check_erase_bbox(corners_all: np.ndarray) -> bool:
    """Last box is the candidate erase box; accept iff it neither overlaps an
    existing BEV footprint nor exceeds 0.7 frustum IoU with any existing
    frustum (create_pbe_database.py:259-273)."""
    frustums = get_frustum(corners_all)
    box_coll = box_collision_test(corners_all, corners_all)
    fr_coll = frustum_collision_test(frustums[:-1], frustums[-1:], thresh=0.7)
    n = len(corners_all)
    coll = box_coll.copy()
    coll[np.arange(n), np.arange(n)] = False
    last_hits = coll[-1].any() or coll[:, -1].any() or fr_coll.any()
    return not last_hits


def synthesize_erase_boxes(
    all_scene_infos: Dict[str, dict],
    all_rows: List[dict],
    num_target: int,
    rng: np.random.Generator,
    max_tries: int = 200000,
) -> List[dict]:
    erase = []
    scene_keys = list(all_scene_infos.keys())
    tries = 0
    while len(erase) < num_target and tries < max_tries:
        tries += 1
        row = all_rows[int(rng.integers(0, len(all_rows)))]
        scene_key = scene_keys[int(rng.integers(0, len(scene_keys)))]
        src = all_scene_infos[row["scene_token"]]
        tgt = all_scene_infos[scene_key]
        oi = row["scene_obj_idx"]

        cand_corners = np.concatenate(
            [tgt["gt_bboxes_3d_corners"], src["gt_bboxes_3d_corners"][[oi]]]
        )
        if not check_erase_bbox(cand_corners):
            continue
        cand_7d = np.concatenate(
            [tgt["gt_bboxes_3d"], src["gt_bboxes_3d"][[oi]]]
        )
        tgt["gt_bboxes_3d_corners"] = cand_corners
        tgt["gt_bboxes_3d"] = cand_7d
        new_row = copy.deepcopy(row)
        new_row["scene_token"] = scene_key
        new_row["is_erase_box"] = True
        new_row["scene_obj_idx"] = len(cand_corners) - 1
        erase.append(new_row)
    return erase


def build_pbe_database(
    dataroot: str,
    out_dir: str,
    version: str = "v1.0-mini",
    split: str = "train",
    info_prefix: str = "nuscenes",
    num_erase: Optional[int] = None,
    seed: int = 0,
    max_samples: Optional[int] = None,
) -> Dict[str, str]:
    tables = NuScenesTables(dataroot, version)
    db_dir = os.path.join(out_dir, f"{info_prefix}_pbe_gt_database_{split}")
    os.makedirs(db_dir, exist_ok=True)

    all_scene_infos: Dict[str, dict] = {}
    all_rows: List[dict] = []
    for i, sample in enumerate(tables.samples_of_split()):
        if max_samples is not None and i >= max_samples:
            break
        rec = tables.sample_record(sample)
        scene_info, rows = process_sample(rec, db_dir)
        if scene_info is not None:
            all_scene_infos[scene_info["sample_idx"]] = scene_info
            all_rows.extend(rows)

    if num_erase is None:
        num_erase = 10000 if split == "train" else 2000
        if "mini" in version:
            num_erase //= 100
    rng = np.random.default_rng(seed)
    all_rows.extend(
        synthesize_erase_boxes(all_scene_infos, all_rows, num_erase, rng)
    )

    # camera_visibility_mask: each row's mask pixels over the sum of its
    # (track_id, scene_token, timestamp) group's (a groupby transform)
    keys = [(r["track_id"], r["scene_token"], r["timestamp"]) for r in all_rows]
    total: Dict[tuple, int] = {}
    for key, r in zip(keys, all_rows):
        total[key] = total.get(key, 0) + r["num_mask_pixels"]
    with np.errstate(divide="ignore", invalid="ignore"):
        for key, r in zip(keys, all_rows):
            r["camera_visibility_mask"] = float(np.float64(r["num_mask_pixels"]) / np.float64(total[key]))
    columns = list(all_rows[0]) if all_rows else ["camera_visibility_mask"]

    csv_path = os.path.join(out_dir, f"{info_prefix}_dbinfos_pbe_{split}.csv")
    pkl_path = os.path.join(out_dir, f"{info_prefix}_scene_infos_pbe_{split}.pkl")
    write_csv(csv_path, columns, list(enumerate(all_rows)))
    with open(pkl_path, "wb") as f:
        pickle.dump(all_scene_infos, f)
    return {"object_database_path": csv_path, "scene_database_path": pkl_path}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataroot", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--version", default="v1.0-mini")
    p.add_argument("--split", default="train")
    p.add_argument("--info-prefix", default="nuscenes")
    p.add_argument("--num-erase", type=int, default=None)
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--write-infos", action="store_true",
                   help="also write {prefix}_infos_{train,val}.pkl "
                        "(reference create_nuscenes_infos stage)")
    p.add_argument("--max-sweeps", type=int, default=10)
    args = p.parse_args(argv)
    out = build_pbe_database(
        args.dataroot, args.out_dir, args.version, args.split,
        args.info_prefix, args.num_erase, max_samples=args.max_samples,
    )
    if args.write_infos:
        from mobi_tpu_torch.data.infos_converter import create_nuscenes_infos

        out.update(create_nuscenes_infos(
            args.dataroot, args.out_dir, args.version, args.info_prefix,
            max_sweeps=args.max_sweeps,
        ))
    print(out)
    return out


if __name__ == "__main__":
    main()
