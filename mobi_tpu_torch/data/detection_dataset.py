"""Detector-facing nuScenes dataset for evaluating detectors on (edited)
scenes (mobi_tpu data/detection_dataset.py; the roles of the reference's
nuscenes_dataset.py:240-314 get_data_info with the edited-samples swap and
pipelines/loading.py), on the port's devkit-free table reader. Items are
numpy dicts:

  {
    "sample_token", "points" [N, 5], "images" [6, H, W, 3] float in [-1, 1],
    "lidar2image" [6, 4, 4], "camera_intrinsics" [6, 4, 4],
    "camera2lidar" [6, 4, 4], "lidar2global" [4, 4],
    "gt_bboxes_3d" [M, 7] (lidar frame, bottom-centre z), "gt_velocity",
    "gt_names" [M], "ann_tokens" [M] (instance tokens),
  }

`edited_samples_path` swaps edited sensor files in by file stem (the
devkit's nuscenes.py:127-149 patch). `sweeps_num > 0` aggregates that many
previous lidar sweeps into the keyframe frame with a time-lag channel
(`det_pipeline.load_points_multisweep`). Camera frames are read with
`image_io.read_image` (JPEG or PNG by magic bytes).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from mobi_tpu_torch.data.det_pipeline import fold_img_aug, image_aug_3d, load_points_multisweep
from mobi_tpu_torch.data.image_io import read_image
from mobi_tpu_torch.data.nuscenes_tables import NuScenesTables, load_lidar_points


class DetectionSceneDataset:
    def __init__(
        self,
        dataroot: str,
        version: str = "v1.0-mini",
        edited_samples_path: Optional[str] = None,
        load_images: bool = True,
        max_points: Optional[int] = None,
        sweeps_num: int = 0,
        image_size: Optional[tuple] = None,
        image_resize: Optional[float] = None,
    ):
        """image_size: when set (e.g. (256, 704), the production detector's
        input), every view is resized and cropped by
        `det_pipeline.image_aug_3d(is_train=False)` and the affine is folded
        into the returned `lidar2image` / `camera_intrinsics`.
        image_resize overrides the scale (default max(fW/W, fH/H), which
        covers the canvas; 0.48 is the reference's on 1600x900 frames)."""
        self.tables = NuScenesTables(dataroot, version, edited_samples_path=edited_samples_path)
        self.load_images = load_images
        self.max_points = max_points
        self.sweeps_num = sweeps_num
        self.image_size = tuple(image_size) if image_size else None
        self.image_resize = image_resize
        self._samples = list(self.tables.samples_of_split())

    def __len__(self) -> int:
        return len(self._samples)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        rec = self.tables.sample_record(self._samples[i])
        if self.sweeps_num > 0:
            points = load_points_multisweep(rec, sweeps_num=self.sweeps_num).astype(np.float32)
        else:
            points = load_lidar_points(rec["lidar_path"]).astype(np.float32)
        if self.max_points is not None:
            # fixed-size clouds: a seeded subsample, or padding with an
            # out-of-range sentinel
            n = len(points)
            if n > self.max_points:
                sel = np.random.default_rng(i).choice(n, self.max_points, replace=False)
                points = points[sel]
            elif n < self.max_points:
                pad = np.full((self.max_points - n, points.shape[1]), 1e4, np.float32)
                points = np.concatenate([points, pad])

        out: Dict[str, Any] = {
            "sample_token": rec["sample_token"],
            "points": points,
            "lidar2image": rec["lidar2image_transforms"].astype(np.float32),
            "camera2lidar": np.linalg.inv(rec["lidar2camera_transforms"]).astype(np.float32)
            if len(rec["lidar2camera_transforms"]) else np.zeros((0, 4, 4), np.float32),
            "camera_intrinsics": rec["camera_intrinsics"].astype(np.float32),
            "cam_types": rec["cam_types"],
            "lidar2global": np.asarray(rec["lidar2global"], np.float64),
            "gt_bboxes_3d": rec["gt_bboxes_3d"].astype(np.float32),
            "gt_velocity": rec["gt_velocity"].astype(np.float32),
            "gt_names": list(rec["gt_names"]),
            "ann_tokens": list(rec["ann_tokens"]),
        }
        if self.load_images:
            imgs: List[np.ndarray] = [read_image(p).astype(np.float32) / 127.5 - 1.0
                                      for p in rec["image_paths"]]
            if imgs:
                images = np.stack(imgs)
                if self.image_size is not None:
                    images, aug = self._resize_views(images)
                    out["img_aug_matrix"] = aug
                    out["lidar2image"], out["camera_intrinsics"] = fold_img_aug(
                        out["lidar2image"], out["camera_intrinsics"], aug)
                out["images"] = images
        return out

    def _resize_views(self, images: np.ndarray):
        fH, fW = self.image_size
        H, W = images.shape[1:3]
        r = self.image_resize or max(fH / H, fW / W)
        return image_aug_3d(images, rng=None, final_dim=(fH, fW), resize_lim=(r, r),
                            bot_pct_lim=(0.0, 0.0), rot_lim=(0.0, 0.0), rand_flip=False, is_train=False)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self[i]
