"""Object-centric nuScenes dataset for joint camera + lidar inpainting
(mobi_tpu data/nuscenes.py), on numpy and the port's own `table`,
`image_io`, `imgproc`, `geometry` and `range_projection` (no pandas, PIL or
cv2). Every branch of the JAX class, with the same draws from the one
`np.random.default_rng(seed)` in the same order, so the two give the same
samples on the same database.

Returned sample schema (NHWC), as MobiDiffusion.get_input reads it:
  {id_name, bbox_3d[8,3], ref_class,
   image: {GT, inpaint_image, inpaint_mask, cond:{ref_image, ref_bbox}},
   lidar: {range_data, range_data_inpaint, range_mask, range_instance_mask,
           range_depth_orig, range_int_orig, width_crop, range_shift_left,
           range_pitch, range_yaw, min_depth_obj, max_depth_obj,
           cond:{ref_image, ref_bbox}}}
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from mobi_tpu_torch.data import range_projection as rp
from mobi_tpu_torch.data import table
from mobi_tpu_torch.data.augment import ref_augment, resize_image, to_clip_input, to_model_range
from mobi_tpu_torch.data.geometry import (
    get_2d_bbox,
    get_inpaint_mask,
    get_range_inpaint_mask,
    project_to_image,
    rotate_bbox,
    translate_bbox,
)
from mobi_tpu_torch.data.image_io import read_image
from mobi_tpu_torch.ops.ranges import depth_normalization


class NuScenesDataset:
    def __init__(
        self,
        state: str,
        object_database_path: str,
        scene_database_path: str,
        object_classes: Sequence[str],
        expand_mask_ratio: float = 0.0,
        expand_ref_ratio: float = 0.0,
        ref_aug: bool = True,
        prob_use_3d_edit_mask: float = 1.0,
        prob_drop_context: float = 0.0,
        ref_mode: str = "id-ref",
        image_height: int = 512,
        image_width: int = 512,
        range_height: int = 512,
        range_width: int = 512,
        reference_image_min_h: int = 100,
        reference_image_max_h: int = 800,
        reference_image_min_w: int = 100,
        reference_image_max_w: int = 1400,
        frustum_iou_max: float = 0.5,
        camera_visibility_min: float = 0.7,
        object_area_crop: float = 0.2,
        object_random_crop: bool = True,
        min_lidar_points: int = 64,
        rot_every_angle: int = 0,
        rot_test_scene: Optional[str] = None,
        rot_test_cam_idx: int = 3,
        rot_test_bbox_coord=(3, -10, -1.5),
        use_lidar: bool = False,
        use_camera: bool = True,
        random_range_crop: bool = False,
        num_samples_per_class: Optional[int] = None,
        prob_erase_box: float = 0.0,
        fixed_sampling: bool = True,
        sample_each_frame: bool = False,
        return_original_image: bool = False,
        range_object_norm: bool = True,
        range_object_norm_scale: float = 0.75,
        range_int_norm: bool = False,
        object_meta_dump_path: Optional[str] = None,
        specific_object: Optional[str] = None,
        seed: int = 42,
    ) -> None:
        self.state = state
        self.ref_aug = ref_aug
        self.ref_mode = "id-ref" if ref_mode == "same-ref" else ref_mode
        self.expand_mask_ratio = expand_mask_ratio
        self.expand_ref_ratio = expand_ref_ratio
        self.prob_use_3d_edit_mask = prob_use_3d_edit_mask
        self.prob_drop_context = prob_drop_context
        self.rot_test_scene = rot_test_scene
        self.rot_test_cam_idx = rot_test_cam_idx
        self.rot_test_bbox_coord = np.asarray(rot_test_bbox_coord, np.float64)
        self.use_lidar = use_lidar
        self.use_camera = use_camera
        self.random_range_crop = random_range_crop
        self.object_area_crop = object_area_crop
        self.object_random_crop = object_random_crop
        self.return_original_image = return_original_image
        self.range_object_norm = range_object_norm
        self.range_object_norm_scale = range_object_norm_scale
        self.range_int_norm = range_int_norm
        self.num_samples_per_class = num_samples_per_class
        self.prob_erase_box = prob_erase_box
        self.fixed_sampling = fixed_sampling
        self.image_height = image_height
        self.image_width = image_width
        self.range_height = range_height
        self.range_width = range_width
        self.object_classes = list(object_classes)
        self._rng = np.random.default_rng(seed)

        meta = table.read_csv(object_database_path, index_col=0)
        # trivial filters (nuscenes.py:127-135)
        meta = meta[
            np.isin(meta["object_class"], self.object_classes)
            & (meta["camera_visibility_mask"] >= camera_visibility_min)
            & (meta["max_distance"] < rp.DEPTH_MAX)
            & (meta["min_distance"] > rp.DEPTH_MIN)
        ]
        self.objects_meta_orig = meta
        # quality filters (nuscenes.py:138-146)
        meta_all = meta[
            (meta["reference_image_h"] >= reference_image_min_h)
            & (meta["reference_image_h"] <= reference_image_max_h)
            & (meta["reference_image_w"] >= reference_image_min_w)
            & (meta["reference_image_w"] <= reference_image_max_w)
            & (meta["max_iou_overlap"] <= frustum_iou_max)
            & (meta["num_lidar_points"] >= min_lidar_points)
        ]
        self.erase_meta_all = meta_all[meta_all["is_erase_box"]]
        self.objects_meta_all = meta_all[~meta_all["is_erase_box"]]

        if specific_object is not None:
            parts = specific_object.split("_")
            scene_token = parts[0].split("-", 1)[1]
            track_id = parts[1].split("-", 1)[1]
            timestamp = int(parts[2].split("-", 1)[1])
            self.objects_meta = self.objects_meta_orig[
                (self.objects_meta_orig["track_id"] == track_id)
                & (self.objects_meta_orig["scene_token"] == scene_token)
                & (self.objects_meta_orig["timestamp"] == timestamp)
            ].reset_index(drop=True)
            self.num_samples_per_class = None
        elif sample_each_frame:
            # one object per scene, topping up missing scenes
            sel = self.objects_meta_all.groupby("scene_token").sample(
                n=1, random_state=seed
            )
            missing = set(self.objects_meta_orig["scene_token"]) - set(
                sel["scene_token"]
            )
            pool = self.objects_meta_orig[
                np.isin(self.objects_meta_orig["scene_token"], list(missing))
                & ~self.objects_meta_orig["is_erase_box"]
            ]
            extra = (
                pool.sort_values("num_lidar_points", ascending=False)
                .groupby("scene_token")
                .head(3)
                .groupby("scene_token")
                .sample(n=1, random_state=seed)
            )
            self.objects_meta = table.concat([sel, extra]).reset_index(drop=True)
            self.objects_meta_all = table.concat([self.objects_meta_all, extra])
            self.num_samples_per_class = None
        elif num_samples_per_class is not None and fixed_sampling:
            parts = []
            for _, grp in self.objects_meta_all.groupby("object_class"):
                parts.append(
                    grp.sample(
                        num_samples_per_class,
                        replace=(len(grp) < num_samples_per_class),
                        random_state=seed,
                    )
                )
            self.objects_meta = table.concat(parts).reset_index(drop=True)
        else:
            self.objects_meta = self.objects_meta_all.reset_index(drop=True)

        if object_meta_dump_path is not None:
            dump = {
                row["scene_token"]: row["track_id"]
                for _, row in self.objects_meta.iterrows()
            }
            os.makedirs(os.path.dirname(object_meta_dump_path), exist_ok=True)
            with open(object_meta_dump_path, "w") as f:
                json.dump(dump, f)

        self.idx_lists = [
            self.objects_meta[self.objects_meta["object_class"] == c].index.tolist()
            for c in self.object_classes
        ]
        self.idx_lists_erase = [
            self.erase_meta_all[self.erase_meta_all["object_class"] == c].index.tolist()
            for c in self.object_classes
        ]

        if rot_every_angle:
            angles = np.arange(0, 360, rot_every_angle)
            self.objects_meta = table.concat(
                [self.objects_meta] * len(angles), ignore_index=True
            )
            self.objects_meta["bbox_rot_angle"] = np.repeat(
                angles, len(self.objects_meta) // len(angles)
            )
            if self.num_samples_per_class is not None:
                self.num_samples_per_class *= len(angles)

        with open(scene_database_path, "rb") as f:
            self.scenes_info = pickle.load(f)

    # ------------------------------------------------------------------ len
    def __len__(self) -> int:
        if self.num_samples_per_class is None:
            return len(self.objects_meta)
        return len(self.object_classes) * self.num_samples_per_class

    # -------------------------------------------------------------- sampling
    def __getitem__(self, index: int) -> Dict[str, Any]:
        rng = self._rng
        cls_bucket = index % len(self.object_classes)
        if (
            rng.uniform() < self.prob_erase_box
            and len(self.idx_lists_erase[cls_bucket]) > 0
        ):
            idx = int(rng.choice(self.idx_lists_erase[cls_bucket]))
            object_meta = self.erase_meta_all.loc(idx)
        else:
            if self.num_samples_per_class and not self.fixed_sampling:
                index = int(rng.choice(self.idx_lists[cls_bucket]))
            object_meta = self.objects_meta.loc(index)

        if self.rot_test_scene is not None:
            scene_info = self.scenes_info[self.rot_test_scene]
            cam_idx = self.rot_test_cam_idx
        else:
            scene_info = self.scenes_info[object_meta["scene_token"]]
            cam_idx = int(object_meta["cam_idx"])

        ref_image, ref_clip, ref_bbox_3d, ref_class = self.get_reference(
            object_meta, index
        )

        if self.rot_test_scene is None:
            bbox_3d = np.asarray(
                scene_info["gt_bboxes_3d_corners"][int(object_meta["scene_obj_idx"])],
                np.float64,
            )
        else:
            bbox_3d = translate_bbox(ref_bbox_3d, self.rot_test_bbox_coord)

        bbox_3d = rotate_bbox(bbox_3d, float(object_meta.get("bbox_rot_angle", 0)))

        data: Dict[str, Any] = {
            "id_name": self.get_id_name(object_meta),
            "bbox_3d": bbox_3d.astype(np.float32),
            "ref_class": ref_class,
            "image": {},
            "lidar": {},
        }

        if self.use_camera:
            data["image"] = self.get_image_data(scene_info, cam_idx, bbox_3d)
            data["image"]["cond"]["ref_image"] = ref_clip

        if self.use_lidar:
            data["lidar"] = self.get_range_data(
                scene_info, bbox_3d, int(object_meta["scene_obj_idx"])
            )
            data["lidar"]["cond"]["ref_image"] = ref_clip
            if self.use_camera:
                # camera bbox token shares the lidar depth channel
                # (nuscenes.py:303-304)
                data["image"]["cond"]["ref_bbox"][..., 2] = data["lidar"]["cond"][
                    "ref_bbox"
                ][..., 2]

        if bool(object_meta["is_erase_box"]) or self.ref_mode == "erase-ref":
            # dummy bbox conditioning for erasing (nuscenes.py:306-310)
            if self.use_camera:
                data["image"]["cond"]["ref_bbox"] *= 0
            if self.use_lidar:
                data["lidar"]["cond"]["ref_bbox"] *= 0

        return data

    # ------------------------------------------------------------ reference
    def get_reference(self, object_meta, index: int):
        rng = self._rng
        is_erase = bool(object_meta["is_erase_box"]) or self.ref_mode == "erase-ref"
        if self.ref_mode in ("id-ref", "erase-ref") or bool(object_meta["is_erase_box"]):
            reference_meta = object_meta
        elif self.ref_mode == "in-domain-ref":
            pool = self.objects_meta_all[
                (self.objects_meta_all["object_class"] == object_meta["object_class"])
                & (self.objects_meta_all["is_raining"] == object_meta["is_raining"])
                & (self.objects_meta_all["is_night"] == object_meta["is_night"])
            ]
            reference_meta = pool.sample(1, random_state=index).iloc(0)
        elif self.ref_mode == "cross-domain-ref":
            pool = self.objects_meta_all[
                (self.objects_meta_all["object_class"] == object_meta["object_class"])
                & (
                    (self.objects_meta_all["is_raining"] != object_meta["is_raining"])
                    | (self.objects_meta_all["is_night"] != object_meta["is_night"])
                )
            ]
            reference_meta = pool.sample(1, random_state=index).iloc(0)
        elif self.ref_mode == "track-ref":
            tracked = self.objects_meta_all[
                self.objects_meta_all["track_id"] == object_meta["track_id"]
            ]
            # reference behavior: the first tracked frame is always taken
            # (nuscenes.py:332-347 — the beta-weighted branch is dead code)
            reference_meta = (
                tracked.iloc(0) if len(tracked) else object_meta
            )
        else:
            raise ValueError(f"Invalid ref_mode {self.ref_mode}")

        ref_scene = self.scenes_info[reference_meta["scene_token"]]
        ref_cam_idx = int(reference_meta["cam_idx"])
        ref_bbox_3d = np.asarray(
            ref_scene["gt_bboxes_3d_corners"][int(reference_meta["scene_obj_idx"])],
            np.float64,
        )
        ref_class = reference_meta["object_class"]

        if is_erase:
            crop = np.zeros((224, 224, 3), dtype=np.uint8)
            ref_class = "empty"
        else:
            img = self._load_image(ref_scene["image_paths"][ref_cam_idx])
            H, W = img.shape[:2]
            x1, y1, x2, y2 = get_2d_bbox(
                ref_bbox_3d,
                ref_scene["lidar2image_transforms"][ref_cam_idx],
                H, W, self.expand_ref_ratio,
            )
            w = max(x2 - x1 + 1, 1)
            h = max(y2 - y1 + 1, 1)
            crop = img[y1 : y1 + h, x1 : x1 + w]

        crop = ref_augment(crop, rng if self.ref_aug else None, enabled=self.ref_aug)
        return crop, to_clip_input(crop), ref_bbox_3d, ref_class

    @staticmethod
    def _load_image(path: str) -> np.ndarray:
        return read_image(path)

    def get_id_name(self, object_meta) -> str:
        id_name = "sample-{}_track-{}_time-{}_{}_{}_rot-{}".format(
            object_meta["scene_token"],
            object_meta["track_id"],
            object_meta["timestamp"],
            object_meta["object_class"],
            self.ref_mode,
            object_meta.get("bbox_rot_angle", 0),
        )
        if self.ref_aug:
            id_name += "-aug"
        return id_name

    # --------------------------------------------------------------- camera
    def get_image_data(self, scene_info, cam_idx: int, bbox_3d) -> Dict[str, Any]:
        rng = self._rng
        lidar2image = np.asarray(scene_info["lidar2image_transforms"][cam_idx])
        image_path = scene_info["image_paths"][cam_idx]
        img_u8 = self._load_image(image_path)
        H, W = img_u8.shape[:2]
        image = to_model_range(img_u8)

        bbox_coords = project_to_image(bbox_3d, lidar2image, include_depth=True)

        use_3d = rng.uniform() < self.prob_use_3d_edit_mask
        mask = get_inpaint_mask(
            bbox_3d, lidar2image, H, W, self.expand_mask_ratio, use_3d
        )
        if self.return_original_image:
            image_orig, mask_orig = image.copy(), mask.copy()
        if (mask == 1).all():
            mask = 1 - mask  # badly projected erase boxes (nuscenes.py:522-524)

        ys, xs = np.nonzero(1 - mask)
        y1, y2 = ys.min(), ys.max()
        x1, x2 = xs.min(), xs.max()

        # object-area square crop (nuscenes.py:530-553)
        area = (1 - mask).sum() / self.object_area_crop
        crop_H = crop_W = int(np.sqrt(area))
        if y2 - y1 > crop_H:
            crop_W += crop_H - (y2 - y1)
            crop_H = y2 - y1
        if x2 - x1 > crop_W:
            crop_H += crop_W - (x2 - x1)
            crop_W = x2 - x1
        crop_H, crop_W = int(min(crop_H, H)), int(min(crop_W, W))

        lo_l, hi_l = max(0, x2 - crop_W), min(x1, W - crop_W)
        lo_t, hi_t = max(0, y2 - crop_H), min(y1, H - crop_H)
        if self.object_random_crop and hi_l >= lo_l and hi_t >= lo_t:
            left = int(rng.integers(lo_l, hi_l + 1))
            top = int(rng.integers(lo_t, hi_t + 1))
        else:
            left = int((lo_l + hi_l) // 2)
            top = int((lo_t + hi_t) // 2)

        image_c = image[top : top + crop_H, left : left + crop_W]
        mask_c = mask[top : top + crop_H, left : left + crop_W]

        bbox_coords = bbox_coords - np.array([left, top, 0.0])
        bbox_coords[..., 0] /= image_c.shape[1]
        bbox_coords[..., 1] /= image_c.shape[0]

        image_r = resize_image(image_c, self.image_height, self.image_width)
        mask_r = resize_image(mask_c, self.image_height, self.image_width)[..., None]

        inpaint = image_r * mask_r
        if rng.uniform() < self.prob_drop_context:
            inpaint = inpaint * 0
            image_r = image_r * (1 - mask_r)

        data = {
            "GT": image_r.astype(np.float32),
            "inpaint_image": inpaint.astype(np.float32),
            "inpaint_mask": mask_r.astype(np.float32),
            "cond": {"ref_bbox": bbox_coords.astype(np.float32)},
        }
        if self.return_original_image:
            data["orig"] = {
                "crop": np.array([left, top, crop_W, crop_H], np.int32),
                "image": image_orig,
                "mask": mask_orig,
                "file_name": os.path.basename(image_path),
                "cam_type": scene_info["cam_types"][cam_idx],
                "lidar2image": lidar2image,
            }
        return data

    # ---------------------------------------------------------------- lidar
    def get_range_data(self, scene_info, bbox_3d, obj_idx: int) -> Dict[str, Any]:
        rng = self._rng
        if "range_depth_path" in scene_info:
            range_depth = np.load(scene_info["range_depth_path"])
            range_int = np.load(scene_info["range_intensity_path"])
            range_pitch = np.load(scene_info["range_pitch_path"])
            range_yaw = np.load(scene_info["range_yaw_path"])
            if "range_instance_mask_path" in scene_info:
                inst = np.load(scene_info["range_instance_mask_path"])
                instance_mask = (inst == obj_idx).astype(np.float32)
            else:
                instance_mask = np.zeros_like(range_depth, np.float32)
        elif "lidar_path" in scene_info:
            scan = np.load(scene_info["lidar_path"])
            range_depth, range_int, _, range_pitch, range_yaw = rp.pcd_to_range(
                scan[:, :3], scan[:, 3]
            )
            instance_mask = np.zeros_like(range_depth, np.float32)
        else:
            raise ValueError("No lidar data found in scene info")

        coords = rp.bbox_range_coords(bbox_3d)
        depth_orig, int_orig, inst_orig = (
            range_depth.copy(), range_int.copy(), instance_mask.copy(),
        )

        range_depth, range_int, instance_mask, coords, geom = rp.apply_range_transforms(
            coords, range_depth, range_int, instance_mask,
            out_h=self.range_height, out_w=self.range_width,
            random_crop=self.random_range_crop, rng=rng,
        )

        coords = coords.astype(np.float32)
        coords[..., 0] /= self.range_width
        coords[..., 1] /= self.range_height
        d = coords[:, 2]
        spread = d.max() - d.min()
        min_depth_obj = np.clip(d.min() - 0.1 * spread, -1, 1).astype(np.float32)
        max_depth_obj = np.clip(d.max() + 0.1 * spread, -1, 1).astype(np.float32)

        if self.range_object_norm:
            range_depth = depth_normalization(
                range_depth, min_depth_obj, max_depth_obj,
                alpha=self.range_object_norm_scale,
            )
            coords[..., 2] = depth_normalization(
                coords[..., 2], min_depth_obj, max_depth_obj,
                alpha=self.range_object_norm_scale,
            )

        range_int = ((range_int / 255.0) - 0.5) * 2.0
        if self.range_int_norm:
            range_int = np.clip(
                2 * (1 - np.exp(-2 * (range_int + 1))) - 1, -1, 1
            )

        range_data = np.stack([range_depth, range_int], axis=-1).astype(np.float32)

        range_mask = get_range_inpaint_mask(
            bbox_3d, self.range_height, self.range_width, self.expand_mask_ratio,
            crop_left=geom.crop_left, width_crop=geom.width_crop,
        )[..., None].astype(np.float32)

        inpaint = range_data * range_mask
        if rng.uniform() < self.prob_drop_context:
            inpaint = inpaint * 0
            range_data = range_data * (1 - range_mask)

        return {
            "range_data": range_data,
            "range_data_inpaint": inpaint,
            "range_depth_orig": depth_orig.astype(np.float32),
            "range_int_orig": int_orig.astype(np.float32),
            "range_instance_mask_orig": inst_orig.astype(np.float32),
            "range_shift_left": np.int32(geom.crop_left),
            "width_crop": np.int32(geom.width_crop),
            "range_mask": range_mask,
            "range_instance_mask": instance_mask[..., None].astype(np.float32),
            "range_pitch": range_pitch.astype(np.float32),
            "range_yaw": range_yaw.astype(np.float32),
            "min_depth_obj": min_depth_obj,
            "max_depth_obj": max_depth_obj,
            "cond": {"ref_bbox": coords},
            "file_name": os.path.basename(str(scene_info.get("lidar_path", "range"))),
        }


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of per-sample dicts into batched numpy arrays; string
    fields become lists."""

    def stack(key, items):
        if isinstance(items[0], dict):
            return {k: stack(k, [it[k] for it in items]) for k in items[0]}
        if isinstance(items[0], str):
            return list(items)
        return np.stack([np.asarray(it) for it in items])

    return {k: stack(k, [s[k] for s in samples]) for k in samples[0]}
