"""Lidar reconstruction metrics (mobi_tpu eval/lidar_metrics.py), the
in-training metric block of ddpm.py:1502-1597: de-normalize
predicted/GT depth (object-adaptive inverse) and intensity (log inverse),
pool-resize each sample to (32, width_crop), and report RMSE and median
absolute error over the object instance mask, the edit-mask region, and the
full crop — scaled to meters (x(54-1.4)/2) and intensity units (x128).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from mobi_tpu_torch.data.range_projection import block_max_resize, block_mean_resize
from mobi_tpu_torch.ops.ranges import (
    inverse_depth_normalization,
    inverse_intensity_normalization,
)

DEPTH_SCALE = (54.0 - 1.4) / 2.0
INT_SCALE = 128.0


def lidar_sample_metrics(
    pred: np.ndarray,           # [B, H, W, 2] decoded range (depth, intensity)
    gt: np.ndarray,             # [B, H, W, 2]
    instance_mask: np.ndarray,  # [B, H, W, 1]
    edit_mask: np.ndarray,      # [B, H, W, 1] (1 = keep, 0 = edited)
    width_crop: np.ndarray,     # [B] int
    min_depth_obj: Optional[np.ndarray] = None,
    max_depth_obj: Optional[np.ndarray] = None,
    range_object_norm: bool = True,
    range_object_norm_scale: float = 0.75,
    range_int_norm: bool = True,
    prefix: str = "",
) -> Dict[str, float]:
    B = pred.shape[0]
    pred_depth = pred[..., 0].astype(np.float64)
    gt_depth = gt[..., 0].astype(np.float64)
    pred_int = pred[..., 1].astype(np.float64)
    gt_int = gt[..., 1].astype(np.float64)

    if range_object_norm and min_depth_obj is not None:
        for i in range(B):
            pred_depth[i] = inverse_depth_normalization(
                pred_depth[i], float(min_depth_obj[i]), float(max_depth_obj[i]),
                alpha=range_object_norm_scale,
            )
            gt_depth[i] = inverse_depth_normalization(
                gt_depth[i], float(min_depth_obj[i]), float(max_depth_obj[i]),
                alpha=range_object_norm_scale,
            )
    if range_int_norm:
        pred_int = inverse_intensity_normalization(pred_int)
        gt_int = inverse_intensity_normalization(gt_int)

    inv_mask = 1.0 - edit_mask[..., 0]  # 1 where edited (ddpm.py:1516)
    inst = instance_mask[..., 0]

    scores: Dict[str, list] = {}

    def add(key, val):
        scores.setdefault(key, []).append(val)

    for i in range(B):
        w = int(width_crop[i])
        pd = block_mean_resize(pred_depth[i], 32, w)
        gd = block_mean_resize(gt_depth[i], 32, w)
        pi = block_mean_resize(pred_int[i], 32, w)
        gi = block_mean_resize(gt_int[i], 32, w)
        im = block_max_resize(inst[i], 32, w) == 1
        em = block_max_resize(inv_mask[i], 32, w) == 1

        for name, (p, g) in {"depth": (pd, gd), "int": (pi, gi)}.items():
            err = np.abs(p - g)
            if im.any():
                add(f"mse/object_pred_{name}", float(np.sqrt((err[im] ** 2).mean())))
                add(f"median_error/object_pred_{name}", float(np.median(err[im])))
            if em.any():
                add(f"mse/mask_pred_{name}", float(np.sqrt((err[em] ** 2).mean())))
                add(f"median_error/mask_pred_{name}", float(np.median(err[em])))

    out = {}
    for k, v in scores.items():
        scale = DEPTH_SCALE if "depth" in k else INT_SCALE
        out[f"{prefix}{k}"] = float(np.mean(v)) * scale
    return out
