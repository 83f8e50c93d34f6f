"""Visualisation (mobi_tpu viz.py): lidar-on-image overlays, the top-down
BEV view of points and boxes, and the camera and range-view collages, on
`imgproc` and `image_io` instead of cv2. Images are RGB uint8 unless noted.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from mobi_tpu_torch.data.image_io import write_png
from mobi_tpu_torch.data.imgproc import TURBO_LUT, arrowed_line, fill_circle, line, resize_nearest

# the box corners each wireframe edge joins (mobi_tpu viz.py)
BOX_EDGES = (
    (0, 1), (0, 3), (3, 2), (1, 2),
    (1, 5), (0, 4), (3, 7), (2, 6),
    (4, 7), (4, 5), (5, 6), (6, 7),
)


def _to_u8(img: np.ndarray, assume_pm1: bool = True) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    if assume_pm1:
        img = (img + 1.0) / 2.0
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def overlay_lidar_on_image(
    points: np.ndarray,
    lidar2image: np.ndarray,
    image: np.ndarray,
    output_path: Optional[str] = None,
    point_size: int = 2,
    clip_values=(1e-5, 1e5),
) -> np.ndarray:
    """Project lidar points onto a camera frame as filled circles colored by
    depth (TURBO). Returns the overlay RGB u8 and writes it as a PNG when
    `output_path` is given."""
    img = _to_u8(image, assume_pm1=False).copy()
    if img.ndim == 3 and img.shape[0] == 3:
        img = img.transpose(1, 2, 0).copy()
    H, W = img.shape[:2]

    pts = np.asarray(points)[:, :3]
    hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    proj = hom @ np.asarray(lidar2image).reshape(4, 4).T
    keep = proj[:, 2] > 0
    proj = proj[keep]
    z = np.clip(proj[:, 2], *clip_values)
    u = proj[:, 0] / z
    v = proj[:, 1] / z
    inside = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, z = u[inside], v[inside], z[inside]

    if len(z):
        z_norm = np.clip((z - z.min()) / max(z.max() - z.min(), 1e-6), 0, 1)
        colors = TURBO_LUT[(z_norm * 255).astype(np.uint8)]
        for x, y, c in zip(u.astype(int), v.astype(int), colors):
            fill_circle(img, (x, y), point_size, c)

    if output_path:
        os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
        write_png(output_path, img)
    return img


def visualize_lidar_bev(
    lidar: Optional[np.ndarray] = None,
    *,
    fpath: Optional[str] = None,
    bboxes: Optional[np.ndarray] = None,
    xlim=(-10, 10),
    ylim=(-10, 10),
    thickness: int = 1,
    bbox_color=(0, 165, 255),
    points_color=(0, 128, 128),
    dpi: int = 20,
) -> np.ndarray:
    """Top-down rendering of points and boxes, pixel for pixel as the JAX
    package's cv2 version: a white canvas of (ylim span * dpi) x (xlim span
    * dpi), each box's wireframe edges as cv2 lines (LINE_8), an arrow
    (LINE_AA, tip 0.1) from the box centre to its front face [0, 1, 4, 5],
    then the points as single pixels. Writes a PNG when `fpath` is given.
    Lines are one pixel wide, as every caller draws them; another
    `thickness` raises."""
    if thickness != 1:
        raise NotImplementedError("the port draws one-pixel lines (thickness=1)")
    img = np.full((int((ylim[1] - ylim[0]) * dpi), int((xlim[1] - xlim[0]) * dpi), 3), 255, np.uint8)

    def to_px(p):
        return int(p[0] * dpi - xlim[0] * dpi), int((ylim[1] - p[1]) * dpi)

    if bboxes is not None and len(bboxes) > 0:
        boxes = np.asarray(bboxes)
        if boxes.ndim == 2:
            boxes = boxes[None]
        for box in boxes:
            for s, e in BOX_EDGES:
                line(img, to_px(box[s]), to_px(box[e]), bbox_color, 8)
            center, tip = box.mean(axis=0), box[[0, 1, 4, 5]].mean(axis=0)
            arrowed_line(img, to_px(center), to_px(tip), bbox_color, 16, tip_length=0.1)

    if lidar is not None and len(lidar):
        pts = np.asarray(lidar)[:, :2].copy()
        pts[:, 0] = (pts[:, 0] - xlim[0]) * dpi
        pts[:, 1] = (ylim[1] - pts[:, 1]) * dpi
        keep = (pts[:, 0] >= 0) & (pts[:, 0] < img.shape[1]) & (pts[:, 1] >= 0) & (pts[:, 1] < img.shape[0])
        pts = pts[keep].astype(int)
        img[pts[:, 1], pts[:, 0]] = points_color

    if fpath:
        os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
        write_png(fpath, img)
    return img


def camera_log_collage(rows: Sequence[np.ndarray]) -> np.ndarray:
    """Stack [-1, 1] HWC images vertically into one u8 collage (the
    reference's GT / inpaint / sample rows); grey rows become RGB and a row
    of another size is resized nearest to the largest height and width."""
    h = max(r.shape[0] for r in rows)
    w = max(r.shape[1] for r in rows)
    out = []
    for r in rows:
        u8 = _to_u8(r)
        if u8.ndim == 2:
            u8 = np.repeat(u8[..., None], 3, axis=-1)
        if u8.shape[-1] == 1:
            u8 = np.repeat(u8, 3, axis=-1)
        if u8.shape[:2] != (h, w):
            u8 = resize_nearest(u8, h, w)
        out.append(u8)
    return np.concatenate(out, axis=0)


def range_log_collage(
    gt: np.ndarray,
    inpaint: np.ndarray,
    mask: np.ndarray,
    sample: np.ndarray,
    rec: Optional[np.ndarray] = None,
    channel: int = 0,
) -> np.ndarray:
    """Per-channel range collage [input, inpaint, mask, sample(, rec)]
    (ddpm.py:1519-1520). Inputs [-1,1] HWC; returns u8 [k*H, W]."""
    rows = [gt[..., channel], inpaint[..., channel],
            mask[..., 0] * 2.0 - 1.0, sample[..., channel]]
    if rec is not None:
        rows.append(rec[..., channel])
    return np.concatenate([_to_u8(r) for r in rows], axis=0)
