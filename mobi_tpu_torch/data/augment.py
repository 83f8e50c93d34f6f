"""Reference-crop augmentations and image value ranges (mobi_tpu
data/augment.py) on `imgproc`'s cv2 operations.

`ref_augment` makes the JAX package's draws from the same numpy generator in
the same order: flip, angle, blur (and its kernel), contrast/brightness.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from mobi_tpu_torch.data import imgproc
from mobi_tpu_torch.models.clip import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD


def resize_image(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR)."""
    return imgproc.resize_linear(img, h, w)


def ref_augment(
    img: np.ndarray,
    rng: Optional[np.random.Generator] = None,
    size: int = 224,
    enabled: bool = True,
) -> np.ndarray:
    """uint8 HWC crop -> augmented uint8 [size, size, 3]: resize, then with
    `rng` a flip (p 0.5), a rotation by U(-30, 30) degrees with a zero
    border, a k x k box blur (p 0.5, k in {3, 5, 7}) and a contrast and
    brightness change (p 0.5)."""
    img = resize_image(img, size, size)
    if not enabled or rng is None:
        return img

    if rng.uniform() < 0.5:
        img = img[:, ::-1].copy()

    img = imgproc.rotate(img, rng.uniform(-30, 30))

    if rng.uniform() < 0.5:
        k = int(rng.integers(3, 8)) | 1
        img = imgproc.box_blur(img, k)

    if rng.uniform() < 0.5:
        alpha = 1.0 + rng.uniform(-0.3, 0.3)   # contrast
        beta = rng.uniform(-0.3, 0.3) * 255    # brightness
        img = np.clip(img.astype(np.float32) * alpha + beta, 0, 255).astype(np.uint8)

    return img


def to_model_range(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return (img_uint8.astype(np.float32) / 255.0 - 0.5) * 2.0


def to_clip_input(img_uint8: np.ndarray) -> np.ndarray:
    """uint8 -> CLIP-normalized float32 HWC."""
    x = img_uint8.astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_IMAGE_MEAN, np.float32)) / np.asarray(CLIP_IMAGE_STD, np.float32)
