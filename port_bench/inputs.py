"""Seeded inputs in the dataset's batch schema (NHWC float32 numpy, as the
loader hands them over): per pair a camera frame with a box mask and its
masked copy, a 224 x 224 reference crop and the object's 3D box as 8
normalized (x, y, depth) corners; with lidar, the range view (depth,
intensity) with its own box mask and box. Every batch of a run is drawn
from (seed, batch index), so the same seed gives the same inputs and
every batch differs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _rng(seed: int, index: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(x) & ((1 << 64) - 1) for x in (seed, index, stream)])


def _uniform(rng, shape) -> np.ndarray:
    return rng.random(shape, dtype=np.float32) * 2.0 - 1.0


def _box_masks(rng, pairs: int, h: int, w: int) -> np.ndarray:
    """[pairs, h, w, 1]: 1 inside one box a pair, each side 15-50% of the frame."""
    mask = np.zeros((pairs, h, w, 1), np.float32)
    for i in range(pairs):
        bh, bw = (int(rng.uniform(0.15, 0.5) * s) for s in (h, w))
        y0, x0 = int(rng.integers(0, h - bh + 1)), int(rng.integers(0, w - bw + 1))
        mask[i, y0:y0 + bh, x0:x0 + bw] = 1.0
    return mask


def _boxes(rng, pairs: int) -> np.ndarray:
    """[pairs, 8, 3]: the corners of a box, centre 0.2-0.8, extent 0.05-0.3,
    depth 0.1-0.9, every coordinate in [0, 1]."""
    c = rng.uniform(0.2, 0.8, (pairs, 1, 2))
    ext = rng.uniform(0.05, 0.3, (pairs, 1, 2))
    depth = rng.uniform(0.1, 0.9, (pairs, 1, 1))
    dd = rng.uniform(0.01, 0.1, (pairs, 1, 1))
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float64)
    xy = c + 0.5 * ext * signs[None, :, :2]
    d = depth + 0.5 * dd * signs[None, :, 2:]
    return np.clip(np.concatenate([xy, d], axis=-1), 0.0, 1.0).astype(np.float32)


def make_batch(seed: int, index: int, pairs: int, image_size: int, range_size: int,
               use_lidar: bool, use_bbox: bool, ref_size: int = 224) -> Dict:
    rng = _rng(seed, index)
    gt = _uniform(rng, (pairs, image_size, image_size, 3))
    mask = _box_masks(rng, pairs, image_size, image_size)
    cond = {"ref_image": _uniform(rng, (pairs, ref_size, ref_size, 3))}
    if use_bbox:
        cond["ref_bbox"] = _boxes(rng, pairs)
    batch = {"image": {"GT": gt, "inpaint_image": gt * (1.0 - mask), "inpaint_mask": mask, "cond": cond}}
    if use_lidar:
        rd = _uniform(rng, (pairs, range_size, range_size, 2))
        rmask = _box_masks(rng, pairs, range_size, range_size)
        batch["lidar"] = {"range_data": rd, "range_data_inpaint": rd * (1.0 - rmask), "range_mask": rmask,
                          "cond": {"ref_bbox": _boxes(rng, pairs)} if use_bbox else {}}
    return batch


def pairs_of(batch: Dict, lo: int, hi: int) -> Dict:
    """Pairs [lo, hi) of a batch, in the same schema."""
    if isinstance(batch, dict):
        return {k: pairs_of(v, lo, hi) for k, v in batch.items()}
    return batch[lo:hi]


def tree_map(fn, tree):
    return {k: tree_map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)
