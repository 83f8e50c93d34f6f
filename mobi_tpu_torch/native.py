"""ctypes bindings of the C++ host ops (native/mobi_native.cpp), the port's
copy of mobi_tpu/native/__init__.py.

The shared library is compiled from the checkout's `native/mobi_native.cpp`
with g++ at the first call into `build/native/` (gitignored), named by a
hash of the source and flags, so an edited source rebuilds; nothing is
written under `native/`. A failed build raises; `hard_voxelize_numpy` is a
numpy reference of `hard_voxelize` that runs only where a caller names it.

Covered reference native-op families (bevfusion/mmdet3d/ops/):
  voxel (hard/dynamic voxelization), knn, ball_query,
  furthest_point_sample, interpolate (three_nn), roiaware_pool3d
  (points_in_boxes). gather/group are plain indexing (`gather_points` /
  `group_points`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "mobi_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmobi_native_{digest}.so"


def build() -> Path:
    """Compile the library unless the one for this source is there; raises
    on a failed build."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builds each land a whole file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.dynamic_voxelize.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, _f32p, _i32p, _i32p,
        ]
        lib.hard_voxelize.restype = ctypes.c_int64
        lib.hard_voxelize.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, _f32p, _i32p,
            ctypes.c_int64, ctypes.c_int64, _f32p, _i32p, _i32p,
        ]
        lib.knn.argtypes = [
            _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_int64,
            _i32p, _f32p,
        ]
        lib.ball_query.argtypes = [
            _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_float,
            ctypes.c_int64, _i32p,
        ]
        lib.furthest_point_sample.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _i32p,
        ]
        lib.three_nn.argtypes = [
            _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, _f32p, _i32p,
        ]
        lib.points_in_boxes.argtypes = [
            _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, _i32p,
        ]
        _lib = lib
        return _lib


def _grid_size(voxel_size, coors_range) -> np.ndarray:
    vs = np.asarray(voxel_size, np.float32)
    cr = np.asarray(coors_range, np.float32)
    return np.round((cr[3:] - cr[:3]) / vs).astype(np.int32)


# -------------------------------------------------------------- voxelization
def dynamic_voxelize(points: np.ndarray, voxel_size, coors_range) -> np.ndarray:
    """[N, >=3] points -> [N, 3] (x, y, z) grid coords, -1 if out of range
    (the reference's voxelization_cpu.cpp:7-43). The mmdet3d Python wrapper flips
    to (z, y, x); use coors[:, ::-1] for that convention."""
    pts = np.ascontiguousarray(points, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    cr = np.asarray(coors_range, np.float32)
    out = np.empty((len(pts), 3), np.int32)
    _load().dynamic_voxelize(pts, len(pts), pts.shape[1], vs, cr, _grid_size(vs, cr), out)
    return out


def hard_voxelize(
    points: np.ndarray, voxel_size, coors_range, max_points: int = 32, max_voxels: int = 20000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-come-first-serve voxel grouping (voxelization_cpu.cpp:45-120).

    Returns (voxels [V, max_points, F], coors [V, 3] xyz grid indices,
    num_points_per_voxel [V])."""
    pts = np.ascontiguousarray(points, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    cr = np.asarray(coors_range, np.float32)
    nf = pts.shape[1]
    voxels = np.zeros((max_voxels, max_points, nf), np.float32)
    coors = np.zeros((max_voxels, 3), np.int32)
    npv = np.zeros((max_voxels,), np.int32)
    v = _load().hard_voxelize(pts, len(pts), nf, vs, cr, _grid_size(vs, cr),
                              max_points, max_voxels, voxels, coors, npv)
    return voxels[:v], coors[:v], npv[:v]


def hard_voxelize_numpy(
    points: np.ndarray, voxel_size, coors_range, max_points: int = 32, max_voxels: int = 20000,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """`hard_voxelize` in numpy, the same first-come-first-serve semantics."""
    pts = np.ascontiguousarray(points, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    cr = np.asarray(coors_range, np.float32)
    nf = pts.shape[1]
    c = np.floor((pts[:, :3] - cr[:3]) / vs).astype(np.int32)
    c[((c < 0) | (c >= _grid_size(vs, cr))).any(axis=1)] = -1
    voxels = np.zeros((max_voxels, max_points, nf), np.float32)
    coors = np.zeros((max_voxels, 3), np.int32)
    npv = np.zeros((max_voxels,), np.int32)
    vid_of = {}
    v = 0
    for i in range(len(pts)):
        if c[i, 0] < 0:
            continue
        key = tuple(c[i])
        vid = vid_of.get(key)
        if vid is None:
            if v >= max_voxels:
                continue
            vid = vid_of[key] = v
            coors[v] = c[i]
            v += 1
        if npv[vid] < max_points:
            voxels[vid, npv[vid]] = pts[i]
            npv[vid] += 1
    return voxels[:v], coors[:v], npv[:v]


# ----------------------------------------------------------------- point ops
def knn(ref: np.ndarray, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest refs per query -> (idx [N, k], dist2 [N, k])."""
    r = np.ascontiguousarray(ref[:, :3], np.float32)
    q = np.ascontiguousarray(query[:, :3], np.float32)
    idx = np.empty((len(q), k), np.int32)
    d2 = np.empty((len(q), k), np.float32)
    _load().knn(r, len(r), q, len(q), k, idx, d2)
    return idx, d2


def ball_query(ref: np.ndarray, query: np.ndarray, radius: float, nsample: int) -> np.ndarray:
    """First `nsample` refs within `radius` per query, remaining slots repeat
    the first hit (mmdet3d ops/ball_query semantics)."""
    r = np.ascontiguousarray(ref[:, :3], np.float32)
    q = np.ascontiguousarray(query[:, :3], np.float32)
    idx = np.zeros((len(q), nsample), np.int32)
    _load().ball_query(r, len(r), q, len(q), radius, nsample, idx)
    return idx


def furthest_point_sample(points: np.ndarray, npoint: int) -> np.ndarray:
    """Iterative FPS seeded at index 0 -> [npoint] indices."""
    p = np.ascontiguousarray(points[:, :3], np.float32)
    idx = np.empty((npoint,), np.int32)
    _load().furthest_point_sample(p, len(p), npoint, idx)
    return idx


def three_nn(unknown: np.ndarray, known: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """3 nearest knowns per unknown -> (dist2 [N, 3], idx [N, 3])."""
    idx, d2 = knn(known, unknown, 3)
    return d2, idx


def three_interpolate(features: np.ndarray, idx: np.ndarray,
                      dist2: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """Inverse-distance weighted interpolation (ops/interpolate):
    features [M, C], idx/dist2 [N, 3] -> [N, C]."""
    w = 1.0 / (dist2 + eps)
    w = w / w.sum(axis=1, keepdims=True)
    return (features[idx] * w[..., None]).sum(axis=1)


def gather_points(features: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """features [N, C], idx [M] -> [M, C] (ops/gather_points)."""
    return features[idx]


def group_points(features: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """features [N, C], idx [M, K] -> [M, K, C] (ops/group_points)."""
    return features[idx]


def points_in_boxes(points: np.ndarray, boxes7d: np.ndarray) -> np.ndarray:
    """points [N, >=3] x boxes [B, 7] (cx, cy, cz_bottom, dx, dy, dz, yaw) ->
    [N] first containing box index or -1 (ops/roiaware_pool3d
    points_in_boxes_cpu semantics)."""
    p = np.ascontiguousarray(points[:, :3], np.float32)
    b = np.ascontiguousarray(boxes7d, np.float32)
    out = np.empty((len(p),), np.int32)
    _load().points_in_boxes(p, len(p), b, len(b), out)
    return out
