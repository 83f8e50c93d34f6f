"""Rotated 3D-box IoU and NMS in plain PyTorch, on the caller's device
(mobi_tpu ops/box3d.py; the reference's iou3d CUDA kernels,
mmdet3d/ops/iou3d/src/iou3d_kernel.cu: rotated BEV overlap by polygon
clipping, boxes_iou_bev, nms_gpu).

The pairwise rotated-rectangle intersection is a fixed-size
Sutherland-Hodgman clip, vectorised over every pair as JAX vmaps it: each
intermediate polygon is a padded [..., V, 2] buffer with a vertex count, the
buffer doubling at each of the four clips. `iou_3d` builds the Hungarian's
IoU cost in the TransFusion loss ([200, 128] at the production grid). Greedy
NMS walks a precomputed IoU matrix on the host.

Boxes are [x, y, z, dx, dy, dz, yaw] (centre, full sizes, heading about +z),
mmdet3d's LiDAR box convention.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] -> [..., 4, 2] counter-clockwise footprint corners."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy = boxes[..., 3], boxes[..., 4]
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    ux = torch.stack([dx, dx, -dx, -dx], dim=-1) * 0.5
    uy = torch.stack([-dy, dy, dy, -dy], dim=-1) * 0.5
    cx = x[..., None] + ux * c[..., None] - uy * s[..., None]
    cy = y[..., None] + ux * s[..., None] + uy * c[..., None]
    return torch.stack([cx, cy], dim=-1)


def _polygon_area(verts: torch.Tensor) -> torch.Tensor:
    """Shoelace area of padded [..., V, 2] buffers whose padding repeats the
    first vertex (it adds nothing to the cyclic sum)."""
    nxt = torch.roll(verts, -1, dims=-2)
    cross = verts[..., 0] * nxt[..., 1] - verts[..., 1] * nxt[..., 0]
    return 0.5 * torch.abs(cross.sum(-1))


def _clip_by_edge(verts: torch.Tensor, count: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """One Sutherland-Hodgman pass over [..., V, 2] polygons with [...]
    vertex counts: keep the half-plane left of the directed edge p1 -> p2
    ([..., 2] each). The buffer grows to 2V."""
    v = verts.shape[-2]
    idx = torch.arange(v, device=verts.device)
    valid = idx < count[..., None]
    nxt_idx = torch.where(idx + 1 >= count[..., None], torch.zeros_like(idx), idx + 1)
    cur = verts
    nxt = torch.gather(verts, -2, nxt_idx[..., None].expand(verts.shape))
    edge = p2 - p1

    def side(q):
        return edge[..., None, 0] * (q[..., 1] - p1[..., None, 1]) - edge[..., None, 1] * (q[..., 0] - p1[..., None, 0])

    d_cur, d_nxt = side(cur), side(nxt)
    cur_in, nxt_in = d_cur >= 0, d_nxt >= 0
    den = d_cur - d_nxt
    t = d_cur / torch.where(torch.abs(den) < _EPS, torch.full_like(den, _EPS), den)
    inter = cur + t[..., None] * (nxt - cur)
    # per input vertex: slot 0 the vertex (if inside), slot 1 the crossing
    keep_cur = valid & cur_in
    keep_int = valid & (cur_in != nxt_in)
    cand = torch.stack([cur, inter], dim=-2).reshape(verts.shape[:-2] + (2 * v, 2))
    keep = torch.stack([keep_cur, keep_int], dim=-1).reshape(verts.shape[:-2] + (2 * v,))
    # stable compaction: the kept candidates move to the front in order
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    out = torch.gather(cand, -2, order[..., None].expand(cand.shape))
    new_count = keep.sum(-1)
    # pad the tail with the first vertex so the shoelace closure is exact
    pad = torch.where((new_count > 0)[..., None], out[..., 0, :], torch.zeros_like(out[..., 0, :]))
    slots = torch.arange(2 * v, device=verts.device) < new_count[..., None]
    out = torch.where(slots[..., None], out, pad[..., None, :])
    return out, new_count


def _quad_intersection_area(poly_a: torch.Tensor, poly_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas of counter-clockwise quads [..., 4, 2]."""
    verts = poly_a
    count = torch.full(poly_a.shape[:-2], 4, dtype=torch.int64, device=poly_a.device)
    for k in range(4):
        verts, count = _clip_by_edge(verts, count, poly_b[..., k, :], poly_b[..., (k + 1) % 4, :])
    area = _polygon_area(verts)
    return torch.where(count >= 3, area, torch.zeros_like(area))


def _pairwise_bev_intersection(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    ca, cb = box_corners_bev(boxes_a), box_corners_bev(boxes_b)
    n, m = ca.shape[0], cb.shape[0]
    return _quad_intersection_area(ca[:, None].expand(n, m, 4, 2), cb[None].expand(n, m, 4, 2))


def iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU: [N, 7] x [M, 7] -> [N, M]
    (iou3d_kernel.cu boxes_iou_bev)."""
    inter = _pairwise_bev_intersection(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)


def iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated 3D IoU with the z extents' overlap: [N, 7] x [M, 7]
    -> [N, M] (iou3d.cpp boxes_iou3d_gpu)."""
    inter_bev = _pairwise_bev_intersection(boxes_a, boxes_b)
    za_lo, za_hi = boxes_a[:, 2] - boxes_a[:, 5] / 2, boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb_lo, zb_hi = boxes_b[:, 2] - boxes_b[:, 5] / 2, boxes_b[:, 2] + boxes_b[:, 5] / 2
    z_ov = torch.clamp(torch.minimum(za_hi[:, None], zb_hi[None]) - torch.maximum(za_lo[:, None], zb_lo[None]),
                       min=0.0)
    inter = inter_bev * z_ov
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None]
    return inter / torch.clamp(vol_a + vol_b - inter, min=_EPS)


def nms_3d(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
           bev: bool = True) -> torch.Tensor:
    """Greedy rotated NMS (iou3d nms_gpu): a boolean keep mask in the input
    order. Boxes are visited by descending score (ties by index); a box is
    kept when no kept box before it overlaps it above `iou_threshold`."""
    n = boxes.shape[0]
    order = torch.sort(-scores, stable=True).indices
    sorted_boxes = boxes[order]
    iou = (iou_bev if bev else iou_3d)(sorted_boxes, sorted_boxes).cpu()
    keep_sorted = torch.zeros(n, dtype=torch.bool)
    for i in range(n):
        keep_sorted[i] = not bool((keep_sorted[:i] & (iou[:i, i] > iou_threshold)).any())
    keep = torch.zeros(n, dtype=torch.bool)
    keep[order.cpu()] = keep_sorted
    return keep.to(boxes.device)
