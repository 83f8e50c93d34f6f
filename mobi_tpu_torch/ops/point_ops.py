"""PointNet++-family device ops as torch gathers and contractions (mobi_tpu
ops/point_ops.py).

The irregular neighbour searches (knn, ball_query, furthest_point_sample,
three_nn) run on the host (`mobi_tpu_torch.native`); the ops here are dense
gather-and-contract patterns that belong on the device:

  * gather_points / group_points: the reference's ops/gather_points and
    group_points, channel-last;
  * three_interpolate: ops/interpolate's weighted sum of the 3 nearest
    known features (idx and weights from `native.three_nn`);
  * assign_score_withk: PAConv's scored weight-bank aggregation
    (mmdet3d/ops/paconv/assign_score.py:25-100),
      out[b, d, i, k] = agg_m scores[b, i, k, m] *
          (point_feat[b, knn[b, i, k], m, d] - center_feat[b, knn[b, i, 0], m, d])
    as one gather and one einsum.

Every op runs on the device of its inputs.
"""
from __future__ import annotations

import torch


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, N, C], idx [B, S] -> [B, S, C]."""
    return torch.take_along_dim(features, idx.long()[..., None], dim=1)


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [B, N, C], idx [B, S, K] -> [B, S, K, C]."""
    b, s, k = idx.shape
    return gather_points(features, idx.reshape(b, s * k)).reshape(b, s, k, features.shape[-1])


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """features [B, M, C], idx [B, N, 3], weight [B, N, 3] -> [B, N, C]."""
    return (group_points(features, idx) * weight[..., None]).sum(dim=2)


def assign_score_withk(scores: torch.Tensor, point_features: torch.Tensor, center_features: torch.Tensor,
                       knn_idx: torch.Tensor, aggregate: str = "sum") -> torch.Tensor:
    """scores [B, npoint, K, M], point and center features [B, N, M, D],
    knn_idx [B, npoint, K] (column 0 the center itself) -> [B, D, npoint, K]
    (the CUDA op's layout). `aggregate`: "sum", "avg" or "max"."""
    b, npoint, k = knn_idx.shape
    gathered = group_points(point_features.reshape(b, point_features.shape[1], -1), knn_idx)
    gathered = gathered.reshape(b, npoint, k, *point_features.shape[2:])  # [B, np, K, M, D]
    centers = group_points(center_features.reshape(b, center_features.shape[1], -1), knn_idx[:, :, :1])
    centers = centers.reshape(b, npoint, 1, *center_features.shape[2:])  # [B, np, 1, M, D]
    diff = gathered - centers
    if aggregate == "sum":
        out = torch.einsum("bikm,bikmd->bikd", scores, diff)
    elif aggregate == "avg":
        out = torch.einsum("bikm,bikmd->bikd", scores, diff) / scores.shape[-1]
    elif aggregate == "max":
        out = (scores[..., None] * diff).amax(dim=3)
    else:
        raise ValueError(f"unknown aggregate: {aggregate}")
    return out.permute(0, 3, 1, 2)
