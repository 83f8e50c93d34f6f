"""Voxel ops on the device: the LSS splat (bev_pool), dynamic voxelization and
the per-voxel reduction (mobi_tpu ops/voxel_ops.py; the reference's
bev_pool_cuda.cu and scatter_points_cuda.cu DynamicScatter).

Each is one scatter over linearised ids with `index_add_` (sums, counts) or
`index_reduce_` (max). Invalid entries go to an overflow bucket that is cut
off, as in JAX. On CUDA the adds land in no fixed order, so the card's sums
differ from the CPU's by rounding.
"""
from __future__ import annotations

from typing import Sequence

import torch


def bev_pool(feats: torch.Tensor, coords: torch.Tensor, batch_size: int, bev_z: int,
             bev_h: int, bev_w: int) -> torch.Tensor:
    """Sum frustum-point features into BEV cells.

    feats [N, C]; coords [N, 4] int (batch, z, y, x), a coordinate outside
    its extent marks the point invalid. Returns [B, Z, H, W, C]."""
    b, z, y, x = coords.long().unbind(1)
    valid = ((b >= 0) & (b < batch_size) & (z >= 0) & (z < bev_z)
             & (y >= 0) & (y < bev_h) & (x >= 0) & (x < bev_w))
    n_cells = batch_size * bev_z * bev_h * bev_w
    rank = ((b * bev_z + z) * bev_h + y) * bev_w + x
    rank = torch.where(valid, rank, torch.full_like(rank, n_cells))
    out = feats.new_zeros(n_cells + 1, feats.shape[-1])
    out.index_add_(0, rank, feats)
    return out[:n_cells].reshape(batch_size, bev_z, bev_h, bev_w, -1)


def dynamic_voxelize(points: torch.Tensor, voxel_size: Sequence[float], coors_range: Sequence[float],
                     grid_size: Sequence[int]) -> torch.Tensor:
    """[N, >=3] -> [N, 3] (x, y, z) grid coords, -1 out of range (the device
    mirror of `native.dynamic_voxelize`)."""
    vs = torch.as_tensor(voxel_size, dtype=torch.float32, device=points.device)
    lo = torch.as_tensor(coors_range[:3], dtype=torch.float32, device=points.device)
    grid = torch.as_tensor(grid_size, dtype=torch.int32, device=points.device)
    c = torch.floor((points[:, :3].float() - lo) / vs).to(torch.int32)
    bad = ((c < 0) | (c >= grid)).any(dim=1, keepdim=True)
    return torch.where(bad, torch.full_like(c, -1), c)


def dynamic_scatter(feats: torch.Tensor, voxel_ids: torch.Tensor, num_voxels: int,
                    reduce: str = "mean") -> torch.Tensor:
    """Reduce point features into their voxel (DynamicScatter).

    feats [N, C]; voxel_ids [N] in [0, num_voxels) or < 0 (dropped); reduce
    'mean' | 'max' | 'sum'. Returns [num_voxels, C]; empty voxels are 0."""
    ids = voxel_ids.long()
    ids = torch.where(ids < 0, torch.full_like(ids, num_voxels), ids)
    if reduce in ("mean", "sum"):
        s = feats.new_zeros(num_voxels + 1, feats.shape[-1]).index_add_(0, ids, feats)
        if reduce == "sum":
            return s[:num_voxels]
        cnt = feats.new_zeros(num_voxels + 1).index_add_(0, ids, feats.new_ones(feats.shape[0]))
        return s[:num_voxels] / torch.clamp(cnt[:num_voxels, None], min=1.0)
    if reduce == "max":
        m = feats.new_full((num_voxels + 1, feats.shape[-1]), -torch.inf)
        m.index_reduce_(0, ids, feats, "amax")
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        return m[:num_voxels]
    raise ValueError(f"unknown reduce {reduce}")
