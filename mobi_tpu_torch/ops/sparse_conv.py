"""Submanifold and strided sparse 3D convolution as gather -> GEMM -> scatter
(mobi_tpu ops/sparse_conv.py; the reference's spconv: indice.cc's
rulebook, reordering's gather and scatter-add, maxpool.cc).

The rulebook, the (input row, output row) pairs of each kernel offset, is
planned on the host with a dict over integer coordinates, the JAX planner
as it is. The device part is, for each offset with pairs,
`index_select` of its input rows, one `torch.mm` with that offset's weight
slice, and `index_add_` into the output rows (on CUDA the adds land in no
fixed order, so a card's sums differ from the CPU's by rounding).

Eager PyTorch needs no static shapes, so the detector plans unpadded.
`pad_rulebook` pads a plan to the static caps of
`models.bevfusion.calibrate_static_caps`; since `sparse_conv_apply` reads
only the first `counts[k]` pairs of each offset, a padded plan gives the
same rows as an unpadded one (pad output rows stay zero before the bias;
pad coordinates lie outside the grid, and the dense BEV drops them).

Coordinates are integer [N, 3] (x, y, z) voxel indices.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Rulebook:
    """Gather/scatter plan for one sparse conv layer.

    in_idx / out_idx: [K, P] index pairs per kernel offset, padded (pad rows
    point at n_in / n_out). counts[k] = number of real pairs for offset k.
    """

    in_idx: np.ndarray     # int32 [K, P]
    out_idx: np.ndarray    # int32 [K, P]
    counts: np.ndarray     # int32 [K]
    out_coords: np.ndarray  # int32 [M, 3]
    n_in: int
    n_out: int
    _device: Dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def pairs(self, device) -> Tuple[torch.Tensor, torch.Tensor, list]:
        """(in rows, out rows) of the real pairs, offset after offset, as
        int64 tensors on `device`, and each offset's (k, start, end) slice;
        copied once per device."""
        key = str(torch.device(device))
        if key not in self._device:
            cnt = [int(c) for c in self.counts]
            ins = np.concatenate([self.in_idx[k, :c] for k, c in enumerate(cnt)]).astype(np.int64)
            outs = np.concatenate([self.out_idx[k, :c] for k, c in enumerate(cnt)]).astype(np.int64)
            ends = np.cumsum(cnt)
            slices = [(k, int(e - c), int(e)) for k, (c, e) in enumerate(zip(cnt, ends)) if c]
            self._device[key] = (torch.from_numpy(ins).to(device, non_blocking=True),
                                 torch.from_numpy(outs).to(device, non_blocking=True), slices)
        return self._device[key]


def pad_rulebook(rb: Rulebook, pairs_to: int, out_to: int,
                 n_in: int | None = None) -> Rulebook:
    """Pad a rulebook to fixed shapes (static caps): pairs_to pairs per
    offset, out_to output sites (extra out_coords rows hold a huge
    coordinate that the dense BEV drops), n_in input rows (defaults to
    rb.n_in)."""
    K, p = rb.in_idx.shape
    if pairs_to < p or out_to < rb.n_out:
        raise ValueError(
            f"pad_rulebook: caps (pairs_to={pairs_to}, out_to={out_to}) "
            f"below actual (pairs={p}, n_out={rb.n_out}); raise the static "
            "caps for this point-cloud density"
        )
    n_in = rb.n_in if n_in is None else int(n_in)
    in_idx = np.full((K, pairs_to), n_in, np.int32)
    out_idx = np.full((K, pairs_to), out_to, np.int32)
    in_idx[:, :p] = np.where(rb.in_idx == rb.n_in, n_in, rb.in_idx)
    out_idx[:, :p] = np.where(rb.out_idx == rb.n_out, out_to, rb.out_idx)
    out_coords = np.full((out_to, 3), np.int32(2**30), np.int32)
    out_coords[: rb.n_out] = rb.out_coords
    return Rulebook(
        in_idx=in_idx, out_idx=out_idx, counts=rb.counts,
        out_coords=out_coords, n_in=n_in, n_out=out_to,
    )


def _hash_coords(coords: np.ndarray) -> Dict[Tuple[int, int, int], int]:
    return {tuple(c): i for i, c in enumerate(coords.tolist())}


def build_rulebook(
    coords: np.ndarray,
    kernel_size: Sequence[int] = (3, 3, 3),
    stride: Sequence[int] = (1, 1, 1),
    padding: Sequence[int] = (0, 0, 0),
    spatial_shape: Sequence[int] | None = None,
    submanifold: bool = True,
    pad_to: int | None = None,
) -> Rulebook:
    """Build the (input, output) index pairs per kernel offset on the host
    (indice.cc getIndicePairs semantics).

    * submanifold: output sites == input sites; a pair (i -> o) exists when
      coords[i] == out_coords[o] + offset - kernel//2 (SubMConv3d).
    * strided (submanifold=False): out * stride + offset - padding = in;
      output sites are the reachable cells in input-scan order, bounded by
      (spatial_shape + 2p - k)//s + 1 when `spatial_shape` is given
      (SparseConv3d).
    """
    coords = np.asarray(coords, np.int64)
    n_in = len(coords)
    ks = [int(k) for k in kernel_size]
    st = [int(s) for s in stride]
    pd = [int(p) for p in padding]
    half = [k // 2 for k in ks]

    offsets = list(itertools.product(*[range(k) for k in ks]))
    pairs_in = [[] for _ in offsets]
    pairs_out = [[] for _ in offsets]

    if submanifold:
        out_coords = coords.copy()
        in_of = _hash_coords(coords)
        for oi, oc in enumerate(out_coords.tolist()):
            for k, off in enumerate(offsets):
                ic = tuple(oc[d] + off[d] - half[d] for d in range(3))
                ii = in_of.get(ic)
                if ii is not None:
                    pairs_in[k].append(ii)
                    pairs_out[k].append(oi)
    else:
        if spatial_shape is not None:
            out_shape = [
                (int(spatial_shape[d]) + 2 * pd[d] - ks[d]) // st[d] + 1
                for d in range(3)
            ]
        else:
            out_shape = None
        out_of: Dict[Tuple[int, int, int], int] = {}
        out_list: list = []
        for ii, ic in enumerate(coords.tolist()):
            for k, off in enumerate(offsets):
                tmp = tuple(ic[d] + pd[d] - off[d] for d in range(3))
                if any(t % st[d] != 0 or t < 0 for d, t in enumerate(tmp)):
                    continue
                oc = tuple(t // st[d] for d, t in enumerate(tmp))
                if out_shape is not None and any(
                    oc[d] >= out_shape[d] for d in range(3)
                ):
                    continue
                oi = out_of.get(oc)
                if oi is None:
                    oi = out_of[oc] = len(out_list)
                    out_list.append(oc)
                pairs_in[k].append(ii)
                pairs_out[k].append(oi)
        out_coords = np.asarray(out_list, np.int64).reshape(-1, 3)

    counts = np.asarray([len(p) for p in pairs_in], np.int32)
    p = int(pad_to) if pad_to else max(1, int(counts.max()))
    K = len(offsets)
    in_idx = np.full((K, p), n_in, np.int32)
    out_idx = np.full((K, p), len(out_coords), np.int32)
    for k in range(K):
        in_idx[k, : counts[k]] = pairs_in[k]
        out_idx[k, : counts[k]] = pairs_out[k]
    return Rulebook(
        in_idx=in_idx, out_idx=out_idx, counts=counts,
        out_coords=out_coords.astype(np.int32),
        n_in=n_in, n_out=len(out_coords),
    )


def sparse_conv_apply(features: torch.Tensor, weights: torch.Tensor, rulebook: Rulebook,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """features [N_in, C_in], weights [K, C_in, C_out] (K = prod(kernel))
    -> [N_out, C_out]: per offset, gather -> GEMM -> scatter-add."""
    ins, outs, slices = rulebook.pairs(features.device)
    w = weights.to(features.dtype)
    out = features.new_zeros(rulebook.n_out, w.shape[-1])
    for k, s, e in slices:
        rows = features.index_select(0, ins[s:e])
        out.index_add_(0, outs[s:e], torch.mm(rows, w[k]))
    if bias is not None:
        out = out + bias
    return out


def sparse_maxpool_apply(features: torch.Tensor, rulebook: Rulebook) -> torch.Tensor:
    """Max over all inputs mapped to each output (maxpool.cc); outputs no
    pair reaches are 0."""
    ins, outs, _ = rulebook.pairs(features.device)
    c = features.shape[-1]
    out = features.new_full((rulebook.n_out, c), -torch.inf)
    out.index_reduce_(0, outs, features.index_select(0, ins), "amax")
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))

