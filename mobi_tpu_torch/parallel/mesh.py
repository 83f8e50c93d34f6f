"""Device mesh and sharding layout of the port (mobi_tpu parallel/mesh.py) on
torch.distributed, one process per device:

  * axis "dp"   - data parallel: each rank of the dp x fsdp grid holds its
    contiguous rows of the batch, and the trainable gradients are averaged
    over dp x fsdp after the backward;
  * axis "fsdp" - ZeRO-style parameter and optimizer sharding: at rest each
    parameter, its optimizer moments and its EMA shadow hold only this
    rank's piece of the dim `param_spec` names; a forward all-gathers one
    block's pieces at a time (`ModelSharding.blockwise`), again for the
    block's backward, and each block's gradients come back reduce-scattered
    onto the pieces as the backward leaves it;
  * axis "tp"   - Megatron-style tensor parallelism on the named projections
    (`_TP_COL_PARALLEL` split their output features, `_TP_ROW_PARALLEL`
    their input features, with the partial sums all-reduced); tp ranks see
    the same batch rows.

GSPMD gives the JAX package all of this from the specs alone; here
`ModelSharding` does it explicitly, and `param_spec` makes the JAX
package's decision for each parameter. A torch weight is [out, in] (a conv
[out, in, kh, kw]) where flax has [in, out] ([kh, kw, in, out]): the spec
is decided in the JAX layout and mapped back, so "the output dim" is torch
dim 0 and a row-parallel split is torch dim 1.

Every rank runs the same program with host RNG in lockstep: under
`Mesh.batch_shard` (ops.draws.batch_shard) the model draws its
per-example randomness (posterior samples, t, noise, x_T) at the global
batch shape from the shared generator and keeps its own rows, so N ranks
reproduce the one-process draws. The camera/lidar interleave needs whole
pairs per rank, hence `shard_batch`'s pair guard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mobi_tpu_torch.ops.draws import batch_shard

Spec = Tuple[Optional[str], ...]

# ---------------------------------------------------------------- the mesh


class Mesh:
    """dp x fsdp [x tp] over every rank of the process group (the tp axis
    exists only when tp > 1, as in the JAX package). `device_mesh` is the
    torch DeviceMesh; `group(axis)` this rank's process group along an
    axis; `batch_group` the dp x fsdp ranks that share this rank's tp
    coordinate (the batch axis); `device` where this rank computes."""

    def __init__(self, dp: int, fsdp: int, tp: int, ranks: Sequence[int], device: torch.device):
        from torch.distributed.device_mesh import DeviceMesh

        self.axis_names = ("dp", "fsdp", "tp") if tp > 1 else ("dp", "fsdp")
        sizes = (dp, fsdp, tp) if tp > 1 else (dp, fsdp)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))
        self.ranks = np.asarray(ranks).reshape(sizes)
        self.device = device
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = DeviceMesh(device_type, torch.as_tensor(self.ranks),
                                      mesh_dim_names=self.axis_names)
        where = np.argwhere(self.ranks == dist.get_rank())[0]
        self.coord: Dict[str, int] = {a: int(c) for a, c in zip(self.axis_names, where)}
        self.coord.setdefault("tp", 0)
        if tp > 1:
            # every rank creates every group, in the same order
            groups = [dist.new_group(self.ranks[..., t].ravel().tolist()) for t in range(tp)]
            self.batch_group = groups[self.coord["tp"]]
        else:
            self.batch_group = dist.group.WORLD

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def batch_shards(self) -> int:
        """dp x fsdp: the number of distinct slices of the batch."""
        return self.shape["dp"] * self.shape["fsdp"]

    @property
    def batch_index(self) -> int:
        """This rank's slice of the batch, in rank order over dp x fsdp."""
        return self.coord["dp"] * self.shape["fsdp"] + self.coord["fsdp"]

    def batch_shard(self):
        """ops.draws.batch_shard at this rank's slice."""
        return batch_shard(self.batch_index, self.batch_shards)


def create_mesh(dp: Optional[int] = None, fsdp: int = 1, tp: int = 1,
                devices: Optional[Sequence[int]] = None) -> Mesh:
    """dp x fsdp [x tp] mesh over `devices`, the global ranks (all of the
    process group by default; a mesh must span the group, one device a
    rank). dp defaults to what is left. Warms the collectives up."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs the process group: call parallel.distributed.initialize")
    world = dist.get_world_size()
    ranks = list(devices) if devices is not None else list(range(world))
    n = len(ranks)
    if dp is None:
        dp = n // (fsdp * tp)
    assert dp * fsdp * tp == n, f"dp({dp}) * fsdp({fsdp}) * tp({tp}) != devices({n})"
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"the mesh must span every rank of the process group (world {world}), got {ranks}")
    from mobi_tpu_torch.parallel.distributed import local_device

    dev = local_device() or (torch.device("cuda", torch.cuda.current_device())
                             if dist.get_backend() == "nccl" else torch.device("cpu"))
    mesh = Mesh(dp, fsdp, tp, ranks, dev)
    warmup_collectives(mesh)
    return mesh


def warmup_collectives(mesh: Mesh) -> None:
    """One tiny all-reduce over the whole mesh, so the communicators connect
    now, while every rank sits at the same point."""
    x = torch.zeros((), device=mesh.device)
    dist.all_reduce(x)


def mesh_process_count(mesh: Mesh) -> int:
    """Processes in the mesh: one a device."""
    return mesh.size


def batch_spec() -> Tuple[Tuple[str, str]]:
    """The batch axis's layout: its leading dim over dp x fsdp."""
    return (("dp", "fsdp"),)


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading (interleaved batch) axis over dp x fsdp of `mesh`,
    replicated over tp: each rank holds its contiguous rows."""
    mesh: Mesh
    spec: Tuple[Tuple[str, str]] = (("dp", "fsdp"),)


def batch_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding(mesh)


# -------------------------------------------------------- the batch layout


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, batch: Any, interleaved: bool = False, local: bool = False) -> Any:
    """This rank's rows of a batch, as tensors on the rank's device: each
    leaf's leading axis is split into `mesh.batch_shards` contiguous slices
    in rank order over dp x fsdp (tp ranks take the same rows).

    The leaves are the GLOBAL batch, the same on every rank (the JAX
    package's single-process input), unless `local`: then they are this
    rank's slice already (what `PrefetchLoader` gives with shard_index =
    `mesh.batch_index`, num_shards = `mesh.batch_shards`), whose global
    length is local x batch_shards, and they are kept whole.

    `interleaved=False` is for per-modality trees whose leading axis counts
    (camera, lidar) pairs. `interleaved=True` declares the axis camera/lidar
    interleaved (2 x pairs): it must divide 2 x dp x fsdp so each rank holds
    whole pairs; a length that divides dp x fsdp but not that raises, since
    a pair would span ranks. A leaf that does not split raises on a mesh of
    more than one process (replicating per-rank data is meaningless); on one
    process the rank keeps the whole leaf. Scalars pass through."""
    n_shards, i = mesh.batch_shards, mesh.batch_index
    nproc = mesh_process_count(mesh)

    def put(x):
        if not (hasattr(x, "shape") and len(x.shape) >= 1):
            return x
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))
        b = t.shape[0] * n_shards if local else t.shape[0]  # the global batch axis
        if interleaved and b % n_shards == 0 and b % (2 * n_shards) != 0:
            raise ValueError(
                f"interleaved batch axis {b} divides dp*fsdp={n_shards} but not "
                f"2*dp*fsdp={2 * n_shards}: a (camera, lidar) pair would span shards. Use a batch "
                "of whole pairs per shard.")
        divisible = b % ((2 if interleaved else 1) * n_shards) == 0
        if not divisible:
            if nproc > 1:
                raise ValueError(
                    f"global batch axis {b} does not divide {'2 * ' if interleaved else ''}"
                    f"dp*fsdp={n_shards}; replicating per-rank data is not meaningful. Pad the batch.")
            return t.to(mesh.device)  # one process: the whole leaf
        if not local:
            rows = b // n_shards
            t = t[i * rows:(i + 1) * rows]
        return t.to(mesh.device)

    return _map_tree(put, batch)


# ---------------------------------------------------- the parameter layout

# Exact module names whose weights split cleanly along heads / channels for
# tensor parallelism (the JAX package's sets, mobi_tpu/parallel/mesh.py:
# 100-106): QKV and MLP in-projections split their OUTPUT features,
# output and MLP out-projections their INPUT features (partial sums,
# all-reduced). Everything else replicates over tp. "proj" is the GEGLU
# in-projection, "out" the feed-forward out-projection of the JAX UNet.
_TP_COL_PARALLEL = frozenset(
    {"to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "fc1", "c_fc", "proj"})
_TP_ROW_PARALLEL = frozenset(
    {"to_out", "out_proj", "fc2", "c_proj", "mlp_c_proj", "out"})

# The port's (reference Lightning) names where the JAX package's name
# decides differently: the UNet's feed-forward out-projection is `ff.net.2`
# there `ff/out` (row-parallel), and the UNet's final norm and conv are
# `out.0` / `out.2` there `out_norm` / `out_conv` (replicated).
_JAX_NAMES = (
    (re.compile(r"(^|\.)ff\.net\.2\.(weight|bias)$"), r"\1ff.out.\2"),
    (re.compile(r"(^|\.)out\.0\.(weight|bias)$"), r"\1out_norm.\2"),
    (re.compile(r"(^|\.)out\.2\.(weight|bias)$"), r"\1out_conv.\2"),
)
# the GEGLU in-projection, whose output is (a, gate) halves
_GEGLU_PROJ = re.compile(r"(^|\.)ff\.net\.0\.proj\.weight$")


def _jax_name(name: str) -> str:
    for pattern, repl in _JAX_NAMES:
        name = pattern.sub(repl, name)
    return name.replace(".", "/")


def _jax_dims(name: str, ndim: int) -> List[int]:
    """The JAX dim of each torch dim: a Dense weight [out, in] is flax's
    [in, out], a conv [out, in, kh, kw] flax's [kh, kw, in, out]; anything
    else (embeddings, vectors) has one layout in both."""
    if ndim == 4:
        return [3, 2, 0, 1]
    if ndim == 2 and not name.endswith("position_embedding.weight"):
        return [1, 0]
    return list(range(ndim))


def _jax_param_spec(shape: Sequence[int], fsdp_size: int, tp_size: int, name: str) -> List[Optional[str]]:
    """mobi_tpu.parallel.mesh.param_spec on the JAX layout, untrimmed."""
    spec: List[Optional[str]] = [None] * len(shape)
    if not shape:
        return spec
    if tp_size > 1 and len(shape) >= 2 and name:
        leaf = next((p for p in reversed(name.split("/"))
                     if p in _TP_ROW_PARALLEL or p in _TP_COL_PARALLEL), None)
        if leaf in _TP_ROW_PARALLEL and shape[-2] % tp_size == 0:
            spec[-2] = "tp"
        elif leaf in _TP_COL_PARALLEL and shape[-1] % tp_size == 0:
            spec[-1] = "tp"
    if fsdp_size > 1:
        # the output (last) dim first, then the largest
        dims = sorted(range(len(shape)), key=lambda i: (i != len(shape) - 1, -shape[i]))
        for i in dims:
            if spec[i] is None and shape[i] % fsdp_size == 0 and shape[i] >= fsdp_size:
                spec[i] = "fsdp"
                break
    return spec


def param_spec(shape: Sequence[int], fsdp_size: int, tp_size: int = 1, name: str = "") -> Spec:
    """The mesh axis of each dim of a parameter of torch shape `shape` named
    `name` (the port's state-dict name): None, "fsdp" or "tp", one entry a
    dim. The JAX package's decision for the same parameter: fsdp on the
    output dim first, then the largest divisible one; tp on the named
    projections (matched right to left over the name's components); 1-D
    leaves never tp-split."""
    shape = tuple(int(s) for s in shape)
    jdims = _jax_dims(name, len(shape))
    jshape = [0] * len(shape)
    for t, j in enumerate(jdims):
        jshape[j] = shape[t]
    jspec = _jax_param_spec(jshape, fsdp_size, tp_size, _jax_name(name))
    return tuple(jspec[jdims[t]] for t in range(len(shape)))


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """A tensor's full shape and the mesh axis of each of its dims. With
    `halves`, a tp split keeps the two halves of the dim alike (the GEGLU
    in-projection: rank r holds the r-th piece of `a` and of `gate`)."""
    shape: Tuple[int, ...]
    spec: Spec
    halves: bool = False

    def dim(self, axis: str) -> Optional[int]:
        return self.spec.index(axis) if axis in self.spec else None

    @property
    def sharded(self) -> bool:
        return any(s is not None for s in self.spec)

    def drop(self, d: int) -> "ParamLayout":
        """The layout of a reduction over dim `d`."""
        d %= len(self.shape)
        return ParamLayout(self.shape[:d] + self.shape[d + 1:], self.spec[:d] + self.spec[d + 1:],
                           self.halves and self.spec[d] != "tp")

    def pieces(self, t: torch.Tensor, axis: str, n: int) -> List[torch.Tensor]:
        """t split into the n pieces the ranks of `axis` hold, in order."""
        d = self.dim(axis)
        if axis == "tp" and self.halves:
            h = t.shape[d] // 2
            a, g = t.narrow(d, 0, h).chunk(n, d), t.narrow(d, h, h).chunk(n, d)
            return [torch.cat([a[i], g[i]], d) for i in range(n)]
        return [p.contiguous() for p in t.chunk(n, d)]

    def join(self, pieces: Sequence[torch.Tensor], axis: str) -> torch.Tensor:
        """The inverse of `pieces`."""
        d = self.dim(axis)
        if axis == "tp" and self.halves:
            h = pieces[0].shape[d] // 2
            return torch.cat([p.narrow(d, 0, h) for p in pieces] + [p.narrow(d, h, h) for p in pieces], d)
        return torch.cat(list(pieces), d)


# --------------------------------------------------- tensor-parallel glue


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over tp (the input of a
    column-parallel projection reaches every tp rank)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """The partial sums of a row-parallel projection all-reduced over tp;
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToTP(torch.autograd.Function):
    """This rank's slice of the last dim of a tensor every tp rank holds
    whole; the backward all-gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.group, ctx.rank, ctx.size = group, rank, size
        return x.chunk(size, -1)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        k = g.shape[-1]
        full = g.new_zeros(g.shape[:-1] + (k * ctx.size,))
        full[..., ctx.rank * k:(ctx.rank + 1) * k] = g
        dist.all_reduce(full, group=ctx.group)
        return full, None, None, None


@dataclasses.dataclass
class TensorParallel:
    """How a Dense layer runs under tp: "col" holds its rank's output
    features (the bias, kept whole as the JAX spec keeps 1-D leaves, is
    sliced to them), "row" its rank's input features (the output all-reduced
    and the bias added once)."""
    mode: str
    group: Any
    rank: int
    size: int
    halves: bool = False

    def linear(self, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               dtype: torch.dtype) -> torch.Tensor:
        w = weight.to(dtype)
        if self.mode == "col":
            x = _CopyToTP.apply(x, self.group)
            b = None
            if bias is not None:
                b = self._bias_slice(_CopyToTP.apply(bias, self.group)).to(dtype)
            return torch.nn.functional.linear(x.to(dtype), w, b)
        if x.shape[-1] != w.shape[1]:  # a whole input: take this rank's features
            x = _ScatterToTP.apply(x, self.group, self.rank, self.size)
        y = _ReduceFromTP.apply(torch.nn.functional.linear(x.to(dtype), w), self.group)
        return y if bias is None else y + bias.to(dtype)

    def _bias_slice(self, b: torch.Tensor) -> torch.Tensor:
        if not self.halves:
            return b.chunk(self.size)[self.rank]
        h = b.shape[0] // 2
        return torch.cat([b[:h].chunk(self.size)[self.rank], b[h:].chunk(self.size)[self.rank]])


# ------------------------------------------------------- model sharding


def _flat_cat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, shapes: Sequence[torch.Size]) -> List[torch.Tensor]:
    """`flat` cut into views of `shapes`."""
    out, o = [], 0
    for shape in shapes:
        out.append(flat[o:o + shape.numel()].view(shape))
        o += shape.numel()
    return out


# the most bytes of pieces one all-gather moves (ModelSharding._iter_gather)
GATHER_BUCKET_BYTES = 128 * 2**20


def _buckets(ids: Sequence[int], nbytes) -> Iterator[List[int]]:
    """`ids` in order, cut into runs of at most GATHER_BUCKET_BYTES (a
    larger tensor alone). Every rank cuts alike: its pieces have the same
    sizes."""
    run: List[int] = []
    size = 0
    for i in ids:
        b = nbytes(i)
        if run and size + b > GATHER_BUCKET_BYTES:
            yield run
            run, size = [], 0
        run.append(i)
        size += b
    if run:
        yield run


def _by_dtype(items):
    groups: Dict[torch.dtype, list] = {}
    for i, t in enumerate(items):
        groups.setdefault(t.dtype, []).append(i)
    return groups.values()


# The modules a blockwise forward makes whole one at a time, by their names
# in the port's state dict: the UNet's input, middle and output blocks, each
# level and middle of each VAE's encoder and decoder, each layer of the CLIP
# tower and of the mapper, and the rest of the conditioning stage. A
# parameter belongs to the innermost such module around it; the others (the
# UNet's time embedding and output head, the VAEs' stems and heads, the
# context projection and the unconditional vectors, a few MB at full width)
# form the root, whole through a blockwise forward and its backward.
_BLOCK = re.compile(r"(^|\.)((input_blocks|output_blocks|layers|resblocks|down|up)\.\d+"
                    r"|middle_block|mid|cond_stage_model)$")
# blocks whole at once besides the root: the one running and the one before
BLOCK_WINDOW = 2


@dataclasses.dataclass
class _Block:
    """The fsdp-sharded parameters of one block: each Parameter (its piece),
    its layout, the (module, name) places it is registered at, and the dtype
    its layers compute in (`_compute_dtype`)."""
    name: str
    params: List[torch.nn.Parameter] = dataclasses.field(default_factory=list)
    layouts: List[ParamLayout] = dataclasses.field(default_factory=list)
    sites: List[List[Tuple[torch.nn.Module, str]]] = dataclasses.field(default_factory=list)
    dtypes: List[torch.dtype] = dataclasses.field(default_factory=list)

    @property
    def trainable(self) -> List[int]:
        return [i for i, p in enumerate(self.params) if p.requires_grad]


@dataclasses.dataclass
class _Whole:
    """A block's whole tensors while it is gathered; `tied` when the
    trainable ones run through _ToPieces (their gradients reach the pieces)."""
    tensors: List[torch.Tensor]
    tied: bool = False


class _Held:
    """What the autograd graph keeps of a whole parameter (or a view of one)
    it saved: the block, the slot and the view's geometry, gathered again
    when the backward reads it."""
    __slots__ = ("block", "slot", "view")

    def __init__(self, block: int, slot: int, view=None):
        self.block, self.slot, self.view = block, slot, view


def _compute_dtype(p: torch.nn.Parameter, sites: List[Tuple[torch.nn.Module, str]]) -> torch.dtype:
    """The dtype a parameter is read in: a Dense or Conv2d weight casts
    itself to its layer's dtype in the forward (models/layers.py), so a
    whole weight installed in that dtype spares the forward a copy, which
    the autograd graph would save whole until the block's backward; any
    other parameter keeps its own dtype."""
    from mobi_tpu_torch.models.layers import Conv2d, Dense

    dts = {m.dtype if isinstance(m, (Dense, Conv2d)) and name == "weight" else p.dtype for m, name in sites}
    return dts.pop() if len(dts) == 1 else p.dtype


class _ToPieces(torch.autograd.Function):
    """The whole tensors of a block's trainable parameters, unchanged, tied to
    their pieces: the backward reduce-scatters the block's gradients over
    fsdp (summed, one collective a dtype) onto the pieces."""

    @staticmethod
    def forward(ctx, sharding, layouts, n, *tensors):
        ctx.sharding, ctx.layouts, ctx.n = sharding, layouts, n
        return tuple(w.view_as(w) for w in tensors[n:])

    @staticmethod
    def backward(ctx, *grads):
        pieces = ctx.sharding.reduce_scatter(list(grads), ctx.layouts)
        return (None, None, None, *pieces, *([None] * ctx.n))


class ModelSharding:
    """The sharding of one module's parameters on a mesh (`shard_params`).

    At rest each parameter's `.data` is its rank's piece: the tp piece,
    then the fsdp piece, of the dims `param_spec` names, and it stays so in
    a step. Inside `blockwise()` a forward gathers the fsdp pieces of one
    block at a time (tp pieces stay, the layers compute on them) and the
    block's modules see the whole tensors in place of their parameters;
    `backward(loss)` gathers each block again as the backward reads it and
    reduce-scatters its gradients onto the pieces; `reduce_grads_()` then
    averages the trainable gradients over dp x fsdp. `gather_()` /
    `scatter_()` / `unsharded()` make every parameter whole and back, for
    code that reads or writes whole weights outside a forward (loads).
    Each parameter carries `_mobi_shard` = (this object, its ParamLayout),
    which the optimizers, the EMA and `training.global_norm` read."""

    def __init__(self, mesh: Mesh, model: torch.nn.Module):
        self.mesh = mesh
        fsdp, tp = mesh.shape["fsdp"], mesh.shape.get("tp", 1)
        self.entries: List[Tuple[str, torch.nn.Parameter, ParamLayout]] = []
        for name, p in model.named_parameters():
            spec = param_spec(tuple(p.shape), fsdp, tp, name)
            layout = ParamLayout(tuple(p.shape), spec, bool(_GEGLU_PROJ.search(name)) and "tp" in spec)
            self.entries.append((name, p, layout))
            p._mobi_shard = (self, layout)
        self.layouts: Dict[str, ParamLayout] = {n: lay for n, _, lay in self.entries}
        self._install_tp(model)
        with torch.no_grad():
            for _, p, layout in self.entries:
                if layout.sharded:
                    p.data = self.local(p.data, layout)
        self.gathered = False
        self.blocks: List[_Block] = self._find_blocks(model) if fsdp > 1 else []
        self._mode: Optional[str] = None  # None, "forward" or "backward" (blockwise)
        self._window: Dict[int, _Whole] = {}  # gathered blocks, oldest first
        self._packable: Dict[int, Tuple[int, int]] = {}  # id(whole) -> (block, slot)

    # -- layout helpers
    def axis_size(self, axis: str) -> int:
        return self.mesh.shape.get(axis, 1)

    def local(self, full: torch.Tensor, layout: ParamLayout, axes=("tp", "fsdp")) -> torch.Tensor:
        """This rank's piece of a whole tensor laid out as `layout`, in
        memory of its own (a view would keep the whole tensor alive); the
        tensor itself where no axis of `axes` splits it."""
        t = full
        for axis in axes:
            if layout.dim(axis) is not None:
                t = layout.pieces(t, axis, self.axis_size(axis))[self.mesh.coord[axis]]
        return t if t is full else t.clone(memory_format=torch.contiguous_format)

    def _iter_gather(self, tensors: List[Optional[torch.Tensor]], layouts: List[ParamLayout],
                     axis: str) -> Iterator[Tuple[int, torch.Tensor]]:
        """(i, whole over `axis`) for each tensors[i] sharded on `axis`,
        all-gathered in buckets of one dtype and at most GATHER_BUCKET_BYTES
        of pieces: a gather holds one bucket's buffers at a time, and a
        caller that drops tensors[i] once it has its whole frees the piece
        as it goes."""
        idx = [i for i, lay in enumerate(layouts) if lay.dim(axis) is not None]
        if not idx:
            return
        n, group = self.axis_size(axis), self.mesh.group(axis)
        for sel in _by_dtype([tensors[i] for i in idx]):
            ids = [idx[j] for j in sel]
            for bucket in _buckets(ids, lambda i: tensors[i].numel() * tensors[i].element_size()):
                shapes = [tensors[i].shape for i in bucket]
                flat = _flat_cat([tensors[i] for i in bucket])
                full = flat.new_empty(flat.numel() * n)
                dist.all_gather_into_tensor(full, flat, group=group)
                del flat
                per_rank = [_unflat(chunk, shapes) for chunk in full.chunk(n)]
                for k, i in enumerate(bucket):
                    yield i, layouts[i].join([per_rank[r][k] for r in range(n)], axis)

    def full(self, tensors: List[torch.Tensor], layouts: List[ParamLayout]) -> List[torch.Tensor]:
        """Whole tensors from every rank's pieces (fsdp, then tp)."""
        out = list(tensors)
        for axis in ("fsdp", "tp"):
            for i, whole in self._iter_gather(out, layouts, axis):
                out[i] = whole
        return out

    # -- blocks
    def _find_blocks(self, model: torch.nn.Module) -> List[_Block]:
        """The root (index 0) and each block (_BLOCK) with its fsdp-sharded
        parameters; a forward pre-hook on every module of a block gathers
        the block. A parameter registered in two blocks joins the root."""
        names = [n for n, _ in model.named_modules() if n and _BLOCK.search(n)]

        def owner(mname: str) -> str:
            return max((b for b in names if mname == b or mname.startswith(b + ".")), key=len, default="")

        index = {"": 0, **{b: i + 1 for i, b in enumerate(names)}}
        owners: Dict[int, set] = {}
        sites: Dict[int, List[Tuple[torch.nn.Module, str]]] = {}
        params: Dict[int, torch.nn.Parameter] = {}
        for mname, m in model.named_modules():
            blk = owner(mname)
            if blk:
                m.register_forward_pre_hook(lambda mod, args, i=index[blk]: self._enter(i))
            for pname, p in m._parameters.items():
                if p is None or p._mobi_shard[1].dim("fsdp") is None:
                    continue
                owners.setdefault(id(p), set()).add(blk)
                sites.setdefault(id(p), []).append((m, pname))
                params[id(p)] = p
        blocks = [_Block("")] + [_Block(b) for b in names]
        for key, p in params.items():
            b = blocks[index[next(iter(owners[key]))] if len(owners[key]) == 1 else 0]
            b.params.append(p)
            b.layouts.append(p._mobi_shard[1])
            b.sites.append(sites[key])
            b.dtypes.append(_compute_dtype(p, sites[key]))
        return blocks

    def _enter(self, i: int) -> None:
        if self._mode is not None:
            self._ensure(i)

    def _gather_block(self, blk: _Block) -> List[torch.Tensor]:
        out: List[Optional[torch.Tensor]] = [None] * len(blk.params)
        with torch.no_grad():
            for j, whole in self._iter_gather([p.detach() for p in blk.params], blk.layouts, "fsdp"):
                out[j] = whole
        return out

    def _place(self, i: int, whole: _Whole) -> None:
        """Each module of block i sees the whole tensors in place of its
        parameters; the autograd graph saves them as handles."""
        for j, (t, sites) in enumerate(zip(whole.tensors, self.blocks[i].sites)):
            for m, pname in sites:
                m._parameters[pname] = t
            self._packable[id(t)] = (i, j)
            if t._base is not None:  # a tied tensor: views of it have its base
                self._packable[id(t._base)] = (i, j)

    def _evict(self, i: int) -> None:
        whole = self._window.pop(i)
        blk = self.blocks[i]
        for t, p, sites in zip(whole.tensors, blk.params, blk.sites):
            self._packable.pop(id(t), None)
            if t._base is not None:
                self._packable.pop(id(t._base), None)
            for m, pname in sites:
                m._parameters[pname] = p

    def _ensure(self, i: int) -> _Whole:
        """Block i gathered (tied to its pieces when a forward records
        gradients), the most recent of the window; the oldest blocks beyond
        BLOCK_WINDOW let go (the root stays). Trainable tensors that record
        gradients are installed in their compute dtype: the fp32 whole goes
        as soon as its cast is made, and its gradient comes back through
        the cast, in fp32."""
        blk = self.blocks[i]
        whole = self._window.get(i)
        fresh = whole is None
        if fresh:
            whole = _Whole(self._gather_block(blk))
            if self._mode == "backward":  # a recompute (remat) records what the forward did
                for j in blk.trainable:
                    whole.tensors[j] = whole.tensors[j].requires_grad_(True).to(blk.dtypes[j])
        if self._mode == "forward" and not whole.tied and torch.is_grad_enabled() and blk.trainable:
            if not fresh:
                self._evict(i)
            tr = blk.trainable
            tied = _ToPieces.apply(self, [blk.layouts[j] for j in tr], len(tr),
                                   *[blk.params[j] for j in tr], *[whole.tensors[j] for j in tr])
            for j, t in zip(tr, tied):
                whole.tensors[j] = t.to(blk.dtypes[j])
            whole.tied, fresh = True, True
        if fresh:
            self._place(i, whole)
        self._window.pop(i, None)
        self._window[i] = whole
        while sum(1 for k in self._window if k) > BLOCK_WINDOW:
            self._evict(next(k for k in self._window if k))
        return whole

    def _pack(self, t: torch.Tensor):
        key = self._packable.get(id(t))
        if key is not None:
            return _Held(*key)
        key = None if t._base is None else self._packable.get(id(t._base))
        return t if key is None else _Held(*key, (t.size(), t.stride(), t.storage_offset()))

    def _unpack(self, h):
        if not isinstance(h, _Held):
            return h
        if self._mode is None:
            raise RuntimeError("a blockwise graph's backward runs inside ModelSharding.blockwise()")
        t = self._ensure(h.block).tensors[h.slot]
        return t if h.view is None else t.detach().as_strided(*h.view)

    @contextlib.contextmanager
    def blockwise(self) -> Iterator[None]:
        """Forwards inside hold whole the root's parameters and those of at
        most BLOCK_WINDOW blocks, each gathered as its first module runs;
        the backward of their graph runs inside too (`backward`). A no-op
        without fsdp, inside another blockwise() and while `gather_()` holds
        every parameter whole."""
        if not self.blocks or self._mode is not None or self.gathered:
            yield
            return
        self._mode = "forward"
        try:
            with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
                self._ensure(0)
                yield
        finally:
            for i in list(self._window):
                self._evict(i)
            self._mode = None

    def backward(self, loss: torch.Tensor) -> None:
        """loss.backward() of a graph recorded inside `blockwise()`: each
        block is gathered again when the backward reads its weights, and its
        trainable gradients are reduce-scattered onto the pieces as the
        backward leaves it."""
        if self._mode is not None:
            self._mode = "backward"
        loss.backward()

    @torch.no_grad()
    def reduce_scatter(self, grads: List[torch.Tensor], layouts: List[ParamLayout]) -> List[torch.Tensor]:
        """Whole gradients -> this rank's fsdp pieces of their sum over the
        fsdp ranks, one reduce-scatter a dtype (rank-major buckets)."""
        n = self.axis_size("fsdp")
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        for sel in _by_dtype(grads):
            pieces = [layouts[i].pieces(grads[i], "fsdp", n) for i in sel]
            bucket = torch.cat([_flat_cat([pc[r] for pc in pieces]) for r in range(n)])
            mine = bucket.new_empty(bucket.numel() // n)
            dist.reduce_scatter_tensor(mine, bucket, group=self.mesh.group("fsdp"))
            for i, g in zip(sel, _unflat(mine, [pc[0].shape for pc in pieces])):
                out[i] = g
        return out

    # -- whole parameters outside a forward (loads)
    @torch.no_grad()
    def gather_(self) -> None:
        """Put each parameter's fsdp pieces together (a no-op without fsdp),
        a bucket at a time, each piece freed once its whole is in place."""
        if self.gathered:
            return
        self.gathered = True
        if self.axis_size("fsdp") == 1:
            return
        ps = [p for _, p, _ in self.entries]
        pieces: List[Optional[torch.Tensor]] = [p.data for p in ps]
        for i, whole in self._iter_gather(pieces, [lay for _, _, lay in self.entries], "fsdp"):
            ps[i].data = whole
            pieces[i] = None

    @torch.no_grad()
    def scatter_(self) -> None:
        """Back to rest: each parameter its rank's fsdp piece."""
        if not self.gathered:
            return
        self.gathered = False
        if self.axis_size("fsdp") == 1:
            return
        for _, p, layout in self.entries:
            if layout.dim("fsdp") is not None:
                p.data = self.local(p.data, layout, axes=("fsdp",))

    @contextlib.contextmanager
    def unsharded(self) -> Iterator[None]:
        """Every parameter whole inside (its .data), at rest after; what is
        written into them inside is kept (each rank keeps its piece)."""
        was = self.gathered
        self.gather_()
        try:
            yield
        finally:
            if not was:
                self.scatter_()

    @torch.no_grad()
    def reduce_grads_(self, params: Sequence[torch.nn.Parameter]) -> None:
        """After a step's backward: each gradient of `params` (zeros where
        the step left none) summed over dp x fsdp and divided by dp x fsdp,
        on its piece. The fsdp-sharded gradients arrive summed over fsdp
        from the backward (`reduce_scatter`) and go through one all-reduce
        over dp a dtype; the others through one all-reduce over the batch
        ranks a dtype."""
        n_batch = self.mesh.batch_shards
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        sh = [i for i, p in enumerate(params) if p._mobi_shard[1].dim("fsdp") is not None]
        rep = [i for i, p in enumerate(params) if p._mobi_shard[1].dim("fsdp") is None]
        dp_group = self.mesh.group("dp") if self.mesh.shape["dp"] > 1 else None
        for ids, group in ((sh, dp_group), (rep, self.mesh.batch_group)):
            for sel in _by_dtype([grads[i] for i in ids]):
                sub = [ids[j] for j in sel]
                flat = _flat_cat([grads[i] for i in sub])
                if group is not None:
                    dist.all_reduce(flat, group=group)
                flat.div_(n_batch)
                for i, g in zip(sub, _unflat(flat, [grads[i].shape for i in sub])):
                    params[i].grad = g

    # -- reductions over sharded dims (the optimizers, the global norm)
    def sum_over(self, t: torch.Tensor, layout: ParamLayout, dims: Optional[Sequence[int]] = None) -> torch.Tensor:
        """t.sum(dims) (every dim when None) with the sums over the sharded
        ones completed across their ranks; keepdim=False."""
        nd = len(layout.shape)
        dims = list(range(nd)) if dims is None else [d % nd for d in dims]
        s = t.sum(dim=dims) if dims else t
        for axis in ("fsdp", "tp"):
            if layout.dim(axis) in dims:
                s = s.contiguous()
                dist.all_reduce(s, group=self.mesh.group(axis))
        return s

    def counted_here(self, layout: ParamLayout) -> bool:
        """Whether this rank counts a value laid out as `layout` in a sum
        over the world: the one copy at coordinate 0 of every axis that does
        not shard it."""
        return all(self.mesh.coord.get(a, 0) == 0 for a in ("dp", "fsdp", "tp") if layout.dim(a) is None)

    # -- host copies (checkpoints)
    def _opt_layouts(self, opt) -> List[Dict[str, Optional[ParamLayout]]]:
        """The layout of each optimizer state entry of each parameter."""
        out = []
        for p in opt.params:
            lay = p._mobi_shard[1]
            st = opt.inner.state.get(p, {})
            entry = {}
            for k, v in st.items():
                if not isinstance(v, torch.Tensor) or v.dim() == 0:
                    entry[k] = None
                elif k in ("v_row", "v_col"):
                    d1, d0 = opt.inner.factored_dims(lay.shape)
                    entry[k] = lay.drop(d0 if k == "v_row" else d1)
                else:
                    entry[k] = lay
            out.append(entry)
        return out

    @property
    def sharded(self) -> bool:
        """Whether any parameter is split (fsdp or tp); a dp-only sharding
        leaves every rank the whole model."""
        return any(lay.sharded for _, _, lay in self.entries)

    def _to_host(self, tensors: List[torch.Tensor], layouts: List[ParamLayout], keep: bool) -> List[Any]:
        """Whole host copies of `tensors` (None each without `keep`),
        gathered a run of at most GATHER_BUCKET_BYTES of pieces at a time:
        the device holds one run's whole tensors at once, never the model's."""
        out: List[Any] = []
        for run in _buckets(range(len(tensors)), lambda i: tensors[i].numel() * tensors[i].element_size()):
            whole = self.full([tensors[i] for i in run], [layouts[i] for i in run])
            out.extend(w.detach().cpu() if keep else None for w in whole)
        return out

    def host_state(self, state, keep: bool = True) -> Optional[Dict[str, Any]]:
        """replicate_to_host of a TrainState whose model this shards (at
        rest: a step cut short is put back first). Every rank must call it
        (the pieces are all-gathered); only with `keep` does the rank copy
        the whole tensors to the host and return them, else None."""
        self.scatter_()
        names = [n for n, _, _ in self.entries]
        whole = self._to_host([p.data for _, p, _ in self.entries], [lay for _, _, lay in self.entries], keep)
        model = dict(zip(names, whole)) if keep else None
        opt = None
        if state.opt is not None:
            o = state.opt
            sd = o.inner.state_dict()  # its per-parameter dicts are the live ones: copy them
            sd = {**sd, "state": {i: dict(st) for i, st in sd["state"].items()}}
            lays = self._opt_layouts(o)
            keys = [(i, k) for i, entry in enumerate(lays) for k, lay in entry.items() if lay is not None]
            got = self._to_host([sd["state"][i][k] for i, k in keys], [lays[i][k] for i, k in keys], keep)
            for (i, k), v in zip(keys, got):
                sd["state"][i][k] = v
            acc = None if o._acc is None else self._to_host(list(o._acc), [p._mobi_shard[1] for p in o.params], keep)
            opt = {"inner": sd, "count": o.count, "mini_step": o.mini_step, "acc": acc}
        ema = None
        if state.ema is not None:
            from mobi_tpu_torch.convert import UNET_PREFIX

            snames = list(state.ema.shadow)
            got = self._to_host([state.ema.shadow[n] for n in snames],
                                [self.layouts[UNET_PREFIX + n] for n in snames], keep)
            if keep:
                ema = {"shadow": dict(zip(snames, got)), "num_updates": state.ema.num_updates}
        return {"model": model, "optimizer": opt, "ema": ema} if keep else None

    def local_model_state(self, full_sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole state dict -> this rank's pieces (for load_state_dict)."""
        return {k: self.local(torch.as_tensor(v), self.layouts[k]) if k in self.layouts else v
                for k, v in full_sd.items()}

    def local_optimizer_state(self, opt, saved: Dict[str, Any]) -> Dict[str, Any]:
        """A whole saved optimizer state (checkpoint form) -> this rank's."""
        saved = dict(saved)
        inner = dict(saved["inner"])
        state = {}
        for i, st in inner["state"].items():
            lay = opt.params[i]._mobi_shard[1]
            entry = {}
            for k, v in st.items():
                if isinstance(v, torch.Tensor) and v.dim() > 0:
                    if k in ("v_row", "v_col"):
                        d1, d0 = opt.inner.factored_dims(lay.shape)
                        v = self.local(v, lay.drop(d0 if k == "v_row" else d1))
                    else:
                        v = self.local(v, lay)
                entry[k] = v
            state[i] = entry
        inner["state"] = state
        saved["inner"] = inner
        if saved.get("acc") is not None:
            saved["acc"] = [self.local(a, p._mobi_shard[1]) for a, p in zip(saved["acc"], opt.params)]
        return saved

    def local_ema_shadow(self, shadow: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        from mobi_tpu_torch.convert import UNET_PREFIX

        return {n: self.local(v, self.layouts[UNET_PREFIX + n]) for n, v in shadow.items()}

    # -- tensor parallelism
    def _install_tp(self, model: torch.nn.Module) -> None:
        tp = self.axis_size("tp")
        if tp == 1:
            return
        from mobi_tpu_torch.models.layers import Dense

        for mname, m in model.named_modules():
            own = {n: p for n, p in m.named_parameters(recurse=False)}
            split = [n for n in own if self.layouts[f"{mname}.{n}" if mname else n].dim("tp") is not None]
            if not split:
                continue
            if not isinstance(m, Dense) or split != ["weight"]:
                raise ValueError(f"{mname}: tp splits {split} of a {type(m).__name__}; only Dense "
                                 "weights run tensor-parallel")
            layout = self.layouts[f"{mname}.weight"]
            d = layout.dim("tp")
            if layout.halves and (layout.shape[0] // 2) % tp:
                raise ValueError(f"{mname}: the GEGLU halves of {layout.shape[0]} do not split over tp={tp}")
            m.tp = TensorParallel("col" if d == 0 else "row", self.mesh.group("tp"), self.mesh.coord["tp"],
                                  tp, layout.halves)
        for mname, m in model.named_modules():
            heads = getattr(m, "heads", None)
            q = getattr(m, "to_q", None) or getattr(m, "q_proj", None)
            if heads is not None and q is not None and getattr(q, "tp", None) is not None and heads % tp:
                raise ValueError(f"{mname}: {heads} heads do not split over tp={tp}")


def shard_params(mesh: Mesh, model: torch.nn.Module) -> ModelSharding:
    """Shard `model`'s parameters on `mesh` in place (param_spec decides
    each one) and return the sharding; a model already sharded returns its
    own. Every rank must hold the same weights when it is called (the same
    seed or checkpoint), as in the JAX package."""
    existing = model_sharding(model)
    if existing is not None:
        if existing.mesh is not mesh:
            raise ValueError("the model is already sharded on another mesh")
        return existing
    sharding = ModelSharding(mesh, model)
    model._mobi_sharding = sharding
    return sharding


def model_sharding(model: torch.nn.Module) -> Optional[ModelSharding]:
    return getattr(model, "_mobi_sharding", None)


def all_gather_rows(mesh: Mesh, tree: Any) -> Any:
    """Each leaf's rows from every batch shard, concatenated in rank order
    (the batch axis made whole on every rank)."""
    n = mesh.batch_shards

    def gather(t):
        if not isinstance(t, torch.Tensor) or t.dim() == 0 or n == 1:
            return t
        t = t.contiguous()
        out = t.new_empty((t.shape[0] * n,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=mesh.batch_group)
        return out

    return _map_tree(gather, tree)


def mean_over_batch(mesh: Mesh, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-rank means over equal batch shards -> the global means, on every
    rank (one all-reduce; tp ranks hold equal values, so the world sum is
    tp times the dp x fsdp sum)."""
    keys = list(values)
    if not keys:
        return {}
    stacked = torch.stack([values[k].detach().float().reshape(()) for k in keys]).to(mesh.device)
    dist.all_reduce(stacked)
    stacked /= mesh.size
    return dict(zip(keys, stacked.unbind()))
