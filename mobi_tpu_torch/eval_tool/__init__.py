"""The realism scorers of the port (eval_tool/ of the JAX package), run as
`python -m mobi_tpu_torch.eval_tool.camera.fid_score` and so on.

Every scorer runs on the card unless `--device cpu` is passed, and raises
without one. Its networks compute in fp32 with TF32 off for both matmuls and
cuDNN convolutions for the scope of the call (`metric_scope`), as the JAX
CLIs compute in fp32: a score must not move with the card's default.
Within `reuse_networks()` each scorer builds a network once for the same
weight files and device and reuses it after.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from mobi_tpu_torch.models.diffusion import resolve_device

_reused: Optional[Dict[tuple, torch.nn.Module]] = None


@contextlib.contextmanager
def metric_scope(device) -> Iterator[torch.device]:
    """The scorer's device (CUDA unless another is named; raises without
    one), with TF32 off for matmuls and cuDNN convs and autograd off, for
    the scope; the previous TF32 switches come back after."""
    dev = resolve_device(device)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield dev
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def to_device(batch, device: torch.device) -> torch.Tensor:
    """A host batch [B, H, W, C] float32 -> the device in one copy, NCHW."""
    return torch.from_numpy(np.ascontiguousarray(batch.transpose(0, 3, 1, 2), dtype=np.float32)).to(device)


@contextlib.contextmanager
def reuse_networks() -> Iterator[Dict[tuple, torch.nn.Module]]:
    """A scope in which `network` builds each network once for the same
    build function and arguments (weight paths, device) and hands the same
    one out after; a nested scope shares the outer's networks. They are let
    go when the outermost scope ends."""
    global _reused
    outer = _reused
    if outer is None:
        _reused = {}
    try:
        yield _reused
    finally:
        if outer is None:
            _reused = None


def network(build: Callable[..., torch.nn.Module], *args) -> torch.nn.Module:
    """`build(*args)`, or the network that the same call built before in the
    enclosing `reuse_networks()` scope."""
    if _reused is None:
        return build(*args)
    key = (build.__module__, build.__qualname__) + tuple(str(a) for a in args)
    if key not in _reused:
        _reused[key] = build(*args)
    return _reused[key]
