"""Plain float32 building blocks of the reference, over a flat state dict.

Every function takes `P`, a mapping from the published state-dict names
(`model.diffusion_model.input_blocks.1.0.in_layers.2.weight`, ...) to
float32 tensors, and the name of the layer it applies. Nothing here calls
a kernel of the program: convolutions and products are `torch.nn.functional`
and `einsum`, attention is the softmax formula in float32, GroupNorm and
LayerNorm keep float32 statistics.

`operand_cast(fn)` makes every operand of a product or convolution pass
through `fn` first (weights and activations alike): the control computes the
reference so in a lower precision.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Iterator, Mapping, Optional

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]

_CAST: contextvars.ContextVar = contextvars.ContextVar("port_bench_operand_cast", default=None)
# scores of one attention chunk stay under this many float32 elements
ATTN_CHUNK_ELEMENTS = 1 << 28


@contextlib.contextmanager
def operand_cast(fn: Optional[Callable[[torch.Tensor], torch.Tensor]]) -> Iterator[None]:
    token = _CAST.set(fn)
    try:
        yield
    finally:
        _CAST.reset(token)


def op(t: torch.Tensor) -> torch.Tensor:
    fn = _CAST.get()
    return t if fn is None else fn(t)


def linear(P: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(op(x), op(P[name + ".weight"]), P.get(name + ".bias"))


def conv(P: Params, name: str, x: torch.Tensor, stride: int = 1, padding=None) -> torch.Tensor:
    """A convolution; `padding` None is "same" for the odd kernel at stride 1."""
    w = P[name + ".weight"]
    if padding is None:
        padding = (w.shape[2] // 2, w.shape[3] // 2)
    return F.conv2d(op(x), op(w), P.get(name + ".bias"), stride, padding)


def group_norm(P: Params, name: str, x: torch.Tensor, eps: float, groups: int = 32) -> torch.Tensor:
    b, c = x.shape[:2]
    g = min(groups, c)
    xg = x.reshape(b, g, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = (xg - mean).square().mean(dim=-1, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return y * P[name + ".weight"].reshape(shape) + P[name + ".bias"].reshape(shape)


def layer_norm(P: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * P[name + ".weight"] + P[name + ".bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, N, heads * d], in rows of the
    batch small enough that one chunk's scores stay under
    ATTN_CHUNK_ELEMENTS."""
    b, nq, hd = q.shape
    nk, d = k.shape[1], hd // heads
    per_row = heads * nq * nk
    rows = max(1, ATTN_CHUNK_ELEMENTS // per_row)
    outs = []
    for lo in range(0, b, rows):
        qh = op(q[lo:lo + rows]).reshape(-1, nq, heads, d)
        kh = op(k[lo:lo + rows]).reshape(-1, nk, heads, d)
        vh = op(v[lo:lo + rows]).reshape(-1, nk, heads, d)
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * d ** -0.5
        weights = op(torch.softmax(scores, dim=-1))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", weights, vh).reshape(-1, nq, hd))
    return torch.cat(outs)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, cos then sin (the reference UNet's)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """Float32 products and convolutions without TF32 inside."""
    import torch.backends.cuda
    import torch.backends.cudnn

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
