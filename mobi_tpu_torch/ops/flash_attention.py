"""Flash attention, forward and backward: the plain PyTorch versions, the
wrappers that launch the CUDA kernels on the card, and the autograd wiring.

Replaces the five TPU kernels of `mobi_tpu/ops/flash_attention.py`:

  K1 `_flash_kernel` (launched by `_flash_fwd_impl`): non-causal
     softmax(Q K^T d^-1/2) V with the dots in the input dtype and fp32
     accumulation, the online max and sum in fp32, P cast to V's dtype
     before P V, the output in the input dtype. CUDA: `csrc/flash_fwd.cu`,
     in bf16 and in fp32. Plain version: `attention_plain`.
  K2 `_flash_kernel_tav` (picked by `_flash_fwd_impl` when
     `MOBI_FLASH_TRANSPOSED_AV=1` and d < 64): K1's function with the
     output accumulator held as O^T [D, TQ] and P V taken as V^T P^T.
     CUDA: `csrc/flash_fwd_tav.cu`, bf16 and fp32, head dims that pad to
     48. Its plain version is K1's, `attention_plain`. On the H100, in bf16
     its output equals K1's bit for bit (the same products, summed in the
     same order with the operands swapped); in fp32 the two differ at
     rounding level (the 3xTF32 cross terms are summed in another order).
     It takes about 1.4x K1's time (PERF.md), so the switch stays off by
     default, as in the JAX package.
  K3 `_flash_kernel_lse` (`_flash_fwd_lse_impl`): K1 plus the per-row fp32
     logsumexp lse = m + log l that the backward needs. CUDA: the same
     kernel, instantiated with an lse output.
  K4 `_flash_bwd_dq_kernel` and K5 `_flash_bwd_dkv_kernel` (`_flash_bwd_impl`):
     with P = exp(Q K^T d^-1/2 - lse) recomputed, delta = rowsum(dO * O) and
     dS = P * (dO V^T - delta) * d^-1/2 cast to the input dtype,
     dQ = dS K (K4) and dK = dS^T Q, dV = P^T dO with P cast to dO's dtype
     (K5). CUDA: `csrc/flash_bwd.cu`. delta is one PyTorch reduction outside
     the kernels, as in the JAX package.

`flash_attention` is the entry point. A call that needs no gradient (grad
disabled, or none of q, k, v requires grad) runs `flash_fwd` alone: K1, or
K2 when the transposed-accumulator switch is on and d < 64. A call that does
goes through `FlashAttention`, an autograd Function: K3 forward, K4 and K5
backward. `MOBI_FLASH_BWD=xla` (the JAX package's switch, default "pallas")
makes the forward `flash_fwd` and the backward autograd through
`attention_plain`. On a CPU tensor every wrapper computes its plain version;
on a CUDA tensor it launches its kernel or raises. K1 and K2 take bf16 and
fp32, K3-K5 bf16 only (every shipped diffusion config trains in bf16).

What bounds the kernels on the H100. Per (batch, head) at N queries and keys
of head dim d, K1 and K3 do 4 N^2 d tensor-core flops and N^2 exponentials,
K4 6 N^2 d flops (S, dP and dQ) and N^2 exponentials, K5 8 N^2 d flops (S,
dP, dV and dK) and N^2 exponentials, each moving O(N d) bytes. At the UNet's
shapes (N = 4096, d = 40 at the 64x64 level; N = 1024, d = 80 at 32x32) the
bytes are far below both other bounds, and at d = 40 the N^2 exponentials
on the special-function units (about 3.9 T/s) take longer than the products
on the tensor cores (989 TFLOP/s bf16) in K1, K3 and K4, while in K5 the
products come close: all are bound by operations.

What the designs do about it. The N x N matrices never leave the chip. The
forward keeps 128 query rows per block of 8 warps in registers and streams K
and V through shared memory in 64-key tiles (K2 as K1, with each warp's
accumulator tiles O^T [48 x 16], the softmax statistics brought to its
columns by warp shuffles, and the output staged through shared memory for
row-contiguous stores); K4 keeps 64 query rows (Q and
dO fragments) per block of 4 warps and streams K and V; K5 keeps 64 keys (K
and V fragments) and streams Q, dO, lse and delta. Every stream is
double-buffered with `cp.async`, so the next tile's loads run under this
tile's math. The softmax runs in base 2 with log2(e) folded into the scale
(and into lse in the backward): one `ex2.approx` per logit. All products
use `mma.sync` m16n8k16 on bf16, with fragments read by `ldmatrix`
(transposed by `ldmatrix.trans` where a tile is the product's right operand
along its rows); the head dim is zero-padded to a multiple of 16 for the
contraction (40 -> 48 adds 20% to the mma work, none to the exponentials).
The backward is two kernels with no reduction across blocks, so its
gradients are the same from run to run. fp32 inputs (K1, K2) run both
products as 3xTF32 on mma.sync m16n8k8: each operand split into two tf32
halves, three products, which keeps them accurate to fp32 (plain TF32 would
keep 11 bits), at three times the tf32 work. `wgmma`/TMA and warp
specialisation are not used: they are the next step to the tensor-core rate.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops._autograd import grad_of_plain

LOG2E = 1.4426950408889634
# The kernels are built for head dims padded to 48 and 80: the UNet's d = 40
# (64x64 level) and d = 80 (32x32 level), the only flash calls of the model.
PADDED_HEAD_DIMS = (48, 80)

# How a call that needs a gradient runs (mobi_tpu flash_attention.py
# `_BWD_MODE`, read at import as there): "pallas" = K3 forward, K4 + K5
# backward; "xla" = K1 forward, autograd through `attention_plain` backward.
BWD_MODE = os.environ.get("MOBI_FLASH_BWD", "pallas")

# The transposed-accumulator forward K2 for head dims below 64 (mobi_tpu
# flash_attention.py `TRANSPOSED_AV`, read at import as there; off by
# default). `set_transposed_av` flips it within a process.
TRANSPOSED_AV = os.environ.get("MOBI_FLASH_TRANSPOSED_AV", "0") == "1"
TAV_MAX_HEAD_DIM = 64  # K2 serves d < 64, as in the JAX package


def set_transposed_av(on: bool) -> None:
    """Switch the no-gradient forward between K1 and, for d < 64, K2."""
    global TRANSPOSED_AV
    TRANSPOSED_AV = bool(on)

# ----------------------------------------------------------- plain versions
def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[B, N, H, D] attention with fp32 logits and softmax; the weights are
    cast to V's dtype before the second product (mobi_tpu
    ops/attention.py::_xla_attention, flash_attention.py::_xla_reference).
    mask: optional [B, Nq, Nk] bool, True = keep."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(
            ~mask[:, None], torch.finfo(torch.float32).min
        )
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function: ([B, Nq, H, D] output, fp32 [B, H, Nq] logsumexp of
    each query row's scaled logits)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(logits, dim=-1)
    weights = torch.exp(logits - lse[..., None]).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v), lse


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, [B, N, H, D] -> [B, H, N]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs_and_dscores(q, k, v, do, lse, delta):
    """P = exp(S * scale - lse) in fp32 and dS = P (dO V^T - delta) scale in
    q's dtype, [B, H, Nq, Nk]; every product in fp32 (mobi_tpu
    flash_attention.py:316-325, 349-363)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta) -> torch.Tensor:
    """K4's function: dQ = dS K, in q's dtype."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta)
    return torch.einsum("bhqk,bkhd->bqhd", ds.float(), k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's function: (dK = dS^T Q, dV = P^T dO with P in dO's dtype)."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float()).to(k.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float()).to(v.dtype)
    return dk, dv


def flash_bwd_plain(q, k, v, o, lse, do):
    """The JAX kernels' backward formula (mobi_tpu flash_attention.py:210-223,
    303-373): (dq, dk, dv) from the forward's o and lse."""
    delta = flash_bwd_delta(o, do)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    return flash_bwd_dq_plain(q, k, v, do, lse, delta), dk, dv


# ------------------------------------------------------------- entry point
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: [B, Nq, H, D], k, v: [B, Nk, H, D] (strided views allowed, unit
    stride in D) -> [B, Nq, H, D] contiguous, differentiable."""
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_fwd(q, k, v)
    if BWD_MODE == "pallas":
        return FlashAttention.apply(q, k, v)
    if BWD_MODE == "xla":
        return _PlainBackward.apply(q, k, v)
    raise ValueError(f"MOBI_FLASH_BWD={BWD_MODE!r}: expected 'pallas' or 'xla'")


class FlashAttention(torch.autograd.Function):
    """K3 forward, saving (q, k, v, o, lse); delta, K4 and K5 backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd_lse(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do.contiguous())


class _PlainBackward(torch.autograd.Function):
    """MOBI_FLASH_BWD=xla: K1 forward; the backward recomputes
    `attention_plain` and differentiates it (mobi_tpu flash_attention.py
    `_bwd` in xla mode)."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return flash_fwd(q, k, v)

    @staticmethod
    def backward(ctx, do):
        return grad_of_plain(attention_plain, ctx.saved_tensors, ctx.needs_input_grad, do)


# ------------------------------------------------------------------ wrappers
def flash_fwd(q, k, v) -> torch.Tensor:
    """The forward alone: K2 when the transposed-accumulator switch is on and
    d < 64, else K1."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    if TRANSPOSED_AV and q.shape[-1] < TAV_MAX_HEAD_DIM:
        return _flash_tav_cuda(q, k, v)
    return _flash_cuda(q, k, v, with_lse=False)[0]


def flash_fwd_tav(q, k, v) -> torch.Tensor:
    """K2 itself, whatever the switch says."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return _flash_tav_cuda(q, k, v)


def flash_fwd_lse(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (o, fp32 lse [B, H, Nq])."""
    if q.device.type == "cpu":
        return attention_lse_plain(q, k, v)
    return _flash_cuda(q, k, v, with_lse=True)


def flash_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """K4: dq, contiguous [B, Nq, H, D]."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    return _flash_bwd_cuda("dq", q, k, v, do, lse, delta)[0]


def flash_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: (dk, dv), contiguous [B, Nk, H, D]."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    return _flash_bwd_cuda("dkv", q, k, v, do, lse, delta)


def flash_bwd(q, k, v, o, lse, do):
    """(dq, dk, dv): delta, then K4 and K5."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do)
    delta = flash_bwd_delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    return flash_bwd_dq(q, k, v, do, lse, delta), dk, dv


def _check_inputs(q, k, v, do=None, dtypes=(torch.bfloat16,)):
    """Raise on what the kernels do not take; returns (b, nq, nk, h, d)."""
    named = [("q", q), ("k", k), ("v", v)] + ([("dout", do)] if do is not None else [])
    for name, t in named:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q {q.dtype}; this kernel "
                            f"takes one of {[str(x) for x in dtypes]} for all")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, N, H, D], got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride in D")
        if any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} strides {t.stride()} / pointer are "
                "not 16-byte aligned; the kernels load 8 elements at a time"
            )
    b, nq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d) or (
            do is not None and do.shape != q.shape):
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)}" + (f" dout {tuple(do.shape)}" if do is not None else "")
            + " do not agree"
        )
    nk = k.shape[1]
    if d % 8 or -(-d // 16) * 16 not in PADDED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8 that pads "
                         f"to one of {PADDED_HEAD_DIMS}")
    if nk == 0 or b * h > 65535:
        raise ValueError(f"flash_attention: nk={nk}, batch*heads={b * h} out of range")
    return b, nq, nk, h, d


def _check_stats(name, t, q, shape):
    if t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be a contiguous float32 {list(shape)} "
                         f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_cuda(q, k, v, with_lse: bool):
    # K3 feeds the backward, which is bf16 only; K1 also takes fp32
    dtypes = (torch.bfloat16,) if with_lse else (torch.bfloat16, torch.float32)
    b, nq, nk, h, d = _check_inputs(q, k, v, dtypes=dtypes)
    o = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    if nq == 0:
        return o, lse
    err = _build.library().mobi_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, h, nq, nk, d, int(q.dtype == torch.float32),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        (d ** -0.5) * LOG2E, _stream(q),
    )
    _build.launched(err, "flash_fwd_lse" if with_lse else "flash_fwd")
    return o, lse


def _flash_tav_cuda(q, k, v):
    b, nq, nk, h, d = _check_inputs(q, k, v, dtypes=(torch.bfloat16, torch.float32))
    if -(-d // 16) * 16 != PADDED_HEAD_DIMS[0]:
        raise ValueError(f"flash_fwd_tav: head dim {d} does not pad to {PADDED_HEAD_DIMS[0]}, "
                         "the one head dim K2 is built for (it serves d < 64)")
    o = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
    if nq == 0:
        return o
    err = _build.library().mobi_flash_fwd_tav(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, h, nq, nk, d, int(q.dtype == torch.float32),
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        (d ** -0.5) * LOG2E, _stream(q),
    )
    _build.launched(err, "flash_fwd_tav")
    return o


def _flash_bwd_cuda(which: str, q, k, v, do, lse, delta):
    b, nq, nk, h, d = _check_inputs(q, k, v, do)
    _check_stats("lse", lse, q, (b, h, nq))
    _check_stats("delta", delta, q, (b, h, nq))
    lib = _build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3]]
    if which == "dq":
        dq = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
        if nq == 0:
            return (dq,)
        table = (ctypes.c_longlong * 15)(*strides, *dq.stride()[:3])
        err = lib.mobi_flash_bwd_dq(*args, dq.data_ptr(), b, h, nq, nk, d,
                                    ctypes.addressof(table), d ** -0.5, _stream(q))
        _build.launched(err, "flash_bwd_dq")
        return (dq,)
    dk = torch.empty((b, nk, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, nk, h, d), dtype=v.dtype, device=q.device)
    table = (ctypes.c_longlong * 18)(*strides, *dk.stride()[:3], *dv.stride()[:3])
    err = lib.mobi_flash_bwd_dkv(*args, dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, d,
                                 ctypes.addressof(table), d ** -0.5, _stream(q))
    _build.launched(err, "flash_bwd_dkv")
    return dk, dv
