"""Flash attention, forward and backward: the plain PyTorch versions, the
wrappers that launch the CUDA kernels on the card, and the autograd wiring.

Replaces the five TPU kernels of `mobi_tpu/ops/flash_attention.py`:

  K1 `_flash_kernel` (launched by `_flash_fwd_impl`): non-causal
     softmax(Q K^T d^-1/2) V with the dots in the input dtype and fp32
     accumulation, the online max and sum in fp32, P cast to V's dtype
     before P V, the output in the input dtype. CUDA: bf16 in
     `csrc/flash_fwd_sm90.cu` (wgmma, TMA, warp specialisation), fp32 in
     `csrc/flash_fwd.cu` (mma.sync). Plain version: `attention_plain`.
  K2 `_flash_kernel_tav` (picked by `_flash_fwd_impl` when
     `MOBI_FLASH_TRANSPOSED_AV=1` and d < 64): K1's function with the
     output accumulator held as O^T [D, TQ] and P V taken as V^T P^T.
     CUDA: bf16 in `csrc/flash_fwd_sm90.cu` (the K1 design with its own
     second product), fp32 in `csrc/flash_fwd_tav.cu`; built for the padded
     head dims 48 and 64. Its plain version is K1's, `attention_plain`. On
     the H100, in bf16 its output equals K1's bit for bit (the same
     products, summed in the same order with the operands swapped); in fp32
     the two differ at rounding level (the 3xTF32 cross terms are summed in
     another order).
     It takes about 1.1x K1's time (PERF.md), and the switch stays off by
     default, as in the JAX package.
  K3 `_flash_kernel_lse` (`_flash_fwd_lse_impl`): K1 plus the per-row fp32
     logsumexp lse = m + log l that the backward needs. CUDA: K1's kernels
     with an lse output, bf16 in `csrc/flash_fwd_sm90.cu` (a non-null lse
     pointer: the quad that holds a row's running sum writes it in the
     epilogue), fp32 in `csrc/flash_fwd.cu`.
  K4 `_flash_bwd_dq_kernel` and K5 `_flash_bwd_dkv_kernel` (`_flash_bwd_impl`):
     with P = exp(Q K^T d^-1/2 - lse) recomputed, delta = rowsum(dO * O) and
     dS = P * (dO V^T - delta) * d^-1/2 cast to the input dtype,
     dQ = dS K (K4) and dK = dS^T Q, dV = P^T dO with P cast to dO's dtype
     (K5). CUDA: bf16 in `csrc/flash_bwd_sm90.cu` (wgmma, TMA, warp
     specialisation), fp32 in `csrc/flash_bwd.cu` (mma.sync). delta is one
     PyTorch reduction outside the kernels, as in the JAX package.

`flash_attention` is the entry point. A call that needs no gradient (grad
disabled, or none of q, k, v requires grad) runs `flash_fwd` alone: K1, or
K2 when the transposed-accumulator switch is on and d < 64. A call that does
goes through `FlashAttention`, an autograd Function: K3 forward, K4 and K5
backward. `MOBI_FLASH_BWD=xla` (the JAX package's switch, default "pallas")
makes the forward `flash_fwd` and the backward autograd through
`attention_plain`. On a CPU tensor every wrapper computes its plain version;
on a CUDA tensor it launches its kernel or raises. Every kernel takes bf16
and fp32, so the default fp32 `MobiConfig()` trains on the card as the
shipped bf16 configs do.

What bounds the kernels on the H100. Per (batch, head) at N queries and keys
of head dim d, K1 and K3 do 4 N^2 d tensor-core flops and N^2 exponentials,
K4 6 N^2 d flops (S, dP and dQ) and N^2 exponentials, K5 8 N^2 d flops (S,
dP, dV and dK) and N^2 exponentials, each moving O(N d) bytes. At the UNet's
shapes (N = 4096, d = 40 at the 64x64 level; N = 1024, d = 80 at 32x32) the
bytes are far below both other bounds, and at d = 40 the N^2 exponentials
on the special-function units (about 3.9 T/s) take longer than the products
on the tensor cores (989 TFLOP/s bf16) in K1, K3 and K4, while in K5 the
products come close: all are bound by operations. The exponential unit
(16 lanes an SM, 4 a scheduler) is the scarce resource, so a forward is as
fast as it keeps that unit busy: every stall of a warp that holds
exponentials to compute shows in the time.

What the designs do about it. The N x N matrices never leave the chip, and
the softmax runs in base 2 with log2(e) folded into the scale (and into lse
in the backward): one `ex2.approx` per logit. The head dim is zero-padded
for the contraction to the smallest width the kernels are built for, 48,
64, 80, 128, 160, 192 or 256 (40 -> 48 adds 20% to the product work, none to
the exponentials; K2 is built for 48 and 64). A head dim that is not a
multiple of 8 cannot be a TMA or 16-byte row: the wrapper copies q, k, v
(and dO) into zero-padded tensors, runs the kernel with the scale of the
true head dim, and slices the outputs back. Above 128 (the UNet's d = 160
at the 16x16 and 8x8 levels under `attn_backend: flash`) the head dim of
the outputs is split into slices of 80 (d <= 160) or 64 columns, a grid
axis: a block computes the logits (and dP) over the full width and
accumulates only its slice of O (dQ; dK and dV), so its accumulators take
the registers of the 80 or 64 build. The wgmma designs hold the
accumulators in registers, and at 128 they already pass the 168 registers a
thread that ptxas gives them (they spill); a slice of 80 does not. Each
slice recomputes the logits and the exponentials: at d = 160 the
exponentials double and the products grow by half. Above 256 the kernels
raise (the rule is csrc/flash_common.cuh's `head_dims`).

bf16 K1, K2 and K3 (`flash_fwd_sm90.cu`) are warp-specialised: a block of 128
query rows has a producer warpgroup, one thread of which issues TMA loads of
Q and of 128-key K and V tiles into a three-stage ring (mbarriers), and two
consumer warpgroups of 64 rows each with 240 registers (setmaxnreg). A
consumer issues S(j) = Q K_j^T (wgmma m64n128k16 from shared memory) with
P(j-1) V(j-1) (wgmma with P from registers, V read MN-major from shared
memory) and runs the softmax of tile j while the second product is on the
tensor cores; the two consumers take turns to issue (named barriers), so
one's exponentials overlap the other's products. K2 runs its second product
as O^T += V^T P^T (wgmma m64n64k16, the head dim padded to M = 64), which
reads P^T from shared memory: each consumer writes its bf16 P tile there
with stmatrix, and the per-query rescale and 1 / l, which scale O^T's
columns, pass through shared memory too. The 32-byte-swizzled TMA boxes of
16 head-dim columns let d = 40 pad to 48 with TMA's zero fill, and rows
past N are zero-filled the same way.

bf16 K4 and K5 (`flash_bwd_sm90.cu`) take the same design. K4's block owns
128 query rows, loads Q and dO once and streams K and V in 128-key tiles,
which each consumer takes in two 64-key steps: S = Q K^T and dP = dO V^T
(wgmma m64n64k16), dS in registers, then dQ += dS K with dS from registers
and K read MN-major. K5's block owns 128 keys, loads K and V once and
streams Q and dO in 64-row tiles, taken in two 32-query steps: S^T = K Q^T
and dP^T = V dO^T (m64n32k16), then dV += P^T dO and dK += dS^T Q. lse and
delta run along K5's accumulator columns, so a producer warp stages each
tile's values in shared memory beside the TMA loads. Each step's first
products are issued with the previous step's last ones, and the steps are
small enough that all of it stays in the registers (larger ones made ptxas
spill and serialise the wgmmas); the consumers take turns to issue.

The mma.sync kernels (fp32 K1, K2, K3, K4 and K5) keep 128 query rows per
block of 8 warps (forward), or 64 query rows (K4) or 64 keys (K5) per block
of 4 warps, and stream the other side through shared memory in 64-row tiles
double-buffered with `cp.async`. Their products run as 3xTF32 on m16n8k8:
each operand split into two tf32 halves, three products, which keeps them
accurate to fp32 (plain TF32 would keep 11 bits), at three times the tf32
work. The backward is two kernels with no reduction across blocks, so its
gradients are the same from run to run.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops._autograd import grad_of_plain

LOG2E = 1.4426950408889634
# The largest head dim the kernels take (csrc/flash_common.cuh `head_dims`
# picks the instantiation and its slices of the head dim: the UNet's d = 40
# runs in the 48 build, d = 80 in 80, d = 160 in two slices of 80).
MAX_HEAD_DIM = 256

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


_DTYPES = (torch.bfloat16, torch.float32)


def _pad_head_dim(*ts):
    """Zero-padded copies of [B, N, H, D] tensors whose head dim is not a
    multiple of 8, padded to the next one (the kernels read 16-byte rows):
    the padding adds zeros to every dot product and zero output columns,
    which the caller slices off. Others are returned as they are. Raises,
    before any copy, for a head dim the kernels do not take."""
    d = ts[0].shape[-1]
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d}: the kernels take head dims up to "
                         f"{MAX_HEAD_DIM} (a block holds Q or K and V at the full head dim in "
                         "shared memory); the JAX kernel takes it")
    if d % 8 == 0:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, -d % 8)) for t in ts)


def _unpad(t, d):
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check_inputs(q, k, v, do=None):
    """Raise on what the kernels do not take; returns (b, nq, nk, h, d)."""
    named = [("q", q), ("k", k), ("v", v)] + ([("dout", do)] if do is not None else [])
    for name, t in named:
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on {q.device}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q {q.dtype}; the kernels "
                            f"take one of {[str(x) for x in _DTYPES]} for all")
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


def _fwd_args(q, k, v, o, d):
    """The strides of q, k, v, o and scale_log2, as every forward takes them."""
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
            (d ** -0.5) * LOG2E, _stream(q))


def _flash_cuda(q, k, v, with_lse: bool):
    """K1, or K3 with `with_lse` (bf16: the wgmma kernel, K3 through its lse
    pointer; fp32: mma.sync)."""
    d = q.shape[-1]
    q, k, v = _pad_head_dim(q, k, v)
    b, nq, nk, h, d8 = _check_inputs(q, k, v)
    o = torch.empty((b, nq, h, d8), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    if nq == 0:
        return _unpad(o, d), lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None if lse is None else lse.data_ptr())
    if q.dtype == torch.bfloat16:
        err = _build.library().mobi_flash_fwd_sm90(*ptrs, b, h, nq, nk, d8, 0, *_fwd_args(q, k, v, o, d))
    else:
        err = _build.library().mobi_flash_fwd(*ptrs, b, h, nq, nk, d8, *_fwd_args(q, k, v, o, d))
    _build.launched(err, "flash_fwd_lse" if with_lse else "flash_fwd")
    return _unpad(o, d), lse


def _flash_tav_cuda(q, k, v):
    """K2 (bf16: the wgmma kernel; fp32: mma.sync), for d < 64."""
    d = q.shape[-1]
    if d >= TAV_MAX_HEAD_DIM:
        raise ValueError(f"flash_fwd_tav: head dim {d}; K2 serves head dims below {TAV_MAX_HEAD_DIM}, "
                         "as in the JAX package")
    q, k, v = _pad_head_dim(q, k, v)
    b, nq, nk, h, d8 = _check_inputs(q, k, v)
    o = torch.empty((b, nq, h, d8), dtype=q.dtype, device=q.device)
    if nq == 0:
        return _unpad(o, d)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if q.dtype == torch.bfloat16:
        err = _build.library().mobi_flash_fwd_sm90(*ptrs, None, b, h, nq, nk, d8, 1, *_fwd_args(q, k, v, o, d))
    else:
        err = _build.library().mobi_flash_fwd_tav(*ptrs, b, h, nq, nk, d8, *_fwd_args(q, k, v, o, d))
    _build.launched(err, "flash_fwd_tav")
    return _unpad(o, d)


def _flash_bwd_cuda(which: str, q, k, v, do, lse, delta):
    """K4 or K5: bf16 on the wgmma kernels, fp32 on the mma.sync ones."""
    d = q.shape[-1]
    q, k, v, do = _pad_head_dim(q, k, v, do)
    b, nq, nk, h, d8 = _check_inputs(q, k, v, do)
    _check_stats("lse", lse, q, (b, h, nq))
    _check_stats("delta", delta, q, (b, h, nq))
    lib = _build.library()
    sm90 = q.dtype == torch.bfloat16
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3]]
    if which == "dq":
        dq = torch.empty((b, nq, h, d8), dtype=q.dtype, device=q.device)
        if nq == 0:
            return (_unpad(dq, d),)
        table = (ctypes.c_longlong * 15)(*strides, *dq.stride()[:3])
        fn = lib.mobi_flash_bwd_dq_sm90 if sm90 else lib.mobi_flash_bwd_dq
        err = fn(*args, dq.data_ptr(), b, h, nq, nk, d8, ctypes.addressof(table), d ** -0.5, _stream(q))
        _build.launched(err, "flash_bwd_dq")
        return (_unpad(dq, d),)
    if nq == 0:  # no query: no gradient reaches k or v
        return (torch.zeros((b, nk, h, d), dtype=k.dtype, device=q.device),
                torch.zeros((b, nk, h, d), dtype=v.dtype, device=q.device))
    dk = torch.empty((b, nk, h, d8), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, nk, h, d8), dtype=v.dtype, device=q.device)
    table = (ctypes.c_longlong * 18)(*strides, *dk.stride()[:3], *dv.stride()[:3])
    fn = lib.mobi_flash_bwd_dkv_sm90 if sm90 else lib.mobi_flash_bwd_dkv
    err = fn(*args, dk.data_ptr(), dv.data_ptr(), b, h, nq, nk, d8, ctypes.addressof(table), d ** -0.5,
             _stream(q))
    _build.launched(err, "flash_bwd_dkv")
    return _unpad(dk, d), _unpad(dv, d)
