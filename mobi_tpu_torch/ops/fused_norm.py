"""GroupNorm, and fused GroupNorm + SiLU: the plain PyTorch versions, and the
wrapper that launches the CUDA kernel `csrc/gn_silu.cu` on the card.

Replaces the TPU kernel `mobi_tpu/ops/fused_norm.py::_gn_silu_kernel`
(launched by `_gn_silu_pallas`, entry point `fused_groupnorm_silu`):
silu(groupnorm(x) * scale + bias) with fp32 group statistics, the variance
taken as E[x^2] - mean^2, in the activation dtype in and out (bf16 or fp32 on
the card).

What bounds it on the H100. It does a few operations per element, so it is
bound by bytes: one read and one write of the activation. At the main path's
widest ResBlock norm (8 x 960 x 64 x 64 bf16) that is 126 MB, about 38 us at
3.35 TB/s; twice that in fp32. Over the 45 norms of one UNet forward at the
flagship's batch 8 (14 shapes) the bound is 0.320 ms, most of it at the
64x64 level; the 8x8 and 16x16 norms are a few MB each, where a launch's
latency, not its bytes, sets the time.

What the design does about it. The TPU kernel's 0/1 group-membership matmul
and its row-tile loop existed for Mosaic's layouts and the TPU's VMEM limit;
neither carries over. In NCHW each (sample, group) is one contiguous span,
and the kernel reads it from device memory once and writes it once, holding
it on chip between the statistics and the normalisation (csrc/gn_silu.cu;
`gn_plan` below picks the variant and shape per launch). A span of more
than 32 KB goes to a thread-block cluster of up to 8 blocks: each block
loads its chunk into shared memory with TMA bulk copies, the blocks
exchange their partial sums through distributed shared memory, and each
normalises its chunk from shared memory. The first port read each span
twice and counted on L2 for the second read, which the widest norm's 63 MB
overflows. A span of up to 32 KB (the 8x8 and 16x16 levels, some 32x32
ones) is one block's, held in its registers, all its loads in flight
before the first is used. The variance is E[x^2] - mean^2 in fp32, as the
TPU kernel takes it. For a bf16 output the SiLU is h + h tanh(h), h = y /
2, on tanh.approx: one special-function op an element, whose error is
below bf16's rounding. A span that is not a multiple of 16 bytes (an odd
H * W with an odd group width; no UNet level) or larger than 8 x 224 KB
takes the first port's two-pass block, which handles any span. The CUDA
dispatch needs only C % groups == 0; the TPU shape gate (VMEM) does not
carry over, and the JAX entry point's fallback to the formula for the
shapes its gate refuses has no counterpart: on the card every shape runs
the kernel.

Gradients. A call on the card that needs one goes through `GroupNormSiLU`,
an autograd Function whose forward is the kernel and whose backward is
autograd of `groupnorm_silu_plain`, recomputed from the saved (x, weight,
bias), as the JAX package's `_bwd` does (fused_norm.py:161-167); the TPU had
no backward kernel either. A call that needs none launches the kernel alone.

On a CPU tensor the wrapper computes the plain version (which autograd
differentiates); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops._autograd import grad_of_plain

# The kernel's launch plan (csrc/gn_silu.cu, whose C entry point checks it).
# The thresholds were picked on an H100 from the main path's 14 shapes.
GN_VARIANTS = {"stream": 0, "cluster_smem": 1, "cluster_regs": 2}
GN_STREAM_THREADS = 512
GN_REGS_MAX_BYTES = 32 * 1024     # a span a block holds in registers (8 16-byte entries a thread)
GN_FEW_BLOCKS_BYTES = 128 * 1024  # spans up to here: the fewest blocks of up to 80 KB ...
GN_FEW_CHUNK_BYTES = 80 * 1024
GN_MANY_CHUNK_BYTES = 32 * 1024   # ... above: chunks of about 32 KB, for more blocks in flight
GN_MAX_CLUSTER = 8                # the portable cluster size
GN_MAX_CHUNK_BYTES = 28 * 8192    # 28 TMA pieces of 8 KB: 224 KB of a block's 227 KB


@dataclasses.dataclass(frozen=True)
class GnPlan:
    """How one launch covers the B * G spans of C / G * H * W elements: a
    cluster of `cluster` blocks of `threads` a span, block r taking elements
    [r * chunk, min((r + 1) * chunk, span)) into shared memory
    ("cluster_smem") or registers ("cluster_regs"); or ("stream") one block
    of 512 a span, read twice."""
    variant: str
    cluster: int
    chunk: int
    threads: int


def gn_plan(batch: int, channels: int, groups: int, hw: int, elem_bytes: int) -> GnPlan:
    """The kernel's variant and launch shape for x of [batch, channels, hw]
    with `elem_bytes` bytes an element (2 bf16, 4 fp32): a span of up to
    32 KB in one block's registers (256 threads up to 16 KB, else 512); a
    larger one in the shared memory of a cluster of blocks, the fewest that
    hold it in chunks of up to 80 KB where it is at most 128 KB, else chunks
    of about 32 KB (256 threads a block up to 32 KB, else 512); a span that
    is not a multiple of 16 bytes, or past 8 blocks of 224 KB, streamed."""
    span = channels // groups * hw
    nbytes, vec = span * elem_bytes, 16 // elem_bytes
    if nbytes % 16:
        return GnPlan("stream", 1, span, GN_STREAM_THREADS)
    if nbytes <= GN_REGS_MAX_BYTES:
        return GnPlan("cluster_regs", 1, span, 256 if nbytes <= GN_REGS_MAX_BYTES // 2 else 512)
    target = GN_FEW_CHUNK_BYTES if nbytes <= GN_FEW_BLOCKS_BYTES else GN_MANY_CHUNK_BYTES
    chunk = math.ceil(span / min(GN_MAX_CLUSTER, math.ceil(nbytes / target)) / vec) * vec
    if chunk * elem_bytes > GN_MAX_CHUNK_BYTES:
        return GnPlan("stream", 1, span, GN_STREAM_THREADS)
    return GnPlan("cluster_smem", math.ceil(span / chunk), chunk,
                  256 if chunk * elem_bytes <= GN_MANY_CHUNK_BYTES else 512)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm over the channel axis (dim 1) with fp32 statistics
    (two-pass variance), returned in x's dtype (mobi_tpu layers.GroupNorm).
    Groups are clamped to the channel count for tiny test widths."""
    orig = x.dtype
    b, c = x.shape[:2]
    g = min(num_groups, c)
    if c % g:
        raise ValueError(f"channels {c} not divisible by groups {g}")
    xg = x.float().reshape(b, g, -1)
    mean = xg.mean(dim=-1, keepdim=True)
    var = xg.var(dim=-1, unbiased=False, keepdim=True)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    affine = (1, c) + (1,) * (x.dim() - 2)
    y = xg.reshape(x.shape) * weight.float().reshape(affine) + bias.float().reshape(affine)
    return y.to(orig)


def groupnorm_silu_plain(x, weight, bias, num_groups: int = 32, eps: float = 1e-5):
    """silu(group_norm(x)), the SiLU taken in fp32 before the cast back
    (mobi_tpu fused_norm.py::_gn_silu_reference)."""
    orig = x.dtype
    y = group_norm(x.float(), weight, bias, num_groups, eps)
    return F.silu(y).to(orig)


def fused_groupnorm_silu(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, num_groups: int = 32,
                         eps: float = 1e-5) -> torch.Tensor:
    """x: [B, C, H, W]; weight, bias: [C] -> silu(GN(x)). On the card x is
    bf16 or fp32, of any H and W; the plain version on the CPU takes any
    float dtype."""
    if x.device.type == "cpu":
        return groupnorm_silu_plain(x, weight, bias, num_groups, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return GroupNormSiLU.apply(x, weight, bias, num_groups, eps)
    return _gn_silu_cuda(x, weight, bias, num_groups, eps)


class GroupNormSiLU(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.num_groups, ctx.eps = num_groups, eps
        return _gn_silu_cuda(x, weight, bias, num_groups, eps)

    @staticmethod
    def backward(ctx, dy):
        grads = grad_of_plain(groupnorm_silu_plain, ctx.saved_tensors, ctx.needs_input_grad, dy,
                              ctx.num_groups, ctx.eps)
        return (*grads, None, None)


def _gn_silu_cuda(x, weight, bias, num_groups, eps, plan: GnPlan | None = None):
    """The kernel, with `gn_plan`'s launch plan unless one is given."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_groupnorm_silu: x is on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_groupnorm_silu: x is {x.dtype}; the kernel takes bfloat16 or float32")
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_groupnorm_silu: x must be a contiguous, 16-byte aligned [B, C, H, W] tensor")
    b, c, h, w = x.shape
    g = min(num_groups, c)
    if c % g:
        raise ValueError(f"fused_groupnorm_silu: channels {c} not divisible by groups {g}")
    if (c // g) * h * w >= 2 ** 31:
        raise ValueError(f"fused_groupnorm_silu: a group of {(c // g) * h * w} elements; the kernel "
                         "indexes a group's span with 32-bit integers")
    for name, t in (("weight", weight), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous():
            raise ValueError(f"fused_groupnorm_silu: {name} must be a contiguous float32 [{c}] on {x.device}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    plan = plan or gn_plan(b, c, g, h * w, x.element_size())
    lib = _build.library()
    err = lib.mobi_gn_silu(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        b, c, g, h * w, int(x.dtype == torch.float32), float(eps),
        GN_VARIANTS[plan.variant], plan.cluster, plan.chunk, plan.threads,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.launched(err, "gn_silu")
    return y
