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
3.35 TB/s; twice that in fp32.

What the design does about it. The TPU kernel's 0/1 group-membership matmul
and its row-tile loop existed for Mosaic's layouts and the TPU's VMEM limit;
neither carries over. In NCHW each (sample, group) is one contiguous span, so
one block owns one span: it reads it with 16-byte loads for the statistics,
then reads it again and writes silu(x * sc + off). The second read comes from
L2, which the first has just filled (a span of up to 240 KB does not fit a
block's shared memory), so device memory sees the activation read about once
and written once. Where H * W is not a multiple of 8 (no UNet level; a
latent size another config might have), a span's aligned body still takes
16-byte loads and its head and tail scalar loads. The CUDA dispatch needs
only C % groups == 0; the TPU shape gate (VMEM) does not carry over, and the
JAX entry point's fallback to the formula for the shapes its gate refuses
has no counterpart: on the card every shape runs the kernel.

Gradients. A call on the card that needs one goes through `GroupNormSiLU`,
an autograd Function whose forward is the kernel and whose backward is
autograd of `groupnorm_silu_plain`, recomputed from the saved (x, weight,
bias), as the JAX package's `_bwd` does (fused_norm.py:161-167); the TPU had
no backward kernel either. A call that needs none launches the kernel alone.

On a CPU tensor the wrapper computes the plain version (which autograd
differentiates); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mobi_tpu_torch.ops import _build
from mobi_tpu_torch.ops._autograd import grad_of_plain


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


def _gn_silu_cuda(x, weight, bias, num_groups, eps):
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
    lib = _build.library()
    err = lib.mobi_gn_silu(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        b, c, g, h * w, int(x.dtype == torch.float32), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.launched(err, "gn_silu")
    return y
