"""Shared building blocks in NCHW (mobi_tpu models/layers.py).

Each module computes in its `dtype` (the JAX package's flax `dtype`): inputs
and parameters are cast to it at use, so bf16 weights and fp32 norm scales and
biases live side by side as in the JAX bf16 policy. Norm statistics are fp32.

  * GroupNorm: 32 groups, eps 1e-6 in the VAE, 1e-5 in the UNet ResBlocks;
    `fuse_silu` routes silu(groupnorm(x)) through the fused kernel wrapper.
  * Downsample: stride-2 conv with asymmetric (0, 1) x (0, 1) padding.
  * Upsample: nearest x2 + 3x3 conv.

`remat` is flax's nn.remat on a block call: torch.utils.checkpoint, which
drops the block's activations and recomputes them in the backward.
`init_layers_` draws seeded weights for every Dense, Conv2d and norm of a
module, as `MobiDiffusion.init_random_` draws the UNet's.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from mobi_tpu_torch.ops.attention import dot_product_attention
from mobi_tpu_torch.ops.fused_norm import fused_groupnorm_silu, group_norm


def remat(fn: Callable[..., torch.Tensor], *args, enabled: bool) -> torch.Tensor:
    """fn(*args), its activations recomputed in the backward when `enabled`
    and autograd records (no recompute where nothing is differentiated)."""
    if enabled and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


@torch.no_grad()
def init_layers_(module: nn.Module, g: torch.Generator) -> None:
    """Every Dense and Conv2d kernel of `module` uniform(+-fan_in^-1/2) from
    `g`, in module order, biases 0; every GroupNorm and LayerNorm (1, 0)."""
    for m in module.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (Dense, Conv2d)):
            w = m.weight
            w.copy_((torch.rand(w.shape, generator=g, device=w.device) * 2 - 1) * w[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()


class GroupNorm(nn.Module):
    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-6,
                 fuse_silu: bool = False):
        super().__init__()
        self.num_groups, self.eps, self.fuse_silu = num_groups, eps, fuse_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuse_silu:
            return fused_groupnorm_silu(x, self.weight, self.bias, self.num_groups, self.eps)
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, float32 compute, eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Dense(nn.Module):
    """Linear layer; weight [out, in] as in torch. `tp` (set by
    parallel.mesh.shard_params) runs it tensor-parallel on its weight's
    piece."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            return self.tp.linear(x, self.weight, self.bias, self.dtype)
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv2d(nn.Module):
    """Conv with weight [out, in, kh, kw]; padding "same" is the JAX SAME for
    odd kernels at stride 1."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Tuple[int, int] = (3, 3), stride: int = 1,
                 padding="same", bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kh, kw = kernel_size
        self.dtype, self.stride = dtype, stride
        self.padding = (kh // 2, kw // 2) if padding == "same" else padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest_2x(x))


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, stride=2, padding=0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # pad right and bottom by one (reference model.py:73-76)
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class ResnetBlock(nn.Module):
    """VAE resnet block: GN -> swish -> conv, GN -> swish -> conv, 1x1 nin
    shortcut when the width changes."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 kernel_size: Tuple[int, int] = (3, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, kernel_size, dtype=dtype)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, kernel_size, dtype=dtype)
        self.nin_shortcut = (
            Conv2d(in_channels, out_channels, (1, 1), dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """VAE single-head spatial self-attention, always the plain formula (the
    JAX package pins backend="xla" here)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm(channels)
        self.q = Conv2d(channels, channels, (1, 1), dtype=dtype)
        self.k = Conv2d(channels, channels, (1, 1), dtype=dtype)
        self.v = Conv2d(channels, channels, (1, 1), dtype=dtype)
        self.proj_out = Conv2d(channels, channels, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wdt = x.shape
        h = self.norm(x)
        q, k, v = (m(h).flatten(2).transpose(1, 2) for m in (self.q, self.k, self.v))
        out = dot_product_attention(q, k, v, num_heads=1, backend="xla")
        out = out.transpose(1, 2).reshape(b, c, hgt, wdt).contiguous()
        return x + self.proj_out(out)
