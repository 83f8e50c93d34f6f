"""Swin Transformer (tiny) camera backbone and the GeneralizedLSSFPN neck
(mobi_tpu models/swin.py; the reference's mmdet SwinTransformer, swin-T:
embed 96, depths [2, 2, 6, 2], heads [3, 6, 12, 24], window 7,
out_indices (1, 2, 3) -> channels (192, 384, 768); and
mmdet3d/models/necks/generalized_lss.py:13-110).

Module and parameter names are mmdet's, so the `encoders.camera.backbone.*`
and `encoders.camera.neck.*` entries of a reference `bevfusion-det.pth`
load strict:

  * each window attention keeps the checkpoint's `relative_position_index`
    buffer and indexes its bias table through it;
  * PatchMerging flattens each 2x2 neighbourhood as `nn.Unfold` does,
    channel-major (c * 4 + kh * 2 + kw), so `downsample.reduction` and
    `downsample.norm` take the reference's weights as they are.

The transformer runs channel-last ([B, H, W, C]); the FPN takes and gives
NCHW. Dropout and drop-path are inference identities and left out.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mobi_tpu_torch.models.bevfusion import StatsBatchNorm


def rel_pos_index(w: int) -> np.ndarray:
    """[w*w, w*w] lookup into the (2w-1)^2 relative bias table (the
    displacement indexing the JAX package exports beside its table)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, w*w, C] (H, W multiples of w)."""
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(windows: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    b = windows.shape[0] // ((h // w) * (wd // w))
    x = windows.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def _shift_mask(hp: int, wp: int, w: int, shift: int) -> np.ndarray:
    """Additive mask [nW, w*w, w*w] for shifted windows: 0 within one
    region, -100 across regions."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    slices = (slice(0, -w), slice(-w, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // w, w, wp // w, w).transpose(0, 2, 1, 3).reshape(-1, w * w)
    return (win[:, :, None] != win[:, None, :]).astype(np.float32) * -100.0


class WindowAttention(nn.Module):
    """Window attention with a relative-position bias (mmdet's WindowMSA)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", torch.from_numpy(rel_pos_index(window)))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        bw, n, dim = x.shape
        dh = dim // self.heads
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(bw, n, self.heads, dh).transpose(1, 2) for t in (q, k, v))
        logits = (q * dh**-0.5) @ k.transpose(-2, -1)
        idx = self.relative_position_index.reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(n, n, self.heads).permute(2, 0, 1)
        logits = logits + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            logits = (logits.reshape(-1, nw, self.heads, n, n) + mask[None, :, None]).reshape(-1, self.heads, n, n)
        out = logits.softmax(dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(bw, n, dim))


class ShiftWindowMSA(nn.Module):
    """Pad to whole windows, roll by `shift`, window attention, roll back
    (mmdet ShiftWindowMSA)."""

    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.w_msa = WindowAttention(dim, heads, window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, wd, c = x.shape
        w, s = self.window, self.shift
        pad_h, pad_w = (w - h % w) % w, (w - wd % w) % w
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, wd + pad_w
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = torch.from_numpy(_shift_mask(hp, wp, w, s)).to(x.device, x.dtype)
        x = _window_reverse(self.w_msa(_window_partition(x, w), mask), w, hp, wp)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        return x[:, :h, :wd]


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int = 7, shift: int = 0, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ShiftWindowMSA(dim, heads, window, shift)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = nn.Module()
        self.ffn.layers = nn.Sequential(
            nn.Sequential(nn.Linear(dim, dim * mlp_ratio), nn.GELU()), nn.Linear(dim * mlp_ratio, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn.layers(self.norm2(x))


class PatchMerging(nn.Module):
    """2x2 neighbourhood -> LayerNorm -> Linear(4C, 2C), the neighbourhood
    flattened channel-major as nn.Unfold does (mmdet PatchMerging)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        h2, w2 = x.shape[1] // 2, x.shape[2] // 2
        x = x.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 5, 2, 4)  # [b, h2, w2, c, kh, kw]
        return self.reduction(self.norm(x.reshape(b, h2, w2, 4 * c)))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, shift=0 if i % 2 == 0 else window // 2) for i in range(depth))
        if downsample:
            self.downsample = PatchMerging(dim, 2 * dim)


class SwinTransformer(nn.Module):
    """Swin-T multi-scale camera backbone: [B, 3, H, W] -> the maps at
    out_indices, NCHW, strides 8 / 16 / 32 with channels 192 / 384 / 768."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 out_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = nn.Module()
        self.patch_embed.projection = nn.Conv2d(3, embed_dim, 4, stride=4)
        self.patch_embed.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.stages = nn.ModuleList(
            SwinStage(embed_dim * 2**i, d, h, window, downsample=i < len(depths) - 1)
            for i, (d, h) in enumerate(zip(depths, heads)))
        for i in self.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dim * 2**i, eps=1e-5))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.patch_embed.norm(self.patch_embed.projection(x).permute(0, 2, 3, 1))
        outs = []
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                x = blk(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2).contiguous())
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
        return tuple(outs)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with align_corners=True (the reference FPN's
    upsample_cfg, generalized_lss.py:24,91-96)."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=True)


class ConvModule(nn.Module):
    """conv (no bias) -> BatchNorm (by its stored statistics, `StatsBatchNorm`)
    -> ReLU, mmcv ConvModule's names."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, eps: float = 1e-5):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.bn = StatsBatchNorm(cout, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class GeneralizedLSSFPN(nn.Module):
    """Top-down FPN with concat fusion: per level from the coarsest, upsample
    the coarser map to this level, concat, 1x1 ConvModule, 3x3 ConvModule.
    Returns len(inputs) - 1 maps (NCHW)."""

    def __init__(self, in_channels: Sequence[int] = (192, 384, 768), out_channels: int = 256):
        super().__init__()
        n = len(in_channels) - 1
        cins = [in_channels[i] + (in_channels[i + 1] if i == n - 1 else out_channels) for i in range(n)]
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in cins)
        self.fpn_convs = nn.ModuleList(ConvModule(out_channels, out_channels, 3) for _ in cins)

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals: List[torch.Tensor] = list(inputs)
        n = len(laterals) - 1
        for i in range(n - 1, -1, -1):
            up = resize_bilinear_align_corners(laterals[i + 1], laterals[i].shape[-2:])
            h = self.lateral_convs[i](torch.cat([laterals[i], up], dim=1))
            laterals[i] = self.fpn_convs[i](h)
        return tuple(laterals[:n])
