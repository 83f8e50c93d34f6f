"""RangeNet++ (darknet53) feature extractor for FRD, the Frechet Range
Distance (mobi_tpu eval/rangenet.py), NCHW with the published
lidar-bonnetal darknet53 module names.

  * input: 5 channels [depth_m, intensity, x, y, z] at 64 x 1024 (nearest
    resize), depth denormalised as (d + 1) / 2 * 54, pixels outside
    (1.4, 54) m set to -1 in every channel (`range_npy_to_input`);
  * `backbone`: darknet53 with width-only downsampling (each stage's conv
    at stride [1, 2], OS 32 across the width), the skip tapped before each
    width reduction;
  * `decoder`: five ConvTranspose2d([1, 4], stride [1, 2], padding [0, 1])
    stages, each + BN + LeakyReLU, then the skip added, then a Basic
    residual block (the JAX module's order); a 32-channel map;
  * the FRD feature: "depth" aggregation, torch's view(B, C, 16, H // 16,
    W).mean((3, 4)) -> [B, 32 * 16 = 512].

`load_published` takes the checkpoint's `backbone` and
`segmentation_decoder` state dicts, strict on each.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

DARKNET53_BLOCKS = (1, 2, 8, 8, 4)
STAGE_CH = ((32, 64), (64, 128), (128, 256), (256, 512), (512, 1024))
DEC_CH = ((1024, 512), (512, 256), (256, 128), (128, 64), (64, 32))
FEATURE_DIM = 512
INPUT_HW = (64, 1024)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class BasicBlock(nn.Module):
    """1 x 1 squeeze to planes[0], 3 x 3 back to planes[1], + the input."""

    def __init__(self, planes: Tuple[int, int]):
        super().__init__()
        mid, out = planes
        self.conv1 = nn.Conv2d(out, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, out, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _leaky(self.bn1(self.conv1(x)))
        return x + _leaky(self.bn2(self.conv2(h)))


class Darknet53(nn.Module):
    """The published `backbone`: conv1/bn1, then enc1..enc5, each a [1, 2]
    strided conv + bn and its residual blocks. Returns the last map and the
    skips by output stride."""

    def __init__(self, in_channels: int = 5):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 32, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        for si, ((cin, cout), blocks) in enumerate(zip(STAGE_CH, DARKNET53_BLOCKS)):
            enc = nn.Module()
            enc.conv = nn.Conv2d(cin, cout, 3, stride=(1, 2), padding=1, bias=False)
            enc.bn = nn.BatchNorm2d(cout)
            for bi in range(blocks):
                setattr(enc, f"residual_{bi}", BasicBlock((cin, cout)))
            setattr(self, f"enc{si + 1}", enc)

    def forward(self, x: torch.Tensor):
        skips: Dict[int, torch.Tensor] = {}
        os = 1
        h = _leaky(self.bn1(self.conv1(x)))
        for si, blocks in enumerate(DARKNET53_BLOCKS):
            enc = getattr(self, f"enc{si + 1}")
            skips[os] = h  # tapped before each width reduction
            os *= 2
            h = _leaky(enc.bn(enc.conv(h)))
            for bi in range(blocks):
                h = getattr(enc, f"residual_{bi}")(h)
        return h, skips, os


class DarknetDecoder(nn.Module):
    """The published `segmentation_decoder`: dec5..dec1, each an up-conv +
    bn and a residual block."""

    def __init__(self):
        super().__init__()
        for di, (cin, cout) in enumerate(DEC_CH):
            dec = nn.Module()
            dec.upconv = nn.ConvTranspose2d(cin, cout, (1, 4), stride=(1, 2), padding=(0, 1))
            dec.bn = nn.BatchNorm2d(cout)
            dec.residual = BasicBlock((cin, cout))
            setattr(self, f"dec{5 - di}", dec)

    def forward(self, h: torch.Tensor, skips: Dict[int, torch.Tensor], os: int) -> torch.Tensor:
        for di in range(len(DEC_CH)):
            dec = getattr(self, f"dec{5 - di}")
            h = _leaky(dec.bn(dec.upconv(h)))
            os //= 2
            h = dec.residual(h + skips[os])
        return h


class RangeNetFRD(nn.Module):
    """[B, 5, 64, 1024] -> [B, 512] FRD features."""

    def __init__(self, n_groups: int = 16):
        super().__init__()
        self.n_groups = n_groups
        self.backbone = Darknet53()
        self.decoder = DarknetDecoder()
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.decoder(*self.backbone(x))
        b, c, H, W = h.shape
        return h.view(b, c, self.n_groups, H // self.n_groups, W).mean((3, 4)).reshape(b, -1)


def _nearest_resize_torch(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """torch F.interpolate(mode='nearest') indexing: src = floor(dst * in / out)."""
    h, w = x.shape[:2]
    ri = np.floor(np.arange(out_h) * h / out_h).astype(np.int64)
    ci = np.floor(np.arange(out_w) * w / out_w).astype(np.int64)
    return x[ri][:, ci]


def range_npy_to_input(npy: np.ndarray, out_h: int = INPUT_HW[0], out_w: int = INPUT_HW[1],
                       depth_interval: Tuple[float, float] = (1.4, 54.0)) -> np.ndarray:
    """A saved (depth_norm, intensity, pitch, yaw) stack -> [H, W, 5]
    float32: depth = (d + 1) / 2 * 54; pixels outside (1.4, 54) m get -1 in
    every channel; xyz from the spherical angles."""
    depth_n, inten, pitch, yaw = npy[0], npy[1], npy[2], npy[3]
    depth_m = (depth_n + 1.0) / 2.0 * depth_interval[1]
    valid = (depth_m > depth_interval[0]) & (depth_m < depth_interval[1])
    x = np.cos(yaw) * np.cos(pitch) * depth_m
    y = -np.sin(yaw) * np.cos(pitch) * depth_m
    z = np.sin(pitch) * depth_m
    stack = np.stack([depth_m, inten, x, y, z], axis=-1).astype(np.float32)
    stack[~valid] = -1.0
    if stack.shape[:2] != (out_h, out_w):
        stack = _nearest_resize_torch(stack, out_h, out_w)
    return stack


def load_published(model: RangeNetFRD, backbone_sd: Dict[str, torch.Tensor],
                   decoder_sd: Dict[str, torch.Tensor]) -> None:
    """The published darknet53 `backbone` and `segmentation_decoder` state
    dicts into `model`, strict=True on each."""
    model.backbone.load_state_dict({k: torch.as_tensor(v) for k, v in backbone_sd.items()}, strict=True)
    model.decoder.load_state_dict({k: torch.as_tensor(v) for k, v in decoder_sd.items()}, strict=True)
