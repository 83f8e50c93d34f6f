"""The KL-VAE and its lidar-range variant (LDM's AutoencoderKL), NCHW, as
plain float32 functions over the published names under `<stage>.`
(`first_stage_model.` for the camera, `lidar_stage_model.` for lidar).

With the lidar adapter the encoder opens with a (1, 5) conv and two (1, 5)
ResnetBlocks, and the decoder closes with two (1, 5) ResnetBlocks, each
followed by GroupNorm and swish, and a (1, 5) conv.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from port_bench.reference.nn import Params, attention, conv, group_norm, silu, upsample_nearest_2x


def _resnet(P: Params, name: str, x):
    h = conv(P, name + ".conv1", silu(group_norm(P, name + ".norm1", x, 1e-6)))
    h = conv(P, name + ".conv2", silu(group_norm(P, name + ".norm2", h, 1e-6)))
    if name + ".nin_shortcut.weight" in P:
        x = conv(P, name + ".nin_shortcut", x)
    return x + h


def _attn_block(P: Params, name: str, x):
    b, c, hgt, wdt = x.shape
    h = group_norm(P, name + ".norm", x, 1e-6)
    q, k, v = (conv(P, f"{name}.{m}", h).flatten(2).transpose(1, 2) for m in ("q", "k", "v"))
    out = attention(q, k, v, heads=1).transpose(1, 2).reshape(b, c, hgt, wdt)
    return x + conv(P, name + ".proj_out", out)


def _mid(P: Params, name: str, x):
    x = _resnet(P, name + ".block_1", x)
    x = _attn_block(P, name + ".attn_1", x)
    return _resnet(P, name + ".block_2", x)


def _levels(P: Params, name: str) -> int:
    n = 0
    while f"{name}.{n}.block.0.conv1.weight" in P:
        n += 1
    return n


def _blocks(P: Params, name: str) -> int:
    n = 0
    while f"{name}.block.{n}.conv1.weight" in P:
        n += 1
    return n


def encode(P: Params, stage: str, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, C, H, W] -> the posterior's (mean, logvar), logvar clamped to
    [-30, 20]."""
    e = stage + ".encoder"
    if e + ".conv_in_lidar.weight" in P:
        h = conv(P, e + ".conv_in_lidar", x)
        h = _resnet(P, e + ".res_block_lidar1", h)
        h = _resnet(P, e + ".res_block_lidar2", h)
    else:
        h = conv(P, e + ".conv_in", x)
    for i in range(_levels(P, e + ".down")):
        lvl = f"{e}.down.{i}"
        for j in range(_blocks(P, lvl)):
            h = _resnet(P, f"{lvl}.block.{j}", h)
        if lvl + ".downsample.conv.weight" in P:
            h = conv(P, lvl + ".downsample.conv", F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = _mid(P, e + ".mid", h)
    h = conv(P, e + ".conv_out", silu(group_norm(P, e + ".norm_out", h, 1e-6)))
    moments = conv(P, stage + ".quant_conv", h)
    mean, logvar = moments.chunk(2, dim=1)
    return mean, logvar.clamp(-30.0, 20.0)


def decode(P: Params, stage: str, z: torch.Tensor) -> torch.Tensor:
    d = stage + ".decoder"
    h = conv(P, d + ".conv_in", conv(P, stage + ".post_quant_conv", z))
    h = _mid(P, d + ".mid", h)
    for i in reversed(range(_levels(P, d + ".up"))):
        lvl = f"{d}.up.{i}"
        for j in range(_blocks(P, lvl)):
            h = _resnet(P, f"{lvl}.block.{j}", h)
        if lvl + ".upsample.conv.weight" in P:
            h = conv(P, lvl + ".upsample.conv", upsample_nearest_2x(h))
    if d + ".conv_out_lidar.weight" in P:
        h = silu(group_norm(P, d + ".norm_out_lidar1", _resnet(P, d + ".res_block_lidar1", h), 1e-6))
        h = silu(group_norm(P, d + ".norm_out_lidar2", _resnet(P, d + ".res_block_lidar2", h), 1e-6))
        return conv(P, d + ".conv_out_lidar", h)
    return conv(P, d + ".conv_out", silu(group_norm(P, d + ".norm_out", h, 1e-6)))
