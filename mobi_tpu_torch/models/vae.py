"""KL-VAE (camera RGB) and its lidar-range variant in NCHW (mobi_tpu
models/vae.py). Module names follow the reference state dict
(`encoder.down.0.block.1.conv1`, `decoder.up.3.upsample.conv`, ...).

lidar_adapter: the encoder's conv_in becomes a (1, 5) conv plus two (1, 5)
ResnetBlocks; the decoder's tail is two (1, 5) ResnetBlocks, each followed by
GroupNorm + swish (the reference's extra norm after res_block_lidar1 kept),
and a (1, 5) conv_out.

use_checkpoint: every ResnetBlock and AttnBlock is recomputed in the backward
(flax nn.remat per block in the JAX package), wherever autograd records.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobi_tpu_torch.models.layers import (
    AttnBlock,
    Conv2d,
    Downsample,
    GroupNorm,
    ResnetBlock,
    Upsample,
    init_layers_,
    remat,
)
from mobi_tpu_torch.ops.distributions import DiagonalGaussian


class _Mid(nn.Module):
    def __init__(self, ch: int, dtype: torch.dtype, use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.block_1 = ResnetBlock(ch, dtype=dtype)
        self.attn_1 = AttnBlock(ch, dtype=dtype)
        self.block_2 = ResnetBlock(ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in (self.block_1, self.attn_1, self.block_2):
            x = remat(blk, x, enabled=self.use_checkpoint)
        return x


class _Level(nn.Module):
    """One resolution level: `block` ResnetBlocks, optional `attn`, and the
    resampler (`downsample` in the encoder, `upsample` in the decoder)."""

    def __init__(self, blocks, attns, resample_name=None, resample=None, use_checkpoint: bool = False):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.block = nn.ModuleList(blocks)
        self.attn = nn.ModuleList(attns)
        self.resample_name = resample_name
        if resample is not None:
            setattr(self, resample_name, resample)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i, blk in enumerate(self.block):
            h = remat(blk, h, enabled=self.use_checkpoint)
            if len(self.attn):
                h = remat(self.attn[i], h, enabled=self.use_checkpoint)
        if self.resample_name is not None:
            h = getattr(self, self.resample_name)(h)
        return h


class Encoder(nn.Module):
    def __init__(self, in_channels: int, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 512, z_channels: int = 4, double_z: bool = True,
                 lidar_adapter: bool = False, use_checkpoint: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lidar_adapter, self.use_checkpoint = lidar_adapter, use_checkpoint
        if lidar_adapter:
            self.conv_in_lidar = Conv2d(in_channels, ch, (1, 5), dtype=dtype)
            self.res_block_lidar1 = ResnetBlock(ch, ch, (1, 5), dtype=dtype)
            self.res_block_lidar2 = ResnetBlock(ch, ch, (1, 5), dtype=dtype)
        else:
            self.conv_in = Conv2d(in_channels, ch, dtype=dtype)
        self.down = nn.ModuleList()
        block_in, curr_res = ch, resolution
        for i_level, mult in enumerate(ch_mult):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(ResnetBlock(block_in, ch * mult, dtype=dtype))
                block_in = ch * mult
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, dtype=dtype))
            last = i_level == len(ch_mult) - 1
            self.down.append(_Level(
                blocks, attns, None if last else "downsample",
                None if last else Downsample(block_in, dtype=dtype), use_checkpoint))
            if not last:
                curr_res //= 2
        self.mid = _Mid(block_in, dtype, use_checkpoint)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = Conv2d(block_in, 2 * z_channels if double_z else z_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.lidar_adapter:
            h = self.conv_in_lidar(x)
            for blk in (self.res_block_lidar1, self.res_block_lidar2):
                h = remat(blk, h, enabled=self.use_checkpoint)
        else:
            h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, out_ch: int = 3, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 4, 4),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 resolution: int = 512, z_channels: int = 4,
                 lidar_adapter: bool = False, use_checkpoint: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lidar_adapter, self.use_checkpoint = lidar_adapter, use_checkpoint
        num_levels = len(ch_mult)
        block_in = ch * ch_mult[-1]
        curr_res = resolution // 2 ** (num_levels - 1)
        self.conv_in = Conv2d(z_channels, block_in, dtype=dtype)
        self.mid = _Mid(block_in, dtype, use_checkpoint)
        levels = [None] * num_levels
        for i_level in reversed(range(num_levels)):
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, ch * ch_mult[i_level], dtype=dtype))
                block_in = ch * ch_mult[i_level]
                if curr_res in attn_resolutions:
                    attns.append(AttnBlock(block_in, dtype=dtype))
            levels[i_level] = _Level(
                blocks, attns, "upsample" if i_level else None,
                Upsample(block_in, dtype=dtype) if i_level else None, use_checkpoint)
            if i_level:
                curr_res *= 2
        self.up = nn.ModuleList(levels)
        if lidar_adapter:
            self.res_block_lidar1 = ResnetBlock(block_in, block_in, (1, 5), dtype=dtype)
            self.norm_out_lidar1 = GroupNorm(block_in)
            self.res_block_lidar2 = ResnetBlock(block_in, block_in, (1, 5), dtype=dtype)
            self.norm_out_lidar2 = GroupNorm(block_in)
            self.conv_out_lidar = Conv2d(block_in, out_ch, (1, 5), dtype=dtype)
        else:
            self.norm_out = GroupNorm(block_in)
            self.conv_out = Conv2d(block_in, out_ch, dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        if self.lidar_adapter:
            h = F.silu(self.norm_out_lidar1(remat(self.res_block_lidar1, h, enabled=self.use_checkpoint)))
            h = F.silu(self.norm_out_lidar2(remat(self.res_block_lidar2, h, enabled=self.use_checkpoint)))
            return self.conv_out_lidar(h)
        return self.conv_out(F.silu(self.norm_out(h)))


class AutoencoderKL(nn.Module):
    """Encoder + 1x1 quant convs + Decoder."""

    def __init__(self, embed_dim: int = 4, ch: int = 128, out_ch: int = 3,
                 ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attn_resolutions: Sequence[int] = (), resolution: int = 512,
                 z_channels: int = 4, lidar_adapter: bool = False, use_checkpoint: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(ch=ch, ch_mult=ch_mult, num_res_blocks=num_res_blocks,
                  attn_resolutions=attn_resolutions, resolution=resolution,
                  z_channels=z_channels, lidar_adapter=lidar_adapter,
                  use_checkpoint=use_checkpoint, dtype=dtype)
        self.encoder = Encoder(in_channels=out_ch, double_z=True, **kw)
        self.decoder = Decoder(out_ch=out_ch, **kw)
        self.quant_conv = Conv2d(2 * z_channels, 2 * embed_dim, (1, 1), dtype=dtype)
        self.post_quant_conv = Conv2d(embed_dim, z_channels, (1, 1), dtype=dtype)
        self.downsample_factor = 2 ** (len(ch_mult) - 1)

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "AutoencoderKL":
        """Seeded weights by the JAX package's initializers, as
        MobiDiffusion.init_random_ draws a VAE's: every conv kernel
        uniform(+-fan_in^-1/2), biases 0, norms (1, 0). Returns self."""
        init_layers_(self, torch.Generator(device=self.quant_conv.weight.device).manual_seed(seed))
        return self

    def last_layer(self) -> torch.Tensor:
        """The decoder's last conv kernel (conv_out_lidar with the lidar
        adapter, else conv_out): the adaptive GAN weight's W."""
        dec = self.decoder
        return (dec.conv_out_lidar if dec.lidar_adapter else dec.conv_out).weight

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        moments = self.quant_conv(self.encoder(x.contiguous()))
        return DiagonalGaussian.from_moments(moments, channel_axis=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.contiguous()))


def autoencoder_from_config(embed_dim: int = 4, ddconfig: Optional[dict] = None, dtype: torch.dtype = torch.float32,
                            **_) -> AutoencoderKL:
    """The `model.params` of a first-stage YAML (configs/range_autoencoder.yaml)
    -> AutoencoderKL, as the JAX training script builds it from `ddconfig`:
    `use_checkpoint` (activation remat per block) True unless the ddconfig
    says otherwise; the loss config, monitor and image key are the
    trainer's. The weights are not initialised (`init_random_` or a load)."""
    dd = dict(ddconfig or {})
    return AutoencoderKL(
        embed_dim=embed_dim, ch=dd.get("ch", 128), ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        num_res_blocks=dd.get("num_res_blocks", 2), attn_resolutions=tuple(dd.get("attn_resolutions", ())),
        resolution=dd.get("resolution", 512), z_channels=dd.get("z_channels", 4), out_ch=dd.get("out_ch", 2),
        lidar_adapter=dd.get("lidar_adapter", False), use_checkpoint=dd.get("use_checkpoint", True), dtype=dtype)
