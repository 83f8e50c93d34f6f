"""The legacy lidar range-view VQ autoencoder (mobi_tpu models/lidar_vq.py),
NCHW: convolutions circular in azimuth, per-level rectangular strides, attention
at chosen levels, and a vector-quantized bottleneck.

  * `circular_pad` wraps the width (azimuth) and zero-pads the height, in
    the (left, right, top, bottom) order of the stride and kernel tables,
    copied from the JAX package; `CircularConv` then runs a VALID conv.
  * The decoder up-samples with half-pixel-centre bilinear interpolation:
    `jax.image.resize(..., "bilinear")` is `F.interpolate(mode="bilinear",
    align_corners=False)`, whatever the JAX docstring's "align_corners"
    says (ROADMAP queue 3).
  * `VectorQuantizer` takes the argmax of 2<x, e> - |e|^2 in fp32 with the
    straight-through estimator; its loss is beta * mse(sg(q), z) +
    mse(q, sg(z)), beta 0.25.
  * `CircAttnBlock` is single-head and always the plain formula (the JAX
    package pins backend="xla"): no kernel runs in this model.

Module names are the JAX names in PyTorch's dotted form (`down_0_block_1` ->
`down.0.block.1`, `mid_attn_1` -> `mid.attn_1`, a CircularConv's kernel under
`.conv`). `export_torch.py` has no mapping for these models, so no published
checkpoint name applies: `convert.vq_state_dict` carries a JAX tree across.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobi_tpu_torch.models.layers import AttnBlock, Conv2d, GroupNorm, init_layers_
from mobi_tpu_torch.models.vae import _Level

# (kernel, (left, right, top, bottom)) per stride: width circular, height
# zero-padded (mobi_tpu models/lidar_vq.py:36-55).
DOWN_TABLE = {
    (1, 2): ((3, 3), (0, 1, 1, 1)),
    (1, 4): ((3, 5), (1, 1, 1, 1)),
    (2, 1): ((3, 3), (1, 1, 1, 1)),
    (2, 2): ((3, 3), (0, 1, 0, 1)),
}
UP_TABLE = {
    (1, 2): ((1, 5), (2, 2, 0, 0)),
    (1, 4): ((1, 7), (3, 3, 0, 0)),
    (2, 1): ((5, 1), (0, 0, 2, 2)),
    (2, 2): ((3, 3), (1, 1, 1, 1)),
}
# the stride-1 kernels inside the ResnetBlocks and the decoder's tail
KERNEL2PAD = {
    (3, 3): (1, 1, 1, 1),
    (1, 4): (1, 2, 0, 0),
    (1, 1): (0, 0, 0, 0),
    (1, 5): (2, 2, 0, 0),
}


def circular_pad(x: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """Pad NCHW: the width circularly (azimuth wraps), the height with zeros."""
    left, right, top, bottom = pad
    if left or right:
        w = x.shape[-1]
        x = x[..., torch.arange(-left, w + right, device=x.device) % w]
    if top or bottom:
        x = F.pad(x, (0, 0, top, bottom))
    return x


class CircularConv(nn.Module):
    """Conv2d after `circular_pad` (VALID); `pad` defaults to the kernel's
    entry of KERNEL2PAD."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), pad: Optional[Tuple[int, int, int, int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pad = tuple(pad) if pad is not None else KERNEL2PAD[tuple(kernel_size)]
        self.conv = Conv2d(in_channels, out_channels, tuple(kernel_size), stride=tuple(strides),
                           padding=0, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(circular_pad(x, self.pad))


class CircResnetBlock(nn.Module):
    """GN -> swish -> circular conv, twice, with a 1x1 `nin_shortcut` when the
    width changes."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 kernel_size: Tuple[int, int] = (3, 3), dtype: torch.dtype = torch.float32):
        super().__init__()
        out_channels = out_channels or in_channels
        self.norm1 = GroupNorm(in_channels)
        self.conv1 = CircularConv(in_channels, out_channels, kernel_size, dtype=dtype)
        self.norm2 = GroupNorm(out_channels)
        self.conv2 = CircularConv(out_channels, out_channels, kernel_size, dtype=dtype)
        self.nin_shortcut = (Conv2d(in_channels, out_channels, (1, 1), dtype=dtype)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class CircAttnBlock(AttnBlock):
    """Single-head spatial self-attention (make_attn "vanilla"): the VAE's
    AttnBlock, GN (eps 1e-6) and 1x1 q, k, v, proj_out, the plain formula."""


class CircUpsample(CircularConv):
    """The decoder's up-sampler: half-pixel bilinear interpolation by
    `stride`, then the circular conv of UP_TABLE's kernel and pad."""

    def __init__(self, channels: int, stride: Tuple[int, int], dtype: torch.dtype = torch.float32):
        kernel, pad = UP_TABLE[tuple(stride)]
        super().__init__(channels, channels, kernel, pad=pad, dtype=dtype)
        self.stride = tuple(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh, sw = self.stride
        x = F.interpolate(x, size=(x.shape[2] * sh, x.shape[3] * sw), mode="bilinear", align_corners=False)
        return super().forward(x)


class _Mid(nn.Module):
    def __init__(self, ch: int, dtype: torch.dtype):
        super().__init__()
        self.block_1 = CircResnetBlock(ch, dtype=dtype)
        self.attn_1 = CircAttnBlock(ch, dtype)
        self.block_2 = CircResnetBlock(ch, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class VQEncoder(nn.Module):
    """Range-image encoder with rectangular per-level strides:
    [B, in_channels, H, W] -> [B, z (x2 with double_z), H', W']."""

    def __init__(self, ch: int = 64, ch_mult: Sequence[int] = (1, 2, 4),
                 strides: Sequence[Tuple[int, int]] = ((1, 2), (2, 2)), num_res_blocks: int = 2,
                 attn_levels: Sequence[int] = (), in_channels: int = 1, z_channels: int = 8,
                 double_z: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_in = CircularConv(in_channels, ch, (3, 3), dtype=dtype)
        self.down = nn.ModuleList()
        block_in = ch
        for lvl, mult in enumerate(ch_mult):
            blocks, attns = [], []
            for _ in range(num_res_blocks):
                blocks.append(CircResnetBlock(block_in, ch * mult, dtype=dtype))
                block_in = ch * mult
                if lvl in attn_levels:
                    attns.append(CircAttnBlock(block_in, dtype))
            if lvl != len(ch_mult) - 1:
                kernel, pad = DOWN_TABLE[tuple(strides[lvl])]
                self.down.append(_Level(blocks, attns, "downsample", CircularConv(
                    block_in, block_in, kernel, tuple(strides[lvl]), pad, dtype)))
            else:
                self.down.append(_Level(blocks, attns))
        self.mid = _Mid(block_in, dtype)
        self.norm_out = GroupNorm(block_in)
        self.conv_out = CircularConv(block_in, 2 * z_channels if double_z else z_channels, (3, 3), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.contiguous())
        for level in self.down:
            h = level(h)
        return self.conv_out(F.silu(self.norm_out(self.mid(h))))


class VQDecoder(nn.Module):
    """The mirror decoder: (1, 4) kernels at the width-stretched levels, and
    at each stride a half-pixel bilinear up-sample then a circular conv."""

    def __init__(self, ch: int = 64, out_ch: int = 1, ch_mult: Sequence[int] = (1, 2, 4),
                 strides: Sequence[Tuple[int, int]] = ((1, 2), (2, 2)), num_res_blocks: int = 2,
                 attn_levels: Sequence[int] = (), z_channels: int = 8, use_mask: bool = False,
                 tanh_out: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tanh_out = tanh_out
        stride2kernel = {(2, 2): (3, 3), (1, 2): (1, 4)}
        block_in = ch * ch_mult[-1]
        self.conv_in = CircularConv(z_channels, block_in, (3, 3), dtype=dtype)
        self.mid = _Mid(block_in, dtype)
        up = {}
        for lvl in reversed(range(len(ch_mult))):
            stride = tuple(strides[lvl - 1]) if lvl > 0 else None
            kernel = stride2kernel.get(stride, (1, 4)) if stride else (1, 4)
            blocks, attns = [], []
            for _ in range(num_res_blocks + 1):
                blocks.append(CircResnetBlock(block_in, ch * ch_mult[lvl], kernel, dtype))
                block_in = ch * ch_mult[lvl]
                if lvl in attn_levels:
                    attns.append(CircAttnBlock(block_in, dtype))
            up[lvl] = (_Level(blocks, attns, "upsample", CircUpsample(block_in, stride, dtype))
                       if stride is not None else _Level(blocks, attns))
        self.up = nn.ModuleList([up[lvl] for lvl in range(len(ch_mult))])
        self.norm_out = GroupNorm(block_in)
        self.conv_out = CircularConv(block_in, out_ch + 1 if use_mask else out_ch, (1, 4), dtype=dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z.contiguous()))
        for level in reversed(self.up):
            h = level(h)
        h = self.conv_out(F.silu(self.norm_out(h)))
        return torch.tanh(h) if self.tanh_out else h


class VectorQuantizer(nn.Module):
    """Codebook quantization with straight-through gradients; `embedding`
    [n_embed, embed_dim], U[0, 2 / n_embed) at init (flax uniform(scale))."""

    def __init__(self, n_embed: int = 8192, embed_dim: int = 8, beta: float = 0.25):
        super().__init__()
        self.beta = beta
        self.embedding = nn.Embedding(n_embed, embed_dim)

    def scores(self, z: torch.Tensor) -> torch.Tensor:
        """[B, D, H, W] -> fp32 [B * H * W, n_embed] of 2<x, e> - |e|^2, whose
        argmax is the nearest code."""
        cb = self.embedding.weight.float()
        flat = z.permute(0, 2, 3, 1).reshape(-1, cb.shape[1]).float()
        return 2.0 * flat @ cb.T - (cb ** 2).sum(dim=-1)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """z [B, D, H, W] -> (quantized, commitment + codebook loss, indices
        [B, H, W])."""
        b, d, h, w = z.shape
        idx = self.scores(z).argmax(dim=-1)
        quant = self.embedding.weight[idx].reshape(b, h, w, d).permute(0, 3, 1, 2).to(z.dtype)
        loss = (self.beta * torch.mean((quant.detach() - z) ** 2)
                + torch.mean((quant - z.detach()) ** 2))
        quant = z + (quant - z).detach()  # straight-through
        return quant, loss, idx.reshape(b, h, w)


class VQModel(nn.Module):
    """encoder -> 1x1 quant_conv -> VectorQuantizer -> 1x1 post_quant_conv ->
    decoder, built on `device` (CUDA unless the caller names another) with
    seeded weights. `ddconfig` holds VQEncoder's keywords (its defaults
    where absent) plus `out_ch` (default: `in_channels`)."""

    def __init__(self, ddconfig: Optional[Dict[str, Any]] = None, n_embed: int = 8192, embed_dim: int = 8,
                 use_mask: bool = False, device=None, seed: int = 0, dtype: torch.dtype = torch.float32):
        from mobi_tpu_torch.models.diffusion import resolve_device

        super().__init__()
        dd = dict(ddconfig or {})
        out_ch = dd.pop("out_ch", dd.get("in_channels", 1))
        in_ch, z_ch = dd.pop("in_channels", 1), dd.pop("z_channels", 8)
        self.use_mask = use_mask
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.encoder = VQEncoder(in_channels=in_ch, z_channels=z_ch, dtype=dtype, **dd)
            dd.pop("double_z", None)
            self.decoder = VQDecoder(out_ch=out_ch, z_channels=z_ch, use_mask=use_mask, dtype=dtype, **dd)
            self.quantize = VectorQuantizer(n_embed, embed_dim)
            self.quant_conv = Conv2d(z_ch, embed_dim, (1, 1), dtype=dtype)
            self.post_quant_conv = Conv2d(embed_dim, z_ch, (1, 1), dtype=dtype)
        self.init_random_(seed)

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "VQModel":
        """Conv kernels uniform(+-fan_in^-1/2), biases 0, norms (1, 0), the
        codebook U[0, 2 / n_embed), all from `seed`. Returns self."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        init_layers_(self, g)
        e = self.quantize.embedding.weight
        e.copy_(torch.rand(e.shape, generator=g, device=e.device) * (2.0 / e.shape[0]))
        return self

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.quantize(self.quant_conv(self.encoder(x)))

    def decode(self, quant: torch.Tensor) -> torch.Tensor:
        dec = self.decoder(self.post_quant_conv(quant))
        if self.use_mask:  # the second channel < 0 marks no return
            dec = torch.where(dec[:, 1:2] < 0.0, torch.full_like(dec[:, :1], -1.0), dec[:, 0:1])
        return dec

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        quant, emb_loss, _ = self.encode(x)
        return self.decode(quant), emb_loss


class VQModelInterface(VQModel):
    """The latent-diffusion side of VQModel: `encode` returns the
    PRE-quantization latent of the depth channel (channel 0) and `decode`
    quantizes unless `force_not_quantize`."""

    def encode(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return self.quant_conv(self.encoder(x[:, 0:1]))

    def decode(self, h: torch.Tensor, force_not_quantize: bool = False) -> torch.Tensor:  # type: ignore[override]
        quant = h if force_not_quantize else self.quantize(h)[0]
        return VQModel.decode(self, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # type: ignore[override]
        return self.decode(self.encode(x))
