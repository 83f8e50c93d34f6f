"""MObI UNet in NCHW (mobi_tpu models/unet.py): the SD-1.x eps UNet with the
reference-image cross-attention, the bbox adapter and camera <-> lidar
cross-modal attention.

Module names follow the reference's Lightning state dict
(`input_blocks.1.0.in_layers.0.weight`, `...transformer_blocks.0.attn1.to_q`,
...), so `state_dict()` keys equal what mobi_tpu/export_torch.py writes under
`model.diffusion_model.`. The interleaved multimodal batch is
[cam0, lid0, cam1, lid1, ...]; cross-modal attention views it as pairs.

The up-sampler is layers.Upsample (nearest x2 + 3x3 conv), which is what the
JAX package's UNetUpsample computes, under the same `conv` name.

`return_cache` / `encoder_cache` serve encoder propagation (the DDIM
sampler's `encoder_interval`): the forward can hand back its input blocks'
skip activations and the middle block's output, and a later forward given
them skips the input and middle blocks.

`use_checkpoint` is the JAX package's activation remat (flax nn.remat per
block): True recomputes every ResBlock and SpatialTransformer in the
backward, "transformer" only the SpatialTransformers, False nothing.

Not ported yet: EncoderUNetModel (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobi_tpu_torch.models.layers import Conv2d, Dense, GroupNorm, LayerNorm, Upsample, remat
from mobi_tpu_torch.ops.attention import dot_product_attention
from mobi_tpu_torch.ops.schedules import timestep_embedding


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 attn_backend: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.attn_backend = heads, attn_backend
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(inner, query_dim, dtype=dtype)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        out = dot_product_attention(
            self.to_q(x), self.to_k(ctx), self.to_v(ctx),
            num_heads=self.heads, backend=self.attn_backend,
        )
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Dense(dim, inner * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)  # exact-erf gelu


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP, mult 4: net.0 = GEGLU, net.2 = output projection."""

    def __init__(self, dim: int, mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult, dtype), nn.Identity(),
                                  Dense(dim * mult, dim, dtype=dtype)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """self-attn -> CLIP cross-attn -> bbox adapter -> cross-modal -> FF.
    `attn_backend` goes to the self- and cross-modal attentions, as in the
    JAX package; the CLIP and bbox attentions keep "auto", which sends their
    short contexts to the plain formula."""

    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int,
                 bbox_cond: bool = False, multimodal: bool = False,
                 attn_backend: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bbox_cond, self.multimodal = bbox_cond, multimodal
        attn = dict(heads=heads, dim_head=dim_head, dtype=dtype)
        self.attn1 = CrossAttention(dim, dim, attn_backend=attn_backend, **attn)
        self.attn2 = CrossAttention(dim, context_dim, **attn)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim, dtype=dtype)
        if bbox_cond:
            self.cond_adapter_norm = LayerNorm(dim)
            self.cond_adapter_attn = CrossAttention(dim, context_dim, **attn)
            self.cond_adapter_connector = Dense(dim, dim, dtype=dtype)
        if multimodal:
            for m in ("camera", "lidar"):
                setattr(self, f"cross_modal_norm_{m}", LayerNorm(dim))
                setattr(self, f"cross_modal_attn_{m}",
                        CrossAttention(dim, dim, attn_backend=attn_backend, **attn))
                setattr(self, f"cross_modal_connector_{m}", Dense(dim, dim, dtype=dtype))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        # the CLIP reference token only (reference attention.py:235)
        x = self.attn2(self.norm2(x), context[:, :1]) + x
        if self.bbox_cond:
            h = self.cond_adapter_attn(self.cond_adapter_norm(x), context)
            x = self.cond_adapter_connector(h) + x
        if self.multimodal:
            b2, n, c = x.shape
            pair = x.reshape(b2 // 2, 2, n, c)
            x_camera, x_lidar = pair[:, 0], pair[:, 1]
            h = self.cross_modal_attn_camera(self.cross_modal_norm_camera(x_camera), x_lidar)
            x_camera = self.cross_modal_connector_camera(h) + x_camera
            # lidar attends to the ALREADY-UPDATED camera tokens
            h = self.cross_modal_attn_lidar(self.cross_modal_norm_lidar(x_lidar), x_camera)
            x_lidar = self.cross_modal_connector_lidar(h) + x_lidar
            x = torch.stack([x_camera, x_lidar], dim=1).reshape(b2, n, c)
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GN (eps 1e-6) -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out -> +x."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, bbox_cond: bool, multimodal: bool,
                 attn_backend: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, inner, (1, 1), dtype=dtype)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, dim_head, context_dim, bbox_cond,
                                  multimodal, attn_backend, dtype)
            for _ in range(depth)
        ])
        self.proj_out = Conv2d(inner, channels, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, _, hgt, wdt = x.shape
        h = self.proj_in(self.norm(x))
        inner = h.shape[1]
        h = h.flatten(2).transpose(1, 2).contiguous()
        for blk in self.transformer_blocks:
            h = blk(h, context)
        # back to contiguous NCHW: a transposed view would carry channels-last
        # strides through the convs that follow
        h = h.transpose(1, 2).reshape(b, inner, hgt, wdt).contiguous()
        return self.proj_out(h) + x


class ResBlock(nn.Module):
    """UNet residual block with timestep injection; GroupNorm eps 1e-5.
    in_layers = [GN, SiLU, conv], emb_layers = [SiLU, Dense],
    out_layers = [GN, SiLU, dropout slot, conv] (reference indices). With
    `fused_gn` each GN + SiLU pair runs as one fused call."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 fused_gn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_layers = nn.Sequential(
            GroupNorm(in_channels, eps=1e-5, fuse_silu=fused_gn), nn.SiLU(),
            Conv2d(in_channels, out_channels, dtype=dtype))
        self.emb_layers = nn.Sequential(nn.SiLU(), Dense(emb_channels, out_channels, dtype=dtype))
        self.out_layers = nn.Sequential(
            GroupNorm(out_channels, eps=1e-5, fuse_silu=fused_gn), nn.SiLU(),
            nn.Identity(), Conv2d(out_channels, out_channels, dtype=dtype))
        self.skip_connection = (
            Conv2d(in_channels, out_channels, (1, 1), dtype=dtype)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = _norm_silu(self.in_layers[0], x)
        h = self.in_layers[2](h)
        e = self.emb_layers[1](F.silu(emb))
        h = h + e[:, :, None, None]
        h = self.out_layers[3](_norm_silu(self.out_layers[0], h))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


def _norm_silu(norm: GroupNorm, x: torch.Tensor) -> torch.Tensor:
    h = norm(x)
    return h if norm.fuse_silu else F.silu(h)


class UNetDownsample(nn.Module):
    """Stride-2 conv with symmetric padding 1."""

    def __init__(self, channels: int, out_channels: int, dtype: torch.dtype):
        super().__init__()
        self.op = Conv2d(channels, out_channels, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class UNetModel(nn.Module):
    """Full UNet. x: [B, in_channels, H, W] (9 = 4 noisy + 4 inpaint latent +
    1 mask), timesteps: [B], context: [B, n_tokens, context_dim]. With camera
    and lidar, B is even and interleaved. Returns eps in x's dtype."""

    def __init__(
        self,
        in_channels: int = 9,
        model_channels: int = 320,
        out_channels: int = 4,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        transformer_depth: int = 1,
        context_dim: int = 768,
        bbox_cond: bool = True,
        use_camera: bool = True,
        use_lidar: bool = True,
        fused_gn: Optional[bool] = None,
        use_checkpoint: Union[bool, str] = False,
        attn_backend: str = "auto",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        if fused_gn is None:  # the JAX package's switch, read once here
            fused_gn = os.environ.get("MOBI_FUSED_GN", "0") == "1"
        self.model_channels, self.dtype = model_channels, dtype
        mc, emb_ch = model_channels, 4 * model_channels
        multimodal = use_camera and use_lidar

        def transformer(ch):
            return SpatialTransformer(
                ch, num_heads, ch // num_heads, transformer_depth, context_dim,
                bbox_cond, multimodal, attn_backend, dtype)

        def res(cin, cout):
            return ResBlock(cin, cout, emb_ch, fused_gn, dtype)

        self.time_embed = nn.Sequential(Dense(mc, emb_ch, dtype=dtype), nn.SiLU(),
                                        Dense(emb_ch, emb_ch, dtype=dtype))
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, mc, dtype=dtype)])])
        skips, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(transformer(ch))
                self.input_blocks.append(nn.ModuleList(layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([UNetDownsample(ch, ch, dtype)]))
                skips.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([res(ch, ch), transformer(ch), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(channel_mult))):
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skips.pop(), mc * mult)]
                ch = mc * mult
                if ds in attention_resolutions:
                    layers.append(transformer(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch, dtype))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        self.out = nn.Sequential(GroupNorm(ch, eps=1e-5, fuse_silu=fused_gn), nn.SiLU(),
                                 Conv2d(ch, out_channels, dtype=dtype))

    def set_fused_gn(self, fused: bool) -> None:
        """Switch every ResBlock norm and the final norm between the fused
        GroupNorm + SiLU call and GroupNorm followed by SiLU."""
        for m in self.modules():
            if isinstance(m, ResBlock):
                m.in_layers[0].fuse_silu = m.out_layers[0].fuse_silu = fused
        self.out[0].fuse_silu = fused

    def _run(self, block: nn.ModuleList, h, emb, context):
        for layer in block:
            if isinstance(layer, ResBlock):
                h = remat(layer, h, emb, enabled=self.use_checkpoint is True)
            elif isinstance(layer, SpatialTransformer):
                h = remat(layer, h, context, enabled=self.use_checkpoint in (True, "transformer"))
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, context: torch.Tensor,
                encoder_cache: Optional[Tuple[torch.Tensor, ...]] = None,
                return_cache: bool = False):
        """eps, or (eps, cache) with `return_cache`. With `encoder_cache` (a
        cache returned earlier) the input and middle blocks are skipped and
        the cached skips and middle output are reused; the decoder still sees
        this call's timesteps and context (mobi_tpu unet.py:278-289,
        348-388)."""
        if self.use_checkpoint not in (True, False, "transformer"):
            # the JAX package's message, word for word
            raise ValueError(
                f"use_checkpoint={self.use_checkpoint!r}: expected True, "
                'False, or "transformer" (a typo here would silently '
                "disable remat and OOM 512-config training)"
            )
        t_emb = timestep_embedding(timesteps, self.model_channels).to(self.dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        context = context.to(self.dtype)
        if encoder_cache is None:
            h = x.to(self.dtype).contiguous()  # NCHW, as the fused norm kernel takes it
            hs = []
            for block in self.input_blocks:
                h = self._run(block, h, emb, context)
                hs.append(h)
            h = self._run(self.middle_block, h, emb, context)
        else:
            hs, h = list(encoder_cache[:-1]), encoder_cache[-1]
        cache = tuple(hs) + (h,) if return_cache else None
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=1), emb, context)
        out = self.out[2](_norm_silu(self.out[0], h)).to(x.dtype)
        return (out, cache) if return_cache else out
