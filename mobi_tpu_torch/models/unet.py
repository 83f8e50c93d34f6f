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

`EncoderUNetModel` is the half UNet with a pooled head that the noisy-latent
classifier trains (models/classifier.py). `export_torch.py` has no mapping
for it, so no published checkpoint name applies; `convert.encoder_unet_state_dict`
carries a JAX tree across.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobi_tpu_torch.models.layers import Conv2d, Dense, GroupNorm, LayerNorm, Upsample, init_layers_, remat
from mobi_tpu_torch.ops.attention import dot_product_attention
from mobi_tpu_torch.ops.schedules import timestep_embedding


class CrossAttention(nn.Module):
    """Multi-head attention; self-attention when context is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 attn_backend: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.attn_backend = heads, dim_head, attn_backend
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.ModuleList([Dense(inner, query_dim, dtype=dtype)])

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if context is None else context
        q = self.to_q(x)
        # under tensor parallelism the projections hold this rank's heads only
        out = dot_product_attention(
            q, self.to_k(ctx), self.to_v(ctx),
            num_heads=q.shape[-1] // self.dim_head, backend=self.attn_backend,
        )
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int, dtype: torch.dtype):
        super().__init__()
        self.proj = Dense(dim, inner * 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under tensor parallelism `proj` holds this rank's piece of `a` and
        # the matching piece of `gate` (parallel.mesh shards the two halves
        # alike), so the local chunk pairs them as the whole one does
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


class TrunkAttention(nn.Module):
    """The encoder trunk's self-attention in the JAX package's form:
    GroupNorm (eps 1e-5), then CrossAttention(heads, c // heads) over the
    H * W tokens with no context, plus the residual (mobi_tpu
    models/unet.py:481-494). The reference's AttentionBlock (a qkv conv and
    a zero-init proj_out) differs: ROADMAP queue 3."""

    def __init__(self, channels: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = GroupNorm(channels, eps=1e-5)
        self.attn = CrossAttention(channels, channels, heads, channels // heads, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wdt = x.shape
        att = self.attn(self.norm(x).flatten(2).transpose(1, 2))
        return x + att.transpose(1, 2).reshape(b, c, hgt, wdt).contiguous()


ENCODER_POOLS = ("adaptive", "spatial", "spatial_v2", "attention")


class EncoderUNetModel(nn.Module):
    """Half UNet (the input blocks and two middle ResBlocks) with a pooled
    head, [B, in_channels, H, W] x [B] timesteps -> [B, out_channels] fp32
    logits (mobi_tpu models/unet.py:427-536). Pools:

      * "adaptive": GN + SiLU, global mean, `out_proj` (zero at JAX's init);
      * "spatial" / "spatial_v2": the spatial mean after the input conv,
        every input block and the middle, concatenated, an fp32
        Dense(2048) `out_0`, then ReLU ("spatial") or LayerNorm `out_norm`
        + SiLU ("spatial_v2"), then `out_2`;
      * "attention": GN + SiLU, a learned `pool_query` attends over the
        H * W tokens (`attention_pool`, one query), `attention_pool_proj`.

    The ResBlocks, down-samplers and `time_embed` carry UNetModel's names
    (`input_blocks.{i}.0.in_layers.0.weight`, ...); a trunk attention is
    `input_blocks.{i}.1` (`norm`, `attn.to_q`, ...), the middle block's
    ResBlocks `middle_block.0` and `.2`, the heads the JAX module names.
    Its trunk attention goes through `dot_product_attention(backend="auto")`,
    so at >= FLASH_MIN_SEQ tokens it runs the flash kernels (K1 without a
    gradient, K3 forward and K4/K5 backward with one). With `fused_gn`
    (default: MOBI_FUSED_GN, read here) the ResBlocks' norms run fused; the
    head's `out_norm` never does, as in the JAX package."""

    def __init__(
        self,
        in_channels: int = 4,
        model_channels: int = 320,
        out_channels: int = 1000,
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4, 2, 1),
        channel_mult: Sequence[int] = (1, 2, 4, 4),
        num_heads: int = 8,
        pool: str = "adaptive",
        fused_gn: Optional[bool] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if pool not in ENCODER_POOLS:
            raise ValueError(f"pool={pool!r}: expected one of {ENCODER_POOLS}")
        if fused_gn is None:
            fused_gn = os.environ.get("MOBI_FUSED_GN", "0") == "1"
        self.model_channels, self.pool, self.dtype = model_channels, pool, dtype
        mc, emb_ch = model_channels, 4 * model_channels

        self.time_embed = nn.Sequential(Dense(mc, emb_ch, dtype=dtype), nn.SiLU(),
                                        Dense(emb_ch, emb_ch, dtype=dtype))
        self.input_blocks = nn.ModuleList([nn.ModuleList([Conv2d(in_channels, mc, dtype=dtype)])])
        widths, ch, ds = [mc], mc, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, mult * mc, emb_ch, fused_gn, dtype)]
                ch = mult * mc
                if ds in attention_resolutions:
                    layers.append(TrunkAttention(ch, num_heads, dtype))
                self.input_blocks.append(nn.ModuleList(layers))
                widths.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([UNetDownsample(ch, ch, dtype)]))
                widths.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([ResBlock(ch, ch, emb_ch, fused_gn, dtype), nn.Identity(),
                                           ResBlock(ch, ch, emb_ch, fused_gn, dtype)])
        if pool.startswith("spatial"):
            self.out_0 = Dense(sum(widths) + ch, 2048)
            if pool == "spatial_v2":
                self.out_norm = LayerNorm(2048)
            self.out_2 = Dense(2048, out_channels)
            return
        self.out_norm = GroupNorm(ch, eps=1e-5)
        if pool == "attention":
            self.pool_query = nn.Parameter(torch.zeros(1, 1, ch))
            self.attention_pool = CrossAttention(ch, ch, num_heads, ch // num_heads, dtype=dtype)
            self.attention_pool_proj = Dense(ch, out_channels)
        else:
            self.out_proj = Dense(ch, out_channels)

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "EncoderUNetModel":
        """Seeded weights by the JAX package's initializers: kernels
        uniform(+-fan_in^-1/2), biases 0, norms (1, 0), `pool_query`
        N(0, c^-1/2). Every layer is drawn, those JAX zero-initialises too
        (`zero_init_` zeroes them). Returns self."""
        g = torch.Generator(device=self.time_embed[0].weight.device).manual_seed(seed)
        init_layers_(self, g)
        if self.pool == "attention":
            q = self.pool_query
            q.copy_(torch.randn(q.shape, generator=g, device=q.device) * q.shape[-1] ** -0.5)
        return self

    @torch.no_grad()
    def zero_init_(self) -> "EncoderUNetModel":
        """Zero the layers the JAX package's init leaves at zero: each
        ResBlock's output conv and the adaptive head's `out_proj`."""
        for m in self.modules():
            if isinstance(m, ResBlock):
                m.out_layers[3].weight.zero_()
                m.out_layers[3].bias.zero_()
        if self.pool == "adaptive":
            self.out_proj.weight.zero_()
            self.out_proj.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        t_emb = timestep_embedding(timesteps, self.model_channels).to(self.dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        h = x.to(self.dtype).contiguous()
        pooled = []
        for block in self.input_blocks:
            for layer in block:
                h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
            pooled.append(h.mean(dim=(2, 3)))
        h = self.middle_block[2](self.middle_block[0](h, emb), emb)
        if self.pool.startswith("spatial"):
            pooled.append(h.mean(dim=(2, 3)))
            feats = self.out_0(torch.cat(pooled, dim=1).float())
            feats = F.silu(self.out_norm(feats)) if self.pool == "spatial_v2" else F.relu(feats)
            return self.out_2(feats)
        h = F.silu(self.out_norm(h))
        if self.pool == "attention":
            b, c = h.shape[:2]
            query = self.pool_query.to(h.dtype).expand(b, 1, c)
            att = self.attention_pool(query, h.flatten(2).transpose(1, 2))
            return self.attention_pool_proj(att[:, 0].float())
        return self.out_proj(h.mean(dim=(2, 3)).float())
