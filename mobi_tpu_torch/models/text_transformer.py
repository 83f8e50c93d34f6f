"""The text-conditioning transformer stack of the legacy surfaces (mobi_tpu
models/text_transformer.py): the x-transformer encoder (`EncoderBlock`,
`TransformerWrapper`), the `BERTEmbedder` over it and `SpatialRescaler`.

  * Attention is the plain formula (the JAX package pins backend="xla"); a
    key-padding mask [B, N] is broadcast to [B, N, N] and fills the masked
    logits with finfo(float32).min, not -inf, so a fully padded row gets
    JAX's uniform softmax instead of NaN.
  * The MLP's GELU is the exact erf form.
  * `SpatialRescaler` resizes as `jax.image.resize` does: half-pixel
    centres, antialiased when it shrinks (`F.interpolate(...,
    antialias=True)`).

Tokenization (the JAX package's `tokenize_bert`) loads transformers'
`bert-base-uncased` vocabulary through `from_pretrained`, which the port
does not depend on: it is not ported, and the modules take token ids.
Module names are the JAX names in PyTorch's dotted form (`block_3` ->
`block.3`). `export_torch.py` has no mapping for these models, so no
published checkpoint name applies: `convert.text_transformer_state_dict`
carries a JAX tree across.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobi_tpu_torch.models.layers import Conv2d, Dense, LayerNorm, init_layers_
from mobi_tpu_torch.ops.attention import dot_product_attention


class EncoderBlock(nn.Module):
    """Pre-LN self-attention (no bias on q, k, v) and an exact-GELU MLP,
    each around a residual."""

    def __init__(self, dim: int, heads: int = 8, ff_mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.attn_norm = LayerNorm(dim)
        self.to_q, self.to_k, self.to_v = (Dense(dim, dim, bias=False, dtype=dtype) for _ in range(3))
        self.to_out = Dense(dim, dim, dtype=dtype)
        self.ff_norm = LayerNorm(dim)
        self.ff_in = Dense(dim, dim * ff_mult, dtype=dtype)
        self.ff_out = Dense(dim * ff_mult, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.attn_norm(x)
        att = dot_product_attention(self.to_q(h), self.to_k(h), self.to_v(h), num_heads=self.heads,
                                    mask=mask, backend="xla")
        x = x + self.to_out(att)
        return x + self.ff_out(F.gelu(self.ff_in(self.ff_norm(x))))


class TransformerWrapper(nn.Module):
    """Token and learned position embeddings over `depth` EncoderBlocks and
    a final LayerNorm: ids [B, N] (and an optional key-padding mask [B, N],
    True = keep) -> hidden states [B, N, dim]."""

    def __init__(self, num_tokens: int = 30522, max_seq_len: int = 77, dim: int = 1280,
                 depth: int = 32, heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_emb = nn.Embedding(num_tokens, dim)
        self.pos_emb = nn.Embedding(max_seq_len, dim)
        self.block = nn.ModuleList([EncoderBlock(dim, heads, dtype=dtype) for _ in range(depth)])
        self.final_norm = LayerNorm(dim)

    @torch.no_grad()
    def init_random_(self, g: torch.Generator) -> None:
        """Embeddings N(0, 0.02), then every layer by `init_layers_`."""
        for t in (self.token_emb.weight, self.pos_emb.weight):
            t.copy_(torch.randn(t.shape, generator=g, device=t.device) * 0.02)
        init_layers_(self, g)

    def forward(self, token_ids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n = token_ids.shape
        x = self.token_emb.weight[token_ids].to(self.dtype) + self.pos_emb.weight[:n].to(self.dtype)[None]
        attn_mask = None if mask is None else mask.bool()[:, None, :].expand(b, n, n)
        for blk in self.block:
            x = blk(x, attn_mask)
        return self.final_norm(x)


class BERTEmbedder(nn.Module):
    """BERT-vocabulary text conditioning: ids [B, 77] -> context [B, 77,
    n_embed] through `transformer` (a TransformerWrapper, 8 heads). Built on
    `device` (CUDA unless the caller names another) with seeded weights.
    `mask` is the wrapper's key-padding mask; the JAX module passes none."""

    def __init__(self, n_embed: int = 1280, n_layer: int = 32, vocab_size: int = 30522,
                 max_seq_len: int = 77, device=None, seed: int = 0, dtype: torch.dtype = torch.float32):
        from mobi_tpu_torch.models.diffusion import resolve_device

        super().__init__()
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.transformer = TransformerWrapper(vocab_size, max_seq_len, n_embed, n_layer, dtype=dtype)
        self.transformer.init_random_(torch.Generator(device=self.device).manual_seed(seed))

    def forward(self, token_ids: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.transformer(token_ids, mask)


class SpatialRescaler(nn.Module):
    """`n_stages` resizes by `multiplier` (each to int(h * m) x int(w * m)),
    then an optional 1x1 `channel_mapper` to `out_channels`; NCHW. Methods:
    "bilinear" (jax.image.resize's "bilinear" and "linear") and "nearest"
    (half-pixel centres, torch's "nearest-exact")."""

    MODES = {"bilinear": "bilinear", "linear": "bilinear", "nearest": "nearest-exact"}

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None, use_bias: bool = False,
                 device=None, seed: int = 0):
        from mobi_tpu_torch.models.diffusion import resolve_device

        super().__init__()
        if method not in self.MODES:
            raise NotImplementedError(f"method {method!r}: the port resizes with {sorted(self.MODES)}")
        self.n_stages, self.mode, self.multiplier = n_stages, self.MODES[method], multiplier
        self.device = resolve_device(device)
        self.channel_mapper = None
        if out_channels is not None:
            with torch.device(self.device):
                self.channel_mapper = Conv2d(in_channels, out_channels, (1, 1), bias=use_bias)
            init_layers_(self, torch.Generator(device=self.device).manual_seed(seed))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            h, w = x.shape[2:]
            size = (int(h * self.multiplier), int(w * self.multiplier))
            if self.mode == "bilinear":
                x = F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)
            else:
                x = F.interpolate(x, size=size, mode=self.mode)
        return x if self.channel_mapper is None else self.channel_mapper(x)
