"""Conditioning encoders (mobi_tpu models/encoders.py): the frozen CLIP image
embedder with its 1-token xf mapper, and the 3D-bbox Fourier embedder.

`CondStageModel(cond)` returns {"ref_image_token": [B, 1, clip_width],
"ref_bbox_token": [B, 1, 768]}; the clip_width -> 768 projection lives in the
diffusion model (`proj_out`), as in the reference.

`ClassEmbedder` is the class-label conditioning of the legacy surfaces: a
frozen table of CLIP-text CLS rows. The JAX package's
`compute_class_text_embeddings` fills it through transformers'
`from_pretrained` (`openai/clip-vit-large-patch14`), which the port does
not depend on: it is not ported, and a table comes in as `table_init`. `export_torch.py` has no mapping for it, so no published
checkpoint name applies.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mobi_tpu_torch.models.clip import CLIPVisionTower
from mobi_tpu_torch.models.layers import Dense, LayerNorm
from mobi_tpu_torch.ops.attention import dot_product_attention


class _XFAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.c_qkv = Dense(width, 3 * width, dtype=dtype)
        self.c_proj = Dense(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        dh = d // self.heads
        # the fused projection is packed PER HEAD: [h0_q, h0_k, h0_v, h1_q, ...]
        qkv = self.c_qkv(x).reshape(b, n, self.heads, 3 * dh)
        q, k, v = (qkv[..., i * dh:(i + 1) * dh].reshape(b, n, d) for i in range(3))
        return self.c_proj(dot_product_attention(q, k, v, num_heads=self.heads, backend="xla"))


class _XFMLP(nn.Module):
    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.c_fc = Dense(width, 4 * width, dtype=dtype)
        self.c_proj = Dense(4 * width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class XFAttentionBlock(nn.Module):
    """Residual pre-LN block: fused-QKV attention with fp32 softmax, exact
    GELU MLP x4."""

    def __init__(self, width: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = _XFAttention(width, heads, dtype)
        self.ln_2 = LayerNorm(width)
        self.mlp = _XFMLP(width, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class XFTransformer(nn.Module):
    """The CLIP-token mapper: a stack of XFAttentionBlocks."""

    def __init__(self, width: int, layers: int = 5, heads: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [XFAttentionBlock(width, heads, dtype) for _ in range(layers)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x)
        return x


def fourier_embed(x: torch.Tensor, num_freqs: int = 4, include_input: bool = True) -> torch.Tensor:
    """[x, sin(f0 x), cos(f0 x), sin(f1 x), ...] over the last axis, with
    freq_bands 2^linspace(0, num_freqs - 1, num_freqs)."""
    freq_bands = 2.0 ** np.linspace(0.0, num_freqs - 1, num_freqs)
    parts = [x] if include_input else []
    for freq in freq_bands:
        parts.append(torch.sin(x * float(freq)))
        parts.append(torch.cos(x * float(freq)))
    return torch.cat(parts, dim=-1)


def fourier_out_dim(input_dims: int, num_freqs: int, include_input: bool = True) -> int:
    return input_dims * (2 * num_freqs + (1 if include_input else 0))


class BBoxEmbedder(nn.Module):
    """8 bbox corners x (x, y, depth) -> 1 conditioning token."""

    def __init__(self, num_freqs: int = 4, proj_dims: Sequence[int] = (768, 512, 512, 768),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_freqs, self.dtype = num_freqs, dtype
        in_dim = 8 * fourier_out_dim(3, num_freqs)
        self.bbox_proj = Dense(in_dim, proj_dims[0], dtype=dtype)
        self.second_linear = nn.Sequential(
            Dense(proj_dims[0], proj_dims[1], dtype=dtype), nn.SiLU(),
            Dense(proj_dims[1], proj_dims[2], dtype=dtype), nn.SiLU(),
            Dense(proj_dims[2], proj_dims[3], dtype=dtype))

    def forward(self, bbox: torch.Tensor) -> torch.Tensor:
        """bbox: [B, 8, 3] normalized corners -> [B, 1, proj_dims[-1]]."""
        emb = fourier_embed(bbox.to(self.dtype), self.num_freqs).flatten(1)
        return self.second_linear(self.bbox_proj(emb))[:, None, :]


class CondStageModel(nn.Module):
    """FrozenCLIPImageEmbedder equivalent. conditions: a subset of
    ("ref_image", "ref_bbox"). The tower sizes default to ViT-L/14 and the
    5-layer mapper; tests pass miniature ones."""

    def __init__(self, conditions: Sequence[str] = ("ref_image", "ref_bbox"),
                 clip_width: int = 1024, clip_image_size: int = 224,
                 clip_patch_size: int = 14, clip_layers: int = 24, clip_heads: int = 16,
                 mapper_layers: int = 5, bbox_proj_dims: Sequence[int] = (768, 512, 512, 768),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conditions = tuple(conditions)
        if "ref_image" in self.conditions:
            self.transformer = CLIPVisionTower(clip_image_size, clip_patch_size, clip_width,
                                               clip_layers, clip_heads, dtype)
            self.mapper = XFTransformer(clip_width, mapper_layers, heads=1, dtype=dtype)
            self.final_ln = LayerNorm(clip_width)
        if "ref_bbox" in self.conditions:
            self.bbox_embedder = BBoxEmbedder(proj_dims=bbox_proj_dims, dtype=dtype)

    def embed_image(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """CLIP-normalized [B, S, S, 3] -> [B, 1, clip_width]."""
        z = self.transformer(pixel_values)[:, None, :]
        return self.final_ln(self.mapper(z))

    def forward(self, cond: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        ret = {}
        if "ref_image" in self.conditions and "ref_image" in cond:
            ret["ref_image_token"] = self.embed_image(cond["ref_image"])
        if "ref_bbox" in self.conditions and "ref_bbox" in cond:
            ret["ref_bbox_token"] = self.bbox_embedder(cond["ref_bbox"])
        return ret


class ClassEmbedder(nn.Module):
    """labels [B] -> rows of the frozen `text_embeddings` table
    [num_classes, embed_dim], in `dtype`. The table is `table_init` when
    given, else N(0, 0.02) from `seed` (flax's init). Built on `device`
    (CUDA unless the caller names another)."""

    def __init__(self, num_classes: int, embed_dim: int = 512, table_init: Optional[np.ndarray] = None,
                 device=None, seed: int = 0, dtype: torch.dtype = torch.float32):
        from mobi_tpu_torch.models.diffusion import resolve_device

        super().__init__()
        self.dtype = dtype
        self.device = resolve_device(device)
        if table_init is not None:
            table = torch.as_tensor(np.asarray(table_init, np.float32))
            if tuple(table.shape) != (num_classes, embed_dim):
                raise ValueError(f"table_init {tuple(table.shape)} != {(num_classes, embed_dim)}")
        else:
            g = torch.Generator().manual_seed(seed)
            table = torch.randn(num_classes, embed_dim, generator=g) * 0.02
        self.text_embeddings = nn.Parameter(table.to(self.device), requires_grad=False)

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        return self.text_embeddings[labels.long()].to(self.dtype)
