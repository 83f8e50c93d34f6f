"""CLIP towers (mobi_tpu models/clip.py).

`CLIPVisionTower`: HF `CLIPVisionModel` semantics, pre-LN encoder, quick-GELU
MLP, pooled output = post_layernorm(CLS). Names follow HF's state dict under
`vision_model.`, including its `pre_layrnorm` spelling. Images come in NHWC,
as at the JAX package's boundary.

`CLIPTextTower`: HF `CLIPTextModel` semantics, token and position
embeddings, a causally masked pre-LN encoder (the plain formula, masked
logits at finfo(float32).min), `final_layer_norm`; it returns the whole last
hidden state. Names follow HF's under `text_model.`, so a converted table
(`convert.clip_text_state_dict`) loads strict. `export_torch.py` has no
mapping for it, so no published checkpoint name applies.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from mobi_tpu_torch.models.layers import Conv2d, Dense, LayerNorm, init_layers_
from mobi_tpu_torch.ops.attention import dot_product_attention

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def clip_normalize(images: torch.Tensor) -> torch.Tensor:
    """Map [-1, 1]-ranged RGB (NHWC) to CLIP-normalized pixel values."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images.dtype, device=images.device)
    return ((images + 1.0) / 2.0 - mean) / std


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.head_dim = heads, width // heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Dense(width, width, dtype=dtype) for _ in range(4))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self.q_proj(x)  # this rank's heads under tensor parallelism
        out = dot_product_attention(q, self.k_proj(x), self.v_proj(x),
                                    num_heads=q.shape[-1] // self.head_dim, mask=mask, backend="xla")
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(width, 4 * width, dtype=dtype)
        self.fc2 = Dense(4 * width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.layer_norm1 = LayerNorm(width)
        self.self_attn = CLIPAttention(width, heads, dtype)
        self.layer_norm2 = LayerNorm(width)
        self.mlp = CLIPMLP(width, dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEmbeddings(nn.Module):
    def __init__(self, image_size: int, patch_size: int, width: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        n_pos = (image_size // patch_size) ** 2 + 1
        self.patch_embedding = Conv2d(3, width, (patch_size, patch_size),
                                      stride=patch_size, padding=0, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.position_embedding = nn.Embedding(n_pos, width)

    def forward(self, pixel_values_nhwc: torch.Tensor) -> torch.Tensor:
        x = pixel_values_nhwc.permute(0, 3, 1, 2).to(self.dtype)
        patches = self.patch_embedding(x).flatten(2).transpose(1, 2)
        b, _, width = patches.shape
        cls = self.class_embedding.to(self.dtype).expand(b, 1, width)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.weight.to(self.dtype)[None]


class CLIPVisionModel(nn.Module):
    def __init__(self, image_size: int, patch_size: int, width: int, layers: int,
                 heads: int, dtype: torch.dtype):
        super().__init__()
        self.embeddings = CLIPEmbeddings(image_size, patch_size, width, dtype)
        self.pre_layrnorm = LayerNorm(width)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(width, heads, dtype) for _ in range(layers)])
        self.post_layernorm = LayerNorm(width)

    def forward(self, pixel_values_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.pre_layrnorm(self.embeddings(pixel_values_nhwc))
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x[:, 0])


class CLIPVisionTower(nn.Module):
    """Returns the pooled CLS feature [B, width] of CLIP-normalized NHWC
    pixels. ViT-L/14 by default: 224 px, patch 14, width 1024, 24 layers,
    16 heads."""

    def __init__(self, image_size: int = 224, patch_size: int = 14, width: int = 1024,
                 layers: int = 24, heads: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vision_model = CLIPVisionModel(image_size, patch_size, width, layers, heads, dtype)

    def forward(self, pixel_values_nhwc: torch.Tensor) -> torch.Tensor:
        return self.vision_model(pixel_values_nhwc)


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, vocab_size: int, max_positions: int, width: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Embedding(max_positions, width)


class CLIPTextModel(nn.Module):
    def __init__(self, vocab_size: int, max_positions: int, width: int, layers: int,
                 heads: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.embeddings = CLIPTextEmbeddings(vocab_size, max_positions, width)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [CLIPEncoderLayer(width, heads, dtype) for _ in range(layers)])
        self.final_layer_norm = LayerNorm(width)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        b, n = input_ids.shape
        emb = self.embeddings
        x = (emb.token_embedding.weight[input_ids].to(self.dtype)
             + emb.position_embedding.weight[:n].to(self.dtype)[None])
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril().expand(b, n, n)
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)


class CLIPTextTower(nn.Module):
    """Token ids [B, N] -> last hidden state [B, N, width]. ViT-B/32's text
    config by default (width 512, 12 layers, 8 heads, vocab 49408, 77
    positions); ViT-L/14's is width 768, 12 heads. Built on `device` (CUDA
    unless the caller names another) with seeded weights: embeddings
    N(0, 0.02), kernels uniform(+-fan_in^-1/2), biases 0, norms (1, 0)."""

    def __init__(self, vocab_size: int = 49408, max_positions: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, device=None, seed: int = 0,
                 dtype: torch.dtype = torch.float32):
        from mobi_tpu_torch.models.diffusion import resolve_device

        super().__init__()
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.text_model = CLIPTextModel(vocab_size, max_positions, width, layers, heads, dtype)
        self.init_random_(seed)

    @torch.no_grad()
    def init_random_(self, seed: int = 0) -> "CLIPTextTower":
        g = torch.Generator(device=self.device).manual_seed(seed)
        emb = self.text_model.embeddings
        for t in (emb.token_embedding.weight, emb.position_embedding.weight):
            t.copy_(torch.randn(t.shape, generator=g, device=t.device) * 0.02)
        init_layers_(self, g)
        return self

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_model(input_ids)
