"""The conditioning stage as plain float32 functions: the CLIP ViT image
tower (HF CLIPVisionModel: pre-LN layers, quick-GELU, the pooled
post-LayerNorm CLS), Paint-by-Example's 1-head mapper with its final
LayerNorm, the `proj_out` image-token projection, MObI's Fourier bbox
embedder, and the learned unconditional tokens of classifier-free
guidance.
"""
from __future__ import annotations

from typing import Mapping

import torch

from port_bench.reference.nn import Params, attention, conv, gelu, layer_norm, linear, quick_gelu, silu

CLIP = "cond_stage_model.transformer.vision_model."
MAPPER = "cond_stage_model.mapper.resblocks."
BBOX = "cond_stage_model.bbox_embedder."


def _count(P: Params, fmt: str) -> int:
    n = 0
    while fmt.format(n) in P:
        n += 1
    return n


def clip_image(P: Params, arch: Mapping, pixels_nhwc: torch.Tensor) -> torch.Tensor:
    """CLIP-normalized [B, S, S, 3] -> pooled [B, width]."""
    heads = arch["clip_heads"]
    x = conv(P, CLIP + "embeddings.patch_embedding", pixels_nhwc.permute(0, 3, 1, 2),
             stride=arch["clip_patch_size"], padding=0)
    x = x.flatten(2).transpose(1, 2)
    cls = P[CLIP + "embeddings.class_embedding"].expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + P[CLIP + "embeddings.position_embedding.weight"][None]
    x = layer_norm(P, CLIP + "pre_layrnorm", x)
    for i in range(_count(P, CLIP + "encoder.layers.{}.layer_norm1.weight")):
        n = f"{CLIP}encoder.layers.{i}."
        h = layer_norm(P, n + "layer_norm1", x)
        a = attention(linear(P, n + "self_attn.q_proj", h), linear(P, n + "self_attn.k_proj", h),
                      linear(P, n + "self_attn.v_proj", h), heads)
        x = x + linear(P, n + "self_attn.out_proj", a)
        h = layer_norm(P, n + "layer_norm2", x)
        x = x + linear(P, n + "mlp.fc2", quick_gelu(linear(P, n + "mlp.fc1", h)))
    return layer_norm(P, CLIP + "post_layernorm", x[:, 0])


def image_token(P: Params, arch: Mapping, pixels_nhwc: torch.Tensor) -> torch.Tensor:
    """[B, S, S, 3] -> the projected reference-image token [B, 1, context_dim]."""
    z = clip_image(P, arch, pixels_nhwc)[:, None, :]
    for i in range(_count(P, MAPPER + "{}.ln_1.weight")):
        n = f"{MAPPER}{i}."
        h = layer_norm(P, n + "ln_1", z)
        d = h.shape[-1]
        qkv = linear(P, n + "attn.c_qkv", h)  # one head: [q, k, v]
        a = attention(qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:], heads=1)
        z = z + linear(P, n + "attn.c_proj", a)
        z = z + linear(P, n + "mlp.c_proj", gelu(linear(P, n + "mlp.c_fc", layer_norm(P, n + "ln_2", z))))
    z = layer_norm(P, "cond_stage_model.final_ln", z)
    return linear(P, "proj_out", z)


def bbox_token(P: Params, bbox: torch.Tensor, num_freqs: int = 4) -> torch.Tensor:
    """[B, 8, 3] normalized corners -> [B, 1, D]: the corners and their
    sin / cos at frequencies 1, 2, 4, 8, flattened, then four linears."""
    parts = [bbox]
    for i in range(num_freqs):
        f = 2.0 ** i
        parts += [torch.sin(bbox * f), torch.cos(bbox * f)]
    emb = torch.cat(parts, dim=-1).flatten(1)
    h = linear(P, BBOX + "bbox_proj", emb)
    h = silu(linear(P, BBOX + "second_linear.0", h))
    h = silu(linear(P, BBOX + "second_linear.2", h))
    return linear(P, BBOX + "second_linear.4", h)[:, None, :]


def context(P: Params, arch: Mapping, cond: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The conditioning tokens [B, n, D]: the image token, then the bbox
    token when the configuration conditions on boxes."""
    tokens = [image_token(P, arch, cond["ref_image"])]
    if "ref_bbox" in arch["cond_stage_key"]:
        tokens.append(bbox_token(P, cond["ref_bbox"]))
    return torch.cat(tokens, dim=1)


def uncond(P: Params, arch: Mapping, rows: int) -> torch.Tensor:
    toks = [P["learnable_vector"].expand(rows, 1, -1)]
    if "ref_bbox" in arch["cond_stage_key"]:
        toks.append(P["bbox_uncond_vector"].expand(rows, 1, -1))
    return torch.cat(toks, dim=1)
