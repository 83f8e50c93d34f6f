"""The MObI UNet (SD-1.x eps UNet with the reference-image cross-attention,
the bbox adapter and camera <-> lidar cross-modal attention), NCHW, as
plain float32 functions over the published state-dict names under
`model.diffusion_model.`.

The multimodal batch is interleaved, [cam0, lid0, cam1, lid1, ...]; the
cross-modal attention views it as pairs, and the lidar rows attend to the
camera rows already updated in the same block.
"""
from __future__ import annotations

from typing import Mapping

import torch

from port_bench.reference.nn import (
    Params, attention, conv, gelu, group_norm, layer_norm, linear, silu, timestep_embedding,
    upsample_nearest_2x,
)

PREFIX = "model.diffusion_model."


def _attn(P: Params, name: str, x: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
    q = linear(P, name + ".to_q", x)
    out = attention(q, linear(P, name + ".to_k", ctx), linear(P, name + ".to_v", ctx), heads)
    return linear(P, name + ".to_out.0", out)


def _transformer_block(P: Params, name: str, x, context, heads: int, bbox: bool, multimodal: bool):
    n1 = layer_norm(P, name + ".norm1", x)
    x = _attn(P, name + ".attn1", n1, n1, heads) + x
    # the reference-image token only
    x = _attn(P, name + ".attn2", layer_norm(P, name + ".norm2", x), context[:, :1], heads) + x
    if bbox:
        h = _attn(P, name + ".cond_adapter_attn", layer_norm(P, name + ".cond_adapter_norm", x), context, heads)
        x = linear(P, name + ".cond_adapter_connector", h) + x
    if multimodal:
        b2, n, c = x.shape
        pair = x.reshape(b2 // 2, 2, n, c)
        cam, lid = pair[:, 0], pair[:, 1]
        h = _attn(P, name + ".cross_modal_attn_camera", layer_norm(P, name + ".cross_modal_norm_camera", cam), lid, heads)
        cam = linear(P, name + ".cross_modal_connector_camera", h) + cam
        h = _attn(P, name + ".cross_modal_attn_lidar", layer_norm(P, name + ".cross_modal_norm_lidar", lid), cam, heads)
        lid = linear(P, name + ".cross_modal_connector_lidar", h) + lid
        x = torch.stack([cam, lid], dim=1).reshape(b2, n, c)
    a, gate = linear(P, name + ".ff.net.0.proj", layer_norm(P, name + ".norm3", x)).chunk(2, dim=-1)
    return linear(P, name + ".ff.net.2", a * gelu(gate)) + x


def _spatial_transformer(P: Params, name: str, x, context, heads: int, bbox: bool, multimodal: bool):
    b, _, hgt, wdt = x.shape
    h = conv(P, name + ".proj_in", group_norm(P, name + ".norm", x, 1e-6))
    inner = h.shape[1]
    h = h.flatten(2).transpose(1, 2)
    h = _transformer_block(P, name + ".transformer_blocks.0", h, context, heads, bbox, multimodal)
    h = h.transpose(1, 2).reshape(b, inner, hgt, wdt)
    return conv(P, name + ".proj_out", h) + x


def _resblock(P: Params, name: str, x, emb):
    h = conv(P, name + ".in_layers.2", silu(group_norm(P, name + ".in_layers.0", x, 1e-5)))
    h = h + linear(P, name + ".emb_layers.1", silu(emb))[:, :, None, None]
    h = conv(P, name + ".out_layers.3", silu(group_norm(P, name + ".out_layers.0", h, 1e-5)))
    if name + ".skip_connection.weight" in P:
        x = conv(P, name + ".skip_connection", x)
    return x + h


def unet(P: Params, arch: Mapping, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """eps of x [B, 9, h, w] at timesteps t [B] under context [B, n, D]."""
    p = PREFIX
    mc, heads = arch["unet_channels"], arch["unet_num_heads"]
    mults, nrb = list(arch["unet_channel_mult"]), arch["unet_num_res_blocks"]
    attn_res = set(arch["unet_attention_resolutions"])
    bbox = "ref_bbox" in arch["cond_stage_key"]
    multimodal = arch["use_camera"] and arch["use_lidar"]

    def st(name, h):
        return _spatial_transformer(P, name, h, context, heads, bbox, multimodal)

    emb = linear(P, p + "time_embed.2", silu(linear(P, p + "time_embed.0", timestep_embedding(t, mc))))
    h = conv(P, p + "input_blocks.0.0", x)
    hs, idx, ds = [h], 1, 1
    for level, _ in enumerate(mults):
        for _ in range(nrb):
            h = _resblock(P, f"{p}input_blocks.{idx}.0", h, emb)
            if ds in attn_res:
                h = st(f"{p}input_blocks.{idx}.1", h)
            hs.append(h)
            idx += 1
        if level != len(mults) - 1:
            h = conv(P, f"{p}input_blocks.{idx}.0.op", h, stride=2, padding=1)
            hs.append(h)
            idx += 1
            ds *= 2
    h = _resblock(P, p + "middle_block.0", h, emb)
    h = st(p + "middle_block.1", h)
    h = _resblock(P, p + "middle_block.2", h, emb)
    idx = 0
    for level in reversed(range(len(mults))):
        for i in range(nrb + 1):
            h = _resblock(P, f"{p}output_blocks.{idx}.0", torch.cat([h, hs.pop()], dim=1), emb)
            j = 1
            if ds in attn_res:
                h = st(f"{p}output_blocks.{idx}.1", h)
                j = 2
            if level and i == nrb:
                h = conv(P, f"{p}output_blocks.{idx}.{j}.conv", upsample_nearest_2x(h))
                ds //= 2
            idx += 1
    return conv(P, p + "out.2", silu(group_norm(P, p + "out.0", h, 1e-5)))
