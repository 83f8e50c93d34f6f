"""Seeded weights, made on the device in a few large draws and handed the
same to the program (`load_state_dict`) and to the reference.

The scales are the port's initializer's: every >= 2-D kernel uniform in
+-fan_in^-1/2, `proj_out` normal with std fan_in^-1/2, the CLIP patch
embedding normal with std fan_in^-1/2 cut at two standard deviations, the
CLIP class and position embeddings normal(0.02), the unconditional tokens
normal(1), norm scales 1 and every bias 0. Each tensor takes the dtype the
program holds it in, so both sides start from the same values.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Mapping, Tuple

import torch

DRAW_ELEMENTS = 1 << 28  # elements a draw, so the transient stays near 1 GiB

Layout = Mapping[str, Tuple[Tuple[int, ...], torch.dtype]]


def layout_of(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    return {k: (tuple(v.shape), v.dtype) for k, v in state_dict.items()}


def _rule(name: str, shape) -> Tuple[str, float]:
    """(law, scale) of a tensor: "uniform" in +-scale, "normal" with std
    scale (cut at 2 std for "truncated"), or "const" at scale."""
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    if name in ("learnable_vector", "bbox_uncond_vector"):
        return "normal", 1.0
    if name.endswith("class_embedding") or name.endswith("position_embedding.weight"):
        return "normal", 0.02
    if name.endswith("patch_embedding.weight"):
        return "truncated", fan_in ** -0.5
    if name == "proj_out.weight":
        return "normal", fan_in ** -0.5
    if len(shape) >= 2:
        return "uniform", fan_in ** -0.5
    if name.endswith(".bias"):
        return "const", 0.0
    return "const", 1.0


def _draw_groups(items: List[Tuple[str, int]]) -> Iterator[List[Tuple[str, int]]]:
    group, size = [], 0
    for name, n in items:
        if group and size + n > DRAW_ELEMENTS:
            yield group
            group, size = [], 0
        group.append((name, n))
        size += n
    if group:
        yield group


@torch.no_grad()
def generate(layout: Layout, seed: int, device, fp32: bool = False) -> Dict[str, torch.Tensor]:
    """The weights of `layout` (name -> (shape, dtype)) from `seed`, in each
    tensor's dtype, or those same values in float32 with `fp32`."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    out: Dict[str, torch.Tensor] = {}
    rules = {name: _rule(name, shape) for name, (shape, _) in layout.items()}

    def finish(name, t):
        shape, dtype = layout[name]
        t = t.reshape(shape).to(dtype)
        out[name] = t.float() if fp32 else t

    for law in ("uniform", "normal", "truncated"):
        items = [(n, torch.Size(layout[n][0]).numel()) for n in layout if rules[n][0] == law]
        for group in _draw_groups(items):
            total = sum(n for _, n in group)
            if law == "uniform":
                flat = torch.rand(total, generator=g, device=device).mul_(2).sub_(1)
            else:
                flat = torch.randn(total, generator=g, device=device)
                if law == "truncated":
                    flat.clamp_(-2.0, 2.0)
            off = 0
            for name, n in group:
                finish(name, flat[off:off + n] * rules[name][1])
                off += n
            del flat
    for name, (shape, _) in layout.items():
        if rules[name][0] == "const":
            finish(name, torch.full(shape, rules[name][1], device=device))
    return out
