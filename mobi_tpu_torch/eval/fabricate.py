"""Seeded random weights in the published layouts of the metric networks,
for runs where the published files are absent: the scores they give are
meaningless, the code paths that read them are the real ones.

`published_layouts()` gives {name: {key: shape}} of each file the scorers
read, `fill_published(layout, seed)` seeded values for one layout, and
`write_published(root, seed)` writes all six under `root` (as named in
`PUBLISHED_FILES`). The values are drawn on `device` (the CPU unless named;
the card draws the ~290 M values in a fraction of the CPU's time) and
returned and saved on the CPU, as published files are.

`det_drive_state_dict(detector, seed)` gives a BEVFusion detector the JAX
detection drive's draws in the same spirit (chip_smoke's detection phases
and the lifecycle drive's checkpoint).
"""
from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Dict, Tuple

import torch

Layout = Dict[str, Tuple[int, ...]]

PUBLISHED_FILES = {"clip": "clip_vit_b32.pth", "inception": "inception_v3.pth", "lpips": "lpips_alex.pth",
                   "alexnet": "alexnet.pth", "rangenet_backbone": "darknet53/backbone",
                   "rangenet_decoder": "darknet53/segmentation_decoder"}


def published_layouts() -> Dict[str, Layout]:
    """{file: {key: shape}} of the published state dicts the scorers read:
    an HF CLIPModel at ViT-B/32 (the text tower's keys included: 12 layers
    of width 512, vocabulary 49408, 77 positions), torchvision's
    inception_v3 (with fc and AuxLogits) and alexnet (with its
    classifier), the lpips package's "alex" heads, and RangeNet++'s
    darknet53 backbone and segmentation_decoder."""
    from mobi_tpu_torch.eval.clip_embed import ClipImageEmbedder
    from mobi_tpu_torch.eval.inception import InceptionV3Features
    from mobi_tpu_torch.eval.lpips import LPIPS
    from mobi_tpu_torch.eval.rangenet import RangeNetFRD

    def shapes(module):
        return {k: tuple(v.shape) for k, v in module.state_dict().items()}

    with torch.device("meta"):
        clip, incep, lpips, rn = (shapes(m) for m in (ClipImageEmbedder(), InceptionV3Features(), LPIPS(),
                                                      RangeNetFRD()))
    text = {"text_model.embeddings.token_embedding.weight": (49408, 512),
            "text_model.embeddings.position_embedding.weight": (77, 512)}
    for i in range(12):
        p = f"text_model.encoder.layers.{i}."
        for proj in ("k_proj", "v_proj", "q_proj", "out_proj"):
            text.update({p + f"self_attn.{proj}.weight": (512, 512), p + f"self_attn.{proj}.bias": (512,)})
        text.update({p + "layer_norm1.weight": (512,), p + "layer_norm1.bias": (512,),
                     p + "mlp.fc1.weight": (2048, 512), p + "mlp.fc1.bias": (2048,),
                     p + "mlp.fc2.weight": (512, 2048), p + "mlp.fc2.bias": (512,),
                     p + "layer_norm2.weight": (512,), p + "layer_norm2.bias": (512,)})
    text.update({"text_model.final_layer_norm.weight": (512,), "text_model.final_layer_norm.bias": (512,),
                 "text_projection.weight": (512, 512), "logit_scale": ()})
    aux = {"fc.weight": (1000, 2048), "fc.bias": (1000,),
           "AuxLogits.fc.weight": (1000, 768), "AuxLogits.fc.bias": (1000,)}
    for name, cin, cout, k in (("conv0", 768, 128, 1), ("conv1", 128, 768, 5)):
        aux[f"AuxLogits.{name}.conv.weight"] = (cout, cin, k, k)
        aux.update({f"AuxLogits.{name}.bn.{s}": (cout,) for s in ("weight", "bias", "running_mean", "running_var")})
        aux[f"AuxLogits.{name}.bn.num_batches_tracked"] = ()
    alexnet = {k[len("net."):]: v for k, v in lpips.items() if k.startswith("net.")}
    alexnet.update({"classifier.1.weight": (4096, 9216), "classifier.1.bias": (4096,),
                    "classifier.4.weight": (4096, 4096), "classifier.4.bias": (4096,),
                    "classifier.6.weight": (1000, 4096), "classifier.6.bias": (1000,)})
    return {"clip": {**text, **{k: v for k, v in clip.items() if k.startswith("vision_model.")},
                     "visual_projection.weight": clip["visual_projection.weight"]},
            "inception": {**incep, **aux}, "alexnet": alexnet,
            "lpips": {k: v for k, v in lpips.items() if k.startswith("lin")},
            "rangenet_backbone": {k[len("backbone."):]: v for k, v in rn.items() if k.startswith("backbone.")},
            "rangenet_decoder": {k[len("decoder."):]: v for k, v in rn.items() if k.startswith("decoder.")}}


def fill_published(layout: Layout, seed: int, device="cpu") -> Dict[str, torch.Tensor]:
    """Seeded values for a layout, by the key's role: BatchNorm statistics
    (running variances in [0.5, 1.5]), BatchNorm scales near 1 (darknet's
    residual branches' last ones in [0.1, 0.3], so 23 residual adds keep
    the features in range), LayerNorm scales 1 + N(0, 0.02), the lpips heads
    non-negative, other vectors and embedding tables N(0, 0.02), and every
    other weight He-scaled by its fan-in, so the features stay finite
    through 94 Inception convs and 53 darknet convs."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for k, shape in layout.items():
        def randn(std=1.0):
            return (torch.randn(shape, generator=g, device=device) * std).cpu()

        def uniform(lo, hi):
            return (lo + (hi - lo) * torch.rand(shape, generator=g, device=device)).cpu()

        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(0)
        elif k == "logit_scale":
            out[k] = torch.tensor(math.log(1 / 0.07))
        elif k.endswith("running_var"):
            out[k] = uniform(0.5, 1.5)
        elif k.endswith("running_mean"):
            out[k] = randn(0.1)
        elif re.search(r"residual(_\d+)?\.bn2\.weight$", k):
            out[k] = uniform(0.1, 0.3)
        elif re.search(r"(^|\.)bn\d?\.weight$", k):
            out[k] = uniform(0.8, 1.2)
        elif "norm" in k and k.endswith("weight") and len(shape) == 1:
            out[k] = 1 + randn(0.02)
        elif k.startswith("lin"):
            out[k] = randn(0.1).abs()
        elif len(shape) < 2 or (k.endswith("embedding.weight") and "patch" not in k):
            out[k] = randn(0.02)
        else:
            fan_in = shape[0] * math.prod(shape[2:]) / 2 if "upconv" in k else math.prod(shape[1:])
            out[k] = randn(math.sqrt(2.0 / fan_in))
    return out


def write_published(root, seed: int, device="cpu") -> Dict[str, str]:
    """The six published files under `root`, filled by fill_published with
    seed + i for the i-th, drawn on `device` -> {name: path}."""
    paths = {}
    for i, (name, layout) in enumerate(published_layouts().items()):
        path = Path(root) / PUBLISHED_FILES[name]
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(fill_published(layout, seed + i, device), path)
        paths[name] = str(path)
    return paths


def det_drive_state_dict(model, seed: int) -> Dict[str, torch.Tensor]:
    """A detector's seeded weights as the JAX detection drive draws them
    (scripts/tpu_detection_eval_drive.py:31-40), in the port's state dict:
    every float entry N(0, 0.05) from one CPU generator in `model`'s key
    order, BN running variances |v| + 0.5, other entries as they are. mAP
    is meaningless; the path that loads and runs them is real."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            a = torch.randn(v.shape, generator=g) * 0.05
            out[k] = a.abs() + 0.5 if k.endswith("running_var") else a
        else:
            out[k] = v.detach().cpu()
    return out
