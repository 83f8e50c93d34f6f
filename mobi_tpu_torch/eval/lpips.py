"""LPIPS with the AlexNet trunk (mobi_tpu eval/lpips.py), NCHW.

The perceptual distance of the lpips package (v0.1, net="alex") as the JAX
package computes it:

  * inputs RGB in [-1, 1], shifted by (-.030, -.088, -.188) and scaled by
    (.458, .448, .450);
  * AlexNet's five conv + ReLU stages, each ReLU output a tap, VALID 3 x 3
    stride-2 max-pools after stages 0 and 1 only;
  * each tap's channels unit-normalised as a * rsqrt(sum(a^2) + 1e-10),
    the squared difference through a bias-free 1 x 1 head, its spatial
    mean, summed over the stages.

Module names are the published ones: the trunk is torchvision AlexNet's
`features` (convs at 0, 3, 6, 8, 10) under `net.`, the heads the lpips
package's `lin{i}.model.1.weight`, so `load_published` takes both state
dicts as they are distributed, with strict=True.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (out channels, kernel, stride, padding) of each conv; in channels follow
_ALEX_CFG = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
_POOL_AFTER = (0, 1)  # the max-pool after stage 4 is never tapped


class AlexNetFeatures(nn.Module):
    """torchvision AlexNet's `features` trunk (indices as there: conv, ReLU,
    pool, ...), returning the ReLU output of each of the five stages."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for i, (cout, k, s, p) in enumerate(_ALEX_CFG):
            layers += [nn.Conv2d(cin, cout, k, s, p), nn.ReLU()]
            if i in _POOL_AFTER:
                layers.append(nn.MaxPool2d(3, 2))
            cin = cout
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                taps.append(x)
        return taps


class _Lin(nn.Module):
    """The lpips package's NetLinLayer without its dropout: `model.1` is the
    bias-free 1 x 1 conv to one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.net = AlexNetFeatures()
        for i, (cout, *_rest) in enumerate(_ALEX_CFG):
            setattr(self, f"lin{i}", _Lin(cout))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: [B, 3, H, W] in [-1, 1] -> [B] distances."""
        fx = self.net((x - self.shift) / self.scale)
        fy = self.net((y - self.shift) / self.scale)
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            a = a * torch.rsqrt(a.square().sum(1, keepdim=True) + 1e-10)
            b = b * torch.rsqrt(b.square().sum(1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((a - b).square()).mean(dim=(1, 2, 3))
        return total


def load_published(model: LPIPS, lpips_sd: Dict[str, torch.Tensor], alexnet_sd: Dict[str, torch.Tensor]) -> None:
    """The lpips package's "alex" heads (`lin{i}.model.1.weight`) and
    torchvision AlexNet's state dict into `model`, strict=True. The AlexNet
    file is taken as it is published: its `features.*` are loaded and its
    `classifier.*`, which LPIPS does not use, are left."""
    sd = {f"net.{k}": v for k, v in alexnet_sd.items() if k.startswith("features.")}
    sd.update({k: v for k, v in lpips_sd.items() if k.startswith("lin")})
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
