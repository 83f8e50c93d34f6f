"""Exponential moving average of a module's parameters (mobi_tpu
models/ema.py, the reference's LitEma): after update n (counted from 1) each
shadow value moves as e <- e - (1 - d) (e - p), d = min(decay, (1 + n) /
(10 + n)), with d and 1 - d rounded to float32 as the JAX package computes
them. The shadow keeps each parameter's dtype, as the JAX tree does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn


class LitEma:
    def __init__(self, module: nn.Module, decay: float = 0.9999):
        self.decay = decay
        self.num_updates = 0
        self.shadow: Dict[str, torch.Tensor] = {
            name: p.detach().clone() for name, p in module.named_parameters()
        }

    @torch.no_grad()
    def update(self, module: nn.Module) -> None:
        self.num_updates += 1
        n = self.num_updates
        d = min(np.float32(self.decay), np.float32(1 + n) / np.float32(10 + n))
        one_minus_d = float(np.float32(1.0) - d)
        for name, p in module.named_parameters():
            e = self.shadow[name]
            e.sub_(one_minus_d * (e - p.to(e.dtype)))

    @torch.no_grad()
    def copy_to(self, module: nn.Module) -> None:
        """Write the shadow values into the module's parameters."""
        for name, p in module.named_parameters():
            p.copy_(self.shadow[name])
