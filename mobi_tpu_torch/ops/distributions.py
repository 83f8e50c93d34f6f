"""Diagonal Gaussian posterior of the KL-VAEs (mobi_tpu ops/distributions.py),
channel axis 1 for the port's NCHW layout."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor, channel_axis: int = 1) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(moments, 2, dim=channel_axis)
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        noise = torch.randn(
            self.mean.shape, generator=generator, dtype=self.mean.dtype,
            device=self.mean.device,
        )
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL divergence to N(0, 1), summed over each sample's (C, H, W)."""
        return 0.5 * torch.sum(self.mean.square() + torch.exp(self.logvar) - 1.0 - self.logvar,
                               dim=(1, 2, 3))
