"""Diagonal Gaussian posterior of the KL-VAEs (mobi_tpu ops/distributions.py),
channel axis 1 for the port's NCHW layout."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from mobi_tpu_torch.ops.draws import randn_rows


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
        """mean + std * N(0, 1); the draw is that of this rank's rows of the
        global batch under ops.draws.batch_shard."""
        noise = randn_rows(self.mean.shape, generator=generator, dtype=self.mean.dtype,
                           device=self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def kl(self, other: Optional["DiagonalGaussian"] = None, dims=(1, 2, 3)) -> torch.Tensor:
        """KL divergence to `other` (N(0, 1) when None), summed over `dims`.
        The JAX package's `axes` count NHWC axes and these NCHW ones: the
        default (1, 2, 3) is every non-batch axis in both, and a JAX
        axes=(1, 2) (H, W) is dims=(2, 3) here."""
        if other is None:
            return 0.5 * torch.sum(self.mean.square() + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum((self.mean - other.mean).square() / other.var + self.var / other.var
                               - 1.0 - self.logvar + other.logvar, dim=dims)

    def nll(self, sample: torch.Tensor, dims=(1, 2, 3)) -> torch.Tensor:
        """Negative log-likelihood of `sample`, summed over `dims` (NCHW, as
        `kl`'s)."""
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * torch.sum(logtwopi + self.logvar + (sample - self.mean).square() / self.var, dim=dims)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL divergence between two Gaussians, elementwise with broadcasting;
    tensors or Python numbers."""
    mean1, logvar1, mean2, logvar2 = (torch.as_tensor(x) for x in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2).square() * torch.exp(-logvar2))
