"""VAE training losses (mobi_tpu models/losses.py): L1 + logvar NLL + KL +
the adaptive-weight GAN term, and the PatchGAN discriminator, NCHW.

As in the JAX package, the trainer calls `generator_loss` and
`discriminator_loss` one after the other (the reference's two
`optimizer_idx` passes). The adaptive GAN weight is ||d nll / d W|| /
(||d g / d W|| + 1e-4) for the decoder's last conv kernel W, taken here with
`torch.autograd.grad` on W (the reference's calculate_adaptive_weight); the
JAX package replays the last conv on its detached input for the same values.

The discriminator is the JAX package's layout, not the reference's: a
GroupNorm of group size 1 (eps 1e-6, flax's) after conv1..conv3 where
taming-transformers has BatchNorm, no bias on those convs, and flax's
default init (lecun-normal kernels, zero biases).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobi_tpu_torch.ops.distributions import DiagonalGaussian


class NLayerDiscriminator(nn.Module):
    """PatchGAN discriminator; module names are the JAX package's (conv0,
    conv{i} and norm{i} for i in 1..n_layers, conv_out)."""

    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(in_channels, ndf, 4, 2, 1)
        cin = ndf
        for i in range(1, n_layers + 1):
            cout = ndf * min(2 ** i, 8)
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, 4, 2 if i < n_layers else 1, 1, bias=False))
            setattr(self, f"norm{i}", nn.GroupNorm(cout, cout, eps=1e-6))
            cin = cout
        self.conv_out = nn.Conv2d(cin, 1, 4, 1, 1)

    @torch.no_grad()
    def init_random_(self, generator: torch.Generator) -> None:
        """flax's defaults: each kernel lecun normal (N(0, 1) truncated to
        [-2, 2], scaled to std fan_in^-1/2), biases 0, norms (1, 0)."""
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                w = m.weight
                u = torch.rand(w.shape, generator=generator, device=w.device) * (hi - lo) + lo
                z = torch.erfinv(2 * u - 1) * math.sqrt(2)
                w.copy_(z.clamp_(-2, 2) * (w[0].numel() ** -0.5 / 0.87962566103423978))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.conv0(x), 0.2)
        for i in range(1, self.n_layers + 1):
            h = F.leaky_relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(h)), 0.2)
        return self.conv_out(h)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int) -> float:
    """0 before `threshold` steps, `weight` from there (the GAN gate)."""
    return 0.0 if global_step < threshold else weight


class LidarWithDiscriminator(nn.Module):
    """The range VAE's loss. Its state: `logvar` (a frozen parameter, as
    the JAX trainer takes no gradient for it) and `discriminator`, seeded
    from `seed`."""

    def __init__(self, disc_start: int, logvar_init: float = 0.0, kl_weight: float = 1.0,
                 pixelloss_weight: float = 1.0, disc_num_layers: int = 3, disc_in_channels: int = 3,
                 disc_factor: float = 1.0, disc_weight: float = 1.0, disc_loss: str = "hinge",
                 seed: int = 0, **_):
        super().__init__()
        self.disc_start = disc_start
        self.kl_weight = kl_weight
        self.pixel_weight = pixelloss_weight
        self.disc_factor = disc_factor
        self.disc_weight = disc_weight
        self.d_loss_fn = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
        self.logvar = nn.Parameter(torch.tensor(float(logvar_init)), requires_grad=False)
        self.discriminator = NLayerDiscriminator(disc_in_channels, n_layers=disc_num_layers)
        self.discriminator.init_random_(torch.Generator().manual_seed(seed))

    def nll_and_kl(self, inputs: torch.Tensor, recons: torch.Tensor,
                   posterior: DiagonalGaussian) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        rec = (inputs - recons).abs()
        return self._nll(rec, inputs, posterior)

    def _nll(self, rec, inputs, posterior):
        nll = (rec / torch.exp(self.logvar) + self.logvar).sum() / inputs.shape[0]
        kl = posterior.kl().sum() / inputs.shape[0]
        return nll, kl, rec.mean()

    def adaptive_weight(self, nll: torch.Tensor, g_loss: torch.Tensor, last_layer: torch.Tensor) -> torch.Tensor:
        """||d nll / d last_layer|| / (||d g / d last_layer|| + 1e-4), clipped
        to [0, 1e4], times disc_weight, detached; the graph is kept."""
        nll_g = torch.autograd.grad(nll, last_layer, retain_graph=True)[0]
        gan_g = torch.autograd.grad(g_loss, last_layer, retain_graph=True)[0]
        d_weight = torch.linalg.vector_norm(nll_g) / (torch.linalg.vector_norm(gan_g) + 1e-4)
        return (d_weight.clamp(0.0, 1e4) * self.disc_weight).detach()

    def generator_loss(self, inputs: torch.Tensor, recons: torch.Tensor, posterior: DiagonalGaussian,
                       global_step: int, last_layer: Optional[torch.Tensor] = None,
                       split: str = "train") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, log). `last_layer`: the decoder's last conv kernel, for the
        adaptive weight; None gives it 0 (eval, the reference's RuntimeError
        fallback). The weight is computed whatever the gate, as in the JAX
        package and the reference; `disc_factor` gates the term."""
        nll, kl, rec_mean = self.nll_and_kl(inputs, recons, posterior)
        g_loss = -self.discriminator(recons).mean()
        if last_layer is not None and self.disc_factor > 0:
            d_weight = self.adaptive_weight(nll, g_loss, last_layer)
        else:
            d_weight = torch.zeros((), device=inputs.device)
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        loss = nll + self.kl_weight * kl + d_weight * disc_factor * g_loss
        log = {f"{split}/total_loss": loss, f"{split}/logvar": self.logvar, f"{split}/kl_loss": kl,
               f"{split}/nll_loss": nll, f"{split}/rec_loss": rec_mean, f"{split}/d_weight": d_weight,
               f"{split}/disc_factor": torch.tensor(disc_factor), f"{split}/g_loss": g_loss}
        return loss, log

    def discriminator_loss(self, inputs: torch.Tensor, recons: torch.Tensor, global_step: int,
                           split: str = "train") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, log) on detached inputs and reconstructions."""
        logits_real = self.discriminator(inputs.detach())
        logits_fake = self.discriminator(recons.detach())
        disc_factor = adopt_weight(self.disc_factor, global_step, self.disc_start)
        d_loss = disc_factor * self.d_loss_fn(logits_real, logits_fake)
        log = {f"{split}/disc_loss": d_loss, f"{split}/logits_real": logits_real.mean(),
               f"{split}/logits_fake": logits_fake.mean()}
        return d_loss, log


class LPIPSWithDiscriminator(LidarWithDiscriminator):
    """The camera VAE's loss: the range loss with an AlexNet-LPIPS term added
    to the L1 residual per sample before the logvar NLL. The LPIPS net
    (`lpips`, built only when perceptual_weight > 0) is frozen: gradients
    reach the decoder through its activations, never its weights. Load the
    published weights with `eval.lpips.load_published(loss.lpips, ...)`;
    its seeded random weights serve shape and parity checks only."""

    def __init__(self, *args, perceptual_weight: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.perceptual_weight = perceptual_weight
        if perceptual_weight > 0:
            from mobi_tpu_torch.eval.lpips import LPIPS

            self.lpips = LPIPS()
            self.lpips.requires_grad_(False)

    def nll_and_kl(self, inputs, recons, posterior):
        rec = (inputs - recons).abs()
        if self.perceptual_weight > 0:
            p = self.lpips(inputs, recons)
            rec = rec + self.perceptual_weight * p[:, None, None, None]
        return self._nll(rec, inputs, posterior)
