"""Noisy-latent classifier (mobi_tpu models/classifier.py): an
EncoderUNetModel trained to predict the class of a VAE latent after it has
been diffused to a random timestep, the classifier-guidance recipe. The
forward-diffusion tables come from `DiffusionSchedule`, as in the JAX
package, so no generative model is built.

`loss` draws t and the noise from a `torch.Generator` unless the caller
passes them (the JAX package draws them inside its loss from a key, so a
parity test computes them there and passes both). `make_classifier_train_step`
returns one step of an optimizer: optax.adam(lr) update for update is the
trainer's `AdamWLowMu(params, lr, torch.float32, weight_decay=0.0)` (fp32
moments, the bias corrections in float32 as optax computes them;
torch.optim.Adam's, in float64, move the first update by ~1e-5). No CLI:
the JAX package has none.

`export_torch.py` has no mapping for this model, so no published checkpoint
name applies: `convert.encoder_unet_state_dict` carries a JAX tree across.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from mobi_tpu_torch.models.unet import EncoderUNetModel
from mobi_tpu_torch.ops.schedules import DiffusionSchedule


class NoisyLatentClassifier(nn.Module):
    """EncoderUNetModel over q-sampled latents (NCHW), built on `device`
    (CUDA unless the caller names another) with JAX's init drawn from
    `seed`: the layers JAX zero-initialises at zero."""

    def __init__(
        self,
        num_classes: int,
        in_channels: int = 4,
        model_channels: int = 128,
        channel_mult: Sequence[int] = (1, 2, 4),
        num_res_blocks: int = 2,
        attention_resolutions: Sequence[int] = (4,),
        pool: str = "attention",
        num_timesteps: int = 1000,
        device=None,
        seed: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        from mobi_tpu_torch.models.diffusion import resolve_device

        super().__init__()
        self.num_classes, self.num_timesteps = num_classes, num_timesteps
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = EncoderUNetModel(
                in_channels=in_channels, model_channels=model_channels, out_channels=num_classes,
                num_res_blocks=num_res_blocks, attention_resolutions=tuple(attention_resolutions),
                channel_mult=tuple(channel_mult), pool=pool, dtype=dtype)
        self.model.init_random_(seed).zero_init_()
        self.schedule = DiffusionSchedule.create(timesteps=num_timesteps)

    def forward(self, zt: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return self.model(zt, t)

    def loss(self, z0: torch.Tensor, labels: torch.Tensor, t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Cross-entropy of the classifier on q_sample(z0, t, noise), and
        {loss, accuracy, t_mean}. t defaults to uniform draws in [0,
        num_timesteps), the noise to N(0, 1), both from `generator`."""
        b = z0.shape[0]
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,), generator=generator, device=z0.device)
        if noise is None:
            noise = torch.randn(z0.shape, generator=generator, device=z0.device, dtype=z0.dtype)
        logits = self.model(self.schedule.q_sample(z0, t, noise), t)
        ce = F.cross_entropy(logits.float(), labels.long(), reduction="none")
        acc = (logits.argmax(dim=-1) == labels).float()
        loss = ce.mean()
        return loss, {"loss": loss.detach(), "accuracy": acc.mean(), "t_mean": t.float().mean()}


def make_classifier_train_step(clf: NoisyLatentClassifier, optimizer: torch.optim.Optimizer) -> Callable:
    """step(z0, labels, t=None, noise=None, generator=None) -> metrics: the
    loss's gradients, then one step of `optimizer` (`AdamWLowMu` at fp32
    moments for optax's adam / adamw) over the classifier's parameters."""

    def step(z0, labels, t=None, noise=None, generator=None):
        optimizer.zero_grad(set_to_none=True)
        loss, metrics = clf.loss(z0, labels, t=t, noise=noise, generator=generator)
        loss.backward()
        optimizer.step()
        return metrics

    return step
