"""Training building blocks (mobi_tpu training.py): the LR schedules, AdamW on
the trainable partition with optional gradient accumulation, the train state
and the train step.

Reference semantics, as the JAX package reads them:
  * LambdaLinearScheduler (configs/mobi_nusc_512.yaml:55-62): warm-up from
    f_start to f_max over warm_up_steps, then linear from f_max to f_min
    across the cycle (constant after warm-up in the shipped configs).
  * AdamW on the adapter partition only, torch defaults (b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-2); the frozen parameters get no update and
    no decay. The schedule is read at the update count, from 0, as optax
    does.
  * accumulate_steps = k > 1 is optax.MultiSteps: one update every k calls,
    on the mean of their k gradients.

The schedules compute in float32 with the JAX expressions' order of
operations. The train state is mutable: the model holds the parameters and
the optimizer its moments. The entry points run on CUDA unless the caller
passes device="cpu", and the model must live there.

Not ported yet (ROADMAP queue 1 item 5): optimizer="adafactor" and
`adam_mu_dtype` (bf16 first moments); both raise NotImplementedError.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mobi_tpu_torch.models.diffusion import MobiDiffusion, resolve_device
from mobi_tpu_torch.models.ema import LitEma

Schedule = Callable[[int], np.float32]
f32 = np.float32


def lambda_linear_schedule(base_lr: float, warm_up_steps: int = 200, f_start: float = 1e-6,
                           f_max: float = 1.0, f_min: float = 1.0,
                           cycle_length: float = 1e13) -> Schedule:
    def schedule(step):
        step = f32(step)
        warm = f32(f_start) + f32(f_max - f_start) * step / f32(max(warm_up_steps, 1))
        lin = f32(f_min) + f32(f_max - f_min) * (f32(cycle_length) - step) / f32(cycle_length)
        return f32(base_lr) * (warm if step < warm_up_steps else lin)

    return schedule


def lambda_warmup_cosine_schedule(base_lr: float, warm_up_steps: int, lr_min: float,
                                  lr_max: float, lr_start: float,
                                  max_decay_steps: int) -> Schedule:
    """LambdaWarmUpCosineScheduler: linear warm-up lr_start -> lr_max, then
    a half cosine down to lr_min over max_decay_steps (clamped after)."""

    def schedule(step):
        step = f32(step)
        warm = f32(lr_start) + f32(lr_max - lr_start) * step / f32(max(warm_up_steps, 1))
        t = (step - f32(warm_up_steps)) / f32(max(max_decay_steps - warm_up_steps, 1))
        t = min(t, f32(1.0))
        cos = f32(lr_min) + f32(0.5 * (lr_max - lr_min)) * (f32(1.0) + np.cos(t * f32(np.pi)))
        return f32(base_lr) * (warm if step < warm_up_steps else cos)

    return schedule


def multi_cycle_schedule(base_lr: float, warm_up_steps, f_min, f_max, f_start,
                         cycle_lengths, shape: str = "linear") -> Schedule:
    """The reference's list-parameterised repeating schedulers: per cycle a
    linear warm-up f_start -> f_max, then a linear ramp toward f_min across
    the cycle ("linear", LambdaLinearScheduler) or a half cosine from f_max
    to f_min over the rest of the cycle, clamped ("cosine",
    LambdaWarmUpCosineScheduler2). A step on a cycle boundary belongs to the
    cycle it ends (searchsorted, side "left")."""
    warm_up_steps, f_min, f_max, f_start, cycle_lengths = (
        np.asarray(a, f32) for a in (warm_up_steps, f_min, f_max, f_start, cycle_lengths))
    if not (warm_up_steps.shape == f_min.shape == f_max.shape == f_start.shape
            == cycle_lengths.shape):
        raise ValueError("per-cycle parameter lists must have equal lengths")
    if shape not in ("linear", "cosine"):
        raise ValueError(f"unknown schedule shape {shape!r}")
    cum = np.concatenate([[0.0], np.cumsum(cycle_lengths)]).astype(f32)

    def schedule(step):
        step = f32(step)
        cycle = int(np.clip(np.searchsorted(cum[1:], step, side="left"), 0, len(cycle_lengths) - 1))
        n = step - cum[cycle]
        wu, fs, fm, fx, cl = (a[cycle] for a in (warm_up_steps, f_start, f_min, f_max, cycle_lengths))
        warm = fs + (fx - fs) * n / max(wu, f32(1.0))
        if shape == "linear":
            after = fm + (fx - fm) * (cl - n) / cl
        else:
            t = min((n - wu) / max(cl - wu, f32(1.0)), f32(1.0))
            after = fm + f32(0.5) * (fx - fm) * (f32(1.0) + np.cos(t * f32(np.pi)))
        return f32(base_lr) * (warm if n < wu else after)

    return schedule


def schedule_from_config(base_lr: float, scheduler_config: Optional[dict]) -> Schedule:
    """The LR schedule a config's scheduler_config block names, by the
    reference's class names; unset -> LambdaLinear with 200 warm-up steps.
    The shipped configs name `mobi_tpu.training.lambda_linear_schedule`,
    which this (like the JAX package's) does not know, so they raise."""
    if not scheduler_config:
        return lambda_linear_schedule(base_lr)
    target = str(scheduler_config.get("target", "")).rsplit(".", 1)[-1]
    p = scheduler_config.get("params", {})
    if target == "LambdaLinearScheduler":
        return multi_cycle_schedule(base_lr, p["warm_up_steps"], p["f_min"], p["f_max"],
                                    p["f_start"], p["cycle_lengths"], shape="linear")
    if target == "LambdaWarmUpCosineScheduler2":
        return multi_cycle_schedule(base_lr, p["warm_up_steps"], p["f_min"], p["f_max"],
                                    p["f_start"], p["cycle_lengths"], shape="cosine")
    if target == "LambdaWarmUpCosineScheduler":
        return lambda_warmup_cosine_schedule(base_lr, p["warm_up_steps"], p["lr_min"],
                                             p["lr_max"], p["lr_start"], p["max_decay_steps"])
    raise ValueError(f"unknown scheduler target {scheduler_config.get('target')!r}")


class MaskedAdamW:
    """AdamW on the model's trainable parameters (`trainable_mask`), which
    must be fp32 (the masters); every other parameter gets
    requires_grad=False. `update()` consumes the trainable parameters'
    .grad."""

    def __init__(self, model: MobiDiffusion, schedule: Schedule, weight_decay: float = 1e-2,
                 accumulate_steps: int = 1):
        mask = model.trainable_mask()
        self.params: List[torch.nn.Parameter] = []
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
            if mask[name]:
                if p.dtype != torch.float32:
                    raise ValueError(f"trainable parameter {name} is {p.dtype}; build the model "
                                     "with for_training=True to keep the trainable set fp32")
                self.params.append(p)
        self.schedule, self.accumulate_steps = schedule, accumulate_steps
        self.count = 0      # updates applied: the schedule's step
        self.mini_step = 0  # calls since the last update
        self._acc: Optional[List[torch.Tensor]] = None
        self.inner = torch.optim.AdamW(self.params, lr=float(schedule(0)), betas=(0.9, 0.999),
                                       eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def update(self) -> bool:
        """One call's gradients in; True when an AdamW update was applied."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        self.zero_grad()
        if self.accumulate_steps > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in self.params]
            for acc, g in zip(self._acc, grads):
                acc.add_(g)
            self.mini_step += 1
            if self.mini_step < self.accumulate_steps:
                return False
            grads = [acc / self.accumulate_steps for acc in self._acc]
            self._acc, self.mini_step = None, 0
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.inner.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.inner.step()
        self.count += 1
        self.zero_grad()
        return True


def make_optimizer(model: MobiDiffusion, base_lr: float = 8.0e-5, warm_up_steps: int = 200,
                   weight_decay: float = 1e-2, accumulate_steps: int = 1,
                   schedule: Optional[Schedule] = None, optimizer: str = "adamw",
                   adam_mu_dtype=None) -> MaskedAdamW:
    """AdamW restricted to the trainable partition, on `schedule` (default:
    LambdaLinear at base_lr with warm_up_steps)."""
    if optimizer == "adafactor" or adam_mu_dtype is not None:
        raise NotImplementedError(
            "optimizer='adafactor' and adam_mu_dtype are not ported yet "
            "(ROADMAP queue 1 item 5); use optimizer='adamw' with fp32 moments")
    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return MaskedAdamW(model, schedule or lambda_linear_schedule(base_lr, warm_up_steps),
                       weight_decay, accumulate_steps)


@dataclasses.dataclass
class TrainState:
    step: int
    model: MobiDiffusion
    opt: MaskedAdamW
    ema: Optional[LitEma]


def _check_device(model: MobiDiffusion, device) -> None:
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"the model is on {model.device}, training asked for {dev}")


def create_train_state(model: MobiDiffusion, base_lr: float = 8.0e-5, use_ema: bool = False,
                       accumulate_steps: int = 1, scheduler_config: Optional[dict] = None,
                       optimizer: str = "adamw", schedule: Optional[Schedule] = None,
                       adam_mu_dtype=None, device=None) -> Tuple[TrainState, MaskedAdamW]:
    """(TrainState, optimizer) for `model`, which holds the starting weights.
    `schedule` overrides `scheduler_config`."""
    _check_device(model, device)
    if schedule is None and scheduler_config:
        schedule = schedule_from_config(base_lr, scheduler_config)
    tx = make_optimizer(model, base_lr, accumulate_steps=accumulate_steps, schedule=schedule,
                        optimizer=optimizer, adam_mu_dtype=adam_mu_dtype)
    ema = LitEma(model.unet) if use_ema else None
    return TrainState(0, model, tx, ema), tx


@contextlib.contextmanager
def params_with_ema(state: TrainState) -> Iterator[MobiDiffusion]:
    """The model with the UNet's EMA weights swapped in for the block and the
    trained weights restored after (the reference's ema_scope); the model as
    it is when no EMA is kept."""
    if state.ema is None:
        yield state.model
        return
    unet = state.model.unet
    saved = {name: p.detach().clone() for name, p in unet.named_parameters()}
    state.ema.copy_to(unet)
    try:
        yield state.model
    finally:
        with torch.no_grad():
            for name, p in unet.named_parameters():
                p.copy_(saved[name])


def global_norm(tensors) -> torch.Tensor:
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors if t is not None]
    return torch.linalg.vector_norm(torch.stack(norms)) if norms else torch.zeros(())


def make_train_step(model: MobiDiffusion, tx: MaskedAdamW,
                    device=None) -> Callable[..., Tuple[TrainState, Dict[str, Any]]]:
    """`train_step(state, batch, generator=None, *, t=None, noise=None,
    drop=None)` -> (state, metrics): the loss metrics of `training_loss` and
    `grad_norm`, the global norm of this call's trainable gradients, as
    device tensors. `t`, `noise` and `drop` pass through to
    `training_loss`. When the state keeps an EMA
    (`create_train_state(use_ema=True)`), it moves toward the UNet at every
    call, after the optimizer, as in the JAX package."""
    _check_device(model, device)

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None, **inject):
        tx.zero_grad()
        loss, metrics = model.training_loss(batch, generator, **inject)
        loss.backward()
        grad_norm = global_norm([p.grad for p in tx.params])
        tx.update()
        if state.ema is not None:
            state.ema.update(model.unet)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        return state, metrics

    return train_step
