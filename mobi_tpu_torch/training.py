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
  * adam_mu_dtype (adamw only) stores the first moment in that dtype and
    runs the update math in fp32 (optax adamw(mu_dtype=...)).
  * optimizer="adafactor" is optax.adafactor(lr, multiply_by_parameter_scale=
    False, clipping_threshold=1.0), as the JAX package builds it: the
    factored second moment for parameters with two dims of 128 or more
    (optax's min_dim_size_to_factor), block-RMS clipping at 1, no weight
    decay.

The schedules compute in float32 with the JAX expressions' order of
operations. The train state is mutable: the model holds the parameters and
the optimizer its moments. The entry points run on CUDA unless the caller
passes device="cpu", and the model must live there.

On a mesh (parallel.mesh; `create_train_state(mesh=...)` shards the model
before the optimizer and the EMA exist), each rank steps on its batch rows,
the trainable gradients are averaged over dp x fsdp, the parameters, the
moments and the EMA shadow stay on their fsdp / tp pieces at rest, and the
metrics are the global batch's. Adafactor's factored means and its block
RMS span the sharded dims.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from mobi_tpu_torch.models.diffusion import MobiDiffusion, resolve_device
from mobi_tpu_torch.models.ema import LitEma
from mobi_tpu_torch.parallel.mesh import Mesh, mean_over_batch, model_sharding, shard_params

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


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule: init_value times (1 - alpha) of a half
    cosine over decay_steps plus alpha, constant after."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive decay_steps, got {decay_steps}")

    def schedule(step):
        count = min(f32(step), f32(decay_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * count / f32(decay_steps)))
        return f32(init_value) * ((f32(1) - f32(alpha)) * cos + f32(alpha))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init_value to
    peak_value over warmup_steps, then `cosine_decay_schedule` from
    peak_value to end_value over the rest of decay_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(step):
        if step >= warmup_steps:
            return cosine(step - warmup_steps)
        frac = f32(1) - f32(step) / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

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


class AdamWLowMu(torch.optim.Optimizer):
    """AdamW with the first moment stored in `mu_dtype` (optax adamw with
    mu_dtype): each update reads mu in fp32, runs the moments, the bias
    corrections 1 - b ** count (rounded in float32, as optax computes them)
    and the decoupled weight decay in fp32, and stores the new mu back in
    mu_dtype. With mu_dtype float32 and weight_decay 0 it is optax.adam."""

    def __init__(self, params, lr: float, mu_dtype: torch.dtype, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p].update(count=0, mu=torch.zeros_like(p, dtype=self.mu_dtype),
                                         nu=torch.zeros_like(p, dtype=torch.float32))
            states = [self.state[p] for p in params]
            c = states[0]["count"] + 1
            grads = [p.grad.float() for p in params]
            mu = [st["mu"].float() for st in states]
            nu = [st["nu"] for st in states]
            # one multi-tensor kernel a line, not one kernel a parameter
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(c)) for b in (b1, b2))
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            if group["weight_decay"]:
                torch._foreach_add_(upd, [p.float() for p in params], alpha=group["weight_decay"])
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, [u.to(p.dtype) for u, p in zip(upd, params)])
            torch._foreach_copy_([st["mu"] for st in states], mu)
            for st in states:
                st["count"] = c


class Adafactor(torch.optim.Optimizer):
    """optax.adafactor(learning_rate, multiply_by_parameter_scale=False,
    clipping_threshold=1.0) with optax's other defaults (decay_rate 0.8,
    min_dim_size_to_factor 128, eps 1e-30, no momentum, no weight decay):
    the second moment of a parameter whose two largest dims are both 128 or
    more is factored into row and column means over those two dims, any
    other parameter's is kept whole; the update g / sqrt(v) is clipped to a
    block RMS of `clipping_threshold` and scaled by the learning rate."""

    def __init__(self, params, lr: float, clipping_threshold: float = 1.0, decay_rate: float = 0.8,
                 min_dim_size_to_factor: int = 128, eps: float = 1e-30):
        super().__init__(params, dict(lr=lr))
        self.clipping_threshold, self.decay_rate = clipping_threshold, decay_rate
        self.min_dim, self.eps = min_dim_size_to_factor, eps

    def factored_dims(self, shape) -> Optional[Tuple[int, int]]:
        """(d1, d0): the second-largest and the largest dim, or None."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < self.min_dim:
            return None
        return int(order[-2]), int(order[-1])

    @staticmethod
    def _mean(t: torch.Tensor, p, dims=None, layout=None) -> torch.Tensor:
        """t.mean over `dims` (every dim when None), across the ranks that
        hold the other pieces of a dim `p`'s sharding splits. `layout` is
        t's, when it is not p's."""
        sh = getattr(p, "_mobi_shard", None)
        lay = layout if layout is not None or sh is None else sh[1]
        nd = t.dim()
        if isinstance(dims, int):
            dims = [dims]
        over = list(range(nd)) if dims is None else [d % nd for d in dims]
        if sh is None or not any(lay.spec[d] is not None for d in over):
            return t.mean() if dims is None else t.mean(dim=dims)
        count = int(np.prod([lay.shape[d] for d in over]))
        return sh[0].sum_over(t, lay, over) / count

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                sh = getattr(p, "_mobi_shard", None)
                # the whole parameter's shape decides the factoring
                dims = self.factored_dims(sh[1].shape if sh is not None else tuple(p.shape))
                if not st:
                    st["count"] = 0
                    if dims is None:
                        st["v"] = torch.zeros_like(p, dtype=torch.float32)
                    else:
                        st["v_row"] = torch.zeros_like(p, dtype=torch.float32).mean(dim=dims[1])
                        st["v_col"] = torch.zeros_like(p, dtype=torch.float32).mean(dim=dims[0])
                rate = float(f32(1) - f32(st["count"] + 1) ** f32(-self.decay_rate))
                g = p.grad.float()
                g2 = g * g + self.eps
                if dims is None:
                    st["v"].mul_(rate).add_(g2, alpha=1 - rate)
                    upd = g * st["v"].rsqrt()
                else:
                    d1, d0 = dims
                    st["v_row"].mul_(rate).add_(self._mean(g2, p, d0), alpha=1 - rate)
                    st["v_col"].mul_(rate).add_(self._mean(g2, p, d1), alpha=1 - rate)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_layout = None if sh is None else sh[1].drop(d0)
                    row_mean = self._mean(st["v_row"], p, reduced_d1, row_layout).unsqueeze(reduced_d1)
                    row = (st["v_row"] / row_mean).rsqrt()
                    upd = g * row.unsqueeze(d0) * st["v_col"].rsqrt().unsqueeze(d1)
                st["count"] += 1
                upd = upd / torch.clamp_min(self._mean(upd.pow(2), p).sqrt() / self.clipping_threshold, 1.0)
                p.add_(upd.mul_(-group["lr"]).to(p.dtype))


def make_inner_optimizer(params, optimizer: str = "adamw", lr: float = 0.0, weight_decay: float = 1e-2,
                         adam_mu_dtype=None) -> torch.optim.Optimizer:
    """The optimizer of `make_optimizer` on a list of parameters, its lr to
    be set before each step: torch's AdamW (optax adamw with fp32 moments),
    `AdamWLowMu` with adam_mu_dtype, or `Adafactor`."""
    if optimizer == "adamw":
        if adam_mu_dtype is None:
            return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        return AdamWLowMu(params, lr, adam_mu_dtype, weight_decay=weight_decay)
    if optimizer == "adafactor":
        if adam_mu_dtype is not None:
            raise ValueError("adam_mu_dtype applies to optimizer='adamw' only")
        # the JAX package's warning (mobi_tpu/training.py:203-212), word for word
        warnings.warn(
            "optimizer='adafactor' failed to train the full-UNet "
            "architecture in every recorded run (PROFILE.md optimizer "
            "ledger: stuck at the zero-output basin). Prefer "
            "optimizer='adamw' with adam_mu_dtype=bfloat16 for HBM "
            "savings; proceed with adafactor only deliberately.",
            stacklevel=3,
        )
        return Adafactor(params, lr)
    raise ValueError(f"unknown optimizer {optimizer!r}")


class MaskedAdamW:
    """The optimizer on the model's trainable parameters (`trainable_mask`),
    which must be fp32 (the masters): AdamW by default, with
    `adam_mu_dtype` its first moment in that dtype, or Adafactor
    (`make_inner_optimizer`). Every other parameter gets
    requires_grad=False. `update()` consumes the trainable parameters'
    .grad."""

    def __init__(self, model: MobiDiffusion, schedule: Schedule, weight_decay: float = 1e-2,
                 accumulate_steps: int = 1, optimizer: str = "adamw", adam_mu_dtype=None):
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
        self.inner = make_inner_optimizer(self.params, optimizer, float(schedule(0)), weight_decay,
                                          adam_mu_dtype)

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
    """AdamW (or Adafactor) restricted to the trainable partition, on
    `schedule` (default: LambdaLinear at base_lr with warm_up_steps)."""
    return MaskedAdamW(model, schedule or lambda_linear_schedule(base_lr, warm_up_steps),
                       weight_decay, accumulate_steps, optimizer, adam_mu_dtype)


@torch.no_grad()
def randomize_zero_init(module: torch.nn.Module, seed: int = 0, prefix: str = "") -> List[str]:
    """Replace every >= 2-D parameter of `module` that is all zeros with
    N(0, 0.02) draws from np.random.default_rng(seed), in the order of
    named_parameters, cast to the parameter's dtype; returns the names
    perturbed. The JAX package's knob (train.py:230-251 over the whole
    tree; overfit_oracle.py:286-320 over the UNet only): the reference
    zero-initialises every ResBlock and transformer output conv and the
    final out_conv, which leaves a UNet trained from scratch on a saddle
    (eps == 0 exactly). The caller picks the scope by the module it passes:
    the oracle its UNet, train.py's counterpart the whole model."""
    rng = np.random.default_rng(seed)
    names = []
    for name, p in module.named_parameters(prefix=prefix.rstrip(".")):
        if p.dim() >= 2 and not bool(p.any()):
            p.copy_(torch.from_numpy(rng.normal(0, 0.02, tuple(p.shape)).astype(np.float32)))
            names.append(name)
    return names


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
                       adam_mu_dtype=None, device=None,
                       mesh: Optional[Mesh] = None) -> Tuple[TrainState, MaskedAdamW]:
    """(TrainState, optimizer) for `model`, which holds the starting weights.
    `schedule` overrides `scheduler_config`. With `mesh` the model is
    sharded on it first (parallel.mesh.shard_params; every rank must hold
    the same weights), so the moments and the EMA shadow live on the
    parameters' pieces."""
    _check_device(model, device)
    if mesh is not None:
        shard_params(mesh, model)
    if schedule is None and scheduler_config:
        schedule = schedule_from_config(base_lr, scheduler_config)
    tx = make_optimizer(model, base_lr, accumulate_steps=accumulate_steps, schedule=schedule,
                        optimizer=optimizer, adam_mu_dtype=adam_mu_dtype)
    ema = LitEma(model.unet) if use_ema else None
    return TrainState(0, model, tx, ema), tx


def gathered(model: MobiDiffusion):
    """A context in which a sharded model's parameters are whole on their
    fsdp dim (parallel.mesh.ModelSharding.unsharded), for code that reads
    or writes whole weights (loads); nothing to do for a model that is not
    sharded. Forwards take `blockwise`."""
    sharding = model_sharding(model)
    return contextlib.nullcontext() if sharding is None else sharding.unsharded()


def blockwise(model: MobiDiffusion):
    """A context for forwards of a sharded model outside the train step
    (validation, sampling): one block's parameters whole at a time
    (parallel.mesh.ModelSharding.blockwise); nothing to do for a model that
    is not sharded."""
    sharding = model_sharding(model)
    return contextlib.nullcontext() if sharding is None else sharding.blockwise()


@contextlib.contextmanager
def params_with_ema(state: TrainState) -> Iterator[MobiDiffusion]:
    """The model with the UNet's EMA weights swapped in for the block and the
    trained weights restored after (the reference's ema_scope); the model as
    it is when no EMA is kept. A sharded model's forwards inside gather
    block by block."""
    if state.ema is None:
        with blockwise(state.model):
            yield state.model
        return
    unet = state.model.unet
    saved = {name: p.detach().clone() for name, p in unet.named_parameters()}
    state.ema.copy_to(unet)
    try:
        with blockwise(state.model):
            yield state.model
    finally:
        with torch.no_grad():
            for name, p in unet.named_parameters():
                p.copy_(saved[name])


def global_norm(tensors) -> torch.Tensor:
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors if t is not None]
    return torch.linalg.vector_norm(torch.stack(norms)) if norms else torch.zeros(())


def sharded_global_norm(params: List[torch.nn.Parameter], mesh: Mesh) -> torch.Tensor:
    """The global norm of the gradients of sharded parameters: each piece
    counted once over the mesh (one all-reduce)."""
    sq = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for p in params:
        sharding, layout = p._mobi_shard
        if p.grad is not None and sharding.counted_here(layout):
            sq = sq + torch.linalg.vector_norm(p.grad.float()).square()
    torch.distributed.all_reduce(sq)
    return sq.sqrt()


def make_train_step(model: MobiDiffusion, tx: MaskedAdamW, device=None,
                    mesh: Optional[Mesh] = None) -> Callable[..., Tuple[TrainState, Dict[str, Any]]]:
    """`train_step(state, batch, generator=None, *, t=None, noise=None,
    drop=None)` -> (state, metrics): the loss metrics of `training_loss` and
    `grad_norm`, the global norm of this call's trainable gradients, as
    device tensors. `t`, `noise` and `drop` pass through to
    `training_loss`. When the state keeps an EMA
    (`create_train_state(use_ema=True)`), it moves toward the UNet at every
    call, after the optimizer, as in the JAX package.

    With `mesh` (the state built by `create_train_state(mesh=mesh)`) the
    step is the sharded one: `batch` is this rank's rows (mesh.shard_batch),
    the draws come from the global batch shape in lockstep (`t` and `noise`
    injected at that shape), the forward and backward gather the fsdp
    pieces block by block and reduce-scatter each block's gradients
    (ModelSharding.blockwise), the trainable gradients are then averaged
    over dp x fsdp by one collective a dtype before the optimizer (every
    trainable gradient, zeros where a step leaves one unused, as the CFG
    drop does the unconditional token's, so no rank waits on a gradient
    another never makes), and the metrics are the global batch's on every
    rank."""
    _check_device(model, device)
    if mesh is not None:
        sharding = model_sharding(model)
        if sharding is None or sharding.mesh is not mesh:
            raise ValueError("the model is not sharded on this mesh: build the state with "
                             "create_train_state(..., mesh=mesh)")

        def sharded_step(state: TrainState, batch: Dict[str, Any],
                         generator: Optional[torch.Generator] = None, **inject):
            tx.zero_grad()
            with mesh.batch_shard(), sharding.blockwise():
                loss, metrics = model.training_loss(batch, generator, **inject)
                sharding.backward(loss)
            sharding.reduce_grads_(tx.params)
            grad_norm = sharded_global_norm(tx.params, mesh)
            tx.update()
            if state.ema is not None:
                state.ema.update(model.unet)
            state.step += 1
            metrics = mean_over_batch(mesh, metrics)
            metrics["grad_norm"] = grad_norm
            return state, metrics

        return sharded_step

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None, **inject):
        tx.zero_grad()
        loss, metrics = model.training_loss(batch, generator, **inject)
        if loss.requires_grad:  # the camera-only model's adapter set is one token the loss never reads
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
