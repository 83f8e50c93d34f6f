"""DDIM, PLMS and DDPM sampling (mobi_tpu models/samplers.py) as Python loops
over the step tables, in NCHW.

Classifier-free guidance doubles the batch, unconditional rows first; the 5
conditioning channels (4 inpaint latent + 1 mask) are re-concatenated to the
noisy 4-channel state every step. The per-step scalars are 0-d float32
tensors on the device, so the updates' arithmetic is the JAX package's fp32
arithmetic and the loop never waits on the device.

PLMS runs step 0 as the pseudo improved Euler double evaluation
(`plms_prologue`), then Adams-Bashforth over a 3-deep eps history
(`plms_scan_segment`); the history is an explicit [3, B, 4, h, w] carry, so
the trajectory can be cut into segments at any step (pipeline.py). DDIM with
`encoder_interval > 1` reuses the UNet encoder's cached activations between
key steps ("Faster Diffusion", arXiv 2312.09608; approximate, off by
default). DDPM is the full-length ancestral loop. Random draws come from a
`torch.Generator`, or from `noises` where a caller injects them.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from mobi_tpu_torch.ops.schedules import DiffusionSchedule, SamplerTables

ModelFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
# (x9, t, context, encoder_cache, return_cache) -> eps, or (eps, cache)
CachedModelFn = Callable[..., object]


def _guided_eps(model_fn: ModelFn, x9: torch.Tensor, t: torch.Tensor,
                cond: torch.Tensor, uncond: Optional[torch.Tensor],
                scale: float) -> torch.Tensor:
    if uncond is None or scale == 1.0:
        return model_fn(x9, t, cond)
    eps_all = model_fn(torch.cat([x9, x9]), torch.cat([t, t]), torch.cat([uncond, cond]))
    eps_uncond, eps_cond = eps_all.chunk(2)
    return eps_uncond + scale * (eps_cond - eps_uncond)


def _eval_eps(model_fn: ModelFn, x: torch.Tensor, rest: torch.Tensor, t,
              cond: torch.Tensor, uncond: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    x9 = torch.cat([x, rest], dim=1)
    tb = torch.full((x.shape[0],), int(t), dtype=torch.int32, device=x.device)
    return _guided_eps(model_fn, x9, tb, cond, uncond, scale)


def _ddim_update(x, eps, a_t, a_prev, sqrt_1m_at, sigma, noise):
    """x_{t-1} from the eps prediction (reference ddim.py:200-212)."""
    pred_x0 = (x - sqrt_1m_at * eps) / torch.sqrt(a_t)
    dir_xt = torch.sqrt(1.0 - a_prev - sigma**2) * eps
    return torch.sqrt(a_prev) * pred_x0 + dir_xt + sigma * noise, pred_x0


def _draw(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(x.shape, generator=generator, dtype=x.dtype, device=x.device)


def ddim_scan_segment(
    model_fn: ModelFn,
    x: torch.Tensor,
    cond: torch.Tensor,
    rest: torch.Tensor,
    timesteps: np.ndarray,
    per_step: torch.Tensor,
    uncond: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    eta_is_zero: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """A contiguous run of DDIM steps. `timesteps` ([S] host ints) and
    `per_step` ([S, 4] float32: alpha, alpha_prev, sqrt(1 - alpha), sigma)
    are slices of SamplerTables in sampling order."""
    for t, (a_t, a_prev, sqrt_1m_at, sigma) in zip(timesteps, per_step):
        eps = _eval_eps(model_fn, x, rest, t, cond, uncond, guidance_scale)
        noise = torch.zeros_like(x) if eta_is_zero else _draw(x, generator)
        x, _ = _ddim_update(x, eps, a_t, a_prev, sqrt_1m_at, sigma, noise)
    return x


def ddim_sample(
    model_fn: ModelFn,
    tables: SamplerTables,
    x_T: torch.Tensor,
    cond: torch.Tensor,
    rest: torch.Tensor,
    uncond: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    encoder_interval: int = 1,
    cached_model_fn: Optional[CachedModelFn] = None,
) -> torch.Tensor:
    """The DDIM loop. x_T: [B, 4, h, w] fp32, cond: [B, n_tokens, D],
    rest: [B, 5, h, w]. Returns the final latent [B, 4, h, w].

    `encoder_interval > 1` (with `cached_model_fn`) runs the UNet's input
    and middle blocks only at every `encoder_interval`-th step (step 0
    included) and reuses their cached activations in between, where only the
    decoder runs, with the current timestep and context."""
    per_step = tables.per_step(x_T.device)
    if encoder_interval <= 1 or cached_model_fn is None:
        return ddim_scan_segment(
            model_fn, x_T, cond, rest, tables.timesteps, per_step,
            uncond, guidance_scale, tables.eta_is_zero, generator,
        )
    doubled = uncond is not None and guidance_scale != 1.0

    def eps_and_cache(x, t, cache):
        x9 = torch.cat([x, rest], dim=1)
        if doubled:
            x9, ctx = torch.cat([x9, x9]), torch.cat([uncond, cond])
        else:
            ctx = cond
        tb = torch.full((x9.shape[0],), int(t), dtype=torch.int32, device=x.device)
        if cache is None:
            eps_all, cache = cached_model_fn(x9, tb, ctx, None, True)
        else:
            eps_all = cached_model_fn(x9, tb, ctx, cache, False)
        if doubled:
            eps_u, eps_c = eps_all.chunk(2)
            eps_all = eps_u + guidance_scale * (eps_c - eps_u)
        return eps_all, cache

    x, cache = x_T, None
    for i, (t, (a_t, a_prev, sqrt_1m_at, sigma)) in enumerate(zip(tables.timesteps, per_step)):
        eps, cache = eps_and_cache(x, t, None if i % encoder_interval == 0 else cache)
        noise = torch.zeros_like(x) if tables.eta_is_zero else _draw(x, generator)
        x, _ = _ddim_update(x, eps, a_t, a_prev, sqrt_1m_at, sigma, noise)
    return x


def ddpm_sample(
    model_fn: ModelFn,
    schedule: DiffusionSchedule,
    x_T: torch.Tensor,
    cond: torch.Tensor,
    rest: torch.Tensor,
    uncond: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    clip_denoised: bool = True,
    generator: Optional[torch.Generator] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """Full-length ancestral DDPM sampling over t = T-1 .. 0 (reference
    ddpm.py:253-282 with the q-posterior of :227-251): eps -> x0 estimate
    (optionally clipped) -> posterior mean + sigma_t noise, no noise at t = 0.
    `noises[i]` replaces the draw of step i."""
    dev = x_T.device

    def at(name, t):
        return torch.tensor(getattr(schedule, name)[t], dtype=torch.float32, device=dev)

    x = x_T
    for i, t in enumerate(range(schedule.num_timesteps - 1, -1, -1)):
        eps = _eval_eps(model_fn, x, rest, t, cond, uncond, guidance_scale)
        x_recon = at("sqrt_recip_alphas_cumprod", t) * x - at("sqrt_recipm1_alphas_cumprod", t) * eps
        if clip_denoised:
            x_recon = torch.clamp(x_recon, -1.0, 1.0)
        mean = at("posterior_mean_coef1", t) * x_recon + at("posterior_mean_coef2", t) * x
        noise = noises[i].to(dev, x.dtype) if noises is not None else _draw(x, generator)
        nonzero = 1.0 if t > 0 else 0.0
        x = mean + nonzero * torch.exp(0.5 * at("posterior_log_variance_clipped", t)) * noise
    return x


def ddim_stochastic_encode(tables: SamplerTables, x0: torch.Tensor, t_index: torch.Tensor,
                           noise: torch.Tensor) -> torch.Tensor:
    """Noise x0 to the t_index-th DDIM step (reference ddim.py:215-229).
    `t_index` ([B] ints) indexes the INCREASING-t table (0 = least noisy),
    like the reference's `t`."""
    dev = x0.device
    alphas = torch.as_tensor(tables.alphas[::-1].copy(), device=dev)
    sqrt_om = torch.as_tensor(tables.sqrt_one_minus_alphas[::-1].copy(), device=dev)
    idx = torch.as_tensor(t_index, device=dev).long()
    shape = (x0.shape[0],) + (1,) * (x0.dim() - 1)
    return torch.sqrt(alphas[idx]).reshape(shape) * x0 + sqrt_om[idx].reshape(shape) * noise


def ddim_decode(
    model_fn: ModelFn,
    tables: SamplerTables,
    x_latent: torch.Tensor,
    t_start: int,
    cond: torch.Tensor,
    rest: torch.Tensor,
    uncond: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
) -> torch.Tensor:
    """Deterministic DDIM decode of a stochastically encoded latent: the
    first `t_start` steps of the increasing-t table, largest first, i.e. the
    last `t_start` rows of the sampling-order tables (reference
    ddim.py:231-250)."""
    s = tables.num_steps
    if not 0 < t_start <= s:
        raise ValueError(f"t_start {t_start} out of range 1..{s}")
    per_step = tables.per_step(x_latent.device)[s - t_start:]
    x = x_latent
    for t, (a_t, a_prev, sqrt_1m_at, _) in zip(tables.timesteps[s - t_start:], per_step):
        eps = _eval_eps(model_fn, x, rest, t, cond, uncond, guidance_scale)
        x, _ = _ddim_update(x, eps, a_t, a_prev, sqrt_1m_at, 0.0, 0.0)
    return x


def plms_prologue(
    model_fn: ModelFn,
    tables: SamplerTables,
    x_T: torch.Tensor,
    cond: torch.Tensor,
    rest: torch.Tensor,
    uncond: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PLMS step 0, pseudo improved Euler (plms.py:221-226): eps at t0, a
    provisional DDIM update, a second eps at t1, their mean. Returns (x after
    step 0, eps history [3, ...] = (eps_t0, 0, 0)), the carry
    `plms_scan_segment` continues from."""
    a_t, a_prev, sqrt_1m_at, _ = tables.per_step(x_T.device)[0]

    def update(x, eps):
        return _ddim_update(x, eps, a_t, a_prev, sqrt_1m_at, 0.0, 0.0)[0]

    e_t = _eval_eps(model_fn, x_T, rest, tables.timesteps[0], cond, uncond, guidance_scale)
    x_prev = update(x_T, e_t)
    e_t_next = _eval_eps(model_fn, x_prev, rest, tables.timesteps_next[0], cond, uncond,
                         guidance_scale)
    x = update(x_T, 0.5 * (e_t + e_t_next))
    return x, torch.stack([e_t, torch.zeros_like(e_t), torch.zeros_like(e_t)])


def plms_per_step_tables(tables: SamplerTables, device) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """(timesteps [S-1], per_step [S-1, 4], coeffs [S-1, 4]) for PLMS steps
    1..S-1, sliceable (row i drives step i + 1)."""
    return (tables.timesteps[1:], tables.per_step(device)[1:],
            torch.as_tensor(tables.plms_coeffs, device=device))


def plms_scan_segment(
    model_fn: ModelFn,
    x: torch.Tensor,
    hist: torch.Tensor,
    cond: torch.Tensor,
    rest: torch.Tensor,
    per_step: Tuple[np.ndarray, torch.Tensor, torch.Tensor],
    uncond: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A contiguous run of PLMS multistep updates (steps >= 1): the
    Adams-Bashforth blend of the current eps with up to 3 history entries by
    the coefficient table (plms.py:227-237). `per_step` is a slice of
    `plms_per_step_tables`. Returns (x, hist) to carry on."""
    for t, (a_t, a_prev, sqrt_1m_at, _), c in zip(*per_step):
        eps = _eval_eps(model_fn, x, rest, t, cond, uncond, guidance_scale)
        e_prime = c[0] * eps + c[1] * hist[0] + c[2] * hist[1] + c[3] * hist[2]
        x, _ = _ddim_update(x, e_prime, a_t, a_prev, sqrt_1m_at, 0.0, 0.0)
        hist = torch.stack([eps, hist[0], hist[1]])
    return x, hist


def plms_sample(
    model_fn: ModelFn,
    tables: SamplerTables,
    x_T: torch.Tensor,
    cond: torch.Tensor,
    rest: torch.Tensor,
    uncond: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
) -> torch.Tensor:
    """PLMS (pseudo linear multistep) sampling; eta is always 0:
    `plms_prologue` (step 0), then one `plms_scan_segment` over steps
    1..S-1."""
    x, hist = plms_prologue(model_fn, tables, x_T, cond, rest, uncond, guidance_scale)
    x, _ = plms_scan_segment(model_fn, x, hist, cond, rest,
                             plms_per_step_tables(tables, x_T.device), uncond, guidance_scale)
    return x
