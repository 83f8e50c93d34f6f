"""Diffusion noise schedules and DDIM / PLMS step tables (mobi_tpu
ops/schedules.py).

The schedule math runs on the host in float64 numpy, as in the JAX package;
the DDPM buffers are then rounded to float32, and the sampler tables are
derived from those float32 values upcast to float64 again, exactly as
`mobi_tpu.ops.schedules.SamplerTables.create` reads them, so both packages
hold equal tables.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """Beta schedule in float64."""
    if schedule == "linear":
        betas = (
            np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64)
            ** 2
        )
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        betas = np.clip(betas, 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def make_ddim_timesteps(
    ddim_discr_method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int
) -> np.ndarray:
    """DDIM timestep subset, +1 offset included. The last index is clamped to
    num_ddpm_timesteps - 1, so step counts that do not divide the schedule
    stay in range (the JAX package's deliberate deviation from the
    reference; for divisor counts the grids are identical)."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.arange(0, num_ddpm_timesteps, c)
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(
            f'unknown ddim discretization method "{ddim_discr_method}"'
        )
    return np.minimum(ddim_timesteps + 1, num_ddpm_timesteps - 1)


def make_ddim_sampling_parameters(
    alphacums: np.ndarray, ddim_timesteps: np.ndarray, eta: float
):
    """(sigmas, alphas, alphas_prev) per DDIM step."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def make_plms_coeffs(num_steps: int) -> np.ndarray:
    """Adams-Bashforth blending coefficients, float64 [num_steps - 1, 4]: row
    i - 1 gives (c_cur, c_1, c_2, c_3) for sampling step i >= 1, so that
    eps' = c_cur eps_t + c_1 old[-1] + c_2 old[-2] + c_3 old[-3] with up to 3
    earlier eps (the orders of reference plms.py:221-235). Step 0, the
    pseudo improved Euler step, has no row."""
    rows = []
    for i in range(1, num_steps):
        n_old = min(i, 3)
        if n_old == 1:
            rows.append((3 / 2, -1 / 2, 0.0, 0.0))
        elif n_old == 2:
            rows.append((23 / 12, -16 / 12, 5 / 12, 0.0))
        else:
            rows.append((55 / 24, -59 / 24, 37 / 24, -9 / 24))
    return np.asarray(rows, dtype=np.float64).reshape(-1, 4)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM buffers as float32 numpy arrays on the host."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    num_timesteps: int
    linear_start: float
    linear_end: float

    @classmethod
    def create(
        cls,
        timesteps: int = 1000,
        beta_schedule: str = "linear",
        linear_start: float = 1e-4,
        linear_end: float = 2e-2,
        cosine_s: float = 8e-3,
        given_betas: Optional[np.ndarray] = None,
        v_posterior: float = 0.0,
        parameterization: str = "eps",
    ) -> "DiffusionSchedule":
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(
                beta_schedule, timesteps, linear_start=linear_start,
                linear_end=linear_end, cosine_s=cosine_s,
            )
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])

        posterior_variance = (1 - v_posterior) * betas * (
            1.0 - alphas_cumprod_prev
        ) / (1.0 - alphas_cumprod) + v_posterior * betas

        if parameterization == "eps":
            # posterior_variance[0] == 0; the inf at index 0 is replaced below
            with np.errstate(divide="ignore"):
                lvlb_weights = betas**2 / (
                    2 * posterior_variance * alphas * (1 - alphas_cumprod)
                )
        elif parameterization == "x0":
            lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
        else:
            raise NotImplementedError(parameterization)
        lvlb_weights = lvlb_weights.copy()
        lvlb_weights[0] = lvlb_weights[1]

        def f(x):
            return np.asarray(x, dtype=np.float32)

        return cls(
            betas=f(betas),
            alphas_cumprod=f(alphas_cumprod),
            alphas_cumprod_prev=f(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=f(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=f(posterior_variance),
            posterior_log_variance_clipped=f(
                np.log(np.maximum(posterior_variance, 1e-20))
            ),
            posterior_mean_coef1=f(
                betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
            ),
            posterior_mean_coef2=f(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            lvlb_weights=f(lvlb_weights),
            num_timesteps=int(timesteps),
            linear_start=linear_start,
            linear_end=linear_end,
        )

    def table(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Buffer `name` gathered at integer timesteps t, float32 on t's device."""
        return torch.as_tensor(getattr(self, name), device=t.device)[t]

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Forward-noise x_start ([B, ...]) to steps t ([B])."""
        shape = (t.shape[0],) + (1,) * (x_start.dim() - 1)
        a = self.table("sqrt_alphas_cumprod", t).reshape(shape)
        s = self.table("sqrt_one_minus_alphas_cumprod", t).reshape(shape)
        return a * x_start + s * noise


@dataclasses.dataclass(frozen=True)
class SamplerTables:
    """Per-step DDIM / PLMS tables in sampling order (index 0 is the largest
    t).

    `timesteps` and `timesteps_next` (the t of the following step, the last
    repeated; PLMS step 0 evaluates there) are int32, the value tables
    float32 and `plms_coeffs` float32 [S - 1, 4], all numpy on the host;
    `per_step(device)` gives the value tables as float32 tensors for the
    loop."""

    timesteps: np.ndarray
    timesteps_next: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray
    plms_coeffs: np.ndarray
    num_steps: int
    eta_is_zero: bool = True

    @classmethod
    def create(
        cls,
        schedule: DiffusionSchedule,
        num_steps: int,
        discretize: str = "uniform",
        eta: float = 0.0,
    ) -> "SamplerTables":
        ddim_ts = make_ddim_timesteps(discretize, num_steps, schedule.num_timesteps)
        alphacums = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            alphacums, ddim_ts, eta
        )
        order = slice(None, None, -1)

        def f(x):
            return np.ascontiguousarray(x[order], dtype=np.float32)

        ts = np.ascontiguousarray(ddim_ts[order], dtype=np.int32)
        return cls(
            timesteps=ts,
            timesteps_next=np.concatenate([ts[1:], ts[-1:]]),
            alphas=f(alphas),
            alphas_prev=f(alphas_prev),
            sqrt_one_minus_alphas=f(np.sqrt(1.0 - alphas)),
            sigmas=f(sigmas),
            plms_coeffs=make_plms_coeffs(len(ddim_ts)).astype(np.float32),
            num_steps=len(ddim_ts),
            eta_is_zero=(eta == 0.0),
        )

    def per_step(self, device) -> torch.Tensor:
        """[S, 4] float32 (alpha, alpha_prev, sqrt(1 - alpha), sigma)."""
        rows = np.stack(
            [self.alphas, self.alphas_prev, self.sqrt_one_minus_alphas, self.sigmas],
            axis=1,
        )
        return torch.as_tensor(rows, dtype=torch.float32, device=device)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal timestep embedding, cos then sin, float32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb
