"""Export a checkpoint of the port to the reference's Lightning .ckpt
(scripts/export_checkpoint.py of the JAX package):

  python -m mobi_tpu_torch.export_checkpoint --config configs/mobi_nusc_512.yaml \
      --ckpt logs/<run>/checkpoints [--step N] --out exported.ckpt [--no-schedule] [overrides ...]

--ckpt is a checkpoint directory the training CLI wrote (a manager
directory, whose latest step or --step is taken, or a step directory, whose
name is the step), or a Lightning .ckpt (loaded into the config's model and
written again). The file holds {"state_dict", "global_step", "epoch"}: the
model's state dict in fp32 under the reference's names, the EMA shadow as
LitEma's `model_ema.*` buffers (the tracked name without its dots, with
`model_ema.num_updates` and `model_ema.decay`) when the checkpoint keeps one,
and the DDPM schedule buffers unless --no-schedule; convert.load_checkpoint
and convert.extract_ema_state_dict read it back. A .ckpt input is written
without EMA, as the JAX script does; its model is built on the card unless
--platform cpu.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

# the reference's register_schedule buffers (ddpm.py:127-179); lvlb_weights
# is not persistent there, so a reference state dict never holds it
SCHEDULE_BUFFERS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                    "sqrt_recipm1_alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
                    "posterior_mean_coef1", "posterior_mean_coef2")


def _fp32(v: torch.Tensor) -> torch.Tensor:
    v = torch.as_tensor(v).detach().cpu()
    return v.float() if v.is_floating_point() else v


def export_state_dict(model_sd: Dict[str, torch.Tensor], ema_shadow: Optional[Dict[str, torch.Tensor]] = None,
                      ema_num_updates: Optional[int] = None, ema_decay: float = 0.9999,
                      schedule=None) -> Dict[str, torch.Tensor]:
    """The reference's whole state dict: the model's entries in fp32, the
    UNet's EMA shadow (its names relative to the UNet, as LitEma keeps
    them) as `model_ema.*` buffers, and the schedule's buffers."""
    out = {k: _fp32(v) for k, v in model_sd.items()}
    if ema_shadow is not None:
        from mobi_tpu_torch.convert import EMA_PREFIX, UNET_PREFIX, ema_buffer_name

        for k, v in ema_shadow.items():
            out[ema_buffer_name(UNET_PREFIX + k)] = _fp32(v)
        out[EMA_PREFIX + "num_updates"] = torch.tensor(int(ema_num_updates or 0), dtype=torch.int64)
        out[EMA_PREFIX + "decay"] = torch.tensor(ema_decay, dtype=torch.float32)
    if schedule is not None:
        out.update({n: torch.from_numpy(np.asarray(getattr(schedule, n), np.float32)) for n in SCHEDULE_BUFFERS})
    return out


def save_reference_checkpoint(path: str, state_dict: Dict[str, torch.Tensor], global_step: int = 0,
                              epoch: int = 0) -> None:
    """A Lightning-shaped .ckpt (load_model_from_config reads its state_dict)."""
    torch.save({"state_dict": state_dict, "global_step": int(global_step), "epoch": int(epoch)}, path)


def main(argv=None, cond_stage_model: Optional[torch.nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Export; returns the state dict written. `cond_stage_model` replaces
    the default conditioning stage of the model a .ckpt input is loaded
    into (as train.main takes it)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", required=True, help="checkpoint directory of the port (or a step of it), or a .ckpt")
    p.add_argument("--step", type=int, default=None, help="step to export (default: the latest)")
    p.add_argument("--out", required=True, help="output .ckpt path")
    p.add_argument("--no-schedule", action="store_true", help="omit the DDPM schedule buffers")
    p.add_argument("--platform", default=None, choices=["cpu"],
                   help="build a .ckpt input's model on the CPU instead of the CUDA device")
    p.add_argument("overrides", nargs="*")
    opt = p.parse_args(argv)

    from mobi_tpu_torch.ops.schedules import DiffusionSchedule
    from mobi_tpu_torch.utils.config import load_config, mobi_config_from_yaml

    cfg = load_config([opt.config], [s for s in opt.overrides if "=" in s])
    mcfg = mobi_config_from_yaml(cfg)
    ema, ema_updates, step = None, None, 0
    if os.path.isdir(opt.ckpt):
        from mobi_tpu_torch.checkpoint import CheckpointManager, read_step

        ckpt_dir, step = os.path.normpath(opt.ckpt), opt.step
        if os.path.basename(ckpt_dir).isdigit():
            ckpt_dir, step = os.path.dirname(ckpt_dir), int(os.path.basename(ckpt_dir))
        if step is None:
            step = CheckpointManager(ckpt_dir).latest_step() or 0
        got = read_step(os.path.join(ckpt_dir, str(step)), parts=("model", "ema"))
        model_sd = got["model"]
        if got["ema"] is not None:
            ema, ema_updates = got["ema"]["shadow"], got["ema"]["num_updates"]
        print(f"restored checkpoint (step {step}{', with EMA' if ema is not None else ''})")
    else:
        from mobi_tpu_torch import convert
        from mobi_tpu_torch.models.diffusion import MobiDiffusion

        model = MobiDiffusion(mcfg, device="cpu" if opt.platform == "cpu" else None,
                              cond_stage_model=cond_stage_model)
        convert.load_checkpoint(model, opt.ckpt)
        model_sd = model.state_dict()
        print(f"imported torch checkpoint {opt.ckpt}")
    schedule = None if opt.no_schedule else DiffusionSchedule.create(
        timesteps=mcfg.timesteps, beta_schedule=mcfg.beta_schedule, linear_start=mcfg.linear_start,
        linear_end=mcfg.linear_end, parameterization=mcfg.parameterization)
    out_sd = export_state_dict(model_sd, ema, ema_updates, schedule=schedule)
    save_reference_checkpoint(opt.out, out_sd, global_step=step)
    print(f"wrote {opt.out}: {len(out_sd)} state-dict entries "
          f"({sum(v.numel() for v in out_sd.values()) * 4 / 1e6:.1f} MB fp32)")
    return out_sd


if __name__ == "__main__":
    main()
