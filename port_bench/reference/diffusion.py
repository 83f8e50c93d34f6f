"""MObI's latent diffusion around the networks, plain float32: the DDPM
schedule and the DDIM tables, the encodes of each modality's (GT, inpaint,
mask) triplet, the lidar latent's crop to the camera's size, DDIM with
classifier-free guidance, the decodes with the lidar latent pasted back,
the eps-MSE training loss with whole-batch CFG dropout, and AdamW.

Batches use the dataset schema, NHWC: `image` {GT, inpaint_image,
inpaint_mask, cond: {ref_image, ref_bbox}} and, with lidar, `lidar`
{range_data, range_data_inpaint, range_mask, cond: {ref_bbox}}. The lidar
rows condition on the camera's reference image. Rows are interleaved
[cam0, lid0, cam1, lid1, ...].
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from port_bench.reference import cond as C
from port_bench.reference.nn import Params
from port_bench.reference.unet import unet
from port_bench.reference.vae import decode, encode


def alphas_cumprod(arch: Mapping) -> np.ndarray:
    """The linear schedule's cumulative alphas, computed in float64 and
    rounded to float32, as LDM keeps its buffers."""
    betas = np.linspace(arch["linear_start"] ** 0.5, arch["linear_end"] ** 0.5, arch["timesteps"],
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def ddim_tables(arch: Mapping, num_steps: int):
    """(timesteps, alpha_t, alpha_prev) in sampling order, eta 0: uniform
    steps of T // S from 1, clamped to T - 1."""
    T = arch["timesteps"]
    ts = np.minimum(np.arange(0, T, T // num_steps) + 1, T - 1)
    ac = alphas_cumprod(arch).astype(np.float64)
    a = ac[ts]
    a_prev = np.asarray([ac[0]] + ac[ts[:-1]].tolist())
    return ts[::-1].copy(), a[::-1].astype(np.float32), a_prev[::-1].astype(np.float32)


def interleave(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    s = torch.stack(list(xs), dim=1)
    return s.reshape((-1,) + tuple(s.shape[2:]))


def _posterior(P, stage, x_nhwc, scale, noise):
    mean, logvar = encode(P, stage, x_nhwc.permute(0, 3, 1, 2))
    z = mean if noise is None else mean + torch.exp(0.5 * logvar) * noise
    return (scale * z).permute(0, 2, 3, 1)


def _triplet(P, stage, gt, inpaint, mask, scale, noises):
    z = _posterior(P, stage, gt, scale, noises[0])
    z_in = _posterior(P, stage, inpaint, scale, noises[1])
    h, w = z.shape[1], z.shape[2]
    ridx = torch.arange(h, device=mask.device) * mask.shape[1] // h
    cidx = torch.arange(w, device=mask.device) * mask.shape[2] // w
    return torch.cat([z, z_in, mask[:, ridx][:, :, cidx]], dim=-1)


def latents(P: Params, arch: Mapping, batch: Mapping, noises: Optional[List] = None) -> Dict:
    """The interleaved 9-channel latents `z` [rows, h, w, 9], the raw
    conditioning of each row, and the lidar geometry. `noises` (None: the
    posterior means) gives the posterior draws in the program's order:
    camera GT, camera inpaint, lidar GT, lidar inpaint, NCHW."""
    noises = noises or [None] * 4
    size = arch["latent_size"]
    zs, conds, out = [], [], {}
    if arch["use_camera"]:
        img = batch["image"]
        zs.append(_triplet(P, "first_stage_model", img["GT"], img["inpaint_image"], img["inpaint_mask"],
                           arch["scale_factor"], noises[0:2]))
        conds.append(dict(img["cond"]))
    if arch["use_lidar"]:
        lid = batch["lidar"]
        zl = _triplet(P, "lidar_stage_model", lid["range_data"], lid["range_data_inpaint"], lid["range_mask"],
                      arch["lidar_scale_factor"], noises[2:4])
        H, W = zl.shape[1], zl.shape[2]
        left, pad = W // 2 - size // 2, (size - H) // 2
        z = zl[:, :, left:W // 2 + size // 2, :]
        z = torch.nn.functional.pad(z, (0, 0, 0, 0, pad, size - H - pad)) if pad >= 0 else z[:, -pad:-pad + size]
        lc = {"ref_image": batch["image"]["cond"]["ref_image"]}
        if "ref_bbox" in lid["cond"]:
            bbox = lid["cond"]["ref_bbox"].clone()
            bbox[..., 0] = (bbox[..., 0] * W - left) / size
            bbox[..., 1] = bbox[..., 1] + pad / size
            lc["ref_bbox"] = bbox
        zs.append(z)
        conds.append(lc)
        out["z_lidar_full"] = zl[..., :4]
        out["geom"] = (H, left)
    out["z"] = interleave(zs) if len(zs) > 1 else zs[0]
    out["cond"] = {k: interleave([c[k] for c in conds]) if len(conds) > 1 else conds[0][k] for k in conds[0]}
    return out


def ddim_sample(P: Params, arch: Mapping, data: Mapping, x_T_nchw: torch.Tensor, num_steps: int,
                guidance: float) -> torch.Tensor:
    """DDIM (eta 0) with classifier-free guidance, the unconditional rows
    first in the doubled batch. Returns the latents NHWC."""
    z = data["z"].permute(0, 3, 1, 2)
    rest = z[:, 4:]
    ctx = C.context(P, arch, data["cond"])
    unc = C.uncond(P, arch, z.shape[0])
    x = x_T_nchw
    ts, a_t, a_prev = ddim_tables(arch, num_steps)
    for t, at, ap in zip(ts, a_t, a_prev):
        x9 = torch.cat([x, rest], dim=1)
        tb = torch.full((2 * x.shape[0],), int(t), dtype=torch.int64, device=x.device)
        eps_u, eps_c = unet(P, arch, torch.cat([x9, x9]), tb, torch.cat([unc, ctx])).chunk(2)
        eps = eps_u + guidance * (eps_c - eps_u)
        at, ap = float(at), float(ap)
        pred_x0 = (x - math.sqrt(1.0 - at) * eps) / math.sqrt(at)
        x = math.sqrt(ap) * pred_x0 + math.sqrt(1.0 - ap) * eps
    return x.permute(0, 2, 3, 1)


def decode_outputs(P: Params, arch: Mapping, sample_nhwc: torch.Tensor, data: Mapping) -> Dict[str, torch.Tensor]:
    """Latents -> {"camera": [B, H, W, 3], "lidar": [B, H, W, 2]} in [-1, 1]."""
    multimodal = arch["use_camera"] and arch["use_lidar"]
    if multimodal:
        pair = sample_nhwc.reshape((-1, 2) + tuple(sample_nhwc.shape[1:]))
        h_cam, h_lid = pair[:, 0], pair[:, 1]
    else:
        h_cam, h_lid = (sample_nhwc, None) if arch["use_camera"] else (None, sample_nhwc)
    out = {}
    if h_lid is not None and "geom" in data:
        H, left = data["geom"]
        bottom = (h_lid.shape[1] - H) // 2
        crop = h_lid[:, bottom:bottom + H]
        full = data["z_lidar_full"]
        if full.shape[2] != h_lid.shape[2]:
            h_lid = full.clone()
            h_lid[:, :, left:left + crop.shape[2]] = crop
        else:
            h_lid = crop
    if h_cam is not None:
        dec = decode(P, "first_stage_model", (h_cam / arch["scale_factor"]).permute(0, 3, 1, 2))
        out["camera"] = dec.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
    if h_lid is not None:
        dec = decode(P, "lidar_stage_model", (h_lid / arch["lidar_scale_factor"]).permute(0, 3, 1, 2))
        out["lidar"] = dec.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
    return out


@torch.no_grad()
def inpaint(P: Params, arch: Mapping, batch: Mapping, x_T_nhwc: torch.Tensor, num_steps: int,
            guidance: float) -> Dict[str, torch.Tensor]:
    """The whole pipeline on a batch with the posterior means: conditioning,
    encodes, DDIM with CFG from x_T ([rows, h, w, 4] NHWC), decodes."""
    data = latents(P, arch, batch)
    x = ddim_sample(P, arch, data, x_T_nhwc.permute(0, 3, 1, 2), num_steps, guidance)
    return decode_outputs(P, arch, x, data)


def training_loss(P: Params, arch: Mapping, batch: Mapping, t: torch.Tensor, noise_nhwc: torch.Tensor,
                  drop: bool, posterior_noises: List[torch.Tensor]) -> torch.Tensor:
    """The eps-MSE of one step over the batch's rows: the latents from
    posterior samples (no gradient), the conditioning (the unconditional
    tokens when `drop`), the noised latents at t, the UNet, the mean over
    rows of each row's mean squared error."""
    with torch.no_grad():
        data = latents(P, arch, batch, posterior_noises)
    z = data["z"]
    ctx = C.uncond(P, arch, z.shape[0]) if drop else C.context(P, arch, data["cond"])
    ac = torch.as_tensor(alphas_cumprod(arch), device=z.device)
    a = torch.sqrt(ac[t]).reshape(-1, 1, 1, 1)
    s = torch.sqrt(1.0 - ac[t]).reshape(-1, 1, 1, 1)
    x_noisy = a * z[..., :4] + s * noise_nhwc
    x9 = torch.cat([x_noisy, z[..., 4:]], dim=-1).permute(0, 3, 1, 2)
    eps = unet(P, arch, x9, t, ctx).permute(0, 2, 3, 1)
    return (eps - noise_nhwc).square().mean(dim=(1, 2, 3)).mean()


def lambda_linear_lr(base_lr: float, warm_up_steps: int, step: int, f_start: float = 1e-6) -> float:
    """LDM's LambdaLinearScheduler during warm-up, in float32 as optax reads it."""
    f32 = np.float32
    warm = f32(f_start) + f32(1.0 - f_start) * f32(step) / f32(max(warm_up_steps, 1))
    return float(f32(base_lr) * (warm if step < warm_up_steps else f32(1.0)))


@torch.no_grad()
def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict, lr: float,
               weight_decay: float = 1e-2, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW update in place (decoupled decay first, then the bias-
    corrected moments), as torch.optim.AdamW."""
    state["step"] = step = state.get("step", 0) + 1
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for name, p in params.items():
        g = grads[name]
        m = state.setdefault(("m", name), torch.zeros_like(p))
        v = state.setdefault(("v", name), torch.zeros_like(p))
        p.mul_(1 - lr * weight_decay)
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.addcdiv_(m, v.sqrt() / math.sqrt(bc2) + eps, value=-lr / bc1)


ADAPTER_SUBSTRINGS = ("cond_adapter", "lidar", "cross_modal")


def trainable(name: str) -> bool:
    """MObI's adapter-only rule: the UNet's adapter layers, the bbox
    embedder and the unconditional bbox token train; all else is frozen."""
    unet_prefix = "model.diffusion_model."
    if name.startswith(unet_prefix):
        return any(s in name[len(unet_prefix):] for s in ADAPTER_SUBSTRINGS)
    if name.startswith("cond_stage_model."):
        return "bbox_embedder" in name
    return name == "bbox_uncond_vector"
