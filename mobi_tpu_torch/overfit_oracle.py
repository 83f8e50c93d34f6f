"""Overfit learning oracle (mobi_tpu overfit_oracle.py): proof that train ->
sample learns to inpaint.

The reference proves its product with a realism bench against published
checkpoints, which cannot run without them. This harness needs no file from
outside the repository:

  1. make a fixed small set of synthetic objects (`make_object_set`:
     distinct textures in a known box, camera and lidar, the object itself
     as the reference crop);
  2. overfit both VAEs on its frames (`overfit_vaes`);
  3. overfit the whole UNet on the same set (`overfit_diffusion`,
     MOBI_TRAIN_UNET_FULL for the call);
  4. sample inpaints of the same objects through the production pipeline
     and score the masked region against the ground truth
     (`sample_and_score`): the inpaint must beat the do-nothing baseline
     (the blanked hole) by a margin.

The port's model is mutable: the phases train it in place. What they train
must be fp32 masters, as the JAX package's parameters always are: build the
model with `oracle_model` (for_training=True, the UNet and both VAEs kept
fp32 under a bf16 compute dtype). Every random draw comes from an explicit
torch.Generator, and the minibatches from np.random.default_rng, so a run
is reproducible from its seeds; the scoring functions take `x_T` to pin the
initial noise. Used by mobi_tpu_torch/overfit_oracle_drive.py (the card at
mini-256), chip_smoke.py (its `oracle` phase) and tests/test_torch_oracle.py.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mobi_tpu_torch import training as T
from mobi_tpu_torch.models.diffusion import UNET_PREFIX, MobiConfig, MobiDiffusion, _to_device
from mobi_tpu_torch.ops.distributions import DiagonalGaussian

Batch = Dict[str, Any]

# What the oracle trains, kept fp32 (the masters) under a bf16 compute dtype.
FP32_PREFIXES = (UNET_PREFIX, "first_stage_model.", "lidar_stage_model.")


def oracle_model(config: MobiConfig, device=None, seed: int = 0, cond_stage_model=None) -> MobiDiffusion:
    """A model the oracle can train from scratch, as the JAX package's:
    for_training=True, the UNet and both VAEs fp32 whatever the compute
    dtype, and the UNet layers the reference zero-initialises at zero (the
    port's seeded weights fill them, which suits the inference checks but
    not training from scratch: a UNet with every residual branch open
    overfits the loss yet samples far off its latents)."""
    model = MobiDiffusion(config, device=device, seed=seed, cond_stage_model=cond_stage_model,
                          for_training=True)
    # fp32 masters: the build held what is frozen at that moment in the
    # compute dtype; seeded values lose nothing that matters to its rounding
    for name, p in model.named_parameters():
        if name.startswith(FP32_PREFIXES):
            p.data = p.data.float()
    model.zero_init_reference_layers_()
    return model


# ----------------------------------------------------------------- dataset
def make_object_set(
    n_objects: int = 4,
    h: int = 32,
    w: int = 32,
    box: Tuple[int, int, int, int] | None = None,
    seed: int = 0,
    ref_hw: Tuple[int, int] | None = None,
) -> Dict[str, Any]:
    """A fixed batch of `n_objects` synthetic inpainting problems, the same
    arrays as the JAX package's (numpy, NHWC).

    Each sample: a smooth background with a distinct blocky texture
    ("object") inside a fixed box; inpaint_mask is 0 inside the box
    (inpaint_image = GT * mask, the hole to fill); the reference crop is the
    object patch itself resized to ref_hw (the frame by default) by
    nearest-neighbour indexing; ref_bbox is the box's 8 corners with the
    object's depth. Lidar range_data carries the same kind of texture in
    (depth, intensity) channels, so the joint model must fill both.
    """
    rng = np.random.default_rng(seed)
    if box is None:
        q_h, q_w = h // 4, w // 4
        box = (q_h, 3 * q_h, q_w, 3 * q_w)  # (y0, y1, x0, x1), centred
    y0, y1, x0, x1 = box
    f32 = np.float32

    def blocky(shape, cells=4):
        """A texture of random cells upsampled to shape."""
        small = rng.uniform(-1, 1, (cells, cells, shape[-1])).astype(f32)
        reps = (shape[0] // cells, shape[1] // cells)
        return np.repeat(np.repeat(small, reps[0], 0), reps[1], 1)

    gts, masks, refs, bboxes, gts_l, masks_l = [], [], [], [], [], []
    for i in range(n_objects):
        yy, xx = np.mgrid[0:h, 0:w].astype(f32)
        bg = np.stack(
            [
                0.4 * np.sin(2 * np.pi * (xx / w + i / n_objects)),
                0.4 * np.cos(2 * np.pi * yy / h),
                np.full((h, w), -0.2 + 0.1 * i, f32),
            ],
            axis=-1,
        ).astype(f32)
        gt = bg.copy()
        obj = blocky((y1 - y0, x1 - x0, 3))
        gt[y0:y1, x0:x1] = obj
        mask = np.ones((h, w, 1), f32)
        mask[y0:y1, x0:x1] = 0.0

        rh, rw = ref_hw or (h, w)
        ry = np.clip((np.arange(rh) * (y1 - y0)) // rh, 0, y1 - y0 - 1)
        rx = np.clip((np.arange(rw) * (x1 - x0)) // rw, 0, x1 - x0 - 1)
        refs.append(obj[np.ix_(ry, rx)])

        depth = 0.3 + 0.1 * i
        # 8 corners: the front face duplicated as the back face at equal depth
        bboxes.append(np.array([[x / w, y / h, depth] for y in (y0, y1) for x in (x0, x1)] * 2, f32))

        gt_l = np.stack([0.3 * np.sin(2 * np.pi * xx / w), np.full((h, w), -0.5, f32)], axis=-1).astype(f32)
        gt_l[y0:y1, x0:x1] = blocky((y1 - y0, x1 - x0, 2))
        gts.append(gt)
        masks.append(mask)
        gts_l.append(gt_l)
        masks_l.append(mask.copy())

    gt, mask, gt_l, mask_l = np.stack(gts), np.stack(masks), np.stack(gts_l), np.stack(masks_l)
    bbox = np.stack(bboxes)
    return {
        "image": {"GT": gt, "inpaint_image": gt * mask, "inpaint_mask": mask,
                  "cond": {"ref_image": np.stack(refs), "ref_bbox": bbox}},
        "lidar": {"range_data": gt_l, "range_data_inpaint": gt_l * mask_l, "range_mask": mask_l,
                  "cond": {"ref_bbox": bbox.copy()}},
    }


def _nchw(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device).permute(0, 3, 1, 2)


def _nhwc_numpy(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().cpu().numpy()


# ------------------------------------------------------------- VAE overfit
def vae_loss(vae, x: torch.Tensor, kl_weight: float = 1e-4, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L1 + kl_weight * KL / numel, L1) of one VAE round trip through a
    posterior sample (mobi_tpu overfit_oracle.py:192-198): x NCHW in [-1, 1],
    the sample mean + std * noise with `noise` given or drawn from
    `generator`; the KL of each sample averaged over the batch and divided by
    one sample's element count. The losses are fp32."""
    post = vae.encode(x)
    if noise is None:
        noise = torch.randn(post.mean.shape, generator=generator, dtype=post.mean.dtype, device=x.device)
    rec = vae.decode(post.mean + post.std * noise)
    l1 = (rec.float() - x.float()).abs().mean()
    kl = DiagonalGaussian(post.mean.float(), post.logvar.float()).kl().mean() / float(np.prod(x.shape[1:]))
    return l1 + kl_weight * kl, l1


def _require_fp32(named_params, what: str) -> None:
    bad = [name for name, p in named_params if p.dtype != torch.float32]
    if bad:
        raise ValueError(f"{what}: {bad[0]} (and {len(bad) - 1} more) are not fp32; build the model with "
                         "overfit_oracle.oracle_model to keep fp32 masters of what the oracle trains")


def overfit_vaes(
    model: MobiDiffusion,
    batch: Batch,
    steps: int = 400,
    lr: float = 1.5e-3,
    kl_weight: float = 1e-4,
    seed: int = 0,
    log_every: int = 0,
    minibatch: int = 0,
) -> Dict[str, float]:
    """Overfit the camera and the lidar VAE (in place) on the object set's
    frames, GT and inpaint views, with L1 + a small KL (`vae_loss`): Adam on
    a cosine decay to 0.05 of `lr` (optax.adam(cosine_decay_schedule(lr,
    steps, alpha=0.05))). Returns each VAE's last recon L1, as
    {"vae_camera": .., "vae_lidar": ..}.

    minibatch > 0 trains on `minibatch` frames a step, chosen on the host by
    np.random.default_rng(seed) without replacement; the posterior draws
    come from a torch.Generator seeded with `seed`, on the model's device."""
    jobs = [
        ("vae_camera", "first_stage_model",
         np.concatenate([batch["image"]["GT"], batch["image"]["inpaint_image"]])),
        ("vae_lidar", "lidar_stage_model",
         np.concatenate([batch["lidar"]["range_data"], batch["lidar"]["range_data_inpaint"]])),
    ]
    finals: Dict[str, float] = {}
    for name, attr, x_np in jobs:
        vae = getattr(model, attr)
        _require_fp32(vae.named_parameters(prefix=attr), "overfit_vaes")
        params = list(vae.parameters())
        was = [p.requires_grad for p in params]
        for p in params:
            p.requires_grad_(True)
        n = x_np.shape[0]
        mb = min(minibatch, n) if minibatch else n
        # cosine tail: the VAE round trip is the PSNR ceiling of the whole
        # oracle, so converging it matters 1:1 for the gate margin
        schedule = T.cosine_decay_schedule(lr, max(steps, 1), alpha=0.05)
        opt = torch.optim.Adam(params, lr=float(schedule(0)), betas=(0.9, 0.999), eps=1e-8)
        gen = torch.Generator(device=model.device).manual_seed(seed)
        sel = np.random.default_rng(seed)
        full = _nchw(x_np, model.device) if mb == n else None
        l1 = torch.full((), float("nan"))
        for i in range(steps):
            x = full if mb == n else _nchw(x_np[sel.choice(n, size=mb, replace=False)], model.device)
            loss, l1 = vae_loss(vae, x, kl_weight, generator=gen)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            for group in opt.param_groups:
                group["lr"] = float(schedule(i))
            opt.step()
            if log_every and (i + 1) % log_every == 0:
                print(f"  [{name}] step {i + 1}: recon L1 {float(l1.detach()):.4f}", flush=True)
        finals[name] = float(l1.detach())
        for p, w in zip(params, was):
            p.grad = None
            p.requires_grad_(w)
        del opt
        if model.device.type == "cuda":
            torch.cuda.empty_cache()
    return finals


# -------------------------------------------------------- diffusion overfit
def overfit_diffusion(
    model: MobiDiffusion,
    batch: Batch,
    steps: int = 600,
    lr: float = 3e-4,
    seed: int = 0,
    log_every: int = 0,
    train_step=None,
    state=None,
    optimizer: str = "adamw",
    cosine_decay: bool = False,
    randomize_zero_init: bool = False,
    adam_mu_dtype=None,
    on_step: Optional[Callable[[int, Dict[str, torch.Tensor]], None]] = None,
) -> Tuple[T.TrainState, Dict[str, Any]]:
    """Overfit the whole UNet (in place) on the object set, with
    MOBI_TRAIN_UNET_FULL=1 for the call and its previous value restored
    after: from random weights the adapters alone cannot learn it. Pass
    (train_step, state) to reuse a caller's; otherwise the state is built
    here with `optimizer` ("adamw" or "adafactor"), `adam_mu_dtype`, and
    with `cosine_decay` optax's warmup_cosine_decay_schedule(0, lr,
    min(200, steps // 4), steps, lr / 20) (else the trainer's default
    LambdaLinear with 200 warm-up steps). `randomize_zero_init` perturbs the
    UNet's all-zero >= 2-D parameters first (training.randomize_zero_init,
    seeded by `seed`). The steps draw from a torch.Generator seeded with
    seed + 1. `on_step(i, metrics)` is called after each step with its
    device metrics. Returns (the train state, {"final_loss": the last
    step's loss, "losses": every step's loss, "zero_init_perturbed": the
    names perturbed}).

    With log_every, every log_every steps prints the step's loss and the
    window mean (the per-step loss swings with the sampled timestep; the
    mean is the signal), split into camera and lidar."""
    if state is not None and (optimizer != "adamw" or cosine_decay or randomize_zero_init
                              or adam_mu_dtype is not None):
        # the caller's (train_step, state) already holds its own optimizer;
        # ignoring these would train something other than the call reads
        raise ValueError(
            "optimizer/cosine_decay/randomize_zero_init/adam_mu_dtype "
            "require overfit_diffusion to build the train state itself — "
            "do not combine them with a caller-provided `state`"
        )
    perturbed: List[str] = []
    if randomize_zero_init:
        # only the UNet: the zero-initialised convs all live there, and the
        # frozen parts are never mutated
        perturbed = T.randomize_zero_init(model.unet, seed, prefix=UNET_PREFIX)

    prev = os.environ.get("MOBI_TRAIN_UNET_FULL")
    os.environ["MOBI_TRAIN_UNET_FULL"] = "1"
    try:
        if state is None:
            _require_fp32([(n, p) for n, p in model.named_parameters() if n.startswith(UNET_PREFIX)],
                          "overfit_diffusion")
            schedule = (T.warmup_cosine_decay_schedule(0.0, lr, min(200, steps // 4), steps, lr / 20.0)
                        if cosine_decay else None)
            state, tx = T.create_train_state(model, base_lr=lr, optimizer=optimizer, schedule=schedule,
                                             adam_mu_dtype=adam_mu_dtype, device=model.device)
            train_step = T.make_train_step(model, tx, device=model.device)
        gen = torch.Generator(device=model.device).manual_seed(seed + 1)
        dev_batch = _to_device(batch, model.device)
        losses: List[torch.Tensor] = []
        window: List[Dict[str, torch.Tensor]] = []
        per_mod = model.config.multimodal
        for i in range(steps):
            state, metrics = train_step(state, dev_batch, gen)
            losses.append(metrics["loss"])
            window.append(metrics)
            if on_step is not None:
                on_step(i, metrics)
            if log_every and (i + 1) % log_every == 0:
                mean = float(torch.stack([m["loss"] for m in window]).mean())
                split = ""
                if per_mod and "loss_camera" in window[-1]:
                    c = float(torch.stack([m["loss_camera"] for m in window]).mean())
                    lid = float(torch.stack([m["loss_lidar"] for m in window]).mean())
                    split = f" cam {c:.4f} lid {lid:.4f}"
                print(f"  [diffusion] step {i + 1}: loss {float(metrics['loss']):.4f} "
                      f"(mean{len(window)} {mean:.4f}{split})", flush=True)
                window = []
        history = torch.stack(losses).float().cpu().tolist() if losses else []
    finally:
        if prev is None:
            os.environ.pop("MOBI_TRAIN_UNET_FULL", None)
        else:
            os.environ["MOBI_TRAIN_UNET_FULL"] = prev
    return state, {"final_loss": history[-1] if history else float("nan"), "losses": history,
                   "zero_init_perturbed": perturbed}


# ------------------------------------------------------------- diagnostics
@torch.no_grad()
def latent_stats(model: MobiDiffusion, batch: Batch) -> Dict[str, float]:
    """Per-modality statistics of the scaled GT latents the diffusion model
    trains on (z = scale_factor * encode(GT).mode()): a modality whose
    latents are far from unit std mismatches the N(0, 1) prior the sampler
    starts from."""
    cfg = model.config
    z_c = (cfg.scale_factor * model.first_stage_model.encode(
        _nchw(batch["image"]["GT"], model.device)).mode()).float().cpu().numpy()
    z_l = (cfg.lidar_scale_factor * model.lidar_stage_model.encode(
        _nchw(batch["lidar"]["range_data"], model.device)).mode()).float().cpu().numpy()
    return {
        "camera_z_std": float(z_c.std()), "camera_z_mean": float(z_c.mean()),
        "camera_z_absmax": float(np.abs(z_c).max()),
        "lidar_z_std": float(z_l.std()), "lidar_z_mean": float(z_l.mean()),
        "lidar_z_absmax": float(np.abs(z_l).max()),
    }


@torch.no_grad()
def sample_latent_mse(
    model: MobiDiffusion,
    batch: Batch,
    num_steps: int = 20,
    seed: int = 7,
    guidance_scale: float = 1.0,
    sampler: str = "ddim",
    x_T: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
    """Latent-space error of the sampler per modality: the MSE between the
    sampled latents and the mode-encoded GT latents, and the same over the
    GT latents' variance (a decoder-independent SNR). A large lidar value
    says the diffusion model misses the lidar latents; a small one beside a
    poor pixel PSNR says the lidar decoder amplifies small latent errors.
    The draws come from a generator seeded with `seed`; `x_T` pins the
    initial noise."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    data = model.get_input(batch, gen, encode_cond=True, deterministic=True)
    lat = model.sample(data, gen, num_steps=num_steps, guidance_scale=guidance_scale, sampler=sampler,
                       x_T=x_T)
    lat = lat.double().cpu().numpy()
    z_gt = data["z"][..., :4].double().cpu().numpy()
    if model.config.multimodal:
        mods = {"camera": (lat[0::2], z_gt[0::2]), "lidar": (lat[1::2], z_gt[1::2])}
    else:
        mods = {"camera" if model.config.use_camera else "lidar": (lat, z_gt)}
    out: Dict[str, float] = {}
    for name, (s, g) in mods.items():
        mse = float(((s - g) ** 2).mean())
        out[f"{name}_latent_mse"] = mse
        out[f"{name}_latent_mse_rel"] = mse / max(float(g.var()), 1e-12)
    return out


@torch.no_grad()
def vae_ceiling(model: MobiDiffusion, batch: Batch) -> Dict[str, float]:
    """Masked-region PSNR of the pure VAE round trip (mode encode -> decode):
    the ceiling on what any latent-space sampler can score against the
    pixel GT."""

    def round_trip(vae, x):
        return _nhwc_numpy(vae.decode(vae.encode(_nchw(x, model.device)).mode()))

    gt_c, gt_l = batch["image"]["GT"], batch["lidar"]["range_data"]
    return {
        "camera_ceiling_psnr": masked_psnr(round_trip(model.first_stage_model, gt_c), gt_c,
                                           1.0 - np.asarray(batch["image"]["inpaint_mask"])),
        "lidar_ceiling_psnr": masked_psnr(round_trip(model.lidar_stage_model, gt_l), gt_l,
                                          1.0 - np.asarray(batch["lidar"]["range_mask"])),
    }


# ---------------------------------------------------------------- the gate
def masked_psnr(pred: np.ndarray, gt: np.ndarray, region: np.ndarray) -> float:
    """PSNR over region == 1 pixels only (peak 2.0 for [-1, 1] data)."""
    pred, gt = np.asarray(pred, np.float64), np.asarray(gt, np.float64)
    region = np.broadcast_to(np.asarray(region, np.float64), gt.shape)
    mse = float((((pred - gt) * region) ** 2).sum() / region.sum())
    return float(10.0 * np.log10(4.0 / max(mse, 1e-12)))


def score_inpaint(out: Dict[str, np.ndarray], batch: Batch) -> Dict[str, float]:
    """The gate's numbers for sampled NHWC outputs {"camera", "lidar"}: each
    modality's masked PSNR, the do-nothing baseline's (the blanked hole), and
    the lidar depth channel's masked MSE."""
    region_c = 1.0 - np.asarray(batch["image"]["inpaint_mask"])
    region_l = 1.0 - np.asarray(batch["lidar"]["range_mask"])
    gt_c, gt_l = np.asarray(batch["image"]["GT"]), np.asarray(batch["lidar"]["range_data"])
    return {
        "camera_psnr": masked_psnr(out["camera"], gt_c, region_c),
        "camera_psnr_baseline": masked_psnr(np.asarray(batch["image"]["inpaint_image"]), gt_c, region_c),
        "lidar_psnr": masked_psnr(out["lidar"], gt_l, region_l),
        "lidar_psnr_baseline": masked_psnr(np.asarray(batch["lidar"]["range_data_inpaint"]), gt_l, region_l),
        "lidar_depth_mse": float((((out["lidar"][..., 0] - gt_l[..., 0]) * region_l[..., 0]) ** 2).sum()
                                 / region_l[..., 0].sum()),
    }


def sample_and_score(
    model: MobiDiffusion,
    batch: Batch,
    num_steps: int = 20,
    seed: int = 7,
    pipeline=None,
    guidance_scale: float = 1.0,
    sampler: str = "ddim",
    sample_segments: int = 1,
    x_T: Optional[torch.Tensor] = None,
) -> Dict[str, float]:
    """Sample inpaints of the object set through the production pipeline
    (posterior-mode encodes) and score them (`score_inpaint`).
    guidance_scale, sampler and sample_segments select the protocol: the
    reference samples its benches at CFG scale 5 with PLMS-50, and scoring
    there shows the unconditional tokens trained under CFG dropout guide
    rather than garble. The draws come from a generator seeded with `seed`;
    `x_T` pins the initial noise."""
    from mobi_tpu_torch.pipeline import make_inpaint_pipeline

    if pipeline is None:
        pipeline = make_inpaint_pipeline(
            model, num_steps=num_steps, guidance_scale=guidance_scale, sampler=sampler,
            deterministic_encode=True, sample_segments=sample_segments, device=model.device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    out = pipeline(batch, gen, x_T)
    return score_inpaint({k: v.float().cpu().numpy() for k, v in out.items()}, batch)
