"""Joint camera + lidar latent diffusion, the MObI flagship model: the
inference and training surface of mobi_tpu models/diffusion.py.

`MobiDiffusion` is an nn.Module whose state-dict keys are the reference
Lightning names that mobi_tpu/export_torch.py writes:

  model.diffusion_model.*   UNet
  first_stage_model.*       camera KL-VAE
  lidar_stage_model.*       range KL-VAE (lidar adapter convs)
  cond_stage_model.*        CLIP tower + mapper + final_ln + bbox embedder
  proj_out.*                clip_width -> context_dim image-token projection
  learnable_vector, bbox_uncond_vector   the CFG unconditional tokens

so a published checkpoint loads with `load_state_dict(strict=True)`, and
`load_jax_params` loads a JAX parameter tree through convert.py. The DDPM
schedule lives on the host (`self.schedule`) and is not part of the state.

Training (`p_losses`, `training_loss`) follows the reference's adapter-only
rule: `trainable_mask` names the trainable parameters, and a model built with
`for_training=True` keeps them fp32 (the optimizer's masters) while the
frozen >= 2-D weights take the model dtype.

The batch dict, `get_input`'s latents, `sample`'s x_T and result and
`decode_sample`'s outputs keep the JAX package's NHWC layout; the networks
run in NCHW. The entry point runs on CUDA unless the caller passes
device="cpu".
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from mobi_tpu_torch.convert import UNET_PREFIX, state_dict_from_jax
from mobi_tpu_torch.models.clip import CLIPEmbeddings
from mobi_tpu_torch.models.encoders import CondStageModel
from mobi_tpu_torch.models.layers import Conv2d, Dense, GroupNorm, LayerNorm
from mobi_tpu_torch.models import samplers as S
from mobi_tpu_torch.models.unet import UNetModel
from mobi_tpu_torch.models.vae import AutoencoderKL
from mobi_tpu_torch.ops.schedules import DiffusionSchedule, SamplerTables


# The reference's adapter trainability rule (mobi_tpu diffusion.py:54, 61-67),
# applied to the UNet's names only: over full state-dict names "lidar" would
# also match the whole lidar VAE (`lidar_stage_model.*`).
ADAPTER_SUBSTRINGS = ("cond_adapter", "lidar", "cross_modal")
# The UNet layers the reference zero-initialises (zero_module; mobi_tpu
# models/unet.py's zero_init=True): each ResBlock's output conv, each
# SpatialTransformer's proj_out, the adapters' connectors and the final
# output conv. Matched against names relative to the UNet.
ZERO_INIT_LAYERS = re.compile(
    r"(\.out_layers\.3|\.proj_out|\.cond_adapter_connector|\.cross_modal_connector_\w+|^out\.2)\.(weight|bias)$")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mobi_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def interleave_modalities(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """[x_a, x_b] (each [B, ...]) -> [a0, b0, a1, b1, ...] ([2B, ...])."""
    stacked = torch.stack(list(tensors), dim=1)
    return stacked.reshape((-1,) + tuple(stacked.shape[2:]))


def deinterleave_modalities(x: torch.Tensor, n: int = 2) -> Tuple[torch.Tensor, ...]:
    pair = x.reshape((-1, n) + tuple(x.shape[1:]))
    return tuple(pair[:, i] for i in range(n))


@dataclasses.dataclass(frozen=True)
class MobiConfig:
    """The fields of mobi_tpu MobiConfig (configs/mobi_nusc_512.yaml model
    params) that inference, training and the test bench read; `dtype` is a
    torch dtype. Images are square (image_height and range_height set the
    VAE resolutions; the widths are carried for the data path)."""

    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.00085
    linear_end: float = 0.0120
    latent_size: int = 64
    channels: int = 4
    scale_factor: float = 0.18215
    lidar_scale_factor: float = 0.18215
    u_cond_percent: float = 0.2
    use_camera: bool = True
    use_lidar: bool = True
    cond_stage_key: Sequence[str] = ("ref_image", "ref_bbox")
    # the range view's normalizations, read by the test bench's lidar
    # metrics and paste-back (mobi_tpu_torch/inference_test_bench.py)
    range_object_norm: bool = True
    range_object_norm_scale: float = 0.75
    range_int_norm: bool = True
    parameterization: str = "eps"
    image_height: int = 512
    image_width: int = 512
    range_height: int = 512
    range_width: int = 512
    unet_channels: int = 320
    unet_channel_mult: Sequence[int] = (1, 2, 4, 4)
    unet_num_res_blocks: int = 2
    unet_attention_resolutions: Sequence[int] = (4, 2, 1)
    unet_num_heads: int = 8
    # activation remat (the JAX package's flax nn.remat): the UNet's True,
    # "transformer" or False (models/unet.py), the VAEs' per block
    unet_use_checkpoint: Union[bool, str] = False
    vae_use_checkpoint: bool = False
    # the attention backend of the UNet's self- and cross-modal attentions:
    # "auto" | "flash" | "xla" (ops/attention.py)
    attn_backend: str = "auto"
    context_dim: int = 768
    vae_ch: int = 128
    vae_ch_mult: Sequence[int] = (1, 2, 4, 4)
    vae_num_res_blocks: int = 2
    vae_embed_dim: int = 4
    clip_width: int = 1024
    ref_image_size: int = 224
    dtype: torch.dtype = torch.float32

    @property
    def multimodal(self) -> bool:
        return self.use_camera and self.use_lidar


class _DiffusionWrapper(nn.Module):
    """Holds the UNet as `diffusion_model` (the reference's `model.` level)."""

    def __init__(self, unet: UNetModel):
        super().__init__()
        self.diffusion_model = unet


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):  # a copy: the array may be read-only
        return torch.tensor(tree, device=device)
    return tree.to(device)


class MobiDiffusion(nn.Module):
    """The flagship model on one device, with seeded random weights until a
    checkpoint or JAX tree is loaded.

    The random weights follow the JAX package's initializers: uniform(+-
    fan_in^-1/2) for every conv and linear kernel (variance scaling 1/3),
    `proj_out` normal with std clip_width^-1/2, CLIP's patch embedding
    lecun normal truncated at two standard deviations (flax's nn.Conv
    default), the CLIP embeddings normal(0.02), the unconditional tokens
    normal(1), norms (1, 0) and biases 0. Unlike JAX's, the layers the
    reference zero-initialises are drawn too, so every branch contributes to
    the output. With a bf16
    `config.dtype` the >= 2-D parameters are held in bf16 and the 1-D norm
    scales and biases in fp32 (the JAX bench's policy); with `for_training`
    the trainable parameters stay fp32 as well (train.py's policy, applied
    before any weights are loaded, so trainable values are never rounded
    through bf16). `cond_stage_model` replaces the default ViT-L/14 conditioning stage.
    `zero_init_reference_layers_` zeroes the layers the reference
    zero-initialises, for training from scratch as the JAX package does.
    """

    def __init__(self, config: MobiConfig = MobiConfig(), device=None, seed: int = 0,
                 cond_stage_model: Optional[CondStageModel] = None,
                 for_training: bool = False):
        super().__init__()
        self.config = cfg = config
        self.for_training = for_training
        self.device = resolve_device(device)
        self.schedule = DiffusionSchedule.create(
            timesteps=cfg.timesteps, beta_schedule=cfg.beta_schedule,
            linear_start=cfg.linear_start, linear_end=cfg.linear_end,
            parameterization=cfg.parameterization,
        )
        vae_kw = dict(embed_dim=cfg.vae_embed_dim, ch=cfg.vae_ch,
                      ch_mult=tuple(cfg.vae_ch_mult),
                      num_res_blocks=cfg.vae_num_res_blocks,
                      use_checkpoint=cfg.vae_use_checkpoint, dtype=cfg.dtype)
        with torch.device(self.device):
            self.model = _DiffusionWrapper(UNetModel(
                in_channels=9, model_channels=cfg.unet_channels,
                out_channels=cfg.channels, num_res_blocks=cfg.unet_num_res_blocks,
                attention_resolutions=tuple(cfg.unet_attention_resolutions),
                channel_mult=tuple(cfg.unet_channel_mult),
                num_heads=cfg.unet_num_heads, context_dim=cfg.context_dim,
                bbox_cond="ref_bbox" in cfg.cond_stage_key,
                use_camera=cfg.use_camera, use_lidar=cfg.use_lidar,
                use_checkpoint=cfg.unet_use_checkpoint,
                attn_backend=cfg.attn_backend, dtype=cfg.dtype,
            ))
            if cfg.use_camera:
                self.first_stage_model = AutoencoderKL(
                    out_ch=3, resolution=cfg.image_height, **vae_kw)
            if cfg.use_lidar:
                self.lidar_stage_model = AutoencoderKL(
                    out_ch=2, resolution=cfg.range_height, lidar_adapter=True, **vae_kw)
            self.cond_stage_model = cond_stage_model or CondStageModel(
                conditions=tuple(cfg.cond_stage_key), clip_width=cfg.clip_width,
                clip_image_size=cfg.ref_image_size, dtype=cfg.dtype)
            self.proj_out = Dense(cfg.clip_width, cfg.context_dim, dtype=cfg.dtype)
            self.learnable_vector = nn.Parameter(torch.empty(1, 1, cfg.context_dim))
            self.bbox_uncond_vector = nn.Parameter(torch.empty(1, 1, cfg.context_dim))
        self.to(self.device)
        self.init_random_(seed)

    @property
    def unet(self) -> UNetModel:
        return self.model.diffusion_model

    # ----------------------------------------------------------- weights
    @torch.no_grad()
    def init_random_(self, seed: int) -> None:
        """Fill every parameter from `seed` (see the class docstring), then
        apply the dtype policy."""
        g = torch.Generator(device=self.device).manual_seed(seed)

        def uniform(t, bound):
            t.copy_((torch.rand(t.shape, generator=g, device=self.device) * 2 - 1) * bound)

        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=g, device=self.device) * std)

        def lecun_truncated(t):
            # flax variance_scaling(1, "fan_in", "truncated_normal"): N(0, 1)
            # truncated to [-2, 2] by the inverse CDF (torch's trunc_normal_),
            # its std 0.8796 brought back to fan_in^-1/2
            lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
            u = torch.rand(t.shape, generator=g, device=self.device) * (hi - lo) + lo
            z = torch.erfinv(2 * u - 1) * math.sqrt(2)
            t.copy_(z.clamp_(-2, 2) * (t[0].numel() ** -0.5 / 0.87962566103423978))

        for m in self.modules():
            if isinstance(m, (GroupNorm, LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, (Dense, Conv2d)):
                uniform(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, CLIPEmbeddings):
                normal(m.class_embedding, 0.02)
                normal(m.position_embedding.weight, 0.02)
        normal(self.learnable_vector, 1.0)
        normal(self.bbox_uncond_vector, 1.0)
        normal(self.proj_out.weight, self.config.clip_width ** -0.5)
        for m in self.modules():
            if isinstance(m, CLIPEmbeddings):
                lecun_truncated(m.patch_embedding.weight)
        self.apply_dtype_policy()

    @torch.no_grad()
    def zero_init_reference_layers_(self) -> list:
        """Zero the weights and biases of the UNet layers the reference
        zero-initialises (`ZERO_INIT_LAYERS`), as the JAX package's init
        leaves them; returns their full names. Trained from there, the
        UNet starts at eps == 0 with every residual branch closed."""
        names = []
        for name, p in self.unet.named_parameters():
            if ZERO_INIT_LAYERS.search(name):
                p.zero_()
                names.append(UNET_PREFIX + name)
        return names

    def apply_dtype_policy(self) -> None:
        if self.config.dtype == torch.float32:
            return
        keep = self.trainable_mask() if self.for_training else {}
        for name, p in self.named_parameters():
            if p.dim() >= 2 and not keep.get(name, False):
                p.data = p.data.to(self.config.dtype)

    def trainable_mask(self) -> Dict[str, bool]:
        """Parameter name -> trainable: the UNet adapters, the bbox embedder
        and `bbox_uncond_vector` (mobi_tpu diffusion.py:278-301, reference
        ddpm.py:1616-1669). MOBI_TRAIN_UNET_FULL=1 makes the whole UNet
        trainable instead of its adapters; the VAEs and the CLIP tower stay
        frozen either way."""
        full = os.environ.get("MOBI_TRAIN_UNET_FULL", "0") == "1"

        def trainable(name: str) -> bool:
            if name.startswith(UNET_PREFIX):
                return full or any(s in name[len(UNET_PREFIX):] for s in ADAPTER_SUBSTRINGS)
            if name.startswith("cond_stage_model."):
                return "bbox_embedder" in name
            return name == "bbox_uncond_vector"

        return {name: trainable(name) for name, _ in self.named_parameters()}

    def load_jax_params(self, params_np: Dict[str, Any]) -> None:
        """Load a mobi_tpu parameter tree (numpy leaves) with strict=True."""
        self.load_state_dict(state_dict_from_jax(params_np, self.config), strict=True)

    # -------------------------------------------------------- vae stages
    def _encode_stage(self, vae: AutoencoderKL, x_nhwc: torch.Tensor,
                      generator: Optional[torch.Generator], scale: float,
                      deterministic: bool) -> torch.Tensor:
        # get_input runs it under no_grad: the latents are data and never a
        # gradient path (the reference's detach, the JAX package's
        # stop_gradient), so a remat'd VAE encode is never recomputed inside
        # the UNet's backward, where its temporaries would raise the peak
        posterior = vae.encode(x_nhwc.permute(0, 3, 1, 2))
        z = posterior.mode() if deterministic else posterior.sample(generator)
        return (scale * z).permute(0, 2, 3, 1)

    def _encode_triplet(self, vae, gt, inpaint, mask, generator, scale,
                        deterministic: bool = False) -> torch.Tensor:
        """(GT, inpaint, mask) NHWC -> 9-channel NHWC latent."""
        z = self._encode_stage(vae, gt, generator, scale, deterministic)
        z_inpaint = self._encode_stage(vae, inpaint, generator, scale, deterministic)
        h, w = z.shape[1], z.shape[2]
        # torch nearest picks floor(i * in / out); index explicitly, as the
        # JAX package does, so the mask channel is bit-exact
        ridx = torch.arange(h, device=mask.device) * mask.shape[1] // h
        cidx = torch.arange(w, device=mask.device) * mask.shape[2] // w
        mask_resized = mask[:, ridx][:, :, cidx]
        return torch.cat([z, z_inpaint, mask_resized.to(z.dtype)], dim=-1)

    def lidar_latent_geometry(self, z_lidar_full_shape) -> Dict[str, int]:
        size = self.config.latent_size
        H, W = z_lidar_full_shape[1], z_lidar_full_shape[2]
        return {"W": W, "H": H, "left": W // 2 - size // 2, "pad": (size - H) // 2}

    def align_lidar_latent(self, z_lidar: torch.Tensor, ref_bbox: Optional[torch.Tensor]):
        """Center-crop the NHWC lidar latent's width to latent_size, pad (or
        crop) its height, and renormalize the lidar bbox.
        Returns (aligned latent, adjusted bbox, geometry dict)."""
        size = self.config.latent_size
        geom = self.lidar_latent_geometry(z_lidar.shape)
        W, H, left, pad = geom["W"], geom["H"], geom["left"], geom["pad"]
        z = z_lidar[:, :, left:W // 2 + size // 2, :]
        if pad >= 0:
            z = torch.nn.functional.pad(z, (0, 0, 0, 0, pad, size - H - pad))
        else:
            # a negative pad crops, as torch F.pad does in the reference
            z = z[:, -pad:-pad + size, :, :]
        bbox = ref_bbox
        if bbox is not None:
            bbox = bbox.clone()
            bbox[..., 0] = (bbox[..., 0] * W - left) / size
            bbox[..., 1] = bbox[..., 1] + pad / size
        return z, bbox, geom

    # ------------------------------------------------------ conditioning
    def get_learned_conditioning(self, cond: Dict[str, torch.Tensor]) -> torch.Tensor:
        """cond dict -> [B, n_tokens, context_dim]."""
        tokens = []
        enc = self.cond_stage_model(cond)
        if "ref_image" in self.config.cond_stage_key:
            # bf16 token @ weight, + the fp32 bias: the JAX promotion
            tokens.append(enc["ref_image_token"] @ self.proj_out.weight.to(
                enc["ref_image_token"].dtype).t() + self.proj_out.bias)
        if "ref_bbox" in self.config.cond_stage_key:
            tokens.append(enc["ref_bbox_token"])
        return torch.cat(tokens, dim=1)

    def uncond_tokens(self, batch: int) -> torch.Tensor:
        toks = [self.learnable_vector.expand(batch, 1, -1)]
        if "ref_bbox" in self.config.cond_stage_key:
            toks.append(self.bbox_uncond_vector.expand(batch, 1, -1))
        return torch.cat(toks, dim=1).to(self.config.dtype)

    # ---------------------------------------------------------- get_input
    @torch.no_grad()
    def get_input(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                  encode_cond: bool = False, deterministic: bool = False) -> Dict[str, Any]:
        """Batch dict (NHWC, the NuScenes schema of the JAX package) ->
        interleaved latents `z` [2B, h, w, 9] and conditioning.
        `deterministic=True` encodes with the posterior mode."""
        cfg = self.config
        batch = _to_device(batch, self.device)
        out: Dict[str, Any] = {}
        zs, conds = [], []
        if cfg.use_camera:
            img = batch["image"]
            zs.append(self._encode_triplet(
                self.first_stage_model, img["GT"], img["inpaint_image"],
                img["inpaint_mask"], generator, cfg.scale_factor, deterministic))
            conds.append(dict(img["cond"]))
        if cfg.use_lidar:
            lid = batch["lidar"]
            z_lidar_full = self._encode_triplet(
                self.lidar_stage_model, lid["range_data"], lid["range_data_inpaint"],
                lid["range_mask"], generator, cfg.lidar_scale_factor, deterministic)
            lidar_cond = dict(lid["cond"])
            if "ref_image" in cfg.cond_stage_key and "ref_image" not in lidar_cond:
                # lidar rows share the camera reference crop (dataset contract)
                lidar_cond["ref_image"] = batch["image"]["cond"]["ref_image"]
            z_lidar, bbox, geom = self.align_lidar_latent(
                z_lidar_full, lidar_cond.get("ref_bbox"))
            if bbox is not None:
                lidar_cond["ref_bbox"] = bbox
            zs.append(z_lidar)
            conds.append(lidar_cond)
            out["z_lidar_full"] = z_lidar_full[..., :4]
            out["lidar_geom"] = geom
        out["z"] = interleave_modalities(zs) if len(zs) > 1 else zs[0]
        merged = {
            k: interleave_modalities([c[k] for c in conds]) if len(conds) > 1 else conds[0][k]
            for k in conds[0]
        }
        if encode_cond:
            out["cond"] = self.get_learned_conditioning(merged)
        else:
            out["cond_raw"] = merged
        return out

    # ----------------------------------------------------------- denoiser
    def apply_model(self, x9: torch.Tensor, t: torch.Tensor, context: torch.Tensor,
                    encoder_cache=None, return_cache: bool = False):
        """The UNet, NCHW: [B, 9, h, w] -> eps [B, 4, h, w]; (eps, cache)
        with `return_cache`; `encoder_cache` skips the encoder (UNetModel)."""
        return self.unet(x9, t, context, encoder_cache=encoder_cache, return_cache=return_cache)

    # --------------------------------------------------------------- loss
    def p_losses(self, z: torch.Tensor, context: torch.Tensor, t: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """eps-MSE on the first 4 channels of the NHWC latents z [B, h, w, 9]
        (mobi_tpu diffusion.py:485-520). An explicit `noise` overrides the
        draw. The metrics split the joint loss into the even (camera) and odd
        (lidar) rows of the interleaved batch; the trained loss stays the
        joint mean."""
        if noise is None:
            noise = torch.randn(z[..., :4].shape, generator=generator, dtype=z.dtype,
                                device=z.device)
        x_noisy = self.schedule.q_sample(z[..., :4], t, noise)
        x9 = torch.cat([x_noisy, z[..., 4:]], dim=-1)
        eps = self.apply_model(x9.permute(0, 3, 1, 2), t, context).permute(0, 2, 3, 1)
        loss_simple = ((eps.float() - noise.float()) ** 2).mean(dim=(1, 2, 3))
        loss = loss_simple.mean()
        metrics = {
            "loss": loss,
            "loss_simple": loss_simple.mean(),
            "loss_vlb": (self.schedule.table("lvlb_weights", t) * loss_simple).mean(),
        }
        if self.config.multimodal:
            metrics["loss_camera"] = loss_simple[0::2].mean()
            metrics["loss_lidar"] = loss_simple[1::2].mean()
        return loss, metrics

    def training_loss(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None, *,
                      t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                      drop=None):
        """The reference's shared_step (mobi_tpu diffusion.py:522-536): both
        encodes (posterior samples under no_grad, `get_input`), the
        conditioning on the trainable path, whole-batch CFG dropout with
        probability u_cond_percent, and `p_losses`. `t`, `noise` and `drop`
        (a bool) replace their draws. Returns (loss, metrics)."""
        cfg = self.config
        data = self.get_input(batch, generator, encode_cond=False)
        z = data["z"]
        b = z.shape[0]
        if t is None:
            t = torch.randint(0, cfg.timesteps, (b,), generator=generator, device=self.device)
        context = self.get_learned_conditioning(data["cond_raw"])
        if drop is None:
            drop = torch.rand((), generator=generator, device=self.device) < cfg.u_cond_percent
        drop = torch.as_tensor(drop, device=self.device)
        context = torch.where(drop, self.uncond_tokens(b), context)
        return self.p_losses(z, context, t.to(self.device), noise, generator)

    # ----------------------------------------------------------- sampling
    SAMPLERS = ("plms", "ddim", "ddpm")

    def sampling_inputs(self, data: Dict[str, Any], generator: Optional[torch.Generator],
                        guidance_scale: float, x_T: Optional[torch.Tensor] = None):
        """(x_T, cond, rest, uncond) of a sampling loop, NCHW: x_T drawn from
        `generator` unless given ([B, h, w, 4] NHWC), fp32 either way."""
        z = data["z"].permute(0, 3, 1, 2)
        rest = z[:, 4:]
        uncond = self.uncond_tokens(z.shape[0]) if guidance_scale != 1.0 else None
        if x_T is None:
            x_T = torch.randn(z[:, :4].shape, generator=generator,
                              dtype=torch.float32, device=self.device)
        else:
            x_T = x_T.to(self.device, torch.float32).permute(0, 3, 1, 2)
        return x_T, data["cond"], rest, uncond

    @torch.no_grad()
    def sample(self, data: Dict[str, Any], generator: Optional[torch.Generator] = None,
               num_steps: int = 50, guidance_scale: float = 5.0, sampler: str = "plms",
               eta: float = 0.0, encoder_interval: int = 1,
               x_T: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample latents from `get_input(encode_cond=True)` data with
        "plms" (the default, as in the JAX package; eta is 0 there), "ddim"
        (`encoder_interval > 1` turns on encoder propagation, approximate) or
        "ddpm" (the full-length ancestral loop, no x0 clipping). `x_T`
        ([B, h, w, 4], NHWC) overrides the initial noise draw. Returns the
        interleaved NHWC latents [B, h, w, 4] in float32: the sampling carry
        stays fp32 while the UNet runs in the model dtype."""
        if sampler not in self.SAMPLERS:
            raise ValueError(f"unknown sampler {sampler}")
        x_T, cond, rest, uncond = self.sampling_inputs(data, generator, guidance_scale, x_T)
        if sampler == "ddpm":
            x = S.ddpm_sample(self.apply_model, self.schedule, x_T, cond, rest, uncond,
                              guidance_scale, clip_denoised=False, generator=generator)
            return x.permute(0, 2, 3, 1)
        tables = SamplerTables.create(self.schedule, num_steps, eta=eta)
        if sampler == "plms":
            x = S.plms_sample(self.apply_model, tables, x_T, cond, rest, uncond, guidance_scale)
        else:
            x = S.ddim_sample(self.apply_model, tables, x_T, cond, rest, uncond, guidance_scale,
                              generator=generator, encoder_interval=encoder_interval,
                              cached_model_fn=self.apply_model)
        return x.permute(0, 2, 3, 1)

    @torch.no_grad()
    def decode_sample(self, sample: torch.Tensor, z_lidar_full: Optional[torch.Tensor] = None,
                      lidar_geom: Optional[Dict[str, int]] = None) -> Dict[str, torch.Tensor]:
        """De-interleave the NHWC latents, paste the lidar latent back into
        its full width, and VAE-decode both modalities to NHWC in [-1, 1]."""
        cfg = self.config
        if cfg.multimodal:
            h_camera, h_lidar = deinterleave_modalities(sample)
        elif cfg.use_camera:
            h_camera, h_lidar = sample, None
        else:
            h_camera, h_lidar = None, sample
        if h_lidar is not None and lidar_geom is not None:
            H, left = lidar_geom["H"], lidar_geom["left"]
            bottom = (h_lidar.shape[1] - H) // 2
            h_lidar_crop = h_lidar[:, bottom:bottom + H]
            if z_lidar_full is not None and z_lidar_full.shape[2] != h_lidar.shape[2]:
                h_lidar = z_lidar_full.to(h_lidar_crop.dtype).clone()
                h_lidar[:, :, left:left + h_lidar_crop.shape[2]] = h_lidar_crop
            else:
                h_lidar = h_lidar_crop
        out: Dict[str, torch.Tensor] = {}
        if h_camera is not None:
            dec = self.first_stage_model.decode((h_camera / cfg.scale_factor).permute(0, 3, 1, 2))
            out["camera"] = torch.clamp(dec, -1.0, 1.0).permute(0, 2, 3, 1)
        if h_lidar is not None:
            dec = self.lidar_stage_model.decode((h_lidar / cfg.lidar_scale_factor).permute(0, 3, 1, 2))
            out["lidar"] = torch.clamp(dec, -1.0, 1.0).permute(0, 2, 3, 1)
        return out
