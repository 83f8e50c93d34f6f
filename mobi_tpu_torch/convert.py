"""mobi_tpu parameter tree -> the port's state dict, and reference
checkpoints into the port.

The port's own copy of the walks in mobi_tpu/export_torch.py (which the port
does not import): a JAX/flax parameter tree with numpy leaves becomes the
reference Lightning state dict that `MobiDiffusion.state_dict()` has, key for
key. Layout conversions:

  Dense kernel [in, out]         -> Linear weight [out, in]
  Conv kernel [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw]
  norm scale / bias              -> weight / bias

A reference Lightning checkpoint has those names already: `load_checkpoint`
loads one, with the LitEma overlay of `extract_ema_state_dict` (the port's
copy of mobi_tpu/import_torch.py:435) where the config serves EMA weights,
and also a directory the port's CheckpointManager (checkpoint.py) wrote.

The legacy surfaces (EncoderUNetModel, the lidar VQ autoencoder, the CLIP
text tower, ClassEmbedder, the text transformer and SpatialRescaler) have no
mapping in `export_torch.py` and no published checkpoint names: their
functions here (`encoder_unet_state_dict`, `vq_state_dict`,
`clip_text_state_dict`, `class_embedder_state_dict`,
`text_transformer_state_dict`) rename a JAX tree's paths to the port's
modules, each loaded with strict=True.

The evaluation networks (CLIP ViT-B/32, Inception, LPIPS's AlexNet,
RangeNet++) need no flax-to-torch converter: their interchange is the
published torch state dict, which JAX's importers read and the port's
modules load as it is, strict (`eval/*.load_*`, `eval/*.load_published`).
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mobi_tpu_torch.models.swin import rel_pos_index

Params = Dict[str, Any]
StateDict = Dict[str, np.ndarray]
UNET_PREFIX = "model.diffusion_model."


def _linear(k) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(k).T)


def _conv(k) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _get(tree: Params, path: str):
    """'a/b/c' -> leaf, or None when any component is absent."""
    node = tree
    for p in path.split("/"):
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


class _Writer:
    """Writes converted leaves of one sub-tree into `out` under a prefix."""

    def __init__(self, params: Params, out: StateDict, prefix: str = ""):
        self.params, self.out, self.prefix = params, out, prefix

    def put(self, dst: str, value) -> None:
        self.out[self.prefix + dst] = np.asarray(value)

    def dense(self, src: str, dst: str) -> None:
        k = _get(self.params, f"{src}/Dense_0/kernel")
        if k is None:
            raise KeyError(f"missing Dense kernel at {src}")
        self.put(f"{dst}.weight", _linear(k))
        b = _get(self.params, f"{src}/Dense_0/bias")
        if b is not None:
            self.put(f"{dst}.bias", b)

    def conv(self, src: str, dst: str) -> None:
        k = _get(self.params, f"{src}/Conv_0/kernel")
        if k is None:
            raise KeyError(f"missing Conv kernel at {src}")
        self.put(f"{dst}.weight", _conv(k))
        b = _get(self.params, f"{src}/Conv_0/bias")
        if b is not None:
            self.put(f"{dst}.bias", b)

    def norm(self, src: str, dst: str) -> None:
        s = _get(self.params, f"{src}/scale")
        if s is None:
            raise KeyError(f"missing norm scale at {src}")
        self.put(f"{dst}.weight", s)
        self.put(f"{dst}.bias", _get(self.params, f"{src}/bias"))


def _vae(w: _Writer, ch_mult: Sequence[int], num_res_blocks: int,
         attn_resolutions: Sequence[int], resolution: int, lidar_adapter: bool) -> None:
    def resblock(src, dst):
        w.norm(f"{src}/norm1", f"{dst}.norm1")
        w.conv(f"{src}/conv1", f"{dst}.conv1")
        w.norm(f"{src}/norm2", f"{dst}.norm2")
        w.conv(f"{src}/conv2", f"{dst}.conv2")
        if _get(w.params, f"{src}/nin_shortcut") is not None:
            w.conv(f"{src}/nin_shortcut", f"{dst}.nin_shortcut")

    def attnblock(src, dst):
        w.norm(f"{src}/norm", f"{dst}.norm")
        for n in ("q", "k", "v", "proj_out"):
            w.conv(f"{src}/{n}", f"{dst}.{n}")

    if lidar_adapter:
        w.conv("encoder/conv_in_lidar", "encoder.conv_in_lidar")
        resblock("encoder/res_block_lidar1", "encoder.res_block_lidar1")
        resblock("encoder/res_block_lidar2", "encoder.res_block_lidar2")
    else:
        w.conv("encoder/conv_in", "encoder.conv_in")
    curr_res = resolution
    for lvl in range(len(ch_mult)):
        for blk in range(num_res_blocks):
            resblock(f"encoder/down_{lvl}_block_{blk}", f"encoder.down.{lvl}.block.{blk}")
            if curr_res in attn_resolutions:
                attnblock(f"encoder/down_{lvl}_attn_{blk}", f"encoder.down.{lvl}.attn.{blk}")
        if lvl != len(ch_mult) - 1:
            w.conv(f"encoder/down_{lvl}_downsample/conv", f"encoder.down.{lvl}.downsample.conv")
            curr_res //= 2
    resblock("encoder/mid_block_1", "encoder.mid.block_1")
    attnblock("encoder/mid_attn_1", "encoder.mid.attn_1")
    resblock("encoder/mid_block_2", "encoder.mid.block_2")
    w.norm("encoder/norm_out", "encoder.norm_out")
    w.conv("encoder/conv_out", "encoder.conv_out")

    w.conv("decoder/conv_in", "decoder.conv_in")
    resblock("decoder/mid_block_1", "decoder.mid.block_1")
    attnblock("decoder/mid_attn_1", "decoder.mid.attn_1")
    resblock("decoder/mid_block_2", "decoder.mid.block_2")
    curr_res = resolution // 2 ** (len(ch_mult) - 1)
    for lvl in reversed(range(len(ch_mult))):
        for blk in range(num_res_blocks + 1):
            resblock(f"decoder/up_{lvl}_block_{blk}", f"decoder.up.{lvl}.block.{blk}")
            if curr_res in attn_resolutions:
                attnblock(f"decoder/up_{lvl}_attn_{blk}", f"decoder.up.{lvl}.attn.{blk}")
        if lvl != 0:
            w.conv(f"decoder/up_{lvl}_upsample/conv", f"decoder.up.{lvl}.upsample.conv")
            curr_res *= 2
    if lidar_adapter:
        resblock("decoder/res_block_lidar1", "decoder.res_block_lidar1")
        w.norm("decoder/norm_out_lidar1", "decoder.norm_out_lidar1")
        resblock("decoder/res_block_lidar2", "decoder.res_block_lidar2")
        w.norm("decoder/norm_out_lidar2", "decoder.norm_out_lidar2")
        w.conv("decoder/conv_out_lidar", "decoder.conv_out_lidar")
    else:
        w.norm("decoder/norm_out", "decoder.norm_out")
        w.conv("decoder/conv_out", "decoder.conv_out")
    w.conv("quant_conv", "quant_conv")
    w.conv("post_quant_conv", "post_quant_conv")


def _unet(w: _Writer, channel_mult: Sequence[int], num_res_blocks: int,
          attention_resolutions: Sequence[int]) -> None:
    def resblock(src, dst):
        w.norm(f"{src}/in_norm", f"{dst}.in_layers.0")
        w.conv(f"{src}/in_conv", f"{dst}.in_layers.2")
        w.dense(f"{src}/emb_proj", f"{dst}.emb_layers.1")
        w.norm(f"{src}/out_norm", f"{dst}.out_layers.0")
        w.conv(f"{src}/out_conv", f"{dst}.out_layers.3")
        if _get(w.params, f"{src}/skip_connection") is not None:
            w.conv(f"{src}/skip_connection", f"{dst}.skip_connection")

    def cross_attention(src, dst):
        for n in ("to_q", "to_k", "to_v"):
            w.dense(f"{src}/{n}", f"{dst}.{n}")
        w.dense(f"{src}/to_out", f"{dst}.to_out.0")

    def transformer(src, dst):
        w.norm(f"{src}/norm", f"{dst}.norm")
        w.conv(f"{src}/proj_in", f"{dst}.proj_in")
        w.conv(f"{src}/proj_out", f"{dst}.proj_out")
        d = 0
        while _get(w.params, f"{src}/block_{d}/norm1/scale") is not None:
            bsrc, bdst = f"{src}/block_{d}", f"{dst}.transformer_blocks.{d}"
            cross_attention(f"{bsrc}/attn1", f"{bdst}.attn1")
            cross_attention(f"{bsrc}/attn2", f"{bdst}.attn2")
            for n in ("norm1", "norm2", "norm3"):
                w.norm(f"{bsrc}/{n}", f"{bdst}.{n}")
            w.dense(f"{bsrc}/ff/proj", f"{bdst}.ff.net.0.proj")
            w.dense(f"{bsrc}/ff/out", f"{bdst}.ff.net.2")
            if _get(w.params, f"{bsrc}/cond_adapter_norm") is not None:
                w.norm(f"{bsrc}/cond_adapter_norm", f"{bdst}.cond_adapter_norm")
                cross_attention(f"{bsrc}/cond_adapter_attn", f"{bdst}.cond_adapter_attn")
                w.dense(f"{bsrc}/cond_adapter_connector", f"{bdst}.cond_adapter_connector")
            if _get(w.params, f"{bsrc}/cross_modal_norm_camera") is not None:
                for m in ("camera", "lidar"):
                    w.norm(f"{bsrc}/cross_modal_norm_{m}", f"{bdst}.cross_modal_norm_{m}")
                    cross_attention(f"{bsrc}/cross_modal_attn_{m}", f"{bdst}.cross_modal_attn_{m}")
                    w.dense(f"{bsrc}/cross_modal_connector_{m}", f"{bdst}.cross_modal_connector_{m}")
            d += 1

    w.dense("time_embed_0", "time_embed.0")
    w.dense("time_embed_2", "time_embed.2")
    w.conv("input_blocks_0_conv", "input_blocks.0.0")
    idx, ds = 1, 1
    for level in range(len(channel_mult)):
        for _ in range(num_res_blocks):
            resblock(f"input_blocks_{idx}_res", f"input_blocks.{idx}.0")
            if ds in attention_resolutions:
                transformer(f"input_blocks_{idx}_attn", f"input_blocks.{idx}.1")
            idx += 1
        if level != len(channel_mult) - 1:
            w.conv(f"input_blocks_{idx}_down/op", f"input_blocks.{idx}.0.op")
            idx += 1
            ds *= 2
    resblock("middle_block_0", "middle_block.0")
    transformer("middle_block_1", "middle_block.1")
    resblock("middle_block_2", "middle_block.2")
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            resblock(f"output_blocks_{idx}_res", f"output_blocks.{idx}.0")
            sub = 1
            if ds in attention_resolutions:
                transformer(f"output_blocks_{idx}_attn", f"output_blocks.{idx}.{sub}")
                sub += 1
            if level and i == num_res_blocks:
                w.conv(f"output_blocks_{idx}_up/conv", f"output_blocks.{idx}.{sub}.conv")
                ds //= 2
            idx += 1
    w.norm("out_norm", "out.0")
    w.conv("out_conv", "out.2")


def _cond_stage(w: _Writer) -> None:
    params = w.params
    tower = params.get("transformer")
    if tower is not None:
        vm = "transformer.vision_model"
        w.put(f"{vm}.embeddings.patch_embedding.weight", _conv(tower["patch_embedding"]["kernel"]))
        w.put(f"{vm}.embeddings.class_embedding", tower["class_embedding"])
        w.put(f"{vm}.embeddings.position_embedding.weight", tower["position_embedding"])
        tw = _Writer(tower, w.out, w.prefix + vm + ".")
        tw.norm("pre_layernorm", "pre_layrnorm")  # HF's spelling
        tw.norm("post_layernorm", "post_layernorm")
        i = 0
        while f"layer_{i}" in tower:
            src, dst = f"layer_{i}", f"encoder.layers.{i}"
            for n in ("layer_norm1", "layer_norm2"):
                tw.norm(f"{src}/{n}", f"{dst}.{n}")
            for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                tw.dense(f"{src}/self_attn/{n}", f"{dst}.self_attn.{n}")
            for n in ("fc1", "fc2"):
                tw.dense(f"{src}/{n}", f"{dst}.mlp.{n}")
            i += 1
        i = 0
        while _get(params, f"mapper/resblock_{i}") is not None:
            src, dst = f"mapper/resblock_{i}", f"mapper.resblocks.{i}"
            w.dense(f"{src}/c_qkv", f"{dst}.attn.c_qkv")
            w.dense(f"{src}/c_proj", f"{dst}.attn.c_proj")
            w.dense(f"{src}/c_fc", f"{dst}.mlp.c_fc")
            w.dense(f"{src}/mlp_c_proj", f"{dst}.mlp.c_proj")
            w.norm(f"{src}/ln_1", f"{dst}.ln_1")
            w.norm(f"{src}/ln_2", f"{dst}.ln_2")
            i += 1
        if "final_ln" in params:
            w.norm("final_ln", "final_ln")
    if "bbox_embedder" in params:
        for src, dst in (("bbox_proj", "bbox_proj"), ("linear_1", "second_linear.0"),
                         ("linear_2", "second_linear.2"), ("linear_3", "second_linear.4")):
            w.dense(f"bbox_embedder/{src}", f"bbox_embedder.{dst}")


def state_dict_numpy(params: Params, cfg) -> StateDict:
    """The converted state dict with numpy values."""
    out: StateDict = {}
    if "unet" in params:
        _unet(_Writer(params["unet"], out, "model.diffusion_model."),
              tuple(cfg.unet_channel_mult), cfg.unet_num_res_blocks,
              tuple(cfg.unet_attention_resolutions))
    vae_kw = dict(ch_mult=tuple(cfg.vae_ch_mult), num_res_blocks=cfg.vae_num_res_blocks,
                  attn_resolutions=(), resolution=cfg.image_height)
    if "vae_camera" in params:
        _vae(_Writer(params["vae_camera"], out, "first_stage_model."),
             lidar_adapter=False, **vae_kw)
    if "vae_lidar" in params:
        _vae(_Writer(params["vae_lidar"], out, "lidar_stage_model."),
             lidar_adapter=True, **vae_kw)
    if "cond" in params:
        _cond_stage(_Writer(params["cond"], out, "cond_stage_model."))
    if "proj_out" in params:
        out["proj_out.weight"] = _linear(params["proj_out"]["kernel"])
        out["proj_out.bias"] = np.asarray(params["proj_out"]["bias"])
    for name in ("learnable_vector", "bbox_uncond_vector"):
        if name in params:
            out[name] = np.asarray(params[name])
    return out


def vae_state_dict_numpy(params: Params, ch_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                         attn_resolutions: Sequence[int] = (), resolution: int = 512,
                         lidar_adapter: bool = False) -> StateDict:
    """A mobi_tpu AutoencoderKL tree -> a bare AutoencoderKL state dict of
    the port (numpy values), as train_autoencoder trains one."""
    out: StateDict = {}
    _vae(_Writer(params, out), tuple(ch_mult), num_res_blocks, tuple(attn_resolutions), resolution, lidar_adapter)
    return out


# torchvision AlexNet's index of each of the five LPIPS trunk convs
_ALEX_INDEX = (0, 3, 6, 8, 10)


def loss_state_dict_numpy(params: Params) -> StateDict:
    """A mobi_tpu VAE-loss tree {"logvar", "discriminator"[, "lpips"]} ->
    the state dict of the port's LidarWithDiscriminator (or
    LPIPSWithDiscriminator): the discriminator's convs and GroupNorms under
    their JAX names, the LPIPS trunk under torchvision AlexNet's and its
    heads under the lpips package's."""
    out: StateDict = {"logvar": np.asarray(params["logvar"])}
    for name, node in params["discriminator"].items():
        if "kernel" in node:
            out[f"discriminator.{name}.weight"] = _conv(node["kernel"])
        if "scale" in node:
            out[f"discriminator.{name}.weight"] = np.asarray(node["scale"])
        if "bias" in node:
            out[f"discriminator.{name}.bias"] = np.asarray(node["bias"])
    if "lpips" in params:
        lp = params["lpips"]
        for i, ti in enumerate(_ALEX_INDEX):
            out[f"lpips.net.features.{ti}.weight"] = _conv(lp["net"][f"conv{i}"]["kernel"])
            out[f"lpips.net.features.{ti}.bias"] = np.asarray(lp["net"][f"conv{i}"]["bias"])
        for i in range(len(_ALEX_INDEX)):
            out[f"lpips.lin{i}.model.1.weight"] = _conv(lp[f"lin{i}"]["kernel"])
    return out


def state_dict_from_jax(params: Params, cfg) -> Dict[str, torch.Tensor]:
    """mobi_tpu params (numpy leaves) -> the port's state dict (torch
    tensors), for `MobiDiffusion.load_state_dict(..., strict=True)`."""
    return {k: torch.from_numpy(np.array(v))  # a writable copy
            for k, v in state_dict_numpy(params, cfg).items()}


def to_numpy_state_dict(state_dict) -> StateDict:
    """Torch tensors (any float dtype) or arrays -> numpy values."""
    out: StateDict = {}
    for k, v in state_dict.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = v.float() if v.dtype in (torch.bfloat16, torch.float16) else v
            v = v.numpy()
        out[k] = np.asarray(v)
    return out


def extract_ema_state_dict(state_dict) -> Tuple[Optional[StateDict], Optional[int]]:
    """LitEma buffers -> a 'model.*'-keyed state dict of EMA values.

    The reference keeps each EMA shadow as a flat buffer named by the tracked
    parameter's name without its dots (ldm/modules/ema.py:16-21), under the
    'model_ema.' prefix. Every live 'model.*' entry gets its EMA value where
    one is tracked and keeps its live value otherwise (the reference's
    copy_to, ema.py:52-60). Returns (state dict, num_updates), or (None,
    None) when the checkpoint holds no EMA."""
    sd = to_numpy_state_dict(state_dict)
    if not any(k.startswith(EMA_PREFIX) for k in sd):
        return None, None
    num_updates = sd.get(EMA_PREFIX + "num_updates")
    out = {k: sd.get(ema_buffer_name(k), v) for k, v in sd.items() if k.startswith("model.")}
    return out, None if num_updates is None else int(num_updates)


EMA_PREFIX = "model_ema."


def ema_buffer_name(key: str) -> str:
    """The LitEma buffer that shadows the state-dict entry `key` ('model.*'):
    the name after 'model.' without its dots, under 'model_ema.'."""
    return EMA_PREFIX + key[len("model."):].replace(".", "")


def torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A Lightning .ckpt's "state_dict", or a torch-saved state dict, as it
    was saved."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd["state_dict"] if isinstance(sd, dict) and "state_dict" in sd else sd


def load_torch_checkpoint(path: str) -> StateDict:
    """A Lightning .ckpt (its "state_dict") or a torch-saved state dict, as
    numpy."""
    return to_numpy_state_dict(torch_state_dict(path))


def _read_checkpoint_dir(path: str, use_ema: bool):
    """(state dict, EMA state dict or None, step) of a directory the port's
    CheckpointManager wrote: a manager directory gives its latest step, a
    step directory that step (the JAX bench's orbax branch)."""
    from mobi_tpu_torch.checkpoint import CheckpointManager, is_step_dir, read_step

    step_dir = os.path.normpath(path)
    if not is_step_dir(step_dir):
        latest = CheckpointManager(step_dir).latest_step()
        if latest is None:
            raise NotImplementedError(
                f"{path} holds no checkpoint written by mobi_tpu_torch (an orbax checkpoint of the JAX "
                "package?); the port reads its own CheckpointManager directories and Lightning .ckpt / "
                "torch files. Convert an orbax tree where JAX is installed: restore it with "
                "mobi_tpu.checkpoint.CheckpointManager and load its params through "
                "convert.state_dict_from_jax")
        step_dir = os.path.join(step_dir, str(latest))
    got = read_step(step_dir, parts=("model", "ema") if use_ema else ("model",))
    ema = got.get("ema")
    if ema is not None:
        ema = {UNET_PREFIX + k: v for k, v in ema["shadow"].items()}
    return got["model"], ema, got["step"]


def load_checkpoint(model, path: str, use_ema: bool = False, ignore_keys: Sequence[str] = ()) -> Dict[str, Any]:
    """Load a checkpoint into `model` over its current weights, the keys the
    model has less those under `ignore_keys` (the reference's partial load,
    ddpm.py:196-212; a shape mismatch raises): a reference Lightning .ckpt /
    torch file, with the LitEma overlay when `use_ema` and the file holds
    one, or a directory the port's CheckpointManager wrote (its latest step,
    or the step directory given), with the saved EMA shadow over the UNet
    when `use_ema`. Any other directory (an orbax tree of the JAX package)
    raises NotImplementedError. Returns {"loaded", "missing", "ema",
    "step"} (step None for a file)."""
    from mobi_tpu_torch.checkpoint import delete_by_prefix

    step = None
    if os.path.isdir(path):
        sd, ema, step = _read_checkpoint_dir(path, use_ema)
    else:
        sd = load_torch_checkpoint(path)
        ema = extract_ema_state_dict(sd)[0] if use_ema else None
    if ema is not None:
        sd = {**sd, **ema}
    sd = delete_by_prefix(sd, ignore_keys)
    own = model.state_dict()
    picked = {k: torch.as_tensor(np.array(v) if isinstance(v, np.ndarray) else v)
              for k, v in sd.items() if k in own}
    model.load_state_dict(picked, strict=False)
    return {"loaded": len(picked), "missing": [k for k in own if k not in picked],
            "ema": ema is not None, "step": step}


def import_lidar_stage_from_config(cfg: Dict, model) -> bool:
    """The reference's auto-load of `lidar_stage_config.params.ckpt_path`
    (mobi_tpu/import_torch.py:488): when the config names a file and uses
    lidar, its range-autoencoder weights (a bare AutoencoderKL checkpoint or
    a whole model's `lidar_stage_model.*`) are loaded into the model's lidar
    VAE; a path that does not exist prints the JAX package's warning and
    changes nothing. Returns whether it loaded."""
    from mobi_tpu_torch.checkpoint import restore_partial

    mp = cfg.get("model", {}).get("params", {})
    lsc = (mp.get("lidar_stage_config") or {}).get("params", {})
    path = lsc.get("ckpt_path")
    if not path or not mp.get("use_lidar", False):
        return False
    if not os.path.exists(path):
        print(
            f"WARNING: lidar_stage_config.params.ckpt_path={path!r} does not "
            "exist — the lidar VAE stays randomly initialized (the reference "
            "would refuse to start). Provide the range autoencoder artifact "
            "or remove ckpt_path."
        )
        return False
    sd = load_torch_checkpoint(path)
    prefix = "lidar_stage_model."
    if not any(k.startswith("encoder.") for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    restore_partial(model, {prefix + k: v for k, v in sd.items()})
    print(f"initialized lidar VAE from {path}")
    return True


# ------------------------------------------------------------ BEVFusion
# The port's copy of mobi_tpu/export_bevfusion.py's mapping: a JAX
# BEVFusionDetector tree -> the reference detector's state dict
# (fusion_models/bevfusion.py:25-77), which `models.bevfusion` loads as it is.

def _f32(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def _bev_conv(v) -> np.ndarray:
    """flax (kH, kW, I, O) -> torch Conv2d (O, I, kH, kW)."""
    return np.ascontiguousarray(_f32(v).transpose(3, 2, 0, 1))


def _bev_deconv(v) -> np.ndarray:
    """flax ConvTranspose (kH, kW, I, O) -> torch ConvTranspose2d
    (I, O, kH, kW), the taps mirrored back (JAX mirrors them)."""
    return np.ascontiguousarray(_f32(v).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])


def _bev_lin(v, conv1d: bool = False) -> np.ndarray:
    """Dense kernel (I, O) -> torch Linear (O, I) / Conv1d (O, I, 1)."""
    a = _f32(v).T
    return a[..., None] if conv1d else np.ascontiguousarray(a)


def _bev_node(tree: Params, *path):
    node = tree
    for k in path:
        node = node[k]
    return node


def _bev_bn(sd: StateDict, dst: str, tree: Params, path, flat_prefix="bn"):
    node = _bev_node(tree, *path) if path else tree
    sd[f"{dst}.weight"] = _f32(node[f"{flat_prefix}_scale"])
    sd[f"{dst}.bias"] = _f32(node[f"{flat_prefix}_bias"])
    sd[f"{dst}.running_mean"] = _f32(node[f"{flat_prefix}_mean"])
    sd[f"{dst}.running_var"] = _f32(node[f"{flat_prefix}_var"])
    sd[f"{dst}.num_batches_tracked"] = np.asarray(0, np.int64)


def _bev_ln(sd: StateDict, dst: str, node: Params):
    sd[f"{dst}.weight"] = _f32(node["scale"])
    sd[f"{dst}.bias"] = _f32(node["bias"])


# --------------------------------------------------------------------- Swin
def _bev_swin(p: Params, prefix: str = "", window: int = 7,
                depths=(2, 2, 6, 2), out_indices=(1, 2, 3)) -> StateDict:
    """Swin-T subtree -> mmdet SwinTransformer entries; the bias table in
    the canonical displacement indexing beside the matching
    `relative_position_index` buffer."""
    sd: StateDict = {}
    sd[f"{prefix}patch_embed.projection.weight"] = _bev_conv(
        p["patch_embed"]["kernel"])
    sd[f"{prefix}patch_embed.projection.bias"] = _f32(p["patch_embed"]["bias"])
    _bev_ln(sd, f"{prefix}patch_embed.norm", p["patch_norm"])

    canon_idx = rel_pos_index(window)
    dim0 = p["patch_embed"]["kernel"].shape[-1]
    for s, depth in enumerate(depths):
        for b in range(depth):
            blk = p[f"stage{s}_block{b}"]
            dst = f"{prefix}stages.{s}.blocks.{b}"
            _bev_ln(sd, f"{dst}.norm1", blk["norm1"])
            _bev_ln(sd, f"{dst}.norm2", blk["norm2"])
            attn = blk["attn"]
            sd[f"{dst}.attn.w_msa.qkv.weight"] = _bev_lin(attn["qkv"]["kernel"])
            sd[f"{dst}.attn.w_msa.qkv.bias"] = _f32(attn["qkv"]["bias"])
            sd[f"{dst}.attn.w_msa.proj.weight"] = _bev_lin(attn["proj"]["kernel"])
            sd[f"{dst}.attn.w_msa.proj.bias"] = _f32(attn["proj"]["bias"])
            sd[f"{dst}.attn.w_msa.relative_position_bias_table"] = _f32(
                attn["rel_bias"])
            sd[f"{dst}.attn.w_msa.relative_position_index"] = canon_idx
            sd[f"{dst}.ffn.layers.0.0.weight"] = _bev_lin(blk["fc1"]["kernel"])
            sd[f"{dst}.ffn.layers.0.0.bias"] = _f32(blk["fc1"]["bias"])
            sd[f"{dst}.ffn.layers.1.weight"] = _bev_lin(blk["fc2"]["kernel"])
            sd[f"{dst}.ffn.layers.1.bias"] = _f32(blk["fc2"]["bias"])
        if f"merge{s}" in p:
            c = dim0 * (2 ** s)
            unfold_of_block = (0, 2, 1, 3)
            perm = np.concatenate(
                [np.arange(c) * 4 + unfold_of_block[blk_i] for blk_i in range(4)]
            )
            inv = np.argsort(perm)
            red = _f32(p[f"merge{s}"]["reduction"]["kernel"])[inv]
            sd[f"{prefix}stages.{s}.downsample.reduction.weight"] = (
                np.ascontiguousarray(red.T))
            sd[f"{prefix}stages.{s}.downsample.norm.weight"] = _f32(
                p[f"merge{s}"]["norm"]["scale"])[inv]
            sd[f"{prefix}stages.{s}.downsample.norm.bias"] = _f32(
                p[f"merge{s}"]["norm"]["bias"])[inv]
    for s in out_indices:
        _bev_ln(sd, f"{prefix}norm{s}", p[f"out_norm{s}"])
    return sd


# ---------------------------------------------------------------- camera FPN
def _bev_lss_fpn(p: Params, prefix: str, num_levels: int = 2) -> StateDict:
    sd: StateDict = {}
    for i in range(num_levels):
        for ours, dst in ((f"lateral{i}", f"lateral_convs.{i}"),
                          (f"fpn{i}", f"fpn_convs.{i}")):
            sd[f"{prefix}{dst}.conv.weight"] = _bev_conv(
                p[ours]["conv"]["kernel"])
            _bev_bn(sd, f"{prefix}{dst}.bn", p, [ours])
    return sd


# ------------------------------------------------------------- DepthLSS
def _bev_depth_lss(p: Params, prefix: str) -> StateDict:
    sd: StateDict = {}
    for ours, conv_i, bn_i in (("dt_conv0", 0, 1), ("dt_conv1", 3, 4),
                               ("dt_conv2", 6, 7)):
        sd[f"{prefix}dtransform.{conv_i}.weight"] = _bev_conv(p[ours]["kernel"])
        sd[f"{prefix}dtransform.{conv_i}.bias"] = _f32(p[ours]["bias"])
        _bev_bn(sd, f"{prefix}dtransform.{bn_i}", p, [],
                flat_prefix=ours.replace("conv", "bn"))
    for ours, conv_i in (("dn_conv0", 0), ("dn_conv1", 3), ("dn_out", 6)):
        sd[f"{prefix}depthnet.{conv_i}.weight"] = _bev_conv(p[ours]["kernel"])
        sd[f"{prefix}depthnet.{conv_i}.bias"] = _f32(p[ours]["bias"])
    _bev_bn(sd, f"{prefix}depthnet.1", p, [], flat_prefix="dn_bn0")
    _bev_bn(sd, f"{prefix}depthnet.4", p, [], flat_prefix="dn_bn1")
    if "ds_conv0" in p:
        for ours, conv_i, bn_i in (("ds_conv0", 0, 1), ("ds_conv1", 3, 4),
                                   ("ds_conv2", 6, 7)):
            sd[f"{prefix}downsample.{conv_i}.weight"] = _bev_conv(
                p[ours]["conv"]["kernel"])
            _bev_bn(sd, f"{prefix}downsample.{bn_i}", p, [ours])
    return sd


# --------------------------------------------------------- sparse encoder
def _bev_spconv(v, kernel_size) -> np.ndarray:
    """ours [K, Cin, Cout] -> spconv weight (*kernel_size, in, out)."""
    a = _f32(v)
    return a.reshape(tuple(kernel_size) + a.shape[-2:])


def _bev_sparse_encoder(p: Params, prefix: str) -> StateDict:
    """basicblock plan, kernels (3,3,3) everywhere except conv_out's
    (3,1,1) (sparse_encoder.py:121-133)."""
    sd: StateDict = {}

    def convmodule(ours_path, dst, kernel_size=(3, 3, 3)):
        node = _bev_node(p, *ours_path)
        sd[f"{dst}.0.weight"] = _bev_spconv(node["kernel"], kernel_size)
        _bev_bn(sd, f"{dst}.1", p, ours_path)

    def basicblock(ours_path, dst):
        node = _bev_node(p, *ours_path)
        for ours, conv, bn in (("conv1", "conv1", "bn1"),
                               ("conv2", "conv2", "bn2")):
            sd[f"{dst}.{conv}.weight"] = _bev_spconv(
                node[ours]["kernel"], (3, 3, 3))
            _bev_bn(sd, f"{dst}.{bn}", p, ours_path + [ours])

    convmodule(["conv_input"], f"{prefix}conv_input")
    stage_layouts = ((2, True), (2, True), (2, True), (2, False))
    for i, (n_blocks, has_down) in enumerate(stage_layouts):
        dst_stage = f"{prefix}encoder_layers.encoder_layer{i + 1}"
        for j in range(n_blocks):
            basicblock([f"stage{i}_block{j}"], f"{dst_stage}.{j}")
        if has_down:
            convmodule([f"stage{i}_down"], f"{dst_stage}.{n_blocks}")
    convmodule(["conv_out"], f"{prefix}conv_out", kernel_size=(3, 1, 1))
    return sd


# ------------------------------------------------------------ dense blocks
def _bev_second(p: Params, prefix: str, layer_nums=(5, 5)) -> StateDict:
    sd: StateDict = {}
    for i, n in enumerate(layer_nums):
        for j in range(n + 1):
            conv_i = 3 * j
            node = p[f"stage{i}_conv{j}"]
            sd[f"{prefix}blocks.{i}.{conv_i}.weight"] = _bev_conv(
                node["conv"]["kernel"])
            _bev_bn(sd, f"{prefix}blocks.{i}.{conv_i + 1}", p,
                    [f"stage{i}_conv{j}"])
    return sd


def _bev_second_fpn(p: Params, prefix: str, upsample_strides=(1, 2)) -> StateDict:
    sd: StateDict = {}
    for i, s in enumerate(upsample_strides):
        if s > 1:
            sd[f"{prefix}deblocks.{i}.0.weight"] = _bev_deconv(
                p[f"deblock{i}_up"]["kernel"])
        else:
            sd[f"{prefix}deblocks.{i}.0.weight"] = _bev_conv(
                p[f"deblock{i}_conv"]["kernel"])
        _bev_bn(sd, f"{prefix}deblocks.{i}.1", p, [],
                flat_prefix=f"deblock{i}_bn")
    return sd


def _bev_fuser(p: Params, prefix: str, camera_channels: int = 80,
                 lidar_c: int = 128, lidar_d: int = 2) -> StateDict:
    """JAX's z-major lidar input-channel block permuted to the reference's
    C-major, D-minor dense() flattening; with camera_channels=0 the whole
    input is the lidar block (a lidar-only detector's fuser)."""
    w = _f32(p["fuse"]["conv"]["kernel"])  # [kH, kW, In, Out]
    n_lidar = lidar_c * lidar_d
    cam, lid = w[..., :camera_channels, :], w[..., camera_channels:, :]
    assert lid.shape[-2] == n_lidar, (lid.shape, n_lidar)
    z = np.arange(n_lidar) // lidar_c
    c = np.arange(n_lidar) % lidar_c
    perm = c * lidar_d + z
    inv = np.argsort(perm)
    w = np.concatenate([cam, lid[..., inv, :]], axis=-2)
    sd: StateDict = {f"{prefix}0.weight": _bev_conv(w)}
    _bev_bn(sd, f"{prefix}1", p, ["fuse"])
    return sd


# ----------------------------------------------------------------- head
def _bev_head(p: Params, prefix: str,
                            num_decoder_layers: int = 1) -> StateDict:
    sd: StateDict = {}
    sd[f"{prefix}shared_conv.weight"] = _bev_conv(p["shared_conv"]["kernel"])
    sd[f"{prefix}shared_conv.bias"] = _f32(p["shared_conv"]["bias"])

    sd[f"{prefix}heatmap_head.0.conv.weight"] = _bev_conv(
        p["heatmap_conv"]["conv"]["kernel"])
    _bev_bn(sd, f"{prefix}heatmap_head.0.bn", p, ["heatmap_conv"])
    sd[f"{prefix}heatmap_head.1.weight"] = _bev_conv(
        p["heatmap_out"]["kernel"])
    sd[f"{prefix}heatmap_head.1.bias"] = _f32(p["heatmap_out"]["bias"])

    sd[f"{prefix}class_encoding.weight"] = _bev_lin(
        p["class_encoding"]["kernel"], conv1d=True)
    sd[f"{prefix}class_encoding.bias"] = _f32(p["class_encoding"]["bias"])

    for i in range(num_decoder_layers):
        dec = p[f"decoder{i}"]
        dst = f"{prefix}decoder.{i}"
        for ours, attn in (("self_attn", "self_attn"),
                           ("cross_attn", "multihead_attn")):
            node = dec[ours]
            sd[f"{dst}.{attn}.in_proj_weight"] = np.concatenate(
                [_f32(node[n]["kernel"]).T for n in ("q", "k", "v")], axis=0)
            sd[f"{dst}.{attn}.in_proj_bias"] = np.concatenate(
                [_f32(node[n]["bias"]) for n in ("q", "k", "v")], axis=0)
            sd[f"{dst}.{attn}.out_proj.weight"] = _bev_lin(node["out"]["kernel"])
            sd[f"{dst}.{attn}.out_proj.bias"] = _f32(node["out"]["bias"])
        for n in ("norm1", "norm2", "norm3"):
            _bev_ln(sd, f"{dst}.{n}", dec[n])
        for n in ("linear1", "linear2"):
            sd[f"{dst}.{n}.weight"] = _bev_lin(dec[n]["kernel"])
            sd[f"{dst}.{n}.bias"] = _f32(dec[n]["bias"])
        for pe in ("self_posembed", "cross_posembed"):
            head = f"{dst}.{pe}.position_embedding_head"
            sd[f"{head}.0.weight"] = _bev_lin(dec[pe]["fc1"]["kernel"],
                                              conv1d=True)
            sd[f"{head}.0.bias"] = _f32(dec[pe]["fc1"]["bias"])
            _bev_bn(sd, f"{head}.1", dec, [pe])
            sd[f"{head}.3.weight"] = _bev_lin(dec[pe]["fc2"]["kernel"],
                                              conv1d=True)
            sd[f"{head}.3.bias"] = _f32(dec[pe]["fc2"]["bias"])

        pred = p[f"pred{i}"]
        dst_p = f"{prefix}prediction_heads.{i}"
        for name in ("center", "height", "dim", "rot", "vel", "heatmap"):
            sd[f"{dst_p}.{name}.0.conv.weight"] = _bev_lin(
                pred[f"{name}_fc"]["kernel"], conv1d=True)
            sd[f"{dst_p}.{name}.0.conv.bias"] = _f32(pred[f"{name}_fc"]["bias"])
            _bev_bn(sd, f"{dst_p}.{name}.0.bn", pred, [],
                    flat_prefix=f"{name}_bn")
            sd[f"{dst_p}.{name}.1.weight"] = _bev_lin(
                pred[f"{name}_out"]["kernel"], conv1d=True)
            sd[f"{dst_p}.{name}.1.bias"] = _f32(pred[f"{name}_out"]["bias"])
    return sd


def bevfusion_state_dict_numpy(params: Params, use_camera: bool = True) -> StateDict:
    """A JAX BEVFusionDetector tree (numpy leaves) -> the reference-layout
    state dict (numpy values), key for key the JAX exporter's. A lidar-only
    tree keeps its fuser (camera_channels=0)."""
    sd: StateDict = {}
    if use_camera:
        sd.update(_bev_swin(params["camera_backbone"],
                              "encoders.camera.backbone."))
        sd.update(_bev_lss_fpn(params["camera_neck"],
                                 "encoders.camera.neck."))
        sd.update(_bev_depth_lss(params["vtransform"],
                                   "encoders.camera.vtransform."))
    sd.update(_bev_sparse_encoder(params["lidar_encoder"],
                                    "encoders.lidar.backbone."))
    sd.update(_bev_fuser(params["fuser"], "fuser.",
                           camera_channels=80 if use_camera else 0))
    sd.update(_bev_second(params["backbone"], "decoder.backbone."))
    sd.update(_bev_second_fpn(params["neck"], "decoder.neck."))
    sd.update(_bev_head(params["head"], "heads.object."))
    return sd


def bevfusion_state_dict(params: Params, use_camera: bool = True) -> Dict[str, torch.Tensor]:
    """A JAX BEVFusionDetector tree -> the port's state dict (reference
    names, torch tensors) for `BEVFusionDetector.load_state_dict(...,
    strict=True)`."""
    return {k: torch.from_numpy(np.array(v))  # a writable copy
            for k, v in bevfusion_state_dict_numpy(params, use_camera).items()}


def centerpoint_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """A JAX CenterHeadTPU tree (mobi_tpu/models/centerpoint.py) -> the
    port's `CenterHead` state dict: `shared_conv` -> `shared_conv.conv`,
    `task_head/<head>_conv<i>` -> `task_heads.0.<head>.<i>.conv`,
    `task_head/<head>_out` -> `task_heads.0.<head>.<num_conv - 1>`."""
    sd: StateDict = {"shared_conv.conv.weight": _bev_conv(params["shared_conv"]["kernel"]),
                     "shared_conv.conv.bias": _f32(params["shared_conv"]["bias"])}
    task = params["task_head"]
    for name in sorted({k.rsplit("_", 1)[0] for k in task}):
        i = 0
        while f"{name}_conv{i}" in task:
            sd[f"task_heads.0.{name}.{i}.conv.weight"] = _bev_conv(task[f"{name}_conv{i}"]["kernel"])
            sd[f"task_heads.0.{name}.{i}.conv.bias"] = _f32(task[f"{name}_conv{i}"]["bias"])
            i += 1
        sd[f"task_heads.0.{name}.{i}.weight"] = _bev_conv(task[f"{name}_out"]["kernel"])
        sd[f"task_heads.0.{name}.{i}.bias"] = _f32(task[f"{name}_out"]["bias"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def save_reference_checkpoint(state_dict, path: str) -> str:
    """Write `{"state_dict": ...}` as a .pth, the layout of the reference's
    `bevfusion-det.pth` (a detector's `state_dict()`, or this module's
    conversion of a JAX tree)."""
    torch.save({"state_dict": {k: (v.detach().cpu() if isinstance(v, torch.Tensor)
                                   else torch.from_numpy(np.ascontiguousarray(v)))
                               for k, v in state_dict.items()}}, path)
    return path


# ------------------------------------------------------- legacy surfaces


def _leaves(tree: Params, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _renamed(params: Params, rules: Sequence[Tuple[str, str]]) -> Dict[str, torch.Tensor]:
    """Every leaf of a JAX tree under its port name: the path joined by "/"
    without flax's `Dense_0` / `Conv_0` wrappers, each (pattern,
    replacement) of `rules` applied in turn (re.sub), then `kernel` ->
    `weight` (Dense and Conv layouts converted) and `scale` -> `weight`,
    "/" -> "."."""
    out = {}
    for path, v in _leaves(params):
        name = "/".join(p for p in path if p not in ("Dense_0", "Conv_0"))
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        v = np.asarray(v)
        if name.endswith("/kernel"):
            name, v = name[:-len("kernel")] + "weight", (_conv(v) if v.ndim == 4 else _linear(v))
        elif name.endswith("/scale"):
            name = name[:-len("scale")] + "weight"
        out[name.replace("/", ".")] = torch.from_numpy(np.array(v, np.float32))
    return out


_RESBLOCK_RULES = (
    (r"^(.+/)in_norm/", r"\1in_layers/0/"), (r"^(.+/)in_conv/", r"\1in_layers/2/"),
    (r"^(.+/)emb_proj/", r"\1emb_layers/1/"), (r"^(.+/)out_norm/", r"\1out_layers/0/"),
    (r"^(.+/)out_conv/", r"\1out_layers/3/"),
)


def encoder_unet_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """A JAX EncoderUNetModel tree -> the port's state dict: the ResBlocks,
    down-samplers and time embedding under UNetModel's names
    (`input_blocks.{i}.0.in_layers.0`, ...), a trunk attention at
    `input_blocks.{i}.1` (`norm`, `attn.to_q`, `attn.to_out.0`), the middle
    ResBlocks at `middle_block.0` / `.2`, the heads under their JAX names."""
    return _renamed(params, (
        (r"^time_embed_(\d)/", r"time_embed/\1/"),
        (r"^input_blocks_0_conv/", "input_blocks/0/0/"),
        (r"^input_blocks_(\d+)_(res|down)/", r"input_blocks/\1/0/"),
        (r"^input_blocks_(\d+)_attn_norm/", r"input_blocks/\1/1/norm/"),
        (r"^input_blocks_(\d+)_attn/", r"input_blocks/\1/1/attn/"),
        (r"^middle_block_(\d)/", r"middle_block/\1/"),
        (r"/to_out/", "/to_out/0/"),
    ) + _RESBLOCK_RULES)


def vq_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """A JAX VQModel / VQModelInterface tree (or a VQEncoder's or
    VQDecoder's alone) -> the port's state dict: `down_0_block_1` ->
    `down.0.block.1`, `up_2_upsample` -> `up.2.upsample`, `mid_attn_1` ->
    `mid.attn_1`, the codebook -> `quantize.embedding.weight`."""
    return _renamed(params, (
        (r"(down|up)_(\d+)_(block|attn)_(\d+)/", r"\1/\2/\3/\4/"),
        (r"(down|up)_(\d+)_(downsample|upsample)/", r"\1/\2/\3/"),
        (r"mid_(block_\d|attn_\d)/", r"mid/\1/"),
        (r"^quantize/embedding$", "quantize/embedding/weight"),
    ))


def clip_text_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """A JAX CLIPTextTower tree -> the port's state dict under HF
    CLIPTextModel's names (`text_model.embeddings.token_embedding.weight`,
    `text_model.encoder.layers.{i}.self_attn.q_proj`, `layer_norm1`,
    `mlp.fc1`, `text_model.final_layer_norm`)."""
    return _renamed(params, (
        (r"^layer_(\d+)_(q|k|v|out)/", r"text_model/encoder/layers/\1/self_attn/\2_proj/"),
        (r"^layer_(\d+)_ln(\d)/", r"text_model/encoder/layers/\1/layer_norm\2/"),
        (r"^layer_(\d+)_(fc\d)/", r"text_model/encoder/layers/\1/mlp/\2/"),
        (r"^final_layernorm/", "text_model/final_layer_norm/"),
        (r"^(token|position)_embedding$", r"text_model/embeddings/\1_embedding/weight"),
    ))


def class_embedder_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """A JAX ClassEmbedder tree -> {"text_embeddings": table}."""
    return _renamed(params, ())


def text_transformer_state_dict(params: Params) -> Dict[str, torch.Tensor]:
    """A JAX TransformerWrapper, BERTEmbedder (under `transformer.`) or
    SpatialRescaler tree -> the port's state dict: `block_3` -> `block.3`,
    the embedding tables -> `token_emb.weight` / `pos_emb.weight`."""
    return _renamed(params, (
        (r"(^|/)block_(\d+)/", r"\1block/\2/"),
        (r"(token_emb|pos_emb)$", r"\1/weight"),
    ))
