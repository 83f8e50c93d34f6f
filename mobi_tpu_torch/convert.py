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

The evaluation networks (CLIP ViT-B/32, Inception, LPIPS's AlexNet,
RangeNet++) need no flax-to-torch converter: their interchange is the
published torch state dict, which JAX's importers read and the port's
modules load as it is, strict (`eval/*.load_*`, `eval/*.load_published`).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

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
