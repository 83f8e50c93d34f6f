"""Config loading (mobi_tpu utils/config.py): layered YAML, `${key}`
interpolation against the root of the merged tree, dotted `a.b.c=value`
overrides with YAML-typed values, the translation of a reference-schema
config into the port's `MobiConfig`, and `instantiate_from_config` for the
dataset targets the port has.

PyYAML is imported by `load_config` and `parse_override` only, so the rest of
the port does not need it.
"""
from __future__ import annotations

import importlib
import re
from typing import Any, Dict, Optional, Sequence

import torch

from mobi_tpu_torch.models.diffusion import MobiConfig

_INTERP = re.compile(r"\$\{([^}]+)\}")


def deep_merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _lookup(root: Dict, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        node = node[part]
    return node


def interpolate(node: Any, root: Dict) -> Any:
    """Replace `${a.b}` strings with the value at that path of `root`; a
    string that is one reference keeps the value's type."""
    if isinstance(node, dict):
        return {k: interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [interpolate(v, root) for v in node]
    if isinstance(node, str):
        m = _INTERP.fullmatch(node.strip())
        if m:
            return _lookup(root, m.group(1))
        return _INTERP.sub(lambda mm: str(_lookup(root, mm.group(1))), node)
    return node


def set_dotted(cfg: Dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def parse_override(s: str):
    """`a.b.c=value` -> (key, YAML-typed value)."""
    import yaml

    key, _, raw = s.partition("=")
    return key.strip(), yaml.safe_load(raw)


def load_config(paths: Sequence[str], overrides: Optional[Sequence[str]] = None) -> Dict:
    """Merge the YAML files left to right (later wins, deep), apply the
    overrides, then interpolate."""
    import yaml

    cfg: Dict = {}
    for p in paths:
        with open(p) as f:
            cfg = deep_merge(cfg, yaml.safe_load(f) or {})
    for s in overrides or ():
        key, value = parse_override(s)
        set_dotted(cfg, key, value)
    return interpolate(cfg, cfg)


# the `target:` paths of the shipped configs that the port can build, each
# with the port's module and class (imported on first use, so the config
# utility does not load the data layer)
TARGETS = {
    "mobi_tpu.data.nuscenes.NuScenesDataset": ("mobi_tpu_torch.data.nuscenes", "NuScenesDataset"),
    "ldm.data.nuscenes.NuScenesDataset": ("mobi_tpu_torch.data.nuscenes", "NuScenesDataset"),
    "mobi_tpu.models.vae.AutoencoderKL": ("mobi_tpu_torch.models.vae", "autoencoder_from_config"),
    "mobi_tpu.models.losses.LidarWithDiscriminator": ("mobi_tpu_torch.models.losses", "LidarWithDiscriminator"),
    "mobi_tpu.models.losses.LPIPSWithDiscriminator": ("mobi_tpu_torch.models.losses", "LPIPSWithDiscriminator"),
}


def instantiate_from_config(node: Dict, **extra) -> Any:
    """`{target: ..., params: {...}}` -> object, for the targets in TARGETS;
    any other target raises."""
    if "target" not in node:
        raise KeyError("Expected key `target` to instantiate.")
    if node["target"] not in TARGETS:
        raise NotImplementedError(f"the port cannot build target {node['target']!r}; "
                                  f"it builds {sorted(TARGETS)}")
    params = dict(node.get("params") or {})
    params.update(extra)
    module, name = TARGETS[node["target"]]
    return getattr(importlib.import_module(module), name)(**params)


def mobi_config_from_yaml(cfg: Dict) -> MobiConfig:
    """A reference-schema config tree -> the port's MobiConfig, with the JAX
    package's defaults for absent keys. `attn_backend` is read from the
    unet's params, else from the top level (mobi_tpu utils/config.py:159);
    the unet's and the first stage's `use_checkpoint` (activation remat) as
    there."""
    mp = cfg["model"]["params"]
    unet = mp["unet_config"]["params"]
    first = (mp.get("first_stage_config") or {}).get("params", {})
    dd = first.get("ddconfig", {})
    conds = mp.get("cond_stage_key", cfg.get("conditions", ["ref_image", "ref_bbox"]))
    if isinstance(conds, str):
        conds = [conds]
    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[cfg.get("precision", "bf16")]
    return MobiConfig(
        timesteps=mp.get("timesteps", 1000),
        linear_start=mp.get("linear_start", 0.00085),
        linear_end=mp.get("linear_end", 0.0120),
        latent_size=mp.get("image_size", 64),
        channels=mp.get("channels", 4),
        scale_factor=mp.get("scale_factor", 1.0),
        lidar_scale_factor=mp.get("lidar_scale_factor", 1.0),
        u_cond_percent=mp.get("u_cond_percent", 0.0),
        use_camera=mp.get("use_camera", True),
        use_lidar=mp.get("use_lidar", False),
        cond_stage_key=tuple(conds),
        range_object_norm=mp.get("range_object_norm", False),
        range_object_norm_scale=mp.get("range_object_norm_scale", 0.75),
        range_int_norm=mp.get("range_int_norm", False),
        image_height=cfg.get("image_height", 512),
        image_width=cfg.get("image_width", 512),
        range_height=cfg.get("range_height", 512),
        range_width=cfg.get("range_width", 512),
        unet_channels=unet.get("model_channels", 320),
        unet_channel_mult=tuple(unet.get("channel_mult", (1, 2, 4, 4))),
        unet_num_res_blocks=unet.get("num_res_blocks", 2),
        unet_attention_resolutions=tuple(unet.get("attention_resolutions", (4, 2, 1))),
        unet_num_heads=unet.get("num_heads", 8),
        unet_use_checkpoint=unet.get("use_checkpoint", False),
        vae_use_checkpoint=first.get("use_checkpoint", False),
        attn_backend=unet.get("attn_backend", cfg.get("attn_backend", "auto")),
        context_dim=unet.get("context_dim", 768),
        vae_ch=dd.get("ch", 128),
        vae_ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        vae_num_res_blocks=dd.get("num_res_blocks", 2),
        vae_embed_dim=first.get("embed_dim", 4),
        dtype=dtype,
    )
