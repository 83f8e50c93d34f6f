"""Config loading (mobi_tpu utils/config.py): layered YAML, `${key}`
interpolation against the root of the merged tree, dotted `a.b.c=value`
overrides with YAML-typed values, and the translation of a reference-schema
config into the port's `MobiConfig`.

PyYAML is imported by `load_config` and `parse_override` only, so the rest of
the port does not need it.
"""
from __future__ import annotations

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


def mobi_config_from_yaml(cfg: Dict) -> MobiConfig:
    """A reference-schema config tree -> the port's MobiConfig, with the JAX
    package's defaults for absent keys. `attn_backend` is read from the
    unet's params, else from the top level (mobi_tpu utils/config.py:159).
    A true `use_checkpoint` (activation remat of the UNet or the VAE) raises:
    the port has no remat yet, and would run without it."""
    mp = cfg["model"]["params"]
    unet = mp["unet_config"]["params"]
    first = (mp.get("first_stage_config") or {}).get("params", {})
    dd = first.get("ddconfig", {})
    for name, params in (("unet_config", unet), ("first_stage_config", first)):
        if params.get("use_checkpoint", False):
            raise NotImplementedError(
                f"{name} sets use_checkpoint: {params['use_checkpoint']!r}; activation remat is not "
                "ported yet (ROADMAP queue 1 item 5): set it to false")
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
        image_height=cfg.get("image_height", 512),
        range_height=cfg.get("range_height", 512),
        unet_channels=unet.get("model_channels", 320),
        unet_channel_mult=tuple(unet.get("channel_mult", (1, 2, 4, 4))),
        unet_num_res_blocks=unet.get("num_res_blocks", 2),
        unet_attention_resolutions=tuple(unet.get("attention_resolutions", (4, 2, 1))),
        unet_num_heads=unet.get("num_heads", 8),
        attn_backend=unet.get("attn_backend", cfg.get("attn_backend", "auto")),
        context_dim=unet.get("context_dim", 768),
        vae_ch=dd.get("ch", 128),
        vae_ch_mult=tuple(dd.get("ch_mult", (1, 2, 4, 4))),
        vae_num_res_blocks=dd.get("num_res_blocks", 2),
        vae_embed_dim=first.get("embed_dim", 4),
        dtype=dtype,
    )
