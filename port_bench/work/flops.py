"""The model's operations, counted once per cell shape over the reference
on the meta device with torch's FlopCounterMode: convolutions, products
and attention's two products, by their shapes (elementwise work is not
counted). The count is the same whatever implements the work.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.reference import cond as C
from port_bench.reference import diffusion as D
from port_bench.reference.unet import unet
from port_bench.reference.vae import decode, encode

META = torch.device("meta")


def meta_params(layout: Mapping, requires_grad: Iterable[str] = ()) -> Dict[str, torch.Tensor]:
    grad = set(requires_grad)
    return {n: torch.empty(shape, device=META).requires_grad_(n in grad) for n, (shape, _) in layout.items()}


def count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _e(*shape):
    return torch.empty(shape, device=META)


def _cond(arch, rows: int) -> Dict[str, torch.Tensor]:
    s = arch["ref_image_size"]
    c = {"ref_image": _e(rows, s, s, 3)}
    if "ref_bbox" in arch["cond_stage_key"]:
        c["ref_bbox"] = _e(rows, 8, 3)
    return c


def _down(arch) -> int:
    return 2 ** (len(arch["vae_ch_mult"]) - 1)


def _stages(arch):
    out = []
    if arch["use_camera"]:
        out.append(("first_stage_model", 3, arch["image_height"]))
    if arch["use_lidar"]:
        out.append(("lidar_stage_model", 2, arch["range_height"]))
    return out


def inference(arch: Mapping, layout: Mapping, num_steps: int) -> Dict[str, int]:
    """Operations a pair of the inpaint pipeline: the conditioning of each
    of its rows, both encodes of each modality, `num_steps` CFG-doubled
    UNet evaluations, one decode a modality."""
    P = meta_params(layout)
    rows = len(_stages(arch))
    lat = arch["latent_size"]
    split = {"conditioning": count(lambda: C.context(P, arch, _cond(arch, rows)))}
    split["vae_encode"] = sum(2 * count(lambda: encode(P, st, _e(1, ch, s, s))) for st, ch, s in _stages(arch))
    unet_once = count(lambda: unet(P, arch, _e(2 * rows, 9, lat, lat), torch.zeros(2 * rows, dtype=torch.long,
                                                                                  device=META),
                                   _e(2 * rows, len(arch["cond_stage_key"]), arch["context_dim"])))
    split["unet"] = num_steps * unet_once
    split["vae_decode"] = sum(count(lambda: decode(P, st, _e(1, 4, s // _down(arch), s // _down(arch)))) for st, _, s in _stages(arch))
    split["total"] = sum(split.values())
    return split


def training(arch: Mapping, layout: Mapping, pairs: int, trainable: Iterable[str]) -> Dict[str, int]:
    """Operations of one adapter training step at `pairs` pairs: the
    encodes (no gradient), the conditioning and the UNet forward, and the
    backward to the trainable tensors; the optimizer's elementwise update
    is not counted."""
    P = meta_params(layout, trainable)
    rows = len(_stages(arch)) * pairs
    lat = arch["latent_size"]
    batch = {"image": {"GT": _e(pairs, arch["image_height"], arch["image_height"], 3),
                       "inpaint_image": _e(pairs, arch["image_height"], arch["image_height"], 3),
                       "inpaint_mask": _e(pairs, arch["image_height"], arch["image_height"], 1),
                       "cond": _cond(arch, pairs)}}
    if arch["use_lidar"]:
        r = arch["range_height"]
        batch["lidar"] = {"range_data": _e(pairs, r, r, 2), "range_data_inpaint": _e(pairs, r, r, 2),
                          "range_mask": _e(pairs, r, r, 1), "cond": {"ref_bbox": _e(pairs, 8, 3)}}
    noise = [_e(pairs, 4, s // _down(arch), s // _down(arch)) for _, _, s in _stages(arch) for _ in range(2)]
    t = torch.zeros(rows, dtype=torch.long, device=META)

    def step():
        loss = D.training_loss(P, arch, batch, t, _e(rows, lat, lat, 4), False, noise)
        loss.backward()

    return {"step": count(step)}
