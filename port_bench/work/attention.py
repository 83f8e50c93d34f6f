"""The flash-attention calls of a UNet forward, by shape, with the
operations and bytes each needs: the yardstick of the attention kernels'
rooflines.

The program routes a UNet attention to its flash kernels when it is
self-attention shaped (Nq == Nk) at 1024 tokens or more (the "auto" rule),
or every routed one with the backend "flash": each transformer's
self-attention and, with both modalities, its two cross-modal attentions
at half the rows. A forward counts QK^T and PV, 4 B H N^2 D operations; a
backward the five products of the recomputing algorithm (S, dP, dV, dQ,
dK), 10 B H N^2 D. Bytes count each input read once and each output
written once, bf16 tensors at 2 bytes and the float32 log-sum-exp and
delta rows at 4.
"""
from __future__ import annotations

from typing import List, Mapping, Tuple

FLASH_MIN_SEQ = 1024

Call = Tuple[int, int, int, int]  # (B, N, H, D)


def unet_calls(arch: Mapping, unet_batch: int) -> List[Call]:
    """(B, N, H, D) of every flash call of one UNet forward, in order."""
    mc, heads, size = arch["unet_channels"], arch["unet_num_heads"], arch["latent_size"]
    mults, nrb, res = list(arch["unet_channel_mult"]), arch["unet_num_res_blocks"], set(arch["unet_attention_resolutions"])
    multimodal = arch["use_camera"] and arch["use_lidar"]
    levels, ds = [], 1
    for level, mult in enumerate(mults):
        levels += [(ds, mult * mc)] * (nrb if ds in res else 0)
        if level != len(mults) - 1:
            ds *= 2
    levels.append((ds, mults[-1] * mc))
    for level, mult in reversed(list(enumerate(mults))):
        levels += [(ds, mult * mc)] * ((nrb + 1) if ds in res else 0)
        if level:
            ds //= 2
    calls = []
    for ds, ch in levels:
        n = (size // ds) ** 2
        if arch.get("attn_backend", "auto") == "flash" or n >= FLASH_MIN_SEQ:
            d = ch // heads
            calls += [(unet_batch, n, heads, d)] + [(unet_batch // 2, n, heads, d)] * (2 if multimodal else 0)
    return calls


def forward_work(call: Call, elt: int = 2) -> Tuple[float, float, float]:
    """(operations, bytes, exponentials) of one forward call."""
    b, n, h, d = call
    return 4.0 * b * h * n * n * d, 4.0 * b * n * h * d * elt, float(b * h * n * n)


def forward_lse_work(call: Call, elt: int = 2) -> Tuple[float, float, float]:
    b, n, h, d = call
    ops, nbytes, exps = forward_work(call, elt)
    return ops, nbytes + 4.0 * b * h * n, exps


def backward_work(call: Call, elt: int = 2) -> Tuple[float, float, float]:
    """Reads q, k, v, dO, lse and delta; writes dq, dk, dv."""
    b, n, h, d = call
    return 10.0 * b * h * n * n * d, 7.0 * b * n * h * d * elt + 8.0 * b * h * n, float(b * h * n * n)


def bound_s(work: Tuple[float, float, float], peaks: Mapping) -> float:
    """The least time of the two physical roofs: operations at the bf16
    peak, bytes at HBM bandwidth."""
    return max(work[0] / peaks["bf16_flops_per_s"], work[1] / peaks["hbm_bytes_per_s"])
