"""Multi-head attention entry point (mobi_tpu ops/attention.py).

`dot_product_attention` serves the UNet transformer blocks, the VAE mid
attention and the CLIP/xf towers. The backends are the JAX package's:
"flash" sends every call to the flash-attention wrapper (which launches the
CUDA kernel on the card), as mobi_tpu ops/attention.py:65-68 does, mask or
no mask; "auto" sends self-attention-shaped calls (Nq == Nk >= FLASH_MIN_SEQ,
no mask) there; every other call, and every "xla" call, takes the plain
fp32-softmax formula, where the JAX package uses XLA.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from mobi_tpu_torch.ops.flash_attention import attention_plain, flash_attention

# The "auto" rule's least sequence length, read at import from the JAX
# package's switch (mobi_tpu ops/attention.py:26), default 1024: flash on
# both the 4096-token (d = 40) and the 1024-token (d = 80) UNet levels.
FLASH_MIN_SEQ = int(os.environ.get("MOBI_FLASH_MIN_SEQ", "1024"))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, H*D] -> [B, N, H, D] (a view where the layout allows)."""
    b, n, hd = x.shape
    return x.reshape(b, n, num_heads, hd // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, N, H, D] -> [B, N, H*D]"""
    b, n, h, d = x.shape
    return x.reshape(b, n, h * d)


def uses_flash(nq: int, nk: int, mask, backend: str) -> bool:
    """Whether a call goes to the flash-attention wrapper."""
    if backend == "xla":
        return False
    if backend == "flash":
        return True
    if backend != "auto":
        raise ValueError(f"unknown attention backend {backend!r}")
    return mask is None and nq >= FLASH_MIN_SEQ and nq == nk


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    num_heads: int,
    mask: Optional[torch.Tensor] = None,
    backend: str = "auto",
) -> torch.Tensor:
    """q: [B, Nq, H*D], k, v: [B, Nk, H*D] -> [B, Nq, H*D].

    mask: optional [B, Nq, Nk] bool (True = keep); the flash path, like the
    JAX kernel, takes none and ignores it. backend: "auto" | "flash" | "xla"
    (the plain formula; the name is the JAX package's)."""
    qh, kh, vh = (split_heads(t, num_heads) for t in (q, k, v))
    if uses_flash(qh.shape[1], kh.shape[1], mask, backend):
        out = flash_attention(qh, kh, vh)
    else:
        out = attention_plain(qh, kh, vh, mask)
    return merge_heads(out)
