"""The backward shared by the autograd Functions whose gradient is autograd of
a plain version recomputed from the saved inputs (the fused GroupNorm + SiLU,
and flash attention under MOBI_FLASH_BWD=xla), as the JAX package's `_bwd`
rules recompute theirs."""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def grad_of_plain(fn: Callable[..., torch.Tensor], saved: Sequence[torch.Tensor],
                  needs_input_grad: Sequence[bool], dy: torch.Tensor,
                  *extra) -> Tuple[Optional[torch.Tensor], ...]:
    """The gradients of fn(*saved, *extra) against dy, one per saved tensor,
    None where its input needs none."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs_input_grad)]
    with torch.enable_grad():
        y = fn(*inputs, *extra)
    grads = iter(torch.autograd.grad(y, [t for t in inputs if t.requires_grad], dy))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)
