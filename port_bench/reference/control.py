"""The control's precision: the step below the configurations' bf16, fp8
e4m3 (3 mantissa bits), with one scale per tensor that maps its largest
magnitude to e4m3's largest finite value, as fp8 inference scales. Used
through `nn.operand_cast` on every product and convolution operand. The
rounding passes gradients straight through, so a backward runs its products
on the rounded operands it saved."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    rounded = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (rounded - t.detach())
