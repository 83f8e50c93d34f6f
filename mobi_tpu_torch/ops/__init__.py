"""Tensor ops of the port: schedules, distributions, attention and the CUDA
kernels (flash-attention forward and backward, fused GroupNorm + SiLU)."""
