"""mobi_tpu_torch: the PyTorch/CUDA port of mobi_tpu for one NVIDIA H100.

It mirrors the JAX package's module names (ops/, models/, pipeline.py,
training.py, utils/) and imports torch and numpy, never jax, flax or
mobi_tpu. The TPU kernels on the inference and training paths are CUDA C++
kernels under csrc/, built at first use.
"""
