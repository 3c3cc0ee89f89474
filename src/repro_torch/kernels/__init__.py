"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

``<name>/ops.py`` picks by the tensor's device: a CPU tensor goes to the
plain version, a CUDA tensor to the CUDA kernel (or raises). There is no
fallback from one to the other.
"""
