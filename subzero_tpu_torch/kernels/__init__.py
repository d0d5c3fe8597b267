"""Kernels written by hand for Hopper, each beside its plain PyTorch
version.  Nothing here builds or imports CUDA code at import time."""
