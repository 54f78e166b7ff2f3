"""PyTorch/CUDA port of the QFT repro, held against the JAX package.

Plain tensor code is PyTorch; every kernel the JAX package wrote in Pallas
for the TPU is a hand-written CUDA kernel for Hopper (``csrc/``), built with
``nvcc`` at first use.  Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``; with no GPU and no CPU request they raise.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
