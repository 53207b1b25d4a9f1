"""PyTorch/CUDA port of the StatQuant reproduction for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro``; every Pallas TPU kernel on
a ported path becomes a hand-written CUDA kernel under ``csrc/`` with a
plain PyTorch version beside it (``kernels/``).  Entry points run on the
card unless the caller passes ``device="cpu"``, where the plain versions
run instead.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
