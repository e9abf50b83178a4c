"""PyTorch/CUDA port of the Sense balanced-sparse stack: serving, the
paper's CNN path and its prune -> retrain training.

The JAX package `repro` is the reference; this package mirrors its module
layout (``configs/ core/ kernels/ engine/ models/ optim/ data/
checkpoint/ runtime/ launch/``) so each counterpart is easy to find.  It imports torch, numpy and the standard
library only — never jax, never `repro`.

The Pallas kernels of the reference become hand-written CUDA kernels
(`kernels/csrc/`), built with nvcc at first use and bound with ctypes.  On
CPU tensors every kernel wrapper runs its plain PyTorch version instead, so
the whole package runs (and is parity-tested) on a machine without a GPU.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
