"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a missing
GPU is an error, never a silent fallback to CPU execution.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU explicitly")
    return dev


@contextlib.contextmanager
def exact_matmuls():
    """Within the block, cuBLAS and cuDNN without TF32: exact float32
    matmuls and convolutions (the dense yardsticks, the masked-dense
    reference, a train step's forward and backward).  The flags are as
    they were after it."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
