"""State carried between the two packages as NumPy arrays.

`params_from_numpy` turns a tree given as numpy arrays (the JAX package's
params after ``jax.tree.map(np.asarray, params)``) into this package's
tensors in the same layout (``[L, n_in, n_out]``, no transpose), so both
packages compute on identical weights.  The same call carries the other
training state: pruning masks, the AdamW state (``m``, ``v`` and the int32
``step``, a 0-d array).  `tree_to_numpy` goes the other way (bf16 leaves as
f32, which holds every bf16 value exactly).  The data streams' state is
plain integers (``state_dict`` / ``load_state_dict``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.array(a, order="C")          # a copy; a 0-d array stays 0-d
    if arr.dtype.name == "bfloat16":      # ml_dtypes bfloat16: reinterpret
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree, device=None):
    """Nested dicts of arrays -> the same dicts of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)


def tree_to_numpy(tree):
    """Nested dicts of tensors -> the same dicts of numpy arrays on the
    host (bf16 as f32)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
