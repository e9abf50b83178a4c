"""Parameters from the reference's arrays.

`params_from_numpy` turns a params tree given as numpy arrays (the JAX
package's params after ``jax.tree.map(np.asarray, params)``) into this
package's tensors in the same layout (``[L, n_in, n_out]``, no transpose),
so both packages compute on identical weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":      # ml_dtypes bfloat16: reinterpret
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device)


def params_from_numpy(tree, device=None):
    """Nested dicts of arrays -> the same dicts of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(tree, dev)
