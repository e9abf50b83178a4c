"""Plain torch oracles for the kernels (the correctness contract) —
counterpart of `repro.kernels.ref`.  Products accumulate in f32 and the
result is cast to the activation dtype, as the reference's
``preferred_element_type=f32`` dots do."""
from __future__ import annotations

import torch

from .tile_format import TiledBalanced, tiled_to_dense

Tensor = torch.Tensor


def balanced_dense(values: Tensor, indices: Tensor, n_in: int) -> Tensor:
    """Densify a balanced-sparse matrix ``(values[O, K], indices[O, K])``."""
    dense = torch.zeros((values.shape[0], n_in), dtype=values.dtype,
                        device=values.device)
    return dense.scatter_add_(1, indices.long(), values)


def balanced_spmm_ref(x: Tensor, values: Tensor, indices: Tensor) -> Tensor:
    """y = x @ W.T for W balanced-sparse [O, N] (scatter densify + dot)."""
    w = balanced_dense(values, indices, x.shape[-1])
    return (x.float() @ w.float().T).to(x.dtype)


def balanced_spmm_gather(x: Tensor, values: Tensor, indices: Tensor) -> Tensor:
    """Gather ``x`` per (output, nonzero) and reduce: the [M, O, K]
    formulation (no scatter)."""
    xg = x[:, indices.long()]                               # [M, O, K]
    return torch.einsum("mok,ok->mo", xg.float(), values.float()).to(x.dtype)


def tiled_balanced_spmm_ref(x: Tensor, tb: TiledBalanced) -> Tensor:
    """y = x @ W.T for W in the tile-local format (densify + dot)."""
    w = tiled_to_dense(tb)
    return (x[:, :tb.n_in].float() @ w.float().T).to(x.dtype)
