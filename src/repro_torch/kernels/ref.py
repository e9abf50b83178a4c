"""Plain torch oracles for the kernels (the correctness contract) —
counterpart of `repro.kernels.ref`.  Products accumulate in f32 and the
result is cast to the activation dtype, as the reference's
``preferred_element_type=f32`` dots do."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .sparse_conv import _pad_nhwc, _resolve_padding
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


def bitmap_dense(bitmap: Tensor, packed: Tensor) -> Tensor:
    """Densify a bitmap-compressed matrix: bitmap ``[O, N]`` {0, 1},
    packed ``[O, K]`` rows of nonzero values in raster order (anything
    past a row's count is padding)."""
    nz_rank = torch.cumsum(bitmap.int(), dim=1) - 1
    nz_rank = nz_rank.clamp(0, packed.shape[1] - 1)
    gathered = packed.gather(1, nz_rank.long())
    return torch.where(bitmap != 0, gathered,
                       gathered.new_zeros(())).to(packed.dtype)


def bitmap_spmm_ref(x: Tensor, bitmap: Tensor, packed: Tensor) -> Tensor:
    """y = x @ W.T for W bitmap-compressed [O, N] (densify + dot)."""
    w = bitmap_dense(bitmap, packed)
    return (x.float() @ w.float().T).to(x.dtype)


def sparse_conv2d_ref(x: Tensor, w_dense: Tensor, *, stride: int = 1,
                      padding: str | int = "SAME") -> Tensor:
    """Dense conv oracle: x [B,H,W,Ci], w [Hk,Wk,Ci,Co] -> [B,Ho,Wo,Co]
    (f32 products and sums, cast to x's dtype)."""
    hk, wk = w_dense.shape[:2]
    xp = _pad_nhwc(x, *_resolve_padding(x.shape[1], x.shape[2], hk, wk,
                                        stride, padding))
    y = F.conv2d(xp.permute(0, 3, 1, 2).float(),
                 w_dense.permute(3, 2, 0, 1).float(), stride=stride)
    return y.permute(0, 2, 3, 1).to(x.dtype)
