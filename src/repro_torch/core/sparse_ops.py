"""Sparse compute ops: the bridge from Sense's formats to the kernels —
counterpart of `repro.core.sparse_ops`.

Implements the §VI-F computing-mode switch (dense vs sparse by sparsity
thresholds) on top of the CUDA kernels, so model code calls one function
and gets the paper's co-designed behavior.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops as kernel_ops
from ..kernels.sparse_conv import sparse_conv2d as _sparse_conv2d
from .pruning import BalancedSparse, to_balanced_sparse

Tensor = torch.Tensor

# §VI-F thresholds: sparse mode pays off beyond these zero fractions.
IFM_SPARSE_THRESHOLD = 0.30
W_SPARSE_THRESHOLD = 0.20


@dataclasses.dataclass(frozen=True)
class SparseLinearSpec:
    """Per-layer computing-mode decision."""
    w_sparsity: float
    ifm_sparsity: float = 0.0

    @property
    def use_sparse(self) -> bool:
        return (self.w_sparsity >= W_SPARSE_THRESHOLD
                or self.ifm_sparsity >= IFM_SPARSE_THRESHOLD)


def sparse_matmul(x: Tensor, sp, *, impl: str = "cuda",
                  block_k: int | None = None) -> Tensor:
    """y = x @ W.T with W in the balanced format.

    A `LayerPlan` runs through the plan engine (`engine.execute.apply_fc`;
    encoding, impl and KB were fixed at plan time).  A flat
    `BalancedSparse` is the ad-hoc path through `kernels.ops.balanced_spmm`
    (the ``cuda`` rung caches its tile encoding per weight); ``block_k``
    pins the tile format's per-block capacity.
    """
    from ..engine.execute import apply_fc
    from ..engine.plan import LayerPlan
    if isinstance(sp, LayerPlan):
        return apply_fc(x, sp)
    return kernel_ops.balanced_spmm(x, sp.values, sp.indices, n_in=sp.n_in,
                                    impl=impl, block_k=block_k)


def mode_switched_matmul(x: Tensor, w_dense: Tensor, spec: SparseLinearSpec,
                         *, impl: str = "cuda") -> Tensor:
    """Dense/sparse mode switch (§VI-F): below thresholds the PE array runs
    dense (address-calc units gated); above, the balanced sparse path."""
    if not spec.use_sparse:
        return (x.float() @ w_dense.float().T).to(x.dtype)
    sp = to_balanced_sparse(w_dense, sparsity=spec.w_sparsity)
    return sparse_matmul(x, sp, impl=impl)


def sparse_conv2d(x: Tensor, sp: BalancedSparse, *, hk: int, wk: int,
                  stride: int = 1, padding: str | int = "SAME",
                  impl: str = "cuda", block_k: int | None = None) -> Tensor:
    """Balanced-sparse convolution (chunked im2col + balanced GEMM)."""
    def matmul_fn(flat, values, indices, n_in):
        return kernel_ops.balanced_spmm(flat, values, indices, n_in=n_in,
                                        impl=impl, block_k=block_k)
    return _sparse_conv2d(x, sp.values, sp.indices, sp.n_in, hk=hk, wk=wk,
                          stride=stride, padding=padding, matmul_fn=matmul_fn)
