"""The §VI-F computing-mode switch: sparse mode pays off beyond these zero
fractions (counterpart of `repro.core.sparse_ops`, thresholds only)."""
from __future__ import annotations

import dataclasses

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
