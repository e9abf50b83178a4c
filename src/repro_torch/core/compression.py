"""Bitmap compression storage model (Sense §III-C, Fig.8) — the part of
`repro.core.compression` that the plan and the serve report need."""
from __future__ import annotations


def compressed_bits(numel: int, nnz: int, *, elem_bits: int = 16,
                    length_bits: int = 16) -> int:
    """Storage cost of one compressed block in bits (Fig.8 layout:
    length word + one bitmap bit per element + the NZE list)."""
    return length_bits + numel + nnz * elem_bits
