"""Bitmap compression formats (Sense §III-C, Fig.8/Fig.12) — torch
counterpart of `repro.core.compression`.

A compressed block is ``(data_length, bitmap, NZE list)``: ``data_length``
is the nonzero count (N_NZEI / N_NZEW), the bitmap flags zero(0)/nonzero(1)
per position, and the NZE list holds values in raster order.

Two views are provided:

* exact numpy codecs (`bitmap_compress` / `bitmap_decompress`) used by the
  storage/DRAM model and tests — true variable-length, like the hardware;
* static-capacity torch codecs (`bitmap_compress_padded`), capacity = block
  size and valid prefix = data_length, the compaction a kernel performs when
  it packs a sparse tile.

`decode_locations` reproduces the paper's coordinate decompression used for
``Psum_addr = (I_row - W_row) * Wo + (I_col - W_col)`` (Fig.10).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class CompressedBlock:
    """Exact (variable-length) compressed block, one per IFM tile / kernel."""
    length: int          # N_NZE
    bitmap: np.ndarray   # bool, original block shape
    values: np.ndarray   # [length] nonzero values, raster order
    shape: tuple         # original block shape

    @property
    def numel(self) -> int:
        return int(np.prod(self.shape))


def bitmap_compress(block: np.ndarray) -> CompressedBlock:
    arr = np.asarray(block)
    bitmap = arr != 0
    values = arr[bitmap]
    return CompressedBlock(length=int(values.size), bitmap=bitmap,
                           values=values, shape=arr.shape)


def bitmap_decompress(c: CompressedBlock) -> np.ndarray:
    out = np.zeros(c.shape, dtype=c.values.dtype if c.values.size
                   else np.float32)
    out[c.bitmap] = c.values
    return out


def compressed_bits(numel: int, nnz: int, *, elem_bits: int = 16,
                    length_bits: int = 16) -> int:
    """Storage cost of one compressed block in bits (Fig.8 layout:
    length word + one bitmap bit per element + the NZE list)."""
    return length_bits + numel + nnz * elem_bits


def compression_ratio(numel: int, nnz: int, *, elem_bits: int = 16) -> float:
    """dense_bits / compressed_bits — >1 means the format saves DRAM."""
    dense = numel * elem_bits
    return dense / compressed_bits(numel, nnz, elem_bits=elem_bits)


# ---------------------------------------------------------------------------
# Balanced-format storage (flat vs tile-local) — feeds the DRAM model
# ---------------------------------------------------------------------------

def balanced_flat_bits(n_out: int, k: int, n_in: int, *,
                       elem_bits: int = 16) -> int:
    """Storage of the flat balanced format ``(values[O,K], indices[O,K])``:
    every index addresses the full input dimension (``ceil(log2 N)`` bits)."""
    idx_bits = max(1, (max(n_in, 2) - 1).bit_length())
    return n_out * k * (elem_bits + idx_bits)


def balanced_tiled_bits(n_out: int, nb: int, kb: int, bn: int, *,
                        elem_bits: int = 16, count_bits: int = 16) -> int:
    """Storage of the tile-local balanced format ``[O, NB, KB]`` blocks:
    block-local indices need only ``ceil(log2 bn)`` bits, plus a per-block
    count word."""
    idx_bits = max(1, (max(bn, 2) - 1).bit_length())
    return n_out * nb * (kb * (elem_bits + idx_bits) + count_bits)


# ---------------------------------------------------------------------------
# Static-shape codecs — the on-chip tile view
# ---------------------------------------------------------------------------

def _nonzero_first(flat: Tensor) -> Tensor:
    """Positions of ``flat``'s nonzeros first, raster order kept (stable)."""
    return torch.argsort((flat == 0).to(torch.uint8), stable=True)


def bitmap_compress_padded(block: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Compress a block into ``(length, bitmap, padded_values)`` with static
    shapes: ``padded_values`` has the block's full size, the first
    ``length`` entries are the NZEs in raster order, the rest zero."""
    flat = block.reshape(-1)
    bitmap = flat != 0
    length = bitmap.to(torch.int32).sum()
    packed = flat[_nonzero_first(flat)]
    packed = torch.where(torch.arange(flat.numel(), device=flat.device)
                         < length, packed, torch.zeros((), dtype=flat.dtype,
                                                       device=flat.device))
    return length, bitmap.reshape(block.shape), packed


def bitmap_decompress_padded(length: Tensor, bitmap: Tensor,
                             packed: Tensor) -> Tensor:
    """Inverse of `bitmap_compress_padded` (static shapes)."""
    flat_bitmap = bitmap.reshape(-1)
    nz_rank = torch.cumsum(flat_bitmap.to(torch.int32), dim=0) - 1
    gathered = packed[nz_rank.clamp(0, packed.numel() - 1).long()]
    out = torch.where(flat_bitmap, gathered,
                      torch.zeros((), dtype=packed.dtype,
                                  device=packed.device))
    return out.reshape(bitmap.shape)


def decode_locations(bitmap: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Bitmap -> (valid, row, col) location info, padded to block size.

    Rows/cols are the coordinates of the NZEs in raster order — the
    ``(I_row, I_col)`` / ``(W_row, W_col)`` streams of Fig.10.  Entry ``j``
    is valid iff ``j < N_NZE``.
    """
    _, w = bitmap.shape
    flat = bitmap.reshape(-1)
    order = _nonzero_first(flat)
    n = (flat != 0).to(torch.int32).sum()
    valid = torch.arange(flat.numel(), device=flat.device) < n
    rows = torch.div(order, w, rounding_mode="floor").to(torch.int32)
    cols = (order % w).to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=flat.device)
    return valid, torch.where(valid, rows, zero), torch.where(valid, cols,
                                                              zero)


# ---------------------------------------------------------------------------
# FC column format (Fig.12): compress a weight matrix per column
# ---------------------------------------------------------------------------

def compress_fc_columns(w: np.ndarray) -> list[CompressedBlock]:
    """Per-column compression of an FC weight matrix ``[out, in]``: column
    ``c`` (all weights fed by input ``c``) is one compressed block, the
    unit the outer-product dataflow (§III-D) consumes."""
    w = np.asarray(w)
    return [bitmap_compress(w[:, c]) for c in range(w.shape[1])]


def storage_bits_conv(ifm: np.ndarray, w: np.ndarray, *, tile: int = 7,
                      elem_bits: int = 16) -> tuple[int, int]:
    """Compressed storage (bits) of an IFM ``[C,H,W]`` (tiled ``tile x
    tile``) and conv weights ``[Co,Ci,Hk,Wk]`` (one block per kernel)."""
    ifm = np.asarray(ifm)
    w = np.asarray(w)
    i_bits = 0
    c, h, ww = ifm.shape
    for ch in range(c):
        for r0 in range(0, h, tile):
            for c0 in range(0, ww, tile):
                blk = ifm[ch, r0:r0 + tile, c0:c0 + tile]
                i_bits += compressed_bits(blk.size,
                                          int(np.count_nonzero(blk)),
                                          elem_bits=elem_bits)
    w_bits = 0
    co = w.shape[0]
    flat = w.reshape(co, -1)
    for k in range(co):
        w_bits += compressed_bits(flat.shape[1],
                                  int(np.count_nonzero(flat[k])),
                                  elem_bits=elem_bits)
    return i_bits, w_bits
