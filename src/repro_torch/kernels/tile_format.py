"""Tile-local balanced-sparse weight format — torch counterpart of
`repro.kernels.tile_format`.

Each output row's nonzeros are re-partitioned by ``bn``-wide column blocks
of the input dimension, exactly the blocks the kernels walk:

* ``values[O, NB, KB]``  — nonzero values, zero-padded per block
* ``indices[O, NB, KB]`` — *block-local* column indices in ``[0, bn)``
* ``counts[O, NB]``      — true nonzeros per (row, block)

``KB`` is the per-block capacity (max count rounded up to 8).  Pad slots
carry value 0 / index 0, so a decode that *adds* needs no count masking.
A packed encoding (column-combining, Kung et al.) stores the input-column
permutation in ``perm`` (packed position -> original padded column).

Block quantization (`quantize_tiled`): one f32 absmax scale per (row,
block), ``scales[O, NB]``, and the values as int8 ``[O, NB, KB]`` or int4
nibble-packed two per byte, uint8 ``[O, NB, ceil(KB/2)]`` (low nibble =
slot 2i).  `dequantize_values` is the reconstruction ``float(q) * scale``
that the quant kernels compute on chip, bit for bit.

The encoders run as tensor ops on the tensors' device (the plan builds on
the GPU at full width) and produce encodings identical to the reference's
host encoders, array for array.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

_KB_ROUND = 8

# Per-block symmetric quantization grids: one f32 absmax scale per
# (row, bn-block), narrow two's-complement values.
QUANT_QMAX = {"int8": 127, "int4": 7}
QUANT_MODES = ("none",) + tuple(QUANT_QMAX)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class TiledBalanced:
    """Block-partitioned balanced-sparse matrix (see module docstring).

    Leaves may carry leading stacked axes (``[L, O, NB, KB]``; ``perm``
    broadcast to ``[L, NB*bn]``).  When ``quant != "none"``, ``values``
    holds the narrow encoding (int8 ``[..., O, NB, KB]``; int4 uint8
    ``[..., O, NB, ceil(KB/2)]``) and ``scales`` the f32 per-block scales
    ``[..., O, NB]``.
    """
    values: Tensor           # [..., O, NB, KB] (narrower for int4)
    indices: Tensor          # [..., O, NB, KB] int32, block-local
    counts: Tensor           # [..., O, NB] int32
    n_in: int                # dense input dimension (NB * bn >= n_in)
    bn: int                  # column-block width
    perm: Tensor | None = None
    scales: Tensor | None = None
    quant: str = "none"

    @property
    def n_out(self) -> int:
        return self.indices.shape[-3]

    @property
    def nb(self) -> int:
        return self.indices.shape[-2]

    @property
    def kb(self) -> int:
        return self.indices.shape[-1]

    @property
    def k(self) -> int:
        """Total nonzeros per row (the flat format's K)."""
        return int(self.counts.reshape(-1, self.nb)[0].sum())

    def nbytes(self) -> int:
        """Stored bytes of every leaf (what a dispatch streams)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.values, self.indices, self.counts,
                             self.perm, self.scales) if t is not None)

    def live_nbytes(self) -> int:
        """The bytes a product with this encoding must read: each live
        slot's value (half a byte for int4) and index, every per-block
        count and scale (pad slots carry no work)."""
        value = {"int8": 1.0, "int4": 0.5}.get(self.quant,
                                               self.values.element_size())
        live = int(self.counts.sum())
        return int(live * (value + self.indices.element_size())) + sum(
            t.numel() * t.element_size() for t in (self.counts, self.scales)
            if t is not None)

    def to_dense(self) -> Tensor:
        return tiled_to_dense(self)


def leaf_perm(perm: Tensor) -> Tensor:
    """Collapse a lead-broadcast perm leaf ([..., NB*bn]) to one row."""
    return perm.reshape(-1, perm.shape[-1])[0]


def _block_counts(idx: Tensor, nb: int, bn: int) -> Tensor:
    """Per-(row, block) entry counts of flat column indices ``[R, K]``."""
    counts = torch.zeros((idx.shape[0], nb), dtype=torch.int64,
                         device=idx.device)
    blk = torch.div(idx, bn, rounding_mode="floor")
    return counts.scatter_add_(1, blk, torch.ones_like(blk))


def max_block_count(indices, n_in: int, bn: int) -> int:
    """KB for a flat index array ``[R, K]``: max per-(row, block) count,
    rounded up to a multiple of 8."""
    idx = torch.as_tensor(indices).long()
    counts = _block_counts(idx.reshape(-1, idx.shape[-1]), -(-n_in // bn), bn)
    return max(_KB_ROUND, _round_up(int(counts.max()), _KB_ROUND))


def pack_columns(pattern, bn: int) -> Tensor:
    """Column-combining permutation for a sparsity pattern ``[rows, n]``.

    Greedy first-fit-decreasing balancer: columns, heaviest first, go to the
    ``bn``-slot block whose max per-(row, block) count grows the least
    (ties -> the emptiest block -> the lowest block id, the order of the
    reference's ``np.lexsort((fill, newmax))[0]``); leftover slots take the
    padding columns ``[n, NB*bn)`` in order.  Returns int32 ``perm[NB*bn]``
    on the pattern's device, with ``perm[p]`` = original padded column at
    packed position ``p``.

    The greedy step is tensor ops on the pattern's device with one host
    sync at the end, so it costs a few launches per column on the GPU
    instead of a host pass over the whole pooled pattern per column.
    """
    mask = torch.as_tensor(pattern) != 0
    dev = mask.device
    o, n = mask.shape
    nb = -(-n // bn)
    npad = nb * bn
    if nb <= 1:
        return torch.arange(npad, dtype=torch.int32, device=dev)
    order = torch.argsort(-mask.sum(dim=0), stable=True)
    mask_t = mask.t().contiguous()                            # [n, o] bool
    block_rows = torch.zeros((nb, o), dtype=torch.int32, device=dev)
    fill = torch.zeros(nb, dtype=torch.int64, device=dev)
    full = torch.full((nb,), n + 2, dtype=torch.int64, device=dev)
    tiebreak = torch.arange(nb, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.int64, device=dev)
    assign = torch.empty(n, dtype=torch.int64, device=dev)
    for i, c in enumerate(order.tolist()):
        col = mask_t[c]
        if o:
            newmax = (block_rows + col).amax(dim=1).to(torch.int64)
        else:
            newmax = torch.zeros_like(fill)
        newmax = torch.where(fill < bn, newmax, full)
        # lexicographic (newmax, fill, block) as one unique integer key
        b = torch.argmin((newmax * (bn + 1) + fill) * nb + tiebreak)
        block_rows.index_add_(0, b.view(1),
                              col.view(1, -1).to(torch.int32))
        fill.index_add_(0, b.view(1), one)
        assign[i] = b
    assign_h = assign.cpu().numpy()
    order_h = order.cpu().numpy()
    perm = np.empty(npad, np.int64)
    pad = n
    for b in range(nb):
        cols = order_h[assign_h == b]             # in assignment order
        perm[b * bn:b * bn + cols.size] = cols
        rest = bn - cols.size
        perm[b * bn + cols.size:(b + 1) * bn] = np.arange(pad, pad + rest)
        pad += rest
    return torch.as_tensor(perm, dtype=torch.int32, device=dev)


def invert_perm(perm: Tensor) -> Tensor:
    """Inverse permutation: ``inv[original column] = packed position``."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


def encode_tiled(values: Tensor, indices, n_in: int, *, bn: int,
                 kb: int | None = None) -> TiledBalanced:
    """Flat balanced ``(values[O, K], indices[O, K])`` -> `TiledBalanced`.

    Runs on ``values``' device; ``kb`` is measured when not given.  Raises
    when a block holds more than ``kb`` entries.
    """
    o, k = values.shape
    dev = values.device
    nb = -(-n_in // bn)
    idx = torch.as_tensor(indices, device=dev).long()
    if kb is None:
        kb = max_block_count(idx, n_in, bn)
    # stable sort by block id (a no-op on ascending rows; defends against
    # unsorted callers, as the reference does)
    order = torch.argsort(torch.div(idx, bn, rounding_mode="floor"), dim=1,
                          stable=True)
    idx_s = idx.gather(1, order)
    blk = torch.div(idx_s, bn, rounding_mode="floor")
    counts = _block_counts(idx_s, nb, bn)
    if o and int(counts.max()) > kb:
        raise ValueError(f"kb={kb} < max per-block count {int(counts.max())}")
    off = counts.cumsum(dim=1) - counts                      # exclusive
    slot = torch.arange(k, device=dev)[None, :] - off.gather(1, blk)
    rows = torch.arange(o, device=dev)[:, None].expand(o, k)
    ti = torch.zeros((o, nb, kb), dtype=torch.int32, device=dev)
    ti[rows, blk, slot] = (idx_s % bn).to(torch.int32)
    tv = torch.zeros((o, nb, kb), dtype=values.dtype, device=dev)
    tv[rows, blk, slot] = values.gather(1, order)
    return TiledBalanced(tv, ti, counts.to(torch.int32), n_in=n_in, bn=bn)


def pack_int4(q: Tensor) -> Tensor:
    """Pack int values in [-8, 7] two nibbles per byte along the last axis
    (low nibble = slot 2i, high nibble = slot 2i+1).  An odd-length axis
    gets one zero pad slot first: its nibble decodes to 0."""
    if q.shape[-1] % 2:
        q = torch.cat([q, q.new_zeros((*q.shape[:-1], 1))], dim=-1)
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    u = u.reshape(*q.shape[:-1], q.shape[-1] // 2, 2)
    return u[..., 0] | (u[..., 1] << 4)


def unpack_int4(packed: Tensor, kb: int) -> Tensor:
    """Inverse of `pack_int4`: uint8 ``[..., ceil(kb/2)]`` -> int8
    ``[..., kb]`` in [-8, 7] (``(n ^ 8) - 8`` sign-extends a nibble)."""
    q = torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2).to(torch.int8)
    return ((q ^ 8) - 8)[..., :kb]


def quantize_tiled(tb: TiledBalanced, quant: str) -> TiledBalanced:
    """Per-block symmetric quantization of a `TiledBalanced` encoding.

    Each (row, block) gets one f32 scale ``absmax / qmax`` (shape ==
    ``counts``); values become ``round(v / scale)`` (half to even) clipped
    to the grid, int8 one byte per slot, int4 two nibbles per byte.  An
    all-zero block gets scale 0 and every slot 0.  Indices, counts and
    perm are kept; stacked leaves work as they are.  Computed in f32 from
    the stored values, as the reference does, so the result is
    array-equal to its."""
    if quant == "none":
        return tb
    if quant not in QUANT_QMAX:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    if tb.quant != "none":
        raise ValueError(f"encoding is already {tb.quant}-quantized")
    qmax = QUANT_QMAX[quant]
    vals = tb.values.float()
    scales = vals.abs().amax(dim=-1) / qmax                 # counts-shaped
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(vals / safe[..., None]), -qmax, qmax)
    q = torch.where(scales[..., None] > 0, q, torch.zeros_like(q))
    q = q.to(torch.int8)
    qv = q if quant == "int8" else pack_int4(q)
    return TiledBalanced(qv, tb.indices, tb.counts, n_in=tb.n_in, bn=tb.bn,
                         perm=tb.perm, scales=scales, quant=quant)


def dequantize_values(values: Tensor, scales: Tensor | None, quant: str,
                      kb: int) -> Tensor:
    """Narrow block-quant values -> f32 ``float(q) * scale`` per block
    (``kb``, the logical slot count, drops int4's odd-tail pad nibble);
    ``quant == "none"`` returns ``values`` as they are."""
    if quant == "none":
        return values
    q = unpack_int4(values, kb) if quant == "int4" else values
    return q.float() * scales[..., None]


def dequantize_tiled(tb: TiledBalanced) -> TiledBalanced:
    """Quantized encoding -> f32 `TiledBalanced` (quant "none")."""
    if tb.quant == "none":
        return tb
    vals = dequantize_values(tb.values, tb.scales, tb.quant, tb.kb)
    return TiledBalanced(vals, tb.indices, tb.counts, n_in=tb.n_in,
                         bn=tb.bn, perm=tb.perm)


def tiled_to_dense(tb: TiledBalanced) -> Tensor:
    """Densify to ``[..., O, n_in]`` (the inverse of `encode_tiled`).

    Packed encodings are unpermuted back to original column order; pad
    slots add a zero onto some column — harmless under add.  Quantized
    encodings are dequantized first (f32).
    """
    tb = dequantize_tiled(tb)
    nb, bn = tb.nb, tb.bn
    blk = torch.arange(nb, device=tb.indices.device)[:, None] * bn
    cols = blk + tb.indices.long()                       # [..., O, NB, KB]
    if tb.perm is not None:
        cols = leaf_perm(tb.perm).long()[cols]
    lead = tb.values.shape[:-2]                          # (..., O)
    dense = torch.zeros((*lead, nb * bn), dtype=tb.values.dtype,
                        device=tb.values.device)
    dense.scatter_add_(-1, cols.flatten(-2), tb.values.flatten(-2))
    return dense[..., :tb.n_in]


def tiled_to_flat(tb: TiledBalanced):
    """`TiledBalanced` ``[O, NB, KB]`` -> flat ``(values[O, K],
    indices[O, K])`` with ascending global columns.  Raises on an
    unbalanced encoding (unequal per-row totals).  Quantized encodings
    are dequantized first (f32 values)."""
    tb = dequantize_tiled(tb)
    idx, cnt = tb.indices.long(), tb.counts.long()
    o, nb, kb = idx.shape
    totals = cnt.sum(dim=1)
    if o and not bool((totals == totals[0]).all()):
        raise ValueError("unbalanced encoding: per-row totals range "
                         f"{int(totals.min())}..{int(totals.max())} — no "
                         "flat [O, K] representation")
    k = int(totals[0]) if o else 0
    dev = idx.device
    valid = torch.arange(kb, device=dev)[None, None, :] < cnt[:, :, None]
    gcols = torch.arange(nb, device=dev)[None, :, None] * tb.bn + idx
    if tb.perm is not None:
        gcols = leaf_perm(tb.perm).long()[gcols]
    order = torch.argsort((~valid).reshape(o, -1).to(torch.uint8), dim=1,
                          stable=True)[:, :k]
    flat_idx = gcols.reshape(o, -1).gather(1, order)
    flat_vals = tb.values.reshape(o, -1).gather(1, order)
    if tb.perm is not None:
        asc = torch.argsort(flat_idx, dim=1, stable=True)
        flat_idx = flat_idx.gather(1, asc)
        flat_vals = flat_vals.gather(1, asc)
    return flat_vals, flat_idx.to(torch.int32)


def block_imbalance(tb: TiledBalanced) -> float:
    """KB padding slack: capacity / mean block count (1.0 == no waste).

    Balanced pruning keeps this near 1 + O(sqrt(NB/K)); large values mean
    the block width ``bn`` is too fine for the row's nonzero budget.
    """
    mean = float(tb.counts.to(torch.float32).mean())
    return tb.kb / max(mean, 1e-9)


def tiled_storage_bits(tb: TiledBalanced, *, elem_bits: int = 16,
                       count_bits: int = 16) -> int:
    """Storage of the format as the reference models it (values + local
    indices of ``ceil(log2 bn)`` bits + one count word per block).  The
    stored tensors use int32 indices and counts; `TiledBalanced.nbytes`
    gives those bytes."""
    idx_bits = max(1, (tb.bn - 1).bit_length())
    n_slots = tb.n_out * tb.nb * tb.kb
    scale_bits = 0
    if tb.quant != "none":
        elem_bits = {"int8": 8, "int4": 4}[tb.quant]
        scale_bits = tb.n_out * tb.nb * 32
    return n_slots * (elem_bits + idx_bits) \
        + tb.n_out * tb.nb * count_bits + scale_bits
