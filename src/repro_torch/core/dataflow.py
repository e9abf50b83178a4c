"""IFM/weight partition + Adaptive Dataflow Configuration (Sense §V) —
counterpart of `repro.core.dataflow` (pure Python, kept as this package's
own copy).

Per layer, OFM traversal order is either channel-first ("Reuse-IFM-First",
RIF: stationary IFM tile, weights re-streamed ``T_ifm_row*T_ifm_col`` times)
or edge-first ("Reuse-Weight-First", RWF: stationary weights, IFM re-streamed
``T_oc`` times):

    D_mem(RIF) = W_mem * T_ifm_row * T_ifm_col + I_mem
    D_mem(RWF) = I_mem * T_oc + W_mem
    D_mem      = I_mem + W_mem          when all weights fit on chip

Sense picks the cheaper one per layer from the *compressed* storage sizes —
the 1.17x~1.8x DRAM-access reduction vs Swallow's fixed RIF (Fig.22).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence

from .compression import compressed_bits

ReuseMode = Literal["RIF", "RWF", "ON_CHIP"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Shape + sparsity description of one CONV/FC layer (the mapping input)."""
    name: str
    kind: Literal["conv", "fc"]
    h_i: int = 1
    w_i: int = 1
    c_i: int = 1
    c_o: int = 1
    h_k: int = 1
    w_k: int = 1
    stride: int = 1
    padding: int = 0
    ifm_sparsity: float = 0.0    # zero fraction of IFMs (dynamic, measured)
    w_sparsity: float = 0.0      # zero fraction of weights (from pruning)

    @property
    def h_o(self) -> int:
        return (self.h_i + 2 * self.padding - self.h_k) // self.stride + 1

    @property
    def w_o(self) -> int:
        return (self.w_i + 2 * self.padding - self.w_k) // self.stride + 1

    @property
    def macs(self) -> int:
        if self.kind == "fc":
            return self.c_i * self.c_o
        return self.h_o * self.w_o * self.c_i * self.c_o * self.h_k * self.w_k

    @property
    def ifm_numel(self) -> int:
        return self.c_i * self.h_i * self.w_i

    @property
    def w_numel(self) -> int:
        if self.kind == "fc":
            return self.c_i * self.c_o
        return self.c_o * self.c_i * self.h_k * self.w_k


@dataclasses.dataclass(frozen=True)
class Tiling:
    """Partition of one layer onto the array (§V-A)."""
    t_ifm_row: int
    t_ifm_col: int
    t_ic: int
    t_oc: int
    n_is: int      # IFM sub-tile edge
    n_pe: int

    @property
    def n_ifm_tiles(self) -> int:
        return self.t_ifm_row * self.t_ifm_col


def conv_tiling(layer: LayerSpec, *, n_is: int = 7, n_pe: int = 32) -> Tiling:
    """Square ``n_is x n_is`` spatial tiles; ``n_pe`` channels per array pass."""
    if layer.kind == "fc":
        return Tiling(1, 1, math.ceil(layer.c_i / n_pe),
                      math.ceil(layer.c_o / n_pe), n_is, n_pe)
    return Tiling(
        t_ifm_row=math.ceil(layer.h_i / n_is),
        t_ifm_col=math.ceil(layer.w_i / n_is),
        t_ic=math.ceil(layer.c_i / n_pe),
        t_oc=math.ceil(layer.c_o / n_pe),
        n_is=n_is, n_pe=n_pe,
    )


# ---------------------------------------------------------------------------
# Compressed storage sizes (bits) — inputs to the D_mem arithmetic
# ---------------------------------------------------------------------------

def ifm_storage_bits(layer: LayerSpec, *, elem_bits: int = 16,
                     compressed: bool = True) -> int:
    numel = layer.ifm_numel
    if not compressed:
        return numel * elem_bits
    nnz = round(numel * (1.0 - layer.ifm_sparsity))
    return compressed_bits(numel, nnz, elem_bits=elem_bits)


def weight_storage_bits(layer: LayerSpec, *, elem_bits: int = 16,
                        compressed: bool = True) -> int:
    numel = layer.w_numel
    if not compressed:
        return numel * elem_bits
    nnz = round(numel * (1.0 - layer.w_sparsity))
    return compressed_bits(numel, nnz, elem_bits=elem_bits)


# ---------------------------------------------------------------------------
# Adaptive Dataflow Configuration (§V-C)
# ---------------------------------------------------------------------------

def dram_access_rif(i_mem: int, w_mem: int, tiling: Tiling) -> int:
    return w_mem * tiling.n_ifm_tiles + i_mem


def dram_access_rwf(i_mem: int, w_mem: int, tiling: Tiling) -> int:
    return i_mem * tiling.t_oc + w_mem


@dataclasses.dataclass(frozen=True)
class DataflowChoice:
    mode: ReuseMode
    d_mem_bits: int
    d_mem_rif: int
    d_mem_rwf: int
    i_mem: int
    w_mem: int


def choose_dataflow(layer: LayerSpec, *, n_is: int = 7, n_pe: int = 32,
                    weight_buffer_bits: int | None = None,
                    elem_bits: int = 16) -> DataflowChoice:
    """Pick RIF vs RWF (vs fully on-chip) minimizing DRAM access.

    ``weight_buffer_bits`` is the on-chip weight buffer capacity; when the
    whole (compressed) weight set fits, weights load once and IFMs are
    stationary: ``D = I + W`` (paper's Layer-3 case).
    """
    tiling = conv_tiling(layer, n_is=n_is, n_pe=n_pe)
    i_mem = ifm_storage_bits(layer, elem_bits=elem_bits)
    w_mem = weight_storage_bits(layer, elem_bits=elem_bits)
    rif = dram_access_rif(i_mem, w_mem, tiling)
    rwf = dram_access_rwf(i_mem, w_mem, tiling)
    if layer.kind == "fc":
        # GEMV: no weight reuse exists; every weight is read once.  §V-C.
        return DataflowChoice("ON_CHIP", i_mem + w_mem, rif, rwf, i_mem, w_mem)
    if weight_buffer_bits is not None and w_mem <= weight_buffer_bits:
        return DataflowChoice("ON_CHIP", i_mem + w_mem, rif, rwf, i_mem, w_mem)
    if rif <= rwf:
        return DataflowChoice("RIF", rif, rif, rwf, i_mem, w_mem)
    return DataflowChoice("RWF", rwf, rif, rwf, i_mem, w_mem)


def swallow_dataflow(layer: LayerSpec, *, n_is: int = 7, n_pe: int = 32,
                     weight_buffer_bits: int | None = None,
                     elem_bits: int = 16) -> DataflowChoice:
    """Swallow's fixed compute-in-row dataflow == always RIF (§VI-D).

    Swallow's matrix-multiplication tiling still keeps weights on-chip when
    they fit (its "reuse within each channel"), so the ON_CHIP shortcut
    applies to it too — the *only* difference vs Sense is the missing RWF
    option.
    """
    tiling = conv_tiling(layer, n_is=n_is, n_pe=n_pe)
    i_mem = ifm_storage_bits(layer, elem_bits=elem_bits)
    w_mem = weight_storage_bits(layer, elem_bits=elem_bits)
    rif = dram_access_rif(i_mem, w_mem, tiling)
    rwf = dram_access_rwf(i_mem, w_mem, tiling)
    if layer.kind == "fc":
        return DataflowChoice("ON_CHIP", i_mem + w_mem, rif, rwf, i_mem, w_mem)
    if weight_buffer_bits is not None and w_mem <= weight_buffer_bits:
        return DataflowChoice("ON_CHIP", i_mem + w_mem, rif, rwf, i_mem, w_mem)
    return DataflowChoice("RIF", rif, rif, rwf, i_mem, w_mem)


def network_dram_access(layers: Sequence[LayerSpec], *, adaptive: bool = True,
                        n_is: int = 7, n_pe: int = 32,
                        weight_buffer_bits: int | None = None) -> dict:
    """Total DRAM traffic for a network under adaptive vs fixed-RIF dataflow.

    Returns totals plus the per-layer mode mix (Fig.22b's RIF/RWF split).
    """
    total = 0
    modes: list[ReuseMode] = []
    per_layer = []
    for layer in layers:
        if adaptive:
            ch = choose_dataflow(layer, n_is=n_is, n_pe=n_pe,
                                 weight_buffer_bits=weight_buffer_bits)
        else:
            ch = swallow_dataflow(layer, n_is=n_is, n_pe=n_pe,
                                  weight_buffer_bits=weight_buffer_bits)
        total += ch.d_mem_bits
        modes.append(ch.mode)
        per_layer.append(ch)
    return {
        "total_bits": total,
        "modes": modes,
        "per_layer": per_layer,
        "frac_rwf": modes.count("RWF") / max(len(modes), 1),
        "frac_rif": modes.count("RIF") / max(len(modes), 1),
    }
