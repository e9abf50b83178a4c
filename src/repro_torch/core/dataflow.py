"""Adaptive Dataflow Configuration (Sense §V-C) — the part of
`repro.core.dataflow` behind `choose_dataflow`.

Per layer the OFM traversal is channel-first (RIF) or edge-first (RWF),
picked by the cheaper DRAM traffic from compressed storage sizes:

    D_mem(RIF) = W_mem * T_ifm_row * T_ifm_col + I_mem
    D_mem(RWF) = I_mem * T_oc + W_mem
    D_mem      = I_mem + W_mem          for fc layers (GEMVs, ON_CHIP)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

from .compression import compressed_bits

ReuseMode = Literal["RIF", "RWF", "ON_CHIP"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Shape + sparsity description of one CONV/FC layer."""
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
    ifm_sparsity: float = 0.0
    w_sparsity: float = 0.0

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
    t_ifm_row: int
    t_ifm_col: int
    t_ic: int
    t_oc: int
    n_is: int
    n_pe: int

    @property
    def n_ifm_tiles(self) -> int:
        return self.t_ifm_row * self.t_ifm_col


def conv_tiling(layer: LayerSpec, *, n_is: int = 7, n_pe: int = 32) -> Tiling:
    if layer.kind == "fc":
        return Tiling(1, 1, math.ceil(layer.c_i / n_pe),
                      math.ceil(layer.c_o / n_pe), n_is, n_pe)
    return Tiling(t_ifm_row=math.ceil(layer.h_i / n_is),
                  t_ifm_col=math.ceil(layer.w_i / n_is),
                  t_ic=math.ceil(layer.c_i / n_pe),
                  t_oc=math.ceil(layer.c_o / n_pe), n_is=n_is, n_pe=n_pe)


def ifm_storage_bits(layer: LayerSpec, *, elem_bits: int = 16) -> int:
    numel = layer.ifm_numel
    nnz = round(numel * (1.0 - layer.ifm_sparsity))
    return compressed_bits(numel, nnz, elem_bits=elem_bits)


def weight_storage_bits(layer: LayerSpec, *, elem_bits: int = 16) -> int:
    numel = layer.w_numel
    nnz = round(numel * (1.0 - layer.w_sparsity))
    return compressed_bits(numel, nnz, elem_bits=elem_bits)


@dataclasses.dataclass(frozen=True)
class DataflowChoice:
    mode: ReuseMode
    d_mem_bits: int
    d_mem_rif: int
    d_mem_rwf: int
    i_mem: int
    w_mem: int


def choose_dataflow(layer: LayerSpec, *, n_is: int = 7, n_pe: int = 32,
                    elem_bits: int = 16) -> DataflowChoice:
    """Pick RIF vs RWF minimizing DRAM access; fc layers are GEMVs with no
    weight reuse, so every weight is read once (ON_CHIP)."""
    tiling = conv_tiling(layer, n_is=n_is, n_pe=n_pe)
    i_mem = ifm_storage_bits(layer, elem_bits=elem_bits)
    w_mem = weight_storage_bits(layer, elem_bits=elem_bits)
    rif = w_mem * tiling.n_ifm_tiles + i_mem
    rwf = i_mem * tiling.t_oc + w_mem
    if layer.kind == "fc":
        return DataflowChoice("ON_CHIP", i_mem + w_mem, rif, rwf, i_mem, w_mem)
    if rif <= rwf:
        return DataflowChoice("RIF", rif, rif, rwf, i_mem, w_mem)
    return DataflowChoice("RWF", rwf, rif, rwf, i_mem, w_mem)
