"""Network mapping algorithm (Sense §V-D, Tab.III) — counterpart of
`repro.core.mapping` (pure Python, this package's own copy).

Feeds network structure parameters in, architecture configuration parameters
out: per-layer tiling, reuse mode, loop order and NZE maxima.  The emitted
``LayerPlan`` is what the (simulated) top controller walks; ``loop_nest``
reproduces Tab.III's 8-deep loop ordering so tests can check the RIF/RWF
loop-order swap (rows 1 & 4) literally.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

from .dataflow import (DataflowChoice, LayerSpec, Tiling, choose_dataflow,
                       conv_tiling)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    layer: LayerSpec
    tiling: Tiling
    dataflow: DataflowChoice
    n_nzew_max: int           # loaded as a parameter (weights fixed offline)

    @property
    def t_oc_outer(self) -> int:
        # Tab.III header: RIF -> outer=1, inner=T_oc; RWF -> outer=T_oc.
        return 1 if self.dataflow.mode in ("RIF", "ON_CHIP") else self.tiling.t_oc

    @property
    def t_oc_inner(self) -> int:
        return self.tiling.t_oc if self.dataflow.mode in ("RIF", "ON_CHIP") else 1


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    name: str
    layers: tuple


def plan_layer(layer: LayerSpec, *, n_is: int = 7, n_pe: int = 32,
               weight_buffer_bits: int | None = None) -> LayerPlan:
    tiling = conv_tiling(layer, n_is=n_is, n_pe=n_pe)
    dataflow = choose_dataflow(layer, n_is=n_is, n_pe=n_pe,
                               weight_buffer_bits=weight_buffer_bits)
    kernel_numel = (layer.c_i * layer.h_k * layer.w_k
                    if layer.kind == "conv" else layer.c_o)
    n_nzew_max = max(1, round(kernel_numel * (1.0 - layer.w_sparsity)))
    return LayerPlan(layer=layer, tiling=tiling, dataflow=dataflow,
                     n_nzew_max=n_nzew_max)


def plan_network(name: str, layers: Sequence[LayerSpec], *, n_is: int = 7,
                 n_pe: int = 32,
                 weight_buffer_bits: int | None = None) -> NetworkPlan:
    return NetworkPlan(name=name, layers=tuple(
        plan_layer(l, n_is=n_is, n_pe=n_pe,
                   weight_buffer_bits=weight_buffer_bits) for l in layers))


def loop_nest(plan: LayerPlan) -> Iterator[tuple]:
    """Yield Tab.III's loop indices ``(a, b, c, d, e)`` in controller order:

        for a in T_oc_outer:            # row 1
          for b in T_ifm_row:           # row 2
            for c in T_ifm_col:         # row 3
              for d in T_oc_inner:      # row 4
                for e in T_ic:          # row 5
                    MAC over NZE pairs  # rows 6-8 (modeled in systolic.py)

    The a/d swap between RIF and RWF is the whole point: RIF finishes all
    OCs for one output tile before moving; RWF finishes all output tiles for
    one OC.
    """
    t = plan.tiling
    for a in range(plan.t_oc_outer):
        for b in range(t.t_ifm_row):
            for c in range(t.t_ifm_col):
                for d in range(plan.t_oc_inner):
                    for e in range(t.t_ic):
                        yield (a, b, c, d, e)


def oc_visit_order(plan: LayerPlan) -> list[tuple]:
    """(oc_tile, ifm_tile) visit sequence — lets tests assert reuse order."""
    t = plan.tiling
    seq = []
    for a, b, c, d, e in loop_nest(plan):
        if e == 0:
            oc = a if plan.dataflow.mode == "RWF" else d
            seq.append((oc, (b, c)))
    return seq
