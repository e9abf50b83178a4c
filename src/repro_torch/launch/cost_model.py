"""Deployment-aware DRAM-traffic and energy cost model (DESIGN.md §14) —
counterpart of `repro.launch.cost_model` (pure Python, this package's own
copy; `pytree_nbytes` walks tensors and dicts of tensors).

Sense's Adaptive Dataflow Configuration (§V-C) picks RIF / RWF / ON_CHIP
from compressed storage *ratios*; this module turns that rule into an
explicit per-layer, per-mode accounting of what actually crosses the DRAM
boundary — IFM stream, weight stream (quant-aware byte widths, including
the int8/int4 tile encodings plus their per-block scales), OFM stream and
partial-sum spills — plus an Accelergy-style per-component energy model
(DRAM / on-chip SRAM / MAC; constants documented in DESIGN.md §14 with
provenance).  `engine.plan` uses it as a plan objective
(``plan_model(..., objective=..., deployment=...)``) so dataflow mode and
impl selection co-optimize per deployment instead of reading storage
ratios alone; it also serves the paper-claims comparisons.  The
deployment profiles are models of an accelerator's buffers and DRAM, the
reference's own; none of their numbers describes the GPU this package
runs on.

Two deliberately distinct accounting levels (the model-vs-measurement
contract, DESIGN.md §14):

* **format bits** — what a Sense-style accelerator streams: compressed
  bitmap IFMs, tile-local encodings with ``ceil(log2 bn)``-bit indices
  (`kernels.tile_format.tiled_storage_bits` exactly).  Drives objective
  decisions and the paper-claims CNN comparison.
* **stored bytes** — what *this* runtime actually moves: the encoded
  weights' tensor bytes (f32/bf16 values, int32 indices/counts, f32
  scales, nibble-packed int4), `pytree_nbytes`.  Checked **exactly**
  against the `engine.execute` byte counters (`bytes_stats`).

The tiling that creates reuse is buffer-derived, not PE-array-derived:
an operand larger than its on-chip buffer streams in ``ceil(size /
buffer)`` resident chunks, and the non-stationary operand re-streams once
per chunk.  RWF with a chunked weight set additionally spills partial
sums (write + read at ``psum_bits``) for every chunk beyond the first.
This is the per-component style of Timeloop/Accelergy and of SPOTS-
adjacent accounting (Heo et al., arXiv 2207.00068).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

from ..core.dataflow import LayerSpec, ifm_storage_bits, weight_storage_bits

# ---------------------------------------------------------------------------
# Canonical dtype widths (the reference's one table; `launch.dryrun` sums
# tensor bytes from it)
# ---------------------------------------------------------------------------

DTYPE_BITS: Dict[str, int] = {
    "f64": 64, "float64": 64,
    "f32": 32, "float32": 32,
    "f16": 16, "float16": 16,
    "bf16": 16, "bfloat16": 16,
    "s64": 64, "int64": 64, "u64": 64, "uint64": 64,
    "s32": 32, "int32": 32, "u32": 32, "uint32": 32,
    "s16": 16, "int16": 16, "u16": 16, "uint16": 16,
    "s8": 8, "int8": 8, "u8": 8, "uint8": 8,
    "s4": 4, "int4": 4, "u4": 4, "uint4": 4,
    "pred": 8, "bool": 8,
    "f8e4m3fn": 8, "f8e5m2": 8,
    "c64": 64, "c128": 128,
}

# torch's names where they differ from the table's (``torch.float8_e4m3fn``
# -> ``f8e4m3fn``, the complex types by their total width)
_TORCH_NAMES = {"float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2",
                "complex64": "c64", "complex128": "c128"}


def dtype_bits(dt: Any) -> int:
    """Bit width of an HLO / numpy dtype name, a `torch.dtype` or its name
    (``torch.bfloat16``, ``"torch.bfloat16"``), or anything with a str
    form."""
    key = str(dt).lower()
    if key.startswith("torch."):
        key = key[len("torch."):]
        key = _TORCH_NAMES.get(key, key)
    if key in DTYPE_BITS:
        return DTYPE_BITS[key]
    raise KeyError(f"unknown dtype {dt!r} (add it to cost_model.DTYPE_BITS)")


def dtype_bytes(dt: Any) -> float:
    """Bytes per element; fractional for sub-byte types (s4 -> 0.5)."""
    return dtype_bits(dt) / 8.0


# ---------------------------------------------------------------------------
# Energy table (Accelergy-style per-component constants; DESIGN.md §14)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnergyTable:
    """pJ-per-event constants.  Defaults: DRAM matches
    `core.systolic.SystolicConfig.dram_pj_per_bit` (DDR4 ~20 pJ/bit);
    SRAM/MAC levels follow the Horowitz ISSCC'14 45 nm survey scaled the
    way Accelergy's default plug-ins do (see DESIGN.md §14 for the
    derivation and the TPU-calibration caveat)."""
    dram_pj_per_bit: float = 20.0
    sram_pj_per_bit: float = 0.6       # large on-chip buffer (VMEM-class)
    reg_pj_per_bit: float = 0.06       # PE-local accumulator register
    mac_pj: float = 1.2                # 16-bit multiply-accumulate
    mac_pj_int8: float = 0.35
    mac_pj_int4: float = 0.15

    def mac_energy(self, quant: str = "none") -> float:
        if quant == "int8":
            return self.mac_pj_int8
        if quant == "int4":
            return self.mac_pj_int4
        return self.mac_pj


# ---------------------------------------------------------------------------
# Deployment profiles
# ---------------------------------------------------------------------------

_BRAM36_BITS = 36 * 1024


@dataclasses.dataclass(frozen=True)
class DeploymentProfile:
    """One deployment's memory hierarchy + throughput envelope.

    ``weight_buffer_bits`` is the on-chip capacity available to hold a
    stationary (compressed) weight set, ``ifm_buffer_bits`` the ping-pong
    IFM tile buffer.  An operand bigger than its buffer streams in
    ``ceil(size / buffer)`` chunks and the opposite operand re-streams per
    chunk — the source of every reuse factor in this model.
    """
    name: str = "zcu102"
    weight_buffer_bits: int = 160 * _BRAM36_BITS   # Tab.IV weight BRAM
    ifm_buffer_bits: int = 10 * _BRAM36_BITS       # IFM ping-pong buffer
    act_bits: int = 16
    psum_bits: int = 32
    dram_bytes_per_s: float = 19.2e9               # Tab.IV DDR4 envelope
    peak_macs_per_s: float = 32 * 32 * 200e6       # PE array @ 200 MHz
    batch: int = 1
    energy: EnergyTable = EnergyTable()


#: Named profiles.  ``zcu102`` mirrors the paper's Tab.IV board (and the
#: existing `core.systolic.SystolicConfig` constants); ``tpu-host`` is a
#: generous serving host (plans rarely chunk); ``edge-64k`` is the
#: DRAM-constrained profile — weight buffer far below LLM layer sizes, so
#: ON_CHIP capture is infeasible and the dram objective must re-mode layers.
DEPLOYMENTS: Dict[str, DeploymentProfile] = {
    "zcu102": DeploymentProfile(),
    "tpu-host": DeploymentProfile(
        name="tpu-host",
        weight_buffer_bits=int(64e6 * 8),          # ~64 MB VMEM-class
        ifm_buffer_bits=int(16e6 * 8),
        act_bits=16,
        dram_bytes_per_s=100e9,
        peak_macs_per_s=2e12,
    ),
    "edge-64k": DeploymentProfile(
        name="edge-64k",
        weight_buffer_bits=64 * 1024 * 8,
        ifm_buffer_bits=32 * 1024 * 8,
        act_bits=16,
        dram_bytes_per_s=4e9,
        peak_macs_per_s=64e9,
    ),
    # MCU-class: buffers below even smoke-scaled layer streams, so the dram
    # objective re-modes layers at any model size (the serve --report demo
    # and the BENCH_serve `dram` gate exercise the flip without paying
    # full-dim planning time on CPU).
    "edge-4k": DeploymentProfile(
        name="edge-4k",
        weight_buffer_bits=4 * 1024 * 8,
        ifm_buffer_bits=2 * 1024 * 8,
        act_bits=16,
        dram_bytes_per_s=1e9,
        peak_macs_per_s=8e9,
    ),
}

OBJECTIVES = ("latency", "dram", "energy", "balanced")

#: Impl ladder, most specialized first (the reference's, with the
#: hand-kernel rung named after its backend: ``cuda`` for ``pallas``).
#: Canonical here; `engine.plan` and `engine.execute` re-export it.
IMPL_LADDER = ("cuda", "xla", "xla_gather", "dense")


def get_deployment(dep: "str | DeploymentProfile | None") -> DeploymentProfile:
    """A profile by name (``None``: ``zcu102``), or the profile given."""
    if dep is None:
        return DEPLOYMENTS["zcu102"]
    if isinstance(dep, DeploymentProfile):
        return dep
    try:
        return DEPLOYMENTS[dep]
    except KeyError:
        raise KeyError(f"unknown deployment {dep!r}; have "
                       f"{sorted(DEPLOYMENTS)}") from None


# ---------------------------------------------------------------------------
# Per-mode DRAM accounting (bits; shared by the CNN and GEMM sides)
# ---------------------------------------------------------------------------

def mode_dram_bits(i_bits: int, w_bits: int, o_bits: int, psum_bits: int,
                   dep: DeploymentProfile, *,
                   gemv: bool = False) -> Dict[str, int]:
    """DRAM traffic (bits) of one layer under each feasible dataflow mode.

    ``psum_bits`` is the full partial-sum footprint of the layer's OFM at
    ``dep.psum_bits`` width (spilled once per extra weight chunk under a
    chunked RWF: written then read back).  ``gemv`` marks layers with no
    weight-reuse dimension (fc at M=1): every mode streams the weights
    exactly once, so all entries collapse to the same minimum.
    """
    n_i = max(1, math.ceil(i_bits / dep.ifm_buffer_bits))
    n_w = max(1, math.ceil(w_bits / dep.weight_buffer_bits))
    if gemv:
        d = i_bits + w_bits + o_bits
        out = {"RIF": d, "RWF": d}
        if n_w == 1:
            out["ON_CHIP"] = d
        return out
    out = {
        # IFM chunk stationary; the whole weight set re-streams per chunk.
        "RIF": i_bits + w_bits * n_i + o_bits,
        # Weight chunk stationary; IFMs re-stream per chunk, partial sums
        # spill (write + read) for every chunk beyond the first.
        "RWF": w_bits + i_bits * n_w + o_bits + 2 * (n_w - 1) * psum_bits,
    }
    if n_w == 1:
        # all weights resident: load-once capture (the paper's Layer-3 case)
        out["ON_CHIP"] = i_bits + w_bits + o_bits
    return out


#: Tie-break preference when modes cost the same (prefer the capture).
_MODE_ORDER = ("ON_CHIP", "RWF", "RIF")


def pick_mode(costs: Dict[str, int]) -> str:
    return min(_MODE_ORDER, key=lambda m: (costs.get(m, float("inf")),
                                           _MODE_ORDER.index(m)))


# ---------------------------------------------------------------------------
# Weight-stream sizes: format bits (hardware) and stored bytes (this runtime)
# ---------------------------------------------------------------------------

def tiled_format_bits(n_out: int, nb: int, kb: int, bn: int, *,
                      elem_bits: int = 16, quant: str = "none",
                      count_bits: int = 16) -> int:
    """Format-level bits of a `TiledBalanced` encoding, from shapes alone.

    Matches `kernels.tile_format.tiled_storage_bits` exactly: per slot the
    element plus a ``ceil(log2 bn)``-bit block-local index, one count word
    per block, and for quantized encodings the narrow element width plus
    one f32 scale per block.
    """
    idx_bits = max(1, (bn - 1).bit_length())
    scale_bits = 0
    if quant != "none":
        elem_bits = {"int8": 8, "int4": 4}[quant]
        scale_bits = n_out * nb * 32
    return n_out * nb * kb * (elem_bits + idx_bits) \
        + n_out * nb * count_bits + scale_bits


def flat_format_bits(n_out: int, k: int, n_in: int, *,
                     elem_bits: int = 16) -> int:
    """Format-level bits of the flat balanced format (global indices)."""
    idx_bits = max(1, (n_in - 1).bit_length())
    return n_out * k * (elem_bits + idx_bits)


def _leaves(tree: Any):
    """Tensor leaves of nested dicts / lists / tuples / dataclasses."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def pytree_nbytes(tree: Any) -> int:
    """As-stored bytes of every tensor leaf (dicts, lists, tuples and
    dataclasses such as `TiledBalanced` are walked)."""
    return sum(int(t.numel()) * int(t.element_size()) for t in _leaves(tree))


def dispatch_weight_nbytes(weights: Any, lead_layers: int = 1) -> int:
    """Stored bytes one dispatch streams: the stacked-plan total divided by
    the leading layer axis (the model runs one layer per dispatch; MoE
    expert axes stay in the dispatch)."""
    return pytree_nbytes(weights) // max(1, lead_layers)


# ---------------------------------------------------------------------------
# Layer cost (the provenance record attached to every PlanSpec)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CostTag:
    """Hashable per-layer cost provenance (rides in `PlanSpec.cost`).

    Byte fields are *stored bytes* (checked exactly against the execute
    STATS counters); ``dram_bits`` / ``energy_pj`` / ``latency_s`` come
    from the format-level model at the chosen mode.
    """
    objective: str = "latency"
    deployment: str = "zcu102"
    mode: str = "ON_CHIP"
    w_stream_bytes: int = 0        # per-dispatch stored encoded bytes
    w_total_bytes: int = 0         # whole (stacked) weight pytree
    act_in_bytes: int = 0          # per dispatch at the plan's m_hint
    act_out_bytes: int = 0
    dram_bits: int = 0             # modeled per-dispatch DRAM traffic
    energy_pj: float = 0.0
    latency_s: float = 0.0


def gemm_layer_cost(*, m: int, n_in: int, n_out: int,
                    w_format_bits: int, macs: int,
                    dep: DeploymentProfile, quant: str = "none",
                    gemv: bool = False) -> Dict[str, Any]:
    """Per-mode DRAM bits + energy/latency for one GEMM layer at M rows.

    ``w_format_bits`` is the weight stream at format level (tiled/flat/
    dense as encoded); IFM/OFM stream dense at ``dep.act_bits`` (activation
    compression is future work — DESIGN.md §14).
    """
    i_bits = m * n_in * dep.act_bits
    o_bits = m * n_out * dep.act_bits
    psum = m * n_out * dep.psum_bits
    costs = mode_dram_bits(i_bits, w_format_bits, o_bits, psum, dep,
                           gemv=gemv)
    mode = pick_mode(costs)
    d = costs[mode]
    e = layer_energy_pj(d, macs, dep, quant=quant)
    lat = layer_latency_s(d, macs, dep)
    return {"mode": mode, "dram_bits": d, "per_mode": costs,
            "i_bits": i_bits, "o_bits": o_bits,
            "energy_pj": e, "latency_s": lat}


def layer_energy_pj(dram_bits: int, macs: int, dep: DeploymentProfile, *,
                    quant: str = "none") -> float:
    """Per-component energy: DRAM stream + two on-chip operand reads per
    MAC + the MAC itself (psums accumulate in the PE register file)."""
    et = dep.energy
    return (dram_bits * et.dram_pj_per_bit
            + macs * 2 * dep.act_bits * et.sram_pj_per_bit
            + macs * dep.psum_bits * et.reg_pj_per_bit
            + macs * et.mac_energy(quant))


def layer_latency_s(dram_bits: int, macs: int,
                    dep: DeploymentProfile) -> float:
    """Roofline estimate: bound by the DRAM stream or the MAC envelope."""
    return max(dram_bits / 8.0 / dep.dram_bytes_per_s,
               macs / dep.peak_macs_per_s)


def objective_score(objective: str, *, dram_bits: int, energy_pj: float,
                    latency_s: float) -> float:
    """Scalar score an objective minimizes.  ``latency`` is handled by the
    planner's default path (the §V-C / §VI-F rules) and scored here only
    for ranking; ``balanced`` is the energy-delay product."""
    if objective == "dram":
        return float(dram_bits)
    if objective == "energy":
        return energy_pj
    if objective == "balanced":
        return energy_pj * latency_s
    return latency_s


# ---------------------------------------------------------------------------
# CNN (paper) side: per-layer + network totals for the four paper nets
# ---------------------------------------------------------------------------

def conv_layer_cost(ls: LayerSpec, dep: DeploymentProfile, *,
                    elem_bits: int = 16, fixed: bool = False
                    ) -> Dict[str, Any]:
    """Byte-accurate accounting for one CONV/FC `LayerSpec`.

    Compressed-bitmap IFM/weight streams (`core.dataflow` storage sizes),
    dense OFM write at ``dep.act_bits``, buffer-derived chunking, psum
    spills under chunked RWF.  ``fixed=True`` models the fixed-dataflow
    baseline: RIF for every layer where a reuse choice exists (GEMV fc
    layers have none — every weight streams once under any dataflow)."""
    i = ifm_storage_bits(ls, elem_bits=elem_bits)
    w = weight_storage_bits(ls, elem_bits=elem_bits)
    o = ls.h_o * ls.w_o * ls.c_o * dep.act_bits
    psum = ls.h_o * ls.w_o * ls.c_o * dep.psum_bits
    gemv = ls.kind == "fc"
    costs = mode_dram_bits(i, w, o, psum, dep, gemv=gemv)
    if fixed and not gemv:
        mode = "RIF"
    else:
        mode = pick_mode(costs)
    d = costs[mode]
    eff_macs = round(ls.macs * (1.0 - ls.w_sparsity))
    return {"name": ls.name, "kind": ls.kind, "mode": mode,
            "dram_bits": d, "per_mode": costs,
            "i_bits": i, "w_bits": w, "o_bits": o,
            "energy_pj": layer_energy_pj(d, eff_macs, dep),
            "latency_s": layer_latency_s(d, eff_macs, dep)}


def network_cost(layers: Sequence[LayerSpec], dep: DeploymentProfile, *,
                 adaptive: bool = True, scope: str = "all",
                 elem_bits: int = 16) -> Dict[str, Any]:
    """Network totals under adaptive vs fixed-RIF dataflow.

    ``scope="adc"`` restricts the totals to the layers Adaptive Dataflow
    Configuration actually governs (conv layers — fc GEMV layers stream
    their weights exactly once under *any* dataflow, so including them
    measures model topology, not the mechanism; DESIGN.md §14).
    """
    if scope not in ("all", "adc"):
        raise ValueError(f"scope must be 'all' or 'adc', got {scope!r}")
    per_layer = []
    total_bits = 0
    energy = 0.0
    modes = []
    for ls in layers:
        c = conv_layer_cost(ls, dep, elem_bits=elem_bits,
                            fixed=not adaptive)
        per_layer.append(c)
        if scope == "adc" and ls.kind == "fc":
            continue
        total_bits += c["dram_bits"]
        energy += c["energy_pj"]
        modes.append(c["mode"])
    return {"total_bits": total_bits, "total_bytes": total_bits / 8.0,
            "energy_pj": energy, "modes": modes, "per_layer": per_layer,
            "frac_rwf": modes.count("RWF") / max(len(modes), 1)}


def adc_reduction(layers: Sequence[LayerSpec], dep: DeploymentProfile, *,
                  scope: str = "adc") -> float:
    """Fixed-RIF DRAM traffic over adaptive (>= 1: adaptive never loses)."""
    a = network_cost(layers, dep, adaptive=True, scope=scope)
    f = network_cost(layers, dep, adaptive=False, scope=scope)
    return f["total_bits"] / max(a["total_bits"], 1)


__all__ = [
    "EnergyTable", "DeploymentProfile", "DEPLOYMENTS", "get_deployment",
    "OBJECTIVES", "IMPL_LADDER", "mode_dram_bits", "pick_mode",
    "tiled_format_bits", "flat_format_bits", "pytree_nbytes",
    "dispatch_weight_nbytes", "CostTag", "gemm_layer_cost",
    "layer_energy_pj", "layer_latency_s", "objective_score",
    "conv_layer_cost", "network_cost", "adc_reduction",
]
