"""Analytical systolic-array performance & energy model (Sense §II/§VI) —
counterpart of `repro.core.systolic` (NumPy, this package's own copy).

Without the FPGA/RTL, the paper's performance, PE-utilization,
DRAM and energy comparisons are reproduced with a tile-granular analytical
model of the weight-oriented sparse dataflow.  The model is exact on the
paper's worked micro-examples (unit-tested):

* Fig.3  — kernels NZE [6,2] vs balanced [4,4]: 6Tw -> 4Tw (1.5x)
* Fig.4  — IFM NZE [8,4,8,3] on a 1x2 array: 16Ti -> 12Ti (1.33x)
* Fig.6  — 3x3 kernels pruned to 4 NZE: 9/4 = 2.25x vs dense
* Fig.10 — 4-NZE IFM x 2-NZE kernel: 8 cycles vs 64 dense (8x)

Cycle law (weight-oriented flow): a PE at (row=channel r, col=kernel c)
needs ``N_NZEI[r] * N_NZEW[c]`` MAC cycles for one (IC, OC, tile) step; the
rigid systolic tempo blocks the step at the slowest PE:

    step = max_r(N_NZEI[r]) * max_c(N_NZEW[c])

Baseline accelerators are modeled by how they constrain those NZE streams:

* dense   — no skipping: N_NZEI = tile numel, N_NZEW = Hk*Wk
* swallow — skips zeros of both operands, but NZE counts stay irregular
            (no balance) and channels stream in natural order
* fesa    — pattern-pruned weights (balanced) but IFMs left dense
* spots   — group-wise pruning + Im2Col GEMM: only all-zero weight rows /
            IFM columns are skipped
* sense   — balanced weights (equal NZE per kernel) + channel clustering
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence

import numpy as np

from .dataflow import (DataflowChoice, LayerSpec, choose_dataflow, conv_tiling,
                       ifm_storage_bits, swallow_dataflow, weight_storage_bits)

Accelerator = Literal["sense", "swallow", "fesa", "spots", "dense"]


@dataclasses.dataclass(frozen=True)
class SystolicConfig:
    """Hardware constants of the Sense implementation (§VI-A, Tab.IV)."""
    n_pe: int = 32                 # array is n_pe x n_pe
    n_is: int = 7                  # IFM sub-tile edge
    freq_hz: float = 200e6
    elem_bits: int = 16
    # dense/sparse computing-mode thresholds (§VI-F: IFM 30%, weight 20%)
    ifm_sparse_threshold: float = 0.30
    w_sparse_threshold: float = 0.20
    # power (W), Tab.IV breakdown
    power_total: float = 10.8
    power_clustering: float = 0.3
    power_sparse_overhead: float = 0.30   # §VI-F: sparse processing +30%
    # DRAM
    dram_pj_per_bit: float = 20.0         # CACTI-class DDR4 estimate
    dram_bw_bits: float = 19.2e9 * 8      # ZCU102 PS-DDR4 ~19.2 GB/s
    # on-chip weight buffer: 320 BRAM36 x ~36Kb for I&W (Tab.IV), half weights
    weight_buffer_bits: int = 160 * 36 * 1024

    @property
    def peak_macs(self) -> float:
        return self.n_pe * self.n_pe * self.freq_hz   # 204.8 GMAC/s @32,200MHz


# ---------------------------------------------------------------------------
# Cycle primitives
# ---------------------------------------------------------------------------

def _group_max(values: np.ndarray, group: int, *, sort_desc: bool) -> np.ndarray:
    """Max within consecutive groups of ``group`` (pad with 0), optionally
    after descending sort — the clustering schedule."""
    v = np.asarray(values, dtype=np.int64).reshape(-1)
    if sort_desc:
        v = -np.sort(-v)
    pad = (-v.size) % group
    if pad:
        v = np.concatenate([v, np.zeros(pad, dtype=v.dtype)])
    return v.reshape(-1, group).max(axis=1)


def conv_cycles(nzei: np.ndarray, nzew: np.ndarray, *, n_pe: int,
                cluster_ifm: bool, sort_weights: bool = False) -> int:
    """Cycles for one spatial tile pass over all (IC, OC) group pairs.

    nzei: [C_i] NZE count per input channel for this tile.
    nzew: [C_o] NZE count per kernel.
    Step time = max_r(nzei) * max_c(nzew), summed over the IC x OC group grid.
    """
    row_max = _group_max(nzei, n_pe, sort_desc=cluster_ifm)
    col_max = _group_max(nzew, n_pe, sort_desc=sort_weights)
    return int(row_max.sum() * col_max.sum())


def conv_cycles_sliced(nzei_tiles: np.ndarray, nzew_slices: np.ndarray, *,
                       n_pe: int, cluster_ifm: bool,
                       sync: Literal["block", "step"] = "block") -> int:
    """Full-layer cycles at PE-array granularity (§IV-C: PE row r holds IC r,
    PE column c holds OC c, so PE (r,c) processes kernel *slice* W[c, r] —
    nzei x nzew_slice MAC cycles, the Fig.10 law).

    nzei_tiles:  [C_i, T]   NZE per input channel x spatial tile
    nzew_slices: [C_o, C_i] NZE per kernel slice (<= Hk*Wk each)

    ``sync`` is the array's synchronization granularity:

    * "block" (the paper's §IV-C: "when all ICs of this output block are
      finished, we pause the computation, accumulate across PEs") — lane
      (r, c) accumulates over the whole IC loop before the array syncs:

          block_time[c_grp, t] = max_{r, c} sum_e nzei[ch(e,r), t] * w[c, ch(e,r)]

      Balanced kernel *totals* + clustered channels make the lane sums
      nearly equal — this is exactly why the co-design balances totals.
    * "step" — pessimistic per-IC-group sync (ablation; what a naive rigid
      schedule would give): sum over e of max_{r,c} products.

    Clustering ranks channels once per layer by *total* NZE (the HW sorts
    whole channels), so per-tile imbalance inside a cluster remains — the
    Fig.29 effect.
    """
    nzei_tiles = np.asarray(nzei_tiles, dtype=np.int64)
    nzew_slices = np.asarray(nzew_slices, dtype=np.int64)
    c_i, t = nzei_tiles.shape
    c_o = nzew_slices.shape[0]
    assert nzew_slices.shape[1] == c_i, (nzew_slices.shape, c_i)
    if cluster_ifm:
        order = np.argsort(-nzei_tiles.sum(axis=1), kind="stable")
        nzei_tiles = nzei_tiles[order]
        nzew_slices = nzew_slices[:, order]
    pad_i = (-c_i) % n_pe
    pad_o = (-c_o) % n_pe
    if pad_i:
        nzei_tiles = np.concatenate(
            [nzei_tiles, np.zeros((pad_i, t), np.int64)])
        nzew_slices = np.concatenate(
            [nzew_slices, np.zeros((c_o, pad_i), np.int64)], axis=1)
    if pad_o:
        nzew_slices = np.concatenate(
            [nzew_slices, np.zeros((pad_o, nzew_slices.shape[1]), np.int64)])
    ci_p, co_p = nzei_tiles.shape[0], nzew_slices.shape[0]
    gi, go = ci_p // n_pe, co_p // n_pe
    # lane view: channel (e, r) -> IC e*n_pe + r; OC groups batched on a
    # leading G axis — one einsum over all output groups (this function
    # dominates benchmarks/paper_figs.py runtime, so no Python group loop).
    nzei_l = nzei_tiles.reshape(gi, n_pe, t)            # [E, r, T]
    w_g = nzew_slices.reshape(go, n_pe, gi, n_pe)       # [G, c, E, r]
    if sync == "block":
        # lane[g, c, r, T] = sum_e w_g[g,c,e,r] * nzei_l[e,r,T]
        lane = np.einsum("gcer,ert->gcrt", w_g, nzei_l)
        return int(lane.max(axis=(1, 2)).sum())         # max lanes, sum G x T
    # step[g, e, t] = max_{c, r} w_g[g,c,e,r] * nzei_l[e,r,t]
    w_max = w_g.max(axis=1)                             # [G, E, r]
    step = (w_max[..., None] * nzei_l[None]).max(axis=2)     # [G, E, T]
    return int(step.sum())


def fc_cycles(input_mask: np.ndarray, nzew_cols: np.ndarray, *, n_pe: int,
              clustered: bool) -> int:
    """Outer-product FC cycles (§III-D): nonzero input elements are consumed
    ``n_pe`` at a time; a step costs the max column-NZE within the group.
    Clustering sorts the (nonzero-input) columns by NZE count first."""
    mask = np.asarray(input_mask).astype(bool).reshape(-1)
    cols = np.asarray(nzew_cols, dtype=np.int64).reshape(-1)[mask]
    if cols.size == 0:
        return 0
    return int(_group_max(cols, n_pe, sort_desc=clustered).sum())


# ---------------------------------------------------------------------------
# NZE-stream synthesis per accelerator
# ---------------------------------------------------------------------------

def synth_weight_nze(layer: LayerSpec, accel: Accelerator,
                     rng: np.random.Generator) -> np.ndarray:
    """Per-kernel *total* NZE counts after each accelerator's pruning style."""
    kernel_numel = layer.c_i * layer.h_k * layer.w_k
    dense = np.full(layer.c_o, kernel_numel, dtype=np.int64)
    keep = 1.0 - layer.w_sparsity
    if accel == "dense":
        return dense
    if accel in ("sense", "fesa"):
        # balanced: every kernel at exactly the target NZE count
        return np.full(layer.c_o, max(1, round(kernel_numel * keep)), np.int64)
    if accel == "swallow":
        # unstructured magnitude pruning: real per-kernel keep rates vary
        # widely across output channels (filters differ in importance);
        # model keep-rate ~ Beta with CV ~0.35, matching measured spreads
        # of magnitude-pruned CNNs (and our own trained small CNNs).
        cv = 0.35
        mean = keep
        var = min((cv * mean) ** 2, mean * (1 - mean) * 0.95 + 1e-9)
        common = mean * (1 - mean) / max(var, 1e-9) - 1
        a, b = max(mean * common, 1e-2), max((1 - mean) * common, 1e-2)
        keep_rates = np.clip(rng.beta(a, b, size=layer.c_o), 0, 1)
        return np.maximum(1, rng.binomial(kernel_numel, keep_rates))
    if accel == "spots":
        # group-wise pruning: zero elements only help when a whole GEMM row
        # (one position across the group) is zero; effective NZE is the
        # count of positions with any survivor among `g` grouped kernels.
        g = 4
        p_pos_zero = layer.w_sparsity ** g        # all g copies pruned
        eff = kernel_numel * (1.0 - p_pos_zero)
        return np.full(layer.c_o, max(1, round(eff)), np.int64)
    raise ValueError(accel)


def synth_weight_slices(layer: LayerSpec, accel: Accelerator,
                        rng: np.random.Generator) -> np.ndarray:
    """[C_o, C_i] NZE counts per kernel slice W[c, r] (each <= Hk*Wk).

    Per-kernel totals follow the accelerator's pruning style; the split
    across input channels is hypergeometric (positions chosen without
    replacement inside the kernel), which is exact for magnitude pruning
    with i.i.d. weights.
    """
    slice_numel = layer.h_k * layer.w_k
    totals = synth_weight_nze(layer, accel, rng)
    kernel_numel = layer.c_i * slice_numel
    out = np.empty((layer.c_o, layer.c_i), dtype=np.int64)
    colors = [slice_numel] * layer.c_i
    for c in range(layer.c_o):
        k = int(min(totals[c], kernel_numel))
        out[c] = rng.multivariate_hypergeometric(colors, k)
    return out


def synth_ifm_nze(layer: LayerSpec, accel: Accelerator,
                  rng: np.random.Generator, *, n_is: int,
                  channel_cv: float = 0.35) -> np.ndarray:
    """[C_i, T] NZE counts per channel x spatial tile.

    Real ReLU feature maps have strongly channel-dependent sparsity; we model
    per-channel keep-rate with a Beta distribution matching the layer's mean
    IFM density and coefficient of variation ``channel_cv`` (measured CNN
    feature maps typically land at 0.3~0.5), then Binomial per tile.
    """
    tiling = conv_tiling(layer, n_is=n_is, n_pe=1)
    t = tiling.n_ifm_tiles
    tile_numel = n_is * n_is
    keep = np.clip(1.0 - layer.ifm_sparsity, 1e-6, 1.0)
    if accel in ("fesa", "dense"):
        return np.full((layer.c_i, t), tile_numel, dtype=np.int64)
    if accel == "spots":
        # only all-zero Im2Col columns are skipped: an output position's
        # column is zero iff all Hk*Wk*Ci taps are zero — essentially never
        # for real densities; model a mild saving via per-row zero prob.
        win = layer.h_k * layer.w_k
        p_col_zero = layer.ifm_sparsity ** win
        eff = tile_numel * (1.0 - p_col_zero)
        return np.full((layer.c_i, t), max(1, round(eff)), np.int64)
    # sense / swallow: true per-channel dynamic sparsity
    cv = channel_cv
    mean = keep
    var = (cv * mean) ** 2
    var = min(var, mean * (1 - mean) * 0.95 + 1e-9)
    alpha = mean * (mean * (1 - mean) / var - 1)
    beta = (1 - mean) * (mean * (1 - mean) / var - 1)
    alpha, beta = max(alpha, 1e-2), max(beta, 1e-2)
    ch_keep = np.clip(rng.beta(alpha, beta, size=layer.c_i), 0.0, 1.0)
    return rng.binomial(tile_numel, ch_keep[:, None],
                        size=(layer.c_i, t)).astype(np.int64)


# ---------------------------------------------------------------------------
# Layer- and network-level reports
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerPerf:
    name: str
    cycles: int
    macs_useful: int
    dram_bits: int
    mode: str                 # RIF / RWF / ON_CHIP
    compute_s: float
    dram_s: float
    latency_s: float          # max(compute, dram) — ping-pong overlap
    sparse_mode: bool


@dataclasses.dataclass
class NetworkPerf:
    accel: str
    layers: list
    total_cycles: int
    latency_s: float
    images_per_s: float
    dram_bits: int
    pe_utilization: float
    energy_j: float
    images_per_j: float


def _layer_sparse_mode(layer: LayerSpec, cfg: SystolicConfig,
                       accel: Accelerator) -> bool:
    if accel == "dense":
        return False
    return (layer.ifm_sparsity >= cfg.ifm_sparse_threshold
            or layer.w_sparsity >= cfg.w_sparse_threshold)


def layer_perf(layer: LayerSpec, accel: Accelerator, cfg: SystolicConfig,
               rng: np.random.Generator, *, adaptive_dataflow: bool = True,
               nzei_tiles: np.ndarray | None = None,
               nzew_slices: np.ndarray | None = None) -> LayerPerf:
    """Cycles + DRAM for one layer under one accelerator model.

    Measured NZE streams can be injected (``nzei_tiles``/``nzew_slices``) to
    drive the model from *real* pruned weights and feature maps; otherwise
    they are synthesized from the layer's sparsity ratios.
    """
    sparse_mode = _layer_sparse_mode(layer, cfg, accel)
    eff_accel: Accelerator = accel if sparse_mode else "dense"

    if layer.kind == "fc":
        # one weight column per input element; FESA/SPOTS don't target FC —
        # give them Swallow-like unstructured FC handling.
        in_keep = 1.0 - (layer.ifm_sparsity if eff_accel not in ("fesa", "dense")
                         else 0.0)
        input_mask = rng.random(layer.c_i) < in_keep
        col_keep = 1.0 - (layer.w_sparsity if eff_accel != "dense" else 0.0)
        nzew_cols = np.maximum(1, rng.binomial(layer.c_o, col_keep,
                                               size=layer.c_i))
        if eff_accel in ("sense", "fesa"):
            nzew_cols = np.full(layer.c_i, max(1, round(layer.c_o * col_keep)),
                                np.int64)
        # §V-B: FC runs on a single PE column (bandwidth-bound)
        cycles = fc_cycles(input_mask, nzew_cols, n_pe=cfg.n_pe,
                           clustered=(eff_accel == "sense"))
    else:
        if nzei_tiles is None:
            nzei_tiles = synth_ifm_nze(layer, eff_accel, rng, n_is=cfg.n_is)
        if nzew_slices is None:
            nzew_slices = synth_weight_slices(layer, eff_accel, rng)
        cycles = conv_cycles_sliced(nzei_tiles, nzew_slices, n_pe=cfg.n_pe,
                                    cluster_ifm=(eff_accel == "sense"))

    if adaptive_dataflow and accel == "sense":
        choice = choose_dataflow(layer, n_is=cfg.n_is, n_pe=cfg.n_pe,
                                 weight_buffer_bits=cfg.weight_buffer_bits)
    else:
        choice = swallow_dataflow(layer, n_is=cfg.n_is, n_pe=cfg.n_pe,
                                  weight_buffer_bits=cfg.weight_buffer_bits)
    if accel in ("fesa", "dense"):
        # no IFM compression: dense IFM traffic
        i_dense = ifm_storage_bits(layer, elem_bits=cfg.elem_bits,
                                   compressed=False)
        d_bits = choice.d_mem_bits - choice.i_mem + i_dense
    else:
        d_bits = choice.d_mem_bits

    macs_useful = round(layer.macs * (1 - layer.ifm_sparsity)
                        * (1 - layer.w_sparsity))
    compute_s = cycles / cfg.freq_hz
    dram_s = d_bits / cfg.dram_bw_bits
    return LayerPerf(name=layer.name, cycles=cycles, macs_useful=macs_useful,
                     dram_bits=d_bits, mode=choice.mode, compute_s=compute_s,
                     dram_s=dram_s, latency_s=max(compute_s, dram_s),
                     sparse_mode=sparse_mode)


def network_perf(layers: Sequence[LayerSpec], accel: Accelerator,
                 cfg: SystolicConfig | None = None, *, seed: int = 0,
                 adaptive_dataflow: bool | None = None) -> NetworkPerf:
    cfg = cfg or SystolicConfig()
    if adaptive_dataflow is None:
        adaptive_dataflow = accel == "sense"
    rng = np.random.default_rng(seed)
    reports = [layer_perf(l, accel, cfg, rng,
                          adaptive_dataflow=adaptive_dataflow) for l in layers]
    total_cycles = sum(r.cycles for r in reports)
    latency = sum(r.latency_s for r in reports)
    dram_bits = sum(r.dram_bits for r in reports)
    useful = sum(r.macs_useful for r in reports)
    # PE utilization per §VI-B: actual vs ideal performance at equal
    # computing complexity (useful MACs).
    ideal_s = useful / cfg.peak_macs
    pe_util = min(1.0, ideal_s / max(latency, 1e-30))
    any_sparse = any(r.sparse_mode for r in reports)
    power = cfg.power_total * (1.0 if any_sparse
                               else 1.0 / (1.0 + cfg.power_sparse_overhead))
    if accel == "swallow":
        power = cfg.power_total - cfg.power_clustering   # no clustering module
    if accel == "fesa":
        power = cfg.power_total / 1.5                    # paper: Sense = 1.5x FESA
    if accel == "spots":
        power = cfg.power_total / 1.3                    # paper: Sense = 1.3x SPOTS
    if accel == "dense":
        power = cfg.power_total / (1.0 + cfg.power_sparse_overhead)
    energy = latency * power + dram_bits * cfg.dram_pj_per_bit * 1e-12
    return NetworkPerf(accel=accel, layers=reports, total_cycles=total_cycles,
                       latency_s=latency, images_per_s=1.0 / latency,
                       dram_bits=dram_bits, pe_utilization=pe_util,
                       energy_j=energy, images_per_j=1.0 / energy)
