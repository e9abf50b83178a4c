"""Layer-plan construction — counterpart of `repro.engine.plan`.

`build_layer_plan` plans one fc (``[O, N]``) or conv (``[Co, Ci, Hk, Wk]``)
weight from its pruning mask; `plan_smallcnn` plans the executable small
CNN with it; `plan_transformer`, `plan_rwkv6` and `plan_zamba2` plan the
served models' stacked projections, and `plan_model` dispatches on the
family.

One offline pass fixes every per-layer execution decision: the dataflow
mode (§V-C `choose_dataflow`), the kernel impl (§VI-F thresholds), the
block sizes (`kernels.autotune.resolve_blocks`: the static
`kernels.ops.choose_blocks` model, or under ``tune="cached"|"sweep"`` a
measured choice) and the weights pre-encoded to the impl's native format
(`TiledBalanced` for the ``cuda`` kernels, flat `BalancedSparse` for the
eager rungs, masked dense otherwise).

``objective`` / ``deployment`` select the plan objective (the reference's
DESIGN.md §14): ``"latency"`` keeps the §V-C / §VI-F rules and only
annotates each spec with its `launch.cost_model.CostTag`; ``"dram"``,
``"energy"`` and ``"balanced"`` co-optimize the dataflow mode and the impl
(sparse encoding vs dense stream, never up the ladder) against the cost
model's accounting for the named deployment profile.  Every tag carries
the exact stored bytes `engine.execute.bytes_stats` must count.

``quant`` ("int8" | "int4") block-quantizes every sparse encoding per
(row, bn-block); a quantized plan keeps the tiled format on every sparse
rung (the scales are tile-local) and is column-packed only on ``cuda``.

Pruning, column packing, encoding and quantization run as tensor ops on
the weights' device, so a full-width plan builds on the GPU in seconds;
the result is array-equal to the reference's plan (its ``pallas`` impl
<-> ``cuda``).
Their transients (sort indices, int64 column ids) are taken over chunks of
at most `_PLAN_CHUNK` elements, so planning the MoE expert stacks
(``[L*E, O, N]``) needs little memory beyond the masks and the encodings.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Tuple

import torch

from ..configs.base import TRANSFORMER_FAMILIES
from ..core.dataflow import LayerSpec, choose_dataflow
from ..core.pruning import BalancedSparse, keep_count, nonzero_columns, \
    topk_mask
from ..core.sparse_ops import SparseLinearSpec
from ..core.dataflow import ifm_storage_bits
from ..kernels import autotune
from ..kernels import ops as kernel_ops
from ..kernels.tile_format import (_KB_ROUND, QUANT_MODES, _round_up,
                                   TiledBalanced, encode_tiled, invert_perm,
                                   max_block_count, pack_columns,
                                   quantize_tiled, tiled_to_dense)
from ..launch import cost_model as _cost
from ..launch.cost_model import IMPL_LADDER
from ..launch.mesh import LiveMesh
from ..distributed.sharding import P

Tensor = torch.Tensor

# The projection families the planner prunes: every entry is a stacked
# [L, n_in, n_out] (or [L, E, n_in, n_out] for the MoE expert tensors) leaf
# of params["blocks"].
ATTN_PROJ_NAMES = ("wq", "wk", "wv", "wo")
MLP_PROJ_NAMES = ("w_gate", "w_up", "w_down", "w_in", "w_out")
MOE_SHARED_NAMES = ("ws_gate", "ws_up", "ws_down")
MOE_EXPERT_NAMES = ("we_gate", "we_up", "we_down")
# RWKV6: the time-mix R/K/V/G/O and the channel-mix matrices; the WKV
# recurrence and the decay LoRA head stay dense
RWKV6_PROJ_NAMES = ("wr", "wkm", "wv", "wg", "wo", "ck", "cv", "cr")
# Zamba2: the Mamba blocks' in/out projections; the B/C/dt heads (d ->
# ssm_state / nheads), the convs, the SSD recurrence and the shared
# attention block (one unstacked weight set) stay dense
ZAMBA2_PROJ_NAMES = ("z_proj", "x_proj", "out_proj")

# elements per chunk of the planning transients (1 GiB of int64 at most)
_PLAN_CHUNK = 1 << 27


def _chunks(rows: int, width: int):
    """Slices over ``rows`` of ``width`` elements each, `_PLAN_CHUNK`
    elements at most per slice (one row at least)."""
    step = max(1, _PLAN_CHUNK // max(width, 1))
    return [slice(i, min(i + step, rows)) for i in range(0, rows, step)]


def balanced_mask_k(mask2d: Tensor) -> int | None:
    """Per-row NZE count if the mask ``[O, N]`` is load-balanced, else
    None."""
    counts = (mask2d != 0).sum(dim=1)
    if counts.numel() and bool((counts == counts[0]).all()) \
            and int(counts[0]) > 0:
        return int(counts[0])
    return None


def mask_block_k(mask2d: Tensor, bn: int = 128) -> int:
    """Max per-(row, bn-block) NZE count of a concrete mask ``[O, N]``."""
    o, n = mask2d.shape
    nb = -(-n // bn)
    best = 0
    for sl in _chunks(o, nb * bn):
        m = torch.nn.functional.pad((mask2d[sl] != 0).to(torch.int32),
                                    (0, nb * bn - n))
        best = max(best, int(m.reshape(-1, nb, bn).sum(dim=2).max()))
    return best


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """The static half of a LayerPlan."""
    name: str
    kind: str                       # "fc" | "conv"
    impl: str                       # cuda | xla | xla_gather | dense
    mode: str                       # RIF | RWF | ON_CHIP
    n_in: int
    n_out: int
    k: int                          # NZE per output row (n_in when dense)
    block_k: int                    # per-bn-block capacity (KB)
    blocks: kernel_ops.BlockChoice | None
    w_sparsity: float
    d_mem_bits: int
    i_mem_bits: int
    w_mem_bits: int
    hk: int = 1                     # conv geometry (kind == "conv")
    wk: int = 1
    stride: int = 1
    conv_padding: Any = "SAME"      # "SAME" | "VALID" | int
    experts: int = 0
    tuned: str = "static"           # where ``blocks`` came from: "static"
                                    # (the model), "cached" (a warm autotune
                                    # entry), "swept" (measured at build)
    blocks_static: kernel_ops.BlockChoice | None = None
                                    # the static model's choice for the
                                    # same key (None when ``blocks`` is)
    degraded_from: str = ""         # the impl the planner chose, when the
                                    # guard ladder demoted or quarantined
                                    # the layer (`engine.guard`)
    m_hint: int = 0                 # prefill GEMM M ``blocks`` was chosen at
    decode_m: int = 0               # decode GEMM M of ``blocks_decode``
    blocks_decode: kernel_ops.BlockChoice | None = None
    packed: bool = False            # column-combining perm on the encoding
    pack_kb: Tuple = ()             # (kb_unpacked, kb_packed) when packed
    quant: str = "none"
    cost: Any = None                # `launch.cost_model.CostTag`: modeled
                                    # per-dispatch DRAM / energy / latency at
                                    # the build objective, and the stored
                                    # bytes `execute.bytes_stats` counts
                                    # (None on plan_from_balanced plans)

    @property
    def is_sparse(self) -> bool:
        return self.impl != "dense"


@dataclasses.dataclass
class LayerPlan:
    """One layer's frozen execution decision + its pre-encoded weights
    (`TiledBalanced`, `BalancedSparse` or a dense ``[..., O, N]`` tensor;
    leaves may carry a leading stacked-layer axis).  ``placement`` is
    ``(mesh, weight specs)`` when the weights are one rank's shards of a
    live mesh (`shard_plan`; `gather_layer` reassembles them), None when
    they are whole."""
    spec: PlanSpec
    weights: Any
    placement: Any = None

    def dense_weights(self) -> Tensor:
        """Densify back to ``[..., O, N]`` (the stored ``[Co, Ci, Hk, Wk]``
        of a dense conv plan) — the masked-dense reference this plan must
        match."""
        w = self.weights
        if isinstance(w, TiledBalanced):
            return tiled_to_dense(w)
        if isinstance(w, BalancedSparse):
            return w.to_dense()
        return w

    def nbytes(self) -> int:
        """Stored bytes of the weights, every stacked layer included
        (`cost_model.pytree_nbytes`), computed once per weights object: a
        dispatch counts them without walking the encoding again."""
        hit = self.__dict__.get("_nbytes")
        if hit is None or hit[0] is not self.weights:
            hit = (self.weights, _cost.pytree_nbytes(self.weights))
            self.__dict__["_nbytes"] = hit
        return hit[1]

    def layer(self, i: int) -> "LayerPlan":
        """The plan of stacked layer ``i`` (views of the stacked leaves;
        a placed plan's specs lose their stacked dim with them)."""
        def pick(t):
            return P(*t[1:]) if isinstance(t, P) else t[i]
        placement = None
        if self.placement is not None:
            mesh, specs = self.placement
            placement = (mesh, _map_weights(specs, pick))
        return LayerPlan(spec=self.spec,
                         weights=_map_weights(self.weights, pick),
                         placement=placement)


@dataclasses.dataclass
class ModelPlan:
    """Per-model container: layer name -> LayerPlan, plus build metadata."""
    layers: Dict[str, LayerPlan]
    meta: Tuple = ()

    def mode_mix(self) -> Dict[str, int]:
        mix: Dict[str, int] = {}
        for lp in self.layers.values():
            mix[lp.spec.mode] = mix.get(lp.spec.mode, 0) + 1
        return mix

    def impl_mix(self) -> Dict[str, int]:
        mix: Dict[str, int] = {}
        for lp in self.layers.values():
            mix[lp.spec.impl] = mix.get(lp.spec.impl, 0) + 1
        return mix

    def tuned_mix(self) -> Dict[str, int]:
        """Where each layer's `BlockChoice` came from (static model / warm
        autotune cache / fresh sweep)."""
        mix: Dict[str, int] = {}
        for lp in self.layers.values():
            mix[lp.spec.tuned] = mix.get(lp.spec.tuned, 0) + 1
        return mix

    def tune_deltas(self) -> Tuple:
        """``(name, tuned (bm, bo, bn), static (bm, bo, bn))`` of the layers
        whose measured choice differs from the static model (`meta` key
        ``tune_deltas``)."""
        return dict(self.meta).get("tune_deltas", ())

    def degraded_mix(self) -> Dict[str, int]:
        """``"<original>-><current>"`` counts of the layers the guard
        ladder demoted or quarantined (empty: nothing degraded)."""
        mix: Dict[str, int] = {}
        for lp in self.layers.values():
            s = lp.spec
            if s.degraded_from:
                key = f"{s.degraded_from}->{s.impl}"
                mix[key] = mix.get(key, 0) + 1
        return mix

    def quarantined(self) -> Tuple:
        """Layers the runtime NaN guard flipped to dense (`meta` key
        ``quarantined``, stamped by `engine.guard.quarantine_layers`)."""
        return dict(self.meta).get("quarantined", ())

    def cost_summary(self) -> Dict[str, Any]:
        """The per-layer `CostTag`s aggregated over the model: per-dispatch
        figures scale by the stacked-layer count (``w_total_bytes //
        w_stream_bytes``); layers without a tag count in ``untagged``."""
        meta = dict(self.meta)
        out: Dict[str, Any] = {
            "objective": meta.get("objective", "latency"),
            "deployment": meta.get("deployment", ""),
            "total_dram_bytes": 0.0, "total_energy_pj": 0.0,
            "total_w_stream_bytes": 0, "total_act_bytes": 0,
            "modes": {}, "untagged": 0, "per_layer": {},
        }
        for nm in sorted(self.layers):
            tag = self.layers[nm].spec.cost
            if tag is None:
                out["untagged"] += 1
                continue
            if not out["deployment"]:
                out["deployment"] = tag.deployment
            n_disp = max(1, tag.w_total_bytes // max(tag.w_stream_bytes, 1))
            out["total_dram_bytes"] += tag.dram_bits / 8.0 * n_disp
            out["total_energy_pj"] += tag.energy_pj * n_disp
            out["total_w_stream_bytes"] += tag.w_stream_bytes * n_disp
            out["total_act_bytes"] += \
                (tag.act_in_bytes + tag.act_out_bytes) * n_disp
            out["modes"][tag.mode] = out["modes"].get(tag.mode, 0) + 1
            out["per_layer"][nm] = {
                "mode": tag.mode, "dram_bytes": tag.dram_bits / 8.0,
                "energy_pj": tag.energy_pj, "latency_s": tag.latency_s,
                "w_stream_bytes": tag.w_stream_bytes,
                "dispatches": n_disp,
            }
        return out

    @property
    def sparse_layer_count(self) -> int:
        return sum(1 for lp in self.layers.values() if lp.spec.is_sparse)

    @functools.cached_property
    def per_layer(self) -> list:
        """``[{name: LayerPlan}]`` per stacked layer, built once (the model
        walks it per layer and step)."""
        n = int(dict(self.meta).get("n_layers", 0))
        return [{nm: lp.layer(i) for nm, lp in self.layers.items()}
                for i in range(n)]

    def summary(self) -> str:
        lines = [f"{'layer':14s} {'mode':>8s} {'impl':>10s} {'O':>6s} "
                 f"{'N':>6s} {'K':>6s} {'KB':>4s} {'spars':>6s} "
                 f"{'Dmem(Kb)':>9s}"]
        for name in sorted(self.layers):
            s = self.layers[name].spec
            lines.append(f"{name:14s} {s.mode:>8s} {s.impl:>10s} "
                         f"{s.n_out:6d} {s.n_in:6d} {s.k:6d} "
                         f"{s.block_k:4d} {s.w_sparsity:6.2f} "
                         f"{s.d_mem_bits / 1e3:9.0f}")
        lines.append(f"mode mix {self.mode_mix()}  impl mix "
                     f"{self.impl_mix()}  blocks {self.tuned_mix()}")
        degraded = self.degraded_mix()
        if degraded:
            lines.append(f"degraded {degraded}  quarantined "
                         f"{list(self.quarantined())}")
        return "\n".join(lines)


def default_impl(*, balanced: bool, w_sparsity: float,
                 ifm_sparsity: float = 0.0,
                 device: torch.device | str = "cuda") -> str:
    """dense below the §VI-F thresholds or for unbalanced patterns; else the
    CUDA kernels for a plan built on a CUDA device, the eager ``xla``
    densify+matmul on the CPU (as the reference picks pallas on a TPU and
    xla where Pallas would run interpreted)."""
    spec = SparseLinearSpec(w_sparsity=w_sparsity, ifm_sparsity=ifm_sparsity)
    if not balanced or not spec.use_sparse:
        return "dense"
    return "cuda" if torch.device(device).type == "cuda" else "xla"


# ---------------------------------------------------------------------------
# Cost-objective co-optimization (launch.cost_model)
# ---------------------------------------------------------------------------

def _encoded_format_bits(*, impl: str, n_out: int, n_in: int, k: int,
                         bn: int, block_k: int, quant: str,
                         elem_bits: int) -> int:
    """Format-level weight-stream bits of one encoding candidate."""
    if impl == "dense":
        return n_out * n_in * elem_bits
    if impl == "cuda" or quant != "none":
        nb = -(-n_in // bn)
        return _cost.tiled_format_bits(n_out, nb, block_k, bn,
                                       elem_bits=elem_bits, quant=quant)
    return _cost.flat_format_bits(n_out, k, n_in, elem_bits=elem_bits)


def _evaluate_cost(*, objective: str, dep, layer_spec: LayerSpec | None,
                   kind: str, m_hint: int, n_in: int, n_out: int, k: int,
                   w_format_bits: int, quant: str,
                   elem_bits: int) -> Dict[str, Any]:
    """Per-mode DRAM bits and energy / latency of one (impl, encoding)
    candidate: a conv layer streams compressed-bitmap IFMs of its
    geometry, an fc layer a dense ``[m_hint, N]`` activation block."""
    if kind == "conv" and layer_spec is not None:
        i_bits = ifm_storage_bits(layer_spec, elem_bits=elem_bits)
        o_elems = layer_spec.h_o * layer_spec.w_o * layer_spec.c_o
        o_bits = o_elems * dep.act_bits
        psum = o_elems * dep.psum_bits
        macs = round(layer_spec.macs * (k / max(n_in, 1)))
    else:
        i_bits = m_hint * n_in * dep.act_bits
        o_bits = m_hint * n_out * dep.act_bits
        psum = m_hint * n_out * dep.psum_bits
        macs = m_hint * n_out * k
    per_mode = _cost.mode_dram_bits(i_bits, w_format_bits, o_bits, psum, dep)
    mode = min(per_mode, key=lambda m: (per_mode[m],
                                        _cost._MODE_ORDER.index(m)))
    d = per_mode[mode]
    energy = _cost.layer_energy_pj(d, macs, dep, quant=quant)
    lat = _cost.layer_latency_s(d, macs, dep)
    return {"mode": mode, "per_mode": per_mode, "dram_bits": d,
            "energy_pj": energy, "latency_s": lat, "macs": macs,
            "i_bits": i_bits, "o_bits": o_bits,
            "score": _cost.objective_score(objective, dram_bits=d,
                                           energy_pj=energy, latency_s=lat)}


def _format_bits_of(weights: Any, *, elem_bits: int,
                    lead_layers: int = 1) -> int:
    """Per-dispatch format-level bits of an encoding (the leading layer
    axis divides out; expert axes stay in the dispatch)."""
    if isinstance(weights, TiledBalanced):
        o, nb, kb = weights.indices.shape[-3:]
        g = 1
        for d in weights.indices.shape[:-3]:
            g *= int(d)
        per = _cost.tiled_format_bits(o, nb, kb, weights.bn,
                                      elem_bits=elem_bits,
                                      quant=weights.quant)
    elif isinstance(weights, BalancedSparse):
        o, k = weights.indices.shape[-2:]
        g = 1
        for d in weights.indices.shape[:-2]:
            g *= int(d)
        per = _cost.flat_format_bits(o, k, weights.n_in,
                                     elem_bits=elem_bits)
    else:                                # dense (fc 2-D, conv 4-D, stacked)
        g = 1
        per = int(weights.numel()) * elem_bits
    return per * g // max(1, lead_layers)


def _tag_for(*, objective: str, dep, ev: Dict[str, Any], mode: str,
             quant: str, weights: Any, lead_layers: int, m_hint: int,
             n_in: int, n_out: int, itemsize: int) -> "_cost.CostTag":
    """The provenance record at ``mode`` (the spec's: at the latency
    objective the §V-C choice, which the deployment's buffers may not
    admit, then the model's own pick), with the exact stored byte counts
    `execute.bytes_stats` must reproduce."""
    d = ev["per_mode"].get(mode, ev["dram_bits"])
    w_total = _cost.pytree_nbytes(weights)
    return _cost.CostTag(
        objective=objective, deployment=dep.name, mode=mode,
        w_stream_bytes=w_total // max(1, lead_layers),
        w_total_bytes=w_total,
        act_in_bytes=m_hint * n_in * itemsize,
        act_out_bytes=m_hint * n_out * itemsize,
        dram_bits=int(d),
        energy_pj=float(_cost.layer_energy_pj(d, ev["macs"], dep,
                                              quant=quant)),
        latency_s=float(_cost.layer_latency_s(d, ev["macs"], dep)))


def _check_objective(objective: str, deployment: Any):
    """The deployment profile, after checking the objective's name."""
    if objective not in _cost.OBJECTIVES:
        raise ValueError(f"objective must be one of {_cost.OBJECTIVES}, "
                         f"got {objective!r}")
    return _cost.get_deployment(deployment)


def _prefer_dense(*, objective: str, dep, layer_spec: LayerSpec | None,
                  kind: str, impl: str, m_hint: int, n_out: int, n_in: int,
                  k: int, pattern: Tensor, itemsize: int, dtype, quant: str,
                  elem_bits: int, groups: int = 1) -> bool:
    """The impl co-optimization of a non-latency objective: whether the
    dense stream scores better than the sparse encoding at the static
    block choice (``groups`` encodings per dispatch: the experts).  Format
    level; packing could only shrink the sparse side, so a sparse win here
    is conservative.  Never promotes up the ladder."""
    blk0 = autotune.resolve_blocks(m_hint, n_out, n_in, k, itemsize=itemsize,
                                   impl=impl, tune="off", dtype=dtype,
                                   quant=quant).blocks
    bk0 = max(_KB_ROUND, _round_up(mask_block_k(pattern, bn=blk0.bn),
                                   _KB_ROUND))
    ev_s = _evaluate_cost(
        objective=objective, dep=dep, layer_spec=layer_spec, kind=kind,
        m_hint=m_hint, n_in=n_in, n_out=n_out, k=k,
        w_format_bits=groups * _encoded_format_bits(
            impl=impl, n_out=n_out, n_in=n_in, k=k, bn=blk0.bn,
            block_k=bk0, quant=quant, elem_bits=elem_bits),
        quant=quant, elem_bits=elem_bits)
    ev_d = _evaluate_cost(
        objective=objective, dep=dep, layer_spec=layer_spec, kind=kind,
        m_hint=m_hint, n_in=n_in, n_out=n_out, k=n_in,
        w_format_bits=groups * n_out * n_in * elem_bits, quant="none",
        elem_bits=elem_bits)
    return ev_d["score"] < ev_s["score"]


def _cost_meta(objective: str, deployment: Any) -> Tuple:
    """Meta entries of the plan objective; empty at the default (latency,
    default deployment), as the reference's."""
    if objective == "latency" and deployment is None:
        return ()
    return (("objective", objective),
            ("deployment", _cost.get_deployment(deployment).name))


def _tune_meta(tune: str, layers: Dict[str, "LayerPlan"]) -> Tuple:
    """Meta entries of the tune policy and the per-layer tuned-vs-static
    `BlockChoice` deltas."""
    if tune == "off":
        return ()
    deltas = []
    for nm in sorted(layers):
        s = layers[nm].spec
        if s.blocks is None or s.blocks_static is None \
                or s.tuned == "static":
            continue
        stat = s.blocks_static
        if (s.blocks.bm, s.blocks.bo, s.blocks.bn) != \
                (stat.bm, stat.bo, stat.bn):
            deltas.append((nm, (s.blocks.bm, s.blocks.bo, s.blocks.bn),
                           (stat.bm, stat.bo, stat.bn)))
    return (("tune", tune), ("tune_deltas", tuple(deltas)))


def _maybe_pack(idx: Tensor, vals: Tensor, pattern2: Tensor, n_in: int,
                bn: int, block_k: int):
    """Column-combining packing of a flat encoding, adopted only when it
    strictly shrinks KB.  ``idx`` ``[g, O, K]`` ascending, ``pattern2``
    the pooled ``[g*O, n_in]`` mask.  Returns ``(idx, vals, block_k,
    n_enc, perm, pack_kb)`` (perm None when not adopted); the packed
    indices are re-sorted ascending, chunk by chunk."""
    nb = -(-n_in // bn)
    if nb <= 1:
        return idx, vals, block_k, n_in, None, ()
    perm = pack_columns(pattern2, bn)
    inv = invert_perm(perm).long()
    npack = nb * bn
    g, o, k = idx.shape
    parts = _chunks(g, o * k)
    # block counts do not depend on the order within a row
    kb_packed = max(max_block_count(inv[idx[sl].long()].reshape(-1, k),
                                    npack, bn) for sl in parts)
    if kb_packed >= block_k:
        return idx, vals, block_k, n_in, None, ()
    pidx = torch.empty_like(idx)
    pvals = torch.empty_like(vals)
    for sl in parts:
        p = inv[idx[sl].long()]
        order = torch.argsort(p, dim=-1, stable=True)
        pidx[sl] = p.gather(-1, order).to(pidx.dtype)
        pvals[sl] = vals[sl].gather(-1, order)
    return pidx, pvals, kb_packed, npack, perm, (block_k, kb_packed)


def _encode_chunked(vals: Tensor, idx: Tensor, n_enc: int, bn: int,
                    kb: int, quant: str = "none") -> TiledBalanced:
    """`encode_tiled` (then `quantize_tiled`) of the rows ``[R, K]`` one
    chunk of rows at a time: rows encode, and their (row, block) scales
    quantize, independently at a fixed KB, so the full-precision encoding
    of a stacked tensor never exists whole."""
    r, k = idx.shape
    nb = -(-n_enc // bn)
    out = None                       # values, indices, counts, scales
    for sl in _chunks(r, max(k, nb * kb)):
        part = quantize_tiled(encode_tiled(vals[sl], idx[sl], n_enc, bn=bn,
                                           kb=kb), quant)
        leaves = (part.values, part.indices, part.counts, part.scales)
        if out is None:
            out = [None if t is None else t.new_empty((r, *t.shape[1:]))
                   for t in leaves]
        for dst, t in zip(out, leaves):
            if t is not None:
                dst[sl] = t
    return TiledBalanced(*out[:3], n_in=n_enc, bn=bn, scales=out[3],
                         quant=quant)


def _as_dtype(dt) -> torch.dtype:
    return dt if isinstance(dt, torch.dtype) else getattr(torch, str(dt))


def _plan_stacked(nm: str, w: Tensor, *, sparsity: float, impl: str | None,
                  m_hint: int, cd, tune: str = "off",
                  tune_cache: str | None = None, decode_m: int = 4,
                  pack: bool = True, quant: str = "none",
                  objective: str = "latency",
                  deployment: Any = None) -> LayerPlan:
    """Plan one stacked projection ``[*lead, n_in, n_out]``: transpose to
    output-major, cast to the compute dtype (ties break in that dtype, as
    the reference's), balanced-prune each row to K = keep_count(n_in), and
    encode every slice with one shared BlockChoice / KB (resolved under
    ``tune``; and one shared packing permutation over the pooled pattern,
    on ``cuda`` only).  A quantized sparse layer is tiled and quantized on
    every rung; a dense one never quantizes.  A non-latency ``objective``
    may flip the layer to the dense stream; the spec's `CostTag` counts
    one dispatch (one stacked layer, every expert)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, "
                         f"got {quant!r}")
    cd = _as_dtype(cd)
    lead = tuple(w.shape[:-2])
    n_in, n_out = w.shape[-2:]
    g = 1
    for d in lead:
        g *= int(d)
    k = keep_count(n_in, sparsity)
    impl_nm = impl or default_impl(balanced=True, w_sparsity=1.0 - k / n_in,
                                   device=w.device)
    if impl_nm not in IMPL_LADDER:
        raise ValueError(f"impl must be one of {IMPL_LADDER}, got {impl_nm!r}")
    wt = w.reshape(g, n_in, n_out).transpose(-1, -2).to(cd)     # [g, O, N]
    masks = torch.empty((g, n_out, n_in), dtype=torch.bool, device=w.device)
    for sl in _chunks(g, n_out * n_in):
        masks[sl] = topk_mask(wt[sl], k)
    dep = _check_objective(objective, deployment)
    lead0 = int(lead[0]) if lead else 1       # dispatches per stacked layer
    elem_bits = cd.itemsize * 8
    pooled = masks.reshape(g * n_out, n_in)
    if objective != "latency" and impl_nm != "dense" and _prefer_dense(
            objective=objective, dep=dep, layer_spec=None, kind="fc",
            impl=impl_nm, m_hint=m_hint, n_out=n_out, n_in=n_in, k=k,
            pattern=pooled, itemsize=cd.itemsize, dtype=cd, quant=quant,
            elem_bits=elem_bits, groups=g // lead0):
        impl_nm = "dense"
    blk = blk_dec = blk_static = None
    tuned = "static"
    block_k = 0
    packed = False
    pack_kb: Tuple = ()
    if impl_nm == "dense":
        weights: Any = (wt * masks).reshape(*lead, n_out, n_in)
        quant = "none"
    else:
        res = autotune.resolve_blocks(m_hint, n_out, n_in, k,
                                      itemsize=cd.itemsize, impl=impl_nm,
                                      tune=tune, cache_path=tune_cache,
                                      dtype=cd, quant=quant, device=w.device)
        blk, tuned, blk_static = res.blocks, res.source, res.static
        blk_dec = autotune.resolve_blocks(decode_m, n_out, n_in, k,
                                          itemsize=cd.itemsize, impl=impl_nm,
                                          tune=tune, cache_path=tune_cache,
                                          dtype=cd, quant=quant,
                                          device=w.device).blocks
        block_k = max(_KB_ROUND,
                      _round_up(mask_block_k(pooled, bn=blk.bn), _KB_ROUND))
        # ascending nonzero columns [g, O, K] and their values
        idx = torch.empty((g, n_out, k), dtype=torch.int32, device=w.device)
        vals = torch.empty((g, n_out, k), dtype=cd, device=w.device)
        for sl in _chunks(g, n_out * n_in):
            cols = nonzero_columns(masks[sl], k)
            idx[sl] = cols.to(torch.int32)
            vals[sl] = wt[sl].gather(-1, cols)
        if impl_nm == "cuda" or quant != "none":
            n_enc, perm = n_in, None
            if impl_nm == "cuda" and pack:
                idx, vals, block_k, n_enc, perm, pack_kb = _maybe_pack(
                    idx, vals, pooled, n_in, blk.bn, block_k)
            tb = _encode_chunked(vals.reshape(g * n_out, k),
                                 idx.reshape(g * n_out, k), n_enc, blk.bn,
                                 block_k, quant)
            perm_leaf = None
            if perm is not None:
                packed = True
                perm_leaf = perm.expand(*lead, perm.shape[0]).contiguous() \
                    if lead else perm
            weights = TiledBalanced(
                tb.values.reshape(*lead, n_out, *tb.values.shape[-2:]),
                tb.indices.reshape(*lead, n_out, tb.nb, block_k),
                tb.counts.reshape(*lead, n_out, tb.nb),
                n_in=n_in, bn=blk.bn, perm=perm_leaf,
                scales=None if tb.scales is None
                else tb.scales.reshape(*lead, n_out, tb.nb), quant=quant)
        else:
            weights = BalancedSparse(vals.reshape(*lead, n_out, k),
                                     idx.reshape(*lead, n_out, k), n_in)
    flow = choose_dataflow(LayerSpec(name=nm, kind="fc", c_i=n_in,
                                     c_o=n_out, w_sparsity=1.0 - k / n_in))
    ev = _evaluate_cost(objective=objective, dep=dep, layer_spec=None,
                        kind="fc", m_hint=m_hint, n_in=n_in, n_out=n_out,
                        k=k if impl_nm != "dense" else n_in,
                        w_format_bits=_format_bits_of(weights,
                                                      elem_bits=elem_bits,
                                                      lead_layers=lead0),
                        quant=quant, elem_bits=elem_bits)
    mode = flow.mode if objective == "latency" else ev["mode"]
    tag = _tag_for(objective=objective, dep=dep, ev=ev, mode=mode,
                   quant=quant, weights=weights, lead_layers=lead0,
                   m_hint=int(m_hint), n_in=n_in, n_out=n_out,
                   itemsize=cd.itemsize)
    spec = PlanSpec(name=nm, kind="fc", impl=impl_nm, mode=mode,
                    n_in=n_in, n_out=n_out, k=k, block_k=block_k,
                    blocks=blk, w_sparsity=1.0 - k / n_in,
                    d_mem_bits=int(flow.d_mem_bits) * g,
                    i_mem_bits=int(flow.i_mem) * g,
                    w_mem_bits=int(flow.w_mem) * g,
                    experts=int(lead[1]) if len(lead) > 1 else 0,
                    tuned=tuned, blocks_static=blk_static,
                    m_hint=int(m_hint), decode_m=int(decode_m),
                    blocks_decode=blk_dec, packed=packed, pack_kb=pack_kb,
                    quant=quant, cost=tag)
    return LayerPlan(spec=spec, weights=weights)


def build_layer_plan(name: str, w: Tensor, *, mask: Tensor | None = None,
                     layer_spec: LayerSpec | None = None, m_hint: int = 128,
                     impl: str | None = None, ifm_sparsity: float = 0.0,
                     weight_buffer_bits: int | None = None, stride: int = 1,
                     conv_padding: Any = "SAME", tune: str = "off",
                     tune_cache: str | None = None, quant: str = "none",
                     objective: str = "latency",
                     deployment: Any = None) -> LayerPlan:
    """Derive one LayerPlan from a dense weight (output-major ``[O, N]`` for
    fc, ``[Co, Ci, Hk, Wk]`` for conv) and an optional pruning mask (else
    the weight's own nonzero pattern): the reference's `build_layer_plan`
    at its defaults for the rest (decode M 4, packing on, the weight's
    dtype, 16-bit format elements).

    The §V-C dataflow mode comes from ``layer_spec`` (an fc spec of the
    weight's shape when None) at the pattern's sparsity; ``impl`` overrides
    the §VI-F policy but degrades to "dense" when the pattern is not
    balanced (the mask is still applied).  ``m_hint`` is the GEMM M the
    prefill `BlockChoice` is resolved at (the decode one at M = 4);
    ``tune`` ("off" | "cached" | "sweep", cache file ``tune_cache``)
    selects how (`kernels.autotune.resolve_blocks`); a ``cuda`` fc layer
    is column-packed when that shrinks KB; ``quant`` block-quantizes a
    sparse encoding; ``objective`` / ``deployment`` select the plan
    objective (module docstring).  Built on the weight's device.
    """
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, "
                         f"got {quant!r}")
    decode_m, elem_bits = 4, 16
    kind = "conv" if w.ndim == 4 else "fc"
    hk = wk = 1
    if w.ndim == 4:
        co, _, hk, wk = w.shape
        w2 = w.reshape(co, -1)
        mask2 = mask.reshape(co, -1) if mask is not None else None
    elif w.ndim == 2:
        w2, mask2 = w, mask
    else:
        raise ValueError(f"expected 2-D or 4-D weights, got "
                         f"{tuple(w.shape)}")
    o, n = w2.shape
    masked2 = w2 * mask2 if mask2 is not None else w2
    pattern = (mask2 if mask2 is not None else w2) != 0
    k = balanced_mask_k(pattern)
    balanced = k is not None and k < n
    w_sparsity = 1.0 - (k / n) if balanced \
        else 1.0 - int(pattern.sum()) / pattern.numel()

    # -- dataflow mode (§V-C) ----------------------------------------------
    if layer_spec is None:
        layer_spec = LayerSpec(name=name, kind="fc", c_i=n, c_o=o)
    layer_spec = dataclasses.replace(layer_spec, w_sparsity=w_sparsity,
                                     ifm_sparsity=ifm_sparsity)
    flow = choose_dataflow(layer_spec, weight_buffer_bits=weight_buffer_bits)

    # -- kernel impl (§VI-F) + blocks + encoding ----------------------------
    if impl is None:
        impl = default_impl(balanced=balanced, w_sparsity=w_sparsity,
                            ifm_sparsity=ifm_sparsity, device=w.device)
    elif impl not in IMPL_LADDER:
        raise ValueError(f"impl must be one of {IMPL_LADDER}, got {impl!r}")
    elif impl != "dense" and not balanced:
        impl = "dense"
    dt = w2.dtype
    dep = _check_objective(objective, deployment)
    if objective != "latency" and impl != "dense" and _prefer_dense(
            objective=objective, dep=dep, layer_spec=layer_spec, kind=kind,
            impl=impl, m_hint=m_hint, n_out=o, n_in=n, k=k, pattern=pattern,
            itemsize=dt.itemsize, dtype=dt, quant=quant,
            elem_bits=elem_bits):
        impl = "dense"
    blocks = blocks_decode = blocks_static = None
    tuned = "static"
    block_k = 0
    packed = False
    pack_kb: Tuple = ()
    if impl == "dense":
        # conv keeps the 4-D layout apply_conv convolves with
        masked = (w * mask if mask is not None else w) if w.ndim == 4 \
            else masked2
        weights: Any = masked.to(dt)
        k = n
        quant = "none"
    else:
        res = autotune.resolve_blocks(m_hint, o, n, k, itemsize=dt.itemsize,
                                      impl=impl, tune=tune,
                                      cache_path=tune_cache, dtype=dt,
                                      quant=quant, device=w.device)
        blocks, tuned, blocks_static = res.blocks, res.source, res.static
        blocks_decode = autotune.resolve_blocks(
            decode_m, o, n, k, itemsize=dt.itemsize, impl=impl, tune=tune,
            cache_path=tune_cache, dtype=dt, quant=quant,
            device=w.device).blocks
        idx = nonzero_columns(pattern, k)               # ascending [O, K]
        vals = masked2.gather(1, idx).to(dt)
        idx = idx.to(torch.int32)
        block_k = max(_KB_ROUND,
                      _round_up(mask_block_k(pattern, bn=blocks.bn),
                                _KB_ROUND))
        if impl == "cuda" or quant != "none":
            n_enc, perm = n, None
            if impl == "cuda" and kind == "fc":
                pidx, pvals, block_k, n_enc, perm, pack_kb = _maybe_pack(
                    idx[None], vals[None], pattern, n, blocks.bn, block_k)
                idx, vals = pidx[0], pvals[0]
            tb = encode_tiled(vals, idx, n_enc, bn=blocks.bn, kb=block_k)
            weights = TiledBalanced(tb.values, tb.indices, tb.counts,
                                    n_in=n, bn=blocks.bn, perm=perm)
            packed = perm is not None
            if quant != "none":
                weights = quantize_tiled(weights, quant)
        else:
            weights = BalancedSparse(vals, idx, n)

    # -- cost provenance: evaluated on the actual encoding -----------------
    ev = _evaluate_cost(objective=objective, dep=dep, layer_spec=layer_spec,
                        kind=kind, m_hint=m_hint, n_in=n, n_out=o, k=int(k),
                        w_format_bits=_format_bits_of(weights,
                                                      elem_bits=elem_bits),
                        quant=quant, elem_bits=elem_bits)
    mode = flow.mode if objective == "latency" else ev["mode"]
    tag = _tag_for(objective=objective, dep=dep, ev=ev, mode=mode,
                   quant=quant, weights=weights, lead_layers=1,
                   m_hint=int(m_hint), n_in=n, n_out=o, itemsize=dt.itemsize)
    spec = PlanSpec(name=name, kind=kind, impl=impl, mode=mode,
                    n_in=n, n_out=o, k=int(k), block_k=block_k,
                    blocks=blocks, w_sparsity=float(w_sparsity),
                    d_mem_bits=int(flow.d_mem_bits),
                    i_mem_bits=int(flow.i_mem), w_mem_bits=int(flow.w_mem),
                    hk=hk, wk=wk, stride=stride, conv_padding=conv_padding,
                    tuned=tuned, blocks_static=blocks_static,
                    m_hint=int(m_hint), decode_m=int(decode_m),
                    blocks_decode=blocks_decode, packed=packed,
                    pack_kb=pack_kb, quant=quant, cost=tag)
    return LayerPlan(spec=spec, weights=weights)


def plan_from_balanced(sp: BalancedSparse, *, name: str = "adhoc",
                       impl: str = "cuda", block_k: int | None = None,
                       m_hint: int = 128, ifm_sparsity: float = 0.0,
                       tune: str = "off",
                       tune_cache: str | None = None) -> LayerPlan:
    """Wrap an existing flat BalancedSparse as a single-layer plan (the
    `core.sparse_ops` delegation path): ``cuda`` encodes it to the tile
    format (KB ``block_k`` rounded up to 8, else measured) at the blocks
    ``tune`` resolves, the eager rungs keep it flat.  No cost tag (as the
    reference's)."""
    o, k = sp.values.shape
    n = sp.n_in
    res = autotune.resolve_blocks(m_hint, o, n, k,
                                  itemsize=sp.values.element_size(),
                                  impl=impl, tune=tune,
                                  cache_path=tune_cache,
                                  device=sp.values.device)
    blocks = res.blocks
    if impl == "cuda":
        if block_k is None:
            block_k = max_block_count(sp.indices, n, blocks.bn)
        else:
            block_k = max(_KB_ROUND, _round_up(block_k, _KB_ROUND))
        weights: Any = encode_tiled(sp.values, sp.indices, n, bn=blocks.bn,
                                    kb=block_k)
    else:
        weights = sp
    w_sparsity = 1.0 - k / n
    flow = choose_dataflow(LayerSpec(name=name, kind="fc", c_i=n, c_o=o,
                                     w_sparsity=w_sparsity,
                                     ifm_sparsity=ifm_sparsity))
    spec = PlanSpec(name=name, kind="fc", impl=impl, mode=flow.mode,
                    n_in=n, n_out=o, k=k, block_k=block_k or 0,
                    blocks=blocks, w_sparsity=w_sparsity,
                    d_mem_bits=int(flow.d_mem_bits),
                    i_mem_bits=int(flow.i_mem), w_mem_bits=int(flow.w_mem),
                    tuned=res.source, blocks_static=res.static)
    return LayerPlan(spec=spec, weights=weights)


def plan_smallcnn(cfg, params: dict, masks: dict | None = None, *,
                  impl: str | None = None, ifm_sparsity: float = 0.0,
                  weight_buffer_bits: int | None = None,
                  m_hint: int = 4096, tune: str = "off",
                  tune_cache: str | None = None, quant: str = "none",
                  objective: str = "latency",
                  deployment: Any = None) -> ModelPlan:
    """One offline pass over the small CNN (`models.cnn`): conv layers with
    balanced masks go through the sparse conv path, balanced fc masks
    through the balanced GEMM, everything else stays dense (mask still
    applied).  Built on the params' device, in their dtype; ``tune`` and
    ``objective`` as in `build_layer_plan`."""
    masks = masks or {}
    layers: Dict[str, LayerPlan] = {}
    img, cin = cfg.img, 3
    for i, cout in enumerate(cfg.channels):
        name = f"conv{i}"
        hw = img // (2 ** i)
        geom = LayerSpec(name=name, kind="conv", h_i=hw, w_i=hw, c_i=cin,
                         c_o=cout, h_k=cfg.kernel, w_k=cfg.kernel, stride=1,
                         padding=cfg.kernel // 2)
        layers[name] = build_layer_plan(
            name, params[name], mask=masks.get(name), layer_spec=geom,
            m_hint=m_hint, impl=impl, ifm_sparsity=ifm_sparsity,
            weight_buffer_bits=weight_buffer_bits, conv_padding="SAME",
            tune=tune, tune_cache=tune_cache, quant=quant,
            objective=objective, deployment=deployment)
        cin = cout
    for name in ("fc1", "fc2"):
        layers[name] = build_layer_plan(
            name, params[name], mask=masks.get(name), m_hint=m_hint,
            impl=impl, ifm_sparsity=ifm_sparsity,
            weight_buffer_bits=weight_buffer_bits, tune=tune,
            tune_cache=tune_cache, quant=quant, objective=objective,
            deployment=deployment)
    meta = (("model", "smallcnn"),) + _cost_meta(objective, deployment) \
        + _tune_meta(tune, layers)
    return ModelPlan(layers=layers, meta=meta)


def _slot_sources(lp: LayerPlan):
    """Where each stored value slot of a sparse plan's encoding reads the
    layer's output-major ``[O, N]`` weight: ``(flat positions, live-slot
    mask)`` shaped as the stored values; pad slots (slot >= count) point at
    position 0 and are masked off (the flat format has none: mask None).
    None for a dense plan."""
    w, n = lp.weights, lp.spec.n_in
    if isinstance(w, TiledBalanced):
        if w.quant != "none" or w.indices.ndim != 3:
            raise ValueError(f"{lp.spec.name}: only an unquantized, "
                             "unstacked tiled encoding re-gathers its values")
        o, nb, kb = w.indices.shape
        dev = w.indices.device
        cols = (torch.arange(nb, device=dev)[None, :, None] * w.bn
                + w.indices.long())
        if w.perm is not None:                   # packed -> original column
            cols = w.perm.long()[cols]
        live = torch.arange(kb, device=dev) < w.counts[..., None]
        cols = torch.where(live, cols, 0)
        return torch.arange(o, device=dev)[:, None, None] * n + cols, live
    if isinstance(w, BalancedSparse):
        o = w.indices.shape[0]
        return (torch.arange(o, device=w.indices.device)[:, None] * n
                + w.indices.long()), None
    return None


class TrainPlan:
    """A `ModelPlan` frozen at one mask set, for training: the structure
    (pattern, indices, counts, packing perm, blocks, impl, mode) is built
    once; each call re-reads only the stored values from the live weights,
    ``(w * mask)`` at each slot's source position (pad slots exactly 0),
    so a train step does no pattern analysis and no host sync.  The result
    is array-equal to a fresh `plan_smallcnn` / `build_layer_plan` of the
    same weights and masks (the reference builds its plan once per trace
    with concrete masks and traced values: the same semantics), and
    differentiable: autograd carries each value's gradient back to its
    dense weight through the gather.  Quantized plans do not train."""

    def __init__(self, plan: ModelPlan, masks: dict | None = None):
        self.plan = plan
        self.masks = masks or {}
        self.sources = {nm: _slot_sources(lp)
                        for nm, lp in plan.layers.items()}

    def __call__(self, params: dict) -> ModelPlan:
        layers = {}
        for nm, lp in self.plan.layers.items():
            w, mask = params[nm], self.masks.get(nm)
            masked = w * mask if mask is not None else w
            src = self.sources[nm]
            old = lp.weights
            if src is None:
                weights: Any = masked.to(old.dtype).reshape(old.shape)
            else:
                pos, live = src
                vals = masked.reshape(-1)[pos].to(old.values.dtype)
                if live is not None:
                    vals = torch.where(live, vals, vals.new_zeros(()))
                weights = dataclasses.replace(old, values=vals)
            layers[nm] = LayerPlan(spec=lp.spec, weights=weights)
        return ModelPlan(layers=layers, meta=self.plan.meta)


def _resolve_sparsity(cfg, sparsity: float | None) -> float:
    sparsity = cfg.w_sparsity if sparsity is None else sparsity
    if not 0.0 < sparsity < 1.0:
        raise ValueError(f"need 0 < sparsity < 1, got {sparsity}")
    return sparsity


def _plan_names(cfg, params: dict, names, *, sparsity: float | None = None,
                impl: str | None = None, m_hint: int | None = None,
                decode_m: int | None = None, pack: bool = True,
                tune: str = "off", tune_cache: str | None = None,
                quant: str = "none", objective: str = "latency",
                deployment: Any = None) -> ModelPlan:
    """Plan the stacked leaves ``names`` of ``params["blocks"]`` (each
    through `_plan_stacked`, in the order given) with the model's meta."""
    sparsity = _resolve_sparsity(cfg, sparsity)
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got "
                         f"{quant!r}")
    blocks = params["blocks"]
    layers = {nm: _plan_stacked(nm, blocks[nm], sparsity=sparsity, impl=impl,
                                m_hint=m_hint or 256, cd=cfg.compute_dtype,
                                tune=tune, tune_cache=tune_cache,
                                decode_m=decode_m or 4, pack=pack,
                                quant=quant, objective=objective,
                                deployment=deployment)
              for nm in names}
    meta = (("model", cfg.name), ("sparsity", float(sparsity)),
            ("n_layers", int(cfg.n_layers)), ("quant", quant)) \
        + _cost_meta(objective, deployment) + _tune_meta(tune, layers)
    return ModelPlan(layers=layers, meta=meta)


def plan_transformer(cfg, params: dict, *, include_mlp: bool = True,
                     **kwargs) -> ModelPlan:
    """Offline plan for a transformer's stacked projections: attention
    ``[L, n_in, n_out]``, plus the MLP (or, for MoE, the shared experts)
    unless ``include_mlp`` is False.  For MoE the rank-4 expert tensors
    ``[L, E, n_in, n_out]`` get per-expert encodings with one shared
    BlockChoice / KB (`engine.execute.apply_expert_fc` runs them), also
    only with ``include_mlp``.  The keyword arguments (``sparsity``,
    ``impl``, ``m_hint``, ``decode_m``, ``pack``, ``tune``, ``tune_cache``,
    ``quant``: "none" | "int8" | "int4", ``objective``, ``deployment``)
    are `build_layer_plan`'s.  Built on the params' device."""
    if cfg.family not in TRANSFORMER_FAMILIES:
        raise ValueError(f"plan_transformer plans the {TRANSFORMER_FAMILIES} "
                         f"families, got {cfg.family!r} (plan_model "
                         "dispatches the others)")
    blocks = params["blocks"]
    names = [n for n in ATTN_PROJ_NAMES
             + ((MLP_PROJ_NAMES + MOE_SHARED_NAMES) if include_mlp else ())
             if n in blocks and blocks[n].ndim == 3]
    if include_mlp and cfg.family == "moe":
        names += [n for n in MOE_EXPERT_NAMES
                  if n in blocks and blocks[n].ndim == 4]
    return _plan_names(cfg, params, names, **kwargs)


def plan_rwkv6(cfg, params: dict, **kwargs) -> ModelPlan:
    """Offline plan for the RWKV6 projections (`RWKV6_PROJ_NAMES`: the
    time-mix R/K/V/G/O and the channel-mix matrices); the WKV recurrence
    is elementwise and stays dense, as the paper leaves non-CONV/FC ops
    dense.  Keyword arguments as `plan_transformer`'s."""
    names = [nm for nm in RWKV6_PROJ_NAMES if nm in params["blocks"]]
    return _plan_names(cfg, params, names, **kwargs)


def plan_zamba2(cfg, params: dict, **kwargs) -> ModelPlan:
    """Offline plan for the Zamba2 Mamba blocks' in/out projections
    (`ZAMBA2_PROJ_NAMES`); the shared attention block (``params["shared"]``,
    one unstacked weight set) is left to the dense path.  Keyword arguments
    as `plan_transformer`'s."""
    names = [nm for nm in ZAMBA2_PROJ_NAMES if nm in params["blocks"]]
    return _plan_names(cfg, params, names, **kwargs)


def plan_model(cfg, params: dict, **kwargs) -> ModelPlan:
    """Family dispatcher (the reference's ``plan_model``): the transformer
    families (`TRANSFORMER_FAMILIES`: dense, audio, vlm, moe) ->
    `plan_transformer`, ssm -> `plan_rwkv6`, hybrid -> `plan_zamba2`.
    Keyword arguments are forwarded unchanged; ``include_mlp`` is dropped
    for the recurrent planners."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return plan_transformer(cfg, params, **kwargs)
    kwargs.pop("include_mlp", None)
    if cfg.family == "ssm":
        return plan_rwkv6(cfg, params, **kwargs)
    if cfg.family == "hybrid":
        return plan_zamba2(cfg, params, **kwargs)
    raise ValueError(f"no planner for family {cfg.family!r}")


def masked_dense_params(params: dict, plan: ModelPlan) -> dict:
    """The masked-dense reference: the plan's pruned weights densified back
    into the params layout (``[L, n_in, n_out]``, ``[L, E, n_in, n_out]``
    for expert tensors) and dtype, one stacked layer at a time."""
    blocks = dict(params["blocks"])
    for nm, lp in plan.layers.items():
        out = torch.empty_like(params["blocks"][nm])
        for i in range(out.shape[0]):
            out[i] = lp.layer(i).dense_weights().transpose(-1, -2)
        blocks[nm] = out
    return {**params, "blocks": blocks}


# ---------------------------------------------------------------------------
# Shard-aware plans: the reference's specs of the encoded leaves
# ---------------------------------------------------------------------------

def _layer_weight_specs(lp: LayerPlan, mesh):
    """The weights of one `LayerPlan` with each tensor replaced by its
    spec: encoded leaves shard like the dense weights they replace — the
    stacked L axis replicated, the expert axis over ``model``, the output
    channels over the FSDP axes (`distributed.sharding.logical_spec`)."""
    from ..distributed import sharding as shd
    w = lp.weights
    fsdp = [shd.fsdp_axes(mesh)]

    def lead_plan(n_lead: int):
        # the first stacked axis is L (replicated); the second, when there
        # is one, the expert axis (model-parallel)
        return [None, ["model"] if lp.spec.experts else None][:n_lead]

    if isinstance(w, TiledBalanced):
        lead = w.values.dim() - 3
        vplan = lead_plan(lead) + [fsdp, None, None]
        perm_spec = None if w.perm is None else shd.logical_spec(
            mesh, w.perm.shape, lead_plan(w.perm.dim() - 1) + [None])
        scales_spec = None if w.scales is None else shd.logical_spec(
            mesh, w.scales.shape, lead_plan(lead) + [fsdp, None])
        return TiledBalanced(
            shd.logical_spec(mesh, w.values.shape, vplan),
            shd.logical_spec(mesh, w.indices.shape, vplan),
            shd.logical_spec(mesh, w.counts.shape,
                             lead_plan(lead) + [fsdp, None]),
            n_in=w.n_in, bn=w.bn, perm=perm_spec, scales=scales_spec,
            quant=w.quant)
    if isinstance(w, BalancedSparse):
        vplan = lead_plan(w.values.dim() - 2) + [fsdp, None]
        return BalancedSparse(shd.logical_spec(mesh, w.values.shape, vplan),
                              shd.logical_spec(mesh, w.indices.shape, vplan),
                              w.n_in)
    if lp.spec.kind == "conv":          # dense conv [Co, Ci, Hk, Wk]
        return shd.logical_spec(mesh, w.shape,
                                [fsdp] + [None] * (w.dim() - 1))
    return shd.logical_spec(mesh, w.shape,        # dense fc [*lead, O, N]
                            lead_plan(w.dim() - 2) + [fsdp, None])


def plan_specs(plan: ModelPlan, mesh) -> ModelPlan:
    """A `ModelPlan` of ``plan``'s structure whose weight tensors are
    replaced by their specs (`_layer_weight_specs`), the reference's
    placement of the encoded values, indices and counts over a mesh."""
    return ModelPlan(
        layers={nm: LayerPlan(spec=lp.spec,
                              weights=_layer_weight_specs(lp, mesh))
                for nm, lp in plan.layers.items()},
        meta=plan.meta)


def _map_weights(w, fn):
    """The weights (`TiledBalanced`, `BalancedSparse` or one tensor) with
    ``fn`` applied to each tensor (or spec) leaf."""
    if isinstance(w, TiledBalanced):
        return TiledBalanced(
            fn(w.values), fn(w.indices), fn(w.counts), n_in=w.n_in,
            bn=w.bn, perm=None if w.perm is None else fn(w.perm),
            scales=None if w.scales is None else fn(w.scales),
            quant=w.quant)
    if isinstance(w, BalancedSparse):
        return BalancedSparse(fn(w.values), fn(w.indices), w.n_in)
    return fn(w)


def weight_leaves(w) -> Dict[str, Any]:
    """The tensor (or spec) leaves of the weights by field name."""
    if isinstance(w, TiledBalanced):
        return {k: getattr(w, k) for k in ("values", "indices", "counts",
                                           "perm", "scales")
                if getattr(w, k) is not None}
    if isinstance(w, BalancedSparse):
        return {"values": w.values, "indices": w.indices}
    return {"w": w}


def _with_leaves(w, leaves: Dict[str, Any]):
    if isinstance(w, (TiledBalanced, BalancedSparse)):
        return dataclasses.replace(w, **leaves)
    return leaves["w"]


def shard_plan(plan: ModelPlan, mesh) -> ModelPlan:
    """The plan placed on its `plan_specs`: on a live mesh
    (`launch.mesh.LiveMesh`) each rank keeps its shard of every encoded
    leaf (values, indices, counts and scales over the FSDP axes, ``perm``
    whole), and every `LayerPlan` carries its placement for
    `gather_layer`; on a description nothing is placed, and the plan is
    returned as it is."""
    from ..distributed import sharding as shd
    if not isinstance(mesh, LiveMesh):
        return plan
    specs = plan_specs(plan, mesh)
    layers = {}
    for nm, lp in plan.layers.items():
        ws = specs.layers[nm].weights
        spec_leaves = weight_leaves(ws)
        shards = {k: shd.place(t, mesh, spec_leaves[k])
                  for k, t in weight_leaves(lp.weights).items()}
        layers[nm] = LayerPlan(spec=lp.spec,
                               weights=_with_leaves(lp.weights, shards),
                               placement=(mesh, ws))
    return ModelPlan(layers=layers, meta=plan.meta)


def gather_layer(lp: LayerPlan) -> LayerPlan:
    """ZeRO-3 ("zero redundancy", stage 3): a placed layer's encoding
    gathered over the axes its `plan_specs` split it on, one
    ``all_gather`` a layer, just before use (the reference's
    ``gather_for_use`` for plans).  A layer without experts comes back
    whole, bit for bit the one-process encoding.  An expert layer is
    gathered over the FSDP axes only: its expert axis stays split over
    ``model`` (expert parallelism), so it comes back as this rank's block
    of experts, each whole, bit for bit the one-process encoding's slice
    of them (``perm`` and ``scales`` follow their specs as the other
    leaves do).  A whole layer is returned as it is."""
    if lp.placement is None:
        return lp
    from ..distributed import sharding as shd
    mesh, ws = lp.placement
    specs = weight_leaves(ws)
    axes = {a for sp in specs.values() for d in sp for a in shd.spec_axes(d)}
    if lp.spec.experts:
        axes &= set(shd.fsdp_axes(mesh))
    whole = shd.gather_tree(weight_leaves(lp.weights), mesh, specs, axes)
    return LayerPlan(spec=lp.spec, weights=_with_leaves(lp.weights, whole))


__all__ = ["LayerPlan", "ModelPlan", "PlanSpec", "TrainPlan", "IMPL_LADDER",
           "default_impl", "balanced_mask_k", "mask_block_k",
           "build_layer_plan", "plan_from_balanced", "plan_smallcnn",
           "plan_transformer", "plan_rwkv6", "plan_zamba2", "plan_model",
           "masked_dense_params", "plan_specs", "shard_plan",
           "gather_layer", "weight_leaves", "ATTN_PROJ_NAMES",
           "MLP_PROJ_NAMES", "MOE_SHARED_NAMES", "MOE_EXPERT_NAMES",
           "RWKV6_PROJ_NAMES", "ZAMBA2_PROJ_NAMES"]
