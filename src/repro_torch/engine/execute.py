"""Plan execution: dispatch one pre-built `LayerPlan` per call site —
counterpart of `repro.engine.execute`.

``cuda`` plans, and quantized plans on every sparse rung, run the
pre-encoded `kernels.ops.tiled_spmm` at the plan's blocks (decode-shaped
ones when M is skinny), the other eager-rung plans the flat
`kernels.ops.balanced_spmm`, dense layers a plain matmul on the masked
weights; `apply_expert_fc` does the same for the MoE experts, every expert
in one dispatch; `apply_conv` runs a planned convolution (the sparse ones
through the chunked im2col GEMM of `kernels.sparse_conv`, the dense ones
through ``F.conv2d`` on the masked weight).  `STATS` counts balanced-sparse
dispatches per call
(PyTorch runs eagerly, so this is per execution, not per trace);
`launch/serve.py` asserts on it that the sparse path really ran.  On a
live mesh `apply_fc` and `apply_expert_fc` gather a placed layer's
encoding before the kernel (`engine.plan.gather_layer`; an expert layer
keeps its experts split over ``model``).  A layer
whose blocks came from the autotuner ticks ``tuned_blocks``; a layer the
guard ladder demoted or quarantined (``spec.degraded_from``) ticks
``degraded_dispatch`` on every dispatch, dense ones included.

`BYTE_STATS` counts the bytes each dispatch streams, keyed by layer name:
the stored weights (every tensor of the layer's encoding, nibble-packed
int4 included; computed once per `LayerPlan`, `LayerPlan.nbytes`) plus
the activation operand and result, from their shapes.  The plan's
`CostTag` models the same bytes (``w_stream_bytes``, ``act_in_bytes``,
``act_out_bytes``); the model-vs-measurement contract holds them equal.

`next_impl` / `demote_layer` are the ladder's mechanics (policy in
`engine.guard`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..core.pruning import BalancedSparse
from ..kernels import ops as kernel_ops
from ..kernels.sparse_conv import _pad_nhwc, _resolve_padding
from ..kernels.sparse_conv import sparse_conv2d as _sparse_conv2d
from ..kernels.tile_format import TiledBalanced, tiled_to_flat
from ..launch.cost_model import IMPL_LADDER
from .plan import LayerPlan, ModelPlan, gather_layer

Tensor = torch.Tensor

STATS: "collections.Counter[str]" = collections.Counter()

# per-layer streamed-byte counters (see module docstring)
BYTE_STATS: Dict[str, "collections.Counter[str]"] = {}

# experts a dispatch of `apply_expert_fc` ran -> dispatches
EXPERT_BLOCKS: "collections.Counter[int]" = collections.Counter()


def reset_stats() -> None:
    STATS.clear()
    BYTE_STATS.clear()
    EXPERT_BLOCKS.clear()


def stats() -> dict:
    return dict(STATS)


def bytes_stats() -> dict:
    """Per-layer streamed bytes: ``{layer: {bytes_weights, bytes_act_in,
    bytes_act_out, dispatches}}``."""
    return {nm: dict(c) for nm, c in BYTE_STATS.items()}


def _count_bytes(lp: LayerPlan, x: Tensor, y: Tensor) -> None:
    """Record one dispatch's streamed bytes: the layer's stored weights
    (one stacked layer's slice, as the model dispatches it) and x and y
    from their shapes."""
    wb = lp.nbytes()
    xb = x.numel() * x.element_size()
    yb = y.numel() * y.element_size()
    c = BYTE_STATS.get(lp.spec.name)
    if c is None:
        c = BYTE_STATS[lp.spec.name] = collections.Counter()
    c["bytes_weights"] += wb
    c["bytes_act_in"] += xb
    c["bytes_act_out"] += yb
    c["dispatches"] += 1
    STATS["bytes_weights"] += wb
    STATS["bytes_act_in"] += xb
    STATS["bytes_act_out"] += yb


def _count_dense(spec, kind: str) -> None:
    """Record one dense dispatch (``dense_matmul`` / ``dense_conv``)."""
    STATS[kind] += 1
    if spec.degraded_from:
        STATS["degraded_dispatch"] += 1


def _count_dispatch(spec, *extra: str) -> None:
    """Record one balanced-sparse dispatch: the family, the impl, a
    ``tuned_blocks`` tick when the blocks came from the autotuner, a
    ``degraded_dispatch`` tick for a layer the guard demoted, the quant
    mode of a quantized plan (``quant_<mode>``), and any extra tags
    (``decode_dispatch`` for skinny M)."""
    STATS["balanced_spmm"] += 1
    STATS[f"impl_{spec.impl}"] += 1
    if spec.tuned != "static":
        STATS["tuned_blocks"] += 1
    if spec.degraded_from:
        STATS["degraded_dispatch"] += 1
    if spec.quant != "none":
        STATS[f"quant_{spec.quant}"] += 1
    for name in extra:
        STATS[name] += 1


# ---------------------------------------------------------------------------
# Impl-degradation ladder (the mechanics; the policy lives in engine.guard)
# ---------------------------------------------------------------------------

def next_impl(impl: str) -> str | None:
    """The next rung down `IMPL_LADDER` (None below dense)."""
    i = IMPL_LADDER.index(impl)
    return IMPL_LADDER[i + 1] if i + 1 < len(IMPL_LADDER) else None


def _tiled_to_flat_stacked(w: TiledBalanced):
    """`tiled_to_flat` over any leading stacked axes ``[*lead, O, NB, KB]``:
    the lead axes fold into the rows (every row holds the same K), the
    (lead-broadcast) perm passes through, so the flat indices come out in
    original column order, ascending; a quantized encoding is dequantized
    first (f32 values)."""
    lead = w.indices.shape[:-3]
    perm = w.perm
    if perm is not None and perm.ndim > 1:
        perm = perm.reshape(-1, perm.shape[-1])[0]
    flat = TiledBalanced(w.values.reshape(-1, *w.values.shape[-2:]),
                         w.indices.reshape(-1, *w.indices.shape[-2:]),
                         w.counts.reshape(-1, w.counts.shape[-1]),
                         n_in=w.n_in, bn=w.bn, perm=perm,
                         scales=None if w.scales is None
                         else w.scales.reshape(-1, w.scales.shape[-1]),
                         quant=w.quant)
    vals, idx = tiled_to_flat(flat)
    k = vals.shape[-1]
    o = w.indices.shape[-3]
    return vals.reshape(*lead, o, k), idx.reshape(*lead, o, k)


def demote_layer(lp: LayerPlan, *, to_impl: str | None = None,
                 ref_dense: Tensor | None = None) -> LayerPlan:
    """Re-target one LayerPlan at a lower ladder rung, re-encoding the
    weights to that rung's format: ``cuda`` -> ``xla`` / ``xla_gather``
    decodes the tiled encoding to the flat format (a quantized one keeps
    its tiled encoding, whose scales are tile-local); any rung -> ``dense``
    densifies, or takes ``ref_dense`` (``[*lead, O, N]``, the quarantine
    path: a known-good masked weight replaces a suspect encoding).  The
    original impl is kept in ``spec.degraded_from``; a re-encoding drops
    the cost tag (its byte counts no longer hold)."""
    spec = lp.spec
    to_impl = to_impl or next_impl(spec.impl)
    if to_impl is None:
        raise ValueError(f"{spec.name}: no rung below impl {spec.impl!r}")
    if to_impl == spec.impl and ref_dense is None:
        return lp
    origin = spec.degraded_from or spec.impl
    if to_impl == "dense":
        weights = ref_dense if ref_dense is not None else lp.dense_weights()
        if spec.kind == "conv" and weights.ndim == 2:
            # apply_conv's dense path convolves the 4-D layout
            ci = spec.n_in // (spec.hk * spec.wk)
            weights = weights.reshape(spec.n_out, ci, spec.hk, spec.wk)
        new_spec = dataclasses.replace(spec, impl="dense", k=spec.n_in,
                                       blocks=None, block_k=0,
                                       blocks_decode=None, packed=False,
                                       quant="none", degraded_from=origin,
                                       cost=None)
        return LayerPlan(spec=new_spec, weights=weights)
    if isinstance(lp.weights, TiledBalanced) and spec.quant != "none":
        return LayerPlan(spec=dataclasses.replace(spec, impl=to_impl,
                                                  degraded_from=origin),
                         weights=lp.weights)   # same encoding: tag holds
    if isinstance(lp.weights, TiledBalanced):
        vals, idx = _tiled_to_flat_stacked(lp.weights)
        weights: Any = BalancedSparse(vals, idx, spec.n_in)
    else:
        weights = lp.weights             # xla <-> xla_gather share a format
    return LayerPlan(spec=dataclasses.replace(spec, impl=to_impl,
                                              packed=False,
                                              degraded_from=origin,
                                              cost=None),
                     weights=weights)


def apply_fc(x: Tensor, lp: LayerPlan) -> Tensor:
    """``y = x @ W.T`` for one planned linear layer, ``[..., N] ->
    [..., O]``.  ``block_m`` is clamped to the live M's power-of-two bucket
    (8-row floor), so a small live M never pads to a stale prefill tile;
    this changes which tile the kernel pads to, not the result.  A layer
    placed on a live mesh (`plan.shard_plan`) is gathered whole first
    (`plan.gather_layer`, ZeRO-3), and the kernel runs on this rank's
    rows of ``x``; the counts are those of the whole layer."""
    lp = gather_layer(lp)
    spec = lp.spec
    if spec.impl == "dense":
        _count_dense(spec, "dense_matmul")
        y = x @ lp.weights.T.to(x.dtype)
        _count_bytes(lp, x, y)
        return y
    m = 1
    for d in x.shape[:-1]:
        m *= d
    skinny = m <= kernel_ops.SKINNY_M
    _count_dispatch(spec, *(("decode_dispatch",) if skinny else ()))
    if isinstance(lp.weights, TiledBalanced):
        blk = spec.blocks_decode if skinny and spec.blocks_decode \
            else spec.blocks
        bm = min(blk.bm, max(8, kernel_ops.bucket_m(m)))
        y = kernel_ops.tiled_spmm(x, lp.weights, block_m=bm,
                                  block_o=blk.bo, impl=spec.impl)
    else:
        sp = lp.weights
        y = kernel_ops.balanced_spmm(x, sp.values, sp.indices,
                                     n_in=spec.n_in, impl=spec.impl)
    _count_bytes(lp, x, y)
    return y


def apply_expert_fc(x: Tensor, lp: LayerPlan) -> Tensor:
    """Per-expert planned projection ``x [E, ..., N] -> [E, ..., O]`` (the
    plan of a rank-4 ``[L, E, n_in, n_out]`` expert tensor, sliced to one
    layer).  Every impl is one dispatch over all experts: ``cuda`` runs
    `kernels.ops.tiled_spmm_batched` (the expert is a grid axis of one
    kernel launch), the eager rungs `kernels.ops.balanced_spmm_batched`.
    The same live-M clamp of ``block_m`` as `apply_fc`, with M the
    per-expert capacity.  Counts ``expert_balanced_spmm`` in `STATS`, and
    the experts it ran in `EXPERT_BLOCKS`.  A layer placed on a live mesh
    is gathered first (`plan.gather_layer`): its experts stay split over
    ``model``, so ``x`` holds this rank's block of experts (``E / model``)
    and the kernel runs on that block; as in `apply_fc`, the counts are
    those of the gathered layer."""
    lp = gather_layer(lp)
    spec = lp.spec
    e = x.shape[0]
    EXPERT_BLOCKS[e] += 1
    if spec.impl == "dense":
        _count_dense(spec, "dense_matmul")
        x3 = x.reshape(e, -1, x.shape[-1])
        y = torch.bmm(x3, lp.weights.to(x.dtype).transpose(1, 2))
        y = y.reshape(*x.shape[:-1], y.shape[-1])
        _count_bytes(lp, x, y)
        return y
    m = 1
    for d in x.shape[1:-1]:
        m *= d
    skinny = m <= kernel_ops.SKINNY_M
    _count_dispatch(spec, "expert_balanced_spmm",
                    *(("decode_dispatch",) if skinny else ()))
    if isinstance(lp.weights, TiledBalanced):
        blk = spec.blocks_decode if skinny and spec.blocks_decode \
            else spec.blocks
        bm = min(blk.bm, max(8, kernel_ops.bucket_m(m)))
        y = kernel_ops.tiled_spmm_batched(x, lp.weights, block_m=bm,
                                          block_o=blk.bo, impl=spec.impl)
    else:
        sp = lp.weights
        y = kernel_ops.balanced_spmm_batched(x, sp.values, sp.indices,
                                             n_in=spec.n_in, impl=spec.impl)
    _count_bytes(lp, x, y)
    return y


def apply_conv(x: Tensor, lp: LayerPlan) -> Tensor:
    """NHWC convolution ``[B, H, W, Ci] -> [B, Ho, Wo, Co]`` for a planned
    conv layer: a dense plan convolves the masked 4-D weight (``F.conv2d``
    in x's dtype, NCHW views of the NHWC tensors); a sparse plan lowers to
    the chunked im2col + balanced GEMM of `kernels.sparse_conv.sparse_conv2d`
    with the plan's encoding: `kernels.ops.tiled_spmm` at the plan's blocks
    on a tiled one, the flat `kernels.ops.balanced_spmm` otherwise.  Counts
    ``sparse_conv`` (or ``dense_conv``) in `STATS`."""
    spec = lp.spec
    if spec.impl == "dense":
        _count_dense(spec, "dense_conv")
        w = lp.weights.to(x.dtype)
        xp = _pad_nhwc(x, *_resolve_padding(x.shape[1], x.shape[2], spec.hk,
                                            spec.wk, spec.stride,
                                            spec.conv_padding))
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=spec.stride)
        y = y.permute(0, 2, 3, 1)
        _count_bytes(lp, x, y)
        return y
    _count_dispatch(spec, "sparse_conv")
    if isinstance(lp.weights, TiledBalanced):
        tb = lp.weights
        blk = spec.blocks

        def matmul_fn(flat, values, indices, n_in):
            return kernel_ops.tiled_spmm(flat, tb, block_m=blk.bm,
                                         block_o=blk.bo, impl=spec.impl)
        vals, idx = tb.values, tb.indices
    else:
        sp = lp.weights

        def matmul_fn(flat, values, indices, n_in):
            return kernel_ops.balanced_spmm(flat, values, indices,
                                            n_in=n_in, impl=spec.impl,
                                            block_k=spec.block_k)
        vals, idx = sp.values, sp.indices
    y = _sparse_conv2d(x, vals, idx, spec.n_in, hk=spec.hk, wk=spec.wk,
                       stride=spec.stride, padding=spec.conv_padding,
                       matmul_fn=matmul_fn)
    _count_bytes(lp, x, y)
    return y


def apply_layer(x: Tensor, lp: LayerPlan) -> Tensor:
    """Spec-directed dispatch: conv plans expect NHWC, expert plans
    ``[E, ..., N]``, fc plans ``[..., N]``."""
    if lp.spec.kind == "conv":
        return apply_conv(x, lp)
    if lp.spec.experts:
        return apply_expert_fc(x, lp)
    return apply_fc(x, lp)


def apply_named(x: Tensor, plan: ModelPlan, name: str) -> Tensor:
    return apply_layer(x, plan.layers[name])


__all__ = ["apply_fc", "apply_expert_fc", "apply_conv", "apply_layer",
           "apply_named", "stats", "reset_stats", "bytes_stats", "STATS",
           "BYTE_STATS", "EXPERT_BLOCKS", "IMPL_LADDER", "next_impl",
           "demote_layer"]
