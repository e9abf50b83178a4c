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
`launch/serve.py` asserts on it that the sparse path really ran.
"""
from __future__ import annotations

import collections

import torch
import torch.nn.functional as F

from ..kernels import ops as kernel_ops
from ..kernels.sparse_conv import _pad_nhwc, _resolve_padding
from ..kernels.sparse_conv import sparse_conv2d as _sparse_conv2d
from ..kernels.tile_format import TiledBalanced
from .plan import LayerPlan, ModelPlan

Tensor = torch.Tensor

STATS: "collections.Counter[str]" = collections.Counter()


def reset_stats() -> None:
    STATS.clear()


def stats() -> dict:
    return dict(STATS)


def _count_dispatch(spec, *extra: str) -> None:
    """Record one balanced-sparse dispatch: the family, the impl, the
    quant mode of a quantized plan (``quant_<mode>``), and any extra tags
    (``decode_dispatch`` for skinny M)."""
    STATS["balanced_spmm"] += 1
    STATS[f"impl_{spec.impl}"] += 1
    if spec.quant != "none":
        STATS[f"quant_{spec.quant}"] += 1
    for name in extra:
        STATS[name] += 1


def apply_fc(x: Tensor, lp: LayerPlan) -> Tensor:
    """``y = x @ W.T`` for one planned linear layer, ``[..., N] ->
    [..., O]``.  ``block_m`` is clamped to the live M's power-of-two bucket
    (8-row floor), so a small live M never pads to a stale prefill tile;
    this changes which tile the kernel pads to, not the result."""
    spec = lp.spec
    if spec.impl == "dense":
        STATS["dense_matmul"] += 1
        return x @ lp.weights.T.to(x.dtype)
    m = 1
    for d in x.shape[:-1]:
        m *= d
    skinny = m <= kernel_ops.SKINNY_M
    _count_dispatch(spec, *(("decode_dispatch",) if skinny else ()))
    if isinstance(lp.weights, TiledBalanced):
        blk = spec.blocks_decode if skinny and spec.blocks_decode \
            else spec.blocks
        bm = min(blk.bm, max(8, kernel_ops.bucket_m(m)))
        return kernel_ops.tiled_spmm(x, lp.weights, block_m=bm,
                                     block_o=blk.bo, impl=spec.impl)
    sp = lp.weights
    return kernel_ops.balanced_spmm(x, sp.values, sp.indices,
                                    n_in=spec.n_in, impl=spec.impl)


def apply_expert_fc(x: Tensor, lp: LayerPlan) -> Tensor:
    """Per-expert planned projection ``x [E, ..., N] -> [E, ..., O]`` (the
    plan of a rank-4 ``[L, E, n_in, n_out]`` expert tensor, sliced to one
    layer).  Every impl is one dispatch over all experts: ``cuda`` runs
    `kernels.ops.tiled_spmm_batched` (the expert is a grid axis of one
    kernel launch), the eager rungs `kernels.ops.balanced_spmm_batched`.
    The same live-M clamp of ``block_m`` as `apply_fc`, with M the
    per-expert capacity.  Counts ``expert_balanced_spmm`` in `STATS`."""
    spec = lp.spec
    e = x.shape[0]
    if spec.impl == "dense":
        STATS["dense_matmul"] += 1
        x3 = x.reshape(e, -1, x.shape[-1])
        y = torch.bmm(x3, lp.weights.to(x.dtype).transpose(1, 2))
        return y.reshape(*x.shape[:-1], y.shape[-1])
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
        return kernel_ops.tiled_spmm_batched(x, lp.weights, block_m=bm,
                                             block_o=blk.bo, impl=spec.impl)
    sp = lp.weights
    return kernel_ops.balanced_spmm_batched(x, sp.values, sp.indices,
                                            n_in=spec.n_in, impl=spec.impl)


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
        STATS["dense_conv"] += 1
        w = lp.weights.to(x.dtype)
        xp = _pad_nhwc(x, *_resolve_padding(x.shape[1], x.shape[2], spec.hk,
                                            spec.wk, spec.stride,
                                            spec.conv_padding))
        y = F.conv2d(xp.permute(0, 3, 1, 2), w, stride=spec.stride)
        return y.permute(0, 2, 3, 1)
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
    return _sparse_conv2d(x, vals, idx, spec.n_in, hk=spec.hk, wk=spec.wk,
                          stride=spec.stride, padding=spec.conv_padding,
                          matmul_fn=matmul_fn)


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
           "apply_named", "stats", "reset_stats", "STATS"]
