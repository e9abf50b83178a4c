"""Gradient compression with error feedback — counterpart of
`repro.distributed.compress`.

int8 block-quantized payload plus an error-feedback residual: the
quantization error of step t is added back into step t+1's gradient, so
the compressed trajectory tracks the exact one (Karimireddy et al.).  On
one card no payload crosses a link; the numerics, and the error-feedback
correction, are what a fleet would see.  Plugs into the trainer's step
before `optim.adamw_update`.

On a live mesh (`compress_tree` with ``mesh=`` and ``specs``) the
gradients and residuals are this rank's blocks, and the quantization is
the reference's of the whole leaf: 256-element blocks of the leaf's
row-major flattening, one of which may span several ranks (a leaf cut on
a dim but the first, or a rank's rows short of a whole block).  Each rank
takes the partial max |value| of every block its elements fall in, one
``all_reduce`` (max) over the axes that cut the leaves combines the
partials of all the leaves cut alike (1/256 of their float32 bytes), and
each rank quantizes its own elements with their block's scale.  No rank
gathers a gradient.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import sharding as shd
from ..tree import at_path, flatten_with_paths, leaves, tree_map, unflatten

Tensor = torch.Tensor


def quantize_int8(x: Tensor, *, block: int = 256):
    """Per-block symmetric int8 quantization.  Returns ``(q, scales)``:
    int8 ``[nblocks, block]`` and f32 ``[nblocks, 1]``."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block).float()
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = scale.clamp(min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: Tensor, scale: Tensor, shape, dtype) -> Tensor:
    out = (q.float() * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return out[:n].reshape(shape).to(dtype)


def _one(g: Tensor, r: Tensor) -> tuple:
    g32 = g.float() + r
    q, s = quantize_int8(g32)
    deq = dequantize_int8(q, s, g.shape, torch.float32)
    return deq.to(g.dtype), g32 - deq


def compress_tree(grads, residuals, *, mesh=None, specs=None):
    """Quantize grads + residual; returns ``(dequantized grads, new
    residuals)``, the residuals f32.  On a live ``mesh`` the leaves are
    this rank's blocks laid out by ``specs`` (see the module docstring);
    the result's blocks are the whole-leaf result's, bit for bit."""
    if mesh is None:
        out = [_one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
        return (unflatten(grads, [o[0] for o in out]),
                unflatten(grads, [o[1] for o in out]))
    flat = flatten_with_paths(grads)
    res = leaves(residuals)
    out: list = [None] * len(flat)
    cut_leaves: dict = {}          # cut axes -> [(i, g32, block ids)]
    for i, ((path, g), r) in enumerate(zip(flat, res)):
        spec = at_path(specs, path)
        named = {a for d in spec for a in shd.spec_axes(d)}
        cut = tuple(a for a in mesh.axis_names
                    if a in named and mesh.shape[a] > 1)
        if not cut:
            out[i] = _one(g, r)
            continue
        g32 = g.float() + r
        cut_leaves.setdefault(cut, []).append(
            (i, g32, _block_ids(mesh, g32.shape, spec, g32.device)))
    for cut, items in cut_leaves.items():
        parts = []
        for i, g32, ids in items:
            part = torch.zeros(_whole_blocks(mesh, g32.shape, at_path(
                specs, flat[i][0])), dtype=torch.float32, device=g32.device)
            parts.append(part.scatter_reduce_(
                0, ids.reshape(-1), g32.abs().reshape(-1), "amax"))
        amax = shd.all_max(torch.cat(parts), mesh, cut)
        off = 0
        for (i, g32, ids), part in zip(items, parts):
            scale = (amax[off:off + part.numel()] / 127.0).clamp(min=1e-12)
            off += part.numel()
            s = scale[ids]
            q = torch.clamp(torch.round(g32 / s), -127, 127).to(torch.int8)
            deq = q.float() * s
            out[i] = (deq.to(flat[i][1].dtype), g32 - deq)
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def _whole_blocks(mesh, shape, spec, block: int = 256) -> int:
    """The 256-element blocks of the whole leaf's flattening."""
    return -(-math.prod(shd.whole_shape(mesh, shape, spec)) // block)


def _block_ids(mesh, shape, spec, device, block: int = 256) -> Tensor:
    """The block of the whole leaf's row-major flattening that each
    element of this rank's block (``shape``, laid out by ``spec``) falls
    in, int64 of ``shape``."""
    whole = shd.whole_shape(mesh, shape, spec)
    region = shd.block_region(mesh, whole, spec)
    stride = 1
    flat = torch.zeros(shape, dtype=torch.int64, device=device)
    for k in reversed(range(len(shape))):
        start, size = region[k]
        idx = torch.arange(start, start + size, dtype=torch.int64,
                           device=device) * stride
        flat = flat + idx.reshape([-1] + [1] * (len(shape) - 1 - k))
        stride *= whole[k]
    return flat // block


def zero_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
