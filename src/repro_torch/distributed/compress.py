"""Gradient compression with error feedback — counterpart of
`repro.distributed.compress`.

int8 block-quantized payload plus an error-feedback residual: the
quantization error of step t is added back into step t+1's gradient, so
the compressed trajectory tracks the exact one (Karimireddy et al.).  On
one card no payload crosses a link; the numerics, and the error-feedback
correction, are what a fleet would see.  Plugs into the trainer's step
before `optim.adamw_update`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..tree import leaves, tree_map, unflatten

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


def compress_tree(grads, residuals):
    """Quantize grads + residual; returns ``(dequantized grads, new
    residuals)``, the residuals f32."""
    def one(g, r):
        g32 = g.float() + r
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s, g.shape, torch.float32)
        return deq.to(g.dtype), g32 - deq

    out = [one(g, r) for g, r in zip(leaves(grads), leaves(residuals))]
    return (unflatten(grads, [o[0] for o in out]),
            unflatten(grads, [o[1] for o in out]))


def zero_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
