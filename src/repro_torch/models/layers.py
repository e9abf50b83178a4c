"""Shared model primitives — counterpart of `repro.models.layers` (norms,
RoPE, prefill and decode attention).  Scores, softmax and the value sum run
in f32 and the result is cast back to the activation dtype, as the
reference's ``preferred_element_type=f32`` einsums do.  Masks select with
`torch.where`, never multiply (0 * NaN would poison the output)."""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def rms_norm(x: Tensor, gamma: Tensor | None, *, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if gamma is not None:
        y = y * gamma
    return y.to(x.dtype)


def layer_norm(x: Tensor, gamma: Tensor | None = None,
               beta: Tensor | None = None, *, eps: float = 1e-5) -> Tensor:
    """LayerNorm; with gamma=beta=None it is OLMo's non-parametric LN."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y.to(x.dtype)


def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     device=None) -> Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, *,
               theta: float = 10000.0) -> Tensor:
    """x: ``[..., S, H, dh]``; positions: ``[..., S]`` (int)."""
    freqs = rope_frequencies(x.shape[-1], theta=theta, device=x.device)
    angles = positions[..., None].float() * freqs          # [..., S, dh/2]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def causal_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """Causal prefill attention, q ``[B, S, H, dh]``, k/v ``[B, S, KH, dh]``
    with H = KH * G (grouped, no KV repetition).  The counterpart of the
    reference's ``blocked_causal_attention`` as one masked softmax: at the
    serving prompt lengths the ``[S, S]`` scores are small."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, s, kh, h // kh, dh).float()
    sc = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]                      # [q, k]
    sc = torch.where(mask, sc, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh).to(q.dtype)


def decode_attention_planes(q: Tensor, k_planes: Tensor, v_planes: Tensor,
                            cache_len: Tensor) -> Tensor:
    """Chunked decode attention on a plane-layout KV cache.

    q: ``[B, C, H, dh]`` — C >= 1 new tokens whose K/V rows were just
    written at ``cache_len .. cache_len + C - 1``; k/v planes ``[B*KH, Smax,
    dh]`` (plane ``b * KH + h``); query i attends to positions
    ``j <= cache_len + i``.
    """
    b, c, h, dh = q.shape
    kh = k_planes.shape[0] // b
    smax = k_planes.shape[1]
    k4 = k_planes.reshape(b, kh, smax, dh).float()
    v4 = v_planes.reshape(b, kh, smax, dh).float()
    qg = q.reshape(b, c, kh, h // kh, dh).float()
    sc = torch.einsum("bqhgd,bhkd->bhgqk", qg, k4) / math.sqrt(dh)
    pos = torch.arange(smax, device=q.device)
    last = cache_len[:, None] + torch.arange(c, device=q.device)[None, :]
    mask = pos[None, None, :] <= last[:, :, None]            # [B, C, Smax]
    sc = torch.where(mask[:, None, None], sc, float("-inf"))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v4)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, dh).to(q.dtype)
