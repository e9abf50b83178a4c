"""Decoder-only dense transformer (olmo-1b and the other dense configs) —
counterpart of the dense family of `repro.models.transformer`.

Layer parameters are stacked on a leading L axis, in the reference's
layout (``[L, n_in, n_out]``), and walked with a Python loop.  The KV cache
uses the plane layout ``[L, B*KH, Smax, dh]`` (plane ``b * KH + h``) and
decode writes new rows with the reference's ``cache_update="mask"`` select:
exact (one-hot products), and never out of range.

Sense integration: with ``cfg.sparse_serving`` and a plan attached
(``params["sparse_plan"]``), prefill *and* decode run every planned
projection through `engine.execute.apply_fc` — the CUDA kernels on a GPU.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .api import ModelBundle, planned_proj as _proj, serving_plan
from .layers import (apply_rope, causal_attention, decode_attention_planes,
                     layer_norm, rms_norm)

Tensor = torch.Tensor
KV_DTYPE = torch.bfloat16       # the cache is bf16 by construction


def _norm(cfg: ModelConfig, x: Tensor, gamma: Tensor | None) -> Tensor:
    if cfg.norm == "nonparam_ln":
        return layer_norm(x, None, None)
    return rms_norm(x, gamma)


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def to_planes(kv: Tensor) -> Tensor:
    """``[B, S, KH, dh]`` -> plane layout ``[B*KH, S, dh]``."""
    b, s, kh, dh = kv.shape
    return kv.permute(0, 2, 1, 3).reshape(b * kh, s, dh)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random parameters with the reference's scales (normal / sqrt(fan_in)
    projections, 0.02 embedding, unit norms).  The generator differs from
    ``jax.random``, so comparisons convert the reference's params
    (`models.convert.params_from_numpy`) instead of re-initialising."""
    d, dh, l = cfg.d_model, cfg.head_dim, cfg.n_layers
    h, kh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    dt = getattr(torch, cfg.param_dtype)

    def mat(n_in, n_out):
        w = torch.randn((l, n_in, n_out), generator=generator, device=device)
        return (w / math.sqrt(n_in)).to(dt)

    blocks: Dict[str, Tensor] = {
        "wq": mat(d, h * dh), "wk": mat(d, kh * dh), "wv": mat(d, kh * dh),
        "wo": mat(h * dh, d),
        "attn_norm": torch.ones((l, d), dtype=dt, device=device),
        "mlp_norm": torch.ones((l, d), dtype=dt, device=device),
    }
    if cfg.qk_norm:
        blocks["q_norm"] = torch.ones((l, dh), dtype=dt, device=device)
        blocks["k_norm"] = torch.ones((l, dh), dtype=dt, device=device)
    if cfg.mlp == "swiglu":
        blocks["w_gate"] = mat(d, f)
        blocks["w_up"] = mat(d, f)
        blocks["w_down"] = mat(f, d)
    else:
        blocks["w_in"] = mat(d, f)
        blocks["w_out"] = mat(f, d)
    embed = torch.randn((cfg.vocab_size, d), generator=generator,
                        device=device) * 0.02
    return {"embed": embed.to(dt), "blocks": blocks,
            "final_norm": torch.ones((d,), dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def _attn(cfg: ModelConfig, lp, h: Tensor, positions: Tensor,
          kv_override=None, plan_layers=None) -> tuple:
    """Attention sublayer; returns ``(out, (k, v))``.  ``kv_override`` is
    ``(k_cache, v_cache, cache_len)`` for decode (planes ``[B*KH, Smax,
    dh]``): the s >= 1 new rows land at ``cache_len .. cache_len + s - 1``."""
    b, s, _ = h.shape
    dh, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    cd = _cdtype(cfg)
    x = _norm(cfg, h, lp["attn_norm"]).to(cd)
    q = _proj(lp, plan_layers, "wq", x, cd).reshape(b, s, nh, dh)
    k = _proj(lp, plan_layers, "wk", x, cd).reshape(b, s, nkv, dh)
    v = _proj(lp, plan_layers, "wv", x, cd).reshape(b, s, nkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"])
        k = rms_norm(k, lp["k_norm"])
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    if kv_override is not None:
        if cfg.cache_update != "mask":
            raise ValueError(f"cache_update={cfg.cache_update!r}: only the "
                             "'mask' write is ported")
        k_cache, v_cache, clen = kv_override
        k_t = to_planes(k).to(k_cache.dtype)                # [B*KH, s, dh]
        v_t = to_planes(v).to(v_cache.dtype)
        smax = k_cache.shape[1]
        rows = clen.repeat_interleave(nkv)[:, None] \
            + torch.arange(s, device=h.device)[None, :]
        oh = rows[:, :, None] == torch.arange(smax, device=h.device)
        written = oh.any(dim=1)[..., None]                  # [B*KH, Smax, 1]
        ohf = oh.to(k_cache.dtype)
        k_cache = torch.where(written,
                              torch.einsum("pcs,pcd->psd", ohf, k_t), k_cache)
        v_cache = torch.where(written,
                              torch.einsum("pcs,pcd->psd", ohf, v_t), v_cache)
        o = decode_attention_planes(q, k_cache.to(cd), v_cache.to(cd), clen)
        kv_out = (k_cache, v_cache)
    else:
        o = causal_attention(q, k, v)
        kv_out = (k, v)
    o = o.reshape(b, s, nh * dh)
    return _proj(lp, plan_layers, "wo", o, cd), kv_out


def _mlp(cfg: ModelConfig, lp, h: Tensor, plan_layers=None) -> Tensor:
    cd = _cdtype(cfg)
    x = _norm(cfg, h, lp["mlp_norm"]).to(cd)
    if cfg.mlp == "swiglu":
        g = F.silu(_proj(lp, plan_layers, "w_gate", x, cd)) \
            * _proj(lp, plan_layers, "w_up", x, cd)
        return _proj(lp, plan_layers, "w_down", g, cd)
    g = F.gelu(_proj(lp, plan_layers, "w_in", x, cd), approximate="tanh")
    return _proj(lp, plan_layers, "w_out", g, cd)


def _block(cfg: ModelConfig, h: Tensor, lp, positions: Tensor,
           kv_override=None, plan_layers=None):
    """One transformer block; returns ``(h, (k, v))``."""
    attn_out, kv = _attn(cfg, lp, h, positions, kv_override=kv_override,
                         plan_layers=plan_layers)
    h = h + attn_out.to(h.dtype)
    h = h + _mlp(cfg, lp, h, plan_layers=plan_layers).to(h.dtype)
    return h, kv


def block_diffs(cfg: ModelConfig, params, ref_params,
                tokens: Tensor) -> list:
    """Teacher-forced per-layer comparison of two param sets (e.g. a sparse
    plan against its masked-dense reference): walk ``ref_params``' prefill
    and, at every layer, run that layer under both param sets *from the
    same input hidden state*.  Returns per layer ``(out, ref_out)`` block
    outputs, so rounding differences do not compound across layers."""
    cd = _cdtype(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    h = ref_params["embed"][tokens].to(cd)
    plan = serving_plan(cfg, params)
    ref_plan = serving_plan(cfg, ref_params)
    out = []
    for i in range(cfg.n_layers):
        lp = {nm: w[i] for nm, w in params["blocks"].items()}
        ref_lp = {nm: w[i] for nm, w in ref_params["blocks"].items()}
        got, _ = _block(cfg, h, lp, positions, plan_layers=None
                        if plan is None else plan.per_layer[i])
        h, _ = _block(cfg, h, ref_lp, positions, plan_layers=None
                      if ref_plan is None else ref_plan.per_layer[i])
        out.append((got, h))
    return out


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------

def build(cfg: ModelConfig, device: torch.device) -> ModelBundle:
    cd = _cdtype(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_params(cfg, gen, device)

    def _layers(params):
        """Per-layer ``(params slice, plan slice or None)``."""
        blocks = params["blocks"]
        plan = serving_plan(cfg, params)
        for i in range(cfg.n_layers):
            lp = {nm: w[i] for nm, w in blocks.items()}
            yield lp, (plan.per_layer[i] if plan is not None else None)

    def _logits(params, h):
        h = _norm(cfg, h, params["final_norm"])
        return h[:, -1].float() @ params["embed"].float().T

    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=device)[None].expand(b, s)
        h = params["embed"][tokens].to(cd)
        ks, vs = [], []
        for lp, plp in _layers(params):
            h, (k, v) = _block(cfg, h, lp, positions, plan_layers=plp)
            ks.append(to_planes(k).to(KV_DTYPE))
            vs.append(to_planes(v).to(KV_DTYPE))
        return _logits(params, h), {"k": torch.stack(ks),
                                    "v": torch.stack(vs)}

    def init_cache(batch_size: int, max_len: int):
        shape = (cfg.n_layers, batch_size * cfg.n_kv_heads, max_len,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=KV_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=KV_DTYPE, device=device)}

    def decode_step(params, batch, cache):
        """One step of ``s >= 1`` tokens per sequence: s == 1 is classic
        decode, s > 1 a chunk attending to the cached prefix."""
        tokens, clen = batch["tokens"], batch["cache_len"]
        b, s = tokens.shape
        positions = clen[:, None] + torch.arange(s, device=device)[None, :]
        h = params["embed"][tokens].to(cd)
        ks, vs = [], []
        for i, (lp, plp) in enumerate(_layers(params)):
            h, (kc, vc) = _block(cfg, h, lp, positions,
                                 kv_override=(cache["k"][i], cache["v"][i],
                                              clen),
                                 plan_layers=plp)
            ks.append(kc)
            vs.append(vc)
        return _logits(params, h), {"k": torch.stack(ks),
                                    "v": torch.stack(vs)}

    return ModelBundle(cfg=cfg, device=device, init=init, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache)
