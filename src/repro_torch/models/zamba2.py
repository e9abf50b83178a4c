"""Zamba2 (arXiv:2411.15242), the ``zamba2-1.2b`` arch (family hybrid) — a
Mamba2 backbone with one *shared* attention block applied before every
``cfg.attn_every`` Mamba layers; counterpart of `repro.models.zamba2`.

Mamba2 (SSD) per layer:
    z, x, B, C, dt projections of the rms-normed input
    causal depthwise convs over x, B and C, then silu
    a_t = exp(-softplus(dt + bias) * exp(A_log));  state [B, H, dh, N]
    h_t = a_t * h_{t-1} + dt * x_t (x) B_t ;  y_t = C_t . h_t + D * x_t
    out = out_proj(rmsnorm(y) * silu(z))

The SSD state recurs as a Python loop over tokens (`_ssd_scan`, the
configs' ``ssm_mode="scan"``) or over chunks of matmuls (`_ssd_chunked`;
decode always scans).  The layers run in the reference's fixed group
structure ``[shared-attn, mamba x attn_every] x n_attn``.  The cache is the
reference's dict: ``ssm`` ``[L, B, H, dh, N]`` and ``conv`` ``[L, B, K-1,
d_in + 2N]`` (f32), and the shared block's ``k`` / ``v`` ``[n_attn, B, S,
KH, dh]`` (bf16), written at ``cache_len`` by a mask select.

Sense integration: with ``cfg.sparse_serving`` and a plan attached
(``params["sparse_plan"]``, `engine.plan.plan_zamba2`), prefill and decode
run the Mamba blocks' z / x in-projections and out_proj through
`engine.execute.apply_fc`.  The SSD recurrence, the convs, the small
B / C / dt heads and the shared attention block (``params["shared"]``, one
unstacked weight set that no plan covers) stay dense.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed import sharding as shd
from ..distributed.sharding import P
from ..tree import tree_map
from .api import (BlockDiff, ModelBundle, init_shapes,
                  planned_proj as _proj, register_family, serving_plan)
from .layers import (apply_rope, causal_lm_labels, chunked_cross_entropy,
                     decode_attention, embed_init, prefill_attention,
                     rms_norm, swiglu)
from .rwkv6 import _chunk_len, _layer, _run_chunks

Tensor = torch.Tensor
KV_DTYPE = torch.bfloat16


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _dims(cfg: ModelConfig) -> tuple:
    """``(d_in, nheads, conv_dim, proj_out)`` of the Mamba blocks."""
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, nheads, conv_dim, 2 * d_in + 2 * cfg.ssm_state + nheads


def _n_attn(cfg: ModelConfig) -> int:
    """Applications of the shared block."""
    return -(-cfg.n_layers // cfg.attn_every)


def _groups(cfg: ModelConfig) -> list:
    """Each shared-block application's range of Mamba layers."""
    ae = cfg.attn_every
    return [(g * ae, min((g + 1) * ae, cfg.n_layers))
            for g in range(_n_attn(cfg))]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random parameters in the reference's layout and scales: stacked
    ``[L, ...]`` Mamba blocks (separate z / x / B / C / dt projections and
    one depthwise conv per stream) and the unstacked ``shared`` block."""
    d, l, n = cfg.d_model, cfg.n_layers, cfg.ssm_state
    d_in, nheads, conv_dim, _ = _dims(cfg)
    dt = getattr(torch, cfg.param_dtype)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    def fan(*shape):                       # normal / sqrt(fan-in)
        return (randn(*shape) / math.sqrt(shape[-2])).to(dt)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dt, device=device)

    blocks = {
        "norm": const(1.0, l, d),
        "z_proj": fan(l, d, d_in), "x_proj": fan(l, d, d_in),
        "B_proj": fan(l, d, n), "C_proj": fan(l, d, n),
        "dt_proj": fan(l, d, nheads),
        "conv_wx": (randn(l, cfg.ssm_conv, d_in) * 0.1).to(dt),
        "conv_wB": (randn(l, cfg.ssm_conv, n) * 0.1).to(dt),
        "conv_wC": (randn(l, cfg.ssm_conv, n) * 0.1).to(dt),
        "conv_b": const(0.0, l, conv_dim),
        "A_log": const(0.0, l, nheads), "D": const(1.0, l, nheads),
        "dt_bias": const(0.0, l, nheads),
        "gate_norm": const(1.0, l, d_in),
        "out_proj": fan(l, d_in, d),
    }
    dh, h, kh, f = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shared = {
        "attn_norm": const(1.0, d),
        "wq": fan(d, h * dh), "wk": fan(d, kh * dh), "wv": fan(d, kh * dh),
        "wo": fan(h * dh, d),
        "mlp_norm": const(1.0, d),
        "w_gate": fan(d, f), "w_up": fan(d, f), "w_down": fan(f, d),
    }
    return {"embed": embed_init(generator, cfg.vocab_size, d, dt, device),
            "blocks": blocks, "shared": shared,
            "final_norm": const(1.0, d)}


def param_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The reference's parameter specs: the Mamba projections' d_in /
    head dims over ``model``, d over the FSDP axes; the shared block's
    as the transformer's, unstacked."""
    if mesh is None:
        return tree_map(lambda _: P(), init_shapes(cfg))
    d = cfg.d_model
    d_in, nheads, _, _ = _dims(cfg)
    dh, h, kh, f = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    n = cfg.ssm_state
    fsdp, tp = [("data", "pod")], ["model"]

    def ls(shape, plan):
        return shd.logical_spec(mesh, (0, *shape), [None, *plan])

    def one(shape, plan):
        return shd.logical_spec(mesh, shape, plan)

    blocks = {
        "norm": P(None, None),
        "z_proj": ls((d, d_in), [fsdp, tp]),
        "x_proj": ls((d, d_in), [fsdp, tp]),
        "B_proj": ls((d, n), [fsdp, None]),
        "C_proj": ls((d, n), [fsdp, None]),
        "dt_proj": ls((d, nheads), [fsdp, tp]),
        "conv_wx": ls((cfg.ssm_conv, d_in), [None, tp]),
        "conv_wB": P(None, None, None),
        "conv_wC": P(None, None, None),
        "conv_b": P(None, None),
        "A_log": ls((nheads,), [tp]),
        "D": ls((nheads,), [tp]),
        "dt_bias": ls((nheads,), [tp]),
        "gate_norm": ls((d_in,), [tp]),
        "out_proj": ls((d_in, d), [tp, fsdp]),
    }
    shared = {
        "attn_norm": P(None),
        "wq": one((d, h * dh), [fsdp, tp]),
        "wk": one((d, kh * dh), [fsdp, tp]),
        "wv": one((d, kh * dh), [fsdp, tp]),
        "wo": one((h * dh, d), [tp, fsdp]),
        "mlp_norm": P(None),
        "w_gate": one((d, f), [fsdp, tp]),
        "w_up": one((d, f), [fsdp, tp]),
        "w_down": one((f, d), [tp, fsdp]),
    }
    return {"embed": one((cfg.vocab_size, d), [tp, fsdp]),
            "blocks": blocks, "shared": shared,
            "final_norm": P(None)}


# ---------------------------------------------------------------------------
# Mamba2 mixer
# ---------------------------------------------------------------------------

def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 conv_state: Tensor) -> tuple:
    """Depthwise causal conv over time: x ``[B, T, C]``, w ``[K, C]``,
    conv_state ``[B, K-1, C]`` (the previous segment's last K-1 inputs).
    The taps are summed in x's dtype in the order j = 0..K-1, as the
    reference's.  Returns ``(y [B, T, C], new conv_state)``."""
    t = x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)     # [B, T+K-1, C]
    y = torch.zeros_like(x)
    for j in range(w.shape[0]):
        y = y + xp[:, j:j + t, :] * w[j][None, None, :]
    return y + b[None, None, :], xp[:, t:, :]


def _ssd_scan(x, dt, a, B, C, state, *, chunk: int = 64):
    """The Mamba2 recurrence, one token a step (f32): x ``[B, T, H, dh]``,
    dt / a ``[B, T, H]``, B / C ``[B, T, N]``, state ``[B, H, dh, N]``.
    Returns ``(y [B, T, H, dh], new state)``.  ``dt * x`` needs no state and
    is taken for all t at once."""
    def chunk_step(s, dxc, ac, Bc, Cc):
        ys = []
        for i in range(dxc.shape[1]):
            upd = dxc[:, i, ..., None] * Bc[:, i, None, None, :]
            s = torch.addcmul(upd, ac[:, i, :, None, None], s)
            ys.append(torch.einsum("bhdn,bn->bhd", s, Cc[:, i]))
        return torch.stack(ys, dim=1), s

    return _run_chunks(chunk_step, state, (dt[..., None] * x, a, B, C),
                       _chunk_len(x.shape[1], chunk))


def _ssd_chunked(x, dt, a, B, C, state, *, chunk: int = 64):
    """The same recurrence as chunk-local matmuls (the Mamba2 paper's SSD
    decomposition, f32): with ``L_t = sum_{tau <= t} log a_tau`` inside a
    chunk (``a`` floored at 1e-37 before its log),

        y_t   = C_t . (P_t * S_0) + sum_{s<=t} (P_t / P_s) dt_s (C_t.B_s) x_s
        S_out = P_c * S_0         + sum_s (P_c / P_s) dt_s x_s (x) B_s
    """
    c = _chunk_len(x.shape[1], chunk)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=x.device))

    def chunk_step(s, xc, dtc, ac, Bc, Cc):
        logp = torch.cumsum(torch.log(torch.clamp_min(ac, 1e-37)), dim=1)
        y_inter = torch.einsum("bcn,bhdn->bchd", Cc, s) \
            * torch.exp(logp)[..., None]
        ratio = torch.exp(logp[:, :, None] - logp[:, None, :])  # [B,c,s,H]
        cb = torch.einsum("bcn,bsn->bcs", Cc, Bc)
        scores = torch.where(tril[None, :, :, None],
                             cb[..., None] * ratio * dtc[:, None], 0.0)
        y_intra = torch.einsum("bcsh,bshd->bchd", scores, xc)
        wgt = torch.exp(logp[:, -1:] - logp) * dtc               # [B,c,H]
        s = s * torch.exp(logp[:, -1])[..., None, None] \
            + torch.einsum("bchd,bcn->bhdn", xc * wgt[..., None], Bc)
        return y_inter + y_intra, s

    return _run_chunks(chunk_step, state, (x, dt, a, B, C), c)


def _mamba_block(cfg: ModelConfig, lp, h: Tensor, ssm_state: Tensor,
                 conv_state: Tensor, plan_layers=None) -> tuple:
    """One Mamba2 layer with its residual; returns ``(h, ssm_state,
    conv_state)``."""
    out, ssm_state, conv_state = _mamba_inc(cfg, lp, h, ssm_state,
                                            conv_state,
                                            plan_layers=plan_layers)
    return h + out, ssm_state, conv_state


def _mamba_inc(cfg: ModelConfig, lp, h: Tensor, ssm_state: Tensor,
               conv_state: Tensor, plan_layers=None) -> tuple:
    """One Mamba2 layer's increment to the residual ``h`` (in ``h``'s
    dtype); returns ``(increment, ssm_state, conv_state)``."""
    cd = _cdtype(cfg)
    b, t, _ = h.shape
    d_in, nheads, _, _ = _dims(cfg)
    hd, n = cfg.ssm_head_dim, cfg.ssm_state
    x = rms_norm(h, lp["norm"]).to(cd)
    z = _proj(lp, plan_layers, "z_proj", x, cd)
    xm = _proj(lp, plan_layers, "x_proj", x, cd)
    bm_r = x @ lp["B_proj"].to(cd)
    cm_r = x @ lp["C_proj"].to(cd)
    dt_raw = x @ lp["dt_proj"].to(cd)
    # one depthwise conv per stream (== one conv over concat(x, B, C));
    # the conv state keeps the concatenated layout [B, K-1, d_in + 2N]
    cb = lp["conv_b"].to(cd)
    xs_c, ns_x = _causal_conv(xm, lp["conv_wx"].to(cd), cb[:d_in],
                              conv_state[..., :d_in])
    bm_c, ns_b = _causal_conv(bm_r, lp["conv_wB"].to(cd), cb[d_in:d_in + n],
                              conv_state[..., d_in:d_in + n])
    cm_c, ns_c = _causal_conv(cm_r, lp["conv_wC"].to(cd), cb[d_in + n:],
                              conv_state[..., d_in + n:])
    conv_state = torch.cat([ns_x, ns_b, ns_c], dim=-1).to(conv_state.dtype)
    xs = F.silu(xs_c)
    bm = F.silu(bm_c).float()
    cm = F.silu(cm_c).float()
    # jax.nn.softplus is logaddexp(x, 0) everywhere (F.softplus switches to
    # the identity above its threshold)
    raw = dt_raw.float() + lp["dt_bias"].float()
    dt = torch.logaddexp(raw, torch.zeros_like(raw))
    a = torch.exp(-dt * torch.exp(lp["A_log"].float()))
    ssd = _ssd_chunked if (cfg.ssm_mode == "chunked" and t > 1) \
        else _ssd_scan
    xh = xs.reshape(b, t, nheads, hd).float()
    y, ssm_state = ssd(xh, dt, a, bm, cm, ssm_state)
    y = y + lp["D"].float()[None, None, :, None] * xh
    y = rms_norm(y.reshape(b, t, d_in), lp["gate_norm"]) * F.silu(z.float())
    out = _proj(lp, plan_layers, "out_proj", y.to(cd), cd)
    return out.to(h.dtype), ssm_state, conv_state


# ---------------------------------------------------------------------------
# Shared attention block
# ---------------------------------------------------------------------------

def _shared_attn(cfg: ModelConfig, sp, h: Tensor, positions: Tensor,
                 kv_override=None) -> tuple:
    """The shared attention + SwiGLU block with its residuals; returns
    ``(h, (k, v))``.  ``kv_override`` is ``(k_cache, v_cache, cache_len)``
    for a decode step (caches ``[B, Smax, KH, dh]``): the new row is
    written at ``cache_len`` by a mask select, as the reference's."""
    a, kv = _shared_attn_inc(cfg, sp, h, positions, kv_override=kv_override)
    h = h + a
    return h + _shared_mlp_inc(cfg, sp, h), kv


def _shared_attn_inc(cfg: ModelConfig, sp, h: Tensor, positions: Tensor,
                     kv_override=None) -> tuple:
    """The shared block's attention increment to the residual ``h`` (in
    ``h``'s dtype); returns ``(increment, (k, v))``."""
    cd = _cdtype(cfg)
    b, s, _ = h.shape
    dh, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    x = rms_norm(h, sp["attn_norm"]).to(cd)
    q = (x @ sp["wq"].to(cd)).reshape(b, s, nh, dh)
    k = (x @ sp["wk"].to(cd)).reshape(b, s, nkv, dh)
    v = (x @ sp["wv"].to(cd)).reshape(b, s, nkv, dh)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    if kv_override is not None:
        k_cache, v_cache, clen = kv_override
        smax = k_cache.shape[1]
        wmask = (torch.arange(smax, device=h.device)[None, :]
                 == clen[:, None])[..., None, None]
        k_cache = torch.where(wmask, k[:, :1].to(k_cache.dtype), k_cache)
        v_cache = torch.where(wmask, v[:, :1].to(v_cache.dtype), v_cache)
        o = decode_attention(q, k_cache.to(cd), v_cache.to(cd), clen + 1)
        kv = (k_cache, v_cache)
    else:
        o = prefill_attention(q, k, v, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        kv = (k.to(KV_DTYPE), v.to(KV_DTYPE))
    return (o.reshape(b, s, nh * dh) @ sp["wo"].to(cd)).to(h.dtype), kv


def _shared_mlp_inc(cfg: ModelConfig, sp, h: Tensor) -> Tensor:
    """The shared block's SwiGLU increment to the residual ``h``."""
    cd = _cdtype(cfg)
    x = rms_norm(h, sp["mlp_norm"]).to(cd)
    return swiglu(x, sp["w_gate"].to(cd), sp["w_up"].to(cd),
                  sp["w_down"].to(cd)).to(h.dtype)


def _zero_states(cfg: ModelConfig, b: int, device) -> tuple:
    _, nheads, conv_dim, _ = _dims(cfg)
    return (torch.zeros((cfg.n_layers, b, nheads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=torch.float32, device=device),
            torch.zeros((cfg.n_layers, b, cfg.ssm_conv - 1, conv_dim),
                        dtype=torch.float32, device=device))


def sublayer_diffs(cfg: ModelConfig, params, ref_params, tokens: Tensor):
    """Teacher-forced per-sublayer comparison of two param sets (a sparse
    plan against its masked-dense reference), in the model's order, as
    `transformer.sublayer_diffs`: each shared-block application's
    attention from the reference's input ``h`` and its SwiGLU from the
    reference's ``h + attn``, and each Mamba layer from the reference's
    input with zero SSM and conv states (a prefill starts from zero), run
    under both.  Yields one `models.api.BlockDiff` per block: ``shared g``
    (``shared_attn``, ``shared_mlp``) and ``mamba i`` (``mamba``)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    h = ref_params["embed"][tokens].to(_cdtype(cfg))
    zeros = [z[0] for z in _zero_states(cfg, b, tokens.device)]
    plan, ref_plan = serving_plan(cfg, params), serving_plan(cfg, ref_params)
    for g, (a, bnd) in enumerate(_groups(cfg)):
        sp, ref_sp = params["shared"], ref_params["shared"]
        a_ref = _shared_attn_inc(cfg, ref_sp, h, positions)[0]
        a_got = _shared_attn_inc(cfg, sp, h, positions)[0]
        mid = h + a_ref
        m_ref = _shared_mlp_inc(cfg, ref_sp, mid)
        m_got = _shared_mlp_inc(cfg, sp, mid)
        want = mid + m_ref
        yield BlockDiff(block=f"shared {g}", out=h + a_got + m_got,
                        ref_out=want, agree=None,
                        increments=(("shared_attn", a_got, a_ref),
                                    ("shared_mlp", m_got, m_ref)))
        h = want
        for i in range(a, bnd):
            ref_inc = _mamba_inc(cfg, _layer(ref_params, i), h, *zeros,
                                 plan_layers=None if ref_plan is None
                                 else ref_plan.per_layer[i])[0]
            inc = _mamba_inc(cfg, _layer(params, i), h, *zeros,
                             plan_layers=None if plan is None
                             else plan.per_layer[i])[0]
            want = h + ref_inc
            yield BlockDiff(block=f"mamba {i}", out=h + inc, ref_out=want,
                            agree=None,
                            increments=(("mamba", inc, ref_inc),))
            h = want


def cache_specs(cfg: ModelConfig, mesh, batch_size: int) -> Dict[str, P]:
    """The reference's cache specs: the batch over the data axes that
    divide it (`distributed.sharding.shard_batch`), the SSM state's heads
    over ``model`` when it divides them, and the shared block's KV
    ``[n_attn, B, S, KH, dh]`` with the sequence over ``model``.  Without
    a mesh, ``P()``."""
    if mesh is None:
        return {"ssm": P(), "conv": P(), "k": P(), "v": P()}
    dp = shd.shard_batch(mesh, batch_size)
    hsp = shd.dim_spec(mesh, _dims(cfg)[1], "model")
    return {"ssm": P(None, dp, hsp, None, None),
            "conv": P(None, dp, None, None),
            "k": P(None, dp, "model", None, None),
            "v": P(None, dp, "model", None, None)}


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------

@register_family("hybrid")
def build(cfg: ModelConfig, device: torch.device, mesh=None) -> ModelBundle:
    cd = _cdtype(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_params(cfg, gen, device)

    def _forward(params, tokens: Tensor, states: tuple, attn, plan=None,
                 remat: bool = False):
        """The group structure ``[shared-attn, mamba x attn_every] x
        n_attn``; ``attn(h, g) -> h`` runs the shared block of group g.
        Returns the final-normed hidden states and the new SSM and conv
        states, stacked."""
        h = params["embed"][tokens].to(cd)
        ssm, conv = [], []
        for g, (a, bnd) in enumerate(_groups(cfg)):
            h = attn(h, g)
            for i in range(a, bnd):
                args = (_layer(params, i), h, states[0][i], states[1][i])
                plp = None if plan is None else plan.per_layer[i]
                if remat:
                    h, s_s, c_s = checkpoint(_mamba_block, cfg, *args,
                                             plan_layers=plp,
                                             use_reentrant=False)
                else:
                    h, s_s, c_s = _mamba_block(cfg, *args, plan_layers=plp)
                ssm.append(s_s)
                conv.append(c_s)
        h = rms_norm(h, params["final_norm"])
        return h, torch.stack(ssm), torch.stack(conv)

    def _logits(params, h):
        return h[:, -1].float() @ params["embed"].float().T

    def _positions(tokens):
        b, s = tokens.shape
        return torch.arange(s, device=tokens.device)[None].expand(b, s)

    def train_loss(params, batch):
        tokens = batch["tokens"].long()
        b, s = tokens.shape
        positions = _positions(tokens)
        h, _, _ = _forward(
            params, tokens, _zero_states(cfg, b, tokens.device),
            lambda h, g: _shared_attn(cfg, params["shared"], h,
                                      positions)[0],
            remat=cfg.remat)
        labels, mask = causal_lm_labels(tokens)
        return chunked_cross_entropy(h, params["embed"], labels,
                                     chunk=min(cfg.loss_chunk, s), mask=mask)

    def prefill(params, batch):
        tokens = batch["tokens"]
        positions = _positions(tokens)
        kv = []

        def attn(h, g):
            h, kv_g = _shared_attn(cfg, params["shared"], h, positions)
            kv.append(kv_g)
            return h

        h, ssm, conv = _forward(params, tokens,
                                _zero_states(cfg, tokens.shape[0], device),
                                attn, plan=serving_plan(cfg, params))
        return _logits(params, h), {
            "ssm": ssm, "conv": conv,
            "k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}

    def init_cache(batch_size: int, max_len: int):
        ssm, conv = _zero_states(cfg, batch_size, device)
        kv_shape = (_n_attn(cfg), batch_size, max_len, cfg.n_kv_heads,
                    cfg.head_dim)
        return {"ssm": ssm, "conv": conv,
                "k": torch.zeros(kv_shape, dtype=KV_DTYPE, device=device),
                "v": torch.zeros(kv_shape, dtype=KV_DTYPE, device=device)}

    def decode_step(params, batch, cache):
        tokens, clen = batch["tokens"], batch["cache_len"]
        kv = []

        def attn(h, g):
            h, kv_g = _shared_attn(
                cfg, params["shared"], h, clen[:, None],
                kv_override=(cache["k"][g], cache["v"][g], clen))
            kv.append(kv_g)
            return h

        h, ssm, conv = _forward(params, tokens, (cache["ssm"], cache["conv"]),
                                attn, plan=serving_plan(cfg, params))
        return _logits(params, h), {
            "ssm": ssm, "conv": conv,
            "k": torch.stack([k for k, _ in kv]),
            "v": torch.stack([v for _, v in kv])}

    return ModelBundle(cfg=cfg, device=device, init=init,
                       train_loss=train_loss, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache,
                       param_specs=lambda: param_specs(cfg, mesh),
                       cache_specs=lambda b: cache_specs(cfg, mesh, b))
