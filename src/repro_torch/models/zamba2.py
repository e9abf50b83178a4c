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
unstacked weight set that no plan covers) stay dense.  When serving,
those dense products sum in float64 and round once (`layers.matmul_f64`;
the shared block's weights cast once a forward, `_exact_shared`), so a
row's result does not depend on how many rows share the call (a live
mesh's rank has half the rows or columns of one process).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed import sharding as shd
from ..distributed.sharding import P
from ..launch.mesh import LiveMesh
from ..tree import tree_map
from .api import (BlockDiff, ModelBundle, init_shapes,
                  planned_proj as _proj, register_family, serving_plan)
from .layers import (apply_rope, causal_lm_labels, chunked_cross_entropy,
                     decode_attention, embed_init, matmul_f64,
                     prefill_attention, rms_norm)
from .rwkv6 import Split, _chunk_len, _layer, _run_chunks, live_split

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
    Returns ``(y [B, T, H, dh], new state)``, its sums over N taken in
    float64 and rounded to float32, so that a head's output does not
    depend on how many rows and heads share the call (as
    `rwkv6._wkv_scan`'s).  ``dt * x`` needs no state and is taken for all
    t at once; ``C_t . h_t`` is taken for a chunk at once after its steps,
    from the states it kept."""
    def chunk_step(s, dxc, ac, Bc, Cc):
        states = []
        for i in range(dxc.shape[1]):
            upd = dxc[:, i, ..., None] * Bc[:, i, None, None, :]
            s = torch.addcmul(upd, ac[:, i, :, None, None], s)
            states.append(s)
        ys = torch.einsum("bthdn,btn->bthd",
                          torch.stack(states, dim=1).double(), Cc.double())
        return ys.float(), s

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
                 conv_state: Tensor, plan_layers=None, split=None) -> tuple:
    """One Mamba2 layer with its residual; returns ``(h, ssm_state,
    conv_state)``."""
    out, ssm_state, conv_state = _mamba_inc(cfg, lp, h, ssm_state,
                                            conv_state,
                                            plan_layers=plan_layers,
                                            split=split)
    return h + out, ssm_state, conv_state


def _gate_norm(split: Split, y: Tensor, gamma: Tensor, d_in: int) -> Tensor:
    """`layers.rms_norm` of ``y`` ``[B, T, d_in]`` over the whole
    ``d_in``.  On a rank of a live mesh that holds its heads' block of
    the columns, the row's sum of squares is the float64 partial sums of
    the blocks added in the ranks' order
    (`distributed.sharding.sum_in_order`), so the statistic is one
    process's to float32."""
    if not split.heads:
        return rms_norm(y, gamma)
    xf = y.float()
    ss = shd.sum_in_order(xf.square().double().sum(-1, keepdim=True),
                          split.mesh, split.heads)
    return (xf * torch.rsqrt((ss / d_in).float() + 1e-6)
            * gamma).to(y.dtype)


def _mamba_inc(cfg: ModelConfig, lp, h: Tensor, ssm_state: Tensor,
               conv_state: Tensor, plan_layers=None,
               split: Split | None = None) -> tuple:
    """One Mamba2 layer's increment to the residual ``h`` (in ``h``'s
    dtype); returns ``(increment, ssm_state, conv_state)``.  On a rank of
    a live mesh (``split``) z / x / dt are cut to the rank's heads, the
    x stream's conv, the SSD recurrence (``ssm_state`` the rank's heads)
    and the gate norm run on them and ``out_proj`` takes them split; B /
    C and the conv state stay whole."""
    split = split or Split(_cdtype(cfg))
    cd = split.cd
    b, t, _ = h.shape
    d_in, nheads, _, _ = _dims(cfg)
    hd, n = cfg.ssm_head_dim, cfg.ssm_state
    x = rms_norm(h, lp["norm"]).to(cd)
    z = split.to_heads(split.proj(lp, plan_layers, "z_proj", x))
    xm, have_x = split.proj(lp, plan_layers, "x_proj", x)
    xm_h = split.cols(xm, have_x, split.heads)
    # the weights no plan covers sum in float64 (`layers.matmul_f64`)
    bm_r = matmul_f64(x, lp["B_proj"].to(cd), cd)
    cm_r = matmul_f64(x, lp["C_proj"].to(cd), cd)
    dt_raw = split.to_heads(split.proj(lp, plan_layers, "dt_proj", x,
                                       exact=True))
    # one depthwise conv per stream (== one conv over concat(x, B, C));
    # the conv state keeps the concatenated layout [B, K-1, d_in + 2N]
    cb = lp["conv_b"].to(cd)
    wx = lp["conv_wx"].to(cd)
    if split.mesh is not None:
        wx = split.cols(wx, shd.spec_axes(split.uspecs["conv_wx"][1]),
                        split.heads)
    xs_c, ns_x = _causal_conv(xm_h, wx, cb[:d_in][split.chans],
                              conv_state[..., :d_in][..., split.chans])
    if split.heads:         # the conv state's x stream whole again
        ns_x = torch.cat([conv_state[..., :d_in].to(cd), xm], dim=1)[:, t:] \
            if not have_x else split.cols(ns_x, split.heads, ())
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
    xh = xs.reshape(b, t, -1, hd).float()
    y, ssm_state = ssd(xh, dt, a, bm, cm, ssm_state)
    y = y + lp["D"].float()[None, None, :, None] * xh
    gamma = lp["gate_norm"]
    if split.mesh is not None:
        gamma = split.cols(gamma, shd.spec_axes(split.uspecs["gate_norm"][0]),
                           split.heads)
    y = _gate_norm(split, y.flatten(-2), gamma, d_in) * F.silu(z.float())
    out = split.proj(lp, plan_layers, "out_proj", y.to(cd), split.heads)[0]
    return out.to(h.dtype), ssm_state, conv_state


# ---------------------------------------------------------------------------
# Shared attention block
# ---------------------------------------------------------------------------

# the shared block's weight matrices (no plan covers them)
_SHARED_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _exact_shared(sp: dict, cd: torch.dtype) -> dict:
    """The shared block's weights ``sp`` as a serving forward uses them:
    each matrix rounded to the compute dtype ``cd`` and held in float64,
    cast once a forward (not at each of its ``n_attn`` applications), so
    that its products sum in float64 (`_dense`); the norms as they are."""
    return {k: v.to(cd).double() if k in _SHARED_MATS else v
            for k, v in sp.items()}


def _dense(x: Tensor, w: Tensor, cd: torch.dtype) -> Tensor:
    """``x @ w`` in ``cd``: a float64 ``w`` (`_exact_shared`) sums in
    float64 and rounds once (`layers.matmul_f64`); any other ``w`` is
    rounded to ``cd`` first, as the train step runs it."""
    if w.dtype == torch.float64:
        return matmul_f64(x, w, cd)
    return x @ w.to(cd)


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
    q = _dense(x, sp["wq"], cd).reshape(b, s, nh, dh)
    k = _dense(x, sp["wk"], cd).reshape(b, s, nkv, dh)
    v = _dense(x, sp["wv"], cd).reshape(b, s, nkv, dh)
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
    return _dense(o.reshape(b, s, nh * dh), sp["wo"], cd).to(h.dtype), kv


def _shared_mlp_inc(cfg: ModelConfig, sp, h: Tensor) -> Tensor:
    """The shared block's SwiGLU increment to the residual ``h``."""
    cd = _cdtype(cfg)
    x = rms_norm(h, sp["mlp_norm"]).to(cd)
    g = F.silu(_dense(x, sp["w_gate"], cd)) * _dense(x, sp["w_up"], cd)
    return _dense(g, sp["w_down"], cd).to(h.dtype)


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
    sp = _exact_shared(params["shared"], _cdtype(cfg))
    ref_sp = _exact_shared(ref_params["shared"], _cdtype(cfg))
    for g, (a, bnd) in enumerate(_groups(cfg)):
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
    if isinstance(mesh, LiveMesh):
        return _build_live(cfg, device, mesh)
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
        sp = _exact_shared(params["shared"], cd)
        kv = []

        def attn(h, g):
            h, kv_g = _shared_attn(cfg, sp, h, positions)
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
        sp = _exact_shared(params["shared"], cd)
        kv = []

        def attn(h, g):
            h, kv_g = _shared_attn(
                cfg, sp, h, clen[:, None],
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


# ---------------------------------------------------------------------------
# Live mesh: the sharded serve program
# ---------------------------------------------------------------------------

def _build_live(cfg: ModelConfig, device: torch.device,
                mesh: LiveMesh) -> ModelBundle:
    """The bundle on a live mesh: the reference's sharded serve program
    with its channel sharding (`distributed.sharding.with_channel_sharding`
    says where the split happens), each collective explicit.

    Params are this rank's blocks by `param_specs`, the plan is placed by
    `engine.plan.shard_plan` and the cache is this rank's block by
    `cache_specs`: its batch rows of the SSM state (its heads) and of the
    conv state, and of the shared block's KV ``[n_attn, B, S, KH, dh]``
    its block of S over ``model``.  ``prefill`` and ``decode_step`` take
    and return the whole batch as the one-device bundle does; inside, a
    rank computes the rows of its block of the batch:

    * each Mamba layer's dense weights are gathered over the FSDP axes to
      their use-time specs; z / x / dt come out column-parallel over
      ``model`` (a planned z / x whole) and are cut to the rank's heads
      (`rwkv6.Split`), on which the x stream's conv, the SSD recurrence
      and the gate norm (its row statistic summed over the heads' blocks:
      `_gate_norm`) run; ``out_proj`` is row-parallel; B / C stay whole;
    * the shared block's weights are gathered once a forward: q / k / v
      column-parallel over ``model`` (the rank's heads where ``model``
      divides the query and KV heads, else whole), ``wo`` row-parallel;
      its SwiGLU as the transformer's.  A prefill returns the rank's rows
      of the prompt's KV, all heads, whole in S, and `merge_cache` writes
      its S block into the rank's cache; a decode step gathers the new
      row's KV heads and the cache's S blocks over ``model`` (two
      ``all_gather``s), writes the row by the mask select at
      ``cache_len``, attends with the rank's heads and keeps its S block;
    * the embedding and the logits as the transformer's.

    ``train_loss`` is this rank's share of the reference's loss, the same
    program without a plan and without the KV's sequence split (that
    split is the serving cache's), differentiable through every
    collective and through the float64 products, scan sums and the gate
    norm's sum across ranks.

    ``model`` must divide the cache's ``max_len`` (the reference's spec
    splits S over it without a fallback): `init_cache` raises where it
    does not."""
    cd = _cdtype(cfg)
    d, dh = cfg.d_model, cfg.head_dim
    nh, kh = cfg.n_heads, cfg.n_kv_heads
    _, nheads, _, _ = _dims(cfg)
    pspecs = param_specs(cfg, mesh)
    placed = {k: P(*list(sp)[1:]) for k, sp in pspecs["blocks"].items()}
    split = live_split(cfg, mesh, pspecs["blocks"], nheads, cfg.ssm_head_dim)
    sh_use = {k: shd.use_spec(sp, stacked=False)
              for k, sp in pspecs["shared"].items()}
    att = split.heads if (split.heads and nh % mesh.shape["model"] == 0
                          and kh % mesh.shape["model"] == 0) else ()
    seq_ax = ("model",) if "model" in mesh.shape else ()
    sh_split = dataclasses.replace(split, uspecs=sh_use)

    def shared_block(sp, h, positions, kv=None, keep_kv=True):
        """The shared attention and SwiGLU block with its residuals on
        the rank's rows ``h``; returns ``(h, (k, v))``: the prompt's KV
        (``kv`` None) or the rank's new cache block (``kv`` ``(k block,
        v block, cache_len of the rows)``).  Without ``keep_kv`` (a train
        step: the block attends over the whole sequence, and no cache
        is kept) the KV is not gathered and ``(h, None)`` returns."""
        bl, s, _ = h.shape
        x = rms_norm(h, sp["attn_norm"]).to(cd)

        def proj(name, x, have=()):
            return sh_split.proj(sp, None, name, x, have, exact=True)

        def heads(name):
            return sh_split.cols(*proj(name, x), att).reshape(bl, s, -1, dh)

        q, k, v = heads("wq"), heads("wk"), heads("wv")
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
        split4 = P(None, None, att or None, None)
        whole = shd.gather_tree({"k": k, "v": v}, mesh,
                                {"k": split4, "v": split4}, att) \
            if att and keep_kv else {"k": k, "v": v}
        if kv is None:
            o = prefill_attention(q, k, v, q_chunk=cfg.q_chunk,
                                  kv_chunk=cfg.kv_chunk)
            kv_out = (whole["k"].to(KV_DTYPE), whole["v"].to(KV_DTYPE)) \
                if keep_kv else None
        else:
            k_blk, v_blk, clen = kv
            seq4 = P(None, seq_ax or None, None, None)
            full = shd.gather_tree({"k": k_blk, "v": v_blk}, mesh,
                                   {"k": seq4, "v": seq4}, seq_ax) \
                if seq_ax else {"k": k_blk, "v": v_blk}
            smax = full["k"].shape[1]
            wmask = (torch.arange(smax, device=h.device)[None, :]
                     == clen[:, None])[..., None, None]
            kc = torch.where(wmask, whole["k"][:, :1].to(KV_DTYPE),
                             full["k"])
            vc = torch.where(wmask, whole["v"][:, :1].to(KV_DTYPE),
                             full["v"])
            k0, khl = shd.block_of(mesh, att, kh)
            o = decode_attention(q, kc[:, :, k0:k0 + khl].to(cd),
                                 vc[:, :, k0:k0 + khl].to(cd), clen + 1)
            s0, sl = shd.block_of(mesh, seq_ax, smax)
            kv_out = (kc[:, s0:s0 + sl].clone(), vc[:, s0:s0 + sl].clone())
        o = o.reshape(bl, s, -1)
        h = h + proj("wo", o, att)[0].to(h.dtype)
        x = rms_norm(h, sp["mlp_norm"]).to(cd)
        a, have = proj("w_gate", x)
        u, have_u = proj("w_up", x)
        if have != have_u:
            a, u, have = sh_split.cols(a, have, ()), \
                sh_split.cols(u, have_u, ()), ()
        mlp = proj("w_down", F.silu(a) * u, have)[0]
        return h + mlp.to(h.dtype), kv_out

    def forward(params, tokens: Tensor, states: tuple, pos_fn, kv=None):
        """``(logits [B, V], the rank's new cache)`` of the whole batch
        ``tokens``; ``kv`` ``(k, v, cache_len)`` for a decode step."""
        b = tokens.shape[0]
        bax = shd.shard_batch(mesh, b) or ()
        r0, bl = shd.block_of(mesh, bax, b)
        rows = slice(r0, r0 + bl)
        positions = pos_fn(rows)
        h = shd.embed_rows(mesh, params["embed"], pspecs["embed"], tokens,
                           d, rows).to(cd)
        sp = _exact_shared(shd.gather_for_use(
            mesh, params["shared"], pspecs["shared"], sh_use, cd), cd)
        plan = serving_plan(cfg, params)
        ssm, conv, ks, vs = [], [], [], []
        for g, (a, bnd) in enumerate(_groups(cfg)):
            h, (kg, vg) = shared_block(
                sp, h, positions,
                None if kv is None else (kv[0][g], kv[1][g], kv[2][rows]))
            ks.append(kg)
            vs.append(vg)
            for i in range(a, bnd):
                plp = None if plan is None else plan.per_layer[i]
                lp = shd.gather_for_use(
                    mesh, {nm: w[i] for nm, w in params["blocks"].items()
                           if plp is None or nm not in plp},
                    placed, split.uspecs, cd)
                h, s_s, c_s = _mamba_block(cfg, lp, h, states[0][i],
                                           states[1][i], plan_layers=plp,
                                           split=split)
                ssm.append(s_s)
                conv.append(c_s)
        h = rms_norm(h, params["final_norm"])
        logits = shd.vocab_logits(mesh, h[:, -1], params["embed"],
                                  pspecs["embed"], bax, cfg.vocab_size)
        return logits, {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
                        "k": torch.stack(ks), "v": torch.stack(vs)}

    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return shd.place_tree(init_params(cfg, gen, device),
                              shd.tree_shardings(mesh, pspecs))

    def train_mamba(h, lp, ssm, conv):
        """One Mamba layer of the train step on this rank's rows from
        zero states: its placed weights gathered to their use-time
        specs, then the serve program's `_mamba_block`."""
        lp = shd.gather_for_use(mesh, lp, placed, split.uspecs, cd)
        return _mamba_block(cfg, lp, h, ssm, conv, split=split)[0]

    def train_loss(params, batch):
        """This rank's share of the reference's mean next-token loss of
        the whole ``batch`` (the convention of `distributed.sharding`, as
        `transformer._build_live`'s ``train_loss``): the rank's rows
        through the group structure from zero states, the shared block's
        weights gathered once and used at every application (their
        gradients summed over the applications, then reduce-scattered
        once), its attention over the whole sequence on the rank's
        heads; each Mamba layer channel-split by heads as `forward` runs
        it, remat'd when ``cfg.remat``; then the CE against the tied
        embedding gathered whole, divided by the whole batch's token
        count times the ranks that repeat these rows."""
        tokens = batch["tokens"].long()
        b, s = tokens.shape
        bax = shd.shard_batch(mesh, b) or ()
        r0, bl = shd.block_of(mesh, bax, b)
        rows = slice(r0, r0 + bl)
        positions = torch.arange(s, device=device).expand(bl, s)
        h = shd.embed_rows(mesh, params["embed"], pspecs["embed"], tokens,
                           d, rows).to(cd)
        sp = shd.gather_for_use(mesh, params["shared"], pspecs["shared"],
                                sh_use, cd)
        ssm, conv = zero_states(b)
        for g, (a, bnd) in enumerate(_groups(cfg)):
            h = shared_block(sp, h, positions, keep_kv=False)[0]
            for i in range(a, bnd):
                args = (h, _layer(params, i), ssm[i], conv[i])
                h = checkpoint(train_mamba, *args, use_reentrant=False) \
                    if cfg.remat else train_mamba(*args)
        h = rms_norm(h, params["final_norm"])
        labels, mask = causal_lm_labels(tokens)
        repeats = mesh.size // math.prod(mesh.shape[x] for x in bax)
        emb = shd.gather(params["embed"], mesh, pspecs["embed"])
        return chunked_cross_entropy(
            h, emb, labels[rows], chunk=min(cfg.loss_chunk, s),
            mask=mask[rows], denom=mask.sum().clamp(min=1.0) * repeats)

    def zero_states(batch_size: int) -> tuple:
        """The rank's zero SSM and conv states by `cache_specs`."""
        specs = cache_specs(cfg, mesh, batch_size)
        return tuple(torch.zeros(shd.shard_shape(mesh, tuple(t.shape),
                                                 specs[k]),
                                 dtype=t.dtype, device=device)
                     for k, t in zip(("ssm", "conv"), _zero_states(
                         cfg, batch_size, "meta")))

    def init_cache(batch_size: int, max_len: int):
        m = mesh.shape.get("model", 1)
        if max_len % m:
            raise ValueError(
                f"{cfg.name} on a live mesh splits its shared block's KV "
                f"cache by sequence over model ({m}), as the reference's "
                f"cache_specs do (no fallback): max_len {max_len} must be a "
                f"multiple of {m}")
        specs = cache_specs(cfg, mesh, batch_size)
        kv = torch.empty((_n_attn(cfg), batch_size, max_len, kh, dh),
                         dtype=KV_DTYPE, device="meta")
        return dict(zip(("ssm", "conv"), zero_states(batch_size)),
                    **{k: torch.zeros(shd.shard_shape(
                        mesh, tuple(kv.shape), specs[k]), dtype=KV_DTYPE,
                        device=device) for k in ("k", "v")})

    def merge_cache(cache: dict, prefill_cache: dict) -> dict:
        """The rank's decode cache seeded with its prefill's: the states
        taken whole, the prompt's KV rows (whole in S) written into the
        rank's S block where they fall in it."""
        out = {k: prefill_cache[k].to(cache[k].dtype)
               for k in ("ssm", "conv")}
        s0, sl = shd.block_of(mesh, seq_ax, cache["k"].shape[2]
                              * mesh.shape.get("model", 1))
        for k in ("k", "v"):
            merged = cache[k].clone()
            pf = prefill_cache[k]
            hi = min(s0 + sl, pf.shape[2])
            if hi > s0:
                merged[:, :, :hi - s0] = pf[:, :, s0:hi]
            out[k] = merged
        return out

    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        zeros = init_cache(b, mesh.shape.get("model", 1))
        return forward(params, tokens, (zeros["ssm"], zeros["conv"]),
                       lambda rows: torch.arange(s, device=device)
                       .expand(rows.stop - rows.start, s))

    def decode_step(params, batch, cache):
        tokens, clen = batch["tokens"], batch["cache_len"]
        return forward(params, tokens, (cache["ssm"], cache["conv"]),
                       lambda rows: clen[rows][:, None],
                       kv=(cache["k"], cache["v"], clen))

    return ModelBundle(cfg=cfg, device=device, init=init,
                       train_loss=train_loss, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache,
                       param_specs=lambda: pspecs,
                       cache_specs=lambda b: cache_specs(cfg, mesh, b),
                       merge_cache=merge_cache)
