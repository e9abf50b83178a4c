"""Decoder-only transformer, dense (olmo-1b and the other dense configs),
MoE (deepseek-moe-16b: capacity-dispatched routed experts plus shared
experts), audio (musicgen-medium) and vlm (internvl2-2b) — counterpart of
`repro.models.transformer`.  The audio and vision frontends are stubs, as
in the reference: ``batch["frontend_embed"]`` carries precomputed frame /
patch embeddings ``[B, n, frontend_dim]``, projected by ``frontend_proj``
onto the first n token positions of a prefill or a training batch (the
loss skips the positions they predict).

Layer parameters are stacked on a leading L axis, in the reference's
layout (``[L, n_in, n_out]``), and walked with a Python loop.  The KV cache
uses the plane layout ``[L, B*KH, Smax, dh]`` (plane ``b * KH + h``).
Decode writes new rows as ``cfg.cache_update`` says, as the reference does:
``"mask"`` rewrites the whole cache with a one-hot select (exact, and
never out of range), ``"scatter"`` writes only the new rows, in place,
through the `kernels.kv_cache_update` kernel.  The two are bitwise equal.

Training: ``train_loss`` is the mean next-token cross-entropy (chunked
over the sequence, z-loss included) plus ``router_aux_weight`` times the
MoE blocks' summed load-balancing loss, through dense projections (no
serving plan), each block recomputed in the backward when ``cfg.remat``
(`torch.utils.checkpoint`, the reference's ``jax.checkpoint``).  On a
live mesh it is a rank's share of that loss (`_build_live`).

Sense integration: with ``cfg.sparse_serving`` and a plan attached
(``params["sparse_plan"]``), prefill *and* decode run every planned
projection through `engine.execute.apply_fc` — the CUDA kernels on a GPU —
and every planned expert tensor through `engine.execute.apply_expert_fc`
(all experts in one batched kernel launch).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import TRANSFORMER_FAMILIES, ModelConfig
from ..distributed import sharding as shd
from ..distributed.sharding import P
from ..kernels.kv_cache_update import kv_cache_write_chunk, to_planes
from ..launch.mesh import LiveMesh
from ..tree import tree_map
from .api import (BlockDiff, ModelBundle, planned_proj as _proj,
                  register_family, serving_plan)
from .layers import (apply_rope, attention_chunks, causal_lm_labels,
                     chunked_cross_entropy, decode_attention_planes,
                     dense_init, embed_init, layer_norm, prefill_attention,
                     rms_norm)

Tensor = torch.Tensor
KV_DTYPE = torch.bfloat16       # the cache is bf16 by construction
LIVE_FAMILIES = ("dense", "moe", "audio", "vlm")   # `_build_live` serves


def _norm(cfg: ModelConfig, x: Tensor, gamma: Tensor | None) -> Tensor:
    if cfg.norm == "nonparam_ln":
        return layer_norm(x, None, None)
    return rms_norm(x, gamma)


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


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

    def mat(*shape):
        w = torch.randn((l, *shape), generator=generator, device=device)
        return (w / math.sqrt(shape[-2])).to(dt)

    blocks: Dict[str, Tensor] = {
        "wq": mat(d, h * dh), "wk": mat(d, kh * dh), "wv": mat(d, kh * dh),
        "wo": mat(h * dh, d),
        "attn_norm": torch.ones((l, d), dtype=dt, device=device),
        "mlp_norm": torch.ones((l, d), dtype=dt, device=device),
    }
    if cfg.qk_norm:
        blocks["q_norm"] = torch.ones((l, dh), dtype=dt, device=device)
        blocks["k_norm"] = torch.ones((l, dh), dtype=dt, device=device)
    if cfg.family == "moe":
        e, fs = cfg.n_experts, cfg.d_ff * max(cfg.n_shared_experts, 0)
        blocks["router"] = mat(d, e)
        blocks["we_gate"] = mat(e, d, f)
        blocks["we_up"] = mat(e, d, f)
        blocks["we_down"] = mat(e, f, d)
        if fs:
            blocks["ws_gate"] = mat(d, fs)
            blocks["ws_up"] = mat(d, fs)
            blocks["ws_down"] = mat(fs, d)
    elif cfg.mlp == "swiglu":
        blocks["w_gate"] = mat(d, f)
        blocks["w_up"] = mat(d, f)
        blocks["w_down"] = mat(f, d)
    else:
        blocks["w_in"] = mat(d, f)
        blocks["w_out"] = mat(f, d)
    params = {"embed": embed_init(generator, cfg.vocab_size, d, dt, device),
              "blocks": blocks,
              "final_norm": torch.ones((d,), dtype=dt, device=device)}
    if cfg.frontend:
        params["frontend_proj"] = dense_init(generator, cfg.frontend_dim, d,
                                             dt, device)
    return params


def init_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The params as ``meta`` tensors: `init_params`' shapes and dtypes,
    no storage and no draws."""
    return init_params(cfg, torch.Generator(), torch.device("meta"))


# ---------------------------------------------------------------------------
# Sharding rules (the reference's, over a `launch.mesh.Mesh`)
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The reference's parameter specs: projections' model dims over
    ``model`` (heads, d_ff, experts, vocab), their other dim over the FSDP
    axes; the stacked L axis and the norms replicated.  Without a mesh,
    ``P()`` for every leaf."""
    if mesh is None:
        return tree_map(lambda _: P(), init_shapes(cfg))
    d, dh = cfg.d_model, cfg.head_dim
    h, kh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    fsdp, tp = [("data", "pod")], ["model"]

    def ls(shape, plan):            # layer-stacked: leading L replicated
        return shd.logical_spec(mesh, (0, *shape), [None, *plan])

    blocks: Dict[str, Any] = {
        "wq": ls((d, h * dh), [fsdp, tp]),
        "wk": ls((d, kh * dh), [fsdp, tp]),
        "wv": ls((d, kh * dh), [fsdp, tp]),
        "wo": ls((h * dh, d), [tp, fsdp]),
        "attn_norm": P(None, None),
        "mlp_norm": P(None, None),
    }
    if cfg.qk_norm:
        blocks["q_norm"] = P(None, None)
        blocks["k_norm"] = P(None, None)
    if cfg.family == "moe":
        e = cfg.n_experts
        fs = cfg.d_ff * max(cfg.n_shared_experts, 0)
        blocks["router"] = ls((d, e), [fsdp, None])
        blocks["we_gate"] = ls((e, d, f), [tp, fsdp, None])
        blocks["we_up"] = ls((e, d, f), [tp, fsdp, None])
        blocks["we_down"] = ls((e, f, d), [tp, None, fsdp])
        if fs:
            blocks["ws_gate"] = ls((d, fs), [fsdp, tp])
            blocks["ws_up"] = ls((d, fs), [fsdp, tp])
            blocks["ws_down"] = ls((fs, d), [tp, fsdp])
    elif cfg.mlp == "swiglu":
        blocks["w_gate"] = ls((d, f), [fsdp, tp])
        blocks["w_up"] = ls((d, f), [fsdp, tp])
        blocks["w_down"] = ls((f, d), [tp, fsdp])
    else:
        blocks["w_in"] = ls((d, f), [fsdp, tp])
        blocks["w_out"] = ls((f, d), [tp, fsdp])
    specs: Dict[str, Any] = {
        # vocab over model (sharded softmax / CE), d over the FSDP axes
        "embed": shd.logical_spec(mesh, (cfg.vocab_size, d), [tp, fsdp]),
        "blocks": blocks,
        "final_norm": P(None),
    }
    if cfg.frontend:
        specs["frontend_proj"] = shd.logical_spec(
            mesh, (cfg.frontend_dim, d), [fsdp, tp])
    return specs


def use_specs(cfg: ModelConfig, mesh) -> Dict[str, P]:
    """Per-layer use-time specs of the blocks
    (`distributed.sharding.use_spec`)."""
    return {k: shd.use_spec(s)
            for k, s in param_specs(cfg, mesh)["blocks"].items()}


def gather_for_use(cfg: ModelConfig, mesh, lp: Dict[str, Tensor],
                   specs: Dict[str, P]) -> Dict[str, Tensor]:
    """The layer's placed weights ``lp`` gathered over the FSDP axes to
    their use-time specs ``specs`` in the compute dtype
    (`distributed.sharding.gather_for_use`, one ``all_gather``); on a
    description or no mesh the layer is returned as it is."""
    if not isinstance(mesh, LiveMesh):
        return lp
    placed = {k: P(*list(sp)[1:])
              for k, sp in param_specs(cfg, mesh)["blocks"].items()}
    return shd.gather_for_use(mesh, lp, {k: placed[k] for k in lp},
                              specs, _cdtype(cfg))


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
        k_cache, v_cache, clen = kv_override
        k_cache, v_cache = _write_kv(cfg, k_cache, v_cache, to_planes(k),
                                     to_planes(v),
                                     clen.repeat_interleave(nkv))
        o = decode_attention_planes(q, k_cache.to(cd), v_cache.to(cd), clen)
        kv_out = (k_cache, v_cache)
    else:
        o = prefill_attention(q, k, v, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk)
        kv_out = (k, v)
    o = o.reshape(b, s, nh * dh)
    return _proj(lp, plan_layers, "wo", o, cd), kv_out


def _write_kv(cfg: ModelConfig, k_cache: Tensor, v_cache: Tensor,
              k_t: Tensor, v_t: Tensor, pos: Tensor) -> tuple:
    """The new rows ``k_t`` / ``v_t`` ``[P, s, dh]`` of each plane written
    at ``pos .. pos + s - 1`` (``pos`` ``[P]``) of the planes ``[P, Smax,
    dh]``, as ``cfg.cache_update`` says; returns the caches."""
    k_t, v_t = k_t.to(k_cache.dtype), v_t.to(v_cache.dtype)
    if cfg.cache_update == "scatter":
        # row-sized write, in place: O(P*s*dh) bytes instead of a rewrite
        # of the whole cache
        return (kv_cache_write_chunk(k_cache, k_t, pos),
                kv_cache_write_chunk(v_cache, v_t, pos))
    if cfg.cache_update != "mask":
        raise ValueError(f"cache_update must be 'mask' or 'scatter', got "
                         f"{cfg.cache_update!r}")
    # the one-hot einsum is exact (products with 1.0 and 0.0), so this and
    # the scatter write are bitwise identical
    s, smax = k_t.shape[1], k_cache.shape[1]
    rows = pos[:, None] + torch.arange(s, device=k_cache.device)[None, :]
    oh = rows[:, :, None] == torch.arange(smax, device=k_cache.device)
    written = oh.any(dim=1)[..., None]                      # [P, Smax, 1]
    ohf = oh.to(k_cache.dtype)
    return (torch.where(written, torch.einsum("pcs,pcd->psd", ohf, k_t),
                        k_cache),
            torch.where(written, torch.einsum("pcs,pcd->psd", ohf, v_t),
                        v_cache))


def _mlp(cfg: ModelConfig, lp, h: Tensor, plan_layers=None) -> Tensor:
    cd = _cdtype(cfg)
    x = _norm(cfg, h, lp["mlp_norm"]).to(cd)
    if cfg.mlp == "swiglu":
        g = F.silu(_proj(lp, plan_layers, "w_gate", x, cd)) \
            * _proj(lp, plan_layers, "w_up", x, cd)
        return _proj(lp, plan_layers, "w_down", g, cd)
    g = F.gelu(_proj(lp, plan_layers, "w_in", x, cd), approximate="tanh")
    return _proj(lp, plan_layers, "w_out", g, cd)


def _expert_proj(lp, plan_layers, name: str, x: Tensor, cd) -> Tensor:
    """One per-expert projection on the dispatch buffer ``x [E, C, n_in]``:
    the planned experts' batched kernel (`engine.execute.apply_expert_fc`)
    or the dense batched matmul on ``lp[name]`` ``[E, n_in, n_out]``."""
    if plan_layers is not None and name in plan_layers:
        from ..engine.execute import apply_expert_fc
        return apply_expert_fc(x, plan_layers[name]).to(cd)
    return torch.bmm(x, lp[name].to(cd))


_MOE_SEG = 65536
_ROUTES: list | None = None         # the sink of `record_routes`, when on


@contextlib.contextmanager
def record_routes():
    """``with record_routes() as routes:`` collects into ``routes`` the
    expert ids ``[T, K]`` that every MoE dispatch routes, one a layer and
    segment in call order, on one device or on a live mesh (where every
    rank routes the whole batch's tokens), so two runs' choices compare
    entry for entry."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def _capacity_dispatch(cfg: ModelConfig, eidx: Tensor) -> tuple:
    """``(cap, valid, slot)`` of the routed ``eidx [T, K]``: the capacity
    ``max(8, ceil(T*K/E * capacity_factor))``; whether each assignment's
    position within its expert (a token-major cumsum over the ``[T*K, E]``
    one-hot) is under it (0 / 1 in the compute dtype); and its row
    ``[T*K]`` of the ``[E*cap]`` dispatch buffer (past the capacity:
    clipped to the expert's last row)."""
    t, k = eidx.shape
    e = cfg.n_experts
    cap = max(8, int(math.ceil(t * k / e * cfg.capacity_factor)))
    oh = F.one_hot(eidx.reshape(-1), e)                          # [T*K, E]
    pos = ((oh.cumsum(dim=0) * oh).sum(-1) - 1).reshape(t, k)
    valid = (pos < cap).to(_cdtype(cfg))
    slot = (eidx * cap + pos.clamp(0, cap - 1)).reshape(-1)      # [T*K]
    return cap, valid, slot


def _routed_experts(cfg: ModelConfig, lp, plan_layers, xf: Tensor,
                    gate: Tensor, eidx: Tensor, block=None,
                    gather_out=None, rows=slice(None)) -> Tensor:
    """The routed experts' output for tokens ``xf [T, d]`` routed to
    ``eidx`` with ``gate`` (each ``[T, K]``): capacity dispatch
    (`_capacity_dispatch`), the three per-expert projections
    (`_expert_proj`) and the combine (each ``(t, k)`` slot weighted by its
    gate, summed over k), in the reference's operation order.

    One device fills and runs the whole ``[E, cap, d]`` buffer.  A rank of
    a live mesh passes ``block(cap) -> (e0, el, c0, cl)``, its block of
    experts and capacity rows, which it fills and runs alone;
    ``gather_out(eout [el, cl, d], cap)`` brings the blocks' outputs back
    to ``[E, cap, d]``, and ``rows`` selects the tokens the rank combines.
    Dropped assignments add a zeroed input and weigh 0."""
    cd = _cdtype(cfg)
    t, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    cap, valid, slot = _capacity_dispatch(cfg, eidx)
    xin = xf[:, None, :].expand(t, k, d).reshape(t * k, d) \
        * valid.reshape(-1, 1)
    e0, el, c0, cl = (0, e, 0, cap) if block is None else block(cap)
    at = slot
    if (el, cl) != (e, cap):
        ex, px = slot // cap, slot % cap
        mine = (ex >= e0) & (ex < e0 + el) & (px >= c0) & (px < c0 + cl)
        at, xin = ((ex - e0) * cl + px - c0)[mine], xin[mine]
    # dispatch: scatter-add tokens into [el*cl, d] (dropped ones add 0)
    buf = torch.zeros((el * cl, d), dtype=cd, device=xf.device)
    buf = buf.index_add_(0, at, xin).reshape(el, cl, d)
    hidden = F.silu(_expert_proj(lp, plan_layers, "we_gate", buf, cd)) \
        * _expert_proj(lp, plan_layers, "we_up", buf, cd)
    eout = _expert_proj(lp, plan_layers, "we_down", hidden, cd)
    if gather_out is not None:
        eout = gather_out(eout, cap)
    # combine: gather each (t, k) slot, weight by its gate
    y = eout.reshape(e * cap, d)[slot.reshape(t, k)[rows]]
    return (y * (gate[rows].to(cd) * valid[rows])[..., None]).sum(dim=1)


def _moe(cfg: ModelConfig, lp, h: Tensor, plan_layers=None,
         route=None) -> tuple:
    """Capacity-dispatch MoE FFN.  Returns ``(out, aux_loss, route)`` with
    ``route = (gate, expert ids)``, each ``[B, S, K]``, this block's own
    routing.  ``route`` given forces the dispatch to those experts and
    gates (the teacher-forced parity of `sublayer_diffs`).  Long
    sequences run in segments of <= ``_MOE_SEG`` tokens, as the
    reference's scan does: the dispatch buffers are O(tokens)."""
    cd = _cdtype(cfg)
    b, s, d = h.shape
    x = _norm(cfg, h, lp["mlp_norm"]).to(cd)
    seg_s = max(1, _MOE_SEG // b)
    while s % seg_s:
        seg_s //= 2
    outs = []                               # (y, aux, gate, eidx) per segment
    for j in range(0, s, seg_s):
        seg = slice(j, j + seg_s)
        forced = None if route is None else tuple(
            r[:, seg].reshape(b * seg_s, -1) for r in route)
        y, aux, (g, e) = _moe_tokens(cfg, lp, x[:, seg].reshape(b * seg_s, d),
                                     plan_layers=plan_layers, route=forced)
        outs.append((y.reshape(b, seg_s, d), aux, g.reshape(b, seg_s, -1),
                     e.reshape(b, seg_s, -1)))
    if len(outs) == 1:
        y, aux, g, e = outs[0]
        return y, aux, (g, e)
    ys, auxes, gs, es = zip(*outs)
    return torch.cat(ys, dim=1), torch.stack(auxes).mean(), (
        torch.cat(gs, dim=1), torch.cat(es, dim=1))


def _route(cfg: ModelConfig, lp, xf: Tensor) -> tuple:
    """The router on tokens ``xf [T, d]``: ``(probs [T, E], gate [T, K],
    expert ids [T, K])``, the top-k a stable descending sort and the gates
    renormalized over it."""
    logits = (xf @ lp["router"].to(_cdtype(cfg))).float()        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eidx = gate[:, :cfg.top_k], eidx[:, :cfg.top_k]        # [T, K]
    return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), eidx


def _router_aux(probs: Tensor, eidx: Tensor) -> Tensor:
    """The load-balancing auxiliary (Switch), ``E * sum_e f_e * p_e``, of
    tokens routed with ``probs [T, E]`` to ``eidx [T, K]``."""
    t, e = probs.shape
    assign = torch.zeros((t, e), dtype=torch.float32, device=probs.device)
    assign.scatter_(1, eidx, 1.0)
    return e * torch.mean(assign.mean(0) * probs.mean(0))


def _moe_tokens(cfg: ModelConfig, lp, xf: Tensor, plan_layers=None,
                route=None) -> tuple:
    """Router, top-k, capacity dispatch, experts, combine, shared experts
    for tokens ``xf [T, d]``.  Returns ``(y, aux, (gate, eidx))``.

    The top-k is a stable descending sort, so equal probabilities keep the
    lower expert first as ``lax.top_k`` does (``torch.topk`` does not).
    Positions within each expert come from a token-major cumsum over the
    ``[T*K, E]`` one-hot; assignments past the capacity are clipped to the
    last slot with a zeroed input and a zeroed gate."""
    cd = _cdtype(cfg)
    probs, gate, eidx = _route(cfg, lp, xf)
    own = (gate, eidx)
    aux = _router_aux(probs, eidx)
    if _ROUTES is not None:
        _ROUTES.append(eidx)
    if route is not None:
        gate, eidx = route
    y = _routed_experts(cfg, lp, plan_layers, xf, gate, eidx)
    if cfg.n_shared_experts:
        g = F.silu(_proj(lp, plan_layers, "ws_gate", xf, cd)) \
            * _proj(lp, plan_layers, "ws_up", xf, cd)
        y = y + _proj(lp, plan_layers, "ws_down", g, cd)
    return y, aux, own


def _block(cfg: ModelConfig, h: Tensor, lp, positions: Tensor,
           kv_override=None, plan_layers=None, route=None):
    """One transformer block; returns ``(h, (k, v), aux_loss, route)``:
    the MoE auxiliary loss and this block's own routing (0 and None for a
    dense block).  ``route`` forces an MoE block's routing."""
    attn_out, kv = _attn(cfg, lp, h, positions, kv_override=kv_override,
                         plan_layers=plan_layers)
    h = h + attn_out.to(h.dtype)
    if cfg.family == "moe":
        mlp_out, aux, route = _moe(cfg, lp, h, plan_layers=plan_layers,
                                   route=route)
    else:
        mlp_out, aux = _mlp(cfg, lp, h, plan_layers=plan_layers), 0.0
    return h + mlp_out.to(h.dtype), kv, aux, route


def _embed_tokens(cfg: ModelConfig, params, batch) -> Tensor:
    """Token embeddings in the compute dtype, the first n positions
    replaced by the projected frontend rows when the batch carries
    ``frontend_embed`` ``[B, n, frontend_dim]`` (n <= the sequence)."""
    cd = _cdtype(cfg)
    h = params["embed"][batch["tokens"]].to(cd)
    if cfg.frontend and "frontend_embed" in batch:
        proj = batch["frontend_embed"].to(cd) @ params["frontend_proj"].to(cd)
        h = torch.cat([proj, h[:, proj.shape[1]:]], dim=1)
    return h


def sublayer_diffs(cfg: ModelConfig, params, ref_params, tokens: Tensor,
                   frontend_embed: Tensor | None = None):
    """Teacher-forced per-sublayer comparison of two param sets (a sparse
    plan against its masked-dense reference): walk ``ref_params``'
    prefill and, at every layer, run each sublayer under both param sets
    from the reference's input to it: the attention from the block's
    input ``h``, the MLP or MoE from the reference's ``h + attn``.  So
    rounding differences compound neither across layers nor from one
    sublayer into the next, and each planned projection runs once a
    layer.  An MoE sublayer under ``params`` takes the reference's
    routing (expert ids and gates): a near-tie in the router that breaks
    the other way would send a token to another expert, a large but
    legitimate difference, so the comparison covers the projections
    only; ``agree`` is the share of (token, k) choices on which the
    router of ``params``, on its own ``h + attn``, picks the reference's
    experts.  ``frontend_embed`` enters through the reference's
    embedding, as in a prefill.  Yields one `models.api.BlockDiff` per
    layer (sublayers ``attn`` and ``mlp`` or ``moe``)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    batch = {"tokens": tokens}
    if frontend_embed is not None:
        batch["frontend_embed"] = frontend_embed
    h = _embed_tokens(cfg, ref_params, batch)
    plan = serving_plan(cfg, params)
    ref_plan = serving_plan(cfg, ref_params)
    for i in range(cfg.n_layers):
        lp = {nm: w[i] for nm, w in params["blocks"].items()}
        ref_lp = {nm: w[i] for nm, w in ref_params["blocks"].items()}
        plp = None if plan is None else plan.per_layer[i]
        ref_plp = None if ref_plan is None else ref_plan.per_layer[i]
        a_ref = _attn(cfg, ref_lp, h, positions,
                      plan_layers=ref_plp)[0].to(h.dtype)
        a_got = _attn(cfg, lp, h, positions, plan_layers=plp)[0].to(h.dtype)
        mid = h + a_ref
        agree = None
        if cfg.family == "moe":
            m_ref, _, ref_route = _moe(cfg, ref_lp, mid, plan_layers=ref_plp)
            m_got, _, _ = _moe(cfg, lp, mid, plan_layers=plp,
                               route=ref_route)
            own = _norm(cfg, h + a_got, lp["mlp_norm"]).to(_cdtype(cfg))
            eidx = _route(cfg, lp, own.reshape(b * s, -1))[2]
            agree = float((eidx == ref_route[1].reshape(b * s, -1))
                          .float().mean())
            name = "moe"
        else:
            m_ref = _mlp(cfg, ref_lp, mid, plan_layers=ref_plp)
            m_got = _mlp(cfg, lp, mid, plan_layers=plp)
            name = "mlp"
        m_ref, m_got = m_ref.to(h.dtype), m_got.to(h.dtype)
        want = mid + m_ref
        yield BlockDiff(block=f"layer {i}", out=h + a_got + m_got,
                        ref_out=want, agree=agree,
                        increments=(("attn", a_got, a_ref),
                                    (name, m_got, m_ref)))
        h = want


def dispatch_spec(cfg: ModelConfig, mesh, cap: int) -> P:
    """The reference's constraint on the MoE dispatch buffer ``[E, cap,
    d]`` (its `_moe_tokens`): experts over ``model``, the capacity over
    the data axes, each where it divides."""
    return shd.logical_spec(mesh, (cfg.n_experts, cap, cfg.d_model),
                            [["model"], [("data", "pod")], None])


def cache_specs(cfg: ModelConfig, mesh, batch_size: int) -> Dict[str, P]:
    """The reference's cache specs: the ``[L, B*KH, S, dh]`` planes over
    the data axes (then ``model``) when they divide them, rows replicated
    (`distributed.sharding.kv_plane_spec`).  Without a mesh, ``P()``."""
    if mesh is None:
        return {"k": P(), "v": P()}
    kv = shd.kv_plane_spec(mesh, batch_size * cfg.n_kv_heads, lead_dims=1)
    return {"k": kv, "v": kv}


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------

@register_family(*TRANSFORMER_FAMILIES)
def build(cfg: ModelConfig, device: torch.device, mesh=None) -> ModelBundle:
    if isinstance(mesh, LiveMesh):
        return _build_live(cfg, device, mesh)
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

    def _train_block(h, lp, positions):
        h, _, aux, _ = _block(cfg, h, lp, positions)
        return h, torch.as_tensor(aux, dtype=torch.float32, device=h.device)

    def train_loss(params, batch):
        tokens = batch["tokens"].long()
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
        h = _embed_tokens(cfg, params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(cfg.n_layers):
            lp = {nm: w[i] for nm, w in params["blocks"].items()}
            if cfg.remat:
                h, a = checkpoint(_train_block, h, lp, positions,
                                  use_reentrant=False)
            else:
                h, a = _train_block(h, lp, positions)
            aux = aux + a
        h = _norm(cfg, h, params["final_norm"])
        labels, mask = causal_lm_labels(tokens)
        if cfg.frontend and "frontend_embed" in batch:
            # the frontend rows carry no token: no loss on predicting them
            mask[:, :max(batch["frontend_embed"].shape[1] - 1, 0)] = 0.0
        loss = chunked_cross_entropy(h, params["embed"], labels,
                                     chunk=min(cfg.loss_chunk, s), mask=mask)
        return loss + cfg.router_aux_weight * aux

    def prefill(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        positions = torch.arange(s, device=device)[None].expand(b, s)
        h = _embed_tokens(cfg, params, batch)
        ks, vs = [], []
        for lp, plp in _layers(params):
            h, (k, v), _, _ = _block(cfg, h, lp, positions,
                                     plan_layers=plp)
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
        decode, s > 1 a chunk attending to the cached prefix.  With
        ``cache_update="scatter"`` the new rows are written into ``cache``
        in place and that same dict is returned: the cache passed in is
        consumed.  With ``"mask"`` a new cache is returned and the one
        passed in is left as it was."""
        tokens, clen = batch["tokens"], batch["cache_len"]
        b, s = tokens.shape
        positions = clen[:, None] + torch.arange(s, device=device)[None, :]
        h = params["embed"][tokens].to(cd)
        ks, vs = [], []
        for i, (lp, plp) in enumerate(_layers(params)):
            h, (kc, vc), _, _ = _block(
                cfg, h, lp, positions,
                kv_override=(cache["k"][i], cache["v"][i], clen),
                plan_layers=plp)
            ks.append(kc)
            vs.append(vc)
        if cfg.cache_update == "scatter":
            return _logits(params, h), cache
        return _logits(params, h), {"k": torch.stack(ks),
                                    "v": torch.stack(vs)}

    return ModelBundle(cfg=cfg, device=device, init=init,
                       train_loss=train_loss, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache,
                       param_specs=lambda: param_specs(cfg, mesh),
                       cache_specs=lambda b: cache_specs(cfg, mesh, b))


# ---------------------------------------------------------------------------
# Live mesh: the transformer families' sharded serve program
# ---------------------------------------------------------------------------

def _build_live(cfg: ModelConfig, device: torch.device,
                mesh: LiveMesh) -> ModelBundle:
    """The transformer families' bundle on a live mesh: the reference's
    sharded serve program, each collective explicit
    (`distributed.sharding`).

    Params are this rank's blocks by `param_specs` (``init`` makes them
    whole from the seed on every rank, then places them); the plan is
    placed by `engine.plan.shard_plan`; the KV cache is this rank's planes
    by `cache_specs`.  ``prefill`` and ``decode_step`` take and return the
    whole batch as the one-device bundle does; inside, a rank computes the
    rows of its block of the batch (`distributed.sharding.shard_batch`;
    every row where it does not divide the data axes):

    * each layer's dense weights are gathered to their use-time specs
      (`gather_for_use`): ``wq``, ``wk``, ``wv``, ``w_gate`` and ``w_up``
      (``w_in``) are then column-parallel over ``model``, ``wo`` and
      ``w_down`` (``w_out``) row-parallel, with one ``all_reduce`` over
      ``model``; a planned projection gathers its encoding
      (`engine.execute.apply_fc`) and runs whole;
    * attention runs on the KV planes `cache_specs` put on the rank
      (`distributed.sharding.planes_of` / `rows_of`): no cache plane
      crosses ranks, and the output returns to the batch rows in one
      collective over the plane axes where a rank lacks a row of it.
      Where ``model`` splits no plane, a prefill splits the query groups
      or each q chunk's rows over it as the reference's branches do
      (`prefill_planes`);
    * the MoE sublayer (`moe`) is expert-parallel: the normed rows are
      gathered over the batch axes (one collective) and every rank
      routes the whole batch, as one process does; each rank runs its
      experts (``E / model``, their encodings gathered over the FSDP
      axes only: `engine.plan.gather_layer`) on its block of the
      dispatch buffer (`dispatch_spec`), the blocks' outputs are
      gathered back (one collective) and each rank combines its own
      rows; the router is gathered whole, the shared experts run as the
      dense MLP does;
    * the embedding, split by vocab over ``model`` and by ``d`` over the
      FSDP axes, is a masked local lookup of every row plus one
      ``all_reduce`` (`distributed.sharding.embed_rows`; a vocab that
      ``model`` does not divide is looked up whole); the logits are each
      rank's vocab and ``d`` block's partial product, summed by one
      ``all_reduce`` (`distributed.sharding.vocab_logits`, the last
      positions gathered over the batch axes first);
    * a prefill that carries ``frontend_embed`` (the audio and vlm
      families) projects the rank's rows of it by ``frontend_proj``,
      placed ``[fsdp, model]``: gathered over the FSDP axes,
      column-parallel over ``model``, its columns gathered back, written
      over the first n positions.

    ``train_loss`` is this rank's share of the reference's loss of the
    whole batch, differentiable through every collective (the convention
    of `distributed.sharding`): each gather's backward reduce-scatters
    the gradients onto the blocks, and `runtime.trainer.grad_step` sums
    each leaf's over the axes its spec leaves it replicated on.  It runs
    without a plan (dense weights), as the reference's does.  For the
    families of `LIVE_FAMILIES`."""
    if cfg.family not in LIVE_FAMILIES:
        raise NotImplementedError(
            f"a live mesh serves the {LIVE_FAMILIES} families; {cfg.name} "
            f"is {cfg.family}")
    cd = _cdtype(cfg)
    dh, kh = cfg.head_dim, cfg.n_kv_heads
    g = cfg.n_heads // kh
    pspecs = param_specs(cfg, mesh)
    uspecs = use_specs(cfg, mesh)

    def batch_axes(b: int) -> tuple:
        return shd.shard_batch(mesh, b) or ()

    def plane_axes(b: int) -> tuple:
        return shd.spec_axes(cache_specs(cfg, mesh, b)["k"][1])

    def proj(lp, plp, name: str, x: Tensor, have: tuple) -> tuple:
        """``(x @ W, the axes its columns are split over)``, ``x``'s
        columns split over ``have`` (`distributed.sharding.project`)."""
        planned = None if plp is None else plp.get(name)
        return shd.project(mesh, x, have, lp.get(name), uspecs[name],
                           planned, cd)

    def prefill_planes(q, k, v, pax):
        """Prefill attention on this rank's planes (one plane a batch row
        of `layers.prefill_attention`: q ``[n, s, g, dh]``, k / v ``[n, s,
        1, dh]``); where ``model`` splits no plane (its ranks hold the same
        ones), the reference's other splits over it (layers.py:131-144):
        the query groups when ``model`` divides them, else each q chunk's
        rows, else none."""
        def attend(q, q_part=(0, 1)):
            return prefill_attention(q, k, v, q_chunk=cfg.q_chunk,
                                     kv_chunk=cfg.kv_chunk, q_part=q_part)
        m = mesh.shape.get("model", 1)
        if m == 1 or "model" in pax:
            return attend(q)
        i = mesh.coord()["model"]
        split = P(None, None, "model", None)
        if g % m == 0:
            gl = g // m
            return shd.gather(attend(q[:, :, i * gl:(i + 1) * gl]), mesh,
                              split)
        n, s = q.shape[:2]
        qc, _ = attention_chunks(s, cfg.q_chunk, cfg.kv_chunk)
        if qc % m:
            return attend(q)
        o = attend(q, (i, m)).reshape(n, s // qc, qc // m, g * dh)
        return shd.gather(o, mesh, split).reshape(n, s, g, dh)

    def attn(lp, plp, h, bax, b, pos_fn, kv=None):
        s = h.shape[1]
        pax = plane_axes(b)
        p0, n = shd.block_of(mesh, pax, b * kh)
        x = _norm(cfg, h, lp["attn_norm"]).to(cd)

        def planes(name: str, heads: int) -> Tensor:
            y, have = proj(lp, plp, name, x, ())
            return shd.planes_of(y, mesh, (bax, have), kh, pax).reshape(
                n, s, heads, dh)

        q, k, v = planes("wq", g), planes("wk", 1), planes("wv", 1)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"])
            k = rms_norm(k, lp["k_norm"])
        rows = torch.arange(p0, p0 + n, device=device) // kh
        positions = pos_fn(rows)                            # [n, s]
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
        k, v = k[:, :, 0], v[:, :, 0]                       # [n, s, dh]
        if kv is not None:
            k_cache, v_cache, clen = kv
            pos = clen[rows]
            k_cache, v_cache = _write_kv(cfg, k_cache, v_cache, k, v, pos)
            o = decode_attention_planes(q, k_cache.to(cd), v_cache.to(cd),
                                        pos)
            kv_out = (k_cache, v_cache)
        else:
            o = prefill_planes(q, k[:, :, None], v[:, :, None], pax)
            kv_out = (k, v)
        want = () if plp is not None and "wo" in plp \
            else shd.spec_axes(uspecs["wo"][0])
        o = shd.rows_of(o.reshape(n, s, g * dh), mesh, pax, kh, (bax, want))
        return proj(lp, plp, "wo", o, want)[0], kv_out

    def swiglu(lp, plp, x, names=("w_gate", "w_up", "w_down")):
        gate, up, down = names
        a, have = proj(lp, plp, gate, x, ())
        u, have_u = proj(lp, plp, up, x, ())
        if have != have_u:
            a, u, have = shd.cols(mesh, a, have, ()), \
                shd.cols(mesh, u, have_u, ()), ()
        return proj(lp, plp, down, F.silu(a) * u, have)[0]

    def mlp(lp, plp, h):
        x = _norm(cfg, h, lp["mlp_norm"]).to(cd)
        if cfg.mlp == "swiglu":
            return swiglu(lp, plp, x)
        a, have = proj(lp, plp, "w_in", x, ())
        return proj(lp, plp, "w_out", F.gelu(a, approximate="tanh"),
                    have)[0]

    def moe(lp, plp, h, bax, b):
        """The MoE sublayer of this rank's rows ``h`` ``[bl, s, d]`` as
        the reference's sharded `_moe` runs it: every segment of S (by
        ``_MOE_SEG`` and the whole batch's ``b``) routes the whole
        batch's tokens on every rank, so the capacity, the positions and
        the drops are those of one process; the rank fills, and runs its
        experts on, its block of the dispatch buffer ``[E, cap, d]`` (E
        over ``model``, cap over the data axes where they divide it:
        `dispatch_spec`); the blocks' outputs are gathered back to
        ``[E*cap, d]`` (one collective), and the rank combines its own
        rows in the reference's order.  Returns ``(y, aux)``: ``aux`` the
        whole batch's router auxiliary, the segments' mean, as one
        process's `_moe` has it."""
        s, d = h.shape[1], cfg.d_model
        x = _norm(cfg, h, lp["mlp_norm"]).to(cd)
        xg = shd.gather(x, mesh, P(bax, None, None)) if bax else x
        r0, bl = shd.block_of(mesh, bax, b)

        def axes(cap):          # (expert axes, capacity axes) of the buffer
            return [shd.spec_axes(a)
                    for a in dispatch_spec(cfg, mesh, cap)][:2]

        def block(cap):
            e_ax, c_ax = axes(cap)
            return (*shd.block_of(mesh, e_ax, cfg.n_experts),
                    *shd.block_of(mesh, c_ax, cap))

        def gather_out(eout, cap):
            e_ax, c_ax = axes(cap)
            return shd.gather(eout, mesh, P(e_ax, c_ax, None)) \
                if e_ax or c_ax else eout
        seg_s = max(1, _MOE_SEG // b)
        while s % seg_s:
            seg_s //= 2
        ys, auxes = [], []
        for j in range(0, s, seg_s):
            t = b * seg_s
            xf = xg[:, j:j + seg_s].reshape(t, d)
            probs, gate, eidx = _route(cfg, lp, xf)
            auxes.append(_router_aux(probs, eidx))
            if _ROUTES is not None:
                _ROUTES.append(eidx)
            rows = slice(r0 * seg_s, (r0 + bl) * seg_s)
            y = _routed_experts(cfg, lp, plp, xf, gate, eidx, block=block,
                                gather_out=gather_out, rows=rows)
            if cfg.n_shared_experts:
                y = y + swiglu(lp, plp,
                               x[:, j:j + seg_s].reshape(bl * seg_s, d),
                               ("ws_gate", "ws_up", "ws_down"))
            ys.append(y.reshape(bl, seg_s, d))
        aux = auxes[0] if len(auxes) == 1 else torch.stack(auxes).mean()
        return torch.cat(ys, dim=1), aux

    def frontend_rows(params, h, frontend_embed):
        """``h`` with its first n positions replaced by this rank's rows
        of ``frontend_embed`` ``[bl, n, frontend_dim]`` projected by
        ``frontend_proj`` (gathered over the FSDP axes, column-parallel
        over ``model``, its columns gathered back), as `_embed_tokens`
        does on one device."""
        spec = pspecs["frontend_proj"]
        use = shd.use_spec(spec, stacked=False)
        w = shd.gather_for_use(mesh, {"w": params["frontend_proj"]},
                               {"w": spec}, {"w": use}, cd)["w"]
        y, have = shd.project(mesh, frontend_embed.to(cd), (), w, use,
                              dtype=cd)
        y = shd.cols(mesh, y, have, ())
        return torch.cat([y, h[:, y.shape[1]:]], dim=1)

    def forward(params, tokens, pos_fn, cache=None, frontend_embed=None):
        """``(logits [B, V], per-layer (k, v) planes)`` of the whole batch
        ``tokens`` ``[B, s]`` (and its ``frontend_embed`` rows, a
        prefill's); ``cache`` is ``(k, v, cache_len)`` for a decode
        step."""
        b = tokens.shape[0]
        bax = batch_axes(b)
        r0, bl = shd.block_of(mesh, bax, b)
        e = params["embed"]
        h = shd.embed_rows(mesh, e, pspecs["embed"], tokens, cfg.d_model,
                           slice(r0, r0 + bl)).to(cd)
        if cfg.frontend and frontend_embed is not None:
            h = frontend_rows(params, h, frontend_embed[r0:r0 + bl])
        plan = serving_plan(cfg, params)
        kvs = []
        for i in range(cfg.n_layers):
            plp = plan.per_layer[i] if plan is not None else None
            lp = gather_for_use(
                cfg, mesh, {nm: w[i] for nm, w in params["blocks"].items()
                            if plp is None or nm not in plp}, uspecs)
            kv = None if cache is None else (cache[0][i], cache[1][i],
                                             cache[2])
            a, kv_out = attn(lp, plp, h, bax, b, pos_fn, kv)
            h = h + a.to(h.dtype)
            m = moe(lp, plp, h, bax, b)[0] if cfg.family == "moe" \
                else mlp(lp, plp, h)
            h = h + m.to(h.dtype)
            kvs.append(kv_out)
        last = _norm(cfg, h, params["final_norm"])[:, -1]
        return shd.vocab_logits(mesh, last, e, pspecs["embed"], bax,
                                cfg.vocab_size), kvs

    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return shd.place_tree(init_params(cfg, gen, device),
                              shd.tree_shardings(mesh, pspecs))

    def train_block(h, lp, b, bax, pos_fn):
        """One layer of the train step on this rank's rows ``h``: its
        placed weights ``lp`` gathered to their use-time specs, attention
        and the MLP or MoE as the serve program runs them; returns ``(h,
        the router auxiliary)``."""
        lp = gather_for_use(cfg, mesh, lp, uspecs)
        a, _ = attn(lp, None, h, bax, b, pos_fn)
        h = h + a.to(h.dtype)
        if cfg.family == "moe":
            m, aux = moe(lp, None, h, bax, b)
        else:
            m = mlp(lp, None, h)
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return h + m.to(h.dtype), aux

    def train_loss(params, batch):
        """This rank's share of the mean next-token loss of the whole
        ``batch`` (the convention of `distributed.sharding`: the ranks'
        shares sum to one process's `train_loss`).  The rank runs every
        position of the rows `api.batch_partition_spec` gives it (its
        block of `shard_batch`) through the layers, each remat'd per
        layer when ``cfg.remat`` (`torch.utils.checkpoint`: the backward
        repeats the layer's collectives, in the same order on every
        rank).  The CE runs against the tied embedding gathered whole
        over every axis (its backward one reduce-scatter onto the
        blocks), divided by the whole batch's token count times the
        ranks that repeat these rows; the router auxiliary, which every
        rank takes of the whole batch, enters divided by the mesh's
        size."""
        tokens = batch["tokens"].long()
        b, s = tokens.shape
        bax = batch_axes(b)
        r0, bl = shd.block_of(mesh, bax, b)
        rows = slice(r0, r0 + bl)
        h = shd.embed_rows(mesh, params["embed"], pspecs["embed"], tokens,
                           cfg.d_model, rows).to(cd)
        fe = batch.get("frontend_embed") if cfg.frontend else None
        if fe is not None:
            h = frontend_rows(params, h, fe[rows])

        def pos_fn(prows):
            return torch.arange(s, device=device).expand(len(prows), s)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(cfg.n_layers):
            lp = {nm: w[i] for nm, w in params["blocks"].items()}
            if cfg.remat:
                h, a = checkpoint(train_block, h, lp, b, bax, pos_fn,
                                  use_reentrant=False)
            else:
                h, a = train_block(h, lp, b, bax, pos_fn)
            aux = aux + a
        h = _norm(cfg, h, params["final_norm"])
        labels, mask = causal_lm_labels(tokens)
        if fe is not None:
            # the frontend rows carry no token: no loss on predicting them
            mask[:, :max(fe.shape[1] - 1, 0)] = 0.0
        repeats = mesh.size // math.prod(mesh.shape[x] for x in bax)
        emb = shd.gather(params["embed"], mesh, pspecs["embed"])
        loss = chunked_cross_entropy(
            h, emb, labels[rows], chunk=min(cfg.loss_chunk, s),
            mask=mask[rows], denom=mask.sum().clamp(min=1.0) * repeats)
        return loss + cfg.router_aux_weight * aux / mesh.size

    def prefill(params, batch):
        s = batch["tokens"].shape[1]
        logits, kvs = forward(
            params, batch["tokens"],
            lambda rows: torch.arange(s, device=device).expand(len(rows), s),
            frontend_embed=batch.get("frontend_embed"))
        return logits, {"k": torch.stack([k for k, _ in kvs]).to(KV_DTYPE),
                        "v": torch.stack([v for _, v in kvs]).to(KV_DTYPE)}

    def init_cache(batch_size: int, max_len: int):
        shape = shd.shard_shape(
            mesh, (cfg.n_layers, batch_size * kh, max_len, dh),
            cache_specs(cfg, mesh, batch_size)["k"])
        return {"k": torch.zeros(shape, dtype=KV_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=KV_DTYPE, device=device)}

    def decode_step(params, batch, cache):
        """As the one-device bundle's; ``cache`` is this rank's planes."""
        tokens, clen = batch["tokens"], batch["cache_len"]
        s = tokens.shape[1]
        logits, kvs = forward(
            params, tokens,
            lambda rows: clen[rows][:, None]
            + torch.arange(s, device=device)[None, :],
            cache=(cache["k"], cache["v"], clen))
        if cfg.cache_update == "scatter":
            return logits, cache
        return logits, {"k": torch.stack([k for k, _ in kvs]),
                        "v": torch.stack([v for _, v in kvs])}

    return ModelBundle(cfg=cfg, device=device, init=init,
                       train_loss=train_loss, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache,
                       param_specs=lambda: pspecs,
                       cache_specs=lambda b: cache_specs(cfg, mesh, b))
