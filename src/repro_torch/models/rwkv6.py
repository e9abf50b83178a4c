"""RWKV-6 "Finch" (arXiv:2404.05892), the ``rwkv6-3b`` arch (family ssm) —
counterpart of `repro.models.rwkv6`.

Per layer a time mix (the WKV linear-attention recurrence with a
data-dependent per-channel decay from a LoRA head) and a channel mix (a
token-shift gated FFN).  The projections run over the whole sequence at
once; only the WKV state ``[B, H, dh, dh]`` (f32) recurs over time, as a
Python loop over tokens (`_wkv_scan`, the configs' ``ssm_mode="scan"``) or
over chunks of matmuls (`_wkv_chunked`, ``ssm_mode="chunked"``; decode
always scans).  The cache is the reference's dict: ``att_shift`` and
``ffn_shift`` ``[L, B, D]`` (the last token of each sublayer's input) and
``wkv`` ``[L, B, H, dh, dh]``.

Sense integration: with ``cfg.sparse_serving`` and a plan attached
(``params["sparse_plan"]``, `engine.plan.plan_rwkv6`), prefill and decode
run the R/K/V/G/O and channel-mix projections through
`engine.execute.apply_fc`; the recurrence and the decay head stay dense.

Dtypes follow the reference's promotion: the token-shift state is f32, so
the lerps that mix it in come out f32 (the reference then multiplies f32 by
the compute-dtype weight, in f32).  The port's kernels take one dtype, so
each projection's input is rounded to the compute dtype first, planned or
not; the decay head keeps the reference's f32 product.
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
from .api import (BlockDiff, ModelBundle, init_shapes, planned_proj,
                  register_family, serving_plan)
from .layers import (_row_mean, causal_lm_labels, chunked_cross_entropy,
                     embed_init, layer_norm, matmul_f64)

Tensor = torch.Tensor


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in the promoted dtype of the two (as jnp's ``@``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


@dataclasses.dataclass(frozen=True)
class Split:
    """Where a recurrent layer's channels live.  On one device (the
    default) every column is whole and a projection is `planned_proj`.  On
    a rank of a live mesh (``mesh``) a projection runs at its use-time
    spec (``uspecs``, `distributed.sharding.project`) and the recurrence
    runs on the rank's heads: the state's head dim is split over the axes
    ``heads`` (``model`` where it divides the heads, else none: the
    reference's ``dim_spec`` fallback), ``chans`` its channels."""
    cd: torch.dtype
    mesh: LiveMesh | None = None
    uspecs: dict | None = None
    heads: tuple = ()
    chans: slice = slice(None)

    def proj(self, lp, plan_layers, name: str, x: Tensor,
             have: tuple = (), exact: bool = False) -> tuple:
        """``(x @ W, the axes its columns are split over)`` in the compute
        dtype, ``x``'s columns split over ``have``; ``exact`` (a weight no
        plan covers) sums in float64 (`layers.matmul_f64`)."""
        if self.mesh is None:
            if exact:
                return matmul_f64(x.to(self.cd), lp[name].to(self.cd),
                                  self.cd), ()
            return planned_proj(lp, plan_layers, name, x.to(self.cd),
                                self.cd), ()
        planned = None if plan_layers is None else plan_layers.get(name)
        return shd.project(self.mesh, x.to(self.cd), have, lp.get(name),
                           self.uspecs[name], planned, self.cd, exact=exact)

    def cols(self, x: Tensor, have: tuple, want: tuple) -> Tensor:
        """`distributed.sharding.cols` on a live mesh, else ``x``."""
        return x if self.mesh is None else shd.cols(self.mesh, x, have,
                                                    want)

    def to_heads(self, y_have: tuple) -> Tensor:
        """A projection's output re-laid to the rank's heads."""
        return self.cols(*y_have, self.heads)


def live_split(cfg: ModelConfig, mesh: LiveMesh, specs: dict,
               n_heads: int, head_dim: int) -> Split:
    """The `Split` of a rank of ``mesh``: the blocks' use-time specs from
    their placed ``specs``, the heads over ``model`` where it divides
    ``n_heads``."""
    heads = shd.spec_axes(shd.dim_spec(mesh, n_heads, "model"))
    h0, nhl = shd.block_of(mesh, heads, n_heads)
    return Split(_cdtype(cfg), mesh,
                 {k: shd.use_spec(sp) for k, sp in specs.items()}, heads,
                 slice(h0 * head_dim, (h0 + nhl) * head_dim))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random parameters in the reference's layout and scales (the
    reference's params are converted for comparisons, `models.convert`)."""
    d, f, l, r = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.rwkv_lora_rank
    dt = getattr(torch, cfg.param_dtype)

    def randn(*shape):
        return torch.randn((l, *shape), generator=generator, device=device)

    def mat(*shape):
        return (randn(*shape) / math.sqrt(shape[-2])).to(dt)

    def full(value):
        return torch.full((l, d), value, dtype=dt, device=device)

    blocks = {
        "ln1": full(1.0), "ln1_b": full(0.0),
        "ln2": full(1.0), "ln2_b": full(0.0),
        # time-mix lerp coefficients for r / k / v / g / w
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_g": full(0.5), "mu_w": full(0.5),
        # the decay LoRA: w = exp(-exp(w0 + tanh(xw A) B))
        "w0": full(-6.0),
        "wA": mat(d, r), "wB": (randn(r, d) * 0.01).to(dt),
        "wr": mat(d, d), "wkm": mat(d, d), "wv": mat(d, d), "wg": mat(d, d),
        "wo": mat(d, d),
        "u": (randn(d) * 0.1).to(dt),
        "gn": full(1.0),                 # per-head group-norm gamma
        # channel mix
        "cmu_k": full(0.5), "cmu_r": full(0.5),
        "ck": mat(d, f), "cv": mat(f, d), "cr": mat(d, d),
    }
    return {"embed": embed_init(generator, cfg.vocab_size, d, dt, device),
            "blocks": blocks,
            "final_norm": torch.ones((d,), dtype=dt, device=device)}


def param_specs(cfg: ModelConfig, mesh) -> Dict[str, Any]:
    """The reference's parameter specs (`transformer.param_specs`' rules:
    square projections' output dim over ``model``, the other over the FSDP
    axes, the LoRA and per-channel vectors as the reference has them)."""
    if mesh is None:
        return tree_map(lambda _: P(), init_shapes(cfg))
    d, f = cfg.d_model, cfg.d_ff
    fsdp, tp = [("data", "pod")], ["model"]

    def ls(shape, plan):
        return shd.logical_spec(mesh, (0, *shape), [None, *plan])

    vec = P(None, None)
    blocks = {
        "ln1": vec, "ln1_b": vec, "ln2": vec, "ln2_b": vec,
        "mu_r": vec, "mu_k": vec, "mu_v": vec, "mu_g": vec, "mu_w": vec,
        "w0": vec, "u": vec, "gn": vec, "cmu_k": vec, "cmu_r": vec,
        "wA": ls((d, cfg.rwkv_lora_rank), [fsdp, None]),
        "wB": ls((cfg.rwkv_lora_rank, d), [None, fsdp]),
        "wr": ls((d, d), [fsdp, tp]),
        "wkm": ls((d, d), [fsdp, tp]),
        "wv": ls((d, d), [fsdp, tp]),
        "wg": ls((d, d), [fsdp, tp]),
        "wo": ls((d, d), [tp, fsdp]),
        "ck": ls((d, f), [fsdp, tp]),
        "cv": ls((f, d), [tp, fsdp]),
        "cr": ls((d, d), [fsdp, tp]),
    }
    return {"embed": shd.logical_spec(mesh, (cfg.vocab_size, d), [tp, fsdp]),
            "blocks": blocks,
            "final_norm": P(None)}


# ---------------------------------------------------------------------------
# The WKV recurrence
# ---------------------------------------------------------------------------

def _shift(x: Tensor, last: Tensor) -> Tensor:
    """Token shift: x[:, t] <- x[:, t-1], ``last`` filling t = 0 (the
    concatenation promotes, as the reference's)."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _chunk_len(t: int, chunk: int) -> int:
    c = min(chunk, t)
    while t % c:
        c //= 2
    return c


def _run_chunks(chunk_step, state: Tensor, xs: tuple, c: int):
    """Walk ``xs`` (each ``[B, T, ...]``) in chunks of ``c`` tokens,
    carrying ``state``; each chunk is recomputed in the backward when
    autograd records (the reference's ``jax.checkpoint(chunk_step)``).
    Returns ``(outputs concatenated over T, state)``."""
    outs = []
    for j in range(0, xs[0].shape[1], c):
        part = tuple(z[:, j:j + c] for z in xs)
        if torch.is_grad_enabled():
            y, state = checkpoint(chunk_step, state, *part,
                                  use_reentrant=False)
        else:
            y, state = chunk_step(state, *part)
        outs.append(y)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)), state


def _wkv_scan(r, k, v, w, u, state, *, chunk: int = 64):
    """WKV recurrence over time, one token a step (f32).

    r/k/v/w ``[B, T, H, dh]`` (w the decay in (0, 1)); u ``[H, dh]``;
    state ``[B, H, dh, dh]`` (key-major).  Returns ``(out [B, T, H, dh],
    new state)``, its sums over ``dh`` taken in float64 and rounded to
    float32, so that a head's output does not depend on how many rows and
    heads share the call (on the H100 a float32 batched product of 2 rows
    rounds otherwise than of 4, and a live mesh's rank runs its rows and
    heads alone):

        out_t = r_t . (S_{t-1} + (u * k_t) (x) v_t)
        S_t   = diag(w_t) S_{t-1} + k_t (x) v_t

    The bonus term ``(r_t . (u * k_t)) v_t`` needs no state and is taken
    for all t at once, so a step allocates only ``k_t (x) v_t`` and the new
    state; ``r_t . S_{t-1}`` is taken for a chunk at once after its steps,
    from the states it kept, so the float64 sums cost no launches a step."""
    def chunk_step(s, rc, kc, vc, wc):
        prev = []
        for i in range(rc.shape[1]):
            prev.append(s)
            kv = kc[:, i, ..., :, None] * vc[:, i, ..., None, :]
            s = torch.addcmul(kv, wc[:, i, ..., None], s)
        ys = torch.einsum("bthk,bthkv->bthv", rc.double(),
                          torch.stack(prev, dim=1).double())
        return ys.float(), s

    y, state = _run_chunks(chunk_step, state, (r, k, v, w),
                           _chunk_len(r.shape[1], chunk))
    return y + (r * u * k).double().sum(-1, keepdim=True).float() * v, state


def _wkv_chunked(r, k, v, w, u, state, *, chunk: int = 32):
    """Chunk-parallel WKV: the same recurrence as chunk-local matmuls (f32).

    With ``L_t = sum_{tau <= t} log w_tau`` per channel inside a chunk:

        y_t = r_t.(exp(L_{t-1}) * S_0)                      (inter)
            + sum_{s<t} (r_t exp(L_{t-1} - L_s)) . k_s  v_s  (intra)
            + (r_t.(u * k_t)) v_t                           (diagonal)
        S'  = exp(L_C) S_0 + sum_s exp(L_C - L_s) k_s (x) v_s

    ``exp(-L_s)`` grows within a chunk, so chunks stay short (32) and the
    decay is floored at 1e-37 before its log, as the reference's."""
    c = _chunk_len(r.shape[1], chunk)
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      -1)

    def chunk_step(s, rc, kc, vc, wc):
        logw = torch.log(torch.clamp_min(wc, 1e-37))
        l_incl = torch.cumsum(logw, dim=1)              # L_t
        l_prev = l_incl - logw                          # L_{t-1}
        r_p = rc * torch.exp(l_prev)
        k_m = kc * torch.exp(-l_incl)
        y = torch.einsum("bchk,bhkv->bchv", r_p, s)
        sc = torch.einsum("bchk,bshk->bhcs", r_p, k_m)
        sc = torch.where(tril, sc, 0.0)
        y = y + torch.einsum("bhcs,bshv->bchv", sc, vc)
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
        k_f = kc * torch.exp(l_incl[:, -1:] - l_incl)
        s = torch.exp(l_incl[:, -1])[..., None] * s \
            + torch.einsum("bchk,bchv->bhkv", k_f, vc)
        return y, s

    return _run_chunks(chunk_step, state, (r, k, v, w), c)


# ---------------------------------------------------------------------------
# Time mix / channel mix
# ---------------------------------------------------------------------------

def _group_norm(out: Tensor, gamma: Tensor) -> Tensor:
    """The per-head group norm of ``out`` ``[B, T, H, dh]`` (population
    variance, as jnp.var; its statistics `layers._row_mean`'s, so a head's
    do not depend on the call's rows), times ``gamma`` ``[H*dh]``."""
    mu = _row_mean(out)
    var = _row_mean((out - mu).square())
    return ((out - mu) * torch.rsqrt(var + 1e-5)).flatten(-2) * gamma


def _time_mix(cfg: ModelConfig, lp, x: Tensor, shift_last: Tensor,
              state: Tensor, plan_layers=None, split: Split | None = None
              ) -> tuple:
    """x ``[B, T, D]``; returns ``(out, new shift_last, new state)``.  On
    a rank of a live mesh (``split``) r / k / v / g, the decay and the
    bonus are cut to the rank's heads, the recurrence and the group norm
    run on them (``state`` is the rank's heads) and ``wo`` takes them
    split."""
    split = split or Split(_cdtype(cfg))
    cd = split.cd
    b, t, d = x.shape
    hd = cfg.rwkv_head_dim
    xs = _shift(x, shift_last)

    def lerp(mu):
        return x + (xs - x) * mu.to(cd)

    def heads(name: str, mu: str) -> Tensor:
        return split.to_heads(split.proj(lp, plan_layers, name,
                                         lerp(lp[mu])))

    r, k, v = heads("wr", "mu_r"), heads("wkm", "mu_k"), heads("wv", "mu_v")
    g = F.silu(heads("wg", "mu_g"))
    # the data-dependent decay (the Finch contribution)
    w_log = lp["w0"].to(cd) + _mm(torch.tanh(_mm(lerp(lp["mu_w"]),
                                                 lp["wA"].to(cd))),
                                  lp["wB"].to(cd))
    w = torch.exp(-torch.exp(w_log.float()))[..., split.chans]   # in (0, 1)
    nh = r.shape[-1] // hd
    hs = (b, t, nh, hd)
    wkv = _wkv_chunked if (cfg.ssm_mode == "chunked" and t > 1) \
        else _wkv_scan
    out, state = wkv(r.reshape(hs).float(), k.reshape(hs).float(),
                     v.reshape(hs).float(), w.reshape(hs),
                     lp["u"].float()[split.chans].reshape(nh, hd), state)
    out = _group_norm(out, lp["gn"].float()[split.chans])
    out = split.proj(lp, plan_layers, "wo", out.to(cd) * g, split.heads)[0]
    return out, x[:, -1, :], state


def _channel_mix(cfg: ModelConfig, lp, x: Tensor, shift_last: Tensor,
                 plan_layers=None, split: Split | None = None) -> tuple:
    """On a rank of a live mesh ``ck`` and ``cr`` are column-parallel,
    ``cv`` row-parallel on ``ck``'s split."""
    split = split or Split(_cdtype(cfg))
    cd = split.cd
    xs = _shift(x, shift_last)
    xk = x + (xs - x) * lp["cmu_k"].to(cd)
    xr = x + (xs - x) * lp["cmu_r"].to(cd)
    k, have = split.proj(lp, plan_layers, "ck", xk)
    kv = split.proj(lp, plan_layers, "cv", torch.square(F.relu(k)), have)[0]
    r = split.cols(*split.proj(lp, plan_layers, "cr", xr), ())
    return torch.sigmoid(r) * kv, x[:, -1, :]


def _time_mix_inc(cfg: ModelConfig, lp, h: Tensor, att_shift: Tensor,
                  state: Tensor, plan_layers=None, split=None) -> tuple:
    """The time mix's increment to the residual ``h`` (in ``h``'s dtype);
    returns ``(increment, att_shift, state)``."""
    x = layer_norm(h, lp["ln1"], lp["ln1_b"]).to(_cdtype(cfg))
    att, att_shift, state = _time_mix(cfg, lp, x, att_shift, state,
                                      plan_layers=plan_layers, split=split)
    return att.to(h.dtype), att_shift, state


def _channel_mix_inc(cfg: ModelConfig, lp, h: Tensor, ffn_shift: Tensor,
                     plan_layers=None, split=None) -> tuple:
    """The channel mix's increment to the residual ``h``; returns
    ``(increment, ffn_shift)``."""
    x = layer_norm(h, lp["ln2"], lp["ln2_b"]).to(_cdtype(cfg))
    ffn, ffn_shift = _channel_mix(cfg, lp, x, ffn_shift,
                                  plan_layers=plan_layers, split=split)
    return ffn.to(h.dtype), ffn_shift


def _block(cfg: ModelConfig, lp, h: Tensor, att_shift: Tensor,
           ffn_shift: Tensor, state: Tensor, plan_layers=None,
           split=None) -> tuple:
    """One layer; returns ``(h, att_shift, ffn_shift, state)``."""
    att, att_shift, state = _time_mix_inc(cfg, lp, h, att_shift, state,
                                          plan_layers=plan_layers,
                                          split=split)
    h = h + att
    ffn, ffn_shift = _channel_mix_inc(cfg, lp, h, ffn_shift,
                                      plan_layers=plan_layers, split=split)
    return h + ffn, att_shift, ffn_shift, state


def _zero_states(cfg: ModelConfig, b: int, device) -> tuple:
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32,  # noqa: E731
                                   device=device)
    return (zeros(cfg.n_layers, b, d), zeros(cfg.n_layers, b, d),
            zeros(cfg.n_layers, b, d // hd, hd, hd))


def _layer(params, i: int) -> dict:
    return {nm: w[i] for nm, w in params["blocks"].items()}


def sublayer_diffs(cfg: ModelConfig, params, ref_params, tokens: Tensor):
    """Teacher-forced per-sublayer comparison of two param sets (a sparse
    plan against its masked-dense reference), as
    `transformer.sublayer_diffs`: walk ``ref_params``' prefill and run
    each layer's time mix from the reference's input ``h`` and its channel
    mix from the reference's ``h + att``, under both, with zero shift and
    WKV states (a prefill starts from zero).  Yields one
    `models.api.BlockDiff` per layer (``time_mix``, ``channel_mix``)."""
    h = ref_params["embed"][tokens].to(_cdtype(cfg))
    att0, ffn0, wkv0 = (z[0] for z in _zero_states(cfg, tokens.shape[0],
                                                    tokens.device))
    plan, ref_plan = serving_plan(cfg, params), serving_plan(cfg, ref_params)
    for i in range(cfg.n_layers):
        lp, ref_lp = _layer(params, i), _layer(ref_params, i)
        plp = None if plan is None else plan.per_layer[i]
        ref_plp = None if ref_plan is None else ref_plan.per_layer[i]
        a_ref = _time_mix_inc(cfg, ref_lp, h, att0, wkv0,
                              plan_layers=ref_plp)[0]
        a_got = _time_mix_inc(cfg, lp, h, att0, wkv0, plan_layers=plp)[0]
        mid = h + a_ref
        f_ref = _channel_mix_inc(cfg, ref_lp, mid, ffn0,
                                 plan_layers=ref_plp)[0]
        f_got = _channel_mix_inc(cfg, lp, mid, ffn0, plan_layers=plp)[0]
        want = mid + f_ref
        yield BlockDiff(block=f"layer {i}", out=h + a_got + f_got,
                        ref_out=want, agree=None,
                        increments=(("time_mix", a_got, a_ref),
                                    ("channel_mix", f_got, f_ref)))
        h = want


def cache_specs(cfg: ModelConfig, mesh, batch_size: int) -> Dict[str, P]:
    """The reference's cache specs: the token-shift states ``[L, B, D]``
    and the WKV state ``[L, B, H, dh, dh]`` with the batch over the data
    axes that divide it (`distributed.sharding.shard_batch`), the heads
    over ``model`` when it divides them.  Without a mesh, ``P()``."""
    if mesh is None:
        return {"att_shift": P(), "ffn_shift": P(), "wkv": P()}
    dp = shd.shard_batch(mesh, batch_size)
    hsp = shd.dim_spec(mesh, cfg.d_model // cfg.rwkv_head_dim, "model")
    return {"att_shift": P(None, dp, None), "ffn_shift": P(None, dp, None),
            "wkv": P(None, dp, hsp, None, None)}


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------

@register_family("ssm")
def build(cfg: ModelConfig, device: torch.device, mesh=None) -> ModelBundle:
    if isinstance(mesh, LiveMesh):
        return _build_live(cfg, device, mesh)
    cd = _cdtype(cfg)

    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_params(cfg, gen, device)

    def _forward(params, tokens: Tensor, states: tuple, plan=None,
                 remat: bool = False):
        """All layers from ``states`` (``[L, ...]`` each); returns the
        final-normed hidden states and the new states, stacked."""
        h = params["embed"][tokens].to(cd)
        new = ([], [], [])
        for i in range(cfg.n_layers):
            args = (_layer(params, i), h, *(s[i] for s in states))
            plp = None if plan is None else plan.per_layer[i]
            if remat:
                h, *st = checkpoint(_block, cfg, *args, plan_layers=plp,
                                    use_reentrant=False)
            else:
                h, *st = _block(cfg, *args, plan_layers=plp)
            for acc, s in zip(new, st):
                acc.append(s)
        h = layer_norm(h, params["final_norm"], None)
        return h, tuple(torch.stack(acc) for acc in new)

    def _logits(params, h):
        return h[:, -1].float() @ params["embed"].float().T

    def _cache(states):
        return dict(zip(("att_shift", "ffn_shift", "wkv"), states))

    def train_loss(params, batch):
        tokens = batch["tokens"].long()
        s = tokens.shape[1]
        h, _ = _forward(params, tokens,
                        _zero_states(cfg, tokens.shape[0], tokens.device),
                        remat=cfg.remat)
        labels, mask = causal_lm_labels(tokens)
        return chunked_cross_entropy(h, params["embed"], labels,
                                     chunk=min(cfg.loss_chunk, s), mask=mask)

    def prefill(params, batch):
        tokens = batch["tokens"]
        h, states = _forward(params, tokens,
                             _zero_states(cfg, tokens.shape[0], device),
                             plan=serving_plan(cfg, params))
        return _logits(params, h), _cache(states)

    def init_cache(batch_size: int, max_len: int):
        return _cache(_zero_states(cfg, batch_size, device))

    def decode_step(params, batch, cache):
        states = (cache["att_shift"], cache["ffn_shift"], cache["wkv"])
        h, states = _forward(params, batch["tokens"], states,
                             plan=serving_plan(cfg, params))
        return _logits(params, h), _cache(states)

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

    Params are this rank's blocks by `param_specs`; the plan is placed by
    `engine.plan.shard_plan`; the cache is this rank's block by
    `cache_specs`: its batch rows of the token-shift states ``[L, B, D]``
    and its rows and heads of the WKV state.  ``prefill`` and
    ``decode_step`` take and return the whole batch as the one-device
    bundle does; inside, a rank computes the rows of its block of the
    batch (`distributed.sharding.shard_batch`):

    * each layer's dense weights are gathered over the FSDP axes to their
      use-time specs (`distributed.sharding.gather_for_use`): ``wr``,
      ``wkm``, ``wv``, ``wg``, ``ck`` and ``cr`` are column-parallel over
      ``model``, ``wo`` and ``cv`` row-parallel (one ``all_reduce``), the
      decay LoRA ``wA`` / ``wB`` whole; a planned projection gathers its
      encoding and runs whole;
    * the time mix's r / k / v / g and decay are cut to the rank's heads
      (`Split`), on which the WKV recurrence and the group norm run;
    * the embedding and the logits as the transformer's
      (`distributed.sharding.embed_rows`, `vocab_logits`)."""
    cd = _cdtype(cfg)
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    pspecs = param_specs(cfg, mesh)
    placed = {k: P(*list(sp)[1:]) for k, sp in pspecs["blocks"].items()}
    split = live_split(cfg, mesh, pspecs["blocks"], d // hd, hd)

    def forward(params, tokens: Tensor, states: tuple) -> tuple:
        """``(logits [B, V], the rank's new states)`` of the whole batch
        ``tokens`` from the rank's ``states``."""
        b = tokens.shape[0]
        bax = shd.shard_batch(mesh, b) or ()
        r0, bl = shd.block_of(mesh, bax, b)
        h = shd.embed_rows(mesh, params["embed"], pspecs["embed"], tokens,
                           d, slice(r0, r0 + bl)).to(cd)
        plan = serving_plan(cfg, params)
        new = ([], [], [])
        for i in range(cfg.n_layers):
            plp = None if plan is None else plan.per_layer[i]
            lp = shd.gather_for_use(
                mesh, {nm: w[i] for nm, w in params["blocks"].items()
                       if plp is None or nm not in plp},
                placed, split.uspecs, cd)
            h, *st = _block(cfg, lp, h, *(s[i] for s in states),
                            plan_layers=plp, split=split)
            for acc, s in zip(new, st):
                acc.append(s)
        h = layer_norm(h, params["final_norm"], None)
        logits = shd.vocab_logits(mesh, h[:, -1], params["embed"],
                                  pspecs["embed"], bax, cfg.vocab_size)
        return logits, dict(zip(("att_shift", "ffn_shift", "wkv"),
                                (torch.stack(acc) for acc in new)))

    def init(seed: int = 0):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return shd.place_tree(init_params(cfg, gen, device),
                              shd.tree_shardings(mesh, pspecs))

    def train_loss(params, batch):
        raise NotImplementedError("the sharded train step is not ported; "
                                  "a live mesh serves prefill and decode")

    def init_cache(batch_size: int, max_len: int):
        specs = cache_specs(cfg, mesh, batch_size)
        whole = _zero_states(cfg, batch_size, "meta")
        return {k: torch.zeros(shd.shard_shape(mesh, tuple(t.shape),
                                               specs[k]),
                               dtype=t.dtype, device=device)
                for k, t in zip(("att_shift", "ffn_shift", "wkv"), whole)}

    def prefill(params, batch):
        cache = init_cache(batch["tokens"].shape[0], 1)
        return forward(params, batch["tokens"],
                       (cache["att_shift"], cache["ffn_shift"], cache["wkv"]))

    def decode_step(params, batch, cache):
        return forward(params, batch["tokens"],
                       (cache["att_shift"], cache["ffn_shift"], cache["wkv"]))

    return ModelBundle(cfg=cfg, device=device, init=init,
                       train_loss=train_loss, prefill=prefill,
                       decode_step=decode_step, init_cache=init_cache,
                       param_specs=lambda: pspecs,
                       cache_specs=lambda b: cache_specs(cfg, mesh, b))
