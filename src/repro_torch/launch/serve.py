"""Serving launcher: batched prefill + greedy decode with Sense sparse
weights — counterpart of `repro.launch.serve`, for every family the
reference serves.

``python -m repro_torch.launch.serve --arch olmo-1b --sparsity 0.5``, or
``--arch`` deepseek-moe-16b, rwkv6-3b, zamba2-1.2b, musicgen-medium,
internvl2-2b (on the GPU; add ``--smoke --device cpu`` for the small config
on a CPU; the frontend archs are served tokens only, as the reference
serves them); ``--quant int8|int4`` serves block-quantized encodings
through the quant kernels; ``--traffic`` serves a seeded Poisson request
stream through the continuous-batching runtime (`serving/`, the
transformer families only) against the static batch loop, after a
paged-vs-contiguous parity gate held at exactly 0.0.

One offline pass (`engine.plan.plan_model`) balanced-prunes every
projection (and every routed expert), picks the per-layer dataflow mode
and kernel impl, and pre-encodes the weights; prefill and decode then
execute the plan — on a GPU every planned projection runs the hand-written
CUDA kernels, the routed experts all in one batched launch per projection.
Reports the plan, a sparse-vs-masked-dense parity check, the dispatch and
kernel-launch counts, dense vs sparse tokens/s and the weight storage.

``--tune cached|sweep`` (cache file ``--tune-cache``) resolves each
layer's blocks through the measured autotuner (`kernels.autotune`);
``--objective dram|energy|balanced`` with ``--deployment`` plans against
the cost model (`launch.cost_model`), and the report carries the plan's
cost summary.  ``--guard`` validates the plan strictly, probes every
layer down the impl ladder (`engine.guard.harden_plan`; every demotion is
printed, stamped in the plan and reported, and its dispatches tick
``degraded_dispatch``) and runs one untimed guarded pass that checks the
logits after the prefill and every decode step, bisecting a NaN to the
layer that made it and quarantining that layer to dense;
``--inject-nan`` (only under ``--guard``) poisons one planned layer first.
Without ``--guard`` nothing of the ladder runs.

``--mesh data=2,model=2 --dist-init URL`` serves the static greedy path
(a prefill, then ``--gen-steps`` decode steps) on a live mesh of that
many `torch.distributed` ranks, one process each (`launch.ranks`), over
``gloo``: each rank holds its shards of the params, the plan and the KV
cache by the reference's specs and runs its family's sharded program
(`models.transformer`: the dense, MoE, audio and vlm
families, the MoE's routed experts split over ``model``; `models.rwkv6`
and `models.zamba2`: the recurrent families, their channels split over
``model`` by heads); on a GPU every rank uses the card of its rank modulo
the card count.  The ranks set up in turns: rank 0 alone, then as
many at once as the card holds by rank 0's set-up peak.  The report carries
rank 0's tokens and prefill logits held against a one-process run of
the same plan, each rank's resident bytes beside the dry run's
`shard_bytes`, its collectives (`distributed.sharding.COLLECTIVES`),
kernel launches, set-up and serving peak memory and wall, and for the
MoE its block of experts, the experts each batched dispatch ran and its
routing's agreement with one process.  ``--guard`` and ``--tune`` are
refused with it (the reference's guard and autotuner take no mesh).

``--traffic --mesh`` runs `traffic_mode` on every rank (the transformer
families): both engines' pools are placed by `paged_pool_specs` (each
rank holds its block of the pool planes; a step gathers the pages of
its view planes and sends its written rows back in one ``all_to_all``
each, `serving.paged_kv`), and the arrival clock is rank 0's
(`serving.traffic.Clock`), so every rank runs the same schedule.  It
raises unless on every rank the paged replay equals the contiguous one
exactly, its tokens equal a one-process replay of the same schedule
with the logits within the parity tolerance, both pools' resident bytes
equal `shard_bytes` and its kernel launches equal the one-process
replay's; the report carries rank 0's continuous and static metrics and
each rank's exchange, launches, peaks and wall.  On the CPU (``--smoke
--device cpu``) the kernels' plain versions run; on the card the CUDA
kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time

import numpy as np
import torch

from ..configs import ARCHS, TRANSFORMER_FAMILIES, get_config, get_smoke
from ..core.compression import compressed_bits
from ..device import exact_matmuls, resolve_device
from ..distributed import sharding as shd
from ..engine import execute as engine_execute
from ..engine import plan as engine_plan
from ..kernels import balanced_spmm, kv_cache_update
from ..kernels.ops import SKINNY_M
from ..kernels.tile_format import QUANT_MODES, TiledBalanced
from ..models import build_model, transformer
from ..models.api import merge_prefill_cache, sublayer_diffs
from . import cost_model
from .mesh_run import (against_one_process, in_turns, parse_mesh,
                       peak_gib, rank_mesh, routing_agreement, zero_counts)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_generate(bundle, params, prompt: torch.Tensor, steps: int,
                    max_len: int, logits_out: list | None = None
                    ) -> torch.Tensor:
    """Greedy decode of ``steps`` tokens after the prompt; ``logits_out``,
    when given, receives the logits the prefill and each decode step
    chose from.

    ``max_len`` must cover every KV row written: prompt rows 0..p-1 plus
    one row per decode step (step i writes at ``p + i``), so the bound is
    ``prompt_len + steps <= max_len``; past it the cache write would fall
    outside the cache, so it raises here instead.
    """
    if prompt.shape[1] + steps > max_len:
        raise ValueError(
            f"KV cache overrun: prompt_len={prompt.shape[1]} + "
            f"steps={steps} > max_len={max_len} — decode would write past "
            "the cache end; raise max_len or shorten the generation")
    b = prompt.shape[0]
    with torch.no_grad():
        logits, pf_cache = bundle.prefill(params, {"tokens": prompt})
        cache = bundle.merge(bundle.init_cache(b, max_len), pf_cache)
        toks = logits.argmax(dim=-1)[:, None]
        out = [toks]
        clen = torch.full((b,), prompt.shape[1], dtype=torch.long,
                          device=prompt.device)
        for _ in range(steps):
            if logits_out is not None:
                logits_out.append(logits)
            logits, cache = bundle.decode_step(
                params, {"tokens": toks, "cache_len": clen}, cache)
            toks = logits.argmax(dim=-1)[:, None]
            clen = clen + 1
            out.append(toks)
        if logits_out is not None:
            logits_out.append(logits)
    return torch.cat(out, dim=1)


def guarded_generate(bundle, plan, params, prompt: torch.Tensor, steps: int,
                     max_len: int, *, ref_blocks=None):
    """One guarded serving pass, the greedy path of `greedy_generate` with
    the logits checked after the prefill and after every decode step; on a
    non-finite one, bisect the plan against the dense reference
    (`engine.guard.locate_poisoned`, its oracle a prefill and one decode
    step), quarantine the culprit layer(s) to dense (``ref_blocks``: the
    masked-dense weights in params layout) and restart under the repaired
    plan.  Returns ``(tokens, plan, events)``.  Untimed: every check is a
    host sync."""
    from ..engine import guard as engine_guard
    if prompt.shape[1] + steps > max_len:
        raise ValueError(f"KV cache overrun: prompt_len={prompt.shape[1]} "
                         f"+ steps={steps} > max_len={max_len}")
    b = prompt.shape[0]

    def finite(t: torch.Tensor) -> bool:
        return bool(torch.isfinite(t).all())

    def prefill(p):
        logits, pf_cache = bundle.prefill(p, {"tokens": prompt})
        cache = bundle.merge(bundle.init_cache(b, max_len), pf_cache)
        clen = torch.full((b,), prompt.shape[1], dtype=torch.long,
                          device=prompt.device)
        return logits, cache, clen

    def eval_finite(cand_plan) -> bool:
        # a prefill and a decode step: a NaN in a q / k projection can
        # surface only through the decode's attention
        p = {**params, "sparse_plan": cand_plan}
        with torch.no_grad():
            lg, cache, clen = prefill(p)
            if not finite(lg):
                return False
            lg2, _ = bundle.decode_step(
                p, {"tokens": lg.argmax(dim=-1)[:, None],
                    "cache_len": clen}, cache)
        return finite(lg2)

    events = []
    for _ in range(4):      # each repair round quarantines >= 1 layer
        p = {**params, "sparse_plan": plan}
        tripped_at = None
        with torch.no_grad():
            logits, cache, clen = prefill(p)
            if not finite(logits):
                tripped_at = "prefill"
            else:
                toks = logits.argmax(dim=-1)[:, None]
                out = [toks]
                for step in range(steps):
                    logits, cache = bundle.decode_step(
                        p, {"tokens": toks, "cache_len": clen}, cache)
                    if not finite(logits):
                        tripped_at = f"decode_step_{step}"
                        break
                    toks = logits.argmax(dim=-1)[:, None]
                    clen = clen + 1
                    out.append(toks)
        if tripped_at is None:
            return torch.cat(out, dim=1), plan, events
        poisoned, attributable = engine_guard.locate_poisoned(
            plan, eval_finite, ref_blocks=ref_blocks)
        events.append({"event": "nan_trip", "at": tripped_at,
                       "poisoned_layers": list(poisoned),
                       "attributable": attributable})
        if not attributable or not poisoned:
            raise engine_guard.GuardError(
                f"non-finite logits at {tripped_at} not attributable to "
                f"any planned sparse layer (bisection blamed "
                f"{list(poisoned)}) — the poison is outside the plan "
                "(component: model params / dense path)")
        print(f"[serve/guard] non-finite logits at {tripped_at}; bisection "
              f"blames {list(poisoned)}; quarantined to dense, restarting "
              "the guarded pass")
        plan = engine_guard.quarantine_layers(plan, poisoned, ref_blocks)
    raise engine_guard.GuardError(
        "guarded serving did not stabilize after 4 quarantine rounds")


def _compare(got: torch.Tensor, want: torch.Tensor, tol: float):
    """``(max |got - want|, all finite and |got - want| <= tol + tol*|want|)``
    — the reference's ``assert_allclose(rtol=tol, atol=tol)``."""
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()) \
        and bool((err <= tol + tol * want.float().abs()).all())
    return float(err.max()), ok


def _gate_excess(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """How far the worst output of ``got`` lies past `_compare`'s bound:
    ``max(|got - want| - (tol + tol*|want|))`` (<= 0 within the gate; +inf
    where ``got`` holds a non-finite value)."""
    if not bool(torch.isfinite(got).all()):
        return math.inf
    err = (got.float() - want.float()).abs()
    return float((err - (tol + tol * want.float().abs())).max())


def gate_block(diff, tol: float) -> list:
    """Serve's per-block gate on one `models.api.BlockDiff`: each
    sublayer's increment against the reference's, `_compare` at ``tol``,
    and the block output finite.  Returns per sublayer ``(name, max |diff|,
    within, excess)`` (`_gate_excess`), then ``("output", max |diff|,
    finite, excess)``: the block output is reported, its bound not gated
    (a bf16 block rounds its residual sums at the residual's magnitude,
    which an increment that cancels the residual to a small output does
    not have)."""
    rows = [(name, *_compare(got, want, tol), _gate_excess(got, want, tol))
            for name, got, want in diff.increments]
    out_diff = float((diff.out.float() - diff.ref_out.float()).abs().max())
    rows.append(("output", out_diff, bool(torch.isfinite(diff.out).all()),
                 _gate_excess(diff.out, diff.ref_out, tol)))
    return rows


def _parity_check(bundle, sparse_params, ref_params, prompt, *,
                  tol: float) -> dict:
    """Sparse plan vs its masked-dense reference on the prompt.

    Gated: every sublayer's increment to the residual (attention, MLP or
    MoE, time / channel mix, Mamba mixer; the family's
    `models.api.sublayer_diffs`), each side computed from the reference's
    input to that sublayer (in an MoE block also with the reference's
    routing, in a recurrent one from zero states), within ``tol`` (abs +
    rel, `_compare`), and every block output finite; at float32 compute
    also the prefill logits within ``tol``, each side routing on its own.
    The block outputs are reported (``layer_max_abs_diff``), not gated: a
    bf16 block rounds its residual sums at the residual's magnitude, so a
    1-ulp difference at magnitude 8 that cancels to a small output lies
    past ``tol + tol*|out|`` on a correct plan.  At bfloat16 the end-to-end
    logits are reported, not gated: rounding-order differences compound
    over depth (full-width olmo-1b on an H100, identical weights: max
    |dlogit| 5.8e-2 at bf16, 1.1e-5 at f32 — see PERF.md).  For MoE it
    reports the share of (token, k) router choices on which the two
    sides' own routing agrees, over all layers; and the gate's margin
    over the sublayers (``layer_gate_excess``, at most 0 when it passes)
    with the one that came closest (``layer_gate_closest``)."""
    cfg = bundle.cfg
    outs, agree, bad = [], [], []
    closest = (-math.inf, "")
    with torch.no_grad():
        logits_s, _ = bundle.prefill(sparse_params, {"tokens": prompt})
        logits_r, _ = bundle.prefill(ref_params, {"tokens": prompt})
        for diff in sublayer_diffs(cfg, sparse_params, ref_params, prompt):
            if diff.agree is not None:
                agree.append(diff.agree)
            for name, err, ok, excess in gate_block(diff, tol):
                where = f"{diff.block} {name}"
                if name == "output":
                    outs.append(err)
                elif excess >= closest[0]:
                    closest = (excess, where)
                if not ok:
                    bad.append(f"{where} (max |diff| {err:.6g})")
    logit_diff, logits_ok = _compare(logits_s, logits_r, tol)
    if bad or (cfg.compute_dtype == "float32" and not logits_ok):
        raise AssertionError(
            f"sparse plan differs from the masked-dense reference (tol "
            f"{tol:g}): {', '.join(bad) or 'every sublayer within'}; "
            f"block outputs' max |diff| {[round(d, 6) for d in outs]}, "
            f"max |dlogit| {logit_diff}")
    out = {"logits_max_abs_diff": logit_diff,
           "logits_within_tol": logits_ok,
           "layer_max_abs_diff": max(outs),
           # the sublayer gate's margin: its closest approach (< 0 passes)
           "layer_gate_excess": closest[0],
           "layer_gate_closest": closest[1],
           "argmax_equal": bool((logits_s.argmax(-1)
                                 == logits_r.argmax(-1)).all())}
    if agree:
        out["routing_agreement"] = sum(agree) / len(agree)
    return out


def kernels_reached(plan, m_prefill: int, m_decode: int) -> set:
    """The kernels of `kernels.balanced_spmm` that serving this plan
    launches on a GPU: for 2-D ``cuda`` layers the wide or skinny kernel of
    each GEMM M (prefill ``batch * prompt_len``, decode ``batch``), for
    ``cuda`` expert layers the batched one; the ``_q`` twin of each for a
    quantized layer."""
    need = set()
    for lp in plan.layers.values():
        if lp.spec.impl != "cuda":
            continue
        q = "_q" if lp.spec.quant != "none" else ""
        if lp.spec.experts:
            need.add("tiled_balanced_spmm_batched" + q)
            continue
        for m in (m_prefill, m_decode):
            need.add(("tiled_balanced_spmm_skinny" if m <= SKINNY_M
                      else "tiled_balanced_spmm") + q)
    return need


def traffic_scenario(cfg, args: argparse.Namespace) -> dict:
    """``--traffic``'s seeded scenario and the engines' geometry: the
    requests and their Poisson arrivals, the prompt lengths and budgets
    drawn from, the page size, the view's pages and padded width, the
    slots, the chunk widths the scenario can produce and the parity
    replay's request count.  The same on every rank of a mesh and in a
    one-process run of the same arguments."""
    from ..serving import traffic as tr
    rng = np.random.default_rng(args.seed)
    prompt_lens = (args.prompt_len // 2, args.prompt_len)
    gen_steps = (max(args.gen_steps // 4, 2), args.gen_steps)
    reqs = tr.make_requests(args.requests, rng, vocab=cfg.vocab_size,
                            prompt_lens=prompt_lens, gen_steps=gen_steps)
    arrivals = tr.poisson_arrivals(len(reqs), args.rate, rng)
    ps = args.page_size
    budget = max(r["prompt"].shape[0] + r["max_new_tokens"] - 1
                 for r in reqs)
    view_pages = -(-budget // ps)
    # chunk widths this scenario can produce: full prefill chunks, each
    # prompt length's remainder chunk, and single-token decode
    pc = args.prefill_chunk
    widths = {1} | {pc for p in prompt_lens if p >= pc} \
        | {p % pc for p in prompt_lens if p % pc} \
        | {p for p in prompt_lens if p < pc}
    return {"reqs": reqs, "arrivals": arrivals, "prompt_lens": prompt_lens,
            "gen_steps": gen_steps, "page_size": ps,
            "view_pages": view_pages,
            "max_len": view_pages * ps,   # shared padded width: exact parity
            "slots": args.slots, "widths": widths,
            "n_par": min(len(reqs), 2 * args.slots)}


def paged_engine(bundle, params, sc: dict, args: argparse.Namespace,
                 mesh=None, **kw):
    """The scenario's paged engine (`serving.ServingEngine`), its pool
    placed on ``mesh`` where one is given."""
    from ..serving import ServingEngine
    return ServingEngine(bundle, params,
                         num_pages=sc["slots"] * sc["view_pages"] + 1,
                         page_size=sc["page_size"], max_slots=sc["slots"],
                         max_pages_per_slot=sc["view_pages"],
                         prefill_chunk=args.prefill_chunk, mesh=mesh, **kw)


def replay(eng, sc: dict) -> dict:
    """The parity replay's schedule on ``eng``: the scenario's first
    ``n_par`` requests submitted at once and served to the end, no
    arrival clock (deterministic).  Returns each request's tokens."""
    for r in sc["reqs"][:sc["n_par"]]:
        eng.submit(r["prompt"], r["max_new_tokens"])
    eng.run()
    return {r.rid: list(r.out_tokens) for r in eng.sched.done}


def _counts_since(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def _collectives_since(before: dict, after: dict) -> dict:
    return {k: {f: c[f] - before.get(k, {}).get(f, 0) for f in c}
            for k, c in after.items()
            if c != before.get(k)}


def traffic_mode(bundle, serve_params, cfg, args, mesh=None) -> dict:
    """``--traffic``: the continuous-batching runtime under a seeded
    Poisson arrival scenario, A/B'd against the static batch loop at
    equal load, plus the paged-vs-contiguous bitwise parity gate.

    Returns ``continuous`` / ``static`` metric blocks (p50/p99 latency,
    TTFT, sustained tok/s) and ``parity_max_abs_diff``, which must be 0.0:
    the paged pool is a copy-exact rearrangement of the contiguous cache
    (see serving/paged_kv.py).  Raises if it is not.  The report also
    carries the paged replay's tokens, the kernel launches and
    collectives it made, and the pools' resident bytes (with ``mesh``
    beside the dry run's `shard_bytes` under `paged_pool_specs`) and, on
    a mesh, the replay's logits (``replay_logits``: request id -> one row
    a step, numpy) and the continuous run's tick log.

    ``mesh``: a live mesh, ``bundle`` built on it and ``serve_params``
    placed on it.  Both engines' pools are then placed on it (the
    reference's ``mesh=``), every rank runs this function alike and the
    loops run by rank 0's clock (`serving.traffic.Clock`).
    """
    from ..serving import contiguous_engine
    from ..serving import paged_kv
    from ..serving import traffic as tr
    from .dryrun import shard_bytes, tree_bytes
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    sc = traffic_scenario(cfg, args)
    reqs, arrivals, slots = sc["reqs"], sc["arrivals"], sc["slots"]
    prompt_lens, max_len, n_par = sc["prompt_lens"], sc["max_len"], \
        sc["n_par"]

    shared_steps: dict = {}      # step functions shared across paged engines

    def paged(**kw):
        return paged_engine(bundle, serve_params, sc, args, mesh=mesh,
                            step_cache=shared_steps, **kw)

    # -- parity gate: replay a slice through both cache structures ---------
    diff = 0.0
    traces, pools = {}, {}
    for mk in ("paged", "contig"):
        eng = paged(record_logits=True) if mk == "paged" else \
            contiguous_engine(bundle, serve_params, max_slots=slots,
                              max_len=max_len,
                              prefill_chunk=args.prefill_chunk, mesh=mesh,
                              record_logits=True)
        if mk == "paged":
            _sync(bundle.device)
            before = (_launch_counts(), shd.COLLECTIVES.snapshot())
            t0 = time.monotonic()
            replay_tokens = replay(eng, sc)
            _sync(bundle.device)
            replay_s = time.monotonic() - t0
            replay_launches = _counts_since(before[0], _launch_counts())
            replay_coll = _collectives_since(before[1],
                                             shd.COLLECTIVES.snapshot())
        else:
            replay(eng, sc)
        traces[mk] = eng.logits_trace
        pools[mk] = {"resident": tree_bytes(eng.pool)}
        if mesh is not None:
            num_pages = eng.pool_planes // eng.kh
            whole = paged_kv.init_pool(cfg.n_layers, num_pages, eng.kh,
                                       eng.page_size, cfg.head_dim,
                                       device="meta")
            pools[mk]["shard_bytes"] = shard_bytes(
                mesh, whole, paged_kv.paged_pool_specs(mesh, num_pages,
                                                       eng.kh))
            pools[mk]["planes"] = list(paged_kv.plane_block(
                mesh, eng.pool_planes))
    for rid, rows in traces["paged"].items():
        ref = traces["contig"][rid]
        if len(rows) != len(ref):
            raise AssertionError(f"rid {rid} step count diverged")
        diff = max(diff, max(float(np.max(np.abs(a - b)))
                             for a, b in zip(rows, ref)))
    if diff != 0.0:
        raise AssertionError(f"paged KV diverged from the contiguous cache: "
                             f"max|dlogit|={diff}")
    say(f"[serve/traffic] paged-vs-contiguous parity over {n_par} "
        f"requests: max |dlogit| = {diff} (gate: exact)")

    # -- equal-load A/B: continuous runtime vs the static batch loop -------
    # both sides warm up off the timed path: the engine runs every (batch
    # bucket, chunk width) step, the static loop a prefill and a decode
    # step per prompt length
    eng = paged()
    n_fns = eng.warmup(chunk_widths=sc["widths"])
    say(f"[serve/traffic] warmed {n_fns} step fns "
        f"(buckets x chunk widths {sorted(sc['widths'])})")
    with torch.no_grad():
        for p in prompt_lens:
            wtoks = torch.zeros((slots, p), dtype=torch.long,
                                device=bundle.device)
            _, pfc = bundle.prefill(serve_params, {"tokens": wtoks})
            cache = merge_prefill_cache(bundle.init_cache(slots, max_len),
                                        pfc)
            lg, _ = bundle.decode_step(
                serve_params, {"tokens": wtoks[:, :1],
                               "cache_len": torch.full(
                                   (slots,), p, dtype=torch.long,
                                   device=bundle.device)}, cache)
            lg.cpu()
    cont = tr.run_continuous(eng, reqs, arrivals)
    static = tr.run_static(bundle, serve_params, reqs, arrivals,
                           batch=slots, max_len=max_len, mesh=mesh)
    for name, m in (("continuous", cont), ("static", static)):
        say(f"[serve/traffic/{name}] {m['sustained_tok_per_s']:.1f} tok/s "
            f"sustained; latency p50={m['latency_s']['p50']:.3f}s "
            f"p99={m['latency_s']['p99']:.3f}s; "
            f"ttft p50={m['ttft_s']['p50']:.3f}s "
            f"p99={m['ttft_s']['p99']:.3f}s")
    on_mesh = {} if mesh is None else {
        "replay_logits": {rid: np.stack(rows)
                          for rid, rows in traces["paged"].items()},
        "ticks": eng.ticks}
    return {"scenario": {"requests": args.requests, "rate_per_s": args.rate,
                         "seed": args.seed, "prompt_lens": list(prompt_lens),
                         "gen_steps": list(sc["gen_steps"]),
                         "page_size": sc["page_size"],
                         "slots": slots, "prefill_chunk": args.prefill_chunk,
                         "max_len": max_len},
            "parity_max_abs_diff": diff, "parity_requests": n_par,
            "replay_tokens": replay_tokens, "replay_s": replay_s,
            "replay_launches": replay_launches,
            "replay_collectives": replay_coll, "pool_bytes": pools,
            **on_mesh, "continuous": cont, "static": static,
            "speedup_sustained": cont["sustained_tok_per_s"]
            / max(static["sustained_tok_per_s"], 1e-9)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="olmo-1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-steps", type=int, default=32)
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--impl", choices=["auto", "cuda", "xla", "xla_gather"],
                    default="auto",
                    help="force the sparse kernel impl (auto: the CUDA "
                         "kernels on a GPU, the eager xla densify+matmul "
                         "on the CPU)")
    ap.add_argument("--quant", choices=QUANT_MODES,
                    default="none",
                    help="block-quantize the sparse encodings: int8 or "
                         "nibble-packed int4 values with one f32 scale per "
                         "(row, column block), dequantized on chip")
    ap.add_argument("--attn-only", action="store_true",
                    help="plan only the attention projections, not the MLP "
                         "or the experts (transformer families)")
    ap.add_argument("--tune", choices=["off", "cached", "sweep"],
                    default="off",
                    help="block-choice policy (kernels.autotune): 'cached' "
                         "uses warm measured winners and falls back to the "
                         "static model, 'sweep' times the candidates of a "
                         "missing key on the device and persists the winner")
    ap.add_argument("--tune-cache", default=None,
                    help="autotune cache path (default "
                         "~/.cache/repro_torch/autotune.json or "
                         "$REPRO_TORCH_AUTOTUNE_CACHE)")
    ap.add_argument("--guard", action="store_true",
                    help="guarded execution (engine.guard): validate the "
                         "plan, probe every layer down the impl ladder, and "
                         "run one untimed guarded pass whose NaN trip "
                         "bisects to the poisoned layer and quarantines it "
                         "to dense")
    ap.add_argument("--inject-nan", action="store_true",
                    help="fault injection: poison one planned layer's "
                         "values with NaN after the parity reference is "
                         "built (only under --guard)")
    ap.add_argument("--objective", choices=list(cost_model.OBJECTIVES),
                    default="latency",
                    help="plan objective (launch.cost_model): 'latency' "
                         "keeps the paper's rules and only annotates the "
                         "cost; 'dram' / 'energy' / 'balanced' co-optimize "
                         "the dataflow mode and impl for --deployment")
    ap.add_argument("--deployment", choices=sorted(cost_model.DEPLOYMENTS),
                    default=None,
                    help="the modeled deployment profile the objective is "
                         "evaluated against (default zcu102)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's); the widths stay as published")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--report", default=None,
                    help="write the serve report to this JSON file")
    ap.add_argument("--traffic", action="store_true",
                    help="continuous-batching serving under a seeded "
                         "Poisson arrival scenario (serving/): paged-KV "
                         "runtime vs the static batch loop at equal load, "
                         "plus the paged-vs-contiguous exact parity gate")
    ap.add_argument("--requests", type=int, default=12,
                    help="traffic: number of requests in the scenario")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="traffic: Poisson arrival rate (req/s)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="traffic: KV pool page size (tokens per page)")
    ap.add_argument("--slots", type=int, default=4,
                    help="traffic: live-request slots (max batch)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="traffic: prompt tokens cached per prefill tick")
    ap.add_argument("--seed", type=int, default=0,
                    help="traffic: scenario seed (arrivals + shapes)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a live mesh of torch.distributed ranks, "
                         "e.g. data=2,model=2 (the axes in order, each "
                         "name=size)")
    ap.add_argument("--dist-init", default=None,
                    help="the ranks' rendezvous with --mesh: file://PATH "
                         "(a path that does not exist yet) or "
                         "tcp://HOST:PORT")
    return ap


def config(args: argparse.Namespace):
    """The model config the arguments name: the published or smoke
    config with sparse serving on, depth cut to ``--n-layers``."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, sparse_serving=True)
    if args.n_layers is not None:
        if not 0 < args.n_layers <= cfg.n_layers:
            raise ValueError(f"--n-layers must be in [1, {cfg.n_layers}]")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.inject_nan and not args.guard:
        ap.error("--inject-nan poisons the serving path by design; it is "
                 "only meaningful (and only safe) under --guard")
    cfg = config(args)
    if args.mesh is not None:
        refused = [f for f, on in (("--guard", args.guard),
                                   ("--tune", args.tune != "off")) if on]
        if refused:
            ap.error(f"--mesh serves the greedy path and --traffic; "
                     f"{refused} take no mesh (the reference's guard and "
                     f"autotuner run on one device)")
        if args.dist_init is None:
            ap.error("--mesh needs --dist-init (file://PATH or "
                     "tcp://HOST:PORT)")
    if args.traffic and cfg.family not in TRANSFORMER_FAMILIES:
        ap.error(f"--traffic serves the transformer families "
                 f"{TRANSFORMER_FAMILIES}; {cfg.family} has O(1) recurrent "
                 "state (nothing to page)")
    return run(args, cfg)


def _launch_counts() -> dict:
    return {**balanced_spmm.LAUNCHES, **kv_cache_update.LAUNCHES}


def _plan_kwargs(args: argparse.Namespace, cfg) -> dict:
    """`engine.plan.plan_model`'s arguments as the parsed ones say."""
    kw = dict(sparsity=args.sparsity,
              impl=None if args.impl == "auto" else args.impl,
              m_hint=args.batch * args.prompt_len,
              tune=args.tune, tune_cache=args.tune_cache,
              quant=args.quant, objective=args.objective,
              deployment=args.deployment)
    if cfg.family in TRANSFORMER_FAMILIES:
        kw["include_mlp"] = not args.attn_only
    return kw


def _prompt(args: argparse.Namespace, cfg, device) -> torch.Tensor:
    gen = torch.Generator().manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen).to(device)


# ---------------------------------------------------------------------------
# --mesh: the sharded serve program on live ranks
# ---------------------------------------------------------------------------

def place_rank(mesh, device: torch.device, args: argparse.Namespace,
               cfg) -> tuple:
    """A rank's set-up of ``--mesh``: ``(bundle, params with the placed
    plan under "sparse_plan", the dry run's `shard_bytes` of its params
    and plan, the set-up report)``.  In its turn (`in_turns`) a rank
    makes the params from the seed and builds the plan whole, and places
    both."""
    from .dryrun import shard_bytes
    bundle = build_model(cfg, device, mesh=mesh)
    pspecs = bundle.param_specs()

    def make():
        whole = build_model(cfg, device).init(0)
        plan = engine_plan.plan_model(cfg, whole, **_plan_kwargs(args, cfg))
        want = {"params": shard_bytes(mesh, whole, pspecs)}
        pl_specs = engine_plan.plan_specs(plan, mesh)
        want["plan"] = sum(shard_bytes(
            mesh, engine_plan.weight_leaves(lp.weights),
            engine_plan.weight_leaves(pl_specs.layers[nm].weights))
            for nm, lp in plan.layers.items())
        params = shd.place_tree(whole, shd.tree_shardings(mesh, pspecs))
        params["sparse_plan"] = engine_plan.shard_plan(plan, mesh)
        return params, want
    (params, want), setup = in_turns(mesh, device, make)
    return bundle, params, want, setup


def _serve_rank(rank: int, world_size: int, init_method: str,
                args: argparse.Namespace, cfg) -> dict:
    """One rank of ``--mesh`` (`rank_mesh`), set up by `place_rank`.
    Then it times the greedy path (its tokens, the logits they were
    chosen from and, for the MoE family, the experts it routed) with this
    rank's counts zeroed just before (`zero_counts`) and read just
    after.  Returns the rank's report (numpy for the tensors)."""
    from .dryrun import cache_shapes, shard_bytes, tree_bytes
    with rank_mesh(rank, world_size, init_method, args) as (mesh, device):
        bundle, sparams, want, setup = place_rank(mesh, device, args, cfg)
        prompt = _prompt(args, cfg, device)
        max_len = args.prompt_len + args.gen_steps
        cache = bundle.init_cache(args.batch, max_len)
        want["cache"] = shard_bytes(mesh,
                                    cache_shapes(cfg, args.batch, max_len),
                                    bundle.cache_specs(args.batch))
        resident = {"params": tree_bytes({k: v for k, v in sparams.items()
                                          if k != "sparse_plan"}),
                    "plan": sum(tree_bytes(engine_plan.weight_leaves(
                        lp.weights))
                        for lp in sparams["sparse_plan"].layers.values()),
                    "cache": tree_bytes(cache)}
        del cache
        expert_block = None
        if cfg.family == "moe":
            e0, el = shd.block_of(
                mesh, shd.spec_axes(
                    bundle.param_specs()["blocks"]["we_gate"][1]),
                cfg.n_experts)
            expert_block = [e0, e0 + el]
        zero_counts(device)
        t0 = time.monotonic()
        logits = []
        with transformer.record_routes() as routes:
            toks = greedy_generate(bundle, sparams, prompt, args.gen_steps,
                                   max_len, logits)
        _sync(device)
        wall = time.monotonic() - t0
        return {"rank": rank, "coord": mesh.coord(),
                "collectives": shd.COLLECTIVES.snapshot(),
                "kernel_launches": _launch_counts(),
                "expert_block": expert_block,
                "experts_per_dispatch": dict(engine_execute.EXPERT_BLOCKS),
                "peak_gib": peak_gib(device),
                **setup, "wall_s": wall, "resident_bytes": resident,
                "shard_bytes": want, "tokens": toks.cpu().numpy(),
                "logits": torch.stack(logits).float().cpu().numpy(),
                "routes": [r.cpu().numpy() for r in routes]}


def one_process(args: argparse.Namespace, cfg) -> tuple:
    """``(greedy tokens, the logits they were chosen from, the experts
    each MoE dispatch routed)`` of one process serving the same params,
    plan and prompt as ``--mesh`` does (the yardstick of its ranks)."""
    device = resolve_device(args.device)
    bundle = build_model(cfg, device)
    params = bundle.init(0)
    plan = engine_plan.plan_model(cfg, params, **_plan_kwargs(args, cfg))
    sparams = {**params, "sparse_plan": plan}
    prompt = _prompt(args, cfg, device)
    logits = []
    with transformer.record_routes() as routes:
        toks = greedy_generate(bundle, sparams, prompt, args.gen_steps,
                               args.prompt_len + args.gen_steps, logits)
    return (toks.cpu().numpy(), torch.stack(logits).float().cpu().numpy(),
            [r.cpu().numpy() for r in routes])


def _mesh_verdict(args: argparse.Namespace, report: dict, ok: bool,
                  what: str) -> dict:
    """Raise with ``report`` unless ``ok``; else write it to ``--report``
    (if given) and return it under ``mesh``."""
    if not ok:
        raise AssertionError(f"the {what} differs from one process or from "
                             f"its shard bytes: "
                             f"{json.dumps(report, default=str)}")
    if args.report:
        out = pathlib.Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"mesh": report}, indent=1, default=str)
                       + "\n")
    return {"mesh": report}


def run_mesh(args: argparse.Namespace, cfg) -> dict:
    """``--mesh``: `one_process`, then the ranks' greedy path
    (`_serve_rank`), by `against_one_process`; raises unless every
    rank's tokens equal the one-process run's, the logits each step chose
    from (the prefill's and every decode step's) lie within the parity
    tolerance and every rank's resident bytes equal its
    `launch.dryrun.shard_bytes`."""
    (ref_toks, ref_logits, ref_routes), ranks, head = \
        against_one_process(args, cfg, one_process, _serve_rank)
    tol = head["parity_tol"]
    step_err = np.max([np.abs(r["logits"] - ref_logits).max(axis=(1, 2))
                       for r in ranks], axis=0)
    tokens_equal = all(np.array_equal(r["tokens"], ref_toks) for r in ranks)
    bytes_equal = all(r["resident_bytes"] == r["shard_bytes"]
                      for r in ranks)
    per_rank = [{k: v for k, v in r.items()
                 if k not in ("tokens", "logits", "routes")}
                for r in ranks]
    for r, full in zip(per_rank, ranks):
        r["routing_agreement"] = routing_agreement(full["routes"],
                                                   ref_routes)
    setup_card = max((r["setup_card_gib"] for r in per_rank
                      if r["setup_card_gib"] is not None), default=None)
    for r in per_rank:
        moe = "" if r["expert_block"] is None else (
            f", experts {r['expert_block']} (experts a batched dispatch: "
            f"{r['experts_per_dispatch']}), routing agreement with one "
            f"process {r['routing_agreement']:.6f}")
        print(f"[serve/mesh] rank {r['rank']} {r['coord']}: resident "
              f"{r['resident_bytes']} B (shard_bytes {r['shard_bytes']}), "
              f"launches {r['kernel_launches']}, collectives "
              f"{r['collectives']}, peak {r['peak_gib']} GiB (set-up "
              f"{r['setup_peak_gib']} GiB, the card {r['setup_card_gib']} "
              f"GiB), set-up {r['setup_s']:.2f} s of "
              f"{r['setup_wall_s']:.2f} s in turns of "
              f"{r['setup_turns']} ranks, greedy "
              f"{r['wall_s']:.3f} s{moe}")
    print(f"[serve/mesh] {cfg.name} on {head['mesh']} over gloo "
          f"({head['device']}): tokens equal to one process "
          f"{tokens_equal}, logits max |diff| prefill {step_err[0]:.3g}, "
          f"decode steps {float(step_err[1:].max(initial=0.0)):.3g} (tol "
          f"{tol:g}), resident bytes equal to shard_bytes {bytes_equal}"
          + ("" if not ref_routes else ", routing agreement with one "
             f"process {min(r['routing_agreement'] for r in per_rank):.6f}")
          + ("" if setup_card is None else
             f", the card's peak in set-up {setup_card:.2f} GiB")
          + f"; ranks {head['ranks_s']:.1f} s")
    report = {**head, "tokens": ranks[0]["tokens"].tolist(),
              "one_process_tokens": ref_toks.tolist(),
              "logits_max_abs_diff": float(step_err[0]),
              "step_logits_max_abs_diff": [float(e) for e in step_err],
              "tokens_equal": tokens_equal, "bytes_equal": bytes_equal,
              "routing_agreement": None if not ref_routes else min(
                  r["routing_agreement"] for r in per_rank),
              "setup_card_peak_gib": setup_card, "ranks": per_rank}
    return _mesh_verdict(args, report, tokens_equal
                         and float(step_err.max()) <= tol and bytes_equal,
                         "mesh run")


def _traffic_rank(rank: int, world_size: int, init_method: str,
                  args: argparse.Namespace, cfg) -> dict:
    """One rank of ``--traffic --mesh`` (`rank_mesh`), set up by
    `place_rank`: `traffic_mode` on the live mesh, this rank's counts
    zeroed just before (`zero_counts`) and read just after.  Returns the
    rank's report: the traffic report, its whole run's launches and
    collectives, its peak memory and wall."""
    with rank_mesh(rank, world_size, init_method, args) as (mesh, device):
        bundle, sparams, _, setup = place_rank(mesh, device, args, cfg)
        zero_counts(device)
        t0 = time.monotonic()
        res = traffic_mode(bundle, sparams, cfg, args, mesh=mesh)
        _sync(device)
        return {"rank": rank, "coord": mesh.coord(), "traffic": res,
                "kernel_launches": _launch_counts(),
                "collectives": shd.COLLECTIVES.snapshot(),
                "peak_gib": peak_gib(device), **setup,
                "wall_s": time.monotonic() - t0}


def one_process_replay(args: argparse.Namespace, cfg) -> tuple:
    """``(tokens, logits, kernel launches)`` of `traffic_mode`'s paged
    replay in one process serving the same params and plan as ``--traffic
    --mesh`` does (the yardstick of its ranks)."""
    device = resolve_device(args.device)
    bundle = build_model(cfg, device)
    params = bundle.init(0)
    plan = engine_plan.plan_model(cfg, params, **_plan_kwargs(args, cfg))
    sc = traffic_scenario(cfg, args)
    eng = paged_engine(bundle, {**params, "sparse_plan": plan}, sc, args,
                       record_logits=True)
    _sync(device)
    before = _launch_counts()
    tokens = replay(eng, sc)
    _sync(device)
    return (tokens, {rid: np.stack(rows)
                     for rid, rows in eng.logits_trace.items()},
            _counts_since(before, _launch_counts()))


def run_traffic_mesh(args: argparse.Namespace, cfg) -> dict:
    """``--traffic --mesh``: `one_process_replay`, then `traffic_mode` on
    every rank (`_traffic_rank`), by `against_one_process`; raises
    unless on every rank the paged replay equals the contiguous one
    exactly (`traffic_mode` raises otherwise), its tokens equal the
    one-process replay's, the logits of every step lie within the parity
    tolerance of its, both pools' resident bytes equal the dry run's
    `shard_bytes` under `serving.paged_kv.paged_pool_specs`, its replay's
    kernel launches equal the one-process replay's, and every rank's
    continuous run ticked as rank 0's did.  Continuous batching is not
    gated against the static loop here (as in the reference's
    `traffic_mode`)."""
    (ref_toks, ref_logits, ref_launches), ranks, head = \
        against_one_process(args, cfg, one_process_replay,
                                  _traffic_rank)
    tol = head["parity_tol"]
    ts = [r["traffic"] for r in ranks]
    step_err = max(float(np.abs(t["replay_logits"][rid] - want).max())
                   if t["replay_logits"][rid].shape == want.shape
                   else math.inf
                   for t in ts for rid, want in ref_logits.items())
    tokens_equal = all(t["replay_tokens"] == ref_toks for t in ts)
    bytes_equal = all(p["resident"] == p["shard_bytes"]
                      for t in ts for p in t["pool_bytes"].values())
    launches_equal = all(t["replay_launches"] == ref_launches for t in ts)
    # the continuous run's ticks (rank 0's clock, kinds, requests, shapes)
    lock_step = all(t["ticks"] == ts[0]["ticks"] for t in ts)
    parity = max(t["parity_max_abs_diff"] for t in ts)
    per_rank = []
    for r, t in zip(ranks, ts):
        per_rank.append({
            **{k: v for k, v in r.items() if k != "traffic"},
            **{k: t[k] for k in ("parity_max_abs_diff", "replay_launches",
                                 "replay_collectives", "replay_s",
                                 "pool_bytes", "ticks")}})
        ex = t["replay_collectives"].get("all_to_all", {})
        print(f"[serve/traffic-mesh] rank {r['rank']} {r['coord']}: paged "
              f"vs contiguous {t['parity_max_abs_diff']}, pool planes "
              f"{t['pool_bytes']['paged']['planes']}, pools "
              f"{t['pool_bytes']} B, replay launches "
              f"{t['replay_launches']}, replay exchange "
              f"{ex.get('ops', 0)} ops {ex.get('bytes', 0)} B, collectives "
              f"{r['collectives']}, peak {r['peak_gib']} GiB (set-up "
              f"{r['setup_peak_gib']} GiB), set-up {r['setup_s']:.2f} s, "
              f"replay {t['replay_s']:.2f} s, traffic {r['wall_s']:.2f} s")
    cont, static = ts[0]["continuous"], ts[0]["static"]
    print(f"[serve/traffic-mesh] {cfg.name} on {head['mesh']} over gloo "
          f"({head['device']}): paged vs contiguous {parity} on every "
          f"rank, replay tokens equal to one process {tokens_equal}, "
          f"logits max |diff| {step_err:.3g} (tol {tol:g}), pool bytes "
          f"equal to shard_bytes {bytes_equal}, replay launches equal to "
          f"one process {launches_equal} ({ref_launches}), every rank's "
          f"ticks equal to rank 0's {lock_step}; rank 0 "
          f"continuous {cont['sustained_tok_per_s']:.2f} tok/s, static "
          f"{static['sustained_tok_per_s']:.2f} tok/s; ranks "
          f"{head['ranks_s']:.1f} s")
    report = {**head, "mode": "traffic", "scenario": ts[0]["scenario"],
              "parity_max_abs_diff": parity,
              "replay_tokens": ref_toks, "tokens_equal": tokens_equal,
              "logits_max_abs_diff": step_err, "bytes_equal": bytes_equal,
              "launches_equal": launches_equal, "lock_step": lock_step,
              "one_process_launches": ref_launches,
              "continuous": cont, "static": static, "ranks": per_rank}
    return _mesh_verdict(args, report, parity == 0.0 and tokens_equal
                         and step_err <= tol and bytes_equal
                         and launches_equal and lock_step,
                         "traffic mesh run")


def run(args: argparse.Namespace, cfg) -> dict:
    """Serve ``cfg`` as the parsed arguments say (`main` with a config it
    does not build itself, e.g. ``cache_update="scatter"``), under
    `exact_matmuls`."""
    with exact_matmuls():
        if args.mesh is not None:
            if resolve_device(args.device).type == "cuda":
                from ..kernels import _build
                _build.build()      # once here, not in every rank
            return (run_traffic_mesh if args.traffic else run_mesh)(args,
                                                                    cfg)
        return _serve_one(args, cfg)


def _serve_one(args: argparse.Namespace, cfg) -> dict:
    """`run` on one device."""
    device = resolve_device(args.device)
    bundle = build_model(cfg, device)
    params = bundle.init(0)
    prompt = _prompt(args, cfg, device)
    max_len = args.prompt_len + args.gen_steps

    # ---- the offline pass: build the plan once, serve from it ------------
    plan_kwargs = _plan_kwargs(args, cfg)
    if cfg.family not in TRANSFORMER_FAMILIES and args.attn_only:
        print(f"[serve] --attn-only is inapplicable to family {cfg.family} "
              "(no separate attention projections are planned); planning "
              "the full projection family")
    _sync(device)
    t0 = time.monotonic()
    plan = engine_plan.plan_model(cfg, params, **plan_kwargs)
    _sync(device)
    plan_s = time.monotonic() - t0
    print(f"[serve] {cfg.name} (family {cfg.family}, quant {args.quant}) on "
          f"{device}: layer plan "
          f"({len(plan.layers)} projection groups x {cfg.n_layers} layers) "
          f"built in {plan_s:.2f} s:")
    print(plan.summary())
    if args.tune != "off":
        deltas = plan.tune_deltas()
        print(f"[serve] tune={args.tune}: block sources {plan.tuned_mix()}; "
              f"{len(deltas)} tuned choice(s) differ from the static model"
              + "".join(f"\n[serve]   {nm}: tuned (bm,bo,bn)={t} "
                        f"static={st}" for nm, t, st in deltas))
    if plan.sparse_layer_count == 0:
        raise RuntimeError("plan produced no sparse-kernel layers — "
                           "sparsity below the §VI-F thresholds?")

    # ---- guarded execution: validate + harden before anything else runs --
    guard_report = None
    if args.guard:
        from ..engine import guard as engine_guard
        _sync(device)
        t0 = time.monotonic()
        before = _launch_counts()
        report = engine_guard.validate_plan(plan, strict=True)
        plan, degradations = engine_guard.harden_plan(plan)
        guard_report = {"validated_layers": len(report.layers),
                        "degradations": [dataclasses.asdict(d)
                                         for d in degradations],
                        "events": []}
        print(f"[serve/guard] {report.summary()}; ladder: "
              f"{len(degradations)} event(s)")
        for d in degradations:
            print(f"[serve/guard] ladder: {d.layer} {d.from_impl} -> "
                  f"{d.to_impl} ({d.action}: {d.reason})")
    sparse_params = {**params, "sparse_plan": plan}
    ref_params = engine_plan.masked_dense_params(params, plan)

    # ---- the guarded serving pass (untimed; NaN bisection + quarantine) --
    if args.guard:
        if args.inject_nan:
            from ..testing import faults
            plan, poisoned_name = faults.inject_nan_output(plan)
            print(f"[serve/guard] fault injection: poisoned layer "
                  f"{poisoned_name!r} values with NaN")
            guard_report["injected"] = poisoned_name
        toks, plan, events = guarded_generate(
            bundle, plan, params, prompt, 2, max_len,
            ref_blocks=ref_params["blocks"])
        _sync(device)
        guard_report["events"] = events
        guard_report["quarantined"] = list(plan.quarantined())
        # the pass returned: every logit of it was finite
        guard_report["sample"] = toks[0].tolist()
        guard_report["seconds"] = time.monotonic() - t0
        after = _launch_counts()
        guard_report["kernel_launches"] = {k: after[k] - before[k]
                                           for k in after}
        sparse_params = {**params, "sparse_plan": plan}
        if plan.degraded_mix() or plan.quarantined():
            print(f"[serve/guard] serving a degraded mix: "
                  f"{plan.degraded_mix()}; quarantined "
                  f"{list(plan.quarantined())}")

    # ---- correctness: sparse plan == masked dense, on the kernel path -----
    # a quantized plan is held against its dequantized masked-dense
    # reference (`masked_dense_params` densifies through the scales), so
    # the gate measures round-off, not the quantization error; the wider
    # tol is the reference's for quantized plans
    tol = 1e-4 if cfg.compute_dtype == "float32" else 2e-2
    if args.quant != "none":
        tol = max(tol, 5e-2)
    engine_execute.reset_stats()
    parity = _parity_check(bundle, sparse_params, ref_params, prompt,
                           tol=tol)
    stats = engine_execute.stats()
    if stats.get("balanced_spmm", 0) == 0:
        raise RuntimeError(f"balanced_spmm never dispatched — the sparse "
                           f"path is a no-op ({stats})")
    if any(lp.spec.experts and lp.spec.is_sparse
           for lp in plan.layers.values()) \
            and stats.get("expert_balanced_spmm", 0) == 0:
        raise RuntimeError(f"MoE expert layers never hit the per-expert "
                           f"path ({stats})")
    routing = "" if "routing_agreement" not in parity else \
        f", own routing agrees on {parity['routing_agreement']:.4f} of " \
        f"(token, k) choices"
    print(f"[serve] parity sparse vs masked-dense (tol {tol:g}): sublayer "
          f"gate excess {parity['layer_gate_excess']:.3g} (closest "
          f"{parity['layer_gate_closest']}), block outputs' max |diff| = "
          f"{parity['layer_max_abs_diff']:.2e}, max |dlogit| = "
          f"{parity['logits_max_abs_diff']:.2e}, argmax equal "
          f"{parity['argmax_equal']}{routing};  engine dispatches: {stats}")

    # ---- throughput (warm-up first; clocks read after a synchronize) -----
    results: dict = {}
    if args.traffic:
        # the continuous-batching runtime (serving/) under Poisson load,
        # served from the plan-carrying params
        results["traffic"] = traffic_mode(bundle, sparse_params, cfg, args)
    for mode, p in () if args.traffic else (("dense", params),
                                            ("sparse", sparse_params)):
        greedy_generate(bundle, p, prompt, 1, max_len)
        _sync(device)
        t0 = time.monotonic()
        toks = greedy_generate(bundle, p, prompt, args.gen_steps, max_len)
        _sync(device)
        dt = time.monotonic() - t0
        tps = args.batch * args.gen_steps / dt
        results[mode] = {"tokens_per_s": tps, "wall_s": dt,
                         "sample": toks[0, :8].tolist()}
        print(f"[serve/{mode}] {tps:.1f} tok/s ({dt:.3f} s for "
              f"{args.gen_steps} steps x batch {args.batch})")
    launches = _launch_counts()
    reached = kernels_reached(plan, args.batch * args.prompt_len, args.batch)
    if cfg.cache_update == "scatter":
        reached.add("kv_cache_update")
    reached = sorted(reached)
    if device.type == "cuda":
        missing = [k for k in reached if launches[k] == 0]
        if missing:
            raise RuntimeError(f"kernels never launched on the main path: "
                               f"{missing} ({launches})")
    print(f"[serve] kernel launches: {launches}")

    # ---- storage: bitmap model (Fig.8) and the stored tile encodings -----
    total_numel = total_nnz = enc_bytes = live_bytes = 0
    for lp in plan.layers.values():
        s = lp.spec
        # each projection repeats per layer, and per expert for the experts
        mult = cfg.n_layers * max(s.experts, 1)
        total_numel += s.n_in * s.n_out * mult
        total_nnz += s.k * s.n_out * mult
        enc_bytes += lp.nbytes()
        # what a decode step must read of this projection's weights
        live_bytes += lp.weights.live_nbytes() \
            if isinstance(lp.weights, TiledBalanced) else lp.nbytes()
    itemsize = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                           ).element_size()
    dense_bytes = total_numel * itemsize
    comp_bits = compressed_bits(total_numel, total_nnz, elem_bits=16)
    print(f"[serve] planned weight sparsity "
          f"{1 - total_nnz / max(total_numel, 1):.2f}, bitmap compression "
          f"{total_numel * 16 / comp_bits:.2f}x; stored encodings "
          f"{enc_bytes / 1e6:.1f} MB vs dense {cfg.compute_dtype} "
          f"{dense_bytes / 1e6:.1f} MB;  mode mix {plan.mode_mix()}  "
          f"impl mix {plan.impl_mix()}")
    cost = plan.cost_summary()
    print(f"[serve/cost] objective={cost['objective']} "
          f"deployment={cost['deployment'] or 'zcu102'} (a modeled "
          f"profile): DRAM {cost['total_dram_bytes'] / 1e6:.2f} MB, energy "
          f"{cost['total_energy_pj'] / 1e9:.3f} mJ, weight stream "
          f"{cost['total_w_stream_bytes'] / 1e6:.2f} MB "
          f"(modes {cost['modes']})")
    results["plan"] = {
        "model": cfg.name, "family": cfg.family, "n_layers": cfg.n_layers,
        "quant": args.quant,
        "device": str(device), "plan_build_s": plan_s,
        "mode_mix": plan.mode_mix(), "impl_mix": plan.impl_mix(),
        "sparse_layers": plan.sparse_layer_count,
        "block_k": {nm: lp.spec.block_k for nm, lp in plan.layers.items()},
        "packed": {nm: lp.spec.packed for nm, lp in plan.layers.items()},
        "parity": parity, "parity_tol": tol,
        "engine_stats": stats, "kernel_launches": launches,
        "kernels_reached": reached,
        "encoded_bytes": enc_bytes, "dense_bytes": dense_bytes,
        "step_weight_bytes": live_bytes,
        "blocks": {nm: None if lp.spec.blocks is None else
                   [lp.spec.blocks.bm, lp.spec.blocks.bo, lp.spec.blocks.bn]
                   for nm, lp in plan.layers.items()},
        "tune": {"mode": args.tune, "sources": plan.tuned_mix(),
                 "deltas": [[nm, list(t), list(st)]
                            for nm, t, st in plan.tune_deltas()]},
        "cost": cost,
    }
    if guard_report is not None:
        guard_report["degraded_mix"] = plan.degraded_mix()
        results["guard"] = guard_report
    if args.report:
        out = pathlib.Path(args.report)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1, default=str) + "\n")
        print(f"[serve] report -> {out}")
    return results


if __name__ == "__main__":
    main()
