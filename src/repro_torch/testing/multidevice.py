"""Rank functions of the multi-device tests (`tests/test_torch_multidevice.py`,
`test_torch_moe_mesh.py`, `test_torch_family_mesh.py`): each runs in a process of its own under `launch.ranks.run_ranks`, which
needs it importable by its module path, and returns numpy arrays (a
bf16 tensor as its int16 bits, so shards compare bit for bit).

* `mesh_case` — one smoke model (dense or MoE) on a live mesh over
  ``gloo`` on the CPU: every placed shard (params, plan leaves, a
  one-process prefill's cache) with its `shard_shape`, whether every
  gathered plan encoding equals the unsharded one (an expert layer: the
  rank's block of its experts), the sharded prefill's logits, cache,
  `COLLECTIVES` and the experts each batched dispatch ran, the greedy
  tokens, and the prefill logits without a plan;
* `prefill_cases` — several smoke configs' sharded prefill and one
  decode step on one live mesh, each with its plan or without;
* `family_cases` — several smoke models of any family on one live mesh:
  shards, prefill logits with the plan and without, collectives, the
  seeded decode cache beside the one-process one, greedy tokens and a
  prefill with frontend rows;
* `frontend_prefill` — one planned prefill with frontend rows
  (`frontend_batch`) of a model at any width, its ranks set up by
  ``serve --mesh``'s own set-up (the GPU smoke's family-mesh phase runs
  it on the card);

`prefill_cases` takes the MoE segment length
(``models.transformer._MOE_SEG``) with each case: a spawned rank imports
the module afresh, so a test's monkeypatch does not reach it.
* `traffic_cases` — the continuous-batching engine (`serving/`) of
  several smoke configs on one live mesh, its pool placed by
  `paged_pool_specs`: tokens, logits, the contiguous twin's parity, the
  rank's pool block, a poisoned request's quarantine and a run whose one
  rank starts late (the tick log);
* `train_cases` — the sharded train step (`runtime.grad_step` and
  `optim.adamw_update` on the mesh) of several smoke configs on one live
  mesh: per step the loss, the grad norm, every leaf's gradient block
  and whether the replicated blocks equal the other ranks' bit for bit;
  the last step's `COLLECTIVES`;
  the params, ``m`` and ``v`` blocks after the last step; the resident
  bytes beside `launch.train.mesh_bytes`;
* `adjoint_cases` — each differentiable collective of
  `distributed.sharding` (gathers over some axes and over all, two cuts
  in one `gather_tree`, `all_reduce`, `cols` both ways, `embed_rows`) at
  float64: this rank's ``<f(x), dy>`` and ``<x, grad>`` (``grad`` by
  autograd from ``dy``), whose sums over the ranks agree where the
  backward is the forward's adjoint;
* `raise_on` / `hang_on` — one rank raises, or never joins, while the
  others wait for it in the rendezvous; `pid_of` — a rank's process;
* `gloo_cuda_probe` — which ``gloo`` collectives take CUDA tensors (the
  GPU smoke's mesh phase runs it on the card).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..distributed import sharding as shd
from ..engine import execute as engine_execute
from ..engine import plan as engine_plan
from ..launch.mesh import init_mesh
from ..models import build_model, transformer
from ..models.convert import params_from_numpy
from ..tree import flatten_with_paths


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _key(path) -> str:
    return "/".join(str(p) for p in path)


_MOE_SEG = transformer._MOE_SEG       # the module's own, at import


def _set_moe_seg(moe_seg: int | None) -> None:
    transformer._MOE_SEG = _MOE_SEG if moe_seg is None else moe_seg


def _kept_block(t: torch.Tensor, spec, mesh, gathered: set) -> torch.Tensor:
    """This rank's block of the whole ``t`` over the axes of ``spec`` that
    a gather over ``gathered`` keeps split."""
    for i, d in enumerate(spec):
        if d is not None and not set(shd.spec_axes(d)) & gathered:
            start, size = shd.block_of(mesh, d, t.shape[i])
            t = t.narrow(i, start, size)
    return t


def mesh_case(rank: int, world_size: int, init_method: str, axes, sizes,
              cfg, params_np, prompt: np.ndarray, steps: int,
              plan_kwargs: dict) -> dict:
    """See the module docstring; the plan is built on every rank from the
    converted params (`engine.plan.plan_transformer`), then placed."""
    from ..launch.serve import greedy_generate
    mesh = init_mesh(axes, sizes, rank=rank, world_size=world_size,
                     backend="gloo", init_method=init_method, device="cpu")
    try:
        whole = params_from_numpy(params_np, "cpu")
        plan = engine_plan.plan_transformer(cfg, whole, **plan_kwargs)
        bundle = build_model(cfg, "cpu", mesh=mesh)
        pspecs = bundle.param_specs()
        params = shd.place_tree(whole, shd.tree_shardings(mesh, pspecs))
        splan = engine_plan.shard_plan(plan, mesh)
        out: dict = {"coord": mesh.coord(), "params": {}, "plan": {},
                     "shapes": {}}
        for path, t in flatten_with_paths(params):
            out["params"][_key(path)] = _bits(t)
        for path, t in flatten_with_paths(whole):
            spec = pspecs
            for p in path:
                spec = spec[p]
            out["shapes"][_key(path)] = shd.shard_shape(mesh, tuple(t.shape),
                                                        spec)
        specs = engine_plan.plan_specs(plan, mesh)
        for nm, lp in splan.layers.items():
            leaf_specs = engine_plan.weight_leaves(specs.layers[nm].weights)
            whole_leaves = engine_plan.weight_leaves(plan.layers[nm].weights)
            for leaf, t in engine_plan.weight_leaves(lp.weights).items():
                out["plan"][f"{nm}/{leaf}"] = _bits(t)
                out["shapes"][f"{nm}/{leaf}"] = shd.shard_shape(
                    mesh, tuple(whole_leaves[leaf].shape), leaf_specs[leaf])
        out["gathered_equal"] = {}
        out["gathered_shapes"] = {}
        fsdp = set(shd.fsdp_axes(mesh))
        for i in range(cfg.n_layers):
            for nm, lp in splan.per_layer[i].items():
                got = engine_plan.weight_leaves(
                    engine_plan.gather_layer(lp).weights)
                want = engine_plan.weight_leaves(
                    plan.per_layer[i][nm].weights)
                leaf_specs = engine_plan.weight_leaves(lp.placement[1])
                gathered = fsdp if lp.spec.experts else set(mesh.axis_names)
                for leaf, t in want.items():
                    t = _kept_block(t, leaf_specs[leaf], mesh, gathered)
                    out["gathered_shapes"][f"{i}/{nm}/{leaf}"] = tuple(
                        got[leaf].shape)
                    out["gathered_equal"][f"{i}/{nm}/{leaf}"] = bool(
                        got[leaf].dtype == t.dtype
                        and torch.equal(got[leaf], t))
        tokens = torch.from_numpy(prompt)
        b = tokens.shape[0]
        with torch.no_grad():
            _, whole_cache = build_model(cfg, "cpu").prefill(
                {**whole, "sparse_plan": plan}, {"tokens": tokens})
            cspecs = bundle.cache_specs(b)
            out["cache_placed"] = {k: _bits(shd.place(v, mesh, cspecs[k]))
                                   for k, v in whole_cache.items()}
            out["whole_cache"] = {k: _bits(v) for k, v in whole_cache.items()}
            sparams = {**params, "sparse_plan": splan}
            shd.COLLECTIVES.reset()
            engine_execute.reset_stats()
            logits, cache = bundle.prefill(sparams, {"tokens": tokens})
            out["collectives"] = shd.COLLECTIVES.snapshot()
            out["expert_blocks"] = dict(engine_execute.EXPERT_BLOCKS)
            out["logits"] = logits.numpy()
            out["cache"] = {k: _bits(v) for k, v in cache.items()}
            out["tokens"] = greedy_generate(
                bundle, sparams, tokens, steps,
                tokens.shape[1] + steps).numpy()
            out["dense_logits"] = bundle.prefill(
                params, {"tokens": tokens})[0].numpy()
    finally:
        mesh.close()
    return out


def prefill_cases(rank: int, world_size: int, init_method: str, axes,
                  sizes, cases) -> list:
    """``[(prefill logits, decode logits)]`` of each case ``(cfg,
    params_np, prompt, plan_kwargs or None[, MoE segment length])`` on one
    live mesh: the prefill of ``prompt``, then one decode step of token 3
    for every row on its cache."""
    mesh = init_mesh(axes, sizes, rank=rank, world_size=world_size,
                     backend="gloo", init_method=init_method, device="cpu")
    out = []
    try:
        for cfg, params_np, prompt, plan_kwargs, *seg in cases:
            _set_moe_seg(seg[0] if seg else None)
            whole = params_from_numpy(params_np, "cpu")
            bundle = build_model(cfg, "cpu", mesh=mesh)
            params = shd.place_tree(
                whole, shd.tree_shardings(mesh, bundle.param_specs()))
            if plan_kwargs is not None:
                params["sparse_plan"] = engine_plan.shard_plan(
                    engine_plan.plan_transformer(cfg, whole, **plan_kwargs),
                    mesh)
            tokens = torch.from_numpy(prompt)
            b, s = tokens.shape
            with torch.no_grad():
                logits, pf = bundle.prefill(params, {"tokens": tokens})
                cache = bundle.merge(bundle.init_cache(b, s + 1), pf)
                step, _ = bundle.decode_step(
                    params, {"tokens": torch.full((b, 1), 3),
                             "cache_len": torch.full((b,), s)}, cache)
            out.append((logits.numpy(), step.numpy()))
    finally:
        mesh.close()
    return out


def family_cases(rank: int, world_size: int, init_method: str, axes,
                 sizes, cases) -> list:
    """Each case (a dict: ``cfg``, ``params_np``, ``prompt``, ``steps``,
    ``plan_kwargs``; optional ``frontend`` rows, ``shards``) of any family
    on one live mesh.  Per case: the sharded prefill's logits with the
    plan (`engine.plan.plan_model`, placed) and without it, `COLLECTIVES`
    over the planned prefill, the greedy tokens (``steps`` new ones), the
    decode cache of ``max_len = prompt + steps`` seeded with the planned
    prefill's (the bundle's ``merge``) beside the one-process cache of the
    same run placed by `cache_specs`, and with ``frontend`` the planned
    prefill's logits with those rows.  With ``shards`` also every placed
    param and plan leaf with its `shard_shape`."""
    from ..launch.serve import greedy_generate
    mesh = init_mesh(axes, sizes, rank=rank, world_size=world_size,
                     backend="gloo", init_method=init_method, device="cpu")
    out = []
    try:
        for case in cases:
            cfg, prompt = case["cfg"], torch.from_numpy(case["prompt"])
            b, s = prompt.shape
            max_len = s + case["steps"]
            whole = params_from_numpy(case["params_np"], "cpu")
            plan = engine_plan.plan_model(cfg, whole, **case["plan_kwargs"])
            bundle = build_model(cfg, "cpu", mesh=mesh)
            pspecs = bundle.param_specs()
            params = shd.place_tree(whole, shd.tree_shardings(mesh, pspecs))
            sparams = {**params, "sparse_plan": engine_plan.shard_plan(
                plan, mesh)}
            got: dict = {"coord": mesh.coord()}
            if case.get("shards"):
                got["params"], got["plan"], got["shapes"] = {}, {}, {}
                for path, t in flatten_with_paths(params):
                    got["params"][_key(path)] = _bits(t)
                for path, t in flatten_with_paths(whole):
                    spec = pspecs
                    for p in path:
                        spec = spec[p]
                    got["shapes"][_key(path)] = shd.shard_shape(
                        mesh, tuple(t.shape), spec)
                for nm, lp in sparams["sparse_plan"].layers.items():
                    for leaf, t in engine_plan.weight_leaves(
                            lp.weights).items():
                        got["plan"][f"{nm}/{leaf}"] = _bits(t)
            with torch.no_grad():
                one = build_model(cfg, "cpu")
                wplan = {**whole, "sparse_plan": plan}
                _, pf = one.prefill(wplan, {"tokens": prompt})
                want = one.merge(one.init_cache(b, max_len), pf)
                cspecs = bundle.cache_specs(b)
                got["cache_placed"] = {
                    k: _bits(shd.place(v, mesh, cspecs[k]))
                    for k, v in want.items()}
                got["whole_cache"] = {k: _bits(v) for k, v in want.items()}
                shd.COLLECTIVES.reset()
                logits, pf = bundle.prefill(sparams, {"tokens": prompt})
                got["collectives"] = shd.COLLECTIVES.snapshot()
                got["logits"] = logits.numpy()
                got["cache"] = {
                    k: _bits(v) for k, v in bundle.merge(
                        bundle.init_cache(b, max_len), pf).items()}
                got["tokens"] = greedy_generate(bundle, sparams, prompt,
                                                case["steps"],
                                                max_len).numpy()
                got["dense_logits"] = bundle.prefill(
                    params, {"tokens": prompt})[0].numpy()
                if case.get("frontend") is not None:
                    got["frontend_logits"] = bundle.prefill(
                        sparams, {"tokens": prompt, "frontend_embed":
                                  torch.from_numpy(case["frontend"])}
                    )[0].numpy()
            out.append(got)
    finally:
        mesh.close()
    return out


def frontend_batch(cfg, batch: int, prompt_len: int, n_rows: int,
                   device) -> dict:
    """A seeded prefill batch of ``cfg``: tokens ``[batch, prompt_len]``
    and ``n_rows`` frontend rows ``[batch, n_rows, frontend_dim]`` (bf16),
    drawn on the CPU, so every process makes the same one."""
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen)
    rows = torch.randn((batch, n_rows, cfg.frontend_dim), generator=gen)
    return {"tokens": tokens.to(device),
            "frontend_embed": rows.to(torch.bfloat16).to(device)}


def frontend_prefill(rank: int, world_size: int, init_method: str, args,
                     cfg, batch: int, prompt_len: int, n_rows: int) -> dict:
    """One planned prefill with frontend rows (`frontend_batch`) of
    ``cfg`` on the live mesh of ``serve --mesh``'s parsed ``args``, the
    rank set up as serve's own (`launch.mesh_run.rank_mesh`,
    `launch.serve.place_rank`):
    its logits, its kernel launches and collectives over the prefill."""
    from ..kernels import balanced_spmm
    from ..launch import serve
    from ..launch.mesh_run import rank_mesh
    with rank_mesh(rank, world_size, init_method, args) as (mesh, device):
        bundle, params, _, _ = serve.place_rank(mesh, device, args, cfg)
        inputs = frontend_batch(cfg, batch, prompt_len, n_rows, device)
        balanced_spmm.reset_launches()
        shd.COLLECTIVES.reset()
        with torch.no_grad():
            logits = bundle.prefill(params, inputs)[0]
        return {"logits": logits.float().cpu().numpy(),
                "launches": dict(balanced_spmm.LAUNCHES),
                "collectives": shd.COLLECTIVES.snapshot()}


def traffic_cases(rank: int, world_size: int, init_method: str, axes,
                  sizes, cases) -> list:
    """Each case (a dict: ``cfg``, ``params_np``, ``plan_kwargs`` or None,
    ``requests`` ``[(prompt, max_new_tokens)]``, ``engine`` the paged
    engine's geometry (`serving.ServingEngine`'s keywords); optional
    ``max_len``: also the contiguous engine of that width, ``poison``:
    ``(request index, ticks)``, the request's pool planes set to NaN on
    every rank after that many ticks (one decode step a tick), ``late``:
    ``(rank, seconds, arrivals)``, the requests fed by
    `serving.traffic.run_continuous` at those arrivals with that rank
    started that much later) on one live mesh.  Per case: each request's
    tokens, state and logits, the engine's events, its pool block
    (int16 bits) and the block's ``(start, size)`` of the pool planes,
    whether the pool is finite, the tick log and the max |diff| of the
    logits against the contiguous engine's."""
    from ..serving import ServingEngine, contiguous_engine, paged_kv
    from ..serving import traffic as tr
    from ..serving.pages import NULL_PAGE
    mesh = init_mesh(axes, sizes, rank=rank, world_size=world_size,
                     backend="gloo", init_method=init_method, device="cpu")
    out = []
    try:
        for case in cases:
            cfg = case["cfg"]
            whole = params_from_numpy(case["params_np"], "cpu")
            bundle = build_model(cfg, "cpu", mesh=mesh)
            params = shd.place_tree(
                whole, shd.tree_shardings(mesh, bundle.param_specs()))
            if case["plan_kwargs"] is not None:
                params["sparse_plan"] = engine_plan.shard_plan(
                    engine_plan.plan_model(cfg, whole, **case["plan_kwargs"]),
                    mesh)
            eng = ServingEngine(bundle, params, mesh=mesh, record_logits=True,
                                **case["engine"])
            if case.get("late") is not None:
                late, delay, arrivals = case["late"]
                if rank == late:
                    time.sleep(delay)
                tr.run_continuous(eng, [{"prompt": p, "max_new_tokens": g}
                                        for p, g in case["requests"]],
                                  np.asarray(arrivals))
            else:
                reqs = [eng.submit(p, g) for p, g in case["requests"]]
                if case.get("poison") is not None:
                    victim, ticks = case["poison"]
                    eng.decode_fuse = 1
                    for _ in range(ticks):
                        eng.tick()
                    r = reqs[victim]
                    planes = np.array([p * eng.kh + h
                                       for p in eng.table.table[r.slot]
                                       if p != NULL_PAGE
                                       for h in range(eng.kh)])
                    p0, m = paged_kv.plane_block(mesh, eng.pool_planes)
                    mine = planes[(planes >= p0) & (planes < p0 + m)] - p0
                    for leaf in eng.pool.values():
                        leaf[:, torch.from_numpy(mine)] = float("nan")
                eng.run()
            done = {r.rid: r for r in eng.sched.done}
            got = {"coord": mesh.coord(),
                   "tokens": {i: list(r.out_tokens) for i, r in done.items()},
                   "states": {i: r.state for i, r in done.items()},
                   "logits": {i: np.stack(v)
                              for i, v in eng.logits_trace.items()},
                   "events": eng.events, "ticks": eng.ticks,
                   "pool": {k: _bits(v) for k, v in eng.pool.items()},
                   "pool_block": paged_kv.plane_block(mesh, eng.pool_planes),
                   "finite": all(bool(torch.isfinite(v).all())
                                 for v in eng.pool.values())}
            if case.get("max_len") is not None:
                geo = case["engine"]
                con = contiguous_engine(
                    bundle, params, max_slots=geo["max_slots"],
                    max_len=case["max_len"],
                    prefill_chunk=geo["prefill_chunk"], mesh=mesh,
                    record_logits=True)
                for p, g in case["requests"]:
                    con.submit(p, g)
                con.run()
                got["contiguous_diff"] = max(
                    float(np.abs(np.stack(v) - got["logits"][i]).max())
                    for i, v in con.logits_trace.items())
            out.append(got)
    finally:
        mesh.close()
    return out


def train_cases(rank: int, world_size: int, init_method: str, axes, sizes,
                cases: list) -> list:
    """See the module docstring.  A case is ``{"cfg", "params_np",
    "batches": [{name: numpy}], "opt": optim.AdamWConfig}``; the params
    are converted on every rank (`params_from_numpy`) and placed."""
    from ..launch.dryrun import tree_bytes
    from ..launch.train import mesh_bytes, replicas_equal
    from ..optim import adamw_init, adamw_update
    from ..runtime import grad_step
    mesh = init_mesh(axes, sizes, rank=rank, world_size=world_size,
                     backend="gloo", init_method=init_method, device="cpu")
    out = []
    try:
        for case in cases:
            cfg = case["cfg"]
            bundle = build_model(cfg, "cpu", mesh=mesh)
            specs = bundle.param_specs()
            params = shd.place_tree(params_from_numpy(case["params_np"],
                                                      "cpu"),
                                    shd.tree_shardings(mesh, specs))
            opt = adamw_init(params)
            res: dict = {"coord": mesh.coord(), "loss": [], "grad_norm": [],
                         "grads": [], "replicas_equal": []}
            for batch in case["batches"]:
                shd.COLLECTIVES.reset()
                loss, grads = grad_step(
                    bundle.train_loss, params,
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    accum=cfg.grad_accum, mesh=mesh, specs=specs)
                params, opt, metrics = adamw_update(
                    case["opt"], params, grads, opt, mesh=mesh, specs=specs)
                res["collectives"] = shd.COLLECTIVES.snapshot()
                res["loss"].append(float(loss))
                res["grad_norm"].append(float(metrics["grad_norm"]))
                res["grads"].append({_key(p): _bits(t) for p, t in
                                     flatten_with_paths(grads)})
                res["replicas_equal"].append(all(
                    replicas_equal(t, mesh, specs)
                    for t in (params, opt["m"], opt["v"], grads)))
            res["state"] = {_key(p): _bits(t) for p, t in flatten_with_paths(
                {"params": params, "m": opt["m"], "v": opt["v"]})}
            res["resident_bytes"] = {"param_bytes": tree_bytes(params),
                                     "opt_bytes": tree_bytes(opt),
                                     "grad_bytes": tree_bytes(grads)}
            b, s = next(iter(case["batches"]))["tokens"].shape
            res["shard_bytes"] = mesh_bytes(cfg, mesh, s, b)
            out.append(res)
    finally:
        mesh.close()
    return out


def adjoint_cases(rank: int, world_size: int, init_method: str, axes,
                  sizes) -> dict:
    """See the module docstring: ``{case: (<f(x), dy>, <x, grad>)}`` of
    this rank, and the `COLLECTIVES` the backward ran."""
    mesh = init_mesh(axes, sizes, rank=rank, world_size=world_size,
                     backend="gloo", init_method=init_method, device="cpu")
    gen = torch.Generator().manual_seed(100 + rank)

    def rand(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64)
    both = tuple(axes)
    cases = {
        "gather_data": lambda x: shd.gather(x[0], mesh, shd.P("data",
                                                               "model"),
                                            ("data",)),
        "gather_all": lambda x: shd.gather(x[0], mesh, shd.P(both, None)),
        "gather_tree_two_cuts": lambda x: torch.cat([
            t.reshape(-1) for t in shd.gather_tree(
                {"a": x[0], "b": x[1]}, mesh,
                {"a": shd.P("data", None), "b": shd.P("data", "model")},
                both).values()]),
        "all_reduce_model": lambda x: shd.all_reduce(x[0], mesh, "model"),
        "cols_gather": lambda x: shd.cols(mesh, x[0], ("model",), ()),
        "cols_cut": lambda x: shd.cols(mesh, x[0], (), ("model",)),
        "embed_rows": lambda x: shd.embed_rows(
            mesh, x[0], shd.P("model", "data"),
            torch.tensor([[0, 3, 5], [7, 2, 2]]), 4, slice(0, 2)),
    }
    out = {}
    try:
        for name, f in cases.items():
            xs = [rand(4, 2).requires_grad_(True),
                  rand(2, 2).requires_grad_(True)]
            shd.COLLECTIVES.reset()
            y = f(xs)
            dy = rand(*y.shape)
            y.backward(dy)
            out[name] = (float((y.detach() * dy).sum()),
                         sum(float((x.detach() * x.grad).sum())
                             for x in xs if x.grad is not None),
                         shd.COLLECTIVES.snapshot())
    finally:
        mesh.close()
    return out


def pid_of(rank: int, world_size: int, init_method: str) -> int:
    """The rank's process id, after it joined a one-axis mesh (left
    open: the launcher tears a kept rank's groups down)."""
    init_mesh(("data",), (world_size,), rank=rank, world_size=world_size,
              backend="gloo", init_method=init_method, device="cpu")
    return os.getpid()


def raise_on(rank: int, world_size: int, init_method: str, bad: int):
    """Rank ``bad`` raises; the others wait for it in the rendezvous."""
    if rank == bad:
        raise RuntimeError(f"rank {bad} fails on purpose")
    init_mesh(("data",), (world_size,), rank=rank, world_size=world_size,
              backend="gloo", init_method=init_method, device="cpu")


def hang_on(rank: int, world_size: int, init_method: str, bad: int):
    """Rank ``bad`` never joins; the others wait for it in the
    rendezvous."""
    if rank == bad:
        time.sleep(3600)
    init_mesh(("data",), (world_size,), rank=rank, world_size=world_size,
              backend="gloo", init_method=init_method, device="cpu")


def gloo_cuda_probe(rank: int, world_size: int, init_method: str) -> dict:
    """Each collective of `torch.distributed` on CUDA tensors over
    ``gloo``: ``{op: "ok"}``, or the start of the error it raised, or
    ``"wrong"`` where it returned a wrong result."""
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    mesh = init_mesh(("data",), (world_size,), rank=rank,
                     world_size=world_size, backend="gloo",
                     init_method=init_method, device=dev)
    dist = torch.distributed
    x = torch.full((4,), float(rank + 1), device=dev)
    total = float(sum(range(1, world_size + 1)))

    def gather():
        out = [torch.empty_like(x) for _ in range(world_size)]
        dist.all_gather(out, x)
        return all(bool((o == r + 1).all()) for r, o in enumerate(out))

    def gather_into():
        out = x.new_empty(4 * world_size)
        dist.all_gather_into_tensor(out, x)
        return bool((out.reshape(world_size, 4)[:, 0]
                     == torch.arange(1, world_size + 1, device=dev)).all())

    def reduce():
        y = x.clone()
        dist.all_reduce(y)
        return bool((y == total).all())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return bool((y == 1).all())

    def reduce_scatter():
        out = x.new_empty(4)
        dist.reduce_scatter(out, [x.clone() for _ in range(world_size)])
        return bool((out == total).all())

    def all_to_all():
        out = x.new_empty(4 * world_size)
        dist.all_to_all_single(out, x.repeat(world_size))
        return bool((out.reshape(world_size, 4)[:, 0]
                     == torch.arange(1, world_size + 1, device=dev)).all())

    found = {}
    try:
        for name, op in (("all_gather", gather),
                         ("all_gather_into_tensor", gather_into),
                         ("all_reduce", reduce), ("broadcast", broadcast),
                         ("reduce_scatter", reduce_scatter),
                         ("all_to_all_single", all_to_all)):
            try:
                found[name] = "ok" if op() else "wrong"
            except RuntimeError as e:     # the backend refuses the op
                found[name] = f"{type(e).__name__}: {str(e)[:100]}"
            dist.barrier()
    finally:
        mesh.close()
    return found


__all__ = ["mesh_case", "prefill_cases", "family_cases", "frontend_batch",
           "frontend_prefill", "traffic_cases", "train_cases",
           "adjoint_cases", "pid_of", "raise_on", "hang_on",
           "gloo_cuda_probe"]
