"""Training launcher — counterpart of `repro.launch.train`:

    python -m repro_torch.launch.train --arch olmo-1b [--smoke] [--device cpu]

Trains any arch (the transformer families, rwkv6, zamba2) on the
synthetic Markov-chain LM stream with AdamW through the fault-tolerant
`runtime.Trainer`:
checkpoints every ``--ckpt-every`` steps and at the end, ``--resume``
picks up the newest restorable one, ``--grad-compression`` runs the int8
error-feedback compression.  ``--smoke`` takes the reduced config,
``--n-layers`` cuts the depth and keeps the published widths.  Runs on the
GPU unless ``--device cpu`` is given (a missing GPU raises), with TF32 off
so f32 matmuls are exact.  A step takes the config's ``grad_accum``
microbatches (`runtime.grad_step`).

``--mesh data=2,model=2 --dist-init file://PATH`` trains the transformer
families on a live mesh of `torch.distributed` ranks over ``gloo``, one
process a rank (all on the one card, or the CPU), the reference's sharded
train step (`run_mesh`): params, gradients and AdamW moments placed by
``param_specs``.  It gates itself against a one-process run of the same
arguments in this process and raises where a gate fails; for the MoE
family the gate holds the steps before the ranks' routes first differ
from the one process's (at bf16 a near tie flips once the params differ
by a rounding), and reports the routing agreement.  It takes no
checkpoint; it refuses ``--resume``, ``--grad-compression`` and the
recurrent families.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import ARCHS, ShapeSpec, get_config, get_smoke
from ..data import DataConfig, SyntheticLMData
from ..device import exact_matmuls, resolve_device
from ..distributed import sharding as shd
from ..kernels import balanced_spmm, bitmap_spmm, kv_cache_update
from ..models import build_model, transformer
from ..models.api import input_specs
from ..optim import AdamWConfig, adamw_init
from ..runtime import Trainer, TrainerConfig
from ..tree import at_path, flatten_with_paths, leaves, tree_map
from . import mesh_run


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir())
                                / "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (default: the "
                         "config's); the widths stay as published")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--mesh", default=None,
                    help="train on a live mesh of ranks, e.g. "
                         "data=2,model=2 (axes of pod, data, model)")
    ap.add_argument("--dist-init", default=None,
                    help="with --mesh: the ranks' rendezvous, a file:// "
                         "path that does not exist yet or tcp://host:port")
    return ap


def config(args: argparse.Namespace):
    """The model config the arguments name, depth cut to ``--n-layers``."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers is not None:
        if not 0 < args.n_layers <= cfg.n_layers:
            raise ValueError(f"--n-layers must be in [1, {cfg.n_layers}]")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    return cfg


def _trainer(args: argparse.Namespace, cfg, bundle, params, device, *,
             mesh=None, checkpoint_every: int | None = None) -> Trainer:
    """The trainer of ``bundle``'s ``params`` on the synthetic stream
    (``--batch`` x ``--seq`` a step) with the arguments' AdamW."""
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch),
                           device=device)
    return Trainer(
        loss_fn=bundle.train_loss, params=params, data=data,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=20,
                            total_steps=args.steps),
        cfg=TrainerConfig(total_steps=args.steps,
                          checkpoint_every=args.ckpt_every
                          if checkpoint_every is None else checkpoint_every,
                          checkpoint_dir=args.ckpt_dir,
                          grad_compression=args.grad_compression,
                          grad_accum=cfg.grad_accum),
        mesh=mesh, specs=None if mesh is None else bundle.param_specs())


def build_trainer(args: argparse.Namespace) -> Trainer:
    """The model (seed-0 params), the data stream and the trainer the
    arguments name, on the device they name."""
    device = resolve_device(args.device)
    cfg = config(args)
    bundle = build_model(cfg, device)
    params = bundle.init(0)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"[train] arch={cfg.name} layers={cfg.n_layers} "
          f"params={n_params / 1e6:.2f}M steps={args.steps} on {device}")
    return _trainer(args, cfg, bundle, params, device)


def run(args: argparse.Namespace, trainer: Trainer | None = None) -> dict:
    """Resume if asked, train to ``--steps`` under `exact_matmuls` (exact
    float32 matmuls and convolutions in the backward as in the forward),
    print the log; returns the trainer's result (with ``--mesh``:
    `run_mesh`'s report)."""
    with exact_matmuls():
        if args.mesh:
            return run_mesh(args)
        trainer = trainer or build_trainer(args)
        if args.resume and trainer.resume():
            print(f"[train] resumed from step {trainer.step}")
        result = trainer.run()
    for m in trainer.metrics_log:
        print(f"  step {m['step']:5d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  {m['step_time_s'] * 1e3:.0f}ms")
    print(f"[train] {result}")
    return result


# ---------------------------------------------------------------------------
# --mesh: the sharded train step on live ranks
# ---------------------------------------------------------------------------


def refuse_mesh(args: argparse.Namespace, cfg) -> None:
    """Raise ValueError where ``--mesh`` cannot run these arguments."""
    if args.resume:
        raise ValueError("--mesh does not take --resume: a sharded "
                         "checkpoint is not ported yet")
    if args.grad_compression:
        raise ValueError("--mesh does not take --grad-compression: the "
                         "compression is not ported to the mesh yet")
    if cfg.family not in transformer.LIVE_FAMILIES:
        raise ValueError(f"--mesh trains the {transformer.LIVE_FAMILIES} "
                         f"families; {cfg.name} is {cfg.family}, whose "
                         f"live train_loss is not ported yet")
    if not args.dist_init:
        raise ValueError("--mesh needs --dist-init (file://PATH or "
                         "tcp://HOST:PORT)")


def _state(trainer: Trainer) -> dict:
    return {"params": trainer.params, "m": trainer.opt_state["m"],
            "v": trainer.opt_state["v"]}


def compared_steps(cfg, steps: int) -> list:
    """The steps after which the ranks' blocks are held against one
    process's state: every step for the MoE family (the gate takes the
    last one before the routes first differ), else the last."""
    return list(range(1, steps + 1)) if cfg.family == "moe" else [steps]


def _key(path) -> str:
    return "/".join(map(str, path))


def one_process(args: argparse.Namespace, cfg, state_dir: str) -> dict:
    """One process's run of the same seed-0 params, stream and steps as
    ``--mesh`` (its yardstick): per step the loss, the grad norm and the
    experts each MoE dispatch chose; after each of `compared_steps` its
    params and AdamW moments (float32, on the host) saved to
    ``state_dir/<step>.pt`` and each leaf's max |value|."""
    device = resolve_device(args.device)
    bundle = build_model(cfg, device)
    trainer = _trainer(args, cfg, bundle, bundle.init(0), device,
                       checkpoint_every=0)
    trainer.cfg.log_every = 1
    compared = compared_steps(cfg, args.steps)
    routes, scale = [], {}

    def on_step(step):
        routes.append([r.cpu().numpy() for r in sink])
        sink.clear()
        if step in compared:
            state = {_key(p): t.detach().float().cpu()
                     for p, t in flatten_with_paths(_state(trainer))}
            scale[step] = {k: max(float(t.abs().max()), 1e-30)
                           for k, t in state.items()}
            torch.save(state, f"{state_dir}/{step}.pt")
    with transformer.record_routes() as sink:
        res = trainer.run(on_step=on_step)
    if res["status"] != "done":
        raise RuntimeError(f"the one-process run ended {res}")
    log_ = trainer.metrics_log
    return {"loss": [m["loss"] for m in log_],
            "grad_norm": [m["grad_norm"] for m in log_],
            "step_s": [m["step_time_s"] for m in log_],
            "routes": routes, "scale": scale}


def replicas_equal(tree, mesh, specs) -> bool:
    """Whether every leaf of ``tree`` (this rank's blocks by ``specs``)
    equals, bit for bit, the block of each rank that holds the same one
    (the ranks along `distributed.sharding.replicated_axes`)."""
    ok = True
    for path, t in flatten_with_paths(tree):
        axes = shd.replicated_axes(mesh, at_path(specs, path))
        if axes:
            copies = shd.gather(t[None], mesh, shd.P(axes))
            ok = ok and all(torch.equal(c, t) for c in copies)
    return ok


def mesh_bytes(cfg, mesh, seq: int, batch: int) -> dict:
    """`launch.dryrun.per_device_bytes`' ``param_bytes``, ``opt_bytes``
    and ``grad_bytes`` of one rank of ``mesh`` training ``cfg`` on
    ``batch`` x ``seq`` (the gradients in float32 where ``grad_accum``
    sums them)."""
    from .dryrun import per_device_bytes
    shapes = transformer.init_shapes(cfg)
    shape = ShapeSpec("train", "train", seq, batch)
    grads = shapes if cfg.grad_accum == 1 \
        else tree_map(lambda p: p.float(), shapes)
    want = per_device_bytes(
        cfg, shape, mesh, {"params": shapes, "opt": adamw_init(shapes),
                           "inputs": input_specs(cfg, shape)},
        {"grads": grads})
    return {k: want[k] for k in ("param_bytes", "opt_bytes", "grad_bytes")}


def block_errors(state: dict, mesh, specs: dict, path: str) -> dict:
    """Per leaf of ``state`` (this rank's params, ``m`` and ``v`` blocks):
    max |block - its block of the one-process leaf|, taken on the host
    (``path``: the one-process state as `torch.save` wrote it, read
    memory-mapped, so a rank reads its blocks only)."""
    whole = torch.load(path, mmap=True, weights_only=True)
    return {_key(p): float((t.detach().float().cpu() - shd.place(
        whole[_key(p)], mesh, at_path(specs, p[1:]))).abs().max())
        for p, t in flatten_with_paths(state)}


def _train_rank(rank: int, world_size: int, init_method: str,
                args: argparse.Namespace, cfg, state_dir: str) -> dict:
    """One rank of ``--mesh`` (`mesh_run.rank_mesh`): the live bundle's
    seed-0 params made whole and placed in turns (`mesh_run.in_turns`),
    then ``--steps`` steps of the mesh's `runtime.Trainer`, this rank's
    counts zeroed just before the first step.  After each step it notes
    the step's collectives, the experts each MoE dispatch chose, and
    whether its params' and moments' blocks equal, bit for bit, those of
    the ranks that hold the same ones; after each of `compared_steps`,
    each block's distance to the one-process state of that step
    (`block_errors`).  Returns the rank's report."""
    from .dryrun import tree_bytes
    t_start = time.monotonic()
    with mesh_run.rank_mesh(rank, world_size, init_method, args) as (
            mesh, device):
        bundle = build_model(cfg, device, mesh=mesh)
        specs = bundle.param_specs()
        params, setup = mesh_run.in_turns(mesh, device,
                                          lambda: bundle.init(0))
        trainer = _trainer(args, cfg, bundle, params, device, mesh=mesh,
                           checkpoint_every=0)
        trainer.cfg.log_every = 1
        del params
        compared = compared_steps(cfg, args.steps)
        equal, collectives, routes, errors = [], [], [], {}
        compare_s = 0.0

        def on_step(step):
            nonlocal compare_s
            collectives.append(shd.COLLECTIVES.snapshot())
            routes.append([r.cpu().numpy() for r in sink])
            sink.clear()
            equal.append(all(replicas_equal(t, mesh, specs)
                             for t in _state(trainer).values()))
            if step in compared:
                t0 = time.monotonic()
                errors[step] = block_errors(_state(trainer), mesh, specs,
                                            f"{state_dir}/{step}.pt")
                compare_s += time.monotonic() - t0
            shd.COLLECTIVES.reset()
        mesh_run.zero_counts(device)
        with transformer.record_routes() as sink:
            res = trainer.run(on_step=on_step)
        if res["status"] != "done":
            raise RuntimeError(f"rank {rank} ended {res}")
        log_ = trainer.metrics_log
        return {"rank": rank, "coord": mesh.coord(),
                "loss": [m["loss"] for m in log_],
                "grad_norm": [m["grad_norm"] for m in log_],
                "step_s": [m["step_time_s"] for m in log_],
                "collectives": collectives, "replicas_equal": equal,
                "routes": routes,
                "kernel_launches": {**balanced_spmm.LAUNCHES,
                                    **bitmap_spmm.LAUNCHES,
                                    **kv_cache_update.LAUNCHES},
                "peak_gib": mesh_run.peak_gib(device), **setup,
                "resident_bytes": {
                    "param_bytes": tree_bytes(trainer.params),
                    "opt_bytes": tree_bytes(trainer.opt_state),
                    "grad_bytes": log_[-1]["grad_bytes"]},
                "shard_bytes": mesh_bytes(cfg, mesh, args.seq, args.batch),
                "block_errors": errors, "compare_s": compare_s,
                "rank_s": time.monotonic() - t_start}


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def run_mesh(args: argparse.Namespace) -> dict:
    """``--mesh``: `one_process` in this process, then `_train_rank` on
    every rank, by `mesh_run.against_one_process`.  The steps held
    against one process are those before the first in which a rank's
    MoE routes differ from its (every step without experts; a flip is
    what bf16 rounding of a near tie does once the params differ by it).
    Raises unless, at the parity tolerance (1e-4 at float32 compute, 2e-2
    at bfloat16), every rank's loss and grad norm of each held step match
    the one-process run's (relative to its value) and its params, ``m``
    and ``v`` blocks after the last held step match the one-process tree
    cut by ``param_specs`` (relative to each leaf's max |value|), the
    first step is held, every rank routed as rank 0 did, every rank's
    replicated blocks equal after every step, bit for bit, those of the
    ranks that hold the same ones, and every rank's resident params,
    moments and gradients equal `dryrun.per_device_bytes` for the config
    and mesh.  Prints per rank the step's collectives, walls and peak;
    returns the report under ``mesh``."""
    cfg = config(args)
    refuse_mesh(args, cfg)
    with tempfile.TemporaryDirectory() as tmp:
        ref, ranks, head = mesh_run.against_one_process(
            args, cfg, functools.partial(one_process, state_dir=tmp),
            _train_rank, rank_args=(tmp,))
    tol = head["parity_tol"]
    agreement = [None if not want else min(
        mesh_run.routing_agreement(r["routes"][i], want) for r in ranks)
        for i, want in enumerate(ref["routes"])]
    held = next((i for i, a in enumerate(agreement)
                 if a is not None and a < 1.0), args.steps)
    routes_alike = all(
        len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        for r in ranks for a, b in zip(r["routes"], ranks[0]["routes"]))
    steps_equal = all(len(r["loss"]) == args.steps for r in ranks)
    loss_err = max((_rel(g, w) for r in ranks
                    for g, w in zip(r["loss"][:held], ref["loss"][:held])),
                   default=math.inf)
    gnorm_err = max((_rel(g, w) for r in ranks for g, w in
                     zip(r["grad_norm"][:held], ref["grad_norm"][:held])),
                    default=math.inf)
    scale = ref["scale"].get(held, {})
    state_err = {k: max(r["block_errors"][held][k] for r in ranks) / s
                 for k, s in scale.items()} or {"-": math.inf}
    replicas = all(all(r["replicas_equal"]) for r in ranks)
    bytes_equal = all(r["resident_bytes"] == r["shard_bytes"]
                      for r in ranks)
    per_rank = [{k: v for k, v in r.items()
                 if k not in ("block_errors", "routes")} for r in ranks]
    for r in per_rank:
        print(f"[train/mesh] rank {r['rank']} {r['coord']}: steps "
              f"{[round(s, 3) for s in r['step_s']]} s, collectives of the "
              f"last step " + ", ".join(
                  f"{k}: {c['ops']} ops {c['bytes']} B"
                  for k, c in r["collectives"][-1].items())
              + f", peak {r['peak_gib']} GiB (set-up {r['setup_peak_gib']} "
              f"GiB), set-up {r['setup_s']:.2f} s of "
              f"{r['setup_wall_s']:.2f} s in turns of {r['setup_turns']}, "
              f"resident {r['resident_bytes']} (per_device_bytes "
              f"{r['shard_bytes']}), compare {r['compare_s']:.2f} s, rank "
              f"{r['rank_s']:.2f} s")
    worst = max(state_err, key=state_err.get)
    report = {**head, "steps": args.steps, "grad_accum": cfg.grad_accum,
              "loss": ranks[0]["loss"], "one_process_loss": ref["loss"],
              "grad_norm": ranks[0]["grad_norm"],
              "one_process_grad_norm": ref["grad_norm"],
              "one_process_step_s": ref["step_s"],
              "routing_agreement": agreement, "held_steps": held,
              "routes_alike": routes_alike,
              "loss_rel_err": loss_err, "grad_norm_rel_err": gnorm_err,
              "state_rel_err": state_err, "replicas_equal": replicas,
              "bytes_equal": bytes_equal, "ranks": per_rank}
    routing = "" if cfg.family != "moe" else (
        f"; routing agreement with one process a step {agreement}, "
        f"every rank routed as rank 0 {routes_alike}")
    print(f"[train/mesh] {cfg.name} on {head['mesh']} over gloo "
          f"({head['device']}), {args.steps} steps: loss {report['loss']} "
          f"(one process {ref['loss']}), held {held} steps{routing}: rel "
          f"err loss {loss_err:.3g}, grad norm {gnorm_err:.3g}, params / m "
          f"/ v {state_err[worst]:.3g} ({worst}) (tol {tol:g}); replicated "
          f"blocks bitwise equal {replicas}, resident bytes equal to "
          f"per_device_bytes {bytes_equal}; one process "
          f"{head['one_process_s']:.1f} s, ranks {head['ranks_s']:.1f} s")
    if not (steps_equal and held >= 1 and routes_alike and replicas
            and bytes_equal and loss_err <= tol and gnorm_err <= tol
            and state_err[worst] <= tol):
        raise AssertionError(f"the mesh's train run failed its gates: "
                             f"{report}")
    return {"mesh": report}


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
