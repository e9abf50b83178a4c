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

``--mesh data=2,model=2 --dist-init file://PATH`` trains any family
(rwkv6 and zamba2 at ``--compute-dtype float32`` only: `refuse_mesh`) on
a live mesh of `torch.distributed` ranks over ``gloo``, one process a
rank (all on the one card, or the CPU), as the reference's `Trainer`
does on sharded arrays (`run_mesh`): params, gradients, AdamW moments
and the compression's residuals placed by ``param_specs``; each rank
checkpoints its own blocks every ``--ckpt-every`` steps and at the end
(a replicated block once), ``--resume`` restores them, from a
checkpoint of any mesh or of one process, and ``--grad-compression``
quantizes each leaf as the whole leaf would be.  It gates itself
against a one-process run of the same arguments in this process (from
step 0, uninterrupted) and raises where a gate fails; for the MoE family
the gate holds the steps before the ranks' routes first differ from the
one process's (at bf16 a near tie flips once the params differ by a
rounding), and reports the routing agreement.
"""
from __future__ import annotations

import argparse
import dataclasses
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
from ..models.api import init_shapes, input_specs
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
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"),
                    default=None,
                    help="the activations' dtype (default: the config's)")
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
    """The model config the arguments name, depth cut to ``--n-layers``,
    its compute dtype ``--compute-dtype`` where given."""
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.n_layers is not None:
        if not 0 < args.n_layers <= cfg.n_layers:
            raise ValueError(f"--n-layers must be in [1, {cfg.n_layers}]")
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if getattr(args, "compute_dtype", None):
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    return cfg


def _trainer(args: argparse.Namespace, cfg, bundle, params, device, *,
             mesh=None, checkpoint_every: int | None = None) -> Trainer:
    """The trainer of ``bundle``'s ``params`` on the synthetic stream
    (``--batch`` x ``--seq`` a step) with the arguments' AdamW, on a live
    ``mesh`` with the bundle's ``param_specs``."""
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


# The families (rwkv6's ``ssm``, zamba2's ``hybrid``) whose train state a
# mesh run cannot be held to one process's at bfloat16 compute: their
# zero-initialized leaves (rwkv6's ``ln1_b`` / ``ln2_b``, zamba2's
# ``conv_b`` / ``A_log`` / ``dt_bias``) take Adam's sign-like first step,
# so a bf16 rounding that flips the sign of a near-zero gradient moves
# such a param by 2 lr, about its leaf's whole max; one process at bf16
# differs from itself at float32 by 40-70% of such a leaf's max, so no
# tolerance tells a fault from rounding there.
FLOAT32_ONLY_MESH_FAMILIES = ("ssm", "hybrid")


def refuse_mesh(args: argparse.Namespace, cfg) -> None:
    """Raise ValueError where ``--mesh`` cannot run these arguments: a
    missing rendezvous, or a family of `FLOAT32_ONLY_MESH_FAMILIES` at
    bfloat16 compute (before any rank starts)."""
    if not args.dist_init:
        raise ValueError("--mesh needs --dist-init (file://PATH or "
                         "tcp://HOST:PORT)")
    if cfg.family in FLOAT32_ONLY_MESH_FAMILIES \
            and cfg.compute_dtype != "float32":
        raise ValueError(
            f"--mesh holds {cfg.name}'s train state against one process "
            f"only at float32 compute: at {cfg.compute_dtype} its "
            f"zero-initialized leaves take Adam's sign-like first step, "
            f"which a rounding of a near-zero gradient flips; pass "
            f"--compute-dtype float32")


def _state(trainer: Trainer) -> dict:
    return {"params": trainer.params, "m": trainer.opt_state["m"],
            "v": trainer.opt_state["v"]}


def compared_steps(cfg, steps: int) -> list:
    """The steps after which the ranks' blocks are held against one
    process's state: every step for the MoE family (the gate takes the
    last one before the routes first differ), else the last (any family:
    the recurrent ones route nothing)."""
    return list(range(1, steps + 1)) if cfg.family == "moe" else [steps]


def _key(path) -> str:
    return "/".join(map(str, path))


def one_process(args: argparse.Namespace, cfg,
                compared: list | None = None) -> dict:
    """One process's run of the same seed-0 params, stream and steps as
    ``--mesh`` (its yardstick), from step 0 to ``--steps`` uninterrupted
    and without a checkpoint, with ``--grad-compression`` where given:
    per step the loss, the grad norm and the experts each MoE dispatch
    chose (none for the families without experts); after each step of
    ``compared`` (default `compared_steps`) its params and AdamW moments
    (float32, kept in memory on its device, under ``states``: the ranks
    read them where they lie) and each leaf's max |value|.  A yardstick
    with several compared steps serves several mesh runs (a run and its
    resumed continuation)."""
    device = resolve_device(args.device)
    bundle = build_model(cfg, device)
    trainer = _trainer(args, cfg, bundle, bundle.init(0), device,
                       checkpoint_every=0)
    trainer.cfg.log_every = 1
    compared = compared or compared_steps(cfg, args.steps)
    routes, scale, states = [], {}, {}

    def on_step(step):
        routes.append([r.cpu().numpy() for r in sink])
        sink.clear()
        if step in compared:
            # a step replaces the state's tensors (`adamw_update` writes
            # none in place), so these stay the step's
            states[step] = {_key(p): t.detach().float()
                            for p, t in flatten_with_paths(_state(trainer))}
            scale[step] = {k: max(float(t.abs().max()), 1e-30)
                           for k, t in states[step].items()}
    with transformer.record_routes() as sink:
        res = trainer.run(on_step=on_step)
    if res["status"] != "done":
        raise RuntimeError(f"the one-process run ended {res}")
    log_ = trainer.metrics_log
    return {"loss": [m["loss"] for m in log_],
            "grad_norm": [m["grad_norm"] for m in log_],
            "step_s": [m["step_time_s"] for m in log_],
            "routes": routes, "scale": scale, "states": states}


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
    shapes = init_shapes(cfg)
    shape = ShapeSpec("train", "train", seq, batch)
    grads = shapes if cfg.grad_accum == 1 \
        else tree_map(lambda p: p.float(), shapes)
    want = per_device_bytes(
        cfg, shape, mesh, {"params": shapes, "opt": adamw_init(shapes),
                           "inputs": input_specs(cfg, shape)},
        {"grads": grads})
    return {k: want[k] for k in ("param_bytes", "opt_bytes", "grad_bytes")}


def block_errors(state: dict, mesh, specs: dict, whole: dict) -> dict:
    """Per leaf of ``state`` (this rank's params, ``m`` and ``v`` blocks):
    max |block - its block of the one-process leaf| (``whole``: the
    one-process state of `one_process`, shared with the ranks where it
    lies: on the card by CUDA IPC, on the CPU in shared memory)."""
    return {_key(p): float((t.detach().float() - shd.place(
        whole[_key(p)], mesh, at_path(specs, p[1:]))).abs().max())
        for p, t in flatten_with_paths(state)}


def _train_rank(rank: int, world_size: int, init_method: str,
                args: argparse.Namespace, cfg, states: dict) -> dict:
    """One rank of ``--mesh`` (`mesh_run.rank_mesh`): the live bundle's
    seed-0 params made whole and placed in turns (`mesh_run.in_turns`),
    resumed from the newest checkpoint of ``--ckpt-dir`` with
    ``--resume`` (every rank its own blocks, on any saving mesh), then
    the mesh's `runtime.Trainer` to ``--steps``, checkpointing every
    ``--ckpt-every`` steps, this rank's counts zeroed just before the
    first step.  After each step it notes the step's collectives (the
    preemption flag's, the compression's and the checkpoint's among
    them), the experts each MoE dispatch chose, and whether its params'
    and moments' blocks equal, bit for bit, those of the ranks that hold
    the same ones; after each step that ``states`` (the one-process
    states by step) holds, each block's distance to that state
    (`block_errors`).  Returns the rank's report."""
    from .dryrun import tree_bytes
    t_start = time.monotonic()
    with mesh_run.rank_mesh(rank, world_size, init_method, args) as (
            mesh, device):
        bundle = build_model(cfg, device, mesh=mesh)
        specs = bundle.param_specs()
        params, setup = mesh_run.in_turns(mesh, device,
                                          lambda: bundle.init(0))
        trainer = _trainer(args, cfg, bundle, params, device, mesh=mesh)
        trainer.cfg.log_every = 1
        del params
        if args.resume:
            trainer.resume()
        start = trainer.step
        equal, collectives, routes, errors = [], [], [], {}
        compare_s = 0.0

        def on_step(step):
            nonlocal compare_s
            collectives.append(shd.COLLECTIVES.snapshot())
            routes.append([r.cpu().numpy() for r in sink])
            sink.clear()
            equal.append(all(replicas_equal(t, mesh, specs)
                             for t in _state(trainer).values()))
            if step in states:
                t0 = time.monotonic()
                errors[step] = block_errors(_state(trainer), mesh, specs,
                                            states[step])
                compare_s += time.monotonic() - t0
            shd.COLLECTIVES.reset()
        mesh_run.zero_counts(device)
        with transformer.record_routes() as sink:
            res = trainer.run(on_step=on_step)
        if res["status"] != "done":
            raise RuntimeError(f"rank {rank} ended {res}")
        log_ = trainer.metrics_log
        return {"rank": rank, "coord": mesh.coord(), "start_step": start,
                "steps": [m["step"] for m in log_],
                "loss": [m["loss"] for m in log_],
                "grad_norm": [m["grad_norm"] for m in log_],
                "step_s": [m["step_time_s"] for m in log_],
                "collectives": collectives, "replicas_equal": equal,
                "routes": routes, "checkpoints": trainer.checkpoints,
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


# A compressed step quantizes each gradient to int8 levels of 1/127 of
# its 256-element block's max: where the mesh's gradient differs from one
# process's by a rounding, an element may land one level apart, which
# moves ``m`` and ``v`` by up to about that share of a leaf's max (and the
# error feedback carries it into the next step).  The params, ``m`` and
# ``v`` of a compressed run are held at this tolerance, the loss and grad
# norm at the compute dtype's.
COMPRESSED_STATE_TOL = 2e-2
# At float32 a mesh's state drifts from one process's by what its
# gradients' sums round apart: a gradient that sums many tokens' terms
# which cancel (rwkv6's bias ``ln1_b``) differs between the two by up to a
# few percent of its value on an H100 (rwkv6-3b at 2 layers), and a leaf
# that starts at zero holds only a few Adam updates of it.  There the H100
# read 3.04e-3 of the leaf's max after one step and 1.19e-3 / 1.29e-3
# after two / three (``m`` and ``v`` within 6.7e-4); the CPU's smoke config
# 1.6e-5 (`tools/mesh_state_gap.py` takes the gap apart by step and
# element).  The params, ``m`` and ``v`` of a float32 run are held at this
# tolerance, 1.6x the largest reading; the loss and grad norm at 1e-4.
F32_STATE_TOL = 5e-3


def state_tol(args: argparse.Namespace, cfg, tol: float) -> float:
    """The tolerance of a mesh run's params, ``m`` and ``v`` (relative to
    each leaf's max |value|): `COMPRESSED_STATE_TOL` where
    ``--grad-compression`` quantizes, `F32_STATE_TOL` at float32 compute,
    else ``tol``, the compute dtype's (that of the loss and grad norm)."""
    if args.grad_compression:
        return max(tol, COMPRESSED_STATE_TOL)
    return F32_STATE_TOL if cfg.compute_dtype == "float32" else tol


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _fmt_collectives(counts: dict) -> str:
    return ", ".join(f"{k}: {c['ops']} ops {c['bytes']} B"
                     for k, c in counts.items()) or "none"


def run_mesh(args: argparse.Namespace, yardstick: dict | None = None
             ) -> dict:
    """``--mesh``: `one_process` in this process (or ``yardstick``, an
    earlier `one_process` of the same config that kept every step this
    run compares), then `_train_rank` on every rank with the yardstick's
    states, by `mesh_run.against_one_process`.  The steps held against
    one process are those the ranks ran (from the checkpoint ``--resume``
    restored, if any) before the first in which a rank's MoE routes
    differ from its (every step without experts; a flip is what bf16
    rounding of a near tie does once the params differ by it).  Raises
    unless, at the parity tolerance (1e-4 at float32 compute, 2e-2 at
    bfloat16), every rank's loss and grad norm of each held step match
    the one-process run's (relative to its value); its params, ``m`` and
    ``v`` blocks after the last held step match the one-process tree cut
    by ``param_specs`` at `state_tol` (relative to each leaf's max
    |value|); the first step is held; every rank started at the same
    step and routed as rank 0 did; every rank's replicated blocks equal
    after every step, bit for bit, those of the ranks that hold the same
    ones; and every rank's resident params, moments and gradients equal
    `dryrun.per_device_bytes` for the config and mesh.  Prints per rank
    the step's collectives, walls, checkpoint writes and restore and the
    peak; returns the report under ``mesh``."""
    cfg = config(args)
    refuse_mesh(args, cfg)
    one_fn = one_process if yardstick is None \
        else lambda *_: yardstick   # noqa: E731
    ref, ranks, head = mesh_run.against_one_process(
        args, cfg, one_fn, _train_rank,
        rank_args=lambda ref: (ref["states"],))
    tol = head["parity_tol"]
    s_tol = state_tol(args, cfg, tol)
    steps = ranks[0]["steps"]
    agreement = [None if not ref["routes"][s - 1] else min(
        mesh_run.routing_agreement(r["routes"][i], ref["routes"][s - 1])
        for r in ranks) for i, s in enumerate(steps)]
    held = next((i for i, a in enumerate(agreement)
                 if a is not None and a < 1.0), len(steps))
    held_step = steps[held - 1] if held else None
    routes_alike = all(
        len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        for r in ranks for a, b in zip(r["routes"], ranks[0]["routes"]))
    steps_equal = all(r["steps"] == steps for r in ranks) and steps == list(
        range(ranks[0]["start_step"] + 1, args.steps + 1))
    loss_err = max((_rel(g, ref["loss"][s - 1]) for r in ranks
                    for g, s in zip(r["loss"][:held], steps)),
                   default=math.inf)
    gnorm_err = max((_rel(g, ref["grad_norm"][s - 1]) for r in ranks
                     for g, s in zip(r["grad_norm"][:held], steps)),
                    default=math.inf)
    scale = ref["scale"].get(held_step, {})
    state_err = {k: max(r["block_errors"][held_step][k] for r in ranks) / s
                 for k, s in scale.items()} or {"-": math.inf}
    replicas = all(all(r["replicas_equal"]) for r in ranks)
    bytes_equal = all(r["resident_bytes"] == r["shard_bytes"]
                      for r in ranks)
    per_rank = [{k: v for k, v in r.items()
                 if k not in ("block_errors", "routes")} for r in ranks]
    for r in per_rank:
        ck = r["checkpoints"]
        saves = "; ".join(
            f"step {c['step']} {c['bytes']} B in {c['files']} files "
            f"{c['s']:.2f} s ({_fmt_collectives(c.get('collectives', {}))})"
            for c in ck["saves"]) or "none"
        restored = ck["restored"]
        restore = f"step {restored['step']} {restored['bytes']} B " \
            f"{restored['s']:.2f} s" if restored else "none"
        print(f"[train/mesh] rank {r['rank']} {r['coord']}: steps "
              f"{r['steps']} walls {[round(s, 3) for s in r['step_s']]} s, "
              f"collectives of the last step "
              f"{_fmt_collectives(r['collectives'][-1])}, peak "
              f"{r['peak_gib']} GiB (set-up {r['setup_peak_gib']} GiB), "
              f"set-up {r['setup_s']:.2f} s of {r['setup_wall_s']:.2f} s "
              f"in turns of {r['setup_turns']}, resident "
              f"{r['resident_bytes']} (per_device_bytes "
              f"{r['shard_bytes']}), checkpoint writes [{saves}], restore "
              f"[{restore}], compare {r['compare_s']:.2f} s, rank "
              f"{r['rank_s']:.2f} s")
    worst = max(state_err, key=state_err.get)
    report = {**head, "steps": args.steps, "grad_accum": cfg.grad_accum,
              "start_step": ranks[0]["start_step"], "ran_steps": steps,
              "grad_compression": args.grad_compression,
              "loss": ranks[0]["loss"], "one_process_loss": ref["loss"],
              "grad_norm": ranks[0]["grad_norm"],
              "one_process_grad_norm": ref["grad_norm"],
              "one_process_step_s": ref["step_s"],
              "routing_agreement": agreement, "held_steps": held,
              "held_step": held_step, "routes_alike": routes_alike,
              "loss_rel_err": loss_err, "grad_norm_rel_err": gnorm_err,
              "state_rel_err": state_err, "state_tol": s_tol,
              "replicas_equal": replicas,
              "bytes_equal": bytes_equal, "ranks": per_rank}
    routing = "" if cfg.family != "moe" else (
        f"; routing agreement with one process a step {agreement}, "
        f"every rank routed as rank 0 {routes_alike}")
    print(f"[train/mesh] {cfg.name} on {head['mesh']} over gloo "
          f"({head['device']}), steps {steps} from step "
          f"{report['start_step']}"
          f"{', compressed' if args.grad_compression else ''}: loss "
          f"{report['loss']} (one process {ref['loss']}), held {held} "
          f"steps{routing}: rel err loss {loss_err:.3g}, grad norm "
          f"{gnorm_err:.3g} (tol {tol:g}), params / m / v "
          f"{state_err[worst]:.3g} ({worst}) (tol {s_tol:g}); "
          f"replicated blocks bitwise equal "
          f"{replicas}, resident bytes equal to per_device_bytes "
          f"{bytes_equal}; one process {head['one_process_s']:.1f} s, "
          f"ranks {head['ranks_s']:.1f} s")
    if not (steps_equal and held >= 1 and routes_alike and replicas
            and bytes_equal and loss_err <= tol and gnorm_err <= tol
            and state_err[worst] <= s_tol):
        raise AssertionError(f"the mesh's train run failed its gates: "
                             f"{report}")
    return {"mesh": report}


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
