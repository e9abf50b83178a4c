"""An entry point's run on a live mesh, shared by ``serve --mesh`` and
``train --mesh``.

The parent runs the entry point once in one process (its yardstick),
then the same arguments on every rank of the mesh (`against_one_process`,
through `launch.ranks.run_ranks`).  A rank opens its mesh over ``gloo``
(`rank_mesh`), sets up in turns so the card never holds more whole
models than fit beside the ranks' shards (`in_turns`), and zeroes its
counts just before the run it reports (`zero_counts`).
"""
from __future__ import annotations

import argparse
import contextlib
import math
import time

import torch

from ..device import exact_matmuls, resolve_device
from ..distributed import sharding as shd
from ..engine import execute as engine_execute
from ..kernels import balanced_spmm, bitmap_spmm, kv_cache_update

MESH_TIMEOUT_S = 900.0      # the launcher's limit on the ranks' run


def parse_mesh(spec: str) -> tuple:
    """``"data=2,model=2"`` -> ``(("data", "model"), (2, 2))``."""
    names, sizes = [], []
    for part in spec.split(","):
        name, _, size = part.partition("=")
        if not name or not size.isdigit() or int(size) < 1:
            raise ValueError(f"--mesh {spec!r}: expected name=size,...")
        names.append(name.strip())
        sizes.append(int(size))
    if len(set(names)) != len(names) or not set(names) <= {"pod", "data",
                                                            "model"}:
        raise ValueError(f"--mesh {spec!r}: axes are distinct names of "
                         f"pod, data, model")
    return tuple(names), tuple(sizes)


@contextlib.contextmanager
def rank_mesh(rank: int, world_size: int, init_method: str,
              args: argparse.Namespace):
    """One rank of ``--mesh``: yields ``(mesh, device)``, the device the
    card of the rank modulo the card count (on a GPU), the live mesh of
    ``args.mesh`` over ``gloo``, under `exact_matmuls`; closes the mesh
    after."""
    from .mesh import init_mesh
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    names, sizes = parse_mesh(args.mesh)
    with exact_matmuls():
        mesh = init_mesh(names, sizes, rank=rank, world_size=world_size,
                         backend="gloo", init_method=init_method,
                         device=device)
        try:
            yield mesh, device
        finally:
            mesh.close()


def in_turns(mesh, device: torch.device, make) -> tuple:
    """``(make(), the set-up report)``: a rank's set-up on a live mesh,
    run in turns, each closed by a barrier.  In its turn a rank calls
    ``make()``, which makes what it needs whole, places it and returns
    the placed part (the whole one freed as it returns); the rank then
    empties its cache.  Rank 0 goes alone; the rest go as many at a time
    as the card holds by rank 0's measured set-up peak (`_setup_group`),
    so the card never holds more whole sets than fit beside the ranks'
    shards."""
    rank, world_size = mesh.rank, mesh.size
    t_start = time.monotonic()
    out = setup_peak = setup_card = setup_s = None
    group, start, turns = 1, 0, []  # rank 0 alone first
    while start < world_size:
        turns.append(min(group, world_size - start))
        if start <= rank < start + turns[-1]:
            t0 = time.monotonic()
            out = make()
            if device.type == "cuda":
                setup_peak = torch.cuda.max_memory_allocated(device) / 2**30
                # the card as every process uses it: the other ranks'
                # shards and contexts, the whole sets of this turn's
                # ranks, this one's still cached
                free, total = torch.cuda.mem_get_info(device)
                setup_card = (total - free) / 2**30
                torch.cuda.empty_cache()
            setup_s = time.monotonic() - t0
        torch.distributed.barrier()
        if start == 0 and world_size > 1:
            group = _setup_group(device, world_size, setup_peak)
        start += turns[-1]
    return out, {"setup_peak_gib": setup_peak, "setup_card_gib": setup_card,
                 "setup_s": setup_s,
                 "setup_wall_s": time.monotonic() - t_start,
                 "setup_turns": turns}


def _setup_group(device: torch.device, world_size: int,
                 peak_gib: float | None) -> int:
    """How many ranks of ``--mesh`` set up at once after rank 0's turn:
    off the card, all of them; on cards, as many of rank 0's measured
    set-up peaks (``peak_gib``, sent from rank 0) as 85% of the free
    memory of its card holds, on each card (a rank's card is its rank
    modulo the card count), at least one."""
    if device.type != "cuda":
        return world_size - 1
    info = torch.tensor([peak_gib or 0.0, torch.cuda.mem_get_info(device)[0]
                         / 2**30], dtype=torch.float64)
    torch.distributed.broadcast(info, 0)
    peak, free = info.tolist()
    return max(1, int(0.85 * free // peak)) * torch.cuda.device_count()


def zero_counts(device: torch.device) -> None:
    """A rank's prologue to the run it reports: the kernels' launch
    counts, the collectives, the engine's dispatch stats and the card's
    peak memory statistics set to zero."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    balanced_spmm.reset_launches()
    bitmap_spmm.reset_launches()
    kv_cache_update.reset_launches()
    shd.COLLECTIVES.reset()
    engine_execute.reset_stats()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device) -> float | None:
    """The card's peak allocated memory since `zero_counts`; None off the
    card."""
    return torch.cuda.max_memory_allocated(device) / 2**30 \
        if device.type == "cuda" else None


def routing_agreement(routes: list, ref_routes: list) -> float | None:
    """The share of (token, k) choices in which ``routes`` (one ``[T, K]``
    array a MoE dispatch) picked the expert ``ref_routes`` did; None
    without experts."""
    if not ref_routes:
        return None
    if len(routes) != len(ref_routes):
        raise ValueError(f"{len(routes)} routed dispatches against "
                         f"{len(ref_routes)}")
    same = sum(int((a == b).sum()) for a, b in zip(routes, ref_routes))
    return same / sum(a.size for a in ref_routes)


def against_one_process(args: argparse.Namespace, cfg, one_fn, rank_fn,
                        rank_args: tuple = ()) -> tuple:
    """The run of ``--mesh``: ``one_fn(args, cfg)``, this process's run of
    the same arguments (its yardstick; its memory freed before the ranks
    start), then ``rank_fn(rank, world_size, init_method, args, cfg,
    *rank_args)`` on every rank of the mesh, within `MESH_TIMEOUT_S`.
    Returns ``(one_fn's result, the ranks' reports, the report's head)``:
    model, depth, mesh, backend, device, the one process's and the ranks'
    seconds and the parity tolerance (1e-4 at float32, 2e-2 at
    bfloat16)."""
    from .ranks import run_ranks
    device = resolve_device(args.device)
    names, sizes = parse_mesh(args.mesh)
    t0 = time.monotonic()
    ref = one_fn(args, cfg)
    one_s = time.monotonic() - t0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    ranks = run_ranks(rank_fn, math.prod(sizes),
                      init_method=args.dist_init,
                      args=(args, cfg, *rank_args), timeout_s=MESH_TIMEOUT_S)
    head = {"model": cfg.name, "n_layers": cfg.n_layers,
            "mesh": dict(zip(names, sizes)), "backend": "gloo",
            "device": str(device), "one_process_s": one_s,
            "ranks_s": time.monotonic() - t0,
            "parity_tol": 1e-4 if cfg.compute_dtype == "float32" else 2e-2}
    return ref, ranks, head
