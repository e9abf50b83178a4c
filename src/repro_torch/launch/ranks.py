"""Run one function on N `torch.distributed` ranks, one process each.

``run_ranks(fn, world_size, init_method=..., args=(...), timeout_s=...)``
spawns ``world_size`` processes (`torch.multiprocessing`, the ``spawn``
start method), calls ``fn(rank, world_size, init_method, *args)`` in each
and returns their results in rank order.  The rendezvous is explicit: a
``file://`` path that does not exist yet, or a ``tcp://host:port``;
nothing is read from the environment.  Each rank runs on one CPU thread
(`torch.set_num_threads`): the ranks share the host's cores.

``fn`` must be importable by its module path (a spawned process starts
from a fresh import), and its result picklable.  ``fn`` and ``args``
reach the ranks through a queue after every process has started, so a
large argument (a model's params) does not hold each start until the
rank before it has imported what unpickling it needs.

A rank that raises or exits non-zero, or a run past ``timeout_s``, ends
every rank that is still running and raises `RankError` with the rank's
traceback (or which ranks did not finish).  There is no fallback to one
process.
"""
from __future__ import annotations

import pathlib
import queue as queue_mod
import time
import traceback
import urllib.parse

import torch
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank raised, died or outlived the launcher's time limit."""


def _entry(rank: int, world_size: int, init_method: str, inbox,
           results) -> None:
    torch.set_num_threads(1)
    try:
        fn, args = inbox.get()
        out = fn(rank, world_size, init_method, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def _check_rendezvous(init_method: str) -> None:
    url = urllib.parse.urlparse(init_method)
    if url.scheme == "file":
        if pathlib.Path(url.path).exists():
            raise ValueError(f"the rendezvous file {url.path} exists: a "
                             f"stale one would join an old run; name "
                             f"another")
    elif url.scheme != "tcp":
        raise ValueError(f"init_method must be file:// or tcp://, got "
                         f"{init_method!r}")


def run_ranks(fn, world_size: int, *, init_method: str, args=(),
              timeout_s: float = 600.0) -> list:
    """``[fn(rank, world_size, init_method, *args) for each rank]``, each
    call in its own spawned process; raises `RankError` (see the module
    docstring)."""
    _check_rendezvous(init_method)
    ctx = mp.get_context("spawn")
    results, inbox = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(r, world_size, init_method, inbox, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    for _ in procs:
        inbox.put((fn, tuple(args)))
    deadline = time.monotonic() + timeout_s
    out: dict = {}
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(out))
                raise RankError(f"ranks {missing} did not finish within "
                                f"{timeout_s:g} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 0.5))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    # a rank that raised has queued its traceback before
                    # it exited: give the queue a moment to deliver it
                    try:
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RankError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result"
                        ) from None
                else:
                    continue
            if not ok:
                raise RankError(f"rank {rank} raised:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            if p.is_alive() and len(out) < world_size:
                p.kill()
        for p in procs:
            p.join(timeout=30)
        results.close()
        # a rank that died before it read its arguments leaves them queued
        inbox.cancel_join_thread()
        inbox.close()
    return [out[r] for r in range(world_size)]


__all__ = ["RankError", "run_ranks"]
