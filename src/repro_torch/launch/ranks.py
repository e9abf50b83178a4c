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

Inside ``with keep_ranks(world_size):`` every `run_ranks` of that many
ranks runs on one set of processes, started by the first call and kept
from call to call (each call still joins its own rendezvous): a process
start, its imports and its CUDA context are paid once for several runs.
Between calls a rank waits for every rank to finish the call (a barrier
of its default group), then tears down the process groups the call left
and frees what the call held (`torch.cuda.empty_cache`).

A rank that raises or exits non-zero, or a run past ``timeout_s``, ends
every rank that is still running and raises `RankError` with the rank's
traceback (or which ranks did not finish); kept ranks are then ended
too, and the next call starts new ones.  There is no fallback to one
process.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import queue as queue_mod
import time
import traceback
import urllib.parse

import torch
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank raised, died or outlived the launcher's time limit."""


def _entry(rank: int, inbox, results) -> None:
    """A rank's process: run each job ``(fn, world_size, init_method,
    args)`` from ``inbox`` until a None, or until one raises."""
    # before the rank's first CUDA allocation: what a job frees (a serve
    # rank's whole params and plan after placement, a finished job's
    # tensors) goes back to the card page by page (a fixed segment that
    # also holds a live tensor could not be released)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    torch.set_num_threads(1)
    for job in iter(inbox.get, None):
        fn, world_size, init_method, args = job
        try:
            out = fn(rank, world_size, init_method, *args)
        except BaseException:
            results.put((rank, False, traceback.format_exc()))
            raise SystemExit(1)
        results.put((rank, True, out))
        if torch.distributed.is_initialized():      # a job left its groups
            # every rank past its job first: a rank that closed its
            # connections while a peer still set up a group (gloo's
            # connectFullMesh) or read its last message would break it
            torch.distributed.barrier()
            torch.distributed.destroy_process_group()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()


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


class _Ranks:
    """``world_size`` started rank processes, each with its own inbox."""

    def __init__(self, world_size: int):
        ctx = mp.get_context("spawn")
        self.world_size = world_size
        self.results = ctx.Queue()
        self.inboxes = [ctx.Queue() for _ in range(world_size)]
        self.procs = [ctx.Process(target=_entry, daemon=True,
                                  args=(r, self.inboxes[r], self.results))
                      for r in range(world_size)]
        for p in self.procs:
            p.start()
        self.closed = False

    def run(self, fn, init_method: str, args: tuple,
            timeout_s: float) -> list:
        """One job on every rank; on a failure every rank is ended."""
        for inbox in self.inboxes:
            inbox.put((fn, self.world_size, init_method, args))
        deadline = time.monotonic() + timeout_s
        out: dict = {}
        try:
            while len(out) < self.world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    missing = sorted(set(range(self.world_size)) - set(out))
                    raise RankError(f"ranks {missing} did not finish within "
                                    f"{timeout_s:g} s")
                try:
                    rank, ok, payload = self.results.get(
                        timeout=min(left, 0.5))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if not dead:
                        continue
                    # a rank that raised has queued its traceback before
                    # it exited: give the queue a moment to deliver it
                    try:
                        rank, ok, payload = self.results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RankError(
                            f"rank {dead[0]} exited with code "
                            f"{self.procs[dead[0]].exitcode} and no result"
                        ) from None
                if not ok:
                    raise RankError(f"rank {rank} raised:\n{payload}")
                out[rank] = payload
        except BaseException:
            self.close(kill=True)
            raise
        return [out[r] for r in range(self.world_size)]

    def close(self, kill: bool = False) -> None:
        """End the processes: each finishes its inbox (``kill``: at
        once)."""
        if self.closed:
            return
        self.closed = True
        for p, inbox in zip(self.procs, self.inboxes):
            if kill and p.is_alive():
                p.kill()
            elif p.is_alive():
                inbox.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self.results.close()
        for inbox in self.inboxes:
            # a rank that died before it read its job leaves it queued
            inbox.cancel_join_thread()
            inbox.close()

    @property
    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)


_KEPT: dict = {}        # world size -> the `_Ranks` of `keep_ranks`


@contextlib.contextmanager
def keep_ranks(world_size: int):
    """Within the block, `run_ranks` of ``world_size`` ranks reuses one
    set of processes (see the module docstring); they end with it."""
    if world_size in _KEPT:
        raise RuntimeError(f"ranks of {world_size} are kept already")
    _KEPT[world_size] = None
    try:
        yield
    finally:
        ranks = _KEPT.pop(world_size)
        if ranks is not None:
            ranks.close()


def run_ranks(fn, world_size: int, *, init_method: str, args=(),
              timeout_s: float = 600.0) -> list:
    """``[fn(rank, world_size, init_method, *args) for each rank]``, each
    call in its own process (kept ones inside `keep_ranks`); raises
    `RankError` (see the module docstring)."""
    _check_rendezvous(init_method)
    if world_size not in _KEPT:
        ranks = _Ranks(world_size)
        try:
            return ranks.run(fn, init_method, tuple(args), timeout_s)
        finally:
            ranks.close()
    ranks = _KEPT[world_size]
    if ranks is None or not ranks.alive:
        ranks = _KEPT[world_size] = _Ranks(world_size)
    try:
        return ranks.run(fn, init_method, tuple(args), timeout_s)
    except BaseException:
        _KEPT[world_size] = None
        raise


__all__ = ["RankError", "run_ranks", "keep_ranks"]
