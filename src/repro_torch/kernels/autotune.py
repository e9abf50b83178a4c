"""Measured block autotuning: sweep, cache, and reuse `BlockChoice`s —
counterpart of `repro.kernels.autotune`.

`ops.choose_blocks` is a closed-form model (the reference's VMEM-occupancy
prior) that picks (bm, bo, bn) without running a kernel.  This module fits
the choice to measurement:

* ``candidate_blocks`` — the static pick plus its one-step power-of-two
  neighbours that fit the model's double-buffered budget, the reference's
  list, less the column blocks the CUDA kernels refuse (``bn`` above
  `balanced_spmm.MAX_BN` or not a multiple of 4): those are dropped before
  anything is timed, so no sweep hides a kernel refusal in a record.  Only
  a forced failure (`ops.InjectedKernelFault`) quarantines a candidate, as
  the reference's sweep quarantines any that raises; any other exception
  propagates.
* ``sweep_blocks`` — times every candidate through `ops.tiled_spmm` (the
  entry `engine.execute.apply_fc` dispatches for a planned ``cuda`` layer)
  on synthetic balanced weights of the exact (m, o, n, k) shape, and
  returns the argmin.  The static pick is always a candidate.
* a JSON **cache** keyed by ``(version, backend, impl, itemsize, dtype, m,
  o, n, k, budget[, quant])``.  The backend segment is ``cpu`` or
  ``cuda:<device name>``, so an entry swept on another card, or on the
  CPU, is a miss.  The file is this package's own (`default_cache_path`,
  and its document carries ``"package": "repro_torch"``): the two packages
  never read each other's entries.
* ``resolve_blocks`` — the entry `engine.plan` calls: ``tune="off"`` the
  static model, ``"cached"`` a warm entry or else the static model,
  ``"sweep"`` a warm entry or else a sweep whose winner is persisted.

What the sweep ranks on the card: the kernels choose their own CTA tiles
(`balanced_spmm.token_tile`, `wide_splits`), so ``bm`` and ``bo`` only set
the wrappers' padding (`ops._pad_and_run_tiled`, `_pad_and_run_batched`);
a sweep ranks ``bn`` (which fixes KB and NB of the encoding) and those
padding copies.  Only the ``cuda`` rung is tunable; the eager rungs take no
block parameters and resolve to the static model.

Timing: on a CUDA device `bench_time` takes the median of at least 10
CUDA-event timed calls, each after an L2 flush and a device-side spin that
outlasts the wrapper's host path (so the events time the device's work);
on the CPU it keeps the reference's best-of-``iters`` wall clock.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import pathlib
import statistics
import tempfile
import time
from typing import NamedTuple

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None

import numpy as np
import torch

from ..device import resolve_device
from . import ops
from .balanced_spmm import MAX_BN
from .tile_format import QUANT_MODES, encode_tiled, max_block_count, \
    quantize_tiled

CACHE_VERSION = 1
PACKAGE = "repro_torch"

# the rung whose execution consumes (bm, bo, bn); every other rung gets the
# static model whatever the tune mode
TUNABLE_IMPLS = ("cuda",)

_ITEMSIZE_DTYPE = {2: torch.bfloat16, 4: torch.float32}

# the CUDA timer: an L2 flush of 256 MB and a spin of at least 2 ms (at
# about 1.98 GHz) and three times the call's host time, then the median of
# at least this many timed calls
_FLUSH_BYTES = 256 * 1024 * 1024
_SPIN_CYCLES = 4_000_000
_CYCLES_PER_MS = 1_980_000
_CUDA_RUNS = 10


def default_cache_path() -> str:
    """``REPRO_TORCH_AUTOTUNE_CACHE`` or ``~/.cache/repro_torch/autotune.json``
    (never the reference's file)."""
    env = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if env:
        return env
    return str(pathlib.Path.home() / ".cache" / PACKAGE / "autotune.json")


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def backend_name(device) -> str:
    """The cache key's backend segment: ``cpu`` or ``cuda:<device name>``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def cache_key(m: int, o: int, n: int, k: int, *, itemsize: int = 4,
              impl: str = "cuda", backend: str | None = None,
              device=None, vmem_budget: int = ops._VMEM_BUDGET,
              dtype=None, quant: str = "none") -> str:
    """Versioned cache key (the reference's layout; its backend segment
    from ``backend``, else from ``device``).  ``m`` is bucketed to the next
    power of two (`ops.bucket_m`) so the live M spread shares entries per
    bucket; the key names the weight dtype, and a ``|q<mode>`` segment
    keeps block-quantized sweeps apart from full-precision ones."""
    backend = backend or backend_name(resolve_device(device))
    m = ops.bucket_m(m)
    dt = _dtype_name(dtype if dtype is not None
                     else _ITEMSIZE_DTYPE.get(itemsize, torch.float32))
    q = f"|q{quant}" if quant != "none" else ""
    return (f"v{CACHE_VERSION}|{backend}|{impl}|is{itemsize}|dt{dt}"
            f"|m{m}|o{o}|n{n}|k{k}|vmem{vmem_budget}{q}")


# ---------------------------------------------------------------------------
# On-disk cache (atomic writes, best-effort reads)
# ---------------------------------------------------------------------------

_READ_MEMO: dict = {}   # path -> ((mtime_ns, size), entries) parse memo


def load_cache(path: str | os.PathLike | None = None) -> dict:
    """Entry dict from ``path``; {} on a missing, corrupt, version-mismatched
    or foreign (not this package's) file, so a stale cache degrades to the
    static model and never breaks a plan build.  Parses are memoized on the
    file's (mtime, size); callers get a fresh shallow copy."""
    path = pathlib.Path(path or default_cache_path())
    try:
        st = path.stat()
    except OSError:
        return {}
    sig = (st.st_mtime_ns, st.st_size)
    memo = _READ_MEMO.get(str(path))
    if memo is not None and memo[0] == sig:
        return dict(memo[1])
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        doc = None
    entries = {}
    if isinstance(doc, dict) and doc.get("version") == CACHE_VERSION \
            and doc.get("package") == PACKAGE \
            and isinstance(doc.get("entries"), dict):
        entries = doc["entries"]
    _READ_MEMO[str(path)] = (sig, entries)
    return dict(entries)


def save_cache(entries: dict, path: str | os.PathLike | None = None) -> str:
    """Atomically persist ``entries`` (tmp file + rename: a concurrent
    reader never sees a torn write).  Returns the path written."""
    path = pathlib.Path(path or default_cache_path())
    path.parent.mkdir(parents=True, exist_ok=True)
    doc = {"version": CACHE_VERSION, "package": PACKAGE, "entries": entries}
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _READ_MEMO.pop(str(path), None)
    return str(path)


@contextlib.contextmanager
def _cache_lock(path: pathlib.Path):
    """Advisory exclusive lock on ``<path>.lock`` (flock) around
    `update_cache`'s read-merge-write; unlocked where there is no fcntl
    (the atomic rename still prevents torn files)."""
    if fcntl is None:  # pragma: no cover
        yield
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    lock = path.with_suffix(path.suffix + ".lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def update_cache(updates: dict,
                 path: str | os.PathLike | None = None) -> dict:
    """Merge ``updates`` into the on-disk cache under an exclusive lock
    (re-read inside the lock, merge, atomic write), so concurrent sweeps
    union their entries.  Returns the merged entries."""
    path = pathlib.Path(path or default_cache_path())
    with _cache_lock(path):
        entries = load_cache(path)
        entries.update(updates)
        save_cache(entries, path)
    return entries


# ---------------------------------------------------------------------------
# Candidate generation (the static model as prior)
# ---------------------------------------------------------------------------

def kernel_takes(c: ops.BlockChoice) -> bool:
    """Whether the CUDA kernels take this column block (their own check:
    ``bn`` a multiple of 4 in [4, `MAX_BN`])."""
    return 4 <= c.bn <= MAX_BN and c.bn % 4 == 0


def candidate_blocks(m: int, o: int, n: int, k: int, *, itemsize: int = 4,
                     vmem_budget: int = ops._VMEM_BUDGET,
                     max_candidates: int = 8, quant: str = "none") -> list:
    """The reference's candidate list (the static pick first, its one-step
    power-of-two neighbours per dimension within the double-buffered budget
    and the padded problem dims, plus ``bo`` x2 / x4 at decode M), less the
    candidates the CUDA kernels refuse (`kernel_takes`).  ``m`` is bucketed
    first, as in `cache_key`."""
    m = ops.bucket_m(m)
    wb = ops.QUANT_WBYTES[quant]
    static = ops.choose_blocks(m, o, n, k, itemsize=itemsize,
                               vmem_budget=vmem_budget, w_bytes=wb)
    caps = {"bm": max(8, ops._round_up(m, 8)),
            "bo": max(8, ops._round_up(o, 8)),
            "bn": max(8, ops._round_up(n, 8))}
    out: list = []
    seen: set = set()

    def add(bm, bo, bn, *, force=False):
        key = (bm, bo, bn)
        if key in seen or len(out) >= max_candidates:
            return
        fp = ops._tiled_footprint(bm, bo, bn, ops._tiled_kb_est(n, k, bn),
                                  itemsize, w_bytes=wb)
        if not force and 2 * fp > vmem_budget:
            return
        seen.add(key)
        out.append(ops.BlockChoice(bm=bm, bo=bo, bn=bn, vmem_bytes=fp))

    # the prior is always candidate 0, budget notwithstanding
    add(static.bm, static.bo, static.bn, force=True)
    base = {"bm": static.bm, "bo": static.bo, "bn": static.bn}
    for dim in ("bm", "bo", "bn"):
        for cand in (base[dim] * 2, base[dim] // 2):
            if not 8 <= cand <= min(256, caps[dim]):
                continue
            trial = dict(base)
            trial[dim] = cand
            add(trial["bm"], trial["bo"], trial["bn"])
    if m <= ops.SKINNY_M:
        for cand in (base["bo"] * 2, base["bo"] * 4):
            if 8 <= cand <= min(256, caps["bo"]):
                add(base["bm"], cand, base["bn"])
    return [c for c in out if kernel_takes(c)]


# ---------------------------------------------------------------------------
# Sweep harness
# ---------------------------------------------------------------------------

def _bench_problem(m: int, o: int, n: int, k: int, dtype, device):
    """The reference's deterministic synthetic problem of the exact shape
    (same NumPy draws): x ``[m, n]``, values ``[o, k]``, ascending per-row
    indices ``[o, k]`` (k distinct columns per row)."""
    rng = np.random.default_rng([m, o, n, k])
    x = rng.standard_normal((m, n), np.float32)
    vals = rng.standard_normal((o, k), np.float32)
    idx = np.sort(np.argsort(rng.random((o, n)), axis=1)[:, :k],
                  axis=1).astype(np.int32)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(vals).to(device, dtype),
            torch.from_numpy(idx).to(device))


def _cuda_time_s(fn, args, runs: int) -> float:
    """Median CUDA-event seconds of ``fn(*args)`` over ``runs`` calls, each
    after an L2 flush and a device-side spin (`torch.cuda._sleep`) longer
    than three times the call's host enqueue time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = max(_SPIN_CYCLES, int(3 * host_ms * _CYCLES_PER_MS))
    flush = torch.empty(_FLUSH_BYTES // 4, device="cuda")
    events = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events) / 1e3


def bench_time(fn, *args, iters: int, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)`` after ``warmup`` untimed calls.
    On CUDA tensors (the first argument's device): the median of
    ``max(iters, 10)`` CUDA-event timed calls (`_cuda_time_s`); on the CPU
    the reference's best-of-``iters`` wall clock (the minimum strips
    additive scheduler noise)."""
    for _ in range(warmup):
        fn(*args)
    if args and isinstance(args[0], torch.Tensor) and args[0].is_cuda:
        return _cuda_time_s(fn, args, max(iters, _CUDA_RUNS))
    best = math.inf
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def _choice_fields(c: ops.BlockChoice) -> dict:
    return {"bm": c.bm, "bo": c.bo, "bn": c.bn, "vmem_bytes": c.vmem_bytes}


def sweep_blocks(m: int, o: int, n: int, k: int, *, itemsize: int = 4,
                 impl: str = "cuda", iters: int = 2, warmup: int = 1,
                 vmem_budget: int = ops._VMEM_BUDGET, dtype=None,
                 quant: str = "none", device=None) -> tuple:
    """Time every candidate `BlockChoice` through `ops.tiled_spmm` on
    ``device`` and return ``(winner, record)``.  Each candidate re-encodes
    the synthetic weights at its own ``bn``.  ``record`` holds every
    candidate's time, the static pick's, and any candidate that raised
    (``quarantined``, never the winner).  A non-tunable impl returns the
    static model untimed."""
    dev = resolve_device(device)
    m = ops.bucket_m(m)
    static = ops.choose_blocks(m, o, n, k, itemsize=itemsize,
                               vmem_budget=vmem_budget,
                               w_bytes=ops.QUANT_WBYTES[quant])
    dtype = dtype if dtype is not None \
        else _ITEMSIZE_DTYPE.get(itemsize, torch.float32)
    base = {"backend": backend_name(dev), "impl": impl, "m": m, "o": o,
            "n": n, "k": k, "itemsize": itemsize,
            "dtype": _dtype_name(dtype), "quant": quant,
            "torch": torch.__version__}
    if impl not in TUNABLE_IMPLS:
        record = dict(base, source="static",
                      note=f"impl={impl} takes no block parameters",
                      **_choice_fields(static), time_s=None,
                      static_time_s=None, candidates=[])
        return static, record

    x, vals, idx = _bench_problem(m, o, n, k, dtype, dev)
    timed = []
    quarantined = []
    with torch.no_grad():
        for cand in candidate_blocks(m, o, n, k, itemsize=itemsize,
                                     vmem_budget=vmem_budget, quant=quant):
            try:
                kb = max_block_count(idx, n, cand.bn)
                tb = encode_tiled(vals, idx, n, bn=cand.bn, kb=kb)
                if quant != "none":
                    tb = quantize_tiled(tb, quant)

                def fn(xx, tb=tb, cand=cand):
                    return ops.tiled_spmm(xx, tb, block_m=cand.bm,
                                          block_o=cand.bo, impl=impl)
                t = bench_time(fn, x, iters=iters, warmup=warmup)
            except ops.InjectedKernelFault as e:
                # a forced rung failure quarantines the candidate (recorded,
                # never won); any other exception is a kernel that does not
                # build, launch or take its blocks, and ends the sweep
                quarantined.append(dict(_choice_fields(cand),
                                        error=f"{type(e).__name__}: {e}"))
                continue
            timed.append((t, cand))
    if not timed:
        # every candidate failed: the untimed static model, not a sweep
        # record (it must not be cached as one)
        record = dict(base, source="static",
                      note="all sweep candidates failed",
                      **_choice_fields(static), time_s=None,
                      static_time_s=None, candidates=[],
                      quarantined=quarantined)
        return static, record
    static_t = next((t for t, c in timed
                     if (c.bm, c.bo, c.bn) == (static.bm, static.bo,
                                               static.bn)), None)
    best_t, best = min(timed, key=lambda tc: tc[0])
    record = dict(base, source="sweep", **_choice_fields(best),
                  time_s=best_t, static_time_s=static_t,
                  candidates=[dict(_choice_fields(c), time_s=t)
                              for t, c in timed],
                  quarantined=quarantined)
    return best, record


def _valid_entry(e) -> bool:
    """A trustworthy swept entry: damaged entries (wrong type, missing,
    garbage or non-positive block fields) read as a miss."""
    try:
        return (isinstance(e, dict) and e.get("source") == "sweep"
                and all(int(e[f]) > 0 for f in ("bm", "bo", "bn"))
                and int(e.get("vmem_bytes", 0)) >= 0)
    except (KeyError, TypeError, ValueError):
        return False


def _choice_from_entry(e: dict) -> ops.BlockChoice:
    return ops.BlockChoice(bm=int(e["bm"]), bo=int(e["bo"]), bn=int(e["bn"]),
                           vmem_bytes=int(e.get("vmem_bytes", 0)))


# ---------------------------------------------------------------------------
# The plan-build entry point
# ---------------------------------------------------------------------------

class Resolved(NamedTuple):
    """`resolve_blocks` result: the choice, where it came from (``static``
    | ``cached`` | ``swept``), and the static prior."""
    blocks: ops.BlockChoice
    source: str
    static: ops.BlockChoice


def resolve_blocks(m: int, o: int, n: int, k: int, *, itemsize: int = 4,
                   impl: str = "cuda", tune: str = "off",
                   cache_path: str | None = None,
                   vmem_budget: int = ops._VMEM_BUDGET,
                   iters: int = 2, warmup: int = 1, dtype=None,
                   quant: str = "none", device=None) -> Resolved:
    """Resolve a `BlockChoice` for one GEMM key under a tune policy:
    ``off`` the static `ops.choose_blocks` model; ``cached`` a valid cache
    entry for this exact key (backend of ``device`` included), else the
    static model, never timing anything; ``sweep`` like ``cached``, but a
    miss runs `sweep_blocks` on ``device`` and persists the winner.  Only
    the ``cuda`` rung is tunable; ``m`` is bucketed first."""
    if tune not in ("off", "cached", "sweep"):
        raise ValueError(f"tune must be off|cached|sweep, got {tune!r}")
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
    m = ops.bucket_m(m)
    static = ops.choose_blocks(m, o, n, k, itemsize=itemsize,
                               vmem_budget=vmem_budget,
                               w_bytes=ops.QUANT_WBYTES[quant])
    if tune == "off" or impl not in TUNABLE_IMPLS:
        return Resolved(static, "static", static)
    path = cache_path or default_cache_path()
    key = cache_key(m, o, n, k, itemsize=itemsize, impl=impl, device=device,
                    vmem_budget=vmem_budget, dtype=dtype, quant=quant)
    hit = load_cache(path).get(key)
    if _valid_entry(hit):
        return Resolved(_choice_from_entry(hit), "cached", static)
    if tune == "cached":
        return Resolved(static, "static", static)
    best, record = sweep_blocks(m, o, n, k, itemsize=itemsize, impl=impl,
                                iters=iters, warmup=warmup,
                                vmem_budget=vmem_budget, dtype=dtype,
                                quant=quant, device=device)
    if record.get("source") == "sweep":
        update_cache({key: record}, path)
        return Resolved(best, "swept", static)
    return Resolved(static, "static", static)


def main(argv=None):  # pragma: no cover - thin CLI
    """``python -m repro_torch.kernels.autotune --m 128 --o 2048 --n 2048
    --k 1024 --itemsize 2`` sweeps one shape into the cache on the GPU
    (``--device cpu`` on the CPU)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, required=True)
    ap.add_argument("--o", type=int, required=True)
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--itemsize", type=int, default=4, choices=(2, 4))
    ap.add_argument("--quant", default="none", choices=QUANT_MODES)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    res = resolve_blocks(args.m, args.o, args.n, args.k,
                         itemsize=args.itemsize, impl="cuda", tune="sweep",
                         cache_path=args.cache, quant=args.quant,
                         device=args.device)
    print(f"{res.source}: bm={res.blocks.bm} bo={res.blocks.bo} "
          f"bn={res.blocks.bn} (static bm={res.static.bm} "
          f"bo={res.static.bo} bn={res.static.bn}) -> "
          f"{args.cache or default_cache_path()}")
    return 0


bucket_m = ops.bucket_m          # re-export: callers keying sweeps by hand

__all__ = ["CACHE_VERSION", "TUNABLE_IMPLS", "Resolved", "backend_name",
           "bench_time", "bucket_m", "cache_key", "candidate_blocks",
           "default_cache_path", "kernel_takes", "load_cache",
           "resolve_blocks", "save_cache", "sweep_blocks", "update_cache"]


if __name__ == "__main__":  # pragma: no cover
    import sys
    sys.exit(main())
