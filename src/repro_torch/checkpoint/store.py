"""Atomic checkpoints with a CRC manifest — counterpart of
`repro.checkpoint.store`.  A whole-leaf checkpoint (one process's) has the
reference's on-disk layout, so one that either package writes restores in
the other; a mesh checkpoint (below) restores in this package only, onto
any mesh or as whole leaves (its leaves list ``blocks``, where the
reference's reader expects one ``file``)::

    <root>/step_00000123/
        manifest.json      # step, extra, per leaf: file, shape, dtype, crc32
        <crc32 of the leaf's key path>.npy

A leaf's key path joins its keys with ``::`` (dicts in sorted key order,
as ``jax.tree_util`` walks them); its crc32 is that of the array's raw
bytes.  Write protocol: write into ``step_XXXXXXXX.tmp/``, fsync the
manifest, then rename atomically; a crash mid-write never corrupts the
latest checkpoint, and ``.tmp`` residue is collected.

bf16 leaves: NumPy has no bf16 type, so such a leaf is written as its
16-bit words in a ``V2`` (two raw bytes) array and tagged ``bfloat16`` in
the manifest, which is what the reference's ``np.save`` of an ml_dtypes
bf16 array gives; restore reads the words back into a bf16 tensor.

On a live mesh (``mesh=`` and the tree's ``specs``, `distributed.sharding`
partition specs) the tree's leaves are this rank's blocks and no rank
holds a whole leaf: each rank writes its own blocks, a block that several
ranks hold (replicated over `sharding.replicated_axes`) once, by the rank
at index 0 along those axes, into the step's ``.tmp`` directory; then the
ranks meet (one gather of every rank's block records, which is the
barrier), rank 0 writes the manifest, renames and collects, and a last
barrier returns every rank after the commit.  A rank that dies before the
gather leaves no committed step.  The manifest adds the mesh's axes and,
per leaf, its whole shape, its spec and every block's file, index,
start, shape and crc32::

        <crc32 of the key path>.<block index per dim>.npy

Restore takes the restarting job's mesh and specs, which may differ from
the saving job's, or none (whole leaves): each rank builds each of its
blocks from the saved blocks that overlap it, read memory-mapped (on the
saving mesh a rank reads its own blocks only), and a whole-leaf
checkpoint is one block covering its leaf.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ..distributed import sharding as shd
from ..tree import at_path, flatten_with_paths, unflatten

_SEP = "::"
_BF16 = "bfloat16"


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(leaf) -> tuple:
    """``(array to save, manifest dtype)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor on ``arr``'s memory (an array of this process's own)."""
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _crc(arr: np.ndarray) -> int:
    """The crc32 of an array's raw bytes (read in place where it is
    contiguous, as a memory-mapped block is)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _load(path: Path) -> np.ndarray:
    """One ``.npy`` file, memory-mapped (a truncated file raises)."""
    return np.load(path, mmap_mode="r")


def _fsync_json(path: Path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _fresh_tmp(root: Path, step: int) -> Path:
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    return tmp


def _commit(root: Path, step: int, tmp: Path, manifest: dict,
            keep: int) -> None:
    _fsync_json(tmp / "manifest.json", manifest)
    final = root / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic commit
    _gc(root, keep)


def save_checkpoint(root: str | Path, step: int, tree, *,
                    extra: dict | None = None, keep: int = 3,
                    mesh=None, specs=None) -> dict:
    """Atomically write ``tree`` (+ json-serializable ``extra``) for
    ``step``, keeping the newest ``keep`` steps.  On a live ``mesh`` the
    leaves are this rank's blocks laid out by ``specs`` (a tree of
    `distributed.sharding.P` of ``tree``'s structure) and every rank of
    the mesh calls it (`write_blocks`, then `commit_blocks`).  Returns
    what this process wrote: ``{"bytes", "files", "s"}``."""
    t0 = time.monotonic()
    root = Path(root)
    if mesh is not None:
        if mesh.rank == 0:
            _fresh_tmp(root, step)
        _barrier(mesh)
        tmp = root / f"step_{step:08d}.tmp"
        records = write_blocks(tmp, tree, mesh, specs)
        commit_blocks(root, step, records, mesh, extra=extra, keep=keep)
        return {"bytes": sum(r["bytes"] for r in records),
                "files": len(records), "s": time.monotonic() - t0}
    tmp = _fresh_tmp(root, step)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    nbytes = 0
    for path, leaf in flatten_with_paths(tree):
        key = _key(path)
        arr, dtype = _to_numpy(leaf)
        fname = f"{zlib.crc32(key.encode()):08x}.npy"
        np.save(tmp / fname, arr)
        nbytes += arr.nbytes
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype,
            "crc32": _crc(arr),
        }
    _commit(root, step, tmp, manifest, keep)
    return {"bytes": nbytes, "files": len(manifest["leaves"]),
            "s": time.monotonic() - t0}


# ---------------------------------------------------------------------------
# A live mesh: blocks
# ---------------------------------------------------------------------------

def _barrier(mesh) -> None:
    torch.distributed.barrier()
    shd.COLLECTIVES.record("barrier", 0)


def _spec_json(spec) -> list:
    return [list(d) if isinstance(d, tuple) else d for d in spec]


def write_blocks(tmp: str | Path, tree, mesh, specs) -> list:
    """Write the blocks of ``tree`` (this rank's, by ``specs``) that this
    rank is the writer of (index 0 along the leaf's replicated axes) into
    the step's ``.tmp`` directory ``tmp``; returns their records (key,
    file, index, start, shape, dtype, whole shape, spec, crc32, bytes)."""
    tmp = Path(tmp)
    coord = mesh.coord()
    out = []
    for path, leaf in flatten_with_paths(tree):
        spec = at_path(specs, path)
        if any(coord[a] for a in shd.replicated_axes(mesh, spec)):
            continue
        key = _key(path)
        arr, dtype = _to_numpy(leaf)
        dims = list(spec) + [None] * (arr.ndim - len(spec))
        index = [mesh.index(d) if d is not None else 0 for d in dims]
        whole = shd.whole_shape(mesh, arr.shape, spec)
        fname = f"{zlib.crc32(key.encode()):08x}." \
            + ".".join(map(str, index)) + ".npy"
        np.save(tmp / fname, arr)
        out.append({"key": key, "file": fname, "index": index,
                    "start": [i * n for i, n in zip(index, arr.shape)],
                    "shape": list(arr.shape), "dtype": dtype,
                    "whole": whole, "spec": _spec_json(spec),
                    "crc32": _crc(arr), "bytes": int(arr.nbytes)})
    return out


def commit_blocks(root: str | Path, step: int, records: list, mesh, *,
                  extra: dict | None = None, keep: int = 3) -> None:
    """The commit of a step whose blocks every rank wrote
    (`write_blocks`): every rank's records gathered (one
    ``all_gather_object``, the barrier after the writes), then rank 0
    writes the manifest, renames the ``.tmp`` directory and collects old
    steps; a last barrier returns every rank once the step is
    committed."""
    root = Path(root)
    every: list = [None] * mesh.size
    torch.distributed.all_gather_object(every, records)
    shd.COLLECTIVES.record("all_gather_object",
                           len(pickle.dumps(records)))
    if mesh.rank == 0:
        leaves: dict = {}
        for rec in (r for recs in every for r in recs):
            leaf = leaves.setdefault(rec["key"], {
                "shape": rec["whole"], "dtype": rec["dtype"],
                "spec": rec["spec"], "blocks": []})
            leaf["blocks"].append({k: rec[k] for k in (
                "file", "index", "start", "shape", "crc32")})
        for leaf in leaves.values():
            leaf["blocks"].sort(key=lambda b: b["index"])
        manifest = {"step": step, "leaves": leaves, "extra": extra or {},
                    "mesh": {"axis_names": list(mesh.axis_names),
                             "axis_sizes": list(mesh.axis_sizes)}}
        _commit(root, step, root / f"step_{step:08d}.tmp", manifest, keep)
    _barrier(mesh)


def _blocks(meta: dict) -> list:
    """A manifest leaf's blocks: a whole-leaf entry is one block."""
    if "blocks" in meta:
        return meta["blocks"]
    return [{"file": meta["file"], "start": [0] * len(meta["shape"]),
             "shape": meta["shape"], "crc32": meta["crc32"]}]


# ---------------------------------------------------------------------------
# Steps, verify, restore
# ---------------------------------------------------------------------------

def _gc(root: Path, keep: int):
    steps = sorted(d for d in root.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and not d.name.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(d)
    for d in root.glob("step_*.tmp"):
        shutil.rmtree(d)


def complete_steps(root: str | Path) -> list[int]:
    """Steps with a committed (renamed, manifest-bearing) directory,
    ascending; ``.tmp`` residue and manifest-less directories never
    appear."""
    root = Path(root)
    if not root.exists():
        return []
    steps = []
    for d in root.iterdir():
        if (d.is_dir() and d.name.startswith("step_")
                and not d.name.endswith(".tmp")
                and (d / "manifest.json").exists()):
            steps.append(int(d.name.split("_")[1]))
    return sorted(steps)


def latest_step(root: str | Path) -> int | None:
    steps = complete_steps(root)
    return steps[-1] if steps else None


def verify_checkpoint(root: str | Path, step: int) -> list[str]:
    """Check one step's files (every block of a mesh's checkpoint)
    against its CRC manifest without building a tree.  Returns the
    problems found (empty: healthy), each naming the file or leaf at
    fault."""
    d = Path(root) / f"step_{step:08d}"
    if not d.is_dir():
        return [f"{d.name}: directory missing"]
    try:
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{d.name}/manifest.json: unreadable ({e})"]
    problems = []
    for key, meta in manifest.get("leaves", {}).items():
        for blk in _blocks(meta):
            try:
                arr = _load(d / blk["file"])
            except (OSError, ValueError, EOFError) as e:
                problems.append(f"{d.name}/{blk['file']} (leaf {key}): "
                                f"unreadable shard ({type(e).__name__}: "
                                f"{e})")
                continue
            if _crc(arr) != blk["crc32"]:
                problems.append(f"{d.name}/{blk['file']} (leaf {key}): "
                                "CRC mismatch")
    return problems


def _read_region(d: Path, key: str, meta: dict, region: list,
                 strict_crc: bool) -> tuple:
    """``(array, bytes read)``: the part ``region`` (``[(start, size)]``
    per dim) of a saved leaf, from the blocks that overlap it."""
    out, nbytes, covered = None, 0, 0
    for blk in _blocks(meta):
        lo = [max(s, b) for (s, _), b in zip(region, blk["start"])]
        hi = [min(s + n, b + m) for (s, n), b, m in zip(
            region, blk["start"], blk["shape"])]
        if any(h <= lo_ for lo_, h in zip(lo, hi)):
            continue
        arr = _load(d / blk["file"])
        if tuple(arr.shape) != tuple(blk["shape"]):
            raise ValueError(f"{blk['file']} (leaf {key}): shape "
                             f"{arr.shape}, manifest {blk['shape']}")
        if strict_crc and _crc(arr) != blk["crc32"]:
            raise IOError(f"CRC mismatch for {key} ({blk['file']}) — "
                          f"corrupt checkpoint")
        if out is None:
            out = np.empty([n for _, n in region], dtype=arr.dtype)
        src = tuple(slice(a - b, h - b)
                    for a, h, b in zip(lo, hi, blk["start"]))
        dst = tuple(slice(a - s, h - s)
                    for a, h, (s, _) in zip(lo, hi, region))
        out[dst] = arr[src]
        nbytes += arr.nbytes
        covered += int(np.prod([h - a for a, h in zip(lo, hi)]))
    if out is None or covered != int(np.prod([n for _, n in region])):
        raise IOError(f"checkpoint blocks of {key} do not cover the "
                      f"block {region}")
    return out, nbytes


def restore_checkpoint(root: str | Path, step: int, tree_like, *,
                       device=None, strict_crc: bool = True, mesh=None,
                       specs=None, stats: dict | None = None):
    """Restore into the structure of ``tree_like``; returns ``(tree,
    extra)``.  Each leaf goes to ``device``, else to the device of the
    matching ``tree_like`` leaf (the CPU for a non-tensor leaf).  On a
    live ``mesh`` the leaves are this rank's blocks by ``specs`` (the
    restarting job's, any mesh shape): each is built from the saved
    blocks that overlap it (the reference's reshard-on-load); without a
    mesh each leaf is whole.  Either kind of checkpoint restores either
    way.  ``stats``, where given, gets this process's ``bytes`` read and
    ``s``."""
    t0 = time.monotonic()
    d = Path(root) / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    out, nbytes = [], 0
    for path, like in flatten_with_paths(tree_like):
        key = _key(path)
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        region = [(0, n) for n in meta["shape"]] if mesh is None else \
            shd.block_region(mesh, meta["shape"], at_path(specs, path))
        if isinstance(like, torch.Tensor) and list(like.shape) != [
                n for _, n in region]:
            raise ValueError(f"{key}: the checkpoint's block is "
                             f"{[n for _, n in region]}, the tree's "
                             f"{list(like.shape)}")
        arr, n = _read_region(d, key, meta, region, strict_crc)
        nbytes += n
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out.append(_from_numpy(arr, meta["dtype"]).to(dev))
    if stats is not None:
        stats.update(bytes=nbytes, s=time.monotonic() - t0)
    return unflatten(tree_like, out), manifest.get("extra", {})


class CheckpointManager:
    """Save-every-N + auto-resume convenience wrapper; on a live ``mesh``
    (with the state's ``specs``) every rank saves and restores its
    blocks together."""

    def __init__(self, root: str | Path, *, every: int = 100, keep: int = 3,
                 mesh=None, specs=None):
        self.root = Path(root)
        self.every = every
        self.keep = keep
        self.mesh, self.specs = mesh, specs
        self.saves: list[dict] = []       # per save: step, bytes, files, s
        self.restored: dict = {}          # the restore's step, bytes, s

    def maybe_save(self, step: int, tree, *, extra=None, force=False):
        if force or (step > 0 and step % self.every == 0):
            done = save_checkpoint(self.root, step, tree, extra=extra,
                                   keep=self.keep, mesh=self.mesh,
                                   specs=self.specs)
            self.saves.append({"step": step, **done})
            return True
        return False

    def restore_latest(self, tree_like, *, device=None):
        """Restore the newest *restorable* step: walk complete steps newest
        to oldest, skipping any that fail (truncated file, CRC mismatch,
        missing leaf) with a warning, so one bad step costs at most
        ``every`` steps of progress rather than the job.  On a mesh the
        ranks agree on each step (one ``all_reduce`` of the failures a
        step): a step restores only where every rank restored its blocks,
        and no rank goes on from a step the others did not."""
        steps = complete_steps(self.root)
        last_err = None
        for step in reversed(steps):
            stats: dict = {}
            try:
                tree, extra = restore_checkpoint(
                    self.root, step, tree_like, device=device,
                    mesh=self.mesh, specs=self.specs, stats=stats)
                failed = 0
            except (OSError, ValueError, KeyError, EOFError) as e:
                last_err, failed = e, 1
                print(f"checkpoint: step {step} unrestorable "
                      f"({type(e).__name__}: {e}); falling back to an "
                      "older step")
            if self.mesh is not None:
                failed = int(shd.all_reduce(
                    torch.tensor([failed], dtype=torch.float32),
                    self.mesh, tuple(self.mesh.axis_names)).item())
                if failed and last_err is None:
                    last_err = IOError(f"{failed} rank(s) could not "
                                       f"restore step {step}")
            if not failed:
                self.restored = {"step": step, **stats}
                return step, tree, extra
        if steps and last_err is not None:
            raise IOError(
                f"no restorable checkpoint under {self.root}: all "
                f"{len(steps)} complete step(s) failed; last error: "
                f"{last_err}") from last_err
        return None, None, {}
