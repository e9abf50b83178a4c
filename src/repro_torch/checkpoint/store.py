"""Atomic checkpoints with a CRC manifest — counterpart of
`repro.checkpoint.store`, on the same on-disk layout, so a checkpoint that
either package writes restores in the other::

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
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from pathlib import Path

import numpy as np
import torch

from ..tree import flatten_with_paths, unflatten

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
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def save_checkpoint(root: str | Path, step: int, tree, *,
                    extra: dict | None = None, keep: int = 3):
    """Atomically write ``tree`` (+ json-serializable ``extra``) for
    ``step``, keeping the newest ``keep`` steps."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for path, leaf in flatten_with_paths(tree):
        key = _key(path)
        arr, dtype = _to_numpy(leaf)
        fname = f"{zlib.crc32(key.encode()):08x}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype,
            "crc32": zlib.crc32(arr.tobytes()),
        }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                     # atomic commit
    _gc(root, keep)


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
    """Check one step's files against its CRC manifest without building a
    tree.  Returns the problems found (empty: healthy), each naming the
    file or leaf at fault."""
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
        try:
            arr = np.load(d / meta["file"])
        except (OSError, ValueError, EOFError) as e:
            problems.append(f"{d.name}/{meta['file']} (leaf {key}): "
                            f"unreadable shard ({type(e).__name__}: {e})")
            continue
        if zlib.crc32(arr.tobytes()) != meta["crc32"]:
            problems.append(f"{d.name}/{meta['file']} (leaf {key}): "
                            "CRC mismatch")
    return problems


def restore_checkpoint(root: str | Path, step: int, tree_like, *,
                       device=None, strict_crc: bool = True):
    """Restore into the structure of ``tree_like``; returns ``(tree,
    extra)``.  Each leaf goes to ``device``, else to the device of the
    matching ``tree_like`` leaf (the CPU for a non-tensor leaf)."""
    d = Path(root) / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    out = []
    for path, like in flatten_with_paths(tree_like):
        key = _key(path)
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(d / meta["file"])
        if strict_crc and zlib.crc32(arr.tobytes()) != meta["crc32"]:
            raise IOError(f"CRC mismatch for {key} — corrupt checkpoint")
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out.append(_from_numpy(arr, meta["dtype"]).to(dev))
    return unflatten(tree_like, out), manifest.get("extra", {})


class CheckpointManager:
    """Save-every-N + auto-resume convenience wrapper."""

    def __init__(self, root: str | Path, *, every: int = 100, keep: int = 3):
        self.root = Path(root)
        self.every = every
        self.keep = keep

    def maybe_save(self, step: int, tree, *, extra=None, force=False):
        if force or (step > 0 and step % self.every == 0):
            save_checkpoint(self.root, step, tree, extra=extra,
                            keep=self.keep)
            return True
        return False

    def restore_latest(self, tree_like, *, device=None):
        """Restore the newest *restorable* step: walk complete steps newest
        to oldest, skipping any that fail (truncated file, CRC mismatch,
        missing leaf) with a warning, so one bad step costs at most
        ``every`` steps of progress rather than the job."""
        steps = complete_steps(self.root)
        last_err = None
        for step in reversed(steps):
            try:
                tree, extra = restore_checkpoint(self.root, step, tree_like,
                                                 device=device)
                return step, tree, extra
            except (OSError, ValueError, KeyError, EOFError) as e:
                last_err = e
                print(f"checkpoint: step {step} unrestorable "
                      f"({type(e).__name__}: {e}); falling back to an "
                      "older step")
        if steps and last_err is not None:
            raise IOError(
                f"no restorable checkpoint under {self.root}: all "
                f"{len(steps)} complete step(s) failed; last error: "
                f"{last_err}") from last_err
        return None, None, {}
