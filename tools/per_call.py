"""Wall microseconds per call of the planned decode projection, for one or
more source trees of the port, on one CUDA card.

    python3 tools/per_call.py TREE [TREE ...]

Each TREE is a checkout of the repo (its ``src/repro_torch`` is the one
timed); a parent commit unpacks with ``git archive <sha> | tar -x -C
.archive/parent`` (``.archive/`` is git-ignored).  Give the trees
alternating, e.g. ``.archive/parent . . .archive/parent``: each argument
runs in a process of its own, which times `chip_smoke.per_call_us` (layer
0's ``wq`` of olmo-1b at full width, cut to one layer, 4 rows of bf16,
the sparse plan and the dense matmul it replaces) `REPEATS` times.  Prints
the card's name and power limit, one JSON line per process, and as the
last line each tree's median over its processes of their medians and
minima.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
REPEATS = 9


def child(tree: str) -> int:
    """One tree's `REPEATS` timings as a JSON line, with that tree's
    ``src/`` first on the path."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(pathlib.Path(tree).resolve() / "src"))
    import repro_torch
    _, params, plan, _ = chip_smoke.full_width(torch, "bfloat16",
                                               n_layers=1)
    runs = [chip_smoke.per_call_us(torch, params, plan, torch.bfloat16)
            for _ in range(REPEATS)]
    print(json.dumps({"tree": tree, "package": repro_torch.__file__,
                      "sparse_us": [r["sparse"] for r in runs],
                      "dense_us": [r["dense"] for r in runs]}), flush=True)
    return 0


def compare(trees: list) -> int:
    import torch
    if not trees:
        print("usage: python3 tools/per_call.py TREE [TREE ...]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("per_call: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    out = []
    for tree in trees:
        res = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True, check=True)
        row = json.loads(res.stdout.strip().splitlines()[-1])
        for k in ("sparse", "dense"):
            row[f"{k}_median_us"] = statistics.median(row[f"{k}_us"])
            row[f"{k}_min_us"] = min(row[f"{k}_us"])
        print(json.dumps(row), flush=True)
        out.append(row)
    summary = {}
    for tree in dict.fromkeys(trees):
        rows = [r for r in out if r["tree"] == tree]
        summary[tree] = {f"{k}_{s}_us": statistics.median(
            r[f"{k}_{s}_us"] for r in rows)
            for k in ("sparse", "dense") for s in ("median", "min")}
        summary[tree]["processes"] = len(rows)
    print(json.dumps({"per_call": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    sys.exit(compare(sys.argv[1:]))
