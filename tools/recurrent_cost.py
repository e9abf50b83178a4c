"""The one-device serve cost of the recurrent families (chip_smoke phase
19's paths), for one or more source trees of the port, on one CUDA card.

    python3 tools/recurrent_cost.py TREE [TREE ...]

Each TREE is a checkout of the repo (its ``src/repro_torch`` is the one
measured); a parent commit unpacks with ``git archive <sha> | tar -x -C
.archive/parent`` (``.archive/`` is git-ignored).  Give the trees
alternating, e.g. ``.archive/parent . . .archive/parent``: each argument
runs in a process of its own, which for rwkv6-3b and zamba2-1.2b at
published width and depth (bf16, batch 4, prompt 32, 32 new tokens,
sparsity 0.5) serves through the tree's ``launch.serve`` entry point
(`chip_smoke.serve_run`: dense and sparse tok/s, the peak device memory)
and profiles one sparse generation (`chip_smoke.profile_generate`: the
wall, the device's busy time, the WKV / SSD scans' device time, one warm
prefill's wall).  Prints the card's name and power limit, one JSON line
per process, and as the last line each tree's median over its processes
of each number.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ("rwkv6-3b", "zamba2-1.2b")
PROFILE_KEYS = ("wall_ms", "device_busy_ms", "recurrence_device_ms",
                "prefill_wall_ms")


def child(tree: str) -> int:
    """One tree's numbers as a JSON line, with that tree's ``src/`` first
    on the path."""
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    sys.path.insert(0, str(pathlib.Path(tree).resolve() / "src"))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    _build.build()
    # as chip_smoke sets them before its serve phases
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"tree": tree, "package": repro_torch.__file__}
    for arch in ARCHS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _, res = chip_smoke.serve_run(
            torch, serve, arch,
            ["--arch", arch, *chip_smoke.SLICE7_ARGS, "--quant", "none"])
        row = {"dense_tok_s": res["dense"]["tokens_per_s"],
               "sparse_tok_s": res["sparse"]["tokens_per_s"],
               "serve_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        torch.cuda.empty_cache()
        prof = chip_smoke.profile_generate(torch, serve, arch=arch)
        row.update({k: prof[k] for k in PROFILE_KEYS})
        out[arch] = row
    print(json.dumps(out), flush=True)
    return 0


def compare(trees: list) -> int:
    import torch
    if not trees:
        print("usage: python3 tools/recurrent_cost.py TREE [TREE ...]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("recurrent_cost: no CUDA device available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    out = []
    for tree in trees:
        res = subprocess.run([sys.executable, __file__, "--child", tree],
                             capture_output=True, text=True)
        if res.returncode:
            print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
            return res.returncode
        row = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        out.append(row)
    summary = {}
    for tree in dict.fromkeys(trees):
        rows = [r for r in out if r["tree"] == tree]
        summary[tree] = {arch: {k: statistics.median(r[arch][k]
                                                     for r in rows)
                                for k in rows[0][arch]}
                         for arch in ARCHS}
        summary[tree]["processes"] = len(rows)
    print(json.dumps({"recurrent_cost": summary}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child(sys.argv[2]))
    sys.exit(compare(sys.argv[1:]))
