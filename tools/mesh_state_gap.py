"""Where the float32 train state of ``train --mesh`` departs from one
process's, leaf by leaf and element by element.

    PYTHONPATH=src python3 tools/mesh_state_gap.py --arch rwkv6-3b \
        --n-layers 2 --batch 8 --seq 128 --steps 2

takes `launch.train`'s own arguments (``--smoke --device cpu`` for a
small run on the CPU; ``--mesh`` defaults to ``data=2,model=2``) and
runs them at float32 compute: one process's uninterrupted steps
(`launch.train.one_process`, its state kept after every step), then the
mesh's run of the same steps, checkpointing every step (`run_mesh`,
whose verdict is printed and whose gate failure is not fatal here).  It
restores the mesh's checkpoint of each step as whole leaves and prints,
per step, the largest params / ``m`` / ``v`` error relative to each
leaf's max |value|, then for every leaf of the last step beyond
``FLOOR`` of its max: how many elements are, and for each step where
those elements' gradient lies among the leaf's and how far the mesh's
gradient and Adam update differ from one process's there (`leaf_gap`).
A param moves by ``lr * m_hat / (sqrt(v_hat) + eps)``; at step 1 that
is ``lr * g / (|g| + eps)``, so an element whose ``|g|`` is near
``eps`` takes a step that follows its gradient's rounding.  Prints the
card's name and power limit
first and one JSON object a line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile

import torch

from repro_torch.checkpoint import restore_checkpoint
from repro_torch.device import exact_matmuls
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.optim import AdamWConfig
from repro_torch.tree import flatten_with_paths

FLOOR = 1e-4            # the float32 tolerance of the repo's parity gates


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype)


def mesh_state(root: str, step: int, cfg) -> dict:
    """The mesh's checkpoint of ``step`` as whole float32 leaves on the
    host, keyed as `launch.train.one_process` saves its state."""
    shapes = api.init_shapes(cfg)
    like = {"params": _zeros(shapes), "opt": {
        "m": _zeros(shapes), "v": _zeros(shapes),
        "step": torch.zeros((), dtype=torch.int32)}}
    tree, _ = restore_checkpoint(root, step, like, device="cpu")
    flat = {"params": tree["params"], "m": tree["opt"]["m"],
            "v": tree["opt"]["v"]}
    return {train._key(p): t.float() for p, t in flatten_with_paths(flat)}


def leaf_gap(key: str, got: torch.Tensor, want: torch.Tensor,
             moments: list, moments_mesh: list, opt: AdamWConfig) -> dict:
    """The elements of one leaf beyond `FLOOR` of its max |value|, and
    for each step k their gradient ``g_k`` (``(m_k - b1 m_(k-1)) / (1 -
    b1)``, clipped) and Adam's update ``u_k = m_hat / (sqrt(v_hat) +
    eps)`` (a param moves by ``lr_k * u_k``), from each step's ``(m,
    v)`` of one process (``moments``) and of the mesh
    (``moments_mesh``): where the elements' ``|g_k|`` lies in the
    leaf's, and how far the two sides' ``g_k`` and ``u_k`` differ
    there."""
    scale = max(float(want.abs().max()), 1e-30)
    over = ((got - want).abs() / scale > FLOOR).flatten()
    out = {"leaf": key, "rel_err": float((got - want).abs().max()) / scale,
           "elements": want.numel(), "over": int(over.sum()), "steps": []}
    prev = prev_mesh = torch.zeros_like(want)
    for k, ((m, v), (mm, vm)) in enumerate(zip(moments, moments_mesh), 1):
        g = ((m - opt.b1 * prev) / (1 - opt.b1)).flatten()
        gm = ((mm - opt.b1 * prev_mesh) / (1 - opt.b1)).flatten()
        prev, prev_mesh = m, mm

        def update(m_, v_):
            return (m_ / (1 - opt.b1 ** k)) / (
                (v_ / (1 - opt.b2 ** k)).sqrt() + opt.eps)
        a, a_over = g.abs(), g.abs()[over]
        out["steps"].append({
            "step": k, "g_abs_median": float(a.median()),
            "g_abs_max": float(a.max()),
            "over_g_abs_median": float(a_over.median()),
            "over_g_abs_max": float(a_over.max()),
            # the share of the leaf's elements whose |g_k| is at most the
            # largest of the elements beyond the floor
            "share_at_or_below": float((a <= a_over.max()).float().mean()),
            "over_g_rel_diff_max": float(
                ((gm - g).abs() / a.clamp(min=1e-30))[over].max()),
            "over_update_diff_max": float(
                (update(mm, vm) - update(m, v)).abs().flatten()[over].max()),
            "update_diff_max_elsewhere": float(
                (update(mm, vm) - update(m, v)).abs().flatten()[~over]
                .max()) if bool((~over).any()) else 0.0})
    return out


def main(argv=None) -> int:
    ns = train.build_parser().parse_args(argv)
    ns.mesh = ns.mesh or "data=2,model=2"
    ns.compute_dtype = "float32"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip() if ns.device != "cpu"
          else "cpu", flush=True)
    opt = AdamWConfig()
    with tempfile.TemporaryDirectory() as tmp:
        ns.ckpt_dir, ns.ckpt_every = f"{tmp}/ckpt", 1
        ns.dist_init = f"file://{tmp}/rendezvous"
        cfg = train.config(ns)
        steps = list(range(1, ns.steps + 1))
        with exact_matmuls():
            yardstick = train.one_process(ns, cfg, compared=steps)
            try:
                train.run_mesh(ns, yardstick=yardstick)
                verdict = "held"
            except AssertionError:
                verdict = "failed"
        print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers,
                          "mesh": ns.mesh, "steps": ns.steps,
                          "run_mesh_gates": verdict}), flush=True)
        got = {s: mesh_state(ns.ckpt_dir, s, cfg) for s in steps}
        want = {s: {k: t.cpu() for k, t in yardstick["states"][s].items()}
                for s in steps}
        del yardstick
        for step in steps:
            worst: dict = {}
            for key, w in want[step].items():
                kind = key.split("/")[0]
                e = float((got[step][key] - w).abs().max()) \
                    / max(float(w.abs().max()), 1e-30)
                if e >= worst.get(kind, (0.0, ""))[0]:
                    worst[kind] = (e, key)
            print(json.dumps({"step": step, "worst": worst}), flush=True)
        last = steps[-1]
        for key, w in want[last].items():
            if float((got[last][key] - w).abs().max()) \
                    <= FLOOR * max(float(w.abs().max()), 1e-30):
                continue
            leaf = key.split("/", 1)[1]
            print(json.dumps(leaf_gap(
                key, got[last][key], w,
                [(want[s][f"m/{leaf}"], want[s][f"v/{leaf}"]) for s in steps],
                [(got[s][f"m/{leaf}"], got[s][f"v/{leaf}"]) for s in steps],
                opt)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
