"""Meta-device dry run of every (arch x shape) cell — counterpart of
`repro.launch.dryrun`.

The reference lowers and compiles each cell for its production TPU mesh
and reads the compiled module's cost.  The port builds each cell's step
on PyTorch's ``meta`` device instead: tensors with shapes and dtypes and
no storage, so a 104B-parameter train step or a 32768-token prefill runs
its Python in seconds without a byte of memory.  The step is the
reference's (``build_cell``): train (the loss, its gradients through
autograd and one AdamW update, ``grad_accum`` microbatches), prefill or
decode (one token against a cache of the shape's length).  Parameters
come from `models.api.init_shapes` and inputs from `models.api
.input_specs`.

Each record holds:

* ``bytes`` — parameters, optimizer state (train), gradients (train) and
  cache (decode: the cache the step reads; prefill: the one it returns),
  exact sums over the meta tensors (`cost_model.dtype_bytes`);
* ``flops`` — the step's matmul FLOPs from
  `torch.utils.flop_counter.FlopCounterMode` (mm / bmm / addmm and the
  einsums that lower to them; elementwise work is not counted), with the
  prefill attention's skipped kv chunks never run, so not counted;
* ``collectives`` — 0 (one device);
* ``model_flops`` — the reference's analytical count (`model_flops`, the
  same arithmetic);
* ``fits_one_card`` — the resident state (the bytes above and the inputs)
  against `launch.mesh.HBM_BYTES`: a necessary condition, since
  activations and temporaries have no allocator on ``meta``;
* ``roofline`` — the FLOPs over the bf16 peak and the resident bytes over
  the memory rate of one H100 (`launch.mesh`).

With ``--production-mesh`` (the reference's one pod, ``pod16x16``: 16 x 16
over ``(data, model)``) or ``--multi-pod`` (``pod2x16x16``: 2 x 16 x 16
over ``(pod, data, model)``) a cell's id and ``mesh`` carry that tag, and
its record swaps the one-card fields (``fits_one_card``, ``roofline``,
``n_devices``, ``collectives``) for the reference's production-mesh view,
host arithmetic over its sharding rules (no device is involved):

* ``n_chips`` — the mesh's size;
* ``per_device`` — each part's bytes on one device: params by the
  family's ``param_specs``, the AdamW moments by the same specs and the
  step count replicated (the reference's ``opt_sh``), grads by the param
  specs, the cache by ``cache_specs``, inputs by
  `models.api.batch_partition_spec` (each leaf's
  `distributed.sharding.shard_shape`);
* ``resident_bytes_per_device`` and ``fits_hbm`` — their sum against one
  H100's `launch.mesh.HBM_BYTES`, the same necessary condition as
  ``fits_one_card``;
* ``flops_per_device`` and ``collectives`` — null, with the reason in
  ``per_device_null_reason``: both are properties of the SPMD program the
  reference's compiler partitions for the mesh, which the port does not
  build.  The global ``flops`` stay as the meta run counts them.

The reference's ``launch/hlo_cost.py`` (a walker over compiled HLO text)
has no port: the port emits no HLO, and the flop counter takes its role.
The recurrent families at ``prefill_32k``, ``decode_32k`` and
``long_500k`` run at the reference's own variant ``v_ssm_mode=chunked``
(the per-token scan would be ``seq_len x n_layers`` Python steps; both
packages hold the two forms equal) and the record names the variant.  A
cell whose step cannot be built on ``meta`` is recorded with ``status:
"error"`` and its reason, as the reference records a cell that fails to
compile.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape prefill_32k [--batch 1] [--variant v0_baseline]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        [--production-mesh | --multi-pod]

Records are written to ``dryrun_torch/<cell>.json`` at the repository root
(``--out`` for another directory), one file per cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, SHAPES, ShapeSpec, get_config, get_smoke, \
    shape_applicable
from ..distributed.sharding import P, shard_shape
from ..models import build_model
from ..models.api import (batch_partition_spec, cache_specs, init_shapes,
                          input_specs, param_specs)
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..tree import flatten_with_paths, leaves, tree_map, unflatten
from . import cost_model
from .mesh import HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16, make_production_mesh

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_torch"
MESH_TAG = "gpu1"
# the reference's production meshes: tag -> multi_pod
PRODUCTION_MESHES = {"pod16x16": False, "pod2x16x16": True}
SPMD_REASON = ("per-device FLOPs and collective bytes are properties of the "
               "SPMD program the reference's compiler partitions for this "
               "mesh; the port builds no such program, so they are not "
               "derived (null, not 0)")
META = torch.device("meta")
# the recurrent families' long cells run the chunked forms
CHUNKED_CELLS = ("prefill_32k", "decode_32k", "long_500k")
CHUNKED_VARIANT = "v_ssm_mode=chunked"


def model_flops(arch: str, shape_name: str) -> float:
    """Analytical model FLOPs (global) — the reference's arithmetic: 6 N D
    for training, 2 N D for inference, plus the attention's quadratic term;
    N = active non-embedding parameters."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_total = cfg.param_count() - cfg.vocab_size * cfg.d_model
    if cfg.family == "moe":
        # active = shared + top_k of routed experts
        d, f, l = cfg.d_model, cfg.d_ff, cfg.n_layers
        routed_all = cfg.n_experts * 3 * d * f
        routed_act = cfg.top_k * 3 * d * f
        n_total = n_total - l * routed_all + l * routed_act
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "ssm":
        attn_layers = 0
    elif cfg.family == "hybrid":
        attn_layers = -(-cfg.n_layers // max(cfg.attn_every, 1))
    else:
        attn_layers = cfg.n_layers
    if shape.kind == "train":
        tokens = b * s
        return (6.0 * n_total * tokens
                + 6.0 * attn_layers * b * s * s * cfg.n_heads * cfg.head_dim)
    if shape.kind == "prefill":
        tokens = b * s
        return (2.0 * n_total * tokens
                + 2.0 * attn_layers * b * s * s * cfg.n_heads * cfg.head_dim)
    # decode: one token per sequence against an S-long cache
    base = 2.0 * n_total * b
    if cfg.family == "ssm":
        attn = 0.0
    elif cfg.family == "hybrid":
        n_attn = -(-cfg.n_layers // max(cfg.attn_every, 1))
        attn = 4.0 * n_attn * b * s * cfg.n_heads * cfg.head_dim
    else:
        attn = 4.0 * cfg.n_layers * b * s * cfg.n_heads * cfg.head_dim
    return base + attn


def apply_variant(cfg, variant: str):
    """The reference's variants: ``v0_baseline``, ``v1_sparse_serving``
    and ``v_key=value,key=value`` config overrides."""
    if variant in ("v0_baseline", ""):
        return cfg
    if variant == "v1_sparse_serving":
        return dataclasses.replace(cfg, sparse_serving=True)
    if variant.startswith("v_"):
        kvs = dict(kv.split("=") for kv in variant[2:].split(","))
        typed = {}
        for k, v in kvs.items():
            cur = getattr(cfg, k)
            typed[k] = (v.lower() in ("1", "true") if isinstance(cur, bool)
                        else type(cur)(v))
        return dataclasses.replace(cfg, **typed)
    raise ValueError(f"unknown variant {variant}")


def cell_variant(cfg, shape_name: str, variant: str) -> str:
    """The variant a cell runs at: the recurrent families' long cells at
    `CHUNKED_VARIANT` unless another variant was asked for."""
    if variant in ("v0_baseline", "") and shape_name in CHUNKED_CELLS \
            and cfg.family in ("ssm", "hybrid"):
        return CHUNKED_VARIANT
    return variant


def tree_bytes(tree) -> int:
    """Exact bytes of a tree of tensors (`cost_model.dtype_bytes`)."""
    return int(sum(t.numel() * cost_model.dtype_bytes(t.dtype)
                   for t in leaves(tree) if torch.is_tensor(t)))


def _spec_paths(specs) -> dict:
    """``{key path: P}`` of a tree of specs (a spec is a leaf)."""
    if isinstance(specs, dict):
        return {(k,) + p: v for k in specs
                for p, v in _spec_paths(specs[k]).items()}
    return {(): specs}


def shard_bytes(mesh, tree, specs) -> int:
    """Bytes of one device's shards of a tree of tensors laid out by the
    matching tree of specs (`distributed.sharding.shard_shape`)."""
    by_path = _spec_paths(specs)
    total = 0
    for path, t in flatten_with_paths(tree):
        shard = shard_shape(mesh, tuple(t.shape), by_path[path])
        total += math.prod(shard) * cost_model.dtype_bytes(t.dtype)
    return int(total)


def cache_shapes(cfg, batch_size: int, max_len: int) -> dict:
    """The one-device decode cache of ``batch_size`` sequences of
    ``max_len`` as ``meta`` tensors, for every family: the transformer's
    KV planes, rwkv6's token-shift and WKV states, zamba2's SSM and conv
    states and its shared block's KV.  `shard_bytes` of it under the
    bundle's ``cache_specs`` is one device's cache of a mesh (zamba2's KV
    split by sequence over ``model`` included)."""
    return build_model(cfg, META).init_cache(batch_size, max_len)


def per_device_bytes(cfg, shape: ShapeSpec, mesh, state: dict,
                     out: dict) -> dict:
    """Each resident part's bytes on one device of ``mesh`` under the
    reference's specs: params and grads by ``param_specs``, the AdamW
    moments likewise with the step replicated, the cache (decode: the one
    the step reads; prefill: the one it returns) by ``cache_specs``, the
    inputs by ``batch_partition_spec``."""
    pspecs = param_specs(cfg, mesh)
    opt = state.get("opt")
    cache = state.get("cache") if shape.kind == "decode" \
        else out.get("cache")
    return {
        "param_bytes": shard_bytes(mesh, state["params"], pspecs),
        "opt_bytes": 0 if opt is None else shard_bytes(
            mesh, opt, {"m": pspecs, "v": pspecs, "step": P()}),
        "grad_bytes": 0 if out.get("grads") is None
        else shard_bytes(mesh, out["grads"], pspecs),
        "cache_bytes": 0 if cache is None else shard_bytes(
            mesh, cache, cache_specs(cfg, mesh, shape.global_batch)),
        "input_bytes": shard_bytes(mesh, state["inputs"],
                                   batch_partition_spec(cfg, shape, mesh)),
    }


def build_cell(cfg, shape: ShapeSpec):
    """``(step, state)``: ``step()`` runs the cell's step on ``meta`` and
    returns the tensors it produced; ``state`` the resident tensors by
    role (``params``, ``inputs``, and ``opt`` / ``cache``)."""
    bundle = build_model(cfg, META)
    params = init_shapes(cfg)
    batch = input_specs(cfg, shape)
    state = {"params": params, "inputs": batch}

    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        opt = adamw_init(params)
        state["opt"] = opt
        accum = max(1, cfg.grad_accum)

        def train_step():
            grads = None
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                live = tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
                loss = bundle.train_loss(live, mb)
                g = torch.autograd.grad(loss, leaves(live),
                                        allow_unused=True)
                g = [torch.zeros_like(p) if x is None else x
                     for p, x in zip(leaves(live), g)]
                grads = g if grads is None else [a + b for a, b in
                                                 zip(grads, g)]
            grads = unflatten(params, [g / accum for g in grads])
            new_p, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                                   opt)
            return {"params": new_p, "opt": new_opt, "grads": grads,
                    "loss": loss.detach(), "grad_norm": metrics["grad_norm"]}
        return train_step, state

    if shape.kind == "prefill":
        def prefill_step():
            with torch.no_grad():
                logits, cache = bundle.prefill(params, batch)
            return {"logits": logits, "cache": cache}
        return prefill_step, state

    cache = bundle.init_cache(shape.global_batch, shape.seq_len)
    state["cache"] = cache

    def decode_step():
        with torch.no_grad():
            logits, new_cache = bundle.decode_step(params, batch, cache)
        return {"logits": logits, "cache": new_cache}
    return decode_step, state


def run_cell(arch: str, shape_name: str, *, variant: str = "v0_baseline",
             batch: int | None = None, seq_len: int | None = None,
             smoke: bool = False, out_dir: Path | None = None,
             save: bool = True, mesh_tag: str = MESH_TAG) -> dict:
    """Build and run one cell on ``meta``; returns (and saves) its record.
    ``batch`` / ``seq_len`` cut the shape (named in the cell id),
    ``smoke`` takes the arch's smoke config, ``mesh_tag`` one of
    `PRODUCTION_MESHES` records the cell on that mesh (default: one
    card)."""
    if mesh_tag != MESH_TAG and mesh_tag not in PRODUCTION_MESHES:
        raise ValueError(f"mesh_tag must be {MESH_TAG!r} or one of "
                         f"{sorted(PRODUCTION_MESHES)}, got {mesh_tag!r}")
    cfg = get_smoke(arch) if smoke else get_config(arch)
    variant = cell_variant(cfg, shape_name, variant)
    shape = SHAPES[shape_name]
    cut = ""
    if batch is not None and batch != shape.global_batch:
        cut += f"_b{batch}"
    if seq_len is not None and seq_len != shape.seq_len:
        cut += f"_s{seq_len}"
    shape = dataclasses.replace(
        shape, global_batch=batch or shape.global_batch,
        seq_len=seq_len or shape.seq_len)
    cell_id = (f"{arch}{'-smoke' if smoke else ''}__{shape_name}{cut}__"
               f"{mesh_tag}__{variant}")
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        rec = {"cell": cell_id, "status": "skipped", "reason": why}
        if save:
            _save(cell_id, rec, out_dir)
        return rec
    t0 = time.time()
    try:
        cfg = apply_variant(cfg, variant)
        step, state = build_cell(cfg, shape)
        with FlopCounterMode(display=False) as counter:
            out = step()
        flops = float(counter.get_total_flops())
        by_op = {str(op): float(n) for op, n in
                 counter.get_flop_counts().get("Global", {}).items()}
        mem = {"param_bytes": tree_bytes(state["params"]),
               "input_bytes": tree_bytes(state["inputs"]),
               "opt_bytes": tree_bytes(state.get("opt")),
               "grad_bytes": tree_bytes(out.get("grads")),
               "cache_bytes": tree_bytes(state.get("cache")
                                         if shape.kind == "decode"
                                         else out.get("cache")),
               "output_bytes": tree_bytes(out)}
        resident = (mem["param_bytes"] + mem["input_bytes"]
                    + mem["opt_bytes"] + mem["grad_bytes"]
                    + mem["cache_bytes"])
        t_compute = flops / PEAK_FLOPS_BF16
        t_memory = resident / HBM_BW
        mf = model_flops(arch, shape_name) if not (smoke or cut) else None
        rec = {
            "cell": cell_id, "arch": arch, "shape": shape_name,
            "kind": shape.kind, "batch": shape.global_batch,
            "seq_len": shape.seq_len, "smoke": smoke, "mesh": MESH_TAG,
            "variant": variant, "status": "ok", "n_devices": 1,
            "build_s": time.time() - t0,
            "flops": flops, "flops_by_op": by_op,
            "collectives": {"total_bytes": 0, "op_counts": {}},
            "memory": mem, "resident_bytes": resident,
            "fits_one_card": bool(resident <= HBM_BYTES),
            "hbm_bytes": HBM_BYTES,
            "model_flops": mf,
            "model_flops_ratio": (mf / flops if mf and flops else None),
            "roofline": {"compute_s": t_compute, "memory_s": t_memory,
                         "bound_s": max(t_compute, t_memory),
                         "dominant": ("compute" if t_compute >= t_memory
                                      else "memory")},
        }
        if mesh_tag in PRODUCTION_MESHES:
            mesh = make_production_mesh(multi_pod=PRODUCTION_MESHES[mesh_tag])
            per_dev = per_device_bytes(cfg, shape, mesh, state, out)
            for key in ("n_devices", "collectives", "fits_one_card",
                        "roofline"):
                del rec[key]
            resident_dev = sum(per_dev.values())
            rec.update({
                "mesh": mesh_tag, "n_chips": mesh.size,
                "per_device": per_dev,
                "resident_bytes_per_device": resident_dev,
                "fits_hbm": bool(resident_dev <= HBM_BYTES),
                "flops_per_device": None, "collectives": None,
                "per_device_null_reason": SPMD_REASON})
    except Exception as e:  # noqa: BLE001 — a failing cell is a record
        rec = {"cell": cell_id, "arch": arch, "shape": shape_name,
               "variant": variant, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    if save:
        _save(cell_id, rec, out_dir)
    return rec


def _save(cell_id: str, rec: dict, out_dir: Path | None) -> None:
    d = Path(out_dir) if out_dir is not None else RESULTS_DIR
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{cell_id}.json").write_text(json.dumps(rec, indent=1) + "\n")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--variant", default="v0_baseline")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch to this")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="cut the shape's sequence length to this")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {RESULTS_DIR})")
    meshes = ap.add_mutually_exclusive_group()
    meshes.add_argument("--production-mesh", action="store_true",
                        help="record per-device bytes on the reference's "
                             "one-pod mesh (pod16x16) instead of one card")
    meshes.add_argument("--multi-pod", action="store_true",
                        help="the same on the reference's two-pod mesh "
                             "(pod2x16x16)")
    args = ap.parse_args(argv)
    mesh_tag = "pod2x16x16" if args.multi_pod else \
        "pod16x16" if args.production_mesh else MESH_TAG
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    recs = []
    for arch, shape in cells:
        rec = run_cell(arch, shape, variant=args.variant, batch=args.batch,
                       seq_len=args.seq_len, smoke=args.smoke,
                       out_dir=args.out, mesh_tag=mesh_tag)
        recs.append(rec)
        if rec["status"] == "ok" and "per_device" in rec:
            print(f"[ok] {rec['cell']}: {rec['build_s']:.1f} s, flops "
                  f"{rec['flops']:.4e} (global), per device "
                  f"{rec['per_device']}, resident "
                  f"{rec['resident_bytes_per_device']} B of "
                  f"{rec['n_chips']} chips, fits_hbm={rec['fits_hbm']}",
                  flush=True)
        elif rec["status"] == "ok":
            m = rec["memory"]
            print(f"[ok] {rec['cell']}: {rec['build_s']:.1f} s, flops "
                  f"{rec['flops']:.4e} (model {rec['model_flops']}), params "
                  f"{m['param_bytes']} B, opt {m['opt_bytes']} B, cache "
                  f"{m['cache_bytes']} B, resident {rec['resident_bytes']} B,"
                  f" fits_one_card={rec['fits_one_card']}", flush=True)
        elif rec["status"] == "skipped":
            print(f"[skipped] {rec['cell']}: {rec['reason']}", flush=True)
        else:
            print(f"[error] {rec['cell']}: {rec['error']}", flush=True)
    return recs


if __name__ == "__main__":
    main()
