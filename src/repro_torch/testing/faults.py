"""Fault injectors for the chaos tests — counterpart of
`repro.testing.faults`.

Each injector makes exactly the damage one guard layer is built to catch:

* `corrupt_tile_encoding`  — structural plan damage -> `guard.validate_plan`
* `corrupt_scales`         — block-quant scale poison (NaN / zero) ->
  `guard.validate_plan`'s ``scale`` checks and the ``--guard`` NaN
  quarantine
* `inject_nan_output`      — weight poison -> ``serve --guard``'s NaN
  bisection and quarantine, and serve's parity gate
* `scale_values`           — finite wrong values -> serve's parity gate
* `truncate_shard` / `bit_flip_shard` — checkpoint damage against the CRC
  manifest -> `CheckpointManager.restore_latest`'s fallback
* `poison_autotune_entry`  — cache damage -> `autotune.resolve_blocks`
  degrading to the static model
* `force_impl_failure`     — dispatch exceptions at a rung's fault site
  (`kernels.ops._FORCED_FAULTS`) -> `guard.harden_plan`'s ladder

A plan injector returns a rebuilt plan and never mutates its input; the
filesystem injectors damage files in place, as real corruption would.

On a GPU a structurally corrupt encoding (`corrupt_tile_encoding`'s
``index_oob`` / ``count_overflow``) must never reach a kernel: the guard
validates before any launch (`guard.probe_layer`).  Drive those on the CPU;
on the card drive the guard with `force_impl_failure` and NaN injection.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
from typing import Callable, Iterator, Tuple

import torch

from ..core.pruning import BalancedSparse
from ..engine.plan import LayerPlan, ModelPlan
from ..kernels import ops as kernel_ops
from ..kernels.tile_format import TiledBalanced

TILE_FAULTS = ("index_oob", "count_overflow", "nan", "imbalance")
SCALE_FAULTS = ("nan", "zero")
FAULT_SITES = ("cuda", "xla", "xla_gather", "xla_decode", "cuda_decode")


def _pick_sparse(plan: ModelPlan, layer: str | None, want=None) -> str:
    names = sorted(nm for nm, lp in plan.layers.items()
                   if lp.spec.is_sparse
                   and (want is None or isinstance(lp.weights, want)))
    if layer is not None:
        if layer not in plan.layers:
            raise KeyError(f"no layer {layer!r} in plan")
        return layer
    if not names:
        raise ValueError("plan has no sparse layer to corrupt")
    return names[len(names) // 2]


def _replace_layer(plan: ModelPlan, name: str, lp: LayerPlan) -> ModelPlan:
    layers = dict(plan.layers)
    layers[name] = lp
    return ModelPlan(layers=layers, meta=plan.meta)


def corrupt_tile_encoding(plan: ModelPlan, layer: str | None = None,
                          kind: str = "index_oob"
                          ) -> Tuple[ModelPlan, str]:
    """Damage one sparse layer's encoding as a bad checkpoint or a buggy
    encoder would: ``index_oob`` (a column index outside its range),
    ``count_overflow`` (a tile count above KB), ``nan`` (a non-finite
    value), ``imbalance`` (row 0 one NZE short; tiled encodings only).
    Returns ``(corrupted_plan, layer_name)``."""
    if kind not in TILE_FAULTS:
        raise ValueError(f"kind must be one of {TILE_FAULTS}, got {kind!r}")
    name = _pick_sparse(plan, layer)
    lp = plan.layers[name]
    w = lp.weights
    if isinstance(w, TiledBalanced):
        vals, idx, cnt = w.values.clone(), w.indices.clone(), \
            w.counts.clone()
        if kind == "index_oob":
            idx.view(-1)[0] = w.bn + 3
        elif kind == "count_overflow":
            cnt.view(-1)[0] = w.values.shape[-1] + 1
        elif kind == "nan":
            if not vals.is_floating_point():
                raise ValueError(f"{name}: quantized values cannot hold "
                                 "NaN (corrupt_scales poisons the scales)")
            vals.view(-1)[0] = float("nan")
        else:  # imbalance: row 0 one NZE short of the rest
            flat = cnt.view(-1, cnt.shape[-1])
            nz = torch.nonzero(flat[0]).flatten()
            if not nz.numel():
                raise ValueError(f"{name}: row 0 has no NZE to drop")
            flat[0, nz[0]] -= 1
        new = dataclasses.replace(w, values=vals, indices=idx, counts=cnt)
    elif isinstance(w, BalancedSparse):
        if kind in ("count_overflow", "imbalance"):
            raise ValueError(f"kind {kind!r} needs a tiled encoding; layer "
                             f"{name!r} holds the flat format")
        vals, idx = w.values.clone(), w.indices.clone()
        if kind == "index_oob":
            idx.view(-1)[0] = w.n_in + 7
        else:
            vals.view(-1)[0] = float("inf")
        new = BalancedSparse(vals, idx, w.n_in)
    else:
        raise ValueError(f"layer {name!r} holds dense weights — nothing "
                         "encoded to corrupt")
    return _replace_layer(plan, name, LayerPlan(spec=lp.spec, weights=new)), \
        name


def corrupt_scales(plan: ModelPlan, layer: str | None = None,
                   kind: str = "nan") -> Tuple[ModelPlan, str]:
    """Poison one quantized layer's per-block dequant scales: ``nan`` a
    quarter of them (every dequant through them gives NaN; ``scale``
    finiteness), ``zero`` a quarter of the live nonzero ones (silently
    wrong numbers, but an encoding the quantizer never emits; ``scale``
    zero-consistency).  Returns ``(corrupted_plan, layer_name)``."""
    if kind not in SCALE_FAULTS:
        raise ValueError(f"kind must be one of {SCALE_FAULTS}, got {kind!r}")
    if layer is None:
        names = sorted(nm for nm, lp in plan.layers.items()
                       if isinstance(lp.weights, TiledBalanced)
                       and lp.weights.quant != "none")
        if not names:
            raise ValueError("plan has no quantized layer to corrupt")
        name = names[len(names) // 2]
    else:
        name = _pick_sparse(plan, layer)
    lp = plan.layers[name]
    w = lp.weights
    if not isinstance(w, TiledBalanced) or w.quant == "none" \
            or w.scales is None:
        raise ValueError(f"layer {name!r} carries no block-quant scales")
    s = w.scales.float().clone()
    flat = s.view(-1)
    if kind == "nan":
        flat[:max(1, flat.numel() // 4)] = float("nan")
    else:
        cnt = w.counts.reshape(-1)
        live = torch.nonzero((cnt > 0) & (flat > 0)).flatten()
        if not live.numel():
            raise ValueError(f"layer {name!r} has no live nonzero-scale "
                             "block to zero")
        flat[live[:max(1, live.numel() // 4)]] = 0.0
    new = dataclasses.replace(w, scales=s)
    return _replace_layer(plan, name, LayerPlan(spec=lp.spec, weights=new)), \
        name


def _map_values(w, fn, index: int | None):
    """``w`` with ``fn`` applied to its values (the scales of a quantized
    encoding: integers hold no NaN), on stacked layer ``index`` alone when
    given."""
    def apply(t):
        if index is None:
            return fn(t)
        t = t.clone()
        t[index] = fn(t[index])
        return t
    if isinstance(w, TiledBalanced) and w.quant != "none":
        return dataclasses.replace(w, scales=apply(w.scales))
    if isinstance(w, (TiledBalanced, BalancedSparse)):
        return dataclasses.replace(w, values=apply(w.values))
    return apply(w)


def inject_nan_output(plan: ModelPlan, layer: str | None = None, *,
                      index: int | None = None) -> Tuple[ModelPlan, str]:
    """Poison every encoded value of one sparse layer with NaN (the scales
    of a quantized one: integers hold no NaN), so its output and every
    downstream logit go non-finite while the encoding stays structurally
    valid; with ``index``, only stacked layer ``index`` of it.  Returns
    ``(poisoned_plan, name)``."""
    name = _pick_sparse(plan, layer)
    lp = plan.layers[name]
    new = _map_values(lp.weights, lambda t: torch.full_like(t, float("nan")),
                      index)
    return _replace_layer(plan, name, LayerPlan(spec=lp.spec, weights=new)), \
        name


def scale_values(plan: ModelPlan, layer: str | None = None, *,
                 index: int | None = None) -> Tuple[ModelPlan, str]:
    """Double one sparse layer's encoded values (a quantized one's
    scales), on stacked layer ``index`` alone when given: a finite,
    structurally valid encoding whose numbers are wrong, which only a
    parity check against the reference can catch.  Returns
    ``(corrupted_plan, name)``."""
    name = _pick_sparse(plan, layer)
    lp = plan.layers[name]
    new = _map_values(lp.weights, lambda t: t * 2, index)
    return _replace_layer(plan, name, LayerPlan(spec=lp.spec, weights=new)), \
        name


# ---------------------------------------------------------------------------
# Checkpoint damage
# ---------------------------------------------------------------------------

def _pick_shard(root, step: int | None) -> pathlib.Path:
    from ..checkpoint import store
    root = pathlib.Path(root)
    if step is None:
        step = store.latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = root / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    leaves = sorted(manifest["leaves"].items())
    if not leaves:
        raise ValueError(f"{d.name}: manifest lists no leaves")
    return d / leaves[len(leaves) // 2][1]["file"]


def truncate_shard(root, step: int | None = None) -> pathlib.Path:
    """Cut one shard of the (newest by default) checkpoint to half its
    size, as a crash or a partial copy would.  Returns the damaged path."""
    shard = _pick_shard(root, step)
    size = shard.stat().st_size
    with open(shard, "r+b") as f:
        f.truncate(max(1, size // 2))
    return shard


def bit_flip_shard(root, step: int | None = None) -> pathlib.Path:
    """Flip one payload bit in one shard: silent media corruption, which
    the CRC manifest exists to catch.  Returns the damaged path."""
    shard = _pick_shard(root, step)
    data = bytearray(shard.read_bytes())
    # past the .npy header, inside the array payload
    data[len(data) // 2 + len(data) // 4] ^= 0x10
    shard.write_bytes(bytes(data))
    return shard


# ---------------------------------------------------------------------------
# Autotune-cache damage
# ---------------------------------------------------------------------------

def poison_autotune_entry(path, key: str | None = None) -> str:
    """Garble one entry (by default every entry) of an autotune cache as a
    bad hand edit would: block fields replaced with garbage while the file
    stays valid JSON.  `autotune.resolve_blocks` must read it as a miss.
    Returns the poisoned key (or ``"*"``)."""
    from ..kernels import autotune
    path = pathlib.Path(path)
    doc = json.loads(path.read_text())
    entries = doc.get("entries", {})
    if key is not None:
        if key not in entries:
            raise KeyError(f"no cache entry {key!r} in {path}")
        targets = [key]
    else:
        targets = list(entries)
    for k in targets:
        entries[k] = dict(entries[k], bm="garbage", bo=-4, bn=None)
    path.write_text(json.dumps(doc))
    autotune._READ_MEMO.pop(str(path), None)
    return key if key is not None else "*"


# ---------------------------------------------------------------------------
# Forced dispatch failure
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def force_impl_failure(*impls: str,
                       when: Callable[[dict], bool] | None = None
                       ) -> Iterator[None]:
    """Arm `kernel_ops` fault sites so the named rungs raise
    `ops.InjectedKernelFault` at dispatch: the stand-in for a kernel that
    fails to build or launch.  ``when(ctx)`` narrows the trip (the ``cuda``
    sites pass ``bm``, ``bo``, ``bn``; batched dispatches ``batched=True``).
    ``xla_decode`` / ``cuda_decode`` trip only the skinny-M branches of
    their rungs.  The previous arming is restored on exit."""
    for impl in impls:
        if impl not in FAULT_SITES:
            raise ValueError(f"no fault site for impl {impl!r} "
                             f"(valid: {FAULT_SITES})")
    pred = when if when is not None else (lambda ctx: True)
    prev = dict(kernel_ops._FORCED_FAULTS)
    kernel_ops._FORCED_FAULTS.update({impl: pred for impl in impls})
    try:
        yield
    finally:
        kernel_ops._FORCED_FAULTS.clear()
        kernel_ops._FORCED_FAULTS.update(prev)


__all__ = ["TILE_FAULTS", "SCALE_FAULTS", "FAULT_SITES",
           "corrupt_tile_encoding", "corrupt_scales", "inject_nan_output",
           "truncate_shard", "bit_flip_shard", "poison_autotune_entry",
           "force_impl_failure"]
