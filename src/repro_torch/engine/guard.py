"""Guarded execution: plan validation, the impl-fallback ladder, and
runtime NaN quarantine — counterpart of `repro.engine.guard`.

* `validate_plan` — structural invariants of every LayerPlan (index
  ranges, tile counts against capacity, the equal-NZE balance invariant,
  block shapes, finite values, quantization, packing, dtype / shape
  agreement, the cost tag's byte counts), as a typed per-layer
  `PlanReport`; strict mode raises `PlanValidationError` naming the layer
  and check.  An optional probe pass checks each layer's planned path
  against its own densified weights.
* `harden_plan` — the degradation ladder (`execute.IMPL_LADDER`: cuda ->
  xla -> xla_gather -> dense).  Each layer's rung is probed alone; on a
  failed probe a ``cuda`` layer first retries once with halved (bm, bo),
  then the layer steps down until a rung passes.  Demotions are recorded in the
  plan (``spec.degraded_from``, meta key ``degraded``) and tick
  ``degraded_dispatch`` in `execute.STATS` on every dispatch.
* `locate_poisoned` / `quarantine_layers` — the runtime NaN guard: bisect
  the plan's sparse layers to the one(s) that poison the logits and flip
  them to dense (a known-good reference weight preferred).

On a GPU a structurally broken encoding (an index out of its block, a
count over the block's capacity) would make the kernels read out of
bounds, and the eager rungs' gathers trip a device-side assert that
poisons the CUDA context for the rest of the process: an exception there
cannot be caught and degraded around.  So nothing here launches a kernel
on a layer `validate_layer` flags: `probe_layer` and `harden_plan`
validate first and raise `PlanValidationError` naming the layer.

Differences from the reference: (1) its probe also fails a Pallas layer
whose modeled VMEM footprint trips the TPU's budget; that model has no
meaning for the CUDA kernels, so there is no such precheck here and only a
failed probe halves the blocks.  (2) Its probe demotes a layer on any
exception; here a ``cuda`` layer's probe fails only on an
`InjectedKernelFault` (`testing.faults.force_impl_failure`), a non-finite
output or a parity miss, and any other exception on that rung (a kernel
that does not build, does not launch, or refuses its blocks) raises
`GuardError` naming the layer: the ladder never hides a broken kernel
behind its plain version.  The checks run as tensor ops on the weights'
device, in chunks.  The ladder runs only when the caller asks for it
(``serve --guard``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from ..core.pruning import BalancedSparse
from ..kernels import ops as kernel_ops
from ..kernels.tile_format import TiledBalanced, unpack_int4
from ..launch import cost_model as _cost
from . import execute
from .plan import LayerPlan, ModelPlan

Tensor = torch.Tensor

# elements per chunk of the checks' transients
_CHECK_CHUNK = 1 << 26

_INT_DTYPES = (torch.int8, torch.uint8, torch.int16, torch.int32,
               torch.int64)


class GuardError(RuntimeError):
    """A fault the guard cannot degrade around (names the component)."""


class PlanValidationError(ValueError):
    """Strict validation failure; carries the full `PlanReport`."""

    def __init__(self, report: "PlanReport"):
        self.report = report
        bad = [lr for lr in report.layers.values() if not lr.ok]
        lines = [f"plan validation failed on {len(bad)} layer(s):"]
        for lr in bad:
            for v in lr.violations:
                lines.append(f"  layer {lr.name!r} [{lr.impl}] "
                             f"check={v.check}: {v.detail}")
            if lr.probe_error:
                lines.append(f"  layer {lr.name!r} [{lr.impl}] "
                             f"probe: {lr.probe_error}")
        super().__init__("\n".join(lines))


@dataclasses.dataclass(frozen=True)
class Violation:
    """One failed structural check on one layer."""
    layer: str
    check: str      # index_range | count_capacity | balance | block_shape |
                    # finite | dtype | weights_type | shape | perm |
                    # quant | scale | cost_*
    detail: str


@dataclasses.dataclass
class LayerReport:
    name: str
    impl: str
    violations: Tuple[Violation, ...] = ()
    probe_max_diff: float | None = None   # probe: max |planned - dense|
    probe_error: str | None = None        # probe raised / exceeded tol

    @property
    def ok(self) -> bool:
        return not self.violations and self.probe_error is None


@dataclasses.dataclass
class PlanReport:
    """Typed per-layer validation result (`validate_plan`)."""
    layers: Dict[str, LayerReport]

    @property
    def ok(self) -> bool:
        return all(lr.ok for lr in self.layers.values())

    def violations(self) -> Tuple[Violation, ...]:
        return tuple(v for lr in self.layers.values() for v in lr.violations)

    def summary(self) -> str:
        bad = sum(1 for lr in self.layers.values() if not lr.ok)
        if not bad:
            return f"plan valid: {len(self.layers)} layer(s) checked"
        return (f"plan INVALID: {bad}/{len(self.layers)} layer(s) failed — "
                + "; ".join(f"{lr.name}:{v.check}"
                            for lr in self.layers.values()
                            for v in lr.violations)
                + "".join(f"; {lr.name}:probe" for lr in self.layers.values()
                          if lr.probe_error))


@dataclasses.dataclass(frozen=True)
class Degradation:
    """One ladder event of `harden_plan`."""
    layer: str
    from_impl: str
    to_impl: str
    action: str     # "halved_blocks" | "demoted"
    reason: str


# ---------------------------------------------------------------------------
# Structural validation
# ---------------------------------------------------------------------------

def _pow2_ge8(x: int) -> bool:
    return x >= 8 and (x & (x - 1)) == 0


def _rows(t: Tensor, width: int, step: int | None = None):
    """Chunks of the rows of ``t`` viewed as ``[-1, width]``, ``step``
    rows each (default: `_CHECK_CHUNK` elements)."""
    flat = t.reshape(-1, width)
    step = step or max(1, _CHECK_CHUNK // max(width, 1))
    for i in range(0, flat.shape[0], step):
        yield flat[i:i + step]


def _all_finite(t: Tensor) -> bool:
    if not t.is_floating_point():
        return True
    return all(bool(torch.isfinite(c).all()) for c in _rows(t, t.shape[-1]))


def _check_blocks(spec, add) -> None:
    c = spec.blocks
    if c is None:
        add("block_shape", "sparse impl with no BlockChoice")
        return
    for f in ("bm", "bo", "bn"):
        v = getattr(c, f)
        if not _pow2_ge8(v):
            add("block_shape", f"{f}={v} is not a power of two >= 8")


def _check_quant(quant: str, vals: Tensor, cnt: Tensor, scales, kb: int,
                 add) -> bool:
    """The quantized encoding's invariants: scales present, of the counts'
    shape, finite and >= 0; the narrow dtype; q in the symmetric range; no
    live q against a zero scale (the quantizer never emits one).  True
    when the encoding is too malformed to check further."""
    if scales is None:
        add("quant", "quantized encoding carries no scales")
        return True
    if scales.shape != cnt.shape:
        add("quant", f"scales {tuple(scales.shape)} != counts "
            f"{tuple(cnt.shape)}")
        return True
    want = torch.int8 if quant == "int8" else torch.uint8
    if vals.dtype != want:
        add("dtype", f"{quant} values must be "
            f"{'int8' if quant == 'int8' else 'packed uint8'}, "
            f"got {vals.dtype}")
        return True
    s = scales.float()
    if not bool(torch.isfinite(s).all()):
        add("scale", "non-finite block scales")
        return False
    if bool((s < 0).any()):
        add("scale", "negative block scales (absmax scales are >= 0)")
        return False
    qmax = 7 if quant == "int4" else 127
    over = zero_live = False
    step = max(1, _CHECK_CHUNK // kb)
    for vc, sc in zip(_rows(vals, vals.shape[-1], step), _rows(s, 1, step)):
        q = unpack_int4(vc, kb) if quant == "int4" else vc
        q = q.to(torch.int32)
        over = over or bool((q.abs() > qmax).any())
        zero_live = zero_live or bool(((sc == 0) & (q != 0)).any())
    if over:
        add("scale", f"quantized values exceed the symmetric range "
            f"[-{qmax}, {qmax}]")
    if zero_live:
        add("scale", "zero-scale block carries nonzero quantized values")
    return False


def _has_duplicates(idx: Tensor, cnt: Tensor, bn: int) -> bool:
    """Whether the live slots of any (row, block) repeat a column: a sort
    of each block's slots, pad slots re-pointed past ``bn``."""
    kb = idx.shape[-1]
    pad = bn + torch.arange(kb, device=idx.device)
    step = max(1, _CHECK_CHUNK // kb)
    for ic, cc in zip(_rows(idx, kb, step), _rows(cnt, 1, step)):
        valid = torch.arange(kb, device=idx.device) < cc
        srt = torch.where(valid, ic.long(), pad).sort(dim=-1).values
        if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] < bn)).any()):
            return True
    return False


def _check_tiled(spec, w: TiledBalanced, add) -> None:
    vals, idx, cnt = w.values, w.indices, w.counts
    quant = w.quant or "none"
    if quant != spec.quant:
        add("quant", f"encoding quant={quant!r} != spec.quant="
            f"{spec.quant!r}")
    # indices carry the logical [.., O, NB, KB] geometry; int4 values pack
    # two nibbles a byte, so their last axis is ceil(KB / 2)
    nb, kb = idx.shape[-2], idx.shape[-1]
    want_kb = -(-kb // 2) if quant == "int4" else kb
    if idx.shape[:-1] != vals.shape[:-1] or vals.shape[-1] != want_kb \
            or cnt.shape != idx.shape[:-1]:
        add("shape", f"values {tuple(vals.shape)} / indices "
            f"{tuple(idx.shape)} / counts {tuple(cnt.shape)} disagree "
            f"(quant={quant})")
        return
    if idx.shape[-3] != spec.n_out:
        add("shape", f"O={idx.shape[-3]} != spec.n_out={spec.n_out}")
    if w.n_in != spec.n_in:
        add("shape", f"n_in={w.n_in} != spec.n_in={spec.n_in}")
    if nb * w.bn < w.n_in:
        add("shape", f"NB*bn={nb * w.bn} < n_in={w.n_in}")
    if spec.block_k and kb != spec.block_k:
        add("shape", f"KB={kb} != spec.block_k={spec.block_k}")
    if quant != "none":
        if _check_quant(quant, vals, cnt, w.scales, kb, add):
            return
    elif w.scales is not None:
        add("quant", "unquantized encoding carries scales")
    if spec.blocks is not None and w.bn != spec.blocks.bn:
        add("block_shape", f"encoding bn={w.bn} != blocks.bn="
            f"{spec.blocks.bn}")
    if idx.dtype not in _INT_DTYPES or cnt.dtype not in _INT_DTYPES:
        add("dtype", f"indices {idx.dtype} / counts {cnt.dtype} "
            "must be integer")
        return
    if idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= w.bn:
            add("index_range", f"block-local indices span [{lo}, {hi}], "
                f"valid range [0, {w.bn})")
    if cnt.numel():
        lo, hi = int(cnt.min()), int(cnt.max())
        if lo < 0 or hi > kb:
            add("count_capacity", f"counts span [{lo}, {hi}], capacity "
                f"KB={kb}")
            return
    totals = cnt.reshape(-1, nb).sum(dim=1)
    if totals.numel() and not bool((totals == totals[0]).all()):
        add("balance", f"per-row NZE totals span [{int(totals.min())}, "
            f"{int(totals.max())}] — the equal-NZE invariant is broken")
    elif totals.numel() and spec.k and int(totals[0]) != spec.k:
        add("balance", f"per-row NZE total {int(totals[0])} != spec.k="
            f"{spec.k}")
    if _has_duplicates(idx, cnt, w.bn):
        add("index_range", "duplicate column index inside a tile block")
    if not _all_finite(vals):
        add("finite", "non-finite encoded values")
    # a column-combining perm must be a bijection of the padded columns,
    # and its presence must agree with the spec's packing provenance
    packed = bool(getattr(spec, "packed", False))
    if w.perm is None:
        if packed:
            add("perm", "spec.packed=True but encoding carries no perm")
        return
    if not packed:
        add("perm", "encoding carries a perm but spec.packed=False")
    p = w.perm
    if p.shape[-1] != nb * w.bn:
        add("perm", f"perm length {p.shape[-1]} != NB*bn={nb * w.bn}")
        return
    want = torch.arange(p.shape[-1], device=p.device)
    if not bool((p.reshape(-1, p.shape[-1]).long().sort(dim=-1).values
                 == want).all()):
        add("perm", "perm is not a bijection of [0, NB*bn)")


def _check_flat(spec, w: BalancedSparse, add) -> None:
    vals, idx = w.values, w.indices
    if idx.shape != vals.shape:
        add("shape", f"values {tuple(vals.shape)} / indices "
            f"{tuple(idx.shape)} disagree")
        return
    if vals.shape[-2] != spec.n_out or w.n_in != spec.n_in:
        add("shape", f"[O, K]={tuple(vals.shape[-2:])} over n_in={w.n_in} "
            f"vs spec (n_out={spec.n_out}, n_in={spec.n_in})")
    if spec.k and vals.shape[-1] != spec.k:
        add("balance", f"K={vals.shape[-1]} != spec.k={spec.k}")
    if idx.dtype not in _INT_DTYPES:
        add("dtype", f"indices dtype {idx.dtype} must be integer")
        return
    if idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < 0 or hi >= w.n_in:
            add("index_range", f"indices span [{lo}, {hi}], valid range "
                f"[0, {w.n_in})")
    if idx.shape[-1] > 1 and any(
            bool((c.sort(dim=-1).values.diff(dim=-1) <= 0).any())
            for c in _rows(idx, idx.shape[-1])):
        add("index_range", "duplicate column index within a row")
    if not _all_finite(vals):
        add("finite", "non-finite encoded values")


def _check_dense(spec, w: Tensor, add) -> None:
    if spec.kind == "conv":
        if w.ndim != 4 or w.shape[0] != spec.n_out \
                or math.prod(w.shape[1:]) != spec.n_in:
            add("shape", f"dense conv weights {tuple(w.shape)} vs spec "
                f"(Co={spec.n_out}, Ci*Hk*Wk={spec.n_in})")
    elif tuple(w.shape[-2:]) != (spec.n_out, spec.n_in):
        add("shape", f"dense weights {tuple(w.shape)} vs spec "
            f"([.., {spec.n_out}, {spec.n_in}])")
    if not _all_finite(w):
        add("finite", "non-finite dense weights")


_IMPL_FORMAT = {"cuda": TiledBalanced, "xla": BalancedSparse,
                "xla_gather": BalancedSparse}

_COST_MODES = ("RIF", "RWF", "ON_CHIP")


def _check_cost(spec, weights, add) -> None:
    """The cost tag's invariants: known objective and mode, finite
    non-negative figures, and stored byte counts equal to the weights'
    (a tag that disagrees was built for other weights)."""
    tag = spec.cost
    if tag.objective not in _cost.OBJECTIVES:
        add("cost_objective", f"unknown objective {tag.objective!r}")
    if tag.mode not in _COST_MODES:
        add("cost_mode", f"unknown dataflow mode {tag.mode!r}")
    if tag.dram_bits < 0 or not math.isfinite(tag.energy_pj) \
            or tag.energy_pj < 0 or not math.isfinite(tag.latency_s) \
            or tag.latency_s < 0:
        add("cost_range", f"negative/non-finite cost figures "
            f"(dram_bits={tag.dram_bits}, energy_pj={tag.energy_pj}, "
            f"latency_s={tag.latency_s})")
    nbytes = _cost.pytree_nbytes(weights)
    if tag.w_total_bytes != nbytes:
        add("cost_bytes", f"tag w_total_bytes={tag.w_total_bytes} but "
            f"weights hold {nbytes} bytes")
    elif tag.w_stream_bytes <= 0 or tag.w_stream_bytes > max(nbytes, 1) \
            or (tag.w_stream_bytes and nbytes % tag.w_stream_bytes):
        add("cost_bytes", f"w_stream_bytes={tag.w_stream_bytes} does not "
            f"divide the stored {nbytes} bytes")


def validate_layer(lp: LayerPlan, name: str | None = None) -> LayerReport:
    """Structural checks of one LayerPlan (no probe, no kernel launch).
    ``name`` overrides the report label."""
    spec = lp.spec
    name = name if name is not None else spec.name
    violations: list = []

    def add(check: str, detail: str) -> None:
        violations.append(Violation(name, check, detail))

    want = _IMPL_FORMAT.get(spec.impl)
    if want is BalancedSparse and spec.quant != "none":
        # a quantized plan keeps the tiled format on every sparse rung
        want = TiledBalanced
    if want is not None and not isinstance(lp.weights, want):
        add("weights_type", f"impl {spec.impl!r} expects "
            f"{want.__name__}, got {type(lp.weights).__name__}")
    elif want is None and isinstance(lp.weights,
                                     (TiledBalanced, BalancedSparse)):
        add("weights_type", f"impl {spec.impl!r} expects dense weights, "
            f"got {type(lp.weights).__name__}")
    elif isinstance(lp.weights, TiledBalanced):
        _check_blocks(spec, add)
        _check_tiled(spec, lp.weights, add)
    elif isinstance(lp.weights, BalancedSparse):
        _check_flat(spec, lp.weights, add)
    else:
        _check_dense(spec, lp.weights, add)
    if spec.cost is not None:
        _check_cost(spec, lp.weights, add)
    return LayerReport(name=name, impl=spec.impl,
                       violations=tuple(violations))


# ---------------------------------------------------------------------------
# Probe-vector parity spot-check
# ---------------------------------------------------------------------------

def _probe_view(lp: LayerPlan) -> LayerPlan:
    """Slice away the stacked layer axis (layer 0) so `execute.apply_layer`
    sees one layer's weights; expert plans keep the E axis."""
    if lp.spec.kind == "conv":
        return lp
    w = lp.weights
    if isinstance(w, TiledBalanced):
        nd, base = w.indices.ndim, 3
    elif isinstance(w, BalancedSparse):
        nd, base = w.values.ndim, 2
    else:
        nd, base = w.ndim, 2
    target = base + (1 if lp.spec.experts else 0)
    for _ in range(nd - target):
        lp = lp.layer(0)
    return lp


def _probe_input(lp: LayerPlan, m: int) -> Tensor:
    """The reference's probe input (NumPy seed 20), on the weights' device,
    in their dtype (float32 for integer values)."""
    spec = lp.spec
    vals = (lp.weights.values if isinstance(
        lp.weights, (TiledBalanced, BalancedSparse)) else lp.weights)
    dt = vals.dtype if vals.is_floating_point() else torch.float32
    rng = np.random.default_rng(20)
    if spec.kind == "conv":
        ci = spec.n_in // (spec.hk * spec.wk)
        hw = max(spec.hk, spec.wk, 4)
        shape = (1, hw, hw, ci)
    elif spec.experts:
        shape = (spec.experts, m, spec.n_in)
    else:
        shape = (m, spec.n_in)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32))
    return x.to(vals.device, dt)


def _probe_tol(dtype, quant: str = "none") -> float:
    """Probe parity tolerance (the reference's guard.py:416): 5e-2 for a
    quantized path, 1e-4 at float32, 2e-2 otherwise."""
    if quant != "none":
        return 5e-2
    return 1e-4 if dtype == torch.float32 else 2e-2


def _probe_one(view: LayerPlan, m: int, tol: float | None,
               name: str) -> Tuple[float | None, str | None]:
    """One probe shape: the planned path on an m-row input against the
    layer's own densified weights (the dense ladder floor).  On the
    ``cuda`` rung only an `InjectedKernelFault` counts as a failed probe:
    any other exception there (a kernel that does not build, launch, or
    take its blocks) raises `GuardError` naming the layer, so the ladder
    never stands the plain rungs in for a broken kernel."""
    spec = view.spec
    x = _probe_input(view, m)
    try:
        with torch.no_grad():
            y = execute.apply_layer(x, view)
            ref = y if spec.impl == "dense" else execute.apply_layer(
                x, execute.demote_layer(view, to_impl="dense"))
            y, ref = y.float().cpu(), ref.float().cpu()
    except kernel_ops.InjectedKernelFault as e:
        return None, f"{type(e).__name__}: {e}"
    except Exception as e:  # noqa: BLE001 — a plain rung's failure demotes
        if spec.impl == "cuda":
            raise GuardError(
                f"layer {name!r}: the cuda rung raised at m={m} "
                f"({type(e).__name__}: {e}); a kernel fault is not "
                "demoted") from e
        return None, f"{type(e).__name__}: {e}"
    if not bool(torch.isfinite(y).all()):
        return None, "non-finite probe output"
    diff = float((y - ref).abs().max()) if spec.impl != "dense" else 0.0
    tol = tol if tol is not None else _probe_tol(x.dtype, spec.quant)
    if diff > tol:
        return diff, f"probe parity {diff:.3e} exceeds tol {tol:g}"
    return diff, None


def probe_layer(lp: LayerPlan, *, m: int = 16, m_decode: int | None = None,
                tol: float | None = None, name: str | None = None
                ) -> Tuple[float | None, str | None]:
    """Probe one layer's planned path at both serving shapes: ``m`` rows
    (prefill) and ``m_decode`` (default the plan's ``spec.decode_m``, else
    4), which route to other kernels and blocks.  Returns ``(max |diff|,
    error)``, the error prefixed with the failing shape (``m=<mm>:``).
    Validates the layer first and raises `PlanValidationError` (naming it)
    instead of launching a kernel on a broken encoding."""
    name = name if name is not None else lp.spec.name
    lr = validate_layer(lp, name)
    if lr.violations:
        raise PlanValidationError(PlanReport(layers={name: lr}))
    view = _probe_view(lp)
    spec = view.spec
    # a conv probe ignores m (its input is a fixed small NHWC image)
    shapes = [m] if spec.kind == "conv" else sorted(
        {m, m_decode or spec.decode_m or 4})
    worst: float | None = None
    for mm in shapes:
        diff, err = _probe_one(view, mm, tol, name)
        if err is not None:
            return diff, f"m={mm}: {err}"
        if diff is not None and (worst is None or diff > worst):
            worst = diff
    return worst, None


def validate_plan(plan: ModelPlan, *, strict: bool = True,
                  probe: bool = False, probe_m: int = 16,
                  tol: float | None = None) -> PlanReport:
    """Check every LayerPlan's structural invariants (and, with ``probe``,
    the numerical parity of the layers that pass them).  ``strict`` raises
    `PlanValidationError` naming each failing layer and check; otherwise
    the report is returned."""
    reports: Dict[str, LayerReport] = {}
    for nm in sorted(plan.layers):
        lr = validate_layer(plan.layers[nm], nm)
        if probe and not lr.violations:
            lr.probe_max_diff, lr.probe_error = probe_layer(
                plan.layers[nm], m=probe_m, tol=tol, name=nm)
        reports[nm] = lr
    report = PlanReport(layers=reports)
    if strict and not report.ok:
        raise PlanValidationError(report)
    return report


# ---------------------------------------------------------------------------
# The degradation ladder
# ---------------------------------------------------------------------------

def _meta_set(meta: Tuple, key: str, value) -> Tuple:
    d = dict(meta)
    d[key] = value
    return tuple(d.items())


def harden_plan(plan: ModelPlan, *, probe_m: int = 16,
                tol: float | None = None
                ) -> Tuple[ModelPlan, Tuple[Degradation, ...]]:
    """Probe every layer's rung and walk failures down the ladder: a
    ``cuda`` layer first retries once with halved (bm, bo), then the layer
    demotes one rung (`execute.demote_layer`) and is probed again, until a
    rung passes.  The dense floor failing raises `GuardError` naming the
    layer (its weights are unusable), as does a ``cuda`` rung that raises
    anything but an `InjectedKernelFault`; a structurally broken layer
    raises `PlanValidationError` before any launch.  Returns ``(plan, events)``;
    the events are stamped into the meta (``degraded``) and every demoted
    spec carries ``degraded_from``."""
    events: list = []
    layers: Dict[str, LayerPlan] = {}
    for nm in sorted(plan.layers):
        lp = plan.layers[nm]
        tried_halve = False
        while True:
            _, err = probe_layer(lp, m=probe_m, tol=tol, name=nm)
            if err is None:
                break
            spec = lp.spec
            if spec.impl == "dense":
                raise GuardError(
                    f"layer {nm!r}: dense ladder floor failed ({err}) — "
                    "the weights themselves are unusable (component: "
                    "plan weights; run validate_plan)")
            if spec.impl == "cuda" and not tried_halve \
                    and spec.blocks is not None:
                tried_halve = True
                halved = kernel_ops.halve_blocks(
                    spec.blocks, kb=spec.block_k or None)
                if halved is not None:
                    events.append(Degradation(nm, spec.impl, spec.impl,
                                              "halved_blocks", err))
                    lp = LayerPlan(
                        spec=dataclasses.replace(spec, blocks=halved),
                        weights=lp.weights)
                    continue
            nxt = execute.next_impl(spec.impl)
            events.append(Degradation(nm, spec.impl, nxt, "demoted", err))
            lp = execute.demote_layer(lp, to_impl=nxt)
        layers[nm] = lp
    meta = plan.meta
    if events:
        meta = _meta_set(meta, "degraded",
                         tuple((e.layer, e.from_impl, e.to_impl, e.action,
                                e.reason) for e in events))
    return ModelPlan(layers=layers, meta=meta), tuple(events)


# ---------------------------------------------------------------------------
# Runtime NaN guard: bisection + quarantine
# ---------------------------------------------------------------------------

def quarantine_layers(plan: ModelPlan, names: Iterable[str],
                      ref_blocks: dict | None = None) -> ModelPlan:
    """Flip ``names`` to the dense impl.  ``ref_blocks`` (params-layout
    ``{name: [*lead, n_in, n_out]}`` known-good weights, e.g. the
    masked-dense reference) replaces the suspect encoding when given;
    otherwise the layer's own densified weights are used.  The names are
    stamped into the meta (``quarantined``)."""
    layers = dict(plan.layers)
    names = sorted(set(names))
    for nm in names:
        lp = layers[nm]
        ref = None
        if ref_blocks is not None and nm in ref_blocks:
            ref = ref_blocks[nm].transpose(-1, -2)
        if lp.spec.impl == "dense":
            if ref is not None:
                layers[nm] = LayerPlan(spec=lp.spec, weights=ref)
            continue
        layers[nm] = execute.demote_layer(lp, to_impl="dense",
                                          ref_dense=ref)
    prev = dict(plan.meta).get("quarantined", ())
    meta = _meta_set(plan.meta, "quarantined",
                     tuple(sorted(set(prev) | set(names))))
    return ModelPlan(layers=layers, meta=meta)


def locate_poisoned(plan: ModelPlan, eval_finite: Callable[[ModelPlan], bool],
                    *, ref_blocks: dict | None = None
                    ) -> Tuple[Tuple[str, ...], bool]:
    """Bisect the plan's sparse layers against the dense reference:
    quarantining a prefix of the sorted sparse layers is monotone, so a
    binary search finds the smallest prefix whose quarantine restores
    finiteness (``eval_finite(candidate_plan)``); its last layer is a
    culprit, quarantined for real, and the search repeats until the model
    is finite.  Returns ``(culprits, attributable)``; not attributable
    means even the all-dense plan is non-finite."""
    poisoned: list = []
    current = plan
    while not eval_finite(current):
        cand = [nm for nm in sorted(current.layers)
                if current.layers[nm].spec.is_sparse]
        if not cand or not eval_finite(
                quarantine_layers(current, cand, ref_blocks)):
            return tuple(poisoned), False
        lo, hi = 1, len(cand)
        while lo < hi:
            mid = (lo + hi) // 2
            if eval_finite(quarantine_layers(current, cand[:mid],
                                             ref_blocks)):
                hi = mid
            else:
                lo = mid + 1
        culprit = cand[lo - 1]
        poisoned.append(culprit)
        current = quarantine_layers(current, [culprit], ref_blocks)
    return tuple(poisoned), True


def nonfinite_rows(logits) -> np.ndarray:
    """Per-row non-finiteness mask of a ``[B, vocab]`` logits batch."""
    return (~torch.isfinite(torch.as_tensor(logits)).all(dim=-1)).cpu() \
        .numpy()


__all__ = ["GuardError", "PlanValidationError", "Violation", "LayerReport",
           "PlanReport", "Degradation", "validate_layer", "validate_plan",
           "probe_layer", "harden_plan", "quarantine_layers",
           "locate_poisoned", "nonfinite_rows"]
