"""The port's guard layer and fault injectors against the JAX reference
(twins of `tests/test_faults.py`): validation names the same (layer,
check) violations, the ladder makes the same degradation sequences
(reference ``pallas`` <-> port ``cuda``), bisection blames and quarantines
the same layers, the checkpoint and autotune injectors damage the same
bytes and degrade the same way, and ``serve --guard`` quarantines an
injected NaN.  Plans are built by both packages from the same
numpy-seeded weights (the reference's, converted).  The one sequence
that differs by design: the reference halves a Pallas layer's blocks on a
modeled VMEM trip; the port has no such model for its CUDA kernels, so
its twin trips the halving with a forced ``cuda`` failure.  On the CPU the
kernel wrappers run their plain versions; the `cuda`-marked test hardens
a clean plan on the card."""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.pruning import balanced_prune_rows  # noqa: E402
from repro.engine import execute as ref_execute  # noqa: E402
from repro.engine import guard as ref_guard  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.testing import faults as ref_faults  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import guard  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.testing import faults  # noqa: E402

IMPLS = {"cuda": "pallas", "xla": "xla", "xla_gather": "xla_gather",
         "dense": "dense"}


def _ref_name(nm: str) -> str:
    return nm.replace("cuda", "pallas")


def _np(t):
    return t.detach().float().cpu().numpy()


def _fc_pair(key=0, o=48, n=96, sparsity=0.6, impl="cuda", **kw):
    """One fc layer planned by both packages from the same weights:
    ``(masked weight [O, N], port plan, reference plan)``."""
    w_j = jax.random.normal(jax.random.key(key), (o, n))
    _, mask_j = balanced_prune_rows(w_j, sparsity)
    w, mask = (torch.from_numpy(np.array(a)) for a in (w_j, mask_j))
    lp = engine_plan.build_layer_plan("fc", w, mask=mask, m_hint=32,
                                      impl=impl, **kw)
    lp_j = ref_plan.build_layer_plan("fc", w_j, mask=mask_j, m_hint=32,
                                     impl=IMPLS[impl], **kw)
    return w * mask, lp, lp_j


def _toy_plans(impls=("cuda", "xla"), **kw):
    """Multi-layer plans of both packages, and the masked-dense references
    in params layout ([n_in, n_out]) serve's ref_params would carry."""
    layers, layers_j, ref_blocks, ref_blocks_j = {}, {}, {}, {}
    for i, impl in enumerate(impls):
        wm, lp, lp_j = _fc_pair(key=i, impl=impl, **kw)
        name = f"l{i}_{impl}"
        layers[name], layers_j[_ref_name(name)] = lp, lp_j
        ref_blocks[name] = wm.T.contiguous()
        ref_blocks_j[_ref_name(name)] = jnp.asarray(_np(wm).T)
    return (engine_plan.ModelPlan(layers=layers, meta=()), ref_blocks,
            ref_plan.ModelPlan(layers=layers_j, meta=()), ref_blocks_j)


def _checks(report) -> set:
    return {(_ref_name(v.layer), v.check) for v in report.violations()}


def _events(events) -> list:
    return [(_ref_name(e.layer), IMPLS[e.from_impl], IMPLS[e.to_impl],
             e.action) for e in events]


def _x(seed, m, n=96):
    x = np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def _finite_oracle(x, apply):
    def eval_finite(cand):
        return all(bool(np.isfinite(np.asarray(apply(x, lp), np.float32))
                        .all()) for lp in cand.layers.values())
    return eval_finite


def _port_apply(x, lp):
    with torch.no_grad():
        return _np(execute.apply_layer(x, lp))


# ---------------------------------------------------------------------------
# validate_plan: structural invariants
# ---------------------------------------------------------------------------

def test_validate_clean_plan_passes_with_probe():
    plan, _, plan_j, _ = _toy_plans()
    report = guard.validate_plan(plan, strict=True, probe=True)
    assert report.ok and len(report.layers) == 2
    for lr in report.layers.values():
        assert lr.probe_error is None
        assert lr.probe_max_diff is not None and lr.probe_max_diff < 1e-4
    assert ref_guard.validate_plan(plan_j, strict=True, probe=True).ok


@pytest.mark.parametrize("kind,check", [
    ("index_oob", "index_range"),
    ("count_overflow", "count_capacity"),
    ("nan", "finite"),
    ("imbalance", "balance"),
])
def test_validate_names_corrupt_tiled_layer(kind, check):
    plan, _, plan_j, _ = _toy_plans()
    bad, name = faults.corrupt_tile_encoding(plan, layer="l0_cuda",
                                             kind=kind)
    with pytest.raises(guard.PlanValidationError) as ei:
        guard.validate_plan(bad, strict=True)
    assert name in str(ei.value) and check in str(ei.value)
    report = guard.validate_plan(bad, strict=False)
    assert not report.ok
    assert any(v.layer == name and v.check == check
               for v in report.violations())
    assert report.layers["l1_xla"].ok        # damage stays attributed
    bad_j, _ = ref_faults.corrupt_tile_encoding(plan_j, layer="l0_pallas",
                                                kind=kind)
    assert _checks(report) == _checks(ref_guard.validate_plan(
        bad_j, strict=False))


@pytest.mark.parametrize("kind,check", [
    ("index_oob", "index_range"), ("nan", "finite")])
def test_validate_names_corrupt_flat_layer(kind, check):
    plan, _, plan_j, _ = _toy_plans()
    bad, name = faults.corrupt_tile_encoding(plan, layer="l1_xla", kind=kind)
    report = guard.validate_plan(bad, strict=False)
    assert any(v.layer == name and v.check == check
               for v in report.violations())
    bad_j, _ = ref_faults.corrupt_tile_encoding(plan_j, layer="l1_xla",
                                                kind=kind)
    assert _checks(report) == _checks(ref_guard.validate_plan(
        bad_j, strict=False))


@pytest.mark.parametrize("kind", ["index_oob", "count_overflow"])
def test_probe_and_harden_refuse_a_corrupt_layer_before_any_launch(kind):
    """A structurally broken encoding never reaches a kernel: the probe
    and the ladder validate first and raise naming the layer, with no
    dispatch made (on a GPU it would read out of bounds)."""
    plan, _, _, _ = _toy_plans()
    bad, name = faults.corrupt_tile_encoding(plan, layer="l0_cuda",
                                             kind=kind)
    execute.reset_stats()
    with pytest.raises(guard.PlanValidationError, match=name):
        guard.probe_layer(bad.layers[name], name=name)
    with pytest.raises(guard.PlanValidationError, match=name):
        guard.harden_plan(bad)                 # l0_cuda is its first layer
    assert execute.stats() == {}               # nothing was dispatched
    report = guard.validate_plan(bad, strict=False, probe=True)
    assert report.layers[name].probe_error is None    # never probed
    assert report.layers["l1_xla"].probe_max_diff is not None
    assert execute.stats()["impl_xla"] == execute.stats()["balanced_spmm"]


def _quant_plans(quant="int8", impls=("xla", "xla")):
    return _toy_plans(impls=impls, quant=quant)


@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("kind", faults.SCALE_FAULTS)
def test_validate_names_corrupt_scales(kind, quant):
    plan, _, plan_j, _ = _quant_plans(quant=quant)
    bad, name = faults.corrupt_scales(plan, kind=kind)
    with pytest.raises(guard.PlanValidationError) as ei:
        guard.validate_plan(bad, strict=True)
    assert name in str(ei.value) and "scale" in str(ei.value)
    report = guard.validate_plan(bad, strict=False)
    assert any(v.layer == name and v.check == "scale"
               for v in report.violations())
    other = next(nm for nm in plan.layers if nm != name)
    assert report.layers[other].ok
    bad_j, name_j = ref_faults.corrupt_scales(plan_j, kind=kind)
    assert name_j == _ref_name(name)
    assert _checks(report) == _checks(ref_guard.validate_plan(
        bad_j, strict=False))


def test_validate_quant_spec_encoding_mismatch():
    """A quant spec paired with an unquantized encoding (a miswired
    restore) trips the ``quant`` agreement check, as in the reference."""
    from repro.kernels.tile_format import dequantize_tiled as ref_deq
    from repro_torch.kernels.tile_format import dequantize_tiled
    plan, _, plan_j, _ = _quant_plans()
    name = next(iter(plan.layers))
    crossed = engine_plan.LayerPlan(
        spec=plan.layers[name].spec,
        weights=dequantize_tiled(plan.layers[name].weights))
    bad = engine_plan.ModelPlan(layers={**plan.layers, name: crossed})
    report = guard.validate_plan(bad, strict=False)
    assert any(v.layer == name and v.check == "quant"
               for v in report.violations())
    lp_j = plan_j.layers[name]
    bad_j = ref_plan.ModelPlan(layers={**plan_j.layers, name: ref_plan
                                       .LayerPlan(spec=lp_j.spec,
                                                  weights=ref_deq(
                                                      lp_j.weights))})
    assert _checks(report) == _checks(ref_guard.validate_plan(
        bad_j, strict=False))


def test_corrupt_scales_requires_a_quantized_layer():
    plan, _, _, _ = _toy_plans()
    with pytest.raises(ValueError, match="no quantized layer"):
        faults.corrupt_scales(plan)


def test_nan_scales_bisected_and_quarantined():
    """A NaN dequant scale poisons the layer's output; the guard bisects
    to it and quarantines it to the dense reference, as the reference
    does."""
    plan, ref_blocks, plan_j, ref_blocks_j = _quant_plans(
        impls=("xla", "xla", "xla"))
    x, x_j = _x(11, 4)
    poisoned, name = faults.corrupt_scales(plan, kind="nan")
    assert not np.isfinite(_port_apply(x, poisoned.layers[name])).all()
    culprits, attributable = guard.locate_poisoned(
        poisoned, _finite_oracle(x, _port_apply), ref_blocks=ref_blocks)
    assert attributable and culprits == (name,)
    fixed = guard.quarantine_layers(poisoned, [name], ref_blocks)
    assert fixed.layers[name].spec.impl == "dense"
    assert fixed.layers[name].spec.quant == "none"
    np.testing.assert_allclose(_port_apply(x, fixed.layers[name]),
                               _np(x @ ref_blocks[name]), rtol=1e-5,
                               atol=1e-5)
    poisoned_j, name_j = ref_faults.corrupt_scales(plan_j, kind="nan")
    want = ref_guard.locate_poisoned(
        poisoned_j, _finite_oracle(x_j, ref_execute.apply_layer),
        ref_blocks=ref_blocks_j)
    assert want == ((name_j,), True) and name_j == name


def test_validate_weights_type_mismatch():
    plan, _, _, _ = _toy_plans()
    crossed = engine_plan.LayerPlan(spec=plan.layers["l0_cuda"].spec,
                                    weights=plan.layers["l1_xla"].weights)
    bad = engine_plan.ModelPlan(layers={**plan.layers, "l0_cuda": crossed})
    report = guard.validate_plan(bad, strict=False)
    assert any(v.layer == "l0_cuda" and v.check == "weights_type"
               for v in report.violations())


# ---------------------------------------------------------------------------
# The degradation ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site,impl,m", [
    ("xla", "xla", 4), ("xla_decode", "xla", 4), ("xla_decode", "xla", 16),
    ("cuda", "cuda", 16), ("cuda_decode", "cuda", 4),
    ("cuda_decode", "cuda", 16), ("xla_gather", "xla_gather", 4)])
def test_forced_fault_trips_dispatch(site, impl, m):
    """Each fault site trips exactly the dispatches the reference's does
    (a decode site only at skinny M), and is disarmed on exit."""
    _, lp, lp_j = _fc_pair(impl=impl)
    x, x_j = _x(3, m)

    def trips(arm, apply, x, lp, error) -> bool:
        with arm:
            try:
                apply(x, lp)
            except error:
                return True
        apply(x, lp)                          # disarmed on exit
        return False

    got = trips(faults.force_impl_failure(site), execute.apply_layer, x, lp,
                ops.InjectedKernelFault)
    assert got == (site == impl or (site == f"{impl}_decode"
                                    and m <= ops.SKINNY_M))
    ref_site = site.replace("cuda", "pallas")
    assert trips(ref_faults.force_impl_failure(ref_site),
                 ref_execute.apply_layer, x_j, lp_j,
                 ref_ops.InjectedKernelFault) == got


def test_demote_preserves_numerics_down_the_ladder():
    wm, lp, lp_j = _fc_pair(impl="cuda")
    x, x_j = _x(3, 5)
    want = _np(x @ wm.T)
    for impl in ("xla", "xla_gather", "dense"):
        lp_d = execute.demote_layer(lp, to_impl=impl)
        assert lp_d.spec.impl == impl and lp_d.spec.degraded_from == "cuda"
        np.testing.assert_allclose(_port_apply(x, lp_d), want, rtol=1e-5,
                                   atol=1e-5)
        ref_d = ref_execute.demote_layer(lp_j, to_impl=impl)
        np.testing.assert_allclose(
            _port_apply(x, lp_d),
            np.asarray(ref_execute.apply_layer(x_j, ref_d)), rtol=1e-5,
            atol=1e-5)
        if impl != "dense":
            np.testing.assert_array_equal(
                lp_d.weights.indices.numpy(),
                np.asarray(ref_d.weights.indices))


def test_harden_demotes_failing_impl_and_records():
    plan, _, plan_j, _ = _toy_plans()
    x, _ = _x(4, 5)
    before = {nm: _port_apply(x, lp) for nm, lp in plan.layers.items()}
    with faults.force_impl_failure("cuda"):
        hardened, events = guard.harden_plan(plan)
    assert hardened.layers["l0_cuda"].spec.impl == "xla"
    assert hardened.layers["l1_xla"].spec.impl == "xla"     # untouched
    assert hardened.degraded_mix() == {"cuda->xla": 1}
    assert any(e.layer == "l0_cuda" and e.action == "demoted"
               for e in events)
    assert dict(hardened.meta).get("degraded")
    for nm, lp in hardened.layers.items():
        np.testing.assert_allclose(_port_apply(x, lp), before[nm],
                                   rtol=1e-5, atol=1e-5)
    execute.reset_stats()
    execute.apply_named(x, hardened, "l0_cuda")
    assert execute.stats().get("degraded_dispatch", 0) == 1
    with ref_faults.force_impl_failure("pallas"):
        _, events_j = ref_guard.harden_plan(plan_j)
    assert _events(events) == [tuple(dataclasses.astuple(e)[:4])
                               for e in events_j]


def _broken_kernel(*args, **kwargs):
    raise RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")


@pytest.mark.parametrize("wrapper", ["tiled_balanced_spmm",
                                     "tiled_balanced_spmm_skinny"])
def test_harden_reraises_a_real_cuda_rung_failure(monkeypatch, wrapper):
    """The ladder is no fallback for a broken kernel: a ``cuda`` rung that
    raises anything but an `InjectedKernelFault` (here the prefill or the
    decode wrapper failing to launch) ends `harden_plan` with `GuardError`
    naming the layer, instead of demoting it to the plain ``xla`` rung.
    (The reference demotes on any exception.)  A plain rung's failure
    still walks the ladder."""
    plan, _, _, _ = _toy_plans()
    monkeypatch.setattr(ops, wrapper, _broken_kernel)
    with pytest.raises(guard.GuardError, match="'l0_cuda'.*RuntimeError") \
            as ei:
        guard.harden_plan(plan)
    assert isinstance(ei.value.__cause__, RuntimeError)
    monkeypatch.undo()
    xla_only, _, _, _ = _toy_plans(impls=("xla",))
    real = execute.apply_layer

    def broken_xla(x, lp):
        if lp.spec.impl == "xla":
            raise RuntimeError("plain rung failed")
        return real(x, lp)
    monkeypatch.setattr(execute, "apply_layer", broken_xla)
    hardened, events = guard.harden_plan(xla_only)
    assert [(e.from_impl, e.to_impl, e.action) for e in events] == \
        [("xla", "xla_gather", "demoted")]
    assert hardened.layers["l0_xla"].spec.impl == "xla_gather"


def test_serve_guard_fails_on_a_real_cuda_rung_failure(monkeypatch):
    """``serve --guard`` with a kernel wrapper that raises: the run fails
    naming the layer, and no report claims the kernels ran."""
    from repro_torch.launch import serve
    monkeypatch.setattr(ops, "tiled_balanced_spmm", _broken_kernel)
    with pytest.raises(guard.GuardError, match="cuda rung raised"):
        serve.main(SERVE + ["--impl", "cuda", "--guard"])


def test_harden_walks_multiple_rungs():
    plan, _, plan_j, _ = _toy_plans(impls=("cuda",))
    with faults.force_impl_failure("cuda", "xla"):
        hardened, events = guard.harden_plan(plan)
    assert hardened.layers["l0_cuda"].spec.impl == "xla_gather"
    assert [e.to_impl for e in events if e.action == "demoted"] == \
        ["xla", "xla_gather"]
    assert hardened.degraded_mix() == {"cuda->xla_gather": 1}
    with ref_faults.force_impl_failure("pallas", "xla"):
        _, events_j = ref_guard.harden_plan(plan_j)
    assert _events(events) == [tuple(dataclasses.astuple(e)[:4])
                               for e in events_j]


def test_harden_vmem_trip_halves_blocks(monkeypatch):
    """The reference halves the blocks of a layer whose modeled VMEM
    footprint trips the TPU budget; the port has no VMEM model for its
    kernels, so a forced ``cuda`` failure of the prefill-shaped dispatch
    (``bm`` above the decode tile of 8) at the unhalved output tile
    (``bo``) trips the same recovery: one ``halved_blocks`` event, the
    layer stays on its rung at the reference's halved blocks."""
    plan, _, plan_j, _ = _toy_plans(impls=("cuda",))
    spec = plan.layers["l0_cuda"].spec
    halved = ops.halve_blocks(spec.blocks, kb=spec.block_k)
    assert halved is not None and halved.vmem_bytes < spec.blocks.vmem_bytes
    with faults.force_impl_failure(
            "cuda", when=lambda c: c["bm"] > 8 and c["bo"] > halved.bo):
        hardened, events = guard.harden_plan(plan)
    assert [e.action for e in events] == ["halved_blocks"]
    hspec = hardened.layers["l0_cuda"].spec
    assert hspec.impl == "cuda"
    assert (hspec.blocks.bm, hspec.blocks.bo) == (halved.bm, halved.bo)
    spec_j = plan_j.layers["l0_pallas"].spec
    monkeypatch.setattr(ref_ops, "_VMEM_BUDGET",
                        2 * spec_j.blocks.vmem_bytes - 1)
    hardened_j, events_j = ref_guard.harden_plan(plan_j)
    assert [e.action for e in events_j] == ["halved_blocks"]
    assert dataclasses.asdict(hardened_j.layers["l0_pallas"].spec.blocks) \
        == dataclasses.asdict(hspec.blocks)


def test_harden_raises_when_dense_floor_fails(monkeypatch):
    """NaN weights poison every rung: unrecoverable.  The reference walks
    the ladder to the dense floor and raises `GuardError`; the port
    validates before it launches anything, so it raises
    `PlanValidationError` naming the layer and the ``finite`` check.  A
    dense floor whose output fails on valid weights is a `GuardError`."""
    plan, _, plan_j, _ = _toy_plans(impls=("xla",))
    poisoned, _ = faults.inject_nan_output(plan, layer="l0_xla")
    with pytest.raises(guard.PlanValidationError, match="l0_xla") as ei:
        guard.harden_plan(poisoned)
    assert {v.check for v in ei.value.report.violations()} == {"finite"}
    poisoned_j, _ = ref_faults.inject_nan_output(plan_j, layer="l0_xla")
    with pytest.raises(ref_guard.GuardError, match="l0_xla"):
        ref_guard.harden_plan(poisoned_j)
    dense = engine_plan.ModelPlan(layers={"d": execute.demote_layer(
        plan.layers["l0_xla"], to_impl="dense")})
    real = execute.apply_layer
    monkeypatch.setattr(execute, "apply_layer",
                        lambda x, lp: real(x, lp) * float("nan"))
    with pytest.raises(guard.GuardError, match="'d'"):
        guard.harden_plan(dense)


# ---------------------------------------------------------------------------
# NaN bisection + quarantine
# ---------------------------------------------------------------------------

def test_locate_poisoned_blames_the_right_layer():
    plan, ref_blocks, plan_j, ref_blocks_j = _toy_plans(
        impls=("cuda", "xla", "xla"))
    x, x_j = _x(5, 4)
    poisoned, name = faults.inject_nan_output(plan, layer="l1_xla")
    got = guard.locate_poisoned(poisoned, _finite_oracle(x, _port_apply),
                                ref_blocks=ref_blocks)
    assert got == ((name,), True)
    poisoned_j, _ = ref_faults.inject_nan_output(plan_j, layer="l1_xla")
    assert ref_guard.locate_poisoned(
        poisoned_j, _finite_oracle(x_j, ref_execute.apply_layer),
        ref_blocks=ref_blocks_j) == got


def test_quarantine_restores_parity_against_reference():
    plan, ref_blocks, _, _ = _toy_plans(impls=("cuda", "xla"))
    x, _ = _x(6, 4)
    clean = {nm: _port_apply(x, lp) for nm, lp in plan.layers.items()}
    poisoned, name = faults.inject_nan_output(plan, layer="l0_cuda")
    fixed = guard.quarantine_layers(poisoned, [name], ref_blocks)
    assert fixed.layers[name].spec.impl == "dense"
    assert fixed.layers[name].spec.degraded_from == "cuda"
    assert fixed.quarantined() == (name,)
    np.testing.assert_allclose(_port_apply(x, fixed.layers[name]),
                               clean[name], rtol=1e-5, atol=1e-5)


def test_locate_poisoned_multiple_layers():
    plan, ref_blocks, plan_j, ref_blocks_j = _toy_plans(
        impls=("xla", "xla", "xla"))
    x, x_j = _x(7, 4)
    p1, n1 = faults.inject_nan_output(plan, layer="l0_xla")
    p2, n2 = faults.inject_nan_output(p1, layer="l2_xla")
    got = guard.locate_poisoned(p2, _finite_oracle(x, _port_apply),
                                ref_blocks=ref_blocks)
    assert got[1] and sorted(got[0]) == sorted([n1, n2])
    q1, _ = ref_faults.inject_nan_output(plan_j, layer="l0_xla")
    q2, _ = ref_faults.inject_nan_output(q1, layer="l2_xla")
    assert ref_guard.locate_poisoned(
        q2, _finite_oracle(x_j, ref_execute.apply_layer),
        ref_blocks=ref_blocks_j) == got


def test_locate_poisoned_unattributable():
    plan, ref_blocks, _, _ = _toy_plans(impls=("xla",))
    poisoned, _ = faults.inject_nan_output(plan, layer="l0_xla")
    _, attributable = guard.locate_poisoned(poisoned, lambda cand: False,
                                            ref_blocks=ref_blocks)
    assert not attributable


def test_nonfinite_rows_marks_rows():
    logits = np.zeros((3, 5), np.float32)
    logits[1, 2] = np.nan
    logits[2, 0] = np.inf
    np.testing.assert_array_equal(guard.nonfinite_rows(
        torch.from_numpy(logits)), ref_guard.nonfinite_rows(logits))


# ---------------------------------------------------------------------------
# Checkpoint recovery (store.py + the filesystem injectors)
# ---------------------------------------------------------------------------

def _tiny_tree(seed=0):
    k = jax.random.key(seed)
    return {"w": jax.random.normal(k, (8, 8)),
            "b": jnp.arange(8, dtype=jnp.float32)}


def _tiny_tree_t(seed=0):
    return {k: torch.from_numpy(np.array(v))
            for k, v in _tiny_tree(seed).items()}


def test_restore_falls_back_on_truncated_shard(tmp_path, capsys):
    from repro.checkpoint.store import CheckpointManager as RefManager
    from repro_torch.checkpoint.store import (CheckpointManager,
                                              verify_checkpoint)
    mgr = CheckpointManager(tmp_path / "port", every=1, keep=5)
    mgr.maybe_save(1, _tiny_tree_t(1), force=True)
    mgr.maybe_save(2, _tiny_tree_t(2), force=True)
    shard = faults.truncate_shard(tmp_path / "port")        # step 2
    assert "step_00000002" in str(shard)
    problems = verify_checkpoint(tmp_path / "port", 2)
    assert problems and any("unreadable" in p for p in problems)
    assert not verify_checkpoint(tmp_path / "port", 1)
    step, tree, _ = mgr.restore_latest(_tiny_tree_t())
    assert step == 1
    np.testing.assert_array_equal(tree["w"].numpy(),
                                  np.asarray(_tiny_tree(1)["w"]))
    assert "falling back" in capsys.readouterr().out
    # the reference's injector damages the same shard, to the same bytes
    ref = RefManager(tmp_path / "ref", every=1, keep=5)
    ref.maybe_save(1, _tiny_tree(1), force=True)
    ref.maybe_save(2, _tiny_tree(2), force=True)
    ref_shard = ref_faults.truncate_shard(tmp_path / "ref")
    assert ref_shard.name == shard.name
    assert ref_shard.read_bytes() == shard.read_bytes()


def test_restore_falls_back_on_crc_mismatch(tmp_path):
    from repro.checkpoint.store import CheckpointManager as RefManager
    from repro_torch.checkpoint.store import (CheckpointManager,
                                              verify_checkpoint)
    mgr = CheckpointManager(tmp_path / "port", every=1, keep=5)
    mgr.maybe_save(3, _tiny_tree_t(3), force=True)
    mgr.maybe_save(4, _tiny_tree_t(4), force=True)
    shard = faults.bit_flip_shard(tmp_path / "port")
    problems = verify_checkpoint(tmp_path / "port", 4)
    assert problems and any("CRC mismatch" in p for p in problems)
    step, _, _ = mgr.restore_latest(_tiny_tree_t())
    assert step == 3
    ref = RefManager(tmp_path / "ref", every=1, keep=5)
    ref.maybe_save(3, _tiny_tree(3), force=True)
    ref.maybe_save(4, _tiny_tree(4), force=True)
    ref_shard = ref_faults.bit_flip_shard(tmp_path / "ref")
    assert ref_shard.name == shard.name
    assert ref_shard.read_bytes() == shard.read_bytes()


def test_restore_raises_when_every_step_is_damaged(tmp_path):
    from repro_torch.checkpoint.store import CheckpointManager
    mgr = CheckpointManager(tmp_path, every=1, keep=5)
    mgr.maybe_save(1, _tiny_tree_t(1), force=True)
    mgr.maybe_save(2, _tiny_tree_t(2), force=True)
    faults.bit_flip_shard(tmp_path, step=1)
    faults.bit_flip_shard(tmp_path, step=2)
    with pytest.raises(IOError, match="no restorable checkpoint"):
        mgr.restore_latest(_tiny_tree_t())


def test_tmp_residue_is_garbage_collected(tmp_path):
    from repro_torch.checkpoint.store import (complete_steps, latest_step,
                                              save_checkpoint)
    residue = tmp_path / "step_00000099.tmp"        # a crash mid-write
    residue.mkdir(parents=True)
    (residue / "junk.npy").write_bytes(b"partial")
    assert latest_step(tmp_path) is None
    save_checkpoint(tmp_path, 100, _tiny_tree_t())
    assert not residue.exists()
    assert complete_steps(tmp_path) == [100]


# ---------------------------------------------------------------------------
# Autotune-cache chaos
# ---------------------------------------------------------------------------

SHAPE = dict(m=64, o=48, n=96, k=48)


def test_poisoned_cache_entry_degrades_to_static(tmp_path):
    path = str(tmp_path / "cache.json")
    res = autotune.resolve_blocks(**SHAPE, itemsize=4, tune="sweep",
                                  cache_path=path, device="cpu")
    assert res.source == "swept"
    assert faults.poison_autotune_entry(path) == "*"
    entry = next(iter(json.loads(open(path).read())["entries"].values()))
    assert (entry["bm"], entry["bo"], entry["bn"]) == ("garbage", -4, None)
    again = autotune.resolve_blocks(**SHAPE, itemsize=4, tune="cached",
                                    cache_path=path, device="cpu")
    assert again.source == "static"
    assert again.blocks == ops.choose_blocks(**SHAPE, itemsize=4)


def test_sweep_quarantines_failing_candidate():
    cands = autotune.candidate_blocks(**SHAPE, itemsize=4)
    assert len(cands) >= 2
    victim = cands[1]                       # a non-static candidate

    def only_victim(ctx):
        # the wide dispatch's ctx: bm is the live M's block, bo the
        # output tile, bn the encoding's column block
        return (ctx.get("bo"), ctx.get("bn")) == (victim.bo, victim.bn) \
            and ctx.get("bm") == ops._pick_block(SHAPE["m"], victim.bm)

    with faults.force_impl_failure("cuda", when=only_victim):
        best, record = autotune.sweep_blocks(**SHAPE, itemsize=4,
                                             device="cpu")
    assert record["source"] == "sweep"
    assert [q["bm"] for q in record["quarantined"]] == [victim.bm]
    assert "InjectedKernelFault" in record["quarantined"][0]["error"]
    assert (best.bm, best.bo, best.bn) != (victim.bm, victim.bo, victim.bn)
    assert len(record["candidates"]) == len(cands) - 1


def test_sweep_all_candidates_failing_falls_back_static(tmp_path):
    path = tmp_path / "cache.json"
    with faults.force_impl_failure("cuda"):
        res = autotune.resolve_blocks(**SHAPE, itemsize=4, tune="sweep",
                                      cache_path=str(path), device="cpu")
    assert res.source == "static"
    assert res.blocks == ops.choose_blocks(**SHAPE, itemsize=4)
    assert not path.exists()          # a failed sweep is never cached


def test_update_cache_concurrent_writers_union(tmp_path):
    path = str(tmp_path / "cache.json")
    autotune.save_cache({"seed": {"source": "sweep", "bm": 8, "bo": 8,
                                  "bn": 8, "vmem_bytes": 1}}, path)
    errs = []

    def writer(i):
        try:
            for j in range(10):
                autotune.update_cache(
                    {f"w{i}_{j}": {"source": "sweep", "bm": 8, "bo": 8,
                                   "bn": 8, "vmem_bytes": 1}}, path)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs
    entries = autotune.load_cache(path)
    assert set(entries) == {"seed"} | {f"w{i}_{j}"
                                       for i in range(4) for j in range(10)}


# ---------------------------------------------------------------------------
# Serving-path guards (the launcher end of the story)
# ---------------------------------------------------------------------------

SERVE = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen-steps", "2", "--sparsity", "0.5"]


def test_greedy_generate_overrun_raises():
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke("olmo-1b"), sparse_serving=True)
    bundle = build_model(cfg, "cpu")
    params = bundle.init(0)
    prompt = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="KV cache overrun"):
        serve.greedy_generate(bundle, params, prompt, steps=3, max_len=18)
    with pytest.raises(ValueError, match="KV cache overrun"):
        serve.guarded_generate(bundle, None, params, prompt, steps=8,
                               max_len=16)
    toks = serve.greedy_generate(bundle, params, prompt, steps=2, max_len=18)
    assert toks.shape == (2, 3)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_guard_quarantines_injected_nan(tmp_path, quant):
    """``serve --guard --inject-nan``: the injected layer is blamed and
    quarantined, the pass restarts and serving goes on (a quantized plan's
    injector poisons the scales)."""
    from repro_torch.launch import serve
    report_path = tmp_path / "degradation.json"
    results = serve.main(SERVE + ["--impl", "cuda", "--quant", quant,
                                  "--guard", "--inject-nan",
                                  "--report", str(report_path)])
    g = results["guard"]
    assert g["injected"] in g["quarantined"]
    assert [e["event"] for e in g["events"]] == ["nan_trip"]
    assert g["events"][0]["attributable"]
    assert g["events"][0]["poisoned_layers"] == [g["injected"]]
    assert g["degraded_mix"] == {"cuda->dense": 1}
    assert not g["degradations"]
    assert results["plan"]["quant"] == quant
    assert results["sparse"]["tokens_per_s"] > 0
    on_disk = json.loads(report_path.read_text())
    assert on_disk["guard"]["quarantined"] == g["quarantined"]
    assert on_disk["plan"]["cost"]["objective"] == "latency"


def test_serve_inject_nan_needs_guard():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(SERVE + ["--inject-nan"])


def test_serve_guard_ladder_survives_forced_cuda_failure():
    from repro_torch.launch import serve
    with faults.force_impl_failure("cuda"):
        results = serve.main(SERVE + ["--impl", "cuda", "--guard"])
    g = results["guard"]
    assert g["degradations"]                      # the ladder fired
    assert all(d["from_impl"] == "cuda" for d in g["degradations"])
    assert len(_demoted(g)) == 7                  # every planned layer
    assert g["degraded_mix"] == {"cuda->xla": 7} and not g["quarantined"]
    stats = results["plan"]["engine_stats"]
    assert stats["degraded_dispatch"] == stats["balanced_spmm"] > 0
    assert results["sparse"]["tokens_per_s"] > 0


def _demoted(g) -> set:
    return {d["layer"] for d in g["degradations"] if d["action"] == "demoted"}


def test_serve_guard_clean_plan_shows_no_degradation():
    """A clean plan under ``--guard``: no ladder event, no quarantine, no
    degraded dispatch — the ladder never hides a working rung."""
    from repro_torch.launch import serve
    results = serve.main(SERVE + ["--impl", "cuda", "--guard"])
    g = results["guard"]
    assert g["degradations"] == [] and g["events"] == []
    assert g["quarantined"] == [] and g["degraded_mix"] == {}
    assert "degraded_dispatch" not in results["plan"]["engine_stats"]


@pytest.mark.parametrize("poison,s,q_chunk,kv_chunk", [
    pytest.param("none", 8, 8, 8, id="none"),
    pytest.param("k_rows", 8, 8, 8, id="k_rows"),
    pytest.param("q_rows", 8, 8, 8, id="q_rows"),
    pytest.param("all_k", 8, 8, 8, id="all_k"),
    # a poisoned row inside the first kv chunk of a multi-chunk sequence:
    # the reference's online softmax weighs the later chunks by 0 there
    pytest.param("k_nan_first_chunk", 32, 16, 16, id="k_nan-s32-c16"),
    pytest.param("k_inf_first_chunk", 32, 16, 16, id="k_inf-s32-c16"),
    pytest.param("q_rows", 32, 16, 16, id="q_rows-s32-c16"),
    pytest.param("k_nan_first_chunk", 32, 8, 16, id="k_nan-s32-q8-kv16"),
    pytest.param("k_inf_first_chunk", 32, 8, 16, id="k_inf-s32-q8-kv16"),
    pytest.param("q_rows", 32, 8, 16, id="q_rows-s32-q8-kv16"),
    # one chunk, a NaN key beside a finite score above ~88: the
    # reference's exp overflows and its rows from the NaN key on are NaN;
    # the models' prefill attention gives the same, the unchunked twin
    # (`causal_attention`, no model's) finite rows (pinned, not hidden)
    pytest.param("k_nan_beside_overflow", 8, 8, 8, id="k_nan-overflow"),
])
def test_prefill_attention_non_finite_scores_as_reference(poison, s, q_chunk,
                                                          kv_chunk):
    """The reference's prefill attention gives a non-finite score no
    weight (a row with none finite gives zeros), so a NaN q / k projection
    is first seen in the decode step; the port's does the same, and equals
    it on finite inputs.  The models' prefill attention
    (`layers.prefill_attention`, always the chunked form) equals the
    reference's at every chunking, one chunk included, also where a
    poisoned key sits in the first of several kv chunks; the unchunked
    `causal_attention` equals it on one chunk but for one case: a row
    holding a NaN score and a finite one above ~88, where the reference's
    ``exp(sc - 0)`` overflows and the row is NaN (so is
    `prefill_attention`'s), while the unchunked twin's is finite and gives
    the NaN key no weight; the rows before the NaN key agree."""
    from repro.models.layers import blocked_causal_attention
    from repro_torch.models.layers import causal_attention, prefill_attention
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, s, 4, 16)).astype(np.float32)
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    if poison == "k_rows":
        k[:, 3] = np.nan
    elif poison == "q_rows":
        q[:, 5] = np.inf
    elif poison == "all_k":
        k[:] = np.nan
    elif poison == "k_nan_first_chunk":
        k[:, 3] = np.nan
    elif poison == "k_inf_first_chunk":
        k[:, 3] = np.inf
    elif poison == "k_nan_beside_overflow":
        q = np.abs(q) + 4.0          # every q . k0 / 4 >= 6 * 4 * 16 / 4 = 96
        k[:, 0] = 6.0
        k[:, 3] = np.nan
    want = blocked_causal_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    q_chunk=q_chunk, kv_chunk=kv_chunk)
    paths = [prefill_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               q_chunk=q_chunk, kv_chunk=kv_chunk)]
    if s == kv_chunk:
        paths.append(causal_attention(*(torch.from_numpy(a)
                                        for a in (q, k, v))))
    if poison == "k_nan_beside_overflow":
        want = np.asarray(want)
        assert np.isnan(want[:, 3:]).all() and np.isfinite(want[:, :3]).all()
        got, twin = paths
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        assert np.isnan(got[:, 3:].numpy()).all()
        # the unchunked twin's rows 4.. are the softmax over the finite
        # scores alone: the same attention with position 3 taken out of
        # q, k and v
        rule = causal_attention(*(torch.from_numpy(np.delete(a, 3, axis=1))
                                  for a in (q, k, v)))
        assert bool(torch.isfinite(twin).all())
        np.testing.assert_allclose(twin[:, :3].numpy(), want[:, :3],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(twin[:, 4:].numpy(), rule[:, 3:].numpy(),
                                   rtol=1e-5, atol=1e-5)
        return
    for got in paths:
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_guarded_generate_equals_reference_on_converted_params():
    """The guarded pass on the reference's olmo-1b smoke params, converted:
    the same NaN trip, blamed layer and quarantine as the reference's, and
    greedy tokens equal to the reference's greedy decode on its repaired
    plan (f32 compute)."""
    from repro.configs import get_smoke as ref_get_smoke
    from repro.launch import serve as ref_serve
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy
    ref_cfg = dataclasses.replace(ref_get_smoke("olmo-1b"),
                                  compute_dtype="float32", sparse_serving=True)
    cfg = dataclasses.replace(get_smoke("olmo-1b"), compute_dtype="float32",
                              sparse_serving=True)
    ref_m = ref_build_model(ref_cfg)
    params_j = ref_m.init(jax.random.key(0))
    m = build_model(cfg, "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    plan_j = ref_plan.plan_model(ref_cfg, params_j, sparsity=0.5, impl="xla",
                                 m_hint=16)
    plan = engine_plan.plan_model(cfg, params, sparsity=0.5, impl="xla",
                                  m_hint=16)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    ref_blocks_j = ref_plan.masked_dense_params(params_j, plan_j)["blocks"]
    ref_blocks = engine_plan.masked_dense_params(params, plan)["blocks"]
    poisoned_j, name_j = ref_faults.inject_nan_output(plan_j)
    poisoned, name = faults.inject_nan_output(plan)
    assert name == name_j
    _, fixed_j, events_j = ref_serve.guarded_generate(
        ref_m, poisoned_j, params_j, jnp.asarray(prompt), 3, 12,
        prefill_fn=jax.jit(ref_m.prefill),
        decode_fn=jax.jit(ref_m.decode_step), ref_blocks=ref_blocks_j)
    toks, fixed, events = serve.guarded_generate(
        m, poisoned, params, torch.from_numpy(prompt), 3, 12,
        ref_blocks=ref_blocks)
    assert events == events_j
    assert fixed.quarantined() == fixed_j.quarantined() == (name,)
    assert {nm: IMPLS[lp.spec.impl] for nm, lp in fixed.layers.items()} == \
        {nm: lp.spec.impl for nm, lp in fixed_j.layers.items()}
    want = ref_serve.greedy_generate(ref_m, {**params_j,
                                             "sparse_plan": fixed_j},
                                     jnp.asarray(prompt), 3, 12)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


@pytest.mark.cuda
def test_cuda_clean_plan_hardens_without_degradation():
    """On the card: a clean olmo-1b smoke plan on the ``cuda`` rung probes
    clean (no ladder event), and under a forced ``cuda`` failure every
    layer moves to ``xla`` and then launches no tiled kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import balanced_spmm
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_smoke("olmo-1b"), sparse_serving=True)
    params = build_model(cfg, "cuda").init(0)
    plan = engine_plan.plan_model(cfg, params, sparsity=0.5, impl="cuda")
    hardened, events = guard.harden_plan(plan)
    assert events == () and hardened.degraded_mix() == {}
    with faults.force_impl_failure("cuda"):
        demoted, events = guard.harden_plan(plan)
    assert demoted.impl_mix() == {"xla": len(plan.layers)}
    balanced_spmm.reset_launches()
    x = torch.randn((4, cfg.d_model), device="cuda").to(torch.bfloat16)
    execute.apply_fc(x, demoted.per_layer[0]["wq"])
    assert sum(balanced_spmm.LAUNCHES.values()) == 0
