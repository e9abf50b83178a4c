"""The port's cost-objective planning against the JAX reference (twins of
`tests/test_cost_model.py`'s plan, bytes and guard tests): the same
numpy-seeded weights (or the reference's params, converted array by
array) planned by both packages under every objective x deployment give
equal `PlanSpec`s (mode, impl, KB, packing, blocks, `CostTag` fields;
reference ``pallas`` <-> port ``cuda``) and equal `cost_summary()`s at
smallcnn, olmo-1b smoke and deepseek-moe-16b smoke; the bytes a dispatch
streams (`execute.bytes_stats`) equal the cost tag's and the reference's
counters exactly; stale or bogus tags are guard violations."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.core import pruning as ref_pruning  # noqa: E402
from repro.engine import execute as ref_execute  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.launch import cost_model as ref_cost  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import guard  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import cost_model  # noqa: E402
from repro_torch.launch.cost_model import pytree_nbytes  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

IMPLS = {"cuda": "pallas", "xla": "xla", "xla_gather": "xla_gather",
         "dense": "dense"}
DEPLOYMENTS = (None,) + tuple(sorted(cost_model.DEPLOYMENTS))


def _t(a):
    return params_from_numpy(jax.tree.map(np.asarray, a), "cpu")


def _spec_fields(spec) -> dict:
    """A spec's fields with the reference's impl names (``cuda`` ->
    ``pallas``); nested dataclasses (BlockChoice, CostTag) as dicts."""
    d = dataclasses.asdict(spec)
    d["impl"] = IMPLS.get(d["impl"], d["impl"])
    if d["degraded_from"]:
        d["degraded_from"] = IMPLS[d["degraded_from"]]
    return d


def _assert_plans_equal(got, want):
    assert sorted(got.layers) == sorted(want.layers)
    for nm in want.layers:
        assert _spec_fields(got.layers[nm].spec) == \
            dataclasses.asdict(want.layers[nm].spec), nm
    assert got.meta == want.meta
    assert got.cost_summary() == want.cost_summary()
    assert got.mode_mix() == want.mode_mix()
    assert {IMPLS[k]: v for k, v in got.impl_mix().items()} == \
        want.impl_mix()


@functools.lru_cache(maxsize=None)
def _smallcnn():
    """Both packages' smallcnn config, params (the reference's, converted)
    and balanced masks (convs 0.5, fc1 0.8)."""
    cfg_j = ref_cnn.SmallCNNConfig(channels=(8, 16), img=16, fc_hidden=32)
    params_j = ref_cnn.smallcnn_init(cfg_j, jax.random.key(0))
    masks_j = {}
    for i in range(len(cfg_j.channels)):
        _, masks_j[f"conv{i}"] = ref_pruning.balanced_prune_conv(
            params_j[f"conv{i}"], 0.5)
    _, masks_j["fc1"] = ref_pruning.balanced_prune_rows(params_j["fc1"], 0.8)
    cfg = cnn.SmallCNNConfig(channels=(8, 16), img=16, fc_hidden=32)
    return cfg_j, params_j, masks_j, cfg, _t(params_j), _t(masks_j)


@functools.lru_cache(maxsize=None)
def _transformer(arch):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), sparse_serving=True)
    cfg = dataclasses.replace(get_smoke(arch), sparse_serving=True)
    params_j = ref_build_model(ref_cfg).init(jax.random.key(0))
    return ref_cfg, params_j, cfg, _t(params_j)


# ---------------------------------------------------------------------------
# module 1: the cost model's objectives and deployments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ref_cost.OBJECTIVES)
def test_objective_score_identical(objective):
    assert cost_model.OBJECTIVES == ref_cost.OBJECTIVES
    rng = np.random.default_rng(3)
    for name in DEPLOYMENTS:
        dep, ref_dep = cost_model.get_deployment(name), \
            ref_cost.get_deployment(name)
        assert dataclasses.asdict(dep) == dataclasses.asdict(ref_dep)
        for _ in range(5):
            d = int(rng.integers(1, 1 << 40))
            macs = int(rng.integers(1, 1 << 30))
            e = cost_model.layer_energy_pj(d, macs, dep)
            lat = cost_model.layer_latency_s(d, macs, dep)
            assert e == ref_cost.layer_energy_pj(d, macs, ref_dep)
            assert cost_model.objective_score(
                objective, dram_bits=d, energy_pj=e, latency_s=lat) == \
                ref_cost.objective_score(objective, dram_bits=d,
                                         energy_pj=e, latency_s=lat)


def test_deployment_objects_and_lookup():
    assert cost_model.get_deployment(None).name == "zcu102"
    assert cost_model.get_deployment("edge-4k").weight_buffer_bits \
        < cost_model.get_deployment("edge-64k").weight_buffer_bits \
        < cost_model.get_deployment("zcu102").weight_buffer_bits
    assert cost_model.get_deployment(cost_model.DEPLOYMENTS["edge-64k"]) \
        is cost_model.DEPLOYMENTS["edge-64k"]
    with pytest.raises(KeyError):
        cost_model.get_deployment("gameboy")
    assert sorted(cost_model.DEPLOYMENTS) == sorted(ref_cost.DEPLOYMENTS)


# ---------------------------------------------------------------------------
# module 2: plans under every objective x deployment
# ---------------------------------------------------------------------------

def test_latency_objective_plan_identity():
    """objective="latency" is the default path: an explicit latency plan
    equals the default one (specs, weights, meta), every layer carries a
    latency-objective tag, and both equal the reference's."""
    cfg_j, params_j, masks_j, cfg, params, masks = _smallcnn()
    p1 = engine_plan.plan_smallcnn(cfg, params, masks, impl="cuda")
    p2 = engine_plan.plan_smallcnn(cfg, params, masks, impl="cuda",
                                   objective="latency")
    assert p1.meta == p2.meta
    for nm in p1.layers:
        assert p1.layers[nm].spec == p2.layers[nm].spec
        assert p1.layers[nm].spec.cost.objective == "latency"
        for a, b in zip(cost_model._leaves(p1.layers[nm].weights),
                        cost_model._leaves(p2.layers[nm].weights)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    _assert_plans_equal(p1, ref_plan.plan_smallcnn(cfg_j, params_j, masks_j,
                                                   impl="pallas"))


def test_non_default_objective_stamps_meta():
    cfg_j, params_j, masks_j, cfg, params, masks = _smallcnn()
    p = engine_plan.plan_smallcnn(cfg, params, masks, objective="dram",
                                  deployment="edge-64k")
    meta = dict(p.meta)
    assert meta["objective"] == "dram" and meta["deployment"] == "edge-64k"
    cs = p.cost_summary()
    assert cs["objective"] == "dram" and cs["deployment"] == "edge-64k"
    assert cs["untagged"] == 0
    assert cs["total_dram_bytes"] > 0 and cs["total_energy_pj"] > 0
    want = ref_plan.plan_smallcnn(cfg_j, params_j, masks_j, objective="dram",
                                  deployment="edge-64k")
    assert cs == want.cost_summary()


@pytest.mark.parametrize("objective", ref_cost.OBJECTIVES)
@pytest.mark.parametrize("impl", ["cuda", "xla"])
def test_smallcnn_plans_equal_every_deployment(impl, objective):
    cfg_j, params_j, masks_j, cfg, params, masks = _smallcnn()
    for dep in DEPLOYMENTS:
        got = engine_plan.plan_smallcnn(cfg, params, masks, impl=impl,
                                        objective=objective, deployment=dep)
        want = ref_plan.plan_smallcnn(cfg_j, params_j, masks_j,
                                      impl=IMPLS[impl], objective=objective,
                                      deployment=dep)
        _assert_plans_equal(got, want)


@pytest.mark.parametrize("objective", ref_cost.OBJECTIVES)
@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
def test_transformer_plans_equal_every_deployment(arch, objective):
    """Every field of every PlanSpec and the cost summary, at the smoke
    configs, for each deployment profile (int8 once per arch: the
    quantized format bits and MAC energies)."""
    ref_cfg, params_j, cfg, params = _transformer(arch)
    for dep in DEPLOYMENTS:
        for quant in ("none", "int8") if dep == "edge-64k" else ("none",):
            kw = dict(sparsity=0.5, m_hint=32, objective=objective,
                      deployment=dep, quant=quant)
            got = engine_plan.plan_model(cfg, params, impl="cuda", **kw)
            want = ref_plan.plan_model(ref_cfg, params_j, impl="pallas", **kw)
            _assert_plans_equal(got, want)


def test_dram_objective_flips_mode_at_llm_dims():
    """An olmo-1b-sized projection (2048 x 2048, 50% sparse) exceeds the
    ZCU102 weight buffer: the latency objective keeps the GEMV ON_CHIP
    label, the dram objective re-modes it to a streaming dataflow and
    models no more traffic; both as the reference plans it."""
    w_np = np.random.default_rng(0).standard_normal((1, 2048, 2048),
                                                    np.float32)
    w = torch.from_numpy(w_np).to(torch.bfloat16)
    w_j = jnp.asarray(w_np).astype(jnp.bfloat16)
    kw = dict(sparsity=0.5, impl="xla", m_hint=256)
    lat = engine_plan._plan_stacked("wq", w, cd=torch.bfloat16, **kw)
    dram = engine_plan._plan_stacked("wq", w, cd=torch.bfloat16,
                                     objective="dram", **kw)
    assert lat.spec.mode == "ON_CHIP"
    assert dram.spec.mode in ("RIF", "RWF")
    assert dram.spec.cost.dram_bits <= lat.spec.cost.dram_bits
    assert dram.spec.cost.w_total_bytes == lat.spec.cost.w_total_bytes \
        == pytree_nbytes(dram.weights)
    want = ref_plan._plan_stacked("wq", w_j, cd=jnp.bfloat16,
                                  objective="dram", **kw)
    assert _spec_fields(dram.spec) == dataclasses.asdict(want.spec)


@pytest.mark.parametrize("impl", ["cuda", "xla"])
@pytest.mark.parametrize("sparsity", [0.2, 0.5])
def test_objective_impl_flip_equal_reference(sparsity, impl):
    """The impl co-optimization: at 20% sparsity the dense stream beats
    the encoding under the dram / balanced objectives (the impl flips to
    dense, never up the ladder); at 50% it does not.  Every decision and
    tag as the reference's."""
    w_np = np.random.default_rng(0).standard_normal((2, 256, 128),
                                                    np.float32)
    w = torch.from_numpy(w_np).to(torch.bfloat16)
    w_j = jnp.asarray(w_np).astype(jnp.bfloat16)
    flipped = 0
    for objective in ref_cost.OBJECTIVES:
        for dep in DEPLOYMENTS:
            kw = dict(sparsity=sparsity, m_hint=32, objective=objective,
                      deployment=dep)
            got = engine_plan._plan_stacked("w", w, impl=impl,
                                            cd=torch.bfloat16, **kw)
            want = ref_plan._plan_stacked("w", w_j, impl=IMPLS[impl],
                                          cd=jnp.bfloat16, **kw)
            assert _spec_fields(got.spec) == dataclasses.asdict(want.spec)
            flipped += got.spec.impl == "dense"
    assert (flipped > 0) == (sparsity < 0.5)


def test_stacked_per_dispatch_stream_bytes():
    """A stacked plan tags one dispatch: the leading layer axis divides
    the stored total exactly."""
    n_layers = 4
    w_np = np.random.default_rng(0).standard_normal((n_layers, 64, 96),
                                                    np.float32)
    lp = engine_plan._plan_stacked("wq", torch.from_numpy(w_np),
                                   sparsity=0.5, impl="xla", m_hint=16,
                                   cd=torch.float32)
    tag = lp.spec.cost
    total = pytree_nbytes(lp.weights)
    assert tag.w_total_bytes == total == lp.nbytes()
    assert tag.w_stream_bytes * n_layers == total
    assert tag.w_stream_bytes == lp.layer(0).nbytes()
    want = ref_plan._plan_stacked("wq", jnp.asarray(w_np), sparsity=0.5,
                                  impl="xla", m_hint=16, cd=jnp.float32)
    assert dataclasses.asdict(tag) == dataclasses.asdict(want.spec.cost)


# ---------------------------------------------------------------------------
# module 5: the model-vs-measurement byte contract
# ---------------------------------------------------------------------------

def _fc_pair(impl, o=64, n=128, m=32, quant="none"):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((o, n), np.float32)
    _, mask = ref_pruning.balanced_prune_rows(jnp.asarray(w), 0.5)
    mask = np.array(mask)
    x = rng.standard_normal((m, n), np.float32)
    lp = engine_plan.build_layer_plan(
        "fc0", torch.from_numpy(w), mask=torch.from_numpy(mask), impl=impl,
        m_hint=m, quant=quant)
    lp_j = ref_plan.build_layer_plan("fc0", jnp.asarray(w),
                                     mask=jnp.asarray(mask),
                                     impl=IMPLS[impl], m_hint=m, quant=quant)
    return lp, lp_j, x


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("impl", ["xla", "cuda"])
def test_fc_stream_bytes_match_stats_exactly(impl, quant):
    """The tag's stored bytes equal what a dispatch streams — and the
    reference's counters for the same call — as integers, no tolerance."""
    lp, lp_j, x = _fc_pair(impl, quant=quant)
    execute.reset_stats()
    execute.apply_fc(torch.from_numpy(x), lp)
    bs = execute.bytes_stats()["fc0"]
    tag = lp.spec.cost
    assert bs["bytes_weights"] == tag.w_stream_bytes == pytree_nbytes(
        lp.weights)
    assert bs["bytes_act_in"] == tag.act_in_bytes == x.size * x.itemsize
    assert bs["bytes_act_out"] == tag.act_out_bytes == 32 * 64 * x.itemsize
    assert bs["dispatches"] == 1
    assert execute.stats()["bytes_weights"] == bs["bytes_weights"]
    ref_execute.reset_stats()
    # a jit of its own: the reference's counters tick only while it traces,
    # and its own tests jit `apply_fc` at these shapes (a shared trace cache
    # would leave theirs, or this, uncounted)
    jax.block_until_ready(jax.jit(lambda x, lp: ref_execute.apply_fc(x, lp))(
        jnp.asarray(x), lp_j))
    assert bs == ref_execute.bytes_stats()["fc0"]
    assert dataclasses.asdict(tag) == dataclasses.asdict(lp_j.spec.cost)


def test_conv_stream_bytes_match_stats_exactly():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 8, 3, 3), np.float32)
    _, mask = ref_pruning.balanced_prune_conv(jnp.asarray(w), 0.5)
    mask = np.array(mask)
    x = rng.standard_normal((2, 16, 16, 8), np.float32)
    lp = engine_plan.build_layer_plan("conv0", torch.from_numpy(w),
                                      mask=torch.from_numpy(mask),
                                      impl="xla", m_hint=64)
    execute.reset_stats()
    execute.apply_conv(torch.from_numpy(x), lp)
    bs = execute.bytes_stats()["conv0"]
    assert bs["bytes_weights"] == lp.spec.cost.w_stream_bytes \
        == pytree_nbytes(lp.weights)
    assert bs["bytes_act_in"] == x.size * x.itemsize
    assert bs["dispatches"] == 1
    lp_j = ref_plan.build_layer_plan("conv0", jnp.asarray(w),
                                     mask=jnp.asarray(mask), kind="conv",
                                     impl="xla", m_hint=64)
    ref_execute.reset_stats()
    jax.block_until_ready(jax.jit(lambda x, lp: ref_execute.apply_conv(
        x, lp))(jnp.asarray(x), lp_j))          # a jit of its own, as above
    assert bs == ref_execute.bytes_stats()["conv0"]


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
def test_model_bytes_equal_tag_times_dispatches(arch):
    """After one prefill and one decode step every planned layer's counted
    weight bytes equal its tag's ``w_stream_bytes`` x dispatches, and one
    dispatch per layer per forward (the contract chip_smoke phase 18 holds
    at full width)."""
    _, _, cfg, params = _transformer(arch)
    plan = engine_plan.plan_model(cfg, params, sparsity=0.5, impl="cuda",
                                  m_hint=16, objective="dram",
                                  deployment="edge-64k")
    m = build_model(cfg, "cpu")
    sparse = {**params, "sparse_plan": plan}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)))
    from repro_torch.models.api import merge_prefill_cache
    execute.reset_stats()
    with torch.no_grad():
        lg, pfc = m.prefill(sparse, {"tokens": tokens})
        m.decode_step(sparse, {"tokens": lg.argmax(-1)[:, None],
                               "cache_len": torch.full((2,), 8)},
                      merge_prefill_cache(m.init_cache(2, 12), pfc))
    bs = execute.bytes_stats()
    assert sorted(bs) == sorted(plan.layers)
    for nm, lp in plan.layers.items():
        assert bs[nm]["dispatches"] == 2 * cfg.n_layers, nm
        assert bs[nm]["bytes_weights"] == \
            lp.spec.cost.w_stream_bytes * bs[nm]["dispatches"], nm


# ---------------------------------------------------------------------------
# guard: stale cost tags are structural violations
# ---------------------------------------------------------------------------

def _fc_plan_with_tag():
    lp, lp_j, _ = _fc_pair("xla", o=32, n=64, m=8)
    return lp, lp_j


def test_guard_accepts_fresh_tag():
    lp, _ = _fc_plan_with_tag()
    assert guard.validate_layer(lp).ok


@pytest.mark.parametrize("bad", [
    {"w_total_bytes": 1},                     # disagrees with the weights
    {"mode": "WARP"},                         # unknown dataflow mode
    {"objective": "vibes"},                   # unknown objective
    {"energy_pj": float("nan")},              # non-finite figure
])
def test_guard_flags_stale_or_bogus_tag(bad):
    from repro.engine import guard as ref_guard
    lp, lp_j = _fc_plan_with_tag()
    stale = engine_plan.LayerPlan(
        spec=dataclasses.replace(
            lp.spec, cost=dataclasses.replace(lp.spec.cost, **bad)),
        weights=lp.weights)
    report = guard.validate_layer(stale)
    assert not report.ok
    assert all(v.check.startswith("cost_") for v in report.violations)
    stale_j = ref_plan.LayerPlan(
        spec=dataclasses.replace(
            lp_j.spec, cost=dataclasses.replace(lp_j.spec.cost, **bad)),
        weights=lp_j.weights)
    assert {v.check for v in report.violations} == \
        {v.check for v in ref_guard.validate_layer(stale_j).violations}


@pytest.mark.parametrize("impl", ["dense", "xla_gather"])
def test_guard_demotion_drops_stale_tag(impl):
    """A re-encoding demotion drops the tag (its byte counts no longer
    hold), and the demoted layer validates."""
    lp, _ = _fc_plan_with_tag()
    demoted = execute.demote_layer(lp, to_impl=impl)
    assert demoted.spec.impl == impl and demoted.spec.degraded_from == "xla"
    if pytree_nbytes(demoted.weights) != pytree_nbytes(lp.weights):
        assert demoted.spec.cost is None
    assert guard.validate_layer(demoted).ok
