"""Continuous batching on the port's live mesh, on the CPU: the paged
engine (`serving.ServingEngine` with ``mesh=``) run by `torch.distributed`
ranks over ``gloo``, its pool placed by the reference's `paged_pool_specs`.

On ``(data=2, model=2)`` (pool and view planes split four ways, rows
crossing ranks in the exchange) and on ``(data=1, model=3)`` (no split
divides the smoke pool's planes: every rank holds the whole pool and the
exchange moves nothing), the olmo-1b smoke config at float32 with its
plan and the scatter cache write (the kv kernel's plain version): the
paged run's logits equal the contiguous engine's exactly on
every rank, its greedy tokens equal the JAX reference engine's
(`repro.serving.ServingEngine` on the converted params and the
reference's plan) with the logits within 1e-4,
and each rank's pool block has `shard_shape`'s shape, holds the numpy
slice of a one-process engine's pool that `paged_pool_specs` names (bf16
KV, within a bf16 rounding) and equals bit for bit every rank that holds
the same block.  Once on ``(data=2, model=2)``: the deepseek-moe-16b
smoke config against the JAX reference engine (and the port's
one-process engine), a NaN-poisoned
request quarantined on every rank while the rest finish, and a
Poisson-fed run whose rank 3 starts late (every rank's tick log equals
rank 0's: the ranks run by rank 0's clock).  And ``serve --traffic
--mesh`` end to end with its own gates."""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as ref_serving  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import ServingEngine, paged_kv  # noqa: E402
from repro_torch.testing import multidevice  # noqa: E402
from test_torch_multidevice import _fake_mesh, _np_slice  # noqa: E402

MESHES = {"data2_model2": (("data", "model"), (2, 2)),
          "data1_model3": (("data", "model"), (1, 3))}
PLAN_KW = dict(sparsity=0.5, impl="cuda", m_hint=16)
ENGINE = dict(num_pages=7, page_size=4, max_slots=2, max_pages_per_slot=3,
              prefill_chunk=3)
MAX_LEN = 12             # the contiguous twin's width: 3 pages of 4
TOL = 1e-4
KV_TOL = 2 ** -7         # one bf16 rounding of the f32 KV rows
POISON = (0, 2)          # request 0's planes turn NaN after two ticks
LATE = (3, 0.3, (0.0, 0.4, 0.8, 1.2))   # rank, delay, arrivals (s)
LIMIT_S = 120.0          # the launcher's limit on a mesh case


def _requests(rng, n, vocab):
    return [(np.asarray(rng.integers(0, vocab, rng.integers(2, 7)),
                        np.int32), int(rng.integers(1, 5))) for _ in range(n)]


def _cfgs(arch):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32",
                                  sparse_serving=True)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                              sparse_serving=True, cache_update="scatter")
    return ref_cfg, cfg


@functools.lru_cache(maxsize=None)
def _dense():
    """The olmo-1b smoke params (numpy, from the reference's init), its
    requests, the reference engine's tokens and logits on them (its plan
    on the ``xla`` rung, the port's on ``cuda``'s plain version) and a
    one-process port engine's pool after the same run."""
    ref_cfg, cfg = _cfgs("olmo-1b")
    ref_m = ref_build_model(ref_cfg)
    params_j = ref_m.init(jax.random.key(0))
    plan_j = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="xla", m_hint=16)
    reqs = _requests(np.random.default_rng(4), 4, cfg.vocab_size)
    # without ``mesh=``: this JAX refuses the reference engine's gather
    # on a pool placed on its one-device host mesh (ShardingTypeError);
    # the reference places the pool for layout only, its values the same
    ref = ref_serving.ServingEngine(
        ref_m, {**params_j, "sparse_plan": plan_j}, record_logits=True,
        **ENGINE)
    for p, g in reqs:
        ref.submit(p, g)
    ref.run()
    params_np = jax.tree.map(np.asarray, params_j)
    whole = params_from_numpy(params_np, "cpu")
    one = ServingEngine(build_model(cfg, "cpu"),
                        {**whole, "sparse_plan": engine_plan.plan_model(
                            cfg, whole, **PLAN_KW)}, **ENGINE)
    for p, g in reqs:
        one.submit(p, g)
    one.run()
    return (cfg, params_np, reqs,
            {r.rid: r.out_tokens for r in ref.sched.done},
            {i: np.stack(v) for i, v in ref.logits_trace.items()},
            {k: v.float().numpy() for k, v in one.pool.items()})


@functools.lru_cache(maxsize=None)
def _moe():
    """The deepseek-moe-16b smoke params (numpy, from the reference's
    init), requests, the reference engine's tokens and logits on them
    (its plan on the ``xla`` rung) and the port's one-process engine's
    tokens."""
    ref_cfg, cfg = _cfgs("deepseek-moe-16b")
    ref_m = ref_build_model(ref_cfg)
    params_j = ref_m.init(jax.random.key(3))
    plan_j = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="xla", m_hint=16)
    reqs = _requests(np.random.default_rng(5), 3, cfg.vocab_size)
    ref = ref_serving.ServingEngine(
        ref_m, {**params_j, "sparse_plan": plan_j}, record_logits=True,
        **ENGINE)
    for p, g in reqs:
        ref.submit(p, g)
    ref.run()
    params_np = jax.tree.map(np.asarray, params_j)
    whole = params_from_numpy(params_np, "cpu")
    one = ServingEngine(build_model(cfg, "cpu"),
                        {**whole, "sparse_plan": engine_plan.plan_model(
                            cfg, whole, **PLAN_KW)}, **ENGINE)
    for p, g in reqs:
        one.submit(p, g)
    one.run()
    return (cfg, params_np, reqs,
            {r.rid: r.out_tokens for r in ref.sched.done},
            {i: np.stack(v) for i, v in ref.logits_trace.items()},
            {r.rid: r.out_tokens for r in one.sched.done})


def _case(cfg, params_np, reqs, **kw) -> dict:
    return {"cfg": cfg, "params_np": params_np, "plan_kwargs": PLAN_KW,
            "requests": reqs, "engine": ENGINE, **kw}


@functools.lru_cache(maxsize=None)
def _run(mesh_name: str, tmp: str) -> list:
    """Every rank's results of the mesh's cases: the dense case with its
    contiguous twin; on ``data2_model2`` also the MoE, poison and
    late-start cases."""
    axes, sizes = MESHES[mesh_name]
    cfg, params_np, reqs = _dense()[:3]
    cases = [_case(cfg, params_np, reqs, max_len=MAX_LEN)]
    if mesh_name == "data2_model2":
        mcfg, mparams, mreqs = _moe()[:3]
        cases += [_case(mcfg, mparams, mreqs, max_len=MAX_LEN),
                  _case(cfg, params_np, reqs[:3], poison=POISON),
                  _case(cfg, params_np, reqs, late=LATE)]
    return run_ranks(multidevice.traffic_cases, math.prod(sizes),
                     init_method=f"file://{tmp}/{mesh_name}",
                     args=(axes, sizes, cases), timeout_s=LIMIT_S)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("traffic_mesh"))


def _logits_close(got: dict, want: dict, tol: float) -> None:
    assert sorted(got) == sorted(want)
    for rid, rows in want.items():
        np.testing.assert_allclose(got[rid], rows, rtol=tol, atol=tol)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_engine_equals_reference_engine(mesh_name, tmp):
    cfg, _, _, want_toks, want_logits, _ = _dense()
    for r in _run(mesh_name, tmp):
        got = r[0]
        assert got["contiguous_diff"] == 0.0
        assert got["tokens"] == want_toks and all(want_toks.values())
        _logits_close(got["logits"], want_logits, TOL)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_mesh_pool_blocks_follow_paged_pool_specs(mesh_name, tmp):
    """Each rank's pool block: `shard_shape`'s shape, the numpy slice of
    the one-process pool by `paged_pool_specs` (within a bf16 rounding of
    the KV rows), bit for bit the block of every rank holding the same
    planes; on ``data1_model3`` the whole pool on every rank."""
    cfg, *_, whole = _dense()
    axes, sizes = MESHES[mesh_name]
    size_of = dict(zip(axes, sizes))
    ranks = _run(mesh_name, tmp)
    n_planes = ENGINE["num_pages"] * cfg.n_kv_heads
    by_block: dict = {}
    for rank, r in enumerate(ranks):
        mesh = _fake_mesh(axes, sizes, rank)
        specs = paged_kv.paged_pool_specs(mesh, ENGINE["num_pages"],
                                          cfg.n_kv_heads)
        got = r[0]
        assert tuple(got["pool_block"]) == paged_kv.plane_block(mesh, n_planes)
        for k, bits in got["pool"].items():
            assert bits.shape == shd.shard_shape(mesh, whole[k].shape,
                                                 specs[k])
            vals = torch.from_numpy(bits).view(torch.bfloat16).float().numpy()
            np.testing.assert_allclose(
                vals, _np_slice(whole[k], got["coord"], size_of, specs[k]),
                rtol=KV_TOL, atol=KV_TOL)
            same = by_block.setdefault((k, tuple(got["pool_block"])), bits)
            np.testing.assert_array_equal(bits, same)
    if mesh_name == "data1_model3":
        assert all(tuple(r[0]["pool_block"]) == (0, n_planes) for r in ranks)
    else:
        assert len({tuple(r[0]["pool_block"]) for r in ranks}) == 4


def test_mesh_moe_engine_equals_one_process(tmp):
    """The MoE smoke config on ``(data=2, model=2)``: paged vs contiguous
    exactly 0.0 on every rank, greedy tokens equal to the JAX reference
    engine's and to the port's one-process engine's, the logits within
    1e-4 of the reference's."""
    want_toks, want_logits, one_toks = _moe()[3:]
    assert one_toks == want_toks
    for r in _run("data2_model2", tmp):
        got = r[1]
        assert got["contiguous_diff"] == 0.0
        assert got["tokens"] == want_toks and all(want_toks.values())
        _logits_close(got["logits"], want_logits, TOL)


def test_mesh_quarantines_poisoned_request_on_every_rank(tmp):
    """Request 0's pool planes turn NaN mid-decode on every rank: each
    rank quarantines it alike (the logits come whole from the vocab
    ``all_reduce``), wipes its own planes of it, and finishes the rest
    with their whole budgets; every pool block stays finite."""
    reqs = _dense()[2][:3]
    for r in _run("data2_model2", tmp):
        got = r[2]
        assert got["states"][0] == "quarantined"
        assert [e["rid"] for e in got["events"]
                if e["event"] == "request_quarantine"] == [0]
        for rid in (1, 2):
            assert got["states"][rid] == "finished"
            assert len(got["tokens"][rid]) == reqs[rid][1]
        assert got["finite"]


def test_mesh_ranks_keep_lock_step_with_a_late_rank(tmp):
    """Rank 3 starts the Poisson-fed run 0.3 s after the others: every
    rank's tick log (rank 0's clock readings, kinds, request ids, chunks
    and fused steps) equals rank 0's, the arrivals were admitted over
    several ticks, and every request finished."""
    ranks = _run("data2_model2", tmp)
    ticks = ranks[0][3]["ticks"]
    for r in ranks:
        assert r[3]["ticks"] == ticks
        assert set(r[3]["states"].values()) == {"finished"}
    first_seen = {}
    for now, _, rids, _, _ in ticks:
        for rid in rids:
            first_seen.setdefault(rid, now)
    assert len(set(first_seen.values())) > 1


def test_serve_traffic_mesh_entry_point(tmp_path):
    """``serve --traffic --mesh data=2,model=2`` of the smoke olmo-1b:
    its own gates (paged vs contiguous 0.0 on every rank, replay tokens
    equal to one process, logits within the tolerance, pool bytes equal
    to `shard_bytes`, replay launches equal to one process's), and every
    rank's replay exchanged rows with the others."""
    res = serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                      "--impl", "cuda", "--traffic", "--mesh",
                      "data=2,model=2", "--requests", "4", "--rate", "200",
                      "--prompt-len", "8", "--gen-steps", "4", "--slots",
                      "2", "--page-size", "4", "--prefill-chunk", "3",
                      "--dist-init", f"file://{tmp_path}/rendezvous"])["mesh"]
    assert res["mode"] == "traffic" and res["parity_max_abs_diff"] == 0.0
    assert res["tokens_equal"] and res["bytes_equal"]
    assert res["launches_equal"] and res["lock_step"]
    assert res["logits_max_abs_diff"] <= res["parity_tol"]
    assert len(res["ranks"]) == 4
    for r in res["ranks"]:
        assert r["replay_collectives"]["all_to_all"]["ops"] > 0
        assert r["pool_bytes"]["paged"]["resident"] \
            == r["pool_bytes"]["paged"]["shard_bytes"]
    assert res["continuous"]["requests"] == res["static"]["requests"] == 4
