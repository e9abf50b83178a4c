"""The port's continuous-batching runtime (`repro_torch.serving`) against
the reference's (`repro.serving`), twins of tests/test_serving.py.

Host layer (NumPy, copied as it is): page conservation and no aliasing
under churn, tick sequences and allocator states identical to the
reference scheduler's, full-budget admission, the allocator's errors, and
the page-table index builders identical to the reference's.

Engine layer (olmo smoke on the CPU; the kernels' plain versions): the
paged pool's logits bitwise equal to a contiguous cache's, under both
``cache_update`` modes; the per-request NaN quarantine; greedy tokens
equal to the reference engine's on converted weights (f32 compute); and
``serve --traffic --smoke --device cpu`` end to end with parity 0.0."""
import dataclasses
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import serving as ref_serving  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.serving import paged_kv as ref_paged_kv  # noqa: E402
from repro.serving import traffic as ref_traffic  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import kv_cache_update as kv  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import (OutOfPages, PageAllocator,  # noqa: E402
                                 PageTable, Scheduler, ServingEngine,
                                 contiguous_engine, paged_kv, traffic)
from repro_torch.serving.pages import NULL_PAGE  # noqa: E402

# ---------------------------------------------------------------------------
# host-layer churn driver (the reference test's, over either package)
# ---------------------------------------------------------------------------


def _make_sched(pkg=None, *, max_slots=3, max_pages_per_slot=6, page_size=4,
                num_pages=16, prefill_chunk=3, max_batch=4):
    pt, pa, sc = (PageTable, PageAllocator, Scheduler) if pkg is None else \
        (pkg.PageTable, pkg.PageAllocator, pkg.Scheduler)
    table = pt(max_slots=max_slots, max_pages_per_slot=max_pages_per_slot,
               page_size=page_size)
    alloc = pa(num_pages)
    return sc(table, alloc, prefill_chunk=prefill_chunk,
              max_batch=max_batch), table, alloc


def _check_no_aliasing(table, alloc) -> None:
    """Every mapped page is owned by exactly one slot, and the table's
    live pages are exactly the allocator's owned set."""
    live = [int(p) for p in table.table.ravel() if p != NULL_PAGE]
    assert len(live) == len(set(live)), f"page aliased across slots: {live}"
    assert set(live) == alloc._owned
    assert alloc.free_pages + len(live) == alloc.num_pages - 1


def _drive(sched, rng: random.Random, *, quarantine_prob: float = 0.0,
           table=None, alloc=None, trace: list | None = None) -> None:
    """Drain the scheduler, simulating the engine's outcome reporting,
    checking invariants (and recording the tick and allocator state in
    ``trace``) every tick."""
    guard = 0
    while not sched.idle:
        guard += 1
        assert guard < 10_000, "scheduler failed to drain"
        sched.admit()
        work = sched.next_work()
        if work is None:
            assert not sched.live, "live work but nothing schedulable"
            head = sched.waiting[0]
            assert (sched.table.free_slots == 0
                    or sched.table.pages_for(head.budget_tokens)
                    > sched.alloc.free_pages)
            return
        kind, reqs, chunk = work
        if trace is not None:
            trace.append((kind, tuple(r.rid for r in reqs), chunk,
                          tuple(sched.alloc._free),
                          sched.table.table.tobytes(),
                          sched.table.length.tobytes()))
        for r in list(reqs):
            if kind == "prefill":
                sched.on_prefill(r, chunk)
                if r.state != "decode":
                    continue            # prompt unfinished: no logits used
            if quarantine_prob and rng.random() < quarantine_prob:
                sched.quarantine(r)
                continue
            sched.on_token(r, rng.randrange(1000))
        if table is not None:
            _check_no_aliasing(table, alloc)


def _submit_churn(sched, rng: random.Random, n_requests: int) -> None:
    for _ in range(n_requests):
        plen = rng.randint(1, 8)
        gen = rng.randint(1, 8)         # budget <= 15 tokens <= 4 pages
        sched.submit(np.asarray(rng.choices(range(100), k=plen), np.int32),
                     gen)


@pytest.mark.parametrize("q", [0.0, 0.25])
@pytest.mark.parametrize("seed", range(8))
def test_no_page_leaks_or_aliasing_under_churn(seed, q):
    """Churn with and without mid-flight eviction (the NaN-guard path):
    pages are conserved and never aliased; drained, everything is back."""
    rng = random.Random(seed)
    sched, table, alloc = _make_sched()
    _submit_churn(sched, rng, 20)
    _drive(sched, rng, quarantine_prob=q, table=table, alloc=alloc)
    assert sched.idle and len(sched.done) == 20
    assert alloc.free_pages == alloc.num_pages - 1
    assert alloc._owned == set()
    assert table.free_slots == table.max_slots
    assert (table.table == NULL_PAGE).all()
    assert (table.length == 0).all()


@pytest.mark.parametrize("seed", [7, 11, 12])
def test_tick_sequence_identical_to_reference(seed):
    """The same submissions and outcomes give the reference scheduler's
    tick sequence (kind, rids, chunk) and allocator / page-table states,
    tick for tick, with random quarantines."""
    traces = []
    for pkg in (None, ref_serving):
        rng = random.Random(seed)
        sched, _, _ = _make_sched(pkg)
        _submit_churn(sched, rng, 15)
        trace: list = []
        _drive(sched, rng, quarantine_prob=0.2, trace=trace)
        traces.append(trace)
    assert traces[0] == traces[1]
    assert len(traces[0]) > 0


def test_admission_reserves_full_budget():
    sched, table, alloc = _make_sched(max_slots=2, max_pages_per_slot=2,
                                      page_size=4, num_pages=16)
    with pytest.raises(ValueError, match="per-slot capacity"):
        sched.submit(np.zeros((6,), np.int32), 4)  # budget 9 > 2*4 rows
    assert not sched.waiting and alloc.free_pages == 15
    alloc.alloc(13)                                # only 2 pages left
    sched.submit(np.zeros((4,), np.int32), 5)      # budget 8 -> 2 pages
    sched.submit(np.zeros((4,), np.int32), 5)
    assert len(sched.admit()) == 1
    assert len(sched.waiting) == 1                 # head waits, no crash
    assert alloc.free_pages == 0


def test_allocator_rejects_double_free_and_null_page():
    alloc = PageAllocator(6)
    pages = alloc.alloc(3)
    alloc.free(pages[:1])
    with pytest.raises(ValueError, match="double free"):
        alloc.free(pages[:1])
    with pytest.raises(ValueError, match="reserved"):
        alloc.free([NULL_PAGE])
    with pytest.raises(OutOfPages):
        alloc.alloc(99)
    with pytest.raises(ValueError, match="at least 2"):
        PageAllocator(1)


def test_index_builders_and_scenario_identical_to_reference():
    """`gather_planes` / `scatter_indices` (padding slots and positions past
    the mapped pages included) and the traffic scenario equal the
    reference's."""
    for pkg in (None, ref_serving):
        sched, table, alloc = _make_sched(pkg, max_pages_per_slot=3)
        for plen in (5, 2, 7):
            sched.submit(np.arange(plen, dtype=np.int32), 4)
        sched.admit()
        slots = [r.slot for r in sched.live.values()] + [-1]
        clen = np.array([0, 3, 6, 0], np.int32)
        mod = paged_kv if pkg is None else ref_paged_kv
        out = (mod.gather_planes(table, slots, 2, 3),
               *mod.scatter_indices(table, slots, clen, 2, 4))
        if pkg is None:
            got = out
        else:
            for g, w in zip(got, out):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
    for mod in (traffic, ref_traffic):
        rng = np.random.default_rng(3)
        reqs = mod.make_requests(5, rng, vocab=100, prompt_lens=(4, 8))
        arr = mod.poisson_arrivals(5, 8.0, rng)
        if mod is traffic:
            mine = (reqs, arr)
    np.testing.assert_array_equal(mine[1], arr)
    for a, b in zip(mine[0], reqs):
        np.testing.assert_array_equal(a["prompt"], b["prompt"])
        assert a["max_new_tokens"] == b["max_new_tokens"]


# ---------------------------------------------------------------------------
# engine layer (olmo smoke, CPU)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _olmo(cache_update="mask", cd="bfloat16"):
    cfg = dataclasses.replace(get_smoke("olmo-1b"), sparse_serving=True,
                              cache_update=cache_update, compute_dtype=cd)
    bundle = build_model(cfg, "cpu")
    return cfg, bundle, bundle.init(0)


def _mixed_requests(rng, n, vocab):
    return [(np.asarray(rng.integers(0, vocab, rng.integers(2, 7)),
                        np.int32), int(rng.integers(1, 5))) for _ in range(n)]


@pytest.mark.parametrize("cache_update", ["mask", "scatter"])
def test_paged_logits_parity_with_contiguous(cache_update, monkeypatch):
    """The paged pool is a pure rearrangement of the contiguous cache, so
    per-request logits traces match *bitwise* (max abs diff exactly 0)
    and greedy tokens are identical; the scatter mode writes every step's
    rows through the kv wrapper."""
    cfg, bundle, params = _olmo(cache_update)
    rng = np.random.default_rng(0)
    reqs = _mixed_requests(rng, 5, cfg.vocab_size)
    shared: dict = {}
    paged = ServingEngine(bundle, params, num_pages=2 * 3 + 1, page_size=4,
                          max_slots=2, max_pages_per_slot=3,
                          prefill_chunk=3, record_logits=True,
                          step_cache=shared)
    contig = contiguous_engine(bundle, params, max_slots=2, max_len=12,
                               prefill_chunk=3, record_logits=True)
    calls = []
    real = kv.kv_cache_write_chunk_plain
    monkeypatch.setattr(kv, "kv_cache_write_chunk_plain",
                        lambda *a: calls.append(1) or real(*a))
    for eng in (paged, contig):
        for prompt, gen in reqs:
            eng.submit(prompt, gen)
        eng.run()
    assert bool(calls) == (cache_update == "scatter")
    toks_p = {r.rid: r.out_tokens for r in paged.sched.done}
    toks_c = {r.rid: r.out_tokens for r in contig.sched.done}
    assert toks_p == toks_c
    assert all(len(t) > 0 for t in toks_p.values())
    diff = 0.0
    for rid, rows in paged.logits_trace.items():
        ref = contig.logits_trace[rid]
        assert len(rows) == len(ref)
        diff = max(diff, max(float(np.max(np.abs(a - b)))
                             for a, b in zip(rows, ref)))
    assert diff == 0.0
    for eng in (paged, contig):
        assert eng.alloc.free_pages == eng.alloc.num_pages - 1
        assert (eng.table.table == NULL_PAGE).all()


def test_quarantine_poisoned_request_keeps_batch_serving():
    """Poison one request's cached KV rows mid-flight (NaN): exactly that
    request is quarantined, its pages are wiped before reuse, and every
    other request finishes its full budget."""
    cfg, bundle, params = _olmo("scatter")
    rng = np.random.default_rng(1)
    prompts = [np.asarray(rng.integers(0, cfg.vocab_size, 4), np.int32)
               for _ in range(3)]
    eng = ServingEngine(bundle, params, num_pages=3 * 3 + 1, page_size=4,
                        max_slots=3, max_pages_per_slot=3, prefill_chunk=4)
    eng.decode_fuse = 1      # tick-by-tick so the poison lands mid-decode
    victim = eng.submit(prompts[0], 6)
    others = [eng.submit(p, 6) for p in prompts[1:]]
    for _ in range(2):
        eng.tick()
    assert victim.state == "decode"
    pages = [int(p) for p in eng.table.table[victim.slot] if p != NULL_PAGE]
    assert pages
    planes = torch.tensor([p * eng.kh + h for p in pages
                           for h in range(eng.kh)])
    for leaf in eng.pool.values():
        leaf[:, planes] = float("nan")
    eng.run()
    assert victim.state == "quarantined"
    assert any(e["event"] == "request_quarantine" and e["rid"] == victim.rid
               for e in eng.events)
    for r in others:
        assert r.state == "finished" and len(r.out_tokens) == 6
    for leaf in eng.pool.values():
        assert bool(torch.isfinite(leaf).all())
    assert eng.alloc.free_pages == eng.alloc.num_pages - 1


def test_engine_tokens_equal_reference_engine():
    """Greedy tokens of the port's paged engine (scatter writes) equal the
    reference engine's on converted weights, f32 compute, and the logits
    agree within 1e-4."""
    ref_cfg = dataclasses.replace(ref_get_smoke("olmo-1b"),
                                  compute_dtype="float32")
    ref_bundle = ref_build_model(ref_cfg)
    params_j = ref_bundle.init(jax.random.key(0))
    cfg, bundle, _ = _olmo("scatter", "float32")
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    reqs = _mixed_requests(np.random.default_rng(4), 3, cfg.vocab_size)
    engines = [
        ServingEngine(bundle, params, num_pages=7, page_size=4, max_slots=2,
                      max_pages_per_slot=3, prefill_chunk=3,
                      record_logits=True),
        ref_serving.ServingEngine(ref_bundle, params_j, num_pages=7,
                                  page_size=4, max_slots=2,
                                  max_pages_per_slot=3, prefill_chunk=3,
                                  record_logits=True)]
    for eng in engines:
        for prompt, gen in reqs:
            eng.submit(prompt, gen)
        eng.run()
    got, want = ({r.rid: r.out_tokens for r in e.sched.done}
                 for e in engines)
    assert got == want and all(got.values())
    for rid, rows in engines[0].logits_trace.items():
        np.testing.assert_allclose(np.stack(rows),
                                   np.stack(engines[1].logits_trace[rid]),
                                   rtol=1e-4, atol=1e-4)


def test_serve_traffic_smoke_cpu():
    """``serve --traffic --smoke --device cpu`` end to end (the CLI's
    mask config), then the same scenario on the scatter config through
    `serve.run`: parity exactly 0.0, every request served on both
    drivers."""
    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--traffic",
            "--requests", "5", "--rate", "200", "--prompt-len", "8",
            "--gen-steps", "4", "--slots", "2", "--page-size", "4",
            "--prefill-chunk", "3"]
    res = serve.main(argv)
    args = serve.build_parser().parse_args(argv)
    res_s = serve.run(args, dataclasses.replace(serve.config(args),
                                                cache_update="scatter"))
    for r in (res, res_s):
        t = r["traffic"]
        assert t["parity_max_abs_diff"] == 0.0
        assert t["parity_requests"] == 4
        for side in ("continuous", "static"):
            assert t[side]["requests"] == 5
            assert t[side]["generated_tokens"] > 0
        assert t["continuous"]["quarantined"] == 0
        assert "dense" not in r and "sparse" not in r
    assert "kv_cache_update" in res_s["plan"]["kernels_reached"]
    assert "kv_cache_update" not in res["plan"]["kernels_reached"]
