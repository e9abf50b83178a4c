"""The port's measured block autotuner (`repro_torch.kernels.autotune`)
against the JAX reference's (twins of `tests/test_autotune.py`): cache
round-trips, the static-model fallbacks (cold cache, foreign backend,
non-tunable rungs, corrupt files and entries), the sweep never slower
than the static pick, plan builds with ``tune="cached"`` deterministic;
plus the candidate list (the reference's, less the column blocks the CUDA
kernels refuse) and the two packages' caches kept apart.  On the CPU the
sweep times the kernels' plain versions; the `cuda`-marked test sweeps on
the card."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.kernels import autotune as ref_autotune  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels.balanced_spmm import MAX_BN  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# small enough to sweep in seconds, big enough that the candidate set is
# non-trivial
SHAPE = dict(m=64, o=48, n=96, k=48)


def _fields(c) -> tuple:
    return (c.bm, c.bo, c.bn, c.vmem_bytes)


def _resolve(tmp_path, tune, **kw):
    return autotune.resolve_blocks(
        SHAPE["m"], SHAPE["o"], SHAPE["n"], SHAPE["k"], itemsize=4,
        impl=kw.pop("impl", "cuda"), tune=tune,
        cache_path=str(tmp_path / "cache.json"), device="cpu", **kw)


def test_tune_off_is_the_static_model(tmp_path):
    res = _resolve(tmp_path, "off")
    static = ops.choose_blocks(**SHAPE, itemsize=4)
    assert res.source == "static" and res.blocks == static
    assert _fields(static) == _fields(ref_ops.choose_blocks(**SHAPE,
                                                            itemsize=4))
    assert not (tmp_path / "cache.json").exists()


def test_cold_cache_falls_back_to_static(tmp_path):
    res = _resolve(tmp_path, "cached")
    assert res.source == "static"
    assert res.blocks == ops.choose_blocks(**SHAPE, itemsize=4)
    # cached mode never writes (plan builds stay side-effect free)
    assert not (tmp_path / "cache.json").exists()


def test_sweep_cache_roundtrip(tmp_path):
    """write -> reload -> identical BlockChoice, through the versioned
    JSON file; the key is the reference's layout with this package's
    backend and rung segments."""
    res = _resolve(tmp_path, "sweep")
    assert res.source == "swept"
    doc = json.loads((tmp_path / "cache.json").read_text())
    assert doc["version"] == autotune.CACHE_VERSION
    assert doc["package"] == "repro_torch"
    (key, entry), = doc["entries"].items()
    assert key == autotune.cache_key(**SHAPE, itemsize=4, device="cpu")
    ref_key = ref_autotune.cache_key(**SHAPE, itemsize=4, impl="pallas",
                                     backend="cpu")
    got, want = key.split("|"), ref_key.split("|")
    assert got[1:3] == ["cpu", "cuda"] and want[1:3] == ["cpu", "pallas"]
    assert got[:1] + got[3:] == want[:1] + want[3:]
    for tune in ("cached", "sweep"):
        again = _resolve(tmp_path, tune)
        assert again.source == "cached"
        assert again.blocks == res.blocks
    assert (entry["bm"], entry["bo"], entry["bn"]) == \
        (res.blocks.bm, res.blocks.bo, res.blocks.bn)
    assert entry["backend"] == "cpu" and entry["quarantined"] == []


def test_sweep_never_slower_than_static(tmp_path):
    res = _resolve(tmp_path, "sweep")
    entry = next(iter(json.loads(
        (tmp_path / "cache.json").read_text())["entries"].values()))
    assert entry["time_s"] <= entry["static_time_s"]
    cands = {(c["bm"], c["bo"], c["bn"]) for c in entry["candidates"]}
    assert (res.static.bm, res.static.bo, res.static.bn) in cands
    assert (res.blocks.bm, res.blocks.bo, res.blocks.bn) in cands
    assert len(cands) == len(autotune.candidate_blocks(**SHAPE, itemsize=4))


def test_foreign_backend_cache_misses(tmp_path):
    """An entry swept on another backend (a card, named in the key) is
    invisible on the CPU, and a CPU entry under a card's name."""
    path = tmp_path / "cache.json"
    for backend in ("cuda:NVIDIA H100 80GB HBM3", "tpu-imaginary"):
        key = autotune.cache_key(**SHAPE, itemsize=4, backend=backend)
        autotune.save_cache({key: {"bm": 8, "bo": 8, "bn": 8,
                                   "vmem_bytes": 1, "source": "sweep"}},
                            path)
        res = _resolve(tmp_path, "cached")
        assert res.source == "static"
        assert res.blocks == ops.choose_blocks(**SHAPE, itemsize=4)
    assert autotune.cache_key(**SHAPE, backend="cpu") != \
        autotune.cache_key(**SHAPE, backend="cuda:NVIDIA H100 80GB HBM3")


def test_corrupt_or_mismatched_cache_degrades_to_static(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json")
    assert autotune.load_cache(path) == {}
    assert _resolve(tmp_path, "cached").source == "static"
    path.write_text(json.dumps({"version": autotune.CACHE_VERSION + 1,
                                "package": "repro_torch",
                                "entries": {"x": {}}}))
    assert autotune.load_cache(path) == {}
    assert ref_autotune.load_cache(path) == {}


def test_entry_level_corruption_degrades_to_static(tmp_path):
    key = autotune.cache_key(**SHAPE, itemsize=4, device="cpu")
    path = tmp_path / "cache.json"
    for bad in ("junk",                                   # not a dict
                {"source": "sweep"},                      # missing bm/bo/bn
                {"source": "sweep", "bm": "x", "bo": 8, "bn": 8},
                {"source": "sweep", "bm": -8, "bo": 8, "bn": 8},
                {"bm": 8, "bo": 8, "bn": 8}):             # no sweep source
        autotune.save_cache({key: bad}, path)
        res = _resolve(tmp_path, "cached")
        assert res.source == "static"
        assert res.blocks == ops.choose_blocks(**SHAPE, itemsize=4)
        assert autotune._valid_entry(bad) == ref_autotune._valid_entry(bad)


def test_non_tunable_impls_always_resolve_static(tmp_path):
    """The eager rungs take no block parameters: every tune mode returns
    the static model and never touches the cache."""
    assert autotune.TUNABLE_IMPLS == ("cuda",)
    for impl in ("xla", "xla_gather"):
        for tune in ("cached", "sweep"):
            res = _resolve(tmp_path, tune, impl=impl)
            assert res.source == "static"
    assert not (tmp_path / "cache.json").exists()


def test_sweep_raises_on_a_real_kernel_failure(tmp_path, monkeypatch):
    """Only a forced rung failure quarantines a candidate (the guard
    tests cover that); a kernel wrapper that raises anything else ends the
    sweep, and nothing is cached."""
    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: unspecified launch failure")
    monkeypatch.setattr(ops, "tiled_balanced_spmm", broken)
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        _resolve(tmp_path, "sweep")
    assert not (tmp_path / "cache.json").exists()


def test_candidates_include_static_and_fit_budget():
    cands = autotune.candidate_blocks(**SHAPE, itemsize=4)
    static = ops.choose_blocks(**SHAPE, itemsize=4)
    assert cands[0] == dataclasses.replace(static,
                                           vmem_bytes=cands[0].vmem_bytes)
    assert len(cands) == len({(c.bm, c.bo, c.bn) for c in cands})
    for c in cands[1:]:
        assert 2 * c.vmem_bytes <= ops._VMEM_BUDGET
        assert all(v >= 8 for v in (c.bm, c.bo, c.bn))
    assert [_fields(c) for c in cands] == [
        _fields(c) for c in ref_autotune.candidate_blocks(**SHAPE,
                                                          itemsize=4)]


# (m, o, n, k, itemsize): the olmo-1b projections at prefill (M = 128)
# and decode (M = 4) in bf16, the deepseek-moe-16b expert shapes, and
# small ones
CANDIDATE_CASES = [(128, 2048, 2048, 1024, 2), (4, 2048, 2048, 1024, 2),
                   (128, 8192, 2048, 1024, 2), (4, 8192, 2048, 1024, 2),
                   (128, 2048, 8192, 4096, 2), (4, 2048, 8192, 4096, 2),
                   (16, 1408, 2048, 1024, 2), (8, 2048, 1408, 704, 2),
                   (64, 48, 96, 48, 4), (3, 10, 256, 51, 4),
                   (256, 512, 512, 256, 4), (4, 64, 128, 64, 2)]


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("case", CANDIDATE_CASES)
def test_candidates_equal_reference_less_refused_blocks(case, quant):
    """The port's list is the reference's where the reference's holds no
    column block the CUDA kernels refuse (bn > 128 or bn % 4), and the
    reference's less those candidates elsewhere, in the same order."""
    m, o, n, k, itemsize = case
    got = autotune.candidate_blocks(m, o, n, k, itemsize=itemsize,
                                    quant=quant)
    want = ref_autotune.candidate_blocks(m, o, n, k, itemsize=itemsize,
                                         quant=quant)
    kept = [c for c in want if c.bn <= MAX_BN and c.bn % 4 == 0]
    assert [_fields(c) for c in got] == [_fields(c) for c in kept]
    assert all(autotune.kernel_takes(c) for c in got)
    if n >= 256 and (m, o) == (128, 2048):
        # the wide prefill shapes are where the reference reaches bn 256
        assert len(kept) < len(want)


def test_caches_of_the_two_packages_never_mix(tmp_path, monkeypatch):
    """Each package reads only its own entries: the default paths differ,
    a reference cache file is empty to the port, and a port file holds no
    key the reference resolves."""
    assert autotune.default_cache_path() != ref_autotune.default_cache_path()
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "p.json"))
    assert autotune.default_cache_path() == str(tmp_path / "p.json")
    ref_path = tmp_path / "ref.json"
    ref_key = ref_autotune.cache_key(**SHAPE, itemsize=4, impl="pallas",
                                     backend="cpu")
    ref_autotune.save_cache({ref_key: {"bm": 8, "bo": 8, "bn": 8,
                                       "vmem_bytes": 1, "source": "sweep"}},
                            ref_path)
    assert autotune.load_cache(ref_path) == {}
    res = autotune.resolve_blocks(**SHAPE, itemsize=4, tune="cached",
                                  cache_path=str(ref_path), device="cpu")
    assert res.source == "static"
    port_path = tmp_path / "port.json"
    _resolve(tmp_path, "sweep")
    (tmp_path / "cache.json").rename(port_path)
    ref = ref_autotune.resolve_blocks(**SHAPE, itemsize=4, impl="pallas",
                                      tune="cached",
                                      cache_path=str(port_path))
    assert ref.source == "static"


# ---------------------------------------------------------------------------
# Plan integration
# ---------------------------------------------------------------------------

def _plan_olmo(tune, cache, params=None):
    cfg = dataclasses.replace(get_smoke("olmo-1b"), sparse_serving=True)
    m = build_model(cfg, "cpu")
    params = params if params is not None else m.init(0)
    plan = engine_plan.plan_model(cfg, params, sparsity=0.5, impl="cuda",
                                  tune=tune, tune_cache=cache)
    return cfg, m, params, plan


def test_plan_determinism_with_cached_tuning(tmp_path):
    """With the same warm cache, two ``tune="cached"`` builds are equal to
    the byte (specs, every tensor) — a tuned plan ships like a static
    one."""
    cache = str(tmp_path / "tune.json")
    _, _, params, warm = _plan_olmo("sweep", cache)
    assert set(warm.tuned_mix()) <= {"swept", "cached"}
    _, _, _, p1 = _plan_olmo("cached", cache, params=params)
    _, _, _, p2 = _plan_olmo("cached", cache, params=params)
    assert p1.meta == p2.meta
    assert p1.tuned_mix() == {"cached": len(p1.layers)}
    for nm in p1.layers:
        assert p1.layers[nm].spec == p2.layers[nm].spec
        w1, w2 = p1.layers[nm].weights, p2.layers[nm].weights
        for f in ("values", "indices", "counts", "perm"):
            a, b = getattr(w1, f), getattr(w2, f)
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b)


def test_tuned_plan_parity_and_engine_stats(tmp_path):
    """A tuned plan still matches the masked-dense reference, and every
    sparse dispatch ticks ``tuned_blocks``."""
    cache = str(tmp_path / "tune.json")
    cfg, m, params, plan = _plan_olmo("sweep", cache)
    ref_params = engine_plan.masked_dense_params(params, plan)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)))
    execute.reset_stats()
    with torch.no_grad():
        ls, _ = m.prefill({**params, "sparse_plan": plan},
                          {"tokens": tokens})
    stats = execute.stats()
    assert stats.get("balanced_spmm", 0) > 0
    assert stats.get("tuned_blocks", 0) == stats["balanced_spmm"]
    with torch.no_grad():
        lr, _ = m.prefill(ref_params, {"tokens": tokens})
    np.testing.assert_allclose(ls.float().numpy(), lr.float().numpy(),
                               rtol=2e-2, atol=2e-2)
    for nm, tuned, static in plan.tune_deltas():
        assert nm in plan.layers
        assert len(tuned) == 3 and len(static) == 3


def test_build_layer_plan_tune_knob(tmp_path):
    """`build_layer_plan` honours the knob too (the smallcnn / fc path),
    and at tune="off" its blocks are the reference's static ones."""
    from repro.core.pruning import balanced_prune_rows
    from repro.engine import plan as ref_plan
    cache = str(tmp_path / "tune.json")
    w_j = jax.random.normal(jax.random.key(0), (48, 96))
    _, mask_j = balanced_prune_rows(w_j, 0.5)
    w, mask = (torch.from_numpy(np.array(a)) for a in (w_j, mask_j))
    lp = engine_plan.build_layer_plan("fc", w, mask=mask, m_hint=64,
                                      impl="cuda", tune="sweep",
                                      tune_cache=cache)
    assert lp.spec.tuned == "swept"
    lp2 = engine_plan.build_layer_plan("fc", w, mask=mask, m_hint=64,
                                       impl="cuda", tune="cached",
                                       tune_cache=cache)
    assert lp2.spec.tuned == "cached"
    assert lp2.spec.blocks == lp.spec.blocks
    lp3 = engine_plan.build_layer_plan("fc", w, mask=mask, m_hint=64,
                                       impl="cuda")
    assert lp3.spec.tuned == "static"
    want = ref_plan.build_layer_plan("fc", w_j, mask=mask_j, m_hint=64,
                                     impl="pallas")
    assert _fields(lp3.spec.blocks) == _fields(want.spec.blocks)
    assert _fields(lp3.spec.blocks_static) == \
        _fields(want.spec.blocks_static)


@pytest.mark.cuda
def test_cuda_sweep_on_the_card(tmp_path):
    """On the card: the olmo-1b projection keys sweep with no quarantined
    candidate, the keys name the card, and a cached build reuses them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    cache = str(tmp_path / "tune.json")
    for m in (128, 4):
        res = autotune.resolve_blocks(m, 2048, 2048, 1024, itemsize=2,
                                      dtype=torch.bfloat16, tune="sweep",
                                      cache_path=cache, device="cuda")
        assert res.source == "swept"
    entries = autotune.load_cache(cache)
    assert len(entries) == 2
    name = torch.cuda.get_device_name()
    for key, e in entries.items():
        assert f"|cuda:{name}|" in key
        assert e["quarantined"] == [] and e["time_s"] > 0
