"""The port's plan and execute against the JAX reference on olmo smoke
(and a wider variant whose column blocks let packing engage): identical
spec decisions, array-equal encodings (reference impl ``pallas`` <-> port
``cuda``), and `apply_fc` within 1e-4 (f32) / 2e-2 (bf16)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.engine import execute as ref_execute  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
IMPLS = {"cuda": "pallas", "xla": "xla"}
# olmo smoke is one column block wide (bn = 128 > d_model); the wide
# variant has NB = 2..3 blocks per row, so packing is tried
WIDE = dict(d_model=256, n_heads=4, head_dim=64, n_kv_heads=4, d_ff=384)


def _np(t):
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@functools.lru_cache(maxsize=None)
def _plans(cd, impl, wide):
    overrides = WIDE if wide else {}
    ref_cfg = dataclasses.replace(ref_get_smoke("olmo-1b"),
                                  compute_dtype=cd, **overrides)
    cfg = dataclasses.replace(get_smoke("olmo-1b"), compute_dtype=cd,
                              **overrides)
    params_j = ref_build_model(ref_cfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    want = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                     impl=IMPLS[impl], m_hint=64, decode_m=4)
    got = engine_plan.plan_transformer(cfg, params, sparsity=0.5, impl=impl,
                                       m_hint=64, decode_m=4)
    return got, want


@pytest.mark.parametrize("cd,impl,wide", [
    ("float32", "cuda", False), ("bfloat16", "cuda", False),
    ("float32", "cuda", True), ("bfloat16", "cuda", True),
    ("bfloat16", "xla", False)])
def test_plan_matches_reference(cd, impl, wide):
    got, want = _plans(cd, impl, wide)
    assert sorted(got.layers) == sorted(want.layers)
    assert got.meta == want.meta
    for nm, lp in got.layers.items():
        s, r = lp.spec, want.layers[nm].spec
        assert s.impl == impl and r.impl == IMPLS[impl]
        for f in ("mode", "n_in", "n_out", "k", "block_k", "w_sparsity",
                  "d_mem_bits", "i_mem_bits", "w_mem_bits", "m_hint",
                  "decode_m", "packed", "pack_kb", "quant"):
            assert getattr(s, f) == getattr(r, f), (nm, f)
        for f in ("blocks", "blocks_decode"):
            assert dataclasses.asdict(getattr(s, f)) == \
                dataclasses.asdict(getattr(r, f)), (nm, f)
        w, rw = lp.weights, want.layers[nm].weights
        np.testing.assert_array_equal(_np(w.values),
                                      np.asarray(rw.values, np.float32))
        np.testing.assert_array_equal(w.indices.numpy(),
                                      np.asarray(rw.indices))
        if impl == "cuda":
            np.testing.assert_array_equal(w.counts.numpy(),
                                          np.asarray(rw.counts))
            assert (w.perm is None) == (rw.perm is None)
            if w.perm is not None:
                np.testing.assert_array_equal(w.perm.numpy(),
                                              np.asarray(rw.perm))
    if wide and impl == "cuda":
        # the wide variant exercises the packed path (wv, w_down adopt it)
        assert any(lp.spec.packed for lp in got.layers.values())


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [4, 24])
def test_apply_fc_matches_reference(cd, m):
    """Layer 1 of every planned projection, skinny (decode) and wide M,
    on the wide variant (packed encodings included)."""
    got, want = _plans(cd, "cuda", True)
    rng = np.random.default_rng(m)
    execute.reset_stats()
    for nm, lp in got.layers.items():
        x = rng.standard_normal((m, lp.spec.n_in)).astype(np.float32)
        xt = torch.from_numpy(x).to(getattr(torch, cd))
        xj = jax.numpy.asarray(x).astype(getattr(jax.numpy, cd))
        rlp = jax.tree.map(lambda a: a[1], want.layers[nm])
        y = execute.apply_fc(xt, lp.layer(1))
        assert y.dtype == xt.dtype and y.shape == (m, lp.spec.n_out)
        np.testing.assert_allclose(_np(y), np.asarray(
            ref_execute.apply_fc(xj, rlp), np.float32), rtol=TOL[cd],
            atol=TOL[cd])
    stats = execute.stats()
    assert stats["balanced_spmm"] == stats["impl_cuda"] == len(got.layers)
    assert stats.get("decode_dispatch", 0) == (len(got.layers) if m <= 8
                                               else 0)


def test_default_impl_follows_device():
    assert engine_plan.default_impl(balanced=True, w_sparsity=0.5,
                                    device="cpu") == "xla"
    assert engine_plan.default_impl(balanced=True, w_sparsity=0.5,
                                    device="cuda") == "cuda"
    assert engine_plan.default_impl(balanced=True, w_sparsity=0.1,
                                    device="cuda") == "dense"
    assert engine_plan.default_impl(balanced=False, w_sparsity=0.5,
                                    device="cuda") == "dense"


@pytest.mark.parametrize("kind,shape", [
    ("fc", dict(c_i=2048, c_o=8192)),
    ("conv", dict(h_i=56, w_i=56, c_i=64, c_o=128, h_k=3, w_k=3)),
    ("conv", dict(h_i=7, w_i=7, c_i=512, c_o=512, h_k=3, w_k=3))])
def test_choose_dataflow_matches_reference(kind, shape):
    """§V-C mode and DRAM bits: an fc GEMV (ON_CHIP), an early conv layer
    (large IFM: RWF) and a late one (large weights: RIF)."""
    from repro.core import dataflow as ref_dataflow
    from repro_torch.core import dataflow
    kw = dict(name="l", kind=kind, w_sparsity=0.5, ifm_sparsity=0.3, **shape)
    got = dataflow.choose_dataflow(dataflow.LayerSpec(**kw))
    want = ref_dataflow.choose_dataflow(ref_dataflow.LayerSpec(**kw))
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
