"""The port's sparse ops against the JAX reference on numpy-seeded
inputs: the flat `kernels.ops.balanced_spmm` ``cuda`` rung (encoded at
`choose_blocks`' bn behind its per-weight cache, then the wide or skinny
kernel; the reference's ``pallas`` rung in interpret mode), the cache's
hits, misses and evictions, `core.sparse_ops` (`sparse_matmul`,
`mode_switched_matmul`'s dense/sparse decisions at the §VI-F thresholds)
and `engine.plan.plan_from_balanced`.  f32 within 1e-4.  On the CPU the
kernel wrappers run their plain versions."""
import dataclasses
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import sparse_ops as ref_sparse_ops  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import pruning, sparse_ops  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

IMPLS = {"cuda": "pallas", "xla": "xla"}


def _np(t):
    return t.detach().float().numpy()


def _close(got, want):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _flat(rng, o, n):
    """A balanced-pruned (0.5) flat weight in both packages."""
    w = rng.standard_normal((o, n)).astype(np.float32)
    _, mask = ref_pruning.balanced_prune_rows(jnp.asarray(w), 0.5)
    rsp = ref_pruning.from_mask(jnp.asarray(w), mask)
    sp = pruning.from_mask(_t(w), _t(mask))
    return sp, rsp


# ---------------------------------------------------------------------------
# the flat balanced_spmm cuda rung and the §VI-F mode switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,block_k", [(4, None), (40, None), (40, 45)])
def test_balanced_spmm_cuda_rung(m, block_k):
    """The flat entry's ``cuda`` rung (encode at choose_blocks' bn behind
    the cache, then the kernel) against the reference's ``pallas`` rung,
    forward and gradients."""
    rng = np.random.default_rng(m)
    sp, rsp = _flat(rng, 24, 90)
    x = rng.standard_normal((m, sp.n_in)).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    vals = sp.values.clone().requires_grad_(True)
    got = ops.balanced_spmm(xt, vals, sp.indices, n_in=sp.n_in, impl="cuda",
                            block_k=block_k)
    want = ref_ops.balanced_spmm(jnp.asarray(x), rsp.values, rsp.indices,
                                 n_in=rsp.n_in, impl="pallas",
                                 block_k=block_k)
    _close(got, want)
    got.square().sum().backward()
    gx, gv = jax.grad(lambda a, v: jnp.sum(ref_ops.balanced_spmm(
        a, v, rsp.indices, n_in=rsp.n_in, impl="pallas",
        block_k=block_k) ** 2), argnums=(0, 1))(jnp.asarray(x), rsp.values)
    _close(xt.grad, gx)
    _close(vals.grad, gv)


def test_balanced_spmm_encoding_cache():
    """One encoding per live, unchanged weight: a hit returns the cached
    encoding; an in-place update misses; a dead weight's entry is
    evicted."""
    rng = np.random.default_rng(3)
    sp, _ = _flat(rng, 16, 72)
    x = _t(rng.standard_normal((16, sp.n_in)))
    ops._ENC_CACHE.clear()
    y0 = ops.balanced_spmm(x, sp.values, sp.indices, n_in=sp.n_in,
                           impl="cuda")
    assert len(ops._ENC_CACHE) == 1
    (key, (_, tb)), = ops._ENC_CACHE.items()
    ops.balanced_spmm(x, sp.values, sp.indices, n_in=sp.n_in, impl="cuda")
    assert len(ops._ENC_CACHE) == 1 and ops._ENC_CACHE[key][1] is tb
    with torch.no_grad():
        sp.values.mul_(2.0)
    y1 = ops.balanced_spmm(x, sp.values, sp.indices, n_in=sp.n_in,
                           impl="cuda")
    torch.testing.assert_close(y1, 2 * y0, rtol=1e-5, atol=1e-5)
    assert len(ops._ENC_CACHE) == 2
    del sp
    gc.collect()
    assert len(ops._ENC_CACHE) == 0
    with pytest.raises(ValueError, match="impl"):
        ops.balanced_spmm(x, torch.zeros(4, 2), torch.zeros(
            4, 2, dtype=torch.int32), n_in=x.shape[1], impl="pallas")


@pytest.mark.parametrize("w_sparsity,ifm_sparsity", [
    (0.1, 0.0), (0.1, 0.35), (0.2, 0.0), (0.5, 0.0), (0.8, 0.5)])
def test_mode_switched_matmul(w_sparsity, ifm_sparsity):
    """The dense/sparse decision at the §VI-F thresholds, and the output of
    either mode against the reference's (sparse: pruned to the spec's
    sparsity, so it differs from the dense product)."""
    spec = sparse_ops.SparseLinearSpec(w_sparsity, ifm_sparsity)
    rspec = ref_sparse_ops.SparseLinearSpec(w_sparsity, ifm_sparsity)
    assert spec.use_sparse == rspec.use_sparse
    assert (sparse_ops.IFM_SPARSE_THRESHOLD,
            sparse_ops.W_SPARSE_THRESHOLD) == \
        (ref_sparse_ops.IFM_SPARSE_THRESHOLD,
         ref_sparse_ops.W_SPARSE_THRESHOLD)
    rng = np.random.default_rng(int(w_sparsity * 10))
    w = rng.standard_normal((12, 40)).astype(np.float32)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    got = sparse_ops.mode_switched_matmul(_t(x), _t(w), spec)
    want = ref_sparse_ops.mode_switched_matmul(jnp.asarray(x),
                                               jnp.asarray(w), rspec,
                                               impl="xla")
    _close(got, want)
    dense = x @ w.T
    assert np.allclose(_np(got), dense, rtol=1e-4, atol=1e-4) == \
        (not spec.use_sparse)


def test_sparse_matmul_and_plan_from_balanced():
    rng = np.random.default_rng(9)
    sp, rsp = _flat(rng, 20, 144)
    x = rng.standard_normal((10, sp.n_in)).astype(np.float32)
    for impl in ("cuda", "xla"):
        for block_k in (None, 75):
            lp = engine_plan.plan_from_balanced(sp, impl=impl,
                                                block_k=block_k)
            rp = ref_plan.plan_from_balanced(rsp, impl=IMPLS[impl],
                                             block_k=block_k)
            for f in ("kind", "mode", "n_in", "n_out", "k", "block_k",
                      "w_sparsity", "d_mem_bits", "i_mem_bits",
                      "w_mem_bits"):
                assert getattr(lp.spec, f) == getattr(rp.spec, f), f
            assert dataclasses.asdict(lp.spec.blocks) == \
                dataclasses.asdict(rp.spec.blocks)
            if impl == "cuda":
                np.testing.assert_array_equal(
                    lp.weights.indices.numpy(), np.asarray(rp.weights.indices))
            _close(sparse_ops.sparse_matmul(_t(x), lp),
                   ref_sparse_ops.sparse_matmul(jnp.asarray(x), rp))
        _close(sparse_ops.sparse_matmul(_t(x), sp, impl=impl),
               ref_sparse_ops.sparse_matmul(jnp.asarray(x), rsp,
                                            impl=IMPLS[impl]))
