"""The port's pruning and tile-local encoders against the JAX reference:
every host-side array must come out identical (inputs from numpy seeds)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.kernels import tile_format as ref_tf  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.kernels import tile_format as tf  # noqa: E402


def _np(t):
    """torch tensor -> numpy (bf16 through its exact f32 image)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _balanced_mask(rng, o, n, k, live=None):
    """A balanced bool mask [o, n]: k random columns per row among the
    first ``live`` columns (the rest stay empty: zero-count blocks)."""
    live = n if live is None else live
    mask = np.zeros((o, n), bool)
    for r in range(o):
        mask[r, rng.choice(live, size=k, replace=False)] = True
    return mask


def _flat(rng, o, n, k, live=None):
    mask = _balanced_mask(rng, o, n, k, live)
    idx = np.sort(np.argsort(~mask, axis=1, kind="stable")[:, :k],
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((o, k)).astype(np.float32)
    return mask, vals, idx


def _assert_tiled_equal(got, want):
    np.testing.assert_array_equal(_np(got.values),
                                  np.asarray(want.values, np.float32))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    assert got.indices.dtype == torch.int32 and got.counts.dtype == \
        torch.int32
    assert (got.n_in, got.bn) == (want.n_in, want.bn)


@pytest.mark.parametrize("numel,sparsity", [(64, 0.5), (100, 0.3),
                                            (7, 0.99), (2048, 0.5),
                                            (10, 0.0)])
def test_keep_count_matches(numel, sparsity):
    assert pruning.keep_count(numel, sparsity) == \
        ref_pruning.keep_count(numel, sparsity)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
def test_balanced_masks_match(dtype, ties):
    """Top-K per row by magnitude with index tie-breaking, in the compute
    dtype: bf16 quantizes many magnitudes onto the same value."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    if ties:
        w = np.round(w * 2) / 2           # heavy ties (and exact zeros)
    wt = torch.from_numpy(w).to(getattr(torch, dtype))
    wj = jnp.asarray(w).astype(getattr(jnp, dtype))
    for sparsity in (0.5, 0.7):
        _, mask = pruning.balanced_prune_rows(wt, sparsity)
        _, ref_mask = ref_pruning.balanced_prune_rows(wj, sparsity)
        np.testing.assert_array_equal(_np(mask), np.asarray(ref_mask,
                                                            np.float32))
        sp = pruning.to_balanced_sparse(wt, sparsity=sparsity)
        ref_sp = ref_pruning.to_balanced_sparse(wj, sparsity=sparsity)
        np.testing.assert_array_equal(sp.indices.numpy(),
                                      np.asarray(ref_sp.indices))
        np.testing.assert_array_equal(_np(sp.values),
                                      np.asarray(ref_sp.values, np.float32))
        fm = pruning.from_mask(wt, mask)
        ref_fm = ref_pruning.from_mask(wj, ref_mask)
        np.testing.assert_array_equal(fm.indices.numpy(),
                                      np.asarray(ref_fm.indices))
        np.testing.assert_array_equal(_np(fm.values),
                                      np.asarray(ref_fm.values, np.float32))


@pytest.mark.parametrize("o,n,k,bn,live,kb", [
    (16, 96, 24, 32, None, None),  # divisible N
    (13, 100, 30, 32, None, 40),   # non-divisible N (ragged last block)
    (9, 128, 16, 32, 40, None),    # zero-count blocks past column 40
    (8, 50, 50, 16, None, 8),      # fully dense rows; kb below the need
])
def test_encode_tiled_matches(o, n, k, bn, live, kb):
    rng = np.random.default_rng(o * n + k)
    _, vals, idx = _flat(rng, o, n, k, live)
    assert tf.max_block_count(torch.from_numpy(idx), n, bn) == \
        ref_tf.max_block_count(idx, n, bn)
    if kb is not None and kb < ref_tf.max_block_count(idx, n, bn):
        with pytest.raises(ValueError):
            tf.encode_tiled(torch.from_numpy(vals), torch.from_numpy(idx),
                            n, bn=bn, kb=kb)
        return
    got = tf.encode_tiled(torch.from_numpy(vals), torch.from_numpy(idx), n,
                          bn=bn, kb=kb)
    want = ref_tf.encode_tiled(jnp.asarray(vals), idx, n, bn=bn, kb=kb)
    _assert_tiled_equal(got, want)
    np.testing.assert_array_equal(_np(tf.tiled_to_dense(got)),
                                  np.asarray(ref_tf.tiled_to_dense(want)))
    fv, fi = tf.tiled_to_flat(got)
    rv, ri = ref_tf.tiled_to_flat(want)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(fv.numpy(), np.asarray(rv))
    assert tf.tiled_storage_bits(got) == ref_tf.tiled_storage_bits(want)


def test_encode_tiled_bf16_values():
    rng = np.random.default_rng(3)
    _, vals, idx = _flat(rng, 10, 64, 20)
    got = tf.encode_tiled(torch.from_numpy(vals).to(torch.bfloat16),
                          torch.from_numpy(idx), 64, bn=16)
    want = ref_tf.encode_tiled(jnp.asarray(vals).astype(jnp.bfloat16), idx,
                               64, bn=16)
    assert got.values.dtype == torch.bfloat16
    _assert_tiled_equal(got, want)


def _skewed_mask(rng, o, n, k):
    """Balanced rows whose nonzeros crowd a few heavy columns — the case
    packing exists for."""
    p = rng.pareto(1.0, n) + 0.05
    mask = np.zeros((o, n), bool)
    for r in range(o):
        mask[r, rng.choice(n, size=k, replace=False, p=p / p.sum())] = True
    return mask


@pytest.mark.parametrize("o,n,k,bn,skewed", [
    (32, 96, 24, 32, False), (40, 100, 30, 32, True),
    (20, 64, 16, 64, False),                            # nb == 1
    (1, 48, 12, 16, True)])
def test_pack_columns_matches(o, n, k, bn, skewed):
    """The tensor-op greedy gives the reference's permutation exactly,
    and the packed encodings invert to the same dense/flat weights."""
    rng = np.random.default_rng(o + n + k)
    mask = _skewed_mask(rng, o, n, k) if skewed \
        else _balanced_mask(rng, o, n, k)
    perm = tf.pack_columns(torch.from_numpy(mask), bn)
    ref_perm = ref_tf.pack_columns(mask, bn)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), ref_perm)
    np.testing.assert_array_equal(tf.invert_perm(perm).numpy(),
                                  ref_tf.invert_perm(ref_perm))
    # packed encoding: remap indices into packed space, encode, invert
    idx = np.sort(np.argsort(~mask, axis=1, kind="stable")[:, :k],
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((o, k)).astype(np.float32)
    pidx = ref_tf.invert_perm(ref_perm)[idx]
    order = np.argsort(pidx, axis=1, kind="stable")
    pidx = np.take_along_axis(pidx, order, axis=1)
    pvals = np.take_along_axis(vals, order, axis=1)
    npack = ref_perm.shape[0]
    want = ref_tf.encode_tiled(jnp.asarray(pvals), pidx, npack, bn=bn)
    want = ref_tf.TiledBalanced(want.values, want.indices, want.counts,
                                n_in=n, bn=bn, perm=jnp.asarray(ref_perm))
    got = tf.encode_tiled(torch.from_numpy(pvals), torch.from_numpy(pidx),
                          npack, bn=bn)
    got = tf.TiledBalanced(got.values, got.indices, got.counts, n_in=n,
                           bn=bn, perm=perm)
    _assert_tiled_equal(got, want)
    np.testing.assert_array_equal(_np(tf.tiled_to_dense(got)),
                                  np.asarray(ref_tf.tiled_to_dense(want)))
    fv, fi = tf.tiled_to_flat(got)
    rv, ri = ref_tf.tiled_to_flat(want)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(fv.numpy(), np.asarray(rv))


def test_tiled_to_flat_rejects_unbalanced():
    rng = np.random.default_rng(5)
    _, vals, idx = _flat(rng, 6, 64, 10)
    tb = tf.encode_tiled(torch.from_numpy(vals), torch.from_numpy(idx), 64,
                         bn=16)
    counts = tb.counts.clone()
    counts[0, 0] -= 1
    with pytest.raises(ValueError, match="unbalanced"):
        tf.tiled_to_flat(tf.TiledBalanced(tb.values, tb.indices, counts,
                                          n_in=64, bn=16))
