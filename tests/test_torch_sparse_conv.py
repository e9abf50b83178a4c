"""The port's sparse convolution against the JAX reference on
numpy-seeded inputs: `im2col` bitwise equal to
``conv_general_dilated_patches`` (SAME, VALID, explicit pads, strides 1
and 2, 1x1 to 7x7 windows, f32 and bf16), `sparse_conv2d` chunked and
single-piece against the reference's with ``impl="xla"`` and against its
Pallas kernel in interpret mode, the dense conv oracles, `core.sparse_ops.
sparse_conv2d` and `tile_format.block_imbalance`.  f32 within 1e-4.  On
the CPU the kernel wrappers run their plain versions."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import sparse_ops as ref_sparse_ops  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro.kernels import tile_format as ref_tf  # noqa: E402
from repro_torch.core import pruning, sparse_ops  # noqa: E402
from repro_torch.kernels import ref, sparse_conv  # noqa: E402
from repro_torch.kernels import tile_format as tf  # noqa: E402

ref_sc = importlib.import_module("repro.kernels.sparse_conv")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# (hk, stride, padding): SAME and VALID, explicit pads, the 7x7 stride-2
# and 1x1 stride-2 geometries of the paper's ResNet-50 / GoogleNet
GEOMS = [(3, 1, "SAME"), (3, 2, "SAME"), (1, 2, "VALID"), (5, 1, 2),
         (7, 2, 3), (2, 1, "SAME")]


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype))


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


def _conv_weight(rng, co, ci, hk, sparsity=0.5):
    """A conv weight and its balanced mask."""
    w = rng.standard_normal((co, ci, hk, hk)).astype(np.float32)
    _, mask = ref_pruning.balanced_prune_conv(jnp.asarray(w), sparsity)
    return w, np.asarray(mask)


def _flat(w, mask):
    """The flat balanced encoding of a pruned conv weight in both
    packages."""
    co = w.shape[0]
    rsp = ref_pruning.from_mask(jnp.asarray(w.reshape(co, -1)),
                                jnp.asarray(mask.reshape(co, -1)))
    sp = pruning.from_mask(_t(w.reshape(co, -1)),
                           _t(mask.reshape(co, -1)))
    return sp, rsp


# ---------------------------------------------------------------------------
# im2col and the sparse conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hk,stride,padding", GEOMS)
def test_im2col_bitwise(dtype, hk, stride, padding):
    rng = np.random.default_rng(hk * 10 + stride)
    x = rng.standard_normal((2, 11, 10, 3)).astype(np.float32)
    got = sparse_conv.im2col(_t(x, dtype), hk, hk, stride=stride,
                             padding=padding)
    pad = [(padding, padding)] * 2 if isinstance(padding, int) else padding
    want = jax.lax.conv_general_dilated_patches(
        _j(x, dtype), filter_shape=(hk, hk), window_strides=(stride, stride),
        padding=pad, dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        _np(got), np.asarray(ref_sc.im2col(_j(x, dtype), hk, hk,
                                           stride=stride, padding=padding),
                             np.float32))
    for dim in (11, 10):
        assert sparse_conv._resolve_padding(dim, dim + 1, hk, hk, stride,
                                            padding) == \
            ref_sc._resolve_padding(dim, dim + 1, hk, hk, stride, padding)


@pytest.mark.parametrize("hk,stride,padding,chunk", [
    g + (c,) for g, c in zip(GEOMS, [sparse_conv._CHUNK_ELEMS, 300] * 3)])
def test_sparse_conv2d_matches_reference_xla(hk, stride, padding, chunk):
    """Single-piece (the default budget) and chunked in output rows (300
    patch elements: one or a few output rows a chunk)."""
    rng = np.random.default_rng(hk + stride)
    w, mask = _conv_weight(rng, 8, 3, hk)
    sp, rsp = _flat(w, mask)
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    got = sparse_conv.sparse_conv2d(_t(x), sp.values, sp.indices, sp.n_in,
                                    hk=hk, wk=hk, stride=stride,
                                    padding=padding, chunk_elems=chunk)

    def xla(flat, values, indices, n_in):
        return ref_ops.balanced_spmm(flat, values, indices, n_in=n_in,
                                     impl="xla")
    want = ref_sc.sparse_conv2d(jnp.asarray(x), rsp.values, rsp.indices,
                                rsp.n_in, hk=hk, wk=hk, stride=stride,
                                padding=padding, matmul_fn=xla,
                                chunk_elems=chunk)
    assert tuple(got.shape) == want.shape
    _close(got, want, "float32")
    # and the dense oracle of both packages
    w_hwio = np.transpose(w * mask, (2, 3, 1, 0))
    oracle = ref.sparse_conv2d_ref(_t(x), _t(w_hwio), stride=stride,
                                   padding=padding)
    _close(oracle, ref_ref.sparse_conv2d_ref(jnp.asarray(x),
                                             jnp.asarray(w_hwio),
                                             stride=stride, padding=padding),
           "float32")
    _close(got, np.asarray(oracle), "float32")


@pytest.mark.parametrize("hk,stride,padding,chunk", [
    (3, 1, "SAME", sparse_conv._CHUNK_ELEMS), (3, 2, "SAME", 600),
    (1, 2, "VALID", sparse_conv._CHUNK_ELEMS)])
def test_sparse_conv2d_matches_reference_pallas(hk, stride, padding, chunk):
    """Against the reference's default path: its Pallas kernel (interpret
    mode on the CPU) behind the flat `balanced_spmm` encoding cache."""
    rng = np.random.default_rng(11)
    w, mask = _conv_weight(rng, 8, 4, hk)
    sp, rsp = _flat(w, mask)
    x = rng.standard_normal((1, 7, 8, 4)).astype(np.float32)
    got = sparse_conv.sparse_conv2d(_t(x), sp.values, sp.indices, sp.n_in,
                                    hk=hk, wk=hk, stride=stride,
                                    padding=padding, chunk_elems=chunk)
    want = ref_sc.sparse_conv2d(jnp.asarray(x), rsp.values, rsp.indices,
                                rsp.n_in, hk=hk, wk=hk, stride=stride,
                                padding=padding, chunk_elems=chunk)
    _close(got, want, "float32")
    got = sparse_ops.sparse_conv2d(_t(x), sp, hk=hk, wk=hk, stride=stride,
                                   padding=padding)
    want = ref_sparse_ops.sparse_conv2d(jnp.asarray(x), rsp, hk=hk, wk=hk,
                                        stride=stride, padding=padding,
                                        impl="xla")
    _close(got, want, "float32")


def test_block_imbalance_equal():
    rng = np.random.default_rng(5)
    w, mask = _conv_weight(rng, 16, 12, 3)
    sp, rsp = _flat(w, mask)
    for bn in (8, 32, 128):
        assert tf.block_imbalance(tf.encode_tiled(sp.values, sp.indices,
                                                  sp.n_in, bn=bn)) == \
            pytest.approx(ref_tf.block_imbalance(ref_tf.encode_tiled(
                rsp.values, rsp.indices, rsp.n_in, bn=bn)), rel=1e-6)
