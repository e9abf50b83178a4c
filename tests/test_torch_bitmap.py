"""The port's bitmap-compressed format and matmul (`kernels.bitmap_spmm`,
`ops.bitmap_spmm`, `ops.encode_bitmap`, `ref.bitmap_dense`) against the JAX
reference on numpy-seeded inputs: encodings array-equal (dynamic and
static ``k``, all-zero rows, an all-zero matrix), block choices equal,
``ops.bitmap_spmm`` within 1e-5 (f32) / 2e-2 (bf16) of the reference's
``impl="pallas"`` (interpret mode).  On the CPU the wrapper runs the
kernel's plain version; the CUDA kernel is checked by the `cuda`-marked
test, on a GPU."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402
from repro_torch.kernels import bitmap_spmm as bm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ref_bm = importlib.import_module("repro.kernels.bitmap_spmm")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _weight(seed, o, n, sparsity, *, zero_rows=()):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((o, n)).astype(np.float32)
    w *= rng.random((o, n)) >= sparsity
    w[list(zero_rows)] = 0.0
    return w


def _both(a, dtype="float32"):
    td, jd = DTYPES[dtype]
    return torch.from_numpy(a).to(td), jnp.asarray(a).astype(jd)


def _equal(got, want):
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert str(got.dtype).removeprefix("torch.") == str(
        np.asarray(want).dtype)


@pytest.mark.parametrize("o,n,bn,sparsity,zero_rows,dtype", [
    (8, 128, 128, 0.5, (), "float32"), (16, 256, 128, 0.9, (3,), "float32"),
    (5, 128, 32, 0.3, (0, 4), "bfloat16"), (6, 64, 64, 1.0, (), "float32")])
def test_bitmap_encode_matches_reference(o, n, bn, sparsity, zero_rows,
                                         dtype):
    """Bitmap, packed (its width, order and zero padding) and offsets
    array-equal to the reference's; an all-zero matrix packs K = 1."""
    w = _weight(o + n, o, n, sparsity, zero_rows=zero_rows)
    wt, wj = _both(w, dtype)
    got = ops.encode_bitmap(wt, bn=bn)
    want = ref_ops.encode_bitmap(wj, bn=bn)
    for g, h in zip(got, want):
        _equal(g, h)
    if sparsity == 1.0:
        assert got[1].shape == (o, 1)
    np.testing.assert_array_equal(
        ref.bitmap_dense(got[0], got[1]).float().numpy(), wt.float().numpy())


def test_bitmap_encode_static_k():
    """A static k at or above the largest row count pads ``packed`` to k
    as the reference does; below it both raise."""
    w = _weight(3, 6, 256, 0.6)
    kmax = int(np.count_nonzero(w, axis=1).max())
    wt, wj = _both(w)
    for k in (kmax, kmax + 5):
        got = bm.bitmap_encode(wt, 128, k=k)
        want = ref_bm.bitmap_encode(wj, 128, k=k)
        assert got[1].shape == (6, k)
        for g, h in zip(got, want):
            _equal(g, h)
    with pytest.raises(ValueError, match="static k"):
        ref_bm.bitmap_encode(wj, 128, k=kmax - 1)
    with pytest.raises(ValueError, match="static k"):
        bm.bitmap_encode(wt, 128, k=kmax - 1)
    with pytest.raises(ValueError, match="multiple"):
        bm.bitmap_encode(wt[:, :200], 128)


@pytest.mark.parametrize("m,o,n,k,itemsize,bn", [
    (128, 2048, 2048, 1024, 2, 128), (8, 8192, 2048, 1100, 2, 128),
    (128, 2048, 8192, 4200, 4, 128), (12, 16, 256, 30, 4, 128),
    (3, 7, 96, 40, 2, 32), (256, 4096, 4096, 4096, 4, 64)])
def test_choose_blocks_bitmap_matches_reference(m, o, n, k, itemsize, bn):
    """`choose_blocks` decides as the reference's for kind "bitmap" with a
    pinned bn, and for kind "tiled" with and without one."""
    for kw in ({"kind": "bitmap", "bn": bn}, {"kind": "tiled", "bn": bn},
               {"kind": "tiled"}):
        got = ops.choose_blocks(m, o, n, k, itemsize=itemsize, **kw)
        want = ref_ops.choose_blocks(m, o, n, k, itemsize=itemsize, **kw)
        assert (got.bm, got.bo, got.bn, got.vmem_bytes) == \
            (want.bm, want.bo, want.bn, want.vmem_bytes), kw


@pytest.mark.parametrize("o,n,sparsity,m", [(8, 128, 0.5, 12),
                                            (16, 256, 0.9, 12),
                                            (5, 128, 0.3, 12),
                                            (20, 256, 0.5, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_bitmap_spmm_matches_reference(o, n, sparsity, m, dtype):
    """``ops.bitmap_spmm`` (impl cuda: padded M and O, the kernel's plain
    version here) and impl xla against the reference's impl pallas, in
    x's dtype, with an all-zero row."""
    w = _weight(o * n, o, n, sparsity, zero_rows=(1,))
    wt, wj = _both(w, dtype)
    x_np = np.random.default_rng(7).standard_normal((m, n)).astype(
        np.float32)
    x, xj = _both(x_np, dtype)
    enc, enc_j = ops.encode_bitmap(wt), ref_ops.encode_bitmap(wj)
    want = np.asarray(ref_ops.bitmap_spmm(xj, *enc_j, impl="pallas"),
                      np.float32)
    for impl in ("cuda", "xla"):
        got = ops.bitmap_spmm(x.reshape(1, m, n), *enc, impl=impl)
        assert got.dtype == x.dtype and got.shape == (1, m, o)
        np.testing.assert_allclose(got[0].float().numpy(), want,
                                   rtol=TOL[dtype], atol=TOL[dtype])
    with pytest.raises(ValueError, match="impl"):
        ops.bitmap_spmm(x, *enc, impl="pallas")


def test_bitmap_kernel_contract_matches_pallas():
    """The wrapper (plain version here) against ``bitmap_spmm_pallas`` on
    tile-aligned inputs, f32 out: any nonzero bitmap byte is a set bit,
    and positions come from the per-block offsets."""
    w = _weight(11, 16, 256, 0.5)
    wt, wj = _both(w)
    bits, packed, offsets = bm.bitmap_encode(wt, 128)
    bits = bits * torch.from_numpy(np.random.default_rng(1).choice(
        np.array([1, -3, 7], np.int8), size=bits.shape))
    x_np = np.random.default_rng(2).standard_normal((8, 256)).astype(
        np.float32)
    x, xj = _both(x_np)
    got = bm.bitmap_spmm(x, bits, packed, offsets, bn=128)
    want = ref_bm.bitmap_spmm_pallas(xj, jnp.asarray(bits.numpy()),
                                     jnp.asarray(packed.numpy()),
                                     jnp.asarray(offsets.numpy()), bm=8,
                                     bo=16, bn=128, interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        bm.bitmap_decode(bits, packed, offsets, 128).numpy(), w)
    assert bm.LAUNCHES == {"bitmap_spmm": 0}


def test_bitmap_ref_matches_reference():
    w = _weight(5, 6, 256, 0.6)
    wt, wj = _both(w)
    bits, packed, _ = bm.bitmap_encode(wt, 128)
    want = ref_ref.bitmap_dense(jnp.asarray(bits.numpy()),
                                jnp.asarray(packed.numpy()))
    _equal(ref.bitmap_dense(bits, packed), want)
    x_np = np.random.default_rng(6).standard_normal((4, 256)).astype(
        np.float32)
    x, xj = _both(x_np)
    np.testing.assert_allclose(
        ref.bitmap_spmm_ref(x, bits, packed).numpy(),
        np.asarray(ref_ref.bitmap_spmm_ref(xj, jnp.asarray(bits.numpy()),
                                           jnp.asarray(packed.numpy()))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_bitmap_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card: both dtypes,
    the wide and skinny tiles, ragged M and O, bn 128 and 32, an all-zero
    row, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel runs only on the card)")
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        for o, n, bn in ((196, 384, 128), (70, 256, 32)):
            w = torch.from_numpy(_weight(o, o, n, 0.5, zero_rows=(2,))).to(
                dtype).cuda()
            enc = bm.bitmap_encode(w, bn)
            for m in (5, 8, 100):
                x = torch.from_numpy(rng.standard_normal((m, n)).astype(
                    np.float32)).to(dtype).cuda()
                before = bm.LAUNCHES["bitmap_spmm"]
                got = bm.bitmap_spmm(x, *enc, bn=bn)
                torch.cuda.synchronize()
                assert bm.LAUNCHES["bitmap_spmm"] == before + 1
                want = bm.bitmap_spmm_plain(x, *enc, bn=bn)
                np.testing.assert_allclose(got.cpu().numpy(),
                                           want.cpu().numpy(), rtol=1e-4,
                                           atol=1e-4)


@pytest.mark.parametrize("m", [16, 32, 128])
@pytest.mark.parametrize("o,n", [(2048, 2048), (8192, 2048), (2048, 8192)])
def test_bitmap_split_choice(o, n, m):
    """The bitmap kernel's wide branch takes the tiled kernels' split of
    its N / bn column blocks: at olmo-1b's projection shapes it divides
    them and fills between half and all of one wave of the H100's 132 SMs
    (one CTA each)."""
    from repro_torch.kernels import balanced_spmm as bs
    nb = n // 128
    s = bs.wide_splits(m, o, nb)
    ctas = -(-o // bs.TC_BO) * -(-m // bs.token_tile(m)) * s
    assert nb % s == 0
    assert bs.H100_SMS // 2 < ctas <= bs.H100_SMS
    x = torch.zeros((m, n), dtype=torch.float32)
    assert bs.split_workspace(x, m, o, nb) == (1, None)   # f32: FMA kernel


@pytest.mark.cuda
def test_cuda_bitmap_tensor_cores():
    """The bf16 wide branch (tensor cores) at ragged M (16, 24, 32, 64,
    256), bn 128, 32 and 20, against the plain version at 1e-4; two calls
    at a split shape bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel runs only on the card)")
    rng = np.random.default_rng(1)
    for o, n, bn in ((196, 1024, 128), (130, 640, 32), (70, 400, 20)):
        w = torch.from_numpy(_weight(o + bn, o, n, 0.5, zero_rows=(3,))).to(
            torch.bfloat16).cuda()
        enc = bm.bitmap_encode(w, bn)
        for m in (16, 24, 32, 64, 256):
            x = torch.from_numpy(rng.standard_normal((m, n)).astype(
                np.float32)).to(torch.bfloat16).cuda()
            got = bm.bitmap_spmm(x, *enc, bn=bn)
            np.testing.assert_allclose(
                got.cpu().numpy(),
                bm.bitmap_spmm_plain(x, *enc, bn=bn).cpu().numpy(),
                rtol=1e-4, atol=1e-4)
    w = torch.from_numpy(_weight(9, 256, 2048, 0.5)).to(torch.bfloat16).cuda()
    enc = bm.bitmap_encode(w, 128)
    x = torch.from_numpy(rng.standard_normal((128, 2048)).astype(
        np.float32)).to(torch.bfloat16).cuda()
    assert torch.equal(bm.bitmap_spmm(x, *enc, bn=128),
                       bm.bitmap_spmm(x, *enc, bn=128))


@pytest.mark.cuda
def test_cuda_bitmap_skinny_streamer():
    """The bf16 skinny branch (the weight streamer) at M = 1, 3, 8, bn 128,
    32 and 20, an all-zero row, and past the resident x (N = 16384),
    against the plain version at 1e-4; two calls bitwise equal and y[:3]
    of an M = 8 call bitwise equal to an M = 3 call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel runs only on the card)")
    rng = np.random.default_rng(2)
    for o, n, bn in ((196, 1024, 128), (130, 640, 32), (70, 400, 20),
                     (64, 16384, 128)):
        w = torch.from_numpy(_weight(o + bn, o, n, 0.5, zero_rows=(3,))).to(
            torch.bfloat16).cuda()
        enc = bm.bitmap_encode(w, bn)
        for m in (1, 3, 8):
            x = torch.from_numpy(rng.standard_normal((m, n)).astype(
                np.float32)).to(torch.bfloat16).cuda()
            got = bm.bitmap_spmm(x, *enc, bn=bn)
            np.testing.assert_allclose(
                got.cpu().numpy(),
                bm.bitmap_spmm_plain(x, *enc, bn=bn).cpu().numpy(),
                rtol=1e-4, atol=1e-4)
        assert torch.equal(got, bm.bitmap_spmm(x, *enc, bn=bn))
        assert torch.equal(got[:3], bm.bitmap_spmm(x[:3].contiguous(), *enc,
                                                   bn=bn))
