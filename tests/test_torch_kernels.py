"""The port's kernel wrappers and `ops` entries against the JAX reference's
Pallas kernels run in interpret mode (inputs from numpy seeds): f32 within
1e-4, bf16 within 2e-2 (`guard._probe_tol`).  On the CPU the wrappers run
the kernels' plain version; the CUDA kernels themselves are checked by the
`cuda`-marked test, on a GPU."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import tile_format as ref_tf  # noqa: E402
from repro_torch.kernels import balanced_spmm as bs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tile_format as tf  # noqa: E402

# the reference package re-exports a function under the module's name
ref_bs = importlib.import_module("repro.kernels.balanced_spmm")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _np(t):
    return t.detach().float().numpy()


def _pair(rng, o, n, k, dtype, *, pack=False, bn=32, live=None):
    """The same balanced encoding in both packages (optionally packed;
    nonzeros only in the first ``live`` columns when given)."""
    mask = np.zeros((o, n), bool)
    for r in range(o):
        mask[r, rng.choice(live or n, size=k, replace=False)] = True
    idx = np.sort(np.argsort(~mask, axis=1, kind="stable")[:, :k],
                  axis=1).astype(np.int32)
    vals = (rng.standard_normal((o, k)) / np.sqrt(k)).astype(np.float32)
    n_enc, perm = n, None
    if pack:
        perm = ref_tf.pack_columns(mask, bn)
        pidx = ref_tf.invert_perm(perm)[idx]
        order = np.argsort(pidx, axis=1, kind="stable")
        idx = np.take_along_axis(pidx, order, axis=1)
        vals = np.take_along_axis(vals, order, axis=1)
        n_enc = perm.shape[0]
    ref = ref_tf.encode_tiled(jnp.asarray(vals).astype(getattr(jnp, dtype)),
                              idx, n_enc, bn=bn)
    ref = ref_tf.TiledBalanced(ref.values, ref.indices, ref.counts, n_in=n,
                               bn=bn, perm=None if perm is None
                               else jnp.asarray(perm))
    got = tf.TiledBalanced(
        torch.from_numpy(np.array(ref.values, np.float32)).to(
            getattr(torch, dtype)),
        torch.from_numpy(np.array(ref.indices)),
        torch.from_numpy(np.array(ref.counts)), n_in=n, bn=bn,
        perm=None if perm is None else torch.from_numpy(perm))
    return got, ref


def _x(rng, m, n, dtype):
    x = rng.standard_normal((m, n)).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_kernels_match_pallas(dtype):
    """The wide and skinny wrappers (plain version on CPU tensors) against
    `tiled_balanced_spmm_pallas` / `_skinny_pallas` in interpret mode on
    tile-aligned inputs, zero-count blocks included."""
    rng = np.random.default_rng(0)
    tb, ref = _pair(rng, 32, 96, 12, dtype, live=60)
    assert int((tb.counts == 0).sum()) > 0          # empty blocks occur
    x, xj = _x(rng, 16, 96, dtype)
    _close(bs.tiled_balanced_spmm(x, tb, bm=8, bo=16),
           ref_bs.tiled_balanced_spmm_pallas(xj, ref, bm=8, bo=16,
                                             interpret=True), dtype)
    x, xj = _x(rng, 8, 96, dtype)
    _close(bs.tiled_balanced_spmm_skinny(x, tb, bo=16),
           ref_bs.tiled_balanced_spmm_skinny_pallas(xj, ref, bo=16,
                                                    interpret=True), dtype)
    with pytest.raises(ValueError, match="tile-aligned"):
        bs.tiled_balanced_spmm(x[:5], tb, bm=8, bo=16)
    assert bs.LAUNCHES == {f"tiled_balanced_spmm{kind}{q}": 0
                           for kind in ("", "_skinny", "_batched")
                           for q in ("", "_q")}


@pytest.mark.parametrize("m", [1, 4, 8, 9, 128])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_spmm_matches_reference(m, pack, dtype):
    """`ops.tiled_spmm` (impl cuda) against the reference's (impl pallas):
    O = 50 is not a multiple of the block, skinny and wide M, packed and
    unpacked encodings."""
    rng = np.random.default_rng(m + 7 * pack)
    tb, ref = _pair(rng, 50, 100, 30, dtype, pack=pack)
    x, xj = _x(rng, m, 100, dtype)
    _close(ops.tiled_spmm(x, tb, block_m=64, block_o=32),
           ref_ops.tiled_spmm(xj, ref, block_m=64, block_o=32,
                              impl="pallas"), dtype)


@pytest.mark.parametrize("m,pack", [(4, False), (24, True)])
def test_tiled_spmm_grads_match_reference(m, pack):
    """dx and dvalues against the reference's custom_vjp; pad slots
    (slot >= count) get exactly zero gradient."""
    rng = np.random.default_rng(11)
    tb, ref = _pair(rng, 40, 100, 20, "float32", pack=pack)
    x, xj = _x(rng, m, 100, "float32")
    g = rng.standard_normal((m, 40)).astype(np.float32)
    x.requires_grad_(True)
    vals = tb.values.clone().requires_grad_(True)
    tbv = tf.TiledBalanced(vals, tb.indices, tb.counts, n_in=tb.n_in,
                           bn=tb.bn, perm=tb.perm)
    (ops.tiled_spmm(x, tbv) * torch.from_numpy(g)).sum().backward()

    def loss(xv, vv):
        r = ref_tf.TiledBalanced(vv, ref.indices, ref.counts, n_in=ref.n_in,
                                 bn=ref.bn, perm=ref.perm)
        return jnp.sum(ref_ops.tiled_spmm(xv, r, impl="pallas") * g)

    gx, gv = jax.grad(loss, argnums=(0, 1))(xj, ref.values)
    np.testing.assert_allclose(_np(x.grad), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(vals.grad), np.asarray(gv), rtol=1e-4,
                               atol=1e-4)
    pad = torch.arange(tb.kb) >= tb.counts[..., None]
    assert bool(pad.any()) and bool((vals.grad[pad] == 0).all())


@pytest.mark.parametrize("impl", ["xla", "xla_gather"])
@pytest.mark.parametrize("m", [4, 40])
def test_balanced_spmm_eager_rungs_match(impl, m):
    """The flat-format eager rungs against the reference's, skinny and
    wide M (xla routes skinny M to the gather formulation)."""
    rng = np.random.default_rng(m)
    mask = np.zeros((24, 70), bool)
    for r in range(24):
        mask[r, rng.choice(70, size=20, replace=False)] = True
    idx = np.sort(np.argsort(~mask, axis=1, kind="stable")[:, :20],
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((24, 20)).astype(np.float32)
    x, xj = _x(rng, m, 70, "float32")
    got = ops.balanced_spmm(x.reshape(2, m // 2, 70), torch.from_numpy(vals),
                            torch.from_numpy(idx), n_in=70, impl=impl)
    want = ref_ops.balanced_spmm(xj.reshape(2, m // 2, 70),
                                 jnp.asarray(vals), jnp.asarray(idx),
                                 n_in=70, impl=impl)
    assert got.shape == (2, m // 2, 24)
    _close(got, want, "float32")


@pytest.mark.parametrize("m,o,n,k,itemsize", [
    (128, 2048, 2048, 1024, 2), (4, 8192, 2048, 1024, 2),
    (256, 2048, 8192, 4096, 4), (16, 50, 100, 30, 4), (3, 7, 9, 2, 2)])
def test_choose_blocks_matches(m, o, n, k, itemsize):
    got = ops.choose_blocks(m, o, n, k, itemsize=itemsize)
    want = ref_ops.choose_blocks(m, o, n, k, itemsize=itemsize)
    assert (got.bm, got.bo, got.bn, got.vmem_bytes) == \
        (want.bm, want.bo, want.bn, want.vmem_bytes)
    assert ops.bucket_m(m) == ref_ops.bucket_m(m)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """Each CUDA kernel against its plain version on the card (both
    dtypes, ragged M and O, a packed encoding through `tiled_spmm`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    rng = np.random.default_rng(5)
    for dtype in ("float32", "bfloat16"):
        # O = 196: a multiple of neither CTA tile (64 wide, 8 skinny)
        tb, _ = _pair(rng, 196, 384, 96, dtype, bn=128)
        tbc = tf.TiledBalanced(tb.values.cuda(), tb.indices.cuda(),
                               tb.counts.cuda(), n_in=tb.n_in, bn=tb.bn)
        for m, fn in ((100, bs.tiled_balanced_spmm),
                      (5, bs.tiled_balanced_spmm_skinny)):
            x = _x(rng, m, 384, dtype)[0].cuda()
            kw = {"bm": 4, "bo": 4} if m > 8 else {"bo": 4}
            before = dict(bs.LAUNCHES)
            got = fn(x, tbc, **kw)
            torch.cuda.synchronize()
            assert sum(bs.LAUNCHES.values()) == sum(before.values()) + 1
            want = bs.tiled_balanced_spmm_plain(x, tbc)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
        tb, _ = _pair(rng, 64, 300, 60, dtype, pack=True, bn=128)
        tbc = tf.TiledBalanced(tb.values.cuda(), tb.indices.cuda(),
                               tb.counts.cuda(), n_in=tb.n_in, bn=tb.bn,
                               perm=tb.perm.cuda())
        x = _x(rng, 16, 300, dtype)[0]
        np.testing.assert_allclose(
            _np(ops.tiled_spmm(x.cuda(), tbc).cpu()),
            _np(ops.tiled_spmm(x, tb)), rtol=TOL[dtype], atol=TOL[dtype])


def _pair_batched(rng, e, o, n, k, dtype, *, pack=None, bn=32, live=None):
    """The same per-expert encodings ``[E, O, NB, KB]`` (one shared KB) in
    both packages.  ``pack``: None, ``"broadcast"`` (one packing perm over
    the pooled pattern, broadcast to ``[E, NB*bn]`` as a plan stores it)
    or ``"flat"`` (the same perm as one ``[NB*bn]`` row)."""
    mask = np.zeros((e * o, n), bool)
    for r in range(e * o):
        mask[r, rng.choice(live or n, size=k, replace=False)] = True
    idx = np.sort(np.argsort(~mask, axis=1, kind="stable")[:, :k],
                  axis=1).astype(np.int32)
    vals = (rng.standard_normal((e * o, k)) / np.sqrt(k)).astype(np.float32)
    n_enc, perm = n, None
    if pack:
        perm = ref_tf.pack_columns(mask, bn)
        pidx = ref_tf.invert_perm(perm)[idx]
        order = np.argsort(pidx, axis=1, kind="stable")
        idx = np.take_along_axis(pidx, order, axis=1)
        vals = np.take_along_axis(vals, order, axis=1)
        n_enc = perm.shape[0]
        if pack == "broadcast":
            perm = np.ascontiguousarray(np.broadcast_to(perm,
                                                        (e, perm.shape[0])))
    flat = ref_tf.encode_tiled(jnp.asarray(vals).astype(getattr(jnp, dtype)),
                               idx, n_enc, bn=bn)
    nb, kb = flat.values.shape[1:]
    ref = ref_tf.TiledBalanced(flat.values.reshape(e, o, nb, kb),
                               flat.indices.reshape(e, o, nb, kb),
                               flat.counts.reshape(e, o, nb), n_in=n, bn=bn,
                               perm=None if perm is None
                               else jnp.asarray(perm))
    got = tf.TiledBalanced(
        torch.from_numpy(np.array(ref.values, np.float32)).to(
            getattr(torch, dtype)),
        torch.from_numpy(np.array(ref.indices)),
        torch.from_numpy(np.array(ref.counts)), n_in=n, bn=bn,
        perm=None if perm is None else torch.from_numpy(perm))
    return got, ref


def _x3(rng, e, m, n, dtype):
    x = rng.standard_normal((e, m, n)).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [8, 16])
def test_plain_batched_kernel_matches_pallas(dtype, m):
    """The batched wrapper (plain version on CPU tensors) against
    `tiled_balanced_spmm_batched_pallas` in interpret mode, the skinny
    (M = 8) and wide capacities, zero-count blocks included."""
    rng = np.random.default_rng(20 + m)
    tb, ref = _pair_batched(rng, 3, 32, 96, 12, dtype, live=60)
    assert int((tb.counts == 0).sum()) > 0          # empty blocks occur
    x, xj = _x3(rng, 3, m, 96, dtype)
    _close(bs.tiled_balanced_spmm_batched(x, tb, bm=8, bo=16),
           ref_bs.tiled_balanced_spmm_batched_pallas(
               xj, ref.values, ref.indices, bn=32, bm=8, bo=16,
               interpret=True), dtype)
    with pytest.raises(ValueError, match="tile-aligned"):
        bs.tiled_balanced_spmm_batched(x[:, :5], tb, bm=8, bo=16)
    with pytest.raises(ValueError, match="expected x"):
        bs.tiled_balanced_spmm_batched(x[0], tb, bm=8, bo=16)
    assert bs.LAUNCHES["tiled_balanced_spmm_batched"] == 0


@pytest.mark.parametrize("m", [1, 8, 15])
@pytest.mark.parametrize("pack", [None, "broadcast", "flat"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tiled_spmm_batched_matches_reference(m, pack, dtype):
    """`ops.tiled_spmm_batched` (impl cuda) against the reference's (impl
    pallas): O = 50 is not a multiple of the block, skinny and wide
    per-expert M, unpacked, lead-broadcast packed and flat packed."""
    rng = np.random.default_rng(m + 3 * len(pack or ""))
    tb, ref = _pair_batched(rng, 3, 50, 100, 30, dtype, pack=pack)
    x, xj = _x3(rng, 3, m, 100, dtype)
    got = ops.tiled_spmm_batched(x, tb, block_m=16, block_o=32)
    assert got.shape == (3, m, 50) and got.dtype == x.dtype
    _close(got, ref_ops.tiled_spmm_batched(xj, ref, block_m=16, block_o=32,
                                           impl="pallas"), dtype)


@pytest.mark.parametrize("m,pack", [(4, None), (12, "broadcast")])
def test_tiled_spmm_batched_grads_match_reference(m, pack):
    """dx and dvalues of the batched autograd Function against
    ``jax.grad`` through the reference's ``_tiled_spmm_batched``; pad
    slots (slot >= count) get exactly zero gradient."""
    rng = np.random.default_rng(31)
    tb, ref = _pair_batched(rng, 3, 40, 100, 20, "float32", pack=pack)
    x, xj = _x3(rng, 3, m, 100, "float32")
    g = rng.standard_normal((3, m, 40)).astype(np.float32)
    x.requires_grad_(True)
    vals = tb.values.clone().requires_grad_(True)
    tbv = tf.TiledBalanced(vals, tb.indices, tb.counts, n_in=tb.n_in,
                           bn=tb.bn, perm=tb.perm)
    (ops.tiled_spmm_batched(x, tbv) * torch.from_numpy(g)).sum().backward()

    def loss(xv, vv):
        r = ref_tf.TiledBalanced(vv, ref.indices, ref.counts, n_in=ref.n_in,
                                 bn=ref.bn, perm=ref.perm)
        return jnp.sum(ref_ops.tiled_spmm_batched(xv, r, impl="pallas") * g)

    gx, gv = jax.grad(loss, argnums=(0, 1))(xj, ref.values)
    np.testing.assert_allclose(_np(x.grad), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(vals.grad), np.asarray(gv), rtol=1e-4,
                               atol=1e-4)
    pad = torch.arange(tb.kb) >= tb.counts[..., None]
    assert bool(pad.any()) and bool((vals.grad[pad] == 0).all())


@pytest.mark.parametrize("impl", ["xla", "xla_gather"])
@pytest.mark.parametrize("m", [4, 24])
def test_balanced_spmm_batched_eager_rungs_match(impl, m):
    """The experts' flat-format eager rungs against the reference's,
    skinny and wide capacity (xla gathers at skinny M)."""
    rng = np.random.default_rng(40 + m)
    e, o, n, k = 3, 24, 70, 20
    idx = np.stack([np.sort(rng.choice(n, size=k, replace=False))
                    for _ in range(e * o)]).reshape(e, o, k).astype(np.int32)
    vals = rng.standard_normal((e, o, k)).astype(np.float32)
    x, xj = _x3(rng, e, m, n, "float32")
    got = ops.balanced_spmm_batched(x.reshape(e, 2, m // 2, n),
                                    torch.from_numpy(vals),
                                    torch.from_numpy(idx), n_in=n, impl=impl)
    want = ref_ops.balanced_spmm_batched(xj.reshape(e, 2, m // 2, n),
                                         jnp.asarray(vals), jnp.asarray(idx),
                                         n_in=n, impl=impl)
    assert got.shape == (e, 2, m // 2, o)
    _close(got, want, "float32")


def test_batched_entries_reject_other_rungs():
    """The tiled batched entry takes the tiled rungs (``cuda``, and the
    eager ``xla`` / ``xla_gather`` twins, as the reference routes a tiled
    encoding) and raises on any other impl; the flat-format batched entry
    still raises on ``cuda``."""
    rng = np.random.default_rng(2)
    tb, ref = _pair_batched(rng, 2, 16, 64, 8, "float32")
    x, xj = _x3(rng, 2, 4, 64, "float32")
    with pytest.raises(ValueError, match="impl"):
        ops.tiled_spmm_batched(x, tb, impl="dense")
    _close(ops.tiled_spmm_batched(x, tb, impl="xla"),
           ref_ops.tiled_spmm_batched(xj, ref, impl="xla"), "float32")
    with pytest.raises(ValueError, match="impl 'xla'"):
        ops.balanced_spmm_batched(x, torch.zeros((2, 16, 8)),
                                  torch.zeros((2, 16, 8), dtype=torch.int32),
                                  n_in=64, impl="cuda")


@pytest.mark.cuda
def test_cuda_batched_kernel_matches_plain():
    """The batched CUDA kernel against its plain version on the card, both
    dtypes, the skinny (M <= 8) and wide tiles, ragged O through
    `ops.tiled_spmm_batched`, and a packed encoding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    rng = np.random.default_rng(6)
    for dtype in ("float32", "bfloat16"):
        tb, _ = _pair_batched(rng, 4, 192, 384, 96, dtype, bn=128)
        tbc = tf.TiledBalanced(tb.values.cuda(), tb.indices.cuda(),
                               tb.counts.cuda(), n_in=tb.n_in, bn=tb.bn)
        for m in (8, 16, 40):
            x = _x3(rng, 4, m, 384, dtype)[0].cuda()
            before = bs.LAUNCHES["tiled_balanced_spmm_batched"]
            got = bs.tiled_balanced_spmm_batched(x, tbc, bm=8, bo=64)
            torch.cuda.synchronize()
            assert bs.LAUNCHES["tiled_balanced_spmm_batched"] == before + 1
            want = bs.tiled_balanced_spmm_batched_plain(x, tbc)
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
        # O = 196 ragged, packed columns, through the ops entry
        tb, _ = _pair_batched(rng, 4, 196, 300, 60, dtype, bn=128,
                              pack="broadcast")
        tbc = tf.TiledBalanced(tb.values.cuda(), tb.indices.cuda(),
                               tb.counts.cuda(), n_in=tb.n_in, bn=tb.bn,
                               perm=tb.perm.cuda())
        x = _x3(rng, 4, 5, 300, dtype)[0]
        np.testing.assert_allclose(
            _np(ops.tiled_spmm_batched(x.cuda(), tbc).cpu()),
            _np(ops.tiled_spmm_batched(x, tb)), rtol=TOL[dtype],
            atol=TOL[dtype])


@pytest.mark.cuda
def test_cuda_quant_kernels_match_plain():
    """The three quant kernels (wide, skinny, batched) against their plain
    versions on the card, int8 and int4 (odd KB included), both x dtypes,
    with all-zero blocks, and ragged O through the `ops` entries (the
    scales pad with zeros)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    rng = np.random.default_rng(7)

    def cuda(tb):
        return tf.TiledBalanced(
            tb.values.cuda(), tb.indices.cuda(), tb.counts.cuda(),
            n_in=tb.n_in, bn=tb.bn, scales=tb.scales.cuda(), quant=tb.quant)

    for quant in ("int8", "int4"):
        for dtype in ("float32", "bfloat16"):
            tb, _ = _pair(rng, 256, 384, 96, dtype, bn=128, live=256)
            for kb in (tb.kb, tb.kb - 1):           # odd KB: a pad nibble
                t = tf.TiledBalanced(tb.values[..., :kb],
                                     tb.indices[..., :kb],
                                     tb.counts.clamp(max=kb), n_in=384,
                                     bn=128)
                qt = cuda(tf.quantize_tiled(t, quant))
                assert bool((qt.scales == 0).any())    # all-zero blocks
                for m, name in ((64, "tiled_balanced_spmm"),
                                (5, "tiled_balanced_spmm_skinny")):
                    x = _x(rng, m, 384, dtype)[0].cuda()
                    before = bs.LAUNCHES[name + "_q"]
                    if m > bs.SKINNY_MAX_M:
                        got = bs.tiled_balanced_spmm(x, qt, bm=8, bo=8)
                    else:
                        got = bs.tiled_balanced_spmm_skinny(x, qt, bo=8)
                    torch.cuda.synchronize()
                    assert bs.LAUNCHES[name + "_q"] == before + 1
                    np.testing.assert_allclose(
                        got.cpu().numpy(),
                        bs.tiled_balanced_spmm_plain(x, qt).cpu().numpy(),
                        rtol=1e-4, atol=1e-4)
            tb, _ = _pair_batched(rng, 4, 192, 384, 96, dtype, bn=128)
            qt = cuda(tf.quantize_tiled(tb, quant))
            for m in (8, 16):
                x = _x3(rng, 4, m, 384, dtype)[0].cuda()
                got = bs.tiled_balanced_spmm_batched(x, qt, bm=8, bo=64)
                np.testing.assert_allclose(
                    got.cpu().numpy(),
                    bs.tiled_balanced_spmm_batched_plain(x, qt).cpu().numpy(),
                    rtol=1e-4, atol=1e-4)
            # ragged O = 190 per expert through the entries' padding
            tb, _ = _pair_batched(rng, 2, 190, 384, 96, dtype, bn=128)
            qt = tf.quantize_tiled(tb, quant)
            x = _x3(rng, 2, 5, 384, dtype)[0]
            np.testing.assert_allclose(
                _np(ops.tiled_spmm_batched(x.cuda(), cuda(qt)).cpu()),
                _np(ops.tiled_spmm_batched(x, qt)), rtol=TOL[dtype],
                atol=TOL[dtype])


@pytest.mark.parametrize("pack", [False, True])
def test_ref_oracles_match(pack):
    """`kernels.ref`'s flat and tiled oracles against the reference's."""
    from repro.kernels import ref as ref_ref
    from repro_torch.kernels import ref
    rng = np.random.default_rng(3 + pack)
    tb, want_tb = _pair(rng, 24, 100, 30, "float32", pack=pack)
    x, xj = _x(rng, 6, 100, "float32")
    _close(ref.tiled_balanced_spmm_ref(x, tb),
           ref_ref.tiled_balanced_spmm_ref(xj, want_tb), "float32")
    vals, idx = tf.tiled_to_flat(tb)
    for name in ("balanced_spmm_ref", "balanced_spmm_gather"):
        _close(getattr(ref, name)(x, vals, idx),
               getattr(ref_ref, name)(xj, jnp.asarray(vals.numpy()),
                                      jnp.asarray(idx.numpy())), "float32")


# ---- the tensor-core wide kernel's host-side split choice ------------------
# (O, N) of olmo-1b's seven projections per layer and deepseek-moe-16b's
# attention, shared-expert and routed-expert (E = 64) projections
_OLMO = {"wq": (2048, 2048), "wk": (2048, 2048), "wv": (2048, 2048),
         "wo": (2048, 2048), "w_gate": (8192, 2048), "w_up": (8192, 2048),
         "w_down": (2048, 8192)}
_MOE = {"attn": (2048, 2048, 1), "shared_up": (2816, 2048, 1),
        "shared_down": (2048, 2816, 1), "expert_up": (1408, 2048, 64),
        "expert_down": (2048, 1408, 64)}
_SPLIT_SHAPES = [(name, o, n, 1) for name, (o, n) in _OLMO.items()] + \
    [(name, o, n, e) for name, (o, n, e) in _MOE.items()]


@pytest.mark.parametrize("m", [16, 32, 128])
@pytest.mark.parametrize("name,o,n,experts", _SPLIT_SHAPES)
def test_wide_splits_fill_the_card(name, o, n, experts, m):
    """The split divides NB and is the largest that keeps the CTAs within
    one wave of the H100's 132 SMs (one CTA each); no split when the tiles
    alone fill the card; the partials' workspace sized to match."""
    nb = -(-n // 128)
    s = bs.wide_splits(m, o, nb, experts=experts)
    tiles = experts * -(-o // bs.TC_BO) * -(-m // bs.token_tile(m))
    assert nb % s == 0 and 1 <= s <= bs.TC_MAX_SPLITS
    divisors = [d for d in range(1, min(nb, bs.TC_MAX_SPLITS) + 1)
                if nb % d == 0]
    if tiles >= bs.H100_SMS:
        assert s == 1
    else:
        assert tiles * s <= bs.H100_SMS
        assert all(tiles * d > bs.H100_SMS for d in divisors if d > s)
    want = 0 if s == 1 else s * experts * m * o
    assert bs.workspace_numel(m, o, s, experts) == want


@pytest.mark.parametrize("m", [1, 8, 9, 16, 128, 256])
def test_float32_never_takes_tensor_cores(m):
    """float32 x keeps the FMA kernels at every M (one split, no
    workspace); bf16 takes the tensor cores above the skinny M only; the
    token tile follows M."""
    assert not bs.tensor_core_route(torch.float32, m)
    assert bs.tensor_core_route(torch.bfloat16, m) == (m > bs.SKINNY_MAX_M)
    x = torch.zeros((m, 256), dtype=torch.float32)
    assert bs.split_workspace(x, m, 64, 2) == (1, None)
    assert bs.token_tile(m) == (32 if m <= 32 else 64 if m <= 64 else 128)


def _cuda_tb(rng, o, n, k, bn, quant="none", kb=None):
    """A balanced random [o, n] weight with k nonzeros a row, bf16, encoded
    on the card with column blocks of ``bn`` (capacity ``kb`` if given),
    quantized as ``quant`` says."""
    idx = np.sort(np.stack([rng.choice(n, size=k, replace=False)
                            for _ in range(o)]), axis=1).astype(np.int64)
    vals = (rng.standard_normal((o, k)) / np.sqrt(k)).astype(np.float32)
    tb = tf.encode_tiled(torch.from_numpy(vals).to(torch.bfloat16).cuda(),
                         torch.from_numpy(idx).cuda(), n, bn=bn, kb=kb)
    return tb if quant == "none" else tf.quantize_tiled(tb, quant)


def _bf16_x(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_cuda_wide_ragged_m(quant):
    """The tensor-core wide kernel (and its batched branch) at every token
    tile and ragged M (16, 24, 32, 64, 256; the batched branch at 16 and
    24), against the plain version at the f32 tolerance, one launch per
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    rng = np.random.default_rng(11)
    name = "tiled_balanced_spmm" + ("" if quant == "none" else "_q")
    tb = _cuda_tb(rng, 320, 1024, 512, 128, quant)
    for m in (16, 24, 32, 64, 256):
        x = _bf16_x(rng, (m, 1024))
        before = bs.LAUNCHES[name]
        got = bs.tiled_balanced_spmm(x, tb, bm=8, bo=64)
        torch.cuda.synchronize()
        assert bs.LAUNCHES[name] == before + 1
        np.testing.assert_allclose(
            got.cpu().numpy(), bs.tiled_balanced_spmm_plain(x, tb).cpu().numpy(),
            rtol=1e-4, atol=1e-4)
    tb = _cuda_tb(rng, 4 * 192, 1024, 512, 128, quant)
    lead = lambda t: None if t is None else t.reshape(4, 192, *t.shape[1:])  # noqa: E731,E501
    tbe = tf.TiledBalanced(lead(tb.values), lead(tb.indices), lead(tb.counts),
                           n_in=1024, bn=128, scales=lead(tb.scales),
                           quant=tb.quant)
    for m in (16, 24):
        x = _bf16_x(rng, (4, m, 1024))
        got = bs.tiled_balanced_spmm_batched(x, tbe, bm=8, bo=64)
        np.testing.assert_allclose(
            got.cpu().numpy(),
            bs.tiled_balanced_spmm_batched_plain(x, tbe).cpu().numpy(),
            rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [32, 20])
def test_cuda_wide_narrow_blocks(bn):
    """Column blocks of 32 and 20 (K padded to 16 with zeros; 20 takes
    narrower copies) and an odd KB, every value policy, bf16, against the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    rng = np.random.default_rng(12 + bn)
    n = 20 * bn
    for quant in ("none", "int8", "int4"):
        for kb in (None, bn - 1):             # bn - 1: an odd KB
            tb = _cuda_tb(rng, 200, n, n // 4, bn, quant, kb=kb)
            for m in (40, 128):
                x = _bf16_x(rng, (m, n))
                np.testing.assert_allclose(
                    bs.tiled_balanced_spmm(x, tb, bm=8, bo=8).cpu().numpy(),
                    bs.tiled_balanced_spmm_plain(x, tb).cpu().numpy(),
                    rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_wide_deterministic():
    """At a shape that splits NB, two calls of each bf16 wide kernel on the
    same input are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    rng = np.random.default_rng(13)
    x = _bf16_x(rng, (128, 2048))
    assert bs.wide_splits(128, 256, 16) > 1
    for quant in ("none", "int8", "int4"):
        tb = _cuda_tb(rng, 256, 2048, 1024, 128, quant)
        a = bs.tiled_balanced_spmm(x, tb, bm=8, bo=8)
        b = bs.tiled_balanced_spmm(x, tb, bm=8, bo=8)
        assert torch.equal(a, b)


def _pads_are_zero(values, indices, counts):
    """Every slot from its block's live count on is a pad: value 0, index
    0 (the bf16 skinny kernels read only each block's live prefix).  At
    least one pad must exist, so the check is not vacuous."""
    values = np.asarray(values, np.float32)
    indices, counts = np.asarray(indices), np.asarray(counts)
    pad = np.arange(indices.shape[-1]) >= counts[..., None]
    assert pad.any()
    assert (values[pad] == 0).all()
    assert (indices[pad] == 0).all()


@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_live_prefix_premise(pack, dtype):
    """`encode_tiled` (plain and column-packed) leaves every slot past its
    block's count at value 0 and index 0, in the port's encoding (made by
    the port's encoder from the numpy input) and in the reference's arrays
    from the same input, and the two agree."""
    rng = np.random.default_rng(21)
    o, n, k, bn = 96, 512, 200, 128
    _, ref = _pair(rng, o, n, k, dtype, pack=pack, bn=bn)
    # the port's own encoder on the slots the reference encoded
    nb, kb = ref.indices.shape[1:]
    cols = (np.arange(nb)[:, None] * bn + np.asarray(ref.indices)).reshape(
        o, -1)
    live = (np.arange(kb) < np.asarray(ref.counts)[..., None]).reshape(o, -1)
    idx = np.stack([c[m] for c, m in zip(cols, live)]).astype(np.int64)
    vals = np.stack([v[m] for v, m in zip(
        np.asarray(ref.values, np.float32).reshape(o, -1), live)])
    got = tf.encode_tiled(torch.from_numpy(vals).to(getattr(torch, dtype)),
                          torch.from_numpy(idx), nb * bn, bn=bn)
    _pads_are_zero(_np(got.values), got.indices.numpy(), got.counts.numpy())
    _pads_are_zero(ref.values, ref.indices, ref.counts)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))


# olmo-1b's seven projections (N, O) and deepseek-moe-16b's expert ones at
# sparsity 0.5: KB = 88 (the olmo-1b plan) and 96 (the expert stacks)
_STREAM_SHAPES = [("olmo-1b wq/wk/wv/wo", 2048, 88),
                  ("olmo-1b w_gate/w_up", 2048, 88),
                  ("olmo-1b w_down", 8192, 88),
                  ("deepseek we_gate/we_up", 2048, 96),
                  ("deepseek we_down", 1408, 96)]


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("name,n,kb", _STREAM_SHAPES)
def test_stream_keeps_x_resident(name, n, kb, quant):
    """The skinny streamer's host-side choice: at olmo-1b's and
    deepseek-moe-16b's shapes the whole x stays resident (one column
    range), every value policy; past it (N = 16384, 32768) x goes in
    ranges of a multiple of 32 blocks; the choice depends on the encoding
    alone (not on M)."""
    bb = bs.stream_block_bytes(kb, quant)
    assert bb % 16 == 0 and bb >= 4 * kb
    assert bs.stream_x_ranges(n, 128, bb) == 1
    assert bs.stream_x_ranges(16384, 128, bb) == 2
    assert bs.stream_x_ranges(32768, 128, bb) == 3
    assert bs.stream_x_ranges(100 * 20, 20, bs.stream_block_bytes(20)) == 1


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 16])
def test_float32_never_streams(m):
    """Only bf16 at M <= 8 takes the weight streamer; float32 keeps the FMA
    skinny templates at every M, and M > 8 is the wide route."""
    assert not bs.stream_route(torch.float32, m)
    assert bs.stream_route(torch.bfloat16, m) == (m <= bs.SKINNY_MAX_M)
    assert not (bs.stream_route(torch.bfloat16, m)
                and bs.tensor_core_route(torch.bfloat16, m))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_cuda_skinny_streamer(quant):
    """The bf16 skinny streamer against the plain version at every decode
    M, at column blocks of 128, 32 and 20, at N = 1408 (value runs that are
    not 16-byte aligned at int8 / int4) and past the resident x (N =
    16384); two calls bitwise equal and y[:3] of an M = 8 call bitwise
    equal to an M = 3 call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    rng = np.random.default_rng(31)
    for o, n, bn in ((512, 2048, 128), (256, 1408, 128), (128, 16384, 128),
                     (200, 640, 32), (200, 400, 20)):
        tb = _cuda_tb(rng, o, n, n // 2, bn, quant)
        for m in (1, 2, 3, 4, 5, 8):
            x = _bf16_x(rng, (m, n))
            np.testing.assert_allclose(
                bs.tiled_balanced_spmm_skinny(x, tb, bo=8).cpu().numpy(),
                bs.tiled_balanced_spmm_plain(x, tb).cpu().numpy(),
                rtol=1e-4, atol=1e-4)
        a = bs.tiled_balanced_spmm_skinny(x, tb, bo=8)
        assert torch.equal(a, bs.tiled_balanced_spmm_skinny(x, tb, bo=8))
        assert torch.equal(a[:3], bs.tiled_balanced_spmm_skinny(
            x[:3].contiguous(), tb, bo=8))


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_cuda_batched_empty_experts(quant):
    """The batched skinny streamer with x zero in 10 of 16 experts: exact
    +0.0 there, the plain version elsewhere, at every decode M."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    rng = np.random.default_rng(32)
    e, o, n = 16, 256, 1024
    tb = _cuda_tb(rng, e * o, n, n // 2, 128, quant)
    lead = lambda t: t.reshape(e, o, *t.shape[1:])  # noqa: E731
    tbe = tf.TiledBalanced(lead(tb.values), lead(tb.indices),
                           lead(tb.counts), n_in=n, bn=128,
                           scales=None if tb.scales is None
                           else lead(tb.scales), quant=tb.quant)
    dead = torch.from_numpy(rng.permutation(e)[:10]).cuda()
    for m in (1, 3, 4, 8):
        x = _bf16_x(rng, (e, m, n))
        x[dead] = 0
        got = bs.tiled_balanced_spmm_batched(x, tbe, bm=1, bo=8)
        assert bool((got[dead] == 0).all())
        assert not bool(torch.signbit(got[dead]).any())
        np.testing.assert_allclose(
            got.cpu().numpy(),
            bs.tiled_balanced_spmm_batched_plain(x, tbe).cpu().numpy(),
            rtol=1e-4, atol=1e-4)
