"""The port's block-quantized tile format (int8 / int4) against the JAX
reference on numpy-seeded inputs: `pack_int4`, `unpack_int4`,
`quantize_tiled` and `dequantize_values` array-equal; the quantized
`tiled_spmm` / `tiled_spmm_batched` on every rung (the port's ``cuda`` rung
runs the quant kernels' plain version on the CPU, the reference's
``pallas`` its quant kernels in interpret mode) within 1e-4 at f32 and
2e-2 at bf16, with the straight-through gradient; quantized plans of
olmo-1b and deepseek-moe-16b smoke array-equal; prefill logits of a
quantized plan within the same tolerances and greedy tokens equal at f32;
and ``serve --quant`` on the CPU."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import tile_format as ref_tf  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.kernels import balanced_spmm as bs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tile_format as tf  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

QUANTS = ("int8", "int4")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
IMPLS = {"cuda": "pallas", "xla": "xla", "xla_gather": "xla_gather"}
O, N, BN = 48, 96, 16                      # the reference's test_quant sizes


def _np(t):
    return t.detach().float().numpy()


def _eq(got, want):
    """Array-equal, dtype included (bf16 / int words compared as such)."""
    g = got.detach()
    w = np.asarray(want)
    assert str(g.dtype).removeprefix("torch.") == str(w.dtype), \
        (g.dtype, w.dtype)
    if g.dtype == torch.bfloat16:
        g, w = g.float(), w.astype(np.float32)
    np.testing.assert_array_equal(g.numpy(), w)


def _pair(rng, o, n, k, dtype, *, bn=BN, live=None, zero_rows=0,
          pack=False):
    """The same unquantized encoding in both packages: ``k`` nonzeros per
    row (among the first ``live`` columns), the values of the first
    ``zero_rows`` rows exactly 0 (all-zero blocks with live slots), and
    optionally column-packed."""
    mask = np.zeros((o, n), bool)
    for r in range(o):
        mask[r, rng.choice(live or n, size=k, replace=False)] = True
    idx = np.sort(np.argsort(~mask, axis=1, kind="stable")[:, :k],
                  axis=1).astype(np.int32)
    vals = rng.standard_normal((o, k)).astype(np.float32)
    vals[:zero_rows] = 0.0
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


def _stack(tb, lead, lib):
    """Reshape an ``[R, NB, KB]`` encoding's leaves to ``[*lead, O, ...]``."""
    o = tb.indices.shape[0]
    for d in lead:
        o //= d
    cls = lib.TiledBalanced

    def rs(t):
        return t.reshape(*lead, o, *t.shape[1:])
    return cls(rs(tb.values), rs(tb.indices), rs(tb.counts), n_in=tb.n_in,
               bn=tb.bn)


def _quant_pair(rng, quant, dtype="float32", *, o=O, n=N, k=None,
                stack=None, **kw):
    got, ref = _pair(rng, o, n, k or n // 2, dtype, **kw)
    if stack:
        got, ref = _stack(got, stack, tf), _stack(ref, stack, ref_tf)
    return tf.quantize_tiled(got, quant), ref_tf.quantize_tiled(ref, quant)


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kb", [8, 7])
def test_pack_unpack_int4_match_reference(kb):
    """Nibble packing (odd KB gets a zero pad slot) and sign-extending
    unpacking, array-equal to the reference's on stacked leaves."""
    q = np.random.default_rng(kb).integers(-8, 8, (2, 3, 5, kb)).astype(
        np.int8)
    packed = tf.pack_int4(torch.from_numpy(q))
    want = ref_tf.pack_int4(jnp.asarray(q))
    _eq(packed, want)
    assert packed.shape[-1] == -(-kb // 2)
    _eq(tf.unpack_int4(packed, kb), ref_tf.unpack_int4(want, kb))
    np.testing.assert_array_equal(tf.unpack_int4(packed, kb).numpy(), q)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stack", [None, (2, 3)])
def test_quantize_tiled_matches_reference(quant, dtype, stack):
    """q words, scales, indices and counts array-equal to the reference's,
    with all-zero blocks (scale 0, every q 0) and stacked ``[L, E, ...]``
    leaves; `dequantize_values` / `dequantize_tiled` / `tiled_to_dense`
    then agree bit for bit."""
    rng = np.random.default_rng(3)
    got, ref = _quant_pair(rng, quant, dtype, stack=stack, zero_rows=2,
                           live=70)
    assert got.quant == quant
    _eq(got.values, ref.values)
    _eq(got.scales, ref.scales)
    _eq(got.indices, ref.indices)
    _eq(got.counts, ref.counts)
    assert int((got.scales == 0).sum()) > 0        # all-zero blocks occur
    zero = got.scales == 0
    vals = tf.dequantize_values(got.values, got.scales, quant, got.kb)
    assert bool((vals[zero] == 0).all())
    # the logical KB (the reference's `kb` property reads an unstacked
    # shape)
    _eq(vals, ref_tf.dequantize_values(ref.values, ref.scales, quant,
                                       got.kb))
    if stack is None:
        _eq(tf.dequantize_tiled(got).values,
            ref_tf.dequantize_tiled(ref).values)
        _eq(tf.tiled_to_dense(got), ref_tf.tiled_to_dense(ref))
        flat_v, flat_i = tf.tiled_to_flat(got)
        want_v, want_i = ref_tf.tiled_to_flat(ref)
        _eq(flat_v, want_v)
        _eq(flat_i, want_i)
    with pytest.raises(ValueError, match="already"):
        tf.quantize_tiled(got, quant)
    with pytest.raises(ValueError, match="quant"):
        tf.quantize_tiled(tf.dequantize_tiled(got), "int3")


# ---------------------------------------------------------------------------
# the ops entries, every rung
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("impl", ["cuda", "xla", "xla_gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [4, 20, 40])
def test_tiled_spmm_quant_matches_reference(quant, impl, dtype, m):
    """`ops.tiled_spmm` on a quantized encoding against the reference's
    rung: skinny (M <= 8), gather (M <= 32) and wide M; O = 48 pads to the
    64-row block (the scales pad with zeros)."""
    rng = np.random.default_rng(10 + m)
    got, ref = _quant_pair(rng, quant, dtype, zero_rows=1)
    x, xj = _x(rng, (m, N), dtype)
    before = dict(bs.LAUNCHES)
    y = ops.tiled_spmm(x, got, impl=impl)
    assert y.dtype == x.dtype and y.shape == (m, O)
    _close(y, ref_ops.tiled_spmm(xj, ref, impl=IMPLS[impl]), dtype)
    assert bs.LAUNCHES == before                  # plain version on the CPU


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("m", [4, 40])
def test_tiled_spmm_quant_packed_matches_reference(quant, m):
    """A packed, quantized encoding on the kernel rung (x permuted into
    packed column space before the Function)."""
    rng = np.random.default_rng(20 + m)
    got, ref = _quant_pair(rng, quant, "bfloat16", pack=True)
    x, xj = _x(rng, (m, N), "bfloat16")
    _close(ops.tiled_spmm(x, got), ref_ops.tiled_spmm(xj, ref,
                                                      impl="pallas"),
           "bfloat16")


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("impl", ["cuda", "xla", "xla_gather"])
@pytest.mark.parametrize("m", [4, 20, 40])
def test_tiled_spmm_batched_quant_matches_reference(quant, impl, m):
    """`ops.tiled_spmm_batched` on quantized per-expert encodings (E = 3,
    ragged O = 24, so the expert scales pad too) against the reference."""
    rng = np.random.default_rng(30 + m)
    got, ref = _quant_pair(rng, quant, "float32", o=3 * 24, stack=(3,),
                           zero_rows=1)
    x, xj = _x(rng, (3, m, N), "float32")
    y = ops.tiled_spmm_batched(x, got, impl=impl)
    assert y.shape == (3, m, 24)
    _close(y, ref_ops.tiled_spmm_batched(xj, ref, impl=IMPLS[impl]),
           "float32")


def test_unquantized_tiled_encoding_on_eager_rungs():
    """An unquantized tiled encoding on ``xla`` / ``xla_gather`` runs the
    tiled eager twins (float values get a zero straight-through grad)."""
    rng = np.random.default_rng(4)
    got, ref = _pair(rng, O, N, 40, "float32")
    for impl in ("xla", "xla_gather"):
        for m in (4, 40):
            x, xj = _x(rng, (m, N), "float32")
            _close(ops.tiled_spmm(x, got, impl=impl),
                   ref_ops.tiled_spmm(xj, ref, impl=impl), "float32")
    vals = got.values.clone().requires_grad_(True)
    tb = tf.TiledBalanced(vals, got.indices, got.counts, n_in=N, bn=BN)
    ops.tiled_spmm(torch.ones((40, N)), tb, impl="xla").sum().backward()
    assert bool((vals.grad == 0).all())


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("impl", ["cuda", "xla"])
@pytest.mark.parametrize("batched", [False, True])
def test_quant_straight_through_grad_matches_reference(quant, impl, batched):
    """``dx`` through the dequantized weights equals the reference's."""
    rng = np.random.default_rng(5)
    if batched:
        got, ref = _quant_pair(rng, quant, o=2 * 24, stack=(2,))
        shape, fn, ref_fn = (2, 12, N), ops.tiled_spmm_batched, \
            ref_ops.tiled_spmm_batched
    else:
        got, ref = _quant_pair(rng, quant)
        shape, fn, ref_fn = (12, N), ops.tiled_spmm, ref_ops.tiled_spmm
    x, xj = _x(rng, shape, "float32")
    g = rng.standard_normal((*shape[:-1], got.n_out)).astype(np.float32)
    x.requires_grad_(True)
    (fn(x, got, impl=impl) * torch.from_numpy(g)).sum().backward()
    gx = jax.grad(lambda v: jnp.sum(ref_fn(v, ref, impl=IMPLS[impl]) * g))(xj)
    _close(x.grad, gx, "float32")


def test_entries_reject_unknown_rungs():
    rng = np.random.default_rng(6)
    got, _ = _quant_pair(rng, "int8")
    with pytest.raises(ValueError, match="impl"):
        ops.tiled_spmm(torch.zeros((4, N)), got, impl="dense")
    with pytest.raises(ValueError, match="impl"):
        ops.tiled_spmm_batched(torch.zeros((1, 4, N)), _stack(got, (1,), tf),
                               impl="pallas")


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params(arch, cd):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype=cd,
                                  sparse_serving=True)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=cd,
                              sparse_serving=True)
    ref_m = ref_build_model(ref_cfg)
    params_j = ref_m.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return ref_cfg, cfg, ref_m, params_j, params


@functools.lru_cache(maxsize=None)
def _plans(arch, cd, impl, quant):
    ref_cfg, cfg, _, params_j, params = _params(arch, cd)
    want = ref_plan.plan_model(ref_cfg, params_j, sparsity=0.5,
                               impl=IMPLS[impl], m_hint=16, decode_m=2,
                               quant=quant)
    got = engine_plan.plan_model(cfg, params, sparsity=0.5, impl=impl,
                                 m_hint=16, decode_m=2, quant=quant)
    return got, want


def _assert_plans_equal(got, want):
    assert sorted(got.layers) == sorted(want.layers)
    for nm, lp in got.layers.items():
        s, r = lp.spec, want.layers[nm].spec
        for f in ("mode", "n_in", "n_out", "k", "block_k", "experts",
                  "packed", "pack_kb", "quant"):
            assert getattr(s, f) == getattr(r, f), (nm, f)
        assert dataclasses.asdict(s.blocks) == dataclasses.asdict(r.blocks)
        assert dataclasses.asdict(s.blocks_decode) == \
            dataclasses.asdict(r.blocks_decode)
        w, rw = lp.weights, want.layers[nm].weights
        assert isinstance(w, tf.TiledBalanced) and w.quant == rw.quant
        for leaf in ("values", "indices", "counts", "scales"):
            _eq(getattr(w, leaf), getattr(rw, leaf))
        assert (w.perm is None) == (rw.perm is None)
        if w.perm is not None:
            _eq(w.perm, rw.perm)


@pytest.mark.parametrize("arch,impl,quant", [
    ("olmo-1b", "cuda", "int8"), ("olmo-1b", "xla", "int4"),
    ("deepseek-moe-16b", "cuda", "int4"), ("deepseek-moe-16b", "xla", "int8")])
def test_quant_plans_match_reference(arch, impl, quant):
    """Quantized plans on both families: every sparse layer tiled and
    quantized on both rungs (packed only on ``cuda``), array-equal to the
    reference's (its ``pallas`` <-> ``cuda``), meta included."""
    got, want = _plans(arch, "bfloat16", impl, quant)
    assert got.meta == want.meta and dict(got.meta)["quant"] == quant
    _assert_plans_equal(got, want)
    assert all(lp.spec.impl == impl for lp in got.layers.values())
    if impl == "xla":
        assert not any(lp.spec.packed for lp in got.layers.values())
        return
    # the masked-dense reference densifies through the scales
    _, _, _, params_j, params = _params(arch, "bfloat16")
    mine = engine_plan.masked_dense_params(params, got)["blocks"]
    ref = ref_plan.masked_dense_params(params_j, want)["blocks"]
    for nm in got.layers:
        np.testing.assert_array_equal(_np(mine[nm]),
                                      np.asarray(ref[nm], np.float32))


@pytest.mark.parametrize("quant", QUANTS)
def test_chunked_quantization_matches_unchunked(quant, monkeypatch):
    """Quantizing chunk by chunk inside the encoder gives the same arrays
    as one piece (the expert stacks are planned in chunks at full width)."""
    _, cfg, _, _, params = _params("deepseek-moe-16b", "bfloat16")

    def plan():
        return engine_plan.plan_model(cfg, params, sparsity=0.5, impl="cuda",
                                      m_hint=16, decode_m=2, quant=quant)
    got = plan()
    monkeypatch.setattr(engine_plan, "_PLAN_CHUNK", 1000)
    small = plan()
    for nm, lp in got.layers.items():
        for leaf in ("values", "indices", "counts", "scales"):
            np.testing.assert_array_equal(
                getattr(small.layers[nm].weights, leaf).numpy(),
                getattr(lp.weights, leaf).numpy())


def test_dense_never_quantizes_and_unknown_quant_raises():
    _, cfg, _, _, params = _params("olmo-1b", "float32")
    plan = engine_plan.plan_model(cfg, params, sparsity=0.5, impl="dense",
                                  quant="int8")
    assert all(lp.spec.quant == "none" and isinstance(lp.weights,
                                                      torch.Tensor)
               for lp in plan.layers.values())
    with pytest.raises(ValueError, match="quant"):
        engine_plan.plan_model(cfg, params, sparsity=0.5, quant="int3")


# ---------------------------------------------------------------------------
# the model and the serving entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,quant", [("olmo-1b", "int8"),
                                        ("deepseek-moe-16b", "int4")])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_quant_prefill_matches_reference(arch, quant, cd):
    """Prefill logits of a quantized plan (port ``cuda`` plain version vs
    the reference's ``pallas`` quant kernels) on identical weights."""
    _, cfg, ref_m, params_j, params = _params(arch, cd)
    got, want = _plans(arch, cd, "cuda", quant)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    lj, _ = jax.jit(ref_m.prefill)({**params_j, "sparse_plan": want},
                                   {"tokens": jnp.asarray(prompt)})
    execute.reset_stats()
    with torch.no_grad():
        lt, _ = build_model(cfg, "cpu").prefill(
            {**params, "sparse_plan": got},
            {"tokens": torch.from_numpy(prompt)})
    assert execute.stats()[f"quant_{quant}"] > 0
    _close(lt, lj, cd)


def test_quant_greedy_tokens_equal_reference_f32():
    """olmo-1b smoke, int8: greedy tokens equal to the reference's."""
    ref_cfg, cfg, ref_m, params_j, params = _params("olmo-1b", "float32")
    got, want = _plans("olmo-1b", "float32", "cuda", "int8")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    toks = serve.greedy_generate(build_model(cfg, "cpu"),
                                 {**params, "sparse_plan": got},
                                 torch.from_numpy(prompt), 4, 12)
    ref_toks = ref_serve.greedy_generate(ref_m,
                                         {**params_j, "sparse_plan": want},
                                         jnp.asarray(prompt), 4, 12)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_toks))


@pytest.mark.parametrize("arch,impl,quant", [
    ("olmo-1b", "cuda", "int8"), ("olmo-1b", "xla", "int4"),
    ("deepseek-moe-16b", "cuda", "int4"),
    ("deepseek-moe-16b", "xla_gather", "int8")])
def test_serve_quant_smoke_cpu(arch, impl, quant):
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--impl", impl, "--quant", quant, "--batch", "2",
                      "--prompt-len", "8", "--gen-steps", "3"])
    plan = res["plan"]
    stats = plan["engine_stats"]
    assert plan["quant"] == quant and plan["parity_tol"] == 5e-2
    assert stats[f"quant_{quant}"] == stats["balanced_spmm"] > 0
    assert plan["parity"]["layer_max_abs_diff"] <= 5e-2
    reached = set(plan["kernels_reached"])
    if impl == "cuda":
        assert reached and all(k.endswith("_q") for k in reached)
        assert ("tiled_balanced_spmm_batched_q" in reached) == \
            (arch == "deepseek-moe-16b")
    else:
        assert reached == set()


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("stack", [None, (2, 3)])
def test_quantized_pads_are_zero(quant, stack):
    """`quantize_tiled` keeps the live-prefix premise that the bf16 skinny
    kernels rely on: every slot from its block's count on is value 0 (the
    int4 nibble too, unpacked) and index 0, in the port's encoding and in
    the reference's from the same numpy input, plain and expert-stacked."""
    got, ref = _quant_pair(np.random.default_rng(41), quant, o=48, n=96,
                           k=40, stack=stack)
    for lib, tb in ((tf, got), (ref_tf, ref)):
        values = tb.values if quant == "int8" \
            else lib.unpack_int4(tb.values, tb.indices.shape[-1])
        values = np.asarray(values.numpy() if lib is tf else values)
        indices = np.asarray(tb.indices.numpy() if lib is tf
                             else tb.indices)
        counts = np.asarray(tb.counts.numpy() if lib is tf else tb.counts)
        pad = np.arange(indices.shape[-1]) >= counts[..., None]
        assert pad.any()
        assert (values[pad] == 0).all() and (indices[pad] == 0).all()
    _eq(got.values, ref.values)
