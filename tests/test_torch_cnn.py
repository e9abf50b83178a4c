"""The port's Sense-pruned CNN inference path against the JAX reference on
numpy-seeded inputs: balanced conv / random pruning masks equal,
`build_layer_plan` / `plan_smallcnn` spec fields and encodings array-equal
(reference ``pallas`` <-> port ``cuda``), `smallcnn_apply` logits from
converted reference params (and through the reference's Pallas kernels
in interpret mode at a tiny size).  f32 within 1e-4, bf16 within 2e-2.
`test_torch_sparse_conv.py` holds `im2col` and `sparse_conv2d`,
`test_torch_sparse_ops.py` the flat `balanced_spmm` ``cuda`` rung and the
§VI-F mode switch.  On the CPU the kernel
wrappers run their plain versions; the `cuda`-marked test runs the path
on a GPU."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.engine import execute as ref_execute  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
IMPLS = {"cuda": "pallas", "xla": "xla", "xla_gather": "xla_gather",
         "dense": "dense"}
# a small CNN whose Pallas run in interpret mode stays quick
TINY = dict(img=8, channels=(4, 8), kernel=3, n_classes=5, fc_hidden=16)


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


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("sparsity", [0.5, 5 / 9, 0.8])
def test_balanced_prune_conv_masks_equal(dtype, ties, sparsity):
    rng = np.random.default_rng(int(sparsity * 100) + ties)
    w = rng.standard_normal((6, 5, 3, 3)).astype(np.float32)
    if ties:
        w = np.round(w * 2) / 2
    got_w, got_m = pruning.balanced_prune_conv(_t(w, dtype), sparsity)
    want_w, want_m = ref_pruning.balanced_prune_conv(_j(w, dtype), sparsity)
    np.testing.assert_array_equal(_np(got_m), np.asarray(want_m, np.float32))
    np.testing.assert_array_equal(_np(got_w), np.asarray(want_w, np.float32))
    assert got_m.dtype == getattr(torch, dtype)
    with pytest.raises(ValueError):
        pruning.balanced_prune_conv(_t(w[0]), sparsity)


@pytest.mark.parametrize("ties", [False, True])
def test_random_prune_equal_and_generator(ties):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((12, 20)).astype(np.float32)
    if ties:
        w = np.round(w)
    got_w, got_m = pruning.random_prune(_t(w), 0.8)
    want_w, want_m = ref_pruning.random_prune(jnp.asarray(w), 0.8)
    np.testing.assert_array_equal(_np(got_m), np.asarray(want_m))
    np.testing.assert_array_equal(_np(got_w), np.asarray(want_w))
    # random order: the reference's key stream is JAX's; the port draws
    # from an explicit generator, with the same kept count
    k = pruning.keep_count(w.size, 0.8)
    a = pruning.random_prune(_t(w), 0.8, by_magnitude=False,
                             generator=torch.Generator().manual_seed(0))[1]
    b = pruning.random_prune(_t(w), 0.8, by_magnitude=False,
                             generator=torch.Generator().manual_seed(0))[1]
    c = pruning.random_prune(_t(w), 0.8, by_magnitude=False,
                             generator=torch.Generator().manual_seed(1))[1]
    assert int(a.sum()) == k == int(np.asarray(ref_pruning.random_prune(
        jnp.asarray(w), 0.8, rng=jax.random.key(0),
        by_magnitude=False)[1]).sum())
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        pruning.random_prune(_t(w), 0.8, by_magnitude=False)


# ---------------------------------------------------------------------------
# plans and the small CNN
# ---------------------------------------------------------------------------

def _smallcnn(cfg_kw, dtype="float32", seed=0):
    """Reference params from its own init, balanced-pruned (convs 0.5, fc
    0.8, as examples/adaptive_dataflow.py prunes), and the same params and
    masks converted to the port (built once per argument set; callers do
    not mutate them)."""
    return _smallcnn_cached(tuple(sorted(cfg_kw.items())), dtype, seed)


@functools.lru_cache(maxsize=None)
def _smallcnn_cached(cfg_items, dtype, seed):
    cfg_kw = dict(cfg_items)
    rcfg = ref_cnn.SmallCNNConfig(**cfg_kw)
    tparams = params_from_numpy(jax.tree.map(
        np.asarray, ref_cnn.smallcnn_init(rcfg, jax.random.key(seed))),
        "cpu")
    tmasks = {}
    for nm, w in tparams.items():
        prune = pruning.balanced_prune_conv if w.ndim == 4 \
            else pruning.balanced_prune_rows
        tparams[nm], tmasks[nm] = prune(w, 0.5 if w.ndim == 4 else 0.8)
    cast = lambda d: {k: v.to(getattr(torch, dtype))  # noqa: E731
                      for k, v in d.items()}
    tparams, tmasks = cast(tparams), cast(tmasks)
    as_jnp = lambda d: {k: _j(_np(v), dtype)  # noqa: E731
                        for k, v in d.items()}
    return (cnn.SmallCNNConfig(**cfg_kw), tparams, tmasks), \
        (rcfg, as_jnp(tparams), as_jnp(tmasks))


@pytest.mark.parametrize("impl", ["cuda", "xla", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plan_smallcnn_matches_reference(impl, dtype):
    (cfg, params, masks), (rcfg, rparams, rmasks) = _smallcnn({}, dtype)
    got = engine_plan.plan_smallcnn(cfg, params, masks, impl=impl)
    want = ref_plan.plan_smallcnn(rcfg, rparams, rmasks, impl=IMPLS[impl])
    assert sorted(got.layers) == sorted(want.layers)
    assert got.meta == want.meta
    for nm, lp in got.layers.items():
        s, r = lp.spec, want.layers[nm].spec
        assert s.impl == impl and r.impl == IMPLS[impl]
        for f in ("kind", "mode", "n_in", "n_out", "k", "block_k",
                  "w_sparsity", "d_mem_bits", "i_mem_bits", "w_mem_bits",
                  "hk", "wk", "stride", "conv_padding", "m_hint",
                  "decode_m", "packed", "pack_kb", "quant"):
            assert getattr(s, f) == getattr(r, f), (nm, f)
        for f in ("blocks", "blocks_decode"):
            assert (getattr(s, f) is None) == (getattr(r, f) is None)
            if getattr(s, f) is not None:
                assert dataclasses.asdict(getattr(s, f)) == \
                    dataclasses.asdict(getattr(r, f)), (nm, f)
        w, rw = lp.weights, want.layers[nm].weights
        if impl == "dense":
            np.testing.assert_array_equal(_np(w), np.asarray(rw, np.float32))
            continue
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
        np.testing.assert_array_equal(_np(lp.dense_weights()),
                                      np.asarray(want.layers[nm]
                                                 .dense_weights(),
                                                 np.float32))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_plan_smallcnn_quantized(quant):
    """A block-quantized smallcnn plan: the ``cuda`` one (the quant
    kernels' route) array-equal to the reference's ``pallas`` one, values,
    scales, indices and KB; the eager ``xla`` one's logits within 1e-4 of
    the reference's (the same dequantized weights on both sides)."""
    (cfg, params, masks), (rcfg, rparams, rmasks) = _smallcnn({})
    got = engine_plan.plan_smallcnn(cfg, params, masks, impl="cuda",
                                    quant=quant)
    want = ref_plan.plan_smallcnn(rcfg, rparams, rmasks, impl="pallas",
                                  quant=quant)
    for nm, lp in got.layers.items():
        w, r = lp.weights, want.layers[nm]
        assert (lp.spec.quant, lp.spec.block_k, lp.spec.packed) == \
            (r.spec.quant, r.spec.block_k, r.spec.packed) == \
            (quant, r.spec.block_k, nm == "fc1")
        for leaf in ("values", "indices", "counts", "scales"):
            np.testing.assert_array_equal(
                getattr(w, leaf).numpy(), np.asarray(getattr(r.weights,
                                                             leaf)))
    x = np.random.default_rng(2).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    got = engine_plan.plan_smallcnn(cfg, params, masks, impl="xla",
                                    quant=quant)
    want = ref_plan.plan_smallcnn(rcfg, rparams, rmasks, impl="xla",
                                  quant=quant)
    _close(cnn.smallcnn_apply(cfg, None, _t(x), plan=got),
           ref_cnn.smallcnn_apply(rcfg, rparams, jnp.asarray(x), plan=want),
           "float32")


def test_build_layer_plan_degrades_and_geometry():
    """An unbalanced mask degrades a requested sparse impl to dense (mask
    applied; a conv keeps its 4-D layout); no mask plans the weight's own
    pattern; conv geometry rides on the spec."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 3, 5, 5)).astype(np.float32)
    mask = (rng.random(w.shape) < 0.5).astype(np.float32)
    ls = engine_plan.LayerSpec(name="c", kind="conv", h_i=12, w_i=12, c_i=3,
                               c_o=6, h_k=5, w_k=5, stride=2, padding=2)
    lp = engine_plan.build_layer_plan("c", _t(w), mask=_t(mask),
                                      layer_spec=ls, impl="cuda", stride=2,
                                      conv_padding=2)
    rp = ref_plan.build_layer_plan("c", jnp.asarray(w),
                                   mask=jnp.asarray(mask), layer_spec=ls,
                                   impl="pallas", stride=2, conv_padding=2)
    assert (lp.spec.impl, lp.spec.kind, lp.spec.hk, lp.spec.stride) == \
        (rp.spec.impl, rp.spec.kind, rp.spec.hk, rp.spec.stride) == \
        ("dense", "conv", 5, 2)
    assert (lp.spec.w_sparsity, lp.spec.mode, lp.spec.d_mem_bits) == \
        (rp.spec.w_sparsity, rp.spec.mode, rp.spec.d_mem_bits)
    x = rng.standard_normal((2, 12, 12, 3)).astype(np.float32)
    _close(execute.apply_conv(_t(x), lp),
           ref_execute.apply_conv(jnp.asarray(x), rp), "float32")
    assert execute.apply_layer(_t(x), lp).shape == (2, 6, 6, 6)
    w2 = rng.standard_normal((8, 20)).astype(np.float32)
    w2[:, ::2] = 0.0                         # balanced: 10 of 20 per row
    lp = engine_plan.build_layer_plan("f", _t(w2))
    rp = ref_plan.build_layer_plan("f", jnp.asarray(w2))
    assert (lp.spec.impl, lp.spec.k, lp.spec.w_sparsity) == \
        ("xla", rp.spec.k, rp.spec.w_sparsity)
    assert engine_plan.balanced_mask_k(_t(w2) != 0) == \
        ref_plan.balanced_mask_k(w2 != 0) == 10
    assert engine_plan.balanced_mask_k(_t(mask.reshape(6, -1))) == \
        ref_plan.balanced_mask_k(mask.reshape(6, -1))


@pytest.mark.parametrize("impl", ["cuda", "xla", "xla_gather", "dense"])
def test_smallcnn_logits_match_reference(impl):
    """Logits from converted reference params within 1e-4 (f32), batch 5:
    wide conv GEMMs and skinny fc ones; the STATS counters show the sparse
    conv dispatches."""
    (cfg, params, masks), (rcfg, rparams, rmasks) = _smallcnn({})
    x = np.random.default_rng(0).standard_normal(
        (5, 32, 32, 3)).astype(np.float32)
    execute.reset_stats()
    got = cnn.smallcnn_apply(cfg, params, _t(x), masks=masks, impl=impl)
    want = ref_cnn.smallcnn_apply(rcfg, rparams, jnp.asarray(x),
                                  masks=rmasks,
                                  impl="xla" if impl == "cuda" else impl)
    assert tuple(got.shape) == (5, 10)
    _close(got, want, "float32")
    stats = execute.stats()
    if impl == "dense":
        assert stats["dense_conv"] == 3 and "sparse_conv" not in stats
    else:
        assert stats["sparse_conv"] == 3 and stats[f"impl_{impl}"] == 5
        assert stats["decode_dispatch"] == 2
    labels = np.arange(5) % 10
    loss = cnn.smallcnn_loss(cfg, params, {"image": _t(x),
                                           "label": torch.from_numpy(labels)},
                             masks=masks)
    rloss = ref_cnn.smallcnn_loss(rcfg, rparams, {"image": jnp.asarray(x),
                                                  "label": jnp.asarray(labels)},
                                  masks=rmasks)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-4, abs=1e-4)


def test_smallcnn_tiny_matches_reference_pallas():
    """The tiny CNN through the port's ``cuda`` plan against the
    reference's Pallas kernels in interpret mode (f32)."""
    (cfg, params, masks), (rcfg, rparams, rmasks) = _smallcnn(TINY, seed=1)
    x = np.random.default_rng(1).standard_normal(
        (2, 8, 8, 3)).astype(np.float32)
    plan = engine_plan.plan_smallcnn(cfg, params, masks, impl="cuda")
    got = cnn.smallcnn_apply(cfg, params, _t(x), plan=plan)
    want = ref_cnn.smallcnn_apply(rcfg, rparams, jnp.asarray(x),
                                  masks=rmasks, impl="pallas")
    _close(got, want, "float32")


def test_smallcnn_init_shapes_and_scale():
    cfg = cnn.SmallCNNConfig()
    params = cnn.smallcnn_init(cfg, torch.Generator().manual_seed(0))
    rparams = ref_cnn.smallcnn_init(ref_cnn.SmallCNNConfig(),
                                    jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        {k: v.shape for k, v in rparams.items()}
    for k, v in params.items():
        fan = v[0].numel()
        assert abs(float(v.float().std()) * fan ** 0.5 - 1.0) < 0.2, k
    again = cnn.smallcnn_init(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], v) for k, v in params.items())


@pytest.mark.cuda
def test_smallcnn_on_the_card_matches_cpu():
    """The small CNN's ``cuda`` plan on the card (the CUDA kernels) against
    the same plan's plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    (cfg, params, masks), _ = _smallcnn({})
    x = _t(np.random.default_rng(0).standard_normal((64, 32, 32, 3)))
    want = cnn.smallcnn_apply(cfg, params, x, masks=masks, impl="cuda")
    dev = {k: v.cuda() for k, v in params.items()}
    dmasks = {k: v.cuda() for k, v in masks.items()}
    got = cnn.smallcnn_apply(cfg, dev, x.cuda(), masks=dmasks)
    _close(got.cpu(), want.numpy(), "float32")
