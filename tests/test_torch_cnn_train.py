"""The port's Sense prune -> retrain path against the JAX reference on
numpy-seeded inputs, at the reduced small CNN of the reference's
`test_smallcnn_plan_grads_trainable_under_jit` (channels (8, 16), img 16,
fc_hidden 32): `smallcnn_loss` gradients against ``jax.grad`` for both rung
pairs (the port's ``xla`` against the reference's ``xla``; the port's
``cuda``, whose kernel wrappers run their plain versions on the CPU,
against the reference's ``pallas`` in interpret mode) at the f32 tolerance
1e-4; the chunked sparse conv's dx / dvalues; pad slots' exactly-zero
gradient; the per-step value re-gather (`engine.plan.TrainPlan`)
array-equal to a fresh plan, and its gradients (a packed fc1 on the
``cuda`` rung) against the reference's; a 5-step masked AdamW trajectory from
converted params; `iterative_prune_retrain`'s history.  The `cuda`-marked
test runs the gradient on a GPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pruning as ref_pruning  # noqa: E402
from repro.data.pipeline import SyntheticImageData as RefImageData  # noqa: E402,E501
from repro.engine import plan as ref_plan  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels.sparse_conv import sparse_conv2d as ref_sparse_conv2d  # noqa: E402,E501
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.optim import (AdamWConfig as RefAdamWConfig,  # noqa: E402
                         adamw_init as ref_adamw_init,
                         adamw_update as ref_adamw_update,
                         apply_masks as ref_apply_masks)
from repro_torch.core import pruning  # noqa: E402
from repro_torch.data import SyntheticImageData  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.sparse_conv import sparse_conv2d  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.convert import params_from_numpy, tree_to_numpy  # noqa: E402,E501
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               value_and_grad)

TOL = 1e-4                       # f32 (the reference's probe tolerance)
CFG = dict(channels=(8, 16), img=16, fc_hidden=32)
RUNGS = {"xla": "xla", "cuda": "pallas"}   # port rung -> reference rung


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _setup(seed=0, fc1_balanced=True):
    """Reference params from its own init and their masks (convs balanced
    0.5 per kernel; fc1 balanced 0.8 per row, or by magnitude as the
    example prunes it; fc2 by magnitude 0.8: unbalanced, so dense),
    converted to the port."""
    rcfg = ref_cnn.SmallCNNConfig(**CFG)
    rparams = ref_cnn.smallcnn_init(rcfg, jax.random.key(seed))
    rmasks = {}
    for i in range(len(rcfg.channels)):
        _, rmasks[f"conv{i}"] = ref_pruning.balanced_prune_conv(
            rparams[f"conv{i}"], 0.5)
    _, rmasks["fc1"] = (ref_pruning.balanced_prune_rows if fc1_balanced
                        else ref_pruning.random_prune)(rparams["fc1"], 0.8)
    _, rmasks["fc2"] = ref_pruning.random_prune(rparams["fc2"], 0.8)
    to_t = lambda d: params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, d), "cpu")
    return (cnn.SmallCNNConfig(**CFG), to_t(rparams), to_t(rmasks)), \
        (rcfg, rparams, rmasks)


def _batch(b=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 16, 16, 3)).astype(np.float32)
    labels = (np.arange(b) * 3 % 10).astype(np.int32)
    return ({"image": torch.from_numpy(x), "label": torch.from_numpy(labels)},
            {"image": jnp.asarray(x), "label": jnp.asarray(labels)})


def _ref_loss(rcfg, impl, rmasks, batch):
    """The reference's `smallcnn_loss` with its rung pinned (its own
    `smallcnn_loss` always takes the default ``xla``)."""
    def loss(p):
        logits = ref_cnn.smallcnn_apply(rcfg, p, batch["image"],
                                        masks=rmasks, impl=impl)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, batch["label"][:, None],
                                             axis=1))
    return loss


@pytest.mark.parametrize("rung", ["xla", "cuda"])
def test_smallcnn_grads_match_reference(rung):
    (cfg, params, masks), (rcfg, rparams, rmasks) = _setup()
    tb, rb = _batch()
    loss, grads = value_and_grad(
        lambda p: cnn.smallcnn_loss(cfg, p, tb, masks=masks, impl=rung),
        params)
    plan = engine_plan.plan_smallcnn(cfg, params, masks, impl=rung)
    assert plan.impl_mix() == {rung: 3, "dense": 1}
    rloss, rgrads = jax.value_and_grad(
        _ref_loss(rcfg, RUNGS[rung], rmasks, rb))(rparams)
    _close(float(loss), float(rloss))
    for nm in params:
        _close(grads[nm], rgrads[nm])
        # autograd reaches every kept weight and no pruned one
        pruned = masks[nm] == 0
        assert bool((grads[nm][pruned] == 0).all()), nm
        assert bool((grads[nm][~pruned] != 0).any()), nm


@pytest.mark.parametrize("rung", ["xla", "cuda"])
def test_sparse_conv_backward_matches_reference(rung):
    """dx and dvalues through the chunked im2col (four chunks of output
    rows, stride 2 and an explicit pad: the strided `unfold` views, the
    reshape copy, `torch.cat`) and each chunk's matmul."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    x = rng.standard_normal((2, 15, 15, 4)).astype(np.float32)
    dy = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    wm, mask = ref_pruning.balanced_prune_conv(jnp.asarray(w), 0.5)
    rlp = ref_plan.build_layer_plan("c", jnp.asarray(w), mask=mask,
                                    impl=RUNGS[rung], stride=2,
                                    conv_padding=1)
    lp = engine_plan.build_layer_plan(
        "c", torch.from_numpy(w), mask=torch.from_numpy(np.array(mask)),
        impl=rung, stride=2, conv_padding=1)
    chunk = 2 * 8 * 36 * 2              # two output rows a chunk

    def port(xt, enc):
        if rung == "cuda":
            fn = lambda f, v, i, n_in: ops.tiled_spmm(  # noqa: E731
                f, enc, block_m=lp.spec.blocks.bm, block_o=lp.spec.blocks.bo)
        else:
            fn = lambda f, v, i, n_in: ops.balanced_spmm(  # noqa: E731
                f, v, i, n_in=n_in, impl="xla")
        return sparse_conv2d(xt, enc.values, enc.indices, 36, hk=3, wk=3, stride=2,
                             padding=1, matmul_fn=fn, chunk_elems=chunk)

    def ref(xj, vals):
        enc = rlp.weights
        if rung == "cuda":
            enc = dataclasses.replace(enc, values=vals)
            fn = lambda f, v, i, n_in: ref_ops.tiled_spmm(  # noqa: E731
                f, enc, block_m=rlp.spec.blocks.bm,
                block_o=rlp.spec.blocks.bo, impl="pallas")
        else:
            fn = lambda f, v, i, n_in: ref_ops.balanced_spmm(  # noqa: E731
                f, v, i, n_in=n_in, impl="xla")
        y = ref_sparse_conv2d(xj, vals, enc.indices, 36, hk=3, wk=3,
                              stride=2, padding=1, matmul_fn=fn,
                              chunk_elems=chunk)
        return jnp.sum(y * dy)

    enc = lp.weights
    xt = torch.from_numpy(x).requires_grad_(True)
    vals = enc.values.detach().requires_grad_(True)
    y = port(xt, dataclasses.replace(enc, values=vals))
    assert y.shape == (2, 8, 8, 8)
    (y * torch.from_numpy(dy)).sum().backward()
    rdx, rdv = jax.grad(ref, argnums=(0, 1))(jnp.asarray(x),
                                             rlp.weights.values)
    _close(xt.grad, rdx)
    _close(vals.grad, rdv)


def test_pad_slots_get_exactly_zero_gradient():
    """The tiled Function's dvalues is exactly 0 at every pad slot (slot
    >= count) and the plan's value gather passes nothing from a pad slot
    to the dense weight."""
    (cfg, params, masks), _ = _setup()
    lp = engine_plan.build_layer_plan("conv1", params["conv1"],
                                      mask=masks["conv1"], impl="cuda")
    tb = lp.weights
    pads = torch.arange(tb.kb) >= tb.counts[..., None]
    assert bool(pads.any())
    vals = tb.values.detach().requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (24, lp.spec.n_in)).astype(np.float32))
    y = ops.tiled_spmm(x, dataclasses.replace(tb, values=vals))
    (y * y).sum().backward()
    assert bool((vals.grad[pads] == 0).all())
    assert bool((vals.grad[~pads] != 0).all())


@pytest.mark.parametrize("rung", ["cuda", "xla"])
def test_train_plan_regather_equals_fresh_build(rung):
    """`TrainPlan` built once, called on moved weights, is array-equal to a
    fresh `plan_smallcnn` of those weights (sparse convs, a sparse and a
    dense fc), and to a fresh `build_layer_plan` of a packed fc layer."""
    (cfg, params, masks), _ = _setup()
    tp = engine_plan.TrainPlan(engine_plan.plan_smallcnn(
        cfg, params, masks, impl=rung), masks)
    gen = torch.Generator().manual_seed(4)
    moved = {k: v + 0.05 * torch.randn(v.shape, generator=gen)
             for k, v in params.items()}
    # the re-gather is independent of the params it was built from
    cases = [(tp(moved), engine_plan.plan_smallcnn(cfg, moved, masks,
                                                   impl=rung))]
    # a packed fc: every row keeps columns of the first block only
    o, n = 16, 512
    w = torch.randn((o, n), generator=gen)
    mask = torch.zeros((o, n))
    mask[:, :64] = 1.0
    mask[:, 64:128] = (torch.arange(64) < 16).float()
    lp = engine_plan.build_layer_plan("fc", w, mask=mask, impl=rung)
    if rung == "cuda":
        assert lp.spec.packed
    w2 = w + 0.1 * torch.randn((o, n), generator=gen)
    one = engine_plan.ModelPlan(layers={"fc": lp})
    cases.append((engine_plan.TrainPlan(one, {"fc": mask})({"fc": w2}),
                  engine_plan.ModelPlan(layers={
                      "fc": engine_plan.build_layer_plan(
                          "fc", w2, mask=mask, impl=rung)})))
    for got, want in cases:
        assert got.layers.keys() == want.layers.keys()
        for nm, lp_got in got.layers.items():
            a, b = lp_got.weights, want.layers[nm].weights
            assert lp_got.spec == want.layers[nm].spec
            if isinstance(b, torch.Tensor):
                assert torch.equal(a, b), nm
                continue
            for f in ("values", "indices", "counts", "perm"):
                x, y = getattr(a, f, None), getattr(b, f, None)
                assert (x is None) == (y is None), (nm, f)
                if x is not None:
                    assert torch.equal(x, y), (nm, f)


@pytest.mark.parametrize("rung", ["xla", "cuda"])
def test_train_plan_grads_match_reference(rung):
    """The retraining step's gradients: through `TrainPlan` (built once,
    its values re-gathered from the live weights) against ``jax.grad`` of
    the reference's rung, with an fc1 that the ``cuda`` plan packs (every
    row keeps 48 of the first 64 columns: one block of 128 unpacked,
    spread over two by the packing perm)."""
    (cfg, params, masks), (rcfg, rparams, rmasks) = _setup()
    rng = np.random.default_rng(6)
    fc1 = np.zeros(tuple(params["fc1"].shape), np.float32)
    for row in fc1:
        row[rng.permutation(64)[:48]] = 1.0
    masks = {**masks, "fc1": torch.from_numpy(fc1)}
    rmasks = {**rmasks, "fc1": jnp.asarray(fc1)}
    tp = engine_plan.TrainPlan(engine_plan.plan_smallcnn(
        cfg, params, masks, impl=rung), masks)
    assert tp.plan.impl_mix() == {rung: 3, "dense": 1}
    assert tp.plan.layers["fc1"].spec.packed == (rung == "cuda")
    tb, rb = _batch()
    loss, grads = value_and_grad(
        lambda p: cnn.smallcnn_loss(cfg, p, tb, masks=masks, plan=tp(p)),
        params)
    rloss, rgrads = jax.value_and_grad(
        _ref_loss(rcfg, RUNGS[rung], rmasks, rb))(rparams)
    _close(float(loss), float(rloss))
    for nm in params:
        _close(grads[nm], rgrads[nm])
        pruned = masks[nm] == 0
        assert bool((grads[nm][pruned] == 0).all()), nm
        assert bool((grads[nm][~pruned] != 0).any()), nm


def test_masked_adamw_trajectory_matches_reference():
    """Five mask-preserving AdamW steps (the example's step: warmup 20,
    weight decay 0.01) on the synthetic image stream from converted params,
    the port's ``xla`` rung against the reference's: params within 1e-6
    after every step (the two differ by 1.5e-8 at most: f32 sums in
    another order), and every pruned position exactly 0.0 on the port's
    side after every step."""
    (cfg, params, masks), (rcfg, rparams, rmasks) = _setup(
        fc1_balanced=False)
    rparams = ref_apply_masks(rparams, rmasks)
    params = params_from_numpy(tree_to_numpy(params), "cpu")
    params = {k: v * masks[k] for k, v in params.items()}
    data = SyntheticImageData(img=16, batch=8, device="cpu")
    rdata = RefImageData(img=16, batch=8)
    kw = dict(lr=1e-3, warmup_steps=20, total_steps=5, weight_decay=0.01)
    opt, ropt = AdamWConfig(**kw), RefAdamWConfig(**kw)
    state, rstate = adamw_init(params), ref_adamw_init(rparams)
    tp = engine_plan.TrainPlan(engine_plan.plan_smallcnn(
        cfg, params, masks, impl="xla"), masks)

    @jax.jit
    def ref_step(p, s, batch):
        loss, g = jax.value_and_grad(
            lambda q: ref_cnn.smallcnn_loss(rcfg, q, batch, masks=rmasks))(p)
        p, s, _ = ref_adamw_update(ropt, p, g, s)
        return ref_apply_masks(p, rmasks), s, loss

    for step in range(5):
        params, state, loss = cnn.smallcnn_train_step(
            cfg, params, state, data.batch_at(step), opt, masks=masks,
            plan=tp, impl="xla")
        rparams, rstate, rloss = ref_step(rparams, rstate,
                                          rdata.batch_at(step))
        _close(float(loss), float(rloss))
        for nm in params:
            _close(params[nm], rparams[nm], tol=1e-6)
            assert bool((params[nm][masks[nm] == 0] == 0).all()), nm
    assert int(state["step"]) == int(rstate["step"]) == 5


@pytest.mark.parametrize("floor", [None, 0.5])
def test_iterative_prune_retrain_history_matches_reference(floor):
    """The cubic Zhu-Gupta ramp and the accuracy-floor stop, with
    deterministic callables on both sides: balanced conv pruning, a
    mask-preserving scaling as the retrain, the kept fraction as the
    metric."""
    w = np.random.default_rng(5).standard_normal((6, 4, 3, 3)).astype(
        np.float32)

    def run(prune_conv, as_float, w0):
        def prune_fn(p, s):
            pw, m = prune_conv(p["w"], s)
            return {"w": pw}, {"w": m}
        return (pruning if prune_conv is pruning.balanced_prune_conv
                else ref_pruning).iterative_prune_retrain(
            {"w": w0}, target_sparsity=0.8, n_stages=4, prune_fn=prune_fn,
            retrain_fn=lambda p, m: {"w": p["w"] * 1.5 * m["w"]},
            eval_fn=lambda p: as_float((p["w"] != 0).sum()) / w.size,
            accuracy_floor=floor)

    got = run(pruning.balanced_prune_conv, lambda t: float(t),
              torch.from_numpy(w))
    want = run(ref_pruning.balanced_prune_conv, lambda a: float(a),
               jnp.asarray(w))
    assert got.history == want.history
    assert got.final_sparsity == want.final_sparsity
    # the kept fraction falls below 0.5 at stage 2 of 4
    assert len(got.history) == (4 if floor is None else 2)
    np.testing.assert_array_equal(got.masks["w"].numpy(),
                                  np.asarray(want.masks["w"]))
    np.testing.assert_array_equal(got.params["w"].numpy(),
                                  np.asarray(want.params["w"]))


@pytest.mark.cuda
def test_smallcnn_grads_on_the_card_match_cpu():
    """The ``cuda`` rung's loss and gradients on the card (the CUDA
    kernels forward) against the same on the CPU (their plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    (cfg, params, masks), _ = _setup()
    tb, _ = _batch(8)
    loss, grads = value_and_grad(
        lambda p: cnn.smallcnn_loss(cfg, p, tb, masks=masks, impl="cuda"),
        params)
    dev = lambda d: {k: v.cuda() for k, v in d.items()}  # noqa: E731
    dloss, dgrads = value_and_grad(
        lambda p: cnn.smallcnn_loss(cfg, p, dev(tb), masks=dev(masks),
                                    impl="cuda"), dev(params))
    _close(float(dloss), float(loss))
    for nm in params:
        _close(dgrads[nm].cpu(), grads[nm])
