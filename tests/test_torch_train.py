"""The port's training substrate against the JAX reference (twins of
`tests/test_substrate.py`): checkpoints (atomicity, CRC, GC, and both
directions between the packages, bitwise, a bf16 leaf included), AdamW
(equal to the reference's update at rtol 1e-6 over 5 steps, with and
without clipping and masks), the data streams (batches bitwise equal),
gradient compression (bitwise equal) and the trainer's fault tolerance
(loss decreases, bit-exact resume, preemption, retry, stragglers,
compressed convergence), all on the CPU."""
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as ref_ckpt  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.data import (DataConfig as RefDataConfig,  # noqa: E402
                        SyntheticImageData as RefImageData,
                        SyntheticLMData as RefLMData)
from repro.distributed import compress as ref_compress  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, restore_checkpoint,
                                    save_checkpoint, verify_checkpoint)
from repro_torch.data import (DataConfig, SyntheticImageData,  # noqa: E402
                              SyntheticLMData)
from repro_torch.distributed import compress  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, apply_masks, lr_at,
                               value_and_grad)
from repro_torch.runtime import (Trainer, TrainerConfig,  # noqa: E402
                                 TransientError)
from repro_torch.tree import leaves  # noqa: E402


def _arrays(seed=0):
    r = np.random.default_rng(seed)
    return {"a": r.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": r.standard_normal(7).astype(np.float32),
                  "d": r.integers(0, 9, 5).astype(np.int32)}}


def tiny_tree(seed=0):
    return jax.tree.map(torch.from_numpy, _arrays(seed))


def _same(a, b):
    """Bitwise equality of two trees' leaves (torch or jax)."""
    for x, y in zip(leaves(a), jax.tree.leaves(b)):
        x = x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) \
            and x.dtype == torch.bfloat16 else np.asarray(x)
        y = np.asarray(y)
        if y.dtype.name == "bfloat16":
            y = y.view(np.int16)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    tree = tiny_tree()
    save_checkpoint(tmp_path, 7, tree, extra={"note": "x"})
    assert latest_step(tmp_path) == 7
    out, extra = restore_checkpoint(tmp_path, 7, tree)
    for a, b in zip(leaves(tree), leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert extra == {"note": "x"}
    assert verify_checkpoint(tmp_path, 7) == []


def test_checkpoint_crc_detects_corruption(tmp_path):
    tree = tiny_tree()
    save_checkpoint(tmp_path, 1, tree)
    d = tmp_path / "step_00000001"
    victim = next(f for f in d.iterdir() if f.suffix == ".npy")
    arr = np.load(victim).copy()
    flat = arr.reshape(-1)
    flat[0] = flat[0] + 1
    np.save(victim, arr)
    with pytest.raises(IOError):
        restore_checkpoint(tmp_path, 1, tree)
    problems = verify_checkpoint(tmp_path, 1)
    assert len(problems) == 1 and victim.name in problems[0]


def test_checkpoint_atomic_no_partial(tmp_path):
    save_checkpoint(tmp_path, 5, tiny_tree())
    # a straggling .tmp dir (crash mid-write) must not be visible
    (tmp_path / "step_00000009.tmp").mkdir()
    assert latest_step(tmp_path) == 5


def test_checkpoint_gc_keeps_n(tmp_path):
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, s, tiny_tree(), keep=2)
    steps = sorted(d.name for d in tmp_path.iterdir())
    assert steps == ["step_00000004", "step_00000005"]


def test_checkpoint_restores_to_the_given_device(tmp_path):
    """The port's reshard-on-load: each leaf goes to ``device``, else to
    its ``tree_like`` leaf's device."""
    tree = tiny_tree()
    save_checkpoint(tmp_path, 3, tree)
    out, _ = restore_checkpoint(tmp_path, 3, tree, device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(out))


def test_manager_falls_back_past_a_corrupt_step(tmp_path):
    mgr = CheckpointManager(tmp_path, every=1)
    tree = tiny_tree()
    assert mgr.maybe_save(1, tree) and mgr.maybe_save(2, tiny_tree(1))
    victim = next((tmp_path / "step_00000002").glob("*.npy"))
    victim.write_bytes(victim.read_bytes()[:20])
    step, out, _ = mgr.restore_latest(tree)
    assert step == 1
    _same(out, jax.tree.map(jnp.asarray, _arrays()))


def _mixed_tree(seed=0):
    """Reference-side tree of the trainer's state layout with a bf16 leaf."""
    r = np.random.default_rng(seed)
    return {"params": {"w": jnp.asarray(r.standard_normal((3, 5)),
                                        jnp.float32),
                       "e": jnp.asarray(r.standard_normal((4, 2)),
                                        jnp.bfloat16)},
            "opt": {"step": jnp.asarray(7, jnp.int32),
                    "m": [jnp.asarray(r.standard_normal(6), jnp.float32)]}}


def _to_port(tree):
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(one, tree)


def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path):
    ref = _mixed_tree()
    ref_ckpt.save_checkpoint(tmp_path, 4, ref, extra={"data_state": {
        "step": 4, "seed": 0}})
    like = _to_port(_mixed_tree(1))
    assert verify_checkpoint(tmp_path, 4) == []
    out, extra = restore_checkpoint(tmp_path, 4, like)
    assert out["params"]["e"].dtype == torch.bfloat16
    _same(out, ref)
    assert extra == {"data_state": {"step": 4, "seed": 0}}


def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path):
    ref = _mixed_tree()
    save_checkpoint(tmp_path, 9, _to_port(ref), extra={"k": 1})
    assert ref_ckpt.store.verify_checkpoint(tmp_path, 9) == []
    out, extra = ref_ckpt.restore_checkpoint(tmp_path, 9, _mixed_tree(1))
    assert out["params"]["e"].dtype == jnp.bfloat16
    _same(_to_port(ref), out)
    assert extra == {"k": 1}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_decreases_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                      weight_decay=0.0, grad_clip=0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw_init(params)
    loss = lambda p: (p["w"] ** 2).sum()  # noqa: E731
    for _ in range(60):
        _, g = value_and_grad(loss, params)
        params, state, _ = adamw_update(cfg, params, g, state)
    assert float(loss(params)) < 0.05


def test_apply_masks_preserves_zeros():
    params = {"w": torch.ones((2, 4)), "b": torch.ones(3)}
    masks = {"w": torch.tensor([[1, 0, 1, 0], [0, 1, 0, 1]],
                               dtype=torch.float32)}
    out = apply_masks(params, masks)
    assert int((out["w"] != 0).sum()) == 4
    assert torch.equal(out["b"], torch.ones(3))


@pytest.mark.parametrize("step", [0, 1, 19, 20, 21, 60, 100, 150])
def test_lr_schedule_matches_reference(step):
    kw = dict(lr=3e-4, warmup_steps=20, total_steps=100)
    got = float(lr_at(AdamWConfig(**kw), step))
    want = float(ref_optim.adamw.lr_at(ref_optim.AdamWConfig(**kw), step))
    assert got == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("clip,masked", [(0.0, False), (1.0, False),
                                         (0.05, True)])
def test_adamw_update_matches_reference(clip, masked):
    """Five steps from the same numpy params and grads: the clip (0.05
    binds on every step), bias corrections, weight decay and the masks."""
    r = np.random.default_rng(0)
    arrays = {"w": r.standard_normal((6, 5)).astype(np.float32),
              "b": {"c": r.standard_normal(4).astype(np.float32)}}
    mask = {"w": (r.random((6, 5)) < 0.5).astype(np.float32)} \
        if masked else None
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip,
              weight_decay=0.1)
    cfg, rcfg = AdamWConfig(**kw), ref_optim.AdamWConfig(**kw)
    params = jax.tree.map(torch.from_numpy, arrays)
    rparams = jax.tree.map(jnp.asarray, arrays)
    state, rstate = adamw_init(params), ref_optim.adamw_init(rparams)
    tmask = None if mask is None else jax.tree.map(torch.from_numpy, mask)
    for _ in range(5):
        g = jax.tree.map(lambda a: r.standard_normal(a.shape).astype(
            np.float32), arrays)
        params, state, met = adamw_update(cfg, params,
                                          jax.tree.map(torch.from_numpy, g),
                                          state)
        rparams, rstate, rmet = ref_optim.adamw_update(
            rcfg, rparams, jax.tree.map(jnp.asarray, g), rstate)
        params = apply_masks(params, tmask)
        rparams = ref_optim.apply_masks(rparams, mask)
        for a, b in zip(leaves(params) + leaves(state["m"])
                        + leaves(state["v"]),
                        jax.tree.leaves(rparams) + jax.tree.leaves(
                            rstate["m"]) + jax.tree.leaves(rstate["v"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        assert float(met["grad_norm"]) == pytest.approx(
            float(rmet["grad_norm"]), rel=1e-6)
        assert float(met["lr"]) == pytest.approx(float(rmet["lr"]), rel=1e-6)
    assert int(state["step"]) == int(rstate["step"]) == 5
    if masked:
        assert bool((params["w"][tmask["w"] == 0] == 0).all())


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_int8_quantization_error_bound():
    r = np.random.default_rng(0)
    x = torch.from_numpy((r.standard_normal(1000) * 5).astype(np.float32))
    q, s = compress.quantize_int8(x, block=256)
    deq = compress.dequantize_int8(q, s, x.shape, torch.float32)
    pad = (-x.numel()) % 256
    blocks = np.pad(x.numpy(), (0, pad)).reshape(-1, 256)
    bound = np.abs(blocks).max(axis=1) / 127 * 0.5 + 1e-7
    err = np.abs(np.pad((x - deq).numpy(), (0, pad))).reshape(-1, 256)
    assert (err <= bound[:, None] + 1e-6).all()


def test_compress_tree_matches_reference_bitwise():
    """Ten error-feedback steps on a tree with a ragged leaf: the
    dequantized grads and the residuals bitwise equal to the
    reference's."""
    r = np.random.default_rng(1)
    shapes = {"g": (8, 8), "h": {"k": (300,)}}
    res = compress.zero_residuals(jax.tree.map(
        lambda s: torch.zeros(s), shapes, is_leaf=lambda s: isinstance(
            s, tuple)))
    rres = ref_compress.zero_residuals(jax.tree.map(
        lambda s: jnp.zeros(s), shapes, is_leaf=lambda s: isinstance(
            s, tuple)))
    for _ in range(10):
        g = jax.tree.map(lambda s: (r.standard_normal(s) * 3).astype(
            np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
        out, res = compress.compress_tree(jax.tree.map(torch.from_numpy, g),
                                          res)
        rout, rres = ref_compress.compress_tree(
            jax.tree.map(jnp.asarray, g), rres)
        _same(out, rout)
        _same(res, rres)


def test_error_feedback_tracks_true_sum():
    """sum of compressed grads + final residual == sum of true grads."""
    r = np.random.default_rng(1)
    grads = [torch.from_numpy(r.standard_normal((8, 8)).astype(np.float32))
             for _ in range(10)]
    res = {"g": torch.zeros((8, 8))}
    total = torch.zeros((8, 8))
    for g in grads:
        out, res = compress.compress_tree({"g": g}, res)
        total += out["g"]
    np.testing.assert_allclose((total + res["g"]).numpy(),
                               sum(g.numpy() for g in grads),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_lm_batches_bitwise_equal_to_reference():
    cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=4, seed=3)
    d = SyntheticLMData(cfg, device="cpu")
    ref = RefLMData(RefDataConfig(vocab_size=64, seq_len=16, global_batch=4,
                                  seed=3))
    for step in (0, 5):
        got = d.batch_at(step)["tokens"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(ref.batch_at(step)["tokens"]))
    h1 = d.batch_at(2, host_id=1, n_hosts=2)["tokens"]
    np.testing.assert_array_equal(h1.numpy(), np.asarray(
        ref.batch_at(2, host_id=1, n_hosts=2)["tokens"]))
    # host sharding partitions the global batch
    h0 = d.batch_at(2, host_id=0, n_hosts=2)["tokens"]
    assert torch.equal(torch.cat([h0, h1]), d.batch_at(2)["tokens"])


def test_image_batches_bitwise_equal_to_reference():
    d = SyntheticImageData(img=16, batch=8, seed=2, device="cpu")
    ref = RefImageData(img=16, batch=8, seed=2)
    for step in (0, 7):
        got, want = d.batch_at(step), ref.batch_at(step)
        assert got["image"].dtype == torch.float32
        np.testing.assert_array_equal(got["image"].numpy(),
                                      np.asarray(want["image"]))
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))


def test_data_state_resumable_and_checked():
    cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=4, seed=3)
    d1 = SyntheticLMData(cfg, device="cpu")
    d2 = SyntheticLMData(cfg, device="cpu")
    d1.step = 17
    d2.load_state_dict(d1.state_dict())
    assert d2.step == 17
    with pytest.raises(ValueError, match="seed"):
        d2.load_state_dict({"step": 1, "seed": 4})
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            SyntheticLMData(cfg)
        else:
            raise RuntimeError("CUDA present: the default device is fine")


# ---------------------------------------------------------------------------
# trainer fault tolerance
# ---------------------------------------------------------------------------

def _make_trainer(tmp_path, steps=12, every=5, opt_total=None, **kw):
    cfg = DataConfig(vocab_size=32, seq_len=8, global_batch=4)
    data = SyntheticLMData(cfg, device="cpu")
    params = {"emb": torch.from_numpy((np.random.default_rng(0)
                                       .standard_normal((32, 16)) * 0.1)
                                      .astype(np.float32))}

    def loss_fn(p, batch):
        tokens = batch["tokens"].long()
        h = p["emb"][tokens[:, :-1]]
        logits = h @ p["emb"].T
        lse = torch.logsumexp(logits, -1)
        gold = logits.gather(-1, tokens[:, 1:, None])[..., 0]
        return (lse - gold).mean()

    return Trainer(loss_fn=loss_fn, params=params, data=data,
                   opt_cfg=AdamWConfig(lr=1e-2, warmup_steps=0,
                                       total_steps=opt_total or steps),
                   cfg=TrainerConfig(total_steps=steps,
                                     checkpoint_every=every,
                                     checkpoint_dir=str(tmp_path),
                                     log_every=1, **kw))


def test_trainer_loss_decreases(tmp_path):
    t = _make_trainer(tmp_path, steps=30)
    res = t.run()
    assert res["status"] == "done"
    losses = [m["loss"] for m in t.metrics_log]
    assert losses[-1] < losses[0]


def test_trainer_resume_bit_exact(tmp_path):
    """Interrupted-at-10 + resume == uninterrupted, bit-exact params and
    optimizer state; the data state comes back with the checkpoint."""
    t1 = _make_trainer(tmp_path / "a", steps=10, every=10, opt_total=20)
    t1.run()
    t2 = _make_trainer(tmp_path / "a", steps=20, every=10)
    assert t2.resume() and t2.step == 10 and t2.data.step == 10
    t2.run()
    t3 = _make_trainer(tmp_path / "b", steps=20, every=50)
    t3.run()
    assert torch.equal(t2.params["emb"], t3.params["emb"])
    for a, b in zip(leaves(t2.opt_state), leaves(t3.opt_state)):
        assert torch.equal(a, b)


def test_trainer_preemption_checkpoints(tmp_path):
    t = _make_trainer(tmp_path, steps=50, every=100)

    def hook(step):
        if step == 7:
            t.preempted = True
    res = t.run(fault_hook=hook)
    assert res["status"] == "preempted"
    assert latest_step(tmp_path) == res["step"] == 8


def test_trainer_sigterm_checkpoints_at_the_next_step(tmp_path):
    t = _make_trainer(tmp_path, steps=50, every=100)

    def hook(step):
        if step == 3:
            t._on_sigterm()          # what the SIGTERM handler does
    res = t.run(fault_hook=hook)
    assert res == {"status": "preempted", "step": 4}
    assert latest_step(tmp_path) == 4


def test_trainer_binds_sigterm_only_while_it_runs(tmp_path):
    """The run's SIGTERM handler sets the preemption flag (the run
    checkpoints and stops at the next step), and the handler that was
    bound before the run is bound again after it, also after a failure."""
    before = signal.getsignal(signal.SIGTERM)
    t = _make_trainer(tmp_path, steps=50, every=100)

    def hook(step):
        if step == 3:
            handler = signal.getsignal(signal.SIGTERM)
            assert handler == t._on_sigterm
            handler(signal.SIGTERM, None)
    res = t.run(fault_hook=hook)
    assert res == {"status": "preempted", "step": 4}
    assert signal.getsignal(signal.SIGTERM) == before

    def fail(step):
        raise RuntimeError("not transient")
    t2 = _make_trainer(tmp_path / "b", steps=5, every=100)
    with pytest.raises(RuntimeError):
        t2.run(fault_hook=fail)
    assert signal.getsignal(signal.SIGTERM) == before


def test_trainer_transient_fault_retries(tmp_path):
    """Two failures at step 3, each after the step's update ran: the retry
    starts from the last good state, so the run equals a clean one."""
    t = _make_trainer(tmp_path / "a", steps=6, every=100)
    fails = {"n": 0}
    step_fn = t._train_step

    def flaky(*args):
        out = step_fn(*args)
        if t.step == 3 and fails["n"] < 2:
            fails["n"] += 1
            raise TransientError("injected after the update")
        return out
    t._train_step = flaky
    res = t.run()
    assert res["status"] == "done" and fails["n"] == 2
    clean = _make_trainer(tmp_path / "b", steps=6, every=100)
    clean.run()
    assert torch.equal(t.params["emb"], clean.params["emb"])

    t = _make_trainer(tmp_path / "c", steps=6, every=100, max_retries=1)

    def always(step):
        if step == 2:
            raise TransientError("persistent")
    with pytest.raises(TransientError):
        t.run(fault_hook=always)


def test_trainer_straggler_detection(tmp_path):
    import time
    t = _make_trainer(tmp_path, steps=6, every=100, step_deadline_s=0.05)

    def hook(step):
        if step == 2:
            time.sleep(0.2)
    t.run(fault_hook=hook)
    assert t.straggler_steps == [2]


def test_trainer_grad_compression_still_converges(tmp_path):
    t = _make_trainer(tmp_path, steps=30, grad_compression=True)
    t.run()
    losses = [m["loss"] for m in t.metrics_log]
    assert losses[-1] < losses[0]
