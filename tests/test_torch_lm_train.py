"""The port's LM training entry against the JAX reference: `train_loss` and
its gradients at the olmo-1b and deepseek-moe-16b smoke configs (f32
compute, converted params, 1e-4), with remat on and off; the loss pieces
(`chunked_cross_entropy`, `causal_lm_labels`) and the MLP primitives
alone; and ``python -m repro_torch.launch.train`` on the CPU (and its
refusal to run without a card unless ``--device cpu`` is given).  The
`cuda`-marked twins hold the gradients on a GPU against the CPU."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.core.pruning import to_balanced_sparse as ref_to_bs  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro_torch.checkpoint import latest_step, verify_checkpoint  # noqa: E402,E501
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.pruning import to_balanced_sparse  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import value_and_grad  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

TOL = 1e-4
ARCHS = ("olmo-1b", "deepseek-moe-16b")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _reference(arch, remat):
    """The reference's f32 smoke config, seed-0 params, a 2 x 32 batch
    (two loss chunks), its loss and gradients."""
    cfg = dataclasses.replace(ref_get_smoke(arch), compute_dtype="float32",
                              remat=remat)
    bundle = ref_build_model(cfg)
    params = bundle.init(jax.random.key(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    loss, grads = jax.value_and_grad(bundle.train_loss)(
        params, {"tokens": jnp.asarray(tokens)})
    return (jax.tree.map(np.asarray, params), tokens, float(loss),
            jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(arch, remat, device="cpu"):
    params, tokens, _, _ = _reference(arch, remat)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                              remat=remat)
    bundle = build_model(cfg, device)
    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    return value_and_grad(bundle.train_loss,
                          params_from_numpy(params, device), batch)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, remat):
    _, _, rloss, rgrads = _reference(arch, remat)
    loss, grads = _port_loss_and_grads(arch, remat)
    _close(float(loss), rloss)
    want = dict(flatten_with_paths(rgrads))
    got = flatten_with_paths(grads)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        _close(g, want[path])


@pytest.mark.parametrize("pad_id", [-1, 3])
def test_chunked_cross_entropy_and_labels_match_reference(pad_id):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, 8)).astype(np.float32)
    emb = rng.standard_normal((20, 8)).astype(np.float32)
    tokens = rng.integers(0, 20, (2, 12)).astype(np.int32)
    tokens[0, 4] = 3
    labels, mask = layers.causal_lm_labels(torch.from_numpy(tokens),
                                           pad_id=pad_id)
    rlabels, rmask = ref_layers.causal_lm_labels(jnp.asarray(tokens),
                                                 pad_id=pad_id)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(rlabels))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(rmask))
    for chunk in (4, 12):
        xt = torch.from_numpy(x).requires_grad_(True)
        et = torch.from_numpy(emb).requires_grad_(True)
        loss = layers.chunked_cross_entropy(xt, et, labels, chunk=chunk,
                                            mask=mask)
        loss.backward()
        loss = loss.detach()

        def ref(a, e):
            return ref_layers.chunked_cross_entropy(a, e, rlabels,
                                                    chunk=chunk, mask=rmask)
        rloss, (rdx, rde) = jax.value_and_grad(ref, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(emb))
        _close(float(loss), float(rloss))
        _close(xt.grad, rdx)
        _close(et.grad, rde)
    with pytest.raises(ValueError, match="multiple"):
        layers.chunked_cross_entropy(xt, et, labels, chunk=5)


def test_mlp_primitives_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) / 4
              for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) / 5
    t = torch.from_numpy
    _close(layers.swiglu(t(x), t(wg), t(wu), t(wd)),
           ref_layers.swiglu(jnp.asarray(x), jnp.asarray(wg),
                             jnp.asarray(wu), jnp.asarray(wd)))
    _close(layers.gelu_mlp(t(x), t(wg), t(wd)),
           ref_layers.gelu_mlp(jnp.asarray(x), jnp.asarray(wg),
                               jnp.asarray(wd)))
    w = rng.standard_normal((12, 16)).astype(np.float32)
    got = layers.sparse_linear(t(x), to_balanced_sparse(t(w), sparsity=0.5),
                               impl="xla")
    want = ref_layers.sparse_linear(jnp.asarray(x),
                                    ref_to_bs(jnp.asarray(w), sparsity=0.5),
                                    impl="xla")
    _close(got, want)
    gen = torch.Generator().manual_seed(0)
    d = layers.dense_init(gen, 256, 64)
    e = layers.embed_init(gen, 512, 32, dtype=torch.bfloat16)
    assert d.shape == (256, 64) and e.dtype == torch.bfloat16
    assert abs(float(d.std()) * 16 - 1) < 0.1
    assert abs(float(e.float().std()) / 0.02 - 1) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_to_done_on_the_cpu(arch, tmp_path, capsys):
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "4", "--ckpt-dir", str(tmp_path),
                      "--ckpt-every", "2", "--grad-compression"])
    assert res["status"] == "done" and res["step"] == 4
    assert np.isfinite(res["final_loss"])
    assert latest_step(tmp_path) == 4 and verify_checkpoint(tmp_path, 4) == []
    # resume: picks up step 4 and runs to 6
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "6", "--ckpt-dir", str(tmp_path),
                      "--resume"])
    assert res["status"] == "done" and res["step"] == 6
    assert "resumed from step 4" in capsys.readouterr().out


def test_launch_train_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "olmo-1b", "--smoke", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_grads_on_the_card_match_cpu(arch):
    """The same loss and gradients on the GPU (TF32 off) as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    loss, grads = _port_loss_and_grads(arch, True)
    dloss, dgrads = _port_loss_and_grads(arch, True, "cuda")
    _close(float(dloss), float(loss))
    for (path, g), (_, dg) in zip(flatten_with_paths(grads),
                                  flatten_with_paths(dgrads)):
        _close(dg.cpu(), g)
