"""``--grad-compression`` on the port's live mesh, on the CPU: four
`torch.distributed` ranks over ``gloo`` (kept for the file) quantize their
blocks of each gradient as the reference's `compress_tree` quantizes the
whole leaf (256-element blocks of its row-major flattening, one block's
partial maxima combined by one ``all_reduce`` (max) over the axes that cut
it):

* leaves cut on dim 0, on dim 1, on both, a rank's block short of whole
  256-element blocks, a stacked 3-d leaf and a replicated one: the mesh's
  dequantized gradients and residuals, over two rounds (the residuals fed
  back), equal bit for bit the reference's `compress_tree` of the whole
  gradients; one ``all_reduce`` a set of cut axes, none for a replicated
  leaf, no gather;
* a two-step compressed mesh run of rwkv6-3b and zamba2-1.2b smoke
  (float32) against the reference's compressed `Trainer`: the loss and
  grad norm at 1e-4, the params, ``m`` and ``v`` blocks within one int8
  level (`launch.train.COMPRESSED_STATE_TOL`), almost every element at
  1e-4;
* ``train --mesh --grad-compression`` to done with its own gates; a
  resumed compressed run starts its residuals from zero (the reference's
  checkpoint holds no residuals)."""
import concurrent.futures
import dataclasses
import functools
import math
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLMData as RefSyntheticLMData  # noqa: E402
from repro.distributed import compress as ref_compress  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.runtime import Trainer as RefTrainer  # noqa: E402
from repro.runtime import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.ranks import keep_ranks, run_ranks  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.testing import multidevice  # noqa: E402
from repro_torch.tree import at_path, flatten_with_paths, leaves  # noqa: E402
from test_torch_family_mesh import _np_params  # noqa: E402
from test_torch_multidevice import _fake_mesh, _np_slice  # noqa: E402

MESH = (("data", "model"), (2, 2))
SIZES = dict(zip(*MESH))
LIMIT_S = 240.0
TOL = 1e-4
BATCH, SEQ, STEPS = 4, 32, 2
OPT = dict(lr=3e-4, warmup_steps=20, total_steps=STEPS)
# (whole shape, spec): the ways a leaf is cut
LEAVES = {
    "dim0": ((64, 32), P(("data", "model"), None)),
    "dim0_short": ((40, 24), P("data", None)),       # 480 a rank
    "dim1": ((24, 64), P(None, "model")),
    "both": ((32, 40), P("data", "model")),
    "stacked": ((2, 24, 40), P(None, "data", "model")),
    "replicated": ((300,), P(None)),
}


@functools.lru_cache(maxsize=None)
def _grads() -> dict:
    """Whole float32 gradients, each row at its own scale (blocks of
    different maxima), with one all-zero block."""
    rng = np.random.default_rng(11)
    out = {}
    for name, (shape, _) in LEAVES.items():
        a = rng.standard_normal(shape).astype(np.float32)
        a *= np.exp(rng.standard_normal(shape[:-1] + (1,))).astype(
            np.float32)
        out[name] = a
    out["dim0"][:8] = 0.0                          # one whole zero block
    return out


def _reference_rounds() -> list:
    grads = {k: jnp.asarray(v) for k, v in _grads().items()}
    res = ref_compress.zero_residuals(grads)
    out = []
    for i in range(2):
        deq, res = ref_compress.compress_tree(
            {k: g / (i + 1) for k, g in grads.items()}, res)
        out.append({"deq": {k: np.asarray(v) for k, v in deq.items()},
                    "res": {k: np.asarray(v) for k, v in res.items()}})
    return out


@pytest.fixture(scope="module")
def ranks4():
    with keep_ranks(4):
        yield


@pytest.fixture(scope="module")
def blocks(ranks4):
    with tempfile.TemporaryDirectory() as tmp:
        got = run_ranks(multidevice.compress_cases, 4,
                        init_method=f"file://{tmp}/r",
                        args=(*MESH, _grads(),
                              {k: tuple(s) for k, (_, s) in
                               LEAVES.items()}),
                        timeout_s=LIMIT_S)
    return {"ranks": got, "ref": _reference_rounds()}


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_mesh_compression_equals_the_whole_leafs_bitwise(blocks, leaf):
    """Each rank's dequantized gradient and residual blocks, over two
    rounds, are the reference's `compress_tree` of the whole gradient
    cut by the leaf's spec, bit for bit."""
    spec = LEAVES[leaf][1]
    for r in blocks["ranks"]:
        for got, want in zip(r["rounds"], blocks["ref"]):
            for part in ("deq", "res"):
                block = _np_slice(want[part][leaf], r["coord"], SIZES, spec)
                assert np.array_equal(got[part][leaf].view(np.uint32),
                                      block.view(np.uint32)), (leaf, part)


def test_mesh_compression_collectives(blocks):
    """One ``all_reduce`` (max) a set of cut axes, of 4 bytes a
    256-element block of the whole leaves it cuts; no gather."""
    groups: dict = {}
    for name, (shape, spec) in LEAVES.items():
        named = tuple(a for a in MESH[0] if any(
            a in ((d,) if isinstance(d, str) else d or ()) for d in spec))
        if named:
            groups[named] = groups.get(named, 0) + \
                -(-math.prod(shape) // 256) * 4
    for r in blocks["ranks"]:
        assert r["collectives"] == {"all_reduce": {
            "ops": len(groups), "bytes": sum(groups.values())}}


def _cfgs(arch: str):
    return tuple(dataclasses.replace(get(arch), compute_dtype="float32")
                 for get in (ref_get_smoke, get_smoke))


@functools.lru_cache(maxsize=None)
def _params(arch: str):
    return _np_params(_cfgs(arch)[0], 5)


def _reference_run(arch: str) -> dict:
    ref_cfg = _cfgs(arch)[0]
    data = RefSyntheticLMData(RefDataConfig(vocab_size=ref_cfg.vocab_size,
                                            seq_len=SEQ, global_batch=BATCH))
    with tempfile.TemporaryDirectory() as tmp:
        tr = RefTrainer(loss_fn=ref_build_model(ref_cfg).train_loss,
                        params=jax.tree.map(jnp.asarray, _params(arch)),
                        data=data, opt_cfg=RefAdamWConfig(**OPT),
                        cfg=RefTrainerConfig(total_steps=STEPS,
                                             checkpoint_every=100,
                                             checkpoint_dir=tmp, log_every=1,
                                             grad_compression=True))
        assert tr.run()["status"] == "done"
    return {"loss": [m["loss"] for m in tr.metrics_log],
            "grad_norm": [m["grad_norm"] for m in tr.metrics_log],
            "state": {"/".join(map(str, p)): np.asarray(v)
                      for p, v in flatten_with_paths(
                          {"params": tr.params, "m": tr.opt_state["m"],
                           "v": tr.opt_state["v"]})}}


ARCHS = ("rwkv6-3b", "zamba2-1.2b")


@pytest.fixture(scope="module")
def compressed(ranks4):
    """The compressed mesh runs of both archs (one `trainer_cases` call)
    and the reference's compressed `Trainer` runs, taken in a thread
    meanwhile."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        refs = {a: pool.submit(_reference_run, a) for a in ARCHS}
        cases = [{"cfg": _cfgs(a)[1], "params_np": _params(a),
                  "opt": AdamWConfig(**OPT), "steps": STEPS,
                  "batch": BATCH, "seq": SEQ, "grad_compression": True}
                 for a in ARCHS]
        with tempfile.TemporaryDirectory() as tmp:
            got = run_ranks(multidevice.trainer_cases, 4,
                            init_method=f"file://{tmp}/r",
                            args=(*MESH, cases), timeout_s=LIMIT_S)
        return {a: ([r[i] for r in got], refs[a].result())
                for i, a in enumerate(ARCHS)}


@pytest.mark.parametrize("arch", ARCHS)
def test_compressed_mesh_run_matches_reference(compressed, arch):
    ranks, ref = compressed[arch]
    specs = api.param_specs(_cfgs(arch)[1], _fake_mesh(*MESH, 0))
    for r in ranks:
        assert r["result"]["status"] == "done"
        assert r["replicas_equal"] == [True] * STEPS
        # the residuals are f32 blocks placed as the params
        assert r["residual_bytes"] == sum(
            a.size for k, a in r["state"].items()
            if k.startswith("params/")) * 4
        for got, want in zip(r["loss"] + r["grad_norm"],
                             ref["loss"] + ref["grad_norm"]):
            assert abs(got - want) <= TOL * abs(want), (got, want)
        for key, whole in ref["state"].items():
            spec = at_path(specs, tuple(key.split("/"))[1:])
            block = _np_slice(whole, r["coord"], SIZES, spec)
            scale = max(float(np.abs(whole).max()), 1e-30)
            err = np.abs(r["state"][key] - block) / scale
            assert float(err.max()) <= train.COMPRESSED_STATE_TOL, key
            assert float((err > TOL).mean()) <= 1e-2, key


def test_launch_train_mesh_compressed_runs_to_done(compressed, tmp_path):
    """``train --mesh --grad-compression`` of zamba2-1.2b smoke at
    float32 against one process that compresses too: its own gates hold,
    and each step runs the compression's ``all_reduce`` (max)."""
    rep = train.main(["--arch", "zamba2-1.2b", "--smoke", "--device",
                      "cpu", "--compute-dtype", "float32", "--steps", "2",
                      "--ckpt-every", "0", "--grad-compression", "--mesh",
                      "data=2,model=2", "--dist-init",
                      f"file://{tmp_path}/r"])["mesh"]
    assert rep["grad_compression"] and rep["ran_steps"] == [1, 2]
    assert rep["state_tol"] == train.COMPRESSED_STATE_TOL
    assert rep["loss_rel_err"] <= 1e-4 and rep["grad_norm_rel_err"] <= 1e-4
    uncompressed = ("--compute-dtype float32 --steps 1 --ckpt-every 0 "
                    "--mesh data=2,model=2").split()
    base = train.main(["--arch", "zamba2-1.2b", "--smoke", "--device",
                       "cpu", *uncompressed, "--dist-init",
                       f"file://{tmp_path}/r2"])["mesh"]
    # the compression's max adds one all_reduce a set of cut axes a step
    assert rep["ranks"][0]["collectives"][0]["all_reduce"]["ops"] > \
        base["ranks"][0]["collectives"][0]["all_reduce"]["ops"]


def test_resumed_compressed_run_starts_its_residuals_from_zero(tmp_path):
    """The checkpoint holds params and optimizer state, as the
    reference's `_state`: a resumed compressed trainer's error-feedback
    residuals start from zero (a documented difference from an
    uninterrupted run, not a fault)."""

    class Data:
        def batch_at(self, step):
            return {"x": torch.linspace(-1, 1, 300) * (step + 1)}

    def make():
        return Trainer(loss_fn=lambda p, b: (p["w"] * b["x"]).sum(),
                       params={"w": torch.zeros(300)}, data=Data(),
                       cfg=TrainerConfig(total_steps=2, checkpoint_every=1,
                                         checkpoint_dir=str(tmp_path),
                                         grad_compression=True))
    first = make()
    first.run()
    assert any(bool(r.abs().max() > 0) for r in leaves(first._residuals))
    second = make()
    assert second.resume() and second.step == 2
    assert all(bool((r == 0).all()) for r in leaves(second._residuals))
    assert torch.equal(second.params["w"], first.params["w"])
