"""The recurrent families' sharded train step on the port's live mesh, on
the CPU: four `torch.distributed` ranks over ``gloo`` (started once for
the file, `launch.ranks.keep_ranks`) run the mesh's `runtime.Trainer` on
their blocks of the reference's `param_specs` (the live bundles'
``train_loss``: rwkv6's channel split by heads, zamba2's Mamba mixers by
heads and its shared block column- / row-parallel), held against the JAX
reference's `repro.runtime.Trainer` on the reference bundle's
``train_loss`` from the same numpy-seeded params and the same
`SyntheticLMData` stream, at float32 and 1e-4 relative to each leaf's
max |value|:

* rwkv6-3b and zamba2-1.2b smoke on ``(data=2, model=2)`` and ``(data=1,
  model=4)``, and both with ``ssm_mode="chunked"`` on ``(data=2,
  model=2)``: per step the loss and the grad norm, then every rank's
  params, ``m`` and ``v`` blocks after 2 steps against the reference's
  whole leaves cut by the specs;
* every rank's replicated blocks bitwise equal to the other holders'
  after every step;
* ``python -m repro_torch.launch.train --mesh`` of both smoke configs at
  ``--compute-dtype float32`` to done with its own gates (at their own
  bf16 refused up front), and the launcher's mesh check and byte count
  taking every family."""
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
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.runtime import Trainer as RefTrainer  # noqa: E402
from repro.runtime import TrainerConfig as RefTrainerConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_smoke  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.dryrun import shard_bytes  # noqa: E402
from repro_torch.launch.ranks import keep_ranks, run_ranks  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.testing import multidevice  # noqa: E402
from repro_torch.tree import at_path, flatten_with_paths  # noqa: E402
from test_torch_family_mesh import _np_params  # noqa: E402
from test_torch_multidevice import _fake_mesh, _np_slice  # noqa: E402

MESHES = {"data2_model2": (("data", "model"), (2, 2)),
          "data1_model4": (("data", "model"), (1, 4))}
BATCH, SEQ, STEPS = 4, 32, 2            # two loss chunks of 16 a row
TOL = 1e-4
LIMIT_S = 240.0          # the launcher's limit on a mesh's cases
# the launcher's AdamW (`launch.train`): every step inside the warmup
OPT = dict(lr=3e-4, warmup_steps=20, total_steps=STEPS)
CASES = {"rwkv6": ("rwkv6-3b", {}),
         "zamba2": ("zamba2-1.2b", {}),
         "rwkv6_chunked": ("rwkv6-3b", dict(ssm_mode="chunked")),
         "zamba2_chunked": ("zamba2-1.2b", dict(ssm_mode="chunked"))}
EVERY_MESH = ("rwkv6", "zamba2")
PAIRS = [(m, c) for m in MESHES for c in CASES
         if c in EVERY_MESH or m == "data2_model2"]


def _cfgs(case: str):
    arch, fields = CASES[case]
    fields = dict(compute_dtype="float32", **fields)
    return (dataclasses.replace(ref_get_smoke(arch), **fields),
            dataclasses.replace(get_smoke(arch), **fields))


@functools.lru_cache(maxsize=None)
def _params(case: str):
    return _np_params(_cfgs(case)[0], 3)


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): np.asarray(v)
            for p, v in flatten_with_paths(tree)}


def _reference(case: str) -> dict:
    """The reference `Trainer`'s run of the case: per step the loss and
    grad norm, then its params and moments."""
    ref_cfg, _ = _cfgs(case)
    data = RefSyntheticLMData(RefDataConfig(vocab_size=ref_cfg.vocab_size,
                                            seq_len=SEQ, global_batch=BATCH))
    with tempfile.TemporaryDirectory() as tmp:
        tr = RefTrainer(loss_fn=ref_build_model(ref_cfg).train_loss,
                        params=jax.tree.map(jnp.asarray, _params(case)),
                        data=data, opt_cfg=RefAdamWConfig(**OPT),
                        cfg=RefTrainerConfig(total_steps=STEPS,
                                             checkpoint_every=100,
                                             checkpoint_dir=tmp,
                                             log_every=1))
        assert tr.run()["status"] == "done"
    return {"loss": [m["loss"] for m in tr.metrics_log],
            "grad_norm": [m["grad_norm"] for m in tr.metrics_log],
            "state": _flat({"params": tr.params, "m": tr.opt_state["m"],
                            "v": tr.opt_state["v"]})}


@pytest.fixture(scope="module")
def refs():
    """The reference's runs of every case, taken in a thread while the
    ranks run theirs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        futures = {c: pool.submit(_reference, c) for c in CASES}
        yield lambda case: futures[case].result()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, refs):
    """Every mesh's ranks' results of its cases (one `trainer_cases` call
    a mesh), on four rank processes kept for the file."""
    tmp = tmp_path_factory.mktemp("train_mesh_recurrent")
    cache: dict = {}

    def run(mesh_name: str) -> dict:
        if mesh_name not in cache:
            axes, sizes = MESHES[mesh_name]
            cases = [c for m, c in PAIRS if m == mesh_name]
            args = [{"cfg": _cfgs(c)[1], "params_np": _params(c),
                     "opt": AdamWConfig(**OPT), "steps": STEPS,
                     "batch": BATCH, "seq": SEQ} for c in cases]
            got = run_ranks(multidevice.trainer_cases, math.prod(sizes),
                            init_method=f"file://{tmp}/{mesh_name}",
                            args=(axes, sizes, args), timeout_s=LIMIT_S)
            cache[mesh_name] = {c: [r[i] for r in got]
                                for i, c in enumerate(cases)}
        return cache[mesh_name]
    with keep_ranks(4):
        yield run


def _specs(case: str, mesh_name: str) -> dict:
    axes, sizes = MESHES[mesh_name]
    return api.param_specs(_cfgs(case)[1], _fake_mesh(axes, sizes, 0))


@pytest.mark.parametrize("mesh_name,case", PAIRS)
def test_recurrent_mesh_trainer_matches_reference(runs, refs, mesh_name,
                                                  case):
    ranks = runs(mesh_name)[case]
    ref = refs(case)
    specs = _specs(case, mesh_name)
    sizes = dict(zip(*MESHES[mesh_name]))
    for r in ranks:
        assert r["result"]["status"] == "done" and r["steps"] == [1, 2]
        for step in range(STEPS):
            for got, want in ((r["loss"][step], ref["loss"][step]),
                              (r["grad_norm"][step],
                               ref["grad_norm"][step])):
                assert abs(got - want) <= TOL * abs(want), (step, got, want)
        assert sorted(r["state"]) == sorted(ref["state"])
        for key, whole in ref["state"].items():
            spec = at_path(specs, tuple(key.split("/"))[1:])
            block = _np_slice(whole, r["coord"], sizes, spec)
            scale = max(float(np.abs(whole).max()), 1e-30)
            err = float(np.abs(r["state"][key] - block).max()) / scale
            assert err <= TOL, (key, r["coord"], err)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_recurrent_replicated_blocks_bitwise(runs, mesh_name):
    """After every step each rank's replicated params and moments equal
    the other holders' bit for bit (checked in the ranks, and here on
    the blocks they returned)."""
    axes, _ = MESHES[mesh_name]
    for case, ranks in runs(mesh_name).items():
        specs = _specs(case, mesh_name)
        for r in ranks:
            assert r["replicas_equal"] == [True] * STEPS, case
        for key in ranks[0]["state"]:
            spec = at_path(specs, tuple(key.split("/"))[1:])
            named = {a for d in spec for a in shd.spec_axes(d)}
            held: dict = {}
            for r in ranks:
                block = tuple(r["coord"][a] for a in axes if a in named)
                if block in held:
                    assert np.array_equal(held[block], r["state"][key]), key
                held[block] = r["state"][key]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_launch_train_mesh_recurrent_runs_to_done(runs, tmp_path, arch):
    """``train --mesh`` of the recurrent smoke configs at float32 compute
    on the CPU: `run_mesh` raises where a gate fails, so a report is a
    pass."""
    rep = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--compute-dtype", "float32", "--steps", "2",
                      "--ckpt-every", "0", "--mesh", "data=2,model=2",
                      "--dist-init", f"file://{tmp_path}/rendezvous"]
                     )["mesh"]
    assert rep["ran_steps"] == [1, 2] and rep["parity_tol"] == 1e-4
    assert rep["state_tol"] == train.F32_STATE_TOL
    assert rep["replicas_equal"] and rep["bytes_equal"]
    assert max(rep["state_rel_err"].values()) <= 1e-4
    assert all(not any(r["kernel_launches"].values()) for r in rep["ranks"])
    # a step agrees on the preemption flag: one all_reduce more
    assert all(r["collectives"][-1]["all_reduce"]["ops"]
               for r in rep["ranks"])


@pytest.mark.parametrize("arch", ARCHS)
def test_refuse_mesh_takes_every_family(arch):
    """`launch.train.refuse_mesh` asks for the rendezvous, and every
    family the reference shards trains on the mesh: the recurrent ones
    at float32 compute only (at bf16 their state cannot be held against
    one process), refused before any rank starts."""
    args = train.build_parser().parse_args(["--arch", arch, "--smoke",
                                            "--mesh", "data=2,model=2"])
    cfg = train.config(args)
    with pytest.raises(ValueError, match="--dist-init"):
        train.refuse_mesh(args, cfg)
    args.dist_init = "file:///nonexistent/rendezvous"
    if cfg.family in train.FLOAT32_ONLY_MESH_FAMILIES:
        assert cfg.compute_dtype == "bfloat16"
        with pytest.raises(ValueError, match="--compute-dtype float32"):
            train.refuse_mesh(args, cfg)
        args.compute_dtype = "float32"
        cfg = train.config(args)
    train.refuse_mesh(args, cfg)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_launch_train_mesh_refuses_a_recurrent_family_at_bf16(tmp_path,
                                                              arch):
    """``train --mesh`` of a recurrent smoke config at its own bf16
    raises before it trains: no one-process run, no rank, no rendezvous
    file."""
    with pytest.raises(ValueError, match="only at float32 compute"):
        train.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "2", "--mesh", "data=2,model=2",
                    "--dist-init", f"file://{tmp_path}/rendezvous"])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("dtype,compressed,want", [
    ("float32", False, "F32_STATE_TOL"), ("bfloat16", False, 2e-2),
    ("float32", True, "COMPRESSED_STATE_TOL"),
    ("bfloat16", True, "COMPRESSED_STATE_TOL")])
def test_state_tol_by_dtype_and_compression(dtype, compressed, want):
    """`launch.train.state_tol`: a mesh run's params / ``m`` / ``v`` are
    held at `F32_STATE_TOL` at float32, at the dtype's 2e-2 at bf16 and at
    `COMPRESSED_STATE_TOL` compressed; its loss and grad norm stay at the
    dtype's tolerance (the ``tol`` passed in)."""
    args = train.build_parser().parse_args(
        ["--arch", "olmo-1b", "--smoke", "--compute-dtype", dtype]
        + ["--grad-compression"] * compressed)
    tol = 1e-4 if dtype == "float32" else 2e-2
    want = getattr(train, want) if isinstance(want, str) else want
    assert train.state_tol(args, train.config(args), tol) == want


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b", "olmo-1b"])
def test_mesh_bytes_takes_every_family(arch):
    """`launch.train.mesh_bytes` sums the family's own params (a
    recurrent family's `init_shapes`, not the transformer's) by its
    `param_specs`, the moments twice and a step counter."""
    cfg = get_smoke(arch)
    mesh = _fake_mesh(("data", "model"), (2, 2), 0)
    got = train.mesh_bytes(cfg, mesh, SEQ, BATCH)
    shapes = api.init_shapes(cfg)
    want = shard_bytes(mesh, shapes, api.param_specs(cfg, mesh))
    assert got["param_bytes"] == want == got["grad_bytes"]
    assert got["opt_bytes"] == 2 * want + adamw_init(shapes)["step"] \
        .element_size()
