"""The sharded checkpoint of the mesh's trainer, on the CPU: four
`torch.distributed` ranks over ``gloo`` (kept for the file) each write
their own blocks of the state (a replicated block once), rank 0 commits
the manifest, and restore rebuilds each rank's blocks from the saved
blocks that overlap them, on any mesh or as whole leaves — the
reference's ``restore_checkpoint(..., shardings=)`` reshard-on-load
(`tests/test_substrate.py` ``test_checkpoint_reshard_on_load``).  The
smoke rwkv6-3b at float32 trains on ``(data=2, model=2)``:

* interrupted at step 2 and resumed to 4 equals the uninterrupted 4
  steps bit for bit (the reference's ``test_trainer_resume_bit_exact``),
  and matches the JAX reference's `repro.runtime.Trainer`'s 4
  uninterrupted steps at 1e-4;
* the step-2 checkpoint restores bit for bit onto ``(data=1, model=4)``
  and as whole leaves, a one-process checkpoint onto the mesh, and so
  does the reference `Trainer`'s own whole-leaf checkpoint; the manifest
  holds every block once with its CRC;
* a rank that raises before the commit leaves no committed step; a
  corrupted block fails `verify_checkpoint`, the restore and a resumed
  run (on every rank: none starts from step 0);
* ``preempted`` set on one rank stops every rank at the same step, which
  they commit together;
* ``train --mesh --ckpt-every 1`` then ``--resume`` to done with the
  launcher's own gates."""
import concurrent.futures
import dataclasses
import functools
import json
import math
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (complete_steps, latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint,
                                    verify_checkpoint)
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.ranks import (RankError, keep_ranks,  # noqa: E402
                                      run_ranks)
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import (Trainer, TrainerConfig,  # noqa: E402
                                 state_specs)
from repro_torch.testing import multidevice  # noqa: E402
from repro_torch.tree import at_path, flatten_with_paths  # noqa: E402
from test_torch_multidevice import _fake_mesh, _np_slice  # noqa: E402

MESH = (("data", "model"), (2, 2))
OTHER = (("data", "model"), (1, 4))
BATCH, SEQ, STEPS = 4, 32, 4
OPT = AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=STEPS)
LIMIT_S = 240.0
CFG = dataclasses.replace(get_smoke("rwkv6-3b"), compute_dtype="float32")
TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _params_np() -> dict:
    """Seed-0 params of the port's init, as numpy."""
    from repro_torch.models import build_model
    from repro_torch.models.convert import tree_to_numpy
    return tree_to_numpy(build_model(CFG, "cpu").init(0))


def _case(**kw) -> dict:
    return {"cfg": CFG, "params_np": _params_np(), "opt": OPT,
            "steps": STEPS, "batch": BATCH, "seq": SEQ, **kw}


def _ref_flat(state: dict) -> dict:
    """The reference trainer's ``{"params", "opt"}`` as numpy, keyed as
    the rank functions key the state."""
    flat = {"params": state["params"], "m": state["opt"]["m"],
            "v": state["opt"]["v"]}
    return {"/".join(map(str, p)): np.asarray(v)
            for p, v in flatten_with_paths(flat)}


def _reference(root: str) -> dict:
    """The JAX reference `Trainer`'s 4 uninterrupted steps of the same
    params, stream and AdamW, checkpointing every 2 steps into ``root``
    (its own whole-leaf format): per step the loss and grad norm, its
    final state, and its step-2 checkpoint read back by the reference's
    own `restore_checkpoint`."""
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import restore_checkpoint as ref_restore
    from repro.configs import get_smoke as ref_get_smoke
    from repro.data import DataConfig as RefDataConfig
    from repro.data import SyntheticLMData as RefSyntheticLMData
    from repro.models import build_model as ref_build_model
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.runtime import Trainer as RefTrainer
    from repro.runtime import TrainerConfig as RefTrainerConfig
    ref_cfg = dataclasses.replace(ref_get_smoke("rwkv6-3b"),
                                  compute_dtype="float32")
    data = RefSyntheticLMData(RefDataConfig(vocab_size=ref_cfg.vocab_size,
                                            seq_len=SEQ, global_batch=BATCH))
    tr = RefTrainer(loss_fn=ref_build_model(ref_cfg).train_loss,
                    params=jax.tree.map(jnp.asarray, _params_np()),
                    data=data, opt_cfg=RefAdamWConfig(
                        lr=OPT.lr, warmup_steps=OPT.warmup_steps,
                        total_steps=STEPS),
                    cfg=RefTrainerConfig(total_steps=STEPS,
                                         checkpoint_every=2,
                                         checkpoint_dir=root, log_every=1))
    assert tr.run()["status"] == "done"
    step2, _ = ref_restore(root, 2, tr._state())
    return {"loss": [m["loss"] for m in tr.metrics_log],
            "grad_norm": [m["grad_norm"] for m in tr.metrics_log],
            "state": _ref_flat(tr._state()), "root": root,
            "step2": _ref_flat(step2)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run, taken in a thread while the ranks run
    theirs (imported here, so that the file's ``cuda`` tests collect
    where JAX is not installed)."""
    pytest.importorskip("jax")
    root = str(tmp_path_factory.mktemp("ref_ckpt"))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(_reference, root)
        yield future.result


@pytest.fixture(scope="module")
def ranks4():
    with keep_ranks(4):
        yield


@pytest.fixture(scope="module")
def trained(reference, ranks4, tmp_path_factory):
    """One `trainer_cases` call on ``(data=2, model=2)``: the
    uninterrupted run, the run interrupted at step 2 (checkpoints every
    2 steps), its resumption to step 4, and a run preempted on rank 1."""
    tmp = tmp_path_factory.mktemp("mesh_ckpt")
    dirs = {k: str(tmp / k) for k in ("cut", "preempt")}
    cases = [_case(),
             _case(steps=2, ckpt_dir=dirs["cut"], ckpt_every=2),
             _case(ckpt_dir=dirs["cut"], ckpt_every=2, resume=True),
             _case(steps=6, ckpt_dir=dirs["preempt"], ckpt_every=100,
                   preempt=(1, 2))]
    got = run_ranks(multidevice.trainer_cases, 4,
                    init_method=f"file://{tmp}/rendezvous",
                    args=(*MESH, cases), timeout_s=LIMIT_S)
    names = ("whole", "cut", "resumed", "preempted")
    return {"dirs": dirs, "tmp": tmp,
            **{n: [r[i] for r in got] for i, n in enumerate(names)}}


def _whole_state(root, step: int) -> dict:
    """A trainer state's checkpoint restored as whole leaves."""
    shapes = api.init_shapes(CFG)
    like = {"params": _zeros(shapes), "opt": {
        "m": _zeros(shapes), "v": _zeros(shapes),
        "step": torch.zeros((), dtype=torch.int32)}}
    return restore_checkpoint(root, step, like, device="cpu")[0]


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _specs(axes_sizes) -> dict:
    return state_specs(api.param_specs(CFG, _fake_mesh(*axes_sizes, 0)))


def _as_state_keys(tree: dict) -> dict:
    """``{"params", "opt": {"m", "v", ...}}`` flattened to the keys the
    rank functions return (``params/...``, ``m/...``, ``v/...``)."""
    flat = {"params": tree["params"], "m": tree["opt"]["m"],
            "v": tree["opt"]["v"]}
    return {"/".join(map(str, p)): t.numpy()
            for p, t in flatten_with_paths(flat)}


def test_mesh_resume_is_bit_exact(trained):
    """Interrupted at step 2 and resumed to 4 equals the uninterrupted
    run bit for bit: params, moments, and the losses of steps 3-4."""
    for whole, cut, res in zip(trained["whole"], trained["cut"],
                               trained["resumed"]):
        assert cut["result"]["status"] == "done" and cut["steps"] == [1, 2]
        assert res["resumed"] and res["start"] == 2 and res["steps"] == [3, 4]
        assert res["loss"] == whole["loss"][2:]
        assert res["grad_norm"] == whole["grad_norm"][2:]
        assert res["checkpoints"]["restored"]["step"] == 2
        for key, bits in whole["state"].items():
            assert np.array_equal(bits, res["state"][key]), key
    assert complete_steps(trained["dirs"]["cut"]) == [2, 4]


def test_mesh_resume_matches_the_reference_trainer(trained, reference):
    """The mesh run interrupted at step 2 and resumed to 4 is held against
    the JAX reference `Trainer`'s 4 uninterrupted steps: the losses and
    grad norms of every step at 1e-4 relative, and each rank's params,
    ``m`` and ``v`` blocks after step 4 against the reference's whole
    leaves cut by the specs, at 1e-4 of each leaf's max |value|."""
    ref = reference()
    specs = _specs(MESH)
    sizes = dict(zip(*MESH))
    for cut, res in zip(trained["cut"], trained["resumed"]):
        for got, want in zip(cut["loss"] + res["loss"]
                             + cut["grad_norm"] + res["grad_norm"],
                             ref["loss"][:2] + ref["loss"][2:]
                             + ref["grad_norm"][:2] + ref["grad_norm"][2:]):
            assert abs(got - want) <= TOL * abs(want), (got, want)
        assert sorted(res["state"]) == sorted(ref["state"])
        for key, whole in ref["state"].items():
            block = _np_slice(whole, res["coord"], sizes,
                              at_path(specs, _spec_path(key)))
            scale = max(float(np.abs(whole).max()), 1e-30)
            err = float(np.abs(res["state"][key] - block).max()) / scale
            assert err <= TOL, (key, res["coord"], err)


def test_mesh_checkpoint_writes_each_block_once(trained):
    """The manifest records the mesh and, per leaf, its whole shape, its
    spec and every block once with its CRC; a rank writes only the
    blocks it is the writer of (index 0 along the replicated axes), and
    a save's collectives are its barriers and one gather of the
    records."""
    d = trained["dirs"]["cut"]
    assert verify_checkpoint(d, 2) == []
    manifest = json.loads((trained["tmp"] / "cut" / "step_00000002"
                           / "manifest.json").read_text())
    assert manifest["mesh"] == {"axis_names": ["data", "model"],
                                "axis_sizes": [2, 2]}
    specs = _specs(MESH)
    files = set()
    for key, meta in manifest["leaves"].items():
        spec = at_path(specs, tuple(key.split("::")))
        n = math.prod(shd._axes_size(_fake_mesh(*MESH, 0), d) for d in spec)
        assert len(meta["blocks"]) == n, key
        assert [list(d) if isinstance(d, tuple) else d for d in spec] \
            == meta["spec"]
        files |= {b["file"] for b in meta["blocks"]}
    on_disk = {p.name for p in (trained["tmp"] / "cut"
                                / "step_00000002").glob("*.npy")}
    assert files == on_disk
    saves = [r["checkpoints"]["saves"] for r in trained["cut"]]
    assert sum(s[-1]["files"] for s in saves) == len(files)
    for s in saves:
        assert [c["step"] for c in s] == [2]
        assert s[0]["collectives"]["barrier"]["ops"] == 2
        assert s[0]["collectives"]["all_gather_object"]["ops"] == 1


def test_mesh_checkpoint_restores_as_whole_leaves(trained):
    """The step-2 checkpoint of ``(data=2, model=2)`` restored as whole
    leaves in one process, cut by the specs, equals every rank's blocks
    after step 2 bit for bit."""
    want = _as_state_keys(_whole_state(trained["dirs"]["cut"], 2))
    sizes = dict(zip(*MESH))
    specs = _specs(MESH)
    for r in trained["cut"]:
        for key, bits in r["state"].items():
            spec = at_path(specs, _spec_path(key))
            assert np.array_equal(_np_slice(want[key], r["coord"], sizes,
                                            spec), bits), key


def _spec_path(key: str) -> tuple:
    head, *rest = key.split("/")
    return (("params",) if head == "params" else ("opt", head)) + tuple(rest)


@pytest.fixture(scope="module")
def reshard(trained, reference, tmp_path_factory):
    """The step-2 checkpoint of ``(data=2, model=2)`` restored onto
    ``(data=1, model=4)``, a one-process checkpoint of the same state
    restored onto ``(data=2, model=2)``, and the reference `Trainer`'s
    step-2 checkpoint (its own whole-leaf format) restored onto
    ``(data=2, model=2)``, each with the whole state it must give."""
    tmp = tmp_path_factory.mktemp("reshard")
    whole = _whole_state(trained["dirs"]["cut"], 2)
    save_checkpoint(tmp / "one", 2, whole)
    other = run_ranks(multidevice.restore_case, 4,
                      init_method=f"file://{tmp}/r1",
                      args=(*OTHER, CFG, trained["dirs"]["cut"], 2),
                      timeout_s=LIMIT_S)
    onto = run_ranks(multidevice.restore_case, 4,
                     init_method=f"file://{tmp}/r2",
                     args=(*MESH, CFG, str(tmp / "one"), 2),
                     timeout_s=LIMIT_S)
    ref = reference()
    from_ref = run_ranks(multidevice.restore_case, 4,
                         init_method=f"file://{tmp}/r3",
                         args=(*MESH, CFG, ref["root"], 2),
                         timeout_s=LIMIT_S)
    want = _as_state_keys(whole)
    return {"want": want, "other": (other, want), "onto": (onto, want),
            "reference": (from_ref, ref["step2"])}


@pytest.mark.parametrize("which,axes_sizes", [("other", OTHER),
                                              ("onto", MESH),
                                              ("reference", MESH)])
def test_mesh_checkpoint_restores_onto_another_layout(reshard, which,
                                                      axes_sizes):
    """Each rank's restored blocks equal the whole state cut by the
    restoring mesh's specs, bit for bit: a mesh checkpoint onto another
    mesh shape, a one-process checkpoint onto the mesh, and the JAX
    reference `Trainer`'s whole-leaf checkpoint onto the mesh (against
    the state the reference's own restore reads from it)."""
    sizes = dict(zip(*axes_sizes))
    specs = _specs(axes_sizes)
    ranks, want = reshard[which]
    for r in ranks:
        assert "error" not in r, r.get("error")
        assert sorted(r["state"]) == sorted(want)
        for key, bits in r["state"].items():
            spec = at_path(specs, _spec_path(key))
            assert np.array_equal(_np_slice(want[key], r["coord"], sizes,
                                            spec), bits), (which, key)


@pytest.mark.parametrize("axes_sizes", [MESH, OTHER,
                                        (("data", "model"), (4, 1)),
                                        (("pod", "data", "model"),
                                         (2, 2, 1))])
def test_restore_builds_each_block_from_the_overlapping_ones(trained,
                                                             axes_sizes):
    """`restore_checkpoint` with a mesh (no collective: its coordinates
    only) reads, for each of a rank's blocks, the saved blocks that
    overlap it: every rank of every layout gets the whole leaf's block,
    and on the saving mesh a rank reads only its own blocks."""
    root = trained["dirs"]["cut"]
    want = _as_state_keys(_whole_state(root, 2))
    sizes = dict(zip(*axes_sizes))
    specs = _specs(axes_sizes)
    whole = _whole_state(root, 2)
    for rank in range(math.prod(axes_sizes[1])):
        mesh = _fake_mesh(*axes_sizes, rank)
        like = multidevice._placed_like(whole, mesh, specs)
        stats: dict = {}
        tree, _ = restore_checkpoint(root, 2, like, mesh=mesh, specs=specs,
                                     stats=stats)
        got = _as_state_keys(tree)
        for key, arr in got.items():
            spec = at_path(specs, _spec_path(key))
            assert np.array_equal(arr, _np_slice(want[key], mesh.coord(),
                                                 sizes, spec)), key
        if axes_sizes == MESH:
            mine = sum(a.nbytes for a in got.values()) \
                + tree["opt"]["step"].element_size()
            assert stats["bytes"] == mine


def test_rank_dying_before_the_commit_leaves_no_step(reshard, tmp_path):
    """Every rank writes its blocks into the step's ``.tmp`` directory,
    then rank 1 raises before the commit: the launcher ends every rank,
    and no step is committed (the ``.tmp`` residue is not listed)."""
    root = tmp_path / "ckpt"
    # the launcher reports the first rank it sees fail: rank 1, or one
    # whose commit's gather lost rank 1 (gloo's wording of the lost
    # connection varies)
    with pytest.raises(RankError,
                       match="dies before the commit|in commit_blocks"):
        run_ranks(multidevice.partial_save, 4,
                  init_method=f"file://{tmp_path}/r",
                  args=(*MESH, CFG, str(root), 7, 1), timeout_s=LIMIT_S)
    assert (root / "step_00000007.tmp").is_dir()
    assert any((root / "step_00000007.tmp").glob("*.npy"))
    assert complete_steps(root) == [] and latest_step(root) is None


def test_corrupted_block_fails_verify_restore_and_resume(trained,
                                                         tmp_path):
    """One flipped byte in one block file: `verify_checkpoint` names the
    file, a whole restore raises, and a resumed mesh run fails on every
    rank instead of starting from step 0."""
    root = tmp_path / "ckpt"
    shutil.copytree(trained["dirs"]["cut"], root)
    shutil.rmtree(root / "step_00000004")
    d = root / "step_00000002"
    manifest = json.loads((d / "manifest.json").read_text())
    victim = manifest["leaves"]["params::blocks::wr"]["blocks"][1]["file"]
    raw = bytearray((d / victim).read_bytes())
    raw[-1] ^= 0xFF
    (d / victim).write_bytes(bytes(raw))
    problems = verify_checkpoint(root, 2)
    assert len(problems) == 1 and victim in problems[0] \
        and "CRC mismatch" in problems[0]
    with pytest.raises(IOError, match="CRC mismatch"):
        _whole_state(root, 2)
    with pytest.raises(RankError, match="no restorable checkpoint"):
        run_ranks(multidevice.trainer_cases, 4,
                  init_method=f"file://{tmp_path}/r",
                  args=(*MESH, [_case(ckpt_dir=str(root), ckpt_every=2,
                                      resume=True)]), timeout_s=LIMIT_S)


def test_preemption_on_one_rank_stops_every_rank(trained):
    """``preempted`` set on rank 1 alone (when step 3 starts) stops every
    rank at the next boundary, the same step on each, which they
    commit together; the flag costs one small ``all_reduce`` a step."""
    results = [r["result"] for r in trained["preempted"]]
    assert results == [{"status": "preempted", "step": 3}] * 4
    assert all(r["steps"] == [1, 2, 3] for r in trained["preempted"])
    assert latest_step(trained["dirs"]["preempt"]) == 3
    assert verify_checkpoint(trained["dirs"]["preempt"], 3) == []
    # the steps it took are the uninterrupted run's, bit for bit
    for r, whole in zip(trained["preempted"], trained["whole"]):
        assert r["loss"] == whole["loss"][:3]


def test_trainer_on_a_mesh_checkpoints_its_blocks():
    """A mesh's trainer takes a checkpoint manager on the mesh with the
    state's specs (the moments as the params, the step replicated)."""
    mesh = _fake_mesh(("data",), (2,), 0)
    specs = {"w": shd.P("data")}
    tr = Trainer(loss_fn=None, params={"w": torch.zeros(2)}, data=None,
                 cfg=TrainerConfig(checkpoint_every=1,
                                   checkpoint_dir="/nonexistent"),
                 mesh=mesh, specs=specs)
    assert tr._ckpt.mesh is mesh
    assert tr._ckpt.specs == {"params": specs, "opt": {
        "m": specs, "v": specs, "step": shd.P()}}


def test_launch_train_mesh_checkpoints_then_resumes(ranks4, tmp_path):
    """``train --mesh --ckpt-every 1 --steps 2``, then ``--resume --steps
    3`` from its directory: the second starts at step 2, takes one step
    and holds it against one process's uninterrupted 3 steps, with the
    launcher's own gates."""
    base = ["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
            "--compute-dtype", "float32", "--mesh", "data=2,model=2",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    first = train.main(base + ["--steps", "2", "--ckpt-every", "1",
                               "--dist-init", f"file://{tmp_path}/r1"]
                       )["mesh"]
    assert first["ran_steps"] == [1, 2] and first["start_step"] == 0
    assert complete_steps(tmp_path / "ckpt") == [1, 2]
    for r in first["ranks"]:
        assert [c["step"] for c in r["checkpoints"]["saves"]] == [1, 2]
    second = train.main(base + ["--steps", "3", "--resume",
                                "--dist-init", f"file://{tmp_path}/r2"]
                        )["mesh"]
    assert second["start_step"] == 2 and second["ran_steps"] == [3]
    assert second["held_step"] == 3
    assert max(second["state_rel_err"].values()) <= 1e-4
    assert all(r["checkpoints"]["restored"]["step"] == 2
               for r in second["ranks"])


@pytest.mark.cuda
def test_launch_train_mesh_checkpoint_on_the_card(tmp_path):
    """The mesh trainer with its four ranks on the card: two steps of
    the smoke rwkv6-3b checkpointing every step, the resumed third step
    held against one process on the card, and the step-2 checkpoint's
    round trip through the card's tensors (restored as whole leaves onto
    cuda, saved again by one process, restored onto the mesh's specs of
    ``(data=1, model=4)`` without ranks, bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    root = tmp_path / "ckpt"
    base = ["--arch", "rwkv6-3b", "--smoke", "--compute-dtype", "float32",
            "--mesh", "data=2,model=2", "--ckpt-dir", str(root)]
    first = train.main(base + ["--steps", "2", "--ckpt-every", "1",
                               "--dist-init", f"file://{tmp_path}/r1"]
                       )["mesh"]
    assert first["device"].startswith("cuda") and first["bytes_equal"]
    second = train.main(base + ["--steps", "3", "--resume",
                                "--dist-init", f"file://{tmp_path}/r2"]
                        )["mesh"]
    assert second["start_step"] == 2 and second["ran_steps"] == [3]
    shapes = api.init_shapes(CFG)
    like = {"params": _zeros(shapes), "opt": {
        "m": _zeros(shapes), "v": _zeros(shapes),
        "step": torch.zeros((), dtype=torch.int32)}}
    on_card, _ = restore_checkpoint(root, 2, like, device="cuda")
    assert on_card["params"]["embed"].is_cuda
    save_checkpoint(tmp_path / "one", 2, on_card)
    mesh = _fake_mesh(*OTHER, 1)
    specs = _specs(OTHER)
    like = multidevice._placed_like(on_card, mesh, specs)
    back, _ = restore_checkpoint(tmp_path / "one", 2, like, mesh=mesh,
                                 specs=specs)
    for (p, whole), (_, block) in zip(flatten_with_paths(on_card),
                                      flatten_with_paths(back)):
        assert torch.equal(shd.place(whole.cpu(), mesh, at_path(specs, p)),
                           block), p


@pytest.mark.cuda
def test_launch_train_mesh_compressed_on_the_card(tmp_path):
    """Two compressed steps of the smoke zamba2-1.2b with its four ranks
    on the card, against one process on the card that compresses too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rep = train.main(["--arch", "zamba2-1.2b", "--smoke", "--compute-dtype",
                      "float32", "--steps", "2", "--ckpt-every", "0",
                      "--grad-compression", "--mesh", "data=2,model=2",
                      "--dist-init", f"file://{tmp_path}/r"])["mesh"]
    assert rep["device"].startswith("cuda") and rep["replicas_equal"]
    assert rep["loss_rel_err"] <= 1e-4 and rep["grad_norm_rel_err"] <= 1e-4
