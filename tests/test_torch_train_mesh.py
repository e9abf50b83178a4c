"""The sharded train step on the port's live mesh, on the CPU: four
`torch.distributed` ranks over ``gloo`` (started once for the file,
`launch.ranks.keep_ranks`) run `runtime.grad_step` and `optim.adamw_update`
on their blocks of the reference's `param_specs`, held against the JAX
reference's one-device ``value_and_grad(train_loss)`` and `adamw_update`
on the same numpy-seeded params (`params_from_numpy`) and the reference's
`SyntheticLMData` batches, at float32 and 1e-4 relative to each leaf's
max |value|.

* olmo-1b smoke, remat on and off, on ``(data=2, model=2)``, ``(data=1,
  model=4)``, ``(data=4, model=1)`` and ``(pod=2, data=2, model=1)`` (a
  sum over an axis missing or doubled shows on one of them): per step the
  loss, the grad norm and every rank's gradient block of every leaf (the
  reference's gradients cut by the specs), then the params, ``m`` and
  ``v`` blocks after 2 steps;
* on ``(data=2, model=2)`` also deepseek-moe-16b smoke (router auxiliary
  included), once at a capacity factor of 0.5 (tokens drop), ``grad_accum
  = 2`` against the reference's accumulation (per-microbatch gradients
  summed in float32 and averaged), and internvl2-2b smoke with
  ``frontend_embed`` (the loss mask of the frontend rows);
* every rank's replicated blocks bitwise equal to the other holders' after
  every step, its resident params, moments and gradients equal to
  `launch.dryrun.per_device_bytes`, the reduce-scatter counted;
* each differentiable collective's backward its forward's adjoint (the
  dot-product test at float64, summed over the ranks);
* ``python -m repro_torch.launch.train --smoke --mesh ... --device cpu``
  to done with its own gates (olmo-1b; deepseek-moe-16b held on the
  steps before its routes first differ from one process's), and its
  refusals; `Trainer.run`'s per-step callback; the one-device step and
  loss unchanged.  The `cuda`-marked twin runs ``train --mesh`` on the
  card and skips without one."""
import concurrent.futures
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLMData as RefSyntheticLMData  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.ranks import keep_ranks, run_ranks  # noqa: E402
from repro_torch.models import build_model, layers, transformer  # noqa: E402
from repro_torch.optim import AdamWConfig, value_and_grad  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig, grad_step  # noqa: E402
from repro_torch.testing import multidevice  # noqa: E402
from repro_torch.tree import at_path, flatten_with_paths  # noqa: E402
from test_torch_moe_mesh import _np_params  # noqa: E402
from test_torch_multidevice import _fake_mesh, _np_slice  # noqa: E402

MESHES = {"data2_model2": (("data", "model"), (2, 2)),
          "data1_model4": (("data", "model"), (1, 4)),
          "data4_model1": (("data", "model"), (4, 1)),
          "pod2_data2_model1": (("pod", "data", "model"), (2, 2, 1))}
BATCH, SEQ, STEPS = 4, 32, 2            # two loss chunks of 16 a row
TOL = 1e-4
LIMIT_S = 240.0          # the launcher's limit on a mesh's cases
# the launcher's AdamW (`launch.train`): every step inside the warmup
OPT = dict(lr=3e-4, warmup_steps=20, total_steps=STEPS)
# (arch, config fields): the olmo-1b cases run on every mesh, the rest on
# (data=2, model=2)
CASES = {"olmo_remat": ("olmo-1b", dict(remat=True)),
         "olmo_no_remat": ("olmo-1b", dict(remat=False)),
         "moe": ("deepseek-moe-16b", {}),
         "moe_drops": ("deepseek-moe-16b", dict(capacity_factor=0.5)),
         "olmo_accum2": ("olmo-1b", dict(grad_accum=2)),
         "vlm_frontend": ("internvl2-2b", {})}
EVERY_MESH = ("olmo_remat", "olmo_no_remat")
PAIRS = [(m, c) for m in MESHES for c in CASES
         if c in EVERY_MESH or m == "data2_model2"]


def _cfgs(case: str):
    arch, fields = CASES[case]
    fields = dict(compute_dtype="float32", **fields)
    return (dataclasses.replace(ref_get_smoke(arch), **fields),
            dataclasses.replace(get_smoke(arch), **fields))


def _batches(cfg) -> list:
    """The reference stream's first `STEPS` batches; a frontend model's
    carry ``frontend_embed`` rows (numpy-seeded, float32)."""
    data = RefSyntheticLMData(RefDataConfig(vocab_size=cfg.vocab_size,
                                            seq_len=SEQ, global_batch=BATCH))
    rng = np.random.default_rng(7)
    out = []
    for step in range(STEPS):
        batch = {"tokens": np.asarray(data.batch_at(step)["tokens"])}
        if cfg.frontend:
            n = min(cfg.n_frontend_tokens, SEQ)
            batch["frontend_embed"] = rng.standard_normal(
                (BATCH, n, cfg.frontend_dim)).astype(np.float32)
        out.append(batch)
    return out


def _flat(tree) -> dict:
    return {"/".join(map(str, p)): np.asarray(v)
            for p, v in flatten_with_paths(tree)}


@functools.lru_cache(maxsize=None)
def _inputs(case: str) -> dict:
    """The case's port config, params (numpy) and batches."""
    ref_cfg, cfg = _cfgs(case)
    return {"cfg": cfg, "params_np": _np_params(ref_cfg, 0),
            "batches": _batches(cfg)}


def _reference(case: str) -> dict:
    """The reference's run of the case: per step the loss, grad norm and
    gradients, then the params and moments after the last step.  With
    ``grad_accum`` > 1 each microbatch's gradients are taken alone,
    summed in float32 and averaged, as the reference's dry-run step
    does."""
    ref_cfg, _ = _cfgs(case)
    params_np, batches = _inputs(case)["params_np"], _inputs(case)["batches"]
    vg = jax.jit(jax.value_and_grad(ref_build_model(ref_cfg).train_loss))
    opt_cfg = ref_adamw.AdamWConfig(**OPT)
    params = jax.tree.map(jnp.asarray, params_np)
    opt = ref_adamw.adamw_init(params)
    out = {"loss": [], "grad_norm": [], "grads": []}
    accum = ref_cfg.grad_accum
    for batch in batches:
        mbs = [{k: jnp.asarray(v.reshape(accum, -1, *v.shape[1:])[i])
                for k, v in batch.items()} for i in range(accum)]
        loss, grads = vg(params, mbs[0])
        if accum > 1:
            grads = jax.tree.map(lambda g: g.astype(jnp.float32), grads)
            for mb in mbs[1:]:
                mloss, g = vg(params, mb)
                grads = jax.tree.map(lambda a, b: a + b.astype(jnp.float32),
                                     grads, g)
                loss = loss + mloss
            grads = jax.tree.map(lambda g: g / accum, grads)
            loss = loss / accum
        params, opt, metrics = ref_adamw.adamw_update(opt_cfg, params, grads,
                                                      opt)
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["grads"].append(_flat(grads))
    out["state"] = _flat({"params": params, "m": opt["m"], "v": opt["v"]})
    return out


@pytest.fixture(scope="module")
def refs():
    """The reference's runs of every case, taken in a thread while the
    ranks run theirs."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        futures = {c: pool.submit(_reference, c) for c in CASES}
        yield lambda case: futures[case].result()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, refs):
    """Every mesh's ranks' results of its cases (one `train_cases` call a
    mesh), on four rank processes kept for the file."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    cache: dict = {}

    def run(mesh_name: str) -> list:
        if mesh_name not in cache:
            axes, sizes = MESHES[mesh_name]
            cases = [c for m, c in PAIRS if m == mesh_name]
            args = [{**_inputs(c), "opt": AdamWConfig(**OPT)}
                    for c in cases]
            got = run_ranks(multidevice.train_cases, math.prod(sizes),
                            init_method=f"file://{tmp}/{mesh_name}",
                            args=(axes, sizes, args), timeout_s=LIMIT_S)
            cache[mesh_name] = {c: [r[i] for r in got]
                                for i, c in enumerate(cases)}
        return cache[mesh_name]
    with keep_ranks(4):
        yield run


def _specs(case: str, mesh_name: str) -> dict:
    axes, sizes = MESHES[mesh_name]
    return transformer.param_specs(_inputs(case)["cfg"],
                                   _fake_mesh(axes, sizes, 0))


def _close_blocks(ranks, want: dict, spec_of, sizes: dict, what: str):
    """Every rank's block of every leaf within `TOL` of the reference
    leaf's block, relative to the reference leaf's max |value|."""
    for r in ranks:
        got = r[what] if isinstance(what, str) else what(r)
        assert sorted(got) == sorted(want)
        for key, whole in want.items():
            block = _np_slice(whole, r["coord"], sizes, spec_of(key))
            scale = max(float(np.abs(whole).max()), 1e-30)
            err = float(np.abs(got[key] - block).max()) / scale
            assert err <= TOL, (key, r["coord"], err)


@pytest.mark.parametrize("mesh_name,case", PAIRS)
def test_mesh_step_matches_reference(runs, refs, mesh_name, case):
    ranks = runs(mesh_name)[case]
    ref = refs(case)
    specs = _specs(case, mesh_name)
    sizes = dict(zip(*MESHES[mesh_name]))
    for step in range(STEPS):
        for r in ranks:
            for got, want in ((r["loss"][step], ref["loss"][step]),
                              (r["grad_norm"][step],
                               ref["grad_norm"][step])):
                assert abs(got - want) <= TOL * abs(want), (step, got, want)
        _close_blocks(ranks, ref["grads"][step],
                      lambda k: at_path(specs, tuple(k.split("/"))), sizes,
                      lambda r, s=step: r["grads"][s])
    _close_blocks(ranks, ref["state"],
                  lambda k: at_path(specs, tuple(k.split("/"))[1:]), sizes,
                  "state")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_replicated_blocks_bitwise_and_resident_bytes(runs, mesh_name):
    """After every step each rank's replicated params, moments and
    gradients equal the other holders' bit for bit (checked in the ranks,
    and here on the blocks they returned); its resident bytes equal
    `per_device_bytes`; every step reduce-scatters."""
    axes, _ = MESHES[mesh_name]
    for case, ranks in runs(mesh_name).items():
        specs = _specs(case, mesh_name)
        for r in ranks:
            assert all(r["replicas_equal"]) and len(r["replicas_equal"]) \
                == STEPS
            assert r["resident_bytes"] == r["shard_bytes"], case
        for trees, drop in (([r["state"] for r in ranks], 1),
                            ([r["grads"][-1] for r in ranks], 0)):
            for key in trees[0]:
                spec = at_path(specs, tuple(key.split("/"))[drop:])
                named = {a for d in spec for a in
                         ((d,) if isinstance(d, str) else d or ())}
                held: dict = {}
                for r, tree in zip(ranks, trees):
                    block = tuple(r["coord"][a] for a in axes if a in named)
                    if block in held:
                        assert np.array_equal(held[block], tree[key]), key
                    held[block] = tree[key]
    # the tied embedding is gathered over every axis for the loss
    assert all(r["collectives"]["reduce_scatter"]["ops"]
               for c in runs(mesh_name).values() for r in c)


ADJOINT_CASES = ("gather_data", "gather_all", "gather_tree_two_cuts",
                 "all_reduce_model", "cols_gather", "cols_cut", "embed_rows")


@pytest.fixture(scope="module")
def adjoints(runs, tmp_path_factory):
    """`multidevice.adjoint_cases` on ``(data=2, model=2)`` (the kept
    ranks of `runs`)."""
    tmp = tmp_path_factory.mktemp("adjoint")
    return run_ranks(multidevice.adjoint_cases, 4,
                     init_method=f"file://{tmp}/rendezvous",
                     args=MESHES["data2_model2"], timeout_s=LIMIT_S)


@pytest.mark.parametrize("case", ADJOINT_CASES)
def test_collective_backward_is_its_adjoint(adjoints, case):
    """Summed over the ranks, ``<f(x), dy> == <x, grad>`` at float64: the
    backward autograd runs is the forward's transpose (a gather's one
    reduce-scatter a cut, a sum's the same sum, a cut's the zero-padded
    block)."""
    fwd = sum(r[case][0] for r in adjoints)
    back = sum(r[case][1] for r in adjoints)
    # `embed_rows` looks the rows up in float32, as it serves them
    tol = 1e-6 if case == "embed_rows" else 1e-12
    assert abs(fwd - back) <= tol * max(1.0, abs(fwd)), (fwd, back)
    kinds = adjoints[0][case][2]
    if case.startswith("gather"):
        want = 2 if case == "gather_tree_two_cuts" else 1
        assert kinds["reduce_scatter"]["ops"] == want, kinds


def test_launch_train_mesh_runs_to_done_with_its_gates(runs, tmp_path,
                                                        capsys):
    """``train --mesh`` of the smoke config (bf16 compute) on the CPU:
    `run_mesh` raises where a gate fails, so a report is a pass."""
    rep = train.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--mesh", "data=2,model=2",
                      "--dist-init", f"file://{tmp_path}/rendezvous"])["mesh"]
    assert rep["mesh"] == {"data": 2, "model": 2} and rep["steps"] == 2
    assert rep["held_steps"] == 2 and rep["routing_agreement"] == [None] * 2
    assert rep["replicas_equal"] and rep["bytes_equal"]
    assert max(rep["state_rel_err"].values()) <= rep["parity_tol"] == 2e-2
    assert all(not any(r["kernel_launches"].values()) for r in rep["ranks"])
    assert all(r["collectives"][-1]["reduce_scatter"]["ops"]
               for r in rep["ranks"])
    assert "[train/mesh] olmo-1b-smoke on" in capsys.readouterr().out


def test_launch_train_mesh_moe_holds_the_steps_its_routes_agree_on(
        runs, tmp_path, capsys):
    """``train --mesh`` of the MoE smoke config (bf16 compute): the steps
    before the ranks' routes first differ from one process's are held at
    2e-2 (the first always: both start from the same params), every rank
    routes as rank 0 does, and the routing agreement of each step is
    reported."""
    rep = train.main(["--arch", "deepseek-moe-16b", "--smoke", "--device",
                      "cpu", "--steps", "2", "--mesh", "data=2,model=2",
                      "--dist-init", f"file://{tmp_path}/rendezvous"]
                     )["mesh"]
    agree = rep["routing_agreement"]
    assert len(agree) == 2 and agree[0] == 1.0 and rep["routes_alike"]
    assert rep["held_steps"] == next(
        (i for i, a in enumerate(agree) if a < 1.0), 2)
    assert max(rep["state_rel_err"].values()) <= rep["parity_tol"] == 2e-2
    assert rep["loss_rel_err"] <= 2e-2 and rep["grad_norm_rel_err"] <= 2e-2
    assert rep["replicas_equal"] and rep["bytes_equal"]
    assert "routing agreement with one process a step" in \
        capsys.readouterr().out


@pytest.mark.parametrize("arch,want", [("olmo-1b", [3]),
                                       ("deepseek-moe-16b", [1, 2, 3]),
                                       ("internvl2-2b", [3])])
def test_compared_steps(arch, want):
    """The one-process states a mesh run compares against: every step's
    for the routed family, the last one's else."""
    assert train.compared_steps(get_smoke(arch), 3) == want


def test_trainer_calls_on_step_after_each_logged_step():
    """`Trainer.run`'s ``on_step`` sees each step once, after its log
    entry and with the step's params in place."""
    w0 = torch.ones(3)
    seen = []

    class Data:
        def batch_at(self, step):
            return {"x": torch.full((3,), float(step + 1))}
    tr = Trainer(loss_fn=lambda p, b: (p["w"] * b["x"]).sum(),
                 params={"w": w0}, data=Data(),
                 cfg=TrainerConfig(total_steps=3, checkpoint_every=0,
                                   log_every=1))
    tr.run(on_step=lambda step: seen.append(
        (step, len(tr.metrics_log), tr.params["w"].clone())))
    assert [s for s, _, _ in seen] == [1, 2, 3]
    assert [n for _, n, _ in seen] == [1, 2, 3]
    assert not torch.equal(seen[0][2], w0) and torch.equal(
        seen[-1][2], tr.params["w"])


@pytest.mark.parametrize("extra,match", [
    (["--resume"], "--resume"),
    (["--grad-compression"], "--grad-compression"),
    (["--arch", "rwkv6-3b"], "rwkv6-3b-smoke is ssm"),
    (["--arch", "zamba2-1.2b"], "zamba2-1.2b-smoke is hybrid"),
    (None, "--dist-init")])
def test_launch_train_mesh_refuses(tmp_path, extra, match):
    argv = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps",
            "1", "--mesh", "data=2,model=2"]
    if extra is not None:
        argv += extra + ["--dist-init", f"file://{tmp_path}/r"]
    with pytest.raises(ValueError, match=match):
        train.main(argv)


def test_trainer_on_a_mesh_takes_no_checkpoint():
    with pytest.raises(ValueError, match="checkpoint"):
        Trainer(loss_fn=None, params={"w": torch.zeros(2)}, data=None,
                mesh=_fake_mesh(("data",), (2,), 0))


def test_one_device_step_and_loss_unchanged():
    """Without a mesh `grad_step` of one microbatch is `value_and_grad`
    bit for bit, and a `denom` of the kept tokens leaves the loss as it
    was."""
    cfg = get_smoke("olmo-1b")
    bundle = build_model(cfg, "cpu")
    params = bundle.init(0)
    batch = {"tokens": torch.tensor(_batches(cfg)[0]["tokens"])}
    want = value_and_grad(bundle.train_loss, params, batch)
    got = grad_step(bundle.train_loss, params, batch)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_paths(got[1]), flatten_with_paths(want[1])))
    gen = torch.Generator().manual_seed(0)
    x, emb = torch.randn(2, 8, 4, generator=gen), torch.randn(
        16, 4, generator=gen)
    labels, mask = layers.causal_lm_labels(
        torch.randint(0, 16, (2, 8), generator=gen))
    plain = layers.chunked_cross_entropy(x, emb, labels, chunk=4, mask=mask)
    kept = layers.chunked_cross_entropy(x, emb, labels, chunk=4, mask=mask,
                                        denom=mask.sum())
    assert torch.equal(plain, kept)


@pytest.mark.cuda
def test_launch_train_mesh_on_the_card(tmp_path):
    """``train --mesh`` of the smoke config with its four ranks on the
    card, against one process on the card, with its own gates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    rep = train.main(["--arch", "olmo-1b", "--smoke", "--steps", "2",
                      "--mesh", "data=2,model=2", "--dist-init",
                      f"file://{tmp_path}/rendezvous"])["mesh"]
    assert rep["device"].startswith("cuda") and rep["bytes_equal"]
