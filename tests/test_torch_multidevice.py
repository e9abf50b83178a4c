"""The port's live mesh on the CPU: four `torch.distributed` ranks over
``gloo``, spawned by `launch.ranks.run_ranks` with a ``file://``
rendezvous under ``tmp_path``, serving the olmo-1b smoke config's sharded
program (`models.transformer`) on ``(data=2, model=2)`` and ``(pod=2,
data=2, model=1)``.  Every rank's placed shards equal numpy slices of the
whole arrays by the reference's specs, bit for bit, with `shard_shape`'s
shapes; every gathered plan encoding equals the unsharded one, bit for
bit (the twin of the reference's ``test_sharded_plan_multidevice_subprocess``);
the sharded prefill's logits lie within 1e-4 of the JAX reference's
one-device prefill (float32, on the converted weights and plan, and on
the dense weights without a plan) and its greedy tokens equal the
reference's; `COLLECTIVES` over one prefill equals a count derived here
from the specs.  The launcher fails within its own limit when a rank
raises or hangs.  Without processes: `LiveMesh`'s coordinates, `place`
against numpy slicing and the plane moves `planes_of` / `rows_of` where no
rank needs a collective."""
import dataclasses
import functools
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models.api import merge_prefill_cache as ref_merge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import LiveMesh  # noqa: E402
from repro_torch.launch.ranks import RankError, run_ranks  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.testing import multidevice  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

MESHES = {"data2_model2": (("data", "model"), (2, 2)),
          "pod2_data2_model1": (("pod", "data", "model"), (2, 2, 1))}
PLAN_KW = dict(sparsity=0.5, impl="cuda", m_hint=16)
STEPS = 4
TOL = 1e-4
LIMIT_S = 240.0          # the launcher's limit on a mesh case


@functools.lru_cache(maxsize=None)
def _setup():
    """The JAX reference's smoke olmo-1b at f32 with its plan, its
    one-device prefill logits (with and without the plan) and greedy
    tokens; the same params as numpy, and the port's plan on them."""
    ref_cfg = dataclasses.replace(ref_get_smoke("olmo-1b"),
                                  compute_dtype="float32",
                                  sparse_serving=True)
    cfg = dataclasses.replace(get_smoke("olmo-1b"), compute_dtype="float32",
                              sparse_serving=True)
    ref_m = ref_build_model(ref_cfg)
    params_j = ref_m.init(jax.random.key(0))
    plan_j = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="pallas", m_hint=16)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    sparse_j = {**params_j, "sparse_plan": plan_j}
    batch = {"tokens": jnp.asarray(prompt)}
    want = {"logits": np.asarray(jax.jit(ref_m.prefill)(sparse_j, batch)[0]),
            "dense_logits": np.asarray(
                jax.jit(ref_m.prefill)(params_j, batch)[0]),
            "tokens": np.asarray(ref_serve.greedy_generate(
                ref_m, sparse_j, jnp.asarray(prompt), STEPS,
                prompt.shape[1] + STEPS))}
    params_np = jax.tree.map(np.asarray, params_j)
    whole = params_from_numpy(params_np, "cpu")
    plan = engine_plan.plan_transformer(cfg, whole, **PLAN_KW)
    return cfg, params_np, whole, plan, prompt, want


def _fake_mesh(names, sizes, rank: int) -> LiveMesh:
    """A live mesh's coordinates without process groups (enough for
    `place` and for collective-free plane moves)."""
    return LiveMesh(tuple(names), tuple(sizes), rank, torch.device("cpu"),
                    {})


def _np_slice(a: np.ndarray, coord: dict, sizes: dict, spec) -> np.ndarray:
    """The block of ``a`` at ``coord`` by ``spec``, by numpy slicing: a
    dim over a tuple of axes split first axis major."""
    idx = []
    for i, d in enumerate(spec):
        axes = shd.spec_axes(d)
        n = math.prod(sizes[x] for x in axes)
        j = 0
        for x in axes:
            j = j * sizes[x] + coord[x]
        size = a.shape[i] // n
        idx.append(slice(j * size, (j + 1) * size))
    return a[tuple(idx)]


def _bits(t) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _expected_collectives(cfg, plan, mesh_names, mesh_sizes, b: int,
                          s: int) -> dict:
    """One prefill's collectives on every rank, from the specs.

    * the embedding: one ``all_reduce`` of the f32 ``[B, s, d]`` rows when
      its spec splits it at all;
    * per layer, each planned projection's encoding gathered over the
      axes `plan_specs` split it on (one ``all_gather`` of every split
      leaf's shard);
    * per layer, q, k and v (whole columns: every projection is planned)
      gathered over the batch axes when some rank's cache planes
      (`cache_specs`) hold a row it does not; the attention output
      gathered over the plane axes when some rank's planes lack a head
      of one of its rows (``wo`` is planned and takes every head);
    * the logits: the last positions gathered over the batch axes, then
      one ``all_reduce`` of the f32 ``[B, V]`` partials.

    An MoE layer adds (one segment of S):

    * its unplanned weights (the router) gathered over the FSDP axes to
      their use specs (one ``all_gather`` of the split leaves' shards);
    * the normed rows gathered over the batch axes, so that every rank
      routes the whole batch;
    * the expert encodings gathered over the FSDP axes only (their
      expert axis stays over ``model``);
    * the experts' outputs gathered over the axes the dispatch buffer's
      block is split on (`transformer.dispatch_spec`)."""
    sizes = dict(zip(mesh_names, mesh_sizes))
    world = math.prod(mesh_sizes)
    meshes = [_fake_mesh(mesh_names, mesh_sizes, r) for r in range(world)]
    bax = shd.shard_batch(meshes[0], b) or ()
    pax = shd.spec_axes(transformer.cache_specs(cfg, meshes[0], b)["k"][1])
    kh, dh, d = cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    g = cfg.n_heads // kh
    gathers, reduces = [], []
    emb = transformer.param_specs(cfg, meshes[0])["embed"]
    if any(sizes[a] > 1 for dd in emb for a in shd.spec_axes(dd)):
        reduces.append(b * s * d * 4)
    specs = engine_plan.plan_specs(plan, meshes[0])
    fsdp = set(shd.fsdp_axes(meshes[0]))
    for nm, lp in plan.layers.items():
        leaf_specs = engine_plan.weight_leaves(specs.layers[nm].weights)
        gathered = fsdp if lp.spec.experts else set(sizes)
        nbytes = 0
        for leaf, t in engine_plan.weight_leaves(lp.layer(0).weights).items():
            spec = P(*list(leaf_specs[leaf])[1:])
            if any(sizes[a] > 1 for dd in spec for a in shd.spec_axes(dd)
                   if a in gathered):
                nbytes += math.prod(shd.shard_shape(
                    meshes[0], tuple(t.shape), spec)) * t.element_size()
        if nbytes:
            gathers.append(nbytes)
    bl = b // math.prod(sizes[a] for a in bax) if bax else b
    if cfg.family == "moe":
        cd = getattr(torch, cfg.compute_dtype).itemsize
        pspecs = transformer.param_specs(cfg, meshes[0])["blocks"]
        uspecs = transformer.use_specs(cfg, meshes[0])
        nbytes = 0
        for nm, t in transformer.init_shapes(cfg)["blocks"].items():
            placed = P(*list(pspecs[nm])[1:])
            kept = {a for dd in uspecs[nm] for a in shd.spec_axes(dd)}
            if nm not in plan.layers and any(
                    sizes[a] > 1 for dd in placed for a in shd.spec_axes(dd)
                    if a not in kept):
                nbytes += math.prod(shd.shard_shape(
                    meshes[0], tuple(t.shape[1:]), placed)) * cd
        if nbytes:
            gathers.append(nbytes)
        if bl < b:
            gathers.append(bl * s * d * cd)
        t = b * s
        cap = max(8, math.ceil(t * cfg.top_k / cfg.n_experts
                               * cfg.capacity_factor))
        block = shd.shard_shape(meshes[0], (cfg.n_experts, cap, d),
                                transformer.dispatch_spec(cfg, meshes[0],
                                                          cap))
        if math.prod(block) < cfg.n_experts * cap * d:
            gathers.append(math.prod(block) * cd)
    rows = [set(range(*_range(m, bax, b))) for m in meshes]
    planes = [set(range(*_range(m, pax, b * kh))) for m in meshes]
    n = b * kh // math.prod(sizes[a] for a in pax)
    if not all({p // kh for p in pl} <= rw for pl, rw in zip(planes, rows)):
        gathers += [bl * s * g * kh * dh * 4, bl * s * kh * dh * 4,
                    bl * s * kh * dh * 4]
    if not all({r * kh + h for r in rw for h in range(kh)} <= pl
               for pl, rw in zip(planes, rows)):
        gathers.append(n * s * g * dh * 4)
    layer = gathers[:]
    gathers = layer * cfg.n_layers
    if bl < b:
        gathers.append(bl * d * 4)
    if any(sizes[a] > 1 for dd in emb for a in shd.spec_axes(dd)):
        reduces.append(b * cfg.vocab_size * 4)
    return {"all_gather": {"ops": len(gathers), "bytes": sum(gathers)},
            "all_reduce": {"ops": len(reduces), "bytes": sum(reduces)}}


def _range(mesh, axes, extent):
    start, size = shd.block_of(mesh, axes, extent)
    return start, start + size


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_serve_on_live_ranks(mesh_name, tmp_path):
    names, sizes = MESHES[mesh_name]
    cfg, params_np, whole, plan, prompt, want = _setup()
    t0 = time.monotonic()
    res = run_ranks(multidevice.mesh_case, math.prod(sizes),
                    init_method=f"file://{tmp_path}/rendezvous",
                    args=(names, sizes, cfg, params_np, prompt, STEPS,
                          PLAN_KW), timeout_s=LIMIT_S)
    assert time.monotonic() - t0 < LIMIT_S
    size_of = dict(zip(names, sizes))
    m0 = _fake_mesh(names, sizes, 0)
    pspecs = transformer.param_specs(cfg, m0)
    specs = engine_plan.plan_specs(plan, m0)
    cspecs = transformer.cache_specs(cfg, m0, prompt.shape[0])
    derived = _expected_collectives(cfg, plan, names, sizes, *prompt.shape)
    whole_cache = res[0]["whole_cache"]
    for r in res:
        coord = r["coord"]
        # (a) every placed shard is numpy's slice of the whole, bit for bit
        for path, t in flatten_with_paths(whole):
            key = "/".join(path)
            spec = pspecs
            for p in path:
                spec = spec[p]
            want_shard = _np_slice(_bits(t), coord, size_of, spec)
            np.testing.assert_array_equal(r["params"][key], want_shard)
            assert r["params"][key].shape == r["shapes"][key]
        for nm, lp in plan.layers.items():
            leaf_specs = engine_plan.weight_leaves(specs.layers[nm].weights)
            for leaf, t in engine_plan.weight_leaves(lp.weights).items():
                key = f"{nm}/{leaf}"
                np.testing.assert_array_equal(
                    r["plan"][key],
                    _np_slice(_bits(t), coord, size_of, leaf_specs[leaf]))
                assert r["plan"][key].shape == r["shapes"][key]
        for k, v in r["cache_placed"].items():
            np.testing.assert_array_equal(
                v, _np_slice(whole_cache[k], coord, size_of, cspecs[k]))
        # the sharded prefill's own cache: this rank's planes of the
        # one-process cache (bf16 rows of f32 sums in another grouping)
        for k, v in r["cache"].items():
            np.testing.assert_allclose(
                torch.from_numpy(v).view(torch.bfloat16).float().numpy(),
                torch.from_numpy(r["cache_placed"][k]).view(
                    torch.bfloat16).float().numpy(), rtol=1e-2, atol=1e-2)
        # (b) gathered encodings are the unsharded ones, bit for bit
        assert r["gathered_equal"] and all(r["gathered_equal"].values()), \
            [k for k, ok in r["gathered_equal"].items() if not ok]
        # (c) against the JAX reference's one-device prefill and decode
        np.testing.assert_allclose(r["logits"], want["logits"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(r["dense_logits"], want["dense_logits"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        # (d) the collectives of one prefill, derived from the specs
        assert r["collectives"] == derived


# heads that ``model`` does not split by cache plane: MQA (one KV head;
# the query groups split over model) and three query heads on one KV
# head (3 % 2: each q chunk's rows split over model); their q / k columns
# split mid-head over model
SPLITS = {"query_groups": dict(n_kv_heads=1),
          "query_rows": dict(n_heads=3, n_kv_heads=1)}


def _ref_case(fields):
    ref_cfg = dataclasses.replace(ref_get_smoke("olmo-1b"),
                                  compute_dtype="float32",
                                  sparse_serving=True, **fields)
    cfg = dataclasses.replace(get_smoke("olmo-1b"), compute_dtype="float32",
                              sparse_serving=True, **fields)
    ref_m = ref_build_model(ref_cfg)
    params_j = ref_m.init(jax.random.key(0))
    # the reference's eager rung: at three heads (O or N = 48) its
    # interpret-mode Pallas decode kernel and its own xla path differ by
    # 1.5e-4 in the decode logits (ROADMAP Queue 3)
    plan_j = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="xla", m_hint=16)
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    want = []
    for p in ({**params_j, "sparse_plan": plan_j}, params_j):
        logits, cache = jax.jit(ref_m.prefill)(p, {"tokens":
                                                   jnp.asarray(prompt)})
        step, _ = jax.jit(ref_m.decode_step)(
            p, {"tokens": jnp.full((2, 1), 3),
                "cache_len": jnp.full((2,), 8, jnp.int32)},
            ref_merge(ref_m.init_cache(2, 9), cache))
        want.append((np.asarray(logits), np.asarray(step)))
    params_np = jax.tree.map(np.asarray, params_j)
    return [(cfg, params_np, prompt, PLAN_KW), (cfg, params_np, prompt,
                                                None)], want


def test_attention_splits_where_model_splits_no_plane(tmp_path):
    """The reference's other attention splits on ``(data=2, model=2)``,
    with the plan and without: the sharded prefill and one decode step
    within 1e-4 of the JAX reference's one-device ones."""
    cases, wants = [], []
    for fields in SPLITS.values():
        c, w = _ref_case(fields)
        cases += c
        wants += w
    got = run_ranks(multidevice.prefill_cases, 4,
                    init_method=f"file://{tmp_path}/rendezvous",
                    args=(("data", "model"), (2, 2), cases),
                    timeout_s=LIMIT_S)
    for r in got:
        for (logits, step), (want_logits, want_step) in zip(r, wants):
            np.testing.assert_allclose(logits, want_logits, rtol=TOL,
                                       atol=TOL)
            np.testing.assert_allclose(step, want_step, rtol=TOL, atol=TOL)


def test_serve_mesh_entry_point(tmp_path):
    """``serve --mesh`` on the CPU at batch 4 (each rank's planes one
    whole row, as on the card): every rank's tokens equal one process's, its logits fed those tokens lie
    within the tolerance, its resident bytes equal `shard_bytes`, and
    each rank ran the same collectives."""
    res = serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                      "--impl", "cuda", "--batch", "4", "--prompt-len", "8",
                      "--gen-steps", "3", "--mesh", "data=2,model=2",
                      "--dist-init", f"file://{tmp_path}/rendezvous"])["mesh"]
    assert res["tokens_equal"] and res["bytes_equal"]
    assert max(res["step_logits_max_abs_diff"]) <= res["parity_tol"]
    assert len(res["step_logits_max_abs_diff"]) == 1 + 3
    assert len(res["ranks"]) == 4
    assert len({str(r["collectives"]) for r in res["ranks"]}) == 1
    assert res["ranks"][0]["collectives"]["all_gather"]["ops"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b",
                                  "musicgen-medium", "internvl2-2b"])
def test_serve_mesh_serves_every_family(arch, tmp_path):
    """``serve --mesh`` of each family the reference shards besides the
    dense and MoE ones, on the CPU at batch 4 (max_len 12, which
    ``model`` divides: zamba2's KV is split by sequence over it): every
    rank's tokens equal one process's, its logits lie within the
    tolerance, its resident bytes (the recurrent states, zamba2's
    sequence-split KV) equal `shard_bytes`."""
    res = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--impl", "cuda", "--batch", "4", "--prompt-len", "8",
                      "--gen-steps", "4", "--mesh", "data=2,model=2",
                      "--dist-init", f"file://{tmp_path}/rendezvous"])["mesh"]
    assert res["tokens_equal"] and res["bytes_equal"]
    assert max(res["step_logits_max_abs_diff"]) <= res["parity_tol"]
    assert len(res["step_logits_max_abs_diff"]) == 1 + 4
    assert all(r["resident_bytes"]["cache"] > 0 for r in res["ranks"])


@pytest.mark.parametrize("argv, msg", [
    (["--traffic", "--guard"], "--guard"), (["--guard"], "--guard"),
    (["--tune", "sweep"], "--tune"), ([], "--dist-init"),
    (["--arch", "rwkv6-3b", "--traffic"], "--traffic")])
def test_serve_mesh_refuses(argv, msg, capsys):
    base = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--mesh",
            "data=2,model=2"]
    if msg != "--dist-init":
        base += ["--dist-init", "file:///nonexistent/rendezvous"]
    with pytest.raises(SystemExit):
        serve.main(base + argv)
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("spec, want", [
    ("data=2,model=2", (("data", "model"), (2, 2))),
    ("pod=2,data=2,model=1", (("pod", "data", "model"), (2, 2, 1))),
    ("data=x", None), ("data=2,data=2", None), ("rows=2", None)])
def test_parse_mesh(spec, want):
    if want is None:
        with pytest.raises(ValueError):
            serve.parse_mesh(spec)
    else:
        assert serve.parse_mesh(spec) == want


@pytest.mark.parametrize("fn, limit, msg", [
    ("raise_on", 120.0, "rank 2 raised"),
    ("hang_on", 8.0, "did not finish within")])
def test_launcher_fails_within_its_limit(fn, limit, msg, tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RankError, match=msg) as err:
        run_ranks(getattr(multidevice, fn), 4,
                  init_method=f"file://{tmp_path}/rendezvous", args=(2,),
                  timeout_s=limit)
    assert time.monotonic() - t0 < limit + 30
    if fn == "raise_on":
        assert "fails on purpose" in str(err.value)


def test_kept_ranks_run_several_calls_on_one_set_of_processes(tmp_path):
    """Inside `keep_ranks` two calls run on the same four processes (each
    joining its own rendezvous); a call whose rank raises ends them, and
    the next call starts new ones; the block's end ends them too."""
    from repro_torch.launch.ranks import keep_ranks

    def run(name, fn=multidevice.pid_of, args=()):
        return run_ranks(fn, 4, init_method=f"file://{tmp_path}/{name}",
                         args=args, timeout_s=120.0)
    with keep_ranks(4):
        first, second = run("a"), run("b")
        assert first == second and len(set(first)) == 4
        with pytest.raises(RankError, match="rank 1 raised"):
            run("c", multidevice.raise_on, (1,))
        third = run("d")
        assert not set(third) & set(first)
    fresh = run("e")
    assert not set(fresh) & set(third)


def test_launcher_refuses_a_stale_rendezvous(tmp_path):
    stale = tmp_path / "rendezvous"
    stale.write_text("")
    with pytest.raises(ValueError, match="exists"):
        run_ranks(multidevice.raise_on, 2, init_method=f"file://{stale}",
                  args=(0,))
    with pytest.raises(ValueError, match="file:// or tcp://"):
        run_ranks(multidevice.raise_on, 2, init_method="env://", args=(0,))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_coordinates_and_place_match_numpy(mesh_name):
    """`LiveMesh.coord` is row-major over the axes, `index` first axis
    major, and `place` cuts numpy's slice with `shard_shape`'s shape."""
    names, sizes = MESHES[mesh_name]
    a = np.arange(8 * 12 * 4, dtype=np.float32).reshape(8, 12, 4)
    for r in range(math.prod(sizes)):
        m = _fake_mesh(names, sizes, r)
        assert list(np.unravel_index(r, sizes)) == list(m.coord().values())
        for spec in (P(("data", "pod"), "model"), P(("pod", "data")),
                     P(None, ("data", "model"), None), P("model", "data")):
            spec = P(*[tuple(x for x in shd.spec_axes(d) if x in names)
                       for d in spec])
            got = shd.place(torch.from_numpy(a), m, spec)
            assert tuple(got.shape) == shd.shard_shape(m, a.shape, spec)
            np.testing.assert_array_equal(
                got.numpy(), _np_slice(a, m.coord(), dict(zip(names, sizes)),
                                       spec))


@pytest.mark.parametrize("b, kh, w, layout, round_trip", [
    (2, 4, 3, (("data",), ()), False),
    (4, 4, 2, (("data",), ()), False),
    (2, 4, 3, (("data",), ("model",)), True),
    (1, 4, 2, ((), ()), False)])
def test_planes_move_in_place_where_every_rank_holds_them(b, kh, w, layout,
                                                          round_trip):
    """On (data=2, model=2) with the planes over (data, model), where
    every rank's row block holds its cache planes, `planes_of` needs no
    collective and cuts the whole activation's planes ``[b*kh, S, w]``
    (plane ``row * kh + head``) exactly; where the planes also hold the
    block (the KV-head split), `rows_of` returns it exactly."""
    pax = ("data", "model")
    names, sizes = ("data", "model"), (2, 2)
    s = 3
    x = torch.arange(b * s * kh * w, dtype=torch.float32).reshape(b, s,
                                                                 kh * w)
    planes = x.reshape(b, s, kh, w).transpose(1, 2).reshape(b * kh, s, w)
    for r in range(4):
        m = _fake_mesh(names, sizes, r)
        bax, cax = layout
        block = shd.place(x, m, P(bax or None, None, cax or None))
        p0, n = shd.block_of(m, pax, b * kh)
        mine = shd.planes_of(block, m, layout, kh, pax)
        torch.testing.assert_close(mine, planes[p0:p0 + n], rtol=0, atol=0)
        if round_trip:
            back = shd.rows_of(mine, m, pax, kh, layout)
            torch.testing.assert_close(back, block, rtol=0, atol=0)
