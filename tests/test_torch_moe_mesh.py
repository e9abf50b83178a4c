"""Expert parallelism on the port's live mesh, on the CPU: the
deepseek-moe-16b smoke config (8 routed experts, top-2, one shared) at
float32, served by four `torch.distributed` ranks over ``gloo`` on
``(data=2, model=2)`` (four experts a rank), ``(data=1, model=4)`` (two)
and ``(pod=2, data=2, model=1)`` (every expert, the capacity split),
held against the JAX reference's one-device prefill and greedy decode on
the same numpy-seeded params (`params_from_numpy`) and plan.

Per mesh: every placed param and plan shard equals numpy's slice by the
reference's specs, bit for bit; `gather_layer` of every expert leaf is
the whole encoding's block of the rank's experts, bit for bit (the other
layers whole); the prefill logits lie within 1e-4 of the reference's with
the plan and without it (dense experts), the greedy tokens equal its, and
each batched dispatch ran the rank's experts only; `COLLECTIVES` over one
prefill equals the count `_expected_collectives` derives from the specs.
On ``(data=2, model=2)`` also: a capacity factor of 0.5 at batch 4 x
prompt 16 (the reference drops assignments; the mesh routes the whole
batch and drops the same ones), ``_MOE_SEG`` small in both packages (S
runs in segments; the ranks take it as an argument) and an int8 plan
(5e-2); and ``serve --mesh`` of the smoke MoE passes its own gates."""
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
from repro.engine import plan as ref_plan  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro.models.api import merge_prefill_cache as ref_merge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.testing import multidevice  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402
from test_torch_multidevice import (_bits, _expected_collectives,  # noqa: E402
                                    _fake_mesh, _np_slice)

ARCH = "deepseek-moe-16b"
MESHES = {"data2_model2": (("data", "model"), (2, 2)),
          "data1_model4": (("data", "model"), (1, 4)),
          "pod2_data2_model1": (("pod", "data", "model"), (2, 2, 1))}
PLAN_KW = dict(sparsity=0.5, impl="cuda", m_hint=16)
STEPS = 4
TOL = 1e-4
INT8_TOL = 5e-2          # the reference's tolerance for quantized plans
OVERFLOW = dict(capacity_factor=0.5)
OVERFLOW_PROMPT = (4, 16)
# the segment case: batch 2 x prompt 32 in segments of 16 positions (32
# tokens, capacity 8), at the overflow's capacity factor, so that the
# segments drop other assignments than one dispatch of 64 tokens would
SEG, SEG_PROMPT = 32, (2, 32)
LIMIT_S = 240.0          # the launcher's limit on a mesh case
EXPERT_NAMES = ("we_gate", "we_up", "we_down")


def _cfgs(**fields):
    ref_cfg = dataclasses.replace(ref_get_smoke(ARCH), compute_dtype="float32",
                                  sparse_serving=True, **fields)
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32",
                              sparse_serving=True, **fields)
    return ref_cfg, cfg


def _np_params(ref_cfg, seed: int):
    """Params of the reference's shapes from a numpy seed: projections
    normal over sqrt(fan-in), the embedding 0.02 x normal, the norms 1 +
    0.1 x normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        name = path[-1].key
        if "norm" in name:
            a = 1.0 + 0.1 * rng.standard_normal(sd.shape)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(sd.shape)
        else:
            a = rng.standard_normal(sd.shape) / np.sqrt(sd.shape[-2])
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, ref_tr.init_shapes(ref_cfg))


def _prompt(cfg, shape):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, shape)


@functools.lru_cache(maxsize=None)
def _reference():
    """The reference's one-device prefill logits (with the plan and
    without) and greedy tokens; the params as numpy and the port's plan
    on them."""
    ref_cfg, cfg = _cfgs()
    params_np = _np_params(ref_cfg, 0)
    params_j = jax.tree.map(jnp.asarray, params_np)
    plan_j = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="pallas", m_hint=16)
    ref_m = ref_build_model(ref_cfg)
    prompt = _prompt(cfg, (2, 8))
    sparse_j = {**params_j, "sparse_plan": plan_j}
    batch = {"tokens": jnp.asarray(prompt)}
    want = {"logits": np.asarray(jax.jit(ref_m.prefill)(sparse_j, batch)[0]),
            "dense_logits": np.asarray(
                jax.jit(ref_m.prefill)(params_j, batch)[0]),
            "tokens": np.asarray(ref_serve.greedy_generate(
                ref_m, sparse_j, jnp.asarray(prompt), STEPS,
                prompt.shape[1] + STEPS))}
    whole = params_from_numpy(params_np, "cpu")
    plan = engine_plan.plan_transformer(cfg, whole, **PLAN_KW)
    return cfg, params_np, whole, plan, prompt, want


@functools.lru_cache(maxsize=None)
def _mesh_run(mesh_name: str) -> list:
    """`multidevice.mesh_case` on the mesh's ranks (one spawn a mesh,
    shared by the tests of that mesh)."""
    names, sizes = MESHES[mesh_name]
    cfg, params_np, _, _, prompt, _ = _reference()
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(multidevice.mesh_case, math.prod(sizes),
                         init_method=f"file://{tmp}/rendezvous",
                         args=(names, sizes, cfg, params_np, prompt, STEPS,
                               PLAN_KW), timeout_s=LIMIT_S)


def _ref_step(ref_cfg, params, prompt, decode: bool = True) -> list:
    """The reference's prefill logits and (with ``decode``) one decode
    step of token 3 for every row (a fresh bundle: jit traces under the
    module's ``_MOE_SEG`` of the moment)."""
    ref_m = ref_build_model(ref_cfg)
    b, s = prompt.shape
    logits, cache = jax.jit(ref_m.prefill)(params,
                                           {"tokens": jnp.asarray(prompt)})
    if not decode:
        return [np.asarray(logits)]
    step, _ = jax.jit(ref_m.decode_step)(
        params, {"tokens": jnp.full((b, 1), 3),
                 "cache_len": jnp.full((b,), s, jnp.int32)},
        ref_merge(ref_m.init_cache(b, s + 1), cache))
    return [np.asarray(logits), np.asarray(step)]


def _layer0_load(ref_cfg, params_j, prompt) -> tuple:
    """``(the most assignments any expert gets, the capacity)`` of the
    reference's first MoE dispatch in a prefill of ``prompt`` (its own
    embedding, attention, norm and router)."""
    b, s = prompt.shape
    lp = jax.tree.map(lambda a: a[0], params_j["blocks"])
    h = ref_tr._embed_tokens(ref_cfg, params_j,
                             {"tokens": jnp.asarray(prompt)}, None)
    positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
    h = h + ref_tr._attn(ref_cfg, lp, h, positions, None)[0].astype(h.dtype)
    x = ref_tr._norm(ref_cfg, h, lp["mlp_norm"]).reshape(b * s, -1)
    _, eidx = jax.lax.top_k(jax.nn.softmax(x @ lp["router"], axis=-1),
                            ref_cfg.top_k)
    cap = max(8, math.ceil(b * s * ref_cfg.top_k / ref_cfg.n_experts
                           * ref_cfg.capacity_factor))
    load = np.bincount(np.asarray(eidx).reshape(-1),
                       minlength=ref_cfg.n_experts)
    return int(load.max()), cap


@functools.lru_cache(maxsize=None)
def _extra_cases():
    """The overflow, segment and int8 cases on ``(data=2, model=2)``: the
    reference's prefill and decode-step logits, the ranks' (one spawn),
    and the reference's first-layer load and capacity at overflow."""
    cases, wants = {}, {}
    ref_cfg, cfg = _cfgs(**OVERFLOW)
    params_np = _np_params(ref_cfg, 2)
    params_j = jax.tree.map(jnp.asarray, params_np)
    prompt = _prompt(cfg, OVERFLOW_PROMPT)
    plan_j = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="pallas", m_hint=64)
    kw = dict(PLAN_KW, m_hint=64)
    cases["overflow"] = (cfg, params_np, prompt, kw)
    wants["overflow"] = _ref_step(ref_cfg, {**params_j,
                                            "sparse_plan": plan_j}, prompt)
    cases["overflow dense"] = (cfg, params_np, prompt, None)
    wants["overflow dense"] = _ref_step(ref_cfg, params_j, prompt,
                                        decode=False)
    load = _layer0_load(ref_cfg, params_j, prompt)

    params_np = _np_params(ref_cfg, 3)
    params_j = jax.tree.map(jnp.asarray, params_np)
    prompt = _prompt(cfg, SEG_PROMPT)
    plan_j = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="pallas", m_hint=64)
    cases["segments"] = (cfg, params_np, prompt, kw, SEG)
    sparse_j = {**params_j, "sparse_plan": plan_j}
    wants["one dispatch"] = _ref_step(ref_cfg, sparse_j, prompt,
                                      decode=False)
    old = ref_tr._MOE_SEG
    ref_tr._MOE_SEG = SEG
    try:
        wants["segments"] = _ref_step(ref_cfg, sparse_j, prompt)
    finally:
        ref_tr._MOE_SEG = old

    ref_cfg, cfg = _cfgs()
    prompt = _prompt(cfg, (2, 8))
    plan_q = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="pallas", m_hint=16,
                                       quant="int8")
    cases["int8"] = (cfg, params_np, prompt, dict(PLAN_KW, quant="int8"))
    wants["int8"] = _ref_step(ref_cfg, {**params_j, "sparse_plan": plan_q},
                              prompt)
    with tempfile.TemporaryDirectory() as tmp:
        got = run_ranks(multidevice.prefill_cases, 4,
                        init_method=f"file://{tmp}/rendezvous",
                        args=(("data", "model"), (2, 2),
                              list(cases.values())), timeout_s=LIMIT_S)
    got = [dict(zip(cases, r)) for r in got]
    return got, wants, load


def _experts_of(mesh_name: str) -> int:
    """The experts a rank holds on the mesh, by `param_specs`."""
    names, sizes = MESHES[mesh_name]
    cfg = _reference()[0]
    m = _fake_mesh(names, sizes, 0)
    spec = transformer.param_specs(cfg, m)["blocks"]["we_gate"]
    return shd.block_of(m, spec[1], cfg.n_experts)[1]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_moe_shards_are_numpy_slices(mesh_name):
    names, sizes = MESHES[mesh_name]
    cfg, _, whole, plan, _, _ = _reference()
    size_of = dict(zip(names, sizes))
    m0 = _fake_mesh(names, sizes, 0)
    pspecs = transformer.param_specs(cfg, m0)
    specs = engine_plan.plan_specs(plan, m0)
    for r in _mesh_run(mesh_name):
        for path, t in flatten_with_paths(whole):
            key = "/".join(path)
            spec = pspecs
            for p in path:
                spec = spec[p]
            np.testing.assert_array_equal(
                r["params"][key], _np_slice(_bits(t), r["coord"], size_of,
                                            spec))
            assert r["params"][key].shape == r["shapes"][key]
        for nm, lp in plan.layers.items():
            leaf_specs = engine_plan.weight_leaves(specs.layers[nm].weights)
            for leaf, t in engine_plan.weight_leaves(lp.weights).items():
                key = f"{nm}/{leaf}"
                np.testing.assert_array_equal(
                    r["plan"][key], _np_slice(_bits(t), r["coord"], size_of,
                                              leaf_specs[leaf]))
                assert r["plan"][key].shape == r["shapes"][key]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_gather_layer_keeps_the_ranks_experts(mesh_name):
    """`gather_layer` returns each expert leaf as the rank's block of
    ``E / model`` experts (the whole encoding's slice, bit for bit) and
    every other layer whole."""
    cfg, _, _, plan, _, _ = _reference()
    el = _experts_of(mesh_name)
    assert el == cfg.n_experts // MESHES[mesh_name][1][-1]
    for r in _mesh_run(mesh_name):
        assert r["gathered_equal"] and all(r["gathered_equal"].values()), \
            [k for k, ok in r["gathered_equal"].items() if not ok]
        for i in range(cfg.n_layers):
            for nm, lp in plan.per_layer[i].items():
                for leaf, t in engine_plan.weight_leaves(lp.weights).items():
                    got = r["gathered_shapes"][f"{i}/{nm}/{leaf}"]
                    want = tuple(t.shape)
                    if nm in EXPERT_NAMES:
                        want = (el,) + want[1:]
                    assert got == want, (i, nm, leaf)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_moe_mesh_matches_reference(mesh_name):
    cfg, _, _, _, _, want = _reference()
    el = _experts_of(mesh_name)
    for r in _mesh_run(mesh_name):
        np.testing.assert_allclose(r["logits"], want["logits"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(r["dense_logits"], want["dense_logits"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["tokens"], want["tokens"])
        # every batched dispatch of the prefill ran this rank's experts
        assert r["expert_blocks"] == {el: len(EXPERT_NAMES) * cfg.n_layers}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_moe_collectives_derived_from_specs(mesh_name):
    names, sizes = MESHES[mesh_name]
    cfg, _, _, plan, prompt, _ = _reference()
    derived = _expected_collectives(cfg, plan, names, sizes, *prompt.shape)
    for r in _mesh_run(mesh_name):
        assert r["collectives"] == derived


def test_moe_capacity_overflow_matches_reference():
    """At capacity factor 0.5 the reference drops assignments (an expert
    is chosen past its capacity); the mesh, which routes the whole batch
    on every rank, drops the same ones: its prefill and decode step equal
    the reference's, with the plan and without."""
    got, wants, (load, cap) = _extra_cases()
    assert load > cap
    for r in got:
        for name in ("overflow", "overflow dense"):
            for g, w in zip(r[name], wants[name]):
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_moe_segments_match_reference():
    """``_MOE_SEG`` small in both packages: S runs in two segments, each
    routed over the whole batch (their capacity drops differ from one
    dispatch's, so the segments show in the logits)."""
    got, wants, _ = _extra_cases()
    assert not np.allclose(wants["segments"][0], wants["one dispatch"][0],
                           rtol=TOL, atol=TOL)
    for r in got:
        for g, w in zip(r["segments"], wants["segments"]):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_moe_int8_plan_matches_reference():
    got, wants, _ = _extra_cases()
    for r in got:
        for g, w in zip(r["int8"], wants["int8"]):
            np.testing.assert_allclose(g, w, rtol=INT8_TOL, atol=INT8_TOL)


def test_serve_mesh_moe_entry_point(tmp_path):
    """``serve --mesh`` of the smoke MoE: every rank's tokens equal one
    process's, its logits lie within the tolerance, its resident bytes
    equal `shard_bytes`; each rank held and ran its block of experts, and
    routed every token as one process does.  Off the card, rank 0 sets up
    alone and the other ranks together."""
    steps = 3
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--impl", "cuda", "--batch", "4", "--prompt-len", "8",
                      "--gen-steps", str(steps), "--mesh", "data=2,model=2",
                      "--dist-init", f"file://{tmp_path}/rendezvous"])["mesh"]
    assert res["tokens_equal"] and res["bytes_equal"]
    assert max(res["step_logits_max_abs_diff"]) <= res["parity_tol"]
    assert res["routing_agreement"] == 1.0
    cfg = get_smoke(ARCH)
    el = cfg.n_experts // 2
    for r in res["ranks"]:
        e0 = r["coord"]["model"] * el
        assert r["expert_block"] == [e0, e0 + el]
        assert r["experts_per_dispatch"] == {
            el: len(EXPERT_NAMES) * cfg.n_layers * (1 + steps)}
        assert r["routing_agreement"] == 1.0
        assert r["setup_turns"] == [1, 3]
