"""The recurrent and frontend families on the port's live mesh, on the
CPU: the smoke configs of rwkv6-3b (family ssm), zamba2-1.2b (hybrid),
musicgen-medium (audio) and internvl2-2b (vlm) at float32, served by four
`torch.distributed` ranks over ``gloo`` on ``(data=2, model=2)`` and, for
the three whose query and KV heads ``model = 4`` divides, on ``(data=1,
model=4)``, held against the JAX reference's one-device prefill and
greedy decode on the same numpy-seeded params (`params_from_numpy`) and
plan.

Per family and mesh: every placed param and plan shard equals numpy's
slice by the reference's specs, bit for bit, and so does the one-process
decode cache placed by `cache_specs` (zamba2's shared-block KV split by
sequence over ``model``); the ranks' own seeded decode cache lies within
1e-4 of it (its bf16 KV within 1e-2); the prefill logits lie within 1e-4
of the reference's with the plan and without it, and the greedy tokens
equal its; `COLLECTIVES` over one planned prefill equals the count derived
here from the specs.  On ``(data=2, model=2)`` also: a zamba2 int8 plan
(5e-2), a prefill with frontend rows of musicgen-medium and internvl2-2b
against the reference's with ``frontend_embed`` (1e-4) and internvl2-2b
at a vocab of 255, which ``model`` does not divide (the published 92553
does not either): its embedding is replicated over ``model``.  zamba2
refuses a ``max_len`` that ``model`` does not divide.  Each mesh's ranks
are spawned once for all its cases."""
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
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.sharding import P  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.models import api, build_model, rwkv6, zamba2  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.testing import multidevice  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402
from test_torch_multidevice import (_bits, _expected_collectives,  # noqa: E402
                                    _fake_mesh, _np_slice)

ARCHS = ("rwkv6-3b", "zamba2-1.2b", "musicgen-medium", "internvl2-2b")
MESHES = {"data2_model2": (("data", "model"), (2, 2), ARCHS),
          "data1_model4": (("data", "model"), (1, 4), ARCHS[:3])}
PLAN_KW = dict(sparsity=0.5, impl="cuda", m_hint=16)
REF_PLAN_KW = dict(sparsity=0.5, impl="pallas", m_hint=16)
B, S, STEPS = 2, 8, 4          # max_len 12: model 2 and 4 divide it
TOL, INT8_TOL = 1e-4, 5e-2
ODD_VOCAB = 255                # internvl2-2b's own (92553) is odd too
LIMIT_S = 240.0                # the launcher's limit on a mesh's cases


def _cfgs(arch, **fields):
    return tuple(dataclasses.replace(get(arch), compute_dtype="float32",
                                     sparse_serving=True, **fields)
                 for get in (ref_get_smoke, get_smoke))


def _np_params(ref_cfg, seed: int):
    """The reference's seed-0 params as numpy, every per-channel vector
    (norms, lerps, decays, biases) moved by 0.1 x a numpy normal of
    ``seed``, so that each rank's block of one differs from its
    neighbour's."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray,
                          ref_build_model(ref_cfg).init(jax.random.key(0)))

    def leaf(path, a):
        vector = a.ndim == (2 if path[0].key == "blocks" else 1) \
            and path[-1].key != "embed"
        if not vector:
            return a
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _frontend(cfg) -> np.ndarray:
    """Seeded frontend rows, float32 values a bf16 holds exactly."""
    fe = np.random.default_rng(7).standard_normal(
        (B, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return np.asarray(jnp.asarray(fe, jnp.bfloat16).astype(jnp.float32))


def _ref_run(ref_cfg, params_np, prompt, *, quant: str = "none",
             frontend=None, greedy: bool = True) -> dict:
    """The reference's one-device prefill logits with its plan (and
    without, and its greedy tokens, when ``greedy``; with ``frontend``
    rows, those too)."""
    params_j = jax.tree.map(jnp.asarray, params_np)
    plan_j = ref_plan.plan_model(ref_cfg, params_j, quant=quant,
                                 **REF_PLAN_KW)
    m = ref_build_model(ref_cfg)
    sparse_j = {**params_j, "sparse_plan": plan_j}
    batch = {"tokens": jnp.asarray(prompt)}
    prefill = jax.jit(m.prefill)
    want = {"logits": np.asarray(prefill(sparse_j, batch)[0])}
    if greedy:
        want["dense_logits"] = np.asarray(prefill(params_j, batch)[0])
        want["tokens"] = np.asarray(ref_serve.greedy_generate(
            m, sparse_j, jnp.asarray(prompt), STEPS, S + STEPS))
    if frontend is not None:
        want["frontend_logits"] = np.asarray(prefill(sparse_j, {
            **batch, "frontend_embed": jnp.asarray(frontend,
                                                   jnp.bfloat16)})[0])
    return want


def _prompt(cfg, seed: int = 1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@functools.lru_cache(maxsize=None)
def _family(arch):
    """``(port cfg, numpy params, prompt, the reference's results)``;
    internvl2-2b at `ODD_VOCAB`."""
    fields = {"vocab_size": ODD_VOCAB} if arch == "internvl2-2b" else {}
    ref_cfg, cfg = _cfgs(arch, **fields)
    params_np = _np_params(ref_cfg, 3)
    prompt = _prompt(cfg)
    frontend = _frontend(cfg) if cfg.frontend else None
    return cfg, params_np, prompt, frontend, _ref_run(
        ref_cfg, params_np, prompt, frontend=frontend)


@functools.lru_cache(maxsize=None)
def _int8():
    ref_cfg, cfg = _cfgs("zamba2-1.2b")
    params_np = _np_params(ref_cfg, 4)
    prompt = _prompt(cfg, 2)
    return cfg, params_np, prompt, _ref_run(ref_cfg, params_np, prompt,
                                            quant="int8", greedy=False)


@functools.lru_cache(maxsize=None)
def _mesh_run(mesh_name: str) -> dict:
    """`multidevice.family_cases` of the mesh's families (and on
    ``(data=2, model=2)`` the int8 case) on its ranks, spawned once:
    ``{case: [each rank's result]}``."""
    names, sizes, archs = MESHES[mesh_name]
    cases = {}
    for arch in archs:
        cfg, params_np, prompt, frontend, _ = _family(arch)
        cases[arch] = dict(cfg=cfg, params_np=params_np, prompt=prompt,
                           steps=STEPS, plan_kwargs=PLAN_KW, shards=True,
                           frontend=frontend)
    if mesh_name == "data2_model2":
        cfg, params_np, prompt, _ = _int8()
        cases["int8"] = dict(cfg=cfg, params_np=params_np, prompt=prompt,
                             steps=STEPS,
                             plan_kwargs=dict(PLAN_KW, quant="int8"))
    with tempfile.TemporaryDirectory() as tmp:
        got = run_ranks(multidevice.family_cases, math.prod(sizes),
                        init_method=f"file://{tmp}/rendezvous",
                        args=(names, sizes, list(cases.values())),
                        timeout_s=LIMIT_S)
    return {name: [r[i] for r in got] for i, name in enumerate(cases)}


MESH_FAMILIES = [(m, a) for m, (_, _, archs) in sorted(MESHES.items())
                 for a in archs]


def _spec_at(specs, path):
    for p in path:
        specs = specs[p]
    return specs


@pytest.mark.parametrize("mesh_name, arch", MESH_FAMILIES)
def test_family_shards_are_numpy_slices(mesh_name, arch):
    """Params, plan leaves and the one-process decode cache placed by the
    reference's specs are numpy's slices, bit for bit; the ranks' own
    seeded cache is close to that placed one."""
    names, sizes, _ = MESHES[mesh_name]
    cfg, params_np, _, _, _ = _family(arch)
    size_of = dict(zip(names, sizes))
    m0 = _fake_mesh(names, sizes, 0)
    whole = params_from_numpy(params_np, "cpu")
    plan = engine_plan.plan_model(cfg, whole, **PLAN_KW)
    pspecs = api.param_specs(cfg, m0)
    specs = engine_plan.plan_specs(plan, m0)
    cspecs = api.cache_specs(cfg, m0, B)
    ranks = _mesh_run(mesh_name)[arch]
    whole_cache = ranks[0]["whole_cache"]
    for r in ranks:
        for path, t in flatten_with_paths(whole):
            key = "/".join(path)
            np.testing.assert_array_equal(
                r["params"][key], _np_slice(_bits(t), r["coord"], size_of,
                                            _spec_at(pspecs, path)))
            assert r["params"][key].shape == r["shapes"][key]
        for nm, lp in plan.layers.items():
            leaf_specs = engine_plan.weight_leaves(specs.layers[nm].weights)
            for leaf, t in engine_plan.weight_leaves(lp.weights).items():
                np.testing.assert_array_equal(
                    r["plan"][f"{nm}/{leaf}"],
                    _np_slice(_bits(t), r["coord"], size_of,
                              leaf_specs[leaf]))
        for k, v in r["cache_placed"].items():
            np.testing.assert_array_equal(
                v, _np_slice(whole_cache[k], r["coord"], size_of, cspecs[k]))
            got = r["cache"][k]
            assert got.shape == v.shape, k
            if got.dtype == np.int16:        # bf16 KV, as the dense mesh's
                got, v = (torch.from_numpy(a).view(torch.bfloat16).float()
                          .numpy() for a in (got, v))
                tol = 1e-2
            else:
                tol = TOL
            np.testing.assert_allclose(got, v, rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("mesh_name, arch", MESH_FAMILIES)
def test_family_mesh_matches_reference(mesh_name, arch):
    *_, want = _family(arch)
    for r in _mesh_run(mesh_name)[arch]:
        np.testing.assert_allclose(r["logits"], want["logits"], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(r["dense_logits"], want["dense_logits"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(r["tokens"], want["tokens"])


def _recurrent_collectives(cfg, plan, names, sizes, b: int,
                           s: int) -> dict:
    """One planned prefill's collectives on every rank of a recurrent
    family, from the specs (every large projection is planned):

    * the embedding's ``all_reduce`` of the f32 ``[B, s, d]`` rows and the
      logits' gather of the last positions over the batch axes and
      ``all_reduce`` of the f32 ``[B, V]`` partials, as the transformer's;
    * per layer, each planned projection's encoding gathered over the
      axes `plan_specs` split it on, and the layer's unplanned weights
      that the FSDP axes split gathered to their use-time specs (one
      ``all_gather``, f32 here);
    * per layer, where ``model`` splits the heads: the out-projection's
      input gathered whole (its encoding takes whole columns), and for
      zamba2 the gate norm's float64 partial sums ``[bl, s, 1]``;
    * zamba2's shared block: its weights gathered over the FSDP axes once
      a forward; per application the prompt's k and v (the rank's heads)
      gathered whole, and two ``all_reduce``s of the float64 partial
      products ``[bl, s, d]`` of ``wo`` and ``w_down`` (row-parallel; the
      weights no plan covers sum in float64, `layers.matmul_f64`)."""
    m0 = _fake_mesh(names, sizes, 0)
    size_of = dict(zip(names, sizes))
    d = cfg.d_model

    def split(spec, axes=None):
        return any(size_of[a] > 1 for dd in spec for a in shd.spec_axes(dd)
                   if axes is None or a in axes)

    def shard_bytes(shape, spec):
        return math.prod(shd.shard_shape(m0, tuple(shape), spec)) * 4

    pspecs = api.param_specs(cfg, m0)
    shapes = api.init_shapes(cfg)
    fsdp = set(shd.fsdp_axes(m0))
    bax = shd.shard_batch(m0, b) or ()
    bl = b // math.prod(size_of[a] for a in bax) if bax else b
    gathers, reduces = [], []
    if split(pspecs["embed"]):
        reduces.append(b * s * d * 4)
    specs = engine_plan.plan_specs(plan, m0)
    plan_gathers = []
    for nm, lp in plan.layers.items():
        leaf_specs = engine_plan.weight_leaves(specs.layers[nm].weights)
        nbytes = sum(
            math.prod(shd.shard_shape(m0, tuple(t.shape),
                                      P(*list(leaf_specs[leaf])[1:])))
            * t.element_size()
            for leaf, t in engine_plan.weight_leaves(
                lp.layer(0).weights).items()
            if split(P(*list(leaf_specs[leaf])[1:])))
        if nbytes:
            plan_gathers.append(nbytes)
    dense = sum(shard_bytes(t.shape[1:], P(*list(pspecs["blocks"][nm])[1:]))
                for nm, t in shapes["blocks"].items()
                if nm not in plan.layers
                and split(P(*list(pspecs["blocks"][nm])[1:]), fsdp))
    layer = plan_gathers + ([dense] if dense else [])
    heads_split = size_of.get("model", 1) > 1
    if cfg.family == "ssm":
        nh = d // cfg.rwkv_head_dim
        assert nh % size_of.get("model", 1) == 0
        if heads_split:
            layer.append(bl * s * d // size_of["model"] * 4)
        gathers += layer * cfg.n_layers
    else:
        d_in = cfg.ssm_expand * d
        if heads_split:
            layer += [bl * s * 8, bl * s * d_in // size_of["model"] * 4]
        gathers += layer * cfg.n_layers
        shared = sum(shard_bytes(t.shape, pspecs["shared"][nm])
                     for nm, t in shapes["shared"].items()
                     if split(pspecs["shared"][nm], fsdp))
        if shared:
            gathers.append(shared)
        n_attn = -(-cfg.n_layers // cfg.attn_every)
        for _ in range(n_attn):
            if heads_split:
                gathers.append(2 * bl * s * cfg.n_kv_heads * cfg.head_dim
                               // size_of["model"] * 4)
                reduces += [bl * s * d * 8] * 2
    if bl < b:
        gathers.append(bl * d * 4)
    if split(pspecs["embed"]):
        reduces.append(b * cfg.vocab_size * 4)
    return {"all_gather": {"ops": len(gathers), "bytes": sum(gathers)},
            "all_reduce": {"ops": len(reduces), "bytes": sum(reduces)}}


@pytest.mark.parametrize("mesh_name, arch", MESH_FAMILIES)
def test_family_collectives_derived_from_specs(mesh_name, arch):
    names, sizes, _ = MESHES[mesh_name]
    cfg, params_np, prompt, _, _ = _family(arch)
    plan = engine_plan.plan_model(cfg, params_from_numpy(params_np, "cpu"),
                                  **PLAN_KW)
    derive = _recurrent_collectives if cfg.family in ("ssm", "hybrid") \
        else _expected_collectives
    want = derive(cfg, plan, names, sizes, *prompt.shape)
    for r in _mesh_run(mesh_name)[arch]:
        assert r["collectives"] == want


def test_zamba2_int8_plan_on_mesh():
    *_, want = _int8()
    for r in _mesh_run("data2_model2")["int8"]:
        np.testing.assert_allclose(r["logits"], want["logits"],
                                   rtol=INT8_TOL, atol=INT8_TOL)


@pytest.mark.parametrize("arch", ("musicgen-medium", "internvl2-2b"))
def test_frontend_rows_prefill_on_mesh(arch):
    """A planned prefill with ``frontend_embed``: ``frontend_proj`` placed
    ``[fsdp, model]`` projects each rank's rows onto the first n
    positions; the logits lie within 1e-4 of the reference's, and the
    rows change them."""
    *_, want = _family(arch)
    for r in _mesh_run("data2_model2")[arch]:
        np.testing.assert_allclose(r["frontend_logits"],
                                   want["frontend_logits"], rtol=TOL,
                                   atol=TOL)
        assert np.abs(r["frontend_logits"] - r["logits"]).max() > 10 * TOL


def test_vocab_that_model_does_not_divide():
    """internvl2-2b at a vocab of 255: the embedding's vocab dim falls
    back to replicated on ``(data=2, model=2)`` (its ``d`` over ``data``),
    every rank looks every token up, and the prefill and greedy tokens
    match the reference (`test_family_mesh_matches_reference`)."""
    names, sizes, _ = MESHES["data2_model2"]
    cfg = _family("internvl2-2b")[0]
    assert cfg.vocab_size == ODD_VOCAB and ODD_VOCAB % 2
    spec = api.param_specs(cfg, _fake_mesh(names, sizes, 0))["embed"]
    assert tuple(spec) == (None, "data")
    want = _family("internvl2-2b")[-1]
    for r in _mesh_run("data2_model2")["internvl2-2b"]:
        assert r["params"]["embed"].shape == (ODD_VOCAB, cfg.d_model // 2)
        np.testing.assert_array_equal(r["tokens"], want["tokens"])


@pytest.mark.parametrize("model", (2, 4))
def test_zamba2_max_len_must_divide_model(model):
    """The reference splits zamba2's shared-block KV by sequence over
    ``model`` with no fallback: the live bundle refuses a ``max_len``
    that ``model`` does not divide, and takes one it divides."""
    cfg = _cfgs("zamba2-1.2b")[1]
    mesh = _fake_mesh(("data", "model"), (1, model), 0)
    bundle = build_model(cfg, "cpu", mesh=mesh)
    with pytest.raises(ValueError, match="must be a multiple of"):
        bundle.init_cache(B, 3 * model + 1)
    cache = bundle.init_cache(B, 3 * model)
    assert cache["k"].shape[2] == 3


def test_recurrent_live_modules_do_not_import_the_transformer():
    """The recurrent families' live program runs from their own modules
    and `distributed.sharding`, not from `models.transformer`."""
    import ast
    import inspect
    for mod in (rwkv6, zamba2):
        tree = ast.parse(inspect.getsource(mod))
        names = {a.name for node in ast.walk(tree)
                 if isinstance(node, (ast.Import, ast.ImportFrom))
                 for a in node.names}
        mods = {node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.module}
        assert "transformer" not in names and not any(
            m.endswith("transformer") for m in mods), mod.__name__


def test_serve_leaves_the_matmul_flags_as_it_found_them():
    """`serve.run` takes its matmuls without TF32 (`exact_matmuls`) and
    gives the process its flags back: a later timing in the same process
    runs under the caller's settings."""
    import torch
    from repro_torch.launch import serve
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    seen = []
    real = serve._serve_one

    def spy(args, cfg):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return real(args, cfg)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        serve._serve_one = spy
        serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu",
                    "--impl", "cuda", "--batch", "2", "--prompt-len", "4",
                    "--gen-steps", "2"])
        assert seen == [(False, False)]
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        serve._serve_one = real
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
