"""The port's MoE family (deepseek-moe-16b smoke) against the JAX reference
on identical weights (`params_from_numpy`): parameters, router tie-break,
`_moe_tokens` (capacity dispatch, drops, aux loss, segmentation), the
expert plans (array-equal encodings, reference ``pallas`` <-> port
``cuda``), `apply_expert_fc`, end-to-end prefill/decode logits within 1e-4
at f32 (2e-2 at bf16) with greedy tokens equal, and the serving entry
point.  The reference's Pallas kernels run in interpret mode; the port's
wrappers run their plain versions on the CPU."""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.engine import execute as ref_execute  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import transformer as ref_tr  # noqa: E402
from repro.models.api import merge_prefill_cache as ref_merge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.api import merge_prefill_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCH = "deepseek-moe-16b"
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
IMPLS = {"cuda": "pallas", "xla": "xla"}
# the smoke experts are one column block wide; this variant has NB = 2..3
# blocks per row, so the shared packing permutation is tried (and adopted)
WIDE = dict(d_model=256, n_heads=4, head_dim=64, n_kv_heads=4, d_ff=192,
            n_experts=4)


def _np(t):
    return t.detach().float().numpy()


def _cfgs(cd, **overrides):
    ref_cfg = dataclasses.replace(ref_get_smoke(ARCH), compute_dtype=cd,
                                  sparse_serving=True, **overrides)
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=cd,
                              sparse_serving=True, **overrides)
    return ref_cfg, cfg


@functools.lru_cache(maxsize=None)
def _params(cd, wide=False):
    ref_cfg, cfg = _cfgs(cd, **(WIDE if wide else {}))
    params_j = ref_tr.init_params(ref_cfg, jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    return ref_cfg, cfg, params_j, params


@functools.lru_cache(maxsize=None)
def _plans(cd, impl, wide=False):
    ref_cfg, cfg, params_j, params = _params(cd, wide)
    want = ref_plan.plan_model(ref_cfg, params_j, sparsity=0.5,
                               impl=IMPLS[impl], m_hint=16, decode_m=2)
    got = engine_plan.plan_model(cfg, params, sparsity=0.5, impl=impl,
                                 m_hint=16, decode_m=2)
    return got, want


@functools.lru_cache(maxsize=None)
def _setup(cd):
    """Both packages' bundles and sparse / masked-dense params."""
    ref_cfg, cfg, params_j, params = _params(cd)
    got_plan, want_plan = _plans(cd, "cuda")
    ref = {"sparse": {**params_j, "sparse_plan": want_plan},
           "dense": ref_plan.masked_dense_params(params_j, want_plan)}
    got = {"sparse": {**params, "sparse_plan": got_plan},
           "dense": engine_plan.masked_dense_params(params, got_plan)}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    return ref_build_model(ref_cfg), build_model(cfg, "cpu"), ref, got, prompt


def _close(got, want, cd):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=TOL[cd], atol=TOL[cd])


def _layer(params, i):
    return {nm: w[i] for nm, w in params["blocks"].items()}


def test_init_params_match_reference_layout():
    """The MoE branch of `init_params`: the reference's keys, shapes and
    dtypes (router, routed and shared experts), and `params_from_numpy`
    carries a MoE tree over array for array."""
    ref_cfg, cfg, params_j, params = _params("float32")
    mine = tr.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                          ref_tr.init_shapes(ref_cfg))
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).removeprefix("torch.")),
                        mine) == shapes
    for nm in ("router", "we_gate", "we_down", "ws_gate", "ws_down"):
        np.testing.assert_array_equal(params["blocks"][nm].numpy(),
                                      np.asarray(params_j["blocks"][nm]))
    # the 1/sqrt(fan-in) scale of the down projections (f and fs)
    f = cfg.d_ff
    assert abs(float(mine["blocks"]["we_down"].std()) * f ** 0.5 - 1) < 0.1


def test_router_tie_keeps_lower_expert_like_lax_top_k():
    """Exactly equal router probabilities: the port takes the lower expert
    first, as ``lax.top_k`` does, and the block output matches."""
    ref_cfg, cfg, params_j, params = _params("float32")
    ref_cfg = dataclasses.replace(ref_cfg, top_k=3)
    cfg = dataclasses.replace(cfg, top_k=3)
    tie = np.array([0.5, 1, 1, 0.2, 1, 1, 0.1, 1], np.float32)
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[0] = tie
    xf = np.zeros((4, cfg.d_model), np.float32)
    xf[:, 0] = 1.0
    xf[:, 1:] = np.random.default_rng(0).standard_normal((4, cfg.d_model - 1))
    lp = {**_layer(params, 0), "router": torch.from_numpy(router)}
    lpj = {**jax.tree.map(lambda a: a[0], params_j["blocks"]),
           "router": jnp.asarray(router)}
    y, aux, (gate, eidx) = tr._moe_tokens(cfg, lp, torch.from_numpy(xf))
    _, want_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xf) @ router), 3)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(want_idx))
    assert eidx[0].tolist() == [1, 2, 4]
    yj, auxj = ref_tr._moe_tokens(ref_cfg, lpj, jnp.asarray(xf), None)
    _close(y, yj, "float32")
    _close(aux, auxj, "float32")


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("planned", [False, True])
def test_moe_tokens_match_reference(cd, planned):
    """`_moe_tokens` (dense experts, and the planned experts through the
    batched kernel's plain version) against the reference's, with enough
    tokens that the capacity drops assignments; aux loss included."""
    ref_cfg, cfg, params_j, params = _params(cd)
    got_plan, want_plan = _plans(cd, "cuda")
    t = 64
    x = np.random.default_rng(5).standard_normal((t, cfg.d_model))
    xt = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, cd))
    xj = jnp.asarray(x, jnp.float32).astype(getattr(jnp, cd))
    execute.reset_stats()
    y, aux, (_, eidx) = tr._moe_tokens(
        cfg, _layer(params, 1), xt,
        plan_layers=got_plan.per_layer[1] if planned else None)
    yj, auxj = ref_tr._moe_tokens(
        ref_cfg, jax.tree.map(lambda a: a[1], params_j["blocks"]), xj, None,
        plan_layers=jax.tree.map(lambda a: a[1], want_plan.layers)
        if planned else None)
    cap = max(8, math.ceil(t * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor))
    assert int(torch.bincount(eidx.reshape(-1)).max()) > cap   # drops occur
    assert (execute.stats().get("expert_balanced_spmm", 0) == 3) == planned
    _close(y, yj, cd)
    _close(aux, auxj, "float32")


def test_moe_segments_match_reference(monkeypatch):
    """`_moe` over several token segments (``_MOE_SEG`` made small): the
    reference's scan becomes a loop with the same segment bounds, aux
    averaged over segments."""
    monkeypatch.setattr(tr, "_MOE_SEG", 8)
    monkeypatch.setattr(ref_tr, "_MOE_SEG", 8)
    ref_cfg, cfg, params_j, params = _params("float32")
    h = np.random.default_rng(6).standard_normal((2, 12, cfg.d_model))
    h = h.astype(np.float32)
    y, aux, route = tr._moe(cfg, _layer(params, 0), torch.from_numpy(h))
    yj, auxj = ref_tr._moe(ref_cfg, jax.tree.map(lambda a: a[0],
                                                 params_j["blocks"]),
                           jnp.asarray(h), None)
    assert route[1].shape == (2, 12, cfg.top_k)
    _close(y, yj, "float32")
    _close(aux, auxj, "float32")


@pytest.mark.parametrize("cd,impl,wide", [
    ("float32", "cuda", False), ("bfloat16", "cuda", False),
    ("bfloat16", "cuda", True), ("bfloat16", "xla", False)])
def test_expert_plans_match_reference(cd, impl, wide):
    """`plan_model` on MoE: the same layers and specs as
    `repro.engine.plan.plan_transformer`, with array-equal per-expert
    encodings (and the lead-broadcast packing perm where adopted)."""
    got, want = _plans(cd, impl, wide)
    assert sorted(got.layers) == sorted(want.layers)
    assert {"we_gate", "we_up", "we_down", "ws_gate", "ws_up",
            "ws_down"} <= set(got.layers)
    assert got.meta == want.meta
    for nm, lp in got.layers.items():
        s, r = lp.spec, want.layers[nm].spec
        assert s.impl == impl and r.impl == IMPLS[impl]
        for f in ("mode", "n_in", "n_out", "k", "block_k", "experts",
                  "d_mem_bits", "packed", "pack_kb"):
            assert getattr(s, f) == getattr(r, f), (nm, f)
        assert dataclasses.asdict(s.blocks) == dataclasses.asdict(r.blocks)
        w, rw = lp.weights, want.layers[nm].weights
        np.testing.assert_array_equal(_np(w.values),
                                      np.asarray(rw.values, np.float32))
        np.testing.assert_array_equal(w.indices.numpy(),
                                      np.asarray(rw.indices))
        if impl == "cuda":
            np.testing.assert_array_equal(w.counts.numpy(),
                                          np.asarray(rw.counts))
            assert (w.perm is None) == (rw.perm is None)
            if w.perm is not None:
                np.testing.assert_array_equal(w.perm.numpy(),
                                              np.asarray(rw.perm))
    assert got.layers["we_up"].spec.experts == got.layers["we_up"] \
        .weights.values.shape[1]
    if wide:
        assert any(lp.spec.packed and lp.spec.experts
                   for lp in got.layers.values())


@pytest.mark.parametrize("impl,m", [("cuda", 8), ("cuda", 12), ("xla", 8),
                                    ("xla", 12)])
def test_apply_expert_fc_matches_reference(impl, m):
    """Layer 1 of each planned expert tensor on the wide variant (packed
    encodings sliced per layer), skinny and wide capacity, against the
    reference's `apply_expert_fc`; and the dense plan's einsum."""
    got, want = _plans("bfloat16", impl, True)
    rng = np.random.default_rng(m)
    execute.reset_stats()
    for nm in ("we_gate", "we_up", "we_down"):
        lp = got.layers[nm]
        x = rng.standard_normal((lp.spec.experts, m, lp.spec.n_in))
        xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
        rlp = jax.tree.map(lambda a: a[1], want.layers[nm])
        y = execute.apply_expert_fc(xt, lp.layer(1))
        assert y.dtype == xt.dtype
        assert y.shape == (lp.spec.experts, m, lp.spec.n_out)
        _close(y, ref_execute.apply_expert_fc(xj, rlp), "bfloat16")
        dense = engine_plan.LayerPlan(
            dataclasses.replace(lp.spec, impl="dense"),
            lp.layer(1).dense_weights())
        _close(execute.apply_expert_fc(xt, dense),
               ref_execute.apply_expert_fc(xj, jax.tree.map(
                   lambda a: a[1], ref_plan.LayerPlan(
                       dataclasses.replace(want.layers[nm].spec,
                                           impl="dense"),
                       want.layers[nm].dense_weights()))), "bfloat16")
    stats = execute.stats()
    assert stats["expert_balanced_spmm"] == 3
    assert stats.get("decode_dispatch", 0) == (3 if m <= 8 else 0)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["sparse", "dense"])
def test_prefill_and_decode_match_reference(cd, which):
    ref_m, m, ref, got, prompt = _setup(cd)
    lj, cj = jax.jit(ref_m.prefill)(ref[which],
                                    {"tokens": jnp.asarray(prompt)})
    execute.reset_stats()
    with torch.no_grad():
        lt, ct = m.prefill(got[which], {"tokens": torch.from_numpy(prompt)})
    assert (execute.stats().get("expert_balanced_spmm", 0) > 0) == \
        (which == "sparse")
    _close(lt, lj, cd)
    new = np.array([[3], [250]])
    clen = np.full((2,), 8)
    ldj, _ = jax.jit(ref_m.decode_step)(
        ref[which], {"tokens": jnp.asarray(new),
                     "cache_len": jnp.asarray(clen, jnp.int32)},
        ref_merge(ref_m.init_cache(2, 12), cj))
    with torch.no_grad():
        ldt, _ = m.decode_step(
            got[which], {"tokens": torch.from_numpy(new),
                         "cache_len": torch.from_numpy(clen)},
            merge_prefill_cache(m.init_cache(2, 12), ct))
    _close(ldt, ldj, cd)


def test_greedy_tokens_equal_reference_f32():
    ref_m, m, ref, got, prompt = _setup("float32")
    want = ref_serve.greedy_generate(ref_m, ref["sparse"],
                                     jnp.asarray(prompt), 4, 12)
    toks = serve.greedy_generate(m, got["sparse"], torch.from_numpy(prompt),
                                 4, 12)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


def test_block_diffs_forces_reference_routing():
    """`sublayer_diffs` on MoE: every layer's sparse MoE sublayer takes the
    reference block's routing, and the own-routing agreement is a share;
    the increments and the block outputs within the bf16 tolerance."""
    _, m, _, got, prompt = _setup("bfloat16")
    with torch.no_grad():
        diffs = list(tr.sublayer_diffs(m.cfg, got["sparse"], got["dense"],
                                       torch.from_numpy(prompt)))
    assert len(diffs) == m.cfg.n_layers
    for d in diffs:
        assert d.out.shape == d.ref_out.shape and 0.0 <= d.agree <= 1.0
        assert [nm for nm, _, _ in d.increments] == ["attn", "moe"]
        for _, inc, want in d.increments:
            _close(inc, want.float().numpy(), "bfloat16")
        _close(d.out, d.ref_out.float().numpy(), "bfloat16")


@pytest.mark.parametrize("impl", ["cuda", "xla"])
def test_serve_main_moe_smoke_cpu(impl, tmp_path):
    report = tmp_path / "serve.json"
    res = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--impl", impl, "--batch", "2", "--prompt-len", "8",
                      "--gen-steps", "3", "--report", str(report)])
    plan = res["plan"]
    assert plan["family"] == "moe"
    assert plan["engine_stats"]["expert_balanced_spmm"] > 0
    assert plan["impl_mix"] == {impl: 10}
    assert plan["parity"]["layer_max_abs_diff"] <= 2e-2
    assert 0.0 <= plan["parity"]["routing_agreement"] <= 1.0
    # storage counts every expert of every layer
    cfg = get_smoke(ARCH)
    assert plan["dense_bytes"] == 2 * cfg.n_layers * (
        4 * cfg.d_model * cfg.n_heads * cfg.head_dim
        + 3 * cfg.d_model * cfg.d_ff * (cfg.n_experts
                                        + cfg.n_shared_experts))
    assert res["sparse"]["tokens_per_s"] > 0 and report.exists()


def test_kernels_reached_follow_the_plan():
    """The launch check demands only the kernels a plan reaches: no batched
    kernel for olmo-1b, the batched one for the MoE experts, none for the
    eager rungs; skinny or wide by each GEMM's M."""
    got, _ = _plans("bfloat16", "cuda")
    olmo_cfg = get_smoke("olmo-1b")
    olmo = engine_plan.plan_model(
        olmo_cfg, build_model(olmo_cfg, "cpu").init(0), sparsity=0.5,
        impl="cuda")
    assert serve.kernels_reached(olmo, 16, 2) == {
        "tiled_balanced_spmm", "tiled_balanced_spmm_skinny"}
    assert serve.kernels_reached(olmo, 8, 2) == {"tiled_balanced_spmm_skinny"}
    assert serve.kernels_reached(got, 64, 4) == {
        "tiled_balanced_spmm", "tiled_balanced_spmm_skinny",
        "tiled_balanced_spmm_batched"}
    assert serve.kernels_reached(_plans("bfloat16", "xla")[0], 64, 4) == set()


@pytest.mark.parametrize("wide", [False, True])
def test_expert_stacks_keep_pads_zero(wide):
    """The planned expert stacks ``[L, E, O, NB, KB]`` keep the premise the
    bf16 skinny kernels rely on (they read each block's live prefix): every
    slot from its block's count on is value 0 and index 0, in the port's
    plan and in the reference's."""
    got, want = _plans("bfloat16", "cuda", wide)
    for nm in ("we_gate", "we_up", "we_down"):
        for w in (got.layers[nm].weights, want.layers[nm].weights):
            values = np.asarray(_np(w.values) if hasattr(w.values, "numpy")
                                else np.asarray(w.values, np.float32))
            indices = np.asarray(w.indices)
            counts = np.asarray(w.counts)
            pad = np.arange(indices.shape[-1]) >= counts[..., None]
            # the smoke experts' blocks are full; the wide variant's are not
            assert pad.any() or not wide, nm
            assert (values[pad] == 0).all() and (indices[pad] == 0).all()


@pytest.mark.parametrize("planned", [False, True])
def test_unchosen_experts_see_zero_inputs(monkeypatch, planned):
    """At deepseek-moe-16b smoke, a decode step of batch 4 (four tokens):
    every expert no token chose gets an all-zero input to we_gate and we_up
    and so to we_down (silu(0) * 0 = 0), and the combine reads none of its
    output rows (garbage written there leaves y bitwise unchanged).  This
    is why the batched skinny kernel may write +0 for an expert whose x is
    all zero and read none of its weights.  The one place this differs
    from the plain version is a non-finite weight of such an expert: the
    plain version gives NaN (0 x NaN), the kernel +0.0.  So a NaN guard
    drill that poisoned only unrouted experts would trip on the CPU and
    not on the card; `testing.faults.inject_nan_output` poisons every
    expert, and chip_smoke's MoE drill holds the blamed layers of the
    kernels equal to those of the plain versions."""
    _, cfg, _, params = _params("float32")
    got_plan, _ = _plans("float32", "cuda")
    plan_layers = got_plan.per_layer[1] if planned else None
    xt = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (4, cfg.d_model)).astype(np.float32))
    seen = {}
    real = tr._expert_proj

    def record(lp, pl, name, x, cd):
        seen[name] = x.clone()
        return real(lp, pl, name, x, cd)

    monkeypatch.setattr(tr, "_expert_proj", record)
    y, _, (_, eidx) = tr._moe_tokens(cfg, _layer(params, 1), xt,
                                     plan_layers=plan_layers)
    chosen = set(eidx.reshape(-1).tolist())
    idle = [e for e in range(cfg.n_experts) if e not in chosen]
    assert idle                                   # the premise is exercised
    for nm in ("we_gate", "we_up", "we_down"):
        assert seen[nm].shape[0] == cfg.n_experts
        assert bool((seen[nm][idle] == 0).all()), nm
        assert bool(seen[nm][sorted(chosen)].abs().sum() > 0), nm

    def garbage(lp, pl, name, x, cd):
        out = real(lp, pl, name, x, cd)
        if name == "we_down":
            out = out.clone()
            out[idle] = 1e3
        return out

    monkeypatch.setattr(tr, "_expert_proj", garbage)
    y2, _, _ = tr._moe_tokens(cfg, _layer(params, 1), xt,
                              plan_layers=plan_layers)
    assert torch.equal(y, y2)
