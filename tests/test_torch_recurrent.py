"""The port's recurrent families (rwkv6-3b, zamba2-1.2b smoke) against the
JAX reference on identical weights (`params_from_numpy`): the WKV and SSD
recurrences (scan and chunked forms), `decode_attention`, prefill logits and
caches and two decode steps dense and planned (reference ``xla`` /
``pallas`` <-> port ``xla`` / ``cuda``), decode against prefill, greedy
tokens, `train_loss` and every gradient leaf, the plans field by field
(quant and objectives included), and the serving and training entry
points.  Tolerances: f32 1e-4, bf16 2e-2.  The reference's Pallas kernels
run in interpret mode; the port's wrappers run their plain versions on the
CPU.  The `cuda`-marked test holds rows 1 and 2 at the new families'
full-width projection shapes on the card."""
import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.models import zamba2 as ref_zamba2  # noqa: E402
from repro.models.api import merge_prefill_cache as ref_merge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import build_model, layers, rwkv6, zamba2  # noqa: E402,E501
from repro_torch.models.api import merge_prefill_cache  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import value_and_grad  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCHS = ("rwkv6-3b", "zamba2-1.2b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
IMPLS = {"cuda": "pallas", "xla": "xla"}
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
B, S = 2, 8                     # the prompt of the parity tests


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got) if torch.is_tensor(got) else got,
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _cfgs(arch, cd, **kw):
    return (dataclasses.replace(ref_get_smoke(arch), compute_dtype=cd,
                                sparse_serving=True, **kw),
            dataclasses.replace(get_smoke(arch), compute_dtype=cd,
                                sparse_serving=True, **kw))


@functools.lru_cache(maxsize=None)
def _params(arch):
    """The reference's seed-0 params and the port's copy."""
    ref_cfg, _ = _cfgs(arch, "float32")
    params_j = ref_build_model(ref_cfg).init(jax.random.key(0))
    return params_j, params_from_numpy(jax.tree.map(np.asarray, params_j),
                                       "cpu")


@functools.lru_cache(maxsize=None)
def _served(arch, cd, which):
    """Both packages' bundles and serving params: ``dense`` (the seed
    weights) or a plan on the ``xla`` / ``cuda`` rung (the reference's
    ``xla`` / ``pallas``)."""
    ref_cfg, cfg = _cfgs(arch, cd)
    params_j, params = _params(arch)
    if which != "dense":
        want = ref_plan.plan_model(ref_cfg, params_j, sparsity=0.5,
                                   impl=IMPLS[which], m_hint=16, decode_m=2)
        got = engine_plan.plan_model(cfg, params, sparsity=0.5, impl=which,
                                     m_hint=16, decode_m=2)
        params_j = {**params_j, "sparse_plan": want}
        params = {**params, "sparse_plan": got}
    return ref_build_model(ref_cfg), build_model(cfg, "cpu"), params_j, \
        params


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close_cache(got: dict, want: dict, cd):
    """Every cache leaf's dtype and shape as the reference's; at f32 its
    values within 1e-4 (a leaf stored in bf16, the shared block's K / V,
    within 2e-2, as the transformer's twin holds its cache).  At bf16 the
    values are not held elementwise: rounding compounds through the
    recurrent states past the first layer, dense or planned, and the
    logits carry the check."""
    assert sorted(got) == sorted(want)
    for key in want:
        dtype = str(got[key].dtype).removeprefix("torch.")
        assert dtype == str(want[key].dtype), key
        assert tuple(got[key].shape) == want[key].shape, key
        assert bool(torch.isfinite(got[key]).all()), key
        if cd == "float32":
            _close(got[key], want[key], TOL[dtype])


# ---------------------------------------------------------------------------
# the recurrences and the decode attention
# ---------------------------------------------------------------------------

def _wkv_inputs(t=64):
    r_ = np.random.default_rng(2)
    b, h, dh = 2, 2, 8
    r, k, v = (r_.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(r_.standard_normal((b, t, h, dh)) * 0.5 - 2.0)
               ).astype(np.float32)
    u = (r_.standard_normal((h, dh)) * 0.1).astype(np.float32)
    s0 = (r_.standard_normal((b, h, dh, dh)) * 0.2).astype(np.float32)
    return r, k, v, w, u, s0


def _ssd_inputs(t=64):
    r = np.random.default_rng(1)
    b, h, dh, n = 2, 2, 8, 4
    return (r.standard_normal((b, t, h, dh)).astype(np.float32),
            (r.random((b, t, h)) * 0.5 + 0.1).astype(np.float32),
            np.exp(-r.random((b, t, h)) * 0.8).astype(np.float32),
            r.standard_normal((b, t, n)).astype(np.float32),
            r.standard_normal((b, t, n)).astype(np.float32),
            (r.standard_normal((b, h, dh, n)) * 0.2).astype(np.float32))


@pytest.mark.parametrize("family", ["wkv", "ssd"])
def test_chunked_matches_scan(family):
    """Twins of `test_wkv_chunked_matches_scan` and
    `test_ssd_chunked_matches_scan`: the chunk-parallel forms equal the
    sequential recurrences (outputs and final state) at 1e-4."""
    if family == "wkv":
        args, scan, chunked = _wkv_inputs(), rwkv6._wkv_scan, \
            rwkv6._wkv_chunked
    else:
        args, scan, chunked = _ssd_inputs(), zamba2._ssd_scan, \
            zamba2._ssd_chunked
    args = [torch.from_numpy(a) for a in args]
    y1, s1 = scan(*args, chunk=16)
    y2, s2 = chunked(*args, chunk=16)
    _close(y2, _np(y1), 1e-4)
    _close(s2, _np(s1), 1e-4)


@pytest.mark.parametrize("t", [1, 24, 64])
@pytest.mark.parametrize("form", ["scan", "chunked"])
@pytest.mark.parametrize("family", ["wkv", "ssd"])
def test_recurrence_matches_reference(family, form, t):
    """Each port form against the reference's own at 1e-4, at chunk
    lengths that divide T and that do not (24 halves 16 to 8)."""
    mod, ref = (rwkv6, ref_rwkv6) if family == "wkv" else (zamba2,
                                                            ref_zamba2)
    name = {"wkv": "_wkv_", "ssd": "_ssd_"}[family] + form
    args = (_wkv_inputs if family == "wkv" else _ssd_inputs)(t)
    y, s = getattr(mod, name)(*(torch.from_numpy(a) for a in args), chunk=16)
    ry, rs = getattr(ref, name)(*(jnp.asarray(a) for a in args), chunk=16)
    _close(y, ry, 1e-4)
    _close(s, rs, 1e-4)


def test_causal_conv_matches_reference():
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 5, 6)).astype(np.float32)
    w = r.standard_normal((4, 6)).astype(np.float32)
    b = r.standard_normal((6,)).astype(np.float32)
    st = r.standard_normal((2, 3, 6)).astype(np.float32)
    y, ns = zamba2._causal_conv(*(torch.from_numpy(a) for a in (x, w, b, st)))
    ry, rns = ref_zamba2._causal_conv(*(jnp.asarray(a)
                                        for a in (x, w, b, st)))
    _close(y, ry, 1e-6)
    _close(ns, rns, 0.0)


def test_decode_attention_matches_reference():
    """`decode_attention` at f32 1e-4, unwritten slots (>= cache_len)
    masked even when they hold garbage, and a NaN score giving a NaN row as
    the reference's plain softmax does."""
    r = np.random.default_rng(4)
    q = r.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, 10, 2, 16)).astype(np.float32)
    clen = np.array([3, 10], np.int32)
    k[0, 3:] = 1e4                                   # unwritten: masked
    got = layers.decode_attention(*(torch.from_numpy(a)
                                    for a in (q, k, v, clen)))
    want = ref_layers.decode_attention(*(jnp.asarray(a)
                                         for a in (q, k, v, clen)))
    _close(got, want, 1e-4)
    q[1, 0, 0, 0] = np.nan
    got = layers.decode_attention(*(torch.from_numpy(a)
                                    for a in (q, k, v, clen)))
    want = ref_layers.decode_attention(*(jnp.asarray(a)
                                         for a in (q, k, v, clen)))
    np.testing.assert_array_equal(np.isnan(_np(got)),
                                  np.isnan(np.asarray(want)))
    nan = np.isnan(_np(got))
    assert nan[1, 0, 0].all() and nan.sum() == nan[1, 0, 0].size


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_reference_layout(arch):
    """`init_params`: the reference's keys, shapes and dtypes (zamba2's
    unstacked ``shared`` set included), and `params_from_numpy` carries
    the tree over array for array."""
    _, cfg = _cfgs(arch, "float32")
    mod = rwkv6 if arch == "rwkv6-3b" else zamba2
    mine = mod.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = jax.tree.map(np.asarray, _params(arch)[0])
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in flatten_with_paths(mine)} == \
        {p: (a.shape, str(a.dtype)) for p, a in flatten_with_paths(ref)}
    params_j, params = _params(arch)
    for p, t in flatten_with_paths(params):
        np.testing.assert_array_equal(t.numpy(),
                                      dict(flatten_with_paths(ref))[p])


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["dense", "xla", "cuda"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, cd, which):
    """Twins of `_family_parity` and `test_rwkv6_zamba2_decode_step_parity`:
    the prefill's logits and cache, then two decode steps' logits and
    caches on the merged full-length cache, within the dtype's tolerance
    (`_close_cache`)."""
    m_j, m, params_j, params = _served(arch, cd, which)
    tol = TOL[cd]
    prompt = _tokens(m.cfg, (B, S))
    execute.reset_stats()
    logits, pf = m.prefill(params, {"tokens": torch.from_numpy(prompt)})
    if which != "dense":
        assert execute.stats()["balanced_spmm"] > 0
    rlogits, rpf = jax.jit(m_j.prefill)(params_j,
                                        {"tokens": jnp.asarray(prompt)})
    _close(logits, rlogits, tol)
    _close_cache(pf, rpf, cd)
    cache = merge_prefill_cache(m.init_cache(B, S + 2), pf)
    rcache = ref_merge(m_j.init_cache(B, S + 2), rpf)
    steps = _tokens(m.cfg, (2, B, 1), seed=2)
    for i in range(2):
        clen = np.full((B,), S + i, np.int32)
        logits, cache = m.decode_step(
            params, {"tokens": torch.from_numpy(steps[i]),
                     "cache_len": torch.from_numpy(clen)}, cache)
        rlogits, rcache = jax.jit(m_j.decode_step)(
            params_j, {"tokens": jnp.asarray(steps[i]),
                       "cache_len": jnp.asarray(clen)}, rcache)
        _close(logits, rlogits, tol)
        _close_cache(cache, rcache, cd)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_reference_f32(arch):
    m_j, m, params_j, params = _served(arch, "float32", "cuda")
    prompt = _tokens(m.cfg, (B, S))
    got = serve.greedy_generate(m, params, torch.from_numpy(prompt), 4,
                                S + 4)
    want = ref_serve.greedy_generate(m_j, params_j, jnp.asarray(prompt), 4,
                                     S + 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["scan", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch, mode):
    """Twin of `test_decode_matches_prefill`: a decode step after an
    n-token prefill equals the prefill of n + 1 tokens (the shift, WKV, SSM
    and conv states and the shared block's KV carried through the cache),
    with the prefill's recurrence in either form."""
    cfg = dataclasses.replace(get_smoke(arch), ssm_mode=mode)
    m = build_model(cfg, "cpu")
    params = _params(arch)[1]
    n = 16
    tokens = torch.from_numpy(_tokens(cfg, (2, n + 1)))
    with torch.no_grad():
        full, _ = m.prefill(params, {"tokens": tokens})
        _, pf = m.prefill(params, {"tokens": tokens[:, :n]})
        cache = merge_prefill_cache(m.init_cache(2, n + 8), pf)
        dec, _ = m.decode_step(params, {
            "tokens": tokens[:, n:], "cache_len": torch.full((2,), n)},
            cache)
    _close(dec, _np(full), 2e-2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_loss(arch, mode):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch),
                                  compute_dtype="float32", ssm_mode=mode)
    tokens = _tokens(ref_cfg, (2, 32)).astype(np.int32)
    loss, grads = jax.value_and_grad(ref_build_model(ref_cfg).train_loss)(
        _params(arch)[0], {"tokens": jnp.asarray(tokens)})
    return tokens, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("mode", ["scan", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, mode):
    """`train_loss` and every gradient leaf against ``jax.grad`` at f32
    (1e-4), through both recurrence forms (each chunk recomputed in the
    backward, each block too under ``remat``)."""
    tokens, rloss, rgrads = _ref_loss(arch, mode)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32",
                              ssm_mode=mode)
    loss, grads = value_and_grad(build_model(cfg, "cpu").train_loss,
                                 _params(arch)[1],
                                 {"tokens": torch.from_numpy(tokens)})
    _close(float(loss), rloss, TOL["float32"])
    want = dict(flatten_with_paths(rgrads))
    got = flatten_with_paths(grads)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        _close(g, want[path], TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_on_the_cpu(arch, tmp_path):
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "32",
                      "--ckpt-dir", str(tmp_path)])
    assert res["status"] == "done" and res["step"] == 3
    assert np.isfinite(res["final_loss"])


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def _spec_fields(spec) -> dict:
    d = dataclasses.asdict(spec)
    d["impl"] = IMPLS.get(d["impl"], d["impl"])
    return d


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_match_reference(arch, quant):
    """Every `PlanSpec` field equal (blocks included: ``tune="off"``), the
    encodings array-equal and `masked_dense_params` equal, under every
    objective; zamba2's ``shared`` set is left alone; `plan_model` drops
    ``include_mlp`` for the recurrent planners."""
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    params_j, params = _params(arch)
    names = {"rwkv6-3b": engine_plan.RWKV6_PROJ_NAMES,
             "zamba2-1.2b": engine_plan.ZAMBA2_PROJ_NAMES}[arch]
    assert names == {"rwkv6-3b": ref_plan.RWKV6_PROJ_NAMES,
                     "zamba2-1.2b": ref_plan.ZAMBA2_PROJ_NAMES}[arch]
    for objective in ("latency", "dram", "energy", "balanced"):
        kw = dict(sparsity=0.5, m_hint=16, decode_m=2, quant=quant,
                  objective=objective, include_mlp=False)
        want = ref_plan.plan_model(ref_cfg, params_j, impl="pallas", **kw)
        got = engine_plan.plan_model(cfg, params, impl="cuda", **kw)
        assert sorted(got.layers) == sorted(want.layers) == sorted(names)
        assert got.meta == want.meta
        assert got.cost_summary() == want.cost_summary()
        for nm, lp in got.layers.items():
            assert _spec_fields(lp.spec) == \
                dataclasses.asdict(want.layers[nm].spec), (objective, nm)
            w, rw = lp.weights, want.layers[nm].weights
            for f in ("values", "indices", "counts", "scales", "perm"):
                a, ra = getattr(w, f, None), getattr(rw, f, None)
                assert (a is None) == (ra is None), (nm, f)
                if a is not None:
                    np.testing.assert_array_equal(_np(a),
                                                  np.asarray(ra, np.float32))
        dense = engine_plan.masked_dense_params(params, got)
        rdense = ref_plan.masked_dense_params(params_j, want)
        assert dict(flatten_with_paths(dense)).keys() == \
            dict(flatten_with_paths(rdense)).keys()
        for p, t in flatten_with_paths(dense):
            np.testing.assert_array_equal(
                _np(t), np.asarray(dict(flatten_with_paths(rdense))[p],
                                   np.float32))
    if arch == "zamba2-1.2b":
        assert all(dense["shared"][k] is params["shared"][k]
                   for k in params["shared"])


def test_plan_transformer_refuses_a_recurrent_family():
    _, cfg = _cfgs("rwkv6-3b", "float32")
    with pytest.raises(ValueError, match="plan_model"):
        engine_plan.plan_transformer(cfg, _params("rwkv6-3b")[1])


# ---------------------------------------------------------------------------
# the serving entry point
# ---------------------------------------------------------------------------

SERVE = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen-steps", "3"]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_recurrent_families_end_to_end(arch, capsys):
    """Twin of `test_serve_recurrent_families_end_to_end`: the plan runs the
    balanced kernels' path (``cuda``: their plain versions here) behind
    the per-block parity gate; ``--attn-only`` is noted and ignored."""
    res = serve.main(["--arch", arch, "--impl", "cuda", "--attn-only"]
                     + SERVE)
    plan = res["plan"]
    assert plan["family"] == {"rwkv6-3b": "ssm", "zamba2-1.2b": "hybrid"}[
        arch]
    assert plan["engine_stats"]["balanced_spmm"] > 0
    assert plan["parity"]["layer_max_abs_diff"] <= 2e-2
    assert plan["kernels_reached"] == ["tiled_balanced_spmm",
                                       "tiled_balanced_spmm_skinny"]
    assert res["sparse"]["tokens_per_s"] > 0
    assert "--attn-only is inapplicable" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_traffic_refused_for_recurrent_families(arch):
    with pytest.raises(SystemExit):
        serve.main(["--arch", arch, "--traffic"] + SERVE)


def test_serve_guard_nan_drill_on_zamba2():
    """``serve --guard --inject-nan`` on zamba2: the injected layer is
    blamed and quarantined, as on the transformer."""
    res = serve.main(["--arch", "zamba2-1.2b", "--impl", "cuda", "--guard",
                      "--inject-nan"] + SERVE)
    g = res["guard"]
    assert [e["event"] for e in g["events"]] == ["nan_trip"]
    assert g["events"][0]["poisoned_layers"] == [g["injected"]]
    assert g["quarantined"] == [g["injected"]]
    assert res["sparse"]["tokens_per_s"] > 0


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "from repro_torch.models import rwkv6, zamba2, api\n"
            "from repro_torch.launch import serve, train\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# ---------------------------------------------------------------------------
# on the card: rows 1 and 2 at the new families' projection shapes
# ---------------------------------------------------------------------------

# (O, N) of rwkv6-3b (wr.., ck, cv) and zamba2-1.2b (z / x, out_proj)
CARD_SHAPES = ((2560, 2560), (8960, 2560), (2560, 8960), (4096, 2048),
               (2048, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("o,n", CARD_SHAPES)
def test_kernels_at_recurrent_shapes_match_plain(o, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    from repro_torch.core.pruning import balanced_prune_rows
    from repro_torch.kernels import balanced_spmm as bs
    gen = torch.Generator(device="cuda").manual_seed(0)
    w = torch.randn((o, n), generator=gen, device="cuda") / n ** 0.5
    for dtype in (torch.bfloat16, torch.float32):
        _, mask = balanced_prune_rows(w, 0.5)
        tb = engine_plan.build_layer_plan("p", w.to(dtype), mask=mask,
                                          impl="cuda").weights
        for m, fn in ((128, bs.tiled_balanced_spmm),
                      (4, bs.tiled_balanced_spmm_skinny)):
            x = torch.randn((m, tb.nb * tb.bn), generator=gen,
                            device="cuda").to(dtype)
            _close(fn(x, tb).cpu(), _np(bs.tiled_balanced_spmm_plain(
                x, tb).cpu()), TOL["float32"])
