"""The port's audio and VLM frontends (musicgen-medium, internvl2-2b smoke)
against the JAX reference on identical weights (`params_from_numpy`):
`input_specs` for every arch x shape cell, the ``frontend_proj`` init,
prefill logits with ``frontend_embed`` dense and planned (reference
``pallas`` <-> port ``cuda``), the plans, `train_loss` and every gradient
leaf with the frontend positions masked out of the loss, the per-layer
comparison with a frontend, and the serving entry point (static and
``--traffic``).  Tolerances: f32 1e-4, bf16 2e-2.  The reference's Pallas
kernels run in interpret mode; the port's wrappers run their plain
versions on the CPU."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke  # noqa: E402,E501
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, build_model, transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import value_and_grad  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

FRONTEND_ARCHS = ("musicgen-medium", "internvl2-2b")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S = 2, 16                 # a prompt longer than the 8 frontend rows


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
    ref_cfg, _ = _cfgs(arch, "float32")
    params_j = ref_build_model(ref_cfg).init(jax.random.key(0))
    return params_j, params_from_numpy(jax.tree.map(np.asarray, params_j),
                                       "cpu")


def _batch(cfg, seed=1, s=S):
    """Tokens and seeded bf16 frontend rows (numpy, as both take them)."""
    r = np.random.default_rng(seed)
    tokens = r.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    fe = r.standard_normal((B, cfg.n_frontend_tokens, cfg.frontend_dim))
    return tokens, jnp.asarray(fe, jnp.bfloat16)


def _port_batch(tokens, fe):
    return {"tokens": torch.from_numpy(tokens),
            "frontend_embed": params_from_numpy(np.asarray(fe), "cpu")}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Every arch x shape cell: the reference's keys, shapes and dtypes, as
    tensors on the meta device."""
    got = api.input_specs(get_config(arch), SHAPES[shape])
    want = ref_api.input_specs(get_config(arch), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for key, spec in want.items():
        assert got[key].device.type == "meta"
        assert tuple(got[key].shape) == spec.shape, key
        assert str(got[key].dtype).removeprefix("torch.") == \
            str(spec.dtype), key


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_init_params_carry_frontend_proj(arch):
    """The frontend branch of `init_params` (``frontend_proj``, drawn by
    `layers.dense_init` at 1/sqrt(frontend_dim)) in the reference's layout,
    and `params_from_numpy` carries it over."""
    _, cfg = _cfgs(arch, "float32")
    mine = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    ref = jax.tree.map(np.asarray, _params(arch)[0])
    assert {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in flatten_with_paths(mine)} == \
        {p: (a.shape, str(a.dtype)) for p, a in flatten_with_paths(ref)}
    np.testing.assert_array_equal(_params(arch)[1]["frontend_proj"].numpy(),
                                  ref["frontend_proj"])
    # a larger draw for the scale: unit normals over sqrt(fan-in)
    big = dataclasses.replace(cfg, frontend_dim=1024, d_model=256)
    fp = transformer.init_params(big, torch.Generator().manual_seed(0),
                                 "cpu")["frontend_proj"]
    assert abs(float(fp.std()) * 32 - 1) < 0.05


@functools.lru_cache(maxsize=None)
def _served(arch, cd, which):
    ref_cfg, cfg = _cfgs(arch, cd)
    params_j, params = _params(arch)
    if which == "cuda":
        want = ref_plan.plan_model(ref_cfg, params_j, sparsity=0.5,
                                   impl="pallas", m_hint=32, decode_m=2)
        got = engine_plan.plan_model(cfg, params, sparsity=0.5, impl="cuda",
                                     m_hint=32, decode_m=2)
        params_j = {**params_j, "sparse_plan": want}
        params = {**params, "sparse_plan": got}
    return ref_build_model(ref_cfg), build_model(cfg, "cpu"), params_j, \
        params


@pytest.mark.parametrize("which", ["dense", "cuda"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefill_with_frontend_matches_reference(arch, cd, which):
    """A prefill with ``frontend_embed``: the logits against the
    reference's within the dtype's tolerance, at f32 the K / V cache too
    (bf16 by construction: 2e-2; at bf16 compute rounding compounds over
    the layers into it, as `test_torch_recurrent._close_cache` says), and
    the frontend rows change the result; then one decode step on the
    merged cache (decode takes no frontend)."""
    m_j, m, params_j, params = _served(arch, cd, which)
    tokens, fe = _batch(m.cfg)
    execute.reset_stats()
    with torch.no_grad():
        logits, cache = m.prefill(params, _port_batch(tokens, fe))
        plain, _ = m.prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert (execute.stats().get("balanced_spmm", 0) > 0) == (which == "cuda")
    rlogits, rcache = jax.jit(m_j.prefill)(
        params_j, {"tokens": jnp.asarray(tokens), "frontend_embed": fe})
    _close(logits, rlogits, TOL[cd])
    for key in ("k", "v"):
        assert cache[key].dtype == torch.bfloat16
        if cd == "float32":
            _close(cache[key], rcache[key], TOL["bfloat16"])
    assert float((logits - plain).abs().max()) > 10 * TOL[cd]
    new, clen = tokens[:, :1], np.full((B,), S, np.int32)
    with torch.no_grad():
        dec, _ = m.decode_step(params, {
            "tokens": torch.from_numpy(new),
            "cache_len": torch.from_numpy(clen)},
            api.merge_prefill_cache(m.init_cache(B, S + 4), cache))
    rdec, _ = jax.jit(m_j.decode_step)(
        params_j, {"tokens": jnp.asarray(new), "cache_len": jnp.asarray(clen)},
        ref_api.merge_prefill_cache(m_j.init_cache(B, S + 4), rcache))
    _close(dec, rdec, TOL[cd])


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_plans_match_reference(arch):
    """The audio and vlm families plan through `plan_transformer`: the
    reference's layers, specs and encodings (``frontend_proj`` stays
    dense, as every non-stacked leaf)."""
    got = _served(arch, "bfloat16", "cuda")[3]["sparse_plan"]
    want = _served(arch, "bfloat16", "cuda")[2]["sparse_plan"]
    assert sorted(got.layers) == sorted(want.layers)
    assert got.meta == want.meta
    for nm, lp in got.layers.items():
        rw = want.layers[nm].weights
        for f in ("values", "indices", "counts"):
            np.testing.assert_array_equal(
                _np(getattr(lp.weights, f)),
                np.asarray(getattr(rw, f), np.float32))
        assert lp.spec.block_k == want.layers[nm].spec.block_k
    dense = engine_plan.masked_dense_params(_params(arch)[1], got)
    assert dense["frontend_proj"] is _params(arch)[1]["frontend_proj"]


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_block_diffs_with_frontend(arch):
    """The teacher-forced sublayer comparison takes ``frontend_embed``
    (chip_smoke's frontend check): the plan against its masked-dense
    reference within 2e-2 at every sublayer and block output at bf16;
    with the frontend the first layer's input is the projected rows."""
    _, m, _, params = _served(arch, "bfloat16", "cuda")
    tokens, fe = _batch(m.cfg)
    ref = engine_plan.masked_dense_params(params, params["sparse_plan"])
    batch = _port_batch(tokens, fe)
    with torch.no_grad():
        diffs = list(transformer.sublayer_diffs(
            m.cfg, params, ref, batch["tokens"],
            frontend_embed=batch["frontend_embed"]))
        plain = next(transformer.sublayer_diffs(m.cfg, params, ref,
                                                batch["tokens"]))
    assert len(diffs) == m.cfg.n_layers
    for d in diffs:
        for _, inc, want in d.increments:
            _close(inc, _np(want), TOL["bfloat16"])
        _close(d.out, _np(d.ref_out), TOL["bfloat16"])
        assert d.agree is None
    assert float((diffs[0].ref_out - plain.ref_out).abs().max()) > 0


@functools.lru_cache(maxsize=None)
def _ref_loss(arch, n_front):
    ref_cfg = dataclasses.replace(ref_get_smoke(arch),
                                  compute_dtype="float32")
    tokens, fe = _batch(ref_cfg, s=32)
    batch = {"tokens": jnp.asarray(tokens)}
    if n_front:
        batch["frontend_embed"] = fe[:, :n_front]
    loss, grads = jax.value_and_grad(ref_build_model(ref_cfg).train_loss)(
        _params(arch)[0], batch)
    return tokens, fe, float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("n_front", [0, 1, 8])
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_train_loss_and_grads_match_reference(arch, n_front):
    """Twin of `test_musicgen_frontend_positions_masked`: `train_loss` and
    every gradient leaf (``frontend_proj``'s included) against
    ``jax.grad`` at f32 (1e-4), with n frontend rows (their n - 1
    positions out of the loss) or none."""
    tokens, fe, rloss, rgrads = _ref_loss(arch, n_front)
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    batch = _port_batch(tokens, fe[:, :n_front])
    if not n_front:
        del batch["frontend_embed"]
    loss, grads = value_and_grad(build_model(cfg, "cpu").train_loss,
                                 _params(arch)[1], batch)
    _close(float(loss), rloss, TOL["float32"])
    want = dict(flatten_with_paths(rgrads))
    got = flatten_with_paths(grads)
    assert sorted(p for p, _ in got) == sorted(want)
    for path, g in got:
        _close(g, want[path], TOL["float32"])
    if not n_front:
        assert float(grads["frontend_proj"].abs().max()) == 0.0


SERVE = ["--smoke", "--device", "cpu", "--impl", "cuda", "--batch", "2",
         "--prompt-len", "8", "--gen-steps", "3"]


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_serve_frontend_archs_end_to_end(arch):
    res = serve.main(["--arch", arch] + SERVE)
    plan = res["plan"]
    assert plan["family"] == {"musicgen-medium": "audio",
                              "internvl2-2b": "vlm"}[arch]
    assert plan["engine_stats"]["balanced_spmm"] > 0
    assert plan["parity"]["layer_max_abs_diff"] <= 2e-2
    assert res["sparse"]["tokens_per_s"] > 0


def test_serve_traffic_on_musicgen():
    """The audio family passes the continuous-batching runtime's gate (the
    reference's behaviour): paged vs contiguous exactly equal."""
    res = serve.main(["--arch", "musicgen-medium", "--traffic",
                      "--requests", "4", "--slots", "2"] + SERVE)
    assert res["traffic"]["parity_max_abs_diff"] == 0.0
    assert res["traffic"]["continuous"]["sustained_tok_per_s"] > 0
