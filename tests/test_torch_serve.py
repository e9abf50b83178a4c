"""The port's dense transformer and serving entry point against the JAX
reference on olmo smoke, on identical weights (`params_from_numpy`):
prefill and one decode step within 1e-4 (f32 compute) / 2e-2 (bf16), both
on the sparse plan (reference ``pallas`` in interpret mode <-> port
``cuda``, plain version on the CPU) and on the masked-dense reference;
greedy tokens equal at f32."""
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
from repro.models.api import merge_prefill_cache as ref_merge  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.engine import execute  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.api import merge_prefill_cache, sublayer_diffs  # noqa: E402,E501
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


@functools.lru_cache(maxsize=None)
def _setup(cd):
    """Both packages' bundles, params (identical weights), sparse and
    masked-dense params, plus a numpy prompt."""
    ref_cfg = dataclasses.replace(ref_get_smoke("olmo-1b"),
                                  compute_dtype=cd, sparse_serving=True)
    cfg = dataclasses.replace(get_smoke("olmo-1b"), compute_dtype=cd,
                              sparse_serving=True)
    ref_m = ref_build_model(ref_cfg)
    params_j = ref_m.init(jax.random.key(0))
    m = build_model(cfg, "cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    plan_j = ref_plan.plan_transformer(ref_cfg, params_j, sparsity=0.5,
                                       impl="pallas", m_hint=16)
    plan = engine_plan.plan_transformer(cfg, params, sparsity=0.5,
                                        impl="cuda", m_hint=16)
    ref = {"sparse": {**params_j, "sparse_plan": plan_j},
           "dense": ref_plan.masked_dense_params(params_j, plan_j)}
    got = {"sparse": {**params, "sparse_plan": plan},
           "dense": engine_plan.masked_dense_params(params, plan)}
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    return ref_m, m, ref, got, prompt


def _close(got, want, cd):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL[cd],
                               atol=TOL[cd])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["sparse", "dense"])
def test_prefill_and_decode_match_reference(cd, which):
    ref_m, m, ref, got, prompt = _setup(cd)
    lj, cj = jax.jit(ref_m.prefill)(ref[which],
                                    {"tokens": jnp.asarray(prompt)})
    pt = torch.from_numpy(prompt)
    execute.reset_stats()
    with torch.no_grad():
        lt, ct = m.prefill(got[which], {"tokens": pt})
    assert (execute.stats().get("balanced_spmm", 0) > 0) == \
        (which == "sparse")
    _close(lt, lj, cd)
    np.testing.assert_allclose(ct["k"].float().numpy(),
                               np.asarray(cj["k"], np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])
    # one decode step of one new token per sequence on the merged cache
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


def test_overrun_guard_both_edges():
    _, m, _, got, prompt = _setup("float32")
    pt = torch.from_numpy(prompt)
    toks = serve.greedy_generate(m, got["dense"], pt, 4, 8 + 4)   # fits
    assert toks.shape == (2, 5)
    with pytest.raises(ValueError, match="overrun"):
        serve.greedy_generate(m, got["dense"], pt, 5, 8 + 4)


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_serve_main_smoke_cpu(impl, tmp_path):
    report = tmp_path / "serve.json"
    res = serve.main(["--arch", "olmo-1b", "--smoke", "--device", "cpu",
                      "--impl", impl, "--batch", "2", "--prompt-len", "8",
                      "--gen-steps", "3", "--report", str(report)])
    plan = res["plan"]
    assert plan["engine_stats"]["balanced_spmm"] > 0
    assert plan["impl_mix"] == {"xla" if impl == "auto" else "cuda": 7}
    assert plan["parity"]["layer_max_abs_diff"] <= 2e-2
    assert res["sparse"]["tokens_per_s"] > 0 and report.exists()


def test_parity_reports_the_gate_margin():
    """`_gate_excess` is how far the worst output lies past the gate
    ``tol + tol*|want|`` (at most 0 when `_compare` passes it, +inf on a
    non-finite output), and the parity report carries its largest value
    over every layer's sublayer increments, with the sublayer it came
    from."""
    want = torch.tensor([0.0, 1.0, -10.0])
    got = want + torch.tensor([0.01, 0.05, 0.1])
    # bounds 0.02, 0.04, 0.22: excesses -0.01, +0.01, -0.12
    assert serve._gate_excess(got, want, 2e-2) == pytest.approx(0.01, abs=1e-6)
    assert not serve._compare(got, want, 2e-2)[1]
    got[1] = 1.03
    assert serve._gate_excess(got, want, 2e-2) == pytest.approx(-0.01, abs=1e-6)
    assert serve._compare(got, want, 2e-2)[1]
    got[0] = float("nan")
    assert serve._gate_excess(got, want, 2e-2) == float("inf")
    _, m, _, got, prompt = _setup("float32")
    prompt = torch.from_numpy(prompt)
    parity = serve._parity_check(m, got["sparse"], got["dense"], prompt,
                                 tol=1e-4)
    with torch.no_grad():
        diffs = list(sublayer_diffs(m.cfg, got["sparse"], got["dense"],
                                    prompt))
    excess = {f"{d.block} {nm}": float(((g - w).abs()
                                        - (1e-4 + 1e-4 * w.abs())).max())
              for d in diffs for nm, g, w in d.increments}
    assert sorted(excess) == ["layer 0 attn", "layer 0 mlp", "layer 1 attn",
                              "layer 1 mlp"]
    assert parity["layer_gate_excess"] == pytest.approx(max(excess.values()))
    assert excess[parity["layer_gate_closest"]] == \
        parity["layer_gate_excess"]
    assert parity["layer_gate_excess"] <= 0.0
    assert parity["layer_max_abs_diff"] == pytest.approx(max(
        float((d.out - d.ref_out).abs().max()) for d in diffs))


def test_serve_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--gen-steps", "1"])


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join((str(SRC),
                                                        str(SRC.parent)))}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_serve_example_on_the_cpu(capsys):
    """``examples/torch_serve_sparse_lm.py --device cpu``: olmo-1b smoke
    served through the plan, the sparse projections' dispatches counted
    (and, with ``--impl cuda``, the kernels' plain versions reached);
    without ``--device cpu`` it raises here (no card)."""
    import importlib.util
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" \
        / "torch_serve_sparse_lm.py"
    spec = importlib.util.spec_from_file_location("torch_serve_example",
                                                  path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    res = example.main(["--device", "cpu", "--gen-steps", "4"])
    stats = res["plan"]["engine_stats"]
    assert stats["balanced_spmm"] > 0
    assert res["plan"]["model"] == "olmo-1b-smoke"
    assert res["plan"]["parity"]["layer_max_abs_diff"] <= 2e-2
    assert res["sparse"]["tokens_per_s"] > 0
    res = example.main(["--device", "cpu", "--gen-steps", "2",
                        "--impl", "cuda"])
    assert res["plan"]["impl_mix"] == {"cuda": 7}
    assert res["plan"]["engine_stats"]["balanced_spmm"] > 0
    assert "[serve/sparse]" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main([])


# ---------------------------------------------------------------------------
# serve's sublayer gate
# ---------------------------------------------------------------------------

def _bf16_block(inc, ref_inc, h=8.0):
    """A one-sublayer bf16 block on a residual of magnitude ``h``."""
    from repro_torch.models.api import BlockDiff
    res = torch.full((4,), h, dtype=torch.bfloat16)
    got = torch.tensor(inc, dtype=torch.bfloat16)
    want = torch.tensor(ref_inc, dtype=torch.bfloat16)
    return BlockDiff(block="layer 0", out=res + got, ref_out=res + want,
                     agree=None, increments=(("mlp", got, want),))


@pytest.mark.parametrize("case", ["residual_cancels", "increment_off_5pct"])
def test_gate_holds_the_increment_not_the_residual_sum(case):
    """`serve.gate_block` at the bf16 tolerance.  ``residual_cancels``:
    increments 1 ulp apart at magnitude ~8 that cancel the residual 8 to
    a small output; the block-output bound ``tol + tol*|out|`` fails on
    it, the increment gate passes.  ``increment_off_5pct``: an increment
    5% off fails."""
    tol = TOL["bfloat16"]
    if case == "residual_cancels":
        ulp = 2.0 ** -5                     # bf16 ulp on [4, 8)
        ref_inc = [-7.9375, -7.96875, -7.875, -7.90625]
        d = _bf16_block([r + ulp for r in ref_inc], ref_inc)
        assert float((d.increments[0][1].float()
                      - d.increments[0][2].float()).abs().max()) == ulp
        assert float(d.out.float().abs().max()) <= 0.25
        assert not serve._compare(d.out, d.ref_out, tol)[1]
        rows = serve.gate_block(d, tol)
        assert [r[0] for r in rows] == ["mlp", "output"]
        assert rows[0][2] and rows[0][3] < 0
        assert rows[1][2] and rows[1][3] > 0    # reported, finite: passes
    else:
        d = _bf16_block([1.05, -2.1, 0.525, 4.2], [1.0, -2.0, 0.5, 4.0],
                        h=0.0)
        rows = serve.gate_block(d, tol)
        assert not rows[0][2] and rows[0][3] > 0


def _fault_setup(arch, cd):
    """``arch``'s smoke bundle at ``cd`` with a clean ``cuda`` plan (the
    kernels' plain versions on the CPU), its masked-dense reference and a
    prompt."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=cd,
                              sparse_serving=True)
    bundle = build_model(cfg, "cpu")
    params = bundle.init(0)
    plan = engine_plan.plan_model(cfg, params, sparsity=0.5, impl="cuda",
                                  m_hint=16)
    ref = engine_plan.masked_dense_params(params, plan)
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)))
    return bundle, params, plan, ref, prompt


# (arch, the projection corrupted at stacked layer 1, the block and the
# sublayer the gate must name).  rwkv6's time mix is corrupted at its
# output projection: its r / k / v scale cancels in the per-head group norm
FAULT_SITES = [
    ("olmo-1b", "w_down", "layer 1 mlp"),
    ("olmo-1b", "wv", "layer 1 attn"),
    ("deepseek-moe-16b", "we_up", "layer 1 moe"),
    ("rwkv6-3b", "wo", "layer 1 time_mix"),
    ("rwkv6-3b", "cv", "layer 1 channel_mix"),
    ("zamba2-1.2b", "out_proj", "mamba 1 mamba"),
    ("musicgen-medium", "w_in", "layer 1 mlp"),
]


@pytest.mark.parametrize("fault", ["nan", "scaled"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,proj,where", FAULT_SITES)
def test_parity_check_names_a_corrupted_layer(arch, proj, where, cd, fault):
    """One stacked layer of one projection poisoned with NaN
    (`faults.inject_nan_output`) or its values doubled
    (`faults.scale_values`) trips serve's gate at both dtypes, and the
    error names that layer and sublayer (and, for a NaN, that block's
    non-finite output) alone; the clean plan passes."""
    from repro_torch.testing import faults
    bundle, params, plan, ref, prompt = _fault_setup(arch, cd)
    tol = TOL[cd]
    clean = serve._parity_check(bundle, {**params, "sparse_plan": plan},
                                ref, prompt, tol=tol)
    assert clean["layer_gate_excess"] <= 0.0
    inject = faults.inject_nan_output if fault == "nan" \
        else faults.scale_values
    bad, name = inject(plan, proj, index=1)
    assert name == proj
    with pytest.raises(AssertionError) as err:
        serve._parity_check(bundle, {**params, "sparse_plan": bad}, ref,
                            prompt, tol=tol)
    msg = str(err.value)
    named = msg.split(": ", 1)[1].split(";")[0].split(", ")
    block = where.rsplit(" ", 1)[0]
    assert named[0].startswith(where + " (max |diff|"), msg
    # only that block: its sublayer, and its output where it went NaN
    assert [n.split(" (")[0] for n in named[1:]] in (
        [], [block + " output"]), msg


def _ref_increments(arch, cfg_j, params_j, plan_j, d, h, positions):
    """The reference's sparse increments of block ``d`` on the port's own
    inputs: ``h`` (the block's input) and, for a second sublayer, ``h``
    plus the port's reference increment of the first.  zamba2's blocks
    fuse their residual adds, so their increments are ``block(x) - x`` at
    float32 (the shared block's with the other sublayer's output weight
    zeroed)."""
    from repro.models import rwkv6 as ref_rwkv6
    from repro.models import transformer as ref_tr
    from repro.models import zamba2 as ref_z
    kind, idx = d.block.split(" ")
    i = int(idx)

    def layer(tree):
        return jax.tree.map(lambda x: x[i], tree)
    lp = layer(params_j["blocks"]) if kind != "shared" else None
    plp = None if kind == "shared" else {nm: layer(p) for nm, p in
                                          plan_j.layers.items()}
    hj = jnp.asarray(h.float().numpy())
    mid = jnp.asarray((h + d.increments[0][2]).float().numpy())
    b = h.shape[0]
    if kind == "layer" and arch == "rwkv6-3b":
        d_, nh = cfg_j.d_model, cfg_j.d_model // cfg_j.rwkv_head_dim
        hd = cfg_j.rwkv_head_dim
        x = ref_rwkv6.layer_norm(hj, lp["ln1"], lp["ln1_b"])
        att = ref_rwkv6._time_mix(cfg_j, lp, x, jnp.zeros((b, d_)),
                                  jnp.zeros((b, nh, hd, hd)), None,
                                  plan_layers=plp)[0]
        x = ref_rwkv6.layer_norm(mid, lp["ln2"], lp["ln2_b"])
        ffn = ref_rwkv6._channel_mix(cfg_j, lp, x, jnp.zeros((b, d_)),
                                     plan_layers=plp)[0]
        return [att, ffn]
    if kind == "layer":
        pos = jnp.asarray(positions.numpy())
        attn = ref_tr._attn(cfg_j, lp, hj, pos, None, plan_layers=plp)[0]
        if cfg_j.family == "moe":
            mlp = ref_tr._moe(cfg_j, lp, mid, None, plan_layers=plp)[0]
        else:
            mlp = ref_tr._mlp(cfg_j, lp, mid, plan_layers=plp)
        return [attn, mlp]
    if kind == "mamba":
        _, nheads, conv_dim, _ = ref_z._dims(cfg_j)
        ssm = jnp.zeros((b, nheads, cfg_j.ssm_head_dim, cfg_j.ssm_state))
        conv = jnp.zeros((b, cfg_j.ssm_conv - 1, conv_dim))
        return [ref_z._mamba_block(cfg_j, lp, hj, ssm, conv,
                                   plan_layers=plp)[0] - hj]
    sp = params_j["shared"]
    pos = jnp.asarray(positions.numpy())
    attn = ref_z._shared_attn(
        cfg_j, {**sp, "w_down": jnp.zeros_like(sp["w_down"])}, hj, pos,
        None)[0] - hj
    mlp = ref_z._shared_attn(
        cfg_j, {**sp, "wo": jnp.zeros_like(sp["wo"])}, mid, pos,
        None)[0] - mid
    return [attn, mlp]


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b", "rwkv6-3b",
                                  "zamba2-1.2b", "musicgen-medium"])
def test_clean_plan_increments_match_reference(arch):
    """A clean ``cuda`` plan of each family on the reference's converted
    smoke weights passes serve's gate at float32 and bfloat16, and at
    float32 every sublayer increment of it equals the reference's sparse
    plan's (``pallas`` in interpret mode) on the same inputs within
    1e-4."""
    from repro.engine import plan as ref_plan_mod
    from repro.models import build_model as ref_build
    for cd in ("bfloat16", "float32"):
        cfg_j = dataclasses.replace(ref_get_smoke(arch), compute_dtype=cd,
                                    sparse_serving=True)
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype=cd,
                                  sparse_serving=True)
        params_j = ref_build(cfg_j).init(jax.random.key(0))
        params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
        plan_j = ref_plan_mod.plan_model(cfg_j, params_j, sparsity=0.5,
                                         impl="pallas", m_hint=16)
        plan = engine_plan.plan_model(cfg, params, sparsity=0.5,
                                      impl="cuda", m_hint=16)
        sparse = {**params, "sparse_plan": plan}
        ref = engine_plan.masked_dense_params(params, plan)
        prompt = torch.from_numpy(
            np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)))
        bundle = build_model(cfg, "cpu")
        parity = serve._parity_check(bundle, sparse, ref, prompt,
                                     tol=TOL[cd])
        assert parity["layer_gate_excess"] <= 0.0
        if cd != "float32":
            continue
        positions = torch.arange(8)[None].expand(2, 8)
        h = ref["embed"][prompt].float()
        n = 0
        with torch.no_grad():
            for d in sublayer_diffs(cfg, sparse, ref, prompt):
                want = _ref_increments(arch, cfg_j, params_j, plan_j, d, h,
                                       positions)
                for (name, got, _), w in zip(d.increments, want, strict=True):
                    np.testing.assert_allclose(
                        got.numpy(), np.asarray(w, np.float32),
                        rtol=TOL[cd], atol=TOL[cd],
                        err_msg=f"{d.block} {name}")
                    n += 1
                h = d.ref_out
        assert n == {"zamba2-1.2b": 8}.get(arch, 2 * cfg.n_layers)
