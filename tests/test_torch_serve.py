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
from repro_torch.models.api import block_diffs, merge_prefill_cache  # noqa: E402,E501
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
    """`_gate_excess` is how far the worst output lies past the per-layer
    gate ``tol + tol*|want|`` (at most 0 when `_compare` passes it), and
    the parity report carries its largest value over the layers."""
    want = torch.tensor([0.0, 1.0, -10.0])
    got = want + torch.tensor([0.01, 0.05, 0.1])
    # bounds 0.02, 0.04, 0.22: excesses -0.01, +0.01, -0.12
    assert serve._gate_excess(got, want, 2e-2) == pytest.approx(0.01, abs=1e-6)
    assert not serve._compare(got, want, 2e-2)[1]
    got[1] = 1.03
    assert serve._gate_excess(got, want, 2e-2) == pytest.approx(-0.01, abs=1e-6)
    assert serve._compare(got, want, 2e-2)[1]
    _, m, _, got, prompt = _setup("float32")
    prompt = torch.from_numpy(prompt)
    parity = serve._parity_check(m, got["sparse"], got["dense"], prompt,
                                 tol=1e-4)
    with torch.no_grad():
        diffs = block_diffs(m.cfg, got["sparse"], got["dense"], prompt)
    excess = max(float(((g - w).abs() - (1e-4 + 1e-4 * w.abs())).max())
                 for g, w, _ in diffs)
    assert parity["layer_gate_excess"] == pytest.approx(excess)
    assert parity["layer_gate_excess"] <= 0.0


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
