"""The port's analytical Sense core against the JAX reference: bitmap
compression, the Adaptive Dataflow Configuration DRAM model, the paper's
network tables, channel clustering, the mapping, the systolic cycle and
energy model and the deployment cost model — on identical (numpy-seeded)
inputs every output must be *identical* (``==``: the Tab. II choices, the
cycle counts, the DRAM bits).  Then the port's own twins of
`test_paper_claims.py`, `test_systolic_model.py` and
`test_paper_examples.py` at those files' bands."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import clustering as ref_clustering  # noqa: E402
from repro.core import compression as ref_compression  # noqa: E402
from repro.core import dataflow as ref_dataflow  # noqa: E402
from repro.core import mapping as ref_mapping  # noqa: E402
from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import systolic as ref_systolic  # noqa: E402
from repro.launch import cost_model as ref_cost  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro_torch.core import clustering, compression, dataflow, mapping  # noqa: E402,E501
from repro_torch.core import pruning, systolic  # noqa: E402
from repro_torch.core.clustering import (cluster_channels,  # noqa: E402
                                         grouped_step_costs, schedule_cycles)
from repro_torch.core.compression import (bitmap_compress,  # noqa: E402
                                          decode_locations)
from repro_torch.core.dataflow import (LayerSpec, choose_dataflow,  # noqa: E402,E501
                                       conv_tiling, dram_access_rif,
                                       dram_access_rwf)
from repro_torch.core.mapping import (loop_nest, oc_visit_order,  # noqa: E402
                                      plan_layer)
from repro_torch.core.pruning import balanced_prune_conv, nze_counts  # noqa: E402,E501
from repro_torch.core.systolic import (SystolicConfig,  # noqa: E402
                                       conv_cycles_sliced, fc_cycles,
                                       layer_perf, network_perf,
                                       synth_ifm_nze, synth_weight_slices)
from repro_torch.launch import cost_model  # noqa: E402
from repro_torch.launch.cost_model import (DEPLOYMENTS,  # noqa: E402
                                           adc_reduction, network_cost)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.cnn import PAPER_NETWORKS, network_layers  # noqa: E402,E501

ZCU102 = DEPLOYMENTS["zcu102"]
NETS = ("alexnet", "vgg16", "resnet50", "googlenet", "vgg16_c10",
        "vgg16_c100")
ACCELS = ("sense", "swallow", "fesa", "spots", "dense")
BUFFERS = (None, 160 * 36 * 1024, 1)


def _plain(v):
    """A comparable form of a result of either package: dataclasses by
    field (their classes differ), arrays and tensors as numpy."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if isinstance(v, torch.Tensor):
        return ("array", v.cpu().numpy().tolist())
    if isinstance(v, (np.ndarray, jnp.ndarray)) or hasattr(v, "__array__"):
        return ("array", np.asarray(v).tolist())
    return v


def _same(got, want):
    assert _plain(got) == _plain(want)


# ---------------------------------------------------------------------------
# Part A against the reference: identical outputs
# ---------------------------------------------------------------------------

def test_compression_codecs_identical():
    rng = np.random.default_rng(0)
    blk = (rng.standard_normal((7, 7))
           * (rng.random((7, 7)) < 0.4)).astype(np.float32)
    c = compression.bitmap_compress(blk)
    rc = ref_compression.bitmap_compress(blk)
    _same(c, rc)
    np.testing.assert_array_equal(compression.bitmap_decompress(c), blk)
    np.testing.assert_array_equal(ref_compression.bitmap_decompress(rc),
                                  compression.bitmap_decompress(c))
    got = compression.bitmap_compress_padded(torch.from_numpy(blk))
    want = ref_compression.bitmap_compress_padded(jnp.asarray(blk))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        compression.bitmap_decompress_padded(*got).numpy(), blk)
    got = decode_locations(torch.from_numpy(blk != 0))
    want = ref_compression.decode_locations(jnp.asarray(blk != 0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    w = rng.standard_normal((12, 9)) * (rng.random((12, 9)) < 0.3)
    _same(compression.compress_fc_columns(w),
          ref_compression.compress_fc_columns(w))
    ifm = rng.standard_normal((3, 16, 15)) * (rng.random((3, 16, 15)) < 0.5)
    wc = rng.standard_normal((4, 3, 3, 3)) * (rng.random((4, 3, 3, 3)) < 0.5)
    assert compression.storage_bits_conv(ifm, wc) == \
        ref_compression.storage_bits_conv(ifm, wc)


@pytest.mark.parametrize("numel,nnz,bits", [(49, 20, 16), (1024, 0, 8),
                                            (9, 9, 32)])
def test_compression_bit_models_identical(numel, nnz, bits):
    assert compression.compressed_bits(numel, nnz, elem_bits=bits) == \
        ref_compression.compressed_bits(numel, nnz, elem_bits=bits)
    assert compression.compression_ratio(numel, nnz, elem_bits=bits) == \
        ref_compression.compression_ratio(numel, nnz, elem_bits=bits)
    for args in ((numel, nnz + 1, 4096), (3, 1, 1), (8, 4, 2)):
        assert compression.balanced_flat_bits(*args, elem_bits=bits) == \
            ref_compression.balanced_flat_bits(*args, elem_bits=bits)
    for args in ((numel, 3, 24, 128), (5, 1, 8, 1), (7, 2, 16, 20)):
        assert compression.balanced_tiled_bits(*args, elem_bits=bits) == \
            ref_compression.balanced_tiled_bits(*args, elem_bits=bits)


@pytest.mark.parametrize("net", NETS)
def test_network_tables_identical(net):
    for accel in ACCELS + ("unknown",):
        _same(network_layers(net, accel), ref_cnn.network_layers(net, accel))
    assert cnn.TAB5_SPARSITY == ref_cnn.TAB5_SPARSITY
    assert PAPER_NETWORKS == ref_cnn.PAPER_NETWORKS


@pytest.mark.parametrize("net", PAPER_NETWORKS)
def test_dataflow_choices_identical(net):
    """Every layer's RIF/RWF/ON_CHIP choice and DRAM bits (Tab. II's rule)
    under both dataflows, three buffer sizes and two tilings."""
    layers = network_layers(net, "sense")
    for buf in BUFFERS:
        for n_is, n_pe in ((7, 32), (4, 16)):
            kw = dict(n_is=n_is, n_pe=n_pe, weight_buffer_bits=buf)
            for ls, rls in zip(layers, ref_cnn.network_layers(net, "sense")):
                assert ls.h_o == rls.h_o and ls.macs == rls.macs
                _same(choose_dataflow(ls, **kw),
                      ref_dataflow.choose_dataflow(rls, **kw))
                _same(dataflow.swallow_dataflow(ls, **kw),
                      ref_dataflow.swallow_dataflow(rls, **kw))
                t = conv_tiling(ls, n_is=n_is, n_pe=n_pe)
                assert dram_access_rif(100, 7, t) == \
                    ref_dataflow.dram_access_rif(100, 7, t)
                assert dram_access_rwf(100, 7, t) == \
                    ref_dataflow.dram_access_rwf(100, 7, t)
                for c in (True, False):
                    assert dataflow.ifm_storage_bits(ls, compressed=c) == \
                        ref_dataflow.ifm_storage_bits(rls, compressed=c)
                    assert dataflow.weight_storage_bits(ls, compressed=c) \
                        == ref_dataflow.weight_storage_bits(rls, compressed=c)
            for adaptive in (True, False):
                _same(dataflow.network_dram_access(layers, adaptive=adaptive,
                                                   **kw),
                      ref_dataflow.network_dram_access(
                          ref_cnn.network_layers(net, "sense"),
                          adaptive=adaptive, **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clustering_identical(seed):
    """Integer NZE counts tie constantly: the port's stable sort must keep
    the reference's tie order."""
    rng = np.random.default_rng(seed)
    ifm = (rng.standard_normal((37, 6, 5))
           * (rng.random((37, 6, 5)) < 0.5)).astype(np.float32)
    nze = rng.integers(0, 6, size=37).astype(np.int32)
    for axis in (0, 1, 2):
        got = clustering.channel_nze_counts(torch.from_numpy(ifm),
                                            channel_axis=axis)
        want = ref_clustering.channel_nze_counts(jnp.asarray(ifm),
                                                 channel_axis=axis)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _same(clustering.clustering_report(torch.from_numpy(ifm), 4,
                                           channel_axis=axis),
              ref_clustering.clustering_report(jnp.asarray(ifm), 4,
                                               channel_axis=axis))
    np.testing.assert_array_equal(
        cluster_channels(torch.from_numpy(nze)).numpy(),
        np.asarray(ref_clustering.cluster_channels(jnp.asarray(nze))))
    for group in (1, 2, 5, 32):
        for cl in (True, False):
            np.testing.assert_array_equal(
                grouped_step_costs(torch.from_numpy(nze), group,
                                   clustered=cl).numpy(),
                np.asarray(ref_clustering.grouped_step_costs(
                    jnp.asarray(nze), group, clustered=cl)))
            assert int(schedule_cycles(torch.from_numpy(nze), group,
                                       clustered=cl)) == \
                int(ref_clustering.schedule_cycles(jnp.asarray(nze), group,
                                                   clustered=cl))
    perm = rng.permutation(37).astype(np.int32)
    np.testing.assert_array_equal(
        clustering.inverse_permutation(torch.from_numpy(perm)).numpy(),
        np.asarray(ref_clustering.inverse_permutation(jnp.asarray(perm))))
    np.testing.assert_array_equal(
        clustering.crossbar_reorder(torch.from_numpy(ifm),
                                    torch.from_numpy(perm)).numpy(),
        np.asarray(ref_clustering.crossbar_reorder(jnp.asarray(ifm),
                                                   jnp.asarray(perm))))
    x = np.round(rng.standard_normal((5, 12)), 1).astype(np.float32)
    for keep in (1, 4, 12):
        np.testing.assert_array_equal(
            clustering.activation_topk(torch.from_numpy(x), keep).numpy(),
            np.asarray(ref_clustering.activation_topk(jnp.asarray(x), keep)))
    w = (rng.standard_normal((20, 37))
         * (rng.random((20, 37)) < 0.3)).astype(np.float32)
    _same(clustering.fc_column_clustering(torch.from_numpy(w), 8),
          ref_clustering.fc_column_clustering(jnp.asarray(w), 8))


def test_pruning_diagnostics_identical():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 10)) * (rng.random((6, 10)) < 0.4)
    for axis in (0, -1, (0, 1)):
        np.testing.assert_array_equal(
            nze_counts(torch.from_numpy(x), axis).numpy(),
            np.asarray(ref_pruning.nze_counts(jnp.asarray(x), axis)))
    for nze in ([3, 3, 3], [1, 5, 2, 0], [0, 0]):
        assert pruning.load_imbalance(torch.tensor(nze)) == \
            ref_pruning.load_imbalance(jnp.asarray(nze))


@pytest.mark.parametrize("net", PAPER_NETWORKS)
def test_mapping_identical(net):
    layers = network_layers(net, "sense")
    ref_layers = ref_cnn.network_layers(net, "sense")
    for buf in BUFFERS:
        _same(mapping.plan_network(net, layers, weight_buffer_bits=buf),
              ref_mapping.plan_network(net, ref_layers,
                                       weight_buffer_bits=buf))
    small = [ls for ls in layers if ls.kind == "conv"
             and ls.h_i <= 28 and ls.c_o <= 256][:3] + [layers[-1]]
    rsmall = [r for r in ref_layers if r.name in {s.name for s in small}]
    for ls, rls in zip(small, rsmall):
        for buf in (None, 1):
            p = plan_layer(ls, weight_buffer_bits=buf)
            r = ref_mapping.plan_layer(rls, weight_buffer_bits=buf)
            assert (p.t_oc_outer, p.t_oc_inner) == (r.t_oc_outer,
                                                    r.t_oc_inner)
            assert list(loop_nest(p)) == list(ref_mapping.loop_nest(r))
            assert oc_visit_order(p) == ref_mapping.oc_visit_order(r)


def _conv(**kw):
    base = dict(name="l", kind="conv", h_i=28, w_i=28, c_i=70, c_o=40,
                h_k=3, w_k=3, padding=1, ifm_sparsity=0.5, w_sparsity=0.5)
    base.update(kw)
    return LayerSpec(**base), ref_dataflow.LayerSpec(**base)


@pytest.mark.parametrize("accel", ACCELS)
def test_systolic_primitives_identical(accel):
    ls, rls = _conv()
    for seed in (0, 5):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        nzei = synth_ifm_nze(ls, accel, a, n_is=7)
        np.testing.assert_array_equal(
            nzei, ref_systolic.synth_ifm_nze(rls, accel, b, n_is=7))
        w = synth_weight_slices(ls, accel, a)
        np.testing.assert_array_equal(
            w, ref_systolic.synth_weight_slices(rls, accel, b))
        np.testing.assert_array_equal(
            systolic.synth_weight_nze(ls, accel, a),
            ref_systolic.synth_weight_nze(rls, accel, b))
        for cl in (True, False):
            for sync in ("block", "step"):
                assert conv_cycles_sliced(nzei, w, n_pe=16, cluster_ifm=cl,
                                          sync=sync) == \
                    ref_systolic.conv_cycles_sliced(nzei, w, n_pe=16,
                                                    cluster_ifm=cl,
                                                    sync=sync)
            assert systolic.conv_cycles(nzei[:, 0], w.sum(1), n_pe=16,
                                        cluster_ifm=cl, sort_weights=cl) \
                == ref_systolic.conv_cycles(nzei[:, 0], w.sum(1), n_pe=16,
                                            cluster_ifm=cl, sort_weights=cl)
            mask = a.random(70) < 0.6
            cols = a.integers(1, 9, size=70)
            assert fc_cycles(mask, cols, n_pe=8, clustered=cl) == \
                ref_systolic.fc_cycles(mask, cols, n_pe=8, clustered=cl)
        for adaptive in (True, False):
            _same(layer_perf(ls, accel, SystolicConfig(),
                             np.random.default_rng(seed),
                             adaptive_dataflow=adaptive),
                  ref_systolic.layer_perf(rls, accel,
                                          ref_systolic.SystolicConfig(),
                                          np.random.default_rng(seed),
                                          adaptive_dataflow=adaptive))


@pytest.mark.parametrize("net,accels", [
    ("alexnet", ACCELS), ("vgg16", ("sense", "swallow")),
    ("googlenet", ("sense", "fesa", "spots")), ("resnet50", ("sense",))])
def test_network_perf_identical(net, accels):
    """Whole-network cycles, latency, DRAM bits, PE utilization and energy
    (seeded synthesis) equal to the reference's."""
    assert dataclasses.asdict(SystolicConfig()) == \
        dataclasses.asdict(ref_systolic.SystolicConfig())
    for accel in accels:
        _same(network_perf(network_layers(net, accel), accel, seed=0),
              ref_systolic.network_perf(ref_cnn.network_layers(net, accel),
                                        accel, seed=0))


@pytest.mark.parametrize("net", PAPER_NETWORKS)
def test_cost_model_identical(net):
    layers = network_layers(net, "sense")
    ref_layers = ref_cnn.network_layers(net, "sense")
    assert sorted(cost_model.DEPLOYMENTS) == sorted(ref_cost.DEPLOYMENTS)
    for name, dep in cost_model.DEPLOYMENTS.items():
        rdep = ref_cost.DEPLOYMENTS[name]
        _same(dep, rdep)
        for scope in ("all", "adc"):
            for adaptive in (True, False):
                _same(network_cost(layers, dep, adaptive=adaptive,
                                   scope=scope),
                      ref_cost.network_cost(ref_layers, rdep,
                                            adaptive=adaptive, scope=scope))
            assert adc_reduction(layers, dep, scope=scope) == \
                ref_cost.adc_reduction(ref_layers, rdep, scope=scope)


def test_cost_model_helpers_identical():
    dep, rdep = DEPLOYMENTS["edge-64k"], ref_cost.DEPLOYMENTS["edge-64k"]
    for i, w, o, p in ((10**6, 10**7, 10**5, 4 * 10**5), (8, 8, 8, 8),
                       (3 * 10**6, 10**5, 0, 0)):
        for gemv in (True, False):
            costs = cost_model.mode_dram_bits(i, w, o, p, dep, gemv=gemv)
            assert costs == ref_cost.mode_dram_bits(i, w, o, p, rdep,
                                                    gemv=gemv)
            assert cost_model.pick_mode(costs) == ref_cost.pick_mode(costs)
    for q in ("none", "int8", "int4"):
        args = (256, 16, 72, 128)
        assert cost_model.tiled_format_bits(*args, quant=q) == \
            ref_cost.tiled_format_bits(*args, quant=q)
        _same(cost_model.gemm_layer_cost(m=64, n_in=2048, n_out=8192,
                                         w_format_bits=10**7, macs=10**9,
                                         dep=dep, quant=q),
              ref_cost.gemm_layer_cost(m=64, n_in=2048, n_out=8192,
                                       w_format_bits=10**7, macs=10**9,
                                       dep=rdep, quant=q))
        assert dep.energy.mac_energy(q) == rdep.energy.mac_energy(q)
    assert cost_model.flat_format_bits(64, 20, 300) == \
        ref_cost.flat_format_bits(64, 20, 300)
    # the ladder renames the hand-kernel rung after its backend
    assert cost_model.IMPL_LADDER == tuple(
        "cuda" if r == "pallas" else r for r in ref_cost.IMPL_LADDER)


def test_pytree_nbytes_matches_reference():
    rng = np.random.default_rng(4)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.integers(0, 9, (7,)).astype(np.int32),
                  "d": rng.standard_normal((2, 2)).astype(np.float16)}}
    ttree = {"a": torch.from_numpy(tree["a"]).to(torch.bfloat16),
             "b": {"c": torch.from_numpy(tree["b"]["c"]),
                   "d": torch.from_numpy(tree["b"]["d"])}}
    want = ref_cost.pytree_nbytes({"a": jnp.asarray(tree["a"], jnp.bfloat16),
                                   "b": tree["b"]})
    assert cost_model.pytree_nbytes(ttree) == want
    sp = pruning.to_balanced_sparse(torch.randn(4, 6), k=2)
    assert cost_model.pytree_nbytes(sp) == 4 * 2 * (4 + 4)


# ---------------------------------------------------------------------------
# Twins of test_paper_claims.py: the ADC reduction band
# ---------------------------------------------------------------------------

ADC_BAND = (1.17, 2.0)


@pytest.mark.parametrize("net", PAPER_NETWORKS)
def test_adc_dram_reduction_band(net):
    r = adc_reduction(network_layers(net, "sense"), ZCU102, scope="adc")
    lo, hi = ADC_BAND
    assert lo <= r <= hi, f"{net}: ADC reduction {r:.3f} outside [{lo},{hi}]"


@pytest.mark.parametrize("net", PAPER_NETWORKS)
def test_adaptive_never_loses_and_escapes_rif(net):
    layers = network_layers(net, "sense")
    for scope in ("all", "adc"):
        a = network_cost(layers, ZCU102, adaptive=True, scope=scope)
        f = network_cost(layers, ZCU102, adaptive=False, scope=scope)
        assert a["total_bits"] <= f["total_bits"]
        for c in a["per_layer"]:
            assert c["dram_bits"] == min(c["per_mode"].values())
    modes = network_cost(layers, ZCU102, adaptive=True, scope="adc")["modes"]
    assert any(m in ("RWF", "ON_CHIP") for m in modes)


def test_choose_dataflow_storage_ratio_flip_and_capture():
    early = choose_dataflow(network_layers("vgg16", "sense")[0],
                            weight_buffer_bits=1)
    late = choose_dataflow(next(ls for ls in network_layers("resnet50",
                                                            "sense")
                                if ls.name == "s2b0_1x1b"),
                           weight_buffer_bits=1)
    assert (early.mode, late.mode) == ("RWF", "RIF")
    assert early.d_mem_bits == min(early.d_mem_rif, early.d_mem_rwf)
    tiny = LayerSpec(name="tiny", kind="conv", h_i=14, w_i=14, c_i=32,
                     c_o=32, h_k=3, w_k=3, padding=1, w_sparsity=0.5,
                     ifm_sparsity=0.45)
    c = choose_dataflow(tiny, weight_buffer_bits=ZCU102.weight_buffer_bits)
    assert c.mode == "ON_CHIP" and c.d_mem_bits == c.i_mem + c.w_mem
    fc = LayerSpec(name="fc", kind="fc", c_i=4096, c_o=1000, w_sparsity=0.8,
                   ifm_sparsity=0.6)
    assert len(set(cost_model.conv_layer_cost(fc, ZCU102)["per_mode"]
                   .values())) == 1
    tight = dataclasses.replace(ZCU102, name="tight",
                                ifm_buffer_bits=ZCU102.ifm_buffer_bits // 4)
    vgg = network_layers("vgg16", "sense")
    assert adc_reduction(vgg, tight) >= adc_reduction(vgg, ZCU102) - 1e-9


# ---------------------------------------------------------------------------
# Twins of test_systolic_model.py: model invariants
# ---------------------------------------------------------------------------

def test_balanced_and_clustered_never_slower():
    ls, _ = _conv(c_i=128, c_o=128)
    nzei = synth_ifm_nze(ls, "sense", np.random.default_rng(0), n_is=7)
    w_bal = synth_weight_slices(ls, "sense", np.random.default_rng(1))
    w_irr = synth_weight_slices(ls, "swallow", np.random.default_rng(1))
    scale = w_bal.sum() / max(w_irr.sum(), 1)
    c_bal = conv_cycles_sliced(nzei, w_bal, n_pe=32, cluster_ifm=True)
    c_irr = conv_cycles_sliced(nzei, w_irr, n_pe=32, cluster_ifm=True)
    assert c_bal <= c_irr / min(scale, 1.0) * 1.05
    assert conv_cycles_sliced(nzei, w_bal, n_pe=32, cluster_ifm=True) <= \
        conv_cycles_sliced(nzei, w_bal, n_pe=32, cluster_ifm=False)


def test_dense_mode_below_thresholds_and_fc_cycles():
    cfg = SystolicConfig()
    lo, _ = _conv(ifm_sparsity=0.1, w_sparsity=0.1)
    hi, _ = _conv(ifm_sparsity=0.5, w_sparsity=0.5)
    rep = layer_perf(lo, "sense", cfg, np.random.default_rng(0))
    rep2 = layer_perf(hi, "sense", cfg, np.random.default_rng(0))
    assert not rep.sparse_mode and rep2.sparse_mode
    assert rep2.cycles < rep.cycles
    mask, cols = np.array([1, 1, 0, 1, 1]), np.array([5, 3, 9, 2, 4])
    assert fc_cycles(mask, cols, n_pe=2, clustered=False) == 9
    assert fc_cycles(mask, cols, n_pe=2, clustered=True) == 8


def test_pe_utilization_and_sparsity_monotone():
    for accel in ("sense", "dense"):
        p = network_perf(network_layers("alexnet", accel), accel, seed=1)
        assert 0.0 < p.pe_utilization <= 1.0
        assert p.images_per_s > 0 and p.energy_j > 0
    base = network_layers("vgg16", "sense")
    lo = network_perf([dataclasses.replace(ls, w_sparsity=0.3)
                       for ls in base], "sense", seed=3)
    hi = network_perf([dataclasses.replace(ls, w_sparsity=0.7)
                       for ls in base], "sense", seed=3)
    assert hi.images_per_s >= lo.images_per_s


def test_tab3_loop_order_swap():
    rif, _ = _conv(h_i=7, w_i=7, c_i=512, c_o=2048, h_k=1, w_k=1, padding=0)
    plan = plan_layer(rif, weight_buffer_bits=1)
    assert plan.dataflow.mode == "RIF"
    seq = oc_visit_order(plan)
    assert seq[0][1] == seq[1][1]           # one ifm tile, consecutive ocs
    rwf, _ = _conv(h_i=28, w_i=28, c_i=512, c_o=512)
    plan2 = plan_layer(rwf, weight_buffer_bits=1)
    assert plan2.dataflow.mode == "RWF"
    seq2 = oc_visit_order(plan2)
    assert seq2[0][0] == seq2[1][0]         # one oc, consecutive tiles
    t = plan.tiling
    assert sum(1 for _ in loop_nest(plan)) == \
        t.t_ifm_row * t.t_ifm_col * t.t_oc * t.t_ic


# ---------------------------------------------------------------------------
# Twins of test_paper_examples.py: the worked examples, exactly
# ---------------------------------------------------------------------------

def test_fig4_channel_clustering_cycles():
    nze = torch.tensor([8, 4, 8, 3])
    natural = int(schedule_cycles(nze, group=2, clustered=False))
    clustered = int(schedule_cycles(nze, group=2, clustered=True))
    assert (natural, clustered) == (16, 12)
    assert set(cluster_channels(nze)[:2].tolist()) == {0, 2}
    nat = grouped_step_costs(nze, 2, clustered=False).numpy()
    clu = grouped_step_costs(nze, 2, clustered=True).numpy()
    assert int(np.sum(nat[:, None] - np.array([[8, 4], [8, 3]]))) == 9
    assert int(np.sum(clu[:, None] - np.array([[8, 8], [4, 3]]))) == 1


def test_fig6_balanced_prune_3x3_kernels():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((2, 1, 3, 3)))
    _, mask = balanced_prune_conv(w, sparsity=5 / 9)
    counts = nze_counts(mask.reshape(2, -1)).numpy()
    assert (counts == 4).all() and 9 / counts.max() == 2.25
    flat = w.abs().reshape(2, -1).numpy()
    m = mask.reshape(2, -1).numpy()
    for r in range(2):
        assert set(np.flatnonzero(m[r]).tolist()) == \
            set(np.argsort(-flat[r])[:4].tolist())


def test_fig10_sparse_conv_cycles_and_addresses():
    ifm = np.zeros((4, 4))
    np.fill_diagonal(ifm, [10, 20, 30, 40])
    ker = np.zeros((2, 2))
    np.fill_diagonal(ker, [10, 20])
    ci, cw = bitmap_compress(ifm), bitmap_compress(ker)
    assert ci.length * cw.length == 8 and ifm.size * ker.size == 64
    wo = 3
    valid_i, ir, ic = decode_locations(torch.from_numpy(ci.bitmap))
    valid_w, wr, wc = decode_locations(torch.from_numpy(cw.bitmap))
    accum = {}
    for i in range(int(valid_i.sum())):
        for j in range(int(valid_w.sum())):
            pr, pc = int(ir[i]) - int(wr[j]), int(ic[i]) - int(wc[j])
            if 0 <= pr < wo and 0 <= pc < wo:
                accum[pr * wo + pc] = accum.get(pr * wo + pc, 0) + \
                    float(ci.values[i]) * float(cw.values[j])
    assert accum == {0: 10 * 10 + 20 * 20, 4: 20 * 10 + 30 * 20,
                     8: 30 * 10 + 40 * 20}


def test_tab2_dataflow_modes():
    buf = 160 * 36 * 1024
    l3, _ = _conv(h_i=56, w_i=56, c_i=64, c_o=64, h_k=1, w_k=1, padding=0)
    ch = choose_dataflow(l3, weight_buffer_bits=buf)
    assert ch.mode == "ON_CHIP" and ch.d_mem_bits == ch.i_mem + ch.w_mem
    l15, _ = _conv(c_i=512, c_o=512, padding=0)
    ch = choose_dataflow(l15, weight_buffer_bits=buf)
    assert ch.mode == "RWF" and ch.d_mem_bits == min(ch.d_mem_rif,
                                                     ch.d_mem_rwf)
    l48, _ = _conv(h_i=7, w_i=7, c_i=512, c_o=2048, h_k=1, w_k=1, padding=0)
    assert choose_dataflow(l48, weight_buffer_bits=buf).mode == "RIF"
    t = conv_tiling(LayerSpec(name="x", kind="conv", h_i=14, w_i=14, c_i=64,
                              c_o=128, h_k=3, w_k=3), n_is=7, n_pe=32)
    assert (t.t_ifm_row, t.t_ifm_col) == (2, 2)
    assert dram_access_rif(100, 10, t) == 10 * 4 + 100
    assert dram_access_rwf(100, 10, t) == 100 * t.t_oc + 10
