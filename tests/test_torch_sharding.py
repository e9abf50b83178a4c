"""The port's mesh description and sharding rules against the JAX
reference's: every spec decision (`dim_spec`, `logical_spec`,
`shard_batch`, `kv_plane_spec`, `page_table_spec`, `paged_pool_specs`,
`batch_partition_spec` for every shape, `param_specs` and the bundles'
`cache_specs` of every family at smoke and published width, `plan_specs`
of an olmo-1b smoke plan) and `shard_shape` against ``NamedSharding``
equal,
compared as tuples, on the port's `Mesh` and on a jax ``AbstractMesh`` of
the same axis sizes — (1, 1), (4, 4), (16, 16) and (2, 16, 16); the
one-device identities; and `cost_model.DTYPE_BITS` with its functions (the
twin of ``tests/test_cost_model.py``'s dtype tests)."""
import dataclasses
import functools
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.engine import plan as ref_plan  # noqa: E402
from repro.launch import cost_model as ref_cost  # noqa: E402
from repro.models import api as ref_api  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import rwkv6 as ref_rwkv6  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.models import zamba2 as ref_zamba2  # noqa: E402
from repro.serving import paged_kv as ref_paged_kv  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke  # noqa: E402,E501
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.engine import plan as engine_plan  # noqa: E402
from repro_torch.launch import cost_model, mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving import paged_kv  # noqa: E402

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "4x4": (("data", "model"), (4, 4)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
DIMS = (1, 2, 3, 4, 8, 12, 16, 32, 48, 64, 96, 256, 512, 4096, 32000, 50304)
CANDIDATES = (
    ("model",), ("data",), (("data", "pod"),), (("pod", "data"),),
    (("data", "pod", "model"), "model"), ("pod",), (None,),
    ("model", ("data", "pod")), (("data", "model"),),
)


def _meshes(name):
    names, sizes = MESHES[name]
    return mesh.Mesh(names, sizes), AbstractMesh(sizes, names)


def _t(spec):
    return tuple(spec)


def _spec_tree(tree):
    """A nested dict of specs -> ``{path: tuple}``."""
    if isinstance(tree, dict):
        return {(k,) + p: v for k in tree
                for p, v in _spec_tree(tree[k]).items()}
    return {(): _t(tree)}


@pytest.fixture(params=list(MESHES))
def meshes(request):
    return _meshes(request.param)


def test_mesh_description():
    m = mesh.make_production_mesh()
    assert m.axis_names == ("data", "model") and m.size == 256
    assert list(m.shape.items()) == [("data", 16), ("model", 16)]
    m = mesh.make_production_mesh(multi_pod=True)
    assert dict(m.shape) == {"pod": 2, "data": 16, "model": 16}
    assert m.size == 512
    h = mesh.make_host_mesh()
    assert dict(h.shape) == {"data": 1, "model": 1} and h.size == 1
    with pytest.raises(ValueError, match="differ in length"):
        mesh.Mesh(("data",), (1, 2))
    assert not hasattr(mesh, "ICI_BW")
    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.HBM_BW == 3.35e12
    assert 80e9 <= mesh.HBM_BYTES <= 2 ** 37


def test_partition_spec_normalizes_as_jax():
    from jax.sharding import PartitionSpec
    for dims in [(), (None,), ("data",), (("data",),), (("pod", "data"),),
                 ((), "model"), (None, ("data", "pod"), "model")]:
        assert _t(shd.P(*dims)) == _t(PartitionSpec(*dims)), dims


def test_axis_helpers(meshes):
    port, ref = meshes
    assert shd.dp_axes(port) == ref_shd.dp_axes(ref)
    assert shd.fsdp_axes(port) == ref_shd.fsdp_axes(ref)
    # the reference's api keeps its own copies of the batch rules, which
    # `batch_partition_spec` uses; the port's calls `sharding`'s
    assert shd.dp_axes(port) == ref_api._dp_axes(ref)
    for dim in DIMS:
        assert shd.shard_batch(port, dim) == ref_shd.shard_batch(ref, dim) \
            == ref_api._shardable_prefix(ref_api._dp_axes(ref), dim, ref)


def test_dim_spec(meshes):
    port, ref = meshes
    for dim in DIMS:
        for cands in CANDIDATES:
            assert shd.dim_spec(port, dim, *cands) == \
                ref_shd.dim_spec(ref, dim, *cands), (dim, cands)


def test_logical_spec(meshes):
    port, ref = meshes
    fsdp, tp = [("data", "pod")], ["model"]
    plans = [
        ((4096, 4096), [fsdp, tp]),
        ((0, 2048, 8192), [None, fsdp, tp]),
        ((0, 64, 2048, 1408), [None, tp, fsdp, None]),
        ((50304, 2048), [tp, fsdp]),
        ((48, 12), [["model", ("data", "pod")], tp]),
        ((256, 256, 3), [[("data", "model")], tp, []]),
        ((1, 32), [tp, tp]),
    ]
    for shape, plan in plans:
        assert _t(shd.logical_spec(port, shape, plan)) == \
            _t(ref_shd.logical_spec(ref, shape, plan)), (shape, plan)


def test_batch_kv_and_page_specs(meshes):
    port, ref = meshes
    for b in DIMS:
        assert shd.shard_batch(port, b) == ref_shd.shard_batch(ref, b)
    for planes in DIMS:
        for lead in (0, 1, 2):
            assert _t(shd.kv_plane_spec(port, planes, lead_dims=lead)) == \
                _t(ref_shd.kv_plane_spec(ref, planes, lead_dims=lead))
    assert _t(shd.page_table_spec(port)) == _t(ref_shd.page_table_spec(ref))
    for pages in (1, 7, 16, 64, 1024):
        for kh in (1, 4, 8, 16):
            got = paged_kv.paged_pool_specs(port, pages, kh)
            want = ref_paged_kv.paged_pool_specs(ref, pages, kh)
            assert _spec_tree(got) == _spec_tree(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_partition_spec_every_shape(arch, meshes):
    port, ref = meshes
    assert ARCHS == REF_ARCHS and list(SHAPES) == list(REF_SHAPES)
    for sname, shape in SHAPES.items():
        got = api.batch_partition_spec(get_config(arch), shape, port)
        want = ref_api.batch_partition_spec(ref_get_config(arch),
                                            REF_SHAPES[sname], ref)
        assert _spec_tree(got) == _spec_tree(want), sname


_REF_SPECS = {**{f: ref_transformer.param_specs
                 for f in ("dense", "audio", "vlm", "moe")},
              "ssm": ref_rwkv6.param_specs,
              "hybrid": ref_zamba2.param_specs}


def test_entry_points_dispatch_through_the_registry(monkeypatch):
    """`build_model`, `init_shapes`, `param_specs`, `cache_specs` and
    `sublayer_diffs` reach a family through `register_family` alone:
    every arch's family is served by its module, a family registered
    under a new name is served by the module of its ``build``, and an
    unregistered name raises."""
    for arch in ARCHS:
        cfg = get_smoke(arch)
        want = {"ssm": "rwkv6", "hybrid": "zamba2"}.get(cfg.family,
                                                        "transformer")
        assert api._family_module(cfg).__name__ == \
            f"repro_torch.models.{want}"
    toy = types.ModuleType("toy_family")

    def build(cfg, device, mesh=None):
        return ("bundle", cfg.family, device)

    build.__module__ = toy.__name__
    toy.init_params = lambda cfg, gen, device: {
        "w": torch.empty((2, 3), device=device)}
    toy.param_specs = lambda cfg, mesh: {"w": shd.P(None, "model")}
    toy.cache_specs = lambda cfg, mesh, b: {"k": shd.P(None, b)}
    toy.sublayer_diffs = lambda cfg, params, ref, tokens, **kw: [kw]
    monkeypatch.setitem(sys.modules, toy.__name__, toy)
    monkeypatch.setattr(api, "_REGISTRY", dict(api._REGISTRY))
    assert api.register_family("toy", "toy2")(build) is build
    for family in ("toy", "toy2"):
        cfg = dataclasses.replace(get_smoke("olmo-1b"), family=family)
        assert api.build_model(cfg, "cpu") == ("bundle", family,
                                              torch.device("cpu"))
        w = api.init_shapes(cfg)["w"]
        assert w.is_meta and tuple(w.shape) == (2, 3)
        assert api.param_specs(cfg, None) == {"w": shd.P(None, "model")}
        assert api.cache_specs(cfg, None, 3) == {"k": shd.P(None, 3)}
        assert api.sublayer_diffs(cfg, {}, {}, None, extra=1) == \
            [{"extra": 1}]
    cfg = dataclasses.replace(get_smoke("olmo-1b"), family="unregistered")
    with pytest.raises(ValueError, match="unknown family 'unregistered'"):
        api.build_model(cfg, "cpu")


@pytest.mark.parametrize("which", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_every_family(arch, which, meshes):
    port, ref = meshes
    cfg = get_smoke(arch) if which == "smoke" else get_config(arch)
    ref_cfg = ref_get_smoke(arch) if which == "smoke" \
        else ref_get_config(arch)
    got = api.param_specs(cfg, port)
    want = _REF_SPECS[cfg.family](ref_cfg, ref)
    assert _spec_tree(got) == _spec_tree(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_without_mesh_and_init_shapes(arch):
    """No mesh: ``P()`` on every leaf of the params' tree; `init_shapes`
    gives the reference's ``eval_shape`` shapes and dtypes on ``meta``."""
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    got = api.param_specs(cfg, None)
    want = _REF_SPECS[cfg.family](ref_cfg, None)
    assert _spec_tree(got) == _spec_tree(want)
    assert set(_spec_tree(got).values()) == {()}
    shapes = api.init_shapes(cfg)
    ref_shapes = jax.eval_shape(ref_build_model(ref_cfg).init,
                                jax.ShapeDtypeStruct((2,), jnp.uint32))

    def flat(tree):
        if isinstance(tree, dict):
            return {(k,) + p: v for k in tree
                    for p, v in flat(tree[k]).items()}
        return {(): tree}
    f, rf = flat(shapes), flat(ref_shapes)
    assert f.keys() == rf.keys()
    for p, t in f.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(rf[p].shape), p
        assert str(t.dtype).removeprefix("torch.") == str(rf[p].dtype), p


BATCHES = (1, 2, 4, 8, 32, 256)


@pytest.mark.parametrize("which", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_every_family(arch, which, meshes):
    """The bundles' ``cache_specs(batch)`` (and `api.cache_specs`) equal,
    as tuples, the reference bundle's built on the jax ``AbstractMesh`` of
    the same sizes, at every batch of `BATCHES`; without a mesh ``P()``
    for every leaf, as the reference's."""
    from repro_torch.models import build_model
    port, ref = meshes
    cfg = get_smoke(arch) if which == "smoke" else get_config(arch)
    ref_cfg = ref_get_smoke(arch) if which == "smoke" \
        else ref_get_config(arch)
    bundle = build_model(cfg, "meta", mesh=port)
    ref_bundle = ref_build_model(ref_cfg, ref)
    for b in BATCHES:
        want = _spec_tree(ref_bundle.cache_specs(b))
        assert _spec_tree(bundle.cache_specs(b)) == want, b
        assert _spec_tree(api.cache_specs(cfg, port, b)) == want, b
    assert _spec_tree(bundle.param_specs()) == \
        _spec_tree(ref_bundle.param_specs())
    plain = build_model(cfg, "meta")
    assert _spec_tree(plain.cache_specs(4)) == \
        _spec_tree(ref_build_model(ref_cfg).cache_specs(4))
    assert set(_spec_tree(plain.cache_specs(4)).values()) == {()}
    assert sorted(plain.cache_specs(4)) == \
        sorted(plain.init_cache(4, 16))


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_shape_equals_named_sharding(arch, meshes):
    """`sharding.shard_shape` equals ``NamedSharding(AbstractMesh, spec)
    .shard_shape(shape)`` for every param leaf (published width) and
    every cache leaf of a decode cell's cache (batch 32 x 32768 tokens)
    of the arch, on every mesh; a dim its axes do not divide raises in
    both."""
    from jax.sharding import NamedSharding, PartitionSpec
    from repro_torch.models import build_model
    from repro_torch.tree import flatten_with_paths
    port, ref = meshes
    cfg = get_config(arch)
    bundle = build_model(cfg, "meta", mesh=port)
    pairs = [(api.init_shapes(cfg), bundle.param_specs()),
             (bundle.init_cache(32, 32768), bundle.cache_specs(32))]
    n = 0
    for tree, specs in pairs:
        by_path = _spec_tree(specs)
        for path, t in flatten_with_paths(tree):
            spec = shd.P(*by_path[path])
            want = NamedSharding(ref, PartitionSpec(*spec)).shard_shape(
                tuple(t.shape))
            assert shd.shard_shape(port, tuple(t.shape), spec) == \
                tuple(want), (path, spec)
            n += 1
    assert n > 10
    if port.size > 1:
        with pytest.raises(ValueError, match="does not divide"):
            shd.shard_shape(port, (3, 5), shd.P("model"))
        with pytest.raises(ValueError):
            NamedSharding(ref, PartitionSpec("model")).shard_shape((3, 5))
    with pytest.raises(ValueError, match="more dims"):
        shd.shard_shape(port, (4,), shd.P(None, None))


def test_transformer_use_specs_and_identities(meshes):
    port, ref = meshes
    for arch in ("olmo-1b", "deepseek-moe-16b", "musicgen-medium"):
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        got = transformer.use_specs(cfg, port)
        want = ref_transformer.use_specs(ref_cfg, ref)
        assert {k: _t(v) for k, v in got.items()} == \
            {k: _t(v) for k, v in want.items()}
    lp = {"wq": torch.ones(2, 2)}
    assert transformer.gather_for_use(cfg, port, lp, got) is lp
    h = torch.zeros(1, 4, 8)
    assert shd.with_hidden_sharding(port, h) is h
    assert shd.with_channel_sharding(port, h) is h
    spec = shd.P("data", None)
    assert shd.named(port, spec) is spec
    tree = {"a": spec, "b": {"c": shd.P()}}
    assert shd.tree_shardings(port, tree) is tree


@functools.lru_cache(maxsize=None)
def _plans(impl):
    """The olmo-1b smoke plan of both packages on the same weights."""
    ref_cfg = dataclasses.replace(ref_get_smoke("olmo-1b"),
                                  sparse_serving=True)
    cfg = dataclasses.replace(get_smoke("olmo-1b"), sparse_serving=True)
    params_j = ref_build_model(ref_cfg).init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, params_j), "cpu")
    kw = dict(sparsity=0.5, m_hint=16, decode_m=2)
    want = ref_plan.plan_transformer(
        ref_cfg, params_j, impl={"cuda": "pallas"}.get(impl, impl), **kw)
    got = engine_plan.plan_transformer(cfg, params, impl=impl, **kw)
    return got, want


_FIELDS = ("values", "indices", "counts", "scales", "perm")


@pytest.mark.parametrize("impl", ["cuda", "xla", "dense"])
def test_plan_specs_olmo_smoke(impl, meshes):
    port, ref = meshes
    got_plan, want_plan = _plans(impl)
    got = engine_plan.plan_specs(got_plan, port)
    want = ref_plan.plan_specs(want_plan, ref)
    assert sorted(got.layers) == sorted(want.layers)
    assert got.meta == want_plan.meta == got_plan.meta
    for nm, lp in got.layers.items():
        w, rw = lp.weights, want.layers[nm].weights
        if hasattr(rw, "values"):
            assert type(w).__name__ == type(rw).__name__, nm
            for f in _FIELDS:
                a, ra = getattr(w, f, None), getattr(rw, f, None)
                assert (a is None) == (ra is None), (nm, f)
                if a is not None:
                    assert _t(a) == _t(ra), (nm, f)
        else:
            assert isinstance(w, shd.P) and _t(w) == _t(rw), nm
    assert engine_plan.shard_plan(got_plan, port) is got_plan


# ---------------------------------------------------------------------------
# dtype widths (the twin of tests/test_cost_model.py's dtype tests)
# ---------------------------------------------------------------------------

def test_dtype_table_equals_reference():
    assert cost_model.DTYPE_BITS == ref_cost.DTYPE_BITS
    for name, bits in ref_cost.DTYPE_BITS.items():
        assert cost_model.dtype_bits(name) == ref_cost.dtype_bits(name)
        assert cost_model.dtype_bytes(name) == ref_cost.dtype_bytes(name) \
            == bits / 8.0, name


def test_dtype_pins():
    assert cost_model.dtype_bytes("bf16") == 2
    assert cost_model.dtype_bytes("f32") == 4
    assert cost_model.dtype_bytes("s8") == 1
    assert cost_model.dtype_bytes("s4") == 0.5
    assert cost_model.dtype_bits(np.dtype(np.float32)) == 32
    with pytest.raises(KeyError):
        cost_model.dtype_bits("q3_k_m")
    with pytest.raises(KeyError):
        cost_model.dtype_bits("torch.q3_k_m")


@pytest.mark.parametrize("dt", [torch.float64, torch.float32, torch.float16,
                                torch.bfloat16, torch.int64, torch.int32,
                                torch.int16, torch.int8, torch.uint8,
                                torch.bool, torch.float8_e4m3fn,
                                torch.float8_e5m2, torch.complex64,
                                torch.complex128])
def test_dtype_bits_of_torch_dtypes(dt):
    """A torch dtype and its name give its element width, which is the
    reference's width for the same numpy / HLO name."""
    bits = torch.empty((), dtype=dt).element_size() * 8
    assert cost_model.dtype_bits(dt) == bits
    assert cost_model.dtype_bits(str(dt)) == bits
    assert cost_model.dtype_bytes(dt) == bits / 8.0
