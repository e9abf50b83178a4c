"""The port's meta-device dry run (`launch.dryrun`) against the JAX
reference's dry run: `model_flops` identical for all 40 (arch x shape)
pairs; the olmo-1b smoke prefill built on ``meta`` with its bytes equal to
the sum over `init_shapes` and its matmul FLOPs equal to the dot FLOPs of
the reference's compiled HLO (walked with the reference's `hlo_cost`
helpers) once the chunks the reference's ``lax.cond`` skips are counted;
the variants, the skip records, the recurrent families' chunked long
cells, and the CLI's records; on the reference's production meshes the
per-device bytes of smoke cells equal the reference specs' shard sizes,
and without a mesh flag the one-card record is as before."""
import dataclasses
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, get_smoke  # noqa: E402,E501
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import HBM_BYTES  # noqa: E402
from repro_torch.models import api  # noqa: E402


def _ref_dryrun():
    """The reference's dry-run module.  Importing it sets ``XLA_FLAGS`` to
    512 host devices; the backend is initialized first (so this process
    keeps its devices) and the variable restored afterwards."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return ref


def test_model_flops_identical_for_every_cell():
    ref = _ref_dryrun()
    pairs = [(a, s) for a in ARCHS for s in SHAPES]
    assert len(pairs) == 40 and list(SHAPES) == list(REF_SHAPES)
    for arch, shape in pairs:
        assert dryrun.model_flops(arch, shape) == \
            ref.model_flops(arch, shape), (arch, shape)


def test_apply_variant_as_reference():
    ref = _ref_dryrun()
    for arch in ("olmo-1b", "zamba2-1.2b", "rwkv6-3b"):
        for v in ("v0_baseline", "v1_sparse_serving",
                  "v_ssm_mode=chunked", "v_remat=false,q_chunk=256",
                  "v_cache_update=scatter"):
            got = dryrun.apply_variant(get_config(arch), v)
            want = ref.apply_variant(ref.get_config(arch), v)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), v
    with pytest.raises(ValueError):
        dryrun.apply_variant(get_config("olmo-1b"), "v9_unknown")


def _ref_dot_flops(hlo: str) -> float:
    """Dot FLOPs of compiled HLO with the reference walker's rules: loop
    bodies times their trip counts, a conditional at its costliest branch
    (`hlo_cost.analyze`'s upper bound)."""
    comps, entry = hlo_cost.parse_computations(hlo)
    memo: dict = {}

    def cost(name):
        if name in memo:
            return memo[name]
        memo[name] = 0.0
        insts = comps.get(name, [])
        types = {i.name: i.type_str for i in insts}
        total = 0.0
        for inst in insts:
            op = inst.opcode
            if op == "dot":
                total += hlo_cost._dot_flops(inst, types)
            elif op == "while":
                calls = dict(re.findall(
                    r"(body|condition)=%?([\w.\-]+)", inst.attrs_str))
                tm = hlo_cost._TRIP_RE.search(inst.attrs_str)
                trips = int(tm.group(1)) if tm else hlo_cost.trip_count(
                    comps.get(calls.get("condition"), []))
                total += trips * cost(calls["body"])
            elif op == "conditional":
                bm = hlo_cost._BRANCHES_RE.search(inst.attrs_str)
                total += max(cost(b) for b in
                             hlo_cost._NAME_RE.findall(bm.group(1)))
            else:
                cm = hlo_cost._CALL_RE.search(inst.attrs_str)
                if cm:
                    total += cost(cm.group(1))
        memo[name] = total
        return total
    return cost(entry)


B, S = 2, 64


def test_smoke_prefill_cell_bytes_and_flops_against_reference(tmp_path):
    cfg = get_smoke("olmo-1b")
    rec = dryrun.run_cell("olmo-1b", "prefill_32k", smoke=True, batch=B,
                          seq_len=S, out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cell"] == "olmo-1b-smoke__prefill_32k_b2_s64__gpu1__v0_baseline"
    assert json.loads((tmp_path / f"{rec['cell']}.json").read_text()) == rec
    # bytes: exact sums over init_shapes / the returned cache
    shapes = api.init_shapes(cfg)
    from repro_torch.tree import leaves
    want_params = sum(t.numel() * t.element_size() for t in leaves(shapes))
    assert rec["memory"]["param_bytes"] == want_params
    kv = 2 * cfg.n_layers * B * cfg.n_kv_heads * S * cfg.head_dim * 2
    assert rec["memory"]["cache_bytes"] == kv
    assert rec["memory"]["input_bytes"] == B * S * 4
    assert rec["memory"]["opt_bytes"] == rec["memory"]["grad_bytes"] == 0
    assert rec["resident_bytes"] == want_params + kv + B * S * 4
    assert rec["fits_one_card"] and rec["hbm_bytes"] == HBM_BYTES
    assert rec["collectives"]["total_bytes"] == 0
    # flops: the reference's compiled prefill on the same cell
    ref_cfg = ref_get_smoke("olmo-1b")
    bundle = ref_build_model(ref_cfg)
    params = jax.eval_shape(bundle.init,
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    hlo = jax.jit(bundle.prefill).lower(
        params, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    ).compile().as_text()
    ref_dots = _ref_dot_flops(hlo)
    # The reference's kv loop is a scan over every (q block, kv chunk)
    # pair with a lax.cond that skips the invisible ones at run time; the
    # walker charges a conditional its costliest branch, so its count holds
    # all nq * nk pairs.  The port's loop never runs a skipped chunk.
    qc, kc = cfg.q_chunk, cfg.kv_chunk
    nq, nk = S // qc, S // kc
    visible = sum(1 for qi in range(nq) for ki in range(nk)
                  if ki * kc <= qi * qc + qc - 1)
    g = cfg.n_heads // cfg.n_kv_heads
    per_chunk = 2 * (2 * B * cfg.n_kv_heads * g * qc * kc * cfg.head_dim)
    skipped = cfg.n_layers * (nq * nk - visible) * per_chunk
    assert (nq, nk, visible) == (4, 4, 10)
    assert rec["flops"] + skipped == ref_dots
    # and by hand: 7 projections, the visible chunks, the last-token logits
    d, f, h = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    proj = 2 * B * S * (3 * d * h + h * d + 3 * d * f)
    attn = visible * per_chunk
    assert rec["flops"] == cfg.n_layers * (proj + attn) \
        + 2 * B * d * cfg.vocab_size


def test_train_and_decode_cells_on_meta(tmp_path):
    """A train cell counts the forward, the remat recompute and the
    backward's matmuls and holds params, AdamW moments and gradients; a
    decode cell holds the cache it reads."""
    cfg = get_smoke("olmo-1b")
    tr = dryrun.run_cell("olmo-1b", "train_4k", smoke=True, batch=B,
                         seq_len=S, out_dir=tmp_path)
    assert tr["status"] == "ok", tr.get("error")
    m = tr["memory"]
    assert m["opt_bytes"] == 2 * m["param_bytes"] + 4
    assert m["grad_bytes"] == m["param_bytes"]
    pf = dryrun.run_cell("olmo-1b", "prefill_32k", smoke=True, batch=B,
                         seq_len=S, save=False)
    # forward + recompute (remat) + backward (two matmuls per forward one)
    assert tr["flops"] > 3 * pf["flops"]
    dec = dryrun.run_cell("olmo-1b", "decode_32k", smoke=True, batch=B,
                          seq_len=S, save=False)
    assert dec["status"] == "ok", dec.get("error")
    assert dec["memory"]["cache_bytes"] == \
        2 * cfg.n_layers * B * cfg.n_kv_heads * S * cfg.head_dim * 2
    assert dec["kind"] == "decode" and dec["flops"] > 0


@pytest.mark.parametrize("arch,shape", [("olmo-1b", "train_4k"),
                                        ("olmo-1b", "prefill_32k"),
                                        ("olmo-1b", "decode_32k"),
                                        ("zamba2-1.2b", "train_4k"),
                                        ("zamba2-1.2b", "prefill_32k"),
                                        ("deepseek-moe-16b", "prefill_32k")])
def test_meta_flops_equal_a_cpu_run_of_the_same_step(arch, shape):
    """The step on ``meta`` (where the prefill attention runs only its
    products) counts the FLOPs the same step counts on real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import build_model
    rec = dryrun.run_cell(arch, shape, smoke=True, batch=B, seq_len=S,
                          save=False)
    assert rec["status"] == "ok", rec.get("error")
    cfg = dryrun.apply_variant(get_smoke(arch), rec["variant"])
    spec = dataclasses.replace(SHAPES[shape], global_batch=B, seq_len=S)
    bundle = build_model(cfg, "cpu")
    params = bundle.init(0)
    gen = torch.Generator().manual_seed(0)
    batch = {k: (torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                               dtype=v.dtype) if k == "tokens"
                 else torch.full(v.shape, S - 1, dtype=v.dtype))
             for k, v in api.input_specs(cfg, spec).items()}
    with FlopCounterMode(display=False) as fc:
        if spec.kind == "train":
            from repro_torch.optim import value_and_grad
            value_and_grad(bundle.train_loss, params, batch)
        elif spec.kind == "prefill":
            with torch.no_grad():
                bundle.prefill(params, batch)
        else:
            with torch.no_grad():
                bundle.decode_step(params, batch, bundle.init_cache(B, S))
    assert rec["flops"] == fc.get_total_flops()


def test_skip_records_and_chunked_variant(tmp_path):
    ref = _ref_dryrun()
    rec = dryrun.run_cell("olmo-1b", "long_500k", out_dir=tmp_path)
    _, why = ref.shape_applicable(ref.get_config("olmo-1b"), "long_500k")
    assert rec == {"cell": "olmo-1b__long_500k__gpu1__v0_baseline",
                   "status": "skipped", "reason": why}
    for arch in ("rwkv6-3b", "zamba2-1.2b"):
        for shape in SHAPES:
            v = dryrun.cell_variant(get_config(arch), shape, "v0_baseline")
            assert v == ("v_ssm_mode=chunked"
                         if shape in dryrun.CHUNKED_CELLS else "v0_baseline")
        assert dryrun.cell_variant(get_config(arch), "long_500k",
                                   "v_remat=false") == "v_remat=false"
    assert dryrun.cell_variant(get_config("olmo-1b"), "prefill_32k",
                               "v0_baseline") == "v0_baseline"
    rec = dryrun.run_cell("rwkv6-3b", "prefill_32k", smoke=True, batch=B,
                          seq_len=S, save=False)
    assert rec["status"] == "ok" and rec["variant"] == "v_ssm_mode=chunked"


def test_cli_writes_one_record_a_cell(tmp_path, capsys):
    recs = dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                        "--smoke", "--batch", "2", "--seq-len", "64",
                        "--out", str(tmp_path)])
    assert [r["status"] for r in recs] == ["ok"]
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [recs[0]["cell"] + ".json"]
    assert "[ok] olmo-1b-smoke__decode_32k_b2_s64" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "olmo-1b"])


def test_published_decode_cell_fits_and_counts(tmp_path):
    """olmo-1b decode_32k at published width on ``meta``: the exact cache
    and parameter bytes, the model FLOPs beside the counted ones."""
    cfg = get_config("olmo-1b")
    rec = dryrun.run_cell("olmo-1b", "decode_32k", out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    shape = SHAPES["decode_32k"]
    kv = 2 * cfg.n_layers * shape.global_batch * cfg.n_kv_heads \
        * shape.seq_len * cfg.head_dim * 2
    assert rec["memory"]["cache_bytes"] == kv
    assert rec["model_flops"] == dryrun.model_flops("olmo-1b", "decode_32k")
    assert rec["fits_one_card"] == (rec["resident_bytes"] <= HBM_BYTES)
    assert np.isfinite(rec["roofline"]["bound_s"])


# the one-card record's keys, as PR 21 wrote them
ONE_CARD_KEYS = {"cell", "arch", "shape", "kind", "batch", "seq_len",
                 "smoke", "mesh", "variant", "status", "n_devices",
                 "build_s", "flops", "flops_by_op", "collectives", "memory",
                 "resident_bytes", "fits_one_card", "hbm_bytes",
                 "model_flops", "model_flops_ratio", "roofline"}


def _ref_shard_bytes(ref_mesh, tree, specs):
    """Bytes of one device's shards under the reference's specs:
    ``NamedSharding(mesh, spec).shard_shape`` of every leaf of ``tree``
    (a pytree of shape-dtype structs)."""
    from jax.sharding import NamedSharding, PartitionSpec
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), spec_leaves, strict=True):
        shard = NamedSharding(ref_mesh, spec).shard_shape(leaf.shape)
        total += int(np.prod(shard)) * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", [("olmo-1b", "train_4k"),
                                        ("olmo-1b", "decode_32k"),
                                        ("zamba2-1.2b", "decode_32k"),
                                        ("rwkv6-3b", "prefill_32k"),
                                        ("deepseek-moe-16b", "train_4k")])
def test_production_mesh_bytes_equal_reference_shards(arch, shape,
                                                      tmp_path):
    """A smoke cell on ``pod16x16`` (batch 32, 64 tokens): each part's
    per-device bytes equal the sum of the reference's shard sizes under
    its own bundle's specs on the ``AbstractMesh`` (16, 16): params and
    grads by ``param_specs``, AdamW by them with the step replicated, the
    cache by ``cache_specs``, the inputs by ``batch_partition_spec``.
    Per-device FLOPs and collectives are null with their reason; the
    global FLOPs and bytes are the one-card record's."""
    from jax.sharding import AbstractMesh, PartitionSpec
    from repro.models.api import batch_partition_spec as ref_bps
    from repro.models.api import input_specs as ref_input_specs
    from repro.optim import adamw_init as ref_adamw_init
    b, s = 32, 64
    rec = dryrun.run_cell(arch, shape, smoke=True, batch=b, seq_len=s,
                          mesh_tag="pod16x16", out_dir=tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["cell"].split("__")[2] == "pod16x16"
    assert rec["mesh"] == "pod16x16" and rec["n_chips"] == 256
    one = dryrun.run_cell(arch, shape, smoke=True, batch=b, seq_len=s,
                          save=False)
    for key in ("flops", "memory", "resident_bytes", "model_flops"):
        assert rec[key] == one[key], key
    assert rec["flops_per_device"] is None and rec["collectives"] is None
    assert "SPMD" in rec["per_device_null_reason"]
    assert not {"fits_one_card", "roofline", "n_devices"} & set(rec)
    ref_mesh = AbstractMesh((16, 16), ("data", "model"))
    cfg_j = dryrun.apply_variant(ref_get_smoke(arch), rec["variant"])
    bundle = ref_build_model(cfg_j, ref_mesh)
    params = jax.eval_shape(bundle.init,
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    pspecs = bundle.param_specs()
    spec = dataclasses.replace(REF_SHAPES[shape], global_batch=b,
                               seq_len=s)
    want = {"param_bytes": _ref_shard_bytes(ref_mesh, params, pspecs),
            "input_bytes": _ref_shard_bytes(
                ref_mesh, ref_input_specs(cfg_j, spec),
                ref_bps(cfg_j, spec, ref_mesh)),
            "opt_bytes": 0, "grad_bytes": 0, "cache_bytes": 0}
    if spec.kind == "train":
        opt = jax.eval_shape(ref_adamw_init, params)
        want["opt_bytes"] = _ref_shard_bytes(
            ref_mesh, opt, {"m": pspecs, "v": pspecs, "step": PartitionSpec()})
        want["grad_bytes"] = want["param_bytes"]
    else:
        # decode: the cache the step reads; prefill: the one it returns
        cache = jax.eval_shape(lambda: bundle.init_cache(b, s)) \
            if spec.kind == "decode" else jax.eval_shape(
                bundle.prefill, params, ref_input_specs(cfg_j, spec))[1]
        want["cache_bytes"] = _ref_shard_bytes(ref_mesh, cache,
                                               bundle.cache_specs(b))
    assert rec["per_device"] == want
    assert rec["resident_bytes_per_device"] == sum(want.values())
    assert rec["fits_hbm"] == (sum(want.values()) <= HBM_BYTES)


def test_one_card_record_unchanged_and_mesh_flags(tmp_path, capsys):
    """Without a mesh flag the record is the one-card record (`gpu1`, its
    keys as before); ``--production-mesh`` and ``--multi-pod`` write the
    same cell under ``pod16x16`` / ``pod2x16x16``, and refuse each
    other."""
    rec = dryrun.run_cell("olmo-1b", "decode_32k", smoke=True, batch=B,
                          seq_len=S, save=False)
    assert set(rec) == ONE_CARD_KEYS and rec["mesh"] == "gpu1"
    assert rec["n_devices"] == 1 and rec["collectives"]["total_bytes"] == 0
    args = ["--arch", "olmo-1b", "--shape", "decode_32k", "--smoke",
            "--batch", "32", "--seq-len", "64", "--out", str(tmp_path)]
    for flag, tag, chips in (("--production-mesh", "pod16x16", 256),
                             ("--multi-pod", "pod2x16x16", 512)):
        [r] = dryrun.main(args + [flag])
        assert r["status"] == "ok" and r["mesh"] == tag
        assert r["n_chips"] == chips
        assert (tmp_path / f"{r['cell']}.json").exists()
        assert f"__{tag}__" in r["cell"]
    assert "fits_hbm=True" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        dryrun.main(args + ["--production-mesh", "--multi-pod"])
    with pytest.raises(ValueError, match="mesh_tag"):
        dryrun.run_cell("olmo-1b", "decode_32k", mesh_tag="pod4x4")
