#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, all started together);
3. kernels — each kernel against its plain PyTorch version on the card,
             unquantized and block-quantized (int8, int4: the ``_q``
             kernels): the 2-D kernels at the olmo-1b projection shapes
             (and a zero-count-block, a ragged-O/M, a ragged-O through
             `ops` and a packed encoding), the batched expert kernel at
             the deepseek-moe-16b expert shapes (E = 64, M = 8 and 16; and
             a ragged-O and a zero-count-block encoding), held at the f32
             tolerance (both sides are f32 sums of the same products); each
             timed beside its plain version, a library yardstick on the
             (dequantized) masked dense weight (``torch.matmul`` /
             ``torch.bmm``) and the card's bound for the same work (the
             live slots only: pad slots carry none);
4. serve   — the port's serving entry point at full olmo-1b width: plan,
             sparse-vs-masked-dense prefill parity, greedy decode; the
             launch counts are zeroed just before and read just after.
             Then the same parity at float32 compute, gated end to end, and
             a `torch.profiler` trace of one sparse generation (device busy
             share, kernels by device time) with the wall time per call
             of one planned projection beside the dense matmul's;
5. quant   — ``serve --quant int8`` at full olmo-1b width: parity gate at
             5e-2 against the dequantized reference, only the ``_q``
             kernels launch; a profile;
6. moe     — the same as 4 for deepseek-moe-16b at full published width,
             depth cut to `MOE_LAYERS`: serve (the batched kernel's launches
             must equal (prefills + decode steps) x layers x 3), peak device
             memory, float32 end-to-end parity, a profile; then
             ``serve --quant int4`` (the same launch count for the batched
             quant kernel), with its peak device memory;
7. result  — one JSON line of per-kernel numbers, then the ok line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

DEVICE = "cuda"
SHAPES = ((2048, 2048), (8192, 2048), (2048, 8192))   # (O, N): olmo-1b
SPARSITY = 0.5
WIDE_M = 128                 # prefill GEMM M: batch 4 x prompt 32
SKINNY_MS = (1, 4, 8)        # decode batches (the kernel's tile is 8 rows)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a kernel and its plain version both return the f32 sum of the same
# products (bf16 x bf16 is exact in f32), so they are held at the f32
# tolerance at either input dtype; a comparison of outputs rounded to the
# compute dtype (through `ops`) takes that dtype's
KERNEL_TOL = TOL["float32"]
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
QUANTS = ("none", "int8", "int4")
CSRC = "src/repro_torch/kernels/csrc/"
REF = "src/repro/kernels/balanced_spmm.py:"
# kernel -> (its source, the TPU kernel it replaces, the quant mode of the
# timed row that the result line reports: the one its serve path runs)
KERNELS = {
    "tiled_balanced_spmm": (CSRC + "balanced_spmm.cu", REF + "106", "none"),
    "tiled_balanced_spmm_skinny": (CSRC + "balanced_spmm.cu", REF + "185",
                                   "none"),
    "tiled_balanced_spmm_batched": (CSRC + "balanced_spmm.cu", REF + "267",
                                    "none"),
    "tiled_balanced_spmm_q": (CSRC + "balanced_spmm_q.cu", REF + "90",
                              "int8"),
    "tiled_balanced_spmm_skinny_q": (CSRC + "balanced_spmm_q.cu",
                                     REF + "170", "int8"),
    "tiled_balanced_spmm_batched_q": (CSRC + "balanced_spmm_q.cu",
                                      REF + "250", "int4")}
GEN_STEPS = 32
SERVE_ARGS = ["--arch", "olmo-1b", "--batch", "4", "--prompt-len", "32",
              "--gen-steps", str(GEN_STEPS), "--sparsity", str(SPARSITY)]
# deepseek-moe-16b: 64 routed experts (top-6) + 2 shared; E x (O, N) of the
# expert projections (gate/up, down); capacities M: decode (batch 4 -> 8)
# and prefill (4 x 32 tokens -> 15, padded to 16)
EXPERTS = 64
EXPERT_SHAPES = ((1408, 2048), (2048, 1408))
EXPERT_MS = (8, 16)
# depth cut: f32 params + bf16 encodings + the f32 masked-dense reference
# take about 7 GB per layer at full width; 8 of the 28 layers fit on 80 GB
MOE_LAYERS = 8
MOE_ARGS = ["--arch", "deepseek-moe-16b", "--n-layers", str(MOE_LAYERS),
            "--batch", "4", "--prompt-len", "32", "--gen-steps",
            str(GEN_STEPS), "--sparsity", str(SPARSITY)]
# kernel launches of one serve run, in prefills' worth: the parity check's
# sparse prefill, its teacher-forced layers, the warm-up's and the timed
# generation's prefills; decode steps: the warm-up's one and GEN_STEPS
SERVE_PREFILLS = 4
SERVE_DECODE_STEPS = 1 + GEN_STEPS
# the quant paths: the 2-D quant kernels at int8 on olmo-1b and at int4 on
# the MoE attention and shared experts, the batched one at int4
QUANT_ARGS = SERVE_ARGS + ["--quant", "int8"]
MOE_QUANT_ARGS = MOE_ARGS + ["--quant", "int4"]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(torch, fn, *, flush, warmup: int = 3, runs: int = 25) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` calls after warm-up,
    with the L2 cache overwritten before each call (the main path finds
    the weights cold: a decode step streams gigabytes).  All runs are
    enqueued before one synchronize: while the card clears ``flush``, the
    host enqueues the next call, so the events time the device's work and
    not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        events.append((start, stop))
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(stop)
                             for start, stop in events)


def compare(torch, worst: dict, name: str, got, want, tol: float,
            what: str) -> None:
    """Hold ``got`` against ``want`` elementwise at ``tol + tol * |want|``;
    raise if any element is off or not finite, else record the max |diff|
    as ``name``'s worst."""
    err = (got.float() - want.float()).abs()
    diff = float(err.max())
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= tol + tol * want.float().abs()).all())
    log(f"check {name:27s} {what:38s} max|diff| {diff:.3e} "
        f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"at {what}: max|diff| {diff}")
    worst[name] = max(worst.get(name, 0.0), diff)


def bound(tb, x, m: int, y_numel: int, dname: str) -> dict:
    """The least time the card could take for ``y = x @ decode(tb)^T``
    (batched or not, ``m`` rows of x per weight): the larger of the bytes
    it must move (x read once, the live encoding with its counts and
    scales, `TiledBalanced.live_nbytes`, the f32 y written once)
    over the memory rate and its multiply-adds on the live slots over the
    peak rate of the input dtype."""
    nbytes = x.numel() * x.element_size() + tb.live_nbytes() + y_numel * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * int(tb.counts.sum()) / PEAK_FLOPS[dname] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def make_encoding(torch, o: int, n: int, dtype, gen, *, empty_half=False,
                  pack=False, quant="none"):
    """A balanced-pruned random [o, n] weight at SPARSITY, encoded as the
    plan encodes it (bn = 128), block-quantized when ``quant`` says so:
    ``(tb, the masked dense weight, dequantized)``.  ``empty_half`` keeps
    every row's nonzeros in the first half of the columns (zero-count,
    zero-scale blocks in the rest); ``pack`` applies the column-combining
    permutation."""
    from repro_torch.core.pruning import keep_count, nonzero_columns, \
        topk_mask
    from repro_torch.kernels import tile_format as tf
    w = (torch.randn((o, n), generator=gen, device=DEVICE)
         / n ** 0.5).to(dtype)
    live = n // 2 if empty_half else n
    k = keep_count(live, SPARSITY)
    mask = torch.zeros((o, n), dtype=torch.bool, device=DEVICE)
    mask[:, :live] = topk_mask(w[:, :live], k)
    idx = nonzero_columns(mask, k)
    vals = w.gather(1, idx)
    n_enc, perm = n, None
    if pack:
        perm = tf.pack_columns(mask, 128)
        pidx = tf.invert_perm(perm).long()[idx]
        order = torch.argsort(pidx, dim=1, stable=True)
        idx, vals = pidx.gather(1, order), vals.gather(1, order)
        n_enc = perm.shape[0]
    tb = tf.encode_tiled(vals, idx, n_enc, bn=128)
    tb = tf.TiledBalanced(tb.values, tb.indices, tb.counts, n_in=n, bn=128,
                          perm=perm)
    if quant == "none":
        return tb, w * mask
    tb = tf.quantize_tiled(tb, quant)
    return tb, tf.tiled_to_dense(tb)


def check_kernels(torch):
    """Phase 3: every 2-D kernel (unquantized, int8, int4) against its
    plain version; returns the rows and the worst error per kernel."""
    from repro_torch.kernels import balanced_spmm as bs
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    # 256 MB: five times the 50 MB L2, and about 0.1 ms of device time
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    worst = {name: 0.0 for name in bs.LAUNCHES}
    rows = []
    check = lambda *a: compare(torch, worst, *a)  # noqa: E731

    for quant, dtype in ((q, d) for q in QUANTS
                         for d in (torch.bfloat16, torch.float32)):
        dname = str(dtype).removeprefix("torch.")
        sfx = "" if quant == "none" else "_q"
        wide, skinny = "tiled_balanced_spmm" + sfx, \
            "tiled_balanced_spmm_skinny" + sfx
        enc = lambda o, n, **kw: make_encoding(  # noqa: E731
            torch, o, n, dtype, gen, quant=quant, **kw)
        for o, n in SHAPES:
            tb, w_masked = enc(o, n)
            for name, m in ((wide, WIDE_M), *((skinny, mm)
                                              for mm in SKINNY_MS)):
                x = torch.randn((m, n), generator=gen,
                                device=DEVICE).to(dtype)
                if name == wide:
                    kern = lambda: bs.tiled_balanced_spmm(x, tb)  # noqa: E731
                else:
                    kern = lambda: bs.tiled_balanced_spmm_skinny(x, tb)  # noqa: E731,E501
                plain = lambda: bs.tiled_balanced_spmm_plain(x, tb)  # noqa: E731,E501
                check(name, kern(), plain(), KERNEL_TOL,
                      f"{quant} {dname} M={m} O={o} N={n} KB={tb.kb}")
                if m not in (WIDE_M, 8):
                    continue       # timed at the shapes the main path runs
                wd = w_masked.to(dtype)
                library = lambda: torch.matmul(x, wd.T)  # noqa: E731
                row = {"name": name, "quant": quant, "dtype": dname, "M": m,
                       "O": o, "N": n, "KB": tb.kb,
                       "ms": time_ms(torch, kern, flush=flush),
                       "plain_ms": time_ms(torch, plain, flush=flush),
                       "library_ms": time_ms(torch, library, flush=flush),
                       **bound(tb, x, m, m * o, dname)}
                rows.append(row)
                log("time  " + json.dumps(row))
        # edge encodings: zero-count (zero-scale) blocks, ragged O and M,
        # packed columns
        tb, _ = enc(2048, 2048, empty_half=True)
        for name, m in ((wide, WIDE_M), (skinny, 8)):
            x = torch.randn((m, 2048), generator=gen, device=DEVICE).to(dtype)
            fn = bs.tiled_balanced_spmm if m > 8 \
                else bs.tiled_balanced_spmm_skinny
            check(name, fn(x, tb), bs.tiled_balanced_spmm_plain(x, tb),
                  KERNEL_TOL, f"{quant} {dname} zero-count blocks")
        # O = 2004: a multiple of neither kernel's CTA tile (64 wide, 8
        # skinny); then through `ops`, which pads O (and the scales) to 2048
        tb, _ = enc(2004, 2048)
        for name, m in ((wide, 100), (skinny, 5)):
            x = torch.randn((m, 2048), generator=gen, device=DEVICE).to(dtype)
            got = bs.tiled_balanced_spmm(x, tb, bm=4, bo=4) if m > 8 \
                else bs.tiled_balanced_spmm_skinny(x, tb, bo=4)
            check(name, got, bs.tiled_balanced_spmm_plain(x, tb), KERNEL_TOL,
                  f"{quant} {dname} ragged M={m} O=2004")
            check(name, ops.tiled_spmm(x, tb).float(),
                  ref.tiled_balanced_spmm_ref(x, tb).float(), TOL[dname],
                  f"{quant} {dname} ops, padded M={m} O=2004")
        tb, _ = enc(2048, 2048, pack=True)
        for name, m in ((wide, WIDE_M), (skinny, 4)):
            x = torch.randn((m, 2048), generator=gen, device=DEVICE).to(dtype)
            check(name, ops.tiled_spmm(x, tb).float(),
                  ref.tiled_balanced_spmm_ref(x, tb).float(), TOL[dname],
                  f"{quant} {dname} packed M={m} KB={tb.kb}")
    return rows, worst


def make_expert_encoding(torch, e: int, o: int, n: int, dtype, gen, *,
                         empty_half=False, quant="none"):
    """``e`` experts' balanced-pruned random [o, n] weights, encoded as the
    plan encodes an expert stack (one shared KB) and quantized as
    ``quant`` says: ``(tb [E, O, NB, KB], masked dense [E, O, N])``."""
    from repro_torch.kernels import tile_format as tf
    tb, w = make_encoding(torch, e * o, n, dtype, gen, empty_half=empty_half,
                          quant=quant)
    lead = lambda t: t.reshape(e, o, *t.shape[1:])  # noqa: E731
    return tf.TiledBalanced(lead(tb.values), lead(tb.indices),
                            lead(tb.counts), n_in=n, bn=tb.bn,
                            scales=None if tb.scales is None
                            else lead(tb.scales),
                            quant=tb.quant), w.reshape(e, o, n)


def check_batched(torch, worst: dict) -> list:
    """Phase 3, the batched expert kernel (unquantized, int8, int4) against
    its plain version at E = 64 and the deepseek-moe-16b expert shapes,
    M = 8 (decode) and 16 (prefill), both dtypes, timed; then a ragged-O
    encoding through the wrapper's padding (`ops.tiled_spmm_batched`) and
    zero-count blocks."""
    from repro_torch.kernels import balanced_spmm as bs
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    rows = []

    for quant, dtype in ((q, d) for q in QUANTS
                         for d in (torch.bfloat16, torch.float32)):
        dname = str(dtype).removeprefix("torch.")
        name = "tiled_balanced_spmm_batched" + ("" if quant == "none"
                                                else "_q")
        check = lambda *a: compare(torch, worst, name, *a)  # noqa: E731
        enc = lambda e, o, n, **kw: make_expert_encoding(  # noqa: E731
            torch, e, o, n, dtype, gen, quant=quant, **kw)
        for o, n in EXPERT_SHAPES:
            tb, w_masked = enc(EXPERTS, o, n)
            wd = w_masked.to(dtype)
            for m in EXPERT_MS:
                x = torch.randn((EXPERTS, m, n), generator=gen,
                                device=DEVICE).to(dtype)
                kern = lambda: bs.tiled_balanced_spmm_batched(x, tb, bm=8, bo=8)  # noqa: E731,E501
                plain = lambda: bs.tiled_balanced_spmm_batched_plain(x, tb)  # noqa: E731,E501
                library = lambda: torch.bmm(x, wd.transpose(1, 2))  # noqa: E731,E501
                check(kern(), plain(), KERNEL_TOL,
                      f"{quant} {dname} E={EXPERTS} M={m} O={o} N={n} "
                      f"KB={tb.kb}")
                row = {"name": name, "quant": quant, "dtype": dname,
                       "E": EXPERTS, "M": m, "O": o, "N": n, "KB": tb.kb,
                       "ms": time_ms(torch, kern, flush=flush),
                       "plain_ms": time_ms(torch, plain, flush=flush),
                       "library_ms": time_ms(torch, library, flush=flush),
                       **bound(tb, x, m, EXPERTS * m * o, dname)}
                rows.append(row)
                log("time  " + json.dumps(row))
            del tb, w_masked, wd
        # O = 1404 per expert: a multiple of neither CTA tile; the wrapper
        # pads O (and the scales) to its block and M to 8 / 16
        tb, _ = enc(8, 1404, 2048)
        for m in (5, 15):
            x = torch.randn((8, m, 2048), generator=gen,
                            device=DEVICE).to(dtype)
            want = torch.stack([ref.tiled_balanced_spmm_ref(
                x[i], type(tb)(tb.values[i], tb.indices[i], tb.counts[i],
                               n_in=tb.n_in, bn=tb.bn,
                               scales=None if tb.scales is None
                               else tb.scales[i], quant=tb.quant))
                for i in range(8)])
            check(ops.tiled_spmm_batched(x, tb).float(), want.float(),
                  TOL[dname], f"{quant} {dname} ragged E=8 M={m} O=1404")
        tb, _ = enc(8, 1408, 2048, empty_half=True)
        for m in EXPERT_MS:
            x = torch.randn((8, m, 2048), generator=gen,
                            device=DEVICE).to(dtype)
            check(bs.tiled_balanced_spmm_batched(x, tb, bm=8, bo=8),
                  bs.tiled_balanced_spmm_batched_plain(x, tb), KERNEL_TOL,
                  f"{quant} {dname} zero-count blocks M={m}")
    return rows


def full_width(torch, compute_dtype: str, arch: str = "olmo-1b",
               n_layers: int | None = None, quant: str = "none"):
    """``arch`` at full width as `launch/serve.py` builds it (seed 0
    weights, seed 1 prompt of batch 4 x 32), depth cut to ``n_layers``
    when given, the plan quantized as ``quant`` says: ``(bundle, params,
    plan, prompt)``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.engine import plan as engine_plan
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch), sparse_serving=True,
                              compute_dtype=compute_dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    bundle = build_model(cfg, DEVICE)
    params = bundle.init(0)
    prompt = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    plan = engine_plan.plan_model(cfg, params, sparsity=SPARSITY, m_hint=128,
                                  quant=quant)
    return bundle, params, plan, prompt.to(DEVICE)


def full_width_f32_parity(torch, serve, arch: str = "olmo-1b",
                          n_layers: int | None = None) -> dict:
    """The sparse plan against its masked-dense reference at float32
    compute and full width, gated end to end on the prefill logits at 1e-4
    (bf16 rounding compounds over depth; f32 does not)."""
    from repro_torch.engine import plan as engine_plan
    bundle, params, plan, prompt = full_width(torch, "float32", arch,
                                              n_layers)
    return serve._parity_check(
        bundle, {**params, "sparse_plan": plan},
        engine_plan.masked_dense_params(params, plan), prompt,
        tol=TOL["float32"])


def profile_generate(torch, serve, steps: int = 8, arch: str = "olmo-1b",
                     n_layers: int | None = None,
                     quant: str = "none") -> dict:
    """Where the device time goes in one sparse greedy generation at full
    width (bf16; one prefill and ``steps`` decode steps): the device's
    busy share of the wall time and the kernels by total device time,
    from a `torch.profiler` trace of the card's activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    bundle, params, plan, prompt = full_width(torch, "bfloat16", arch,
                                              n_layers, quant)
    sparse = {**params, "sparse_plan": plan}
    max_len = prompt.shape[1] + steps
    serve.greedy_generate(bundle, sparse, prompt, steps, max_len)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        serve.greedy_generate(bundle, sparse, prompt, steps, max_len)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            n, ms = by_name.get(evt.name, (0, 0.0))
            by_name[evt.name] = (n + 1, ms + evt.time_range.elapsed_us() / 1e3)
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    out = {"arch": arch, "quant": quant, "layers": bundle.cfg.n_layers,
           "steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms,
           "top": [{"kernel": name[:80], "count": n, "ms": ms}
                   for name, (n, ms) in top]}
    if arch == "olmo-1b":
        out["per_call_us"] = per_call_us(torch, params, plan, torch.bfloat16)
    return out


def per_call_us(torch, params, plan, cd, calls: int = 200) -> dict:
    """Wall microseconds per call of one decode-shaped projection (wq of
    layer 0, x of 4 rows in the compute dtype ``cd``), 200 calls back to
    back: the larger of the host's and the device's time per call, for
    `models.api.planned_proj` on the plan (the sparse path) and without
    it (the dense matmul it replaces), as the model calls it."""
    from repro_torch.models.api import planned_proj
    layer = {nm: t[0] for nm, t in params["blocks"].items()}
    plan0 = plan.per_layer[0]
    x = torch.randn((4, layer["wq"].shape[0]), device=DEVICE).to(cd)

    def wall_us(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) / calls * 1e6

    with torch.no_grad():
        return {"sparse": wall_us(lambda: planned_proj(layer, plan0, "wq", x,
                                                       cd)),
                "dense": wall_us(lambda: planned_proj(layer, None, "wq", x,
                                                      cd))}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import balanced_spmm as bs
    from repro_torch.launch import serve

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.monotonic()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.monotonic() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS})")
    for stem in libs:
        for line in _build.build_log(stem).splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                log(f"ptxas {stem}: {line.strip()}")

    # 3. kernels vs plain versions (launches here are not the main path's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, worst = check_kernels(torch)
    rows += check_batched(torch, worst)

    # 4. the olmo-1b path: counts zeroed just before, read just after
    paths = {"olmo-1b": serve_path(torch, serve, "olmo-1b", SERVE_ARGS)}
    parity_f32 = full_width_f32_parity(torch, serve)
    log(f"float32 compute, full width, end to end: {json.dumps(parity_f32)}")
    log(f"profile {json.dumps(profile_generate(torch, serve))}")

    # 5. the olmo-1b int8 path, the same way
    paths["olmo-1b int8"] = serve_path(torch, serve, "olmo-1b int8",
                                       QUANT_ARGS)
    log("int8 profile " + json.dumps(profile_generate(torch, serve,
                                                      quant="int8")))

    # 6. the deepseek-moe-16b paths, the same way, after freeing olmo's
    want = (SERVE_PREFILLS + SERVE_DECODE_STEPS) * MOE_LAYERS * 3
    for label, args, batched in (
            ("deepseek-moe-16b", MOE_ARGS, "tiled_balanced_spmm_batched"),
            ("deepseek-moe-16b int4", MOE_QUANT_ARGS,
             "tiled_balanced_spmm_batched_q")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        paths[label] = serve_path(torch, serve, label, args)
        if paths[label][batched] != want:
            raise AssertionError(f"{batched} launched "
                                 f"{paths[label][batched]} times on the "
                                 f"{label} path, expected {want}")
        log(f"{label} serve peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f})")
        if batched.endswith("_q"):
            break
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        parity_f32 = full_width_f32_parity(torch, serve, "deepseek-moe-16b",
                                           MOE_LAYERS)
        log(f"moe float32 compute, full width, {MOE_LAYERS} layers, end to "
            f"end: {json.dumps(parity_f32)}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
        log("moe profile " + json.dumps(profile_generate(
            torch, serve, arch="deepseek-moe-16b", n_layers=MOE_LAYERS)))

    # 7. result: launches summed over the four paths' serve runs; each
    # kernel's timed row at bf16, at the quant mode its serve path runs
    kernels = []
    for name, (source, replaces, quant) in KERNELS.items():
        if name.startswith("tiled_balanced_spmm_batched"):
            m, shape = 8, EXPERT_SHAPES[0]
        else:
            m, shape = (8 if "skinny" in name else WIDE_M), SHAPES[1]
        row = next(r for r in rows if r["name"] == name and r["M"] == m
                   and (r["O"], r["N"]) == shape and r["quant"] == quant
                   and r["dtype"] == "bfloat16")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "quant": quant,
                        "launches": sum(p[name] for p in paths.values()),
                        "launches_by_path": {a: p[name]
                                             for a, p in paths.items()},
                        "max_abs_err": worst[name], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def serve_path(torch, serve, label: str, args: list) -> dict:
    """Drive one path through `launch/serve.main` with every launch count
    zeroed just before and read just after; fail if a kernel that the
    path's plan reaches never launched, or if a kernel of the other
    format launched (a quantized plan runs only the ``_q`` kernels, an
    unquantized one none of them)."""
    from repro_torch.kernels import balanced_spmm as bs
    bs.reset_launches()
    t0 = time.monotonic()
    res = serve.main(args)
    torch.cuda.synchronize()
    launches = dict(bs.LAUNCHES)
    plan = res["plan"]
    log(f"serve {' '.join(args)}: {time.monotonic() - t0:.1f} s, plan "
        f"{plan['plan_build_s']:.2f} s, dense "
        f"{res['dense']['tokens_per_s']:.1f} tok/s, sparse "
        f"{res['sparse']['tokens_per_s']:.1f} tok/s, KB "
        f"{plan['block_k']}, parity (tol {plan['parity_tol']:g}) "
        f"{json.dumps(plan['parity'])}, stored {plan['encoded_bytes']} B vs "
        f"dense {plan['dense_bytes']} B; a decode step reads "
        f"{plan['step_weight_bytes']} B of live weights, bound "
        f"{plan['step_weight_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    log(f"{label} launches " + ", ".join(f"{k}={v}"
                                         for k, v in launches.items())
        + f"; the plan reaches {plan['kernels_reached']}")
    quantized = plan["quant"] != "none"
    if not plan["kernels_reached"] or any(
            launches[k] == 0 for k in plan["kernels_reached"]):
        raise AssertionError(f"a kernel of the {label} path never launched: "
                             f"{launches}")
    other = [k for k, v in launches.items()
             if v and k.endswith("_q") != quantized]
    if other:
        raise AssertionError(f"the {label} path launched {other}, kernels of "
                             f"the other weight format")
    return launches


if __name__ == "__main__":
    sys.exit(main())
