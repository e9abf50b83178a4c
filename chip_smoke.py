#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, all started together); the SASS of the
             three spmm libraries must hold HGMMA (the bf16 wide kernels'
             wgmma);
3. kernels — each kernel against its plain PyTorch version on the card,
             unquantized and block-quantized (int8, int4: the ``_q``
             kernels): the 2-D kernels at the olmo-1b projection shapes
             (skinny at M = 1, 2, 3, 4, 5, 8; and a zero-count-block, a
             ragged-O/M, a ragged-O through `ops` and a packed encoding),
             the batched expert kernel at the deepseek-moe-16b expert
             shapes (E = 64, M = 8 and 16; every skinny M at E = 8; and a
             ragged-O and a zero-count-block encoding); the wide kernels
             (and the bitmap one) also at M = 16, 24, 32, 64 and 256 (every
             token tile of the tensor-core kernel) and at column blocks of
             32 and 20, and two bf16 calls bitwise equal at a shape that
             splits the column blocks; the skinny kernels (2-D, batched,
             bitmap) also at column blocks of 32 and 20, at N = 1408 and
             past the resident x (N = 16384), with two bf16 calls bitwise
             equal and y[:3] of an M = 8 call bitwise equal to an M = 3
             call; the batched kernel with x zero in all but 24 of 64
             experts (exact +0.0 there); all held at the f32 tolerance
             (both sides are f32 sums of the same products); each timed
             (after a device-side spin that outlasts the wrapper's host
             path) beside its plain version, a library yardstick on the
             (dequantized) masked dense weight (``torch.matmul`` /
             ``torch.bmm``) and the card's bound for the same work (the
             live slots only: pad slots and empty experts carry none);
             then the wide and skinny kernels in bf16 at the projection
             shapes of rwkv6-3b, zamba2-1.2b, musicgen-medium and
             internvl2-2b (M = 128 and 4), each with the wide kernel's
             splits and CTAs (the streamer's x ranges), timed beside
             ``torch.matmul`` and the bound;
4. serve   — the port's serving entry point at full olmo-1b width: plan,
             sparse-vs-masked-dense prefill parity, greedy decode; the
             launch counts are zeroed just before and read just after.
             Then the same parity at float32 compute, gated end to end, and
             a `torch.profiler` trace of one sparse generation at
             `PROFILE_LAYERS` of the 16 layers (device busy
             share, kernels by device time, the wide and skinny kernels by
             name: bf16 must run the tensor-core wide kernel and the skinny
             streamer, never the FMA wide or skinny ones) with the wall
             time per call of one planned projection beside the dense
             matmul's;
5. bitmap  — the bitmap format's public entry (``ops.encode_bitmap`` +
             ``ops.bitmap_spmm``) over olmo-1b's seven projections at the
             prefill and decode M, counts zeroed just before and read just
             after, each output held against the masked dense matmul;
6. scatter — olmo-1b at full width with ``cache_update="scatter"``: greedy
             tokens and every step's logits bitwise equal to the mask
             path's; then the serve entry point, whose kv kernel launches
             must equal 2 x layers x decode steps and whose tiled kernel
             launches must equal the mask path's;
7. traffic — ``serve --traffic`` at full olmo-1b width, depth
             `PROFILE_LAYERS` of 16, on the scatter config (the
             reference's default scenario): paged-vs-contiguous
             parity exactly 0.0 (gated inside `traffic_mode`), continuous and
             static metrics, the kv, wide and skinny launch counts; then a
             `torch.profiler` trace of the continuous engine serving a batch
             at `PROFILE_LAYERS` (the same wide-kernel check);
8. quant   — ``serve --quant int8`` at full olmo-1b width: parity gate at
             5e-2 against the dequantized reference, only the ``_q``
             kernels launch; a profile at `PROFILE_LAYERS`;
9. moe     — the same as 4 for deepseek-moe-16b at full published width,
             depth cut to `MOE_LAYERS`: serve (the batched kernel's launches
             must equal (prefills + decode steps) x layers x 3), peak device
             memory, float32 end-to-end parity, a profile at
             `PROFILE_LAYERS`; then
             ``serve --quant int4`` (the same launch count for the batched
             quant kernel), with its peak device memory;
10. result — one JSON line of per-kernel numbers (the batched kernel's
             also at the prefill capacity, M = 16; the kv kernel's beside
             the launch floor: an empty kernel under the same timer), then
             the ok line.

The Sense CNN path runs right after phase 3, each phase fatal as above:

11. conv kernels — the wide and skinny kernels against their plain
             versions at 1e-4, both dtypes, at the GEMMs of the CNN path:
             smallcnn's im2col chunks (N = 27, 144, 288; O = 16, 32, 64)
             and fc1 / fc2 (O = 10, also through `ops`, padded to 16) at
             M = 256 and 4, and the im2col GEMMs of VGG-16 conv1_1,
             conv3_1, conv5_3 (N = 4608), ResNet-50 conv1 (7x7 stride 2)
             and s3b0_3x3 (M = 784) and GoogleNet inc3a_3x3r (O = 96);
             two bf16 calls bitwise equal at a split shape;
12. smallcnn — the small CNN (img 32, channels 16/32/64, fc_hidden 256,
             seed-0 weights, convs pruned 0.5, fc 0.8) planned on the card
             and run at batch 256 and 4 in bf16 and f32: logits against the
             masked-dense reference (2e-2 / 1e-4), the wide and skinny
             launches equal to one per im2col chunk and fc call, every
             sparse conv dispatch in `STATS`; the bf16 forward timed beside
             its masked-dense one;
13. paper layers — every conv and fc layer of AlexNet, VGG-16, ResNet-50
             and GoogleNet (`network_layers(net, "sense")`) at batch 1,
             bf16, pruned at Tab. V's Sense ratios, through
             `build_layer_plan` and `apply_conv` / `apply_fc`: each held at
             2e-2 against the masked dense conv / matmul, the launches
             counted, each timed beside cuDNN / cuBLAS and the byte and
             FLOP bounds, summed per network; VGG-16's pass profiled.

Then the training paths, each fatal as above:

14. cnn train — the Fig. 5 prune -> retrain flow through
             `examples/torch_train_sparse_cnn.py` at smallcnn's full config,
             batch 64, f32, 300 dense and 150 retraining steps: the
             ``cuda`` rung's loss and gradients at 1e-4 against the eager
             ``xla`` rung on one batch, through a plan built in the loss
             and through the retraining step's `TrainPlan` (also with
             fc1 / fc2 balanced); after every retraining step the
             pruned positions exactly 0.0, K nonzeros in every conv kernel
             and one tiled launch per im2col chunk of the forward; final
             accuracy within 0.05 of dense; the backward and the update
             launch no spmm kernel; a batch-4 step (fc balanced) launches
             the skinny kernel; ms per step beside the masked-dense twin
             and a `torch.profiler` split of one step;
15. lm train — `launch.train` at full olmo-1b width, 2 layers, batch 8,
             seq 128, 3 steps: finite loss and grad norm, the final
             checkpoint verified, a resumed run bitwise equal to the
             uninterrupted one, peak device memory and ms per step.

Then planning and robustness at full olmo-1b width (bf16, sparsity 0.5,
batch 4, prompt 32), after phase 9, each fatal as above:

16. tune — ``serve --tune sweep`` into a fresh temporary cache: every
             key's candidates timed on the card (each key's candidates,
             the static pick's time and the winner's printed), none
             quarantined, every key naming the card; then ``--tune
             cached`` on that cache (every sparse layer ``cached``, the
             cache untouched, the parity gate and every reached kernel
             launched; tok/s beside ``--tune off``'s, a record) and
             on an empty cache (blocks
             equal to ``--tune off``'s);
17. guard — ``serve --guard`` on olmo-1b and on deepseek-moe-16b at
             `MOE_LAYERS`: no ladder event, no quarantine, no
             ``degraded_dispatch``, and the serving launches (the guard's
             subtracted) equal to phases 4 and 9's; ``serve --guard
             --inject-nan`` on olmo-1b and on ``--quant int8``: one NaN
             trip, blamed on the injected layer, which alone goes dense;
             the MoE NaN drill on an expert layer through
             `serve.guarded_generate`, blaming the same layers with the
             kernels and with their plain versions; `harden_plan` under a
             forced ``cuda`` failure: every layer ``cuda`` -> ``xla``, and
             a greedy pass on that plan launches no tiled kernel and ticks
             ``degraded_dispatch`` on every dispatch;
18. objective — olmo-1b planned under every objective on the modeled
             ``zcu102`` and ``edge-64k`` profiles: mode / impl mix and the
             cost summary, and after one prefill and one decode step each
             layer's dispatches (`execute.bytes_stats`) two per layer of
             the model and its counted weight bytes equal to its cost
             tag's ``w_stream_bytes`` x dispatches (a dispatch-count and
             bookkeeping check: both byte counts are host arithmetic over
             the same stored tensors, no measured traffic); then ``serve
             --objective dram --deployment edge-64k`` through its parity
             gate.

The kernels phase also holds the bitmap kernel against its plain version
and the tiled kernel on the same pruned weight at olmo-1b's projection
shapes, and the kv kernel bitwise against its plain version at P = 64
planes (batch 4 x 16 kv heads), dh = 128, bf16, S = 64 and 4096, C = 1
and 8, with rows past S; each timed beside its plain version, a library
call and its bound (the kv kernel also beside the mask-select rewrite).

Then the recurrent families and the frontends, after phase 18, each
fatal as above:

19. recurrent — rwkv6-3b and zamba2-1.2b at published width and depth
             (32 and 38 layers), bf16, sparsity 0.5, batch 4, prompt 32,
             32 new tokens, through the serve entry point (counts zeroed
             just before, read just after): the sublayer parity gate, the
             wide launches equal to planned projections x layers x
             prefills and the skinny ones that x decode steps, tok/s, plan
             build time and peak memory; the float32 end-to-end parity at
             1e-4; a profile of one sparse generation at `PROFILE_LAYERS`
             layers (busy share, kernels
             by device time, the tensor-core wide kernel and the streamer
             alone) with the WKV / SSD scan's own device time and a
             prefill's wall time; then ``serve --quant int8`` of
             zamba2-1.2b (rows 3 and 4, the same launch counts);
20. frontends — musicgen-medium and internvl2-2b at published width
             through the serve entry point, gated and counted as in 19;
             then a prefill whose first 256 positions (their
             n_frontend_tokens) take seeded frontend rows, batch 2 x
             prompt 320 (M = 640): the sparse plan against its
             masked-dense reference sublayer by sublayer at 2e-2 in bf16 (one
             wide launch a planned projection and layer) and the logits
             end to end at 1e-4 in float32.

Then the long prefill, after phase 20, fatal as above:

21. long prefill — (a) the chunked prefill attention
             (`blocked_causal_attention` at olmo-1b's chunks, 512 / 1024)
             against its unchunked twin at B = 1, S = 4096, H = 16,
             dh = 128 (f32 within 1e-4, bf16 within 2e-2), each form's
             time and peak memory, and a NaN key row in the first of four
             kv chunks (S = 256) on the card against the CPU at 1e-4,
             `LONG_POISON_REPEATS` times on the same inputs (the largest
             reading and the spread printed);
             (b) ``serve`` of olmo-1b at published width, depth
             `LONG_SERVE_LAYERS` of 16, bf16 compute, sparsity 0.5,
             batch 1 (prefill_32k's batch of 32 cut to 1), one
             32768-token prompt and 8 new tokens with the scatter cache
             write: serve's parity gate (every sublayer's increment at
             2e-2), the wide launches (the tensor-core kernel) equal to 7
             projections x layers x prefills, the skinny ones (the
             streamer) that x decode steps, the kv kernel's 2 x layers x
             2 x decode steps, tok/s and the peak device memory; the bf16
             witness (depth
             `WITNESS_LAYERS` of 16): every layer of
             the bf16 sparse prefill (the tensor-core wide kernel, its
             launches counted) and of the
             bf16 masked-dense one, teacher-forced from a float32
             masked-dense reference, their errors against it alike
             (relative RMS of the sparse within 1.25 x the dense's, both
             within 2e-2); then in bf16 one sparse
             prefill's wall time at all 16 layers, the wide kernel at M = 32768 against
             its plain version at 1e-4 (timed beside ``torch.matmul`` and
             its bound) and a profile of one prefill at
             `LONG_PROFILE_LAYERS` layer (the
             attention's and the wide kernel's shares of the device
             time); (c) float32 end
             to end at 2 layers and 8192 tokens against the masked-dense
             reference at 1e-4; (d) the meta-device dry run of the cell
             (`launch.dryrun`, batch 1): its param and cache bytes equal to
             the card's tensors', beside the measured peak.

Then the mesh, after phase 21, fatal as above:

22. mesh  — which ``gloo`` collectives take CUDA tensors (the mesh's
             four ranks on the card); then ``serve --mesh
             data=2,model=2`` of olmo-1b at published width (depth
             `MESH_LAYERS` of 16), bf16, batch 4, prompt 32, 8 new
             tokens through the kv kernel: four
             `torch.distributed` ranks, one process each, all on cuda:0
             over ``gloo``, each holding its shards of the params, the
             plan and the cache by the reference's specs; its greedy
             tokens equal to a one-process run of the same plan, the
             logits of its prefill and of every decode step within 2e-2
             of that run's, each rank's resident bytes
             equal to the dry run's `shard_bytes`, each rank's launches of
             the wide, skinny and kv kernels equal to the plan's count;
             the device count, the backend, each rank's collectives, peak
             memory and wall printed.

Then the MoE mesh, after phase 22, fatal as above:

23. moe mesh — ``serve --mesh data=2,model=2`` of deepseek-moe-16b at
             published width (depth `MOE_MESH_LAYERS` of 28), bf16, batch
             4, prompt 32, 8 new tokens through the kv kernel, on the same
             four ranks sharing cuda:0, the ranks setting up in turns
             (rank 0 alone, then as many as the card holds): the routed
             experts split over ``model`` (32 a rank, their encodings
             gathered over ``data`` only), every rank routing the whole
             batch; the gates of phase 22, each rank's
             launches of rows 1, 2, 5 and 8 equal to the plan's count,
             every batched launch fed the rank's 32 experts; the routing
             agreement with one process, each rank's collectives, set-up
             and serving peaks and wall printed.

Phases 22-26 run their four ranks on processes started once and kept
from run to run (`launch.ranks.keep_ranks`).

Then the family meshes, after phase 23, fatal as above:

24. family meshes — ``serve --mesh data=2,model=2`` of rwkv6-3b,
             zamba2-1.2b, musicgen-medium and internvl2-2b at published
             width, depth `FAMILY_MESH_LAYERS` (zamba2: one group, the
             shared block and two Mamba layers), bf16, sparsity 0.5,
             batch 4, prompt 32, 8 new tokens, the scatter cache write,
             on the same four ranks sharing cuda:0: the recurrent
             families' channels split over ``model`` by heads, zamba2's
             shared-block KV by sequence; the gates of phase 22 for each,
             each rank's launches of rows 1, 2 and 8 equal to the plan's
             count (`FAMILY_MESH_LAUNCHES`), its collectives, peaks and
             wall printed; then one prefill of internvl2-2b on the mesh
             with `FRONTEND_MESH_ROWS` frontend rows (batch 4, prompt
             `FRONTEND_MESH_PROMPT`), launched as serve's ranks are, its
             logits within 2e-2 of one process's prefill with the same
             rows.

Then continuous batching on the mesh, after phase 24, fatal as above:

25. traffic mesh — ``serve --traffic --mesh data=2,model=2`` of olmo-1b
             at published width, depth `TRAFFIC_MESH_LAYERS` of 16, bf16,
             sparsity 0.5, the scatter cache write, on the same four ranks
             sharing cuda:0 (`TRAFFIC_MESH_ARGS`: 4 requests at 8 a
             second, prompts 8 and 16, pages of 8, 2 slots, prefill
             chunks of 16, 8 new tokens at most): each rank holds its
             block of the paged pool by `paged_pool_specs` (7 pages, 28
             of the 112 planes a rank) and of the contiguous pool (12 of
             48), gathers its view's pages and sends its written rows in
             one ``all_to_all`` each, and runs by rank 0's clock; serve's
             own gates (paged vs contiguous exactly 0.0 on every rank, the
             replay's tokens equal to a one-process replay in this
             process, its logits within 2e-2, both pools' resident bytes
             equal to `shard_bytes`, the replay's launches equal to the one
             process's, every rank's ticks of the continuous run equal to
             rank 0's), held again here with each of rows 1, 2 and 8
             launched; each rank's launches, exchange ops and bytes,
             peaks and wall and rank 0's continuous and static metrics
             printed.

Then the sharded train step, after phase 25, fatal as above:

26. train mesh — ``train --mesh data=2,model=2`` of olmo-1b at published
             width (d_model 2048, d_ff 8192, vocab 50304), depth
             `LM_TRAIN_LAYERS` of 16, batch 8, seq 128, `LM_TRAIN_STEPS`
             steps, bf16 compute, f32 params (phase 15's arguments), on
             the same four ranks sharing cuda:0: params, gradients and
             AdamW moments placed by the reference's ``param_specs``, the
             gradients reduce-scattered onto the FSDP blocks; train's own
             gates (every step's loss and grad norm, and every rank's
             final params, ``m`` and ``v`` blocks, within 2e-2 of a
             one-process run in this process; replicated blocks bitwise
             equal after every step; resident bytes equal to
             `launch.dryrun.per_device_bytes`), held again here, and no
             launch of rows 1-8 in the ranks' steps; each rank's step
             walls, collectives of a step and peaks printed.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
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
# decode batches: every M of the streamer's two x layouts (kM = 4, 8)
SKINNY_MS = (1, 2, 3, 4, 5, 8)
# the skinny kernels' column blocks other than the plan's 128, the
# deepseek-moe-16b w_down shape (N = 1408: int8 / int4 value runs that are
# not 16-byte aligned) and an N past the resident x (two column ranges)
SKINNY_EDGE_SHAPES = ((2048, 1408), (1024, 16384))
# decode batch 4 x top-6: at most 24 of the 64 experts hold a token
LIVE_EXPERTS = 24
# the wide kernels' other M: every token tile of the tensor-core kernel
# (32, 64, 128) and ragged ones; column blocks other than the plan's 128
WIDE_MS = (16, 24, 32, 64, 256)
NARROW_BNS = (32, 20)
# the sources whose bf16 wide kernels run wgmma
TC_SOURCES = ("balanced_spmm", "balanced_spmm_q", "bitmap_spmm")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a kernel and its plain version both return the f32 sum of the same
# products (bf16 x bf16 is exact in f32), so they are held at the f32
# tolerance at either input dtype; a comparison of outputs rounded to the
# compute dtype (through `ops`) takes that dtype's
KERNEL_TOL = TOL["float32"]
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
# the timer's device-side spin before each start event: 4e6 SM cycles,
# about 2 ms at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 4_000_000
QUANTS = ("none", "int8", "int4")
# the wrappers' skinny threshold (`kernels.ops.SKINNY_M`)
SKINNY_M = 8
CSRC = "src/repro_torch/kernels/csrc/"
REF = "src/repro/kernels/balanced_spmm.py:"
REF_BITMAP = "src/repro/kernels/bitmap_spmm.py:51"
REF_KV = "src/repro/kernels/kv_cache_update.py:54"
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
                                      REF + "250", "int4"),
    "bitmap_spmm": (CSRC + "bitmap_spmm.cu", REF_BITMAP, "none"),
    "kv_cache_update": (CSRC + "kv_cache_update.cu", REF_KV, "none")}
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
# the bitmap kernel: M of prefill (batch 4 x prompt 32) and decode (batch 4,
# 8 in the kernel phase: its tile)
BITMAP_MS = (4, 8, 128)
# olmo-1b's seven projections (O, N) per layer, the bitmap path's weights
OLMO_PROJECTIONS = {"wq": (2048, 2048), "wk": (2048, 2048),
                    "wv": (2048, 2048), "wo": (2048, 2048),
                    "w_gate": (8192, 2048), "w_up": (8192, 2048),
                    "w_down": (2048, 8192)}
# the kv kernel: P = batch 4 x 16 kv heads planes of dh = 128, bf16
KV_PLANES, KV_DH = 64, 128
KV_SEQS = (64, 4096)
KV_CHUNKS = (1, 8)
OLMO_LAYERS = 16
# the scatter serve: the dense and the sparse generation, each a warm-up
# decode step and GEN_STEPS timed ones, write K and V of every layer
SCATTER_KV_LAUNCHES = 2 * OLMO_LAYERS * 2 * (1 + GEN_STEPS)
# the reference's default traffic scenario (launch/serve.py --traffic),
# depth cut as the profiles' (PROFILE_LAYERS; its gates are per layer:
# parity exactly 0.0, launches that scale with depth) so that the whole
# script, phase 25 included, ends within its time limit
TRAFFIC_ARGS = ["--arch", "olmo-1b", "--traffic", "--requests", "12",
                "--rate", "8", "--page-size", "8", "--slots", "4",
                "--prefill-chunk", "8", "--seed", "0", "--prompt-len", "32",
                "--gen-steps", "32", "--sparsity", str(SPARSITY)]

# the Sense CNN path (phases 11-13): smallcnn at its own config, balanced-
# pruned as examples/adaptive_dataflow.py prunes (convs 0.5, fc 0.8), at a
# wide batch (every GEMM on the wide kernels) and a decode-sized one (fc on
# the skinny streamer)
CNN_BATCHES = (256, 4)
CNN_SPARSITY = {"conv": 0.5, "fc": 0.8}
# the reference's im2col chunk budget (kernels/sparse_conv.py) and the conv
# plans' GEMM M hint (engine.plan.plan_smallcnn's)
CHUNK_ELEMS = 1 << 21
CONV_M_HINT = 4096
# paper layers (network, name in `network_layers`) whose im2col GEMMs the
# kernel phase checks: VGG-16 conv1_1, conv3_1 and conv5_3, ResNet-50's
# 7x7 stride-2 conv1 and a stage-3 3x3, GoogleNet's inc3a 3x3 reduce
PAPER_GEMMS = (("vgg16", "conv1"), ("vgg16", "conv5"), ("vgg16", "conv13"),
               ("resnet50", "conv1"), ("resnet50", "s3b0_3x3"),
               ("googlenet", "inc3a_3x3r"))
# paper_layers' timer: fewer runs (about 140 layers, each timed twice)
PAPER_RUNS = 10
# SM cycles per ms at the H100's 1.98 GHz boost clock (the timer's spin)
CYCLES_PER_MS = 1_980_000
# the training paths (phases 14-15): the reference example's Fig. 5 flow at
# smallcnn's own config (batch 64, 300 dense + 150 retraining steps; its
# accuracy runs `cnn.EVAL_BATCHES` batches), a decode-sized step for the
# skinny kernel, the runs of the step timer; then olmo-1b at full width, depth cut so that the
# forced final checkpoint (f32 params and both AdamW moments) is ~3 GB
CNN_TRAIN_BATCH = 64
CNN_TRAIN_STEPS = (300, 150)
SKINNY_TRAIN_BATCH = 4
TRAIN_STEP_RUNS = 20
LM_TRAIN_LAYERS = 2
LM_TRAIN_STEPS = 3
# planning and robustness (phases 16-18): the guarded NaN runs at fewer
# decode steps (their checks are the guard's, not throughput); the plan
# objectives on two modeled deployment profiles
GUARD_NAN_ARGS = ["--arch", "olmo-1b", "--batch", "4", "--prompt-len", "32",
                  "--gen-steps", "8", "--sparsity", str(SPARSITY)]
OBJECTIVE_DEPLOYMENTS = ("zcu102", "edge-64k")
LM_TRAIN_ARGS = ["--arch", "olmo-1b", "--n-layers", str(LM_TRAIN_LAYERS),
                 "--batch", "8", "--seq", "128"]
# the recurrent families and the frontends (phases 19-20): served at
# published width as olmo-1b is (bf16, sparsity 0.5, batch 4, prompt 32,
# GEN_STEPS new tokens); rwkv6-3b and zamba2-1.2b at published depth too
RECURRENT_ARCHS = ("rwkv6-3b", "zamba2-1.2b")
FRONTEND_ARCHS = ("musicgen-medium", "internvl2-2b")
SLICE7_ARGS = ["--batch", "4", "--prompt-len", "32", "--gen-steps",
               str(GEN_STEPS), "--sparsity", str(SPARSITY)]
# the float32 logits' rounding floor (`logit_sensitivity`): seeded relative
# noise on one planned projection, about the spread of f32 rounding between
# two summation orders; where the floor exceeds 1e-4 the logits are held
# within FLOOR_FACTOR x the floor (`recurrent_f32_parity`)
F32_NOISE, FLOOR_FACTOR = 1e-6, 2.0
# the profiler range around each WKV / SSD scan call (`profile_generate`)
RECURRENCE_RANGE = "recurrence"
# the quantized recurrent path (rows 3 and 4)
RECURRENT_QUANT = ("zamba2-1.2b", "int8")
# a prefill with every frontend row (n_frontend_tokens = 256): batch 2,
# prompt 320, so M = 640
FRONTEND_BATCH, FRONTEND_PROMPT = 2, 320
# the new families' projection shapes (O, N) for rows 1 and 2 (phase 3)
NEW_SHAPES = {"rwkv6-3b": ((2560, 2560), (8960, 2560), (2560, 8960)),
              "zamba2-1.2b": ((4096, 2048), (2048, 4096)),
              "musicgen-medium": ((1536, 1536), (6144, 1536), (1536, 6144)),
              "internvl2-2b": ((1024, 2048),)}
NEW_SHAPE_MS = (WIDE_M, 4)
# phase 21, the long prefill: olmo-1b at published width and depth, one
# 32768-token prompt (prefill_32k's length; its batch of 32 cut to 1: 32
# sequences of KV alone are 137 GB), 8 new tokens through the kv kernel.
# Served at bf16 compute through serve's sublayer gate (2e-2, abs + rel),
# so the launches counted are the bf16 kernels' (the tensor-core wide
# kernel, the streamer); the bf16 prefill is also timed, profiled and its
# wide kernel checked at M = 32768 against its plain version
# (`long_prefill_profile`), and held per layer against float32
# (`long_bf16_witness`); float32 is gated end to end at `LONG_F32_LAYERS`
LONG_PROMPT, LONG_GEN_STEPS = 32768, 8
LONG_DTYPE = "bfloat16"
# olmo-1b's projection shapes (O, N) for the wide kernel at M = LONG_PROMPT
LONG_KERNEL_SHAPES = ((2048, 2048), (8192, 2048), (2048, 8192))
# the served path's depth: LONG_SERVE_LAYERS of 16 (each layer is the same
# work; the timed sparse prefill of `long_prefill_profile` and the dry run
# keep all 16), so that the script, phase 26 included, ends within its
# time limit on a slow host
LONG_SERVE_LAYERS = 4
LONG_ARGS = ["--arch", "olmo-1b", "--batch", "1", "--prompt-len",
             str(LONG_PROMPT), "--gen-steps", str(LONG_GEN_STEPS),
             "--sparsity", str(SPARSITY), "--n-layers",
             str(LONG_SERVE_LAYERS)]
LONG_LABEL = "long_prefill"
LONG_KV_LAUNCHES = 2 * LONG_SERVE_LAYERS * 2 * (1 + LONG_GEN_STEPS)
# the two attention forms on the card (B, S, H, dh), both held in memory;
# the poisoned multi-chunk check (S, chunk), one NaN key row at LONG_POISON_ROW
ATTN_SHAPE = (1, 4096, 16, 128)
LONG_POISON, LONG_POISON_ROW = (256, 64), 3
# ... repeated on the same inputs, the card's and the CPU's side each time
LONG_POISON_REPEATS = 20
# the profiled sparse prefill at LONG_PROMPT: depth cut to this many layers
# (each layer is the same work; the trace of 16 holds ~340k kernels, and
# reading the trace of 2 took about 55 s of the script's limit)
LONG_PROFILE_LAYERS = 1
# the profiled generations of phases 4, 7-9 and 19 (one prefill and 8 steps,
# the traffic engine's batch): depth cut to this many layers (each layer is
# the same work; the script's wall differs by a quarter between H100 hosts)
PROFILE_LAYERS = 2
TRAFFIC_ARGS += ["--n-layers", str(PROFILE_LAYERS)]
# the float32 end-to-end check: published width, depth cut to 2, batch 1
LONG_F32_LAYERS, LONG_F32_PROMPT = 2, 8192
# the profiler range around each prefill attention call
ATTENTION_RANGE = "attention"
# the bf16 witness at LONG_PROMPT: per layer, the relative RMS error against
# float32 of the bf16 sparse output within WITNESS_RATIO x the bf16
# masked-dense one's (both round at the same points; only the f32 sums'
# order differs), and each within WITNESS_REL, the bf16 tolerance (a block
# rounds its input, projections, SwiGLU product and residual sums to bf16)
WITNESS_RATIO, WITNESS_REL = 1.25, TOL["bfloat16"]
WITNESS_LABEL = "long_prefill bf16 witness"
# ... its depth cut to WITNESS_LAYERS of 16 (each layer is the same work;
# the script's limit)
WITNESS_LAYERS = 1
# phase 22, the mesh: olmo-1b at published width, bf16, batch 4, prompt
# 32, 8 new tokens through the kv kernel, served by four torch.distributed
# ranks on a (data=2, model=2) mesh, all sharing cuda:0 over gloo (NCCL
# refuses two ranks on one card); depth cut to MESH_LAYERS of 16 so that the
# whole script ends within its time limit on a slow host (each layer is the
# same work; the script's wall differs by a quarter from one H100 host to
# another)
MESH, MESH_RANKS, MESH_LAYERS, MESH_GEN_STEPS = "data=2,model=2", 4, 2, 8
MESH_ARGS = ["--arch", "olmo-1b", "--batch", "4", "--prompt-len", "32",
             "--gen-steps", str(MESH_GEN_STEPS), "--sparsity", str(SPARSITY),
             "--n-layers", str(MESH_LAYERS), "--mesh", MESH]
# each rank's launches: one wide launch a planned projection and layer in
# the prefill (M = 2 rows x 32), one skinny launch a projection, layer and
# decode step (M = 2), one kv launch for k and one for v a layer and step
MESH_PROJECTIONS = 7
MESH_LAUNCHES = {
    "tiled_balanced_spmm": MESH_PROJECTIONS * MESH_LAYERS,
    "tiled_balanced_spmm_skinny": MESH_PROJECTIONS * MESH_LAYERS
    * MESH_GEN_STEPS,
    "kv_cache_update": 2 * MESH_LAYERS * MESH_GEN_STEPS}
# phase 23, the MoE mesh: deepseek-moe-16b at published width, depth cut
# to MOE_MESH_LAYERS of 28 (28 layers are about 200 GB of whole f32 params
# and plan; 2, not 4, so that the script, phases 21 and 22 at published
# depth included, ends within its time limit: each rank gathers its
# experts' encodings over data every forward), the same cell and mesh as
# phase 22, its 64 routed experts split over model (MOE_MESH_EXPERTS a
# rank)
MOE_MESH_LAYERS, MOE_MESH_EXPERTS = 2, 32
MOE_MESH_ARGS = ["--arch", "deepseek-moe-16b", "--batch", "4",
                 "--prompt-len", "32", "--gen-steps", str(MESH_GEN_STEPS),
                 "--sparsity", str(SPARSITY), "--n-layers",
                 str(MOE_MESH_LAYERS), "--mesh", MESH]
# each rank's launches: the 4 attention and 3 shared-expert projections as
# phase 22's 7 (wide M = 2 rows x 32, skinny M = 2), and one batched launch
# a routed-expert projection, layer and forward (the prefill and every
# decode step) on the rank's 32 experts
MOE_MESH_FORWARDS = 1 + MESH_GEN_STEPS
MOE_MESH_LAUNCHES = {
    "tiled_balanced_spmm": MESH_PROJECTIONS * MOE_MESH_LAYERS,
    "tiled_balanced_spmm_skinny": MESH_PROJECTIONS * MOE_MESH_LAYERS
    * MESH_GEN_STEPS,
    "tiled_balanced_spmm_batched": 3 * MOE_MESH_LAYERS * MOE_MESH_FORWARDS,
    "kv_cache_update": 2 * MOE_MESH_LAYERS * MESH_GEN_STEPS}
# phase 24, the family meshes: each family the reference shards besides the
# dense and MoE ones, at published width, depth cut to FAMILY_MESH_LAYERS,
# the cell and mesh of phase 22; per rank one wide launch a planned
# projection and layer in the prefill (M = 2 rows x 32), one skinny launch
# a projection, layer and decode step (M = 2), and for the transformer
# families one kv launch for k and one for v a layer and step (the
# recurrent states and zamba2's mask-select KV launch none)
FAMILY_MESH_LAYERS = 2
FAMILY_MESH_PROJECTIONS = {"rwkv6-3b": 8, "zamba2-1.2b": 3,
                           "musicgen-medium": 6, "internvl2-2b": 7}


def family_mesh_args(arch: str) -> list:
    return ["--arch", arch, "--batch", "4", "--prompt-len", "32",
            "--gen-steps", str(MESH_GEN_STEPS), "--sparsity", str(SPARSITY),
            "--n-layers", str(FAMILY_MESH_LAYERS), "--mesh", MESH]


def family_mesh_launches(arch: str) -> dict:
    n = FAMILY_MESH_PROJECTIONS[arch] * FAMILY_MESH_LAYERS
    kv = arch in ("musicgen-medium", "internvl2-2b")
    return {"tiled_balanced_spmm": n,
            "tiled_balanced_spmm_skinny": n * MESH_GEN_STEPS,
            "kv_cache_update": 2 * FAMILY_MESH_LAYERS * MESH_GEN_STEPS * kv}


FAMILY_MESH_LAUNCHES = {a: family_mesh_launches(a)
                        for a in FAMILY_MESH_PROJECTIONS}
# ... and one prefill of internvl2-2b with frontend rows on the mesh
FRONTEND_MESH_ARCH, FRONTEND_MESH_ROWS = "internvl2-2b", 256
FRONTEND_MESH_BATCH, FRONTEND_MESH_PROMPT = 4, 320
# phase 25, continuous batching on the mesh: olmo-1b at published width,
# depth cut to TRAFFIC_MESH_LAYERS of 16, the mesh of phase 22; prompts of
# 8 and 16 in chunks of 16 (a prefill of 2 requests is 16 rows on a rank:
# the wide kernel), 2 slots of 3 pages of 8 (a 7-page pool)
TRAFFIC_MESH_LAYERS = 2
TRAFFIC_MESH_ARGS = ["--arch", "olmo-1b", "--traffic", "--requests", "4",
                     "--rate", "8", "--page-size", "8", "--slots", "2",
                     "--prefill-chunk", "16", "--prompt-len", "16",
                     "--gen-steps", "8", "--seed", "0",
                     "--sparsity", str(SPARSITY),
                     "--n-layers", str(TRAFFIC_MESH_LAYERS), "--mesh", MESH]
TRAFFIC_MESH_KERNELS = ("tiled_balanced_spmm", "tiled_balanced_spmm_skinny",
                        "kv_cache_update")
# phase 26, the sharded train step: phase 15's run (LM_TRAIN_ARGS,
# LM_TRAIN_STEPS) on the mesh of phase 22
TRAIN_MESH_ARGS = LM_TRAIN_ARGS + ["--steps", str(LM_TRAIN_STEPS),
                                   "--mesh", MESH]


T_START = time.monotonic()


def log(msg: str) -> None:
    """One line of the script's log, with the seconds since its start."""
    print(f"[chip_smoke {time.monotonic() - T_START:7.1f} s] {msg}",
          flush=True)


def time_ms(torch, fn, *, flush, warmup: int = 3, runs: int = 25,
            spin: int = SPIN_CYCLES) -> float:
    """Median CUDA-event time of ``fn`` over ``runs`` calls after warm-up,
    with the L2 cache overwritten before each call (the main path finds
    the weights cold: a decode step streams gigabytes).  Before each start
    event the card is held in a device-side spin (`torch.cuda._sleep` of
    ``spin`` SM cycles, by default about 2 ms, longer than any wrapper's
    host path; a caller whose ``fn`` enqueues for longer passes a longer
    spin), so the host has enqueued ``fn``'s work before the start event
    runs: the events time the device's work, never a wrapper's host
    time."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(spin)
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


def deterministic(torch, name: str, fn, n: int, what: str) -> None:
    """Two calls of the bf16 wide kernel ``fn`` on one x of WIDE_M rows
    and ``n`` columns at a shape that splits its column blocks must be
    bitwise equal (the split partials are summed in a fixed order)."""
    from repro_torch.kernels import balanced_spmm as bs
    x = torch.randn((WIDE_M, n), device=DEVICE).to(torch.bfloat16)
    a, b = fn(x), fn(x)
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    log(f"check {name:27s} {what + ' two calls bitwise':38s} splits "
        f"{bs.wide_splits(WIDE_M, 2048, n // 128)} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError(f"{name}: two calls on one input differ at "
                             f"{what}")


def skinny_bitwise(torch, name: str, fn, x, what: str) -> None:
    """Two calls of the skinny kernel ``fn`` on ``x`` (8 rows) must be
    bitwise equal, and rows 0-2 of that call bitwise equal to a call on
    ``x[:3]``: each output's summation order depends on the encoding
    alone, not on M, the grid or the timing."""
    a, b = fn(x), fn(x)
    c = fn(x[..., :3, :].contiguous())
    torch.cuda.synchronize()
    same, rows = torch.equal(a, b), torch.equal(a[..., :3, :], c)
    log(f"check {name:27s} {what + ' bitwise, rows':38s} two calls "
        f"{'ok' if same else 'FAIL'}, y[:3] of M=8 == M=3 "
        f"{'ok' if rows else 'FAIL'}")
    if not (same and rows):
        raise AssertionError(f"{name}: skinny calls not bitwise stable at "
                             f"{what} (two calls equal {same}, rows "
                             f"independent {rows})")


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
                  pack=False, quant="none", bn: int = 128):
    """A balanced-pruned random [o, n] weight at SPARSITY, encoded as the
    plan encodes it (column blocks of ``bn``, 128 as the plan's),
    block-quantized when ``quant`` says so:
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
    tb = tf.encode_tiled(vals, idx, n_enc, bn=bn)
    tb = tf.TiledBalanced(tb.values, tb.indices, tb.counts, n_in=n, bn=bn,
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
                if m not in (WIDE_M, 8, 4):
                    continue       # timed at the table's M and the served 4
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
        # the wide kernel at every token tile and ragged M, and at column
        # blocks of 32 and 20 (K padded to 16; 20 takes narrower copies)
        tb, _ = enc(2048, 2048)
        for m in WIDE_MS:
            x = torch.randn((m, 2048), generator=gen, device=DEVICE).to(dtype)
            check(wide, bs.tiled_balanced_spmm(x, tb, bm=8, bo=8),
                  bs.tiled_balanced_spmm_plain(x, tb), KERNEL_TOL,
                  f"{quant} {dname} M={m} O=2048 N=2048")
        for bn in NARROW_BNS:
            tb, _ = enc(2048, 100 * bn, bn=bn)
            x = torch.randn((WIDE_M, 100 * bn), generator=gen,
                            device=DEVICE).to(dtype)
            check(wide, bs.tiled_balanced_spmm(x, tb),
                  bs.tiled_balanced_spmm_plain(x, tb), KERNEL_TOL,
                  f"{quant} {dname} bn={bn} KB={tb.kb} N={100 * bn}")
        if dtype == torch.bfloat16:
            deterministic(torch, wide, lambda x, tb=enc(2048, 2048)[0]:
                          bs.tiled_balanced_spmm(x, tb), 2048,
                          f"{quant} O=2048 N=2048")
        # the skinny kernel at column blocks of 32 and 20, at N = 1408
        # (unaligned quantized value runs) and past the resident x; two
        # calls and M = 3 vs 8 bitwise (bf16: the streamer)
        edges = [(enc(512, 100 * bn, bn=bn)[0], f"bn={bn} N={100 * bn}")
                 for bn in NARROW_BNS]
        edges += [(enc(o, n)[0], f"O={o} N={n}")
                  for o, n in SKINNY_EDGE_SHAPES]
        for tb, what in edges:
            for m in (3, 8):
                x = torch.randn((m, tb.nb * tb.bn), generator=gen,
                                device=DEVICE).to(dtype)
                check(skinny, bs.tiled_balanced_spmm_skinny(x, tb),
                      bs.tiled_balanced_spmm_plain(x, tb), KERNEL_TOL,
                      f"{quant} {dname} M={m} {what}")
            if dtype == torch.bfloat16:
                skinny_bitwise(torch, skinny, lambda x, tb=tb:
                               bs.tiled_balanced_spmm_skinny(x, tb), x,
                               f"{quant} {what}")
        if dtype == torch.bfloat16:
            tb = enc(8192, 2048)[0]
            x = torch.randn((8, 2048), generator=gen, device=DEVICE).to(dtype)
            skinny_bitwise(torch, skinny, lambda x:
                           bs.tiled_balanced_spmm_skinny(x, tb), x,
                           f"{quant} O=8192 N=2048")
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
        tb, _ = enc(8, 1408, 2048)
        for m in (24, 32):            # the wide branch's other token tiles
            x = torch.randn((8, m, 2048), generator=gen,
                            device=DEVICE).to(dtype)
            check(bs.tiled_balanced_spmm_batched(x, tb, bm=8, bo=8),
                  bs.tiled_balanced_spmm_batched_plain(x, tb), KERNEL_TOL,
                  f"{quant} {dname} E=8 M={m} O=1408 N=2048")
        tb, _ = enc(8, 1408, 2048, empty_half=True)
        for m in EXPERT_MS:
            x = torch.randn((8, m, 2048), generator=gen,
                            device=DEVICE).to(dtype)
            check(bs.tiled_balanced_spmm_batched(x, tb, bm=8, bo=8),
                  bs.tiled_balanced_spmm_batched_plain(x, tb), KERNEL_TOL,
                  f"{quant} {dname} zero-count blocks M={m}")
        # the skinny branch at every decode M, at N = 1408 (we_down:
        # unaligned quantized runs) and past the resident x; bitwise stable
        for o, n in ((1408, 2048), (2048, 1408), (256, 16384)):
            tb, _ = enc(8, o, n)
            for m in SKINNY_MS:
                x = torch.randn((8, m, n), generator=gen,
                                device=DEVICE).to(dtype)
                check(bs.tiled_balanced_spmm_batched(x, tb, bm=1, bo=8),
                      bs.tiled_balanced_spmm_batched_plain(x, tb),
                      KERNEL_TOL, f"{quant} {dname} E=8 M={m} O={o} N={n}")
            if dtype == torch.bfloat16:
                skinny_bitwise(torch, name, lambda x, tb=tb:
                               bs.tiled_balanced_spmm_batched(x, tb, bm=1,
                                                              bo=8),
                               x, f"{quant} E=8 O={o} N={n}")
        if dtype == torch.bfloat16:
            rows += empty_experts(torch, worst, name, quant, dtype, gen,
                                  flush)
    return rows


def empty_experts(torch, worst: dict, name: str, quant: str, dtype, gen,
                  flush) -> list:
    """The batched skinny kernel at deepseek-moe-16b's decode: E = 64
    experts whose x is zero but for LIVE_EXPERTS of them (batch 4, top-6).
    The empty experts' y must be exactly +0.0 (their CTAs read no weight),
    the rest must match the plain version; timed beside the plain version,
    ``torch.bmm`` and a bound that counts the live experts' bytes only (the
    work these inputs need)."""
    from repro_torch.kernels import balanced_spmm as bs
    dname = str(dtype).removeprefix("torch.")
    out = []
    for o, n in EXPERT_SHAPES:
        tb, w_masked = make_expert_encoding(torch, EXPERTS, o, n, dtype, gen,
                                            quant=quant)
        wd = w_masked.to(dtype)
        m = EXPERT_MS[0]
        x = torch.randn((EXPERTS, m, n), generator=gen,
                        device=DEVICE).to(dtype)
        live = torch.randperm(EXPERTS, generator=torch.Generator().manual_seed(
            o))[:LIVE_EXPERTS].to(DEVICE)
        dead = torch.ones(EXPERTS, dtype=torch.bool, device=DEVICE)
        dead[live] = False
        x[dead] = 0
        kern = lambda: bs.tiled_balanced_spmm_batched(x, tb, bm=8, bo=8)  # noqa: E731,E501
        plain = lambda: bs.tiled_balanced_spmm_batched_plain(x, tb)  # noqa: E731,E501
        got, want = kern(), plain()
        zero = bool((got[dead] == 0).all()) and not bool(
            torch.signbit(got[dead]).any())
        log(f"check {name:27s} {f'{quant} empty experts O={o} N={n}':38s} "
            f"{EXPERTS - LIVE_EXPERTS} experts +0.0 "
            f"{'ok' if zero else 'FAIL'}")
        if not zero:
            raise AssertionError(f"{name}: an empty expert's y is not +0.0")
        compare(torch, worst, name, got, want, KERNEL_TOL,
                f"{quant} {dname} {LIVE_EXPERTS} live of E={EXPERTS} O={o}")
        sub = type(tb)(tb.values[live], tb.indices[live], tb.counts[live],
                       n_in=tb.n_in, bn=tb.bn,
                       scales=None if tb.scales is None else tb.scales[live],
                       quant=tb.quant)
        row = {"name": name, "quant": quant, "dtype": dname, "E": EXPERTS,
               "live_experts": LIVE_EXPERTS, "M": m, "O": o, "N": n,
               "KB": tb.kb, "ms": time_ms(torch, kern, flush=flush),
               "plain_ms": time_ms(torch, plain, flush=flush),
               "library_ms": time_ms(torch, lambda: torch.bmm(
                   x, wd.transpose(1, 2)), flush=flush),
               **bound(sub, x[live], m, EXPERTS * m * o, dname)}
        out.append(row)
        log("time  " + json.dumps(row))
        del tb, w_masked, wd
    return out


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


def recurrent_f32_parity(torch, serve, arch: str) -> dict:
    """Phase 19's float32 check of ``arch`` at full width: every
    sublayer's increment teacher-forced from the masked-dense reference's
    input to it (`models.api.sublayer_diffs`, serve's gate
    `serve.gate_block`) within 1e-4, and the prefill logits end to end
    within 1e-4, unless the model's own rounding floor
    (`logit_sensitivity`) exceeds 1e-4: then 1e-4 cannot tell a kernel
    from rounding, and the logits are held within `FLOOR_FACTOR` x that
    floor (random-weight rwkv6-3b's 32 layers amplify 1e-6 relative noise
    on one projection to 0.5 in the logits on an H100; PERF.md)."""
    from repro_torch.engine import plan as engine_plan
    from repro_torch.models.api import sublayer_diffs
    bundle, params, plan, prompt = full_width(torch, "float32", arch)
    sparse = {**params, "sparse_plan": plan}
    ref = engine_plan.masked_dense_params(params, plan)
    tol = TOL["float32"]
    with torch.no_grad():
        rows = [(d.block, *row) for d in sublayer_diffs(
            bundle.cfg, sparse, ref, prompt)
            for row in serve.gate_block(d, tol)]
        logits_s, _ = bundle.prefill(sparse, {"tokens": prompt})
        logits_r, _ = bundle.prefill(ref, {"tokens": prompt})
    diff, within = serve._compare(logits_s, logits_r, tol)
    floor = logit_sensitivity(torch, bundle, ref, prompt,
                              next(iter(plan.layers)))
    limit = FLOOR_FACTOR * floor["logits_max_abs_change"]
    if floor["logits_max_abs_change"] > tol:
        gate = f"{FLOOR_FACTOR:g} x floor = {limit:g}"
        ok = math.isfinite(limit) and diff <= limit
    else:
        gate, ok = f"{tol:g}", within
    out = {"layer_max_abs_diff": max(r[2] for r in rows
                                     if r[1] == "output"),
           "layer_gate_excess": max(r[4] for r in rows
                                    if r[1] != "output"),
           "logits_max_abs_diff": diff, "logits_gate": gate,
           "argmax_equal": bool((logits_s.argmax(-1)
                                 == logits_r.argmax(-1)).all()),
           "floor": floor}
    bad = [f"{r[0]} {r[1]}" for r in rows if not r[3]]
    if bad or not ok:
        raise AssertionError(f"{arch} float32: sublayers {bad} beyond "
                             f"{tol:g}, logits gated at {gate}: {out}")
    return out


def logit_sensitivity(torch, bundle, params, prompt, name: str) -> dict:
    """The model's own float32 rounding floor: the prefill logits' max
    |change| when one stacked projection (``name``, every layer) takes
    seeded relative noise of `F32_NOISE`, about the spread of f32 rounding
    between two summation orders."""
    w = params["blocks"][name]
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    noisy = {**params, "blocks": {**params["blocks"], name: w * (
        1 + F32_NOISE * torch.randn(w.shape, generator=gen, device=DEVICE))}}
    with torch.no_grad():
        a, _ = bundle.prefill(params, {"tokens": prompt})
        b, _ = bundle.prefill(noisy, {"tokens": prompt})
    return {"weight": name, "rel_noise": F32_NOISE,
            "logits_max_abs_change": float((a - b).abs().max())}


def device_kernels(prof) -> tuple:
    """A `torch.profiler` trace of the card's activity: ``(by_name, busy
    ms, top)`` with ``by_name`` kernel name -> (launches, device ms) and
    ``top`` the ten kernels of most device time.  `RECURRENCE_RANGE` and
    `ATTENTION_RANGE`, host ranges that also show on the card's track
    spanning their kernels and the gaps between them, are not kernels and
    are left out."""
    from torch.autograd import DeviceType
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA \
                and evt.name not in (RECURRENCE_RANGE, ATTENTION_RANGE):
            n, ms = by_name.get(evt.name, (0, 0.0))
            by_name[evt.name] = (n + 1, ms + evt.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return (by_name, sum(ms for _, ms in by_name.values()),
            [{"kernel": name[:80], "count": n, "ms": ms}
             for name, (n, ms) in top])


def profile_generate(torch, serve, steps: int = 8, arch: str = "olmo-1b",
                     n_layers: int | None = None,
                     quant: str = "none") -> dict:
    """Where the device time goes in one sparse greedy generation at full
    width (bf16; one prefill and ``steps`` decode steps): the device's
    busy share of the wall time and the kernels by total device time,
    from a `torch.profiler` trace of the card's activity, and the wall
    time of one warm prefill (untraced, clocks read after a synchronize).
    For a recurrent family the trace also takes the host's activity, with
    each WKV / SSD scan call in a `RECURRENCE_RANGE` range
    (`recurrence_ranges`), and sums the kernels those ranges launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import TRANSFORMER_FAMILIES
    bundle, params, plan, prompt = full_width(torch, "bfloat16", arch,
                                              n_layers, quant)
    sparse = {**params, "sparse_plan": plan}
    recurrent = bundle.cfg.family not in TRANSFORMER_FAMILIES
    max_len = prompt.shape[1] + steps
    serve.greedy_generate(bundle, sparse, prompt, steps, max_len)   # warm
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        bundle.prefill(sparse, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_ms = (time.monotonic() - t0) * 1e3
    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if recurrent else [])
    with recurrence_ranges(bundle.cfg), profile(
            activities=activities) as prof:
        t0 = time.monotonic()
        serve.greedy_generate(bundle, sparse, prompt, steps, max_len)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name, busy_ms, top = device_kernels(prof)
    out = {"arch": arch, "quant": quant, "layers": bundle.cfg.n_layers,
           "steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms, "prefill_wall_ms": prefill_ms,
           "top": top,
           "wide": wide_kernels(by_name), "skinny": skinny_kernels(by_name)}
    if arch == "olmo-1b":
        out["per_call_us"] = per_call_us(torch, params, plan, torch.bfloat16)
    if recurrent:
        ranges = [e for e in prof.events() if e.name == RECURRENCE_RANGE
                  and e.device_type == DeviceType.CPU]
        want = bundle.cfg.n_layers * (1 + steps)
        if len(ranges) != want:
            raise AssertionError(f"{len(ranges)} recurrence ranges traced, "
                                 f"expected {want}")
        rec_ms = sum(e.device_time_total for e in ranges) / 1e3
        out.update(recurrence_calls=len(ranges), recurrence_device_ms=rec_ms,
                   recurrence_share_of_busy=rec_ms / busy_ms)
    return out


@contextlib.contextmanager
def ranged_calls(mod, name: str, label: str):
    """Within the block, each call of ``mod.name`` runs in a ``label``
    `record_function` range."""
    from torch.profiler import record_function
    fn = getattr(mod, name)

    def ranged(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    setattr(mod, name, ranged)
    try:
        yield
    finally:
        setattr(mod, name, fn)


@contextlib.contextmanager
def recurrence_ranges(cfg):
    """Within the block, each call of a recurrent family's scan
    (`models.rwkv6._wkv_scan`, `models.zamba2._ssd_scan`) runs in a
    `RECURRENCE_RANGE` `record_function` range; a transformer family is
    left as it is."""
    from repro_torch.models import rwkv6, zamba2
    mod, name = {"ssm": (rwkv6, "_wkv_scan"),
                 "hybrid": (zamba2, "_ssd_scan")}.get(cfg.family,
                                                      (None, None))
    if mod is None:
        yield
        return
    with ranged_calls(mod, name, RECURRENCE_RANGE):
        yield


def skinny_kernels(by_name: dict) -> list:
    """The skinny (decode) kernels of a bf16 profile, by name with count
    and device ms: the weight streamer (``skinny_stream_kernel``) must be
    among them and the FMA skinny kernels (float32 only) must not."""
    skinny = [{"kernel": name, "count": n, "ms": ms}
              for name, (n, ms) in by_name.items()
              if "skinny" in name]
    if not any("skinny_stream_kernel" in k["kernel"] for k in skinny) or any(
            "spmm_skinny_kernel" in k["kernel"] for k in skinny):
        raise AssertionError(f"a bf16 decode did not run the skinny "
                             f"streamer alone: {skinny}")
    return skinny


def wide_kernels(by_name: dict) -> list:
    """The wide kernels of a bf16 profile, by name with count and device
    ms: the tensor-core kernel (``tc_spmm_kernel``) must be among them and
    the FMA wide kernels (f32 only) must not."""
    wide = [{"kernel": name, "count": n, "ms": ms}
            for name, (n, ms) in by_name.items()
            if "tc_spmm_kernel" in name or "spmm_wide_kernel" in name]
    if not any("tc_spmm_kernel" in w["kernel"] for w in wide) or any(
            "spmm_wide_kernel" in w["kernel"] for w in wide):
        raise AssertionError(f"a bf16 prefill did not run the tensor-core "
                             f"wide kernel alone: {wide}")
    return wide


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


def launch_counters():
    """Every kernel wrapper's launch counter, by module."""
    from repro_torch.kernels import balanced_spmm, bitmap_spmm, \
        kv_cache_update
    return (balanced_spmm, bitmap_spmm, kv_cache_update)


def reset_launches() -> None:
    for mod in launch_counters():
        mod.reset_launches()


def launches() -> dict:
    out = {}
    for mod in launch_counters():
        out.update(mod.LAUNCHES)
    return out


def bitmap_bound(x, enc, m: int, o: int, dname: str) -> dict:
    """The least time for ``y = x @ decode(W)^T`` on the bitmap format:
    the bytes (x, the bitmap, the live nonzeros, the offsets, the f32 y,
    each once) over the memory rate against the multiply-adds on the
    nonzeros over the peak rate of the input dtype."""
    bitmap, packed, offsets = enc
    nnz = int((bitmap != 0).sum())
    nbytes = (x.numel() * x.element_size() + bitmap.numel()
              + nnz * packed.element_size() + offsets.numel() * 4 + m * o * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * nnz / PEAK_FLOPS[dname] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_bitmap(torch, worst: dict) -> list:
    """Phase 3, the bitmap kernel against its plain version and the tiled
    kernel on the same balanced-pruned weight, at olmo-1b's projection
    shapes, M = 8 and 128, both dtypes, timed beside its plain version,
    ``torch.matmul`` on the masked dense weight and its bound; then an
    all-zero-row weight, an all-zero one (K = 1) and a ragged O and M
    through `ops.bitmap_spmm` (padded as the reference pads)."""
    from repro_torch.kernels import balanced_spmm as bs
    from repro_torch.kernels import bitmap_spmm as bmk
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")

        def check(got, want, what, tol=KERNEL_TOL):
            compare(torch, worst, "bitmap_spmm", got, want, tol, what)

        for o, n in SHAPES:
            tb, w_masked = make_encoding(torch, o, n, dtype, gen)
            enc = bmk.bitmap_encode(w_masked, 128)
            for m in BITMAP_MS:
                x = torch.randn((m, n), generator=gen,
                                device=DEVICE).to(dtype)
                kern = lambda: bmk.bitmap_spmm(x, *enc, bn=128)  # noqa: E731
                plain = lambda: bmk.bitmap_spmm_plain(x, *enc, bn=128)  # noqa: E731,E501
                library = lambda: torch.matmul(x, w_masked.T)  # noqa: E731
                got = kern()
                what = f"{dname} M={m} O={o} N={n} K={enc[1].shape[1]}"
                check(got, plain(), what)
                tiled = bs.tiled_balanced_spmm(x, tb) if m > 8 \
                    else bs.tiled_balanced_spmm_skinny(x, tb)
                check(got, tiled, what + " vs tiled")
                row = {"name": "bitmap_spmm", "quant": "none",
                       "dtype": dname, "M": m, "O": o, "N": n,
                       "K": enc[1].shape[1],
                       "ms": time_ms(torch, kern, flush=flush),
                       "plain_ms": time_ms(torch, plain, flush=flush),
                       "library_ms": time_ms(torch, library, flush=flush),
                       **bitmap_bound(x, enc, m, o, dname)}
                rows.append(row)
                log("time  " + json.dumps(row))
            del tb, w_masked, enc
        # every token tile and ragged M; column blocks of 32 and 20; two
        # calls bitwise equal at a split shape (bf16)
        _, w = make_encoding(torch, 2048, 2048, dtype, gen)
        enc = bmk.bitmap_encode(w, 128)
        for m in (1, 3):              # the skinny kernel's other decode M
            x = torch.randn((m, 2048), generator=gen, device=DEVICE).to(dtype)
            check(bmk.bitmap_spmm(x, *enc, bn=128),
                  bmk.bitmap_spmm_plain(x, *enc, bn=128),
                  f"{dname} M={m} O=2048 N=2048")
        if dtype == torch.bfloat16:
            x = torch.randn((8, 2048), generator=gen, device=DEVICE).to(dtype)
            skinny_bitwise(torch, "bitmap_spmm", lambda x:
                           bmk.bitmap_spmm(x, *enc, bn=128), x,
                           "O=2048 N=2048")
        for m in WIDE_MS:
            x = torch.randn((m, 2048), generator=gen, device=DEVICE).to(dtype)
            check(bmk.bitmap_spmm(x, *enc, bn=128),
                  bmk.bitmap_spmm_plain(x, *enc, bn=128),
                  f"{dname} M={m} O=2048 N=2048")
        if dtype == torch.bfloat16:
            deterministic(torch, "bitmap_spmm",
                          lambda x: bmk.bitmap_spmm(x, *enc, bn=128), 2048,
                          "O=2048 N=2048")
        for bn in NARROW_BNS:
            _, w = make_encoding(torch, 2048, 100 * bn, dtype, gen, bn=bn)
            enc = bmk.bitmap_encode(w, bn)
            for m in (WIDE_M, 3):
                x = torch.randn((m, 100 * bn), generator=gen,
                                device=DEVICE).to(dtype)
                check(bmk.bitmap_spmm(x, *enc, bn=bn),
                      bmk.bitmap_spmm_plain(x, *enc, bn=bn),
                      f"{dname} M={m} bn={bn} N={100 * bn}")
        # past the resident x: two column ranges
        o, n = SKINNY_EDGE_SHAPES[-1]
        _, w = make_encoding(torch, o, n, dtype, gen)
        enc = bmk.bitmap_encode(w, 128)
        for m in (3, 8):
            x = torch.randn((m, n), generator=gen, device=DEVICE).to(dtype)
            check(bmk.bitmap_spmm(x, *enc, bn=128),
                  bmk.bitmap_spmm_plain(x, *enc, bn=128),
                  f"{dname} M={m} O={o} N={n}")
        if dtype == torch.bfloat16:
            skinny_bitwise(torch, "bitmap_spmm", lambda x:
                           bmk.bitmap_spmm(x, *enc, bn=128), x,
                           f"O={o} N={n}")
        # all-zero rows, an all-zero matrix (K = 1), ragged O and M
        _, w = make_encoding(torch, 2004, 2048, dtype, gen)
        w[::7] = 0
        for wt in (w, torch.zeros_like(w)):
            enc = ops.encode_bitmap(wt)
            for m in (100, 5):
                x = torch.randn((m, 2048), generator=gen,
                                device=DEVICE).to(dtype)
                check(bmk.bitmap_spmm(x, *enc, bn=128),
                      bmk.bitmap_spmm_plain(x, *enc, bn=128),
                      f"{dname} ragged M={m} O=2004 K={enc[1].shape[1]}")
                check(ops.bitmap_spmm(x, *enc).float(),
                      ref.bitmap_spmm_ref(x, enc[0], enc[1]).float(),
                      f"{dname} ops, padded M={m} O=2004", TOL[dname])
    return rows


def check_kv(torch, worst: dict) -> list:
    """Phase 3, the kv kernel bitwise against its plain version at
    P = 64, dh = 128, bf16, S = 64 and 4096, C = 1 and 8, int32 and int64
    positions with rows past S (dropped); timed beside its plain version,
    ``index_put_`` of the in-range rows, the mask-select rewrite that the
    ``"mask"`` mode runs, and its bound (the in-range rows read and
    written, the positions read)."""
    from repro_torch.kernels import kv_cache_update as kv
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    rows = []
    p, dh = KV_PLANES, KV_DH
    for s in KV_SEQS:
        cache0 = torch.randn((p, s, dh), generator=gen,
                             device=DEVICE).to(torch.bfloat16)
        for c in KV_CHUNKS:
            new = torch.randn((p, c, dh), generator=gen,
                              device=DEVICE).to(torch.bfloat16)
            pos = torch.randint(0, s - c + 1, (p,), generator=gen,
                                device=DEVICE)
            # rows past S: partly (the last row of the chunk or more), and
            # a whole chunk at S (nothing lands)
            pos[-3], pos[-2], pos[-1] = s - 1, s - c // 2 - 1, s
            for pdt in (torch.int64, torch.int32):
                want = kv.kv_cache_write_chunk_plain(cache0.clone(), new,
                                                     pos.to(pdt))
                got = cache0.clone()
                ptr = got.data_ptr()
                kv.kv_cache_write_chunk(got, new, pos.to(pdt))
                torch.cuda.synchronize()
                diff = float((got.float() - want.float()).abs().max())
                ok = torch.equal(got, want) and got.data_ptr() == ptr \
                    and torch.equal(got[-1], cache0[-1])
                log(f"check {'kv_cache_update':27s} S={s} C={c} pos "
                    f"{str(pdt).removeprefix('torch.')} bitwise, in place "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kv_cache_update differs from its "
                                         f"plain version at S={s} C={c}: "
                                         f"max|diff| {diff}")
                worst["kv_cache_update"] = max(
                    worst.get("kv_cache_update", 0.0), diff)
            rows_ = pos[:, None] + torch.arange(c, device=DEVICE)
            keep = rows_ < s
            planes = torch.arange(p, device=DEVICE)[:, None].expand(p, c)
            idx = (planes[keep], rows_[keep])
            vals = new[keep]
            target = cache0.clone()
            oh = rows_[:, :, None] == torch.arange(s, device=DEVICE)
            written = oh.any(dim=1)[..., None]
            ohf = oh.to(torch.bfloat16)

            def mask_rewrite():
                return torch.where(written,
                                   torch.einsum("pcs,pcd->psd", ohf, new),
                                   target)

            live = int(keep.sum())
            nbytes = 2 * live * dh * 2 + p * pos.element_size()
            row = {"name": "kv_cache_update", "quant": "none",
                   "dtype": "bfloat16", "P": p, "S": s, "C": c, "dh": dh,
                   "rows_written": live,
                   "ms": time_ms(torch, lambda: kv.kv_cache_write_chunk(
                       target, new, pos), flush=flush),
                   "plain_ms": time_ms(
                       torch, lambda: kv.kv_cache_write_chunk_plain(
                           target, new, pos), flush=flush),
                   "library_ms": time_ms(
                       torch, lambda: target.index_put_(idx, vals),
                       flush=flush),
                   "mask_ms": time_ms(torch, mask_rewrite, flush=flush),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
            rows.append(row)
            log("time  " + json.dumps(row))
    return rows


def bitmap_path(torch) -> dict:
    """Phase 7, the bitmap format through its public entry: every olmo-1b
    projection (random weights balanced-pruned at SPARSITY, bf16) encoded
    by ``ops.encode_bitmap`` and multiplied by ``ops.bitmap_spmm`` at the
    prefill M (128) and the decode M (4), each output held against the
    masked dense matmul at the bf16 tolerance; counts zeroed just before
    and read just after."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    weights = {}
    for name, (o, n) in OLMO_PROJECTIONS.items():
        _, w = make_encoding(torch, o, n, torch.bfloat16, gen)
        weights[name] = (w, ops.encode_bitmap(w))
    xs = {(m, n): torch.randn((m, n), generator=gen, device=DEVICE).to(
        torch.bfloat16) for m in (WIDE_M, 4)
        for n in {n for _, n in OLMO_PROJECTIONS.values()}}
    reset_launches()
    outs = {(name, m): ops.bitmap_spmm(xs[(m, w.shape[1])], *enc)
            for name, (w, enc) in weights.items() for m in (WIDE_M, 4)}
    torch.cuda.synchronize()
    counts = launches()
    worst = 0.0
    for (name, m), y in outs.items():
        w = weights[name][0]
        want = (xs[(m, w.shape[1])].float() @ w.float().T).to(torch.bfloat16)
        err = (y.float() - want.float()).abs()
        tol = TOL["bfloat16"]
        if not bool((err <= tol + tol * want.float().abs()).all()):
            raise AssertionError(f"ops.bitmap_spmm {name} M={m} differs from "
                                 f"the masked dense matmul: max|diff| "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    if counts["bitmap_spmm"] != len(outs):
        raise AssertionError(f"bitmap_spmm launched {counts['bitmap_spmm']} "
                             f"times on the bitmap path, expected "
                             f"{len(outs)}")
    log(f"bitmap path: {len(outs)} calls of ops.bitmap_spmm over olmo-1b's "
        f"projections, max|diff| vs masked dense {worst:.3e} (tol "
        f"{TOL['bfloat16']:g}); launches {counts}")
    return counts


def scatter_vs_mask(torch, steps: int = GEN_STEPS) -> dict:
    """Phase 8: the full-width olmo-1b plan served greedily with
    ``cache_update="mask"`` and with ``"scatter"`` from the same weights,
    plan and prompt; tokens and every step's logits must be bitwise
    equal."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models.api import merge_prefill_cache
    bundle_m, params, plan, prompt = full_width(torch, "bfloat16")
    bundle_s = build_model(dataclasses.replace(bundle_m.cfg,
                                               cache_update="scatter"),
                           DEVICE)
    sparse = {**params, "sparse_plan": plan}
    b, p = prompt.shape
    traces = []
    with torch.no_grad():
        for bundle in (bundle_m, bundle_s):
            logits, pfc = bundle.prefill(sparse, {"tokens": prompt})
            cache = merge_prefill_cache(bundle.init_cache(b, p + steps), pfc)
            toks = logits.argmax(dim=-1)[:, None]
            trace = [(logits, toks)]
            clen = torch.full((b,), p, dtype=torch.long, device=DEVICE)
            for _ in range(steps):
                logits, cache = bundle.decode_step(
                    sparse, {"tokens": toks, "cache_len": clen}, cache)
                toks = logits.argmax(dim=-1)[:, None]
                clen = clen + 1
                trace.append((logits, toks))
            traces.append(trace)
    torch.cuda.synchronize()
    diff = max(float((a[0] - b_[0]).abs().max())
               for a, b_ in zip(*traces))
    equal = all(torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1])
                for a, b_ in zip(*traces))
    out = {"steps": steps, "logits_max_abs_diff": diff,
           "bitwise_equal": equal,
           "sample": torch.cat([t for _, t in traces[1]], 1)[0, :8].tolist()}
    log(f"scatter vs mask, olmo-1b full width, {steps} decode steps: "
        f"{json.dumps(out)}")
    if not equal:
        raise AssertionError(f"the scatter cache write changed the served "
                             f"tokens or logits: {out}")
    return out


def profile_traffic(torch, serve) -> dict:
    """Where the device time goes in the continuous engine (phase 7): the
    olmo-1b plan at full width, depth `PROFILE_LAYERS`, scatter config,
    four requests of the traffic scenario's shapes (prompts 16 and 32, 8
    and 32 new tokens) submitted together and served to the end after a
    warm-up, under
    `torch.profiler`: ticks, wall time, the device's busy share and the
    kernels by device time."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import build_model
    from repro_torch.serving import ServingEngine
    bundle, params, plan, _ = full_width(torch, "bfloat16",
                                         n_layers=PROFILE_LAYERS)
    bundle = build_model(dataclasses.replace(bundle.cfg,
                                             cache_update="scatter"), DEVICE)
    sparse = {**params, "sparse_plan": plan}
    rng = torch.Generator().manual_seed(5)
    reqs = [(torch.randint(0, bundle.cfg.vocab_size, (plen,),
                           generator=rng).numpy(), gen)
            for plen, gen in ((16, 8), (32, 32), (32, 8), (16, 32))]

    def engine():
        return ServingEngine(bundle, sparse, num_pages=4 * 8 + 1,
                             page_size=8, max_slots=4, max_pages_per_slot=8,
                             prefill_chunk=8)

    warm = engine()
    for prompt, gen in reqs:
        warm.submit(prompt, gen)
    warm.run()
    eng = engine()
    for prompt, gen in reqs:
        eng.submit(prompt, gen)
    ticks = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        while eng.tick():
            ticks += 1
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    by_name, busy_ms, top = device_kernels(prof)
    return {"layers": bundle.cfg.n_layers, "ticks": ticks,
            "tokens": sum(len(r.out_tokens) for r in eng.sched.done),
            "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "busy_share": busy_ms / wall_ms,
            "top": top,
            "wide": wide_kernels(by_name), "skinny": skinny_kernels(by_name)}


def conv_chunks(b: int, ho: int, wo: int, feat: int) -> list:
    """Output rows per im2col chunk of a conv at batch ``b`` (the rule of
    `kernels.sparse_conv.sparse_conv2d` at the reference's budget): one
    wide-kernel launch each."""
    rows = max(1, CHUNK_ELEMS // max(b * wo * feat, 1))
    return [min(rows, ho - r0) for r0 in range(0, ho, rows)]


def host_spin(torch, fn) -> int:
    """A timer spin (SM cycles) at least three times ``fn``'s host enqueue
    time and never below `SPIN_CYCLES`: a chunked conv enqueues a few
    kernels per chunk from Python, longer than the default spin."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    host_ms = (time.monotonic() - t0) * 1e3
    torch.cuda.synchronize()
    return max(SPIN_CYCLES, int(3 * host_ms * CYCLES_PER_MS))


def launch_floor_ms(torch, flush) -> float:
    """The event time of an empty kernel under `time_ms`
    (`torch.cuda._sleep(0)`: one thread that exits at once): the least any
    one-launch kernel can measure on this timer, row 8's launch floor."""
    return time_ms(torch, lambda: torch.cuda._sleep(0), flush=flush)


def prune_plan(torch, name: str, w, *, layer_spec=None, m_hint: int,
               stride: int = 1, padding="SAME"):
    """``w`` balanced-pruned at `CNN_SPARSITY` of its kind (conv per
    kernel, fc per row) and planned as the path plans it
    (`engine.plan.build_layer_plan`, the CUDA rung on the card):
    ``(plan, masked dense weight)``."""
    from repro_torch.core.pruning import balanced_prune_conv, \
        balanced_prune_rows
    from repro_torch.engine.plan import build_layer_plan
    conv = w.ndim == 4
    prune = balanced_prune_conv if conv else balanced_prune_rows
    wm, mask = prune(w, CNN_SPARSITY["conv" if conv else "fc"])
    lp = build_layer_plan(name, w, mask=mask, layer_spec=layer_spec,
                          m_hint=m_hint, stride=stride, conv_padding=padding)
    if lp.spec.impl != "cuda":
        raise AssertionError(f"{name} planned {lp.spec.impl}, not cuda")
    return lp, wm


def check_conv_kernels(torch, worst: dict) -> None:
    """Phase 11: the wide and skinny kernels (rows 1 and 2) against their
    plain versions at 1e-4 on the GEMMs of the CNN path, both dtypes:
    smallcnn's three im2col GEMMs (every distinct chunk M at batch 256 and
    4) and fc1 / fc2 (O = 10; then through `ops.tiled_spmm`, which pads it
    to 16) at M = 256 and 4; the im2col GEMMs of VGG-16 conv1_1 (N = 27),
    conv3_1 and conv5_3 (N = 4608), ResNet-50 conv1 (7x7 stride 2) and
    s3b0_3x3 (M = 784) and GoogleNet inc3a_3x3r (O = 96) at batch 1; and two
    bf16 calls bitwise equal at a shape that splits the column blocks."""
    from repro_torch.kernels import balanced_spmm as bs
    from repro_torch.kernels import ops, ref
    from repro_torch.models import cnn
    from repro_torch.models.cnn import network_layers
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    cfg = cnn.SmallCNNConfig()
    gemms = []                       # (label, [M...], O, Ci, k) of convs
    hw, cin = cfg.img, 3
    for i, cout in enumerate(cfg.channels):
        ms = sorted({b * r * hw for b in CNN_BATCHES
                     for r in conv_chunks(b, hw, hw, cin * cfg.kernel ** 2)})
        gemms.append((f"smallcnn conv{i}", ms, cout, cin, cfg.kernel))
        hw, cin = hw // 2, cout
    for net, name in PAPER_GEMMS:
        ls = next(ls for ls in network_layers(net, "sense")
                  if ls.name == name)
        feat = ls.c_i * ls.h_k * ls.w_k
        ms = sorted({r * ls.w_o for r in conv_chunks(1, ls.h_o, ls.w_o,
                                                     feat)})
        gemms.append((f"{net} {name}", ms, ls.c_o, ls.c_i, ls.h_k))
    feat = cfg.channels[-1] * (cfg.img // 2 ** len(cfg.channels)) ** 2
    fcs = (("smallcnn fc1", cfg.fc_hidden, feat),
           ("smallcnn fc2", cfg.n_classes, cfg.fc_hidden))
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        cases = []
        for label, ms, o, ci, k in gemms:
            w = (torch.randn((o, ci, k, k), generator=gen, device=DEVICE)
                 / (ci * k * k) ** 0.5).to(dtype)
            cases.append((label, ms, prune_plan(torch, label, w,
                                                m_hint=CONV_M_HINT)[0]))
        for label, o, n in fcs:
            w = (torch.randn((o, n), generator=gen, device=DEVICE)
                 / n ** 0.5).to(dtype)
            cases.append((label, CNN_BATCHES, prune_plan(
                torch, label, w, m_hint=CONV_M_HINT)[0]))
        for label, ms, lp in cases:
            tb = lp.weights
            for m in ms:
                x = torch.randn((m, tb.nb * tb.bn), generator=gen,
                                device=DEVICE).to(dtype)
                if m > SKINNY_M:
                    name, got = "tiled_balanced_spmm", \
                        bs.tiled_balanced_spmm(x, tb, bm=1, bo=1)
                else:
                    name, got = "tiled_balanced_spmm_skinny", \
                        bs.tiled_balanced_spmm_skinny(x, tb, bo=1)
                what = (f"{dname} {label} M={m} O={tb.n_out} "
                        f"N={lp.spec.n_in} bn={tb.bn} KB={tb.kb}")
                compare(torch, worst, name, got,
                        bs.tiled_balanced_spmm_plain(x, tb), KERNEL_TOL, what)
                if tb.n_out % 16:       # through ops: O padded to 16
                    xs = x[:, :tb.n_in]
                    compare(torch, worst, name, ops.tiled_spmm(xs, tb).float(),
                            ref.tiled_balanced_spmm_ref(xs, tb).float(),
                            TOL[dname], what + " ops")
        if dtype == torch.bfloat16:
            label, ms, lp = next(c for c in cases if c[0].endswith("conv13"))
            tb = lp.weights
            x = torch.randn((ms[0], tb.nb * tb.bn), generator=gen,
                            device=DEVICE).to(dtype)
            a = bs.tiled_balanced_spmm(x, tb, bm=1, bo=1)
            b = bs.tiled_balanced_spmm(x, tb, bm=1, bo=1)
            torch.cuda.synchronize()
            splits = bs.wide_splits(ms[0], tb.n_out, tb.nb)
            same = torch.equal(a, b)
            log(f"check {'tiled_balanced_spmm':27s} {label} M={ms[0]} two "
                f"calls bitwise, splits {splits} {'ok' if same else 'FAIL'}")
            if not same or splits < 2:
                raise AssertionError(f"{label}: two calls differ (or no "
                                     f"split: {splits})")


def smallcnn_dense(torch, cfg, plan, x):
    """The masked-dense reference of a smallcnn plan: ``F.conv2d`` and a
    matmul on each layer's `LayerPlan.dense_weights()` in x's dtype, the
    same ReLU, 2x2 max-pool and (H, W, C) flattening."""
    import torch.nn.functional as F
    h = x.permute(0, 3, 1, 2)
    for i in range(len(cfg.channels)):
        lp = plan.layers[f"conv{i}"]
        w = lp.dense_weights().reshape(lp.spec.n_out, -1, lp.spec.hk,
                                       lp.spec.wk).to(x.dtype)
        h = F.max_pool2d(torch.relu(F.conv2d(h, w, padding=cfg.kernel // 2)),
                         2)
    h = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    h = torch.relu(h @ plan.layers["fc1"].dense_weights().to(x.dtype).T)
    return h @ plan.layers["fc2"].dense_weights().to(x.dtype).T


def cnn_path(torch) -> dict:
    """Phase 12: the small CNN at its own config (img 32, channels
    16/32/64, fc_hidden 256; random weights from seed 0, convs pruned 0.5
    per kernel, fc1 and fc2 0.8 per row), planned on the card
    (`plan_smallcnn`: every layer on the CUDA kernels) and run by
    `smallcnn_apply` at batch 256 (every GEMM wide: one launch per im2col
    chunk) and 4 (fc on the skinny streamer), in bf16 and f32, with the
    launch counts zeroed just before and read just after.  Logits are held
    against the masked-dense reference at the dtype's tolerance; the
    launches must equal the chunk rule's count and `STATS` must count each
    sparse conv dispatch.  Then the batch-256 bf16 forward is timed beside
    its masked-dense reference (cuDNN and cuBLAS)."""
    from repro_torch.core.pruning import balanced_prune_conv, \
        balanced_prune_rows
    from repro_torch.engine import execute
    from repro_torch.engine.plan import plan_smallcnn
    from repro_torch.models import cnn
    cfg = cnn.SmallCNNConfig()
    params = cnn.smallcnn_init(cfg, torch.Generator(
        device=DEVICE).manual_seed(0))
    masks = {}
    for nm, w in params.items():
        conv = w.ndim == 4
        prune = balanced_prune_conv if conv else balanced_prune_rows
        params[nm], masks[nm] = prune(w, CNN_SPARSITY["conv" if conv
                                                      else "fc"])
    x = torch.randn((max(CNN_BATCHES), cfg.img, cfg.img, 3), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(1))
    plans = {}
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        t0 = time.monotonic()
        plan = plan_smallcnn(cfg, {k: v.to(dt) for k, v in params.items()},
                             {k: v.to(dt) for k, v in masks.items()})
        torch.cuda.synchronize()
        plans[dname] = plan
        log(f"smallcnn {dname} plan {time.monotonic() - t0:.2f} s: "
            f"{plan.impl_mix()}, KB "
            f"{ {k: lp.spec.block_k for k, lp in plan.layers.items()} }, "
            f"packed {[k for k, lp in plan.layers.items() if lp.spec.packed]}")
    wide = skinny = 0
    for b in CNN_BATCHES:
        hw, cin = cfg.img, 3
        for cout in cfg.channels:
            wide += len(conv_chunks(b, hw, hw, cin * cfg.kernel ** 2))
            hw, cin = hw // 2, cout
        if b > SKINNY_M:
            wide += 2
        else:
            skinny += 2
    want_counts = {"tiled_balanced_spmm": wide * len(plans),
                   "tiled_balanced_spmm_skinny": skinny * len(plans)}
    reset_launches()
    execute.reset_stats()
    outs = {}
    with torch.no_grad():
        for dname, plan in plans.items():
            for b in CNN_BATCHES:
                outs[(dname, b)] = cnn.smallcnn_apply(
                    cfg, None, x[:b].to(getattr(torch, dname)), plan=plan)
    torch.cuda.synchronize()
    counts = launches()
    stats = execute.stats()
    log(f"smallcnn launches {json.dumps(counts)}; STATS {json.dumps(stats)}")
    other = {k: v for k, v in counts.items() if v and k not in want_counts}
    if any(counts[k] != v for k, v in want_counts.items()) or other:
        raise AssertionError(f"smallcnn launched {counts}, expected "
                             f"{want_counts} and nothing else")
    n_fwd = len(plans) * len(CNN_BATCHES)
    if stats.get("sparse_conv") != len(cfg.channels) * n_fwd \
            or stats.get("balanced_spmm") != (len(cfg.channels) + 2) * n_fwd:
        raise AssertionError(f"smallcnn STATS {stats}: expected "
                             f"{len(cfg.channels) * n_fwd} sparse convs")
    with torch.no_grad():
        for (dname, b), y in outs.items():
            want = smallcnn_dense(torch, cfg, plans[dname],
                                  x[:b].to(getattr(torch, dname)))
            tol = TOL[dname]
            err = (y.float() - want.float()).abs()
            ok = tuple(y.shape) == (b, cfg.n_classes) and bool(
                torch.isfinite(y).all()) and bool(
                (err <= tol + tol * want.float().abs()).all())
            log(f"check smallcnn {dname} batch {b}: logits vs masked dense "
                f"max|diff| {float(err.max()):.3e} (tol {tol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"smallcnn {dname} batch {b} logits "
                                     f"differ from the masked-dense "
                                     f"reference: {float(err.max())}")
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    b = max(CNN_BATCHES)
    xb = x[:b].to(torch.bfloat16)
    plan = plans["bfloat16"]
    with torch.no_grad():
        fwd = lambda: cnn.smallcnn_apply(cfg, None, xb, plan=plan)  # noqa: E731,E501
        dense = lambda: smallcnn_dense(torch, cfg, plan, xb)  # noqa: E731
        timing = {"batch": b,
                  "ms": time_ms(torch, fwd, flush=flush,
                                spin=host_spin(torch, fwd)),
                  "masked_dense_ms": time_ms(torch, dense, flush=flush,
                                             spin=host_spin(torch, dense))}
    log(f"smallcnn bf16 forward {json.dumps(timing)}")
    return counts


def profile_layers(torch, apply, layers) -> dict:
    """One pass over ``layers`` (after a warm pass) under `torch.profiler`:
    wall time, the device's busy share and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad():
        for ls, lp, _, x, _ in layers:
            apply(ls, lp, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for ls, lp, _, x, _ in layers:
                apply(ls, lp, x)
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    by_name, busy_ms, top = device_kernels(prof)
    return {"layers": len(layers), "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
            "top": top, "wide": wide_kernels(by_name)}


def paper_layers(torch) -> dict:
    """Phase 13: every conv and fc layer of `network_layers(net, "sense")`
    for the four paper networks at batch 1, bf16: random weights
    balanced-pruned at Tab. V's Sense ratios (conv 0.5 per kernel, fc 0.8
    per row), planned by `build_layer_plan` and run by `apply_conv` /
    `apply_fc` on a random NHWC input of the layer's shape, with the launch
    counts zeroed just before each network's pass and read just after
    (one wide launch per im2col chunk, one skinny per fc); each output held
    at 2e-2 against ``F.conv2d`` / a matmul on the masked weight.  Then
    each layer is timed (`time_ms`, its spin raised above the layer's host
    enqueue time) beside ``F.conv2d`` on the masked dense weight (cuDNN,
    channels-last) or ``torch.matmul`` (cuBLAS), and two bounds: the bytes
    (input, im2col patches written and read once, the live encoding, the
    output) over the memory rate, and the dense-tile FLOPs (M x O x the
    padded N, what the tensor-core kernel multiplies) over the bf16 peak.
    VGG-16's pass is profiled.  Returns the launches summed over the
    networks' passes."""
    import torch.nn.functional as F
    from repro_torch.engine.execute import apply_conv, apply_fc
    from repro_torch.models.cnn import PAPER_NETWORKS, network_layers

    def apply(ls, lp, x):
        return apply_conv(x, lp) if ls.kind == "conv" else apply_fc(x, lp)

    gen = torch.Generator(device=DEVICE).manual_seed(6)
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    bf = torch.bfloat16
    total: dict = {}
    tol = TOL["bfloat16"]
    for net in PAPER_NETWORKS:
        layers = []
        want_counts = {"tiled_balanced_spmm": 0,
                       "tiled_balanced_spmm_skinny": 0}
        for ls in network_layers(net, "sense"):
            conv = ls.kind == "conv"
            shape = (ls.c_o, ls.c_i, ls.h_k, ls.w_k) if conv \
                else (ls.c_o, ls.c_i)
            fan = ls.c_i * (ls.h_k * ls.w_k if conv else 1)
            w = (torch.randn(shape, generator=gen, device=DEVICE)
                 / fan ** 0.5).to(bf)
            lp, wm = prune_plan(torch, ls.name, w, layer_spec=ls,
                                m_hint=CONV_M_HINT if conv else 128,
                                stride=ls.stride, padding=ls.padding)
            xs = (1, ls.h_i, ls.w_i, ls.c_i) if conv else (1, ls.c_i)
            x = torch.randn(xs, generator=gen, device=DEVICE).to(bf)
            chunks = conv_chunks(1, ls.h_o, ls.w_o, fan) if conv else [1]
            want_counts["tiled_balanced_spmm" if conv
                        else "tiled_balanced_spmm_skinny"] += len(chunks)
            layers.append((ls, lp, wm, x, len(chunks)))
        reset_launches()
        with torch.no_grad():
            ys = [apply(ls, lp, x) for ls, lp, _, x, _ in layers]
        torch.cuda.synchronize()
        counts = launches()
        other = {k: v for k, v in counts.items()
                 if v and k not in want_counts}
        if any(counts[k] != v for k, v in want_counts.items()) or other:
            raise AssertionError(f"{net} layers launched {counts}, expected "
                                 f"{want_counts} and nothing else")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        rows = []
        with torch.no_grad():
            for (ls, lp, wm, x, n_chunks), y in zip(layers, ys):
                conv = ls.kind == "conv"
                if conv:
                    want = F.conv2d(x.permute(0, 3, 1, 2).float(), wm.float(),
                                    stride=ls.stride, padding=ls.padding
                                    ).permute(0, 2, 3, 1)
                    xc = x.permute(0, 3, 1, 2)           # channels-last
                    wc = wm.contiguous(memory_format=torch.channels_last)
                    library = lambda xc=xc, wc=wc, ls=ls: F.conv2d(  # noqa: E731,E501
                        xc, wc, stride=ls.stride, padding=ls.padding)
                else:
                    want = x.float() @ wm.float().T
                    library = lambda x=x, wm=wm: torch.matmul(x, wm.T)  # noqa: E731,E501
                err = (y.float() - want).abs()
                ok = tuple(y.shape) == tuple(want.shape) and bool(
                    torch.isfinite(y).all()) and bool(
                    (err <= tol + tol * want.abs()).all())
                if not ok:
                    raise AssertionError(f"{net} {ls.name}: the planned "
                                         f"layer differs from the masked "
                                         f"dense one: {float(err.max())}")
                tb = lp.weights
                m = ls.h_o * ls.w_o if conv else 1
                n = lp.spec.n_in
                nbytes = (x.numel() * 2 + (2 * m * n * 2 if conv else 0)
                          + tb.live_nbytes() + m * ls.c_o * 2)
                fn = lambda ls=ls, lp=lp, x=x: apply(ls, lp, x)  # noqa: E731
                rows.append({
                    "layer": ls.name, "kind": ls.kind, "M": m, "O": ls.c_o,
                    "N": n, "bn": tb.bn, "KB": tb.kb, "chunks": n_chunks,
                    "ms": time_ms(torch, fn, flush=flush, warmup=2,
                                  runs=PAPER_RUNS, spin=host_spin(torch, fn)),
                    "library_ms": time_ms(torch, library, flush=flush,
                                          warmup=2, runs=PAPER_RUNS),
                    "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "flops_ms": 2 * m * ls.c_o * tb.nb * tb.bn
                    / PEAK_FLOPS["bfloat16"] * 1e3,
                    "max_abs_err": float(err.max())})
        for row in rows:
            log(f"paper {net} " + json.dumps(row))
        conv_rows = [r for r in rows if r["kind"] == "conv"]
        summary = {"net": net, "layers": len(rows), "conv": len(conv_rows),
                   "sparse_ms": sum(r["ms"] for r in rows),
                   "library_ms": sum(r["library_ms"] for r in rows),
                   "bytes_bound_ms": sum(r["bytes_ms"] for r in rows),
                   "flops_bound_ms": sum(r["flops_ms"] for r in rows),
                   "conv_sparse_ms": sum(r["ms"] for r in conv_rows),
                   "conv_library_ms": sum(r["library_ms"] for r in conv_rows),
                   "launches": {k: v for k, v in counts.items() if v},
                   "max_abs_err": max(r["max_abs_err"] for r in rows)}
        log(f"paper layers {json.dumps(summary)}")
        if net == "vgg16":
            log("vgg16 profile " + json.dumps(profile_layers(torch, apply,
                                                             layers)))
        del layers, ys
    return total


def load_example(name: str):
    """The example script ``examples/<name>.py`` as a module: the entry
    point a user runs, driven here as a user would run it."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_parts(prof) -> dict:
    """Device ms of a profiled train step by part: each kernel is charged
    to the host range that launched it (its CPU ancestors in the trace):
    ``train.forward`` (the tiled kernels apart), the backward's autograd
    functions (the im2col's ``UnfoldBackward``, the GEMMs, the rest) and
    ``train.optimizer``; with the backward's device ms per autograd
    function."""
    from torch.autograd import DeviceType
    parts: dict = {}
    by_fn: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        names, e = [], evt
        while e is not None:
            names.append(e.name)
            e = e.cpu_parent
        bwd = next((n for n in names
                    if n.startswith("autograd::engine::evaluate_function")),
                   None)
        for k in evt.kernels:
            ms = k.duration / 1e3
            if "train.optimizer" in names:
                part = "optimizer"
            elif bwd is not None:
                if "Unfold" in bwd:
                    part = "im2col backward"
                elif "gemm" in k.name.lower():
                    part = "backward matmuls"
                else:
                    part = "backward other"
                fn = bwd.split(":")[-1].strip()
                by_fn[fn] = by_fn.get(fn, 0.0) + ms
            elif "train.forward" in names:
                part = "forward tiled kernels" if "spmm" in k.name \
                    else "forward other"
            else:
                part = "unattributed"
            parts[part] = parts.get(part, 0.0) + ms
    return {"parts_ms": parts, "backward_by_function_ms": dict(
        sorted(by_fn.items(), key=lambda kv: -kv[1])[:8])}


def cnn_train(torch) -> dict:
    """Phase 14: the paper's prune -> retrain flow (Fig. 5) through its
    entry point, `examples/torch_train_sparse_cnn.py`, at smallcnn's full
    config, batch 64, f32: 300 dense steps, balanced pruning (convs 0.5
    per kernel, fc 0.8 by magnitude, so dense), 150 masked retraining
    steps.  First, on one fixed batch, the loss and every gradient leaf of
    the ``cuda`` rung (the tiled kernels forward) are held at 1e-4 against
    the eager ``xla`` rung, both on the card: through a plan built in the
    loss, and through the `TrainPlan` that the retraining steps run, with
    these masks and with fc1 / fc2 balanced-pruned (0.8 per row).  The
    counts are zeroed just before the flow and read just after; after
    every retraining step every pruned position must be exactly 0.0,
    every conv kernel must hold
    exactly K nonzeros, and the step must have launched the tiled kernel
    once per im2col chunk of the forward and nothing else.  The example
    fails unless the final sparse accuracy is within 0.05 of the dense
    one.  Then one step with the counts read after the forward and after
    the update (the backward and the optimizer launch no spmm kernel); one
    step at batch 4 with fc1 / fc2 balanced-pruned (0.8 per row), which
    must launch the skinny kernel for them; the median wall ms per
    retraining step beside its masked-dense twin (``impl="dense"``:
    ``F.conv2d`` on the masked weight) and both steps' device ms under the
    timer; and a `torch.profiler` split of one sparse step.  Returns the
    flow's launches."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core.pruning import balanced_prune_rows
    from repro_torch.data import SyntheticImageData
    from repro_torch.engine.plan import TrainPlan, plan_smallcnn
    from repro_torch.models import cnn
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   apply_masks, value_and_grad)
    example = load_example("torch_train_sparse_cnn")
    cfg = cnn.SmallCNNConfig()
    b = CNN_TRAIN_BATCH
    data = SyntheticImageData(batch=b, device=DEVICE)
    n_chunks = 0
    hw, cin = cfg.img, 3
    for cout in cfg.channels:
        n_chunks += len(conv_chunks(b, hw, hw, cin * cfg.kernel ** 2))
        hw, cin = hw // 2, cout

    # the example's pruning of seed-0 weights
    params = cnn.smallcnn_init(cfg, torch.Generator(
        device=DEVICE).manual_seed(0))
    masks = {}
    for i in range(len(cfg.channels)):
        _, masks[f"conv{i}"] = example.balanced_prune_conv(
            params[f"conv{i}"], 0.5)
    for name in ("fc1", "fc2"):
        _, masks[name] = example.random_prune(params[name], 0.8)
    params = apply_masks(params, masks)
    batch = data.batch_at(0)

    # gradients: the cuda rung against the eager xla rung on one batch,
    # through a plan built in the loss and through the retraining step's
    # `TrainPlan`; the latter also with fc1 / fc2 balanced-pruned (0.8 per
    # row: the skinny step's masks), so that every layer is a tiled one
    smasks = dict(masks)
    for name in ("fc1", "fc2"):
        _, smasks[name] = balanced_prune_rows(params[name], 0.8)
    sparams = apply_masks(params, smasks)
    worst: dict = {}
    for what, p0, mk in (("", params, masks),
                         (" (balanced fc)", sparams, smasks)):
        rloss, rg = value_and_grad(
            lambda p, mk=mk: cnn.smallcnn_loss(cfg, p, batch, masks=mk,
                                               impl="xla"), p0)
        tp = TrainPlan(plan_smallcnn(cfg, p0, mk, impl="cuda"), mk)
        runs = {"TrainPlan": lambda p, mk=mk, tp=tp: cnn.smallcnn_loss(
            cfg, p, batch, masks=mk, plan=tp(p))}
        if mk is masks:
            runs["plan in the loss"] = lambda p: cnn.smallcnn_loss(
                cfg, p, batch, masks=masks, impl="cuda")
        for how, fn in runs.items():
            loss, g = value_and_grad(fn, p0)
            compare(torch, worst, "cnn train grads", loss, rloss,
                    TOL["float32"], f"loss, cuda ({how}{what}) vs xla rung")
            for nm in p0:
                compare(torch, worst, "cnn train grads", g[nm], rg[nm],
                        TOL["float32"],
                        f"d{nm}, cuda ({how}{what}) vs xla rung")

    # the flow, checked after every retraining step; its evaluations run
    # `cnn.EVAL_BATCHES` batches each through the pruned plan (the dense
    # ones launch none)
    seen = {"steps": 0, "last": cnn.EVAL_BATCHES * n_chunks}

    def check_step(s, p, loss, flow_masks):
        now = launches()
        step = {k: v for k, v in now.items() if v}
        step["tiled_balanced_spmm"] -= seen["last"]
        if step != {"tiled_balanced_spmm": n_chunks} \
                or not bool(torch.isfinite(loss)):
            raise AssertionError(f"retrain step {s} launched {step}, "
                                 f"expected {n_chunks} tiled launches; "
                                 f"loss {float(loss)}")
        seen["last"] = now["tiled_balanced_spmm"]
        for nm, m in flow_masks.items():
            if bool((p[nm][m == 0] != 0).any()):
                raise AssertionError(f"retrain step {s}: a pruned weight "
                                     f"of {nm} is not 0.0")
        for i in range(len(cfg.channels)):
            m = flow_masks[f"conv{i}"]
            k = (m.reshape(m.shape[0], -1) != 0).sum(dim=1)
            w = p[f"conv{i}"]
            nz = (w.reshape(w.shape[0], -1) != 0).sum(dim=1)
            if not (bool((k == k[0]).all()) and torch.equal(nz, k)):
                raise AssertionError(f"retrain step {s}: conv{i} kernels "
                                     f"hold {nz.tolist()} nonzeros, masks "
                                     f"{k.tolist()}")
        seen["steps"] += 1

    reset_launches()
    t0 = time.monotonic()
    res = example.run(device=DEVICE, steps=CNN_TRAIN_STEPS[0],
                      retrain_steps=CNN_TRAIN_STEPS[1],
                      on_retrain_step=check_step, log=log)
    torch.cuda.synchronize()
    counts = launches()
    flow_s = time.monotonic() - t0
    want = (2 * cnn.EVAL_BATCHES + CNN_TRAIN_STEPS[1]) * n_chunks
    if seen["steps"] != CNN_TRAIN_STEPS[1] \
            or counts["tiled_balanced_spmm"] != want:
        raise AssertionError(f"checked {seen['steps']} retrain steps; "
                             f"launches {counts}, expected {want} tiled")
    log(f"cnn train flow {flow_s:.1f} s: accuracy dense "
        f"{res['acc_dense']:.3f}, pruned {res['acc_pruned']:.3f}, final "
        f"{res['acc_final']:.3f}; systolic speedup "
        f"{res['systolic_speedup']:.2f}x; launches {json.dumps(counts)}")

    # one step: the forward's launches, then the backward's and the update's
    opt = AdamWConfig(lr=3e-4, warmup_steps=20,
                      total_steps=CNN_TRAIN_STEPS[1], weight_decay=0.01)
    state = adamw_init(params)
    plans = {impl: TrainPlan(plan_smallcnn(cfg, params, masks, impl=impl),
                             masks) for impl in ("cuda", "dense")}

    def step(impl):
        def loss_fn(p):
            with record_function("train.forward"):
                out = cnn.smallcnn_loss(cfg, p, batch, masks=masks,
                                        impl=impl, plan=plans[impl](p))
            marks.append(launches()["tiled_balanced_spmm"])
            return out
        with record_function("train.grad"):
            loss, grads = value_and_grad(loss_fn, params)
        with record_function("train.optimizer"):
            p, s, _ = adamw_update(opt, params, grads, state)
            p = apply_masks(p, masks)
        return p, s, loss

    marks = []
    reset_launches()
    step("cuda")
    torch.cuda.synchronize()
    after = {k: v for k, v in launches().items() if v}
    if marks != [n_chunks] or after != {"tiled_balanced_spmm": n_chunks}:
        raise AssertionError(f"one retrain step: {marks} tiled launches "
                             f"after the forward, {after} after the update "
                             f"(expected {n_chunks} and no other)")

    # the skinny kernel: batch 4, fc1 / fc2 balanced-pruned
    sb = SyntheticImageData(batch=SKINNY_TRAIN_BATCH, device=DEVICE)
    tp = TrainPlan(plan_smallcnn(cfg, sparams, smasks), smasks)
    reset_launches()
    cnn.smallcnn_train_step(cfg, sparams, adamw_init(sparams), sb.batch_at(0),
                            opt, masks=smasks, plan=tp)
    torch.cuda.synchronize()
    skinny = {k: v for k, v in launches().items() if v}
    if skinny != {"tiled_balanced_spmm": len(cfg.channels),
                  "tiled_balanced_spmm_skinny": 2}:
        raise AssertionError(f"the batch-{SKINNY_TRAIN_BATCH} step launched "
                             f"{skinny}: expected one wide launch a conv "
                             "and one skinny for each of fc1, fc2")

    # times: wall ms per step (host clock, synchronized), then device ms
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    timing = {"batch": b}
    for impl in ("cuda", "dense"):
        walls = []
        for _ in range(3 + TRAIN_STEP_RUNS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            step(impl)
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        fn = lambda impl=impl: step(impl)  # noqa: E731
        timing[impl] = {
            "wall_ms": statistics.median(walls[3:]),
            "device_ms": time_ms(torch, fn, flush=flush, warmup=2,
                                 runs=TRAIN_STEP_RUNS,
                                 spin=host_spin(torch, fn))}
    marks.clear()

    # one sparse step under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step("cuda")
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    # the kernels only: the host ranges also show on the device's timeline
    parts = kernel_parts(prof)
    busy_ms = sum(parts["parts_ms"].values())
    top = [k for k in device_kernels(prof)[2]
           if not k["kernel"].startswith("train.")]
    split = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
             "busy_share": busy_ms / wall_ms, **parts, "top": top[:6]}
    log(f"cnn train step {json.dumps(timing)}")
    log(f"cnn train step profile {json.dumps(split)}")
    # the path's launches: the flow's and the batch-4 step's
    return {k: v + skinny.get(k, 0) for k, v in counts.items()}


def lm_train(torch) -> dict:
    """Phase 15: `launch.train` at full olmo-1b width (d_model 2048, d_ff
    8192, vocab 50304), depth cut to `LM_TRAIN_LAYERS`, batch 8, seq 128,
    `LM_TRAIN_STEPS` steps (f32 params, bf16 compute, AdamW, every step
    logged) into a temporary checkpoint directory, deleted afterwards:
    loss and grad norm finite at every step, the forced final checkpoint
    passes `verify_checkpoint`, the peak device memory and the ms per
    step (the trainer's clock, taken after the card finished the step).
    Then the same run stopped one step short and resumed (``--resume``)
    must reach the uninterrupted run's params and optimizer state, bitwise
    (every step is in the 20-step warmup, so the learning rate does not
    depend on the run's length)."""
    import tempfile
    from repro_torch.checkpoint import latest_step, verify_checkpoint
    from repro_torch.launch import train
    from repro_torch.tree import flatten_with_paths

    def run(ckpt_dir, steps, *extra):
        args = train.build_parser().parse_args(
            LM_TRAIN_ARGS + ["--steps", str(steps), "--ckpt-dir", ckpt_dir,
                             *extra])
        trainer = train.build_trainer(args)
        trainer.cfg.log_every = 1
        res = train.run(args, trainer)
        torch.cuda.synchronize()
        return res, trainer

    with tempfile.TemporaryDirectory() as tmp:
        full, resumed = f"{tmp}/full", f"{tmp}/resumed"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res, trainer = run(full, LM_TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated()
        run_s = time.monotonic() - t0
        log_ = trainer.metrics_log
        if res["status"] != "done" or len(log_) != LM_TRAIN_STEPS or not all(
                math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                for m in log_):
            raise AssertionError(f"lm train: {res}, log {log_}")
        t1 = time.monotonic()
        problems = verify_checkpoint(full, LM_TRAIN_STEPS)
        verify_s = time.monotonic() - t1
        if latest_step(full) != LM_TRAIN_STEPS or problems:
            raise AssertionError(f"lm train checkpoint: latest "
                                 f"{latest_step(full)}, {problems}")
        want = [t for _, t in flatten_with_paths(
            {"params": trainer.params, "opt": trainer.opt_state})]
        names = [p for p, _ in flatten_with_paths(
            {"params": trainer.params, "opt": trainer.opt_state})]
        n_params = sum(t.numel() for _, t in flatten_with_paths(
            trainer.params))
        del trainer
        torch.cuda.empty_cache()
        run(resumed, LM_TRAIN_STEPS - 1)
        torch.cuda.empty_cache()
        res2, again = run(resumed, LM_TRAIN_STEPS, "--resume")
        got = [t for _, t in flatten_with_paths(
            {"params": again.params, "opt": again.opt_state})]
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(got, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
        if res2["status"] != "done" or not bitwise:
            differ = [p for p, a, b in zip(names, got, want)
                      if not torch.equal(a, b)]
            raise AssertionError(f"lm train: the resumed run differs from "
                                 f"the uninterrupted one by {diff} in "
                                 f"{differ} ({res2})")
        ckpt_bytes = sum(f.stat().st_size for f in pathlib.Path(
            full).rglob("*") if f.is_file())
    out = {"arch": "olmo-1b", "layers": LM_TRAIN_LAYERS,
           "params": n_params, "steps": LM_TRAIN_STEPS,
           "loss": [m["loss"] for m in log_],
           "grad_norm": [m["grad_norm"] for m in log_],
           "step_ms": [m["step_time_s"] * 1e3 for m in log_],
           "run_s": run_s, "verify_s": verify_s,
           "peak_memory_gib": peak / 2**30, "checkpoint_bytes": ckpt_bytes,
           "resume_bitwise": bitwise}
    log(f"lm train {json.dumps(out)}")
    return out


def tune_phase(torch, serve, tune_off: dict, paths: dict) -> None:
    """16. ``serve --tune sweep`` into a fresh cache (every key's
    candidates timed on the card: none may be quarantined, every key names
    the card), then ``--tune cached`` on it (every layer ``cached``,
    nothing timed, the parity gate, every reached kernel launched; tok/s
    beside ``--tune off``'s, a record), then ``--tune
    cached`` on an empty cache (blocks equal ``--tune off``'s)."""
    import tempfile
    from repro_torch.kernels import autotune
    card = f"|cuda:{torch.cuda.get_device_name(0)}|"
    with tempfile.TemporaryDirectory() as tmp:
        cache = pathlib.Path(tmp) / "tune.json"
        label = "olmo-1b tune sweep"
        paths[label], swept = serve_run(
            torch, serve, label,
            SERVE_ARGS + ["--tune", "sweep", "--tune-cache", str(cache)])
        entries = autotune.load_cache(cache)
        shapes = set(OLMO_PROJECTIONS.values())
        if len(entries) != 2 * len(shapes):
            raise AssertionError(f"the sweep wrote {len(entries)} keys, "
                                 f"expected {2 * len(shapes)}")
        for key, e in sorted(entries.items()):
            if card not in key:
                raise AssertionError(f"cache key {key} does not name the "
                                     f"card")
            if e.get("quarantined"):
                raise AssertionError(f"the sweep quarantined candidates of "
                                     f"{key}: {e['quarantined']}")
            cands = ", ".join(f"({c['bm']},{c['bo']},{c['bn']}) "
                              f"{c['time_s'] * 1e3:.4f}"
                              for c in e["candidates"])
            log(f"tune {key}: static ms {e['static_time_s'] * 1e3:.4f}, "
                f"winner ({e['bm']},{e['bo']},{e['bn']}) ms "
                f"{e['time_s'] * 1e3:.4f}; candidates (bm,bo,bn) ms: "
                f"{cands}")
        tune = swept["plan"]["tune"]
        log(f"tune sweep: plan (sweep included) "
            f"{swept['plan']['plan_build_s']:.2f} s, sources "
            f"{tune['sources']}, deltas {tune['deltas']}")
        stat = cache.stat()
        label = "olmo-1b tune cached"
        paths[label], cached = serve_run(
            torch, serve, label,
            SERVE_ARGS + ["--tune", "cached", "--tune-cache", str(cache)])
        n_sparse = cached["plan"]["sparse_layers"]
        stats = cached["plan"]["engine_stats"]
        if cached["plan"]["tune"]["sources"] != {"cached": n_sparse} \
                or stats.get("tuned_blocks") != stats["balanced_spmm"]:
            raise AssertionError(f"a cached build did not take every block "
                                 f"from the cache: {cached['plan']['tune']}")
        if (cache.stat().st_mtime_ns, cache.stat().st_size) != \
                (stat.st_mtime_ns, stat.st_size):
            raise AssertionError("a cached build wrote the cache")
        # tok/s of --tune cached beside --tune off (phase 4's run): a
        # record, not a gate
        for mode, res in (("off", tune_off), ("cached", cached)):
            log(f"tune {mode}: sparse tok/s "
                f"{res['sparse']['tokens_per_s']}, dense tok/s "
                f"{res['dense']['tokens_per_s']} (a record, not a gate)")
        empty = pathlib.Path(tmp) / "empty.json"
        label = "olmo-1b tune empty cache"
        paths[label], cold = serve_run(
            torch, serve, label,
            SERVE_ARGS + ["--tune", "cached", "--tune-cache", str(empty)])
        if cold["plan"]["blocks"] != tune_off["plan"]["blocks"] \
                or cold["plan"]["tune"]["sources"] != {"static": n_sparse} \
                or empty.exists():
            raise AssertionError(f"--tune cached on an empty cache: blocks "
                                 f"{cold['plan']['blocks']} vs --tune off "
                                 f"{tune_off['plan']['blocks']}")


def guard_clean(torch, serve, label: str, args: list, want: dict,
                paths: dict) -> None:
    """``serve --guard`` on a clean plan: no ladder event, no quarantine,
    no degraded dispatch, and the serving path's own launches (the guard's
    subtracted) equal to ``want``, the unguarded path's."""
    paths[label], res = serve_run(torch, serve, label, args + ["--guard"])
    g = res["guard"]
    if g["degradations"] or g["events"] or g["quarantined"] \
            or g["degraded_mix"] \
            or res["plan"]["engine_stats"].get("degraded_dispatch"):
        raise AssertionError(f"a clean plan degraded under --guard: {g}")
    main = {k: v - g["kernel_launches"].get(k, 0)
            for k, v in paths[label].items()}
    if main != want:
        raise AssertionError(f"{label}: the serving launches {main} differ "
                             f"from the unguarded path's {want}")
    log(f"{label}: validated {g['validated_layers']} layers, no degradation;"
        f" guard {g['seconds']:.2f} s, its launches "
        f"{ {k: v for k, v in g['kernel_launches'].items() if v} }")


def guard_nan(torch, serve, label: str, args: list, vocab: int,
              paths: dict) -> None:
    """``serve --guard --inject-nan``: exactly one NaN trip, blamed on the
    injected layer, which alone is quarantined to dense; the guarded pass's
    tokens are real ids; the parity gate passes on the repaired plan."""
    paths[label], res = serve_run(torch, serve, label,
                                  args + ["--guard", "--inject-nan"])
    g = res["guard"]
    trips = [e for e in g["events"] if e["event"] == "nan_trip"]
    if len(g["events"]) != 1 or len(trips) != 1 or not trips[0][
            "attributable"] or trips[0]["poisoned_layers"] != [g["injected"]] \
            or g["quarantined"] != [g["injected"]] \
            or g["degraded_mix"] != {"cuda->dense": 1} \
            or not all(0 <= t < vocab for t in g["sample"]):
        raise AssertionError(f"{label}: the NaN guard did not blame and "
                             f"quarantine the injected layer alone: {g}")
    log(f"{label}: injected {g['injected']}, trip {trips[0]}, quarantined "
        f"{g['quarantined']}, guard {g['seconds']:.2f} s")


@contextlib.contextmanager
def plain_kernels():
    """The 2-D and batched kernel entries of `kernels.ops` swapped for their
    plain versions (CUDA tensors included) while the context lasts."""
    from repro_torch.kernels import balanced_spmm as bs
    from repro_torch.kernels import ops
    saved = (ops.tiled_balanced_spmm, ops.tiled_balanced_spmm_skinny,
             ops.tiled_balanced_spmm_batched)
    ops.tiled_balanced_spmm = \
        lambda x, tb, **_: bs.tiled_balanced_spmm_plain(x, tb)
    ops.tiled_balanced_spmm_skinny = \
        lambda x, tb, **_: bs.tiled_balanced_spmm_plain(x, tb)
    ops.tiled_balanced_spmm_batched = \
        lambda x, tb, **_: bs.tiled_balanced_spmm_batched_plain(x, tb)
    try:
        yield
    finally:
        (ops.tiled_balanced_spmm, ops.tiled_balanced_spmm_skinny,
         ops.tiled_balanced_spmm_batched) = saved


def guard_moe_nan(torch, serve) -> None:
    """The MoE NaN drill through `serve.guarded_generate` on an expert
    layer (every expert's values NaN): the batched skinny kernel writes
    +0.0 for an expert no token routes to, where its plain version would
    give NaN, so the blamed layers are held equal to those of the same
    pass through the plain versions."""
    from repro_torch.engine import plan as engine_plan
    from repro_torch.testing import faults
    bundle, params, plan, prompt = full_width(torch, "bfloat16",
                                              "deepseek-moe-16b", MOE_LAYERS)
    ref_blocks = engine_plan.masked_dense_params(params, plan)["blocks"]
    poisoned, name = faults.inject_nan_output(plan, layer="we_gate")
    max_len = prompt.shape[1] + 2
    reset_launches()
    _, kern, events = serve.guarded_generate(bundle, poisoned, params, prompt,
                                             2, max_len,
                                             ref_blocks=ref_blocks)
    torch.cuda.synchronize()
    if not launches()["tiled_balanced_spmm_batched"]:
        raise AssertionError("the MoE NaN drill never ran the batched "
                             "kernel")
    with plain_kernels():
        _, plain, events_plain = serve.guarded_generate(
            bundle, poisoned, params, prompt, 2, max_len,
            ref_blocks=ref_blocks)
    if kern.quarantined() != (name,) or plain.quarantined() != (name,) \
            or events != events_plain:
        raise AssertionError(f"MoE NaN drill: kernels blame "
                             f"{kern.quarantined()} {events}, plain versions "
                             f"{plain.quarantined()} {events_plain}")
    log(f"moe NaN drill on {name}: kernels and plain versions both blame "
        f"{list(kern.quarantined())}; events {events}")


def guard_forced(torch, serve) -> None:
    """`harden_plan` under a forced ``cuda`` failure on the full-width
    olmo-1b plan: every layer moves ``cuda`` -> ``xla`` (events printed);
    a serve pass on that plan launches no tiled kernel and ticks
    ``degraded_dispatch`` on every dispatch."""
    from repro_torch.engine import execute, guard
    from repro_torch.testing import faults
    bundle, params, plan, prompt = full_width(torch, "bfloat16")
    t0 = time.monotonic()
    with faults.force_impl_failure("cuda"):
        hardened, events = guard.harden_plan(plan)
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    for e in events:
        log(f"forced cuda failure: {e.layer} {e.from_impl} -> {e.to_impl} "
            f"({e.action}: {e.reason[:100]})")
    moved = {e.layer for e in events if e.action == "demoted"}
    if moved != set(plan.layers) or hardened.impl_mix() != {
            "xla": len(plan.layers)} or any(
            e.from_impl != "cuda" for e in events):
        raise AssertionError(f"the forced cuda failure did not move every "
                             f"layer to xla: {hardened.impl_mix()}")
    reset_launches()
    execute.reset_stats()
    steps = 4
    serve.greedy_generate(bundle, {**params, "sparse_plan": hardened},
                          prompt, steps, prompt.shape[1] + steps)
    torch.cuda.synchronize()
    counts, stats = launches(), execute.stats()
    tiled = {k: v for k, v in counts.items() if k.startswith("tiled_") and v}
    if tiled or not stats.get("balanced_spmm") \
            or stats.get("degraded_dispatch") != stats["balanced_spmm"]:
        raise AssertionError(f"the demoted plan launched {tiled} or did not "
                             f"tick degraded_dispatch on every dispatch: "
                             f"{stats}")
    log(f"forced cuda failure: harden {secs:.2f} s, {len(events)} events; "
        f"a greedy pass of {steps} steps launched no tiled kernel, "
        f"degraded_dispatch {stats['degraded_dispatch']} of "
        f"{stats['balanced_spmm']} dispatches")


def guard_phase(torch, serve, olmo: dict, moe: dict, paths: dict) -> None:
    """17. the guard: clean ``--guard`` runs (olmo-1b, the MoE), the NaN
    drills (olmo-1b, int8, and the MoE against its plain versions), and
    the forced ``cuda`` failure."""
    from repro_torch.configs import get_config
    guard_clean(torch, serve, "olmo-1b guard", SERVE_ARGS, olmo, paths)
    torch.cuda.empty_cache()
    guard_clean(torch, serve, "deepseek-moe-16b guard", MOE_ARGS, moe, paths)
    torch.cuda.empty_cache()
    vocab = get_config("olmo-1b").vocab_size
    guard_nan(torch, serve, "olmo-1b guard nan", GUARD_NAN_ARGS, vocab,
              paths)
    guard_nan(torch, serve, "olmo-1b int8 guard nan",
              GUARD_NAN_ARGS + ["--quant", "int8"], vocab, paths)
    torch.cuda.empty_cache()
    guard_moe_nan(torch, serve)
    torch.cuda.empty_cache()
    guard_forced(torch, serve)
    torch.cuda.empty_cache()


def objective_phase(torch, serve, paths: dict) -> None:
    """18. olmo-1b at full width planned under every objective on two
    modeled deployment profiles: the mode and impl mix and the cost
    summary; after one prefill and one decode step every layer was
    dispatched twice per layer of the model and its counted weight bytes
    equal its tag's ``w_stream_bytes`` x dispatches (a dispatch-count and
    bookkeeping check: both sides are host arithmetic over the same stored
    tensors, not a measurement of traffic).  Then ``serve --objective dram
    --deployment edge-64k`` through its parity gate."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.engine import execute
    from repro_torch.engine import plan as engine_plan
    from repro_torch.launch import cost_model
    from repro_torch.models import build_model
    from repro_torch.models.api import merge_prefill_cache
    cfg = dataclasses.replace(get_config("olmo-1b"), sparse_serving=True)
    bundle = build_model(cfg, DEVICE)
    params = bundle.init(0)
    prompt = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(1)
                           ).to(DEVICE)
    for dep in OBJECTIVE_DEPLOYMENTS:
        for objective in cost_model.OBJECTIVES:
            t0 = time.monotonic()
            plan = engine_plan.plan_model(cfg, params, sparsity=SPARSITY,
                                          m_hint=128, objective=objective,
                                          deployment=dep)
            torch.cuda.synchronize()
            build_s = time.monotonic() - t0
            sparse = {**params, "sparse_plan": plan}
            execute.reset_stats()
            with torch.no_grad():
                lg, pfc = bundle.prefill(sparse, {"tokens": prompt})
                bundle.decode_step(
                    sparse, {"tokens": lg.argmax(-1)[:, None],
                             "cache_len": torch.full((4,), 32,
                                                     device=DEVICE)},
                    merge_prefill_cache(bundle.init_cache(4, 33), pfc))
            torch.cuda.synchronize()
            counted = execute.bytes_stats()
            for nm, lp in plan.layers.items():
                c = counted[nm]
                if c["dispatches"] != 2 * cfg.n_layers or \
                        c["bytes_weights"] != \
                        lp.spec.cost.w_stream_bytes * c["dispatches"]:
                    raise AssertionError(
                        f"{objective}/{dep} {nm}: counted {c}, tag "
                        f"{lp.spec.cost}")
            cs = plan.cost_summary()
            log(f"objective {objective} on {dep} (modeled): plan "
                f"{build_s:.2f} s, modes {plan.mode_mix()}, impls "
                f"{plan.impl_mix()}; DRAM {cs['total_dram_bytes']:.6e} B, "
                f"energy {cs['total_energy_pj']:.6e} pJ, weight stream "
                f"{cs['total_w_stream_bytes']} B; bytes_stats == tag x "
                f"dispatches for all {len(plan.layers)} layers")
            del plan, sparse
    del bundle, params
    torch.cuda.empty_cache()
    label = "olmo-1b objective dram edge-64k"
    paths[label], res = serve_run(
        torch, serve, label,
        SERVE_ARGS + ["--objective", "dram", "--deployment", "edge-64k"])
    cs = res["plan"]["cost"]
    if (cs["objective"], cs["deployment"]) != ("dram", "edge-64k"):
        raise AssertionError(f"the served plan's cost summary: {cs}")
    log(f"{label}: modes {res['plan']['mode_mix']}, impls "
        f"{res['plan']['impl_mix']}, modeled DRAM "
        f"{cs['total_dram_bytes']:.6e} B")


def check_new_shapes(torch, worst: dict) -> list:
    """Phase 3, extended: rows 1 and 2 in bf16 at the new families'
    projection shapes (`NEW_SHAPES`), at the prefill M (128) and the decode
    M (4), each against its plain version at the f32 tolerance and timed
    beside ``torch.matmul`` on the masked dense weight and its bound; the
    wide rows carry the kernel's splits and CTAs, the skinny ones the
    streamer's x column ranges (1: x resident)."""
    from repro_torch.kernels import balanced_spmm as bs
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for arch, shapes in NEW_SHAPES.items():
        for o, n in shapes:
            tb, w_masked = make_encoding(torch, o, n, torch.bfloat16, gen)
            wd = w_masked.to(torch.bfloat16)
            for m in NEW_SHAPE_MS:
                wide = m > SKINNY_M
                name = "tiled_balanced_spmm" + ("" if wide else "_skinny")
                fn = bs.tiled_balanced_spmm if wide \
                    else bs.tiled_balanced_spmm_skinny
                x = torch.randn((m, n), generator=gen,
                                device=DEVICE).to(torch.bfloat16)
                kern = lambda: fn(x, tb)  # noqa: E731
                compare(torch, worst, name, kern(),
                        bs.tiled_balanced_spmm_plain(x, tb), KERNEL_TOL,
                        f"{arch} bf16 M={m} O={o} N={n} KB={tb.kb}")
                row = {"name": name, "arch": arch, "M": m, "O": o, "N": n,
                       "KB": tb.kb, "ms": time_ms(torch, kern, flush=flush),
                       "library_ms": time_ms(
                           torch, lambda: torch.matmul(x, wd.T),
                           flush=flush),
                       **bound(tb, x, m, m * o, "bfloat16")}
                if wide:
                    splits = bs.wide_splits(m, o, tb.nb, sms=sms)
                    row.update(splits=splits, ctas=splits * -(-o // bs.TC_BO)
                               * -(-m // bs.token_tile(m)))
                else:
                    row["x_ranges"] = bs.stream_x_ranges(
                        n, tb.bn, bs.stream_block_bytes(tb.kb))
                rows.append(row)
                log("time  " + json.dumps(row))
            del tb, w_masked, wd
    return rows


def slice7_serve(torch, serve, arch: str, quant: str = "none") -> tuple:
    """Phases 19-20: ``arch`` through the serve entry point (`serve_run`:
    counts zeroed just before, read just after; the parity gate inside),
    at published width and depth; every planned projection on the
    ``cuda`` rung, and the wide (or ``_q``) launches equal to planned
    projections x layers x `SERVE_PREFILLS`, the skinny ones that x
    `SERVE_DECODE_STEPS`.  Logs the peak device memory; returns
    ``(label, counts)``."""
    label = arch + ("" if quant == "none" else f" {quant}")
    args = ["--arch", arch, *SLICE7_ARGS, "--quant", quant]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts, res = serve_run(torch, serve, label, args)
    plan = res["plan"]
    n_proj, layers = len(plan["block_k"]), plan["n_layers"]
    if plan["impl_mix"] != {"cuda": n_proj}:
        raise AssertionError(f"{label}: not every projection on the cuda "
                             f"rung: {plan['impl_mix']}")
    sfx = "" if quant == "none" else "_q"
    want = {"tiled_balanced_spmm" + sfx: n_proj * layers * SERVE_PREFILLS,
            "tiled_balanced_spmm_skinny" + sfx:
                n_proj * layers * SERVE_DECODE_STEPS}
    log(f"{label}: {n_proj} planned projections x {layers} layers; "
        f"launches {dict((k, counts[k]) for k in want)}, expected {want}; "
        f"serve peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    bad = {k: counts[k] for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{label}: launches {bad}, expected {want}")
    return label, counts


def recurrent_phase(torch, serve, paths: dict) -> None:
    """Phase 19: rwkv6-3b and zamba2-1.2b at published width and depth:
    the serve entry point (`slice7_serve`), the float32 end-to-end parity,
    a profile of one sparse generation with the recurrence's device time,
    then ``serve --quant int8`` of zamba2-1.2b (rows 3 and 4)."""
    for arch in RECURRENT_ARCHS:
        label, paths[label] = slice7_serve(torch, serve, arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        parity = recurrent_f32_parity(torch, serve, arch)
        log(f"{arch} float32 compute, full width, end to end: "
            f"{json.dumps(parity)}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
        log(f"{arch} profile " + json.dumps(profile_generate(
            torch, serve, arch=arch, n_layers=PROFILE_LAYERS)))
        torch.cuda.empty_cache()
    arch, quant = RECURRENT_QUANT
    label, paths[label] = slice7_serve(torch, serve, arch, quant)


def frontend_prefill(torch, arch: str) -> dict:
    """Phase 20's frontend check: ``arch`` at published width and depth, a
    seeded prefill of `FRONTEND_BATCH` x `FRONTEND_PROMPT` tokens whose
    first n_frontend_tokens positions take seeded bf16 frontend rows.  In
    bf16 the sparse plan against its masked-dense reference sublayer by
    sublayer (serve's gate, `serve.gate_block`) at 2e-2, with the wide
    launches counted (zeroed just before, read just after: one a planned
    projection and layer); in float32 the prefill logits end to end at
    1e-4.  Returns the bf16 pass's launch counts."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.engine import plan as engine_plan
    from repro_torch.launch.serve import _compare, gate_block
    from repro_torch.models import build_model, transformer
    out: dict = {}
    for cd in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config(arch), sparse_serving=True,
                                  compute_dtype=cd)
        bundle = build_model(cfg, DEVICE)
        params = bundle.init(0)
        gen = torch.Generator().manual_seed(2)
        tokens = torch.randint(0, cfg.vocab_size,
                               (FRONTEND_BATCH, FRONTEND_PROMPT),
                               generator=gen).to(DEVICE)
        fe = torch.randn((FRONTEND_BATCH, cfg.n_frontend_tokens,
                          cfg.frontend_dim), generator=gen).to(
                              DEVICE, torch.bfloat16)
        plan = engine_plan.plan_model(
            cfg, params, sparsity=SPARSITY,
            m_hint=FRONTEND_BATCH * FRONTEND_PROMPT)
        sparse = {**params, "sparse_plan": plan}
        ref = engine_plan.masked_dense_params(params, plan)
        with torch.no_grad():
            if cd == "bfloat16":
                reset_launches()
                rows = [(d.block, *row) for d in transformer.sublayer_diffs(
                    cfg, sparse, ref, tokens, frontend_embed=fe)
                    for row in gate_block(d, TOL[cd])]
                torch.cuda.synchronize()
                counts = launches()
                want = len(plan.layers) * cfg.n_layers
                out["counts"] = counts
                out["bf16_layer_max_abs_diff"] = max(
                    r[2] for r in rows if r[1] == "output")
                out["bf16_gate_excess"] = max(
                    r[4] for r in rows if r[1] != "output")
                bad = [f"{r[0]} {r[1]}" for r in rows if not r[3]]
                if bad or counts["tiled_balanced_spmm"] != want \
                        or counts["tiled_balanced_spmm_skinny"]:
                    raise AssertionError(
                        f"{arch} frontend prefill: sublayers past 2e-2 "
                        f"{bad}, launches {counts}, expected {want} wide")
            else:
                batch = {"tokens": tokens, "frontend_embed": fe}
                logits_s, _ = bundle.prefill(sparse, batch)
                logits_r, _ = bundle.prefill(ref, batch)
                diff, ok = _compare(logits_s, logits_r, TOL[cd])
                out["f32_logits_max_abs_diff"] = diff
                if not ok:
                    raise AssertionError(f"{arch} frontend prefill: f32 "
                                         f"logits differ by {diff}")
        del bundle, params, plan, sparse, ref
        torch.cuda.empty_cache()
    log(f"{arch} frontend prefill (batch {FRONTEND_BATCH} x "
        f"{FRONTEND_PROMPT}, M = {FRONTEND_BATCH * FRONTEND_PROMPT}, "
        f"{get_config(arch).n_layers} layers): "
        + json.dumps({k: v for k, v in out.items() if k != "counts"}))
    return out["counts"]


def frontend_phase(torch, serve, paths: dict) -> None:
    """Phase 20: musicgen-medium and internvl2-2b at published width
    through the serve entry point (`slice7_serve`), then the frontend
    prefill check (`frontend_prefill`)."""
    for arch in FRONTEND_ARCHS:
        label, paths[label] = slice7_serve(torch, serve, arch)
        torch.cuda.empty_cache()
        paths[f"{arch} frontend"] = frontend_prefill(torch, arch)


def attention_forms(torch) -> dict:
    """Phase 21 (a): the chunked prefill attention (`models.layers
    .blocked_causal_attention` at olmo-1b's chunks) against its unchunked
    twin (`causal_attention`) on the card at `ATTN_SHAPE`, f32 within 1e-4
    and bf16 inputs within 2e-2, each form's time and peak memory; then
    the chunk-dependent non-finite rule on the card: a NaN key row in the
    first of four kv chunks, the chunked form on the card against itself
    on the CPU at 1e-4 (f32), `LONG_POISON_REPEATS` times on the same
    inputs, each reading held."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = get_config("olmo-1b")
    b, s, h, dh = ATTN_SHAPE
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    qkv = [torch.randn((b, s, h, dh), generator=gen, device=DEVICE)
           for _ in range(3)]
    flush = torch.empty(64 * 1024 * 1024 // 4, device=DEVICE)
    out: dict = {"shape": list(ATTN_SHAPE),
                 "chunks": [cfg.q_chunk, cfg.kv_chunk]}
    for dname in ("float32", "bfloat16"):
        q, k, v = (t.to(getattr(torch, dname)) for t in qkv)
        forms = {
            "blocked": lambda: layers.blocked_causal_attention(
                q, k, v, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk),
            "unchunked": lambda: layers.causal_attention(q, k, v)}
        got = {}
        for name, fn in forms.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                y = fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            with torch.no_grad():
                ms = time_ms(torch, fn, flush=flush, warmup=1, runs=5,
                             spin=10 * SPIN_CYCLES)
            got[name] = y
            out[f"{dname} {name}"] = {"ms": ms, "peak_bytes": peak}
        err = float((got["blocked"].float()
                     - got["unchunked"].float()).abs().max())
        out[f"{dname} max_abs_err"] = err
        if not (err <= TOL[dname]
                and bool(torch.isfinite(got["blocked"]).all())):
            raise AssertionError(f"chunked vs unchunked attention, {dname}: "
                                 f"max |diff| {err} > {TOL[dname]}")
        del got, q, k, v
    s_p, chunk = LONG_POISON
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((1, s_p, h, dh), generator=gen) for _ in range(3))
    k[:, LONG_POISON_ROW] = float("nan")
    readings, finite = [], True
    for _ in range(LONG_POISON_REPEATS):
        cpu = layers.blocked_causal_attention(q, k, v, q_chunk=chunk,
                                              kv_chunk=chunk)
        card = layers.blocked_causal_attention(
            q.to(DEVICE), k.to(DEVICE), v.to(DEVICE), q_chunk=chunk,
            kv_chunk=chunk).cpu()
        readings.append(float((card - cpu).abs().max()))
        finite = finite and bool(torch.isfinite(card).all())
    unchunked = float((layers.causal_attention(q, k, v) - cpu).abs().max())
    out["poisoned"] = {"S": s_p, "chunk": chunk, "row": LONG_POISON_ROW,
                       "repeats": LONG_POISON_REPEATS,
                       "card_vs_cpu_max_abs_err": max(readings),
                       "spread": max(readings) - min(readings),
                       "readings": readings,
                       "unchunked_vs_chunked_max_abs_diff": unchunked}
    if not (max(readings) <= TOL["float32"] and finite):
        raise AssertionError(f"the chunked attention's non-finite rule "
                             f"differs on the card: {out['poisoned']}")
    return out


def long_bf16_witness(torch, paths: dict) -> dict:
    """Phase 21 (b), the bf16 witness: olmo-1b at published width, depth
    cut to `WITNESS_LAYERS`, one `LONG_PROMPT`-token prompt, planned at
    bf16 as serve plans it.  Walks the float32 masked-dense prefill and, at every layer, runs
    the block from its float32 input three ways: float32 masked-dense (the
    reference), bf16 masked-dense and bf16 sparse (the plan's tensor-core
    wide kernel; its launches counted from just before the first layer to
    just after the last).  Per layer, the two bf16 outputs' relative RMS
    and max |diff| against the reference: the sparse one's relative RMS
    within `WITNESS_RATIO` x the dense one's, both within
    `WITNESS_REL`."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.engine import plan as engine_plan
    from repro_torch.models import build_model, transformer
    cfg16 = dataclasses.replace(get_config("olmo-1b"), sparse_serving=True,
                                n_layers=WITNESS_LAYERS)
    cfg32 = dataclasses.replace(cfg16, compute_dtype="float32")
    params = build_model(cfg16, DEVICE).init(0)
    prompt = torch.randint(0, cfg16.vocab_size, (1, LONG_PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).to(DEVICE)
    plan = engine_plan.plan_model(cfg16, params, sparsity=SPARSITY,
                                  m_hint=LONG_PROMPT)
    ref = engine_plan.masked_dense_params(params, plan)
    positions = torch.arange(LONG_PROMPT, device=DEVICE)[None]
    t0 = time.monotonic()
    reset_launches()
    rows = []
    with torch.no_grad():
        h = transformer._embed_tokens(cfg32, ref, {"tokens": prompt})
        for i in range(cfg16.n_layers):
            lp = {k: w[i] for k, w in params["blocks"].items()}
            ref_lp = {k: w[i] for k, w in ref["blocks"].items()}
            want = transformer._block(cfg32, h, ref_lp, positions)[0]
            h16 = h.to(torch.bfloat16)
            got = {
                "dense": transformer._block(cfg16, h16, ref_lp,
                                            positions)[0],
                "sparse": transformer._block(
                    cfg16, h16, lp, positions,
                    plan_layers=plan.per_layer[i])[0]}
            norm = float(want.norm())
            row = {"layer": i}
            for name, y in got.items():
                d = y.float() - want
                row[f"{name}_rel_rms"] = float(d.norm()) / norm
                row[f"{name}_max_abs"] = float(d.abs().max())
            row["finite"] = all(bool(torch.isfinite(y).all())
                                for y in got.values())
            rows.append(row)
            h = want
            del got, want, h16
    torch.cuda.synchronize()
    counts = launches()
    paths[WITNESS_LABEL] = counts
    want_counts = {"tiled_balanced_spmm": len(plan.per_layer[0])
                   * cfg16.n_layers}
    out = {"layers": rows, "launches": {k: v for k, v in counts.items()
                                        if v},
           "expected_launches": want_counts,
           "seconds": time.monotonic() - t0,
           "worst_ratio": max(r["sparse_rel_rms"] / r["dense_rel_rms"]
                              for r in rows),
           "worst_rel_rms": max(max(r["sparse_rel_rms"], r["dense_rel_rms"])
                                for r in rows)}
    bad = [r["layer"] for r in rows if not (
        r["finite"] and r["sparse_rel_rms"] <= WITNESS_RATIO
        * r["dense_rel_rms"] and max(r["sparse_rel_rms"],
                                     r["dense_rel_rms"]) <= WITNESS_REL)]
    if bad or out["launches"] != want_counts:
        raise AssertionError(f"{WITNESS_LABEL}: layers {bad} out of "
                             f"bounds or launches off: {json.dumps(out)}")
    return out


def long_prefill_profile(torch) -> dict:
    """Phase 21 (b): olmo-1b at published width and depth, bf16, planned
    as serve plans it: the wall time of one sparse prefill of
    `LONG_PROMPT` tokens (clocks read after a synchronize), the bytes of
    its params and of the cache it returns; then a `torch.profiler` trace
    of one sparse prefill of the same prompt at `LONG_PROFILE_LAYERS`
    layers (the first ones' weights, planned alike): the device's busy
    share, the device time inside the `ATTENTION_RANGE` ranges (one a
    `blocked_causal_attention` call) and in the tensor-core wide
    kernel."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    from repro_torch.configs import get_config
    from repro_torch.engine import plan as engine_plan
    from repro_torch.models import build_model, layers
    cfg = dataclasses.replace(get_config("olmo-1b"), sparse_serving=True)
    bundle = build_model(cfg, DEVICE)
    params = bundle.init(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).to(DEVICE)
    plan = engine_plan.plan_model(cfg, params, sparsity=SPARSITY,
                                  m_hint=LONG_PROMPT)
    out = {"param_bytes": sum(t.numel() * t.element_size()
                              for t in params["blocks"].values())
           + sum(params[k].numel() * params[k].element_size()
                 for k in ("embed", "final_norm"))}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.no_grad():
        _, cache = bundle.prefill({**params, "sparse_plan": plan},
                                  {"tokens": prompt})
    torch.cuda.synchronize()
    out["prefill_wall_s"] = time.monotonic() - t0
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in cache.values())
    del cache, plan, bundle
    torch.cuda.empty_cache()
    out["wide_at_long_m"] = long_wide_kernel(torch)
    cut = dataclasses.replace(cfg, n_layers=LONG_PROFILE_LAYERS)
    params = {**params, "blocks": {k: w[:LONG_PROFILE_LAYERS]
                                   for k, w in params["blocks"].items()}}
    plan = engine_plan.plan_model(cut, params, sparsity=SPARSITY,
                                  m_hint=LONG_PROMPT)
    bundle = build_model(cut, DEVICE)
    sparse = {**params, "sparse_plan": plan}
    with torch.no_grad():
        bundle.prefill(sparse, {"tokens": prompt})            # warm
        torch.cuda.synchronize()
        with ranged_calls(layers, "blocked_causal_attention",
                          ATTENTION_RANGE), profile(activities=[
                              ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            bundle.prefill(sparse, {"tokens": prompt})
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3
    by_name, busy_ms, top = device_kernels(prof)
    ranges = [e for e in prof.events() if e.name == ATTENTION_RANGE
              and e.device_type == DeviceType.CPU]
    if len(ranges) != LONG_PROFILE_LAYERS:
        raise AssertionError(f"{len(ranges)} attention ranges traced, "
                             f"expected {LONG_PROFILE_LAYERS}")
    attn_ms = sum(e.device_time_total for e in ranges) / 1e3
    wide = wide_kernels(by_name)
    wide_ms = sum(w["ms"] for w in wide)
    out["profile"] = {
        "layers": LONG_PROFILE_LAYERS, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
        "attention_device_ms": attn_ms,
        "attention_share_of_busy": attn_ms / busy_ms,
        "wide_kernel_ms": wide_ms, "wide_share_of_busy": wide_ms / busy_ms,
        "wide": wide, "top": top}
    return out


def long_wide_kernel(torch) -> list:
    """Row 1 in bf16 at M = `LONG_PROMPT` (the long prefill's GEMM M) at
    olmo-1b's projection shapes: against its plain version at the f32
    tolerance (both are f32 sums of the same products), timed beside
    ``torch.matmul`` on the masked dense weight and its bound."""
    from repro_torch.kernels import balanced_spmm as bs
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    flush = torch.empty(256 * 1024 * 1024 // 4, device=DEVICE)
    worst: dict = {}
    rows = []
    m = LONG_PROMPT
    for o, n in LONG_KERNEL_SHAPES:
        tb, w_masked = make_encoding(torch, o, n, torch.bfloat16, gen)
        wd = w_masked.to(torch.bfloat16)
        x = torch.randn((m, n), generator=gen, device=DEVICE).to(
            torch.bfloat16)
        kern = lambda: bs.tiled_balanced_spmm(x, tb)  # noqa: E731
        compare(torch, worst, "tiled_balanced_spmm", kern(),
                bs.tiled_balanced_spmm_plain(x, tb), KERNEL_TOL,
                f"long prefill bf16 M={m} O={o} N={n} KB={tb.kb}")
        rows.append({"M": m, "O": o, "N": n, "KB": tb.kb,
                     "ms": time_ms(torch, kern, flush=flush, runs=5),
                     "library_ms": time_ms(
                         torch, lambda: torch.matmul(x, wd.T), flush=flush,
                         runs=5),
                     **bound(tb, x, m, m * o, "bfloat16")})
        del tb, w_masked, wd, x
    log(f"wide kernel at M = {m}, max |err| vs plain "
        f"{worst['tiled_balanced_spmm']:.3g}: " + json.dumps(rows))
    return rows


def long_f32_parity(torch, serve) -> dict:
    """Phase 21 (c): olmo-1b at published width, depth cut to
    `LONG_F32_LAYERS`, float32 compute, one `LONG_F32_PROMPT`-token prompt:
    the sparse plan against its masked-dense reference (serve's parity
    check: every block teacher-forced and the prefill logits end to end,
    1e-4)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.engine import plan as engine_plan
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("olmo-1b"), sparse_serving=True,
                              compute_dtype="float32",
                              n_layers=LONG_F32_LAYERS)
    bundle = build_model(cfg, DEVICE)
    params = bundle.init(0)
    prompt = torch.randint(0, cfg.vocab_size, (1, LONG_F32_PROMPT),
                           generator=torch.Generator().manual_seed(1)
                           ).to(DEVICE)
    plan = engine_plan.plan_model(cfg, params, sparsity=SPARSITY,
                                  m_hint=LONG_F32_PROMPT)
    return serve._parity_check(
        bundle, {**params, "sparse_plan": plan},
        engine_plan.masked_dense_params(params, plan), prompt,
        tol=TOL["float32"])


def long_prefill_phase(torch, serve, paths: dict) -> None:
    """Phase 21: the chunked prefill attention on the card (a), the long
    prefill through the serve entry point and its profile (b), the
    float32 end-to-end check at 8192 tokens (c), and the meta-device dry
    run of the same cell beside the measured memory (d).  The dry run is
    host work: its entry point (``python -m repro_torch.launch.dryrun``)
    runs in a process of its own beside (a)-(c), and is stopped if the
    phase fails first."""
    import tempfile
    from repro_torch.launch import dryrun
    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "olmo-1b", "--shape", "prefill_32k", "--batch", "1", "--out",
             out], cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            peak, measured = long_prefill_card(torch, serve, paths)
            t0 = time.monotonic()
            stdout, _ = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode:
            raise AssertionError(f"the dry run failed: {stdout}")
        rec = json.loads(next(pathlib.Path(out).glob("*.json")).read_text())
    if rec["status"] != "ok":
        raise AssertionError(f"dry run: {rec}")
    mem = rec["memory"]
    log(f"dry run {rec['cell']} ({rec['build_s']:.1f} s on meta, "
        f"{time.monotonic() - t0:.1f} s waited for after (c)): params "
        f"{mem['param_bytes']} B, cache {mem['cache_bytes']} B, resident "
        f"{rec['resident_bytes']} B, flops {rec['flops']:.6e} (model flops "
        f"{dryrun.model_flops('olmo-1b', 'prefill_32k') / 32:.6e} at batch "
        f"1), fits_one_card {rec['fits_one_card']}; measured: params "
        f"{measured['param_bytes']} B, prefill cache "
        f"{measured['cache_bytes']} B, serve peak {peak} B")
    if (mem["param_bytes"], mem["cache_bytes"]) != \
            (measured["param_bytes"], measured["cache_bytes"]):
        raise AssertionError("the dry run's param / cache bytes differ from "
                             "the card's tensors")


def long_prefill_card(torch, serve, paths: dict) -> tuple:
    """Phase 21 (a)-(c) on the card; returns ``(serve's peak device
    memory, long_prefill_profile's bytes and timings)``."""
    log("phase 21 (a) attention forms " + json.dumps(attention_forms(torch)))
    torch.cuda.empty_cache()
    # (b) the path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    counts, res = serve_run(torch, serve, LONG_LABEL, LONG_ARGS, "scatter",
                            LONG_DTYPE)
    paths[LONG_LABEL] = counts
    peak = torch.cuda.max_memory_allocated()
    plan = res["plan"]
    n_proj, layers = len(plan["block_k"]), plan["n_layers"]
    want = {"tiled_balanced_spmm": n_proj * layers * SERVE_PREFILLS,
            "tiled_balanced_spmm_skinny":
                n_proj * layers * (1 + LONG_GEN_STEPS),
            "kv_cache_update": LONG_KV_LAUNCHES}
    log(f"{LONG_LABEL}: {n_proj} planned projections x {layers} layers, "
        f"prompt {LONG_PROMPT}, {LONG_DTYPE}; launches "
        f"{dict((k, counts[k]) for k in want)}, expected {want}; dense "
        f"{res['dense']['tokens_per_s']:.2f} tok/s, sparse "
        f"{res['sparse']['tokens_per_s']:.2f} tok/s (prefill + "
        f"{LONG_GEN_STEPS} steps: dense {res['dense']['wall_s']:.3f} s, "
        f"sparse {res['sparse']['wall_s']:.3f} s); serve peak device memory "
        f"{peak / 2**30:.2f} GiB ({peak} B)")
    if (n_proj, layers) != (7, LONG_SERVE_LAYERS) \
            or plan["impl_mix"] != {"cuda": n_proj}:
        raise AssertionError(f"{LONG_LABEL}: plan {plan['impl_mix']} over "
                             f"{layers} layers")
    bad = {k: counts[k] for k, v in want.items() if counts[k] != v}
    if bad:
        raise AssertionError(f"{LONG_LABEL}: launches {bad}, expected {want}")
    torch.cuda.empty_cache()
    log(f"{WITNESS_LABEL}, {LONG_PROMPT} tokens: "
        + json.dumps(long_bf16_witness(torch, paths)))
    torch.cuda.empty_cache()
    measured = long_prefill_profile(torch)
    log(f"{LONG_LABEL} sparse prefill of {LONG_PROMPT} tokens, "
        f"{OLMO_LAYERS} layers: {measured['prefill_wall_s']:.3f} s wall, "
        f"{LONG_PROMPT / measured['prefill_wall_s']:.0f} tok/s; profile "
        + json.dumps(measured["profile"]))
    torch.cuda.empty_cache()
    # (c) float32 end to end
    t0 = time.monotonic()
    parity = long_f32_parity(torch, serve)
    log(f"{LONG_LABEL} float32, {LONG_F32_LAYERS} layers, prompt "
        f"{LONG_F32_PROMPT}, end to end ({time.monotonic() - t0:.1f} s): "
        + json.dumps(parity))
    torch.cuda.empty_cache()
    return peak, measured


def main() -> int:
    import torch
    t_start = time.monotonic()
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
    # the wide kernels' products run on the tensor cores: wgmma is HGMMA
    # in the SASS
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    for stem in TC_SOURCES:
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[stem])],
                              capture_output=True, text=True,
                              check=True).stdout
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        log(f"sass {stem}: {hgmma} HGMMA instructions")
        if not hgmma:
            raise AssertionError(f"no HGMMA in the SASS of {stem}")

    # 3. kernels vs plain versions (launches here are not the main path's)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, worst = check_kernels(torch)
    rows += check_batched(torch, worst)
    rows += check_bitmap(torch, worst)
    rows += check_kv(torch, worst)
    check_new_shapes(torch, worst)
    floor_ms = launch_floor_ms(torch, torch.empty(256 * 1024 * 1024 // 4,
                                                  device=DEVICE))
    log(f"launch floor (an empty kernel under the timer) {floor_ms:.4f} ms")
    # 11. rows 1 and 2 at the CNN path's GEMM shapes
    check_conv_kernels(torch, worst)

    # 12-13. the Sense CNN path (smallcnn), then the paper networks' layers:
    # counts zeroed just before each pass, read just after
    t0 = time.monotonic()
    paths = {"smallcnn": cnn_path(torch)}
    log(f"smallcnn path {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    paths["paper layers"] = paper_layers(torch)
    log(f"paper layers {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 14-15. the training paths: the CNN prune -> retrain flow (counts
    # zeroed just before, read just after), then the LM trainer
    t0 = time.monotonic()
    paths["cnn train"] = cnn_train(torch)
    log(f"cnn train {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    lm_train(torch)
    log(f"lm train {time.monotonic() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 4. the olmo-1b path: counts zeroed just before, read just after
    paths["olmo-1b"], tune_off = serve_run(torch, serve, "olmo-1b",
                                           SERVE_ARGS)
    parity_f32 = full_width_f32_parity(torch, serve)
    log(f"float32 compute, full width, end to end: {json.dumps(parity_f32)}")
    log("profile " + json.dumps(profile_generate(
        torch, serve, n_layers=PROFILE_LAYERS)))

    # 5. the bitmap format's entry at olmo-1b's projections, the same way
    paths["bitmap"] = bitmap_path(torch)

    # 6. olmo-1b with the scatter cache write: bitwise against the mask
    # path, then the serve entry point, the same way
    scatter_vs_mask(torch)
    label = "olmo-1b scatter"
    paths[label], _ = serve_run(torch, serve, label, SERVE_ARGS,
                                 "scatter")
    if paths[label]["kv_cache_update"] != SCATTER_KV_LAUNCHES:
        raise AssertionError(f"kv_cache_update launched "
                             f"{paths[label]['kv_cache_update']} times on "
                             f"the {label} path, expected "
                             f"{SCATTER_KV_LAUNCHES}")
    tiled = [k for k in bs.LAUNCHES
             if paths[label][k] != paths["olmo-1b"][k]]
    if tiled:
        raise AssertionError(f"the scatter path launched {tiled} another "
                             f"number of times than the mask path")

    # 7. the continuous-batching runtime on the scatter config, the same way
    label = "olmo-1b traffic"
    paths[label], _ = serve_run(torch, serve, label, TRAFFIC_ARGS,
                                 "scatter")
    quiet = [k for k in ("kv_cache_update", "tiled_balanced_spmm",
                         "tiled_balanced_spmm_skinny")
             if paths[label][k] == 0]
    if quiet:
        raise AssertionError(f"{quiet} never launched on the {label} path")
    log("traffic profile " + json.dumps(profile_traffic(torch, serve)))

    # 8. the olmo-1b int8 path, the same way
    paths["olmo-1b int8"], _ = serve_run(torch, serve, "olmo-1b int8",
                                         QUANT_ARGS)
    log("int8 profile " + json.dumps(profile_generate(
        torch, serve, n_layers=PROFILE_LAYERS, quant="int8")))

    # 9. the deepseek-moe-16b paths, the same way, after freeing olmo's
    want = (SERVE_PREFILLS + SERVE_DECODE_STEPS) * MOE_LAYERS * 3
    for label, args, batched in (
            ("deepseek-moe-16b", MOE_ARGS, "tiled_balanced_spmm_batched"),
            ("deepseek-moe-16b int4", MOE_QUANT_ARGS,
             "tiled_balanced_spmm_batched_q")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        paths[label], _ = serve_run(torch, serve, label, args)
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
            torch, serve, arch="deepseek-moe-16b",
            n_layers=min(MOE_LAYERS, PROFILE_LAYERS))))
    torch.cuda.empty_cache()

    # 16-18. planning and robustness at full width, each path's counts
    # zeroed just before and read just after
    for name, phase in (
            ("16. tune", lambda: tune_phase(torch, serve, tune_off, paths)),
            ("17. guard", lambda: guard_phase(
                torch, serve, paths["olmo-1b"], paths["deepseek-moe-16b"],
                paths)),
            ("18. objective", lambda: objective_phase(torch, serve, paths))):
        t0 = time.monotonic()
        phase()
        torch.cuda.empty_cache()
        log(f"phase {name}: {time.monotonic() - t0:.1f} s")

    # 19-20. the recurrent families and the frontends at published width,
    # each path's counts zeroed just before and read just after
    for name, phase in (
            ("19. recurrent", lambda: recurrent_phase(torch, serve, paths)),
            ("20. frontends", lambda: frontend_phase(torch, serve, paths))):
        t0 = time.monotonic()
        phase()
        torch.cuda.empty_cache()
        log(f"phase {name}: {time.monotonic() - t0:.1f} s")

    # 21. the long prefill: the chunked attention, olmo-1b at 32768 tokens
    # through serve (counts zeroed just before, read just after), the
    # float32 check at 8192 and the dry run of the cell
    t0 = time.monotonic()
    long_prefill_phase(torch, serve, paths)
    torch.cuda.empty_cache()
    log(f"phase 21. long prefill: {time.monotonic() - t0:.1f} s")

    # 22-26: the meshes, on four rank processes started once and kept
    # from run to run (`launch.ranks.keep_ranks`; each run joins its own
    # rendezvous, and counts are zeroed just before each rank's greedy
    # path or train steps and read just after, in the rank)
    from repro_torch.launch.ranks import keep_ranks
    with keep_ranks(MESH_RANKS):
        # 22. the mesh: olmo-1b on four ranks sharing the card
        t0 = time.monotonic()
        mesh_phase(torch, serve, paths)
        torch.cuda.empty_cache()
        log(f"phase 22. mesh: {time.monotonic() - t0:.1f} s")

        # 23. the MoE mesh: deepseek-moe-16b's experts split over model
        t0 = time.monotonic()
        moe_mesh_phase(torch, serve, paths)
        torch.cuda.empty_cache()
        log(f"phase 23. moe mesh: {time.monotonic() - t0:.1f} s")

        # 24. the family meshes: rwkv6-3b, zamba2-1.2b, musicgen-medium and
        # internvl2-2b, and internvl2-2b's prefill with frontend rows
        t0 = time.monotonic()
        family_mesh_phase(torch, serve, paths)
        torch.cuda.empty_cache()
        log(f"phase 24. family meshes: {time.monotonic() - t0:.1f} s")

        # 25. continuous batching on the mesh: the paged pool placed by
        # paged_pool_specs, the ranks in lock step
        t0 = time.monotonic()
        traffic_mesh_phase(torch, serve, paths)
        torch.cuda.empty_cache()
        log(f"phase 25. traffic mesh: {time.monotonic() - t0:.1f} s")

        # 26. the sharded train step: gradients reduce-scattered onto the
        # blocks, AdamW on the shards
        t0 = time.monotonic()
        train_mesh_phase(torch, paths)
        torch.cuda.empty_cache()
        log(f"phase 26. train mesh: {time.monotonic() - t0:.1f} s")

    # 10. result: launches summed over the paths' runs; each kernel's timed
    # row at bf16, at the quant mode its serve path runs, at the shape its
    # main path runs (the kv kernel: a decode write into a 4096-row cache)
    kernels = []
    for name, (source, replaces, quant) in KERNELS.items():
        if name == "kv_cache_update":
            row = next(r for r in rows if r["name"] == name
                       and r["S"] == KV_SEQS[-1] and r["C"] == 1)
        else:
            if name.startswith("tiled_balanced_spmm_batched"):
                m, shape = 8, EXPERT_SHAPES[0]
            else:
                m, shape = (8 if "skinny" in name else WIDE_M), SHAPES[1]
            row = next(r for r in rows if r["name"] == name and r["M"] == m
                       and (r["O"], r["N"]) == shape and r["quant"] == quant
                       and r["dtype"] == "bfloat16"
                       and "live_experts" not in r)
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
        if name == "tiled_balanced_spmm_batched":
            # the wide branch at the served prefill capacity
            wide = next(r for r in rows if r["name"] == name
                        and r["M"] == EXPERT_MS[-1]
                        and (r["O"], r["N"]) == shape and r["quant"] == quant
                        and r["dtype"] == "bfloat16")
            kernels[-1]["prefill"] = {k: wide[k] for k in (
                "M", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name == "kv_cache_update":
            kernels[-1]["launch_floor_ms"] = floor_ms
    log(f"all phases {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def mesh_phase(torch, serve, paths: dict) -> None:
    """Phase 22: which gloo collectives take CUDA tensors (the mesh's
    four ranks), then ``serve --mesh`` of olmo-1b on four ranks sharing
    the card:
    serve's own gates (every rank's greedy tokens equal to a one-process
    run of the same plan in this process, the logits of the prefill and
    of every decode step within 2e-2 of its,
    each rank's resident bytes of placed leaves equal to the dry run's
    `shard_bytes`), held again here, and each rank's launches of rows 1, 2
    and 8 equal to the plan's count (`MESH_LAUNCHES`)."""
    import dataclasses
    import tempfile
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.testing import multidevice
    log(f"phase 22 mesh: {torch.cuda.device_count()} device(s), backend "
        f"gloo, {MESH_RANKS} ranks on cuda:0, olmo-1b {MESH_LAYERS} of "
        f"{OLMO_LAYERS} layers")
    with tempfile.TemporaryDirectory() as tmp:
        probe = run_ranks(multidevice.gloo_cuda_probe, MESH_RANKS,
                          init_method=f"file://{tmp}/probe", timeout_s=180)
        log(f"gloo collectives on CUDA tensors: {json.dumps(probe[0])}")
        ns = serve.build_parser().parse_args(
            MESH_ARGS + ["--dist-init", f"file://{tmp}/mesh"])
        cfg = dataclasses.replace(serve.config(ns), cache_update="scatter")
        res = serve.run(ns, cfg)["mesh"]
    steps = res["step_logits_max_abs_diff"]
    log(f"mesh {res['mesh']} over {res['backend']}: tokens equal to one "
        f"process {res['tokens_equal']}, logits max |diff| prefill "
        f"{steps[0]:.6g}, decode steps "
        f"{[round(e, 6) for e in steps[1:]]} (tol {res['parity_tol']:g}), "
        f"resident bytes equal to shard_bytes {res['bytes_equal']}, ranks "
        f"{res['ranks_s']:.1f} s; tokens[0] {res['tokens'][0]}")
    if not res["tokens_equal"] or not res["bytes_equal"] \
            or max(steps) > TOL["bfloat16"]:
        raise AssertionError(f"the mesh run failed its gates: {res}")
    for r in res["ranks"]:
        got = {k: r["kernel_launches"][k] for k in MESH_LAUNCHES}
        log(f"mesh rank {r['rank']} {r['coord']}: launches {got}, resident "
            f"{r['resident_bytes']} B (shard_bytes {r['shard_bytes']}), peak "
            f"{r['peak_gib']} GiB serving, {r['setup_peak_gib']} GiB in set-up"
            f" (whole params and plan), set-up {r['setup_s']:.1f} s of "
            f"{r['setup_wall_s']:.1f} s in turns of {r['setup_turns']} ranks, "
            f"greedy "
            f"{r['wall_s']:.3f} s "
            f"({ns.batch * MESH_GEN_STEPS / r['wall_s']:.2f} tok/s)")
        log(f"mesh rank {r['rank']} collectives " + ", ".join(
            f"{k}: {c['ops']} ops {c['bytes']} B"
            for k, c in r["collectives"].items()))
        if got != MESH_LAUNCHES:
            raise AssertionError(f"rank {r['rank']} launched {got}, the "
                                 f"plan's count is {MESH_LAUNCHES}")
    paths["olmo-1b mesh"] = {
        k: sum(r["kernel_launches"].get(k, 0) for r in res["ranks"])
        for k in launches()}


def traffic_mesh_phase(torch, serve, paths: dict) -> None:
    """Phase 25: ``serve --traffic --mesh`` of olmo-1b on four ranks
    sharing the card, the scatter config: serve's own gates (paged vs
    contiguous exactly 0.0 on every rank, the parity replay's tokens equal
    to a one-process replay in this process and its logits within 2e-2,
    both pools' resident bytes equal to the dry run's `shard_bytes` under
    `paged_pool_specs`, the replay's launches equal to the one process's,
    every rank's ticks of the continuous run equal to rank 0's),
    held again here with each of rows 1, 2 and 8 launched in the replay;
    each rank's launches, exchange (``all_to_all``) ops and bytes, peaks
    and wall, and rank 0's continuous and static metrics printed."""
    import dataclasses
    import tempfile
    log(f"phase 25 traffic mesh: backend gloo, {MESH_RANKS} ranks on "
        f"cuda:0, olmo-1b {TRAFFIC_MESH_LAYERS} of {OLMO_LAYERS} layers")
    with tempfile.TemporaryDirectory() as tmp:
        ns = serve.build_parser().parse_args(
            TRAFFIC_MESH_ARGS + ["--dist-init", f"file://{tmp}/mesh"])
        cfg = dataclasses.replace(serve.config(ns), cache_update="scatter")
        res = serve.run(ns, cfg)["mesh"]
    want = res["one_process_launches"]
    cont, static = res["continuous"], res["static"]
    log(f"traffic mesh {res['mesh']} over {res['backend']}: paged vs "
        f"contiguous {res['parity_max_abs_diff']} on every rank, replay "
        f"tokens equal to one process {res['tokens_equal']}, logits max "
        f"|diff| {res['logits_max_abs_diff']:.6g} (tol "
        f"{res['parity_tol']:g}), pool bytes equal to shard_bytes "
        f"{res['bytes_equal']}, replay launches equal to one process "
        f"{res['launches_equal']} "
        f"({ {k: want[k] for k in TRAFFIC_MESH_KERNELS} }), every rank's "
        f"ticks equal to rank 0's {res['lock_step']}, ranks "
        f"{res['ranks_s']:.1f} s; rank 0 continuous "
        f"{cont['sustained_tok_per_s']:.3f} tok/s (latency p50 "
        f"{cont['latency_s']['p50']:.3f} s, p99 {cont['latency_s']['p99']:.3f}"
        f" s, ttft p50 {cont['ttft_s']['p50']:.3f} s), static "
        f"{static['sustained_tok_per_s']:.3f} tok/s (latency p50 "
        f"{static['latency_s']['p50']:.3f} s, p99 "
        f"{static['latency_s']['p99']:.3f} s)")
    quiet = [k for k in TRAFFIC_MESH_KERNELS if want[k] == 0]
    if res["parity_max_abs_diff"] != 0.0 or not res["tokens_equal"] \
            or not res["bytes_equal"] or not res["launches_equal"] \
            or not res["lock_step"] \
            or res["logits_max_abs_diff"] > TOL["bfloat16"] or quiet:
        raise AssertionError(f"the traffic mesh run failed its gates "
                             f"(never launched: {quiet}): {res}")
    for r in res["ranks"]:
        got = {k: r["replay_launches"][k] for k in TRAFFIC_MESH_KERNELS}
        run = {k: r["kernel_launches"][k] for k in TRAFFIC_MESH_KERNELS}
        ex = r["replay_collectives"].get("all_to_all", {})
        log(f"traffic mesh rank {r['rank']} {r['coord']}: replay launches "
            f"{got} (the whole traffic run {run}), replay exchange "
            f"{ex.get('ops', 0)} ops "
            f"{ex.get('bytes', 0)} B in {r['replay_s']:.2f} s, pools "
            f"{r['pool_bytes']}, peak {r['peak_gib']} GiB serving, "
            f"{r['setup_peak_gib']} GiB in set-up, set-up "
            f"{r['setup_s']:.1f} s of {r['setup_wall_s']:.1f} s in turns of "
            f"{r['setup_turns']} ranks, traffic {r['wall_s']:.1f} s")
        log(f"traffic mesh rank {r['rank']} collectives " + ", ".join(
            f"{k}: {c['ops']} ops {c['bytes']} B"
            for k, c in r["collectives"].items()))
    paths["olmo-1b traffic mesh"] = {
        k: sum(r["kernel_launches"].get(k, 0) for r in res["ranks"])
        for k in launches()}


def train_mesh_phase(torch, paths: dict) -> None:
    """Phase 26: ``train --mesh`` of olmo-1b on four ranks sharing the
    card (`TRAIN_MESH_ARGS`): train's own gates (every step's loss and
    grad norm and every rank's final params, ``m`` and ``v`` blocks
    within 2e-2 of a one-process run in this process, replicated blocks
    bitwise equal after every step, resident bytes equal to
    `per_device_bytes`), held again here, and no launch of rows 1-8 in
    any rank's steps (the train step runs no plan); each rank's step
    walls, collectives of its last step and peaks printed."""
    import tempfile
    from repro_torch.launch import train
    log(f"phase 26 train mesh: backend gloo, {MESH_RANKS} ranks on cuda:0, "
        f"olmo-1b {LM_TRAIN_LAYERS} of {OLMO_LAYERS} layers, "
        f"{LM_TRAIN_STEPS} steps")
    with tempfile.TemporaryDirectory() as tmp:
        ns = train.build_parser().parse_args(
            TRAIN_MESH_ARGS + ["--dist-init", f"file://{tmp}/mesh"])
        res = train.run(ns)["mesh"]
    tol = TOL["bfloat16"]
    worst = max(res["state_rel_err"], key=res["state_rel_err"].get)
    log(f"train mesh {res['mesh']} over {res['backend']}: loss "
        f"{res['loss']} (one process {res['one_process_loss']}), grad norm "
        f"{res['grad_norm']} (one process {res['one_process_grad_norm']}); "
        f"rel err loss {res['loss_rel_err']:.6g}, grad norm "
        f"{res['grad_norm_rel_err']:.6g}, params / m / v "
        f"{res['state_rel_err'][worst]:.6g} ({worst}) (tol "
        f"{res['parity_tol']:g}); replicated blocks bitwise equal "
        f"{res['replicas_equal']}, resident bytes equal to per_device_bytes "
        f"{res['bytes_equal']}; one process {res['one_process_s']:.1f} s "
        f"(steps {[round(x, 3) for x in res['one_process_step_s']]} s), "
        f"ranks {res['ranks_s']:.1f} s")
    launched = {r["rank"]: {k: n for k, n in r["kernel_launches"].items()
                            if n} for r in res["ranks"]}
    if res["parity_tol"] != tol or res["held_steps"] != LM_TRAIN_STEPS \
            or res["loss_rel_err"] > tol \
            or res["grad_norm_rel_err"] > tol \
            or res["state_rel_err"][worst] > tol \
            or not res["replicas_equal"] or not res["bytes_equal"] \
            or any(launched.values()):
        raise AssertionError(f"the train mesh run failed its gates "
                             f"(launched: {launched}): {res}")
    for r in res["ranks"]:
        log(f"train mesh rank {r['rank']} {r['coord']}: steps "
            f"{[round(x, 3) for x in r['step_s']]} s, peak {r['peak_gib']} "
            f"GiB training, {r['setup_peak_gib']} GiB in set-up, set-up "
            f"{r['setup_s']:.1f} s of {r['setup_wall_s']:.1f} s in turns of "
            f"{r['setup_turns']} ranks, resident {r['resident_bytes']} B, "
            f"the one-process comparison {r['compare_s']:.1f} s; collectives "
            f"of the last step " + ", ".join(
                f"{k}: {c['ops']} ops {c['bytes']} B"
                for k, c in r["collectives"][-1].items()))
    paths["olmo-1b train mesh"] = {
        k: sum(r["kernel_launches"].get(k, 0) for r in res["ranks"])
        for k in launches()}


def moe_mesh_phase(torch, serve, paths: dict) -> None:
    """Phase 23: ``serve --mesh`` of deepseek-moe-16b on four ranks
    sharing the card, its routed experts split over ``model``: serve's
    own gates (every rank's greedy tokens equal to a one-process run of
    the same plan in this process, the logits of the prefill and of every
    decode step within 2e-2 of its, each rank's resident bytes equal to
    the dry run's `shard_bytes`), held again here, each rank's launches
    of rows 1, 2, 5 and 8 equal to the plan's count (`MOE_MESH_LAUNCHES`)
    and every batched launch of a rank fed its `MOE_MESH_EXPERTS`
    experts; the routing agreement with one process, each rank's
    collectives, set-up and serving peaks and wall printed."""
    import dataclasses
    import tempfile
    log(f"phase 23 moe mesh: {torch.cuda.device_count()} device(s), backend "
        f"gloo, {MESH_RANKS} ranks on cuda:0, deepseek-moe-16b "
        f"{MOE_MESH_LAYERS} of 28 layers, {MOE_MESH_EXPERTS} experts a rank")
    with tempfile.TemporaryDirectory() as tmp:
        ns = serve.build_parser().parse_args(
            MOE_MESH_ARGS + ["--dist-init", f"file://{tmp}/mesh"])
        cfg = dataclasses.replace(serve.config(ns), cache_update="scatter")
        res = serve.run(ns, cfg)["mesh"]
    steps = res["step_logits_max_abs_diff"]
    log(f"moe mesh {res['mesh']} over {res['backend']}: tokens equal to one "
        f"process {res['tokens_equal']}, logits max |diff| prefill "
        f"{steps[0]:.6g}, decode steps "
        f"{[round(e, 6) for e in steps[1:]]} (tol {res['parity_tol']:g}), "
        f"resident bytes equal to shard_bytes {res['bytes_equal']}, routing "
        f"agreement with one process {res['routing_agreement']:.6f}, the "
        f"card's peak in set-up {res['setup_card_peak_gib']} GiB, ranks "
        f"{res['ranks_s']:.1f} s; tokens[0] {res['tokens'][0]}")
    if not res["tokens_equal"] or not res["bytes_equal"] \
            or max(steps) > TOL["bfloat16"]:
        raise AssertionError(f"the moe mesh run failed its gates: {res}")
    want_fed = {MOE_MESH_EXPERTS: 3 * MOE_MESH_LAYERS * MOE_MESH_FORWARDS}
    for r in res["ranks"]:
        got = {k: r["kernel_launches"][k] for k in MOE_MESH_LAUNCHES}
        log(f"moe mesh rank {r['rank']} {r['coord']}: experts "
            f"{r['expert_block']}, experts a batched dispatch "
            f"{r['experts_per_dispatch']}, routing agreement "
            f"{r['routing_agreement']:.6f}, launches {got}, resident "
            f"{r['resident_bytes']} B (shard_bytes {r['shard_bytes']}), peak "
            f"{r['peak_gib']} GiB serving, {r['setup_peak_gib']} GiB in its "
            f"set-up turn (the card {r['setup_card_gib']} GiB), set-up "
            f"{r['setup_s']:.1f} s of {r['setup_wall_s']:.1f} s in turns of "
            f"{r['setup_turns']} ranks, "
            f"greedy {r['wall_s']:.3f} s "
            f"({ns.batch * MESH_GEN_STEPS / r['wall_s']:.2f} tok/s)")
        log(f"moe mesh rank {r['rank']} collectives " + ", ".join(
            f"{k}: {c['ops']} ops {c['bytes']} B"
            for k, c in r["collectives"].items()))
        if got != MOE_MESH_LAUNCHES:
            raise AssertionError(f"rank {r['rank']} launched {got}, the "
                                 f"plan's count is {MOE_MESH_LAUNCHES}")
        if r["experts_per_dispatch"] != want_fed:
            raise AssertionError(f"rank {r['rank']}'s batched dispatches ran "
                                 f"{r['experts_per_dispatch']} experts, not "
                                 f"its block of {MOE_MESH_EXPERTS}")
    paths["deepseek-moe-16b mesh"] = {
        k: sum(r["kernel_launches"].get(k, 0) for r in res["ranks"])
        for k in launches()}


def family_mesh_phase(torch, serve, paths: dict) -> None:
    """Phase 24: ``serve --mesh`` of rwkv6-3b, zamba2-1.2b,
    musicgen-medium and internvl2-2b, each on four ranks sharing the
    card: serve's own gates (every rank's greedy tokens equal to a
    one-process run of the same plan, the logits of the prefill and of
    every decode step within 2e-2 of its, each rank's resident bytes equal
    to the dry run's `shard_bytes`: the recurrent states and zamba2's
    sequence-split KV included), held again here, and each rank's
    launches of rows 1, 2 and 8 equal to the plan's count
    (`FAMILY_MESH_LAUNCHES`); then internvl2-2b's prefill with frontend
    rows on the mesh (`frontend_mesh_prefill`)."""
    import dataclasses
    import tempfile
    log(f"phase 24 family meshes: {torch.cuda.device_count()} device(s), "
        f"backend gloo, {MESH_RANKS} ranks on cuda:0, "
        f"{FAMILY_MESH_LAYERS} layers each")
    for arch, want in FAMILY_MESH_LAUNCHES.items():
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as tmp:
            ns = serve.build_parser().parse_args(
                family_mesh_args(arch) + ["--dist-init",
                                          f"file://{tmp}/mesh"])
            cfg = dataclasses.replace(serve.config(ns),
                                      cache_update="scatter")
            res = serve.run(ns, cfg)["mesh"]
        steps = res["step_logits_max_abs_diff"]
        log(f"{arch} mesh {res['mesh']} over {res['backend']}: tokens equal "
            f"to one process {res['tokens_equal']}, logits max |diff| "
            f"prefill {steps[0]:.6g}, decode steps "
            f"{[round(e, 6) for e in steps[1:]]} (tol "
            f"{res['parity_tol']:g}), resident bytes equal to shard_bytes "
            f"{res['bytes_equal']}, the card's peak in set-up "
            f"{res['setup_card_peak_gib']} GiB, ranks {res['ranks_s']:.1f} s "
            f"of {time.monotonic() - t0:.1f} s; tokens[0] {res['tokens'][0]}")
        if not res["tokens_equal"] or not res["bytes_equal"] \
                or max(steps) > TOL["bfloat16"]:
            raise AssertionError(f"the {arch} mesh run failed its gates: "
                                 f"{res}")
        for r in res["ranks"]:
            got = {k: r["kernel_launches"][k] for k in want}
            log(f"{arch} mesh rank {r['rank']} {r['coord']}: launches {got}, "
                f"resident {r['resident_bytes']} B (shard_bytes "
                f"{r['shard_bytes']}), peak {r['peak_gib']} GiB serving, "
                f"{r['setup_peak_gib']} GiB in its set-up turn, set-up "
                f"{r['setup_s']:.1f} s of {r['setup_wall_s']:.1f} s in turns "
                f"of {r['setup_turns']} ranks, greedy {r['wall_s']:.3f} s "
                f"({ns.batch * MESH_GEN_STEPS / r['wall_s']:.2f} tok/s); "
                "collectives " + ", ".join(
                    f"{k}: {c['ops']} ops {c['bytes']} B"
                    for k, c in r["collectives"].items()))
            if got != want:
                raise AssertionError(f"{arch} rank {r['rank']} launched "
                                     f"{got}, the plan's count is {want}")
        paths[f"{arch} mesh"] = {
            k: sum(r["kernel_launches"].get(k, 0) for r in res["ranks"])
            for k in launches()}
        torch.cuda.empty_cache()
    log(f"{FRONTEND_MESH_ARCH} frontend prefill on the mesh: "
        + json.dumps(frontend_mesh_prefill(torch, serve)))


def frontend_mesh_prefill(torch, serve) -> dict:
    """Phase 24's prefill of internvl2-2b (published width,
    `FAMILY_MESH_LAYERS`, bf16) with `FRONTEND_MESH_ROWS` frontend rows on
    the ``data=2,model=2`` mesh, its ranks set up by serve's own rank
    set-up (`testing.multidevice.frontend_prefill`): every rank's logits within
    2e-2 of one process's prefill of the same params, plan and rows, and
    each rank's wide launches one a planned projection and layer."""
    import dataclasses
    import tempfile
    from repro_torch.engine import plan as engine_plan
    from repro_torch.launch.mesh_run import MESH_TIMEOUT_S
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models import build_model
    from repro_torch.testing import multidevice
    ns = serve.build_parser().parse_args(
        family_mesh_args(FRONTEND_MESH_ARCH)
        + ["--batch", str(FRONTEND_MESH_BATCH), "--prompt-len",
           str(FRONTEND_MESH_PROMPT)])
    cfg = dataclasses.replace(serve.config(ns), cache_update="scatter")
    t0 = time.monotonic()
    bundle = build_model(cfg, DEVICE)
    batch = multidevice.frontend_batch(cfg, FRONTEND_MESH_BATCH,
                                       FRONTEND_MESH_PROMPT,
                                       FRONTEND_MESH_ROWS, DEVICE)
    with torch.no_grad():
        params = bundle.init(0)
        params["sparse_plan"] = engine_plan.plan_model(
            cfg, params, **serve._plan_kwargs(ns, cfg))
        want = bundle.prefill(params, batch)[0].float().cpu()
        plain = bundle.prefill(params, {"tokens": batch["tokens"]}
                               )[0].float().cpu()
    del params
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(multidevice.frontend_prefill, MESH_RANKS,
                          init_method=f"file://{tmp}/frontend",
                          args=(ns, cfg, FRONTEND_MESH_BATCH,
                                FRONTEND_MESH_PROMPT, FRONTEND_MESH_ROWS),
                          timeout_s=MESH_TIMEOUT_S)
    errs = [float((torch.from_numpy(r["logits"]) - want).abs().max())
            for r in ranks]
    wide = FAMILY_MESH_PROJECTIONS[FRONTEND_MESH_ARCH] * FAMILY_MESH_LAYERS
    out = {"rows": FRONTEND_MESH_ROWS, "batch": FRONTEND_MESH_BATCH,
           "prompt": FRONTEND_MESH_PROMPT, "max_abs_err": errs,
           "rows_move_logits_by": float((want - plain).abs().max()),
           "launches": [{k: v for k, v in r["launches"].items() if v}
                        for r in ranks],
           "collectives": ranks[0]["collectives"],
           "seconds": time.monotonic() - t0}
    if max(errs) > TOL["bfloat16"] or any(
            r["launches"]["tiled_balanced_spmm"] != wide for r in ranks) \
            or out["rows_move_logits_by"] <= TOL["bfloat16"]:
        raise AssertionError(f"the frontend prefill on the mesh: {out}")
    return out


def serve_run(torch, serve, label: str, args: list,
              cache_update: str | None = None,
              compute_dtype: str | None = None) -> tuple:
    """Drive one path through `launch/serve` (``main``, or ``run`` on the
    config ``main`` builds with ``cache_update`` and / or
    ``compute_dtype`` set) with every launch
    count zeroed just before and read just after; fail if a kernel that
    the path's plan reaches never launched, or if a tiled kernel of the
    other format launched (a quantized plan runs only the ``_q`` kernels,
    an unquantized one none of them).  Returns ``(launch counts, the
    serve report)``."""
    import dataclasses
    reset_launches()
    t0 = time.monotonic()
    overrides = {k: v for k, v in (("cache_update", cache_update),
                                   ("compute_dtype", compute_dtype))
                 if v is not None}
    if not overrides:
        res = serve.main(args)
    else:
        ns = serve.build_parser().parse_args(args)
        res = serve.run(ns, dataclasses.replace(serve.config(ns),
                                                **overrides))
    torch.cuda.synchronize()
    counts = launches()
    plan = res["plan"]
    if "traffic" in res:
        served = "traffic " + json.dumps(res["traffic"])
    else:
        served = (f"dense {res['dense']['tokens_per_s']:.1f} tok/s, sparse "
                  f"{res['sparse']['tokens_per_s']:.1f} tok/s")
    log(f"serve {' '.join(args)}"
        + (f" ({overrides})" if overrides else "")
        + f": {time.monotonic() - t0:.1f} s, plan "
        f"{plan['plan_build_s']:.2f} s, {served}, KB "
        f"{plan['block_k']}, parity (tol {plan['parity_tol']:g}) "
        f"{json.dumps(plan['parity'])}, stored {plan['encoded_bytes']} B vs "
        f"dense {plan['dense_bytes']} B; a decode step reads "
        f"{plan['step_weight_bytes']} B of live weights, bound "
        f"{plan['step_weight_bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    log(f"{label} launches " + ", ".join(f"{k}={v}"
                                         for k, v in counts.items())
        + f"; the plan reaches {plan['kernels_reached']}")
    quantized = plan["quant"] != "none"
    if not plan["kernels_reached"] or any(
            counts[k] == 0 for k in plan["kernels_reached"]):
        raise AssertionError(f"a kernel of the {label} path never launched: "
                             f"{counts}")
    other = [k for k, v in counts.items() if v and k.startswith("tiled_")
             and k.endswith("_q") != quantized]
    if other:
        raise AssertionError(f"the {label} path launched {other}, kernels of "
                             f"the other weight format")
    return counts, res


if __name__ == "__main__":
    sys.exit(main())
