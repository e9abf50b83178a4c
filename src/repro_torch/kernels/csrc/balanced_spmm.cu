// Tiled balanced-sparse x dense matmul, y[M, O] = x[M, NB*bn] @ decode(W)^T,
// for NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/_build.py; the wrappers live in
// src/repro_torch/kernels/balanced_spmm.py, the kernel templates (shared
// with the block-quantized entries of balanced_spmm_q.cu) in
// tiled_spmm.cuh.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/balanced_spmm.py:
//   tiled_spmm_wide    <- tiled_balanced_spmm_pallas (_kernel), prefill (wide M)
//   tiled_spmm_skinny  <- tiled_balanced_spmm_skinny_pallas (_kernel_skinny),
//                         decode (M <= 8, padded to 8)
//   tiled_spmm_batched <- tiled_balanced_spmm_batched_pallas (_kernel_batched),
//                         the MoE experts: y[e] = x[e] @ decode(W[e])^T for
//                         every expert e in one launch
//
// W is the tile-local balanced format: values[O, NB, KB] (f32 or bf16, the
// activation dtype) and block-local int32 indices[O, NB, KB] in [0, bn).
// Pad slots hold value 0 / index 0.
//
// What bounds it on an H100: the encoded weights are read once per call
// (6 bytes per slot in bf16: a 2-byte value and a 4-byte index), so decode
// (M <= 8) is bound by device-memory bytes, and so is prefill at M = 128
// in bf16: at olmo-1b's 8192 x 2048, sparsity 0.5, the bytes a call must
// move (the live slots with their counts, x, the f32 y) are 56 MB (0.0166
// ms at 3.35 TB/s) against 2.1 GFLOP (0.0022 ms at 989 TFLOP/s).  In float32 the product is bound by operations (67 TFLOP/s on
// the FMA pipe: 0.032 ms there).
//
// bf16 wide (tiled_spmm_wide, and tiled_spmm_batched at M > 8): the
// tensor-core kernel of tc_spmm.cuh with the BalancedTc decoder of
// tiled_spmm.cuh.
//  * A CTA owns 64 output rows (O) and a token tile of TN = 32, 64 or 128
//    rows of x (swap-AB: O takes wgmma's 64-row side, the tokens its N);
//    grid z is the expert of a batched call.  Per column block: the
//    block's [64, KB] indices and values are copied (cp.async, 16-byte
//    pieces where the run allows) into a two-stage ring, each warp zeroes
//    its 8 rows of a bf16 [64, bn] tile in the 128-byte swizzle and stores
//    every nonzero slot at its swizzled column (a lane takes 4 slots: one
//    16-byte index read); wgmma m64nTNk16 multiplies the tile with the
//    TMA-loaded x tile into f32 registers while the next block decodes.
//  * Pad slots (value 0, index 0) and the decode's writes: slots whose
//    value is 0 are skipped, which is exact for the reference's `.at[].add`
//    (adding 0 to the zeroed tile changes nothing), so a pad slot never
//    writes, let alone over a real column-0 weight.  The other slots of one
//    row and block hold distinct columns (the columns of a balanced row are
//    distinct, and encode_tiled and the column packing keep them so), so
//    every tile element has at most one writer and a plain store decodes
//    exactly what the add does.  Indices outside [0, bn) are dropped, as an
//    out-of-range XLA scatter update is; they never write outside the tile.
//  * When the output tiles alone do not fill the card, the column blocks
//    are split (split-K, one wave of CTAs) and the partials summed in a
//    fixed order by a second kernel: two calls give the same bits.
//  * bf16 x bf16 products are exact in f32; only the summation order
//    differs from the plain version (within 1e-4).
//  What bounds it now: at 8192 x 2048, M = 128 it reads the stored slots,
//  pads included (69 MB at KB = 88, 0.021 ms), the x slice once per O tile
//  from L2, and decodes on the CUDA cores; the decode is the part of each
//  block that the product and the copies do not hide.
//
// bf16 skinny (tiled_spmm_skinny, and tiled_spmm_batched at M <= 8): the
// weight streamer of skinny_spmm.cuh with the BalancedStream decoder of
// tiled_spmm.cuh.
//  * x stays resident in shared memory (32 KB at N = 2048, 128 KB at
//    olmo-1b's w_down N = 8192; past about 13K columns, column ranges);
//    each warp owns whole rows and streams each (row, block)'s live prefix
//    (counts[o, b] slots of indices and values; the C entries take the
//    counts) through a private 3-stage cp.async ring, 66 KB of stored
//    slots in flight per SM at N = 2048, and gathers x's column per slot: no
//    dense tile, no zeroing, no pad slot read.  The product is f32 FMAs per
//    slot and row of x, reduced across the warp in a fixed order.
//  * Pad slots are value 0 and index 0 (encode_tiled, and quantize_tiled,
//    keep them so; tests/test_torch_*.py hold the port's and the
//    reference's encodings to it), so reading the live prefix alone is
//    exact.
//  * The batched entry skips empty experts: a CTA whose expert's x is all
//    zero writes +0.0 and reads no weight (exact for finite weights; a NaN
//    or Inf weight of an empty expert gives NaN in the plain version and 0
//    here).  At deepseek-moe-16b's decode, batch 4 x top-6, at most 24 of
//    the 64 experts hold a token.
//  What bounds it now: instruction issue (skinny_spmm.cuh's note): at
//  8192 x 2048, M = 8 it runs 3.0x its byte bound, 2.1x torch.matmul; the
//  expert grid with every expert live 2.3x its bound, 2.7x torch.bmm.
//
// float32 x keeps the FMA templates (tiled_spmm_wide_kernel,
// tiled_spmm_skinny_kernel): TF32 wgmma would round x and the weights to
// 10-bit mantissas, past the 1e-4 bar that the f32 kernels check and the
// f32 end-to-end parity gate hold, and a float32 x at N = 8192 (256 KB)
// does not stay resident.  They:
//  * The TPU grid's sequential NB axis becomes a loop inside the CTA; one
//    CTA owns one output tile and nothing carries between CTAs.
//  * Per column block: stage the x slice in shared memory (as f32), zero a
//    dense [BO, bn] f32 tile, scatter-decode the block's slots into it
//    (skipping zero slots, as above), sync, accumulate the product with f32
//    FMAs in registers.
//  * Against device-memory latency: every load of column block b+1 (the
//    slots of the CTA's rows, one warp per row and lanes over the slots, and
//    the x slice) is issued into registers right after block b is decoded,
//    so those loads are in flight together while block b's product runs.
//    Shared-memory float atomicAdd would compile to a compare-and-swap loop
//    on sm_90a, hence the plain stores.
//  * Small output tiles (32 x 64 wide, 8 x 8 skinny) so O = 2048 still gives
//    at least one CTA per SM; row strides of bn + 4 floats keep the float4
//    reads and the decode's scattered stores free of bank conflicts.
//
// The batched (MoE expert) kernels take the expert as a grid axis: each
// CTA offsets x [E, M, NB*bn], the encodings [E, O, NB, KB] and y
// [E, M, O] by its expert.  The host takes the skinny route when the
// per-expert M (the capacity) is <= 8, the wide one otherwise (in bf16 the
// tensor-core kernel, TN = 32 at the prefill capacity 16).  What bounds
// it: device-memory bytes, the live slots of the live experts.  At
// deepseek-moe-16b's decode, E = 64, O x N = 1408 x 2048, sparsity 0.5,
// M = 8, with every expert live the work needs the live slots and the
// per-block counts: 64 x 1408 x 1024 x 6 B + 64 x 1408 x 16 x 4 B = 559
// MB, 0.17 ms at 3.35 TB/s; with 24 live experts, 0.064 ms.
#include "tiled_spmm.cuh"

using namespace tiled_spmm;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and values share it).  y is f32
// [M, O]; ws is a float32 workspace of splits x M x O (null for one
// split); bf16 runs the tensor-core kernel, float32 the FMA one (splits
// 1).  Returns the cudaError_t of the launch (0 on success).
int tiled_spmm_wide(const void* x, const void* vals, const int* idx, float* y,
                    int M, int O, int NB, int KB, int bn, int dtype,
                    float* ws, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_wide_any<__nv_bfloat16, FloatValues<__nv_bfloat16>, false>(
        x, vals, idx, nullptr, y, ws, splits, 1, M, O, NB, KB, bn, s);
  return launch_wide_any<float, FloatValues<float>, false>(
      x, vals, idx, nullptr, y, ws, splits, 1, M, O, NB, KB, bn, s);
}

// counts int32 [O, NB]: a block's live slots (the bf16 route reads only
// those; float32 ignores them).
int tiled_spmm_skinny(const void* x, const void* vals, const int* idx,
                      const int* counts, float* y, int M, int O, int NB,
                      int KB, int bn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_skinny_any<__nv_bfloat16, FloatValues<__nv_bfloat16>,
                             false>(x, vals, idx, counts, nullptr, y, 1, M, O,
                                    NB, KB, bn, s);
  return launch_skinny_any<float, FloatValues<float>, false>(
      x, vals, idx, counts, nullptr, y, 1, M, O, NB, KB, bn, s);
}

// x [E, M, NB*bn], values / indices [E, O, NB, KB], counts [E, O, NB], y
// f32 [E, M, O]; ws splits x E x M x O floats (the wide branch only).
int tiled_spmm_batched(const void* x, const void* vals, const int* idx,
                       const int* counts, float* y, int E, int M, int O,
                       int NB, int KB, int bn, int dtype, float* ws,
                       int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_batched<__nv_bfloat16, FloatValues<__nv_bfloat16>>(
        x, vals, idx, counts, nullptr, y, ws, splits, E, M, O, NB, KB, bn, s);
  return launch_batched<float, FloatValues<float>>(
      x, vals, idx, counts, nullptr, y, ws, splits, E, M, O, NB, KB, bn, s);
}

const char* spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
