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
// (M <= 8) is bound by device-memory bytes; prefill at M = 128 sits near
// the bf16 ridge, but the product here runs on the f32 FMA pipe (67 TFLOP/s,
// not the tensor cores) over the whole decoded tile, zeros included.
//
// Design (right and simple first; wgmma, TMA and narrower index words are
// later work):
//  * The TPU grid's sequential NB axis becomes a loop inside the CTA; one
//    CTA owns one output tile and nothing carries between CTAs.
//  * Per column block: stage the x slice in shared memory (as f32), zero a
//    dense [BO, bn] f32 tile, scatter-decode the block's slots into it,
//    sync, accumulate the product with f32 FMAs in registers.  bf16 x bf16
//    products are exact in f32, as on the TPU's preferred_element_type=f32
//    dot.
//  * Against device-memory latency: every load of column block b+1 (the
//    slots of the CTA's rows, one warp per row and lanes over the slots, and
//    the x slice) is issued into registers right after block b is decoded,
//    so those loads are in flight together while block b's product runs.
//  * Pad slots and the decode's writes: slots whose value is 0 are skipped,
//    which is exact for the reference's `.at[].add` (adding 0 to the zeroed
//    tile changes nothing), so a pad slot (value 0, index 0) never writes,
//    let alone over a real column-0 weight.  The other slots of one row and
//    block hold distinct columns (the columns of a balanced row are distinct,
//    and encode_tiled and the column packing keep them so), so every tile
//    element has at most one writer and a plain store decodes exactly what
//    the add does.  Shared-memory float atomicAdd would compile to a
//    compare-and-swap loop on sm_90a.  Indices outside [0, bn) are dropped,
//    as an out-of-range XLA scatter update is; they never write outside the
//    tile.
//  * Small output tiles (64 columns wide, 8 skinny) so O = 2048 still gives
//    at least one CTA per SM; row strides of bn + 4 floats keep the float4
//    reads and the decode's scattered stores free of bank conflicts.
//
// The batched (MoE expert) kernel is the same two tile shapes with the
// expert as the grid's z axis: each CTA offsets x [E, M, NB*bn], the
// encodings [E, O, NB, KB] and y [E, M, O] by its expert and runs the loop
// above on that expert's slice.  The host takes the 8-row skinny tile when
// the per-expert M (the capacity) is <= 8, so decode does not pay for a
// 32-row tile, and the wide tile otherwise.  What bounds it: the encodings
// of all E experts are read once per call (the capacity buffer holds every
// expert, empty or not), so it is bound by device-memory bytes at both
// capacities.  At deepseek-moe-16b's decode, E = 64, O x N = 1408 x 2048,
// sparsity 0.5, M = 8, the work needs the live slots and the per-block
// counts: 64 x 1408 x 1024 x 6 B + 64 x 1408 x 16 x 4 B = 559 MB, 0.17 ms
// at 3.35 TB/s.  This kernel reads every stored slot, pads included: at
// KB = 88, 64 x 1408 x 16 x 88 x 6 B = 761 MB.  The prefill capacity
// (M = 16) runs the wide tile half empty.
#include "tiled_spmm.cuh"

using namespace tiled_spmm;

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and values share it).  y is f32
// [M, O].  Returns the cudaError_t of the launch (0 on success).
int tiled_spmm_wide(const void* x, const void* vals, const int* idx, float* y,
                    int M, int O, int NB, int KB, int bn, int dtype,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_wide<__nv_bfloat16, FloatValues<__nv_bfloat16>, false>(
        x, vals, idx, nullptr, y, 1, M, O, NB, KB, bn, s);
  return launch_wide<float, FloatValues<float>, false>(
      x, vals, idx, nullptr, y, 1, M, O, NB, KB, bn, s);
}

int tiled_spmm_skinny(const void* x, const void* vals, const int* idx,
                      float* y, int M, int O, int NB, int KB, int bn,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_skinny<__nv_bfloat16, FloatValues<__nv_bfloat16>, false>(
        x, vals, idx, nullptr, y, 1, M, O, NB, KB, bn, s);
  return launch_skinny<float, FloatValues<float>, false>(
      x, vals, idx, nullptr, y, 1, M, O, NB, KB, bn, s);
}

// x [E, M, NB*bn], values / indices [E, O, NB, KB], y f32 [E, M, O].
int tiled_spmm_batched(const void* x, const void* vals, const int* idx,
                       float* y, int E, int M, int O, int NB, int KB, int bn,
                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_batched<__nv_bfloat16, FloatValues<__nv_bfloat16>>(
        x, vals, idx, nullptr, y, E, M, O, NB, KB, bn, s);
  return launch_batched<float, FloatValues<float>>(
      x, vals, idx, nullptr, y, E, M, O, NB, KB, bn, s);
}

const char* spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
