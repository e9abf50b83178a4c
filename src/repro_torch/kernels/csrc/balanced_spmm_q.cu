// Block-quantized tiled balanced-sparse x dense matmul,
// y[M, O] = x[M, NB*bn] @ dequant(decode(W))^T, for NVIDIA Hopper (sm_90a).
// Plain C interface, loaded with ctypes by src/repro_torch/kernels/_build.py;
// the wrappers live in src/repro_torch/kernels/balanced_spmm.py, the kernel
// templates (shared with balanced_spmm.cu) in tiled_spmm.cuh.
//
// Replaces the quantized twins of the Pallas TPU kernels in
// src/repro/kernels/balanced_spmm.py, which dequantize in VMEM inside
// _decode_tile right before the scatter that feeds the MXU:
//   tiled_spmm_wide_q    <- tiled_balanced_spmm_pallas, _kernel_q (prefill)
//   tiled_spmm_skinny_q  <- tiled_balanced_spmm_skinny_pallas,
//                           _kernel_skinny_q (decode, M <= 8)
//   tiled_spmm_batched_q <- tiled_balanced_spmm_batched_pallas,
//                           _kernel_batched_q (the MoE experts' grid)
//
// W is the tile-local format of balanced_spmm.cu with narrow values and one
// f32 absmax scale per (row, block): int8 values[.., O, NB, KB], or int4
// values nibble-packed two per byte, uint8 [.., O, NB, ceil(KB/2)] (slot 2i
// the low nibble of byte i), int32 block-local indices[.., O, NB, KB] and
// f32 scales[.., O, NB].  x stays f32 or bf16.  Each slot decodes to
// float(q) * scale, one f32 multiply: what tile_format.dequantize_values
// computes, bit for bit.  A slot whose product is 0 (q == 0: pad slots, and
// every slot of an all-zero block, whose scale is 0) is skipped, exactly as
// in balanced_spmm.cu; the encoder never gives a block a scale that is not
// finite, so q == 0 always decodes to 0.
//
// What bounds it on an H100: the same as balanced_spmm.cu, device-memory
// bytes at decode and at the MoE capacities, with fewer bytes per slot: an
// int8 value plus an int32 index is 5 B, an int4 one 4.5 B (bf16: 6 B),
// plus 4 B of scale per (row, block).  At olmo-1b's largest projection,
// O x N = 8192 x 2048, sparsity 0.5, M = 8, the work needs the live slots,
// counts and scales: 8192 x 1024 x 5 B + 8192 x 16 x 8 B = 43 MB (int8),
// 0.013 ms at 3.35 TB/s; at deepseek-moe-16b's experts, E = 64, 1408 x
// 2048, int4: 64 x 1408 x (1024 x 4.5 B + 16 x 8 B) = 427 MB, 0.128 ms.
// The int32 index word is most of those bytes, so quantization saves a
// sixth (int8) or a quarter (int4) of the unquantized kernels' bytes.
//
// Design: the templates of tiled_spmm.cuh with a value policy.
//  * bf16 x, wide (tiled_spmm_wide_q, tiled_spmm_batched_q at M > 8): the
//    tensor-core kernel of tc_spmm.cuh (balanced_spmm.cu's note).  Each
//    stage also copies the 64 rows' scales of the block; the decode reads
//    a lane's 4 slots as one 4-byte (int8) or 2-byte (int4) load and stores
//    q itself in bf16 (|q| <= 127 is exact; int4 sign-extends the low
//    nibble for the even slot as (n ^ 8) - 8).  The block's product goes to
//    a per-block f32 accumulator (wgmma scale-d = 0 on its first k-step) and
//    then y += scale[o, b] * that sum, one fma: the factoring of ops.py's
//    _tiled_gather_spmm.  Rounding q * scale to bf16 instead would change
//    the numbers.  A zero-scale block's q are 0: they decode to exact
//    zeros.
//  * bf16 x, skinny (tiled_spmm_skinny_q, tiled_spmm_batched_q at M <= 8):
//    the weight streamer of skinny_spmm.cuh (balanced_spmm.cu's note).  A
//    block's live prefix is its first counts[o, b] index words and the
//    bytes that hold its first counts[o, b] values (int4: ceil(count / 2)
//    bytes), each rounded up to the copy piece; the scale rides in the
//    lanes' registers with the count.  A value run that is not 16-byte
//    aligned (deepseek-moe-16b's we_down at N = 1408: an int8 row run of
//    968 bytes, an int4 one of 484, scales of 44) takes 8-, 4-, 2- or
//    1-byte pieces, never reading past the run.  Each slot decodes to
//    float(q) * scale, int4 picking its nibble as (n ^ 8) - 8, and a slot
//    that decodes to 0 adds nothing; empty experts exit as in
//    balanced_spmm.cu.
//  * float32 x keeps the FMA templates (TF32 would miss the f32 bar, as in
//    balanced_spmm.cu): a slot's load reads one byte (int8) or the byte
//    that holds its nibble (int4; two lanes read the same byte) and, once
//    per row and block, the scale; they stay raw in registers until the
//    decode, which writes float(q) * scale into the f32 tile.
// What bounds the bf16 wide kernel: the same as balanced_spmm.cu's (the
// stored slots, the decode); fewer value bytes, the same index words.  The
// bf16 skinny ones: instruction issue, as balanced_spmm.cu's (8192 x 2048
// int8, M = 8: 3.6x its byte bound; the int4 expert grid, every expert
// live: 3.1x).
#include "tiled_spmm.cuh"

using namespace tiled_spmm;

namespace {

// dtype: 0 = float32, 1 = bfloat16 x; wfmt: 1 = int8, 2 = int4.
template <template <typename, typename> class Launch>
int dispatch(int dtype, int wfmt, const void* x, const void* vals,
             const int* idx, const int* counts, const float* scales,
             float* y, float* ws, int splits, int E, int M, int O, int NB,
             int KB, int bn, cudaStream_t s) {
  if (wfmt != 1 && wfmt != 2) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (wfmt == 1)
      return Launch<__nv_bfloat16, Int8Values>::run(
          x, vals, idx, counts, scales, y, ws, splits, E, M, O, NB, KB, bn,
          s);
    return Launch<__nv_bfloat16, Int4Values>::run(
        x, vals, idx, counts, scales, y, ws, splits, E, M, O, NB, KB, bn, s);
  }
  if (wfmt == 1)
    return Launch<float, Int8Values>::run(x, vals, idx, counts, scales, y, ws,
                                          splits, E, M, O, NB, KB, bn, s);
  return Launch<float, Int4Values>::run(x, vals, idx, counts, scales, y, ws,
                                        splits, E, M, O, NB, KB, bn, s);
}

template <typename T, typename W>
struct Wide {
  static int run(const void* x, const void* v, const int* i, const int*,
                 const float* sc, float* y, float* ws, int splits, int E,
                 int M, int O, int NB, int KB, int bn, cudaStream_t s) {
    return launch_wide_any<T, W, false>(x, v, i, sc, y, ws, splits, E, M, O,
                                        NB, KB, bn, s);
  }
};

template <typename T, typename W>
struct Skinny {
  static int run(const void* x, const void* v, const int* i, const int* c,
                 const float* sc, float* y, float*, int, int E, int M, int O,
                 int NB, int KB, int bn, cudaStream_t s) {
    return launch_skinny_any<T, W, false>(x, v, i, c, sc, y, E, M, O, NB, KB,
                                          bn, s);
  }
};

template <typename T, typename W>
struct Batched {
  static int run(const void* x, const void* v, const int* i, const int* c,
                 const float* sc, float* y, float* ws, int splits, int E,
                 int M, int O, int NB, int KB, int bn, cudaStream_t s) {
    return launch_batched<T, W>(x, v, i, c, sc, y, ws, splits, E, M, O, NB,
                                KB, bn, s);
  }
};

}  // namespace

extern "C" {

// x [M, NB*bn] (dtype), values (wfmt), indices, scales [O, NB]; y f32
// [M, O]; ws splits x M x O floats (null for one split).  Returns the
// cudaError_t of the launch (0 on success).
int tiled_spmm_wide_q(const void* x, const void* vals, const int* idx,
                      const float* scales, float* y, int M, int O, int NB,
                      int KB, int bn, int dtype, int wfmt, float* ws,
                      int splits, void* stream) {
  return dispatch<Wide>(dtype, wfmt, x, vals, idx, nullptr, scales, y, ws,
                        splits, 1, M, O, NB, KB, bn,
                        static_cast<cudaStream_t>(stream));
}

// counts int32 [O, NB] (see tiled_spmm_skinny).
int tiled_spmm_skinny_q(const void* x, const void* vals, const int* idx,
                        const int* counts, const float* scales, float* y,
                        int M, int O, int NB, int KB, int bn, int dtype,
                        int wfmt, void* stream) {
  return dispatch<Skinny>(dtype, wfmt, x, vals, idx, counts, scales, y,
                          nullptr, 1, 1, M, O, NB, KB, bn,
                          static_cast<cudaStream_t>(stream));
}

// x [E, M, NB*bn], values [E, O, NB, KB or ceil(KB/2)], indices
// [E, O, NB, KB], counts and scales [E, O, NB], y f32 [E, M, O]; ws
// splits x E x M x O floats (the wide branch only).
int tiled_spmm_batched_q(const void* x, const void* vals, const int* idx,
                         const int* counts, const float* scales, float* y,
                         int E, int M, int O, int NB, int KB, int bn,
                         int dtype, int wfmt, float* ws, int splits,
                         void* stream) {
  return dispatch<Batched>(dtype, wfmt, x, vals, idx, counts, scales, y, ws,
                           splits, E, M, O, NB, KB, bn,
                           static_cast<cudaStream_t>(stream));
}

const char* spmm_q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
