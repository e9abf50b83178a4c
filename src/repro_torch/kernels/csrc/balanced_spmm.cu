// Tiled balanced-sparse x dense matmul, y[M, O] = x[M, NB*bn] @ decode(W)^T,
// for NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/_build.py; the wrappers live in
// src/repro_torch/kernels/balanced_spmm.py.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kMaxBn = 128;                  // widest column block a plan picks
constexpr int kLanes = 32;
constexpr int kSlotIters = kMaxBn / kLanes;  // a lane's slots per row (KB <= 128)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The registers that carry one column block from its loads to its decode:
// the KB slots of each row this warp decodes (rows warp, warp + kWarps, ...)
// and this thread's share of the [kBM, bn] x slice.
// Values stay in the storage type until they are used: a bf16 -> f32
// conversion right after its load would wait for that load.
template <typename T, int kBM, int kBO, int kThreads>
struct BlockRegs {
  static constexpr int kWarps = kThreads / kLanes;
  static constexpr int kRows = kBO / kWarps;
  static constexpr int kX = kBM * kMaxBn / kThreads;
  int idx[kRows][kSlotIters];
  T val[kRows][kSlotIters];
  T x[kX];
};

template <typename T, int kBM, int kBO, int kThreads>
__device__ __forceinline__ void load_block(
    BlockRegs<T, kBM, kBO, kThreads>& r, const T* __restrict__ x,
    const T* __restrict__ vals, const int* __restrict__ idx, int M, int O,
    int NB, int KB, int bn, int m0, int o0, int b) {
  using R = BlockRegs<T, kBM, kBO, kThreads>;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
#pragma unroll
  for (int i = 0; i < R::kRows; ++i) {
    const int o = o0 + warp + R::kWarps * i;
    const size_t base = ((size_t)o * NB + b) * KB;
#pragma unroll
    for (int j = 0; j < kSlotIters; ++j) {
      const int s = lane + kLanes * j;
      const bool live = o < O && s < KB;
      r.idx[i][j] = live ? idx[base + s] : -1;
      r.val[i][j] = live ? vals[base + s] : T(0.f);
    }
  }
  const size_t n = (size_t)NB * bn;
#pragma unroll
  for (int i = 0; i < R::kX; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int m = e / bn;
    const int kk = e - m * bn;
    r.x[i] = (m < kBM && m0 + m < M)
                 ? x[(size_t)(m0 + m) * n + (size_t)b * bn + kk]
                 : T(0.f);
  }
}

// Zero the decoded tile and store the x slice (xs[m][kk], ws[o][c], both
// with row stride ld = bn + 4 floats).  Needs a sync before and after.
template <typename T, int kBM, int kBO, int kThreads>
__device__ __forceinline__ void stage_block(
    const BlockRegs<T, kBM, kBO, kThreads>& r, float* xs, float* ws, int bn,
    int ld) {
  using R = BlockRegs<T, kBM, kBO, kThreads>;
  float4* ws4 = reinterpret_cast<float4*>(ws);
  for (int e = threadIdx.x; e < kBO * ld / 4; e += kThreads)
    ws4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < R::kX; ++i) {
    const int e = threadIdx.x + kThreads * i;
    const int m = e / bn;
    if (m < kBM) xs[m * ld + (e - m * bn)] = to_f32(r.x[i]);
  }
}

// Scatter the block's nonzero slots into the zeroed tile, one warp per row
// (see the note at the top: the live columns of a row are distinct).
template <typename T, int kBM, int kBO, int kThreads>
__device__ __forceinline__ void decode_block(
    const BlockRegs<T, kBM, kBO, kThreads>& r, float* ws, int bn, int ld) {
  using R = BlockRegs<T, kBM, kBO, kThreads>;
  const int warp = threadIdx.x / kLanes;
#pragma unroll
  for (int i = 0; i < R::kRows; ++i) {
    float* row = ws + (warp + R::kWarps * i) * ld;
#pragma unroll
    for (int j = 0; j < kSlotIters; ++j) {
      const int c = r.idx[i][j];
      const float v = to_f32(r.val[i][j]);
      if ((unsigned)c < (unsigned)bn && v != 0.f) row[c] = v;
    }
  }
}

// ---- wide (prefill) -------------------------------------------------------
constexpr int kWideBM = 32;                  // output rows (M) per CTA
constexpr int kWideBO = 64;                  // output columns (O) per CTA
constexpr int kWideThreads = 256;            // 16 (o) x 16 (m), 4 x 2 outputs

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kWideThreads)
tiled_spmm_wide_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                       const int* __restrict__ idx, float* __restrict__ y,
                       int M, int O, int NB, int KB, int bn) {
  extern __shared__ float4 smem4[];
  // the expert (grid z) of a batched launch; the 2-D kernels have none
  const size_t e = kBatched ? blockIdx.z : 0;
  x += e * M * ((size_t)NB * bn);
  vals += e * O * ((size_t)NB * KB);
  idx += e * O * ((size_t)NB * KB);
  y += e * M * (size_t)O;
  const int ld = bn + 4;
  float* xs = reinterpret_cast<float*>(smem4);   // [kWideBM][ld]
  float* ws = xs + kWideBM * ld;                 // [kWideBO][ld]
  const int tx = threadIdx.x % 16;               // columns tx + 16 j
  const int ty = threadIdx.x / 16;               // rows ty + 16 i
  const int m0 = blockIdx.y * kWideBM;
  const int o0 = blockIdx.x * kWideBO;
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  BlockRegs<T, kWideBM, kWideBO, kWideThreads> regs;
  load_block(regs, x, vals, idx, M, O, NB, KB, bn, m0, o0, 0);
  for (int b = 0; b < NB; ++b) {
    __syncthreads();                 // the previous product is done with xs/ws
    stage_block(regs, xs, ws, bn, ld);
    __syncthreads();
    decode_block(regs, ws, bn, ld);
    if (b + 1 < NB)
      load_block(regs, x, vals, idx, M, O, NB, KB, bn, m0, o0, b + 1);
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < bn; kk += 4) {
      float4 xv[2], wv[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        xv[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * ld + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[j] = *reinterpret_cast<const float4*>(ws + (tx + 16 * j) * ld + kk);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(xv[i].x, wv[j].x, acc[i][j]);
          acc[i][j] = fmaf(xv[i].y, wv[j].y, acc[i][j]);
          acc[i][j] = fmaf(xv[i].z, wv[j].z, acc[i][j]);
          acc[i][j] = fmaf(xv[i].w, wv[j].w, acc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + tx + 16 * j;
      if (o < O) y[(size_t)m * O + o] = acc[i][j];
    }
  }
}

// ---- skinny (decode) ------------------------------------------------------
constexpr int kSkinnyM = 8;                  // the decode batch, padded to 8
constexpr int kSkinnyBO = 8;                 // output columns per CTA
constexpr int kSkinnyThreads = 256;          // 64 outputs x 4 parts of bn
constexpr int kSkinnyParts = kSkinnyThreads / (kSkinnyM * kSkinnyBO);

template <typename T, bool kBatched>
__global__ void __launch_bounds__(kSkinnyThreads)
tiled_spmm_skinny_kernel(const T* __restrict__ x, const T* __restrict__ vals,
                         const int* __restrict__ idx, float* __restrict__ y,
                         int M, int O, int NB, int KB, int bn) {
  extern __shared__ float4 smem4[];
  // the expert (grid z) of a batched launch; the 2-D kernels have none
  const size_t e = kBatched ? blockIdx.z : 0;
  x += e * M * ((size_t)NB * bn);
  vals += e * O * ((size_t)NB * KB);
  idx += e * O * ((size_t)NB * KB);
  y += e * M * (size_t)O;
  const int ld = bn + 4;
  float* xs = reinterpret_cast<float*>(smem4);   // [kSkinnyM][ld]
  float* ws = xs + kSkinnyM * ld;                // [kSkinnyBO][ld]
  const int q = threadIdx.x % (kSkinnyM * kSkinnyBO);
  const int m = q / kSkinnyBO;                   // this thread's output row
  const int r = q % kSkinnyBO;                   // and column
  const int part = threadIdx.x / (kSkinnyM * kSkinnyBO);
  const int span = bn / kSkinnyParts;            // its share of each block
  const int o0 = blockIdx.x * kSkinnyBO;
  float acc = 0.f;

  BlockRegs<T, kSkinnyM, kSkinnyBO, kSkinnyThreads> regs;
  load_block(regs, x, vals, idx, M, O, NB, KB, bn, 0, o0, 0);
  for (int b = 0; b < NB; ++b) {
    __syncthreads();
    stage_block(regs, xs, ws, bn, ld);
    __syncthreads();
    decode_block(regs, ws, bn, ld);
    if (b + 1 < NB)
      load_block(regs, x, vals, idx, M, O, NB, KB, bn, 0, o0, b + 1);
    __syncthreads();
    const float* xrow = xs + m * ld + part * span;
    const float* wrow = ws + r * ld + part * span;
#pragma unroll 8
    for (int kk = 0; kk < span; ++kk) acc = fmaf(xrow[kk], wrow[kk], acc);
  }
  // sum the parts in a fixed order
  __syncthreads();
  float* red = xs;                   // [kSkinnyParts][64], over xs and ws
  red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < kSkinnyM * kSkinnyBO) {
    float sum = 0.f;
#pragma unroll
    for (int p = 0; p < kSkinnyParts; ++p)
      sum += red[p * kSkinnyM * kSkinnyBO + threadIdx.x];
    const int o = o0 + r;
    if (m < M && o < O) y[(size_t)m * O + o] = sum;
  }
}

// bn a multiple of 4 in [4, 128] (float4 rows; the register slots hold
// KB <= 128 per row).  The wrapper checks the same before it launches.
bool supported(int KB, int bn) {
  return bn >= 4 && bn <= kMaxBn && bn % 4 == 0 && KB >= 0 && KB <= kMaxBn;
}

template <typename T>
using KernelFn = void (*)(const T*, const T*, const int*, float*, int, int,
                          int, int, int);

template <typename T>
int launch(KernelFn<T> kernel, dim3 grid, int threads, int smem,
           cudaStream_t s, const void* x, const void* vals, const int* idx,
           float* y, int M, int O, int NB, int KB, int bn) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0 || M == 0) return 0;
  kernel<<<grid, threads, smem, s>>>(static_cast<const T*>(x),
                                     static_cast<const T*>(vals), idx, y, M,
                                     O, NB, KB, bn);
  return (int)cudaGetLastError();
}

constexpr int kMaxExperts = 65535;           // grid z limit

// E > 1 slices only with kBatched (the 2-D kernels skip the z offset).
template <typename T, bool kBatched>
int launch_wide(const void* x, const void* vals, const int* idx, float* y,
                int E, int M, int O, int NB, int KB, int bn, cudaStream_t s) {
  if (!supported(KB, bn) || E < 0 || E > kMaxExperts)
    return (int)cudaErrorInvalidValue;
  const int smem = (kWideBM + kWideBO) * (bn + 4) * (int)sizeof(float);
  const dim3 grid((O + kWideBO - 1) / kWideBO, (M + kWideBM - 1) / kWideBM,
                  E);
  return launch<T>(tiled_spmm_wide_kernel<T, kBatched>, grid, kWideThreads,
                   smem, s, x, vals, idx, y, M, O, NB, KB, bn);
}

template <typename T, bool kBatched>
int launch_skinny(const void* x, const void* vals, const int* idx, float* y,
                  int E, int M, int O, int NB, int KB, int bn,
                  cudaStream_t s) {
  if (M > kSkinnyM || !supported(KB, bn) || E < 0 || E > kMaxExperts)
    return (int)cudaErrorInvalidValue;
  // the tiles, or the parts' partial sums if those need more room
  const int floats = (kSkinnyM + kSkinnyBO) * (bn + 4);
  const int smem = (floats > kSkinnyThreads ? floats : kSkinnyThreads) *
                   (int)sizeof(float);
  const dim3 grid((O + kSkinnyBO - 1) / kSkinnyBO, 1, E);
  return launch<T>(tiled_spmm_skinny_kernel<T, kBatched>, grid,
                   kSkinnyThreads, smem, s, x, vals, idx, y, M, O, NB, KB,
                   bn);
}

// The expert grid: the skinny tile for per-expert M <= 8, else the wide one.
template <typename T>
int launch_batched(const void* x, const void* vals, const int* idx, float* y,
                   int E, int M, int O, int NB, int KB, int bn,
                   cudaStream_t s) {
  if (M <= kSkinnyM)
    return launch_skinny<T, true>(x, vals, idx, y, E, M, O, NB, KB, bn, s);
  return launch_wide<T, true>(x, vals, idx, y, E, M, O, NB, KB, bn, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and values share it).  y is f32
// [M, O].  Returns the cudaError_t of the launch (0 on success).
int tiled_spmm_wide(const void* x, const void* vals, const int* idx, float* y,
                    int M, int O, int NB, int KB, int bn, int dtype,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_wide<__nv_bfloat16, false>(x, vals, idx, y, 1, M, O, NB, KB,
                                             bn, s);
  return launch_wide<float, false>(x, vals, idx, y, 1, M, O, NB, KB, bn, s);
}

int tiled_spmm_skinny(const void* x, const void* vals, const int* idx,
                      float* y, int M, int O, int NB, int KB, int bn,
                      int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_skinny<__nv_bfloat16, false>(x, vals, idx, y, 1, M, O, NB,
                                               KB, bn, s);
  return launch_skinny<float, false>(x, vals, idx, y, 1, M, O, NB, KB, bn, s);
}

// x [E, M, NB*bn], values / indices [E, O, NB, KB], y f32 [E, M, O].
int tiled_spmm_batched(const void* x, const void* vals, const int* idx,
                       float* y, int E, int M, int O, int NB, int KB, int bn,
                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_batched<__nv_bfloat16>(x, vals, idx, y, E, M, O, NB, KB, bn,
                                         s);
  return launch_batched<float>(x, vals, idx, y, E, M, O, NB, KB, bn, s);
}

const char* spmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
