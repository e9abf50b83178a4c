// The tiled balanced-sparse x dense matmul kernels, y = x @ decode(W)^T,
// as templates shared by balanced_spmm.cu (values in the activation dtype)
// and balanced_spmm_q.cu (block-quantized int8 / int4 values): the FMA
// templates that float32 x takes (wide, skinny, batched skinny), the
// decoder of the tensor-core mainloop (tc_spmm.cuh) that bf16 wide calls
// take, and the decoder of the weight streamer (skinny_spmm.cuh) that bf16
// skinny calls take (the 2-D skinny entries, and the batched ones at
// M <= 8).  The design, the bounds and what each entry replaces are in
// those files' header notes; this file holds the code they share.
//
// A value policy W says how a slot's value is stored and decoded:
//   FloatValues<T>  values[.., O, NB, KB] in T, decoded as float(v);
//   Int8Values      int8 values[.., O, NB, KB] and f32 scales[.., O, NB],
//                   decoded as float(q) * scale;
//   Int4Values      uint8 values[.., O, NB, ceil(KB/2)], slot 2i the low
//                   nibble of byte i and 2i+1 the high one, sign-extended
//                   as (n ^ 8) - 8, decoded as float(q) * scale.
// float(q) * scale is one f32 multiply of exact operands: the same f32
// the reference's dequantize_values computes, bit for bit (the FMA
// templates and the streamer use it per slot).  The tensor-core decoder
// stores q itself in bf16 (|q| <= 127 is exact) and the mainloop scales
// the block's sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "skinny_spmm.cuh"
#include "tc_spmm.cuh"

namespace tiled_spmm {

constexpr int kMaxBn = 128;                  // widest column block a plan picks
constexpr int kLanes = 32;
constexpr int kSlotIters = kMaxBn / kLanes;  // a lane's slots per row (KB <= 128)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
struct FloatValues {
  using Raw = T;
  static constexpr bool kScaled = false;
  __host__ __device__ static int width(int kb) { return kb; }
  __device__ static int byte_of(int s) { return s; }
  __device__ static float decode(Raw v, int, float) { return to_f32(v); }
};

struct Int8Values {
  using Raw = int8_t;
  static constexpr bool kScaled = true;
  __host__ __device__ static int width(int kb) { return kb; }
  __device__ static int byte_of(int s) { return s; }
  __device__ static float decode(Raw q, int, float scale) {
    return (float)q * scale;
  }
};

struct Int4Values {
  using Raw = uint8_t;                       // the byte that holds the slot
  static constexpr bool kScaled = true;
  __host__ __device__ static int width(int kb) { return (kb + 1) / 2; }
  __device__ static int byte_of(int s) { return s >> 1; }
  __device__ static float decode(Raw b, int s, float scale) {
    const int n = (s & 1) ? (b >> 4) : (b & 0xF);
    return (float)((n ^ 8) - 8) * scale;
  }
};

// The registers that carry one column block from its loads to its decode:
// the KB slots (and, quantized, the scale) of each row this warp decodes
// (rows warp, warp + kWarps, ...) and this thread's share of the
// [kBM, bn] x slice.  Values stay in their storage type until they are
// used: a conversion right after its load would wait for that load.
template <typename T, typename W, int kBM, int kBO, int kThreads>
struct BlockRegs {
  static constexpr int kWarps = kThreads / kLanes;
  static constexpr int kRows = kBO / kWarps;
  static constexpr int kX = kBM * kMaxBn / kThreads;
  int idx[kRows][kSlotIters];
  typename W::Raw val[kRows][kSlotIters];
  float scale[kRows];
  T x[kX];
};

template <typename T, typename W, int kBM, int kBO, int kThreads>
__device__ __forceinline__ void load_block(
    BlockRegs<T, W, kBM, kBO, kThreads>& r, const T* __restrict__ x,
    const typename W::Raw* __restrict__ vals, const int* __restrict__ idx,
    const float* __restrict__ scales, int M, int O, int NB, int KB, int bn,
    int m0, int o0, int b) {
  using R = BlockRegs<T, W, kBM, kBO, kThreads>;
  using Raw = typename W::Raw;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int kbv = W::width(KB);
#pragma unroll
  for (int i = 0; i < R::kRows; ++i) {
    const int o = o0 + warp + R::kWarps * i;
    const size_t blk = (size_t)o * NB + b;
    if (W::kScaled) r.scale[i] = o < O ? scales[blk] : 0.f;
#pragma unroll
    for (int j = 0; j < kSlotIters; ++j) {
      const int s = lane + kLanes * j;
      const bool live = o < O && s < KB;
      r.idx[i][j] = live ? idx[blk * KB + s] : -1;
      r.val[i][j] = live ? vals[blk * kbv + W::byte_of(s)] : Raw(0.f);
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
template <typename T, typename W, int kBM, int kBO, int kThreads>
__device__ __forceinline__ void stage_block(
    const BlockRegs<T, W, kBM, kBO, kThreads>& r, float* xs, float* ws,
    int bn, int ld) {
  using R = BlockRegs<T, W, kBM, kBO, kThreads>;
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
// (the live columns of a row are distinct, see balanced_spmm.cu's note).
template <typename T, typename W, int kBM, int kBO, int kThreads>
__device__ __forceinline__ void decode_block(
    const BlockRegs<T, W, kBM, kBO, kThreads>& r, float* ws, int bn,
    int ld) {
  using R = BlockRegs<T, W, kBM, kBO, kThreads>;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
#pragma unroll
  for (int i = 0; i < R::kRows; ++i) {
    float* row = ws + (warp + R::kWarps * i) * ld;
#pragma unroll
    for (int j = 0; j < kSlotIters; ++j) {
      const int c = r.idx[i][j];
      const float v = W::decode(r.val[i][j], lane + kLanes * j,
                                W::kScaled ? r.scale[i] : 1.f);
      if ((unsigned)c < (unsigned)bn && v != 0.f) row[c] = v;
    }
  }
}

// ---- wide (prefill) -------------------------------------------------------
constexpr int kWideBM = 32;                  // output rows (M) per CTA
constexpr int kWideBO = 64;                  // output columns (O) per CTA
constexpr int kWideThreads = 256;            // 16 (o) x 16 (m), 4 x 2 outputs

template <typename T, typename W, bool kBatched>
__global__ void __launch_bounds__(kWideThreads)
tiled_spmm_wide_kernel(const T* __restrict__ x,
                       const typename W::Raw* __restrict__ vals,
                       const int* __restrict__ idx,
                       const float* __restrict__ scales,
                       float* __restrict__ y, int M, int O, int NB, int KB,
                       int bn) {
  extern __shared__ float4 smem4[];
  // the expert (grid z) of a batched launch; the 2-D kernels have none
  const size_t e = kBatched ? blockIdx.z : 0;
  x += e * M * ((size_t)NB * bn);
  vals += e * O * ((size_t)NB * W::width(KB));
  idx += e * O * ((size_t)NB * KB);
  if (W::kScaled) scales += e * O * (size_t)NB;
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

  BlockRegs<T, W, kWideBM, kWideBO, kWideThreads> regs;
  load_block(regs, x, vals, idx, scales, M, O, NB, KB, bn, m0, o0, 0);
  for (int b = 0; b < NB; ++b) {
    __syncthreads();                 // the previous product is done with xs/ws
    stage_block(regs, xs, ws, bn, ld);
    __syncthreads();
    decode_block(regs, ws, bn, ld);
    if (b + 1 < NB)
      load_block(regs, x, vals, idx, scales, M, O, NB, KB, bn, m0, o0, b + 1);
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

template <typename T, typename W, bool kBatched>
__global__ void __launch_bounds__(kSkinnyThreads)
tiled_spmm_skinny_kernel(const T* __restrict__ x,
                         const typename W::Raw* __restrict__ vals,
                         const int* __restrict__ idx,
                         const float* __restrict__ scales,
                         float* __restrict__ y, int M, int O, int NB, int KB,
                         int bn) {
  extern __shared__ float4 smem4[];
  // the expert (grid z) of a batched launch; the 2-D kernels have none
  const size_t e = kBatched ? blockIdx.z : 0;
  x += e * M * ((size_t)NB * bn);
  vals += e * O * ((size_t)NB * W::width(KB));
  idx += e * O * ((size_t)NB * KB);
  if (W::kScaled) scales += e * O * (size_t)NB;
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

  BlockRegs<T, W, kSkinnyM, kSkinnyBO, kSkinnyThreads> regs;
  load_block(regs, x, vals, idx, scales, M, O, NB, KB, bn, 0, o0, 0);
  for (int b = 0; b < NB; ++b) {
    __syncthreads();
    stage_block(regs, xs, ws, bn, ld);
    __syncthreads();
    decode_block(regs, ws, bn, ld);
    if (b + 1 < NB)
      load_block(regs, x, vals, idx, scales, M, O, NB, KB, bn, 0, o0, b + 1);
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
inline bool supported(int KB, int bn) {
  return bn >= 4 && bn <= kMaxBn && bn % 4 == 0 && KB >= 0 && KB <= kMaxBn;
}

template <typename T, typename W>
using KernelFn = void (*)(const T*, const typename W::Raw*, const int*,
                          const float*, float*, int, int, int, int, int);

template <typename T, typename W>
int launch(KernelFn<T, W> kernel, dim3 grid, int threads, int smem,
           cudaStream_t s, const void* x, const void* vals, const int* idx,
           const float* scales, float* y, int M, int O, int NB, int KB,
           int bn) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (grid.x == 0 || grid.y == 0 || grid.z == 0 || M == 0) return 0;
  kernel<<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const typename W::Raw*>(vals),
      idx, scales, y, M, O, NB, KB, bn);
  return (int)cudaGetLastError();
}

constexpr int kMaxExperts = 65535;           // grid z limit

// E > 1 slices only with kBatched (the 2-D kernels skip the z offset).
template <typename T, typename W, bool kBatched>
int launch_wide(const void* x, const void* vals, const int* idx,
                const float* scales, float* y, int E, int M, int O, int NB,
                int KB, int bn, cudaStream_t s) {
  if (!supported(KB, bn) || E < 0 || E > kMaxExperts)
    return (int)cudaErrorInvalidValue;
  const int smem = (kWideBM + kWideBO) * (bn + 4) * (int)sizeof(float);
  const dim3 grid((O + kWideBO - 1) / kWideBO, (M + kWideBM - 1) / kWideBM,
                  E);
  return launch<T, W>(tiled_spmm_wide_kernel<T, W, kBatched>, grid,
                      kWideThreads, smem, s, x, vals, idx, scales, y, M, O,
                      NB, KB, bn);
}

template <typename T, typename W, bool kBatched>
int launch_skinny(const void* x, const void* vals, const int* idx,
                  const float* scales, float* y, int E, int M, int O, int NB,
                  int KB, int bn, cudaStream_t s) {
  if (M > kSkinnyM || !supported(KB, bn) || E < 0 || E > kMaxExperts)
    return (int)cudaErrorInvalidValue;
  // the tiles, or the parts' partial sums if those need more room
  const int floats = (kSkinnyM + kSkinnyBO) * (bn + 4);
  const int smem = (floats > kSkinnyThreads ? floats : kSkinnyThreads) *
                   (int)sizeof(float);
  const dim3 grid((O + kSkinnyBO - 1) / kSkinnyBO, 1, E);
  return launch<T, W>(tiled_spmm_skinny_kernel<T, W, kBatched>, grid,
                      kSkinnyThreads, smem, s, x, vals, idx, scales, y, M, O,
                      NB, KB, bn);
}

// ---- wide on the tensor cores (bf16 x) -----------------------------------
// The tiled balanced decoder of tc_spmm.cuh's mainloop.  A stage holds the
// block's staged encodings of the CTA's 64 rows: indices [64][KB] int32,
// values [64][width(KB)] raw, rows padded to 16 bytes, and (quantized) the
// 64 scales.  The decode zeroes the warp's 8 rows of the bf16 tile, then a
// lane takes 4 consecutive slots of a row (one 16-byte index load, one
// value load) and stores each slot's value (q for a quantized policy: the
// scale is applied to the block's sum) at its swizzled column; slots that
// decode to 0 (pad slots, zero-scale blocks' q = 0), slots past KB and
// columns outside [0, bn) never store.
template <typename W>
struct BalancedTc {
  using Raw = typename W::Raw;
  static constexpr bool kScaled = W::kScaled;
  struct Params {
    const Raw* vals;
    const int* idx;
    const float* scales;
    int KB;
    int vw, iw;                              // piece bytes of the runs
  };
  struct Prefetch {};
  __host__ __device__ static int vbytes(int kb) {
    return W::width(kb) * (int)sizeof(Raw);
  }
  __host__ __device__ static int ipitch(int kb) { return (kb * 4 + 15) & ~15; }
  __host__ __device__ static int vpitch(int kb) {
    return (vbytes(kb) + 15) & ~15;
  }
  __host__ __device__ static int raw_bytes(const Params& d, int) {
    return tc::kBO * (ipitch(d.KB) + vpitch(d.KB)) +
           (kScaled ? tc::kBO * 4 : 0);
  }
  __device__ static Params at_expert(Params d, const tc::Problem& p, int e) {
    const size_t rows = (size_t)e * p.O * p.NB;
    d.vals += rows * W::width(d.KB);
    d.idx += rows * d.KB;
    if (kScaled) d.scales += rows;
    return d;
  }
  __device__ static void load(const Params& d, const tc::Problem& p,
                              uint8_t* raw, int o0, int b, Prefetch&) {
    const int kb = d.KB;
    const int vb = vbytes(kb);
    uint8_t* rv = raw + tc::kBO * ipitch(kb);
    tc::copy_rows(raw, ipitch(kb), kb * 4, d.iw,
                  [&](int r) -> const uint8_t* {
                    const int o = o0 + r;
                    return o < p.O ? reinterpret_cast<const uint8_t*>(
                                         d.idx + ((size_t)o * p.NB + b) * kb)
                                   : nullptr;
                  });
    tc::copy_rows(rv, vpitch(kb), vb, d.vw, [&](int r) -> const uint8_t* {
      const int o = o0 + r;
      return o < p.O ? reinterpret_cast<const uint8_t*>(d.vals) +
                           ((size_t)o * p.NB + b) * vb
                     : nullptr;
    });
    if (kScaled && threadIdx.x < tc::kBO && o0 + (int)threadIdx.x < p.O)
      tc::copy_piece(rv + tc::kBO * vpitch(kb) + threadIdx.x * 4,
                     reinterpret_cast<const uint8_t*>(
                         d.scales + (size_t)(o0 + threadIdx.x) * p.NB + b),
                     4);
  }
  __device__ static float scale(const Params& d, const uint8_t* raw, int r) {
    return reinterpret_cast<const float*>(
        raw + tc::kBO * (ipitch(d.KB) + vpitch(d.KB)))[r];
  }
  // The raw values of slots 4q .. 4q+3 of a staged value row, and their
  // decode to bf16 bits (q, not q * scale; 0 for a slot that decodes to
  // 0).  No conversion instruction: a bf16 value keeps its bits, and an
  // integer q is exact as 12582912 + q in f32, whose top half is bf16(q)
  // once 12582912 is taken off.
  using Quad = typename std::conditional<
      sizeof(Raw) == 2, uint2,
      typename std::conditional<std::is_same<W, Int8Values>::value, uint32_t,
                                uint16_t>::type>::type;
  __device__ static Quad quad(const uint8_t* vrow, int q) {
    return reinterpret_cast<const Quad*>(vrow)[q];
  }
  __device__ static uint32_t int_bits(int q) {
    return __float_as_uint(__int_as_float(0x4B400000 + q) - 12582912.f) >>
           16;
  }
  __device__ static void unpack(Quad u, uint32_t (&h)[4]) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if constexpr (sizeof(Raw) == 2) {
        const uint32_t w = ((t < 2 ? u.x : u.y) >> (16 * (t & 1))) & 0xFFFF;
        h[t] = (w & 0x7FFF) ? w : 0u;        // +-0 decode to nothing
      } else if constexpr (std::is_same<W, Int8Values>::value) {
        h[t] = int_bits((int)(int8_t)(u >> (8 * t)));
      } else {
        h[t] = int_bits((int)(((u >> (4 * t)) & 0xF) ^ 8) - 8);
      }
    }
  }
  // The warp's 8 rows: their staged slots are read first (one 16-byte
  // index load and one value load a row), then the rows are zeroed and the
  // slots stored, so the reads are in flight together.
  __device__ static void decode(const Params& d, const tc::Problem& p,
                                const uint8_t* raw, uint8_t* wt, int o0) {
    constexpr int kRows = tc::kRowsPerWarp;
    const int warp = threadIdx.x / kLanes;
    const int lane = threadIdx.x % kLanes;
    const int kb = d.KB;
    const int r0 = warp * kRows;
    const int q = lane;                      // KB <= 128: one quad a lane
    const int nq = kb - 4 * q;               // live slots of the quad
    const uint8_t* rv = raw + tc::kBO * ipitch(kb);
    int4 c4[kRows];
    Quad u[kRows];
    if (nq > 0) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        c4[i] = reinterpret_cast<const int4*>(raw + (r0 + i) * ipitch(kb))[q];
        u[i] = quad(rv + (r0 + i) * vpitch(kb), q);
      }
    }
    // zero the rows' 16-byte chunks: 8 a swizzle atom, 1 or 2 atoms
    const int shift = p.bn > tc::kAtomCols ? 4 : 3;     // log2(chunks)
    for (int c = lane; c < kRows << shift; c += kLanes) {
      const int k = c & ((1 << shift) - 1);
      *reinterpret_cast<uint4*>(wt + (k >> 3) * tc::kBO * 128 +
                                (r0 + (c >> shift)) * 128 + (k & 7) * 16) =
          make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
    if (nq <= 0) return;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      if (o0 + r >= p.O) continue;           // rows past O stay zero
      uint32_t h[4];
      unpack(u[i], h);
      const int cols[4] = {c4[i].x, c4[i].y, c4[i].z, c4[i].w};
      uint8_t* row = wt + r * 128;
      const int x16 = (r & 7) << 4;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = cols[t];
        if (t < nq && (unsigned)c < (unsigned)p.bn && h[t] != 0)
          *reinterpret_cast<uint16_t*>(
              row + ((c & tc::kAtomCols) << 7) + (((c << 1) & 126) ^ x16)) =
              (uint16_t)h[t];
      }
    }
  }
};

template <typename W>
int launch_wide_tc(const void* x, const void* vals, const int* idx,
                   const float* scales, float* y, float* ws, int splits,
                   int E, int M, int O, int NB, int KB, int bn,
                   cudaStream_t s) {
  if (!supported(KB, bn)) return (int)cudaErrorInvalidValue;
  using D = BalancedTc<W>;
  const typename D::Params dp{
      static_cast<const typename W::Raw*>(vals), idx, scales, KB,
      tc::piece_bytes(vals, D::vbytes(KB)), tc::piece_bytes(idx, KB * 4)};
  const tc::Problem p{static_cast<const __nv_bfloat16*>(x), y, ws, E, M, O,
                      NB, bn, splits, tc::piece_bytes(x, bn * 2)};
  return tc::launch<D>(p, dp, s);
}

// The wide entry: bf16 x takes the tensor-core kernel (split-K over
// `splits`), float32 x the FMA template (splits must be 1).
template <typename T, typename W, bool kBatched>
int launch_wide_any(const void* x, const void* vals, const int* idx,
                    const float* scales, float* y, float* ws, int splits,
                    int E, int M, int O, int NB, int KB, int bn,
                    cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_wide_tc<W>(x, vals, idx, scales, y, ws, splits, E, M, O,
                             NB, KB, bn, s);
  } else {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return launch_wide<T, W, kBatched>(x, vals, idx, scales, y, E, M, O, NB,
                                       KB, bn, s);
  }
}

// ---- skinny (decode) for bf16 x: the weight streamer -------------------
// The tiled balanced decoder of skinny_spmm.cuh's mainloop.  An item is a
// group of G column blocks of one row; a staged block holds the live
// prefix of the block's indices (counts[o, b] int32 words) and of its
// values (the bytes that hold slots [0, count)), each rounded up to the
// copy piece, and its header the count and (quantized) the scale: slots
// from the count on are pads (value 0, index 0) and are neither read nor
// used.  32 / G lanes copy a block.  The decode takes a block at a time:
// lane l takes slots l, l + 32, ... (KB <= 128: at most 4), loads all its
// slots' indices and values, then their x columns, then decodes each value
// (float(q) * scale for a quantized policy, bit for bit dequantize_values)
// and, unless its column is outside [0, bn) or it decodes to 0, adds
// x[:, column] * value into its accumulators.
template <typename W>
struct BalancedStream {
  using Raw = typename W::Raw;
  struct Params {
    const Raw* vals;
    const int* idx;
    const int* counts;
    const float* scales;
    int KB;
    int iw, vw;                              // piece bytes of the runs
  };
  __host__ __device__ static int vbytes(int kb) {
    return W::width(kb) * (int)sizeof(Raw);
  }
  __host__ __device__ static int ipitch(int kb) { return sk::round16(kb * 4); }
  static int block_bytes(const Params& d, int) {
    return ipitch(d.KB) + sk::round16(vbytes(d.KB));
  }
  __device__ static Params at_expert(Params d, const sk::Problem& p, int e) {
    const size_t rows = (size_t)e * p.O * p.NB;
    d.vals += rows * W::width(d.KB);
    d.idx += rows * d.KB;
    d.counts += rows;
    if (W::kScaled) d.scales += rows;
    return d;
  }
  __device__ static sk::Meta load_meta(const Params& d, const sk::Problem& p,
                                       int o, int b) {
    const size_t at = (size_t)o * p.NB + b;
    return {__ldg(d.counts + at),
            W::kScaled ? __float_as_int(__ldg(d.scales + at)) : 0};
  }
  __device__ static void issue(const Params& d, const sk::Problem& p,
                               uint8_t* stage, int o, int b0, int n,
                               const sk::Meta& cur) {
    const int lane = threadIdx.x % kLanes;
    const int per = kLanes >> (__ffs(p.G) - 1);   // lanes a block
    const int g = lane >> (__ffs(per) - 1);
    const int r = lane & (per - 1);
    const int b = b0 + g;
    int cnt = __shfl_sync(0xffffffffu, cur.a, b & (sk::kSeg - 1));
    const int f = __shfl_sync(0xffffffffu, cur.f, b & (sk::kSeg - 1));
    if (g >= n) return;
    cnt = cnt < 0 ? 0 : (cnt > d.KB ? d.KB : cnt);
    if (r == 0)
      *reinterpret_cast<int2*>(stage + g * sk::kHeader) = make_int2(cnt, f);
    const size_t blk = (size_t)o * p.NB + b;
    uint8_t* di = stage + p.G * sk::kHeader + g * p.block_bytes;
    // the prefix rounded up to whole pieces stays inside the block's run
    // (a piece width divides the run's bytes)
    sk::copy_pieces(di, reinterpret_cast<const uint8_t*>(d.idx + blk * d.KB),
                    (cnt * 4 + d.iw - 1) >> (__ffs(d.iw) - 1), r, per, d.iw);
    sk::copy_pieces(
        di + ipitch(d.KB),
        reinterpret_cast<const uint8_t*>(d.vals) + blk * vbytes(d.KB),
        (vbytes(cnt) + d.vw - 1) >> (__ffs(d.vw) - 1), r, per, d.vw);
  }
  // U slots a lane (lane, lane + 32, ...; U = ceil(count / 32), the same
  // for the warp): their indices and values, then their x columns, then
  // the products.
  template <int kM, int U>
  __device__ static void slots(const int* ci, const Raw* cv, int cnt,
                               float scale, const uint8_t* xs, int col0,
                               int bn, float (&acc)[kM]) {
    const int lane = threadIdx.x % kLanes;
    int c[U];
    Raw raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = lane + kLanes * u;
      const bool live = j < cnt;
      c[u] = live ? ci[j] : -1;
      raw[u] = live ? cv[W::byte_of(j)] : Raw(0.f);
    }
    sk::XCol<kM> xc[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if ((unsigned)c[u] < (unsigned)bn)
        xc[u] = sk::x_column<kM>(xs, col0 + c[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float v = W::decode(raw[u], lane + kLanes * u, scale);
      if ((unsigned)c[u] < (unsigned)bn && v != 0.f)
        sk::fma_column<kM>(xc[u], v, acc);
    }
  }
  template <int kM>
  __device__ static void compute(const Params& d, const sk::Problem& p,
                                 const uint8_t* stage, int, int n,
                                 const uint8_t* xs, int col0,
                                 float (&acc)[kM]) {
    for (int g = 0; g < n; ++g) {
      const int2 h = *reinterpret_cast<const int2*>(stage + g * sk::kHeader);
      const uint8_t* blk = stage + p.G * sk::kHeader + g * p.block_bytes;
      const int* ci = reinterpret_cast<const int*>(blk);
      const Raw* cv = reinterpret_cast<const Raw*>(blk + ipitch(d.KB));
      const float scale = __int_as_float(h.y);
      const int cb = col0 + g * p.bn;
      switch ((h.x + kLanes - 1) / kLanes) {   // KB <= 128: at most 4
        case 0: break;
        case 1: slots<kM, 1>(ci, cv, h.x, scale, xs, cb, p.bn, acc); break;
        case 2: slots<kM, 2>(ci, cv, h.x, scale, xs, cb, p.bn, acc); break;
        case 3: slots<kM, 3>(ci, cv, h.x, scale, xs, cb, p.bn, acc); break;
        default: slots<kM, 4>(ci, cv, h.x, scale, xs, cb, p.bn, acc);
      }
    }
  }
};

template <typename W, bool kBatched>
int launch_skinny_stream(const void* x, const void* vals, const int* idx,
                         const int* counts, const float* scales, float* y,
                         int E, int M, int O, int NB, int KB, int bn,
                         cudaStream_t s) {
  if (!supported(KB, bn) || counts == nullptr || E > kMaxExperts)
    return (int)cudaErrorInvalidValue;
  using D = BalancedStream<W>;
  const typename D::Params d{static_cast<const typename W::Raw*>(vals), idx,
                             counts, scales, KB,
                             tc::piece_bytes(idx, (size_t)KB * 4),
                             tc::piece_bytes(vals, D::vbytes(KB))};
  const sk::Problem p{static_cast<const __nv_bfloat16*>(x), y, E, M, O, NB,
                      bn, 0, 0, 0};
  return sk::launch<D, kBatched>(p, d, s);
}

// The skinny entry: bf16 x takes the weight streamer, float32 x the FMA
// template (the f32 parity gates' route; its x is twice as wide and N =
// 8192 would not stay resident).
template <typename T, typename W, bool kBatched>
int launch_skinny_any(const void* x, const void* vals, const int* idx,
                      const int* counts, const float* scales, float* y,
                      int E, int M, int O, int NB, int KB, int bn,
                      cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return launch_skinny_stream<W, kBatched>(x, vals, idx, counts, scales, y,
                                             E, M, O, NB, KB, bn, s);
  } else {
    return launch_skinny<T, W, kBatched>(x, vals, idx, scales, y, E, M, O,
                                         NB, KB, bn, s);
  }
}

// The expert grid: the skinny route for per-expert M <= 8, else the wide
// one.
template <typename T, typename W>
int launch_batched(const void* x, const void* vals, const int* idx,
                   const int* counts, const float* scales, float* y,
                   float* ws, int splits, int E, int M, int O, int NB, int KB,
                   int bn, cudaStream_t s) {
  if (M <= kSkinnyM) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return launch_skinny_any<T, W, true>(x, vals, idx, counts, scales, y, E,
                                         M, O, NB, KB, bn, s);
  }
  return launch_wide_any<T, W, true>(x, vals, idx, scales, y, ws, splits, E,
                                     M, O, NB, KB, bn, s);
}

}  // namespace tiled_spmm
