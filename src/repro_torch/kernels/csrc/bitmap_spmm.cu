// Bitmap-compressed sparse x dense matmul, y[M, O] = x[M, N] @ decode(W)^T,
// for NVIDIA Hopper (sm_90a).  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/_build.py; the wrapper lives in
// src/repro_torch/kernels/bitmap_spmm.py.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/bitmap_spmm.py,
// bitmap_spmm_pallas (_kernel), with the entry bitmap_spmm: in bf16, M > 8
// the tensor-core kernel tc::tc_spmm_kernel<BitmapTc> and M <= 8 the
// weight streamer sk::skinny_stream_kernel<BitmapStream>; in float32
// bitmap_spmm_wide_kernel and bitmap_spmm_skinny_kernel (FMA).
//
// W [O, N] is (bitmap int8 [O, N], packed [O, K] in the activation dtype,
// offsets int32 [O, N / bn]): element (r, c) of column block nb is
//   packed[r, clip(offsets[r, nb] + (set bits of row r in block nb up to and
//   including c) - 1, 0, K - 1)] if bitmap[r, c] != 0, else 0.
// Any nonzero bitmap byte is a set bit, as the reference's `bitmap != 0`.
//
// What bounds it on an H100: a call must read the bitmap (one byte per
// element of W), the packed nonzeros and the offsets once: at olmo-1b's
// 8192 x 2048, sparsity 0.5, bf16, 16.8 + 16.8 + 0.5 MB, about 0.010 ms at
// 3.35 TB/s, so both decode (M = 8) and prefill (M = 128) are bound by
// device-memory bytes.
//
// bf16 x, M > 8: the tensor-core kernel of tc_spmm.cuh (tiles, stages,
// TMA-loaded x, split-K with its fixed-order sum: balanced_spmm.cu's note)
// with the BitmapTc decoder below.
//  * The Pallas kernel stages a row block's whole packed run [bo, K] in
//    VMEM; at olmo-1b (K = 1024 bf16, 128 rows) that is 256 KB, over the
//    227 KB a CTA may have.  Here a stage holds, per row of the CTA's 64,
//    the block's bitmap bytes, its offset, and a window of the packed row:
//    min(bn, K - c0) elements from c0 = offsets[r, b] clipped to [0, K),
//    which hold every element the block can read (a position is the offset
//    plus a rank below bn, clipped to [0, K)).  All of it is copied with
//    cp.async one iteration ahead; the offsets a stage needs are loaded
//    into registers a stage earlier still, so no copy waits on another.
//  * The decode: a lane owns 4 consecutive columns, reads their 4 bitmap
//    bytes at once, ranks its set bits with 4 warp ballots, reads their
//    packed values from the window and writes the 4 columns (value or 0)
//    with one 8-byte store into the swizzled bf16 tile, so no zeroing pass.
//  What bounds it now: as the tiled kernel, the bytes it copies (the
//  window is up to bn elements, about twice the block's nonzeros at
//  sparsity 0.5) and the decode that the product does not hide.
//
// bf16 x, M <= 8: the weight streamer of skinny_spmm.cuh with the
// BitmapStream decoder below (balanced_spmm.cu's note).  A staged block is
// the block's bitmap bytes and its window of packed elements, from its
// offset to the next block's (the block's nonzeros), so the stream reads
// about the bound's bytes.  What bounds it now: instruction issue, more so
// than the tiled streamer's (4 ballots and 4 predicated slots a lane per
// block, half of them unset at sparsity 0.5): 8192 x 2048, M = 8, 7.1x its
// byte bound.
//
// float32 x keeps the FMA kernels (TF32 would miss the f32 bar, see
// balanced_spmm.cu), M > 8 the wide one and M <= 8 the skinny one:
//  * The TPU grid's sequential column-block axis becomes a loop inside the
//    CTA; one CTA owns one output tile and nothing carries between CTAs.
//  * Each row's nonzeros of a block are read from device memory where they
//    start, at offsets[r, nb]: one warp per row, lanes over the block's
//    columns in chunks of 32, the in-block rank of a set bit from a warp
//    ballot (__popc(mask & lanemask_lt) plus the counts of the chunks
//    before it), so the set bits of a chunk read consecutive packed
//    elements.
//  * Per column block: stage the x slice in shared memory (as f32), decode
//    the [BO, bn] tile into shared memory (f32; every element is written,
//    zeros included, so no separate zeroing pass), sync, accumulate the
//    product with f32 FMAs in registers.  bf16 x bf16 products are exact in
//    f32, as on the TPU's preferred_element_type=f32 dot.
//  * Tiles as the tiled balanced kernels (tiled_spmm.cuh): 32 x 64 outputs
//    per CTA for prefill, 8 x 8 for decode (M <= 8) with the block's columns
//    split in 4 parts summed in a fixed order; row strides of bn + 4 floats
//    keep the float4 reads and the decode's stores free of bank conflicts.
//    Several CTAs per SM overlap one CTA's decode loads with another's
//    product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>


#include "skinny_spmm.cuh"
#include "tc_spmm.cuh"

namespace {

constexpr int kMaxBn = 128;
constexpr int kLanes = 32;
constexpr int kChunks = kMaxBn / kLanes;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x[m0 .. m0 + kBM, block b] -> xs[m][kk] (f32, row stride ld), zero rows
// past M.
template <typename T, int kBM, int kThreads>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* xs,
                                        int M, int N, int bn, int ld, int m0,
                                        int b) {
  for (int e = threadIdx.x; e < kBM * bn; e += kThreads) {
    const int m = e / bn;
    const int kk = e - m * bn;
    const size_t at = (size_t)(m0 + m) * N + (size_t)b * bn + kk;
    xs[m * ld + kk] = m0 + m < M ? to_f32(x[at]) : 0.f;
  }
}

// Rows o0 .. o0 + kBO of column block b -> ws[r][c] (f32, row stride ld),
// one warp per row; rows past O decode to zeros.
template <typename T, int kBO, int kThreads>
__device__ __forceinline__ void decode_block(
    const int8_t* __restrict__ bitmap, const T* __restrict__ packed,
    const int* __restrict__ offsets, float* ws, int O, int N, int K, int bn,
    int ld, int o0, int b) {
  constexpr int kWarps = kThreads / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const unsigned below = (1u << lane) - 1u;     // lanes before this one
  const int nb = N / bn;
  for (int r = warp; r < kBO; r += kWarps) {     // warp-uniform
    const int o = o0 + r;
    float* row = ws + r * ld;
    if (o >= O) {
      for (int c = lane; c < bn; c += kLanes) row[c] = 0.f;
      continue;
    }
    const int8_t* bits = bitmap + (size_t)o * N + (size_t)b * bn;
    const T* prow = packed + (size_t)o * K;
    int8_t v[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = lane + kLanes * j;
      v[j] = c < bn ? bits[c] : 0;
    }
    int base = offsets[(size_t)o * nb + b];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = lane + kLanes * j;
      const bool set = v[j] != 0;
      const unsigned mask = __ballot_sync(0xffffffffu, set);
      float w = 0.f;
      if (set) {
        int pos = base + __popc(mask & below);
        pos = pos < 0 ? 0 : (pos >= K ? K - 1 : pos);
        w = to_f32(prow[pos]);
      }
      if (c < bn) row[c] = w;
      base += __popc(mask);
    }
  }
}

// ---- wide (prefill) -------------------------------------------------------
constexpr int kWideBM = 32;                  // output rows (M) per CTA
constexpr int kWideBO = 64;                  // output columns (O) per CTA
constexpr int kWideThreads = 256;            // 16 (o) x 16 (m), 4 x 2 outputs

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
bitmap_spmm_wide_kernel(const T* __restrict__ x,
                        const int8_t* __restrict__ bitmap,
                        const T* __restrict__ packed,
                        const int* __restrict__ offsets,
                        float* __restrict__ y, int M, int O, int N, int K,
                        int bn) {
  extern __shared__ float4 smem4[];
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

  for (int b = 0; b < N / bn; ++b) {
    __syncthreads();                 // the previous product is done with xs/ws
    stage_x<T, kWideBM, kWideThreads>(x, xs, M, N, bn, ld, m0, b);
    decode_block<T, kWideBO, kWideThreads>(bitmap, packed, offsets, ws, O, N,
                                           K, bn, ld, o0, b);
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

template <typename T>
__global__ void __launch_bounds__(kSkinnyThreads)
bitmap_spmm_skinny_kernel(const T* __restrict__ x,
                          const int8_t* __restrict__ bitmap,
                          const T* __restrict__ packed,
                          const int* __restrict__ offsets,
                          float* __restrict__ y, int M, int O, int N, int K,
                          int bn) {
  extern __shared__ float4 smem4[];
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

  for (int b = 0; b < N / bn; ++b) {
    __syncthreads();
    stage_x<T, kSkinnyM, kSkinnyThreads>(x, xs, M, N, bn, ld, 0, b);
    decode_block<T, kSkinnyBO, kSkinnyThreads>(bitmap, packed, offsets, ws,
                                               O, N, K, bn, ld, o0, b);
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

// ---- wide on the tensor cores (bf16 x) -----------------------------------
// The bitmap decoder of tc_spmm.cuh's mainloop.  A stage holds, for the
// CTA's 64 rows, the block's bitmap bytes ([64][bn], rows padded to 16
// bytes), their offsets, and each row's packed window: the elements
// [c0, c0 + min(bn, K - c0)) from c0 = offsets[r, b] clipped to [0, K),
// which hold every nonzero of the row's block, copied as the 16-byte pieces
// that cover them (pieces that leave the packed array go by 2-byte
// loads).  The offsets a stage needs are in registers one load ahead (a
// thread per row), so no copy waits on another.  The decode is the FMA
// kernel's rank by ballot, reading the window in shared memory; a position
// outside the window (only an offset outside [0, K) gives one) reads the
// packed array itself.  Every column < bn of a row < O is written (the
// value or 0).
struct BitmapTc {
  static constexpr bool kScaled = false;
  static constexpr int kPieces = 17;         // 16-byte pieces of a window
  static constexpr int kWin = kPieces * 16;
  struct Params {
    const int8_t* bitmap;
    const __nv_bfloat16* packed;
    const int* offsets;
    int K;
    int bw;                                  // piece bytes of a bitmap run
  };
  struct Prefetch {
    int b = -1;                              // the block `off` belongs to
    int off = 0;                             // offsets[o0 + tid, b]
  };
  __host__ __device__ static int pitch(int bn) { return (bn + 15) & ~15; }
  __host__ __device__ static int raw_bytes(const Params&, int bn) {
    return tc::kBO * (pitch(bn) + 8 + kWin);
  }
  __device__ static Params at_expert(Params d, const tc::Problem&, int) {
    return d;
  }
  // The window of a row from offset off: its first element c0 (off
  // clipped to [0, K)) and length min(bn, K - c0).  Every position the
  // decode reads, off + rank clipped to [0, K) with rank < bn, lies in it.
  __device__ static void window(const Params& d, int off, int bn, int& c0,
                                int& len) {
    c0 = off < 0 ? 0 : (off >= d.K ? d.K - 1 : off);
    len = d.K - c0 < bn ? d.K - c0 : bn;
  }
  __device__ static void load(const Params& d, const tc::Problem& p,
                              uint8_t* raw, int o0, int b, Prefetch& pre) {
    const size_t n = (size_t)p.NB * p.bn;
    int2* meta = reinterpret_cast<int2*>(raw + tc::kBO * pitch(p.bn));
    uint8_t* win = raw + tc::kBO * (pitch(p.bn) + 8);
    const uintptr_t lo = reinterpret_cast<uintptr_t>(d.packed);
    const uintptr_t hi = lo + (size_t)p.O * d.K * 2;
    const int t = threadIdx.x;
    if (t < tc::kBO && o0 + t < p.O) {
      // the row's offset, and where element `at` of its window sits:
      // win + wb + 2 at
      const int off = pre.b == b ? pre.off
                                 : d.offsets[(size_t)(o0 + t) * p.NB + b];
      int c0, len;
      window(d, off, p.bn, c0, len);
      const int lead = (int)((lo + ((size_t)(o0 + t) * d.K + c0) * 2) & 15);
      meta[t] = make_int2(off, t * kWin + lead - 2 * c0);
    }
    tc::copy_rows(raw, pitch(p.bn), p.bn, d.bw, [&](int r) -> const uint8_t* {
      const int o = o0 + r;
      return o < p.O ? reinterpret_cast<const uint8_t*>(
                           d.bitmap + (size_t)o * n + (size_t)b * p.bn)
                     : nullptr;
    });
    __syncthreads();                         // meta -> every thread
    for (int i = t; i < tc::kBO * kPieces; i += tc::kThreads) {
      const int r = i / kPieces;
      const int o = o0 + r;
      if (o >= p.O) continue;
      int c0, len;
      window(d, meta[r].x, p.bn, c0, len);
      const uintptr_t a0 = lo + ((size_t)o * d.K + c0) * 2;
      const uintptr_t g = (a0 & ~(uintptr_t)15) + (i % kPieces) * 16;
      if (g >= a0 + len * 2) continue;
      uint8_t* dst = win + r * kWin + (i % kPieces) * 16;
      if (g >= lo && g + 16 <= hi) {
        tc::copy_piece(dst, reinterpret_cast<const uint8_t*>(g), 16);
      } else {
        for (int k = 0; k < 16; k += 2)
          if (g + k >= lo && g + k < hi)
            *reinterpret_cast<uint16_t*>(dst + k) =
                *reinterpret_cast<const uint16_t*>(g + k);
      }
    }
    if (t < tc::kBO && o0 + t < p.O && b + 1 < p.NB) {
      pre.off = d.offsets[(size_t)(o0 + t) * p.NB + b + 1];
      pre.b = b + 1;
    }
  }
  // The warp's 8 rows; a lane owns 4 consecutive columns (bn is a
  // multiple of 4): one 4-byte read of their bitmap bytes, their ranks from
  // 4 ballots (the set bits before column 4 l + t: those of lanes below in
  // every byte, then this lane's bytes below t), 4 window reads, one 8-byte
  // store of the 4 decoded columns.  Each phase runs over the 8 rows, so
  // its reads are in flight together.  A position clipped to [0, K) always
  // lies in the row's window (see window), so nothing reads device memory.
  __device__ static void decode(const Params& d, const tc::Problem& p,
                                const uint8_t* raw, uint8_t* wt, int o0) {
    constexpr int kRows = tc::kRowsPerWarp;
    const int warp = threadIdx.x / kLanes;
    const int lane = threadIdx.x % kLanes;
    const unsigned below = (1u << lane) - 1u;
    const int2* meta =
        reinterpret_cast<const int2*>(raw + tc::kBO * pitch(p.bn));
    const uint8_t* win = raw + tc::kBO * (pitch(p.bn) + 8);
    const int r0 = warp * kRows;
    const int c = 4 * lane;                  // this lane's first column
    const bool mine = c < p.bn;
    uint32_t bits[kRows];
    int2 m[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      bits[i] = mine ? *reinterpret_cast<const uint32_t*>(
                           raw + (r0 + i) * pitch(p.bn) + c)
                     : 0u;
      m[i] = meta[r0 + i];
    }
    uint2 out[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const bool live = o0 + r0 + i < p.O;   // warp-uniform
      int pos = m[i].x;                      // + set bits before the lane
      bool set[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        set[t] = live && ((bits[i] >> (8 * t)) & 0xFF) != 0;
        pos += __popc(__ballot_sync(0xffffffffu, set[t]) & below);
      }
      uint32_t h[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int at = pos < 0 ? 0 : (pos >= d.K ? d.K - 1 : pos);
        h[t] = set[t] ? *reinterpret_cast<const uint16_t*>(win + m[i].y +
                                                           2 * at)
                      : 0u;
        pos += set[t];
      }
      out[i] = make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      if (o0 + r >= p.O || !mine) continue;  // rows past O stay zero
      *reinterpret_cast<uint2*>(wt + tc::swizzled(r, c, tc::kBO)) = out[i];
    }
  }
};

// ---- skinny (decode) for bf16 x: the weight streamer -------------------
// The bitmap decoder of skinny_spmm.cuh's mainloop.  An item is a group of
// G column blocks of one row; a staged block holds the block's bn bitmap
// bytes and its window of packed elements, packed[r, c0 .. c0 + len) with
// c0 = offsets[r, b] clipped to [0, K) and len = offsets[r, b + 1] - c0
// (the block's nonzeros; K - c0 for the row's last block and bn for the
// last block of a 32-block segment, whose next offset is not in the lanes'
// registers), at most min(bn, K - c0), copied as the 16-byte pieces that
// cover it (pieces that leave the packed array go by 2-byte loads); its
// header the offset, c0, len and the window's first byte.  32 / G lanes
// copy a block.  The decode takes a block at a time: a lane owns 4
// consecutive columns, reads their bitmap bytes at once, ranks its set
// bits with 4 warp ballots (the set bits of lanes below in each byte
// position, then its own bytes below), and for each set column reads the
// packed value at position offset + rank clipped to [0, K): from the
// window, or (only an offset that disagrees with the bitmap puts it
// outside) from device memory.
struct BitmapStream {
  struct Params {
    const int8_t* bitmap;
    const __nv_bfloat16* packed;
    const int* offsets;
    int K;
    int bw;                                  // piece bytes of a bitmap run
  };
  __host__ __device__ static int window(int bn) {
    return sk::round16(2 * bn) + 16;
  }
  static int block_bytes(const Params&, int bn) {
    return sk::round16(bn) + window(bn);
  }
  __device__ static Params at_expert(Params d, const sk::Problem&, int) {
    return d;
  }
  __device__ static sk::Meta load_meta(const Params& d, const sk::Problem& p,
                                       int o, int b) {
    return {__ldg(d.offsets + (size_t)o * p.NB + b), 0};
  }
  __device__ static void issue(const Params& d, const sk::Problem& p,
                               uint8_t* stage, int o, int b0, int n,
                               const sk::Meta& cur) {
    const int lane = threadIdx.x % kLanes;
    const int per = kLanes >> (__ffs(p.G) - 1);   // lanes a block
    const int g = lane >> (__ffs(per) - 1);
    const int r = lane & (per - 1);
    const int b = b0 + g;
    const int off = __shfl_sync(0xffffffffu, cur.a, b & (sk::kSeg - 1));
    const int nx = __shfl_sync(0xffffffffu, cur.a, (b + 1) & (sk::kSeg - 1));
    if (g >= n) return;
    const int c0 = off < 0 ? 0 : (off >= d.K ? d.K - 1 : off);
    int len = d.K - c0 < p.bn ? d.K - c0 : p.bn;
    if (b + 1 < p.NB && ((b + 1) & (sk::kSeg - 1)) != 0) {
      const int live = nx - c0;
      len = live < 0 ? 0 : (live < len ? live : len);
    }
    const uintptr_t lo = reinterpret_cast<uintptr_t>(d.packed);
    const uintptr_t hi = lo + (size_t)p.O * d.K * 2;
    const uintptr_t a0 = lo + ((size_t)o * d.K + c0) * 2;
    const uintptr_t g0 = a0 & ~(uintptr_t)15;
    const int nw = len > 0 ? (int)((a0 + 2 * len - g0 + 15) / 16) : 0;
    if (r == 0)
      *reinterpret_cast<int4*>(stage + g * sk::kHeader) =
          make_int4(off, c0, len, (int)(a0 & 15));
    uint8_t* db = stage + p.G * sk::kHeader + g * p.block_bytes;
    uint8_t* dw = db + sk::round16(p.bn);
    sk::copy_pieces(db,
                    reinterpret_cast<const uint8_t*>(
                        d.bitmap + (size_t)o * p.NB * p.bn + (size_t)b * p.bn),
                    p.bn / d.bw, r, per, d.bw);
    for (int i = r; i < nw; i += per) {
      const uintptr_t src = g0 + 16 * i;
      uint8_t* dst = dw + 16 * i;
      if (src >= lo && src + 16 <= hi) {
        tc::copy_piece(dst, reinterpret_cast<const uint8_t*>(src), 16);
      } else {
        for (int k = 0; k < 16; k += 2)
          if (src + k >= lo && src + k < hi)
            *reinterpret_cast<uint16_t*>(dst + k) =
                *reinterpret_cast<const uint16_t*>(src + k);
      }
    }
  }
  template <int kM>
  __device__ static void compute(const Params& d, const sk::Problem& p,
                                 const uint8_t* stage, int o, int n,
                                 const uint8_t* xs, int col0,
                                 float (&acc)[kM]) {
    const int lane = threadIdx.x % kLanes;
    const unsigned below = (1u << lane) - 1u;
    const int c = 4 * lane;                  // this lane's first column
    for (int g = 0; g < n; ++g) {
      // off, c0, len, the window's first byte
      const int4 h = *reinterpret_cast<const int4*>(stage + g * sk::kHeader);
      const uint8_t* blk = stage + p.G * sk::kHeader + g * p.block_bytes;
      const uint8_t* win = blk + sk::round16(p.bn) + h.w;
      const int cb = col0 + g * p.bn;
      const uint32_t bits =
          c < p.bn ? *reinterpret_cast<const uint32_t*>(blk + c) : 0u;
      bool set[4];
      int pos = h.x;                         // + set bits before the lane
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        set[t] = ((bits >> (8 * t)) & 0xFF) != 0;
        pos += __popc(__ballot_sync(0xffffffffu, set[t]) & below);
      }
      float v[4];
      sk::XCol<kM> xc[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[t] = 0.f;
        if (!set[t]) continue;
        const int at = pos < 0 ? 0 : (pos >= d.K ? d.K - 1 : pos);
        ++pos;
        v[t] = at >= h.y && at < h.y + h.z
                   ? __uint_as_float(
                         (uint32_t)*reinterpret_cast<const uint16_t*>(
                             win + 2 * (at - h.y))
                         << 16)
                   : __bfloat162float(d.packed[(size_t)o * d.K + at]);
        xc[t] = sk::x_column<kM>(xs, cb + c + t);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (v[t] != 0.f) sk::fma_column<kM>(xc[t], v[t], acc);
    }
  }
};

int launch_stream(const void* x, const int8_t* bitmap, const void* packed,
                  const int* offsets, float* y, int M, int O, int N, int K,
                  int bn, cudaStream_t s) {
  const BitmapStream::Params d{bitmap,
                               static_cast<const __nv_bfloat16*>(packed),
                               offsets, K, tc::piece_bytes(bitmap, bn)};
  const sk::Problem p{static_cast<const __nv_bfloat16*>(x), y, 1, M, O,
                      N / bn, bn, 0, 0, 0};
  return sk::launch<BitmapStream, false>(p, d, s);
}

int launch_tc(const void* x, const int8_t* bitmap, const void* packed,
              const int* offsets, float* y, float* ws, int splits, int M,
              int O, int N, int K, int bn, cudaStream_t s) {
  const BitmapTc::Params dp{bitmap, static_cast<const __nv_bfloat16*>(packed),
                            offsets, K, tc::piece_bytes(bitmap, bn)};
  const tc::Problem p{static_cast<const __nv_bfloat16*>(x), y, ws, 1, M, O,
                      N / bn, bn, splits, tc::piece_bytes(x, bn * 2)};
  return tc::launch<BitmapTc>(p, dp, s);
}

// float32 x: the FMA kernels.
int launch_fma(const void* x, const int8_t* bitmap, const void* packed,
               const int* offsets, float* y, int M, int O, int N, int K,
               int bn, cudaStream_t s) {
  const bool skinny = M <= kSkinnyM;
  const int bm = skinny ? kSkinnyM : kWideBM;
  const int bo = skinny ? kSkinnyBO : kWideBO;
  const int floats = (bm + bo) * (bn + 4);
  const int smem = (skinny && floats < kSkinnyThreads ? kSkinnyThreads
                                                      : floats) *
                   (int)sizeof(float);
  auto kernel = skinny ? bitmap_spmm_skinny_kernel<float>
                      : bitmap_spmm_wide_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (M == 0 || O == 0) return 0;
  const dim3 grid((O + bo - 1) / bo, skinny ? 1 : (M + bm - 1) / bm);
  kernel<<<grid, skinny ? kSkinnyThreads : kWideThreads, smem, s>>>(
      static_cast<const float*>(x), bitmap,
      static_cast<const float*>(packed), offsets, y, M, O, N, K, bn);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and packed share it).  y is f32
// [M, O].  bn a multiple of 4 in [4, 128] dividing N; K >= 1.  At bf16,
// M <= 8 takes the weight streamer and wider M the tensor-core kernel,
// split over `splits` with a workspace ws of splits x M x O floats (null
// for one split); at float32 the FMA skinny or wide kernel (splits 1).
// Returns the cudaError_t of the launch (0 on success).
int bitmap_spmm(const void* x, const int8_t* bitmap, const void* packed,
                const int* offsets, float* y, int M, int O, int N, int K,
                int bn, int dtype, float* ws, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 0 || O < 0 || N < 0 || K < 1 || bn < 4 || bn > kMaxBn ||
      bn % 4 || N % bn)
    return (int)cudaErrorInvalidValue;
  if (M > kSkinnyM && dtype == 1)
    return launch_tc(x, bitmap, packed, offsets, y, ws, splits, M, O, N, K,
                     bn, s);
  if (splits != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_stream(x, bitmap, packed, offsets, y, M, O, N, K, bn, s);
  return launch_fma(x, bitmap, packed, offsets, y, M, O, N, K, bn, s);
}

const char* bitmap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
