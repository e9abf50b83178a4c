// The tensor-core mainloop of the wide (prefill) sparse x dense kernels on
// Hopper (sm_90a), shared by the tiled balanced decoder (tiled_spmm.cuh,
// for balanced_spmm.cu and balanced_spmm_q.cu) and the bitmap decoder
// (bitmap_spmm.cu).  Only bf16 x takes it (float32 keeps the FMA kernels:
// see balanced_spmm.cu); what bounds each kernel is in those files' notes.
//
//  * swap-AB: a CTA computes a 64 (O) x TN (M) tile of y^T = W x^T with
//    wgmma.mma_async m64nTNk16, bf16 operands, f32 accumulators in
//    registers.  TN in {32, 64, 128} is picked on the host from M (M <= 32,
//    <= 64, else 128-row M tiles), so a 16-row prefill does not run a
//    128-wide tile.  256 threads: warpgroup 0 issues the products and holds
//    the accumulators; both warpgroups copy and decode.
//  * Both operands are K-major bf16 tiles in shared memory in the 128-byte
//    swizzle (atoms of 8 rows x 128 bytes, 64 columns; a block of bn
//    columns pads to a multiple of 16 with zeros and spans ceil(bn / 64)
//    atoms).  x arrives by TMA (cp.async.bulk.tensor, a 3-D tensor map made
//    on the host through the runtime's driver entry point, rows past M
//    zero-filled) when bn is a multiple of 64 and its rows are 16-byte
//    aligned, else by cp.async in 16/8/4-byte pieces written to their
//    swizzled address; the decoder stores the block's weights at theirs.
//  * Two stages of x, of decoded weight tiles and of staged encodings: in
//    iteration j warpgroup 0 issues block j's product; both warpgroups
//    decode block j+1 (its encodings copied since iteration j-2) into the
//    other tile; then x(j+2) and block j+3's encodings go out.
//    fence.proxy.async + a barrier publish the decoder's stores (and the
//    cp.async writes) to wgmma's async proxy; an mbarrier per stage reports
//    TMA's.
//  * A scaled decoder (block-quantized q) decodes q, exact in bf16, and the
//    block's product goes to a per-block accumulator (scale-d = 0 on its
//    first k-step); y += scale[o, b] * block sum, one f32 fma per output,
//    the order of ops.py's _tiled_gather_spmm.
//  * split-K: grid y holds (M tile, split); split j sums the column blocks
//    [j NB/s, (j+1) NB/s) into its partial [E, M, O] in a workspace, and a
//    second kernel adds the s partials in split order, so every run gives
//    the same bits.  The host (balanced_spmm.wide_splits) picks the largest
//    s that keeps the CTAs in one wave: a CTA's ring takes up to 200 KB of
//    shared memory, so an SM runs one, and a second wave would pay every
//    CTA's prologue again.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace tc {

constexpr int kBO = 64;                      // output rows (O) per CTA
constexpr int kMmaThreads = 128;             // warpgroup 0 runs the product
constexpr int kThreads = 256;                // both warpgroups decode
constexpr int kRowsPerWarp = kBO / (kThreads / 32);
constexpr int kAtomCols = 64;                // bf16 columns of a swizzle row
constexpr int kMaxSplits = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (row, k) in a K-major 128-byte-swizzled tile of
// `rows` rows: atoms of 64 columns one after the other, each `rows` x 128
// bytes, the 16-byte chunk c of row r stored at chunk c ^ (r % 8).
__device__ __forceinline__ int swizzled(int row, int k, int rows) {
  const int byte = (k % kAtomCols) * 2;
  return (k / kAtomCols) * rows * 128 + row * 128 +
         (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15);
}

// The wgmma descriptor of a K-major 128-byte-swizzled operand at `addr`
// (shared; its atom 1024-byte aligned): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Copy one piece of w bytes global -> shared: cp.async for 16, 8 and 4
// bytes, a plain load and store below (the piece sizes an odd-width or
// misaligned array allows).
__device__ __forceinline__ void copy_piece(uint8_t* dst, const uint8_t* src,
                                           int w) {
  const uint32_t d = smem_u32(dst);
  switch (w) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
      break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
      break;
    default:
      *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy kBO row runs of `nbytes` (a multiple of w) each, row r from src(r)
// (nullptr: the row is past O, skipped) to dst + r * pitch; a team of
// kThreads / kBO threads per row.
template <int W>
__device__ __forceinline__ void copy_run(uint8_t* dst, const uint8_t* src,
                                         int pieces, int first, int step) {
  for (int i = first; i < pieces; i += step)
    copy_piece(dst + i * W, src + i * W, W);
}

template <typename Src>
__device__ __forceinline__ void copy_rows(uint8_t* dst, int pitch, int nbytes,
                                          int w, Src src) {
  constexpr int kTeam = kThreads / kBO;
  const int r = threadIdx.x / kTeam;
  const uint8_t* s = src(r);
  if (s == nullptr) return;
  dst += r * pitch;
  const int t = threadIdx.x % kTeam;
  switch (w) {
    case 16: copy_run<16>(dst, s, nbytes / 16, t, kTeam); break;
    case 8: copy_run<8>(dst, s, nbytes / 8, t, kTeam); break;
    case 4: copy_run<4>(dst, s, nbytes / 4, t, kTeam); break;
    case 2: copy_run<2>(dst, s, nbytes / 2, t, kTeam); break;
    default: copy_run<1>(dst, s, nbytes, t, kTeam);
  }
}

__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// mbarriers and TMA, for x's tiles.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}
// One box of the 3-D tensor map (innermost coordinate first) -> dst,
// reported to bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// D[64 x TN] (+)= A[64 x 16] B[16 x TN]; A and B K-major in shared memory;
// scale_d = 0 overwrites D.
template <int TN>
__device__ void wgmma(float (&d)[TN / 2], uint64_t a, uint64_t b,
                      int scale_d);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The problem a launch solves: y[e] = x[e] @ decode(W[e])^T for the E
// experts (E = 1 for the 2-D entries); y (or, split, the workspace) f32.
struct Problem {
  const __nv_bfloat16* x;                    // [E, M, NB * bn]
  float* y;                                  // [E, M, O]
  float* ws;                                 // [splits, E, M, O] or null
  int E, M, O, NB, bn, splits;
  int xw;                                    // x piece bytes: 16, 8, 4, 2
  int tma;                                   // x by TMA (xmap) or cp.async
};

// x[e, m0 .. m0 + TN, block b] -> its swizzled tile, a team of
// kThreads / TN threads per row; rows past M are left as they are (zeroed
// once at the start).
template <int TN, int W>
__device__ __forceinline__ void load_x_rows(const Problem& p,
                                            const uint8_t* src, uint8_t* xs,
                                            int m) {
  constexpr int kTeam = kThreads / TN;
  const int pieces = p.bn * 2 / W;
  for (int i = threadIdx.x % kTeam; i < pieces; i += kTeam)
    copy_piece(xs + swizzled(m, i * W / 2, TN), src + i * W, W);
}

template <int TN>
__device__ __forceinline__ void load_x(const Problem& p,
                                       const __nv_bfloat16* x, uint8_t* xs,
                                       int m0, int b) {
  const int m = threadIdx.x / (kThreads / TN);
  if (m0 + m >= p.M) return;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(
      x + (size_t)(m0 + m) * p.NB * p.bn + (size_t)b * p.bn);
  switch (p.xw) {
    case 16: load_x_rows<TN, 16>(p, src, xs, m); break;
    case 8: load_x_rows<TN, 8>(p, src, xs, m); break;
    case 4: load_x_rows<TN, 4>(p, src, xs, m); break;
    default: load_x_rows<TN, 2>(p, src, xs, m);
  }
}

// The mainloop.  D (the decoder) gives: Params (its arrays, offset to
// expert e by at_expert); raw_bytes (one stage of staged encodings, a
// multiple of 16); Prefetch (registers a decoder carries from one load to
// the next); load (issue the copies of block b's encodings of rows
// o0 .. o0 + 64; called by every thread, in block order); decode (staged
// encodings -> the swizzled bf16 [64, bn] tile, every element of rows < O
// and columns < bn written or zeroed); kScaled and scale (the block's
// per-row scale from the staged encodings).
//
// Block j's x and block j+1's encodings are copied in the group committed
// at the end of iteration j-2: iteration j waits for it, then warpgroup 0
// issues block j's product, both warpgroups decode block j+1 into the other
// tile, warpgroup 0 waits for the product (and folds a scaled block in),
// and the copies of x(j+2) and the encodings of block j+3 go out.
template <class D, int TN>
__global__ void __launch_bounds__(kThreads, 1)
tc_spmm_kernel(const __grid_constant__ Problem p,
               const __grid_constant__ typename D::Params dp0,
               const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int kpad = (p.bn + 15) / 16 * 16;
  const int atoms = (kpad + kAtomCols - 1) / kAtomCols;
  const int ksteps = kpad / 16;
  const int xs_bytes = atoms * TN * 128;
  const int wt_bytes = atoms * kBO * 128;
  const int raw_bytes = D::raw_bytes(dp0, p.bn);
  uint8_t* xs[2] = {sm, sm + xs_bytes};
  uint8_t* wt[2] = {sm + 2 * xs_bytes, sm + 2 * xs_bytes + wt_bytes};
  uint8_t* raw[2] = {wt[1] + wt_bytes, wt[1] + wt_bytes + raw_bytes};
  uint64_t* bar = reinterpret_cast<uint64_t*>(raw[1] + raw_bytes);

  const int mtiles = (p.M + TN - 1) / TN;
  const int o0 = blockIdx.x * kBO;
  const int m0 = (blockIdx.y % mtiles) * TN;
  const int split = blockIdx.y / mtiles;
  const int nblk = p.NB / p.splits;
  const int b0 = split * nblk;
  const int e = blockIdx.z;
  const __nv_bfloat16* x = p.x + (size_t)e * p.M * ((size_t)p.NB * p.bn);
  const typename D::Params dp = D::at_expert(dp0, p, e);
  const bool mma = threadIdx.x < kMmaThreads;  // warpgroup 0
  const int warp = (threadIdx.x % kMmaThreads) / 32;
  const int lane = threadIdx.x % 32;
  const int frag_row = warp * 16 + lane / 4;   // and frag_row + 8

  // zero both stages' tiles: x rows past M and the pad columns past bn
  // are never written again
  {
    uint4* z = reinterpret_cast<uint4*>(sm);
    for (int i = threadIdx.x; i < (xs_bytes + wt_bytes) * 2 / 16;
         i += kThreads)
      z[i] = make_uint4(0, 0, 0, 0);
  }
  if (p.tma && threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_proxy();                       // the zeroes before TMA's writes
  __syncthreads();
  // x(b) -> stage st: one TMA box per swizzle atom, or cp.async pieces
  auto load_x_stage = [&](int st, int b) {
    if (!p.tma) {
      load_x<TN>(p, x, xs[st], m0, b);
    } else if (threadIdx.x == 0) {
      mbar_expect(&bar[st], xs_bytes);
      for (int a = 0; a < atoms; ++a)
        tma_load(xs[st] + a * TN * 128, &xmap, &bar[st],
                 b * p.bn + a * kAtomCols, m0, e);
    }
  };

  float acc[TN / 2];
  float blk[D::kScaled ? TN / 2 : 1];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (D::kScaled ? TN / 2 : 1); ++i) blk[i] = 0.f;
  float sc0 = 1.f, sc1 = 1.f, nsc0 = 1.f, nsc1 = 1.f;
  typename D::Prefetch pre;

  // prologue: block 0's encodings, then x(0) and block 1's encodings
  // while block 0 decodes; then x(1) and block 2's encodings
  if (nblk > 0) D::load(dp, p, raw[0], o0, b0, pre);
  cp_async_commit();
  if (nblk > 0) load_x_stage(0, b0);
  if (nblk > 1) D::load(dp, p, raw[1], o0, b0 + 1, pre);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  if (nblk > 0) {
    D::decode(dp, p, raw[0], wt[0], o0);
    if constexpr (D::kScaled) {
      sc0 = D::scale(dp, raw[0], frag_row);
      sc1 = D::scale(dp, raw[0], frag_row + 8);
    }
  }
  __syncthreads();
  if (nblk > 1) load_x_stage(1, b0 + 1);
  if (nblk > 2) D::load(dp, p, raw[0], o0, b0 + 2, pre);
  cp_async_commit();

  for (int j = 0; j < nblk; ++j) {
    const int s = j & 1;
    cp_async_wait<1>();                      // x(j), encodings of j+1
    fence_async_proxy();                     // decoded and copied tiles
    __syncthreads();                         // -> visible to wgmma
    if (mma && p.tma) mbar_wait(&bar[s], (j >> 1) & 1);   // x(j)
    if (mma) {
      const uint32_t wa = smem_u32(wt[s]);
      const uint32_t xa = smem_u32(xs[s]);
      if constexpr (D::kScaled) fence_regs(blk); else fence_regs(acc);
      wgmma_fence();
      for (int kk = 0; kk < ksteps; ++kk) {
        const uint64_t da =
            descriptor(wa + (kk / 4) * kBO * 128 + (kk % 4) * 32);
        const uint64_t db =
            descriptor(xa + (kk / 4) * TN * 128 + (kk % 4) * 32);
        if constexpr (D::kScaled)
          wgmma<TN>(blk, da, db, kk > 0);  // the block's own sum
        else
          wgmma<TN>(acc, da, db, 1);
      }
      wgmma_commit();
    }
    if (j + 1 < nblk) {                      // decode block j+1 meanwhile
      uint8_t* next = raw[(j + 1) & 1];
      D::decode(dp, p, next, wt[s ^ 1], o0);
      if constexpr (D::kScaled) {
        nsc0 = D::scale(dp, next, frag_row);
        nsc1 = D::scale(dp, next, frag_row + 8);
      }
    }
    if (mma) {
      wgmma_wait();
      if constexpr (D::kScaled) {
        fence_regs(blk);
#pragma unroll
        for (int i = 0; i < TN / 2; ++i)
          acc[i] = fmaf((i & 2) ? sc1 : sc0, blk[i], acc[i]);
        sc0 = nsc0;
        sc1 = nsc1;
      } else {
        fence_regs(acc);
      }
    }
    __syncthreads();                         // x(j), the decoded j+1 free
    if (j + 2 < nblk) load_x_stage(s, b0 + j + 2);
    if (j + 3 < nblk) D::load(dp, p, raw[(j + 1) & 1], o0, b0 + j + 3, pre);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // acc[i] holds y^T[o0 + row][m0 + col]
  if (!mma) return;
  const size_t slab = (size_t)p.E * p.M * p.O;
  float* out = (p.splits > 1 ? p.ws + split * slab : p.y) +
               (size_t)e * p.M * p.O;
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) {
    const int o = o0 + frag_row + 8 * ((i >> 1) & 1);
    const int m = m0 + 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    if (o < p.O && m < p.M) out[(size_t)m * p.O + o] = acc[i];
  }
}

// y[i] = sum of the splits' partials, in split order.
__global__ void reduce_splits(const float* __restrict__ ws,
                              float* __restrict__ y, size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = ws[i];
    for (int j = 1; j < splits; ++j) sum += ws[j * n + i];
    y[i] = sum;
  }
}

// Largest piece of {16, 8, 4, 2, 1} bytes that divides both a row run's
// byte count and its array's address (so every run's pieces are aligned).
inline int piece_bytes(const void* ptr, size_t run) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  for (int w = 16; w > 1; w /= 2)
    if (run % w == 0 && a % w == 0) return w;
  return 1;
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// -lcuda link); null when the driver does not give it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// x [E, M, N] bf16 as a 3-D tensor map of boxes [1, TN, 64] in the
// 128-byte swizzle, rows past M read as zeros.  TMA takes x when the
// blocks span whole swizzle atoms (bn a multiple of 64) and the rows are
// 16-byte aligned; false (cp.async takes it) otherwise.
inline bool x_map(CUtensorMap* map, const Problem& p, int tn) {
  const size_t n = (size_t)p.NB * p.bn;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || p.bn % kAtomCols || n % 8 ||
      reinterpret_cast<uintptr_t>(p.x) % 16)
    return false;
  const cuuint64_t dims[3] = {n, (cuuint64_t)p.M, (cuuint64_t)p.E};
  const cuuint64_t strides[2] = {n * 2, (cuuint64_t)p.M * n * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kAtomCols, (cuuint32_t)tn, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<__nv_bfloat16*>(p.x), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class D, int TN>
int launch_tn(Problem p, const typename D::Params& dp, cudaStream_t s) {
  const int kpad = (p.bn + 15) / 16 * 16;
  const int atoms = (kpad + kAtomCols - 1) / kAtomCols;
  const int smem = 1024 + 2 * atoms * 128 * (TN + kBO) +
                   2 * D::raw_bytes(dp, p.bn) + 16;
  CUtensorMap map{};
  p.tma = x_map(&map, p, TN);
  auto kernel = tc_spmm_kernel<D, TN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.O + kBO - 1) / kBO, (p.M + TN - 1) / TN * p.splits,
                  p.E);
  kernel<<<grid, kThreads, smem, s>>>(p, dp, map);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return (int)err;
  const size_t n = (size_t)p.E * p.M * p.O;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  reduce_splits<<<blocks, 256, 0, s>>>(p.ws, p.y, n, p.splits);
  return (int)cudaGetLastError();
}

// The token tile the host picks for M (balanced_spmm.token_tile mirrors
// it), then the launch.  bn a multiple of 4 in [4, 128]; splits divides NB
// (a workspace of splits x E x M x O floats when splits > 1).
template <class D>
int launch(const Problem& p, const typename D::Params& dp, cudaStream_t s) {
  if (p.bn < 4 || p.bn > 128 || p.bn % 4 || p.E < 0 || p.E > 65535 ||
      p.splits < 1 || p.splits > kMaxSplits || p.NB < 0 ||
      (p.NB > 0 && p.NB % p.splits) || (p.splits > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (p.M == 0 || p.O == 0 || p.E == 0) return 0;
  if (p.M <= 32) return launch_tn<D, 32>(p, dp, s);
  if (p.M <= 64) return launch_tn<D, 64>(p, dp, s);
  return launch_tn<D, 128>(p, dp, s);
}

}  // namespace tc
