// The decode (M <= 8) mainloop of the sparse x dense kernels on Hopper
// (sm_90a) for bf16 x: a weight streamer, shared by the tiled balanced
// decoder (tiled_spmm.cuh's BalancedStream, for balanced_spmm.cu and
// balanced_spmm_q.cu) and the bitmap decoder (bitmap_spmm.cu's
// BitmapStream).  float32 x keeps the FMA skinny templates; what bounds
// each kernel is in those files' notes.
//
//  * x resident: a CTA copies x [M, N] (the expert's, batched) once into
//    shared memory, kM = 4 (M <= 4) or 8 bf16 rows a column, rows past M
//    zero, so one 8- or 16-byte load returns every row's value at a
//    column; the low bits of a column's place are XORed with the next
//    ones, so the nearby columns a warp gathers fall in distinct bank
//    groups.  When N does not fit beside the rings (past about 13K columns)
//    x goes in column ranges of a multiple of 32 blocks, sized for kM = 8
//    whatever M is (balanced_spmm.stream_x_ranges mirrors the choice); a
//    row's sum is then range 0's, plus range 1's, ... in that order, added
//    into y by the warp that owns it.
//  * Weight stream: each warp owns whole rows (row o = the warp's global
//    number + k x the warps of the grid, per expert) and walks its items,
//    groups of G column blocks of a row, in range, row, block order,
//    through a private ring of kStages stages in shared memory.  A staged
//    block is the block's live part (the decoders say which bytes) behind
//    a 16-byte header, copied by 32 / G lanes with 16-byte cp.async pieces
//    where the arrays allow (narrower where a run or a base is not 16-byte
//    aligned; never past a tensor's end).  The warp issues item t +
//    kStages - 1, then waits for item t (cp.async.wait_group) and computes
//    it; no CTA-wide barrier sits in the loop (only at a range change).
//    What a copy needs to know about its block (the tiled live count and
//    scale, the bitmap offset) comes from registers: a lane holds block
//    (32 s + lane)'s of the current 32-block segment, and the next
//    segment's load is issued a segment ahead.  The launch picks G in
//    {8, 4, 2, 1} for the most stored bytes in flight per SM (up to 128
//    KB), then the most CTAs per SM (up to 2: a thread may use 128
//    registers).  At olmo-1b's N = 2048 and KB = 88 that is G = 4 and two
//    CTAs, 66 KB of stored slots in flight per SM; at N = 8192 (x alone is
//    128 KB), G = 4 and one CTA, 33 KB.  (Three stages and 8-row expert
//    slices measured a few percent faster than four and 16.)
//  * Gather-dot: the lanes take a block's slots in order (U = ceil(count /
//    32) a lane); per slot the decoder reads its column and value, one
//    shared-memory load gives the kM rows' x, kM f32 FMAs go into per-lane
//    accumulators.  At a row's end the lanes' sums are reduced by an xor
//    butterfly (every lane gets the same bits: f32 addition commutes) and
//    lane m writes y[m, o].  Each output's summation order depends only on
//    the encoding (and N's ranges), never on M, G, the grid or the timing:
//    two calls give the same bits and y[:3] of an M = 8 call is y of an
//    M = 3 call on x[:3].
//  * Batched (expert grid y): the CTA ORs the x it stages; when the
//    expert's x is all zero (+-0) it writes its rows of y as +0.0 and
//    issues no copy.  With finite weights that is exactly the plain
//    version's sum; a NaN or Inf weight in an empty expert would give NaN
//    there and 0 here.  A CTA takes 8 x 8 rows of one expert, so an empty
//    expert's CTAs leave at once and the block scheduler fills their place.
//  What bounds it: instruction issue, not bytes.  A staged block costs its
//  warp the slots' loads, 8 bf16 unpacks and 8 FMAs per slot at kM = 8,
//  the copies and the walk, and builds of this file with
//  the slot work or the copies taken out showed the copies and the walk
//  alone already above the byte bound, the slot work adding the rest (most
//  on the expert grid, where it does not hide behind the stream).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "tc_spmm.cuh"

namespace sk {

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kLanes;
constexpr int kStages = 3;                   // ring stages per warp
constexpr int kMaxGroup = 8;                 // column blocks per item
constexpr int kHeader = 16;                  // a block's header bytes
constexpr int kMaxM = 8;
constexpr int kSeg = 32;                     // blocks a lane-set of meta holds
constexpr int kSmemLimit = 232448;           // 227 KB a CTA may have
constexpr int kSmemPerSm = 233472;           // 228 KB an SM has
constexpr int kSmemReserved = 1024;          // the runtime's share per CTA
constexpr int kBatchedRowsPerWarp = 8;
constexpr int kMaxCtas = 2;                  // CTAs an SM may hold
constexpr int kInFlight = 128 * 1024;        // stored bytes in flight per SM

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// What a launch solves: y[e] = x[e] @ decode(W[e])^T (E = 1 for 2-D).
struct Problem {
  const __nv_bfloat16* x;                    // [E, M, NB * bn]
  float* y;                                  // [E, M, O]
  int E, M, O, NB, bn;
  int RB;                                    // blocks of x resident at once
  int G;                                     // column blocks per item
  int block_bytes;                           // a block's staged bytes
  int xvec;                                  // x by 8-byte loads
};

// Two 32-bit words of per-(row, block) metadata a lane holds.
struct Meta {
  int a;
  int f;
};

// Pieces first, first + step, ... < n of w bytes each, src -> dst.
__device__ __forceinline__ void copy_pieces(uint8_t* dst, const uint8_t* src,
                                            int n, int first, int step,
                                            int w) {
  switch (w) {
    case 16: tc::copy_run<16>(dst, src, n, first, step); break;
    case 8: tc::copy_run<8>(dst, src, n, first, step); break;
    case 4: tc::copy_run<4>(dst, src, n, first, step); break;
    case 2: tc::copy_run<2>(dst, src, n, first, step); break;
    default: tc::copy_run<1>(dst, src, n, first, step);
  }
}

// Where column `col` of the resident x sits (in columns of kM bf16): the
// low bits of the column are XORed with the next ones, so the nearby
// columns that a warp's lanes gather (a block's live columns in slot order
// are ascending) fall in distinct bank groups.
template <int kM>
__device__ __forceinline__ int xpos(int col) {
  constexpr int kL = kM == 8 ? 3 : 4;       // 16- or 8-byte columns
  return col ^ ((col >> kL) & ((1 << kL) - 1));
}

// x[:, c0 .. c0 + ncols) -> xs (bf16, column c at xpos(c), rows past M
// zero); returns the OR of the staged bits without the sign (nonzero: some
// x is not +-0).
template <int kM>
__device__ __forceinline__ uint32_t load_x(const __nv_bfloat16* x, int M,
                                           int N, int c0, int ncols,
                                           uint8_t* xs, bool vec) {
  uint32_t nz = 0;
  if (vec) {
    // 4 columns a thread: an 8-byte load per row, transposed in registers
    for (int g = threadIdx.x; g < ncols / 4; g += kThreads) {
      uint2 r[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        r[m] = m < M ? *reinterpret_cast<const uint2*>(
                           x + (size_t)m * N + c0 + 4 * g)
                     : make_uint2(0u, 0u);
        nz |= (r[m].x | r[m].y) & 0x7FFF7FFFu;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t w[kM / 2];
#pragma unroll
        for (int i = 0; i < kM / 2; ++i) {
          const uint32_t a = j < 2 ? r[2 * i].x : r[2 * i].y;
          const uint32_t b = j < 2 ? r[2 * i + 1].x : r[2 * i + 1].y;
          w[i] = __byte_perm(a, b, (j & 1) ? 0x7632 : 0x5410);
        }
        uint8_t* dst = xs + (size_t)xpos<kM>(4 * g + j) * kM * 2;
        if constexpr (kM == 8)
          *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      }
    }
  } else {
    const uint16_t* xr = reinterpret_cast<const uint16_t*>(x);
    uint16_t* xd = reinterpret_cast<uint16_t*>(xs);
    for (int i = threadIdx.x; i < ncols * kM; i += kThreads) {
      const int c = i / kM;
      const int m = i - c * kM;
      const uint16_t v = m < M ? xr[(size_t)m * N + c0 + c] : (uint16_t)0;
      nz |= v & 0x7FFFu;
      xd[xpos<kM>(c) * kM + m] = v;
    }
  }
  return nz;
}

// The OR of x[:, c0 ..) without staging it (the columns past range 0).
__device__ __forceinline__ uint32_t x_bits_from(const __nv_bfloat16* x,
                                                int M, int N, int c0) {
  const uint16_t* xr = reinterpret_cast<const uint16_t*>(x);
  uint32_t nz = 0;
  const int cols = N - c0;
  for (int i = threadIdx.x; i < M * cols; i += kThreads)
    nz |= xr[(size_t)(i / cols) * N + c0 + i % cols] & 0x7FFFu;
  return nz;
}

// The kM rows of x at column `col` of the resident range, as bf16 pairs.
template <int kM>
struct XCol {
  uint32_t w[kM / 2];
};
template <int kM>
__device__ __forceinline__ XCol<kM> x_column(const uint8_t* xs, int col) {
  const uint8_t* xcol = xs + xpos<kM>(col) * kM * 2;
  XCol<kM> c;
  if constexpr (kM == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(xcol);
    c.w[0] = u.x; c.w[1] = u.y; c.w[2] = u.z; c.w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(xcol);
    c.w[0] = u.x; c.w[1] = u.y;
  }
  return c;
}
// acc[m] += x[m] * v, in f32 (a bf16 is the top half of its f32).
template <int kM>
__device__ __forceinline__ void fma_column(const XCol<kM>& c, float v,
                                           float (&acc)[kM]) {
#pragma unroll
  for (int i = 0; i < kM / 2; ++i) {
    acc[2 * i] = fmaf(__uint_as_float(c.w[i] << 16), v, acc[2 * i]);
    acc[2 * i + 1] = fmaf(__uint_as_float(c.w[i] & 0xFFFF0000u), v,
                          acc[2 * i + 1]);
  }
}

// The rows a warp owns and the walk over its items: (range, row, group of
// G blocks) in that order; a group never crosses a range or a 32-block
// segment (ranges start at multiples of 32 blocks, G divides 32).
struct Walk {
  int first, stride, nrows;                  // rows first + k * stride
  int NB, RB, nranges, G;
  __device__ int row(int k) const { return first + k * stride; }
  __device__ int range_end(int q) const {
    return (q + 1) * RB < NB ? (q + 1) * RB : NB;
  }
  // the segment after the one at (q, k, b0) in walk order; false at the end
  __device__ bool next_seg(int& q, int& k, int& b0) const {
    if (b0 + kSeg < range_end(q)) {
      b0 += kSeg;
      return true;
    }
    if (k + 1 < nrows) {
      ++k;
      b0 = q * RB;
      return true;
    }
    if (q + 1 < nranges) {
      ++q;
      k = 0;
      b0 = q * RB;
      return true;
    }
    return false;
  }
};

// The issue cursor: the next item to copy and the metadata of its segment
// (cur) and of the segment after it (nxt, in flight).
template <typename D>
struct Issuer {
  int q, k, b;
  bool done;
  Meta cur, nxt;

  __device__ Meta load_seg(const typename D::Params& d, const Problem& p,
                           const Walk& w, int q_, int k_, int b0) const {
    const int bb = b0 + (int)(threadIdx.x % kLanes);
    return bb < w.range_end(q_) ? D::load_meta(d, p, w.row(k_), bb)
                                : Meta{0, 0};
  }
  __device__ void prefetch(const typename D::Params& d, const Problem& p,
                           const Walk& w) {
    int q_ = q, k_ = k, b0 = b;
    nxt = w.next_seg(q_, k_, b0) ? load_seg(d, p, w, q_, k_, b0)
                                 : Meta{0, 0};
  }
  __device__ void init(const typename D::Params& d, const Problem& p,
                       const Walk& w) {
    q = 0;
    k = 0;
    b = 0;
    done = w.nrows == 0;
    if (done) return;
    cur = load_seg(d, p, w, 0, 0, 0);
    prefetch(d, p, w);
  }
  // Copy the next item into `stage` (nothing past the end), commit one
  // cp.async group either way, and advance.
  __device__ void issue(const typename D::Params& d, const Problem& p,
                        const Walk& w, uint8_t* stage) {
    if (!done) {
      const int end = w.range_end(q);
      const int n = end - b < w.G ? end - b : w.G;
      D::issue(d, p, stage, w.row(k), b, n, cur);
      b += n;
      bool seg = (b & (kSeg - 1)) == 0;
      if (b == end) {
        seg = true;
        b = q * w.RB;
        if (++k == w.nrows) {
          k = 0;
          b = ++q * w.RB;
          done = q == w.nranges;
        }
      }
      if (seg && !done) {
        cur = nxt;
        prefetch(d, p, w);
      }
    }
    tc::cp_async_commit();
  }
};

// D, the decoder: Params (its arrays; at_expert offsets them to expert e),
// block_bytes (one staged block, past its kHeader-byte header), load_meta
// (one (row, block)'s Meta, read from device memory), issue (warp-wide:
// copy a group of n <= G blocks of a row, live part only, into a stage:
// G headers, then G blocks; 32 / G lanes a block) and compute (warp-wide:
// a staged group's products into the lanes' accumulators, block by block,
// the group's first column at column col0 of the resident x).
template <typename D, int kM, bool kBatched>
__global__ void __launch_bounds__(kThreads, kMaxCtas)
skinny_stream_kernel(const Problem p, typename D::Params d) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int e = kBatched ? blockIdx.y : 0;
  const int N = p.NB * p.bn;
  const __nv_bfloat16* x = p.x + (size_t)e * p.M * N;
  float* y = p.y + (size_t)e * p.M * p.O;
  d = D::at_expert(d, p, e);

  Walk w;
  w.first = blockIdx.x * kWarps + warp;
  w.stride = gridDim.x * kWarps;
  w.nrows = w.first < p.O ? (p.O - w.first + w.stride - 1) / w.stride : 0;
  w.NB = p.NB;
  w.RB = p.RB;
  w.nranges = (p.NB + p.RB - 1) / p.RB;
  w.G = p.G;

  const int stage_bytes = p.G * (kHeader + p.block_bytes);
  uint8_t* xs = smem;
  uint8_t* ring = smem + round16(p.RB * p.bn * kM * 2) +
                  (size_t)warp * kStages * stage_bytes;
  Issuer<D> is;
  is.init(d, p, w);
  auto prologue = [&]() {
    for (int s = 0; s < kStages - 1; ++s)
      is.issue(d, p, w, ring + s * stage_bytes);
  };
  if (!kBatched) prologue();

  int slot = 0;                              // the ring stage of the item
  float acc[kM];
  for (int q = 0; q < w.nranges; ++q) {
    const int b0 = q * p.RB;
    const int b1 = w.range_end(q);
    if (q > 0) __syncthreads();              // every warp is done with xs
    uint32_t nz = load_x<kM>(x, p.M, N, b0 * p.bn, (b1 - b0) * p.bn, xs,
                             p.xvec);
    if (kBatched && q == 0) {
      if (w.nranges > 1) nz |= x_bits_from(x, p.M, N, b1 * p.bn);
      if (!__syncthreads_or(nz != 0)) {
        // an empty expert: y = +0, no weight read
        for (int k = 0; k < w.nrows; ++k)
          if (lane < p.M) y[(size_t)lane * p.O + w.row(k)] = 0.f;
        return;
      }
      prologue();
    } else {
      __syncthreads();
    }
    for (int k = 0; k < w.nrows; ++k) {
#pragma unroll
      for (int m = 0; m < kM; ++m) acc[m] = 0.f;
      for (int b = b0; b < b1; b += p.G) {
        is.issue(d, p, w,
                 ring + ((slot + kStages - 1) % kStages) * stage_bytes);
        tc::cp_async_wait<kStages - 1>();
        __syncwarp();
        D::template compute<kM>(d, p, ring + slot * stage_bytes,
                                w.row(k), b1 - b < p.G ? b1 - b : p.G, xs,
                                (b - b0) * p.bn, acc);
        __syncwarp();                        // the stage may be refilled
        slot = slot + 1 == kStages ? 0 : slot + 1;
      }
#pragma unroll
      for (int m = 0; m < kM; ++m)
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], s);
      float mine = 0.f;
#pragma unroll
      for (int m = 0; m < kM; ++m)
        if (lane == m) mine = acc[m];
      if (lane < p.M) {
        float* dst = y + (size_t)lane * p.O + w.row(k);
        *dst = q == 0 ? mine : *dst + mine;
      }
    }
  }
  tc::cp_async_wait<0>();
}

// The launch.  x ranges: a function of the encoding alone (N, bn and the
// staged block's bytes, x sized at 8 rows), so every M sums in the same
// order.  G: of 8, 4, 2, 1, the one whose rings keep the most stored
// bytes in flight per SM (up to kInFlight), then the one that lets more
// CTAs share an SM (up to kMaxCtas).  Grid: 2-D, as many CTAs as fit on
// the card at once (rows strided over their warps); batched,
// (ceil(O / (8 x 8)), E), a warp about 8 rows of its expert, so the CTAs
// of an empty expert leave early and the block scheduler fills their place.
template <typename D, bool kBatched>
int launch(Problem p, const typename D::Params& d, cudaStream_t s) {
  if (p.M < 0 || p.M > kMaxM || p.E < 0 || p.O < 0 || p.NB < 0 ||
      p.bn < 4 || p.bn % 4)
    return (int)cudaErrorInvalidValue;
  p.block_bytes = D::block_bytes(d, p.bn);
  auto ring = [&](int g) {
    return kWarps * kStages * g * (kHeader + p.block_bytes);
  };
  const int col_bytes = p.bn * kMaxM * 2;    // one block of x at 8 rows
  const int xs_cap = kSmemLimit - ring(1);
  if ((long long)p.NB * col_bytes <= xs_cap) {
    p.RB = p.NB > 0 ? p.NB : 1;
  } else {
    p.RB = xs_cap / col_bytes / kSeg * kSeg;
    if (p.RB < kSeg) return (int)cudaErrorInvalidValue;
  }
  p.xvec = reinterpret_cast<uintptr_t>(p.x) % 8 == 0;
  const int km = p.M <= 4 ? 4 : 8;
  const int xs = round16(p.RB * p.bn * km * 2);
  p.G = 1;
  long long best = -1;
  for (int g = kMaxGroup; g >= 1; g /= 2) {
    if (xs + ring(g) > kSmemLimit) continue;
    int ctas = kSmemPerSm / (xs + ring(g) + kSmemReserved);
    ctas = ctas < kMaxCtas ? ctas : kMaxCtas;
    long long flight = (long long)ctas * kWarps * (kStages - 1) * g *
                       p.block_bytes;
    flight = flight < kInFlight ? flight : kInFlight;
    const long long score = flight * 4 + ctas;
    if (score > best) {
      best = score;
      p.G = g;
    }
  }
  const int smem = xs + ring(p.G);
  auto kernel = km == 4 ? &skinny_stream_kernel<D, 4, kBatched>
                        : &skinny_stream_kernel<D, 8, kBatched>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (p.M == 0 || p.O == 0 || p.E == 0) return 0;
  if (p.NB == 0)                             // an empty product: y = 0
    return (int)cudaMemsetAsync(p.y, 0, sizeof(float) * p.E * p.M * p.O, s);
  dim3 grid;
  if (kBatched) {
    grid = dim3((p.O + kWarps * kBatchedRowsPerWarp - 1) /
                    (kWarps * kBatchedRowsPerWarp),
                p.E);
  } else {
    int dev = 0, sms = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kernel, kThreads, smem)) != cudaSuccess)
      return (int)err;
    const int tiles = (p.O + kWarps - 1) / kWarps;
    const int fit = (occ > 0 ? occ : 1) * sms;
    grid = dim3(tiles < fit ? tiles : fit);
  }
  kernel<<<grid, kThreads, smem, s>>>(p, d);
  return (int)cudaGetLastError();
}

}  // namespace sk
