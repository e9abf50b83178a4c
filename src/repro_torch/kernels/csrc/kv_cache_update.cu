// In-place KV-cache row write on the plane layout, for NVIDIA Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/_build.py; the wrappers live in
// src/repro_torch/kernels/kv_cache_update.py.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/kv_cache_update.py:
//   kv_write_rows <- kv_cache_update_pallas (_kernel): cache[p, pos[p]] =
//                    new[p] for every plane p, in place (C = 1), and its
//                    multi-row form kv_cache_write_chunk (C >= 1), which the
//                    reference's model calls: cache[p, pos[p] + i] =
//                    new[p, i] for i < C.
//
// cache [P, S, row] and new [P, C, row] share one dtype (f32, bf16 or f16:
// the wrapper casts new), so a row is `row_bytes` of raw data and the kernel
// copies bytes; pos [P] is int32 or int64 and is read on the device, so the
// caller never syncs to learn where the rows go.  Rows with pos[p] + i
// outside [0, S) are dropped, as the reference's .at[].set drops an
// out-of-range update.
//
// What bounds it on an H100: the bytes of the new rows, read once and
// written once (P x C x row_bytes each way: 32 KB at P = 64, C = 1, dh = 128
// bf16), far under what one launch costs (a few microseconds), so the
// launch latency is the bound in practice.  The kernel exists for what it
// does not touch: the mask-select rewrite it replaces reads and writes the
// whole P x S x row cache (64 MB per leaf at S = 4096).
//
// Design: grid (P, C), one CTA per written row; its threads copy the row in
// 16-byte words when the row and both base pointers allow it (dh = 128 in
// bf16 is 16 words), else in 2-byte words (every supported dtype is a
// multiple of 2 bytes).  No shared memory, no synchronisation: the rows of
// one call are distinct (one plane per p, consecutive rows per i).
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxGridY = 65535;

template <typename Word, typename Pos>
__global__ void __launch_bounds__(kThreads)
kv_write_rows_kernel(Word* __restrict__ cache, const Word* __restrict__ rows,
                     const Pos* __restrict__ pos, int S, int C, int words) {
  const int p = blockIdx.x;
  const int i = blockIdx.y;
  const long long r = (long long)pos[p] + i;
  if (r < 0 || r >= S) return;
  Word* dst = cache + ((size_t)p * S + (size_t)r) * words;
  const Word* src = rows + ((size_t)p * C + i) * words;
  for (int w = threadIdx.x; w < words; w += kThreads) dst[w] = src[w];
}

template <typename Word>
int launch(void* cache, const void* rows, const void* pos, int P, int S,
           int C, int words, int pos64, cudaStream_t s) {
  const dim3 grid(P, C);
  if (pos64)
    kv_write_rows_kernel<Word, int64_t><<<grid, kThreads, 0, s>>>(
        static_cast<Word*>(cache), static_cast<const Word*>(rows),
        static_cast<const int64_t*>(pos), S, C, words);
  else
    kv_write_rows_kernel<Word, int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<Word*>(cache), static_cast<const Word*>(rows),
        static_cast<const int32_t*>(pos), S, C, words);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cache [P, S, row_bytes], new [P, C, row_bytes] (one dtype), pos [P]
// (int64 when pos64, else int32).  Returns the cudaError_t of the launch
// (0 on success).
int kv_write_rows(void* cache, const void* rows, const void* pos, int P,
                  int S, int C, int row_bytes, int pos64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 0 || S < 0 || C < 0 || C > kMaxGridY || row_bytes <= 0 ||
      row_bytes % 2)
    return (int)cudaErrorInvalidValue;
  if (P == 0 || C == 0 || S == 0) return 0;
  const bool wide = row_bytes % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cache) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  if (wide)
    return launch<uint4>(cache, rows, pos, P, S, C, row_bytes / 16, pos64, s);
  return launch<uint16_t>(cache, rows, pos, P, S, C, row_bytes / 2, pos64, s);
}

const char* kv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
