// predicate_filter: ingestion-time conditionsList evaluation (paper Alg. 2).
//
// Replaces: src/repro/kernels/predicate_filter/kernel.py,
//   predicate_filter_kernel (body _kernel), the Pallas TPU kernel.
// Computes: (N, F) int32 records x per-channel canonical intervals
//   lo/hi/neq (C, F) -> (N, C) match bitmap, one byte (0/1) per entry:
//   match[n, c] = AND_f (lo[c,f] <= x[n,f] <= hi[c,f]
//                        && (x[n,f] != neq[c,f] || neq[c,f] == INT32_MIN)).
// Bound on the H100: memory. Each record is read once (4F bytes) and each
//   bitmap byte written once; at N = 65,536, F = 10, C = 3 that is 2.6 MB in
//   and 0.2 MB out, under a microsecond at 3.35 TB/s, so at the main path's
//   shapes the launch itself is the cost.
// Design: one thread per record row, a block of 256 rows. The block first
//   copies its (256, F) slab of records into shared memory with consecutive
//   threads on consecutive words (coalesced), and the (C, F) tables beside
//   it; then each thread evaluates its row against every channel from
//   shared memory. The ragged tail is masked here, so the caller pads
//   nothing, and the output is written as bytes straight into a torch.bool
//   tensor.
//
// Second entry, predicate_filter_rows_launch: the fused discovery's stacked
//   form (the reference batches its kernel by vmap over a leading grid axis,
//   predicate_filter/ops.py predicate_filter_rows). (C, N, F) row blocks x
//   (C, F) tables -> (C, N): block (b, c) stages channel c's rows b*256...
//   into shared memory as above and evaluates them against table row c only,
//   writing one byte per row of the (C, N) torch.bool output. Bound: memory,
//   4F bytes in and 1 byte out per (c, n).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr int32_t kNeqNone = INT32_MIN;

__global__ void predicate_filter_kernel(const int32_t* __restrict__ fields,
                                        const int32_t* __restrict__ lo,
                                        const int32_t* __restrict__ hi,
                                        const int32_t* __restrict__ neq,
                                        uint8_t* __restrict__ out,
                                        int n, int f, int c) {
  extern __shared__ int32_t smem[];
  int32_t* s_lo = smem;
  int32_t* s_hi = s_lo + c * f;
  int32_t* s_neq = s_hi + c * f;
  int32_t* s_rows = s_neq + c * f;

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = n - row0 < kRows ? static_cast<int>(n - row0) : kRows;

  for (int i = threadIdx.x; i < c * f; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_hi[i] = hi[i];
    s_neq[i] = neq[i];
  }
  const int32_t* slab = fields + row0 * f;
  for (int i = threadIdx.x; i < rows * f; i += blockDim.x) {
    s_rows[i] = slab[i];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= rows) return;
  const int32_t* x = s_rows + r * f;
  uint8_t* o = out + (row0 + r) * c;
  for (int ch = 0; ch < c; ++ch) {
    const int32_t* l = s_lo + ch * f;
    const int32_t* h = s_hi + ch * f;
    const int32_t* q = s_neq + ch * f;
    bool ok = true;
    for (int k = 0; k < f; ++k) {
      const int32_t v = x[k];
      ok = ok && v >= l[k] && v <= h[k] && (v != q[k] || q[k] == kNeqNone);
    }
    o[ch] = ok ? 1 : 0;
  }
}

// Block (blockIdx.x, blockIdx.y = c): rows b*kRows... of channel c's block.
__global__ void predicate_filter_rows_kernel(
    const int32_t* __restrict__ fields, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, const int32_t* __restrict__ neq,
    uint8_t* __restrict__ out, int n, int f) {
  extern __shared__ int32_t smem[];
  int32_t* s_lo = smem;
  int32_t* s_hi = s_lo + f;
  int32_t* s_neq = s_hi + f;
  int32_t* s_rows = s_neq + f;

  const int64_t c = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows = n - row0 < kRows ? static_cast<int>(n - row0) : kRows;

  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    s_lo[i] = lo[c * f + i];
    s_hi[i] = hi[c * f + i];
    s_neq[i] = neq[c * f + i];
  }
  const int32_t* slab = fields + (c * n + row0) * f;
  for (int i = threadIdx.x; i < rows * f; i += blockDim.x) {
    s_rows[i] = slab[i];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r >= rows) return;
  const int32_t* x = s_rows + r * f;
  bool ok = true;
  for (int k = 0; k < f; ++k) {
    const int32_t v = x[k];
    ok = ok && v >= s_lo[k] && v <= s_hi[k] &&
         (v != s_neq[k] || s_neq[k] == kNeqNone);
  }
  out[c * n + row0 + r] = ok ? 1 : 0;
}

}  // namespace

extern "C" int predicate_filter_launch(const void* fields, const void* lo,
                                       const void* hi, const void* neq,
                                       void* out, int n, int f, int c,
                                       void* stream) {
  if (n <= 0 || c <= 0) return 0;
  const size_t shared =
      sizeof(int32_t) * (3 * static_cast<size_t>(c) * f +
                         static_cast<size_t>(kRows) * f);
  if (shared > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kRows - 1) / kRows;
  predicate_filter_kernel<<<blocks, kRows, shared,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fields), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(neq),
      static_cast<uint8_t*>(out), n, f, c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int predicate_filter_rows_launch(const void* fields, const void* lo,
                                            const void* hi, const void* neq,
                                            void* out, int c, int n, int f,
                                            void* stream) {
  if (n <= 0 || c <= 0) return 0;
  const size_t shared =
      sizeof(int32_t) * (3 * static_cast<size_t>(f) +
                         static_cast<size_t>(kRows) * f);
  if (shared > kMaxSharedBytes || c > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRows - 1) / kRows, c);
  predicate_filter_rows_kernel<<<grid, kRows, shared,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fields), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(neq),
      static_cast<uint8_t*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}
