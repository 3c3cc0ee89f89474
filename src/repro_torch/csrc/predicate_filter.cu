// predicate_filter: ingestion-time conditionsList evaluation (paper Alg. 2).
//
// Replaces: src/repro/kernels/predicate_filter/kernel.py,
//   predicate_filter_kernel (body _kernel), the Pallas TPU kernel.
// Computes: (N, F) int32 records x per-channel canonical intervals
//   lo/hi/neq (C, F) -> (N, C) match bitmap, one byte (0/1) per entry:
//   match[n, c] = AND_f (lo[c,f] <= x[n,f] <= hi[c,f]
//                        && (x[n,f] != neq[c,f] || neq[c,f] == INT32_MIN)).
// Bound on the H100: memory. Each record is read once (4F bytes) and each
//   bitmap byte written once: at N = 65,536, F = 10, C = 3 that is 2.6 MB in
//   and 0.2 MB out, under a microsecond at 3.35 TB/s, so at the ingest shape
//   the launch itself is the cost; a full scan of the 2M-row ring moves
//   90 MB, and there the bytes are.
// Design: one pass, one thread per record row, a block of 256 rows (a
//   1,024 F-byte slab, so every block starts on a 16-byte boundary when the
//   records do; the wrapper checks the base). Each thread first issues all
//   its 16-byte loads of the flat slab through the read-only path (all of
//   them at once for F <= 32; with F known at compile time, as for the
//   tweet schema's 10, only the loads it can have), then scatters them into
//   shared memory at a row pitch of F | 1 words, odd, so that the 32 rows a
//   warp reads word by word fall on 32 banks. The (C, F) tables are read
//   once a block through the read-only path, their loads issued before the
//   slab's (one warp a channel, one lane a field), and each channel keeps
//   only its constrained fields, compacted by a ballot into int4 entries
//   {lo, hi - lo, neq, field and whether neq is unused}: a row then costs a
//   broadcast load and a range test per predicate, not per (channel,
//   field), with the same result bit for bit (a field with no predicate
//   always passes). Each thread writes its row's bytes into a shared output
//   slab, which the block stores with 16-byte stores (the block's output
//   starts on a 16-byte boundary: 256 rows of whole bytes). The ragged tail
//   is masked here, so the caller pads nothing, and the output is written
//   as bytes straight into a torch.bool tensor. At F = 10 a thread needs 32
//   to 40 registers and a block 12.5 KB of shared memory, so eight blocks
//   fit on an SM and, at a full scan's 8,192 blocks, the loads of some are
//   in flight while others compare. Where a block's tables and output do
//   not fit in 48 KB beside its rows (at F = 10, more than 90 channels), it
//   takes the channels in chunks of as many as fit, the rows staged once,
//   and stores each chunk's columns as runs of bytes; any C is taken for F
//   up to 47.
//
// Second entry, predicate_filter_rows_launch: the fused discovery's stacked
//   form (the reference batches its kernel by vmap over a leading grid axis,
//   predicate_filter/ops.py predicate_filter_rows). (C, N, F) row blocks x
//   (C, F) tables -> (C, N): the same kernel over the flat (C * N, F)
//   records, flat row i held against table row i / N only and writing one
//   byte, so the (C, N) output is the flat row order; a block stages only
//   the tables of the channels its rows fall in. Bound: memory, 4F bytes in
//   and 1 byte out per (c, n).
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;
constexpr int kVecs = 8;                 // 16-byte loads a thread per round
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr int32_t kNeqNone = INT32_MIN;

// shared memory for chunks of up to ct channels: the int4 tables, the
// channels' entry counts, the padded rows, the output bytes
__host__ __device__ inline size_t count_offset(int ct, int f) {
  return 16 * static_cast<size_t>(ct) * f;
}
__host__ __device__ inline size_t rows_offset(int ct, int f) {
  return (count_offset(ct, f) + 4 * static_cast<size_t>(ct) + 15) / 16 * 16;
}
__host__ __device__ inline size_t out_offset(int ct, int f) {
  const size_t end =
      rows_offset(ct, f) + 4 * static_cast<size_t>(kRows) * (f | 1);
  return (end + 15) / 16 * 16;
}
inline size_t shared_bytes(int ct, int f, bool stacked) {
  return out_offset(ct, f) + static_cast<size_t>(kRows) * (stacked ? 1 : ct);
}

// whether row x meets a channel's n entries t: one broadcast load and one
// range test a predicate
__device__ __forceinline__ uint8_t matches(const int4* t, int n,
                                           const int32_t* x) {
  bool ok = true;
  for (int e = 0; e < n; ++e) {
    const int4 p = t[e];
    const int32_t v = x[p.w >> 1];
    ok &= (static_cast<uint32_t>(v) - static_cast<uint32_t>(p.x) <=
           static_cast<uint32_t>(p.y)) &
          ((v != p.z) | (p.w & 1));
  }
  return ok ? 1 : 0;
}

// kStacked = false: rows of (n_rows, F) against every table row, C bytes a
// row. kStacked = true: flat rows of (C * per_channel, F), row i against
// table row i / per_channel, one byte a row. kF > 0: F known at compile time
// (the slab's scatter divides by a constant); kF = 0: F = f at run time.
// A block takes the channels its rows need (all C, or the one to few its
// rows fall in) in chunks of up to ct_max, the rows staged once; kChunked =
// false where one chunk holds them all, so the loop compiles away (the
// loop kept in cost the full scan about 10%).
template <bool kStacked, int kF, bool kChunked>
__global__ void __launch_bounds__(kRows)
    predicate_filter_kernel(const int32_t* __restrict__ fields,
                            const int32_t* __restrict__ lo,
                            const int32_t* __restrict__ hi,
                            const int32_t* __restrict__ neq,
                            uint8_t* __restrict__ out, int64_t n_rows,
                            int f_run, int c, int64_t per_channel,
                            int ct_max) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = kF > 0 ? kF : f_run, pitch = f | 1;
  int4* s_tab = reinterpret_cast<int4*>(smem);
  int* s_count = reinterpret_cast<int*>(smem + count_offset(ct_max, f));
  int32_t* s_rows = reinterpret_cast<int32_t*>(smem + rows_offset(ct_max, f));
  uint8_t* s_out = smem + out_offset(ct_max, f);
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int rows =
      static_cast<int>(n_rows - row0 < kRows ? n_rows - row0 : kRows);

  // the channels this block's rows need: all of them, or (stacked) those
  // of its first to last row, found with one 64-bit division each
  const int ch_begin = kStacked ? static_cast<int>(row0 / per_channel) : 0;
  const int ch_end =
      kStacked ? static_cast<int>((row0 + rows - 1) / per_channel) + 1 : c;
  // the stacked form's row channel, in 32-bit arithmetic from ch_begin's
  const int my_ch =
      kStacked ? ch_begin + static_cast<int>(
                                static_cast<uint32_t>(
                                    row0 - ch_begin * per_channel + tid) /
                                static_cast<uint32_t>(per_channel))
               : 0;

  // channel ch's constrained fields only, as entries {lo, hi - lo as
  // unsigned, neq, 2 k + (neq unused)}: lo <= x <= hi is (unsigned)(x - lo)
  // <= hi - lo, an empty interval (lo > hi) becomes x == 0 && x != 0, and a
  // field with no predicate (the full int32 range, no neq) is left out
  auto unconstrained = [](int32_t a, int32_t z, int32_t q) {
    return a == INT32_MIN && z == INT32_MAX && q == kNeqNone;
  };
  auto entry = [](int k, int32_t a, int32_t z, int32_t q) {
    return a <= z ? make_int4(a,
                              static_cast<int32_t>(static_cast<uint32_t>(z) -
                                                   static_cast<uint32_t>(a)),
                              q, 2 * k + (q == kNeqNone))
                  : make_int4(0, 0, 0, 2 * k);
  };
  // a first chunk of up to 8 channels of up to 32 fields: warp w's lane k
  // loads entry (ch_begin + w, k) before the slab's loads, so the two
  // latencies overlap
  const int warp = tid >> 5, lane = tid & 31;
  const int ct0 = min(ct_max, ch_end - ch_begin);
  const bool by_warp = ct0 <= kRows / 32 && f <= 32;
  int32_t ta = INT32_MIN, tz = INT32_MAX, tq = kNeqNone;
  if (by_warp && warp < ct0 && lane < f) {
    const int i = (ch_begin + warp) * f + lane;
    ta = __ldg(lo + i);
    tz = __ldg(hi + i);
    tq = __ldg(neq + i);
  }

  // the slab's 16-byte loads first, all in flight, then into shared memory
  // (with F known, a thread holds only the loads it can have)
  constexpr int V = kF > 0 ? (kF + 3) / 4 : kVecs;
  const int32_t* slab = fields + row0 * f;
  const int words = rows * f, vecs = words / 4;
  const uint4* slab4 = reinterpret_cast<const uint4*>(slab);
  for (int first = 0; first < vecs; first += kRows * V) {
    uint4 buf[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = first + j * kRows + tid;
      if (i < vecs) buf[j] = __ldg(slab4 + i);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int i = first + j * kRows + tid;
      if (i < vecs) {
        int r = 4 * i / f, k = 4 * i - r * f;
        const int32_t w[4] = {static_cast<int32_t>(buf[j].x),
                              static_cast<int32_t>(buf[j].y),
                              static_cast<int32_t>(buf[j].z),
                              static_cast<int32_t>(buf[j].w)};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s_rows[r * pitch + k] = w[u];
          if (++k == f) k = 0, ++r;
        }
      }
    }
  }
  if (tid < words - 4 * vecs) {            // the ragged tail's last words
    const int i = 4 * vecs + tid, r = i / f;
    s_rows[r * pitch + i - r * f] = __ldg(slab + i);
  }

  const int32_t* x = s_rows + tid * pitch;
  for (int c0 = ch_begin; c0 < (kChunked ? ch_end : ch_begin + 1);
       c0 += ct_max) {
    const int ct = kChunked ? min(ct_max, ch_end - c0) : ch_end - ch_begin;
    if (kChunked && c0 != ch_begin) __syncthreads();   // last chunk read
    if (c0 == ch_begin && by_warp) {
      if (warp < ct) {
        const bool keep = lane < f && !unconstrained(ta, tz, tq);
        const unsigned mask = __ballot_sync(0xffffffffu, keep);
        if (keep)
          s_tab[warp * f + __popc(mask & ((1u << lane) - 1))] =
              entry(lane, ta, tz, tq);
        if (lane == 0) s_count[warp] = __popc(mask);
      }
    } else {
      for (int j = tid; j < ct; j += kRows) {
        int n = 0;
        for (int k = 0; k < f; ++k) {
          const int i = (c0 + j) * f + k;
          const int32_t a = __ldg(lo + i), z = __ldg(hi + i),
                        q = __ldg(neq + i);
          if (!unconstrained(a, z, q)) s_tab[j * f + n++] = entry(k, a, z, q);
        }
        s_count[j] = n;
      }
    }
    __syncthreads();

    if (kStacked) {
      if (tid < rows && my_ch >= c0 && my_ch < c0 + ct)
        s_out[tid] = matches(s_tab + (my_ch - c0) * f, s_count[my_ch - c0],
                             x);
    } else {
      if (tid < rows)
        for (int j = 0; j < ct; ++j)
          s_out[tid * ct + j] = matches(s_tab + j * f, s_count[j], x);
      __syncthreads();
      uint8_t* dst = out + row0 * c;
      if (!kChunked || ct == c) {
        // the block's whole output: 16-byte stores, then the ragged tail
        const int bytes = rows * c;
        for (int i = tid; i < bytes / 16; i += kRows)
          reinterpret_cast<uint4*>(dst)[i] =
              reinterpret_cast<const uint4*>(s_out)[i];
        for (int i = bytes / 16 * 16 + tid; i < bytes; i += kRows)
          dst[i] = s_out[i];
      } else {
        // a chunk of columns: runs of ct bytes at a pitch of C
        for (int i = tid; i < rows * ct; i += kRows)
          dst[static_cast<int64_t>(i / ct) * c + c0 + i % ct] = s_out[i];
      }
    }
  }
  if (kStacked) {
    // the block's bytes: 16-byte stores, then the ragged tail's bytes
    __syncthreads();
    uint8_t* dst = out + row0;
    for (int i = tid; i < rows / 16; i += kRows)
      reinterpret_cast<uint4*>(dst)[i] =
          reinterpret_cast<const uint4*>(s_out)[i];
    for (int i = rows / 16 * 16 + tid; i < rows; i += kRows) dst[i] = s_out[i];
  }
}

// the records' width in the tweet schema, compiled with F known
constexpr int kSchemaFields = 10;

// the channels a chunk: all that a block needs if they fit in 48 KB of
// shared memory, else the most that do (0 where not even one does: F > 47)
int chunk(int span, int f, bool stacked) {
  const size_t fixed = out_offset(0, f) + 32;
  if (fixed >= kMaxSharedBytes) return 0;
  const size_t per = 16 * static_cast<size_t>(f) + 4 + (stacked ? 0 : kRows);
  int ct = static_cast<int>(
      std::min<size_t>(span, (kMaxSharedBytes - fixed) / per + 1));
  while (ct > 0 && shared_bytes(ct, f, stacked) > kMaxSharedBytes) --ct;
  return ct;
}

template <bool kStacked>
int launch(const void* fields, const void* lo, const void* hi,
           const void* neq, void* out, int64_t n_rows, int f, int c,
           int64_t per_channel, void* stream) {
  const int64_t blocks = (n_rows + kRows - 1) / kRows;
  // a block's channels: all C, or (stacked) the most its rows can meet
  const int span = kStacked ? static_cast<int>(std::min<int64_t>(
                                  c, (kRows - 1) / per_channel + 2))
                            : c;
  const int ct = f > 0 ? chunk(span, f, kStacked) : 0;
  if (ct < 1 || blocks > 0x7fffffff ||
      (reinterpret_cast<uintptr_t>(fields) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool chunked = ct < span;
  auto kernel =
      f == kSchemaFields
          ? (chunked ? predicate_filter_kernel<kStacked, kSchemaFields, true>
                     : predicate_filter_kernel<kStacked, kSchemaFields, false>)
          : (chunked ? predicate_filter_kernel<kStacked, 0, true>
                     : predicate_filter_kernel<kStacked, 0, false>);
  kernel<<<static_cast<unsigned>(blocks), kRows,
           shared_bytes(ct, f, kStacked), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fields), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(neq),
      static_cast<uint8_t*>(out), n_rows, f, c, per_channel, ct);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fields (N, F) int32 and out (N, C) bytes, both 16-byte aligned and
// contiguous; lo, hi, neq (C, F) int32. Returns the launch's cudaError_t.
extern "C" int predicate_filter_launch(const void* fields, const void* lo,
                                       const void* hi, const void* neq,
                                       void* out, int n, int f, int c,
                                       void* stream) {
  if (n <= 0 || c <= 0) return 0;
  return launch<false>(fields, lo, hi, neq, out, n, f, c, n, stream);
}

// fields (C, N, F) int32 and out (C, N) bytes, both 16-byte aligned and
// contiguous; lo, hi, neq (C, F) int32. Returns the launch's cudaError_t.
extern "C" int predicate_filter_rows_launch(const void* fields, const void* lo,
                                            const void* hi, const void* neq,
                                            void* out, int c, int n, int f,
                                            void* stream) {
  if (n <= 0 || c <= 0) return 0;
  return launch<true>(fields, lo, hi, neq, out, static_cast<int64_t>(c) * n,
                      f, c, n, stream);
}
