// join_compact: pair expansion of the compacted candidate stream.
//
// Replaces: src/repro/kernels/join_compact/kernel.py, join_pairs_kernel
//   (body _kernel), the Pallas TPU kernel behind the "compact_pallas"
//   backend.
// Computes: per stream entry s (S entries) and join-map column t (maxT):
//     pv        = valid[s] && t < tgt_n[s] && tgt[s,t] >= 0
//     members   = pv ? members_in[s,t] : 0
//     pair_bytes= pv ? payload[s] + (aggregated ? 4*members : 0) : 0
//     bids      = pv ? brokers_in[s,t] : num_brokers
//   pv is written as one byte (0/1) straight into a torch.bool tensor; the
//   other three grids are int32, and the byte sum wraps modulo 2^32 as the
//   reference's int32 arithmetic does.
// Bound on the H100: memory (3.35 TB/s), as chip_smoke.join_compact_bytes
//   counts it on the call's inputs. The four outputs are written in full,
//   13 B an entry; each stream entry reads valid, tgt_n and payload, 9 B;
//   of the (S, maxT) inputs only what decides or fills a live pair is
//   needed, in 32-B sectors: tgt where valid[s] and t < tgt_n[s], members
//   and brokers where the pair is live. The outputs dominate (1.745 GB of
//   2.31 at the compact phase's real grid), so the kernel is a store
//   stream with sparse, dependent reads in front of it.
// Design: the vector path gives each thread a quad, 4 consecutive columns
//   of one row. It reads the row's three scalars once, loads tgt as one
//   16-B int4 only when the quad's first column is live-able (valid[s],
//   column < tgt_n[s]), then members and brokers as one int4 each only when
//   some pair of the quad is live, and stores members, pair_bytes and bids
//   as int4 and the four pv bytes as one 32-bit word: a warp writes 512 B
//   of each int32 grid per store instruction, and at maxT = 16 a warp
//   covers 8 whole rows with no idle lane. It needs maxT % 4 == 0 and all
//   ten pointers 16-B aligned (ops.vector_ok decides, the caller passes
//   the choice); otherwise the scalar path runs the same rules a pair per
//   thread. Both walk a 1-D grid of 64-bit indices with a grid-stride loop,
//   so no shape meets a per-axis grid limit; the ragged edges are masked
//   here and the caller pads nothing. Measured on an H100 (PERF.md's kernel
//   table): a flat grid, one unit a thread, beats persistent blocks sized
//   from the SM count (8 an SM: 8% slower at the real grid) and two or four
//   quads a thread with their loads batched (0.5% and 1-11% slower at the
//   real grid, 16-64% at the fused shape's few blocks); streaming
//   (evict-first) stores move neither shape, so the stores are default ones,
//   which leave the fused path's 3.4 MB of outputs in L2 for the stream
//   accounting that reads them next; a 32-bit division for the row where
//   the indices fit measured the same as the 64-bit one.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// gridDim.x's limit; the grid-stride loop takes what lies beyond it
constexpr int64_t kMaxBlocks = 0x7fffffff;

// The row's live-able column count: tgt_n[s] where valid[s], else 0. Both
// scalars load in one round.
__device__ __forceinline__ int live_cols(const int32_t* __restrict__ tgt_n,
                                         const uint8_t* __restrict__ valid,
                                         int64_t s) {
  const int n = __ldg(tgt_n + s);
  return __ldg(valid + s) != 0 ? n : 0;
}

// unsigned arithmetic: int32 wraparound without signed overflow
__device__ __forceinline__ int32_t pair_bytes(bool pv, uint32_t pay,
                                              int32_t m, int aggregated) {
  return pv ? static_cast<int32_t>(
                  pay + (aggregated ? 4u * static_cast<uint32_t>(m) : 0u))
            : 0;
}

__global__ void __launch_bounds__(kThreads)
    join_quads_kernel(const int4* __restrict__ tgt,
                      const int32_t* __restrict__ tgt_n,
                      const int4* __restrict__ members,
                      const int4* __restrict__ brokers,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ payload,
                      uint32_t* __restrict__ pv_out,
                      int4* __restrict__ members_out,
                      int4* __restrict__ bytes_out,
                      int4* __restrict__ bids_out, int64_t quads,
                      int quads_per_row, int num_brokers, int aggregated) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       q < quads; q += stride) {
    // quad q holds columns c..c+3 of row s: element s * maxT + c == 4 q
    const int64_t s = q / quads_per_row;
    const int c = static_cast<int>(q - s * quads_per_row) * 4;
    const int n = live_cols(tgt_n, valid, s);
    const uint32_t pay = static_cast<uint32_t>(__ldg(payload + s));
    int4 t = make_int4(-1, -1, -1, -1);
    if (c < n) t = __ldg(tgt + q);
    const bool p0 = c < n && t.x >= 0, p1 = c + 1 < n && t.y >= 0,
               p2 = c + 2 < n && t.z >= 0, p3 = c + 3 < n && t.w >= 0;
    int4 m = make_int4(0, 0, 0, 0);
    int4 b = make_int4(num_brokers, num_brokers, num_brokers, num_brokers);
    if (p0 || p1 || p2 || p3) {
      const int4 mi = __ldg(members + q), bi = __ldg(brokers + q);
      m = make_int4(p0 ? mi.x : 0, p1 ? mi.y : 0, p2 ? mi.z : 0,
                    p3 ? mi.w : 0);
      b = make_int4(p0 ? bi.x : num_brokers, p1 ? bi.y : num_brokers,
                    p2 ? bi.z : num_brokers, p3 ? bi.w : num_brokers);
    }
    // little-endian: column c's byte is the word's lowest
    pv_out[q] = static_cast<uint32_t>(p0) | static_cast<uint32_t>(p1) << 8 |
                static_cast<uint32_t>(p2) << 16 |
                static_cast<uint32_t>(p3) << 24;
    members_out[q] = m;
    bytes_out[q] = make_int4(pair_bytes(p0, pay, m.x, aggregated),
                             pair_bytes(p1, pay, m.y, aggregated),
                             pair_bytes(p2, pay, m.z, aggregated),
                             pair_bytes(p3, pay, m.w, aggregated));
    bids_out[q] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
    join_pairs_kernel(const int32_t* __restrict__ tgt,
                      const int32_t* __restrict__ tgt_n,
                      const int32_t* __restrict__ members,
                      const int32_t* __restrict__ brokers,
                      const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ payload,
                      uint8_t* __restrict__ pv_out,
                      int32_t* __restrict__ members_out,
                      int32_t* __restrict__ bytes_out,
                      int32_t* __restrict__ bids_out, int64_t pairs,
                      int max_t, int num_brokers, int aggregated) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < pairs; i += stride) {
    const int64_t s = i / max_t;
    const int t = static_cast<int>(i - s * max_t);
    const bool pv = t < live_cols(tgt_n, valid, s) && __ldg(tgt + i) >= 0;
    const int32_t m = pv ? __ldg(members + i) : 0;
    pv_out[i] = pv ? 1 : 0;
    members_out[i] = m;
    bytes_out[i] = pair_bytes(
        pv, pv ? static_cast<uint32_t>(__ldg(payload + s)) : 0u, m,
        aggregated);
    bids_out[i] = pv ? __ldg(brokers + i) : num_brokers;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// blocks for `units` threads' work: one each, as far as gridDim.x goes
unsigned blocks_for(int64_t units) {
  const int64_t blocks = (units + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// tgt, members, brokers (S, maxT) int32; tgt_n, payload (S,) int32; valid
// (S,) bool as bytes; pv_out (S, maxT) bool as bytes; members_out, bytes_out,
// bids_out (S, maxT) int32; all contiguous. vector = 1 runs the quad path,
// which needs maxT % 4 == 0 and all ten pointers 16-B aligned (else the
// launch is refused); vector = 0 runs the pair path. Returns the launch's
// cudaError_t, or 0.
extern "C" int join_compact_launch(const void* tgt, const void* tgt_n,
                                   const void* members, const void* brokers,
                                   const void* valid, const void* payload,
                                   void* pv_out, void* members_out,
                                   void* bytes_out, void* bids_out, int s_len,
                                   int max_t, int num_brokers, int aggregated,
                                   int vector, void* stream) {
  if (s_len <= 0 || max_t <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t pairs = static_cast<int64_t>(s_len) * max_t;
  if (vector) {
    const void* ptrs[] = {tgt, tgt_n, members, brokers, valid,
                          payload, pv_out, members_out, bytes_out, bids_out};
    bool ok = max_t % 4 == 0;
    for (const void* p : ptrs) ok = ok && aligned16(p);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t quads = pairs / 4;
    join_quads_kernel<<<blocks_for(quads), kThreads, 0, st>>>(
        static_cast<const int4*>(tgt), static_cast<const int32_t*>(tgt_n),
        static_cast<const int4*>(members), static_cast<const int4*>(brokers),
        static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(payload), static_cast<uint32_t*>(pv_out),
        static_cast<int4*>(members_out), static_cast<int4*>(bytes_out),
        static_cast<int4*>(bids_out), quads, max_t / 4, num_brokers,
        aggregated);
  } else {
    join_pairs_kernel<<<blocks_for(pairs), kThreads, 0, st>>>(
        static_cast<const int32_t*>(tgt), static_cast<const int32_t*>(tgt_n),
        static_cast<const int32_t*>(members),
        static_cast<const int32_t*>(brokers),
        static_cast<const uint8_t*>(valid),
        static_cast<const int32_t*>(payload), static_cast<uint8_t*>(pv_out),
        static_cast<int32_t*>(members_out), static_cast<int32_t*>(bytes_out),
        static_cast<int32_t*>(bids_out), pairs, max_t, num_brokers,
        aggregated);
  }
  return static_cast<int>(cudaGetLastError());
}
