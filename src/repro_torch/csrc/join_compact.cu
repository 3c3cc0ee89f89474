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
// Bound on the H100: memory. Each (s, t) entry reads 3 int32 (12 B) and
//   writes 1 + 3*4 = 13 B; each s reads tgt_n and payload (int32) and valid
//   (bool), 9 B. There is no reuse, so the kernel can at best stream at the
//   memory rate (3.35 TB/s).
// Design: one thread per (s, t) pair. A block of 32 x 8 threads covers 32
//   consecutive columns of 8 stream entries, so a warp reads and writes 32
//   consecutive words (bytes for pv) of one row: the accesses coalesce. The
//   grid is 2-D, S on x (no 65,535 limit there) and maxT on y; the ragged
//   edges of both axes are masked here, so the caller pads nothing (the TPU
//   wrapper pads S to its 256-row tile). valid is the caller's bool tensor,
//   read as bytes: no int32 cast pass.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;
constexpr int kRows = 8;

__global__ void join_compact_kernel(const int32_t* __restrict__ tgt,
                                    const int32_t* __restrict__ tgt_n,
                                    const int32_t* __restrict__ members,
                                    const int32_t* __restrict__ brokers,
                                    const uint8_t* __restrict__ valid,
                                    const int32_t* __restrict__ payload,
                                    uint8_t* __restrict__ pv_out,
                                    int32_t* __restrict__ members_out,
                                    int32_t* __restrict__ bytes_out,
                                    int32_t* __restrict__ bids_out,
                                    int s_len, int max_t, int num_brokers,
                                    int aggregated) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.y;
  const int t = blockIdx.y * kCols + threadIdx.x;
  if (s >= s_len || t >= max_t) return;
  const int64_t i = s * max_t + t;
  const bool pv = valid[s] != 0 && t < tgt_n[s] && tgt[i] >= 0;
  const int32_t m = pv ? members[i] : 0;
  // unsigned arithmetic: int32 wraparound without signed overflow
  const uint32_t per = static_cast<uint32_t>(payload[s]) +
                       (aggregated ? 4u * static_cast<uint32_t>(m) : 0u);
  pv_out[i] = pv ? 1 : 0;
  members_out[i] = m;
  bytes_out[i] = pv ? static_cast<int32_t>(per) : 0;
  bids_out[i] = pv ? brokers[i] : num_brokers;
}

}  // namespace

extern "C" int join_compact_launch(const void* tgt, const void* tgt_n,
                                   const void* members, const void* brokers,
                                   const void* valid, const void* payload,
                                   void* pv_out, void* members_out,
                                   void* bytes_out, void* bids_out, int s_len,
                                   int max_t, int num_brokers, int aggregated,
                                   void* stream) {
  if (s_len <= 0 || max_t <= 0) return 0;
  const dim3 block(kCols, kRows);
  const dim3 grid((s_len + kRows - 1) / kRows, (max_t + kCols - 1) / kCols);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  join_compact_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tgt), static_cast<const int32_t*>(tgt_n),
      static_cast<const int32_t*>(members),
      static_cast<const int32_t*>(brokers),
      static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(payload), static_cast<uint8_t*>(pv_out),
      static_cast<int32_t*>(members_out), static_cast<int32_t*>(bytes_out),
      static_cast<int32_t*>(bids_out), s_len, max_t, num_brokers, aggregated);
  return static_cast<int>(cudaGetLastError());
}
