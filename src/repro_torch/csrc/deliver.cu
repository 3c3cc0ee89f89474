// deliver: the broker's fused convert and send stages, with spill capture
// and the retry ring (core/broker.py deliver_all), in four launches.
//
// Replaces: no TPU kernel. The reference runs delivery as XLA operations
//   (src/repro/core/broker.py deliver_all); the port ran them as a chain of
//   PyTorch operations, each of which materialised a tensor the size of a
//   delivery buffer. This kernel computes the same FusedDelivery bit for bit
//   (all integer).
// Computes, per channel c, with the pairs in delivery order (live ring
//   entries in residence order, then the fresh valid pairs in ravel order):
//   the first min(live, cap) pairs are the wire lines of the pack buffer
//   (C, max_pairs, width) = [row, target, members, payload_words, the
//   target's sID row (the target itself on the identity fanout),
//   payload_words copies of row]; the lines after a channel's delivered
//   count are left as the buffer held them (no reader looks past that
//   count; the plain version writes zeros there); the member sIDs of the
//   same order fill notify (C, max_notify) up to its cap, -1 after; what
//   overflows a cap fills the successor ring's window, then the spill
//   window, and past both is counted. Per-broker counts, the produced and
//   delivered counts, the ring's counters and the spill totals come with
//   them.
// Bound on the H100: memory (3.35 TB/s). Written: the live wire lines (at
//   paper-1m's param plan-group a few thousand of its (2, 131,072, 10,252)
//   int32 capacity, some 0.24 GB), notify in full ((C, 2^25) int32, 0.27
//   GB), the windows and counters; read: the (C, P) validity flags, which
//   two passes read, the other inputs where a pair is valid, and each live
//   line's sID row.
// Design, four launches:
//   1. count: a block a tile of 4,096 pairs (16 flags a thread, one 16-B
//      load where the flags allow) sums the tile's valid pairs and their
//      member counts.
//   2. scan: a block a channel scans its tile sums into tile offsets, and
//      with the totals known writes every per-channel counter, fills the
//      small windows (ring, spill) with their empty values, and places the
//      live ring entries: their wire slots, their overflow in the new ring,
//      their sIDs in notify.
//   3. scatter: a block a tile that holds a valid pair ranks its pairs
//      (block scan plus the tile's offset) and writes each pair's source
//      into its wire slot (or the new ring, or the spill window), counts
//      brokers in shared memory with one global add a block, writes the
//      members of a pair with at most kSmall of them itself, and queues a
//      pair with more as a work item.
//   4. write: the live wire lines, flattened over the channels (each
//      channel's delivered count, read on the device), kLineBlocksPerSm
//      blocks an SM that take them from a counter as they go: a block a
//      line (several lines a block where a line is narrow), 16-byte stores
//      where the width and the buffer allow (vector_lines). A block that
//      finishes early takes the next line: a fixed grid stride keeps the
//      blocks marching in step, and on an H100 ran a full buffer some 36%
//      slower than one block a line. Ahead of them blocks that
//      fill notify's tail with -1 (st.global.cs, so that they do not evict
//      the tables from L2) and copy each queued pair's members, a block a
//      pair, so that the send stage reads in proportion to the load.
//   Offsets into the wire buffer pass 2^31 words, so every index is 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // count, scatter and write
constexpr int kScanThreads = 1024;  // scan: one block a channel
// dynamic shared memory (the per-broker tally) past which a launch asks for
// more than the default 48 KB: the scan's warp sums take 256 B of their own
constexpr size_t kSmemOptIn = 32 * 1024;
constexpr int kTileItems = 16;      // flags a thread: one 16-B load
constexpr int64_t kTile = kThreads * kTileItems;
constexpr int32_t kSmall = 32;      // members a pair's own thread writes
constexpr int64_t kFanBlocks = 1024;
constexpr int64_t kMaxBlocks = 0x7fffffff;
// blocks of the line walk an SM: the card's resident blocks of 256 threads
constexpr int kLineBlocksPerSm = 8;

// rows of the per-channel counters, each C wide; after them the queued
// item count, the two spill totals and the line walk's counter
enum Stat {
  kDelivP, kProdP, kDelivS, kProdS, kStale, kRingP, kRingS, kNRing,
  kOvP, kOvS, kCapP, kSidBase, kNStat
};

// Every array of one call (ops.py _Args mirrors it field for field).
struct Args {
  const uint8_t* valid;        // (C, P) bool
  const int32_t* rows;         // (C, P)
  const int32_t* tgts;         // (C, P)
  const int32_t* sids;         // (C, T, S) group table, null: identity
  const int32_t* counts;       // (C, Tc) member counts, null: identity
  const int32_t* brokers;      // (C, Tb), null: no per-broker counts
  const int32_t* caps_p;       // (C,) or null
  const int32_t* caps_n;       // (C,) or null
  const int32_t* ring_rows;    // (C, W), all ring arrays null: ring-less
  const int32_t* ring_tgts;
  const int32_t* ring_epochs;
  const int32_t* ring_pcount;  // (C,)
  const int32_t* ring_sids;    // (C, W)
  const int32_t* ring_scount;  // (C,)
  const int32_t* epochs;       // (C,)
  int32_t* payload;            // (C, max_pairs, width)
  int32_t* notify;             // (C, max_notify)
  int32_t* stats;              // kNStat * C + 3
  int32_t* per_broker;         // (C, B)
  uint8_t* spill_mask;         // (C, P) bool, ring-less only
  int32_t* ps_rows;            // (C * spill_cap) pair spill
  int32_t* ps_ch;
  int32_t* ps_tgts;
  uint8_t* ps_valid;
  int32_t* ss_vals;            // (C * spill_cap) sID spill
  int32_t* ss_ch;
  uint8_t* ss_valid;
  int32_t* nr_rows;            // (C, W) the successor ring
  int32_t* nr_tgts;
  int32_t* nr_epochs;
  int32_t* nr_sids;
  int2* tile_sums;             // (C, tiles) valid pairs, member sum
  int2* tile_offs;             // (C, tiles) their exclusive prefix
  int2* slots;                 // (C, max_pairs) each wire line's row, target
  int4* items;                 // (items_cap) channel, target, members, rank
  int64_t C, P, T, S, Tc, Tb, B, W, spill_cap, max_pairs, max_notify, width,
      payload_words, items_cap, tiles, identity, ring, vector_valid,
      vector_lines, vector_notify, sms;
};

__device__ __forceinline__ int64_t clamp_index(int64_t i, int64_t n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// member count of a valid pair targeting t (the send stage's count)
__device__ __forceinline__ int32_t members_of(const Args& a, int64_t c,
                                              int32_t t) {
  if (a.identity) return t >= 0 ? 1 : 0;
  if (a.Tc == 0) return 0;
  return __ldg(a.counts + c * a.Tc + clamp_index(t, a.Tc));
}

// sID of member j of a pair targeting t
__device__ __forceinline__ int32_t member_sid(const Args& a, int64_t c,
                                              int32_t t, int64_t j) {
  if (a.identity) return t < 0 ? 0 : t;
  if (a.T == 0) return 0;
  return __ldg(a.sids + (c * a.T + clamp_index(t, a.T)) * a.S +
               (j >= a.S ? a.S - 1 : j));
}

__device__ __forceinline__ int32_t broker_of(const Args& a, int64_t c,
                                             int32_t t) {
  if (a.Tb == 0) return 0;
  return __ldg(a.brokers + c * a.Tb + clamp_index(t, a.Tb));
}

__device__ __forceinline__ int32_t stat_of(const Args& a, int row, int64_t c) {
  return a.stats[row * a.C + c];
}

// the 16 validity flags of the pairs p0 .. p0 + 15 of channel c, as bits
__device__ __forceinline__ uint32_t flag_bits(const Args& a, int64_t c,
                                              int64_t p0) {
  if (p0 >= a.P) return 0u;
  const uint8_t* base = a.valid + c * a.P + p0;
  uint32_t bits = 0u;
  if (a.vector_valid) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(base));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      bits |= static_cast<uint32_t>(((w[k >> 2] >> (8 * (k & 3))) & 0xffu) !=
                                    0u) << k;
  } else {
    const int64_t n = a.P - p0 < kTileItems ? a.P - p0 : kTileItems;
    for (int k = 0; k < n; ++k)
      bits |= static_cast<uint32_t>(__ldg(base + k) != 0) << k;
  }
  return bits;
}

// Exclusive block-wide scan of (count, member sum); every thread of the
// block calls it. Sums wrap modulo 2^32, as the reference's int32 cumsum.
template <int kN>
__device__ __forceinline__ uint2 block_scan(uint2 v, uint2& total,
                                            uint2* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kWarps = kN / 32;
  uint2 inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t x = __shfl_up_sync(0xffffffffu, inc.x, d);
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc.y, d);
    if (lane >= d) {
      inc.x += x;
      inc.y += y;
    }
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint2 w = lane < kWarps ? warp_sums[lane] : make_uint2(0u, 0u);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t x = __shfl_up_sync(0xffffffffu, w.x, d);
      const uint32_t y = __shfl_up_sync(0xffffffffu, w.y, d);
      if (lane >= d) {
        w.x += x;
        w.y += y;
      }
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const uint2 before = warp == 0 ? make_uint2(0u, 0u) : warp_sums[warp - 1];
  total = warp_sums[kWarps - 1];
  const uint2 ex = make_uint2(before.x + inc.x - v.x, before.y + inc.y - v.y);
  __syncthreads();  // warp_sums is reused by the next call
  return ex;
}

// member rank k of channel c (combined order) to its place: notify below
// the delivered count ds, then the new ring's window, then the spill window
__device__ __forceinline__ void put_sid(const Args& a, int64_t c, int64_t k,
                                        int32_t v, int64_t ds) {
  if (k < ds) {
    a.notify[c * a.max_notify + k] = v;
    return;
  }
  int64_t i = k - ds;
  if (a.ring) {
    if (i < a.W) {
      a.nr_sids[c * a.W + i] = v;
      return;
    }
    i -= a.W;
  }
  if (i < a.spill_cap) {
    const int64_t s = c * a.spill_cap + i;
    a.ss_vals[s] = v;
    a.ss_ch[s] = static_cast<int32_t>(c);
    a.ss_valid[s] = 1;
  }
}

// pair rank r of channel c (combined order) past its cap: the new ring's
// window, then the spill window
__device__ __forceinline__ void put_overflow_pair(const Args& a, int64_t c,
                                                  int64_t i, int32_t row,
                                                  int32_t t) {
  if (a.ring) {
    if (i < a.W) {
      a.nr_rows[c * a.W + i] = row;
      a.nr_tgts[c * a.W + i] = t;
      return;
    }
    i -= a.W;
  }
  if (i < a.spill_cap) {
    const int64_t s = c * a.spill_cap + i;
    a.ps_rows[s] = row;
    a.ps_ch[s] = static_cast<int32_t>(c);
    a.ps_tgts[s] = t;
    a.ps_valid[s] = 1;
  }
}

__device__ __forceinline__ int32_t cap_of(const int32_t* caps, int64_t c,
                                          int64_t limit) {
  const int32_t l = static_cast<int32_t>(limit);
  if (caps == nullptr) return l;
  const int32_t v = caps[c];
  return v < l ? v : l;
}

// ---- 1. count ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads) count_kernel(const Args a) {
  __shared__ uint2 warp_sums[kThreads / 32];
  const int64_t blocks = a.C * a.tiles;
  for (int64_t b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int64_t c = b / a.tiles;
    const int64_t p0 = (b - c * a.tiles) * kTile + threadIdx.x * kTileItems;
    uint32_t bits = flag_bits(a, c, p0);
    uint2 mine = make_uint2(__popc(bits), 0u);
    while (bits) {
      const int k = __ffs(bits) - 1;
      bits &= bits - 1;
      mine.y += static_cast<uint32_t>(
          members_of(a, c, __ldg(a.tgts + c * a.P + p0 + k)));
    }
    uint2 total;
    block_scan<kThreads>(mine, total, warp_sums);
    if (threadIdx.x == 0)
      a.tile_sums[b] = make_int2(static_cast<int32_t>(total.x),
                                 static_cast<int32_t>(total.y));
  }
}

// ---- 2. scan -----------------------------------------------------------

__global__ void __launch_bounds__(kScanThreads) scan_kernel(const Args a) {
  extern __shared__ int32_t tally[];  // B
  __shared__ uint2 warp_sums[kScanThreads / 32];
  const int64_t c = blockIdx.x;
  const int tid = threadIdx.x;
  const int32_t cap_p = cap_of(a.caps_p, c, a.max_pairs);
  const int32_t cap_n = cap_of(a.caps_n, c, a.max_notify);
  for (int64_t b = tid; b < a.B; b += kScanThreads) tally[b] = 0;
  if (c == 0 && tid == 0) {
    a.stats[kNStat * a.C] = 0;      // queued items
    a.stats[kNStat * a.C + 3] = 0;  // the line walk's counter
  }

  // tile offsets: each thread a run of consecutive tiles
  const int64_t per = (a.tiles + kScanThreads - 1) / kScanThreads;
  const int64_t t0 = tid * per;
  const int64_t t1 = t0 + per < a.tiles ? t0 + per : a.tiles;
  const int2* sums = a.tile_sums + c * a.tiles;
  uint2 run = make_uint2(0u, 0u);
  for (int64_t t = t0; t < t1; ++t) {
    const int2 s = sums[t];
    run.x += static_cast<uint32_t>(s.x);
    run.y += static_cast<uint32_t>(s.y);
  }
  uint2 total;
  uint2 at = block_scan<kScanThreads>(run, total, warp_sums);
  for (int64_t t = t0; t < t1; ++t) {
    a.tile_offs[c * a.tiles + t] = make_int2(static_cast<int32_t>(at.x),
                                             static_cast<int32_t>(at.y));
    const int2 s = sums[t];
    at.x += static_cast<uint32_t>(s.x);
    at.y += static_cast<uint32_t>(s.y);
  }
  const int32_t nfresh = static_cast<int32_t>(total.x);
  const uint32_t mtot = total.y;

  // the windows start empty
  for (int64_t i = tid; i < a.spill_cap; i += kScanThreads) {
    const int64_t s = c * a.spill_cap + i;
    a.ps_rows[s] = -1;
    a.ps_ch[s] = -1;
    a.ps_tgts[s] = -1;
    a.ps_valid[s] = 0;
    a.ss_vals[s] = -1;
    a.ss_ch[s] = -1;
    a.ss_valid[s] = 0;
  }
  int32_t nring = 0, pcount = 0, rsc = 0;
  if (a.ring) {
    const int32_t epoch = a.epochs[c];
    for (int64_t i = tid; i < a.W; i += kScanThreads) {
      const int64_t s = c * a.W + i;
      a.nr_rows[s] = -1;
      a.nr_tgts[s] = -1;
      a.nr_epochs[s] = epoch;
      a.nr_sids[s] = -1;
    }
    __syncthreads();
    // live ring pairs, in residence order, ahead of the fresh ones
    pcount = a.ring_pcount[c];
    for (int64_t w0 = 0; w0 < a.W; w0 += kScanThreads) {
      const int64_t w = w0 + tid;
      const bool live = w < a.W && w < pcount &&
                        a.ring_epochs[c * a.W + w] == epoch;
      uint2 n;
      const uint2 ex = block_scan<kScanThreads>(make_uint2(live, 0u), n,
                                                warp_sums);
      if (live) {
        const int32_t r = nring + static_cast<int32_t>(ex.x);
        const int32_t row = a.ring_rows[c * a.W + w];
        const int32_t t = a.ring_tgts[c * a.W + w];
        if (r < cap_p) {
          a.slots[c * a.max_pairs + r] = make_int2(row, t);
          if (a.B > 0) {
            const int32_t bid = broker_of(a, c, t < 0 ? 0 : t);
            if (bid >= 0 && bid < a.B) atomicAdd(&tally[bid], 1);
          }
        } else if (r - cap_p < a.W) {
          a.nr_rows[c * a.W + (r - cap_p)] = row;
          a.nr_tgts[c * a.W + (r - cap_p)] = t;
        }
      }
      nring += static_cast<int32_t>(n.x);
    }
    // resident ring sIDs ahead of the fresh members
    rsc = a.ring_scount[c];
    for (int64_t k = tid; k < rsc; k += kScanThreads) {
      const int32_t v = a.ring_sids[c * a.W + (k < a.W ? k : a.W - 1)];
      if (k < cap_n)
        a.notify[c * a.max_notify + k] = v;
      else if (k - cap_n < a.W)
        a.nr_sids[c * a.W + (k - cap_n)] = v;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const int32_t W = static_cast<int32_t>(a.W);
    const int32_t live = nring + nfresh;
    const int32_t dp = live < cap_p ? live : cap_p;
    const int32_t ps = static_cast<int32_t>(static_cast<uint32_t>(rsc) + mtot);
    const int32_t ds = ps < cap_n ? ps : cap_n;
    const int32_t ovs = ps - ds;
    a.stats[kDelivP * a.C + c] = dp;
    a.stats[kDelivS * a.C + c] = ds;
    a.stats[kProdS * a.C + c] = ps;
    a.stats[kNRing * a.C + c] = nring;
    a.stats[kCapP * a.C + c] = cap_p;
    a.stats[kSidBase * a.C + c] = rsc;
    if (a.ring) {
      const int32_t ov = live - dp;
      a.stats[kProdP * a.C + c] = pcount + nfresh;
      a.stats[kStale * a.C + c] = pcount - nring;
      a.stats[kRingP * a.C + c] = ov < W ? ov : W;
      a.stats[kRingS * a.C + c] = ovs < W ? ovs : W;
      a.stats[kOvP * a.C + c] = ov - W > 0 ? ov - W : 0;
      a.stats[kOvS * a.C + c] = ovs - W > 0 ? ovs - W : 0;
    } else {
      a.stats[kProdP * a.C + c] = nfresh;
      a.stats[kOvP * a.C + c] = nfresh - dp;
      a.stats[kOvS * a.C + c] = ovs;
    }
  }
  for (int64_t b = tid; b < a.B; b += kScanThreads)
    a.per_broker[c * a.B + b] = tally[b];
}

// ---- 3. scatter --------------------------------------------------------

__global__ void __launch_bounds__(kThreads) scatter_kernel(const Args a) {
  extern __shared__ int32_t tally[];  // B
  __shared__ uint2 warp_sums[kThreads / 32];
  const int64_t blocks = a.C * a.tiles;
  for (int64_t b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int64_t c = b / a.tiles;
    const int64_t p0 = (b - c * a.tiles) * kTile + threadIdx.x * kTileItems;
    const int2 sums = a.tile_sums[b];
    if (sums.x == 0) {  // no valid pair: only the ring-less mask, all 0
      if (!a.ring && p0 < a.P) {
        uint8_t* m = a.spill_mask + c * a.P + p0;
        if (a.vector_valid) {
          *reinterpret_cast<uint4*>(m) = make_uint4(0u, 0u, 0u, 0u);
        } else {
          for (int64_t k = 0; k < kTileItems && p0 + k < a.P; ++k) m[k] = 0;
        }
      }
      continue;  // the same for every thread of the block
    }
    for (int64_t i = threadIdx.x; i < a.B; i += kThreads) tally[i] = 0;
    const uint32_t bits = flag_bits(a, c, p0);
    const int32_t* tg = a.tgts + c * a.P + p0;
    uint2 mine = make_uint2(__popc(bits), 0u);
    for (uint32_t left = bits; left; left &= left - 1)
      mine.y += static_cast<uint32_t>(members_of(a, c, __ldg(tg + __ffs(left) - 1)));
    uint2 total;
    const uint2 ex = block_scan<kThreads>(mine, total, warp_sums);
    const int2 off = a.tile_offs[b];
    uint32_t fr = static_cast<uint32_t>(off.x) + ex.x;   // fresh pair rank
    uint32_t ms = static_cast<uint32_t>(off.y) + ex.y;   // fresh member rank
    const int32_t cap_p = stat_of(a, kCapP, c);
    const int32_t nring = stat_of(a, kNRing, c);
    const int64_t ds = stat_of(a, kDelivS, c);
    const int64_t sid_end = ds + (a.ring ? a.W : 0) + a.spill_cap;
    const int64_t sid_base = stat_of(a, kSidBase, c);
    uint32_t mask = 0u;  // ring-less: valid pairs past the cap
    for (uint32_t left = bits; left; left &= left - 1) {
      const int k = __ffs(left) - 1;
      const int32_t t = __ldg(tg + k);
      const int32_t row = __ldg(a.rows + c * a.P + p0 + k);
      const int32_t m = members_of(a, c, t);
      const int32_t r = nring + static_cast<int32_t>(fr);
      if (r < cap_p) {
        a.slots[c * a.max_pairs + r] = make_int2(row, t);
        if (a.B > 0) {
          const int32_t bid = broker_of(a, c, t < 0 ? 0 : t);
          if (bid >= 0 && bid < a.B) atomicAdd(&tally[bid], 1);
        }
      } else {
        put_overflow_pair(a, c, static_cast<int64_t>(r) - cap_p, row, t);
        mask |= 1u << k;
      }
      const int64_t k0 = sid_base + static_cast<int32_t>(ms);
      if (m > 0 && k0 < sid_end) {
        const int64_t n = m < sid_end - k0 ? m : sid_end - k0;
        if (m <= kSmall) {
          for (int64_t j = 0; j < n; ++j)
            put_sid(a, c, k0 + j, member_sid(a, c, t, j), ds);
        } else {
          const int32_t at = atomicAdd(a.stats + kNStat * a.C, 1);
          if (at < a.items_cap)
            a.items[at] = make_int4(static_cast<int32_t>(c), t, m,
                                    static_cast<int32_t>(k0));
        }
      }
      fr += 1u;
      ms += static_cast<uint32_t>(m);
    }
    if (!a.ring && p0 < a.P) {
      uint8_t* mp = a.spill_mask + c * a.P + p0;
      if (a.vector_valid) {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = ((mask >> (4 * q)) & 1u) | ((mask >> (4 * q + 1)) & 1u) << 8 |
                 ((mask >> (4 * q + 2)) & 1u) << 16 |
                 ((mask >> (4 * q + 3)) & 1u) << 24;
        *reinterpret_cast<uint4*>(mp) = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        for (int64_t k = 0; k < kTileItems && p0 + k < a.P; ++k)
          mp[k] = (mask >> k) & 1u;
      }
    }
    __syncthreads();
    for (int64_t i = threadIdx.x; i < a.B; i += kThreads)
      if (tally[i]) atomicAdd(a.per_broker + c * a.B + i, tally[i]);
    __syncthreads();  // tally is zeroed again by the next tile
  }
}

// ---- 4. write ----------------------------------------------------------

// notify's tail -1, the queued pairs' members (a block a pair), the totals
__device__ void fan_blocks(const Args& a, int64_t bid, int64_t nb) {
  const int tid = threadIdx.x;
  if (bid == 0 && tid == 0) {
    int32_t tp = 0, ts = 0;
    for (int64_t c = 0; c < a.C; ++c) {
      tp += stat_of(a, kOvP, c);
      ts += stat_of(a, kOvS, c);
    }
    a.stats[kNStat * a.C + 1] = tp;
    a.stats[kNStat * a.C + 2] = ts;
  }
  const int64_t gt = bid * kThreads + tid, gs = nb * kThreads;
  for (int64_t c = 0; c < a.C; ++c) {
    const int64_t ds = stat_of(a, kDelivS, c) > 0 ? stat_of(a, kDelivS, c) : 0;
    int32_t* row = a.notify + c * a.max_notify;
    if (a.vector_notify) {
      for (int64_t v = ds / 4 + gt; v < a.max_notify / 4; v += gs) {
        const int64_t k = 4 * v;
        if (k >= ds) {
          __stcs(reinterpret_cast<int4*>(row) + v, make_int4(-1, -1, -1, -1));
        } else {
          for (int64_t j = ds; j < k + 4; ++j) row[j] = -1;
        }
      }
    } else {
      for (int64_t k = ds + gt; k < a.max_notify; k += gs) __stcs(row + k, -1);
    }
  }
  const int32_t queued = a.stats[kNStat * a.C];
  const int64_t n = queued < a.items_cap ? queued : a.items_cap;
  for (int64_t it = bid; it < n; it += nb) {
    const int4 item = a.items[it];
    const int64_t c = item.x, k0 = item.w;
    const int64_t ds = stat_of(a, kDelivS, c);
    const int64_t end = ds + (a.ring ? a.W : 0) + a.spill_cap;
    const int64_t len = item.z < end - k0 ? item.z : end - k0;
    for (int64_t j = tid; j < len; j += kThreads)
      put_sid(a, c, k0 + j, member_sid(a, c, item.y, j), ds);
  }
}

// word w of the wire line of a pair (row, t) of channel c
__device__ __forceinline__ int32_t line_word(const Args& a, int64_t w,
                                             int32_t row, int32_t t,
                                             int32_t members,
                                             const int32_t* srow) {
  if (w == 0) return row;
  if (w == 1) return t;
  if (w == 2) return members;
  if (w == 3) return static_cast<int32_t>(a.payload_words);
  const int64_t s = w - 4;
  if (a.identity) return s == 0 ? (t < 0 ? 0 : t) : row;
  if (s < a.S) return srow == nullptr ? 0 : __ldg(srow + s);
  return row;
}

// the wire lines channel c delivered, clamped to its buffer
__device__ __forceinline__ int64_t live_lines(const Args& a, int64_t c) {
  const int64_t d = stat_of(a, kDelivP, c);
  return d < 0 ? 0 : (d > a.max_pairs ? a.max_pairs : d);
}

// the live lines of every channel, one flat index over them (channel 0's
// first), per_block lines at a time from the counter
__device__ void line_blocks(const Args& a, int span, int per_block) {
  __shared__ int32_t next;
  const int sub = threadIdx.x / span, u0 = threadIdx.x % span;
  const int64_t units = a.vector_lines ? a.width / 4 : a.width;
  int64_t total = 0;
  for (int64_t k = 0; k < a.C; ++k) total += live_lines(a, k);
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(a.stats + kNStat * a.C + 3, 1);
    __syncthreads();
    const int64_t L0 = static_cast<int64_t>(next) * per_block;
    __syncthreads();
    if (L0 >= total) return;
    const int64_t L = L0 + sub;
    if (sub >= per_block || L >= total) continue;
    int64_t c = 0, base = 0;
    while (L >= base + live_lines(a, c)) {
      base += live_lines(a, c);
      ++c;
    }
    const int64_t q = L - base;
    int32_t* line = a.payload + (c * a.max_pairs + q) * a.width;
    const int2 src = a.slots[c * a.max_pairs + q];
    const int32_t row = src.x, t = src.y;
    const int32_t members = a.identity ? 1 : members_of(a, c, t);
    const int32_t* srow =
        (a.identity || a.T == 0)
            ? nullptr
            : a.sids + (c * a.T + clamp_index(t, a.T)) * a.S;
    if (a.vector_lines) {
      for (int64_t u = u0; u < units; u += span)
        reinterpret_cast<int4*>(line)[u] = make_int4(
            line_word(a, 4 * u, row, t, members, srow),
            line_word(a, 4 * u + 1, row, t, members, srow),
            line_word(a, 4 * u + 2, row, t, members, srow),
            line_word(a, 4 * u + 3, row, t, members, srow));
    } else {
      for (int64_t u = u0; u < units; u += span)
        line[u] = line_word(a, u, row, t, members, srow);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    write_kernel(const Args a, int64_t fan_nb, int span, int per_block) {
  if (blockIdx.x < fan_nb)
    fan_blocks(a, blockIdx.x, fan_nb);
  else
    line_blocks(a, span, per_block);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned capped(int64_t blocks) {
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// The write kernel's grid, as ops.grid computes it: fan blocks (at least
// one, at most kFanBlocks, one a 1,024 words of notify) and line blocks
// (kLineBlocksPerSm an SM, fewer where the buffer holds fewer line blocks;
// per_block lines a block, span threads a line). out: fan, line, span,
// per_block.
void write_grid(int64_t channels, int64_t max_pairs, int64_t width,
                int64_t max_notify, bool vector, int64_t sms, int64_t* out) {
  const int64_t units = vector ? width / 4 : width;
  const int64_t span = units < kThreads ? (units > 0 ? units : 1) : kThreads;
  const int64_t per_block = kThreads / span;
  int64_t fan = (channels * max_notify + 4 * kThreads - 1) / (4 * kThreads);
  fan = fan < 1 ? 1 : (fan > kFanBlocks ? kFanBlocks : fan);
  const int64_t lines = channels * max_pairs;
  const int64_t line = (lines + per_block - 1) / per_block;
  const int64_t card = sms * kLineBlocksPerSm;
  out[0] = fan;
  out[1] = line < card ? line : card;
  out[2] = span;
  out[3] = per_block;
}

}  // namespace

// One deliver_all on the current stream: `args` (an Args) holds every
// array and size; the wrapper has checked shapes, types and contiguity.
// vector_valid needs P % 16 == 0 and valid (and a ring-less call's
// spill_mask) 16-B aligned, vector_lines
// width % 4 == 0 and payload aligned, vector_notify max_notify % 4 == 0
// and notify aligned (else the call is refused). Returns the first
// launch's cudaError_t that is not 0, or 0.
extern "C" int deliver_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  const auto st = static_cast<cudaStream_t>(stream);
  if (a.C <= 0 || a.P <= 0 || a.B < 0 || a.B > 12288 || a.W < 0 ||
      a.spill_cap < 0 || a.max_pairs < 0 || a.max_notify < 0 || a.sms <= 0 ||
      a.sms > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((a.vector_valid &&
       (a.P % 16 != 0 || !aligned16(a.valid) ||
        (!a.ring && !aligned16(a.spill_mask)))) ||
      (a.vector_lines && (a.width % 4 != 0 || !aligned16(a.payload))) ||
      (a.vector_notify && (a.max_notify % 4 != 0 || !aligned16(a.notify))))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(a.B) * sizeof(int32_t);
  cudaError_t e;
  if (smem > kSmemOptIn) {
    // the tally and the kernels' own shared memory pass the 48 KB a launch
    // gets without asking: ask for the tally's size
    e = cudaFuncSetAttribute(scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(scatter_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned tile_blocks = capped(a.C * a.tiles);
  count_kernel<<<tile_blocks, kThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<<<static_cast<unsigned>(a.C), kScanThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scatter_kernel<<<tile_blocks, kThreads, smem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  int64_t g[4];
  write_grid(a.C, a.max_pairs, a.width, a.max_notify, a.vector_lines != 0,
             a.sms, g);
  write_kernel<<<static_cast<unsigned>(g[0] + g[1]), kThreads, 0, st>>>(
      a, g[0], static_cast<int>(g[2]), static_cast<int>(g[3]));
  return static_cast<int>(cudaGetLastError());
}
