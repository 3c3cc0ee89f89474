// flash_decode: one-token GQA decode attention over a kv_len-masked cache,
// split over the cache (flash-decoding) inside one clustered launch.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py, flash_decode_kernel
//   (body _kernel), the Pallas TPU kernel behind models/attention.py
//   attn_decode (attn_impl="flash" there; on the card the port's
//   attn_decode always launches this kernel).
// Computes: for each (b, h), over the keys j < kv_len[b] of KV head h / G:
//   m = max_j s_j with s_j = scale * q[b,h] . k[b,h/G,j], l = sum_j e^(s_j-m),
//   acc = sum_j e^(s_j-m) v[b,h/G,j]; all float32 whatever the input type
//   (float32 or bfloat16), D in {16, 32, 64, 80, 128}. Where no key is
//   live: m = -inf, l = 0, acc = 0, and no NaN (the reference's empty-shard
//   contract). The normalised entry writes acc / l (0 where l = 0) in q's
//   type instead of (acc, m, l).
// Bound on the H100: the bytes. Each live K/V row is read once (2*D*bytes
//   per key and KV head); the arithmetic is 4*D*G operations per key, a
//   third of what the CUDA cores' float32 rate allows at G = 6 and the
//   memory rate. PV stays on the CUDA cores in float32: the partials are
//   held to 2e-5 + 1e-5 relative, which P rounded to bf16 for the tensor
//   cores would break. QK^T in bf16 goes to the tensor cores, where bf16 x
//   bf16 products are exact and summed in float32, as on the CUDA cores:
//   there each of a head's lanes widens every K element it reads, one
//   integer operation a multiply-add, and on an H100 the same ring with
//   QK^T on the CUDA cores took 1.4x as long at the serve decode and 1.65x
//   at a 32,768-key cache (tools/compare_checkouts.py).
// Design (Hopper, sm_90a), one kernel for both types:
//   * One launch per call. The blocks of one (b, KV head) form a thread-
//     block cluster of n_split blocks (1, 2, 4, 8 or 16, chosen by the
//     wrapper from the SM count: about two blocks an SM, each with at least
//     two tiles). Each block takes its rank's share of the row's kv_len[b]
//     live keys, divided in whole tiles of 32 keys by the kernel itself
//     (key_share below), so a ragged batch keeps every block busy and no
//     key at or past kv_len[b] is read. The host never reads kv_len.
//   * K and V stay in their type in shared memory, in a ring of tiles (4
//     stages at D = 128 in bf16, 2 in float32). One lane of a producer warp
//     issues 1-D bulk copies (cp.async.bulk, mbarrier completion, no tensor
//     map) of each tile's live rows, a ring's depth ahead of the warps, and
//     an "empty" mbarrier a stage tells it when a tile has been read.
//   * A block has groups of warps; group w takes the tiles w, w + groups,
//     ... of the share, so several tiles are computed at once, and every
//     K/V byte comes from device memory once for all G heads. A warp holds
//     up to 8 heads. QK^T: in bf16 by mma.sync with the heads as A's rows
//     and K read by ldmatrix, in float32 on the CUDA cores; K lands in
//     padded blocks of 4 rows, so its reads meet no bank conflict. The
//     softmax runs in the mma's accumulator layout, 4 lanes a head, and P
//     passes through shared memory to PV, where lane j owns D / 32
//     consecutive output dims of each head of its warp, widened to float32
//     in registers.
//   * The split merge never leaves the cluster: each warp leaves its heads'
//     m, l and acc in its block's shared memory; after a cluster barrier the
//     warp holding head h in group 0 of rank h mod n_split reads every
//     group's and rank's partial of head h through distributed shared
//     memory, merges them by the algebra of ref.merge_partials (the empty
//     partial kept exact) and writes the output; a second cluster barrier
//     keeps the peers' shared memory alive until it has been read.
#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kTK = 32;             // keys per tile: one per lane
constexpr int kRingBytes = 69632;   // K and V tiles in flight a block
constexpr int kMinBlocks = 3;       // blocks an SM (so 16-block clusters fit)
constexpr int kMaxGroup = 32;       // query heads per KV head
constexpr int kMaxDevices = 64;
constexpr float kMasked = -1e30f;   // the TPU kernel's NEG_INF
constexpr uint64_t kWaitNs = 1000000000;   // 1 s: an mbarrier wait's limit

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// nanoseconds by the card's global timer
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t bar_try_wait(uint32_t bar,
                                                 uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// spin until the phase of the given parity has completed. A phase still
// open after kWaitNs by the global timer (a healthy wait lasts microseconds:
// one tile's bulk copy, or the tile before it being read) traps, so a fault
// in the ring's bookkeeping fails the launch instead of holding the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try_wait(bar, parity)) return;
  const uint64_t start = global_ns();
  while (!bar_try_wait(bar, parity))
    if (global_ns() - start > kWaitNs) __trap();
}

// bytes (a multiple of 16) from 16-byte-aligned global to shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// rank r's share of a row's live keys: whole tiles, the same number to each
// rank but the last busy one
__device__ __forceinline__ void key_share(int len, int rank, int n_split,
                                          int* begin, int* end) {
  const int tiles = (len + kTK - 1) / kTK;
  const int per = (tiles + n_split - 1) / n_split;
  *begin = min(rank * per * kTK, len);
  *end = min((rank + 1) * per * kTK, len);
}

// an output element from its float32 value
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  __device__ static float from_f32(float x) { return x; }
};
template <>
struct Elem<__nv_bfloat16> {
  __device__ static __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16_rn(x);
  }
};

// N consecutive elements of a shared row, widened (N * sizeof(T) is 2, 4, 8
// or 16 bytes, and the address is aligned to it)
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float* x) {
  constexpr int bytes = N * static_cast<int>(sizeof(T));
  uint32_t u[4] = {0, 0, 0, 0};
  if constexpr (bytes == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    u[0] = w.x, u[1] = w.y, u[2] = w.z, u[3] = w.w;
  } else if constexpr (bytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    u[0] = w.x, u[1] = w.y;
  } else if constexpr (bytes == 4) {
    u[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    u[0] = *reinterpret_cast<const uint16_t*>(p);
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = __uint_as_float(u[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
      x[i] = __uint_as_float(i % 2 ? u[i / 2] & 0xffff0000u : u[i / 2] << 16);
  }
}

// A warp holds up to 8 query heads and scores a tile's 32 keys in the
// layout of an m16n8k16 product's accumulator: lane 4 r + c holds head r's
// scores of the keys 4 (2 c + e) + i, i < 4, e < 2. In bf16 the product is
// mma.sync (bf16 x bf16 products are exact and summed in float32, as on the
// CUDA cores), with the heads as A's rows (the other 8 rows zero), K read
// by ldmatrix, n-tile i holding row i of every K block; in float32 each
// lane sums its 8 keys on the CUDA cores. PV stays on the CUDA cores, P in
// float32. K lands as 8 blocks of 4 rows, each block 16 bytes past a
// multiple of 128: the 8 rows that one ldmatrix (or the 4 lanes of a head)
// read fall on distinct bank groups (a row is a multiple of 32 bytes, so
// 4 rows are a multiple of 128 at every head dim), with 9 bulk copies a tile.
template <typename T, int D>
struct Plan {
  static constexpr int KSTEPS = D / 16;               // mma k-steps a row
  // PV dims of a lane, consecutive: 1, 2 or 4, so
  // that D / DL <= 32 lanes cover a row (D = 80: 20 lanes of 4)
  static constexpr int DL = D <= 32 ? 1 : D <= 64 ? 2 : 4;
  static_assert(D % 16 == 0 && D % DL == 0 && D / DL <= 32, "head dim");
  static constexpr int ROW = D * sizeof(T);           // bytes of a K/V row
  static constexpr int K_BLK = 4 * ROW + 16;          // 4 rows, padded
  static constexpr int K_BYTES = 8 * K_BLK;
  static constexpr int V_BYTES = kTK * ROW;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  // tiles in the ring: kRingBytes of K and V, 2 to 4 stages (4 at D = 128
  // in bf16, 2 in float32)
  static constexpr int STAGES_BY_BYTES = kRingBytes / STAGE_BYTES;
  static constexpr int STAGES =
      STAGES_BY_BYTES < 2 ? 2 : (STAGES_BY_BYTES > 4 ? 4 : STAGES_BY_BYTES);
  static constexpr int RING_OFF = 128;                // after the mbarriers
  // then per (group, head) p (32 floats); once every tile has been read,
  // the partials acc (D floats a slot), m and l take the ring's place, so
  // that three blocks fit on an SM
  static constexpr int P_OFF = RING_OFF + STAGES * STAGE_BYTES;
  static size_t bytes(int slots) {
    return P_OFF + static_cast<size_t>(slots) * kTK * sizeof(float);
  }
};

// The merge of head h's partials (slot w * G + h of every group w in every
// rank's shared memory, read through distributed shared memory) by the
// algebra of ref.merge_partials, the empty partial kept exact; writes output
// row `row`: acc / l in T (0 where l = 0) when `normalized`, else acc, m, l.
template <typename T, int D>
__device__ __forceinline__ void merge_head(int h, int g, int groups, int lane,
                                           float* m_s, float* l_s,
                                           float* acc_s, int64_t row,
                                           void* out, float* m_out,
                                           float* l_out, int normalized) {
  constexpr int DL = Plan<T, D>::DL;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  float mm = -INFINITY;
  for (int r = 0; r < n_split; ++r) {
    const float* mr = cluster.map_shared_rank(m_s, r);
    for (int w = 0; w < groups; ++w) mm = fmaxf(mm, mr[w * g + h]);
  }
  const float m_safe = mm == -INFINITY ? 0.f : mm;
  float a[DL], ll = 0.f;
#pragma unroll
  for (int i = 0; i < DL; ++i) a[i] = 0.f;
  for (int r = 0; r < n_split; ++r) {
    const float* mr = cluster.map_shared_rank(m_s, r);
    const float* lr = cluster.map_shared_rank(l_s, r);
    const float* ar = cluster.map_shared_rank(acc_s, r);
    for (int w = 0; w < groups; ++w) {
      const int at = w * g + h;
      const float c = mr[at] == -INFINITY ? 0.f : expf(mr[at] - m_safe);
      ll += c * lr[at];
      if (lane * DL < D)
#pragma unroll
        for (int i = 0; i < DL; ++i) a[i] += c * ar[at * D + lane * DL + i];
    }
  }
  if (normalized) {
    const float inv = ll == 0.f ? 1.f : ll;
    T* o = static_cast<T*>(out) + row * D;
    if (lane * DL < D)
#pragma unroll
      for (int i = 0; i < DL; ++i)
        o[lane * DL + i] = Elem<T>::from_f32(a[i] / inv);
  } else {
    float* o = static_cast<float*>(out) + row * D;
    if (lane * DL < D)
#pragma unroll
      for (int i = 0; i < DL; ++i) o[lane * DL + i] = a[i];
    if (lane == 0) {
      m_out[row] = mm;
      l_out[row] = ll;
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// warps a group, heads a warp (the last warp may hold fewer) and groups a
// block: 8 heads a warp at most; two groups where one warp holds the whole
// group and the ring has 4 stages. The groups divide the stages, so the
// tile a stage held before tile t, t - S, was the same group's, which has
// read it: a consumer never waits on a stage's barrier two phases ahead of
// it (where the parity would pass early).
template <typename T, int D>
struct Layout {
  int gw, hpw, groups;
  explicit Layout(int g)
      : gw((g + 7) / 8), hpw((g + (g + 7) / 8 - 1) / ((g + 7) / 8)),
        groups((g + 7) / 8 == 1 && Plan<T, D>::STAGES == 4 ? 2 : 1) {}
  int threads() const { return 32 * (gw * groups + 1); }
};
constexpr int kMaxThreads = 32 * (4 + 1);     // G = 32: 4 warps + producer

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B for one m16n8k16 tile; A's rows 8-15 are zero
__device__ __forceinline__ void mma_rows8(float* d, uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// grid (n_split * B * KH): cluster c = (b, KV head), its block of rank r
// takes key_share(kv_len[b], r). A block has `groups` groups of gw warps and
// one producer warp; group w takes the tiles t = w, w + groups, ... of the
// share, and its warp j the query heads j * hpw ... of its KV head's group
// (HPW >= hpw is the compiled bound). out: (B, H, D) in T when
// `normalized`, else float32 acc with m_out, l_out.
template <typename T, int D, int HPW>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ kv_len, void* out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int heads, int kv_heads, int s_len, float scale,
                        int hpw, int groups, int normalized) {
  using P = Plan<T, D>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int S = P::STAGES, DL = P::DL, KSTEPS = P::KSTEPS;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = heads / kv_heads, gw = (g + hpw - 1) / hpw;
  const int slab = blockIdx.x / n_split;            // b * KH + kh
  const int b = slab / kv_heads, kh = slab % kv_heads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / gw, h0 = (warp % gw) * hpw;
  const int nh = min(hpw, g - h0);                  // this warp's heads

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int slots = g * groups;                     // (group, head) pairs
  float* ps = reinterpret_cast<float*>(smem + P::P_OFF);     // slots x 32
  float* acc_s = reinterpret_cast<float*>(smem + P::RING_OFF);  // slots x D
  float* m_s = acc_s + slots * D;                            // slots
  float* l_s = m_s + slots;                                  // slots
  auto full = [&](int s) { return base + 8 * s; };
  auto empty = [&](int s) { return base + 8 * (S + s); };
  auto k_at = [&](int s) { return base + P::RING_OFF + s * P::STAGE_BYTES; };

  const int len = min(max(kv_len[b], 0), s_len);
  int k_begin, k_end;
  key_share(len, rank, n_split, &k_begin, &k_end);
  const int n_tiles = (k_end - k_begin + kTK - 1) / kTK;
  const int64_t kv_base = static_cast<int64_t>(slab) * s_len * D;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), gw);     // the warps of the group that reads it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int consumers = gw * groups;
  float acc[HPW][DL], part_m = kMasked, part_l = 0.f;
  if (warp == consumers) {
    // the producer: tile t's live rows into stage t mod S once tile t - S
    // has been read, V in one bulk copy, K in its blocks of 4 rows
    if (lane == 0)
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S, k0 = k_begin + t * kTK;
        const int rows = min(kTK, k_end - k0);
        if (t >= S) bar_wait(empty(s), ((t / S) & 1) ^ 1);
        bar_expect(full(s), 2 * rows * P::ROW);
        const int64_t at = kv_base + static_cast<int64_t>(k0) * D;
        bulk_load(k_at(s) + P::K_BYTES, v + at, rows * P::ROW, full(s));
        for (int j = 0; 4 * j < rows; ++j)
          bulk_load(k_at(s) + j * P::K_BLK, k + at + 4 * j * D,
                    min(4, rows - 4 * j) * P::ROW, full(s));
      }
  } else {
    // head r = lane / 4 of the warp (a row past its heads reads its last
    // head's q and is never stored); in bf16 the A operand: k-columns
    // 2 (lane % 4) + {0, 1} and + 8 of each 16-column step, rows past the
    // warp's heads zero
    const int r = lane >> 2, c = lane & 3;
    const T* q_row = q + (static_cast<int64_t>(b) * heads + kh * g + h0 +
                          min(r, nh - 1)) * D;
    uint32_t a[KSTEPS][2];
    if constexpr (kBf16) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          a[ks][half] =
              r < nh ? *reinterpret_cast<const uint32_t*>(q_row + ks * 16 +
                                                          half * 8 + 2 * c)
                     : 0u;
    }
    // ldmatrix: lane i gives n-tile (i / 16) of a pair, k-half (i / 8) % 2,
    // column i % 8 of it: row i / 16 of K block i % 8
    const uint32_t lm_off = (lane & 7) * P::K_BLK + (lane >> 4) * P::ROW +
                            ((lane >> 3) & 1) * 16;

    float m = kMasked, l = 0.f;                   // head r's, over c's keys
#pragma unroll
    for (int u = 0; u < HPW; ++u)
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[u][i] = 0.f;
    float* p_rows = ps + (grp * g + h0) * kTK;    // nh x 32
    for (int t = grp; t < n_tiles; t += groups) {
      const int s = t % S, rows = min(kTK, k_end - k_begin - t * kTK);
      bar_wait(full(s), (t / S) & 1);
      const unsigned char* stage = smem + P::RING_OFF + s * P::STAGE_BYTES;
      const T* vs = reinterpret_cast<const T*>(stage + P::K_BYTES);
      // S = Q K^T: key 4 (2 c + e) + nt of head r in d[nt][e]
      float d[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[nt][e] = 0.f;
      if constexpr (kBf16) {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t bm[4];
            ldmatrix_x4(k_at(s) + np * 2 * P::ROW + ks * 32 + lm_off, bm);
            mma_rows8(d[2 * np], a[ks][0], a[ks][1], bm[0], bm[1]);
            mma_rows8(d[2 * np + 1], a[ks][0], a[ks][1], bm[2], bm[3]);
          }
      } else {
        // key 4 j + nt is row nt of K block j = 2 c + e
        const float4* q4 = reinterpret_cast<const float4*>(q_row);
        for (int x = 0; x < D / 4; ++x) {
          const float4 qq = __ldg(q4 + x);
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const float4 kk = *reinterpret_cast<const float4*>(
                  stage + (2 * c + e) * P::K_BLK + nt * P::ROW + 16 * x);
              d[nt][e] = fmaf(qq.x, kk.x, d[nt][e]);
              d[nt][e] = fmaf(qq.y, kk.y, d[nt][e]);
              d[nt][e] = fmaf(qq.z, kk.z, d[nt][e]);
              d[nt][e] = fmaf(qq.w, kk.w, d[nt][e]);
            }
        }
      }
      // online softmax of head r over the 4 lanes of its row
      float mx = kMasked;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live = 4 * (2 * c + e) + nt < rows;
          d[nt][e] = live ? d[nt][e] * scale : kMasked;
          mx = fmaxf(mx, d[nt][e]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = 4 * (2 * c + e) + nt;
          const float p = key < rows ? expf(d[nt][e] - m_new) : 0.f;
          sum += p;
          if (r < nh) p_rows[r * kTK + key] = p;
        }
      l = l * corr + sum;
      m = m_new;
#pragma unroll
      for (int u = 0; u < HPW; ++u) {
        const float cu = __shfl_sync(0xffffffffu, corr, 4 * u);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[u][i] *= cu;
      }
      __syncwarp();
      // PV: lane owns dims lane * DL ... of every head of the warp; heads
      // past nh (HPW rounds up) are computed and never stored
      if (lane * DL < D) {
        const T* v_col = vs + lane * DL;
        if (rows == kTK) {
#pragma unroll 2
          for (int j = 0; j < kTK; j += 4) {
            float4 pj[HPW];
#pragma unroll
            for (int u = 0; u < HPW; ++u)
              pj[u] = *reinterpret_cast<const float4*>(
                  p_rows + (u < nh ? u : 0) * kTK + j);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              float vx[DL];
              load_row<T, DL>(v_col + (j + x) * D, vx);
#pragma unroll
              for (int u = 0; u < HPW; ++u) {
                const float pw = x == 0 ? pj[u].x
                                 : x == 1 ? pj[u].y
                                 : x == 2 ? pj[u].z
                                          : pj[u].w;
#pragma unroll
                for (int i = 0; i < DL; ++i)
                  acc[u][i] = fmaf(pw, vx[i], acc[u][i]);
              }
            }
          }
        } else {
          for (int j = 0; j < rows; ++j) {
            float vx[DL];
            load_row<T, DL>(v_col + j * D, vx);
#pragma unroll
            for (int u = 0; u < HPW; ++u) {
              const float pw = p_rows[(u < nh ? u : 0) * kTK + j];
#pragma unroll
              for (int i = 0; i < DL; ++i)
                acc[u][i] = fmaf(pw, vx[i], acc[u][i]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty(s));
    }
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    part_m = m, part_l = l;
  }
  // every tile has arrived and been read: the ring takes the partials
  __syncthreads();
  if (warp < consumers) {
    // this warp's partials at slot grp * G + h0 + u
    const int r = lane >> 2, c = lane & 3;
    const float m = part_m, l = part_l;
    if (c == 0 && r < nh) {
      m_s[grp * g + h0 + r] = l == 0.f ? -INFINITY : m;
      l_s[grp * g + h0 + r] = l;
    }
#pragma unroll
    for (int u = 0; u < HPW; ++u)
      if (u < nh && lane * DL < D)
#pragma unroll
        for (int i = 0; i < DL; ++i)
          acc_s[(grp * g + h0 + u) * D + lane * DL + i] = acc[u][i];
  }
  cluster.sync();
  for (int u = 0; u < nh && grp == 0 && warp < consumers; ++u)
    if ((h0 + u) % n_split == rank)
      merge_head<T, D>(h0 + u, g, groups, lane, m_s, l_s, acc_s,
                          static_cast<int64_t>(b) * heads + kh * g + h0 + u,
                          out, m_out, l_out, normalized);
  cluster.sync();   // the peers' partials stay alive until they are read
}

// once per device and kernel (outside any CUDA-graph capture of later
// launches): the opt-in to the largest block's shared memory and to the
// non-portable cluster size 16
template <auto Kernel>
int configure(size_t bytes) {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) cudaGetLastError();  // portable sizes only
    done[dev] = true;
  }
  return 0;
}

// a launch's block: threads, shared memory, heads a warp, warp groups
struct Block {
  int threads;
  size_t smem;
  int hpw, groups;
};

cudaLaunchConfig_t config(cudaLaunchAttribute* attr, int64_t n_clusters,
                          int n_split, const Block& blk,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n_clusters * n_split));
  cfg.blockDim = dim3(blk.threads);
  cfg.dynamicSmemBytes = blk.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel and block for (T, D, G): heads a warp rounded up to 2, 4, 6
// or 8 for the compiled bound.
template <typename T, int D, typename Fn>
int dispatch(int g, Fn&& fn) {
  const Layout<T, D> lay(g);
  const Block blk{lay.threads(), Plan<T, D>::bytes(g * lay.groups), lay.hpw,
                  lay.groups};
  const size_t most = Plan<T, D>::bytes(kMaxGroup * 2);
  if (lay.hpw <= 2)
    return fn(flash_decode_kernel<T, D, 2>,
              configure<flash_decode_kernel<T, D, 2>>(most), blk);
  if (lay.hpw <= 4)
    return fn(flash_decode_kernel<T, D, 4>,
              configure<flash_decode_kernel<T, D, 4>>(most), blk);
  if (lay.hpw <= 6)
    return fn(flash_decode_kernel<T, D, 6>,
              configure<flash_decode_kernel<T, D, 6>>(most), blk);
  return fn(flash_decode_kernel<T, D, 8>,
            configure<flash_decode_kernel<T, D, 8>>(most), blk);
}

template <typename T, int D>
int clusters(int g, int n_split, int* count) {
  return dispatch<T, D>(g, [&](auto kernel, int configured, const Block& blk) {
    if (configured != 0) return configured;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(attr, 1, n_split, blk, nullptr);
    const cudaError_t r = cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
    if (r != cudaSuccess) {
      cudaGetLastError();      // leave no error for a later launch to report
      *count = 0;
    }
    return static_cast<int>(r);
  });
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* m, void* l, int batch, int heads, int kv_heads,
           int s_len, float scale, int n_split, int normalized,
           cudaStream_t stream) {
  const int64_t slabs = static_cast<int64_t>(batch) * kv_heads;
  if (slabs * n_split > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<T, D>(heads / kv_heads, [&](auto kernel, int configured,
                                              const Block& blk) {
    if (configured != 0) return configured;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(attr, slabs, n_split, blk, stream);
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int32_t*>(kv_len), out,
        static_cast<float*>(m), static_cast<float*>(l), heads, kv_heads,
        s_len, scale, blk.hpw, blk.groups, normalized));
  });
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* kv_len, void* out, void* m, void* l, int batch,
             int heads, int kv_heads, int s_len, float scale, int n_split,
             int normalized, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, kv_len, out, m, l, batch, heads, kv_heads, s_len, scale, n_split, normalized, stream);
    case 32: return launch<T, 32>(q, k, v, kv_len, out, m, l, batch, heads, kv_heads, s_len, scale, n_split, normalized, stream);
    case 64: return launch<T, 64>(q, k, v, kv_len, out, m, l, batch, heads, kv_heads, s_len, scale, n_split, normalized, stream);
    case 80: return launch<T, 80>(q, k, v, kv_len, out, m, l, batch, heads, kv_heads, s_len, scale, n_split, normalized, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, out, m, l, batch, heads, kv_heads, s_len, scale, n_split, normalized, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int clusters_d(int d, int g, int n_split, int* count) {
  switch (d) {
    case 16: return clusters<T, 16>(g, n_split, count);
    case 32: return clusters<T, 32>(g, n_split, count);
    case 64: return clusters<T, 64>(g, n_split, count);
    case 80: return clusters<T, 80>(g, n_split, count);
    case 128: return clusters<T, 128>(g, n_split, count);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a launch's threads and dynamic shared memory a block, for the launch
// floor's empty kernel (chip_smoke.py)
template <typename T>
int block_d(int d, int g, int* threads, int* smem) {
  auto take = [&](auto, int configured, const Block& blk) {
    *threads = blk.threads;
    *smem = static_cast<int>(blk.smem);
    return configured;
  };
  switch (d) {
    case 16: return dispatch<T, 16>(g, take);
    case 32: return dispatch<T, 32>(g, take);
    case 64: return dispatch<T, 64>(g, take);
    case 80: return dispatch<T, 80>(g, take);
    case 128: return dispatch<T, 128>(g, take);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool valid_split(int n_split) {
  return n_split == 1 || n_split == 2 || n_split == 4 || n_split == 8 ||
         n_split == 16;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v). q (B, H, D); k, v
// (B, KH, S, D); kv_len (B,) int32, read on the device only; all contiguous,
// k and v 16-byte aligned (the bulk copies). normalized = 1: out (B, H, D)
// in q's type, m and l unused; normalized = 0: out the float32 acc (B, H, D),
// m and l (B, H) float32. n_split in {1, 2, 4, 8, 16} blocks a cluster, one
// cluster per (b, KV head). Returns the launch's cudaError_t, or 0.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* kv_len,
                                   void* out, void* m, void* l, int batch,
                                   int heads, int kv_heads, int s_len,
                                   int head_dim, int dtype, float scale,
                                   int n_split, int normalized, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 ||
      heads / kv_heads > kMaxGroup || s_len <= 0 || !valid_split(n_split) ||
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(head_dim, q, k, v, kv_len, out, m, l, batch, heads,
                           kv_heads, s_len, scale, n_split, normalized, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, kv_len, out, m, l,
                                   batch, heads, kv_heads, s_len, scale,
                                   n_split, normalized, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The clusters of n_split blocks of G warps (and their shared memory) that
// fit on the current device at once, into *count; 0 where that cluster size
// is refused. Returns the query's cudaError_t (left cleared).
extern "C" int flash_decode_clusters(int head_dim, int dtype, int group,
                                     int n_split, int* count) {
  *count = 0;
  if (group <= 0 || group > kMaxGroup || !valid_split(n_split))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return clusters_d<float>(head_dim, group, n_split, count);
  if (dtype == 1)
    return clusters_d<__nv_bfloat16>(head_dim, group, n_split, count);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The threads and dynamic shared memory of a block of a launch with this
// head dim, dtype and group, into *threads and *smem. Returns 0 or the
// cudaError_t of the kernel's configuration.
extern "C" int flash_decode_block(int head_dim, int dtype, int group,
                                  int* threads, int* smem) {
  *threads = *smem = 0;
  if (group <= 0 || group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return block_d<float>(head_dim, group, threads, smem);
  if (dtype == 1)
    return block_d<__nv_bfloat16>(head_dim, group, threads, smem);
  return static_cast<int>(cudaErrorInvalidValue);
}
