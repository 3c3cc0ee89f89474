// flash_attention: causal or full GQA attention forward, online softmax.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_kernel (body _kernel), the Pallas TPU kernel behind
//   models/attention.py _sdpa (attn_impl="flash" there; on the card the
//   port's _sdpa always launches this kernel).
// Computes: out[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/G,j]) *
//   v[b,h/G,j] over the keys j < Sk (and j <= i when causal), G = H / KH.
//   q and out have Sq query rows, k and v their own Sk keys: Sk = Sq when
//   causal, any Sk when not (the encoder-decoder's cross-attention: Sq
//   decoder positions over Sk encoder frames).
//   Inputs float32 or bfloat16, scores, running max m, running sum l and
//   the PV accumulator in float32, output in the input type. A masked score
//   contributes p = 0, so a row with no live key keeps l = 0 and its output
//   is 0, as the TPU kernel's l == 0 -> 0 rule (kernel.py:61-65).
// Bound on the H100, at the two shapes the card launches (both bf16):
//   the serve prefill (B 8, H 12, KH 2, S 512, D 128, causal) needs 6.45
//   GFLOP of live products (0.0065 ms at 989 TFLOP/s) and 29.4 MB (0.0088
//   ms at 3.35 TB/s); the scorer (B 16,384, S 10) needs 1.17 GB (0.35 ms)
//   and almost no products. Bytes bound both: the kernel must read each
//   K/V row once for all G heads of its KV head, and keep the products off
//   the critical path.
// bf16 design (Hopper: wgmma, TMA, mbarriers, sm_90a):
//   * GQA-packed query tiles. q is (B, H, S, D) with h = kh * G + g, so the
//     G heads of KV head kh are one contiguous (G*S, D) slab; a tile is 64
//     rows of a slab (row r is query position r mod S) and reads the slab's
//     K/V once for all of its rows. At the scorer a tile is one (b, kh): 60
//     rows and 10 keys; at the serve prefill a tile lies inside one head.
//     Causal tiles read keys up to the largest position among their rows.
//   * Both products on the tensor cores, bf16 in and float32 out:
//     S = Q K^T by wgmma with Q and K from shared memory, O += P V with P
//     from registers (the score accumulator rounded to bf16, unnormalised,
//     after the online-softmax update) and V from shared memory read
//     MN-major. The key tile is 64 keys, or 16 when S <= 16.
//   * Asynchronous staging. One producer thread issues TMA loads of the Q
//     tile and of the K/V tiles into rings of shared-memory stages with
//     mbarrier completion; one consumer warpgroup computes. q and out are
//     3-D maps over (B*KH, G*S, D), k and v over (B*KH, S, D), so a box at
//     a slab's edge is zero-filled on load (a masked key's V row is 0, never
//     garbage) and clipped on store. The output is staged in shared memory
//     in the map's swizzled layout and written by a TMA store.
//   * Persistent blocks: two or three a SM (by occupancy) walk the tiles,
//     so one tile's loads overlap another's products; causal tiles are
//     walked longest first when S is a multiple of 64.
// Head dims 16, 32, 64, 80 and 128. At D = 80 (zamba2) the bf16 kernel runs
//   the D = 128 plan over tensor maps whose rows are 80 wide: TMA fills the
//   boxes' columns 80-127 with zeros on every load (so they add nothing to
//   Q K^T and give zero output columns) and clips them on the store, and
//   the scale is 80^-0.5 from the wrapper; nothing is padded in memory.
// float32 keeps the CUDA-core kernel below (products in float32 on the
//   CUDA cores, 32-row tiles per (b, h)): its 3e-5 tolerance rules out
//   TF32, and no path on the card launches float32 attention (the serving
//   and scorer configurations are bf16).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kTQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTK = 32;                     // keys per tile: one per lane

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return kTQ * D + kTK * (D + 4) + kTK * D + kWarps * kRowsPerWarp * kTK;
}

// One block per (b, h, tile of 32 query rows), a loop over tiles of 32 keys
// that stops at the causal diagonal. Q and each K/V tile are staged in
// shared memory (K rows padded to D + 4 floats: float4 reads without bank
// conflicts); each warp owns 8 query rows, lane j takes key j for the
// scores and output dims j, j + 32, ... for the PV product.
template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    f32_attention_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         int heads, int kv_heads, int s_len, int s_keys,
                         float scale, int causal) {
  constexpr int KP = D + 4;            // padded K row
  constexpr int DL = (D + 31) / 32;    // output dims per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kTQ x D
  float* ks = qs + kTQ * D;                     // kTK x KP
  float* vs = ks + kTK * KP;                    // kTK x D
  float* ps = vs + kTK * D;                     // kWarps x kRowsPerWarp x kTK

  const int bh = blockIdx.x;                    // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const int kh = h / (heads / kv_heads);
  const int q0 = blockIdx.y * kTQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t q_base = static_cast<int64_t>(bh) * s_len * D;
  const int64_t kv_base =
      (static_cast<int64_t>(b) * kv_heads + kh) * s_keys * D;

  for (int i = tid; i < kTQ * D; i += blockDim.x) {
    const int r = q0 + i / D;
    qs[i] = r < s_len ? q[q_base + static_cast<int64_t>(r) * D + i % D] : 0.f;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }
  const float* q_rows = qs + warp * kRowsPerWarp * D;
  float* p_rows = ps + warp * kRowsPerWarp * kTK;
  const int row0 = q0 + warp * kRowsPerWarp;
  // the keys any row of this block sees: up to the diagonal when causal
  const int kv_end = causal ? min(s_len, q0 + kTQ) : s_keys;
  for (int k0 = 0; k0 < kv_end; k0 += kTK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kTK * D; i += blockDim.x) {
      const int r = i / D, d = i % D, key = k0 + r;
      const int64_t at = kv_base + static_cast<int64_t>(key) * D + d;
      ks[r * KP + d] = key < s_keys ? k[at] : 0.f;
      vs[i] = key < s_keys ? v[at] : 0.f;
    }
    __syncthreads();
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float* k_row = ks + lane * KP;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(k_row + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(q_rows + r * D + d);
        s[r] += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
      }
    }
    const int key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const bool live = key < s_keys && (!causal || key <= row0 + r);
      const float sc = live ? s[r] * scale : kMasked;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = live ? expf(sc - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= corr;
      p_rows[r * kTK + lane] = p;
    }
    __syncwarp();
    for (int j = 0; j < kTK; ++j) {
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = p_rows[r * kTK + j];
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] += p * vv[i];
      }
    }
    __syncwarp();  // p_rows is rewritten by the next tile
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= s_len) continue;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const int d = lane + 32 * i;
      if (d < D)
        out[q_base + static_cast<int64_t>(row) * D + d] =
            l[r] == 0.f ? 0.f : acc[r][i] / l[r];
    }
  }
}


// ---------------------------------------------------------------------------
// bfloat16: Hopper
// ---------------------------------------------------------------------------

constexpr int kRows = 64;                   // query rows of a tile: wgmma M
constexpr int kConsumers = 128;             // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kKvStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

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

// spin until the phase of the given parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared memory -> wgmma descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode in the top two bits
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// D (64 x 16, float32) (+)= A (64 x 16, bf16, shared memory, K-major)
//   * B (16 x 16, bf16, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, float32) (+)= A (64 x 16, bf16, shared memory, K-major)
//   * B (16 x 64, bf16, shared memory, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 16, float32) += A (64 x 16, bf16, registers)
//   * B (16 x 16, bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7" "}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 32, float32) += A (64 x 16, bf16, registers)
//   * B (16 x 32, bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15" "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, bf16, registers)
//   * B (16 x 64, bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31" "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (N == 16) wgmma_ss_n16(d, a, b, accumulate);
  else wgmma_ss_n64(d, a, b, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else wgmma_rs_n64(d, a, b);
}

// Shared-memory plan of one block at head dim D and key tile BN. Every
// tile is stored as boxes BOX elements (SW bytes, the swizzle span) wide:
// one box a row for D <= 64, two for D = 128.
template <int D, int BN>
struct Plan {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;
  static constexpr int BOX = SW / 2;
  static constexpr int BOXES = D / BOX;
  static constexpr uint64_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  static constexpr int ON = D < 64 ? D : 64;  // output columns a wgmma
  static constexpr int OC = D / ON;
  // two Q stages for short tiles (the next tile's Q is in flight while
  // this one computes), one where a tile runs over several key tiles
  static constexpr int Q_STAGES = BN == 16 ? 2 : 1;
  static constexpr int Q_BYTES = kRows * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + Q_STAGES * Q_BYTES;
  static constexpr int V_OFF = K_OFF + kKvStages * KV_BYTES;
  static constexpr int O_OFF = V_OFF + kKvStages * KV_BYTES;
  static constexpr int BAR_OFF = O_OFF + Q_BYTES;
  // barriers: q_full, q_empty per Q stage, kv_full, kv_empty per K/V stage;
  // 1 KB of slack aligns the tiles to the 1024-byte swizzle pattern
  static constexpr int SMEM = BAR_OFF + 16 * (Q_STAGES + kKvStages) + 1024;
  static constexpr int MIN_BLOCKS = BN == 16 ? 3 : 2;
};

struct Tile {
  int slab, row0, n_kv;
};

// Tile t of the walk: its slab (b * KH + kh), first row in the slab and
// number of key tiles. With a causal mask and S a multiple of 64, tiles
// are taken by diagonal band, the longest band first, and within a band
// the G heads of one slab side by side (they share K/V in L2).
__device__ __forceinline__ Tile tile_at(int t, int n_slabs, int tiles, int gs,
                                        int s_len, int s_keys, int g,
                                        int causal, int bn) {
  int slab, m;
  if (causal && s_len % kRows == 0) {
    const int per_head = s_len / kRows, band = n_slabs * g;
    const int rest = t % band;
    slab = rest / g;
    m = (rest % g) * per_head + per_head - 1 - t / band;
  } else {
    slab = t / tiles;
    m = t % tiles;
  }
  const int row0 = m * kRows;
  int kv_end = s_keys;
  if (causal) {
    const int last = min(row0 + kRows, gs) - 1;
    if (row0 / s_len == last / s_len) kv_end = last % s_len + 1;
  }
  return Tile{slab, row0, (kv_end + bn - 1) / bn};
}

template <int D, int BN>
__global__ void __launch_bounds__(kThreads, Plan<D, BN>::MIN_BLOCKS)
    bf16_attention_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_o,
                          int n_slabs, int tiles, int gs, int s_len,
                          int s_keys, int g, float scale_log2, int causal) {
  using P = Plan<D, BN>;
  constexpr int SW = P::SW;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + P::BAR_OFF;
  const auto q_full = [&](int s) { return bars + 8 * s; };
  const auto q_empty = [&](int s) { return bars + 8 * (P::Q_STAGES + s); };
  const auto kv_full = [&](int s) {
    return bars + 8 * (2 * P::Q_STAGES + s);
  };
  const auto kv_empty = [&](int s) {
    return bars + 8 * (2 * P::Q_STAGES + kKvStages + s);
  };
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < P::Q_STAGES; ++s) {
      bar_init(q_full(s), 1);
      bar_init(q_empty(s), kConsumers);
    }
    for (int s = 0; s < kKvStages; ++s) {
      bar_init(kv_full(s), 1);
      bar_init(kv_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = n_slabs * tiles;

  if (tid >= kConsumers) {
    // producer: one thread keeps the rings full
    if (tid != kConsumers) return;
    int qs = 0, qph = 0, ks = 0, kph = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      const Tile tl = tile_at(t, n_slabs, tiles, gs, s_len, s_keys, g, causal,
                              BN);
      bar_wait(q_empty(qs), qph ^ 1);
      bar_expect(q_full(qs), P::Q_BYTES);
      const uint32_t qd = base + P::Q_OFF + qs * P::Q_BYTES;
      for (int c = 0; c < P::BOXES; ++c)
        tma_load(qd + c * kRows * SW, &map_q, q_full(qs), c * P::BOX,
                 tl.row0, tl.slab);
      if (++qs == P::Q_STAGES) qs = 0, qph ^= 1;
      for (int j = 0; j < tl.n_kv; ++j) {
        bar_wait(kv_empty(ks), kph ^ 1);
        bar_expect(kv_full(ks), 2 * P::KV_BYTES);
        const uint32_t kd = base + P::K_OFF + ks * P::KV_BYTES;
        const uint32_t vd = base + P::V_OFF + ks * P::KV_BYTES;
        for (int c = 0; c < P::BOXES; ++c) {
          tma_load(kd + c * BN * SW, &map_k, kv_full(ks), c * P::BOX, j * BN,
                   tl.slab);
          tma_load(vd + c * BN * SW, &map_v, kv_full(ks), c * P::BOX, j * BN,
                   tl.slab);
        }
        if (++ks == kKvStages) ks = 0, kph ^= 1;
      }
    }
    return;
  }

  // consumers: thread tid holds rows r_lo and r_lo + 8 of the tile, and
  // in each 8-column block of an accumulator the columns 2 * (tid % 4) + {0, 1}
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = warp * 16 + lane / 4, col = 2 * (lane % 4);
  int qs = 0, qph = 0, ks = 0, kph = 0;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const Tile tl = tile_at(t, n_slabs, tiles, gs, s_len, s_keys, g, causal,
                            BN);
    const int pos[2] = {(tl.row0 + r_lo) % s_len, (tl.row0 + r_lo + 8) % s_len};
    float o[P::OC][P::ON / 2], sc[BN / 2];
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < P::OC; ++c)
#pragma unroll
      for (int i = 0; i < P::ON / 2; ++i) o[c][i] = 0.f;
    bar_wait(q_full(qs), qph);
    const uint32_t qb = base + P::Q_OFF + qs * P::Q_BYTES;
    for (int j = 0; j < tl.n_kv; ++j) {
      bar_wait(kv_full(ks), kph);
      const uint32_t kb = base + P::K_OFF + ks * P::KV_BYTES;
      const uint32_t vb = base + P::V_OFF + ks * P::KV_BYTES;
      // S = Q K^T, 16 columns of D a step (32 bytes into a swizzled row)
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int box = kk * 32 / SW, at = kk * 32 % SW;
        wgmma_ss<BN>(sc,
                     smem_desc(qb + box * kRows * SW + at, 16, 8 * SW, P::MODE),
                     smem_desc(kb + box * BN * SW + at, 16, 8 * SW, P::MODE),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      if (j == tl.n_kv - 1) bar_arrive(q_empty(qs));  // Q is read for good

      // online softmax in base 2; a masked score is -inf and gives p = 0
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int key = j * BN + 8 * (i / 4) + col + (i % 2);
        const int h = (i / 2) % 2;
        const bool live = key < s_keys && (!causal || key <= pos[h]);
        sc[i] = live ? sc[i] * scale_log2 : -INFINITY;
        mx[h] = fmaxf(mx[h], sc[i]);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sc[i] = exp2f(sc[i] - m[(i / 2) % 2]);
        l[(i / 2) % 2] += sc[i];
      }
#pragma unroll
      for (int c = 0; c < P::OC; ++c)
#pragma unroll
        for (int i = 0; i < P::ON / 2; ++i) o[c][i] *= corr[(i / 2) % 2];
      // the score accumulator's layout is the A operand's: keys 16 kk ..
      // 16 kk + 15 are registers 8 kk .. 8 kk + 7
      uint32_t a[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

      // O += P V, V read MN-major (its rows are keys, D contiguous)
#pragma unroll
      for (int c = 0; c < P::OC; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int c = 0; c < P::OC; ++c)
          wgmma_rs<P::ON>(o[c], a[kk],
                          smem_desc(vb + c * BN * SW + kk * 16 * SW, BN * SW,
                                    8 * SW, P::MODE));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int c = 0; c < P::OC; ++c) fence_regs(o[c]);
      bar_arrive(kv_empty(ks));
      if (++ks == kKvStages) ks = 0, kph ^= 1;
    }

    // epilogue: normalise, stage in the map's swizzled layout, TMA store
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = l[h] == 0.f ? 0.f : 1.f / l[h];
    }
    if (tid == 0)  // the previous tile's store has read the stage
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
#pragma unroll
    for (int c = 0; c < P::OC; ++c)
#pragma unroll
      for (int i = 0; i < P::ON / 2; i += 2) {
        const int h = (i / 2) % 2, row = r_lo + 8 * h;
        const int dcol = c * P::ON + 8 * (i / 4) + col;
        uint32_t off = (dcol / P::BOX) * kRows * SW + row * SW +
                       (dcol % P::BOX) * 2;
        off ^= (off >> 3) & (SW - 16);  // the TMA swizzle of SW bytes
        *reinterpret_cast<uint32_t*>(smem + P::O_OFF + off) =
            pack_bf16(o[c][i] * inv[h], o[c][i + 1] * inv[h]);
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (tid == 0) {
      for (int c = 0; c < P::BOXES; ++c)
        tma_store(&map_o, base + P::O_OFF + c * kRows * SW, c * P::BOX,
                  tl.row0, tl.slab);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (++qs == P::Q_STAGES) qs = 0, qph ^= 1;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// What a kernel instantiation needs once per device, on its first launch
// there (outside any CUDA-graph capture of later launches): the opt-in to
// more than 48 KB of dynamic shared memory, and the blocks that fit on the
// device at once (the persistent kernel's grid).
template <typename Kernel>
int setup(int (&resident)[kMaxDevices], Kernel kernel, int threads,
          size_t bytes, int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    if (bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = per_sm * sms;
  }
  *blocks = resident[dev];
  return 0;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               int batch, int heads, int kv_heads, int s_len, int s_keys,
               float scale, int causal, cudaStream_t stream) {
  static int resident[kMaxDevices];
  const size_t bytes = smem_floats<D>() * sizeof(float);
  int blocks = 0;  // the grid follows the shape here
  const int e = setup(resident, f32_attention_kernel<D>, kWarps * 32, bytes,
                      &blocks);
  if (e != 0) return e;
  const int64_t rows = static_cast<int64_t>(batch) * heads;
  const int q_tiles = (s_len + kTQ - 1) / kTQ;
  if (rows > 0x7fffffff || q_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows), q_tiles);
  f32_attention_kernel<D><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), heads, kv_heads,
      s_len, s_keys, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; the library links only the
// runtime, so it is looked up through the runtime once
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (slabs, rows, d) bf16 tensor in boxes of (1, box_rows, SW / 2) of the
// plan of width D >= d, swizzled; rows past the slab's end and columns past
// d read as zeros and are not written
template <int D, int BN>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* p, int64_t slabs,
            int64_t rows, int box_rows, int d) {
  using P = Plan<D, BN>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(slabs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(P::BOX),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            P::SWIZZLE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 launch's shape: threads a block, dynamic shared memory, and the
// persistent grid (the (query, head) tiles, at most the blocks resident on
// the device at once).
struct LaunchShape {
  int threads, smem, grid;
};

// the plan of width D over tensors whose rows are d <= D wide; with
// ``shape`` given, its launch shape is written there and nothing launched
template <int D, int BN>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int batch, int heads, int kv_heads, int s_len, int s_keys,
                int d, float scale, int causal, cudaStream_t stream,
                LaunchShape* shape) {
  using P = Plan<D, BN>;
  static int resident[kMaxDevices];
  int blocks = 0;
  const int e = setup(resident, bf16_attention_kernel<D, BN>, kThreads,
                      P::SMEM, &blocks);
  if (e != 0) return e;
  const int g = heads / kv_heads;
  const int64_t slabs = static_cast<int64_t>(batch) * kv_heads;
  const int64_t gs = static_cast<int64_t>(g) * s_len;
  const int64_t tiles = (gs + kRows - 1) / kRows;
  if (gs > INT_MAX || slabs * tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = slabs * tiles;
  const int grid = static_cast<int>(total < blocks ? total : blocks);
  if (shape != nullptr) {
    *shape = {kThreads, P::SMEM, grid};
    return 0;
  }
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap mq, mk, mv, mo;
  if (!encode<D, BN>(fn, &mq, q, slabs, gs, kRows, d) ||
      !encode<D, BN>(fn, &mk, k, slabs, s_keys, BN, d) ||
      !encode<D, BN>(fn, &mv, v, slabs, s_keys, BN, d) ||
      !encode<D, BN>(fn, &mo, out, slabs, gs, kRows, d))
    return static_cast<int>(cudaErrorInvalidValue);
  bf16_attention_kernel<D, BN><<<grid, kThreads, P::SMEM, stream>>>(
      mq, mk, mv, mo, static_cast<int>(slabs), static_cast<int>(tiles),
      static_cast<int>(gs), s_len, s_keys, g, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

// bf16 at D = 80 takes the D = 128 plan (the TMA maps are 80 wide); the key
// tile is 16 keys where Sk <= 16. ``shape`` as in launch_bf16 (bf16 only)
template <int D>
int launch_d(int dtype, const void* q, const void* k, const void* v,
             void* out, int batch, int heads, int kv_heads, int s_len,
             int s_keys, float scale, int causal, cudaStream_t stream,
             LaunchShape* shape) {
  constexpr int DP = D == 80 ? 128 : D;
  if (dtype == 0)
    return shape != nullptr
               ? static_cast<int>(cudaErrorInvalidValue)
               : launch_f32<D>(q, k, v, out, batch, heads, kv_heads, s_len,
                               s_keys, scale, causal, stream);
  if (s_keys <= 16)
    return launch_bf16<DP, 16>(q, k, v, out, batch, heads, kv_heads, s_len,
                               s_keys, D, scale, causal, stream, shape);
  return launch_bf16<DP, 64>(q, k, v, out, batch, heads, kv_heads, s_len,
                             s_keys, D, scale, causal, stream, shape);
}

int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int heads, int kv_heads, int s_len, int s_keys, int head_dim,
           int dtype, float scale, int causal, cudaStream_t st,
           LaunchShape* shape) {
  if (batch <= 0 || heads <= 0 || s_len <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || (dtype != 0 && dtype != 1) ||
      s_keys <= 0 || (causal && s_keys != s_len))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (head_dim) {
    case 16: return launch_d<16>(dtype, q, k, v, out, batch, heads, kv_heads, s_len, s_keys, scale, causal, st, shape);
    case 32: return launch_d<32>(dtype, q, k, v, out, batch, heads, kv_heads, s_len, s_keys, scale, causal, st, shape);
    case 64: return launch_d<64>(dtype, q, k, v, out, batch, heads, kv_heads, s_len, s_keys, scale, causal, st, shape);
    case 80: return launch_d<80>(dtype, q, k, v, out, batch, heads, kv_heads, s_len, s_keys, scale, causal, st, shape);
    case 128: return launch_d<128>(dtype, q, k, v, out, batch, heads, kv_heads, s_len, s_keys, scale, causal, st, shape);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, out (B, H, Sq, D); k, v (B, KH, Sk,
// D), Sk >= 1, and Sk = Sq when causal; all contiguous, and in bfloat16
// 16-byte aligned (TMA). Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int heads, int kv_heads, int s_len,
                                      int s_keys, int head_dim, int dtype,
                                      float scale, int causal, void* stream) {
  return launch(q, k, v, out, batch, heads, kv_heads, s_len, s_keys, head_dim,
                dtype, scale, causal, static_cast<cudaStream_t>(stream),
                nullptr);
}

// The shape flash_attention_launch gives the bf16 kernel at these sizes:
// threads a block, dynamic shared memory and grid, for timing the empty
// kernel on the same launch. Returns a cudaError_t.
extern "C" int flash_attention_block(int batch, int heads, int kv_heads,
                                     int s_len, int s_keys, int head_dim,
                                     int causal, int* threads, int* smem,
                                     int* grid) {
  LaunchShape shape = {0, 0, 0};
  const int e = launch(nullptr, nullptr, nullptr, nullptr, batch, heads,
                       kv_heads, s_len, s_keys, head_dim, 1, 1.0f, causal,
                       nullptr, &shape);
  *threads = shape.threads;
  *smem = shape.smem;
  *grid = shape.grid;
  return e;
}
