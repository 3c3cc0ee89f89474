// flash_attention: causal or full GQA attention forward, online softmax.
//
// Replaces: src/repro/kernels/flash_attention/kernel.py,
//   flash_attention_kernel (body _kernel), the Pallas TPU kernel behind
//   models/attention.py _sdpa (attn_impl="flash" there; on the card the
//   port's _sdpa always launches this kernel).
// Computes: out[b,h,i] = sum_j softmax_j(scale * q[b,h,i] . k[b,h/G,j]) *
//   v[b,h/G,j] over the keys j < S (and j <= i when causal), G = H / KH.
//   Inputs float32 or bfloat16, accumulation in float32 throughout (scores,
//   running max m, running sum l, the PV accumulator), output in the input
//   type. A masked score is -1e30 and contributes p = 0, so a row with no
//   live key keeps l = 0 and its output is 0, as the TPU kernel's
//   l == 0 -> 0 rule (kernel.py:61-65).
// Bound on the H100: at the serving shapes (S = 512, D = 128) the
//   operations, 4*S*S*D/2 per causal (b, h) against 989 TFLOP/s of bf16
//   tensor cores; at the scorer's S = 10 the bytes (q, k, v read once,
//   out written once) against 3.35 TB/s. This first kernel does its
//   products on the CUDA cores in float32 (67 TFLOP/s), so it cannot reach
//   the tensor-core bound; wgmma, TMA and warp specialisation are later work.
// Design: one block per (b, h, tile of 32 query rows); the TPU kernel's
//   sequential kv grid axis becomes a loop inside the block over tiles of 32
//   keys, which stops at the causal diagonal (no tile above it is read). The
//   block stages its Q tile once and each K/V tile in shared memory as
//   float32 (K rows padded to D + 4 floats: float4 reads without bank
//   conflicts). Each of the 4 warps owns 8 query rows; for the scores lane j
//   takes key j (its K row against the 8 q rows, read as broadcasts), the
//   row max and sum are warp shuffles, and for the PV product lane j owns
//   output dims j, j + 32, ... The ragged end of S is masked here (keys and
//   rows past S), so the caller pads nothing. KV head h / G is read by the
//   blocks of its G query heads.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kTQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kTK = 32;                     // keys per tile: one per lane
constexpr float kMasked = -1e30f;           // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int heads, int kv_heads, int s_len, float scale,
                           int causal) {
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
      (static_cast<int64_t>(b) * kv_heads + kh) * s_len * D;

  for (int i = tid; i < kTQ * D; i += blockDim.x) {
    const int r = q0 + i / D;
    qs[i] = r < s_len ? to_f32(q[q_base + static_cast<int64_t>(r) * D +
                                 i % D])
                      : 0.f;
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
  const int kv_end = causal ? min(s_len, q0 + kTQ) : s_len;
  for (int k0 = 0; k0 < kv_end; k0 += kTK) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < kTK * D; i += blockDim.x) {
      const int r = i / D, d = i % D, key = k0 + r;
      const int64_t at = kv_base + static_cast<int64_t>(key) * D + d;
      ks[r * KP + d] = key < s_len ? to_f32(k[at]) : 0.f;
      vs[i] = key < s_len ? to_f32(v[at]) : 0.f;
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
      const bool live = key < s_len && (!causal || key <= row0 + r);
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
        store(out + q_base + static_cast<int64_t>(row) * D + d,
              l[r] == 0.f ? 0.f : acc[r][i] / l[r]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int heads, int kv_heads, int s_len, float scale, int causal,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  // opt in to more than 48 KB of shared memory once per instantiation
  // (outside any CUDA-graph capture of later launches)
  static bool configured = false;
  if (bytes > 48 * 1024 && !configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int64_t rows = static_cast<int64_t>(batch) * heads;
  const int q_tiles = (s_len + kTQ - 1) / kTQ;
  if (rows > 0x7fffffff || q_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows), q_tiles);
  flash_attention_kernel<T, D><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), heads, kv_heads, s_len,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* out,
             int batch, int heads, int kv_heads, int s_len, float scale,
             int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, batch, heads, kv_heads, s_len, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, batch, heads, kv_heads, s_len, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, batch, heads, kv_heads, s_len, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, batch, heads, kv_heads, s_len, scale, causal, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, out (B, H, S, D); k, v (B, KH, S, D);
// all contiguous. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int heads, int kv_heads, int s_len,
                                      int head_dim, int dtype, float scale,
                                      int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || s_len <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(head_dim, q, k, v, out, batch, heads, kv_heads,
                           s_len, scale, causal, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, out, batch, heads,
                                   kv_heads, s_len, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
