// flash_decode: one-token GQA decode attention over a kv_len-masked cache,
// split over the cache (flash-decoding), returning unnormalised partials.
//
// Replaces: src/repro/kernels/flash_decode/kernel.py, flash_decode_kernel
//   (body _kernel), the Pallas TPU kernel behind models/attention.py
//   attn_decode (attn_impl="flash" there; on the card the port's
//   attn_decode always launches this kernel).
// Computes: for each (b, h), over the keys j < kv_len[b] of KV head h / G:
//   m = max_j s_j with s_j = scale * q[b,h] . k[b,h/G,j], l = sum_j e^(s_j-m),
//   acc = sum_j e^(s_j-m) v[b,h/G,j]; all float32 whatever the input type
//   (float32 or bfloat16). Where no key is live: m = -inf, l = 0, acc = 0,
//   and no NaN (the reference's empty-shard contract).
// Bound on the H100: the bytes. Each live K/V row is read once (2*D*bytes
//   per key and KV head); the arithmetic is 4*D*G operations per key, far
//   below the tensor cores' or even the CUDA cores' rate at G <= 32.
// Design: the TPU kernel walks the cache sequentially on one core; here
//   the cache is split. Kernel 1 runs one block per (b, KV head, split of
//   the cache), with one warp per query head of the group (G warps), so a
//   block stages each tile of 32 keys of K and V in shared memory once and
//   all G heads read it: every live K/V byte comes from device memory once.
//   A block reads no key at or past kv_len[b]; a split wholly past it writes
//   the empty partial without a load. Within a warp lane j scores key j,
//   the running max and sum are warp shuffles, and lane j owns output dims
//   j, j + 32, ... Kernel 2 merges each (b, h)'s splits by the log-sum-exp
//   algebra of ref.merge_partials into the partials over the whole cache.
//   The splits are chosen by the wrapper so that B * KH * splits fills the
//   132 SMs at the small batches of decoding.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTK = 32;                 // keys per tile: one per lane
constexpr float kMasked = -1e30f;       // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// partials of one split: (B, H, n_split, D) acc and (B, H, n_split) m, l
template <typename T, int D>
__global__ void __launch_bounds__(1024)
    flash_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int32_t* __restrict__ kv_len,
                              float* __restrict__ acc_part,
                              float* __restrict__ m_part,
                              float* __restrict__ l_part, int heads,
                              int kv_heads, int s_len, int split,
                              float scale) {
  constexpr int KP = D + 4;            // padded K row
  constexpr int DL = (D + 31) / 32;    // output dims per lane
  const int g = heads / kv_heads;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // G x D
  float* ks = qs + g * D;                       // kTK x KP
  float* vs = ks + kTK * KP;                    // kTK x D

  const int b = blockIdx.x / kv_heads, kh = blockIdx.x % kv_heads;
  const int sp = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(kv_len[b], 0), s_len);
  const int k_begin = sp * split;
  const int k_end = min(len, k_begin + split);
  const int64_t q_base = (static_cast<int64_t>(b) * heads + kh * g) * D;
  const int64_t kv_base =
      (static_cast<int64_t>(b) * kv_heads + kh) * s_len * D;

  for (int i = tid; i < g * D; i += blockDim.x) qs[i] = to_f32(q[q_base + i]);
  float m = kMasked, l = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  const float* q_row = qs + warp * D;
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < kTK * D; i += blockDim.x) {
      const int r = i / D, d = i % D, key = k0 + r;
      const int64_t at = kv_base + static_cast<int64_t>(key) * D + d;
      ks[r * KP + d] = key < k_end ? to_f32(k[at]) : 0.f;
      vs[i] = key < k_end ? to_f32(v[at]) : 0.f;
    }
    __syncthreads();
    const float* k_row = ks + lane * KP;
    float s = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(k_row + d);
      const float4 qq = *reinterpret_cast<const float4*>(q_row + d);
      s += qq.x * kk.x + qq.y * kk.y + qq.z * kk.z + qq.w * kk.w;
    }
    const bool live = k0 + lane < k_end;
    const float sc = live ? s * scale : kMasked;
    const float m_new = fmaxf(m, warp_max(sc));
    const float p = live ? expf(sc - m_new) : 0.f;
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= corr;
    for (int j = 0; j < kTK; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += pj * vs[j * D + d];
      }
    }
  }
  const int64_t row =
      (static_cast<int64_t>(b) * heads + kh * g + warp) * n_split + sp;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) acc_part[row * D + d] = acc[i];
  }
  if (lane == 0) {
    m_part[row] = l == 0.f ? -INFINITY : m;
    l_part[row] = l;
  }
}

// merge of the n_split partials of each (b, h): one block per (b, h)
template <int D>
__global__ void flash_decode_merge_kernel(const float* __restrict__ acc_part,
                                          const float* __restrict__ m_part,
                                          const float* __restrict__ l_part,
                                          float* __restrict__ acc,
                                          float* __restrict__ m_out,
                                          float* __restrict__ l_out,
                                          int n_split) {
  const int64_t row = blockIdx.x;
  const float* mp = m_part + row * n_split;
  const float* lp = l_part + row * n_split;
  float m = -INFINITY;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, mp[s]);
  const float m_safe = m == -INFINITY ? 0.f : m;
  float a = 0.f, l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float c = mp[s] == -INFINITY ? 0.f : expf(mp[s] - m_safe);
    l += c * lp[s];
    if (threadIdx.x < D) a += c * acc_part[(row * n_split + s) * D + threadIdx.x];
  }
  if (threadIdx.x < D) acc[row * D + threadIdx.x] = a;
  if (threadIdx.x == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* acc_part, void* m_part, void* l_part, void* acc, void* m,
           void* l, int batch, int heads, int kv_heads, int s_len, int split,
           int n_split, float scale, cudaStream_t stream) {
  const int g = heads / kv_heads;
  const size_t bytes = (g * D + kTK * (D + 4) + kTK * D) * sizeof(float);
  // opt in to the largest group's shared memory once per instantiation
  // (outside any CUDA-graph capture of later launches)
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    const size_t most = (32 * D + kTK * (D + 4) + kTK * D) * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = most;
  }
  const int64_t blocks = static_cast<int64_t>(batch) * kv_heads;
  if (blocks > 0x7fffffff || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_decode_split_kernel<T, D>
      <<<dim3(static_cast<unsigned>(blocks), n_split), g * 32, bytes,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v),
                   static_cast<const int32_t*>(kv_len),
                   static_cast<float*>(acc_part), static_cast<float*>(m_part),
                   static_cast<float*>(l_part), heads, kv_heads, s_len, split,
                   scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = D < 32 ? 32 : D;
  flash_decode_merge_kernel<D>
      <<<static_cast<unsigned>(static_cast<int64_t>(batch) * heads), threads, 0,
         stream>>>(static_cast<const float*>(acc_part),
                   static_cast<const float*>(m_part),
                   static_cast<const float*>(l_part), static_cast<float*>(acc),
                   static_cast<float*>(m), static_cast<float*>(l), n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* kv_len, void* acc_part, void* m_part, void* l_part,
             void* acc, void* m, void* l, int batch, int heads, int kv_heads,
             int s_len, int split, int n_split, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, kv_len, acc_part, m_part, l_part, acc, m, l, batch, heads, kv_heads, s_len, split, n_split, scale, stream);
    case 32: return launch<T, 32>(q, k, v, kv_len, acc_part, m_part, l_part, acc, m, l, batch, heads, kv_heads, s_len, split, n_split, scale, stream);
    case 64: return launch<T, 64>(q, k, v, kv_len, acc_part, m_part, l_part, acc, m, l, batch, heads, kv_heads, s_len, split, n_split, scale, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, acc_part, m_part, l_part, acc, m, l, batch, heads, kv_heads, s_len, split, n_split, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v). q (B, H, D); k, v
// (B, KH, S, D); kv_len (B,) int32; scratch acc_part (B, H, n_split, D),
// m_part / l_part (B, H, n_split); outputs acc (B, H, D), m / l (B, H), all
// float32 and contiguous. Splits of ``split`` keys (a multiple of 32),
// n_split = ceil(S / split). Returns the first failing cudaError_t, or 0.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* kv_len,
                                   void* acc_part, void* m_part, void* l_part,
                                   void* acc, void* m, void* l, int batch,
                                   int heads, int kv_heads, int s_len,
                                   int head_dim, int dtype, float scale,
                                   int split, int n_split, void* stream) {
  if (batch <= 0 || heads <= 0) return 0;
  if (kv_heads <= 0 || heads % kv_heads != 0 || heads / kv_heads > 32 ||
      s_len <= 0 || split <= 0 || split % kTK != 0 || n_split <= 0 ||
      static_cast<int64_t>(split) * n_split < s_len)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(head_dim, q, k, v, kv_len, acc_part, m_part,
                           l_part, acc, m, l, batch, heads, kv_heads, s_len,
                           split, n_split, scale, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(head_dim, q, k, v, kv_len, acc_part,
                                   m_part, l_part, acc, m, l, batch, heads,
                                   kv_heads, s_len, split, n_split, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
