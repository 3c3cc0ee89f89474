// spatial_match: the TweetsAboutCrime spatial join's hit map.
//
// Replaces: src/repro/kernels/spatial_match/kernel.py,
//   spatial_match_kernel (body _kernel), the Pallas TPU kernel.
// Computes: (R, 2) tweet locations x (U, 2) user locations, float32 ->
//   (R, U) hit map, one byte (0/1) per pair: dist2 < r2, with the TPU
//   kernel's expansion form in this fixed order and no FMA contraction:
//     t2 = t0*t0 + t1*t1;  u2 = u0*u0 + u1*u1;  cross = t0*u0 + t1*u1;
//     dist2 = (t2 + u2) - 2*cross.
//   The plain version in kernels/spatial_match/ops.py does the same float32
//   operations one by one, so kernel and plain version agree bit for bit.
//   Callers may pad with +-1e30 (FAR): FAR^2 overflows to inf (or the sum
//   goes NaN), and neither is < r2, so padded pairs never match.
// Bound on the H100: memory. At R = 16,384, U = 10,000 the bitmap alone is
//   164 MB to write, about 49 us at 3.35 TB/s, against about 17 us for its
//   ~7 float32 operations per pair at 67 TFLOP/s on the CUDA cores.
// Design: K = 2 fits no tensor-core shape, so this runs on the CUDA cores.
//   A block of 256 threads covers 256 consecutive users (one per thread,
//   kept in registers with u2) and a tile of 32 tweets, whose coordinates
//   and t2 are staged in shared memory once per block. Each thread walks the
//   32 tweet rows and writes one byte per row; a warp's 32 bytes are
//   consecutive along U, so the stores coalesce.
//
// Second entry, spatial_match_stacked_launch: the fused spatial join's
//   stacked form (the reference vmaps its kernel over the channel axis,
//   spatial_match/ops.py). (C, R, 2) tweets x (C, U, 2) users with one r2
//   per channel (a (C,) float32 array on the device) -> (C, R, U) hit map.
//   The same tile scheme with a third grid axis over the channels; the same
//   fixed float32 order without FMA, so it stays bit-equal to its plain
//   version. Bound: memory, C*R*U bytes written.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUsers = 256;
constexpr int kTweets = 32;

// Channel c = blockIdx.z reads tweets + c*2r and users + c*2u and writes
// out + c*r*u; r2 is r2s[c] (r2s null: the scalar r2 for every channel).
__global__ void spatial_match_kernel(const float* __restrict__ tweets,
                                     const float* __restrict__ users,
                                     uint8_t* __restrict__ out, int r, int u,
                                     float r2,
                                     const float* __restrict__ r2s) {
  const int64_t c = blockIdx.z;
  tweets += c * 2 * r;
  users += c * 2 * u;
  out += c * r * u;
  if (r2s != nullptr) r2 = r2s[c];
  __shared__ float s_t0[kTweets];
  __shared__ float s_t1[kTweets];
  __shared__ float s_t2[kTweets];

  const int64_t t_base = static_cast<int64_t>(blockIdx.y) * kTweets;
  const int rows = r - t_base < kTweets ? static_cast<int>(r - t_base) : kTweets;
  if (threadIdx.x < rows) {
    const float t0 = tweets[2 * (t_base + threadIdx.x)];
    const float t1 = tweets[2 * (t_base + threadIdx.x) + 1];
    s_t0[threadIdx.x] = t0;
    s_t1[threadIdx.x] = t1;
    s_t2[threadIdx.x] = __fadd_rn(__fmul_rn(t0, t0), __fmul_rn(t1, t1));
  }
  __syncthreads();

  const int64_t col = static_cast<int64_t>(blockIdx.x) * kUsers + threadIdx.x;
  if (col >= u) return;
  const float u0 = users[2 * col];
  const float u1 = users[2 * col + 1];
  const float u2 = __fadd_rn(__fmul_rn(u0, u0), __fmul_rn(u1, u1));
  uint8_t* o = out + t_base * u + col;
  for (int i = 0; i < rows; ++i) {
    const float cross = __fadd_rn(__fmul_rn(s_t0[i], u0),
                                  __fmul_rn(s_t1[i], u1));
    const float dist2 = __fsub_rn(__fadd_rn(s_t2[i], u2),
                                  __fmul_rn(2.0f, cross));
    o[static_cast<int64_t>(i) * u] = dist2 < r2 ? 1 : 0;
  }
}

}  // namespace

extern "C" int spatial_match_launch(const void* tweets, const void* users,
                                    void* out, int r, int u, float r2,
                                    void* stream) {
  if (r <= 0 || u <= 0) return 0;
  const dim3 grid((u + kUsers - 1) / kUsers, (r + kTweets - 1) / kTweets);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  spatial_match_kernel<<<grid, kUsers, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tweets), static_cast<const float*>(users),
      static_cast<uint8_t*>(out), r, u, r2, nullptr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spatial_match_stacked_launch(const void* tweets,
                                            const void* users, void* out,
                                            const void* r2s, int c, int r,
                                            int u, void* stream) {
  if (c <= 0 || r <= 0 || u <= 0) return 0;
  const dim3 grid((u + kUsers - 1) / kUsers, (r + kTweets - 1) / kTweets, c);
  if (grid.y > 65535 || grid.z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  spatial_match_kernel<<<grid, kUsers, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tweets), static_cast<const float*>(users),
      static_cast<uint8_t*>(out), r, u, 0.0f,
      static_cast<const float*>(r2s));
  return static_cast<int>(cudaGetLastError());
}
