// launch_floor: an empty kernel, the floor under a kernel's time.
//
// A measuring instrument, on no path: chip_smoke.py launches it with the
// grid, block, dynamic shared memory and cluster size of a kernel it times,
// from a CUDA graph exactly as it times the kernel, so the difference is
// the kernel's own work. Within a cluster of more than one block it does
// one cluster barrier, as the clustered kernels do at least once.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kMaxDevices = 64;

__global__ void launch_floor_kernel(int cluster) {
  if (cluster > 1) cg::this_cluster().sync();
}

}  // namespace

// blocks x threads with `smem` bytes of dynamic shared memory a block, in
// clusters of `cluster` blocks (1: no cluster). Returns the launch's
// cudaError_t, or 0.
extern "C" int launch_floor_launch(long long blocks, int threads, int smem,
                                   int cluster, void* stream) {
  // a device's opt-ins: cluster sizes past 8, and the shared memory
  static bool configured[kMaxDevices];
  static int opted[kMaxDevices];
  if (blocks <= 0 || blocks > 0x7fffffff || threads <= 0 || smem < 0 ||
      cluster <= 0 || blocks % cluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // outside a graph capture: the first call of each configuration
  if (!configured[dev]) {
    e = cudaFuncSetAttribute(launch_floor_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured[dev] = true;
  }
  if (smem > opted[dev]) {
    e = cudaFuncSetAttribute(launch_floor_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, launch_floor_kernel,
                                             cluster));
}
