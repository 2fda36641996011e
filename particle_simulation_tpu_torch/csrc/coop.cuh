// The cooperative launch of a persistent kernel, shared by the engines
// (worklog.cu, staged.cu): as many blocks as can be resident at once
// (occupancy x SMs, at most ``max_blocks``), launched with
// cudaLaunchCooperativeKernel, so a grid that could not all be resident is
// refused rather than deadlocked at its first grid barrier.
//
// The SM count, the dynamic shared-memory attribute and the occupancy do
// not change between phases: each launch site of the compiled set queries
// them once per device and keeps the resident grid size in its own
// CoopCache.  The open instantiations take their grid from the caller, who
// sizes their scratch by it (resident_blocks, launch_cooperative_grid).
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace pst {

constexpr int kMaxDevices = 64;

// One per kernel instantiation (a static in its launch function); static
// storage starts zeroed, and 0 means "not queried yet".  Two threads that
// query at once store the same value.
struct CoopCache {
  std::atomic<int> blocks[kMaxDevices];
};

// The resident grid of ``kernel``: its blocks per SM at ``threads`` and
// ``smem_bytes`` of dynamic shared memory, times the SMs (sets the kernel's
// dynamic shared-memory attribute on the way).  A block that does not fit
// an SM at all is cudaErrorInvalidConfiguration.
inline cudaError_t resident_blocks(const void* kernel, int threads,
                                   int smem_bytes, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem_bytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// A cooperative launch of exactly ``blocks`` blocks; more than can be
// resident is refused (cudaErrorCooperativeLaunchTooLarge).
inline cudaError_t launch_cooperative_grid(const void* kernel,
                                           unsigned int blocks, int threads,
                                           int smem_bytes, void** args,
                                           cudaStream_t stream) {
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kernel, dim3(blocks), dim3(threads), args, smem_bytes, stream);
  // a refused launch also leaves its error as the last one: clear it
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

inline cudaError_t launch_cooperative(const void* kernel, int threads,
                                      int smem_bytes, long long max_blocks,
                                      void** args, CoopCache& cache,
                                      cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int resident = cache.blocks[dev].load(std::memory_order_relaxed);
  if (resident == 0) {
    err = resident_blocks(kernel, threads, smem_bytes, &resident);
    if (err != cudaSuccess) return err;
    cache.blocks[dev].store(resident, std::memory_order_relaxed);
  }
  const unsigned int blocks = static_cast<unsigned int>(
      resident < max_blocks ? resident : max_blocks);
  return launch_cooperative_grid(kernel, blocks, threads, smem_bytes, args,
                                 stream);
}

}  // namespace pst
