// The cooperative launch of a persistent kernel, shared by the engines
// (worklog.cu, staged.cu): as many blocks as can be resident at once
// (occupancy x SMs, at most ``max_blocks``), launched with
// cudaLaunchCooperativeKernel, so a grid that could not all be resident is
// refused rather than deadlocked at its first grid barrier.
//
// The SM count, the dynamic shared-memory attribute and the occupancy do
// not change between phases: each launch site queries them once per device
// and keeps the resident grid size in its own CoopCache.
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
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
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
    resident = per_sm * sms;
    cache.blocks[dev].store(resident, std::memory_order_relaxed);
  }
  const unsigned int blocks = static_cast<unsigned int>(
      resident < max_blocks ? resident : max_blocks);
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args,
                                    smem_bytes, stream);
  // a refused launch also leaves its error as the last one: clear it
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

}  // namespace pst
