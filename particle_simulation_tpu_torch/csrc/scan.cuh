// The order-preserving block scan shared by the engines' kernels: a scan
// of two ints across one block.  No atomics, so what the engines emit
// comes out in the same order on every run.
#pragma once

#include <cuda_runtime.h>

namespace pst {

// inclusive sum over a block of THREADS (a multiple of 32, at most 1024)
// of two ints; every thread gets its block-exclusive prefixes and the
// block totals.  Two calls in a row need a __syncthreads() between them
// (they share the warp sums).
template <int THREADS>
__device__ __forceinline__ void block_scan2(int a, int b, int& excl_a,
                                            int& excl_b, int& tot_a,
                                            int& tot_b) {
  constexpr int kWarps = THREADS / 32;
  __shared__ int warp_a[kWarps];
  __shared__ int warp_b[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ya = __shfl_up_sync(0xffffffffu, ia, off);
    const int yb = __shfl_up_sync(0xffffffffu, ib, off);
    if (lane >= off) {
      ia += ya;
      ib += yb;
    }
  }
  if (lane == 31) {
    warp_a[warp] = ia;
    warp_b[warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int va = lane < kWarps ? warp_a[lane] : 0;
    int vb = lane < kWarps ? warp_b[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ya = __shfl_up_sync(0xffffffffu, va, off);
      const int yb = __shfl_up_sync(0xffffffffu, vb, off);
      if (lane >= off) {
        va += ya;
        vb += yb;
      }
    }
    if (lane < kWarps) {
      warp_a[lane] = va;
      warp_b[lane] = vb;
    }
  }
  __syncthreads();
  excl_a = (warp > 0 ? warp_a[warp - 1] : 0) + ia - a;
  excl_b = (warp > 0 ? warp_b[warp - 1] : 0) + ib - b;
  tot_a = warp_a[kWarps - 1];
  tot_b = warp_b[kWarps - 1];
}

}  // namespace pst
