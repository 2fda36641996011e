// Order-preserving block scans shared by the engines' kernels: a scan of
// two ints across one block, and the one-block scan that turns per-block
// counts into each block's exclusive offsets and the pass totals.  No
// atomics, so what the engines emit comes out in the same order on every
// run.
#pragma once

#include <cuda_runtime.h>

namespace pst {

#ifndef PST_BLOCK
#error "PST_BLOCK must be defined by the build (ops/kernels/build.py)"
#endif
constexpr int kBlock = PST_BLOCK;  // push_mcc.py BLOCK sizes the scratch

// inclusive sum over a block of THREADS (a multiple of 32, at most 1024)
// of two ints; every thread gets its block-exclusive prefixes and the
// block totals.  Two calls in a row need a __syncthreads() between them
// (they share the warp sums).
template <int THREADS = kBlock>
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

// Body of a one-block kernel of THREADS threads over ``n_blocks`` rows of
// NCOL per-block counts: the exclusive offset of every block in each of
// the first NOFF columns (offsets[NOFF * b + j]) and the total of every
// column (totals[j]), all as 64-bit sums.
template <int NCOL, int NOFF, int THREADS>
__device__ __forceinline__ void scan_block_sums(
    const long long* __restrict__ block_sums, int n_blocks,
    long long* __restrict__ offsets, long long* __restrict__ totals) {
  __shared__ long long sh[NCOL][THREADS];
  const int tid = threadIdx.x;
  const int per = (n_blocks + THREADS - 1) / THREADS;
  const int b0 = min(tid * per, n_blocks);
  const int b1 = min(b0 + per, n_blocks);
  long long own[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) own[j] = 0;
  for (int b = b0; b < b1; ++b) {
#pragma unroll
    for (int j = 0; j < NCOL; ++j) own[j] += block_sums[NCOL * (long long)b + j];
  }
#pragma unroll
  for (int j = 0; j < NCOL; ++j) sh[j][tid] = own[j];
  __syncthreads();
  // Hillis-Steele inclusive scan of the per-thread sums
  for (int off = 1; off < THREADS; off <<= 1) {
    long long add[NCOL];
#pragma unroll
    for (int j = 0; j < NCOL; ++j) add[j] = tid >= off ? sh[j][tid - off] : 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NCOL; ++j) sh[j][tid] += add[j];
    __syncthreads();
  }
  long long run[NOFF];
#pragma unroll
  for (int j = 0; j < NOFF; ++j) run[j] = sh[j][tid] - own[j];
  for (int b = b0; b < b1; ++b) {
#pragma unroll
    for (int j = 0; j < NOFF; ++j) {
      offsets[NOFF * (long long)b + j] = run[j];
      run[j] += block_sums[NCOL * (long long)b + j];
    }
  }
  if (tid == THREADS - 1) {
#pragma unroll
    for (int j = 0; j < NCOL; ++j) totals[j] = sh[j][tid];
  }
}

}  // namespace pst
