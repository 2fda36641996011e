// Decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016): the exclusive prefix of a tile's
// count over every earlier tile, in the same pass that computes the counts.
//
// Each tile owns one 64-bit word of ``state``: the status in the high half
// and the value in the low half, published with one store, so a reader
// never sees a status without its value.  A tile publishes its aggregate
// (kAggregate) as soon as it knows it, looks back over its predecessors
// 32 at a time with one warp (lookback_exclusive) or a block's threads at
// a time (lookback_exclusive_block), summing aggregates until it meets an
// inclusive prefix, then publishes its inclusive prefix (kInclusive).
//
// Forward progress: the caller numbers tiles by an atomicAdd ticket taken
// when the block starts, not by blockIdx, so every tile a block waits on
// belongs to a block that is already running and publishes its aggregate
// without waiting on anything.  The words and the ticket are zero when a
// tile first takes or reads them, and no host fill need make them so:
// compact.cu's last block to finish sets those its launch used back to
// zero, and the engines (worklog.cu, staged.cu) zero each region on the
// device a pass or more before its next use.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pst {

constexpr unsigned long long kLookbackEmpty = 0ull;
constexpr unsigned long long kLookbackAggregate = 1ull << 32;
constexpr unsigned long long kLookbackInclusive = 2ull << 32;
constexpr unsigned long long kLookbackStatus = 3ull << 32;

__device__ __forceinline__ unsigned long long lookback_load(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void lookback_store(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The tile's number, from the ticket; every thread of the block gets it.
__device__ __forceinline__ int lookback_ticket(unsigned int* ticket) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  return tile;
}

// Called by all 32 lanes of one warp of tile ``tile`` with the tile's
// ``aggregate`` (a count in [0, 2^32)); returns the sum of the aggregates
// of tiles [0, tile) to every lane, and publishes the tile's inclusive
// prefix.  Sums wrap modulo 2^32.
__device__ __forceinline__ unsigned int lookback_exclusive(
    unsigned long long* state, int tile, unsigned int aggregate) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) lookback_store(state, kLookbackInclusive | aggregate);
    return 0u;
  }
  if (lane == 0) lookback_store(state + tile, kLookbackAggregate | aggregate);
  unsigned int exclusive = 0u;
  int end = tile - 1;  // the nearest predecessor not summed yet
  while (true) {
    const int j = end - lane;  // lane 0 reads the nearest
    unsigned long long w = kLookbackInclusive;  // before tile 0: prefix 0
    if (j >= 0) {
      do {
        w = lookback_load(state + j);
      } while ((w & kLookbackStatus) == kLookbackEmpty);
    }
    const unsigned int done =
        __ballot_sync(0xffffffffu, (w & kLookbackStatus) == kLookbackInclusive);
    // sum up to and including the nearest inclusive prefix, or all 32
    const int last = done ? __ffs(done) - 1 : 31;
    const unsigned int v =
        lane <= last ? static_cast<unsigned int>(w & 0xffffffffu) : 0u;
    exclusive += __reduce_add_sync(0xffffffffu, v);
    if (done) break;
    end -= 32;
  }
  if (lane == 0) {
    lookback_store(state + tile, kLookbackInclusive | (exclusive + aggregate));
  }
  return exclusive;
}

// lookback_exclusive for the whole block: called by all kThreads threads
// (a multiple of 32) of tile ``tile``'s block, it reads kThreads
// predecessors a round instead of 32.  When every tile starts at once (a
// grid that is all resident), no predecessor has its inclusive prefix
// yet, and tile k sums aggregates back to tile 0: k / kThreads rounds of
// L2 round trips, not k / 32.
template <int kThreads>
__device__ __forceinline__ unsigned int lookback_exclusive_block(
    unsigned long long* state, int tile, unsigned int aggregate) {
  constexpr int kWarps = kThreads / 32;
  __shared__ int nearest[kWarps];  // a warp's first thread at an inclusive
  __shared__ unsigned int sums[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (tile == 0) {
    if (threadIdx.x == 0) lookback_store(state, kLookbackInclusive | aggregate);
    return 0u;
  }
  if (threadIdx.x == 0) {
    lookback_store(state + tile, kLookbackAggregate | aggregate);
  }
  unsigned int exclusive = 0u;
  int end = tile - 1;  // the nearest predecessor not summed yet
  while (true) {
    const int j = end - static_cast<int>(threadIdx.x);  // thread 0: nearest
    unsigned long long w = kLookbackInclusive;  // before tile 0: prefix 0
    if (j >= 0) {
      do {
        w = lookback_load(state + j);
      } while ((w & kLookbackStatus) == kLookbackEmpty);
    }
    const unsigned int done =
        __ballot_sync(0xffffffffu, (w & kLookbackStatus) == kLookbackInclusive);
    if (lane == 0) nearest[warp] = done ? warp * 32 + __ffs(done) - 1 : kThreads;
    __syncthreads();
    int last = kThreads;
#pragma unroll
    for (int k = kWarps - 1; k >= 0; --k) last = min(last, nearest[k]);
    // sum up to and including the nearest inclusive prefix, or all
    const unsigned int v = static_cast<int>(threadIdx.x) <= last
                               ? static_cast<unsigned int>(w & 0xffffffffu)
                               : 0u;
    const unsigned int warp_sum = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0) sums[warp] = warp_sum;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWarps; ++k) exclusive += sums[k];
    __syncthreads();  // nearest and sums are rewritten by the next round
    if (last < kThreads) break;
    end -= kThreads;
  }
  if (threadIdx.x == 0) {
    lookback_store(state + tile, kLookbackInclusive | (exclusive + aggregate));
  }
  return exclusive;
}

}  // namespace pst
