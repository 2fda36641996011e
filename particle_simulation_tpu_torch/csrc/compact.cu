// Row compaction with a carried pointer, in one pass.
//
// Replaces scripts/experiment_worklog.py::kernel.  In each (R, 128) int32
// row the elements > 0 move to the front in their order and the rest of
// the row is zero; the rows that keep an element are stacked in source
// order at the front of ``out``, and ``ptr`` is their number.  Rows
// [ptr, R) of ``out`` are zero (the TPU kernel leaves them undefined).
//
// The TPU kernel carries the output row pointer in SMEM across its
// sequential grid and ranks lanes with a triangular matmul and one-hot
// sums.  Here a tile of 32 rows is one block of 8 warps, and the pointer
// is the tile's exclusive prefix from a decoupled look-back across blocks
// (lookback.cuh), so the count, the prefix and the stores are one pass:
//   * a warp loads a row as one int4 a thread (512 B coalesced) and ranks
//     its elements with a warp scan of per-thread counts;
//   * warp 0 ranks the tile's non-empty rows with one ballot and looks
//     back for the tile's first output row;
//   * each non-empty row is rebuilt in shared memory and stored as one
//     int4 a thread.
// A second launch zeroes rows [ptr, R), reading ptr on the device.
//
// What bounds it on the H100: memory traffic.  Each input byte is read
// once and each output byte written once (8 MiB each way at (16384, 128),
// about 5 us at 3.35 TB/s).  The look-back adds one 8-byte word per tile
// and a chain of L2 round trips that the aggregates keep short.  The
// output is the same on every run: positions depend on counts only.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace pst {

constexpr int kCompactLanes = 128;
constexpr int kCompactWarps = 8;
constexpr int kCompactThreads = 32 * kCompactWarps;
constexpr int kTileRows = 32;  // one ballot ranks a tile's rows
constexpr int kRowsPerWarp = kTileRows / kCompactWarps;
constexpr int kInt4PerRow = kCompactLanes / 4;

__device__ __forceinline__ int positives(const int4& v) {
  return (v.x > 0) + (v.y > 0) + (v.z > 0) + (v.w > 0);
}

__global__ void __launch_bounds__(kCompactThreads)
row_compact(const int4* __restrict__ x, int4* __restrict__ out,
            int* __restrict__ ptr, unsigned long long* __restrict__ state,
            unsigned int* __restrict__ ticket, long long n_rows, int n_tiles) {
  __shared__ int row_total[kTileRows];
  __shared__ unsigned int tile_mask;
  __shared__ unsigned int tile_base;
  __shared__ __align__(16) int buf[kCompactWarps][kCompactLanes];

  const int tile = lookback_ticket(ticket);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int4 v[kRowsPerWarp];
  int excl[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp * kRowsPerWarp + k;
    const long long g = static_cast<long long>(tile) * kTileRows + r;
    v[k] = g < n_rows ? x[g * kInt4PerRow + lane] : make_int4(0, 0, 0, 0);
    const int c = positives(v[k]);
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    excl[k] = incl - c;
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0) row_total[r] = total;
  }
  __syncthreads();

  if (warp == 0) {
    const unsigned int mask = __ballot_sync(0xffffffffu, row_total[lane] > 0);
    const unsigned int base =
        lookback_exclusive(state, tile, static_cast<unsigned int>(__popc(mask)));
    if (lane == 0) {
      tile_mask = mask;
      tile_base = base;
      if (tile == n_tiles - 1) *ptr = static_cast<int>(base + __popc(mask));
    }
  }
  __syncthreads();

  const unsigned int mask = tile_mask;
  const long long base = tile_base;
  int* row_buf = buf[warp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp * kRowsPerWarp + k;
    if (!((mask >> r) & 1u)) continue;  // uniform across the warp
    reinterpret_cast<int4*>(row_buf)[lane] = make_int4(0, 0, 0, 0);
    __syncwarp();
    int e = excl[k];
    if (v[k].x > 0) row_buf[e++] = v[k].x;
    if (v[k].y > 0) row_buf[e++] = v[k].y;
    if (v[k].z > 0) row_buf[e++] = v[k].z;
    if (v[k].w > 0) row_buf[e++] = v[k].w;
    __syncwarp();
    const long long dest = base + __popc(mask & ((1u << r) - 1u));
    out[dest * kInt4PerRow + lane] = reinterpret_cast<const int4*>(row_buf)[lane];
    __syncwarp();
  }
}

// out rows [*ptr, n_rows) = 0
__global__ void __launch_bounds__(256)
zero_tail(int4* __restrict__ out, const int* __restrict__ ptr,
          long long n_rows) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const long long row = i / kInt4PerRow;
  if (row < n_rows && row >= *ptr) out[i] = make_int4(0, 0, 0, 0);
}

}  // namespace pst

// Compacts the (n_rows, 128) int32 rows of ``x`` into ``out`` (same shape)
// and writes the number of non-empty rows to ``ptr`` (one int32), on
// ``stream``.  ``state`` holds ceil(n_rows / 32) + 1 zeroed 64-bit words:
// the look-back words and, in the last, the ticket.  ``x`` and ``out`` are
// 16-byte aligned.  Returns a cudaError_t (0 on success).
extern "C" int pst_row_compact(const void* x, void* out, void* ptr,
                               void* state, long long n_rows, void* stream) {
  using namespace pst;
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n_rows + kTileRows - 1) / kTileRows;
  if (n_tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  auto* words = static_cast<unsigned long long*>(state);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_compact<<<static_cast<unsigned int>(n_tiles), kCompactThreads, 0, s>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out),
      static_cast<int*>(ptr), words,
      reinterpret_cast<unsigned int*>(words + n_tiles), n_rows,
      static_cast<int>(n_tiles));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n4 = n_rows * kInt4PerRow;
  zero_tail<<<static_cast<unsigned int>((n4 + 255) / 256), 256, 0, s>>>(
      static_cast<int4*>(out), static_cast<const int*>(ptr), n_rows);
  return static_cast<int>(cudaGetLastError());
}
