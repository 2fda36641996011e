// Row compaction with a carried pointer, in one launch.
//
// Replaces scripts/experiment_worklog.py::kernel.  In each (R, 128) int32
// row the elements > 0 move to the front in their order and the rest of
// the row is zero; the rows that keep an element are stacked in source
// order at the front of ``out``, and ``ptr`` is their number.  Rows
// [ptr, R) of ``out`` are zero (the TPU kernel leaves them undefined).
//
// The TPU kernel carries the output row pointer in SMEM across its
// sequential grid and ranks lanes with a triangular matmul and one-hot
// sums.  Here a tile is 128 rows for a block of 32 warps, and the pointer
// is the tile's exclusive prefix from a decoupled look-back across blocks
// (lookback.cuh), so the count, the prefix and the stores are one pass:
//   * a warp loads a row as one int4 a thread (512 B coalesced) and ranks
//     its elements with a warp scan of per-thread counts;
//   * one ballot a group of 32 rows ranks the tile's non-empty rows, and
//     the block looks back for the tile's first output row;
//   * each non-empty row is rebuilt in shared memory and stored as one
//     int4 a thread.
//
// What bounds it on the H100: memory traffic.  Each input byte is read
// once and each output byte written once (8 MiB each way at (16384, 128),
// 0.0050 ms at 3.35 TB/s).  The look-back adds one 8-byte word per tile
// and a chain of L2 round trips that the aggregates keep short.  The
// output is the same on every run: positions depend on counts only.
//
// At that size a launch (2.4-3.2 us on the card) is half the bound, and
// the first design spent four device operations a call: two zero fills
// from the host (ptr, the look-back words), the compaction and a second
// launch that zeroed rows [ptr, R).  A call is now one launch of one block
// a tile, with nothing filled before it and no grid barrier in it:
//   * A warp issues its four row loads before it ranks any of them, so a
//     block waits on one L2 or HBM round trip for its tile, not four.
//   * Few tiles, and a block-wide look-back (lookback_exclusive_block).
//     When every tile starts at once no predecessor is inclusive yet, so
//     tile k reads all k words before it: n^2 / 2 loads on a few hot L2
//     lines.  Tiles of 128 rows (one block of 1024 an SM at (16384, 128))
//     make that 8K loads in one round each, where tiles of 32 rows made
//     131K in up to 16 rounds (2 with the block-wide look-back).
//   * The tail needs no barrier.  Rows [ptr, R) are as many as the empty
//     input rows, so tile k zeroes output rows [R - E_k, R - E_{k-1}),
//     where E_k counts the empty rows of tiles 0..k and comes from the
//     tile's own prefix (E_k = rows of tiles 0..k - inclusive prefix).
//     The ranges of the tiles are disjoint and cover [ptr, R), and every
//     output byte is still written once.
//   * Nothing is zeroed before the launch.  The state (the ticket in word
//     0, a count of finished tiles in word 1, then one look-back word a
//     tile) is the wrapper's buffer, kept per device and stream and grown
//     as R needs, zeroed once when it is allocated.  A tile counts itself
//     finished after its look-back, the only place it reads words; the
//     block that finishes the launch's last tile sees every tile finished,
//     every ticket taken and every word read, and sets words [0, tiles + 2)
//     back to zero.  So every word is zero when a call starts: those an
//     earlier call used (whatever its R) it cleared itself, the others were
//     never written, and a call on the same stream starts after the one
//     before it ends.  A word can thus never be read as this call's before
//     one of this call's tiles publishes it.
#include <cuda_runtime.h>

#include <cstdint>

#include "lookback.cuh"

namespace pst {

constexpr int kCompactLanes = 128;
constexpr int kCompactWarps = 32;
constexpr int kCompactThreads = 32 * kCompactWarps;
constexpr int kTileRows = 128;
constexpr int kRowsPerWarp = kTileRows / kCompactWarps;
constexpr int kRowGroups = kTileRows / 32;  // one ballot ranks a group's rows
constexpr int kInt4PerRow = kCompactLanes / 4;

__device__ __forceinline__ int positives(const int4& v) {
  return (v.x > 0) + (v.y > 0) + (v.z > 0) + (v.w > 0);
}

// ``state``: the ticket (word 0), the count of finished tiles (word 1) and
// the look-back words of tiles [0, n_tiles) (words 2 ..), all zero at the
// launch and again at its end.  One block a tile.
__global__ void __launch_bounds__(kCompactThreads)
row_compact(const int4* __restrict__ x, int4* __restrict__ out, int* ptr,
            unsigned long long* state, long long n_rows, int n_tiles) {
  __shared__ int row_total[kTileRows];
  __shared__ unsigned int group_mask[kRowGroups];
  __shared__ __align__(16) int buf[kCompactWarps][kCompactLanes];
  __shared__ bool last_block;

  auto* ticket = reinterpret_cast<unsigned int*>(state);
  auto* finished = reinterpret_cast<unsigned int*>(state + 1);
  unsigned long long* words = state + 2;
  const int tile = lookback_ticket(ticket);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(tile) * kTileRows;

  int4 v[kRowsPerWarp];
  int excl[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {  // all of the warp's loads first
    const long long g = row0 + warp * kRowsPerWarp + k;
    v[k] = g < n_rows ? x[g * kInt4PerRow + lane] : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp * kRowsPerWarp + k;
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

  // the non-empty rows of each group of 32, then of the warp's group and
  // of the tile; the block looks back
  if (warp < kRowGroups) {
    group_mask[warp] =
        __ballot_sync(0xffffffffu, row_total[warp * 32 + lane] > 0);
  }
  __syncthreads();
  const int group = warp * kRowsPerWarp / 32;
  const unsigned int mask = group_mask[group];
  unsigned int kept = 0u, before_group = 0u;
#pragma unroll
  for (int q = 0; q < kRowGroups; ++q) {
    const unsigned int n = static_cast<unsigned int>(__popc(group_mask[q]));
    before_group += q < group ? n : 0u;
    kept += n;
  }
  const long long base =
      lookback_exclusive_block<kCompactThreads>(words, tile, kept);
  if (threadIdx.x == 0) {
    if (tile == n_tiles - 1) *ptr = static_cast<int>(base + kept);
    __threadfence();  // the look-back's reads before the count
    last_block = atomicAdd(finished, 1u) == static_cast<unsigned int>(n_tiles - 1);
  }

  int* row_buf = buf[warp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = (warp * kRowsPerWarp + k) & 31;  // the row in its group
    if (!((mask >> r) & 1u)) continue;  // uniform across the warp
    reinterpret_cast<int4*>(row_buf)[lane] = make_int4(0, 0, 0, 0);
    __syncwarp();
    int e = excl[k];
    if (v[k].x > 0) row_buf[e++] = v[k].x;
    if (v[k].y > 0) row_buf[e++] = v[k].y;
    if (v[k].z > 0) row_buf[e++] = v[k].z;
    if (v[k].w > 0) row_buf[e++] = v[k].w;
    __syncwarp();
    const long long dest =
        base + before_group + __popc(mask & ((1u << r) - 1u));
    out[dest * kInt4PerRow + lane] =
        reinterpret_cast<const int4*>(row_buf)[lane];
    __syncwarp();
  }

  // this tile's share of the zero tail: one output row per empty row
  const long long rows_here =
      n_rows - row0 < kTileRows ? n_rows - row0 : kTileRows;
  const long long empty_before = row0 - base;
  const long long empty_through = row0 + rows_here - (base + kept);
  for (long long i = (n_rows - empty_through) * kInt4PerRow + threadIdx.x;
       i < (n_rows - empty_before) * kInt4PerRow; i += kCompactThreads) {
    out[i] = make_int4(0, 0, 0, 0);
  }

  __syncthreads();  // last_block
  if (last_block) {
    __threadfence();
    for (long long i = threadIdx.x; i < n_tiles + 2ll; i += kCompactThreads) {
      state[i] = 0ull;
    }
  }
}

}  // namespace pst

// Compacts the (n_rows, 128) int32 rows of ``x`` into ``out`` (same shape)
// and writes the number of non-empty rows to ``ptr`` (one int32), with one
// launch on ``stream``.  ``state`` holds at least ceil(n_rows / 32) + 2
// 64-bit words, all zero, and the kernel leaves them zero; no other call
// may use them at the same time.  ``x`` and ``out`` are 16-byte aligned.
// Returns a cudaError_t (0 on success), including a refused launch.
extern "C" int pst_row_compact(const void* x, void* out, void* ptr,
                               void* state, long long n_rows, void* stream) {
  using namespace pst;
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (n_rows + kTileRows - 1) / kTileRows;
  if (tiles >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  row_compact<<<static_cast<unsigned int>(tiles), kCompactThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(x), static_cast<int4*>(out),
      static_cast<int*>(ptr), static_cast<unsigned long long*>(state), n_rows,
      static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
