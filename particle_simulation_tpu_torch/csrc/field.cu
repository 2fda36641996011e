// The field phase on Hopper: the gather of the packed diffs, and the bbox
// subgrid's phase as three kernels.
//
// Replaces scripts/microbench_fieldgather.py::banded_gather_kernel
// (out = table[rows, lanes] from a packed (2048, 128) int32 bbox table) and
// serves the packed-diff gather of the field phase
// (particle_simulation_tpu/ops/grid.py gather_acceleration_packdiff and
// _subgrid_packdiff_acc; ops/grid.py here).  Two entries share one device
// gather:
//   banded_gather:       out[i] = table[rows[i] * 128 + lanes[i]];
//   packed_field_gather: v = packed[max(flat[i], 0)], unpacked into three
//     10-bit biased diffs, each scaled to float(d) * e_const (one rounding:
//     the build passes -fmad=false and there is nothing to contract), and
//     0 where weight[i] == 0.
//
// The TPU kernel sweeps each (128, 128) tile's row band with a broadcast
// row, a lane take_along_axis and a select, because the TPU has no
// per-lane gather.  Hopper has one: each thread reads its element through
// the read-only path.
//
// What bounds it on the H100: memory traffic and the latency of the random
// reads.  A 64^3 packed table is 1 MB and a 256^3 one 67 MB, both held in
// the 50 MB L2 or mostly so; the streams of indices (8 bytes an element in,
// 4 or 12 out) are coalesced.  Staging each block's row band in shared
// memory for cell-sorted ids is later work.
//
// The subgrid field phase on a CUDA state (ops/grid.py
// subgrid_field_chain; the JAX package's bbox_field_acceleration, whose
// lax.conds are host decisions here) replaces no TPU kernel: the JAX
// package builds it from jnp operations, and so does the port's CPU path.
// Run as some 60 PyTorch operations on the card, the phase left the card
// idle for most of its time while the host issued them, and read back
// twice.  Three kernels, each over the state's own pos and status (the
// live test is population.is_live's, the cell ops/grid.py cell_indices':
// trunc(p * float32(1 / cell_size)), clamped into the grid), do it with
// one readback:
//   subgrid_bbox:        words[a] = max over live rows of (g_a - cell_a),
//     words[3 + a] = max of (cell_a + 1), 0 where no row is live, so that
//     lo = g - words[a] and hi = words[3 + a] - 1 give live_bbox's bounds
//     and sentinels; the host reads the six words back and takes the
//     window test (fit_window's arithmetic);
//   subgrid_deposit:     counts[(rx * S + ry) * S + rz] += 1 for each live
//     row at cell - origin (integer atomics: exact, whatever their order);
//   subgrid_field_store: acc[i][a] = float(c[+1] - c[-1]) * e_const along
//     axis a for a live row i < m (neighbours outside the S^3 window count
//     0, as axis_diff's), 0 on every other row of the capacity: the value
//     of packed_field_gather and of the float32 rows alike, so the 10-bit
//     test and its readback go, and the state's acc is written once.
// A live row outside the window (which the window test rules out) is
// neither deposited nor given a field.
//
// What bounds them: bytes.  bbox and deposit read 16 B a row (pos and
// status); the store reads 16 B a row below m and writes 12 B a capacity
// row: at 5e7 slots, 600 MB, 0.18 ms at 3.35 TB/s, the phase's largest
// term.  The S^3 counts (8 MB at S = 128) stay in the 50 MB L2.  The
// design: bbox strides a grid of at most kBboxBlocks blocks over the rows
// and reduces in shared memory, one atomicMax a word a block; deposit
// merges a warp's adds to one cell (__match_any_sync) into one atomicAdd;
// the store gives each thread four consecutive floats of acc, one 16-byte
// store, neighbouring threads on neighbouring addresses.
#include <cuda_runtime.h>

#include <cstdint>

namespace pst {

constexpr int kGatherBlock = 256;
constexpr int kLanes = 128;
constexpr int kPackBias = 1 << 9;
constexpr int kPackMask = (1 << 10) - 1;

__device__ __forceinline__ int32_t gather(const int32_t* __restrict__ table,
                                          long long i) {
  return __ldg(table + i);
}

__global__ void __launch_bounds__(kGatherBlock)
banded_gather(const int32_t* __restrict__ table,
              const int32_t* __restrict__ rows,
              const int32_t* __restrict__ lanes, int32_t* __restrict__ out,
              long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kGatherBlock + threadIdx.x;
  if (i < n) {
    out[i] = gather(table, static_cast<long long>(rows[i]) * kLanes + lanes[i]);
  }
}

__global__ void __launch_bounds__(kGatherBlock)
packed_field_gather(const int32_t* __restrict__ packed,
                    const int32_t* __restrict__ flat,
                    const int32_t* __restrict__ weight, float e_const,
                    float* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kGatherBlock + threadIdx.x;
  if (i >= n) return;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (weight[i] > 0) {
    const int32_t f = flat[i];
    const int32_t v = gather(packed, f > 0 ? f : 0);
    ax = __fmul_rn(static_cast<float>((v >> 20) - kPackBias), e_const);
    ay = __fmul_rn(static_cast<float>(((v >> 10) & kPackMask) - kPackBias),
                   e_const);
    az = __fmul_rn(static_cast<float>((v & kPackMask) - kPackBias), e_const);
  }
  out[3 * i] = ax;
  out[3 * i + 1] = ay;
  out[3 * i + 2] = az;
}

constexpr int kFieldBlock = 256;
constexpr int kBboxBlocks = 1024;
constexpr int32_t kStatusAlive = -1;  // constants.STATUS_ALIVE

// Where the state's rows fall: the cell map of ops/grid.py cell_indices
// and the S^3 window at origin.
struct CellMap {
  float inv;      // float32(1 / cell_size)
  int g[3];       // grid size
  int origin[3];  // the window's origin (bbox: unused)
  int s;          // the window's edge S (bbox: unused)
};

// population.is_live
__device__ __forceinline__ bool is_live(int32_t status) {
  return status == kStatusAlive || status > 0;
}

// cell_indices on one axis: trunc(p * inv), then clamp(min=0), min(g - 1)
__device__ __forceinline__ int cell_of(float p, float inv, int g) {
  const int c = __float2int_rz(__fmul_rn(p, inv));
  const int lo = c > 0 ? c : 0;
  return lo < g - 1 ? lo : g - 1;
}

// row i's cell relative to the window's origin; false if it lies outside
__device__ __forceinline__ bool window_cell(const float* __restrict__ pos,
                                            long long i, const CellMap& map,
                                            int r[3]) {
  bool inside = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r[a] = cell_of(pos[3 * i + a], map.inv, map.g[a]) - map.origin[a];
    inside = inside && r[a] >= 0 && r[a] < map.s;
  }
  return inside;
}

__global__ void __launch_bounds__(kFieldBlock)
subgrid_bbox(const float* __restrict__ pos, const int32_t* __restrict__ status,
             long long m, CellMap map, int32_t* __restrict__ words) {
  __shared__ int block_words[6];
  if (threadIdx.x < 6) block_words[threadIdx.x] = 0;
  __syncthreads();
  int w[6] = {0, 0, 0, 0, 0, 0};
  const long long stride = static_cast<long long>(gridDim.x) * kFieldBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kFieldBlock +
                     threadIdx.x;
       i < m; i += stride) {
    if (!is_live(status[i])) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int c = cell_of(pos[3 * i + a], map.inv, map.g[a]);
      w[a] = max(w[a], map.g[a] - c);
      w[3 + a] = max(w[3 + a], c + 1);
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    w[k] = __reduce_max_sync(0xffffffffu, w[k]);
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (w[k] > 0) atomicMax(block_words + k, w[k]);
    }
  }
  __syncthreads();
  if (threadIdx.x < 6 && block_words[threadIdx.x] > 0) {
    atomicMax(words + threadIdx.x, block_words[threadIdx.x]);
  }
}

__global__ void __launch_bounds__(kFieldBlock)
subgrid_deposit(const float* __restrict__ pos,
                const int32_t* __restrict__ status, long long m, CellMap map,
                int32_t* __restrict__ counts) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kFieldBlock + threadIdx.x;
  int cell = -1;  // the row's window cell, -1 for no add
  if (i < m && is_live(status[i])) {
    int r[3];
    if (window_cell(pos, i, map, r)) cell = (r[0] * map.s + r[1]) * map.s + r[2];
  }
  // every lane of the warp reaches the match: one add a distinct cell
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  if (cell >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(counts + cell, __popc(peers));
  }
}

// acc row i's value on axis a: the field at a live row's window cell, else 0
// (r[a] by selects, so that r stays in registers)
__device__ __forceinline__ float field_at(const int32_t* __restrict__ counts,
                                          const int r[3], bool live, int a,
                                          int s, float e_const) {
  if (!live) return 0.0f;
  const int ra = a == 0 ? r[0] : (a == 1 ? r[1] : r[2]);
  const int stride = a == 0 ? s * s : (a == 1 ? s : 1);
  const int cell = (r[0] * s + r[1]) * s + r[2];
  const int up = ra + 1 < s ? __ldg(counts + cell + stride) : 0;
  const int down = ra > 0 ? __ldg(counts + cell - stride) : 0;
  return __fmul_rn(static_cast<float>(up - down), e_const);
}

__global__ void __launch_bounds__(kFieldBlock)
subgrid_field_store(const float* __restrict__ pos,
                    const int32_t* __restrict__ status, long long m,
                    long long capacity, CellMap map,
                    const int32_t* __restrict__ counts, float e_const,
                    float* __restrict__ acc) {
  const long long n = 3 * capacity;  // the floats of acc
  const long long e0 =
      4 * (static_cast<long long>(blockIdx.x) * kFieldBlock + threadIdx.x);
  if (e0 >= n) return;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (e0 < 3 * m) {
    // the four floats span two rows at most: the first row's, then
    // (where it starts inside the four) the second's
    const long long i0 = e0 / 3;
    int r[3] = {0, 0, 0};
    bool live = is_live(status[i0]) && window_cell(pos, i0, map, r);
    const int a0 = static_cast<int>(e0 - 3 * i0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int a = a0 + k;  // 0..5: past 2, the next row
      if (a == 3) {
        if (i0 + 1 >= m) break;
        live = is_live(status[i0 + 1]) && window_cell(pos, i0 + 1, map, r);
      }
      v[k] = field_at(counts, r, live, a < 3 ? a : a - 3, map.s, e_const);
    }
  }
  if (e0 + 4 <= n) {
    *reinterpret_cast<float4*>(acc + e0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e0 + k < n) acc[e0 + k] = v[k];
    }
  }
}

inline unsigned int field_blocks(long long threads) {
  const long long b = (threads + kFieldBlock - 1) / kFieldBlock;
  return static_cast<unsigned int>(b > 0 ? b : 1);
}

inline CellMap cell_map(float inv, int gx, int gy, int gz, int ox, int oy,
                        int oz, int s) {
  return CellMap{inv, {gx, gy, gz}, {ox, oy, oz}, s};
}

inline unsigned int gather_blocks(long long n) {
  return static_cast<unsigned int>((n + kGatherBlock - 1) / kGatherBlock);
}

}  // namespace pst

// out[i] = table[rows[i] * 128 + lanes[i]] for i < n, on ``stream``.
// Returns a cudaError_t (0 on success).
extern "C" int pst_banded_gather(const void* table, const void* rows,
                                 const void* lanes, void* out, long long n,
                                 void* stream) {
  using namespace pst;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  banded_gather<<<gather_blocks(n), kGatherBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(lanes), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// The (n, 3) float32 field of n particles from the packed diff grid, on
// ``stream``.  Returns a cudaError_t (0 on success).
extern "C" int pst_packed_field_gather(const void* packed, const void* flat,
                                       const void* weight, float e_const,
                                       void* out, long long n, void* stream) {
  using namespace pst;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  packed_field_gather<<<gather_blocks(n), kGatherBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(packed), static_cast<const int32_t*>(flat),
      static_cast<const int32_t*>(weight), e_const, static_cast<float*>(out),
      n);
  return static_cast<int>(cudaGetLastError());
}

// The bounds words of the live rows among the first m of pos (m, 3) and
// status (m,) on ``stream``: words (6,) int32 zeroed, then max-reduced
// (see the note at the top).  Returns a cudaError_t (0 on success).
extern "C" int pst_subgrid_bbox(const void* pos, const void* status,
                                long long m, float inv, int gx, int gy,
                                int gz, void* words, void* stream) {
  using namespace pst;
  if (m < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(words, 0, 6 * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (m + kFieldBlock - 1) / kFieldBlock;
  const unsigned int blocks =
      want < 1 ? 1u : static_cast<unsigned int>(want < kBboxBlocks ? want : kBboxBlocks);
  subgrid_bbox<<<blocks, kFieldBlock, 0, s>>>(
      static_cast<const float*>(pos), static_cast<const int32_t*>(status), m,
      cell_map(inv, gx, gy, gz, 0, 0, 0, 0), static_cast<int32_t*>(words));
  return static_cast<int>(cudaGetLastError());
}

// The S^3 int32 counts of the live rows among the first m, the window at
// (ox, oy, oz): counts zeroed, then one add a row, on ``stream``.  Returns
// a cudaError_t (0 on success).
extern "C" int pst_subgrid_deposit(const void* pos, const void* status,
                                   long long m, float inv, int gx, int gy,
                                   int gz, int ox, int oy, int oz, int s,
                                   void* counts, void* stream) {
  using namespace pst;
  if (m < 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(s) * s * s * sizeof(int32_t);
  cudaError_t err = cudaMemsetAsync(counts, 0, bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  subgrid_deposit<<<field_blocks(m), kFieldBlock, 0, st>>>(
      static_cast<const float*>(pos), static_cast<const int32_t*>(status), m,
      cell_map(inv, gx, gy, gz, ox, oy, oz, s),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// acc (capacity, 3) float32, every row written: the field of the live rows
// among the first m from the S^3 counts at (ox, oy, oz), 0 elsewhere, on
// ``stream``.  Returns a cudaError_t (0 on success).
extern "C" int pst_subgrid_field_store(const void* pos, const void* status,
                                       long long m, long long capacity,
                                       float inv, int gx, int gy, int gz,
                                       int ox, int oy, int oz, int s,
                                       const void* counts, float e_const,
                                       void* acc, void* stream) {
  using namespace pst;
  if (m < 0 || m > capacity || s <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  subgrid_field_store<<<field_blocks((3 * capacity + 3) / 4), kFieldBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const int32_t*>(status), m,
      capacity, cell_map(inv, gx, gy, gz, ox, oy, oz, s),
      static_cast<const int32_t*>(counts), e_const, static_cast<float*>(acc));
  return static_cast<int>(cudaGetLastError());
}
