// The field phase's gather on Hopper.
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
