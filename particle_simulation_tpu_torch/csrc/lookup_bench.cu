// A 100-step table lookup over a tile of lanes: the engine's T loop in
// miniature, with the table read where the kernel chooses.
//
// Replaces scripts/microbench_lookup.py::kernel.  For each int32 lane x
// and t = 0 .. T-1:
//   idx = (x + 37 t) mod 896 + 128, hi = idx >> 7, lo = idx & 127,
//   acc = (acc + split[hi, lo]) + remove[hi, lo],  x += 1,
// with acc starting at 0.0f; out = acc.  The int32 sums wrap and mod is
// the floor modulo (as in jnp and torch), so idx stays in [128, 1024) and
// every read is inside the table whatever x holds.  The two adds are
// rounded in that order (__fadd_rn), bitwise equal to the TPU kernel and
// to the plain version.
//
// The TPU kernel's modes a-d are four ways of sweeping the band of table
// rows with broadcasts and lane gathers, because the TPU has no per-lane
// gather; all compute this one function (mode e, no lookup, is the
// floor).  Hopper gathers per thread, so the variants here ask where the
// table should live:
//   global: both tables read through the read-only cache (__ldg), as
//           csrc/lookup.cuh reads the engine's table;
//   shared: both tables (2 x 79 x 128 floats = 80,896 B, above the 48 KB
//           static limit, so dynamic shared memory) staged once per block,
//           as VMEM holds them for the TPU kernel;
//   none:   no lookup, acc stays 0 (the floor; the compiler drops the
//           loop).
// Blocks of 1024 threads, two per SM (the shared variant's 80 KB each),
// loop over the lanes, so a block stages the table once for several.
//
// What bounds it on the H100: not memory (x in and acc out, 7.9 MB at the
// probe's 60 tiles: about 2.4 us at 3.35 TB/s) but the issue of the table
// reads and the dependent adds, 2 reads and about 10 operations a lane and
// step (about 1e9 operations at the probe's size).
#include <cuda_runtime.h>

#include <cstdint>

namespace pst {

constexpr int kLookupThreads = 1024;
constexpr int kLookupBlocksPerSm = 2;
constexpr int kLookupNone = 0;
constexpr int kLookupGlobal = 1;
constexpr int kLookupShared = 2;
constexpr int kLookupLanes = 128;
constexpr uint32_t kLookupStride = 37u;
constexpr int kLookupSpan = 7 * kLookupLanes;  // 896
constexpr int kLookupOffset = kLookupLanes;    // 128

template <int VARIANT>
__global__ void __launch_bounds__(kLookupThreads, kLookupBlocksPerSm)
lookup_bench(const int32_t* __restrict__ x, const float* __restrict__ split,
             const float* __restrict__ remove, float* __restrict__ out,
             long long n, int table_elems, int t_steps) {
  extern __shared__ float staged[];  // shared variant: split, then remove
  if (VARIANT == kLookupShared) {
    for (int i = threadIdx.x; i < table_elems; i += kLookupThreads) {
      staged[i] = split[i];
      staged[table_elems + i] = remove[i];
    }
    __syncthreads();
  }
  const long long step = static_cast<long long>(gridDim.x) * kLookupThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kLookupThreads +
                     threadIdx.x;
       e < n; e += step) {
    uint32_t xv = static_cast<uint32_t>(x[e]);
    float acc = 0.0f;
    for (int t = 0; t < t_steps; ++t) {
      if (VARIANT != kLookupNone) {
        const int v =
            static_cast<int>(xv + kLookupStride * static_cast<uint32_t>(t));
        int r = v % kLookupSpan;
        if (r < 0) r += kLookupSpan;
        const int idx = r + kLookupOffset;
        const int flat = (idx >> 7) * kLookupLanes + (idx & (kLookupLanes - 1));
        float s, q;
        if (VARIANT == kLookupShared) {
          s = staged[flat];
          q = staged[table_elems + flat];
        } else {
          s = __ldg(split + flat);
          q = __ldg(remove + flat);
        }
        acc = __fadd_rn(__fadd_rn(acc, s), q);
      }
      xv += 1u;
    }
    out[e] = acc;
  }
}

}  // namespace pst

// out[e] (n floats) from the n int32 lanes ``x`` and the two tables of
// ``table_elems`` floats each (rows of 128), over ``t_steps`` steps, on
// ``stream``; ``variant`` 0 none, 1 global, 2 shared.  Returns a
// cudaError_t (0 on success), including a refused launch.
extern "C" int pst_lookup_bench(const void* x, const void* split,
                                const void* remove, void* out, long long n,
                                int table_elems, int t_steps, int variant,
                                void* stream) {
  using namespace pst;
  if (n <= 0 || t_steps < 0 || table_elems < kLookupOffset + kLookupSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kLookupThreads - 1) / kLookupThreads;
  const unsigned int blocks = static_cast<unsigned int>(
      want < static_cast<long long>(kLookupBlocksPerSm) * sms
          ? want : static_cast<long long>(kLookupBlocksPerSm) * sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* sp = static_cast<const float*>(split);
  const auto* rp = static_cast<const float*>(remove);
  auto* op = static_cast<float*>(out);
  if (variant == kLookupShared) {
    const int bytes = 2 * table_elems * static_cast<int>(sizeof(float));
    err = cudaFuncSetAttribute(lookup_bench<kLookupShared>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    lookup_bench<kLookupShared><<<blocks, kLookupThreads, bytes, st>>>(
        xp, sp, rp, op, n, table_elems, t_steps);
  } else if (variant == kLookupGlobal) {
    lookup_bench<kLookupGlobal><<<blocks, kLookupThreads, 0, st>>>(
        xp, sp, rp, op, n, table_elems, t_steps);
  } else if (variant == kLookupNone) {
    lookup_bench<kLookupNone><<<blocks, kLookupThreads, 0, st>>>(
        xp, sp, rp, op, n, table_elems, t_steps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
