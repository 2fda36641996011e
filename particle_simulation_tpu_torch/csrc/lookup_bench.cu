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
// to the plain version.  A row holds 128 lanes, so (hi, lo) is the flat
// entry idx, and only entries [128, 1024) (rows 1-7) are ever read.
//
// The TPU kernel's modes a-d are four ways of sweeping the band of table
// rows with broadcasts and lane gathers, because the TPU has no per-lane
// gather; all compute this one function (mode e, no lookup, is the
// floor).  Hopper gathers per thread, so the variants here ask where the
// table should live:
//   global: both tables read through the read-only cache (__ldg), as
//           csrc/lookup.cuh reads the engine's table;
//   shared: both whole tables (2 x 79 x 128 floats = 80,896 B) staged once
//           per block, as VMEM holds them for the TPU kernel;
//   banked: the 896 readable entries in shared memory, laid out so that no
//           load conflicts (below): the kernel's design;
//   paired: banked's loop on one copy of the (split, remove) pairs, the
//           layout of the engines' SharedTable (lookup.cuh), whose loads
//           conflict as `shared`'s do: what the 16 copies save;
//   none:   no lookup, acc stays 0 (the floor; the compiler drops the
//           loop).
//
// What bounds it on the H100.  Not memory: x in and acc out are 7.9 MB at
// the probe's 60 tiles, about 2.4 us at 3.35 TB/s.  The yardstick is the
// operations, 8 a lane-step (probes/microbench_lookup.py OPS_PER_STEP) at
// 67 TFLOP/s: 0.0117 ms for the probe's 9.83e7 lane-steps.  A table in
// shared memory sets a ceiling above that: each lane-step loads 2 x 4 B,
// and an SM's shared memory serves 128 B a clock, so 7.9e8 B over 132 SMs
// take about 46,500 clocks, 0.024 ms at 1.98 GHz, twice the bound.
//
// The banked design, against what held `shared` at 0.095 ms:
//   * Bank conflicts.  `shared` reads two 4-byte words at indices that
//     scatter over [128, 1024), so a warp's 32 lanes meet 3-4 to a bank.
//     Here entry i is one float2 (split, remove), the engines' pair layout
//     (lookup.cuh), so one 8-byte load serves a lane-step, and the 7 KB of
//     pairs are replicated into kBankCopies = 16 copies: entry i of copy c
//     sits at float2 slot i * 16 + c, and lane l reads copy l & 15.  A
//     64-bit load is served a half-warp at a time; the slot's banks are
//     2c and 2c + 1 whatever i is, so each half-warp covers the 32 banks
//     once and no load conflicts.  114,688 B a block: two blocks of 1024
//     threads share an SM's 233,472 B (with 1 KB reserved each), which the
//     occupancy query checks at the first launch.
//   * Index arithmetic.  x + 37t with x += 1 is x0 + 38t, so the kernel
//     carries r = (x0 + 38t) mod 896 and steps it by r += 38, r -= 896 if
//     r >= 896: no division in the loop.  A lane whose x0 + 38t wraps int32
//     within its T steps (x0 > INT32_MAX - 38 (T - 1)) gets another result
//     from that rule, since 2^32 mod 896 = 256, and takes the exact formula.
//   * Staging.  Only the 896 readable entries are staged, once per block:
//     thread i loads entry i's pair in one L2 round trip and stores its 16
//     copies (a loop over slots waited on 14 round trips a thread).
//   * The last wave.  The grid is the resident one (blocks per SM from the
//     occupancy query, times the SMs), and block b takes the contiguous
//     lanes [n b / G, n (b + 1) / G): every SM gets the same share within
//     two lanes, where a grid-stride loop over 1024-lane blocks left a
//     quarter of the card idle in its last round.
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace pst {

constexpr int kLookupThreads = 1024;
constexpr int kLookupBlocksPerSm = 2;
constexpr int kLookupNone = 0;
constexpr int kLookupGlobal = 1;
constexpr int kLookupShared = 2;
constexpr int kLookupBanked = 3;
constexpr int kLookupPaired = 4;
constexpr int kLookupLanes = 128;
constexpr uint32_t kLookupStride = 37u;
constexpr int kLookupStep = kLookupStride + 1;  // x + 37t with x += 1
constexpr int kLookupSpan = 7 * kLookupLanes;   // 896
constexpr int kLookupOffset = kLookupLanes;     // 128
constexpr int kBankCopies = 16;
template <int COPIES>  // the staged pairs, COPIES copies
constexpr int kPairBytes =
    kLookupSpan * COPIES * static_cast<int>(sizeof(float2));
constexpr int kLookupMaxDevices = 64;

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

// COPIES = kBankCopies: the banked variant; COPIES = 1: paired, the same
// loop on one copy of the pairs, the engines' layout, whose loads conflict
template <int COPIES>
__global__ void __launch_bounds__(kLookupThreads, kLookupBlocksPerSm)
lookup_bench_banked(const int32_t* __restrict__ x,
                    const float* __restrict__ split,
                    const float* __restrict__ remove, float* __restrict__ out,
                    long long n, int t_steps) {
  extern __shared__ float2 banked[];  // entry i of copy c at i * COPIES + c
  // thread i loads entry i's pair once and writes its copies, copy
  // (c + i) % COPIES at store c, so a half-warp's stores meet no bank twice
  if (threadIdx.x < kLookupSpan) {
    const int i = threadIdx.x;
    const float2 pair =
        make_float2(split[kLookupOffset + i], remove[kLookupOffset + i]);
#pragma unroll
    for (int c = 0; c < COPIES; ++c) {
      banked[i * COPIES + ((c + i) & (COPIES - 1))] = pair;
    }
  }
  __syncthreads();
  // this thread's copy, addressed in bytes: entry r at r * kRowBytes
  constexpr int kRowBytes = COPIES * static_cast<int>(sizeof(float2));
  constexpr int kSpanBytes = kLookupSpan * kRowBytes;
  constexpr int kStepBytes = kLookupStep * kRowBytes;
  const char* copy =
      reinterpret_cast<const char*>(banked + (threadIdx.x & (COPIES - 1)));
  // lanes up to here step r without wrapping int32 (t_steps >= 0)
  const long long last_stepped =
      INT_MAX - static_cast<long long>(kLookupStep) * (t_steps - 1);
  const long long lo = n * blockIdx.x / gridDim.x;
  const long long hi = n * (blockIdx.x + 1) / gridDim.x;
  for (long long e = lo + threadIdx.x; e < hi; e += kLookupThreads) {
    const int32_t x0 = x[e];
    float acc = 0.0f;
    if (x0 <= last_stepped) {
      int r = x0 % kLookupSpan;
      if (r < 0) r += kLookupSpan;
      int o = r * kRowBytes;
#pragma unroll 4
      for (int t = 0; t < t_steps; ++t) {
        const float2 p = *reinterpret_cast<const float2*>(copy + o);
        acc = __fadd_rn(__fadd_rn(acc, p.x), p.y);
        o += kStepBytes;
        o -= o >= kSpanBytes ? kSpanBytes : 0;
      }
    } else {  // x0 + 38t wraps int32: the exact formula, step by step
      for (int t = 0; t < t_steps; ++t) {
        const int v = static_cast<int>(static_cast<uint32_t>(x0) +
                                       static_cast<uint32_t>(kLookupStep) *
                                           static_cast<uint32_t>(t));
        int r = v % kLookupSpan;
        if (r < 0) r += kLookupSpan;
        const float2 p =
            *reinterpret_cast<const float2*>(copy + r * kRowBytes);
        acc = __fadd_rn(__fadd_rn(acc, p.x), p.y);
      }
    }
    out[e] = acc;
  }
}

// lookup_bench_banked<COPIES>'s resident blocks per SM and the SM count of
// the current device, set up and queried once per device.  An error, or no
// resident block, is returned and never cached.
template <int COPIES>
cudaError_t banked_occupancy(int* per_sm, int* sms) {
  static std::atomic<int> cached_per_sm[kLookupMaxDevices];
  static std::atomic<int> cached_sms[kLookupMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kLookupMaxDevices) return cudaErrorInvalidDevice;
  *per_sm = cached_per_sm[dev].load(std::memory_order_acquire);
  if (*per_sm > 0) {
    *sms = cached_sms[dev].load(std::memory_order_relaxed);
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(lookup_bench_banked<COPIES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPairBytes<COPIES>);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(lookup_bench_banked<COPIES>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, lookup_bench_banked<COPIES>, kLookupThreads,
        kPairBytes<COPIES>);
  }
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  cached_sms[dev].store(*sms, std::memory_order_relaxed);
  cached_per_sm[dev].store(*per_sm, std::memory_order_release);
  return cudaSuccess;
}

// The resident grid (at most one block a 1024 lanes) on ``stream``.
template <int COPIES>
cudaError_t launch_banked(const int32_t* x, const float* split,
                          const float* remove, float* out, long long n,
                          int t_steps, cudaStream_t stream) {
  int per_sm = 0, sms = 0;
  cudaError_t err = banked_occupancy<COPIES>(&per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const long long want = (n + kLookupThreads - 1) / kLookupThreads;
  const unsigned int blocks =
      static_cast<unsigned int>(want < resident ? want : resident);
  constexpr int bytes = kPairBytes<COPIES>;
  lookup_bench_banked<COPIES><<<blocks, kLookupThreads, bytes, stream>>>(
      x, split, remove, out, n, t_steps);
  return cudaGetLastError();
}

}  // namespace pst

// out[e] (n floats) from the n int32 lanes ``x`` and the two tables of
// ``table_elems`` floats each (rows of 128), over ``t_steps`` steps, on
// ``stream``; ``variant`` 0 none, 1 global, 2 shared, 3 banked, 4 paired.
// Returns a cudaError_t (0 on success), including a refused launch and, for
// banked and paired, a failed occupancy query or no resident block.
extern "C" int pst_lookup_bench(const void* x, const void* split,
                                const void* remove, void* out, long long n,
                                int table_elems, int t_steps, int variant,
                                void* stream) {
  using namespace pst;
  if (n <= 0 || t_steps < 0 || table_elems < kLookupOffset + kLookupSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int32_t*>(x);
  const auto* sp = static_cast<const float*>(split);
  const auto* rp = static_cast<const float*>(remove);
  auto* op = static_cast<float*>(out);
  if (variant == kLookupBanked) {
    return static_cast<int>(
        launch_banked<kBankCopies>(xp, sp, rp, op, n, t_steps, st));
  }
  if (variant == kLookupPaired) {
    return static_cast<int>(launch_banked<1>(xp, sp, rp, op, n, t_steps, st));
  }
  cudaError_t err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (n + kLookupThreads - 1) / kLookupThreads;
  const unsigned int blocks = static_cast<unsigned int>(
      want < static_cast<long long>(kLookupBlocksPerSm) * sms
          ? want : static_cast<long long>(kLookupBlocksPerSm) * sms);
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

// The banked variant's resident blocks of 1024 threads per SM on the
// current device (the occupancy query its launch makes), into
// ``*blocks_per_sm``.  Returns a cudaError_t (0 on success).
extern "C" int pst_lookup_bench_banked_blocks(void* blocks_per_sm) {
  int sms = 0;
  return static_cast<int>(pst::banked_occupancy<pst::kBankCopies>(
      static_cast<int*>(blocks_per_sm), &sms));
}
