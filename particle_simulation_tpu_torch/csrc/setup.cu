// The set-up on Hopper: a whole initial SimState in one launch.
//
// Replaces no TPU kernel: the JAX package seeds its state with plain jnp
// (particle_simulation_tpu/state.py setup_particles), and so does the
// port's plain twin (state.py seed_plain).  It was added because that plain
// seeding, run as PyTorch operations on the card, took about 228 ms of
// device time at capacity 5e7 (one episode of the benchmark's rows): it
// runs Threefry-2x32 as some 170 masked int64 operations a block, once for
// the ids and once an axis, over every slot, then keeps the first init_n
// slots' draws with torch.where and zeroes the rest.
//
// What it writes, bit for bit the plain twin's:
//   * slot i < init_n: (id_hi, id_lo) = threefry2x32<20>(seed, kGolden, 0,
//     uint32(i + slot_offset)); per axis a, the block (id_hi, id_lo,
//     0xFFFFFFFF, a) gives u01 = top 24 bits * 2^-24 and the position
//     u01 * scale + lo, the product and the sum rounded apart (__fmul_rn,
//     __fadd_rn: rng.uniform_from_bits), widened exactly to double under
//     precision "f64"; status ALIVE, acc 0, and vel 0 or, with init_vth,
//     vth * N(0, 1) per axis: Box-Muller on the block (id_hi, id_lo,
//     0xFFFFFFFF, a + 8) with u1 clamped to 2^-25 and log, sqrt and cos
//     taken in double and rounded once to float (rng.setup_gaussian), the
//     product rounded in the state's float type;
//   * slot i >= init_n: every word 0 (STATUS_EMPTY is 0).
//
// What bounds it on the H100: the bytes it writes, 48 B a slot (72 under
// "f64"): 2.4e9 B at capacity 5e7, 0.716 ms at 3.35 TB/s.  Threefry runs
// for the live slots only (init_n = 1e6 against 5e7 slots: about 3e8
// integer operations, a few microseconds of the card).  The design:
//   * One launch, no synchronise, no copy from the host: every scalar is a
//     kernel argument, and each word of each field is written once.
//   * A grid of a few blocks an SM, each thread striding first over the
//     live slots (its ids, positions and velocities in registers, stored
//     field by field), then over the zero tail of each of the six arrays
//     with 16-byte stores, neighbouring threads on neighbouring addresses
//     (a field's tail starts at any 4-byte boundary: its first and last
//     few words take 4-byte stores).
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace pst {

constexpr int kSetupBlock = 256;
constexpr int kSetupBlocksPerSm = 8;
constexpr uint32_t kSetupCtr = 0xFFFFFFFFu;  // rng.SETUP_CTR
constexpr int32_t kStatusAlive = -1;         // constants.STATUS_ALIVE
constexpr float kTwoPiF32 = 6.2831854820251465f;  // constants.TWO_PI_F32

struct SetupAffine {
  float scale[3];  // rng.affine(lo, hi)[0] of each axis
  float shift[3];  // rng.affine(lo, hi)[1]
};

__device__ __forceinline__ float top24_u01(uint32_t bits) {
  return __fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f);
}

// rng.setup_uniform: one axis of the initial placement
__device__ __forceinline__ float setup_uniform(uint32_t hi, uint32_t lo,
                                               uint32_t axis, float scale,
                                               float shift) {
  uint32_t b0, b1;
  threefry2x32<20>(hi, lo, kSetupCtr, axis, b0, b1);
  return __fadd_rn(__fmul_rn(top24_u01(b0), scale), shift);
}

// rng.setup_gaussian: one axis of the thermal start's N(0, 1)
__device__ __forceinline__ float setup_gaussian(uint32_t hi, uint32_t lo,
                                                uint32_t axis) {
  uint32_t b0, b1;
  threefry2x32<20>(hi, lo, kSetupCtr, axis + 8u, b0, b1);
  const float u1 = fmaxf(top24_u01(b0), 2.98023223876953125e-08f);  // 2^-25
  const float u2 = top24_u01(b1);
  const float l = static_cast<float>(log(static_cast<double>(u1)));
  const float r = static_cast<float>(sqrt(static_cast<double>(__fmul_rn(-2.0f, l))));
  const float c = static_cast<float>(cos(static_cast<double>(__fmul_rn(kTwoPiF32, u2))));
  return __fmul_rn(r, c);
}

// init_vth * g rounded in the state's float type (vth is float32(init_vth)
// for float, init_vth for double)
__device__ __forceinline__ float thermal(float vth, float g) {
  return __fmul_rn(vth, g);
}
__device__ __forceinline__ double thermal(double vth, float g) {
  return __dmul_rn(vth, static_cast<double>(g));
}

// zero the 4-byte words [w0, w1) of base, 16 bytes a store where aligned
__device__ __forceinline__ void zero_words(uint32_t* __restrict__ base,
                                           long long w0, long long w1,
                                           long long tid, long long stride) {
  if (w0 >= w1) return;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(base + w0);
  long long a0 = w0 + static_cast<long long>(((16u - (addr & 15u)) & 15u) / 4u);
  if (a0 > w1) a0 = w1;
  const long long vecs = (w1 - a0) / 4;
  const long long a1 = a0 + 4 * vecs;
  if (tid < a0 - w0) base[w0 + tid] = 0u;
  if (tid < w1 - a1) base[a1 + tid] = 0u;
  uint4* v = reinterpret_cast<uint4*>(base + a0);
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (long long j = tid; j < vecs; j += stride) v[j] = z;
}

template <typename T>
__global__ void __launch_bounds__(kSetupBlock)
setup_seed(T* __restrict__ pos, T* __restrict__ vel, float* __restrict__ acc,
           int32_t* __restrict__ status, uint32_t* __restrict__ id_hi,
           uint32_t* __restrict__ id_lo, long long capacity, long long init_n,
           long long slot_offset, uint32_t seed, SetupAffine box, double vth,
           int thermal_start) {
  const long long stride = static_cast<long long>(gridDim.x) * kSetupBlock;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kSetupBlock + threadIdx.x;
  for (long long i = tid; i < init_n; i += stride) {
    uint32_t hi, lo;
    threefry2x32<20>(seed, kGolden, 0u,
                     static_cast<uint32_t>(i + slot_offset), hi, lo);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pos[3 * i + a] = static_cast<T>(
          setup_uniform(hi, lo, a, box.scale[a], box.shift[a]));
      vel[3 * i + a] = thermal_start
          ? thermal(static_cast<T>(vth), setup_gaussian(hi, lo, a)) : T(0);
      acc[3 * i + a] = 0.0f;
    }
    status[i] = kStatusAlive;
    id_hi[i] = hi;
    id_lo[i] = lo;
  }
  constexpr long long kWords = sizeof(T) / 4;  // 4-byte words of a T
  zero_words(reinterpret_cast<uint32_t*>(pos), 3 * kWords * init_n,
             3 * kWords * capacity, tid, stride);
  zero_words(reinterpret_cast<uint32_t*>(vel), 3 * kWords * init_n,
             3 * kWords * capacity, tid, stride);
  zero_words(reinterpret_cast<uint32_t*>(acc), 3 * init_n, 3 * capacity,
             tid, stride);
  zero_words(reinterpret_cast<uint32_t*>(status), init_n, capacity, tid,
             stride);
  zero_words(id_hi, init_n, capacity, tid, stride);
  zero_words(id_lo, init_n, capacity, tid, stride);
}

}  // namespace pst

// The initial SimState of capacity slots, init_n of them live, on stream:
// every field of every slot written once (see the note above).  f64 selects
// double pos and vel; thermal_start the velocity vth * N(0, 1).  Returns a
// cudaError_t (0 on success).
extern "C" int pst_setup_seed(void* pos, void* vel, void* acc, void* status,
                              void* id_hi, void* id_lo, long long capacity,
                              long long init_n, long long slot_offset,
                              unsigned int seed, float lo_x, float lo_y,
                              float lo_z, float scale_x, float scale_y,
                              float scale_z, double vth, int thermal_start,
                              int f64, void* stream) {
  using namespace pst;
  if (capacity <= 0 || init_n < 0 || init_n > capacity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // a thread for each live slot or each 16-byte store of pos, the largest
  // field, up to kSetupBlocksPerSm blocks an SM
  const long long stores = 3 * capacity * (f64 ? 2 : 1) / 4 + 1;
  const long long work = init_n > stores ? init_n : stores;
  long long blocks = (work + kSetupBlock - 1) / kSetupBlock;
  const long long most = static_cast<long long>(sms) * kSetupBlocksPerSm;
  if (blocks > most) blocks = most;
  SetupAffine box = {{scale_x, scale_y, scale_z}, {lo_x, lo_y, lo_z}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) {
    setup_seed<double><<<static_cast<unsigned int>(blocks), kSetupBlock, 0, s>>>(
        static_cast<double*>(pos), static_cast<double*>(vel),
        static_cast<float*>(acc), static_cast<int32_t*>(status),
        static_cast<uint32_t*>(id_hi), static_cast<uint32_t*>(id_lo),
        capacity, init_n, slot_offset, seed, box, vth, thermal_start);
  } else {
    setup_seed<float><<<static_cast<unsigned int>(blocks), kSetupBlock, 0, s>>>(
        static_cast<float*>(pos), static_cast<float*>(vel),
        static_cast<float*>(acc), static_cast<int32_t*>(status),
        static_cast<uint32_t*>(id_hi), static_cast<uint32_t*>(id_lo),
        capacity, init_n, slot_offset, seed, box, vth, thermal_start);
  }
  return static_cast<int>(cudaGetLastError());
}
