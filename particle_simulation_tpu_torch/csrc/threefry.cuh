// Threefry-2x32 and the draw protocol of rng.py, as functions a kernel
// inlines.  The cipher and every derived word are bitwise equal to
// particle_simulation_tpu/rng.py (and to the port's plain rng.py).
//
// The functions are __host__ __device__ so that a host compiler can check
// the arithmetic too; the kernels use them on the device.
#pragma once

#include <cstdint>
#include <cmath>

#if defined(__CUDACC__)
#define PST_HD __host__ __device__ __forceinline__
#else
#define PST_HD inline
#endif

namespace pst {

constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kKsParity = 0x1BD11BDAu;

// a*b + c rounded once.  Every multiply-add of the physics is written
// through this (or as a plain product and a plain sum): the build passes
// -fmad=false, so the compiler contracts nothing on its own.
PST_HD float fma_rn(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
  return __fmaf_rn(a, b, c);
#else
  return std::fma(a, b, c);
#endif
}

PST_HD constexpr int threefry_rotation(int r) {
  return r == 0 ? 13 : r == 1 ? 15 : r == 2 ? 26 : r == 3 ? 6
       : r == 4 ? 17 : r == 5 ? 29 : r == 6 ? 16 : 24;
}

PST_HD uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32 with ROUNDS rounds (13 and 20 are the configured values).
template <int ROUNDS>
PST_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                         uint32_t& o0, uint32_t& o1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kKsParity};
  uint32_t x0 = c0 + k0;
  uint32_t x1 = c1 + k1;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    x0 += x1;
    x1 = rotl32(x1, threefry_rotation(r % 8));
    x1 ^= x0;
    if ((r + 1) % 4 == 0) {
      const int inject = (r + 1) / 4;
      x0 += ks[inject % 3];
      x1 += ks[(inject + 1) % 3] + static_cast<uint32_t>(inject);
    }
  }
  o0 = x0;
  o1 = x1;
}

// Top 24 bits -> [lo, lo + span), scale and shift rounded separately as
// in rng.uniform_from_bits (the draws use lo = 0).
PST_HD float uniform_from_bits(uint32_t bits, float span, float lo) {
  const float u01 =
      static_cast<float>(static_cast<int32_t>(bits >> 8)) * 5.9604644775390625e-08f;
  return u01 * span + lo;
}

// The collision draw u in [0, 100) and the child id of mobility step t
// (rng.step_draws_mode).  block2: one block per step pair, keyed at t & ~1;
// the caller passes the pair block (b0, b1) and the parity of t.
struct Draw {
  float u;
  uint32_t child_hi;
  uint32_t child_lo;
};

PST_HD Draw draw_from_block(uint32_t b0, uint32_t b1, bool odd) {
  Draw d;
  if (odd) {
    d.u = uniform_from_bits(b1, 100.0f, 0.0f);
    d.child_hi = b0 + kGolden;
    d.child_lo = b1 ^ kGolden;
  } else {
    d.u = uniform_from_bits(b0, 100.0f, 0.0f);
    d.child_hi = b1;
    d.child_lo = b0 ^ kGolden;
  }
  return d;
}

}  // namespace pst
