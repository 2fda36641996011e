// The cross-section lookup: energy -> bucket -> (split, remove) chances.
//
// Replaces the outcome of particle_simulation_tpu/ops/pallas/push_mcc.py::
// make_chunked_lookup (its chunk-swept lane gathers exist because the TPU
// has no per-lane gather from an 80 KB table).  Here each lane reads its
// bucket's (split, remove) pair as one 8-byte load: through the read-only
// data cache (the staged engine; the population's energies sit in few
// buckets, so the reads hit the cache), or from a copy in shared memory
// (the work-log engine, whose persistent blocks copy it once a phase).
#pragma once

#include "threefry.cuh"

#ifndef PST_N_STEPS
#error "PST_N_STEPS must be defined by the build (ops/kernels/build.py)"
#endif

namespace pst {

// trunc((log10 E + 6) * N/22) clamped to [0, N-1]
// (cross_section.energy_to_index).  log10 is log(E) * float32(1/ln 10) and
// "+ 6" is fused into it, as XLA computes it.  logf is the full-accuracy
// one: the build uses no fast-math flag.
PST_HD int energy_to_index(float e, float log10_e, float bucket_scale) {
  float x = truncf(fma_rn(logf(e), log10_e, 6.0f) * bucket_scale);
  if (x != x) x = 0.0f;
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(PST_N_STEPS - 1));
  return static_cast<int>(x);
}

PST_HD float2 table_lookup(const float2* __restrict__ table, float e,
                           float log10_e, float bucket_scale) {
  const float2* row = table + energy_to_index(e, log10_e, bucket_scale);
#if defined(__CUDA_ARCH__)
  return __ldg(row);
#else
  return *row;
#endif
}

// The table staged in shared memory by a kernel whose blocks live long
// enough to amortise the copy (worklog.cu): a plain load, no read-only
// cache.
struct SharedTable {
  const float2* rows;
};

PST_HD float2 table_lookup(SharedTable table, float e, float log10_e,
                           float bucket_scale) {
  return table.rows[energy_to_index(e, log10_e, bucket_scale)];
}

}  // namespace pst
