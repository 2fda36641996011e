// One particle's mobility steps start..T: leapfrog push, bounds kill,
// draws, table lookup, split or absorb, and the suspension of a lane whose
// child slots are full.  The float32 expressions are those of the port's
// ops/physics.py (and of XLA's contraction of the JAX package's
// ops/physics.py), operation for operation.
//
// The status encodings come from ops/kernels/push_mcc.py through macros
// (build.py), so Python and CUDA share one definition.
#pragma once

#include "lookup.cuh"
#include "threefry.cuh"

#if !defined(PST_SUS_BASE) || !defined(PST_STAMP_BITS) || \
    !defined(PST_INF_START) || !defined(PST_FIN_BASE)
#error "status encodings must be defined by the build (ops/kernels/build.py)"
#endif

namespace pst {

constexpr int kStatusEmpty = 0;  // constants.py STATUS_*
constexpr int kStatusAlive = -1;
constexpr int kStatusDead = -2;

struct PhysConsts {
  float dt;            // float32(mobility_dt)
  float half_dt;       // float32(dt) / 2
  float size_x, size_y, size_z;  // float32(sim_size)
  float log10_e;       // float32(1 / ln 10)
  float bucket_scale;  // float32(N_STEPS / 22)
  uint32_t seed;
  uint32_t poisson_step;
  int t_steps;
};

PST_HD bool is_suspended(int s) { return s <= PST_SUS_BASE; }

PST_HD bool is_unfinished(int s) { return s == -1 || s > 0 || is_suspended(s); }

// finished inside the staged engine's fixed point: (SUS_BASE, FIN_BASE]
// packs the lane's stamp (ALIVE or its spawn step)
PST_HD int encode_finished(int stamp) { return PST_FIN_BASE - (stamp + 2); }

PST_HD bool is_finished(int s) { return s <= PST_FIN_BASE && s > PST_SUS_BASE; }

PST_HD int decode_finished(int s) { return PST_FIN_BASE - s - 2; }

PST_HD int encode_suspended(int resume, int stamp) {
  return PST_SUS_BASE - (((resume - 1) << PST_STAMP_BITS) | (stamp + 2));
}

PST_HD int suspended_resume(int s) {
  return ((PST_SUS_BASE - s) >> PST_STAMP_BITS) + 1;
}

PST_HD int suspended_stamp(int s) {
  return ((PST_SUS_BASE - s) & ((1 << PST_STAMP_BITS) - 1)) - 2;
}

// First mobility step of a record: fresh (-1) at 1, a child stamped t at
// t + 1, a suspended lane at its packed resume step; never for the rest.
PST_HD int start_step(int s) {
  return s == -1 ? 1
       : s > 0 ? s + 1
       : is_suspended(s) ? suspended_resume(s) : PST_INF_START;
}

struct Lane {
  float px, py, pz, vx, vy, vz, ax, ay, az;
  int status;
  uint32_t id_hi, id_lo;
};

struct Child {
  float px, py, pz, vx, vy, vz;
  int stamp;
  uint32_t id_hi, id_lo;
};

// Runs lane L (an unfinished record) through steps start..t_steps and
// returns the number of steps it moved.  ``table`` is the table in device
// memory (const float2*) or staged in shared memory (SharedTable).  On
// return L.status is ALIVE or a child stamp (finished), DEAD, or the
// suspended packing; children[0..n_children) hold the children it spawned
// (at most D: a lane with D children suspends at its next step).
template <int D, int ROUNDS, bool BLOCK2, typename Table>
PST_HD int advance_lane(Lane& L, Child (&children)[D], int& n_children,
                        Table table,
                        const PhysConsts& k) {
  const int s0 = L.status;
  int stamp = is_suspended(s0) ? suspended_stamp(s0) : s0;
  const float kx = L.ax * k.half_dt;
  const float ky = L.ay * k.half_dt;
  const float kz = L.az * k.half_dt;
  const uint32_t key0 = L.id_hi ^ k.seed;
  uint32_t b0 = 0, b1 = 0;
  bool have_block = false;
  int depth = 0;
  int pushes = 0;
  for (int t = start_step(s0); t <= k.t_steps; ++t) {
    if (depth >= D) {
      stamp = encode_suspended(t, stamp);
      break;
    }
    ++pushes;
    // draws: the pair block at t & ~1 (block2) or one block per step
    if (!BLOCK2 || !have_block || (t & 1) == 0) {
      const uint32_t ctr1 =
          BLOCK2 ? (static_cast<uint32_t>(t) & ~1u) : static_cast<uint32_t>(t);
      threefry2x32<ROUNDS>(key0, L.id_lo, k.poisson_step, ctr1, b0, b1);
      have_block = true;
    }
    const Draw dr = draw_from_block(b0, b1, BLOCK2 && (t & 1));
    // kick-drift-kick: the drift velocity is fused into the position
    // update, the stored velocity is the twice-rounded (v - k) - k
    const float nx = fma_rn(fma_rn(-L.ax, k.half_dt, L.vx), k.dt, L.px);
    const float ny = fma_rn(fma_rn(-L.ay, k.half_dt, L.vy), k.dt, L.py);
    const float nz = fma_rn(fma_rn(-L.az, k.half_dt, L.vz), k.dt, L.pz);
    const float wx = (L.vx - kx) - kx;
    const float wy = (L.vy - ky) - ky;
    const float wz = (L.vz - kz) - kz;
    L.px = nx;
    L.py = ny;
    L.pz = nz;
    L.vx = wx;
    L.vy = wy;
    L.vz = wz;
    // out of bounds kills before the collision roll (per-axis form; equal
    // to the JAX package's cubic min/max fold for finite coordinates)
    if (nx < 0.0f || nx >= k.size_x || ny < 0.0f || ny >= k.size_y ||
        nz < 0.0f || nz >= k.size_z) {
      stamp = kStatusDead;
      break;
    }
    const float e = fma_rn(wz, wz, fma_rn(wx, wx, wy * wy));
    const float2 sr = table_lookup(table, e, k.log10_e, k.bucket_scale);
    if (dr.u < sr.x) {
      // split: the child copies the moved lane, the lane's velocity flips
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d == depth) {
          children[d] = Child{nx, ny, nz, wx, wy, wz, t, dr.child_hi,
                              dr.child_lo};
        }
      }
      ++depth;
      L.vx = -wx;
      L.vy = -wy;
      L.vz = -wz;
    } else if (dr.u < sr.x + sr.y) {
      stamp = kStatusDead;
      break;
    }
  }
  L.status = stamp;
  n_children = depth;
  return pushes;
}

}  // namespace pst
