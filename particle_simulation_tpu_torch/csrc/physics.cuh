// One particle's mobility steps start..T: push, boundary, draws, table
// lookup, split or absorb, and the suspension of a lane whose child slots
// are full.  The float32 expressions are those of the port's
// ops/physics.py (and of XLA's contraction of the JAX package's
// ops/physics.py), operation for operation.
//
// Two instantiations of lane_steps: the reference one (GENERAL = false:
// leapfrog, absorbing boundary, reverse collisions, the main path's code)
// and the general one, which reads the model selections of the JAX
// package's ops/physics.py from PhysConsts::model at run time (boris with
// or without a field, periodic wrap, isotropic children).  The model is
// the same for every lane of a launch, so its branches do not diverge.
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

// PhysConsts::model bits (ops/kernels/engine.py MODEL_BITS); 0 is the
// reference model
constexpr int kBoris = 1;       // integrator="boris"
constexpr int kMagnetized = 2;  // boris with a nonzero b_field
constexpr int kIsotropic = 4;   // collision_model="isotropic"
constexpr int kPeriodic = 8;    // boundary="periodic"

struct PhysConsts {
  float dt;            // float32(mobility_dt)
  float half_dt;       // float32(dt) / 2
  float size_x, size_y, size_z;  // float32(sim_size)
  float log10_e;       // float32(1 / ln 10)
  float bucket_scale;  // float32(N_STEPS / 22)
  uint32_t seed;
  uint32_t poisson_step;
  int t_steps;
  int model;           // kBoris | kMagnetized | kIsotropic | kPeriodic
  float rot_t[3];      // boris: t = Omega dt / 2 (ops/physics.py rotation)
  float rot_s[3];      // boris: s = 2 t / (1 + |t|^2)
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

// x*y - z*w as XLA contracts it: fma(x, y, -(z*w))
PST_HD float cross_term(float x, float y, float z, float w) {
  return fma_rn(x, y, -(z * w));
}

// The boris kick with a field, per output axis as XLA fuses it (fma.py):
// v - h is fused on the two other axes (fx, fy, fz) and twice-rounded on
// the output's own (px_, py_, pz_, with h = kx, ky, kz rounded).
PST_HD void boris_rotate(const Lane& L, float kx, float ky, float kz,
                         const PhysConsts& k, float& wx, float& wy,
                         float& wz) {
  const float* t = k.rot_t;
  const float* s = k.rot_s;
  const float fx = fma_rn(-L.ax, k.half_dt, L.vx);
  const float fy = fma_rn(-L.ay, k.half_dt, L.vy);
  const float fz = fma_rn(-L.az, k.half_dt, L.vz);
  const float ox = L.vx - kx;
  const float oy = L.vy - ky;
  const float oz = L.vz - kz;
  {  // x: vm = (ox, fy, fz)
    const float v1y = fy + cross_term(fz, t[0], ox, t[2]);
    const float v1z = fz + cross_term(ox, t[1], fy, t[0]);
    wx = (ox + cross_term(v1y, s[2], v1z, s[1])) - kx;
  }
  {  // y: vm = (fx, oy, fz)
    const float v1z = fz + cross_term(fx, t[1], oy, t[0]);
    const float v1x = fx + cross_term(oy, t[2], fz, t[1]);
    wy = (oy + cross_term(v1z, s[0], v1x, s[2])) - ky;
  }
  {  // z: vm = (fx, fy, oz)
    const float v1x = fx + cross_term(fy, t[2], oz, t[1]);
    const float v1y = fy + cross_term(oz, t[0], fx, t[2]);
    wz = (oz + cross_term(v1x, s[1], v1y, s[0])) - kz;
  }
}

// jnp.mod as XLA computes it (the exact fmodf, plus s where the remainder
// is nonzero and its sign differs from s's), clipped to nextafter(s, 0)
PST_HD float wrap_periodic(float x, float s) {
  float r = fmodf(x, s);
  if (r != 0.0f && ((r < 0.0f) != (s < 0.0f))) r = r + s;
  return fminf(fmaxf(r, 0.0f), nextafterf(s, 0.0f));
}

// The isotropic child's velocity: speed |v| in the direction (cos_t,
// phi) from the child's id words; sqrt correctly rounded (sqrtf), cos and
// sin in double precision, rounded once (fma.py f32_of_f64)
PST_HD void isotropic_velocity(float wx, float wy, float wz,
                               uint32_t child_hi, uint32_t child_lo,
                               float& cx, float& cy, float& cz) {
  const float cos_t = 2.0f * uniform_from_bits(child_hi, 1.0f, 0.0f) - 1.0f;
  const float sin_t = sqrtf(fmaxf(fma_rn(-cos_t, cos_t, 1.0f), 0.0f));
  const float phi = 6.28318548202514648f * uniform_from_bits(child_lo, 1.0f,
                                                              0.0f);
  const float speed = sqrtf(fma_rn(wz, wz, fma_rn(wx, wx, wy * wy)));
  const float across = speed * sin_t;
  cx = across * static_cast<float>(cos(static_cast<double>(phi)));
  cy = across * static_cast<float>(sin(static_cast<double>(phi)));
  cz = speed * cos_t;
}

// The spawn depth and Threefry rounds of a lane's steps, and where its
// children go (store) and come back from (child, below slots()).
// FixedLimits: both known at compile time, the children in the caller's
// array (registers), the instantiations of the compiled set.
template <int D, int ROUNDS>
struct FixedLimits {
  Child (&children)[D];

  PST_HD bool full(int depth) const { return depth >= D; }

  PST_HD void cipher(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                     uint32_t& o0, uint32_t& o1) const {
    threefry2x32<ROUNDS>(k0, k1, c0, c1, o0, o1);
  }

  PST_HD void store(int depth, const Child& c) const {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (d == depth) children[d] = c;
    }
  }

  PST_HD int slots() const { return D; }

  PST_HD const Child& child(int d) const { return children[d]; }
};

// OpenLimits: both read at run time (the engines' open instantiations);
// child d goes to children[d * stride], a slice of a scratch buffer in
// global memory.
struct OpenLimits {
  Child* children;
  long long stride;
  int depth;
  int rounds;

  PST_HD bool full(int d) const { return d >= depth; }

  PST_HD void cipher(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                     uint32_t& o0, uint32_t& o1) const {
    threefry2x32_rt(rounds, k0, k1, c0, c1, o0, o1);
  }

  PST_HD void store(int d, const Child& c) const { children[d * stride] = c; }

  PST_HD int slots() const { return depth; }

  PST_HD Child child(int d) const { return children[d * stride]; }
};

// D = kOpen is an engine's open instantiation: spawn depth and rounds from
// its arguments (ROUNDS is unused), the children in a scratch buffer.
constexpr int kOpen = 0;

#if defined(__CUDACC__)
// Where a lane of a TILE-thread block keeps its children: the compiled
// set's in ``regs``, the open instantiation's in the thread's slices of
// the engine's scratch ``a.kids`` (a Child a resident thread and depth).
template <int D, int ROUNDS, int TILE, typename Args>
__device__ __forceinline__ auto tile_limits(
    const Args& a, Child (&regs)[D == kOpen ? 1 : D]) {
  if constexpr (D == kOpen) {
    return OpenLimits{a.kids + blockIdx.x * TILE + threadIdx.x,
                      static_cast<long long>(gridDim.x) * TILE, a.depth,
                      a.rounds};
  } else {
    return FixedLimits<D, ROUNDS>{regs};
  }
}
#endif

// Runs lane L (an unfinished record) through steps start..t_steps and
// returns the number of steps it moved.  ``table`` is the table in device
// memory (const float2*) or staged in shared memory (SharedTable).  On
// return L.status is ALIVE or a child stamp (finished), DEAD, or the
// suspended packing; the children it spawned are stored at depths
// 0..n_children (at most the spawn depth: a lane whose child slots are full
// suspends at its next step).  GENERAL selects the instantiation that reads
// k.model (the header note).
template <bool BLOCK2, bool GENERAL, typename Limits, typename Table>
PST_HD int lane_steps(Lane& L, const Limits& lim, int& n_children,
                      Table table, const PhysConsts& k) {
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
    if (lim.full(depth)) {
      stamp = encode_suspended(t, stamp);
      break;
    }
    ++pushes;
    // draws: the pair block at t & ~1 (block2) or one block per step
    if (!BLOCK2 || !have_block || (t & 1) == 0) {
      const uint32_t ctr1 =
          BLOCK2 ? (static_cast<uint32_t>(t) & ~1u) : static_cast<uint32_t>(t);
      lim.cipher(key0, L.id_lo, k.poisson_step, ctr1, b0, b1);
      have_block = true;
    }
    const Draw dr = draw_from_block(b0, b1, BLOCK2 && (t & 1));
    if constexpr (GENERAL) {
      float nx, ny, nz, wx, wy, wz;
      if (k.model & kBoris) {
        if (k.model & kMagnetized) {
          boris_rotate(L, kx, ky, kz, k, wx, wy, wz);
        } else {
          wx = fma_rn(-L.ax, k.dt, L.vx);
          wy = fma_rn(-L.ay, k.dt, L.vy);
          wz = fma_rn(-L.az, k.dt, L.vz);
        }
        // the drift with the new velocity
        nx = fma_rn(wx, k.dt, L.px);
        ny = fma_rn(wy, k.dt, L.py);
        nz = fma_rn(wz, k.dt, L.pz);
      } else {
        nx = fma_rn(fma_rn(-L.ax, k.half_dt, L.vx), k.dt, L.px);
        ny = fma_rn(fma_rn(-L.ay, k.half_dt, L.vy), k.dt, L.py);
        nz = fma_rn(fma_rn(-L.az, k.half_dt, L.vz), k.dt, L.pz);
        wx = (L.vx - kx) - kx;
        wy = (L.vy - ky) - ky;
        wz = (L.vz - kz) - kz;
      }
      if (k.model & kPeriodic) {
        nx = wrap_periodic(nx, k.size_x);
        ny = wrap_periodic(ny, k.size_y);
        nz = wrap_periodic(nz, k.size_z);
      }
      L.px = nx;
      L.py = ny;
      L.pz = nz;
      L.vx = wx;
      L.vy = wy;
      L.vz = wz;
      if (!(k.model & kPeriodic) &&
          (nx < 0.0f || nx >= k.size_x || ny < 0.0f || ny >= k.size_y ||
           nz < 0.0f || nz >= k.size_z)) {
        stamp = kStatusDead;
        break;
      }
      const float e = fma_rn(wz, wz, fma_rn(wx, wx, wy * wy));
      const float2 sr = table_lookup(table, e, k.log10_e, k.bucket_scale);
      if (dr.u < sr.x) {
        float cx = wx, cy = wy, cz = wz;
        if (k.model & kIsotropic) {
          isotropic_velocity(wx, wy, wz, dr.child_hi, dr.child_lo, cx, cy,
                             cz);
        } else {
          L.vx = -wx;
          L.vy = -wy;
          L.vz = -wz;
        }
        lim.store(depth, Child{nx, ny, nz, cx, cy, cz, t, dr.child_hi,
                               dr.child_lo});
        ++depth;
      } else if (dr.u < sr.x + sr.y) {
        stamp = kStatusDead;
        break;
      }
      continue;
    }
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
      lim.store(depth, Child{nx, ny, nz, wx, wy, wz, t, dr.child_hi,
                             dr.child_lo});
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
