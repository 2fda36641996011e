// The work-log engine on Hopper: a whole mobility phase in one launch.
//
// Replaces particle_simulation_tpu/ops/pallas/worklog.py::_worklog_kernel
// (launched per pass by _sweep's pallas_call) together with the
// lax.while_loop over passes around it (mobility_phase_worklog), with the
// inlined lookup of push_mcc.py::make_chunked_lookup (lookup.cuh).
//
// A phase is a fixed point over passes.  Pass 1 sweeps the caller's
// SimState (pos, vel, acc as (C, 3) float32, status, id_hi, id_lo), every
// later pass the work log the pass before it wrote.  Each pass runs every
// unfinished record through its mobility steps (physics.cuh lane_steps)
// and emits, in source order,
//   * a finished record, status reset to ALIVE, to the done log after the
//     records already there.  The done log is the output SimState's own
//     tensors: it ends up as the next population, with no compaction;
//   * a suspended parent and then its children, in depth order, to the work
//     log of the next pass.  The two work logs are (12, work_cap) int32
//     planes (pos, vel, acc as float bit patterns, status, id_hi, id_lo;
//     ops/kernels/engine.py FIELD_NAMES) that the passes ping-pong.
// Work past work_cap is dropped and flags overflow (the counts go on); done
// records past the capacity are dropped and n_done > C flags it.  A phase
// stops after t_steps + 1 passes and flags that it did not converge.
// Rows past the population hold zeros: the kernel clears the rows from it
// to clear_to, which the host passes as the rows of the output that may
// hold anything else (the capacity for a fresh buffer; a buffer the host
// kept from an earlier phase of a smaller population needs less, which at
// 5e7 slots and 1e6 live saves most of a phase: PERF.md section 6).
//
// The design, against what bounds the engine on the H100:
//   * Host round trips.  The grid is persistent (as many blocks as can be
//     resident, launched with cudaLaunchCooperativeKernel, so a grid that
//     could not all be resident is refused rather than deadlocked) and loops
//     over the passes itself, with a grid barrier (cooperative_groups
//     grid.sync) between them.  Each block reads the pass's totals from the
//     look-back words after the barrier, so every block holds the same done
//     count and next work count without a second barrier.  The host reads
//     back once a phase: the kRes* result words.
//   * Re-reads.  A block takes tiles of kTile records by an atomicAdd ticket
//     (lookback.cuh), sweeps a record a thread, ranks the tile's done and work
//     emissions with one block scan (scan.cuh block_scan2), and gets the
//     tile's offsets in the done and the work stream from two decoupled
//     look-backs run by warps 0 and 1 at once.  It then writes the lane and
//     its children from registers straight to their places: no write-back,
//     no staging area, no code array, no second kernel.  Offsets depend on
//     counts alone, so the output is the same on every run.
//   * Look-back words.  Each pass owns a region of the lookback buffer
//     (one ticket word, then one 64-bit word per tile for done and one for
//     work: 1 + 2 * tiles_max words).  kRegions = 3 regions rotate
//     (ops/kernels/worklog.py LOOKBACK_REGIONS, -DPST_WORKLOG_REGIONS): pass
//     p zeroes the region of pass p + 1, last used by pass p - 2, whose
//     totals every block read before the barrier that ended pass p - 1.  So
//     the buffer is 3 * (1 + 2 * ceil(max(C, work_cap) / kTile)) words (250
//     KB at the main path's 2M slots) whatever t_steps is; region 0 is
//     zeroed before a first barrier.
//   * The serial chain.  The T-loop is a chain of dependent steps: a
//     Threefry block per step pair (13 rounds, about 70 integer
//     operations), a logf, a dozen float operations and one dependent 8-byte
//     table read.  Every block copies the 80,000-byte table into dynamic
//     shared memory once a phase, so that read is a shared-memory load
//     (lookup.cuh SharedTable).  At spawn depth 2 (the main path's; ptxas
//     gives it 80 registers a thread, depth 4 118) and 80 KB a block, two
//     blocks of kTile = 384 threads fit an SM (768 threads).
//
// The model menu (ops/physics.py: boris with or without a field, the
// periodic box, isotropic children; physics.cuh lane_steps).  Each
// kernel is instantiated twice per (depth, rounds, block2): the reference
// instantiation, the main path's code as it was, and the general one,
// which reads PhysConsts::model at run time (the same for every lane, so
// its branches do not diverge).  The launch takes the reference
// instantiation for model 0 and the general one otherwise; the general
// path costs the registers and the operations of its models, and its time
// is PERF.md's (section 6).
//
// The compiled set is spawn depth 1..4 with 13 or 20 Threefry rounds, the
// children in registers.  Every other (depth, rounds), as the JAX package
// takes any, runs the open instantiation (D = kOpen, exported as
// pst_worklog_phase_open): both are launch arguments (physics.cuh
// OpenLimits, threefry.cuh threefry2x32_rt), and a lane's children go to
// its slices of a global scratch sized by the host for the resident grid
// (pst_worklog_open_blocks): a Child (36 bytes) per resident thread and
// depth, 3.6 MB a depth at 264 blocks of 384 threads.  Its emission and its
// result are the compiled instantiations'.
//
// Measured alternatives (chip_smoke.py phase 5 on trees that differ only
// in the kernel, two runs of each alternated in one call, on one NVIDIA H100
// 80GB HBM3 at 700 W; PERF.md section 6): the device's busy time in the
// phase (its one kernel and its readback) at main-path phases 4-6, under
// torch.profiler, was 2.23-2.41 ms (mean 2.30) for the kept
// version, the table in shared memory with tiles of 384; 2.39-2.57 (2.47)
// with the table read through the read-only cache (lookup.cuh's __ldg);
// 2.34-2.57 (2.47) with tiles of 256; 2.33-2.53 (2.43) with tiles of 512
// (one block an SM).  The kept version was the fastest at every phase of
// every run.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "coop.cuh"
#include "lookback.cuh"
#include "physics.cuh"
#include "scan.cuh"

namespace pst {

namespace cg = cooperative_groups;

#ifndef PST_WORKLOG_TILE
#error "PST_WORKLOG_TILE must be defined by the build (ops/kernels/build.py)"
#endif
constexpr int kTile = PST_WORKLOG_TILE;  // records a tile, threads a block
constexpr int kTableBytes = PST_N_STEPS * static_cast<int>(sizeof(float2));
constexpr int kNF = 12;
#if !defined(PST_WORKLOG_REGIONS) || !defined(PST_WORKLOG_RESULT_WORDS)
#error "PST_WORKLOG_REGIONS and PST_WORKLOG_RESULT_WORDS come from the build"
#endif
constexpr int kRegions = PST_WORKLOG_REGIONS;
// slots of the result words (ops/kernels/worklog.py RESULT)
constexpr int kResDone = 0;      // records emitted to the done log
constexpr int kResChildren = 1;  // children spawned, dropped ones included
constexpr int kResPushes = 2;    // lane-steps advanced
constexpr int kResPasses = 3;
constexpr int kResOverflow = 4;  // some pass's work exceeded work_cap
constexpr int kResStuck = 5;     // work left after t_steps + 1 passes
constexpr int kResBlocks = 6;    // the persistent grid's size
static_assert(kResBlocks + 1 == PST_WORKLOG_RESULT_WORDS,
              "the result words differ from ops/kernels/worklog.py RESULT");

struct PhaseArgs {
  const float* pos;  // pass 1's source: the caller's state, never written
  const float* vel;
  const float* acc;
  const int32_t* status;
  const int32_t* id_hi;
  const int32_t* id_lo;
  int n0;
  float* out_pos;  // the done log: the output state
  float* out_vel;
  float* out_acc;
  int32_t* out_status;
  int32_t* out_id_hi;
  int32_t* out_id_lo;
  long long cap;
  long long clear_to;  // rows of the output that may not hold zeros
  int32_t* logs;  // (2, 12, work_cap)
  long long work_cap;
  unsigned long long* lookback;  // (kRegions, 1 + 2 * tiles_max)
  long long tiles_max;
  long long* result;
  const float2* table;
  PhysConsts k;
  // the open instantiation's spawn depth, rounds and children: depth
  // slices of one Child a resident thread, child d of thread g at
  // kids[d * threads + g]
  int depth;
  int rounds;
  Child* kids;
};

__device__ __forceinline__ Lane load_state(const PhaseArgs& a, int i) {
  Lane r;
  r.px = __ldg(a.pos + 3LL * i);
  r.py = __ldg(a.pos + 3LL * i + 1);
  r.pz = __ldg(a.pos + 3LL * i + 2);
  r.vx = __ldg(a.vel + 3LL * i);
  r.vy = __ldg(a.vel + 3LL * i + 1);
  r.vz = __ldg(a.vel + 3LL * i + 2);
  r.ax = __ldg(a.acc + 3LL * i);
  r.ay = __ldg(a.acc + 3LL * i + 1);
  r.az = __ldg(a.acc + 3LL * i + 2);
  r.status = __ldg(a.status + i);
  r.id_hi = static_cast<uint32_t>(__ldg(a.id_hi + i));
  r.id_lo = static_cast<uint32_t>(__ldg(a.id_lo + i));
  return r;
}

// A work log was written by other blocks in this launch: read it through
// L2 (ld.global.cg), never the non-coherent read-only path.
__device__ __forceinline__ Lane load_work(const int32_t* log, long long cap,
                                          int i) {
  const int32_t* p = log + i;
  Lane r;
  r.px = __int_as_float(__ldcg(p));
  r.py = __int_as_float(__ldcg(p + cap));
  r.pz = __int_as_float(__ldcg(p + 2 * cap));
  r.vx = __int_as_float(__ldcg(p + 3 * cap));
  r.vy = __int_as_float(__ldcg(p + 4 * cap));
  r.vz = __int_as_float(__ldcg(p + 5 * cap));
  r.ax = __int_as_float(__ldcg(p + 6 * cap));
  r.ay = __int_as_float(__ldcg(p + 7 * cap));
  r.az = __int_as_float(__ldcg(p + 8 * cap));
  r.status = __ldcg(p + 9 * cap);
  r.id_hi = static_cast<uint32_t>(__ldcg(p + 10 * cap));
  r.id_lo = static_cast<uint32_t>(__ldcg(p + 11 * cap));
  return r;
}

__device__ __forceinline__ void store_work(int32_t* log, long long cap,
                                           long long j, const Lane& r) {
  int32_t* p = log + j;
  p[0] = __float_as_int(r.px);
  p[cap] = __float_as_int(r.py);
  p[2 * cap] = __float_as_int(r.pz);
  p[3 * cap] = __float_as_int(r.vx);
  p[4 * cap] = __float_as_int(r.vy);
  p[5 * cap] = __float_as_int(r.vz);
  p[6 * cap] = __float_as_int(r.ax);
  p[7 * cap] = __float_as_int(r.ay);
  p[8 * cap] = __float_as_int(r.az);
  p[9 * cap] = r.status;
  p[10 * cap] = static_cast<int32_t>(r.id_hi);
  p[11 * cap] = static_cast<int32_t>(r.id_lo);
}

__device__ __forceinline__ void store_done(const PhaseArgs& a, long long j,
                                           const Lane& r) {
  a.out_pos[3 * j] = r.px;
  a.out_pos[3 * j + 1] = r.py;
  a.out_pos[3 * j + 2] = r.pz;
  a.out_vel[3 * j] = r.vx;
  a.out_vel[3 * j + 1] = r.vy;
  a.out_vel[3 * j + 2] = r.vz;
  a.out_acc[3 * j] = r.ax;
  a.out_acc[3 * j + 1] = r.ay;
  a.out_acc[3 * j + 2] = r.az;
  a.out_status[j] = kStatusAlive;
  a.out_id_hi[j] = static_cast<int32_t>(r.id_hi);
  a.out_id_lo[j] = static_cast<int32_t>(r.id_lo);
}

// One tile of one pass: sweep, rank, look back, emit.  ``src`` is null in
// pass 1 (the source is the caller's state).  Adds the thread's pushes and
// children to its running sums.
template <int D, int ROUNDS, bool BLOCK2, bool GENERAL>
__device__ __forceinline__ void sweep_tile(
    const PhaseArgs& a, int tile, int n_src, const int32_t* src,
    int32_t* dst, unsigned long long* done_words,
    unsigned long long* work_words, long long n_done, long long& pushes,
    long long& children) {
  __shared__ unsigned int base[2];  // the tile's done and work offsets
  extern __shared__ float2 table_rows[];  // the phase's copy of the table
  const int i = tile * kTile + threadIdx.x;
  Lane L;
  Child regs[D == kOpen ? 1 : D];
  const auto kids = tile_limits<D, ROUNDS, kTile>(a, regs);
  int n_kids = 0;
  bool done = false;
  bool suspended = false;
  if (i < n_src) {
    L = src ? load_work(src, a.work_cap, i) : load_state(a, i);
    if (is_unfinished(L.status)) {
      pushes += lane_steps<BLOCK2, GENERAL>(L, kids, n_kids,
                                            SharedTable{table_rows}, a.k);
      children += n_kids;
      done = L.status == kStatusAlive || L.status > 0;
      suspended = is_suspended(L.status);
    }
  }
  const int n_work = (suspended ? 1 : 0) + n_kids;
  int ex_d, ex_w, tot_d, tot_w;
  block_scan2<kTile>(done ? 1 : 0, n_work, ex_d, ex_w, tot_d, tot_w);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const unsigned int e = lookback_exclusive(
        warp == 0 ? done_words : work_words, tile,
        static_cast<unsigned int>(warp == 0 ? tot_d : tot_w));
    if ((threadIdx.x & 31) == 0) base[warp] = e;
  }
  __syncthreads();
  if (done) {
    const long long od = n_done + base[0] + ex_d;
    if (od < a.cap) store_done(a, od, L);
  }
  long long ow = static_cast<long long>(base[1]) + ex_w;
  if (suspended) {
    if (ow < a.work_cap) store_work(dst, a.work_cap, ow, L);
    ++ow;
  }
#pragma unroll
  for (int d = 0; d < kids.slots(); ++d, ++ow) {
    if (d < n_kids && ow < a.work_cap) {
      const Child& c = kids.child(d);
      Lane r = L;
      r.px = c.px;
      r.py = c.py;
      r.pz = c.pz;
      r.vx = c.vx;
      r.vy = c.vy;
      r.vz = c.vz;
      r.status = c.stamp;
      r.id_hi = c.id_hi;
      r.id_lo = c.id_lo;
      store_work(dst, a.work_cap, ow, r);
    }
  }
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The open instantiation (D = kOpen) takes every instantiation's bound:
// ptxas gives each open kernel 80 registers and no spill, two blocks an
// SM; with __launch_bounds__(kTile, 1) the reference one took 112
// registers and one block an SM, and its main-path phase measured 12-23%
// slower on an H100 at 700 W (PERF.md section 6).
template <int D, int ROUNDS, bool BLOCK2, bool GENERAL>
__global__ void __launch_bounds__(kTile) worklog_phase(PhaseArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float2 table_rows[];
  for (int j = threadIdx.x; j < PST_N_STEPS; j += kTile) {
    table_rows[j] = a.table[j];
  }
  const long long region_words = 1 + 2 * a.tiles_max;
  const long long n_threads = static_cast<long long>(gridDim.x) * kTile;
  const long long gid = static_cast<long long>(blockIdx.x) * kTile +
                        threadIdx.x;
  for (long long w = gid; w < region_words; w += n_threads) a.lookback[w] = 0;
  if (gid == 0) {
    a.result[kResChildren] = 0;
    a.result[kResPushes] = 0;
  }
  grid.sync();

  long long n_done = 0;  // the same in every block
  long long pushes = 0;  // this thread's
  long long children = 0;
  bool overflow = false;
  bool stuck = false;
  int n_src = a.n0;
  int pass = 0;
  for (; n_src > 0; ++pass) {
    // every record of pass k+1 starts at least one step later than the
    // earliest start of pass k, so a phase needs at most t_steps + 1
    if (pass > a.k.t_steps) {
      stuck = true;
      break;
    }
    unsigned long long* region = a.lookback + (pass % kRegions) * region_words;
    unsigned long long* next =
        a.lookback + ((pass + 1) % kRegions) * region_words;
    for (long long w = gid; w < region_words; w += n_threads) next[w] = 0;
    const int32_t* src =
        pass ? a.logs + ((pass - 1) & 1) * kNF * a.work_cap : nullptr;
    int32_t* dst = a.logs + (pass & 1) * kNF * a.work_cap;
    unsigned long long* done_words = region + 1;
    unsigned long long* work_words = region + 1 + a.tiles_max;
    const int n_tiles = (n_src + kTile - 1) / kTile;
    while (true) {
      const int tile = lookback_ticket(reinterpret_cast<unsigned int*>(region));
      if (tile >= n_tiles) break;
      sweep_tile<D, ROUNDS, BLOCK2, GENERAL>(a, tile, n_src, src, dst,
                                             done_words, work_words, n_done,
                                             pushes, children);
    }
    grid.sync();
    // the last tile's inclusive prefixes are the pass's totals
    n_done += lookback_load(done_words + n_tiles - 1) & 0xffffffffull;
    const long long work = lookback_load(work_words + n_tiles - 1) &
                           0xffffffffull;
    overflow = overflow || work > a.work_cap;
    n_src = static_cast<int>(work > a.work_cap ? a.work_cap : work);
  }

  // rows past the population hold zeros: those up to clear_to are cleared
  const long long n_live = n_done < a.cap ? n_done : a.cap;
  const long long clear_end = a.clear_to > n_live ? a.clear_to : n_live;
  for (long long j = 3 * n_live + gid; j < 3 * clear_end; j += n_threads) {
    a.out_pos[j] = 0.0f;
    a.out_vel[j] = 0.0f;
    a.out_acc[j] = 0.0f;
  }
  for (long long j = n_live + gid; j < clear_end; j += n_threads) {
    a.out_status[j] = 0;
    a.out_id_hi[j] = 0;
    a.out_id_lo[j] = 0;
  }
  pushes = warp_sum(pushes);
  children = warp_sum(children);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.result + kResPushes),
              static_cast<unsigned long long>(pushes));
    atomicAdd(reinterpret_cast<unsigned long long*>(a.result + kResChildren),
              static_cast<unsigned long long>(children));
  }
  if (gid == 0) {
    a.result[kResDone] = n_done;
    a.result[kResPasses] = pass;
    a.result[kResOverflow] = overflow;
    a.result[kResStuck] = stuck;
    a.result[kResBlocks] = gridDim.x;
  }
}

template <int D, int ROUNDS, bool BLOCK2, bool GENERAL>
cudaError_t launch_phase(PhaseArgs& a, cudaStream_t stream) {
  static CoopCache cache;
  const auto kernel = worklog_phase<D, ROUNDS, BLOCK2, GENERAL>;
  void* args[] = {&a};
  return launch_cooperative((const void*)kernel, kTile, kTableBytes,
                            a.tiles_max, args, cache, stream);
}

template <bool BLOCK2, bool GENERAL>
const void* open_kernel() {
  return (const void*)worklog_phase<kOpen, 0, BLOCK2, GENERAL>;
}

const void* open_kernel(int block2, bool general) {
  return block2 ? (general ? open_kernel<true, true>()
                           : open_kernel<true, false>())
                : (general ? open_kernel<false, true>()
                           : open_kernel<false, false>());
}

template <int D, bool GENERAL>
cudaError_t dispatch_phase(int rounds, int block2, PhaseArgs& a,
                           cudaStream_t stream) {
  if (rounds == 13 && block2) {
    return launch_phase<D, 13, true, GENERAL>(a, stream);
  }
  if (rounds == 13) {
    return launch_phase<D, 13, false, GENERAL>(a, stream);
  }
  if (rounds == 20 && block2) {
    return launch_phase<D, 20, true, GENERAL>(a, stream);
  }
  if (rounds == 20) {
    return launch_phase<D, 20, false, GENERAL>(a, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace pst

namespace {

// The body of both exported phases: the arguments checked and gathered,
// then the launch of the compiled instantiation of (depth, rounds, block2,
// model 0 or not), or with ``open`` of the open instantiation on
// ``kid_blocks`` blocks (at most tiles_max), whose children go to ``kids``
// (kid_blocks * kTile * depth Child records).
int run_phase(
    const void* pos, const void* vel, const void* acc, const void* status,
    const void* id_hi, const void* id_lo, int n0, void* out_pos,
    void* out_vel, void* out_acc, void* out_status, void* out_id_hi,
    void* out_id_lo, long long capacity, long long clear_to, void* logs,
    long long work_cap,
    void* lookback, long long tiles_max, void* result, const void* table,
    float dt, float half_dt, float size_x, float size_y, float size_z,
    float log10_e, float bucket_scale, unsigned int seed,
    unsigned int poisson_step, int t_steps, int depth, int rounds,
    int block2, int model, float t0, float t1, float t2, float s0,
    float s1, float s2, bool open, void* kids, long long kid_blocks,
    void* stream) {
  using namespace pst;
  // a look-back word holds a pass's count in 32 bits: at most 1 + depth
  // work records for each of at most max(n0, work_cap) source records
  const long long most = n0 > work_cap ? n0 : work_cap;
  if (n0 <= 0 || n0 > capacity || clear_to < 0 || clear_to > capacity ||
      work_cap <= 0 || depth < 1 ||
      most * (1 + depth) > UINT32_MAX ||
      tiles_max < (most + kTile - 1) / kTile ||
      (open && (kids == nullptr || kid_blocks < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PhaseArgs a;
  a.pos = static_cast<const float*>(pos);
  a.vel = static_cast<const float*>(vel);
  a.acc = static_cast<const float*>(acc);
  a.status = static_cast<const int32_t*>(status);
  a.id_hi = static_cast<const int32_t*>(id_hi);
  a.id_lo = static_cast<const int32_t*>(id_lo);
  a.n0 = n0;
  a.out_pos = static_cast<float*>(out_pos);
  a.out_vel = static_cast<float*>(out_vel);
  a.out_acc = static_cast<float*>(out_acc);
  a.out_status = static_cast<int32_t*>(out_status);
  a.out_id_hi = static_cast<int32_t*>(out_id_hi);
  a.out_id_lo = static_cast<int32_t*>(out_id_lo);
  a.cap = capacity;
  a.clear_to = clear_to;
  a.logs = static_cast<int32_t*>(logs);
  a.work_cap = work_cap;
  a.lookback = static_cast<unsigned long long*>(lookback);
  a.tiles_max = tiles_max;
  a.result = static_cast<long long*>(result);
  a.table = static_cast<const float2*>(table);
  a.k.dt = dt;
  a.k.half_dt = half_dt;
  a.k.size_x = size_x;
  a.k.size_y = size_y;
  a.k.size_z = size_z;
  a.k.log10_e = log10_e;
  a.k.bucket_scale = bucket_scale;
  a.k.seed = seed;
  a.k.poisson_step = poisson_step;
  a.k.t_steps = t_steps;
  a.k.model = model;
  a.k.rot_t[0] = t0;
  a.k.rot_t[1] = t1;
  a.k.rot_t[2] = t2;
  a.k.rot_s[0] = s0;
  a.k.rot_s[1] = s1;
  a.k.rot_s[2] = s2;
  a.depth = depth;
  a.rounds = rounds;
  a.kids = static_cast<Child*>(kids);
  // the reference model runs the instantiations of the main path
  const bool general = model != 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (open) {
    const void* kernel = open_kernel(block2, general);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    void* args[] = {&a};
    const long long blocks = kid_blocks < tiles_max ? kid_blocks : tiles_max;
    return static_cast<int>(launch_cooperative_grid(
        kernel, static_cast<unsigned int>(blocks), kTile, kTableBytes, args,
        st));
  }
  switch (depth) {
    case 1:
      err = general ? dispatch_phase<1, true>(rounds, block2, a, st)
                    : dispatch_phase<1, false>(rounds, block2, a, st);
      break;
    case 2:
      err = general ? dispatch_phase<2, true>(rounds, block2, a, st)
                    : dispatch_phase<2, false>(rounds, block2, a, st);
      break;
    case 3:
      err = general ? dispatch_phase<3, true>(rounds, block2, a, st)
                    : dispatch_phase<3, false>(rounds, block2, a, st);
      break;
    case 4:
      err = general ? dispatch_phase<4, true>(rounds, block2, a, st)
                    : dispatch_phase<4, false>(rounds, block2, a, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// A whole mobility phase on ``stream``: the n0 records of the input state
// (pos, vel, acc (C, 3) float32; status, id_hi, id_lo (C,) int32) to the
// output state of the same capacity, whose rows from ``clear_to`` on
// hold zeros on entry (clear_to = capacity: any content), through the work
// logs ``logs``
// ((2, 12, work_cap) int32), with the look-back words ``lookback``
// ((kRegions, 1 + 2 * tiles_max) int64, any content).  ``result``
// (PST_WORKLOG_RESULT_WORDS int64) gets the kRes* words.  ``model`` is
// PhysConsts::model (0: the reference instantiation), t0..s2 the boris
// rotation's constants.  The compiled set: depth 1..4, rounds 13 and 20.
// Returns a cudaError_t (0 on success), including a refused cooperative
// launch.
extern "C" int pst_worklog_phase(
    const void* pos, const void* vel, const void* acc, const void* status,
    const void* id_hi, const void* id_lo, int n0, void* out_pos,
    void* out_vel, void* out_acc, void* out_status, void* out_id_hi,
    void* out_id_lo, long long capacity, long long clear_to, void* logs,
    long long work_cap,
    void* lookback, long long tiles_max, void* result, const void* table,
    float dt, float half_dt, float size_x, float size_y, float size_z,
    float log10_e, float bucket_scale, unsigned int seed,
    unsigned int poisson_step, int t_steps, int depth, int rounds,
    int block2, int model, float t0, float t1, float t2, float s0,
    float s1, float s2, void* stream) {
  return run_phase(pos, vel, acc, status, id_hi, id_lo, n0, out_pos, out_vel,
                   out_acc, out_status, out_id_hi, out_id_lo, capacity,
                   clear_to, logs, work_cap, lookback, tiles_max, result,
                   table, dt, half_dt, size_x, size_y, size_z, log10_e,
                   bucket_scale, seed, poisson_step, t_steps, depth, rounds,
                   block2, model, t0, t1, t2, s0, s1, s2, false,
                   nullptr, 0, stream);
}

// The same phase through the open instantiation, for any depth >= 1 and
// any round count: ``kids`` holds kid_blocks * PST_WORKLOG_TILE * depth
// Child records (9 words each) of any content, and the grid is kid_blocks
// blocks (at most tiles_max), which must all be resident
// (pst_worklog_open_blocks).
extern "C" int pst_worklog_phase_open(
    const void* pos, const void* vel, const void* acc, const void* status,
    const void* id_hi, const void* id_lo, int n0, void* out_pos,
    void* out_vel, void* out_acc, void* out_status, void* out_id_hi,
    void* out_id_lo, long long capacity, long long clear_to, void* logs,
    long long work_cap,
    void* lookback, long long tiles_max, void* result, const void* table,
    float dt, float half_dt, float size_x, float size_y, float size_z,
    float log10_e, float bucket_scale, unsigned int seed,
    unsigned int poisson_step, int t_steps, int depth, int rounds,
    int block2, int model, float t0, float t1, float t2, float s0,
    float s1, float s2, void* kids, long long kid_blocks, void* stream) {
  return run_phase(pos, vel, acc, status, id_hi, id_lo, n0, out_pos, out_vel,
                   out_acc, out_status, out_id_hi, out_id_lo, capacity,
                   clear_to, logs, work_cap, lookback, tiles_max, result,
                   table, dt, half_dt, size_x, size_y, size_z, log10_e,
                   bucket_scale, seed, poisson_step, t_steps, depth, rounds,
                   block2, model, t0, t1, t2, s0, s1, s2, true, kids,
                   kid_blocks, stream);
}

// The blocks of the open instantiation (block2, model 0 or not) that can
// be resident at once on the current device, into *blocks: the grid its
// children scratch is sized for.  Returns a cudaError_t.
extern "C" int pst_worklog_open_blocks(int block2, int general,
                                       int* blocks) {
  using namespace pst;
  return static_cast<int>(resident_blocks(open_kernel(block2, general != 0),
                                          kTile, kTableBytes, blocks));
}
