// The staged engine on Hopper (scheduler dynamic_old): a whole mobility
// phase in one launch.
//
// Replaces particle_simulation_tpu/ops/pallas/push_mcc.py::_mobility_kernel
// (launched per pass by _sweep_pass's pallas_call) and the append of the
// staged children that follows each pass there (push_mcc._append_staged),
// together with the loop over passes around them (mobility_phase_dynamic's
// lax.while_loop), with the inlined lookup of push_mcc.py::
// make_chunked_lookup (lookup.cuh).  It keeps the staged design, beside the
// work-log engine (worklog.cu), as the JAX package keeps its older engine
// and the reference its older persistent kernel as mode 33.
//
// The staged semantics: records live in a (12, C) int32 record stack (pos,
// vel, acc as float bit patterns, status, id_hi, id_lo; ops/kernels/
// push_mcc.py FIELD_NAMES) whose slots [0, n) are the population.  A pass
// advances every unfinished lane (fresh -1, spawn stamp > 0, suspended)
// through physics.cuh's advance_lane and writes it back in place: the
// finished marker (encode_finished) if it is live at the end, DEAD, or the
// suspended packing if its D child slots filled.  The pass's children go
// to [n, n + k), depth-major and then in slot order; those at or beyond
// the capacity are dropped but counted in n.  Before that append, when
// n <= C < n + k and some row below n is DEAD, the DEAD and EMPTY rows are
// dropped stably (every other status kept verbatim), and the dropped count
// is added to ``reclaimed``.  The phase ends when no lane is suspended and
// nothing was appended; after t_steps + 1 passes it flags that it did not
// converge.  Then the finished rows, in slot order and reset to ALIVE, are
// the output state: population.compact of the decoded stack, fused.
//
// What bounds it on the H100: the T-loop, as in worklog.cu (a Threefry
// block per step pair, a logf, a dozen float operations and a dependent
// 8-byte table read per step), 70 operations a push at 67 TFLOP/s.  Around
// it the staged design moves more bytes than the work-log engine: lanes
// are written back in place, children are staged before they enter the
// stack, and the population is compacted at the end.  The design takes
// what held the per-pass version back (a host round trip each pass, a
// one-block scan, children written twice and counted from a code array,
// a thread for every slot of [0, n) each pass, and record-stack copies
// and compaction around the phase) one by one.  Each sub-phase is a loop
// of ticketed tiles over the persistent grid and ends at a grid barrier:
//   (a) The work list of pass 1.  The caller's status words of [0, min(n,
//       C)) are scanned in tiles of kScanTile slots (kItems a thread, a
//       warp ballot an (item, warp) and one scan of their counts), and the
//       unfinished slots go, ascending, to a dense int32 list at the tile's
//       offset from a decoupled look-back (lookback.cuh).  The rows are
//       copied into the stack on the way (the kernel never writes its
//       input) and the DEAD ones counted.
//   (b) Sweep and stage, one barrier a pass.  Blocks take ticketed tiles of
//       kTile list entries, a lane a thread, with the table in shared
//       memory (lookup.cuh SharedTable), so a warp holds 32 unfinished
//       lanes, not 32 slots of which a few are unfinished.  The list is the
//       slots the pass before left suspended, ascending, then the children
//       it staged that fit, which take the slots from n on and enter the
//       stack as they are swept: the append is the sweep's own read.  Each
//       child goes straight to its place in this pass's staging region for
//       its depth, and each lane that suspends to the next list, at ranks
//       from one block scan of the flags and D + 1 look-backs (one warp a
//       stream).  No code array, no single-block scan, no rescan of the
//       slots.  Newly DEAD lanes go into a counter (one atomic a block).
//   (c) Reclaim, only when the rule above holds: the non-DEAD, non-EMPTY
//       rows of [0, n) are compacted stably into the second stack with the
//       scan tiles of (a), the stacks swap, and a scan of the moved rows
//       rebuilds the next list (suspended lanes change slots).  The DEAD
//       count it tests is a running count (the input's, plus each pass's
//       new deaths, 0 after a reclaim), which equals a recount of DEAD rows
//       below min(n, C).
//   (d) After the last pass the finished rows go to the output state at
//       their rank (scan tiles and a look-back), and a last barrier lets
//       every block zero the rows past them (status EMPTY).
// Every block reads each sub-phase's totals from the look-back words and
// counters after its barrier, so all blocks take the same branches.  The
// host reads back once a phase: the kRes* result words.  Ranks come from
// counts alone, so the output is the same on every run.
//
// Measured alternatives (probes/step_times.py on trees that differ only in
// the kernel, alternated in one call, on one NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md section 6), the mobility phase's mean over main-path
// steps 1-5 by CUDA events: the kept design 2.73 and 2.78 ms in two
// rounds, against 3.04 and 3.18 ms when every pass rescans the status
// words for its list and the append is a copy of its own; and, in that
// rescanning version, 3.13 and 2.95 ms kept against 3.70 and 3.55 with one
// block an SM, 3.42 and 3.42 with the sweep tile not inlined, 2.99 and
// 3.00 with 8 slots a scan thread in place of 16.
//
// Look-back words: a region is a ticket and a counter, then a word per
// stream and sweep tile (a scan tile uses one word; it is kItems sweep
// tiles long).  kRegions = 3 regions rotate over the sub-phases, each
// zeroed two sub-phases after its use, as in worklog.cu.  Memory at the
// main path's 2M slots and spawn depth 2: the two stacks 192 MB, the two
// sets of staging regions 384 MB (96 MB a depth), the two lists 16 MB,
// the look-back words 375 KB, the output state 96 MB.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "coop.cuh"
#include "lookback.cuh"
#include "physics.cuh"
#include "scan.cuh"

namespace pst {
namespace staged {

namespace cg = cooperative_groups;

#if !defined(PST_STAGED_TILE) || !defined(PST_STAGED_ITEMS) ||    \
    !defined(PST_STAGED_REGIONS) || !defined(PST_STAGED_HEADER) || \
    !defined(PST_STAGED_RESULT_WORDS)
#error "the staged kernel's sizes come from the build (ops/kernels/build.py)"
#endif
constexpr int kTile = PST_STAGED_TILE;    // a sweep tile's lanes and threads
constexpr int kItems = PST_STAGED_ITEMS;  // slots a thread of a scan tile
constexpr int kScanTile = kTile * kItems;
constexpr int kWarps = kTile / 32;
constexpr int kRegions = PST_STAGED_REGIONS;
constexpr int kHeader = PST_STAGED_HEADER;
constexpr int kTableBytes = PST_N_STEPS * static_cast<int>(sizeof(float2));
constexpr int kNF = 12;
constexpr int kStatusField = 9;
constexpr int kMaxDepth = 4;
static_assert(kTile % 32 == 0 && kTile <= 1024, "a block is whole warps");
// a region's header words
constexpr int kTicket = 0;
constexpr int kCount = 1;  // DEAD rows of the input, or lanes that died
static_assert(kCount + 1 == kHeader,
              "the header differs from ops/kernels/push_mcc.py REGION_HEADER");
// slots of the result words (ops/kernels/push_mcc.py STAGED_RESULT)
constexpr int kResN = 0;          // created slots at the end (may exceed C)
constexpr int kResLive = 1;       // rows of the output state
constexpr int kResPushes = 2;     // lane-steps advanced
constexpr int kResPasses = 3;
constexpr int kResReclaimed = 4;  // rows the reclaims dropped
constexpr int kResReclaims = 5;
constexpr int kResStuck = 6;      // unfinished lanes after t_steps + 1 passes
constexpr int kResBlocks = 7;     // the persistent grid's size
static_assert(kResBlocks + 1 == PST_STAGED_RESULT_WORDS,
              "the result words differ from ops/kernels/push_mcc.py");

struct Args {
  const float* pos;  // the caller's state: read in pass 1, never written
  const float* vel;
  const float* acc;
  const int32_t* status;
  const int32_t* id_hi;
  const int32_t* id_lo;
  long long n0;      // its created slots (may exceed cap)
  float* out_pos;    // the output state
  float* out_vel;
  float* out_acc;
  int32_t* out_status;
  int32_t* out_id_hi;
  int32_t* out_id_lo;
  long long cap;
  int32_t* stacks;   // (2, 12, cap): the population, the reclaim's target
  int32_t* stage;    // (2, D, 12, cap): a pass's children; passes alternate
  int32_t* list;     // (2, cap): a pass's list, and the next pass's
  unsigned long long* lookback;  // (kRegions, kHeader + (D + 1) * tiles_max)
  long long tiles_max;           // sweep tiles of cap slots
  long long* result;
  const float2* table;
  PhysConsts k;
};

// Rows written earlier in this launch are read through L2 (ld.global.cg),
// never the non-coherent read-only path.
__device__ __forceinline__ Lane load_row(const int32_t* p, long long cap) {
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

__device__ __forceinline__ void copy_row(const int32_t* src, int32_t* dst,
                                         long long cap) {
#pragma unroll
  for (int f = 0; f < kNF; ++f) dst[f * cap] = __ldcg(src + f * cap);
}

// The slots [0, n) of a region's ranked compaction, in tiles of kScanTile:
// thread t holds slots base + j * kTile + t, so (item, warp, lane) order is
// slot order.  The slots where keep(slot) holds go to emit(slot, rank),
// their rank among the kept slots of [0, n): a ballot an (item, warp), one
// warp's scan of the kItems * kWarps counts, and the tile's look-back in
// ``words``.
template <typename Keep, typename Emit>
__device__ __forceinline__ void compact_tile(int tile, long long n,
                                             unsigned long long* words,
                                             Keep keep, Emit emit) {
  constexpr int kCells = kItems * kWarps;
  constexpr int kPer = (kCells + 31) / 32;
  __shared__ unsigned int cell[kCells];  // counts, then exclusive offsets
  __shared__ unsigned int tile_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(tile) * kScanTile +
                         threadIdx.x;
  unsigned int mask[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long slot = base + static_cast<long long>(j) * kTile;
    mask[j] = __ballot_sync(0xffffffffu, slot < n && keep(slot));
    if (lane == 0) cell[j * kWarps + warp] = __popc(mask[j]);
  }
  __syncthreads();
  if (warp == 0) {
    unsigned int own[kPer];
    unsigned int sum = 0;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int x = lane * kPer + c;
      own[c] = x < kCells ? cell[x] : 0u;
      sum += own[c];
    }
    unsigned int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    unsigned int run = incl - sum;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int x = lane * kPer + c;
      if (x < kCells) cell[x] = run;
      run += own[c];
    }
    const unsigned int total = __shfl_sync(0xffffffffu, incl, 31);
    const unsigned int e = lookback_exclusive(words, tile, total);
    if (lane == 0) tile_base = e;
  }
  __syncthreads();
  const unsigned int below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    if ((mask[j] >> lane) & 1u) {
      emit(base + static_cast<long long>(j) * kTile,
           static_cast<long long>(tile_base) + cell[j * kWarps + warp] +
               __popc(mask[j] & below));
    }
  }
}

// What a pass sweeps: the n_susp slots of its list (ascending), then the
// children of the pass before that fit, which take the slots from n_app on
// in the order they were staged (depth-major, then by parent) and enter the
// stack as they are swept.
template <int D>
struct PassIn {
  const int32_t* list;
  int n_susp;
  int n_list;              // n_susp + the children that fit
  const int32_t* kids;     // the pass before's staging regions (D, 12, cap)
  long long k_depth[D];    // its children a depth
  long long n_app;
};

// One sweep tile: list entries [tile * kTile, +kTile) of the pass.  Each
// lane's children go to this pass's staging regions, its slot to the next
// list if it suspends, at ranks from D + 1 look-backs in ``words``.  Adds
// the thread's pushes and newly DEAD lanes to its sums.
template <int D, int ROUNDS, bool BLOCK2>
__device__ __forceinline__ void sweep_tile(
    const Args& a, int tile, const PassIn<D>& in, int32_t* stack,
    int32_t* next_list, int32_t* stage, unsigned long long* words,
    long long& pushes, int& died) {
  __shared__ unsigned int base[kMaxDepth + 1];  // the tile's offsets
  extern __shared__ float2 table_rows[];
  const long long cap = a.cap;
  const int j = tile * kTile + threadIdx.x;
  Lane L;
  Child kids[D];
  int n_kids = 0;
  bool suspended = false;
  long long slot = 0;
  if (j < in.n_list) {
    if (j < in.n_susp) {
      slot = __ldcg(in.list + j);
      L = load_row(stack + slot, cap);
    } else {
      long long off = j - in.n_susp;
      slot = in.n_app + off;
      int d = 0;
      while (d < D - 1 && off >= in.k_depth[d]) off -= in.k_depth[d++];
      L = load_row(in.kids + d * kNF * cap + off, cap);
      // the fields the write-back below leaves alone
      int32_t* p = stack + slot;
      p[6 * cap] = __float_as_int(L.ax);
      p[7 * cap] = __float_as_int(L.ay);
      p[8 * cap] = __float_as_int(L.az);
      p[10 * cap] = static_cast<int32_t>(L.id_hi);
      p[11 * cap] = static_cast<int32_t>(L.id_lo);
    }
    pushes += advance_lane<D, ROUNDS, BLOCK2>(L, kids, n_kids,
                                              SharedTable{table_rows}, a.k);
    int32_t* p = stack + slot;
    p[0] = __float_as_int(L.px);
    p[cap] = __float_as_int(L.py);
    p[2 * cap] = __float_as_int(L.pz);
    p[3 * cap] = __float_as_int(L.vx);
    p[4 * cap] = __float_as_int(L.vy);
    p[5 * cap] = __float_as_int(L.vz);
    const bool live = L.status == kStatusAlive || L.status > 0;
    p[kStatusField * cap] = live ? encode_finished(L.status) : L.status;
    suspended = is_suspended(L.status);
    died += L.status == kStatusDead ? 1 : 0;
  }
  // ranks in the D + 1 streams: the children of each depth, then the
  // suspended lanes; two streams a block scan
  int flag[kMaxDepth + 2], ex[kMaxDepth + 2], tot[kMaxDepth + 2];
#pragma unroll
  for (int d = 0; d < D; ++d) flag[d] = n_kids > d ? 1 : 0;
  flag[D] = suspended ? 1 : 0;
  flag[D + 1] = 0;
#pragma unroll
  for (int i = 0; i <= D; i += 2) {
    if (i) __syncthreads();
    block_scan2<kTile>(flag[i], flag[i + 1], ex[i], ex[i + 1], tot[i],
                       tot[i + 1]);
  }
  const int warp = threadIdx.x >> 5;
  if (warp <= D) {
    int t = tot[0];
#pragma unroll
    for (int i = 1; i <= D; ++i) {
      if (warp == i) t = tot[i];
    }
    const unsigned int e = lookback_exclusive(words + warp * a.tiles_max, tile,
                                              static_cast<unsigned int>(t));
    if ((threadIdx.x & 31) == 0) base[warp] = e;
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) {
    if (d < n_kids) {
      const Child& c = kids[d];
      int32_t* out = stage + d * kNF * cap + base[d] + ex[d];
      out[0] = __float_as_int(c.px);
      out[cap] = __float_as_int(c.py);
      out[2 * cap] = __float_as_int(c.pz);
      out[3 * cap] = __float_as_int(c.vx);
      out[4 * cap] = __float_as_int(c.vy);
      out[5 * cap] = __float_as_int(c.vz);
      out[6 * cap] = __float_as_int(L.ax);
      out[7 * cap] = __float_as_int(L.ay);
      out[8 * cap] = __float_as_int(L.az);
      out[9 * cap] = c.stamp;
      out[10 * cap] = static_cast<int32_t>(c.id_hi);
      out[11 * cap] = static_cast<int32_t>(c.id_lo);
    }
  }
  if (suspended) next_list[base[D] + ex[D]] = static_cast<int32_t>(slot);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The block's sum of a per-thread count, atomically added to a counter
// word.  Every thread of the block calls it.
__device__ __forceinline__ void add_block_count(int x,
                                                unsigned long long* counter) {
  int ex, ey, tx, ty;
  block_scan2<kTile>(x, 0, ex, ey, tx, ty);
  if (threadIdx.x == 0 && tx) {
    atomicAdd(counter, static_cast<unsigned long long>(tx));
  }
}

// The last tile's inclusive look-back prefix: a sub-phase's total.
__device__ __forceinline__ long long total_of(unsigned long long* words,
                                              long long n_tiles) {
  return n_tiles > 0 ? static_cast<long long>(
                           lookback_load(words + n_tiles - 1) & 0xffffffffull)
                     : 0;
}

// Two blocks an SM (at most 85 registers a thread, ptxas spilling the
// rest) at spawn depth 1 and 2, as worklog_phase runs; unbounded, the
// kernel takes 168 registers and one block an SM, which measured slower
// (the source note).  Depths 3 and 4 run one block an SM.
template <int D, int ROUNDS, bool BLOCK2>
__global__ void __launch_bounds__(kTile, D <= 2 ? 2 : 1) staged_phase(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float2 table_rows[];
  for (int j = threadIdx.x; j < PST_N_STEPS; j += kTile) {
    table_rows[j] = a.table[j];
  }
  const long long cap = a.cap;
  const long long region_words = kHeader + (D + 1) * a.tiles_max;
  const long long n_threads = static_cast<long long>(gridDim.x) * kTile;
  const long long gid = static_cast<long long>(blockIdx.x) * kTile +
                        threadIdx.x;
  for (long long w = gid; w < region_words; w += n_threads) a.lookback[w] = 0;
  if (gid == 0) a.result[kResPushes] = 0;
  grid.sync();

  // Sub-phase q uses region q % kRegions and zeroes the next one, last
  // used by sub-phase q - 2, whose words every block read before the
  // barrier that ended q - 1.
  int q = 0;
  auto open = [&]() {
    unsigned long long* next =
        a.lookback + ((q + 1) % kRegions) * region_words;
    for (long long w = gid; w < region_words; w += n_threads) next[w] = 0;
    return a.lookback + (q % kRegions) * region_words;
  };
  auto close = [&]() {
    grid.sync();
    ++q;
  };
  auto ticket = [](unsigned long long* r) {
    return lookback_ticket(reinterpret_cast<unsigned int*>(r + kTicket));
  };
  // (a) the unfinished slots of [0, m) of ``status`` (the caller's, read
  // through the read-only path, with ``input``), ascending, to ``list``;
  // returns their count, and counts the DEAD rows into ``dead_rows``
  auto scan = [&](const int32_t* status, long long m, int32_t* list,
                  bool input, long long& dead_rows) {
    unsigned long long* r = open();
    const long long n_tiles = (m + kScanTile - 1) / kScanTile;
    int dead_in = 0;
    for (int tile = ticket(r); tile < n_tiles; tile = ticket(r)) {
      compact_tile(
          tile, m, r + kHeader,
          [&](long long i) {
            const int s = input ? __ldg(status + i) : __ldcg(status + i);
            dead_in += s == kStatusDead ? 1 : 0;
            return is_unfinished(s);
          },
          [&](long long i, long long rank) {
            list[rank] = static_cast<int32_t>(i);
          });
    }
    add_block_count(dead_in, r + kCount);
    close();
    dead_rows = static_cast<long long>(lookback_load(r + kCount));
    return static_cast<int>(total_of(r + kHeader, n_tiles));
  };

  long long n = a.n0;        // created slots, dropped children included
  long long dead = 0;        // DEAD rows below min(n, cap)
  long long reclaimed = 0;
  int reclaims = 0;
  long long pushes = 0;      // this thread's
  int cur = 0;               // the stack holding the population
  int pass = 0;
  bool stuck = false;

  // pass 1's list: the caller's unfinished slots, its rows copied into the
  // stack on the way
  PassIn<D> in;
  {
    const long long m = n < cap ? n : cap;
    int32_t* stack = a.stacks;
    for (long long i = gid; i < m; i += n_threads) {
      int32_t* p = stack + i;
      const int32_t* pos = reinterpret_cast<const int32_t*>(a.pos) + 3 * i;
      const int32_t* vel = reinterpret_cast<const int32_t*>(a.vel) + 3 * i;
      const int32_t* acc = reinterpret_cast<const int32_t*>(a.acc) + 3 * i;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p[c * cap] = __ldg(pos + c);
        p[(3 + c) * cap] = __ldg(vel + c);
        p[(6 + c) * cap] = __ldg(acc + c);
      }
      p[9 * cap] = __ldg(a.status + i);
      p[10 * cap] = __ldg(a.id_hi + i);
      p[11 * cap] = __ldg(a.id_lo + i);
    }
    in.list = a.list + cap;  // pass p reads list p % 2
    in.n_susp = scan(a.status, m, a.list + cap, true, dead);
    in.n_list = in.n_susp;
    in.kids = a.stage;
    in.n_app = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) in.k_depth[d] = 0;
  }

  while (true) {
    // every unfinished lane of pass p + 1 starts later than the earliest
    // start of pass p, so a phase needs at most t_steps + 1 passes
    if (pass > a.k.t_steps) {
      stuck = true;
      break;
    }
    ++pass;
    int32_t* stack = a.stacks + cur * kNF * cap;
    int32_t* next_list = a.list + ((pass + 1) & 1) * cap;
    int32_t* stage = a.stage + (pass & 1) * D * kNF * cap;

    // (b) sweep and stage
    unsigned long long* r = open();
    const long long n_tiles = (in.n_list + kTile - 1) / kTile;
    {
      int died = 0;
      for (int tile = ticket(r); tile < n_tiles; tile = ticket(r)) {
        sweep_tile<D, ROUNDS, BLOCK2>(a, tile, in, stack, next_list, stage,
                                      r + kHeader, pushes, died);
      }
      add_block_count(died, r + kCount);
    }
    close();
    long long k = 0;
    long long k_depth[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      k_depth[d] = total_of(r + kHeader + d * a.tiles_max, n_tiles);
      k += k_depth[d];
    }
    int n_susp = static_cast<int>(
        total_of(r + kHeader + D * a.tiles_max, n_tiles));
    dead += static_cast<long long>(lookback_load(r + kCount));

    // (c) the pre-append reclaim (never past an overflow, whose count of
    // dropped children lives in n), then the next list from the moved rows
    if (n <= cap && n + k > cap && dead > 0) {
      r = open();
      int32_t* dst = a.stacks + (cur ^ 1) * kNF * cap;
      const int32_t* status = stack + kStatusField * cap;
      const long long c_tiles = (n + kScanTile - 1) / kScanTile;
      for (int tile = ticket(r); tile < c_tiles; tile = ticket(r)) {
        compact_tile(
            tile, n, r + kHeader,
            [&](long long i) {
              const int s = __ldcg(status + i);
              return s != kStatusDead && s != kStatusEmpty;
            },
            [&](long long i, long long rank) {
              copy_row(stack + i, dst + rank, cap);
            });
      }
      close();
      const long long n_new = total_of(r + kHeader, c_tiles);
      reclaimed += n - n_new;
      ++reclaims;
      n = n_new;
      dead = 0;
      cur ^= 1;
      long long none;  // the reclaim left no DEAD row
      n_susp = scan(dst + kStatusField * cap, n, next_list, false, none);
    }

    // (d) the append: the children that fit take [n, n + keep) as the next
    // pass sweeps them
    long long keep = cap - n < k ? cap - n : k;
    if (keep < 0) keep = 0;
    if (n_susp == 0 && keep == 0) {
      n += k;
      break;
    }
    in.list = next_list;
    in.n_susp = n_susp;
    in.n_list = n_susp + static_cast<int>(keep);
    in.kids = stage;
    in.n_app = n;
#pragma unroll
    for (int d = 0; d < D; ++d) in.k_depth[d] = k_depth[d];
    n += k;
  }

  // (e) the finished rows, decoded and reset to ALIVE, to the output
  long long n_live = 0;
  if (!stuck) {
    unsigned long long* r = open();
    const int32_t* stack = a.stacks + cur * kNF * cap;
    const int32_t* status = stack + kStatusField * cap;
    const long long m = n < cap ? n : cap;
    const long long n_tiles = (m + kScanTile - 1) / kScanTile;
    for (int tile = ticket(r); tile < n_tiles; tile = ticket(r)) {
      compact_tile(
          tile, m, r + kHeader,
          [&](long long i) {
            const int s = __ldcg(status + i);
            const int stamp = is_finished(s) ? decode_finished(s) : s;
            return stamp == kStatusAlive || stamp > 0;
          },
          [&](long long i, long long rank) {
            const Lane L = load_row(stack + i, cap);
            a.out_pos[3 * rank] = L.px;
            a.out_pos[3 * rank + 1] = L.py;
            a.out_pos[3 * rank + 2] = L.pz;
            a.out_vel[3 * rank] = L.vx;
            a.out_vel[3 * rank + 1] = L.vy;
            a.out_vel[3 * rank + 2] = L.vz;
            a.out_acc[3 * rank] = L.ax;
            a.out_acc[3 * rank + 1] = L.ay;
            a.out_acc[3 * rank + 2] = L.az;
            a.out_status[rank] = kStatusAlive;
            a.out_id_hi[rank] = static_cast<int32_t>(L.id_hi);
            a.out_id_lo[rank] = static_cast<int32_t>(L.id_lo);
          });
    }
    close();
    n_live = total_of(r + kHeader, n_tiles);
    // rows past the population hold zeros and status EMPTY
    for (long long j = 3 * n_live + gid; j < 3 * cap; j += n_threads) {
      a.out_pos[j] = 0.0f;
      a.out_vel[j] = 0.0f;
      a.out_acc[j] = 0.0f;
    }
    for (long long j = n_live + gid; j < cap; j += n_threads) {
      a.out_status[j] = kStatusEmpty;
      a.out_id_hi[j] = 0;
      a.out_id_lo[j] = 0;
    }
  }
  pushes = warp_sum(pushes);
  if ((threadIdx.x & 31) == 0 && pushes) {
    atomicAdd(reinterpret_cast<unsigned long long*>(a.result + kResPushes),
              static_cast<unsigned long long>(pushes));
  }
  if (gid == 0) {
    a.result[kResN] = n;
    a.result[kResLive] = n_live;
    a.result[kResPasses] = pass;
    a.result[kResReclaimed] = reclaimed;
    a.result[kResReclaims] = reclaims;
    a.result[kResStuck] = stuck;
    a.result[kResBlocks] = gridDim.x;
  }
}

template <int D, int ROUNDS, bool BLOCK2>
cudaError_t launch(Args& a, cudaStream_t stream) {
  static CoopCache cache;
  const auto kernel = staged_phase<D, ROUNDS, BLOCK2>;
  void* args[] = {&a};
  return launch_cooperative((const void*)kernel, kTile, kTableBytes,
                            a.tiles_max, args, cache, stream);
}

template <int D>
cudaError_t dispatch(int rounds, int block2, Args& a, cudaStream_t stream) {
  if (rounds == 13 && block2) return launch<D, 13, true>(a, stream);
  if (rounds == 13) return launch<D, 13, false>(a, stream);
  if (rounds == 20 && block2) return launch<D, 20, true>(a, stream);
  if (rounds == 20) return launch<D, 20, false>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace staged
}  // namespace pst

// A whole staged mobility phase on ``stream``: the input state (pos, vel,
// acc (C, 3) float32; status, id_hi, id_lo (C,) int32; n0 created slots)
// to the output state of the same capacity, through the record stacks
// ``stacks`` ((2, 12, C) int32), the staging regions ``stage`` ((2, depth,
// 12, C) int32), the work lists ``list`` ((2, C) int32) and the look-back
// words ``lookback`` ((PST_STAGED_REGIONS, PST_STAGED_HEADER + (depth + 1)
// * tiles_max) int64, tiles_max >= ceil(C / PST_STAGED_TILE)), all of any
// content.  ``result`` (PST_STAGED_RESULT_WORDS int64) gets the kRes*
// words.  Returns a cudaError_t (0 on success), including a refused
// cooperative launch.
extern "C" int pst_staged_phase(
    const void* pos, const void* vel, const void* acc, const void* status,
    const void* id_hi, const void* id_lo, long long n0, void* out_pos,
    void* out_vel, void* out_acc, void* out_status, void* out_id_hi,
    void* out_id_lo, long long capacity, void* stacks, void* stage,
    void* list, void* lookback, long long tiles_max, void* result,
    const void* table, float dt, float half_dt, float size_x, float size_y,
    float size_z, float log10_e, float bucket_scale, unsigned int seed,
    unsigned int poisson_step, int t_steps, int depth, int rounds,
    int block2, void* stream) {
  using namespace pst::staged;
  // list entries and look-back counts are 32-bit: at most C of each a pass
  if (n0 <= 0 || capacity <= 0 || capacity > INT32_MAX || depth < 1 ||
      depth > kMaxDepth || tiles_max < (capacity + kTile - 1) / kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
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
  a.stacks = static_cast<int32_t*>(stacks);
  a.stage = static_cast<int32_t*>(stage);
  a.list = static_cast<int32_t*>(list);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (depth) {
    case 1: err = dispatch<1>(rounds, block2, a, st); break;
    case 2: err = dispatch<2>(rounds, block2, a, st); break;
    case 3: err = dispatch<3>(rounds, block2, a, st); break;
    case 4: err = dispatch<4>(rounds, block2, a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
