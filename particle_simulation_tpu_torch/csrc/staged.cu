// The staged engine on Hopper (scheduler dynamic_old): one sweep pass of
// its work-list fixed point.
//
// Replaces particle_simulation_tpu/ops/pallas/push_mcc.py::_mobility_kernel
// (launched per pass by _sweep_pass's pallas_call), with the inlined lookup
// of push_mcc.py::make_chunked_lookup (lookup.cuh), and the append of the
// staged children that follows each pass there (push_mcc._append_staged).
// This is the faithful staged design, kept beside the work-log engine
// (worklog.cu) as the JAX package keeps its older engine, and as the
// reference keeps its older persistent kernel as mode 33: not a redesign.
//
// A pass runs over the slots [0, n) of a (12, stride) int32 record stack
// (pos, vel, acc as float bit patterns, status, id_hi, id_lo; ops/kernels/
// push_mcc.py FIELD_NAMES), in place, in three kernels:
//   staged_sweep:  one thread per slot.  A slot that is not unfinished
//     (finished, dead, empty) writes nothing.  An unfinished lane (fresh -1,
//     spawn stamp > 0, suspended) runs physics.cuh's advance_lane from its
//     start step to T and is written back in place: finished (the stamp
//     packed by encode_finished) if it is live at the end, DEAD if it died,
//     or the suspended packing if its D child slots filled.  Its children go
//     to a (D, 12, stride) staging area, slot i's d-th child at [d][:, i];
//     code[i] is its child count.  Each block writes its counts: children at
//     each depth, pushes, suspended lanes, DEAD rows.
//   staged_scan:   one block scans the per-block counts into each block's
//     offsets per depth and the pass totals (64-bit sums).
//   staged_append (a second call, after the host has read the totals and
//     reclaimed dead rows where the children would not fit): the staged
//     children to slots [n_dst, n_dst + k) in depth-major, then slot order;
//     those at or beyond the capacity are dropped (the host counts them in
//     n).  No atomics, so the order is the same on every run.
//
// What bounds it on the H100: the T-loop is compute-bound, as in
// worklog.cu (a Threefry block per step pair, a logf, a dozen float
// operations and an 8-byte table read per step).  Unlike the work-log
// engine, every pass rescans all n slots; a finished lane costs one 4-byte
// status read and returns at once, so a pass over a mostly finished
// population is bound by that read (8 MB at 2M slots).
#include <cuda_runtime.h>

#include <cstdint>

#include "physics.cuh"
#include "scan.cuh"

namespace pst {

constexpr int kNF = 12;
constexpr int kStatusField = 9;
constexpr int kMaxDepth = 4;
// per-block counts: children at depth 0..3, pushes, suspended, dead, pad
constexpr int kNCol = 8;
constexpr int kScanThreads = 512;

template <int D, int ROUNDS, bool BLOCK2>
__global__ void __launch_bounds__(kBlock)
staged_sweep(int32_t* __restrict__ stack, long long stride, int n,
             int32_t* __restrict__ stage, int32_t* __restrict__ code,
             long long* __restrict__ block_sums,
             const float2* __restrict__ table, PhysConsts k) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  int c = 0, pushes = 0, suspended = 0, dead = 0;
  if (i < n) {
    const int s = stack[kStatusField * stride + i];
    if (is_unfinished(s)) {
      Lane L;
      L.px = __int_as_float(stack[0 * stride + i]);
      L.py = __int_as_float(stack[1 * stride + i]);
      L.pz = __int_as_float(stack[2 * stride + i]);
      L.vx = __int_as_float(stack[3 * stride + i]);
      L.vy = __int_as_float(stack[4 * stride + i]);
      L.vz = __int_as_float(stack[5 * stride + i]);
      L.ax = __int_as_float(stack[6 * stride + i]);
      L.ay = __int_as_float(stack[7 * stride + i]);
      L.az = __int_as_float(stack[8 * stride + i]);
      L.status = s;
      L.id_hi = static_cast<uint32_t>(stack[10 * stride + i]);
      L.id_lo = static_cast<uint32_t>(stack[11 * stride + i]);
      Child children[D];
      pushes = advance_lane<D, ROUNDS, BLOCK2>(L, children, c, table, k);
      stack[0 * stride + i] = __float_as_int(L.px);
      stack[1 * stride + i] = __float_as_int(L.py);
      stack[2 * stride + i] = __float_as_int(L.pz);
      stack[3 * stride + i] = __float_as_int(L.vx);
      stack[4 * stride + i] = __float_as_int(L.vy);
      stack[5 * stride + i] = __float_as_int(L.vz);
      const bool live = L.status == kStatusAlive || L.status > 0;
      stack[kStatusField * stride + i] =
          live ? encode_finished(L.status) : L.status;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d < c) {
          const Child& ch = children[d];
          int32_t* out = stage + static_cast<long long>(d) * kNF * stride + i;
          out[0 * stride] = __float_as_int(ch.px);
          out[1 * stride] = __float_as_int(ch.py);
          out[2 * stride] = __float_as_int(ch.pz);
          out[3 * stride] = __float_as_int(ch.vx);
          out[4 * stride] = __float_as_int(ch.vy);
          out[5 * stride] = __float_as_int(ch.vz);
          out[6 * stride] = __float_as_int(L.ax);
          out[7 * stride] = __float_as_int(L.ay);
          out[8 * stride] = __float_as_int(L.az);
          out[9 * stride] = ch.stamp;
          out[10 * stride] = static_cast<int32_t>(ch.id_hi);
          out[11 * stride] = static_cast<int32_t>(ch.id_lo);
        }
      }
      suspended = is_suspended(L.status) ? 1 : 0;
      dead = L.status == kStatusDead ? 1 : 0;
    } else {
      dead = s == kStatusDead ? 1 : 0;
    }
    code[i] = c;
  }
  int ex_a, ex_b, t0, t1, t2, t3, tp, ts, td, tz;
  block_scan2(c > 0, c > 1, ex_a, ex_b, t0, t1);
  __syncthreads();
  block_scan2(c > 2, c > 3, ex_a, ex_b, t2, t3);
  __syncthreads();
  block_scan2(pushes, suspended, ex_a, ex_b, tp, ts);
  __syncthreads();
  block_scan2(dead, 0, ex_a, ex_b, td, tz);
  if (threadIdx.x == 0) {
    long long* out = block_sums + static_cast<long long>(kNCol) * blockIdx.x;
    out[0] = t0;
    out[1] = t1;
    out[2] = t2;
    out[3] = t3;
    out[4] = tp;
    out[5] = ts;
    out[6] = td;
    out[7] = tz;
  }
}

// One block: each sweep block's exclusive offset among the children of
// each depth, and the pass totals (children per depth, pushes, suspended,
// dead).
__global__ void __launch_bounds__(kScanThreads)
staged_scan(const long long* __restrict__ block_sums, int n_blocks,
            long long* __restrict__ offsets, long long* __restrict__ totals) {
  scan_block_sums<kNCol, kMaxDepth, kScanThreads>(block_sums, n_blocks,
                                                  offsets, totals);
}

__device__ __forceinline__ void copy_child(const int32_t* __restrict__ stage,
                                           long long stride, int d, int i,
                                           int32_t* __restrict__ stack,
                                           long long pos) {
  if (pos >= stride) return;  // beyond the capacity: dropped
  const int32_t* in = stage + static_cast<long long>(d) * kNF * stride + i;
#pragma unroll
  for (int f = 0; f < kNF; ++f) stack[f * stride + pos] = in[f * stride];
}

// Children of depth d land after every child of the shallower depths, in
// slot order within a depth (the JAX package's children[f].reshape(-1)).
__global__ void __launch_bounds__(kBlock)
staged_append(const int32_t* __restrict__ stage, long long stride,
              int n_swept, const int32_t* __restrict__ code,
              const long long* __restrict__ offsets,
              const long long* __restrict__ totals, int depth,
              int32_t* __restrict__ stack, long long n_dst) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int c = i < n_swept ? code[i] : 0;
  const long long* off = offsets + static_cast<long long>(kMaxDepth) * blockIdx.x;
  long long base = n_dst;
  for (int d = 0; d < depth; d += 2) {
    int ex0, ex1, tot0, tot1;
    block_scan2(c > d, c > d + 1, ex0, ex1, tot0, tot1);
    if (c > d) copy_child(stage, stride, d, i, stack, base + off[d] + ex0);
    base += totals[d];
    if (c > d + 1) {
      copy_child(stage, stride, d + 1, i, stack, base + off[d + 1] + ex1);
    }
    base += totals[d + 1];
    __syncthreads();
  }
}

template <int D>
bool dispatch_staged_sweep(int rounds, int block2, int n_blocks,
                           cudaStream_t st, int32_t* stack, long long stride,
                           int n, int32_t* stage, int32_t* code,
                           long long* sums, const float2* table,
                           const PhysConsts& k) {
#define PST_SWEEP(R, B)                                                  \
  staged_sweep<D, R, B><<<n_blocks, kBlock, 0, st>>>(stack, stride, n, \
                                                     stage, code, sums, \
                                                     table, k)
  if (rounds == 13 && block2) PST_SWEEP(13, true);
  else if (rounds == 13) PST_SWEEP(13, false);
  else if (rounds == 20 && block2) PST_SWEEP(20, true);
  else if (rounds == 20) PST_SWEEP(20, false);
  else return false;
#undef PST_SWEEP
  return true;
}

}  // namespace pst

// Sweep and scan of one pass on ``stream``.  Returns a cudaError_t (0 on
// success); the caller reads the eight 64-bit totals (children at depth
// 0..3, pushes, suspended, dead, 0) from ``totals``.
extern "C" int pst_staged_sweep(
    void* stack, long long stride, int n, void* stage, void* code,
    void* block_sums, void* offsets, void* totals, const void* table,
    float dt, float half_dt, float size_x, float size_y, float size_z,
    float log10_e, float bucket_scale, unsigned int seed,
    unsigned int poisson_step, int t_steps, int depth, int rounds,
    int block2, void* stream) {
  using namespace pst;
  if (n <= 0 || n > stride) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n + kBlock - 1) / kBlock;
  PhysConsts k;
  k.dt = dt;
  k.half_dt = half_dt;
  k.size_x = size_x;
  k.size_y = size_y;
  k.size_z = size_z;
  k.log10_e = log10_e;
  k.bucket_scale = bucket_scale;
  k.seed = seed;
  k.poisson_step = poisson_step;
  k.t_steps = t_steps;
  auto* stack_i = static_cast<int32_t*>(stack);
  auto* stage_i = static_cast<int32_t*>(stage);
  auto* code_i = static_cast<int32_t*>(code);
  auto* sums = static_cast<long long*>(block_sums);
  const auto* tab = static_cast<const float2*>(table);
  bool ok;
  switch (depth) {
    case 1: ok = dispatch_staged_sweep<1>(rounds, block2, n_blocks, st, stack_i, stride, n, stage_i, code_i, sums, tab, k); break;
    case 2: ok = dispatch_staged_sweep<2>(rounds, block2, n_blocks, st, stack_i, stride, n, stage_i, code_i, sums, tab, k); break;
    case 3: ok = dispatch_staged_sweep<3>(rounds, block2, n_blocks, st, stack_i, stride, n, stage_i, code_i, sums, tab, k); break;
    case 4: ok = dispatch_staged_sweep<4>(rounds, block2, n_blocks, st, stack_i, stride, n, stage_i, code_i, sums, tab, k); break;
    default: ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  staged_scan<<<1, kScanThreads, 0, st>>>(
      sums, n_blocks, static_cast<long long*>(offsets),
      static_cast<long long*>(totals));
  return static_cast<int>(cudaGetLastError());
}

// Append of the children staged by the last sweep over ``n_swept`` slots,
// at slot ``n_dst`` of ``stack``, on ``stream``.  Returns a cudaError_t.
extern "C" int pst_staged_append(const void* stage, long long stride,
                                 int n_swept, const void* code,
                                 const void* offsets, const void* totals,
                                 int depth, void* stack, long long n_dst,
                                 void* stream) {
  using namespace pst;
  if (n_swept <= 0 || n_swept > stride || depth < 1 || depth > kMaxDepth ||
      n_dst < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = (n_swept + kBlock - 1) / kBlock;
  staged_append<<<n_blocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(stage), stride, n_swept,
      static_cast<const int32_t*>(code),
      static_cast<const long long*>(offsets),
      static_cast<const long long*>(totals), depth,
      static_cast<int32_t*>(stack), n_dst);
  return static_cast<int>(cudaGetLastError());
}
