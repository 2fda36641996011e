// The work-log engine on Hopper: one pass of the mobility phase.
//
// Replaces particle_simulation_tpu/ops/pallas/worklog.py::_worklog_kernel
// (launched per pass by _sweep's pallas_call) with the inlined lookup of
// push_mcc.py::make_chunked_lookup.  A pass sweeps a source log of
// particle records (a (12, stride) int32 stack: pos, vel, acc as float bit
// patterns, status, id_hi, id_lo; ops/kernels/push_mcc.py FIELD_NAMES), runs
// each unfinished record through its mobility steps, then emits, in source
// order,
//   * finished records, status reset to ALIVE, to the done log after the
//     n_done_in records already there (the done log ends up as the next
//     population: no separate compaction);
//   * suspended parents and their staged children to the work log, which
//     the next pass sweeps (the host ping-pongs two work logs).
//
// Three kernels make a pass:
//   worklog_sweep: one thread per source record runs physics.cuh's
//     advance_lane, writes the lane back in place, its children to a
//     staging area, a per-record code (done, suspended, children) and the
//     block's counts;
//   worklog_scan:  one block scans the per-block counts into offsets and
//     totals (done, work, children, pushes as 64-bit sums);
//   worklog_emit:  one thread per record scans its block's codes and copies
//     the records to their offsets.  No atomics, so the emitted order is
//     the same on every run.
//
// What bounds it on the H100: the T-loop is compute-bound.  Each mobility
// step costs one Threefry block per step pair (13 rounds: about 70 integer
// operations) plus a logf, a dozen float operations and one 8-byte table
// read; a source record moves 48 bytes in and out once per pass, against
// up to T = 100 steps of that arithmetic.  The design keeps the lane, its
// frozen half-kick and its staged children in registers for the whole
// phase, reads the table through the read-only cache, and halves the
// cipher work with the step-pair block.  Lanes of one warp start and die
// at different steps, so warps diverge; a later version can sort records
// by start step.
#include <cuda_runtime.h>

#include <cstdint>

#include "physics.cuh"
#include "scan.cuh"

namespace pst {

constexpr int kNF = 12;
constexpr int kScanThreads = 1024;
constexpr int kStatusField = 9;

// code of a swept record: bit 0 done, bit 1 suspended, bits 2.. children
__device__ __forceinline__ int work_count(int code) {
  return ((code >> 1) & 1) + (code >> 2);
}

template <int D, int ROUNDS, bool BLOCK2>
__global__ void __launch_bounds__(kBlock)
worklog_sweep(int32_t* __restrict__ src, long long src_stride, int n_src,
              int32_t* __restrict__ stage, long long stage_stride,
              int32_t* __restrict__ code, long long* __restrict__ block_sums,
              const float2* __restrict__ table, PhysConsts k) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  int c = 0;
  int pushes = 0;
  if (i < n_src) {
    const int s = src[kStatusField * src_stride + i];
    if (is_unfinished(s)) {
      Lane L;
      L.px = __int_as_float(src[0 * src_stride + i]);
      L.py = __int_as_float(src[1 * src_stride + i]);
      L.pz = __int_as_float(src[2 * src_stride + i]);
      L.vx = __int_as_float(src[3 * src_stride + i]);
      L.vy = __int_as_float(src[4 * src_stride + i]);
      L.vz = __int_as_float(src[5 * src_stride + i]);
      L.ax = __int_as_float(src[6 * src_stride + i]);
      L.ay = __int_as_float(src[7 * src_stride + i]);
      L.az = __int_as_float(src[8 * src_stride + i]);
      L.status = s;
      L.id_hi = static_cast<uint32_t>(src[10 * src_stride + i]);
      L.id_lo = static_cast<uint32_t>(src[11 * src_stride + i]);
      Child children[D];
      int n_children = 0;
      pushes = advance_lane<D, ROUNDS, BLOCK2>(L, children, n_children,
                                               table, k);
      src[0 * src_stride + i] = __float_as_int(L.px);
      src[1 * src_stride + i] = __float_as_int(L.py);
      src[2 * src_stride + i] = __float_as_int(L.pz);
      src[3 * src_stride + i] = __float_as_int(L.vx);
      src[4 * src_stride + i] = __float_as_int(L.vy);
      src[5 * src_stride + i] = __float_as_int(L.vz);
      src[kStatusField * src_stride + i] = L.status;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d < n_children) {
          const Child& ch = children[d];
          int32_t* out = stage + static_cast<long long>(d) * kNF * stage_stride + i;
          out[0 * stage_stride] = __float_as_int(ch.px);
          out[1 * stage_stride] = __float_as_int(ch.py);
          out[2 * stage_stride] = __float_as_int(ch.pz);
          out[3 * stage_stride] = __float_as_int(ch.vx);
          out[4 * stage_stride] = __float_as_int(ch.vy);
          out[5 * stage_stride] = __float_as_int(ch.vz);
          out[6 * stage_stride] = __float_as_int(L.ax);
          out[7 * stage_stride] = __float_as_int(L.ay);
          out[8 * stage_stride] = __float_as_int(L.az);
          out[9 * stage_stride] = ch.stamp;
          out[10 * stage_stride] = static_cast<int32_t>(ch.id_hi);
          out[11 * stage_stride] = static_cast<int32_t>(ch.id_lo);
        }
      }
      const bool finished = L.status == kStatusAlive || L.status > 0;
      c = (finished ? 1 : 0) | (is_suspended(L.status) ? 2 : 0) |
          (n_children << 2);
    }
    code[i] = c;
  }
  int ex_a, ex_b, done_tot, work_tot, child_tot, push_tot;
  block_scan2(c & 1, work_count(c), ex_a, ex_b, done_tot, work_tot);
  __syncthreads();
  block_scan2(c >> 2, pushes, ex_a, ex_b, child_tot, push_tot);
  if (threadIdx.x == 0) {
    long long* out = block_sums + 4LL * blockIdx.x;
    out[0] = done_tot;
    out[1] = work_tot;
    out[2] = child_tot;
    out[3] = push_tot;
  }
}

// One block: exclusive offsets of every sweep block in the done and work
// streams, and the pass totals (done, work, children, pushes).
__global__ void __launch_bounds__(kScanThreads)
worklog_scan(const long long* __restrict__ block_sums, int n_blocks,
             long long* __restrict__ offsets, long long* __restrict__ totals) {
  scan_block_sums<4, 2, kScanThreads>(block_sums, n_blocks, offsets, totals);
}

__global__ void __launch_bounds__(kBlock)
worklog_emit(const int32_t* __restrict__ src, long long src_stride, int n_src,
             const int32_t* __restrict__ stage, long long stage_stride,
             const int32_t* __restrict__ code,
             const long long* __restrict__ offsets,
             int32_t* __restrict__ done, long long done_cap,
             long long n_done_in, int32_t* __restrict__ work,
             long long work_cap) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const int c = i < n_src ? code[i] : 0;
  int ex_d, ex_w, tot_d, tot_w;
  block_scan2(c & 1, work_count(c), ex_d, ex_w, tot_d, tot_w);
  if (c == 0) return;
  const long long od = n_done_in + offsets[2LL * blockIdx.x] + ex_d;
  long long ow = offsets[2LL * blockIdx.x + 1] + ex_w;
  if ((c & 1) && od < done_cap) {
#pragma unroll
    for (int f = 0; f < kNF; ++f) {
      done[f * done_cap + od] =
          f == kStatusField ? kStatusAlive : src[f * src_stride + i];
    }
  }
  if (c & 2) {
    if (ow < work_cap) {
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        work[f * work_cap + ow] = src[f * src_stride + i];
      }
    }
    ++ow;
  }
  const int n_children = c >> 2;
  for (int d = 0; d < n_children; ++d, ++ow) {
    if (ow < work_cap) {
      const int32_t* in = stage + static_cast<long long>(d) * kNF * stage_stride + i;
#pragma unroll
      for (int f = 0; f < kNF; ++f) {
        work[f * work_cap + ow] = in[f * stage_stride];
      }
    }
  }
}

template <int D, int ROUNDS, bool BLOCK2>
void launch_sweep(int n_blocks, cudaStream_t stream, int32_t* src,
                  long long src_stride, int n_src, int32_t* stage,
                  long long stage_stride, int32_t* code,
                  long long* block_sums, const float2* table,
                  const PhysConsts& k) {
  worklog_sweep<D, ROUNDS, BLOCK2><<<n_blocks, kBlock, 0, stream>>>(
      src, src_stride, n_src, stage, stage_stride, code, block_sums, table, k);
}

template <int D>
bool dispatch_sweep(int rounds, int block2, int n_blocks, cudaStream_t stream,
                    int32_t* src, long long src_stride, int n_src,
                    int32_t* stage, long long stage_stride, int32_t* code,
                    long long* block_sums, const float2* table,
                    const PhysConsts& k) {
#define PST_SWEEP(R, B)                                                     \
  launch_sweep<D, R, B>(n_blocks, stream, src, src_stride, n_src, stage,  \
                        stage_stride, code, block_sums, table, k)
  if (rounds == 13 && block2) PST_SWEEP(13, true);
  else if (rounds == 13) PST_SWEEP(13, false);
  else if (rounds == 20 && block2) PST_SWEEP(20, true);
  else if (rounds == 20) PST_SWEEP(20, false);
  else return false;
#undef PST_SWEEP
  return true;
}

}  // namespace pst

// One pass: sweep, scan, emit on ``stream``.  Returns a cudaError_t (0 on
// success); the caller reads the four 64-bit totals from ``totals``.
extern "C" int pst_worklog_pass(
    void* src, long long src_stride, int n_src, void* stage,
    long long stage_stride, void* code, void* block_sums, void* offsets,
    void* totals, const void* table, void* done, long long done_cap,
    long long n_done_in, void* work, long long work_cap, float dt,
    float half_dt, float size_x, float size_y, float size_z, float log10_e,
    float bucket_scale, unsigned int seed, unsigned int poisson_step,
    int t_steps, int depth, int rounds, int block2, void* stream) {
  using namespace pst;
  if (n_src <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n_src + kBlock - 1) / kBlock;
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
  auto* src_i = static_cast<int32_t*>(src);
  auto* stage_i = static_cast<int32_t*>(stage);
  auto* code_i = static_cast<int32_t*>(code);
  auto* sums = static_cast<long long*>(block_sums);
  const auto* tab = static_cast<const float2*>(table);
  bool ok;
  switch (depth) {
    case 1: ok = dispatch_sweep<1>(rounds, block2, n_blocks, st, src_i, src_stride, n_src, stage_i, stage_stride, code_i, sums, tab, k); break;
    case 2: ok = dispatch_sweep<2>(rounds, block2, n_blocks, st, src_i, src_stride, n_src, stage_i, stage_stride, code_i, sums, tab, k); break;
    case 3: ok = dispatch_sweep<3>(rounds, block2, n_blocks, st, src_i, src_stride, n_src, stage_i, stage_stride, code_i, sums, tab, k); break;
    case 4: ok = dispatch_sweep<4>(rounds, block2, n_blocks, st, src_i, src_stride, n_src, stage_i, stage_stride, code_i, sums, tab, k); break;
    default: ok = false;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  worklog_scan<<<1, kScanThreads, 0, st>>>(
      sums, n_blocks, static_cast<long long*>(offsets),
      static_cast<long long*>(totals));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  worklog_emit<<<n_blocks, kBlock, 0, st>>>(
      src_i, src_stride, n_src, stage_i, stage_stride, code_i,
      static_cast<const long long*>(offsets), static_cast<int32_t*>(done),
      done_cap, n_done_in, static_cast<int32_t*>(work), work_cap);
  return static_cast<int>(cudaGetLastError());
}
