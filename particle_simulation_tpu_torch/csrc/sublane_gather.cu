// take_along_axis on one (S, 128) float32 tile, along its rows
// ("sublanes" on the TPU) or along both axes.
//
// Replaces scripts/experiment_sublane_gather.py::kernel, a probe of
// whether Mosaic lowers take_along_axis along sublanes.  For index tiles
// idx of shape (B, S, 128) (B = 1 is the TPU kernel's call):
//   sublane: out[b, i, j] = x[idx[b, i, j], j];
//   both:    c = (idx[b, i, j] * 7) mod 128, r = idx[b, i, c] mod S,
//            out[b, i, j] = x[r, c]
// ("both" is the composition take_along_axis(take_along_axis(x, row, 0),
// col, 1) with row = idx mod S and col = (idx * 7) mod 128, not a 2-D
// gather).  mod is the floor modulo of jnp and torch, and idx * 7 wraps
// as int32, so "both" reads inside x for every index.  "sublane" takes
// indices in [0, S); outside it the kernel reads nothing and writes NaN.
//
// The TPU needs a sublane shuffle for this.  Hopper gathers per thread:
// one thread an element, x read through the read-only cache (at most
// 64 KB at S = 128, held in L1 and L2).  What bounds it on the H100:
// memory traffic, 4 bytes of index in and 4 bytes out an element (16 MiB
// at 2M elements, about 5 us at 3.35 TB/s); at B = 1 the launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace pst {

constexpr int kGatherLanes = 128;
constexpr int kSublaneThreads = 256;

template <bool BOTH>
__global__ void __launch_bounds__(kSublaneThreads)
sublane_gather(const float* __restrict__ x, const int32_t* __restrict__ idx,
               float* __restrict__ out, int s, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * kSublaneThreads +
                      threadIdx.x;
  if (e >= n) return;
  const int32_t v = idx[e];
  if (BOTH) {
    // (v * 7) mod 128 with int32 wrap: the low 7 bits of the product
    const int c = static_cast<int>(static_cast<uint32_t>(v) * 7u) &
                  (kGatherLanes - 1);
    int r = __ldg(idx + (e - (e & (kGatherLanes - 1)) + c)) % s;
    if (r < 0) r += s;
    out[e] = __ldg(x + r * kGatherLanes + c);
  } else {
    const int j = static_cast<int>(e & (kGatherLanes - 1));
    out[e] = (v >= 0 && v < s) ? __ldg(x + v * kGatherLanes + j)
                               : __int_as_float(0x7fc00000);
  }
}

}  // namespace pst

// out (n = B * S * 128 floats) from the (S, 128) tile ``x`` and the
// indices ``idx`` (n int32), on ``stream``; ``both`` selects the variant.
// Returns a cudaError_t (0 on success).
extern "C" int pst_sublane_gather(const void* x, const void* idx, void* out,
                                  int s, long long n, int both, void* stream) {
  using namespace pst;
  if (n <= 0 || s <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks =
      static_cast<unsigned int>((n + kSublaneThreads - 1) / kSublaneThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const float*>(x);
  const auto* ip = static_cast<const int32_t*>(idx);
  auto* op = static_cast<float*>(out);
  if (both) {
    sublane_gather<true><<<blocks, kSublaneThreads, 0, st>>>(xp, ip, op, s, n);
  } else {
    sublane_gather<false><<<blocks, kSublaneThreads, 0, st>>>(xp, ip, op, s, n);
  }
  return static_cast<int>(cudaGetLastError());
}
