// Throughput probe for the DPX instruction __viaddmin_s32 on sm_90a.
//
// Not on the query path.  It measures the rate that the min-plus kernel's
// bound is reckoned against: every thread of a full-occupancy grid runs
// `iters` rounds of 8 DPX instructions on registers only, in the same form
// as the kernel's inner loop (acc = min(x + y, acc)).  The 8 accumulators
// relax each other in a ring, so no round can be folded away and each round
// carries 8 instructions of which about 4 can issue together.  The result
// is written out so the loop is not dead.
//
//   DPX operations = blocks * THREADS * iters * 8

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
dpx_rate_kernel(const int* __restrict__ seed, int* __restrict__ out,
                int iters) {
  const int y = seed[0];
  int acc[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) acc[u] = seed[1 + u] + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      acc[u] = __viaddmin_s32(acc[(u + 1) % 8], y, acc[u]);
  }
  int s = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) s ^= acc[u];
  out[blockIdx.x * THREADS + threadIdx.x] = s;
}

}  // namespace

// seed: 9 int32 on the card; out: blocks * 256 int32.  Returns
// cudaGetLastError() after the launch.
extern "C" int dpx_rate(const void* seed, void* out, int blocks, int iters,
                        void* stream) {
  if (blocks <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  dpx_rate_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seed), static_cast<int*>(out), iters);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
