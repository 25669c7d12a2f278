// Tropical (min, +) matrix product for Hopper, built for sm_90a.
//
//   C[i, j] = min(min_k (A[i, k] + B[k, j]), INF)      int32, INF = 1 << 29
//
// A [M, K] and B [K, N] are int32 with any element strides; C [M, N] is
// int32 with leading dimension ldc.  K = 0 gives INF everywhere.
//
// Precondition: every entry of A and B lies in [0, INF].  Then every sum is
// at most 2 INF = 2^30 < 2^31 and cannot overflow, so the accumulator starts
// at INF and is clipped to INF once, at the end.  (The TPU kernel clips
// after every K block; clipping once gives the same result under this
// precondition.)  Every operand on the query path is a hop count clipped at
// INF, so the precondition holds there.
//
// Replaces the TPU kernel src/repro/kernels/tropical_matmul/
// tropical_matmul.py, function tropical_matmul_pallas (body _kernel), which
// sweeps the contraction in chunks of 8 with a [bm, ck, bn] broadcast-add in
// VMEM, because the TPU's matrix unit has no (min, +) mode.
//
// What bounds it on the card.  The tensor cores have no (min, +) mode
// either, so a squaring at M = N = K = nb is nb^3 min-plus pairs on the
// SIMT integer lanes: it is bound by operations.  The DPX instruction
// __viaddmin_s32(a, b, c) = min(a + b, c) does one pair in one instruction.
//
// Design.  Each block of 256 threads owns a 128 x 128 output tile and each
// thread 8 x 8 accumulators in registers.  The contraction is staged
// through shared memory 16 steps at a time, A transposed so that a thread's
// 8 rows and 8 columns are each two 16-byte shared loads: 4 loads feed 64
// DPX instructions.  Out-of-range operands load as INF, which no min-plus
// sum can undercut, so the ragged edges need no padding; rows past M and
// columns past N are never stored.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int INF = 1 << 29;
constexpr int TILE = 128;         // output rows and columns per block
constexpr int KS = 16;            // contraction steps per shared stage
constexpr int PITCH = TILE + 4;   // shared row pitch in words
constexpr int THREADS = 256;      // 16 x 16 threads, 8 x 8 outputs each

__global__ void __launch_bounds__(THREADS)
min_plus_kernel(const int* __restrict__ a, const int* __restrict__ b,
                int* __restrict__ c, int M, int K, int N, int sa0, int sa1,
                int sb0, int sb1, int ldc) {
  __shared__ __align__(16) int As[KS][PITCH];   // As[k][row]
  __shared__ __align__(16) int Bs[KS][PITCH];   // Bs[k][col]
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;

  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = INF;

  for (int k0 = 0; k0 < K; k0 += KS) {
    for (int e = t; e < TILE * KS; e += THREADS) {
      const int r = e / KS, kk = e % KS;
      const int gi = m0 + r, gk = k0 + kk;
      As[kk][r] = (gi < M && gk < K)
                      ? a[(size_t)gi * sa0 + (size_t)gk * sa1] : INF;
    }
    for (int e = t; e < TILE * KS; e += THREADS) {
      const int kk = e / TILE, col = e % TILE;
      const int gj = n0 + col, gk = k0 + kk;
      Bs[kk][col] = (gj < N && gk < K)
                        ? b[(size_t)gk * sb0 + (size_t)gj * sb1] : INF;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int4 a0 = *reinterpret_cast<const int4*>(&As[kk][ty * 8]);
      const int4 a1 = *reinterpret_cast<const int4*>(&As[kk][ty * 8 + 4]);
      const int4 b0 = *reinterpret_cast<const int4*>(&Bs[kk][tx * 8]);
      const int4 b1 = *reinterpret_cast<const int4*>(&Bs[kk][tx * 8 + 4]);
      const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __viaddmin_s32(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = m0 + ty * 8 + i;
    if (gi >= M) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gj = n0 + tx * 8 + j;
      if (gj < N) c[(size_t)gi * ldc + gj] = min(acc[i][j], INF);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int min_plus_matmul(const void* a, const void* b, void* c, int M,
                               int K, int N, int sa0, int sa1, int sb0,
                               int sb1, int ldc, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + TILE - 1) / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  min_plus_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<int*>(c), M, K, N, sa0, sa1, sb0, sb1, ldc);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
