// Contraction body of the bit-packed or-and kernel for Hopper (sm_90a),
// bitpack_ops/csrc/bitpack_matmul.cu, its only user.
//
//   C[i, j] = (OR_w ap[i, w] AND bp[w, j]) != 0
//
// ap [M, W] and bp [W, N] are 32-bit words, row-major and contiguous: bit l
// of ap[i, w] stands for A[i, 32 w + l], bit l of bp[w, j] for B[32 w + l, j].
// Precondition: bits past the true contraction length K in the last word
// are zero in at least one operand, so the ragged K edge needs no mask.
// C [M, N] is written as bytes 0/1 with leading dimension ldc.
//
// One LOP3 instruction (acc |= a & b) covers 32 k-steps.  Each block of 256
// threads owns a 128 x 128 output tile, each thread 8 x 8 outputs held in
// registers; the contraction is staged through shared memory 8 words (256
// k) at a time, and a thread's 8 rows and 8 columns are read as two 16-byte
// loads each.  Rows past M and columns past N are read as zero words and
// never stored.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace or_and {

constexpr int TILE = 128;         // output rows and columns per block
constexpr int TW = 8;             // packed words per shared-memory stage
constexpr int PITCH = TILE + 4;   // shared row pitch in words: transposed
                                  // stores fall on distinct banks
constexpr int THREADS = 256;      // 16 x 16 threads, 8 x 8 outputs each

__global__ void __launch_bounds__(THREADS)
contract_kernel(const uint32_t* __restrict__ ap,
                const uint32_t* __restrict__ bp, uint8_t* __restrict__ c,
                int M, int N, int W, int ldc) {
  __shared__ __align__(16) uint32_t As[TW][PITCH];   // As[w][row]
  __shared__ __align__(16) uint32_t Bs[TW][PITCH];   // Bs[w][col]
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int m0 = blockIdx.y * TILE;
  const int n0 = blockIdx.x * TILE;

  uint32_t acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0u;

  for (int w0 = 0; w0 < W; w0 += TW) {
    for (int e = t; e < TILE * TW; e += THREADS) {
      const int r = e / TW, w = e % TW;
      const int gi = m0 + r, gw = w0 + w;
      As[w][r] = (gi < M && gw < W) ? ap[(size_t)gi * W + gw] : 0u;
    }
    for (int e = t; e < TILE * TW; e += THREADS) {
      const int w = e / TILE, col = e % TILE;
      const int gj = n0 + col, gw = w0 + w;
      Bs[w][col] = (gj < N && gw < W) ? bp[(size_t)gw * N + gj] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < TW; ++w) {
      const uint4 a0 = *reinterpret_cast<const uint4*>(&As[w][ty * 8]);
      const uint4 a1 = *reinterpret_cast<const uint4*>(&As[w][ty * 8 + 4]);
      const uint4 b0 = *reinterpret_cast<const uint4*>(&Bs[w][tx * 8]);
      const uint4 b1 = *reinterpret_cast<const uint4*>(&Bs[w][tx * 8 + 4]);
      const uint32_t av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const uint32_t bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] |= av[i] & bv[j];
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
      if (gj < N) c[(size_t)gi * ldc + gj] = acc[i][j] != 0u ? 1 : 0;
    }
  }
}

// Grid limits of contract_kernel: the row tiles ride gridDim.y.
inline bool contract_fits(int M) { return (M + TILE - 1) / TILE <= 65535; }

inline void launch_contract(const uint32_t* ap, const uint32_t* bp,
                            uint8_t* c, int M, int N, int W, int ldc,
                            cudaStream_t st) {
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  contract_kernel<<<grid, THREADS, 0, st>>>(ap, bp, c, M, N, W, ldc);
}

}  // namespace or_and
