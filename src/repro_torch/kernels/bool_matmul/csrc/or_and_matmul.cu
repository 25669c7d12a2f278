// Or-and (Boolean semiring) matrix product for Hopper, built for sm_90a.
//
//   C[i, j] = OR_k (A[i, k] AND B[k, j])
//
// A [M, K] and B [K, N] are torch.bool storage (one byte, 0 or 1) with any
// element strides; C [M, N] is written as bytes 0/1 with leading dimension
// ldc, into a torch.bool tensor that the caller allocates.
//
// Replaces the TPU kernel src/repro/kernels/bool_matmul/bool_matmul.py,
// function bool_matmul_pallas (body _kernel).  That kernel upcasts 0/1
// blocks to f32 so that each 128-block product rides the TPU's matrix
// unit, and thresholds the f32 sum at > 0 after the last K block.
//
// What bounds it on the card.  A squaring of the boundary closure
// (M = N = K = nb) does 2 nb^3 Boolean operations on 3 nb^2 bytes, so it is
// bound by operations; the batch compose ([N, nb] x [nb, nb] with small N)
// reads the closure once and is bound by bytes.
//
// Design.  Two passes.  The first packs A's rows and B's columns into
// 32-bit words, bit l of word w standing for k = 32 w + l; bits past K are
// zero, so the ragged contraction edge needs no padding.  The second pass
// contracts the words: one LOP3 instruction (acc |= a & b) covers 32
// k-steps, a 32-fold cut in instructions over a byte-wise loop.  Each block
// of 256 threads owns a 128 x 128 output tile, each thread 8 x 8 outputs
// held in registers; the contraction is staged through shared memory 8
// words (256 k) at a time, and a thread's 8 rows and 8 columns are read as
// two 16-byte loads each.  Rows past M and columns past N are never
// stored.  Tensor cores (int8 wgmma with an int32 accumulator), TMA and
// pipelining are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 128;         // output rows and columns per block
constexpr int TW = 8;             // packed words per shared-memory stage
constexpr int PITCH = TILE + 4;   // shared row pitch in words: transposed
                                  // stores fall on distinct banks
constexpr int THREADS = 256;      // 16 x 16 threads, 8 x 8 outputs each

// ap[i, w]: bit l = A[i, 32 w + l].  One warp per (row, word), one byte per
// lane, gathered with a ballot.
__global__ void pack_rows_kernel(const uint8_t* __restrict__ a,
                                 uint32_t* __restrict__ ap, int M, int K,
                                 int W, int s0, int s1) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (warp >= (long long)M * W) return;  // uniform across the warp
  const int i = (int)(warp / W);
  const int w = (int)(warp % W);
  const int k = w * 32 + lane;
  const bool bit = k < K && a[(size_t)i * s0 + (size_t)k * s1] != 0;
  const uint32_t word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) ap[(size_t)i * W + w] = word;
}

// bp[w, j]: bit l = B[32 w + l, j].  One thread per (word, column):
// neighbouring threads read neighbouring columns of one row.
__global__ void pack_cols_kernel(const uint8_t* __restrict__ b,
                                 uint32_t* __restrict__ bp, int K, int N,
                                 int s0, int s1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (j >= N) return;
  const int k0 = w * 32;
  const int kn = min(32, K - k0);
  uint32_t word = 0;
  for (int l = 0; l < kn; ++l)
    word |= (uint32_t)(b[(size_t)(k0 + l) * s0 + (size_t)j * s1] != 0) << l;
  bp[(size_t)w * N + j] = word;
}

__global__ void __launch_bounds__(THREADS)
or_and_kernel(const uint32_t* __restrict__ ap, const uint32_t* __restrict__ bp,
              uint8_t* __restrict__ c, int M, int N, int W, int ldc) {
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

}  // namespace

// ap [M, ceil(K/32)] and bp [ceil(K/32), N] are 32-bit scratch buffers the
// caller allocates.  Returns cudaGetLastError() after the launches.
extern "C" int or_and_matmul(const void* a, const void* b, void* c, void* ap,
                             void* bp, int M, int K, int N, int sa0, int sa1,
                             int sb0, int sb1, int ldc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const int W = (K + 31) / 32;
  if (W > 65535 || (M + TILE - 1) / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  auto* apw = static_cast<uint32_t*>(ap);
  auto* bpw = static_cast<uint32_t*>(bp);
  if (W > 0) {
    const long long warps = (long long)M * W;
    const long long blocks = (warps + THREADS / 32 - 1) / (THREADS / 32);
    pack_rows_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const uint8_t*>(a), apw, M, K, W, sa0, sa1);
    pack_cols_kernel<<<dim3((N + THREADS - 1) / THREADS, W), THREADS, 0, st>>>(
        static_cast<const uint8_t*>(b), bpw, K, N, sb0, sb1);
  }
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  or_and_kernel<<<grid, THREADS, 0, st>>>(apw, bpw, static_cast<uint8_t*>(c),
                                          M, N, W, ldc);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
