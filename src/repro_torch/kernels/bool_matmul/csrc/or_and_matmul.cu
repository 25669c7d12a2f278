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
// contracts the words with the body in or_and_contract.cuh, which
// bitpack_ops/csrc/bitpack_matmul.cu shares: one LOP3 instruction
// (acc |= a & b) covers 32 k-steps, a 32-fold cut in instructions over a
// byte-wise loop, on 128 x 128 output tiles with 8 x 8 outputs per thread.
// Tensor cores (int8 wgmma with an int32 accumulator), TMA and pipelining
// are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "or_and_contract.cuh"

namespace {

using or_and::THREADS;

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

}  // namespace

// ap [M, ceil(K/32)] and bp [ceil(K/32), N] are 32-bit scratch buffers the
// caller allocates.  Returns cudaGetLastError() after the launches.
extern "C" int or_and_matmul(const void* a, const void* b, void* c, void* ap,
                             void* bp, int M, int K, int N, int sa0, int sa1,
                             int sb0, int sb1, int ldc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const int W = (K + 31) / 32;
  if (W > 65535 || !or_and::contract_fits(M))
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
  or_and::launch_contract(apw, bpw, static_cast<uint8_t*>(c), M, N, W, ldc,
                          st);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
