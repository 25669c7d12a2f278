// Bit-packed or-and matrix product for Hopper, built for sm_90a.
//
//   C[i, j] = (OR_w Ap[i, w] AND Bp[w, j]) != 0
//
// Ap [M, W] holds A's rows packed into 32-bit words (bit l of Ap[i, w] is
// A[i, 32 w + l]), Bp [W, N] holds B's columns packed the same way (bit l
// of Bp[w, j] is B[32 w + l, j]); both are contiguous torch.int32 tensors
// with the uint32 bit layout, as repro_torch.kernels.bitpack_ops.pack_rows
// and pack_cols make them.  C [M, N] is written as bytes 0/1 with leading
// dimension ldc into a torch.bool tensor that the caller allocates.
//
// Precondition: W == ceil(K / 32) for the true contraction length K, and
// the bits past K in the last word are zero.  pack_rows and pack_cols
// guarantee it; the kernel does not mask them.
//
// Replaces the TPU kernel src/repro/kernels/bitpack_ops/bitpack_ops.py,
// function bitpack_matmul_pallas (body _kernel), reached through
// ops.py::bitpack_bool_matmul.  That kernel ANDs a [bm, cw] word block
// against a [cw, bn] one on the TPU's vector unit, reduces the hits over
// the words and carries an OR accumulator in VMEM from one grid step to the
// next.  Its wrapper pads M, N and W to its block sizes; here the M and N
// edges are masked instead, and no padded copy is made.
//
// What bounds it on the card.  The product does M * N * W word operations
// (one AND and one OR each, fused into one LOP3) and moves 4 M W + 4 W N +
// M N bytes.  At the sharded path's closure shape, M = N = nb = 16039 and
// W = 502, that is 1.29e11 LOP3s: at 64 int32 operations per clock per SM,
// 132 SMs and 1.98 GHz (H100 SXM data sheet) about 7.7 ms, against 0.08 ms
// for the 257 MB output at 3.35 TB/s.  So it is bound by operations.
//
// Design.  The operands arrive packed, so the kernel is the contraction
// pass of or_and_matmul.cu alone, with the same body (or_and_contract.cuh):
// one LOP3 per 32 k-steps, 128 x 128 output tiles, 8 x 8 outputs per thread
// held in registers, the words staged through shared memory 8 at a time.
// b1 tensor cores (mma with .and.popc) are left for later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "../../bool_matmul/csrc/or_and_contract.cuh"

// ap [M, W], bp [W, N] contiguous 32-bit words; c [M, N] bytes, row stride
// ldc.  Returns cudaGetLastError() after the launch.
extern "C" int bitpack_matmul(const void* ap, const void* bp, void* c, int M,
                              int W, int N, int K, int ldc, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || W != (K + 31) / 32 || ldc < N)
    return (int)cudaErrorInvalidValue;
  if (!or_and::contract_fits(M)) return (int)cudaErrorInvalidValue;
  or_and::launch_contract(static_cast<const uint32_t*>(ap),
                          static_cast<const uint32_t*>(bp),
                          static_cast<uint8_t*>(c), M, N, W, ldc,
                          static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
