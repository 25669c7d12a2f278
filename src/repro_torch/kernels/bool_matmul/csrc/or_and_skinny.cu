// Or-and (Boolean semiring) product with few rows, for Hopper (sm_90a):
// the skinny route of the or-and kernel.
//
//   C[i, j] = init[i, j] OR (OR_k (A[i, k] AND B[k, j]))
//
// A [M, K] (M <= 8), B [K, N] and the optional init [M, N] are torch.bool
// storage (one byte, 0 or 1).  B is read as it is stored, row-major: its
// base and row pitch must be multiples of 16 bytes, and its storage must
// reach the end of its last row's last 16-byte group.  The bytes of that
// group past N (the pads of padded storage) are read and masked, so they
// may hold anything.  A and init are read a byte at a time through their
// strides, so any view will do (evalDG hands over x[None, :]).  C [M, N]
// has a row pitch that is a multiple of 16 bytes and must be all zero,
// pads included, before the launch: the blocks merge into it with
// atomicOr.  Its pad bytes stay zero.
//
// Replaces, at this shape, the TPU kernel src/repro/kernels/bool_matmul/
// bool_matmul.py, function bool_matmul_pallas, as repro.core.engine.
// evaldg_reach calls it: x | or_and_matmul(x[None, :], D) with M = 1 and D
// [B, B] as stored.  The tile route (or_and_matmul.cu) takes both operands
// K-major, so that call would need D^T, a copy of D each query.
//
// What bounds it on the card: bytes.  The operations are one OR of 16
// bytes per 16 bytes of B read, far below any rate of the card.  One pass
// over B is K*N bytes: 0.077 ms for [16041]^2 and 1.920 ms for [80205]^2
// at 3.35 TB/s.  Only rows k with some A[i, k] set can change C, so a step
// whose frontier x holds few rows needs to read only those rows.
//
// Design.
//  - Streaming B: a block of 128 threads owns a strip of 2048 columns,
//    16 per thread, and a range of K.  A thread loads its 16 bytes of a
//    row of B as one 16-byte load, so a warp reads 512 contiguous bytes;
//    U row loads are issued before they are ORed.  The column group that
//    straddles N is loaded whole like the others (a byte-by-byte path
//    there diverged its warp and made the last strip the slowest) and its
//    bytes past N are masked off before the merge, so C's pads get zeros.
//    K is split over enough blocks to fill every SM's block slots once
//    (ops._route, from the occupancy that or_and_skinny_blocks_per_sm
//    reads).
//  - Skipping rows outside the frontier: a block walks its range of K in
//    chunks of 128.  Each thread reads A[:, k] for one k of the chunk; a
//    warp ballot and a prefix over the warps compact the set rows of the
//    chunk, in order, into shared memory, with their row masks.  Only
//    those rows of B are loaded.  A chunk with no set row costs one read
//    of A's bytes and no load of B; a block whose whole range is clear
//    loads nothing.  A skipped row contributes only zeros, so the result
//    is unchanged.
//  - Merge: each thread ORs into MR accumulators of 16 bytes (MR = M
//    rounded up to a power of two) and merges the words that are not zero
//    into C with atomicOr.  OR is exact and order-free, so C is the same
//    bits in every run.  The blocks of the first K range also OR in init,
//    whether or not their range had set rows, which fuses evalDG's x | ...
//
// Sizes and pitches are int; every offset into B is 64-bit, since a
// [80205]^2 operand holds 6.43e9 bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SK_THREADS = 128;              // threads a block; k's a chunk
constexpr int SK_COLS = 16;                  // columns (bytes) a thread
constexpr int SK_STRIP = SK_THREADS * SK_COLS;
constexpr int SK_WARPS = SK_THREADS / 32;
constexpr int SK_U = 8;                      // row loads in flight a thread

__device__ __forceinline__ void or_masked(uint4& acc, const uint4& v,
                                          uint32_t sel) {
  acc.x |= v.x & sel;
  acc.y |= v.y & sel;
  acc.z |= v.z & sel;
  acc.w |= v.w & sel;
}

// The bytes of a 32-bit word of a thread's column group that lie before N:
// word w covers columns 4w .. 4w+3 of the group, of which `valid` come
// before N.
__device__ __forceinline__ uint32_t word_mask(int w, int valid) {
  const int n = valid - 4 * w;
  return n >= 4 ? 0xffffffffu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

__device__ __forceinline__ void merge_word(uint8_t* c, int w, uint32_t v) {
  if (v != 0u) atomicOr(reinterpret_cast<unsigned int*>(c) + w, v);
}

// ORs the n listed rows of a chunk (offsets ks from `rows`, masks ms) into
// the accumulators: one 16-byte load a row, SK_U of them issued before they
// are used.  With one row of A every listed row is set in it, so no mask
// is read.
template <int MR>
__device__ __forceinline__ void or_rows(uint4 (&acc)[MR],
                                        const uint8_t* __restrict__ rows,
                                        int ldb, const int* ks,
                                        const uint8_t* ms, int n) {
  for (int j = 0; j < n; j += SK_U) {
    uint4 v[SK_U];
#pragma unroll
    for (int u = 0; u < SK_U; ++u)
      v[u] = j + u < n ? __ldg(reinterpret_cast<const uint4*>(
                             rows + static_cast<size_t>(ks[j + u]) * ldb))
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < SK_U; ++u) {
      if (MR == 1) {
        or_masked(acc[0], v[u], ~0u);           // zeros past the list
      } else {
        const uint32_t m = j + u < n ? ms[j + u] : 0u;
#pragma unroll
        for (int r = 0; r < MR; ++r)
          or_masked(acc[r], v[u], 0u - ((m >> r) & 1u));
      }
    }
  }
}

template <int MR>
__global__ void __launch_bounds__(SK_THREADS)
or_and_skinny_kernel(const uint8_t* __restrict__ a,
                     const uint8_t* __restrict__ b,
                     const uint8_t* __restrict__ init, uint8_t* c, int M,
                     int K, int N, int lda0, int lda1, int ldb, int ldi0,
                     int ldi1, int ldc, int kper) {
  __shared__ int ks[SK_THREADS];         // the chunk's set rows, in order
  __shared__ uint8_t ms[SK_THREADS];     // their masks: bit i = A[i, k]
  __shared__ int counts[SK_WARPS];       // set rows found by each warp
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int col = blockIdx.x * SK_STRIP + t * SK_COLS;
  const bool live = col < N;
  const int valid = min(SK_COLS, N - col);
  const long long kb = static_cast<long long>(blockIdx.y) * kper;
  const long long ke = min(static_cast<long long>(K), kb + kper);
  const uint8_t* bcol = b + (live ? col : 0);

  uint4 acc[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) acc[r] = make_uint4(0u, 0u, 0u, 0u);

  for (long long k0 = kb; k0 < ke; k0 += SK_THREADS) {
    const long long k = k0 + t;
    uint32_t m = 0u;
    if (k < ke) {
#pragma unroll
      for (int r = 0; r < MR; ++r)
        if (r < M &&
            a[static_cast<size_t>(r) * lda0 + static_cast<size_t>(k) * lda1])
          m |= 1u << r;
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, m != 0u);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, n = 0;
#pragma unroll
    for (int w = 0; w < SK_WARPS; ++w) {
      base += w < warp ? counts[w] : 0;
      n += counts[w];
    }
    if (m != 0u) {
      const int pos = base + __popc(ballot & ((1u << lane) - 1u));
      ks[pos] = static_cast<int>(k - k0);
      if (MR > 1) ms[pos] = static_cast<uint8_t>(m);
    }
    __syncthreads();
    if (live)
      or_rows<MR>(acc, bcol + static_cast<size_t>(k0) * ldb, ldb, ks, ms, n);
    __syncthreads();                     // the chunk's list is read
  }

  if (!live) return;
  if (blockIdx.y == 0 && init != nullptr) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= M) break;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      const uint8_t* p = init + static_cast<size_t>(r) * ldi0 +
                         static_cast<size_t>(col) * ldi1;
#pragma unroll
      for (int j = 0; j < SK_COLS; ++j)
        if (j < valid)
          w[j >> 2] |= static_cast<uint32_t>(p[static_cast<size_t>(j) * ldi1])
                       << (8 * (j & 3));
      or_masked(acc[r], make_uint4(w[0], w[1], w[2], w[3]), ~0u);
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r >= M) break;
    uint8_t* out = c + static_cast<size_t>(r) * ldc + col;
    merge_word(out, 0, acc[r].x & word_mask(0, valid));
    merge_word(out, 1, acc[r].y & word_mask(1, valid));
    merge_word(out, 2, acc[r].z & word_mask(2, valid));
    merge_word(out, 3, acc[r].w & word_mask(3, valid));
  }
}

template <int MR>
struct Skinny {
  static int launch(const uint8_t* a, const uint8_t* b, const uint8_t* init,
                    uint8_t* c, int M, int K, int N, int lda0, int lda1,
                    int ldb, int ldi0, int ldi1, int ldc, int split,
                    cudaStream_t s) {
    const int strips = (N + SK_STRIP - 1) / SK_STRIP;
    // whole chunks a K range, so that no block walks a short last chunk
    const long long chunks = (static_cast<long long>(K) + SK_THREADS - 1) /
                             SK_THREADS;
    const long long kper = (chunks + split - 1) / split * SK_THREADS;
    if (kper > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    or_and_skinny_kernel<MR><<<dim3(strips, split), SK_THREADS, 0, s>>>(
        a, b, init, c, M, K, N, lda0, lda1, ldb, ldi0, ldi1, ldc,
        static_cast<int>(kper));
    return (int)cudaGetLastError();
  }
  static int blocks_per_sm() {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, or_and_skinny_kernel<MR>, SK_THREADS, 0);
    return e == cudaSuccess ? n : -1;
  }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

#define SKINNY_CASES(X) X(1) X(2) X(4) X(8)

// C |= init | A (or-and) B for M <= rows (a power of two, at most 8), K cut
// into `split` ranges of whole 128-row chunks; `init` may be null.  C must
// be zero before the launch.  Returns cudaGetLastError() after the launch.
extern "C" int or_and_skinny(const void* a, const void* b, const void* init,
                             void* c, int M, int K, int N, int lda0,
                             int lda1, int ldb, int ldi0, int ldi1, int ldc,
                             int rows, int split, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || M > rows || split < 1 || split > 65535 ||
      ldc < N || (K > 0 && ldb < N))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(b) || !aligned16(c) || ldb % 16 != 0 || ldc % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const auto* A = static_cast<const uint8_t*>(a);
  const auto* B = static_cast<const uint8_t*>(b);
  const auto* I = static_cast<const uint8_t*>(init);
  auto* C = static_cast<uint8_t*>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(MR)                                                          \
  if (rows == MR)                                                           \
    return Skinny<MR>::launch(A, B, I, C, M, K, N, lda0, lda1, ldb, ldi0,   \
                              ldi1, ldc, split, s);
  SKINNY_CASES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Skinny blocks resident on one SM of the current device, -1 on error.
extern "C" int or_and_skinny_blocks_per_sm(int rows) {
#define OCCUPANCY(MR) \
  if (rows == MR) return Skinny<MR>::blocks_per_sm();
  SKINNY_CASES(OCCUPANCY)
#undef OCCUPANCY
  return -1;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
