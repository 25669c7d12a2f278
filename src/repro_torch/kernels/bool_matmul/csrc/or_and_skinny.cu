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
// strides, so any view will do (x[None, :] for a vector).  C [M, N]
// has a row pitch that is a multiple of 16 bytes and must be all zero,
// pads included, before the launch: the blocks merge into it with
// atomicOr.  Its pad bytes stay zero.
//
// Replaces, for products of at most 8 rows with B as stored, the TPU kernel
// src/repro/kernels/bool_matmul/bool_matmul.py, function bool_matmul_pallas.
// The tile route (or_and_matmul.cu) takes both operands K-major, so such a
// product there would need B^T, a copy of B.  evalDG's steps (repro.core.
// engine.evaldg_reach, x | or_and_matmul(x[None, :], D) until nothing
// changes) do not launch this route: or_and_fixpoint, at the end of this
// file, runs the whole fixpoint in one launch on the same device code.
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
//    whether or not their range had set rows, which fuses a step's x | ...
//
// Sizes and pitches are int; every offset into B is 64-bit, since a
// [80205]^2 operand holds 6.43e9 bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "../../fixpoint.cuh"

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

// ---------------------------------------------------------------------------
// evalDG's whole fixpoint in one launch: or_and_fixpoint
// ---------------------------------------------------------------------------
//
//   x_0 = x0, Delta_0 = x0
//   x_{t+1} = x_t | OR_{k in Delta_t} D[k, :],  Delta_{t+1} = x_{t+1} & ~x_t
//
// until Delta is empty; writes x [B] and the number of steps taken.  x0 [B]
// is bool, read a byte at a time through its stride; D [B, B] is bool
// storage as the skinny route reads B (rows a multiple of 16 bytes apart,
// storage to the last row's last 16-byte group, the bytes past B masked).
//
// Replaces the TPU kernel bool_matmul_pallas as the reference's evalDG runs
// it: one or-and vector-matrix product a step inside one jax.lax.while_loop
// (src/repro/core/engine.py, evaldg_reach).
//
// Why it is exact.  The iterates are the naive loop's, x_{t+1} = x_t | x_t
// (or-and) D, step for step: a row k set in x_t but not in Delta_t was
// already set in x_{t-1}, so D[k] was ORed into x_t and ORing it again adds
// nothing.  The naive loop stops after its first step that changes
// nothing, which is the first step whose Delta comes out empty, so the
// steps are counted as the host loop counts its launches (0 when x0 is
// empty).  OR is order-free: the result is the same bits in every run,
// whatever order the list holds its rows in.
//
// What bounds it: bytes.  A row of D enters Delta at most once, so the whole
// fixpoint reads each row of D at most once (B^2 bytes, 0.077 ms for
// [16041]^2 at 3.35 TB/s), where the host loop read every row x held at
// every step.  Each step adds two grid barriers and a pass over x.
//
// Design.  A cooperative grid of SK_THREADS-thread blocks (ops.
// _fixpoint_route: at most the SMs times the blocks an SM holds, and no
// more than the work can use).  One step:
//  1. OR: the list of Delta's rows is cut into row ranges, each paired with
//     every 2048-column strip (fixpoint::split_rows).  A block takes items
//     in turn, stages a range's row numbers in shared memory a chunk at a
//     time, and ORs those rows' 16 bytes a thread into registers (or_rows,
//     SK_U loads in flight).  The bytes x already holds and the bytes past
//     B are masked off; what is left merges into acc with atomicOr.
//  2. Grid barrier.
//  3. Fold: each thread takes 16 bytes of acc; where they are not zero they
//     are ORed into x, cleared, and their new columns appended to the next
//     list (fixpoint::warp_append).
//  4. Grid barrier; every thread reads the next list's length and the loop
//     ends when it is 0.
// The length of the list after next is zeroed during step 1, two barriers
// after every thread last read it.  What the kernel writes is read back
// through L2 (__ldcg), never from an SM's L1; D through the read-only path.

// bytes of w that are not zero, as 1, the others 0
__device__ __forceinline__ uint32_t bytes01(uint32_t w) {
  return __vcmpne4(w, 0u) & 0x01010101u;
}

// Appends the columns of the set bytes of nv (each byte 0 or 1), which is
// the 16-byte group g of x, to the list rows of length *count.  Every lane
// of the warp calls it.
__device__ __forceinline__ void append_bytes(const uint4& nv, long long g,
                                             int* count, int* rows) {
  const uint32_t w[4] = {nv.x, nv.y, nv.z, nv.w};
  const int cnt = __popc(w[0]) + __popc(w[1]) + __popc(w[2]) + __popc(w[3]);
  int pos = fixpoint::warp_append(count, cnt);
  if (cnt == 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (uint32_t m = w[i]; m != 0u; m &= m - 1u)
      rows[pos++] = static_cast<int>(g * SK_COLS + 4 * i +
                                     ((__ffs(m) - 1) >> 3));
  }
}

__global__ void __launch_bounds__(SK_THREADS)
or_and_fixpoint_kernel(const uint8_t* __restrict__ x0, int ldx0,
                       const uint8_t* __restrict__ d, int ldd, uint8_t* x,
                       uint32_t* acc, int* rows, int* state, int N,
                       int strips) {
  __shared__ int ks[SK_THREADS];         // a chunk of a range's rows
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long groups = (N + SK_COLS - 1) / SK_COLS;  // of 16 bytes
  const long long stride = static_cast<long long>(gridDim.x) * SK_THREADS;
  const long long first =
      static_cast<long long>(blockIdx.x) * SK_THREADS + (t - lane);
  uint4* x4 = reinterpret_cast<uint4*>(x);
  uint4* acc4 = reinterpret_cast<uint4*>(acc);

  // x = x0 with zero pads, acc = 0, the first list = the columns x0 holds
  for (long long base = first; base < groups; base += stride) {
    const long long g = base + lane;     // warp-uniform loop, lanes past
    uint4 nv = make_uint4(0u, 0u, 0u, 0u);   // the end append nothing
    if (g < groups) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; j < SK_COLS; ++j) {
        const long long col = g * SK_COLS + j;
        if (col < N && x0[col * ldx0]) w[j >> 2] |= 1u << (8 * (j & 3));
      }
      nv = make_uint4(w[0], w[1], w[2], w[3]);
      x4[g] = nv;
      acc4[g] = make_uint4(0u, 0u, 0u, 0u);
    }
    append_bytes(nv, g, state + 1, rows);
  }
  fixpoint::grid_barrier();

  int step = 0;
  for (;;) {
    const int n = __ldcg(state + 1 + (step & 1));
    if (n == 0) break;
    int* next = state + 1 + ((step + 1) & 1);
    if (blockIdx.x == 0 && t == 0) *next = 0;

    // 1. OR the listed rows into acc, outside what x holds
    const fixpoint::Split sp = fixpoint::split_rows(n, strips);
    const int items = sp.groups * strips;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int col = (item % strips) * SK_STRIP + t * SK_COLS;
      const int r0 = (item / strips) * sp.per;
      const int r1 = min(n, r0 + sp.per);
      const bool live = col < N;
      uint4 a[1] = {make_uint4(0u, 0u, 0u, 0u)};
      for (int c0 = r0; c0 < r1; c0 += SK_THREADS) {
        const int m = min(SK_THREADS, r1 - c0);
        __syncthreads();                 // the last chunk is read
        if (t < m) ks[t] = __ldcg(rows + c0 + t);
        __syncthreads();
        if (live) or_rows<1>(a, d + col, ldd, ks, nullptr, m);
      }
      if (live) {
        const int valid = min(SK_COLS, N - col);
        const uint4 xo = __ldcg(reinterpret_cast<const uint4*>(x + col));
        uint8_t* out = reinterpret_cast<uint8_t*>(acc) + col;
        merge_word(out, 0, a[0].x & word_mask(0, valid) & ~xo.x);
        merge_word(out, 1, a[0].y & word_mask(1, valid) & ~xo.y);
        merge_word(out, 2, a[0].z & word_mask(2, valid) & ~xo.z);
        merge_word(out, 3, a[0].w & word_mask(3, valid) & ~xo.w);
      }
    }
    fixpoint::grid_barrier();

    // 3. fold acc into x and list the new columns
    for (long long base = first; base < groups; base += stride) {
      const long long g = base + lane;
      uint4 nv = make_uint4(0u, 0u, 0u, 0u);
      if (g < groups) {
        const uint4 av = __ldcg(acc4 + g);
        if ((av.x | av.y | av.z | av.w) != 0u) {
          acc4[g] = make_uint4(0u, 0u, 0u, 0u);
          const uint4 xo = __ldcg(x4 + g);
          nv = make_uint4(bytes01(av.x) & ~xo.x, bytes01(av.y) & ~xo.y,
                          bytes01(av.z) & ~xo.z, bytes01(av.w) & ~xo.w);
          x4[g] = make_uint4(xo.x | nv.x, xo.y | nv.y, xo.z | nv.z,
                             xo.w | nv.w);
        }
      }
      append_bytes(nv, g, next, rows);
    }
    ++step;
    fixpoint::grid_barrier();
  }
  if (blockIdx.x == 0 && t == 0) state[0] = step;
}

// Empty steps at a given grid: what a fixpoint step costs when there is
// nothing to do but read the list's length and wait at the grid barrier
// twice.  chip_smoke.py times it for the floor of an s-step fixpoint; no
// query path launches it.
__global__ void __launch_bounds__(SK_THREADS)
fixpoint_barrier_probe_kernel(const int* state, int steps) {
  for (int s = 0; s < steps; ++s) {
    if (__ldcg(state + 1 + (s & 1)) != 0) break;   // never: all zero
    fixpoint::grid_barrier();
    fixpoint::grid_barrier();
  }
}

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

// evalDG's fixpoint from x0 on D [N, N] (ldd a multiple of 16, storage to
// the last row's last 16-byte group) in one cooperative launch of `blocks`
// blocks: x gets the fixpoint (pitch(N) bytes, 16-byte aligned, pads
// zeroed), state[0] the steps.  acc (pitch(N) / 4 words, 16-byte aligned)
// and rows (N ints) are scratch; state (3 ints) must be zero before the
// launch.  Returns the launch's CUDA error code.
extern "C" int or_and_fixpoint(const void* x0, int ldx0, const void* d,
                               int ldd, void* x, void* acc, void* rows,
                               void* state, int N, int blocks,
                               void* stream) {
  if (N <= 0 || ldd < N || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(d) || !aligned16(x) || !aligned16(acc) || ldd % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const auto* X0 = static_cast<const uint8_t*>(x0);
  const auto* Dp = static_cast<const uint8_t*>(d);
  auto* X = static_cast<uint8_t*>(x);
  auto* A = static_cast<uint32_t*>(acc);
  auto* R = static_cast<int*>(rows);
  auto* S = static_cast<int*>(state);
  int strips = (N + SK_STRIP - 1) / SK_STRIP;
  void* args[] = {&X0, &ldx0, &Dp, &ldd, &X, &A, &R, &S, &N, &strips};
  return fixpoint::cooperative_launch(
      reinterpret_cast<const void*>(or_and_fixpoint_kernel), blocks,
      SK_THREADS, args, static_cast<cudaStream_t>(stream));
}

// Fixpoint blocks resident on one SM of the current device, -1 on error.
extern "C" int or_and_fixpoint_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, or_and_fixpoint_kernel, SK_THREADS, 0);
  return e == cudaSuccess ? n : -1;
}

// `steps` empty fixpoint steps on a grid of `blocks` blocks; state (3
// ints) must be zero.  Returns the launch's CUDA error code.
extern "C" int fixpoint_barrier_probe(const void* state, int blocks,
                                      int steps, void* stream) {
  if (blocks < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  const auto* S = static_cast<const int*>(state);
  void* args[] = {&S, &steps};
  return fixpoint::cooperative_launch(
      reinterpret_cast<const void*>(fixpoint_barrier_probe_kernel), blocks,
      SK_THREADS, args, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
