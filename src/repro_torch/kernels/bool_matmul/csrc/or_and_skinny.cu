// evalDG's whole single-source fixpoint over the or-and (Boolean)
// semiring in one cooperative launch, for Hopper (sm_90a): or_and_fixpoint.
//
//   x_0 = x0, Delta_0 = x0
//   x_{t+1} = x_t | OR_{k in Delta_t} D[k, :],  Delta_{t+1} = x_{t+1} & ~x_t
//
// until Delta is empty; writes x [B] and the number of steps taken.  x0 [B]
// is bool, read a byte at a time through its stride; D [B, B] is bool
// storage read as it is stored (rows a multiple of 16 bytes apart, storage
// to the last row's last 16-byte group, whose bytes past B are read and
// masked off, so the pads may hold anything).
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
// Design.  A cooperative grid of FX_THREADS-thread blocks (ops.
// _fixpoint_route: at most the SMs times the blocks an SM holds, and no
// more than the work can use).  One step:
//  1. OR: the list of Delta's rows is cut into row ranges, each paired with
//     every 2048-column strip (fixpoint::split_rows).  A block takes items
//     in turn, stages a range's row numbers in shared memory a chunk at a
//     time, and ORs those rows' 16 bytes a thread into registers (or_rows,
//     FX_U loads in flight).  The bytes x already holds and the bytes past
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
// Sizes and pitches are int; every offset into D is 64-bit, since a
// [80205]^2 operand holds 6.43e9 bytes.
//
// The file also holds the grid-barrier probe that chip_smoke.py times;
// its library keeps the name or_and_skinny, by which bench/harness.py
// builds it.

#include <cstdint>
#include <cuda_runtime.h>

#include "../../fixpoint.cuh"

namespace {

constexpr int FX_THREADS = 128;              // threads a block
constexpr int FX_COLS = 16;                  // columns (bytes) a thread
constexpr int FX_STRIP = FX_THREADS * FX_COLS;
constexpr int FX_U = 8;                      // row loads in flight a thread

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

// ORs the n listed rows of a chunk (offsets ks from `rows`) into the
// accumulator: one 16-byte load a row, FX_U of them issued before they are
// used.
__device__ __forceinline__ void or_rows(uint4& acc,
                                        const uint8_t* __restrict__ rows,
                                        int ldb, const int* ks, int n) {
  for (int j = 0; j < n; j += FX_U) {
    uint4 v[FX_U];
#pragma unroll
    for (int u = 0; u < FX_U; ++u)
      v[u] = j + u < n ? __ldg(reinterpret_cast<const uint4*>(
                             rows + static_cast<size_t>(ks[j + u]) * ldb))
                       : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int u = 0; u < FX_U; ++u) {     // zeros past the list
      acc.x |= v[u].x;
      acc.y |= v[u].y;
      acc.z |= v[u].z;
      acc.w |= v[u].w;
    }
  }
}

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
      rows[pos++] = static_cast<int>(g * FX_COLS + 4 * i +
                                     ((__ffs(m) - 1) >> 3));
  }
}

__global__ void __launch_bounds__(FX_THREADS)
or_and_fixpoint_kernel(const uint8_t* __restrict__ x0, int ldx0,
                       const uint8_t* __restrict__ d, int ldd, uint8_t* x,
                       uint32_t* acc, int* rows, int* state, int N,
                       int strips) {
  __shared__ int ks[FX_THREADS];         // a chunk of a range's rows
  const int t = threadIdx.x;
  const int lane = t & 31;
  const long long groups = (N + FX_COLS - 1) / FX_COLS;  // of 16 bytes
  const long long stride = static_cast<long long>(gridDim.x) * FX_THREADS;
  const long long first =
      static_cast<long long>(blockIdx.x) * FX_THREADS + (t - lane);
  uint4* x4 = reinterpret_cast<uint4*>(x);
  uint4* acc4 = reinterpret_cast<uint4*>(acc);

  // x = x0 with zero pads, acc = 0, the first list = the columns x0 holds
  for (long long base = first; base < groups; base += stride) {
    const long long g = base + lane;     // warp-uniform loop, lanes past
    uint4 nv = make_uint4(0u, 0u, 0u, 0u);   // the end append nothing
    if (g < groups) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int j = 0; j < FX_COLS; ++j) {
        const long long col = g * FX_COLS + j;
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
      const int col = (item % strips) * FX_STRIP + t * FX_COLS;
      const int r0 = (item / strips) * sp.per;
      const int r1 = min(n, r0 + sp.per);
      const bool live = col < N;
      uint4 a = make_uint4(0u, 0u, 0u, 0u);
      for (int c0 = r0; c0 < r1; c0 += FX_THREADS) {
        const int m = min(FX_THREADS, r1 - c0);
        __syncthreads();                 // the last chunk is read
        if (t < m) ks[t] = __ldcg(rows + c0 + t);
        __syncthreads();
        if (live) or_rows(a, d + col, ldd, ks, m);
      }
      if (live) {
        const int valid = min(FX_COLS, N - col);
        const uint4 xo = __ldcg(reinterpret_cast<const uint4*>(x + col));
        uint8_t* out = reinterpret_cast<uint8_t*>(acc) + col;
        merge_word(out, 0, a.x & word_mask(0, valid) & ~xo.x);
        merge_word(out, 1, a.y & word_mask(1, valid) & ~xo.y);
        merge_word(out, 2, a.z & word_mask(2, valid) & ~xo.z);
        merge_word(out, 3, a.w & word_mask(3, valid) & ~xo.w);
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
__global__ void __launch_bounds__(FX_THREADS)
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
  int strips = (N + FX_STRIP - 1) / FX_STRIP;
  void* args[] = {&X0, &ldx0, &Dp, &ldd, &X, &A, &R, &S, &N, &strips};
  return fixpoint::cooperative_launch(
      reinterpret_cast<const void*>(or_and_fixpoint_kernel), blocks,
      FX_THREADS, args, static_cast<cudaStream_t>(stream));
}

// Fixpoint blocks resident on one SM of the current device, -1 on error.
extern "C" int or_and_fixpoint_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, or_and_fixpoint_kernel, FX_THREADS, 0);
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
      FX_THREADS, args, static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
