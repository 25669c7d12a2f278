// Tropical (min, +) matrix product for Hopper, built for sm_90a.
//
//   C[i, j] = min(F[i, j], min_k (A[i, k] + B[k, j]), INF)   int32, INF = 1 << 29
//
// A [M, K], B [K, N] and the optional floor F [M, N] (INF when absent) are
// int32 and row-major with 16-byte rows: base and row pitch multiples of 16
// bytes, and storage up to the next multiple of four columns (the wrapper,
// ops.py, copies any other operand).  C [M, N] is written the same way.
// K = 0 gives the floor everywhere.
//
// Precondition: every entry of A, B and F lies in [0, INF].  Then every sum
// is at most 2 INF = 2^30 < 2^31 and cannot overflow; the partial minima
// start at INF and only fall, so they never exceed INF.  Every operand on
// the query path is a hop count clipped at INF.  Entries in the pad columns
// of a padded row are never used for a stored result.
//
// Replaces the TPU kernel src/repro/kernels/tropical_matmul/
// tropical_matmul.py, function tropical_matmul_pallas (body _kernel), which
// sweeps the contraction in chunks of 8 with a [bm, ck, bn] broadcast-add in
// VMEM, because the TPU's matrix unit has no (min, +) mode.
//
// What bounds it on the card.  The tensor cores have no (min, +) mode
// either; the DPX instruction __viaddmin_s32(a, b, c) = min(a + b, c) does
// one pair in one SIMT instruction.  A squaring at M = N = K = nb is nb^3
// pairs and bound by operations.  A vector-matrix step (M = 1) does one pair
// per int32 of B and is bound by reading B once.
//
// Two routes; the wrapper picks one and the K split (ops.py, _route).
//
// Tile path (min_plus_tile).  Each block of 256 threads owns a 128 x 128
// output tile, each thread 8 x 8 partial minima in registers (rows ty + 16 i,
// columns 4 tx + 64 j .. + 3, so that a warp's shared loads and global
// stores are contiguous).  The contraction runs through a ring of STAGES
// shared-memory stages of KS steps, filled by 16-byte cp.async copies issued
// STAGES - 1 stages ahead, with one barrier per stage.  A is kept row-major
// (As[row][k]) and read as int4 over 4 k-steps, B as Bs[k][col]: 16 shared
// loads of 16 bytes feed 256 DPX instructions, and no load conflicts.  The
// last stage of a ragged K is filled by plain loads that put INF past K; rows
// past M and columns past N are zero-filled and never stored.  The epilogue
// folds the floor in and stores int4s.
//
// Skinny path (min_plus_skinny), M <= 64.  A 128 x 128 tile would waste
// 127 of 128 rows at M = 1 and leave most SMs idle, so each block of 128
// threads takes a strip of 128 * CW columns (CW = 4, or 2 for 64 rows) and
// one range of K, and holds all M rows (padded to MR) in registers: one pass
// over B, one 16- or 8-byte load of a row of B per thread per k, serves every
// row.  A's slice is staged in shared memory in chunks of SK_KC steps and
// read as int4 over 4 k-steps (broadcast).  The loads of B for the next U
// steps are issued before the DPX instructions of the current U.  K is split
// over enough blocks to fill every SM's block slots once; the blocks merge
// their partial minima into C, which the wrapper filled with the floor first
// on the same stream, by atomicMin.  Min is exact and order-free, so the
// result is deterministic, and a product is still one launch.
//
// Fixpoint (min_plus_fixpoint), evalDG's whole Bellman-Ford loop in one
// cooperative launch, and settle (min_plus_settle), evalDG's answer by
// levels in one cooperative launch; their own comments are at the kernels
// below.

#include <cstdint>
#include <cuda_runtime.h>

#include "../../fixpoint.cuh"

namespace {

constexpr int INF = 1 << 29;

__device__ __forceinline__ int dpx(int a, int b, int c) {
  return __viaddmin_s32(a, b, c);
}

__device__ __forceinline__ int lane(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// tile path
// ---------------------------------------------------------------------------

constexpr int TILE = 128;                 // output rows and columns per block
constexpr int KS = 16;                    // contraction steps per stage
constexpr int STAGES = 4;                 // stages in the ring
constexpr int THREADS = 256;              // 16 x 16 threads, 8 x 8 outputs each
constexpr int A_STAGE = TILE * KS;        // As[row][k], ints
constexpr int STAGE_INTS = A_STAGE + KS * TILE;   // then Bs[k][col]
constexpr int TILE_SMEM = STAGES * STAGE_INTS * 4;  // 65536 bytes
constexpr int CHUNKS = TILE * KS / 4 / THREADS;     // 16-byte copies per
                                                    // thread per operand
static_assert(CHUNKS * THREADS * 4 == TILE * KS, "stage must split evenly");

__device__ __forceinline__ void cp_async16(int* smem, const int* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Fill one stage with A[m0:m0+128, k0:k0+KS] and B[k0:k0+KS, n0:n0+128].
__device__ __forceinline__ void load_stage(
    int* As, const int* __restrict__ a, const int* __restrict__ b, int M,
    int K, int N, int lda, int ldb, int m0, int n0, int k0, int t) {
  int* Bs = As + A_STAGE;
  if (k0 + KS <= K) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int e = t + i * THREADS;
      const int r = e / (KS / 4), q = e % (KS / 4);
      const bool ok = m0 + r < M;
      cp_async16(As + r * KS + 4 * q,
                 ok ? a + (size_t)(m0 + r) * lda + k0 + 4 * q : a, ok);
    }
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int e = t + i * THREADS;
      const int kk = e / (TILE / 4), q = e % (TILE / 4);
      const bool ok = n0 + 4 * q < N;
      cp_async16(Bs + kk * TILE + 4 * q,
                 ok ? b + (size_t)(k0 + kk) * ldb + n0 + 4 * q : b, ok);
    }
    return;
  }
  // the ragged last stage: INF past K, which no sum can undercut
  for (int i = 0; i < CHUNKS; ++i) {
    const int e = t + i * THREADS;
    const int r = e / (KS / 4), q = e % (KS / 4);
    const int gi = m0 + r;
    int v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gk = k0 + 4 * q + c;
      v[c] = (gi < M && gk < K) ? a[(size_t)gi * lda + gk] : INF;
    }
    *reinterpret_cast<int4*>(As + r * KS + 4 * q) =
        make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int i = 0; i < CHUNKS; ++i) {
    const int e = t + i * THREADS;
    const int kk = e / (TILE / 4), q = e % (TILE / 4);
    const int gj = n0 + 4 * q;
    *reinterpret_cast<int4*>(Bs + kk * TILE + 4 * q) =
        (k0 + kk < K && gj < N)
            ? *reinterpret_cast<const int4*>(b + (size_t)(k0 + kk) * ldb + gj)
            : make_int4(INF, INF, INF, INF);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
min_plus_tile_kernel(const int* __restrict__ a, const int* __restrict__ b,
                     const int* __restrict__ floor_, int* __restrict__ c,
                     int M, int K, int N, int lda, int ldb, int ldf,
                     int ldc) {
  extern __shared__ __align__(16) int smem[];
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

  const int ktiles = (K + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_stage(smem + s * STAGE_INTS, a, b, M, K, N, lda, ldb, m0, n0,
                 s * KS, t);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    // stage kt has landed for every thread, and every thread is done with
    // stage kt - 1, whose slot the next copy refills
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < ktiles)
      load_stage(smem + (pf % STAGES) * STAGE_INTS, a, b, M, K, N, lda, ldb,
                 m0, n0, pf * KS, t);
    cp_async_commit();
    const int* As = smem + (kt % STAGES) * STAGE_INTS;
    const int* Bs = As + A_STAGE;
#pragma unroll
    for (int kq = 0; kq < KS; kq += 4) {
      int4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const int4*>(As + (ty + 16 * i) * KS + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int4 b0 =
            *reinterpret_cast<const int4*>(Bs + (kq + kk) * TILE + 4 * tx);
        const int4 b1 =
            *reinterpret_cast<const int4*>(Bs + (kq + kk) * TILE + 64 + 4 * tx);
        const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int ai = lane(av[i], kk);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = dpx(ai, bv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gi = m0 + ty + 16 * i;
    if (gi >= M) break;
#pragma unroll
    for (int jq = 0; jq < 2; ++jq) {
      const int gj = n0 + 64 * jq + 4 * tx;
      if (gj >= N) continue;
      int4 v = make_int4(acc[i][4 * jq], acc[i][4 * jq + 1],
                         acc[i][4 * jq + 2], acc[i][4 * jq + 3]);
      if (floor_ != nullptr) {
        const int4 f =
            *reinterpret_cast<const int4*>(floor_ + (size_t)gi * ldf + gj);
        v = make_int4(min(v.x, f.x), min(v.y, f.y), min(v.z, f.z),
                      min(v.w, f.w));
      }
      v = make_int4(min(v.x, INF), min(v.y, INF), min(v.z, INF),
                    min(v.w, INF));
      *reinterpret_cast<int4*>(c + (size_t)gi * ldc + gj) = v;
    }
  }
}

// ---------------------------------------------------------------------------
// skinny path
// ---------------------------------------------------------------------------

constexpr int SK_THREADS = 128;           // threads per block
constexpr int SK_KC = 128;                // steps of A's slice staged at once

template <int CW> struct Vec;
template <> struct Vec<4> {
  using T = int4;
  static __device__ __forceinline__ T inf() {
    return make_int4(INF, INF, INF, INF);
  }
  static __device__ __forceinline__ int at(const T& v, int i) {
    return lane(v, i);
  }
};
template <> struct Vec<2> {
  using T = int2;
  static __device__ __forceinline__ T inf() { return make_int2(INF, INF); }
  static __device__ __forceinline__ int at(const T& v, int i) {
    return i == 0 ? v.x : v.y;
  }
};

// MR rows per thread (M padded up), CW columns per thread, U steps of B
// loaded ahead; U is a multiple of 4, the width of one read of A's slice.
// At 64 rows the 128 partial minima bound the registers, and so the blocks
// an SM holds: the register cap of 3 blocks per SM (168 a thread) keeps
// 12 warps in flight instead of 8.
template <int MR, int CW, int U>
__global__ void __launch_bounds__(SK_THREADS, MR == 64 ? 3 : 1)
min_plus_skinny_kernel(const int* __restrict__ a, const int* __restrict__ b,
                       int* __restrict__ c, int M, int K, int N, int lda,
                       int ldb, int ldc, int kper) {
  using V = Vec<CW>;
  using T = typename V::T;
  __shared__ __align__(16) int As[MR][SK_KC];   // A's slice; INF past M, K
  const int t = threadIdx.x;
  const int col = (blockIdx.x * SK_THREADS + t) * CW;
  const bool live = col < N;
  const int kb = blockIdx.y * kper;
  const int ke = min(K, kb + kper);
  const T* bcol = reinterpret_cast<const T*>(b + col);
  const int ldv = ldb / CW;                     // row pitch in T's

  int acc[MR][CW];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[r][j] = INF;

  for (int k0 = kb; k0 < ke; k0 += SK_KC) {
    const int kn = min(SK_KC, ke - k0);
    __syncthreads();                            // the last chunk is read
    for (int e = t; e < MR * SK_KC; e += SK_THREADS) {
      const int r = e / SK_KC, kk = e % SK_KC;
      As[r][kk] = (r < M && kk < kn) ? a[(size_t)r * lda + k0 + kk] : INF;
    }
    __syncthreads();
    if (!live) continue;
    T cur[U], nxt[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      cur[u] = u < kn ? __ldg(bcol + (size_t)(k0 + u) * ldv) : V::inf();
    for (int kk = 0; kk < kn; kk += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kk + U + u;
        nxt[u] = k < kn ? __ldg(bcol + (size_t)(k0 + k) * ldv) : V::inf();
      }
#pragma unroll
      for (int q = 0; q < U; q += 4) {
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const int4 av = *reinterpret_cast<const int4*>(&As[r][kk + q]);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int ar = lane(av, s);
#pragma unroll
            for (int j = 0; j < CW; ++j)
              acc[r][j] = dpx(ar, V::at(cur[q + s], j), acc[r][j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    if (r >= M) break;
#pragma unroll
    for (int j = 0; j < CW; ++j)
      // C holds the floor, at most INF: a partial minimum of INF adds nothing
      if (col + j < N && acc[r][j] < INF)
        atomicMin(c + (size_t)r * ldc + col + j, acc[r][j]);
  }
}

template <int MR, int CW>
struct Skinny {
  static constexpr int U = MR <= 8 ? 8 : 4;
  static int launch(const int* a, const int* b, int* c, int M, int K, int N,
                    int lda, int ldb, int ldc, int split, cudaStream_t s) {
    const int strips = (N + SK_THREADS * CW - 1) / (SK_THREADS * CW);
    const int kper = (K + split - 1) / split;
    min_plus_skinny_kernel<MR, CW, U>
        <<<dim3(strips, split), SK_THREADS, 0, s>>>(a, b, c, M, K, N, lda,
                                                    ldb, ldc, kper);
    return (int)cudaGetLastError();
  }
  static int blocks_per_sm() {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, min_plus_skinny_kernel<MR, CW, U>, SK_THREADS, 0);
    return e == cudaSuccess ? n : -1;
  }
};

// ---------------------------------------------------------------------------
// evalDG's whole fixpoint in one launch: min_plus_fixpoint
// ---------------------------------------------------------------------------
//
//   d_0 = d0, Delta_0 = {k : d0[k] < INF}
//   d_{t+1}[j] = min(d_t[j], min_{k in Delta_t} d_t[k] + W[k, j]),
//   Delta_{t+1} = {k : d_{t+1}[k] < d_t[k]}
//
// until Delta is empty; writes d [B] and the number of steps taken.  d0 [B]
// is int32, read an element at a time through its stride; W [B, B] is
// int32 with 16-byte rows as the product reads it.  Precondition, as for
// the product: every entry of d0 and W lies in [0, INF], so no sum
// overflows and every d_t stays in [0, INF].
//
// Replaces the TPU kernel tropical_matmul_pallas as the reference's evalDG
// runs it: one min-plus vector-matrix product a step, folded with min(d,
// ., INF), inside one jax.lax.while_loop (src/repro/core/engine.py,
// evaldg_dist).
//
// Why it is exact.  The iterates are the naive loop's, d_{t+1} = min(d_t,
// d_t (min, +) W, INF), step for step: a row k outside Delta_t has d_t[k]
// = d_{t-1}[k], and the step before already gave d_t[j] <= d_{t-1}[k] +
// W[k, j] = d_t[k] + W[k, j] for every j, so the row cannot lower d_t.
// Rows outside Delta_0 hold INF, and INF + W[k, j] >= INF changes nothing
// under the cap.  The naive loop stops after its first step that changes
// nothing, the first whose Delta comes out empty, so the steps are counted
// as the host loop counts its launches (0 when d0 is all INF).  Min is
// order-free: the result is the same in every run.
//
// What bounds it: bytes, 4 B per entry of each row of W that enters Delta
// (a row may enter again when its distance falls again), where the host
// loop read all of W at every step, plus two grid barriers and a pass over
// d a step.
//
// Design, as or_and_fixpoint's (bool_matmul/csrc/or_and_skinny.cu): a
// cooperative grid of FX_THREADS-thread blocks; a step ORs, here mins, the
// listed rows into an accumulator acc (INF where nothing fell) over
// (row range x 512-column strip) items, each thread 4 columns with
// __viaddmin_s32 on 16-byte loads of W, FX_U in flight, and the rows'
// d_t[k] staged in shared memory with their numbers; a column's minimum
// merges into acc by atomicMin only where it undercuts d_t; grid barrier;
// the fold lowers d where acc is below it, resets acc to INF there and
// lists those columns; grid barrier.

constexpr int FX_THREADS = 128;           // threads a block
constexpr int FX_CW = 4;                  // columns a thread (one int4)
constexpr int FX_STRIP = FX_THREADS * FX_CW;
constexpr int FX_U = 8;                   // row loads in flight a thread

// Appends the columns 4 g + i of the lanes i set in `fell` (bit i) to the
// list rows of length *count.  Every lane of the warp calls it.
__device__ __forceinline__ void append_lanes(uint32_t fell, long long g,
                                             int* count, int* rows) {
  int pos = fixpoint::warp_append(count, __popc(fell));
  for (uint32_t m = fell; m != 0u; m &= m - 1u)
    rows[pos++] = static_cast<int>(g * FX_CW + __ffs(m) - 1);
}

// Step 1 of both kernels: mins the listed rows rows[0, n) of W, each plus
// its d[k], into acc where they undercut d, over (row range x strip)
// items.  A chunk of a range's rows and their d[k] are staged in ks and kd
// (FX_THREADS each).  With kAtLevel, only the listed rows whose d[k] is
// `level` are staged, packed by a ballot a warp (warp totals in wsum), so
// that a stale entry of a list costs its d but not its row.  Returns the
// rows this block read in the items of strip 0, so that a grid's sum
// counts each row once.
template <bool kAtLevel>
__device__ __forceinline__ int relax_rows(const int* __restrict__ w, int ldw,
                                          const int* d, int* acc,
                                          const int* rows, int n, int N,
                                          int strips, int level, int* ks,
                                          int* kd, int* wsum) {
  const int t = threadIdx.x;
  const int4 inf4 = make_int4(INF, INF, INF, INF);
  const fixpoint::Split sp = fixpoint::split_rows(n, strips);
  const int items = sp.groups * strips;
  int read = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int col = (item % strips) * FX_STRIP + t * FX_CW;
    const int r0 = (item / strips) * sp.per;
    const int r1 = min(n, r0 + sp.per);
    const bool live = col < N;
    const int4* wcol = reinterpret_cast<const int4*>(w + (live ? col : 0));
    int c[FX_CW] = {INF, INF, INF, INF};
    for (int c0 = r0; c0 < r1; c0 += FX_THREADS) {
      int m = min(FX_THREADS, r1 - c0);
      __syncthreads();                    // the last chunk is read
      if constexpr (kAtLevel) {
        int k = 0, dk = INF;
        if (t < m) {
          k = __ldcg(rows + c0 + t);
          dk = __ldcg(d + k);
        }
        const bool keep = dk == level;
        const uint32_t ballot = __ballot_sync(0xffffffffu, keep);
        const int warp = t >> 5;
        if ((t & 31) == 0) wsum[warp] = __popc(ballot);
        __syncthreads();
        int pos = __popc(ballot & ((1u << (t & 31)) - 1u));
        m = 0;
#pragma unroll
        for (int q = 0; q < FX_THREADS / 32; ++q) {
          const int got = wsum[q];
          if (q < warp) pos += got;
          m += got;
        }
        if (keep) {
          ks[pos] = k;
          kd[pos] = dk;
        }
      } else if (t < m) {
        const int k = __ldcg(rows + c0 + t);
        ks[t] = k;
        kd[t] = __ldcg(d + k);
      }
      __syncthreads();
      if (item % strips == 0) read += m;
      if (!live) continue;
      for (int j = 0; j < m; j += FX_U) {
        int4 v[FX_U];
#pragma unroll
        for (int u = 0; u < FX_U; ++u)
          v[u] = j + u < m
                     ? __ldg(wcol + static_cast<size_t>(ks[j + u]) * ldw /
                                        FX_CW)
                     : inf4;
#pragma unroll
        for (int u = 0; u < FX_U; ++u) {
          const int dk = j + u < m ? kd[j + u] : INF;
          c[0] = dpx(dk, v[u].x, c[0]);
          c[1] = dpx(dk, v[u].y, c[1]);
          c[2] = dpx(dk, v[u].z, c[2]);
          c[3] = dpx(dk, v[u].w, c[3]);
        }
      }
    }
    if (live) {
      const int4 dv = __ldcg(reinterpret_cast<const int4*>(d + col));
#pragma unroll
      for (int i = 0; i < FX_CW; ++i)
        // lanes past N may have summed pad entries of W: never merged
        if (col + i < N && c[i] < lane(dv, i)) atomicMin(acc + col + i, c[i]);
    }
  }
  return read;
}

__global__ void __launch_bounds__(FX_THREADS)
min_plus_fixpoint_kernel(const int* __restrict__ d0, int ldd0,
                         const int* __restrict__ w, int ldw, int* d,
                         int* acc, int* rows, int* state, int N,
                         int strips) {
  __shared__ int ks[FX_THREADS];          // a chunk of a range's rows
  __shared__ int kd[FX_THREADS];          // and their d_t[k]
  const int t = threadIdx.x;
  const int wl = t & 31;           // lane in the warp
  const long long groups = (N + FX_CW - 1) / FX_CW;      // of 4 ints
  const long long stride = static_cast<long long>(gridDim.x) * FX_THREADS;
  const long long first =
      static_cast<long long>(blockIdx.x) * FX_THREADS + (t - wl);
  int4* d4 = reinterpret_cast<int4*>(d);
  int4* acc4 = reinterpret_cast<int4*>(acc);
  const int4 inf4 = make_int4(INF, INF, INF, INF);

  // d = d0 with INF pads, acc = INF, the first list = d0's finite columns
  for (long long base = first; base < groups; base += stride) {
    const long long g = base + wl;      // warp-uniform loop
    uint32_t fell = 0u;
    if (g < groups) {
      int v[FX_CW];
#pragma unroll
      for (int i = 0; i < FX_CW; ++i) {
        const long long col = g * FX_CW + i;
        v[i] = col < N ? min(d0[col * ldd0], INF) : INF;
        if (v[i] < INF) fell |= 1u << i;
      }
      d4[g] = make_int4(v[0], v[1], v[2], v[3]);
      acc4[g] = inf4;
    }
    append_lanes(fell, g, state + 1, rows);
  }
  fixpoint::grid_barrier();

  int step = 0;
  for (;;) {
    const int n = __ldcg(state + 1 + (step & 1));
    if (n == 0) break;
    int* next = state + 1 + ((step + 1) & 1);
    if (blockIdx.x == 0 && t == 0) *next = 0;

    // 1. min the listed rows, each plus its d_t[k], into acc where they
    // undercut d_t
    relax_rows<false>(w, ldw, d, acc, rows, n, N, strips, 0, ks, kd,
                      nullptr);
    fixpoint::grid_barrier();

    // 3. fold acc into d and list the columns that fell
    for (long long base = first; base < groups; base += stride) {
      const long long g = base + wl;
      uint32_t fell = 0u;
      if (g < groups) {
        const int4 av = __ldcg(acc4 + g);
        if (min(min(av.x, av.y), min(av.z, av.w)) < INF) {
          const int4 dv = __ldcg(d4 + g);
          int nd[FX_CW];
#pragma unroll
          for (int i = 0; i < FX_CW; ++i) {
            const int a = lane(av, i), o = lane(dv, i);
            nd[i] = min(a, o);
            if (a < o) fell |= 1u << i;
          }
          acc4[g] = inf4;
          d4[g] = make_int4(nd[0], nd[1], nd[2], nd[3]);
        }
      }
      append_lanes(fell, g, next, rows);
    }
    ++step;
    fixpoint::grid_barrier();
  }
  if (blockIdx.x == 0 && t == 0) state[0] = step;
}

// ---------------------------------------------------------------------------
// evalDG's answer by levels (min_plus_settle)
// ---------------------------------------------------------------------------
//
// A dist or bounded query wants one number of the fixpoint: the least d over
// the target columns, and a bounded one only whether it is at most the bound.
// min_plus_settle finds it as Dijkstra's algorithm does with integer buckets
// (Dial's): it settles d level by level, L the least finite d, then the next
// least, and so on, reads each row of W once, at the level of its final
// distance, and stops as soon as the answer is fixed.
//
// Why it is exact.  Entries of W lie in [0, INF], so a row expanded at level
// L lowers d only to L or more.  Once every row whose d is below L has been
// expanded, and the rows that fall to L (zero entries of W) have been
// expanded in turn until none falls, no expansion can lower a d below the
// least d left above L: that least value is final, and it is the next
// level.  tmin, the least d over the targets, only falls; once it is at most
// the next level it is final, and once the next level passes the bound no
// target can end at or below the bound unless tmin already is.  The answer is
// tmin where it is at most the bound, else INF: the plain fixpoint's least
// target distance, INF above the bound.  Min is order-free, and the lists
// below are sets, so the answer, the levels and the rows read are the same in
// every run.
//
// What bounds it: bytes, 4 B per entry of each row of W whose final distance
// lies below the level at which it stops, each read once; plus, a round, a
// pass over d and acc and two grid barriers.
//
// Schedule.  Rounds of an expand, a grid barrier, a fold and a grid barrier,
// over three lists whose roles rotate: E, the rows the round expands; Z, the
// columns that fell to L in the round, which the next round expands at the
// same level; X, the columns whose d is T = L + 1, gathered over a level's
// rounds for the next level.  The expand is min_plus_fixpoint's step 1
// (relax_rows), reading only the listed rows whose d is L, so that a stale
// entry costs no row.  The fold folds acc into d over the whole vector and
// lists into Z the columns that fell to L, into X those whose d is T (every
// one in a level's first round, those that fell to T after), and keeps the
// least d at or above T (the next level) and tmin.  After the round, Z not
// empty: another round at L.  Else, where the next level is T, the round
// after expands X; where it lies beyond, a round with nothing to expand (a
// scan) lists the columns whose d is the next level.  The pass that copies
// d0 into d is the first scan, for level 0.  Every block takes the decision
// after a barrier, from values no block writes before the next one, so all
// take it alike, and a level is counted only where some row's d is it.

// state: [0] the answer, [1] the levels expanded, [2] the rows of W read;
// [3, 6) the three lists' lengths; [6, 8) the next level, by the parity of
// the round that wrote it, and [8] tmin, both kept as INF - value,
// so that the zeroed state starts them at INF and atomicMax takes the least
constexpr int ST_ANSWER = 0, ST_LEVELS = 1, ST_ROWS = 2, ST_COUNT = 3,
              ST_NEXT = 6, ST_TMIN = 8;

// Lowers the least value kept at *slot (as INF - value) to the least v of
// the warp.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_min_into(int* slot, int v) {
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v < INF) atomicMax(slot, INF - v);
}

// One pass over the vector, 4 columns a thread.  kInit: d = d0 with INF pads
// and acc = INF, every column taken as fallen.  Else: d = min(d, acc) and
// acc = INF where acc is below d.  Then the columns that fell to L go to Z,
// those whose d is T (fallen, or any where `all`) to X, the least d at or
// above T to *next and the least fallen target d to *tmin.
template <bool kInit>
__device__ __forceinline__ void settle_pass(
    const int* __restrict__ d0, int ldd0, const unsigned char* __restrict__ tgt,
    int* d, int* acc, int N, int L, int T, bool all, int* zc, int* zl, int* xc,
    int* xl, int* next, int* tmin) {
  const int wl = threadIdx.x & 31;
  const long long groups = (N + FX_CW - 1) / FX_CW;
  const long long stride = static_cast<long long>(gridDim.x) * FX_THREADS;
  const long long start =
      static_cast<long long>(blockIdx.x) * FX_THREADS + (threadIdx.x - wl);
  int4* d4 = reinterpret_cast<int4*>(d);
  int4* acc4 = reinterpret_cast<int4*>(acc);
  const int4 inf4 = make_int4(INF, INF, INF, INF);
  int pmin = INF, tm = INF;
  for (long long base = start; base < groups; base += stride) {
    const long long g = base + wl;      // warp-uniform loop
    uint32_t zb = 0u, xb = 0u;
    if (g < groups) {
      int nd[FX_CW];
      uint32_t fell = 0u;
      if (kInit) {
#pragma unroll
        for (int i = 0; i < FX_CW; ++i) {
          const long long col = g * FX_CW + i;
          nd[i] = col < N ? min(d0[col * ldd0], INF) : INF;
        }
        fell = (1u << FX_CW) - 1u;
        d4[g] = make_int4(nd[0], nd[1], nd[2], nd[3]);
        acc4[g] = inf4;
      } else {
        const int4 av = __ldcg(acc4 + g);
        const int4 dv = __ldcg(d4 + g);
#pragma unroll
        for (int i = 0; i < FX_CW; ++i) {
          const int a = lane(av, i), o = lane(dv, i);
          nd[i] = min(a, o);
          if (a < o) fell |= 1u << i;
        }
        if (fell) {
          acc4[g] = inf4;
          d4[g] = make_int4(nd[0], nd[1], nd[2], nd[3]);
        }
      }
#pragma unroll
      for (int i = 0; i < FX_CW; ++i) {
        const long long col = g * FX_CW + i;
        const bool fl = (fell >> i) & 1u;
        if (col >= N) continue;
        if (!kInit && fl && nd[i] == L) zb |= 1u << i;
        if (nd[i] == T && (all || fl)) xb |= 1u << i;
        if (nd[i] >= T && nd[i] < pmin) pmin = nd[i];
        if (fl && nd[i] < tm && __ldg(tgt + col)) tm = nd[i];
      }
    }
    if (!kInit) append_lanes(zb, g, zc, zl);
    append_lanes(xb, g, xc, xl);
  }
  warp_min_into(next, pmin);
  warp_min_into(tmin, tm);
}

__global__ void __launch_bounds__(FX_THREADS)
min_plus_settle_kernel(const int* __restrict__ d0, int ldd0,
                       const int* __restrict__ w, int ldw,
                       const unsigned char* __restrict__ tgt, int bound,
                       int* d, int* acc, int* lists, int* state, int N,
                       int strips) {
  __shared__ int ks[FX_THREADS];          // a chunk of a range's rows
  __shared__ int kd[FX_THREADS];          // and their d[k]
  __shared__ int wsum[FX_THREADS / 32];   // rows at the level, a warp
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  int* count = state + ST_COUNT;
  int e = 2, z = 1, x = 0;                // the lists' roles
  int L = -1, T = 0, levels = 0, read = 0, answer = INF;
  bool all = true;

  settle_pass<true>(d0, ldd0, tgt, d, acc, N, L, T, true, count + z,
                    lists + static_cast<size_t>(z) * N, count + x,
                    lists + static_cast<size_t>(x) * N, state + ST_NEXT,
                    state + ST_TMIN);
  fixpoint::grid_barrier();

  for (int round = 0;; ++round) {
    const int nz = __ldcg(count + z);
    const int old = e;
    if (nz > 0) {                         // zero entries: level L again
      e = z;
      z = old;
      all = false;
    } else {
      const int tmin = INF - __ldcg(state + ST_TMIN);
      const int next = INF - __ldcg(state + ST_NEXT + (round & 1));
      if (tmin <= next || next > bound) {
        answer = tmin <= bound ? tmin : INF;
        break;
      }
      if (next == T) {                    // level T: expand X
        e = x;
        x = old;
        L = T;
        T = L + 1;
        ++levels;
      } else {                            // a scan lists level `next`
        e = z;
        z = old;
        T = next;
      }
      all = true;
    }
    const int n = __ldcg(count + e);
    int* next_at = state + ST_NEXT + ((round + 1) & 1);
    if (lead) {                           // no block reads either now
      count[old] = 0;
      *next_at = 0;
    }
    if (n > 0)
      read += relax_rows<true>(w, ldw, d, acc,
                               lists + static_cast<size_t>(e) * N, n, N,
                               strips, L, ks, kd, wsum);
    fixpoint::grid_barrier();
    settle_pass<false>(nullptr, 0, tgt, d, acc, N, L, T, all, count + z,
                       lists + static_cast<size_t>(z) * N, count + x,
                       lists + static_cast<size_t>(x) * N, next_at,
                       state + ST_TMIN);
    fixpoint::grid_barrier();
  }
  if (threadIdx.x == 0 && read > 0) atomicAdd(state + ST_ROWS, read);
  if (lead) {
    state[ST_ANSWER] = answer;
    state[ST_LEVELS] = levels;
  }
}

}  // namespace

// The tile path; ``floor_`` may be null (INF).  Returns cudaGetLastError()
// after the launch.
extern "C" int min_plus_tile(const void* a, const void* b, const void* floor_,
                             void* c, int M, int K, int N, int lda, int ldb,
                             int ldf, int ldc, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + TILE - 1) / TILE > 65535)
    return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in, once per device
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(min_plus_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TILE_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  min_plus_tile_kernel<<<grid, THREADS, TILE_SMEM,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(a), static_cast<const int*>(b),
      static_cast<const int*>(floor_), static_cast<int*>(c), M, K, N, lda,
      ldb, ldf, ldc);
  return (int)cudaGetLastError();
}

#define SKINNY_CASES(X)                                                     \
  X(1, 4) X(2, 4) X(4, 4) X(8, 4) X(16, 4) X(32, 4) X(64, 2)

// The skinny path: ``rows`` (a power of two >= M, at most 64) and ``cols``
// as ops._route gives them, K cut into ``split`` ranges.  C must hold the
// floor already.  Returns cudaGetLastError() after the launch.
extern "C" int min_plus_skinny(const void* a, const void* b, void* c, int M,
                               int K, int N, int lda, int ldb, int ldc,
                               int rows, int cols, int split, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || M > rows || split < 1 || split > 65535)
    return (int)cudaErrorInvalidValue;
  const int* A = static_cast<const int*>(a);
  const int* B = static_cast<const int*>(b);
  int* C = static_cast<int*>(c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(MR, CW)                                                      \
  if (rows == MR && cols == CW)                                             \
    return Skinny<MR, CW>::launch(A, B, C, M, K, N, lda, ldb, ldc, split, s);
  SKINNY_CASES(LAUNCH)
#undef LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Skinny blocks resident on one SM of the current device, -1 on error.
extern "C" int min_plus_skinny_blocks_per_sm(int rows, int cols) {
#define OCCUPANCY(MR, CW)                                                   \
  if (rows == MR && cols == CW) return Skinny<MR, CW>::blocks_per_sm();
  SKINNY_CASES(OCCUPANCY)
#undef OCCUPANCY
  return -1;
}

// evalDG's fixpoint from d0 on W [N, N] (16-byte rows) in one cooperative
// launch of `blocks` blocks: d gets the fixpoint (pitch_i32(N) ints,
// 16-byte aligned, pads INF), state[0] the steps.  acc (pitch_i32(N) ints,
// 16-byte aligned) and rows (N ints) are scratch; state (3 ints) must be
// zero before the launch.  Returns the launch's CUDA error code.
extern "C" int min_plus_fixpoint(const void* d0, int ldd0, const void* w,
                                 int ldw, void* d, void* acc, void* rows,
                                 void* state, int N, int blocks,
                                 void* stream) {
  if (N <= 0 || ldw < N || blocks < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(d) |
       reinterpret_cast<uintptr_t>(acc)) & 15u || ldw % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  const auto* D0 = static_cast<const int*>(d0);
  const auto* Wp = static_cast<const int*>(w);
  auto* Dp = static_cast<int*>(d);
  auto* A = static_cast<int*>(acc);
  auto* R = static_cast<int*>(rows);
  auto* S = static_cast<int*>(state);
  int strips = (N + FX_STRIP - 1) / FX_STRIP;
  void* args[] = {&D0, &ldd0, &Wp, &ldw, &Dp, &A, &R, &S, &N, &strips};
  return fixpoint::cooperative_launch(
      reinterpret_cast<const void*>(min_plus_fixpoint_kernel), blocks,
      FX_THREADS, args, static_cast<cudaStream_t>(stream));
}

// Fixpoint blocks resident on one SM of the current device, -1 on error.
extern "C" int min_plus_fixpoint_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, min_plus_fixpoint_kernel, FX_THREADS, 0);
  return e == cudaSuccess ? n : -1;
}

// evalDG's answer from d0 on W [N, N] (16-byte rows) for the targets tgt (N
// bytes, nonzero where a column is a target) up to `bound`, by levels, in one
// cooperative launch of `blocks` blocks: state[0] gets the least target
// distance (INF if it is none or above the bound), state[1] the levels
// expanded and state[2] the rows of W read.  d and acc (pitch_i32(N) ints
// each, 16-byte aligned) and lists (3 N ints) are scratch; state (9 ints)
// must be zero before the launch.  Returns the launch's CUDA error code.
extern "C" int min_plus_settle(const void* d0, int ldd0, const void* w,
                               int ldw, const void* tgt, int bound, void* d,
                               void* acc, void* lists, void* state, int N,
                               int blocks, void* stream) {
  if (N <= 0 || ldw < N || blocks < 1) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(d) |
       reinterpret_cast<uintptr_t>(acc)) & 15u || ldw % 4 != 0)
    return (int)cudaErrorMisalignedAddress;
  const auto* D0 = static_cast<const int*>(d0);
  const auto* Wp = static_cast<const int*>(w);
  const auto* Tg = static_cast<const unsigned char*>(tgt);
  auto* Dp = static_cast<int*>(d);
  auto* A = static_cast<int*>(acc);
  auto* Ls = static_cast<int*>(lists);
  auto* S = static_cast<int*>(state);
  int strips = (N + FX_STRIP - 1) / FX_STRIP;
  void* args[] = {&D0, &ldd0, &Wp, &ldw, &Tg, &bound, &Dp,
                  &A,  &Ls,   &S,  &N,   &strips};
  return fixpoint::cooperative_launch(
      reinterpret_cast<const void*>(min_plus_settle_kernel), blocks,
      FX_THREADS, args, static_cast<cudaStream_t>(stream));
}

// Settle blocks resident on one SM of the current device, -1 on error.
extern "C" int min_plus_settle_blocks_per_sm() {
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, min_plus_settle_kernel, FX_THREADS, 0);
  return e == cudaSuccess ? n : -1;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
