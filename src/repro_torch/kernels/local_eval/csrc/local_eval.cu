// localEval of the one-shot algorithms for Hopper (sm_90a): every owned
// source row of the dependency matrix, computed by a local BFS on chip and
// written into the caller's matrix in place.
//
//   reach (D, bool):  D[row(f, j), c] = 1 iff source j of fragment f
//                     reaches slot col(f, c) inside f;
//   dist  (W, int32): W[row(f, j), c] = the hop distance from source j to
//                     slot col(f, c) inside f, INF where it is not reached
//                     or lies beyond `cap` (a node within the cap is
//                     reached only through nodes within it, as
//                     core.engine._propagate_dist(cap=) keeps it).
//
// Inputs, int32 and row-major: the edge lists esrc / edst [F, E] (local
// slots, pad edges self-loop on the pad slot n_max), the sources
// src_local / src_row [F, S] (a row of B or more is dropped), the target
// slots tgt_local [F, ldt] (columns 0..B-3), and s_local / t_local [F].
// The last source slot of each fragment is the query source s: slot
// s_local[f], row B-2 where s lies in f (s_local[f] < n_max) and dropped
// elsewhere.  Column B-2 (s) reads the pad, column B-1 (t) reads
// t_local[f], and the pad slot is never reached, so its columns get 0 or
// INF.  Rows that no source of these F fragments owns (the t row, spare
// boundary rows, the rows of another rank's fragments) get 0 or INF
// throughout.  Every row is written over its whole pitch, so the pads of
// padded storage hold 0 or INF too.
//
// Replaces no TPU kernel: the JAX package's localEval
// (src/repro/core/engine.py, local_eval_reach / local_eval_dist) is jnp
// gather and scatter, and the port's plain version is a dense fixpoint of
// gathers and scatters over [F, S, n_max+1] stepped from the host, then a
// gather of the [r, B] row block and its copy into D or W
// (core.engine._propagate_*, kept as the CPU path and the card tests'
// yardstick).  This kernel does that work in one launch with no host sync.
//
// What bounds it on the card: the stores of D or W.  The local work is
// small (at n = 32768, k = 16 a source reaches about 6 local slots, at a
// depth of at most 5), but every owned row must be written once in full:
// 32038 rows of 32040 bytes (1.03 GB, 0.31 ms at 3.35 TB/s) for D and of
// 32040 int32 (4.11 GB, 1.23 ms) for W.
//
// Design.
//  - One persistent block of 1024 threads an SM walks a contiguous range
//    of batches; a batch is 32 sources of one fragment, one bit each of a
//    32-bit word, so one BFS serves 32 rows.
//  - The fragment's edges are loaded into shared memory once for all its
//    batches, beside three words a slot: V (the sources that reached the
//    slot) and two frontiers.  A level is one pass over the edges: an
//    edge u -> v with frontier bits w at u ORs w into V[v] with atomicOr;
//    the bits it newly set are the sources first reaching v at this
//    level, so they enter the next frontier and, for dist, their level is
//    written to a per-block scratch of 32 words a slot (read back only
//    where V has the bit).  Levels stop when a pass sets nothing or at
//    the cap.  The deepest level a batch takes, plus one, is merged into
//    `steps` with atomicMax when asked: the steps the plain loop counts.
//    Where the edges do not fit beside the state they are read through L2
//    from the inputs; where the state does not fit either it lives in a
//    per-block scratch in device memory.
//  - The batch's rows are then written, stream then patch.  Warp j
//    streams row j as the semiring zero over its whole pitch, 16 bytes a
//    lane and 512 contiguous bytes a warp at a time, with no lookup and no
//    load between the stores.  After a barrier the block reads the slot of
//    every column once (eight column-map loads in flight a thread) and,
//    for each source bit of V there (about 5 columns a row at this size),
//    stores 1 or the distance over the zero.  Streaming whole rows reached
//    1.43 ms for W where 32 rows written side by side, with a lookup each,
//    took 1.64 ms (the stores alone, H100, this size; a memset of the same
//    storage 1.25 ms).  Nothing but the rows is stored: no [r, B] block,
//    no assembly copy, no full fill.
//  - Each block also writes the rows no source owns in its share of
//    [0, B), found from a bitmap it builds of the owned rows.
//
// The row-list route (local_eval_lists_kernel, dist and bounded queries).
// Replaces no TPU kernel either: it was added because W is almost all INF
// (160,774 finite entries of 1.03e9 at n = 32768, k = 16: about 5 a row,
// at most 44), so the stores of the dense route write 4.1 GB to say
// nothing.  The same batches and the same BFS; then the block scans the
// column map once, as the patch does, and appends each reached (column,
// distance) pair to its row's list, [B, 64] int2 with a count a row, by
// an atomicAdd in shared memory a pair.  Rows that no source owns keep the
// count 0 they held before the launch: nothing else is written.  A row of
// more than 64 entries, or a distance of 64 or more (the settle kernel's
// ring of levels, tropical_matmul.ops.RING), is never cut silently: the
// block ORs a flag into meta[0], and the caller answers on the dense
// route.  What bounds it: the BFS's passes over the edges and the column
// lookups, a batch each, and no longer the stores (the pairs are 1.3 MB at
// that size).  Measured on an H100 at that size: 0.18 ms a dist query
// (0.17 bounded at 6), where the dense route takes 1.68 and the bytes
// alone would take 0.0014.
//
// Sizes and pitches are int; offsets into the output are 64-bit (W at
// this size holds 1.03e9 entries).

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int LE_THREADS = 1024;
constexpr int LE_BATCH = 32;            // sources a batch: a word's bits
constexpr int LE_WINDOW = 32768;        // rows of the ownership bitmap a pass
constexpr int LE_INF = 1 << 29;         // core.engine.INF
constexpr int LE_ILP = 8;               // column-map loads a thread issues
constexpr int LE_ROW_CAP = 64;          // tropical_matmul.ops.ROW_CAP
constexpr int LE_RING = 64;             // tropical_matmul.ops.RING
constexpr int LE_OVER_ROW = 1;          // a row with more than LE_ROW_CAP
constexpr int LE_OVER_HOPS = 2;         // a distance of LE_RING or more

struct Args {
  const int* esrc;
  const int* edst;
  const int* src_local;
  const int* src_row;
  const int* tgt_local;
  const int* s_local;
  const int* t_local;
  void* out;
  uint32_t* state_ws;   // 3 (n_max + 1) words a block, where not shared
  int* dist_ws;         // 32 (n_max + 1) ints a block, dist only
  int* steps;           // atomicMax of a batch's levels + 1, or null
  long long ldo;        // out's row pitch, in elements
  int ldt;              // tgt_local's row pitch, in elements
  int F, S, E, B, n_max, cap;
  int state_shared, edges_shared;
};

__device__ __forceinline__ bool in_range(int x, int n) {
  return static_cast<unsigned>(x) < static_cast<unsigned>(n);
}

// Local slot of source j of fragment f (the last slot is s).
__device__ __forceinline__ int source_slot(const Args& a, int f, int j) {
  return j == a.S - 1 ? a.s_local[f] : a.src_local[(size_t)f * a.S + j];
}

// Dependency-matrix row of source j of fragment f; B or more is dropped.
__device__ __forceinline__ int source_row(const Args& a, int f, int j) {
  if (j == a.S - 1) return in_range(a.s_local[f], a.n_max) ? a.B - 2 : a.B;
  return a.src_row[(size_t)f * a.S + j];
}

// Local slot that column c of fragment f reads (n_max: nothing).
__device__ __forceinline__ int column_slot(const Args& a, int f, int c) {
  if (c < a.B - 2) return a.tgt_local[(size_t)f * a.ldt + c];
  return c == a.B - 2 ? a.n_max : a.t_local[f];
}

template <bool DIST>
using Elem = typename std::conditional<DIST, int, uint8_t>::type;

// Row r of `out`, pads included, set to the semiring zero (0 or INF) by
// `n` threads of which this is thread `i`, 16 bytes a thread at a time.
template <bool DIST>
__device__ void zero_row(const Args& a, int r, int i, int n) {
  const uint4 z = DIST ? make_uint4(LE_INF, LE_INF, LE_INF, LE_INF)
                       : make_uint4(0, 0, 0, 0);
  auto* row = reinterpret_cast<uint4*>(static_cast<Elem<DIST>*>(a.out) +
                                       (size_t)r * a.ldo);
  const long long groups = a.ldo * (long long)sizeof(Elem<DIST>) / 16;
  for (long long q = i; q < groups; q += n) row[q] = z;
}

// The rows of this block's share of [0, B) that no source owns.
template <bool DIST>
__device__ void zero_unowned_rows(const Args& a, uint32_t* owned) {
  const long long lo = (long long)a.B * blockIdx.x / gridDim.x;
  const long long hi = (long long)a.B * (blockIdx.x + 1) / gridDim.x;
  for (long long w0 = lo; w0 < hi; w0 += LE_WINDOW) {
    const int n = (int)min((long long)LE_WINDOW, hi - w0);
    for (int i = threadIdx.x; i < LE_WINDOW / 32; i += blockDim.x)
      owned[i] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < a.F * a.S; i += blockDim.x) {
      const long long r = source_row(a, i / a.S, i % a.S);
      if (r >= w0 && r < w0 + n && r < a.B)
        atomicOr(&owned[(r - w0) >> 5], 1u << ((r - w0) & 31));
    }
    __syncthreads();
    for (int i = 0; i < n; ++i)
      if (!(owned[i >> 5] >> (i & 31) & 1u))
        zero_row<DIST>(a, (int)(w0 + i), threadIdx.x, blockDim.x);
    __syncthreads();
  }
}

// Stores the reached columns of the batch's rows over their zeros: V[slot]
// holds the batch's sources that reached slot, dws[slot * 32 + j] source
// j's distance where it did.  Every thread reads LE_ILP column slots at a
// time.
template <bool DIST>
__device__ void patch_rows(const Args& a, int f, const uint32_t* V,
                           const int* dws, const int* rows) {
  auto* out = static_cast<Elem<DIST>*>(a.out);
  const int step = blockDim.x * LE_ILP;
  for (int c0 = threadIdx.x; c0 < a.B; c0 += step) {
    int slot[LE_ILP];
#pragma unroll
    for (int i = 0; i < LE_ILP; ++i) {
      const int c = c0 + i * blockDim.x;
      slot[i] = c < a.B ? column_slot(a, f, c) : a.n_max;
    }
#pragma unroll
    for (int i = 0; i < LE_ILP; ++i) {
      if (!in_range(slot[i], a.n_max)) continue;
      const int c = c0 + i * blockDim.x;
      for (uint32_t bits = V[slot[i]]; bits; bits &= bits - 1) {
        const int j = __ffs(bits) - 1;
        if (!in_range(rows[j], a.B)) continue;
        out[(size_t)rows[j] * a.ldo + c] =
            DIST ? dws[(size_t)slot[i] * 32 + j] : 1;
      }
    }
  }
}

// The BFS of one batch, the sources j0 .. j0 + 31 of fragment f (bit j of
// a word is source j0 + j) over the edges es / ed: V[slot] gathers the
// sources that reach slot, and for dist dws[slot * 32 + j] their level.
// V (three words a slot: the reached, the level's new and the next
// level's) must be zero.  local_eval_kernel runs the same steps written
// inline: moved into this function they compiled to other instructions
// there (H100 build, cuobjdump -sass), and that kernel stays as measured.
template <bool DIST>
__device__ __forceinline__ void batch_bfs(const Args& a, int f, int j0,
                                          const int* es, const int* ed,
                                          uint32_t* V, int* dws) {
  const int n1 = a.n_max + 1;
  const int tid = threadIdx.x;
  // level 0: the sources themselves; cur holds a level's new bits,
  // nxt gathers the next level's
  uint32_t* cur = V + n1;
  uint32_t* nxt = V + 2 * n1;
  bool seeded = false;
  if (tid < LE_BATCH && j0 + tid < a.S && a.cap >= 0) {
    const int s = source_slot(a, f, j0 + tid);
    if (in_range(s, a.n_max)) {
      atomicOr(&V[s], 1u << tid);
      atomicOr(&cur[s], 1u << tid);
      if (DIST) dws[(size_t)s * 32 + tid] = 0;
      seeded = true;
    }
  }
  int level = 0;
  if (__syncthreads_or(seeded)) {
    while (level < a.cap) {
      bool grew = false;
      for (int e = tid; e < a.E; e += blockDim.x) {
        const int u = es[e];
        if (!in_range(u, n1)) continue;
        const uint32_t bits = cur[u];
        if (!bits) continue;
        const int v = ed[e];
        if (!in_range(v, n1)) continue;
        uint32_t fresh = bits & ~atomicOr(&V[v], bits);
        if (!fresh) continue;
        atomicOr(&nxt[v], fresh);
        grew = true;
        if (DIST) {
          for (; fresh; fresh &= fresh - 1)
            dws[(size_t)v * 32 + (__ffs(fresh) - 1)] = level + 1;
        }
      }
      if (!__syncthreads_or(grew)) break;
      for (int i = tid; i < n1; i += blockDim.x) cur[i] = 0;
      uint32_t* swap = cur;
      cur = nxt;
      nxt = swap;
      ++level;
      __syncthreads();
    }
    if (a.steps && tid == 0) atomicMax(a.steps, level + 1);
  }
}

template <bool DIST>
__global__ void __launch_bounds__(LE_THREADS, 1)
    local_eval_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t owned[LE_WINDOW / 32];
  __shared__ int rows[LE_BATCH];
  const int n1 = a.n_max + 1;
  const int tid = threadIdx.x;

  zero_unowned_rows<DIST>(a, owned);

  uint32_t* V = a.state_shared
                    ? reinterpret_cast<uint32_t*>(smem)
                    : a.state_ws + (size_t)blockIdx.x * 3 * n1;
  int* es_shared = reinterpret_cast<int*>(
      smem + (a.state_shared ? (size_t)3 * n1 * sizeof(uint32_t) : 0));
  int* ed_shared = es_shared + a.E;
  int* dws = DIST ? a.dist_ws + (size_t)blockIdx.x * 32 * n1 : nullptr;

  const int batches = (a.S + LE_BATCH - 1) / LE_BATCH;
  const long long work = (long long)a.F * batches;
  const long long w_lo = work * blockIdx.x / gridDim.x;
  const long long w_hi = work * (blockIdx.x + 1) / gridDim.x;
  int loaded = -1;
  for (long long w = w_lo; w < w_hi; ++w) {
    const int f = (int)(w / batches);
    const int j0 = (int)(w % batches) * LE_BATCH;
    const int* es = a.esrc + (size_t)f * a.E;
    const int* ed = a.edst + (size_t)f * a.E;
    if (a.edges_shared) {
      if (f != loaded) {
        for (int e = tid; e < a.E; e += blockDim.x) {
          es_shared[e] = es[e];
          ed_shared[e] = ed[e];
        }
        loaded = f;
      }
      es = es_shared;
      ed = ed_shared;
    }
    for (int i = tid; i < 3 * n1; i += blockDim.x) V[i] = 0;
    if (tid < LE_BATCH)
      rows[tid] = j0 + tid < a.S ? source_row(a, f, j0 + tid) : a.B;
    __syncthreads();

    // level 0: the sources themselves; cur holds a level's new bits,
    // nxt gathers the next level's
    uint32_t* cur = V + n1;
    uint32_t* nxt = V + 2 * n1;
    bool seeded = false;
    if (tid < LE_BATCH && j0 + tid < a.S && a.cap >= 0) {
      const int s = source_slot(a, f, j0 + tid);
      if (in_range(s, a.n_max)) {
        atomicOr(&V[s], 1u << tid);
        atomicOr(&cur[s], 1u << tid);
        if (DIST) dws[(size_t)s * 32 + tid] = 0;
        seeded = true;
      }
    }
    int level = 0;
    if (__syncthreads_or(seeded)) {
      while (level < a.cap) {
        bool grew = false;
        for (int e = tid; e < a.E; e += blockDim.x) {
          const int u = es[e];
          if (!in_range(u, n1)) continue;
          const uint32_t bits = cur[u];
          if (!bits) continue;
          const int v = ed[e];
          if (!in_range(v, n1)) continue;
          uint32_t fresh = bits & ~atomicOr(&V[v], bits);
          if (!fresh) continue;
          atomicOr(&nxt[v], fresh);
          grew = true;
          if (DIST) {
            for (; fresh; fresh &= fresh - 1)
              dws[(size_t)v * 32 + (__ffs(fresh) - 1)] = level + 1;
          }
        }
        if (!__syncthreads_or(grew)) break;
        for (int i = tid; i < n1; i += blockDim.x) cur[i] = 0;
        uint32_t* swap = cur;
        cur = nxt;
        nxt = swap;
        ++level;
        __syncthreads();
      }
      if (a.steps && tid == 0) atomicMax(a.steps, level + 1);
    }
    // warp j streams row j, then the block patches every row
    const int j = tid >> 5;
    if (j < LE_BATCH && in_range(rows[j], a.B))
      zero_row<DIST>(a, rows[j], tid & 31, 32);
    __syncthreads();     // the zeros land before the reached columns
    patch_rows<DIST>(a, f, V, dws, rows);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the row-list route (dist): W as lists of its finite entries
// ---------------------------------------------------------------------------

// Where the row lists live: pairs [B, LE_ROW_CAP] of (column, distance),
// count [B] (zero before the launch: rows no source owns keep it) and meta
// (zero before the launch): meta[0] the overflow flags, meta[1] the pairs
// stored.
struct Lists {
  int2* pairs;
  int* count;
  int* meta;
};

// Appends each reached column of the batch's rows to its row's list:
// fill[j] counts row j's entries (the pairs past LE_ROW_CAP are not
// stored), *flags gathers LE_OVER_HOPS for a distance the settle kernel's
// ring cannot hold.  The column map is read as patch_rows reads it.
__device__ void list_rows(const Args& a, const Lists& l, int f,
                          const uint32_t* V, const int* dws, const int* rows,
                          int* fill, int* flags) {
  const int step = blockDim.x * LE_ILP;
  for (int c0 = threadIdx.x; c0 < a.B; c0 += step) {
    int slot[LE_ILP];
#pragma unroll
    for (int i = 0; i < LE_ILP; ++i) {
      const int c = c0 + i * blockDim.x;
      slot[i] = c < a.B ? column_slot(a, f, c) : a.n_max;
    }
#pragma unroll
    for (int i = 0; i < LE_ILP; ++i) {
      if (!in_range(slot[i], a.n_max)) continue;
      const int c = c0 + i * blockDim.x;
      for (uint32_t bits = V[slot[i]]; bits; bits &= bits - 1) {
        const int j = __ffs(bits) - 1;
        if (!in_range(rows[j], a.B)) continue;
        const int dist = dws[(size_t)slot[i] * 32 + j];
        if (dist >= LE_RING) atomicOr(flags, LE_OVER_HOPS);
        const int pos = atomicAdd(&fill[j], 1);
        if (pos < LE_ROW_CAP)
          l.pairs[(size_t)rows[j] * LE_ROW_CAP + pos] = make_int2(c, dist);
      }
    }
  }
}

// The dist BFS of local_eval_kernel<true>, each owned row then stored as
// the list of its reached columns: no semiring zero is written anywhere.
__global__ void __launch_bounds__(LE_THREADS, 1)
    local_eval_lists_kernel(const Args a, const Lists l) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows[LE_BATCH];
  __shared__ int fill[LE_BATCH];
  __shared__ int flags;
  const int n1 = a.n_max + 1;
  const int tid = threadIdx.x;
  if (tid == 0) flags = 0;
  int stored = 0;          // pairs this block stored (warp 0)

  uint32_t* V = a.state_shared
                    ? reinterpret_cast<uint32_t*>(smem)
                    : a.state_ws + (size_t)blockIdx.x * 3 * n1;
  int* es_shared = reinterpret_cast<int*>(
      smem + (a.state_shared ? (size_t)3 * n1 * sizeof(uint32_t) : 0));
  int* ed_shared = es_shared + a.E;
  int* dws = a.dist_ws + (size_t)blockIdx.x * 32 * n1;

  const int batches = (a.S + LE_BATCH - 1) / LE_BATCH;
  const long long work = (long long)a.F * batches;
  const long long w_lo = work * blockIdx.x / gridDim.x;
  const long long w_hi = work * (blockIdx.x + 1) / gridDim.x;
  int loaded = -1;
  for (long long w = w_lo; w < w_hi; ++w) {
    const int f = (int)(w / batches);
    const int j0 = (int)(w % batches) * LE_BATCH;
    const int* es = a.esrc + (size_t)f * a.E;
    const int* ed = a.edst + (size_t)f * a.E;
    if (a.edges_shared) {
      if (f != loaded) {
        for (int e = tid; e < a.E; e += blockDim.x) {
          es_shared[e] = es[e];
          ed_shared[e] = ed[e];
        }
        loaded = f;
      }
      es = es_shared;
      ed = ed_shared;
    }
    for (int i = tid; i < 3 * n1; i += blockDim.x) V[i] = 0;
    if (tid < LE_BATCH) {
      rows[tid] = j0 + tid < a.S ? source_row(a, f, j0 + tid) : a.B;
      fill[tid] = 0;
    }
    __syncthreads();
    batch_bfs<true>(a, f, j0, es, ed, V, dws);
    list_rows(a, l, f, V, dws, rows, fill, &flags);
    __syncthreads();
    if (tid < LE_BATCH) {
      int n = 0;
      if (in_range(rows[tid], a.B)) {
        n = fill[tid];
        if (n > LE_ROW_CAP) atomicOr(&flags, LE_OVER_ROW);
        n = min(n, LE_ROW_CAP);
        l.count[rows[tid]] = n;
      }
      stored += __reduce_add_sync(0xffffffffu, n);
    }
    __syncthreads();     // fill, rows and V are read before the next batch
  }
  if (tid == 0) {
    if (stored) atomicAdd(l.meta + 1, stored);
    if (flags) atomicOr(l.meta, flags);
  }
}

template <bool DIST>
int launch(const Args& a, int smem, int blocks, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      local_eval_kernel<DIST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  local_eval_kernel<DIST><<<blocks, LE_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_lists(const Args& a, const Lists& l, int smem, int blocks,
                 cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      local_eval_lists_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  local_eval_lists_kernel<<<blocks, LE_THREADS, smem, stream>>>(a, l);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's one launch: `mode` 0 writes D (bool), 1 writes W (int32),
// 2 writes W's row lists (local_eval_lists_kernel): `out` then holds the
// pairs, [B, 64] int2, and `count` ([B] ints) and `meta` (2 ints) must be
// zero before the launch; `ldo` is unused.  For modes 0 and 1, out's base
// and row pitch must be multiples of 16 bytes.  state_ws (3 (n_max+1)
// words a block) is needed unless state_shared; dist_ws (32 (n_max+1) ints
// a block) for modes 1 and 2; steps (one int, 0 before the launch) is
// optional.  `smem` is the dynamic shared memory: 12 (n_max+1) bytes if
// state_shared, then 8 E bytes if edges_shared.  Returns the launch's CUDA
// error code.
extern "C" int local_eval(int mode, const void* esrc, const void* edst,
                          const void* src_local, const void* src_row,
                          const void* tgt_local, int ldt,
                          const void* s_local, const void* t_local,
                          void* out, long long ldo, void* count, void* meta,
                          void* state_ws, void* dist_ws, void* steps, int F,
                          int S, int E, int B, int n_max, int cap,
                          int state_shared, int edges_shared, int smem,
                          int blocks, void* stream) {
  const bool lists = mode == 2;
  if (mode < 0 || mode > 2 || F < 0 || S < 1 || E < 0 || B < 2 ||
      n_max < 0 || ldt < B || (!lists && ldo < B) || blocks < 1 || smem < 0)
    return (int)cudaErrorInvalidValue;
  const size_t elem = mode ? 4 : 1;
  if (!lists && (reinterpret_cast<uintptr_t>(out) % 16 || (ldo * elem) % 16))
    return (int)cudaErrorMisalignedAddress;
  if ((!state_shared && !state_ws) || (mode && !dist_ws) ||
      (lists && (!count || !meta)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.esrc = static_cast<const int*>(esrc);
  a.edst = static_cast<const int*>(edst);
  a.src_local = static_cast<const int*>(src_local);
  a.src_row = static_cast<const int*>(src_row);
  a.tgt_local = static_cast<const int*>(tgt_local);
  a.s_local = static_cast<const int*>(s_local);
  a.t_local = static_cast<const int*>(t_local);
  a.out = out;
  a.state_ws = static_cast<uint32_t*>(state_ws);
  a.dist_ws = static_cast<int*>(dist_ws);
  a.steps = static_cast<int*>(steps);
  a.ldo = lists ? LE_ROW_CAP : ldo;
  a.ldt = ldt;
  a.F = F;
  a.S = S;
  a.E = E;
  a.B = B;
  a.n_max = n_max;
  a.cap = cap;
  a.state_shared = state_shared;
  a.edges_shared = edges_shared;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lists) {
    const Lists l{static_cast<int2*>(out), static_cast<int*>(count),
                  static_cast<int*>(meta)};
    return launch_lists(a, l, smem, blocks, s);
  }
  return mode ? launch<true>(a, smem, blocks, s)
              : launch<false>(a, smem, blocks, s);
}

// The most dynamic shared memory a block of either kernel may ask for on
// the current device (local_eval_kernel<true> holds the most static shared
// memory), -1 on error.
extern "C" int local_eval_smem_limit() {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, local_eval_kernel<true>) != cudaSuccess)
    return -1;
  return optin - (int)attr.sharedSizeBytes;
}

// Blocks of the kernel of `mode` (as local_eval's) resident on one SM with
// `smem` bytes of dynamic shared memory each, -1 on error.
extern "C" int local_eval_blocks_per_sm(int mode, int smem) {
  const void* k =
      mode == 2 ? reinterpret_cast<const void*>(local_eval_lists_kernel)
      : mode    ? reinterpret_cast<const void*>(local_eval_kernel<true>)
                : reinterpret_cast<const void*>(local_eval_kernel<false>);
  int n = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, LE_THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
