// Or-and (Boolean semiring) matrix product on Hopper's int8 tensor cores,
// built for sm_90a.
//
//   C[i, j] = OR_k (A[i, k] AND Bt[j, k])          (C = A B with B = Bt^T)
//
// A [M, K] and Bt [N, K] are torch.bool storage (one byte, 0 or 1), both
// K-major: row-major with K contiguous, every row starting on a 16-byte
// boundary (row pitch a multiple of 16).  C [M, N] is written as bytes 0/1
// with row pitch ldc, and, when ct is not null, C^T [N, M] with row pitch
// ldct, both in torch.bool tensors that the caller allocates.  The pad
// columns of both outputs (up to the pitch) are written as zeros.
//
// Replaces the TPU kernel src/repro/kernels/bool_matmul/bool_matmul.py,
// function bool_matmul_pallas (body _kernel).  That kernel upcasts 0/1
// blocks to f32 so that each 128-block product rides the TPU's matrix
// unit, and thresholds the f32 sum at > 0 after the last K block.
//
// What bounds it on the card.  A squaring of the boundary closure
// (M = N = K = nb = 16039) does 2 nb^3 = 8.25e12 operations on 3 nb^2
// bytes: 4.17 ms at 1979 TOPS int8 (H100 SXM data sheet, dense) against
// 0.23 ms for the bytes at 3.35 TB/s, so it is bound by operations.  The
// batch compose ([256, nb] x [nb, nb]) reads the 257 MB closure once: 0.077
// ms for the bytes against 0.066 ms of operations, so it is bound by bytes.
//
// Design.  The same product as the TPU's, on the int8 tensor cores: a
// bool byte is already a valid u8 operand, so the kernel runs
// wgmma.mma_async m64n256k32.s32.u8.u8 straight on the operands and
// thresholds the s32 sum at > 0.  With 0/1 bytes the sum is at most K, so
// it cannot overflow for K < 2^31.  8-bit wgmma reads both operands from
// shared memory in K-major layout only (no transpose bit below 16 bits),
// hence the Bt operand.
//  - Tiles: one block per 128 x 256 output tile, two consumer warpgroups
//    of 64 x 256 (128 s32 accumulators a thread) and one producer warp.
//  - Loads: the producer issues TMA copies of 128-byte K slices (A 128 x
//    128 B, Bt 256 x 128 B) into a ring of 4 stages of 48 KB, with the
//    128-byte swizzle that the wgmma descriptors name; full / empty
//    mbarriers hand the stages between producer and consumers, so the
//    loads of later slices overlap the products of earlier ones.  TMA
//    fills boxes past M, N or K with zeros, which masks every ragged edge.
//  - Clusters: at 48 KB a slice the blocks would read about 5 TB/s out of
//    L2 at the squaring's rate, which L2 cannot serve.  So two blocks on
//    vertically adjacent tiles form a cluster and share the Bt slice:
//    each loads its A slice and half the Bt slice, and multicasts that
//    half to both, which cuts L2 reads to 32 KB a slice.  A stage is
//    refilled only once the consumers of both blocks have released it.
//  - Order: the clusters run in groups of 8 (16 row tiles), so the blocks
//    in flight share their A and Bt slices in L2.
//  - Epilogue: the thresholded tile is staged through shared memory twice,
//    as C and as C^T, so that both go out as coalesced 16-byte stores.  The
//    closure's squarings chain through (C, C^T) with no transpose pass.
// A wait that outlasts 10 s traps, so that a fault ends the launch with an
// error instead of a hang.
//
// The floor pair: or_and_floor_kernel, the rank update's last product.
//
//   C'[i, j]   = F[i, j]  OR  OR_k (A[i, k] AND Bt[j, k])      [M, N]
//   C'^T[j, i] = Ft[j, i] OR  OR_k (A[i, k] AND Bt[j, k])      [N, M]
//
// F and Ft are the closure C and its K-major copy C^T; each is read from
// its own matrix, never derived from the other.  C' and C'^T go to fresh
// padded storage whose pad columns (up to the pitch) come out zero.  The
// repair calls it at A = left [nb, r], Bt = T^T [nb, r], r = 64 on one
// card (every changed-row bucket is a multiple of 64; ~1000 in the sharded
// repair).
//
// What bounds it.  At nb = 16103, r = 64 it must read C and C^T (nb^2
// bytes each: their pads are never read) and write C' and C'^T to the
// pitch (nb pitch(nb) each, pads included): 2 nb (nb + pitch(nb)) plus
// the operands = 1.040 GB, 0.3105 ms at 3.35 TB/s, against 2 nb^2 r =
// 3.3e10 operations, 0.017 ms at 1979 TOPS: bound by bytes.
// The product alone once wrote P and P^T, and two OR passes then read
// them back with C and C^T into zero-filled C' and C'^T (about 1.6 GB
// more).  At the sharded repair's r ~ 1000 the operations (doubled, see
// below) and the L2 reads of the operand slices come near the bytes.
//
// Design.
//  - Persistent grid: one block an SM (the shared memory below) walks the
//    128 x 128 output tiles in a grouped raster (8 row tiles share each
//    column tile in turn), so barrier setup is paid once and the blocks in
//    flight share their A and Bt slices in L2.
//  - Operand slices: a tile's A slice [128, bk] and Bt slice [128, bk] are
//    one TMA box each, bk = 64 bytes with the 64-byte swizzle for K <= 64
//    (no zero-filled half at K = 64) and 128 bytes with the 128-byte
//    swizzle above; K <= 128 is one slice, larger K streams slices through
//    a ring of 4 stages (the box reads zeros past K, which add nothing).
//  - C^T by a second product, not by a byte scatter: each consumer
//    warpgroup runs m64n128k32 on (A slice, Bt slice) for its 64 rows of C
//    and on the swapped pair (Bt slice, A slice) for its 64 rows of C^T.
//    Both slices are already K-major in shared memory, the only layout
//    8-bit wgmma reads, and each accumulator fragment then lies in its
//    output's row order, so both tiles are written as 2-byte words.  The
//    128 x 128 tile keeps 2 x 64 accumulators a thread (the budget of one
//    m64n256 tile); the doubled tensor work is 0.017 ms at r = 64.  (A
//    register transpose of the C fragment would keep the work single but
//    needs a 4 x 4 byte shuffle a word across the quad's lanes.)
//  - The floor loaded ahead: a producer warp loads the C tile of F and
//    the C^T tile of Ft by TMA into one of 3 staging buffers while the
//    consumers multiply earlier tiles.  The epilogue thresholds the sums,
//    ORs them into the staged floor (128-byte swizzled, so the 2-byte
//    writes of a warp fall on distinct banks), fences the async proxy and
//    hands the buffer to a storer warp, which issues both tiles as TMA
//    stores in one bulk group and returns the buffer to the producer once
//    the stores have read it (cp.async.bulk.wait_group.read, one group
//    later).  The consumers
//    never wait on a store, so a tile's 32 KB of stores overlap the next
//    tiles' loads and products.
//  - Row pitch: the paths keep wide matrices with rows 128 bytes apart
//    (ops.pitch), so no 128-byte box row straddles two L2 lines; at a
//    pitch of 16112 bytes the kernel takes 1.6 times as long
//    (tools/or_and_tile_ab.py).
//  - Edges: TMA loads past M, N or K read zeros, the floor maps stop at N
//    (resp. M) so the floor's pad bytes are never read, and the stores'
//    maps run to the pitch: the pad columns come out 0 | 0.

#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;                        // output rows per block
constexpr int BN = 256;                        // output columns per block
constexpr int BK = 128;                        // K bytes per stage: one
                                               // 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int WGMMA_K = 32;                    // u8 wgmma depth
constexpr int A_BYTES = BM * BK;               // 16 KB
constexpr int B_BYTES = BN * BK;               // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES; // 48 KB
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int THREADS = CONSUMERS + 32;        // and one producer warp
constexpr int CLUSTER = 2;                     // blocks sharing a Bt slice
constexpr int B_PART = BN / CLUSTER;           // Bt rows each block loads
constexpr int GROUP = 8;                       // clusters per raster group
constexpr int P1 = BN + 16;                    // staged C tile pitch
constexpr int P2 = BM + 16;                    // staged C^T tile pitch
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(BM * P1 + BN * P2 <= STAGES * STAGE_BYTES,
              "the epilogue tiles reuse the stage ring");

// Error code returned when cuTensorMapEncodeTiled is missing or refuses.
constexpr int ENCODE_ERROR = 100000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Arrive on the barrier at the same offset in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n"
      :: "r"(bar), "r"(rank) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until the phase of parity `parity` of the barrier has completed;
// trap after 10 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((spins & 1023u) == 1023u) {
      const uint64_t now = globaltimer_ns();
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  }
}

// TMA: the box at (c0 = K offset in bytes, c1 = row) of `map` into shared
// memory at dst, completing `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// The same box into dst of every block in `mask`, completing the barrier
// at `bar` in each of them.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "h"(mask)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte-swizzled atoms of 8 rows
// x 128 bytes (1024 bytes apart).  The leading offset is unused for swizzled
// K-major layouts.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)
         | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(int32_t (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d[64 x 256] += A[64 x 32] * B[256 x 32]^T, u8 operands from shared memory.
__device__ __forceinline__ void wgmma_u8(int32_t (&d)[128], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
or_and_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    uint8_t* __restrict__ c, uint8_t* __restrict__ ct, int M,
                    int N, int K, int ldc, int ldct, int pairs_m,
                    int tiles_n) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + STAGES * STAGE_BYTES;  // full[s]: + 8 s
  const uint32_t empty0 = full0 + 8 * STAGES;          // empty[s]: + 8 s

  // grouped raster over clusters of CLUSTER row tiles: GROUP clusters
  // share each column tile in turn; the blocks of a cluster take
  // vertically adjacent row tiles of one column tile
  const uint32_t rank = cluster_rank();
  const int pid = blockIdx.x / CLUSTER;
  const int per_group = GROUP * tiles_n;
  const int first = (pid / per_group) * GROUP;
  const int group = min(pairs_m - first, GROUP);
  const int m0 = ((first + (pid % per_group) % group) * CLUSTER + rank) * BM;
  const int n0 = ((pid % per_group) / group) * BN;
  const int kiters = (K + BK - 1) / BK;
  const int t = threadIdx.x;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);    // the producer's expect_tx arrival
      // one arrival per consumer warpgroup of every block in the cluster
      mbar_init(empty0 + 8 * s, 2 * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the peer's barriers are ready before any multicast or remote arrival
  cluster_sync();

  if (t >= CONSUMERS) {
    // producer warp: one thread keeps the ring full; the stage takes this
    // block's A slice and both blocks' halves of the Bt slice
    if (t == CONSUMERS) {
      for (int it = 0; it < kiters; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty0 + 8 * s, ((it / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t dst = base + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load(dst, &tm_a, full, it * BK, m0);
        tma_load_multicast(dst + A_BYTES + rank * (B_PART * BK), &tm_b, full,
                           it * BK, n0 + rank * B_PART,
                           (uint16_t)((1u << CLUSTER) - 1));
      }
    }
  } else {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
    const int wg = t / 128;
    int32_t acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    for (int it = 0; it < kiters; ++it) {
      const int s = it % STAGES;
      mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
      const uint32_t sa = base + s * STAGE_BYTES + wg * (64 * BK);
      const uint32_t sb = base + s * STAGE_BYTES + A_BYTES;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / WGMMA_K; ++kk)
        wgmma_u8(acc, sw128_desc(sa + kk * WGMMA_K),
                 sw128_desc(sb + kk * WGMMA_K));
      wgmma_commit();
      fence_acc(acc);
      // at most this slice's products still run: the previous stage is free,
      // in this block and, for the multicast, in the peer
      wgmma_wait<1>();
      if (it > 0 && t % 128 == 0)
        for (uint32_t r = 0; r < CLUSTER; ++r)
          mbar_arrive_cluster(empty0 + 8 * ((it - 1) % STAGES), r);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: every consumer is past its last product, so the ring is free
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
    uint8_t* t1 = smem;               // [BM][P1]: the C tile
    uint8_t* t2 = smem + BM * P1;     // [BN][P2]: the C^T tile
    const int warp = (t % 128) / 32;
    const int lane = t % 32;
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    const int c0 = (lane % 4) * 2;
    // accumulator i sits at row r0 + 8 ((i / 2) % 2), column 8 (i / 4) + c0
    // + i % 2 (the wgmma D fragment)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int col = j * 8 + c0;
        const uint32_t v0 = acc[j * 4 + h * 2] > 0 ? 1u : 0u;
        const uint32_t v1 = acc[j * 4 + h * 2 + 1] > 0 ? 1u : 0u;
        *reinterpret_cast<uint16_t*>(t1 + r * P1 + col) =
            static_cast<uint16_t>(v0 | (v1 << 8));
        if (ct != nullptr) {
          t2[col * P2 + r] = static_cast<uint8_t>(v0);
          t2[(col + 1) * P2 + r] = static_cast<uint8_t>(v1);
        }
      }
    }
    asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
    // C rows m < M, columns up to the pitch (past N the products are zero)
    for (int q = t; q < BM * BN / 16; q += CONSUMERS) {
      const int r = q / (BN / 16);
      const int col = (q % (BN / 16)) * 16;
      if (m0 + r < M && n0 + col < ldc)
        *reinterpret_cast<uint4*>(c + (size_t)(m0 + r) * ldc + n0 + col) =
            *reinterpret_cast<const uint4*>(t1 + r * P1 + col);
    }
    if (ct != nullptr) {
      for (int q = t; q < BN * BM / 16; q += CONSUMERS) {
        const int r = q / (BM / 16);
        const int col = (q % (BM / 16)) * 16;
        if (n0 + r < N && m0 + col < ldct)
          *reinterpret_cast<uint4*>(ct + (size_t)(n0 + r) * ldct + m0 + col) =
              *reinterpret_cast<const uint4*>(t2 + r * P2 + col);
      }
    }
  }
  // no block leaves while its peer may still arrive on its barriers
  cluster_sync();
}

// ---------------------------------------------------------------------------
// or_and_floor_kernel: C' = F | A Bt^T and C'^T = Ft | (A Bt^T)^T
// ---------------------------------------------------------------------------

constexpr int FT = 128;                        // output tile side
constexpr int F_TILE = FT * FT;                // one staged tile: 16 KB
constexpr int F_FLOOR_BYTES = 2 * F_TILE;      // its C and C^T tiles
constexpr int F_GROUP = 8;                     // row tiles per raster group
constexpr int F_THREADS = CONSUMERS + 64;      // and a producer and a
                                               // storer warp

// Shared memory: a ring of 4 operand stages, each with room for an A and a
// Bt slice at bk = 128, and 3 staged floor/output tile pairs.  (A shorter
// ring with more floor pairs is slower: the producer, held up by the ring,
// issues the floors late.)
constexpr int F_STAGES = 4;
constexpr int F_STAGE_BYTES = 2 * FT * BK;
constexpr int F_FLOORS = 3;
constexpr int F_SMEM_BYTES = F_STAGES * F_STAGE_BYTES +
                             F_FLOORS * F_FLOOR_BYTES +
                             8 * (2 * F_STAGES + 3 * F_FLOORS) + 1024;
static_assert(F_SMEM_BYTES <= 232448, "one block an SM");

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// TMA: the box at smem src to (c0, c1) of `map`, in the thread's open
// bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in swizzled atoms of 8 rows x bk
// bytes (bk = 64: 64-byte swizzle; bk = 128: 128-byte swizzle).
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, int bk) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)
         | ((uint64_t)1 << 16)
         | ((uint64_t)((8 * bk) >> 4) << 32)
         | ((uint64_t)(bk == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void fence_acc64(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d[64 x 128] += A[64 x 32] * B[128 x 32]^T, u8 operands from shared memory.
__device__ __forceinline__ void wgmma_u8_n128(int32_t (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Origin (m0, n0) of tile `tile` in the grouped raster: F_GROUP row tiles
// take each column tile in turn.
__device__ __forceinline__ void floor_tile(int tile, int tiles_m,
                                           int tiles_n, int& m0, int& n0) {
  const int per_group = F_GROUP * tiles_n;
  const int first = (tile / per_group) * F_GROUP;
  const int rows = min(tiles_m - first, F_GROUP);
  m0 = (first + (tile % per_group) % rows) * FT;
  n0 = ((tile % per_group) / rows) * FT;
}

// Byte offset of (r, c) in a 128 x 128 tile with the 128-byte swizzle that
// the TMA maps of the floors and outputs name (16-byte chunk c / 16 XOR r
// mod 8).
__device__ __forceinline__ int sw128_offset(int r, int c) {
  return r * FT + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

// OR the thresholded 64 x 128 fragment of warpgroup rows [64 wg, +64) into
// the staged tile.
__device__ __forceinline__ void or_fragment(uint8_t* tile,
                                            const int32_t (&d)[64], int r0,
                                            int c0) {
#pragma unroll
  for (int j = 0; j < FT / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v0 = d[j * 4 + h * 2] > 0 ? 1u : 0u;
      const uint32_t v1 = d[j * 4 + h * 2 + 1] > 0 ? 1u : 0u;
      uint16_t* p = reinterpret_cast<uint16_t*>(
          tile + sw128_offset(r0 + 8 * h, j * 8 + c0));
      *p = static_cast<uint16_t>(*p | v0 | (v1 << 8));
    }
  }
}

// bk: the K bytes of one slice, 64 (the 64-byte swizzle) or 128.
template <int bk>
__global__ void __launch_bounds__(F_THREADS, 1)
or_and_floor_kernel(const __grid_constant__ CUtensorMap tm_a,
                    const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_f,
                    const __grid_constant__ CUtensorMap tm_ft,
                    const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_ct, int K,
                    int tiles_m, int tiles_n) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzles repeat every 1024 bytes: align everything to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t floors = base + F_STAGES * F_STAGE_BYTES;
  const uint32_t full0 = floors + F_FLOORS * F_FLOOR_BYTES;   // + 8 s
  const uint32_t empty0 = full0 + 8 * F_STAGES;               // + 8 s
  const uint32_t ffull0 = empty0 + 8 * F_STAGES;              // + 8 b
  const uint32_t staged0 = ffull0 + 8 * F_FLOORS;             // + 8 b
  const uint32_t fempty0 = staged0 + 8 * F_FLOORS;            // + 8 b
  const int tiles = tiles_m * tiles_n;
  const int kiters = (K + bk - 1) / bk;
  constexpr int slice = FT * bk;         // bytes of one operand's slice
  const int t = threadIdx.x;

  if (t == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);       // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 2);      // one per consumer warpgroup
    }
    for (int b = 0; b < F_FLOORS; ++b) {
      mbar_init(ffull0 + 8 * b, 1);      // the producer's expect_tx
      mbar_init(staged0 + 8 * b, CONSUMERS);  // every consumer thread
      mbar_init(fempty0 + 8 * b, 1);     // the storer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (t == CONSUMERS) {
    // producer: tile after tile, the floor pair into its staging buffer
    // (once the storer has handed it back) and the operand slices into
    // the ring
    int it = 0;                          // slices issued
    int j = 0;                           // tiles issued
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      int m0, n0;
      floor_tile(tile, tiles_m, tiles_n, m0, n0);
      const int b = j % F_FLOORS;
      mbar_wait(fempty0 + 8 * b, ((j / F_FLOORS) & 1) ^ 1);
      const uint32_t fb = floors + b * F_FLOOR_BYTES;
      mbar_expect_tx(ffull0 + 8 * b, F_FLOOR_BYTES);
      tma_load(fb, &tm_f, ffull0 + 8 * b, n0, m0);
      tma_load(fb + F_TILE, &tm_ft, ffull0 + 8 * b, m0, n0);
      for (int k = 0; k < kiters; ++k, ++it) {
        const int s = it % F_STAGES;
        mbar_wait(empty0 + 8 * s, ((it / F_STAGES) & 1) ^ 1);
        const uint32_t dst = base + s * F_STAGE_BYTES;
        mbar_expect_tx(full0 + 8 * s, 2 * slice);
        tma_load(dst, &tm_a, full0 + 8 * s, k * bk, m0);
        tma_load(dst + slice, &tm_b, full0 + 8 * s, k * bk, n0);
      }
    }
  } else if (t == CONSUMERS + 32) {
    // storer: each staged tile pair goes out by TMA store; its buffer
    // returns to the producer once the stores have read it
    int j = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
      int m0, n0;
      floor_tile(tile, tiles_m, tiles_n, m0, n0);
      const int b = j % F_FLOORS;
      mbar_wait(staged0 + 8 * b, (j / F_FLOORS) & 1);
      const uint32_t fb = floors + b * F_FLOOR_BYTES;
      tma_store(&tm_c, fb, n0, m0);
      tma_store(&tm_ct, fb + F_TILE, m0, n0);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      // every group but this tile's has read its buffer: the previous
      // tile's goes back to the producer
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      if (j > 0) mbar_arrive(fempty0 + 8 * ((j - 1) % F_FLOORS));
    }
    // the last stores complete before the block (and its shared memory)
    // goes away
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  } else if (t < CONSUMERS) {
    // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the C tile
    // and of the C^T tile
    const int wg = t / 128;
    const int warp = (t % 128) / 32;
    const int lane = t % 32;
    // accumulator i sits at row r0 + 8 ((i / 2) % 2), column 8 (i / 4) +
    // c0 + i % 2 of the warpgroup's 64 x 128 block (the wgmma D fragment)
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    const int c0 = (lane % 4) * 2;
    int32_t acc[64], acct[64];
    int it = 0;
    int j = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++j) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = acct[i] = 0;
      for (int k = 0; k < kiters; ++k, ++it) {
        const int s = it % F_STAGES;
        mbar_wait(full0 + 8 * s, (it / F_STAGES) & 1);
        const uint32_t sa = base + s * F_STAGE_BYTES;
        const uint32_t sb = sa + slice;
        fence_acc64(acc);
        fence_acc64(acct);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < bk / WGMMA_K; ++kk) {
          wgmma_u8_n128(acc, sw_desc(sa + wg * 64 * bk + kk * WGMMA_K, bk),
                        sw_desc(sb + kk * WGMMA_K, bk));
          wgmma_u8_n128(acct, sw_desc(sb + wg * 64 * bk + kk * WGMMA_K, bk),
                        sw_desc(sa + kk * WGMMA_K, bk));
        }
        wgmma_commit();
        fence_acc64(acc);
        fence_acc64(acct);
        // at most this slice's products still run: the previous slice's
        // stage is free
        wgmma_wait<1>();
        if (k > 0 && t % 128 == 0)
          mbar_arrive(empty0 + 8 * ((it - 1) % F_STAGES));
      }
      wgmma_wait<0>();
      fence_acc64(acc);
      fence_acc64(acct);
      if (kiters > 0 && t % 128 == 0)
        mbar_arrive(empty0 + 8 * ((it - 1) % F_STAGES));

      // epilogue: OR both fragments into the staged floor pair and hand
      // it to the storer
      const int b = j % F_FLOORS;
      mbar_wait(ffull0 + 8 * b, (j / F_FLOORS) & 1);
      uint8_t* fc = smem + (floors - base) + b * F_FLOOR_BYTES;
      or_fragment(fc, acc, r0, c0);
      or_fragment(fc + F_TILE, acct, r0, c0);
      // the generic-proxy writes become visible to the TMA stores
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(staged0 + 8 * b);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a u8 matrix [rows, cols] with row pitch `pitch` bytes, in
// boxes of box_rows x box_cols bytes with the 128-byte swizzle, or the
// 64-byte one for boxes 64 bytes wide; reads past the matrix's edges give
// zeros and stores past them are dropped.
bool encode_box(CUtensorMap* map, const void* ptr, int rows, int cols,
                int pitch, int box_rows, int box_cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estrides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a K-major u8 operand [rows, K] with row pitch `pitch` bytes,
// in boxes of box_rows x BK bytes with the 128-byte swizzle.
bool encode(CUtensorMap* map, const void* ptr, int rows, int K, int pitch,
            int box_rows) {
  return encode_box(map, ptr, rows, K, pitch, box_rows, BK);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// C = A Bt^T (and C^T when ct is not null) for A [M, K] with row pitch lda
// and Bt [N, K] with row pitch ldb.  Every pointer and pitch must be a
// multiple of 16 bytes.  Returns cudaGetLastError() after the launch, or
// ENCODE_ERROR when the tensor maps cannot be made.
extern "C" int or_and_matmul_nt(const void* a, const void* bt, void* c,
                                void* ct, int M, int N, int K, int lda,
                                int ldb, int ldc, int ldct, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || ldc < N || (ct != nullptr && ldct < M))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(bt) || !aligned16(c) || lda % 16 != 0 ||
      ldb % 16 != 0 || ldc % 16 != 0 ||
      (ct != nullptr && (!aligned16(ct) || ldct % 16 != 0)))
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tm_a, tm_b;
  std::memset(&tm_a, 0, sizeof(tm_a));
  std::memset(&tm_b, 0, sizeof(tm_b));
  // K == 0: no slice is loaded, and the tiles come out all zero
  if (K > 0 && !(encode(&tm_a, a, M, K, lda, BM) &&
                 encode(&tm_b, bt, N, K, ldb, B_PART)))
    return ENCODE_ERROR;
  // a ragged last cluster's second block gets rows past M: its loads read
  // zeros and it stores nothing
  const long long pairs_m = (M + CLUSTER * BM - 1) / (CLUSTER * BM);
  const long long tiles_n = (N + BN - 1) / BN;
  const long long blocks = CLUSTER * pairs_m * tiles_n;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      or_and_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  or_and_wgmma_kernel<<<(unsigned)blocks, THREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      tm_a, tm_b, static_cast<uint8_t*>(c), static_cast<uint8_t*>(ct), M, N,
      K, ldc, ldct, (int)pairs_m, (int)tiles_n);
  return (int)cudaGetLastError();
}

// C' = F | A Bt^T and C'^T = Ft | (A Bt^T)^T for A [M, K] (pitch lda),
// Bt [N, K] (ldb), the floors F [M, N] (ldf) and Ft [N, M] (ldft), into
// C' [M, N] (ldc) and C'^T [N, M] (ldct), pad columns written as zeros.
// Every pointer and pitch must be a multiple of 16 bytes.  Returns
// cudaGetLastError() after the launch, or ENCODE_ERROR when a tensor map
// cannot be made.
extern "C" int or_and_matmul_floor(const void* a, const void* bt,
                                   const void* f, const void* ft, void* c,
                                   void* ct, int M, int N, int K, int lda,
                                   int ldb, int ldf, int ldft, int ldc,
                                   int ldct, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || ldc < N || ldct < M || ldf < N ||
      ldft < M)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(a) || !aligned16(bt) || !aligned16(f) || !aligned16(ft) ||
      !aligned16(c) || !aligned16(ct) || lda % 16 != 0 || ldb % 16 != 0 ||
      ldf % 16 != 0 || ldft % 16 != 0 || ldc % 16 != 0 || ldct % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int bk = K <= 64 ? 64 : BK;
  CUtensorMap tm[6];
  std::memset(tm, 0, sizeof(tm));
  // K == 0: no slice is loaded, and the outputs are the floors
  if (K > 0 && !(encode_box(&tm[0], a, M, K, lda, FT, bk) &&
                 encode_box(&tm[1], bt, N, K, ldb, FT, bk)))
    return ENCODE_ERROR;
  // the floors stop at N (resp. M): their pad bytes are never read; the
  // outputs run to the pitch, whose columns come out zero
  if (!(encode_box(&tm[2], f, M, N, ldf, FT, FT) &&
        encode_box(&tm[3], ft, N, M, ldft, FT, FT) &&
        encode_box(&tm[4], c, M, ldc, ldc, FT, FT) &&
        encode_box(&tm[5], ct, N, ldct, ldct, FT, FT)))
    return ENCODE_ERROR;
  const long long tiles_m = (M + FT - 1) / FT;
  const long long tiles_n = (N + FT - 1) / FT;
  if (tiles_m * tiles_n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  auto kernel = bk == 64 ? or_and_floor_kernel<64> : or_and_floor_kernel<BK>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           F_SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = tiles_m * tiles_n < sms ? tiles_m * tiles_n : sms;
  kernel<<<(unsigned)blocks, F_THREADS, F_SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      tm[0], tm[1], tm[2], tm[3], tm[4], tm[5], K, (int)tiles_m,
      (int)tiles_n);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one block: the stage ring, its barriers and
// the alignment slack.
extern "C" int or_and_matmul_smem_bytes() { return SMEM_BYTES; }

extern "C" const char* kernel_error_string(int code) {
  if (code == ENCODE_ERROR)
    return "cuTensorMapEncodeTiled is missing or refused the operand";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
