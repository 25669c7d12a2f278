// Device code shared by evalDG's two cooperative kernels for Hopper
// (sm_90a): or_and_fixpoint (bool_matmul/csrc/or_and_skinny.cu), the reach
// fixpoint, and min_plus_settle (tropical_matmul/csrc/min_plus_matmul.cu),
// the dist answer by levels.
//
// Each runs a whole single-source search in one cooperative launch: every
// block of the grid is resident at once (the grid is at most the SMs times
// the blocks an SM holds), so the blocks can wait for each other between
// the phases of a step.  Each keeps lists of the rows a step reads,
// appended to by every block with one atomicAdd a warp, and a small int32
// state that holds the lists' lengths.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace fixpoint {

// Every block of the grid waits here until all have arrived, and the
// writes of each are then visible to all.  A grid of one block needs only
// the block barrier.  Grid synchronisation needs a cooperative launch but
// no relocatable device code (CUDA 11 and later).
__device__ __forceinline__ void grid_barrier() {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    cooperative_groups::this_grid().sync();
  }
}

// Reserves `cnt` slots of the list whose length is *count for the calling
// thread, with one atomicAdd a warp; returns the thread's first slot.
// Every lane of the warp must call it (a lane with nothing passes 0).  The
// order of the slots between warps varies from run to run; the kernels
// only OR or min over the list, so their results do not.
__device__ __forceinline__ int warp_append(int* count, int cnt) {
  const int lane = threadIdx.x & 31;
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int base = 0;
  if (lane == 31 && total > 0) base = atomicAdd(count, total);
  base = __shfl_sync(0xffffffffu, base, 31);
  return base + incl - cnt;
}

// How a step's list of n rows is cut over the grid: `groups` ranges of
// `per` rows, each paired with every one of the `strips` column strips, so
// that a list of one row and one of ten thousand both give every block
// work when there is enough of it.  Item i of groups * strips is strip
// i % strips of the row range i / strips.
struct Split {
  int groups;
  int per;
};

__device__ __forceinline__ Split split_rows(int n, int strips) {
  const int groups = max(1, min(n, static_cast<int>(gridDim.x) / strips));
  return {groups, (n + groups - 1) / groups};
}

// A cooperative launch of `blocks` blocks of `threads` threads on stream
// s: the card must support it, and the grid must fit on the card at once
// (the caller sizes it from the kernel's occupancy).  Returns the launch's
// CUDA error code, and clears it.
inline int cooperative_launch(const void* kernel, int blocks, int threads,
                              void** args, cudaStream_t s) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args,
                                  0, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace fixpoint
