// Grid barrier on a counter of arrivals (bcd_update.cu) and the
// cooperative launch of the persistent-grid kernels (bcd_update.cu,
// fista_gram.cu), eager or under stream capture.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

// The n-th barrier of a launch waits for n * gridDim.x arrivals, one a
// block, on a counter that is zero at launch. Arrive and wait are split
// so that a block can work between them. The arriving thread's release
// covers the writes that a warp or block barrier ordered before it;
// thread 0's acquire, then the block's barrier, come before any read. A
// wait that never completes traps (a launch error) after ~2^32 cycles
// instead of hanging the card.
static __device__ __forceinline__ void arrive(unsigned* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n"
               :: "l"(counter) : "memory");
}

static __device__ __forceinline__ void grid_wait(const unsigned* counter,
                                                 unsigned target) {
  if (threadIdx.x == 0) {
    unsigned seen;
    long long t0 = -1;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(counter) : "memory");
      if (seen >= target) break;
      if (t0 < 0) t0 = clock64();
      else if (clock64() - t0 > (1ll << 32)) __trap();
    }
  }
  __syncthreads();
}

// What a cooperative launch asks the runtime, kept per source file: the
// most blocks the card holds at once for a (kernel, device, block size,
// dynamic shared memory). A launch the full table does not hold asks anew.
struct CoopGrid {
  const void* kern;
  int dev, threads;
  size_t smem;
  int max_grid;
};
struct CoopCache {
  static constexpr int SLOTS = 64;
  std::mutex mu;
  CoopGrid grids[SLOTS];
  int n = 0;
};

// Raises the kernel's dynamic shared memory limit to `smem` where it is
// lower, then returns the most blocks the card holds.
static inline cudaError_t coop_max_grid(const void* kern, int dev,
                                        int threads, size_t smem,
                                        int* max_grid) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if ((size_t)attr.maxDynamicSharedSizeBytes < smem &&
      (err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess)
    return err;
  int n_sm = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return err;
  *max_grid = per_sm * n_sm;
  return cudaSuccess;
}

// Launch `kern` as a cooperative grid of `grid` blocks of `threads`
// threads with `smem` bytes of dynamic shared memory on `stream`;
// refuses a grid larger than the card holds at once. The launch goes
// through cudaLaunchKernelExC with the cooperative attribute, which a
// stream capture records as a cooperative kernel node: a replayed graph
// launches the grid with all its blocks resident, as the counter barrier
// needs. The occupancy queries are not stream work, and the first (eager)
// step fills the table before any capture.
static inline cudaError_t launch_cooperative(const void* kern, int grid,
                                             int threads, size_t smem,
                                             void** args, void* stream) {
  int dev = 0, max_grid = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  {
    static CoopCache cache;
    std::lock_guard<std::mutex> lock(cache.mu);
    const CoopGrid* hit = nullptr;
    for (int i = 0; i < cache.n && !hit; ++i) {
      const CoopGrid& e = cache.grids[i];
      if (e.kern == kern && e.dev == dev && e.threads == threads &&
          e.smem == smem)
        hit = &e;
    }
    if (hit) {
      max_grid = hit->max_grid;
    } else {
      if ((err = coop_max_grid(kern, dev, threads, smem, &max_grid)) !=
          cudaSuccess)
        return err;
      if (cache.n < CoopCache::SLOTS)
        cache.grids[cache.n++] = CoopGrid{kern, dev, threads, smem, max_grid};
    }
  }
  if (grid > max_grid) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = &coop;
  config.numAttrs = 1;
  err = cudaLaunchKernelExC(&config, kern, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
