// Grid barrier on a counter of arrivals and the cooperative launch of the
// persistent-grid kernels (bcd_update.cu, fista_gram.cu).
#pragma once

#include <cuda_runtime.h>

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

// Launch `kern` as a cooperative grid of `grid` blocks of `threads`
// threads with `smem` bytes of dynamic shared memory on `stream`;
// refuses a grid larger than the card holds at once.
static inline cudaError_t launch_cooperative(const void* kern, int grid,
                                             int threads, size_t smem,
                                             void** args, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, smem)) != cudaSuccess)
    return err;
  if (grid > per_sm * n_sm) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(threads), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
