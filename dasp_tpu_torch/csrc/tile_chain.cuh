// Helpers shared by the kernels that cut a row into tiles, one block per
// tile, and hand a state from tile to tile across blocks (a chained scan:
// sosfilt_cascade.cuh, ballistics.cuh). A block takes its tile number from
// an atomic counter in the order blocks start, so it only ever waits on a
// block that runs or has run.

#pragma once

#include <cuda_runtime.h>

namespace dasp {

// tile sample g lives at g + g / 32: thread t's 32-sample chunk at t * 33,
// so a warp reading sample k of 32 chunks hits 32 banks
__device__ __forceinline__ int padded(int g) { return g + g / 32; }

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

}  // namespace dasp
