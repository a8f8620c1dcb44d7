// Exact biquad-cascade filter over rows as a time-parallel chunked scan: the
// kernel template shared by the three uses of kernel A: forward
// (sosfilt_cascade.cu), save-all forward (sosfilt_cascade_save_all.cu) and
// adjoint (sosfilt_cascade_adjoint.cu).
//
// Replaces: dasp_tpu/ops/pallas_iir.py, _sosfilt_wavefront_kernel. Every row
// r of x (R, T) runs through S second-order sections [b0, b1, b2, a0(=1),
// a1, a2], section after section, with zero initial state.
//
// What bounds it on an H100: bytes. The style-transfer EQ (8 rows x 131072
// samples, 6 sections) reads 4.2 MB and writes 4.2 MB: 2.5 us at 3.35 TB/s;
// save-all writes 6 planes (25 MB), the 7-section adjoint 7. Its arithmetic
// (about 10 flops per sample and section) is under a microsecond of fp32
// issue. The recursion, though, is a chain of T dependent steps per row and
// section: walked by one thread per row (the design this file had first) it
// kept 8 threads busy on a 132-SM card and took 7.9 ms.
//
// What the design does about it: each row is cut into chunks of kChunk = 32
// samples, one per thread, and tiles of kTile = 8192 samples, one per block
// of 256 threads. At the EQ's 8 x 131072 that is 128 blocks (8 rows x 16
// tiles) of 256 threads, 32768 chunks; the corruption's 262144 samples give
// 256 blocks. A block stages its tile through shared memory (coalesced
// loads and stores, padded against bank conflicts); from there each thread
// keeps its chunk in registers through all S sections. Per section s:
//
//  1. zero-state pass: the thread walks its chunk's direct-form recursion
//     from zero output state (the input history x[-1], x[-2] is the true
//     one: the previous chunk's samples, or for later sections the state
//     the previous section's carry gave), keeping only the last two
//     outputs e = (z[L-1], z[L-2]);
//  2. carry: the true state c = (y[-1], y[-2]) entering chunk j follows
//     c_{j+1} = M c_j + e_j, with M the section's 2x2 state map over one
//     chunk (from its AR impulse response h: M = [[h[L], -a2 h[L-1]],
//     [h[L-1], -a2 h[L-2]]], as dasp_tpu_torch/ops/iir.py
//     block_toeplitz_operators). A warp scans its 32 chunks by shuffles
//     (Kogge-Stone, with the powers M^1..M^32 precomputed per block); one
//     thread chains the 8 warp totals from the state entering the tile and
//     publishes the state leaving it; the block of the next tile of the row
//     waits for that (a chained scan: tiles take their index from an atomic
//     counter in launch order, so a block only waits on a block that runs or
//     has run);
//  3. fix-up: the thread walks its chunk again from its true state,
//     writing the section's output over its input in registers (the next
//     section's input; save-all stores it, one coalesced plane per section).
//
// Numerics: inside the kernel everything runs in float64 (the walks, the
// powers of M, the carry, the samples handed from section to section); only
// the stored planes are rounded to fp32. Errors injected into the carried
// state of a pole near the unit circle (a 20 Hz / Q 6 low shelf: about
// 2.5e-4 from it) are amplified by the AR part's resonance, so an fp32
// carry loses the low band; and the adjoint's first section is the bare AR
// part (1 / A), whose output for such a shelf is thousands of times its
// input, so fp32 samples handed on to the FIR part that cancels it lose
// dL/dx (3.1e-3 of its largest value on an H100 with fp32 walks, against a
// bound of 1e-3). The float64 work is about 10 double FMAs per sample and
// section. Callers hold the result against float64.
//
// SAVE_ALL writes every section's output, y (S, R, T), as the TPU kernel's
// save_all=True does: the forward residuals of the backward pass, and in the
// adjoint use every lambda and dL/dx at once. REVERSE walks time from T-1
// down to 0 (recursion index n reads and writes t = T-1-n): the adjoint
// cascade runs in flipped time without flipping anything in memory. Both are
// template parameters (a runtime direction cost the first design 4.2 ms).
// T may have any length: samples past the end read zero and are not stored.
//
// Scratch, allocated by the caller: `sync`, 1 + rows * ntiles ints, zeroed
// (the tile counter, then per tile the number of sections published), and
// `states`, rows * ntiles * S * 2 doubles.

#pragma once

#include <cuda_runtime.h>

#include "tile_chain.cuh"

namespace dasp {

constexpr int kChunk = 32;            // samples per thread
constexpr int kWarp = 32;
constexpr int kCascadeThreads = 256;  // threads per block
constexpr int kCascadeWarps = kCascadeThreads / kWarp;
constexpr int kTile = kChunk * kCascadeThreads;  // samples per block
// Largest section count the kernel takes; the wrapper checks it.
constexpr int kMaxSections = 16;
// dynamic shared memory: the powers M^1..M^32 of every section, then the
// tile with one float of padding per 32 samples
constexpr int kTileFloats = kTile + kTile / 32;

struct Mat2 {  // [[a, b], [c, d]]
  double a, b, c, d;
};

__device__ __forceinline__ Mat2 mat_mul(const Mat2& x, const Mat2& y) {
  return {x.a * y.a + x.b * y.c, x.a * y.b + x.b * y.d,
          x.c * y.a + x.d * y.c, x.c * y.b + x.d * y.d};
}

// M^j of section (a1, a2) over kChunk samples, in float64
__device__ inline Mat2 chunk_map_power(double a1, double a2, int j) {
  double h1 = -a1, h2 = 1.0, h3 = 0.0;  // h[k-1], h[k-2], h[k-3]
  for (int k = 2; k <= kChunk; ++k) {
    const double h = -a1 * h1 - a2 * h2;
    h3 = h2;
    h2 = h1;
    h1 = h;
  }
  // h1, h2, h3 = h[L], h[L-1], h[L-2]
  Mat2 p = {h1, -a2 * h2, h2, -a2 * h3};
  Mat2 r = {1.0, 0.0, 0.0, 1.0};
  for (; j; j >>= 1) {
    if (j & 1) r = mat_mul(r, p);
    p = mat_mul(p, p);
  }
  return r;
}

template <bool SAVE_ALL, bool REVERSE>
__global__ void __launch_bounds__(kCascadeThreads)
sosfilt_cascade_kernel(const float* __restrict__ sos, const float* __restrict__ x,
                       float* __restrict__ y, int rows, int S, long long T, int ntiles,
                       int* __restrict__ sync, double* __restrict__ states) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Mat2* powers = reinterpret_cast<Mat2*>(smem_raw);  // [S][32]: M^(j+1)
  float* tile = reinterpret_cast<float*>(powers + S * kWarp);
  __shared__ double2 warp_total[kCascadeWarps];
  __shared__ double2 warp_state[kCascadeWarps];
  __shared__ float halo[2];
  __shared__ int tile_id;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  if (tid == 0) tile_id = atomicAdd(sync, 1);
  __syncthreads();
  const int r = tile_id % rows;
  const int tau = tile_id / rows;
  int* flags = sync + 1 + static_cast<long long>(r) * ntiles;
  double2* row_states = reinterpret_cast<double2*>(states) + static_cast<long long>(r) * ntiles * S;
  const float* coef = sos + static_cast<long long>(r) * S * 6;

  for (int i = tid; i < S * kWarp; i += kCascadeThreads) {
    const int s = i / kWarp;
    powers[i] = chunk_map_power(coef[6 * s + 4], coef[6 * s + 5], i % kWarp + 1);
  }

  const long long row_off = static_cast<long long>(r) * T;
  const long long n0 = static_cast<long long>(tau) * kTile;
  auto at = [&](long long n) { return row_off + (REVERSE ? T - 1 - n : n); };
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const int g = i * kCascadeThreads + tid;
    const long long n = n0 + g;
    tile[padded(g)] = n < T ? x[at(n)] : 0.f;
  }
  if (tid < 2) halo[tid] = n0 > tid ? x[at(n0 - 1 - tid)] : 0.f;
  __syncthreads();

  double u[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) u[k] = tile[tid * (kChunk + 1) + k];
  // the input history of this chunk: x[-1], x[-2]
  double hist1 = tid ? tile[padded(tid * kChunk - 1)] : halo[0];
  double hist2 = tid ? tile[padded(tid * kChunk - 2)] : halo[1];

  for (int s = 0; s < S; ++s) {
    const double b0 = coef[6 * s + 0], b1 = coef[6 * s + 1], b2 = coef[6 * s + 2];
    const double a1 = coef[6 * s + 4], a2 = coef[6 * s + 5];
    const Mat2* pw = powers + s * kWarp;

    // 1. zero-state pass
    double e1, e2;  // z[L-1], z[L-2]
    {
      double xm1 = hist1, xm2 = hist2, z1 = 0.0, z2 = 0.0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const double v = u[k];
        const double z = b0 * v + b1 * xm1 + b2 * xm2 - a1 * z1 - a2 * z2;
        xm2 = xm1;
        xm1 = v;
        z2 = z1;
        z1 = z;
      }
      e1 = z1;
      e2 = z2;
    }

    // 2. carry: inclusive scan of the chunk maps over the warp
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const double p1 = __shfl_up_sync(0xffffffffu, e1, d);
      const double p2 = __shfl_up_sync(0xffffffffu, e2, d);
      if (lane >= d) {
        const Mat2 m = pw[d - 1];
        e1 += m.a * p1 + m.b * p2;
        e2 += m.c * p1 + m.d * p2;
      }
    }
    double x1 = __shfl_up_sync(0xffffffffu, e1, 1);
    double x2 = __shfl_up_sync(0xffffffffu, e2, 1);
    if (lane == kWarp - 1) warp_total[warp] = make_double2(e1, e2);
    __syncthreads();
    if (tid == 0) {
      double2 c = make_double2(0.0, 0.0);
      if (tau > 0) {
        while (load_acquire(flags + tau - 1) <= s) {
        }
        c = __ldcg(row_states + static_cast<long long>(tau - 1) * S + s);
      }
      const Mat2 m = pw[kWarp - 1];
      for (int w = 0; w < kCascadeWarps; ++w) {
        warp_state[w] = c;
        const double2 t = warp_total[w];
        c = make_double2(m.a * c.x + m.b * c.y + t.x, m.c * c.x + m.d * c.y + t.y);
      }
      if (tau + 1 < ntiles) {
        __stcg(row_states + static_cast<long long>(tau) * S + s, c);
        store_release(flags + tau, s + 1);
      }
    }
    __syncthreads();
    double c1 = warp_state[warp].x, c2 = warp_state[warp].y;
    if (lane) {
      const Mat2 m = pw[lane - 1];
      const double t1 = m.a * c1 + m.b * c2 + x1;
      c2 = m.c * c1 + m.d * c2 + x2;
      c1 = t1;
    }

    // 3. fix-up: the chunk again from its true state
    {
      double xm1 = hist1, xm2 = hist2, ym1 = c1, ym2 = c2;
      hist1 = c1;  // the next section's input history
      hist2 = c2;
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const double v = u[k];
        const double out = b0 * v + b1 * xm1 + b2 * xm2 - a1 * ym1 - a2 * ym2;
        xm2 = xm1;
        xm1 = v;
        ym2 = ym1;
        ym1 = out;
        u[k] = out;
      }
    }

    if (SAVE_ALL || s == S - 1) {
      // every thread is past its tile reads (two barriers since), so the
      // tile is free: stage the chunks and store the plane coalesced
#pragma unroll
      for (int k = 0; k < kChunk; ++k) tile[tid * (kChunk + 1) + k] = static_cast<float>(u[k]);
      __syncthreads();
      float* out = y + (SAVE_ALL ? static_cast<long long>(s) * rows * T : 0);
#pragma unroll 4
      for (int i = 0; i < kChunk; ++i) {
        const int g = i * kCascadeThreads + tid;
        const long long n = n0 + g;
        if (n < T) out[at(n)] = tile[padded(g)];
      }
    }
  }
}

// sos: (rows, S, 6); x: (rows, T); y: (rows, T), or (S, rows, T) with
// SAVE_ALL; all fp32 and contiguous on the device; sync and states as in the
// header note. Launches on `stream` and returns the CUDA error as an int.
template <bool SAVE_ALL, bool REVERSE>
int launch_cascade(const float* sos, const float* x, float* y, int rows, int S,
                   long long T, int* sync, double* states, cudaStream_t stream) {
  if (S < 1 || S > kMaxSections || rows < 1 || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = sosfilt_cascade_kernel<SAVE_ALL, REVERSE>;
  const int smem = kMaxSections * kWarp * static_cast<int>(sizeof(Mat2)) + kTileFloats * 4;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int ntiles = static_cast<int>((T + kTile - 1) / kTile);
  const size_t bytes = S * kWarp * sizeof(Mat2) + kTileFloats * sizeof(float);
  sosfilt_cascade_kernel<SAVE_ALL, REVERSE><<<rows * ntiles, kCascadeThreads, bytes, stream>>>(
      sos, x, y, rows, S, T, ntiles, sync, states);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dasp
