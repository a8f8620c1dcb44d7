// Shared coordinates and tiling of the fractional-delay kernels
// (frac_delay.cu, frac_delay_bwd.cu). See dasp_tpu_torch/ops/frac_delay_kernel.py
// for the contract and the plain PyTorch version they are held against.
//
// Tiling of C-fwd and of C-bwd without dx: one row b per blockIdx.y, 1024
// consecutive output samples per block, 4 per thread (C-bwd with dx takes
// one per thread, frac_delay_bwd.cu). Inside a row every index is a 32-bit
// int (the wrapper checks Tp + Dm < 2^31); the row's 64-bit base offset is
// formed once. The delays, gains and cotangents stream in as 16-byte loads
// where Tp % 4 == 0 and the rows are 16-byte aligned (kVec), else one float
// at a time: the ragged case runs the same kernel.
//
// Every rounding step is written with __fadd_rn / __fsub_rn / __fmul_rn in
// the order of the plain version, so the compiler cannot contract it into
// an FMA and the forward is bitwise equal to that version.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace frac_delay {

constexpr int kMaxTaps = 2;
constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlockOutputs = kThreads * kPerThread;

// One tap at one output sample.
struct Tap {
  int i0;      // first lattice point in the tile's window (valid if v0)
  float w0;    // 1 - f
  float f;     // r - floor(r)
  float mask;  // 1 once t - d >= 0, else 0
  float gv;    // mask ? g : 0
  bool v0;     // 0 <= i0 < W
  bool v1;     // 0 <= i0 + 1 < W
};

// Tile-local coordinates: r = (j + Dm) - d with j = t - k*B (exact integer
// sum, then one fp32 subtraction); only the start mask uses the global t.
__device__ __forceinline__ Tap make_tap(float d, float g, int j, int t, int Dm,
                                        int W) {
  Tap p;
  const float r = __fsub_rn(static_cast<float>(j + Dm), d);
  const float fl = floorf(r);
  p.f = __fsub_rn(r, fl);
  p.w0 = __fsub_rn(1.0f, p.f);
  // float comparisons: a NaN coordinate reads nothing
  p.v0 = fl >= 0.0f && fl < static_cast<float>(W);
  p.v1 = fl >= -1.0f && fl < static_cast<float>(W - 1);
  p.i0 = (p.v0 || p.v1) ? static_cast<int>(fl) : 0;
  const bool on = __fsub_rn(static_cast<float>(t), d) >= 0.0f;
  p.mask = on ? 1.0f : 0.0f;
  p.gv = on ? g : 0.0f;
  return p;
}

// The two lattice points of tap p in a window (0 outside [0, W)), through
// the read-only path: neighbouring outputs read neighbouring points, which
// L1 serves.
__device__ __forceinline__ float read0(const float* win, const Tap& p) {
  return p.v0 ? __ldg(win + p.i0) : 0.0f;
}
__device__ __forceinline__ float read1(const float* win, const Tap& p) {
  return p.v1 ? __ldg(win + p.i0 + 1) : 0.0f;
}

// (1 - f) * x0 + f * x1
__device__ __forceinline__ float interp(const Tap& p, float x0, float x1) {
  return __fadd_rn(__fmul_rn(p.w0, x0), __fmul_rn(p.f, x1));
}

// The n (<= 4) floats src[k], k < n: one 16-byte load when kVec (then n is
// 0 or 4), else one at a time; the rest read as 0.
template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ src, int n,
                                      float (&v)[kPerThread]) {
  if (kVec) {
    const float4 q = n > 0 ? __ldg(reinterpret_cast<const float4*>(src))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      v[k] = k < n ? __ldg(src + k) : 0.0f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ dst, int n,
                                       const float (&v)[kPerThread]) {
  if (kVec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (k < n) dst[k] = v[k];
    }
  }
}

// A thread's outputs t0 .. t0 + n - 1 of its row (n == 0 past the end):
// each tap's delays and gains, and each output's tile-local j. The
// coordinates (make_tap) are formed where they are used, so that only the
// loaded values stay live across the channel loop.
struct Outputs {
  int t0;
  int n;
  int j[kPerThread];
  float d[kMaxTaps][kPerThread];
  float g[kMaxTaps][kPerThread];
};

// Loads the delays and gains of every tap: all loads are issued before any
// coordinate is formed.
template <bool kVec>
__device__ __forceinline__ void load_outputs(const float* __restrict__ d,
                                             const float* __restrict__ g,
                                             int bs, int nt, int Tp, int B,
                                             Outputs& o) {
  const int b = blockIdx.y;
  o.t0 = blockIdx.x * kBlockOutputs + threadIdx.x * kPerThread;
  o.n = o.t0 < Tp ? min(kPerThread, Tp - o.t0) : 0;
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    if (i < nt && o.n > 0) {
      const size_t off = (static_cast<size_t>(i) * bs + b) * Tp + o.t0;
      load4<kVec>(d + off, o.n, o.d[i]);
      load4<kVec>(g + off, o.n, o.g[i]);
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) o.d[i][k] = o.g[i][k] = 0.0f;
    }
  }
  int j = o.n > 0 ? o.t0 % B : 0;  // one 32-bit division per thread
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (k > 0 && ++j == B) j = 0;  // the group may straddle a tile edge
    o.j[k] = j;
  }
}

// Output k's window start t - j, and tap i's coordinates there.
__device__ __forceinline__ int window_start(const Outputs& o, int k) {
  return o.t0 + k - o.j[k];
}
__device__ __forceinline__ Tap tap(const Outputs& o, int i, int k, int Dm,
                                   int W) {
  return make_tap(o.d[i][k], o.g[i][k], o.j[k], o.t0 + k, Dm, W);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace frac_delay
