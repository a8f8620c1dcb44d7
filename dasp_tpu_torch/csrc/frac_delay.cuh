// Shared coordinates of the fractional-delay kernels (frac_delay.cu,
// frac_delay_bwd.cu). See dasp_tpu_torch/ops/frac_delay_kernel.py for the
// contract and the plain PyTorch version they are held against.
//
// Every rounding step is written with __fadd_rn / __fsub_rn / __fmul_rn in
// the order of the plain version, so the compiler cannot contract it into
// an FMA and the forward is bitwise equal to that version.

#pragma once

#include <cuda_runtime.h>

namespace frac_delay {

constexpr int kMaxTaps = 2;
constexpr int kThreads = 256;

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
__device__ __forceinline__ Tap make_tap(float d, float g, int j, long long t,
                                        int Dm, int W) {
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

// The two lattice points of tap p in a window row (0 outside [0, W)).
__device__ __forceinline__ float read0(const float* win, const Tap& p) {
  return p.v0 ? win[p.i0] : 0.0f;
}
__device__ __forceinline__ float read1(const float* win, const Tap& p) {
  return p.v1 ? win[p.i0 + 1] : 0.0f;
}

// (1 - f) * x0 + f * x1
__device__ __forceinline__ float interp(const Tap& p, float x0, float x1) {
  return __fadd_rn(__fmul_rn(p.w0, x0), __fmul_rn(p.f, x1));
}

}  // namespace frac_delay
