// Exact biquad-cascade filter over rows: the kernel template shared by the
// three uses of kernel A: forward (sosfilt_cascade.cu), save-all forward
// (sosfilt_cascade_save_all.cu) and adjoint (sosfilt_cascade_adjoint.cu).
//
// Replaces: dasp_tpu/ops/pallas_iir.py, _sosfilt_wavefront_kernel. Every row
// r of x (R, T) runs through S second-order sections [b0, b1, b2, a0(=1),
// a1, a2], section after section, with zero initial state.
//
// What bounds it on an H100: the serial chain of T * S dependent
// multiply-adds per row. Bytes are not the limit: the style-transfer EQ reads
// and writes 8 rows x 131072 samples x 4 B = 4 MB each way, a microsecond of
// HBM bandwidth. With only R = bs * ch = 8 rows, 8 threads run on a 132-SM
// card, so nearly all of the chip idles. Measured on an H100, the kernel
// also waits on each thread's own loads: 7.9 ms per call with x resident in
// L2, 10.4 ms inside the render, where the encoder has likely pushed x out
// of L2. The arithmetic chain alone (per sample, S sections of about two
// dependent FMAs of 4 cycles) is an estimated third of that.
//
// What the design does about it: one thread owns one row and walks its
// samples in order. All S sections advance on each sample, in direct form I
// (y = b0 x + b1 x[-1] + b2 x[-2] - a1 y[-1] - a2 y[-2], as in
// dasp_tpu/ops/iir.py _sos_section_exact), with the coefficients loaded once
// and the 4 history samples of every section held in registers (S is a
// template parameter, so the section loop unrolls and nothing spills to
// local memory). Only x is read and y written; T may have any
// length and nothing is padded. The TPU kernel's 128x128 Toeplitz blocks,
// (8, 128) padding and wavefront ring are not carried over: they fed the
// TPU's matrix unit, and here the recursion is cheaper evaluated directly.
//
// SAVE_ALL writes every section's output, y (S, R, T), as the TPU kernel's
// save_all=True does: the forward residuals of the backward pass, and in the
// adjoint use every lambda and dL/dx at once. REVERSE walks time from T-1
// down to 0 (sample i of the recursion reads and writes index T-1-i): the
// adjoint cascade runs in flipped time, and walking backward saves the two
// flips the TPU wrapper materializes. Both are template parameters: with the
// direction a runtime value the forward ran at 12.0 ms instead of 7.9 ms on
// an H100 (8 x 131072, 6 sections).
//
// The sum is formed with FMA contraction, so it rounds differently from the
// block-Toeplitz evaluation; callers hold it against float64.

#pragma once

#include <cuda_runtime.h>

namespace dasp {

constexpr int kCascadeThreads = 32;
// Largest section count with an instantiated kernel; the wrapper checks it.
constexpr int kMaxSections = 16;

template <int S, bool SAVE_ALL, bool REVERSE>
__global__ void sosfilt_cascade_kernel(const float* __restrict__ sos,
                                       const float* __restrict__ x,
                                       float* __restrict__ y,
                                       int rows, long long T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;

  float b0[S], b1[S], b2[S], a1[S], a2[S];
  float xm1[S], xm2[S], ym1[S], ym2[S];
  const float* c = sos + static_cast<long long>(r) * S * 6;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    b0[s] = c[6 * s + 0];
    b1[s] = c[6 * s + 1];
    b2[s] = c[6 * s + 2];
    a1[s] = c[6 * s + 4];
    a2[s] = c[6 * s + 5];
    xm1[s] = 0.f;
    xm2[s] = 0.f;
    ym1[s] = 0.f;
    ym2[s] = 0.f;
  }

  const long long row_off = static_cast<long long>(r) * T;
  const long long section_stride = static_cast<long long>(rows) * T;
  const float* xr = x + row_off;
  float* yr = y + row_off;
#pragma unroll 4
  for (long long i = 0; i < T; ++i) {
    const long long t = REVERSE ? T - 1 - i : i;
    float v = xr[t];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float out = b0[s] * v + b1[s] * xm1[s] + b2[s] * xm2[s]
                        - a1[s] * ym1[s] - a2[s] * ym2[s];
      xm2[s] = xm1[s];
      xm1[s] = v;
      ym2[s] = ym1[s];
      ym1[s] = out;
      v = out;
      if (SAVE_ALL) yr[s * section_stride + t] = out;
    }
    if (!SAVE_ALL) yr[t] = v;
  }
}

// sos: (rows, S, 6); x: (rows, T); y: (rows, T), or (S, rows, T) with
// SAVE_ALL; all fp32 and contiguous on the device. Launches on `stream` and
// returns cudaGetLastError() as an int.
template <bool SAVE_ALL, bool REVERSE>
int launch_cascade(const float* sos, const float* x, float* y, int rows, int S,
                   long long T, cudaStream_t stream) {
  const int blocks = (rows + kCascadeThreads - 1) / kCascadeThreads;
  switch (S) {
#define DASP_CASE(n)                                                        \
  case n:                                                                   \
    sosfilt_cascade_kernel<n, SAVE_ALL, REVERSE>                            \
        <<<blocks, kCascadeThreads, 0, stream>>>(sos, x, y, rows, T);       \
    break;
    DASP_CASE(1) DASP_CASE(2) DASP_CASE(3) DASP_CASE(4)
    DASP_CASE(5) DASP_CASE(6) DASP_CASE(7) DASP_CASE(8)
    DASP_CASE(9) DASP_CASE(10) DASP_CASE(11) DASP_CASE(12)
    DASP_CASE(13) DASP_CASE(14) DASP_CASE(15) DASP_CASE(16)
#undef DASP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dasp
