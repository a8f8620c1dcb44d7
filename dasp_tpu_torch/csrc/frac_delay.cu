// Banded time-varying fractional multi-tap delay, forward: the port of
// kernel C-fwd.
//
// Replaces: dasp_tpu/ops/pallas_interp.py, _fwd_kernel (launched by
// _fdp_fwd). For output sample t of tile k = t / B, with j = t - k*B and
// the tile's window win = x_ext[b, c, k*B : k*B + Dm + B):
//
//     r_i = (j + Dm) - d_i,  i0 = floor(r_i),  f = r_i - i0
//     wet[b, c, t] = sum_i gv_i * ((1 - f) * win[i0] + f * win[i0 + 1])
//
// with gv_i = g_i once t - d_i >= 0, else 0, and lattice points outside
// [0, Dm + B) read as zero.
//
// What bounds it on an H100: memory. Per output sample it reads nt delays
// and gains and 2 * nt window samples per channel and writes one sample per
// channel, about 35 MB at 8 x 2 x 131072 with two taps (0.021 ms measured
// on an H100 80GB HBM3 at a 700 W power limit, PERF.md); the window reads
// of neighbouring threads are neighbouring addresses for any smooth delay,
// so they coalesce, and the arithmetic is a few operations per read.
//
// What the design does about it: one thread per (b, t) computes each tap's
// coordinates once, in registers, and loops over the channels, so the
// delays and gains are read once for all channels. The TPU kernel's row
// plan (which 128-lane window rows can carry weight, and gates against
// counting a row twice) exists because a TPU vector unit evaluates hat
// weights over whole rows; here a thread reads its two lattice points
// directly, so work per sample is O(taps) for any window and no slope bound
// applies.

#include "frac_delay.cuh"

namespace {

using frac_delay::Tap;

__global__ void frac_delay_kernel(const float* __restrict__ x_ext,
                                  const float* __restrict__ d,
                                  const float* __restrict__ g,
                                  float* __restrict__ wet, int bs, int chs,
                                  int nt, long long Tp, int B, int Dm) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(bs) * Tp) return;
  const int b = static_cast<int>(idx / Tp);
  const long long t = idx - static_cast<long long>(b) * Tp;
  const int j = static_cast<int>(t % B);
  const long long start = t - j;
  const int W = Dm + B;
  const long long T_ext = Tp + Dm;

  Tap taps[frac_delay::kMaxTaps];
#pragma unroll
  for (int i = 0; i < frac_delay::kMaxTaps; ++i) {
    if (i < nt) {
      const long long o = (static_cast<long long>(i) * bs + b) * Tp + t;
      taps[i] = frac_delay::make_tap(d[o], g[o], j, t, Dm, W);
    }
  }
  for (int c = 0; c < chs; ++c) {
    const long long row = static_cast<long long>(b) * chs + c;
    const float* win = x_ext + row * T_ext + start;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < frac_delay::kMaxTaps; ++i) {
      if (i < nt) {
        const Tap& p = taps[i];
        const float v = frac_delay::interp(p, frac_delay::read0(win, p),
                                           frac_delay::read1(win, p));
        acc = __fadd_rn(acc, __fmul_rn(p.gv, v));
      }
    }
    wet[row * Tp + t] = acc;
  }
}

}  // namespace

// x_ext: (bs, chs, Dm + Tp); d, g: (nt, bs, Tp) with 1 <= nt <= 2 and Tp a
// multiple of B; wet: (bs, chs, Tp); all fp32, contiguous, on the device.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int frac_delay_f32(const float* x_ext, const float* d,
                              const float* g, float* wet, int bs, int chs,
                              int nt, long long Tp, int B, int Dm,
                              void* stream) {
  if (nt < 1 || nt > frac_delay::kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(bs) * Tp;
  const long long blocks =
      (n + frac_delay::kThreads - 1) / frac_delay::kThreads;
  frac_delay_kernel<<<static_cast<unsigned int>(blocks), frac_delay::kThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      x_ext, d, g, wet, bs, chs, nt, Tp, B, Dm);
  return static_cast<int>(cudaGetLastError());
}
