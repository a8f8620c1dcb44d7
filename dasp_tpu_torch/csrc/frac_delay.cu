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
// What bounds it on an H100: bytes. Per output sample it reads nt delays
// and gains, 2 * nt window samples per channel, and writes one sample per
// channel. At the blind path's 8 x 1 x 131072 with two taps the delays and
// gains are 16.8 MB of the 25.3 MB moved (x 4.3 MB, wet 4.2 MB), so their
// streams set the bound (7.5 us at 3.35 TB/s); the gathers from x are
// neighbouring addresses for any smooth delay and hit L1.
//
// What the design does about it (frac_delay.cuh): one row per blockIdx.y
// and four consecutive outputs per thread (8 x 128 blocks of 256 threads at
// the blind shape; 44-46 registers, five blocks to an SM), each thread with
// its four delays and gains per tap in flight as 16-byte loads before it
// forms any address of x, and the coordinates formed where they are used
// (precomputed for all four outputs they took about 100 registers and
// halved the resident blocks); 32-bit index arithmetic inside the row (the
// card has no 64-bit divider); 16-byte stores of wet. x is not staged in
// shared memory: it is a sixth of the bytes and L1 serves the neighbouring
// reads. The TPU kernel's row plan (which 128-lane window rows can carry
// weight) exists because a TPU vector unit evaluates hat weights over whole
// rows; here a thread reads its two lattice points directly, so work per
// sample is O(taps) for any window and no slope bound applies.

#include "frac_delay.cuh"

namespace {

using frac_delay::kMaxTaps;
using frac_delay::kPerThread;

template <bool kVec>
__global__ void __launch_bounds__(frac_delay::kThreads)
    frac_delay_kernel(const float* __restrict__ x_ext,
                      const float* __restrict__ d, const float* __restrict__ g,
                      float* __restrict__ wet, int bs, int chs, int nt, int Tp,
                      int B, int Dm) {
  frac_delay::Outputs o;
  frac_delay::load_outputs<kVec>(d, g, bs, nt, Tp, B, o);
  if (o.n == 0) return;
  const int T_ext = Tp + Dm;
  const int W = Dm + B;
  for (int c = 0; c < chs; ++c) {
    const size_t row = static_cast<size_t>(blockIdx.y) * chs + c;
    const float* xr = x_ext + row * T_ext;
    float acc[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      acc[k] = 0.0f;
      const float* win = xr + frac_delay::window_start(o, k);
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
        if (i < nt && k < o.n) {
          const frac_delay::Tap p = frac_delay::tap(o, i, k, Dm, W);
          const float v = frac_delay::interp(p, frac_delay::read0(win, p),
                                             frac_delay::read1(win, p));
          acc[k] = __fadd_rn(acc[k], __fmul_rn(p.gv, v));
        }
      }
    }
    frac_delay::store4<kVec>(wet + row * Tp + o.t0, o.n, acc);
  }
}

}  // namespace

// x_ext: (bs, chs, Dm + Tp); d, g: (nt, bs, Tp) with 1 <= nt <= 2 and Tp a
// multiple of B; wet: (bs, chs, Tp); all fp32, contiguous, on the device;
// Tp + Dm < 2^31 and bs < 65536. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int frac_delay_f32(const float* x_ext, const float* d,
                              const float* g, float* wet, int bs, int chs,
                              int nt, long long Tp, int B, int Dm,
                              void* stream) {
  if (nt < 1 || nt > kMaxTaps || bs < 1 || bs > 65535 || B < 1 || Dm < 0 ||
      Tp + Dm >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tp = static_cast<int>(Tp);
  if (tp == 0) return 0;
  const dim3 grid((tp + frac_delay::kBlockOutputs - 1) / frac_delay::kBlockOutputs, bs);
  const bool vec = tp % 4 == 0 && frac_delay::aligned16(d) &&
                   frac_delay::aligned16(g) && frac_delay::aligned16(wet);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    frac_delay_kernel<true><<<grid, frac_delay::kThreads, 0, s>>>(
        x_ext, d, g, wet, bs, chs, nt, tp, B, Dm);
  } else {
    frac_delay_kernel<false><<<grid, frac_delay::kThreads, 0, s>>>(
        x_ext, d, g, wet, bs, chs, nt, tp, B, Dm);
  }
  return static_cast<int>(cudaGetLastError());
}
