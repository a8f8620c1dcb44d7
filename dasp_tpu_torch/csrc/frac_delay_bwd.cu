// Banded time-varying fractional multi-tap delay, backward: the port of
// kernel C-bwd.
//
// Replaces: dasp_tpu/ops/pallas_interp.py, _bwd_kernel (launched by
// _fdp_bwd). With the forward's coordinates (frac_delay.cu) and ct the
// cotangent of wet, per output sample t and tap i:
//
//     dd_i[b, t] = -sum_c ct * gv_i * (win[i0 + 1] - win[i0])  (0 at f == 0)
//     dg_i[b, t] =  sum_c ct * mask_i * ((1 - f) win[i0] + f win[i0 + 1])
//     dx[b, c, k*B + i0]     += ct * gv_i * (1 - f)
//     dx[b, c, k*B + i0 + 1] += ct * gv_i * f
//
// At an exact integer read position (f == 0) the dd term is dropped, as the
// TPU kernel's sign(0) = 0 drops it.
//
// What bounds it on an H100: bytes, as the forward: delays, gains and the
// cotangent stream in, dd and dg stream out. When dx is asked for, each
// output adds to two window samples per tap and channel, and the windows of
// neighbouring outputs and tiles overlap, so dx goes to device memory as
// atomics (the TPU kernel keeps dx in VMEM and walks the tiles of one item
// in order, which a card's unordered blocks cannot do).
//
// What the design does about it. Without dx (an estimation step: the audio
// needs no gradient), frac_delay_bwd_kernel takes the forward's tiling
// (frac_delay.cuh): 16-byte loads of d, g and ct, 16-byte stores of dd and
// dg, the channel loop run once for both taps from one read of ct and of
// the window. With dx, frac_delay_bwd_dx_kernel takes one output per thread,
// so that each warp's atomic instructions cover 32 consecutive outputs,
// fire and forget into L2, and the kernel keeps the registers of a single
// output: the four-output form spends 117-124 registers on dx (two blocks to
// an SM) and, with a shared-memory buffer for dx, pays a compare-and-swap
// loop per float atomic; both were slower (PERF.md). In both kernels each
// tap keeps its own dd and dg accumulators, summed over channels in channel
// order with no atomics, so dd and dg are bitwise equal to the plain engine
// and from run to run; dx is summed in an order that changes from run to
// run, so it is not.

#include "frac_delay.cuh"

namespace {

using frac_delay::kBlockOutputs;
using frac_delay::kMaxTaps;
using frac_delay::kPerThread;
using frac_delay::kThreads;

template <bool kVec>
__global__ void __launch_bounds__(kThreads) frac_delay_bwd_kernel(
    const float* __restrict__ x_ext, const float* __restrict__ d,
    const float* __restrict__ g, const float* __restrict__ ct,
    float* __restrict__ dd, float* __restrict__ dg, int bs, int chs, int nt,
    int Tp, int B, int Dm) {
  frac_delay::Outputs o;
  frac_delay::load_outputs<kVec>(d, g, bs, nt, Tp, B, o);
  if (o.n == 0) return;
  const int T_ext = Tp + Dm;
  const int W = Dm + B;
  float dd_acc[kMaxTaps][kPerThread];
  float dg_acc[kMaxTaps][kPerThread];
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) dd_acc[i][k] = dg_acc[i][k] = 0.0f;
  }
  for (int c = 0; c < chs; ++c) {
    const size_t row = static_cast<size_t>(blockIdx.y) * chs + c;
    const float* xr = x_ext + row * T_ext;
    float ctv[kPerThread];
    frac_delay::load4<kVec>(ct + row * Tp + o.t0, o.n, ctv);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const float* win = xr + frac_delay::window_start(o, k);
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
        if (i < nt && k < o.n) {
          const frac_delay::Tap p = frac_delay::tap(o, i, k, Dm, W);
          const float x0 = frac_delay::read0(win, p);
          const float x1 = frac_delay::read1(win, p);
          dg_acc[i][k] =
              __fadd_rn(dg_acc[i][k], __fmul_rn(__fmul_rn(ctv[k], p.mask),
                                                frac_delay::interp(p, x0, x1)));
          if (p.f != 0.0f) {
            dd_acc[i][k] = __fadd_rn(
                dd_acc[i][k],
                __fmul_rn(__fmul_rn(ctv[k], p.gv), __fsub_rn(x1, x0)));
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    if (i < nt) {
      const size_t off = (static_cast<size_t>(i) * bs + blockIdx.y) * Tp + o.t0;
      float neg[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) neg[k] = -dd_acc[i][k];
      frac_delay::store4<kVec>(dd + off, o.n, neg);
      frac_delay::store4<kVec>(dg + off, o.n, dg_acc[i]);
    }
  }
}

// One output per thread, dx by atomics; grid (ceil(Tp / kThreads), bs).
__global__ void __launch_bounds__(kThreads) frac_delay_bwd_dx_kernel(
    const float* __restrict__ x_ext, const float* __restrict__ d,
    const float* __restrict__ g, const float* __restrict__ ct,
    float* __restrict__ dx, float* __restrict__ dd, float* __restrict__ dg,
    int bs, int chs, int nt, int Tp, int B, int Dm) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= Tp) return;
  const int j = t % B;
  const int start = t - j;
  const int T_ext = Tp + Dm;
  const int W = Dm + B;
  frac_delay::Tap taps[kMaxTaps];
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    if (i < nt) {
      const size_t off = (static_cast<size_t>(i) * bs + blockIdx.y) * Tp + t;
      taps[i] = frac_delay::make_tap(__ldg(d + off), __ldg(g + off), j, t, Dm, W);
    }
  }
  float dd_acc[kMaxTaps] = {0.0f, 0.0f};
  float dg_acc[kMaxTaps] = {0.0f, 0.0f};
  for (int c = 0; c < chs; ++c) {
    const size_t row = static_cast<size_t>(blockIdx.y) * chs + c;
    const float* win = x_ext + row * T_ext + start;
    float* dwin = dx + row * T_ext + start;
    const float ctv = __ldg(ct + row * Tp + t);
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      if (i < nt) {
        const frac_delay::Tap& p = taps[i];
        const float x0 = frac_delay::read0(win, p);
        const float x1 = frac_delay::read1(win, p);
        const float cg = __fmul_rn(ctv, p.gv);
        dg_acc[i] = __fadd_rn(dg_acc[i], __fmul_rn(__fmul_rn(ctv, p.mask),
                                                   frac_delay::interp(p, x0, x1)));
        if (p.f != 0.0f) {
          dd_acc[i] = __fadd_rn(dd_acc[i], __fmul_rn(cg, __fsub_rn(x1, x0)));
        }
        if (p.v0) atomicAdd(dwin + p.i0, __fmul_rn(cg, p.w0));
        if (p.v1) atomicAdd(dwin + p.i0 + 1, __fmul_rn(cg, p.f));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    if (i < nt) {
      const size_t off = (static_cast<size_t>(i) * bs + blockIdx.y) * Tp + t;
      dd[off] = -dd_acc[i];
      dg[off] = dg_acc[i];
    }
  }
}

}  // namespace

// x_ext: (bs, chs, Dm + Tp); d, g, dd, dg: (nt, bs, Tp) with 1 <= nt <= 2;
// ct: (bs, chs, Tp); dx: like x_ext and zeroed by the caller, or null to
// skip it; all fp32, contiguous, on the device; Tp + Dm < 2^31 and
// bs < 65536. Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int frac_delay_bwd_f32(const float* x_ext, const float* d,
                                  const float* g, const float* ct, float* dx,
                                  float* dd, float* dg, int bs, int chs,
                                  int nt, long long Tp, int B, int Dm,
                                  void* stream) {
  if (nt < 1 || nt > kMaxTaps || bs < 1 || bs > 65535 || B < 1 || Dm < 0 ||
      Tp + Dm >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tp = static_cast<int>(Tp);
  if (tp == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dx != nullptr) {
    const dim3 grid((tp + kThreads - 1) / kThreads, bs);
    frac_delay_bwd_dx_kernel<<<grid, kThreads, 0, s>>>(x_ext, d, g, ct, dx, dd, dg,
                                                       bs, chs, nt, tp, B, Dm);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((tp + kBlockOutputs - 1) / kBlockOutputs, bs);
  const bool vec = tp % 4 == 0 && frac_delay::aligned16(d) &&
                   frac_delay::aligned16(g) && frac_delay::aligned16(ct) &&
                   frac_delay::aligned16(dd) && frac_delay::aligned16(dg);
  if (vec) {
    frac_delay_bwd_kernel<true><<<grid, kThreads, 0, s>>>(x_ext, d, g, ct, dd, dg,
                                                          bs, chs, nt, tp, B, Dm);
  } else {
    frac_delay_bwd_kernel<false><<<grid, kThreads, 0, s>>>(x_ext, d, g, ct, dd, dg,
                                                           bs, chs, nt, tp, B, Dm);
  }
  return static_cast<int>(cudaGetLastError());
}
