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
// What bounds it on an H100: memory, as the forward, plus the scattered
// read-modify-writes of dx. Each output sample adds to two window samples
// per tap and channel, and samples of one tile and of neighbouring tiles
// add to the same window samples (the windows of consecutive tiles overlap
// by Dm samples).
//
// What the design does about it: one thread per (b, t) computes dd and dg
// for its own sample in registers, in a fixed order (no atomics, so dd and
// dg are bitwise reproducible from run to run). dx goes to device memory by
// atomicAdd, so its sums are taken in an order that changes from run to
// run: dx is not bitwise reproducible. The TPU kernel keeps dx in VMEM and
// walks the tiles of one item in order, which a card's unordered blocks
// cannot do. dx is skipped when the caller passes a null pointer (the
// audio needs no gradient in an estimation step).

#include "frac_delay.cuh"

namespace {

using frac_delay::Tap;

__global__ void frac_delay_bwd_kernel(
    const float* __restrict__ x_ext, const float* __restrict__ d,
    const float* __restrict__ g, const float* __restrict__ ct,
    float* __restrict__ dx, float* __restrict__ dd, float* __restrict__ dg,
    int bs, int chs, int nt, long long Tp, int B, int Dm) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(bs) * Tp) return;
  const int b = static_cast<int>(idx / Tp);
  const long long t = idx - static_cast<long long>(b) * Tp;
  const int j = static_cast<int>(t % B);
  const long long start = t - j;
  const int W = Dm + B;
  const long long T_ext = Tp + Dm;

#pragma unroll
  for (int i = 0; i < frac_delay::kMaxTaps; ++i) {
    if (i >= nt) break;
    const long long o = (static_cast<long long>(i) * bs + b) * Tp + t;
    const Tap p = frac_delay::make_tap(d[o], g[o], j, t, Dm, W);
    float dd_acc = 0.0f;
    float dg_acc = 0.0f;
    for (int c = 0; c < chs; ++c) {
      const long long row = static_cast<long long>(b) * chs + c;
      const float* win = x_ext + row * T_ext + start;
      const float ctv = ct[row * Tp + t];
      const float x0 = frac_delay::read0(win, p);
      const float x1 = frac_delay::read1(win, p);
      const float cg = __fmul_rn(ctv, p.gv);
      dg_acc = __fadd_rn(dg_acc, __fmul_rn(__fmul_rn(ctv, p.mask),
                                           frac_delay::interp(p, x0, x1)));
      if (p.f != 0.0f) {
        dd_acc = __fadd_rn(dd_acc, __fmul_rn(cg, __fsub_rn(x1, x0)));
      }
      if (dx != nullptr) {
        float* dwin = dx + row * T_ext + start;
        if (p.v0) atomicAdd(dwin + p.i0, __fmul_rn(cg, p.w0));
        if (p.v1) atomicAdd(dwin + p.i0 + 1, __fmul_rn(cg, p.f));
      }
    }
    dd[o] = -dd_acc;
    dg[o] = dg_acc;
  }
}

}  // namespace

// x_ext: (bs, chs, Dm + Tp); d, g, dd, dg: (nt, bs, Tp) with 1 <= nt <= 2;
// ct: (bs, chs, Tp); dx: like x_ext and zeroed by the caller, or null to
// skip it; all fp32, contiguous, on the device. Launches on `stream` and
// returns cudaGetLastError() as an int.
extern "C" int frac_delay_bwd_f32(const float* x_ext, const float* d,
                                  const float* g, const float* ct, float* dx,
                                  float* dd, float* dg, int bs, int chs,
                                  int nt, long long Tp, int B, int Dm,
                                  void* stream) {
  if (nt < 1 || nt > frac_delay::kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(bs) * Tp;
  const long long blocks =
      (n + frac_delay::kThreads - 1) / frac_delay::kThreads;
  frac_delay_bwd_kernel<<<static_cast<unsigned int>(blocks),
                          frac_delay::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x_ext, d, g, ct, dx, dd, dg, bs, chs, nt, Tp, B, Dm);
  return static_cast<int>(cudaGetLastError());
}
