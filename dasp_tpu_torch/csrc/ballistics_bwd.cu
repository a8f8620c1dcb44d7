// Backward of the exact branching attack/release smoother: the port of
// kernel B-bwd.
//
// Replaces: dasp_tpu/ops/pallas_ballistics.py, _bwd_kernel (launched by
// _bwd_impl). For each row, with y the forward output, y[-1] = y0 and ct the
// cotangent of y, it walks time backward:
//
//     alpha[n]  = alpha_attack if g[n] < y[n-1] else alpha_release
//     lam[n]    = ct[n] + alpha[n+1] * lam[n+1]          (anticausal)
//     dg[n]     = (1 - alpha[n]) * lam[n]
//     dalpha[n] = lam[n] * y[n-1] - lam[n] * g[n]  -> daa or dar by branch
//     dy0       = alpha[0] * lam[0]
//
// What bounds it on an H100: the same serial latency as the forward. Each
// step needs lam[n+1], so a row is one chain of T steps; at the compressor's
// 8 rows x 131072 samples it reads 12 MB and writes 4 MB, nothing for HBM.
// 8 threads run on a 132-SM card, each also waiting on its own loads.
//
// What the design does about it: one thread per row, walking the row from
// T-1 down to 0 with lam, the two coefficient sums and the coefficients in
// registers; the branch is recomputed from the saved y (read
// one sample behind), so no mask is stored. The TPU kernel's time-major layout,
// 128-lane padding, reversed block index map and pre-shifted y_prev copy are
// not carried over: the rows stay (R, T) row-major and T may have any
// length.
//
// Every update is written with __fadd_rn / __fsub_rn / __fmul_rn in the
// order of the plain loop (dasp_tpu_torch/ops/ballistics_kernel.py
// ballistics_bwd_rows_plain), so the compiler cannot contract it into an
// FMA and the result is bitwise equal to that loop, which in turn rounds as
// autograd does through the plain forward: dalpha is the sum of the two
// products (lam * y[n-1]) and -(lam * g[n]) that autograd forms, not the
// (y[n-1] - g[n]) * lam of the TPU kernel (equal in exact arithmetic), and
// daa and dar are serial fp32 sums from T-1 down to 0, as autograd and the
// TPU kernel accumulate them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void ballistics_bwd_kernel(const float* __restrict__ y,
                                      const float* __restrict__ g,
                                      const float* __restrict__ alpha_attack,
                                      const float* __restrict__ alpha_release,
                                      const float* __restrict__ y0,
                                      const float* __restrict__ ct,
                                      float* __restrict__ dg,
                                      float* __restrict__ daa,
                                      float* __restrict__ dar,
                                      float* __restrict__ dy0, int rows,
                                      long long T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float aa = alpha_attack[r];
  const float ar = alpha_release[r];
  const long long off = static_cast<long long>(r) * T;
  const float* yr = y + off;
  const float* gr = g + off;
  const float* ctr = ct + off;
  float* dgr = dg + off;
  float lam_next = 0.f;  // alpha[n+1] * lam[n+1]
  float acc_a = 0.f;
  float acc_r = 0.f;
#pragma unroll 4
  for (long long n = T - 1; n >= 0; --n) {
    const float gn = gr[n];
    const float y_prev = n > 0 ? yr[n - 1] : y0[r];
    const bool attack = gn < y_prev;
    const float alpha = attack ? aa : ar;
    const float lam = __fadd_rn(ctr[n], lam_next);
    dgr[n] = __fmul_rn(__fsub_rn(1.0f, alpha), lam);
    const float dalpha = __fsub_rn(__fmul_rn(lam, y_prev), __fmul_rn(lam, gn));
    if (attack) {
      acc_a = __fadd_rn(acc_a, dalpha);
    } else {
      acc_r = __fadd_rn(acc_r, dalpha);
    }
    lam_next = __fmul_rn(alpha, lam);
  }
  daa[r] = acc_a;
  dar[r] = acc_r;
  dy0[r] = lam_next;
}

}  // namespace

// y, g, ct and dg: (rows, T) fp32; alpha_attack, alpha_release, y0, daa, dar
// and dy0: (rows,) fp32; all contiguous on the device. Launches on `stream`
// and returns cudaGetLastError() as an int.
extern "C" int ballistics_bwd_f32(const float* y, const float* g,
                                  const float* alpha_attack,
                                  const float* alpha_release, const float* y0,
                                  const float* ct, float* dg, float* daa,
                                  float* dar, float* dy0, int rows, long long T,
                                  void* stream) {
  const int blocks = (rows + kThreads - 1) / kThreads;
  ballistics_bwd_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      y, g, alpha_attack, alpha_release, y0, ct, dg, daa, dar, dy0, rows, T);
  return static_cast<int>(cudaGetLastError());
}
