// Exact branching attack/release envelope smoother: the port of kernel B.
//
// Replaces: dasp_tpu/ops/pallas_ballistics.py, _fwd_kernel (launched by
// _fwd_impl). For each row of g (R, T):
//
//     alpha[n] = alpha_attack  if g[n] < y[n-1]  else alpha_release
//     y[n]     = (1 - alpha[n]) * g[n] + alpha[n] * y[n-1],   y[-1] = y0
//
// What bounds it on an H100: the same serial latency as the biquad cascade.
// Each sample's branch depends on the previous output, so a row is one chain
// of T compare-select-multiply-add steps; the compressor's 8 rows x 131072
// samples move 4 MB each way, which is nothing for HBM. 8 threads run on a
// 132-SM card. As for the biquad cascade, each thread also waits on its own
// loads: measured on an H100, 5.9 ms per call with g resident in L2, 6.4 ms
// inside the render. Staging chunks of the row ahead of the chain is the
// first step for a faster version.
//
// What the design does about it: one thread per row walks time in order
// with y[n-1] in a register and the two coefficients loaded once. The TPU
// kernel's time-major layout, 128-lane padding and 1024-sample VMEM blocks
// are not carried over: the row stays in its (R, T) row-major layout and T
// may have any length.
//
// The update is written with __fsub_rn / __fmul_rn / __fadd_rn so that the
// compiler cannot contract it into an FMA: every step rounds exactly as the
// plain loop (dasp_tpu/ops/iir.py ballistics_smooth mode="exact") does, and
// the result is bitwise equal to it. Chunked evaluation that hands the last
// output on as the next chunk's y0 is therefore bitwise equal to one pass.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void ballistics_kernel(const float* __restrict__ g,
                                  const float* __restrict__ alpha_attack,
                                  const float* __restrict__ alpha_release,
                                  const float* __restrict__ y0,
                                  float* __restrict__ y, int rows,
                                  long long T) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float aa = alpha_attack[r];
  const float ar = alpha_release[r];
  float y_prev = y0[r];
  const float* gr = g + static_cast<long long>(r) * T;
  float* yr = y + static_cast<long long>(r) * T;
#pragma unroll 4
  for (long long n = 0; n < T; ++n) {
    const float gn = gr[n];
    const float alpha = (gn < y_prev) ? aa : ar;
    y_prev = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, alpha), gn),
                       __fmul_rn(alpha, y_prev));
    yr[n] = y_prev;
  }
}

}  // namespace

// g and y: (rows, T) fp32; alpha_attack, alpha_release, y0: (rows,) fp32; all
// contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() as an int.
extern "C" int ballistics_f32(const float* g, const float* alpha_attack,
                              const float* alpha_release, const float* y0,
                              float* y, int rows, long long T, void* stream) {
  const int blocks = (rows + kThreads - 1) / kThreads;
  ballistics_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, alpha_attack, alpha_release, y0, y, rows, T);
  return static_cast<int>(cudaGetLastError());
}
