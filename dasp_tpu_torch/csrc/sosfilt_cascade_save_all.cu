// Kernel A in its save-all use: the exact biquad cascade writing every
// section's output, the forward residuals of the backward pass.
//
// Replaces: _rows_fwd (dasp_tpu/ops/pallas_iir.py:254), which launches
// _sosfilt_wavefront_kernel with save_all=True and keeps each section's
// output (S, R, T). The kernel template, its bound on an H100 and its design
// are in sosfilt_cascade.cuh: each section's output is staged in the block's
// tile and stored as one coalesced plane, 25 MB for the EQ's 6 sections at
// 8 x 131072 (7.5 us at 3.35 TB/s).

#include "sosfilt_cascade.cuh"

// sos: (rows, S, 6) fp32, x: (rows, T) fp32, y: (S, rows, T) fp32, all
// contiguous on the device; sync and states: the scratch of
// sosfilt_cascade.cuh. Launches on `stream` and returns the CUDA error as an
// int.
extern "C" int sosfilt_cascade_save_all_f32(const float* sos, const float* x,
                                            float* y, int rows, int S,
                                            long long T, int* sync,
                                            double* states, void* stream) {
  return dasp::launch_cascade<true, false>(sos, x, y, rows, S, T, sync, states,
                                           static_cast<cudaStream_t>(stream));
}
