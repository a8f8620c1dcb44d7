// Kernel A in its forward use: the exact biquad cascade, last section's
// output only.
//
// Replaces: dasp_tpu/ops/pallas_iir.py, _sosfilt_wavefront_kernel (launched
// by _sosfilt_pallas_fwd_impl) with save_all=False. The kernel template, its
// bound on an H100 and its design are in sosfilt_cascade.cuh.

#include "sosfilt_cascade.cuh"

extern "C" int sosfilt_cascade_max_sections() { return dasp::kMaxSections; }

// samples per block: the caller sizes the scratch by it
extern "C" int sosfilt_cascade_tile() { return dasp::kTile; }

// sos: (rows, S, 6) fp32, x and y: (rows, T) fp32, all contiguous on the
// device; sync and states: the scratch of sosfilt_cascade.cuh. Launches on
// `stream` and returns the CUDA error as an int.
extern "C" int sosfilt_cascade_f32(const float* sos, const float* x, float* y,
                                   int rows, int S, long long T, int* sync,
                                   double* states, void* stream) {
  return dasp::launch_cascade<false, false>(sos, x, y, rows, S, T, sync, states,
                                            static_cast<cudaStream_t>(stream));
}
