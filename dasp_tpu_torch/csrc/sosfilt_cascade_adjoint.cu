// Kernel A in its adjoint use: the backward of the exact biquad cascade.
//
// Replaces: _rows_bwd (dasp_tpu/ops/pallas_iir.py:259-317), one save-all
// launch of _sosfilt_wavefront_kernel over the (S+1)-section adjoint cascade
// on the time-flipped cotangent, which yields every section's adjoint lambda
// and dL/dx at once (the wrapper builds the adjoint sections and takes the
// coefficient gradients as correlations). Here the same kernel template
// walks time backward instead (REVERSE): its tiles and chunks run from the
// end of the row, the carry from the last chunk, so the cotangent and the
// (S+1, R, T) result stay in forward time and nothing is flipped in memory.
// The template, its bound on an H100 and its design are in
// sosfilt_cascade.cuh: the EQ's 7-section adjoint at 8 x 131072 moves
// 33.6 MB, 10 us at 3.35 TB/s.

#include "sosfilt_cascade.cuh"

// sos: (rows, S, 6) fp32 adjoint sections, g: (rows, T) fp32 cotangent,
// y: (S, rows, T) fp32, all contiguous on the device; sync and states: the
// scratch of sosfilt_cascade.cuh; section s of the recursion runs from
// t = T-1 down to 0. Launches on `stream` and returns the CUDA error as an
// int.
extern "C" int sosfilt_cascade_adjoint_f32(const float* sos, const float* g,
                                           float* y, int rows, int S,
                                           long long T, int* sync,
                                           double* states, void* stream) {
  return dasp::launch_cascade<true, true>(sos, g, y, rows, S, T, sync, states,
                                          static_cast<cudaStream_t>(stream));
}
