// Kernel D: one streaming step of the exact biquad cascade on the coupled
// realization, sample by sample in float64.
//
// Replaces no TPU kernel: the JAX package's coupled cascade
// (dasp_tpu/ops/iir.py, sosfilt_coupled) is plain jnp, a block-state
// formulation that XLA fuses. In this port the same formulation
// (dasp_tpu_torch/ops/iir.py, _sosfilt_coupled_rows) issues about 30 small
// float64 operations a section, some 180 a chunk of the 6-section EQ, and
// that loop led the serving cells: the card idled while the host issued it.
// This kernel is the stream step's whole cascade in one launch.
//
// What it computes, for every row r of x (R, T) and section s = 0..S-1 in
// turn (section s's output is section s+1's input), with the realization
// of dasp_tpu_torch/ops/iir.py _coupled_state_space packed per (row,
// section) as real[9] = [A00, A01, A10, A11, b0, b1, c0, c1, d]:
//
//     y[n] = d u[n] + c . s[n-1]
//     s[n] = A s[n-1] + b u[n]
//
// from the carried state zi (R, S, 2) (null: from rest), returning the last
// section's output y (R, T) and the state after the last sample zf (R, S,
// 2). Arithmetic and state are float64; y and zf are rounded to the I/O
// type once, as the block-state path rounds them.
//
// What bounds it on an H100: the recursion. Each section's state is a chain
// of T dependent steps; the bytes (2 R T values) and the arithmetic (about
// 12 double operations a sample and section) are nothing for the card: the
// classic chain's 16 x 512 samples read and write 64 KB.
//
// What the design does about it: one warp a row, lane s holding section s's
// nine values and its two state values in registers, in a wavefront: at
// step k lane s filters sample k - s of the row, its input lane s-1's
// output of the step before, passed by __shfl_up_sync; lane 0 reads the
// row's samples from shared memory, where the warp staged a tile of them
// with coalesced loads, and lane S-1 writes the outputs there for one
// coalesced store. A tile of kTile samples takes kTile + S - 1 steps, each
// a shuffle and a few dependent double FMAs on the critical path: 0.034 ms
// for 512 samples and 6 sections on an H100 (about 115 cycles a step), at
// both 2 and 16 rows (R = 2 and 16 in the serving cells: a few warps on a
// few SMs). At most kMaxSections = 32 sections, a lane each (the wrapper's
// MAX_SECTIONS); the caller takes the block-state path for more.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxSections = kWarp;
constexpr int kRowsPerBlock = 4;  // a warp a row
constexpr int kTile = 512;        // samples staged per warp and tile
constexpr int kReal = 9;          // packed realization values per section
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kWarp* kRowsPerBlock)
    coupled_step_kernel(const double* __restrict__ real, const T* __restrict__ x, const double* __restrict__ zi,
                        T* __restrict__ y, T* __restrict__ zf, int rows, int S, long long n) {
  __shared__ T stage_in[kRowsPerBlock][kTile];
  __shared__ T stage_out[kRowsPerBlock][kTile];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves: nothing below syncs the block

  const bool on = lane < S;
  const long long sec = static_cast<long long>(row) * S + lane;
  double a00 = 0.0, a01 = 0.0, a10 = 0.0, a11 = 0.0, b0 = 0.0, b1 = 0.0, c0 = 0.0, c1 = 0.0, d = 0.0;
  double s0 = 0.0, s1 = 0.0;
  if (on) {
    const double* r = real + sec * kReal;
    a00 = r[0], a01 = r[1], a10 = r[2], a11 = r[3];
    b0 = r[4], b1 = r[5], c0 = r[6], c1 = r[7], d = r[8];
    if (zi != nullptr) {
      s0 = zi[2 * sec];
      s1 = zi[2 * sec + 1];
    }
  }

  T* in = stage_in[warp];
  T* out = stage_out[warp];
  const T* xr = x + row * n;
  T* yr = y + row * n;
  const int last = S - 1;
  for (long long t0 = 0; t0 < n; t0 += kTile) {
    const int len = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
    for (int i = lane; i < len; i += kWarp) in[i] = xr[t0 + i];
    __syncwarp();
    double prev = 0.0;                           // this lane's output of the step before
    double head = static_cast<double>(in[0]);    // the row's sample k, read a step ahead (all lanes: a broadcast)
    for (int k = 0; k < len + last; ++k) {
      const double up = __shfl_up_sync(kFull, prev, 1);
      const double u = lane == 0 ? head : up;
      head = k + 1 < len ? static_cast<double>(in[k + 1]) : 0.0;
      const int j = k - lane;  // the sample this lane filters at this step
      if (on && j >= 0 && j < len) {
        const double v = d * u + (c0 * s0 + c1 * s1);
        const double n0 = a00 * s0 + a01 * s1 + b0 * u;
        const double n1 = a10 * s0 + a11 * s1 + b1 * u;
        s0 = n0;
        s1 = n1;
        prev = v;
        if (lane == last) out[j] = static_cast<T>(v);
      }
    }
    __syncwarp();
    for (int i = lane; i < len; i += kWarp) yr[t0 + i] = out[i];
    __syncwarp();  // the next tile's staging overwrites in and out
  }
  if (on) {
    zf[2 * sec] = static_cast<T>(s0);
    zf[2 * sec + 1] = static_cast<T>(s1);
  }
}

template <typename T>
int launch(const double* real, const T* x, const double* zi, T* y, T* zf, int rows, int S, long long n,
           void* stream) {
  if (rows <= 0 || S <= 0 || S > kMaxSections || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  coupled_step_kernel<T><<<blocks, kWarp * kRowsPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      real, x, zi, y, zf, rows, S, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// real: (rows, S, 9) float64; x and y: (rows, n); zi: (rows, S, 2) float64,
// or null (rest); zf: (rows, S, 2); all contiguous on the device. Launches
// on `stream` and returns the CUDA error as an int.
extern "C" int sosfilt_coupled_step_f32(const double* real, const float* x, const double* zi, float* y, float* zf,
                                        int rows, int S, long long n, void* stream) {
  return launch<float>(real, x, zi, y, zf, rows, S, n, stream);
}

extern "C" int sosfilt_coupled_step_f64(const double* real, const double* x, const double* zi, double* y,
                                        double* zf, int rows, int S, long long n, void* stream) {
  return launch<double>(real, x, zi, y, zf, rows, S, n, stream);
}
