// Backward of the exact branching attack/release smoother: the port of
// kernel B-bwd.
//
// Replaces: dasp_tpu/ops/pallas_ballistics.py, _bwd_kernel (launched by
// _bwd_impl). For each row, with y the forward output, y[-1] = y0 and ct the
// cotangent of y, the adjoint runs anticausally:
//
//     alpha[n]  = alpha_attack if g[n] < y[n-1] else alpha_release
//     lam[n]    = ct[n] + q[n+1],   q[n] = alpha[n] * lam[n],   q[T] = 0
//     dg[n]     = (1 - alpha[n]) * lam[n]
//     dalpha[n] = lam[n] * (y[n-1] - g[n])   -> daa or dar by branch
//     dy0       = q[0]
//
// What bounds it on an H100: bytes. At the compressor's 8 rows x 131072
// samples it reads y, g and ct (12.6 MB) and writes dg (4.2 MB): 5.0 us at
// 3.35 TB/s. Walked by one thread per row from T-1 down to 0 (the design
// this file had first) it kept 8 threads busy and took 9.2 ms.
//
// What the design does about it: once y is known every branch is fixed, so
// q is a linear first-order recursion in reverse time, q_in -> P q_in + z
// over any stretch of samples, and it takes kernel A's chunked scan
// (sosfilt_cascade.cuh) with a 1x1 carry instead of a 2x2 one. The tiling
// is ballistics.cuh's, walked from the end of the row as A's REVERSE walks
// it: tile tau, chunk j and sample k hold reverse-time index
// m = tau * 8192 + 32 j + k, forward time n = T - 1 - m. Per block:
//
//  1. stage the tile's g, ct and y[n-1] (y0 at n = 0) through shared memory
//     with coalesced loads; the branches are recomputed from y, so no mask
//     is stored;
//  2. zero-state pass: each thread walks its chunk backward in float64 from
//     q = 0, giving its chunk's map (P = product of its alphas, z = q at
//     its first sample);
//  3. carry: a warp scans its 32 maps by shuffles, (P', z') after (P, z) =
//     (P' P, P' z + z'); one thread chains the 8 warp totals from the q
//     entering the tile and publishes the q leaving it for the next tile
//     back in time, whose block waits for it (tile numbers from an atomic
//     counter in start order, so a block only waits on one that runs or
//     has run);
//  4. fix-up: each thread walks its chunk again from its true q, writing
//     dg = (1 - alpha) lam, computed in float64 and rounded once, and
//     summing the terms lam (y[n-1] - g[n]) by branch in float64; the
//     thread holding n = 0 writes dy0.
//
// The sums: a block adds its threads' sums in a fixed order (warp
// butterflies, then warp 0..7) and stores one float64 pair per tile; the
// row's last block to finish (an atomic count per row) adds the row's pairs
// in tile order and writes daa and dar. So daa and dar are bitwise equal
// from run to run, with no float atomics.
//
// Numerics: everything runs in float64 and each result is rounded to fp32
// once, so the kernel is not bitwise equal to the fp32 reverse loop
// (ballistics_bwd_rows_plain in fp32, which rounds every step as autograd
// does) but closer to float64: callers hold it against that loop run on
// float64 copies of the same inputs, whose branches are the kernel's.
//
// Scratch, allocated by the caller: `sync`, 1 + rows * ntiles + rows ints,
// zeroed (the tile counter; per tile whether its outgoing q is published;
// per row the blocks finished), and `states`, 3 * rows * ntiles doubles
// (per tile the outgoing q, then per tile the two branch sums).

#include "ballistics.cuh"

namespace {

using namespace dasp;
using namespace dasp::ballistics;

// the tiles of g, ct and y[n-1]
constexpr int kSmemBytes = 3 * kTileFloats * static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(kThreads)
ballistics_bwd_kernel(const float* __restrict__ y, const float* __restrict__ g,
                      const float* __restrict__ alpha_attack,
                      const float* __restrict__ alpha_release, const float* __restrict__ y0,
                      const float* __restrict__ ct, float* __restrict__ dg,
                      float* __restrict__ daa, float* __restrict__ dar,
                      float* __restrict__ dy0, int rows, long long T, int ntiles,
                      int* __restrict__ sync, double* __restrict__ states) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;
  float* cs = gs + kTileFloats;  // ct, then dg
  float* ys = cs + kTileFloats;  // y[n-1]
  __shared__ double2 warp_total[kWarps];
  __shared__ double warp_state[kWarps];
  __shared__ double2 warp_sum[kWarps];
  __shared__ int tile_id;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  if (tid == 0) tile_id = atomicAdd(sync, 1);
  __syncthreads();
  const int r = tile_id % rows;
  const int tau = tile_id / rows;
  const long long tiles = static_cast<long long>(rows) * ntiles;
  int* flags = sync + 1 + static_cast<long long>(r) * ntiles;
  int* row_done = sync + 1 + tiles + r;
  double* carry = states + static_cast<long long>(r) * ntiles;
  double* sums = states + tiles + 2 * static_cast<long long>(r) * ntiles;
  const double aa = alpha_attack[r];
  const double ar = alpha_release[r];
  const long long off = static_cast<long long>(r) * T;
  const long long m0 = static_cast<long long>(tau) * kTile;

  // 1. stage; past the row's start (n < 0) everything reads zero
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const int s = i * kThreads + tid;
    const long long n = T - 1 - (m0 + s);
    const bool ok = n >= 0;
    gs[padded(s)] = ok ? g[off + n] : 0.f;
    cs[padded(s)] = ok ? ct[off + n] : 0.f;
    ys[padded(s)] = n > 0 ? y[off + n - 1] : (n == 0 ? y0[r] : 0.f);
  }
  __syncthreads();
  const int base = tid * (kChunk + 1);
  const long long m_first = m0 + static_cast<long long>(tid) * kChunk;

  // 2. zero-state pass: (P, z) of the chunk
  double P = 1.0, z = 0.0;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const double a = gs[base + k] < ys[base + k] ? aa : ar;
    z = a * (cs[base + k] + z);
    P *= a;
  }

  // 3. carry: inclusive scan of the chunk maps over the warp
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    const double pP = __shfl_up_sync(0xffffffffu, P, d);
    const double pz = __shfl_up_sync(0xffffffffu, z, d);
    if (lane >= d) {
      z += P * pz;
      P *= pP;
    }
  }
  double xP = __shfl_up_sync(0xffffffffu, P, 1);
  double xz = __shfl_up_sync(0xffffffffu, z, 1);
  if (lane == 0) {
    xP = 1.0;
    xz = 0.0;
  }
  if (lane == kWarp - 1) warp_total[warp] = make_double2(P, z);
  __syncthreads();
  if (tid == 0) {
    double c = 0.0;
    if (tau > 0) {
      while (load_acquire(flags + tau - 1) == 0) {
      }
      c = __ldcg(carry + tau - 1);
    }
    for (int w = 0; w < kWarps; ++w) {
      warp_state[w] = c;
      c = warp_total[w].x * c + warp_total[w].y;
    }
    if (tau + 1 < ntiles) {
      __stcg(carry + tau, c);
      store_release(flags + tau, 1);
    }
  }
  __syncthreads();
  double q = xP * warp_state[warp] + xz;

  // 4. fix-up: the chunk again from its true q
  double sum_a = 0.0, sum_r = 0.0;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const float gv = gs[base + k];
    const float yp = ys[base + k];
    const bool attack = gv < yp;
    const double a = attack ? aa : ar;
    const double lam = cs[base + k] + q;
    cs[base + k] = static_cast<float>((1.0 - a) * lam);
    const double term = lam * (static_cast<double>(yp) - static_cast<double>(gv));
    if (attack) {
      sum_a += term;
    } else {
      sum_r += term;
    }
    q = a * lam;
    if (m_first + k == T - 1) dy0[r] = static_cast<float>(q);
  }

  // the block's sums in a fixed order
#pragma unroll
  for (int d = kWarp / 2; d; d >>= 1) {
    sum_a += __shfl_xor_sync(0xffffffffu, sum_a, d);
    sum_r += __shfl_xor_sync(0xffffffffu, sum_r, d);
  }
  if (lane == 0) warp_sum[warp] = make_double2(sum_a, sum_r);
  __syncthreads();  // also: every dg of the tile is in cs

  float* dgr = dg + off;
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const int s = i * kThreads + tid;
    const long long n = T - 1 - (m0 + s);
    if (n >= 0) dgr[n] = cs[padded(s)];
  }
  if (tid == 0) {
    double sa = 0.0, sr = 0.0;
    for (int w = 0; w < kWarps; ++w) {
      sa += warp_sum[w].x;
      sr += warp_sum[w].y;
    }
    __stcg(sums + 2 * tau, sa);
    __stcg(sums + 2 * tau + 1, sr);
    __threadfence();
    if (atomicAdd(row_done, 1) == ntiles - 1) {  // the row's last block
      __threadfence();
      sa = 0.0;
      sr = 0.0;
      for (int t = 0; t < ntiles; ++t) {
        sa += __ldcg(sums + 2 * t);
        sr += __ldcg(sums + 2 * t + 1);
      }
      daa[r] = static_cast<float>(sa);
      dar[r] = static_cast<float>(sr);
    }
  }
}

}  // namespace

// y, g, ct and dg: (rows, T) fp32; alpha_attack, alpha_release, y0, daa, dar
// and dy0: (rows,) fp32; sync and states as in the header note; all
// contiguous on the device. Launches on `stream` and returns the CUDA error
// as an int.
extern "C" int ballistics_bwd_f32(const float* y, const float* g, const float* alpha_attack,
                                  const float* alpha_release, const float* y0,
                                  const float* ct, float* dg, float* daa, float* dar,
                                  float* dy0, int rows, long long T, int* sync,
                                  double* states, void* stream) {
  if (rows < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      ballistics_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int ntiles = static_cast<int>((T + kTile - 1) / kTile);
  ballistics_bwd_kernel<<<rows * ntiles, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      y, g, alpha_attack, alpha_release, y0, ct, dg, daa, dar, dy0, rows, T, ntiles, sync,
      states);
  return static_cast<int>(cudaGetLastError());
}
