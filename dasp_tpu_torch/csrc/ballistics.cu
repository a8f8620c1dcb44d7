// Exact branching attack/release envelope smoother: the port of kernel B.
//
// Replaces: dasp_tpu/ops/pallas_ballistics.py, _fwd_kernel (launched by
// _fwd_impl). For each row of g (R, T):
//
//     alpha[n] = alpha_attack  if g[n] < y[n-1]  else alpha_release
//     y[n]     = (1 - alpha[n]) * g[n] + alpha[n] * y[n-1],   y[-1] = y0
//
// What bounds it on an H100: bytes. The compressor's 8 rows x 131072
// samples read 4.2 MB and write 4.2 MB (2.5 us at 3.35 TB/s); the compare,
// select and four rounded operations per sample are nothing for the card.
// The recursion, though, is one chain of T dependent steps per row, and its
// branch depends on the state, so it is no associative scan: walked by one
// thread per row (the design this file had first) it kept 8 threads busy
// on a 132-SM card at about 44 ns a sample (5.8 ms at 131072 samples).
//
// What the design does about it: speculate, then verify to a bitwise fixed
// point. The tiling is ballistics.cuh's (8192-sample tiles, one block each;
// 32-sample chunks, one thread each, held in registers with the two
// products (1 - alpha) * g that do not depend on y).
//
//  1. speculate: every thread walks its chunk from a guessed entering state
//     and keeps only its last output: the guess is the sample of g before
//     the chunk; for a tile's first chunk y0 (the row's first tile), else
//     the last output the previous tile has published, else g[n0 - 1];
//  2. verify, in rounds: every thread whose entering state differs bit for
//     bit from its predecessor's current last output walks its chunk again
//     from that output. A warp runs its rounds alone (the outputs passed by
//     shuffles, its first lane's predecessor the warp before it) until none
//     of its lanes changed (__any_sync); then the block hands the warps'
//     last outputs on at a barrier and goes again while any warp changed
//     (__syncthreads_or). Each round makes at least one more chunk of the
//     warp exact, so a pass takes at most 8 x 33 rounds;
//  3. across tiles: the block publishes its tile's last output after every
//     pass, provisional or final, and waits for the previous tile's
//     published output to change or become final; a new value starts
//     another pass. A block is final once its entering state is final and a
//     round changed nothing. Tiles take their number from an atomic
//     counter in the order blocks start, so a block only waits on one that
//     runs or has run;
//  4. every thread walks its chunk once more from its final entering state
//     and writes the outputs, staged through shared memory.
//
// At the fixed point every chunk starts from its predecessor's exact output
// and the row's first chunk from y0, so by induction the result is the
// serial loop's, bit for bit, whatever the guesses were. Two fp32
// trajectories that agree at one sample agree from then on, and a wrong
// state dies out after about 16 time constants 1 / (1 - alpha_release)
// (measured on the CPU: about 2000 samples at 5 ms, 33000 at 100 ms), so
// the critical path is about that many steps, not T. On an H100 a chunk
// walked in a warp's round takes about 0.34 us (a step's multiply, add and
// select, about 15 cycles, 32 times), and a compressor curve at 8 x 131072
// or 262144 takes about 0.47 ms, 0.58-0.62 at 100 ms time constants (as a
// block-wide round with a barrier each, it took 0.52 and 0.65-0.70). Two
// blocks must fit on an SM (at most 128 registers a thread), or the
// corruption's 256 blocks do not all run at once. A wrong entering state
// that lasts a whole tile makes a pass a serial walk of it in 256 rounds:
// that is the kernel's own worst case (a constant g whose two fp32 fixed
// points never meet: 1.4 ms at 131072), not a fallback.
//
// Every step is written with __fsub_rn / __fmul_rn / __fadd_rn so that the
// compiler cannot contract it into an FMA: it rounds exactly as the plain
// loop (dasp_tpu_torch/ops/ballistics_kernel.py ballistics_rows_plain)
// does. Chunk-chained evaluation that hands the last output on as the next
// chunk's y0 is therefore bitwise equal to one pass.
//
// Scratch, allocated and zeroed by the caller: 1 + 4 * rows * ntiles
// 64-bit words: the tile counter; per tile the published last output
// (state in the high word: 1 provisional, 2 final; fp32 bits in the low
// word); per tile the work done: rounds (the most any warp ran), passes and
// samples walked again in the rounds.

#include "ballistics.cuh"

namespace {

using namespace dasp;
using namespace dasp::ballistics;

constexpr unsigned long long kProvisional = 1ull << 32;
constexpr unsigned long long kFinal = 2ull << 32;

__device__ __forceinline__ unsigned bits(float v) { return __float_as_uint(v); }

// The samples of a thread's chunk and the per-sample products the update
// needs that do not depend on y: (1 - alpha) * g for either branch, rounded
// as the plain loop rounds (1 - alpha) * g (oma and omr are 1 - alpha_attack
// and 1 - alpha_release, each rounded as the loop's 1 - alpha).
struct Chunk {
  float g[kChunk];
  float attack_g[kChunk];
  float release_g[kChunk];
};

// one step, rounded as the plain loop rounds (1 - alpha) * g + alpha * y.
// Both branches' values are formed side by side and the compare selects
// one, so the chain from y to the next y is a multiply, an add and a select
__device__ __forceinline__ float step(const Chunk& c, int k, float y, float aa, float ar) {
  const float ya = __fadd_rn(c.attack_g[k], __fmul_rn(aa, y));
  const float yr = __fadd_rn(c.release_g[k], __fmul_rn(ar, y));
  return c.g[k] < y ? ya : yr;
}

// the chunk walked from the entering state y: its last output
__device__ __forceinline__ float walk(const Chunk& c, float y, float aa, float ar) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) y = step(c, k, y, aa, ar);
  return y;
}

// two blocks per SM: the corruption's 8 x 262144 samples are 256 blocks,
// all of which must be resident for the tiles to overlap (with 179
// registers a thread, one block per SM, 262144 samples took 1.7x as long
// as 131072)
__global__ void __launch_bounds__(kThreads, 2)
ballistics_kernel(const float* __restrict__ g, const float* __restrict__ alpha_attack,
                  const float* __restrict__ alpha_release, const float* __restrict__ y0,
                  float* __restrict__ y, int rows, long long T, int ntiles,
                  unsigned long long* __restrict__ scratch) {
  __shared__ float tile[kTileFloats];
  __shared__ float warp_last[2][kWarps];  // each warp's last output, by iteration parity
  __shared__ int tile_id;
  __shared__ int done;
  __shared__ int rewalks;
  __shared__ int most_rounds;

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  if (tid == 0) {
    tile_id = static_cast<int>(atomicAdd(scratch, 1ull));
    rewalks = 0;
    most_rounds = 0;
  }
  __syncthreads();
  const int r = tile_id % rows;
  const int tau = tile_id / rows;
  unsigned long long* pub = scratch + 1 + static_cast<long long>(r) * ntiles;
  const float aa = alpha_attack[r];
  const float ar = alpha_release[r];
  const float oma = __fsub_rn(1.0f, aa);
  const float omr = __fsub_rn(1.0f, ar);
  const float* gr = g + static_cast<long long>(r) * T;
  const long long n0 = static_cast<long long>(tau) * kTile;

#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const int s = i * kThreads + tid;
    const long long n = n0 + s;
    tile[padded(s)] = n < T ? gr[n] : 0.f;  // past the end: walked, never stored
  }
  __syncthreads();
  Chunk c;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    c.g[k] = tile[tid * (kChunk + 1) + k];
    c.attack_g[k] = __fmul_rn(oma, c.g[k]);
    c.release_g[k] = __fmul_rn(omr, c.g[k]);
  }

  // the guessed entering state e; thread 0 also keeps the tile's entering
  // state and whether it is final
  float entry = 0.f;
  bool entry_final = true;
  float e;
  if (tid == 0) {
    if (tau == 0) {
      entry = y0[r];
    } else {
      const unsigned long long w = load_acquire(pub + tau - 1);
      entry = (w >> 32) ? __uint_as_float(static_cast<unsigned>(w)) : gr[n0 - 1];
      entry_final = (w >> 32) == 2;
    }
    e = entry;
  } else {
    e = tile[padded(tid * kChunk - 1)];
  }

  // 1. speculate. The rounds only need each chunk's last output: the
  // chunk's samples are walked once more from the final entering state
  // at the end
  int buf = 0;
  float out = walk(c, e, aa, ar);
  if (lane == kWarp - 1) warp_last[buf][warp] = out;
  int rounds = 0, passes = 0, my_rewalks = 0;
  __syncthreads();

  for (;;) {
    // 2. verify: rounds to the fixed point for the tile's current entering
    // state. A warp runs its rounds alone, its lanes' predecessors' outputs
    // passed by shuffles and its first lane's from the warp before (or the
    // tile's entering state), until none of its lanes changed; then the
    // block hands every warp's last output on at a barrier, and goes round
    // again while any warp changed
    bool warp_changed;
    do {
      const float warp_entry = warp ? warp_last[buf][warp - 1] : entry;
      warp_changed = false;
      for (;;) {
        float pred = __shfl_up_sync(0xffffffffu, out, 1);
        if (lane == 0) pred = warp_entry;
        const bool changed = bits(pred) != bits(e);
        if (changed) {
          e = pred;
          out = walk(c, e, aa, ar);
          ++my_rewalks;
        }
        ++rounds;
        if (!__any_sync(0xffffffffu, changed)) break;
        warp_changed = true;
      }
      if (lane == kWarp - 1) warp_last[buf ^ 1][warp] = out;
      buf ^= 1;
    } while (__syncthreads_or(warp_changed));

    // 3. publish the tile's last output; wait for a new entering state
    if (tid == 0) {
      const unsigned long long tile_out = bits(warp_last[buf][kWarps - 1]);
      const bool has_next = tau + 1 < ntiles;
      if (has_next) store_release(pub + tau, (entry_final ? kFinal : kProvisional) | tile_out);
      done = entry_final;
      while (!entry_final) {
        const unsigned long long w = load_acquire(pub + tau - 1);
        const float v = __uint_as_float(static_cast<unsigned>(w));
        if ((w >> 32) && bits(v) != bits(entry)) {
          entry = v;
          entry_final = (w >> 32) == 2;
        } else if ((w >> 32) == 2) {
          entry_final = true;
          done = 1;
          if (has_next) store_release(pub + tau, kFinal | tile_out);
        } else {
          __nanosleep(32);
          continue;
        }
        break;
      }
    }
    __syncthreads();
    if (done) break;
    ++passes;
  }

  // the chunk from its exact entering state, staged and stored coalesced
  atomicAdd(&rewalks, my_rewalks);
  if (lane == 0) atomicMax(&most_rounds, rounds);
  {
    float v = e;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      v = step(c, k, v, aa, ar);
      tile[tid * (kChunk + 1) + k] = v;
    }
  }
  __syncthreads();
  float* yr = y + static_cast<long long>(r) * T;
#pragma unroll 4
  for (int i = 0; i < kChunk; ++i) {
    const int s = i * kThreads + tid;
    const long long n = n0 + s;
    if (n < T) yr[n] = tile[padded(s)];
  }
  if (tid == 0) {
    unsigned long long* work = scratch + 1 + static_cast<long long>(rows) * ntiles +
                               3 * (static_cast<long long>(r) * ntiles + tau);
    work[0] = most_rounds;
    work[1] = passes;
    work[2] = static_cast<unsigned long long>(rewalks) * kChunk;
  }
}

}  // namespace

// samples per block: the caller sizes the scratch by it
extern "C" int ballistics_tile() { return kTile; }

// g and y: (rows, T) fp32; alpha_attack, alpha_release, y0: (rows,) fp32;
// scratch as in the header note; all contiguous on the device. Launches on
// `stream` and returns the CUDA error as an int.
extern "C" int ballistics_f32(const float* g, const float* alpha_attack,
                              const float* alpha_release, const float* y0, float* y,
                              int rows, long long T, unsigned long long* scratch,
                              void* stream) {
  if (rows < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = static_cast<int>((T + kTile - 1) / kTile);
  ballistics_kernel<<<rows * ntiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, alpha_attack, alpha_release, y0, y, rows, T, ntiles, scratch);
  return static_cast<int>(cudaGetLastError());
}
