// Kernel E: one eval-mode layer of the TCN encoder (models/tcn.py
// TCNBlock) in one launch, activations channels-last (NWC) in bf16.
//
// Replaces no TPU kernel: the JAX encoder's convolutions are XLA's
// (dasp_tpu/models/tcn.py, nn.Conv with padding VALID), and so were this
// port's until now: cuDNN's conv1d in bf16, then four element-wise passes
// (bias, PReLU, BatchNorm's two kernels) and cuDNN's NCHW <-> NHWC copies,
// each reading and writing every activation again. On an H100 the dilated
// stride-2 convolutions fell to cuDNN's CUDA-core implicit GEMM (about 60
// TFLOP/s) and the style render's encoder ran at about 9 % of what the card
// allows.
//
// What it computes, for x (B, T_in, C_in) bf16 and the layer's weight packed
// tap-major (256, taps, C_in) bf16:
//
//     acc[b, t, n] = sum_{k, c} x[b, t*stride + k*dilation, c] w[n, k, c]   (fp32)
//     v  = bf16(bf16(acc) + bf16(bias[n]))
//     v  = PReLU: v > 0 ? v : bf16(bf16(slope) * v);  ReLU: max(v, 0)
//     y  = bf16(((gamma[n] * (v - mean[n])) * invstd[n]) + beta[n])   (fp32)
//     invstd[n] = 1 / sqrt(var[n] + eps)
//
// with BatchNorm's running statistics and affine read at every launch. Each
// fp32 operation of the epilogue rounds on its own (no contraction into an
// FMA), so the plain version (ops/tcn_kernel.py) repeats it bit for bit;
// only the order of the fp32 sum is the kernel's.
//
// What bounds it on an H100: the large layers are tensor-core work (7 taps
// x 256 x 256 multiply-adds an output row: 1.79 TFLOP of the encoder's 2.85
// at 16 clips of 131072 lie in its first three blocks; 989 TFLOP/s bf16);
// the small late layers and the first layer (one input channel) are bytes
// over 3.35 TB/s (an output row of 512 bytes for 7 taps) and launch latency.
//
// What the design does about it. Layers with C_in a multiple of 64: an
// implicit GEMM with M = batch x T_out output rows, N = 256 channels and
// K = taps x C_in, run tap-major so that each K-slab of 64 is one tap's
// contiguous 128-byte slice of the rows t*stride + k*dilation. A block of
// two warpgroups takes 128 rows x 256 channels; each warpgroup issues
// wgmma.m64n256k16 from shared memory into 128 fp32 registers a thread.
// Slabs arrive by cp.async (16 bytes a copy, 12 a thread a slab) in a ring
// of four stages of 48 KB, written in the 128-byte swizzle that the wgmma
// descriptors name; loads run two slabs ahead of the tensor cores and one
// slab's wgmma stays in flight while the next is issued. The epilogue runs
// in registers and stores bf16 pairs: no layout copy, no second pass.
// The first layer (C_in = 1, 7 taps): a direct kernel on the CUDA cores, 64
// rows a block from a window of the input staged in shared memory, a thread
// two channels (their taps' weights in registers) over half of the rows,
// each output row one coalesced 512-byte store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCout = 256;      // output channels (the GEMM's N; the wrapper's CHANNELS)
constexpr int kBM = 128;        // output rows a block
constexpr int kBK = 64;         // K a slab: 64 input channels of one tap, 128 bytes a row
constexpr int kStages = 4;      // slabs in the ring
constexpr int kThreads = 256;   // two warpgroups, 64 rows each
constexpr int kRowBytes = kBK * 2;
constexpr int kABytes = kBM * kRowBytes;     // 16 KB
constexpr int kBBytes = kCout * kRowBytes;   // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + room to align the ring to the swizzle atom
constexpr int kDirectRows = 64;  // output rows a block of the one-channel path (the wrapper's _DIRECT_ROWS)
constexpr int kMaxTaps = 16;     // taps of the one-channel path (the wrapper's _MAX_DIRECT_TAPS)

struct Epilogue {
  const float* bias;   // (256,) the convolution's bias, rounded to bf16 here
  const float* slope;  // PReLU's one slope, rounded to bf16 here; null: ReLU
  const float* mean;   // BatchNorm's running statistics and affine, (256,) each
  const float* var;
  const float* gamma;
  const float* beta;
  float eps;
};

struct Channel {
  float bias, mean, inv, gamma, beta;
};

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ Channel load_channel(const Epilogue& e, int n) {
  Channel c;
  c.bias = bf16_round(e.bias[n]);
  c.mean = e.mean[n];
  c.inv = __frcp_rn(__fsqrt_rn(__fadd_rn(e.var[n], e.eps)));
  c.gamma = e.gamma[n];
  c.beta = e.beta[n];
  return c;
}

// the convolution's output rounded to bf16, then the bias added and rounded
// again (the configuration's bf16 convolution, then its bf16 bias add); the
// activation on that value, rounded; then BatchNorm's affine in fp32 (the
// caller rounds the result to bf16)
__device__ __forceinline__ float finish(float acc, const Channel& c, float slope, bool prelu) {
  float v = bf16_round(__fadd_rn(bf16_round(acc), c.bias));
  if (prelu) {
    if (!(v > 0.f)) v = bf16_round(__fmul_rn(slope, v));
  } else if (v < 0.f) {
    v = 0.f;
  }
  return __fadd_rn(__fmul_rn(__fmul_rn(c.gamma, __fsub_rn(v, c.mean)), c.inv), c.beta);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A K-major operand in shared memory with the 128-byte swizzle: rows of 64
// bf16 (128 bytes), groups of 8 rows 1024 bytes apart (the stride byte
// offset), the leading byte offset unused; layout type 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma instructions
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x 256, fp32, this warpgroup's registers) += A (64 x 16) B (16 x 256)^T,
// both operands K-major in shared memory
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  const int scale_d = 1;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1)
    tcn_layer_gemm_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, Epilogue epi,
                          __nv_bfloat16* __restrict__ y, int M, int T_in, int T_out, int C_in, int taps, int stride,
                          int dilation) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ Channel chan[kCout];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1024 bytes

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  for (int n = tid; n < kCout; n += kThreads) chan[n] = load_channel(epi, n);
  const bool prelu = epi.slope != nullptr;
  const float slope = prelu ? bf16_round(*epi.slope) : 0.f;

  // this thread's copies: the 16-byte chunk c of rows r0 + 32 i of each tile
  const int c = tid & 7;
  const int r0 = tid >> 3;
  const uint32_t sw = static_cast<uint32_t>(((c ^ (r0 & 7)) << 4) + r0 * kRowBytes);
  const long long k_total = static_cast<long long>(taps) * C_in;
  const int slabs_a_tap = C_in / kBK;
  const int n_slabs = taps * slabs_a_tap;
  const __nv_bfloat16* a_src[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = min(m0 + r0 + 32 * i, M - 1);  // rows past the end read the last row and are not stored
    const int b = m / T_out, t = m - b * T_out;
    a_src[i] = x + (static_cast<long long>(b) * T_in + static_cast<long long>(t) * stride) * C_in + c * 8;
  }
  const __nv_bfloat16* b_src = w + r0 * k_total + c * 8;

  auto load = [&](int kt, int stage) {
    const int tap = kt / slabs_a_tap;
    const long long a_off = static_cast<long long>(tap) * dilation * C_in + (kt - tap * slabs_a_tap) * kBK;
    const uint32_t a_dst = ring + stage * kStageBytes + sw;
#pragma unroll
    for (int i = 0; i < 4; ++i) cp_async16(a_dst + i * 32 * kRowBytes, a_src[i] + a_off);
    const uint32_t b_dst = a_dst + kABytes;
    const __nv_bfloat16* bs = b_src + static_cast<long long>(kt) * kBK;
#pragma unroll
    for (int i = 0; i < 8; ++i) cp_async16(b_dst + i * 32 * kRowBytes, bs + i * 32 * k_total);
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  const int wg = tid >> 7;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < n_slabs) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_slabs; ++kt) {
    // slab kt has landed (the one after it may still be in flight), and
    // every warpgroup's wgmma of slab kt - 2 has finished
    cp_async_wait<kStages - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int next = kt + kStages - 2;
    if (next < n_slabs) load(next, next % kStages);
    cp_async_commit();
    const uint32_t a_tile = ring + (kt % kStages) * kStageBytes + wg * 64 * kRowBytes;
    const uint32_t b_tile = ring + (kt % kStages) * kStageBytes + kABytes;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < kBK / 16; ++k) wgmma_m64n256k16(d, smem_desc(a_tile + k * 32), smem_desc(b_tile + k * 32));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(d);
  }
  wgmma_wait<0>();
  fence_acc(d);

  // accumulator layout of wgmma m64nN: warp q of the warpgroup holds rows
  // 16q + lane/4 and 16q + lane/4 + 8; d[4j + 2h + e] is column 8j + 2(lane%4) + e of row + 8h
  const int lane = tid & 31;
  const int row = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kCout / 8; ++j) {
    const int n = 8 * j + col;
    const Channel c0 = chan[n], c1 = chan[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m < M) {
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn(finish(d[4 * j + 2 * h], c0, slope, prelu));
        v.y = __float2bfloat16_rn(finish(d[4 * j + 2 * h + 1], c1, slope, prelu));
        *reinterpret_cast<__nv_bfloat162*>(y + static_cast<long long>(m) * kCout + n) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    tcn_layer_direct_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                            Epilogue epi, __nv_bfloat16* __restrict__ y, int T_in, int T_out, int taps, int stride,
                            int dilation, int span) {
  extern __shared__ float window[];  // the input samples this block's rows read
  const int n = 2 * (threadIdx.x % (kCout / 2));           // this thread's two channels
  const int half = threadIdx.x / (kCout / 2);              // and half of the block's rows
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kDirectRows;
  float w0[kMaxTaps], w1[kMaxTaps];
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    w0[k] = k < taps ? __bfloat162float(w[n * taps + k]) : 0.f;
    w1[k] = k < taps ? __bfloat162float(w[(n + 1) * taps + k]) : 0.f;
  }
  const long long first = static_cast<long long>(t0) * stride;
  const __nv_bfloat16* xb = x + static_cast<long long>(b) * T_in;
  for (int j = threadIdx.x; j < span; j += kThreads)
    window[j] = __bfloat162float(xb[min(first + j, static_cast<long long>(T_in) - 1)]);
  const Channel c0 = load_channel(epi, n), c1 = load_channel(epi, n + 1);
  const bool prelu = epi.slope != nullptr;
  const float slope = prelu ? bf16_round(*epi.slope) : 0.f;
  __syncthreads();
  const int r_end = min((half + 1) * (kDirectRows / 2), T_out - t0);
  for (int r = half * (kDirectRows / 2); r < r_end; ++r) {
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxTaps; ++k) {
      if (k >= taps) break;
      const float v = window[r * stride + k * dilation];
      acc0 = __fmaf_rn(v, w0[k], acc0);
      acc1 = __fmaf_rn(v, w1[k], acc1);
    }
    __nv_bfloat162 out;
    out.x = __float2bfloat16_rn(finish(acc0, c0, slope, prelu));
    out.y = __float2bfloat16_rn(finish(acc1, c1, slope, prelu));
    *reinterpret_cast<__nv_bfloat162*>(y + (static_cast<long long>(b) * T_out + t0 + r) * kCout + n) = out;
  }
}

}  // namespace

// y (B, T_out, 256) bf16 from x (B, T_in, C_in) bf16 and w (256, taps, C_in)
// bf16, both contiguous, on the stream; C_in 1 (taps <= 16) or a multiple of
// 64; slope null for ReLU. Returns the launch's cudaError_t.
extern "C" int tcn_layer_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias, const float* slope,
                              const float* mean, const float* var, const float* gamma, const float* beta,
                              __nv_bfloat16* y, float eps, int batch, int T_in, int T_out, int C_in, int taps,
                              int stride, int dilation, void* stream) {
  const Epilogue epi{bias, slope, mean, var, gamma, beta, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C_in == 1) {
    const int span = (kDirectRows - 1) * stride + (taps - 1) * dilation + 1;
    const dim3 grid((T_out + kDirectRows - 1) / kDirectRows, batch);
    tcn_layer_direct_kernel<<<grid, kThreads, span * sizeof(float), s>>>(x, w, epi, y, T_in, T_out, taps, stride,
                                                                          dilation, span);
  } else {
    const cudaError_t err =
        cudaFuncSetAttribute(tcn_layer_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    const int M = batch * T_out;
    tcn_layer_gemm_kernel<<<(M + kBM - 1) / kBM, kThreads, kSmemBytes, s>>>(x, w, epi, y, M, T_in, T_out, C_in,
                                                                             taps, stride, dilation);
  }
  return cudaGetLastError();
}
