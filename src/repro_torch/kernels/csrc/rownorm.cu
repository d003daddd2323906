// Row normalisation (RMSNorm and LayerNorm) for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package normalises in XLA
// (src/repro/models/layers.py, `rmsnorm` and `layernorm`), which fuses the
// chain into one pass. The port ran the same chain eagerly in PyTorch
// (`ref.rmsnorm_ref`, `ref.layernorm_ref`): about ten launches a norm,
// each reading and writing the whole activation in float32, some 40 bytes
// an element for RMS and 52 for layer norm. This kernel does the chain in
// one pass over each row of the last dim d:
//     RMS:   var = mean(x^2),              y = (x * rsqrt(var + eps)) * (1 + w)
//     layer: mu = mean(x), var = mean((x - mu)^2),
//                                         y = ((x - mu) * rsqrt(var + eps)) * w + b
// statistics in float32, the result rounded once to x's type. x is
// float32 or bfloat16; w (and b) float32 or bfloat16, read as float32.
//
// What bounds it on the H100: bytes. x is read once and y written once,
// 4 bytes an element in bf16 (granite's 8 x 512 prefill, 4096 rows x 2048:
// 33.6 MB, 10.0 us at 3.35 TB/s), plus the weights, which every row reads
// from L2. The design follows from that:
//   - one block per row, so one launch takes any row count (32 decode
//     rows or 7936 prefill rows); the wrapper picks the block's threads by
//     d alone (kernels/rownorm.py, `plan`);
//   - 16-byte vector loads and stores, neighbouring threads on
//     neighbouring addresses; every load of a row is issued before the
//     first is used, and the row stays in registers (VPT vectors a
//     thread) while it is normalised, so x is read from memory once;
//   - sums in float32: each thread's in its own order, then a warp
//     butterfly, then the warps' partials in warp order from shared
//     memory. No atomics, and a fixed plan per d, so two calls (and a
//     CUDA-graph replay against its eager step) agree bit for bit;
//   - the output's multiply and add are rounded separately (`__fmul_rn`,
//     `__fadd_rn`), in the chain's order, not fused.
// d is a multiple of 8 up to 16384 (the zoo's widest, llama3-405b); rows
// of x may be strided (the last position of a batch), y is contiguous.
// The gated RMS form (`rownorm_gated_fwd`, Mamba-2's output norm) reads a
// gate g beside x and normalises x * silu(g), in float32, in the same
// pass: y = (v * rsqrt(mean(v^2) + eps)) * (1 + w), v = x * silu(g); g's
// rows may be strided too (a view of the input projection).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxD = 16384;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// E elements of T at p, as float32: 16-byte loads, or one 8-byte load for
// four bf16 weights beside a float32 x.
template <typename T, int E>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&f)[E]) {
  constexpr int kBytes = E * (int)sizeof(T);
  static_assert(kBytes == 8 || kBytes % 16 == 0, "8 bytes or whole 16-byte vectors");
  if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < E; ++j) f[j] = to_float(t[j]);
  } else {
    constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) f[c * kPer + j] = to_float(t[j]);
    }
  }
}

// One 16-byte store of E = 16 / sizeof(T) elements, each rounded once.
template <typename T, int E>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&f)[E]) {
  static_assert(E * sizeof(T) == 16, "one 16-byte vector");
  uint4 u;
  T* t = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int j = 0; j < E; ++j) t[j] = from_float<T>(f[j]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The block's sum of v, the same bits in every thread: a warp butterfly
// (a + b and b + a round alike, so every lane holds one value), then the
// warps' partials added in warp order.
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = partial[0];
  const int warps = blockDim.x >> 5;
  for (int i = 1; i < warps; ++i) s += partial[i];
  __syncthreads();  // every thread has read before the next sum writes
  return s;
}

// Row blockIdx.x. Thread t holds vectors t, t + threads, ... (VPT of
// them, the last ones past d left out).
template <typename T, typename W, int VPT, bool kCenter, bool kGate>
__global__ void __launch_bounds__(kMaxThreads) rownorm_kernel(
    const T* __restrict__ x,     // (rows, x_stride), the first d of each row
    const T* __restrict__ g,     // (rows, g_stride), gated RMS only
    const W* __restrict__ w,     // (d,)
    const W* __restrict__ bias,  // (d,), layer norm only
    T* __restrict__ y,           // (rows, d)
    int d, long long x_stride, long long g_stride, float eps) {
  constexpr int E = 16 / (int)sizeof(T);
  __shared__ float partial[kMaxThreads / 32];
  const int nvec = d / E;
  const T* xr = x + (long long)blockIdx.x * x_stride;
  T* yr = y + (long long)blockIdx.x * d;

  float v[VPT][E];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      load_vec<T, E>(xr + (long long)c * E, v[i]);
      if constexpr (kGate) {
        float gv[E];
        load_vec<T, E>(g + (long long)blockIdx.x * g_stride + (long long)c * E, gv);
#pragma unroll
        for (int j = 0; j < E; ++j) v[i][j] *= gv[j] / (1.f + expf(-gv[j]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) v[i][j] = 0.f;
    }
  }

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
#pragma unroll
    for (int j = 0; j < E; ++j) s += kCenter ? v[i][j] : v[i][j] * v[i][j];
  }
  const float total = block_sum(s, partial);
  float mu = 0.f, var;
  if constexpr (kCenter) {
    mu = total / (float)d;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (threadIdx.x + i * blockDim.x < nvec) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const float t = v[i][j] - mu;
          q += t * t;
        }
      }
    }
    var = block_sum(q, partial) / (float)d;
  } else {
    var = total / (float)d;
  }
  const float r = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= nvec) continue;
    float wf[E], out[E];
    load_vec<W, E>(w + (long long)c * E, wf);
    if constexpr (kCenter) {
      float bf[E];
      load_vec<W, E>(bias + (long long)c * E, bf);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float t = __fmul_rn(v[i][j] - mu, r);
        out[j] = __fadd_rn(__fmul_rn(t, wf[j]), bf[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) out[j] = __fmul_rn(__fmul_rn(v[i][j], r), 1.f + wf[j]);
    }
    store_vec<T, E>(yr + (long long)c * E, out);
  }
}

template <typename T, typename W, bool kCenter, bool kGate = false>
int launch(const void* x, const void* w, const void* b, void* y, int rows, int d,
           long long x_stride, float eps, int threads, cudaStream_t st,
           const void* g = nullptr, long long g_stride = 0) {
  const int nvec = d / (16 / (int)sizeof(T));
  const int per = (nvec + threads - 1) / threads;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  const W* wp = static_cast<const W*>(w);
  const W* bp = static_cast<const W*>(b);
  T* yp = static_cast<T*>(y);
#define ROWNORM_LAUNCH(V)                                                                    \
  rownorm_kernel<T, W, V, kCenter, kGate><<<rows, threads, 0, st>>>(xp, gp, wp, bp, yp, d, \
                                                                     x_stride, g_stride, eps); \
  break;
  switch (per <= 1 ? 1 : per <= 2 ? 2 : per <= 4 ? 4 : per <= 8 ? 8 : per <= 16 ? 16 : 0) {
    case 1: ROWNORM_LAUNCH(1)
    case 2: ROWNORM_LAUNCH(2)
    case 4: ROWNORM_LAUNCH(4)
    case 8: ROWNORM_LAUNCH(8)
    case 16: ROWNORM_LAUNCH(16)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROWNORM_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T, bool kCenter>
int launch_w(int w_dtype, const void* x, const void* w, const void* b, void* y, int rows, int d,
             long long x_stride, float eps, int threads, cudaStream_t st) {
  if (w_dtype == 0) return launch<T, float, kCenter>(x, w, b, y, rows, d, x_stride, eps, threads, st);
  if (w_dtype == 1)
    return launch<T, __nv_bfloat16, kCenter>(x, w, b, y, rows, d, x_stride, eps, threads, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_t(int w_dtype, int center, const void* x, const void* w, const void* b, void* y,
             int rows, int d, long long x_stride, float eps, int threads, cudaStream_t st) {
  if (center) return launch_w<T, true>(w_dtype, x, w, b, y, rows, d, x_stride, eps, threads, st);
  return launch_w<T, false>(w_dtype, x, w, b, y, rows, d, x_stride, eps, threads, st);
}

}  // namespace

// y = the norm of each of x's `rows` rows (d wide, `x_stride` elements
// apart); dtype codes 0 float32, 1 bfloat16 for x (and y) and for w (and
// b); `center` 1 for layer norm (b required), 0 for RMS. `threads` a
// multiple of 32 from 32 to 256. Pointers 16-byte aligned. One launch on
// `stream`; returns cudaGetLastError() after it (0 on success).
extern "C" int rownorm_fwd(int x_dtype, int w_dtype, int center, const void* x, const void* w,
                           const void* b, void* y, int rows, int d, long long x_stride, float eps,
                           int threads, void* stream) {
  if (rows < 1 || d < 8 || d > kMaxD || d % 8 != 0 || x_stride < d || x_stride % 8 != 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || (center && b == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_t<float>(w_dtype, center, x, w, b, y, rows, d, x_stride, eps, threads, st);
  if (x_dtype == 1)
    return launch_t<__nv_bfloat16>(w_dtype, center, x, w, b, y, rows, d, x_stride, eps, threads,
                                   st);
  return (int)cudaErrorInvalidValue;
}

// The gated RMS norm: y = the RMS norm of x * silu(g), row by row; g has
// x's dtype and its rows are `g_stride` elements apart. Otherwise as
// `rownorm_fwd` with center 0.
extern "C" int rownorm_gated_fwd(int x_dtype, int w_dtype, const void* x, const void* g,
                                 const void* w, void* y, int rows, int d, long long x_stride,
                                 long long g_stride, float eps, int threads, void* stream) {
  if (rows < 1 || d < 8 || d > kMaxD || d % 8 != 0 || x_stride < d || x_stride % 8 != 0 ||
      g_stride < d || g_stride % 8 != 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || g == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float, false, true>(x, w, nullptr, y, rows, d, x_stride, eps, threads,
                                             st, g, g_stride);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, __nv_bfloat16, false, true>(x, w, nullptr, y, rows, d, x_stride, eps,
                                                     threads, st, g, g_stride);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float, false, true>(x, w, nullptr, y, rows, d, x_stride, eps,
                                                     threads, st, g, g_stride);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false, true>(x, w, nullptr, y, rows, d,
                                                             x_stride, eps, threads, st, g,
                                                             g_stride);
  return (int)cudaErrorInvalidValue;
}
