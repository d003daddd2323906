// Mamba-2 decode step over the arena's rows, for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package has no Mamba-2 block. One call
// per Mamba-2 layer per decode step (models/mamba2.py) takes each arena
// row's token through the mixer's recurrent part, in place:
//     window = [conv_state (W - 1 inputs), xbc]     conv_state <- window[1:]
//     u = SiLU(sum_k conv_w[k] window[k] + conv_b)  -> x (H P), B (N), C (N)
//     dt = softplus(dt_raw + dt_bias), A = -exp(a_log)
//     S <- exp(dt A) S + dt x (x) B,    y = S C + D x
// per head (one group of B and C). A row whose `active` flag is off (a
// held lease, a dead row) is not touched: its state and conv window stay
// as they were and its y is 0, so the step's row mask costs nothing.
// `active` null steps every row.
//
// What bounds it on the H100: bytes. Each stepped row's float32 state is
// read once and written once: at granite-4.0-h-micro's widths (H 64, P 64,
// N 128) 2.10 MB a row, 134 MB at 32 rows, 40 us at 3.35 TB/s; the conv
// window and the token's inputs add 1%. The design follows from that:
//   a. `ssd_step_conv_kernel`, one thread per (row, channel): the conv
//      window, its SiLU, into a small float32 scratch, and the window's
//      shift in place. A separate launch because B and C feed every head:
//      a block of (b) below that shifted them in place would race the
//      other heads' blocks reading them;
//   b. `ssd_step_state_kernel`, one block of 256 threads per (head, row):
//      the head's P x N state as float4 vectors, thread t taking vectors
//      t, t + 256, ... so a warp reads and writes 512 contiguous bytes at
//      a time, all of a thread's loads issued before the first is used;
//      the N / 4 lanes that hold one row p of the state sum S C for it with
//      a shuffle butterfly in a fixed order. No atomics: two calls agree
//      bit for bit, and a CUDA-graph replay equals its eager step.
// P <= 64, N a power of two from 4 to 128, W = 4. `ref.ssd_step_plain` is
// the plain twin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 4;  // conv width
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kThreads = 256;
constexpr int kVecs = kMaxP * kMaxN / 4 / kThreads;  // float4 vectors a thread at most

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <typename T>
__global__ void ssd_step_conv_kernel(const T* __restrict__ xbc, long long xbc_stride,
                                     float* __restrict__ conv_state,  // (B, W - 1, Cc)
                                     const T* __restrict__ conv_w,    // (W, Cc)
                                     const T* __restrict__ conv_b,    // (Cc,)
                                     const bool* __restrict__ active,
                                     float* __restrict__ u,           // (B, Cc)
                                     int Cc) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (ch >= Cc || (active != nullptr && !active[b])) return;
  float* hist = conv_state + (long long)b * (kW - 1) * Cc + ch;
  float win[kW];
#pragma unroll
  for (int k = 0; k < kW - 1; ++k) win[k] = hist[(long long)k * Cc];
  win[kW - 1] = to_float(xbc[(long long)b * xbc_stride + ch]);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kW; ++k) acc = fmaf(win[k], to_float(conv_w[(long long)k * Cc + ch]), acc);
  u[(long long)b * Cc + ch] = silu(acc + to_float(conv_b[ch]));
#pragma unroll
  for (int k = 0; k < kW - 1; ++k) hist[(long long)k * Cc] = win[k + 1];
}

template <typename T, int G>  // G = N / 4 lanes hold one row of the state
__global__ void __launch_bounds__(kThreads) ssd_step_state_kernel(
    const float* __restrict__ u,      // (B, Cc): x (H P), then B (N), then C (N)
    const T* __restrict__ dt, long long dt_stride,  // (B, H) before the softplus
    const T* __restrict__ dt_bias, const T* __restrict__ a_log, const T* __restrict__ dskip,
    float* __restrict__ state,        // (B, H, P, N)
    const bool* __restrict__ active,
    T* __restrict__ y,                // (B, H, P)
    int H, int P, int Cc) {
  constexpr int N = 4 * G;
  const int h = blockIdx.x, b = blockIdx.y;
  T* yr = y + ((long long)b * H + h) * P;
  if (active != nullptr && !active[b]) {
    for (int p = threadIdx.x; p < P; p += kThreads) store(yr + p, 0.f);
    return;
  }
  __shared__ float sx[kMaxP];
  const float* ur = u + (long long)b * Cc;
  const int hp = H * P;
  for (int p = threadIdx.x; p < P; p += kThreads) sx[p] = ur[(long long)h * P + p];
  const int nvec = P * G;  // float4 vectors of the state
  float4* sv = reinterpret_cast<float4*>(state + ((long long)b * H + h) * P * N);
  float4 s[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int f = threadIdx.x + i * kThreads;
    if (f < nvec) s[i] = sv[f];
  }
  const int lane_n = (threadIdx.x % G) * 4;  // this thread's four state columns
  const float4 bv = make_float4(ur[hp + lane_n], ur[hp + lane_n + 1], ur[hp + lane_n + 2],
                                ur[hp + lane_n + 3]);
  const float4 cv = make_float4(ur[hp + N + lane_n], ur[hp + N + lane_n + 1],
                                ur[hp + N + lane_n + 2], ur[hp + N + lane_n + 3]);
  const float step = softplus(to_float(dt[(long long)b * dt_stride + h]) + to_float(dt_bias[h]));
  const float decay = expf(step * -expf(to_float(a_log[h])));
  const float dsk = to_float(dskip[h]);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (i * kThreads >= nvec) break;  // uniform across the block
    const int f = threadIdx.x + i * kThreads;
    const bool live = f < nvec;  // every lane takes part in the shuffles
    const int p = live ? f / G : 0;
    float part = 0.f;
    if (live) {
      const float dx = step * sx[p];
      float4 v = s[i];
      v.x = fmaf(decay, v.x, dx * bv.x);
      v.y = fmaf(decay, v.y, dx * bv.y);
      v.z = fmaf(decay, v.z, dx * bv.z);
      v.w = fmaf(decay, v.w, dx * bv.w);
      sv[f] = v;
      part = (v.x * cv.x + v.y * cv.y) + (v.z * cv.z + v.w * cv.w);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o, G);
    if (live && threadIdx.x % G == 0) store(yr + p, fmaf(dsk, sx[p], part));
  }
}

template <typename T, int G>
int launch_state(const float* u, const void* dt, long long dt_stride, const void* dt_bias,
                 const void* a_log, const void* d, float* state, const bool* active, void* y,
                 int B, int H, int P, int Cc, cudaStream_t st) {
  ssd_step_state_kernel<T, G><<<dim3(H, B), kThreads, 0, st>>>(
      u, static_cast<const T*>(dt), dt_stride, static_cast<const T*>(dt_bias),
      static_cast<const T*>(a_log), static_cast<const T*>(d), state, active,
      static_cast<T*>(y), H, P, Cc);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xbc, long long xbc_stride, const void* dt, long long dt_stride,
           float* conv_state, const void* conv_w, const void* conv_b, const void* dt_bias,
           const void* a_log, const void* d, float* state, const bool* active, float* u,
           void* y, int B, int H, int P, int N, cudaStream_t st) {
  const int Cc = H * P + 2 * N;
  ssd_step_conv_kernel<T><<<dim3((Cc + 255) / 256, B), 256, 0, st>>>(
      static_cast<const T*>(xbc), xbc_stride, conv_state, static_cast<const T*>(conv_w),
      static_cast<const T*>(conv_b), active, u, Cc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
#define SSD_STATE(G) \
  return launch_state<T, G>(u, dt, dt_stride, dt_bias, a_log, d, state, active, y, B, H, P, Cc, st);
  switch (N) {
    case 4: SSD_STATE(1)
    case 8: SSD_STATE(2)
    case 16: SSD_STATE(4)
    case 32: SSD_STATE(8)
    case 64: SSD_STATE(16)
    case 128: SSD_STATE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_STATE
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 for xbc, dt, conv_w, conv_b, dt_bias,
// a_log, d and y. xbc (B, H P + 2 N) and dt (B, H) are rows `*_stride`
// elements apart; conv_state (B, 3, H P + 2 N) and state (B, H, P, N)
// float32, contiguous, 16-byte aligned, updated in place; active (B,) bool
// or null; u a (B, H P + 2 N) float32 scratch; y (B, H, P) contiguous.
// One group of B and C. Returns the first failing launch's cudaError.
extern "C" int ssd_step_fwd(int dtype, const void* xbc, long long xbc_stride, const void* dt,
                            long long dt_stride, void* conv_state, const void* conv_w,
                            const void* conv_b, const void* dt_bias, const void* a_log,
                            const void* d, void* state, const void* active, void* u, void* y,
                            int B, int H, int P, int N, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || P < 1 || P > kMaxP || N < 4 || N > kMaxN ||
      (N & (N - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cs = static_cast<float*>(conv_state);
  float* sp = static_cast<float*>(state);
  const bool* act = static_cast<const bool*>(active);
  float* up = static_cast<float*>(u);
  if (dtype == 0)
    return launch<float>(xbc, xbc_stride, dt, dt_stride, cs, conv_w, conv_b, dt_bias, a_log, d,
                         sp, act, up, y, B, H, P, N, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(xbc, xbc_stride, dt, dt_stride, cs, conv_w, conv_b, dt_bias,
                                 a_log, d, sp, act, up, y, B, H, P, N, st);
  return (int)cudaErrorInvalidValue;
}
