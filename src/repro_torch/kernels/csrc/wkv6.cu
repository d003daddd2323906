// RWKV-6 "Finch" WKV recurrence for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `wkv6` in src/repro/kernels/wkv6.py
// (pallas_call at line 99, body `_kernel` at line 29). Same function, per
// (batch b, head h), with a K x V float32 state S:
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
// r/k/v/u in one dtype (float32 or bfloat16), w in float32 or that dtype,
// the state in float32 in and out, o in r's dtype.
//
// What bounds it on the H100: at rwkv6-1.6b's prefill shape (B = 8,
// S = 512, H = 32, K = V = 64, bf16 r/k/v, f32 w) it must move about
// 109 MB (r/k/v/w read once, o written once, the state read and written
// once), 0.033 ms at 3.35 TB/s, and do at least 4 K V float32 flops per
// (b, h, step) (the state update and the output product), 2.15 GFLOP or
// 0.032 ms at 67 TFLOP/s FP32: the two bounds are about equal. What keeps
// this first version far from both is the sequential time axis: only
// B x H = 256 blocks can run, one step after another. Its design:
//   - one block per (b, h); the TPU grid's sequential time axis becomes a
//     loop inside the block, and the state lives in registers instead of
//     VMEM scratch: thread j holds column S[:, j] (K <= 64 floats);
//   - time is staged through shared memory 32 steps at a time, r/k/w/v
//     loaded cooperatively (64 contiguous values per row and step) and
//     converted to float32 once, so the inner loop reads them as
//     broadcasts;
//   - rows i >= K and columns j >= V are zero-filled, so the inner loop
//     always runs 64 rows with no bounds test and a ragged S needs no
//     padding (the Pallas kernel pads S with w = 1, r = k = v = 0);
//   - per step each thread does 4 FMA chains over i (4 partial sums of o,
//     combined in one fixed order): no atomics, no split of S across
//     blocks, so the result is the same bit for bit run to run.
// The final state may be written over the initial one (the serving
// engine's arena is updated in place): each thread reads its column
// before it writes it, and blocks own disjoint (b, h) slices.
// Plain FMA; no tensor cores or chunked (matrix) formulation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMax = 64;    // K and V at most
constexpr int kChunk = 32;  // time steps staged in shared memory per pass
constexpr int kThreads = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename TR, typename TW>
__global__ void __launch_bounds__(kThreads) wkv6_kernel(
    const TR* __restrict__ r,  // (B, S, H, K)
    const TR* __restrict__ k,  // (B, S, H, K)
    const TR* __restrict__ v,  // (B, S, H, V)
    const TW* __restrict__ w,  // (B, S, H, K)
    const TR* __restrict__ u,  // (H, K)
    const float* s0,           // (B, H, K, V) or null (zeros); may alias s_last
    TR* __restrict__ out,      // (B, S, H, V)
    float* s_last,             // (B, H, K, V)
    int S, int H, int K, int V) {
  __shared__ __align__(16) float sr[kChunk][kMax];
  __shared__ __align__(16) float sk[kChunk][kMax];
  __shared__ __align__(16) float sw[kChunk][kMax];
  __shared__ __align__(16) float sv[kChunk][kMax];
  __shared__ __align__(16) float su[kMax];

  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const bool col = j < V;

  su[j] = j < K ? to_float(u[(size_t)h * K + j]) : 0.f;

  float st[kMax];
  const size_t sbase = (size_t)bh * K * V;
#pragma unroll
  for (int i = 0; i < kMax; ++i)
    st[i] = (s0 != nullptr && col && i < K) ? s0[sbase + (size_t)i * V + j] : 0.f;

  const size_t row = (size_t)H * K;   // stride of one time step in r/k/w
  const size_t vrow = (size_t)H * V;  // ... and in v/out
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is fully consumed
    for (int e = j; e < kChunk * kMax; e += kThreads) {
      const int tt = e / kMax;
      const int i = e - tt * kMax;
      const bool live = tt < n;
      const size_t off = ((size_t)b * S + t0 + tt) * row + (size_t)h * K + i;
      const bool ki = live && i < K;
      sr[tt][i] = ki ? to_float(r[off]) : 0.f;
      sk[tt][i] = ki ? to_float(k[off]) : 0.f;
      sw[tt][i] = ki ? to_float(w[off]) : 0.f;
      const size_t voff = ((size_t)b * S + t0 + tt) * vrow + (size_t)h * V + i;
      sv[tt][i] = (live && i < V) ? to_float(v[voff]) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kMax; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[tt][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float kv = kk[q] * vj;
          acc[q] = fmaf(rr[q], fmaf(uu[q], kv, st[i + q]), acc[q]);
          st[i + q] = fmaf(ww[q], st[i + q], kv);
        }
      }
      if (col) {
        const size_t o = ((size_t)b * S + t0 + tt) * vrow + (size_t)h * V + j;
        store(out + o, (acc[0] + acc[1]) + (acc[2] + acc[3]));
      }
    }
  }

  if (col) {
#pragma unroll
    for (int i = 0; i < kMax; ++i)
      if (i < K) s_last[sbase + (size_t)i * V + j] = st[i];
  }
}

template <typename TR, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s0, void* out, void* s_last, int B, int S, int H, int K, int V,
           cudaStream_t stream) {
  wkv6_kernel<TR, TW><<<B * H, kThreads, 0, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k), static_cast<const TR*>(v),
      static_cast<const TW*>(w), static_cast<const TR*>(u), static_cast<const float*>(s0),
      static_cast<TR*>(out), static_cast<float*>(s_last), S, H, K, V);
  return (int)cudaGetLastError();
}

}  // namespace

// r_dtype (r, k, v, u, out) and w_dtype: 0 = float32, 1 = bfloat16.
// s0 may be null (a zero initial state) and may equal s_last.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int wkv6_fwd(int r_dtype, int w_dtype, const void* r, const void* k,
                        const void* v, const void* w, const void* u, const void* s0,
                        void* out, void* s_last, int B, int S, int H, int K, int V,
                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || K > kMax || V < 1 || V > kMax ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r_dtype == 0 && w_dtype == 0)
    return launch<float, float>(r, k, v, w, u, s0, out, s_last, B, S, H, K, V, st);
  if (r_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, s0, out, s_last, B, S, H, K, V, st);
  if (r_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, out, s_last, B, S, H, K,
                                                V, st);
  return (int)cudaErrorInvalidValue;
}
