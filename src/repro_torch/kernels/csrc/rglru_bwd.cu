// The backward of the RG-LRU linear recurrence (RecurrentGemma / Griffin)
// for Hopper, sm_90a.
//
// The gradient of the Pallas TPU kernel `rglru_scan` in
// src/repro/kernels/rglru.py (pallas_call at line 94); in the reference
// it is XLA autodiff of src/repro/models/recurrent.py::rglru_prefill
// (line 68), whose scan oracle is src/repro/kernels/ref.py::rglru_ref
// (line 83). The forward is `h_t = a_t h_{t-1} + b_t`, h_0 = h0 (zeros
// when absent). Per (batch b, channel d), in float32, walking time from
// the last step to the first, with g_t the gradient of h_t:
//     g_t  = dh_t + a_{t+1} g_{t+1}    (seeded by the last h's gradient)
//     db_t = g_t,   da_t = g_t h_{t-1},   dh0 = a_1 g_1.
// h_{t-1} is the forward's saved output (exact in training, where the
// model passes float32 a and b; rounded to bf16 for bf16 inputs). a, h, dh
// in one dtype (float32 or bfloat16), da and db written in it; dh_last,
// h0 and dh0 are float32. `ref.rglru_bwd_plain` is the same recurrence in
// plain PyTorch.
//
// What bounds it on the H100: bytes. a, h and dh are read once and da,
// db written once, with two multiplies and an add per element: at
// recurrentgemma-9b's training shape (B = 1, S = 4096, D = 4096, float32)
// that is 336 MB, 0.100 ms at 3.35 TB/s. The design is the forward's
// (csrc/rglru.cu) run backwards: one thread per (b, channel), channels
// tiled 128 to a block so each step's loads and stores are contiguous
// across a warp, the reverse time loop unrolled 8 steps deep with every
// load of a group issued before its first use. Each product and sum is
// rounded on its own (no fused multiply-add), as the plain version's
// are, so float32 results are its bit for bit. No atomics: two calls
// agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_bwd_kernel(
    const T* __restrict__ a,            // (B, S, D)
    const T* __restrict__ h,            // (B, S, D) the forward's output
    const T* __restrict__ dh,           // (B, S, D)
    const float* __restrict__ dh_last,  // (B, D) or null (zeros)
    const float* __restrict__ h0,       // (B, D) or null (zeros)
    T* __restrict__ da,                 // (B, S, D)
    T* __restrict__ db,                 // (B, S, D)
    float* __restrict__ dh0,            // (B, D)
    int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)b * S * D + d;
  // carry = a_{t+1} g_{t+1}: the gradient h_t receives from step t + 1.
  float carry = dh_last != nullptr ? dh_last[(size_t)b * D + d] : 0.f;
  const float first = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
  int t = S - 1;
  // Groups of kUnroll steps t - kUnroll + 1 .. t, each with its h_{t-1}
  // inside the sequence (the group's lowest step >= 1).
  for (; t - kUnroll >= 0; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hp[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + (size_t)(t - q) * D;
      av[q] = to_float(a[o]);
      gv[q] = to_float(dh[o]);
      hp[q] = to_float(h[o - D]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + (size_t)(t - q) * D;
      const float g = __fadd_rn(gv[q], carry);
      store(db + o, g);
      store(da + o, __fmul_rn(g, hp[q]));
      carry = __fmul_rn(av[q], g);
    }
  }
  for (; t >= 0; --t) {
    const size_t o = base + (size_t)t * D;
    const float g = __fadd_rn(to_float(dh[o]), carry);
    const float prev = t > 0 ? to_float(h[o - D]) : first;
    store(db + o, g);
    store(da + o, __fmul_rn(g, prev));
    carry = __fmul_rn(to_float(a[o]), g);
  }
  dh0[(size_t)b * D + d] = carry;
}

template <typename T>
int launch(const void* a, const void* h, const void* dh, const void* dh_last, const void* h0,
           void* da, void* db, void* dh0, int B, int S, int D, cudaStream_t stream) {
  dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h), static_cast<const T*>(dh),
      static_cast<const float*>(dh_last), static_cast<const float*>(h0), static_cast<T*>(da),
      static_cast<T*>(db), static_cast<float*>(dh0), S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (a, h, dh, da, db): 0 = float32, 1 = bfloat16. dh_last and h0 may
// be null (zeros); dh0 is always written. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int rglru_scan_bwd(int dtype, const void* a, const void* h, const void* dh,
                              const void* dh_last, const void* h0, void* da, void* db,
                              void* dh0, int B, int S, int D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, h, dh, dh_last, h0, da, db, dh0, B, S, D, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, h, dh, dh_last, h0, da, db, dh0, B, S, D, st);
  return (int)cudaErrorInvalidValue;
}
