// RG-LRU linear recurrence (RecurrentGemma / Griffin) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `rglru_scan` in src/repro/kernels/rglru.py
// (pallas_call at line 94, body `_kernel` at line 31). Same function, per
// (batch b, channel d):
//     h_t = a_t * h_{t-1} + b_t,   h_0 = h0 (zeros when absent)
// a and b in float32 or bfloat16 (one dtype), h carried in float32, the
// per-step h written in a's dtype, the last h in float32.
//
// What bounds it on the H100: bytes. Each element of a and b is read once
// and each h written once, with one multiply and one add per element: at
// recurrentgemma-9b's prefill shape (B = 8, S = 512, D = 4096, float32)
// that is 201 MB, 0.060 ms at 3.35 TB/s, and 0.03 GFLOP. The design only
// has to stream:
//   - one thread per (b, channel): the TPU grid's sequential time axis
//     becomes a loop with h in a register, channels tiled 128 to a block,
//     so each time step's loads and stores are contiguous across a warp;
//   - the loop is unrolled 8 steps deep with every load of a chunk issued
//     before its first use, so 16 loads per thread are in flight while the
//     dependent chain of h runs;
//   - a ragged channel width (D = 520) is bounds-checked, and a ragged S
//     needs no padding (the Pallas kernel pads with a = 1, b = 0);
//   - the multiply and the add are rounded separately, as `a * h + b` is
//     in the reference, not fused: float32 results are the plain
//     version's bit for bit.
// With B x D = 32,768 threads at the served shape the card is not full
// (about 8 warps per SM); splitting time into chunks with a second pass is
// later work.

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
__global__ void __launch_bounds__(kThreads) rglru_kernel(
    const T* __restrict__ a,       // (B, S, D)
    const T* __restrict__ bin,     // (B, S, D)
    const float* __restrict__ h0,  // (B, D) or null (zeros)
    T* __restrict__ out,           // (B, S, D)
    float* __restrict__ h_last,    // (B, D)
    int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  float h = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
  const size_t base = (size_t)b * S * D + d;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + (size_t)(t + q) * D;
      av[q] = to_float(a[o]);
      bv[q] = to_float(bin[o]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      h = __fadd_rn(__fmul_rn(av[q], h), bv[q]);
      store(out + base + (size_t)(t + q) * D, h);
    }
  }
  for (; t < S; ++t) {
    const size_t o = base + (size_t)t * D;
    h = __fadd_rn(__fmul_rn(to_float(a[o]), h), to_float(bin[o]));
    store(out + o, h);
  }
  h_last[(size_t)b * D + d] = h;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out, void* h_last, int B,
           int S, int D, cudaStream_t stream) {
  dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<float*>(h_last), S, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (a, b, out): 0 = float32, 1 = bfloat16. h0 may be null.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* b, const void* h0,
                              void* out, void* h_last, int B, int S, int D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, out, h_last, B, S, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0, out, h_last, B, S, D, st);
  return (int)cudaErrorInvalidValue;
}
