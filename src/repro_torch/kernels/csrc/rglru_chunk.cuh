// The RG-LRU recurrence's shared parts (sm_90a): the element helpers of
// csrc/rglru.cu and csrc/rglru_bwd.cu, and the carry kernel of their
// chunked routes. Each includer gets its own copy in an anonymous
// namespace.
//
// Both chunked routes run one channel-wise linear recurrence
//     y_u = c_u y_{u-1} + x_u
// over a walk u = 0 .. S-1 cut into chunks of L steps: the forward walks
// time forwards (c = a, x = b, y = h), the backward walks it backwards
// (its carry is the gradient h_t receives from step t + 1). Over a whole
// chunk the recurrence is affine in the carry that enters it,
//     y_out = P y_in + E,
// with P the product of the chunk's decays and E its end state from
// zero. Phase 1 writes (P, E) for every chunk but the walk's last (whose
// summary nothing reads); phase 2, `carry_kernel` below, walks the chunks
// in order per (b, channel) and writes the carry entering each; phase 3
// walks each chunk again from its carry and writes the outputs. Summaries
// and carries are float32, laid out (B, n, D) by walk index, so every
// load and store is contiguous across a warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace rglru {

constexpr int kThreads = 128;  // channels per block
constexpr int kUnroll = 8;     // steps whose loads are issued before their first use

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One step of the recurrence, the multiply and the add rounded apart
// (as `c * y + x` is in the plain versions, not fused).
__device__ __forceinline__ float step(float c, float y, float x) {
  return __fadd_rn(__fmul_rn(c, y), x);
}

// Phase 2. Per (b, channel): carry_0 = seed (zeros when null), carry_k =
// P_{k-1} carry_{k-1} + E_{k-1}, written into slot k of `ec`, whose
// slots 0 .. n-2 hold E on entry (slot k's E is read before carry_k
// lands there). `p` holds P in slots 0 .. n-2. Loads run kUnroll chunks
// ahead of the chain.
__global__ void __launch_bounds__(kThreads) carry_kernel(
    const float* __restrict__ p,     // (B, n, D)
    float* ec,                       // (B, n, D): E in, carries out
    const float* __restrict__ seed,  // (B, D) or null (zeros)
    int n, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)b * n * D + d;
  float carry = seed != nullptr ? seed[(size_t)b * D + d] : 0.f;
  int k = 0;
  for (; k + kUnroll <= n - 1; k += kUnroll) {
    float pv[kUnroll], ev[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      pv[q] = p[base + (size_t)(k + q) * D];
      ev[q] = ec[base + (size_t)(k + q) * D];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      ec[base + (size_t)(k + q) * D] = carry;
      carry = step(pv[q], carry, ev[q]);
    }
  }
  for (; k < n - 1; ++k) {
    const size_t o = base + (size_t)k * D;
    const float pk = p[o], ek = ec[o];
    ec[o] = carry;
    carry = step(pk, carry, ek);
  }
  ec[base + (size_t)(n - 1) * D] = carry;
}

inline int launch_carries(const float* p, float* ec, const float* seed, int B, int n, int D,
                          cudaStream_t stream) {
  dim3 grid((D + kThreads - 1) / kThreads, B);
  carry_kernel<<<grid, kThreads, 0, stream>>>(p, ec, seed, n, D);
  return (int)cudaGetLastError();
}

}  // namespace rglru
}  // namespace
