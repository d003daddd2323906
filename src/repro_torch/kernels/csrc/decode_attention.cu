// Single-token decode attention (flash-decoding) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (pallas_call at line 145, body
// `_kernel` at line 40). Same function: one new token per row attends to
// its KV cache through a position-driven mask
//     kv_pos <= cursor  &  kv_valid  &  active  [& kv_pos > cursor - window]
// with an online softmax in float32, tiles with no live slot skipped, and a
// row with no live slot writing exact 0.
//
// What bounds it on the H100: bytes. Per (row, kv head) it reads the live
// part of the K and V cache once and does 4*G*D flops per key, about
// 2*G = 8 flops per byte at granite's G=4 in bf16, far below the ~295
// flops/byte where the tensor cores would become the limit. So the design
// only has to stream K/V once and keep everything else on chip:
//   - one block per (row b, kv head): the G query heads that share a kv
//     head are processed together, so each K/V byte is read once for all
//     G heads (the TPU kernel's (G, D) tile, for the same reason); only a
//     group too large for shared memory (G * D in the thousands) is split
//     over several blocks, each re-reading the head's K/V;
//   - the TPU grid's sequential kv axis becomes a loop inside the block,
//     and the running max / sum / accumulator (m, l, acc) live in shared
//     memory across tiles instead of VMEM scratch across grid steps;
//   - each tile first computes its live-slot bitmap; a tile with no live
//     slot is skipped before any K/V byte is read (dead arena rows and a
//     ring cache's unwritten tail cost no bandwidth), and dead slots of a
//     live tile are not loaded either;
//   - K/V rows are loaded 16 bytes per thread; K rows sit in shared memory
//     at a padded stride, so the score loop is free of bank conflicts.
// No atomics and no split of S across blocks: the summation order is
// fixed, so a step is deterministic run to run.
// Plain FMA arithmetic; no tensor cores, TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockK = 64;    // keys per tile
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int G, int D) {
  const size_t floats = (size_t)G * D            // q
                        + (size_t)kBlockK * (D + 1)  // K tile, padded rows
                        + (size_t)kBlockK * D        // V tile
                        + (size_t)G * kBlockK        // scores / probabilities
                        + (size_t)G * D              // accumulator
                        + 3 * (size_t)G;             // m, l, alpha
  return floats * sizeof(float) + kBlockK * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q,              // (B, 1, H, D)
    const T* __restrict__ k,              // (B, S, KV, D)
    const T* __restrict__ v,              // (B, S, KV, D)
    const int32_t* __restrict__ cursor,   // (B,)
    const int32_t* __restrict__ kv_pos,   // (B, S)
    const uint8_t* __restrict__ kv_valid, // (B, S)
    const uint8_t* __restrict__ active,   // (B,) or null = every row live
    T* __restrict__ out,                  // (B, 1, H, D)
    int S, int KV, int G_all, int G_chunk, int D, int window, float scale) {
  // blockIdx.x = kv head * chunks + chunk: the G_all query heads of a kv
  // head are taken G_chunk at a time when they do not fit shared memory
  // together (each chunk then re-reads that head's K/V).
  const int chunks = (G_all + G_chunk - 1) / G_chunk;
  const int kh = blockIdx.x / chunks;
  const int g_lo = (blockIdx.x - kh * chunks) * G_chunk;
  const int G = min(G_chunk, G_all - g_lo);
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int H = KV * G_all;
  const int DP = D + 1;

  extern __shared__ float smem[];
  float* qs = smem;                   // G x D
  float* ks = qs + G * D;             // kBlockK x DP
  float* vs = ks + kBlockK * DP;      // kBlockK x D
  float* ps = vs + kBlockK * D;       // G x kBlockK
  float* acc = ps + G * kBlockK;      // G x D
  float* m_s = acc + G * D;           // G
  float* l_s = m_s + G;               // G
  float* a_s = l_s + G;               // G
  int* live = reinterpret_cast<int*>(a_s + G);  // kBlockK

  // The query heads of kv head kh are contiguous in H (h = kh * G_all + g).
  const size_t head0 = ((size_t)b * H + (size_t)kh * G_all + g_lo) * D;
  T* ob = out + head0;
  if (active != nullptr && active[b] == 0) {
    for (int e = tid; e < G * D; e += kThreads) store(ob + e, 0.f);
    return;
  }
  const T* qb = q + head0;
  for (int e = tid; e < G * D; e += kThreads) {
    qs[e] = to_float(qb[e]);
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int cur = cursor[b];
  const int32_t* pos_b = kv_pos + (size_t)b * S;
  const uint8_t* val_b = kv_valid + (size_t)b * S;
  const size_t row = (size_t)KV * D;  // elements between consecutive slots
  const T* kb = k + (size_t)b * S * row + (size_t)kh * D;
  const T* vb = v + (size_t)b * S * row + (size_t)kh * D;
  const int d8 = D / 8;
  __syncthreads();

  for (int t0 = 0; t0 < S; t0 += kBlockK) {
    int any = 0;
    for (int j = tid; j < kBlockK; j += kThreads) {
      const int s = t0 + j;
      int ok = 0;
      if (s < S) {
        const int p = pos_b[s];
        ok = (p <= cur) && (val_b[s] != 0);
        if (window > 0) ok = ok && (p > cur - window);
      }
      live[j] = ok;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;  // no live slot: skip the tile

    for (int e = tid; e < kBlockK * d8; e += kThreads) {
      const int j = e / d8;
      const int c = (e - j * d8) * 8;
      float kf[8], vf[8];
      if (live[j]) {
        const size_t off = (size_t)(t0 + j) * row + c;
        load8(kb + off, kf);
        load8(vb + off, vf);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ks[j * DP + c + i] = kf[i];
        vs[j * D + c + i] = vf[i];
      }
    }
    __syncthreads();

    for (int e = tid; e < G * kBlockK; e += kThreads) {
      const int g = e / kBlockK;
      const int j = e - g * kBlockK;
      float sc = kNegInf;
      if (live[j]) {
        const float* qr = qs + g * D;
        const float* kr = ks + j * DP;
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a * scale;
      }
      ps[e] = sc;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pr = ps + g * kBlockK;
      float mx = kNegInf;
      for (int j = lane; j < kBlockK; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kBlockK; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      const int d = e - g * D;
      const float* pr = ps + g * kBlockK;
      float a = 0.f;
      for (int j = 0; j < kBlockK; ++j) a = fmaf(pr[j], vs[j * D + d], a);
      acc[e] = acc[e] * a_s[g] + a;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * D; e += kThreads) {
    const float l = fmaxf(l_s[e / D], 1e-30f);
    store(ob + e, acc[e] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cursor,
           const void* kv_pos, const void* kv_valid, const void* active, void* out,
           int B, int S, int KV, int G, int D, int window, float scale,
           cudaStream_t stream) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int g_chunk = G;  // as many query heads per block as shared memory holds
  while (g_chunk > 1 && smem_bytes(g_chunk, D) > (size_t)smem_max) g_chunk = (g_chunk + 1) / 2;
  const size_t smem = smem_bytes(g_chunk, D);
  err = cudaFuncSetAttribute(decode_attention_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV * ((G + g_chunk - 1) / g_chunk), B);
  decode_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(cursor), static_cast<const int32_t*>(kv_pos),
      static_cast<const uint8_t*>(kv_valid), static_cast<const uint8_t*>(active),
      static_cast<T*>(out), S, KV, G, g_chunk, D, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, const void* cursor,
                                    const void* kv_pos, const void* kv_valid,
                                    const void* active, void* out, int B, int S,
                                    int KV, int G, int D, int window, float scale,
                                    void* stream) {
  if (D % 8 != 0 || D > 256 || G < 1 || KV < 1 || B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, cursor, kv_pos, kv_valid, active, out, B, S, KV,
                         G, D, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, cursor, kv_pos, kv_valid, active, out, B,
                                 S, KV, G, D, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
