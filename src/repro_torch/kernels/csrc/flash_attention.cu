// Causal / sliding-window GQA flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at line 148, body
// `_kernel` at line 37). Same function: arange positions, keys >= S masked,
// optional causal and window masks, online softmax in float32 with the
// same NEG_INF = -1e30 and l >= 1e-30 clamp, kv head h / (H / KV).
//
// What bounds it on the H100: at granite-3-2b's prefill shape (S = 512,
// H = 32, KV = 8, D = 64) the minimum traffic. With K/V shared by four
// query heads, causal work is about 0.4 * (S + 1) flops per byte of
// Q/K/V/out, some 205 at S = 512, below the card's ridge of ~295 flops per
// byte (989 TFLOP/s bf16 over 3.35 TB/s); the causal FLOP count over the
// tensor-core rate takes over from S of about 740. This first version
// reaches neither bound: it does not use the tensor cores (plain FMA, no
// mma/wgmma/TMA). Its design keeps the work it does well fed and skips the
// work the mask makes unnecessary:
//   - one block per (b, h, 64-query tile); the TPU grid's sequential kv
//     axis becomes a loop inside the block, with (m, l, acc) in registers;
//   - kv tiles wholly past S, wholly in the causal future or wholly outside
//     the window are skipped (the TPU kernel's block-sparse `run` test),
//     which halves the causal work;
//   - each 64x64 score tile is a register-blocked product: 256 threads,
//     4x4 scores each, Q and K held transposed in shared memory with
//     padded rows so every shared load is a broadcast or conflict-free;
//   - P goes through shared memory once and each thread accumulates a
//     4 x D/16 slice of the output in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16: ty picks 4 query rows, tx 4 key columns
constexpr int kQP = kBlockQ + 1;
constexpr int kKP = kBlockK + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_bytes(int D) {
  return ((size_t)D * kQP + (size_t)D * kKP + (size_t)kBlockK * D +
          (size_t)kBlockQ * kKP) * sizeof(float);
}

// NI: output columns per thread, d = tx + 16 * i for i < NI (NI >= D / 16).
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q,  // (B, S, H, D)
    const T* __restrict__ k,  // (B, S, KV, D)
    const T* __restrict__ v,  // (B, S, KV, D)
    T* __restrict__ out,      // (B, S, H, D)
    int S, int H, int KV, int D, int causal, int window, float scale) {
  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KV);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  extern __shared__ float smem[];
  float* qT = smem;              // D x kQP   (transposed Q tile)
  float* kT = qT + D * kQP;      // D x kKP   (transposed K tile)
  float* vs = kT + D * kKP;      // kBlockK x D
  float* ps = vs + kBlockK * D;  // kBlockQ x kKP

  const int q_lo = qt * kBlockQ;
  const size_t qrow = (size_t)H * D;
  const size_t krow = (size_t)KV * D;
  const T* qb = q + (size_t)b * S * qrow + (size_t)h * D;
  const T* kb = k + (size_t)b * S * krow + (size_t)kh * D;
  const T* vb = v + (size_t)b * S * krow + (size_t)kh * D;

  for (int e = tid; e < kBlockQ * D; e += kThreads) {
    const int i = e / D;
    const int d = e - i * D;
    const int s = q_lo + i;
    qT[d * kQP + i] = s < S ? to_float(qb[(size_t)s * qrow + d]) : 0.f;
  }

  float m[4], l[4], acc[4][NI];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  const int n_kv = (S + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_lo = kt * kBlockK;
    if (causal && k_lo > q_lo + kBlockQ - 1) break;  // wholly in the future
    if (window > 0 && k_lo + kBlockK - 1 <= q_lo - window) continue;  // outside

    __syncthreads();  // previous tile's readers are done with kT / vs / ps
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const int s = k_lo + j;
      float kv = 0.f, vv = 0.f;
      if (s < S) {
        kv = to_float(kb[(size_t)s * krow + d]);
        vv = to_float(vb[(size_t)s * krow + d]);
      }
      kT[d * kKP + j] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = qT[d * kQP + ty * 4 + r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bk[c] = kT[d * kKP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] = fmaf(a[r], bk[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q_lo + ty * 4 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k_lo + tx + 16 * c;
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        sc[r][c] = ok ? sc[r][c] * scale : kNegInf;
        mx = fmaxf(mx, sc[r][c]);
      }
      // The 16 lanes sharing ty hold one query row: reduce across them.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[r][c] - m_new);
        ps[(ty * 4 + r) * kKP + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBlockK; ++j) {
      float vv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int d = tx + 16 * i;
        vv[i] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = ps[(ty * 4 + r) * kKP + j];
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_lo + ty * 4 + r;
    if (qi >= S) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = out + ((size_t)b * S + qi) * qrow + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = tx + 16 * i;
      if (d < D) store(orow + d, acc[r][i] / lc);
    }
  }
}

template <typename T, int NI>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
           int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, NI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_attention_kernel<T, NI><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, H, KV, D, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S,
             int H, int KV, int D, int causal, int window, float scale,
             cudaStream_t st) {
  const int need = (D + 15) / 16;
  if (need <= 1) return launch<T, 1>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  if (need <= 2) return launch<T, 2>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  if (need <= 4) return launch<T, 4>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  if (need <= 8) return launch<T, 8>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  return launch<T, 16>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. causal: 0/1. window <= 0 means none.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* out, int B, int S, int H, int KV, int D,
                                   int causal, int window, float scale, void* stream) {
  if (D % 8 != 0 || D > 256 || KV < 1 || H % KV != 0 || B < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, KV, D, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
