// RWKV-6 "Finch" WKV recurrence for Hopper, sm_90a: two designs, one file.
//
// Replaces the Pallas TPU kernel `wkv6` in src/repro/kernels/wkv6.py
// (pallas_call at line 99, body `_kernel` at line 29). Same function, per
// (batch b, head h), with a K x V float32 state S:
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//     S_t = diag(w_t) S_{t-1} + k_t^T v_t
// r/k/v/u in one dtype (float32 or bfloat16), w in float32 or that dtype,
// the state in float32 in and out, o in r's dtype. K, V <= 64.
//
// What bounds it on the H100: at rwkv6-1.6b's prefill shape (B = 8,
// S = 512, H = 32, K = V = 64, bf16 r/k/v, f32 w) it must move about
// 109 MB (r/k/v/w read once, o written once, the state read and written
// once), 0.033 ms at 3.35 TB/s; the recurrence's 4 K V flops per
// (b, h, step) take about as long at the FP32 rate. Neither bounds a
// step-by-step kernel: its time axis does (S dependent steps).
//
// The wrapper (kernels/wkv6.py) picks the design from (dtype, S) alone:
//
// 1. Chunked, `wkv6_chunked_fwd` (bf16 r and S >= kT = 64; its kernels are
//    in csrc/wkv6_chunk.cuh, shared with the backward): the time axis
//    is cut into chunks of 64 steps that run in parallel. With a_t =
//    log2 w_t (clamped below at -60 / ln 2, so that w = 0 or a w that
//    underflows gives no -inf and no NaN; its effect is below e^-60 of the
//    state) and G_t the chunk-local sum of a up to t:
//      o_t = (r_t 2^G_{t-1}) S_c + sum_{s<t} [sum_k r_t 2^(G_{t-1}-G_s) k_s] v_s
//            + (r_t . (u k_t)) v_t
//      S_{c+1} = diag(2^G_63) S_c + sum_s (k_s 2^(G_63 - G_s))^T v_s.
//    Three launches, in this order, no atomics:
//      a. `wkv6_chunk_state_kernel`, one block per (chunk, h, b): the
//         chunk's state contribution dS_c = (k 2^(G_63-G))^T v on the
//         tensor cores and its decay 2^G_63, into float32 scratch;
//      b. `wkv6_chunk_carry_kernel`, one thread per state element: the
//         short sequential pass S_{c+1} = diag(decay_c) S_c + dS_c in f32,
//         which overwrites each dS_c with S_c (the state entering chunk c)
//         and writes the last state; it alone reads the initial state, so
//         the last state may be written over it (the decode arena);
//      c. `wkv6_chunk_out_kernel`, one block per (chunk, h, b), 8 warps:
//         warp i < 4 owns query steps 16 i .. 16 i + 15 on the tensor
//         cores ((r 2^G) S_c, then each earlier 16-step block of keys, then
//         its own second half against its first half); warp i + 4
//         meanwhile forms the products inside each 8-step half on the CUDA
//         cores.
//    Every exponent is a sum of a's (<= 0) taken inside an 8-step half or
//    over whole halves, never a difference of two large running sums: the
//    running sums restart at each half; q_t = r_t 2^(L_{t-1}) is referenced
//    at its half's start, kh_s = k_s 2^(T - L_s) at its half's end, and the
//    decay over the halves between is a factor from a small table. Inside
//    a half the factor is the product w_{s+1} ... w_{t-1}, formed step by
//    step per channel (no exponentials, no quotient), with the bonus u on
//    its diagonal. The decayed operands, the scores and S_c go to the
//    tensor cores (mma.sync m16n8k16, f32 sums) as two bf16 parts, hi =
//    bf16(x) and lo = bf16(x - hi), in three products (hi hi, lo hi, hi lo):
//    about 16 significant bits. One bf16 part was not enough: with w near
//    1 the state sums hundreds of steps and the rounding of S_c and of the
//    decayed operands alone broke the 2e-2 tolerance against the
//    step-by-step recurrence. The state, the running sums and the decays
//    stay f32. `ref.wkv6_chunked_plain` repeats this arithmetic in plain
//    PyTorch.
//    What bounds it: the three launches move about three times the
//    function's bytes (k/v/w read twice, dS_c and S_c written and read
//    once each in f32), and the output kernel is latency-bound per block
//    (two blocks of 110 KB shared memory per SM).
// 2. Sequential, `wkv6_fwd` (float32 r, whose 2e-5 tolerance bf16
//    products cannot meet, or S < 64, as decode's S = 1): one block per
//    (b, h); the time loop runs inside the block with the state in
//    registers (thread j holds column S[:, j]); time is staged through
//    shared memory 32 steps at a time, converted to float32 once; rows
//    i >= K and columns j >= V are zero-filled, so a ragged S needs no
//    padding; per step each thread does 4 FMA chains over i, combined in
//    one fixed order. It is also what `previous_design` times.
// Both are the same bit for bit run to run. The final state may be
// written over the initial one: each thread reads its element(s) before
// it writes them, and blocks own disjoint slices. The sequential design
// takes an optional per-row `active` flag (decode over the arena): a row
// whose flag is off outputs 0 and keeps its state (copied to s_last when
// that is another buffer), so a held lease is not stepped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"  // the chunked route's kernels (wkv6c::)

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
    const bool* active,        // (B,) or null (every row)
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
  const size_t sbase = (size_t)bh * K * V;
  if (active != nullptr && !active[b]) {
    for (int t = 0; t < S && col; ++t) store(out + ((size_t)b * S + t) * H * V + (size_t)h * V + j, 0.f);
    if (col && s_last != s0) {
      for (int i = 0; i < K; ++i)
        s_last[sbase + (size_t)i * V + j] = s0 != nullptr ? s0[sbase + (size_t)i * V + j] : 0.f;
    }
    return;
  }

  su[j] = j < K ? to_float(u[(size_t)h * K + j]) : 0.f;

  float st[kMax];
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
           const void* s0, void* out, void* s_last, const void* active, int B, int S, int H,
           int K, int V, cudaStream_t stream) {
  wkv6_kernel<TR, TW><<<B * H, kThreads, 0, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k), static_cast<const TR*>(v),
      static_cast<const TW*>(w), static_cast<const TR*>(u), static_cast<const float*>(s0),
      static_cast<TR*>(out), static_cast<float*>(s_last), static_cast<const bool*>(active), S,
      H, K, V);
  return (int)cudaGetLastError();
}


}  // namespace

// r_dtype (r, k, v, u, out) and w_dtype: 0 = float32, 1 = bfloat16.
// s0 may be null (a zero initial state) and may equal s_last. active (B,)
// bool may be null (every row stepped).
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int wkv6_fwd(int r_dtype, int w_dtype, const void* r, const void* k,
                        const void* v, const void* w, const void* u, const void* s0,
                        void* out, void* s_last, const void* active, int B, int S, int H,
                        int K, int V, void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || K > kMax || V < 1 || V > kMax ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r_dtype == 0 && w_dtype == 0)
    return launch<float, float>(r, k, v, w, u, s0, out, s_last, active, B, S, H, K, V, st);
  if (r_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, s0, out, s_last, active, B, S, H, K, V,
                                        st);
  if (r_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, out, s_last, active, B, S,
                                                H, K, V, st);
  return (int)cudaErrorInvalidValue;
}

// The chunked design (see the header): r/k/v/u/out bfloat16; w_dtype 0 =
// float32, 1 = bfloat16. S >= 64. slots holds B H C K V floats and decay
// B H C K, C = ceil(S / 64). s0 may be null (a zero initial state) and may
// equal s_last. Returns the first failing launch's cudaError (0 on success).
extern "C" int wkv6_chunked_fwd(int w_dtype, const void* r, const void* k, const void* v,
                                const void* w, const void* u, const void* s0, void* out,
                                void* s_last, void* slots, void* decay, int B, int S, int H,
                                int K, int V, void* stream) {
  using wkv6c::bf16;
  using wkv6c::kT;
  if (B < 1 || S < kT || H < 1 || K < 1 || K > kMax || V < 1 || V > kMax || H > 65535 ||
      B > 65535 || (long long)B * H * K * V > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  wkv6c::ChunkArgs p{static_cast<const bf16*>(r), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), w, static_cast<const bf16*>(u),
              static_cast<const float*>(s0), static_cast<bf16*>(out),
              static_cast<float*>(s_last), static_cast<float*>(slots),
              static_cast<float*>(decay), S, H, K, V, (S + kT - 1) / kT, 0};
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(slots);
  p.vec = K % 8 == 0 && V % 8 == 0 && any % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return wkv6c::launch_chunked<float>(p, B, st);
  if (w_dtype == 1) return wkv6c::launch_chunked<bf16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
