// Causal / sliding-window GQA flash attention (prefill) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention.py (pallas_call at line 148, body
// `_kernel` at line 37). Same function: arange positions, keys >= S masked,
// optional causal and window masks, online softmax in float32 with the
// same NEG_INF = -1e30 and l >= 1e-30 clamp, kv head h / (H / KV).
//
// Generalised beyond the Pallas kernel (both routes below):
//   - K and V may hold S_kv != S keys (cross-attention: whisper's decoder
//     over its encoder's frames). The wrapper allows it without a causal
//     mask or window only.
//   - optional int32 positions qpos (B, S) and kpos (B, S_kv): the causal
//     and window masks then compare position values, not indices
//     (M-RoPE's temporal stream, where an image's tokens share one
//     position and so attend to each other both ways). Precondition,
//     which the plain version checks and the kernel does not: under a
//     causal mask both are non-decreasing along S and kpos[0] <= qpos[0].
//     The causal tile skip then stays exact: a kv tile is skipped only
//     when its first (smallest) key position is past the query tile's last
//     (largest) query position, and the tiles kept are a prefix found by
//     binary search. With positions no tile is skipped for a window (the
//     element mask still applies it). Without positions every instruction
//     is the arange kernel's (`kPos` is a template argument).
//
// What bounds it on the H100: bytes, barely. At granite-3-2b's prefill
// shape (B = 8, S = 512, H = 32, KV = 8, D = 64, causal) Q, K and V read
// once and O written once are 41.9 MB (0.0125 ms at 3.35 TB/s) against
// 8.6 GFLOP of causal products (0.0087 ms at 989 TFLOP/s bf16); at
// recurrentgemma-9b's (H = 16, KV = 1, D = 256) 71.3 MB (0.0213 ms)
// against 17.2 GFLOP (0.0174 ms). Both are near the ridge, so the
// products have to run on the tensor cores and the loads have to overlap
// them.
//
// Two routes, chosen by dtype (a rule, not a fallback: a CUDA tensor of
// either dtype launches its kernel or the call raises):
//
// bf16 — `flash_wgmma_kernel`, on the tensor cores with wgmma:
//   - one block of two warpgroups (256 threads) per (b, h, 128 queries);
//     each warpgroup owns a 64-query tile, exactly one wgmma M, and the
//     two share every K/V tile in shared memory (half the K/V traffic per
//     query; one's softmax overlaps the other's products). The TPU grid's
//     sequential kv axis is a loop inside the block, in fixed order: no
//     split of S, no atomics, so a call is deterministic. Blocks late in
//     S, which see the most causal kv tiles, are scheduled first.
//   - Q (loaded once), and each K and V tile, sit in shared memory as
//     64-column blocks of 128-byte rows in the 128-byte swizzle that wgmma
//     reads; D is zero-padded to a multiple of 64 there (D = 8 ... 256)
//     and rows past S are zero-filled, so any D the wrapper takes and a
//     ragged S run through the same code.
//   - S = Q K^T: wgmma.mma_async m64n64k16, A = Q and B = K from shared
//     memory (both K-major), fp32 accumulators in registers.
//   - online softmax on the accumulator fragments in registers (exp2 of
//     log2-scaled scores); P is rounded to bf16, as the Pallas kernel does
//     (`p.astype(v.dtype)`), and becomes the register A operand of
//     O += P V: wgmma m64n64k16 per 64 columns of D, B = V from shared
//     memory (MN-major, transposed by the instruction).
//   - K/V tiles go through a 2-stage ring filled by cp.async (16 bytes a
//     thread, zero-fill for padding), so tile t+1 is in flight while tile
//     t is multiplied. kv tiles wholly past S, wholly in the causal
//     future or wholly outside the window are never loaded, and a
//     warpgroup skips the block's tiles its own rows do not need.
//
// Both routes (and `kPos`) also write, when given a non-null `lse`, the
// float32 log-sum-exp of each query row, (B, H, S), natural log: m + log(l)
// of the online softmax with the same l >= 1e-30 clamp. The backward
// (csrc/flash_attention_bwd.cu) recomputes P from it. The serving path
// passes null and writes nothing more.
//
// float32 — `flash_fma_kernel<float>`, the first port's design: a full
// float32 product has no tensor-core instruction and TF32 would break the
// reference's 2e-5 tolerance. One block of 256 threads per (b, h, 64-query
// tile), each 64x64 score tile a register-blocked FMA product over Q and K
// held transposed in shared memory, P kept in float32, same tile skips.
// Its bf16 instance is exported only as `flash_attention_fma_fwd`, the
// previous bf16 design, for side-by-side timing (`previous_design` in the
// wrapper module); `flash_attention` and `ops` never call it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"  // bf16, cp.async, load_tile, smem_desc, wgmma_*, pack_bf16

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // FMA kernel: 16 x 16, ty picks 4 query rows, tx 4 key columns
constexpr int kQP = kBlockQ + 1;
constexpr int kKP = kBlockK + 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t fma_smem_bytes(int D) {
  return ((size_t)D * kQP + (size_t)D * kKP + (size_t)kBlockK * D +
          (size_t)kBlockQ * kKP) * sizeof(float);
}

// NI: output columns per thread, d = tx + 16 * i for i < NI (NI >= D / 16).
template <typename T, int NI>
__global__ void __launch_bounds__(kThreads) flash_fma_kernel(
    const T* __restrict__ q,  // (B, S, H, D)
    const T* __restrict__ k,  // (B, S_kv, KV, D)
    const T* __restrict__ v,  // (B, S_kv, KV, D)
    T* __restrict__ out,      // (B, S, H, D)
    float* __restrict__ lse,  // (B, H, S) or null
    const int32_t* __restrict__ qpos,  // (B, S) or null = arange
    const int32_t* __restrict__ kpos,  // (B, S_kv) or null = arange
    int S, int Skv, int H, int KV, int D, int causal, int window, float scale) {
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
  const T* kb = k + (size_t)b * Skv * krow + (size_t)kh * D;
  const T* vb = v + (size_t)b * Skv * krow + (size_t)kh * D;
  const int32_t* qp = qpos != nullptr ? qpos + (size_t)b * S : nullptr;
  const int32_t* kp = kpos != nullptr ? kpos + (size_t)b * Skv : nullptr;
  // The tile's largest query position (positions non-decreasing).
  const int q_last = min(q_lo + kBlockQ, S) - 1;
  const int q_max = qp != nullptr ? qp[q_last] : q_last;

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

  const int n_kv = (Skv + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_lo = kt * kBlockK;
    // Wholly in the future: this tile's smallest key past the largest query.
    if (causal && (kp != nullptr ? kp[k_lo] : k_lo) > q_max) break;
    if (kp == nullptr && window > 0 && k_lo + kBlockK - 1 <= q_lo - window) continue;

    __syncthreads();  // previous tile's readers are done with kT / vs / ps
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const int s = k_lo + j;
      float kv = 0.f, vv = 0.f;
      if (s < Skv) {
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
      const int qv = qp != nullptr ? qp[min(qi, S - 1)] : qi;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k_lo + tx + 16 * c;
        const int kv = kp != nullptr ? kp[min(kj, Skv - 1)] : kj;
        bool ok = kj < Skv;
        if (causal) ok = ok && kv <= qv;
        if (window > 0) ok = ok && kv > qv - window;
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
    if (lse != nullptr && tx == 0) lse[((size_t)b * H + h) * S + qi] = m[r] + logf(lc);
    T* orow = out + ((size_t)b * S + qi) * qrow + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int d = tx + 16 * i;
      if (d < D) store(orow + d, acc[r][i] / lc);
    }
  }
}

// The shape and mask arguments every launch takes.
struct Shape {
  float* lse;                  // (B, H, S) or null
  const int32_t *qpos, *kpos;  // null = arange
  int B, S, Skv, H, KV, D, causal, window;
  float scale;
};

template <typename T, int NI>
int launch_fma(const void* q, const void* k, const void* v, void* out, const Shape& a,
               cudaStream_t stream) {
  const int B = a.B, S = a.S, H = a.H, D = a.D;
  const size_t smem = fma_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fma_kernel<T, NI>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  flash_fma_kernel<T, NI><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), a.lse, a.qpos, a.kpos, S, a.Skv, H, a.KV, D, a.causal, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fma(const void* q, const void* k, const void* v, void* out, const Shape& a,
                 cudaStream_t st) {
  const int need = (a.D + 15) / 16;
  if (need <= 1) return launch_fma<T, 1>(q, k, v, out, a, st);
  if (need <= 2) return launch_fma<T, 2>(q, k, v, out, a, st);
  if (need <= 4) return launch_fma<T, 4>(q, k, v, out, a, st);
  if (need <= 8) return launch_fma<T, 8>(q, k, v, out, a, st);
  return launch_fma<T, 16>(q, k, v, out, a, st);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma
// ---------------------------------------------------------------------------

// Accumulator fragment of a 64 x 64 f32 wgmma tile, thread t of the
// warpgroup (warp w = t / 32, lane l): d[4n + 2i + j] is row 16w + l/4 + 8i,
// column 8n + 2(l%4) + j. The same (row, pair of columns) layout is the A
// register fragment of a 64 x 16 tile: four bf16x2 for k-step kk come from
// columns 16kk..16kk+15, i.e. n = 2kk and 2kk+1.
//
// A block is two warpgroups, each with its own 64-query tile (queries
// 128 qb .. 128 qb + 127), sharing every K/V tile in shared memory: half
// the K/V traffic per query, and one warpgroup's softmax overlaps the
// other's products. Each warpgroup multiplies only the kv tiles its own
// rows need.
template <int DP, bool kPos>
__global__ void __launch_bounds__(kFlashThreads, 1) flash_wgmma_kernel(
    const bf16* __restrict__ q,  // (B, S, H, D)
    const bf16* __restrict__ k,  // (B, S_kv, KV, D)
    const bf16* __restrict__ v,  // (B, S_kv, KV, D)
    bf16* __restrict__ out,      // (B, S, H, D)
    float* __restrict__ lse,     // (B, H, S) or null
    const int32_t* __restrict__ qpos,  // (B, S), read when kPos
    const int32_t* __restrict__ kpos,  // (B, S_kv), read when kPos
    int S, int Skv, int H, int KV, int D, int causal, int window, float scale_log2) {
  constexpr int NB = DP / 64;                  // 64-column blocks of D
  constexpr int kTile = NB * kBlockBytes;      // one 64 x DP tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                    // Q0 | Q1 | K0 | K1 | V0 | V1
  const uint32_t sK = base + 2 * kTile;
  const uint32_t sV = base + 4 * kTile;

  // Heaviest query blocks first (the causal ones late in S see the most
  // kv tiles), heads of one kv head next to each other.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int kh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const size_t qrow = (size_t)H * D;
  const size_t krow = (size_t)KV * D;
  const bf16* kb = k + (size_t)b * Skv * krow + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * Skv * krow + (size_t)kh * D;
  const int32_t* qp = kPos ? qpos + (size_t)b * S : nullptr;
  const int32_t* kp = kPos ? kpos + (size_t)b * Skv : nullptr;

  // kv tiles the mask leaves work in, [lo, hi], for this warpgroup's rows
  // and for the block (the union, contiguous).
  const int n_kv = (Skv + kBlockK - 1) / kBlockK;
  auto kv_range = [&](int q_lo, int& lo, int& hi) {
    if (kPos) {
      lo = 0;
      hi = n_kv - 1;
      if (causal) {  // the prefix of tiles whose first key is <= the tile's last query
        const int q_max = qp[min(q_lo + kBlockQ, S) - 1];
        int a = 0, z = n_kv;
        while (a < z) {
          const int mid = (a + z) >> 1;
          if (kp[mid * kBlockK] <= q_max) a = mid + 1; else z = mid;
        }
        hi = a - 1;
      }
      return;
    }
    hi = causal ? min(n_kv - 1, (q_lo + kBlockQ - 1) / kBlockK) : n_kv - 1;
    const int first_key = q_lo - window + 1;  // smallest key a row here keeps
    lo = (window > 0 && first_key > 0) ? first_key / kBlockK : 0;
  };
  const int q_lo0 = qb * 2 * kBlockQ;
  const int q_lo = q_lo0 + wg * kBlockQ;
  const bool rows = q_lo < S;  // the second tile may lie wholly past S
  int my_lo, my_hi, kt_lo, kt_hi, lo1;
  kv_range(q_lo, my_lo, my_hi);
  kv_range(q_lo0, kt_lo, kt_hi);  // the first tile's range starts the block's,
  if (q_lo0 + kBlockQ < S) kv_range(q_lo0 + kBlockQ, lo1, kt_hi);  // the second's ends it

  load_tile<DP>(sQ, q + ((size_t)b * S + q_lo0) * qrow + (size_t)h * D, qrow, S - q_lo0, D,
                tid);
  if (q_lo0 + kBlockQ < S)
    load_tile<DP>(sQ + kTile, q + ((size_t)b * S + q_lo0 + kBlockQ) * qrow + (size_t)h * D,
                  qrow, S - q_lo0 - kBlockQ, D, tid);
  cp_async_commit();
  {
    const int k_lo = kt_lo * kBlockK;
    load_tile<DP>(sK, kb + (size_t)k_lo * krow, krow, Skv - k_lo, D, tid);
    load_tile<DP>(sV, vb + (size_t)k_lo * krow, krow, Skv - k_lo, D, tid);
    cp_async_commit();
  }

  float o[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sums
  const int row0 = q_lo + warp * 16 + (lane >> 2);
  const int col0 = 2 * (lane & 3);
  const uint32_t sQw = sQ + wg * kTile;
  int qv[2];  // kPos: this thread's two rows' mask positions
  if constexpr (kPos) {
#pragma unroll
    for (int i = 0; i < 2; ++i) qv[i] = qp[min(row0 + 8 * i, S - 1)];
  }

  int st = 0;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    if (kt < kt_hi) {  // next tile into the other stage, in flight during this one
      const int k_lo = (kt + 1) * kBlockK;
      load_tile<DP>(sK + (st ^ 1) * kTile, kb + (size_t)k_lo * krow, krow, Skv - k_lo, D, tid);
      load_tile<DP>(sV + (st ^ 1) * kTile, vb + (size_t)k_lo * krow, krow, Skv - k_lo, D, tid);
    }
    cp_async_commit();
    cp_async_wait1();  // Q and this tile have landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // ... and every thread's

    if (rows && kt >= my_lo && kt <= my_hi) {
      // S = Q K^T over DP / 16 k-steps of 16 columns.
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      const uint32_t kst = sK + st * kTile;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
        wgmma_ss(s, smem_desc(sQw + off, 16, 1024), smem_desc(kst + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);

      // Mask, scale (log2 units) and the online softmax on the fragments.
      // (Testing the mask only on tiles a mask reaches into measured
      // slower: the per-element test is cheaper than the branch.)
      const int k_lo = kt * kBlockK;
      int kv[8][2];  // kPos: this thread's 16 columns' mask positions
      if constexpr (kPos) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) kv[n][j] = kp[min(k_lo + 8 * n + col0 + j, Skv - 1)];
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kj = k_lo + 8 * n + col0 + j;
            bool ok = kj < Skv;
            if constexpr (kPos) {
              if (causal) ok = ok && kv[n][j] <= qv[i];
              if (window > 0) ok = ok && kv[n][j] > qv[i] - window;
            } else {
              const int qi = row0 + 8 * i;
              if (causal) ok = ok && kj <= qi;
              if (window > 0) ok = ok && kj > qi - window;
            }
            float& x = s[4 * n + 2 * i + j];
            x = ok ? x * scale_log2 : kNegInf;
            mx[i] = fmaxf(mx[i], x);
          }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp2f(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
      uint32_t pa[4][4];  // P as bf16: the A fragments of the four 16-key k-steps
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = exp2f(s[4 * n + 2 * i] - m[i]);
          const float p1 = exp2f(s[4 * n + 2 * i + 1] - m[i]);
          l[i] += p0 + p1;
          pa[n >> 1][2 * (n & 1) + i] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= alpha[(e >> 1) & 1];

      // O += P V, per 64-column block of V, over four 16-key k-steps.
      const uint32_t vst = sV + st * kTile;
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(o[c]);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs(o[c], pa[kk], smem_desc(vst + c * kBlockBytes + kk * 2048, 1024, 1024));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < NB; ++c) fence_regs(o[c]);
    }
    __syncthreads();  // both warpgroups are done with this stage before it is refilled
    st ^= 1;
  }

  if (!rows) return;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi >= S) continue;
    // m is in log2 units (scores scaled by scale * log2 e).
    if (lse != nullptr && (lane & 3) == 0)
      lse[((size_t)b * H + h) * S + qi] = (m[i] + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
    bf16* orow = out + ((size_t)b * S + qi) * qrow + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 64 * c + 8 * n + col0;
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
              o[c][4 * n + 2 * i] * inv[i], o[c][4 * n + 2 * i + 1] * inv[i]);
      }
  }
}

template <int DP, bool kPos>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, const Shape& a,
                 cudaStream_t stream) {
  // Two Q tiles, two K and two V stages, + alignment slack.
  const size_t smem = 6 * (size_t)(DP / 64) * kBlockBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<DP, kPos>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.H, a.B, (a.S + 2 * kBlockQ - 1) / (2 * kBlockQ));
  flash_wgmma_kernel<DP, kPos><<<grid, kFlashThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), a.lse, a.qpos, a.kpos, a.S, a.Skv, a.H, a.KV, a.D, a.causal,
      a.window,
      a.scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_wgmma(const void* q, const void* k, const void* v, void* out, const Shape& a,
                   cudaStream_t st) {
  if (a.qpos != nullptr) return launch_wgmma<DP, true>(q, k, v, out, a, st);
  return launch_wgmma<DP, false>(q, k, v, out, a, st);
}

// S_kv != S only without a causal mask or window; positions come in pairs.
bool bad_shape(const Shape& a) {
  return a.D % 8 != 0 || a.D > 256 || a.KV < 1 || a.H % a.KV != 0 || a.B < 1 || a.S < 1 ||
         a.Skv < 1 || (a.Skv != a.S && (a.causal || a.window > 0)) ||
         ((a.qpos == nullptr) != (a.kpos == nullptr));
}

}  // namespace

// dtype: 0 = float32 (FMA kernel), 1 = bfloat16 (wgmma kernel). qpos /
// kpos: int32 (B, S) / (B, S_kv) mask positions, or both null for arange.
// causal: 0/1. window <= 0 means none. lse: float32 (B, H, S), or null to
// write none. Returns the launch's cudaGetLastError() (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* out, void* lse, const void* qpos, const void* kpos,
                                   int B, int S, int Skv, int H, int KV, int D, int causal,
                                   int window, float scale, void* stream) {
  const Shape a{static_cast<float*>(lse), static_cast<const int32_t*>(qpos),
                static_cast<const int32_t*>(kpos),
                B, S, Skv, H, KV, D, causal, window, scale};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fma<float>(q, k, v, out, a, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 64) return dispatch_wgmma<64>(q, k, v, out, a, st);
  if (D <= 128) return dispatch_wgmma<128>(q, k, v, out, a, st);
  if (D <= 192) return dispatch_wgmma<192>(q, k, v, out, a, st);
  return dispatch_wgmma<256>(q, k, v, out, a, st);
}

// The previous bf16 design (the FMA kernel: the float32 route's
// template, here at either dtype), kept for side-by-side timing only. Same
// arguments as flash_attention_fwd.
extern "C" int flash_attention_fma_fwd(int dtype, const void* q, const void* k,
                                       const void* v, void* out, void* lse, const void* qpos,
                                       const void* kpos, int B, int S, int Skv, int H, int KV,
                                       int D, int causal, int window, float scale,
                                       void* stream) {
  const Shape a{static_cast<float*>(lse), static_cast<const int32_t*>(qpos),
                static_cast<const int32_t*>(kpos),
                B, S, Skv, H, KV, D, causal, window, scale};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_fma<float>(q, k, v, out, a, st);
  if (dtype == 1) return dispatch_fma<__nv_bfloat16>(q, k, v, out, a, st);
  return (int)cudaErrorInvalidValue;
}
