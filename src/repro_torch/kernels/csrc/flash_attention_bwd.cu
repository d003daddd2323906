// The backward of flash attention (dQ, dK, dV) for Hopper, sm_90a.
//
// Replaces the reference's training gradient of attention: XLA's autodiff
// of the blocked `flash_attention_xla` (src/repro/models/attention.py:117),
// which `jax.value_and_grad` runs through `impl="xla"` in
// src/repro/training/train_loop.py:123,140. The Pallas TPU kernel
// `flash_attention` (src/repro/kernels/flash_attention.py:148) is forward
// only; csrc/flash_attention.cu is its port, and its forward writes the
// log-sum-exp (LSE) this backward reads.
//
// Same function as the plain `flash_attention_bwd_plain` in kernels/ref.py,
// the FlashAttention-2 recurrences from the saved LSE, with no atomics (a
// call is deterministic):
//   1. `delta_kernel`: Delta = rowsum(dO * O) in float32, (B, H, S).
//   2. `dkdv_kernel`, one block per (kv tile of 64 keys, kv head, b): K and
//      V of the tile stay in shared memory; over the H / KV query heads of
//      the group and the query tiles the mask reaches, it recomputes
//      S = Q K^T, P = exp(S scale - LSE), dP = dO V^T, dS = P (dP - Delta),
//      and accumulates dV += P^T dO and dK += dS^T Q in float32 registers.
//   3. `dq_kernel`, one block per (query tile of 64, head, b): Q, dO, LSE
//      and Delta stay in shared memory; over the kv tiles the mask reaches
//      it recomputes P and dS and accumulates dQ += dS K.
// Masks are the forward's (arange causal, window, non-causal with
// S_kv != S, position-valued q_pos / kv_pos), through one predicate,
// `attends`, and tiles wholly masked are skipped by `tile_live`, the
// forward's tile skip.
//
// Both routes run the same code; only the tile product `warp_gemm` and the
// operand type differ (a rule by dtype, not a fallback):
//   - bfloat16: mma.sync.m16n8k16 on the tensor cores, float32 accumulate.
//     P is rounded to bf16 before dV += P^T dO (as the forward rounds P
//     before P V) and dS before dQ and dK: the tensor cores' operands.
//   - float32: the same tiles as register-blocked FMA products in the mma's
//     fragment layout, nothing rounded (the reference's 2e-5 tolerance
//     rules out TF32).
//
// What bounds it on the H100: operations. At granite-3-2b's training shape
// (B = 8, S = 1024, H = 32, KV = 8, D = 64, causal) the five products over
// the 134.3 M causal (query, key) pairs are 85.9 GFLOP, 0.0869 ms at 989
// TFLOP/s bf16, against about 170 MB read and written once (Q, K, V, O,
// dO, LSE in; dQ, dK, dV out), 0.0507 ms at 3.35 TB/s. This first design
// is simple and right, not fast: operands are staged by plain 16-byte
// loads, fragments read from shared memory without ldmatrix, and S and dP
// are computed twice (once per kernel). Its time stands beside the bound
// in PERF.md; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kTile = 64;  // queries per query tile, keys per kv tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

// Shared-memory geometry of one route: rows of DP (D padded to 64, 128 or
// 256) operand elements plus 16 bytes, and 64 + 16 bytes' worth for the
// 64 x 64 P and dS tiles, so that a warp's fragment reads spread over the
// banks and every row starts 16-byte aligned.
template <typename T, int DP>
struct Geo {
  static constexpr int CH = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  static constexpr int LD = DP + CH;
  static constexpr int PLD = kTile + CH;
  static constexpr int NC = DP / 64;   // 64-column blocks of D
  static constexpr int THREADS = 128 * NC;
};

// Everything a launch takes.
struct Args {
  const void *q, *k, *v, *o, *dout;  // (B, S, H, D), (B, S_kv, KV, D) x2, (B, S, H, D) x2
  const float* lse;                  // (B, H, S), natural log
  float* delta;                      // (B, H, S) scratch
  void *dq, *dk, *dv;
  const int32_t *qpos, *kpos;        // (B, S), (B, S_kv) or both null = arange
  int B, S, Skv, H, KV, D, causal, window;
  float scale;
};

// Whether query qi (mask position qv) attends to key kj (position kv): the
// forward's element mask.
__device__ __forceinline__ bool attends(int qi, int kj, int qv, int kv, const Args& a) {
  if (qi >= a.S || kj >= a.Skv) return false;
  if (a.causal && kv > qv) return false;
  if (a.window > 0 && kv <= qv - a.window) return false;
  return true;
}

// False only when the forward skips the (query tile, kv tile) pair: every
// pair in it is masked. With positions (non-decreasing, the forward's
// precondition) only the causal skip applies, as in the forward.
__device__ __forceinline__ bool tile_live(int q_lo, int k_lo, const int32_t* qp,
                                          const int32_t* kp, const Args& a) {
  const int q_last = min(q_lo + kTile, a.S) - 1;
  if (kp != nullptr) return !(a.causal && kp[k_lo] > qp[q_last]);
  if (a.causal && k_lo > q_last) return false;
  if (a.window > 0 && k_lo + kTile - 1 <= q_lo - a.window) return false;
  return true;
}

// Rows [0, rows) of a strided (rows_total x D) matrix into a 64 x DP tile
// of row stride LD, in 16-byte chunks; rows >= rows and columns >= D are 0.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(T* dst, const T* src, size_t stride, int rows,
                                          int D) {
  using G = Geo<T, DP>;
  constexpr int kChunks = DP / G::CH;  // per row
  for (int c = threadIdx.x; c < kTile * kChunks; c += G::THREADS) {
    const int r = c / kChunks;
    const int col = (c - r * kChunks) * G::CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && col < D) val = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + col);
    *reinterpret_cast<uint4*>(dst + r * G::LD + col) = val;
  }
}

// ---------------------------------------------------------------------------
// Tile products: acc[NT][4], a 16 x 8NT tile in mma.sync's C-fragment layout
// (lane l holds rows l/4 and l/4 + 8, columns 8n + 2(l%4) + {0, 1}), plus
// A (16 x K) B (K x 8NT), both from shared memory:
// A(r, kk) = a[r * ars + kk * aks], B(kk, n) = b[kk * bks + n * bns].
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p[0] and p[step] as one bf16x2 register, p[0] in the low half. With
// step 1, p is 4-byte aligned (an even element index in an even-strided row).
__device__ __forceinline__ uint32_t pack2(const bf16* p, int step) {
  if (step == 1) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + step);
  return lo | (hi << 16);
}

// bf16: K % 16 == 0; m16n8k16 fragments (A: rows g, g + 8, k pairs 2t, 2t + 8;
// B: k pairs 2t, 2t + 8 of column g).
template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const bf16* a, int ars, int aks,
                                          const bf16* b, int bks, int bns, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int ka = k0 + 2 * t;
    uint32_t af[4];
    af[0] = pack2(a + g * ars + ka * aks, aks);
    af[1] = pack2(a + (g + 8) * ars + ka * aks, aks);
    af[2] = pack2(a + g * ars + (ka + 8) * aks, aks);
    af[3] = pack2(a + (g + 8) * ars + (ka + 8) * aks, aks);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* bp = b + (8 * n + g) * bns;
      mma_bf16(acc[n], af, pack2(bp + ka * bks, bks), pack2(bp + (ka + 8) * bks, bks));
    }
  }
}

// float32: the same tile and layout by FMA, one k at a time.
template <int NT>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const float* a, int ars, int aks,
                                          const float* b, int bks, int bns, int K) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  for (int kk = 0; kk < K; ++kk) {
    const float a0 = a[g * ars + kk * aks];
    const float a1 = a[(g + 8) * ars + kk * aks];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float b0 = b[kk * bks + (8 * n + 2 * t) * bns];
      const float b1 = b[kk * bks + (8 * n + 2 * t + 1) * bns];
      acc[n][0] = fmaf(a0, b0, acc[n][0]);
      acc[n][1] = fmaf(a0, b1, acc[n][1]);
      acc[n][2] = fmaf(a1, b0, acc[n][2]);
      acc[n][3] = fmaf(a1, b1, acc[n][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// One warp's part of a (query tile, kv tile) step: S and dP for its 16
// query rows (16 wr ..) and 64 / NC keys (c0 ..), then P = exp(S scale -
// LSE) under the mask and dS = P (dP - Delta), written (in T: the operand
// rounding) to Ps (when given) and dSs, both [query][key].
template <typename T, int DP>
__device__ __forceinline__ void p_and_ds(const T* Qs, const T* dOs, const T* Ks, const T* Vs,
                                         const float* lse_s, const float* delta_s,
                                         const int* qpos_s, const int* kpos_s, int q_lo,
                                         int k_lo, const Args& a, T* Ps, T* dSs) {
  using G = Geo<T, DP>;
  constexpr int NTS = 8 / G::NC;  // 8-key column tiles per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 3);
  const int c0 = (warp >> 2) * (kTile / G::NC);
  const int kdim = (a.D + 15) & ~15;
  float s[NTS][4], dp[NTS][4];
  zero(s);
  zero(dp);
  warp_gemm<NTS>(s, Qs + r0 * G::LD, G::LD, 1, Ks + c0 * G::LD, 1, G::LD, kdim);
  warp_gemm<NTS>(dp, dOs + r0 * G::LD, G::LD, 1, Vs + c0 * G::LD, 1, G::LD, kdim);
#pragma unroll
  for (int n = 0; n < NTS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (lane >> 2) + 8 * (e >> 1);
      const int c = c0 + 8 * n + 2 * (lane & 3) + (e & 1);
      const bool ok = attends(q_lo + r, k_lo + c, qpos_s[r], kpos_s[c], a);
      const float p = ok ? expf(s[n][e] * a.scale - lse_s[r]) : 0.f;
      if (Ps != nullptr) store(Ps + r * G::PLD + c, p);
      store(dSs + r * G::PLD + c, p * (dp[n][e] - delta_s[r]));
    }
}

// Query rows [q_lo, q_lo + 64) of head h: LSE, Delta and mask positions.
template <int THREADS>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s, int* qpos_s,
                                               const int32_t* qp, int b, int h, int q_lo,
                                               const Args& a) {
  for (int r = threadIdx.x; r < kTile; r += THREADS) {
    const int qi = q_lo + r;
    const bool in = qi < a.S;
    const size_t at = ((size_t)b * a.H + h) * a.S + qi;
    lse_s[r] = in ? a.lse[at] : 0.f;
    delta_s[r] = in ? a.delta[at] : 0.f;
    qpos_s[r] = in ? (qp != nullptr ? qp[qi] : qi) : 0;
  }
}

template <int THREADS>
__device__ __forceinline__ void load_key_pos(int* kpos_s, const int32_t* kp, int k_lo,
                                             const Args& a) {
  for (int c = threadIdx.x; c < kTile; c += THREADS) {
    const int kj = k_lo + c;
    kpos_s[c] = kj < a.Skv ? (kp != nullptr ? kp[kj] : kj) : 0;
  }
}

// ---------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O): one warp per (b, query, head) row.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void delta_kernel(Args a) {
  const size_t row = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)a.B * a.S * a.H) return;
  const int h = (int)(row % a.H);
  const size_t bs = row / a.H;
  const int i = (int)(bs % a.S);
  const int b = (int)(bs / a.S);
  const T* o = static_cast<const T*>(a.o) + row * a.D;
  const T* d = static_cast<const T*>(a.dout) + row * a.D;
  float acc = 0.f;
  for (int c = lane; c < a.D; c += 32) acc = fmaf(to_float(o[c]), to_float(d[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[((size_t)b * a.H + h) * a.S + i] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK and dV: one block per (kv tile, kv head, b). Warp (wr, wc) owns kv
//    rows 16 wr .. 16 wr + 15 and D columns 64 wc .. 64 wc + 63 of both.
// ---------------------------------------------------------------------------

template <typename T, int DP>
size_t dkdv_smem_bytes() {
  using G = Geo<T, DP>;
  return (4 * (size_t)kTile * G::LD + 2 * (size_t)kTile * G::PLD) * sizeof(T) +
         4 * kTile * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(Geo<T, DP>::THREADS) dkdv_kernel(Args a) {
  using G = Geo<T, DP>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kTile * G::LD;
  T* Qs = Vs + kTile * G::LD;
  T* dOs = Qs + kTile * G::LD;
  T* Ps = dOs + kTile * G::LD;
  T* dSs = Ps + kTile * G::PLD;
  float* lse_s = reinterpret_cast<float*>(dSs + kTile * G::PLD);
  float* delta_s = lse_s + kTile;
  int* qpos_s = reinterpret_cast<int*>(delta_s + kTile);
  int* kpos_s = qpos_s + kTile;

  const int k_lo = blockIdx.x * kTile;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = a.H / a.KV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 3);
  const int d0 = 64 * (warp >> 2);
  const size_t qrow = (size_t)a.H * a.D;
  const size_t krow = (size_t)a.KV * a.D;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int32_t* qp = a.qpos != nullptr ? a.qpos + (size_t)b * a.S : nullptr;
  const int32_t* kp = a.kpos != nullptr ? a.kpos + (size_t)b * a.Skv : nullptr;

  const size_t kv_at = ((size_t)b * a.Skv + k_lo) * krow + (size_t)kh * a.D;
  load_rows<T, DP>(Ks, static_cast<const T*>(a.k) + kv_at, krow, a.Skv - k_lo, a.D);
  load_rows<T, DP>(Vs, static_cast<const T*>(a.v) + kv_at, krow, a.Skv - k_lo, a.D);
  load_key_pos<G::THREADS>(kpos_s, kp, k_lo, a);

  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const int n_q = (a.S + kTile - 1) / kTile;
  for (int h = kh * group; h < (kh + 1) * group; ++h) {
    for (int it = 0; it < n_q; ++it) {
      const int q_lo = it * kTile;
      if (!tile_live(q_lo, k_lo, qp, kp, a)) continue;  // the same for the whole block
      __syncthreads();  // the last step's readers are done with Qs, dOs, Ps, dSs
      const size_t q_at = ((size_t)b * a.S + q_lo) * qrow + (size_t)h * a.D;
      load_rows<T, DP>(Qs, q + q_at, qrow, a.S - q_lo, a.D);
      load_rows<T, DP>(dOs, dout + q_at, qrow, a.S - q_lo, a.D);
      load_row_stats<G::THREADS>(lse_s, delta_s, qpos_s, qp, b, h, q_lo, a);
      __syncthreads();
      p_and_ds<T, DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, qpos_s, kpos_s, q_lo, k_lo, a, Ps, dSs);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's 64 queries.
      warp_gemm<8>(dv, Ps + r0, 1, G::PLD, dOs + d0, G::LD, 1, kTile);
      warp_gemm<8>(dk, dSs + r0, 1, G::PLD, Qs + d0, G::LD, 1, kTile);
    }
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = k_lo + r0 + (lane >> 2) + 8 * (e >> 1);
      const int c = d0 + 8 * n + 2 * (lane & 3) + (e & 1);
      if (kj < a.Skv && c < a.D) {
        const size_t at = ((size_t)b * a.Skv + kj) * krow + (size_t)kh * a.D + c;
        store(dk_out + at, dk[n][e] * a.scale);
        store(dv_out + at, dv[n][e]);
      }
    }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (query tile, head, b). Warp (wr, wc) owns query rows
//    16 wr .. 16 wr + 15 and D columns 64 wc .. 64 wc + 63.
// ---------------------------------------------------------------------------

template <typename T, int DP>
size_t dq_smem_bytes() {
  using G = Geo<T, DP>;
  return (4 * (size_t)kTile * G::LD + (size_t)kTile * G::PLD) * sizeof(T) +
         4 * kTile * sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(Geo<T, DP>::THREADS) dq_kernel(Args a) {
  using G = Geo<T, DP>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kTile * G::LD;
  T* Ks = dOs + kTile * G::LD;
  T* Vs = Ks + kTile * G::LD;
  T* dSs = Vs + kTile * G::LD;
  float* lse_s = reinterpret_cast<float*>(dSs + kTile * G::PLD);
  float* delta_s = lse_s + kTile;
  int* qpos_s = reinterpret_cast<int*>(delta_s + kTile);
  int* kpos_s = qpos_s + kTile;

  const int q_lo = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (a.H / a.KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 3);
  const int d0 = 64 * (warp >> 2);
  const size_t qrow = (size_t)a.H * a.D;
  const size_t krow = (size_t)a.KV * a.D;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int32_t* qp = a.qpos != nullptr ? a.qpos + (size_t)b * a.S : nullptr;
  const int32_t* kp = a.kpos != nullptr ? a.kpos + (size_t)b * a.Skv : nullptr;

  const size_t q_at = ((size_t)b * a.S + q_lo) * qrow + (size_t)h * a.D;
  load_rows<T, DP>(Qs, static_cast<const T*>(a.q) + q_at, qrow, a.S - q_lo, a.D);
  load_rows<T, DP>(dOs, static_cast<const T*>(a.dout) + q_at, qrow, a.S - q_lo, a.D);
  load_row_stats<G::THREADS>(lse_s, delta_s, qpos_s, qp, b, h, q_lo, a);

  float dq[8][4];
  zero(dq);
  const int n_kv = (a.Skv + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_lo = kt * kTile;
    if (!tile_live(q_lo, k_lo, qp, kp, a)) continue;  // the same for the whole block
    __syncthreads();  // the last step's readers are done with Ks, Vs, dSs
    const size_t kv_at = ((size_t)b * a.Skv + k_lo) * krow + (size_t)kh * a.D;
    load_rows<T, DP>(Ks, k + kv_at, krow, a.Skv - k_lo, a.D);
    load_rows<T, DP>(Vs, v + kv_at, krow, a.Skv - k_lo, a.D);
    load_key_pos<G::THREADS>(kpos_s, kp, k_lo, a);
    __syncthreads();
    p_and_ds<T, DP>(Qs, dOs, Ks, Vs, lse_s, delta_s, qpos_s, kpos_s, q_lo, k_lo, a, nullptr,
                    dSs);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys.
    warp_gemm<8>(dq, dSs + r0 * G::PLD, G::PLD, 1, Ks + d0, G::LD, 1, kTile);
  }

  T* dq_out = static_cast<T*>(a.dq);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q_lo + r0 + (lane >> 2) + 8 * (e >> 1);
      const int c = d0 + 8 * n + 2 * (lane & 3) + (e & 1);
      if (qi < a.S && c < a.D)
        store(dq_out + ((size_t)b * a.S + qi) * qrow + (size_t)h * a.D + c, dq[n][e] * a.scale);
    }
}

template <typename T, int DP>
int launch(const Args& a, cudaStream_t stream) {
  using G = Geo<T, DP>;
  const size_t rows = (size_t)a.B * a.S * a.H;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_kv = dkdv_smem_bytes<T, DP>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, DP><<<dim3((a.Skv + kTile - 1) / kTile, a.KV, a.B), G::THREADS, smem_kv,
                       stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_q = dq_smem_bytes<T, DP>();
  err = cudaFuncSetAttribute(dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<T, DP><<<dim3((a.S + kTile - 1) / kTile, a.H, a.B), G::THREADS, smem_q, stream>>>(a);
  return (int)cudaGetLastError();
}

// The forward's argument rules (S_kv != S only without a causal mask or
// window; positions in pairs); float32 takes D <= 128 (shared memory).
bool bad_shape(const Args& a, int dtype) {
  return a.D % 8 != 0 || a.D > 256 || (dtype == 0 && a.D > 128) || a.KV < 1 ||
         a.H % a.KV != 0 || a.B < 1 || a.S < 1 || a.Skv < 1 ||
         (a.Skv != a.S && (a.causal || a.window > 0)) ||
         ((a.qpos == nullptr) != (a.kpos == nullptr));
}

}  // namespace

// dtype: 0 = float32 (FMA), 1 = bfloat16 (mma.sync). q, o, dout, dq: (B, S,
// H, D); k, v, dk, dv: (B, S_kv, KV, D), all contiguous in dtype. lse: the
// forward's float32 (B, H, S); delta: float32 (B, H, S) scratch. qpos /
// kpos: int32 (B, S) / (B, S_kv) mask positions, or both null for arange.
// causal 0/1; window <= 0 means none. Three launches (Delta, dK/dV, dQ) on
// `stream`; returns the first failing launch's cudaError (0 on success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, const void* qpos,
                                   const void* kpos, int B, int S, int Skv, int H, int KV,
                                   int D, int causal, int window, float scale, void* stream) {
  const Args a{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
               dq, dk, dv, static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
               B, S, Skv, H, KV, D, causal, window, scale};
  if (bad_shape(a, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 64) return launch<float, 64>(a, st);
    return launch<float, 128>(a, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 64) return launch<bf16, 64>(a, st);
  if (D <= 128) return launch<bf16, 128>(a, st);
  return launch<bf16, 256>(a, st);
}
