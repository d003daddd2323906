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
// call is deterministic): a pre-pass `delta_kernel` computes Delta =
// rowsum(dO * O) in float32, (B, H, S); a dK/dV kernel owns a tile of keys
// and walks the query tiles that reach it, recomputing S = Q K^T,
// P = exp(S scale - LSE), dP = dO V^T, dS = P (dP - Delta) and summing
// dV += P^T dO and dK += dS^T Q over the group's H / KV query heads in a
// fixed order; a dQ kernel owns a tile of queries and walks the kv tiles,
// recomputing P and dS and summing dQ += dS K. S and dP are computed in
// both kernels: 14 D flops per (query, key) pair and head for the 10 D of
// the five products, 1.4x the bound's operations, the price of summing
// dQ without atomics. P is rounded to bf16 before dV (as the forward
// rounds P before P V) and dS before dQ and dK, where they are
// tensor-core operands. Masks are the forward's (arange causal, window,
// non-causal with S_kv != S, position-valued q_pos / kv_pos) through one
// element predicate, `attends`, and the (64 queries, 64 keys) tiles
// wholly masked are skipped by `tile_live`, the forward's tile skip.
// `ref.flash_attention_bwd_tiled_plain` walks the wgmma route's tiles in
// its order on the CPU.
//
// What bounds it on the H100: operations. At granite-3-2b's training shape
// (B = 8, S = 1024, H = 32, KV = 8, D = 64, causal) the five products over
// the 134.3 M causal (query, key) pairs and heads are 85.9 GFLOP, 0.0869 ms
// at 989 TFLOP/s bf16 (120.3 GFLOP as computed, with S and dP twice),
// against about 170 MB read and written once (Q, K, V, O, dO, LSE in;
// dQ, dK, dV out), 0.0507 ms at 3.35 TB/s.
//
// Routes, a rule by dtype and head dim (`route`), never a fallback: a CUDA
// tensor launches its route's kernels or the call raises.
//   - bf16, D <= 128 (granite, whisper at 64; qwen2-vl, mixtral at 128):
//     `dkdv_wgmma_kernel` and `dq_wgmma_kernel`, every product a
//     wgmma.mma_async m64n64k16 with float32 accumulators, on the tiles of
//     csrc/wgmma_tiles.cuh (the forward's), D zero-padded to 64 or 128.
//       dK/dV: one warpgroup (128 threads) per (64 keys, kv head, b), one
//       wgmma M. Its K and V sit in shared memory for the whole walk; Q,
//       dO, LSE and Delta of the next 64-query tile (and its positions)
//       come through a 2-stage cp.async ring while the current one is
//       multiplied, one barrier a step. Per step S^T = K Q^T and
//       dP^T = V dO^T are wgmma_ss (A = K or V, B = Q or dO, both K-major,
//       as the forward's S = Q K^T); P^T and dS^T, rows keys and columns
//       queries (LSE, Delta and query positions per column, read from the
//       ring's shared memory), are packed to bf16 in the accumulator
//       layout, which is wgmma's A register fragment; then dV += P^T dO and
//       dK += dS^T Q are wgmma_rs with the same dO and Q tiles read
//       MN-major (as the forward's O += P V). Blocks of the first keys,
//       which the most causal query tiles reach, start first.
//       dQ: one warpgroup per (64 queries, head, b), K/V tiles through the
//       same kind of ring; S = Q K^T and dP = dO V^T are wgmma_ss,
//       dQ += dS K is wgmma_rs with K read MN-major. Blocks late in S start
//       first.
//     One warpgroup a block, two blocks an SM (the registers allow no
//     more): the two run unsynchronised, so one's softmax overlaps the
//     other's products, which two warpgroups sharing a ring in one block
//     (the forward's geometry) do not, as they meet at every step's
//     barrier; that geometry measured slower on the H100 (PERF.md §6).
//     The softmax leaves out the element mask on tiles every pair of which
//     attends (`tile_full`: all but the diagonal and edge tiles of a
//     causal walk), saving its integer tests per element, and uses
//     ex2.approx.ftz. The register
//     budget at D = 128: dK + dV (128) + S^T + dP^T (64) + the packed P^T
//     and dS^T (32) a thread, with P^T and dS^T formed element by element
//     so that S^T and dP^T die as they go; ptxas -v shows each kernel's
//     registers and spills (chip_smoke.py fails on a spill).
//   - bf16, 128 < D <= 256 (gemma3, recurrentgemma at 256): the wide
//     route, `dkdv_wide_wgmma_kernel`, `dkdv_reduce_kernel` and
//     `dq_wide_wgmma_kernel`, D zero-padded to 256. dK + dV are 256
//     registers a thread at D = 256 in one warpgroup's wgmma layout, so
//     a block holds two warpgroups, each owning 128 of the 256 columns of
//     dK and dV (128 accumulator registers a thread).
//       dK/dV: one block per (64 keys, kv head, b, part). Per step
//       warpgroup 0 forms S^T = K Q^T and warpgroup 1 dP^T = V dO^T
//       (wgmma_ss, 16 k-steps each, so each is formed once); warpgroup 1
//       hands dP^T over through a float32 exchange tile in fragment
//       order; warpgroup 0 forms P^T and dS^T (the softmax of section 4)
//       and writes them, rounded to bf16, as two swizzled 64 x 64 tiles;
//       then both run dV += P^T dO and dK += dS^T Q on their halves of D
//       (wgmma_ss, A K-major from those tiles, B MN-major). K and V stay
//       resident; Q, dO, LSE, Delta and the query positions of the next
//       step come through a 2-stage cp.async ring. Shared memory: K, V
//       64 KB, the ring 128 KB + 1.5 KB, P^T and dS^T 16 KB, the
//       exchange 16 KB, 1 KB alignment: 231,936 of 232,448 bytes, one
//       block an SM (eight warps).
//       The grid fills the card: S_kv / 64 x KV x B blocks are too few at
//       MQA (recurrentgemma-9b: 64 on 132 SMs), so each group's query
//       heads are split into `parts` runs of consecutive heads, a
//       function of the shape and the SM count alone
//       (`ref.flash_bwd_head_parts`: the smallest divisor of the group
//       that gives at least two blocks an SM; recurrentgemma 8, gemma3-12b
//       1). With parts > 1 each block writes float32 partial dK and dV
//       and `dkdv_reduce_kernel` sums them in order of part and rounds
//       them: no atomics, two calls agree bit for bit.
//       dQ: one block per (64 queries, head, b); warpgroup 0 forms S and
//       the softmax, warpgroup 1 dP, handed over the same way; dS goes
//       to shared memory as bf16 and both warpgroups run dQ += dS K on
//       their halves (K read MN-major). K and V come through a 2-stage
//       ring: 222,208 bytes of shared memory.
//   - float32: the first design, `dkdv_kernel<float>` / `dq_kernel<float>`:
//     one block per 64-key or 64-query tile, register-blocked FMA
//     products in mma.sync's fragment layout, nothing rounded (the
//     reference's 2e-5 tolerance rules out TF32).
// `flash_attention_bwd_previous` runs the first design at every bf16 D
// (its bf16 instance: mma.sync.m16n8k16 on fragments read from shared
// memory, plain 16-byte loads; D > 128 took it until the wide route) and
// float32 as above, for side-by-side timing only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"  // bf16, cp.async, load_tile, smem_desc, wgmma_*, pack_bf16

namespace {

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
  int parts;    // the wide route's split of each group's query heads (1: none)
  float* part;  // (2, parts, B, S_kv, KV, D) float32 partial dK | dV when parts > 1
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
// 2. The first design's dK and dV (float32; bf16 at D > 128): one block per
//    (kv tile, kv head, b). Warp (wr, wc) owns kv rows 16 wr .. 16 wr + 15
//    and D columns 64 wc .. 64 wc + 63 of both.
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
// 3. The first design's dQ: one block per (query tile, head, b). Warp
//    (wr, wc) owns query rows 16 wr .. 16 wr + 15 and D columns 64 wc .. 64 wc + 63.
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

// ---------------------------------------------------------------------------
// 4. bf16, D <= 128: dK/dV and dQ on wgmma (see the header). The fragment
//    rule of csrc/flash_attention.cu: thread t of a warpgroup (warp w, lane
//    l) holds d[4n + 2i + j] of a 64 x 64 accumulator at row 16w + l/4 + 8i,
//    column 8n + 2(l%4) + j, and the same (row, pair of columns) layout is
//    wgmma's A register fragment of a 64 x 16 k-step: pack_bf16 of columns
//    16kk .. 16kk + 15 (n = 2kk, 2kk + 1) gives its four registers.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStatBytes = 64 * 4;  // one query tile's LSE, Delta or positions

// 4-byte async copy global -> shared; zero-fills when !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x with denormal results flushed to 0 (ex2.approx.ftz: one MUFU op; a P
// below 2^-126 adds nothing at bf16's precision).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Keep fragment registers that an in-flight wgmma reads live and unchanged
// until after its wait.
__device__ __forceinline__ void keep_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S (64 x 64) = A B^T over DP / 16 k-steps, A and B 64 x DP swizzled tiles
// (K-major both); the first k-step overwrites S.
template <int DP>
__device__ __forceinline__ void tile_qk(float (&s)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
    wgmma_ss(s, smem_desc(a_tile + off, 16, 1024), smem_desc(b_tile + off, 16, 1024), kk > 0);
  }
}

// acc (64 x DP) += A (64 x 64, four k-steps of register fragments) B, B a
// 64 x DP swizzled tile read MN-major (its rows are the reduction).
template <int NB>
__device__ __forceinline__ void tile_pv(float (&acc)[NB][32], const uint32_t (&a)[4][4],
                                        uint32_t b_tile) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[c], a[kk], smem_desc(b_tile + c * kBlockBytes + kk * 2048, 1024, 1024));
}

template <int NB>
__device__ __forceinline__ void zero_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
}

template <int NB>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][32]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
}

// S = A B^T and dP = C E^T of one step, both 64 x 64, in registers.
template <int DP>
__device__ __forceinline__ void step_products(float (&s)[32], float (&dp)[32], uint32_t a,
                                              uint32_t b, uint32_t c, uint32_t e) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  tile_qk<DP>(s, a, b);
  tile_qk<DP>(dp, c, e);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);
  fence_regs(dp);
}

// Whether every (query, key) pair of a 64 x 64 tile attends, so that the
// element mask can be left out there. Positions are non-decreasing only
// under a causal mask (the forward's precondition): without one, a tile
// with positions is never called full.
__device__ __forceinline__ bool tile_full(int q_lo, int k_lo, const int32_t* qp,
                                          const int32_t* kp, const Args& a) {
  if (q_lo + 63 >= a.S || k_lo + 63 >= a.Skv) return false;
  if (kp != nullptr)
    return a.causal && kp[k_lo + 63] <= qp[q_lo] &&
           (a.window <= 0 || kp[k_lo] > qp[q_lo + 63] - a.window);
  return (!a.causal || k_lo + 63 <= q_lo) && (a.window <= 0 || k_lo > q_lo + 63 - a.window);
}

// The softmax step of one 64 x 64 tile on the accumulator fragments:
// P = exp(S scale - LSE) in place where the element mask keeps the pair (0
// elsewhere) and dS = P (dP - Delta), element by element, each rounded to
// bf16 into A fragments (`pa`, `da`). kKeyRows: rows are keys and columns
// queries (the dK/dV kernel): LSE, Delta and query positions per column
// from the ring's shared memory (`col_*`), key positions per row
// (`row_pos`). Otherwise rows are queries: LSE (log2 units), Delta and
// positions per row (`row_*`), key positions per column from global
// memory (`kp`).
template <bool kKeyRows, bool kMask, bool kPos, typename DPT>
__device__ __forceinline__ void softmax_step(float (&s)[32], const DPT& dp,
                                             uint32_t (&pa)[4][4], uint32_t (&da)[4][4],
                                             const float* col_lse, const float* col_delta,
                                             const int* col_pos, const int32_t* kp,
                                             const float (&row_l2)[2], const float (&row_dl)[2],
                                             const int (&row_pos)[2], int row0, int col_lo,
                                             int col0, float scale_log2, const Args& a) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + col0;  // this thread's columns c, c + 1 (c even)
    float2 l, dl;
    int2 cpos;
    if constexpr (kKeyRows) {
      l = *reinterpret_cast<const float2*>(col_lse + c);
      dl = *reinterpret_cast<const float2*>(col_delta + c);
      if constexpr (kMask)
        cpos = kPos ? *reinterpret_cast<const int2*>(col_pos + c)
                    : make_int2(col_lo + c, col_lo + c + 1);
    } else if constexpr (kMask) {
      cpos = kPos ? make_int2(kp[min(col_lo + c, a.Skv - 1)], kp[min(col_lo + c + 1, a.Skv - 1)])
                  : make_int2(col_lo + c, col_lo + c + 1);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& x = s[4 * n + 2 * r + j];
        bool ok = true;
        if constexpr (kMask) {
          const int ri = row0 + 8 * r;
          const int ci = col_lo + c + j;
          const int cp = j ? cpos.y : cpos.x;
          ok = kKeyRows ? attends(ci, ri, cp, row_pos[r], a) : attends(ri, ci, row_pos[r], cp, a);
        }
        const float lse = kKeyRows ? (j ? l.y : l.x) * kLog2e : row_l2[r];
        x = ok ? ex2(x * scale_log2 - lse) : 0.f;
        d[j] = x * (dp[4 * n + 2 * r + j] - (kKeyRows ? (j ? dl.y : dl.x) : row_dl[r]));
      }
      pa[n >> 1][2 * (n & 1) + r] = pack_bf16(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]);
      da[n >> 1][2 * (n & 1) + r] = pack_bf16(d[0], d[1]);
    }
  }
}

// `softmax_step`, with the element mask left out on a full tile.
template <bool kKeyRows, bool kPos, typename DPT>
__device__ __forceinline__ void softmax_any(bool full, float (&s)[32], const DPT& dp,
                                            uint32_t (&pa)[4][4], uint32_t (&da)[4][4],
                                            const float* col_lse, const float* col_delta,
                                            const int* col_pos, const int32_t* kp,
                                            const float (&row_l2)[2], const float (&row_dl)[2],
                                            const int (&row_pos)[2], int row0, int col_lo,
                                            int col0, float scale_log2, const Args& a) {
  if (full)
    softmax_step<kKeyRows, false, kPos>(s, dp, pa, da, col_lse, col_delta, col_pos, kp, row_l2,
                                        row_dl, row_pos, row0, col_lo, col0, scale_log2, a);
  else
    softmax_step<kKeyRows, true, kPos>(s, dp, pa, da, col_lse, col_delta, col_pos, kp, row_l2,
                                       row_dl, row_pos, row0, col_lo, col0, scale_log2, a);
}

template <int DP>
constexpr size_t dkdv_wgmma_smem() {
  // K | V | two stages each of Q, of dO and of (LSE | Delta | positions)
  return 6 * (size_t)(DP / 64) * kBlockBytes + 2 * 3 * kStatBytes + 1024;
}

// dK and dV: one warpgroup per (64 keys, kv head, b), the M of every
// product; rows = keys, columns = the step's 64 queries.
template <int DP, bool kPos>
__global__ void __launch_bounds__(kWgThreads, 2) dkdv_wgmma_kernel(Args a, float scale_log2) {
  constexpr int NB = DP / 64;
  constexpr int kT = NB * kBlockBytes;  // one 64 x DP tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = base + kT;
  const uint32_t sQ = base + 2 * kT;   // two stages
  const uint32_t sdO = base + 4 * kT;  // two stages
  const uint32_t sStat = base + 6 * kT;
  const float* stat = reinterpret_cast<const float*>(smem_raw + (sStat - raw));

  // The first keys, which the most causal query tiles reach, start first.
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int k_lo = blockIdx.z * 64;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int group = a.H / a.KV;
  const size_t qrow = (size_t)a.H * a.D;
  const size_t krow = (size_t)a.KV * a.D;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int32_t* qp = kPos ? a.qpos + (size_t)b * a.S : nullptr;
  const int32_t* kp = kPos ? a.kpos + (size_t)b * a.Skv : nullptr;

  // The query tiles these keys need: `tile_live` keeps [t_lo, t_hi] (a
  // contiguous run for every mask the forward takes), walked for each head
  // of the group in turn.
  const int n_q = (a.S + 63) / 64;
  int t_lo = n_q, t_hi = -1;
  for (int t = 0; t < n_q; ++t)
    if (tile_live(64 * t, k_lo, qp, kp, a)) {
      t_lo = min(t_lo, t);
      t_hi = t;
    }
  const int n_t = max(t_hi - t_lo + 1, 0);
  const int n_steps = group * n_t;

  // Step i's Q and dO tiles, and its queries' LSE, Delta (and positions).
  auto load_step = [&](int i, int stage) {
    const int h = kh * group + i / n_t;
    const int q_lo = 64 * (t_lo + i % n_t);
    const size_t at = ((size_t)b * a.S + q_lo) * qrow + (size_t)h * a.D;
    load_tile<DP, kWgThreads>(sQ + stage * kT, q + at, qrow, a.S - q_lo, a.D, tid);
    load_tile<DP, kWgThreads>(sdO + stage * kT, dout + at, qrow, a.S - q_lo, a.D, tid);
    for (int x = tid; x < (kPos ? 192 : 128); x += kWgThreads) {
      const int which = x >> 6;
      const int j = x & 63;
      const bool ok = q_lo + j < a.S;
      const size_t row = ((size_t)b * a.H + h) * a.S + q_lo + j;
      const void* src = which == 0 ? static_cast<const void*>(a.lse + row)
                      : which == 1 ? static_cast<const void*>(a.delta + row)
                                   : static_cast<const void*>(qp + q_lo + j);
      cp_async4(sStat + (stage * 3 + which) * kStatBytes + 4 * j, ok ? src : a.lse, ok);
    }
  };

  // K and V once, with the first step's tiles.
  const size_t kv_at = ((size_t)b * a.Skv + k_lo) * krow + (size_t)kh * a.D;
  load_tile<DP, kWgThreads>(sK, static_cast<const bf16*>(a.k) + kv_at, krow, a.Skv - k_lo, a.D,
                            tid);
  load_tile<DP, kWgThreads>(sV, static_cast<const bf16*>(a.v) + kv_at, krow, a.Skv - k_lo, a.D,
                            tid);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk[NB][32], dv[NB][32];
  zero_acc(dk);
  zero_acc(dv);
  const int row0 = k_lo + warp * 16 + (lane >> 2);  // this thread's keys: row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  int kv[2];  // their mask positions
#pragma unroll
  for (int i = 0; i < 2; ++i) kv[i] = kPos ? kp[min(row0 + 8 * i, a.Skv - 1)] : row0 + 8 * i;
  const float none[2] = {0.f, 0.f};

  int st = 0;
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();  // step i's copies have landed (this thread's)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... every thread's, and step i - 1 is done with the other stage
    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);  // in flight during this step
    cp_async_commit();

    const int q_lo = 64 * (t_lo + i % n_t);
    if (tile_live(q_lo, k_lo, qp, kp, a)) {
      const uint32_t qst = sQ + st * kT;
      const uint32_t dost = sdO + st * kT;
      const float* lse_s = stat + st * 3 * 64;  // per column: LSE | Delta | positions
      // S^T = K Q^T and dP^T = V dO^T; then P^T and dS^T, rows keys.
      float s[32], dp[32];
      step_products<DP>(s, dp, sK, qst, sV, dost);
      uint32_t pa[4][4], da[4][4];
      softmax_any<true, kPos>(tile_full(q_lo, k_lo, qp, kp, a), s, dp, pa, da, lse_s,
                              lse_s + 64, reinterpret_cast<const int*>(lse_s + 128), kp, none,
                              none, kv, row0, q_lo, col0, scale_log2, a);
      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major.
      fence_acc(dv);
      fence_acc(dk);
      wgmma_fence();
      tile_pv<NB>(dv, pa, dost);
      tile_pv<NB>(dk, da, qst);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(dv);
      fence_acc(dk);
      keep_regs(pa);
      keep_regs(da);
    }
    st ^= 1;
  }
  cp_async_wait_all();  // nothing left in flight (a walk with no live tile)

  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = row0 + 8 * r;
    if (kj >= a.Skv) continue;
    const size_t at = ((size_t)b * a.Skv + kj) * krow + (size_t)kh * a.D;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 64 * c + 8 * n + col0;
        if (d < a.D) {
          const int e = 4 * n + 2 * r;
          *reinterpret_cast<__nv_bfloat162*>(dk_out + at + d) =
              __floats2bfloat162_rn(dk[c][e] * a.scale, dk[c][e + 1] * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(dv_out + at + d) =
              __floats2bfloat162_rn(dv[c][e], dv[c][e + 1]);
        }
      }
  }
}

template <int DP>
constexpr size_t dq_wgmma_smem() {
  return 6 * (size_t)(DP / 64) * kBlockBytes + 1024;  // Q | dO | two stages of K and of V
}

// dQ: one warpgroup per (64 queries, head, b), the M of every product;
// rows = queries, columns = the step's 64 keys.
template <int DP, bool kPos>
__global__ void __launch_bounds__(kWgThreads, 2) dq_wgmma_kernel(Args a, float scale_log2) {
  constexpr int NB = DP / 64;
  constexpr int kT = NB * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sdO = base + kT;
  const uint32_t sK = base + 2 * kT;  // two stages
  const uint32_t sV = base + 4 * kT;  // two stages

  // Blocks late in S, which the most causal kv tiles reach, start first.
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_lo = (gridDim.z - 1 - blockIdx.z) * 64;
  const int kh = h / (a.H / a.KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t qrow = (size_t)a.H * a.D;
  const size_t krow = (size_t)a.KV * a.D;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)b * a.Skv * krow + (size_t)kh * a.D;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)b * a.Skv * krow + (size_t)kh * a.D;
  const int32_t* qp = kPos ? a.qpos + (size_t)b * a.S : nullptr;
  const int32_t* kp = kPos ? a.kpos + (size_t)b * a.Skv : nullptr;

  // The kv tiles these queries need: `tile_live` keeps [kt_lo, kt_hi].
  const int n_kv = (a.Skv + 63) / 64;
  int kt_lo = n_kv, kt_hi = -1;
  for (int t = 0; t < n_kv; ++t)
    if (tile_live(q_lo, 64 * t, qp, kp, a)) {
      kt_lo = min(kt_lo, t);
      kt_hi = t;
    }
  const int n_steps = max(kt_hi - kt_lo + 1, 0);
  auto load_step = [&](int i, int stage) {
    const int k_lo = (kt_lo + i) * 64;
    load_tile<DP, kWgThreads>(sK + stage * kT, kb + (size_t)k_lo * krow, krow, a.Skv - k_lo,
                              a.D, tid);
    load_tile<DP, kWgThreads>(sV + stage * kT, vb + (size_t)k_lo * krow, krow, a.Skv - k_lo,
                              a.D, tid);
  };

  const size_t q_at = ((size_t)b * a.S + q_lo) * qrow + (size_t)h * a.D;
  load_tile<DP, kWgThreads>(sQ, static_cast<const bf16*>(a.q) + q_at, qrow, a.S - q_lo, a.D,
                            tid);
  load_tile<DP, kWgThreads>(sdO, static_cast<const bf16*>(a.dout) + q_at, qrow, a.S - q_lo,
                            a.D, tid);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dq[NB][32];
  zero_acc(dq);
  const int row0 = q_lo + warp * 16 + (lane >> 2);  // this thread's queries: row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  float l2[2], dl[2];  // their LSE (log2 units), Delta and mask positions
  int qv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const size_t at = ((size_t)b * a.H + h) * a.S + qi;
    l2[r] = qi < a.S ? a.lse[at] * kLog2e : 0.f;
    dl[r] = qi < a.S ? a.delta[at] : 0.f;
    qv[r] = kPos ? qp[min(qi, a.S - 1)] : qi;
  }

  int st = 0;
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);
    cp_async_commit();

    const int k_lo = (kt_lo + i) * 64;
    if (tile_live(q_lo, k_lo, qp, kp, a)) {
      const uint32_t kst = sK + st * kT;
      // S = Q K^T and dP = dO V^T; then P and dS, rows queries.
      float s[32], dp[32];
      step_products<DP>(s, dp, sQ, kst, sdO, sV + st * kT);
      uint32_t pa[4][4], da[4][4];  // pa: P as bf16, not multiplied here
      softmax_any<false, kPos>(tile_full(q_lo, k_lo, qp, kp, a), s, dp, pa, da, nullptr,
                               nullptr, nullptr, kp, l2, dl, qv, row0, k_lo, col0, scale_log2,
                               a);
      // dQ += dS K, K read MN-major.
      fence_acc(dq);
      wgmma_fence();
      tile_pv<NB>(dq, da, kst);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(dq);
      keep_regs(da);
    }
    st ^= 1;
  }
  cp_async_wait_all();  // nothing left in flight (a walk with no live tile)

  bf16* dq_out = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= a.S) continue;
    bf16* orow = dq_out + ((size_t)b * a.S + qi) * qrow + (size_t)h * a.D;
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 64 * c + 8 * n + col0;
        const int e = 4 * n + 2 * r;
        if (d < a.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(dq[c][e] * a.scale, dq[c][e + 1] * a.scale);
      }
  }
}

// ---------------------------------------------------------------------------
// 5. bf16, 128 < D <= 256: the wide route (see the header). Two warpgroups
//    a block, the same fragment rule as section 4 in each.
// ---------------------------------------------------------------------------

constexpr int kWideThreads = 256;         // two warpgroups
constexpr int kXBytes = 64 * 64 * 4;      // one 64 x 64 float32 tile, fragment order

// d += A (64 x 16, shared memory, K-major) B (16 x 64, shared memory,
// MN-major: its rows are the reduction).
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// The other warpgroup's accumulator, read from the exchange tile in
// fragment order: element e of thread t at e * 128 + t.
struct Strided {
  const float* p;
  __device__ __forceinline__ float operator[](int e) const { return p[e * 128]; }
};

// A 64 x 64 tile of packed bf16 A fragments (rows 16 warp + lane / 4 + 8 r,
// columns 16 kk + 8 (q / 2) + 2 (lane % 4)) into one swizzled block, where
// wgmma_ss reads it K-major.
__device__ __forceinline__ void store_frag_tile(uint8_t* tile, const uint32_t (&f)[4][4],
                                                int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = 2 * kk + (q >> 1);
      const int row = 16 * warp + (lane >> 2) + 8 * (q & 1);
      *reinterpret_cast<uint32_t*>(tile + row * 128 + ((n ^ (row & 7)) << 4) + 4 * (lane & 3)) =
          f[kk][q];
    }
}

// acc (64 x 64 per 64-column block c of this warpgroup's half of D) +=
// A B: A one 64 x 64 swizzled block (K-major), B a 64 x DP tile read
// MN-major.
template <int DP>
__device__ __forceinline__ void tile_ab_half(float (&acc)[2][32], uint32_t a_tile,
                                             uint32_t b_tile, int wg) {
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tb(acc[c], smem_desc(a_tile + kk * 32, 16, 1024),
                  smem_desc(b_tile + (2 * wg + c) * kBlockBytes + kk * 2048, 1024, 1024));
}

template <int DP>
constexpr size_t dkdv_wide_smem() {
  // K | V | two stages of Q and of dO | P^T | dS^T | the dP^T exchange |
  // two stages of (LSE | Delta | positions) | alignment
  return 6 * (size_t)(DP / 64) * kBlockBytes + 2 * kBlockBytes + kXBytes + 2 * 3 * kStatBytes +
         1024;
}

// dK and dV of 64 keys of one kv head and batch row, summed over one part
// of the group's query heads: blockIdx.x = kv head * parts + part.
template <int DP, bool kPos>
__global__ void __launch_bounds__(kWideThreads, 1) dkdv_wide_wgmma_kernel(Args a,
                                                                          float scale_log2) {
  constexpr int kT = (DP / 64) * kBlockBytes;  // one 64 x DP tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);  // generic address of `base`
  const uint32_t sK = base;
  const uint32_t sV = base + kT;
  const uint32_t sQ = base + 2 * kT;   // two stages
  const uint32_t sdO = base + 4 * kT;  // two stages
  const uint32_t sP = base + 6 * kT;
  const uint32_t sdS = sP + kBlockBytes;
  float* xch = reinterpret_cast<float*>(gen + 6 * kT + 2 * kBlockBytes);
  const uint32_t sStat = sdS + kBlockBytes + kXBytes;
  const float* stat = reinterpret_cast<const float*>(gen + (sStat - base));

  const int kh = blockIdx.x / a.parts;
  const int part = blockIdx.x - kh * a.parts;
  const int b = blockIdx.y;
  const int k_lo = blockIdx.z * 64;  // the first keys start first
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // 0: S^T and the softmax; 1: dP^T
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = tid & 31;
  const int group = a.H / a.KV;
  const int per = group / a.parts;  // query heads of this part
  const int h0 = kh * group + part * per;
  const size_t qrow = (size_t)a.H * a.D;
  const size_t krow = (size_t)a.KV * a.D;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int32_t* qp = kPos ? a.qpos + (size_t)b * a.S : nullptr;
  const int32_t* kp = kPos ? a.kpos + (size_t)b * a.Skv : nullptr;

  const int n_q = (a.S + 63) / 64;
  int t_lo = n_q, t_hi = -1;
  for (int x = 0; x < n_q; ++x)
    if (tile_live(64 * x, k_lo, qp, kp, a)) {
      t_lo = min(t_lo, x);
      t_hi = x;
    }
  const int n_t = max(t_hi - t_lo + 1, 0);
  const int n_steps = per * n_t;

  auto load_step = [&](int i, int stage) {
    const int h = h0 + i / n_t;
    const int q_lo = 64 * (t_lo + i % n_t);
    const size_t at = ((size_t)b * a.S + q_lo) * qrow + (size_t)h * a.D;
    load_tile<DP, kWideThreads>(sQ + stage * kT, q + at, qrow, a.S - q_lo, a.D, tid);
    load_tile<DP, kWideThreads>(sdO + stage * kT, dout + at, qrow, a.S - q_lo, a.D, tid);
    for (int x = tid; x < (kPos ? 192 : 128); x += kWideThreads) {
      const int which = x >> 6;
      const int j = x & 63;
      const bool ok = q_lo + j < a.S;
      const size_t row = ((size_t)b * a.H + h) * a.S + q_lo + j;
      const void* src = which == 0 ? static_cast<const void*>(a.lse + row)
                      : which == 1 ? static_cast<const void*>(a.delta + row)
                                   : static_cast<const void*>(qp + q_lo + j);
      cp_async4(sStat + (stage * 3 + which) * kStatBytes + 4 * j, ok ? src : a.lse, ok);
    }
  };

  const size_t kv_at = ((size_t)b * a.Skv + k_lo) * krow + (size_t)kh * a.D;
  load_tile<DP, kWideThreads>(sK, static_cast<const bf16*>(a.k) + kv_at, krow, a.Skv - k_lo,
                              a.D, tid);
  load_tile<DP, kWideThreads>(sV, static_cast<const bf16*>(a.v) + kv_at, krow, a.Skv - k_lo,
                              a.D, tid);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk[2][32], dv[2][32];  // this warpgroup's half of D
  zero_acc(dk);
  zero_acc(dv);
  const int row0 = k_lo + warp * 16 + (lane >> 2);  // this thread's keys: row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  int kv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) kv[i] = kPos ? kp[min(row0 + 8 * i, a.Skv - 1)] : row0 + 8 * i;
  const float none[2] = {0.f, 0.f};

  int st = 0;
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // step i's stage landed; step i - 1 is done with everything
    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);
    cp_async_commit();

    const int q_lo = 64 * (t_lo + i % n_t);
    if (tile_live(q_lo, k_lo, qp, kp, a)) {
      const uint32_t qst = sQ + st * kT;
      const uint32_t dost = sdO + st * kT;
      // S^T = K Q^T (warpgroup 0) and dP^T = V dO^T (warpgroup 1), once each.
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      fence_regs(acc);
      wgmma_fence();
      if (wg == 0)
        tile_qk<DP>(acc, sK, qst);
      else
        tile_qk<DP>(acc, sV, dost);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      if (wg == 1)
#pragma unroll
        for (int e = 0; e < 32; ++e) xch[e * 128 + t] = acc[e];
      __syncthreads();  // dP^T is in the exchange tile
      if (wg == 0) {
        // P^T and dS^T, rows keys, each rounded to bf16 into shared memory.
        const float* lse_s = stat + st * 3 * 64;
        uint32_t pa[4][4], da[4][4];
        softmax_any<true, kPos>(tile_full(q_lo, k_lo, qp, kp, a), acc, Strided{xch + t}, pa, da,
                                lse_s, lse_s + 64, reinterpret_cast<const int*>(lse_s + 128), kp,
                                none, none, kv, row0, q_lo, col0, scale_log2, a);
        store_frag_tile(gen + (sP - base), pa, warp, lane);
        store_frag_tile(gen + (sdS - base), da, warp, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      __syncthreads();  // P^T and dS^T are in shared memory
      // dV += P^T dO and dK += dS^T Q on this warpgroup's 128 columns.
      fence_acc(dv);
      fence_acc(dk);
      wgmma_fence();
      tile_ab_half<DP>(dv, sP, dost, wg);
      tile_ab_half<DP>(dk, sdS, qst, wg);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(dv);
      fence_acc(dk);
    }
    st ^= 1;
  }
  cp_async_wait_all();

  const size_t n_out = (size_t)a.B * a.Skv * krow;  // one part's dK (or dV)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = row0 + 8 * r;
    if (kj >= a.Skv) continue;
    const size_t at = ((size_t)b * a.Skv + kj) * krow + (size_t)kh * a.D;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 64 * (2 * wg + c) + 8 * n + col0;
        if (d >= a.D) continue;
        const int e = 4 * n + 2 * r;
        if (a.parts == 1) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dk) + at + d) =
              __floats2bfloat162_rn(dk[c][e] * a.scale, dk[c][e + 1] * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(a.dv) + at + d) =
              __floats2bfloat162_rn(dv[c][e], dv[c][e + 1]);
        } else {
          float* pk = a.part + (size_t)part * n_out + at + d;
          *reinterpret_cast<float2*>(pk) = make_float2(dk[c][e], dk[c][e + 1]);
          *reinterpret_cast<float2*>(pk + (size_t)a.parts * n_out) =
              make_float2(dv[c][e], dv[c][e + 1]);
        }
      }
  }
}

// dK = scale * (the parts' partial dK summed in order of part), dV the same
// unscaled, each rounded to bf16 once.
__global__ void dkdv_reduce_kernel(Args a) {
  const size_t n = (size_t)a.B * a.Skv * a.KV * a.D;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float sk = 0.f, sv = 0.f;
  for (int p = 0; p < a.parts; ++p) {
    sk += a.part[(size_t)p * n + e];
    sv += a.part[(size_t)(a.parts + p) * n + e];
  }
  static_cast<bf16*>(a.dk)[e] = __float2bfloat16(sk * a.scale);
  static_cast<bf16*>(a.dv)[e] = __float2bfloat16(sv);
}

template <int DP>
constexpr size_t dq_wide_smem() {
  // Q | dO | two stages of K and of V | dS | the dP exchange | alignment
  return 6 * (size_t)(DP / 64) * kBlockBytes + kBlockBytes + kXBytes + 1024;
}

// dQ of 64 queries of one head and batch row; rows = queries.
template <int DP, bool kPos>
__global__ void __launch_bounds__(kWideThreads, 1) dq_wide_wgmma_kernel(Args a,
                                                                        float scale_log2) {
  constexpr int kT = (DP / 64) * kBlockBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t sdO = base + kT;
  const uint32_t sK = base + 2 * kT;  // two stages
  const uint32_t sV = base + 4 * kT;  // two stages
  const uint32_t sdS = base + 6 * kT;
  float* xch = reinterpret_cast<float*>(gen + 6 * kT + kBlockBytes);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q_lo = (gridDim.z - 1 - blockIdx.z) * 64;  // late queries first
  const int kh = h / (a.H / a.KV);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;  // 0: S and the softmax; 1: dP
  const int t = tid & 127;
  const int warp = t >> 5;
  const int lane = tid & 31;
  const size_t qrow = (size_t)a.H * a.D;
  const size_t krow = (size_t)a.KV * a.D;
  const bf16* kb = static_cast<const bf16*>(a.k) + (size_t)b * a.Skv * krow + (size_t)kh * a.D;
  const bf16* vb = static_cast<const bf16*>(a.v) + (size_t)b * a.Skv * krow + (size_t)kh * a.D;
  const int32_t* qp = kPos ? a.qpos + (size_t)b * a.S : nullptr;
  const int32_t* kp = kPos ? a.kpos + (size_t)b * a.Skv : nullptr;

  const int n_kv = (a.Skv + 63) / 64;
  int kt_lo = n_kv, kt_hi = -1;
  for (int x = 0; x < n_kv; ++x)
    if (tile_live(q_lo, 64 * x, qp, kp, a)) {
      kt_lo = min(kt_lo, x);
      kt_hi = x;
    }
  const int n_steps = max(kt_hi - kt_lo + 1, 0);
  auto load_step = [&](int i, int stage) {
    const int k_lo = (kt_lo + i) * 64;
    load_tile<DP, kWideThreads>(sK + stage * kT, kb + (size_t)k_lo * krow, krow, a.Skv - k_lo,
                                a.D, tid);
    load_tile<DP, kWideThreads>(sV + stage * kT, vb + (size_t)k_lo * krow, krow, a.Skv - k_lo,
                                a.D, tid);
  };

  const size_t q_at = ((size_t)b * a.S + q_lo) * qrow + (size_t)h * a.D;
  load_tile<DP, kWideThreads>(sQ, static_cast<const bf16*>(a.q) + q_at, qrow, a.S - q_lo, a.D,
                              tid);
  load_tile<DP, kWideThreads>(sdO, static_cast<const bf16*>(a.dout) + q_at, qrow, a.S - q_lo,
                              a.D, tid);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dq[2][32];
  zero_acc(dq);
  const int row0 = q_lo + warp * 16 + (lane >> 2);  // this thread's queries: row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  float l2[2], dl[2];
  int qv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const size_t at = ((size_t)b * a.H + h) * a.S + qi;
    l2[r] = qi < a.S ? a.lse[at] * kLog2e : 0.f;
    dl[r] = qi < a.S ? a.delta[at] : 0.f;
    qv[r] = kPos ? qp[min(qi, a.S - 1)] : qi;
  }

  int st = 0;
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait_all();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + 1 < n_steps) load_step(i + 1, st ^ 1);
    cp_async_commit();

    const int k_lo = (kt_lo + i) * 64;
    if (tile_live(q_lo, k_lo, qp, kp, a)) {
      const uint32_t kst = sK + st * kT;
      // S = Q K^T (warpgroup 0) and dP = dO V^T (warpgroup 1).
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      fence_regs(acc);
      wgmma_fence();
      if (wg == 0)
        tile_qk<DP>(acc, sQ, kst);
      else
        tile_qk<DP>(acc, sdO, sV + st * kT);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(acc);
      if (wg == 1)
#pragma unroll
        for (int e = 0; e < 32; ++e) xch[e * 128 + t] = acc[e];
      __syncthreads();
      if (wg == 0) {
        uint32_t pa[4][4], da[4][4];  // pa: P as bf16, not multiplied here
        softmax_any<false, kPos>(tile_full(q_lo, k_lo, qp, kp, a), acc, Strided{xch + t}, pa,
                                 da, nullptr, nullptr, nullptr, kp, l2, dl, qv, row0, k_lo, col0,
                                 scale_log2, a);
        store_frag_tile(gen + (sdS - base), da, warp, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      __syncthreads();
      // dQ += dS K on this warpgroup's 128 columns, K read MN-major.
      fence_acc(dq);
      wgmma_fence();
      tile_ab_half<DP>(dq, sdS, kst, wg);
      wgmma_commit();
      wgmma_wait0();
      fence_acc(dq);
    }
    st ^= 1;
  }
  cp_async_wait_all();

  bf16* dq_out = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= a.S) continue;
    bf16* orow = dq_out + ((size_t)b * a.S + qi) * qrow + (size_t)h * a.D;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = 64 * (2 * wg + c) + 8 * n + col0;
        const int e = 4 * n + 2 * r;
        if (d < a.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(dq[c][e] * a.scale, dq[c][e + 1] * a.scale);
      }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T>
int launch_delta(const Args& a, cudaStream_t stream) {
  const size_t rows = (size_t)a.B * a.S * a.H;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The first design: mma.sync (bf16) or FMA (float32), 64-row blocks.
template <typename T, int DP>
int launch_first(const Args& a, cudaStream_t stream) {
  using G = Geo<T, DP>;
  cudaError_t err = (cudaError_t)launch_delta<T>(a, stream);
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

// The wgmma route: bf16, D <= 128.
template <int DP, bool kPos>
int launch_wgmma(const Args& a, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)launch_delta<bf16>(a, stream);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = a.scale * kLog2e;
  constexpr size_t smem_kv = dkdv_wgmma_smem<DP>();
  err = cudaFuncSetAttribute(dkdv_wgmma_kernel<DP, kPos>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_wgmma_kernel<DP, kPos><<<dim3(a.KV, a.B, (a.Skv + 63) / 64), kWgThreads, smem_kv,
                                stream>>>(a, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem_q = dq_wgmma_smem<DP>();
  err = cudaFuncSetAttribute(dq_wgmma_kernel<DP, kPos>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_wgmma_kernel<DP, kPos><<<dim3(a.H, a.B, (a.S + 63) / 64), kWgThreads, smem_q, stream>>>(
      a, scale_log2);
  return (int)cudaGetLastError();
}

// The wide route: bf16, 128 < D <= 256.
template <int DP, bool kPos>
int launch_wide(const Args& a, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)launch_delta<bf16>(a, stream);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = a.scale * kLog2e;
  constexpr size_t smem_kv = dkdv_wide_smem<DP>();
  err = cudaFuncSetAttribute(dkdv_wide_wgmma_kernel<DP, kPos>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv_wide_wgmma_kernel<DP, kPos><<<dim3(a.KV * a.parts, a.B, (a.Skv + 63) / 64), kWideThreads,
                                     smem_kv, stream>>>(a, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.parts > 1) {
    const size_t n = (size_t)a.B * a.Skv * a.KV * a.D;
    dkdv_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  constexpr size_t smem_q = dq_wide_smem<DP>();
  err = cudaFuncSetAttribute(dq_wide_wgmma_kernel<DP, kPos>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  dq_wide_wgmma_kernel<DP, kPos><<<dim3(a.H, a.B, (a.S + 63) / 64), kWideThreads, smem_q,
                                   stream>>>(a, scale_log2);
  return (int)cudaGetLastError();
}

// The forward's argument rules (S_kv != S only without a causal mask or
// window; positions in pairs).
bool bad_shape(const Args& a) {
  return a.KV < 1 || a.H % a.KV != 0 || a.B < 1 || a.S < 1 || a.Skv < 1 ||
         (a.Skv != a.S && (a.causal || a.window > 0)) ||
         ((a.qpos == nullptr) != (a.kpos == nullptr));
}

// The route of (dtype, D): 0 = float32 FMA (first design; D <= 128, its
// shared memory), 2 = bf16 wgmma (D <= 128), 3 = bf16 wide wgmma (D in
// (128, 256]); -1 = refused. (1, the first design's bf16 mma.sync, is no
// route any more: only `flash_attention_bwd_previous` runs it.)
int route(int dtype, int D) {
  if (D % 8 != 0 || D < 8) return -1;
  if (dtype == 0) return D <= 128 ? 0 : -1;
  if (dtype != 1 || D > 256) return -1;
  return D <= 128 ? 2 : 3;
}

int run(const Args& a, int dtype, bool previous, cudaStream_t st) {
  const int r = route(dtype, a.D);
  if (bad_shape(a) || r < 0) return (int)cudaErrorInvalidValue;
  if (r == 0) return a.D <= 64 ? launch_first<float, 64>(a, st) : launch_first<float, 128>(a, st);
  const bool pos = a.qpos != nullptr;
  if (r == 2 && !previous) {
    if (a.D <= 64) return pos ? launch_wgmma<64, true>(a, st) : launch_wgmma<64, false>(a, st);
    return pos ? launch_wgmma<128, true>(a, st) : launch_wgmma<128, false>(a, st);
  }
  if (r == 3 && !previous) {
    const int group = a.H / a.KV;
    if (a.parts < 1 || group % a.parts != 0 || (a.parts > 1 && a.part == nullptr))
      return (int)cudaErrorInvalidValue;
    return pos ? launch_wide<256, true>(a, st) : launch_wide<256, false>(a, st);
  }
  if (a.D <= 64) return launch_first<bf16, 64>(a, st);
  if (a.D <= 128) return launch_first<bf16, 128>(a, st);
  return launch_first<bf16, 256>(a, st);
}

Args make_args(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* delta, void* dq, void* dk, void* dv, const void* qpos,
               const void* kpos, int B, int S, int Skv, int H, int KV, int D, int causal,
               int window, float scale, int parts, void* part) {
  return Args{q, k, v, o, dout, static_cast<const float*>(lse), static_cast<float*>(delta),
              dq, dk, dv, static_cast<const int32_t*>(qpos), static_cast<const int32_t*>(kpos),
              B, S, Skv, H, KV, D, causal, window, scale, parts, static_cast<float*>(part)};
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; the route by (dtype, D) is `route`'s.
// q, o, dout, dq: (B, S, H, D); k, v, dk, dv: (B, S_kv, KV, D), all
// contiguous in dtype. lse: the forward's float32 (B, H, S); delta:
// float32 (B, H, S) scratch. qpos / kpos: int32 (B, S) / (B, S_kv) mask
// positions, or both null for arange. causal 0/1; window <= 0 means none.
// parts: on the wide route, how many parts each group of H / KV query
// heads is split into for dK/dV (a divisor of the group; 1 elsewhere);
// part: float32 scratch of 2 parts B S_kv KV D when parts > 1, else null.
// Three launches (Delta, dK/dV, dQ) on `stream`, four with parts > 1 (the
// partials' sum after dK/dV); returns the first failing launch's
// cudaError (0 on success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv, const void* qpos,
                                   const void* kpos, int B, int S, int Skv, int H, int KV,
                                   int D, int causal, int window, float scale, int parts,
                                   void* part, void* stream) {
  return run(make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, qpos, kpos, B, S, Skv, H, KV,
                       D, causal, window, scale, parts, part),
             dtype, false, static_cast<cudaStream_t>(stream));
}

// The first design (mma.sync for bf16 at every D, FMA for float32), kept
// for side-by-side timing only. Same arguments as flash_attention_bwd
// (parts and part are not read).
extern "C" int flash_attention_bwd_previous(int dtype, const void* q, const void* k,
                                            const void* v, const void* o, const void* dout,
                                            const void* lse, void* delta, void* dq, void* dk,
                                            void* dv, const void* qpos, const void* kpos, int B,
                                            int S, int Skv, int H, int KV, int D, int causal,
                                            int window, float scale, int parts, void* part,
                                            void* stream) {
  return run(make_args(q, k, v, o, dout, lse, delta, dq, dk, dv, qpos, kpos, B, S, Skv, H, KV,
                       D, causal, window, scale, 1, nullptr),
             dtype, true, static_cast<cudaStream_t>(stream));
}

// The route flash_attention_bwd takes for (dtype, D): 0 = float32 FMA,
// 2 = bf16 wgmma, 3 = bf16 wide wgmma, -1 = refused.
extern "C" int flash_attention_bwd_route(int dtype, int D) { return route(dtype, D); }
