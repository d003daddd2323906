// Single-token decode attention (flash-decoding, split over S) for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention.py (pallas_call at line 145, body
// `_kernel` at line 40). Same function: one new token per row attends to
// its KV cache through a position-driven mask
//     kv_pos <= cursor  &  kv_valid  &  active  [& kv_pos > cursor - window]
// (ring caches give -1 sentinels for slots never written), an online
// softmax in float32, tiles with no live slot skipped, and a row with no
// live slot writing exact 0. `causal = 0` drops the kv_pos <= cursor term
// (cross-attention against an encoder's K/V, whisper's decoder: there the
// head group is 1, H = KV = 20, D = 64, so the bf16 kernel's 16-row tile
// carries one live row; it is bound by bytes all the same).
//
// What bounds it on the H100: bytes. It reads the live part of the K and V
// cache once and does 4 G D flops per live slot and kv head: at granite's
// G = 4, D = 64 in bf16 about 8 flops per byte, at recurrentgemma's G = 16,
// D = 256 about 32, far below the tensor cores' ridge of ~295. The
// main-path bounds: 33.5 MB, 0.0101 ms at 3.35 TB/s, for B = 8 rows of a
// 2048-slot cache at KV = 8, D = 64; 13.5 MB of live slots, about
// 0.004 ms, for recurrentgemma's full 2048-slot rings (KV = 1, D = 256).
// So the design has to stream K/V once, with enough of it in flight:
//
// Two launches per call (the wrapper counts the call once):
//   1. partials, grid (kv head x head chunk, row b, split): split z walks
//      the fixed slot range [z * tps * 64, (z + 1) * tps * 64) in 64-slot
//      tiles and writes its unnormalised (m, l, acc) for its query heads
//      to float32 scratch that the wrapper allocates. The split count and
//      tiles per split (tps) come from the wrapper's planner, a pure
//      function of (B, KV, S, SM count): about 4 blocks per SM, at least
//      two tiles a split (granite's shape: 8 splits, 512 blocks;
//      recurrentgemma's: 16). Same shape, same card, same plan, so a step
//      is deterministic.
//   2. combine, one block per (b, h): the splits' partials in split order,
//      no atomics. A split with no live slot has m = -1e30, l = 0 and
//      weighs 0 (or 1 with l = 0 if no split was live); a row with no live
//      slot, or with active[b] == 0, writes exact 0.
//
// Inside a split (bf16, `decode_mma_kernel`, 4 warps): each tile's live
// bitmap is computed (one ballot per 32 slots) before any byte of it is
// read; a tile with no live slot is skipped; a live tile's K and V rows
// are copied with cp.async, 16 bytes a thread, dead slots zero-filled and
// not read, into a 2-stage ring, so the next live tile is in flight while
// this one is multiplied. QK^T and PV run on the tensor cores as
// mma.sync.m16n8k16 bf16 (fragments by ldmatrix; shared rows padded by 16
// bytes so ldmatrix is conflict-free), with the head group padded to 16
// rows: granite's G = 4 wastes rows of a tile that costs nothing here, as
// the kernel is bound by bytes; recurrentgemma's G = 16 fills it. Each
// warp owns 16 slots of every tile and keeps its own (m, l, acc) in
// registers; the four warps are merged in shared memory, in warp order,
// when the split ends. P is rounded to bf16 before PV, as the Pallas
// kernel does (`p.astype(v.dtype)`); l sums the unrounded p, as there.
// A head group of more than 16 is taken 16 heads per block, each block
// re-reading the head's K/V (from L2).
//
// float32 (`decode_fma_kernel<float>`): a full-float32 product has no
// tensor-core instruction and TF32 would break the reference's 2e-5
// tolerance, so float32 keeps the first port's FMA design (one block per
// (row, kv head, head chunk), (m, l, acc) in shared memory, dead slots
// not loaded), now walking one split's slot range and writing partials
// for the same combine. This is a dtype rule, not a fallback. Its bf16
// instance is exported only as `decode_attention_fma_fwd`, the previous
// bf16 design (with one split it is that design's grid), for side-by-side
// timing (`previous_design` in the wrapper module); `decode_attention` and
// `ops` never call it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr float kNegInf = -1e30f;
constexpr int kBlockK = 64;    // slots per tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxSplit = 256;

// Partials of split z for query head h of row b sit at index
// (z * B + b) * H + h of part_m / part_l, and at that index times D in
// part_acc (float32; m and l per head, acc unnormalised).

__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* o) {
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
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

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

// ---------------------------------------------------------------------------
// float32 route (and the previous bf16 design): FMA
// ---------------------------------------------------------------------------

size_t fma_smem_bytes(int G, int D) {
  const size_t floats = (size_t)G * D            // q
                        + (size_t)kBlockK * (D + 1)  // K tile, padded rows
                        + (size_t)kBlockK * D        // V tile
                        + (size_t)G * kBlockK        // scores / probabilities
                        + (size_t)G * D              // accumulator
                        + 3 * (size_t)G;             // m, l, alpha
  return floats * sizeof(float) + kBlockK * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_fma_kernel(
    const T* __restrict__ q,              // (B, 1, H, D)
    const T* __restrict__ k,              // (B, S, KV, D)
    const T* __restrict__ v,              // (B, S, KV, D)
    const int32_t* __restrict__ cursor,   // (B,)
    const int32_t* __restrict__ kv_pos,   // (B, S)
    const uint8_t* __restrict__ kv_valid, // (B, S)
    const uint8_t* __restrict__ active,   // (B,) or null = every row live
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
    int B, int S, int KV, int G_all, int G_chunk, int D, int causal, int window,
    float scale, int tiles_per_split) {
  // blockIdx.x = kv head * chunks + chunk: the G_all query heads of a kv
  // head are taken G_chunk at a time when they do not fit shared memory
  // together (each chunk then re-reads that head's K/V).
  const int chunks = (G_all + G_chunk - 1) / G_chunk;
  const int kh = blockIdx.x / chunks;
  const int g_lo = (blockIdx.x - kh * chunks) * G_chunk;
  const int G = min(G_chunk, G_all - g_lo);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  if (active != nullptr && active[b] == 0) return;  // the combine writes the zeros
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

  const int s_begin = split * tiles_per_split * kBlockK;
  const int s_end = min(S, s_begin + tiles_per_split * kBlockK);
  for (int t0 = s_begin; t0 < s_end; t0 += kBlockK) {
    int any = 0;
    for (int j = tid; j < kBlockK; j += kThreads) {
      const int s = t0 + j;
      int ok = 0;
      if (s < S) {
        const int p = pos_b[s];
        ok = (!causal || p <= cur) && (val_b[s] != 0);
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

  const size_t p0 = ((size_t)split * B + b) * H + (size_t)kh * G_all + g_lo;
  for (int g = tid; g < G; g += kThreads) {
    part_m[p0 + g] = m_s[g];
    part_l[p0 + g] = l_s[g];
  }
  for (int e = tid; e < G * D; e += kThreads) part_acc[p0 * D + e] = acc[e];
}

// ---------------------------------------------------------------------------
// bf16 route: mma.sync on the tensor cores, cp.async double buffering
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !pred (src-size 0:
// nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c (16 x 8, f32) += a (16 x 16) b (16 x 8), bf16 inputs.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

size_t mma_smem_bytes(int DP) {
  // Q (16 rows), K and V (2 stages x 64 rows each) at DP + 8 bf16 a row,
  // and two 64-bit live bitmaps.
  return (size_t)(16 + 4 * kBlockK) * (DP + 8) * sizeof(bf16) + 4 * sizeof(uint32_t);
}

// Fragments (lane l of a warp): an m16n8 accumulator c[e] is row
// l/4 + 8 (e / 2), column 2 (l % 4) + e % 2; a 16 x 16 A fragment holds
// the same rows at columns 2 (l % 4) + {0, 1} and + 8.
template <int DP>  // D rounded up to 16, 32, 64, 128 or 256
__global__ void __launch_bounds__(kThreads) decode_mma_kernel(
    const bf16* __restrict__ q,           // (B, 1, H, D)
    const bf16* __restrict__ k,           // (B, S, KV, D)
    const bf16* __restrict__ v,           // (B, S, KV, D)
    const int32_t* __restrict__ cursor,   // (B,)
    const int32_t* __restrict__ kv_pos,   // (B, S)
    const uint8_t* __restrict__ kv_valid, // (B, S)
    const uint8_t* __restrict__ active,   // (B,) or null = every row live
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
    int B, int S, int KV, int G_all, int D, int causal, int window, float scale,
    int tiles_per_split) {
  constexpr int RS = DP + 8;  // shared row stride in elements
  constexpr int ND = DP / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // 16 x RS
  bf16* sk = sq + 16 * RS;                   // 2 stages x 64 x RS
  bf16* sv = sk + 2 * kBlockK * RS;          // 2 stages x 64 x RS
  uint32_t* live = reinterpret_cast<uint32_t*>(sv + 2 * kBlockK * RS);  // [stage][2]

  const int chunks = (G_all + 15) / 16;
  const int kh = blockIdx.x / chunks;
  const int g_lo = (blockIdx.x - kh * chunks) * 16;
  const int G = min(16, G_all - g_lo);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  if (active != nullptr && active[b] == 0) return;  // the combine writes the zeros
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = KV * G_all;

  // Q: G rows of D, zero-padded to 16 x DP.
  const bf16* qb = q + ((size_t)b * H + (size_t)kh * G_all + g_lo) * D;
  for (int c = tid; c < 16 * (DP / 8); c += kThreads) {
    const int r = c / (DP / 8);
    const int ch = c - r * (DP / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < G && ch * 8 < D) x = *reinterpret_cast<const uint4*>(qb + (size_t)r * D + ch * 8);
    *reinterpret_cast<uint4*>(sq + r * RS + ch * 8) = x;
  }
  // Columns D..DP of every K/V stage row stay zero: copies write only < D.
  if (D < DP) {
    const int per = (DP - D) / 8;
    for (int c = tid; c < 4 * kBlockK * per; c += kThreads) {
      const int r = c / per;  // over the 256 rows of sk then sv
      *reinterpret_cast<uint4*>(sk + r * RS + D + (c - r * per) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  const int cur = cursor[b];
  const int32_t* pos_b = kv_pos + (size_t)b * S;
  const uint8_t* val_b = kv_valid + (size_t)b * S;
  const size_t row = (size_t)KV * D;  // elements between consecutive slots
  const bf16* kb = k + (size_t)b * S * row + (size_t)kh * D;
  const bf16* vb = v + (size_t)b * S * row + (size_t)kh * D;
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);

  // The first tile at or after t with a live slot (t_end if none), its
  // bitmap left in live[stage]. Uniform over the block.
  auto next_live = [&](int t, int stage) -> int {
    for (; t < t_end; ++t) {
      int ok = 0;
      if (tid < kBlockK) {
        const int s = t * kBlockK + tid;
        if (s < S) {
          const int p = pos_b[s];
          ok = (!causal || p <= cur) && val_b[s] != 0 && (window <= 0 || p > cur - window);
        }
        const unsigned bits = __ballot_sync(0xffffffffu, ok);
        if (lane == 0) live[2 * stage + warp] = bits;
      }
      if (__syncthreads_or(ok)) return t;
    }
    return t_end;
  };
  // K and V rows of tile t's live slots into stage `stage`; dead slots are
  // zero-filled without being read.
  auto issue = [&](int t, int stage) {
    const uint32_t bits0 = live[2 * stage];
    const uint32_t bits1 = live[2 * stage + 1];
    const uint32_t k_at = smem_u32(sk + stage * kBlockK * RS);
    const uint32_t v_at = smem_u32(sv + stage * kBlockK * RS);
    const int d8 = D / 8;
    for (int c = tid; c < kBlockK * d8; c += kThreads) {
      const int j = c / d8;
      const int ch = c - j * d8;
      const bool ok = (((j < 32) ? (bits0 >> j) : (bits1 >> (j - 32))) & 1u) != 0;
      const size_t off = ok ? (size_t)(t * kBlockK + j) * row + ch * 8 : 0;
      const uint32_t at = (uint32_t)(j * RS + ch * 8) * (uint32_t)sizeof(bf16);
      cp_async16(k_at + at, kb + off, ok);
      cp_async16(v_at + at, vb + off, ok);
    }
  };

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums
  const int grow = lane >> 2;
  const int gcol = 2 * (lane & 3);
  // ldmatrix row addresses of this lane: Q as A; K (B, slots x D) and V
  // (B transposed) rows of this warp's 16 slots.
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int k_row = warp * 16 + ((lane >> 4) << 3) + (lane & 7), k_col = ((lane >> 3) & 1) * 8;
  const int v_row = warp * 16 + (((lane >> 3) & 1) << 3) + (lane & 7), v_col = (lane >> 4) * 8;

  int t = next_live(t_begin, 0);
  if (t < t_end) issue(t, 0);
  cp_async_commit();
  int st = 0;
  while (t < t_end) {
    const int tn = next_live(t + 1, st ^ 1);
    if (tn < t_end) issue(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait1();  // tile t has landed (this thread's copies)
    __syncthreads();   // ... and every thread's
    const uint32_t bits = (live[2 * st + (warp >> 1)] >> ((warp & 1) * 16)) & 0xFFFFu;
    if (bits) {  // this warp's 16 slots hold a live one
      const bf16* ks = sk + st * kBlockK * RS;
      const bf16* vs = sv + st * kBlockK * RS;
      float sc[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4], kf[4];
        ldsm_x4(smem_u32(sq + a_row * RS + kk * 16 + a_col), a);
        ldsm_x4(smem_u32(ks + k_row * RS + kk * 16 + k_col), kf);
        mma_bf16(sc[0], a, kf[0], kf[1]);
        mma_bf16(sc[1], a, kf[2], kf[3]);
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (bits >> (8 * n + gcol + (e & 1))) & 1u;
          sc[n][e] = ok ? sc[n][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = expf(m[i] - mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];
      }
      uint32_t pa[4];  // P (16 heads x 16 slots) as the bf16 A fragment
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = expf(sc[n][2 * i] - m[i]);
          const float p1 = expf(sc[n][2 * i + 1] - m[i]);
          l[i] += p0 + p1;
          pa[2 * n + i] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
#pragma unroll
      for (int n2 = 0; n2 < DP / 16; ++n2) {
        uint32_t vf[4];
        ldsm_x4_trans(smem_u32(vs + v_row * RS + n2 * 16 + v_col), vf);
        mma_bf16(o[2 * n2], pa, vf[0], vf[1]);
        mma_bf16(o[2 * n2 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
    t = tn;
    st ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  // Merge the four warps' (m, l, acc) in warp order, through shared memory
  // (the K/V stages are free: every copy has landed).
  float* cm = reinterpret_cast<float*>(sk);  // [warp][16]
  float* cl = cm + 64;                       // [warp][16]
  float* cw = cl + 64;                       // [warp][16] weights
  float* cacc = cw + 64;                     // [warp][16][DP]
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      cm[warp * 16 + grow + 8 * i] = m[i];
      cl[warp * 16 + grow + 8 * i] = l[i];
    }
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cacc[(warp * 16 + grow + 8 * (e >> 1)) * DP + 8 * n + gcol + (e & 1)] = o[n][e];
  __syncthreads();
  const size_t p0 = ((size_t)split * B + b) * H + (size_t)kh * G_all + g_lo;
  if (tid < 16) {
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) mm = fmaxf(mm, cm[w * 16 + tid]);
    float ll = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = expf(cm[w * 16 + tid] - mm);
      cw[w * 16 + tid] = wt;
      ll += cl[w * 16 + tid] * wt;
    }
    if (tid < G) {
      part_m[p0 + tid] = mm;
      part_l[p0 + tid] = ll;
    }
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int g = e / D;
    const int d = e - g * D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) a += cacc[(w * 16 + g) * DP + d] * cw[w * 16 + g];
    part_acc[(p0 + g) * D + d] = a;
  }
}

// ---------------------------------------------------------------------------
// pass 2: combine the splits of each (b, h), in split order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const uint8_t* __restrict__ active,
    T* __restrict__ out, int BH, int H, int D, int n_split) {
  __shared__ float wts[kMaxSplit];
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  T* o = out + (size_t)bh * D;
  if (active != nullptr && active[bh / H] == 0) {  // partials never written
    for (int d = tid; d < D; d += kThreads) store(o + d, 0.f);
    return;
  }
  float mm = kNegInf;
  for (int z = 0; z < n_split; ++z) mm = fmaxf(mm, part_m[(size_t)z * BH + bh]);
  for (int z = tid; z < n_split; z += kThreads) wts[z] = expf(part_m[(size_t)z * BH + bh] - mm);
  __syncthreads();
  float ll = 0.f;
  for (int z = 0; z < n_split; ++z) ll += part_l[(size_t)z * BH + bh] * wts[z];
  for (int d = tid; d < D; d += kThreads) {
    float a = 0.f;
    if (ll > 0.f) {  // else no split had a live slot: exact 0
      for (int z = 0; z < n_split; ++z) a += part_acc[((size_t)z * BH + bh) * D + d] * wts[z];
      a /= ll;
    }
    store(o + d, a);
  }
}

struct Args {
  const void *q, *k, *v, *cursor, *kv_pos, *kv_valid, *active;
  void* out;
  float *part_m, *part_l, *part_acc;
  int B, S, KV, G, D, causal, window;
  float scale;
  int n_split, tiles_per_split;
  cudaStream_t stream;
};

template <typename T>
int combine(const Args& a) {
  const int BH = a.B * a.KV * a.G;
  decode_combine_kernel<T><<<BH, kThreads, 0, a.stream>>>(
      a.part_m, a.part_l, a.part_acc, static_cast<const uint8_t*>(a.active),
      static_cast<T*>(a.out), BH, a.KV * a.G, a.D, a.n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fma(const Args& a) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int g_chunk = a.G;  // as many query heads per block as shared memory holds
  while (g_chunk > 1 && fma_smem_bytes(g_chunk, a.D) > (size_t)smem_max)
    g_chunk = (g_chunk + 1) / 2;
  const size_t smem = fma_smem_bytes(g_chunk, a.D);
  err = cudaFuncSetAttribute(decode_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.KV * ((a.G + g_chunk - 1) / g_chunk), a.B, a.n_split);
  decode_fma_kernel<T><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int32_t*>(a.cursor), static_cast<const int32_t*>(a.kv_pos),
      static_cast<const uint8_t*>(a.kv_valid), static_cast<const uint8_t*>(a.active),
      a.part_m, a.part_l, a.part_acc, a.B, a.S, a.KV, a.G, g_chunk, a.D, a.causal, a.window,
      a.scale, a.tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine<T>(a);
}

template <int DP>
int launch_mma(const Args& a) {
  const size_t smem = mma_smem_bytes(DP);
  cudaError_t err = cudaFuncSetAttribute(
      decode_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.KV * ((a.G + 15) / 16), a.B, a.n_split);
  decode_mma_kernel<DP><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const int32_t*>(a.cursor),
      static_cast<const int32_t*>(a.kv_pos), static_cast<const uint8_t*>(a.kv_valid),
      static_cast<const uint8_t*>(a.active), a.part_m, a.part_l, a.part_acc, a.B, a.S, a.KV,
      a.G, a.D, a.causal, a.window, a.scale, a.tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return combine<bf16>(a);
}

bool bad_args(const Args& a) {
  return a.D % 8 != 0 || a.D > 256 || a.G < 1 || a.KV < 1 || a.B < 1 || a.S < 1 ||
         a.n_split < 1 || a.n_split > kMaxSplit || a.tiles_per_split < 1 ||
         (long long)a.n_split * a.tiles_per_split * kBlockK < a.S;
}

}  // namespace

// dtype: 0 = float32 (FMA), 1 = bfloat16 (mma.sync). causal: 0/1 (0 drops
// kv_pos <= cursor). window <= 0 means no window. part_m / part_l hold n_split * B * H floats and part_acc that
// times D; split z covers slots [z, z + 1) * tiles_per_split * 64. Two
// launches (partials, combine) on `stream`; returns the first failing
// launch's cudaGetLastError() (0 on success).
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                    const void* cursor, const void* kv_pos,
                                    const void* kv_valid, const void* active, void* out,
                                    float* part_m, float* part_l, float* part_acc, int B,
                                    int S, int KV, int G, int D, int causal, int window,
                                    float scale, int n_split, int tiles_per_split,
                                    void* stream) {
  const Args a{q, k, v, cursor, kv_pos, kv_valid, active, out, part_m, part_l, part_acc,
               B, S, KV, G, D, causal, window, scale, n_split, tiles_per_split,
               static_cast<cudaStream_t>(stream)};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fma<float>(a);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (D <= 16) return launch_mma<16>(a);
  if (D <= 32) return launch_mma<32>(a);
  if (D <= 64) return launch_mma<64>(a);
  if (D <= 128) return launch_mma<128>(a);
  return launch_mma<256>(a);
}

// The previous bf16 design (the FMA kernel: the float32 route's template,
// here at either dtype), kept for side-by-side timing only. Same
// arguments as decode_attention_fwd.
extern "C" int decode_attention_fma_fwd(int dtype, const void* q, const void* k,
                                        const void* v, const void* cursor,
                                        const void* kv_pos, const void* kv_valid,
                                        const void* active, void* out, float* part_m,
                                        float* part_l, float* part_acc, int B, int S, int KV,
                                        int G, int D, int causal, int window, float scale,
                                        int n_split, int tiles_per_split, void* stream) {
  const Args a{q, k, v, cursor, kv_pos, kv_valid, active, out, part_m, part_l, part_acc,
               B, S, KV, G, D, causal, window, scale, n_split, tiles_per_split,
               static_cast<cudaStream_t>(stream)};
  if (bad_args(a)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_fma<float>(a);
  if (dtype == 1) return launch_fma<bf16>(a);
  return (int)cudaErrorInvalidValue;
}
