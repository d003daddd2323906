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
// 1. Chunked, `wkv6_chunked_fwd` (bf16 r and S >= kT = 64): the time axis
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
// it writes them, and blocks own disjoint slices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

  su[j] = j < K ? to_float(u[(size_t)h * K + j]) : 0.f;

  float st[kMax];
  const size_t sbase = (size_t)bh * K * V;
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
           const void* s0, void* out, void* s_last, int B, int S, int H, int K, int V,
           cudaStream_t stream) {
  wkv6_kernel<TR, TW><<<B * H, kThreads, 0, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k), static_cast<const TR*>(v),
      static_cast<const TW*>(w), static_cast<const TR*>(u), static_cast<const float*>(s0),
      static_cast<TR*>(out), static_cast<float*>(s_last), S, H, K, V);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Chunked route: bf16 r/k/v/u, S >= kT (see the header).
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kT = 64;          // steps per chunk
constexpr int kSub = 16;        // steps per sub-block: one warp's query rows
constexpr int kNSub = kT / kSub;
constexpr int kHalf = kSub / 2;  // steps per half: the running sums restart at each
constexpr int kNHalf = kT / kHalf;
constexpr int kFRows = kNHalf * (kNHalf + 1) / 2;  // the decay-factor table's rows
constexpr int kStateThreads = 2 * 32 * kNSub;  // state kernel: a warp per 16 x 32 of dS
constexpr int kOutThreads = 2 * 32 * kNSub;   // output kernel: tensor-core and diagonal warps
constexpr int kRS = kMax + 8;   // bf16 row stride of the ldmatrix tiles (conflict-free)
constexpr int kQS = kMax + 8;   // f32 row stride of q, which warps read 8 rows at a time
constexpr float kLog2Clamp = -86.56170245333781f;  // -60 / ln 2
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 8;  // chunks whose loads the carry issues together

// The special-function unit's log2 and exp2 (about 2 ulp; results below
// 2^-126 flush to 0, as w = 0 and w below 2^-126 do on input: log2 gives
// -inf and the clamp holds it).
__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float log2_clamped(float w) { return fmaxf(fast_log2(w), kLog2Clamp); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
// c (16 x 8, f32) += a (16 x 16) b (16 x 8), bf16 inputs. Not volatile:
// the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// (x0, x1) as two bf16 pairs whose sum carries about 16 significant bits:
// hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}
__device__ __forceinline__ void split_store(bf16* hi, bf16* lo, float x) {
  const bf16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}
__device__ __forceinline__ float2 load_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// o[n] += a b[n] over the 8 n-tiles of a 64-wide B held as 4 ldmatrix.x4
// groups (group n / 2, registers 2 (n % 2) and 2 (n % 2) + 1).
__device__ __forceinline__ void mma_row(float (&o)[kMax / 8][4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[kMax / 16][4]) {
#pragma unroll
  for (int n = 0; n < kMax / 8; ++n)
    mma_bf16(o[n], a, b[n / 2][2 * (n & 1)], b[n / 2][2 * (n & 1) + 1]);
}
// Products of split operands: a b = a_hi b_hi + a_lo b_hi + a_hi b_lo (a_lo
// b_lo, about 2^-16 of the product, is dropped). Each pass below runs over
// all the independent accumulators before the next pass, so that no two
// consecutive products wait on each other.

// Fragments (lane l of a warp): an m16n8 accumulator c[e] is row
// l/4 + 8 (e / 2), column 2 (l % 4) + e % 2; a 16 x 16 A fragment a[2 hi +
// row] holds rows l/4 + 8 row at columns 8 hi + 2 (l % 4) + {0, 1}; a
// 16 x 8 B fragment b[hi] holds column l/4 at rows 8 hi + 2 (l % 4) + {0, 1}.
// ldmatrix row addresses of lane l for a 16 x 16 tile at (row0, col0):
//   B from [n][k] storage (x4): rows row0 + 8 (l >> 4) + (l & 7), columns
//     col0 + 8 ((l >> 3) & 1), giving the n-tiles row0 and row0 + 8;
//   B from [k][n] storage (x4.trans): rows row0 + 8 ((l >> 3) & 1) + (l & 7),
//     columns col0 + 8 (l >> 4), giving the n-tiles col0 and col0 + 8;
//   A from [k][m] storage (x4.trans): rows row0 + (l & 7) + 8 (l >> 4),
//     columns col0 + 8 ((l >> 3) & 1).

struct ChunkArgs {
  const bf16* r;     // (B, S, H, K)
  const bf16* k;     // (B, S, H, K)
  const bf16* v;     // (B, S, H, V)
  const void* w;     // (B, S, H, K), float32 or bf16
  const bf16* u;     // (H, K)
  const float* s0;   // (B, H, K, V) or null; may alias s_last
  bf16* out;         // (B, S, H, V)
  float* s_last;     // (B, H, K, V)
  float* slots;      // (B, H, C, K, V) scratch: dS_c, then S_c
  float* decay;      // (B, H, C, K) scratch: 2^G_63 of each chunk
  int S, H, K, V, C;
  int vec;           // K and V multiples of 8, r/k/v/w/out/slots 16-byte aligned
};

// Staging of one chunk's rows into shared memory. Steps past S are
// identities (w = 1, r = k = v = 0); channels past K or V are zero (w = 1).
// With p.vec every thread moves 16 bytes at a time and issues all its
// loads before it uses any (bf16 tiles by cp.async straight into shared
// memory); otherwise one element at a time.
__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
// 16-byte async copy global -> shared; zero-fills when !pred (src-size 0:
// nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// A (T, D) bf16 tile of x (row stride H D in global memory) into dst
// (row stride ld), zero past S and past D. With p.vec the copies are in
// flight when this returns: cp_async_wait_all() and a barrier land them.
template <int NT>
__device__ __forceinline__ void stage_bf16(const ChunkArgs& p, const bf16* x, int D, int b, int h,
                                           int c, bf16* dst, int ld, int tid) {
  if (p.vec) {
#pragma unroll
    for (int i = 0; i < kT * kMax / 8 / NT; ++i) {
      const int e = tid + i * NT;
      const int t = e / (kMax / 8), c8 = (e % (kMax / 8)) * 8;
      const int tg = c * kT + t;
      const bool live = tg < p.S && c8 < D;
      // A dead copy reads nothing; its address only has to be valid.
      const bf16* src = live ? x + (((size_t)b * p.S + tg) * p.H + h) * D + c8 : x;
      cp_async16(smem_u32(dst + t * ld + c8), src, live);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kT * kMax; e += NT) {
      const int t = e / kMax, ch = e % kMax;
      const int tg = c * kT + t;
      dst[t * ld + ch] = (tg < p.S && ch < D) ? x[(((size_t)b * p.S + tg) * p.H + h) * D + ch]
                                             : zero;
    }
  }
}

template <int LD>
__device__ __forceinline__ void put_w(float (*sw)[kMax], float (*sL)[LD], int t, int ch, float w) {
  if (sw != nullptr) sw[t][ch] = w;
  sL[t][ch] = log2_clamped(w);
}

// w (as float32) into sw (when given) and a = log2 w (clamped) into sL.
template <typename TW, int NT, int LD>
__device__ __forceinline__ void stage_w(const ChunkArgs& p, int b, int h, int c,
                                        float (*sw)[kMax], float (*sL)[LD], int tid) {
  const TW* w = static_cast<const TW*>(p.w);
  constexpr int per = 16 / sizeof(TW);  // elements in 16 bytes
  constexpr int n = kT * kMax / per / NT;
  if (p.vec) {
    uint4 raw[n];
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const int e = tid + i * NT;
      const int t = e / (kMax / per), c0 = (e % (kMax / per)) * per;
      const int tg = c * kT + t;
      raw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (tg < p.S && c0 < p.K)
        raw[i] = ld16(w + (((size_t)b * p.S + tg) * p.H + h) * p.K + c0);
    }
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const int e = tid + i * NT;
      const int t = e / (kMax / per), c0 = (e % (kMax / per)) * per;
      const bool live = c * kT + t < p.S && c0 < p.K;
      const TW* vals = reinterpret_cast<const TW*>(&raw[i]);
#pragma unroll
      for (int q = 0; q < per; ++q) put_w(sw, sL, t, c0 + q, live ? to_float(vals[q]) : 1.f);
    }
  } else {
    for (int e = tid; e < kT * kMax; e += NT) {
      const int t = e / kMax, ch = e % kMax;
      const int tg = c * kT + t;
      const bool live = tg < p.S && ch < p.K;
      put_w(sw, sL, t, ch,
            live ? to_float(w[(((size_t)b * p.S + tg) * p.H + h) * p.K + ch]) : 1.f);
    }
  }
}

// Prefix sums of a (log2 w) inside each 8-step half, in place: each
// becomes the inclusive local sum L_t; L at a half's last step is its
// total T. Fixed order (step by step).
template <int LD>
__device__ __forceinline__ void local_sums(float (*sL)[LD], int tid, int nthreads) {
  for (int task = tid; task < kNHalf * kMax; task += nthreads) {
    const int j = task / kMax, c = task % kMax;
    float x = 0.f;
#pragma unroll
    for (int t = 0; t < kHalf; ++t) {
      x += sL[j * kHalf + t][c];
      sL[j * kHalf + t][c] = x;
    }
  }
}

// a. dS_c = (k 2^(G_63 - G))^T v and the chunk's decay 2^G_63.
template <typename TW>
__global__ void __launch_bounds__(kStateThreads) wkv6_chunk_state_kernel(ChunkArgs p) {
  __shared__ __align__(16) float sL[kT][kMax];
  __shared__ __align__(16) bf16 sKd[2][kT][kRS];  // k, then k 2^(G_63 - G): hi, lo
  __shared__ __align__(16) bf16 sV[kT][kRS];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  stage_bf16<kStateThreads>(p, p.k, p.K, b, h, c, &sKd[0][0][0], kRS, tid);
  stage_bf16<kStateThreads>(p, p.v, p.V, b, h, c, &sV[0][0], kRS, tid);
  stage_w<TW, kStateThreads, kMax>(p, b, h, c, nullptr, sL, tid);
  cp_async_wait_all();
  __syncthreads();
  local_sums(sL, tid, kStateThreads);
  __syncthreads();
  // Thread tid decays channel ch of steps tid / 64 + 4 q.
  const int ch = tid & (kMax - 1);
  float tot[kNHalf], post[kNHalf];  // half totals; sums of the later ones
#pragma unroll
  for (int j = 0; j < kNHalf; ++j) tot[j] = sL[j * kHalf + kHalf - 1][ch];
  post[kNHalf - 1] = 0.f;
#pragma unroll
  for (int j = kNHalf - 2; j >= 0; --j) post[j] = post[j + 1] + tot[j + 1];
  constexpr int kRows = kT * kMax / kStateThreads;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int t = (tid >> 6) + (kStateThreads / kMax) * q;
    const int j = q / 2;  // t's half
    const float x = __bfloat162float(sKd[0][t][ch]) * fast_exp2((tot[j] - sL[t][ch]) + post[j]);
    split_store(&sKd[0][t][ch], &sKd[1][t][ch], x);
  }
  const size_t bhc = ((size_t)b * p.H + h) * p.C + c;
  if (tid < p.K) p.decay[bhc * p.K + tid] = fast_exp2(post[0] + tot[0]);
  __syncthreads();

  // Warp w: rows 16 (w % 4) .. + 15 (key channels) of dS, v columns
  // 32 (w / 4) .. + 31.
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = (warp % kNSub) * 16, col0 = (warp / kNSub) * (kMax / 2);
  float acc[kMax / 16][4];
#pragma unroll
  for (int n = 0; n < kMax / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int xrow = (lane & 7) + ((lane >> 4) << 3), xcol = row0 + ((lane >> 3) & 1) * 8;
  const int vrow = (((lane >> 3) & 1) << 3) + (lane & 7), vcol = col0 + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    uint32_t ah[4], al[4], vf[kMax / 32][4];  // v is bf16: exact in one part
    ldsm_x4_trans(smem_u32(&sKd[0][kk * 16 + xrow][xcol]), ah);
    ldsm_x4_trans(smem_u32(&sKd[1][kk * 16 + xrow][xcol]), al);
#pragma unroll
    for (int n2 = 0; n2 < kMax / 32; ++n2)
      ldsm_x4_trans(smem_u32(&sV[kk * 16 + vrow][n2 * 16 + vcol]), vf[n2]);
#pragma unroll
    for (int n = 0; n < kMax / 16; ++n)
      mma_bf16(acc[n], ah, vf[n / 2][2 * (n & 1)], vf[n / 2][2 * (n & 1) + 1]);
#pragma unroll
    for (int n = 0; n < kMax / 16; ++n)
      mma_bf16(acc[n], al, vf[n / 2][2 * (n & 1)], vf[n / 2][2 * (n & 1) + 1]);
  }
  float* ds = p.slots + bhc * p.K * p.V;
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int n = 0; n < kMax / 16; ++n)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int kc = row0 + g + 8 * e2;
      const int vv = col0 + 8 * n + 2 * q4;
      if (kc >= p.K || vv >= p.V) continue;
      float* dst = ds + (size_t)kc * p.V + vv;
      if (p.vec) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[n][2 * e2], acc[n][2 * e2 + 1]);
      } else {
        dst[0] = acc[n][2 * e2];
        if (vv + 1 < p.V) dst[1] = acc[n][2 * e2 + 1];
      }
    }
}

// b. The carry: one thread per (b, h, k, v) element, chunk after chunk,
// the loads of kCarryBatch chunks issued before any of their stores.
__global__ void __launch_bounds__(kCarryThreads) wkv6_chunk_carry_kernel(ChunkArgs p, int BH) {
  const long long e = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  const int kv = p.K * p.V;
  if (e >= (long long)BH * kv) return;
  const int bh = (int)(e / kv);
  const int i = (int)(e - (long long)bh * kv);
  float x = p.s0 != nullptr ? p.s0[e] : 0.f;
  float* sl = p.slots + (size_t)bh * p.C * kv + i;
  const float* dc = p.decay + (size_t)bh * p.C * p.K + i / p.V;
  for (int c0 = 0; c0 < p.C; c0 += kCarryBatch) {
    float ds[kCarryBatch], g[kCarryBatch];
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      if (c0 + q < p.C) {
        ds[q] = sl[(size_t)(c0 + q) * kv];
        g[q] = dc[(size_t)(c0 + q) * p.K];
      }
    }
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      if (c0 + q < p.C) {
        sl[(size_t)(c0 + q) * kv] = x;  // the state entering chunk c0 + q
        x = fmaf(g[q], x, ds[q]);
      }
    }
  }
  p.s_last[e] = x;
}

// Dynamic shared memory of the output kernel.
struct OutSmem {
  float w[kT][kMax];
  float L[kT][kQS];       // inclusive local sums of log2 w, then q_t = r_t 2^Lx_t
  float f[kFRows][kMax];  // decay factors between halves, see factor_row
  float u[kMax];
  float d[kNSub][kSub][kSub + 1];  // each sub-block's diagonal score block
  bf16 r[kT][kMax];
  bf16 k[kT][kRS];
  bf16 v[kT][kRS];
  bf16 kh[2][kT][kRS];    // k_s 2^(T_h - L_s), decayed to the end of its half h: hi, lo
  bf16 st[2][kMax][kRS];  // S_c: hi, lo
};

// Row of the factor table for query half qh and key half qh' = m - 1 < qh
// (m = 0: the chunk's start, for the state term): 2^(T_m + ... + T_{qh-1}),
// the decay over the halves strictly between, summed from the last.
__device__ __forceinline__ int factor_row(int qh, int m) { return qh * (qh + 1) / 2 + m; }

// Split A fragment of q_t f_row(c) for rows ta and ta + 8 (one sub-block's
// two halves, factor rows f0 and f1) at channels 16 kk + ...; with
// `second_only`, the first half's rows are zero.
__device__ __forceinline__ void query_frag(const OutSmem& sm, int ta, int kk, int q4, int f0,
                                           int f1, bool second_only, uint32_t (&ah)[4],
                                           uint32_t (&al)[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = kk * 16 + half * 8 + 2 * q4;
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      float2 x = make_float2(0.f, 0.f);
      if (!second_only || row == 1) {
        const float2 q = *reinterpret_cast<const float2*>(&sm.L[ta + 8 * row][c]);
        const float2 fac = *reinterpret_cast<const float2*>(&sm.f[row ? f1 : f0][c]);
        x = make_float2(q.x * fac.x, q.y * fac.y);
      }
      split_pack(x.x, x.y, ah[2 * half + row], al[2 * half + row]);
    }
  }
}

// o += P V for a split 16 x 16 score block P and the 16 steps of v whose
// ldmatrix rows start at vrow (v is bf16: exact in one part).
__device__ __forceinline__ void scores_times_v(const OutSmem& sm, int vrow, int vcol,
                                               const uint32_t (&ph)[4], const uint32_t (&pl)[4],
                                               float (&o)[kMax / 8][4]) {
  uint32_t vf[kMax / 16][4];
#pragma unroll
  for (int n2 = 0; n2 < kMax / 16; ++n2)
    ldsm_x4_trans(smem_u32(&sm.v[vrow][n2 * 16 + vcol]), vf[n2]);
  mma_row(o, ph, vf);
  mma_row(o, pl, vf);
}

// The diagonal 16 x 16 score block of sub-block i, the parts that need no
// tensor core: D[t][s] = sum_k r_t k_s w_{s+1} ... w_{t-1} for s < t in
// the same 8-step half, and r_s . (u k_s) at t = s. Lane (s, half) runs key
// step s over channels 4 jj + 2 half + {0, 1}; its factor f is 0 until
// t = s, then 1, then multiplied by w step by step. It also writes the
// zeros above the diagonal; the block of second-half queries against
// first-half keys comes from the tensor cores.
__device__ __forceinline__ void diagonal_block(OutSmem& sm, int i, int lane) {
  const int t_base = i * kSub;
  const int s = lane >> 1, half = lane & 1;
  const int tb = s & kHalf;  // the first step of s's half
  float acc[kHalf], delta[kHalf];
#pragma unroll
  for (int tt = 0; tt < kHalf; ++tt) {
    acc[tt] = 0.f;
    delta[tt] = tb + tt == s ? 1.f : 0.f;
  }
  float accu = 0.f;
#pragma unroll 4
  for (int jj = 0; jj < kMax / 4; ++jj) {
    const int c2 = 4 * jj + 2 * half;
    const float2 ks = load_bf16x2(&sm.k[t_base + s][c2]);
    const float2 rs = load_bf16x2(&sm.r[t_base + s][c2]);
    const float2 us = *reinterpret_cast<const float2*>(&sm.u[c2]);
    accu = fmaf(rs.x * us.x, ks.x, accu);
    accu = fmaf(rs.y * us.y, ks.y, accu);
    float f0 = 0.f, f1 = 0.f;
#pragma unroll
    for (int tt = 0; tt < kHalf; ++tt) {
      const int t = t_base + tb + tt;
      const float2 rr = load_bf16x2(&sm.r[t][c2]);
      const float2 ww = *reinterpret_cast<const float2*>(&sm.w[t][c2]);
      acc[tt] = fmaf(rr.x * f0, ks.x, acc[tt]);
      acc[tt] = fmaf(rr.y * f1, ks.y, acc[tt]);
      f0 = fmaf(f0, ww.x, delta[tt]);
      f1 = fmaf(f1, ww.y, delta[tt]);
    }
  }
#pragma unroll
  for (int tt = 0; tt < kHalf; ++tt) acc[tt] += __shfl_xor_sync(0xffffffffu, acc[tt], 1);
  accu += __shfl_xor_sync(0xffffffffu, accu, 1);
  // Lane half h writes rows tb + 4 h + {0..3} of column s (and, for keys of
  // the second half, zeros in rows 4 h + {0..3} of the first).
#pragma unroll
  for (int tt = 0; tt < kHalf; ++tt) {
    if ((tt >> 2) != half) continue;
    sm.d[i][tb + tt][s] = tb + tt == s ? accu : acc[tt];
    if (tb) sm.d[i][tt][s] = 0.f;
  }
}

// c. o for one chunk. Warps 0-3 (query sub-block i = warp) run the tensor
// cores; warps 4-7 meanwhile form sub-block i = warp - 4's diagonal block.
template <typename TW>
__global__ void __launch_bounds__(kOutThreads) wkv6_chunk_out_kernel(ChunkArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  stage_bf16<kOutThreads>(p, p.r, p.K, b, h, c, &sm.r[0][0], kMax, tid);
  stage_bf16<kOutThreads>(p, p.k, p.K, b, h, c, &sm.k[0][0], kRS, tid);
  stage_bf16<kOutThreads>(p, p.v, p.V, b, h, c, &sm.v[0][0], kRS, tid);
  const size_t bhc = ((size_t)b * p.H + h) * p.C + c;
  const float* sc_in = p.slots + bhc * p.K * p.V;
  constexpr int kStateVecs = kMax * kMax / 4 / kOutThreads;
  float4 sx[kStateVecs];
  if (p.vec) {  // S_c's loads in flight beside w's
#pragma unroll
    for (int i = 0; i < kStateVecs; ++i) {
      const int e = tid + i * kOutThreads;
      const int kc = e / (kMax / 4), v4 = (e % (kMax / 4)) * 4;
      sx[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kc < p.K && v4 < p.V)
        sx[i] = *reinterpret_cast<const float4*>(sc_in + (size_t)kc * p.V + v4);
    }
  }
  stage_w<TW, kOutThreads, kQS>(p, b, h, c, sm.w, sm.L, tid);
  if (p.vec) {
#pragma unroll
    for (int i = 0; i < kStateVecs; ++i) {
      const int e = tid + i * kOutThreads;
      const int kc = e / (kMax / 4), v4 = (e % (kMax / 4)) * 4;
      const float4 x = sx[i];
      uint32_t h0, l0, h1, l1;
      split_pack(x.x, x.y, h0, l0);
      split_pack(x.z, x.w, h1, l1);
      *reinterpret_cast<uint2*>(&sm.st[0][kc][v4]) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(&sm.st[1][kc][v4]) = make_uint2(l0, l1);
    }
  } else {
    for (int e = tid; e < kMax * kMax; e += kOutThreads) {
      const int kc = e / kMax, vv = e % kMax;
      split_store(&sm.st[0][kc][vv], &sm.st[1][kc][vv],
                  (kc < p.K && vv < p.V) ? sc_in[(size_t)kc * p.V + vv] : 0.f);
    }
  }
  if (tid < kMax) sm.u[tid] = tid < p.K ? __bfloat162float(p.u[(size_t)h * p.K + tid]) : 0.f;
  cp_async_wait_all();
  __syncthreads();
  local_sums(sm.L, tid, kOutThreads);
  __syncthreads();
  // Every exponent below is a sum of a's, <= 0, taken inside a half or
  // over whole halves: never a difference of two large running sums.
  for (int e = tid; e < kNHalf * kMax; e += kOutThreads) {  // (query half, channel)
    const int qh = e / kMax, ch = e % kMax;
    float x = 0.f;  // the totals of halves m .. qh - 1, summed from the last
    sm.f[factor_row(qh, qh)][ch] = 1.f;
    for (int m = qh - 1; m >= 0; --m) {
      x += sm.L[m * kHalf + kHalf - 1][ch];
      sm.f[factor_row(qh, m)][ch] = fast_exp2(x);
    }
  }
  constexpr int kElems = kT * kMax / kOutThreads;
  float q[kElems];
#pragma unroll
  for (int i = 0; i < kElems; ++i) {
    const int e = tid + i * kOutThreads;
    const int t = e / kMax, ch = e % kMax;
    const float tot = sm.L[(t / kHalf) * kHalf + kHalf - 1][ch];
    split_store(&sm.kh[0][t][ch], &sm.kh[1][t][ch],
                __bfloat162float(sm.k[t][ch]) * fast_exp2(tot - sm.L[t][ch]));
    const float lx = t % kHalf == 0 ? 0.f : sm.L[t - 1][ch];  // exclusive local sum
    q[i] = __bfloat162float(sm.r[t][ch]) * fast_exp2(lx);
  }
  __syncthreads();  // every read of L is done
#pragma unroll
  for (int i = 0; i < kElems; ++i) {
    const int e = tid + i * kOutThreads;
    sm.L[e / kMax][e % kMax] = q[i];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  if (warp >= kNSub) {
    diagonal_block(sm, warp - kNSub, lane);
    __syncthreads();
    return;
  }
  const int t_base = warp * kSub;
  const int g = lane >> 2, q4 = lane & 3;
  const int ta = t_base + g;
  const int vrow = (((lane >> 3) & 1) << 3) + (lane & 7), vcol = (lane >> 4) * 8;
  const int krow = ((lane >> 4) << 3) + (lane & 7), kcol = ((lane >> 3) & 1) * 8;
  float o[kMax / 8][4];
#pragma unroll
  for (int n = 0; n < kMax / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // (r_t 2^G_{t-1}) S_c: each half's q times the decay of the halves before.
  const int qh0 = 2 * warp, qh1 = 2 * warp + 1;  // the warp's two query halves
#pragma unroll
  for (int kk = 0; kk < kMax / 16; ++kk) {
    uint32_t ah[4], al[4], sh[kMax / 16][4], sl[kMax / 16][4];
#pragma unroll
    for (int n2 = 0; n2 < kMax / 16; ++n2) {
      ldsm_x4_trans(smem_u32(&sm.st[0][kk * 16 + vrow][n2 * 16 + vcol]), sh[n2]);
      ldsm_x4_trans(smem_u32(&sm.st[1][kk * 16 + vrow][n2 * 16 + vcol]), sl[n2]);
    }
    query_frag(sm, ta, kk, q4, factor_row(qh0, 0), factor_row(qh1, 0), false, ah, al);
    mma_row(o, ah, sh);
    mma_row(o, al, sh);
    mma_row(o, ah, sl);
  }
  // Scores against each earlier key sub-block j: its two halves (n-tiles)
  // are referenced at their own ends, the query rows at their halves'
  // starts, with the decay of the halves between as a factor.
  for (int j = 0; j < warp; ++j) {
    // The three split products in three accumulator sets, summed at the end.
    float sc[3][2][4];
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[x][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMax / 16; ++kk) {
      uint32_t kh[4], kl[4];
      ldsm_x4(smem_u32(&sm.kh[0][j * kSub + krow][kk * 16 + kcol]), kh);
      ldsm_x4(smem_u32(&sm.kh[1][j * kSub + krow][kk * 16 + kcol]), kl);
#pragma unroll
      for (int n = 0; n < 2; ++n) {  // key half 2 j + n
        uint32_t ah[4], al[4];
        query_frag(sm, ta, kk, q4, factor_row(qh0, 2 * j + n + 1),
                   factor_row(qh1, 2 * j + n + 1), false, ah, al);
        mma_bf16(sc[0][n], ah, kh[2 * n], kh[2 * n + 1]);
        mma_bf16(sc[1][n], al, kh[2 * n], kh[2 * n + 1]);
        mma_bf16(sc[2][n], ah, kl[2 * n], kl[2 * n + 1]);
      }
    }
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int e0 = 2 * i2, e1 = 2 * i2 + 1;
        split_pack((sc[0][n][e0] + sc[1][n][e0]) + sc[2][n][e0],
                   (sc[0][n][e1] + sc[1][n][e1]) + sc[2][n][e1], ph[2 * n + i2], pl[2 * n + i2]);
      }
    scores_times_v(sm, j * kSub + vrow, vcol, ph, pl, o);
  }
  // Inside the sub-block: second-half queries (q, referenced at their
  // half's start) against first-half keys (kh, referenced at its end);
  // the scores go into the diagonal block's lower-left quarter.
  {
    float sc[3][4];
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[x][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kMax / 16; ++kk) {
      uint32_t ah[4], al[4], kh[4], kl[4];
      ldsm_x4(smem_u32(&sm.kh[0][t_base + krow][kk * 16 + kcol]), kh);
      ldsm_x4(smem_u32(&sm.kh[1][t_base + krow][kk * 16 + kcol]), kl);
      query_frag(sm, ta, kk, q4, 0, factor_row(qh1, qh0 + 1), true, ah, al);
      mma_bf16(sc[0], ah, kh[0], kh[1]);
      mma_bf16(sc[1], al, kh[0], kh[1]);
      mma_bf16(sc[2], ah, kl[0], kl[1]);
    }
    sm.d[warp][kHalf + g][2 * q4] = (sc[0][2] + sc[1][2]) + sc[2][2];
    sm.d[warp][kHalf + g][2 * q4 + 1] = (sc[0][3] + sc[1][3]) + sc[2][3];
  }
  __syncthreads();  // the diagonal blocks are complete
  {
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        const float* d = sm.d[warp][g + 8 * row];
        split_pack(d[8 * half + 2 * q4], d[8 * half + 2 * q4 + 1], ph[2 * half + row],
                   pl[2 * half + row]);
      }
    scores_times_v(sm, t_base + vrow, vcol, ph, pl, o);
  }
#pragma unroll
  for (int n = 0; n < kMax / 8; ++n)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int tg = c * kT + ta + 8 * e2;
      const int vv = 8 * n + 2 * q4;
      if (tg >= p.S || vv >= p.V) continue;
      bf16* dst = p.out + (((size_t)b * p.S + tg) * p.H + h) * p.V + vv;
      if (p.vec) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(o[n][2 * e2], o[n][2 * e2 + 1]);
      } else {
        dst[0] = __float2bfloat16(o[n][2 * e2]);
        if (vv + 1 < p.V) dst[1] = __float2bfloat16(o[n][2 * e2 + 1]);
      }
    }
}

template <typename TW>
int launch_chunked(const ChunkArgs& p, int B, cudaStream_t stream) {
  const dim3 grid(p.C, p.H, B);
  wkv6_chunk_state_kernel<TW><<<grid, kStateThreads, 0, stream>>>(p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)B * p.H * p.K * p.V;
  wkv6_chunk_carry_kernel<<<(unsigned)((n + kCarryThreads - 1) / kCarryThreads), kCarryThreads,
                            0, stream>>>(p, B * p.H);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = (int)cudaFuncSetAttribute(wkv6_chunk_out_kernel<TW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sizeof(OutSmem));
  if (err) return err;
  wkv6_chunk_out_kernel<TW><<<grid, kOutThreads, sizeof(OutSmem), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// r_dtype (r, k, v, u, out) and w_dtype: 0 = float32, 1 = bfloat16.
// s0 may be null (a zero initial state) and may equal s_last.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int wkv6_fwd(int r_dtype, int w_dtype, const void* r, const void* k,
                        const void* v, const void* w, const void* u, const void* s0,
                        void* out, void* s_last, int B, int S, int H, int K, int V,
                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || K > kMax || V < 1 || V > kMax ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r_dtype == 0 && w_dtype == 0)
    return launch<float, float>(r, k, v, w, u, s0, out, s_last, B, S, H, K, V, st);
  if (r_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, s0, out, s_last, B, S, H, K, V, st);
  if (r_dtype == 1 && w_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, s0, out, s_last, B, S, H, K,
                                                V, st);
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
  if (B < 1 || S < kT || H < 1 || K < 1 || K > kMax || V < 1 || V > kMax || H > 65535 ||
      B > 65535 || (long long)B * H * K * V > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ChunkArgs p{static_cast<const bf16*>(r), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), w, static_cast<const bf16*>(u),
              static_cast<const float*>(s0), static_cast<bf16*>(out),
              static_cast<float*>(s_last), static_cast<float*>(slots),
              static_cast<float*>(decay), S, H, K, V, (S + kT - 1) / kT, 0};
  const uintptr_t any = reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
                        reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(slots);
  p.vec = K % 8 == 0 && V % 8 == 0 && any % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return launch_chunked<float>(p, B, st);
  if (w_dtype == 1) return launch_chunked<bf16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}
