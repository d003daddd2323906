// The backward of the RWKV-6 "Finch" WKV recurrence for Hopper, sm_90a.
//
// The gradient of the Pallas TPU kernel `wkv6` in src/repro/kernels/wkv6.py
// (pallas_call at line 99); in the reference it is XLA autodiff of
// src/repro/models/recurrent.py::rwkv6_wkv_scan (line 263). The forward,
// per (batch b, head h), with a K x V float32 state S:
//     o_t = r_t (S_{t-1} + diag(u) k_t^T v_t),   S_t = diag(w_t) S_{t-1} + k_t^T v_t.
// With G_t the gradient of S_t (seeded by the last state's gradient),
// walking t from the last step to the first, in float32:
//     dr_t = do_t (S_{t-1} + diag(u) k_t^T v_t)^T
//     X    = G_t + diag(u) r_t^T do_t           (the gradient of k_t^T v_t)
//     dk_t = X v_t^T,   dv_t = k_t X
//     dw_t = rowsum(G_t . S_{t-1})
//     du  += r_t . k_t (do_t . v_t)             (over batch and time)
//     G_{t-1} = diag(w_t) G_t + r_t^T do_t,     d state0 = G_0.
// This is the sequential recurrence's derivative: the chunked forward's
// clamp of log w at -60 is not differentiated. r/k/v/u/do in one dtype
// (float32 or bfloat16) and dr/dk/dv/du written in it; w in float32 or
// that dtype and dw in w's; the states and their gradients float32. K, V
// <= 64. `ref.wkv6_bwd_plain` is the same recurrences in plain PyTorch.
//
// What bounds it on the H100: at rwkv6-1.6b's training shape (B = 8,
// S = 1024, H = 32, K = V = 64, bf16, w float32) the function reads r, k,
// v, w, do and writes dr, dk, dv, dw: about 0.37 GB, 0.11 ms at 3.35 TB/s;
// its recurrences are about 12 K V flops a step per (b, h), 12.9 GFLOP,
// 0.19 ms at the FP32 rate. Both designs add the states they recompute.
//
// Two designs, a rule by dtype (never a fallback), no atomics in either:
// two calls agree bit for bit.
//
// 1. Chunked (bf16 r): time is cut into 64-step chunks that run in
//    parallel, in five steps on the stream:
//    a. S_c, the state entering each chunk: the chunked forward's chunk
//       summaries (k 2^(...))^T v on the tensor cores and its carry
//       (csrc/wkv6_chunk.cuh, shared with the forward);
//    b. the same kernels with time reversed (wkv6c::src_step<true>): G_{t-1} =
//       diag(w_t) G_t + r_t^T do_t is the forward recurrence walked
//       backwards with r, do in the places of k, v, so its summaries and
//       carry, seeded with the last state's gradient, give G_end, the
//       gradient leaving each chunk, and d state0 as its last state;
//    c. its output kernel with k in the place of r gives dv_t = k_t G_t +
//       (k_t . (u r_t)) do_t on the tensor cores, operands split hi/lo as
//       the forward's are (the 2e-2 tolerance needs about 16 bits);
//    d. `wkv6_bwd_walk_kernel`, one block per (chunk, h, b), 256 threads,
//       the chunk cut into four 16-step sub-chunks. With S_p the state
//       entering sub-chunk p and G_p the gradient at its last step, and
//       A_t, B_t the products of the sub-chunk's w before and after t,
//       P(s, t) and Q(t, s) the products strictly between s and t:
//         S_{t-1} = A_t S_p + sum_{s<t} P(s,t) k_s^T v_s,
//         G_t     = B_t G_p + sum_{s>t} Q(t,s) r_s^T do_s,
//       so dw_t = rowsum(G_t . S_{t-1}) expands, exactly, into
//         A_t B_t rowsum(S_p . G_p) + B_t sum_{s<t} P k_s (G_p v_s^T)
//         + A_t sum_{s>t} Q r_s (S_p do_s^T)
//         + sum_{s'<t<s} P(s',t) Q(t,s) r_s k_s' (do_s . v_s'),
//       and dr_t, dk_t likewise; no quotient by w anywhere (S is never
//       stepped backwards: S_{t-1} = (S_t - k_t^T v_t) / w_t loses every
//       digit as w -> 0), and every weight is a product of at most 16 w,
//       formed step by step. The products with S_p and G_p (x = do S_p^T,
//       y = v G_p^T), the scores m = do v^T and the sub-chunk updates
//       S_{p+1} = diag(prod w) S_p + (k B)^T v and G_{p-1} = diag(prod
//       w) G_p + (r A)^T do run on the tensor cores (mma.sync m16n8k16,
//       S_p, G_p and the decayed k, r as two bf16 parts, as the forward
//       splits them; v, do exact); the running S and G stay float32 in
//       registers in the accumulator layout. One thread per channel then
//       forms the pair sums over the sub-chunk's steps (a recurrence per
//       later step s, 120 pairs) in float32. The states entering the
//       sub-chunks are kept as two bf16 parts (55 KB); 106 KB of shared
//       memory a block, two blocks an SM;
//    e. du's per-(b, chunk) partials summed over b and chunk in order.
// 2. Sequential (float32 r, whose 2e-5 tolerance bf16 products cannot
//    meet; also `wkv6_bwd_previous` at every dtype, for timing): one block
//    per (b, h), 128 threads, no atomics:
//   - thread i < 64 holds row i of S and of G in registers, so dr_t, dk_t
//     and dw_t, which reduce over the columns, stay inside the thread;
//     thread 64 + j holds column j of G (the same recurrence, kept a second
//     time) and forms dv_t, which reduces over the rows, on its own;
//   - time is staged through shared memory 16 steps at a time (kT),
//     converted to float32 once, with each step's do_t . v_t and
//     sum_i u_i r_t[i] k_t[i] formed there by warp shuffles in a fixed
//     order;
//   - pass 1 steps S forward through the whole sequence and writes the
//     state entering every 16-step tile to float32 scratch (B, H, C, 64,
//     64), C = ceil(S / 16): 256 MB at the training shape, written and
//     read once. Pass 2 walks the tiles from the last; inside a tile, per
//     4-step sub-block from the last, each row thread restarts from the
//     tile's state, steps forward to the sub-block and keeps its 4 states
//     of its row in shared memory (4 x 64 x 68 floats a block, rows padded
//     against bank conflicts), then walks those 4 steps backwards. That
//     recomputes S 2.5 times a step on average, at no extra memory;
//   - du's per-(b, h) partials go to scratch and a second launch sums
//     them over b in order.
// The chunked design's S_c and G_end carry the chunked forward's clamp of
// log w at -60 (an effect below e^-60 of the state); its walk, like the
// sequential design, works on w itself (products of w, no clamp), so dw is
// the sequential recurrence's derivative.
// `ref.wkv6_bwd_chunked_plain` is the chunked design in plain PyTorch.
// Steps past S are identities; rows past K and columns past V are zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "wkv6_chunk.cuh"  // the chunked recurrence's kernels (wkv6c::)

namespace {

constexpr int kMax = 64;      // K and V at most
constexpr int kT = 16;        // steps staged per tile; a checkpoint per tile
constexpr int kSub = 4;       // steps of a sub-block whose states are kept
constexpr int kPad = kMax + 4;  // row stride of the kept states (floats)
constexpr int kThreads = 2 * kMax;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Smem {
  float r[kT][kMax], k[kT][kMax], w[kT][kMax], v[kT][kMax], o[kT][kMax];  // o: do
  float dov[kT];  // do_t . v_t
  float urk[kT];  // sum_i u_i r_t[i] k_t[i]
  float u[kMax];
  float hist[kSub][kMax][kPad];  // row i of S_{t-1} for a sub-block's steps
};

template <typename TR, typename TW>
struct Args {
  const TR* r;         // (B, S, H, K)
  const TR* k;         // (B, S, H, K)
  const TR* v;         // (B, S, H, V)
  const TW* w;         // (B, S, H, K)
  const TR* u;         // (H, K)
  const TR* dout;      // (B, S, H, V)
  const float* s0;     // (B, H, K, V) or null (zeros)
  const float* ds;     // (B, H, K, V) the last state's gradient, or null (zeros)
  TR* dr;              // (B, S, H, K)
  TR* dk;              // (B, S, H, K)
  TR* dv;              // (B, S, H, V)
  TW* dw;              // (B, S, H, K)
  float* ds0;          // (B, H, K, V) or null (not wanted)
  float* du_part;      // (B, H, K) scratch
  float* ckpt;         // (B, H, C, 64, 64) scratch: S entering each tile, [j][i]
  int S, H, K, V, C;
};

// Stage steps t0 .. t0 + n - 1 of (b, h) into shared memory as float32
// (zeros past S, K and V; w = 1 there), then each step's two dot products.
template <typename TR, typename TW>
__device__ void stage(const Args<TR, TW>& p, Smem& sm, int b, int h, int t0, int n) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kT * kMax; e += kThreads) {
    const int t = e / kMax, c = e - t * kMax;
    const bool live = t < n;
    const size_t rk = ((size_t)(b * p.S + t0 + t) * p.H + h) * p.K + c;
    const size_t rv = ((size_t)(b * p.S + t0 + t) * p.H + h) * p.V + c;
    const bool ck = live && c < p.K, cv = live && c < p.V;
    sm.r[t][c] = ck ? to_float(p.r[rk]) : 0.f;
    sm.k[t][c] = ck ? to_float(p.k[rk]) : 0.f;
    sm.w[t][c] = ck ? to_float(p.w[rk]) : 1.f;
    sm.v[t][c] = cv ? to_float(p.v[rv]) : 0.f;
    sm.o[t][c] = cv ? to_float(p.dout[rv]) : 0.f;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int t = warp; t < kT; t += kThreads / 32) {
    float a = sm.o[t][lane] * sm.v[t][lane] + sm.o[t][lane + 32] * sm.v[t][lane + 32];
    float c = sm.u[lane] * sm.r[t][lane] * sm.k[t][lane] +
              sm.u[lane + 32] * sm.r[t][lane + 32] * sm.k[t][lane + 32];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
      sm.dov[t] = a;
      sm.urk[t] = c;
    }
  }
  __syncthreads();
}

template <typename TR, typename TW>
__global__ void __launch_bounds__(kThreads, 2) wkv6_bwd_kernel(Args<TR, TW> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - (bh / p.H) * p.H;
  const int tid = threadIdx.x;
  const bool row = tid < kMax;
  const int i = row ? tid : tid - kMax;  // the row (row threads) or column (the others)
  if (tid < kMax) sm.u[tid] = tid < p.K ? to_float(p.u[(size_t)h * p.K + tid]) : 0.f;
  const size_t sbase = (size_t)bh * p.K * p.V;
  float* ck = p.ckpt + (size_t)bh * p.C * kMax * kMax;

  // Pass 1: S forward through time; the state entering each tile to scratch.
  float st[kMax];
#pragma unroll
  for (int j = 0; j < kMax; ++j)
    st[j] = (row && p.s0 != nullptr && i < p.K && j < p.V) ? p.s0[sbase + (size_t)i * p.V + j]
                                                            : 0.f;
  for (int c = 0; c < p.C; ++c) {
    if (row) {
      float* dst = ck + (size_t)c * kMax * kMax + i;
#pragma unroll
      for (int j = 0; j < kMax; ++j) dst[j * kMax] = st[j];
    }
    if (c + 1 == p.C) break;
    __syncthreads();  // the previous tile is fully consumed
    stage(p, sm, b, h, c * kT, kT);  // a tile before the last lies inside S
    if (row) {
      for (int q = 0; q < kT; ++q) {
        const float wi = sm.w[q][i], ki = sm.k[q][i];
        const float4* vq = reinterpret_cast<const float4*>(sm.v[q]);
#pragma unroll
        for (int j = 0; j < kMax / 4; ++j) {
          const float4 vv = vq[j];
          st[4 * j] = fmaf(wi, st[4 * j], ki * vv.x);
          st[4 * j + 1] = fmaf(wi, st[4 * j + 1], ki * vv.y);
          st[4 * j + 2] = fmaf(wi, st[4 * j + 2], ki * vv.z);
          st[4 * j + 3] = fmaf(wi, st[4 * j + 3], ki * vv.w);
        }
      }
    }
  }

  // Pass 2: G backward through time, tile by tile from the last.
  float g[kMax];
#pragma unroll
  for (int x = 0; x < kMax; ++x) {
    // Row thread: g[j] = G[i][j]; column thread: g[x] = G[x][i].
    const int gi = row ? i : x, gj = row ? x : i;
    g[x] = (p.ds != nullptr && gi < p.K && gj < p.V) ? p.ds[sbase + (size_t)gi * p.V + gj] : 0.f;
  }
  float du = 0.f;
  for (int c = p.C - 1; c >= 0; --c) {
    const int t0 = c * kT;
    const int n = min(kT, p.S - t0);
    __syncthreads();  // the previous tile is fully consumed
    stage(p, sm, b, h, t0, n);
    if (row) {
      const float* src = ck + (size_t)c * kMax * kMax + i;
      const float ui = sm.u[i];
      for (int m = (n - 1) / kSub; m >= 0; --m) {
        const int q0 = m * kSub, qe = min(q0 + kSub, n);
        // Restart from the tile's state and step to the sub-block, keeping
        // S_{t-1} for its steps.
#pragma unroll
        for (int j = 0; j < kMax; ++j) st[j] = src[j * kMax];
        for (int q = 0; q < qe; ++q) {
          if (q >= q0) {
            float4* hrow = reinterpret_cast<float4*>(sm.hist[q - q0][i]);
#pragma unroll
            for (int j = 0; j < kMax / 4; ++j)
              hrow[j] = make_float4(st[4 * j], st[4 * j + 1], st[4 * j + 2], st[4 * j + 3]);
          }
          if (q + 1 == qe) break;
          const float wi = sm.w[q][i], ki = sm.k[q][i];
          const float4* vq = reinterpret_cast<const float4*>(sm.v[q]);
#pragma unroll
          for (int j = 0; j < kMax / 4; ++j) {
            const float4 vv = vq[j];
            st[4 * j] = fmaf(wi, st[4 * j], ki * vv.x);
            st[4 * j + 1] = fmaf(wi, st[4 * j + 1], ki * vv.y);
            st[4 * j + 2] = fmaf(wi, st[4 * j + 2], ki * vv.z);
            st[4 * j + 3] = fmaf(wi, st[4 * j + 3], ki * vv.w);
          }
        }
        // The sub-block's steps backwards.
        for (int q = qe - 1; q >= q0; --q) {
          const float4* hrow = reinterpret_cast<const float4*>(sm.hist[q - q0][i]);
          const float4* vq = reinterpret_cast<const float4*>(sm.v[q]);
          const float4* oq = reinterpret_cast<const float4*>(sm.o[q]);
          const float ri = sm.r[q][i], ki = sm.k[q][i], wi = sm.w[q][i], dov = sm.dov[q];
          float a_r = 0.f, a_w = 0.f, a_k = 0.f;
#pragma unroll
          for (int j = 0; j < kMax / 4; ++j) {
            const float4 sp = hrow[j], vv = vq[j], oo = oq[j];
            a_r = fmaf(sp.x, oo.x, fmaf(sp.y, oo.y, fmaf(sp.z, oo.z, fmaf(sp.w, oo.w, a_r))));
            a_w = fmaf(g[4 * j], sp.x, fmaf(g[4 * j + 1], sp.y,
                  fmaf(g[4 * j + 2], sp.z, fmaf(g[4 * j + 3], sp.w, a_w))));
            a_k = fmaf(g[4 * j], vv.x, fmaf(g[4 * j + 1], vv.y,
                  fmaf(g[4 * j + 2], vv.z, fmaf(g[4 * j + 3], vv.w, a_k))));
            g[4 * j] = fmaf(wi, g[4 * j], ri * oo.x);
            g[4 * j + 1] = fmaf(wi, g[4 * j + 1], ri * oo.y);
            g[4 * j + 2] = fmaf(wi, g[4 * j + 2], ri * oo.z);
            g[4 * j + 3] = fmaf(wi, g[4 * j + 3], ri * oo.w);
          }
          if (i < p.K) {
            const size_t o = ((size_t)(b * p.S + t0 + q) * p.H + h) * p.K + i;
            store(p.dr + o, a_r + ui * ki * dov);
            store(p.dk + o, a_k + ui * ri * dov);
            store(p.dw + o, a_w);
          }
          du = fmaf(ri * ki, dov, du);
        }
      }
    } else {
      // Column thread: G's column i, and dv_t[i] = G_t[:, i] . k_t + urk_t do_t[i].
      for (int q = n - 1; q >= 0; --q) {
        const float4* kq = reinterpret_cast<const float4*>(sm.k[q]);
        const float4* rq = reinterpret_cast<const float4*>(sm.r[q]);
        const float4* wq = reinterpret_cast<const float4*>(sm.w[q]);
        const float oi = sm.o[q][i];
        float a_v = 0.f;
#pragma unroll
        for (int x = 0; x < kMax / 4; ++x) {
          const float4 kk = kq[x], rr = rq[x], ww = wq[x];
          a_v = fmaf(g[4 * x], kk.x, fmaf(g[4 * x + 1], kk.y,
                fmaf(g[4 * x + 2], kk.z, fmaf(g[4 * x + 3], kk.w, a_v))));
          g[4 * x] = fmaf(ww.x, g[4 * x], rr.x * oi);
          g[4 * x + 1] = fmaf(ww.y, g[4 * x + 1], rr.y * oi);
          g[4 * x + 2] = fmaf(ww.z, g[4 * x + 2], rr.z * oi);
          g[4 * x + 3] = fmaf(ww.w, g[4 * x + 3], rr.w * oi);
        }
        if (i < p.V)
          store(p.dv + ((size_t)(b * p.S + t0 + q) * p.H + h) * p.V + i,
                fmaf(sm.urk[q], oi, a_v));
      }
    }
  }
  if (row && i < p.K) {
    p.du_part[(size_t)bh * p.K + i] = du;
    if (p.ds0 != nullptr) {
#pragma unroll
      for (int j = 0; j < kMax; ++j)
        if (j < p.V) p.ds0[sbase + (size_t)i * p.V + j] = g[j];
    }
  }
}

// du[h, i] = sum over b of the per-(b, h) partials, in order of b.
template <typename TR>
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ part, TR* __restrict__ du, int B,
                                   int HK) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= HK) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[(size_t)b * HK + e];
  store(du + e, s);
}

template <typename TR, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* dout, const void* s0, const void* ds, void* dr, void* dk, void* dv,
           void* dw, void* du, void* ds0, void* du_part, void* ckpt, int B, int S, int H,
           int K, int V, cudaStream_t stream) {
  Args<TR, TW> p{static_cast<const TR*>(r), static_cast<const TR*>(k),
                 static_cast<const TR*>(v), static_cast<const TW*>(w),
                 static_cast<const TR*>(u), static_cast<const TR*>(dout),
                 static_cast<const float*>(s0), static_cast<const float*>(ds),
                 static_cast<TR*>(dr), static_cast<TR*>(dk), static_cast<TR*>(dv),
                 static_cast<TW*>(dw), static_cast<float*>(ds0), static_cast<float*>(du_part),
                 static_cast<float*>(ckpt), S, H, K, V, (S + kT - 1) / kT};
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<TR, TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_kernel<TR, TW><<<B * H, kThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int hk = H * K;
  wkv6_bwd_du_kernel<TR><<<(hk + 127) / 128, 128, 0, stream>>>(
      static_cast<const float*>(du_part), static_cast<TR*>(du), B, hk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The chunked design (bf16 r; see the header): the walk of one chunk.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
using wkv6c::ldsm_x4;
using wkv6c::ldsm_x4_trans;
using wkv6c::mma_bf16;
using wkv6c::smem_u32;
using wkv6c::split_pack;
constexpr int kChunkT = wkv6c::kT;        // 64 steps a chunk
constexpr int kSubT = 16;                 // steps a sub-chunk
constexpr int kNSub = kChunkT / kSubT;
constexpr int kWalkThreads = 256;         // 8 warps
constexpr int kRS = kMax + 8;             // bf16 row stride of the ldmatrix tiles
constexpr int kFS = kMax + 4;             // float row stride

struct WalkArgs {
  const bf16 *r, *k, *v, *dout, *u;  // (B, S, H, K|V), u (H, K)
  const void* w;                     // (B, S, H, K) float32 or bf16
  const float* s_in;                 // (B, H, C, K, V): S entering each chunk
  const float* g_in;                 // (B, H, C, K, V): G leaving chunk C - 1 - index
  bf16 *dr, *dk;                     // (B, S, H, K)
  void* dw;                          // (B, S, H, K) in w's dtype
  float* du_part;                    // (B, C, H, K)
  int S, H, K, V, C;
  int vec;                           // K, V multiples of 8, inputs 16-byte aligned
};

struct WalkSmem {
  bf16 sp[kNSub - 1][2][kMax][kRS];  // S entering sub-chunks 1 .. 3: hi, lo
  bf16 op[2][kMax][kRS];             // S_0 or G_p: hi, lo (one product at a time)
  float r[kSubT][kMax], k[kSubT][kMax], w[kSubT][kMax];  // the sub-chunk's steps
  bf16 v[kSubT][kRS], o[kSubT][kRS];                     // v and do: exact in bf16
  bf16 dec[2][kSubT][kRS];           // k or r times the decay to the sub-chunk's edge
  float x[kSubT][kFS], y[kSubT][kFS];  // x[t][i] = (S_p do_t^T)[i], y[t][i] = (G_p v_t^T)[i]
  float m[kSubT][kSubT + 1];         // m[t][s] = do_t . v_s
  float cpart[2][kMax];              // rowsum(S_p . G_p) over each half of the columns
  float dcy[kMax];                   // the sub-chunk's decay: the product of its w
  float u[kMax];
};

// Steps t0 .. t0 + 15 of (b, h): r, k, w as float32 (zeros past S and K,
// w = 1 there), v and do as bf16 (zeros past S and V). With p.vec in
// 16-byte loads.
template <typename TW>
__device__ void stage_sub(const WalkArgs& p, WalkSmem& sm, int b, int h, int t0) {
  const TW* w = static_cast<const TW*>(p.w);
  const int tid = threadIdx.x;
  if (p.vec) {
    // v and do: 2 x 16 x 8 chunks of 8; r and k: 2 x 128 of 8 (to float)
    const int e = tid & 127, t = e >> 3, c8 = (e & 7) * 8;
    const bool live = t0 + t < p.S;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const size_t rk = ((size_t)(b * p.S + t0 + t) * p.H + h) * p.K + c8;
    const size_t rv = ((size_t)(b * p.S + t0 + t) * p.H + h) * p.V + c8;
    const bf16* xk = tid < 128 ? p.r : p.k;
    const uint4 a = live && c8 < p.K ? __ldg(reinterpret_cast<const uint4*>(xk + rk)) : zero;
    const bf16* xv = tid < 128 ? p.v : p.dout;
    const uint4 vo = live && c8 < p.V ? __ldg(reinterpret_cast<const uint4*>(xv + rv)) : zero;
    constexpr int per = 16 / (int)sizeof(TW);
    const int tw = tid / (kMax / per), cw = (tid % (kMax / per)) * per;
    const bool wok = tw < kSubT && t0 + tw < p.S && cw < p.K;
    const uint4 wr = wok ? __ldg(reinterpret_cast<const uint4*>(
                               w + ((size_t)(b * p.S + t0 + tw) * p.H + h) * p.K + cw))
                         : zero;
    float* dst = tid < 128 ? &sm.r[t][c8] : &sm.k[t][c8];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h2[q]);
      dst[2 * q] = f.x;
      dst[2 * q + 1] = f.y;
    }
    *reinterpret_cast<uint4*>(tid < 128 ? &sm.v[t][c8] : &sm.o[t][c8]) = vo;
    if (tw < kSubT) {
      const TW* wv = reinterpret_cast<const TW*>(&wr);
#pragma unroll
      for (int q = 0; q < per; ++q) sm.w[tw][cw + q] = wok ? to_float(wv[q]) : 1.f;
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int e = tid; e < kSubT * kMax; e += kWalkThreads) {
      const int t = e / kMax, c = e - t * kMax;
      const bool live = t0 + t < p.S;
      const size_t rk = ((size_t)(b * p.S + t0 + t) * p.H + h) * p.K + c;
      const size_t rv = ((size_t)(b * p.S + t0 + t) * p.H + h) * p.V + c;
      const bool ck = live && c < p.K, cv = live && c < p.V;
      sm.r[t][c] = ck ? to_float(p.r[rk]) : 0.f;
      sm.k[t][c] = ck ? to_float(p.k[rk]) : 0.f;
      sm.w[t][c] = ck ? to_float(w[rk]) : 1.f;
      sm.v[t][c] = cv ? p.v[rv] : zero;
      sm.o[t][c] = cv ? p.dout[rv] : zero;
    }
  }
}

// A 64 x 64 state in the m16n8k16 accumulator layout of 8 warps: warp w
// holds rows 16 (w % 4) + g + 8 (e / 2) and columns 32 (w / 4) + 8 n +
// 2 (lane % 4) + e % 2 of acc[n][e] (g = lane / 4).
struct Frag {
  int row0, col0, g, q4;
  __device__ Frag(int tid) {
    const int warp = tid >> 5, lane = tid & 31;
    row0 = 16 * (warp & 3);
    col0 = 32 * (warp >> 2);
    g = lane >> 2;
    q4 = lane & 3;
  }
  __device__ int row(int e) const { return row0 + g + 8 * (e >> 1); }
  __device__ int col(int n, int e) const { return col0 + 8 * n + 2 * q4 + (e & 1); }
};

// st (a state, K x V) from global memory into the accumulator layout.
__device__ __forceinline__ void load_state(float (&st)[4][4], const float* src, const Frag& f,
                                           int K, int V) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = f.row(e), j = f.col(n, e);
      st[n][e] = (i < K && j < V) ? src[(size_t)i * V + j] : 0.f;
    }
}

// st as two bf16 parts (hi, lo) into dst[0], dst[1] ([row][col]).
__device__ __forceinline__ void store_split(bf16 (*dst)[kMax][kRS], const float (&st)[4][4],
                                            const Frag& f) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      uint32_t hi, lo;
      split_pack(st[n][2 * h2], st[n][2 * h2 + 1], hi, lo);
      const int i = f.row(2 * h2), j = f.col(n, 0);
      *reinterpret_cast<uint32_t*>(&dst[0][i][j]) = hi;
      *reinterpret_cast<uint32_t*>(&dst[1][i][j]) = lo;
    }
}

// st <- diag(dcy) st + dec^T src over the sub-chunk's 16 steps: dec (two
// bf16 parts, [t][i]) and src (bf16, [t][j]) on the tensor cores.
__device__ __forceinline__ void advance(float (&st)[4][4], const WalkSmem& sm,
                                        const bf16 (*src)[kRS], const Frag& f, int lane) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const float d0 = sm.dcy[f.row(0)], d1 = sm.dcy[f.row(2)];
    st[n][0] *= d0;
    st[n][1] *= d0;
    st[n][2] *= d1;
    st[n][3] *= d1;
  }
  const int xrow = (lane & 7) + ((lane >> 4) << 3), xcol = f.row0 + ((lane >> 3) & 1) * 8;
  const int vrow = (((lane >> 3) & 1) << 3) + (lane & 7), vcol = f.col0 + (lane >> 4) * 8;
  uint32_t ah[4], al[4], vf[2][4];
  ldsm_x4_trans(smem_u32(&sm.dec[0][xrow][xcol]), ah);
  ldsm_x4_trans(smem_u32(&sm.dec[1][xrow][xcol]), al);
#pragma unroll
  for (int n2 = 0; n2 < 2; ++n2) ldsm_x4_trans(smem_u32(&src[vrow][n2 * 16 + vcol]), vf[n2]);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_bf16(st[n], ah, vf[n / 2][2 * (n & 1)], vf[n / 2][2 * (n & 1) + 1]);
#pragma unroll
  for (int n = 0; n < 4; ++n) mma_bf16(st[n], al, vf[n / 2][2 * (n & 1)], vf[n / 2][2 * (n & 1) + 1]);
}

// out[t][i] (16 x 16 per warp, columns 16 nb ..) = sum_j a[t][j] B[i][j],
// B a 64 x 64 state in two bf16 parts ([i][j]), a bf16 [t][j]: on the
// tensor cores, warp-wide.
__device__ __forceinline__ void rows_times_state(float (*out)[kFS], const bf16 (*a)[kRS],
                                                 const bf16 (*bs)[kMax][kRS], int nb, int lane) {
  float acc[2][4] = {};
  const int krow = ((lane >> 4) << 3) + (lane & 7), kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kMax / 16; ++kk) {
    uint32_t af[4], bh[4], bl[4];
    ldsm_x4(smem_u32(&a[lane & 15][kk * 16 + (lane >> 4) * 8]), af);
    ldsm_x4(smem_u32(&bs[0][16 * nb + krow][kk * 16 + kcol]), bh);
    ldsm_x4(smem_u32(&bs[1][16 * nb + krow][kk * 16 + kcol]), bl);
#pragma unroll
    for (int n = 0; n < 2; ++n) mma_bf16(acc[n], af, bh[2 * n], bh[2 * n + 1]);
#pragma unroll
    for (int n = 0; n < 2; ++n) mma_bf16(acc[n], af, bl[2 * n], bl[2 * n + 1]);
  }
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[g + 8 * (e >> 1)][16 * nb + 8 * n + 2 * q4 + (e & 1)] = acc[n][e];
}

// One block per (chunk, h, b). Sub-chunks of 16 steps: S forwards (the
// state entering each kept as two bf16 parts), then G backwards from
// G_end; per sub-chunk p, with S_p the state entering it and G_p the
// gradient at its last step, every term of dr, dk and dw is a product of
// S_p or G_p with the sub-chunk's do or v (tensor cores), rowsum(S_p .
// G_p), or a sum over pairs of its steps weighted by products of its w,
// per channel (see the header and ref.wkv6_bwd_chunked_plain).
template <typename TW>
__global__ void __launch_bounds__(kWalkThreads, 2) wkv6_bwd_walk_kernel(WalkArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkSmem& sm = *reinterpret_cast<WalkSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Frag f(tid);
  const int t_base = c * kChunkT;
  const int n_sub = (min(kChunkT, p.S - t_base) + kSubT - 1) / kSubT;  // live sub-chunks
  if (tid < kMax) sm.u[tid] = tid < p.K ? to_float(p.u[(size_t)h * p.K + tid]) : 0.f;
  const size_t bh = (size_t)b * p.H + h;
  const size_t kv = (size_t)p.K * p.V;

  // S forwards: S_{p+1} = diag(prod w) S_p + (k . suffix products of w)^T v.
  float st[4][4];
  load_state(st, p.s_in + (bh * p.C + c) * kv, f, p.K, p.V);
  for (int q = 0; q + 1 < n_sub; ++q) {
    __syncthreads();  // the previous sub-chunk is consumed
    stage_sub<TW>(p, sm, b, h, t_base + q * kSubT);
    __syncthreads();
    if (tid < kMax) {
      float suf = 1.f;  // w after step t, multiplied
#pragma unroll
      for (int t = kSubT - 1; t >= 0; --t) {
        const float x = sm.k[t][tid] * suf;
        const bf16 hi = __float2bfloat16(x);
        sm.dec[0][t][tid] = hi;
        sm.dec[1][t][tid] = __float2bfloat16(x - __bfloat162float(hi));
        suf *= sm.w[t][tid];
      }
      sm.dcy[tid] = suf;
    }
    __syncthreads();
    advance(st, sm, sm.v, f, lane);
    store_split(sm.sp[q], st, f);
  }

  // G backwards, sub-chunk by sub-chunk from the last.
  float gst[4][4];
  load_state(gst, p.g_in + (bh * p.C + (p.C - 1 - c)) * kv, f, p.K, p.V);
  float du = 0.f;
  for (int q = n_sub - 1; q >= 0; --q) {
    const int t0 = t_base + q * kSubT;
    __syncthreads();
    stage_sub<TW>(p, sm, b, h, t0);
    if (q == 0) {  // S_0: the chunk's entering state, as two parts
      const float* s0 = p.s_in + (bh * p.C + c) * kv;
      for (int e = tid; e < kMax * kMax; e += kWalkThreads) {
        const int i = e / kMax, j = e % kMax;
        const float x = (i < p.K && j < p.V) ? s0[(size_t)i * p.V + j] : 0.f;
        const bf16 hi = __float2bfloat16(x);
        sm.op[0][i][j] = hi;
        sm.op[1][i][j] = __float2bfloat16(x - __bfloat162float(hi));
      }
    }
    __syncthreads();
    const bf16 (*sp)[kMax][kRS] = q == 0 ? sm.op : sm.sp[q - 1];
    if (warp < 4) {
      rows_times_state(sm.x, sm.o, sp, warp, lane);  // x = do S_p^T
    } else if (warp == 4) {  // m[t][s] = do_t . v_s
      float acc[2][4] = {};
      const int krow = ((lane >> 4) << 3) + (lane & 7), kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < kMax / 16; ++kk) {
        uint32_t af[4], bv[4];
        ldsm_x4(smem_u32(&sm.o[lane & 15][kk * 16 + (lane >> 4) * 8]), af);
        ldsm_x4(smem_u32(&sm.v[krow][kk * 16 + kcol]), bv);
#pragma unroll
        for (int n = 0; n < 2; ++n) mma_bf16(acc[n], af, bv[2 * n], bv[2 * n + 1]);
      }
      const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm.m[g + 8 * (e >> 1)][8 * n + 2 * q4 + (e & 1)] = acc[n][e];
    }
    {  // rowsum(S_p . G_p): this thread's two rows over its columns, then its row's four lanes
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = f.row(e), j = f.col(n, e);
          const float s = __bfloat162float(sp[0][i][j]) + __bfloat162float(sp[1][i][j]);
          part[e >> 1] = fmaf(s, gst[n][e], part[e >> 1]);
        }
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        part[r2] += __shfl_xor_sync(0xffffffffu, part[r2], 1);
        part[r2] += __shfl_xor_sync(0xffffffffu, part[r2], 2);
        if (f.q4 == 0) sm.cpart[warp >> 2][f.row(2 * r2)] = part[r2];
      }
    }
    __syncthreads();  // x, m, the row sums are done; op is free
    store_split(sm.op, gst, f);
    __syncthreads();
    if (warp < 4) rows_times_state(sm.y, sm.v, sm.op, warp, lane);  // y = v G_p^T
    __syncthreads();
    if (tid < kMax) {
      // Per channel i = tid: the weighted sums over the sub-chunk's steps.
      const int i = tid;
      const float ui = sm.u[i];
      const float cc = sm.cpart[0][i] + sm.cpart[1][i];
      float suf[kSubT], gam[kSubT], uu[kSubT];
      float acc = 1.f, gg = 0.f;
#pragma unroll
      for (int t = kSubT - 1; t >= 0; --t) {
        suf[t] = acc;   // product of w after t
        gam[t] = gg;    // sum over s > t of (w strictly between) r_s x_s
        gg = fmaf(sm.w[t][i], gg, sm.r[t][i] * sm.x[t][i]);
        acc *= sm.w[t][i];
        uu[t] = 0.f;
      }
      float pre = 1.f, beta = 0.f;
#pragma unroll
      for (int t = 0; t < kSubT; ++t) {
        const float rt = sm.r[t][i], kt = sm.k[t][i], wt = sm.w[t][i];
        const float xt = sm.x[t][i], yt = sm.y[t][i], mtt = sm.m[t][t];
        float qq = 1.f, ad = 0.f, ak = 0.f;
#pragma unroll
        for (int s = t + 1; s < kSubT; ++s) {
          const float qr = qq * sm.r[s][i];
          ad = fmaf(qr, uu[s], ad);
          ak = fmaf(qr, sm.m[s][t], ak);
          qq *= sm.w[s][i];
        }
        const int tg = t0 + t;
        if (tg < p.S && i < p.K) {
          const size_t o = ((size_t)(b * p.S + tg) * p.H + h) * p.K + i;
          p.dr[o] = __float2bfloat16(fmaf(pre, xt, uu[t]) + ui * kt * mtt);
          p.dk[o] = __float2bfloat16(fmaf(suf[t], yt, ak) + ui * rt * mtt);
          store(static_cast<TW*>(p.dw) + o,
                fmaf(pre * suf[t], cc, fmaf(suf[t], beta, fmaf(pre, gam[t], ad))));
        }
        du = fmaf(rt * kt, mtt, du);
        const float x = rt * pre;  // r_t times the w before t: its decay to the start
        const bf16 hi = __float2bfloat16(x);
        sm.dec[0][t][i] = hi;
        sm.dec[1][t][i] = __float2bfloat16(x - __bfloat162float(hi));
        beta = fmaf(wt, beta, kt * yt);
#pragma unroll
        for (int s = t + 1; s < kSubT; ++s) uu[s] = fmaf(wt, uu[s], kt * sm.m[s][t]);
        pre *= wt;
      }
      sm.dcy[i] = pre;
    }
    __syncthreads();
    // G_{p-1} = diag(prod w) G_p + (r . prefix products of w)^T do.
    advance(gst, sm, sm.o, f, lane);
  }
  if (tid < kMax && tid < p.K)
    p.du_part[((size_t)b * p.C + c) * p.H * p.K + (size_t)h * p.K + tid] = du;
}

// Scratch of the chunked design, in floats, each part 16-byte aligned.
struct ChunkScratch {
  size_t slots, decay, last, du;
  static size_t up4(size_t x) { return (x + 3) & ~(size_t)3; }
  ChunkScratch(int B, int S, int H, int K, int V) {
    const size_t C = (S + kChunkT - 1) / kChunkT;
    slots = up4((size_t)B * H * C * K * V);
    decay = up4((size_t)B * H * C * K);
    last = up4((size_t)B * H * K * V);
    du = up4((size_t)B * C * H * K);
  }
  size_t total() const { return 2 * (slots + decay + last) + du; }
};

template <typename TW>
int launch_chunked_bwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* dout, const void* s0, const void* ds, void* dr,
                       void* dk, void* dv, void* dw, void* du, void* ds0, float* scratch, int B,
                       int S, int H, int K, int V, cudaStream_t stream) {
  const ChunkScratch sz(B, S, H, K, V);
  float* slots_f = scratch;
  float* decay_f = slots_f + sz.slots;
  float* last_f = decay_f + sz.decay;
  float* slots_r = last_f + sz.last;
  float* decay_r = slots_r + sz.slots;
  float* last_r = decay_r + sz.decay;
  float* du_part = last_r + sz.last;
  const int C = (S + kChunkT - 1) / kChunkT;
  const auto* rb = static_cast<const bf16*>(r);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* ob = static_cast<const bf16*>(dout);
  const auto* ub = static_cast<const bf16*>(u);
  auto vec = [&](std::initializer_list<const void*> ptrs) {
    uintptr_t any = 0;
    for (const void* x : ptrs) any |= reinterpret_cast<uintptr_t>(x);
    return (int)(K % 8 == 0 && V % 8 == 0 && any % 16 == 0);
  };
  // S entering each chunk: the forward's summaries and carry.
  wkv6c::ChunkArgs f{rb, kb, vb, w, ub, static_cast<const float*>(s0), nullptr, last_f,
                     slots_f, decay_f, S, H, K, V, C, vec({r, k, v, w, slots_f})};
  int err = wkv6c::launch_chunked<TW>(f, B, stream, false);
  if (err) return err;
  // The recurrence of G, time reversed, with k, r, do in the places of r,
  // k, v: G leaving each chunk, d state0 as its last state, dv its output.
  wkv6c::ChunkArgs g{kb, rb, ob, w, ub, static_cast<const float*>(ds), static_cast<bf16*>(dv),
                     ds0 != nullptr ? static_cast<float*>(ds0) : last_r, slots_r, decay_r, S,
                     H, K, V, C, vec({k, r, dout, w, dv, slots_r})};
  err = wkv6c::launch_chunked<TW, true>(g, B, stream, true);
  if (err) return err;
  WalkArgs p{rb, kb, vb, ob, ub, w, slots_f, slots_r, static_cast<bf16*>(dr),
             static_cast<bf16*>(dk), dw, du_part, S, H, K, V, C, vec({r, k, v, w, dout})};
  err = (int)cudaFuncSetAttribute(wkv6_bwd_walk_kernel<TW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)sizeof(WalkSmem));
  if (err) return err;
  wkv6_bwd_walk_kernel<TW><<<dim3(C, H, B), kWalkThreads, sizeof(WalkSmem), stream>>>(p);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int hk = H * K;
  wkv6_bwd_du_kernel<bf16><<<(hk + 127) / 128, 128, 0, stream>>>(du_part, static_cast<bf16*>(du),
                                                                 B * C, hk);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch the caller allocates, in floats. Sequential design (float32 r,
// or `previous`): du_part B H K, ckpt B H C 64 64 with C = ceil(S / 16).
// Chunked design (bf16 r): the states entering and the gradients leaving
// each 64-step chunk, their decays, two last states and the du partials.
extern "C" long long wkv6_bwd_scratch_floats(int chunked, int B, int S, int H, int K, int V) {
  if (chunked) return (long long)ChunkScratch(B, S, H, K, V).total();
  const long long c = (S + kT - 1) / kT;
  return (long long)B * H * K + (long long)B * H * c * kMax * kMax;
}

namespace {

int run(int r_dtype, int w_dtype, bool previous, const void* r, const void* k, const void* v,
        const void* w, const void* u, const void* dout, const void* s0, const void* ds,
        void* dr, void* dk, void* dv, void* dw, void* du, void* ds0, void* scratch, int B,
        int S, int H, int K, int V, cudaStream_t st) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || V < 1 || K > kMax || V > kMax || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (w_dtype != 0 && w_dtype != r_dtype) return (int)cudaErrorInvalidValue;
  if (r_dtype == 1 && !previous) {
    float* sc = static_cast<float*>(scratch);
    return w_dtype == 0 ? launch_chunked_bwd<float>(r, k, v, w, u, dout, s0, ds, dr, dk, dv, dw,
                                                    du, ds0, sc, B, S, H, K, V, st)
                        : launch_chunked_bwd<bf16>(r, k, v, w, u, dout, s0, ds, dr, dk, dv, dw,
                                                   du, ds0, sc, B, S, H, K, V, st);
  }
  float* du_part = static_cast<float*>(scratch);
  float* ckpt = du_part + (size_t)B * H * K;
  if (r_dtype == 0)
    return launch<float, float>(r, k, v, w, u, dout, s0, ds, dr, dk, dv, dw, du, ds0, du_part,
                                ckpt, B, S, H, K, V, st);
  if (r_dtype == 1 && w_dtype == 0)
    return launch<__nv_bfloat16, float>(r, k, v, w, u, dout, s0, ds, dr, dk, dv, dw, du, ds0,
                                        du_part, ckpt, B, S, H, K, V, st);
  if (r_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, u, dout, s0, ds, dr, dk, dv, dw,
                                                du, ds0, du_part, ckpt, B, S, H, K, V, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// r_dtype (r, k, v, u, dout, dr, dk, dv, du) and w_dtype (w, dw): 0 =
// float32, 1 = bfloat16, w in float32 or r's dtype. s0, ds and ds0 may be
// null. The design is a rule by dtype: bf16 r the chunked one, float32 r
// the sequential one. Returns the first CUDA error (0 on success).
extern "C" int wkv6_bwd(int r_dtype, int w_dtype, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* dout, const void* s0,
                        const void* ds, void* dr, void* dk, void* dv, void* dw, void* du,
                        void* ds0, void* scratch, int B, int S, int H, int K, int V,
                        void* stream) {
  return run(r_dtype, w_dtype, false, r, k, v, w, u, dout, s0, ds, dr, dk, dv, dw, du, ds0,
             scratch, B, S, H, K, V, static_cast<cudaStream_t>(stream));
}

// The sequential design at every dtype, for side-by-side timing only; the
// same arguments, with the sequential design's scratch.
extern "C" int wkv6_bwd_previous(int r_dtype, int w_dtype, const void* r, const void* k,
                                 const void* v, const void* w, const void* u, const void* dout,
                                 const void* s0, const void* ds, void* dr, void* dk, void* dv,
                                 void* dw, void* du, void* ds0, void* scratch, int B, int S,
                                 int H, int K, int V, void* stream) {
  return run(r_dtype, w_dtype, true, r, k, v, w, u, dout, s0, ds, dr, dk, dv, dw, du, ds0,
             scratch, B, S, H, K, V, static_cast<cudaStream_t>(stream));
}
