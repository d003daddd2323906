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
// 0.19 ms at the FP32 rate. The kernel adds the states it must recompute.
//
// Design (one block per (b, h), 128 threads, no atomics: two calls agree
// bit for bit):
//   - thread i < 64 holds row i of S and of G in registers, so dr_t, dk_t
//     and dw_t, which reduce over the columns, stay inside the thread;
//     thread 64 + j holds column j of G (the same recurrence, kept a second
//     time) and forms dv_t, which reduces over the rows, on its own;
//   - time is staged through shared memory 16 steps at a time (kT),
//     converted to float32 once, with each step's do_t . v_t and
//     sum_i u_i r_t[i] k_t[i] formed there by warp shuffles in a fixed
//     order;
//   - the backward needs S_{t-1} in reverse time, and S is never stepped
//     backwards (S_{t-1} = (S_t - k_t^T v_t) / w_t blows up as w -> 0).
//     Pass 1 steps S forward through the whole sequence and writes the
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
// Steps past S are not walked; rows past K and columns past V are zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// Scratch the caller allocates: du_part B H K floats, ckpt B H C 64 64
// floats with C = ceil(S / 16).
extern "C" long long wkv6_bwd_scratch_floats(int B, int S, int H, int K) {
  const long long c = (S + kT - 1) / kT;
  return (long long)B * H * K + (long long)B * H * c * kMax * kMax;
}

// r_dtype (r, k, v, u, dout, dr, dk, dv, du) and w_dtype (w, dw): 0 =
// float32, 1 = bfloat16, w in float32 or r's dtype. s0, ds and ds0 may be
// null. Returns the first CUDA error (0 on success).
extern "C" int wkv6_bwd(int r_dtype, int w_dtype, const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* dout, const void* s0,
                        const void* ds, void* dr, void* dk, void* dv, void* dw, void* du,
                        void* ds0, void* scratch, int B, int S, int H, int K, int V,
                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || K < 1 || V < 1 || K > kMax || V > kMax)
    return (int)cudaErrorInvalidValue;
  if (w_dtype != 0 && w_dtype != r_dtype) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
