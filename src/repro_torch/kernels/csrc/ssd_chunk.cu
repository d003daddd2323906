// Mamba-2 state-space duality (SSD), chunked prefill, for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package has no Mamba-2 block. Added for
// granite-4.0-h-micro, whose 36 Mamba-2 layers a prompt runs through
// (models/mamba2.py). It takes the mixer from the input projection's xBC
// columns on: the causal depthwise conv of width 4 with its bias and SiLU,
// which gives x (H heads of P), B and C (N each, one group shared by the
// heads), then per batch row b and head h, with a P x N float32 state S
// from zero, dt = softplus(dt_raw + dt_bias), A = -exp(a_log):
//     S_t = exp(dt_t A) S_{t-1} + dt_t x_t (x) B_t
//     y_t = S_t C_t + D x_t
// xBC, dt, the conv's weights and the per-head parameters in one dtype
// (float32 or bfloat16), xBC and dt read through row strides (views of
// the input projection need no copy); y comes out contiguous in that
// dtype, the last state in float32.
//
// What bounds it on the H100: at the served 8 x 512 prompt shape (H 64,
// P 64, N 128) the function moves about 87 MB (xBC and dt read, y
// written), 26 us at 3.35 TB/s, and its chunked form takes about 11 GFLOP,
// 0.16 ms at the float32 rate of 67 TFLOP/s. This design computes in
// float32 on the CUDA cores, so the operations bound it; the tensor cores
// are later work (ROADMAP §D.10).
//
// Design: the time axis is cut into chunks of kL = 64 steps that run in
// parallel. With a_t = dt_t A and L_t its running sum inside the chunk
// (restarted at each chunk, so no exponent is a difference of two long
// sums), four launches in this order, no atomics:
//   0. `ssd_chunk_cb_kernel`, one block per (chunk, b): C_t . B_s for s <= t,
//      which every head of the row shares (one group), into float32 scratch;
//   a. `ssd_chunk_state_kernel`, one block per (chunk, h, b): the chunk's
//      state contribution dS_c = sum_s (e^(L_end - L_s) dt_s x_s) (x) B_s
//      and its decay e^(L_end), into float32 scratch;
//   b. `ssd_chunk_carry_kernel`, one thread per four state elements: the
//      short sequential pass S_{c+1} = decay_c S_c + dS_c, which overwrites
//      each dS_c with S_c (the state entering chunk c) and writes the last
//      state;
//   c. `ssd_chunk_out_kernel`, one block per (chunk, h, b), 256 threads in
//      4 x 4 register tiles: M_ts = (C_t . B_s) e^(L_t - L_s) dt_s for
//      s <= t from (0), then y_t = e^(L_t) C_t . S_c + sum_s M_ts x_s + D x_t.
// Each kernel stages the operands it needs into shared memory as float32
// from xBC (100 KB in c, two blocks an SM), taking the conv and SiLU on the
// way: a staged element reads its 4 input rows (the rows before the chunk
// included) and the conv's weights, by 16-byte loads where the rows allow
// (the model's views do), every load of a vector issued before its first
// use; so the conv's output is never written to memory. A ragged last
// chunk is padded with zeros (dt = 0 adds nothing), so S need not be a
// multiple of kL, and the result does not depend on kL beyond rounding.
// Sums run in a fixed order: two calls agree bit for bit.
// `ref.ssd_chunk_plain` repeats this arithmetic in plain PyTorch;
// `ref.ssd_ref` is the step-by-step oracle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;        // steps per chunk
constexpr int kMaxP = 64;     // head width at most
constexpr int kMaxN = 128;    // state width at most
constexpr int kThreads = 256;
constexpr int kW = 4;         // the conv's width
// Rows of the transposed operands in shared memory (C, B, then S_c) are kRow
// floats apart: 16-byte aligned for float4 reads, and written column by
// column from coalesced loads with 4-way bank conflicts, not 32-way.
constexpr int kRow = kL + 4;
static_assert(kRow >= kMaxP + 4, "S_c's rows share the B region");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// torch.nn.functional.softplus (beta 1, threshold 20).
__device__ __forceinline__ float softplus(float v) { return v > 20.f ? v : log1pf(expf(v)); }

struct Args {
  const void* xbc;  // (B, S, Cc): x (H P), B (N), C (N) before the conv; strides xb, xs
  const void* conv_w;  // (kW, Cc)
  const void* conv_b;  // (Cc,)
  const void* dt;   // (B, S, H), strides db, ds
  const void* dt_bias;  // (H,)
  const void* a_log;    // (H,)
  const void* d;    // (H,)
  void* y;          // (B, S, H, P) contiguous
  float* last;      // (B, H, P, N) or null
  float* slots;     // (B, H, C, P, N)
  float* decay;     // (B, H, C)
  float* cbt;       // (B, C, kL, kL): C_t . B_s of each chunk
  long long xb, xs, db, ds;
  int S, H, P, N, C, Cc;
  bool vec;  // xbc's rows and the conv's weights 16-byte aligned: 16-byte loads
};

// The conv in front of an operand: weights and bias at the operand's first
// channel (rows `wstride` apart), and the operand's first token t0 (rows
// before the sequence's start are zeros).
template <typename T>
struct Conv {
  const T* w;
  const T* bias;
  int wstride;
  int t0;
};

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// Rows [0, n) and columns [0, width) of a row-major operand (rows
// `rstride` elements apart) into shared memory as float32, element (r, c)
// at dst[r * drow + c * dcol] times rscale[r] (when given), zeros past n
// and width. With a conv (cv.w set) element (r, c) is the operand after
// the causal depthwise conv of width kW and SiLU: silu(sum_k w[k][c]
// src[r - kW + 1 + k][c] + bias[c]), its taps summed in k's order.
template <typename T, int kCols, int kRows>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long rstride, int n,
                                      int width, float* dst, int drow, int dcol,
                                      const float* rscale, Conv<T> cv) {
  constexpr int kPer = kRows * kCols / kThreads;
  static_assert(kPer * kThreads == kRows * kCols, "whole passes of the block");
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kCols, c = e - r * kCols;
    float v = 0.f;
    if (r < n && c < width) {
      if (cv.w == nullptr) {
        v = to_float(src[r * rstride + c]);
      } else {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kW; ++k) {
          const int row = r - (kW - 1) + k;
          if (cv.t0 + row >= 0)
            acc = fmaf(to_float(src[row * rstride + c]), to_float(cv.w[k * cv.wstride + c]), acc);
        }
        v = silu(acc + to_float(cv.bias[c]));
      }
    }
    dst[r * drow + c * dcol] = rscale != nullptr ? v * rscale[r] : v;
  }
}

// As `stage`, from 16-byte loads (rows 16-byte aligned, `width` whole
// vectors). kTransposed: dst's columns are its rows (dcol apart, drow 1):
// pairs of neighbouring threads take a 32-byte sector of a row, and the
// pairs neighbouring rows, so that their scattered stores fall in
// different banks; else neighbouring threads take neighbouring vectors
// of a row and store them as float4s.
template <typename T, int kCols, int kRows, bool kTransposed>
__device__ __forceinline__ void stage_vec(const T* __restrict__ src, long long rstride, int n,
                                          int width, float* dst, int drow, int dcol,
                                          const float* rscale, Conv<T> cv) {
  constexpr int kE = 16 / (int)sizeof(T);
  constexpr int kVecs = kCols / kE;  // vectors a row
  constexpr int kPer = kRows * kVecs / kThreads;
  static_assert(kPer * kThreads == kRows * kVecs, "whole passes of the block");
  static_assert(kVecs % 2 == 0, "sectors of two vectors");
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 v[kPer];
  if (cv.w == nullptr) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = kTransposed ? (e >> 1) % kRows : e / kVecs;
      const int c = (kTransposed ? (e >> 1) / kRows * 2 + (e & 1) : e % kVecs) * kE;
      v[i] = (r < n && c < width) ? *reinterpret_cast<const uint4*>(src + r * rstride + c) : zero;
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = kTransposed ? (e >> 1) % kRows : e / kVecs;
    const int c = (kTransposed ? (e >> 1) / kRows * 2 + (e & 1) : e % kVecs) * kE;
    const float sc = rscale != nullptr ? rscale[r] : 1.f;
    float f[kE];
    if (cv.w == nullptr) {
      const T* t = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
      for (int j = 0; j < kE; ++j) f[j] = to_float(t[j]);
    } else {
      // The conv's kW input rows, weights and bias, all loaded first.
      const bool live = r < n && c < width;
      uint4 xv[kW], wv[kW];
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        const int row = r - (kW - 1) + k;
        xv[k] = live && cv.t0 + row >= 0
                    ? *reinterpret_cast<const uint4*>(src + row * rstride + c) : zero;
        wv[k] = live ? *reinterpret_cast<const uint4*>(cv.w + k * cv.wstride + c) : zero;
      }
      const uint4 bv = live ? *reinterpret_cast<const uint4*>(cv.bias + c) : zero;
      const T* bt = reinterpret_cast<const T*>(&bv);
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < kW; ++k)
          acc = fmaf(to_float(reinterpret_cast<const T*>(&xv[k])[j]),
                     to_float(reinterpret_cast<const T*>(&wv[k])[j]), acc);
        f[j] = live ? silu(acc + to_float(bt[j])) : 0.f;
      }
    }
    if (rscale != nullptr) {
#pragma unroll
      for (int j = 0; j < kE; ++j) f[j] *= sc;
    }
    if constexpr (kTransposed) {
#pragma unroll
      for (int j = 0; j < kE; ++j) dst[r + (c + j) * dcol] = f[j];
    } else {
#pragma unroll
      for (int j = 0; j < kE; j += 4)
        *reinterpret_cast<float4*>(&dst[r * drow + c + j]) =
            make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
    }
  }
}

// Operand `off` (its first channel in xbc) of row bi's chunk from token t0,
// with its conv.
template <typename T>
struct Operand {
  const T* src;
  Conv<T> cv;
};
template <typename T>
__device__ __forceinline__ Operand<T> operand(const Args& a, int bi, int t0, int off) {
  const T* w = static_cast<const T*>(a.conv_w) + off;
  return {static_cast<const T*>(a.xbc) + bi * a.xb + (long long)t0 * a.xs + off,
          {w, static_cast<const T*>(a.conv_b) + off, a.Cc, t0}};
}

// One operand of the chunk into shared memory (see `stage`), by 16-byte
// loads where a.vec allows.
template <typename T, int kCols, bool kTransposed>
__device__ __forceinline__ void stage_operand(const Args& a, Operand<T> op, int n, int width,
                                              float* dst, int drow, int dcol,
                                              const float* rscale) {
  if (a.vec)
    stage_vec<T, kCols, kL, kTransposed>(op.src, a.xs, n, width, dst, drow, dcol, rscale, op.cv);
  else
    stage<T, kCols, kL>(op.src, a.xs, n, width, dst, drow, dcol, rscale, op.cv);
}

// The chunk's step sizes and running sums of dt A (thread 0, in order).
template <typename T>
__device__ __forceinline__ void chunk_steps(const Args& a, int bi, int h, int t0, int n,
                                            float* dts, float* lam) {
  const T* dt = static_cast<const T*>(a.dt);
  for (int i = threadIdx.x; i < kL; i += blockDim.x) {
    dts[i] = i < n ? softplus(to_float(dt[bi * a.db + (long long)(t0 + i) * a.ds + h]) +
                              to_float(static_cast<const T*>(a.dt_bias)[h]))
                   : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float rate = -expf(to_float(static_cast<const T*>(a.a_log)[h]));
    float run = 0.f;
    for (int i = 0; i < kL; ++i) {
      run += dts[i] * rate;
      lam[i] = run;
    }
  }
  __syncthreads();
}

// C_t . B_s for s <= t of chunk blockIdx.x of row blockIdx.y (0 above the
// diagonal), row-major [t][s]: every head of the row shares it.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_cb_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;               // [kMaxN][kRow]: C transposed
  float* bt = ct + kMaxN * kRow;  // [kMaxN][kRow]: B transposed
  const int ci = blockIdx.x, bi = blockIdx.y;
  const int t0 = ci * kL;
  const int n = min(kL, a.S - t0);
  stage_operand<T, kMaxN, true>(a, operand<T>(a, bi, t0, a.H * a.P + a.N), n, a.N, ct, 1, kRow,
                                nullptr);
  stage_operand<T, kMaxN, true>(a, operand<T>(a, bi, t0, a.H * a.P), n, a.N, bt, 1, kRow, nullptr);
  __syncthreads();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = ty * 4, s0 = tx * 4;  // query steps t, key steps s
  float m[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) m[i][q] = 0.f;
  if (s0 <= r0 + 3) {
    for (int j = 0; j < a.N; ++j) {
      const float4 cv = *reinterpret_cast<const float4*>(&ct[j * kRow + r0]);
      const float4 bv = *reinterpret_cast<const float4*>(&bt[j * kRow + s0]);
      const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) m[i][q] = fmaf(cr[i], br[q], m[i][q]);
    }
  }
  float* out = a.cbt + ((long long)bi * a.C + ci) * kL * kL;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + i;
    *reinterpret_cast<float4*>(&out[t * kL + s0]) =
        make_float4(s0 <= t ? m[i][0] : 0.f, s0 + 1 <= t ? m[i][1] : 0.f,
                    s0 + 2 <= t ? m[i][2] : 0.f, s0 + 3 <= t ? m[i][3] : 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* xw = smem;                 // [kL][kMaxP]: e^(L_end - L_s) dt_s x_s
  float* bs = xw + kL * kMaxP;      // [kL][kMaxN]
  float* dts = bs + kL * kMaxN;     // [kL]
  float* lam = dts + kL;            // [kL]
  float* ws = lam + kL;             // [kL]: e^(L_end - L_s) dt_s
  const int ci = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int t0 = ci * kL;
  const int n = min(kL, a.S - t0);
  chunk_steps<T>(a, bi, h, t0, n, dts, lam);
  const float lend = lam[kL - 1];
  for (int i = threadIdx.x; i < kL; i += kThreads) ws[i] = expf(lend - lam[i]) * dts[i];
  __syncthreads();
  stage_operand<T, kMaxP, false>(a, operand<T>(a, bi, t0, h * a.P), n, a.P, xw, kMaxP, 1, ws);
  stage_operand<T, kMaxN, false>(a, operand<T>(a, bi, t0, a.H * a.P), n, a.N, bs, kMaxN, 1,
                                 nullptr);
  __syncthreads();
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int p0 = ty * 4, n0 = tx * 8;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < n; ++s) {
    const float4 xv = *reinterpret_cast<const float4*>(&xw[s * kMaxP + p0]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[s * kMaxN + n0]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[s * kMaxN + n0 + 4]);
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
    const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xr[i], br[j], acc[i][j]);
  }
  const long long bh = (long long)bi * a.H + h;
  float* out = a.slots + (bh * a.C + ci) * a.P * a.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (p0 + i >= a.P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (n0 + j < a.N) out[(long long)(p0 + i) * a.N + n0 + j] = acc[i][j];
  }
  if (threadIdx.x == 0) a.decay[bh * a.C + ci] = expf(lend);
}

__device__ __forceinline__ float4 fma4(float d, float4 s, float4 x) {
  return make_float4(fmaf(d, s.x, x.x), fmaf(d, s.y, x.y), fmaf(d, s.z, x.z), fmaf(d, s.w, x.w));
}

// One thread per four state elements: the chunks' carry, in chunk order,
// kCarry chunks' contributions loaded before the first is used.
constexpr int kCarry = 4;
__global__ void ssd_chunk_carry_kernel(Args a) {
  const long long pn4 = (long long)a.P * a.N / 4;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bh = blockIdx.y;  // b * H + h
  if (e >= pn4) return;
  float4* slot = reinterpret_cast<float4*>(a.slots) + bh * a.C * pn4 + e;
  const float* decay = a.decay + bh * a.C;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < a.C; c0 += kCarry) {
    float4 ds[kCarry];
    float dc[kCarry];
#pragma unroll
    for (int i = 0; i < kCarry; ++i) {
      if (c0 + i < a.C) {
        ds[i] = slot[(c0 + i) * pn4];
        dc[i] = decay[c0 + i];
      }
    }
#pragma unroll
    for (int i = 0; i < kCarry; ++i) {
      if (c0 + i < a.C) {
        slot[(c0 + i) * pn4] = st;  // the state entering chunk c0 + i
        st = fma4(dc[i], st, ds[i]);
      }
    }
  }
  if (a.last != nullptr) reinterpret_cast<float4*>(a.last)[bh * pn4 + e] = st;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_out_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                 // [kMaxN][kRow]: C transposed
  float* st = ct + kMaxN * kRow;    // [kMaxN][kRow]: S_c transposed
  float* xs = st + kMaxN * kRow;    // [kL][kMaxP]
  float* mt = xs + kL * kMaxP;      // [kL (s)][kL (t)]
  float* dts = mt + kL * kL;        // [kL]
  float* lam = dts + kL;            // [kL]
  const int ci = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int t0 = ci * kL;
  const int n = min(kL, a.S - t0);
  chunk_steps<T>(a, bi, h, t0, n, dts, lam);
  const long long bh = (long long)bi * a.H + h;
  const float* sc = a.slots + (bh * a.C + ci) * a.P * a.N;  // S entering this chunk
  stage_operand<T, kMaxN, true>(a, operand<T>(a, bi, t0, a.H * a.P + a.N), n, a.N, ct, 1, kRow,
                                nullptr);
  stage_operand<T, kMaxP, false>(a, operand<T>(a, bi, t0, h * a.P), n, a.P, xs, kMaxP, 1,
                                 nullptr);
  stage_vec<float, kMaxN, kMaxP, true>(sc, a.N, a.P, a.N, st, 1, kRow, nullptr,
                                       Conv<float>{nullptr, nullptr, 0, 0});

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int r0 = ty * 4;  // query steps t
  {
    // M_ts = (C_t . B_s) e^(L_t - L_s) dt_s from the row's shared C B^T,
    // stored transposed [s][t] for the product with x.
    const int s0 = tx * 4;  // key steps s
    const float* cbr = a.cbt + ((long long)bi * a.C + ci) * kL * kL;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + i;
      const float4 v = *reinterpret_cast<const float4*>(&cbr[t * kL + s0]);
      const float m[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + q;
        mt[s * kL + t] = s <= t ? m[q] * expf(lam[t] - lam[s]) * dts[s] : 0.f;
      }
    }
  }
  __syncthreads();

  const int p0 = tx * 4;
  float intra[4][4], inter[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) intra[i][q] = inter[i][q] = 0.f;
  const int s_end = min(r0 + 4, kL);
  for (int s = 0; s < s_end; ++s) {
    const float4 mv = *reinterpret_cast<const float4*>(&mt[s * kL + r0]);
    const float4 xv = *reinterpret_cast<const float4*>(&xs[s * kMaxP + p0]);
    const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
    const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) intra[i][q] = fmaf(mr[i], xr[q], intra[i][q]);
  }
  for (int j = 0; j < a.N; ++j) {
    const float4 cv = *reinterpret_cast<const float4*>(&ct[j * kRow + r0]);
    const float4 sv = *reinterpret_cast<const float4*>(&st[j * kRow + p0]);
    const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
    const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) inter[i][q] = fmaf(cr[i], sr[q], inter[i][q]);
  }
  const float dskip = to_float(static_cast<const T*>(a.d)[h]);
  T* y = static_cast<T*>(a.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + i;
    if (t >= n) continue;
    const float decay_in = expf(lam[t]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + q;
      if (p >= a.P) continue;
      const float v = fmaf(decay_in, inter[i][q], intra[i][q]) + dskip * xs[t * kMaxP + p];
      store(y + (((long long)bi * a.S + t0 + t) * a.H + h) * a.P + p, v);
    }
  }
}

constexpr size_t kStateSmem = sizeof(float) * (kL * kMaxP + kL * kMaxN + 3 * kL);
constexpr size_t kCbSmem = sizeof(float) * 2 * kMaxN * kRow;
constexpr size_t kOutSmem =
    sizeof(float) * (2 * kMaxN * kRow + kL * kMaxP + kL * kL + 2 * kL);

template <typename T>
int launch(Args a, int B, cudaStream_t st) {
  static bool configured = false;  // per instantiation; set before the first launch
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(ssd_chunk_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kStateSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_cb_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kCbSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_out_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kOutSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  ssd_chunk_cb_kernel<T><<<dim3(a.C, B), kThreads, kCbSmem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.C, a.H, B);
  ssd_chunk_state_kernel<T><<<grid, kThreads, kStateSmem, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long pn4 = (long long)a.P * a.N / 4;
  const dim3 cgrid((unsigned)((pn4 + 255) / 256), (unsigned)(B * a.H));
  ssd_chunk_carry_kernel<<<cgrid, 256, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_out_kernel<T><<<grid, kThreads, kOutSmem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 for xbc, conv_w, conv_b, dt, dt_bias,
// a_log, d and y. xbc (B, S, H P + 2 N) and dt (B, S, H) with strides in
// elements (batch, then token), their last dims contiguous; conv_w (4, H P
// + 2 N) and conv_b contiguous. last may be null; slots, cbt and last
// 16-byte aligned. slots holds B H C P N floats, decay B H C and cbt B C 64
// 64, C = ceil(S / 64). P <= 64, N a multiple of 4 up to 128. Returns the
// first failing launch's cudaError (0 on success).
extern "C" int ssd_chunk_fwd(int dtype, const void* xbc, const void* conv_w, const void* conv_b,
                             const void* dt, const void* dt_bias, const void* a_log,
                             const void* d, void* y, void* last, void* slots, void* decay,
                             void* cbt, long long xb, long long xs, long long db, long long ds,
                             int B, int S, int H, int P, int N, void* stream) {
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 4 || N > kMaxN || N % 4 != 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int Cc = H * P + 2 * N;
  Args a{xbc, conv_w, conv_b, dt, dt_bias, a_log, d, y, static_cast<float*>(last),
         static_cast<float*>(slots), static_cast<float*>(decay), static_cast<float*>(cbt), xb,
         xs, db, ds, S, H, P, N, (S + kL - 1) / kL, Cc, false};
  const int e = dtype == 1 ? 8 : 4;  // elements a 16-byte vector
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(xbc) | reinterpret_cast<uintptr_t>(conv_w) |
                         reinterpret_cast<uintptr_t>(conv_b);
  a.vec = ptrs % 16 == 0 && P % e == 0 && N % e == 0 && xb % e == 0 && xs % e == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}
