// The backward of the RG-LRU linear recurrence (RecurrentGemma / Griffin)
// for Hopper, sm_90a.
//
// The gradient of the Pallas TPU kernel `rglru_scan` in
// src/repro/kernels/rglru.py (pallas_call at line 94); in the reference
// it is XLA autodiff of src/repro/models/recurrent.py::rglru_prefill
// (line 68), whose scan oracle is src/repro/kernels/ref.py::rglru_ref
// (line 83). The forward is `h_t = a_t h_{t-1} + b_t`, h_0 = h0 (zeros
// when absent). Per (batch b, channel d), in float32, walking time from
// the last step to the first, with g_t the gradient of h_t:
//     g_t  = dh_t + a_{t+1} g_{t+1}    (seeded by the last h's gradient)
//     db_t = g_t,   da_t = g_t h_{t-1},   dh0 = a_1 g_1.
// h_{t-1} is the forward's saved output (exact in training, where the
// model passes float32 a and b; rounded to bf16 for bf16 inputs). a, h, dh
// in one dtype (float32 or bfloat16), da and db written in it; dh_last,
// h0 and dh0 are float32. `ref.rglru_bwd_plain` is the same recurrence in
// plain PyTorch.
//
// What bounds it on the H100: bytes. a, h and dh are read once and da,
// db written once, with two multiplies and an add per element: at
// recurrentgemma-9b's training shape (B = 1, S = 4096, D = 4096, float32)
// that is 336 MB, 0.100 ms at 3.35 TB/s. Two routes, picked by shape
// alone by the same rule as the forward's (kernels/rglru.py,
// `uses_chunked`):
//
// Streaming (`rglru_bwd_kernel`): the forward's streaming design run
// backwards: one thread per (b, channel), channels tiled 128 to a block so
// each step's loads and stores are contiguous across a warp, the reverse
// time loop unrolled 8 steps deep with every load of a group issued
// before its first use. Each product and sum is rounded on its own (no
// fused multiply-add), as the plain version's are, so float32 results are
// its bit for bit. At the training shape that is 32 blocks on 132 SMs,
// and it read at about 0.33 TB/s (1.0243 ms on an H100 80GB HBM3 at
// 700 W).
//
// Chunked (`summary_kernel`, rglru_chunk.cuh's `carry_kernel`,
// `finish_kernel`): the carry c_t = a_{t+1} g_{t+1} (the gradient h_t
// receives from step t + 1) obeys c_{t-1} = a_t (dh_t + c_t), a linear
// recurrence walked from t = S-1 down, so the forward's chunked scan
// serves with time reversed. Walk chunk k covers steps S-1-kL down to
// S-(k+1)L (the last, ragged, down to 0). Phase 1 reads a and dh of every
// walk chunk but the last and writes P (its decays' product, in walk
// order) and E (its outgoing carry from zero); phase 2 gives each chunk
// its incoming carry, seeded by dh_last; phase 3 re-walks each chunk,
// reads a, dh and h_{t-1} (the previous step's h, or h0 at t = 0) and
// writes db, da, and at t = 0 dh0. Bytes are 7/5 of the single pass
// (0.140 ms at the training shape) for 32 x the blocks.
// `ref.rglru_bwd_chunked_plain` repeats its association bit for bit. No
// atomics and a fixed plan per shape: two calls agree bit for bit.

#include "rglru_chunk.cuh"

namespace {

using namespace rglru;

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_bwd_kernel(
    const T* __restrict__ a,            // (B, S, D)
    const T* __restrict__ h,            // (B, S, D) the forward's output
    const T* __restrict__ dh,           // (B, S, D)
    const float* __restrict__ dh_last,  // (B, D) or null (zeros)
    const float* __restrict__ h0,       // (B, D) or null (zeros)
    T* __restrict__ da,                 // (B, S, D)
    T* __restrict__ db,                 // (B, S, D)
    float* __restrict__ dh0,            // (B, D)
    int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const size_t base = (size_t)b * S * D + d;
  // carry = a_{t+1} g_{t+1}: the gradient h_t receives from step t + 1.
  float carry = dh_last != nullptr ? dh_last[(size_t)b * D + d] : 0.f;
  const float first = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
  int t = S - 1;
  // Groups of kUnroll steps t - kUnroll + 1 .. t, each with its h_{t-1}
  // inside the sequence (the group's lowest step >= 1).
  for (; t - kUnroll >= 0; t -= kUnroll) {
    float av[kUnroll], gv[kUnroll], hp[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + (size_t)(t - q) * D;
      av[q] = to_float(a[o]);
      gv[q] = to_float(dh[o]);
      hp[q] = to_float(h[o - D]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + (size_t)(t - q) * D;
      const float g = __fadd_rn(gv[q], carry);
      store(db + o, g);
      store(da + o, __fmul_rn(g, hp[q]));
      carry = __fmul_rn(av[q], g);
    }
  }
  for (; t >= 0; --t) {
    const size_t o = base + (size_t)t * D;
    const float g = __fadd_rn(to_float(dh[o]), carry);
    const float prev = t > 0 ? to_float(h[o - D]) : first;
    store(db + o, g);
    store(da + o, __fmul_rn(g, prev));
    carry = __fmul_rn(to_float(a[o]), g);
  }
  dh0[(size_t)b * D + d] = carry;
}

// Phase 1: walk chunk k = blockIdx.y (every walk chunk but the last, all
// L steps long, from step S-1-kL down) gives P = the product of its a
// (multiplied in walk order) and E = its outgoing carry from zero.
template <typename T>
__global__ void __launch_bounds__(kThreads) summary_kernel(
    const T* __restrict__ a, const T* __restrict__ dh,
    float* __restrict__ p, float* __restrict__ e,  // (B, n, D)
    int S, int D, int L, int n) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const size_t top = ((size_t)b * S + (size_t)(S - 1 - k * L)) * D + d;
  float prod = 1.f, carry = 0.f;
  for (int u = 0; u < L; u += kUnroll) {  // L is a multiple of kUnroll
    float av[kUnroll], gv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = top - (size_t)(u + q) * D;
      av[q] = to_float(a[o]);
      gv[q] = to_float(dh[o]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      prod = __fmul_rn(prod, av[q]);
      carry = __fmul_rn(av[q], __fadd_rn(gv[q], carry));
    }
  }
  const size_t so = ((size_t)b * n + k) * D + d;
  p[so] = prod;
  e[so] = carry;
}

// Phase 3: walk chunk k re-walks its steps from its incoming carry and
// writes db and da; the last walk chunk (which reaches t = 0, ragged when
// L does not divide S) also writes dh0.
template <typename T>
__global__ void __launch_bounds__(kThreads) finish_kernel(
    const T* __restrict__ a, const T* __restrict__ h, const T* __restrict__ dh,
    const float* __restrict__ carry_in,  // (B, n, D)
    const float* __restrict__ h0,        // (B, D) or null (zeros)
    T* __restrict__ da, T* __restrict__ db, float* __restrict__ dh0,
    int S, int D, int L, int n) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  // Chunks in the reverse of the summaries' order: the first blocks find
  // the last summaries' inputs still in L2.
  const int k = n - 1 - blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const int hi = S - 1 - k * L;           // the walk's first step, in time
  const int len = min(L, hi + 1);         // steps hi down to hi - len + 1
  const size_t top = ((size_t)b * S + (size_t)hi) * D + d;
  float carry = carry_in[((size_t)b * n + k) * D + d];
  // Full groups whose every h_{t-1} lies inside the sequence (t >= 1).
  const int full = (hi - len + 1 >= 1) ? len : len - 1;
  int u = 0;
  for (; u + kUnroll <= full; u += kUnroll) {
    float av[kUnroll], gv[kUnroll], hp[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = top - (size_t)(u + q) * D;
      av[q] = to_float(a[o]);
      gv[q] = to_float(dh[o]);
      hp[q] = to_float(h[o - D]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = top - (size_t)(u + q) * D;
      const float g = __fadd_rn(gv[q], carry);
      store(db + o, g);
      store(da + o, __fmul_rn(g, hp[q]));
      carry = __fmul_rn(av[q], g);
    }
  }
  for (; u < len; ++u) {
    const int t = hi - u;
    const size_t o = top - (size_t)u * D;
    const float g = __fadd_rn(to_float(dh[o]), carry);
    const float prev =
        t > 0 ? to_float(h[o - D]) : (h0 != nullptr ? h0[(size_t)b * D + d] : 0.f);
    store(db + o, g);
    store(da + o, __fmul_rn(g, prev));
    carry = __fmul_rn(to_float(a[o]), g);
  }
  if (k == n - 1) dh0[(size_t)b * D + d] = carry;
}

template <typename T>
int launch(const void* a, const void* h, const void* dh, const void* dh_last, const void* h0,
           void* da, void* db, void* dh0, int B, int S, int D, cudaStream_t stream) {
  dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(h), static_cast<const T*>(dh),
      static_cast<const float*>(dh_last), static_cast<const float*>(h0), static_cast<T*>(da),
      static_cast<T*>(db), static_cast<float*>(dh0), S, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunked(const void* a_, const void* h_, const void* dh_, const void* dh_last,
                   const void* h0, void* da, void* db, void* dh0, float* p, float* ec, int B,
                   int S, int D, int L, cudaStream_t stream) {
  const T* a = static_cast<const T*>(a_);
  const T* h = static_cast<const T*>(h_);
  const T* dh = static_cast<const T*>(dh_);
  const int n = (S + L - 1) / L;
  const int tiles = (D + kThreads - 1) / kThreads;
  summary_kernel<T><<<dim3(tiles, n - 1, B), kThreads, 0, stream>>>(a, dh, p, ec, S, D, L, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_carries(p, ec, static_cast<const float*>(dh_last), B, n, D, stream);
  if (err) return err;
  finish_kernel<T><<<dim3(tiles, n, B), kThreads, 0, stream>>>(
      a, h, dh, ec, static_cast<const float*>(h0), static_cast<T*>(da), static_cast<T*>(db),
      static_cast<float*>(dh0), S, D, L, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (a, h, dh, da, db): 0 = float32, 1 = bfloat16. dh_last and h0 may
// be null (zeros); dh0 is always written. Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int rglru_scan_bwd(int dtype, const void* a, const void* h, const void* dh,
                              const void* dh_last, const void* h0, void* da, void* db,
                              void* dh0, int B, int S, int D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, h, dh, dh_last, h0, da, db, dh0, B, S, D, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, h, dh, dh_last, h0, da, db, dh0, B, S, D, st);
  return (int)cudaErrorInvalidValue;
}

// The chunked route: L steps a walk chunk (a positive multiple of 8, at
// least two chunks: L < S), `p` and `ec` float32 scratch of B x
// ceil(S/L) x D each. Three launches on `stream`; returns the first
// failing launch's cudaGetLastError() (0 on success).
extern "C" int rglru_scan_chunked_bwd(int dtype, const void* a, const void* h, const void* dh,
                                      const void* dh_last, const void* h0, void* da, void* db,
                                      void* dh0, void* p, void* ec, int B, int S, int D, int L,
                                      void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || L < kUnroll || L % kUnroll != 0 || L >= S ||
      (S + L - 1) / L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* ef = static_cast<float*>(ec);
  if (dtype == 0)
    return launch_chunked<float>(a, h, dh, dh_last, h0, da, db, dh0, pf, ef, B, S, D, L, st);
  if (dtype == 1)
    return launch_chunked<__nv_bfloat16>(a, h, dh, dh_last, h0, da, db, dh0, pf, ef, B, S, D,
                                         L, st);
  return (int)cudaErrorInvalidValue;
}
