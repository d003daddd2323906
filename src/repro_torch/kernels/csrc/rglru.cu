// RG-LRU linear recurrence (RecurrentGemma / Griffin) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `rglru_scan` in src/repro/kernels/rglru.py
// (pallas_call at line 94, body `_kernel` at line 31). Same function, per
// (batch b, channel d):
//     h_t = a_t * h_{t-1} + b_t,   h_0 = h0 (zeros when absent)
// a and b in float32 or bfloat16 (one dtype), h carried in float32, the
// per-step h written in a's dtype, the last h in float32.
//
// What bounds it on the H100: bytes. Each element of a and b is read once
// and each h written once, with one multiply and one add per element: at
// recurrentgemma-9b's prefill shape (B = 8, S = 512, D = 4096, float32)
// that is 201 MB, 0.060 ms at 3.35 TB/s, and 0.03 GFLOP; at its training
// shape (B = 1, S = 4096, D = 4096) the same. Two routes, which the
// wrapper picks by shape alone (kernels/rglru.py, `uses_chunked`):
//
// Streaming (`rglru_kernel`), for shapes whose B x D channels fill the
// card, as the served prefill's 8 x 4096 do:
//   - one thread per (b, channel): the TPU grid's sequential time axis
//     becomes a loop with h in a register, channels tiled 128 to a block,
//     so each time step's loads and stores are contiguous across a warp;
//   - the loop is unrolled 8 steps deep with every load of a group issued
//     before its first use, so 16 loads per thread are in flight while the
//     dependent chain of h runs;
//   - a ragged channel width (D = 520) is bounds-checked, and a ragged S
//     needs no padding (the Pallas kernel pads with a = 1, b = 0);
//   - the multiply and the add are rounded separately, as `a * h + b` is
//     in the reference, not fused: float32 results are the plain
//     version's bit for bit.
// At B = 1, D = 4096 that is 32 blocks of 4 warps on 132 SMs: too few
// loads in flight to approach the memory rate.
//
// Chunked (`summary_kernel`, rglru_chunk.cuh's `carry_kernel`,
// `finish_kernel`), for shapes that would leave the card idle: time cut
// into n chunks of L steps (the wrapper's `plan_chunks`), a grid of
// (channel tiles x chunks x B) blocks, 1024 at the training shape with L =
// 128 (the planner aims at 4 blocks an SM: on an H100 80GB HBM3 at 700 W, L
// = 128 there timed 0.1216 ms against 0.1267 for L = 64 and 0.1351 for L =
// 32, scripts/chip_measure.py rglru). Phase 1 reads a and b of every chunk but the last once and writes
// its (P, E) in float32; phase 2 turns those into the h entering each
// chunk (seeded by h0); phase 3 re-walks each chunk from its carry, reads
// a and b again and writes h, the last chunk also the last h. Its bytes
// are 5/3 of the single pass (0.100 ms at the training shape) for 32 x
// the blocks. Only the carries round differently from the sequential
// walk (each chunk's walk is the plain recurrence's, unfused), and
// `ref.rglru_chunked_plain` repeats this association bit for bit. No
// atomics and a fixed plan per shape: two calls agree bit for bit. Decays
// whose products underflow are right as they are: the build flushes no
// denormals to zero, and the carry's weight really vanishes.

#include "rglru_chunk.cuh"

namespace {

using namespace rglru;

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_kernel(
    const T* __restrict__ a,       // (B, S, D)
    const T* __restrict__ bin,     // (B, S, D)
    const float* __restrict__ h0,  // (B, D) or null (zeros)
    T* __restrict__ out,           // (B, S, D)
    float* __restrict__ h_last,    // (B, D)
    int S, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  float h = h0 != nullptr ? h0[(size_t)b * D + d] : 0.f;
  const size_t base = (size_t)b * S * D + d;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + (size_t)(t + q) * D;
      av[q] = to_float(a[o]);
      bv[q] = to_float(bin[o]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      h = step(av[q], h, bv[q]);
      store(out + base + (size_t)(t + q) * D, h);
    }
  }
  for (; t < S; ++t) {
    const size_t o = base + (size_t)t * D;
    h = step(to_float(a[o]), h, to_float(bin[o]));
    store(out + o, h);
  }
  h_last[(size_t)b * D + d] = h;
}

// Phase 1: chunk c = blockIdx.y (every chunk but the last, all L steps
// long) gives P = a_{t0} ... a_{t0+L-1} (multiplied in time order) and E
// = its end state from zero.
template <typename T>
__global__ void __launch_bounds__(kThreads) summary_kernel(
    const T* __restrict__ a, const T* __restrict__ bin,
    float* __restrict__ p, float* __restrict__ e,  // (B, n, D)
    int S, int D, int L, int n) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const size_t base = ((size_t)b * S + (size_t)c * L) * D + d;
  float prod = 1.f, y = 0.f;
  for (int t = 0; t < L; t += kUnroll) {  // L is a multiple of kUnroll
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + (size_t)(t + q) * D;
      av[q] = to_float(a[o]);
      bv[q] = to_float(bin[o]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      prod = __fmul_rn(prod, av[q]);
      y = step(av[q], y, bv[q]);
    }
  }
  const size_t so = ((size_t)b * n + c) * D + d;
  p[so] = prod;
  e[so] = y;
}

// Phase 3: chunk c walks its steps from the h entering it (`carry`) and
// writes h; the last chunk (ragged when L does not divide S) also writes
// the last h.
template <typename T>
__global__ void __launch_bounds__(kThreads) finish_kernel(
    const T* __restrict__ a, const T* __restrict__ bin,
    const float* __restrict__ carry,  // (B, n, D)
    T* __restrict__ out, float* __restrict__ h_last, int S, int D, int L, int n) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  // Chunks in the reverse of the summaries' order: the first blocks find
  // the last summaries' inputs still in L2.
  const int c = n - 1 - blockIdx.y, b = blockIdx.z;
  if (d >= D) return;
  const int len = min(L, S - c * L);
  const size_t base = ((size_t)b * S + (size_t)c * L) * D + d;
  float h = carry[((size_t)b * n + c) * D + d];
  int t = 0;
  for (; t + kUnroll <= len; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + (size_t)(t + q) * D;
      av[q] = to_float(a[o]);
      bv[q] = to_float(bin[o]);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      h = step(av[q], h, bv[q]);
      store(out + base + (size_t)(t + q) * D, h);
    }
  }
  for (; t < len; ++t) {
    const size_t o = base + (size_t)t * D;
    h = step(to_float(a[o]), h, to_float(bin[o]));
    store(out + o, h);
  }
  if (c == n - 1) h_last[(size_t)b * D + d] = h;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out, void* h_last, int B,
           int S, int D, cudaStream_t stream) {
  dim3 grid((D + kThreads - 1) / kThreads, B);
  rglru_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<float*>(h_last), S, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunked(const void* a_, const void* b_, const void* h0, void* out_, void* h_last,
                   float* p, float* ec, int B, int S, int D, int L, cudaStream_t stream) {
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  const int n = (S + L - 1) / L;
  const int tiles = (D + kThreads - 1) / kThreads;
  summary_kernel<T><<<dim3(tiles, n - 1, B), kThreads, 0, stream>>>(a, b, p, ec, S, D, L, n);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_carries(p, ec, static_cast<const float*>(h0), B, n, D, stream);
  if (err) return err;
  finish_kernel<T><<<dim3(tiles, n, B), kThreads, 0, stream>>>(
      a, b, ec, static_cast<T*>(out_), static_cast<float*>(h_last), S, D, L, n);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (a, b, out): 0 = float32, 1 = bfloat16. h0 may be null.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int rglru_scan_fwd(int dtype, const void* a, const void* b, const void* h0,
                              void* out, void* h_last, int B, int S, int D, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, out, h_last, B, S, D, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0, out, h_last, B, S, D, st);
  return (int)cudaErrorInvalidValue;
}

// The chunked route: L steps a chunk (a positive multiple of 8, at least
// two chunks: L < S), `p` and `ec` float32 scratch of B x ceil(S/L) x D
// each. Three launches on `stream`; returns the first failing launch's
// cudaGetLastError() (0 on success).
extern "C" int rglru_scan_chunked_fwd(int dtype, const void* a, const void* b, const void* h0,
                                      void* out, void* h_last, void* p, void* ec, int B, int S,
                                      int D, int L, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || D < 1 || L < kUnroll || L % kUnroll != 0 || L >= S ||
      (S + L - 1) / L > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* ef = static_cast<float*>(ec);
  if (dtype == 0) return launch_chunked<float>(a, b, h0, out, h_last, pf, ef, B, S, D, L, st);
  if (dtype == 1)
    return launch_chunked<__nv_bfloat16>(a, b, h0, out, h_last, pf, ef, B, S, D, L, st);
  return (int)cudaErrorInvalidValue;
}
