// The tile machinery the wgmma attention kernels share (sm_90a):
// csrc/flash_attention.cu (the forward) and csrc/flash_attention_bwd.cu
// (the backward) include it, each into its own translation unit.
//
// Layout: a 64-row tile of DP bf16 columns sits in shared memory as DP / 64
// blocks of 64 rows x 64 columns, each row 128 bytes in the 128-byte
// swizzle that wgmma reads (row r at r * 128 bytes, its 16-byte chunk c at
// (c ^ (r % 8)) * 16), blocks 1024-byte aligned. One tile stored so is read
// both ways: K-major (its rows are the product's M or N, contiguous along
// the reduction) by `wgmma_ss`, and MN-major (its rows are the reduction)
// as the B operand of `wgmma_rs`, so no product needs a transposed copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
constexpr int kFlashThreads = 256;  // two warpgroups
// One 64-row x 64-column bf16 block in the 128-byte swizzle: row r at
// r * 128 bytes, its 16-byte chunk c at ((c ^ (r % 8)) * 16). 1024-byte
// aligned, as the swizzle is a function of the address bits.
constexpr int kBlockBytes = 64 * 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills the 16 bytes when !pred
// (src-size 0: nothing is read).
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

// Copy rows [0, rows) of a (rows_total x D) strided bf16 matrix into a
// 64 x DP swizzled tile at `dst`; rows >= rows and columns >= D are zero.
// THREADS threads (tid < THREADS) share the copy.
template <int DP, int THREADS = kFlashThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, size_t stride,
                                          int rows, int D, int tid) {
  constexpr int kRowChunks = DP / 8;
#pragma unroll 4
  for (int c = tid; c < 64 * kRowChunks; c += THREADS) {
    const int r = c / kRowChunks;
    const int ch = c - r * kRowChunks;
    const uint32_t at = dst + (ch >> 3) * kBlockBytes + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
    const bool ok = r < rows && ch * 8 < D;
    cp_async16(at, ok ? src + (size_t)r * stride + ch * 8 : src, ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
// Addresses and byte offsets are encoded in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (it sees them written at the issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 64); A and
// B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (64 x 16, registers: four bf16x2 per thread) B (16 x 64); B from
// shared memory, MN-major (transposed by the instruction).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace
