// Warp-level tensor-core primitives shared by flash_fwd.cu, q8_matmul.cu,
// lstm_q8.cu and the other mma.sync kernels: ldmatrix loads from shared memory, the bf16
// m16n8k16 mma.sync with fp32 accumulators and the int8 m16n8k32 one with
// int32 accumulators, with the PTX fragment layouts they imply.
//
// For one warp, lane = 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 16, row-major) a0: (row g,   k 2t..2t+1)   a1: (row g+8, same k)
//                          a2: (row g,   k 2t+8..+9)   a3: (row g+8, same k)
//   B (16 x 8, k x n)      b0: (k 2t..2t+1, col g)     b1: (k 2t+8..+9, col g)
//   C (16 x 8, fp32)       c0, c1: (row g, cols 2t, 2t+1)  c2, c3: row g+8
// so the C fragments of two adjacent 8-column tiles, rounded to bf16 in
// pairs, are exactly the A fragment of the next product over those 16
// columns (the flash-attention P . V step).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hl {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the 8 row addresses of
// matrix i (16 bytes each), and r[i] receives matrix i's fragment:
// lane 4g+t holds row g, elements 2t and 2t+1
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same with each matrix transposed: lane 4g+t holds column g, rows
// 2t and 2t+1
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b  (16x16 bf16 . 16x8 bf16, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b  (16x32 s8 . 32x8 s8, exact int32 sums). The fragments are
// mma_bf16's with each 32-bit register holding four int8 of consecutive
// k (the first in the low byte) where it held two bf16:
//   a0 (row g, k 4t..4t+3)  a1 (row g+8, same k)  a2, a3: k + 16
//   b0 (k 4t..4t+3, col g)  b1: k + 16;  C as mma_bf16's, in int32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(smem)), "l"(gmem));
}
// 16 bytes global -> shared through L2 only; zeros (and no read) where
// !valid
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace hl
