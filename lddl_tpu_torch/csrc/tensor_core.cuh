// Tensor-core building blocks for the bf16 flash bodies (sm_80 and later
// instructions, built here for sm_90a): cp.async copies into shared memory,
// ldmatrix fragment loads and the m16n8k16 bf16 mma.sync with float32
// accumulators. Every pointer argument is a generic pointer; the helpers
// convert shared-memory ones themselves.
//
// Fragment maps (g = lane / 4, t = lane % 4), as the PTX ISA defines them
// for mma.sync.aligned.m16n8k16 with .bf16 operands:
//   A, 16 x 16 row-major, 4 registers of 2 bf16 (low half = lower column):
//     a[0] = (row g, cols 2t, 2t+1)      a[1] = (row g+8, cols 2t, 2t+1)
//     a[2] = (row g, cols 2t+8, 2t+9)    a[3] = (row g+8, cols 2t+8, 2t+9)
//   B, 16 x 8 (k x n), 2 registers:
//     b[0] = (k 2t, 2t+1; n g)           b[1] = (k 2t+8, 2t+9; n g)
//   C/D, 16 x 8 float32, 4 registers:
//     c[0], c[1] = (row g, cols 2t, 2t+1)   c[2], c[3] = (row g+8, same)
// So the C fragments of two neighbouring n-blocks, packed to bf16, are the
// A fragment of one 16-wide k-step: a = {c0[0:1], c0[2:3], c1[0:1], c1[2:3]}.
//
// ldmatrix.x4 loads four 8 x 8 bf16 matrices: lanes 8i..8i+7 give the
// addresses of matrix i's eight rows (16 bytes each, 16-byte aligned), and
// lane l receives in register i (row l/4, cols 2(l%4), 2(l%4)+1) of
// matrix i, or with .trans (rows 2(l%4), 2(l%4)+1, col l/4).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; with !pred nothing is read and
// the 16 bytes are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, the same way.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// Close the copies this thread issued since the last commit into a group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight (the
// newest N). The other threads' copies need a __syncthreads after it.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores: one 16 x 8 x 16 product of a warp.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the
// low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tc
