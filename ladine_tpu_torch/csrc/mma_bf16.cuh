// bf16 tensor-core building blocks for Hopper (sm_90a), shared by the K1
// GEMM body (fused_linear.cu) and the K3 body (attention.cu): cp.async
// staging, ldmatrix and mma.sync.m16n8k16 with fp32 accumulators.
//
// Fragment coordinates of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16 x 16, 4 regs of 2 bf16): a0 row g, a1 row g + 8, cols 2t, 2t + 1;
//                                  a2, a3 the same rows, cols 2t + 8, 2t + 9
//   B (16 x 8, 2 regs):            b0 rows 2t, 2t + 1, b1 rows 2t + 8, 2t + 9; col g
//   C (16 x 8, 4 fp32):            c0, c1 row g, cols 2t, 2t + 1; c2, c3 row g + 8
// so the C fragments of two neighbouring n8 tiles, rounded to bf16 in pairs,
// are the A fragment of the next product (pack_bf16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0
// zero-fills the destination (the masked edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Four 8 x 8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i, and register i receives it (transposed with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a (16 x 16, row) @ b (16 x 8, col), bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace bf16mma
