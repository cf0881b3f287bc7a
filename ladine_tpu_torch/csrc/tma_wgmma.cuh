// Hopper (sm_90a) building blocks of K1's wgmma and tf32x3 bodies (fused_linear.cu),
// the K3 wgmma body (attention.cu) and the int8 GEMM of K4/K5
// (int8_gemm.cuh): mbarriers, TMA tile loads, the tensor maps they read,
// wgmma descriptors, the bf16 products (m64n128k16, and m64n64k16 /
// m64n16k16 with B K-major or MN-major, A from shared memory or from
// registers), the s8 product m64n128k32, the TF32 product m64n128k8 and the
// split into TF32 halves it takes, setmaxnreg, and the
// persistent schedule that K1's and the int8 GEMM's bodies walk.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a box
// whose inner extent is 128 bytes (64 bf16, 128 int8, 32 fp32) lands as rows of 128
// bytes, the 16-byte chunk c of row r stored at chunk c ^ (r % 8), in atoms
// of 8 rows (1024 bytes) that start 1024-byte aligned. wgmma reads such
// tiles through a descriptor (start address, leading and stride byte
// offsets in 16-byte units, layout type 1 = 128-byte swizzle):
//   K-major (A = x, 64 rows x 64 K):   SBO = 1024 bytes between 8-row atoms;
//     the k16 step kk starts 32 kk bytes into each row (the hardware applies
//     the swizzle to the address, as TMA did).
//   MN-major (B = w, 64 K x 128 N as two 64-column boxes, N contiguous):
//     LBO = the bytes between the two 64-column boxes, SBO = 1024 bytes
//     between 8-row (8 K) atoms; the k16 step kk starts 16 kk rows (2048 kk
//     bytes) in.
//   K-major B (K3's keys, 64 n rows x 64 K): as the K-major A, SBO = 1024
//     bytes between 8-row atoms, the k16 step kk 32 kk bytes into each row.
//   int8 (both operands K-major, as 8-bit wgmma requires; rows of 128 K):
//     the same descriptor, SBO = 1024 bytes; the k32 step kk starts 32 kk
//     bytes into each row.
//   TF32 (both operands K-major, as 32-bit wgmma requires; rows of 32 fp32
//     of K): the same descriptor, SBO = 1024 bytes; the k8 step kk starts
//     32 kk bytes into each row.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda link
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// make the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// ---- TMA --------------------------------------------------------------------

// the 3-D box at (c0, c1, c2) of `map` into shared memory at dst; completion
// (the box's bytes) is reported to bar. Out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the 4-D box at (c0, c1, c2, c3) of `map`, as tma_load_3d
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver that the runtime already
// loaded, so the library needs no -lcuda; null where the CUDA driver has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a contiguous array (d2, d1, d0) of `type` (elements of `bytes`
// bytes), d0 innermost, read in boxes of (1, b1, b0) with the 128-byte
// swizzle (b0 elements: 128 bytes). Returns false where the CUDA driver
// refuses it (a base or a row not 16-byte aligned, among others).
inline bool map_3d(CUtensorMap* map, CUtensorMapDataType type, uint64_t bytes, const void* base, uint64_t d0,
                   uint64_t d1, uint64_t d2, uint32_t b0, uint32_t b1) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {d0, d1, d2};
  cuuint64_t strides[2] = {d0 * bytes, d0 * d1 * bytes};  // bytes, of dims 1 and 2
  cuuint32_t box[3] = {b0, b1, 1};
  cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the int8 map of map_3d (b0 = 128)
inline bool s8_map_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint32_t b0,
                      uint32_t b1) {
  return map_3d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, d0, d1, d2, b0, b1);
}

// A map of a strided bf16 array of 4 dims, d0 innermost (unit stride), the
// others at byte strides s1, s2, s3 (multiples of 16), read in boxes of
// (b0, 1, b2, 1) with the 128-byte swizzle (b0 = 64: 128 bytes). Returns
// false where the CUDA driver refuses it.
inline bool bf16_map_4d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2, uint64_t d3,
                        uint64_t s1, uint64_t s2, uint64_t s3, uint32_t b0, uint32_t b2) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t dims[4] = {d0, d1, d2, d3};
  cuuint64_t strides[3] = {s1, s2, s3};
  cuuint32_t box[4] = {b0, 1, b2, 1};
  cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- wgmma ------------------------------------------------------------------

// descriptor of a 128-byte-swizzled tile at smem address addr (byte offsets in bytes)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous product
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (a wgmma that reads them through a descriptor)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// d (64 x 128 fp32, a warpgroup's fragments) += A (64 x 16, K-major) @
// B (16 x 128, MN-major: imm-trans-b = 1), bf16 operands in shared memory.
// Fragment of thread t (warp w = t / 32, lane l): d[4 j + e] is row
// 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

#define WG_F8(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
                    "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64 fp32) += A (64 x 16, K-major, shared memory) @ B (16 x 64,
// K-major: imm-trans-b = 0); fragments as m64n128k16's, columns 0 .. 63.
__device__ __forceinline__ void wgmma_m64n64k16_kmajor(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 16 fp32) += A (64 x 16, K-major, shared memory) @ B (16 x 16,
// K-major); fragments as m64n128k16's, columns 0 .. 15.
__device__ __forceinline__ void wgmma_m64n16k16_kmajor(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F8(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += A (64 x 16 bf16 in registers) @ B (16 x 64, MN-major:
// imm-trans-b = 1). Thread t (warp w, lane l) holds A's rows 16 w + l / 4
// (a0, a2) and + 8 (a1, a3), columns 2 (l % 4) + {0, 1} (a0, a1) and + 8
// (a2, a3), two bf16 a register: the accumulator fragments of one k16 slice
// (columns 16 kk .. 16 kk + 15 of an m64nN product), rounded in pairs.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 s32) += A (64 x 32 s8, K-major) @ B (32 x 128 s8, K-major),
// both in shared memory (8-bit wgmma takes both K-major and has no
// transpose or scale immediates). Fragments as m64n128k16's: d[4 j + e] is
// row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2.
#define WG_R8(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
                    "+r"(d[i + 6]), "+r"(d[i + 7])
__device__ __forceinline__ void wgmma_m64n128k32_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : WG_R8(d, 0), WG_R8(d, 8), WG_R8(d, 16), WG_R8(d, 24), WG_R8(d, 32), WG_R8(d, 40), WG_R8(d, 48),
        WG_R8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}
#undef WG_R8

// The TF32 halves of v: hi = trunc(v), the top 19 bits, which is what a
// TF32 wgmma reads of a 32-bit value (so v itself serves as hi), and lo =
// v - hi rounded to TF32 (to nearest, ties away, as cvt.rna.tf32.f32):
// v = hi + lo within 2^-21 |v|. Integer operations (cvt.rna.tf32.f32 runs
// on the conversion pipe, and was the slower split on an H100). An Inf or a
// NaN has lo = 0, so hi carries it into the products.
__device__ __forceinline__ uint32_t tf32_lo(float v) {
  const float rest = v - __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
  return rest == rest ? (__float_as_uint(rest) + 0x1000u) & 0xFFFFE000u : 0u;
}

// d (64 x 128 fp32) += A (64 x 8 tf32, K-major) @ B (8 x 128 tf32,
// K-major), both in shared memory as fp32 bits (32-bit wgmma takes both
// K-major and has no transpose immediates). Fragments as m64n128k16's.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24), WG_F8(d, 32), WG_F8(d, 40), WG_F8(d, 48),
        WG_F8(d, 56)
      : "l"(da), "l"(db), "r"(1));
}

#undef WG_F8

// ---- registers --------------------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- the persistent schedule ------------------------------------------------

// The schedule of kernels/fused_linear.py::wgmma_plan (K1's wgmma body; the
// int8 GEMM's through kernels/int8_linear.py::gemm_plan): tiles of one
// member, row tile fastest, each `steps` K-steps deep. Block b runs tiles
// b, b + grid, ... whole for tiles / grid rounds, all blocks of a round at
// the same K step; the last tiles % grid tiles are split in K into
// `chunks` equal parts, chunk q of remainder tile j run by block q * rem +
// j (so neighbours stay at one K step), and the last of its blocks to
// finish completes the tile.
struct WgSched {
  int row_tiles, col_tiles, steps, tiles, grid, chunks;
};

// The segments of one block in the order it runs them: a tile and the steps
// [kb, ke) of its K; split: the remainder tile's index, else -1. Producer
// and consumers walk the same list (kernels/fused_linear.py::wgmma_segments).
struct Segments {
  int round, rounds, rem;
  __device__ Segments(const WgSched& s) : round(0), rounds(s.tiles / s.grid), rem(s.tiles % s.grid) {}
  __device__ bool next(const WgSched& s, int& tile, int& kb, int& ke, int& split) {
    const int b = blockIdx.x;
    split = -1;
    if (round < rounds) {
      tile = b + round++ * s.grid, kb = 0, ke = s.steps;
      return true;
    }
    if (round++ > rounds || b >= rem * s.chunks) return false;
    const int q = b / rem, j = b % rem;
    tile = rounds * s.grid + j, kb = q * s.steps / s.chunks, ke = (q + 1) * s.steps / s.chunks;
    if (s.chunks > 1) split = j;
    return true;
  }
};

// A WgSched the kernels can run: the tiles of M members, a grid that covers
// the remainder's chunks, at most max_rem split tiles (their counts).
inline bool sched_ok(const WgSched& s, int M, int max_rem) {
  if (s.grid < 1 || s.grid > s.tiles || s.tiles != M * s.row_tiles * s.col_tiles || s.chunks < 1 ||
      s.chunks > s.steps)
    return false;
  const int rem = s.tiles % s.grid;
  return rem == 0 || (rem * s.chunks <= s.grid && (s.chunks == 1 || rem <= max_rem));
}

// named barrier ID over the first N threads of the block (the consumers)
template <int ID, int N>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

}  // namespace hopper
