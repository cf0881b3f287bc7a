// Shared parts of the int8 eps kernels for Hopper (sm_90a): the per-row
// quantizer, the quantizing pre-pass, and the member-stacked int8 GEMM with
// its two epilogues. Included by int8_linear.cu (K4) and int8_eps_fused.cu
// (K5); each compiles the instances it launches.
//
// The GEMM, for every member m (tiles of all members in one launch):
//
//   acc = xq[m] @ w[m]                     int8 x int8 -> int32, exact
//   z   = (acc [+ 127 * colsum]) * (xs * s) + c,   xs = max(xmax, 1e-8) / (127 | 254)
//   h   = softplus(z) rounded to the activation type T
//   STORE: h[m] = h, hmax[m, r] = max over the row of the stored h
//   LIN4:  out[m] = h @ w4[m]               (h never reaches device memory)
//
// xq: (M, R, K) int8, xmax: (M, R) fp32, w: the (K, N) int8 weight stored
// K-contiguous, i.e. as (M, N, K); s, c, colsum: (M, N) fp32.
//
// Bound on an H100 at the path's shape (M = 5 members, R = 160 rows a
// member at batch 8, K = N = 4096): a call reads the 84 MB of int8 weight
// once and 13 MB of activations (0.029 ms at 3.35 TB/s) against 27 G int8
// operations (0.014 ms at 1,979 TOP/s): bound by bytes, and what costs is
// reading the same bytes more than once.
//
// Design: a TMA ring feeding s8 wgmma on a persistent grid, the shape of
// K1's wgmma body (fused_linear.cu) with 8-bit operands.
//  - Operands. 8-bit wgmma takes A and B K-major, so the weight is kept
//    K-contiguous from quantization on, (M, N, K), as are the codes xq
//    (M, R, K). Both are read by 3-D TMA tensor maps, (K, R, M) and (K, N,
//    M), in boxes of 128 bytes of K with the 128-byte swizzle (64 rows of
//    xq, 128 rows of w): rows past R, columns past N and K past its end
//    arrive as zeros, never as the next member's rows.
//  - Tiles of BM = 192 rows x BN = 128 columns, BK = 128 bytes of K a step
//    (one swizzled box), through a ring of 5 stages with a full and an empty
//    mbarrier each; one thread of a producer warpgroup (setmaxnreg gives
//    its registers to the consumers) issues the loads, three consumer
//    warpgroups each multiply one 64-row slab of the tile with
//    wgmma.m64n128k32.s32.s8.s8 into 64 int32 accumulators a thread and
//    hand a stage back as soon as the products that read it are done. A
//    slab wholly past R is neither loaded nor multiplied. At batch 8 the
//    160 rows of a member fit one row tile, so each 128-column weight strip
//    leaves device memory once.
//  - The schedule (hopper::WgSched, kernels/int8_linear.py::gemm_plan):
//    min(132, tiles) persistent blocks, one an SM, run the tiles (row tile
//    fastest) whole a round at a time; the tiles % grid tiles of the last
//    round are split in K into equal chunks over as many blocks as they
//    fill. At batch 8 (160 tiles) 132 run whole and 28 in quarters on 112
//    blocks; at R = 1400 (1280 tiles) 9 rounds of 132 and one of 92. A
//    chunk of a split tile leaves its int32 partial tile in a workspace and
//    counts itself in; the last of the tile's blocks adds the partials and
//    runs the epilogue once. int32 sums do not depend on order, so a split
//    changes no bit, and no block waits for another.
//  - Bound. At batch 8 the call streams 84 MB of weight (0.025 ms at 3.35
//    TB/s); each of a member's 32 column tiles re-reads its 0.66 MB of codes
//    from L2. At R = 1400 the 235 G operations bound it (0.119 ms at 1,979
//    TOP/s), and each tile step brings 40 KB a 128 bytes of K into an SM
//    from L2.
//
// The epilogue runs in registers on the accumulator fragments: thread t of
// consumer warpgroup g (warp w, lane l) holds rows 64 g + 16 w + l / 4 (+ 8)
// and columns 8 j + 2 (l % 4) (+ 1) of the tile. Its operands (s, c,
// 127 colsum, the first CLASSES columns of w4, the row scales) are loaded
// when the tile starts, one column and one row a thread, and reach shared
// memory after the products, so their latency hides behind them; LIN4's
// further classes, up to W4_CLASSES, join them there after the products.
// The loop over the 16 column pairs runs in turns of EPI_U pairs (unrolled
// within a turn, not across turns: a fully unrolled epilogue spilled in
// LIN4 and was slower in STORE); after each turn the accumulators rotate by
// 4 EPI_U, so every turn reads the same registers. STORE writes h as pairs of adjacent
// columns and takes each row's max as it goes; the 4 lanes of a row meet
// by shuffles, then one atomicMax a row and column tile on the float's bit
// pattern goes into a zero-filled hmax (softplus is >= 0: exact and
// order-free; the TPU kernel carries the row max along its sequential N
// axis, and nothing carries over between blocks here). Each element takes
// the same rounded operations in the same order whatever the tiling, so h
// and hmax do not depend on the schedule. LIN4 contracts its h values with
// their rows of w4 as it goes (CLASSES classes a pass; more classes take
// more passes, which read h from the accumulators' registers, where the
// first pass left its bits), adds the 4 lanes of a row by shuffles in a
// fixed order, and stores each row's sums over the tile's 128 columns,
// (rows x C) fp32, into its column tile's slot of a workspace that the
// wrapper allocates (kernels/int8_eps_fused.py::l34_workspace_bytes: a
// count a (member, row tile), then a slot a column tile). The block then counts the tile in (an
// integer atomic after a fence); the last of a (member, row tile)'s
// col_tiles tiles sums the slots in column-tile order into out and resets
// the count, so a graph replay starts clean. No float atomics and no block
// waits for another: the order of every sum is fixed by the shape, so two
// launches give the same bits.
//
// Where the time goes (H100 80GB HBM3, 700 W; build variants timed in one
// call, bf16 rows, K4 with its pre-pass): 0.060 / 0.075 / 0.316 ms at R =
// 20 / 160 / 1400, of which the epilogue is 0.017 / 0.022 / 0.094 (the same
// body without it: 0.043 / 0.053 / 0.22), the softplus and the stores of h
// about half of that. Without the products an earlier build lost only
// 0.003 ms at R = 20 and 160: at batch 8 the weight stream (~2 TB/s when
// nothing else runs) and the epilogue, which does not overlap the next
// tile's products (the producer runs at most 5 steps ahead of it), take
// the time. A ring of 256-byte K steps (2 stages), 3 or 4 stages, a K
// order rotated by column strip and other L2 promotions of the weight
// measured no faster.
//
// Numerics follow ladine_tpu/kernels/int8_pallas.py: round half to even
// (rintf), IEEE division in the quantizer, and __fmul_rn/__fadd_rn keep the
// association acc * (xs * s) + c without fused multiply-adds, so the kernel
// and its plain PyTorch version pick the same int8 code for the same input.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace int8k {

constexpr int SLABS = 3;  // consumer warpgroups, one 64-row slab each
constexpr int BM = 64 * SLABS, BN = 128, BK = 128, STAGES = 5;  // BK: bytes of K a step, one 128-byte TMA box
constexpr int THREADS = 128 * (SLABS + 1);  // + the producer warpgroup
constexpr int A_BOX = 64 * BK, B_BOX = BN * BK;  // bytes of one TMA box of xq, of w
constexpr int STAGE_BYTES = SLABS * A_BOX + B_BOX;  // a box of every slab, then of w
constexpr int CLASSES = 2;  // lin4 classes an epilogue pass (the path has 2)
constexpr int W4_CLASSES = 16;  // lin4 classes whose w4 columns the epilogue reads from shared memory
// the epilogue's operands of a tile in shared memory: s, c, 127 colsum and
// W4_CLASSES columns of w4 a column, then the row scales
constexpr int VEC_FLOATS = (3 + W4_CLASSES) * BN + BM;
constexpr int SMEM_BYTES = 128 + 1024 + STAGES * STAGE_BYTES + VEC_FLOATS * 4;  // barriers and flags, alignment, ring
constexpr int PART_INTS = BM * BN;  // a block's int32 partial tile in the split workspace
constexpr int FLAG_BYTES = 1024, MAX_REM = FLAG_BYTES / 4;  // the split tiles' counts lead it
static_assert(SMEM_BYTES <= 232448, "the ring fits a block's shared memory");

enum Epilogue { STORE = 0, LIN4 = 1 };

// LIN4's workspace: an int count a (member, row tile), padded to 16 bytes,
// then a (R x C) fp32 slot a (member, column tile). The layout of
// kernels/int8_eps_fused.py::l34_workspace_bytes.
__host__ __device__ inline int lin4_flag_bytes(int M, int row_tiles) { return (M * row_tiles * 4 + 15) / 16 * 16; }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and jnp
}

// jax.nn.softplus's formula
__device__ __forceinline__ float softplus(float z) {
  return __fadd_rn(fmaxf(z, 0.f), log1pf(expf(-fabsf(z))));
}

// The row scale and the int8 code of the JAX kernels' quantizer.
__device__ __forceinline__ float row_scale(float xmax, bool zp) {
  return __fdiv_rn(fmaxf(xmax, 1e-8f), zp ? 254.f : 127.f);
}
__device__ __forceinline__ int quant(float x, float xs, bool zp) {
  float q = rintf(__fdiv_rn(x, xs));
  if (zp) q -= 127.f;
  return __float2int_rn(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

// two adjacent outputs in one store (p aligned to two elements)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, __nv_bfloat16 a, __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

// Pre-pass: xq = quant(x, row_scale(xmax)) for a (rows, K) matrix, 8
// consecutive elements a thread (K % 8 == 0, 16-byte aligned rows).
template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x, const float* __restrict__ xmax,
                                     int8_t* __restrict__ xq, long long total, int K, bool zp) {
  long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= total) return;
  const float xs = row_scale(xmax[i / K], zp);
  float v[8];
  load8(x + i, v);
  uint2 q;
  q.x = pack4(quant(v[0], xs, zp), quant(v[1], xs, zp), quant(v[2], xs, zp), quant(v[3], xs, zp));
  q.y = pack4(quant(v[4], xs, zp), quant(v[5], xs, zp), quant(v[6], xs, zp), quant(v[7], xs, zp));
  *reinterpret_cast<uint2*>(xq + i) = q;
}

template <typename T>
int launch_quantize_rows(const void* x, const float* xmax, int8_t* xq, long long rows, int K, bool zp,
                         cudaStream_t s) {
  long long total = rows * K;
  long long threads = (total + 7) / 8;
  int block = 256;
  quantize_rows_kernel<T><<<(unsigned)((threads + block - 1) / block), block, 0, s>>>(
      static_cast<const T*>(x), xmax, xq, total, K, zp);
  return static_cast<int>(cudaGetLastError());
}

// *p += v at GPU scope, acquire-release: the writes this thread has seen
// happen before it are visible to whoever reads the sum after it
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void consumers_sync() { hopper::named_sync<1, SLABS * 128>(); }

constexpr int EPI_U = 4;  // column pairs an epilogue turn: a loop of BN / 8 / EPI_U turns, each unrolled
static_assert(BN / 8 % EPI_U == 0 && EPI_U < BN / 8, "whole turns, and more than one");

// acc[v] <- acc[(v + S) % 64]: the next turn's fragments move to the front,
// so an epilogue loop that is not unrolled reads its accumulators at
// constant indices (registers); 64 / S turns restore the order.
template <int S>
__device__ __forceinline__ void rotate(int* acc) {
  int t[S];
#pragma unroll
  for (int v = 0; v < S; ++v) t[v] = acc[v];
#pragma unroll
  for (int v = 0; v < 64 - S; ++v) acc[v] = acc[v + S];
#pragma unroll
  for (int v = 0; v < S; ++v) acc[64 - S + v] = t[v];
}

// Loads issued where they stand (volatile asm is not moved past the
// mainloop's), so their latency hides behind the products; bf16 stays in
// its bits until it is used.
__device__ __forceinline__ float ld_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned short ld_early(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.b16 %0, [%1];\n" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float early_f(float v) { return v; }
__device__ __forceinline__ float early_f(unsigned short v) { return __bfloat162float(__ushort_as_bfloat16(v)); }

// One block a SM on the schedule s; warpgroups 0 .. SLABS-1 multiply and
// run the epilogue, the last warpgroup's first thread issues the TMA loads.
template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                 const float* __restrict__ xmax, const float* __restrict__ s, const float* __restrict__ c,
                 const float* __restrict__ colsum, T* __restrict__ h, float* __restrict__ hmax,
                 const T* __restrict__ w4, float* __restrict__ out, unsigned char* __restrict__ split_work,
                 unsigned char* __restrict__ lin4_work, int M, int R, int K, int N, int C, hopper::WgSched sc) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int* last = reinterpret_cast<int*>(empty + STAGES);  // [0]: finishes the split tile, [1]: sums lin4's slots
  const uint32_t base = smem_u32(smem);
  unsigned char* ring = smem + (((base + 128 + 1023) & ~1023u) - base);  // 1024-aligned for the swizzle
  float* vec = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);  // s, c, 127 colsum, w4 columns; xs
  float* xs_s = vec + (3 + W4_CLASSES) * BN;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);           // the producer's expect_tx arrival (+ the bytes)
      mbar_init(&empty[i], SLABS * 4);  // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  int tile, kb, ke, split;
  if (wg == SLABS) {  // ---- producer
    regs_dealloc<40>();
    if (t != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (Segments seg(sc); seg.next(sc, tile, kb, ke, split);) {
      const int row0 = (tile % sc.row_tiles) * BM, col0 = (tile / sc.row_tiles % sc.col_tiles) * BN;
      const int m = tile / (sc.row_tiles * sc.col_tiles);
      const int live = min(SLABS, (R - row0 + 63) / 64);  // slabs with a row below R
      for (int ks = kb; ks < ke; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * STAGE_BYTES;
        mbar_expect_tx(&full[stage], live * A_BOX + B_BOX);
        for (int q = 0; q < live; ++q) tma_load_3d(st + q * A_BOX, &amap, &full[stage], ks * BK, row0 + 64 * q, m);
        tma_load_3d(st + SLABS * A_BOX, &bmap, &full[stage], ks * BK, col0, m);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  regs_alloc<152>();
  const int warp = t / 32, lane = t % 32, t4 = lane % 4;
  const bool zp = colsum != nullptr;
  int* counts = reinterpret_cast<int*>(split_work);
  int* part = reinterpret_cast<int*>(split_work + FLAG_BYTES) + wg * 64 * BN + t;  // value v at + v * 128
  int acc[64];
  int stage = 0;
  uint32_t phase = 0;
  for (Segments seg(sc); seg.next(sc, tile, kb, ke, split);) {
    const int rt = tile % sc.row_tiles, ct = tile / sc.row_tiles % sc.col_tiles;
    const int tile_row0 = rt * BM, row0 = tile_row0 + 64 * wg, col0 = ct * BN;
    const int m = tile / (sc.row_tiles * sc.col_tiles);
    const bool live = row0 < R;  // warpgroup-uniform; a dead slab only keeps the ring turning
    // The epilogue's operands, loaded now into registers (consumer thread i:
    // column i, row i of the tile) so that their latency hides behind the
    // products; they go to shared memory for the epilogue.
    const int ci = threadIdx.x;
    float pre[3] = {0.f, 0.f, 0.f}, xpre = 0.f;
    decltype(ld_early(w4)) pre_w4[CLASSES] = {};
    if (ci < BN && col0 + ci < N) {
      const size_t mc = (size_t)m * N + col0 + ci;
      pre[0] = ld_early(s + mc), pre[1] = ld_early(c + mc);
      if (zp) pre[2] = ld_early(colsum + mc);
      if constexpr (EPI == LIN4) {
#pragma unroll
        for (int q = 0; q < CLASSES; ++q)
          if (q < C) pre_w4[q] = ld_early(w4 + mc * C + q);
      }
    }
    if (ci < BM && tile_row0 + ci < R) xpre = ld_early(xmax + (size_t)m * R + tile_row0 + ci);
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] = 0;
    int held = -1;  // the stage whose products may still be running
    for (int ks = kb; ks < ke; ++ks) {
      mbar_wait(&full[stage], phase);
      if (live) {
        const uint32_t st = smem_u32(ring + stage * STAGE_BYTES);
#pragma unroll
        for (int v = 0; v < 64; ++v) fence_operand(acc[v]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)  // K past its end arrived as zeros in both operands
          wgmma_m64n128k32_s8(acc, desc_sw128(st + wg * A_BOX + 32 * kk, 16, 1024),
                              desc_sw128(st + SLABS * A_BOX + 32 * kk, 16, 1024));
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: hand it back
#pragma unroll
        for (int v = 0; v < 64; ++v) fence_operand(acc[v]);
      }
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == STAGES) stage = 0, phase ^= 1;
    }
    if (live) {
      wgmma_wait<0>();
#pragma unroll
      for (int v = 0; v < 64; ++v) fence_operand(acc[v]);
    }
    if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);

    if (split >= 0) {  // a chunk of a split tile: the last of its blocks finishes it
      if (live) {
#pragma unroll
        for (int v = 0; v < 64; ++v) __stcg(part + (size_t)blockIdx.x * PART_INTS + v * 128, acc[v]);
      }
      __threadfence();
      consumers_sync();
      if (threadIdx.x == 0) last[0] = atomicAdd(counts + split, 1) == sc.chunks - 1;
      consumers_sync();
      if (!last[0]) continue;
      __threadfence();
      if (live) {  // int32: the same sum in any order; taken in chunk order all the same
        const int rem = sc.tiles % sc.grid;
#pragma unroll
        for (int v = 0; v < 64; ++v) acc[v] = __ldcg(part + (size_t)split * PART_INTS + v * 128);
        for (int q = 1; q < sc.chunks; ++q) {
          const int* p = part + (size_t)(q * rem + split) * PART_INTS;
#pragma unroll
          for (int v = 0; v < 64; ++v) acc[v] += __ldcg(p + v * 128);
        }
      }
    }

    consumers_sync();  // every warpgroup is done with the last tile's operands
    if (ci < BN) {
      vec[ci] = pre[0], vec[BN + ci] = pre[1], vec[2 * BN + ci] = zp ? __fmul_rn(127.f, pre[2]) : 0.f;
#pragma unroll
      for (int q = 0; q < CLASSES; ++q) vec[(3 + q) * BN + ci] = early_f(pre_w4[q]);
      if constexpr (EPI == LIN4) {  // the later passes' classes (C > CLASSES), loaded now
        for (int q = CLASSES; q < min(C, W4_CLASSES); ++q)
          vec[(3 + q) * BN + ci] = col0 + ci < N ? to_f(w4[((size_t)m * N + col0 + ci) * C + q]) : 0.f;
      }
    }
    if (ci < BM) xs_s[ci] = tile_row0 + ci < R ? row_scale(xpre, zp) : 0.f;
    consumers_sync();

    // ---- epilogue, in registers: rows rr (h = 0) and rr + 8 (h = 1), columns col0 + 8 j + 2 t4 (+ 1)
    const int rr = row0 + 16 * warp + lane / 4;
    const float xs[2] = {xs_s[rr - tile_row0], xs_s[rr + 8 - tile_row0]};
    const bool pairs = N % 2 == 0;  // then col < N implies col + 1 < N, 2-element aligned
    if constexpr (EPI == STORE) {
      if (live) {
        float mx[2] = {0.f, 0.f};
#pragma unroll 1
        for (int j0 = 0; j0 < BN / 8 && col0 + 8 * j0 < N; j0 += EPI_U) {  // turns wholly past N: none
#pragma unroll
          for (int jj = 0; jj < EPI_U; ++jj) {
            const int j = j0 + jj;
            const int col = col0 + 8 * j + 2 * t4;
            const float2 sv = *reinterpret_cast<const float2*>(vec + 8 * j + 2 * t4);
            const float2 cv = *reinterpret_cast<const float2*>(vec + BN + 8 * j + 2 * t4);
            const float2 zv = *reinterpret_cast<const float2*>(vec + 2 * BN + 8 * j + 2 * t4);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = rr + 8 * hh;
              if (r >= R || col >= N) continue;
              T o[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float a = __int2float_rn(acc[4 * jj + 2 * hh + e]);
                if (zp) a = __fadd_rn(a, e ? zv.y : zv.x);
                o[e] = from_f<T>(softplus(__fadd_rn(__fmul_rn(a, __fmul_rn(xs[hh], e ? sv.y : sv.x)), e ? cv.y : cv.x)));
              }
              T* dst = h + ((size_t)m * R + r) * N + col;
              if (pairs) {
                store2(dst, o[0], o[1]);
                mx[hh] = fmaxf(mx[hh], fmaxf(to_f(o[0]), to_f(o[1])));
              } else {
                dst[0] = o[0];
                mx[hh] = fmaxf(mx[hh], to_f(o[0]));
                if (col + 1 < N) dst[1] = o[1], mx[hh] = fmaxf(mx[hh], to_f(o[1]));
              }
            }
          }
          rotate<4 * EPI_U>(acc);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v = mx[hh];
#pragma unroll
          for (int o = 1; o < 4; o *= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
          if (t4 == 0 && rr + 8 * hh < R)
            atomicMax(reinterpret_cast<int*>(hmax) + (size_t)m * R + rr + 8 * hh, __float_as_int(v));
        }
      }
    } else {
      // LIN4: this tile's sums over its 128 columns, row by row, into its column tile's slot
      const int flag_bytes = lin4_flag_bytes(M, sc.row_tiles);
      float* slots = reinterpret_cast<float*>(lin4_work + flag_bytes);
      float* slot = slots + ((size_t)m * sc.col_tiles + ct) * R * C;
      if (live) {
        for (int c0 = 0; c0 < C; c0 += CLASSES) {
          float rs[2][CLASSES];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int q = 0; q < CLASSES; ++q) rs[hh][q] = 0.f;
#pragma unroll 1
          for (int j0 = 0; j0 < BN / 8; j0 += EPI_U) {
            if (col0 + 8 * j0 >= N) {  // a turn wholly past N adds nothing; the rotation keeps the order
              rotate<4 * EPI_U>(acc);
              continue;
            }
#pragma unroll
            for (int jj = 0; jj < EPI_U; ++jj) {
              const int cl = 8 * (j0 + jj) + 2 * t4, col = col0 + cl;
              float sv[2], cv[2], zv[2], w4v[2][CLASSES];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const bool ok = col + e < N;
                sv[e] = vec[cl + e], cv[e] = vec[BN + cl + e], zv[e] = vec[2 * BN + cl + e];
#pragma unroll
                for (int q = 0; q < CLASSES; ++q)  // classes past W4_CLASSES from w4 itself
                  w4v[e][q] = c0 + q >= C            ? 0.f
                              : c0 + q < W4_CLASSES ? vec[(3 + c0 + q) * BN + cl + e]
                              : ok                  ? to_f(w4[((size_t)m * N + col + e) * C + c0 + q])
                                                    : 0.f;
              }
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                if (rr + 8 * hh >= R) continue;
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  int& slot_v = acc[4 * jj + 2 * hh + e];
                  if (c0 == 0) {  // h once; its bits replace the accumulator for the later passes
                    v[e] = 0.f;
                    if (col + e < N) {
                      float a = __int2float_rn(slot_v);
                      if (zp) a = __fadd_rn(a, zv[e]);
                      v[e] = to_f(from_f<T>(softplus(__fadd_rn(__fmul_rn(a, __fmul_rn(xs[hh], sv[e])), cv[e]))));
                    }
                    slot_v = __float_as_int(v[e]);
                  } else {
                    v[e] = __int_as_float(slot_v);
                  }
                }
#pragma unroll
                for (int q = 0; q < CLASSES; ++q)
                  rs[hh][q] = fmaf(v[1], w4v[1][q], fmaf(v[0], w4v[0][q], rs[hh][q]));
              }
            }
            rotate<4 * EPI_U>(acc);
          }
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int q = 0; q < CLASSES; ++q) {
              float v = rs[hh][q];
              v += __shfl_xor_sync(0xffffffffu, v, 1);  // the 4 lanes of a row, in a fixed order
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              if (t4 == 0 && rr + 8 * hh < R && c0 + q < C) __stcg(slot + (size_t)(rr + 8 * hh) * C + c0 + q, v);
            }
        }
      }
      // Count the tile in once every slab's slot rows are written (each
      // thread's fence, then the barrier); the last of the (member, row
      // tile)'s column tiles sums the slots in column-tile order: the order
      // is the shape's, whoever is last.
      __threadfence();
      consumers_sync();
      int* count = reinterpret_cast<int*>(lin4_work) + (size_t)m * sc.row_tiles + rt;
      if (threadIdx.x == 0) last[1] = atomic_add_acq_rel(count, 1) == sc.col_tiles - 1;
      consumers_sync();
      if (last[1]) {
        __threadfence();
        const int n_rows = min(BM, R - tile_row0);
        const float* first = slots + (size_t)m * sc.col_tiles * R * C;
        for (int i = threadIdx.x; i < n_rows * C; i += SLABS * 128) {
          const size_t rc = (size_t)tile_row0 * C + i;  // row tile_row0 + i / C, class i % C
          float v = 0.f;
          for (int j0 = 0; j0 < sc.col_tiles; j0 += 16) {  // 16 loads in flight, then the adds in order
            float u[16];
#pragma unroll
            for (int q = 0; q < 16; ++q) u[q] = j0 + q < sc.col_tiles ? __ldcg(first + (size_t)(j0 + q) * R * C + rc) : 0.f;
#pragma unroll
            for (int q = 0; q < 16; ++q)
              if (j0 + q < sc.col_tiles) v = j0 + q == 0 ? u[q] : v + u[q];
          }
          out[(size_t)m * R * C + rc] = v;
        }
        if (threadIdx.x == 0) *count = 0;  // a graph replay starts clean
      }
    }
  }
}

// The GEMM on the schedule sc (kernels/int8_linear.py::gemm_plan). xq: (M,
// R, K) int8 codes, wt: the (M, N, K) int8 weight, both 16-byte aligned, K
// a multiple of 16. split_work: the plan's workspace (a count a split tile,
// then a partial tile a block; null where no tile is split; its counts are
// zeroed here). lin4_work: LIN4's workspace, its counts zero (null for
// STORE).
template <typename T, int EPI>
int launch_gemm(const int8_t* xq, const float* xmax, const void* wt, const void* s, const void* c,
                const void* colsum, void* h, void* hmax, const void* w4, void* out, void* split_work,
                void* lin4_work, int M, int R, int K, int N, int C, const hopper::WgSched& sc, cudaStream_t st) {
  const bool split = sc.grid > 0 && sc.tiles % sc.grid > 0 && sc.chunks > 1;
  if (!hopper::sched_ok(sc, M, MAX_REM) || (split && split_work == nullptr) || K % 16 != 0 ||
      (long long)sc.row_tiles * BM < R || (long long)sc.col_tiles * BN < N || sc.steps != (K + BK - 1) / BK ||
      (EPI == LIN4 && lin4_work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap, bmap;  // xq as (K, R, M) in 128 x 64 boxes, w as (K, N, M) in 128 x 128
  if (!hopper::s8_map_3d(&amap, xq, K, R, M, BK, 64) || !hopper::s8_map_3d(&bmap, wt, K, N, M, BK, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_gemm_kernel<T, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err == cudaSuccess && split) err = cudaMemsetAsync(split_work, 0, FLAG_BYTES, st);  // the split tiles' counts
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<sc.grid, THREADS, SMEM_BYTES, st>>>(
      amap, bmap, xmax, static_cast<const float*>(s), static_cast<const float*>(c),
      static_cast<const float*>(colsum), static_cast<T*>(h), static_cast<float*>(hmax),
      static_cast<const T*>(w4), static_cast<float*>(out), static_cast<unsigned char*>(split_work),
      static_cast<unsigned char*>(lin4_work), M, R, K, N, C, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace int8k
