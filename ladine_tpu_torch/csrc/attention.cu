// One-shot fused attention for the ViT guidance backbone, Hopper (sm_90a).
//
//   o = softmax(q k^T * D^-0.5) v   on the JAX layout (B, N, H, D)
//
// Replaces the TPU kernel ladine_tpu/kernels/attention.py:54 flash_attention
// (body _attn_kernel, :31). As that kernel is built on, at ViT lengths the
// whole score row of a query is one tile: S = Q K^T once, the exact row max
// and sum, p = exp(s - m) / l in fp32, p rounded to v's type, then P V. There
// is no online rescaling and no second pass over the keys. q, k and v may be
// strided views sharing one stride pattern (the slices of the fused qkv
// projection); the output is contiguous (B, N, H, D). Three bodies, chosen by
// kernels/attention.py::attention_plan from the shape, dtype and layout:
//
// wgmma (bf16, D = 64, N <= 256, a layout a TMA tensor map describes: every
// ViT-B/16 and DeiT head; also D = 8, 16, ... 48 as zero-padded 64-column
// boxes, ConViT's 48 among them). What bounds it: at (70, 197, 12, 64), the
// evidence batch, a call reads q, k, v and writes o once, 84.7 MB (0.0253 ms
// at 3.35 TB/s), against 4 B H N^2 D = 8.3 GFLOP (0.0084 ms at 989 TFLOP/s):
// the bytes; at batch 8 (196 tokens, 9.6 MB: 0.0029 ms) the bytes too, but
// then 96 (b, h) pairs are fewer than the 132 SMs, so a call is a few tile
// times and its loads' latency. The old mma body (below) computed S twice,
// copied K and V with its compute threads, once for every 64 query rows, and
// fit 3 blocks an SM. Its design:
//  - Copies by TMA. q, k and v each have a tensor map over (D, H, N, B) with
//    their strides; a box is (64, 1, rows, 1) with the 128-byte swizzle, keys
//    past N (the key axis is rounded up to 16, `keys`), query rows past N
//    and columns past D arrive as zeros. One thread of a producer warpgroup
//    (setmaxnreg gives its registers to the consumers) loads a unit's K, V
//    and query tiles into one of 2 stages, with a full and an empty
//    mbarrier each, so the next unit's K and V are in flight while the
//    consumers work on this one (a 3-stage ring measured the same).
//  - One score product. Two consumer warpgroups each take a 64-row query
//    tile: S = Q K^T by wgmma (Q from shared memory, K as a K-major B), the
//    whole key axis at once in registers (m64n64k16 chunks and m64n16k16
//    tails; 104 fp32 a thread at 208 keys). The row max and sum are exact
//    (the 4 lanes of a row combine theirs with shuffles; only the last 16
//    keys can be masked; exp is 2^x of one FMA on the unscaled score);
//    p = exp(s - m) / l in fp32 is rounded to bf16 straight into the A
//    registers of the second product (an m64 x 16 slice of the accumulator
//    is the A fragment of a k16 step), and O = P V by wgmma with A from
//    registers and V as an MN-major B. O is stored from its fp32
//    accumulators as bf16 pairs.
//  - A grid that fills the card (kernels/attention.py::attention_plan): a
//    unit is a (b, h) pair's query tiles or a share of them (`splits` a
//    pair), units b, b + grid, ... on min(132, units) persistent blocks, one
//    an SM (140 KB of shared memory at 208 keys and 2 tiles a unit).
//    The split is the one with the fewest tile rounds, then the most blocks:
//    at batch 8 (96 pairs of 4 query tiles) 2 units a pair on 132 blocks; at
//    batch 70 (840 pairs) 2 units a pair, 1680 units on 132 blocks (13
//    rounds where whole pairs take 14). K and V of a pair leave L2 once for
//    each unit.
//  - Deterministic: no atomics, every sum in a fixed order.
//  Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2): 0.0109 ms
//  at batch 8 (SDPA 0.0120; the mma body 0.0150), 0.0234 at (30, 197, 12,
//  64), 0.0449 at batch 70 (SDPA 0.0506; the mma body 0.0960): 1.8 x its
//  bound there.
//
// mma (bf16, the shapes wgmma does not take: N > 256 (the card tests run
// 300), D > 64 or not a multiple of 8 (the digits ViT's 12), a layout off
// TMA's 16-byte strides (the digits' 24-byte heads)). One block of 4 warps
// per (64 query rows, head, batch), mma.sync.m16n8k16: cp.async copies the
// whole K (with the Q tile) and V of the block's (b, h) into shared memory
// in vectors of 16, 8 or 4 bytes (the widest the strides and D allow), the
// head padded with zeros to the next multiple of 16 (no copy of q, k or v:
// D = 12 reads 24-byte rows at the real D and fills columns 12 .. 15 with
// zeros; the copies it replaced made the digits' call 0.0209 ms, it now
// takes 0.0042, H100 80GB HBM3 at 700 W), rows padded by 16 bytes so that
// ldmatrix reads them without bank conflicts, and keys zero-filled up to a
// multiple of the 32-key chunk. Each warp keeps its 16 query rows' Q
// fragments in registers; pass 1 takes the row max and sum over 32-key
// chunks of S, pass 2 recomputes each chunk, forms p, rounds it into the A
// fragments of P V and accumulates O with V's fragments read by
// ldmatrix.trans. Only the real D columns are stored.
//
// simt (fp32, any D of whole 16-byte vectors: 12, 48, 64, ...). What bounds
// it: at (70, 197, 12, 64) 8.3 GFLOP at 67 TFLOP/s, 0.1246 ms (the bytes
// take 0.051). The scalar body it replaces (16 query rows a block, one key a
// lane, ~2 FMA a shared-memory load) took 2.00 ms there. Its design: a block
// of 512 threads per (128 query rows, head, batch) where that leaves two
// blocks an SM (batch 30 and 70), else 256 per 64 rows, so K and V leave L2
// once for every 128 (or 64) rows (cp.async; V lands while S is computed).
// Both products are register-tiled, 4 x 4 outputs a thread from 16-byte
// shared-memory reads without bank conflicts (a K or V row is an odd number
// of 16-byte vectors): S as 4 rows x 4 keys a 64-key pass, 16 FMA for 2
// loads (the last keys 16 a pass, so that at 197 keys 208 are computed and
// not 256), stored transposed (key-major) with its scale; then the softmax
// in fp32 in the plain version's order (max, exp, sum, divide, each thread
// on the entries it wrote); then O as 4 rows x 4 columns, a float4 of P and
// one of V for 16 FMA. Where K, V, the Q tile and the scores pass 227 KB
// (128 rows at D = 64; N > 263 at 64 rows), V is loaded into K's place, 64
// keys at a time as S is done with them, so the body takes every N and D
// the scalar body took. TF32 is not used: it cannot hold 1e-4 against the
// plain version. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 2): 0.4449 ms at batch 70 (SDPA 0.4504), 0.2087 at (30, 197, 12,
// 64) (SDPA 0.2025), 0.2298 at (30, 197, 16, 48) (SDPA 0.2577): 3.6 x its
// bound at batch 70, one block of 16 warps an SM whose K, Q and V loads
// wait on device memory between its FMA phases. 8 rows a thread (more FMA
// a load, half the warps) measured 1-5 % slower (a scratch variant).
//
// The TPU kernel's padding to 128 lanes and its -0.7 * f32max mask of padded
// keys have no counterpart: masked keys are skipped or take -inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tma_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace bf16mma;

enum Route { WGMMA = 0, MMA = 1, SIMT = 2 };

constexpr float LOG2E = 1.4426950408889634f;

// ---- wgmma body (bf16, D = 64) ------------------------------------------------

namespace wg {
constexpr int CONSUMERS = 2;                     // warpgroups, one 64-row query tile at a time
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int D = 64, ROW_BYTES = D * 2, TILE_BYTES = 64 * ROW_BYTES;  // a row: one 128-byte swizzle span
// (a head of D < 64 arrives in a 64-column box whose columns past D are
// outside its tensor map: zeros, which add nothing to q k^T)
constexpr int KEY_STEP = 16, MAX_KEYS = 256, STAGES = 2;
__host__ __device__ inline int stage_bytes(int keys, int tpu) { return 2 * keys * ROW_BYTES + tpu * TILE_BYTES; }
__host__ inline size_t smem_bytes(int keys, int tpu) { return 128 + 1024 + (size_t)STAGES * stage_bytes(keys, tpu); }
}  // namespace wg

// The schedule of kernels/attention.py::attention_plan: q_tiles 64-row
// query tiles a (b, h) pair, split into `splits` units of tpu tiles each;
// unit u is split u % splits of pair u / splits (pair = b * H + h).
struct Sched {
  int q_tiles, tpu, splits, units;
};

// 2^x (the approximate MUFU form, flushing denormals: p's bf16 rounding
// is far coarser)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The producer's first thread loads each unit's K, V and query tiles into a
// stage; consumer warpgroup w takes the unit's tiles w, w + CONSUMERS, ...
// NK: the key axis in shared memory (N rounded up to KEY_STEP).
template <int NK>
__global__ void __launch_bounds__(wg::THREADS, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int N, int H, int D,
                       float scale_log2, Sched s) {
  using namespace hopper;
  constexpr int KV = NK * wg::ROW_BYTES;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(wg_smem);
  uint64_t* empty = full + wg::STAGES;
  const uint32_t base = smem_u32(wg_smem);
  unsigned char* ring = wg_smem + (((base + 128 + 1023) & ~1023u) - base);  // 1024-aligned for the swizzle
  const int stage_bytes = wg::stage_bytes(NK, s.tpu);
  const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < wg::STAGES; ++i) {
      mbar_init(&full[i], 1);                    // the producer's expect_tx arrival (+ the bytes)
      mbar_init(&empty[i], wg::CONSUMERS * 4);   // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi == wg::CONSUMERS) {  // ---- producer
    regs_dealloc<40>();
    if (t != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const int pair = u / s.splits, split = u % s.splits, h = pair % H, b = pair / H;
      mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* st = ring + stage * stage_bytes;
      mbar_expect_tx(&full[stage], stage_bytes);
      tma_load_4d(st, &kmap, &full[stage], 0, h, 0, b);
      tma_load_4d(st + KV, &vmap, &full[stage], 0, h, 0, b);
      tma_load_4d(st + 2 * KV, &qmap, &full[stage], 0, h, split * s.tpu * 64, b);
      if (++stage == wg::STAGES) stage = 0, phase ^= 1;
    }
    return;
  }

  // ---- consumers
  regs_alloc<232>();
  const int warp = t / 32, lane = t % 32, g = lane / 4, t4 = lane % 4;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
    const int pair = u / s.splits, split = u % s.splits, h = pair % H, b = pair / H;
    mbar_wait(&full[stage], phase);
    const uint32_t kaddr = smem_u32(ring + stage * stage_bytes), vaddr = kaddr + KV;
    for (int i = wgi; i < s.tpu; i += wg::CONSUMERS) {
      const int tile = split * s.tpu + i;
      if (tile >= s.q_tiles) break;
      const uint32_t qaddr = kaddr + 2 * KV + i * wg::TILE_BYTES;

      // S = Q K^T: s[4 j + e] is row 16 warp + g + 8 (e / 2), key 8 j + 2 t4 + e % 2
      float sc[NK / 2];
#pragma unroll
      for (int v = 0; v < NK / 2; ++v) sc[v] = 0.f;
#pragma unroll
      for (int v = 0; v < NK / 2; ++v) fence_operand(sc[v]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < wg::D / 16; ++kk) {
        const uint64_t da = desc_sw128(qaddr + 32 * kk, 16, 1024);
#pragma unroll
        for (int c = 0; c < NK / 64; ++c)
          wgmma_m64n64k16_kmajor(sc + 32 * c, da, desc_sw128(kaddr + c * 64 * wg::ROW_BYTES + 32 * kk, 16, 1024));
#pragma unroll
        for (int c = NK / 64 * 4; c < NK / 16; ++c)
          wgmma_m64n16k16_kmajor(sc + 8 * c, da, desc_sw128(kaddr + c * 16 * wg::ROW_BYTES + 32 * kk, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int v = 0; v < NK / 2; ++v) fence_operand(sc[v]);

      // the exact row max (rows g and g + 8) of the unscaled scores (the
      // scale is positive), masked keys -inf: only the last KEY_STEP keys can
      // lie past N; then exp(s - m) as 2^(s log2(e) D^-0.5 - m'), one FMA
      float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& x = sc[4 * j + e];
          if (j >= NK / 8 - 2 && 8 * j + 2 * t4 + (e & 1) >= N) x = -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int off = 1; off <= 2; off *= 2) mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], off));
      const float ms[2] = {mx[0] * scale_log2, mx[1] * scale_log2};
#pragma unroll
      for (int v = 0; v < NK / 2; ++v) {
        sc[v] = ex2(fmaf(sc[v], scale_log2, -ms[(v % 4) / 2]));
        sum[(v % 4) / 2] += sc[v];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int off = 1; off <= 2; off *= 2) sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], off);
      const float inv[2] = {1.f / sum[0], 1.f / sum[1]};

      // p = exp(s - m) / l rounded to bf16: the A fragments of k16 step kk
      uint32_t pa[NK / 16][4];
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk) {
        const float* p = sc + 8 * kk;
        pa[kk][0] = pack_bf16(p[0] * inv[0], p[1] * inv[0]);
        pa[kk][1] = pack_bf16(p[2] * inv[1], p[3] * inv[1]);
        pa[kk][2] = pack_bf16(p[4] * inv[0], p[5] * inv[0]);
        pa[kk][3] = pack_bf16(p[6] * inv[1], p[7] * inv[1]);
      }

      // O = P V
      float oc[32];
#pragma unroll
      for (int v = 0; v < 32; ++v) oc[v] = 0.f;
#pragma unroll
      for (int v = 0; v < 32; ++v) fence_operand(oc[v]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NK / 16; ++kk)
        wgmma_m64n64k16_rs(oc, pa[kk], desc_sw128(vaddr + 16 * kk * wg::ROW_BYTES, KV, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int v = 0; v < 32; ++v) fence_operand(oc[v]);

#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = tile * 64 + 16 * warp + g + 8 * hh;
        if (r >= N) continue;
        bf16* orow = o + (((size_t)b * N + r) * H + h) * D + 2 * t4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (8 * j < D)  // D is a multiple of 8
            *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(oc[4 * j + 2 * hh], oc[4 * j + 2 * hh + 1]);
      }
    }
    if (lane == 0) mbar_arrive(&empty[stage]);  // every product of the stage has completed
    if (++stage == wg::STAGES) stage = 0, phase ^= 1;
  }
}

template <int NK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int N, int H, int D, long long sb,
                 long long sn, long long sh, float scale, const Sched& s, int grid, cudaStream_t st) {
  if (s.tpu < 1 || s.tpu * 64 > 256 || s.splits < 1 || s.units != B * H * s.splits || grid < 1 || grid > s.units ||
      (s.splits - 1) * s.tpu >= s.q_tiles || s.q_tiles * 64 < N)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;  // (D, H, N, B) at the views' strides, in bytes; 64-column boxes
  const uint64_t s1 = 2 * (uint64_t)sh, s2 = 2 * (uint64_t)sn, s3 = 2 * (uint64_t)sb;
  if (!hopper::bf16_map_4d(&qm, q, D, H, N, B, s1, s2, s3, 64, s.tpu * 64) ||
      !hopper::bf16_map_4d(&km, k, D, H, N, B, s1, s2, s3, 64, NK) ||
      !hopper::bf16_map_4d(&vm, v, D, H, N, B, s1, s2, s3, 64, NK))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = wg::smem_bytes(NK, s.tpu);
  cudaError_t err =
      cudaFuncSetAttribute(attention_wgmma_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_wgmma_kernel<NK><<<grid, wg::THREADS, bytes, st>>>(qm, km, vm, static_cast<bf16*>(o), N, H, D,
                                                               scale * LOG2E, s);
  return static_cast<int>(cudaGetLastError());
}

// ---- mma body (bf16, other D and N) ------------------------------------------

constexpr int MQ = 64;  // query rows per block, 16 a warp
constexpr int MMA_THREADS = 128;
constexpr int KC = 32;  // keys per chunk of the key loop

__host__ __device__ inline int keys_padded(int N) { return (N + KC - 1) / KC * KC; }

__host__ inline size_t mma_smem_bytes(int N, int DP) {
  return (size_t)(2 * keys_padded(N) + MQ) * (DP + 8) * sizeof(bf16);
}

// `vb` bytes from src into shared dst (vb = 16, 8 or 4); src_bytes = 0
// zero-fills the destination (the masked edge and the padded head)
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src, int vb, bool ok) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? vb : 0;
  if (vb == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else if (vb == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// rows [0, rows) of a (B, N, H, D) view at (b, h) from row r0, D real
// columns in vectors of vb bytes, into a tile of DP columns (zeros past D and
// past N) with row stride LD
template <int DP, int LD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, size_t base, long long sn, int r0, int rows,
                                           int N, int D, int vb, int tid) {
  const int per_row = DP * 2 / vb, ve = vb / 2;  // vectors a padded row, elements a vector
  for (int i = tid; i < rows * per_row; i += MMA_THREADS) {
    const int r = i / per_row, c = (i % per_row) * ve;
    const bool ok = r0 + r < N && c < D;
    cp_async_vec(dst + r * LD + c, src + (ok ? base + (size_t)(r0 + r) * sn + c : 0), vb, ok);
  }
}

template <int DK>  // padded head: DP = 16 * DK
__global__ void __launch_bounds__(MMA_THREADS)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     bf16* __restrict__ o, int N, int H, int D, long long sb, long long sn, long long sh,
                     float scale_log2, int vb) {
  constexpr int DP = 16 * DK, LD = DP + 8;  // LD: row stride, 16 bytes of padding
  extern __shared__ __align__(16) unsigned char smem[];
  const int NP = keys_padded(N);
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + (size_t)NP * LD;
  bf16* Qs = Vs + (size_t)NP * LD;

  const int q0 = blockIdx.x * MQ, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4, mi = lane / 8, mr = lane % 8;

  // group 0: K and the Q tile; group 1: V
  stage_rows<DP, LD>(Ks, k, base, sn, 0, NP, N, D, vb, tid);
  stage_rows<DP, LD>(Qs, q, base, sn, q0, MQ, N, D, vb, tid);
  cp_async_commit();
  stage_rows<DP, LD>(Vs, v, base, sn, 0, NP, N, D, vb, tid);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int wr = warp * 16;            // the warp's first row in the tile
  const bool active = q0 + wr < N;     // warp-uniform: a ragged last tile
  uint32_t qa[DK][4];
  if (active) {
#pragma unroll
    for (int dk = 0; dk < DK; ++dk) ldmatrix_x4(qa[dk], Qs + (wr + lane % 16) * LD + dk * 16 + (lane / 16) * 8);
  }

  // s[j][e]: row g + 8 * (e / 2), key kc * KC + 8 * j + 2 * t4 + e % 2, as
  // s * D^-0.5 * log2(e); masked keys get -1e30 (exp2 of it minus a real
  // max is 0, and no inf - inf can arise)
  auto scores = [&](int kc, float (&s)[4][4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int dk = 0; dk < DK; ++dk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t kb[4];  // B fragments of keys +0..7 and +8..15, d 16 dk .. + 15
        ldmatrix_x4(kb, Ks + (kc * KC + half * 16 + (mi / 2) * 8 + mr) * LD + dk * 16 + (mi % 2) * 8);
        mma(s[2 * half], qa[dk], kb[0], kb[1]);
        mma(s[2 * half + 1], qa[dk], kb[2], kb[3]);
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int key = kc * KC + 8 * j + 2 * t4 + (e % 2);
        s[j][e] = key < N ? s[j][e] * scale_log2 : -1e30f;
      }
  };

  // pass 1: running max m and sum l of exp2(s - m), rows g and g + 8
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  if (active) {
    for (int kc = 0; kc < NP / KC; ++kc) {
      float s[4][4];
      scores(kc, s);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        float sum = l[hh] * exp2f(m[hh] - mx);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum += exp2f(s[j][2 * hh] - mx) + exp2f(s[j][2 * hh + 1] - mx);
        m[hh] = mx, l[hh] = sum;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int off = 1; off <= 2; off *= 2) {  // the 4 lanes of a row
        float mo = __shfl_xor_sync(0xffffffffu, m[hh], off);
        float lo = __shfl_xor_sync(0xffffffffu, l[hh], off);
        float mx = fmaxf(m[hh], mo);
        l[hh] = l[hh] * exp2f(m[hh] - mx) + lo * exp2f(mo - mx);
        m[hh] = mx;
      }
  }

  cp_async_wait<0>();  // V has landed
  __syncthreads();
  if (!active) return;

  // pass 2: p = exp2(s - m) / l rounded to bf16, O += P V
  float acc[2 * DK][4];
#pragma unroll
  for (int j = 0; j < 2 * DK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  for (int kc = 0; kc < NP / KC; ++kc) {
    float s[4][4];
    scores(kc, s);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float p[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[jj][e] = exp2f(s[2 * half + jj][e] - m[e / 2]) * inv[e / 2];
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dj = 0; dj < DK; ++dj) {
        uint32_t vbf[4];  // B fragments of d tiles 2 dj and 2 dj + 1, keys +0..15
        ldmatrix_x4_trans(vbf, Vs + (kc * KC + half * 16 + (mi % 2) * 8 + mr) * LD + dj * 16 + (mi / 2) * 8);
        mma(acc[2 * dj], pa, vbf[0], vbf[1]);
        mma(acc[2 * dj + 1], pa, vbf[2], vbf[3]);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    int r = q0 + wr + g + 8 * hh;
    if (r >= N) continue;
    bf16* orow = o + (((size_t)b * N + r) * H + h) * D + 2 * t4;
#pragma unroll
    for (int j = 0; j < 2 * DK; ++j)
      if (8 * j + 2 * t4 < D)  // D is even: a pair is whole
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
}

template <int DK>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int N, int H, int D, long long sb,
               long long sn, long long sh, float scale, int vb, cudaStream_t s) {
  if ((vb != 16 && vb != 8 && vb != 4) || (2 * D) % vb != 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = mma_smem_bytes(N, 16 * DK);
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + MQ - 1) / MQ, H, B);
  attention_mma_kernel<DK><<<grid, MMA_THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), N, H, D, sb, sn, sh, scale * LOG2E, vb);
  return static_cast<int>(cudaGetLastError());
}

// ---- simt body (fp32, register-tiled) ----------------------------------------

namespace simt {
// K, V and Q row stride in floats: D plus one vector where D / 4 is even, so
// that 8 consecutive rows start in 8 different 16-byte bank groups
__host__ __device__ inline int ld(int D) { return D + ((D / 4) % 2 == 0 ? 4 : 0); }
// the transposed scores' row stride: ROWS + 4, an odd number of vectors at 64 and 128 rows
__host__ __device__ constexpr int lds(int rows) { return rows + 4; }
// K, the Q tile, V (late_v: in K's place once S is done), the scores
__host__ inline size_t smem_bytes(int N, int D, int rows, bool late_v) {
  return ((size_t)((late_v ? 1 : 2) * N + rows) * ld(D) + (size_t)N * lds(rows)) * sizeof(float);
}
}  // namespace simt

// S for rows r0 .. r0 + RPT - 1 of the Q tile (qr: row r0) at keys key,
// key + 16, ... (G of them), scaled, into St; each row's running max in mx.
// Keys past N are read at N - 1 and not kept.
template <int RPT, int G, int LDS>
__device__ __forceinline__ void simt_scores(const float* qr, const float* Ks, float* St, int ldk, int D, int N,
                                            int key, int r0, float scale, float (&mx)[RPT]) {
  const float* kr[G];
#pragma unroll
  for (int j = 0; j < G; ++j) kr[j] = Ks + min(key + 16 * j, N - 1) * ldk;
  float acc[RPT][G];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int j = 0; j < G; ++j) acc[r][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[RPT], kv[G];
#pragma unroll
    for (int r = 0; r < RPT; ++r) qv[r] = *reinterpret_cast<const float4*>(qr + r * ldk + d);
#pragma unroll
    for (int j = 0; j < G; ++j) kv[j] = *reinterpret_cast<const float4*>(kr[j] + d);
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        acc[r][j] = fmaf(qv[r].x, kv[j].x, acc[r][j]);
        acc[r][j] = fmaf(qv[r].y, kv[j].y, acc[r][j]);
        acc[r][j] = fmaf(qv[r].z, kv[j].z, acc[r][j]);
        acc[r][j] = fmaf(qv[r].w, kv[j].w, acc[r][j]);
      }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (key + 16 * j >= N) continue;
#pragma unroll
    for (int i = 0; i < RPT / 4; ++i) {
      const float4 sv = make_float4(acc[4 * i][j] * scale, acc[4 * i + 1][j] * scale, acc[4 * i + 2][j] * scale,
                                    acc[4 * i + 3][j] * scale);
      *reinterpret_cast<float4*>(St + (key + 16 * j) * LDS + r0 + 4 * i) = sv;
      mx[4 * i] = fmaxf(mx[4 * i], sv.x), mx[4 * i + 1] = fmaxf(mx[4 * i + 1], sv.y);
      mx[4 * i + 2] = fmaxf(mx[4 * i + 2], sv.z), mx[4 * i + 3] = fmaxf(mx[4 * i + 3], sv.w);
    }
  }
}

// One block per (ROWS query rows, head, batch) of 16 x ROWS / RPT threads:
// thread (ty, tx) owns rows RPT ty .. RPT ty + RPT - 1 of the tile, with the
// keys tx + 16 j for S and the columns 4 cg .. 4 cg + 3 (cg = tx, tx + 16,
// ...) for O.
template <int ROWS, int RPT>
__global__ void __launch_bounds__(16 * ROWS / RPT)
attention_simt_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      float* __restrict__ o, int N, int H, int D, long long sb, long long sn, long long sh,
                      float scale, bool late_v) {
  constexpr int THREADS = 16 * ROWS / RPT, LDS = simt::lds(ROWS);
  extern __shared__ __align__(16) float fsm[];
  const int ldk = simt::ld(D), vpr = D / 4;
  float* Ks = fsm;
  float* Qs = Ks + (size_t)N * ldk;
  float* Vs = late_v ? Ks : Qs + ROWS * ldk;
  float* St = (late_v ? Qs + ROWS * ldk : Vs + (size_t)N * ldk);  // St[key * LDS + row]: the scores, then p

  const int q0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16, r0 = RPT * ty;

  auto load_rows = [&](float* dst, const float* src, int first, int rows) {
    for (int i = tid; i < rows * vpr; i += THREADS) {
      const int r = i / vpr, d = (i % vpr) * 4;
      const bool ok = first + r < N;
      cp_async16(dst + r * ldk + d, src + (ok ? base + (size_t)(first + r) * sn + d : 0), ok ? 16 : 0);
    }
  };
  // group 0: K and the Q tile; group 1: V, landing while S is computed
  // (late_v: where K, Q and V together pass a block's shared memory, V
  // comes into K's place, 64 keys at a time as S is done with them)
  load_rows(Ks, k, 0, N);
  load_rows(Qs, q, q0, ROWS);
  cp_async_commit();
  if (!late_v) {
    load_rows(Vs, v, 0, N);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  // S * D^-0.5 for keys tx + 16 j: 64 keys a pass, the last chunk's 16 a pass
  float mx[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) mx[r] = -INFINITY;
  const float* qr = Qs + r0 * ldk;
  const int chunks = (N + 63) / 64;
  for (int c = 0; c < chunks; ++c) {
    if (late_v && c > 0) {
      __syncthreads();  // every thread is done with K's chunk c - 1
      load_rows(Vs + (size_t)64 * (c - 1) * ldk, v, 64 * (c - 1), 64);
      cp_async_commit();
    }
    if (64 * c + 64 <= N) {
      simt_scores<RPT, 4, LDS>(qr, Ks, St, ldk, D, N, 64 * c + tx, r0, scale, mx);
    } else {
      for (int key0 = 64 * c; key0 < N; key0 += 16)
        simt_scores<RPT, 1, LDS>(qr, Ks, St, ldk, D, N, key0 + tx, r0, scale, mx);
    }
  }
  if (late_v) {
    __syncthreads();  // every thread is done with K
    load_rows(Vs + (size_t)64 * (chunks - 1) * ldk, v, 64 * (chunks - 1), N - 64 * (chunks - 1));
    cp_async_commit();
  }

  // softmax in the plain version's order: the row max (the 16 lanes tx of a
  // row are a half-warp), exp, the sum, then the division, each thread on
  // the entries it wrote
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int off = 8; off > 0; off /= 2) mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
  float sum[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) sum[r] = 0.f;
  for (int key = tx; key < N; key += 16) {
#pragma unroll
    for (int i = 0; i < RPT / 4; ++i) {
      float4* p = reinterpret_cast<float4*>(St + key * LDS + r0 + 4 * i);
      float4 e = *p;
      e.x = expf(e.x - mx[4 * i]), e.y = expf(e.y - mx[4 * i + 1]);
      e.z = expf(e.z - mx[4 * i + 2]), e.w = expf(e.w - mx[4 * i + 3]);
      sum[4 * i] += e.x, sum[4 * i + 1] += e.y, sum[4 * i + 2] += e.z, sum[4 * i + 3] += e.w;
      *p = e;
    }
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int off = 8; off > 0; off /= 2) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
  for (int key = tx; key < N; key += 16) {
#pragma unroll
    for (int i = 0; i < RPT / 4; ++i) {
      float4* p = reinterpret_cast<float4*>(St + key * LDS + r0 + 4 * i);
      float4 e = *p;
      e.x /= sum[4 * i], e.y /= sum[4 * i + 1], e.z /= sum[4 * i + 2], e.w /= sum[4 * i + 3];
      *p = e;
    }
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();     // ... and every row's p is written

  // O = P V: RPT rows x 4 columns a thread, a float4 of P for each 4 rows
  // and one of V a key
  for (int cg = tx; cg < vpr; cg += 16) {
    float acc[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    const float* pp = St + r0;
    const float* vp = Vs + 4 * cg;
#pragma unroll 4
    for (int j = 0; j < N; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(vp + j * ldk);
#pragma unroll
      for (int i = 0; i < RPT / 4; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(pp + j * LDS + 4 * i);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[4 * i + r][0] = fmaf(pr[r], w.x, acc[4 * i + r][0]);
          acc[4 * i + r][1] = fmaf(pr[r], w.y, acc[4 * i + r][1]);
          acc[4 * i + r][2] = fmaf(pr[r], w.z, acc[4 * i + r][2]);
          acc[4 * i + r][3] = fmaf(pr[r], w.w, acc[4 * i + r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = q0 + r0 + r;
      if (row < N)
        *reinterpret_cast<float4*>(o + (((size_t)b * N + row) * H + h) * D + 4 * cg) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
}

template <int ROWS, int RPT>
int launch_simt(const void* q, const void* k, const void* v, void* o, int B, int N, int H, int D, long long sb,
                long long sn, long long sh, float scale, bool late_v, cudaStream_t s) {
  if (D % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  size_t bytes = simt::smem_bytes(N, D, ROWS, late_v);
  cudaError_t err = cudaFuncSetAttribute(attention_simt_kernel<ROWS, RPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + ROWS - 1) / ROWS, H, B);
  attention_simt_kernel<ROWS, RPT><<<grid, 16 * ROWS / RPT, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), N, H, D, sb, sn, sh, scale, late_v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of a launch: route 0 wgmma (keys, tpu), 1 mma (N, the
// padded D), 2 simt (N, D, rows, late_v); the numbers of
// kernels/attention.py::attention_plan.
extern "C" long long flash_attention_smem_bytes(int route, int N, int D, int keys, int rows, int tpu, int late_v) {
  if (route == WGMMA) return (long long)wg::smem_bytes(keys, tpu);
  if (route == MMA) return (long long)mma_smem_bytes(N, D);
  return (long long)simt::smem_bytes(N, D, rows, late_v != 0);
}

// route, keys, the schedule and grid: kernels/attention.py::attention_plan;
// vb: the mma body's copy width in bytes (16, 8 or 4); rows and threads:
// the simt body's block (64 rows of 256 threads or 128 of 512);
// late_v: the simt body loads V after S. D is the real head width (its
// scale, its output columns); the mma body pads it to dp, a multiple of 16.
// Anything else is refused with cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                                      int D, long long sb, long long sn, long long sh, float scale, int route,
                                      int dp, int vb, int keys, int rows, int q_tiles, int tpu, int splits,
                                      int units, int grid, int threads, int late_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == SIMT) {
    const bool late = late_v != 0;
    if (rows == 64 && threads == 256) return launch_simt<64, 4>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, late, s);
    if (rows == 128 && threads == 512) return launch_simt<128, 4>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, late, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == MMA) {
    if (D > dp) return static_cast<int>(cudaErrorInvalidValue);
    switch (dp) {
      case 16: return launch_mma<1>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, vb, s);
      case 32: return launch_mma<2>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, vb, s);
      case 48: return launch_mma<3>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, vb, s);
      case 64: return launch_mma<4>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, vb, s);
      case 80: return launch_mma<5>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, vb, s);
      case 96: return launch_mma<6>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, vb, s);
      case 112: return launch_mma<7>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, vb, s);
      case 128: return launch_mma<8>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, vb, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (route != WGMMA || D % 8 != 0 || D > wg::D || N > keys || keys % wg::KEY_STEP != 0 || keys > wg::MAX_KEYS)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sched sc{q_tiles, tpu, splits, units};
#define K3_WG(nk) \
  case nk: return launch_wgmma<nk>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, sc, grid, s);
  switch (keys) {
    K3_WG(16) K3_WG(32) K3_WG(48) K3_WG(64) K3_WG(80) K3_WG(96) K3_WG(112) K3_WG(128)
    K3_WG(144) K3_WG(160) K3_WG(176) K3_WG(192) K3_WG(208) K3_WG(224) K3_WG(240) K3_WG(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K3_WG
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
