// Fused member-stacked linear + affine + softplus (+ gate) for Hopper (sm_90a).
//
//   out[m] = softplus((x[m] @ w[m]) * a[m] + c[m]) [* mult[m]]
//   x: (M, R, K)  w: (M, K, N)  a, c: (M, N) fp32  mult, out: (M, R, N)
//   mult in x's dtype, or fp32 beside bf16 x (lin1's gate, the fp32 features)
//
// Replaces the TPU kernel ladine_tpu/kernels/fused_linear.py::fused_linear_act
// (bodies _kernel and _kernel_mult). It is the eps layer of every reverse
// diffusion step: lin1 (K = 2C = 4, with the f gate as mult), lin2 and lin3
// (K = N = 4096), 3 launches a step. The member axis is in the grid: one
// launch covers all members. Five bodies, chosen by the wrapper from the
// shape and dtype (kernels/fused_linear.py::plan):
//
// small_k (K <= 32, both dtypes; lin1 up to 16 classes, K = 4 at 2). An
// outer product and an elementwise pass. Its gate mult is the encoder's
// features, fp32 as flax's last BatchNorm leaves them (the TPU kernel
// multiplies by them in fp32), so beside bf16 x and w it reads mult in fp32.
// The gate may be one row an image: mult (M, P, N) with P dividing R gates
// row r by its row r % P, the reverse chain's trial-major rows (r = t P + i
// for trial t of image i); P = R is a gate a row. What bounds it: at the
// path's shape (M = 5, R = 160 = 20 trials x 8 images, N = 4096) it writes
// 6.55 MB in bf16 and reads 0.66 MB of gate (one row an image), 0.16 MB of
// w and 0.16 MB of a and c: 7.5 MB, 0.0023 ms on 3.35 TB/s (float32: 14.3 MB,
// 0.0043 ms; with a gate a row, 20.0 MB in bf16, 0.0060 ms). At K <= 32 an
// output costs 2K FLOP against 2-4 bytes written, far below the ~300
// operations a byte where tensor cores would pay, so they do not help: the
// stores, and the ~40 instructions of softplus an output (expf, log1pf),
// bound it. Its design:
//  - A block owns one member, a strip of 8 tx columns (tx threads across,
//    8 consecutive columns a thread, 128 / tx row groups) and a run of rows
//    in image-major order (q = i T + t, T = R / P trials), so its rows share
//    gate rows: each row group walks a contiguous run of q, loads an image's
//    8 gate values once (the next image's one row ahead) and reuses them
//    across its trials.
//  - w's strip, a and c are loaded once a block: w in registers at K <= 4
//    (the path's K = 2 and 4), else as fp32 in shared memory; the block's x
//    rows (at most SK_X_FLOATS values) are staged once in shared memory as
//    fp32 and read as broadcasts.
//  - Stores as 16-byte vectors, a warp's 32 side by side (element by
//    element where N % 8 != 0 or a pointer is off 16 bytes). Staging each
//    round of rows in shared memory and writing it with TMA bulk copies
//    (cp.async.bulk, one a row) was slower at every shape timed (PERF.md).
//  - The grid is kernels/fused_linear.py::small_k_plan, a function of the
//    shape and the 132 SMs: (member, strip) pairs times row runs, at most
//    four blocks of 128 threads an SM (128 registers a thread), so every
//    block is resident at once;
//    a block walks units b, b + grid, ... where there are more. No 64-bit
//    division: a thread divides once (32 bits) to find its first row.
//  - The arithmetic of the body it replaced: the K sum in fp32 in k order
//    with fmaf, softplus(z a + c), then x gate in fp32, one rounding to the
//    output dtype. Deterministic: no atomics.
//
// The GEMM bodies below read a gate a row (P = R).
//
// wgmma (K > 32, bf16, K and N multiples of 8, 16-byte aligned pointers: the
// shapes a TMA tensor map describes; lin2 and lin3, K = N = 4096, the
// `_kernel` body of ladine_tpu/kernels/fused_linear.py:66). What bounds it: at R = 160 rows a member (batch 8 x 20 trials) the call reads each
// member's 4096 x 4096 weight once, 168 MB (0.050 ms at 3.35 TB/s; 0.054 ms
// with x and out) against 27 GFLOP (0.027 ms at 989 TFLOP/s): the bytes. At
// R = 1400 (the evidence batch 70) it does 235 GFLOP (0.2375 ms) against
// 225 MB (0.067 ms): the operations. Its design:
//  - Copies by TMA. One thread of a producer warpgroup (setmaxnreg gives its
//    registers to the consumers) loads each K step of BK = 64 as 64 x 64
//    boxes with the 128-byte swizzle (tma_wgmma.cuh): x's live 64-row slabs
//    and w's two 64-column boxes, into a ring of 4 stages of 40 KB, with a
//    full and an empty mbarrier a stage; a consumer hands a stage back as
//    soon as its products have read it. Out-of-range rows, columns and K
//    arrive as zeros. In flight: 4 x 16 KB of w an SM, 8.4 MB on 132 SMs,
//    against the ~3.3 MB that 3.35 TB/s x ~1 us of latency needs (25 KB an
//    SM). The tensor maps are __grid_constant__ parameters, so a CUDA graph
//    captures them with the launch; cuTensorMapEncodeTiled comes from the
//    CUDA driver through cudaGetDriverEntryPoint (no -lcuda).
//  - wgmma.m64n128k16 consumers: three warpgroups, one 64-row slab of a 192
//    x 128 tile each (x K-major, w MN-major as wgmma takes it in 16 bits),
//    fp32 accumulators in registers; a slab wholly past R is not loaded or
//    multiplied.
//  - A grid that fills the card: min(132, tiles) persistent blocks, one an
//    SM (164,992 bytes of shared memory). Block b runs tiles b, b + grid, ...
//    (row tile fastest) whole, a round at a time, every block of a round at
//    the same K step; the tiles % grid tiles of the last round are split in
//    K into chunks = grid / (tiles % grid) equal parts, one a block, so the
//    last round is a chunk deep. At K = N = 4096 (160 tiles a row tile):
//    R = 20 and 160 (one row tile: each weight strip leaves device memory
//    once) run 132 whole tiles, then the other 28 in quarters on 112 blocks:
//    2 waves, the second a quarter deep, 97.0 % of block-steps busy. R = 1400
//    (8 row tiles, 1280 tiles) runs 9 waves of 132 and one of 92 (97.0 %),
//    the 8 row tiles of a strip on neighbouring blocks at once, so the strip
//    is read from device memory about once a wave and from L2 after.
//  - Deterministic. A block that runs a chunk of a split tile writes its
//    fp32 partial tile to the workspace and counts itself in (an integer
//    atomic); the last of the tile's blocks reads the partials back in chunk
//    order and runs the epilogue, so the sum's order is fixed by the shape
//    whoever finishes last, and no block waits for another. No float
//    atomics: a parity request replays bit for bit.
//  - The epilogue in registers on the accumulator fragments (a, c,
//    softplus, the bf16 or fp32 gate, bf16 pairs stored), as the mma body's.
// Each column tile re-reads its member's x from L2 (1.3 MB at R = 160, 210
// MB a call), beside the 168 MB weight stream. At R = 20, where x and the
// products are small, a call is the weight stream alone: on an H100 SXM at
// 700 W it takes 0.078 ms, 2.15 TB/s, with 8.4 MB in flight and 97 % of
// the blocks busy, so neither the ring's depth nor the waves hold it back
// but the rate at which device memory serves each block's 256-byte row
// segments (chip_smoke.py phase 2 times it beside torch.bmm).
//
// mma (K > 32, bf16, the shapes wgmma does not take: K or N not a multiple
// of 8 (lin1 at 17 classes: K = 34), a pointer off 16 bytes). Tiles of 160
// rows x 128 columns, a cluster of 2 blocks splitting K in two halves for
// one tile, the partial fp32 tiles summed through distributed shared memory
// before the epilogue; 8 warps of 80 rows x 32 columns; K streams in steps
// of 32 through a 4-stage ring of cp.async copies. Fragments come from
// shared memory by ldmatrix (.trans for w's row-major K x N tile) into
// mma.sync.m16n8k16. The epilogue runs in registers on the accumulator
// fragments (a, c, softplus, mult, bf16 store): no shared C tile. Its gate
// mult is bf16 or fp32 (lin1 above 16 classes leaves small_k for a GEMM body
// with the fp32 features as its gate, read in fp32 as the TPU kernel reads
// them). Ragged R, N and K are zero-filled; its tiles are staged element
// by element (the shapes that would move as 16-byte vectors take wgmma).
//
// tf32x3 (fp32 K > 1024, K and N multiples of 4, 16-byte aligned pointers:
// the fp32 shapes a TMA tensor map describes above SIMT_MAX_K of
// kernels/fused_linear.py; lin2 and lin3 of the float32 predictor, the
// config default). fp32 has no tensor-core product of its
// own; TF32 (495 TFLOP/s dense against 67 of fp32 FMA) keeps 10 mantissa
// bits, which misses fp32's 1e-4 in one pass. So each value v is split
// into hi = trunc(v) (its top 19 bits) and lo = v - hi rounded to TF32, and
// the product is x_hi w_hi + x_hi w_lo + x_lo w_hi (the dropped x_lo w_lo
// is ~2^-21 relative): three TF32 products, so at R = 1400 its operations
// bound it at 1.424 ms (3 x 235 GFLOP), at R = 160 at 0.163 ms against
// 0.108 ms of bytes. Its design:
//  - The wgmma body's tiles, persistent schedule and split-tile sums
//    (kernels/fused_linear.py::wgmma_plan at BK = 32: 128 bytes of fp32 K,
//    a TMA box wide), its epilogue in registers (fp32 pairs stored).
//  - TF32 wgmma takes both operands K-major. x is; w (K, N) row-major is
//    not, and TMA does not transpose 32-bit data. So w arrives as four
//    32-column MN-major boxes a stage in a ring of its own, and the producer
//    warpgroup's three idle warps write it transposed as w_hi (w itself:
//    the tensor cores read its top 19 bits) and w_lo into the stage, in the
//    128-byte-swizzled K-major layout wgmma reads, without bank conflicts.
//  - x as TMA loads it is x_hi to the tensor cores; each consumer
//    warpgroup writes x_lo of its slab beside it. Every operand is read
//    from shared memory: m64n128k8 wgmma, three a k8 step.
//  - Rounding by integer operations: cvt.rna.tf32.f32 runs on the
//    conversion pipe, and split w and x slower.
//  - A stage's products go into a fresh fp32 tile, added to the
//    accumulator with round-to-nearest: the tensor cores' own sums do not
//    round to nearest, and over K / 8 x 3 sums into one accumulator they
//    biased it past the plain fp32 product's error at K = 4096; folded, it
//    errs less than the plain product against float64
//    (examples/kernel_ab.py reports both).
// It does not depend on torch's TF32 flags, which the port keeps off.
//
// simt (K > 32, fp32, the shapes tf32x3 does not take: K or N off 4, a
// pointer off 16 bytes, K up to SIMT_MAX_K, where it measured faster).
// 64 x 64 tiles of 128 threads, 8 x 4 fp32 FMA
// outputs each, a 2-stage cp.async ring and the epilogue from a shared fp32
// tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tma_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace bf16mma;

enum Body { MMA = 1, SIMT = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// two consecutive gate values (8-byte aligned fp32 or 4-byte aligned bf16)
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float softplus(float z) { return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z))); }

// Stage a ROWS x COLS tile of a row-major (n_rows, n_cols) matrix at
// (row0, col0) into shared memory with row stride ld, zero-filling outside.
// With vec (n_cols a multiple of the 16-byte vector, src 16-byte aligned)
// the copy is asynchronous (cp.async); otherwise element by element.
template <typename T, int ROWS, int COLS, int THREADS>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, int n_rows, int n_cols,
                                      int row0, int col0, bool vec) {
  constexpr int V = 16 / sizeof(T), VECS = ROWS * COLS / V;
  if (vec) {
#pragma unroll
    for (int it = 0; it < (VECS + THREADS - 1) / THREADS; ++it) {
      int i = threadIdx.x + it * THREADS;
      if (VECS % THREADS != 0 && i >= VECS) break;
      int r = i / (COLS / V), cv = (i % (COLS / V)) * V;
      int gr = row0 + r, gc = col0 + cv;
      bool ok = gr < n_rows && gc < n_cols;
      cp_async16(dst + r * ld + cv, src + (ok ? (size_t)gr * n_cols + gc : 0), ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
      int r = i / COLS, cc = i % COLS;
      int gr = row0 + r, gc = col0 + cc;
      dst[r * ld + cc] = (gr < n_rows && gc < n_cols) ? src[(size_t)gr * n_cols + gc] : from_f<T>(0.f);
    }
  }
}

// The K loop over a ring of STAGES shared-memory stages: step kt is
// multiplied while steps kt+1 .. kt+STAGES-1 are in flight. One commit group
// per step (empty past the end) keeps the group count uniform for
// cp.async.wait_group.
template <int STAGES, typename Load, typename Multiply>
__device__ __forceinline__ void k_loop(int nk, Load&& load, Multiply&& multiply) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // ... for every thread; slot kt-1 is free
    int pf = kt + STAGES - 1;
    if (pf < nk) load(pf % STAGES, pf);
    cp_async_commit();
    multiply(kt % STAGES);
  }
  cp_async_wait<0>();
}

// ---- small_k ----------------------------------------------------------------

namespace sk {
constexpr int MAX_K = 32, THREADS = 128, VEC = 8;  // 8 consecutive columns a thread
constexpr int REG_K = 4;                           // K up to this: w's strip in registers
constexpr int X_FLOATS = 4096;                     // a unit's x rows, fp32 in shared memory
constexpr int W_FLOATS = 8192;                     // w's strip above REG_K, fp32 in shared memory
}  // namespace sk

// kernels/fused_linear.py::small_k_plan: tx threads across a strip of 8 tx
// columns, strips of N, splits row runs of each (member, strip) pair,
// units = M x strips x splits, run by the grid's blocks in turn
struct SkPlan {
  int tx, strips, splits, units;
};

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 lo = reinterpret_cast<const float4*>(p)[0], hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w, v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                         pack_bf16(v[6], v[7]));
  *reinterpret_cast<uint4*>(p) = raw;
}
// 8 elements at p (those below `valid`), vectorized where vec
template <typename T>
__device__ __forceinline__ void load8_masked(const T* p, float* v, int valid, bool vec) {
  if (vec) return load8(p, v);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < valid ? to_f(p[e]) : 0.f;
}

// KR: w's strip in registers (K <= KR = REG_K) or in shared memory (KR =
// MAX_K). Shared memory: w's strip (KR = MAX_K: K x 8 tx fp32), then the
// unit's x rows (rows x K fp32).
template <typename T, typename MT, int KR>
__global__ void __launch_bounds__(sk::THREADS, 4)
fused_linear_small_k_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ a,
                            const float* __restrict__ c, const MT* __restrict__ mult, T* __restrict__ out, int R,
                            int P, int K, int N, bool vec, SkPlan p) {
  extern __shared__ __align__(16) float sk_smem[];
  const int tx = p.tx, groups = sk::THREADS / tx, bn = sk::VEC * tx;
  const int lane = threadIdx.x % tx, g = threadIdx.x / tx;
  const int trials = R / P;  // rows r = t P + i: trial t of image i
  float* ws = sk_smem;                              // K x bn (KR = MAX_K)
  float* xs = ws + (KR == sk::MAX_K ? K * bn : 0);  // the unit's rows x K
  const int base = R / p.splits, rem = R % p.splits;

  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int pair = u / p.splits, split = u - pair * p.splits;
    const int m = pair / p.strips, col0 = (pair - m * p.strips) * bn;
    const int q0 = split * base + min(split, rem), L = base + (split < rem ? 1 : 0);
    const int n0 = col0 + sk::VEC * lane, valid = min(sk::VEC, N - n0);  // valid <= 0: past N
    // row group g's run [qa, qb) of the unit's image-major rows [q0, q0 + L)
    const int qa = q0 + g * L / groups, qb = valid > 0 ? q0 + (g + 1) * L / groups : qa;
    int i = qa / trials, t = qa - i * trials;

    // constants of the strip, the first image's gate: loads in flight across the staging
    float wr[KR == sk::REG_K ? sk::REG_K : 1][sk::VEC], av[sk::VEC], cv[sk::VEC], mv[sk::VEC];
    if (qa < qb) {
      if constexpr (KR == sk::REG_K) {
#pragma unroll
        for (int k = 0; k < sk::REG_K; ++k)
          if (k < K) load8_masked(w + ((size_t)m * K + k) * N + n0, wr[k], valid, vec);
      }
      load8_masked(a + (size_t)m * N + n0, av, valid, vec);
      load8_masked(c + (size_t)m * N + n0, cv, valid, vec);
      if (mult != nullptr) load8_masked(mult + ((size_t)m * P + i) * N + n0, mv, valid, vec);
    }
    if constexpr (KR == sk::MAX_K) {
      for (int j = threadIdx.x; j < K * bn; j += sk::THREADS) {
        const int k = j / bn, n = col0 + (j - k * bn);
        ws[j] = n < N ? to_f(w[((size_t)m * K + k) * N + n]) : 0.f;
      }
    }
    for (int j = threadIdx.x; j < L; j += sk::THREADS) {
      const int q = q0 + j, ii = q / trials, r = (q - ii * trials) * P + ii;
      const T* xr = x + ((size_t)m * R + r) * K;
      for (int k = 0; k < K; ++k) xs[j * K + k] = to_f(xr[k]);
    }
    __syncthreads();

    for (int q = qa; q < qb; ++q) {
      float mn[sk::VEC];  // the next row's image's gate, loaded a row ahead
      const bool next = mult != nullptr && t + 1 == trials && q + 1 < qb;
      if (next) load8_masked(mult + ((size_t)m * P + i + 1) * N + n0, mn, valid, vec);
      const float* xr = xs + (q - q0) * K;
      float acc[sk::VEC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        if (k >= K) break;
        float wv[sk::VEC];
        if constexpr (KR == sk::REG_K) {
#pragma unroll
          for (int e = 0; e < sk::VEC; ++e) wv[e] = wr[k][e];
        } else {
          load8(ws + k * bn + sk::VEC * lane, wv);
        }
        const float xk = xr[k];
#pragma unroll
        for (int e = 0; e < sk::VEC; ++e) acc[e] = fmaf(xk, wv[e], acc[e]);
      }
#pragma unroll
      for (int e = 0; e < sk::VEC; ++e) {
        acc[e] = softplus(acc[e] * av[e] + cv[e]);
        if (mult != nullptr) acc[e] *= mv[e];
      }
      const size_t o = ((size_t)m * R + (size_t)t * P + i) * N + n0;
      if (vec) {
        store8(out + o, acc);
      } else {
#pragma unroll
        for (int e = 0; e < sk::VEC; ++e)
          if (e < valid) out[o + e] = from_f<T>(acc[e]);
      }
      if (++t == trials) {
        t = 0, ++i;
        if (next) {
#pragma unroll
          for (int e = 0; e < sk::VEC; ++e) mv[e] = mn[e];
        }
      }
    }
    __syncthreads();  // the next unit restages x and w
  }
}

// The small_k body's dynamic shared memory for a plan (mirrored by
// kernels/fused_linear.py's SmallKPlan.smem_bytes): at most 48 KB
inline int small_k_smem(int R, int K, const SkPlan& p) {
  return 4 * ((K > sk::REG_K ? K * sk::VEC * p.tx : 0) + ((R + p.splits - 1) / p.splits * K + 3) / 4 * 4);
}

template <typename T, typename MT, int KR>
int launch_small_k_as(const void* x, const void* w, const void* a, const void* c, const void* mult, void* out,
                      int R, int P, int K, int N, bool vec, const SkPlan& p, int grid, cudaStream_t s) {
  fused_linear_small_k_kernel<T, MT, KR><<<grid, sk::THREADS, small_k_smem(R, K, p), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(a),
      static_cast<const float*>(c), static_cast<const MT*>(mult), static_cast<T*>(out), R, P, K, N, vec, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename MT>
int launch_small_k(const void* x, const void* w, const void* a, const void* c, const void* mult, void* out, int R,
                   int P, int K, int N, bool vec, const SkPlan& p, int grid, cudaStream_t s) {
  return K <= sk::REG_K ? launch_small_k_as<T, MT, sk::REG_K>(x, w, a, c, mult, out, R, P, K, N, vec, p, grid, s)
                        : launch_small_k_as<T, MT, sk::MAX_K>(x, w, a, c, mult, out, R, P, K, N, vec, p, grid, s);
}

// ---- mma (bf16) -------------------------------------------------------------

namespace mma_cfg {
constexpr int BM = 160, BN = 128, BK = 32, STAGES = 4;
constexpr int WARPS_N = 4, THREADS = 256;          // 8 warps of 80 rows x 32 columns
constexpr int WM = BM / 2, WN = BN / WARPS_N, FM = WM / 16, FN = WN / 8;
constexpr int LDA = BK + 8, LDB = BN + 8;          // 16 bytes of padding a row
constexpr int A_ELEMS = BM * LDA, STAGE_ELEMS = A_ELEMS + BK * LDB;
constexpr int SMEM_BYTES = STAGES * STAGE_ELEMS * (int)sizeof(bf16);  // 86,016: 2 blocks an SM
constexpr int PART = FM * FN * 4;                  // a warp's partial sums a lane
static_assert(PART * THREADS / 2 * (int)sizeof(float) <= SMEM_BYTES, "partials fit the ring");
}  // namespace mma_cfg

// A cluster of 2 blocks splits K in two halves for one 160 x 128 tile; each
// block sums its half, then rank r finishes rows 80 r .. 80 r + 79: the other
// half of its partial tile goes through shared memory to its peer, which adds
// it (distributed shared memory) before the epilogue.
template <typename MT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(mma_cfg::THREADS, 2)
fused_linear_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ a, const float* __restrict__ c,
                        const MT* __restrict__ mult, bf16* __restrict__ out, int R, int K, int N) {
  using namespace mma_cfg;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* pipe = reinterpret_cast<bf16*>(smem);
  const int rank = (int)cluster.block_rank();  // blockIdx.x % 2
  const int m = blockIdx.z, row0 = (blockIdx.x / 2) * BM, col0 = blockIdx.y * BN;
  const int khalf = (K / 2 + BK - 1) / BK * BK;  // rank 0: [0, khalf), rank 1: [khalf, K)
  const int k0 = rank * khalf, nk = rank ? max(0, (K - khalf + BK - 1) / BK) : (min(khalf, K) + BK - 1) / BK;
  const bf16* xm = x + (size_t)m * R * K;
  const bf16* wm = w + (size_t)m * K * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = (warp / WARPS_N) * WM, wc = (warp % WARPS_N) * WN;
  const int g = lane / 4, t4 = lane % 4, mi = lane / 8, mr = lane % 8;
  const bool active = row0 + wr < R;  // warp-uniform: rows past R only zero-fill

  float acc[FM][FN][4];  // rows wr + 16 i + g (+ 8), columns wc + 8 j + 2 t4 (+ 1)
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load = [&](int slot, int kt) {
    bf16* As = pipe + slot * STAGE_ELEMS;
    stage<bf16, BM, BK, THREADS>(As, LDA, xm, R, K, row0, k0 + kt * BK, false);
    stage<bf16, BK, BN, THREADS>(As + A_ELEMS, LDB, wm, K, N, k0 + kt * BK, col0, false);
  };
  k_loop<STAGES>(nk, load, [&](int slot) {
    if (!active) return;
    const bf16* As = pipe + slot * STAGE_ELEMS;
    const bf16* Bs = As + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bfr[FN][2];
#pragma unroll
      for (int jj = 0; jj < FN / 2; ++jj) {  // column tiles 2 jj and 2 jj + 1
        uint32_t r4[4];
        ldmatrix_x4_trans(r4, Bs + (kk + (mi % 2) * 8 + mr) * LDB + wc + jj * 16 + (mi / 2) * 8);
        bfr[2 * jj][0] = r4[0], bfr[2 * jj][1] = r4[1], bfr[2 * jj + 1][0] = r4[2], bfr[2 * jj + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        uint32_t af[4];
        ldmatrix_x4(af, As + (wr + 16 * i + lane % 16) * LDA + kk + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < FN; ++j) mma(acc[i][j], af, bfr[j][0], bfr[j][1]);
      }
    }
  });
  __syncthreads();  // every warp is done with the ring: it now holds partials

  // partial sums in fragment order, lanes innermost (no bank conflicts)
  float* part = reinterpret_cast<float*>(smem);
  const int slot0 = (warp % WARPS_N) * 32 + lane;
  const bool finish = wr == rank * WM;
  if (!finish) {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[((i * FN + j) * 4 + e) * (WARPS_N * 32) + slot0] = acc[i][j][e];
  }
  cluster.sync();  // the peer's partials are written
  if (finish) {
    const float* peer = cluster.map_shared_rank(part, rank ^ 1);
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += peer[((i * FN + j) * 4 + e) * (WARPS_N * 32) + slot0];

    // epilogue from the registers: fp32 affine + softplus (+ gate), masked store
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int col = col0 + wc + 8 * j + 2 * t4;
      float av[2], cv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool ok = col + e < N;
        av[e] = ok ? a[(size_t)m * N + col + e] : 0.f;
        cv[e] = ok ? c[(size_t)m * N + col + e] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = row0 + wr + 16 * i + g + 8 * hh;
          if (r >= R || col >= N) continue;
          const size_t o = ((size_t)m * R + r) * N + col;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) v[e] = softplus(acc[i][j][2 * hh + e] * av[e] + cv[e]);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col + e >= N) continue;
            if (mult != nullptr) v[e] *= to_f(mult[o + e]);
            out[o + e] = __float2bfloat16(v[e]);
          }
        }
    }
  }
  cluster.sync();  // the peer has read this block's partials
}

template <typename MT>
int launch_mma(const void* x, const void* w, const void* a, const void* c, const void* mult,
               void* out, int M, int R, int K, int N, cudaStream_t s) {
  using namespace mma_cfg;
  cudaError_t err = cudaFuncSetAttribute(fused_linear_mma_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(2 * ((R + BM - 1) / BM), (N + BN - 1) / BN, M);
  fused_linear_mma_kernel<MT><<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(a),
      static_cast<const float*>(c), static_cast<const MT*>(mult), static_cast<bf16*>(out), R, K, N);
  return static_cast<int>(cudaGetLastError());
}

// ---- wgmma (bf16) and tf32x3 (fp32): TMA rings on a persistent grid ------

namespace wg_cfg {
constexpr int SLABS = 3;                              // consumer warpgroups, one 64-row slab each
constexpr int BM = 64 * SLABS, BN = 128, BK = 64, STAGES = 4;
constexpr int THREADS = 128 * (SLABS + 1);            // + the producer warpgroup
constexpr int BOX_BYTES = 64 * 64 * 2;                // one 64 x 64 bf16 TMA box
constexpr int STAGE_BYTES = (SLABS + 2) * BOX_BYTES;  // x's slabs, then w's two 64-column boxes
constexpr int SMEM_BYTES = 128 + 1024 + STAGES * STAGE_BYTES;  // barriers and flag, alignment, ring
constexpr int PART_FLOATS = SLABS * 64 * BN;          // a block's partial tile in the workspace
constexpr int FLAG_BYTES = 1024, MAX_GRID = FLAG_BYTES / 4;  // the counts lead the workspace
}  // namespace wg_cfg

// tf32x3: the wgmma body's tiles (BM x BN, three 64-row slabs) and
// schedule at BK = 32 fp32 (128 bytes of K) a step, on two rings and one
// slab a consumer warpgroup: stages of x's slabs (TMA) with w_hi and w_lo
// (K-major, written by the splitting warps); stages of w as TMA loads it
// (MN-major, four 32-column boxes), read by the splitting warps; x_lo.
namespace tf_cfg {
using wg_cfg::SLABS;
using wg_cfg::BM;
using wg_cfg::BN;
using wg_cfg::THREADS;
constexpr int BK = 32, STAGES = 3, W_STAGES = 2;
constexpr int X_BOX = 64 * BK * 4;                     // a 64-row slab of x: 8 KB
constexpr int W_BOX = BK * 32 * 4;                     // BK rows of 32 columns of w: 4 KB
constexpr int HALF = BN * BK * 4;                      // w_hi or w_lo, BN rows of BK: 16 KB
constexpr int HI_OFF = SLABS * X_BOX, LO_OFF = HI_OFF + HALF, STAGE = LO_OFF + HALF;  // 56 KB
constexpr int W_STAGE = (BN / 32) * W_BOX;             // 16 KB
constexpr int W_RING = STAGES * STAGE, XLO = W_RING + W_STAGES * W_STAGE;  // offsets from the first stage
constexpr int SMEM_BYTES = 128 + 1024 + XLO + SLABS * X_BOX;  // 230,528 of the 232,448 a block may have
constexpr int SPLITTERS = 96;                          // warps 1-3 of the producer warpgroup
constexpr int UNITS = (BK / 4) * (BN / 4);             // 4 x 4 blocks of w a stage
static_assert(SMEM_BYTES <= 232448, "the rings fit a block");
}  // namespace tf_cfg

// A position in a ring of N stages: the stage and the parity of its use.
template <int N>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void advance() {
    if (++stage == N) stage = 0, phase ^= 1;
  }
};

// The schedule of kernels/fused_linear.py::wgmma_plan (hopper::WgSched,
// walked by hopper::Segments): tiles of BM rows x BN columns, each `steps`
// BK-steps of K deep; the last of a split tile's blocks to finish adds the
// partial tiles in chunk order.
using hopper::Segments;
using hopper::WgSched;

__device__ __forceinline__ void consumers_sync() { hopper::named_sync<1, wg_cfg::SLABS * 128>(); }
// the 128 threads of consumer warpgroup wg (named barriers 2 .. SLABS + 1)
__device__ __forceinline__ void slab_sync(int wg) { asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory"); }

// A consumer warpgroup's part of a chunk of a split tile: its partial
// slab goes to the workspace (part: this thread's first value, v at
// + v * 128) and the block counts itself in. Returns whether this block is
// the tile's last; that block then holds in acc the partials summed in
// chunk order, so the sum is the same whoever is last. Every consumer
// warpgroup, live or not, calls it.
__device__ __forceinline__ bool finish_split(float* acc, float* part, int* flags, int* last, int split, bool live,
                                             const WgSched& s) {
  using wg_cfg::PART_FLOATS;
  if (live) {
#pragma unroll
    for (int v = 0; v < 64; ++v) __stcg(part + (size_t)blockIdx.x * PART_FLOATS + v * 128, acc[v]);
  }
  __threadfence();
  consumers_sync();
  if (threadIdx.x == 0) *last = atomicAdd(flags + split, 1) == s.chunks - 1;
  consumers_sync();
  if (!*last) return false;
  __threadfence();
  if (live) {
    const int rem = s.tiles % s.grid;
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] = __ldcg(part + (size_t)split * PART_FLOATS + v * 128);
    for (int q = 1; q < s.chunks; ++q) {
      const float* p = part + (size_t)(q * rem + split) * PART_FLOATS;
#pragma unroll
      for (int v = 0; v < 64; ++v) acc[v] += __ldcg(p + v * 128);
    }
  }
  return true;
}

__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// The epilogue from the registers on a warpgroup's 64 x BN fragments at
// (row0, col0) of member m: fp32 affine + softplus (+ gate), pairs stored.
// N is even, so col < N means col + 1 < N.
template <typename T, typename MT>
__device__ __forceinline__ void store_slab(const float* acc, const float* __restrict__ a, const float* __restrict__ c,
                                           const MT* __restrict__ mult, T* __restrict__ out, int m, int row0,
                                           int col0, int R, int N) {
  const int lane = threadIdx.x % 32, rr = row0 + 16 * (threadIdx.x % 128 / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < wg_cfg::BN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
    const float2 av = *reinterpret_cast<const float2*>(a + (size_t)m * N + col);
    const float2 cv = *reinterpret_cast<const float2*>(c + (size_t)m * N + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rr + 8 * h;
      if (r >= R) continue;
      const size_t o = ((size_t)m * R + r) * N + col;
      float v0 = softplus(acc[4 * j + 2 * h] * av.x + cv.x);
      float v1 = softplus(acc[4 * j + 2 * h + 1] * av.y + cv.y);
      if (mult != nullptr) {
        const float2 mv = load2(mult + o);
        v0 *= mv.x, v1 *= mv.y;
      }
      store2(out + o, v0, v1);
    }
  }
}

// Warp-specialised: warpgroups 0 .. SLABS-1 multiply (wgmma) and run the
// epilogue, the last warpgroup's first thread issues the TMA loads. A block
// that runs a chunk of a split tile leaves its partial tile in the
// workspace and counts itself in; the last of the tile's blocks reads the
// partials back in chunk order and runs the epilogue. No block waits for
// another.
template <typename MT>
__global__ void __launch_bounds__(wg_cfg::THREADS, 1)
fused_linear_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                          const float* __restrict__ a, const float* __restrict__ c,
                          const MT* __restrict__ mult, bf16* __restrict__ out, unsigned char* __restrict__ work,
                          int R, int N, WgSched s) {
  using namespace wg_cfg;
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(wg_smem);
  uint64_t* empty = full + STAGES;
  int* last = reinterpret_cast<int*>(empty + STAGES);  // this block finishes the split tile
  const uint32_t base = smem_u32(wg_smem);
  unsigned char* ring = wg_smem + (((base + 128 + 1023) & ~1023u) - base);  // 1024-aligned for the swizzle
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);              // the producer's expect_tx arrival (+ the bytes)
      mbar_init(&empty[i], SLABS * 4);     // lane 0 of every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  int tile, kb, ke, split;
  if (wg == SLABS) {  // ---- producer
    regs_dealloc<40>();
    if (t != 0) return;
    const CUtensorMap* xm = &xmap;
    const CUtensorMap* wm = &wmap;
    int stage = 0;
    uint32_t phase = 0;
    for (Segments seg(s); seg.next(s, tile, kb, ke, split);) {
      const int row0 = (tile % s.row_tiles) * BM, col0 = (tile / s.row_tiles % s.col_tiles) * BN;
      const int m = tile / (s.row_tiles * s.col_tiles);
      const int live = min(SLABS, (R - row0 + 63) / 64);  // slabs with a row below R
      for (int ks = kb; ks < ke; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * STAGE_BYTES;
        mbar_expect_tx(&full[stage], (live + 2) * BOX_BYTES);
        for (int q = 0; q < live; ++q) tma_load_3d(st + q * BOX_BYTES, xm, &full[stage], ks * BK, row0 + 64 * q, m);
        for (int q = 0; q < 2; ++q)
          tma_load_3d(st + (SLABS + q) * BOX_BYTES, wm, &full[stage], col0 + 64 * q, ks * BK, m);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
  } else {  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
    regs_alloc<152>();
    const int lane = t % 32;
    int* flags = reinterpret_cast<int*>(work);
    float* part = reinterpret_cast<float*>(work + FLAG_BYTES) + wg * 64 * BN + t;  // value v at + v * 128
    float acc[64];
    int stage = 0;
    uint32_t phase = 0;
    for (Segments seg(s); seg.next(s, tile, kb, ke, split);) {
      const int row0 = (tile % s.row_tiles) * BM + 64 * wg, col0 = (tile / s.row_tiles % s.col_tiles) * BN;
      const int m = tile / (s.row_tiles * s.col_tiles);
      const bool live = row0 < R;  // warpgroup-uniform; a dead slab only keeps the ring turning
#pragma unroll
      for (int v = 0; v < 64; ++v) acc[v] = 0.f;
      for (int ks = kb; ks < ke; ++ks) {
        mbar_wait(&full[stage], phase);
        if (live) {
          const uint32_t st = smem_u32(ring + stage * STAGE_BYTES);
#pragma unroll
          for (int v = 0; v < 64; ++v) fence_operand(acc[v]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n128k16(acc, desc_sw128(st + wg * BOX_BYTES + 32 * kk, 16, 1024),
                             desc_sw128(st + SLABS * BOX_BYTES + 2048 * kk, BOX_BYTES, 1024));
          wgmma_commit();
          wgmma_wait<0>();  // the stage is read: hand it back at once
#pragma unroll
          for (int v = 0; v < 64; ++v) fence_operand(acc[v]);
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      if (split >= 0 && !finish_split(acc, part, flags, last, split, live, s)) continue;
      if (live) store_slab(acc, a, c, mult, out, m, row0, col0, R, N);
    }
  }
}

// w's raw stage as TMA wrote it (BK rows of K, four 32-column boxes, each
// row 128 bytes with the 128-byte swizzle) into w_hi and w_lo of a stage,
// K-major (BN rows of N, BK values of K each, the same swizzle): w_hi is w
// itself, transposed (the tensor cores read its top 19 bits), w_lo is
// tf32_lo(w). A unit is a 4 x 4 block: 4 rows of K read as one 16-byte
// chunk each, 4 rows of N written as one chunk each to each half. Unit u: K
// rows 4 kg .. 4 kg + 3 with kg = u % 8, N columns 4 nc .. 4 nc + 3 with
// nc = 8 (q % 4) + (u + q / 4) % 8, q = u / 8, so the 8 threads of a
// quarter-warp read and write 8 distinct 16-byte bank groups (chunk c of a
// row r sits at c ^ (r % 8)): no bank conflicts.
__device__ __forceinline__ void split_w(const unsigned char* raw, unsigned char* st, int i) {
  using namespace tf_cfg;
  for (int u = i; u < UNITS; u += SPLITTERS) {
    const int kg = u % 8, q = u / 8, nc = 8 * (q % 4) + (u + q / 4) % 8;
    float4 v[4];  // v[r]: K row 4 kg + r, N columns 4 nc .. 4 nc + 3
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * kg + r;
      v[r] = *reinterpret_cast<const float4*>(raw + (nc / 8) * W_BOX + k * 128 + (((nc % 8) ^ (k % 8)) << 4));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float col[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) col[r] = e == 0 ? v[r].x : e == 1 ? v[r].y : e == 2 ? v[r].z : v[r].w;
      const int n = 4 * nc + e, off = n * 128 + ((kg ^ (n % 8)) << 4);
      *reinterpret_cast<float4*>(st + HI_OFF + off) = make_float4(col[0], col[1], col[2], col[3]);
      *reinterpret_cast<uint4*>(st + LO_OFF + off) =
          make_uint4(hopper::tf32_lo(col[0]), hopper::tf32_lo(col[1]), hopper::tf32_lo(col[2]), hopper::tf32_lo(col[3]));
    }
  }
}

// The tf32x3 body: fp32 x, w, out and gate. As the wgmma body (the same
// tiles, schedule, split-tile sums and epilogue), with the product
// x_hi w_hi + x_hi w_lo + x_lo w_hi on TF32 tensor cores, every operand
// from shared memory (TF32 wgmma takes both K-major, and TMA does not
// transpose 32-bit data). The producer warpgroup's first thread issues the
// TMA loads; its warps 1-3 split each stage of w into K-major halves
// (split_w). Each consumer warpgroup writes x_lo of its slab; x as loaded
// is x_hi to the tensor cores (on an H100 the error against float64 was
// that of an explicit x_hi = tf32(x) written in its place). A stage's
// products go into a fresh fp32 tile that is then added to the
// accumulator with round-to-nearest: the tensor cores' own sums do not
// round to nearest, and over K / 8 x 3 sums into one accumulator they
// biased it past the plain fp32 product's error.
__global__ void __launch_bounds__(tf_cfg::THREADS, 1)
fused_linear_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                           const float* __restrict__ a, const float* __restrict__ c,
                           const float* __restrict__ mult, float* __restrict__ out,
                           unsigned char* __restrict__ work, int R, int N, WgSched s) {
  using namespace tf_cfg;
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char tf_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tf_smem);  // x's slabs have landed
  uint64_t* halves = full + STAGES;                       // w_hi and w_lo are written
  uint64_t* empty = halves + STAGES;                      // the consumers are done with the stage
  uint64_t* wfull = empty + STAGES;                       // w's raw stage has landed
  uint64_t* wempty = wfull + W_STAGES;                    // the splitting warps are done with it
  int* last = reinterpret_cast<int*>(wempty + W_STAGES);
  const uint32_t base = smem_u32(tf_smem);
  unsigned char* ring = tf_smem + (((base + 128 + 1023) & ~1023u) - base);
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&halves[i], SPLITTERS / 32);  // lane 0 of every splitting warp
      mbar_init(&empty[i], SLABS * 4);
    }
    for (int i = 0; i < W_STAGES; ++i) mbar_init(&wfull[i], 1), mbar_init(&wempty[i], SPLITTERS / 32);
    fence_barrier_init();
  }
  __syncthreads();

  int tile, kb, ke, split;
  Ring<STAGES> sr;
  Ring<W_STAGES> wr;
  if (wg == SLABS) {
    regs_dealloc<56>();
    if (t < 32) {  // ---- producer
      if (t != 0) return;
      const CUtensorMap* xm = &xmap;
      const CUtensorMap* wm = &wmap;
      for (Segments seg(s); seg.next(s, tile, kb, ke, split);) {
        const int row0 = (tile % s.row_tiles) * BM, col0 = (tile / s.row_tiles % s.col_tiles) * BN;
        const int m = tile / (s.row_tiles * s.col_tiles);
        const int live = min(SLABS, (R - row0 + 63) / 64);
        for (int ks = kb; ks < ke; ++ks) {
          mbar_wait(&wempty[wr.stage], wr.phase ^ 1);
          unsigned char* raw = ring + W_RING + wr.stage * W_STAGE;
          mbar_expect_tx(&wfull[wr.stage], W_STAGE);
          for (int q = 0; q < BN / 32; ++q) tma_load_3d(raw + q * W_BOX, wm, &wfull[wr.stage], col0 + 32 * q, ks * BK, m);
          wr.advance();
          mbar_wait(&empty[sr.stage], sr.phase ^ 1);
          unsigned char* st = ring + sr.stage * STAGE;
          mbar_expect_tx(&full[sr.stage], live * X_BOX);
          for (int q = 0; q < live; ++q) tma_load_3d(st + q * X_BOX, xm, &full[sr.stage], ks * BK, row0 + 64 * q, m);
          sr.advance();
        }
      }
    } else {  // ---- splitting warps: w's raw stages into the stages' K-major halves
      for (Segments seg(s); seg.next(s, tile, kb, ke, split);) {
        for (int ks = kb; ks < ke; ++ks) {
          mbar_wait(&wfull[wr.stage], wr.phase);
          mbar_wait(&empty[sr.stage], sr.phase ^ 1);  // the consumers are done with the stage's last use
          split_w(ring + W_RING + wr.stage * W_STAGE, ring + sr.stage * STAGE, t - 32);
          fence_proxy_async();  // the halves are read by wgmma
          __syncwarp();
          if (t % 32 == 0) mbar_arrive(&wempty[wr.stage]), mbar_arrive(&halves[sr.stage]);
          wr.advance();
          sr.advance();
        }
      }
    }
  } else {  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
    regs_alloc<152>();
    const int lane = t % 32;
    int* flags = reinterpret_cast<int*>(work);
    float* part = reinterpret_cast<float*>(work + wg_cfg::FLAG_BYTES) + wg * 64 * BN + t;
    unsigned char* xlo = ring + XLO + wg * X_BOX;
    const uint32_t xlo_a = smem_u32(xlo);
    float acc[64], fresh[64];
    for (Segments seg(s); seg.next(s, tile, kb, ke, split);) {
      const int row0 = (tile % s.row_tiles) * BM + 64 * wg, col0 = (tile / s.row_tiles % s.col_tiles) * BN;
      const int m = tile / (s.row_tiles * s.col_tiles);
      const bool live = row0 < R;
#pragma unroll
      for (int v = 0; v < 64; ++v) acc[v] = 0.f;
      for (int ks = kb; ks < ke; ++ks) {
        mbar_wait(&full[sr.stage], sr.phase);
        mbar_wait(&halves[sr.stage], sr.phase);
        if (live) {
          // x_lo of the slab, at the slab's (swizzled) positions; the last
          // stage's products have read x_lo (waited)
          const uint32_t sa = smem_u32(ring + sr.stage * STAGE), xa = sa + wg * X_BOX;
          const float4* xs = reinterpret_cast<const float4*>(ring + sr.stage * STAGE + wg * X_BOX);
#pragma unroll
          for (int i = 0; i < X_BOX / 16 / 128; ++i) {
            const float4 v = xs[t + 128 * i];
            reinterpret_cast<uint4*>(xlo)[t + 128 * i] = make_uint4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z), tf32_lo(v.w));
          }
          fence_proxy_async();  // x_lo is read by wgmma
          slab_sync(wg);
#pragma unroll
          for (int v = 0; v < 64; ++v) fresh[v] = 0.f, fence_operand(fresh[v]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 8; ++kk) {
            const uint64_t xh = desc_sw128(xa + 32 * kk, 16, 1024), whi = desc_sw128(sa + HI_OFF + 32 * kk, 16, 1024);
            wgmma_m64n128k8_tf32(fresh, desc_sw128(xlo_a + 32 * kk, 16, 1024), whi);
            wgmma_m64n128k8_tf32(fresh, xh, desc_sw128(sa + LO_OFF + 32 * kk, 16, 1024));
            wgmma_m64n128k8_tf32(fresh, xh, whi);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int v = 0; v < 64; ++v) fence_operand(fresh[v]), acc[v] += fresh[v];
        }
        if (lane == 0) mbar_arrive(&empty[sr.stage]);
        sr.advance();
      }
      if (split >= 0 && !finish_split(acc, part, flags, last, split, live, s)) continue;
      if (live) store_slab(acc, a, c, mult, out, m, row0, col0, R, N);
    }
  }
}

// Checks a schedule and encodes the tensor maps of x (M, R, K) and w
// (M, K, N) in boxes of x_box x 64 and w_box x BK (128 bytes wide), zeroes
// the split tiles' counts and launches the TMA body `kernel`.
template <typename Kernel, typename MT, typename T>
int launch_tma(Kernel kernel, CUtensorMapDataType type, uint32_t elem_bytes, uint32_t bk, uint32_t w_box, int smem,
               const void* x, const void* w, void* work, int M, int R, int K, int N, const WgSched& s,
               cudaStream_t st, const void* a, const void* c, const MT* mult, T* out) {
  using namespace wg_cfg;
  const bool split = s.grid > 0 && s.tiles % s.grid > 0 && s.chunks > 1;
  if (!hopper::sched_ok(s, M, MAX_GRID) || (split && work == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t x_box = 128 / elem_bytes;
  CUtensorMap xmap, wmap;
  if (!hopper::map_3d(&xmap, type, elem_bytes, x, K, R, M, x_box, 64) ||
      !hopper::map_3d(&wmap, type, elem_bytes, w, N, K, M, w_box, bk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && split) err = cudaMemsetAsync(work, 0, FLAG_BYTES, st);  // the split tiles' counts
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s.grid, THREADS, smem, st>>>(xmap, wmap, static_cast<const float*>(a), static_cast<const float*>(c), mult,
                                        out, static_cast<unsigned char*>(work), R, N, s);
  return static_cast<int>(cudaGetLastError());
}

// ---- simt (fp32) ------------------------------------------------------------

namespace simt_cfg {
constexpr int BM = 64, BN = 64, BK = 32, STAGES = 2, THREADS = 128;
constexpr int LDA = BK + 4, LDB = BN + 4, LDC = BN + 4;  // 16 bytes of padding a row
constexpr int A_ELEMS = BM * LDA, STAGE_ELEMS = A_ELEMS + BK * LDB;
constexpr int PIPE_BYTES = STAGES * STAGE_ELEMS * 4, C_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
}  // namespace simt_cfg

__global__ void __launch_bounds__(simt_cfg::THREADS)
fused_linear_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ a, const float* __restrict__ c,
                         const float* __restrict__ mult, float* __restrict__ out, int R, int K,
                         int N, bool vec) {
  using namespace simt_cfg;
  extern __shared__ __align__(128) unsigned char smem[];
  float* pipe = reinterpret_cast<float*>(smem);
  float* Cs = pipe;  // after the K loop the ring's bytes hold the output tile
  const int m = blockIdx.z, row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const float* xm = x + (size_t)m * R * K;
  const float* wm = w + (size_t)m * K * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;  // rows ty + 8i, columns tx + 16j

  auto load = [&](int slot, int kt) {
    float* As = pipe + slot * STAGE_ELEMS;
    stage<float, BM, BK, THREADS>(As, LDA, xm, R, K, row0, kt * BK, vec);
    stage<float, BK, BN, THREADS>(As + A_ELEMS, LDB, wm, K, N, kt * BK, col0, vec);
  };
  float acc[8][4] = {};
  k_loop<STAGES>((K + BK - 1) / BK, load, [&](int slot) {
    const float* As = pipe + slot * STAGE_ELEMS;
    const float* Bs = As + A_ELEMS;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = As[(ty + 8 * i) * LDA + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  });
  __syncthreads();  // the ring is drained: its bytes become the C tile
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) Cs[(ty + 8 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();

  // epilogue: fp32 affine + softplus (+ gate), masked store
  for (int i = tid; i < BM * BN; i += THREADS) {
    int r = i / BN, cc = i % BN;
    int gr = row0 + r, gn = col0 + cc;
    if (gr >= R || gn >= N) continue;
    float sp = softplus(Cs[r * LDC + cc] * a[(size_t)m * N + gn] + c[(size_t)m * N + gn]);
    size_t o = ((size_t)m * R + gr) * N + gn;
    if (mult != nullptr) sp *= mult[o];
    out[o] = sp;
  }
}

int launch_simt(const void* x, const void* w, const void* a, const void* c, const void* mult,
                void* out, int M, int R, int K, int N, bool vec, cudaStream_t s) {
  using namespace simt_cfg;
  cudaError_t err = cudaFuncSetAttribute(fused_linear_simt_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + BM - 1) / BM, (N + BN - 1) / BN, M);
  fused_linear_simt_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(a),
      static_cast<const float*>(c), static_cast<const float*>(mult), static_cast<float*>(out), R, K,
      N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The small_k body (K <= 32) on the plan of kernels/fused_linear.py::small_k_plan
// (tx, strips, splits, grid): mult (M, P, N) gates row r by its row r % P
// (P divides R; P = R without a gate), in x's dtype or, with mult_f32, fp32
// beside bf16 x; vec: 16-byte vectors (N % 8 == 0, aligned pointers). A plan
// the kernel cannot run is refused with cudaErrorInvalidValue.
extern "C" int fused_linear_small_k_launch(const void* x, const void* w, const void* a, const void* c,
                                           const void* mult, void* out, int M, int R, int P, int K, int N,
                                           int is_bf16, int mult_f32, int vec, int tx, int strips, int splits,
                                           int grid, void* stream) {
  const SkPlan p{tx, strips, splits, M * strips * splits};
  const bool ok = K >= 1 && K <= sk::MAX_K && tx >= 1 && tx <= sk::THREADS && sk::THREADS % tx == 0 && P >= 1 &&
                  R % P == 0 && splits >= 1 && (long long)strips * sk::VEC * tx >= N && grid >= 1 &&
                  grid <= p.units && (R + splits - 1) / splits * K <= sk::X_FLOATS &&
                  (K <= sk::REG_K || K * sk::VEC * tx <= sk::W_FLOATS) && (is_bf16 || !mult_f32);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && mult_f32)
    return launch_small_k<bf16, float>(x, w, a, c, mult, out, R, P, K, N, vec != 0, p, grid, s);
  if (is_bf16) return launch_small_k<bf16, bf16>(x, w, a, c, mult, out, R, P, K, N, vec != 0, p, grid, s);
  return launch_small_k<float, float>(x, w, a, c, mult, out, R, P, K, N, vec != 0, p, grid, s);
}

// body: 1 mma (bf16), 2 simt (fp32); mult_f32: mult is fp32 beside bf16 x
// (mma); vec: simt's 16-byte vectors (mma stages element by element). Any
// other pairing is refused with cudaErrorInvalidValue.
extern "C" int fused_linear_act_launch(const void* x, const void* w, const void* a, const void* c,
                                       const void* mult, void* out, int M, int R, int K, int N,
                                       int is_bf16, int mult_f32, int vec, int body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == MMA && is_bf16 && mult_f32)
    return launch_mma<float>(x, w, a, c, mult, out, M, R, K, N, s);
  if (body == MMA && is_bf16) return launch_mma<bf16>(x, w, a, c, mult, out, M, R, K, N, s);
  if (body == SIMT && !is_bf16 && !mult_f32) return launch_simt(x, w, a, c, mult, out, M, R, K, N, vec != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The TMA bodies on the schedule of kernels/fused_linear.py::wgmma_plan:
// wgmma (is_bf16: bf16 x, w and out; mult bf16 or, with mult_f32, fp32) at
// BK = 64, tf32x3 (fp32 x, w, out and mult) at BK = 32. work: the plan's
// workspace (a count a split tile, then a partial tile a block), null where
// no tile is split.
extern "C" int fused_linear_wgmma_launch(const void* x, const void* w, const void* a, const void* c,
                                         const void* mult, void* out, void* work, int M, int R, int K, int N,
                                         int is_bf16, int mult_f32, int row_tiles, int col_tiles, int steps,
                                         int tiles, int grid, int chunks, void* stream) {
  const WgSched s{row_tiles, col_tiles, steps, tiles, grid, chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16 && mult_f32) return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16)
    return launch_tma(fused_linear_tf32x3_kernel, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, tf_cfg::BK, 32,
                      tf_cfg::SMEM_BYTES, x, w, work, M, R, K, N, s, st, a, c, static_cast<const float*>(mult),
                      static_cast<float*>(out));
  if (mult_f32)
    return launch_tma(fused_linear_wgmma_kernel<float>, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wg_cfg::BK, 64,
                      wg_cfg::SMEM_BYTES, x, w, work, M, R, K, N, s, st, a, c, static_cast<const float*>(mult),
                      static_cast<bf16*>(out));
  return launch_tma(fused_linear_wgmma_kernel<bf16>, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, wg_cfg::BK, 64,
                    wg_cfg::SMEM_BYTES, x, w, work, M, R, K, N, s, st, a, c, static_cast<const bf16*>(mult),
                    static_cast<bf16*>(out));
}

// The dynamic shared memory a block of the TMA body takes (is_bf16: wgmma,
// else tf32x3), for kernels/fused_linear.py's plan to be checked against.
extern "C" int fused_linear_smem_bytes(int is_bf16) { return is_bf16 ? wg_cfg::SMEM_BYTES : tf_cfg::SMEM_BYTES; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
