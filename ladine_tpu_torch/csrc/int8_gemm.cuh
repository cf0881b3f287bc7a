// Shared parts of the int8 eps kernels for Hopper (sm_90a): the per-row
// quantizer, the quantizing pre-pass, and the member-stacked int8 GEMM with
// its two epilogues. Included by int8_linear.cu (K4) and int8_eps_fused.cu
// (K5); each compiles the instances it launches.
//
// The GEMM, for every member m (a grid dimension, so one launch covers all):
//
//   acc = xq[m] @ w[m]                     int8 x int8 -> int32, exact
//   z   = (acc [+ 127 * colsum]) * (xs * s) + c,   xs = max(xmax, 1e-8) / (127 | 254)
//   h   = softplus(z) rounded to the activation type T
//   STORE: h[m] = h, hmax[m, r] = max over the row of the stored h
//   LIN4:  out[m] += h @ w4[m]              (h never reaches device memory)
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
// Design. Tensor-core math is mma.sync.m16n8k32 on s8: both operands
// K-contiguous, so the weight is kept in that layout from quantization on
// (ldmatrix cannot transpose 8-bit elements), and every fragment is a plain
// 32-bit shared-memory load. A block computes a 160 x 128 output tile: BM =
// 160 is every row of a member at batch 8, so each 128-column weight strip
// leaves device memory and L2 once (larger R takes more row tiles; the 32
// column blocks of a member each re-read its int8 x from L2). 8 warps of 80
// rows x 32 columns: 5 x 4 mma tiles, 80 int32 accumulators a thread. K
// streams in 64-byte steps through a 4-stage ring of cp.async copies, so the
// loads of the next steps are in flight while one is multiplied. A cluster
// of 4 blocks splits the K steps of one tile between its ranks, in turn:
// the ranks read adjacent 64-byte pieces of the same weight rows side by
// side, which streams from device memory faster than one 64-byte piece a
// row, and the grid has 640 blocks at the path's shape (2 an SM: 2.4 waves,
// where a cluster pair's 320 blocks left a second wave of 56 alone). int32
// addition does not depend on order, so the split changes no bit. Rank q
// then finishes n-tile q of every warp, adding its peers' int32 partial sums
// for it through distributed shared memory, so all 8 warps share the
// epilogue with 20 values a thread (a whole tile's epilogue on
// half the warps, 80 values a thread beside 80 live accumulators, cost more
// than the products). Rows past R are never staged or multiplied: a warp
// skips its 16-row slabs that lie wholly past R (it still reaches every
// barrier), and rows past R inside a live slab, like columns past N, only
// feed accumulators that the epilogue masks. The K tail is zero-filled; K
// must be a multiple of 16 (16-byte copies). Which tiles a launch covers is
// the wrapper's plan (kernels/int8_linear.py::gemm_plan).
//
// The epilogue runs in registers on the accumulator fragments. STORE writes
// h as pairs of adjacent columns (one 32-bit store a pair in bf16) and takes
// each row's max as it goes; the 4 warp columns meet in shared memory, then
// one atomicMax a row a block on the float's bit pattern goes into a
// zero-filled hmax (softplus is >= 0: exact and order-free; the TPU kernel
// carries the row max along its sequential N axis, and nothing carries over
// between blocks here). LIN4 contracts its h values with their rows of w4 as
// it goes and sums across the warp columns in shared memory. Rank q of the
// cluster then takes the q-th quarter of the tile's rows: it adds each
// row's 4 ranks' sums in rank order through distributed shared memory and
// makes one fp32 atomicAdd a row, a class and a column tile into a
// zero-filled out. Where N fits one column tile (N <= 128, the
// 10-class digits model's 64 among them) out is so the same bit for bit
// from run to run: the reverse chain at 10 classes carried the run-to-run
// rounding of 4 atomics a tile to 3e-4 of the probabilities (a graphed
// request against its eager run). Several column tiles (full width: 32)
// still meet in atomics in no fixed order.
//
// Numerics follow ladine_tpu/kernels/int8_pallas.py: round half to even
// (rintf), IEEE division in the quantizer, and __fmul_rn/__fadd_rn keep the
// association acc * (xs * s) + c without fused multiply-adds, so the kernel
// and its plain PyTorch version pick the same int8 code for the same input.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8k {

constexpr int BM = 160, BN = 128, BK = 64, STAGES = 4;
constexpr int WARPS_N = 4, THREADS = 256;  // 8 warps of 80 rows x 32 columns
constexpr int WM = BM / 2, WN = BN / WARPS_N, FM = WM / 16, FN = WN / 8;
constexpr int LD = BK + 16;  // shared row stride in bytes: 16-byte aligned, rows in distinct banks
constexpr int A_BYTES = BM * LD, STAGE_BYTES = A_BYTES + BN * LD;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 92,160: 2 blocks an SM
constexpr int CLUSTER = 4;        // blocks splitting the K steps of one tile
constexpr int FJ = FN / CLUSTER;  // n-tiles of a warp that each rank finishes
constexpr int PART_BYTES = CLUSTER * FM * FJ * 4 * THREADS * 4;  // int32 partials, by destination
constexpr int CLASSES = 2;  // lin4 classes an epilogue pass (the path has 2)
constexpr int ROWS_A_RANK = BM / CLUSTER;  // the rows whose lin4 sums each rank adds up
static_assert(BM % CLUSTER == 0, "the ranks split a tile's rows evenly");
static_assert(FN % CLUSTER == 0, "each rank finishes whole n-tiles");
static_assert(PART_BYTES + (CLASSES * WARPS_N * BM + BM) * 4 <= SMEM_BYTES,
              "partials, row sums and row scales fit the ring");

enum Epilogue { STORE = 0, LIN4 = 1 };

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The shared-memory offset of byte `byte` of row `row` of a staged tile.
__device__ __forceinline__ int tile_off(int row, int byte) { return row * LD + byte; }

// d += a (16 x 32, row) @ b (32 x 8, col), s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage bytes [k0, k0 + BK) of rows [row0, row0 + ROWS) of a K-contiguous
// (n_rows, K) int8 matrix, zero-filling bytes at or past K. Rows at or past
// n_rows are not staged (they only feed masked accumulators).
template <int ROWS>
__device__ __forceinline__ void stage(unsigned char* dst, const int8_t* src, int n_rows, int K,
                                      int row0, int k0) {
  constexpr int VECS = ROWS * (BK / 16);
#pragma unroll
  for (int it = 0; it < (VECS + THREADS - 1) / THREADS; ++it) {
    int i = threadIdx.x + it * THREADS;
    if (VECS % THREADS != 0 && i >= VECS) break;
    int r = i / (BK / 16), kv = (i % (BK / 16)) * 16;
    int gr = row0 + r, gk = k0 + kv;
    if (gr >= n_rows) continue;
    bool ok = gk < K;
    cp_async16(dst + tile_off(r, kv), src + (ok ? (size_t)gr * K + gk : 0), ok ? 16 : 0);
  }
}

// Rank q of a cluster sums the K steps q, q + CLUSTER, q + 2 CLUSTER, ...
// of one tile: the ranks, running side by side, read adjacent pieces of the
// same weight rows, CLUSTER x BK contiguous bytes a row at a time.
template <typename T, int EPI>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 2)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xmax,
                 const int8_t* __restrict__ wt, const float* __restrict__ s,
                 const float* __restrict__ c, const float* __restrict__ colsum,
                 T* __restrict__ h, float* __restrict__ hmax, const T* __restrict__ w4,
                 float* __restrict__ out, int R, int K, int N, int C) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  const int rank = (int)cluster.block_rank();  // blockIdx.x % CLUSTER
  const int m = blockIdx.z, row0 = (blockIdx.x / CLUSTER) * BM, col0 = blockIdx.y * BN;
  const int nk = max(0, ((K + BK - 1) / BK - rank + CLUSTER - 1) / CLUSTER);
  const int8_t* A = xq + (size_t)m * R * K;
  const int8_t* B = wt + (size_t)m * N * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment coordinates
  const int wr = (warp / WARPS_N) * WM, wc = (warp % WARPS_N) * WN;
  const int slabs = min(FM, max(0, (R - row0 - wr + 15) / 16));  // warp-uniform: with a row < R
  const bool zp = colsum != nullptr;

  auto load = [&](int slot, int kt) {
    unsigned char* As = smem + slot * STAGE_BYTES;
    stage<BM>(As, A, R, K, row0, (kt * CLUSTER + rank) * BK);
    stage<BN>(As + A_BYTES, B, N, K, col0, (kt * CLUSTER + rank) * BK);
  };

  int acc[FM][FN][4];  // rows wr + 16 i + g (+ 8), columns wc + 8 j + 2 t4 (+ 1)
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // K loop over the ring: step kt is multiplied while kt+1 .. kt+STAGES-1
  // are in flight; one commit group per step (empty past the end) keeps the
  // group count uniform for cp.async.wait_group.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // ... for every thread; slot kt-1 is free
    int pf = kt + STAGES - 1;
    if (pf < nk) load(pf % STAGES, pf);
    cp_async_commit();
    if (slabs == 0) continue;
    const unsigned char* As = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* Bs = As + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      const int k4 = kk + t4 * 4;
      uint32_t b[FN][2];
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int n = wc + 8 * j + g;
        b[j][0] = lds32(Bs + tile_off(n, k4));
        b[j][1] = lds32(Bs + tile_off(n, k4 + 16));
      }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        if (i >= slabs) break;
        const int r = wr + 16 * i + g;
        uint32_t a[4] = {lds32(As + tile_off(r, k4)), lds32(As + tile_off(r + 8, k4)),
                         lds32(As + tile_off(r, k4 + 16)), lds32(As + tile_off(r + 8, k4 + 16))};
#pragma unroll
        for (int j = 0; j < FN; ++j) mma_s8(acc[i][j], a, b[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it now holds partial sums

  // Rank q finishes n-tiles [q FJ, (q + 1) FJ) of every warp, so every warp
  // shares the epilogue. The other n-tiles' partial sums go to their ranks
  // through shared memory, by destination, lanes innermost (no bank
  // conflicts); rank q adds its peers' through distributed shared memory.
  // After them: the epilogue's (class, warp column, row) sums and the
  // tile's row scales.
  int* part = reinterpret_cast<int*>(smem);
  float* red = reinterpret_cast<float*>(smem + PART_BYTES);
  float* xs_s = red + CLASSES * WARPS_N * BM;
  const int tid = threadIdx.x, wcol = warp % WARPS_N;
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q) {
    if (q == rank) continue;
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      if (i >= slabs) break;
#pragma unroll
      for (int jj = 0; jj < FJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(((q * FM + i) * FJ + jj) * 4 + e) * THREADS + tid] = acc[i][q * FJ + jj][e];
    }
  }
  if (tid < BM) {
    const int r = row0 + tid;
    xs_s[tid] = r < R ? row_scale(xmax[(size_t)m * R + r], zp) : 0.f;
  }
  int fin[FM][FJ][4];  // rows wr + 16 i + g (+ 8), columns wc + 8 (rank FJ + jj) + 2 t4 (+ 1)
#pragma unroll
  for (int q = 0; q < CLUSTER; ++q)
    if (q == rank) {
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int jj = 0; jj < FJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) fin[i][jj][e] = acc[i][q * FJ + jj][e];
    }
  cluster.sync();  // the peers' partials and this block's row scales are written
  for (int d = 1; d < CLUSTER; ++d) {
    const int* peer = cluster.map_shared_rank(part, (rank + d) % CLUSTER);
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      if (i >= slabs) break;
#pragma unroll
      for (int jj = 0; jj < FJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          fin[i][jj][e] += peer[(((rank * FM + i) * FJ + jj) * 4 + e) * THREADS + tid];
    }
  }

  // The epilogue takes each row's max (STORE) or its partial sums of
  // CLASSES classes of lin4 (LIN4; more classes take more passes, each
  // recomputing h) as it goes; the warp columns meet in red. STORE: one
  // atomicMax a row a block follows. LIN4: each rank leaves its row sums in
  // red, and each row's 4 are added in rank order by the rank that owns the
  // row, one atomicAdd a row and class a tile.
  constexpr int NQ = EPI == STORE ? 1 : CLASSES;
  const bool pairs = N % 2 == 0;  // then col < N implies col + 1 < N, 2-element aligned
  for (int c0 = 0; c0 < (EPI == STORE ? 1 : C); c0 += NQ) {
    float rs[FM][2][NQ];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int q = 0; q < NQ; ++q) rs[i][hh][q] = 0.f;
#pragma unroll
    for (int jj = 0; jj < FJ; ++jj) {
      const int col = col0 + wc + 8 * (rank * FJ + jj) + 2 * t4;
      float sv[2], cv[2], zv[2], w4v[2][NQ];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = col + e < N;
        sv[e] = ok ? s[(size_t)m * N + col + e] : 0.f;
        cv[e] = ok ? c[(size_t)m * N + col + e] : 0.f;
        zv[e] = (ok && zp) ? __fmul_rn(127.f, colsum[(size_t)m * N + col + e]) : 0.f;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          w4v[e][q] = (EPI == LIN4 && ok && c0 + q < C)
                          ? to_f(w4[((size_t)m * N + col + e) * C + c0 + q])
                          : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        if (i >= slabs) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int lr = wr + 16 * i + g + 8 * hh, r = row0 + lr;
          const float xs = xs_s[lr];
          T o[2];
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = 0.f;
            if (r < R && col + e < N) {
              float a = __int2float_rn(fin[i][jj][hh * 2 + e]);
              if (zp) a = __fadd_rn(a, zv[e]);
              o[e] = from_f<T>(softplus(__fadd_rn(__fmul_rn(a, __fmul_rn(xs, sv[e])), cv[e])));
              v[e] = to_f(o[e]);
            }
          }
          if constexpr (EPI == STORE) {
            if (r < R && col < N) {
              T* dst = h + ((size_t)m * R + r) * N + col;
              if (pairs) {
                store2(dst, o[0], o[1]);
              } else {
                dst[0] = o[0];
                if (col + 1 < N) dst[1] = o[1];
              }
            }
            rs[i][hh][0] = fmaxf(rs[i][hh][0], fmaxf(v[0], v[1]));
          } else {
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              rs[i][hh][q] = fmaf(v[1], w4v[1][q], fmaf(v[0], w4v[0][q], rs[i][hh][q]));
          }
        }
      }
    }
    // the 4 lanes of a group hold the same rows
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float v = rs[i][hh][q];
#pragma unroll
          for (int o = 1; o < 4; o *= 2) {
            const float u = __shfl_xor_sync(0xffffffffu, v, o);
            v = EPI == STORE ? fmaxf(v, u) : v + u;
          }
          if (t4 == 0) red[(q * WARPS_N + wcol) * BM + wr + 16 * i + g + 8 * hh] = v;
        }
    __syncthreads();
    const int rr = row0 + tid;  // the row thread tid < BM finishes
    if (tid < BM && rr < R) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (EPI == LIN4 && c0 + q >= C) break;
        float v = red[q * WARPS_N * BM + tid];
#pragma unroll
        for (int w = 1; w < WARPS_N; ++w) {
          const float u = red[(q * WARPS_N + w) * BM + tid];
          v = EPI == STORE ? fmaxf(v, u) : v + u;
        }
        if constexpr (EPI == STORE)
          atomicMax(reinterpret_cast<int*>(hmax) + (size_t)m * R + rr, __float_as_int(v));
        else
          red[q * WARPS_N * BM + tid] = v;  // this rank's sum of the row (a slot only this thread reads)
      }
    }
    if constexpr (EPI == LIN4) {
      cluster.sync();  // every rank's row sums are in its red
      const int lr = rank * ROWS_A_RANK + tid, r4 = row0 + lr;  // rank q adds up the q-th quarter of the rows
      if (tid < ROWS_A_RANK && r4 < R) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          if (c0 + q >= C) break;
          float v = cluster.map_shared_rank(red, 0)[q * WARPS_N * BM + lr];
#pragma unroll
          for (int d = 1; d < CLUSTER; ++d) v += cluster.map_shared_rank(red, d)[q * WARPS_N * BM + lr];
          atomicAdd(out + ((size_t)m * R + r4) * C + c0 + q, v);
        }
      }
      if (c0 + NQ < C) cluster.sync();  // the sums are read before another pass overwrites them (the last: below)
    } else {
      __syncthreads();  // red is read before another pass overwrites it
    }
  }
  cluster.sync();  // the peers have read this block's partials
}

// The launch covers rows row_tiles x BM >= R and columns col_tiles x BN >=
// N, each tile by a cluster of CLUSTER blocks.
template <typename T, int EPI>
int launch_gemm(const int8_t* xq, const float* xmax, const void* wt, const void* s, const void* c,
                const void* colsum, void* h, void* hmax, const void* w4, void* out, int M, int R,
                int K, int N, int C, int row_tiles, int col_tiles, cudaStream_t st) {
  if ((long long)row_tiles * BM < R || (long long)col_tiles * BN < N)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_gemm_kernel<T, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(CLUSTER * row_tiles, col_tiles, M);
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      xq, xmax, static_cast<const int8_t*>(wt), static_cast<const float*>(s),
      static_cast<const float*>(c), static_cast<const float*>(colsum), static_cast<T*>(h),
      static_cast<float*>(hmax), static_cast<const T*>(w4), static_cast<float*>(out), R, K, N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace int8k
