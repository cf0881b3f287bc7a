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
// launch covers all members. Three bodies, chosen by the wrapper from the
// shape and dtype (kernels/fused_linear.py::plan):
//
// small_k (K <= 16, both dtypes; lin1 up to 8 classes). An outer product and an elementwise
// pass. Its gate mult is the encoder's features, fp32 as flax's last
// BatchNorm leaves them (the TPU kernel multiplies by them in fp32), so beside
// bf16 x and w it reads mult in fp32: at the path's shape (M = 5, R = 160,
// N = 4096) it moves 20.0 MB (mult read, out written, w, a, c) and does 26
// MFLOP, so the bytes bound it at 0.0060 ms on 3.35 TB/s. Each thread
// computes 8 consecutive n of one row of one member (a flat index over
// M x R x N/8, so the member loop is in the grid): w's K x 8 slice and x's K
// values in registers, the K sum in fp32, mult read and out written as
// 16-byte vectors (element by element where N % 8 != 0 or a pointer is not
// 16-byte aligned). On the path mult comes from device memory (lin2 and lin3
// stream 168 MB through L2 every step), so one row a thread keeps the most
// loads of it in flight: 4 rows a thread, with w, a and c read once for them,
// was faster with mult in L2 and slower on the path.
//
// mma (K > 16, bf16; lin2 and lin3, and lin1 above 8 classes). At R = 160 rows a member the call reads
// each member's 4096 x 4096 weight once, 168 MB (0.050 ms at 3.35 TB/s; 0.054
// ms with x, mult and out), against 27 GFLOP (0.027 ms at 989 TFLOP/s): the
// weight bytes bound it, and the cost is reading the same bytes more than
// once. So a tile covers BM = 160 rows, every row of a member at batch 8: each
// weight strip leaves device memory once (larger R takes more row tiles).
// Every column tile re-reads its member's x (1.3 MB) from L2, so the tile is
// BN = 128 wide, which halves those re-reads against 64; so that the grid
// keeps 320 blocks (2 an SM: 128 registers a thread, 86 KB of shared memory),
// a cluster of 2 blocks splits K in two halves for one tile and the partial
// fp32 tiles are summed through distributed shared memory before the
// epilogue. 8 warps of 80 rows x 32 columns; K streams in steps of 32
// through a 4-stage ring of cp.async copies, so the loads of the next steps
// are in flight while one is multiplied. Fragments come from shared memory by
// ldmatrix (.trans for w's row-major K x N tile) into mma.sync.m16n8k16. The
// epilogue runs in registers on the accumulator fragments (a, c, softplus,
// mult, bf16 store): no shared C tile. Its gate mult is bf16 (lin2's h1) or
// fp32: lin1 at C > 8 classes (K = 2C > 16, 20 at the 10-class digits
// config) leaves small_k for this body with the fp32 features as its gate,
// read in fp32 as the TPU kernel reads them. Ragged R, N and K are
// zero-filled; where K or N is not a multiple of 8 or a pointer is not
// 16-byte aligned, tiles are staged element by element.
//
// simt (K > 16, fp32). 64 x 64 tiles of 128 threads, 8 x 4 fp32 FMA outputs
// each, a 2-stage cp.async ring and the epilogue from a shared fp32 tile. It
// serves the fp32 predictor, which has no tensor-core product to use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace bf16mma;

enum Body { SMALL_K = 0, MMA = 1, SIMT = 2 };

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

constexpr int MAX_SMALL_K = 16, SK_THREADS = 256;

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

template <typename T, typename MT>
__global__ void __launch_bounds__(SK_THREADS)
fused_linear_small_k_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const float* __restrict__ a, const float* __restrict__ c,
                            const MT* __restrict__ mult, T* __restrict__ out, int M, int R, int K,
                            int N, bool vec) {
  const int nv = (N + 7) / 8;
  const long long i = (long long)blockIdx.x * SK_THREADS + threadIdx.x;
  if (i >= (long long)M * R * nv) return;
  const int n0 = (int)(i % nv) * 8, valid = min(8, N - n0);
  const long long mr = i / nv;  // m * R + r
  const int m = (int)(mr / R);

  float xv[MAX_SMALL_K];
#pragma unroll
  for (int k = 0; k < MAX_SMALL_K; ++k) xv[k] = k < K ? to_f(x[mr * K + k]) : 0.f;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const T* wm = w + (size_t)m * K * N + n0;
#pragma unroll
  for (int k = 0; k < MAX_SMALL_K; ++k) {
    if (k >= K) break;
    float wv[8];
    load8_masked(wm + (size_t)k * N, wv, valid, vec);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = fmaf(xv[k], wv[e], acc[e]);
  }

  float av[8], cv[8], mv[8];
  load8_masked(a + (size_t)m * N + n0, av, valid, vec);
  load8_masked(c + (size_t)m * N + n0, cv, valid, vec);
  const size_t o = (size_t)mr * N + n0;
  if (mult != nullptr) load8_masked(mult + o, mv, valid, vec);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc[e] = softplus(acc[e] * av[e] + cv[e]);
    if (mult != nullptr) acc[e] *= mv[e];
  }
  if (vec) {
    store8(out + o, acc);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < valid) out[o + e] = from_f<T>(acc[e]);
  }
}

template <typename T, typename MT>
int launch_small_k(const void* x, const void* w, const void* a, const void* c, const void* mult,
                   void* out, int M, int R, int K, int N, bool vec, cudaStream_t s) {
  long long threads = (long long)M * R * ((N + 7) / 8);
  fused_linear_small_k_kernel<T, MT><<<(unsigned)((threads + SK_THREADS - 1) / SK_THREADS), SK_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(a),
      static_cast<const float*>(c), static_cast<const MT*>(mult), static_cast<T*>(out), M, R, K, N, vec);
  return static_cast<int>(cudaGetLastError());
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
                        const MT* __restrict__ mult, bf16* __restrict__ out, int R, int K, int N,
                        bool vec) {
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
    stage<bf16, BM, BK, THREADS>(As, LDA, xm, R, K, row0, k0 + kt * BK, vec);
    stage<bf16, BK, BN, THREADS>(As + A_ELEMS, LDB, wm, K, N, k0 + kt * BK, col0, vec);
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
          if (vec) {  // N % 8 == 0: both columns are in range, 4-byte aligned
            if (mult != nullptr) {
              float2 mv = load2(mult + o);
              v[0] *= mv.x, v[1] *= mv.y;
            }
            *reinterpret_cast<uint32_t*>(out + o) = pack_bf16(v[0], v[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (col + e >= N) continue;
              if (mult != nullptr) v[e] *= to_f(mult[o + e]);
              out[o + e] = __float2bfloat16(v[e]);
            }
          }
        }
    }
  }
  cluster.sync();  // the peer has read this block's partials
}

template <typename MT>
int launch_mma(const void* x, const void* w, const void* a, const void* c, const void* mult,
               void* out, int M, int R, int K, int N, bool vec, cudaStream_t s) {
  using namespace mma_cfg;
  cudaError_t err = cudaFuncSetAttribute(fused_linear_mma_kernel<MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(2 * ((R + BM - 1) / BM), (N + BN - 1) / BN, M);
  fused_linear_mma_kernel<MT><<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<const float*>(a),
      static_cast<const float*>(c), static_cast<const MT*>(mult), static_cast<bf16*>(out), R, K, N,
      vec);
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

// body: 0 small_k (either dtype), 1 mma (bf16), 2 simt (fp32); mult_f32: mult
// is fp32 beside bf16 x (small_k and mma). Any other pairing is refused with
// cudaErrorInvalidValue.
extern "C" int fused_linear_act_launch(const void* x, const void* w, const void* a, const void* c,
                                       const void* mult, void* out, int M, int R, int K, int N,
                                       int is_bf16, int mult_f32, int vec, int body, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == SMALL_K && K <= MAX_SMALL_K) {
    if (is_bf16 && mult_f32)
      return launch_small_k<bf16, float>(x, w, a, c, mult, out, M, R, K, N, vec != 0, s);
    if (is_bf16) return launch_small_k<bf16, bf16>(x, w, a, c, mult, out, M, R, K, N, vec != 0, s);
    return launch_small_k<float, float>(x, w, a, c, mult, out, M, R, K, N, vec != 0, s);
  }
  if (body == MMA && is_bf16 && mult_f32)
    return launch_mma<float>(x, w, a, c, mult, out, M, R, K, N, vec != 0, s);
  if (body == MMA && is_bf16) return launch_mma<bf16>(x, w, a, c, mult, out, M, R, K, N, vec != 0, s);
  if (body == SIMT && !is_bf16 && !mult_f32) return launch_simt(x, w, a, c, mult, out, M, R, K, N, vec != 0, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
