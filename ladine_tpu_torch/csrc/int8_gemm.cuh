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
// Design. Tensor-core math is mma.sync.m16n8k32 on s8: both operands
// K-contiguous, so the weight is kept in that layout from quantization on
// (ldmatrix cannot transpose 8-bit elements), and every fragment is a plain
// 32-bit shared-memory load. A block computes a 64 x 128 output tile with 8
// warps of 32 x 32; K streams in 64-byte steps through a 4-stage ring of
// cp.async copies, so the loads of the next steps are in flight while one is
// multiplied. The row tile is the fastest grid dimension: the blocks that
// share a weight tile run together and meet in L2.
//
// Across blocks nothing carries over (the TPU kernel carries the row max and
// the lin4 sum along its sequential N axis): softplus is >= 0, so the row max
// is an atomicMax on the float's bit pattern into a zero-filled hmax, exact
// and order-free; the lin4 partial sums are fp32 atomicAdds into a
// zero-filled out, whose order changes from run to run. Ragged R, N and the
// K tail are masked (zero-filled tiles), so padding never reaches hmax or the
// lin4 sum. K must be a multiple of 16 (16-byte copies).
//
// Numerics follow ladine_tpu/kernels/int8_pallas.py: round half to even
// (rintf), IEEE division in the quantizer, and __fmul_rn/__fadd_rn keep the
// association acc * (xs * s) + c without fused multiply-adds, so the kernel
// and its plain PyTorch version pick the same int8 code for the same input.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int8k {

constexpr int BM = 64, BN = 128, BK = 64, STAGES = 4;
constexpr int WARPS_M = 2, WARPS_N = 4, THREADS = 32 * WARPS_M * WARPS_N;
constexpr int LD = BK + 16;  // shared row stride in bytes: 16-byte aligned, rows in distinct banks
constexpr int A_BYTES = BM * LD, STAGE_BYTES = A_BYTES + BN * LD;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;  // 61,440: above 48 KB, set as dynamic

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

// d += a (16 x 32, row) @ b (32 x 8, col), s8 inputs, s32 accumulators
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage a ROWS x BK byte tile of a K-contiguous (n_rows, K) int8 matrix,
// zero-filling rows >= n_rows and the K tail.
template <int ROWS>
__device__ __forceinline__ void stage(unsigned char* dst, const int8_t* src, int n_rows, int K, int row0,
                                      int k0) {
  constexpr int VECS = ROWS * (BK / 16);
#pragma unroll
  for (int it = 0; it < (VECS + THREADS - 1) / THREADS; ++it) {
    int i = threadIdx.x + it * THREADS;
    if (VECS % THREADS != 0 && i >= VECS) break;
    int r = i / (BK / 16), kv = (i % (BK / 16)) * 16;
    int gr = row0 + r, gk = k0 + kv;
    bool ok = gr < n_rows && gk < K;
    cp_async16(dst + r * LD + kv, src + (ok ? (size_t)gr * K + gk : 0), ok ? 16 : 0);
  }
}

template <typename T, int EPI>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xmax,
                 const int8_t* __restrict__ wt, const float* __restrict__ s,
                 const float* __restrict__ c, const float* __restrict__ colsum,
                 T* __restrict__ h, float* __restrict__ hmax, const T* __restrict__ w4,
                 float* __restrict__ out, int R, int K, int N, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m = blockIdx.z, row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int8_t* A = xq + (size_t)m * R * K;
  const int8_t* B = wt + (size_t)m * N * K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment coordinates
  const int wm = (warp / WARPS_N) * 32, wn = (warp % WARPS_N) * 32;
  const int nk = (K + BK - 1) / BK;
  const bool zp = colsum != nullptr;

  auto load = [&](int slot, int kt) {
    unsigned char* As = smem + slot * STAGE_BYTES;
    stage<BM>(As, A, R, K, row0, kt * BK);
    stage<BN>(As + A_BYTES, B, N, K, col0, kt * BK);
  };

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
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
    const unsigned char* As = smem + (kt % STAGES) * STAGE_BYTES;
    const unsigned char* Bs = As + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned char* p = As + (wm + i * 16 + g) * LD + kk + t4 * 4;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * LD);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * LD + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* p = Bs + (wn + j * 8 + g) * LD + kk + t4 * 4;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  cp_async_wait<0>();

  // Epilogue from the registers. acc[i][j][hh * 2 + e] is row
  // wm + i*16 + g + 8*hh, column wn + j*8 + t4*2 + e of the tile.
  float xs[2][2];
  bool row_ok[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      int r = row0 + wm + i * 16 + g + 8 * hh;
      row_ok[i][hh] = r < R;
      xs[i][hh] = row_ok[i][hh] ? row_scale(xmax[(size_t)m * R + r], zp) : 0.f;
    }
  float hv[2][4][4];  // the stored h, as float; 0 where masked
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int col = col0 + wn + j * 8 + t4 * 2 + e;
      bool col_ok = col < N;
      float sv = col_ok ? s[(size_t)m * N + col] : 0.f;
      float cv = col_ok ? c[(size_t)m * N + col] : 0.f;
      float zv = (col_ok && zp) ? __fmul_rn(127.f, colsum[(size_t)m * N + col]) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float v = 0.f;
          if (col_ok && row_ok[i][hh]) {
            float a = __int2float_rn(acc[i][j][hh * 2 + e]);
            if (zp) a = __fadd_rn(a, zv);
            T o = from_f<T>(softplus(__fadd_rn(__fmul_rn(a, __fmul_rn(xs[i][hh], sv)), cv)));
            if constexpr (EPI == STORE) {
              int r = row0 + wm + i * 16 + g + 8 * hh;
              h[((size_t)m * R + r) * N + col] = o;
            }
            v = to_f(o);
          }
          hv[i][j][hh * 2 + e] = v;
        }
    }

  if constexpr (EPI == STORE) {
    // row max: the 4 lanes of a group hold the same rows
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) v = fmaxf(v, fmaxf(hv[i][j][hh * 2], hv[i][j][hh * 2 + 1]));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (t4 == 0 && row_ok[i][hh]) {
          int r = row0 + wm + i * 16 + g + 8 * hh;
          atomicMax(reinterpret_cast<int*>(hmax) + (size_t)m * R + r, __float_as_int(v));
        }
      }
  } else {
    // lin4: this tile's columns contract with their rows of w4
    for (int cc = 0; cc < C; ++cc) {
      float w4v[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int col = col0 + wn + j * 8 + t4 * 2 + e;
          w4v[j][e] = col < N ? to_f(w4[((size_t)m * N + col) * C + cc]) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) p = fmaf(hv[i][j][hh * 2 + e], w4v[j][e], p);
          p += __shfl_xor_sync(0xffffffffu, p, 1);
          p += __shfl_xor_sync(0xffffffffu, p, 2);
          if (t4 == 0 && row_ok[i][hh]) {
            int r = row0 + wm + i * 16 + g + 8 * hh;
            atomicAdd(out + ((size_t)m * R + r) * C + cc, p);
          }
        }
    }
  }
}

template <typename T, int EPI>
int launch_gemm(const int8_t* xq, const float* xmax, const void* wt, const void* s, const void* c,
                const void* colsum, void* h, void* hmax, const void* w4, void* out, int M, int R,
                int K, int N, int C, cudaStream_t st) {
  auto kernel = int8_gemm_kernel<T, EPI>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + BM - 1) / BM, (N + BN - 1) / BN, M);
  kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      xq, xmax, static_cast<const int8_t*>(wt), static_cast<const float*>(s),
      static_cast<const float*>(c), static_cast<const float*>(colsum), static_cast<T*>(h),
      static_cast<float*>(hmax), static_cast<const T*>(w4), static_cast<float*>(out), R, K, N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace int8k
