// K5: the int8 eps in two kernel calls, member-stacked, Hopper (sm_90a).
//
//   l12: h1 = f * softplus((y_in @ w1) * a1 + c1)       (each product rounded to T)
//        h2 = softplus(int8(h1) @ w2 * (xs * s2) + c2),  hmax2 = row max of h2
//   l34: out = softplus(int8_zp(h2) @ w3 [+ 127 colsum3] * (xs * s3) + c3) @ w4
//
//   f: (M, R, K) bf16/fp32, y_in: (M, R, Ci), w1: (M, Ci, K) in f's type,
//   a1, c1: (M, K) fp32; w2, w3: (M, K, N) int8 stored K-contiguous; s, c,
//   colsum: (M, N) fp32; w4: (M, N, C) in f's type; out: (M, R, C) fp32.
//
// Replaces the TPU kernel ladine_tpu/kernels/int8_pallas.py::int8_eps_pallas_fused,
// bodies _kernel_l12 (lin1 in lin2's prologue) and _kernel_l34 (lin4 in
// lin3's epilogue). h1 and h3 never reach device memory in float: h1 only as
// its int8 codes, h3 not at all.
//
// Bound on an H100: each call reads the 5 members' int8 weight once (84 MB)
// and its activations (6.5 MB of f or h2 in bf16), at batch 8 bound by bytes.
//
// Design. l12: the TPU kernel computes h1 for a row block once, into an
// int8 VMEM scratch of (rows, 4096) that its N sweep reuses; on Hopper a
// 64-row int8 tile of K = 4096 does not fit a block's shared memory, and the
// row max over all of K is needed before any code is picked. So
// lin1_quantize_kernel takes one row a block: lin1 (Ci multiply-adds an
// element), softplus, the gate, |max| over the row in shared memory, then the
// symmetric codes; the GEMM of int8_gemm.cuh runs lin2 on them with K4's
// epilogue. l34: the zero-point codes of h2 come from the quantizing pre-pass
// (as in K4), and the GEMM's LIN4 epilogue contracts each h3 tile with its
// rows of w4 and adds the partial sums into out with fp32 atomics.

#include "int8_gemm.cuh"

namespace {

using namespace int8k;

// One block per (row, member): h1 into shared memory, its |max|, its codes.
template <typename T>
__global__ void lin1_quantize_kernel(const T* __restrict__ f, const T* __restrict__ y_in,
                                     const T* __restrict__ w1, const float* __restrict__ a1,
                                     const float* __restrict__ c1, int8_t* __restrict__ xq,
                                     float* __restrict__ xmax, int R, int K, int Ci) {
  extern __shared__ float h1s[];  // K floats
  __shared__ float red[32];
  const int m = blockIdx.y;
  const size_t row = (size_t)m * R + blockIdx.x;
  const T* yr = y_in + row * Ci;
  const T* w1m = w1 + (size_t)m * Ci * K;
  float mx = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float z = 0.f;
    for (int i = 0; i < Ci; ++i) z = fmaf(to_f(yr[i]), to_f(w1m[(size_t)i * K + k]), z);
    const float sp = to_f(from_f<T>(softplus(
        __fadd_rn(__fmul_rn(z, a1[(size_t)m * K + k]), c1[(size_t)m * K + k]))));
    const float v = to_f(from_f<T>(to_f(f[row * K + k]) * sp));
    h1s[k] = v;
    mx = fmaxf(mx, fabsf(v));
  }
  for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = 0.f;
  for (int w = 0; w < (int)(blockDim.x / 32); ++w) mx = fmaxf(mx, red[w]);
  const float xs = row_scale(mx, false);
  for (int k = threadIdx.x; k < K; k += blockDim.x) xq[row * K + k] = (int8_t)quant(h1s[k], xs, false);
  if (threadIdx.x == 0) xmax[row] = mx;
}

template <typename T>
int launch_l12(const void* f, const void* y_in, const void* w1, const void* a1, const void* c1,
               void* xq, void* xmax, const void* w2, const void* s2, const void* c2, void* h2,
               void* hmax2, int M, int R, int K, int Ci, int N, cudaStream_t st) {
  const int smem = K * (int)sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(lin1_quantize_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lin1_quantize_kernel<T><<<dim3(R, M), 256, smem, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(y_in), static_cast<const T*>(w1),
      static_cast<const float*>(a1), static_cast<const float*>(c1), static_cast<int8_t*>(xq),
      static_cast<float*>(xmax), R, K, Ci);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gemm<T, STORE>(static_cast<const int8_t*>(xq), static_cast<const float*>(xmax), w2,
                               s2, c2, nullptr, h2, hmax2, nullptr, nullptr, M, R, K, N, 0, st);
}

template <typename T>
int launch_l34(const void* h2, const void* hmax2, void* xq, const void* w3, const void* s3,
               const void* c3, const void* colsum3, const void* w4, void* out, int M, int R, int K,
               int N, int C, cudaStream_t st) {
  int err = launch_quantize_rows<T>(h2, static_cast<const float*>(hmax2), static_cast<int8_t*>(xq),
                                    (long long)M * R, K, true, st);
  if (err != 0) return err;
  return launch_gemm<T, LIN4>(static_cast<const int8_t*>(xq), static_cast<const float*>(hmax2), w3,
                              s3, c3, colsum3, nullptr, nullptr, w4, out, M, R, K, N, C, st);
}

}  // namespace

// xq: (M, R, K) int8 scratch, xmax: (M, R) fp32 scratch (max|h1|),
// hmax2: (M, R) fp32, zero-filled.
extern "C" int int8_eps_l12_launch(const void* f, const void* y_in, const void* w1, const void* a1,
                                   const void* c1, void* xq, void* xmax, const void* w2,
                                   const void* s2, const void* c2, void* h2, void* hmax2, int M,
                                   int R, int K, int Ci, int N, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_l12<__nv_bfloat16>(f, y_in, w1, a1, c1, xq, xmax, w2, s2, c2, h2, hmax2, M, R, K,
                                     Ci, N, st);
  return launch_l12<float>(f, y_in, w1, a1, c1, xq, xmax, w2, s2, c2, h2, hmax2, M, R, K, Ci, N, st);
}

// xq: (M, R, K) int8 scratch; out: (M, R, C) fp32, zero-filled.
extern "C" int int8_eps_l34_launch(const void* h2, const void* hmax2, void* xq, const void* w3,
                                   const void* s3, const void* c3, const void* colsum3,
                                   const void* w4, void* out, int M, int R, int K, int N, int C,
                                   int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_l34<__nv_bfloat16>(h2, hmax2, xq, w3, s3, c3, colsum3, w4, out, M, R, K, N, C, st);
  return launch_l34<float>(h2, hmax2, xq, w3, s3, c3, colsum3, w4, out, M, R, K, N, C, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
