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
// 160-row int8 tile of K = 4096 does not fit a block's shared memory, and the
// row max over all of K is needed before any code is picked. So a bandwidth
// pass, lin1_quantize_kernel, writes the symmetric codes of h1 and max|h1|
// once (bound by its bytes: f read, codes written, 9.8 MB at batch 8, ~0.003
// ms), and the GEMM of int8_gemm.cuh runs lin2 on them with K4's epilogue.
// The pass takes one row a block, 16 consecutive k a thread (K / 16 threads
// rounded up to whole warps: 256 at K = 4096): f, w1's Ci x 16 slice, a1 and
// c1 come in 16-byte vectors, h1 stays in registers, the row |max| comes from
// warp shuffles and one shared exchange of the warp maxima, and each thread
// stores its 16 codes as one 16-byte vector. The Ci terms of y_in @ w1 are
// summed in order without fused multiply-adds, as the plain version sums
// them, so both pick the same codes. l34: the zero-point codes of h2 come
// from the quantizing pre-pass (as in K4), and the GEMM's LIN4 epilogue
// contracts each h3 tile with its rows of w4 into its column tile's slot of
// a workspace, and the last block of a row tile to count in adds the slots
// in column-tile order into out: bit-reproducible at every N.

#include "int8_gemm.cuh"

namespace {

using namespace int8k;

// One (row, member) a block, 16 consecutive k a thread; blockDim is K / 16
// rounded up to whole warps, at most 512 (kernels/int8_eps_fused.py::
// lin1_threads). No launch bound: ptxas then keeps it at 72 registers, 3
// blocks an SM at K = 4096 (a bound of 512 threads took 81, and 2 blocks).
template <typename T>
__global__ void
lin1_quantize_kernel(const T* __restrict__ f, const T* __restrict__ y_in, const T* __restrict__ w1,
                     const float* __restrict__ a1, const float* __restrict__ c1,
                     int8_t* __restrict__ xq, float* __restrict__ xmax, int R, int K, int Ci) {
  __shared__ float red[32];
  const int m = blockIdx.y, k0 = threadIdx.x * 16;
  const size_t row = (size_t)m * R + blockIdx.x;
  const bool on = k0 < K;
  float h1[16], mx = 0.f;
  if (on) {
    float fv[16], z[16], av[16], cv[16];
    load8(f + row * K + k0, fv);
    load8(f + row * K + k0 + 8, fv + 8);
#pragma unroll
    for (int e = 0; e < 16; ++e) z[e] = 0.f;
    const T* yr = y_in + row * Ci;
    const T* wm = w1 + (size_t)m * Ci * K + k0;
    for (int i = 0; i < Ci; ++i) {
      const float yi = to_f(yr[i]);
      float wv[16];
      load8(wm + (size_t)i * K, wv);
      load8(wm + (size_t)i * K + 8, wv + 8);
#pragma unroll
      for (int e = 0; e < 16; ++e) z[e] = __fadd_rn(z[e], __fmul_rn(yi, wv[e]));
    }
    load8(a1 + (size_t)m * K + k0, av);
    load8(a1 + (size_t)m * K + k0 + 8, av + 8);
    load8(c1 + (size_t)m * K + k0, cv);
    load8(c1 + (size_t)m * K + k0 + 8, cv + 8);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float sp = to_f(from_f<T>(softplus(__fadd_rn(__fmul_rn(z[e], av[e]), cv[e]))));
      h1[e] = to_f(from_f<T>(__fmul_rn(fv[e], sp)));
      mx = fmaxf(mx, fabsf(h1[e]));
    }
  }
  for (int o = 16; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < (int)(blockDim.x / 32); ++w) mx = fmaxf(mx, red[w]);
  if (on) {
    const float xs = row_scale(mx, false);
    uint32_t q[4];
#pragma unroll
    for (int v = 0; v < 4; ++v)
      q[v] = pack4(quant(h1[4 * v], xs, false), quant(h1[4 * v + 1], xs, false),
                   quant(h1[4 * v + 2], xs, false), quant(h1[4 * v + 3], xs, false));
    *reinterpret_cast<uint4*>(xq + row * K + k0) = make_uint4(q[0], q[1], q[2], q[3]);
  }
  if (threadIdx.x == 0) xmax[row] = mx;
}

template <typename T>
int launch_lin1(const void* f, const void* y_in, const void* w1, const void* a1, const void* c1,
                void* xq, void* xmax, int M, int R, int K, int Ci, int threads, cudaStream_t st) {
  if (threads % 32 != 0 || threads > 512 || threads * 16 < K || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  lin1_quantize_kernel<T><<<dim3(R, M), threads, 0, st>>>(
      static_cast<const T*>(f), static_cast<const T*>(y_in), static_cast<const T*>(w1),
      static_cast<const float*>(a1), static_cast<const float*>(c1), static_cast<int8_t*>(xq),
      static_cast<float*>(xmax), R, K, Ci);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_l12(const void* f, const void* y_in, const void* w1, const void* a1, const void* c1,
               void* xq, void* xmax, const void* w2, const void* s2, const void* c2, void* h2,
               void* hmax2, void* work, int M, int R, int K, int Ci, int N, int threads,
               const hopper::WgSched& sc, cudaStream_t st) {
  int err = launch_lin1<T>(f, y_in, w1, a1, c1, xq, xmax, M, R, K, Ci, threads, st);
  if (err != 0) return err;
  return launch_gemm<T, STORE>(static_cast<const int8_t*>(xq), static_cast<const float*>(xmax), w2,
                               s2, c2, nullptr, h2, hmax2, nullptr, nullptr, work, nullptr, M, R, K, N, 0,
                               sc, st);
}

template <typename T>
int launch_l34(const void* h2, const void* hmax2, void* xq, const void* w3, const void* s3,
               const void* c3, const void* colsum3, const void* w4, void* out, void* work, void* lin4_work,
               int M, int R, int K, int N, int C, const hopper::WgSched& sc, cudaStream_t st) {
  int err = launch_quantize_rows<T>(h2, static_cast<const float*>(hmax2), static_cast<int8_t*>(xq),
                                    (long long)M * R, K, true, st);
  if (err != 0) return err;
  return launch_gemm<T, LIN4>(static_cast<const int8_t*>(xq), static_cast<const float*>(hmax2), w3,
                              s3, c3, colsum3, nullptr, nullptr, w4, out, work, lin4_work, M, R, K, N, C,
                              sc, st);
}

}  // namespace

// K5a's lin1 pass alone: xq (M, R, K) int8, xmax (M, R) fp32 (max|h1|);
// threads from kernels/int8_eps_fused.py::lin1_threads.
extern "C" int int8_lin1_launch(const void* f, const void* y_in, const void* w1, const void* a1,
                                const void* c1, void* xq, void* xmax, int M, int R, int K, int Ci,
                                int threads, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_lin1<__nv_bfloat16>(f, y_in, w1, a1, c1, xq, xmax, M, R, K, Ci, threads, st);
  return launch_lin1<float>(f, y_in, w1, a1, c1, xq, xmax, M, R, K, Ci, threads, st);
}

// xq: (M, R, K) int8 scratch, xmax: (M, R) fp32 scratch (max|h1|),
// hmax2: (M, R) fp32, zero-filled; work: the GEMM plan's split workspace
// (null where no tile is split); threads: the lin1 pass's block; row_tiles
// .. chunks: the GEMM's schedule (kernels/int8_linear.py::gemm_plan).
extern "C" int int8_eps_l12_launch(const void* f, const void* y_in, const void* w1, const void* a1,
                                   const void* c1, void* xq, void* xmax, const void* w2,
                                   const void* s2, const void* c2, void* h2, void* hmax2, void* work, int M,
                                   int R, int K, int Ci, int N, int threads, int row_tiles, int col_tiles,
                                   int steps, int tiles, int grid, int chunks, int is_bf16, void* stream) {
  const hopper::WgSched sc{row_tiles, col_tiles, steps, tiles, grid, chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_l12<__nv_bfloat16>(f, y_in, w1, a1, c1, xq, xmax, w2, s2, c2, h2, hmax2, work, M, R, K,
                                     Ci, N, threads, sc, st);
  return launch_l12<float>(f, y_in, w1, a1, c1, xq, xmax, w2, s2, c2, h2, hmax2, work, M, R, K, Ci, N,
                           threads, sc, st);
}

// xq: (M, R, K) int8 scratch; out: (M, R, C) fp32 (every element written);
// work: the GEMM plan's split workspace (null where no tile is split);
// lin4_work: the workspace of kernels/int8_eps_fused.py::l34_workspace_bytes,
// its counts zero (the kernel leaves them zero).
extern "C" int int8_eps_l34_launch(const void* h2, const void* hmax2, void* xq, const void* w3,
                                   const void* s3, const void* c3, const void* colsum3,
                                   const void* w4, void* out, void* work, void* lin4_work, int M, int R,
                                   int K, int N, int C, int row_tiles, int col_tiles, int steps, int tiles,
                                   int grid, int chunks, int is_bf16, void* stream) {
  const hopper::WgSched sc{row_tiles, col_tiles, steps, tiles, grid, chunks};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_l34<__nv_bfloat16>(h2, hmax2, xq, w3, s3, c3, colsum3, w4, out, work, lin4_work, M, R, K,
                                     N, C, sc, st);
  return launch_l34<float>(h2, hmax2, xq, w3, s3, c3, colsum3, w4, out, work, lin4_work, M, R, K, N, C,
                           sc, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
