// K4: member-stacked int8 linear + dequant + softplus + row max, Hopper (sm_90a).
//
//   h[m]    = softplus(int8(x[m]) @ w[m] [+ 127 colsum] * (xs * s[m]) + c[m])   in x's type
//   hmax[m] = max over each row of the stored h[m]
//   x: (M, R, K) bf16/fp32, xmax: (M, R) fp32 (max|x| symmetric, max x zero-point),
//   w: (M, K, N) int8 stored K-contiguous, s, c, colsum: (M, N) fp32
//
// Replaces the TPU kernel ladine_tpu/kernels/int8_pallas.py::int8_linear_softplus
// (body _kernel), which int8_eps_pallas runs twice a reverse step: lin2
// (symmetric) and lin3 (zero-point 127).
//
// Bound on an H100: at serving batch sizes (R = 20 * B rows per member) a
// call reads the 5 members' 4096 x 4096 int8 weights once (84 MB) and the
// bf16 activations in and out (13 MB), against 2 * M * R * K * N int8
// operations; at batch 8 it is bound by those bytes (3.35 TB/s): ~0.029 ms.
//
// Design: the TPU kernel quantizes its row tile in the prologue of every
// (row, N) grid step. On Hopper that would cost ~15 SIMT instructions per
// element for each of the 32 N tiles, about 7x the int8 tensor-core work of
// the tile, so the quantization runs once per call as a pre-pass
// (quantize_rows_kernel: x is read once, int8 x written once, 10 MB at
// batch 8), and the GEMM of int8_gemm.cuh reads the int8 rows: 160 x 128
// tiles, K split over a cluster pair, each weight strip read once. Its
// epilogue applies the folded affine and softplus, stores h and takes the
// row max (int8_gemm.cuh).

#include "int8_gemm.cuh"

namespace {

template <typename T>
int launch(const void* x, const void* xmax, void* xq, const void* w, const void* s, const void* c,
           const void* colsum, void* h, void* hmax, int M, int R, int K, int N, int row_tiles,
           int col_tiles, cudaStream_t st) {
  const bool zp = colsum != nullptr;
  int err = int8k::launch_quantize_rows<T>(x, static_cast<const float*>(xmax),
                                           static_cast<int8_t*>(xq), (long long)M * R, K, zp, st);
  if (err != 0) return err;
  return int8k::launch_gemm<T, int8k::STORE>(static_cast<const int8_t*>(xq),
                                             static_cast<const float*>(xmax), w, s, c, colsum, h,
                                             hmax, nullptr, nullptr, M, R, K, N, 0, row_tiles,
                                             col_tiles, st);
}

}  // namespace

// xq: (M, R, K) int8 scratch; hmax: (M, R) fp32, zero-filled; colsum null
// for the symmetric scheme; row_tiles, col_tiles: the GEMM's plan
// (kernels/int8_linear.py::gemm_plan).
extern "C" int int8_linear_softplus_launch(const void* x, const void* xmax, void* xq, const void* w,
                                           const void* s, const void* c, const void* colsum,
                                           void* h, void* hmax, int M, int R, int K, int N,
                                           int row_tiles, int col_tiles, int is_bf16,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, xmax, xq, w, s, c, colsum, h, hmax, M, R, K, N, row_tiles,
                                 col_tiles, st);
  return launch<float>(x, xmax, xq, w, s, c, colsum, h, hmax, M, R, K, N, row_tiles, col_tiles, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
