// Fused member-stacked linear + affine + softplus (+ gate) for Hopper (sm_90a).
//
//   out[m] = softplus((x[m] @ w[m]) * a[m] + c[m]) [* mult[m]]
//   x: (M, R, K)  w: (M, K, N)  a, c: (M, N) fp32  mult, out: (M, R, N)
//
// Replaces the TPU kernel ladine_tpu/kernels/fused_linear.py::fused_linear_act
// (bodies _kernel and _kernel_mult). It is the eps layer of every reverse
// diffusion step: lin1 (K = 2C = 4, with the f gate as mult), lin2 and lin3
// (K = N = 4096).
//
// Bound on an H100: at serving batch sizes (R = 20 * B rows per member) the
// lin2/lin3 call reads each member's 4096 x 4096 weight once, 168 MB in bf16
// for the 5 members, against 2 * M * R * K * N operations; below about 350
// rows per member it is bound by those bytes (3.35 TB/s), above by the bf16
// tensor-core rate (989 TFLOP/s).
//
// Design: the member axis is a grid dimension (one launch covers all members,
// never a loop over members); the row tile is the fastest grid dimension, so
// the blocks that share a weight tile run together and find it in L2. A block
// computes a 64 x 64 output tile with a loop over K in steps of 32. The
// tiles stream through a ring of shared-memory stages (4 for bf16, 2 for
// fp32) filled by cp.async, so the loads of the next tiles are in flight
// while the current one is multiplied: with a load per K step that each
// step waits for, the kernel would wait on memory latency, not on bandwidth.
// Where K or N is not a multiple of the 16-byte vector (lin1, K = 4)
// the tile is staged element by element instead. bf16 tiles are multiplied on
// the tensor cores with WMMA (mma.sync) into fp32 accumulators, fp32 tiles
// with fp32 FMA. The epilogue applies a, c, softplus and mult in fp32 from a
// shared fp32 tile and stores in the input type; ragged R, N and K are
// masked. TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Tile shapes. bf16: WARPS_M x WARPS_N warps, each computing FRAG_M x FRAG_N
// WMMA fragments of 16 x 16; fp32: a 64 x 64 tile of 128 threads, 8 x 4
// outputs each. STAGES tiles of the K loop stream through shared memory.
template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int WARPS_M = 2, WARPS_N = 2, FRAG_M = 2, FRAG_N = 4;
  static constexpr int BM = WARPS_M * FRAG_M * 16, BN = WARPS_N * FRAG_N * 16;
  static constexpr int BK = 32, STAGES = 4, THREADS = 32 * WARPS_M * WARPS_N;
};
template <>
struct Cfg<float> {
  static constexpr int BM = 64, BN = 64, BK = 32, STAGES = 2, THREADS = 128;
};

// Shared memory: a ring of STAGES (A, B) tile pairs; after the K loop the
// same bytes hold the fp32 accumulator tile for the epilogue. Row strides are
// padded by 16 bytes: multiples of 16 bytes for WMMA, and rows that start in
// different banks.
template <typename T>
struct Smem {
  using C = Cfg<T>;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LDA = C::BK + PAD, LDB = C::BN + PAD, LDC = C::BN + 4;
  static constexpr int A_ELEMS = C::BM * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + C::BK * LDB;
  static constexpr int PIPE_BYTES = C::STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int C_BYTES = C::BM * LDC * 4;
  static constexpr int BYTES = PIPE_BYTES > C_BYTES ? PIPE_BYTES : C_BYTES;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16-byte global -> shared copy that bypasses registers; src_bytes = 0
// zero-fills the destination (the masked edge).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

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

template <typename T>
__global__ void __launch_bounds__(Cfg<T>::THREADS)
fused_linear_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ a, const float* __restrict__ c,
                        const T* __restrict__ mult, T* __restrict__ out,
                        int R, int K, int N, bool vec) {
  using C = Cfg<T>;
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* pipe = reinterpret_cast<T*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);

  const int m = blockIdx.z;
  const int row0 = blockIdx.x * C::BM;
  const int col0 = blockIdx.y * C::BN;
  const T* xm = x + (size_t)m * R * K;
  const T* wm = w + (size_t)m * K * N;
  const int tid = threadIdx.x;
  const int nk = (K + C::BK - 1) / C::BK;

  auto load = [&](int slot, int kt) {
    T* As = pipe + slot * S::STAGE_ELEMS;
    stage<T, C::BM, C::BK, C::THREADS>(As, S::LDA, xm, R, K, row0, kt * C::BK, vec);
    stage<T, C::BK, C::BN, C::THREADS>(As + S::A_ELEMS, S::LDB, wm, K, N, kt * C::BK, col0, vec);
  };
  // K loop over a ring of stages: tile kt is multiplied while tiles
  // kt+1 .. kt+STAGES-1 are in flight. One commit group per tile (empty past
  // the end) keeps the group count uniform for cp.async.wait_group.
  auto k_loop = [&](auto&& multiply) {
#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<C::STAGES - 2>();  // tile kt has landed
      __syncthreads();                 // ... for every thread; slot kt-1 is free
      int pf = kt + C::STAGES - 1;
      if (pf < nk) load(pf % C::STAGES, pf);
      cp_async_commit();
      const T* As = pipe + (kt % C::STAGES) * S::STAGE_ELEMS;
      multiply(As, As + S::A_ELEMS);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is drained: its bytes become the C tile
  };

  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    const int warp = tid / 32;
    const int wr = (warp / C::WARPS_N) * C::FRAG_M * 16, wc = (warp % C::WARPS_N) * C::FRAG_N * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::FRAG_M][C::FRAG_N];
#pragma unroll
    for (int i = 0; i < C::FRAG_M; ++i)
#pragma unroll
      for (int j = 0; j < C::FRAG_N; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    k_loop([&](const T* As, const T* Bs) {
#pragma unroll
      for (int kk = 0; kk < C::BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[C::FRAG_M];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[C::FRAG_N];
#pragma unroll
        for (int i = 0; i < C::FRAG_M; ++i)
          wmma::load_matrix_sync(af[i], As + (wr + i * 16) * S::LDA + kk, S::LDA);
#pragma unroll
        for (int j = 0; j < C::FRAG_N; ++j)
          wmma::load_matrix_sync(bf[j], Bs + kk * S::LDB + wc + j * 16, S::LDB);
#pragma unroll
        for (int i = 0; i < C::FRAG_M; ++i)
#pragma unroll
          for (int j = 0; j < C::FRAG_N; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
      }
    });
#pragma unroll
    for (int i = 0; i < C::FRAG_M; ++i)
#pragma unroll
      for (int j = 0; j < C::FRAG_N; ++j)
        wmma::store_matrix_sync(Cs + (wr + i * 16) * S::LDC + wc + j * 16, acc[i][j], S::LDC,
                                wmma::mem_row_major);
  } else {
    // fp32: each thread owns rows ty + 8i and columns tx + 16j of the tile
    static_assert(C::BM == 64 && C::BN == 64 && C::THREADS == 128, "fp32 thread mapping");
    const int tx = tid % 16, ty = tid / 16;
    float acc[8][4] = {};
    k_loop([&](const T* As, const T* Bs) {
#pragma unroll 4
      for (int kk = 0; kk < C::BK; ++kk) {
        float av[8], bv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = As[(ty + 8 * i) * S::LDA + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[kk * S::LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    });
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty + 8 * i) * S::LDC + tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  // epilogue: fp32 affine + softplus (+ gate), masked store
  for (int i = tid; i < C::BM * C::BN; i += C::THREADS) {
    int r = i / C::BN, cc = i % C::BN;
    int gr = row0 + r, gn = col0 + cc;
    if (gr >= R || gn >= N) continue;
    float z = Cs[r * S::LDC + cc] * a[(size_t)m * N + gn] + c[(size_t)m * N + gn];
    float sp = fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
    size_t o = ((size_t)m * R + gr) * N + gn;
    if (mult != nullptr) sp *= to_f(mult[o]);
    out[o] = from_f<T>(sp);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* c, const void* mult, void* out,
           int M, int R, int K, int N, int vec, cudaStream_t s) {
  using C = Cfg<T>;
  constexpr int bytes = Smem<T>::BYTES;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(fused_linear_act_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid((R + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, M);
  fused_linear_act_kernel<T><<<grid, C::THREADS, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(a),
      static_cast<const float*>(c), static_cast<const T*>(mult), static_cast<T*>(out), R, K, N,
      vec != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_linear_act_launch(const void* x, const void* w, const void* a, const void* c,
                                       const void* mult, void* out, int M, int R, int K, int N,
                                       int is_bf16, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, w, a, c, mult, out, M, R, K, N, vec, s);
  return launch<float>(x, w, a, c, mult, out, M, R, K, N, vec, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
