// One-shot fused attention for the ViT guidance backbone, Hopper (sm_90a).
//
//   o = softmax(q k^T * D^-0.5) v   on the JAX layout (B, N, H, D)
//
// Replaces the TPU kernel ladine_tpu/kernels/attention.py::flash_attention
// (body _attn_kernel). The statistics are fp32 whatever the input type; the
// probabilities are rounded to the type of v before the product with v, as
// the TPU kernel does.
//
// Bound on an H100: at ViT-B/16 shapes (N = 196, D = 64) one call reads q, k
// and v once and writes o once (4 * B * N * H * D elements) against
// 4 * B * H * N^2 * D operations, about 49 operations per byte in bf16, well
// under the card's ~295: the bytes bound it.
//
// Design: one block of 8 warps per (query-row tile of 16, head, batch). The
// block copies the whole K and V of its (b, h) into shared memory with
// cp.async, 16 bytes a thread and all copies in flight at once, so no thread
// waits on one load before it issues the next; the rows are padded by 16
// bytes so that the 16-byte reads of 8 neighbouring lanes fall in different
// banks. Each warp owns 2
// query rows: lanes split the keys for the scores (16-byte reads of a key
// row, the query row from shared fp32), reduce max and sum with shuffles,
// then split the head dimension, two columns a lane, for the product with v.
// The loops run over the N real keys only, so the TPU kernel's padding to 128
// lanes and its -0.7 * f32max mask of padded keys have no counterpart here.
// q, k and v may be strided views (the slices of the fused qkv projection)
// sharing one stride pattern; D and the outer strides must be multiples of
// the 16-byte vector and the pointers 16-byte aligned. The output is
// contiguous (B, N, H, D). The scalar FMAs leave the tensor cores idle:
// mma-based products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 16;  // query rows per block
constexpr int THREADS = 256;
constexpr int ROWS_PER_WARP = QT / (THREADS / 32);

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Shared row stride of K and V in elements: D plus one 16-byte vector.
__host__ __device__ inline int kv_ld(int D, int elem) { return D + 16 / elem; }

__host__ __device__ inline size_t kv_bytes(int N, int D, int elem) {
  return 2 * (size_t)N * kv_ld(D, elem) * elem;  // a multiple of 16
}

__host__ inline size_t smem_bytes(int N, int D, int elem) {
  return kv_bytes(N, D, elem) + (size_t)QT * D * 4 + (size_t)QT * N * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int N, int H, int D, long long sb, long long sn,
                 long long sh, float scale) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = kv_ld(D, sizeof(T));
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + (size_t)N * ld;
  float* Qs = reinterpret_cast<float*>(smem + kv_bytes(N, D, sizeof(T)));
  float* Ss = Qs + QT * D;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int vpr = D / V;  // vectors per row
  for (int i = tid; i < N * vpr; i += THREADS) {
    int j = i / vpr, d = (i % vpr) * V;
    size_t g = base + (size_t)j * sn + d;
    cp_async16(Ks + j * ld + d, k + g);
    cp_async16(Vs + j * ld + d, v + g);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < QT * D; i += THREADS) {
    int r = i / D, d = i % D;
    Qs[i] = (q0 + r < N) ? to_f(q[base + (size_t)(q0 + r) * sn + d]) : 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r >= N) break;
    const float* qr = Qs + r * D;
    float* sr = Ss + r * N;

    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const T* kj = Ks + j * ld;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < D; d += V) {
        alignas(16) T kv[V];
        *reinterpret_cast<uint4*>(kv) = *reinterpret_cast<const uint4*>(kj + d);
#pragma unroll
        for (int e = 0; e < V; e += 2) {
          s0 = fmaf(qr[d + e], to_f(kv[e]), s0);
          s1 = fmaf(qr[d + e + 1], to_f(kv[e + 1]), s1);
        }
      }
      float s = (s0 + s1) * scale;
      sr[j] = s;
      mx = fmaxf(mx, s);
    }
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      float p = expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < N; j += 32) sr[j] = to_f(from_f<T>(sr[j] / sum));
    __syncwarp();

    // lane owns columns d, d + 1; even and odd keys sum separately
    T* orow = o + (((size_t)b * N + q0 + r) * H + h) * D;
    for (int d = 2 * lane; d < D; d += 64) {
      float e0 = 0.f, e1 = 0.f, o0 = 0.f, o1 = 0.f;
      int j = 0;
      for (; j + 1 < N; j += 2) {
        const T* va = Vs + j * ld + d;
        const T* vb = va + ld;
        float pa = sr[j], pb = sr[j + 1];
        e0 = fmaf(pa, to_f(va[0]), e0);
        e1 = fmaf(pa, to_f(va[1]), e1);
        o0 = fmaf(pb, to_f(vb[0]), o0);
        o1 = fmaf(pb, to_f(vb[1]), o1);
      }
      if (j < N) {
        const T* va = Vs + j * ld + d;
        e0 = fmaf(sr[j], to_f(va[0]), e0);
        e1 = fmaf(sr[j], to_f(va[1]), e1);
      }
      orow[d] = from_f<T>(e0 + o0);
      orow[d + 1] = from_f<T>(e1 + o1);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int N, int H, int D,
           long long sb, long long sn, long long sh, float scale, cudaStream_t s) {
  size_t bytes = smem_bytes(N, D, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + QT - 1) / QT, H, B);
  attention_kernel<T><<<grid, THREADS, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, H, D, sb, sn, sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long flash_attention_smem_bytes(int N, int D, int is_bf16) {
  return (long long)smem_bytes(N, D, is_bf16 ? 2 : 4);
}

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int N, int H, int D, long long sb, long long sn,
                                      long long sh, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, s);
  return launch<float>(q, k, v, o, B, N, H, D, sb, sn, sh, scale, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
