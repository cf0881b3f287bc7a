// One-shot fused attention for the ViT guidance backbone, Hopper (sm_90a).
//
//   o = softmax(q k^T * D^-0.5) v   on the JAX layout (B, N, H, D)
//
// Replaces the TPU kernel ladine_tpu/kernels/attention.py::flash_attention
// (body _attn_kernel). The statistics are fp32 whatever the input type; the
// probabilities are normalized, then rounded to the type of v before the
// product with v, as the TPU kernel does.
//
// Bound on an H100: at ViT-B/16 shapes (B = 8, N = 196, H = 12, D = 64) one
// call reads q, k and v once and writes o once, 9.6 MB in bf16 (0.0029 ms at
// 3.35 TB/s), against 4 * B * H * N^2 * D = 0.94 GFLOP (0.0010 ms at 989
// TFLOP/s): the bytes bound it, and K and V of every (b, h) fit in L2.
//
// bf16 body (D a multiple of 16 up to 128). One block of 4 warps per (64
// query rows, head, batch): 4 x 12 x 8 = 384 blocks at ViT-B, which fit the
// 132 SMs in one wave at 3 blocks an SM. cp.async copies the whole K (with
// the Q tile) and V of the block's (b, h) into shared memory, 16 bytes a
// thread and all in flight, K and V in separate groups so that the score
// pass starts while V lands; rows are padded by 16 bytes so that ldmatrix
// reads them without bank conflicts, and keys are zero-filled up to a
// multiple of the 32-key chunk. Each warp owns 16 query rows and keeps their
// Q fragments in registers (ldmatrix) for the whole key loop. S = Q K^T is
// mma.sync.m16n8k16 bf16 -> fp32: K's rows in shared memory are already the
// B operand's layout. Keys >= N are masked in registers. Two passes over the
// keys keep the TPU kernel's rounding exactly: pass 1 keeps a running row
// max and sum (the 4 lanes of a row combine theirs with shuffles); pass 2
// recomputes each S chunk, forms p = exp(s - m) / l in fp32, rounds it to
// bf16 straight into the A fragments of P V (no shared-memory round trip),
// and accumulates O with V's fragments read by ldmatrix.trans. O is stored
// from its fp32 accumulators as bf16 into the contiguous (B, N, H, D) output.
//
// fp32 body (any D of whole 16-byte vectors): one block of 8 warps per 16
// query rows with scalar fp32 FMA, each warp two rows: lanes split the keys
// for the scores and the head dimension for the product with v. It serves the
// fp32 predictor only, which has no bf16 tensor-core product to use.
//
// Both bodies loop over the real keys only, so the TPU kernel's padding to
// 128 lanes and its -0.7 * f32max mask of padded keys have no counterpart.
// q, k and v may be strided views (the slices of the fused qkv projection)
// sharing one stride pattern; D and the outer strides must be multiples of
// the 16-byte vector and the pointers 16-byte aligned. The output is
// contiguous (B, N, H, D).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace bf16mma;

// ---- bf16 body: mma.sync ----------------------------------------------------

constexpr int MQ = 64;  // query rows per block, 16 a warp
constexpr int MMA_THREADS = 128;
constexpr int KC = 32;  // keys per chunk of the key loop

__host__ __device__ inline int keys_padded(int N) { return (N + KC - 1) / KC * KC; }

__host__ inline size_t mma_smem_bytes(int N, int D) {
  return (size_t)(2 * keys_padded(N) + MQ) * (D + 8) * sizeof(bf16);
}

template <int DK>  // D = 16 * DK
__global__ void __launch_bounds__(MMA_THREADS)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int N, int H,
                     long long sb, long long sn, long long sh, float scale_log2) {
  constexpr int D = 16 * DK, LD = D + 8, VPR = D / 8;  // LD: row stride, 16 bytes of padding
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
  for (int i = tid; i < NP * VPR; i += MMA_THREADS) {
    int j = i / VPR, d = (i % VPR) * 8;
    bool ok = j < N;
    cp_async16(Ks + j * LD + d, k + (ok ? base + (size_t)j * sn + d : 0), ok ? 16 : 0);
  }
  for (int i = tid; i < MQ * VPR; i += MMA_THREADS) {
    int r = i / VPR, d = (i % VPR) * 8;
    bool ok = q0 + r < N;
    cp_async16(Qs + r * LD + d, q + (ok ? base + (size_t)(q0 + r) * sn + d : 0), ok ? 16 : 0);
  }
  cp_async_commit();
  for (int i = tid; i < NP * VPR; i += MMA_THREADS) {
    int j = i / VPR, d = (i % VPR) * 8;
    bool ok = j < N;
    cp_async16(Vs + j * LD + d, v + (ok ? base + (size_t)j * sn + d : 0), ok ? 16 : 0);
  }
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
        uint32_t vb[4];  // B fragments of d tiles 2 dj and 2 dj + 1, keys +0..15
        ldmatrix_x4_trans(vb, Vs + (kc * KC + half * 16 + (mi % 2) * 8 + mr) * LD + dj * 16 + (mi / 2) * 8);
        mma(acc[2 * dj], pa, vb[0], vb[1]);
        mma(acc[2 * dj + 1], pa, vb[2], vb[3]);
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
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(acc[j][2 * hh], acc[j][2 * hh + 1]);
  }
}

template <int DK>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
               long long sb, long long sn, long long sh, float scale, cudaStream_t s) {
  size_t bytes = mma_smem_bytes(N, 16 * DK);
  cudaError_t err = cudaFuncSetAttribute(attention_mma_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + MQ - 1) / MQ, H, B);
  attention_mma_kernel<DK><<<grid, MMA_THREADS, bytes, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), N, H, sb, sn, sh, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 body: scalar FMA ----------------------------------------------------

constexpr int QT = 16;  // query rows per block
constexpr int THREADS = 256;
constexpr int ROWS_PER_WARP = QT / (THREADS / 32);

// Shared row stride of K and V in floats: D plus one 16-byte vector.
__host__ __device__ inline int kv_ld(int D) { return D + 4; }

__host__ __device__ inline size_t kv_bytes(int N, int D) {
  return 2 * (size_t)N * kv_ld(D) * sizeof(float);  // a multiple of 16
}

__host__ inline size_t f32_smem_bytes(int N, int D) {
  return kv_bytes(N, D) + (size_t)QT * D * 4 + (size_t)QT * N * 4;
}

__global__ void __launch_bounds__(THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int N, int H, int D,
                     long long sb, long long sn, long long sh, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = kv_ld(D);
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + (size_t)N * ld;
  float* Qs = reinterpret_cast<float*>(smem + kv_bytes(N, D));
  float* Ss = Qs + QT * D;

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const int vpr = D / 4;  // 16-byte vectors per row
  for (int i = tid; i < N * vpr; i += THREADS) {
    int j = i / vpr, d = (i % vpr) * 4;
    size_t gofs = base + (size_t)j * sn + d;
    cp_async16(Ks + j * ld + d, k + gofs, 16);
    cp_async16(Vs + j * ld + d, v + gofs, 16);
  }
  cp_async_commit();
  for (int i = tid; i < QT * D; i += THREADS) {
    int r = i / D, d = i % D;
    Qs[i] = (q0 + r < N) ? q[base + (size_t)(q0 + r) * sn + d] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r >= N) break;
    const float* qr = Qs + r * D;
    float* sr = Ss + r * N;

    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const float* kj = Ks + j * ld;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < D; d += 4) {
        float4 kv = *reinterpret_cast<const float4*>(kj + d);
        s0 = fmaf(qr[d], kv.x, s0);
        s1 = fmaf(qr[d + 1], kv.y, s1);
        s0 = fmaf(qr[d + 2], kv.z, s0);
        s1 = fmaf(qr[d + 3], kv.w, s1);
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
    for (int j = lane; j < N; j += 32) sr[j] = sr[j] / sum;
    __syncwarp();

    // lane owns columns d, d + 1; even and odd keys sum separately
    float* orow = o + (((size_t)b * N + q0 + r) * H + h) * D;
    for (int d = 2 * lane; d < D; d += 64) {
      float e0 = 0.f, e1 = 0.f, o0 = 0.f, o1 = 0.f;
      int j = 0;
      for (; j + 1 < N; j += 2) {
        const float* va = Vs + j * ld + d;
        const float* vb = va + ld;
        float pa = sr[j], pb = sr[j + 1];
        e0 = fmaf(pa, va[0], e0);
        e1 = fmaf(pa, va[1], e1);
        o0 = fmaf(pb, vb[0], o0);
        o1 = fmaf(pb, vb[1], o1);
      }
      if (j < N) {
        const float* va = Vs + j * ld + d;
        e0 = fmaf(sr[j], va[0], e0);
        e1 = fmaf(sr[j], va[1], e1);
      }
      orow[d] = e0 + o0;
      orow[d + 1] = e1 + o1;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int N, int H, int D,
               long long sb, long long sn, long long sh, float scale, cudaStream_t s) {
  size_t bytes = f32_smem_bytes(N, D);
  cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + QT - 1) / QT, H, B);
  attention_f32_kernel<<<grid, THREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), N, H, D, sb, sn, sh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long long flash_attention_smem_bytes(int N, int D, int is_bf16) {
  return (long long)(is_bf16 ? mma_smem_bytes(N, D) : f32_smem_bytes(N, D));
}

// bf16 needs D in {16, 32, ..., 128} (the wrapper checks it); anything else
// is refused with cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int N, int H, int D, long long sb, long long sn,
                                      long long sh, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_f32(q, k, v, o, B, N, H, D, sb, sn, sh, scale, s);
  switch (D) {
    case 16: return launch_mma<1>(q, k, v, o, B, N, H, sb, sn, sh, scale, s);
    case 32: return launch_mma<2>(q, k, v, o, B, N, H, sb, sn, sh, scale, s);
    case 48: return launch_mma<3>(q, k, v, o, B, N, H, sb, sn, sh, scale, s);
    case 64: return launch_mma<4>(q, k, v, o, B, N, H, sb, sn, sh, scale, s);
    case 80: return launch_mma<5>(q, k, v, o, B, N, H, sb, sn, sh, scale, s);
    case 96: return launch_mma<6>(q, k, v, o, B, N, H, sb, sn, sh, scale, s);
    case 112: return launch_mma<7>(q, k, v, o, B, N, H, sb, sn, sh, scale, s);
    case 128: return launch_mma<8>(q, k, v, o, B, N, H, sb, sn, sh, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
