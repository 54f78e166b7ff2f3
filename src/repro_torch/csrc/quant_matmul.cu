// W4 (int4 nibble-packed) matmul with hoisted scales, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_qmm_int8_kernel` (+ `_unpack_tile`) of
// src/repro/kernels/quant_matmul.py (wrapper `quant_matmul`):
//     y = (x * s_wl) @ unpack(qw), with s_wr applied to one partial sum per
//     K-group and f32 accumulation.
// x: [M, K] f32 or bf16; qw: [K/2, N] uint8, row 2i in the low nibble and
// row 2i+1 in the high one; s_wl: [K] f32; s_wr: [K/group, N] f32 (group = K
// for the layerwise and channel layouts) -> y: [M, N] in x's type.
//
// What bounds it on the H100: at decode M (1 to 8 rows) the weight bytes —
// K*N/2 of them — over 3.35 TB/s; at prefill M (128 rows) it is still below
// the ~295 FLOP/byte ridge, so bytes again, but this first kernel runs its
// product on CUDA-core FMAs and is bound by their rate long before that.
//
// Design.  A 256-thread block owns a 64 x 64 output tile and walks K in
// steps of 64.  Each step stages the x tile, multiplied by s_wl (bm*bk
// multiplies instead of bk*bn on the weights), k-major in shared memory,
// and unpacks the 32 x 64 packed bytes into a 64 x 64 bf16 tile in shared
// memory: bf16 holds every value in [-8, 7] exactly, so the weight never
// exists as an f32 tile in memory.  Each thread keeps a 4 x 4 block of
// per-group partial sums in registers; at every group boundary the partials
// are scaled by that group's s_wr row and added to the accumulators — s_wr
// never multiplies a [bk, bn] tile.  Rows past M are masked, so decode M
// needs no padding; N and K must tile by 64 and a group must be a multiple
// of 16 that divides or is divided by 64 (kernels/ops.py: kernel_tiles_ok).
// Not yet done: wgmma/mma.sync tensor-core products, TMA staging, and a
// split-K or small-BM variant that fills the card at decode M.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTM = 4;
constexpr int kTN = 4;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float nibble(uint32_t b) {
  const int v = static_cast<int>(b & 0xFu);
  return static_cast<float>(v > 7 ? v - 16 : v);     // sign-extend
}

template <typename T>
__global__ void __launch_bounds__(kThreads) qmm_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ qw,
    const float* __restrict__ s_wl, const float* __restrict__ s_wr,
    T* __restrict__ y, int M, int N, int K, int group) {
  __shared__ float xs[kBK][kBM + 1];   // (x * s_wl)^T; +1: conflict-free stores
  __shared__ __align__(16) __nv_bfloat16 ws[kBK][kBN];    // unpacked int4

  const int tx = threadIdx.x % 16;     // output columns 4tx .. 4tx+3
  const int ty = threadIdx.x / 16;     // output rows ty, ty+16, ty+32, ty+48
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int step = min(group, kBK);    // rows between partial-sum flushes

  float acc[kTM][kTN];
  float part[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) { acc[i][j] = 0.f; part[i][j] = 0.f; }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK;
      const int c = i % kBK;
      const int m = m0 + r;
      xs[c][r] = m < M
          ? to_float(x[static_cast<size_t>(m) * K + k0 + c]) * s_wl[k0 + c]
          : 0.f;
    }
    for (int i = threadIdx.x; i < (kBK / 2) * kBN; i += kThreads) {
      const int r = i / kBN;
      const int c = i % kBN;
      const uint32_t b = qw[static_cast<size_t>(k0 / 2 + r) * N + n0 + c];
      ws[2 * r][c] = __float2bfloat16_rn(nibble(b));
      ws[2 * r + 1][c] = __float2bfloat16_rn(nibble(b >> 4));
    }
    __syncthreads();

    for (int kc = 0; kc < kBK; kc += step) {
#pragma unroll 8
      for (int kk = kc; kk < kc + step; ++kk) {
        float a[kTM];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty + 16 * i];
        const uint2 raw = *reinterpret_cast<const uint2*>(&ws[kk][4 * tx]);
        const __nv_bfloat16* wb = reinterpret_cast<const __nv_bfloat16*>(&raw);
        float b[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = __bfloat162float(wb[j]);
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) part[i][j] += a[i] * b[j];
      }
      if ((k0 + kc + step) % group == 0) {
        const float4 sr = *reinterpret_cast<const float4*>(
            s_wr + static_cast<size_t>((k0 + kc) / group) * N + n0 + 4 * tx);
        const float srv[kTN] = {sr.x, sr.y, sr.z, sr.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            acc[i][j] += part[i][j] * srv[j];
            part[i][j] = 0.f;
          }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m < M) {
      T* yr = y + static_cast<size_t>(m) * N + n0 + 4 * tx;
#pragma unroll
      for (int j = 0; j < kTN; ++j) store(yr + j, acc[i][j]);
    }
  }
}

}  // namespace

// Returns a cudaError_t: 0 on a clean launch.  x_dtype: 0 f32, 1 bf16.
extern "C" int qft_quant_matmul(const void* x, const void* qw,
                                const void* s_wl, const void* s_wr, void* y,
                                int M, int N, int K, int group, int x_dtype,
                                void* stream) {
  const bool group_ok = group >= 16 && group % 16 == 0 && K % group == 0 &&
                        (group % kBK == 0 || kBK % group == 0);
  if (M < 1 || N % kBN || K % kBK || !group_ok || (M + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* q = static_cast<const uint8_t*>(qw);
  const float* wl = static_cast<const float*>(s_wl);
  const float* wr = static_cast<const float*>(s_wr);
  if (x_dtype == kF32) {
    qmm_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), q, wl, wr, static_cast<float*>(y), M, N,
        K, group);
  } else if (x_dtype == kBF16) {
    qmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), q, wl, wr,
        static_cast<__nv_bfloat16*>(y), M, N, K, group);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
