// Blocked attention with online softmax, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fa_kernel` of
// src/repro/kernels/flash_attention.py (wrapper `flash_attention`, layout
// shim `kernels/ops.py: attention_prefill`):
//     o = softmax(q k^T * hd^-0.5 [causal mask]) v, with f32 m/l/acc and the
//     upper-triangle key tiles of a causal query tile never visited.
// q, o: a [B, S, H, hd] view; k, v: [B, Sk, Hkv, hd] views, each with its own
// element strides and hd contiguous.  Query head h reads kv head
// h / (H / Hkv) (GQA), so no repeated copy of k and v exists.  The
// [BH, S, hd] form of the reference is the same call with H = Hkv = 1.
// f32 or bf16 in, the same type out.
//
// What bounds it on the H100: at the teacher's prefill shape (B 16 x S 512,
// 32/8 heads, hd 128, bf16) the bytes of q, k, v and o take 0.050 ms at
// 3.35 TB/s and the causal matmul work 0.035 ms on the bf16 tensor cores, so
// bytes.  This first kernel runs both products as f32 FMAs on the CUDA cores
// (0.51 ms at 67 TFLOP/s), read from shared memory, and is bound by those.
//
// Design.  One 256-thread block per (batch * head, 64-query tile).  The
// query tile is staged once in shared memory as f32; a loop over 64-row key
// tiles (the TPU's sequential grid axis) stages K and V as f32, ends at the
// diagonal for a causal tile, and masks keys past Sk, so any S is taken.
// Each thread scores a 4 x 4 block (rows ty + 16i, keys tx + 16j); the row
// max and sum are reduced across the 16 lanes of a half-warp with xor
// shuffles, which leave every lane with the same bits.  The probabilities go
// through shared memory to the P.V product, where each thread owns the same
// 4 rows and hd/16 columns (tx + 16jj) of the f32 accumulator, so the
// rescale by exp(m_old - m_new) needs no exchange.  Masked scores are
// -1e30 as in the reference; expf is the accurate one (no fast-math); no
// atomics, so two runs give the same bits.  Shared rows of Q and K are
// padded by one float so the column reads of the score loop are free of
// bank conflicts.  Not yet done: mma/wgmma products on bf16 operands, TMA
// staging of K/V through a ring of tiles, and query tiles sized to fill the
// 132 SMs at small batch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // key rows per loop step
constexpr int kThreads = 256;      // 16 x 16 threads
constexpr int kTM = 4;             // rows per thread: ty + 16 i
constexpr int kTN = 4;             // keys per thread in the score tile
constexpr int kLdP = kBK + 1;      // padded row of the probability tile
constexpr float kNeg = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {                   // elements between batch, position, head
  long long b, s, h;
};

template <int kHD>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBQ) * (kHD + 1) + kBK * (kHD + 1) +
         kBK * kHD + kBQ * kLdP;
}

// kHD: the head-dim capacity of this instantiation (a multiple of 16);
// columns hd .. kHD-1 are zero in shared memory and never stored.
template <typename T, int kHD>
__global__ void __launch_bounds__(kThreads) fa_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int S, int Sk, int H,
    int Hkv, int hd, Strides sq, Strides sk, Strides sv, Strides so,
    float scale, int causal) {
  constexpr int kLd = kHD + 1;
  constexpr int kNJ = kHD / 16;     // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;       // [kBK][kLd]
  float* vs = ks + kBK * kLd;       // [kBK][kHD]
  float* ps = vs + kBK * kHD;       // [kBQ][kLdP]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int i = threadIdx.x; i < kBQ * kHD; i += kThreads) {
    const int r = i / kHD;
    const int d = i % kHD;
    const int qi = q0 + r;
    qs[r * kLd + d] = (qi < S && d < hd)
        ? to_float(qb[static_cast<long long>(qi) * sq.s + d]) : 0.f;
  }

  float m[kTM], l[kTM], acc[kTM][kNJ];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) acc[i][jj] = 0.f;
  }

  // a causal tile needs keys 0 .. q0 + kBQ - 1 only: the rest lie above the
  // diagonal for every one of its rows
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                // the last step is done with ks, vs, ps
    for (int i = threadIdx.x; i < kBK * kHD; i += kThreads) {
      const int r = i / kHD;
      const int d = i % kHD;
      const int kj = k0 + r;
      const bool ok = kj < Sk && d < hd;
      ks[r * kLd + d] =
          ok ? to_float(kb[static_cast<long long>(kj) * sk.s + d]) : 0.f;
      vs[r * kHD + d] =
          ok ? to_float(vb[static_cast<long long>(kj) * sv.s + d]) : 0.f;
    }
    __syncthreads();

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float a[kTM], c[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = qs[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kTN; ++j) c[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) s[i][j] += a[i] * c[j];
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kj >= Sk || (causal && kj > qi)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) p[i] = ps[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const float vv = vs[c * kHD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < kTM; ++i) acc[i][jj] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* orow = o + b * so.b + h * so.h + static_cast<long long>(qi) * so.s;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int d = tx + 16 * jj;
      if (d < hd) store(orow + d, acc[i][jj] / denom);
    }
  }
}

template <typename T, int kHD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Sk, int H, int Hkv, int hd, Strides sq,
                   Strides sk, Strides sv, Strides so, float scale,
                   int causal, cudaStream_t st) {
  const size_t smem = smem_floats<kHD>() * sizeof(float);
  cudaError_t rc = cudaFuncSetAttribute(
      fa_kernel<T, kHD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return rc;
  const dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  fa_kernel<T, kHD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Sk, H, Hkv, hd, sq, sk,
      sv, so, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int Sk, int H, int Hkv, int hd,
                      Strides sq, Strides sk, Strides sv, Strides so,
                      float scale, int causal, cudaStream_t st) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, S, Sk, H, Hkv, hd, sq, sk, sv, so,
                         scale, causal, st);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, S, Sk, H, Hkv, hd, sq, sk, sv, so,
                         scale, causal, st);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, S, Sk, H, Hkv, hd, sq, sk, sv, so,
                          scale, causal, st);
  return launch<T, 256>(q, k, v, o, B, S, Sk, H, Hkv, hd, sq, sk, sv, so,
                        scale, causal, st);
}

}  // namespace

// Returns a cudaError_t: 0 on a clean launch.  Strides are in elements, in
// the order batch, position, head; dtype: 0 f32, 1 bf16.
extern "C" int qft_flash_attention(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Sk, int H, int Hkv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int dtype,
    void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || H < 1 || Hkv < 1 || H % Hkv || hd < 1 ||
      hd > 256 || (S + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh};
  const Strides sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == kF32)
    rc = launch_hd<float>(q, k, v, o, B, S, Sk, H, Hkv, hd, sq, sk, sv, so,
                          scale, causal, st);
  else if (dtype == kBF16)
    rc = launch_hd<__nv_bfloat16>(q, k, v, o, B, S, Sk, H, Hkv, hd, sq, sk,
                                  sv, so, scale, causal, st);
  return static_cast<int>(rc);
}
