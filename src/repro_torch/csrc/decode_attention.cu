// Slot-masked flash-decode over the serving KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fd_kernel` of
// src/repro/kernels/decode_attention.py (wrapper `decode_attention`): one
// query token per slot, online softmax over the slot's valid KV prefix,
// per-slot masking `col < length[s]`, dead blocks never read.  The int8 path
// folds `k_scale * hd^-0.5` into q before QK^T and multiplies `v_scale` into
// the output once, so no dequantized cache copy exists.
//
// What bounds it on the H100: memory.  A decode step reads every live K and
// V row once (at 1 byte an element for the int8 cache) against a handful of
// FLOPs per byte, so the least time is the live KV bytes over 3.35 TB/s.
//
// Design.  One block per (slot, kv-head); the G x hd query group is staged
// in shared memory once, pre-scaled.  A loop over KV blocks of 32 rows
// replaces the TPU's sequential grid axis and its `pl.when` skip: it stops
// at ceil(min(length, T) / 32), so a slot at position 17 reads one block of
// a 2048-deep cache.  Rows are read as 16-byte vectors and converted to f32
// in shared memory; warp g scores the 32 rows of the block for query g (one
// row per lane, warp-shuffle max/sum), then every thread updates its own
// head-dim columns of the f32 accumulator.  m/l/acc stay in f32; masked
// scores are -1e30, as in the reference.  Rows past the slot's length are
// not read and count as zero (the ragged last block), so the kernel needs
// no tiling gate.  Not yet done: split-KV across blocks for long caches with
// few slots, and indexing the page table inside the kernel instead of the
// gathered [S, T, Hkv, hd] view.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kBlockRows = 32;    // KV rows per loop step: one per lane
constexpr int kMaxGroup = 8;      // query heads per kv-head (2 per warp)
constexpr float kNeg = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16-byte vector of KV elements -> floats.
template <typename KT> struct Vec16;
template <> struct Vec16<int8_t> {
  static constexpr int N = 16;
  __device__ static void unpack(const uint4& u, float* out) {
    const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(b[i]);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* out) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(b[i]);
  }
};
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* out) {
    const float* b = reinterpret_cast<const float*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = b[i];
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// q: [S, Hkv, G, HD]; k, v: [S, T, Hkv, HD]; lengths: [S] int32;
// k_scale, v_scale: [S, Hkv] f32 (QUANT only); out: [S, Hkv, G, HD].
template <typename QT, typename KT, int HD, bool QUANT>
__global__ void __launch_bounds__(kThreads) fd_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k,
    const KT* __restrict__ v, const int* __restrict__ lengths,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    QT* __restrict__ out, int T, int Hkv, int G, float scale) {
  constexpr int VN = Vec16<KT>::N;
  constexpr int VPR = HD / VN;                       // vectors per KV row
  constexpr int DPT = (HD + kThreads - 1) / kThreads;
  __shared__ float q_s[kMaxGroup][HD];
  __shared__ float k_s[kBlockRows][HD + 1];          // +1: conflict-free rows
  __shared__ float v_s[kBlockRows][HD];
  __shared__ float p_s[kMaxGroup][kBlockRows];
  __shared__ float alpha_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t sh = static_cast<size_t>(s) * Hkv + h;
  const int len = min(lengths[s], T);
  const float qscale = QUANT ? scale * k_scale[sh] : scale;

  const QT* qp = q + sh * G * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    q_s[i / HD][i % HD] = to_float(qp[i]) * qscale;

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float acc[kMaxGroup][DPT];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[g][i] = 0.f;

  const size_t row_stride = static_cast<size_t>(Hkv) * HD;   // elements
  const KT* kb = k + static_cast<size_t>(s) * T * row_stride
                   + static_cast<size_t>(h) * HD;
  const KT* vb = v + static_cast<size_t>(s) * T * row_stride
                   + static_cast<size_t>(h) * HD;

  for (int j0 = 0; j0 < len; j0 += kBlockRows) {
    __syncthreads();               // last block's readers are done with k_s/v_s
    for (int i = tid; i < kBlockRows * VPR; i += kThreads) {
      const int r = i / VPR;
      const int c = (i % VPR) * VN;
      float kv[VN], vv[VN];
      if (j0 + r < len) {
        const size_t off = static_cast<size_t>(j0 + r) * row_stride + c;
        Vec16<KT>::unpack(*reinterpret_cast<const uint4*>(kb + off), kv);
        Vec16<KT>::unpack(*reinterpret_cast<const uint4*>(vb + off), vv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) { kv[e] = 0.f; vv[e] = 0.f; }
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[r][c + e] = kv[e];
        v_s[r][c + e] = vv[e];
      }
    }
    __syncthreads();

    // scores and the online-softmax state: warp w owns queries w and w + 4
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + 4 * r;
      if (g < G) {                                   // warp-uniform
        float sc = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) sc += q_s[g][d] * k_s[lane][d];
        sc = (j0 + lane < len) ? sc : kNeg;
        const float m_new = fmaxf(m[r], warp_max(sc));
        const float p = expf(sc - m_new);
        const float alpha = expf(m[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(p);
        m[r] = m_new;
        p_s[g][lane] = p;
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g < G) {
        const float a = alpha_s[g];
#pragma unroll
        for (int i = 0; i < DPT; ++i) {
          const int d = tid + i * kThreads;
          if (d < HD) {
            float sum = 0.f;
#pragma unroll 8
            for (int j = 0; j < kBlockRows; ++j) sum += p_s[g][j] * v_s[j][d];
            acc[g][i] = acc[g][i] * a + sum;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = warp + 4 * r;
    if (g < G && lane == 0) l_s[g] = l[r];
  }
  __syncthreads();
  const float vs = QUANT ? v_scale[sh] : 1.f;
  QT* op = out + sh * G * HD;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) {
    if (g < G) {
      const float inv = 1.f / fmaxf(l_s[g], 1e-20f);
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const int d = tid + i * kThreads;
        if (d < HD) {
          float o = acc[g][i] * inv;
          if (QUANT) o *= vs;
          store(op + g * HD + d, o);
        }
      }
    }
  }
}

template <typename QT, typename KT, bool QUANT>
cudaError_t launch_hd(const void* q, const void* k, const void* v,
                      const int* lengths, const float* ks, const float* vs,
                      void* out, int S, int T, int Hkv, int G, int hd,
                      float scale, cudaStream_t st) {
  const dim3 grid(Hkv, S);
  const QT* qp = static_cast<const QT*>(q);
  const KT* kp = static_cast<const KT*>(k);
  const KT* vp = static_cast<const KT*>(v);
  QT* op = static_cast<QT*>(out);
  switch (hd) {
    case 16:
      fd_kernel<QT, KT, 16, QUANT><<<grid, kThreads, 0, st>>>(
          qp, kp, vp, lengths, ks, vs, op, T, Hkv, G, scale);
      break;
    case 32:
      fd_kernel<QT, KT, 32, QUANT><<<grid, kThreads, 0, st>>>(
          qp, kp, vp, lengths, ks, vs, op, T, Hkv, G, scale);
      break;
    case 64:
      fd_kernel<QT, KT, 64, QUANT><<<grid, kThreads, 0, st>>>(
          qp, kp, vp, lengths, ks, vs, op, T, Hkv, G, scale);
      break;
    case 128:
      fd_kernel<QT, KT, 128, QUANT><<<grid, kThreads, 0, st>>>(
          qp, kp, vp, lengths, ks, vs, op, T, Hkv, G, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t: 0 on a clean launch.  q_dtype: 0 f32, 1 bf16;
// kv_dtype: q_dtype, or 2 for int8 with k_scale/v_scale.
extern "C" int qft_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* k_scale, const void* v_scale, void* out, int S, int T,
    int Hkv, int G, int hd, int q_dtype, int kv_dtype, float scale,
    void* stream) {
  if (S < 1 || T < 1 || Hkv < 1 || G < 1 || G > kMaxGroup || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaError_t rc = cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32)
    rc = launch_hd<float, float, false>(q, k, v, len, ks, vs, out, S, T, Hkv,
                                        G, hd, scale, st);
  else if (q_dtype == kF32 && kv_dtype == kI8)
    rc = launch_hd<float, int8_t, true>(q, k, v, len, ks, vs, out, S, T, Hkv,
                                        G, hd, scale, st);
  else if (q_dtype == kBF16 && kv_dtype == kBF16)
    rc = launch_hd<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, len, ks, vs, out, S, T, Hkv, G, hd, scale, st);
  else if (q_dtype == kBF16 && kv_dtype == kI8)
    rc = launch_hd<__nv_bfloat16, int8_t, true>(
        q, k, v, len, ks, vs, out, S, T, Hkv, G, hd, scale, st);
  return static_cast<int>(rc);
}
