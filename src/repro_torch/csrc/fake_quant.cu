// Fused fake-quantization, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fq_kernel` of
// src/repro/kernels/fake_quant.py (wrapper `fake_quant_kernel`, custom VJP
// `_fq_fwd`/`_fq_bwd`):
//     forward   y = clip(rint(x / s), -qmax, qmax) * s
//     backward  gx and gs, gs summed to the scale's broadcast shape, under
//               one of two rules (kernels/ref.py: fake_quant_grad_ref):
//       rule 0 "kernel": _fq_bwd's hard indicator |x/s| <= qmax;
//       rule 1 "ste":    the gradient of s * clip(ste_round(x/s)) as autograd
//                        takes it, 1/2 where |rint(x/s)| == qmax.
// x, g, y, gx: [R, C] f32 or bf16, row-major.  s: f32, read at its own
// shape through two element strides (0 on a broadcast axis): [R, C],
// [R, 1], [1, C] or [1, 1] -- the reference broadcast it to [R, C] first.
//
// What bounds it on the H100: bytes.  Forward: x read, y written (8 B per
// f32 element) plus the scale (4 B when it is full); backward: g and x read,
// gx written (12 B) plus a full scale read and gs written (8 B).  A few
// flops per element, far below the ~20 flop/byte ridge of f32 CUDA cores.
//
// Design.  The division is IEEE (__fdiv_rn) and the rounding rint (half to
// even), with no fast-math, so the forward and gx equal the PyTorch
// composition bit for bit; every product is an explicit __fmul_rn so the
// compiler cannot contract it into an FMA.  Elementwise passes put one row
// on blockIdx.x and 1024 columns on blockIdx.y (256 threads, 4 strided
// elements each: neighbouring threads read neighbouring addresses).  The
// scale gradient is reduced without atomics, so two runs give the same
// bits: a [R, 1] scale takes one block per row and a fixed-order block
// sum; a [1, C] or [1, 1] scale takes two passes -- 64-row chunks write
// per-chunk column partials, then one thread per column (or one block for
// the scalar) sums them in chunk order.
// Not yet done: 16-byte vector loads, and writing the bf16 compute copy of
// y in the same pass.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                    // columns per thread per row
constexpr int kCols = kThreads * kVec;     // columns per elementwise block
constexpr int kRowChunk = 64;              // rows per column-partial block
constexpr int kSumThreads = 1024;          // the scalar's final block

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kRuleKernel = 0;
constexpr int kRuleSte = 1;
// scale shapes (the wrapper decides): [R, C], [R, 1], [1, C], [1, 1]
constexpr int kFull = 0;
constexpr int kRow = 1;
constexpr int kCol = 2;
constexpr int kScalar = 3;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// clip with NaN passing through, as torch.clamp does
__device__ __forceinline__ float clip(float r, float qmax) {
  return r < -qmax ? -qmax : (r > qmax ? qmax : r);
}

__device__ __forceinline__ float fq(float x, float s, float qmax) {
  return __fmul_rn(clip(rintf(__fdiv_rn(x, s)), qmax), s);
}

// gx and the unreduced gs of one element, in fake_quant_grad_ref's order
template <int RULE>
__device__ __forceinline__ void fq_grad(float g, float x, float s, float qmax,
                                        float* gx, float* gs) {
  const float ratio = __fdiv_rn(x, s);
  const float r = rintf(ratio);
  const float q = clip(r, qmax);
  if (RULE == kRuleKernel) {
    const bool inside = fabsf(ratio) <= qmax;
    *gx = __fmul_rn(g, inside ? 1.0f : 0.0f);
    *gs = __fmul_rn(g, inside ? __fsub_rn(q, ratio) : q);
  } else {
    const float a = fabsf(r);
    const float c = a < qmax ? 1.0f : (a == qmax ? 0.5f : 0.0f);
    *gx = __fdiv_rn(__fmul_rn(__fmul_rn(g, s), c), s);
    *gs = __fmul_rn(g, __fsub_rn(q, __fmul_rn(c, ratio)));
  }
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

template <typename T>
__global__ void fq_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ s, T* __restrict__ y,
                              int C, long long s_rs, long long s_cs,
                              float qmax) {
  const long long r = blockIdx.x;
  const T* xr = x + r * C;
  T* yr = y + r * C;
  const float* sr = s + r * s_rs;
  const int c0 = blockIdx.y * kCols + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = c0 + k * kThreads;
    if (c < C) store(yr + c, fq(load(xr + c), sr[c * s_cs], qmax));
  }
}

// full scale: gx and gs elementwise
template <typename T, int RULE>
__global__ void fq_bwd_full_kernel(const T* __restrict__ g,
                                   const T* __restrict__ x,
                                   const float* __restrict__ s,
                                   T* __restrict__ gx, float* __restrict__ gs,
                                   int C, long long s_rs, long long s_cs,
                                   float qmax) {
  const long long r = blockIdx.x;
  const long long base = r * C;
  const float* sr = s + r * s_rs;
  const int c0 = blockIdx.y * kCols + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int c = c0 + k * kThreads;
    if (c < C) {
      float dx, ds;
      fq_grad<RULE>(load(g + base + c), load(x + base + c), sr[c * s_cs],
                    qmax, &dx, &ds);
      store(gx + base + c, dx);
      gs[base + c] = ds;
    }
  }
}

// [R, 1] scale: one block per row, gs[r] = the row's sum
template <typename T, int RULE>
__global__ void fq_bwd_row_kernel(const T* __restrict__ g,
                                  const T* __restrict__ x,
                                  const float* __restrict__ s,
                                  T* __restrict__ gx, float* __restrict__ gs,
                                  int C, long long s_rs, float qmax) {
  const long long r = blockIdx.x;
  const long long base = r * C;
  const float sv = s[r * s_rs];
  float acc = 0.0f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float dx, ds;
    fq_grad<RULE>(load(g + base + c), load(x + base + c), sv, qmax, &dx, &ds);
    store(gx + base + c, dx);
    acc += ds;
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) gs[r] = acc;
}

// [1, C] and [1, 1] scales, pass 1: block (column tile, 64-row chunk) writes
// partial[chunk, c] = the chunk's column sum
template <typename T, int RULE>
__global__ void fq_bwd_cols_kernel(const T* __restrict__ g,
                                   const T* __restrict__ x,
                                   const float* __restrict__ s,
                                   T* __restrict__ gx,
                                   float* __restrict__ partial, long long R,
                                   int C, long long s_cs, float qmax) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * kRowChunk;
  const long long r1 = r0 + kRowChunk < R ? r0 + kRowChunk : R;
  const float sv = s[c * s_cs];
  float acc = 0.0f;
  for (long long r = r0; r < r1; ++r) {
    float dx, ds;
    fq_grad<RULE>(load(g + r * C + c), load(x + r * C + c), sv, qmax, &dx,
                  &ds);
    store(gx + r * C + c, dx);
    acc += ds;
  }
  partial[static_cast<long long>(blockIdx.y) * C + c] = acc;
}

// [1, C] pass 2: one thread per column sums its partials in chunk order
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ gs, int chunks, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  float acc = 0.0f;
  for (int k = 0; k < chunks; ++k)
    acc += partial[static_cast<long long>(k) * C + c];
  gs[c] = acc;
}

// [1, 1] pass 2: one block sums every partial
__global__ void sum_all_kernel(const float* __restrict__ partial,
                               float* __restrict__ gs, long long n) {
  float acc = 0.0f;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) acc += partial[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) gs[0] = acc;
}

template <typename T, int RULE>
void launch_bwd(const void* g, const void* x, const float* s, void* gx,
                float* gs, float* partial, long long R, int C, long long s_rs,
                long long s_cs, float qmax, int mode, cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  T* gxt = static_cast<T*>(gx);
  if (mode == kFull) {
    const dim3 grid(static_cast<unsigned>(R), (C + kCols - 1) / kCols);
    fq_bwd_full_kernel<T, RULE><<<grid, kThreads, 0, st>>>(
        gt, xt, s, gxt, gs, C, s_rs, s_cs, qmax);
  } else if (mode == kRow) {
    fq_bwd_row_kernel<T, RULE><<<static_cast<unsigned>(R), kThreads, 0, st>>>(
        gt, xt, s, gxt, gs, C, s_rs, qmax);
  } else {
    const int chunks = static_cast<int>((R + kRowChunk - 1) / kRowChunk);
    const dim3 grid((C + kThreads - 1) / kThreads, chunks);
    fq_bwd_cols_kernel<T, RULE><<<grid, kThreads, 0, st>>>(
        gt, xt, s, gxt, partial, R, C, s_cs, qmax);
    if (mode == kCol) {
      sum_chunks_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          partial, gs, chunks, C);
    } else {
      sum_all_kernel<<<1, kSumThreads, 0, st>>>(
          partial, gs, static_cast<long long>(chunks) * C);
    }
  }
}

bool shape_ok(long long R, long long C) {
  return R >= 1 && C >= 1 && R <= 0x7fffffffLL && C <= 0x7fffffffLL &&
         (C + kCols - 1) / kCols <= 65535 &&
         (R + kRowChunk - 1) / kRowChunk <= 65535;
}

}  // namespace

// Each returns a cudaError_t: 0 on a clean launch.  dtype: 0 f32, 1 bf16.
// s_rs / s_cs: the scale's element strides along rows / columns, 0 where
// it broadcasts.

extern "C" int qft_fake_quant_fwd(const void* x, const void* s, void* y,
                                  long long R, long long C, long long s_rs,
                                  long long s_cs, int bits, int dtype,
                                  void* stream) {
  if (!shape_ok(R, C) || bits < 2 || bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  const dim3 grid(static_cast<unsigned>(R),
                  static_cast<unsigned>((C + kCols - 1) / kCols));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const int c = static_cast<int>(C);
  if (dtype == kF32) {
    fq_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), sf, static_cast<float*>(y), c, s_rs,
        s_cs, qmax);
  } else if (dtype == kBF16) {
    fq_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), sf,
        static_cast<__nv_bfloat16*>(y), c, s_rs, s_cs, qmax);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// gs: f32 at the scale's shape; partial: f32 [ceil(R/64), C] scratch for
// modes 2 ([1, C]) and 3 ([1, 1]), unused otherwise.
extern "C" int qft_fake_quant_bwd(const void* g, const void* x, const void* s,
                                  void* gx, void* gs, void* partial,
                                  long long R, long long C, long long s_rs,
                                  long long s_cs, int bits, int dtype,
                                  int rule, int mode, void* stream) {
  if (!shape_ok(R, C) || bits < 2 || bits > 16 || mode < kFull ||
      mode > kScalar || (mode >= kCol && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  float* gsf = static_cast<float*>(gs);
  float* pf = static_cast<float*>(partial);
  const int c = static_cast<int>(C);
  if (dtype == kF32 && rule == kRuleKernel) {
    launch_bwd<float, kRuleKernel>(g, x, sf, gx, gsf, pf, R, c, s_rs, s_cs,
                                   qmax, mode, st);
  } else if (dtype == kF32 && rule == kRuleSte) {
    launch_bwd<float, kRuleSte>(g, x, sf, gx, gsf, pf, R, c, s_rs, s_cs,
                                qmax, mode, st);
  } else if (dtype == kBF16 && rule == kRuleKernel) {
    launch_bwd<__nv_bfloat16, kRuleKernel>(g, x, sf, gx, gsf, pf, R, c, s_rs,
                                           s_cs, qmax, mode, st);
  } else if (dtype == kBF16 && rule == kRuleSte) {
    launch_bwd<__nv_bfloat16, kRuleSte>(g, x, sf, gx, gsf, pf, R, c, s_rs,
                                        s_cs, qmax, mode, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
