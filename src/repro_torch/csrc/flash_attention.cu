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
//
// What bounds it on the H100: at the teacher's prefill shape (B 16 x S 512,
// 32/8 heads, hd 128, bf16) the bytes of q, k, v and o take 0.050 ms at
// 3.35 TB/s and the 34.4 GFLOP of causal products 0.035 ms on the bf16
// tensor cores, so bytes.  Only a tensor-core body comes near either: on the
// CUDA cores the same products take 0.51 ms at the f32 rate.
//
// Two bodies, chosen by the wrapper from dtype and shape (no fallback):
//
// fa_wgmma_kernel (qft_flash_attention_wgmma): bf16, hd 64 or 128, every
// base and stride 16-byte aligned (TMA's rule).  A work item is one
// (b * H + h, 128-query tile); the kernel is persistent, one block per SM
// walking the items heaviest causal tile first, so one item's loads overlap
// the last tiles of the one before.  (Blocks of 64 rows were slower at every
// shape measured, B 1 x S 300 included, so the tile is always 128 rows.)
// A producer warpgroup, whose first thread issues every TMA load
// (cp.async.bulk.tensor over the strided 4-D [B, S, H, hd] view, so rows
// past S or Sk arrive as zeros and the batch edge is never crossed): each
// item's bf16 Q tile into one of two buffers, then its K and V tiles of 64
// keys through a ring of kStages stages, each completing on its own
// mbarrier; consumers release a stage (and a Q buffer) on an "empty"
// mbarrier.  The producer gives its registers to the consumers (setmaxnreg
// 40 / 232): with the 168 a 384-thread launch gets, the softmax's
// independent chains did not interleave (PERF.md).  The
// 128-byte swizzle of the loads is the one the wgmma descriptors name.  Two
// consumer warpgroups own 64 query rows each, and tile j's Q K^T is issued
// together with tile j-1's P V, so tile j's softmax runs while that P V is
// on the tensor cores:
//   S = Q K^T: wgmma m64n64k16 from shared memory, f32 accumulators.  bf16
//     x bf16 products are exact in f32, so S matches the FMA body up to the
//     order of the sums; the scale hd^-0.5 multiplies the f32 scores.
//   online softmax on the accumulator fragments: a row lives in the four
//     lanes of a quad, so the row max needs two xor shuffles; only the
//     diagonal tile (causal) and a ragged last tile pay for the mask;
//     masked scores are -1e30 and expf is the accurate one, as in the FMA
//     body; l is the f32 sum of the f32 probabilities.
//   O += P V: wgmma m64n{hd}k16 with A (P, the probabilities rounded to
//     bf16 for the product only) from registers, where the score fragments
//     already lie in A's layout, and V from shared memory as a transposed
//     (MN-major) B.  On the TPU an f32 dot_general at default precision fed
//     the MXU bf16 operands too, so this is what the Pallas kernel computed
//     on its chip.  O is 64 f32 registers a thread at hd 128.
//   epilogue: scale by 1 / max(l, 1e-20) (one IEEE division a row: one a
//     element cost a fifth of the kernel's time), round to bf16, stage the
//     tile in the warpgroup's Q buffer in the same swizzle and write it with
//     TMA stores (faster than the scattered 4-byte stores of the fragment
//     layout).  No atomics: two runs give the same bits.
//
// fa_kernel (qft_flash_attention): f32, other head dims, and the [BH, S, hd]
// signature.  One 256-thread block per (batch * head, 64-query tile); Q, K
// and V staged as f32 in shared memory; each thread scores a 4 x 4 block
// with f32 FMAs and owns 4 rows x hd/16 columns of the f32 accumulator; the
// probabilities stay f32 through P.V.  Row max and sum are reduced across a
// half-warp with xor shuffles; shared rows are padded by one float against
// bank conflicts.  It is bound by its shared-memory reads (PERF.md).
#include <cuda.h>
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

// ---------------------------------------------------------------------------
// The tensor-core body: TMA + mbarrier ring, wgmma products.
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;         // query rows per consumer warpgroup
constexpr int kTcKeys = 64;         // keys per K/V tile
constexpr int kSwzBytes = 128;      // one swizzled row: 64 bf16
// a [rows][64 columns] chunk of a tile: Q has kTcRows rows, K and V kTcKeys
constexpr int kQChunk = kTcRows * kSwzBytes;
constexpr int kKVChunk = kTcKeys * kSwzBytes;
constexpr int kSc = kTcKeys / 2;    // score registers a thread
constexpr int kPk = kTcKeys / 16;   // k16 steps of P V

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts ~2^34 cycles (seconds) traps, so a broken ring fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// One box of the 4-D tensor map (coordinates innermost first: column, head,
// position, batch) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// One box of shared memory out to the 4-D tensor map; rows past the map's
// extent are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

// Commit this thread's bulk stores and wait until they have read shared
// memory (the global writes complete on their own).
__device__ __forceinline__ void bulk_commit_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// A barrier for the 128 threads of one warpgroup (id 1 + wg; 0 is
// __syncthreads').
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle.  K-major
// operands (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart (SBO);
// a k16 step inside the swizzle row advances the start by 32 bytes.
// MN-major operand (V): LBO is the distance between 64-column chunks, SBO
// between 8-key groups; a k16 step advances 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
       | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed groups are pending
// (groups complete in order).
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving register reads or writes of a wgmma
// accumulator across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define QFT_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define QFT_D32 QFT_D8(0), QFT_D8(8), QFT_D8(16), QFT_D8(24)
#define QFT_D64 QFT_D32, QFT_D8(32), QFT_D8(40), QFT_D8(48), QFT_D8(56)
#define QFT_R32                                                             \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31"
#define QFT_R64                                                             \
  QFT_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both K-major in shared memory.
__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" QFT_R32 "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : QFT_D32 : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64] (MN-major in shared).
__device__ __forceinline__ void mma_pv(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" QFT_R32 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : QFT_D32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) B[16 x 128] (MN-major in shared).
__device__ __forceinline__ void mma_pv(float (&d)[64], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" QFT_R64 "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : QFT_D64 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

#undef QFT_D8
#undef QFT_D32
#undef QFT_D64
#undef QFT_R32
#undef QFT_R64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S[64 x kTcKeys] = Q[64 x hd] K^T for one warpgroup: hd / 16 k16 steps,
// each 32 bytes further along the swizzled rows of a 64-column chunk.
template <int kHD>
__device__ __forceinline__ void issue_qk(float (&sc)[kSc], uint32_t q,
                                         uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < kHD / 16; ++kk) {
    const uint32_t in = (kk % 4) * 32;
    mma_qk(sc, sdesc(q + (kk / 4) * kQChunk + in, 16, 1024),
           sdesc(k + (kk / 4) * kKVChunk + in, 16, 1024), kk > 0);
  }
}

// O[64 x hd] += P[64 x kTcKeys] V: k16 steps of 16 keys (2048 bytes).
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&pa)[kPk][4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < kPk; ++kk)
    mma_pv(o, pa[kk], sdesc(v + kk * 16 * kSwzBytes, kKVChunk, 1024));
}

// The f32 probabilities as wgmma's A fragments: k16 step kk holds keys
// 16 kk .. 16 kk + 15, which the score fragments already hold in A's layout.
__device__ __forceinline__ void pack_p(const float (&sc)[kSc],
                                       uint32_t (&pa)[kPk][4]) {
#pragma unroll
  for (int kk = 0; kk < kPk; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

struct TcArgs {
  int B, S, Sk, H, Hkv;
  float scale;
  int causal;
};

// One tile's online softmax on the score fragments, in place: scores are
// scaled, masked (only the causal diagonal tile and a ragged last tile
// test keys), the running row max moves to the new tile (al0, al1 rescale
// what came before) and sc becomes the f32 probabilities.
// sc[4 i + e]: row row0, key k0 + 8 i + 2 (lane % 4) + e;
// sc[4 i + 2 + e]: row row0 + 8, the same key.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kSc], float& m0, float& m1, float& l0, float& l1, float& al0,
    float& al1, int k0, int row0, int q0w, const TcArgs& a, int lane) {
  const bool masked = k0 + kTcKeys > a.Sk ||
                      (a.causal && k0 + kTcKeys - 1 > q0w);
  const int kc = k0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < kTcKeys / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = sc[4 * i + e] * a.scale;
      float x1 = sc[4 * i + 2 + e] * a.scale;
      if (masked) {
        const int key = kc + 8 * i + e;
        if (key >= a.Sk || (a.causal && key > row0)) x0 = kNeg;
        if (key >= a.Sk || (a.causal && key > row0 + 8)) x1 = kNeg;
      }
      sc[4 * i + e] = x0;
      sc[4 * i + 2 + e] = x1;
    }
  }
  // row max and row sum as trees over the thread's 16 keys a row, so the
  // dependent chains are 4 deep, not 16
  float mx[2][8], sm[2][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 4 * (i / 2) + (i % 2);      // sc index of row 0's key
    mx[0][i] = fmaxf(sc[c], sc[c + 4 * (kTcKeys / 16)]);
    mx[1][i] = fmaxf(sc[c + 2], sc[c + 2 + 4 * (kTcKeys / 16)]);
  }
#pragma unroll
  for (int w = 4; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      mx[0][i] = fmaxf(mx[0][i], mx[0][i + w]);
      mx[1][i] = fmaxf(mx[1][i], mx[1][i + w]);
    }
  float mx0 = mx[0][0], mx1 = mx[1][0];
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  al0 = expf(m0 - mn0);
  al1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int i = 0; i < kTcKeys / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * i + e] = expf(sc[4 * i + e] - mn0);
      sc[4 * i + 2 + e] = expf(sc[4 * i + 2 + e] - mn1);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = 4 * (i / 2) + (i % 2);
    sm[0][i] = sc[c] + sc[c + 4 * (kTcKeys / 16)];
    sm[1][i] = sc[c + 2] + sc[c + 2 + 4 * (kTcKeys / 16)];
  }
#pragma unroll
  for (int w = 4; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i) {
      sm[0][i] += sm[0][i + w];
      sm[1][i] += sm[1][i + w];
    }
  l0 = l0 * al0 + sm[0][0];         // this thread's part of the row sums
  l1 = l1 * al1 + sm[1][0];
}

constexpr int kWG = 2;              // consumer warpgroups: 128 query rows
constexpr int kItemRows = kTcRows * kWG;

template <int kHD>
struct TcShape {
  static constexpr int kNC = kHD / 64;              // 64-column chunks
  static constexpr int kStages = 3;                 // K/V ring depth
  static constexpr int kQBytes = kWG * kNC * kQChunk;       // one Q tile
  static constexpr int kKVBytes = kNC * kKVChunk;           // one K or V tile
  static constexpr int kBarOff = 2 * kQBytes + 2 * kStages * kKVBytes;
  // barriers: q_full[2], q_empty[2], k_full[kStages], v_full[kStages],
  // empty[kStages]; 1024 bytes of slack align the base for the swizzle
  static constexpr int kSmem = kBarOff + 8 * (4 + 3 * kStages) + 1024;
  // + a producer warpgroup: one thread issues the copies, and the group
  // gives its registers to the consumers (setmaxnreg)
  static constexpr int kThreads = kWG * 128 + 128;
};

// A work item: one (b * H + h, 128-row query tile), the heaviest causal
// tiles (the last queries) first.
struct Item {
  int b, h, q0, n_tiles;
};

__device__ __forceinline__ Item item_at(int idx, int n_bh, int n_qt,
                                        const TcArgs& a) {
  Item it;
  const int bh = idx % n_bh;
  it.b = bh / a.H;
  it.h = bh % a.H;
  it.q0 = (n_qt - 1 - idx / n_bh) * kItemRows;
  const int k_end = a.causal ? min(a.Sk, it.q0 + kItemRows) : a.Sk;
  it.n_tiles = (k_end + kTcKeys - 1) / kTcKeys;
  return it;
}

// Persistent: one block per SM walks the work items blockIdx.x,
// blockIdx.x + gridDim.x, ...  The producer runs ahead across items (Q is
// double-buffered and the K/V ring never drains), so one item's first
// loads overlap the last tiles and the stores of the one before.
template <int kHD>
__global__ void __launch_bounds__(TcShape<kHD>::kThreads, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, const TcArgs a,
                int n_qt) {
  using Sh = TcShape<kHD>;
  constexpr int kNC = Sh::kNC;
  constexpr int kStages = Sh::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                      // [2 buffers][kWG][kNC]
  const uint32_t k_s = base + 2 * Sh::kQBytes;
  const uint32_t v_s = k_s + kStages * Sh::kKVBytes;
  const uint32_t q_full = base + Sh::kBarOff;
  const uint32_t q_empty = q_full + 16;
  const uint32_t k_full = q_empty + 16;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;
  const int n_bh = a.B * a.H;
  const int n_items = n_bh * n_qt;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, kWG);         // one arrival a warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * kWG) {
    // ---------------- producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * kWG && lane == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&to);
      int t = 0;                                  // K/V tiles issued so far
      for (int idx = blockIdx.x, n = 0; idx < n_items;
           idx += gridDim.x, ++n) {
        const Item it = item_at(idx, n_bh, n_qt, a);
        const int kvh = it.h / (a.H / a.Hkv);
        const int qb = n & 1;
        if (n >= 2) mbar_wait(q_empty + 8 * qb, ((n >> 1) - 1) & 1);
        mbar_expect_tx(q_full + 8 * qb, Sh::kQBytes);
        for (int w = 0; w < kWG; ++w)
          for (int c = 0; c < kNC; ++c)
            tma_load(q_s + qb * Sh::kQBytes + (w * kNC + c) * kQChunk,
                     &tq, 64 * c, it.h, it.q0 + kTcRows * w, it.b,
                     q_full + 8 * qb);
        for (int j = 0; j < it.n_tiles; ++j, ++t) {
          const int s = t % kStages;
          const int round = t / kStages;
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          mbar_expect_tx(k_full + 8 * s, Sh::kKVBytes);
          for (int c = 0; c < kNC; ++c)
            tma_load(k_s + s * Sh::kKVBytes + c * kKVChunk, &tk, 64 * c,
                     kvh, kTcKeys * j, it.b, k_full + 8 * s);
          mbar_expect_tx(v_full + 8 * s, Sh::kKVBytes);
          for (int c = 0; c < kNC; ++c)
            tma_load(v_s + s * Sh::kKVBytes + c * kKVChunk, &tv, 64 * c,
                     kvh, kTcKeys * j, it.b, v_full + 8 * s);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  // ---------------- consumers: warpgroup wg owns an item's query rows
  // q0 + 64 wg .. q0 + 64 wg + 63.  Tile j's Q K^T is issued together with
  // tile j-1's P V, and tile j's softmax runs while that P V is still on
  // the tensor cores.
  const int wg = warp / 4;
  int t = 0;                                      // K/V tiles consumed
  for (int idx = blockIdx.x, n = 0; idx < n_items; idx += gridDim.x, ++n) {
    const Item it = item_at(idx, n_bh, n_qt, a);
    const int qb = n & 1;
    const int q0w = it.q0 + kTcRows * wg;
    const int row0 = q0w + 16 * (warp % 4) + lane / 4;    // and row0 + 8
    const int k_end_w = a.causal ? min(a.Sk, q0w + kTcRows) : a.Sk;
    // the tiles this warpgroup computes; later ones (past its causal
    // diagonal) are only released
    const int n_w = min(it.n_tiles, (k_end_w + kTcKeys - 1) / kTcKeys);
    const uint32_t q_w = q_s + qb * Sh::kQBytes + wg * kNC * kQChunk;

    float o[kHD / 2];
#pragma unroll
    for (int i = 0; i < kHD / 2; ++i) o[i] = 0.f;
    float sc[kSc];
    uint32_t pa[kPk][4];
    float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f, al0, al1;

    mbar_wait(q_full + 8 * qb, (n >> 1) & 1);
    mbar_wait(k_full + 8 * (t % kStages), (t / kStages) & 1);
    __syncwarp();
    fence_regs(sc);
    wg_fence();
    issue_qk<kHD>(sc, q_w, k_s + (t % kStages) * Sh::kKVBytes);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, m0, m1, l0, l1, al0, al1, 0, row0, q0w, a, lane);
    pack_p(sc, pa);                        // o is still zero: no rescale

    for (int j = 1; j < n_w; ++j) {
      const int s = (t + j) % kStages;
      const int sp = (t + j - 1) % kStages;
      mbar_wait(k_full + 8 * s, ((t + j) / kStages) & 1);
      mbar_wait(v_full + 8 * sp, ((t + j - 1) / kStages) & 1);
      __syncwarp();
      fence_regs(sc);
      fence_regs(o);
      wg_fence();
      issue_qk<kHD>(sc, q_w, k_s + s * Sh::kKVBytes);
      wg_commit();
      issue_pv(o, pa, v_s + sp * Sh::kKVBytes);
      wg_commit();
      wg_wait<1>();                        // tile j's scores are in
      fence_regs(sc);
      softmax_tile(sc, m0, m1, l0, l1, al0, al1, kTcKeys * j, row0, q0w, a,
                   lane);
      wg_wait<0>();                        // tile j-1's P V is done
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sp);
      pack_p(sc, pa);
      // a rescale by 1 is exact: skipped when no row of the warp moved
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
        for (int i = 0; i < kHD / 8; ++i) {
          o[4 * i + 0] *= al0;
          o[4 * i + 1] *= al0;
          o[4 * i + 2] *= al1;
          o[4 * i + 3] *= al1;
        }
      }
    }
    {
      const int sl = (t + n_w - 1) % kStages;
      mbar_wait(v_full + 8 * sl, ((t + n_w - 1) / kStages) & 1);
      __syncwarp();
      fence_regs(o);
      wg_fence();
      issue_pv(o, pa, v_s + sl * Sh::kKVBytes);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * sl);
    }
    // a tile is released only after its load completed, so the arrival
    // counts toward that round of the stage
    for (int j = n_w; j < it.n_tiles; ++j) {
      const int s = (t + j) % kStages;
      mbar_wait(k_full + 8 * s, ((t + j) / kStages) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    t += it.n_tiles;

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    // one IEEE division a row: 64 of them a thread cost a fifth of the
    // kernel's time at the teacher's shape
    const float r0 = 1.f / fmaxf(l0, 1e-20f), r1 = 1.f / fmaxf(l1, 1e-20f);
    // O leaves through this warpgroup's Q tile (its last Q K^T is done), in
    // the same 128-byte swizzle, then one TMA store a 64-column chunk; rows
    // past S are not written.  The Q buffer is released once the stores
    // have read it.
    const int r = 16 * (warp % 4) + lane / 4;             // and r + 8
#pragma unroll
    for (int i = 0; i < kHD / 8; ++i) {
      const uint32_t at = q_w + (i / 8) * kQChunk + r * kSwzBytes +
                          (((i % 8) ^ (r % 8)) << 4) + 4 * (lane % 4);
      st_shared(at, pack_bf16(o[4 * i] * r0, o[4 * i + 1] * r0));
      st_shared(at + 8 * kSwzBytes,
                pack_bf16(o[4 * i + 2] * r1, o[4 * i + 3] * r1));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_barrier(wg);
    if (threadIdx.x % 128 == 0) {
      for (int c = 0; c < kNC; ++c)
        tma_store(&to, q_w + c * kQChunk, 64 * c, it.h, q0w, it.b);
      bulk_commit_wait_read();
      mbar_arrive(q_empty + 8 * qb);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver library.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map over a [B, seq, heads, hd] view (element strides), boxes
// of `rows` rows x 64 columns with the 128-byte swizzle; reads past seq are
// zeros.  The stride of a dimension of size 1 is never used and is set to
// one row's bytes, which TMA accepts.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int seq,
                int heads, int hd, Strides st, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const long long row = 2LL * hd;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {
      static_cast<cuuint64_t>(heads > 1 ? 2 * st.h : row),
      static_cast<cuuint64_t>(seq > 1 ? 2 * st.s : row),
      static_cast<cuuint64_t>(B > 1 ? 2 * st.b : row)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int kHD>
cudaError_t launch_tc(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const CUtensorMap& to,
                      const TcArgs& a, cudaStream_t st) {
  using Sh = TcShape<kHD>;
  static cudaError_t attr = cudaFuncSetAttribute(
      fa_wgmma_kernel<kHD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sh::kSmem);
  if (attr != cudaSuccess) return attr;
  const int n_qt = (a.S + kItemRows - 1) / kItemRows;
  const long long n_items = static_cast<long long>(a.B) * a.H * n_qt;
  const int sms = sm_count();
  if (sms < 1 || n_items > 0x7fffffff) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  fa_wgmma_kernel<kHD><<<grid, Sh::kThreads, Sh::kSmem, st>>>(tq, tk, tv, to,
                                                             a, n_qt);
  return cudaGetLastError();
}

bool aligned16(const void* p, Strides st, int B, int seq, int heads) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (B == 1 || (2 * st.b) % 16 == 0) &&
         (seq == 1 || (2 * st.s) % 16 == 0) &&
         (heads == 1 || (2 * st.h) % 16 == 0);
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

// The tensor-core body: bf16 q, k, v and o, hd 64 or 128, every base and
// every stride of a dimension longer than 1 a multiple of 16 bytes.
// Arguments as for qft_flash_attention.  Returns a cudaError_t: 0 on a clean
// launch, cudaErrorInvalidValue for what it does not take,
// cudaErrorNotSupported when a tensor map cannot be encoded.
extern "C" int qft_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, int B, int S,
    int Sk, int H, int Hkv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, void* stream) {
  if (B < 1 || S < 1 || Sk < 1 || H < 1 || Hkv < 1 || H % Hkv ||
      (hd != 64 && hd != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh};
  const Strides sv{v_sb, v_ss, v_sh}, so{o_sb, o_ss, o_sh};
  if (!aligned16(q, sq, B, S, H) || !aligned16(k, sk, B, Sk, Hkv) ||
      !aligned16(v, sv, B, Sk, Hkv) || !aligned16(o, so, B, S, H))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  if (!encode_map(&tq, q, B, S, H, hd, sq, kTcRows) ||
      !encode_map(&tk, k, B, Sk, Hkv, hd, sk, kTcKeys) ||
      !encode_map(&tv, v, B, Sk, Hkv, hd, sv, kTcKeys) ||
      !encode_map(&to, o, B, S, H, hd, so, kTcRows))
    return static_cast<int>(cudaErrorNotSupported);
  const TcArgs a{B, S, Sk, H, Hkv, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(hd == 64 ? launch_tc<64>(tq, tk, tv, to, a, st)
                                   : launch_tc<128>(tq, tk, tv, to, a, st));
}
