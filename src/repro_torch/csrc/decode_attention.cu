// Slot-masked split-KV flash-decode over the serving KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_fd_kernel` of
// src/repro/kernels/decode_attention.py (wrapper `decode_attention`): one query
// token per slot, softmax over the slot's valid KV prefix, per-slot masking
// `row < length[s]`, dead rows never read.  The int8 path folds `k_scale *
// hd^-0.5` into q before QK^T and multiplies `v_scale` into the output once, so
// no dequantized cache copy exists.  Two entry points share one body:
// `qft_decode_attention` reads the slot-indexed view k/v [S, T, Hkv, hd];
// `qft_decode_attention_paged` reads the int8 page pools [n_pages + 1, P, Hkv,
// hd] through the page table pt [S, max_pages] itself, so the [S, T, Hkv, hd]
// gather `pool[pt]` is never built.
//
// What bounds it on the H100: memory.  A decode step reads every live K and V
// row once (1 byte an element for the int8 cache) against 2 FLOPs per element
// and query head, so the least time is the live KV bytes over 3.35 TB/s.  The
// TPU kernel walks a slot's KV blocks in order on one core; here that walk
// would leave most SMs idle (S x Hkv blocks, one of them walking a 2,048-row
// slot alone), and each step of it waits on its loads, so the rows are split
// across blocks and each block reads its rows in one round of loads.
//
// Design.  Split pass: grid (split, kv head, slot).  A split (`chunk` rows) is
// at most one tile, the rows a block reads at once (Tile::ROWS: 128 for the
// int8 cache at hd 128 and G <= 4, 64 for bf16); the wrapper halves it, down to
// a quarter, where the grid would not fill two waves of 132 SMs. A block whose
// split starts at or past min(length, T) exits before it reads anything.  A
// live block's lanes each load one 16-byte vector of a row (a row spread over
// hd x sizeof(elt) / 16 lanes) for all of the split's K and V rows at once,
// into registers: no f32 tile in shared memory, no loop waiting on its loads.
// The G pre-scaled query rows stay in registers (each lane holds the head-dim
// slice it reads).  Scores: FMAs on the lane's slice, an xor-shuffle sum across
// the row's lanes, into a [G, rows] f32 buffer in shared memory; the split's
// max and sum(exp) per query (one warp a query, warp shuffles); P.V from the V
// registers into f32 registers, summed across the warp's rows by shuffles and
// across the four warps in shared memory, in a fixed order.  The block writes
// its f32 partial (m, l, acc[G, hd]) to scratch the wrapper allocates.  Combine
// pass: one block per (query, kv head, slot) merges the slot's live splits with
// the usual rescale exp(m_c - M), applies 1/L and the V scale, and rounds once
// to q's type; its eight warps take every eighth split and add their sums in
// warp order.  No atomics anywhere: two launches are bit-identical.  m, l and
// acc stay f32; masked rows never enter a sum (the reference gives them -1e30,
// whose exp is 0).  The paged body reads row j of slot s at pool[pt[s, j / P],
// j % P, h]: each block loads its own page-table entries, once for K and V, and
// pages at or past ceil(length / P) (the trash-page padding) are never read.
// Any page size >= 1 is taken.  GQA groups up to 16: a block holds at most 8
// query heads in registers, so a group above 8 is split into query chunks of
// 8 (G 12: 8 + 4), each its own block on the grid's y axis (kv head x query
// chunk) that reads the split's K/V rows again; the partials of all chunks
// land in the one [.., G, ..] scratch, and the combine pass merges any G.
// Head dims 16, 32, 64, 112 and 128: at 112 a
// row is 14 16-byte vectors (bf16) or 7 (int8), so its lanes are padded to the
// next power of two (16 or 8) and the padding lanes read nothing; a warp still
// holds 2 (bf16) or 4 (int8) rows, and 4 of its 32 lanes sit idle.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTile = 128;     // rows of one tile, at most
constexpr int kMaxGroup = 16;     // query heads per kv-head
constexpr int kBlockGroup = 8;    // query heads of one block
constexpr int kMaxHeadDim = 128;

constexpr int pow2_ceil(int x) {
  return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2);
}
constexpr int kCombineWarps = 8;  // split subsets of a combine block
constexpr int kCombineThreads = 32 * kCombineWarps;
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

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The slot-indexed view: k, v [S, T, Hkv, hd].
template <typename KT> struct SlotView {
  const KT* k;
  const KT* v;
  int T, Hkv;
  __device__ size_t row(int s, int h, int j, int hd) const {
    return ((static_cast<size_t>(s) * T + j) * Hkv + h) * hd;
  }
};

// The page pools: k, v [n_pages + 1, P, Hkv, hd]; pt [S, max_pages].
template <typename KT> struct PagedView {
  const KT* k;
  const KT* v;
  const int* pt;
  int P, max_pages, Hkv;
  __device__ size_t row(int s, int h, int j, int hd) const {
    const int page = __ldg(pt + static_cast<size_t>(s) * max_pages + j / P);
    return ((static_cast<size_t>(page) * P + j % P) * Hkv + h) * hd;
  }
};

// One tile: the rows a block reads in a single round of loads.  A lane
// reads one 16-byte vector of a row (LPR lanes a row, padded to LPRP, a power
// of two, so that xor-shuffles stay within a row; RPW rows a warp, RSTEP rows
// the block) and U rows of K and of V; U is 8, or 4 where the lane's query
// slice already takes 128 registers (int8 at G > 4), and a tile holds at most
// kMaxTile rows.  A lane whose slot in its row is LPR or past has no vector:
// it loads nothing and adds zeros.
template <typename KT, int HD, int GM> struct Tile {
  static constexpr int VN = Vec16<KT>::N;
  static constexpr int LPR = HD / VN;
  static constexpr int LPRP = pow2_ceil(LPR);
  static constexpr int RPW = 32 / LPRP;
  static constexpr int RSTEP = kWarps * RPW;
  static constexpr int U0 = GM * VN >= 128 ? 4 : 8;
  static constexpr int U = U0 * RSTEP <= kMaxTile ? U0 : kMaxTile / RSTEP;
  static constexpr int ROWS = U * RSTEP;
  static_assert(HD % VN == 0 && LPR >= 1 && LPRP <= 32 && U >= 1, "tile");
};

// One (chunk, kv head x query chunk, slot), chunk <= Tile::ROWS rows: the
// chunk's partial (m, l, acc) for the block's queries g0 .. g0 + GM - 1 (at
// most; GM per query chunk, gridDim.y = Hkv x ceil(G / GM)).
// q: [S, Hkv, G, HD]; lengths: [S];
// k_scale: [S, Hkv] (QUANT only); part_acc: [S, Hkv, n_chunks, G, HD];
// part_ml: [S, Hkv, n_chunks, G, 2].
template <typename QT, typename KT, int HD, int GM, bool QUANT, class View>
__global__ void __launch_bounds__(kThreads) fd_split_kernel(
    const QT* __restrict__ q, const View view,
    const int* __restrict__ lengths, const float* __restrict__ k_scale,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int T,
    int G, int chunk, float scale) {
  using TL = Tile<KT, HD, GM>;
  constexpr int VN = TL::VN;
  constexpr int LPRP = TL::LPRP;
  constexpr int U = TL::U;
  __shared__ float p_s[GM][TL::ROWS];
  __shared__ float red_s[kWarps][GM][HD];

  const int c = blockIdx.x;
  const int n_qc = (G + GM - 1) / GM;   // query chunks of a kv head
  const int h = blockIdx.y / n_qc;
  const int g0 = (blockIdx.y % n_qc) * GM;
  const int Gb = min(GM, G - g0);       // this block's queries
  const int s = blockIdx.z;
  const int Hkv = gridDim.y / n_qc;
  const int len = min(lengths[s], T);
  const int j0 = c * chunk;
  if (j0 >= len) return;                // a dead chunk: nothing is read
  const int rows = min(chunk, len - j0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % LPRP;          // this lane's vector of a row
  const bool has = sub < TL::LPR;       // false on a padding lane
  const int rl = warp * TL::RPW + lane / LPRP;  // its first row
  const int d0 = has ? sub * VN : 0;
  const size_t sh = static_cast<size_t>(s) * Hkv + h;
  const size_t part = sh * gridDim.x + c;

  // the lane's K and V vectors of every live row, all in flight at once
  uint4 kv[U], vv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = u * TL::RSTEP + rl;
    kv[u] = vv[u] = make_uint4(0u, 0u, 0u, 0u);
    if (has && r < rows) {
      const size_t off = view.row(s, h, j0 + r, HD) + d0;
      kv[u] = load16(view.k + off);
      vv[u] = load16(view.v + off);
    }
  }
  const float qscale = QUANT ? scale * k_scale[sh] : scale;
  float qr[GM][VN];
  const QT* qp = q + (sh * G + g0) * HD;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VN; ++e)
      qr[g][e] = has && g < Gb ? to_float(qp[g * HD + d0 + e]) * qscale
                               : 0.f;

  // scores of the live rows -> p_s
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = u * TL::RSTEP + rl;
    float kf[VN];
    Vec16<KT>::unpack(kv[u], kf);
    float sc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < VN; ++e) a = fmaf(qr[g][e], kf[e], a);
      sc[g] = a;
    }
#pragma unroll
    for (int off = LPRP / 2; off > 0; off >>= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
    if (sub == 0 && r < rows)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < Gb) p_s[g][r] = sc[g];
  }
  __syncthreads();

  // the chunk's max and sum(exp) per query; p_s becomes exp(s - m)
  for (int g = warp; g < Gb; g += kWarps) {
    float m = kNeg;
    for (int r = lane; r < rows; r += 32) m = fmaxf(m, p_s[g][r]);
    m = warp_max(m);
    float l = 0.f;
    for (int r = lane; r < rows; r += 32) {
      const float p = expf(p_s[g][r] - m);
      p_s[g][r] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      part_ml[(part * G + g0 + g) * 2] = m;
      part_ml[(part * G + g0 + g) * 2 + 1] = l;
    }
  }
  __syncthreads();

  // P.V over the lane's head-dim slice
  float acc[GM][VN];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = u * TL::RSTEP + rl;
    if (r < rows) {
      float vf[VN];
      Vec16<KT>::unpack(vv[u], vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < Gb) {
          const float p = p_s[g][r];
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
  }
  // across the warp's rows (lanes with the same slice), then across warps
#pragma unroll
  for (int off = LPRP; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < VN; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (lane < TL::LPR)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < VN; ++e) red_s[warp][g][d0 + e] = acc[g][e];
  __syncthreads();
  float* pa = part_acc + (part * G + g0) * HD;
  for (int i = threadIdx.x; i < Gb * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    float a = red_s[0][g][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += red_s[w][g][d];
    pa[i] = a;
  }
}

// A block-wide max (MAX) or sum of one value a thread, in a fixed order.
template <bool MAX>
__device__ __forceinline__ float block_all(float x, float* warp_s) {
  x = MAX ? warp_max(x) : warp_sum(x);
  if ((threadIdx.x & 31) == 0) warp_s[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = warp_s[0];
  for (int w = 1; w < kCombineWarps; ++w)
    r = MAX ? fmaxf(r, warp_s[w]) : r + warp_s[w];
  __syncthreads();                      // warp_s is reused
  return r;
}

// One (query, kv head, slot): merge the live chunks' partials.  The global
// max M and sum L = sum_c l_c exp(m_c - M) over all threads first, then
// warp w sums acc_c exp(m_c - M) over chunks w, w + 8, ... (four float4
// loads in flight a lane), the eight warp sums added in warp order.
template <typename QT, bool QUANT>
__global__ void __launch_bounds__(kCombineThreads) fd_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, const float* __restrict__ v_scale,
    QT* __restrict__ out, int T, int hd, int chunk, int n_chunks) {
  __shared__ float warp_s[kCombineWarps];
  __shared__ float4 red_s[kCombineWarps][kMaxHeadDim / 4];
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const size_t sh = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int len = max(min(lengths[blockIdx.z], T), 0);
  const int n_live = (len + chunk - 1) / chunk;
  const size_t first = sh * n_chunks * G + g;   // partial (chunk 0, query g)
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + first;
  float m = kNeg;
  for (int c = threadIdx.x; c < n_live; c += kCombineThreads)
    m = fmaxf(m, ml[static_cast<size_t>(c) * G].x);
  m = block_all<true>(m, warp_s);
  float l = 0.f;
  for (int c = threadIdx.x; c < n_live; c += kCombineThreads) {
    const float2 p = ml[static_cast<size_t>(c) * G];
    l = fmaf(p.y, expf(p.x - m), l);
  }
  l = block_all<false>(l, warp_s);
  const int d = lane * 4;
  if (d < hd) {
    const float* acc = part_acc + first * hd + d;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = warp; c < n_live; c += kCombineWarps) {
      const float w = expf(ml[static_cast<size_t>(c) * G].x - m);
      const float4 x = __ldg(reinterpret_cast<const float4*>(
          acc + static_cast<size_t>(c) * G * hd));
      a.x = fmaf(x.x, w, a.x);
      a.y = fmaf(x.y, w, a.y);
      a.z = fmaf(x.z, w, a.z);
      a.w = fmaf(x.w, w, a.w);
    }
    red_s[warp][lane] = a;
  }
  __syncthreads();
  if (warp == 0 && d < hd) {
    float4 a = red_s[0][lane];
    for (int w = 1; w < kCombineWarps; ++w) {
      const float4 x = red_s[w][lane];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float inv = (QUANT ? v_scale[sh] : 1.f) / fmaxf(l, 1e-20f);
    QT* o = out + (sh * G + g) * hd + d;
    store(o, a.x * inv);
    store(o + 1, a.y * inv);
    store(o + 2, a.z * inv);
    store(o + 3, a.w * inv);
  }
}

template <typename QT, typename KT, int HD, bool QUANT, class View>
cudaError_t launch_split(const dim3& grid, const QT* q, const View& view,
                         const int* lengths, const float* ks,
                         float* part_acc, float* part_ml, int T, int G,
                         int chunk, float scale, cudaStream_t st) {
  // grid.y: Hkv x query chunks of GM (one chunk unless G > kBlockGroup)
  if (G <= 4) {
    if (chunk > Tile<KT, HD, 4>::ROWS) return cudaErrorInvalidValue;
    fd_split_kernel<QT, KT, HD, 4, QUANT, View><<<grid, kThreads, 0, st>>>(
        q, view, lengths, ks, part_acc, part_ml, T, G, chunk, scale);
  } else {
    if (chunk > Tile<KT, HD, kBlockGroup>::ROWS) return cudaErrorInvalidValue;
    const dim3 g(grid.x, grid.y * ((G + kBlockGroup - 1) / kBlockGroup),
                 grid.z);
    fd_split_kernel<QT, KT, HD, kBlockGroup, QUANT, View>
        <<<g, kThreads, 0, st>>>(q, view, lengths, ks, part_acc, part_ml, T,
                                 G, chunk, scale);
  }
  return cudaGetLastError();
}

// Both passes on `st`.  scratch: S * Hkv * n_chunks * G * (hd + 2) floats.
template <typename QT, typename KT, bool QUANT, class View>
cudaError_t launch(const void* q_, const View& view, const int* lengths,
                   const float* ks, const float* vs, void* out_,
                   float* scratch, int S, int T, int Hkv, int G, int hd,
                   int chunk, float scale, cudaStream_t st) {
  const QT* q = static_cast<const QT*>(q_);
  QT* out = static_cast<QT*>(out_);
  const int n_chunks = (T + chunk - 1) / chunk;
  float* part_acc = scratch;
  float* part_ml = scratch + static_cast<size_t>(S) * Hkv * n_chunks * G * hd;
  const dim3 grid(n_chunks, Hkv, S);
  cudaError_t rc = cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      rc = launch_split<QT, KT, 16, QUANT>(grid, q, view, lengths, ks,
                                           part_acc, part_ml, T, G, chunk,
                                           scale, st);
      break;
    case 32:
      rc = launch_split<QT, KT, 32, QUANT>(grid, q, view, lengths, ks,
                                           part_acc, part_ml, T, G, chunk,
                                           scale, st);
      break;
    case 64:
      rc = launch_split<QT, KT, 64, QUANT>(grid, q, view, lengths, ks,
                                           part_acc, part_ml, T, G, chunk,
                                           scale, st);
      break;
    case 112:
      rc = launch_split<QT, KT, 112, QUANT>(grid, q, view, lengths, ks,
                                            part_acc, part_ml, T, G, chunk,
                                            scale, st);
      break;
    case 128:
      rc = launch_split<QT, KT, 128, QUANT>(grid, q, view, lengths, ks,
                                            part_acc, part_ml, T, G, chunk,
                                            scale, st);
      break;
  }
  if (rc != cudaSuccess) return rc;
  fd_combine_kernel<QT, QUANT><<<dim3(G, Hkv, S), kCombineThreads, 0, st>>>(
      part_acc, part_ml, lengths, vs, out, T, hd, chunk, n_chunks);
  return cudaGetLastError();
}

bool shape_ok(int S, int T, int Hkv, int G, int chunk) {
  return S >= 1 && S <= 65535 && T >= 1 && Hkv >= 1 &&
         Hkv * ((G + kBlockGroup - 1) / kBlockGroup) <= 65535 && G >= 1 &&
         G <= kMaxGroup && chunk >= 1 && chunk <= kMaxTile;
}

}  // namespace

// Returns a cudaError_t: 0 on a clean launch of both passes.  q_dtype:
// 0 f32, 1 bf16; kv_dtype: q_dtype, or 2 for int8 with k_scale/v_scale.
extern "C" int qft_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    const void* k_scale, const void* v_scale, void* out, void* scratch,
    int S, int T, int Hkv, int G, int hd, int q_dtype, int kv_dtype,
    int chunk, float scale, void* stream) {
  if (!shape_ok(S, T, Hkv, G, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* sc = static_cast<float*>(scratch);
  cudaError_t rc = cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32) {
    const SlotView<float> view{static_cast<const float*>(k),
                               static_cast<const float*>(v), T, Hkv};
    rc = launch<float, float, false>(q, view, len, ks, vs, out, sc, S, T,
                                     Hkv, G, hd, chunk, scale, st);
  } else if (q_dtype == kBF16 && kv_dtype == kBF16) {
    const SlotView<__nv_bfloat16> view{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), T, Hkv};
    rc = launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, view, len, ks, vs, out, sc, S, T, Hkv, G, hd, chunk, scale, st);
  } else if (kv_dtype == kI8) {
    const SlotView<int8_t> view{static_cast<const int8_t*>(k),
                                static_cast<const int8_t*>(v), T, Hkv};
    if (q_dtype == kF32)
      rc = launch<float, int8_t, true>(q, view, len, ks, vs, out, sc, S, T,
                                       Hkv, G, hd, chunk, scale, st);
    else if (q_dtype == kBF16)
      rc = launch<__nv_bfloat16, int8_t, true>(
          q, view, len, ks, vs, out, sc, S, T, Hkv, G, hd, chunk, scale, st);
  }
  return static_cast<int>(rc);
}

// The paged entry: int8 pools [n_pages + 1, P, Hkv, hd], pt [S, max_pages]
// int32 (valid page ids), the view length T = max_pages * P.  Same return.
extern "C" int qft_decode_attention_paged(
    const void* q, const void* pool_k, const void* pool_v, const void* pt,
    const void* lengths, const void* k_scale, const void* v_scale, void* out,
    void* scratch, int S, int P, int max_pages, int Hkv, int G, int hd,
    int q_dtype, int chunk, float scale, void* stream) {
  if (P < 1 || max_pages < 1 ||
      static_cast<long long>(P) * max_pages > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int T = P * max_pages;
  if (!shape_ok(S, T, Hkv, G, chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedView<int8_t> view{static_cast<const int8_t*>(pool_k),
                               static_cast<const int8_t*>(pool_v),
                               static_cast<const int*>(pt), P, max_pages,
                               Hkv};
  const int* len = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* sc = static_cast<float*>(scratch);
  cudaError_t rc = cudaErrorInvalidValue;
  if (q_dtype == kF32)
    rc = launch<float, int8_t, true>(q, view, len, ks, vs, out, sc, S, T,
                                     Hkv, G, hd, chunk, scale, st);
  else if (q_dtype == kBF16)
    rc = launch<__nv_bfloat16, int8_t, true>(q, view, len, ks, vs, out, sc,
                                             S, T, Hkv, G, hd, chunk, scale,
                                             st);
  return static_cast<int>(rc);
}
