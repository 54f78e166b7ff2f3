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
//
// Two entries.
//
// The factored entry (qft_fake_quant_factored_*) is the reference's offline
// subgraph, src/repro/core/dof.py `effective_weight`, on that math: the
// f32 master w [R, C] (a stacked [E, K, N] weight as its [E*K, N] view),
// the scale S_w = S_wL (x) S_wR formed in a register,
//     s[r, c] = s_wl[r mod P] * s_wr[r / g, c * cs]
// (s_wl absent: S_wL = 1; g = K for the channel and layerwise layouts, the
// group size for a group one; cs = 0 for a layerwise s_wr), y written in the
// compute type (bf16 or f32).  The backward reads the gradient in that type,
// w and the two factors, and writes gx (f32, the "ste" rule) and both
// factors' gradients, gs_wl[P] = sum over its rows and columns of gs * s_wr
// and gs_wr[R/g, C|1] = sum over its rows (and columns) of gs * s_wl.
//
// The broadcast entry (qft_fake_quant_fwd/_bwd) takes x [R, C] f32 or bf16
// and a materialised f32 scale read at its own shape through two element
// strides (0 on a broadcast axis): [R, C], [R, 1], [1, C] or [1, 1].  It
// serves the embedding's per-row scale, ops.fake_quant, the CNN's views and
// any weight whose scale the factored entry's index form does not cover.
//
// What bounds it on the H100: bytes, at a few flops an element, far below
// the ~20 flop/byte ridge of the f32 CUDA cores.  The factored entry moves
// 16 B an element with a bf16 output: w read (4) and y written (2) forward;
// the gradient (2) and w (4) read and gx written (4) backward.  The factor
// vectors are negligible, and so are its partial sums (8 B per element over
// the 64 rows of a tile, 1/8 B an element).  The chain it replaces built S_w
// as a full f32 [K, N] tensor, wrote a full gs and reduced it onto the two
// factors in further passes, and cast y to bf16 in a pass of its own: about
// 72 B an element.
//
// Design.  The division is IEEE (__fdiv_rn) and the rounding rint (half to
// even), with no fast-math, so y and gx equal the PyTorch composition bit
// for bit; every product is an explicit __fmul_rn so the compiler cannot
// contract it into an FMA, and s = __fmul_rn(s_wl, s_wr) is the bits of
// torch's outer product.  Loads and stores are 16 bytes a thread where the
// row length is a multiple of 4 and the pointers are aligned (float4 for
// f32, 8 bytes for four bf16 values); otherwise a scalar body with the same
// arithmetic runs (chosen by the host before the launch), neighbouring
// threads on neighbouring addresses either way.
// - Factored entry: a block of 256 threads takes a tile of 64 rows x 256
//   columns, one warp a row at a time (rows w, w + 8, ...), a lane 8
//   columns (two float4s 128 columns apart).  A tile's rows lie in one
//   group of g rows, so one s_wr row serves it; its 8 s_wr values a lane
//   are read once a tile.  A grid of as many blocks as are resident at once
//   (a few an SM) strides over the tiles, column tiles fastest, so a small
//   view is not a swarm of tiny blocks.  The scale gradients are reduced
//   without atomics, in a fixed order, so two runs give the same bits: a
//   row's partial over the tile's columns is summed with warp shuffles and
//   written to row_part[column tile, row]; a lane's column partials over
//   its warp's rows are summed over the 8 warps in warp order in shared
//   memory and written once for each 64-row chunk, col_part[chunk, column]
//   (a layerwise s_wr: the block's sum, col_part[chunk, column tile]).  A
//   second launch sums them in order: gs_wl[p] over the rows r = p (mod P)
//   ascending and the column tiles ascending; gs_wr over a group's chunks.
// - Broadcast entry: elementwise passes put one row on blockIdx.x and 1024
//   columns on blockIdx.y (256 threads, 4 adjacent columns each in the
//   vector body).  A [R, 1] scale's gradient takes one block per row and a
//   fixed-order block sum; a [1, C] or [1, 1] scale's takes two passes --
//   64-row chunks write per-chunk column partials, then one thread per
//   column (or one block for the scalar) sums them in chunk order.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                    // columns per thread per row
constexpr int kCols = kThreads * kVec;     // columns per elementwise block
constexpr int kRowChunk = 64;              // rows per column-partial block
constexpr int kSumThreads = 1024;          // the scalar's final block
// the factored entry's tile: kTileRows x kTileCols, a lane kSlots columns
constexpr int kTileRows = 64;
constexpr int kTileCols = 256;
constexpr int kSlots = kTileCols / 32;
static_assert(kTileCols == kThreads, "one column of a tile per thread");
static_assert(kSlots % kVec == 0, "a lane's columns are whole vectors");

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

// four adjacent elements in one access: 16 bytes of f32, 8 of bf16
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&a);
  t.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

template <typename T>
bool aligned4(const void* p) {   // four elements of T at p in one access
  return reinterpret_cast<uintptr_t>(p) % (kVec * sizeof(T)) == 0;
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// ---------------------------------------------------------------------------
// the broadcast entry
// ---------------------------------------------------------------------------

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
fq_fwd_kernel(const T* __restrict__ x, const float* __restrict__ s,
              T* __restrict__ y, int C, long long s_rs, long long s_cs,
              float qmax) {
  const long long r = blockIdx.x;
  const T* xr = x + r * C;
  T* yr = y + r * C;
  const float* sr = s + r * s_rs;
  if (VEC) {
    const int c = (blockIdx.y * kThreads + threadIdx.x) * kVec;
    if (c < C) {
      float v[kVec];
      load4(xr + c, v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) v[k] = fq(v[k], sr[(c + k) * s_cs], qmax);
      store4(yr + c, v);
    }
  } else {
    const int c0 = blockIdx.y * kCols + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int c = c0 + k * kThreads;
      if (c < C) store(yr + c, fq(load(xr + c), sr[c * s_cs], qmax));
    }
  }
}

// full scale: gx and gs elementwise
template <typename T, int RULE, bool VEC>
__global__ void __launch_bounds__(kThreads)
fq_bwd_full_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const float* __restrict__ s, T* __restrict__ gx,
                   float* __restrict__ gs, int C, long long s_rs,
                   long long s_cs, float qmax) {
  const long long r = blockIdx.x;
  const long long base = r * C;
  const float* sr = s + r * s_rs;
  if (VEC) {
    const int c = (blockIdx.y * kThreads + threadIdx.x) * kVec;
    if (c < C) {
      float gv[kVec], xv[kVec], dx[kVec], ds[kVec];
      load4(g + base + c, gv);
      load4(x + base + c, xv);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        fq_grad<RULE>(gv[k], xv[k], sr[(c + k) * s_cs], qmax, &dx[k], &ds[k]);
      store4(gx + base + c, dx);
      store4(gs + base + c, ds);
    }
  } else {
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
}

// [R, 1] scale: one block per row, gs[r] = the row's sum
template <typename T, int RULE, bool VEC>
__global__ void __launch_bounds__(kThreads)
fq_bwd_row_kernel(const T* __restrict__ g, const T* __restrict__ x,
                  const float* __restrict__ s, T* __restrict__ gx,
                  float* __restrict__ gs, int C, long long s_rs, float qmax) {
  const long long r = blockIdx.x;
  const long long base = r * C;
  const float sv = s[r * s_rs];
  float acc = 0.0f;
  if (VEC) {
    for (int c = threadIdx.x * kVec; c < C; c += kThreads * kVec) {
      float gv[kVec], xv[kVec], dx[kVec];
      load4(g + base + c, gv);
      load4(x + base + c, xv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        float ds;
        fq_grad<RULE>(gv[k], xv[k], sv, qmax, &dx[k], &ds);
        acc += ds;
      }
      store4(gx + base + c, dx);
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float dx, ds;
      fq_grad<RULE>(load(g + base + c), load(x + base + c), sv, qmax, &dx,
                    &ds);
      store(gx + base + c, dx);
      acc += ds;
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) gs[r] = acc;
}

// [1, C] and [1, 1] scales, pass 1: block (column tile, 64-row chunk) writes
// partial[chunk, c] = the chunk's column sum
template <typename T, int RULE, bool VEC>
__global__ void __launch_bounds__(kThreads)
fq_bwd_cols_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const float* __restrict__ s, T* __restrict__ gx,
                   float* __restrict__ partial, long long R, int C,
                   long long s_cs, float qmax) {
  constexpr int kW = VEC ? kVec : 1;       // adjacent columns a thread
  const int c = (blockIdx.x * kThreads + threadIdx.x) * kW;
  if (c >= C) return;
  const long long r0 = static_cast<long long>(blockIdx.y) * kRowChunk;
  const long long r1 = r0 + kRowChunk < R ? r0 + kRowChunk : R;
  float sv[kW], acc[kW];
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    sv[k] = s[(c + k) * s_cs];
    acc[k] = 0.0f;
  }
  for (long long r = r0; r < r1; ++r) {
    const long long at = r * C + c;
    float gv[kW], xv[kW], dx[kW];
    if (VEC) {
      load4(g + at, gv);
      load4(x + at, xv);
    } else {
      gv[0] = load(g + at);
      xv[0] = load(x + at);
    }
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      float ds;
      fq_grad<RULE>(gv[k], xv[k], sv[k], qmax, &dx[k], &ds);
      acc[k] += ds;
    }
    if (VEC) {
      store4(gx + at, dx);
    } else {
      store(gx + at, dx[0]);
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.y) * C + c;
  if (VEC) {
    store4(out, acc);
  } else {
    out[0] = acc[0];
  }
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

template <typename T, int RULE, bool VEC>
void launch_bwd_as(const T* g, const T* x, const float* s, T* gx, float* gs,
                   float* partial, long long R, int C, long long s_rs,
                   long long s_cs, float qmax, int mode, cudaStream_t st) {
  if (mode == kFull) {
    const dim3 grid(static_cast<unsigned>(R), (C + kCols - 1) / kCols);
    fq_bwd_full_kernel<T, RULE, VEC><<<grid, kThreads, 0, st>>>(
        g, x, s, gx, gs, C, s_rs, s_cs, qmax);
  } else if (mode == kRow) {
    fq_bwd_row_kernel<T, RULE, VEC>
        <<<static_cast<unsigned>(R), kThreads, 0, st>>>(g, x, s, gx, gs, C,
                                                        s_rs, qmax);
  } else {
    const int chunks = static_cast<int>((R + kRowChunk - 1) / kRowChunk);
    const int per_block = kThreads * (VEC ? kVec : 1);
    const dim3 grid((C + per_block - 1) / per_block, chunks);
    fq_bwd_cols_kernel<T, RULE, VEC><<<grid, kThreads, 0, st>>>(
        g, x, s, gx, partial, R, C, s_cs, qmax);
    if (mode == kCol) {
      sum_chunks_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, st>>>(
          partial, gs, chunks, C);
    } else {
      sum_all_kernel<<<1, kSumThreads, 0, st>>>(
          partial, gs, static_cast<long long>(chunks) * C);
    }
  }
}

template <typename T, int RULE>
void launch_bwd(const void* g, const void* x, const float* s, void* gx,
                float* gs, float* partial, long long R, int C, long long s_rs,
                long long s_cs, float qmax, int mode, cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  const T* xt = static_cast<const T*>(x);
  T* gxt = static_cast<T*>(gx);
  // the vector body: rows of whole vectors at aligned addresses (gs and
  // partial are fresh allocations)
  if (C % kVec == 0 && aligned4<T>(g) && aligned4<T>(x) && aligned4<T>(gx)) {
    launch_bwd_as<T, RULE, true>(gt, xt, s, gxt, gs, partial, R, C, s_rs,
                                 s_cs, qmax, mode, st);
  } else {
    launch_bwd_as<T, RULE, false>(gt, xt, s, gxt, gs, partial, R, C, s_rs,
                                  s_cs, qmax, mode, st);
  }
}

template <typename T>
void launch_fwd(const void* x, const float* s, void* y, long long R, int C,
                long long s_rs, long long s_cs, float qmax, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(R),
                  static_cast<unsigned>((C + kCols - 1) / kCols));
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (C % kVec == 0 && aligned4<T>(x) && aligned4<T>(y)) {
    fq_fwd_kernel<T, true><<<grid, kThreads, 0, st>>>(xt, s, yt, C, s_rs,
                                                      s_cs, qmax);
  } else {
    fq_fwd_kernel<T, false><<<grid, kThreads, 0, st>>>(xt, s, yt, C, s_rs,
                                                       s_cs, qmax);
  }
}

bool shape_ok(long long R, long long C) {
  return R >= 1 && C >= 1 && R <= 0x7fffffffLL && C <= 0x7fffffffLL &&
         (C + kCols - 1) / kCols <= 65535 &&
         (R + kRowChunk - 1) / kRowChunk <= 65535;
}

// ---------------------------------------------------------------------------
// the factored entry
// ---------------------------------------------------------------------------

// The view's geometry: row r reads s_wl[r % P] and s_wr row r / g; a tile
// is kTileRows x kTileCols inside one group of g rows.
struct Geo {
  long long R;        // rows of the [R, C] view
  int C;
  long long P;        // s_wl's period (its length)
  long long g;        // rows an s_wr row covers; divides R
  int cs;             // 1: s_wr rows have C columns; 0: one
  int n_ct;           // column tiles
  long long cpg;      // row chunks a group: ceil(g / kTileRows)
  long long n_tiles;  // (R / g) * cpg * n_ct
};

struct Tile {
  long long chunk;    // row chunk, counted over all groups
  long long j;        // group: the s_wr row
  long long r0, r1;   // rows [r0, r1)
  int ct, c0;         // column tile and its first column
};

__device__ __forceinline__ Tile tile_at(const Geo& G, long long i) {
  Tile t;
  t.chunk = i / G.n_ct;
  t.ct = static_cast<int>(i - t.chunk * G.n_ct);
  t.j = t.chunk / G.cpg;
  t.r0 = t.j * G.g + (t.chunk - t.j * G.cpg) * kTileRows;
  const long long end = (t.j + 1) * G.g;
  t.r1 = t.r0 + kTileRows < end ? t.r0 + kTileRows : end;
  t.c0 = t.ct * kTileCols;
  return t;
}

// the tile column of a lane's slot k: two float4s 128 columns apart in the
// vector body, a stride of 32 in the scalar one
template <bool VEC>
__device__ __forceinline__ int slot_col(int lane, int k) {
  return VEC ? (k / kVec) * (32 * kVec) + lane * kVec + k % kVec
             : k * 32 + lane;
}

// a lane's s_wr values for its slots (1 past the last column)
template <bool VEC>
__device__ __forceinline__ void load_swr(const Geo& G, const Tile& t,
                                         const float* s_wr, int lane,
                                         float* sr) {
  const float* row = s_wr + t.j * (G.cs ? G.C : 1);
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = t.c0 + slot_col<VEC>(lane, k);
    sr[k] = c < G.C ? row[G.cs ? c : 0] : 1.0f;
  }
}

template <typename TO, bool VEC, bool HAS_WL>
__global__ void __launch_bounds__(kThreads)
ffq_fwd_kernel(const float* __restrict__ w, const float* __restrict__ s_wl,
               const float* __restrict__ s_wr, TO* __restrict__ y,
               const Geo G, float qmax) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long i = blockIdx.x; i < G.n_tiles; i += gridDim.x) {
    const Tile t = tile_at(G, i);
    float sr[kSlots];
    load_swr<VEC>(G, t, s_wr, lane, sr);
    for (long long r = t.r0 + warp; r < t.r1; r += kWarps) {
      const float wl = HAS_WL ? s_wl[r % G.P] : 1.0f;
      const float* wr = w + r * G.C;
      TO* yr = y + r * G.C;
#pragma unroll
      for (int h = 0; h < kSlots / kVec; ++h) {
        if (VEC) {
          const int c = t.c0 + slot_col<true>(lane, h * kVec);
          if (c < G.C) {
            float v[kVec];
            load4(wr + c, v);
#pragma unroll
            for (int q = 0; q < kVec; ++q) {
              const float sk = sr[h * kVec + q];
              v[q] = fq(v[q], HAS_WL ? __fmul_rn(wl, sk) : sk, qmax);
            }
            store4(yr + c, v);
          }
        } else {
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            const int k = h * kVec + q;
            const int c = t.c0 + slot_col<false>(lane, k);
            if (c < G.C)
              store(yr + c, fq(wr[c], HAS_WL ? __fmul_rn(wl, sr[k]) : sr[k],
                               qmax));
          }
        }
      }
    }
  }
}

template <typename TO, bool VEC, bool HAS_WL>
__global__ void __launch_bounds__(kThreads)
ffq_bwd_kernel(const TO* __restrict__ gy, const float* __restrict__ w,
               const float* __restrict__ s_wl, const float* __restrict__ s_wr,
               float* __restrict__ gx, float* __restrict__ row_part,
               float* __restrict__ col_part, const Geo G, float qmax) {
  __shared__ float cols[kWarps][kTileCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (long long i = blockIdx.x; i < G.n_tiles; i += gridDim.x) {
    const Tile t = tile_at(G, i);
    float sr[kSlots], cacc[kSlots];
    load_swr<VEC>(G, t, s_wr, lane, sr);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) cacc[k] = 0.0f;
    for (long long r = t.r0 + warp; r < t.r1; r += kWarps) {
      const float wl = HAS_WL ? s_wl[r % G.P] : 1.0f;
      const TO* gr = gy + r * G.C;
      const float* wr = w + r * G.C;
      float* gxr = gx + r * G.C;
      float racc = 0.0f;
#pragma unroll
      for (int h = 0; h < kSlots / kVec; ++h) {
        const int cv = t.c0 + slot_col<VEC>(lane, h * kVec);
        if (VEC && cv >= G.C) continue;
        float gv[kVec], xv[kVec], dx[kVec];
        if (VEC) {
          load4(gr + cv, gv);
          load4(wr + cv, xv);
        }
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          const int k = h * kVec + q;
          const int c = t.c0 + slot_col<VEC>(lane, k);
          if (!VEC) {
            if (c >= G.C) continue;
            gv[q] = load(gr + c);
            xv[q] = wr[c];
          }
          float ds;
          fq_grad<kRuleSte>(gv[q], xv[q],
                            HAS_WL ? __fmul_rn(wl, sr[k]) : sr[k], qmax,
                            &dx[q], &ds);
          if (HAS_WL) {
            racc += __fmul_rn(ds, sr[k]);
            cacc[k] += __fmul_rn(ds, wl);
          } else {
            cacc[k] += ds;
          }
          if (!VEC) gxr[c] = dx[q];
        }
        if (VEC) store4(gxr + cv, dx);
      }
      if (HAS_WL) {                     // the row's sum over the tile
        racc = warp_sum(racc);
        if (lane == 0) row_part[t.ct * G.R + r] = racc;
      }
    }
    // the columns' sums over the tile's rows: the warps in warp order
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      cols[warp][slot_col<VEC>(lane, k)] = cacc[k];
    __syncthreads();
    float v = 0.0f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) v += cols[w8][threadIdx.x];
    if (G.cs) {
      const int c = t.c0 + threadIdx.x;
      if (c < G.C) col_part[t.chunk * G.C + c] = v;
    } else {                            // a layerwise s_wr: the tile's sum
      v = block_sum(v);
      if (threadIdx.x == 0) col_part[t.chunk * G.n_ct + t.ct] = v;
    }
    __syncthreads();
  }
}

// the partials summed in a fixed order: blocks [0, wl_blocks) give gs_wl
// (one thread a p), the rest gs_wr (one thread a [j, c], or one block a j
// for a layerwise s_wr)
__global__ void __launch_bounds__(kThreads)
ffq_finish_kernel(const float* __restrict__ row_part,
                  const float* __restrict__ col_part,
                  float* __restrict__ gs_wl, float* __restrict__ gs_wr,
                  const Geo G, unsigned wl_blocks) {
  if (blockIdx.x < wl_blocks) {
    const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
    if (p >= G.P) return;
    float acc = 0.0f;
    for (long long r = p; r < G.R; r += G.P)
      for (int ct = 0; ct < G.n_ct; ++ct) acc += row_part[ct * G.R + r];
    gs_wl[p] = acc;
    return;
  }
  const long long b = blockIdx.x - wl_blocks;
  const long long n_j = G.R / G.g;
  if (G.cs) {
    const long long i = b * kThreads + threadIdx.x;
    if (i >= n_j * G.C) return;
    const long long j = i / G.C;
    const long long c = i - j * G.C;
    float acc = 0.0f;
    for (long long k = 0; k < G.cpg; ++k)
      acc += col_part[(j * G.cpg + k) * G.C + c];
    gs_wr[i] = acc;
  } else {
    const long long n = G.cpg * G.n_ct;
    const float* src = col_part + b * n;
    float acc = 0.0f;
    for (long long k = threadIdx.x; k < n; k += kThreads) acc += src[k];
    acc = block_sum(acc);
    if (threadIdx.x == 0) gs_wr[b] = acc;
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n < 1)
    n = 1;
  return n;
}

// a grid of the blocks resident at once, or fewer when there are fewer tiles
template <typename K>
unsigned grid_for(K kernel, const Geo& G) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    0) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long resident = static_cast<long long>(per_sm) * sm_count();
  return static_cast<unsigned>(G.n_tiles < resident ? G.n_tiles : resident);
}

template <typename TO, bool VEC, bool HAS_WL>
void ffq_fwd_as(const float* w, const float* s_wl, const float* s_wr, void* y,
                const Geo& G, float qmax, cudaStream_t st) {
  auto kernel = ffq_fwd_kernel<TO, VEC, HAS_WL>;
  kernel<<<grid_for(kernel, G), kThreads, 0, st>>>(
      w, s_wl, s_wr, static_cast<TO*>(y), G, qmax);
}

template <typename TO>
void ffq_fwd(const float* w, const float* s_wl, const float* s_wr, void* y,
             const Geo& G, float qmax, cudaStream_t st) {
  const bool vec = G.C % kVec == 0 && aligned4<float>(w) && aligned4<TO>(y);
  if (vec && s_wl) {
    ffq_fwd_as<TO, true, true>(w, s_wl, s_wr, y, G, qmax, st);
  } else if (vec) {
    ffq_fwd_as<TO, true, false>(w, s_wl, s_wr, y, G, qmax, st);
  } else if (s_wl) {
    ffq_fwd_as<TO, false, true>(w, s_wl, s_wr, y, G, qmax, st);
  } else {
    ffq_fwd_as<TO, false, false>(w, s_wl, s_wr, y, G, qmax, st);
  }
}

template <typename TO, bool VEC, bool HAS_WL>
void ffq_bwd_as(const void* gy, const float* w, const float* s_wl,
                const float* s_wr, float* gx, float* row_part,
                float* col_part, const Geo& G, float qmax, cudaStream_t st) {
  auto kernel = ffq_bwd_kernel<TO, VEC, HAS_WL>;
  kernel<<<grid_for(kernel, G), kThreads, 0, st>>>(
      static_cast<const TO*>(gy), w, s_wl, s_wr, gx, row_part, col_part, G,
      qmax);
}

template <typename TO>
void ffq_bwd(const void* gy, const float* w, const float* s_wl,
             const float* s_wr, float* gx, float* row_part, float* col_part,
             const Geo& G, float qmax, cudaStream_t st) {
  const bool vec = G.C % kVec == 0 && aligned4<TO>(gy) &&
                   aligned4<float>(w) && aligned4<float>(gx);
  if (vec && s_wl) {
    ffq_bwd_as<TO, true, true>(gy, w, s_wl, s_wr, gx, row_part, col_part, G,
                               qmax, st);
  } else if (vec) {
    ffq_bwd_as<TO, true, false>(gy, w, s_wl, s_wr, gx, row_part, col_part, G,
                                qmax, st);
  } else if (s_wl) {
    ffq_bwd_as<TO, false, true>(gy, w, s_wl, s_wr, gx, row_part, col_part, G,
                                qmax, st);
  } else {
    ffq_bwd_as<TO, false, false>(gy, w, s_wl, s_wr, gx, row_part, col_part,
                                 G, qmax, st);
  }
}

// the geometry of an [R, C] view, or false where the index form does not
// hold (the wrapper checks the same before the launch)
bool make_geo(long long R, long long C, long long P, long long g, int cs,
              Geo* G) {
  if (R < 1 || C < 1 || C > 0x7fffffffLL || P < 1 || g < 1 || R % g ||
      R % P || (cs != 0 && cs != 1))
    return false;
  G->R = R;
  G->C = static_cast<int>(C);
  G->P = P;
  G->g = g;
  G->cs = cs;
  G->n_ct = static_cast<int>((C + kTileCols - 1) / kTileCols);
  G->cpg = (g + kTileRows - 1) / kTileRows;
  G->n_tiles = (R / g) * G->cpg * G->n_ct;
  return true;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sf = static_cast<const float*>(s);
  const int c = static_cast<int>(C);
  if (dtype == kF32) {
    launch_fwd<float>(x, sf, y, R, c, s_rs, s_cs, qmax, st);
  } else if (dtype == kBF16) {
    launch_fwd<__nv_bfloat16>(x, sf, y, R, c, s_rs, s_cs, qmax, st);
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

// The factored entry.  w: f32 [R, C]; s_wl: f32 [P] or null (S_wL = 1);
// s_wr: f32 [R/g, C] (cs 1) or [R/g, 1] (cs 0); y: [R, C] in out_dtype
// (0 f32, 1 bf16).
extern "C" int qft_fake_quant_factored_fwd(const void* w, const void* s_wl,
                                           const void* s_wr, void* y,
                                           long long R, long long C,
                                           long long P, long long g, int cs,
                                           int bits, int out_dtype,
                                           void* stream) {
  Geo G;
  if (!make_geo(R, C, s_wl ? P : R, g, cs, &G) || bits < 2 || bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* wl = static_cast<const float*>(s_wl);
  const float* wr = static_cast<const float*>(s_wr);
  if (out_dtype == kF32) {
    ffq_fwd<float>(wf, wl, wr, y, G, qmax, st);
  } else if (out_dtype == kBF16) {
    ffq_fwd<__nv_bfloat16>(wf, wl, wr, y, G, qmax, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// gy: [R, C] in out_dtype; gx: f32 [R, C]; gs_wl: f32 [P] (with s_wl);
// gs_wr: f32 at s_wr's shape.  Scratch, f32: row_part [ceil(C/256), R]
// (with s_wl), col_part [(R/g)*ceil(g/64), C] (cs 1) or
// [(R/g)*ceil(g/64), ceil(C/256)] (cs 0).  Two launches: the elementwise
// pass with the tiles' partial sums, then their fixed-order sums.
extern "C" int qft_fake_quant_factored_bwd(
    const void* gy, const void* w, const void* s_wl, const void* s_wr,
    void* gx, void* gs_wl, void* gs_wr, void* row_part, void* col_part,
    long long R, long long C, long long P, long long g, int cs, int bits,
    int out_dtype, void* stream) {
  Geo G;
  if (!make_geo(R, C, s_wl ? P : R, g, cs, &G) || bits < 2 || bits > 16 ||
      col_part == nullptr ||
      (s_wl != nullptr && (row_part == nullptr || gs_wl == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float qmax = static_cast<float>((1 << (bits - 1)) - 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* wl = static_cast<const float*>(s_wl);
  const float* wr = static_cast<const float*>(s_wr);
  float* gxf = static_cast<float*>(gx);
  float* rp = static_cast<float*>(row_part);
  float* cp = static_cast<float*>(col_part);
  if (out_dtype == kF32) {
    ffq_bwd<float>(gy, wf, wl, wr, gxf, rp, cp, G, qmax, st);
  } else if (out_dtype == kBF16) {
    ffq_bwd<__nv_bfloat16>(gy, wf, wl, wr, gxf, rp, cp, G, qmax, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_j = R / g;
  const unsigned wl_blocks =
      s_wl ? static_cast<unsigned>((P + kThreads - 1) / kThreads) : 0u;
  const long long wr_blocks = cs ? (n_j * C + kThreads - 1) / kThreads : n_j;
  ffq_finish_kernel<<<static_cast<unsigned>(wl_blocks + wr_blocks), kThreads,
                      0, st>>>(rp, cp, static_cast<float*>(gs_wl),
                               static_cast<float*>(gs_wr), G, wl_blocks);
  return static_cast<int>(cudaGetLastError());
}
