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
// A second entry, `qft_quant_matmul_dequant`, replaces the Pallas baseline
// `_qmm_dequant_kernel` / `_qmm_dequant_group_kernel` (variant="dequant"):
// it dequantizes the weight as (q * s_wl[k]) * s_wr[k / group, n] before
// the product (the classic "dequantize, then GEMM"), the baseline against
// which the first entry's hoisted scales are measured.  Same pipeline, the
// scales moved from the partial sums into the weight operand.
//
// What bounds it on the H100.  At decode M (1 to 16 rows) the packed
// weight read, K*N/2 bytes over 3.35 TB/s; a small linear (2 MB) is bound
// by latency instead: one DRAM round trip, the block's reduction and the
// split combine.  At prefill M (128 rows) bf16 is bound by the tensor
// cores' operations.  f32 x stays on CUDA-core FMAs, whose rate bounds it
// only at large M (the f32 tolerances rule out TF32 or bf16 operands).
//
// Precision.  The reference keeps x*s_wl (K1) and the dequantized weight
// (K5) in f32; one bf16 rounding of that operand puts the card tests'
// elementwise 2e-2 out of reach at K 256.  The decode body therefore
// carries it as a bf16 pair hi + lo (two exact products, 2^-16), and the
// wide body as fp16 after an exact power-of-two scaling that puts each row
// of x (and, for K5, each block's weights) in [2^14, 2^15): 11 significant
// bits and one product, undone on the output.
//
// Design.  Three bodies, chosen by the wrapper's launch plan before the
// launch (kernels/quant_matmul.py: plan), all fed by one loader:
// - the loader streams the packed weight in chunks of 64 K-rows (32 packed
//   rows) as 16-byte cp.async copies into a ring of shared-memory stages
//   (8 stages of 2 KB for the 64-column bodies, 4 of 4 KB plus the x tile
//   for the wide one), so the loads of the next stages overlap the product
//   of this one; the 8-byte columns of each row are XOR-swizzled so that
//   the fragment reads below hit 32 distinct banks;
// - the unpack happens in registers: one byte holds the K-pair (2i, 2i+1)
//   of one column, exactly one 16-bit x2 register of an mma.sync m16n8k16
//   A fragment when W is the A operand.  prmt puts the low nibble in the
//   low half and the high nibble in the high half; lop3 masks them, flips
//   the sign bit (offset binary) and ORs in the bits of a bf16 128.0 (fp16
//   1024.0) in one instruction; one x2 fma subtracts 136 (1032).  Every
//   value in [-8, 7] is exact;
// - split-K fills the card: the grid is (M-tiles x N-tiles, K-splits), with
//   the split length chosen by the plan so that a shape launches at least
//   2 x 132 blocks where it can.  A split holds whole K-groups, or a group
//   holds whole splits, so s_wr still multiplies one partial per group.
//   Each block writes its f32 partial to a workspace [splits, M, N]; the
//   block that arrives last at its output tile (an integer counter, reset
//   by that block for the next launch) sums the partials in split order,
//   eight loads in flight at a time.  No float atomics: two launches give
//   identical bits.  The wide body keeps to one wave of three blocks an SM
//   and at most 8 splits, since its last block reads 32 KB a split;
// - each step's scales (the s_wr row of its group, the dequant's s_wl) are
//   loaded before the wait on its weights, and the group of a step is kept
//   by counters, not a division a step.
// Bodies:
// - `mma` (bf16, M <= 16): W is the A operand (16 columns of N), x the B
//   operand (n8 = 8 tokens, one or two tiles), so decode M wastes at most
//   half a tile.  A block owns 64 columns and one K-split; its 4 warps take
//   interleaved k16 steps of each chunk and are summed in warp order at the
//   end.  x*s_wl of the block's split is formed in f32 once and kept in
//   shared memory as hi and lo.  Each warp keeps two register accumulators,
//   the per-group partial and the sum, and applies s_wr at each group
//   boundary (one accumulator where the split lies in one group).
// - `mma_wide` (bf16, M > 16): a 64-token x 128-column tile per block of 4
//   warps (2 along N, 2 along tokens, 64 x 32 each), the same loader for W
//   and a cp.async ring for the fp16 x tile, B fragments through ldmatrix;
//   a pre-pass kernel forms the row-scaled fp16 x (times s_wl for int8dot).
//   On the H100 its loads alone and its products alone each take most of
//   its time, and the split epilogue a fifth: a wider tile (fewer x reads
//   from L2) lost more to occupancy than it saved; wgmma on unpacked tiles
//   and a combine inside a cluster are the next steps.
// - `fma` (f32): 64 columns x 8 tokens per block, x*s_wl in f32 in shared
//   memory, each thread one column and half of every chunk's rows, CUDA-core
//   FMAs, the halves summed in order.
// The dequant entry runs the same bodies with the dequant moved before the
// product: (q * s_wl[k]) * s_wr[g, n] in f32 with the reference's
// multiplication order, then the same mma on raw x (f32: __fmul_rn in that
// order, then FMAs).
// N and K must tile by 64, a group must be a multiple of 16 that divides or
// is divided by 64, any M >= 1 (rows past M are masked); the 128-column
// tile of the wide body masks whole warps past N.
//
// A third entry, `qft_quant_matmul_i8`, takes the unpacked int8 weights of
// the linears the plan keeps at 8 bits (q [K, N] int8; the reference's
// qlinear_deployed feeds them to dot_general as the integer operand):
//     y = sum_g s_wr[g] * ((x * s_wl)[:, g] @ q[g]).
// Two bodies, chosen by the wrapper's plan_int8:
// - `mma` (bf16 x, M <= 16, a shape the packed bodies tile): the `mma`
//   body above with the int8 weight as the A operand.  The loader copies
//   64 rows x 64 columns a stage (4 KB, 8 stages, the same swizzle); a
//   fragment register takes two bytes of one column from two rows and
//   widens them to bf16 exactly (i8pair4).  The two rows of a register
//   are 4 apart (rows tq and tq + 4 of the k16 step), so the 4 rows a
//   load instruction reads fall in distinct banks; the staged x * s_wl is
//   permuted the same way within each 8 rows (scale_split8<true>), so the
//   product is the same sum over K.  The same split plan, group flush and
//   ordered split combine as the int4 entry.
// - `fma` (f32 x, and every other shape): the fma body's split-K pipeline
//   with a byte load where the packed bodies unpack nibbles: 64-row stages
//   of 64 int8 columns (4 KB, 4 stages), x * s_wl in f32 in shared memory
//   (bf16 x is widened there), one column a thread, the group partial
//   scaled by s_wr where a row opens a new group, the same ordered split
//   combine.  Any shape is taken: columns past N and rows past K are
//   masked (the paper CNN's fc is N 10, a router N 60).  It also takes the
//   int4 entry's nibble-packed weight (`packed`), for the int4 shapes the
//   packed bodies do not tile: a stage holds 32 packed rows and a row's
//   value is the low or high nibble of its byte, read in place.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };
enum Body { kFma = 0, kMma = 1, kMmaWide = 2 };

constexpr int kChunk = 64;            // K-rows per pipeline stage
constexpr int kPairs = kChunk / 2;    // packed rows per stage
constexpr int kBN = 64;               // columns of the mma and fma bodies
constexpr int kStages = 8;            // ring stages of the 64-column bodies
constexpr int kStageBytes = kPairs * kBN;
constexpr int kTileLd = kBN + 4;      // f32 result tile row (+4: banks)
constexpr int kWideBM = 64;                            // tokens a block
constexpr int kWideBN = 128;                           // columns a block
constexpr int kWideThreads = 128;                      // 2 x 2 warps
constexpr int kWideStages = 4;
constexpr int kWideXBytes = kWideBM * kChunk * 2;      // 8 KB of fp16 x
constexpr int kWideWBytes = kPairs * kWideBN;          // 4 KB of packed W
constexpr int kWideStage = kWideWBytes + kWideXBytes;
constexpr int kWideLd = kWideBN + 4;                   // f32 result tile row
constexpr int kWideSmem = kWideStages * kWideStage > kWideBM * kWideLd * 4
                              ? kWideStages * kWideStage
                              : kWideBM * kWideLd * 4;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

// Copies 16 bytes, or writes 16 zero bytes when `valid` is false.
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// D += A B: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t r) {
  return __uint_as_float(r << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t r) {
  return __uint_as_float(r & 0xffff0000u);
}

// One packed word (4 columns at one K-pair) -> 4 bf16x2 registers; register
// j holds column j's rows (2i, 2i+1) as (low half, high half).
__device__ __forceinline__ void unpack4(uint32_t w, uint32_t (&r)[4]) {
  const uint32_t hi = w >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte 0 <- w.byte j (low nibble), byte 2 <- (w >> 4).byte j (high)
    const uint32_t t = __byte_perm(w, hi, 0x0400u + 0x0101u * j);
    uint32_t v;
    // (t & 0x000f000f) ^ 0x43084308: offset binary in a bf16 128.0 -> 128+u
    asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
        : "=r"(v) : "r"(t), "r"(0x000f000fu), "r"(0x43084308u));
    // (128 + u) * 1 - 136 = q, exact
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(r[j]) : "r"(v), "r"(0x3f803f80u), "r"(0xc308c308u));
  }
}

// Two int8 words (4 columns at rows r0 and r1) -> 4 bf16x2 registers;
// register j holds column j's (row r0, row r1) as (low half, high half).
// Offset binary q + 128 in the low byte of the f32 2^23 is 2^23 + q + 128;
// subtracting 2^23 + 128 leaves q, exact, and its upper 16 bits are its
// bf16 (|q| <= 128 needs 8 significant bits).
__device__ __forceinline__ void i8pair4(uint32_t w0, uint32_t w1,
                                        uint32_t (&r)[4]) {
  const uint32_t u0 = w0 ^ 0x80808080u, u1 = w1 ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float a =
        __uint_as_float(__byte_perm(u0, 0x4b000000u, 0x7650u + j)) -
        8388736.f;
    const float b =
        __uint_as_float(__byte_perm(u1, 0x4b000000u, 0x7650u + j)) -
        8388736.f;
    r[j] = __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
  }
}

// Two f32 values as a bf16x2 pair hi + lo: hi = bf16(v), lo = bf16(v - hi)
// (the difference is exact), so hi + lo carries v to 2^-16 and two exact
// bf16 products with f32 accumulation stand in for one f32 product.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf16_lo(hi), b - bf16_hi(hi));
}

// The dequantized weight of one A register, (q * s_wl[k]) * s_wr[g, n] in
// f32 for rows (2i, 2i+1), as a hi/lo bf16 pair.
__device__ __forceinline__ void dequant2(uint32_t q, float2 wl, float wr,
                                         uint32_t& hi, uint32_t& lo) {
  split2(__fmul_rn(__fmul_rn(bf16_lo(q), wl.x), wr),
         __fmul_rn(__fmul_rn(bf16_hi(q), wl.y), wr), hi, lo);
}

// The 4 A fragments of a warp's k16 step from its two 8-byte reads (rows
// pa = 8s + tq and pa + 4, columns nw .. nw + 7): tile a = 2i + h covers
// columns nw + 4i + 2h (rows g) and + 1 (rows g + 8).  int8dot: the
// integers (L unused); dequant: the dequantized weight's hi and lo parts,
// with s_wl at rows k + 2tq (la) and k + 8 + 2tq (lb) and s_wr of the step's
// group for the 8 columns (sr).
template <bool kDequant>
__device__ __forceinline__ void a_frags(uint2 wa, uint2 wb, float2 la,
                                        float2 lb, const float (&sr)[8],
                                        uint32_t (&A)[4][4],
                                        uint32_t (&L)[4][4]) {
  uint32_t ra[4], rb[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    unpack4(i ? wa.y : wa.x, ra);
    unpack4(i ? wb.y : wb.x, rb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t(&a)[4] = A[2 * i + h];
      if (kDequant) {
        uint32_t(&l)[4] = L[2 * i + h];
        const float c0 = sr[4 * i + 2 * h], c1 = sr[4 * i + 2 * h + 1];
        dequant2(ra[2 * h], la, c0, a[0], l[0]);
        dequant2(ra[2 * h + 1], la, c1, a[1], l[1]);
        dequant2(rb[2 * h], lb, c0, a[2], l[2]);
        dequant2(rb[2 * h + 1], lb, c1, a[3], l[3]);
      } else {
        a[0] = ra[2 * h];
        a[1] = ra[2 * h + 1];
        a[2] = rb[2 * h];
        a[3] = rb[2 * h + 1];
      }
    }
  }
}

// a_frags for the int8 weight: rows r0 .. r3 are the k16 step's rows tq,
// tq + 4, tq + 8 and tq + 12 (8 bytes, columns nw .. nw + 7).  K-slots
// (2tq, 2tq + 1) of the mma take rows (tq, tq + 4), slots (2tq + 8,
// 2tq + 9) rows (tq + 8, tq + 12); the columns as in a_frags.
__device__ __forceinline__ void a_frags_i8(uint2 r0, uint2 r1, uint2 r2,
                                           uint2 r3, uint32_t (&A)[4][4]) {
  uint32_t ra[4], rb[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    i8pair4(i ? r0.y : r0.x, i ? r1.y : r1.x, ra);
    i8pair4(i ? r2.y : r2.x, i ? r3.y : r3.x, rb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t(&a)[4] = A[2 * i + h];
      a[0] = ra[2 * h];
      a[1] = ra[2 * h + 1];
      a[2] = rb[2 * h];
      a[3] = rb[2 * h + 1];
    }
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 w = reinterpret_cast<const float4*>(p)[1];
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
}

// 8 bf16 of x (one uint4) times s_wl[k .. k+7] in f32, as hi and lo parts.
// kPerm (the int8 weight's K-slot order): word t holds rows (t, t + 4).
template <bool kPerm>
__device__ __forceinline__ void scale_split8(uint4 raw, const float* wl,
                                             uint4& hi, uint4& lo) {
  float s[8];
  load8(wl, s);
  const float v[8] = {bf16_lo(raw.x) * s[0], bf16_hi(raw.x) * s[1],
                      bf16_lo(raw.y) * s[2], bf16_hi(raw.y) * s[3],
                      bf16_lo(raw.z) * s[4], bf16_hi(raw.z) * s[5],
                      bf16_lo(raw.w) * s[6], bf16_hi(raw.w) * s[7]};
  const int d = kPerm ? 4 : 1;
  const int t = kPerm ? 1 : 2;
  split2(v[0], v[d], hi.x, lo.x);
  split2(v[t], v[t + d], hi.y, lo.y);
  split2(v[2 * t], v[2 * t + d], hi.z, lo.z);
  split2(v[3 * t], v[3 * t + d], hi.w, lo.w);
}

__device__ __forceinline__ float nibble(uint32_t b) {
  return static_cast<float>(static_cast<int>(b << 28) >> 28);  // sign-extend
}


__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y),
                                            pack_bf16(v.z, v.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The K-group of a row that moves by fixed steps: its index and the row's
// offset in it, kept by additions rather than a division each step.
struct GroupPos {
  int g, off, group;
  __device__ GroupPos(int k, int group_)
      : g(k / group_), off(k % group_), group(group_) {}
  // whether the row `step` rows on lies in another group
  __device__ bool ends(int step) const { return off + step >= group; }
  __device__ void advance(int step) {
    off += step;
    while (off >= group) { off -= group; ++g; }
  }
};

// ---------------------------------------------------------------------------
// Shared pieces of the three bodies
// ---------------------------------------------------------------------------

// Byte offset of packed row p, column n in a 64-column stage: 8-byte column
// (n / 8) XOR 4 on rows with bit 1 set, so the 4 rows of a fragment read
// (p = 8s + tq, tq = 0..3) fall on 4 distinct 16-bank quarters.
__device__ __forceinline__ int stage_off(int p, int n) {
  return p * kBN + ((((n >> 3) ^ (((p >> 1) & 1) << 2))) << 3) + (n & 7);
}

// One thread's share of each 64-K-row chunk of the weight, addressed
// once: packed, 32 rows x 64 columns, one 16-byte copy each of 128
// threads; int8 (kI8), 64 rows, two copies (rows p and p + 32, the same
// swizzle).  Chunk c goes to ring stage c mod kStages.
template <bool kI8>
struct W64Copy {
  static constexpr int kRows = kI8 ? kChunk : kPairs;
  static constexpr int kBytes = kRows * kBN;      // a stage
  const uint8_t* src;
  uint32_t dst;
  size_t step, second;
  __device__ W64Copy(const uint8_t* qw, int N, int row0, int n0,
                     uint32_t ring) {
    const int p = threadIdx.x >> 2;
    const int j = threadIdx.x & 3;
    src = qw + static_cast<size_t>(row0 + p) * N + n0 + 16 * j;
    dst = ring + stage_off(p, 16 * j);
    step = static_cast<size_t>(kRows) * N;
    second = static_cast<size_t>(32) * N;
  }
  __device__ void issue(int c) const {
    const uint32_t d = dst + (c % kStages) * kBytes;
    cp_async16(d, src + c * step);
    if (kI8) cp_async16(d + 32 * kBN, src + c * step + second);
  }
};

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// block_store one element at a time, for an N that is not a multiple of 4.
template <typename T>
__device__ void block_store_scalar(const float* tile, int ld,
                                   int part_stride, int parts, int bm, int bn,
                                   int m0, int n0, int M, int N, T* y,
                                   float* ws, int* counter, int split,
                                   int splits) {
  __shared__ int s_last1;
  for (int i = threadIdx.x; i < bm * bn; i += blockDim.x) {
    const int r = i / bn;
    const int c = i % bn;
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = tile[r * ld + c];
    for (int q = 1; q < parts; ++q) v += tile[r * ld + c + q * part_stride];
    if (splits == 1)
      store1(y + static_cast<size_t>(m) * N + n, v);
    else
      ws[(static_cast<size_t>(split) * M + m) * N + n] = v;
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last1 = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!s_last1) return;
  __threadfence();
  for (int i = threadIdx.x; i < bm * bn; i += blockDim.x) {
    const int m = m0 + i / bn;
    const int n = n0 + i % bn;
    if (m >= M || n >= N) continue;
    const size_t mn = static_cast<size_t>(m) * N + n;
    const size_t step = static_cast<size_t>(M) * N;
    float v = __ldcg(ws + mn);
    for (int s = 1; s < splits; ++s) v += __ldcg(ws + s * step + mn);
    store1(y + mn, v);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// The block's f32 result: `parts` tiles [bm][ld] at `tile`, `part_stride`
// floats apart, summed in order.  One split: y directly.  Several: the sum
// goes to ws[split]; the block that arrives last at this output tile sums
// ws[0 .. splits) in split order into y and resets the counter.
template <typename T>
__device__ void block_store(const float* tile, int ld, int part_stride,
                            int parts, int bm, int bn, int m0, int n0, int M,
                            int N, T* y, float* ws, int* counter, int split,
                            int splits) {
  __shared__ int s_last;
  if (N & 3) {                          // the int8 entry's ragged N
    block_store_scalar(tile, ld, part_stride, parts, bm, bn, m0, n0, M, N,
                       y, ws, counter, split, splits);
    return;
  }
  const int nv = bn / 4;
  for (int i = threadIdx.x; i < bm * nv; i += blockDim.x) {
    const int r = i / nv;
    const int c = 4 * (i % nv);
    const int m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    const float* t = tile + r * ld + c;
    float4 v = *reinterpret_cast<const float4*>(t);
    for (int q = 1; q < parts; ++q)
      v = add4(v, *reinterpret_cast<const float4*>(t + q * part_stride));
    if (splits == 1)
      store4(y + static_cast<size_t>(m) * N + n, v);
    else
      store4(ws + (static_cast<size_t>(split) * M + m) * N + n, v);
  }
  if (splits == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < bm * nv; i += blockDim.x) {
    const int m = m0 + i / nv;
    const int n = n0 + 4 * (i % nv);
    if (m >= M || n >= N) continue;
    const size_t mn = static_cast<size_t>(m) * N + n;
    const size_t step = static_cast<size_t>(M) * N;
    // eight loads in flight at a time, summed in split order
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += 8) {
      float4 part[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < splits)
          part[j] = __ldcg(
              reinterpret_cast<const float4*>(ws + (s0 + j) * step + mn));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < splits) v = s0 + j == 0 ? part[0] : add4(v, part[j]);
    }
    store4(y + mn, v);
  }
  if (threadIdx.x == 0) *counter = 0;
}

struct Split {
  int m0, n0, m_tile, n_tile, split, k_begin, k_end;
};

__device__ __forceinline__ Split block_split(int m_tiles, int bm, int bn,
                                             int ks, int K) {
  Split s;
  s.m_tile = blockIdx.x % m_tiles;
  s.n_tile = blockIdx.x / m_tiles;
  s.m0 = s.m_tile * bm;
  s.n0 = s.n_tile * bn;
  s.split = blockIdx.y;
  s.k_begin = s.split * ks;
  s.k_end = min(K, s.k_begin + ks);
  return s;
}

// ---------------------------------------------------------------------------
// Body `mma`: bf16, M <= 16, split-K, W as the A operand
// ---------------------------------------------------------------------------

// kI8: the int8 entry's weight, q [K, N] int8 (see the header).
template <int MT, bool kDequant, bool kTwoAcc, bool kI8 = false>
__global__ void __launch_bounds__(128) qmm_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw,
    const float* __restrict__ s_wl, const float* __restrict__ s_wr,
    __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
    int* __restrict__ counters, int M, int N, int K, int group, int ks,
    int m_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int BM = 8 * MT;
  using Copy = W64Copy<kI8>;
  uint8_t* ring = smem;
  // x of the block's rows and split: raw for dequant; x * s_wl as hi, lo
  __nv_bfloat16* xhi =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * Copy::kBytes);
  const int xld = ks + 8;       // (ks + 8) / 2 words = 4 mod 32: no conflicts
  __nv_bfloat16* xlo = xhi + BM * xld;
  const Split sp = block_split(m_tiles, BM, kBN, ks, K);
  const int n_chunks = (sp.k_end - sp.k_begin) / kChunk;
  const int row0 = kI8 ? sp.k_begin : sp.k_begin / 2;

  const Copy wcopy(qw, N, row0, sp.n0, smem_u32(ring));
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) wcopy.issue(c);
    cp_commit();
  }

  const int n8 = (sp.k_end - sp.k_begin) / 8;
  for (int i = threadIdx.x; i < BM * n8; i += blockDim.x) {
    const int r = i / n8;
    const int k = 8 * (i % n8);
    const int m = sp.m0 + r;
    uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
    if (m < M) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(m) * K + sp.k_begin + k);
      if (kDequant) hi = raw;
      else scale_split8<kI8>(raw, s_wl + sp.k_begin + k, hi, lo);
    }
    *reinterpret_cast<uint4*>(xhi + r * xld + k) = hi;
    if (!kDequant) *reinterpret_cast<uint4*>(xlo + r * xld + k) = lo;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  // the fragment's packed rows 8 warp + tq and + 4 (256 bytes on); int8:
  // rows 16 warp + tq, + 4, + 8, + 12
  const int a_off = stage_off((kI8 ? 16 : 8) * warp + tq, 8 * g);
  const int nw = sp.n0 + 8 * g;        // this thread's 8 columns

  // [token tile][A tile][fragment]: see a_frags for the columns
  float part[MT][4][4];
  float acc[MT][4][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) { part[t][a][e] = 0.f; acc[t][a][e] = 0.f; }

  GroupPos gp(sp.k_begin + 16 * warp, group);   // this warp's steps' group
  for (int c = 0; c < n_chunks; ++c) {
    const int kloc = c * kChunk + 16 * warp;     // this warp's k16 step
    const int k = sp.k_begin + kloc;
    // the step's scales, loaded before the wait on its weights so that
    // their latency hides behind it: s_wr of the step's group (dequant, or
    // the group flush) and s_wl of its rows (dequant)
    float sr[8] = {};
    float2 la = make_float2(0.f, 0.f), lb = la;
    if (kDequant || kTwoAcc)
      load8(s_wr + static_cast<size_t>(gp.g) * N + nw, sr);
    if (kDequant) {
      la = *reinterpret_cast<const float2*>(s_wl + k + 2 * tq);
      lb = *reinterpret_cast<const float2*>(s_wl + k + 8 + 2 * tq);
    }
    cp_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < n_chunks) wcopy.issue(c + kStages - 1);
    cp_commit();
    const uint8_t* st = ring + (c % kStages) * Copy::kBytes;
    const uint2 wa = *reinterpret_cast<const uint2*>(st + a_off);
    const uint2 wb = *reinterpret_cast<const uint2*>(st + a_off + 256);
    uint32_t A[4][4], L[4][4];
    if (kI8)
      a_frags_i8(wa, wb, *reinterpret_cast<const uint2*>(st + a_off + 512),
                 *reinterpret_cast<const uint2*>(st + a_off + 768), A);
    else
      a_frags<kDequant>(wa, wb, la, lb, sr, A, L);
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      const int off = (8 * t + g) * xld + kloc + 2 * tq;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xhi + off);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xhi + off + 8);
      if (kDequant) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          mma_bf16(acc[t][a], A[a], b0, b1);
          mma_bf16(acc[t][a], L[a], b0, b1);
        }
      } else {
        const uint32_t c0 = *reinterpret_cast<const uint32_t*>(xlo + off);
        const uint32_t c1 =
            *reinterpret_cast<const uint32_t*>(xlo + off + 8);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          mma_bf16(part[t][a], A[a], b0, b1);
          mma_bf16(part[t][a], A[a], c0, c1);
        }
      }
    }
    if (!kDequant && kTwoAcc && (c == n_chunks - 1 || gp.ends(kChunk))) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[t][a][e] += part[t][a][e] * sr[2 * a + (e >> 1)];
            part[t][a][e] = 0.f;
          }
    }
    gp.advance(kChunk);
  }
  if (!kDequant && !kTwoAcc) {          // the split lies in one group
    float sc[8];
    load8(s_wr + static_cast<size_t>(sp.k_begin / group) * N + nw, sc);
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][a][e] = part[t][a][e] * sc[2 * a + (e >> 1)];
  }
  cp_wait<0>();
  __syncthreads();

  // each warp's [BM][64] tile, then the 4 summed in warp order
  float* tiles = reinterpret_cast<float*>(smem);
  float* mine = tiles + warp * BM * kTileLd;
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {      // token 2tq + e
      float* row = mine + (8 * t + 2 * tq + e) * kTileLd + 8 * g;
      *reinterpret_cast<float4*>(row) = make_float4(
          acc[t][0][e], acc[t][0][2 + e], acc[t][1][e], acc[t][1][2 + e]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(
          acc[t][2][e], acc[t][2][2 + e], acc[t][3][e], acc[t][3][2 + e]);
    }
  __syncthreads();
  block_store(tiles, kTileLd, BM * kTileLd, 4, BM, kBN, sp.m0, sp.n0, M, N, y,
              ws, counters + blockIdx.x, sp.split, gridDim.y);
}

// ---------------------------------------------------------------------------
// Body `mma_wide`: bf16 x, M > 16, 64 x 128 tiles of 4 warps, fp16 operands
// ---------------------------------------------------------------------------

// D += A B: m16n8k16, fp16 operands, f32 accumulators.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// unpack4 for fp16: the same bytes, the bits of an fp16 1024.0 and -1032.
__device__ __forceinline__ void unpack4_f16(uint32_t w, uint32_t (&r)[4]) {
  const uint32_t hi = w >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t t = __byte_perm(w, hi, 0x0400u + 0x0101u * j);
    uint32_t v;
    asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
        : "=r"(v) : "r"(t), "r"(0x000f000fu), "r"(0x64086408u));
    asm("fma.rn.f16x2 %0, %1, %2, %3;\n"
        : "=r"(r[j]) : "r"(v), "r"(0x3c003c00u), "r"(0xe408e408u));
  }
}

__device__ __forceinline__ float2 f16x2_to_float2(uint32_t r) {
  return __half22float2(*reinterpret_cast<const __half2*>(&r));
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i)
    v = fmaxf(v, red[i]);
  return v;
}

// The exponent e with largest * 2^e in [2^14, 2^15) (0 for 0): after that
// exact scaling fp16 holds every value without overflow, to 11 significant
// bits for all but those 2^28 times smaller than the largest.
__device__ __forceinline__ int fp16_exponent(float largest) {
  if (!(largest > 0.f)) return 0;
  int ex;
  frexpf(largest, &ex);                 // largest = f * 2^ex, f in [0.5, 1)
  return min(max(15 - ex, -100), 100);
}

// One row of bf16 x (times s_wl for int8dot) per block, scaled by a power
// of two 2^e so that its largest magnitude lies in [2^14, 2^15), rounded to
// fp16 into xh [M, K]; rs[m] = 2^-e undoes the scaling on the row's output.
template <bool kScale>
__global__ void __launch_bounds__(256) qmm_rows_f16_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ s_wl,
    __half* __restrict__ xh, float* __restrict__ rs, int K) {
  __shared__ float red[8];
  const size_t row = static_cast<size_t>(blockIdx.x) * K;
  auto values = [&](int k, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(x + row + k);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float s[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
    if (kScale) load8(s_wl + k, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_lo(w[i]) * s[2 * i];
      v[2 * i + 1] = bf16_hi(w[i]) * s[2 * i + 1];
    }
  };
  float mx = 0.f;
  for (int k = 8 * threadIdx.x; k < K; k += 8 * blockDim.x) {
    float v[8];
    values(k, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fabsf(v[i]));
  }
  const int e = fp16_exponent(block_max(mx, red));
  const float p = ldexpf(1.f, e);
  for (int k = 8 * threadIdx.x; k < K; k += 8 * blockDim.x) {
    float v[8];
    values(k, v);
    *reinterpret_cast<uint4*>(xh + row + k) = make_uint4(
        pack_f16(v[0] * p, v[1] * p), pack_f16(v[2] * p, v[3] * p),
        pack_f16(v[4] * p, v[5] * p), pack_f16(v[6] * p, v[7] * p));
  }
  if (threadIdx.x == 0) rs[blockIdx.x] = ldexpf(1.f, -e);
}

// Byte offset of packed row p, 8-byte column c8 in a 128-column stage: the
// column XOR 4 * (p mod 4), so a fragment read's 4 rows are bank-disjoint.
__device__ __forceinline__ int wide_off(int p, int c8) {
  return p * kWideBN + ((c8 ^ ((p & 3) << 2)) << 3);
}

// x comes from qmm_rows_f16_kernel: fp16 [M, K] and the row scales rs [M].
// int8dot: A = the integers in fp16.  dequant: A = ((q * s_wl) * s_wr) *
// 2^-E in f32 (2^-E folded into s_wr, exact), rounded to fp16, with E per
// block so that 8 max|s_wl| max|s_wr| 2^-E < 2^15 over the block's split
// and columns; the output is multiplied back by 2^E.
template <bool kDequant, bool kTwoAcc>
__global__ void __launch_bounds__(kWideThreads, 3) qmm_mma_wide_kernel(
    const __half* __restrict__ xh, const uint8_t* __restrict__ qw,
    const float* __restrict__ s_wl, const float* __restrict__ s_wr,
    __nv_bfloat16* __restrict__ y, float* __restrict__ ws,
    int* __restrict__ counters, int M, int N, int K, int group, int ks,
    int m_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kTT = 4;                 // token tiles of 8 per warp
  constexpr int kThreads = kWideThreads;
  __shared__ float red[kThreads / 32];
  const Split sp = block_split(m_tiles, kWideBM, kWideBN, ks, K);
  const int n_chunks = (sp.k_end - sp.k_begin) / kChunk;
  const int pair0 = sp.k_begin / 2;
  const float* rs = reinterpret_cast<const float*>(xh + static_cast<size_t>(M) * K);

  // each thread's copies, addressed once: 2 of W (8 a 128-byte row of 32
  // packed rows), 4 of x (8 a 128-byte row of 64 tokens); a chunk moves
  // the sources by 32 packed rows and 64 columns of x
  const uint32_t smem0 = smem_u32(smem);
  const uint8_t* w_src[2];
  uint32_t w_dst[2];
  bool w_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int idx = threadIdx.x + kThreads * r;
    const int p = idx >> 3;
    const int j = idx & 7;
    w_ok[r] = sp.n0 + 16 * j < N;
    w_src[r] = qw + static_cast<size_t>(pair0 + p) * N + sp.n0 + 16 * j;
    w_dst[r] = wide_off(p, 2 * j);
  }
  const __half* x_src[4];
  uint32_t x_dst[4];
  bool x_ok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int idx = threadIdx.x + kThreads * r;
    const int row = idx >> 3;
    const int q = idx & 7;
    x_ok[r] = sp.m0 + row < M;
    x_src[r] = xh + static_cast<size_t>(x_ok[r] ? sp.m0 + row : 0) * K +
               sp.k_begin + 8 * q;
    x_dst[r] = kWideWBytes + row * 128 + ((q ^ (row & 7)) << 4);
  }
  const size_t w_step = static_cast<size_t>(kPairs) * N;
  auto load = [&](int c) {
    const uint32_t base = smem0 + (c % kWideStages) * kWideStage;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (w_ok[r]) cp_async16(base + w_dst[r], w_src[r] + c * w_step);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      cp_async16_zfill(base + x_dst[r], x_src[r] + c * kChunk, x_ok[r]);
  };

#pragma unroll
  for (int c = 0; c < kWideStages - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_commit();
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wn = warp & 1;
  const int wm = warp >> 1;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int nw = sp.n0 + 64 * wn + 8 * g;
  const bool live = sp.n0 + 64 * wn < N;
  // ldmatrix rows: matrix lane >> 3 = (token half, k half); the A reads'
  // offset in a stage (rows 8s + tq and + 4 add 1024 s and 512)
  const int lrow = 8 * kTT * wm + ((lane >> 4) << 3) + (lane & 7);
  const int lk = (lane >> 3) & 1;
  const int a_off = wide_off(tq, 8 * wn + g);

  float wscale = 1.f;                   // dequant: 2^-E, then 2^E
  if (kDequant) {
    float mwl = 0.f, mwr = 0.f;
    for (int k = sp.k_begin + threadIdx.x; k < sp.k_end; k += blockDim.x)
      mwl = fmaxf(mwl, fabsf(s_wl[k]));
    const int g0 = sp.k_begin / group, g1 = (sp.k_end - 1) / group;
    const int cols = min(kWideBN, N - sp.n0);
    for (int i = threadIdx.x; i < (g1 - g0 + 1) * cols; i += blockDim.x)
      mwr = fmaxf(mwr, fabsf(s_wr[static_cast<size_t>(g0 + i / cols) * N +
                                  sp.n0 + i % cols]));
    mwl = block_max(mwl, red);
    mwr = block_max(mwr, red);
    wscale = ldexpf(1.f, fp16_exponent(8.f * mwl * mwr));
  }

  float part[kTT][4][4];
  float acc[kTT][4][4];
#pragma unroll
  for (int t = 0; t < kTT; ++t)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) { part[t][a][e] = 0.f; acc[t][a][e] = 0.f; }
  // a chunk lies in one group when groups are 64 rows or more: its s_wr
  // row (and the dequant's s_wl) are loaded before the wait on its tiles
  const bool chunk_group = group >= kChunk;
  float sr[8] = {};
  int sr_group = -1;
  GroupPos gp(sp.k_begin, group);       // the group of each k16 step

  for (int c = 0; c < n_chunks; ++c) {
    const int kc = sp.k_begin + c * kChunk;
    float2 wl[4][2];
    if (live && (kDequant || kTwoAcc) && chunk_group && gp.g != sr_group) {
      sr_group = gp.g;
      load8(s_wr + static_cast<size_t>(sr_group) * N + nw, sr);
    }
    if (kDequant && live) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        wl[s][0] = *reinterpret_cast<const float2*>(s_wl + kc + 16 * s + 2 * tq);
        wl[s][1] =
            *reinterpret_cast<const float2*>(s_wl + kc + 16 * s + 8 + 2 * tq);
      }
    }
    cp_wait<kWideStages - 2>();
    __syncthreads();
    if (c + kWideStages - 1 < n_chunks) load(c + kWideStages - 1);
    cp_commit();
    const uint8_t* w = smem + (c % kWideStages) * kWideStage;
    const uint32_t xt = smem0 + (c % kWideStages) * kWideStage + kWideWBytes;
    if (!live) continue;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint2 wa =
          *reinterpret_cast<const uint2*>(w + a_off + 1024 * s);
      const uint2 wb =
          *reinterpret_cast<const uint2*>(w + a_off + 1024 * s + 512);
      if ((kDequant || kTwoAcc) && !chunk_group && gp.g != sr_group) {
        sr_group = gp.g;
        load8(s_wr + static_cast<size_t>(sr_group) * N + nw, sr);
      }
      uint32_t A[4][4];
      {
        float2 la = make_float2(0.f, 0.f), lb = la;
        if (kDequant) {
          la = wl[s][0];
          lb = wl[s][1];
        }
        uint32_t ra[4], rb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          unpack4_f16(i ? wa.y : wa.x, ra);
          unpack4_f16(i ? wb.y : wb.x, rb);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t(&a)[4] = A[2 * i + h];
            a[0] = ra[2 * h];
            a[1] = ra[2 * h + 1];
            a[2] = rb[2 * h];
            a[3] = rb[2 * h + 1];
            if (kDequant) {
              const float c0 = sr[4 * i + 2 * h] * wscale;
              const float c1 = sr[4 * i + 2 * h + 1] * wscale;
              const float2 l[4] = {la, la, lb, lb};
              const float cc[4] = {c0, c1, c0, c1};
#pragma unroll
              for (int f = 0; f < 4; ++f) {
                const float2 q = f16x2_to_float2(a[f]);
                a[f] = pack_f16(__fmul_rn(__fmul_rn(q.x, l[f].x), cc[f]),
                                __fmul_rn(__fmul_rn(q.y, l[f].y), cc[f]));
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kTT / 2; ++q) {  // token tiles 2q, 2q + 1
        const int row = lrow + 16 * q;
        uint32_t b[4];
        ldmatrix_x4(b, xt + row * 128 + (((2 * s + lk) ^ (row & 7)) << 4));
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          if (kDequant) {
            mma_f16(acc[2 * q][a], A[a], b[0], b[1]);
            mma_f16(acc[2 * q + 1][a], A[a], b[2], b[3]);
          } else {
            mma_f16(part[2 * q][a], A[a], b[0], b[1]);
            mma_f16(part[2 * q + 1][a], A[a], b[2], b[3]);
          }
        }
      }
      if (!kDequant && kTwoAcc &&
          ((c == n_chunks - 1 && s == 3) || gp.ends(16))) {
#pragma unroll
        for (int t = 0; t < kTT; ++t)
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[t][a][e] += part[t][a][e] * sr[2 * a + (e >> 1)];
              part[t][a][e] = 0.f;
            }
      }
      gp.advance(16);
    }
  }
  if (!kDequant && !kTwoAcc && live) {
    float sc[8];
    load8(s_wr + static_cast<size_t>(sp.k_begin / group) * N + nw, sc);
#pragma unroll
    for (int t = 0; t < kTT; ++t)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][a][e] = part[t][a][e] * sc[2 * a + (e >> 1)];
  }
  cp_wait<0>();
  __syncthreads();

  // undo the row scales (and the dequant's 2^-E): powers of two, exact
  const float back = kDequant ? 1.f / wscale : 1.f;
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < kTT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * kTT * wm + 8 * t + 2 * tq + e;
      const float f = sp.m0 + r < M ? rs[sp.m0 + r] * back : 0.f;
      float* row = tile + r * kWideLd + 64 * wn + 8 * g;
      *reinterpret_cast<float4*>(row) = make_float4(
          f * acc[t][0][e], f * acc[t][0][2 + e], f * acc[t][1][e],
          f * acc[t][1][2 + e]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(
          f * acc[t][2][e], f * acc[t][2][2 + e], f * acc[t][3][e],
          f * acc[t][3][2 + e]);
    }
  __syncthreads();
  block_store(tile, kWideLd, 0, 1, kWideBM, kWideBN, sp.m0, sp.n0, M, N, y,
              ws, counters + blockIdx.x, sp.split, gridDim.y);
}

// ---------------------------------------------------------------------------
// Body `fma`: f32, CUDA-core FMAs
// ---------------------------------------------------------------------------

template <bool kDequant, bool kTwoAcc>
__global__ void __launch_bounds__(128) qmm_fma_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ qw,
    const float* __restrict__ s_wl, const float* __restrict__ s_wr,
    float* __restrict__ y, float* __restrict__ ws, int* __restrict__ counters,
    int M, int N, int K, int group, int ks, int m_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int BM = 8;
  uint8_t* ring = smem;
  float* xk = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  const Split sp = block_split(m_tiles, BM, kBN, ks, K);
  const int klen = sp.k_end - sp.k_begin;
  const int n_chunks = klen / kChunk;
  const int pair0 = sp.k_begin / 2;

  const W64Copy<false> wcopy(qw, N, pair0, sp.n0, smem_u32(ring));
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) wcopy.issue(c);
    cp_commit();
  }
  // x (times s_wl for int8dot) k-major: xk[k][token]
  for (int i = threadIdx.x; i < BM * klen; i += blockDim.x) {
    const int r = i / klen;
    const int k = i % klen;
    const int m = sp.m0 + r;
    float v = 0.f;
    if (m < M) {
      v = x[static_cast<size_t>(m) * K + sp.k_begin + k];
      if (!kDequant) v *= s_wl[sp.k_begin + k];
    }
    xk[k * BM + r] = v;
  }

  const int n_loc = threadIdx.x & 63;
  const int half = threadIdx.x >> 6;
  const int n = sp.n0 + n_loc;
  float part[BM], acc[BM];
#pragma unroll
  for (int t = 0; t < BM; ++t) { part[t] = 0.f; acc[t] = 0.f; }
  float sr = 0.f;                       // s_wr of the current group
  int sr_group = -1;
  GroupPos gp(sp.k_begin + 32 * half, group);   // this thread's steps

  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < n_chunks) wcopy.issue(c + kStages - 1);
    cp_commit();
    const uint8_t* st = ring + (c % kStages) * kStageBytes;
#pragma unroll
    for (int s = 0; s < 2; ++s) {       // two 16-row steps of this half
      const int kloc = c * kChunk + 32 * half + 16 * s;
      const int k = sp.k_begin + kloc;
      // this thread's next step is 16 rows on, or the next chunk's
      const int next = s == 0 ? 16 : kChunk - 16;
      if ((kDequant || kTwoAcc) && gp.g != sr_group) {
        sr_group = gp.g;
        sr = s_wr[static_cast<size_t>(sr_group) * N + n];
      }
#pragma unroll
      for (int pp = 0; pp < 8; ++pp) {
        const int p = 16 * half + 8 * s + pp;
        const uint32_t b = st[stage_off(p, n_loc)];
        const float q0 = nibble(b), q1 = nibble(b >> 4);
        const float4* x0 = reinterpret_cast<const float4*>(
            xk + (kloc + 2 * pp) * BM);
        const float4 u0 = x0[0], v0 = x0[1], u1 = x0[2], v1 = x0[3];
        const float a0[BM] = {u0.x, u0.y, u0.z, u0.w, v0.x, v0.y, v0.z, v0.w};
        const float a1[BM] = {u1.x, u1.y, u1.z, u1.w, v1.x, v1.y, v1.z, v1.w};
        if (kDequant) {
          const float2 wl = *reinterpret_cast<const float2*>(
              s_wl + k + 2 * pp);
          const float w0 = __fmul_rn(__fmul_rn(q0, wl.x), sr);
          const float w1 = __fmul_rn(__fmul_rn(q1, wl.y), sr);
#pragma unroll
          for (int t = 0; t < BM; ++t)
            acc[t] = fmaf(a1[t], w1, fmaf(a0[t], w0, acc[t]));
        } else {
#pragma unroll
          for (int t = 0; t < BM; ++t)
            part[t] = fmaf(a1[t], q1, fmaf(a0[t], q0, part[t]));
        }
      }
      if (!kDequant && kTwoAcc &&
          ((c == n_chunks - 1 && s == 1) || gp.ends(next))) {
#pragma unroll
        for (int t = 0; t < BM; ++t) {
          acc[t] += part[t] * sr;
          part[t] = 0.f;
        }
      }
      gp.advance(next);
    }
  }
  if (!kDequant && !kTwoAcc) {
    const float scale = s_wr[static_cast<size_t>(sp.k_begin / group) * N + n];
#pragma unroll
    for (int t = 0; t < BM; ++t) acc[t] = part[t] * scale;
  }
  cp_wait<0>();
  __syncthreads();
  float* tiles = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < BM; ++t)
    tiles[half * BM * kTileLd + t * kTileLd + n_loc] = acc[t];
  __syncthreads();
  block_store(tiles, kTileLd, BM * kTileLd, 2, BM, kBN, sp.m0, sp.n0, M, N, y,
              ws, counters + blockIdx.x, sp.split, gridDim.y);
}

// ---------------------------------------------------------------------------
// The int8 entry: unpacked int8 weights through the fma body's pipeline
// ---------------------------------------------------------------------------

constexpr int kI8Stages = 4;
constexpr int kI8StageBytes = kChunk * kBN;     // 64 rows x 64 int8 columns

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One thread's share of each 64-row chunk of q (rows p and p + 32, 16
// columns at 16 j; 128 threads): 16-byte cp.async copies where N allows
// them (zero-filled past N and past the split), byte loads elsewhere.
// Chunk c goes to stage c mod kI8Stages, row r at byte 64 r.  kPacked:
// q is nibble-packed [K/2, N], a chunk 32 packed rows (row p only).
template <bool kPacked>
struct I8Copy {
  const int8_t* q;
  uint8_t* ring;
  int N, k_begin, k_end, col, p, j16;
  bool vec;
  __device__ I8Copy(const int8_t* q_, uint8_t* ring_, int N_, int k_begin_,
                    int k_end_, int n0, bool vec_)
      : q(q_), ring(ring_), N(N_), k_begin(k_begin_), k_end(k_end_),
        col(n0 + 16 * (threadIdx.x & 3)), p(threadIdx.x >> 2),
        j16(16 * (threadIdx.x & 3)), vec(vec_) {}
  __device__ void issue(int c) const {
#pragma unroll
    for (int h = 0; h < (kPacked ? 1 : 2); ++h) {
      const int r = p + 32 * h;
      // the stage row's first K-row, and its row of q
      const int k = k_begin + c * kChunk + (kPacked ? 2 * r : r);
      const int qrow = kPacked ? k / 2 : k;
      uint8_t* dst = ring + (c % kI8Stages) * kI8StageBytes + r * kBN + j16;
      const bool row_ok = k < k_end;
      if (vec) {
        const bool ok = row_ok && col < N;
        const int8_t* src = ok ? q + static_cast<size_t>(qrow) * N + col : q;
        cp_async16_zfill(smem_u32(dst), src, ok);
      } else {
        const int8_t* src = q + static_cast<size_t>(row_ok ? qrow : 0) * N;
#pragma unroll
        for (int b = 0; b < 16; ++b)
          dst[b] = row_ok && col + b < N
                       ? static_cast<uint8_t>(src[col + b]) : 0;
      }
    }
  }
};

// kPacked: q is the int4 entry's nibble-packed [K/2, N] (K even), for the
// shapes its bodies do not tile; the nibbles are read in place.
template <typename XT, bool kTwoAcc, bool kPacked>
__global__ void __launch_bounds__(128) qmm_i8_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s_wl, const float* __restrict__ s_wr,
    XT* __restrict__ y, float* __restrict__ ws, int* __restrict__ counters,
    int M, int N, int K, int group, int ks, bool vec, int m_tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int BM = 8;
  uint8_t* ring = smem;
  float* xk = reinterpret_cast<float*>(smem + kI8Stages * kI8StageBytes);
  const Split sp = block_split(m_tiles, BM, kBN, ks, K);
  const int klen = sp.k_end - sp.k_begin;
  const int n_chunks = (klen + kChunk - 1) / kChunk;

  const I8Copy<kPacked> wcopy(q, ring, N, sp.k_begin, sp.k_end, sp.n0,
                              vec);
#pragma unroll
  for (int c = 0; c < kI8Stages - 1; ++c) {
    if (c < n_chunks) wcopy.issue(c);
    cp_commit();
  }
  // x * s_wl in f32, k-major: xk[k][token]; rows past the split are zero
  const int kpad = n_chunks * kChunk;
  for (int i = threadIdx.x; i < BM * kpad; i += blockDim.x) {
    const int r = i / kpad;
    const int k = i % kpad;
    const int m = sp.m0 + r;
    float v = 0.f;
    if (m < M && k < klen)
      v = widen(x[static_cast<size_t>(m) * K + sp.k_begin + k]) *
          s_wl[sp.k_begin + k];
    xk[k * BM + r] = v;
  }

  const int n_loc = threadIdx.x & 63;
  const int half = threadIdx.x >> 6;
  const int n = sp.n0 + n_loc;
  const bool live = n < N;
  float part[BM], acc[BM];
#pragma unroll
  for (int t = 0; t < BM; ++t) { part[t] = 0.f; acc[t] = 0.f; }
  float sr = 0.f;                       // s_wr of the current group
  int sr_group = -1;
  GroupPos gp(sp.k_begin + 32 * half, group);   // this thread's next row

  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<kI8Stages - 2>();
    __syncthreads();
    if (c + kI8Stages - 1 < n_chunks) wcopy.issue(c + kI8Stages - 1);
    cp_commit();
    const uint8_t* st = ring + (c % kI8Stages) * kI8StageBytes;
    const int rows = min(32, klen - (c * kChunk + 32 * half));
    for (int rr = 0; rr < rows; ++rr) {
      const int kloc = c * kChunk + 32 * half + rr;
      if (kTwoAcc && gp.g != sr_group) {   // the row opens a new group
        if (sr_group >= 0) {
#pragma unroll
          for (int t = 0; t < BM; ++t) {
            acc[t] += part[t] * sr;
            part[t] = 0.f;
          }
        }
        sr_group = gp.g;
        sr = live ? s_wr[static_cast<size_t>(sr_group) * N + n] : 0.f;
      }
      const int sr_row = 32 * half + rr;          // the row in the chunk
      float qv;
      if (kPacked) {                              // row 2i low, 2i+1 high
        const uint32_t b = st[(sr_row >> 1) * kBN + n_loc];
        qv = nibble(sr_row & 1 ? b >> 4 : b);
      } else {
        qv = static_cast<float>(static_cast<int8_t>(st[sr_row * kBN + n_loc]));
      }
      const float4* xr = reinterpret_cast<const float4*>(xk + kloc * BM);
      const float4 u = xr[0], v = xr[1];
      const float a[BM] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int t = 0; t < BM; ++t) part[t] = fmaf(a[t], qv, part[t]);
      gp.advance(1);
    }
    gp.advance(32);                     // the other half's rows
  }
  if (kTwoAcc) {
    if (sr_group >= 0) {
#pragma unroll
      for (int t = 0; t < BM; ++t) acc[t] += part[t] * sr;
    }
  } else {                              // one group: the channel layout
    const float scale = live ? s_wr[n] : 0.f;
#pragma unroll
    for (int t = 0; t < BM; ++t) acc[t] = part[t] * scale;
  }
  cp_wait<0>();
  __syncthreads();
  float* tiles = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int t = 0; t < BM; ++t)
    tiles[half * BM * kTileLd + t * kTileLd + n_loc] = acc[t];
  __syncthreads();
  block_store(tiles, kTileLd, BM * kTileLd, 2, BM, kBN, sp.m0, sp.n0, M, N, y,
              ws, counters + blockIdx.x, sp.split, gridDim.y);
}

// ---------------------------------------------------------------------------
// Host side: the gate, the plan's checks and the launches
// ---------------------------------------------------------------------------

bool shape_ok(int M, int N, int K, int group) {
  const bool group_ok = group >= 16 && group % 16 == 0 && K % group == 0 &&
                        (group % kChunk == 0 || kChunk % group == 0);
  return M >= 1 && N >= kBN && N % kBN == 0 && K >= kChunk &&
         K % kChunk == 0 && group_ok;
}

// A split lies in one group, or is a union of whole groups.
bool nests(int ks, int group, int K) {
  return group >= K || ks % group == 0 || group % ks == 0;
}

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

// Launches one instantiation, raising its dynamic shared-memory limit the
// first time a launch needs more than the default 48 KB (per device).
template <auto kKernel, typename... Args>
cudaError_t go(int m_tiles, int n_tiles, int splits, int threads, int smem,
               cudaStream_t st, Args... args) {
  static int granted[64] = {};
  if (static_cast<long long>(m_tiles) * n_tiles > 0x7fffffffLL ||
      splits > 65535)
    return cudaErrorInvalidValue;
  if (smem > 32 * 1024) {              // the static s_last counts too
    int dev = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc != cudaSuccess) return rc;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (granted[dev] < smem) {
      rc = cudaFuncSetAttribute(
          kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != cudaSuccess) return rc;
      granted[dev] = smem;
    }
  }
  kKernel<<<dim3(m_tiles * n_tiles, splits), threads, smem, st>>>(
      args..., m_tiles);
  return cudaGetLastError();
}

template <bool kDequant, bool kTwoAcc>
cudaError_t launch_body(int body, const void* x, const uint8_t* qw,
                        const float* wl, const float* wr, void* y, float* ws,
                        void* xs, int* cnt, int M, int N, int K, int group,
                        int ks, int splits, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  const bf16* xb = static_cast<const bf16*>(x);
  bf16* yb = static_cast<bf16*>(y);
  if (body == kFma) {
    const int smem = kStages * kStageBytes + 8 * ks * 4;
    return go<qmm_fma_kernel<kDequant, kTwoAcc>>(
        cdiv(M, 8), N / kBN, splits, 128, smem, st,
        static_cast<const float*>(x), qw, wl, wr, static_cast<float*>(y), ws,
        cnt, M, N, K, group, ks);
  }
  if (body == kMma) {
    const int mt = M <= 8 ? 1 : 2;
    const int ring = kStages * kStageBytes +
                     (kDequant ? 1 : 2) * 8 * mt * (ks + 8) * 2;
    const int tiles = 4 * 8 * mt * kTileLd * 4;
    const int smem = ring > tiles ? ring : tiles;
    if (mt == 1)
      return go<qmm_mma_kernel<1, kDequant, kTwoAcc>>(
          1, N / kBN, splits, 128, smem, st, xb, qw, wl, wr, yb, ws, cnt, M,
          N, K, group, ks);
    return go<qmm_mma_kernel<2, kDequant, kTwoAcc>>(
        1, N / kBN, splits, 128, smem, st, xb, qw, wl, wr, yb, ws, cnt, M, N,
        K, group, ks);
  }
  // x (times s_wl for int8dot) as row-scaled fp16 [M, K], then rs [M]
  __half* xh = static_cast<__half*>(xs);
  float* rs = reinterpret_cast<float*>(xh + static_cast<size_t>(M) * K);
  if (kDequant)
    qmm_rows_f16_kernel<false><<<M, 256, 0, st>>>(xb, wl, xh, rs, K);
  else
    qmm_rows_f16_kernel<true><<<M, 256, 0, st>>>(xb, wl, xh, rs, K);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  return go<qmm_mma_wide_kernel<kDequant, kTwoAcc>>(
      cdiv(M, kWideBM), cdiv(N, kWideBN), splits, kWideThreads, kWideSmem, st,
      static_cast<const __half*>(xh), qw, wl, wr, yb, ws, cnt, M, N, K, group,
      ks);
}

// Checks the shape and the plan, then launches.  body: 0 fma (f32 x),
// 1 mma (bf16 x, M <= 16), 2 mma_wide (bf16 x); ks: K-rows per split, a
// multiple of 64 that nests with the group; ws: f32 [ceil(K/ks), M, N] and
// counters: int32, one per output tile, zero (each launch leaves them
// zero), both needed only when there is more than one split; xs: for the
// mma_wide body, fp16 [M, K] then f32 [M] (the row-scaled x and its scales).
int launch(bool dequant, const void* x, const void* qw, const void* s_wl,
           const void* s_wr, void* y, int M, int N, int K, int group,
           int x_dtype, int body, int ks, void* ws, void* xs, void* counters,
           void* stream) {
  if (!shape_ok(M, N, K, group) || ks < kChunk || ks % kChunk ||
      !nests(ks, group, K))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool dtype_ok = body == kFma ? x_dtype == kF32
                      : (body == kMma || body == kMmaWide) && x_dtype == kBF16;
  if (!dtype_ok || (body == kMma && M > 16) ||
      (body == kFma && 8LL * ks * 4 + kStages * kStageBytes > 200 * 1024) ||
      (body == kMma && 64LL * (ks + 8) + kStages * kStageBytes > 200 * 1024))
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = cdiv(K, ks);
  if (splits > 1 && (ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == kMmaWide && xs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool two_acc = !(group >= K || group % ks == 0);
  const auto* q = static_cast<const uint8_t*>(qw);
  const auto* wl = static_cast<const float*>(s_wl);
  const auto* wr = static_cast<const float*>(s_wr);
  auto* w = static_cast<float*>(ws);
  auto* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (dequant)
    rc = launch_body<true, false>(body, x, q, wl, wr, y, w, xs, cnt, M, N, K,
                                  group, ks, splits, st);
  else if (two_acc)
    rc = launch_body<false, true>(body, x, q, wl, wr, y, w, xs, cnt, M, N, K,
                                  group, ks, splits, st);
  else
    rc = launch_body<false, false>(body, x, q, wl, wr, y, w, xs, cnt, M, N,
                                   K, group, ks, splits, st);
  return static_cast<int>(rc);
}

// The int8 entry's mma body: the checks of `launch` for body 1, and a
// 16-byte aligned q.
int launch_i8_mma(const void* x, const void* q, const void* s_wl,
                  const void* s_wr, void* y, int M, int N, int K, int group,
                  int x_dtype, int ks, void* ws, void* counters,
                  cudaStream_t st) {
  constexpr int kRing = kStages * W64Copy<true>::kBytes;
  if (!shape_ok(M, N, K, group) || ks < kChunk || ks % kChunk ||
      !nests(ks, group, K) || x_dtype != kBF16 || M > 16 ||
      reinterpret_cast<uintptr_t>(q) % 16 ||
      64LL * (ks + 8) + kRing > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = cdiv(K, ks);
  if (splits > 1 && (ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using bf16 = __nv_bfloat16;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* wl = static_cast<const float*>(s_wl);
  const auto* wr = static_cast<const float*>(s_wr);
  auto* yb = static_cast<bf16*>(y);
  auto* w = static_cast<float*>(ws);
  auto* cnt = static_cast<int*>(counters);
  const bool two_acc = !(group >= K || group % ks == 0);
  const int mt = M <= 8 ? 1 : 2;
  const int ring = kRing + 2 * 8 * mt * (ks + 8) * 2;
  const int tiles = 4 * 8 * mt * kTileLd * 4;
  const int smem = ring > tiles ? ring : tiles;
  cudaError_t rc;
  if (mt == 1)
    rc = two_acc ? go<qmm_mma_kernel<1, false, true, true>>(
                       1, N / kBN, splits, 128, smem, st, xb, qb, wl, wr, yb,
                       w, cnt, M, N, K, group, ks)
                 : go<qmm_mma_kernel<1, false, false, true>>(
                       1, N / kBN, splits, 128, smem, st, xb, qb, wl, wr, yb,
                       w, cnt, M, N, K, group, ks);
  else
    rc = two_acc ? go<qmm_mma_kernel<2, false, true, true>>(
                       1, N / kBN, splits, 128, smem, st, xb, qb, wl, wr, yb,
                       w, cnt, M, N, K, group, ks)
                 : go<qmm_mma_kernel<2, false, false, true>>(
                       1, N / kBN, splits, 128, smem, st, xb, qb, wl, wr, yb,
                       w, cnt, M, N, K, group, ks);
  return static_cast<int>(rc);
}

// One instantiation of the int8 entry's fma body.
template <typename XT, bool kPacked>
cudaError_t go_i8(bool two_acc, int mt, int nt, int splits, int smem,
                  cudaStream_t st, const void* x, const int8_t* q,
                  const float* wl, const float* wr, void* y, float* w,
                  int* cnt, int M, int N, int K, int group, int ks, bool vec) {
  const XT* xx = static_cast<const XT*>(x);
  XT* yy = static_cast<XT*>(y);
  return two_acc
      ? go<qmm_i8_kernel<XT, true, kPacked>>(mt, nt, splits, 128, smem, st,
                                             xx, q, wl, wr, yy, w, cnt, M, N,
                                             K, group, ks, vec)
      : go<qmm_i8_kernel<XT, false, kPacked>>(mt, nt, splits, 128, smem, st,
                                              xx, q, wl, wr, yy, w, cnt, M,
                                              N, K, group, ks, vec);
}

// The int8 entry.  body 1 (mma): bf16 x, M <= 16 and a shape `launch`
// takes, ks nesting with the group.  body 0 (fma): any M, N, K >= 1 and a
// group that divides K; ks: rows per split, a multiple of 64.  packed: q is
// nibble-packed [K/2, N] (fma only, K even).  ws and counters as `launch`
// above.
int launch_i8(const void* x, const void* q, const void* s_wl,
              const void* s_wr, void* y, int M, int N, int K, int group,
              int x_dtype, int body, int packed, int ks, void* ws,
              void* counters, void* stream) {
  if (body == kMma && !packed)
    return launch_i8_mma(x, q, s_wl, s_wr, y, M, N, K, group, x_dtype, ks,
                         ws, counters, static_cast<cudaStream_t>(stream));
  if (body != kFma || M < 1 || N < 1 || K < 1 || group < 1 || K % group ||
      ks < kChunk || ks % kChunk || (x_dtype != kF32 && x_dtype != kBF16) ||
      (packed && K % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kI8Stages * kI8StageBytes + 8 * ks * 4;
  if (smem > 200 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int splits = cdiv(K, ks);
  if (splits > 1 && (ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool two_acc = group < K;
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* wl = static_cast<const float*>(s_wl);
  const auto* wr = static_cast<const float*>(s_wr);
  auto* w = static_cast<float*>(ws);
  auto* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = cdiv(M, 8), nt = cdiv(N, kBN);
  using bf16 = __nv_bfloat16;
  cudaError_t rc;
  if (x_dtype == kF32)
    rc = packed ? go_i8<float, true>(two_acc, mt, nt, splits, smem, st, x,
                                     qi, wl, wr, y, w, cnt, M, N, K, group,
                                     ks, vec)
                : go_i8<float, false>(two_acc, mt, nt, splits, smem, st, x,
                                      qi, wl, wr, y, w, cnt, M, N, K, group,
                                      ks, vec);
  else
    rc = packed ? go_i8<bf16, true>(two_acc, mt, nt, splits, smem, st, x, qi,
                                    wl, wr, y, w, cnt, M, N, K, group, ks,
                                    vec)
                : go_i8<bf16, false>(two_acc, mt, nt, splits, smem, st, x,
                                     qi, wl, wr, y, w, cnt, M, N, K, group,
                                     ks, vec);
  return static_cast<int>(rc);
}

}  // namespace

// Both return a cudaError_t: 0 on a clean launch.  x_dtype: 0 f32, 1 bf16;
// the plan's arguments (body, ks, ws, xs, counters) as `launch` above.
extern "C" int qft_quant_matmul(const void* x, const void* qw,
                                const void* s_wl, const void* s_wr, void* y,
                                int M, int N, int K, int group, int x_dtype,
                                int body, int ks, void* ws, void* xs,
                                void* counters, void* stream) {
  return launch(false, x, qw, s_wl, s_wr, y, M, N, K, group, x_dtype, body,
                ks, ws, xs, counters, stream);
}

extern "C" int qft_quant_matmul_dequant(const void* x, const void* qw,
                                        const void* s_wl, const void* s_wr,
                                        void* y, int M, int N, int K,
                                        int group, int x_dtype, int body,
                                        int ks, void* ws, void* xs,
                                        void* counters, void* stream) {
  return launch(true, x, qw, s_wl, s_wr, y, M, N, K, group, x_dtype, body,
                ks, ws, xs, counters, stream);
}

// y = sum_g s_wr[g] * ((x * s_wl)[:, g] @ q[g]) for int8 q [K, N] (packed
// 1: q nibble-packed [K/2, N], the int4 entry's layout); x_dtype 0 f32,
// 1 bf16; body 0 fma, 1 mma; ks, ws and counters from the wrapper's
// plan_int8.
extern "C" int qft_quant_matmul_i8(const void* x, const void* q,
                                   const void* s_wl, const void* s_wr,
                                   void* y, int M, int N, int K, int group,
                                   int x_dtype, int body, int packed, int ks,
                                   void* ws, void* counters, void* stream) {
  return launch_i8(x, q, s_wl, s_wr, y, M, N, K, group, x_dtype, body,
                   packed, ks, ws, counters, stream);
}
