// Tile pieces shared by the ViT attention kernels (attention_fwd.cu,
// attention_bwd.cu): float32 products in 3xTF32 on the tensor cores, and
// cp.async tile copies from device memory into shared memory.
//
// 3xTF32.  The tensor cores take float32 operands as TF32 (8 exponent bits,
// 10 mantissa bits).  Each float32 operand x is split into a high part
// hi = tf32(x), rounded to nearest with ties away from zero (the rounding of
// cvt.rna.tf32.f32), and a low part lo = x - hi, which the tensor core reads
// as TF32; then
//   a * b ~= a_hi * b_lo + a_lo * b_hi + a_hi * b_hi
// (CUTLASS's OpMultiplyAddFastF32).  The dropped a_lo * b_lo term and the
// TF32 reading of lo leave an error near float32's own (about 2^-21 of
// |a||b|, against one TF32 pass's 2^-11).  Each product of two TF32 values
// is exact in float32 and the accumulator is float32.  The two small cross
// terms go in first, as CUTLASS orders them, so that they are not rounded
// away against the large term.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 for lane
// = 4 * g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A C tile feeds the next product as its A operand without shuffles when
// that product's k index is permuted: A column t stands for k = 2t and
// column t + 4 for k = 2t + 1, so a = {c0, c2, c1, c3}, and the B operand
// reads rows 2t and 2t + 1 of its 8-row k block (see b_frag_perm).
//
// Shared-memory tiles are row-major with a row stride of kDp + 4 floats
// (kDp a multiple of 16), which makes every fragment load below free of
// bank conflicts, and keeps rows 16-byte aligned for cp.async.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace tf32 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// x = hi + lo.  hi is x rounded to TF32, to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32, done by two integer operations on
// the bits, because the conversion instruction issues on the SM's narrow
// conversion pipe and the kernels split every operand they load (with it
// the forward kernel ran markedly slower on the H100).  lo = x - hi is
// exact in float32; the tensor core reads its top 19 bits (TF32) and drops
// the rest, as CUTLASS's fast-F32 operator leaves its small part.  A NaN x
// gives a NaN lo, so NaN still reaches the product.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct AFrag {
  uint32_t hi[4], lo[4];
};
struct BFrag {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ AFrag a_frag(float a0, float a1, float a2, float a3) {
  AFrag f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ BFrag b_frag(float b0, float b1) {
  BFrag f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// A fragment of the 16 x 8 block at (row r0, column c0) of a row-major tile
__device__ __forceinline__ AFrag a_frag_rows(const float* s, int ld, int r0, int c0, int g,
                                             int t) {
  const float* p = s + (r0 + g) * ld + c0 + t;
  return a_frag(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
}

// A fragment {c0, c2, c1, c3} of a C tile, for a product whose k index is
// permuted as the header says
__device__ __forceinline__ AFrag a_frag_perm(const float (&c)[4]) {
  return a_frag(c[0], c[2], c[1], c[3]);
}

// B fragment with B[k][n] = tile[n0 + n][k0 + k]: the tile holds B^T
// row-major (keys x dims for Q K^T)
__device__ __forceinline__ BFrag b_frag_t(const float* s, int ld, int n0, int k0, int g,
                                          int t) {
  const float* p = s + (n0 + g) * ld + k0 + t;
  return b_frag(p[0], p[4]);
}

// B fragment with B[k][n] = tile[k0 + perm(k)][n0 + n], perm(t) = 2t and
// perm(t + 4) = 2t + 1: the tile holds B row-major (keys x dims for P V)
__device__ __forceinline__ BFrag b_frag_perm(const float* s, int ld, int k0, int n0, int g,
                                             int t) {
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  return b_frag(p[0], p[ld]);
}

// b[j] = b_frag_t(tile, ld, 8 j, k0) for the first `live` j: B^T's rows
// n in 8-row groups
template <int N>
__device__ __forceinline__ void b_frags_t(BFrag (&b)[N], const float* s, int ld, int k0, int g,
                                          int t, int live) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) b[j] = b_frag_t(s, ld, 8 * j, k0, g, t);
}

// b[c] = b_frag_perm(tile, ld, k0, 8 c): B's columns in 8-wide groups
template <int N>
__device__ __forceinline__ void b_frags_perm(BFrag (&b)[N], const float* s, int ld, int k0,
                                             int g, int t) {
#pragma unroll
  for (int c = 0; c < N; ++c) b[c] = b_frag_perm(s, ld, k0, 8 * c, g, t);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a * b[j] for the first `live` of N tiles in 3xTF32, the cross
// terms first; neighbouring instructions write different accumulators
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N][4], const AFrag& a, const BFrag (&b)[N],
                                     int live) {
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma(d[j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma(d[j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < live) mma(d[j], a.hi, b[j].hi);
}

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of the block src[r0 + r][c0 + c], r < rows, c < kCols, of
// a row-major float32 matrix with n_rows rows, n_cols columns and row
// stride ld_src into dst[r * kLdDst + c]; elements past n_rows or n_cols
// arrive as zeros (a copy of 0 source bytes zero-fills).  16-byte copies
// when ld_src and n_cols are multiples of 4 (c0 is one), else 4-byte ones.
template <int kCols, int kLdDst>
__device__ __forceinline__ void load_block_async(float* dst, const float* src, int ld_src,
                                                 int r0, int c0, int rows, int n_rows,
                                                 int n_cols, int tid, int nthreads) {
  if (ld_src % 4 == 0 && n_cols % 4 == 0) {
    constexpr int kChunks = kCols / 4;
    for (int i = tid; i < rows * kChunks; i += nthreads) {
      const int r = i / kChunks, c = (i % kChunks) * 4;
      const bool live = r0 + r < n_rows && c0 + c < n_cols;
      cp_async16(dst + r * kLdDst + c,
                 live ? src + static_cast<size_t>(r0 + r) * ld_src + c0 + c : src, live);
    }
  } else {
    for (int i = tid; i < rows * kCols; i += nthreads) {
      const int r = i / kCols, c = i % kCols;
      const bool live = r0 + r < n_rows && c0 + c < n_cols;
      cp_async4(dst + r * kLdDst + c,
                live ? src + static_cast<size_t>(r0 + r) * ld_src + c0 + c : src, live);
    }
  }
}

// Rows r0 .. r0 + rows - 1 of a row-major (n, d) matrix into the tile
// dst [rows][kDp + 4], zero-padded to kDp columns.
template <int kDp>
__device__ __forceinline__ void load_tile_async(float* dst, const float* src, int r0, int rows,
                                                int n, int d, int tid, int nthreads) {
  load_block_async<kDp, kDp + 4>(dst, src, d, r0, 0, rows, n, d, tid, nthreads);
}

// The copy of v[r0 .. r0 + rows - 1] into dst[rows]; zeros past n.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int r0, int rows,
                                               int n, int tid, int nthreads) {
  for (int i = tid; i < rows; i += nthreads) {
    const bool live = r0 + i < n;
    cp_async4(dst + i, live ? src + r0 + i : src, live);
  }
}

// Warps of 16 rows for a sequence of n: the number of row tiles per
// (batch, head) and the warps of each, at most kMaxWarps, spread evenly so
// the last tile wastes as few warps as it can.  Four warps a block ran
// faster on the H100 than seven or eight: more, smaller blocks in flight.
constexpr int kMaxWarps = 4;

struct Tiling {
  int tiles, warps;
};

inline Tiling tiling(int n) {
  const int t16 = (n + 15) / 16;
  const int tiles = (t16 + kMaxWarps - 1) / kMaxWarps;
  return {tiles, (t16 + tiles - 1) / tiles};
}

}  // namespace tf32
