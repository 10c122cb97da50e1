// Tile pieces of the half-precision attention kernels (attention_h16_fwd.cu,
// attention_h16_bwd.cu): products of bf16 or fp16 operands on the tensor
// cores with float32 accumulation, fragments read from shared memory by
// ldmatrix, float32 values packed into operand registers, and 16-byte
// cp.async tile copies.  The cp.async primitives, the float32 tile copies
// and the spread of 16-row warp tiles come from tf32_mma.cuh.
//
// mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}.{bf16,f16}.f32 for lane
// = 4 * g + t (g = lane / 4, t = lane % 4); each register holds two 16-bit
// values, the lower column (or k) in the low half:
//   A (16 x 16, row-major): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1),
//                           a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8, float32):    c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
// So the C tiles of two neighbouring 8-column groups j, j + 1 are, packed
// in pairs, the A operand of a product whose k runs over those 16 columns:
// a = {c_j[0:2], c_j[2:4], c_j+1[0:2], c_j+1[2:4]} (the FlashAttention-2
// layout: P and dS feed their products without a shuffle).  The product of
// two bf16 or two fp16 values is exact in float32, so each k16 step adds
// exact products into the float32 accumulator.
//
// Shared-memory tiles of 16-bit values are row-major with a row stride of
// kDp + 8 elements (kDp a multiple of 16): rows are 16-byte aligned for
// cp.async and ldmatrix, and the eight row addresses of each ldmatrix
// matrix fall in different banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <type_traits>

#include "tf32_mma.cuh"

namespace h16 {

// two float32 values, rounded to nearest even, as one register of T pairs
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <>
__device__ __forceinline__ float to_float<__half>(__half x) {
  return __half2float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// d += a * b, float32 accumulator, T operands
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// ----------------------------------------------------------------- ldmatrix
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The A fragment of the 16 x 16 block at (row r0, column c0) of a
// row-major tile: lanes 0-15 address rows r0..r0+15 at column c0, lanes
// 16-31 the same rows at c0 + 8.
template <typename T>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const T* s, int ld, int r0, int c0,
                                       int lane) {
  ldmatrix_x4(a, s + (r0 + (lane & 15)) * ld + c0 + (lane >> 4) * 8);
}

// B fragments of two 8-column groups, B[k][n] = tile[n0 + n][k0 + k] for n
// < 16, k < 16 (the tile holds B^T row-major: keys x dims for Q K^T):
// {b[0], b[1]} for columns n0..n0+7, {b[2], b[3]} for n0+8..n0+15.
template <typename T>
__device__ __forceinline__ void b_frags_t(uint32_t (&b)[4], const T* s, int ld, int n0, int k0,
                                          int lane) {
  ldmatrix_x4(b, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two 8-column groups, B[k][n] = tile[k0 + k][n0 + n] (the
// tile holds B row-major: keys x dims for P V), by the transposing load:
// {b[0], b[1]} for columns n0..n0+7, {b[2], b[3]} for n0+8..n0+15.
template <typename T>
__device__ __forceinline__ void b_frags(uint32_t (&b)[4], const T* s, int ld, int k0, int n0,
                                        int lane) {
  ldmatrix_x4_trans(b, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                           (lane >> 4) * 8);
}

// The A operand {c_j[0:2], c_j[2:4], c_j+1[0:2], c_j+1[2:4]} of two C tiles
template <typename T>
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack<T>(c0[0], c0[1]);
  a[1] = pack<T>(c0[2], c0[3]);
  a[2] = pack<T>(c1[0], c1[1]);
  a[3] = pack<T>(c1[2], c1[3]);
}

// ---------------------------------------------------------------- fp16 range
// The power of two that an A operand row of float32 values with largest
// magnitude `amax` is divided by before it is rounded to fp16 (largest
// finite value 65504): 1 below 2^15, else 2^(e - 14) for amax in [2^e,
// 2^(e+1)), which leaves the row below 2^15.  1 for a non-finite amax: the
// product is non-finite either way.  A power of two keeps every mantissa,
// so a scaled row rounds as the unscaled one would in a wider range.
__device__ __forceinline__ float fp16_row_divisor(float amax) {
  if (!(amax >= 32768.f) || isinf(amax)) return 1.f;
  const int e = static_cast<int>((__float_as_uint(amax) >> 23) & 0xffu) - 127;
  return __uint_as_float(static_cast<uint32_t>(e - 14 + 127) << 23);
}

// ------------------------------------------------------------------ copies
// Rows r0 .. r0 + rows - 1 of a row-major (n, d) matrix of 16-bit values
// into the tile dst [rows][kDp + 8], zero-padded to kDp columns and past n.
// `vec`: d is a multiple of 8 and src 16-byte aligned, so each row copies
// in 16-byte cp.async chunks (a copy of 0 source bytes zero-fills); else
// the copy goes element by element through registers, in plain loads and
// stores that the next barrier orders.
template <int kDp, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0, int rows, int n, int d,
                                          bool vec, int tid, int nthreads) {
  constexpr int kLd = kDp + 8;
  if (vec) {
    constexpr int kChunks = kDp / 8;
    for (int i = tid; i < rows * kChunks; i += nthreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool live = r0 + r < n && c < d;
      const T* from = live ? src + static_cast<size_t>(r0 + r) * d + c : src;
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + r * kLd + c));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(from),
                   "r"(live ? 16 : 0));
    }
  } else {
    const uint16_t* from = reinterpret_cast<const uint16_t*>(src);
    uint16_t* to = reinterpret_cast<uint16_t*>(dst);
    for (int i = tid; i < rows * kDp; i += nthreads) {
      const int r = i / kDp, c = i % kDp;
      to[r * kLd + c] =
          r0 + r < n && c < d ? from[static_cast<size_t>(r0 + r) * d + c] : uint16_t{0};
    }
  }
}

// Store the pair (x0, x1) of a row at columns col, col + 1 (col even) of a
// row-major row of 16-bit values with d columns; one 32-bit store when d
// is even.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int d, float x0, float x1) {
  if (d % 2 == 0) {
    if (col < d) *reinterpret_cast<uint32_t*>(row + col) = pack<T>(x0, x1);
  } else {
    if (col < d) row[col] = from_float<T>(x0);
    if (col + 1 < d) row[col + 1] = from_float<T>(x1);
  }
}

}  // namespace h16
