// Tile pieces of the half-precision attention kernels (attention_h16_fwd.cu,
// attention_h16_bwd.cu): Hopper's warpgroup products (wgmma) of bf16 or
// fp16 operands with float32 accumulation, their shared-memory matrix
// descriptors over tiles in the 128-byte swizzle, the copies that fill
// such tiles, and the conversions and fp16 range guard around them.  The
// cp.async primitives and kLog2e / kLn2 come from tf32_mma.cuh.
//
// wgmma.mma_async.sync.aligned.m64nNk16.f32.{bf16,f16}: four warps (a
// warpgroup, 128 threads) multiply a 64 x 16 A tile by a 16 x N B tile into
// a 64 x N float32 accumulator spread over their registers.  For warp w of
// the warpgroup and lane = 4 g + t (g = lane / 4, t = lane % 4):
//   accumulator (N / 2 floats): d[4j + 0], d[4j + 1] at row 16w + g, columns
//     8j + 2t, 8j + 2t + 1; d[4j + 2], d[4j + 3] at row 16w + g + 8;
//   A from registers (4 x 32 bits, two 16-bit values each, the lower column
//     in the low half): a0 (16w + g, 2t..2t+1), a1 (16w + g + 8, 2t..2t+1),
//     a2 (16w + g, 2t+8..2t+9), a3 (16w + g + 8, 2t+8..2t+9).
// So the accumulator's 8-column groups j, j + 1, packed in pairs, are the A
// operand of a product whose k runs over those 16 columns (pack_a): P and
// dS feed their products without a shuffle.  The product of two bf16 or
// two fp16 values is exact in float32; the sum is float32.
//
// Shared-memory tiles hold 16-bit values in atoms of 64 columns: an atom is
// rows x 128 bytes, row r at r * 128 bytes, and its eight 16-byte chunks
// stored in the order chunk ^ (r % 8) (the 128-byte swizzle, which TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes).  A tile of D <= 128 columns is one or
// two atoms, the second after the first; columns past D are zero.  Every
// atom starts 1024-byte aligned, so the swizzle follows the address bits
// that the tensor cores read it by.  A descriptor names a 64 x 16 (A) or
// 16 x N (B) slice of such a tile:
//   K-major (the contraction index runs along the row, as Q's and K's head
//     dim in Q K^T): start = the slice's row 0 plus 32 bytes per 16 columns,
//     stride between 8-row groups (SBO) 1024 bytes;
//   MN-major (the contraction index runs down the rows, as V's keys in P V):
//     start = the slice's first row (16 rows a k step, 2048 bytes), SBO 1024
//     bytes between 8-row groups, LBO the stride between 64-column atoms;
//     an N of 16 or 32 may start 2 N or 4 N bytes into the row.
// Order: a warpgroup writes a chain's A registers, fences (wgmma.fence),
// issues the chain's products, commits them as a group, and waits
// for the group before it reads the accumulators; fence_operand keeps the
// compiler from moving those reads above the wait.  Shared memory written
// by threads (st.shared, cp.async) is made visible to the products by
// fence.proxy.async before the barrier that publishes it.

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
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// the two float32 values of one register of T pairs, the low half first
template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
  else
    return make_float2(__half2float(__ushort_as_half(static_cast<unsigned short>(x & 0xffffu))),
                       __half2float(__ushort_as_half(static_cast<unsigned short>(x >> 16))));
}

// The A operand of the 16 columns of accumulator groups j, j + 1 (d[4j ..
// 4j + 7]), each value times mul[row] (row 0: g, row 1: g + 8), rounded to T.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float* d, float mul0 = 1.f,
                                       float mul1 = 1.f) {
  a[0] = pack<T>(d[0] * mul0, d[1] * mul0);
  a[1] = pack<T>(d[2] * mul1, d[3] * mul1);
  a[2] = pack<T>(d[4] * mul0, d[5] * mul0);
  a[3] = pack<T>(d[6] * mul1, d[7] * mul1);
}

// 2^x by the SFU's approximation (2 ulp), results below 2^-126 flushed to
// zero: exp2f without its handling of denormal results.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- fp16 range
// The power of two that float32 values of largest magnitude `amax` (or a
// bound on it) are divided by before they are rounded to fp16 (largest
// finite value 65504): 1 below 2^15, else 2^(e - 14) for amax in [2^e,
// 2^(e+1)), which leaves them below 2^15.  1 for a non-finite amax: the
// product is non-finite either way.  A power of two keeps every mantissa,
// so scaled values round as the unscaled ones would in a wider range.
__device__ __forceinline__ float fp16_row_divisor(float amax) {
  if (!(amax >= 32768.f) || isinf(amax)) return 1.f;
  const int e = static_cast<int>((__float_as_uint(amax) >> 23) & 0xffu) - 127;
  return __uint_as_float(static_cast<uint32_t>(e - 14 + 127) << 23);
}

// ------------------------------------------------------------ swizzled tiles
// Byte offset of element (row, col) in a swizzled tile of `rows` rows.
__device__ __forceinline__ uint32_t swz(int rows, int row, int col) {
  return static_cast<uint32_t>((col >> 6) * rows * 128 + row * 128 +
                               ((((col >> 3) & 7) ^ (row & 7)) << 4) + ((col & 7) << 1));
}

// Rows r0 .. r0 + rows - 1 of a row-major (n, d) matrix of 16-bit values
// into the swizzled tile dst of `rows` rows and 64 * NA columns, zero past
// n and past d.  `vec`: d is a multiple of 8 and src 16-byte aligned, so
// each 8-column chunk copies by one 16-byte cp.async (a copy of 0 source
// bytes zero-fills); else element by element through registers, in plain
// stores that the next fence.proxy.async and barrier publish.
template <int NA, typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src, int r0, int rows,
                                          int n, int d, bool vec, int tid, int nthreads) {
  constexpr int kChunks = 8 * NA;
  if (vec) {
    for (int i = tid; i < rows * kChunks; i += nthreads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool live = r0 + r < n && c < d;
      const T* from = live ? src + static_cast<size_t>(r0 + r) * d + c : src;
      const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst + swz(rows, r, c)));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(from),
                   "r"(live ? 16 : 0));
    }
  } else {
    const uint16_t* from = reinterpret_cast<const uint16_t*>(src);
    for (int i = tid; i < rows * 64 * NA; i += nthreads) {
      const int r = i / (64 * NA), c = i % (64 * NA);
      *reinterpret_cast<uint16_t*>(dst + swz(rows, r, c)) =
          r0 + r < n && c < d ? from[static_cast<size_t>(r0 + r) * d + c] : uint16_t{0};
    }
  }
}

// The first 1024-byte aligned address of dynamic shared memory (the kernels
// ask for 1 KB more than they use).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024u - (s & 1023u)) & 1023u);
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

// ------------------------------------------------------------------- wgmma
// Descriptor of a swizzled slice starting at `p` (see the header comment;
// byte offsets, stored in 16-byte units).
__device__ __forceinline__ uint64_t desc(const unsigned char* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((s >> 4) & 0x3fffu) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32 | 1ull << 62;  // 128-byte swizzle
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Shared memory written by this thread becomes visible to the async proxy
// (the products' operand reads) once a barrier follows.
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define H16_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define H16_COMMA ,
#define H16_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define H16_REGS32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define H16_REGS64                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x N) = A B (+ d when `acc`), A and B from shared memory; kTa / kTb:
// A / B MN-major.  N is 16, 32 or 64.
#define H16_SS(N, REGS, OPS, IA, IB, IP, ITA, ITB)                                          \
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {                                    \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " IP ", 0;\n"                          \
                 " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 " REGS ", " IA \
                 ", " IB ", p, 1, 1, " ITA ", " ITB ";\n}\n"                                \
                 : OPS                                                                       \
                 : "l"(da), "l"(db), "r"(static_cast<int>(acc)), "n"(kTa), "n"(kTb));        \
  } else {                                                                                  \
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, " IP ", 0;\n"                          \
                 " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.f16.f16 " REGS ", " IA   \
                 ", " IB ", p, 1, 1, " ITA ", " ITB ";\n}\n"                                \
                 : OPS                                                                       \
                 : "l"(da), "l"(db), "r"(static_cast<int>(acc)), "n"(kTa), "n"(kTb));        \
  }

template <typename T, int kTa, int kTb>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, bool acc) {
  H16_SS(16, H16_REGS16, H16_D8(0), "%8", "%9", "%10", "%11", "%12")
}

template <typename T, int kTa, int kTb>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, bool acc) {
  H16_SS(32, H16_REGS32, H16_D8(0) H16_COMMA H16_D8(8), "%16", "%17", "%18", "%19", "%20")
}

template <typename T, int kTa, int kTb>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, bool acc) {
  H16_SS(64, H16_REGS64,
         H16_D8(0) H16_COMMA H16_D8(8) H16_COMMA H16_D8(16) H16_COMMA H16_D8(24), "%32", "%33",
         "%34", "%35", "%36")
}

// d (64 x 64) = A B (+ d when `acc`), A from registers (pack_a), B from
// shared memory, MN-major when kTb.
template <typename T, int kTb>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         bool acc) {
#define H16_RS(TY)                                                                          \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"                               \
               " wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " H16_REGS64     \
               ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                              \
               : H16_D8(0), H16_D8(8), H16_D8(16), H16_D8(24)                                \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),                        \
                 "r"(static_cast<int>(acc)), "n"(kTb));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    H16_RS("bf16")
  } else {
    H16_RS("f16")
  }
#undef H16_RS
}

}  // namespace h16
