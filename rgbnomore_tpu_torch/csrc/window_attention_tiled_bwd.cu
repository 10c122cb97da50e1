// Swin window attention for windows of 64 < N <= 256 tokens, backward
// (#4L).  For O = softmax(S) V with S = Q K^T + bias[w % P] per window w
// and head, the output's gradient dO, and each query row's log-sum-exp
// lse of S (saved by window_attention_tiled_fwd.cu):
//   P  = exp(S - lse)                    (recomputed tile by tile)
//   dV = P^T dO
//   dP = dO V^T
//   dS = P * (dP - delta),  delta = rowsum(dO * O) = rowsum(dP * P)
//   dQ = dS K,  dK = dS^T Q
//   dbias[p] = sum of dS over every window w with w % P == p
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:
// _win_bwd_kernel (:170-203), which _win_bwd (:267-309) launches as
// fused_window_attention's VJP, at the window sizes past #4's
// (window_attention_bwd.cu, N <= 64): SwinV2 at window 16 (N = 256).  q, k,
// v, o, dout, dq, dk, dv are (BW, H, N, D) float32, contiguous, N <= 256,
// D <= 64; bias and db are (P, H, N, N); lse is (BW, H, N); BW % P == 0.
//
// What bounds it.  On an H100 SXM at stage 1 of SwinV2-B/w16 at batch 256
// (4,096 windows x 4 heads, N = 256, D = 32):
//   operations: the five products of the VJP, 10*N^2*D = 21 MFLOP a
//          (window, head), 344 GFLOP: in 3xTF32 3 x 344 GFLOP at the
//          tensor cores' 495 TFLOP/s = 2.08 ms;
//   bytes: q, k, v, dO read once, dq, dk, dv written once, the bias and its
//          gradient: 3.76 GB, 1.12 ms at 3.35 TB/s.
// Bound by operations.  Seven products are computed against the VJP's
// five: dS is recomputed in the dQ pass rather than written (a (BW, H, N,
// N) scratch would be 4.3 GB at stage 1).
//
// Design: four kernels in order on the stream, no atomics, every sum in a
// fixed order, so two runs give bit-identical gradients:
//   1. tiled_delta_kernel: delta = rowsum(dO * O), one warp a row.
//   2. tiled_dkdv_wgmma_kernel, key-major: a block owns 64 keys of one
//      (pattern, head) and walks a chunk of the pattern's windows (a unit
//      each): dK, dV and the chunk's sum of the bias gradient.
//   3. tiled_dq_wgmma_kernel, query-major: a block owns one (window, head);
//      a unit is two 64-row query tiles: dQ.
//   4. tiled_db_reduce_kernel: one thread a bias entry adds the chunks'
//      partials in chunk order.
// Passes 2 and 3 are Hopper warpgroup products (wgmma.cuh's 128-byte
// swizzled K-major descriptors), every one in 3xTF32 (tf32_mma.cuh's split;
// per 8-deep k step a_hi b_lo, a_lo b_hi, then a_hi b_hi), one block an SM
// of three warpgroups: a producer and two consumers.
//   - A unit has a fixed 64-row A operand (K and V; each consumer's Q and
//     dO) and steps of 32 rows of the other side (pass 2: query rows, 16 at
//     D > 32; pass 3: keys).  The producer loads each item (a unit's fixed
//     rows, a step) into registers an item ahead, 4 x 4 floats a thread,
//     splits every value once into hi and lo, and stores them as K-major
//     swizzled tiles and, where a product contracts over the step's rows
//     (dV += P^T dO, dK += dS^T Q, dQ += dS K), as transposed tiles whose
//     8-row groups hold the k order {0, 2, 4, 6, 1, 3, 5, 7}: S^T's or S's
//     accumulator then feeds that product as its A operand from registers,
//     without a shuffle (tf32_mma.cuh's a_frag_perm).  Its 16-byte stores
//     fall in eight bank groups a phase, its loads on whole 128-byte rows.
//   - Three conversion stages pass steps to the consumers round robin, full
//     and empty mbarriers between them; two fixed buffers at D <= 32 (the
//     next unit's tiles convert while this one runs), one past 32.
//   - A consumer step: S^T and dP^T (pass 3: S and dP) as chains of
//     shared-memory products (m64n32k8, m64n16k8 past D = 32) from zero;
//     P and dS in registers, the bias read a step ahead (one chain does not
//     cover the loads' latency); then the chains into dV and dK (dQ) with
//     P and dS as A operands, added into float32 sums every step (the
//     tensor cores round their accumulator toward zero).
//   - Pass 2: consumer c takes the steps s = c mod 2 of each window, so its
//     exponentials run while the other's products do.  At a window's end
//     the consumer that did not take its last step stores its dK and dV
//     sums, and the other, past an mbarrier, adds its own (a + b: the same
//     bits in either order).  Each step's dS^T goes into the chunk's
//     bias-gradient sum: at D <= 32 in shared memory, each entry owned by one
//     consumer thread (64 KB at N = 256), written to the chunk's partial
//     (P, chunks, H, N, N) at the end; past 32 straight into the partial.
//   - Pass 3: both consumers take every key step, each its own query tile;
//     they issue their S and dP chains in turn (named barriers 2 and 3).
// Registers: the launch bound's 168 a thread (setmaxnreg did not lift
// ptxas's allocation past it); at D = 32 pass 2 uses 168 and spills 12 B,
// pass 3 140; at D = 64 pass 2 spills 176 B (the products and sums of 64
// columns), pass 3 157.  Shared memory: pass 2 226 KB at D <= 32 (stages
// 96, fixed 64, the sum 64), 210 KB past; pass 3 202 KB and 226 KB.
// What bounds it now: latency, not the tensor cores (busy about a quarter
// of the time at stage 1): a step of 32 rows is short against its chains'
// and loads' latencies, with two consumer warpgroups an SM to cover them,
// and every A operand is read from shared memory per product (K and V, or
// Q and dO, in registers need more than the 168 a thread).
// Left for later work: one pass of five products, the dQ partials of a
// window's key tiles reduced through a thread-block cluster's shared memory.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kMaxN = 256;
constexpr int kUnit = 64;      // rows of a unit's fixed A operand: a warpgroup's 64
constexpr int kThreads = 384;  // a producer warpgroup and two consumer warpgroups

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count)
               : "memory");
}

// arrive, with release semantics: this thread's writes before it are seen by
// a thread whose wait completes the phase
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}

// Wait for the phase of `parity` to complete (acquire).  The loop is PTX, so
// that the compiler sees no divergent branch around the products; a wait of
// more than 2^34 clocks traps.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .s64 t0, t1;\n mov.u64 t0, %%clock64;\n"
      "WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @p bra.uni DONE;\n"
      " mov.u64 t1, %%clock64;\n sub.s64 t1, t1, t0;\n setp.gt.s64 p, t1, 17179869184;\n"
      " @p trap;\n bra.uni WAIT;\nDONE:\n}\n" ::"r"(saddr(b)),
      "r"(parity)
      : "memory");
}

// Named barriers 2 and 3 pass the turn to issue products between the two
// consumer warpgroups: one syncs on its own while the other arrives on it.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// -------------------------------------------------------------- tf32 wgmma
// d (64 x N) = A B (+ d when `acc`), tf32 operands, float32 accumulator (the
// layout of wgmma.cuh's header).  wg_ss: A (64 x 8) and B (8 x N) K-major in
// shared memory, by descriptor; wg_rs: A from registers (a0 (16w + g, t),
// a1 (16w + g + 8, t), a2 (16w + g, t + 4), a3 (16w + g + 8, t + 4)).
__device__ __forceinline__ void wg_ss(float (&d)[8], uint64_t a, uint64_t b, bool acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : H16_D8(0)
      : "l"(a), "l"(b), "r"(static_cast<int>(acc)));
}

__device__ __forceinline__ void wg_ss(float (&d)[16], uint64_t a, uint64_t b, bool acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, "
      "1, 1;\n}\n"
      : H16_D8(0), H16_D8(8)
      : "l"(a), "l"(b), "r"(static_cast<int>(acc)));
}

__device__ __forceinline__ void wg_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                      bool acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : H16_D8(0), H16_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(acc)));
}

__device__ __forceinline__ void wg_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                      bool acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : H16_D8(0), H16_D8(8), H16_D8(16), H16_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(acc)));
}

// descriptor of a K-major swizzled slice (rows of 128 bytes, 8-row groups
// 1024 bytes apart); a slice `off` bytes further is the descriptor + off / 16
__device__ __forceinline__ uint64_t kdesc(const unsigned char* p) {
  return h16::desc(p, 16, 1024);
}

// x, hidden from the compiler's view: what is derived from it is computed
// where it is used, not hoisted out of the loop into registers of its own
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// The compiler may not move reads or writes of these registers across this
// point: A fragments stay live, and unchanged, while products in flight
// read them.
template <int N>
__device__ __forceinline__ void keep(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// The A fragments, split, of the accumulator's 8-column groups: group j's
// columns 8j + 2t, 8j + 2t + 1 as k = t, t + 4 (a = {d0, d2, d1, d3}); the
// B operand's rows are stored in that k order (put_block's transposed tiles).
template <int N>
__device__ __forceinline__ void acc_frags(const float* d, uint32_t (&hi)[N][4],
                                          uint32_t (&lo)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    tf32::split(d[4 * j], hi[j][0], lo[j][0]);
    tf32::split(d[4 * j + 2], hi[j][1], lo[j][1]);
    tf32::split(d[4 * j + 1], hi[j][2], lo[j][2]);
    tf32::split(d[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// d = A B from zero over kKS k steps of 8, A (64 rows) and B K-major in
// shared memory: descriptors of A's hi and lo tiles ah, al (64-row atoms),
// of B's bh, bl (atoms of kRowsB rows); a_hi b_lo, a_lo b_hi, a_hi b_hi per
// k step.
template <int kKS, int kRowsB, int N>
__device__ __forceinline__ void chain_ss(float (&d)[N], uint64_t ah, uint64_t al, uint64_t bh,
                                         uint64_t bl) {
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    const uint64_t ao = ((ks >> 2) * kUnit * 128 + (ks & 3) * 32) >> 4;
    const uint64_t bo = ((ks >> 2) * kRowsB * 128 + (ks & 3) * 32) >> 4;
    wg_ss(d, ah + ao, bl + bo, ks > 0);
    wg_ss(d, al + ao, bh + bo, true);
    wg_ss(d, ah + ao, bh + bo, true);
  }
}

// d = A B from zero over the kNQ 8-column groups of A (fragments hi, lo),
// descriptors of B's hi and lo transposed tiles bh, bl (k step j at 32 j
// bytes)
template <int kNQ, int N>
__device__ __forceinline__ void chain_rs(float (&d)[N], uint32_t (&hi)[kNQ][4],
                                         uint32_t (&lo)[kNQ][4], uint64_t bh, uint64_t bl) {
#pragma unroll
  for (int j = 0; j < kNQ; ++j) {
    wg_rs(d, hi[j], bl + 2 * j, j > 0);
    wg_rs(d, lo[j], bh + 2 * j, true);
    wg_rs(d, hi[j], bh + 2 * j, true);
  }
}

// ------------------------------------------------------------ the producer
// Byte offset of float (r, c), c a multiple of 4, in a swizzled K-major tile
// of `rows` rows: atoms of rows x 128 bytes (32 floats of c each), the
// 16-byte chunk (c % 32) / 4 of row r stored at chunk ((c % 32) / 4) ^ (r % 8).
__device__ __forceinline__ int tile_off(int rows, int r, int c) {
  return (c >> 5) * rows * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4);
}

// Four floats of row `row` from column col (a multiple of 4) of a row-major
// (n, d) matrix, zero past n and d: one 16-byte load where d % 4 == 0.
__device__ __forceinline__ float4 ld4(const float* src, int row, int n, int col, int d) {
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < n && col < d) {
    const float* p = src + static_cast<size_t>(row) * d + col;
    if (d % 4 == 0) {
      x = __ldg(reinterpret_cast<const float4*>(p));
    } else {
      x.x = __ldg(p);
      if (col + 1 < d) x.y = __ldg(p + 1);
      if (col + 2 < d) x.z = __ldg(p + 2);
      if (col + 3 < d) x.w = __ldg(p + 3);
    }
  }
  return x;
}

// The producer moves a tile of `rows` rows as 4 x 4 blocks: block lb takes
// rows 8j + par + 2m (m = 0..3) and columns 4cq .. 4cq + 3.  A warp takes four
// values of j2 = 2j + par (o = 0..3) and eight column groups k: its loads
// read four whole 128-byte rows at a time.  In the 16-byte store phase p of
// the warp (lanes 8p .. 8p + 7) each o takes the columns k = 2((o + p) % 4)
// and k + 1: k ^ par differs across the phase, and so does j2 ^ 4(k % 2), so
// the K-major and the transposed stores each fall in eight different
// 16-byte bank groups.
template <int NC>
__device__ __forceinline__ void block_at(int lb, int& j, int& par, int& cq) {
  const int l = lb & 31, grp = lb >> 5, o = (l & 7) >> 1;
  const int j2 = 4 * (grp / NC) + o;
  cq = 8 * (grp % NC) + 2 * ((o + (l >> 3)) & 3) + (l & 1);
  j = j2 >> 1;
  par = j2 & 1;
}

// fetch_block: block lb from rows r0 .. of a row-major (n, d) matrix.
template <int NC>
__device__ __forceinline__ void fetch_block(float4 (&v)[4], const float* src, int r0, int n,
                                            int d, int lb) {
  int j, par, cq;
  block_at<NC>(lb, j, par, cq);
#pragma unroll
  for (int m = 0; m < 4; ++m) v[m] = ld4(src, r0 + 8 * j + par + 2 * m, n, 4 * cq, d);
}

// put_block: the block split, hi and lo, into the K-major tiles hi, lo of
// `rows` rows and, with t, into the transposed tiles thi, tlo (32 NC rows of
// 32 positions), row 8j + r at position 8j + r / 2 (r even) or 8j + 4 + r / 2
// (r odd): the k order of acc_frags.
template <int NC>
__device__ __forceinline__ void put_block(const float4 (&v)[4], int lb, int rows,
                                          unsigned char* hi, unsigned char* lo,
                                          unsigned char* thi, unsigned char* tlo, bool t) {
  int j, par, cq;
  block_at<NC>(lb, j, par, cq);
  uint32_t h[4][4], l[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    tf32::split(v[m].x, h[m][0], l[m][0]);
    tf32::split(v[m].y, h[m][1], l[m][1]);
    tf32::split(v[m].z, h[m][2], l[m][2]);
    tf32::split(v[m].w, h[m][3], l[m][3]);
    const int off = tile_off(rows, 8 * j + par + 2 * m, 4 * cq);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[m][0], h[m][1], h[m][2], h[m][3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[m][0], l[m][1], l[m][2], l[m][3]);
  }
  if (t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = 4 * cq + e;
      const int off = dd * 128 + (((2 * j + par) ^ (dd & 7)) << 4);
      *reinterpret_cast<uint4*>(thi + off) = make_uint4(h[0][e], h[1][e], h[2][e], h[3][e]);
      *reinterpret_cast<uint4*>(tlo + off) = make_uint4(l[0][e], l[1][e], l[2][e], l[3][e]);
    }
  }
}

// The producer's loop over `items` items: item i + 1's values are fetched
// (fetch(i, raw, extra)) before item i is converted and handed on (put(i,
// raw, extra)), so that its loads are in flight while the producer waits for
// the consumers.  (Two or three items ahead ran 2-4% slower on the H100.)
template <int NC, class Fetch, class Put>
__device__ __forceinline__ void produce(int items, Fetch fetch, Put put) {
  float4 buf[2][NC][4];
  float extra[2];
  if (items > 0) fetch(0, buf[0], extra[0]);
  for (int i = 0; i < items; i += 2) {
    if (i + 1 < items) fetch(i + 1, buf[1], extra[1]);
    put(i, buf[0], extra[0]);
    if (i + 1 < items) {
      if (i + 2 < items) fetch(i + 2, buf[0], extra[0]);
      put(i + 1, buf[1], extra[1]);
    }
  }
}

// --------------------------------------------------------------- layouts
// Shared memory of the two wgmma passes, in bytes from the 1024-aligned
// base: kStages conversion stages, the fixed buffers, (pass 2 at D <= 32)
// the bias gradient's sum, the stages' lse and delta (pass 2), and the
// mbarriers full[3], empty[3], fix_full[2], fix_empty[2], xbar[2].
template <int NC, bool kKeyMajor>
struct Shape {
  static constexpr int kDp = 32 * NC;
  static constexpr int kKS = 4 * NC;                          // k steps of 8 over kDp
  static constexpr int kStep = 32 / NC;                       // rows a step
  static constexpr int kDirect = kStep * 128 * NC;            // a step's K-major tile
  static constexpr int kTrans = kDp * 128;                    // a transposed tile
  // pass 2: Q hi, lo, dO hi, lo, Q^T hi, lo, dO^T hi, lo
  // pass 3: K hi, lo, V hi, lo, K^T hi, lo
  static constexpr int kT0 = 4 * kDirect;                     // the first transposed tile
  static constexpr int kStage = kT0 + (kKeyMajor ? 4 : 2) * kTrans;
  static constexpr int kStages = 3;
  static constexpr int kFixT = kUnit * 128 * NC;              // a fixed tile
  static constexpr int kFixBufs = NC == 1 ? 2 : 1;
  // pass 2: K hi, lo, V hi, lo; pass 3: Q hi, lo, dO hi, lo of each consumer
  static constexpr int kFix = (kKeyMajor ? 4 : 8) * kFixT;
  static constexpr int kMaxSteps = (kMaxN / kStep + 1) / 2;   // a consumer's steps a unit
  static constexpr int kDb = kKeyMajor && NC == 1 ? kMaxSteps * (kStep / 2) * 256 * 4 : 0;
  static constexpr int kFixOff = kStages * kStage;
  static constexpr int kDbOff = kFixOff + kFixBufs * kFix;
  static constexpr int kVecOff = kDbOff + kDb;
  static constexpr int kBarOff = kVecOff + kStages * 64 * 4;
  static constexpr int kSmem = kBarOff + 12 * 8 + 1024;
};

// The mbarriers of a block: a stage's full (the producer's 128 threads) and
// empty (its consumers), a fixed buffer's, and the consumers' exchange.
struct Bars {
  uint64_t *full, *empty, *fix_full, *fix_empty, *xbar;
  __device__ Bars(unsigned char* at, int empty_count) {
    uint64_t* b = reinterpret_cast<uint64_t*>(at);
    full = b;
    empty = b + 3;
    fix_full = b + 6;
    fix_empty = b + 8;
    xbar = b + 10;
    if (threadIdx.x == 0) {
      for (int i = 0; i < 3; ++i) {
        bar_init(&full[i], 128);
        bar_init(&empty[i], empty_count);
      }
      for (int i = 0; i < 2; ++i) {
        bar_init(&fix_full[i], 128);
        bar_init(&fix_empty[i], 256);
        bar_init(&xbar[i], 128);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// Each consumer thread's view of a 64 x N accumulator: warp w of its
// warpgroup, g = lane / 4, t = lane % 4; entry 4j + e at row 16w + g + 8(e/2),
// column 8j + 2t + e % 2.
struct Lane {
  int w, g, t;
  __device__ __forceinline__ int row(int e) const { return 16 * w + g + 8 * (e >> 1); }
  __device__ __forceinline__ int col(int j, int e) const { return 8 * j + 2 * t + (e & 1); }
};

// Store (or, with add, add into and store) 64 x kDp sums at rows r0 + row of
// the row-major (n, d) matrix out; rows past n and columns past d are left
// alone.  The adds read every value first, so their loads are in flight
// together.
template <int kDp>
__device__ __forceinline__ void put_sums(float* out, const float (&sum)[kDp / 2], const Lane& ln,
                                         int r0, int n, int d, bool add) {
  float got[kDp / 2];
#pragma unroll
  for (int j = 0; j < kDp / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + ln.row(e), col = ln.col(j, e);
      got[4 * j + e] = add && row < n && col < d ? out[static_cast<size_t>(row) * d + col] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < kDp / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + ln.row(e), col = ln.col(j, e);
      if (row < n && col < d)
        out[static_cast<size_t>(row) * d + col] = got[4 * j + e] + sum[4 * j + e];
    }
}

// delta[row] = sum_c dO[row, c] * O[row, c], one warp per row: lanes stride
// the row, a butterfly adds their sums in a fixed order.
__global__ void tiled_delta_kernel(const float* __restrict__ o,
                                   const float* __restrict__ dout, float* __restrict__ delta,
                                   long long rows, int d) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: every lane of a warp shares its row
  const float* a = o + row * d;
  const float* b = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(a[c], b[c], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// dK, dV of 64 keys of each window of a chunk of one pattern, and the
// chunk's sum of dS over those keys.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    tiled_dkdv_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ delta, float* __restrict__ dk,
                            float* __restrict__ dv, float* __restrict__ partial, int h, int n,
                            int d, int npat, int per_pattern, int chunk, int chunks,
                            int k_tiles) {
  using L = Shape<NC, true>;
  constexpr int kBQ = L::kStep, kNQ = kBQ / 8, kDp = L::kDp;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = h16::align1024(smem_raw);
  unsigned char* fix = smem + L::kFixOff;
  // D <= 32: the bias gradient's sum, each entry owned by one consumer thread
  float* dbs = reinterpret_cast<float*>(smem + L::kDbOff);
  float* vec = reinterpret_cast<float*>(smem + L::kVecOff);
  const Bars bars(smem + L::kBarOff, 128);  // a stage is read by one consumer

  // blockIdx.x = ((p * chunks + ch) * h + head) * k_tiles + key tile: the
  // layout of the partials, (P, chunks, H, N, N)
  const int kt = blockIdx.x % k_tiles;
  const int phc = blockIdx.x / k_tiles;  // (p * chunks + ch) * h + head
  const int head = phc % h, ch = phc / h % chunks, p = phc / h / chunks;
  const int k0 = kt * kUnit;
  const int t0 = ch * chunk, units = min(per_pattern, t0 + chunk) - t0;
  const int steps = (n + kBQ - 1) / kBQ;
  const size_t nd = static_cast<size_t>(n) * d;
  auto unit = [&](int u) {  // (window, head) index of the chunk's window u
    return (p + static_cast<size_t>(t0 + u) * npat) * h + head;
  };
  // the warp index through a shuffle, which the compiler knows is uniform
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (warp < 4) {
    // The producer warpgroup: per window K, V (the fixed tiles), then its
    // query steps.
    const int ptid = threadIdx.x;
    const int per_unit = 2 + steps;
    auto fetch = [&](int i, float4 (&raw)[NC][4], float& lv) {
      const int u = i / per_unit, r = i % per_unit;
      const size_t wb = unit(u) * nd;
      if (r < 2) {
#pragma unroll
        for (int m = 0; m < NC; ++m)
          fetch_block<NC>(raw[m], (r == 0 ? k : v) + wb, k0, n, d, ptid + 128 * m);
      } else {  // Q (threads 0-63) and dO (64-127); lse and delta of the step's rows
        const int q0 = (r - 2) * kBQ, i32 = ptid % 32;
        fetch_block<NC>(raw[0], (ptid < 64 ? q : dout) + wb, q0, n, d, ptid % 64);
        const float* vs = ptid < 32 ? lse : delta;
        lv = ptid < 64 && i32 < kBQ && q0 + i32 < n ? __ldg(vs + unit(u) * n + q0 + i32) : 0.f;
      }
    };
    auto put = [&](int i, const float4 (&cur)[NC][4], float cv) {
      const int u = i / per_unit, r = i % per_unit;
      if (r < 2) {  // K, then V, of window u
        const int b = u % L::kFixBufs;
        unsigned char* fx = fix + b * L::kFix + 2 * r * L::kFixT;
        if (r == 0) bar_wait(&bars.fix_empty[b], ((u / L::kFixBufs) & 1) ^ 1);
#pragma unroll
        for (int m = 0; m < NC; ++m)
          put_block<NC>(cur[m], ptid + 128 * m, kUnit, fx, fx + L::kFixT, nullptr, nullptr,
                        false);
        if (r == 1) {
          h16::proxy_fence();  // the tiles, visible to the products
          bar_arrive(&bars.fix_full[b]);
        }
      } else {  // query step s of window u
        const int gs = u * steps + r - 2, x = gs % L::kStages;
        bar_wait(&bars.empty[x], ((gs / L::kStages) & 1) ^ 1);
        unsigned char* st = smem + x * L::kStage + (ptid < 64 ? 0 : 2 * L::kDirect);
        unsigned char* tt = smem + x * L::kStage + L::kT0 + (ptid < 64 ? 0 : 2 * L::kTrans);
        put_block<NC>(cur[0], ptid % 64, kBQ, st, st + L::kDirect, tt, tt + L::kTrans, true);
        if (ptid < 64) vec[x * 64 + ptid] = cv;
        h16::proxy_fence();
        bar_arrive(&bars.full[x]);
      }
    };
    produce<NC>(units * per_unit, fetch, put);
    return;
  }

  // Consumer warpgroup c: the steps s = c mod 2 of each window.
  const int c = warp / 4 - 1;
  const int ctid = threadIdx.x - 128;
  const Lane ln{warp % 4, static_cast<int>(threadIdx.x % 32) / 4,
                static_cast<int>(threadIdx.x % 4)};
  const int closer = (steps - 1) & 1;  // takes each window's last step
  auto db_at = [&](int s, int y) { return ((s >> 1) * (kBQ / 2) + y) * 256 + ctid; };
  const float* bh = bias + (static_cast<size_t>(p) * h + head) * n * n;
  float* part = partial + static_cast<size_t>(phc) * n * n;
  float sa[kBQ / 2], da[kBQ / 2], dva[kDp / 2], dka[kDp / 2];  // the chains' accumulators
  // bias^T of the warpgroup's step s (the same in every window of the
  // chunk), loaded a step ahead: one chain does not cover the loads' latency
  float bi[kBQ / 2];
  auto bias_t = [&](int s) {
#pragma unroll
    for (int j = 0; j < kNQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + ln.row(e), qq = s * kBQ + ln.col(j, e);
        bi[4 * j + e] = key < n && qq < n ? __ldg(bh + static_cast<size_t>(qq) * n + key) : 0.f;
      }
  };
  bias_t(c);

  for (int u = 0; u < units; ++u) {
    const int b = u % L::kFixBufs;
    bar_wait(&bars.fix_full[b], (u / L::kFixBufs) & 1);
    float dks[kDp / 2], dvs[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) dks[i] = dvs[i] = 0.f;
    for (int s = c; s < steps; s += 2) {
      const int gs = u * steps + s, x = gs % L::kStages;
      const int q0 = s * kBQ;
      bar_wait(&bars.full[x], (gs / L::kStages) & 1);
      const unsigned char* st = smem + x * L::kStage;
      const float* lsed = vec + x * 64;  // the step's lse [0, 32), delta [32, 64)
      const uint64_t sd = opaque(kdesc(st));
      // S^T = K Q^T and dP^T = V dO^T (the chains start from zero; zeroing
      // the registers first ends the last step's values)
#pragma unroll
      for (int i = 0; i < kBQ / 2; ++i) sa[i] = da[i] = 0.f;
      h16::fence();
      const uint64_t fd = opaque(kdesc(fix + b * L::kFix));
      chain_ss<L::kKS, kBQ>(sa, fd, fd + L::kFixT / 16, sd, sd + L::kDirect / 16);
      chain_ss<L::kKS, kBQ>(da, fd + 2 * L::kFixT / 16, fd + 3 * L::kFixT / 16,
                            sd + 2 * L::kDirect / 16, sd + 3 * L::kDirect / 16);
      h16::commit();
      // while the products run: the columns' lse and delta, and the sum's
      // entries so far
      float2 lc[kNQ], dc[kNQ];
      float old[kBQ / 2];
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
        lc[j] = *reinterpret_cast<const float2*>(lsed + ln.col(j, 0));
        dc[j] = *reinterpret_cast<const float2*>(lsed + 32 + ln.col(j, 0));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = 4 * j + e, key = k0 + ln.row(e), qq = q0 + ln.col(j, e);
          if constexpr (NC == 1)
            old[y] = u == 0 ? 0.f : dbs[db_at(s, y)];
          else
            old[y] = u == 0 || key >= n || qq >= n ? 0.f : part[static_cast<size_t>(qq) * n + key];
        }
      }
      h16::wait<0>();
      h16::fence_operand(sa);
      h16::fence_operand(da);
      // P^T = exp(S^T + bias^T - lse), dS^T = P^T (dP^T - delta), and dS^T
      // into the chunk's sum; rows or columns past N get 0
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = 4 * j + e;
          const bool live = k0 + ln.row(e) < n && q0 + ln.col(j, e) < n;
          const float l = e & 1 ? lc[j].y : lc[j].x, dl = e & 1 ? dc[j].y : dc[j].x;
          const float pr = live ? exp2f((sa[y] + bi[y] - l) * tf32::kLog2e) : 0.f;
          sa[y] = pr;
          da[y] = pr * (da[y] - dl);
          old[y] += da[y];
        }
      bias_t(s + 2 < steps ? s + 2 : c);  // the warpgroup's next step
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = 4 * j + e, key = k0 + ln.row(e), qq = q0 + ln.col(j, e);
          if constexpr (NC == 1)
            dbs[db_at(s, y)] = old[y];
          else if (key < n && qq < n)
            part[static_cast<size_t>(qq) * n + key] = old[y];
        }
      // dV += P^T dO, dK += dS^T Q: P^T and dS^T as A operands
      uint32_t ph[kNQ][4], pl[kNQ][4], sh[kNQ][4], sl[kNQ][4];
      acc_frags<kNQ>(sa, ph, pl);
      acc_frags<kNQ>(da, sh, sl);
      keep(ph);
      keep(pl);
      keep(sh);
      keep(sl);
#pragma unroll
      for (int i = 0; i < kDp / 2; ++i) dva[i] = dka[i] = 0.f;
      const uint64_t td = opaque(kdesc(st + L::kT0));
      h16::fence();
      chain_rs<kNQ>(dva, ph, pl, td + 2 * L::kTrans / 16, td + 3 * L::kTrans / 16);
      chain_rs<kNQ>(dka, sh, sl, td, td + L::kTrans / 16);
      h16::commit();
      h16::wait<0>();
      h16::fence_operand(dva);
      h16::fence_operand(dka);
      keep(ph);
      keep(pl);
      keep(sh);
      keep(sl);
#pragma unroll
      for (int i = 0; i < kDp / 2; ++i) {
        dvs[i] += dva[i];
        dks[i] += dka[i];
      }
      bar_arrive(&bars.empty[x]);  // the stage is read (every thread of the warpgroup)
    }
    // the window's dK and dV: the giver's sums, then the closer's added
    const size_t wb = unit(u) * nd;
    if (c != closer) {
      put_sums<kDp>(dk + wb, dks, ln, k0, n, d, false);
      put_sums<kDp>(dv + wb, dvs, ln, k0, n, d, false);
      bar_arrive(&bars.xbar[u & 1]);
    } else {
      bar_wait(&bars.xbar[u & 1], (u >> 1) & 1);
      put_sums<kDp>(dk + wb, dks, ln, k0, n, d, true);
      put_sums<kDp>(dv + wb, dvs, ln, k0, n, d, true);
    }
    // Freed only after the exchange, so that xbar[u % 2] is not arrived on
    // again (two windows on, behind this buffer) before its wait has passed.
    bar_arrive(&bars.fix_empty[b]);
  }

  if constexpr (NC == 1) {  // the chunk's partial, from each thread's own entries
    for (int s = c; s < steps; s += 2)
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + ln.row(e), qq = s * kBQ + ln.col(j, e);
          if (key < n && qq < n) part[static_cast<size_t>(qq) * n + key] = dbs[db_at(s, 4 * j + e)];
        }
  }
}

// dQ = dS K of one (window, head): a unit is two 64-row query tiles, one a
// consumer warpgroup, both taking every key step.
template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    tiled_dq_wgmma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ bias,
                          const float* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dq, int h, int n,
                          int d, int npat) {
  using L = Shape<NC, false>;
  constexpr int kBK = L::kStep, kNK = kBK / 8, kDp = L::kDp;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = h16::align1024(smem_raw);
  unsigned char* fix = smem + L::kFixOff;
  const Bars bars(smem + L::kBarOff, 256);  // a stage is read by both consumers

  const int wh = blockIdx.x;  // w * h + head
  const int head = wh % h, p = (wh / h) % npat;
  const size_t base = static_cast<size_t>(wh) * n * d;
  const int steps = (n + kBK - 1) / kBK;
  const int units = ((n + kUnit - 1) / kUnit + 1) / 2;
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (warp < 4) {
    // The producer warpgroup: per unit Q and dO of each consumer's tile,
    // then the key steps (K and V).
    const int ptid = threadIdx.x;
    const int per_unit = 4 + steps;
    auto fetch = [&](int i, float4 (&raw)[NC][4], float&) {
      const int u = i / per_unit, r = i % per_unit;
      if (r < 4) {  // Q, dO of tile 2u, then of tile 2u + 1
        const float* src = (r % 2 == 0 ? q : dout) + base;
#pragma unroll
        for (int m = 0; m < NC; ++m)
          fetch_block<NC>(raw[m], src, (2 * u + r / 2) * kUnit, n, d, ptid + 128 * m);
      } else {  // K (threads 0-63) and V (64-127)
        fetch_block<NC>(raw[0], (ptid < 64 ? k : v) + base, (r - 4) * kBK, n, d, ptid % 64);
      }
    };
    auto put = [&](int i, const float4 (&cur)[NC][4], float) {
      const int u = i / per_unit, r = i % per_unit;
      if (r < 4) {
        const int b = u % L::kFixBufs;
        unsigned char* fx = fix + b * L::kFix + 2 * r * L::kFixT;
        if (r == 0) bar_wait(&bars.fix_empty[b], ((u / L::kFixBufs) & 1) ^ 1);
#pragma unroll
        for (int m = 0; m < NC; ++m)
          put_block<NC>(cur[m], ptid + 128 * m, kUnit, fx, fx + L::kFixT, nullptr, nullptr,
                        false);
        if (r == 3) {
          h16::proxy_fence();
          bar_arrive(&bars.fix_full[b]);
        }
      } else {  // key step r - 4
        const int gs = u * steps + r - 4, x = gs % L::kStages;
        bar_wait(&bars.empty[x], ((gs / L::kStages) & 1) ^ 1);
        unsigned char* st = smem + x * L::kStage + (ptid < 64 ? 0 : 2 * L::kDirect);
        unsigned char* tt = smem + x * L::kStage + L::kT0;
        put_block<NC>(cur[0], ptid % 64, kBK, st, st + L::kDirect, tt, tt + L::kTrans,
                      ptid < 64);
        h16::proxy_fence();
        bar_arrive(&bars.full[x]);
      }
    };
    produce<NC>(units * per_unit, fetch, put);
    return;
  }

  // Consumer warpgroup c: query tile 2u + c of each unit.
  const int c = warp / 4 - 1;
  const Lane ln{warp % 4, static_cast<int>(threadIdx.x % 32) / 4,
                static_cast<int>(threadIdx.x % 4)};
  const float* bh = bias + (static_cast<size_t>(p) * h + head) * n * n;
  float sa[kBK / 2], da[kBK / 2], dqa[kDp / 2];  // the chains' accumulators
  if (c == 1) named_arrive(2);  // consumer 0 issues first
  // the bias of query tile 2u + c at key step s, loaded a step ahead
  float bi[kBK / 2];
  auto bias_tile = [&](int u, int s) {  // a pair of keys a load where n is even
#pragma unroll
    for (int j = 0; j < kNK; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (2 * u + c) * kUnit + ln.row(2 * r), key = s * kBK + ln.col(j, 0);
        float2 b2 = make_float2(0.f, 0.f);
        if (row < n && key < n) {
          const float* at = bh + static_cast<size_t>(row) * n + key;
          if (n % 2 == 0) {
            b2 = __ldg(reinterpret_cast<const float2*>(at));
          } else {
            b2.x = __ldg(at);
            if (key + 1 < n) b2.y = __ldg(at + 1);
          }
        }
        bi[4 * j + 2 * r] = b2.x;
        bi[4 * j + 2 * r + 1] = b2.y;
      }
  };
  bias_tile(0, 0);

  for (int u = 0; u < units; ++u) {
    const int b = u % L::kFixBufs;
    const int q0 = (2 * u + c) * kUnit;
    float rl[2], rd[2];  // lse and delta of rows g and g + 8 (0 past N)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + ln.row(2 * r);
      rl[r] = row < n ? __ldg(lse + static_cast<size_t>(wh) * n + row) : 0.f;
      rd[r] = row < n ? __ldg(delta + static_cast<size_t>(wh) * n + row) : 0.f;
    }
    bar_wait(&bars.fix_full[b], (u / L::kFixBufs) & 1);
    float dqs[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) dqs[i] = 0.f;
    for (int s = 0; s < steps; ++s) {
      const int gs = u * steps + s, x = gs % L::kStages;
      const int j0 = s * kBK;
      bar_wait(&bars.full[x], (gs / L::kStages) & 1);
      const unsigned char* st = smem + x * L::kStage;
      const uint64_t sd = opaque(kdesc(st));
      // S = Q K^T and dP = dO V^T, issued in turn with the other consumer,
      // so that one's products run while the other's exponentials do
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sa[i] = da[i] = 0.f;
      named_sync(2 + c);
      h16::fence();
      const uint64_t fd = opaque(kdesc(fix + b * L::kFix + 4 * c * L::kFixT));
      chain_ss<L::kKS, kBK>(sa, fd, fd + L::kFixT / 16, sd, sd + L::kDirect / 16);
      chain_ss<L::kKS, kBK>(da, fd + 2 * L::kFixT / 16, fd + 3 * L::kFixT / 16,
                            sd + 2 * L::kDirect / 16, sd + 3 * L::kDirect / 16);
      h16::commit();
      if (c == 0 || gs + 1 < units * steps) named_arrive(3 - c);  // the other's turn
      h16::wait<0>();
      h16::fence_operand(sa);
      h16::fence_operand(da);
      // dS = P (dP - delta), P = exp(S + bias - lse); rows or keys past N get 0
#pragma unroll
      for (int j = 0; j < kNK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int y = 4 * j + e;
          const bool live = q0 + ln.row(e) < n && j0 + ln.col(j, e) < n;
          const float pr = live ? exp2f((sa[y] + bi[y] - rl[e >> 1]) * tf32::kLog2e) : 0.f;
          da[y] = pr * (da[y] - rd[e >> 1]);
        }
      if (s + 1 < steps)  // the next step's bias
        bias_tile(u, s + 1);
      else
        bias_tile(u + 1, 0);
      // dQ += dS K, dS as the A operand
      uint32_t sh[kNK][4], sl[kNK][4];
      acc_frags<kNK>(da, sh, sl);
      keep(sh);
      keep(sl);
#pragma unroll
      for (int i = 0; i < kDp / 2; ++i) dqa[i] = 0.f;
      const uint64_t td = opaque(kdesc(st + L::kT0));
      h16::fence();
      chain_rs<kNK>(dqa, sh, sl, td, td + L::kTrans / 16);
      h16::commit();
      h16::wait<0>();
      h16::fence_operand(dqa);
      keep(sh);
      keep(sl);
#pragma unroll
      for (int i = 0; i < kDp / 2; ++i) dqs[i] += dqa[i];
      bar_arrive(&bars.empty[x]);
    }
    put_sums<kDp>(dq + base, dqs, ln, q0, n, d, false);
    bar_arrive(&bars.fix_empty[b]);
  }
}

// db[p, head, e] = sum over chunks, in order, of partial[p, chunk, head, e].
__global__ void tiled_db_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ db, int h, int nn, int chunks,
                                       long long total) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long e = idx % nn, ph = idx / nn;
  const long long head = ph % h, p = ph / h;
  const float* src = partial + (p * chunks * h + head) * nn + e;
  const long long stride = static_cast<long long>(h) * nn;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += src[c * stride];
  db[idx] = s;
}

constexpr int kSmallThreads = 256;

struct Args {
  const float *q, *k, *v, *bias, *o, *dout, *lse;
  float *delta, *partial, *dq, *dk, *dv, *db;
  long long bw;
  int h, n, d, npat, chunk;
};

template <int NC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using KM = Shape<NC, true>;
  using DQ = Shape<NC, false>;
  const long long rows = a.bw * a.h * a.n;
  const long long per_pattern = a.bw / a.npat;
  const long long chunks = (per_pattern + a.chunk - 1) / a.chunk;
  const int k_tiles = (a.n + kUnit - 1) / kUnit;
  const long long dkdv_blocks = a.npat * chunks * a.h * k_tiles;
  const long long dq_blocks = a.bw * a.h;
  const long long delta_blocks = (rows * 32 + kSmallThreads - 1) / kSmallThreads;
  const long long total = static_cast<long long>(a.npat) * a.h * a.n * a.n;
  const long long reduce_blocks = (total + kSmallThreads - 1) / kSmallThreads;
  if (std::max({dkdv_blocks, dq_blocks, delta_blocks, reduce_blocks, per_pattern}) > INT_MAX)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      tiled_dkdv_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, KM::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_dq_wgmma_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, DQ::kSmem);
  if (err != cudaSuccess) return err;

  tiled_delta_kernel<<<static_cast<unsigned>(delta_blocks), kSmallThreads, 0, stream>>>(
      a.o, a.dout, a.delta, rows, a.d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dkdv_wgmma_kernel<NC>
      <<<static_cast<unsigned>(dkdv_blocks), kThreads, KM::kSmem, stream>>>(
      a.q, a.k, a.v, a.bias, a.dout, a.lse, a.delta, a.dk, a.dv, a.partial, a.h, a.n, a.d,
      a.npat, static_cast<int>(per_pattern), a.chunk, static_cast<int>(chunks), k_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dq_wgmma_kernel<NC><<<static_cast<unsigned>(dq_blocks), kThreads, DQ::kSmem, stream>>>(
      a.q, a.k, a.v, a.bias, a.dout, a.lse, a.delta, a.dq, a.h, a.n, a.d, a.npat);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_db_reduce_kernel<<<static_cast<unsigned>(reduce_blocks), kSmallThreads, 0,
                           stream>>>(
      a.partial, a.db, a.h, a.n * a.n, static_cast<int>(chunks), total);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  q, k, v, o (the forward's output), dout, dq, dk, dv
// are device pointers to contiguous (bw, h, n, d) float32 tensors; bias and
// db to contiguous (npat, h, n, n) float32 tensors; lse (the forward's
// log-sum-exp) and delta (scratch) to (bw, h, n) float32; partial (scratch)
// to npat * chunks * h * n * n floats, where chunks = ceil((bw / npat) /
// chunk); stream is a cudaStream_t.  Launches four kernels in order on the
// stream.  Returns a cudaError_t: 0 when every launch was accepted.
extern "C" int window_attention_tiled_bwd(const void* q, const void* k, const void* v,
                                          const void* bias, const void* o, const void* dout,
                                          const void* lse, void* delta, void* partial, void* dq,
                                          void* dk, void* dv, void* db, long long bw, int h,
                                          int n, int d, int npat, int chunk, void* stream) {
  if (bw <= 0 || h <= 0 || n <= 0 || n > kMaxN || d <= 0 || d > 64 || npat <= 0 ||
      bw % npat != 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(q),     static_cast<const float*>(k),
               static_cast<const float*>(v),     static_cast<const float*>(bias),
               static_cast<const float*>(o),     static_cast<const float*>(dout),
               static_cast<const float*>(lse),   static_cast<float*>(delta),
               static_cast<float*>(partial),     static_cast<float*>(dq),
               static_cast<float*>(dk),          static_cast<float*>(dv),
               static_cast<float*>(db),          bw,
               h,                                n,
               d,                                npat,
               chunk};
  auto s = static_cast<cudaStream_t>(stream);
  return d <= 32 ? launch<1>(a, s) : launch<2>(a, s);
}

extern "C" const char* window_attention_tiled_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
