// Fused softmax attention, backward, on bf16 or fp16 inputs (mixed
// precision).  For O = softmax(scale*QK^T) V and the output's gradient dO:
//   P  = exp(scale * Q K^T - lse)       (lse: each row's float32
//                                         log-sum-exp, saved by
//                                         attention_h16_fwd.cu)
//   dV = P^T dO
//   dP = dO V^T
//   dS = P * (dP - delta),  delta = rowsum(dO * O)
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:_bwd_kernel
// (:51-69), which _bwd (:112-135) launches as fused_attention's VJP, as it
// runs on bf16 or fp16 inputs: every product takes half-precision operands
// with float32 accumulation, P, dP and dS are float32, and dq, dk, dv are
// cast to the input dtype.  q, k, v, o, dO (B, H, N, D), contiguous, any
// N >= 1 and D <= 128.  P and dS are rounded to the input dtype only as
// operands of the dV, dK and dQ products; delta is summed in float32 from
// the input-dtype O and dO, as FlashAttention sums it (the Pallas kernel
// sums dP * P, equal in exact arithmetic).
//
// fp16's range: under the loss scale (2^15 at the start), dO V^T can pass
// fp16's largest value 65504 where float32 holds it, and so can dS.  dP and
// dS stay float32 here, and dS is rounded to fp16 only as an operand, so
// what must stay in range is dS itself.  Every quantity of the backward is
// linear in dO, so fp16 divides the head's dO by a power of two s
// (h16::fp16_row_divisor of a bound on the head's |dS|: 1 below 2^15) as
// each dO tile lands in shared memory, and multiplies dq, dk and dv by s
// when it stores them: exact in float32, and exact in fp16 but for dO
// values that the division takes below fp16's normal range (2^-14), which
// keep their absolute error of 2^-24 s.  The bound is known before any
// product: P <= 1 and Cauchy-Schwarz give |dS_ij| <= |dO_i| |V_j| +
// |delta_i|, and |delta_i| = |dO_i . O_i| <= |dO_i| max_j |V_j| (O_i is a
// convex sum of V's rows, rounded), so |dS| <= 2 max_i |dO_i| max_j |V_j|:
// max |dO_i| from a pass over the head's dO in device memory while its
// first tiles load, max |V_j| from V in shared memory (past 208 keys, the
// later groups' in the same pass).  No product or accumulator changes: the
// loop is bf16's.  A dq, dk or dv
// beyond fp16's range still overflows when it is stored, as the Pallas
// kernel's cast does.  bf16 has float32's range and skips all of it.
//
// Bounds on an H100 SXM, at the ViT-B train shape (512, 12, 196, 64):
//   operations: the five products of the VJP (QK^T, dO V^T, P^T dO, dS K,
//          dS^T Q), 10 * N^2 * D * B * H = 151 GFLOP, 0.153 ms at the
//          tensor cores' 989 TFLOP/s dense bf16 / fp16;
//   bytes: q, k, v, o, dO read once, dq, dk, dv written once (2 B each),
//          lse read once (4 B), 1.24 GB, 0.370 ms at 3.35 TB/s.
// Bound by bytes, 2.4x above the operations.
//
// Design: one block of two warpgroups per (batch, head), nothing in device
// memory but the inputs and the outputs, every sum in a fixed order and no
// atomics (the Pallas kernel's whole head, on Hopper's warpgroup products,
// wgmma.cuh):
//   - The head's K and V stay in swizzled shared memory (208 keys at N =
//     196: 53 KB).  Warpgroup w owns the 64-key chunks w and w + 2 (one
//     chunk at D > 64) and keeps their dK and dV in float32 registers over
//     the whole head (128 of a thread's 255; the last chunk holds 4 live
//     keys at N = 196, the cost of 64-row products).
//   - The head's 64-row query tiles stream through two cp.async stages of
//     Q, dO, O and lse.  Per tile the block sums delta from O and dO, then
//     each warpgroup, per chunk and 32 queries: S^T = K Q^T and dP^T =
//     V dO^T by one wgmma chain (A = the chunk's keys, B = the queries); P^T
//     and dS^T in float32 registers; dV += P^T dO and dK += dS^T Q by one
//     wgmma chain with P^T and dS^T as A operands from registers; and dS^T,
//     rounded to the input dtype, into a shared [key][query] tile.
//   - dQ of the tile = scale * dS K: one wgmma chain over the keys with dS
//     (MN-major) and K from shared memory, each warpgroup taking half of the
//     head dim.  It runs during the next tile, from the second of two dS
//     tiles, so no barrier waits for it.  dS never leaves shared memory: the
//     former design's float32 (B, H, N, N) scratch, delta pass and dQ pass
//     are gone.
//   - No branch parts a chain of products (keys and queries past N are
//     masked, not skipped), or ptxas serialises them all (C7520).
//   - N > 208: key groups of 256 (128 for D > 64); each group's dK and dV
//     are complete after its query walk, and dQ is summed over the groups in
//     a float32 (B, H, N, D) buffer that only its own block reads and
//     writes, in group order.
//   Tried on the H100 and not kept (PERF.md, section 6): four warpgroups of
//   one chunk each (128 registers a thread, spilling); 16-query products; a
//   persistent block an SM walking the heads with the next head's K and V
//   copied in ahead; P^T and dS^T through shared memory so that the next S^T
//   chain runs under dV and dK; the range guard as a branch in the one
//   kernel; fp16 as two launches, the plain kernel marking the heads whose
//   |dS| reached 2^15 and a second, one block an SM, redoing those heads
//   one 16-wide step at a time (on the H100 at ViT-B's shape, 2.5 ms when
//   every head is marked, as a loss scale near its overflow may mark them,
//   against 1.15 for the former mma.sync kernel); dK's divisors from each
//   product's largest |dS|, dK's accumulator divided and multiplied around
//   each product (255 registers spilling 140 B: 1.0 ms); divisors from
//   bounds per key row (dK) and per query row (dQ), the dS tile and dK's
//   operand scaled in the loop (spilling 184 B: 1.1 ms); dS divided by the
//   head's divisor in registers in place of dO in shared memory (1% slower).

#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <type_traits>

#include "wgmma.cuh"

namespace {

constexpr int kBM = 64;  // query rows per tile

// Two warpgroups a block, each owning 64-key chunks of the keys: two each
// at D <= 64 (256 keys), one at D > 64, whose dK and dV take twice the
// registers.
constexpr int kWarpgroups = 2;
constexpr int kThreads = 128 * kWarpgroups;
template <int NA>
constexpr int kChunksPerWg = NA == 1 ? 2 : 1;

// Shared memory, in bytes from the 1024-aligned base, for key groups of 16
// KC keys: K, V [16 KC][64 NA]; two stages of Q, dO, O [kBM][64 NA]; two
// dS tiles [16 KC][kBM] (a tile's dQ product runs while the next tile's dS
// is written); then float32 lse [2][kBM] (in log2 units once a tile lands),
// delta [kBM], and fp16's warps' largest |dO_i|^2 and |V_j|^2 over the head
// [2][8].
// The fourth chunk's products read rows past 16 KC = 208 (N <= 208): they
// run into V and the stages, and every value they give is masked.
template <int NA, int KC>
struct Layout {
  static constexpr int kG = 16 * KC;
  static constexpr int kKv = NA * kG * 128;
  static constexpr int kTile = NA * kBM * 128;
  static constexpr int kDsTile = kG * 128;
  static constexpr int kStage = 2 * kKv;  // K at 0, V at kKv
  static constexpr int kDs = kStage + 6 * kTile;
  static constexpr int kLse = kDs + 2 * kDsTile;
  static constexpr int kDelta = kLse + 2 * kBM * 4;
  static constexpr int kMaxes = kDelta + kBM * 4;
  static constexpr int kBytes = kMaxes + 2 * (kThreads / 32) * 4 + 1024;
};

// The sum of squares, in float32, of row `row` of a row-major (n, d) matrix
// of fp16 values in device memory; `vec` (d a multiple of 8, rows 16-byte
// aligned): 16-byte loads, all issued before the sums.
template <int NA>
__device__ __forceinline__ float row_sq(const __half* m, int row, int d, bool vec) {
  float sq = 0.f;
  if (vec) {
    const uint4* r = reinterpret_cast<const uint4*>(m + static_cast<size_t>(row) * d);
    uint4 x[8 * NA];
#pragma unroll
    for (int cc = 0; cc < 8 * NA; ++cc) x[cc] = 8 * cc < d ? __ldg(r + cc) : uint4{};
#pragma unroll
    for (int cc = 0; cc < 8 * NA; ++cc) {
      const uint32_t w[4] = {x[cc].x, x[cc].y, x[cc].z, x[cc].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = h16::unpack<__half>(w[e]);
        sq = fmaf(a.x, a.x, fmaf(a.y, a.y, sq));
      }
    }
  } else {
    for (int col = 0; col < d; ++col) {
      const float a = __half2float(m[static_cast<size_t>(row) * d + col]);
      sq = fmaf(a, a, sq);
    }
  }
  return sq;
}

// One block per (batch, head) walks the head's keys in groups of 16 KC (N
// > 16 KC: several, dQ summed over them in dq_acc).
template <typename T, int NA, int KC>
__global__ void __launch_bounds__(kThreads, 1)
    attention_h16_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ o,
                             const T* __restrict__ dout, const float* __restrict__ lse,
                             float* __restrict__ dq_acc, T* __restrict__ dq,
                             T* __restrict__ dk, T* __restrict__ dv, int n, int d,
                             float scale, float scale_log2, bool vec) {
  using L = Layout<NA, KC>;
  constexpr bool kGuard = std::is_same<T, __half>::value;  // fp16's range guard
  constexpr int kG = L::kG;
  constexpr int kT = kThreads;
  constexpr int kW = kWarpgroups;
  constexpr int kCW = kChunksPerWg<NA>;
  constexpr int kBN = 32;                      // queries per S^T product: half a tile
  constexpr int kNG = kBN / 8;                 // 8-query groups of a product
  constexpr int kNQ = kBN / 16;                // 16-query steps of a product
  constexpr int kDqCols = 64 * NA / kW;        // head-dim columns of a warpgroup's dQ
  constexpr int kRowThreads = kT / kBM;        // threads of a row's delta
  constexpr int kRowChunks = 8 * NA / kRowThreads;  // 8-column chunks of each
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = h16::align1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(base + L::kLse);
  float* delta_s = reinterpret_cast<float*>(base + L::kDelta);
  float* maxes_s = reinterpret_cast<float*>(base + L::kMaxes);  // dO, V

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q_tiles = (n + kBM - 1) / kBM;
  const int groups = (n + kG - 1) / kG;
  const int c0 = kDqCols * wg;  // the warpgroup's first dQ column
  auto dss = [&](int i) { return base + L::kDs + (i & 1) * L::kDsTile; };
  unsigned char* ks = base;
  unsigned char* vs = base + L::kKv;
  auto stage = [&](int c) { return base + L::kStage + (c & 1) * 3 * L::kTile; };
  const int bh = blockIdx.x;
  const size_t head = static_cast<size_t>(bh) * n * d;
  auto load_stage = [&](int c, int i) {  // query tile i into stage c
    unsigned char* st = stage(c);
    h16::load_tile<NA>(st, q + head, i * kBM, kBM, n, d, vec, tid, kT);
    h16::load_tile<NA>(st + L::kTile, dout + head, i * kBM, kBM, n, d, vec, tid, kT);
    h16::load_tile<NA>(st + 2 * L::kTile, o + head, i * kBM, kBM, n, d, vec, tid, kT);
    tf32::load_vec_async(lse_s + (c & 1) * kBM, lse + static_cast<size_t>(bh) * n, i * kBM,
                         kBM, n, tid, kT);
  };

  // fp16: the head's divisor, from a bound on its |dS| (header comment)
  auto head_div = [&] {
    float dmax = 0.f, vmax = 0.f;
#pragma unroll
    for (int w = 0; w < kT / 32; ++w) {
      dmax = fmaxf(dmax, maxes_s[w]);
      vmax = fmaxf(vmax, maxes_s[kT / 32 + w]);
    }
    return h16::fp16_row_divisor(2.f * sqrtf(dmax) * sqrtf(vmax));
  };

  int c = 0;  // query tiles so far: tile c sits in stage c & 1
  for (int kg = 0; kg < groups; ++kg) {
    const int key0 = kg * kG;
    if (kg > 0) __syncthreads();  // the last group's K, V and dS are consumed
    h16::load_tile<NA>(ks, k + head, key0, kG, n, d, vec, tid, kT);
    h16::load_tile<NA>(vs, v + head, key0, kG, n, d, vec, tid, kT);
    load_stage(c, 0);
    tf32::cp_commit();
    if constexpr (kGuard) {
      if (kg == 0) {
        // while those land: the largest |dO_i|^2 of the head's queries, and
        // |V_j|^2 of its keys past the first group (the first group's are
        // read from shared memory once they land)
        float dmax = 0.f, vmax = 0.f;
        for (int row = tid; row < n; row += kT)
          dmax = fmaxf(dmax, row_sq<NA>(dout + head, row, d, vec));
        for (int row = kG + tid; row < n; row += kT)
          vmax = fmaxf(vmax, row_sq<NA>(v + head, row, d, vec));
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
          dmax = fmaxf(dmax, __shfl_xor_sync(0xffffffffu, dmax, off));
          vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
        }
        if (lane == 0) {
          maxes_s[tid / 32] = dmax;
          maxes_s[kT / 32 + tid / 32] = vmax;
        }
      }
    }

    // dQ of query tile i = dS K over the group's keys: this warpgroup's
    // kDqCols columns of the head dim, A = dS (MN-major) and B = K from
    // shared memory, one chain.  Summed over the groups in order (dq_acc),
    // then scale * dQ (fp16: times the head's divisor) in T.
    auto dq_tile = [&](int i, int kg) {
      const unsigned char* ds = dss(i);
      const unsigned char* kb = ks + (c0 / 64) * kG * 128 + (c0 % 64) * 2;
      float dq_part[kDqCols / 2];
      h16::fence();
#pragma unroll
      for (int s = 0; s < kG / 16; ++s)
        h16::wgmma_ss<T, 1, 1>(dq_part, h16::desc(ds + s * 16 * 128, kBM * 128, 1024),
                               h16::desc(kb + s * 16 * 128, kG * 128, 1024), s > 0);
      h16::commit();
      h16::wait<0>();
      h16::fence_operand(dq_part);
      const float qscale = kGuard ? scale * head_div() : scale;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = i * kBM + 16 * warp + g + 8 * r;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < kDqCols / 8; ++j) {
          const int col = c0 + 8 * j + 2 * t;
          if (col >= d) continue;
          float x0 = dq_part[4 * j + 2 * r], x1 = dq_part[4 * j + 2 * r + 1];
          const size_t at = head + static_cast<size_t>(row) * d + col;
          if (kg > 0) {
            x0 += dq_acc[at];
            if (col + 1 < d) x1 += dq_acc[at + 1];
          }
          if (kg + 1 < groups) {
            dq_acc[at] = x0;
            if (col + 1 < d) dq_acc[at + 1] = x1;
          } else {
            h16::store_pair(dq + head + static_cast<size_t>(row) * d, col, d, x0 * qscale,
                            x1 * qscale);
          }
        }
      }
    };

    float dk_acc[kCW][NA][32], dv_acc[kCW][NA][32];  // from the first tile's products

    for (int it = 0; it < q_tiles; ++it, ++c) {
      tf32::cp_wait<0>();  // tile it has landed (at first with the group's K, V)
      h16::proxy_fence();  // (and this thread's dS of tile it - 1 is visible to the products)
      __syncthreads();     // ... for every thread; tile it - 1 is consumed, dS of it - 2 too
      if (it + 1 < q_tiles) load_stage(c + 1, it + 1);
      tf32::cp_commit();
      const unsigned char* qs = stage(c);
      unsigned char* dos = stage(c) + L::kTile;  // (fp16 scales it in place)
      const unsigned char* os = qs + 2 * L::kTile;
      float* lse_t = lse_s + (c & 1) * kBM;
      unsigned char* ds_t = dss(it);
      const int q0 = it * kBM;
      if constexpr (kGuard) {
        if (kg == 0 && it == 0) {  // the first group's largest |V_j|^2 (rows past N are 0)
          float vn = 0.f;
          if (tid < kG) {
#pragma unroll
            for (int cc = 0; cc < 8 * NA; ++cc) {
              const uint4 x = *reinterpret_cast<const uint4*>(vs + h16::swz(kG, tid, 8 * cc));
              const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 a = h16::unpack<T>(w[e]);
                vn = fmaf(a.x, a.x, fmaf(a.y, a.y, vn));
              }
            }
          }
#pragma unroll
          for (int off = 16; off > 0; off /= 2)
            vn = fmaxf(vn, __shfl_xor_sync(0xffffffffu, vn, off));
          if (lane == 0) maxes_s[kT / 32 + tid / 32] = fmaxf(maxes_s[kT / 32 + tid / 32], vn);
          __syncthreads();
        }
      }

      // delta = rowsum(dO * O) in float32, kRowThreads threads a row, each
      // over its columns in order, then a butterfly over them; and the
      // tile's lse in log2 units.  fp16: dO over the head's divisor first,
      // in place (every dO value of the tile passes here once)
      {
        const int row = tid / kRowThreads, part = tid % kRowThreads;
        const float inv = kGuard ? __frcp_rn(head_div()) : 1.f;
        float sum = 0.f;
#pragma unroll
        for (int cc = 0; cc < kRowChunks; ++cc) {
          const uint32_t off = h16::swz(kBM, row, 8 * (kRowChunks * part + cc));
          const uint4 ov = *reinterpret_cast<const uint4*>(os + off);
          uint4 gv = *reinterpret_cast<const uint4*>(dos + off);
          uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = h16::unpack<T>(ow[e]);
            float2 b = h16::unpack<T>(gw[e]);
            if constexpr (kGuard) {
              gw[e] = h16::pack<T>(b.x * inv, b.y * inv);
              b = h16::unpack<T>(gw[e]);
            }
            sum = fmaf(a.x, b.x, sum);
            sum = fmaf(a.y, b.y, sum);
          }
          if constexpr (kGuard)
            *reinterpret_cast<uint4*>(dos + off) = make_uint4(gw[0], gw[1], gw[2], gw[3]);
        }
#pragma unroll
        for (int off = 1; off < kRowThreads; off *= 2)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (part == 0) delta_s[row] = sum;
        if (tid < kBM) lse_t[tid] *= tf32::kLog2e;
        if constexpr (kGuard) h16::proxy_fence();  // (the scaled dO, for the products)
        __syncthreads();
      }

      // the warpgroup's 64 keys against the tile's queries, kBN at a time.
      // Every warpgroup computes, whether or not its keys are live (keys
      // past N give zeros): no branch may part a chain of products, or the
      // compiler serialises them.
#pragma unroll 1
      for (int hq = 0; hq < kBM / kBN; ++hq) {
#pragma unroll
        for (int cw = 0; cw < kCW; ++cw) {
          const int cc = wg + kW * cw;               // the chunk: keys 64 cc ..
          const int kr0 = 64 * cc + 16 * warp + g;  // the thread's first key row in the group
          const bool rows_held = 4 * cc + warp < KC;  // the warp's 16 keys are rows of the group
          // S^T = K Q^T and dP^T = V dO^T: 64 keys x kBN queries
          float sT[kBN / 2], dpT[kBN / 2];
          h16::fence();
#pragma unroll
          for (int kk = 0; kk < 4 * NA; ++kk) {
            const int atom = kk / 4, col = (kk % 4) * 32;
            const int krow = atom * kG * 128 + cc * 64 * 128 + col;
            const int qrow = atom * kBM * 128 + hq * kBN * 128 + col;
            h16::wgmma_ss<T, 0, 0>(sT, h16::desc(ks + krow, 16, 1024),
                                   h16::desc(qs + qrow, 16, 1024), kk > 0);
            h16::wgmma_ss<T, 0, 0>(dpT, h16::desc(vs + krow, 16, 1024),
                                   h16::desc(dos + qrow, 16, 1024), kk > 0);
          }
          h16::commit();
          h16::wait<0>();
          h16::fence_operand(sT);
          h16::fence_operand(dpT);

          // P^T and dS^T in float32: value 4j + e is key row kr0 + 8 (e / 2),
          // query kBN hq + 8j + 2t + (e & 1) of the tile; keys and queries
          // past N give 0
#pragma unroll
          for (int j = 0; j < kNG; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = kBN * hq + 8 * j + 2 * t + (e & 1);
              const bool live = q0 + col < n && key0 + kr0 + 8 * (e / 2) < n;
              const float p =
                  live ? h16::exp2_ftz(fmaf(sT[4 * j + e], scale_log2, -lse_t[col])) : 0.f;
              sT[4 * j + e] = p;  // (rows past the group read other memory: select, not scale)
              dpT[4 * j + e] = live ? p * (dpT[4 * j + e] - delta_s[col]) : 0.f;
            }
          }

          // P^T and dS^T rounded to T as the A operands of dV += P^T dO and
          // dK += dS^T Q, 16 queries a step, as one chain; dS^T, rounded to
          // T, into the [key][query] tile while the products run (the A
          // operand's pairs as they are).
          const bool first = it == 0 && hq == 0;  // the accumulators start here
          uint32_t pa[kNQ][4], da[kNQ][4];
#pragma unroll
          for (int kq = 0; kq < kNQ; ++kq) {
            h16::pack_a<T>(pa[kq], &sT[8 * kq]);
            h16::pack_a<T>(da[kq], &dpT[8 * kq]);
          }
          h16::fence();
#pragma unroll
          for (int kq = 0; kq < kNQ; ++kq) {
            const int qrow = (kBN * hq + 16 * kq) * 128;
#pragma unroll
            for (int a = 0; a < NA; ++a) {
              h16::wgmma_rs<T, 1>(dv_acc[cw][a], pa[kq],
                                  h16::desc(dos + a * kBM * 128 + qrow, kBM * 128, 1024),
                                  !first || kq > 0);
              h16::wgmma_rs<T, 1>(dk_acc[cw][a], da[kq],
                                  h16::desc(qs + a * kBM * 128 + qrow, kBM * 128, 1024),
                                  !first || kq > 0);
            }
          }
          h16::commit();
          if (rows_held) {
#pragma unroll
            for (int j = 0; j < kNG; ++j)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                *reinterpret_cast<uint32_t*>(
                    ds_t + h16::swz(kG, kr0 + 8 * r, kBN * hq + 8 * j + 2 * t)) =
                    da[j / 2][(j % 2) * 2 + r];
          }
          h16::wait<0>();
#pragma unroll
          for (int a = 0; a < NA; ++a) {
            h16::fence_operand(dv_acc[cw][a]);
            h16::fence_operand(dk_acc[cw][a]);
          }
        }
      }

      // the last tile's dQ, whose dS every warpgroup wrote before this
      // tile's barrier
      if (it > 0) dq_tile(it - 1, kg);
    }
    h16::proxy_fence();
    __syncthreads();  // the last tile's dS is whole
    dq_tile(q_tiles - 1, kg);

    // the group's dK (times scale) and dV, fp16 times the head's divisor,
    // rows past N left out
    const float vscale = kGuard ? head_div() : 1.f, kscale = scale * vscale;
#pragma unroll
    for (int cw = 0; cw < kCW; ++cw)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 64 * (wg + kW * cw) + 16 * warp + g + 8 * r;
        if (key >= n) continue;
        T* dkr = dk + head + static_cast<size_t>(key) * d;
        T* dvr = dv + head + static_cast<size_t>(key) * d;
#pragma unroll
        for (int a = 0; a < NA; ++a)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = 64 * a + 8 * j + 2 * t;
            h16::store_pair(dkr, col, d, dk_acc[cw][a][4 * j + 2 * r] * kscale,
                            dk_acc[cw][a][4 * j + 2 * r + 1] * kscale);
            h16::store_pair(dvr, col, d, dv_acc[cw][a][4 * j + 2 * r] * vscale,
                            dv_acc[cw][a][4 * j + 2 * r + 1] * vscale);
          }
      }
  }
  tf32::cp_wait<0>();
}

// The float32 dQ sums where one block cannot hold a head's keys.
long long dq_elems(long long bh, int n, int d) {
  return n > (d > 64 ? Layout<2, 8>::kG : Layout<1, 16>::kG) ? bh * n * d : 0;
}

template <typename T, int NA, int KC>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* scratch, void* dq, void* dk,
                   void* dv, long long bh, int n, int d, float scale, bool vec,
                   cudaStream_t stream) {
  using L = Layout<NA, KC>;
  if (bh > INT_MAX) return cudaErrorInvalidConfiguration;
  if (n > L::kG && scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_h16_bwd_kernel<T, NA, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  attention_h16_bwd_kernel<T, NA, KC><<<static_cast<unsigned>(bh), kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, scratch, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), n, d, scale, scale * tf32::kLog2e, vec);
  return cudaGetLastError();
}

// Key groups of 208 keys (N <= 208, D <= 64: its dQ takes 13 16-key steps,
// not 16), of 256 (D <= 64) or of 128 (D > 64).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* scratch, void* dq, void* dk,
                     void* dv, long long bh, int n, int d, float scale, bool vec,
                     cudaStream_t s) {
  if (d > 64)
    return launch<T, 2, 8>(q, k, v, o, dout, lse, scratch, dq, dk, dv, bh, n, d, scale, vec, s);
  if (n <= 208)
    return launch<T, 1, 13>(q, k, v, o, dout, lse, scratch, dq, dk, dv, bh, n, d, scale, vec,
                            s);
  return launch<T, 1, 16>(q, k, v, o, dout, lse, scratch, dq, dk, dv, bh, n, d, scale, vec, s);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The float32 elements of scratch that attention_h16_bwd needs for (B H, N,
// D): B H N D for dQ's sums over key groups where one block cannot hold a
// head's keys (N > 256; N > 128 at D > 64), else 0.
extern "C" long long attention_h16_bwd_scratch(long long bh, int n, int d) {
  return dq_elems(bh, n, d);
}

// C entry for ctypes.  bh = B * H; q, k, v, o (the forward's output), dout,
// dq, dk, dv are device pointers to contiguous (B, H, N, D) tensors of one
// 16-bit type, `element` 0 for fp16 and 1 for bf16; lse (the forward's
// log-sum-exp) is (B, H, N) float32; scratch is null, or float32 memory of
// attention_h16_bwd_scratch(bh, n, d) elements where that is not 0; stream
// is a cudaStream_t.  Launches one kernel on the stream.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int attention_h16_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* scratch, void* dq,
                                 void* dk, void* dv, long long bh, int n, int d, float scale,
                                 int element, void* stream) {
  if (bh <= 0 || n <= 0 || d <= 0 || d > 128 || (element != 0 && element != 1))
    return cudaErrorInvalidValue;
  if (attention_h16_bwd_scratch(bh, n, d) > 0 && scratch == nullptr)
    return cudaErrorInvalidValue;
  // 16-byte row chunks when every row starts 16-byte aligned
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(o) && aligned16(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fs = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  if (element == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, fl, fs, dq, dk, dv, bh, n, d, scale, vec,
                                   s);
  return dispatch<__half>(q, k, v, o, dout, fl, fs, dq, dk, dv, bh, n, d, scale, vec, s);
}

extern "C" const char* attention_h16_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
