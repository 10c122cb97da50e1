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
// What bounds it.  #4 holds a whole window, its P and its dS in one block's
// shared memory and sums the bias gradient of a chunk of windows in
// registers, 32 floats a lane.  At N = 256 a head's P alone is 256 KB, and
// a block that sums dS over windows for all 256 x 256 entries of a pattern
// would hold 128 floats a lane.  On an H100 SXM at stage 1 of SwinV2-B/w16
// at batch 256 (4,096 windows x 4 heads, N = 256, D = 32):
//   operations: the five products of the VJP, 10*N^2*D = 21 MFLOP a
//          (window, head), 344 GFLOP: in 3xTF32 3 x 344 GFLOP at the
//          tensor cores' 495 TFLOP/s = 2.08 ms;
//   bytes: q, k, v, dO read once, dq, dk, dv written once, the bias and its
//          gradient: 3.76 GB, 1.12 ms at 3.35 TB/s.
// Bound by operations.
//
// Design: four kernels in order on the stream, no atomics, every sum in a
// fixed order, so two runs give bit-identical gradients:
//   1. tiled_delta_kernel: delta = rowsum(dO * O), one warp a row.
//   2. tiled_dkdv_db_kernel, key-major: a block of four warps owns 64 keys
//      of one (pattern, head) and walks a chunk of the pattern's windows; each warp
//      owns 16 keys.  For each window it reads its keys' K and V once, as
//      split TF32 fragments kept in registers (64 a lane at D = 32), and
//      walks 16-row query tiles (Q, dO, lse, delta and the bias tile
//      through a two-stage cp.async ring): S^T = K Q^T + bias^T, P^T =
//      exp(S^T - lse), dP^T = V dO^T, dS^T = P^T (dP^T - delta), dV += P^T
//      dO, dK += dS^T Q, and dS^T is added into the block's running sum of
//      the bias gradient in shared memory ([64 keys][256 + 8] floats, each
//      entry owned by one lane).  After the chunk the block writes that sum
//      as the chunk's partial (P, chunks, H, N, N).
//   3. tiled_dq_kernel, query-major: a block of four warps owns 64 query
//      rows of one (window, head); over 32-key tiles (K, V and the bias tile through
//      a ring) it recomputes S, P, dP and dS in registers and accumulates dQ
//      += dS K, dS straight from the registers (tf32_mma.cuh's k
//      permutation).
//   4. tiled_db_reduce_kernel: one thread a bias entry adds the chunks'
//      partials in chunk order.
// Seven products against the VJP's five: dS is recomputed in the dQ pass
// rather than written (a (BW, H, N, N) scratch would be 4.3 GB at stage 1
// and twice its size in traffic).  Every product in 3xTF32 on the tensor
// cores (mma.sync m16n8k8), as #4's.  The bias gradient's partials are 1/C
// of every window's dS (the wrapper picks C, about 1,000 blocks or more a
// launch, at most 32).  tiled_dkdv_db_kernel's 104 KB of shared memory at
// D = 32 (the sum 68 KB) leave two blocks an SM, so the keys' fragments live in
// registers (at most 255 a lane), and the next window's K and V land in the
// one shared tile while this window computes.  Every parameter is a kernel
// argument, held in registers: no parameter is read through shared memory
// across a barrier.  Query rows and keys past N: zero-filled tiles, P = 0
// where a row or key is past N, nothing stored for them.
// Left for later work: wgmma; one pass that writes dS of a chunk of windows
// once, which would leave five products.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <math.h>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = tf32::kMaxWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kMaxN = 256;

// ---- tiled_dkdv_db_kernel
constexpr int kKeys = 16 * kWarps;  // keys a block
constexpr int kBQ = 16;             // query rows a ring step
constexpr int kNQ = kBQ / 8;
constexpr int kLdBT = kKeys + 4;    // the bias tile [kBQ][kKeys]: conflict-free transposed reads
constexpr int kLdDb = kMaxN + 8;    // the sum [kKeys][kMaxN]: conflict-free float2 updates

// ---- tiled_dq_kernel
constexpr int kBK = 32;             // keys a tile
constexpr int kNK = kBK / 8;
constexpr int kRows = 16 * kWarps;  // query rows a block
constexpr int kLdB = kBK + 8;       // the bias tile [kRows][kBK]: conflict-free float2 reads

// Shared memory, in floats, of tiled_dkdv_db_kernel: the sum [kKeys][kLdDb],
// K and V [kKeys][ld], then per stage Q, dO [kBQ][ld], lse, delta [kBQ] and
// the bias tile [kBQ][kLdBT].
template <int NC>
constexpr int dkdv_smem_floats() {
  return kKeys * kLdDb + 2 * kKeys * (16 * NC + 4) +
         kStages * (2 * kBQ * (16 * NC + 4) + 2 * kBQ + kBQ * kLdBT);
}

// Shared memory, in floats, of tiled_dq_kernel: Q, dO [kRows][ld], then per
// stage K, V [kBK][ld] and the bias tile [kRows][kLdB].
template <int NC>
constexpr int dq_smem_floats() {
  return 2 * kRows * (16 * NC + 4) + kStages * (2 * kBK * (16 * NC + 4) + kRows * kLdB);
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
__global__ void __launch_bounds__(kThreads, 2)
    tiled_dkdv_db_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dk,
                         float* __restrict__ dv, float* __restrict__ partial, int h, int n,
                         int d, int npat, int per_pattern, int chunk, int chunks,
                         int k_tiles) {
  constexpr int kDp = 16 * NC;
  constexpr int kLd = kDp + 4;
  constexpr int kDT = kDp / 8;
  constexpr int kStage = 2 * kBQ * kLd + 2 * kBQ + kBQ * kLdBT;
  extern __shared__ float smem[];
  float* dbs = smem;                  // [kKeys][kLdDb]
  float* kks = dbs + kKeys * kLdDb;   // [kKeys][kLd]
  float* vvs = kks + kKeys * kLd;     // [kKeys][kLd]
  float* ring = vvs + kKeys * kLd;    // stage s at ring + s kStage

  // blockIdx.x = ((p * chunks + ch) * h + head) * k_tiles + key tile: the
  // layout of the partials, (P, chunks, H, N, N)
  const int kt = blockIdx.x % k_tiles;
  const int phc = blockIdx.x / k_tiles;  // (p * chunks + ch) * h + head
  const int head = phc % h, ch = phc / h % chunks, p = phc / h / chunks;
  const int k0 = kt * kKeys;
  const int t0 = ch * chunk, t_end = min(per_pattern, t0 + chunk);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wk = 16 * warp;  // the warp's first key in the block's 64
  const bool warp_live = k0 + wk < n;
  const int q_tiles = (n + kBQ - 1) / kBQ;
  const size_t nd = static_cast<size_t>(n) * d;
  const float* bh = bias + (static_cast<size_t>(p) * h + head) * n * n;
  auto unit = [&](int tw) {  // (window, head) index of the chunk's window tw
    return (p + static_cast<size_t>(tw) * npat) * h + head;
  };
  auto load_kv = [&](int tw) {
    const size_t b = unit(tw) * nd;
    tf32::load_tile_async<kDp>(kks, k + b, k0, kKeys, n, d, tid, kThreads);
    tf32::load_tile_async<kDp>(vvs, v + b, k0, kKeys, n, d, tid, kThreads);
  };
  auto load_stage = [&](int step) {
    const int tw = t0 + step / q_tiles, it = step % q_tiles;
    float* st = ring + (step % kStages) * kStage;
    const size_t u = unit(tw);
    tf32::load_tile_async<kDp>(st, q + u * nd, it * kBQ, kBQ, n, d, tid, kThreads);
    tf32::load_tile_async<kDp>(st + kBQ * kLd, dout + u * nd, it * kBQ, kBQ, n, d, tid,
                               kThreads);
    tf32::load_vec_async(st + 2 * kBQ * kLd, lse + u * n, it * kBQ, kBQ, n, tid, kThreads);
    tf32::load_vec_async(st + 2 * kBQ * kLd + kBQ, delta + u * n, it * kBQ, kBQ, n, tid,
                         kThreads);
    tf32::load_block_async<kKeys, kLdBT>(st + 2 * kBQ * kLd + 2 * kBQ, bh, n, it * kBQ, k0,
                                         kBQ, n, n, tid, kThreads);
  };
  for (int i = tid; i < kKeys * kLdDb; i += kThreads) dbs[i] = 0.f;
  load_kv(t0);
  load_stage(0);
  tf32::cp_commit();

  tf32::AFrag kf[kDT], vf[kDT];  // the warp's keys and values, split
  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int c = 0; c < kDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  const int steps = (t_end - t0) * q_tiles;
  for (int step = 0; step < steps; ++step) {
    const int tw = t0 + step / q_tiles, it = step % q_tiles;
    tf32::cp_wait<0>();  // step `step` has landed, for every thread, and
    __syncthreads();     // step - 1 is consumed
    if (it == 0) {
      // this window's keys and values into registers; then their tile is
      // free for the next window's
#pragma unroll
      for (int ks8 = 0; ks8 < kDT; ++ks8) {
        kf[ks8] = tf32::a_frag_rows(kks, kLd, wk, 8 * ks8, g, t);
        vf[ks8] = tf32::a_frag_rows(vvs, kLd, wk, 8 * ks8, g, t);
      }
      __syncthreads();
      if (tw + 1 < t_end) load_kv(tw + 1);
    }
    if (step + 1 < steps) load_stage(step + 1);
    tf32::cp_commit();

    const float* qs = ring + (step % kStages) * kStage;
    const float* dos = qs + kBQ * kLd;
    const float* lse_s = dos + kBQ * kLd;
    const float* delta_s = lse_s + kBQ;
    const float* bts = delta_s + kBQ;  // bias[q0 + r][k0 + c] at r * kLdBT + c
    const int q0 = it * kBQ;
    const int qn = min(kBQ, n - q0);  // live query rows of the tile
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int live_nt = kFull ? kNQ : (qn + 7) / 8;

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
      float s[kNQ][4], dp[kNQ][4];
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks8 = 0; ks8 < kDT; ++ks8) {
        tf32::BFrag b[kNQ];
        tf32::b_frags_t(b, qs, kLd, 8 * ks8, g, t, live_nt);
        tf32::mma3(s, kf[ks8], b, live_nt);
        tf32::b_frags_t(b, dos, kLd, 8 * ks8, g, t, live_nt);
        tf32::mma3(dp, vf[ks8], b, live_nt);
      }
      // P^T = exp(S^T + bias^T - lse) of each column's query row, dS^T =
      // P^T (dP^T - delta), added into the sum; query rows past N get 0
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1), key = wk + g + 8 * (e / 2);
          const bool live = kFull || (j < live_nt && col < qn);
          const float p = live ? exp2f((s[j][e] + bts[col * kLdBT + key] - lse_s[col]) *
                                       tf32::kLog2e)
                               : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[col]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2* at = reinterpret_cast<float2*>(dbs + (wk + g + 8 * r) * kLdDb + q0 + 8 * j +
                                                 2 * t);
          float2 sum = *at;
          sum.x += dp[j][2 * r];
          sum.y += dp[j][2 * r + 1];
          *at = sum;
        }
      }
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
        if (j < live_nt) {
          const tf32::AFrag ap = tf32::a_frag_perm(s[j]);
          const tf32::AFrag ad = tf32::a_frag_perm(dp[j]);
          tf32::BFrag b[kDT];
          tf32::b_frags_perm(b, dos, kLd, 8 * j, g, t);
          tf32::mma3(dv_acc, ap, b, kDT);
          tf32::b_frags_perm(b, qs, kLd, 8 * j, g, t);
          tf32::mma3(dk_acc, ad, b, kDT);
        }
      }
    };
    if (warp_live) {
      if (qn == kBQ)
        tile(std::true_type{});
      else
        tile(std::false_type{});
    }

    if (it == q_tiles - 1 && warp_live) {  // the window's last query tile
      const size_t b = unit(tw) * nd;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = k0 + wk + g + 8 * r;
        if (key >= n) continue;
        float* dkr = dk + b + static_cast<size_t>(key) * d;
        float* dvr = dv + b + static_cast<size_t>(key) * d;
#pragma unroll
        for (int c = 0; c < kDT; ++c) {
          const int col = 8 * c + 2 * t;
          if (col < d) {
            dkr[col] = dk_acc[c][2 * r];
            dvr[col] = dv_acc[c][2 * r];
          }
          if (col + 1 < d) {
            dkr[col + 1] = dk_acc[c][2 * r + 1];
            dvr[col + 1] = dv_acc[c][2 * r + 1];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kDT; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;
    }
  }
  tf32::cp_wait<0>();
  __syncthreads();  // every lane's part of the sum is in shared memory

  // the chunk's partial, rows of the pattern's (N, N) tile, columns k0 ..
  float* out = partial + static_cast<size_t>(phc) * n * n;
  const int kn = min(kKeys, n - k0);
  for (int i = tid; i < n * kKeys; i += kThreads) {
    const int row = i / kKeys, c = i % kKeys;
    if (c < kn) out[static_cast<size_t>(row) * n + k0 + c] = dbs[c * kLdDb + row];
  }
}

// dQ = dS K for 64 query rows of one (window, head).
template <int NC>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 3 : 2)
    tiled_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int h, int n,
                    int d, int npat, int q_tiles) {
  constexpr int kDp = 16 * NC;
  constexpr int kLd = kDp + 4;
  constexpr int kDT = kDp / 8;
  constexpr int kStage = 2 * kBK * kLd + kRows * kLdB;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kRows][kLd]
  float* dos = qs + kRows * kLd;     // [kRows][kLd]
  float* ring = dos + kRows * kLd;   // stage s: K, V, bias at ring + s kStage

  // blockIdx.x = (w * h + head) * q_tiles + query tile
  const int wh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kRows;
  const int head = wh % h, p = (wh / h) % npat;
  const size_t base = static_cast<size_t>(wh) * n * d;
  const float* kh = k + base;
  const float* vh = v + base;
  const float* bh = bias + (static_cast<size_t>(p) * h + head) * n * n;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;
  const bool warp_live = q0 + wr < n;
  const int k_tiles = (n + kBK - 1) / kBK;

  auto load_stage = [&](int j) {
    float* st = ring + (j % kStages) * kStage;
    tf32::load_tile_async<kDp>(st, kh, j * kBK, kBK, n, d, tid, kThreads);
    tf32::load_tile_async<kDp>(st + kBK * kLd, vh, j * kBK, kBK, n, d, tid, kThreads);
    tf32::load_block_async<kBK, kLdB>(st + 2 * kBK * kLd, bh, n, q0, j * kBK, kRows, n, n, tid,
                                      kThreads);
  };
  tf32::load_tile_async<kDp>(qs, q + base, q0, kRows, n, d, tid, kThreads);
  tf32::load_tile_async<kDp>(dos, dout + base, q0, kRows, n, d, tid, kThreads);
  load_stage(0);
  tf32::cp_commit();

  // lse and delta of rows g and g + 8 of the warp's 16 (0 past N)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    const bool live = row < n;
    row_lse[r] = live ? __ldg(lse + static_cast<size_t>(wh) * n + row) : 0.f;
    row_delta[r] = live ? __ldg(delta + static_cast<size_t>(wh) * n + row) : 0.f;
  }

  float acc[kDT][4];
#pragma unroll
  for (int c = 0; c < kDT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    tf32::cp_wait<0>();
    __syncthreads();
    if (kt + 1 < k_tiles) load_stage(kt + 1);
    tf32::cp_commit();

    const float* ks = ring + (kt % kStages) * kStage;
    const float* vs = ks + kBK * kLd;
    const float* bs = vs + kBK * kLd;
    const int kn = min(kBK, n - kt * kBK);
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int live_nt = kFull ? kNK : (kn + 7) / 8;

      // S = Q K^T and dP = dO V^T for the warp's 16 rows
      float s[kNK][4], dp[kNK][4];
#pragma unroll
      for (int j = 0; j < kNK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks8 = 0; ks8 < kDT; ++ks8) {
        tf32::BFrag b[kNK];
        const tf32::AFrag aq = tf32::a_frag_rows(qs, kLd, wr, 8 * ks8, g, t);
        tf32::b_frags_t(b, ks, kLd, 8 * ks8, g, t, live_nt);
        tf32::mma3(s, aq, b, live_nt);
        const tf32::AFrag ag = tf32::a_frag_rows(dos, kLd, wr, 8 * ks8, g, t);
        tf32::b_frags_t(b, vs, kLd, 8 * ks8, g, t, live_nt);
        tf32::mma3(dp, ag, b, live_nt);
      }
      // dS = P (dP - delta), P = exp(S + bias - lse); keys past N get 0
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 b2 =
              *reinterpret_cast<const float2*>(bs + (wr + g + 8 * r) * kLdB + 8 * j + 2 * t);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * r + c;
            const bool live = kFull || (j < live_nt && 8 * j + 2 * t + c < kn);
            const float p =
                live ? exp2f((s[j][e] + (c ? b2.y : b2.x) - row_lse[r]) * tf32::kLog2e) : 0.f;
            dp[j][e] = p * (dp[j][e] - row_delta[r]);
          }
        }
      }
      // dQ += dS K, dS straight from the registers
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
        if (j < live_nt) {
          const tf32::AFrag a = tf32::a_frag_perm(dp[j]);
          tf32::BFrag b[kDT];
          tf32::b_frags_perm(b, ks, kLd, 8 * j, g, t);
          tf32::mma3(acc, a, b, kDT);
        }
      }
    };
    if (warp_live) {
      if (kn == kBK)
        tile(std::true_type{});
      else
        tile(std::false_type{});
    }
  }
  tf32::cp_wait<0>();

  if (!warp_live) return;
  float* dqh = dq + base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kDT; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < d) dqh[static_cast<size_t>(row) * d + col] = acc[c][2 * r];
      if (col + 1 < d) dqh[static_cast<size_t>(row) * d + col + 1] = acc[c][2 * r + 1];
    }
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
  const long long rows = a.bw * a.h * a.n;
  const long long per_pattern = a.bw / a.npat;
  const long long chunks = (per_pattern + a.chunk - 1) / a.chunk;
  const int k_tiles = (a.n + kKeys - 1) / kKeys;
  const int q_tiles = (a.n + kRows - 1) / kRows;
  const long long dkdv_blocks = a.npat * chunks * a.h * k_tiles;
  const long long dq_blocks = a.bw * a.h * q_tiles;
  const long long delta_blocks = (rows * 32 + kSmallThreads - 1) / kSmallThreads;
  const long long total = static_cast<long long>(a.npat) * a.h * a.n * a.n;
  const long long reduce_blocks = (total + kSmallThreads - 1) / kSmallThreads;
  if (std::max({dkdv_blocks, dq_blocks, delta_blocks, reduce_blocks, per_pattern}) > INT_MAX)
    return cudaErrorInvalidConfiguration;
  const int dkdv_bytes = dkdv_smem_floats<NC>() * static_cast<int>(sizeof(float));
  const int dq_bytes = dq_smem_floats<NC>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      tiled_dkdv_db_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tiled_dq_kernel<NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dq_bytes);
  if (err != cudaSuccess) return err;

  tiled_delta_kernel<<<static_cast<unsigned>(delta_blocks), kSmallThreads, 0, stream>>>(
      a.o, a.dout, a.delta, rows, a.d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dkdv_db_kernel<NC>
      <<<static_cast<unsigned>(dkdv_blocks), kThreads, dkdv_bytes, stream>>>(
      a.q, a.k, a.v, a.bias, a.dout, a.lse, a.delta, a.dk, a.dv, a.partial, a.h, a.n, a.d,
      a.npat, static_cast<int>(per_pattern), a.chunk, static_cast<int>(chunks), k_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tiled_dq_kernel<NC><<<static_cast<unsigned>(dq_blocks), kThreads, dq_bytes, stream>>>(
      a.q, a.k, a.v, a.bias, a.dout, a.lse, a.delta, a.dq, a.h, a.n, a.d, a.npat, q_tiles);
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
  switch ((d + 15) / 16) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 3: return launch<3>(a, s);
    default: return launch<4>(a, s);
  }
}

extern "C" const char* window_attention_tiled_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
