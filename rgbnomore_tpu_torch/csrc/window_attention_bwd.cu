// Swin window attention, backward.  For O = softmax(S) V with
// S = Q K^T + bias[w % P] per window w and head, and the output's gradient
// dO:
//   P  = softmax(S)                      (recomputed from q, k and the bias)
//   dV = P^T dO
//   dP = dO V^T
//   dS = P * (dP - rowsum(dP * P))
//   dQ = dS K,  dK = dS^T Q
//   dbias[p] = sum of dS over every window w with w % P == p
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:
// _win_bwd_kernel (:170-203), which _win_bwd (:267-309) launches as
// fused_window_attention's VJP.  The TPU kernel ran a sequential grid whose
// innermost axis walked the window pairs of one pattern and accumulated the
// bias gradient in VMEM.  Here blocks run in parallel and in no order, so
// the bias gradient is summed in two fixed-order passes and without float
// atomics, and gradients repeat bit for bit from run to run:
//   1. window_bwd_kernel: one block per (pattern p, chunk of C windows of
//      that pattern, head).  It walks its windows in order, writes each
//      one's dq, dk, dv, keeps the running sum of their dS in registers and
//      writes it once, as the chunk's partial (P, chunks, H, N, N).
//   2. db_reduce_kernel: one thread per bias entry adds the chunks'
//      partials in chunk order.
// Writing every window's dS instead would cost 400 MB of scratch and about
// 0.8 GB of traffic at stage 1 of SwinV2-T at batch 128; the partials cost
// 1/C of that (the wrapper picks C, about 1,000 blocks or more per launch).
// q, k, v, dout, dq, dk, dv are (BW, H, N, D) float32, contiguous, N <= 64,
// D <= 64; bias, db are (P, H, N, N); BW % P == 0.
//
// Bounds on an H100 SXM at N = 64, D = 32, stage 1 of SwinV2-T at batch 128
// (24,576 (window, head) units):
//   bytes: q, k, v, dO read once, dq, dk, dv written once, 7 * N*D * 4 B =
//          56 KB a unit, 1.41 GB: 0.421 ms at 3.35 TB/s (the bias and its
//          gradient are small, and the bias is read once a block);
//   operations: the five products (QK^T, dO V^T, P^T dO, dS K, dS^T Q),
//          10*N^2*D = 1.31 MFLOP a unit, 32.2 GFLOP: 0.481 ms at the 67
//          TFLOP/s of the float32 CUDA cores, or 3 * 32.2 GFLOP at the
//          tensor cores' 495 TFLOP/s in 3xTF32 (tf32_mma.cuh) = 0.195 ms.
// On the CUDA cores the kernel was bound by operations; in 3xTF32 it is
// bound by bytes, 2.2x above its operation bound.
//
// What the design does about that bound:
//   - All five products on the tensor cores in 3xTF32 (mma.sync m16n8k8),
//     each warp owning 16 query rows of the window (four warps at N = 64).
//     S and dP stay in the warp's registers; the row max, sum and
//     rowsum(dP * P) are quad shuffles; dQ = dS K takes dS from the
//     registers as its A operand (tf32_mma.cuh's k permutation), since a
//     warp's rows are its own.
//   - dV = P^T dO and dK = dS^T Q sum over every query row, so P and dS
//     pass through shared memory once ([16 JG][16 JG + 4], written from the
//     C fragments, one barrier); after it each warp computes dQ, then owns
//     16 keys and reads P^T
//     and dS^T as A fragments (a_frag_t_perm), dO and Q as B fragments,
//     free of bank conflicts but for a two-way one on the P and dS writes.
//     The alternative, a key-major pass that rebuilds S^T and dP^T, needs
//     two more products and the rows' softmax statistics first.
//   - Several windows a block, through a ring of two shared-memory stages
//     filled by 16-byte cp.async: window t + 1's q, dO, k, v are in flight
//     while the warps compute on window t.  106 KB of shared memory at
//     D = 32 (the ring 72 KB, P and dS 34 KB) and 210 registers (no spill)
//     leave two blocks of 128 threads an SM.  A block of eight warps, each
//     on half of the keys (128 registers, two such blocks an SM, the rows'
//     softmax statistics met in shared memory behind two more barriers),
//     ran slower on the H100.
//   - dq, dv and dk leave through the warp's own rows of the window's v
//     tile, which no warp reads after the barrier that publishes P and dS:
//     whole rows in 16-byte stores instead of two 4-byte stores per
//     fragment pair, which ran markedly faster on the H100 (the forward,
//     with one output, gained nothing from it and stores directly).
//   - The bias read once a block, into registers (the thread's C fragment,
//     -inf past N's keys, which masks them), beside the running sum of dS.
//   - N is padded to 16-row warp tiles and D to 16 columns in shared memory
//     only (zero-filled by the copies); P and dS of rows past N are zero.
//   - Every parameter is a kernel argument, held in registers: no parameter
//     is read through shared memory across a barrier.
// What holds it back (41-48% of its bytes bound at stage 1): a build
// that dropped the two cross-term products of 3xTF32 ran only somewhat
// faster, so neither the tensor cores nor the bytes pace it; with
// two warps per scheduler, the latency of the chains of shared-memory
// loads, operand splits and dependent mma.sync is what is left.
// Left for later work: bf16 tensor cores (wgmma) under AMP; TMA copies.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxThreads = 32 * tf32::kMaxWarps;  // four warps: N <= 64
constexpr int kStages = 2;                         // the ring of windows

// The warp's 16 x (8 NT) C tiles c[j], rows r0 .. r0 + 15 of a row-major
// shared tile [.][ld] (ld even); every lane of the warp calls it.
template <int NT>
__device__ __forceinline__ void stash_c(float* s, int ld, int r0, const float (&c)[NT][4],
                                        int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* p = s + (r0 + g) * ld + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(c[j][0], c[j][1]);
    *reinterpret_cast<float2*>(p + 8 * ld) = make_float2(c[j][2], c[j][3]);
  }
}

// Rows r0 .. r0 + rows - 1 (columns < d) of the shared tile [.][ld] into the
// row-major (., d) matrix dst, by the 32 lanes of one warp: 16-byte stores
// of the contiguous run when d and ld are multiples of 4, else 4-byte ones.
__device__ __forceinline__ void store_rows(float* dst, const float* s, int ld, int r0, int rows,
                                           int d, int lane) {
  float* out = dst + static_cast<size_t>(r0) * d;
  if (d % 4 == 0 && ld % 4 == 0) {
    const int chunks = rows * d / 4;
    for (int i = lane; i < chunks; i += 32) {
      const int r = 4 * i / d, c = 4 * i % d;
      *reinterpret_cast<float4*>(out + 4 * i) =
          *reinterpret_cast<const float4*>(s + (r0 + r) * ld + c);
    }
  } else {
    for (int i = lane; i < rows * d; i += 32) out[i] = s[(r0 + i / d) * ld + i % d];
  }
}

// Shared memory, in floats: per stage q, dO, k, v [16 JG][16 NC + 4], then
// P and dS [16 JG][16 JG + 4].
template <int NC, int JG>
constexpr int smem_floats() {
  return kStages * 4 * 16 * JG * (16 * NC + 4) + 2 * 16 * JG * (16 * JG + 4);
}

template <int NC, int JG>
__global__ void __launch_bounds__(kMaxThreads, 2)
    window_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ dout, float* __restrict__ dq,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ partial, int h, int n, int d, int npat,
                      int per_pattern, int chunk, int chunks) {
  constexpr int kDp = 16 * NC;       // head dim, padded
  constexpr int kLd = kDp + 4;       // row stride of the q, dO, k, v tiles
  constexpr int kDT = kDp / 8;       // 8-wide column groups of the head dim
  constexpr int kRows = 16 * JG;     // tokens, padded to whole warp tiles
  constexpr int kNT = kRows / 8;     // 8-token groups
  constexpr int kLdP = kRows + 4;    // row stride of P, dS: 4 mod 16
  constexpr int kTile = kRows * kLd;
  extern __shared__ float smem[];    // stage s: q, dO, k, v at smem + 4 s kTile
  float* ps = smem + kStages * 4 * kTile;  // [kRows][kLdP]
  float* dss = ps + kRows * kLdP;          // [kRows][kLdP]

  // blockIdx.x = (p * chunks + ch) * h + head: the layout of the partials
  const int head = blockIdx.x % h;
  const int p = blockIdx.x / h / chunks, ch = blockIdx.x / h % chunks;
  const int t0 = ch * chunk, t_end = min(per_pattern, t0 + chunk);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;  // the warp's first query row, and first key
  const size_t nd = static_cast<size_t>(n) * d;
  auto base = [&](int tw) {
    return (static_cast<size_t>(p + static_cast<long long>(tw) * npat) * h + head) * nd;
  };
  auto load = [&](int tw, int stage) {
    float* st = smem + stage * 4 * kTile;
    const size_t b = base(tw);
    tf32::load_tile_async<kDp>(st, q + b, 0, kRows, n, d, tid, nthreads);
    tf32::load_tile_async<kDp>(st + kTile, dout + b, 0, kRows, n, d, tid, nthreads);
    tf32::load_tile_async<kDp>(st + 2 * kTile, k + b, 0, kRows, n, d, tid, nthreads);
    tf32::load_tile_async<kDp>(st + 3 * kTile, v + b, 0, kRows, n, d, tid, nthreads);
  };
  load(t0, 0);
  tf32::cp_commit();

  // the pattern's bias, this thread's C fragment of it (-inf past N's
  // keys), and the running sum of dS over the block's windows
  const float* bp = bias + (static_cast<size_t>(p) * h + head) * n * n;
  float bias_c[kNT][4], db[kNT][4];
  bool row_live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_live[r] = wr + g + 8 * r < n;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wr + g + 8 * (e / 2), col = 8 * j + 2 * t + (e & 1);
      bias_c[j][e] = col >= n ? -INFINITY : row < n ? __ldg(bp + row * n + col) : 0.f;
      db[j][e] = 0.f;
    }

  for (int tw = t0; tw < t_end; ++tw) {
    const int stage = (tw - t0) % kStages;
    tf32::cp_wait<0>();  // window tw has landed, for every thread; the stage
    __syncthreads();     // of window tw - 1, P and dS are no longer read
    if (tw + 1 < t_end) load(tw + 1, stage ^ 1);
    tf32::cp_commit();
    const float* qs = smem + stage * 4 * kTile;
    const float* dos = qs + kTile;
    const float* ks = dos + kTile;
    float* vs = smem + stage * 4 * kTile + 3 * kTile;

    // S = Q K^T and dP = dO V^T for the warp's 16 rows
    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks8 = 0; ks8 < kDT; ++ks8) {
      tf32::BFrag b[kNT];
      const tf32::AFrag aq = tf32::a_frag_rows(qs, kLd, wr, 8 * ks8, g, t);
      tf32::b_frags_t(b, ks, kLd, 8 * ks8, g, t, kNT);
      tf32::mma3(s, aq, b, kNT);
      const tf32::AFrag ag = tf32::a_frag_rows(dos, kLd, wr, 8 * ks8, g, t);
      tf32::b_frags_t(b, vs, kLd, 8 * ks8, g, t, kNT);
      tf32::mma3(dp, ag, b, kNT);
    }

    // P = softmax(S + bias), dS = P (dP - rowsum(dP P)); rows past N get 0
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += bias_c[j][e];
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - mx[e / 2]) * tf32::kLog2e);
        sum[e / 2] += s[j][e];
      }
    float inv[2], delta[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      inv[r] = row_live[r] ? 1.f / sum[r] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= inv[e / 2];
        delta[e / 2] = fmaf(s[j][e], dp[j][e], delta[e / 2]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
      delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[j][e] = s[j][e] * (dp[j][e] - delta[e / 2]);  // dS, in place
        db[j][e] += dp[j][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (wr + g + 8 * r) * kLdP + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(ps + at) = make_float2(s[j][2 * r], s[j][2 * r + 1]);
        *reinterpret_cast<float2*>(dss + at) = make_float2(dp[j][2 * r], dp[j][2 * r + 1]);
      }
    }

    __syncthreads();  // P and dS of every row are in shared memory, and no
                      // warp reads this window's v tile any more

    // dQ = dS K, dS straight from the registers; then dV = P^T dO and
    // dK = dS^T Q for the warp's 16 keys, over every row.  Each goes out
    // through the warp's own rows of the v tile, in 16-byte stores.
    float* stash = vs;
    float* const outs[3] = {dq + base(tw), dv + base(tw), dk + base(tw)};
    const int live_rows = max(0, min(16, n - wr));
    {
      float acc[kDT][4];
#pragma unroll
      for (int c = 0; c < kDT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const tf32::AFrag a = tf32::a_frag_perm(dp[j]);
        tf32::BFrag b[kDT];
        tf32::b_frags_perm(b, ks, kLd, 8 * j, g, t);
        tf32::mma3(acc, a, b, kDT);
      }
      stash_c(stash, kLd, wr, acc, g, t);
      __syncwarp();
      store_rows(outs[0], stash, kLd, wr, live_rows, d, lane);
    }
    float av[kDT][4], ak[kDT][4];
#pragma unroll
    for (int c = 0; c < kDT; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[c][e] = ak[c][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      tf32::BFrag b[kDT];
      const tf32::AFrag ap = tf32::a_frag_t_perm(ps, kLdP, 8 * j, wr, g, t);
      tf32::b_frags_perm(b, dos, kLd, 8 * j, g, t);
      tf32::mma3(av, ap, b, kDT);
      const tf32::AFrag ad = tf32::a_frag_t_perm(dss, kLdP, 8 * j, wr, g, t);
      tf32::b_frags_perm(b, qs, kLd, 8 * j, g, t);
      tf32::mma3(ak, ad, b, kDT);
    }
    __syncwarp();  // dQ's rows are out of the stash
    stash_c(stash, kLd, wr, av, g, t);
    __syncwarp();
    store_rows(outs[1], stash, kLd, wr, live_rows, d, lane);
    __syncwarp();
    stash_c(stash, kLd, wr, ak, g, t);
    __syncwarp();
    store_rows(outs[2], stash, kLd, wr, live_rows, d, lane);
  }
  tf32::cp_wait<0>();

  float* out = partial + static_cast<size_t>(blockIdx.x) * n * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_live[r]) continue;
    const int row = wr + g + 8 * r;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < n) out[row * n + col] = db[j][2 * r];
      if (col + 1 < n) out[row * n + col + 1] = db[j][2 * r + 1];
    }
  }
}

// db[p, head, e] = sum over chunks, in order, of partial[p, chunk, head, e].
__global__ void db_reduce_kernel(const float* __restrict__ partial, float* __restrict__ db,
                                 int h, int nn, int chunks, long long total) {
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

constexpr int kReduceThreads = 256;

template <int NC, int JG>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* dout, float* partial, float* dq, float* dk, float* dv,
                   float* db, long long blocks, int h, int n, int d, int npat,
                   int per_pattern, int chunk, int chunks, cudaStream_t stream) {
  const int bytes = smem_floats<NC, JG>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(window_bwd_kernel<NC, JG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  window_bwd_kernel<NC, JG><<<static_cast<unsigned>(blocks), 32 * JG, bytes, stream>>>(
      q, k, v, bias, dout, dq, dk, dv, partial, h, n, d, npat, per_pattern, chunk, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(npat) * h * n * n;
  const long long reduce_blocks = (total + kReduceThreads - 1) / kReduceThreads;
  db_reduce_kernel<<<static_cast<unsigned>(reduce_blocks), kReduceThreads, 0, stream>>>(
      partial, db, h, n * n, chunks, total);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_jg(const float* q, const float* k, const float* v, const float* bias,
                      const float* dout, float* partial, float* dq, float* dk, float* dv,
                      float* db, long long blocks, int h, int n, int d, int npat,
                      int per_pattern, int chunk, int chunks, cudaStream_t s) {
  switch ((n + 15) / 16) {
    case 1: return launch<NC, 1>(q, k, v, bias, dout, partial, dq, dk, dv, db, blocks, h, n, d,
                                 npat, per_pattern, chunk, chunks, s);
    case 2: return launch<NC, 2>(q, k, v, bias, dout, partial, dq, dk, dv, db, blocks, h, n, d,
                                 npat, per_pattern, chunk, chunks, s);
    case 3: return launch<NC, 3>(q, k, v, bias, dout, partial, dq, dk, dv, db, blocks, h, n, d,
                                 npat, per_pattern, chunk, chunks, s);
    default: return launch<NC, 4>(q, k, v, bias, dout, partial, dq, dk, dv, db, blocks, h, n,
                                  d, npat, per_pattern, chunk, chunks, s);
  }
}

}  // namespace

// C entry for ctypes.  q, k, v, dout, dq, dk, dv are device pointers to
// contiguous (bw, h, n, d) float32 tensors; bias and db to contiguous
// (npat, h, n, n) float32 tensors; partial (scratch) to npat * chunks * h *
// n * n floats, where chunks = ceil((bw / npat) / chunk); stream is a
// cudaStream_t.  Launches two kernels in order on the stream.  Returns a
// cudaError_t: 0 when both launches were accepted.
extern "C" int window_attention_bwd(const void* q, const void* k, const void* v,
                                    const void* bias, const void* dout, void* partial,
                                    void* dq, void* dk, void* dv, void* db, long long bw,
                                    int h, int n, int d, int npat, int chunk, void* stream) {
  if (bw <= 0 || h <= 0 || n <= 0 || n > 64 || d <= 0 || d > 64 || npat <= 0 ||
      bw % npat != 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  const long long per_pattern = bw / npat;
  const long long chunks = (per_pattern + chunk - 1) / chunk;
  const long long blocks = static_cast<long long>(npat) * chunks * h;
  if (blocks > INT_MAX || per_pattern > INT_MAX ||
      static_cast<long long>(npat) * h * n * n / kReduceThreads + 1 > INT_MAX)
    return cudaErrorInvalidConfiguration;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fb = static_cast<const float*>(bias);
  const auto* fg = static_cast<const float*>(dout);
  auto* fp = static_cast<float*>(partial);
  auto* gq = static_cast<float*>(dq);
  auto* gk = static_cast<float*>(dk);
  auto* gv = static_cast<float*>(dv);
  auto* gb = static_cast<float*>(db);
  const int m = static_cast<int>(per_pattern), nc = static_cast<int>(chunks);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch_jg<1>(fq, fk, fv, fb, fg, fp, gq, gk, gv, gb, blocks, h, n, d, npat,
                                m, chunk, nc, s);
    case 2: return launch_jg<2>(fq, fk, fv, fb, fg, fp, gq, gk, gv, gb, blocks, h, n, d, npat,
                                m, chunk, nc, s);
    case 3: return launch_jg<3>(fq, fk, fv, fb, fg, fp, gq, gk, gv, gb, blocks, h, n, d, npat,
                                m, chunk, nc, s);
    default: return launch_jg<4>(fq, fk, fv, fb, fg, fp, gq, gk, gv, gb, blocks, h, n, d, npat,
                                 m, chunk, nc, s);
  }
}

extern "C" const char* window_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
