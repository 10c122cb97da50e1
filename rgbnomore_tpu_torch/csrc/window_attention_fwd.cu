// Swin window attention, forward: for each window w and head h,
//   O[w, h] = softmax(Q[w, h] K[w, h]^T + bias[w % P, h]) V[w, h],
// float32, with any logit scale already folded into q.
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:
// _win_fwd_kernel (:156-167), which _window_attention_impl (:228-246)
// launches for fused_window_attention.  The TPU kernel stacked two windows
// into one 128-row tile (with -1e9 off the block diagonal of its bias) to
// fill the MXU; here each warp owns 16 query rows of one window, so nothing
// is packed.  q, k, v, o are (BW, H, N, D) float32, contiguous, N <= 64,
// D <= 64; bias is (P, H, N, N) float32, contiguous, and BW % P == 0.  P = 1
// for the unshifted blocks of SwinV2 (the relative position bias alone),
// P = nW for the shifted ones (the bias plus each window's shift mask).
//
// Bounds on an H100 SXM at the SwinV2-T shape N = 64, D = 32, stage 1 of a
// train batch of 128 (8,192 windows x 3 heads = 24,576 (window, head)
// units):
//   bytes: q, k, v read once and o written once, 4 * N*D * 4 B = 32 KB a
//          unit (the bias, one 16 KB tile per pattern and head, is read
//          once a block), 0.81 GB: 0.240 ms at 3.35 TB/s;
//   operations: QK^T and PV, 4*N^2*D = 0.52 MFLOP a unit, 12.9 GFLOP:
//          0.192 ms at the 67 TFLOP/s of the float32 CUDA cores, or, in
//          3xTF32 (three TF32 products per float32 product, tf32_mma.cuh),
//          3 * 12.9 GFLOP at the tensor cores' 495 TFLOP/s = 0.078 ms.
// The kernel is bound by bytes, 3.1x above its 3xTF32 operation bound.
//
// What the design does about that bound:
//   - Both products on the tensor cores in 3xTF32 (mma.sync m16n8k8, the
//     FlashAttention-2 layout: each warp owns 16 query rows; N = 64 is four
//     warps' rows with no padding), so the products no longer pace the
//     kernel.  The scores, row max and sum stay in registers (the quad of
//     lanes holding a row reduces them with __shfl_xor_sync), and P feeds
//     PV as its A operand without a shuffle (tf32_mma.cuh's k permutation):
//     P never reaches shared memory, and nothing is saved for the backward,
//     which recomputes P from the same inputs.
//   - Several windows a block: a block takes one (pattern, head) and walks
//     `chunk` of the pattern's windows, w = p + t * P, through a ring of two
//     shared-memory stages filled by 16-byte cp.async: window t + 1's q, k,
//     v are in flight while the warps compute on window t, one barrier a
//     window.  chunk = units / 1024 clamped to [1, 16]: a launch keeps about
//     1,024 blocks or more where it has that many units, so stage 4 (3,072
//     units at batch 128, chunk 3) still fills the 132 SMs' 528 block slots
//     twice, and stage 1 (chunk 16, 1,536 blocks) loads its bias tile once
//     for 16 windows.  On the H100 this ran slightly faster than 2,048
//     blocks of at most 8 windows.
//   - At D <= 32, at most 128 registers (no spill) and 55 KB of shared
//     memory at D = 32 let four blocks of four warps share an SM; the
//     uncapped build took 158 registers, three blocks, and ran slightly
//     slower.  Wider heads keep two blocks and the registers they need.
//   - The bias read once a block, into registers: each thread holds its C
//     fragment of the pattern's tile (32 floats at N = 64), with -inf for
//     the key columns past N, which masks them in the softmax for free.
//   - N is padded to 16-row warp tiles and D to 16 columns in shared memory
//     only (zero-filled by the copies); a warp's rows past N are computed
//     and not stored.
//   - Every parameter is a kernel argument, held in registers: no parameter
//     is read through shared memory across a barrier.
// Left for later work: bf16 tensor cores (wgmma) under AMP; TMA copies.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <math.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxThreads = 32 * tf32::kMaxWarps;  // four warps: N <= 64
constexpr int kStages = 2;                         // the ring of windows
constexpr int kTargetBlocks = 1024;                // see the note above
constexpr int kMaxChunk = 16;

// Shared memory, in floats: per stage q, k, v [16 JG][16 NC + 4].
template <int NC, int JG>
constexpr int smem_floats() {
  return kStages * 3 * 16 * JG * (16 * NC + 4);
}

template <int NC, int JG>
__global__ void __launch_bounds__(kMaxThreads, NC <= 2 ? 4 : 2)
    window_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ o, int h, int n, int d, int npat, int per_pattern,
                      int chunk, int chunks) {
  constexpr int kDp = 16 * NC;       // head dim, padded
  constexpr int kLd = kDp + 4;       // row stride of the tiles
  constexpr int kDT = kDp / 8;       // 8-wide column groups of the head dim
  constexpr int kRows = 16 * JG;     // tokens, padded to whole warp tiles
  constexpr int kNT = kRows / 8;     // 8-key groups
  constexpr int kTile = kRows * kLd;
  extern __shared__ float smem[];    // stage s: q, k, v at smem + 3 s kTile

  // blockIdx.x = (p * chunks + ch) * h + head
  const int head = blockIdx.x % h;
  const int p = blockIdx.x / h / chunks, ch = blockIdx.x / h % chunks;
  const int t0 = ch * chunk, t_end = min(per_pattern, t0 + chunk);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;  // the warp's first row
  const size_t nd = static_cast<size_t>(n) * d;
  auto base = [&](int tw) {
    return (static_cast<size_t>(p + static_cast<long long>(tw) * npat) * h + head) * nd;
  };
  auto load = [&](int tw, int stage) {
    float* st = smem + stage * 3 * kTile;
    const size_t b = base(tw);
    tf32::load_tile_async<kDp>(st, q + b, 0, kRows, n, d, tid, nthreads);
    tf32::load_tile_async<kDp>(st + kTile, k + b, 0, kRows, n, d, tid, nthreads);
    tf32::load_tile_async<kDp>(st + 2 * kTile, v + b, 0, kRows, n, d, tid, nthreads);
  };
  load(t0, 0);
  tf32::cp_commit();

  // the pattern's bias, this thread's C fragment of it: -inf past N's keys,
  // 0 on rows past N (computed, not stored)
  const float* bp = bias + (static_cast<size_t>(p) * h + head) * n * n;
  float bias_c[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wr + g + 8 * (e / 2), col = 8 * j + 2 * t + (e & 1);
      bias_c[j][e] = col >= n ? -INFINITY : row < n ? __ldg(bp + row * n + col) : 0.f;
    }

  for (int tw = t0; tw < t_end; ++tw) {
    const int stage = (tw - t0) % kStages;
    tf32::cp_wait<0>();  // window tw has landed, for every thread, and the
    __syncthreads();     // stage of window tw - 1 is no longer read
    if (tw + 1 < t_end) load(tw + 1, stage ^ 1);
    tf32::cp_commit();
    const float* qs = smem + stage * 3 * kTile;
    const float* ks = qs + kTile;
    const float* vs = ks + kTile;

    // S = Q K^T + bias for the warp's 16 rows
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks8 = 0; ks8 < kDT; ++ks8) {
      const tf32::AFrag a = tf32::a_frag_rows(qs, kLd, wr, 8 * ks8, g, t);
      tf32::BFrag b[kNT];
      tf32::b_frags_t(b, ks, kLd, 8 * ks8, g, t, kNT);
      tf32::mma3(s, a, b, kNT);
    }
    // softmax of rows g and g + 8, left unnormalised: O is divided by the
    // row sum at the end
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += bias_c[j][e];
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - mx[e / 2]) * tf32::kLog2e);
        sum[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    }

    // O = P V, P straight from the score registers
    float acc[kDT][4];
#pragma unroll
    for (int c = 0; c < kDT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const tf32::AFrag a = tf32::a_frag_perm(s[j]);
      tf32::BFrag b[kDT];
      tf32::b_frags_perm(b, vs, kLd, 8 * j, g, t);
      tf32::mma3(acc, a, b, kDT);
    }

    float* ow = o + base(tw);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr + g + 8 * r;
      if (row >= n) continue;
      const float inv = 1.f / sum[r];
      float* orow = ow + static_cast<size_t>(row) * d;
#pragma unroll
      for (int c = 0; c < kDT; ++c) {
        const int col = 8 * c + 2 * t;
        if (col < d) orow[col] = acc[c][2 * r] * inv;
        if (col + 1 < d) orow[col + 1] = acc[c][2 * r + 1] * inv;
      }
    }
  }
  tf32::cp_wait<0>();
}

template <int NC, int JG>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* o,
                   long long bw, int h, int n, int d, int npat, cudaStream_t stream) {
  const long long units = bw * h;
  const long long per_pattern = bw / npat;
  const int chunk = static_cast<int>(std::min<long long>(
      kMaxChunk, std::max<long long>(1, std::min(units / kTargetBlocks, per_pattern))));
  const long long chunks = (per_pattern + chunk - 1) / chunk;
  const long long blocks = npat * chunks * h;
  if (blocks > INT_MAX || per_pattern > INT_MAX) return cudaErrorInvalidConfiguration;
  const int bytes = smem_floats<NC, JG>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(window_fwd_kernel<NC, JG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  window_fwd_kernel<NC, JG><<<static_cast<unsigned>(blocks), 32 * JG, bytes, stream>>>(
      q, k, v, bias, o, h, n, d, npat, static_cast<int>(per_pattern), chunk,
      static_cast<int>(chunks));
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_jg(const float* q, const float* k, const float* v, const float* bias,
                      float* o, long long bw, int h, int n, int d, int npat,
                      cudaStream_t stream) {
  switch ((n + 15) / 16) {
    case 1: return launch<NC, 1>(q, k, v, bias, o, bw, h, n, d, npat, stream);
    case 2: return launch<NC, 2>(q, k, v, bias, o, bw, h, n, d, npat, stream);
    case 3: return launch<NC, 3>(q, k, v, bias, o, bw, h, n, d, npat, stream);
    default: return launch<NC, 4>(q, k, v, bias, o, bw, h, n, d, npat, stream);
  }
}

}  // namespace

// C entry for ctypes.  q, k, v, o are device pointers to contiguous
// (bw, h, n, d) float32 tensors, bias to a contiguous (npat, h, n, n)
// float32 tensor; stream is a cudaStream_t.  Launches one kernel on the
// stream.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int window_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, void* o, long long bw, int h, int n,
                                    int d, int npat, void* stream) {
  if (bw <= 0 || h <= 0 || n <= 0 || n > 64 || d <= 0 || d > 64 || npat <= 0 ||
      bw % npat != 0)
    return cudaErrorInvalidValue;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fb = static_cast<const float*>(bias);
  auto* fo = static_cast<float*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch_jg<1>(fq, fk, fv, fb, fo, bw, h, n, d, npat, s);
    case 2: return launch_jg<2>(fq, fk, fv, fb, fo, bw, h, n, d, npat, s);
    case 3: return launch_jg<3>(fq, fk, fv, fb, fo, bw, h, n, d, npat, s);
    default: return launch_jg<4>(fq, fk, fv, fb, fo, bw, h, n, d, npat, s);
  }
}

extern "C" const char* window_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
