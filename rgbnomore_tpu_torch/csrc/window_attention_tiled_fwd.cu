// Swin window attention for windows of 64 < N <= 256 tokens, forward (#3L):
// for each window w and head h,
//   O[w, h] = softmax(Q[w, h] K[w, h]^T + bias[w % P, h]) V[w, h],
// float32, with any logit scale already folded into q, and, when asked for,
// each query row's log-sum-exp of its logits, which the backward kernels
// (window_attention_tiled_bwd.cu) rebuild P from.
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:
// _win_fwd_kernel (:156-167), which _window_attention_impl (:228-246)
// launches for fused_window_attention, at the window sizes past #3's
// (window_attention_fwd.cu, N <= 64): SwinV2 at window 16 (N = 256).  q, k,
// v, o are (BW, H, N, D) float32, contiguous, N <= 256, D <= 64; bias is
// (P, H, N, N) float32, contiguous, BW % P == 0; lse, when not null, is
// (BW, H, N) float32.
//
// What bounds it.  #3 holds a whole window's scores in one warp's
// registers and a whole window in one block's shared memory.  At N = 256
// one head's logits are 256 x 256 floats, 256 KB, more than a block's
// 227 KB of shared memory, and a warp's 16 rows of them are 128 registers
// a lane.  On an H100 SXM at stage 1 of SwinV2-B/w16 at batch 256 (4,096
// windows x 4 heads, N = 256, D = 32):
//   operations: QK^T and PV, 4*N^2*D = 8.4 MFLOP a (window, head), 137
//          GFLOP: in 3xTF32 (three TF32 products per float32 product,
//          tf32_mma.cuh) 3 x 137 GFLOP at the tensor cores' 495 TFLOP/s =
//          0.83 ms;
//   bytes: q, k, v read once, o written once (128 KB a (window, head)) and
//          the bias once: 2.15 GB, 0.64 ms at 3.35 TB/s.
// At D = 32 the three TF32 products cost more than the bytes: the kernel
// is bound by operations.
//
// What the design does about that:
//   - Keys tiled, as the ViT kernel (attention_fwd.cu) tiles them: each warp
//     owns 16 query rows (the FlashAttention-2 layout), a block four warps
//     (64 rows), so a window's head takes four blocks, neighbours in the
//     grid, and reads its keys and values from device memory about once and
//     from L2 after that.  Keys, values and the bias arrive in 32-key tiles
//     through a ring of two shared-memory stages filled by 16-byte cp.async;
//     tile j + 1 is in flight while the warps compute on tile j, one
//     barrier a tile.  An online softmax keeps each row's running max and
//     sum in the four lanes that hold the row; P feeds PV from the score
//     registers (tf32_mma.cuh's k permutation) and never reaches shared
//     memory.
//   - The bias tile (64 rows x 32 keys) rides in the same ring stage as its
//     keys; each lane reads its C fragment of it as float2, with a row
//     stride of 40 floats, free of bank conflicts.  A pattern's tile is
//     read by every window of the pattern: from L2 after the first.
//   - Both products in 3xTF32 on the tensor cores (mma.sync m16n8k8): the
//     route of #3, which keeps float32's precision at the tests' tolerances.
//   - Every tile but a ragged last one runs without live-key tests; keys
//     past N are -inf (masked), query rows past N are computed and not
//     stored.  D is zero-padded to 16 columns in shared memory only.
//   - About 48 KB of shared memory at D = 32: four blocks of four warps an
//     SM.
//   - Every parameter is a kernel argument, held in registers: no parameter
//     is read through shared memory across a barrier.
// Left for later work: wgmma (its TF32 operands want K-major shared tiles
// for V, as attention_fwd.cu notes); the bias gradient's layout.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kBK = 32;        // keys per tile
constexpr int kNT = kBK / 8;   // 8-key groups per tile
constexpr int kLdB = kBK + 8;  // row stride of a bias tile: float2 C-fragment reads, no conflicts
constexpr int kStages = 2;     // K, V, bias ring
constexpr int kWarps = tf32::kMaxWarps;
constexpr int kBQ = 16 * kWarps;  // query rows a block
constexpr int kThreads = 32 * kWarps;

// Shared memory, in floats: Q [kBQ][ld], then each stage's K, V [kBK][ld]
// and bias [kBQ][kLdB].
template <int NC>
constexpr int smem_floats() {
  return kBQ * (16 * NC + 4) + kStages * (2 * kBK * (16 * NC + 4) + kBQ * kLdB);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, NC <= 2 ? 4 : 2)
    window_tiled_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            float* __restrict__ o, float* __restrict__ lse, int h, int n, int d,
                            int npat, int q_tiles) {
  constexpr int kDp = 16 * NC;
  constexpr int kLd = kDp + 4;
  constexpr int kDT = kDp / 8;  // 8-wide column groups of the head dim
  constexpr int kStage = 2 * kBK * kLd + kBQ * kLdB;
  extern __shared__ float smem[];
  float* qs = smem;             // [kBQ][kLd]
  float* ring = qs + kBQ * kLd;  // stage s: K, V, bias at ring + s kStage

  // blockIdx.x = (w * h + head) * q_tiles + query tile: the query tiles of
  // one head are neighbours
  const int wh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const int head = wh % h, p = (wh / h) % npat;
  const size_t base = static_cast<size_t>(wh) * n * d;
  const float* kh = k + base;
  const float* vh = v + base;
  const float* bh = bias + (static_cast<size_t>(p) * h + head) * n * n;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;  // the warp's first row in the tile
  const bool warp_live = q0 + wr < n;
  const int k_tiles = (n + kBK - 1) / kBK;

  auto load_stage = [&](int j) {
    float* st = ring + (j % kStages) * kStage;
    tf32::load_tile_async<kDp>(st, kh, j * kBK, kBK, n, d, tid, kThreads);
    tf32::load_tile_async<kDp>(st + kBK * kLd, vh, j * kBK, kBK, n, d, tid, kThreads);
    tf32::load_block_async<kBK, kLdB>(st + 2 * kBK * kLd, bh, n, q0, j * kBK, kBQ, n, n, tid,
                                      kThreads);
  };
  tf32::load_tile_async<kDp>(qs, q + base, q0, kBQ, n, d, tid, kThreads);
  load_stage(0);
  tf32::cp_commit();

  float acc[kDT][4];
#pragma unroll
  for (int c = 0; c < kDT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  // running max (natural units) and this lane's part of the running sum,
  // of rows g and g + 8 of the warp's 16
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < k_tiles; ++kt) {
    tf32::cp_wait<0>();  // tile kt has landed
    __syncthreads();     // ... for every thread, and tile kt - 1 is consumed
    if (kt + 1 < k_tiles) load_stage(kt + 1);
    tf32::cp_commit();

    const float* ks = ring + (kt % kStages) * kStage;
    const float* vs = ks + kBK * kLd;
    const float* bs = vs + kBK * kLd;
    const int kn = min(kBK, n - kt * kBK);  // live keys of the tile
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int live_nt = kFull ? kNT : (kn + 7) / 8;

      // S = Q K^T + bias for the warp's 16 rows, live 8-key groups only
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks8 = 0; ks8 < kDT; ++ks8) {
        const tf32::AFrag a = tf32::a_frag_rows(qs, kLd, wr, 8 * ks8, g, t);
        tf32::BFrag b[kNT];
        tf32::b_frags_t(b, ks, kLd, 8 * ks8, g, t, live_nt);
        tf32::mma3(s, a, b, live_nt);
      }

      // online softmax: add the bias, mask keys past N, fold the tile into
      // each row's max, rescale what was summed under the old one
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 b2 =
              *reinterpret_cast<const float2*>(bs + (wr + g + 8 * r) * kLdB + 8 * j + 2 * t);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 2 * r + c;
            const bool live = kFull || (j < live_nt && 8 * j + 2 * t + c < kn);
            s[j][e] = live ? s[j][e] + (c ? b2.y : b2.x) : -INFINITY;
            mx[r] = fmaxf(mx[r], s[j][e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        alpha[r] = exp2f((m_run[r] - mx[r]) * tf32::kLog2e);  // 0 on the first tile
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f((s[j][e] - m_run[e / 2]) * tf32::kLog2e);
          l_run[e / 2] += s[j][e];
        }
      }
#pragma unroll
      for (int c = 0; c < kDT; ++c) {
        acc[c][0] *= alpha[0];
        acc[c][1] *= alpha[0];
        acc[c][2] *= alpha[1];
        acc[c][3] *= alpha[1];
      }

      // O += P V, P straight from the score registers
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (j < live_nt) {
          const tf32::AFrag a = tf32::a_frag_perm(s[j]);
          tf32::BFrag b[kDT];
          tf32::b_frags_perm(b, vs, kLd, 8 * j, g, t);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  float* oh = o + base;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int c = 0; c < kDT; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < d) oh[static_cast<size_t>(row) * d + col] = acc[c][2 * r] * inv;
      if (col + 1 < d) oh[static_cast<size_t>(row) * d + col + 1] = acc[c][2 * r + 1] * inv;
    }
    // log-sum-exp of the row's logits, for the backward pass
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(wh) * n + row] = m_run[r] + logf(l_run[r]);
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* o,
                   float* lse, long long bw, int h, int n, int d, int npat,
                   cudaStream_t stream) {
  const int q_tiles = (n + kBQ - 1) / kBQ;
  const long long blocks = bw * h * q_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int bytes = smem_floats<NC>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(window_tiled_fwd_kernel<NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  window_tiled_fwd_kernel<NC><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      q, k, v, bias, o, lse, h, n, d, npat, q_tiles);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  q, k, v, o are device pointers to contiguous
// (bw, h, n, d) float32 tensors, bias to a contiguous (npat, h, n, n)
// float32 tensor; lse is null, or a (bw, h, n) float32 tensor that gets
// each row's log-sum-exp; stream is a cudaStream_t.  Launches one kernel on
// the stream.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int window_attention_tiled_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, void* o, void* lse, long long bw,
                                          int h, int n, int d, int npat, void* stream) {
  if (bw <= 0 || h <= 0 || n <= 0 || n > 256 || d <= 0 || d > 64 || npat <= 0 ||
      bw % npat != 0)
    return cudaErrorInvalidValue;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fb = static_cast<const float*>(bias);
  auto* fo = static_cast<float*>(o);
  auto* fl = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<1>(fq, fk, fv, fb, fo, fl, bw, h, n, d, npat, s);
    case 2: return launch<2>(fq, fk, fv, fb, fo, fl, bw, h, n, d, npat, s);
    case 3: return launch<3>(fq, fk, fv, fb, fo, fl, bw, h, n, d, npat, s);
    default: return launch<4>(fq, fk, fv, fb, fo, fl, bw, h, n, d, npat, s);
  }
}

extern "C" const char* window_attention_tiled_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
