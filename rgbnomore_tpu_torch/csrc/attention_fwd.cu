// Fused softmax attention, forward: O = softmax(scale * Q K^T) V, float32,
// and, when asked for, each query row's log-sum-exp of its scaled scores,
// which the backward kernel (attention_bwd.cu) rebuilds P from.
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:_fwd_kernel
// (:39-48), which _attention_impl (:77-95) launches for fused_attention.
// Same function, same call contract: q, k, v, o are (B, H, N, D) float32,
// contiguous, with any N >= 1 and D <= 128.  The TPU version padded N to 256
// and D to 128 for its tiles and masked the padded keys; here nothing is
// padded in device memory: D is zero-padded in shared memory to a multiple
// of 16, and keys >= N are left out of the softmax.
//
// Bounds on an H100 SXM, at the ViT-Ti shape (256, 3, 196, 64):
//   bytes: q, k, v read once and o written once, 4 * 256*3*196*64 * 4 B
//          = 154 MB, 0.046 ms at 3.35 TB/s;
//   operations: QK^T and PV, 2 * 2*N*N*D per (batch, head), 7.55 GFLOP:
//          0.113 ms at the 67 TFLOP/s of the float32 CUDA cores, or, in
//          3xTF32 (three TF32 products per float32 product, tf32_mma.cuh),
//          3 * 7.55 GFLOP at the tensor cores' 495 TFLOP/s = 0.046 ms.
// In 3xTF32 the two bounds meet: the kernel is bound by operations and
// bytes alike, and both are 2.5x below the CUDA cores' float32 bound.
//
// Design:
//   - Both products on the tensor cores in 3xTF32, which keeps float32's
//     precision (the tests hold the kernel to the reference's tolerances).
//     Route: mma.sync m16n8k8 by inline PTX, each warp owning 16 query
//     rows (the FlashAttention-2 layout).  wgmma would reach the full rate,
//     but for TF32 it wants both operands K-major in shared memory (V as
//     V^T) behind descriptors, and the split operands would have to be
//     staged there too; mma.sync keeps the scores in the registers of the
//     warp that owns their rows and splits each operand as it is loaded.
//     wgmma belongs with the bf16 kernels of the AMP slice.
//   - Softmax in registers: the scores of a 16 x 32 tile stay in the mma
//     accumulators; each row's running max and sum live in the four lanes
//     that hold the row, reduced with __shfl_xor_sync.  The scores then feed
//     the PV product as its A operand with no shuffle (the k permutation of
//     tf32_mma.cuh), so no warp waits on another between the two products.
//   - K and V arrive in 32-key tiles through a ring of two shared-memory
//     stages by cp.async: the copy of tile j + 1 is issued right after the
//     barrier that opens tile j, into the stage tile j - 1 left, and is in
//     flight while the warps compute on tile j; one barrier a tile.  Q stays
//     in shared memory for the whole loop.  Every operand is split into its
//     high and low parts as its fragment is loaded (splitting Q once into a
//     second shared array cost a block an SM and ran slower).
//   - Every tile but a ragged last one runs without live-key tests, so its
//     loads, splits and products are one basic block for the scheduler.
//   - Query tiles of 16 rows per warp, spread evenly over the blocks of a
//     head (tf32::tiling): N = 196 takes four blocks of 4 warps, 13 of whose
//     16 warps hold live rows, and the last key tile computes only its live
//     8-key groups.  Rows computed 208 of 196, keys 200 of 196: 8.3% of the
//     products fall past N.
//   - About 52 KB of shared memory and 125 registers at D = 64: four blocks
//     of 4 warps an SM.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kBK = 32;        // keys per tile
constexpr int kNT = kBK / 8;   // 8-key groups per tile
constexpr int kStages = 2;     // K, V ring
constexpr int kMaxThreads = 32 * tf32::kMaxWarps;

// Shared memory, in floats: Q [16 W][ld], then each stage's K and V
// [kBK][ld].
template <int NK>
int smem_floats(int warps) {
  return (16 * warps + 2 * kStages * kBK) * (16 * NK + 4);
}

template <int NK>
__global__ void __launch_bounds__(kMaxThreads)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int n, int d, int q_tiles, float scale_log2) {
  constexpr int kDp = 16 * NK;
  constexpr int kLd = 16 * NK + 4;
  constexpr int kDT = kDp / 8;  // 8-wide column groups of the head dim
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int bq = 16 * warps;
  float* qs = smem;                // [bq][kLd]
  float* ring = qs + bq * kLd;    // stage s: K at ring + 2 s kBK kLd, V after it

  // query tiles of one head are neighbouring blocks, so the head's keys and
  // values come from device memory about once and from L2 after that
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * bq;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const float* kh = k + head;
  const float* vh = v + head;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;             // the warp's first row in the tile
  const bool warp_live = q0 + wr < n;
  const int k_tiles = (n + kBK - 1) / kBK;

  // the ring: K and V of tile j in stage j % 2; tile j + 1 is copied while
  // the warps compute on tile j, into the stage that tile j - 1 left
  auto load_stage = [&](int j) {
    float* st = ring + (j % kStages) * 2 * kBK * kLd;
    tf32::load_tile_async<kDp>(st, kh, j * kBK, kBK, n, d, tid, nthreads);
    tf32::load_tile_async<kDp>(st + kBK * kLd, vh, j * kBK, kBK, n, d, tid, nthreads);
  };
  tf32::load_tile_async<kDp>(qs, q + head, q0, bq, n, d, tid, nthreads);
  load_stage(0);
  tf32::cp_commit();

  float acc[kDT][4];
#pragma unroll
  for (int c = 0; c < kDT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  // running max (log2 units) and this lane's part of the running sum, of
  // rows g and g + 8 of the warp's 16
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < k_tiles; ++kt) {
    tf32::cp_wait<0>();  // tile kt has landed
    __syncthreads();     // ... for every thread, and tile kt - 1 is consumed
    if (kt + 1 < k_tiles) load_stage(kt + 1);
    tf32::cp_commit();

    const float* ks = ring + (kt % kStages) * 2 * kBK * kLd;
    const float* vs = ks + kBK * kLd;
    const int kn = min(kBK, n - kt * kBK);  // live keys of the tile
    // one tile; a full one (every tile but a ragged last) has no live-key
    // tests, so its loads, splits and products form one basic block that
    // the compiler schedules as a whole
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int live_nt = kFull ? kNT : (kn + 7) / 8;

      // S = Q K^T for the warp's 16 rows, live 8-key groups only
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

      // online softmax in log2 units: scale, mask keys past N, fold the
      // tile into each row's max, rescale what was summed under the old one
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool live = kFull || (j < live_nt && 8 * j + 2 * t + (e & 1) < kn);
          s[j][e] = live ? s[j][e] * scale_log2 : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
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
        alpha[r] = exp2f(m_run[r] - mx[r]);  // 0 on the first tile
        m_run[r] = mx[r];
        l_run[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m_run[e / 2]);
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
  float* oh = o + head;
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
    // log-sum-exp of the row's scaled scores, for the backward pass
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(bh) * n + row] = (m_run[r] + log2f(l_run[r])) * tf32::kLn2;
  }
}

template <int NK>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   long long bh, int n, int d, float scale, cudaStream_t stream) {
  const tf32::Tiling tl = tf32::tiling(n);
  const int bytes = smem_floats<NK>(tl.warps) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = bh * tl.tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  attention_fwd_kernel<NK><<<static_cast<unsigned>(blocks), 32 * tl.warps, bytes, stream>>>(
      q, k, v, o, lse, n, d, tl.tiles, scale * tf32::kLog2e);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  bh = B * H; q, k, v, o are device pointers to
// contiguous (B, H, N, D) float32 tensors; lse is null, or a (B, H, N)
// float32 tensor that gets each row's log-sum-exp; stream is a
// cudaStream_t.  Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, long long bh, int n, int d, float scale,
                             void* stream) {
  if (bh <= 0 || n <= 0 || d <= 0 || d > 128) return cudaErrorInvalidValue;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  auto* fo = static_cast<float*>(o);
  auto* fl = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<1>(fq, fk, fv, fo, fl, bh, n, d, scale, s);
    case 2: return launch<2>(fq, fk, fv, fo, fl, bh, n, d, scale, s);
    case 3: return launch<3>(fq, fk, fv, fo, fl, bh, n, d, scale, s);
    case 4: return launch<4>(fq, fk, fv, fo, fl, bh, n, d, scale, s);
    case 5: return launch<5>(fq, fk, fv, fo, fl, bh, n, d, scale, s);
    case 6: return launch<6>(fq, fk, fv, fo, fl, bh, n, d, scale, s);
    case 7: return launch<7>(fq, fk, fv, fo, fl, bh, n, d, scale, s);
    default: return launch<8>(fq, fk, fv, fo, fl, bh, n, d, scale, s);
  }
}

extern "C" const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
