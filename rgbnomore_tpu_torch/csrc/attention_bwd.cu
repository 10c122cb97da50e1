// Fused softmax attention, backward, float32.  For O = softmax(scale*QK^T) V
// and the output's gradient dO:
//   P  = exp(scale * Q K^T - lse)       (lse: each row's log-sum-exp, saved
//                                         by the forward kernel)
//   dV = P^T dO
//   dP = dO V^T
//   dS = P * (dP - delta),  delta = rowsum(dO * O) = rowsum(dP * P)
//   dQ = scale * dS K,  dK = scale * dS^T Q
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:_bwd_kernel
// (:51-69), which _bwd (:112-135) launches as fused_attention's VJP.  Same
// gradients for q, k, v (B, H, N, D) float32, contiguous, any N >= 1 and
// D <= 128.  The TPU kernel kept one whole (padded) head in VMEM; on Hopper a
// head's Q, dO and dQ alone (150 KB at N = 196, D = 64) leave no room in a
// block's shared memory for the tiles it works on, and dK, dV are sums over
// every query row while dQ is a sum over every key.
//
// Bounds on an H100 SXM, at the ViT-Ti train shape (256, 3, 196, 64):
//   operations: the five products of the VJP (QK^T, dO V^T, P^T dO, dS K,
//          dS^T Q), 10*N^2*D*B*H = 18.9 GFLOP: 0.282 ms at the 67 TFLOP/s
//          of the float32 CUDA cores, or 3 * 18.9 GFLOP at the tensor cores'
//          495 TFLOP/s in 3xTF32 (tf32_mma.cuh) = 0.115 ms;
//   bytes: q, k, v, o, dO, lse read once, dq, dk, dv written once, 309 MB,
//          0.092 ms at 3.35 TB/s.
// In 3xTF32 the kernel is bound by operations, 1.2x above its bytes bound.
//
// Design: three kernels in order on the stream, the two large ones on the
// tensor cores in 3xTF32 (mma.sync m16n8k8, 16 rows per warp, as the
// forward kernel), with no atomics:
//   - delta_kernel: delta = rowsum(dO * O), one warp a row.  It stays a
//     kernel of its own: folded into dkdv_kernel, every key block of a head
//     would load O and sum every row's delta again (four times a head at
//     N = 196), which measured slower on the H100 than this pass's one read
//     of O and dO.
//   - dkdv_kernel, key-major: each warp owns 16 keys, whose K and V rows stay
//     in shared memory.  Over 16-row tiles of Q, dO, lse and delta (a
//     two-stage cp.async ring, as the forward kernel's, one barrier a tile)
//     each warp builds S^T and dP^T in registers, P^T from the lse and
//     dS^T = P^T (dP^T - delta), accumulates dV += P^T dO and dK += dS^T Q
//     with P^T and dS^T fed from the accumulators as the A operand
//     (tf32_mma.cuh's k permutation), and stores dS into the scratch ds
//     (B, H, N, N).
//   - dq_kernel, query-major: each warp owns 16 query rows; over 32-key
//     tiles of dS and K (a two-stage cp.async ring) it accumulates
//     dQ += dS K.
//   The dS round trip is 2 * 4 N^2 B H bytes (308 MB at the ViT-Ti shape,
//   0.092 ms at 3.35 TB/s) and costs no product.  Rebuilding S and dP in
//   the dQ pass instead costs two more products (7 of N^2 D in place of 5);
//   that version measured slower on the H100.
//   Every sum runs in a fixed order (each output element has one owning
//   lane, and its k loop is sequential), so two runs give bit-identical
//   dq, dk, dv.
//   - Tiles of 16 keys (rows) per warp spread over the blocks of a head as
//     in the forward kernel; the ragged last tile of a loop computes only
//     its live 8-wide groups, and every other tile runs without live tests.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kBQ = 16;        // query rows per tile of dkdv_kernel
constexpr int kNQ = kBQ / 8;   // their 8-row groups
constexpr int kBK = 32;        // keys per tile of dq_kernel
constexpr int kNK = kBK / 8;   // their 8-key groups
constexpr int kStages = 2;  // tile j + 1 is copied while the warps compute on tile j
constexpr int kLdS = kBK + 8;  // row stride of a dS tile: 64-bit fragment loads, no conflicts
constexpr int kMaxThreads = 32 * tf32::kMaxWarps;

// Shared memory, in floats, of dkdv_kernel: K and V [16 W][ld], and per
// stage Q, dO [kBQ][ld], lse and delta [kBQ].
template <int NK>
int dkdv_smem_floats(int warps) {
  return 2 * 16 * warps * (16 * NK + 4) + kStages * (2 * kBQ * (16 * NK + 4) + 2 * kBQ);
}

// delta[row] = sum_c dO[row, c] * O[row, c], one warp per row: lanes stride
// the row, a butterfly adds their sums in a fixed order.
__global__ void delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                             float* __restrict__ delta, long long rows, int d) {
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

// Shared memory, in floats, of dq_kernel: per stage dS [16 W][kLdS] and K
// [kBK][ld].
template <int NK>
int dq_smem_floats(int warps) {
  return kStages * (16 * warps * kLdS + kBK * (16 * NK + 4));
}

// dK, dV and dS of 16 W keys of one head.
// At D <= 64, 16-row query tiles and a cap of 168 registers (no spill) let
// three blocks share an SM, which ran markedly faster on the H100 than two
// blocks of 32-row tiles; wider heads keep the registers they need.
template <int NK>
__global__ void __launch_bounds__(kMaxThreads, NK <= 4 ? 3 : 1)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ ds, float* __restrict__ dk, float* __restrict__ dv, int n,
                int d, int k_tiles, float scale, float scale_log2) {
  constexpr int kDp = 16 * NK;
  constexpr int kLd = 16 * NK + 4;
  constexpr int kDT = kDp / 8;
  constexpr int kStage = 2 * kBQ * kLd + 2 * kBQ;  // Q, dO, lse, delta
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int bk = 16 * warps;
  float* kks = smem;              // [bk][kLd]
  float* vvs = kks + bk * kLd;    // [bk][kLd]
  float* ring = vvs + bk * kLd;   // stage s at ring + s kStage

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * bk;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const float* qh = q + head;
  const float* gh = dout + head;
  const float* lh = lse + static_cast<size_t>(bh) * n;
  const float* dh = delta + static_cast<size_t>(bh) * n;
  float* dsh = ds + static_cast<size_t>(bh) * n * n;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wk = 16 * warp;
  const bool warp_live = k0 + wk < n;
  const int q_tiles = (n + kBQ - 1) / kBQ;

  auto load_stage = [&](int i) {
    float* st = ring + (i % kStages) * kStage;
    tf32::load_tile_async<kDp>(st, qh, i * kBQ, kBQ, n, d, tid, nthreads);
    tf32::load_tile_async<kDp>(st + kBQ * kLd, gh, i * kBQ, kBQ, n, d, tid, nthreads);
    tf32::load_vec_async(st + 2 * kBQ * kLd, lh, i * kBQ, kBQ, n, tid, nthreads);
    tf32::load_vec_async(st + 2 * kBQ * kLd + kBQ, dh, i * kBQ, kBQ, n, tid, nthreads);
  };
  tf32::load_tile_async<kDp>(kks, k + head, k0, bk, n, d, tid, nthreads);
  tf32::load_tile_async<kDp>(vvs, v + head, k0, bk, n, d, tid, nthreads);
  load_stage(0);
  tf32::cp_commit();

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int c = 0; c < kDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;

  for (int it = 0; it < q_tiles; ++it) {
    tf32::cp_wait<0>();  // tile it has landed, for every thread, and tile
    __syncthreads();     // it - 1 is consumed
    if (it + 1 < q_tiles) load_stage(it + 1);
    tf32::cp_commit();

    const float* qs = ring + (it % kStages) * kStage;
    const float* dos = qs + kBQ * kLd;
    const float* lse_s = dos + kBQ * kLd;
    const float* delta_s = lse_s + kBQ;
    const int q0 = it * kBQ;
    const int qn = min(kBQ, n - q0);  // live query rows of the tile
    // one tile; a full one has no live-row tests (see attention_fwd.cu)
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
        const tf32::AFrag ak = tf32::a_frag_rows(kks, kLd, wk, 8 * ks8, g, t);
        const tf32::AFrag av = tf32::a_frag_rows(vvs, kLd, wk, 8 * ks8, g, t);
        tf32::BFrag b[kNQ];
        tf32::b_frags_t(b, qs, kLd, 8 * ks8, g, t, live_nt);
        tf32::mma3(s, ak, b, live_nt);
        tf32::b_frags_t(b, dos, kLd, 8 * ks8, g, t, live_nt);
        tf32::mma3(dp, av, b, live_nt);
      }
      // P^T from the lse of each column's query row, dS^T = P^T (dP^T -
      // delta); query rows past N get 0.  dS goes to the scratch for the
      // dQ pass.
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const bool live = kFull || (j < live_nt && col < qn);
          const float p =
              live ? exp2f(s[j][e] * scale_log2 - lse_s[col] * tf32::kLog2e) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[col]);
          const int key = k0 + wk + g + 8 * (e / 2);
          if ((kFull || col < qn) && key < n)
            dsh[static_cast<size_t>(q0 + col) * n + key] = dp[j][e];
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
  }
  tf32::cp_wait<0>();

  if (!warp_live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + wk + g + 8 * r;
    if (key >= n) continue;
    float* dkr = dk + head + static_cast<size_t>(key) * d;
    float* dvr = dv + head + static_cast<size_t>(key) * d;
#pragma unroll
    for (int c = 0; c < kDT; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < d) {
        dkr[col] = dk_acc[c][2 * r] * scale;
        dvr[col] = dv_acc[c][2 * r];
      }
      if (col + 1 < d) {
        dkr[col + 1] = dk_acc[c][2 * r + 1] * scale;
        dvr[col + 1] = dv_acc[c][2 * r + 1];
      }
    }
  }
}

// dQ = scale * dS K for 16 W query rows of one head.
template <int NK>
__global__ void __launch_bounds__(kMaxThreads)
    dq_kernel(const float* __restrict__ k, const float* __restrict__ ds,
              float* __restrict__ dq, int n, int d, int q_tiles, float scale) {
  constexpr int kDp = 16 * NK;
  constexpr int kLd = 16 * NK + 4;
  constexpr int kDT = kDp / 8;
  extern __shared__ float smem[];
  const int warps = blockDim.x / 32;
  const int bq = 16 * warps;
  const int stage = bq * kLdS + kBK * kLd;  // dS [bq][kLdS], then K [kBK][kLd]
  float* ring = smem;

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * bq;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const float* kh = k + head;
  const float* dsh = ds + static_cast<size_t>(bh) * n * n;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;
  const bool warp_live = q0 + wr < n;
  const int k_tiles = (n + kBK - 1) / kBK;

  auto load_stage = [&](int kt) {
    float* st = ring + (kt % kStages) * stage;
    tf32::load_block_async<kBK, kLdS>(st, dsh, n, q0, kt * kBK, bq, n, n, tid, nthreads);
    tf32::load_tile_async<kDp>(st + bq * kLdS, kh, kt * kBK, kBK, n, d, tid, nthreads);
  };
  load_stage(0);
  tf32::cp_commit();

  float acc[kDT][4];
#pragma unroll
  for (int c = 0; c < kDT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;

  for (int kt = 0; kt < k_tiles; ++kt) {
    tf32::cp_wait<0>();
    __syncthreads();
    if (kt + 1 < k_tiles) load_stage(kt + 1);
    tf32::cp_commit();

    const float* dss = ring + (kt % kStages) * stage;
    const float* ks = dss + bq * kLdS;
    const int kn = min(kBK, n - kt * kBK);
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int live_nt = kFull ? kNK : (kn + 7) / 8;
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
        if (j < live_nt) {
          // dS with the k permutation: columns 2t and 2t + 1 of the group
          const float* p = dss + (wr + g) * kLdS + 8 * j + 2 * t;
          const float2 top = *reinterpret_cast<const float2*>(p);               // row g
          const float2 bottom = *reinterpret_cast<const float2*>(p + 8 * kLdS);  // row g + 8
          const tf32::AFrag a = tf32::a_frag(top.x, bottom.x, top.y, bottom.y);
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
  float* dqh = dq + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kDT; ++c) {
      const int col = 8 * c + 2 * t;
      if (col < d) dqh[static_cast<size_t>(row) * d + col] = acc[c][2 * r] * scale;
      if (col + 1 < d) dqh[static_cast<size_t>(row) * d + col + 1] = acc[c][2 * r + 1] * scale;
    }
  }
}

template <int NK>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, const float* lse, float* delta, float* ds, float* dq,
                   float* dk, float* dv, long long bh, int n, int d, float scale,
                   cudaStream_t stream) {
  const tf32::Tiling tl = tf32::tiling(n);
  const long long blocks = bh * tl.tiles;
  const long long rows = bh * n;
  const long long delta_blocks = (rows * 32 + 255) / 256;
  if (blocks > INT_MAX || delta_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int dkdv_bytes = dkdv_smem_floats<NK>(tl.warps) * static_cast<int>(sizeof(float));
  const int dq_bytes = dq_smem_floats<NK>(tl.warps) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  delta_kernel<<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(o, dout, delta, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(blocks);
  dkdv_kernel<NK><<<grid, 32 * tl.warps, dkdv_bytes, stream>>>(
      q, k, v, dout, lse, delta, ds, dk, dv, n, d, tl.tiles, scale, scale * tf32::kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<NK><<<grid, 32 * tl.warps, dq_bytes, stream>>>(k, ds, dq, n, d, tl.tiles, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  bh = B * H; q, k, v, o (the forward's output), dout,
// dq, dk, dv are device pointers to contiguous (B, H, N, D) float32 tensors;
// lse (the forward's log-sum-exp) and delta (scratch) are (B, H, N)
// float32; ds (scratch) is (B, H, N, N) float32; stream is a cudaStream_t.
// Launches three kernels in order on the stream.  Returns a cudaError_t: 0
// when every launch was accepted.
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* delta, void* ds,
                             void* dq, void* dk, void* dv, long long bh, int n, int d,
                             float scale, void* stream) {
  if (bh <= 0 || n <= 0 || d <= 0 || d > 128) return cudaErrorInvalidValue;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fo = static_cast<const float*>(o);
  const auto* fg = static_cast<const float*>(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  auto* fs = static_cast<float*>(ds);
  auto* gq = static_cast<float*>(dq);
  auto* gk = static_cast<float*>(dk);
  auto* gv = static_cast<float*>(dv);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<1>(fq, fk, fv, fo, fg, fl, fd, fs, gq, gk, gv, bh, n, d, scale, s);
    case 2: return launch<2>(fq, fk, fv, fo, fg, fl, fd, fs, gq, gk, gv, bh, n, d, scale, s);
    case 3: return launch<3>(fq, fk, fv, fo, fg, fl, fd, fs, gq, gk, gv, bh, n, d, scale, s);
    case 4: return launch<4>(fq, fk, fv, fo, fg, fl, fd, fs, gq, gk, gv, bh, n, d, scale, s);
    case 5: return launch<5>(fq, fk, fv, fo, fg, fl, fd, fs, gq, gk, gv, bh, n, d, scale, s);
    case 6: return launch<6>(fq, fk, fv, fo, fg, fl, fd, fs, gq, gk, gv, bh, n, d, scale, s);
    case 7: return launch<7>(fq, fk, fv, fo, fg, fl, fd, fs, gq, gk, gv, bh, n, d, scale, s);
    default: return launch<8>(fq, fk, fv, fo, fg, fl, fd, fs, gq, gk, gv, bh, n, d, scale, s);
  }
}

extern "C" const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
