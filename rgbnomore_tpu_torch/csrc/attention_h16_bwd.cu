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
// N >= 1 and D <= 128.  P and dS are rounded to the input dtype only as A
// operands of the dV, dK and dQ products; delta is summed in float32 from
// the input-dtype O and dO, as FlashAttention sums it (the Pallas kernel
// sums dP * P, equal in exact arithmetic).
//
// fp16's range: under the loss scale (2^15 at the start), dO V^T can pass
// fp16's largest value 65504 where float32 holds it, and so can dS.  dP and
// dS stay float32 here, and where a row of dS passes 2^15 in magnitude, the
// row is divided by a power of two before it is rounded to fp16 for its
// product, and the product's accumulator row is divided by the same power
// before and multiplied by it after (h16::fp16_row_divisor): exact in
// float32, so the result is the product of the unscaled row, rounded as a
// wider fp16 would round it.  A dq, dk or dv beyond fp16's range still
// overflows when it is stored, as the Pallas kernel's cast does.  bf16
// has float32's range and skips all of it.
//
// Bounds on an H100 SXM, at the ViT-B train shape (512, 12, 196, 64):
//   operations: the five products of the VJP (QK^T, dO V^T, P^T dO, dS K,
//          dS^T Q), 10 * N^2 * D * B * H = 151 GFLOP, 0.153 ms at the
//          tensor cores' 989 TFLOP/s dense bf16 / fp16;
//   bytes: q, k, v, o, dO read once, dq, dk, dv written once (2 B each),
//          lse read once (4 B), 1.24 GB, 0.370 ms at 3.35 TB/s.
// Bound by bytes, 2.4x above the operations.
//
// Design: the three launches of attention_bwd.cu, with no atomics:
//   - delta_kernel: delta = rowsum(dO * O) in float32, one warp a row.
//   - dkdv_kernel, key-major: each warp owns 16 keys, whose K and V A
//     fragments are read once and held in registers.  Over 16-row tiles of
//     Q, dO, lse and delta (a two-stage cp.async ring) each warp builds S^T
//     and dP^T in registers, P^T from the lse and dS^T = P^T (dP^T -
//     delta) in float32, accumulates dV += P^T dO and dK += dS^T Q with
//     P^T and dS^T packed from the accumulators as A operands (h16_mma.cuh)
//     and Q, dO as B operands by the transposing ldmatrix, and stores dS
//     into the float32 scratch ds (B, H, N, N).
//   - dq_kernel, query-major: each warp owns 16 query rows; over 32-key
//     tiles of dS (float32) and K (a two-stage cp.async ring) it rounds dS
//     to the input dtype (fp16 rows scaled as above) and accumulates
//     dQ += dS K.
//   The float32 scratch costs 2 * 4 N^2 B H bytes of traffic (1.89 GB at the
//   ViT-B train shape, 0.56 ms at 3.35 TB/s), 1.5x the kernel's own bytes
//   bound: the first thing to cut in a faster version.
//   Every sum runs in a fixed order, so two runs give bit-identical dq, dk,
//   dv.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <type_traits>

#include "h16_mma.cuh"

namespace {

constexpr int kBQ = 16;        // query rows per tile of dkdv_kernel
constexpr int kNQ = kBQ / 8;   // their 8-row groups
constexpr int kBK = 32;        // keys per tile of dq_kernel
constexpr int kStages = 2;     // tile j + 1 is copied while the warps compute on tile j
constexpr int kLdS = kBK + 8;  // row stride of a float32 dS tile: 64-bit loads, no conflicts
constexpr int kMaxThreads = 32 * tf32::kMaxWarps;

template <typename T>
constexpr bool kHalfRange = std::is_same<T, __half>::value;  // fp16: guard the range

// Shared memory, in bytes, of dkdv_kernel: K and V [16 W][ld] of T, and
// per stage Q, dO [kBQ][ld] of T, lse and delta [kBQ] float32.
template <int NK>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * kBQ * (16 * NK + 8) * 2 + 2 * kBQ * 4;
}

template <int NK>
int dkdv_smem_bytes(int warps) {
  return 2 * 16 * warps * (16 * NK + 8) * 2 + kStages * dkdv_stage_bytes<NK>();
}

// Shared memory, in bytes, of dq_kernel: per stage dS [16 W][kLdS] float32
// and K [kBK][ld] of T.
template <int NK>
__host__ __device__ constexpr int dq_stage_bytes(int warps) {
  return 16 * warps * kLdS * 4 + kBK * (16 * NK + 8) * 2;
}

// delta[row] = sum_c dO[row, c] * O[row, c] in float32, one warp per row:
// lanes stride the row, a butterfly adds their sums in a fixed order.
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                             float* __restrict__ delta, long long rows, int d) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: every lane of a warp shares its row
  const T* a = o + row * d;
  const T* b = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(h16::to_float(a[c]), h16::to_float(b[c]), s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// acc += A B for one 16-row A operand given as this lane's float32 values
// of its rows g and g + 8 (row_g = the a0 and a2 pairs of h16_mma.cuh,
// row_g8 = the a1 and a3 pairs), rounded to T, against the B fragment
// pairs b[c] for each 8-column group c.  For fp16 a row beyond 2^15 is scaled by a power of two around the
// product (see the header comment).
template <typename T, int kDT>
__device__ __forceinline__ void mma_rows(float (&acc)[kDT][4], const float (&row_g)[4],
                                         const float (&row_g8)[4], const uint32_t (&b)[kDT][2]) {
  uint32_t a[4];
  float div[2] = {1.f, 1.f};
  if constexpr (kHalfRange<T>) {
    float amax[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      amax[0] = fmaxf(amax[0], fabsf(row_g[e]));
      amax[1] = fmaxf(amax[1], fabsf(row_g8[e]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 1));
      amax[r] = fmaxf(amax[r], __shfl_xor_sync(0xffffffffu, amax[r], 2));
      div[r] = h16::fp16_row_divisor(amax[r]);
    }
  }
  const bool scaled = kHalfRange<T> && __any_sync(0xffffffffu, div[0] != 1.f || div[1] != 1.f);
  if (scaled) {
    const float inv[2] = {1.f / div[0], 1.f / div[1]};  // powers of two: exact
    a[0] = h16::pack<T>(row_g[0] * inv[0], row_g[1] * inv[0]);
    a[1] = h16::pack<T>(row_g8[0] * inv[1], row_g8[1] * inv[1]);
    a[2] = h16::pack<T>(row_g[2] * inv[0], row_g[3] * inv[0]);
    a[3] = h16::pack<T>(row_g8[2] * inv[1], row_g8[3] * inv[1]);
#pragma unroll
    for (int c = 0; c < kDT; ++c) {
      acc[c][0] *= inv[0];
      acc[c][1] *= inv[0];
      acc[c][2] *= inv[1];
      acc[c][3] *= inv[1];
      h16::mma<T>(acc[c], a, b[c][0], b[c][1]);
      acc[c][0] *= div[0];
      acc[c][1] *= div[0];
      acc[c][2] *= div[1];
      acc[c][3] *= div[1];
    }
  } else {
    a[0] = h16::pack<T>(row_g[0], row_g[1]);
    a[1] = h16::pack<T>(row_g8[0], row_g8[1]);
    a[2] = h16::pack<T>(row_g[2], row_g[3]);
    a[3] = h16::pack<T>(row_g8[2], row_g8[3]);
#pragma unroll
    for (int c = 0; c < kDT; ++c) h16::mma<T>(acc[c], a, b[c][0], b[c][1]);
  }
}

// The B fragment pairs b[c] = B[k0..k0+15][8c..8c+7] of a row-major tile
// (B[k][n] = tile[k0 + k][n]), two 8-column groups per transposing load.
template <int kDT, typename T>
__device__ __forceinline__ void b_frags_all(uint32_t (&b)[kDT][2], const T* s, int ld, int k0,
                                            int lane) {
#pragma unroll
  for (int cp = 0; cp < kDT / 2; ++cp) {
    uint32_t r[4];
    h16::b_frags(r, s, ld, k0, 16 * cp, lane);
    b[2 * cp][0] = r[0];
    b[2 * cp][1] = r[1];
    b[2 * cp + 1][0] = r[2];
    b[2 * cp + 1][1] = r[3];
  }
}

// dK, dV and dS of 16 W keys of one head.
template <typename T, int NK>
__global__ void __launch_bounds__(kMaxThreads, NK <= 4 ? 3 : 1)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ ds, T* __restrict__ dk,
                T* __restrict__ dv, int n, int d, int k_tiles, float scale, float scale_log2,
                bool vec) {
  constexpr int kDp = 16 * NK;
  constexpr int kLd = kDp + 8;
  constexpr int kDT = kDp / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int bk = 16 * warps;
  T* kks = reinterpret_cast<T*>(smem_raw);  // [bk][kLd]
  T* vvs = kks + bk * kLd;                  // [bk][kLd]
  unsigned char* ring = reinterpret_cast<unsigned char*>(vvs + bk * kLd);

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * bk;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const T* qh = q + head;
  const T* gh = dout + head;
  const float* lh = lse + static_cast<size_t>(bh) * n;
  const float* dh = delta + static_cast<size_t>(bh) * n;
  float* dsh = ds + static_cast<size_t>(bh) * n * n;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wk = 16 * warp;
  const bool warp_live = k0 + wk < n;
  const int q_tiles = (n + kBQ - 1) / kBQ;

  // stage layout: Q [kBQ][kLd], dO [kBQ][kLd] of T, then lse, delta [kBQ]
  auto stage_q = [&](int i) {
    return reinterpret_cast<T*>(ring + (i % kStages) * dkdv_stage_bytes<NK>());
  };
  auto load_stage = [&](int i) {
    T* qs = stage_q(i);
    float* vecs = reinterpret_cast<float*>(qs + 2 * kBQ * kLd);
    h16::load_tile<kDp>(qs, qh, i * kBQ, kBQ, n, d, vec, tid, nthreads);
    h16::load_tile<kDp>(qs + kBQ * kLd, gh, i * kBQ, kBQ, n, d, vec, tid, nthreads);
    tf32::load_vec_async(vecs, lh, i * kBQ, kBQ, n, tid, nthreads);
    tf32::load_vec_async(vecs + kBQ, dh, i * kBQ, kBQ, n, tid, nthreads);
  };
  h16::load_tile<kDp>(kks, k + head, k0, bk, n, d, vec, tid, nthreads);
  h16::load_tile<kDp>(vvs, v + head, k0, bk, n, d, vec, tid, nthreads);
  load_stage(0);
  tf32::cp_commit();

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int c = 0; c < kDT; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][e] = dv_acc[c][e] = 0.f;
  uint32_t ka[NK][4], va[NK][4];  // the warp's K and V A fragments

  for (int it = 0; it < q_tiles; ++it) {
    tf32::cp_wait<0>();  // tile it has landed, for every thread, and tile
    __syncthreads();     // it - 1 is consumed
    if (it + 1 < q_tiles) load_stage(it + 1);
    tf32::cp_commit();
    if (it == 0 && warp_live) {
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        h16::a_frag(ka[c], kks, kLd, wk, 16 * c, lane);
        h16::a_frag(va[c], vvs, kLd, wk, 16 * c, lane);
      }
    }

    const T* qs = stage_q(it);
    const T* dos = qs + kBQ * kLd;
    const float* lse_s = reinterpret_cast<const float*>(dos + kBQ * kLd);
    const float* delta_s = lse_s + kBQ;
    const int q0 = it * kBQ;
    const int qn = min(kBQ, n - q0);  // live query rows of the tile
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;

      // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 16 queries
      float s[kNQ][4], dp[kNQ][4];
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int c = 0; c < NK; ++c) {
        uint32_t b[4];
        h16::b_frags_t(b, qs, kLd, 0, 16 * c, lane);
        h16::mma<T>(s[0], ka[c], b[0], b[1]);
        h16::mma<T>(s[1], ka[c], b[2], b[3]);
        h16::b_frags_t(b, dos, kLd, 0, 16 * c, lane);
        h16::mma<T>(dp[0], va[c], b[0], b[1]);
        h16::mma<T>(dp[1], va[c], b[2], b[3]);
      }
      // P^T from the lse of each column's query row, dS^T = P^T (dP^T -
      // delta), float32; query rows past N get 0.  dS goes to the scratch
      // for the dQ pass.
#pragma unroll
      for (int j = 0; j < kNQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const bool live = kFull || col < qn;
          const float p =
              live ? exp2f(s[j][e] * scale_log2 - lse_s[col] * tf32::kLog2e) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[col]);
          const int key = k0 + wk + g + 8 * (e / 2);
          if (live && key < n) dsh[static_cast<size_t>(q0 + col) * n + key] = dp[j][e];
        }
      }
      // dV += P^T dO, dK += dS^T Q: the B fragments of dO and Q by the
      // transposing load
      uint32_t b[kDT][2];
      b_frags_all<kDT>(b, dos, kLd, 0, lane);
      uint32_t a[4];
      h16::a_from_c<T>(a, s[0], s[1]);
#pragma unroll
      for (int c = 0; c < kDT; ++c) h16::mma<T>(dv_acc[c], a, b[c][0], b[c][1]);
      b_frags_all<kDT>(b, qs, kLd, 0, lane);
      const float row_g[4] = {dp[0][0], dp[0][1], dp[1][0], dp[1][1]};
      const float row_g8[4] = {dp[0][2], dp[0][3], dp[1][2], dp[1][3]};
      mma_rows<T, kDT>(dk_acc, row_g, row_g8, b);
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
    T* dkr = dk + head + static_cast<size_t>(key) * d;
    T* dvr = dv + head + static_cast<size_t>(key) * d;
#pragma unroll
    for (int c = 0; c < kDT; ++c) {
      h16::store_pair(dkr, 8 * c + 2 * t, d, dk_acc[c][2 * r] * scale,
                      dk_acc[c][2 * r + 1] * scale);
      h16::store_pair(dvr, 8 * c + 2 * t, d, dv_acc[c][2 * r], dv_acc[c][2 * r + 1]);
    }
  }
}

// dQ = scale * dS K for 16 W query rows of one head.
template <typename T, int NK>
__global__ void __launch_bounds__(kMaxThreads)
    dq_kernel(const T* __restrict__ k, const float* __restrict__ ds, T* __restrict__ dq, int n,
              int d, int q_tiles, float scale, bool vec) {
  constexpr int kDp = 16 * NK;
  constexpr int kLd = kDp + 8;
  constexpr int kDT = kDp / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warps = blockDim.x / 32;
  const int bq = 16 * warps;
  const int stage = dq_stage_bytes<NK>(warps);  // dS [bq][kLdS] float32, then K [kBK][kLd]

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * bq;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const T* kh = k + head;
  const float* dsh = ds + static_cast<size_t>(bh) * n * n;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wr = 16 * warp;
  const bool warp_live = q0 + wr < n;
  const int k_tiles = (n + kBK - 1) / kBK;

  auto stage_ds = [&](int kt) {
    return reinterpret_cast<float*>(smem_raw + (kt % kStages) * stage);
  };
  auto load_stage = [&](int kt) {
    float* st = stage_ds(kt);
    tf32::load_block_async<kBK, kLdS>(st, dsh, n, q0, kt * kBK, bq, n, n, tid, nthreads);
    h16::load_tile<kDp>(reinterpret_cast<T*>(st + bq * kLdS), kh, kt * kBK, kBK, n, d, vec,
                        tid, nthreads);
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

    const float* dss = stage_ds(kt);
    const T* ks = reinterpret_cast<const T*>(dss + bq * kLdS);
    const int kn = min(kBK, n - kt * kBK);
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int live_kc = kFull ? kBK / 16 : (kn + 15) / 16;  // live 16-key chunks
#pragma unroll
      for (int jc = 0; jc < kBK / 16; ++jc) {
        if (jc < live_kc) {
          // dS rows g and g + 8, keys 16 jc + 2t, +1 and 16 jc + 8 + 2t, +1
          const float* p = dss + (wr + g) * kLdS + 16 * jc + 2 * t;
          const float2 top0 = *reinterpret_cast<const float2*>(p);
          const float2 top1 = *reinterpret_cast<const float2*>(p + 8);
          const float2 bot0 = *reinterpret_cast<const float2*>(p + 8 * kLdS);
          const float2 bot1 = *reinterpret_cast<const float2*>(p + 8 * kLdS + 8);
          const float row_g[4] = {top0.x, top0.y, top1.x, top1.y};
          const float row_g8[4] = {bot0.x, bot0.y, bot1.x, bot1.y};
          uint32_t b[kDT][2];
          b_frags_all<kDT>(b, ks, kLd, 16 * jc, lane);
          mma_rows<T, kDT>(acc, row_g, row_g8, b);
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
  T* dqh = dq + head;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < kDT; ++c)
      h16::store_pair(dqh + static_cast<size_t>(row) * d, 8 * c + 2 * t, d,
                      acc[c][2 * r] * scale, acc[c][2 * r + 1] * scale);
  }
}

template <typename T, int NK>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, float* ds, void* dq,
                   void* dk, void* dv, long long bh, int n, int d, float scale, bool vec,
                   cudaStream_t stream) {
  const tf32::Tiling tl = tf32::tiling(n);
  const long long blocks = bh * tl.tiles;
  const long long rows = bh * n;
  const long long delta_blocks = (rows * 32 + 255) / 256;
  if (blocks > INT_MAX || delta_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int dkdv_bytes = dkdv_smem_bytes<NK>(tl.warps);
  const int dq_bytes = kStages * dq_stage_bytes<NK>(tl.warps);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  delta_kernel<T><<<static_cast<unsigned>(delta_blocks), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(blocks);
  dkdv_kernel<T, NK><<<grid, 32 * tl.warps, dkdv_bytes, stream>>>(
      tq, tk, static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, ds,
      static_cast<T*>(dk), static_cast<T*>(dv), n, d, tl.tiles, scale,
      scale * tf32::kLog2e, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, NK><<<grid, 32 * tl.warps, dq_bytes, stream>>>(tk, ds, static_cast<T*>(dq), n,
                                                              d, tl.tiles, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const float* lse, float* delta, float* ds, void* dq,
                     void* dk, void* dv, long long bh, int n, int d, float scale, bool vec,
                     cudaStream_t s) {
  switch ((d + 15) / 16) {
#define H16_BWD_CASE(NK)                                                                  \
  case NK:                                                                                \
    return launch<T, NK>(q, k, v, o, dout, lse, delta, ds, dq, dk, dv, bh, n, d, scale, vec, \
                         s);
    H16_BWD_CASE(1)
    H16_BWD_CASE(2)
    H16_BWD_CASE(3)
    H16_BWD_CASE(4)
    H16_BWD_CASE(5)
    H16_BWD_CASE(6)
    H16_BWD_CASE(7)
#undef H16_BWD_CASE
    default:
      return launch<T, 8>(q, k, v, o, dout, lse, delta, ds, dq, dk, dv, bh, n, d, scale, vec,
                          s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// C entry for ctypes.  bh = B * H; q, k, v, o (the forward's output), dout,
// dq, dk, dv are device pointers to contiguous (B, H, N, D) tensors of one
// 16-bit type, `element` 0 for fp16 and 1 for bf16; lse (the forward's
// log-sum-exp) and delta (scratch) are (B, H, N) float32; ds (scratch) is
// (B, H, N, N) float32; stream is a cudaStream_t.  Launches three kernels
// in order on the stream.  Returns a cudaError_t: 0 when every launch was
// accepted.
extern "C" int attention_h16_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, const void* lse, void* delta, void* ds,
                                 void* dq, void* dk, void* dv, long long bh, int n, int d,
                                 float scale, int element, void* stream) {
  if (bh <= 0 || n <= 0 || d <= 0 || d > 128 || (element != 0 && element != 1))
    return cudaErrorInvalidValue;
  // 16-byte row chunks when every row starts 16-byte aligned
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(dout);
  const auto* fl = static_cast<const float*>(lse);
  auto* fd = static_cast<float*>(delta);
  auto* fs = static_cast<float*>(ds);
  auto s = static_cast<cudaStream_t>(stream);
  if (element == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, fl, fd, fs, dq, dk, dv, bh, n, d, scale,
                                   vec, s);
  return dispatch<__half>(q, k, v, o, dout, fl, fd, fs, dq, dk, dv, bh, n, d, scale, vec, s);
}

extern "C" const char* attention_h16_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
