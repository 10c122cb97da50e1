// Fused softmax attention, forward, on bf16 or fp16 inputs (mixed
// precision): O = softmax(scale * Q K^T) V in the input dtype, and, when
// asked for, each query row's float32 log-sum-exp of its scaled scores,
// which attention_h16_bwd.cu rebuilds P from.
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:_fwd_kernel
// (:39-48), which _attention_impl (:77-95) launches for fused_attention, as
// it runs on bf16 or fp16 inputs: both products take the half-precision
// operands with float32 accumulation (preferred_element_type), the logits
// and the softmax are float32, and the output is cast to the input dtype.
// q, k, v, o are (B, H, N, D), contiguous, any N >= 1 and D <= 128; keys >=
// N are left out of the softmax, and D is zero-padded in shared memory only.
// P is rounded to the input dtype as the A operand of PV, as JAX's einsum
// path rounds it (models/vit.py:70) and as the TPU runs that float32 dot in
// one bf16 pass at its default precision; the running max, the row sums and
// the log-sum-exp stay float32 and are taken over the unrounded P.
//
// Bounds on an H100 SXM, at the ViT-B shape (256, 12, 196, 64):
//   operations: QK^T and PV, 4 * N^2 * D * B * H = 30.2 GFLOP, 0.031 ms at
//          the tensor cores' 989 TFLOP/s dense bf16 / fp16;
//   bytes: q, k, v read once and o written once, 4 * B*H*N*D * 2 B = 308
//          MB, 0.092 ms at 3.35 TB/s.
// Bound by bytes, 3.0x above the operations: 4 N^2 D FLOP per 8 N D bytes
// of q, k, v, o is N / 2 = 98 FLOP a byte at N = 196, against the card's
// 295.
//
// Design (the FlashAttention-2 layout, as attention_fwd.cu, in one mma.sync
// pass per product where 3xTF32 takes three):
//   - mma.sync m16n8k16 by inline PTX, each warp owning 16 query rows; the
//     warp's Q fragments are read once (ldmatrix) and held in registers.
//   - K and V arrive in 32-key tiles through a two-stage cp.async ring (one
//     barrier a tile); K^T's and V's B fragments come straight from the
//     ring by ldmatrix (V by its transposing form), free of bank conflicts
//     at a row stride of D + 8 elements.  64-key tiles took 140 registers
//     at D = 64, three blocks an SM, and took 14-16% more device time on
//     the H100 (tools/kernel_ab.py, PERF.md PR 7); 32-key tiles fit
//     128 registers and 28 KB of shared memory, four blocks an SM.
//   - The scores of a 16 x 32 tile stay in the mma accumulators; each row's
//     running max and sum live in the four lanes that hold the row.  Two
//     neighbouring 8-key C tiles, packed to the input dtype, are the A
//     operand of PV with no shuffle (h16_mma.cuh).
//   - Full tiles run without live-key tests; the ragged last tile computes
//     only its live 8-key groups.
//   - Query tiles of 16 rows per warp spread evenly over a head's blocks
//     (tf32::tiling): N = 196 takes four blocks of 4 warps.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>
#include <type_traits>

#include "h16_mma.cuh"

namespace {

constexpr int kBK = 32;        // keys per tile
constexpr int kNT = kBK / 8;   // 8-key groups per tile
constexpr int kStages = 2;     // K, V ring
constexpr int kMaxThreads = 32 * tf32::kMaxWarps;

// Shared memory, in elements: Q [16 W][ld], then each stage's K and V
// [kBK][ld].
template <int NK>
int smem_elems(int warps) {
  return (16 * warps + 2 * kStages * kBK) * (16 * NK + 8);
}

template <typename T, int NK>
__global__ void __launch_bounds__(kMaxThreads)
    attention_h16_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             float* __restrict__ lse, int n, int d, int q_tiles,
                             float scale_log2, bool vec) {
  constexpr int kDp = 16 * NK;
  constexpr int kLd = kDp + 8;
  constexpr int kDT = kDp / 8;  // 8-wide column groups of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warps = blockDim.x / 32;
  const int bq = 16 * warps;
  T* qs = smem;                 // [bq][kLd]
  T* ring = qs + bq * kLd;      // stage s: K at ring + 2 s kBK kLd, V after it

  // query tiles of one head are neighbouring blocks, so the head's keys and
  // values come from device memory about once and from L2 after that
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * bq;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const T* kh = k + head;
  const T* vh = v + head;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int wr = 16 * warp;  // the warp's first row in the tile
  const bool warp_live = q0 + wr < n;
  const int k_tiles = (n + kBK - 1) / kBK;

  auto load_stage = [&](int j) {
    T* st = ring + (j % kStages) * 2 * kBK * kLd;
    h16::load_tile<kDp>(st, kh, j * kBK, kBK, n, d, vec, tid, nthreads);
    h16::load_tile<kDp>(st + kBK * kLd, vh, j * kBK, kBK, n, d, vec, tid, nthreads);
  };
  h16::load_tile<kDp>(qs, q + head, q0, bq, n, d, vec, tid, nthreads);
  load_stage(0);
  tf32::cp_commit();

  float acc[kDT][4];
#pragma unroll
  for (int c = 0; c < kDT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  // running max (log2 units) and this lane's part of the running sum, of
  // rows g and g + 8 of the warp's 16
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  uint32_t qa[NK][4];  // the warp's Q A fragments, one per 16 dims

  for (int kt = 0; kt < k_tiles; ++kt) {
    tf32::cp_wait<0>();  // tile kt has landed
    __syncthreads();     // ... for every thread, and tile kt - 1 is consumed
    if (kt + 1 < k_tiles) load_stage(kt + 1);
    tf32::cp_commit();
    if (kt == 0 && warp_live) {
#pragma unroll
      for (int c = 0; c < NK; ++c) h16::a_frag(qa[c], qs, kLd, wr, 16 * c, lane);
    }

    const T* ks = ring + (kt % kStages) * 2 * kBK * kLd;
    const T* vs = ks + kBK * kLd;
    const int kn = min(kBK, n - kt * kBK);  // live keys of the tile
    auto tile = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
      const int live_nt = kFull ? kNT : (kn + 7) / 8;

      // S = Q K^T for the warp's 16 rows, live 8-key groups only
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int c = 0; c < NK; ++c) {
#pragma unroll
        for (int jp = 0; jp < kNT / 2; ++jp) {
          if (kFull || 2 * jp < live_nt) {
            uint32_t b[4];
            h16::b_frags_t(b, ks, kLd, 16 * jp, 16 * c, lane);
            h16::mma<T>(s[2 * jp], qa[c], b[0], b[1]);
            if (kFull || 2 * jp + 1 < live_nt) h16::mma<T>(s[2 * jp + 1], qa[c], b[2], b[3]);
          }
        }
      }

      // online softmax in log2 units, in float32: scale, mask keys past N,
      // fold the tile into each row's max, rescale what was summed under
      // the old one
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

      // O += P V, P rounded to T from the score registers, 16 keys a step
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {
        if (kFull || 2 * jp < live_nt) {
          uint32_t a[4];
          h16::a_from_c<T>(a, s[2 * jp], s[2 * jp + 1]);
#pragma unroll
          for (int cp = 0; cp < kDT / 2; ++cp) {
            uint32_t b[4];
            h16::b_frags(b, vs, kLd, 16 * jp, 16 * cp, lane);
            h16::mma<T>(acc[2 * cp], a, b[0], b[1]);
            h16::mma<T>(acc[2 * cp + 1], a, b[2], b[3]);
          }
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
  T* oh = o + head;
  const int g = lane / 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int c = 0; c < kDT; ++c)
      h16::store_pair(oh + static_cast<size_t>(row) * d, 8 * c + 2 * t, d,
                      acc[c][2 * r] * inv, acc[c][2 * r + 1] * inv);
    // log-sum-exp of the row's scaled scores, for the backward pass
    if (lse != nullptr && t == 0)
      lse[static_cast<size_t>(bh) * n + row] = (m_run[r] + log2f(l_run[r])) * tf32::kLn2;
  }
}

template <typename T, int NK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   long long bh, int n, int d, float scale, bool vec, cudaStream_t stream) {
  const tf32::Tiling tl = tf32::tiling(n);
  const int bytes = smem_elems<NK>(tl.warps) * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      attention_h16_fwd_kernel<T, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = bh * tl.tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  attention_h16_fwd_kernel<T, NK>
      <<<static_cast<unsigned>(blocks), 32 * tl.warps, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(o), lse, n, d, tl.tiles, scale * tf32::kLog2e, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     long long bh, int n, int d, float scale, bool vec, cudaStream_t s) {
  switch ((d + 15) / 16) {
    case 1: return launch<T, 1>(q, k, v, o, lse, bh, n, d, scale, vec, s);
    case 2: return launch<T, 2>(q, k, v, o, lse, bh, n, d, scale, vec, s);
    case 3: return launch<T, 3>(q, k, v, o, lse, bh, n, d, scale, vec, s);
    case 4: return launch<T, 4>(q, k, v, o, lse, bh, n, d, scale, vec, s);
    case 5: return launch<T, 5>(q, k, v, o, lse, bh, n, d, scale, vec, s);
    case 6: return launch<T, 6>(q, k, v, o, lse, bh, n, d, scale, vec, s);
    case 7: return launch<T, 7>(q, k, v, o, lse, bh, n, d, scale, vec, s);
    default: return launch<T, 8>(q, k, v, o, lse, bh, n, d, scale, vec, s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// C entry for ctypes.  bh = B * H; q, k, v, o are device pointers to
// contiguous (B, H, N, D) tensors of one 16-bit type, `element` 0 for fp16
// and 1 for bf16; lse is null, or a (B, H, N) float32 tensor that gets
// each row's log-sum-exp; stream is a cudaStream_t.  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int attention_h16_fwd(const void* q, const void* k, const void* v, void* o,
                                 void* lse, long long bh, int n, int d, float scale,
                                 int element, void* stream) {
  if (bh <= 0 || n <= 0 || d <= 0 || d > 128 || (element != 0 && element != 1))
    return cudaErrorInvalidValue;
  // 16-byte row chunks when every row starts 16-byte aligned
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  auto* fl = static_cast<float*>(lse);
  auto s = static_cast<cudaStream_t>(stream);
  if (element == 1) return dispatch<__nv_bfloat16>(q, k, v, o, fl, bh, n, d, scale, vec, s);
  return dispatch<__half>(q, k, v, o, fl, bh, n, d, scale, vec, s);
}

extern "C" const char* attention_h16_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
