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
// one bf16 pass at its default precision; the max, the row sums and the
// log-sum-exp stay float32 and are taken over the unrounded P.
//
// Bounds on an H100 SXM, at the ViT-B shapes (256 or 512, 12, 196, 64):
//   operations: QK^T and PV, 4 * N^2 * D * B * H = 30.2 (60.4) GFLOP,
//          0.031 (0.061) ms at the tensor cores' 989 TFLOP/s dense bf16;
//   bytes: q, k, v read once and o written once, 4 * B*H*N*D * 2 B = 308
//          (617) MB, 0.092 (0.184) ms at 3.35 TB/s.
// Bound by bytes, 3.0x above the operations.
//
// Design: the Pallas kernel's own, one whole head at a time (it holds the
// head's scores in VMEM), on Hopper's warpgroup products (wgmma.cuh):
//   - One block of one warpgroup per (batch, head) while N <= 256 (128 at D
//     > 64).  The head's K and V are read once, into swizzled shared memory
//     (53 KB at N = 196, D = 64), and stay there while the warpgroup walks
//     the head's 64-row query tiles, each copied in by cp.async while the
//     one before it computes (two stages).
//   - Per tile, S = Q K^T is one wgmma chain over the head dim, A and B
//     from shared memory, into registers: 16 * ceil(N / 16) keys wide (208,
//     104 floats a thread, at N = 196), in 64-key products and a 16-key
//     tail.  Then one exact softmax in registers, with no online rescale:
//     each row's max and sum over the four lanes that hold it.
//   - O = P V is one wgmma chain over the keys, P rounded to the input dtype
//     as the A operand from the score registers, V from shared memory.
//   - No branch parts a chain of products (the head dim's padding and the
//     keys past N are computed and masked, not skipped), or ptxas serialises
//     them all (C7520).
//   - Three blocks an SM where their shared memory fits (N <= 208 at D <=
//     64: 70 KB each), registers capped to 168 a thread to match: a block
//     waits on its products, the other two fill the gaps.
//   - N > 256: one block per 64-row query tile walks 128-key tiles of K and
//     V with the online softmax (the running max and sum, and O rescaled
//     between tiles), each tile copied in after the last one is consumed.
//   Tried on the H100 and not kept (PERF.md, section 6): two blocks an SM (255
//   registers); a persistent block of two warpgroups an SM with the next
//   head's K and V copied in ahead; V copied in behind K.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>

#include "wgmma.cuh"

namespace {

constexpr int kBM = 64;  // query rows per tile

// One warpgroup's 64-row query tile against a key tile of 16 KC keys in
// shared memory (K and V [16 KC][64 NA], Q [kBM][64 NA], swizzled), kn of
// them live: S = Q K^T, the softmax in float32 registers, O += P V.  m_run
// and l_run hold each of the thread's two rows' max (log2 units) and its
// part of the row's sum; acc the unnormalised O.  kOnline: over the key
// tiles so far, acc overwritten on the first (kt == 0) and rescaled as the
// max grows; else the whole row is in this tile (m_run, l_run, acc are
// written, and acc is not live before PV).
template <typename T, int NA, int KC, bool kOnline>
__device__ __forceinline__ void tile_product(const unsigned char* qs, const unsigned char* ks,
                                             const unsigned char* vs, int kt, int kn,
                                             float scale_log2, int t, float (&acc)[NA][32],
                                             float (&m_run)[2], float (&l_run)[2]) {
  constexpr int kKeys = 16 * KC;  // key rows of the K and V tiles
  constexpr int kFull = KC / 4;   // 64-key products of S
  constexpr int kTail = KC % 4;   // 16-key units of the tail product
  constexpr int kGroups = 2 * KC; // 8-key groups of S

  // S = Q K^T: 64-key products, then the tail, over the head dim (its zero
  // padding too: no branch may part a chain of products, or the compiler
  // serialises them)
  float s[kFull > 0 ? kFull : 1][32];
  float st[kTail > 0 ? 8 * kTail : 1];
  h16::fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NA; ++kk) {
    const int atom = kk / 4, col = (kk % 4) * 32;  // bytes into the row
    const uint64_t da = h16::desc(qs + atom * kBM * 128 + col, 16, 1024);
#pragma unroll
    for (int c = 0; c < kFull; ++c)
      h16::wgmma_ss<T, 0, 0>(s[c], da,
                             h16::desc(ks + atom * kKeys * 128 + c * 64 * 128 + col, 16, 1024),
                             kk > 0);
    if constexpr (kTail > 0)
      h16::wgmma_ss<T, 0, 0>(st, da,
                             h16::desc(ks + atom * kKeys * 128 + kFull * 64 * 128 + col, 16,
                                       1024),
                             kk > 0);
  }
  h16::commit();
  h16::wait<0>();
#pragma unroll
  for (int c = 0; c < kFull; ++c) h16::fence_operand(s[c]);
  if constexpr (kTail > 0) h16::fence_operand(st);
  // the 4 values of 8-key group j (keys 8j + 2t, +1 of rows g, g + 8)
  auto grp = [&](int j) -> float* {
    return j < 8 * kFull ? &s[j / 8][4 * (j % 8)] : &st[4 * (j - 8 * kFull)];
  };

  // softmax in log2 units, float32: scale, mask keys past N, the max, P,
  // and each row's sum; online, what was summed under an older max is
  // rescaled
  float mx[2] = {-INFINITY, -INFINITY};
  if constexpr (kOnline) mx[0] = m_run[0], mx[1] = m_run[1];
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    float* x = grp(j);
    if (8 * j + 8 <= kn) {  // a group of live keys (all but the last ones)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= scale_log2;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = 8 * j + 2 * t + (e & 1) < kn ? x[e] * scale_log2 : -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], x[e]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (kOnline) {
      alpha[r] = h16::exp2_ftz(m_run[r] - mx[r]);  // 0 on the first tile
      l_run[r] *= alpha[r];
    } else {
      l_run[r] = 0.f;
    }
    m_run[r] = mx[r];
  }
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    float* x = grp(j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = h16::exp2_ftz(x[e] - m_run[e / 2]);
      l_run[e / 2] += x[e];
    }
  }
  if constexpr (kOnline) {  // (on the first tile acc is overwritten below)
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[a][i] *= alpha[(i / 2) & 1];
  }

  // O += P V, P rounded to T from the score registers, 16 keys a step
  // (keys past N: P = 0 and V's rows zero)
  uint32_t pa[KC][4];
#pragma unroll
  for (int u = 0; u < KC; ++u) h16::pack_a<T>(pa[u], grp(2 * u));  // groups 2u, 2u + 1
  h16::fence();
#pragma unroll
  for (int u = 0; u < KC; ++u)
#pragma unroll
    for (int a = 0; a < NA; ++a)
      h16::wgmma_rs<T, 1>(acc[a], pa[u],
                          h16::desc(vs + a * kKeys * 128 + u * 16 * 128, kKeys * 128, 1024),
                          kt > 0 || u > 0);
  h16::commit();
  h16::wait<0>();
#pragma unroll
  for (int a = 0; a < NA; ++a) h16::fence_operand(acc[a]);
}

// O / sum in T for the warpgroup's tile at query row q0 of a head, and the
// log-sum-exp of each row into lse_h when it is not null.
template <typename T, int NA>
__device__ __forceinline__ void store_tile(T* oh, float* lse_h, int q0, int n, int d, int warp,
                                           int g, int t, const float (&acc)[NA][32],
                                           const float (&m_run)[2], float (&l_run)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= n) continue;
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        h16::store_pair(oh + static_cast<size_t>(row) * d, 64 * a + 8 * j + 2 * t, d,
                        acc[a][4 * j + 2 * r] * inv, acc[a][4 * j + 2 * r + 1] * inv);
    if (lse_h != nullptr && t == 0) lse_h[row] = (m_run[r] + log2f(l_run[r])) * tf32::kLn2;
  }
}

// The whole head in one key tile (N <= 16 KC): one block of one warpgroup
// per (batch, head).  K and V are copied in once and stay; the warpgroup
// walks the head's 64-row query tiles, each copied into one of two stages
// while the one before it computes.  Three blocks an SM where their shared
// memory fits (N <= 208 at D <= 64: 70 KB each), their registers capped to
// match (168 a thread), else two.
constexpr int kHeadThreads = 128;

template <int NA, int KC>
constexpr int head_smem_bytes() {
  return 2 * NA * 16 * KC * 128 + 2 * NA * kBM * 128 + 1024;
}

template <int NA, int KC>
constexpr int kHeadBlocks = 3 * head_smem_bytes<NA, KC>() <= 232448 ? 3 : 2;

template <typename T, int NA, int KC>
__global__ void __launch_bounds__(kHeadThreads, (kHeadBlocks<NA, KC>))
    attention_h16_fwd_head_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v, T* __restrict__ o,
                                  float* __restrict__ lse, int n, int d, float scale_log2,
                                  bool vec) {
  constexpr int kKeys = 16 * KC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = h16::align1024(smem_raw);
  unsigned char* vs = ks + NA * kKeys * 128;
  auto stage = [&](int i) { return vs + NA * kKeys * 128 + (i & 1) * NA * kBM * 128; };
  const int bh = blockIdx.x;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const int q_tiles = (n + kBM - 1) / kBM;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  h16::load_tile<NA>(ks, k + head, 0, kKeys, n, d, vec, tid, kHeadThreads);
  h16::load_tile<NA>(vs, v + head, 0, kKeys, n, d, vec, tid, kHeadThreads);
  h16::load_tile<NA>(stage(0), q + head, 0, kBM, n, d, vec, tid, kHeadThreads);
  tf32::cp_commit();
  for (int qt = 0; qt < q_tiles; ++qt) {
    tf32::cp_wait<0>();  // tile qt (and at first K, V) has landed
    h16::proxy_fence();
    __syncthreads();     // ... for every thread; tile qt - 1 is consumed
    if (qt + 1 < q_tiles)
      h16::load_tile<NA>(stage(qt + 1), q + head, (qt + 1) * kBM, kBM, n, d, vec, tid,
                         kHeadThreads);
    tf32::cp_commit();
    float acc[NA][32];
    float m_run[2], l_run[2];
    tile_product<T, NA, KC, false>(stage(qt), ks, vs, 0, n, scale_log2, t, acc, m_run, l_run);
    store_tile<T, NA>(o + head, lse == nullptr ? nullptr : lse + static_cast<size_t>(bh) * n,
                      qt * kBM, n, d, warp, g, t, acc, m_run, l_run);
  }
  tf32::cp_wait<0>();
}

// N past the keys a block holds: one block of one warpgroup per 64-row
// query tile walks 128-key tiles of K and V with the online softmax, each
// tile copied in after the last one is consumed.
constexpr int kTiledThreads = 128;
constexpr int kTileKc = 8;  // 16-key units of a key tile

template <int NA>
constexpr int tiled_smem_bytes() {
  return 2 * NA * 16 * kTileKc * 128 + NA * kBM * 128 + 1024;
}

template <typename T, int NA>
__global__ void __launch_bounds__(kTiledThreads)
    attention_h16_fwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, T* __restrict__ o,
                                   float* __restrict__ lse, int n, int d, float scale_log2,
                                   bool vec) {
  constexpr int kKeys = 16 * kTileKc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks = h16::align1024(smem_raw);
  unsigned char* vs = ks + NA * kKeys * 128;
  unsigned char* qs = vs + NA * kKeys * 128;
  const int q_tiles = (n + kBM - 1) / kBM;
  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x % q_tiles;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  float acc[NA][32];
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  h16::load_tile<NA>(qs, q + head, qt * kBM, kBM, n, d, vec, tid, kTiledThreads);
  for (int kt = 0; kt * kKeys < n; ++kt) {
    if (kt > 0) __syncthreads();  // every warp is done with the last key tile
    h16::load_tile<NA>(ks, k + head, kt * kKeys, kKeys, n, d, vec, tid, kTiledThreads);
    h16::load_tile<NA>(vs, v + head, kt * kKeys, kKeys, n, d, vec, tid, kTiledThreads);
    tf32::cp_commit();
    tf32::cp_wait<0>();
    h16::proxy_fence();
    __syncthreads();
    tile_product<T, NA, kTileKc, true>(qs, ks, vs, kt, min(kKeys, n - kt * kKeys), scale_log2,
                                       t, acc, m_run, l_run);
  }
  store_tile<T, NA>(o + head, lse == nullptr ? nullptr : lse + static_cast<size_t>(bh) * n,
                    qt * kBM, n, d, warp, g, t, acc, m_run, l_run);
}

template <typename T, int NA, int KC>
cudaError_t launch_head(const void* q, const void* k, const void* v, void* o, float* lse,
                        long long bh, int n, int d, float scale, bool vec, cudaStream_t stream) {
  constexpr int bytes = head_smem_bytes<NA, KC>();
  cudaError_t err = cudaFuncSetAttribute(attention_h16_fwd_head_kernel<T, NA, KC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if (bh > INT_MAX) return cudaErrorInvalidConfiguration;
  attention_h16_fwd_head_kernel<T, NA, KC>
      <<<static_cast<unsigned>(bh), kHeadThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(o), lse, n, d, scale * tf32::kLog2e, vec);
  return cudaGetLastError();
}

template <typename T, int NA>
cudaError_t launch_tiled(const void* q, const void* k, const void* v, void* o, float* lse,
                         long long bh, int n, int d, float scale, bool vec, cudaStream_t stream) {
  constexpr int bytes = tiled_smem_bytes<NA>();
  cudaError_t err = cudaFuncSetAttribute(attention_h16_fwd_tiled_kernel<T, NA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = bh * ((n + kBM - 1) / kBM);
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  attention_h16_fwd_tiled_kernel<T, NA>
      <<<static_cast<unsigned>(blocks), kTiledThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
          static_cast<T*>(o), lse, n, d, scale * tf32::kLog2e, vec);
  return cudaGetLastError();
}

// The whole head at once, 16 * KC >= N keys (208 for ViT's 196 or 197 and
// below, 256), while N <= 256 (D <= 64) or N <= 128 (D > 64, whose 64 more
// output columns take the registers); else 128-key tiles.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
                     long long bh, int n, int d, float scale, bool vec, cudaStream_t s) {
  if (d > 64) {
    if (n <= 128) return launch_head<T, 2, 8>(q, k, v, o, lse, bh, n, d, scale, vec, s);
    return launch_tiled<T, 2>(q, k, v, o, lse, bh, n, d, scale, vec, s);
  }
  if (n <= 208) return launch_head<T, 1, 13>(q, k, v, o, lse, bh, n, d, scale, vec, s);
  if (n <= 256) return launch_head<T, 1, 16>(q, k, v, o, lse, bh, n, d, scale, vec, s);
  return launch_tiled<T, 1>(q, k, v, o, lse, bh, n, d, scale, vec, s);
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
