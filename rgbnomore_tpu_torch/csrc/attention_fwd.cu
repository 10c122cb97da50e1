// Fused softmax attention, forward: O = softmax(scale * Q K^T) V, float32,
// and, when asked for, each query row's log-sum-exp of its scaled scores,
// which the backward kernel (attention_bwd.cu) rebuilds P from.
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:_fwd_kernel
// (:39-48), which _attention_impl (:77-95) launches for fused_attention.
// Same function, same call contract: q, k, v, o are (B, H, N, D) float32,
// contiguous, with any N >= 1 and D <= 128.  The TPU version padded N to 256
// and D to 128 for its tiles and masked the padded keys; here nothing is
// padded in device memory, and only keys >= N are left out of the softmax.
//
// Bound on an H100 SXM, at the ViT-Ti eval shape (256, 3, 196, 64):
//   bytes: q, k, v read once and o written once, 4 * 256*3*196*64 * 4 B
//          = 154 MB, 46 us at 3.35 TB/s;
//   operations: QK^T and PV, 2 * 2*N*N*D per (batch, head), 7.55 GFLOP of
//          float32 multiply-adds, 113 us at the 67 TFLOP/s of the float32
//          CUDA cores (the tensor cores take float32 only as TF32, which
//          would not keep the reference's precision).
// So the kernel is bound by float32 operations, not by bytes.
//
// What the design does about that bound:
//   - The (N, N) scores never reach device memory: each block streams the
//     head's keys and values through shared memory in 64-key tiles and keeps
//     a running max and sum per query row (the online softmax), so device
//     memory sees q, k, v once per query tile and o once.
//   - One block per (batch*head, 64 query rows), 256 threads.  Each thread
//     owns 4 query rows x 4 key columns of a score tile and 4 query rows x
//     D/16 output columns, so every value read from shared memory feeds 4
//     multiply-adds; column lanes read neighbouring words (no bank
//     conflicts), and the key tile is stored transposed with a padded stride
//     for the same reason.
//   - Work past the edges is skipped, not masked: row groups past N do no
//     arithmetic, and the last key tile computes only its live 16-column
//     groups (N = 196 leaves 4 keys in the last tile).
//   - About 67 KB of shared memory at D = 64 lets three blocks share an SM.
// Left for later work: the exp of the online softmax runs on 64 threads of
// the block, and bf16/TF32 tensor-core (wgmma) and TMA versions.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kTM = 4;         // query rows per thread
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLd = kBK + 1;   // padded stride of the key-indexed arrays

// Shared memory, in floats, for D <= 16 * NC.
template <int NC>
constexpr int smem_floats() {
  return kBQ * (16 * NC + 1)  // query tile        [kBQ][Dp + 1]
         + 16 * NC * kLd      // key tile, K^T    [Dp][kLd]
         + kBK * 16 * NC      // value tile       [kBK][Dp]
         + kBQ * kLd          // scores, then P   [kBQ][kLd]
         + 2 * kBQ;           // row rescale and row sums
}

// Scores of this thread's 4 rows x JG column groups of one key tile,
// scaled, into ps.  JG is the number of 16-wide column groups that hold a
// live key, so the last, partial tile does only the work it needs.
template <int NC, int JG>
__device__ __forceinline__ void score_tile(const float* __restrict__ qs,
                                           const float* __restrict__ kt,
                                           float* __restrict__ ps, int r0,
                                           int tc, float scale) {
  constexpr int kDp = 16 * NC;
  constexpr int kLq = kDp + 1;
  float s[kTM][JG];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < JG; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int c = 0; c < kDp; ++c) {
    float qv[kTM], kv[JG];
#pragma unroll
    for (int i = 0; i < kTM; ++i) qv[i] = qs[(r0 + i) * kLq + c];
#pragma unroll
    for (int j = 0; j < JG; ++j) kv[j] = kt[c * kLd + tc + 16 * j];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < JG; ++j) ps[(r0 + i) * kLd + tc + 16 * j] = s[i][j] * scale;
}

// at least 3 resident blocks: that caps registers at 80 a thread, which the
// D <= 64 instantiations would otherwise cut to 64 with spills
template <int NC>
__global__ void __launch_bounds__(kThreads, 3)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int n, int d, int q_tiles, float scale) {
  constexpr int kDp = 16 * NC;
  constexpr int kLq = kDp + 1;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][kLq]
  float* kt = qs + kBQ * kLq;         // [kDp][kLd]
  float* vs = kt + kDp * kLd;         // [kBK][kDp]
  float* ps = vs + kBK * kDp;         // [kBQ][kLd]
  float* row_scale = ps + kBQ * kLd;  // [kBQ]
  float* row_sum = row_scale + kBQ;   // [kBQ]

  // query tiles of one head are neighbouring blocks, so the head's keys and
  // values are read from device memory about once and from L2 after that
  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kBQ;
  const size_t head = static_cast<size_t>(bh) * n * d;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;
  float* oh = o + head;

  const int tid = threadIdx.x;
  const int tr = tid / 16;          // row group
  const int tc = tid % 16;          // column lane
  const int r0 = tr * kTM;          // this thread's first row in the tile
  const bool rows_live = q0 + r0 < n;

  for (int i = tid; i < kBQ * kDp; i += kThreads) {
    const int r = i / kDp, c = i % kDp;
    qs[r * kLq + c] =
        (q0 + r < n && c < d) ? qh[static_cast<size_t>(q0 + r) * d + c] : 0.f;
  }

  float acc[kTM][NC];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  // running max and sum of row `tid`, kept by the first kBQ threads
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    const int kn = min(kBK, n - k0);
    __syncthreads();  // the previous tile's P and V are no longer read
    for (int i = tid; i < kBK * kDp; i += kThreads) {
      const int j = i / kDp, c = i % kDp;
      const bool live = j < kn && c < d;
      const size_t g = static_cast<size_t>(k0 + j) * d + c;
      kt[c * kLd + j] = live ? kh[g] : 0.f;
      vs[j * kDp + c] = live ? vh[g] : 0.f;
    }
    __syncthreads();

    if (rows_live) {
      switch ((kn + 15) / 16) {
        case 1: score_tile<NC, 1>(qs, kt, ps, r0, tc, scale); break;
        case 2: score_tile<NC, 2>(qs, kt, ps, r0, tc, scale); break;
        case 3: score_tile<NC, 3>(qs, kt, ps, r0, tc, scale); break;
        default: score_tile<NC, 4>(qs, kt, ps, r0, tc, scale); break;
      }
    }
    __syncthreads();

    // online softmax: fold this tile's keys into row tid's max and sum,
    // turn its scores into exp(s - max), and leave the factor that rescales
    // the output accumulated so far under the old max
    if (tid < kBQ) {
      float* prow = ps + tid * kLd;
      float m_new = m_run;
      for (int j = 0; j < kn; ++j) m_new = fmaxf(m_new, prow[j]);
      float sum = 0.f;
      for (int j = 0; j < kn; ++j) {
        const float p = expf(prow[j] - m_new);
        prow[j] = p;
        sum += p;
      }
      const float alpha = expf(m_run - m_new);  // 0 on the first tile
      l_run = l_run * alpha + sum;
      m_run = m_new;
      row_scale[tid] = alpha;
    }
    __syncthreads();

    if (rows_live) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float a = row_scale[r0 + i];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= a;
      }
#pragma unroll 4
      for (int j = 0; j < kn; ++j) {
        float pv[kTM], vv[NC];
#pragma unroll
        for (int i = 0; i < kTM; ++i) pv[i] = ps[(r0 + i) * kLd + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = vs[j * kDp + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }

  if (tid < kBQ) {
    row_sum[tid] = l_run;
    // log-sum-exp of the row's scaled scores, for the backward pass
    if (lse != nullptr && q0 + tid < n)
      lse[static_cast<size_t>(bh) * n + q0 + tid] = m_run + logf(l_run);
  }
  __syncthreads();
  if (rows_live) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = q0 + r0 + i;
      if (r >= n) continue;
      const float inv = 1.f / row_sum[r0 + i];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tc + 16 * c;
        if (col < d) oh[static_cast<size_t>(r) * d + col] = acc[i][c] * inv;
      }
    }
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, float* lse,
                   long long bh, int n, int d, float scale, cudaStream_t stream) {
  const int bytes = smem_floats<NC>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int q_tiles = (n + kBQ - 1) / kBQ;
  const long long blocks = bh * q_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  attention_fwd_kernel<NC><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      q, k, v, o, lse, n, d, q_tiles, scale);
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
