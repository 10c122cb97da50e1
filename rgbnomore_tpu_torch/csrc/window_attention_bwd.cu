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
// Bound on an H100 SXM, per (window, head) at N = 64, D = 32:
//   operations: the five products (QK^T, dO V^T, P^T dO, dS K, dS^T Q),
//          10*N^2*D = 1.31 MFLOP of float32 multiply-adds, 19.6 ns at the
//          67 TFLOP/s of the float32 CUDA cores;
//   bytes: q, k, v, dO read once, dq, dk, dv written once, 7 * N*D * 4 B =
//          56 KB, 17.1 ns at 3.35 TB/s (the bias and its gradient are small).
// Stage 1 of SwinV2-T at batch 128 (24,576 units): about 0.48 ms, operations
// and bytes within 15% of each other.
//
// What the design does about that bound:
//   - A whole window fits a block: q, dO (row-major), k, v (transposed),
//     P and dS (64 x 64 each) take 67 KB of shared memory at D = 32, so each
//     input is read once, S is computed once, and nothing of size N^2 per
//     window reaches device memory.
//   - The register tiling of the forward kernel: each thread owns 4 rows x
//     4 columns of S and dP (built in one pass over D), then 4 keys x D/16
//     columns of dV and dK, then 4 rows x D/16 columns of dQ; each word read
//     from shared memory feeds 4 or 8 multiply-adds, column lanes read
//     neighbouring words, and the key-indexed arrays use a padded stride.
//   - The row max, sum and rowsum(dP * P) are half-warp shuffles.
//   - At most 128 registers a thread, so two blocks share an SM (without
//     the cap the main path's instance took 180, one block per SM).
//   - Every parameter is a kernel argument, held in registers: no parameter
//     is read through shared memory across a barrier.
// Left for later work: overlapping the next window's loads with this one's
// products (cp.async), and bf16 tensor cores (wgmma) under AMP.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kN = 64;         // tokens per window, at most
constexpr int kTM = 4;         // rows (or keys) per thread
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLd = kN + 1;    // padded stride of the token-indexed arrays

// Shared memory, in floats, for D <= 16 * NC.
template <int NC>
constexpr int smem_floats() {
  return 2 * kN * (16 * NC + 1)  // q, dO, row-major  [kN][Dp + 1]
         + 2 * 16 * NC * kLd     // k, v, transposed  [Dp][kLd]
         + 2 * kN * kLd;         // P, dS             [kN][kLd]
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int NC>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int n, int d) {
  constexpr int kDp = 16 * NC;
  for (int i = threadIdx.x; i < kN * kDp; i += kThreads) {
    const int r = i / kDp, c = i % kDp;
    dst[r * (kDp + 1) + c] = (r < n && c < d) ? src[r * d + c] : 0.f;
  }
}

template <int NC>
__device__ __forceinline__ void load_cols(float* __restrict__ dst, const float* __restrict__ src,
                                          int n, int d) {
  constexpr int kDp = 16 * NC;
  for (int i = threadIdx.x; i < kN * kDp; i += kThreads) {
    const int j = i / kDp, c = i % kDp;
    dst[c * kLd + j] = (j < n && c < d) ? src[j * d + c] : 0.f;
  }
}

template <int NC, int JG>
__global__ void __launch_bounds__(kThreads, 2)
    window_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ dout, float* __restrict__ dq,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ partial, int h, int n, int d, int npat,
                      int per_pattern, int chunk, int chunks) {
  constexpr int kDp = 16 * NC;
  constexpr int kLq = kDp + 1;
  extern __shared__ float smem[];
  float* qs = smem;             // [kN][kLq]
  float* dos = qs + kN * kLq;   // [kN][kLq]
  float* kt = dos + kN * kLq;   // [kDp][kLd]
  float* vt = kt + kDp * kLd;   // [kDp][kLd]
  float* ps = vt + kDp * kLd;   // [kN][kLd]
  float* dss = ps + kN * kLd;   // [kN][kLd]

  // blockIdx.x = (p * chunks + ch) * h + head: the layout of the partials
  const int head = blockIdx.x % h;
  const int p = blockIdx.x / h / chunks, ch = blockIdx.x / h % chunks;
  const float* bp = bias + (static_cast<size_t>(p) * h + head) * n * n;
  const int tid = threadIdx.x, tc = tid % 16, r0 = (tid / 16) * kTM;

  float db[kTM][JG];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < JG; ++j) db[i][j] = 0.f;

  const int t_end = min(per_pattern, (ch + 1) * chunk);
  for (int t = ch * chunk; t < t_end; ++t) {
    const long long w = p + static_cast<long long>(t) * npat;
    const size_t base = (static_cast<size_t>(w) * h + head) * n * d;
    __syncthreads();  // the previous window's tiles are no longer read
    load_rows<NC>(qs, q + base, n, d);
    load_rows<NC>(dos, dout + base, n, d);
    load_cols<NC>(kt, k + base, n, d);
    load_cols<NC>(vt, v + base, n, d);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, this thread's 4 rows x JG column groups
    float s[kTM][JG], dp[kTM][JG];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < JG; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kDp; ++c) {
      float qv[kTM], gv[kTM], kv[JG], vv[JG];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        qv[i] = qs[(r0 + i) * kLq + c];
        gv[i] = dos[(r0 + i) * kLq + c];
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        kv[j] = kt[c * kLd + tc + 16 * j];
        vv[j] = vt[c * kLd + tc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < JG; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

    // P and dS.  Every thread runs this, so the half-warp shuffles see all
    // their lanes; entries outside the window get P = dS = 0.
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = r0 + i;
      const bool row_live = r < n;
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        const int col = tc + 16 * j;
        if (col >= n) {
          s[i][j] = -INFINITY;
        } else if (row_live) {
          s[i][j] += __ldg(bp + r * n + col);
        } else {
          s[i][j] = 0.f;
        }
        m = fmaxf(m, s[i][j]);
      }
      m = group_max(m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        s[i][j] = expf(s[i][j] - m);
        sum += s[i][j];
      }
      sum = group_sum(sum);
      float delta = 0.f;
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        s[i][j] = row_live ? s[i][j] / sum : 0.f;
        delta = fmaf(s[i][j], dp[i][j], delta);
      }
      delta = group_sum(delta);
#pragma unroll
      for (int j = 0; j < JG; ++j) {
        const float g = s[i][j] * (dp[i][j] - delta);
        db[i][j] += g;
        ps[r * kLd + tc + 16 * j] = s[i][j];
        dss[r * kLd + tc + 16 * j] = g;
      }
    }
    __syncthreads();

    if (r0 < n) {
      // dV and dK of keys r0..r0+3: sums over the window's query rows
      float av[kTM][NC], ak[kTM][NC];
#pragma unroll
      for (int kk = 0; kk < kTM; ++kk)
#pragma unroll
        for (int c = 0; c < NC; ++c) av[kk][c] = ak[kk][c] = 0.f;
#pragma unroll 2
      for (int i = 0; i < n; ++i) {
        float pv[kTM], gv[kTM], dov[NC], qv[NC];
#pragma unroll
        for (int kk = 0; kk < kTM; ++kk) {
          pv[kk] = ps[i * kLd + r0 + kk];
          gv[kk] = dss[i * kLd + r0 + kk];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dos[i * kLq + tc + 16 * c];
          qv[c] = qs[i * kLq + tc + 16 * c];
        }
#pragma unroll
        for (int kk = 0; kk < kTM; ++kk)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            av[kk][c] = fmaf(pv[kk], dov[c], av[kk][c]);
            ak[kk][c] = fmaf(gv[kk], qv[c], ak[kk][c]);
          }
      }
      // dQ of rows r0..r0+3: sums over the window's keys
      float aq[kTM][NC];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) aq[i][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float gv[kTM], kv[NC];
#pragma unroll
        for (int i = 0; i < kTM; ++i) gv[i] = dss[(r0 + i) * kLd + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) kv[c] = kt[(tc + 16 * c) * kLd + j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) aq[i][c] = fmaf(gv[i], kv[c], aq[i][c]);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = r0 + i;
        if (r >= n) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tc + 16 * c;
          if (col < d) {
            const size_t at = base + static_cast<size_t>(r) * d + col;
            dv[at] = av[i][c];
            dk[at] = ak[i][c];
            dq[at] = aq[i][c];
          }
        }
      }
    }
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * n * n;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < JG; ++j) {
      const int col = tc + 16 * j;
      if (col < n) out[r * n + col] = db[i][j];
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

template <int NC, int JG>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* dout, float* partial, float* dq, float* dk, float* dv,
                   float* db, long long blocks, int h, int n, int d, int npat,
                   int per_pattern, int chunk, int chunks, cudaStream_t stream) {
  const int bytes = smem_floats<NC>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(window_bwd_kernel<NC, JG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  window_bwd_kernel<NC, JG><<<static_cast<unsigned>(blocks), kThreads, bytes, stream>>>(
      q, k, v, bias, dout, dq, dk, dv, partial, h, n, d, npat, per_pattern, chunk, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(npat) * h * n * n;
  const long long reduce_blocks = (total + kThreads - 1) / kThreads;
  db_reduce_kernel<<<static_cast<unsigned>(reduce_blocks), kThreads, 0, stream>>>(
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
  if (bw <= 0 || h <= 0 || n <= 0 || n > kN || d <= 0 || d > 64 || npat <= 0 ||
      bw % npat != 0 || chunk <= 0)
    return cudaErrorInvalidValue;
  const long long per_pattern = bw / npat;
  const long long chunks = (per_pattern + chunk - 1) / chunk;
  const long long blocks = static_cast<long long>(npat) * chunks * h;
  if (blocks > INT_MAX || per_pattern > INT_MAX ||
      static_cast<long long>(npat) * h * n * n / kThreads + 1 > INT_MAX)
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
