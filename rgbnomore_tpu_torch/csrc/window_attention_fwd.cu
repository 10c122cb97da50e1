// Swin window attention, forward: for each window w and head h,
//   O[w, h] = softmax(Q[w, h] K[w, h]^T + bias[w % P, h]) V[w, h],
// float32, with any logit scale already folded into q.
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/attention.py:
// _win_fwd_kernel (:156-167), which _window_attention_impl (:228-246)
// launches for fused_window_attention.  The TPU kernel stacked two windows
// into one 128-row tile (with -1e9 off the block diagonal of its bias) to
// fill the MXU; a per-window block computes the same outputs, so nothing is
// packed here.  q, k, v, o are (BW, H, N, D) float32, contiguous, N <= 64,
// D <= 64; bias is (P, H, N, N) float32, contiguous, and BW % P == 0.  P = 1
// for the unshifted blocks of SwinV2 (the relative position bias alone),
// P = nW for the shifted ones (the bias plus each window's shift mask).
//
// Bound on an H100 SXM, per (window, head) at the SwinV2-T shape N = 64,
// D = 32:
//   bytes: q, k, v read once and o written once, 4 * N*D * 4 B = 32 KB
//          (the bias, shared by every window of a pattern, is small);
//   operations: QK^T and PV, 4*N^2*D = 0.52 MFLOP of float32 multiply-adds.
// At 3.35 TB/s and the 67 TFLOP/s of the float32 CUDA cores that is 9.8 ns
// of bytes against 7.8 ns of operations, so the kernel is bound by bytes:
// stage 1 at batch 128 (8,192 windows x 3 heads) moves 0.81 GB, 0.24 ms.
//
// What the design does about that bound:
//   - One block of 256 threads per (window, head).  A whole window fits in
//     shared memory (q, k, v 8 KB each at D = 32, the 64 x 64 scores 16 KB),
//     so q, k and v are read from device memory once, the scores never
//     reach it, and o is written once.  Nothing is saved for the backward,
//     which recomputes the scores from the same inputs.
//   - Each thread owns 4 query rows x 4 key columns of the scores and 4
//     query rows x D/16 output columns, so each word read from shared memory
//     feeds 4 multiply-adds; column lanes read neighbouring words and k is
//     stored transposed with a padded stride (no bank conflicts).  The 16
//     column lanes of a row group form a half warp, so the row max and sum
//     of the softmax are warp shuffles.
//   - Loads are coalesced: a window's q, k and v are each one contiguous
//     run of N*D floats.
//   - Every parameter is a kernel argument, held in registers: no parameter
//     is read through shared memory across a barrier.
// Left for later work: a block per (window, several heads) to amortise the
// barriers, vector loads, and bf16 tensor cores (wgmma) under AMP.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kN = 64;         // tokens per window, at most
constexpr int kTM = 4;         // rows per thread
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLd = kN + 1;    // padded stride of the token-indexed arrays

// Shared memory, in floats, for D <= 16 * NC.
template <int NC>
constexpr int smem_floats() {
  return kN * (16 * NC + 1)  // q, row-major    [kN][Dp + 1]
         + 16 * NC * kLd     // k, transposed   [Dp][kLd]
         + kN * 16 * NC      // v, row-major    [kN][Dp]
         + kN * kLd;         // P               [kN][kLd]
}

// Max and sum over the 16 column lanes of a row group (a half warp).
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

// Row-major [kN][ld] copy of a window's (n, d) matrix; zeros past n, d.
template <int NC>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int n, int d, int ld) {
  constexpr int kDp = 16 * NC;
  for (int i = threadIdx.x; i < kN * kDp; i += kThreads) {
    const int r = i / kDp, c = i % kDp;
    dst[r * ld + c] = (r < n && c < d) ? src[r * d + c] : 0.f;
  }
}

// Transposed [Dp][kLd] copy of a window's (n, d) matrix; zeros past n, d.
template <int NC>
__device__ __forceinline__ void load_cols(float* __restrict__ dst, const float* __restrict__ src,
                                          int n, int d) {
  constexpr int kDp = 16 * NC;
  for (int i = threadIdx.x; i < kN * kDp; i += kThreads) {
    const int j = i / kDp, c = i % kDp;
    dst[c * kLd + j] = (j < n && c < d) ? src[j * d + c] : 0.f;
  }
}

// P = softmax(S + bias) of this thread's 4 rows x JG column groups, in
// place.  Every thread of the block runs it, so the half-warp shuffles see
// all their lanes: rows past n take scores of 0 (a finite softmax that no
// one reads), columns past n take -inf (P = 0).
template <int JG>
__device__ __forceinline__ void softmax_rows(float s[kTM][JG], const float* __restrict__ bias,
                                             int r0, int tc, int n) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + i;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < JG; ++j) {
      const int col = tc + 16 * j;
      if (col >= n) {
        s[i][j] = -INFINITY;
      } else if (r < n) {
        s[i][j] += __ldg(bias + r * n + col);
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
#pragma unroll
    for (int j = 0; j < JG; ++j) s[i][j] /= sum;
  }
}

template <int NC, int JG>
__global__ void __launch_bounds__(kThreads)
    window_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ o, int h, int n, int d, int npat) {
  constexpr int kDp = 16 * NC;
  constexpr int kLq = kDp + 1;
  extern __shared__ float smem[];
  float* qs = smem;            // [kN][kLq]
  float* kt = qs + kN * kLq;   // [kDp][kLd]
  float* vs = kt + kDp * kLd;  // [kN][kDp]
  float* ps = vs + kN * kDp;   // [kN][kLd]

  const int unit = blockIdx.x;  // window * h + head: the layout of q
  const int w = unit / h, head = unit % h;
  const size_t base = static_cast<size_t>(unit) * n * d;
  const float* bp = bias + (static_cast<size_t>(w % npat) * h + head) * n * n;
  const int tid = threadIdx.x, tc = tid % 16, r0 = (tid / 16) * kTM;

  load_rows<NC>(qs, q + base, n, d, kLq);
  load_cols<NC>(kt, k + base, n, d);
  load_rows<NC>(vs, v + base, n, d, kDp);
  __syncthreads();

  float s[kTM][JG];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < JG; ++j) s[i][j] = 0.f;
#pragma unroll 4
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
  softmax_rows<JG>(s, bp, r0, tc, n);
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < JG; ++j) ps[(r0 + i) * kLd + tc + 16 * j] = s[i][j];
  __syncthreads();

  if (r0 >= n) return;  // no barrier follows
  float acc[kTM][NC];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
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
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tc + 16 * c;
      if (col < d) o[base + static_cast<size_t>(r) * d + col] = acc[i][c];
    }
  }
}

template <int NC, int JG>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias, float* o,
                   long long units, int h, int n, int d, int npat, cudaStream_t stream) {
  const int bytes = smem_floats<NC>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(window_fwd_kernel<NC, JG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  window_fwd_kernel<NC, JG><<<static_cast<unsigned>(units), kThreads, bytes, stream>>>(
      q, k, v, bias, o, h, n, d, npat);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_jg(const float* q, const float* k, const float* v, const float* bias,
                      float* o, long long units, int h, int n, int d, int npat,
                      cudaStream_t stream) {
  switch ((n + 15) / 16) {
    case 1: return launch<NC, 1>(q, k, v, bias, o, units, h, n, d, npat, stream);
    case 2: return launch<NC, 2>(q, k, v, bias, o, units, h, n, d, npat, stream);
    case 3: return launch<NC, 3>(q, k, v, bias, o, units, h, n, d, npat, stream);
    default: return launch<NC, 4>(q, k, v, bias, o, units, h, n, d, npat, stream);
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
  if (bw <= 0 || h <= 0 || n <= 0 || n > kN || d <= 0 || d > 64 || npat <= 0 ||
      bw % npat != 0)
    return cudaErrorInvalidValue;
  const long long units = bw * h;
  if (units > INT_MAX) return cudaErrorInvalidConfiguration;
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fb = static_cast<const float*>(bias);
  auto* fo = static_cast<float*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch_jg<1>(fq, fk, fv, fb, fo, units, h, n, d, npat, s);
    case 2: return launch_jg<2>(fq, fk, fv, fb, fo, units, h, n, d, npat, s);
    case 3: return launch_jg<3>(fq, fk, fv, fb, fo, units, h, n, d, npat, s);
    default: return launch_jg<4>(fq, fk, fv, fb, fo, units, h, n, d, npat, s);
  }
}

extern "C" const char* window_attention_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
