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
// D <= 128.  The TPU kernel kept one whole (padded) head in VMEM and rebuilt
// P from scratch; a head's K, V, dK and dV alone (200 KB at N=196, D=64) do
// not fit a block's shared memory beside the tiles it works on, and dK, dV
// are sums over every query row.
//
// Bound on an H100 SXM, at the ViT-Ti train shape (256, 3, 196, 64):
//   operations: the five products of the VJP (QK^T, dO V^T, P^T dO, dS K,
//          dS^T Q), 10*N^2*D*B*H = 18.9 GFLOP of float32 multiply-adds,
//          0.282 ms at the 67 TFLOP/s of the float32 CUDA cores (the tensor
//          cores take float32 only as TF32, which would not keep the
//          reference's precision);
//   bytes: q, k, v, o, dO, lse read once, dq, dk, dv written once, 309 MB,
//          0.092 ms at 3.35 TB/s.
// So the kernel is bound by float32 operations.
//
// What the design does about that bound (flash-attention style tiles, as
// the forward kernel):
//   - P is rebuilt tile by tile from the saved lse, so no pass needs a
//     running max, and the (N, N) matrix P never reaches device memory.
//   - Key-tile-major blocks (one per batch*head and 64 keys) loop over the
//     head's query tiles: they rebuild S and dP, accumulate dK and dV in
//     registers, and store dS (the kernel's scratch: N rows of
//     ceil(N/64)*64 per head, 154 MB at the ViT-Ti shape).  Query-tile-major
//     blocks (one per batch*head and 64 query rows) then compute
//     dQ = scale * dS K as a tiled product.  No atomics, so every sum runs
//     in a fixed order, and the work is the bound's 10*N^2*D: dS costs
//     about 0.1 ms of device memory traffic where rebuilding S and dP a
//     second time costs 4*N^2*D.
//   - delta = rowsum(dO * O) is a small kernel of its own, one warp a row.
//   - The register tiling of the forward kernel: 256 threads, each owns
//     4 rows x 4 columns of a score tile, or 4 rows x D/16 columns of an
//     output tile, so each word read from shared memory feeds 4 FMAs; the
//     key-indexed tiles are stored transposed with a padded stride (no bank
//     conflicts).  Row groups past N skip their arithmetic, and the last
//     key tile computes only its live 16-column groups.
// Left for later work: vector shared-memory loads and wider per-thread
// tiles, and bf16 tensor cores (wgmma) under AMP.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>

namespace {

constexpr int kB = 64;         // query rows or keys per tile
constexpr int kTM = 4;         // rows per thread
constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kLd = kB + 1;    // padded stride of the key- or row-indexed arrays

// delta[row] = sum_c dO[row, c] * O[row, c], one warp per row.
__global__ void delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                             float* __restrict__ delta, long long rows, int d) {
  const long long row = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warps: every lane of a warp shares its row
  const float* a = o + row * d;
  const float* g = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(a[c], g[c], s);
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// Row-major tile [kB][Dp + 1] of rows r0.. of a (n, d) matrix; zeros past n, d.
template <int NC>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int r0, int n, int d) {
  constexpr int kDp = 16 * NC;
  for (int i = threadIdx.x; i < kB * kDp; i += kThreads) {
    const int r = i / kDp, c = i % kDp;
    dst[r * (kDp + 1) + c] =
        (r0 + r < n && c < d) ? src[static_cast<size_t>(r0 + r) * d + c] : 0.f;
  }
}

// Transposed tile [Dp][kLd] of rows r0.. of a (n, d) matrix; zeros past n, d.
template <int NC>
__device__ __forceinline__ void load_cols(float* __restrict__ dst, const float* __restrict__ src,
                                          int r0, int n, int d) {
  constexpr int kDp = 16 * NC;
  for (int i = threadIdx.x; i < kB * kDp; i += kThreads) {
    const int j = i / kDp, c = i % kDp;
    dst[c * kLd + j] = (r0 + j < n && c < d) ? src[static_cast<size_t>(r0 + j) * d + c] : 0.f;
  }
}

// For this thread's 4 rows x JG column groups: the scaled scores, rebuilt
// as P, and dS = P * (dP - delta), where S = Q K^T and dP = dO V^T come
// from the row-major tiles qs, dos and the transposed tiles kt, vt.  Rows
// and keys outside the head (row >= qn, key >= kn) get P = dS = 0.
template <int NC, int JG>
__device__ __forceinline__ void p_and_ds(const float* __restrict__ qs,
                                         const float* __restrict__ dos,
                                         const float* __restrict__ kt,
                                         const float* __restrict__ vt,
                                         const float* __restrict__ lse_s,
                                         const float* __restrict__ delta_s, int r0, int tc,
                                         int qn, int kn, float scale, float p[kTM][4],
                                         float ds[kTM][4]) {
  constexpr int kDp = 16 * NC;
  constexpr int kLq = kDp + 1;
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
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = r0 + i;
    const bool row_live = r < qn;
    const float l = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j < JG && row_live && tc + 16 * j < kn) {
        p[i][j] = expf(s[i][j] * scale - l);
        ds[i][j] = p[i][j] * (dp[i][j] - dl);
      } else {
        p[i][j] = ds[i][j] = 0.f;
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void p_and_ds_live(const float* qs, const float* dos, const float* kt,
                                              const float* vt, const float* lse_s,
                                              const float* delta_s, int r0, int tc, int qn,
                                              int kn, float scale, float p[kTM][4],
                                              float ds[kTM][4]) {
  switch ((kn + 15) / 16) {
    case 1: p_and_ds<NC, 1>(qs, dos, kt, vt, lse_s, delta_s, r0, tc, qn, kn, scale, p, ds); break;
    case 2: p_and_ds<NC, 2>(qs, dos, kt, vt, lse_s, delta_s, r0, tc, qn, kn, scale, p, ds); break;
    case 3: p_and_ds<NC, 3>(qs, dos, kt, vt, lse_s, delta_s, r0, tc, qn, kn, scale, p, ds); break;
    default: p_and_ds<NC, 4>(qs, dos, kt, vt, lse_s, delta_s, r0, tc, qn, kn, scale, p, ds); break;
  }
}

// Shared memory, in floats, of the dK/dV pass and of the dQ pass.
template <int NC>
constexpr int dkdv_smem_floats() {
  return 2 * 16 * NC * kLd + 2 * kB * (16 * NC + 1) + 2 * kB * kLd + 2 * kB;
}
template <int NC>
constexpr int dq_smem_floats() {
  return 16 * NC * kLd + kB * kLd;
}

// dK and dV of 64 keys of one head: loop over the head's query tiles.
template <int NC>
__global__ void __launch_bounds__(kThreads, 2)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ ds_out,
                int n, int d, int k_tiles, float scale) {
  constexpr int kDp = 16 * NC;
  constexpr int kLq = kDp + 1;
  extern __shared__ float smem[];
  float* kt = smem;                 // [kDp][kLd]
  float* vt = kt + kDp * kLd;       // [kDp][kLd]
  float* qs = vt + kDp * kLd;       // [kB][kLq]
  float* dos = qs + kB * kLq;       // [kB][kLq]
  float* ps = dos + kB * kLq;       // [kB][kLd]
  float* dss = ps + kB * kLd;       // [kB][kLd]
  float* lse_s = dss + kB * kLd;    // [kB]
  float* delta_s = lse_s + kB;      // [kB]

  const int bh = blockIdx.x / k_tiles;
  const int k0 = (blockIdx.x % k_tiles) * kB;
  const int kn = min(kB, n - k0);
  const size_t head = static_cast<size_t>(bh) * n * d;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16, r0 = tr * kTM;
  const bool keys_live = r0 < kn;  // this thread's 4 keys in dK, dV
  const int ld = k_tiles * kB;     // row stride of dS
  float* ds_head = ds_out + static_cast<size_t>(bh) * n * ld;

  load_cols<NC>(kt, k + head, k0, n, d);
  load_cols<NC>(vt, v + head, k0, n, d);
  float dk_acc[kTM][NC], dv_acc[kTM][NC];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < n; q0 += kB) {
    const int qn = min(kB, n - q0);
    __syncthreads();  // the previous tile's qs, dos, ps, dss are no longer read
    load_rows<NC>(qs, q + head, q0, n, d);
    load_rows<NC>(dos, dout + head, q0, n, d);
    if (tid < kB) {
      const bool live = tid < qn;
      lse_s[tid] = live ? lse[static_cast<size_t>(bh) * n + q0 + tid] : 0.f;
      delta_s[tid] = live ? delta[static_cast<size_t>(bh) * n + q0 + tid] : 0.f;
    }
    __syncthreads();
    if (r0 < qn) {
      float p[kTM][4], ds[kTM][4];
      p_and_ds_live<NC>(qs, dos, kt, vt, lse_s, delta_s, r0, tc, qn, kn, scale, p, ds);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(r0 + i) * kLd + tc + 16 * j] = p[i][j];
          dss[(r0 + i) * kLd + tc + 16 * j] = ds[i][j];
        }
        if (r0 + i < qn) {  // dS of the live rows, every column of the tile
          float* row = ds_head + static_cast<size_t>(q0 + r0 + i) * ld + k0 + tc;
#pragma unroll
          for (int j = 0; j < 4; ++j) row[16 * j] = ds[i][j];
        }
      }
    }
    __syncthreads();
    if (keys_live) {
#pragma unroll 4
      for (int i = 0; i < qn; ++i) {
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
            dv_acc[kk][c] = fmaf(pv[kk], dov[c], dv_acc[kk][c]);
            dk_acc[kk][c] = fmaf(gv[kk], qv[c], dk_acc[kk][c]);
          }
      }
    }
  }

  if (keys_live) {
#pragma unroll
    for (int kk = 0; kk < kTM; ++kk) {
      const int key = k0 + r0 + kk;
      if (key >= n) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tc + 16 * c;
        if (col < d) {
          dk[head + static_cast<size_t>(key) * d + col] = dk_acc[kk][c] * scale;
          dv[head + static_cast<size_t>(key) * d + col] = dv_acc[kk][c];
        }
      }
    }
  }
}

// dQ = scale * dS K for 64 query rows of one head: loop over the head's key
// tiles, reading the dS the dK/dV pass stored.
template <int NC>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ k, const float* __restrict__ ds_in,
              float* __restrict__ dq, int n, int d, int q_tiles, float scale) {
  constexpr int kDp = 16 * NC;
  extern __shared__ float smem[];
  float* kt = smem;              // [kDp][kLd]
  float* dss = kt + kDp * kLd;   // [kB][kLd]

  const int bh = blockIdx.x / q_tiles;
  const int q0 = (blockIdx.x % q_tiles) * kB;
  const int qn = min(kB, n - q0);
  const int ld = q_tiles * kB;  // row stride of dS
  const size_t head = static_cast<size_t>(bh) * n * d;
  const float* ds_head = ds_in + static_cast<size_t>(bh) * n * ld;
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16, r0 = tr * kTM;
  const bool rows_live = r0 < qn;

  float acc[kTM][NC];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < n; k0 += kB) {
    const int kn = min(kB, n - k0);
    __syncthreads();  // the previous tile's kt, dss are no longer read
    load_cols<NC>(kt, k + head, k0, n, d);
    for (int i = tid; i < kB * kB; i += kThreads) {
      const int r = i / kB, j = i % kB;
      dss[r * kLd + j] =
          (r < qn && j < kn) ? ds_head[static_cast<size_t>(q0 + r) * ld + k0 + j] : 0.f;
    }
    __syncthreads();
    if (rows_live) {
#pragma unroll 4
      for (int j = 0; j < kn; ++j) {
        float gv[kTM], kv[NC];
#pragma unroll
        for (int i = 0; i < kTM; ++i) gv[i] = dss[(r0 + i) * kLd + j];
#pragma unroll
        for (int c = 0; c < NC; ++c) kv[c] = kt[(tc + 16 * c) * kLd + j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(gv[i], kv[c], acc[i][c]);
      }
    }
  }

  if (rows_live) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = q0 + r0 + i;
      if (r >= n) continue;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tc + 16 * c;
        if (col < d) dq[head + static_cast<size_t>(r) * d + col] = acc[i][c] * scale;
      }
    }
  }
}

template <int NC>
cudaError_t launch(const float* q, const float* k, const float* v, const float* o,
                   const float* dout, const float* lse, float* delta, float* ds, float* dq,
                   float* dk, float* dv, long long bh, int n, int d, float scale,
                   cudaStream_t stream) {
  const long long rows = bh * n;
  const long long delta_blocks = (rows * 32 + kThreads - 1) / kThreads;
  const int tiles = (n + kB - 1) / kB;
  const long long blocks = bh * tiles;
  if (blocks > INT_MAX || delta_blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const int dkdv_bytes = dkdv_smem_floats<NC>() * static_cast<int>(sizeof(float));
  const int dq_bytes = dq_smem_floats<NC>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return err;
  delta_kernel<<<static_cast<unsigned>(delta_blocks), kThreads, 0, stream>>>(o, dout, delta,
                                                                             rows, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<NC><<<static_cast<unsigned>(blocks), kThreads, dkdv_bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, ds, n, d, tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<NC><<<static_cast<unsigned>(blocks), kThreads, dq_bytes, stream>>>(
      k, ds, dq, n, d, tiles, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  bh = B * H; q, k, v, o (the forward's output), dout,
// dq, dk, dv are device pointers to contiguous (B, H, N, D) float32 tensors;
// lse (the forward's log-sum-exp) and delta (scratch) are (B, H, N)
// float32; ds (scratch) is (B, H, N, ceil(N/64)*64) float32; stream is a
// cudaStream_t.  Launches three kernels in order on the stream.  Returns a
// cudaError_t: 0 when every launch was accepted.
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
