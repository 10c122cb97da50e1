// Fused DCT train-input stage: per-sample flip -> clamp -> num_ops drawn
// RandAugment rounds -> ToRange to [-1, 1], float32.
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/augpipe.py:_kernel
// (:345-369, branches _make_branch :220-342), which fused_flip_aug_range
// (:372-419) launches.  Same function and call contract: y (B, 1, H*W, 64),
// c (B, 2, (H/2)*(W/2), 64) dequantized coefficients; per sample a flip bit
// and, per round, the index of its op in the caller's op list, a sign
// (+-1), an even cutout centre and ChromaDrop's channel bit, all drawn
// outside (RandAugmentDCT.draw_policy).  The 16 ops are the JAX kernel's
// SUPPORTED_OPS; their constants (translate shifts, cutout sizes, posterize
// step, filter rows) are built on the host, as the JAX kernel builds them.
//
// Bound on an H100 SXM, at the ViT-Ti train shape (B=256, 28x28 grid):
//   bytes: y (51.4 MB) and c (25.7 MB) read once and written once, 154 MB,
//          46 us at 3.35 TB/s;
//   operations: a few dozen per coefficient, far below the bytes' time.
// So the kernel is bound by bytes.
//
// What the design does about that bound.  The TPU kernel held a whole
// sample in VMEM and moved it with exact 0/1 permutation matmuls (flip,
// Rotate90), because Mosaic has no cheap gather; a sample (300 KB) does not
// fit in a block's shared memory here, and on Hopper a permutation is an
// index map.  So:
//   - Only four ops read a reduction (AutoContrast and AutoSaturation: min
//     and max of the DCs joint over the plane's channels; Brightness: the
//     mean |DC| of y), and each reads the DC plane only.  Every geometric op
//     (flip, Translate, Rotate90) maps DCs to DCs with sign +1.  So each
//     block first runs the flip and all rounds on the sample's DC planes in
//     shared memory (784 + 392 floats at 28x28, 9.4 KB with the second
//     buffer).
//   - Then each thread takes an output coefficient, traces its source back
//     through the rounds' index maps, reads it once, and applies each
//     round's elementwise part in order (sign, filter, zero-fill, hole,
//     clamp).  DCs come from the plane already in shared memory.
// Each coefficient is read once and written once; the blocks of one sample
// (kChunks of them, to fill the card) each rerun the small DC pass.
// Left for later work: vector (float4) loads and stores, and a single DC
// pass per sample shared through a cluster.

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunks = 4;  // blocks per sample
constexpr float kDctMin = -1024.f;
constexpr float kDctMax = 1016.f;

// op codes, in the order of rgbnomore_tpu_torch/ops/augpipe.py:OP_CODES
enum OpCode {
  kIdentity = 0, kAutoContrast, kAutoSaturation, kPosterize, kSolarizeAdd,
  kColor, kContrast, kBrightness, kSharpness, kMidfreqAug, kCutout,
  kTranslateX, kTranslateY, kRotate90, kGrayscale, kChromaDrop,
};

// One round of one sample, decoded from the policy and the op table.
struct Round {
  int code;
  int ty, tc;        // Translate: shifts of the y and c planes; Rotate90: k = +-1 in ty
  int yh0, yh1, yw0, yw1;  // Cutout hole of y, [h0, h1) x [w0, w1)
  int ch0, ch1, cw0, cw1;  // Cutout hole of c
  int keep;          // ChromaDrop: the chroma channel kept
  float factor;      // Color, Contrast: 1 + mag*sign; Brightness: mag*sign;
                     // SolarizeAdd: the addition; Posterize: the step
  float count;       // Posterize: the number of levels
  int filt;          // Sharpness, MidfreqAug: offset of the 64-float filter row
};

__device__ __forceinline__ float clampf(float v) {
  return fminf(fmaxf(v, kDctMin), kDctMax);
}

// Source of output position (h, w, i, j) of a geometric round on a gh x gw
// plane; false where the round zero-fills.  sign gets the round's factor.
__device__ __forceinline__ bool trace_round(const Round& r, bool is_y, int gh, int gw,
                                            int& h, int& w, int& i, int& j, float& sign) {
  sign = 1.f;
  if (r.code == kTranslateX) {
    w -= is_y ? r.ty : r.tc;
    return w >= 0 && w < gw;
  }
  if (r.code == kTranslateY) {
    h -= is_y ? r.ty : r.tc;
    return h >= 0 && h < gh;
  }
  if (r.code == kRotate90) {
    const int oh = h, ow = w, oi = i;
    if (r.ty > 0) {  // ccw: out[h,w,i,j] = (-1)^i in[w, W-1-h, j, i]
      h = ow;
      w = gw - 1 - oh;
      sign = (oi & 1) ? -1.f : 1.f;
    } else {  // cw: out[h,w,i,j] = (-1)^j in[H-1-w, h, j, i]
      h = gh - 1 - ow;
      w = oh;
      sign = (j & 1) ? -1.f : 1.f;
    }
    i = j;
    j = oi;
  }
  return true;
}

// The non-geometric part of a round at output position (ch, h, w) of a
// plane, frequency f.  Returns the new value (before the clamp).
__device__ __forceinline__ float pointwise(const Round& r, const float* filts, bool is_y,
                                           int ch, int h, int w, int f, float v) {
  switch (r.code) {
    case kSharpness:
    case kMidfreqAug:
      return is_y ? v * filts[r.filt + f] : v;
    case kCutout:
      if (is_y) return (h >= r.yh0 && h < r.yh1 && w >= r.yw0 && w < r.yw1) ? 0.f : v;
      return (h >= r.ch0 && h < r.ch1 && w >= r.cw0 && w < r.cw1) ? 0.f : v;
    case kGrayscale:
      return is_y ? v : 0.f;
    case kChromaDrop:
      return (is_y || ch == r.keep) ? v : 0.f;
    default:
      return v;
  }
}

// Block-wide reduction of (min, max, sum |x|) of a[0..n).
__device__ void block_stats(const float* a, int n, float* scratch, float& mn, float& mx,
                            float& sum_abs) {
  float lo = INFINITY, hi = -INFINITY, s = 0.f;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float v = a[t];
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
    s += fabsf(v);
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kThreads / 32;
  __syncthreads();  // scratch may still be read from the previous call
  if (lane == 0) {
    scratch[warp] = lo;
    scratch[kWarps + warp] = hi;
    scratch[2 * kWarps + warp] = s;
  }
  __syncthreads();
  lo = scratch[0];
  hi = scratch[kWarps];
  s = scratch[2 * kWarps];
  for (int k = 1; k < kWarps; ++k) {
    lo = fminf(lo, scratch[k]);
    hi = fmaxf(hi, scratch[kWarps + k]);
    s += scratch[2 * kWarps + k];
  }
  mn = lo;
  mx = hi;
  sum_abs = s;
}

// AutoContrast of a DC plane in place: min -> DCT_MIN, max -> DCT_MAX.
__device__ void autocontrast(float* a, int n, float* scratch) {
  float mn, mx, unused;
  block_stats(a, n, scratch, mn, mx, unused);
  const float denom = (mx == mn) ? 1.f : mx - mn;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float v = a[t];
    a[t] = (mx == mn) ? v : kDctMin + (v - mn) / denom * (kDctMax - kDctMin);
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
    augpipe_kernel(const float* __restrict__ y, const float* __restrict__ c,
                   float* __restrict__ yo, float* __restrict__ co,
                   const int* __restrict__ idx, const float* __restrict__ sign,
                   const int* __restrict__ cut_ch, const int* __restrict__ cut_cw,
                   const int* __restrict__ drop, const int* __restrict__ flip,
                   const int* __restrict__ codes, const float* __restrict__ params,
                   const float* __restrict__ filts, int gh, int gw,
                   float val_scale, float val_shift) {
  const int b = blockIdx.y;
  const int hw = gh * gw;
  const int chh = gh / 2, cww = gw / 2, hwc = chh * cww;
  extern __shared__ float smem[];
  float* ydc = smem;              // [2][hw]
  float* cdc = ydc + 2 * hw;      // [2][2 * hwc]
  float* scratch = cdc + 4 * hwc; // [3 * kThreads / 32]
  __shared__ Round rounds[NR > 0 ? NR : 1];
  const int tid = threadIdx.x;
  const bool flipped = flip[b] != 0;

  if (tid < NR) {
    Round r;
    const int op = idx[b * NR + tid];
    const float s = sign[b * NR + tid];
    const float* p = params + 4 * op;
    r.code = codes[op];
    r.ty = r.tc = 0;
    r.factor = 0.f;
    r.count = 1.f;
    r.keep = drop[b * NR + tid] > 0 ? 1 : 0;
    r.filt = (op * 2 + (s > 0.f ? 0 : 1)) * 64;
    const int hy = cut_ch[b * NR + tid], wy = cut_cw[b * NR + tid];
    const int py = static_cast<int>(p[0]), pc = static_cast<int>(p[1]);
    r.yh0 = hy - py; r.yh1 = hy + py; r.yw0 = wy - py; r.yw1 = wy + py;
    r.ch0 = hy / 2 - pc; r.ch1 = hy / 2 + pc; r.cw0 = wy / 2 - pc; r.cw1 = wy / 2 + pc;
    switch (r.code) {
      case kTranslateX:
      case kTranslateY:
        r.ty = static_cast<int>(s > 0.f ? p[0] : p[1]);
        r.tc = static_cast<int>(s > 0.f ? p[2] : p[3]);
        break;
      case kRotate90: r.ty = s > 0.f ? 1 : -1; break;
      case kColor:
      case kContrast: r.factor = 1.f + p[0] * s; break;
      case kBrightness: r.factor = p[0] * s; break;
      case kSolarizeAdd: r.factor = p[0]; break;
      case kPosterize: r.factor = p[0]; r.count = p[1]; break;
      default: break;
    }
    rounds[tid] = r;
  }

  // ---- the DC planes: flip, clamp, then every round, in shared memory
  const float* yb = y + static_cast<size_t>(b) * hw * 64;
  const float* cb = c + static_cast<size_t>(b) * 2 * hwc * 64;
  for (int t = tid; t < hw; t += kThreads) {
    const int h = t / gw, w = t % gw;
    ydc[t] = clampf(yb[static_cast<size_t>(h * gw + (flipped ? gw - 1 - w : w)) * 64]);
  }
  for (int t = tid; t < 2 * hwc; t += kThreads) {
    const int ch = t / hwc, pos = t % hwc, h = pos / cww, w = pos % cww;
    const int src = ch * hwc + h * cww + (flipped ? cww - 1 - w : w);
    cdc[t] = clampf(cb[static_cast<size_t>(src) * 64]);
  }
  int cur = 0;  // which half of ydc / cdc holds the planes
  for (int k = 0; k < NR; ++k) {
    __syncthreads();
    // a copy in registers: reading the fields through a reference into
    // shared memory across this loop's barriers gave wrong DCs on the card
    // (nvcc 12.9, sm_90a) after a Brightness round
    const Round r = rounds[k];
    float* ya = ydc + cur * hw;
    float* ca = cdc + cur * 2 * hwc;
    if (r.code == kTranslateX || r.code == kTranslateY || r.code == kRotate90) {
      float* yn = ydc + (1 - cur) * hw;
      float* cn = cdc + (1 - cur) * 2 * hwc;
      for (int t = tid; t < hw; t += kThreads) {
        int h = t / gw, w = t % gw, i = 0, j = 0;
        float sgn;
        const bool ok = trace_round(r, true, gh, gw, h, w, i, j, sgn);
        yn[t] = ok ? clampf(ya[h * gw + w]) : 0.f;
      }
      for (int t = tid; t < 2 * hwc; t += kThreads) {
        const int ch = t / hwc, pos = t % hwc;
        int h = pos / cww, w = pos % cww, i = 0, j = 0;
        float sgn;
        const bool ok = trace_round(r, false, chh, cww, h, w, i, j, sgn);
        cn[t] = ok ? clampf(ca[ch * hwc + h * cww + w]) : 0.f;
      }
      cur = 1 - cur;
      continue;
    }
    if (r.code == kAutoContrast) {
      autocontrast(ya, hw, scratch);
    } else if (r.code == kAutoSaturation) {
      autocontrast(ca, 2 * hwc, scratch);
    } else if (r.code == kBrightness) {
      float mn, mx, sum_abs;
      block_stats(ya, hw, scratch, mn, mx, sum_abs);
      const float shift = sum_abs / static_cast<float>(hw) * r.factor;
      for (int t = tid; t < hw; t += kThreads) ya[t] = ya[t] + shift;
    } else if (r.code == kPosterize) {
      for (int t = tid; t < hw + 2 * hwc; t += kThreads) {
        float* a = t < hw ? ya + t : ca + (t - hw);
        const float q = rintf((*a - kDctMin) / r.factor);
        *a = kDctMin + q * (kDctMax - kDctMin) / r.count;
      }
    } else if (r.code == kSolarizeAdd) {
      for (int t = tid; t < hw; t += kThreads) {
        const float v = ya[t];
        ya[t] = v < 0.f ? v + r.factor : v;
      }
    } else if (r.code == kColor) {
      for (int t = tid; t < 2 * hwc; t += kThreads) ca[t] = ca[t] * r.factor;
    } else if (r.code == kContrast) {
      for (int t = tid; t < hw; t += kThreads) ya[t] = ya[t] * r.factor;
    } else {
      for (int t = tid; t < hw; t += kThreads)
        ya[t] = pointwise(r, filts, true, 0, t / gw, t % gw, 0, ya[t]);
      for (int t = tid; t < 2 * hwc; t += kThreads) {
        const int ch = t / hwc, pos = t % hwc;
        ca[t] = pointwise(r, filts, false, ch, pos / cww, pos % cww, 0, ca[t]);
      }
    }
    __syncthreads();
    for (int t = tid; t < hw; t += kThreads) ya[t] = clampf(ya[t]);
    for (int t = tid; t < 2 * hwc; t += kThreads) ca[t] = clampf(ca[t]);
  }
  __syncthreads();
  const float* ydc_out = ydc + cur * hw;
  const float* cdc_out = cdc + cur * 2 * hwc;
  Round rr[NR > 0 ? NR : 1];  // the rounds in registers, as above
#pragma unroll
  for (int k = 0; k < NR; ++k) rr[k] = rounds[k];

  // ---- every output coefficient of this block's chunk
  const int n_y = hw * 64;
  const int total = n_y + 2 * hwc * 64;
  const int per_chunk = (total + gridDim.x - 1) / gridDim.x;
  const int e0 = blockIdx.x * per_chunk;
  const int e1 = min(total, e0 + per_chunk);
  float* yob = yo + static_cast<size_t>(b) * n_y;
  float* cob = co + static_cast<size_t>(b) * 2 * hwc * 64;
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const bool is_y = e < n_y;
    const int local = is_y ? e : e - n_y;
    const int ch = is_y ? 0 : local / (hwc * 64);
    const int pos = (local / 64) % (is_y ? hw : hwc);
    const int f = local % 64;
    const int pgh = is_y ? gh : chh, pgw = is_y ? gw : cww;
    float v;
    if (f == 0) {
      v = is_y ? ydc_out[pos] : cdc_out[ch * hwc + pos];
    } else {
      // trace back: the output position of every round, its sign, and the
      // input position; a zero-filled source leaves an AC at 0 for good
      int oh[NR > 0 ? NR : 1], ow[NR > 0 ? NR : 1], of[NR > 0 ? NR : 1];
      float sg[NR > 0 ? NR : 1];
      int h = pos / pgw, w = pos % pgw, i = f / 8, j = f % 8;
      bool live = true;
#pragma unroll
      for (int k = NR - 1; k >= 0; --k) {
        oh[k] = h; ow[k] = w; of[k] = i * 8 + j;
        if (live) live = trace_round(rr[k], is_y, pgh, pgw, h, w, i, j, sg[k]);
      }
      if (!live) {
        v = 0.f;
      } else {
        float flip_sign = 1.f;
        if (flipped) {
          w = pgw - 1 - w;
          flip_sign = (j & 1) ? -1.f : 1.f;
        }
        const size_t src = static_cast<size_t>(ch * (is_y ? hw : hwc) + h * pgw + w) * 64 + i * 8 + j;
        v = clampf((is_y ? yb[src] : cb[src]) * flip_sign);
#pragma unroll
        for (int k = 0; k < NR; ++k) {
          v = clampf(pointwise(rr[k], filts, is_y, ch, oh[k], ow[k], of[k], v * sg[k]));
        }
      }
    }
    const float out = v * val_scale + val_shift;
    if (is_y) yob[local] = out; else cob[local] = out;
  }
}

template <int NR>
cudaError_t launch(const float* y, const float* c, float* yo, float* co, const int* idx,
                   const float* sign, const int* cut_ch, const int* cut_cw, const int* drop,
                   const int* flip, const int* codes, const float* params, const float* filts,
                   int batch, int gh, int gw, float val_scale, float val_shift,
                   cudaStream_t stream) {
  const int hw = gh * gw, hwc = (gh / 2) * (gw / 2);
  const int bytes = (2 * hw + 4 * hwc + 3 * kThreads / 32) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      augpipe_kernel<NR>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(kChunks, batch);
  augpipe_kernel<NR><<<grid, kThreads, bytes, stream>>>(
      y, c, yo, co, idx, sign, cut_ch, cut_cw, drop, flip, codes, params, filts, gh, gw,
      val_scale, val_shift);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  Device pointers: y (B, 1, gh*gw, 64), c (B, 2,
// (gh/2)*(gw/2), 64) and the outputs yo, co of the same shapes, float32,
// contiguous; idx, cut_ch, cut_cw, drop int32 and sign float32, each
// (B, num_ops); flip int32 (B,); the op table codes int32 (n_list,),
// params float32 (n_list, 4), filts float32 (n_list, 2, 64).  Rotate90
// needs gh == gw (the caller checks).  Returns a cudaError_t: 0 when the
// launch was accepted.
extern "C" int augpipe_fwd(const void* y, const void* c, void* yo, void* co, const void* idx,
                           const void* sign, const void* cut_ch, const void* cut_cw,
                           const void* drop, const void* flip, const void* codes,
                           const void* params, const void* filts, int batch, int gh, int gw,
                           int num_ops, float val_scale, float val_shift, void* stream) {
  if (batch <= 0 || gh <= 1 || gw <= 1 || gh % 2 || gw % 2 || batch > 65535)
    return cudaErrorInvalidValue;
  auto args = [&](auto launcher) {
    return launcher(static_cast<const float*>(y), static_cast<const float*>(c),
                    static_cast<float*>(yo), static_cast<float*>(co),
                    static_cast<const int*>(idx), static_cast<const float*>(sign),
                    static_cast<const int*>(cut_ch), static_cast<const int*>(cut_cw),
                    static_cast<const int*>(drop), static_cast<const int*>(flip),
                    static_cast<const int*>(codes), static_cast<const float*>(params),
                    static_cast<const float*>(filts), batch, gh, gw, val_scale, val_shift,
                    static_cast<cudaStream_t>(stream));
  };
  switch (num_ops) {
    case 0: return args(&launch<0>);
    case 1: return args(&launch<1>);
    case 2: return args(&launch<2>);
    case 3: return args(&launch<3>);
    case 4: return args(&launch<4>);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* augpipe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
