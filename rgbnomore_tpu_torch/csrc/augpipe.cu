// Fused DCT input stage: per-sample flip -> clamp -> num_ops drawn
// RandAugment rounds -> ToRange to [-1, 1], float32; read from dense
// coefficients, or straight from the mask16 wire.
//
// Replaces the TPU kernel rgbnomore_tpu/ops/pallas/augpipe.py:_kernel
// (:345-369, branches _make_branch :220-342), which fused_flip_aug_range
// (:372-419) launches.  Two entries share one core, templated on how it
// reads a source 8x8 block:
//   - augpipe_fwd, the dense reader: the TPU kernel's own contract.  y (B, 1,
//     H*W, 64), c (B, 2, (H/2)*(W/2), 64) dequantized coefficients; per sample
//     a flip bit and, per round, the index of its op in the caller's op
//     list, a sign (+-1), an even cutout centre and ChromaDrop's channel
//     bit, all drawn outside (RandAugmentDCT.draw_policy).  The 16 ops are
//     the JAX kernel's SUPPORTED_OPS; their constants (translate shifts,
//     cutout sizes, posterize step, filter rows) are built on the host, as
//     the JAX kernel builds them.
//   - augpipe_wire, the wire reader: the consolidated (B, row) uint8 rows of
//     data/loader.py:packed_layout (mask16, mask16w or mask16q), decoded in
//     registers, so the composition that the JAX pipeline runs as two steps
//     (rgbnomore_tpu/augment/pipeline.py:387-390: unpack_cropped ->
//     fused_flip_aug_range; :427 for eval: unpack_cropped -> to_range) is one
//     launch.  Each block's 8-byte occupancy mask is one 64-bit word: the
//     value of set position p sits at rank popc(mask below p) of its K
//     values, times the block's scale, and a set bit of rank K or more reads
//     0, as the JAX compare-and-reduce gives (pipeline.py:89-110); position 0
//     is the exact int16 DC plane; mask16w reads int16 values; mask16q
//     multiplies by the sample's quant table and clamps, as dequantize does.
//     The eval form (no flip, no rounds) rescales in to_range's own order,
//     (v - DCT_MIN) / span as an IEEE division, then -1 + 2x, so it is
//     bit-exact against the JAX pipeline and the plain PyTorch one.
//
// Bound on an H100 SXM: bytes.  At the ViT-Ti train shape (B=256, 28x28
// grid) the dense entry reads and writes y (51.4 MB) and c (25.7 MB) once,
// 154 MB, 46 us at 3.35 TB/s; the wire entry reads the K=16 wire (8.2 MB)
// and writes the 77 MB once, 26 us.  A few dozen operations per coefficient
// stay far below either.
//
// What the design does about that bound.  A sample (300 KB) does not fit a
// block's shared memory, and on Hopper a permutation is an index map, not
// the exact 0/1 permutation matmuls the TPU kernel used.
//   - One block per sample.  Only four ops read a reduction (AutoContrast,
//     AutoSaturation: min and max of the DCs joint over the plane's
//     channels; Brightness: the mean |DC| of y), each over the DC planes
//     only, and every geometric op maps DCs to DCs with sign +1.  So the
//     block runs the flip and every round once on the sample's DC planes in
//     shared memory (784 + 392 floats at 28x28; 1,024 + 512 at 32x32), read
//     straight from the wire's DC planes on the wire entry.
//   - Every geometric op maps a whole 8x8 block onto one source block with a
//     fixed permutation inside it: flip is j -> 7-j with sign (-1)^j,
//     Rotate90 a transpose with a sign, Translate a block shift.  So each
//     output block is traced back through the rounds once; the block-wide
//     zeroings (Cutout, Grayscale, ChromaDrop, a translated-in edge) are
//     decided there.  Then a group of 16 threads writes the block's 256 B as
//     16-byte float4 stores, each thread four coefficients of one row with
//     the transposes, signs, filters and clamps applied in registers, and
//     no integer division per element.
//   - The round parameters are copied into registers from the policy, never
//     read through shared memory: read through a reference into shared
//     memory across the DC pass's barriers they gave wrong DCs after a
//     Brightness round (nvcc 12.9, sm_90a).
// The per-coefficient operations keep the plain version's order (sign, then
// clamp, per round), so the dense entry gives the same bits as before.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;          // one block per sample
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 16;  // a 16-thread group writes one 8x8 block
constexpr int kMaxRounds = 4;
// shared memory a block may take and still sit two to an SM (228 KB, 1 KB
// of it reserved per block)
constexpr int kStageBudget = 112 * 1024;
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
  int ty, tc;    // Translate: shifts of the y and c planes; Rotate90: k = +-1 in ty
  int hy, wy;    // Cutout: the hole's centre on y (halved on c)
  int py, pc;    // Cutout: the hole's half-widths on y and on c
  int keep;      // ChromaDrop: the chroma channel kept
  float factor;  // Color, Contrast: 1 + mag*sign; Brightness: mag*sign;
                 // SolarizeAdd: the addition; Posterize: the step
  float count;   // Posterize: the number of levels
};

// The per-sample draws and the host-built op table.
struct Policy {
  const int* idx;       // (B, NR) op index into the list
  const float* sign;    // (B, NR)
  const int* cut_ch;    // (B, NR) cutout centre, row
  const int* cut_cw;    // (B, NR) cutout centre, column
  const int* drop;      // (B, NR) ChromaDrop channel bit
  const int* flip;      // (B,)
  const int* codes;     // (n_list,)
  const float* params;  // (n_list, 4)
  const float* filts;   // (n_list, 2, 64)
};

__device__ __forceinline__ float clampf(float v) {
  return fminf(fmaxf(v, kDctMin), kDctMax);
}

__device__ __forceinline__ Round load_round(const Policy& pol, int b, int k, int nr) {
  const int at = b * nr + k;
  const int op = pol.idx[at];
  const float s = pol.sign[at];
  const float* p = pol.params + 4 * op;
  Round r;
  r.code = pol.codes[op];
  r.ty = r.tc = 0;
  r.factor = 0.f;
  r.count = 1.f;
  r.keep = pol.drop[at] > 0 ? 1 : 0;
  r.hy = pol.cut_ch[at];
  r.wy = pol.cut_cw[at];
  r.py = static_cast<int>(p[0]);
  r.pc = static_cast<int>(p[1]);
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
  return r;
}

// Whether block (h, w) of a plane lies in a Cutout round's hole.
__device__ __forceinline__ bool in_hole(const Round& r, bool is_y, int h, int w) {
  if (is_y) return h >= r.hy - r.py && h < r.hy + r.py && w >= r.wy - r.py && w < r.wy + r.py;
  const int hc = r.hy / 2, wc = r.wy / 2;
  return h >= hc - r.pc && h < hc + r.pc && w >= wc - r.pc && w < wc + r.pc;
}

// Source block of output block (h, w) of a geometric round on a gh x gw
// plane, in place; false where the round zero-fills.  Other rounds keep the
// block where it is.
__device__ __forceinline__ bool trace_block(const Round& r, bool is_y, int gh, int gw, int& h,
                                            int& w) {
  if (r.code == kTranslateX) {
    w -= is_y ? r.ty : r.tc;
    return w >= 0 && w < gw;
  }
  if (r.code == kTranslateY) {
    h -= is_y ? r.ty : r.tc;
    return h >= 0 && h < gh;
  }
  if (r.code == kRotate90) {
    const int oh = h;
    if (r.ty > 0) {  // ccw: out[h,w,i,j] = (-1)^i in[w, W-1-h, j, i]
      h = w;
      w = gw - 1 - oh;
    } else {  // cw: out[h,w,i,j] = (-1)^j in[H-1-w, h, j, i]
      h = gh - 1 - w;
      w = oh;
    }
  }
  return true;
}

// The non-geometric, non-photometric part of a round at a DC of a plane.
__device__ __forceinline__ float dc_pointwise(const Round& r, float filt0, bool is_y, int ch,
                                              int h, int w, float v) {
  switch (r.code) {
    case kSharpness:
    case kMidfreqAug: return is_y ? v * filt0 : v;
    case kCutout: return in_hole(r, is_y, h, w) ? 0.f : v;
    case kGrayscale: return is_y ? v : 0.f;
    case kChromaDrop: return (is_y || ch == r.keep) ? v : 0.f;
    default: return v;
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

// ToRange in to_range's own order (augment/pipeline.py): (v - DCT_MIN) /
// span as an IEEE division, then -1 + 2x, each rounded on its own.
__device__ __forceinline__ float to_range(float v) {
  const float x = __fdiv_rn(__fsub_rn(v, kDctMin), kDctMax - kDctMin);
  return __fadd_rn(-1.f, __fmul_rn(x, 2.f));
}

// ---------------------------------------------------------------- readers
// A reader gives, for sample b, the raw (dequantized) DC of block n of a
// plane (y: n = h * W + w; c: n = ch * hwc + h * W/2 + w), and the raw
// coefficient at position p of a source block.

// Dense float32 coefficients: the TPU kernel's input.
struct DenseReader {
  const float* y;
  const float* c;
  int hw, hwc;
  struct Sample {
    const float* y;
    const float* c;
  };
  struct Block {
    const float* p;
  };
  __device__ Sample sample(int b) const {
    return {y + static_cast<size_t>(b) * hw * 64, c + static_cast<size_t>(b) * 2 * hwc * 64};
  }
  // a dense sample (300 KB at 28x28) stays in device memory
  __host__ __device__ int staged_bytes() const { return 0; }
  __device__ Sample stage(const Sample& s, uint8_t*) const { return s; }
  __device__ float dc(const Sample& s, bool is_y, int n) const {
    return (is_y ? s.y : s.c)[static_cast<size_t>(n) * 64];
  }
  __device__ Block block(const Sample& s, bool is_y, int n) const {
    return {(is_y ? s.y : s.c) + static_cast<size_t>(n) * 64};
  }
  // the raw coefficients at positions p0 + e * step, e = 0..3
  __device__ void coef4(const Block& blk, int p0, int step, float (&v)[4]) const {
    if (step == 1) {  // four neighbours in a row: one 16-byte load (p0 % 4 == 0)
      const float4 q = __ldg(reinterpret_cast<const float4*>(blk.p + p0));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = __ldg(blk.p + p0 + e * step);
  }
};

enum WireFmt { kMask16 = 0, kMask16W = 1, kMask16Q = 2 };

// Byte offsets of a row's fields (data/loader.py:packed_layout), all
// multiples of 4, and the row length.
struct WireLayout {
  int row, vy, iy, sy, vc, ic, sc, quant, dy, dc;
};

// The mask16 wire: per block K values (int8, int16 for mask16w) in
// ascending position order, an 8-byte occupancy mask, a uint8 scale; exact
// int16 DC planes; mask16q's values are quantized units.  With ``staged``
// the block first copies its sample's row (32 KB at the ViT-Ti train shape,
// 68-89 KB at the eval shapes) into shared memory in coalesced 4-byte loads
// that are all in flight at once, and decodes from there: read in place,
// each output block waits on a dependent chain of device-memory loads (the
// mask, then the values at its ranks).
template <int kFmt>
struct WireReader {
  using Value = typename std::conditional<kFmt == kMask16W, int16_t, int8_t>::type;
  const uint8_t* packed;
  WireLayout lay;
  int k, hwc;
  int staged;  // 1: decode from a copy of the row in shared memory
  struct Sample {
    const uint8_t* row;  // in device or in shared memory
  };
  __host__ __device__ int staged_bytes() const { return staged ? (lay.row + 15) / 16 * 16 : 0; }
  __device__ Sample stage(const Sample& s, uint8_t* smem) const {
    if (!staged) return s;
    const unsigned int* src = reinterpret_cast<const unsigned int*>(s.row);
    unsigned int* dst = reinterpret_cast<unsigned int*>(smem);
    const int words = lay.row / 4;
    int t = threadIdx.x;
    for (; t + 3 * kThreads < words; t += 4 * kThreads) {  // four loads in flight a thread
      const unsigned int a = __ldg(src + t), b = __ldg(src + t + kThreads);
      const unsigned int c = __ldg(src + t + 2 * kThreads), d = __ldg(src + t + 3 * kThreads);
      dst[t] = a;
      dst[t + kThreads] = b;
      dst[t + 2 * kThreads] = c;
      dst[t + 3 * kThreads] = d;
    }
    for (; t < words; t += kThreads) dst[t] = __ldg(src + t);
    __syncthreads();
    return {smem};
  }
  struct Block {
    uint64_t mask;
    float scale;
    const Value* vals;
    const int16_t* quant;
  };
  __device__ Sample sample(int b) const { return {packed + static_cast<size_t>(b) * lay.row}; }
  __device__ const int16_t* quant(const Sample& s, bool is_y, int n) const {
    return reinterpret_cast<const int16_t*>(s.row + lay.quant) + (is_y ? 0 : 64 * (1 + n / hwc));
  }
  __device__ float dc(const Sample& s, bool is_y, int n) const {
    float v = static_cast<float>(reinterpret_cast<const int16_t*>(s.row + (is_y ? lay.dy : lay.dc))[n]);
    if (kFmt == kMask16Q) v = clampf(__fmul_rn(v, static_cast<float>(quant(s, is_y, n)[0])));
    return v;
  }
  __device__ Block block(const Sample& s, bool is_y, int n) const {
    const unsigned int* m = reinterpret_cast<const unsigned int*>(
        s.row + (is_y ? lay.iy : lay.ic) + static_cast<size_t>(n) * 8);
    Block blk;
    blk.mask = static_cast<uint64_t>(m[0]) | (static_cast<uint64_t>(m[1]) << 32);
    blk.scale = static_cast<float>(s.row[(is_y ? lay.sy : lay.sc) + n]);
    blk.vals = reinterpret_cast<const Value*>(s.row + (is_y ? lay.vy : lay.vc)) +
               static_cast<size_t>(n) * k;
    blk.quant = kFmt == kMask16Q ? quant(s, is_y, n) : nullptr;
    return blk;
  }
  // the raw coefficients at positions p0 + e * step, e = 0..3 (step 1 or
  // 8; p0 + 3 * step <= 63): the rank of p0 once, then the bits above it
  __device__ void coef4(const Block& blk, int p0, int step, float (&v)[4]) const {
    const int base = __popcll(blk.mask & ((1ull << p0) - 1ull));
    const unsigned int w = static_cast<unsigned int>(blk.mask >> p0);  // p0 .. p0 + 31
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = e * step;  // <= 24
      const int rank = base + __popc(w & ((1u << off) - 1u));
      float x = 0.f;
      if (((w >> off) & 1u) && rank < k)
        x = __fmul_rn(static_cast<float>(blk.vals[rank]), blk.scale);
      if (kFmt == kMask16Q) x = clampf(__fmul_rn(x, static_cast<float>(blk.quant[p0 + off])));
      v[e] = x;
    }
  }
};

// ------------------------------------------------------------------- core
// Shared memory of the train stage after the staged row, in floats: the
// factor rows (2 planes x (NR + 1) x 16 lanes x 4), the DC planes (two
// buffers each), the reduction scratch, the rounds' filter rows and the
// source block of every output block.
template <int NR>
struct TrainSmem {
  int fac, ydc, cdc, scratch, filt, src, total;
  __host__ __device__ TrainSmem(int hw, int hwc) {
    fac = 0;
    ydc = fac + 2 * (NR + 1) * 16 * 4;
    cdc = ydc + 2 * hw;
    scratch = cdc + 4 * hwc;
    filt = scratch + 3 * kWarps;
    src = filt + NR * 64;
    total = src + hw + 2 * hwc;
  }
};

// One block per sample.  kTrain: flip -> clamp -> NR rounds -> ToRange as
// v * val_scale + val_shift (the TPU kernel's form); else (eval): ToRange
// of the raw coefficients in to_range's order, no flip, no rounds.
template <class Reader, int NR, bool kTrain>
__global__ void __launch_bounds__(kThreads, 2)
    augpipe_kernel(const Reader rd, const Policy pol, float* __restrict__ yo,
                   float* __restrict__ co, int gh, int gw, float val_scale, float val_shift) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int hw = gh * gw;
  const int chh = gh / 2, cww = gw / 2, hwc = chh * cww;
  extern __shared__ __align__(16) uint8_t smem[];  // [the staged row] then TrainSmem
  Round rr[NR > 0 ? NR : 1];  // the rounds, in registers
  const bool flipped = kTrain && pol.flip[b] != 0;
  if (kTrain) {  // loaded before the row's copy waits on its barrier
#pragma unroll
    for (int k = 0; k < NR; ++k) rr[k] = load_round(pol, b, k, NR);
  }
  const auto smp = rd.stage(rd.sample(b), smem);
  const TrainSmem<NR> at(hw, hwc);
  float* base = reinterpret_cast<float*>(smem + rd.staged_bytes());
  float4* sfac = reinterpret_cast<float4*>(base + at.fac);
  float* ydc = base + at.ydc;
  float* cdc = base + at.cdc;
  int* src_of = reinterpret_cast<int*>(base + at.src);
  int cur = 0;  // which half of ydc / cdc holds the DC planes
  int par = 0;  // the parity of the transposes (Rotate90) over all rounds

  if (kTrain) {
    float* scratch = base + at.scratch;
    float* sfilt = base + at.filt;
    int par_after[NR > 0 ? NR : 1];  // the parity of the transposes after round k
#pragma unroll
    for (int k = NR - 1; k >= 0; --k) {
      par_after[k] = par;
      if (rr[k].code == kRotate90) par ^= 1;
    }
    for (int t = tid; t < NR * 64; t += kThreads) {
      const int at_k = b * NR + t / 64;
      sfilt[t] = pol.filts[(pol.idx[at_k] * 2 + (pol.sign[at_k] > 0.f ? 0 : 1)) * 64 + t % 64];
    }
    // ---- the DC planes: flip, clamp (the rounds follow, in shared memory)
    for (int t = tid; t < hw; t += kThreads) {
      const int h = t / gw, w = t - h * gw;
      ydc[t] = clampf(rd.dc(smp, true, h * gw + (flipped ? gw - 1 - w : w)));
    }
    for (int t = tid; t < 2 * hwc; t += kThreads) {
      const int ch = t / hwc, pos = t - ch * hwc, h = pos / cww, w = pos - h * cww;
      cdc[t] = clampf(rd.dc(smp, false, ch * hwc + h * cww + (flipped ? cww - 1 - w : w)));
    }
    // ---- the source block of every output block, traced back through the
    // rounds once: where it sits at each round's output decides the
    // zeroings (-1: every AC of the block is 0 from that round on)
    for (int n = tid; n < hw + 2 * hwc; n += kThreads) {
      const bool is_y = n < hw;
      const int local = is_y ? n : n - hw;
      const int ch = (!is_y && local >= hwc) ? 1 : 0;
      const int pos = local - ch * hwc;
      const int pgh = is_y ? gh : chh, pgw = is_y ? gw : cww;
      int h = pos / pgw;
      int w = pos - h * pgw;
      bool zero = false;
#pragma unroll
      for (int k = NR - 1; k >= 0; --k) {
        const Round& r = rr[k];
        if (!zero && ((r.code == kCutout && in_hole(r, is_y, h, w)) ||
                      (!is_y && (r.code == kGrayscale ||
                                 (r.code == kChromaDrop && ch != r.keep))) ||
                      !trace_block(r, is_y, pgh, pgw, h, w)))
          zero = true;
      }
      if (flipped) w = pgw - 1 - w;
      src_of[n] = zero ? -1 : ch * hwc + h * pgw + w;
    }
    __syncthreads();  // sfilt is read below
    // ---- the factor rows: a coefficient is x -> clamp(x * f) once for the
    // flip and once per round, f = -1 or 1 for the flip and Rotate90 (the
    // sign of the frequency at that point), the filter for Sharpness and
    // MidfreqAug on y, else 1 (x is in range then: clamp(x * 1) == x).
    // Row k of (plane, lane) holds f for the lane's four coefficients.
    if (tid < 32) {
      const bool is_y = tid < 16;
      const int lane = tid & 15, i = lane >> 1, j0 = (lane & 1) * 4;
      float4* row = sfac + (is_y ? 0 : NR + 1) * 16 + lane;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = (flipped && ((par ? i : j0 + e) & 1)) ? -1.f : 1.f;
      row[0] = make_float4(f[0], f[1], f[2], f[3]);
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const Round& r = rr[k];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ki = par_after[k] ? j0 + e : i, kj = par_after[k] ? i : j0 + e;
          f[e] = 1.f;
          if (r.code == kRotate90 && (((r.ty > 0) ? ki : kj) & 1)) f[e] = -1.f;
          if (is_y && (r.code == kSharpness || r.code == kMidfreqAug))
            f[e] = sfilt[k * 64 + ki * 8 + kj];
        }
        row[(k + 1) * 16] = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
    // ---- the rounds on the DC planes
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      __syncthreads();
      const Round r = rr[k];
      float* ya = ydc + cur * hw;
      float* ca = cdc + cur * 2 * hwc;
      if (r.code == kTranslateX || r.code == kTranslateY || r.code == kRotate90) {
        float* yn = ydc + (1 - cur) * hw;
        float* cn = cdc + (1 - cur) * 2 * hwc;
        for (int t = tid; t < hw; t += kThreads) {
          int h = t / gw, w = t - (t / gw) * gw;
          const bool ok = trace_block(r, true, gh, gw, h, w);
          yn[t] = ok ? clampf(ya[h * gw + w]) : 0.f;
        }
        for (int t = tid; t < 2 * hwc; t += kThreads) {
          const int ch = t / hwc, pos = t - ch * hwc;
          int h = pos / cww, w = pos - (pos / cww) * cww;
          const bool ok = trace_block(r, false, chh, cww, h, w);
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
        const float filt0 = sfilt[k * 64];
        for (int t = tid; t < hw; t += kThreads)
          ya[t] = dc_pointwise(r, filt0, true, 0, t / gw, t % gw, ya[t]);
        for (int t = tid; t < 2 * hwc; t += kThreads) {
          const int ch = t / hwc, pos = t - ch * hwc;
          ca[t] = dc_pointwise(r, filt0, false, ch, pos / cww, pos % cww, ca[t]);
        }
      }
      __syncthreads();
      for (int t = tid; t < hw; t += kThreads) ya[t] = clampf(ya[t]);
      for (int t = tid; t < 2 * hwc; t += kThreads) ca[t] = clampf(ca[t]);
    }
    __syncthreads();
  }
  const float* ydc_out = ydc + cur * hw;
  const float* cdc_out = cdc + cur * 2 * hwc;

  // ---- every output block: a group of 16 threads, four coefficients of
  // row i a thread, as one float4 store.  With an odd number of transposes
  // the four come from column i of the source block (positions p0 + 8e),
  // else from its row i (p0 + e).
  const int lane = tid & 15, i = lane >> 1, j0 = (lane & 1) * 4;
  const int p0 = par ? j0 * 8 + i : i * 8 + j0, step = par ? 8 : 1;
  float* yob = yo + static_cast<size_t>(b) * hw * 64;
  float* cob = co + static_cast<size_t>(b) * 2 * hwc * 64;
  for (int n = tid >> 4; n < hw + 2 * hwc; n += kGroups) {
    const bool is_y = n < hw;
    const int local = is_y ? n : n - hw;  // block index on its plane
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (kTrain) {
      const int src = src_of[n];
      if (src >= 0) {
        rd.coef4(rd.block(smp, is_y, src), p0, step, v);
        const float4* fac = sfac + (is_y ? 0 : NR + 1) * 16 + lane;
#pragma unroll
        for (int k = 0; k <= NR; ++k) {  // the flip, then each round
          const float4 f = fac[k * 16];
          v[0] = clampf(v[0] * f.x);
          v[1] = clampf(v[1] * f.y);
          v[2] = clampf(v[2] * f.z);
          v[3] = clampf(v[3] * f.w);
        }
      }
      const float dc = is_y ? ydc_out[local] : cdc_out[local];
      if (lane == 0) v[0] = dc;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = fmaf(v[e], val_scale, val_shift);
    } else {
      rd.coef4(rd.block(smp, is_y, local), p0, 1, v);
      const float dc = rd.dc(smp, is_y, local);  // every lane loads, lane 0 keeps it
      if (lane == 0) v[0] = dc;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = to_range(v[e]);
    }
    float* dst = (is_y ? yob : cob) + static_cast<size_t>(local) * 64 + i * 8 + j0;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Shared memory of the train stage (TrainSmem), in bytes; none for eval.
template <int NR, bool kTrain>
int dc_bytes(int gh, int gw) {
  return kTrain ? TrainSmem<NR>(gh * gw, (gh / 2) * (gw / 2)).total *
                      static_cast<int>(sizeof(float))
                : 0;
}

template <class Reader, int NR, bool kTrain>
cudaError_t launch(const Reader& rd, const Policy& pol, float* yo, float* co, int batch, int gh,
                   int gw, float val_scale, float val_shift, cudaStream_t stream) {
  const int bytes = rd.staged_bytes() + dc_bytes<NR, kTrain>(gh, gw);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        augpipe_kernel<Reader, NR, kTrain>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  augpipe_kernel<Reader, NR, kTrain><<<batch, kThreads, bytes, stream>>>(
      rd, pol, yo, co, gh, gw, val_scale, val_shift);
  return cudaGetLastError();
}

template <class Reader>
cudaError_t launch_train(const Reader& rd, const Policy& pol, float* yo, float* co, int batch,
                         int gh, int gw, int num_ops, float val_scale, float val_shift,
                         cudaStream_t stream) {
  switch (num_ops) {
    case 0: return launch<Reader, 0, true>(rd, pol, yo, co, batch, gh, gw, val_scale, val_shift, stream);
    case 1: return launch<Reader, 1, true>(rd, pol, yo, co, batch, gh, gw, val_scale, val_shift, stream);
    case 2: return launch<Reader, 2, true>(rd, pol, yo, co, batch, gh, gw, val_scale, val_shift, stream);
    case 3: return launch<Reader, 3, true>(rd, pol, yo, co, batch, gh, gw, val_scale, val_shift, stream);
    case kMaxRounds:
      return launch<Reader, kMaxRounds, true>(rd, pol, yo, co, batch, gh, gw, val_scale,
                                              val_shift, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int kFmt>
cudaError_t launch_wire(const WireReader<kFmt>& rd, const Policy& pol, float* yo, float* co,
                        int batch, int grid, bool train, int num_ops, float val_scale,
                        float val_shift, cudaStream_t stream) {
  if (train)
    return launch_train(rd, pol, yo, co, batch, grid, grid, num_ops, val_scale, val_shift, stream);
  return launch<WireReader<kFmt>, 0, false>(rd, pol, yo, co, batch, grid, grid, 0.f, 0.f, stream);
}

Policy make_policy(const void* idx, const void* sign, const void* cut_ch, const void* cut_cw,
                   const void* drop, const void* flip, const void* codes, const void* params,
                   const void* filts) {
  return {static_cast<const int*>(idx), static_cast<const float*>(sign),
          static_cast<const int*>(cut_ch), static_cast<const int*>(cut_cw),
          static_cast<const int*>(drop), static_cast<const int*>(flip),
          static_cast<const int*>(codes), static_cast<const float*>(params),
          static_cast<const float*>(filts)};
}

}  // namespace

// C entry for ctypes, the dense reader.  Device pointers: y (B, 1, gh*gw,
// 64), c (B, 2, (gh/2)*(gw/2), 64) and the outputs yo, co of the same shapes,
// float32, contiguous, yo and co 16-byte aligned; idx, cut_ch, cut_cw, drop
// int32 and sign float32, each (B, num_ops); flip int32 (B,); the op table
// codes int32 (n_list,), params float32 (n_list, 4), filts float32 (n_list,
// 2, 64).  Rotate90 needs gh == gw (the caller checks).  Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int augpipe_fwd(const void* y, const void* c, void* yo, void* co, const void* idx,
                           const void* sign, const void* cut_ch, const void* cut_cw,
                           const void* drop, const void* flip, const void* codes,
                           const void* params, const void* filts, int batch, int gh, int gw,
                           int num_ops, float val_scale, float val_shift, void* stream) {
  if (batch <= 0 || gh <= 1 || gw <= 1 || gh % 2 || gw % 2) return cudaErrorInvalidValue;
  const DenseReader rd{static_cast<const float*>(y), static_cast<const float*>(c), gh * gw,
                       (gh / 2) * (gw / 2)};
  return launch_train(rd, make_policy(idx, sign, cut_ch, cut_cw, drop, flip, codes, params, filts),
                      static_cast<float*>(yo), static_cast<float*>(co), batch, gh, gw, num_ops,
                      val_scale, val_shift, static_cast<cudaStream_t>(stream));
}

// C entry for ctypes, the wire reader.  packed: device (B, layout[0]) uint8
// rows, 4-byte aligned; layout: a host array of the row length and the byte
// offsets of vy, iy, sy, vc, ic, sc, quant, dy, dc (data/loader.py:
// packed_layout, each a multiple of 4); k the values per block; fmt 0
// mask16, 1 mask16w, 2 mask16q; grid the y plane's blocks per side.  Outputs
// yo (B, 1, grid, grid, 8, 8), co (B, 2, grid/2, grid/2, 8, 8) float32,
// 16-byte aligned.  train = 1 takes the policy, flip, op table, num_ops and
// ToRange's val_scale / val_shift as augpipe_fwd does; train = 0 is the
// eval stage (ToRange in to_range's order; the policy pointers may be null).
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int augpipe_wire(const void* packed, void* yo, void* co, const int* layout, int k,
                            int fmt, int train, const void* idx, const void* sign,
                            const void* cut_ch, const void* cut_cw, const void* drop,
                            const void* flip, const void* codes, const void* params,
                            const void* filts, int batch, int grid, int num_ops,
                            float val_scale, float val_shift, void* stream) {
  if (batch <= 0 || grid <= 1 || grid % 2 || k <= 0 || k > 64 || fmt < 0 || fmt > 2 ||
      reinterpret_cast<uintptr_t>(packed) % 4)
    return cudaErrorInvalidValue;
  for (int f = 0; f < 10; ++f)
    if (layout[f] < 0 || layout[f] % 4) return cudaErrorInvalidValue;
  const WireLayout lay{layout[0], layout[1], layout[2], layout[3], layout[4],
                       layout[5], layout[6], layout[7], layout[8], layout[9]};
  const Policy pol = make_policy(idx, sign, cut_ch, cut_cw, drop, flip, codes, params, filts);
  const int hwc = (grid / 2) * (grid / 2);
  // stage the row where it fits beside the DC planes with two blocks an SM
  const int dc = train ? dc_bytes<kMaxRounds, true>(grid, grid) : 0;
  const int staged = (lay.row + 15) / 16 * 16 + dc <= kStageBudget ? 1 : 0;
  const auto* rows = static_cast<const uint8_t*>(packed);
  float* y = static_cast<float*>(yo);
  float* c = static_cast<float*>(co);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kMask16:
      return launch_wire(WireReader<kMask16>{rows, lay, k, hwc, staged}, pol, y, c, batch, grid,
                         train != 0, num_ops, val_scale, val_shift, st);
    case kMask16W:
      return launch_wire(WireReader<kMask16W>{rows, lay, k, hwc, staged}, pol, y, c, batch,
                         grid, train != 0, num_ops, val_scale, val_shift, st);
    default:
      return launch_wire(WireReader<kMask16Q>{rows, lay, k, hwc, staged}, pol, y, c, batch,
                         grid, train != 0, num_ops, val_scale, val_shift, st);
  }
}

extern "C" const char* augpipe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
