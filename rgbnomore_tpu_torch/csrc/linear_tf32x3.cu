// Float32 Linear layers on the tensor cores, in 3xTF32: the forward
// Y = X W^T + b, the input gradient dX = dY W, and the weight gradient
// dW = dY^T X with db = sum over rows of dY, for models/layers.py:Linear at
// compute dtype float32 (ops/linear.py launches them).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA
// (flax Dense, rgbnomore_tpu/models/embeddings.py:74-84 and the ViT's and
// SwinV2's Dense layers).  It exists because PyTorch runs a float32 matmul
// with TF32 off as FFMA kernels on the CUDA cores: at ViT-S's shapes they
// reach about 49 TFLOP/s, 73% of the CUDA cores' 67, and take three
// quarters of a float32 ViT-S step.  The tensor cores take float32 only as
// TF32; 3xTF32 (tf32_mma.cuh: x = hi + lo, a b ~= a_hi b_lo + a_lo b_hi +
// a_hi b_hi) keeps float32's accuracy at a third of their 495 TFLOP/s.
//
// Bounds on an H100 SXM at ViT-S's shapes, batch 1,024 (M = 200,704 rows):
//   operations: 2 M N K a product, three TF32 products each, at 495
//          TFLOP/s: qkv (K 384, N 1,152) 1.08 ms, proj (384, 384) 0.36 ms,
//          mlp1 (384, 1,536) and mlp2 (1,536, 384) 1.44 ms each;
//   bytes: the activations read once and the output written once, 0.18-0.46
//          ms at 3.35 TB/s.
// Every product is bound by operations, 2.3-3.1x above its bytes.
//
// Design (Hopper: TMA, mbarriers, wgmma; wgmma.cuh's descriptors):
//   - Blocks of two consumer warpgroups (a 128-row tile, 64 rows each) and
//     a producer warpgroup, one warp of which loads (setmaxnreg gives the
//     rest of its registers to the consumers).  The producer fills a ring
//     of shared-memory stages by TMA, 32 float32 of the contraction a stage
//     (one 128-byte swizzled row), and each stage's full / empty mbarriers
//     pass it between them.
//     TMA fills a box past the matrix with zeros, so ragged M, N and K edges
//     cost no code; the epilogue masks its stores.
//   - tf32 wgmma reads B only K-major from shared memory, and A K-major from
//     shared memory or from registers.  The large activation operand (X or
//     dY) is A: each consumer thread loads its fragment from the swizzled
//     stage (free of bank conflicts), splits it into hi and lo in registers
//     and feeds both as A.  So no activation-sized hi, lo or transposed copy
//     is ever written to device memory.
//   - The weight is small (2.4 MB at most in ViT-S): split_kernel writes its
//     hi and lo halves once a call, K-major as each product wants them (W
//     for the forward, W^T for the input gradient), zero-padded to rows of a
//     multiple of 4 floats for TMA.
//   - mm_kernel (forward, input gradient) is persistent: one block an SM
//     walks 128 x BN output tiles; the producer runs ahead into the next
//     tile, and the consumers store a tile (with the bias, in the forward)
//     while the next one's first products run.  Per stage a consumer
//     warpgroup issues one chain of 12 products: for each 8-deep k step,
//     a_hi b_lo, a_lo b_hi, then a_hi b_hi, and while it runs loads the next
//     stage's A fragments; then it adds the chain into a float32 sum of its
//     own (retire: the tensor cores' accumulator rounds toward zero, which
//     over a long chain is a drift, not a rounding).
//   - A weight rounded to bf16 or fp16 before the product (SwinV2's qkv
//     under AMP) is exact in TF32: its lo half is zero.  With b_exact the
//     forward and input gradient load only the hi half and leave a_hi b_lo
//     out of the chain: 8 products, the same sums bit for bit, and stages of
//     two thirds the size, so more of them.
//   - wgrad_kernel: dW = dY^T X contracts over M, so both operands run along
//     M.  A = dY^T comes from registers, read transposed out of the dY
//     stage; B = X^T is converted by the consumers from the X stage into
//     K-major hi and lo tiles in shared memory, double-buffered: the next
//     step converts while this one's products run.  dW has few 128 x BN
//     tiles (9-36 at ViT-S), so the tiles' 32-row steps of M
//     are dealt out evenly to one block an SM (stream-K: a block's range
//     may end one tile and start the next), each block writes its part of
//     each tile it touches, and wgrad_reduce_kernel adds the parts in block
//     order, so dW repeats bit for bit from run to run.  db is the sum of
//     the same dY values as they pass through the registers, reduced the
//     same way.
//   - BN is 128, or 64 where that pads the output's columns less; the stages
//     are as many as shared memory holds; the weight gradient's blocks
//     follow its tile count and M.
//   - A matrix that TMA cannot describe (a row stride or base address not a
//     multiple of 16 bytes: ViT-L's separate embedding, 170 columns) is
//     copied into the same swizzled stage by the producer warp's own loads.
// Operands: row-major float32; X (M, K), W (N, K), b (N), Y (M, N).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kBM = 128;                          // tile rows: two warpgroups of 64
constexpr int kBK = 32;                           // contraction a stage: 128 bytes
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * kConsumerWarps + 128;  // and the producer warpgroup
constexpr int kProducerRegs = 56;   // setmaxnreg: the producer gives registers up,
constexpr int kConsumerRegs = 224;  // the consumers take them (384 x 168 at launch)
constexpr int kSmemMax = 232448;                  // a block's shared memory on the H100
constexpr int kSmemSpare = 2048;                  // 1024-byte alignment and the barriers
constexpr int kMaxStages = 8;
constexpr int kAtom = 32 * 128;                   // a swizzled atom of 32 rows

// ---------------------------------------------------------------- mbarriers
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(b)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete.  The loop is PTX, so that the
// compiler sees no divergent branch around the products (a branch it cannot
// prove uniform makes ptxas serialise every wgmma of the kernel, C7520).  A
// wait of more than 2^34 clocks (about nine seconds) traps: a fault at the
// next synchronise rather than a card left spinning.
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .s64 t0, t1;\n mov.u64 t0, %%clock64;\n"
      "WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @p bra.uni DONE;\n"
      " mov.u64 t1, %%clock64;\n sub.s64 t1, t1, t0;\n setp.gt.s64 p, t1, 17179869184;\n"
      " @p trap;\n bra.uni WAIT;\nDONE:\n}\n" ::"r"(saddr(b)),
      "r"(parity)
      : "memory");
}

// the 256 consumer threads (named barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ---------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(saddr(bar))
      : "memory");
}

// Byte offset of float (r, c) in a swizzled atom: rows of 128 bytes, the
// 16-byte chunk c / 4 of row r stored at chunk (c / 4) ^ (r % 8), as TMA's
// 128-byte swizzle writes a box of 32 floats a row.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((((c >> 2) ^ r) & 7) << 4) + ((c & 3) << 2);
}

__device__ __forceinline__ float atom_at(const unsigned char* atom, int r, int c) {
  return *reinterpret_cast<const float*>(atom + swz(r, c));
}

// The producer warp's copy of the box rows row0 .. row0 + rows - 1, columns
// col0 .. col0 + 31 of a row-major (n_rows, n_cols) matrix with row stride
// ld into the atom dst, zeros outside: what a TMA load of the box writes,
// for a matrix that TMA cannot describe.
__device__ __forceinline__ void copy_box(unsigned char* dst, const float* src, long long ld,
                                         long long row0, int col0, int rows, long long n_rows,
                                         int n_cols, int lane) {
  for (int i = lane; i < rows * 32; i += 32) {
    const int r = i >> 5, c = i & 31;
    const bool live = row0 + r < n_rows && col0 + c < n_cols;
    *reinterpret_cast<float*>(dst + swz(r, c)) = live ? src[(row0 + r) * ld + col0 + c] : 0.f;
  }
}

// -------------------------------------------------------------------- wgmma
// d (64 x BN) = A (64 x 8, tf32 from registers) B (8 x BN, tf32, K-major in
// shared memory), + d when `acc`.  A's registers for warp w of the warpgroup and lane
// 4 g + t: a0 (16w + g, t), a1 (16w + g + 8, t), a2 (16w + g, t + 4), a3
// (16w + g + 8, t + 4); d as in wgmma.cuh.
template <int BN>
__device__ __forceinline__ void mma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b,
                                       bool acc);

template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           bool acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : H16_D8(0), H16_D8(8), H16_D8(16), H16_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(acc)));
}

template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            bool acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : H16_D8(0), H16_D8(8), H16_D8(16), H16_D8(24), H16_D8(32), H16_D8(40), H16_D8(48), H16_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(acc)));
}

// A stage's A fragments (4 k steps of 8) out of the warpgroup's 64 rows of
// a swizzled stage, split into hi and lo: row r0 and r0 + 8, columns 8 s +
// t and 8 s + t + 4 (tf32::split; free of bank conflicts)
using Frags = uint32_t[4][4];

__device__ __forceinline__ void load_a(Frags& ahi, Frags& alo, const unsigned char* sa, int r0,
                                       int tq) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int c = 8 * s + tq;
    tf32::split(atom_at(sa, r0, c), ahi[s][0], alo[s][0]);
    tf32::split(atom_at(sa, r0 + 8, c), ahi[s][1], alo[s][1]);
    tf32::split(atom_at(sa, r0, c + 4), ahi[s][2], alo[s][2]);
    tf32::split(atom_at(sa, r0 + 8, c + 4), ahi[s][3], alo[s][3]);
  }
}

// The compiler may not move reads or writes of these registers across this
// point: the A fragments stay live, and unchanged, while products in flight
// read them.
__device__ __forceinline__ void fence_frags(Frags& a) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
}

// Issue a stage's 12 products as one chain: for each 8-deep k step s,
// a_hi b_lo, a_lo b_hi, a_hi b_hi, with B's hi and lo tiles at bhi, blo (BN
// rows of 128 bytes), into d from zero.  kExactB: B is exact in TF32 (a
// weight rounded to bf16 or fp16 first), so its lo half is zero and a_hi b_lo
// adds only zeros; the chain leaves it out (8 products, the same sums) and
// blo is not read.
template <int BN, bool kExactB>
__device__ __forceinline__ void issue(float (&d)[BN / 2], Frags& ahi, Frags& alo,
                                      const unsigned char* bhi, const unsigned char* blo) {
  h16::fence_operand(d);
  fence_frags(ahi);
  fence_frags(alo);
  h16::fence();
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint64_t dhi = h16::desc(bhi + 32 * s, 16, 1024);
    if constexpr (!kExactB) mma_rs<BN>(d, ahi[s], h16::desc(blo + 32 * s, 16, 1024), s > 0);
    mma_rs<BN>(d, alo[s], dhi, !kExactB || s > 0);
    mma_rs<BN>(d, ahi[s], dhi, true);
  }
  h16::commit();
}

// Wait for the chain, then sum += d.  The tensor cores round their float32
// accumulator toward zero, so a chain over all of K (or, in the weight
// gradient, all of M) drifts toward zero by up to a unit in the last place
// a product: 1.5e-4 of a weight gradient's norm over ViT-S's 200,704 rows.
// Each stage's 12 products start afresh, and the thread adds them into its
// own float32 sum, rounded to nearest.
template <int BN>
__device__ __forceinline__ void retire(float (&d)[BN / 2], float (&sum)[BN / 2], Frags& ahi,
                                       Frags& alo) {
  h16::wait<0>();
  h16::fence_operand(d);
  fence_frags(ahi);
  fence_frags(alo);
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sum[i] += d[i];
}

// Store the pair (x0, x1) at columns col, col + 1 of row `row` of a
// row-major (rows, cols) matrix with row stride ld; one 8-byte store where
// `pairs` (ld even, the base 8-byte aligned).
__device__ __forceinline__ void store_pair(float* c, long long ld, long long row, int col,
                                           long long rows, int cols, bool pairs, float x0,
                                           float x1) {
  if (row >= rows || col >= cols) return;
  float* p = c + row * ld + col;
  if (pairs && col + 1 < cols) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (col + 1 < cols) p[1] = x1;
  }
}

// ------------------------------------------------------------ C = A B^T + b
struct MmArgs {
  long long m;          // rows of A and C
  int n, k;             // columns of C; the contraction
  const float* a;       // A (m, k), row stride lda: the producer's own loads when !a_tma
  long long lda;
  int a_tma;
  const float* bias;    // n values, or null
  float* c;             // C (m, n), row stride n
  int pairs;
};

template <int BN, bool kExactB>
struct MmShape {
  static constexpr int kA = kBM * 128;  // A: 128 rows x 32 floats
  static constexpr int kB = BN * 128;   // each of B's hi and lo: BN rows x 32 floats
  static constexpr int kHalves = kExactB ? 1 : 2;  // B's halves loaded: hi only when exact
  static constexpr int kStage = kA + kHalves * kB;
  static constexpr int kStages =
      (kSmemMax - kSmemSpare) / kStage < kMaxStages ? (kSmemMax - kSmemSpare) / kStage
                                                     : kMaxStages;
  static constexpr int kSmem = kStages * kStage + kSmemSpare;
};

// A forward / input-gradient consumer thread's running state
template <int BN>
struct MmState {
  float d[BN / 2], sum[BN / 2];  // the chain's accumulator; the tile's sum
  int r0, tq, a_off;             // rows r0, r0 + 8 of the warpgroup's 64; lane % 4; its A rows
  long long tile;                // the tile of the current unit
  int ks;                        // the unit's step of K
};

// Store the tile t's sum (+ the bias) into C
template <int BN>
__device__ __forceinline__ void mm_store(const MmState<BN>& c, const MmArgs& p, long long t,
                                         long long n_tiles, int wg) {
  const long long row = t / n_tiles * kBM + wg * 64 + c.r0;
  const int n0 = static_cast<int>(t % n_tiles) * BN;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * c.tq;
    float b0 = 0.f, b1 = 0.f;
    if (p.bias != nullptr) {
      if (col < p.n) b0 = p.bias[col];
      if (col + 1 < p.n) b1 = p.bias[col + 1];
    }
    store_pair(p.c, p.n, row, col, p.m, p.n, p.pairs, c.sum[4 * j] + b0, c.sum[4 * j + 1] + b1);
    store_pair(p.c, p.n, row + 8, col, p.m, p.n, p.pairs, c.sum[4 * j + 2] + b0,
               c.sum[4 * j + 3] + b1);
  }
}

// One unit of mm_kernel's consumers: the products of the unit whose A
// fragments are ahi, alo run while the next unit's, if `more`, load into
// nhi, nlo and, at a tile's first unit, the tile before it is stored; then
// their sum.
template <int BN, bool kExactB>
__device__ __forceinline__ void mm_unit(MmState<BN>& c, const MmArgs& p, bool more, Frags& ahi,
                                        Frags& alo, Frags& nhi, Frags& nlo, unsigned char* smem,
                                        uint64_t* full, uint64_t* empty, int& stage,
                                        uint32_t& phase, long long n_tiles, int k_steps, int wg) {
  using S = MmShape<BN, kExactB>;
  const unsigned char* sb = smem + stage * S::kStage + S::kA;
  issue<BN, kExactB>(c.d, ahi, alo, sb, sb + S::kB);
  const int done = stage;
  if (++stage == S::kStages) {
    stage = 0;
    phase ^= 1;
  }
  if (more) {
    bar_wait(&full[stage], phase);
    load_a(nhi, nlo, smem + stage * S::kStage + c.a_off, c.r0, c.tq);
  }
  if (c.ks == 0 && c.tile != blockIdx.x) {  // the tile before, while the products run
    mm_store<BN>(c, p, c.tile - gridDim.x, n_tiles, wg);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) c.sum[i] = 0.f;
  }
  retire<BN>(c.d, c.sum, ahi, alo);
  bar_arrive(&empty[done]);  // every consumer thread: no branch on the lane
  if (++c.ks == k_steps) {
    c.ks = 0;
    c.tile += gridDim.x;
  }
}

// map_a: A as a 2-D map (k, m), box 32 x 128; map_b: B's hi and lo as a 3-D
// map (k padded, n, 2), box 32 x BN x 1 (the hi half alone when kExactB)
template <int BN, bool kExactB>
__global__ void __launch_bounds__(kThreads, 1)
    mm_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, const MmArgs p) {
  using S = MmShape<BN, kExactB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = h16::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kStages * S::kStage);
  uint64_t* empty = full + S::kStages;
  // the warp index through a shuffle, which the compiler knows is uniform
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;
  const long long n_tiles = (p.n + BN - 1) / BN;
  const long long tiles = (p.m + kBM - 1) / kBM * n_tiles;
  const int k_steps = (p.k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      bar_init(&full[s], p.a_tma ? 1 : 32);
      bar_init(&empty[s], 32 * kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (warp >= kConsumerWarps) {  // the producer warpgroup: one warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps) return;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long m0 = t / n_tiles * kBM;
      const int n0 = static_cast<int>(t % n_tiles) * BN;
      for (int ks = 0; ks < k_steps; ++ks) {
        bar_wait(&empty[stage], phase ^ 1);
        unsigned char* sa = smem + stage * S::kStage;
        unsigned char* sb = sa + S::kA;
        const int k0 = ks * kBK;
        if (!p.a_tma) copy_box(sa, p.a, p.lda, m0, k0, kBM, p.m, p.k, lane);
        if (lane == 0) {
          bar_arrive_tx(&full[stage], (p.a_tma ? S::kA : 0) + S::kHalves * S::kB);
          if (p.a_tma) tma_2d(sa, &map_a, &full[stage], k0, static_cast<int>(m0));
          tma_3d(sb, &map_b, &full[stage], k0, n0, 0);
          if constexpr (!kExactB) tma_3d(sb + S::kB, &map_b, &full[stage], k0, n0, 1);
        } else if (!p.a_tma) {
          bar_arrive(&full[stage]);
        }
        if (++stage == S::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, w = warp % 4, g = lane / 4, tq = lane % 4;
  MmState<BN> c;
  c.r0 = 16 * w + g;
  c.tq = tq;
  c.a_off = wg * 64 * 128;
  c.tile = blockIdx.x;
  c.ks = 0;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) c.d[i] = c.sum[i] = 0.f;
  uint32_t a0hi[4][4], a0lo[4][4], a1hi[4][4], a1lo[4][4];
  // the block's units (tile, 32-deep step of K), its tiles one after another
  const long long my_tiles = tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long units = my_tiles * k_steps;
  // the products of unit u run while the A fragments of u + 1 load (two sets
  // of fragments, taken in turn) and, at a tile's first unit, the tile
  // before it is stored
  if (units > 0) {
    bar_wait(&full[stage], phase);
    load_a(a0hi, a0lo, smem + stage * S::kStage + c.a_off, c.r0, tq);
  }
  for (long long u = 0; u < units; u += 2) {
    mm_unit<BN, kExactB>(c, p, u + 1 < units, a0hi, a0lo, a1hi, a1lo, smem, full, empty, stage,
                         phase, n_tiles, k_steps, wg);
    if (u + 1 < units)
      mm_unit<BN, kExactB>(c, p, u + 2 < units, a1hi, a1lo, a0hi, a0lo, smem, full, empty, stage,
                           phase, n_tiles, k_steps, wg);
  }
  if (units > 0) mm_store<BN>(c, p, c.tile - gridDim.x, n_tiles, wg);
}

// ------------------------------------------------------ dW = dY^T X, db
struct WgradArgs {
  long long m;            // rows of dY and X: the contraction
  int n, k;               // columns of dY and of X: dW is (n, k)
  const float* dy;        // the producer's own loads when !dy_tma / !x_tma
  long long ldy;
  int dy_tma;
  const float* x;
  long long ldx;
  int x_tma;
  float* part;            // partial tiles (128 x BN): block c's part of tile t in slot c + t
  float* part_b;          // their partial column sums of dY (128 a slot), or null: no bias
  long long steps;        // 32-row steps of M
  long long units;        // tiles x steps, split evenly over the blocks
};

template <int BN>
struct WgradShape {
  static constexpr int kDy = 4 * kAtom;          // dY: 32 rows x 128 columns (n)
  static constexpr int kX = BN / 32 * kAtom;     // X: 32 rows x BN columns (k)
  static constexpr int kStage = kDy + kX;
  static constexpr int kT = BN * 128;            // X^T's hi or lo: BN rows x 32 floats
  static constexpr int kConv = 4 * kT;           // hi and lo, two buffers
  static constexpr int kStages =
      (kSmemMax - kSmemSpare - kConv) / kStage < kMaxStages
          ? (kSmemMax - kSmemSpare - kConv) / kStage
          : kMaxStages;
  static constexpr int kSmem = kStages * kStage + kConv + kSmemSpare;
};

// Take in a weight-gradient stage (dY's 32 x 128 and X's 32 x BN at sdy,
// in swizzled atoms): X^T's hi and lo into thi and thi + BN * 128, K-major
// (4 consecutive k of one row m in, 4 rows k out; neighbouring lanes take
// neighbouring m, free of bank conflicts), and the thread's A fragments of
// dY^T (A (n, m) = dY (m, n), rows nr and nr + 8), whose values also go
// into the step's column sums of dY for those rows, cs.
template <int BN>
__device__ __forceinline__ void wgrad_in(const unsigned char* sdy, unsigned char* thi, int nr,
                                         int tq, Frags& ahi, Frags& alo, float (&cs)[2]) {
  const unsigned char* sx = sdy + 4 * kAtom;
  unsigned char* tlo = thi + BN * 128;
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {  // 32 x BN floats, 4 a thread-step
    const int e = threadIdx.x + 32 * kConsumerWarps * i;
    const int mr = e & 31, kc = e >> 5;
    const float4 v = *reinterpret_cast<const float4*>(sx + (kc >> 3) * kAtom + swz(mr, 4 * kc));
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t hi, lo;
      tf32::split(vs[q], hi, lo);
      const int off = swz(4 * kc + q, mr);
      *reinterpret_cast<uint32_t*>(thi + off) = hi;
      *reinterpret_cast<uint32_t*>(tlo + off) = lo;
    }
  }
  const unsigned char* a0 = sdy + (nr >> 5) * kAtom;
  const unsigned char* a1 = sdy + ((nr + 8) >> 5) * kAtom;
  cs[0] = cs[1] = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int mc = 8 * s + tq;
    const float v00 = atom_at(a0, mc, nr & 31), v10 = atom_at(a1, mc, (nr + 8) & 31);
    const float v01 = atom_at(a0, mc + 4, nr & 31), v11 = atom_at(a1, mc + 4, (nr + 8) & 31);
    cs[0] += v00 + v01;
    cs[1] += v10 + v11;
    tf32::split(v00, ahi[s][0], alo[s][0]);
    tf32::split(v10, ahi[s][1], alo[s][1]);
    tf32::split(v01, ahi[s][2], alo[s][2]);
    tf32::split(v11, ahi[s][3], alo[s][3]);
  }
}

// A weight-gradient consumer thread's running state
template <int BN>
struct WgradState {
  float d[BN / 2], sum[BN / 2];  // the chain's accumulator; the tile's sum
  float bsum[2];                 // the tile's column sums of dY, rows nr and nr + 8
  int nr, tq;                    // the thread's rows nr, nr + 8; its lane % 4
  long long tile;                // the tile of the current unit
  int left;                      // its units still to come, the current one included
};

// One unit of wgrad_kernel's consumers: the products of the unit taken in
// (fragments ahi, alo and column sums cs; X^T in tcur) run while the next
// unit, if `more`, is taken in (into nhi, nlo, ns; X^T into tnext); then
// their sum, and the tile's part written out where the unit ends it (or
// the block's range).
template <int BN>
__device__ __forceinline__ void wgrad_unit(WgradState<BN>& c, const WgradArgs& p, bool more,
                                           Frags& ahi, Frags& alo, float (&cs)[2], Frags& nhi,
                                           Frags& nlo, float (&ns)[2], unsigned char* tcur,
                                           unsigned char* tnext, unsigned char* smem,
                                           uint64_t* full, uint64_t* empty, int& stage,
                                           uint32_t& phase, int k_tiles) {
  using S = WgradShape<BN>;
  issue<BN, false>(c.d, ahi, alo, tcur, tcur + S::kT);
  if (more) {
    bar_wait(&full[stage], phase);
    wgrad_in<BN>(smem + stage * S::kStage, tnext, c.nr, c.tq, nhi, nlo, ns);
    bar_arrive(&empty[stage]);  // the stage is read (every consumer thread)
    if (++stage == S::kStages) {
      stage = 0;
      phase ^= 1;
    }
    h16::proxy_fence();  // the conversion's stores, visible to the products
  }
  retire<BN>(c.d, c.sum, ahi, alo);
  c.bsum[0] += cs[0];
  c.bsum[1] += cs[1];
  if (--c.left == 0 || !more) {  // the block's part of a tile ends
    const long long slot = blockIdx.x + c.tile;
    float* out = p.part + slot * (kBM * BN);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * c.tq;
      *reinterpret_cast<float2*>(out + c.nr * BN + col) = make_float2(c.sum[4 * j],
                                                                      c.sum[4 * j + 1]);
      *reinterpret_cast<float2*>(out + (c.nr + 8) * BN + col) =
          make_float2(c.sum[4 * j + 2], c.sum[4 * j + 3]);
    }
    if (p.part_b != nullptr && c.tile % k_tiles == 0) {
      // the row sums over the four lanes of a row, in a fixed order
      float b0 = c.bsum[0], b1 = c.bsum[1];
      b0 += __shfl_xor_sync(0xffffffffu, b0, 1);
      b1 += __shfl_xor_sync(0xffffffffu, b1, 1);
      b0 += __shfl_xor_sync(0xffffffffu, b0, 2);
      b1 += __shfl_xor_sync(0xffffffffu, b1, 2);
      if (c.tq == 0) {
        p.part_b[slot * kBM + c.nr] = b0;
        p.part_b[slot * kBM + c.nr + 8] = b1;
      }
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) c.sum[i] = 0.f;
    c.bsum[0] = c.bsum[1] = 0.f;
    ++c.tile;
    c.left = static_cast<int>(p.steps);
  }
  // every thread's conversion is in, and every product of this unit out of
  // the buffer the next conversion writes
  consumers_sync();
}

// Block c of P takes the units [c U / P, (c + 1) U / P) of the U = tiles x
// steps units (tile t = u / steps, its 32-row step u % steps), so every
// block has the same work (stream-K); where its range crosses into a new
// tile it writes the one it leaves to its slot (c + t) and starts the next.
// map_dy: dY as (n, m), box 32 x 32; map_x: X as (k, m), box 32 x 32.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_kernel(const __grid_constant__ CUtensorMap map_dy,
                 const __grid_constant__ CUtensorMap map_x, const WgradArgs p) {
  using S = WgradShape<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = h16::align1024(smem_raw);
  unsigned char* conv = smem + S::kStages * S::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(conv + S::kConv);
  uint64_t* empty = full + S::kStages;
  // the warp index through a shuffle, which the compiler knows is uniform
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);
  const int lane = threadIdx.x % 32;
  const int k_tiles = (p.k + BN - 1) / BN;
  const long long first = blockIdx.x * p.units / gridDim.x;
  const long long last = (blockIdx.x + 1LL) * p.units / gridDim.x;
  const bool manual = !p.dy_tma || !p.x_tma;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      bar_init(&full[s], manual ? 32 : 1);
      bar_init(&empty[s], 32 * kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int stage = 0;
  uint32_t phase = 0;
  if (warp >= kConsumerWarps) {  // the producer warpgroup: one warp loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps) return;
    for (long long u = first; u < last; ++u) {
      const long long t = u / p.steps;
      const int n0 = static_cast<int>(t / k_tiles) * kBM, k0 = static_cast<int>(t % k_tiles) * BN;
      const long long m0 = (u - t * p.steps) * kBK;
      bar_wait(&empty[stage], phase ^ 1);
      unsigned char* sdy = smem + stage * S::kStage;
      unsigned char* sx = sdy + S::kDy;
      if (!p.dy_tma)
        for (int a = 0; a < 4; ++a)
          copy_box(sdy + a * kAtom, p.dy, p.ldy, m0, n0 + 32 * a, 32, p.m, p.n, lane);
      if (!p.x_tma)
        for (int a = 0; a < BN / 32; ++a)
          copy_box(sx + a * kAtom, p.x, p.ldx, m0, k0 + 32 * a, 32, p.m, p.k, lane);
      if (lane == 0) {
        bar_arrive_tx(&full[stage], (p.dy_tma ? S::kDy : 0) + (p.x_tma ? S::kX : 0));
        if (p.dy_tma)
          for (int a = 0; a < 4; ++a)
            tma_2d(sdy + a * kAtom, &map_dy, &full[stage], n0 + 32 * a, static_cast<int>(m0));
        if (p.x_tma)
          for (int a = 0; a < BN / 32; ++a)
            tma_2d(sx + a * kAtom, &map_x, &full[stage], k0 + 32 * a, static_cast<int>(m0));
      } else if (manual) {
        bar_arrive(&full[stage]);
      }
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, w = warp % 4, g = lane / 4, tq = lane % 4;
  WgradState<BN> c;
  c.nr = wg * 64 + 16 * w + g;
  c.tq = tq;
  c.tile = first / p.steps;
  c.left = static_cast<int>(p.steps - first % p.steps);  // units of the tile still to come
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) c.d[i] = c.sum[i] = 0.f;
  c.bsum[0] = c.bsum[1] = 0.f;
  uint32_t a0hi[4][4], a0lo[4][4], a1hi[4][4], a1lo[4][4];
  float cs0[2], cs1[2];
  // the products of unit u run while unit u + 1 converts into the other
  // buffer and its A fragments load: two sets of fragments, taken in turn
  if (first < last) {
    bar_wait(&full[stage], phase);
    wgrad_in<BN>(smem + stage * S::kStage, conv, c.nr, tq, a0hi, a0lo, cs0);
    bar_arrive(&empty[stage]);  // the stage is read (every consumer thread)
    if (++stage == S::kStages) {
      stage = 0;
      phase ^= 1;
    }
    h16::proxy_fence();  // the conversion's stores, visible to the products
    consumers_sync();
  }
  unsigned char* conv1 = conv + 2 * S::kT;
  for (long long u = first; u < last; u += 2) {
    wgrad_unit<BN>(c, p, u + 1 < last, a0hi, a0lo, cs0, a1hi, a1lo, cs1, conv, conv1, smem,
                   full, empty, stage, phase, k_tiles);
    if (u + 1 < last)
      wgrad_unit<BN>(c, p, u + 2 < last, a1hi, a1lo, cs1, a0hi, a0lo, cs0, conv1, conv, smem,
                     full, empty, stage, phase, k_tiles);
  }
}

// The block that takes unit u of `units` split evenly over `blocks`
__device__ __forceinline__ long long block_of(long long u, long long units, int blocks) {
  return ((u + 1) * blocks + units - 1) / units - 1;
}

// dW (n, k) and db (n) from wgrad_kernel's partials: each entry the sum of
// its tile's slots c + t over the blocks c that took part of tile t, in
// block order
__global__ void wgrad_reduce_kernel(const float* part, const float* part_b, int n, int k, int bn,
                                    long long steps, long long units, int blocks, float* dw,
                                    float* db) {
  const int k_tiles = (k + bn - 1) / bn;
  const long long count = static_cast<long long>(n) * k + (db != nullptr ? n : 0);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool weight = i < static_cast<long long>(n) * k;
    const int row = static_cast<int>(weight ? i / k : i - static_cast<long long>(n) * k);
    const int col = weight ? static_cast<int>(i % k) : 0;
    const long long t = static_cast<long long>(row / kBM) * k_tiles + col / bn;
    const long long c0 = block_of(t * steps, units, blocks);
    const long long c1 = block_of((t + 1) * steps - 1, units, blocks);
    float acc = 0.f;
    for (long long c = c0; c <= c1; ++c)
      acc += weight ? part[((c + t) * kBM + row % kBM) * bn + col % bn]
                    : part_b[(c + t) * kBM + row % kBM];
    (weight ? dw[i] : db[row]) = acc;
  }
}

// W (n, k) split into hi (0) and lo (1): out (2, rows, ld), rows = n and
// columns k, or rows = k and columns n (W^T) when `transpose`; zeros past
// the columns
__global__ void split_kernel(const float* w, int n, int k, int transpose, float* out,
                             int ld) {
  const int rows = transpose ? k : n, cols = transpose ? n : k;
  const long long count = static_cast<long long>(rows) * ld;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(i / ld), c = static_cast<int>(i % ld);
    const float x =
        c < cols ? (transpose ? w[static_cast<long long>(c) * k + r] : w[static_cast<long long>(r) * k + c])
                 : 0.f;
    uint32_t hi, lo;
    tf32::split(x, hi, lo);
    out[i] = __uint_as_float(hi);
    out[count + i] = __uint_as_float(lo);
  }
}

// ------------------------------------------------------------------- host
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has loaded (this
// library links none of its own)
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

constexpr int kErrEncoder = 1000;   // no cuTensorMapEncodeTiled in libcuda
constexpr int kErrMap = 1001;       // libcuda refused a tensor map

// A float32 map over `rank` dims (innermost first; strides in bytes of dims
// 1 ..), box 32 x box_rows (x 1), 128-byte swizzle, zeros past the edges
int make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrEncoder;
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrMap;
}

// a row-major (rows, cols) float32 matrix with row stride ld as a 2-D map
int matrix_map(CUtensorMap* map, const float* base, long long rows, int cols, long long ld,
               int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 4};
  return make_map(map, base, 2, dims, strides, box_rows);
}

bool tma_ok(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 4 == 0;
}

// the output tile's width: 128, or 64 where that pads the columns less
int pick_bn(int cols) {
  return (cols + 63) / 64 * 64 < (cols + 127) / 128 * 128 ? 64 : 128;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

template <int BN, bool kExactB>
int launch_mm(const CUtensorMap& map_a, const CUtensorMap& map_b, const MmArgs& p, int sms,
              cudaStream_t stream) {
  using S = MmShape<BN, kExactB>;
  cudaError_t err = cudaFuncSetAttribute(mm_kernel<BN, kExactB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  const long long tiles = (p.m + kBM - 1) / kBM * ((p.n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  mm_kernel<BN, kExactB><<<grid, kThreads, S::kSmem, stream>>>(map_a, map_b, p);
  return cudaGetLastError();
}

// The weight gradient's plan for dY (m, n) and X (m, k): its tile width,
// tiles, 32-row steps of M, and blocks (one an SM, at least 8 units each)
struct WgradPlan {
  int bn;
  long long tiles, steps, units;
  int blocks;
};

WgradPlan wgrad_plan(long long m, int n, int k, int sms) {
  WgradPlan q;
  q.bn = pick_bn(k);
  q.tiles = (n + kBM - 1LL) / kBM * ((k + q.bn - 1LL) / q.bn);
  q.steps = (m + kBK - 1) / kBK;
  q.units = q.tiles * q.steps;
  const long long blocks = q.units / 8 < sms ? q.units / 8 : sms;
  q.blocks = static_cast<int>(blocks < 1 ? 1 : blocks);
  return q;
}

template <int BN>
int launch_wgrad(const CUtensorMap& map_dy, const CUtensorMap& map_x, const WgradArgs& p,
                 int blocks, cudaStream_t stream) {
  using S = WgradShape<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  wgrad_kernel<BN><<<blocks, kThreads, S::kSmem, stream>>>(map_dy, map_x, p);
  return cudaGetLastError();
}

}  // namespace

// The hi and lo halves of W (n, k) as the products read them: out (2, rows,
// ld) with rows = n (the forward's W) or k (transpose: the input gradient's
// W^T), ld >= the columns and a multiple of 4.
extern "C" int linear_tf32x3_split(const void* w, int n, int k, int transpose, void* out,
                                   int ld, void* stream) {
  const int cols = transpose ? n : k;
  if (n <= 0 || k <= 0 || ld < cols || ld % 4 != 0) return cudaErrorInvalidValue;
  const long long count = static_cast<long long>(transpose ? k : n) * ld;
  const long long blocks = (count + 255) / 256;
  split_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(w), n, k,
                                                      transpose, static_cast<float*>(out), ld);
  return cudaGetLastError();
}

// C (m, n) = A (m, k) B^T (+ bias), B given as linear_tf32x3_split's (2, n,
// ldb): the forward (A = X, B = W) and the input gradient (A = dY, n = K,
// B = W^T).  A's rows have stride lda; C is contiguous.  b_exact: B is exact
// in TF32 (its lo half zero), and the products with its lo half are left
// out (ops/linear.py sets it for a bf16 or fp16 weight, exact by its type).
extern "C" int linear_tf32x3_mm(const void* a, long long m, int k, long long lda,
                                const void* bsplit, int n, int ldb, const void* bias, void* c,
                                int b_exact, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || lda < k || ldb < k || ldb % 4 != 0 ||
      m > (1LL << 31) - kBM || reinterpret_cast<uintptr_t>(bsplit) % 16 != 0)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  MmArgs p{m, n, k, static_cast<const float*>(a), lda, tma_ok(a, lda) ? 1 : 0,
           static_cast<const float*>(bias), static_cast<float*>(c),
           n % 2 == 0 && reinterpret_cast<uintptr_t>(c) % 8 == 0 ? 1 : 0};
  CUtensorMap map_a{}, map_b{};
  int err = p.a_tma ? matrix_map(&map_a, p.a, m, k, lda, kBM) : 0;
  const int bn = pick_bn(n);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(ldb), static_cast<cuuint64_t>(n), 2};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(ldb) * 4,
                                 static_cast<cuuint64_t>(ldb) * 4 * n};
  if (err == 0) err = make_map(&map_b, bsplit, 3, dims, strides, bn);
  if (err != 0) return err;
  auto s = static_cast<cudaStream_t>(stream);
  if (bn == 128)
    return b_exact ? launch_mm<128, true>(map_a, map_b, p, sms, s)
                   : launch_mm<128, false>(map_a, map_b, p, sms, s);
  return b_exact ? launch_mm<64, true>(map_a, map_b, p, sms, s)
                 : launch_mm<64, false>(map_a, map_b, p, sms, s);
}

// Floats of scratch linear_tf32x3_wgrad takes for dY (m, n), X (m, k) and a
// bias or none: the blocks' partial tiles (and column sums), a slot for
// each block and for each tile.
extern "C" long long linear_tf32x3_wgrad_scratch(long long m, int n, int k, int bias) {
  if (m <= 0 || n <= 0 || k <= 0) return 0;
  const int sms = sm_count();
  if (sms <= 0) return 0;
  const WgradPlan q = wgrad_plan(m, n, k, sms);
  return (q.tiles + q.blocks) * kBM * (q.bn + (bias ? 1 : 0));
}

// dW (n, k) = dY^T X and, when db is not null, db (n) = the column sums of
// dY; dY (m, n) and X (m, k) with row strides ldy, ldx; `scratch` holds
// linear_tf32x3_wgrad_scratch's floats.  dW and db repeat bit for bit.
extern "C" int linear_tf32x3_wgrad(const void* dy, long long ldy, const void* x, long long ldx,
                                   long long m, int n, int k, void* dw, void* db, void* scratch,
                                   void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || ldy < n || ldx < k || m > (1LL << 31) - kBK ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const WgradPlan q = wgrad_plan(m, n, k, sms);
  float* part = static_cast<float*>(scratch);
  WgradArgs p{m, n, k,
              static_cast<const float*>(dy), ldy, tma_ok(dy, ldy) ? 1 : 0,
              static_cast<const float*>(x), ldx, tma_ok(x, ldx) ? 1 : 0,
              part, db == nullptr ? nullptr : part + (q.tiles + q.blocks) * kBM * q.bn,
              q.steps, q.units};
  CUtensorMap map_dy{}, map_x{};
  int err = p.dy_tma ? matrix_map(&map_dy, p.dy, m, n, ldy, 32) : 0;
  if (err == 0 && p.x_tma) err = matrix_map(&map_x, p.x, m, k, ldx, 32);
  if (err != 0) return err;
  auto s = static_cast<cudaStream_t>(stream);
  err = q.bn == 128 ? launch_wgrad<128>(map_dy, map_x, p, q.blocks, s)
                    : launch_wgrad<64>(map_dy, map_x, p, q.blocks, s);
  if (err != 0) return err;
  const long long count = static_cast<long long>(n) * k + (db == nullptr ? 0 : n);
  const long long blocks = (count + 255) / 256;
  wgrad_reduce_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      part, p.part_b, n, k, q.bn, q.steps, q.units, q.blocks, static_cast<float*>(dw),
      static_cast<float*>(db));
  return cudaGetLastError();
}

extern "C" const char* linear_tf32x3_error_string(int err) {
  if (err == kErrEncoder) return "libcuda has no cuTensorMapEncodeTiled";
  if (err == kErrMap) return "libcuda refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
