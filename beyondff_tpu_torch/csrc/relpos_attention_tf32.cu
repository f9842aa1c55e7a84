// Attention with SAM's decomposed relative-position bias in f32 for Hopper
// (sm_90a): 3xTF32 on wgmma, warp-specialised. Two kernels:
//
// * flash_relpos_tf32_kernel replaces, for float32 inputs, the TPU kernel
//   beyondff_tpu/kernels/flash_attention.py flash_attention_relpos (:193,
//   pallas_call :214, body _relpos_kernel :128, wrapper attend_relpos :253):
//   softmax(Q K^T * scale + bias) V over a raster-ordered (kh, kw) key grid
//   with an online max and denominator, the output divided once. SAM
//   ViT-H's global blocks in detector.dtype float32 under
//   BFF_SAM_RELPOS_FLASH=1: (16 B, 4096, 80), and (16 B, 3072, 80) on the
//   rect 48 x 64 grid; and at head dim 64, the shape of SAM ViT-L's (16 B,
//   4096, 64) and ViT-B's (12 B, 4096, 64) global blocks, which the public
//   entry takes and no configured model calls.
// * window_relpos_tf32_kernel replaces, for float32 inputs, the TPU kernel
//   beyondff_tpu/kernels/window_attention.py window_attention_relpos (:51,
//   pallas_call :110): the same function over G independent 14 x 14 windows
//   (S = 196). SAM ViT-H's windowed blocks: (25 * 16 B, 196, 80).
//
// bias[q, k] = bias_h[q, k / kw] + bias_w[q, k % kw], the factors in f32,
// added in f32. bff_flash_attention_relpos and bff_window_attention_relpos
// (csrc/relpos_attention.cu) route here exactly the calls that
// bff_relpos_tf32_takes accepts (kernels/flash_attention.py
// relpos_tf32_route mirrors it): f32, kMinGridH <= kh <= 64 with kw = 64,
// or kw a multiple of 8 from kMinGridW = 8 to 56 (the narrow mode below), at
// D 64 or 80 (K4), or a 14 x 14 window at D 80 (K5), a positive finite
// scale, and q, k, v, o and both factors 16-byte aligned. Every other f32
// call keeps the FMA kernels of csrc/relpos_attention.cu. The line lies
// below every grid K4 takes: at one grid row (16 heads, S = 64) this kernel took 0.0101 ms
// against the FMA kernel's 0.0211, at 2, 4 and 8 rows 2.5-3.5x less
// (tools/kernel_variants.py --cases "relpos_f32 small"), so kMinGridH is 1.
//
// Precision. As in csrc/flash_attention_tf32.cu: each f32 operand x is split
// into TF32 words hi = rna(x), lo = rna(x - hi) (cvt.rna.tf32.f32) and each
// product is summed as lo hi + hi lo + hi hi in f32 accumulators, about 22
// bits of each operand; one TF32 product would miss the 1e-4 the f32 calls
// are held to. Q is multiplied by the scale before it is split, so the
// scores come out in natural units and the bias is their accumulator's
// initial value: the wgmma chain of Q K^T starts from bias_w (K4) or the
// whole bias (K5), never from zero. The tensor cores' f32 sums lose more
// than the FMA units' round-to-nearest adds: with P V accumulated in the
// wgmma registers across all 64 key tiles of a row (1 536 products), K4 at
// (64, 4096, 80) lay 8.0e-5 from its plain version, against 9.3e-6 for
// the FMA kernel. So each tile's P V is a fresh wgmma sum (kFold), added
// to the output rows by the FMA units: 5.7e-6, for 3-5% of the time and 40
// registers.
//
// Bound on an H100 SXM (3xTF32: 495 / 3 = 165 TFLOP/s of f32-grade work;
// 3.35 TB/s): K4 at (64, 4096, 80) does 4 * 64 * 4096^2 * 80 = 3.44e11
// operations (2.082 ms) and moves q, k, v, o (84 MB each) and both factors
// (67 MB each), 470 MB (0.140 ms): bound by operations. K5 at (1600, 196,
// 80) moves 4 * 1600 * 196 * 80 * 4 + 2 * 1600 * 196 * 14 * 4 bytes = 436 MB
// (0.130 ms) against 4 * 1600 * 196^2 * 80 = 1.97e10 operations (0.119 ms):
// nearly balanced, bytes ahead.
//
// Shared-memory layout (both kernels). TF32 wgmma reads shared-memory
// operands K-major only (no transpose bit) and a k8 step is 32 bytes of a
// row, so every operand is stored as "images" of 32-byte rows in the 32-byte
// swizzle (the 16-byte half c of row r at half c ^ ((r / 4) % 2)): Q and K
// (rows x 80) as 10 regions of rows x 32 bytes, region kk holding columns 8
// kk .. 8 kk + 7, read by k-step kk of Q K^T; V^T (80 x keys) as one region
// of 80 x 32 bytes per 8-key group, read by k-step kk of P V with N = 80
// (wgmma.m64n80k8). A row of 80 floats is 320 bytes, which no single
// 128-byte swizzle box covers; the 32-byte swizzle covers it in ten uniform
// regions. Each 8-key group of V^T stores its keys in the order 0 2 4 6 1 3
// 5 7 (kernels/flash_attention.py TF32_KEY_ORDER), so P's accumulator
// registers are its A fragments as they stand (csrc/flash_attention_tf32.cu
// explains the permutation).
//
// Where a lane's values lie (kernels/flash_attention.py relpos_tf32_fragment
// mirrors this, and the CPU tests hold it to relpos_bias): score register 4
// j + e of lane l in warp w of a consumer warpgroup holds row 16 w + l / 4 +
// 8 (e / 2) and column 8 j + 2 (l % 4) + e % 2 of the m64nN tile.
//
// K4 design (grid (ceil(S / 128), BH), one block of three warpgroups a SM):
// * A pre-pass (split_kv_relpos_kernel, one block a 64-key tile of a head)
//   writes each tile's K hi, K lo, V^T hi and V^T lo images, ready to copy,
//   into scratch the wrapper allocates (4 BH S 80 floats; S = 64 kh is whole
//   tiles). It reads k and v once (168 MB at (64, 4096, 80)) and writes them
//   twice (336 MB).
// * Warpgroup 2 is the producer: one thread copies each tile's K images
//   (40 KB) and V^T images (40 KB) with one bulk copy each into a single
//   K stage and a single V stage, with a full and an empty mbarrier each.
// * Warpgroups 0 and 1 are the consumers, 64 query rows each: Q scaled,
//   split once into its images in shared memory (80 KB for both); S = Q K^T
//   by 30 wgmma.m64n64k8 from shared memory, P V by 24 wgmma.m64n80k8 with
//   P split in registers. Tile t's Q K^T is issued after tile t - 1's P V
//   has finished, and the consumers take turns to issue Q K^T (pingpong).
//   Issuing it before (kOverlap, csrc/flash_attention_tf32.cu's order)
//   keeps scores, P's halves and the output live at once and spills: 4.76
//   against 3.30 ms at (64, 4096, 80).
// * With kw = 64 a 64-key tile is one grid row: bias_w[q, kx] is the same
//   for every tile. The block's 128 rows of it sit in a shared-memory table
//   (row stride 72 floats: a warp's 8-byte reads fall in distinct banks),
//   from which each tile's score accumulators are initialised; bias_h[q, t]
//   stays out of the scores and shifts the row's max and exponent once a
//   tile, read from device memory (L1).
// * Shared memory: Q images 80 KB, one K and one V stage 80 KB, the bias_w
//   table 36 KB: 197 KB. Two stages (another 80 KB) do not fit beside the
//   table. ptxas holds the 384-thread block to 168 registers: scores 32,
//   the output 40, P's halves 64 and, with kFold, the tile's P V 40; 72
//   bytes spill (155 registers and none without kFold).
// * Rows past S (an odd kh) are computed on zero Q and not written.
// * Grids narrower than 64 (the narrow mode, flash_relpos_tf32_kernel<D,
//   true>: SAM's portrait frames under BFF_SAM_RECT=1, 64 x 32 for a 2:1
//   frame). A 64-key tile then spans 64 / kw grid rows or, where kw does
//   not divide 64, parts of two or more, so neither factor is the same for
//   every tile. The tiles stay 64 keys (the wgmma shapes, stages, pingpong
//   and fold of the wide mode, at full tensor-core width whatever kw is);
//   what changes is where the bias comes from. With kw a multiple of 8 an
//   n8 group of keys lies in one grid row, so the wide mode's split holds
//   a group at a time: each score's accumulator starts at bias_w[q, k % kw]
//   (an 8-byte pair a lane from the block's table: kw columns at a row
//   stride of kw or kw + 8, whichever is 8 mod 16 in 8-byte words, no bank
//   conflicts), and bias_h[q, k / kw] shifts the group's logits in log2
//   units in the softmax (16 shifts a lane a tile, read from device
//   memory, L1); the group's grid row and column advance by 8 keys a group
//   and 64 a tile without a division. The pre-pass pads the last tile (S =
//   kh kw need not be a multiple of 64) with zero keys, which start at
//   -inf. Two designs lost (tools/kernel_variants.py on an H100 at 700 W):
//   the whole bias as the accumulators' start, as K5 does, lay 1.07e-4
//   from plain at factor scale 3 (the tensor cores' sums carry twice a
//   factor's magnitude through every k-step); the whole bias added in f32
//   once the products are in held 1e-4 but its reads sit between the
//   scores and the softmax, 6-19% slower. The
//   other way, tiles of one grid row (N = kw), keeps the wide mode's row
//   shift but runs the tensor cores at n16..n56 with the per-tile softmax
//   and barrier costs of a 64-key tile.
// * Head dim 64 (K4Cfg<64>): images of 16 KB a 64-key tile, 8 regions a
//   row. Q 64 KB, two K stages and one V stage 96 KB and the table 36 KB:
//   196 KB. Two V stages as well fit only with the table at 64 floats a
//   row (its 8-column groups swizzled against bank conflicts) and were
//   1.4% slower at (64, 4096, 64) than one; one K stage 3.3% slower
//   (tools/kernel_variants.py). The consumers hold the output 32, scores
//   32, P's halves 64 and the fold's 32 registers: no spill.
//
// K5 design (a persistent grid of one block a SM, each walking items g * 2
// + round, the 128 query rows 128 round .. of window g):
// * No pre-pass: the producer warpgroup's 128 threads read each 40-key tile
//   of the window's K and V from device memory, split them and write their
//   images (keys >= 196 as zero) into a ring of two stages (50 KB each),
//   then fence.proxy.async and arrive on the stage's full barrier. A global
//   pre-pass would move 600 MB more than the kernel's 436 MB. The split is
//   done once per round, twice a window: the window's split K and V^T (256
//   KB) do not fit beside the queries' images. Reading tile u + 1 before
//   writing tile u (kWPrefetch) holds both tiles in registers and spills
//   more: 0.481 against 0.471 ms at (1600, 196, 80).
// * Each consumer reads its 64 rows of Q (all its loads issued before the
//   first split), scales and splits them, and copies its rows of the two
//   factor tables (196 x 14 each) into shared memory, once a round. Five
//   40-key tiles (keys 0..199, 196..199 masked by -inf in the
//   accumulator's initial value) with the same online softmax and pingpong
//   as K4, each tile's products in turn (the overlap spills: 0.520 against
//   0.471 ms); the initial value of each score is bias_h[q, k / 14] +
//   bias_w[q, k % 14] from the tables (a lane's key pair shares one grid
//   row: one bias_h read and one 8-byte bias_w read).
// * The 196 rows are 256 in four m-tiles (the last holds 4), the 196 keys
//   200: 1.33 times the window's operations reach the tensor cores.
//
// Measured on an H100 SXM at 700 W (tools/kernel_variants.py --cases
// relpos_f32, device time, one process): K4 at (64, 4096, 80) 3.30 ms (63%
// of the bound, the pre-pass 0.173 of it) against 20.75 ms for the FMA
// kernel and 13.35 ms for scaled_dot_product_attention in f32 with the
// bias as a float mask; K5 at (1600, 196, 80) 0.471 ms (28% of its byte
// bound) against 1.93 and 1.57 ms; K4 at (64, 4096, 64) 2.60 ms (64% of
// its 1.666 ms bound) against 13.86 and 8.24 ms. The narrow mode at (64,
// 2048, 64) on a 64 x 32 grid 0.909 ms (46% of its 0.4165 ms bound)
// against 4.46 ms for the FMA kernel and 2.63 ms for SDPA in f32 with the
// bias as a float mask; (64, 3072, 64) on 64 x 48 1.95 against 9.93 and
// 5.76; at head dim 80 1.18 and 2.52 against 5.31 / 11.71 and 3.39 / 7.60
// (D 80 spills 88 bytes; starting the scores at the whole bias, 16
// registers fewer, took 1.02 and 2.18 but missed 1e-4).
// At one tile (16 heads of a 1 x 8 grid) 0.0081 against the FMA kernel's
// 0.0119, so kMinGridW is 8, the narrowest width the groups allow.
//
// Host: a failed launch returns non-zero and the wrapper raises: nothing
// falls back to another kernel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>

#include "attention_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace bff_wg;

constexpr int kD = 80;                // SAM ViT-H's head dim (K5's; K4 also takes 64)
constexpr int kConsumers = 2;         // consumer warpgroups of 64 query rows each
constexpr int kBM = 64 * kConsumers;  // query rows of a block (of a K5 round)
constexpr int kThreads = 128 * (kConsumers + 1);  // the producer is the last warpgroup
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr bool kPingpong = true;      // the consumers take turns to issue their products
constexpr bool kFold = true;          // each tile's P V summed apart, then added in f32
constexpr float kL2e = bff_tc::kLog2e;

// K4
constexpr int kGridW = 64;            // the key grid's width (kw) K4 takes
constexpr int kMaxGridH = 64;         // and its largest height (kh)
constexpr int kMinGridH = 1;          // and its smallest
constexpr int kBN = 64;               // keys of a K4 tile: one grid row
constexpr bool kOverlap = false;      // issue Q K^T of tile t before P V of tile t - 1
constexpr int kKStages = 1, kVStages = 1;
constexpr int kBwLd = kGridW + 8;     // the bias_w table's row stride (floats)
constexpr int kMinGridW = 8;          // the narrow mode's smallest kw (a multiple of 8)
// K4 at head dim 64 (K4Cfg): the K and V rings' depths
constexpr int kKStages64 = 2, kVStages64 = 1;
constexpr int kSplitThreads = 256;

// K5
constexpr int kWin = 14;              // the window's side
constexpr int kWinS = kWin * kWin;    // its tokens: 196
constexpr int kWBN = 40;              // keys of a K5 tile
constexpr int kWTiles = 5;            // keys 0..199
constexpr int kWStages = 2;
constexpr int kWRounds = 2;           // 128-row rounds of a window: rows 0..255
constexpr bool kWOverlap = false;     // as kOverlap, for K5
constexpr bool kWPrefetch = false;    // the producer reads tile u + 1 before writing tile u

// The bytes of a K-like image of ``rows`` rows (D / 8 regions of rows x 32
// bytes) and of a V^T image of ``keys`` keys (keys / 8 regions of D x 32):
// both 4 D bytes a row or key.
template <int D = kD>
__host__ __device__ constexpr int img_bytes(int rows) { return rows * D * 4; }

struct Barriers {
  uint64_t k_full[2], k_empty[2], v_full[2], v_empty[2];
};

__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// A K-like image of ``rows`` rows is D / 8 regions x rows x 2 halves of 16
// bytes; chunk i (16 bytes at byte 16 i) is (region i / (2 rows), row (i /
// 2) % rows, stored half i % 2), which holds the columns 8 region + 4 half,
// half = stored half ^ ((row / 4) % 2). Returns that first column; ``row``
// is set.
__device__ __forceinline__ int kimg_chunk(int i, int rows, int& row) {
  const int region = i / (2 * rows);
  row = (i >> 1) % rows;
  return region * 8 + (((i ^ (row >> 2)) & 1) << 2);
}

// A V^T image is keys / 8 regions x D rows x 2 halves; chunk i is (group
// i / 2 D, row d = (i / 2) % D, stored half i % 2) and holds the keys of
// parity e = stored half ^ ((d / 4) % 2) of the group, 8 group + e + 2 u at
// stored position 4 e + u (the order 0 2 4 6 1 3 5 7). Returns the group's
// first key plus e; ``d`` is set.
template <int D = kD>
__device__ __forceinline__ int vimg_chunk(int i, int& d) {
  d = (i >> 1) % D;
  return (i / (2 * D)) * 8 + ((i ^ (d >> 2)) & 1);
}

// ------------------------------------------------------------ wgmma, TF32
#define BFF_T4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define BFF_T8(a, i) BFF_T4(a, i), BFF_T4(a, i + 4)

// d += A B for A 64 x 8 and B 8 x 64 TF32, both from shared memory, K-major.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}

// d += A B for A 64 x 8 and B 8 x 40 TF32, both from shared memory, K-major.
__device__ __forceinline__ void mma_ss(float (&d)[20], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "%20, %21, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T4(d, 16)
      : "l"(da), "l"(db), "r"(1));
}

// d (+)= A B for A 64 x 8 TF32 in registers (a lane holds rows g, g + 8 of
// its warp's 16 and columns t, t + 4: a0 (g, t), a1 (g + 8, t), a2 (g, t +
// 4), a3 (g + 8, t + 4)) and B 8 x 80 (or 8 x 64) TF32 from shared memory,
// K-major.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T8(d, 24), BFF_T8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef BFF_T8
#undef BFF_T4

__device__ __forceinline__ uint64_t desc(uint32_t addr) { return sw32_desc(addr, 16); }

// S += Q K^T for the warpgroup's 64 rows (Q's images at qhi, qlo) and the N
// keys of a tile (K's images at khi, klo), head dim D (D / 8 regions): the
// small terms over every k-step first, then hi hi.
template <int N, int D>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint32_t qhi, uint32_t qlo,
                                             uint32_t khi, uint32_t klo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    mma_ss(s, desc(qlo + kk * 64 * 32), desc(khi + kk * N * 32));
    mma_ss(s, desc(qhi + kk * 64 * 32), desc(klo + kk * N * 32));
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    mma_ss(s, desc(qhi + kk * 64 * 32), desc(khi + kk * N * 32));
}

// O += P V for the KS 8-key groups of a tile (V^T's images at vhi, vlo, a
// region of D x 32 bytes a group); O = P V when ``fresh``.
template <int KS, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&ph)[KS][4],
                                         const uint32_t (&pl)[KS][4], uint32_t vhi,
                                         uint32_t vlo, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    mma_rs(o, pl[kk], desc(vhi + kk * D * 32), kk == 0 && fresh ? 0 : 1);
    mma_rs(o, ph[kk], desc(vlo + kk * D * 32));
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs(o, ph[kk], desc(vhi + kk * D * 32));
}

// The online softmax of one score tile in place. s holds the logits in
// natural units (masked keys at -inf); sh[h][g] shifts row h's logits in
// log2 units: with G = 1 the whole row (K4's wide mode: bias_h of the
// tile's grid row; K5: 0), with G = N / 8 the keys of n8 group g (K4's
// narrow mode: bias_h of the group's grid row). The running max m (log2
// units) is raised, l rescaled and summed, s turned into p; corr: the
// factors the output rows are rescaled by.
template <int N, int G>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const float (&sh)[2][G]) {
  static_assert(G == 1 || G == N / 8, "a shift a row, or a row and n8 group");
  float mx[2] = {bff_tc::masked_score(), bff_tc::masked_score()};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float m0 = fmaxf(s[4 * j], s[4 * j + 1]), m1 = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    mx[0] = fmaxf(mx[0], G == 1 ? m0 : fmaf(m0, kL2e, sh[0][j % G]));
    mx[1] = fmaxf(mx[1], G == 1 ? m1 : fmaf(m1, kL2e, sh[1][j % G]));
  }
  float c[2][G];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], G == 1 ? fmaf(mx[h], kL2e, sh[h][0]) : mx[h]);
    corr[h] = bff_tc::exp2_approx(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
#pragma unroll
    for (int g = 0; g < G; ++g) c[h][g] = sh[h][g] - m[h];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = bff_tc::exp2_approx(fmaf(s[4 * j], kL2e, c[0][j % G]));
    s[4 * j + 1] = bff_tc::exp2_approx(fmaf(s[4 * j + 1], kL2e, c[0][j % G]));
    s[4 * j + 2] = bff_tc::exp2_approx(fmaf(s[4 * j + 2], kL2e, c[1][j % G]));
    s[4 * j + 3] = bff_tc::exp2_approx(fmaf(s[4 * j + 3], kL2e, c[1][j % G]));
    l[0] += s[4 * j] + s[4 * j + 1];
    l[1] += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P split into the A fragments of the k-steps of P V: k-step kk takes the
// accumulator's n8 tile kk, column t of the fragment from key 2 t and
// column t + 4 from key 2 t + 1 (V^T's keys are stored in that order).
template <int KS>
__device__ __forceinline__ void split_p(uint32_t (&ph)[KS][4], uint32_t (&pl)[KS][4],
                                        const float (&s)[4 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    split_tf32(s[4 * kk], ph[kk][0], pl[kk][0]);
    split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
    split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
    split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// The consumers' view of the K and V rings: K stage st's hi image at k_base
// + st * 2 img_bytes(N) and its lo image after it; V^T likewise.
struct Ring {
  Barriers* bars;
  uint32_t k_base, v_base;
};

// One warpgroup's pass over ``n_tiles`` key tiles of N keys against its 64
// query rows (Q's images at qhi, qlo), the tiles being the ring's u0 .. u0
// + n_tiles - 1 (stage u % stages, parity (u / stages) % 2). init(t, s, sh)
// sets tile t's score accumulators to their initial values (the bias, -inf
// for masked keys) and the log2 shifts of the rows (G = 1) or of each row's
// n8 groups (G = N / 8). Leaves the output rows (unnormalised) in acc and
// their denominators, summed over the quad, in l.
// With kFold each tile's P V is a fresh wgmma sum, added to acc by the FMA
// units: the tensor cores' f32 sums then span 3 KS products, not the row's
// every key.
// Every round of issues is one pingpong turn: consumer 1 hands consumer 0
// the first turn before the first pass, consumer 0 takes the surplus one
// after the last.
template <int N, int KStages, int VStages, bool Overlap, int D, int G, typename Init>
__device__ __forceinline__ void attend_rows(float (&acc)[D / 2], float (&l)[2], uint32_t qhi,
                                            uint32_t qlo, const Ring& ring, int u0, int n_tiles,
                                            int wg, Init&& init) {
  constexpr int KS = N / 8;
  constexpr int kImg = img_bytes<D>(N);
  Barriers* bars = ring.bars;
  const bool signals = (threadIdx.x & 31) == 0;  // one arrival per consumer warp
  const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
  auto k_hi = [&](int st) { return ring.k_base + st * 2 * kImg; };
  auto v_hi = [&](int st) { return ring.v_base + st * 2 * kImg; };
  float s[N / 2], pv_sum[D / 2];
  float (&pv)[D / 2] = kFold ? pv_sum : acc;  // what P V's wgmmas accumulate into
  uint32_t ph[KS][4] = {}, pl[KS][4] = {};
  float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, corr[2], sh[2][G];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = pv_sum[i] = 0.f;
  l[0] = l[1] = 0.f;
  auto fold = [&]() {
    if (kFold) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += pv_sum[i];
    }
  };
  auto fence_for_issue = [&]() {
    fence_regs(acc);
    if (kFold) fence_regs(pv_sum);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(s);
    wgmma_fence();
  };
  auto turn = [&]() {
    if (kPingpong) turn_sync(my_turn);
  };
  auto hand_on = [&]() {
    if (kPingpong) turn_arrive(next_turn);
  };

  // tile 0: scores, softmax, P
  {
    const int st = u0 % KStages, parity = (u0 / KStages) & 1;
    init(0, s, sh);
    bar_wait_or_trap(&bars->k_full[st], parity);
    turn();
    fence_for_issue();
    issue_scores<N, D>(s, qhi, qlo, k_hi(st), k_hi(st) + kImg);
    wgmma_commit();
    hand_on();
    wgmma_wait<0>();
    fence_regs(s);
    if (signals) bar_arrive(&bars->k_empty[st]);
    softmax_tile<N, G>(s, m, l, corr, sh);
    split_p<KS>(ph, pl, s);
  }
  for (int t = 1; t < n_tiles; ++t) {
    const int u = u0 + t;
    const int st = u % KStages, parity = (u / KStages) & 1;
    const int pst = (u - 1) % VStages, pparity = ((u - 1) / VStages) & 1;
    if constexpr (Overlap) {
      init(t, s, sh);
      bar_wait_or_trap(&bars->k_full[st], parity);
      bar_wait_or_trap(&bars->v_full[pst], pparity);
      turn();
      fence_for_issue();
      issue_scores<N, D>(s, qhi, qlo, k_hi(st), k_hi(st) + kImg);
      wgmma_commit();
      issue_pv<KS, D>(pv, ph, pl, v_hi(pst), v_hi(pst) + kImg, kFold);
      wgmma_commit();
      hand_on();
      wgmma_wait<1>();  // the scores are in
      fence_regs(s);
      if (signals) bar_arrive(&bars->k_empty[st]);
      softmax_tile<N, G>(s, m, l, corr, sh);
      wgmma_wait<0>();  // P V of tile t - 1 is in
      fence_regs(pv);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(s);
      if (signals) bar_arrive(&bars->v_empty[pst]);
    } else {
      bar_wait_or_trap(&bars->v_full[pst], pparity);
      fence_for_issue();
      issue_pv<KS, D>(pv, ph, pl, v_hi(pst), v_hi(pst) + kImg, kFold);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(ph);
      fence_regs(pl);
      if (signals) bar_arrive(&bars->v_empty[pst]);
      init(t, s, sh);
      bar_wait_or_trap(&bars->k_full[st], parity);
      turn();
      fence_for_issue();
      issue_scores<N, D>(s, qhi, qlo, k_hi(st), k_hi(st) + kImg);
      wgmma_commit();
      hand_on();
      wgmma_wait<0>();
      fence_regs(s);
      if (signals) bar_arrive(&bars->k_empty[st]);
      softmax_tile<N, G>(s, m, l, corr, sh);
    }
    fold();
    rescale<D>(acc, corr);
    split_p<KS>(ph, pl, s);
  }
  // P V of the last tile (its own turn when the products overlap)
  const int lu = u0 + n_tiles - 1;
  const int lst = lu % VStages, lparity = (lu / VStages) & 1;
  bar_wait_or_trap(&bars->v_full[lst], lparity);
  if (Overlap) turn();
  fence_for_issue();
  issue_pv<KS, D>(pv, ph, pl, v_hi(lst), v_hi(lst) + kImg, kFold);
  wgmma_commit();
  if (Overlap) hand_on();
  wgmma_wait<0>();
  fence_regs(pv);
  if (signals) bar_arrive(&bars->v_empty[lst]);
  fold();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// A consumer warp's two rows (row0 and row0 + 8, each written when its flag
// is set), divided by their denominators.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], const float (&l)[2],
                                           float* __restrict__ row0, bool live0, bool live1) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 0 ? live0 : live1) {
      float* orow = row0 + 8 * h * D + 2 * tq;
      const float inv = 1.f / l[h];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
    }
  }
}

// A warpgroup's 64 rows of a (rows, D) f32 matrix, multiplied by ``scale``,
// split and written as its hi and lo images (rows >= n_rows as zero; row r
// read from src + r * D), then made visible to wgmma and to the warpgroup.
template <int D>
__device__ __forceinline__ void stage_q(unsigned char* img_hi, unsigned char* img_lo,
                                        const float* __restrict__ src, int n_rows, float scale,
                                        int wg) {
  constexpr int kPer = 2 * (D / 8) * 64 / 128;  // D / 8 chunks a thread, all read first
  const int wt = threadIdx.x & 127;
  float4 x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    int r;
    const int c = kimg_chunk(wt + 128 * j, 64, r);
    x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) x[j] = __ldg(reinterpret_cast<const float4*>(src + r * D + c));
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = wt + 128 * j;
    uint4 hi, lo;
    split4(make_float4(x[j].x * scale, x[j].y * scale, x[j].z * scale, x[j].w * scale), hi,
           lo);
    *reinterpret_cast<uint4*>(img_hi + 16 * i) = hi;
    *reinterpret_cast<uint4*>(img_lo + 16 * i) = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}

// ------------------------------------------------------------------ K4
// K4 at head dim D (80: SAM ViT-H; 64: SAM ViT-L and ViT-B). Shared memory
// of a block (from a 1024-byte boundary): each consumer's Q hi and lo
// images, the K stages, the V stages, the bias_w table, the barriers. At D
// 80 one K and one V stage fit beside the table; at D 64 (an image 16 KB)
// two K stages and one V stage do.
template <int D>
struct K4Cfg {
  static constexpr int kKStages = D == 64 ? kKStages64 : ::kKStages;
  static constexpr int kVStages = D == 64 ? kVStages64 : ::kVStages;
  static constexpr int kImg = img_bytes<D>(kBN);  // 20 KB at D 80, 16 KB at D 64
  static constexpr int kQOff = 0;
  static constexpr int kKOff = kQOff + 2 * kConsumers * kImg;
  static constexpr int kVOff = kKOff + 2 * kKStages * kImg;
  static constexpr int kBwOff = kVOff + 2 * kVStages * kImg;
  static constexpr int kBarOff = kBwOff + kBM * kBwLd * 4;
  static constexpr int kSmemBytes = kBarOff + (int)sizeof(Barriers) + 1024;
  static_assert(kSmemBytes <= 232448, "K4's shared memory");
  static_assert(kKStages <= 2 && kVStages <= 2, "the barriers' stages");
};
constexpr int kImg64 = img_bytes(kBN);  // a 64-row image at head dim 80, 20 KB

// Each 64-key tile of a head as four images (K hi, K lo, V^T hi, V^T lo):
// tile t of head bh at scratch + (bh * n_tiles + t) * 4 * img_bytes<D>(64).
// One block a tile. kRagged (the narrow mode): keys >= S of the last tile as
// zero.
template <int D, bool kRagged>
__global__ void __launch_bounds__(kSplitThreads) split_kv_relpos_kernel(
    const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ scratch,
    int S) {
  constexpr int kImg = K4Cfg<D>::kImg;
  __shared__ float tk[kBN][D + 1], tv[kBN][D + 1];
  const int t = blockIdx.x, bh = blockIdx.y, n_tiles = gridDim.x;
  const long long in = ((long long)bh * S + (long long)t * kBN) * D;
  for (int i = threadIdx.x; i < kBN * D; i += kSplitThreads) {
    const int r = i / D, c = i - r * D;
    const bool live = !kRagged || t * kBN + r < S;
    tk[r][c] = live ? k[in + i] : 0.f;
    tv[r][c] = live ? v[in + i] : 0.f;
  }
  __syncthreads();
  unsigned char* img =
      reinterpret_cast<unsigned char*>(scratch + ((long long)bh * n_tiles + t) * 4 * (kImg / 4));
  for (int i = threadIdx.x; i < 2 * (D / 8) * kBN; i += kSplitThreads) {
    int r;
    const int c = kimg_chunk(i, kBN, r);
    uint4 hi, lo;
    split4(make_float4(tk[r][c], tk[r][c + 1], tk[r][c + 2], tk[r][c + 3]), hi, lo);
    *reinterpret_cast<uint4*>(img + 16 * i) = hi;
    *reinterpret_cast<uint4*>(img + kImg + 16 * i) = lo;
  }
  for (int i = threadIdx.x; i < 2 * D * (kBN / 8); i += kSplitThreads) {
    int d;
    const int key = vimg_chunk<D>(i, d);
    uint4 hi, lo;
    split4(make_float4(tv[key][d], tv[key + 2][d], tv[key + 4][d], tv[key + 6][d]), hi, lo);
    *reinterpret_cast<uint4*>(img + 2 * kImg + 16 * i) = hi;
    *reinterpret_cast<uint4*>(img + 3 * kImg + 16 * i) = lo;
  }
}

// The bias_w table's row stride in the narrow mode: kw or kw + 8 floats,
// whichever is 8 mod 16 (a quad's 8-byte reads of 8 rows in distinct banks).
__host__ __device__ constexpr int narrow_ld(int kw) { return kw % 16 == 0 ? kw + 8 : kw; }

// kNarrow: a grid of kw < 64 columns (the narrow mode); otherwise kw = 64
// and kh = S / 64 tiles of one grid row each.
template <int D, bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1) flash_relpos_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ scratch,
    const float* __restrict__ bias_h, const float* __restrict__ bias_w, float* __restrict__ o,
    int S, int kh, int kw, float scale) {
  using C = K4Cfg<D>;
  constexpr int kImg = C::kImg;
  extern __shared__ __align__(1024) unsigned char rt_smem_raw[];
  unsigned char* smem = rt_smem_raw + ((1024 - (smem_u32(rt_smem_raw) & 1023)) & 1023);
  float* sBw = reinterpret_cast<float*>(smem + C::kBwOff);
  Barriers* bars = reinterpret_cast<Barriers*>(smem + C::kBarOff);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int cols = kNarrow ? kw : kGridW;          // bias_w's columns
  const int ld = kNarrow ? narrow_ld(kw) : kBwLd;  // the table's row stride
  const int n_tiles = kNarrow ? (S + kBN - 1) / kBN : kh;

  // the block's rows of bias_w (zero past S)
  const float* bwg = bias_w + (long long)bh * S * cols;
  for (int i = threadIdx.x; i < kBM * cols / 4; i += kThreads) {
    const int r = i / (cols / 4), c = 4 * (i % (cols / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < S)
      x = __ldg(reinterpret_cast<const float4*>(bwg + (long long)(q0 + r) * cols + c));
    *reinterpret_cast<float4*>(sBw + r * ld + c) = x;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      bar_init(&bars->k_full[st], 1);
      bar_init(&bars->v_full[st], 1);
      bar_init(&bars->k_empty[st], kConsumerWarps);
      bar_init(&bars->v_empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const long long tile_bytes = 4LL * kImg;
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    if (threadIdx.x == 128 * kConsumers) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(scratch) + (long long)bh * n_tiles * tile_bytes;
      for (int t = 0; t < n_tiles; ++t) {
        const int kst = t % C::kKStages, kparity = ((t / C::kKStages) & 1) ^ 1;
        const int vst = t % C::kVStages, vparity = ((t / C::kVStages) & 1) ^ 1;
        bar_wait_or_trap(&bars->k_empty[kst], kparity);
        bar_expect_tx(&bars->k_full[kst], 2 * kImg);
        bulk_load(smem + C::kKOff + kst * 2 * kImg, src + t * tile_bytes, 2 * kImg,
                  &bars->k_full[kst]);
        bar_wait_or_trap(&bars->v_empty[vst], vparity);
        bar_expect_tx(&bars->v_full[vst], 2 * kImg);
        bulk_load(smem + C::kVOff + vst * 2 * kImg, src + t * tile_bytes + 2 * kImg, 2 * kImg,
                  &bars->v_full[vst]);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int lane = threadIdx.x & 31, tq = lane & 3;
    const int rb = wg * 64 + ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // and rb + 8
    unsigned char* q_hi = smem + C::kQOff + 2 * wg * kImg;
    unsigned char* q_lo = q_hi + kImg;
    stage_q<D>(q_hi, q_lo, q + ((long long)bh * S + q0 + wg * 64) * D, S - q0 - wg * 64, scale,
               wg);
    if (kPingpong && wg == kConsumers - 1) turn_arrive(1 + (wg + 1) % kConsumers);

    const float* bw_row[2] = {sBw + rb * ld + 2 * tq, sBw + (rb + 8) * ld + 2 * tq};
    const float* bh_row[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bh_row[h] = q0 + rb + 8 * h < S ? bias_h + ((long long)bh * S + q0 + rb + 8 * h) * kh
                                      : nullptr;
    // tile t: the accumulators start at bias_w (the same for every tile),
    // the rows shift by bias_h[q, t] in log2 units
    auto init_wide = [&](int t, float (&s)[kBN / 2], float (&sh)[2][1]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sh[h][0] = bh_row[h] != nullptr ? __ldg(bh_row[h] + t) * kL2e : 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(bw_row[h] + 8 * j);
          s[4 * j + 2 * h] = w.x;
          s[4 * j + 2 * h + 1] = w.y;
        }
      }
    };
    // the narrow mode's tile t: the accumulators start at bias_w[q, kx]
    // (keys >= S at -inf), and each n8 group's keys shift by bias_h[q, ky]
    // in log2 units. n8 group j holds keys 64 t + 8 j .. + 7, one grid row
    // (kw % 8 == 0): (ky, kx) of the group's first key, advanced by 8 keys
    // a group and set once a tile
    auto init_narrow = [&](int t, float (&s)[kBN / 2], float (&sh)[2][kBN / 8]) {
      int ky = t * kBN / kw, kx = t * kBN - ky * kw;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const bool in = t * kBN + 8 * j < S;  // S is a multiple of 8: the whole group
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sh[h][j] = in && bh_row[h] != nullptr ? __ldg(bh_row[h] + ky) * kL2e : 0.f;
          const float2 w = *reinterpret_cast<const float2*>(bw_row[h] + kx);
          s[4 * j + 2 * h] = in ? w.x : bff_tc::masked_score();
          s[4 * j + 2 * h + 1] = in ? w.y : bff_tc::masked_score();
        }
        kx += 8;
        if (kx >= kw) {
          kx -= kw;
          ++ky;
        }
      }
    };
    const Ring ring{bars, smem_u32(smem + C::kKOff), smem_u32(smem + C::kVOff)};
    float acc[D / 2], l[2];
    if constexpr (kNarrow)
      attend_rows<kBN, C::kKStages, C::kVStages, kOverlap, D, kBN / 8>(
          acc, l, smem_u32(q_hi), smem_u32(q_lo), ring, 0, n_tiles, wg, init_narrow);
    else
      attend_rows<kBN, C::kKStages, C::kVStages, kOverlap, D, 1>(
          acc, l, smem_u32(q_hi), smem_u32(q_lo), ring, 0, kh, wg, init_wide);
    if (kPingpong && wg == 0) turn_sync(1);  // the last consumer's last turn
    const int row = q0 + rb;
    store_rows<D>(acc, l, o + ((long long)bh * S + row) * D, row < S, row + 8 < S);
  }
}

template <int D, bool kNarrow>
int launch_k4(const void* q, const void* k, const void* v, const void* bias_h,
              const void* bias_w, void* o, void* scratch, int BH, int S, int kh, int kw,
              float scale, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_relpos_tf32_kernel<D, kNarrow>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        K4Cfg<D>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_tiles = (S + kBN - 1) / kBN;  // kh at kw = 64
  split_kv_relpos_kernel<D, kNarrow><<<dim3(n_tiles, BH), kSplitThreads, 0, s>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<float*>(scratch),
      S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_relpos_tf32_kernel<D, kNarrow><<<dim3((S + kBM - 1) / kBM, BH), kThreads,
                                         K4Cfg<D>::kSmemBytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(scratch),
      static_cast<const float*>(bias_h), static_cast<const float*>(bias_w),
      static_cast<float*>(o), S, kh, kw, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K5
// Shared memory of a K5 block: per consumer its Q hi and lo images and its
// rows of the two factor tables; then the stages (K hi, K lo, V^T hi, V^T
// lo of a 40-key tile each); the barriers.
constexpr int kImg40 = img_bytes(kWBN);            // 12 800 bytes
constexpr int kWTable = 64 * kWin * 4;             // a consumer's rows of one factor table
constexpr int kWConsumerBytes = 2 * kImg64 + 2 * kWTable;  // 48 128
constexpr int kWKOff = kConsumers * kWConsumerBytes;
constexpr int kWVOff = kWKOff + kWStages * 2 * kImg40;
constexpr int kWBarOff = kWVOff + kWStages * 2 * kImg40;
constexpr int kWSmemBytes = kWBarOff + (int)sizeof(Barriers) + 1024;
static_assert(kWSmemBytes <= 232448, "K5's shared memory");
static_assert(kWConsumerBytes % 256 == 0 && kImg40 % 256 == 0,
              "images start on the 32-byte swizzle's 256-byte period");

__global__ void __launch_bounds__(kThreads, 1) window_relpos_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias_h, const float* __restrict__ bias_w, float* __restrict__ o,
    int G, float scale) {
  extern __shared__ __align__(1024) unsigned char wt_smem_raw[];
  unsigned char* smem = wt_smem_raw + ((1024 - (smem_u32(wt_smem_raw) & 1023)) & 1023);
  Barriers* bars = reinterpret_cast<Barriers*>(smem + kWBarOff);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kWStages; ++st) {
      bar_init(&bars->k_full[st], 128);
      bar_init(&bars->v_full[st], 128);
      bar_init(&bars->k_empty[st], kConsumerWarps);
      bar_init(&bars->v_empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int n_items = kWRounds * G;
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    const int pt = threadIdx.x & 127;
    constexpr int kChunks = 2 * (kD / 8) * kWBN;  // 800 of each image
    constexpr int kPer = (kChunks + 127) / 128;
    // the block's tiles u = 0 .. n_tiles - 1: item blockIdx.x + (u / 5) *
    // gridDim.x, key tile u % 5; tile u + 1 is read from device memory
    // while tile u is split and written
    const int n_tiles = (n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * kWTiles;
    auto load = [&](int u, float4 (&xk)[kPer], float4 (&xv)[kPer]) {
      const int item = blockIdx.x + (u / kWTiles) * gridDim.x;
      const int k0 = (u % kWTiles) * kWBN;
      const long long base = (long long)(item / kWRounds) * kWinS * kD;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = pt + 128 * j;
        xk[j] = xv[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < kChunks) {
          int r;
          const int c = kimg_chunk(i, kWBN, r);
          if (k0 + r < kWinS)
            xk[j] = __ldg(reinterpret_cast<const float4*>(k + base + (k0 + r) * kD + c));
          // V^T: each chunk the values of one feature for four keys of a group
          int d;
          const int key = k0 + vimg_chunk<kD>(i, d);
          const float* src = v + base + (long long)key * kD + d;
          if (key < kWinS) xv[j].x = __ldg(src);
          if (key + 2 < kWinS) xv[j].y = __ldg(src + 2 * kD);
          if (key + 4 < kWinS) xv[j].z = __ldg(src + 4 * kD);
          if (key + 6 < kWinS) xv[j].w = __ldg(src + 6 * kD);
        }
      }
    };
    auto store = [&](unsigned char* img, const float4 (&x)[kPer]) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = pt + 128 * j;
        if (i < kChunks) {
          uint4 hi, lo;
          split4(x[j], hi, lo);
          *reinterpret_cast<uint4*>(img + 16 * i) = hi;
          *reinterpret_cast<uint4*>(img + kImg40 + 16 * i) = lo;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    float4 xk[kPer], xv[kPer], nk[kPer], nv[kPer];
    load(0, xk, xv);
    for (int u = 0; u < n_tiles; ++u) {
      const int st = u % kWStages, parity = ((u / kWStages) & 1) ^ 1;
      if (kWPrefetch && u + 1 < n_tiles) load(u + 1, nk, nv);
      bar_wait_or_trap(&bars->k_empty[st], parity);
      store(smem + kWKOff + st * 2 * kImg40, xk);
      bar_arrive(&bars->k_full[st]);
      bar_wait_or_trap(&bars->v_empty[st], parity);
      store(smem + kWVOff + st * 2 * kImg40, xv);
      bar_arrive(&bars->v_full[st]);
      if (!kWPrefetch) {
        if (u + 1 < n_tiles) load(u + 1, xk, xv);
        continue;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        xk[j] = nk[j];
        xv[j] = nv[j];
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int lane = threadIdx.x & 31, tq = lane & 3;
    const int wrow = ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // the lane's row of 64, and + 8
    unsigned char* mine = smem + wg * kWConsumerBytes;
    unsigned char* q_hi = mine;
    unsigned char* q_lo = mine + kImg64;
    float* tab_h = reinterpret_cast<float*>(mine + 2 * kImg64);
    float* tab_w = tab_h + 64 * kWin;
    const Ring ring{bars, smem_u32(smem + kWKOff), smem_u32(smem + kWVOff)};
    if (kPingpong && wg == kConsumers - 1) turn_arrive(1 + (wg + 1) % kConsumers);
    int u = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, u += kWTiles) {
      const int g = item / kWRounds;
      const int r0 = (item % kWRounds) * kBM + wg * 64;  // the warpgroup's first row of the window
      const long long base = (long long)g * kWinS * kD;
      // every warp of the warpgroup is past the last item's reads
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
      // the rows' factors (zero past 196), then Q (which syncs the warpgroup)
      const long long fbase = ((long long)g * kWinS + r0) * kWin;
      constexpr int kTabPer = 64 * kWin / 128;  // 7 values of each table a thread
      float fh[kTabPer], fw[kTabPer];
#pragma unroll
      for (int j = 0; j < kTabPer; ++j) {
        const int i = (threadIdx.x & 127) + 128 * j;
        const bool live = r0 + i / kWin < kWinS;
        fh[j] = live ? __ldg(bias_h + fbase + i) : 0.f;
        fw[j] = live ? __ldg(bias_w + fbase + i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kTabPer; ++j) {
        tab_h[(threadIdx.x & 127) + 128 * j] = fh[j];
        tab_w[(threadIdx.x & 127) + 128 * j] = fw[j];
      }
      stage_q<kD>(q_hi, q_lo, q + base + (long long)r0 * kD, kWinS - r0, scale, wg);
      const float* th[2] = {tab_h + wrow * kWin, tab_h + (wrow + 8) * kWin};
      const float* tw[2] = {tab_w + wrow * kWin, tab_w + (wrow + 8) * kWin};
      // tile t: each score starts at its bias; keys >= 196 at -inf
      auto init = [&](int t, float (&s)[kWBN / 2], float (&sh)[2][1]) {
        sh[0][0] = sh[1][0] = 0.f;
#pragma unroll
        for (int j = 0; j < kWBN / 8; ++j) {
          const int c = t * kWBN + 8 * j + 2 * tq;  // the lane's key pair c, c + 1: one grid row
          const int ky = c / kWin, kx = c - ky * kWin;
          const bool in = c < kWinS;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float b = th[h][in ? ky : 0];
            const float2 w = *reinterpret_cast<const float2*>(tw[h] + (in ? kx : 0));
            s[4 * j + 2 * h] = in ? b + w.x : bff_tc::masked_score();
            s[4 * j + 2 * h + 1] = in ? b + w.y : bff_tc::masked_score();
          }
        }
      };
      float acc[40], l[2];
      attend_rows<kWBN, kWStages, kWStages, kWOverlap, kD, 1>(acc, l, smem_u32(q_hi),
                                                              smem_u32(q_lo), ring, u, kWTiles,
                                                              wg, init);
      const int row = r0 + wrow;
      store_rows<kD>(acc, l, o + base + (long long)row * kD, row < kWinS, row + 8 < kWinS);
    }
    if (kPingpong && wg == 0) turn_sync(1);  // the last consumer's last turn
  }
}

bool aligned(const void* q, const void* k, const void* v, const void* o, const void* bh,
             const void* bw) {
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(bh) &&
         aligned16(bw);
}

}  // namespace

// The routing predicate (kernels/flash_attention.py relpos_tf32_route
// mirrors it): 1 when bff_flash_attention_relpos (kind 0, K4; rows x cols =
// kh x kw) or bff_window_attention_relpos (kind 1, K5; wh x ww) takes the
// 3xTF32 kernel for the call: K4 at head dim 64 or 80 on grids of kw = 64
// or of kw a multiple of 8 in [kMinGridW, 64) (the narrow mode), K5 at 80.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int bff_relpos_tf32_takes(int kind, int dtype, int D, int S, int rows, int cols,
                                     float scale, const void* q, const void* k, const void* v,
                                     const void* o, const void* bias_h, const void* bias_w) {
  const bool width = cols == kGridW || (cols % 8 == 0 && cols >= kMinGridW && cols < kGridW);
  const bool shape = kind == 0   ? width && rows >= kMinGridH && rows <= kMaxGridH &&
                                     S == rows * cols && (D == 64 || D == kD)
                     : kind == 1 ? rows == kWin && cols == kWin && S == kWinS && D == kD
                                 : false;
  return shape && dtype == 0 && scale > 0.f && scale <= FLT_MAX &&
         aligned(q, k, v, o, bias_h, bias_w);
}

// The scratch a K4 call at head dim D needs, in floats: each 64-key tile's
// K hi, K lo, V^T hi and V^T lo images, 4 BH Sp D with Sp = S rounded up to
// 64 keys (S itself at kw = 64).
extern "C" long long bff_relpos_tf32_scratch_floats(int BH, int S, int D) {
  return 4LL * BH * ((S + kBN - 1) / kBN * kBN) * D;
}

// K4. q, k, v, o: contiguous (BH, S, D) f32 with S = kh * kw and D 64 or
// 80; bias_h (BH, S, kh), bias_w (BH, S, kw) f32; scratch: 16-byte aligned,
// at least bff_relpos_tf32_scratch_floats floats, on the same stream.
// Returns cudaGetLastError() after the launches, -1 for arguments outside
// the predicate or no scratch.
extern "C" int bff_flash_relpos_tf32(const void* q, const void* k, const void* v,
                                     const void* bias_h, const void* bias_w, void* o,
                                     void* scratch, int BH, int S, int D, int kh, int kw,
                                     float scale, void* stream) {
  if (BH < 1 || scratch == nullptr || !aligned16(scratch) ||
      !bff_relpos_tf32_takes(0, 0, D, S, kh, kw, scale, q, k, v, o, bias_h, bias_w))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BFF_K4(DIM, NARROW) \
  launch_k4<DIM, NARROW>(q, k, v, bias_h, bias_w, o, scratch, BH, S, kh, kw, scale, s)
  if (kw == kGridW) return D == 64 ? BFF_K4(64, false) : BFF_K4(kD, false);
  return D == 64 ? BFF_K4(64, true) : BFF_K4(kD, true);
#undef BFF_K4
}

// K5. q, k, v, o: contiguous (G, 196, 80) f32; bias_h, bias_w (G, 196, 14)
// f32. Return codes as bff_flash_relpos_tf32's.
extern "C" int bff_window_relpos_tf32(const void* q, const void* k, const void* v,
                                      const void* bias_h, const void* bias_w, void* o, int G,
                                      float scale, void* stream) {
  if (G < 1 ||
      !bff_relpos_tf32_takes(1, 0, kD, kWinS, kWin, kWin, scale, q, k, v, o, bias_h, bias_w))
    return -1;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_relpos_tf32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmemBytes);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const int grid = std::min(kWRounds * G, sms);
  window_relpos_tf32_kernel<<<grid, kThreads, kWSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias_h), static_cast<const float*>(bias_w),
      static_cast<float*>(o), G, scale);
  return (int)cudaGetLastError();
}
