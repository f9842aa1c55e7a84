// Flash attention in f32 for Hopper (sm_90a): 3xTF32 on wgmma, TMA and a
// warp-specialised pipeline.
//
// Replaces, for float32 inputs, the TPU kernels
// beyondff_tpu/kernels/flash_attention.py _flash_masked (:270, pallas_call
// :313; keys >= valid_len masked, reached through attend :101) and
// flash_attention (:68, pallas_call :78; every key valid): softmax(Q K^T *
// scale) V over (BH, S, D) with an online max and denominator, the output
// divided once. On the port's main path in detector.dtype float32 that is K2,
// the Grounding-DINO decoder's self-attention at (8 B, 900, 32), and K3,
// EfficientSAM-S's global blocks at (6 B, 4096, 64) (and (6 B, 3072, 64) on
// the rect grid); and f32 attention at head dims 80, 96, 112 and 128, which
// the public entry points take and no configured model calls.
// bff_flash_attention (csrc/flash_attention.cu) routes here exactly the calls
// that bff_flash_tf32_takes accepts: f32, D in {32, 64, 80, 96, 112, 128}, S
// >= kMinS = 256,
// 1 <= valid_len <= S, a positive finite scale and 16-byte aligned q, k, v
// and o; every other f32 call keeps
// flash_fwd_kernel<float> (f32 FMAs). Below S = 256 the pre-pass and the
// pipeline's latency outweigh the products: at S = 64 the FMA kernel took
// 0.0070 ms against 0.0096 (8 heads, D 32), from S = 256 on this kernel
// is the faster (tools/kernel_variants.py --cases "f32 small"; at D 128
// and S = 256, 0.034 ms against 0.070), and the main path's attend calls a
// kernel only from S = 256 on.
//
// Precision. One TF32 product keeps 11 bits of each operand, too few for
// the 1e-4 the f32 calls are held to. Each f32 operand x is split into two
// TF32 words, hi = rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32; x - hi is
// exact in f32), and each product A B is summed as lo(A) hi(B) + hi(A) lo(B)
// + hi(A) hi(B) in the f32 accumulators (the lo lo term is below 2^-22 of
// the product): about 22 bits of each operand, the small terms first. The
// words handed to wgmma are all rna-rounded TF32, so the hardware's
// truncation of the low 13 bits drops nothing.
//
// Bound on an H100 SXM: 3xTF32 does three TF32 products per f32 product,
// 495 / 3 = 165 TFLOP/s of f32-grade work, 2.5x the f32 FMA peak of 67
// TFLOP/s. At (24, 4096, 64) the function does 4 * 24 * 4096^2 * 64 = 103
// GFLOP (0.625 ms at 165 TFLOP/s) and moves 4 * 24 * 4096 * 64 * 4 = 101 MB
// (0.030 ms), so it is bound by operations; at (32, 900, 32) 3.3 GFLOP
// (0.020 ms) against 15 MB (0.0044 ms); at (32, 1024, 128) with 900 valid
// keys 15.1 GFLOP (0.0915 ms) against 67 MB (0.020 ms).
//
// Design:
// * A pre-pass (split_kv_kernel, one block a 64-key tile of a head) writes
//   K's hi and lo as (BH, Kp, D) and V's as V^T (BH, D, Kp), Kp = valid_len
//   rounded up to 64, into scratch the wrapper allocates (4 BH Kp D floats);
//   keys >= valid_len are written as 0. TF32 wgmma takes both shared-memory
//   operands K-major only (no transpose bit): K (keys, D) is K-major for Q
//   K^T as it stands, V must be stored with keys contiguous for P V. The
//   pre-pass reads K and V once and writes them twice (at (24, 4096, 64)
//   50 MB in, 101 MB out: 0.053 ms of the call). Splitting in shared memory
//   instead (tools/variant_csrc/flash_attention_tf32_smem.cu) repeats the
//   split and V's transpose in every query block on the producer's 128
//   threads, and was 2.2x slower.
// * The accumulator layout of S is not the TF32 A-fragment layout: a lane
//   holds keys (2t, 2t + 1) of each 8-key group (t = lane % 4), the m64k8
//   A fragment wants columns (t, t + 4). The pre-pass permutes the keys of
//   each 8-key group of V^T to 0 2 4 6 1 3 5 7, so P's accumulator registers
//   are its A fragments with no data movement (the sum over keys does not
//   care about their order).
// * One block per 128-query tile, grid (ceil(S / 128), BH): warpgroup 2 is
//   the producer (setmaxnreg 24); one of its threads issues every TMA load
//   (cp.async.bulk.tensor.3d, 128-byte swizzle, boxes of 32 floats = one
//   128-byte row) of the 64-key tiles of K hi, K lo, V^T hi and V^T lo into
//   a ring of kStages stages (2 at D 64: 64 KB a stage; 4 at D 32), with a
//   full and an empty mbarrier per operand and stage. Tiles wholly past
//   valid_len are never loaded.
// * Warpgroups 0 and 1 are the consumers (setmaxnreg 240), 64 query rows
//   each. Each reads its Q rows once from device memory, splits them and
//   writes hi and lo to shared memory in the K tiles' swizzled layout
//   (fence.proxy.async before wgmma reads them). ptxas gives a 384-thread
//   block 168 registers a thread whatever setmaxnreg asks, and serializes
//   every wgmma (C7512) when a consumer needs more: Q's halves in registers
//   (2 x D / 2 more) spilled at D 64. S = Q K^T is 3 D / 8
//   wgmma.m64n64k8.tf32 from shared memory, P V 24 wgmma.m64nDk8.tf32 with
//   P split in registers (the A operand). The online softmax runs on the f32
//   accumulators: the row max by quad shuffles, scale * log2(e) folded into
//   one FMA before ex2.approx, the running max raised at every tile. Tile
//   t's Q K^T is issued before tile t - 1's P V (kOverlap), and the two
//   consumers take turns to issue (kPingpong), as in
//   csrc/flash_attention_wgmma.cu.
// * Head dim 128 (Cfg<128>). A 64-key stage of K and V^T hi and lo is 128
//   KB and both consumers' Q halves another 128 KB, above the 227 KB a
//   block may have; and at m64n128 a consumer's output (64 registers),
//   64-key scores (32) and P's halves (64) leave nothing of the 168 for
//   addresses. So the tiles are 32 keys (wgmma.m64n32k8 for Q K^T,
//   m64n128k8 for P V; scores 16 registers, P's halves 32), with two K
//   stages and one V stage (224 KB with Q), each ring fed by its own
//   producer thread. Each tile's products run in turn (kOverlap128 off).
//   P V accumulates in the tensor cores across the tiles: at (32, 1024,
//   128) with 900 valid keys the call lies 4.6e-6 from its plain version
//   at unit scale, within 1e-5 of it, so the fold (kFold128: each tile's P
//   V summed apart in two 64-column halves, m64n64k8, and added by the FMA
//   units, as csrc/relpos_attention_tf32.cu's kFold does) stays off.
// * Head dim 96 (Cfg<96>). A 96-float row is three 128-byte TMA boxes. At
//   64-key tiles a K stage and a V stage (hi and lo) take 48 KB each, so
//   beside both consumers' Q halves (96 KB) only one of each fits (192 KB);
//   at 32-key tiles (D 128's) two of each fit. The output at m64n96 is 48
//   registers a thread; 64-key scores (32) and P's halves (64) leave 24 of
//   the 168 for addresses, yet ptxas fits them without a spill when each
//   tile's products run in turn. So the tiles are 64 keys (wgmma.m64n64k8
//   for Q K^T, m64n96k8 for P V), one K and one V stage, each tile's
//   products in turn (kOverlap96 off), P V accumulated across the tiles by
//   the tensor cores (no fold: 6.8e-6 from plain at unit scale). 32-key
//   tiles with two K and two V stages and the overlap, the first design,
//   were 6% slower (0.1485 against 0.1401 ms at (32, 1024, 96) with 900
//   valid keys; serial 0.1563; three K stages 0.1494).
// * Head dim 80 (Cfg<80>). An 80-float row is 320 bytes, 2.5 128-byte
//   boxes, so K's and Q's rows are five 16-float boxes (64 bytes) in the
//   64-byte swizzle instead (kKBox 16; the Q K^T descriptors in the same
//   mode, a k-step 32 bytes into a 64-byte row), which cover a row exactly:
//   no padded column reaches the tensor cores. V^T, whose rows are keys,
//   keeps the 128-byte swizzle and is read by m64n80k8. Q takes 80 KB, a
//   64-key K stage 40 KB, a V stage 40 KB: two K stages and one V stage
//   (200 KB). The output (40 registers), the scores (32) and P's halves (64)
//   fit 168 registers with no spill, each tile's products in turn, no fold.
//   Padding D 80 to 96 in the pre-pass and Q's split and running Cfg<96>
//   was not built: Cfg<96> itself takes 0.1407 ms at (32, 1024, 96) with
//   900 valid keys, 17% above this design's 0.1206 at D 80, before the
//   padding's 20% more k-steps of Q K^T are counted.
// * Head dim 112 (Cfg<112>). A 112-float row is 448 bytes, 3.5 128-byte
//   boxes, so K's and Q's rows are seven 16-float boxes in the 64-byte
//   swizzle, as D 80's are five; V^T keeps the 128-byte swizzle and is read
//   by m64n112k8. Both consumers' Q halves take 112 KB. At 64-key tiles a K
//   stage and a V stage take 56 KB each, so one of each fits with under 2
//   KB to spare, and the output (56 registers), the scores (32) and P's
//   halves (64) leave 16 of the 168 for addresses; at 32-key tiles (D 128's
//   plan) two K stages and one V stage take 84 KB (196 KB with Q) and the
//   scores and P's halves 48 registers. So the tiles are 32 keys
//   (wgmma.m64n32k8 for Q K^T), two K stages and one V stage, each tile's
//   products in turn, no fold. 64-key tiles with one stage of each were
//   8% faster (0.1681 against 0.1820 ms at (32, 1024, 112) with 900 valid
//   keys) but spilled 80 bytes, also with Q's addresses made opaque once a
//   tile (tools/kernel_variants.py tf32_d112_keys_64*).
// * Masking is branch-free: every score of a key >= valid_len is set to
//   -inf (only the last tile has any); rows >= S are computed on zero Q and
//   not written.
//
// Host: the four CUtensorMaps over the scratch are encoded on every call
// (cuTensorMapEncodeTiled looked up at run time, no -lcuda). A failed
// lookup, encode or launch returns non-zero and the wrapper raises: nothing
// falls back to another kernel.
//
// Measured on an H100 SXM at 700 W (tools/kernel_variants.py --cases f32,
// device time, one process): at (24, 4096, 64) 0.922 ms (112 TFLOP/s, 68%
// of the bound) against 5.46-6.03 ms for the FMA kernel and 3.13 ms for
// scaled_dot_product_attention in f32; at (32, 900, 32) 0.069 ms against
// 0.254 and 0.263 ms. Without the overlap or without pingpong K3 takes
// 11-12% longer. At (32, 1024, 128) with 900 valid keys 0.208 ms (44% of
// the bound, the pre-pass 0.031 of it) against 0.899 ms for the FMA kernel
// and 0.446 ms for scaled_dot_product_attention in f32; there the fold
// took 0.212, the overlap 0.247 (it spills), one K stage and two V stages
// 0.261, one of each 0.224. At (32, 1024, 96) with 900 valid keys 0.140 ms
// (49% of its 0.0686 ms bound, the pre-pass 0.024) against 0.895 ms for
// the FMA kernel and 0.414 ms for scaled_dot_product_attention in f32, 6.8e-6
// from plain (2.9e-5 at spread 3); the overlap at D 96 spilled 384 bytes
// and took 0.287. At (8, 256, 96) 0.0252 against the FMA kernel's 0.0688:
// kMinS holds at D 96. At (32, 1024, 80) with 900 valid keys (NVIDIA H100
// 80GB HBM3, 700.00 W, device time) 0.1206 ms (47% of its 0.0572 ms bound,
// the pre-pass 0.019) against 0.8812 ms for the FMA kernel and 0.4120 ms for
// scaled_dot_product_attention in f32, 5.4e-6 from plain (3.0e-5 at spread
// 3); at (8, 1024, 80) 0.0520 against 0.2455 and 0.1035; the overlap, with
// no spill, took 0.1502, one K and one V stage 0.1220, one K stage and two V
// stages 0.1230. At (8, 256, 80) 0.0218 against the FMA kernel's 0.0678
// (and SDPA-f32's 0.0239): kMinS holds at D 80. At (32, 1024, 112) with
// 900 valid keys (NVIDIA H100 80GB HBM3, 700.00 W, CUDA events) 0.1817 ms
// (44% of its 0.0801 ms bound) against 0.8854 ms for the FMA kernel and
// 0.4533 ms for scaled_dot_product_attention in f32, 4.8e-6 from plain
// (3.1e-5 at spread 3); at (8, 256, 112) 0.0341 against the FMA kernel's
// 0.0697: kMinS holds at D 112.

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace bff_wg;

constexpr int kKeyPad = 64;           // the pre-pass's key tile: K and V^T padded to 64 keys
constexpr int kMinS = 256;            // shorter sequences keep the FMA kernel
constexpr int kConsumers = 2;         // consumer warpgroups of 64 query rows each
constexpr int kBM = 64 * kConsumers;  // query rows of a block
constexpr bool kOverlap = true;       // issue Q K^T of tile t before P V of tile t - 1
constexpr bool kPingpong = true;      // the consumers take turns to issue their products
// Head dim 128 (Cfg): each tile's products in turn; P V accumulated by the
// tensor cores across the tiles (kFold128: each tile's P V summed apart in
// two 64-column halves and added in f32); two K stages and one V stage of
// 32 keys.
constexpr bool kOverlap128 = false;
constexpr bool kFold128 = false;
constexpr int kKStages128 = 2, kVStages128 = 1;
// Head dim 96 (Cfg): 64-key tiles, one K and one V stage, each tile's
// products in turn
constexpr int kBN96 = 64;
constexpr bool kOverlap96 = false;
constexpr int kKStages96 = 1, kVStages96 = 1;
// Head dim 80 (Cfg): K's and Q's rows in boxes of 16 floats in the 64-byte
// swizzle (five a row); 64-key tiles, two K stages and one V stage, each
// tile's products in turn
constexpr int kKStages80 = 2, kVStages80 = 1;
constexpr bool kOverlap80 = false;
// Head dim 112 (Cfg): seven 16-float boxes a row in the 64-byte swizzle, as
// at 80; 32-key tiles, two K stages and one V stage, each tile's products in
// turn
constexpr int kBN112 = 32;
constexpr int kKStages112 = 2, kVStages112 = 1;
constexpr bool kOverlap112 = false;
constexpr int kThreads = 128 * (kConsumers + 1);  // the producer is the last warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kRow = 128;             // bytes of a swizzled row: 32 floats
constexpr int kSplitThreads = 256;

template <int D>
struct Cfg {
  // keys of a tile: 64, or 32 at D 128, where one 64-key stage (K and V^T
  // hi and lo, 128 KB) beside both consumers' Q halves (128 KB) would not
  // fit in a block's 227 KB (at D 96 one 64-key stage of each fits)
  static constexpr int kBN = D == 128 ? 32 : D == 112 ? kBN112 : D == 96 ? kBN96 : 64;
  static constexpr int kStages = D == 32 ? 4 : 2;
  static constexpr int kKStages = D == 128 ? kKStages128
                                  : D == 112 ? kKStages112
                                  : D == 96 ? kKStages96
                                  : D == 80 ? kKStages80
                                            : kStages;
  static constexpr int kVStages = D == 128 ? kVStages128
                                  : D == 112 ? kVStages112
                                  : D == 96 ? kVStages96
                                  : D == 80 ? kVStages80
                                            : kStages;
  static constexpr bool kOverlapped = D == 128 ? kOverlap128
                                      : D == 112 ? kOverlap112
                                      : D == 96 ? kOverlap96
                                      : D == 80 ? kOverlap80
                                                : kOverlap;
  static constexpr bool kFold = D == 128 && kFold128;
  // K's and Q's rows: TMA boxes of kKBox floats, rows of kKRow bytes in the
  // 128-byte swizzle (32 floats), or at D 80 and 112, 2.5 and 3.5 such
  // boxes, of 16 floats in the 64-byte swizzle
  static constexpr int kKBox = D % 32 == 0 ? 32 : 16;
  static constexpr int kKRow = 4 * kKBox;
  static constexpr int kKBytes = kBN * D * 4;  // K hi or K lo of a tile: D / kKBox boxes of kBN rows
  static constexpr int kVBytes = D * kBN * 4;  // V^T hi or lo of a tile: kBN / 32 boxes of D rows
  static constexpr int kQBytes = 64 * D * 4;   // a consumer's Q hi or Q lo: D / kKBox boxes of 64 rows
  // the K stages (hi, lo), the V stages (hi, lo), both consumers' Q hi and
  // lo, the barriers, and room to align the start to 1024 bytes
  static constexpr int kKOff = 0;
  static constexpr int kVOff = kKOff + kKStages * 2 * kKBytes;
  static constexpr int kQOff = kVOff + kVStages * 2 * kVBytes;
  static constexpr int kBarOff = kQOff + 2 * kConsumers * kQBytes;
  static constexpr int kSmemBytes = kBarOff + 256 + 1024;
  static_assert(kSmemBytes <= 232448, "a block's shared memory");
};

template <int D>
struct Barriers {
  uint64_t k_full[Cfg<D>::kKStages], k_empty[Cfg<D>::kKStages];
  uint64_t v_full[Cfg<D>::kVStages], v_empty[Cfg<D>::kVStages];
};
static_assert(sizeof(Barriers<32>) <= 256 && sizeof(Barriers<64>) <= 256 &&
                  sizeof(Barriers<80>) <= 256 && sizeof(Barriers<96>) <= 256 &&
                  sizeof(Barriers<112>) <= 256 && sizeof(Barriers<128>) <= 256,
              "the barriers' room");

#define BFF_T4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define BFF_T16(a, i) BFF_T4(a, i), BFF_T4(a, i + 4), BFF_T4(a, i + 8), BFF_T4(a, i + 12)

// d (+)= A B for A 64 x 8 TF32 in registers (a lane holds rows g, g + 8 of
// its warp's 16 and columns t, t + 4: a0 (g, t), a1 (g + 8, t), a2 (g, t +
// 4), a3 (g + 8, t + 4)) and B 8 x N TF32 from shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : BFF_T16(d, 0), BFF_T16(d, 16), BFF_T16(d, 32), BFF_T16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[56], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : BFF_T16(d, 0), BFF_T16(d, 16), BFF_T16(d, 32), BFF_T4(d, 48), BFF_T4(d, 52)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : BFF_T16(d, 0), BFF_T16(d, 16), BFF_T16(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : BFF_T16(d, 0), BFF_T16(d, 16), BFF_T4(d, 32), BFF_T4(d, 36)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : BFF_T16(d, 0), BFF_T16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : BFF_T16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A B for A 64 x 8 and B 8 x N (N = 64 or 32) TF32, both from shared
// memory, K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : BFF_T16(d, 0), BFF_T16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : BFF_T16(d, 0)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef BFF_T16
#undef BFF_T4

// The descriptor of k-step kk (8 columns, 32 bytes) of a K-major operand
// stored as boxes of ``rows`` 128-byte rows (32 columns a box).
template <int rows>
__device__ __forceinline__ uint64_t kstep_desc(uint32_t base, int kk) {
  return sw128_desc(base + (kk / 4) * rows * kRow + (kk % 4) * 32, 16);
}

// The same for Q and K at head dim D: boxes of Cfg<D>::kKBox floats, at D 80
// and 112 64-byte rows in the 64-byte swizzle (16 columns a box).
template <int D, int rows>
__device__ __forceinline__ uint64_t qk_desc(uint32_t base, int kk) {
  if constexpr (Cfg<D>::kKBox == 32) return kstep_desc<rows>(base, kk);
  else return sw64_desc(base + (kk / 2) * rows * 64 + (kk % 2) * 32, 16);
}

// The byte offset of element (row, col) of a box of ``box``-float rows as
// TMA writes it: in the 128-byte swizzle (box 32) the 16-byte chunk col / 4
// of row r lies at chunk (col / 4) ^ (r % 8), in the 64-byte swizzle (box
// 16) at (col / 4) ^ ((r / 2) % 4).
template <int box>
__device__ __forceinline__ int swizzled(int row, int col) {
  if constexpr (box == 32) return row * kRow + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
  else return row * 64 + ((((col >> 2) ^ (row >> 1)) & 3) << 4) + ((col & 3) << 2);
}

// S = Q K^T for the warpgroup's 64 rows (Q hi and lo in shared memory) and
// the N keys of a tile: the small terms over every k-step first, then hi hi.
template <int D, int N>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint32_t qhi, uint32_t qlo,
                                             uint32_t khi, uint32_t klo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_tf32(s, qk_desc<D, 64>(qlo, kk), qk_desc<D, N>(khi, kk), kk);
    wgmma_tf32(s, qk_desc<D, 64>(qhi, kk), qk_desc<D, N>(klo, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32(s, qk_desc<D, 64>(qhi, kk), qk_desc<D, N>(khi, kk), 1);
}

// O += P V for the N keys of a tile (k-step kk: stored keys 8 kk .. 8 kk +
// 7) and the columns of V^T's rows at vhi, vlo (all D, or a 64-column half
// when O has 32 registers); O = P V when ``fresh``.
template <int D, int N, int R>
__device__ __forceinline__ void issue_pv(float (&o)[R], const uint32_t (&ph)[N / 8][4],
                                         const uint32_t (&pl)[N / 8][4], uint32_t vhi,
                                         uint32_t vlo, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    wgmma_tf32(o, pl[kk], kstep_desc<D>(vhi, kk), kk == 0 && fresh ? 0 : 1);
    wgmma_tf32(o, ph[kk], kstep_desc<D>(vlo, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) wgmma_tf32(o, ph[kk], kstep_desc<D>(vhi, kk), 1);
}

// Where lane's accumulator values lie: s[4 j + e] holds row lane / 4 + 8 (e
// / 2) of the warp's 16 rows and column 8 j + 2 (lane % 4) + e % 2.

// The online softmax of one score tile of N keys in place: keys >=
// valid_len (from k0 on) at -inf, the running max m (log2 units) raised, l
// rescaled and summed, s turned into p. corr: the factors the output rows
// are rescaled by.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2, int k0,
                                             int valid_len) {
  const int c = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = c + 8 * j + (e & 1) < valid_len ? s[4 * j + e] : bff_tc::masked_score();
  float mx[2] = {bff_tc::masked_score(), bff_tc::masked_score()};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2)) * sl2;
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = bff_tc::exp2_approx(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = bff_tc::exp2_approx(fmaf(s[4 * j], sl2, -m[0]));
    s[4 * j + 1] = bff_tc::exp2_approx(fmaf(s[4 * j + 1], sl2, -m[0]));
    s[4 * j + 2] = bff_tc::exp2_approx(fmaf(s[4 * j + 2], sl2, -m[1]));
    s[4 * j + 3] = bff_tc::exp2_approx(fmaf(s[4 * j + 3], sl2, -m[1]));
    l[0] += s[4 * j] + s[4 * j + 1];
    l[1] += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P split into the A fragments of the N / 8 k-steps of P V: k-step kk
// takes the accumulator's n8 tile kk, column t of the fragment from key 2 t
// and column t + 4 from key 2 t + 1 (V^T's keys are stored in that order).
template <int N>
__device__ __forceinline__ void split_p(uint32_t (&ph)[N / 8][4], uint32_t (&pl)[N / 8][4],
                                        const float (&s)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
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

// K's hi and lo as (BH, Kp, D), V's as V^T (BH, D, Kp) with each 8-key
// group stored in the order 0 2 4 6 1 3 5 7; keys >= valid_len as 0. One
// block a 64-key tile of a head.
template <int D>
__global__ void __launch_bounds__(kSplitThreads) split_kv_kernel(
    const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ khi,
    float* __restrict__ klo, float* __restrict__ vhi, float* __restrict__ vlo, int S,
    int valid_len, int Kp) {
  __shared__ float tile[kKeyPad][D + 1];
  const int bh = blockIdx.y, k0 = blockIdx.x * kKeyPad;
  const long long in_base = (long long)bh * S * D;
  const long long out_base = (long long)bh * Kp * D;
  for (int i = threadIdx.x; i < kKeyPad * D; i += kSplitThreads) {
    const int r = i / D, c = i % D, key = k0 + r;
    const bool in = key < valid_len;
    const long long at = in_base + (long long)key * D + c;
    uint32_t hi, lo;
    split_tf32(in ? k[at] : 0.f, hi, lo);
    khi[out_base + (long long)key * D + c] = __uint_as_float(hi);
    klo[out_base + (long long)key * D + c] = __uint_as_float(lo);
    tile[r][c] = in ? v[at] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * kKeyPad; i += kSplitThreads) {
    const int c = i / kKeyPad, pos = i % kKeyPad, kap = pos & 7;
    const int key = (pos & ~7) + (kap < 4 ? 2 * kap : 2 * kap - 7);
    uint32_t hi, lo;
    split_tf32(tile[key][c], hi, lo);
    vhi[out_base + (long long)c * Kp + k0 + pos] = __uint_as_float(hi);
    vlo[out_base + (long long)c * Kp + k0 + pos] = __uint_as_float(lo);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_tf32_kernel(
    const __grid_constant__ CUtensorMap tkh, const __grid_constant__ CUtensorMap tkl,
    const __grid_constant__ CUtensorMap tvh, const __grid_constant__ CUtensorMap tvl,
    const float* __restrict__ q, float* __restrict__ o, int S, int valid_len, float sl2) {
  static_assert(kConsumers == 2, "two consumer warpgroups");
  using C = Cfg<D>;
  constexpr int N = C::kBN;
  constexpr int KS = C::kKStages, VS = C::kVStages;
  extern __shared__ __align__(1024) unsigned char tf32_smem_raw[];
  // the swizzle atoms must start on 1024-byte boundaries of shared memory
  unsigned char* smem = tf32_smem_raw + ((1024 - (smem_u32(tf32_smem_raw) & 1023)) & 1023);
  // K stage st: hi, lo; V stage st: V^T hi, V^T lo
  auto khi_at = [&](int st) { return smem + C::kKOff + st * 2 * C::kKBytes; };
  auto klo_at = [&](int st) { return khi_at(st) + C::kKBytes; };
  auto vhi_at = [&](int st) { return smem + C::kVOff + st * 2 * C::kVBytes; };
  auto vlo_at = [&](int st) { return vhi_at(st) + C::kVBytes; };
  Barriers<D>* bars = reinterpret_cast<Barriers<D>*>(smem + C::kBarOff);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (valid_len + N - 1) / N;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < KS; ++st) {
      bar_init(&bars->k_full[st], 1);
      bar_init(&bars->k_empty[st], kConsumerWarps);
    }
#pragma unroll
    for (int st = 0; st < VS; ++st) {
      bar_init(&bars->v_full[st], 1);
      bar_init(&bars->v_empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    auto load_k = [&](int t) {
      const int st = t % KS, parity = ((t / KS) & 1) ^ 1;
      bar_wait_or_trap(&bars->k_empty[st], parity);
      bar_expect_tx(&bars->k_full[st], 2 * C::kKBytes);
#pragma unroll
      for (int c = 0; c < D / C::kKBox; ++c) {
        tma_load_3d(khi_at(st) + c * N * C::kKRow, &tkh, &bars->k_full[st], C::kKBox * c, t * N,
                    bh);
        tma_load_3d(klo_at(st) + c * N * C::kKRow, &tkl, &bars->k_full[st], C::kKBox * c, t * N,
                    bh);
      }
    };
    auto load_v = [&](int t) {
      const int st = t % VS, parity = ((t / VS) & 1) ^ 1;
      bar_wait_or_trap(&bars->v_empty[st], parity);
      bar_expect_tx(&bars->v_full[st], 2 * C::kVBytes);
#pragma unroll
      for (int j = 0; j < N / 32; ++j) {
        tma_load_3d(vhi_at(st) + j * D * kRow, &tvh, &bars->v_full[st], t * N + 32 * j, 0, bh);
        tma_load_3d(vlo_at(st) + j * D * kRow, &tvl, &bars->v_full[st], t * N + 32 * j, 0, bh);
      }
    };
    if constexpr (KS == VS) {
      // one thread issues every load, K and V of a tile in turn
      if (threadIdx.x == 128 * kConsumers) {
        for (int t = 0; t < n_tiles; ++t) {
          load_k(t);
          load_v(t);
        }
      }
    } else {
      // rings of different depths: one thread (of another warp) each
      if (threadIdx.x == 128 * kConsumers) {
        for (int t = 0; t < n_tiles; ++t) load_k(t);
      } else if (threadIdx.x == 128 * kConsumers + 32) {
        for (int t = 0; t < n_tiles; ++t) load_v(t);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int lane = threadIdx.x & 31;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const int g = lane / 4, tq = lane & 3;
    const int row0 = q0 + wg * 64 + ((threadIdx.x / 32) & 3) * 16 + g;  // and row0 + 8

    // the warpgroup's 64 rows of Q, split into hi and lo in shared memory in
    // the layout the K tiles have (rows >= S as 0), once; then made visible
    // to wgmma (the async proxy) and to the warpgroup
    unsigned char* q_hi = smem + C::kQOff + 2 * wg * C::kQBytes;
    unsigned char* q_lo = q_hi + C::kQBytes;
    {
      const float* qb = q + ((long long)bh * S + q0 + wg * 64) * D;
      const int wt = threadIdx.x & 127;
      for (int i = wt; i < 64 * D; i += 128) {
        const int r = i / D, c = i % D;
        uint32_t hi, lo;
        split_tf32(q0 + wg * 64 + r < S ? qb[(long long)r * D + c] : 0.f, hi, lo);
        const int at =
            (c / C::kKBox) * 64 * C::kKRow + swizzled<C::kKBox>(r, c % C::kKBox);
        *reinterpret_cast<uint32_t*>(q_hi + at) = hi;
        *reinterpret_cast<uint32_t*>(q_lo + at) = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
    }
    const uint32_t qhi = smem_u32(q_hi), qlo = smem_u32(q_lo);

    float s[N / 2] = {}, acc[D / 2] = {};
    // with kFold: one 64-column half of a tile's P V, a fresh wgmma sum
    float pv[C::kFold ? 32 : 1] = {};
    uint32_t ph[N / 8][4] = {}, pl[N / 8][4] = {};
    float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, l[2] = {0.f, 0.f}, corr[2];

    // Pingpong as in csrc/flash_attention_wgmma.cu: consumer w issues its
    // round's Q K^T (and, overlapped, P V) after turn_sync(1 + w) and hands
    // the turn on by turn_arrive; consumer 1 hands consumer 0 the first
    // turn, consumer 0 takes the last one after its loop.
    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
    if (kPingpong && wg == kConsumers - 1) turn_arrive(next_turn);
    auto fence_for_issue = [&]() {
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(s);
      wgmma_fence();
    };
    auto fence_for_pv = [&]() {
      if constexpr (C::kFold) fence_regs(pv);
      else fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      wgmma_fence();
    };
    auto hand_on = [&]() {
      if (kPingpong) turn_arrive(next_turn);
    };
    const uint32_t base = smem_u32(smem);
    auto k_hi = [&](int st) { return base + C::kKOff + st * 2 * C::kKBytes; };
    auto k_lo = [&](int st) { return k_hi(st) + C::kKBytes; };
    auto v_hi = [&](int st) { return base + C::kVOff + st * 2 * C::kVBytes; };
    auto v_lo = [&](int st) { return v_hi(st) + C::kVBytes; };
    // P V of the tile in V stage st: into acc, or with kFold the first
    // 64-column half into pv (the caller commits and waits)
    auto issue_tile_pv = [&](int st) {
      if constexpr (C::kFold) issue_pv<D, N>(pv, ph, pl, v_hi(st), v_lo(st), true);
      else issue_pv<D, N>(acc, ph, pl, v_hi(st), v_lo(st), false);
    };
    // once issue_tile_pv's products are in: with kFold, adds the first half
    // to acc in f32, then the second half likewise
    auto finish_tile_pv = [&](int st) {
      if constexpr (C::kFold) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (half == 1) {
            fence_for_pv();
            issue_pv<D, N>(pv, ph, pl, v_hi(st) + 64 * kRow, v_lo(st) + 64 * kRow, true);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(pv);
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[32 * half + i] += pv[i];
        }
      }
    };

    // tile 0: scores, softmax, P
    bar_wait_or_trap(&bars->k_full[0], 0);
    if (kPingpong) turn_sync(my_turn);
    fence_for_issue();
    issue_scores<D, N>(s, qhi, qlo, k_hi(0), k_lo(0));
    wgmma_commit();
    hand_on();
    wgmma_wait<0>();
    fence_regs(s);
    if (signals) bar_arrive(&bars->k_empty[0]);
    softmax_tile<N>(s, m, l, corr, sl2, 0, valid_len);
    split_p<N>(ph, pl, s);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % KS, parity = (t / KS) & 1;
      const int pst = (t - 1) % VS, pparity = ((t - 1) / VS) & 1;
      if constexpr (C::kOverlapped) {
        bar_wait_or_trap(&bars->k_full[st], parity);
        bar_wait_or_trap(&bars->v_full[pst], pparity);
        if (kPingpong) turn_sync(my_turn);
        fence_for_issue();
        if constexpr (C::kFold) fence_regs(pv);
        issue_scores<D, N>(s, qhi, qlo, k_hi(st), k_lo(st));
        wgmma_commit();
        issue_tile_pv(pst);
        wgmma_commit();
        hand_on();
        wgmma_wait<1>();  // the scores are in
        fence_regs(s);
        if (signals) bar_arrive(&bars->k_empty[st]);
        softmax_tile<N>(s, m, l, corr, sl2, t * N, valid_len);
        wgmma_wait<0>();  // P V of tile t - 1 is in
        fence_regs(acc);
        if constexpr (C::kFold) fence_regs(pv);
        fence_regs(ph);
        fence_regs(pl);
        fence_regs(s);
        finish_tile_pv(pst);
        if (signals) bar_arrive(&bars->v_empty[pst]);
      } else {
        bar_wait_or_trap(&bars->v_full[pst], pparity);
        fence_for_pv();
        issue_tile_pv(pst);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if constexpr (C::kFold) fence_regs(pv);
        finish_tile_pv(pst);
        if (signals) bar_arrive(&bars->v_empty[pst]);
        bar_wait_or_trap(&bars->k_full[st], parity);
        if (kPingpong) turn_sync(my_turn);
        fence_regs(s);
        wgmma_fence();
        issue_scores<D, N>(s, qhi, qlo, k_hi(st), k_lo(st));
        wgmma_commit();
        hand_on();
        wgmma_wait<0>();
        fence_regs(s);
        if (signals) bar_arrive(&bars->k_empty[st]);
        softmax_tile<N>(s, m, l, corr, sl2, t * N, valid_len);
      }
      rescale<D>(acc, corr);
      split_p<N>(ph, pl, s);
    }
    if (kPingpong && wg == 0) turn_sync(my_turn);  // the last consumer's last turn
    // P V of the last tile
    const int lst = (n_tiles - 1) % VS, lparity = ((n_tiles - 1) / VS) & 1;
    bar_wait_or_trap(&bars->v_full[lst], lparity);
    fence_for_pv();
    issue_tile_pv(lst);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (C::kFold) fence_regs(pv);
    finish_tile_pv(lst);

    // the warp's 16 rows, divided by their denominators
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    float* ob = o + ((long long)bh * S + row0) * D + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row0 + 8 * h < S) {
        float* orow = ob + 8 * h * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j) =
              make_float2(acc[4 * j + 2 * h] / l[h], acc[4 * j + 2 * h + 1] / l[h]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* scratch, int BH, int S,
           int valid_len, float scale, cudaStream_t stream) {
  const int Kp = (valid_len + kKeyPad - 1) / kKeyPad * kKeyPad;
  const long long n = (long long)BH * Kp * D;
  float* khi = static_cast<float*>(scratch);
  float *klo = khi + n, *vhi = khi + 2 * n, *vlo = khi + 3 * n;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  CUtensorMap tkh, tkl, tvh, tvl;
  const cuuint64_t k_dims[3] = {(cuuint64_t)D, (cuuint64_t)Kp, (cuuint64_t)BH};
  const cuuint64_t k_strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)Kp * D * 4};
  const cuuint32_t k_box[3] = {(cuuint32_t)Cfg<D>::kKBox, (cuuint32_t)Cfg<D>::kBN, 1};
  const cuuint64_t v_dims[3] = {(cuuint64_t)Kp, (cuuint64_t)D, (cuuint64_t)BH};
  const cuuint64_t v_strides[2] = {(cuuint64_t)Kp * 4, (cuuint64_t)Kp * D * 4};
  const cuuint32_t v_box[3] = {32, D, 1};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  const CUtensorMapSwizzle k_sw = Cfg<D>::kKBox == 32 ? sw : CU_TENSOR_MAP_SWIZZLE_64B;
  int rc = encode_map(fn, &tkh, f32, 3, khi, k_dims, k_strides, k_box, k_sw);
  if (rc == 0) rc = encode_map(fn, &tkl, f32, 3, klo, k_dims, k_strides, k_box, k_sw);
  if (rc == 0) rc = encode_map(fn, &tvh, f32, 3, vhi, v_dims, v_strides, v_box, sw);
  if (rc == 0) rc = encode_map(fn, &tvl, f32, 3, vlo, v_dims, v_strides, v_box, sw);
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<D>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  split_kv_kernel<D><<<dim3(Kp / kKeyPad, BH), kSplitThreads, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), khi, klo, vhi, vlo, S,
      valid_len, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_tf32_kernel<D><<<dim3((S + kBM - 1) / kBM, BH), kThreads, Cfg<D>::kSmemBytes, stream>>>(
      tkh, tkl, tvh, tvl, static_cast<const float*>(q), static_cast<float*>(o), S, valid_len,
      scale * bff_tc::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// The routing predicate (kernels/flash_attention.py tf32_route mirrors it):
// 1 when bff_flash_attention takes this kernel for the call. dtype: 0 =
// float32, 1 = bfloat16.
extern "C" int bff_flash_tf32_takes(int dtype, int D, int S, int valid_len, float scale,
                                    const void* q, const void* k, const void* v, const void* o) {
  return dtype == 0 && (D == 32 || D == 64 || D == 80 || D == 96 || D == 112 || D == 128) &&
         S >= kMinS && valid_len >= 1 && valid_len <= S && scale > 0.f && scale <= FLT_MAX &&
         aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
}

// The scratch a call needs, in floats: K hi and lo, V^T hi and lo, each
// (BH, Kp, D) with Kp = valid_len rounded up to 64 keys.
extern "C" long long bff_flash_tf32_scratch_floats(int BH, int D, int valid_len) {
  return 4LL * BH * ((valid_len + kKeyPad - 1) / kKeyPad * kKeyPad) * D;
}

// q, k, v, o: contiguous (BH, S, D) f32; scratch: 16-byte aligned, at least
// bff_flash_tf32_scratch_floats floats, on the same stream. Returns
// cudaGetLastError() after the launches, -1 for arguments outside the
// predicate or no scratch, -2 when the driver's cuTensorMapEncodeTiled is
// not found, -3 for a misaligned base or stride, -1000 - CUresult for a
// failed encode.
extern "C" int bff_flash_attention_tf32(const void* q, const void* k, const void* v, void* o,
                                        void* scratch, int BH, int S, int D, int valid_len,
                                        float scale, void* stream) {
  if (BH < 1 || scratch == nullptr || !aligned16(scratch) ||
      !bff_flash_tf32_takes(0, D, S, valid_len, scale, q, k, v, o))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch<32>(q, k, v, o, scratch, BH, S, valid_len, scale, s);
  if (D == 64) return launch<64>(q, k, v, o, scratch, BH, S, valid_len, scale, s);
  if (D == 80) return launch<80>(q, k, v, o, scratch, BH, S, valid_len, scale, s);
  if (D == 96) return launch<96>(q, k, v, o, scratch, BH, S, valid_len, scale, s);
  if (D == 112) return launch<112>(q, k, v, o, scratch, BH, S, valid_len, scale, s);
  return launch<128>(q, k, v, o, scratch, BH, S, valid_len, scale, s);
}
