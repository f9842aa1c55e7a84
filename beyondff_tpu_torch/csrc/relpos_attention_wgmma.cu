// Attention with SAM's decomposed relative-position bias at head dim 80 for
// Hopper (sm_90a): wgmma, TMA and a warp-specialised pipeline. Two kernels:
//
// * flash_relpos_wgmma_kernel replaces the TPU kernel
//   beyondff_tpu/kernels/flash_attention.py flash_attention_relpos (:193,
//   pallas_call :214, body _relpos_kernel :128, wrapper attend_relpos :253):
//   softmax(Q K^T * scale + bias) V over a raster-ordered (kh, 64) key grid
//   with an online max and denominator, P rounded to bf16 before P V and the
//   output divided once by the f32 denominator (:175-189). SAM ViT-H's global
//   blocks: (16 B, 4096, 80) on the 64 x 64 grid, (16 B, 3072, 80) on the
//   rect 48 x 64 grid.
// * window_relpos_wgmma_kernel replaces the TPU kernel
//   beyondff_tpu/kernels/window_attention.py window_attention_relpos (:51,
//   pallas_call :110): the same function over G independent 14 x 14 windows
//   (S = 196), each row's softmax taken over all its keys at once (the TPU
//   kernel normalises P before P V, :100-106; here the output is divided
//   after, inside the same bf16 bound). SAM ViT-H's windowed blocks:
//   (25 * 16 B, 196, 80).
//
// bias[q, k] = bias_h[q, k / kw] + bias_w[q, k % kw]; the factors arrive in
// bf16 and are added in f32. bff_flash_attention_relpos and
// bff_window_attention_relpos (csrc/relpos_attention.cu) route here exactly
// the calls that bff_relpos_wgmma_takes accepts (kernels/flash_attention.py
// relpos_wgmma_route mirrors it): bf16, D = 80, kw = 64 with 1 <= kh <= 64
// (K4) or a 14 x 14 window (K5), a positive finite scale, and q, k, v, o and
// both factors 16-byte aligned. Every other call keeps the mma.sync tile of
// csrc/attention_tc.cuh or the FMA kernels.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): K4 at (64, 4096, 80)
// does 4 * 64 * 4096^2 * 80 = 3.4e11 operations (0.347 ms) and moves 0.24 GB
// (0.07 ms): bound by operations. K5 at (1600, 196, 80) moves 4 * 1600 * 196
// * 80 * 2 bytes of q, k, v, o and 2 * 1600 * 196 * 14 * 2 of factors, 218
// MB (0.065 ms), against 2.0e10 operations (0.02 ms): bound by bytes.
//
// The head dim. A bf16 row of 80 is 160 bytes and the 128-byte swizzle spans
// 128, so every tile of q, k and v is two TMA boxes with two tensor maps:
// columns 0-63 in the 128-byte swizzle (rows of 128 bytes) and 64-79 in the
// 32-byte swizzle (rows of 32 bytes). Q K^T runs four k16 steps on the first
// part and its fifth on the second; P V splits N = 80 into wgmma.m64n64k16
// and wgmma.m64n16k16 on the two parts of V (MN-major through the transpose
// bit). No byte of padding is read from device memory.
//
// Where a lane's values lie (kernels/flash_attention.py
// relpos_wgmma_fragment mirrors this index arithmetic, and the CPU tests
// hold it to relpos_bias): accumulator register 4 j + e of lane l in warp w
// of a consumer warpgroup holds warpgroup row 16 w + l / 4 + 8 (e / 2) and
// column 8 j + 2 (l % 4) + e % 2 of the m64nN tile.
//
// K4 design (grid (S / 192, BH), one block of four warpgroups per SM):
// * Warpgroup 3 is the producer (setmaxnreg 32): one thread issues every TMA
//   load, Q's three 64-row slices once, then 128-key K and V tiles (2 boxes
//   each, 20 KB) into a ring of kStages stages with full and empty
//   mbarriers, as K3 (csrc/flash_attention_wgmma.cu) does.
// * Warpgroups 0 to 2 are the consumers (setmaxnreg 160), 64 query rows
//   each: S = Q K^T by wgmma.m64n128k16 (64 registers), O by m64n64k16 and
//   m64n16k16 (40), P in bf16 (32), bias_w (32). Tile t's Q K^T is issued
//   once tile t - 1's P V is in (kOverlap off), so scores and P are never
//   live at once and a consumer fits 160 registers; the consumers take
//   turns to issue their products (pingpong), as in K3. Measured
//   (tools/kernel_variants.py): two consumers of 240 registers with Q K^T
//   issued before the previous P V are 4-7% slower at SAM ViT-H's batch
//   of 4 (and 4% faster at one frame, 16 heads: fewer, fuller waves);
//   three with that overlap spill.
// * The bias in the accumulator layout. With kw = 64 a 128-key tile is grid
//   rows 2 t and 2 t + 1, and a lane's columns 8 j + 2 (l % 4) + {0, 1} have
//   kx = 8 (j % 8) + 2 (l % 4) + {0, 1}, the same for every tile: the lane
//   loads its 2 rows x 16 values of bias_w once, from device memory into
//   registers, in log2 units. bias_h takes two values a row a tile, from a
//   table of the block's rows in shared memory (a row stride of 33 words:
//   the eight rows of a warp's reads fall in eight banks); it stays out of
//   the scores and shifts each half-row's max and exponent instead: per
//   score one FMA (x = s * scale * log2(e) + bias_w), one max, one add and
//   the ex2.
// * The running max is raised only when a row outgrows it by 2^8, as in K3.
//   Keys past S (an odd kh) are masked to -inf; query rows past S are not
//   written.
//
// K5 design (a persistent grid of one block a SM, each walking windows g,
// g + grid, ...):
// * The producer keeps a ring of kWStages windows: Q (200 rows), K and V
//   (208 rows; rows past 196 of a window are zero-filled by the TMA, the
//   maps being 3-D over (G, S, 80)), in two boxes each, and the window's
//   two factor tables (196 x 14 bf16, contiguous) by plain bulk copies: 107
//   KB a stage, two stages in 218 KB. While the consumers finish window g,
//   window g + grid is in flight.
// * The 196 query rows are four 64-row m-tiles; consumer w takes m-tiles w
//   and w + 2. S = Q K^T is one wgmma.m64n200k16 chain (100 registers): the
//   row's 196 keys at once, so the softmax is the window's plain softmax.
//   The fourth m-tile holds 4 real rows; its descriptor reads past the Q
//   rows into the stage's next buffer, and those rows are never written.
// * The bias from the stage's factor tables: a lane's key pair (8 j + 2 (l
//   % 4), + 1) lies in one grid row (kx even), so one bias_h read and one
//   4-byte bias_w read serve both. Keys 196..199 are masked; P V runs 13 k16
//   steps (keys 0..207), P being 0 and V zero past 196.
// * Tensor work wasted on padding (256 query rows, 200 and 208 keys) is
//   cheap: the bound is bytes. Measured (tools/kernel_variants.py): one
//   consumer walking the four m-tiles, two blocks an SM (one consumer and
//   one window each) and the consumers taking turns to issue their products
//   are none of them faster.
//
// Host: the six CUtensorMaps of a call (two for each of q, k and v) are
// encoded on every call through bff_wg::encode_tiled; a failed lookup,
// encode or launch returns non-zero and the wrapper raises: nothing falls
// back to another kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <algorithm>

#include "attention_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace bff_wg;

constexpr int kD = 80;                // SAM ViT-H's head dim
constexpr int kLo = 64;               // columns in the 128-byte-swizzle box
constexpr int kHi = kD - kLo;         // columns in the 32-byte-swizzle box
constexpr int kLoRow = 2 * kLo;       // bytes of a row of each part
constexpr int kHiRow = 2 * kHi;
constexpr float kL2e = bff_tc::kLog2e;

// ------------------------------------------------------------------ K4
constexpr int kGridW = 64;            // the key grid's width (kw) K4 takes
constexpr int kMaxGridH = 64;         // and its largest height (kh)
constexpr int kConsumers = 3;         // consumer warpgroups of 64 query rows each
constexpr int kBM = 64 * kConsumers;  // query rows of a block
constexpr int kBN = 128;              // keys of a tile: grid rows 2 t and 2 t + 1
constexpr int kStages = 2;            // K and V tiles in flight
constexpr bool kOverlap = false;      // issue Q K^T of tile t before P V of tile t - 1
constexpr bool kPingpong = true;      // the consumers take turns to issue their products
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = kConsumers == 2 ? 24 : 32;
constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
constexpr int kTileLo = kBN * kLoRow;        // 16 KB
constexpr int kTileBytes = kBN * kD * 2;     // 20 KB: the lo box, then the hi box
constexpr int kQSliceLo = 64 * kLoRow;       // a consumer's rows of Q, lo part
constexpr int kQSliceHi = 64 * kHiRow;       // and hi part
constexpr int kQBytes = kBM * kD * 2;
constexpr int kBhLd = kMaxGridH + 2;         // bias_h table row: 66 elements, 33 words
constexpr int kBhBytes = kBM * kBhLd * 2;
constexpr int kConsumerWarps = 4 * kConsumers;
// Q (lo parts, then hi parts), the K and V rings, the bias_h table, the
// barriers, and room to align the start to 1024 bytes
constexpr int kSmemBytes = kQBytes + 2 * kStages * kTileBytes + kBhBytes + 128 + 1024;
constexpr float kLazy = 8.f;  // log2(2^8): the largest p is 2^8

struct Barriers {
  uint64_t q_full;
  uint64_t k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
};

// S = Q K^T for the warpgroup's 64 rows and the 128 keys of a tile: four
// k-steps on the 128-byte-swizzle part, the fifth on the 32-byte part.
__device__ __forceinline__ void issue_scores(float (&s)[64], uint32_t q_lo, uint32_t q_hi,
                                             uint32_t k_lo, uint32_t k_hi) {
#pragma unroll
  for (int kk = 0; kk < kLo / 16; ++kk)
    wgmma_m64n128k16_ss(s, sw128_desc(q_lo + kk * 32, 16), sw128_desc(k_lo + kk * 32, 16), kk);
  wgmma_m64n128k16_ss(s, sw32_desc(q_hi, 16), sw32_desc(k_hi, 16), 1);
}

// O += P V for the 128 keys of a V tile (k-step kk: keys 16 kk .. 16 kk +
// 15, 2048 bytes on in the lo part, 512 in the hi part).
__device__ __forceinline__ void issue_pv(float (&o_lo)[32], float (&o_hi)[8],
                                         const uint32_t (&p)[8][4], uint32_t v_lo,
                                         uint32_t v_hi) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    wgmma_m64n64k16_rs(o_lo, p[kk], sw128_desc(v_lo + kk * 2048, 1024));
    wgmma_m64n16k16_rs(o_hi, p[kk], sw32_desc(v_hi + kk * 512, 256));
  }
}

// The online softmax of one score tile in place, with the bias: bw[h][2 i +
// e] is bias_w of row h at kx = 8 i + 2 (lane % 4) + e, bhl[h][half] bias_h
// of row h at grid row 2 t + half, both in log2 units. Keys >= S (from k0
// on) masked when ``ragged``; the running max m (log2 units) raised where a
// row outgrows it by kLazy; l rescaled and summed; s turned into p. Returns
// the factors the output rows must be rescaled by (1 where the max stayed).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2,
                                             const float (&bw)[2][16], const float (&bhl)[2][2],
                                             bool ragged, int k0, int S) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int i = j & 7;
    s[4 * j] = fmaf(s[4 * j], sl2, bw[0][2 * i]);
    s[4 * j + 1] = fmaf(s[4 * j + 1], sl2, bw[0][2 * i + 1]);
    s[4 * j + 2] = fmaf(s[4 * j + 2], sl2, bw[1][2 * i]);
    s[4 * j + 3] = fmaf(s[4 * j + 3], sl2, bw[1][2 * i + 1]);
  }
  if (ragged) {
    const int c = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + 8 * j + (e & 1) >= S) s[4 * j + e] = bff_tc::masked_score();
  }
  // the max of each half-row (one grid row of keys each), then the row's
  // max with bias_h added
  float mh[2][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mh[0][half] = mh[1][half] = bff_tc::masked_score();
#pragma unroll
    for (int j = 8 * half; j < 8 * half + 8; ++j) {
      mh[0][half] = fmaxf(mh[0][half], fmaxf(s[4 * j], s[4 * j + 1]));
      mh[1][half] = fmaxf(mh[1][half], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  }
  float mx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mh[h][0] + bhl[h][0], mh[h][1] + bhl[h][1]);
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  corr[0] = corr[1] = 1.f;
  if (__any_sync(0xffffffffu, mx[0] > m[0] + kLazy || mx[1] > m[1] + kLazy)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = bff_tc::exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
  }
  // p = 2^(x + bias_h - m): one add and the ex2
  float c[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int half = 0; half < 2; ++half) c[h][half] = bhl[h][half] - m[h];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int half = j / 8;
    s[4 * j] = bff_tc::exp2_approx(s[4 * j] + c[0][half]);
    s[4 * j + 1] = bff_tc::exp2_approx(s[4 * j + 1] + c[0][half]);
    s[4 * j + 2] = bff_tc::exp2_approx(s[4 * j + 2] + c[1][half]);
    s[4 * j + 3] = bff_tc::exp2_approx(s[4 * j + 3] + c[1][half]);
    l[0] += s[4 * j] + s[4 * j + 1];
    l[1] += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P in bf16 as the A fragments of the k-steps of P V: step kk takes the
// accumulator's n8 tiles 2 kk and 2 kk + 1; fragments past the N columns
// of s are 0.
template <int KS, int N>
__device__ __forceinline__ void pack_p(uint32_t (&p)[KS][4], const float (&s)[N]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = 8 * kk + 2 * i;
      p[kk][i] = a + 1 < N ? bff_tc::pack_bf16(s[a < N ? a : 0], s[a + 1 < N ? a + 1 : 0]) : 0u;
    }
}

__device__ __forceinline__ void rescale(float (&o_lo)[32], float (&o_hi)[8],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o_lo[4 * j] *= corr[0];
    o_lo[4 * j + 1] *= corr[0];
    o_lo[4 * j + 2] *= corr[1];
    o_lo[4 * j + 3] *= corr[1];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    o_hi[4 * j] *= corr[0];
    o_hi[4 * j + 1] *= corr[0];
    o_hi[4 * j + 2] *= corr[1];
    o_hi[4 * j + 3] *= corr[1];
  }
}

// A consumer warp's 16 rows from row0 on (rows >= S not written), divided
// by their denominators in f32 and rounded once.
__device__ __forceinline__ void store_rows(const float (&o_lo)[32], const float (&o_hi)[8],
                                           float (&l)[2], __nv_bfloat16* __restrict__ o,
                                           int row0, int S) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __nv_bfloat16* ob = o + static_cast<long long>(row0) * kD + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row0 + 8 * h < S) {
      __nv_bfloat16* orow = ob + 8 * h * kD;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            bff_tc::pack_bf16(o_lo[4 * j + 2 * h] / l[h], o_lo[4 * j + 2 * h + 1] / l[h]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint32_t*>(orow + kLo + 8 * j) =
            bff_tc::pack_bf16(o_hi[4 * j + 2 * h] / l[h], o_hi[4 * j + 2 * h + 1] / l[h]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_relpos_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq_lo, const __grid_constant__ CUtensorMap tq_hi,
    const __grid_constant__ CUtensorMap tk_lo, const __grid_constant__ CUtensorMap tk_hi,
    const __grid_constant__ CUtensorMap tv_lo, const __grid_constant__ CUtensorMap tv_hi,
    const __nv_bfloat16* __restrict__ bias_h, const __nv_bfloat16* __restrict__ bias_w,
    __nv_bfloat16* __restrict__ o, int S, int kh, float sl2) {
  static_assert(kConsumers == 2 || kConsumers == 3, "two or three consumer warpgroups");
  extern __shared__ __align__(1024) unsigned char rp_smem_raw[];
  unsigned char* smem = rp_smem_raw + ((1024 - (smem_u32(rp_smem_raw) & 1023)) & 1023);
  unsigned char* sQlo = smem;                         // consumer c at c * kQSliceLo
  unsigned char* sQhi = sQlo + kConsumers * kQSliceLo;  // consumer c at c * kQSliceHi
  unsigned char* sK = sQhi + kConsumers * kQSliceHi;  // stage st at st * kTileBytes
  unsigned char* sV = sK + kStages * kTileBytes;
  __nv_bfloat16* sBh = reinterpret_cast<__nv_bfloat16*>(sV + kStages * kTileBytes);
  Barriers* bars = reinterpret_cast<Barriers*>(sV + kStages * kTileBytes + kBhBytes);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (S + kBN - 1) / kBN;
  // the block's rows of bias_h, zero past S and past kh (an odd kh's last
  // tile reads column kh for its masked keys)
  const __nv_bfloat16* bhg = bias_h + static_cast<long long>(bh) * S * kh;
  for (int i = threadIdx.x; i < kBM * kBhLd; i += kThreads) {
    const int r = i / kBhLd, c = i - r * kBhLd, gr = q0 + r;
    sBh[i] = gr < S && c < kh ? bhg[static_cast<long long>(gr) * kh + c] : __float2bfloat16(0.f);
  }
  if (threadIdx.x == 0) {
    bar_init(&bars->q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      bar_init(&bars->k_full[st], 1);
      bar_init(&bars->v_full[st], 1);
      bar_init(&bars->k_empty[st], kConsumerWarps);
      bar_init(&bars->v_empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 128 * kConsumers) {
      bar_expect_tx(&bars->q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c) {
        tma_load_3d(sQlo + c * kQSliceLo, &tq_lo, &bars->q_full, 0, q0 + 64 * c, bh);
        tma_load_3d(sQhi + c * kQSliceHi, &tq_hi, &bars->q_full, kLo, q0 + 64 * c, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages, parity = ((t / kStages) & 1) ^ 1;
        unsigned char* kt = sK + st * kTileBytes;
        unsigned char* vt = sV + st * kTileBytes;
        bar_wait(&bars->k_empty[st], parity);
        bar_expect_tx(&bars->k_full[st], kTileBytes);
        tma_load_3d(kt, &tk_lo, &bars->k_full[st], 0, t * kBN, bh);
        tma_load_3d(kt + kTileLo, &tk_hi, &bars->k_full[st], kLo, t * kBN, bh);
        bar_wait(&bars->v_empty[st], parity);
        bar_expect_tx(&bars->v_full[st], kTileBytes);
        tma_load_3d(vt, &tv_lo, &bars->v_full[st], 0, t * kBN, bh);
        tma_load_3d(vt + kTileLo, &tv_hi, &bars->v_full[st], kLo, t * kBN, bh);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int lane = threadIdx.x & 31;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const uint32_t q_lo = smem_u32(sQlo) + wg * kQSliceLo;
    const uint32_t q_hi = smem_u32(sQhi) + wg * kQSliceHi;
    const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
    const bool ragged = S % kBN != 0;
    // the lane's rows of the block (h = 0, 1: rb and rb + 8)
    const int rb = wg * 64 + ((threadIdx.x / 32) & 3) * 16 + lane / 4;

    // bias_w at the lane's 16 columns for both rows, in log2 units: the same
    // for every key tile
    float bw[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = q0 + rb + 8 * h;
      const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(
          bias_w + (static_cast<long long>(bh) * S + min(gr, S - 1)) * kGridW + 2 * (lane & 3));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 w = __bfloat1622float2(src[4 * i]);
        bw[h][2 * i] = gr < S ? w.x * kL2e : 0.f;
        bw[h][2 * i + 1] = gr < S ? w.y * kL2e : 0.f;
      }
    }
    const __nv_bfloat16* bh_rows[2] = {sBh + rb * kBhLd, sBh + (rb + 8) * kBhLd};
    // bias_h of the tile's two grid rows, log2 units
    auto tile_bh = [&](int t, float (&bhl)[2][2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 b =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bh_rows[h] + 2 * t));
        bhl[h][0] = b.x * kL2e;
        bhl[h][1] = b.y * kL2e;
      }
    };

    float s[64] = {}, o_lo[32] = {}, o_hi[8] = {};
    uint32_t p[8][4] = {};
    float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, l[2] = {0.f, 0.f}, corr[2], bhl[2][2];

    // Pingpong as in K3: consumer w issues its round's products after
    // turn_sync(1 + w) and hands the turn on; consumer 0 takes the first
    // turn and the surplus one after its loop. No branch stands between an
    // issue and its wait.
    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
    if (kPingpong && wg == kConsumers - 1) turn_arrive(next_turn);
    auto fence_for_issue = [&]() {
      fence_regs(o_lo);
      fence_regs(o_hi);
      fence_regs(p);
      fence_regs(s);
      wgmma_fence();
    };
    auto hand_on = [&]() {
      if (kPingpong) turn_arrive(next_turn);
    };

    bar_wait(&bars->q_full, 0);
    // tile 0: scores, softmax, P
    bar_wait(&bars->k_full[0], 0);
    if (kPingpong) turn_sync(my_turn);
    fence_for_issue();
    issue_scores(s, q_lo, q_hi, k_base, k_base + kTileLo);
    wgmma_commit();
    hand_on();
    tile_bh(0, bhl);
    wgmma_wait<0>();
    fence_regs(s);
    if (signals) bar_arrive(&bars->k_empty[0]);
    softmax_tile(s, m, l, corr, sl2, bw, bhl, ragged && n_tiles == 1, 0, S);
    pack_p(p, s);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % kStages, parity = (t / kStages) & 1;
      const int pst = (t - 1) % kStages, pparity = ((t - 1) / kStages) & 1;
      const uint32_t kt = k_base + st * kTileBytes, vt = v_base + pst * kTileBytes;
      if constexpr (kOverlap) {
        bar_wait(&bars->k_full[st], parity);
        bar_wait(&bars->v_full[pst], pparity);
        if (kPingpong) turn_sync(my_turn);
        fence_for_issue();
        issue_scores(s, q_lo, q_hi, kt, kt + kTileLo);
        wgmma_commit();
        issue_pv(o_lo, o_hi, p, vt, vt + kTileLo);
        wgmma_commit();
        hand_on();
        tile_bh(t, bhl);
        wgmma_wait<1>();  // the scores are in
        fence_regs(s);
        if (signals) bar_arrive(&bars->k_empty[st]);
        softmax_tile(s, m, l, corr, sl2, bw, bhl, ragged && t == n_tiles - 1, t * kBN, S);
        wgmma_wait<0>();  // P V of tile t - 1 is in
        fence_regs(o_lo);
        fence_regs(o_hi);
        fence_regs(p);
        fence_regs(s);
        if (signals) bar_arrive(&bars->v_empty[pst]);
        rescale(o_lo, o_hi, corr);
        pack_p(p, s);
      } else {
        bar_wait(&bars->v_full[pst], pparity);
        fence_for_issue();
        issue_pv(o_lo, o_hi, p, vt, vt + kTileLo);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o_lo);
        fence_regs(o_hi);
        if (signals) bar_arrive(&bars->v_empty[pst]);
        bar_wait(&bars->k_full[st], parity);
        if (kPingpong) turn_sync(my_turn);
        fence_for_issue();
        issue_scores(s, q_lo, q_hi, kt, kt + kTileLo);
        wgmma_commit();
        hand_on();
        tile_bh(t, bhl);
        wgmma_wait<0>();
        fence_regs(s);
        if (signals) bar_arrive(&bars->k_empty[st]);
        softmax_tile(s, m, l, corr, sl2, bw, bhl, ragged && t == n_tiles - 1, t * kBN, S);
        rescale(o_lo, o_hi, corr);
        pack_p(p, s);
      }
    }
    if (kPingpong && wg == 0) turn_sync(my_turn);  // the last consumer's last turn
    // P V of the last tile
    const int lst = (n_tiles - 1) % kStages, lparity = ((n_tiles - 1) / kStages) & 1;
    const uint32_t vt = v_base + lst * kTileBytes;
    bar_wait(&bars->v_full[lst], lparity);
    fence_for_issue();
    issue_pv(o_lo, o_hi, p, vt, vt + kTileLo);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_lo);
    fence_regs(o_hi);
    store_rows(o_lo, o_hi, l, o + static_cast<long long>(bh) * S * kD, q0 + rb, S);
  }
}

// ------------------------------------------------------------------ K5
constexpr int kWin = 14;              // the window's side (wh = ww)
constexpr int kWinS = kWin * kWin;    // its tokens: 196
constexpr int kWQRows = 200;          // Q rows loaded (rows 196.. zero-filled)
constexpr int kWKRows = 208;          // K and V rows loaded: 13 k16 steps of P V
constexpr int kWKeys = 200;           // the keys of S = Q K^T (n200)
constexpr int kWMTiles = 4;           // 64-row m-tiles over 196 rows
constexpr int kWConsumers = 2;        // consumer warpgroups; w takes m-tiles w, w + kWConsumers
constexpr int kWStages = 2;           // windows in flight
constexpr int kWBlocksPerSM = 1;
constexpr int kWThreads = 128 * (kWConsumers + 1);
constexpr int kWProducerRegs = 24;
constexpr int kWConsumerRegs = 240;
constexpr int kWFactor = kWinS * kWin * 2;  // one factor table of a window: 5488 bytes
constexpr int align1k(int x) { return (x + 1023) / 1024 * 1024; }
// a stage: Q lo, Q hi, K lo, K hi, V lo, V hi, bias_h, bias_w
constexpr int kWQLo = 0;
constexpr int kWQHi = kWQLo + kWQRows * kLoRow;           // 25 600
constexpr int kWKLo = kWQHi + align1k(kWQRows * kHiRow);  // + 7 168
constexpr int kWKHi = kWKLo + kWKRows * kLoRow;           // + 26 624
constexpr int kWVLo = kWKHi + align1k(kWKRows * kHiRow);
constexpr int kWVHi = kWVLo + kWKRows * kLoRow;
constexpr int kWFh = kWVHi + align1k(kWKRows * kHiRow);
constexpr int kWFw = kWFh + kWFactor;
constexpr int kWStage = align1k(kWFw + kWFactor);         // 111 616
constexpr int kWTx = (kWQRows + 2 * kWKRows) * kD * 2 + 2 * kWFactor;  // bytes a window
constexpr int kWSmemBytes = kWStages * kWStage + 128 + 1024;
static_assert(kWQHi + 64 * 4 * kHiRow <= kWStage, "the fourth m-tile reads inside its stage");

struct WBarriers {
  uint64_t full[kWStages], empty[kWStages];
};

__global__ void __launch_bounds__(kWThreads, kWBlocksPerSM) window_relpos_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq_lo, const __grid_constant__ CUtensorMap tq_hi,
    const __grid_constant__ CUtensorMap tk_lo, const __grid_constant__ CUtensorMap tk_hi,
    const __grid_constant__ CUtensorMap tv_lo, const __grid_constant__ CUtensorMap tv_hi,
    const __nv_bfloat16* __restrict__ bias_h, const __nv_bfloat16* __restrict__ bias_w,
    __nv_bfloat16* __restrict__ o, int G, float scale) {
  static_assert(kWConsumers == 1 || kWConsumers == 2, "one or two consumer warpgroups");
  extern __shared__ __align__(1024) unsigned char wp_smem_raw[];
  unsigned char* smem = wp_smem_raw + ((1024 - (smem_u32(wp_smem_raw) & 1023)) & 1023);
  WBarriers* bars = reinterpret_cast<WBarriers*>(smem + kWStages * kWStage);
  // zero the stages once, so the bytes no TMA writes (the padding the fourth
  // m-tile reads) are finite; then order those writes before the TMA's
  for (int i = threadIdx.x; i < kWStages * kWStage / 16; i += kWThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kWStages; ++st) {
      bar_init(&bars->full[st], 1);
      bar_init(&bars->empty[st], 4 * kWConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWProducerRegs) : "memory");
    if (threadIdx.x == 128 * kWConsumers) {
      int it = 0;
      for (int g = blockIdx.x; g < G; g += gridDim.x, ++it) {
        const int st = it % kWStages, parity = ((it / kWStages) & 1) ^ 1;
        unsigned char* sb = smem + st * kWStage;
        uint64_t* full = &bars->full[st];
        bar_wait(&bars->empty[st], parity);
        bar_expect_tx(full, kWTx);
        tma_load_3d(sb + kWQLo, &tq_lo, full, 0, 0, g);
        tma_load_3d(sb + kWQHi, &tq_hi, full, kLo, 0, g);
        tma_load_3d(sb + kWKLo, &tk_lo, full, 0, 0, g);
        tma_load_3d(sb + kWKHi, &tk_hi, full, kLo, 0, g);
        tma_load_3d(sb + kWVLo, &tv_lo, full, 0, 0, g);
        tma_load_3d(sb + kWVHi, &tv_hi, full, kLo, 0, g);
        const long long f = static_cast<long long>(g) * kWinS * kWin;
        bulk_load(sb + kWFh, bias_h + f, kWFactor, full);
        bulk_load(sb + kWFw, bias_w + f, kWFactor, full);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWConsumerRegs) : "memory");
    const int lane = threadIdx.x & 31, quad = lane & 3;
    const int wrow = ((threadIdx.x / 32) & 3) * 16 + lane / 4;  // the lane's row of an m-tile
    int it = 0;
    for (int g = blockIdx.x; g < G; g += gridDim.x, ++it) {
      const int st = it % kWStages;
      unsigned char* sb = smem + st * kWStage;
      const uint32_t base = smem_u32(sb);
      const __nv_bfloat16* fh = reinterpret_cast<const __nv_bfloat16*>(sb + kWFh);
      const __nv_bfloat16* fw = reinterpret_cast<const __nv_bfloat16*>(sb + kWFw);
      bar_wait(&bars->full[st], (it / kWStages) & 1);
#pragma unroll 1
      for (int mt = wg; mt < kWMTiles; mt += kWConsumers) {
        float s[kWKeys / 2];
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kLo / 16; ++kk)
          wgmma_m64n200k16_ss(s, sw128_desc(base + kWQLo + mt * 64 * kLoRow + kk * 32, 16),
                              sw128_desc(base + kWKLo + kk * 32, 16), kk);
        wgmma_m64n200k16_ss(s, sw32_desc(base + kWQHi + mt * 64 * kHiRow, 16),
                            sw32_desc(base + kWKHi, 16), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

        // logits with the bias (natural units); a row's max; p; l
        const int r0 = mt * 64 + wrow;  // rows r0 and r0 + 8 (rows >= 196 read row 195)
        const __nv_bfloat16* frh[2] = {fh + min(r0, kWinS - 1) * kWin,
                                       fh + min(r0 + 8, kWinS - 1) * kWin};
        const __nv_bfloat16* frw[2] = {fw + min(r0, kWinS - 1) * kWin,
                                       fw + min(r0 + 8, kWinS - 1) * kWin};
        float mx[2] = {bff_tc::masked_score(), bff_tc::masked_score()};
#pragma unroll
        for (int j = 0; j < kWKeys / 8; ++j) {
          const int c = 8 * j + 2 * quad;  // the lane's key pair c, c + 1 (one grid row)
          const int ky = c / kWin, kx = c - ky * kWin;
          const bool in = c < kWinS;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int u = in ? ky : 0, w = in ? kx : 0;
            const float b = __bfloat162float(frh[h][u]);
            const float2 bw = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(frw[h] + w));
            const float x0 = fmaf(s[4 * j + 2 * h], scale, b + bw.x);
            const float x1 = fmaf(s[4 * j + 2 * h + 1], scale, b + bw.y);
            s[4 * j + 2 * h] = in ? x0 : bff_tc::masked_score();
            s[4 * j + 2 * h + 1] = in ? x1 : bff_tc::masked_score();
            mx[h] = fmaxf(mx[h], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
          }
        }
        float l[2] = {0.f, 0.f}, nm[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          nm[h] = -mx[h] * kL2e;
        }
#pragma unroll
        for (int j = 0; j < kWKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[4 * j + e] = bff_tc::exp2_approx(fmaf(s[4 * j + e], kL2e, nm[e / 2]));
            l[e / 2] += s[4 * j + e];
          }
        uint32_t p[kWKRows / 16][4];
        pack_p(p, s);

        // O = P V over 13 k16 steps (keys 0..207)
        float o_lo[32], o_hi[8];
        fence_regs(o_lo);
        fence_regs(o_hi);
        fence_regs(p);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWKRows / 16; ++kk) {
          wgmma_m64n64k16_rs(o_lo, p[kk], sw128_desc(base + kWVLo + kk * 2048, 1024), kk);
          wgmma_m64n16k16_rs(o_hi, p[kk], sw32_desc(base + kWVHi + kk * 512, 256), kk);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o_lo);
        fence_regs(o_hi);
        store_rows(o_lo, o_hi, l, o + static_cast<long long>(g) * kWinS * kD, mt * 64 + wrow,
                   kWinS);
      }
      if (lane == 0) bar_arrive(&bars->empty[st]);  // one arrival per consumer warp
    }
  }
}

// The six maps of q, k and v: a 128-byte-swizzle box of columns 0-63 and a
// 32-byte-swizzle box of columns 64-79 for each, ``q_rows`` and ``kv_rows``
// rows a box, over (n, S, 80).
int encode_maps(CUtensorMap (&maps)[6], const void* q, const void* k, const void* v, int n,
                int S, int q_rows, int kv_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const void* base[3] = {q, k, v};
  int rc = 0;
  for (int i = 0; i < 3 && rc == 0; ++i) {
    const int rows = i == 0 ? q_rows : kv_rows;
    rc = encode_3d(fn, &maps[2 * i], base[i], kD, S, n, kLo, rows, CU_TENSOR_MAP_SWIZZLE_128B);
    if (rc == 0)
      rc = encode_3d(fn, &maps[2 * i + 1], base[i], kD, S, n, kHi, rows,
                     CU_TENSOR_MAP_SWIZZLE_32B);
  }
  return rc;
}

bool aligned(const void* q, const void* k, const void* v, const void* o, const void* bh,
             const void* bw) {
  return aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) && aligned16(bh) &&
         aligned16(bw);
}

}  // namespace

// The routing predicate (kernels/flash_attention.py relpos_wgmma_route
// mirrors it): 1 when bff_flash_attention_relpos (kind 0, K4; rows x cols =
// kh x kw) or bff_window_attention_relpos (kind 1, K5; wh x ww) takes the
// wgmma kernel for the call. dtype: 0 = float32, 1 = bfloat16.
extern "C" int bff_relpos_wgmma_takes(int kind, int dtype, int D, int S, int rows, int cols,
                                      float scale, const void* q, const void* k, const void* v,
                                      const void* o, const void* bias_h, const void* bias_w) {
  const bool shape = kind == 0   ? cols == kGridW && rows >= 1 && rows <= kMaxGridH &&
                                     S == rows * cols
                     : kind == 1 ? rows == kWin && cols == kWin && S == kWinS
                                 : false;
  return shape && dtype == 1 && D == kD && scale > 0.f && scale <= FLT_MAX &&
         aligned(q, k, v, o, bias_h, bias_w);
}

// K4. q, k, v, o: contiguous (BH, S, 80) bf16 with S = kh * 64; bias_h (BH,
// S, kh), bias_w (BH, S, 64) bf16. Returns cudaGetLastError() after the
// launch, -1 for arguments outside the predicate, -2 when the driver's
// cuTensorMapEncodeTiled is not found, -3 for a misaligned base or stride,
// -1000 - CUresult for a failed encode.
extern "C" int bff_flash_relpos_wgmma(const void* q, const void* k, const void* v,
                                      const void* bias_h, const void* bias_w, void* o, int BH,
                                      int S, int kh, float scale, void* stream) {
  if (BH < 1 || !bff_relpos_wgmma_takes(0, 1, kD, S, kh, kGridW, scale, q, k, v, o, bias_h,
                                        bias_w))
    return -1;
  CUtensorMap maps[6];
  const int rc = encode_maps(maps, q, k, v, BH, S, 64, kBN);
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_relpos_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + kBM - 1) / kBM, BH);
  flash_relpos_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<const __nv_bfloat16*>(bias_h), static_cast<const __nv_bfloat16*>(bias_w),
      static_cast<__nv_bfloat16*>(o), S, kh, scale * kL2e);
  return (int)cudaGetLastError();
}

// K5. q, k, v, o: contiguous (G, 196, 80) bf16; bias_h, bias_w (G, 196, 14)
// bf16. Return codes as bff_flash_relpos_wgmma's.
extern "C" int bff_window_relpos_wgmma(const void* q, const void* k, const void* v,
                                       const void* bias_h, const void* bias_w, void* o, int G,
                                       float scale, void* stream) {
  if (G < 1 || !bff_relpos_wgmma_takes(1, 1, kD, kWinS, kWin, kWin, scale, q, k, v, o, bias_h,
                                       bias_w))
    return -1;
  CUtensorMap maps[6];
  const int rc = encode_maps(maps, q, k, v, G, kWinS, kWQRows, kWKRows);
  if (rc != 0) return rc;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(window_relpos_wgmma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmemBytes);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const int grid = std::min(G, kWBlocksPerSM * sms);
  window_relpos_wgmma_kernel<<<grid, kWThreads, kWSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<const __nv_bfloat16*>(bias_h), static_cast<const __nv_bfloat16*>(bias_w),
      static_cast<__nv_bfloat16*>(o), G, scale);
  return (int)cudaGetLastError();
}
