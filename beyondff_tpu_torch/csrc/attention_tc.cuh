// One flash-attention block for bf16 inputs on Hopper's tensor cores
// (sm_90a), shared by bff_flash_attention (csrc/flash_attention.cu: K2/K3,
// a key mask) and csrc/relpos_attention.cu (K4, SAM's decomposed rel-pos
// bias over the global grid, and K5, the same bias over G windows of at
// most 256 tokens). They differ only in a score modifier passed as a
// functor: ``mod.tile(k0)`` says what a lane needs of the key tile at k0
// (once per tile), and ``mod.apply(s, tile, r0, scale, shift)`` turns the
// raw Q K^T fragment of block rows r0 (+ 8) into logits in place, scaled
// and biased or masked; a per-row constant of the tile may stay out of the
// scores and come back in ``shift`` (it moves the row's max, not its
// softmax).
//
// Ragged edges: a key tile that holds fewer than 64 keys runs only the k16
// steps (16 keys each) that hold any (SAM's 14 x 14 windows: S = 196 is
// three whole tiles and one of 4 keys, one k16 step of four), and a warp
// whose query rows all lie at or past S skips the tile.
//
// Design (a block of WARPS warps, each warp MT m16 tiles = 16 MT query rows):
// * Both products on the tensor cores: mma.sync.m16n8k16.row.col, bf16 in,
//   f32 accumulate. Fragments come from shared memory by ldmatrix (.trans
//   for V). mma.sync and not wgmma: the head dims here are 80 (SAM ViT-H)
//   and 32 (Grounding-DINO), whole k16 steps but not the 64-element rows
//   that wgmma's swizzled shared-memory descriptors want. Head dim 64 with
//   every key valid (K3) takes csrc/flash_attention_wgmma.cu instead.
// * Shared memory, not the tensor cores, sets the pace: every warp reads
//   the whole K and V tile by ldmatrix, at 128 bytes a clock per SM. A warp
//   therefore owns MT m16 tiles and feeds each K and V fragment it reads to
//   all of them (MT = 2 halves the bytes per operation).
// * The 64-key score tile stays in the f32 accumulator fragments; the
//   online max and denominator are taken there with quad shuffles, and the
//   probabilities are converted to bf16 in registers and reused as the A
//   operand of P V (the m16n8 accumulator layout pairs up into the
//   m16n8k16 A layout). No score ever goes through shared memory. Q's A
//   fragments are read from shared memory at each k16 step.
// * The scale (and the bias, by the modifier) are folded into the scores;
//   exponentials are one FMA (times log2(e), minus the row's max) and one
//   ex2.approx. The running max is raised only when a row's tile max passes
//   it by more than ln(2^8) (every lane of the warp agreeing), so most
//   steps skip the rescale of the output; the probabilities then lie in
//   (0, 2^8], far from f32's range.
// * K and V tiles stay bf16 in shared memory, rows padded to DP + 8
//   elements: (DP + 8) / 8 is odd for every DP that is a multiple of 16, so
//   the eight 16-byte rows of one ldmatrix phase hit eight distinct bank
//   groups. A ring of two stages is filled by cp.async.cg 16-byte copies
//   (zero-filled past S and past D), so tile t + 1 loads while tile t
//   computes.
// * Precision, as the TPU kernels (beyondff_tpu/kernels/flash_attention.py
//   :55-57, :180-182, :302-305): P is rounded to bf16 before P V, the
//   denominator is summed from the f32 probabilities, and the output is
//   divided by it in f32 and rounded once.
//
// Shared memory: (ROWS + 4 x 64) x (DP + 8) x 2 bytes with ROWS = 16 WARPS
// MT, plus what the caller appends after it. Takes D % 8 == 0 and 16-byte
// aligned q, k, v (the cp.async granule); the callers route other bf16
// inputs to their FMA kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bff_tc {

constexpr int kBK = 64;      // keys of a tile
constexpr int NS = kBK / 8;  // n8 tiles of a score row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kInitMax = -1e30f;              // below every logit; replaced at the first tile
constexpr float kLazyMax = 5.545177444479562f;  // ln(2^8): the largest p is 2^8

__device__ __forceinline__ float masked_score() { return __int_as_float(0xff800000); }  // -inf

// 2^x on the special-function unit, one instruction (exp2f adds a range
// fix-up for subnormal results, which weigh nothing in a softmax).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A block's query rows, then the K ring and the V ring of two 64-key tiles.
template <int DP, int ROWS>
__host__ __device__ constexpr int smem_bytes() {
  return (ROWS + 4 * kBK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
}

// Where lane's accumulator values lie: s[j][e] of the m16n8 fragment of n8
// tile j holds row ``r0 + 8 * (e / 2)`` of the block (r0 = the m16 tile's
// first row + lane / 4) and column ``8 * j + col0() + e % 2`` of the tile.
__device__ __forceinline__ int col0() { return 2 * (threadIdx.x & 3); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
// 4 bytes by cp.async (through L1) of which the first ``bytes`` (0, 2 or 4)
// are read from src and the rest zero-filled (2: a bf16 pair whose second
// element lies past the end of its array).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// c += a b for one m16n8k16 tile: a the 16 x 16 row-major A fragment, b0 b1
// the 16 x 8 column-major B fragment.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [r0, r0 + ROWS) and features [f0, f0 + DP) of a row-major (S, D)
// bf16 matrix into a tile with row stride DP + 8, by cp.async from THREADS
// threads; rows >= S and features >= D are zero-filled. f0 is 0 but for
// the head-dim slices of attend_block_sliced (a multiple of DP).
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int S, int D, int f0 = 0) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (kTotal % THREADS == 0 || i < kTotal) {
      const int r = i / kChunks, c = (i % kChunks) * 8, gr = r0 + r;
      const bool in = gr < S && f0 + c < D;
      cp_async16(dst + r * (DP + 8) + c, in ? src + (long long)gr * D + f0 + c : src, in);
    }
  }
}

// A warp's output rows before the first key tile: no keys, max below all.
template <int DP, int MT>
__device__ __forceinline__ void init_rows(float (&acc)[MT][DP / 8][4], float (&m)[MT][2],
                                          float (&l)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kInitMax;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }
}

// A warp's 16 MT output rows from row0 on, divided by their denominators
// in f32 and rounded once, into features [c0, c0 + DP) of the (S, D)
// output; rows >= S and features >= D are not written.
template <int DP, int MT>
__device__ __forceinline__ void store_rows(const float (&acc)[MT][DP / 8][4],
                                           const float (&l)[MT][2], __nv_bfloat16* __restrict__ o,
                                           int row0, int S, int D, int c0 = 0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lsum = l[mt][h];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const int row = row0 + mt * 16 + lane / 4 + 8 * h;
      if (row < S) {
        __nv_bfloat16* orow = o + (long long)row * D + c0;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          const int c = 8 * n + col0();
          if (c0 + c < D)
            *reinterpret_cast<uint32_t*>(orow + c) =
                pack_bf16(acc[mt][n][2 * h] / lsum, acc[mt][n][2 * h + 1] / lsum);
        }
      }
    }
}

// S += Q K^T of one key tile for one warp, over the tile's first NK k16
// steps (16 keys each) and the DP features of the tiles: each K fragment
// feeds all MT m16 tiles.
template <int DP, int MT, int NK>
__device__ __forceinline__ void add_scores(float (&s)[MT][NS][4], const __nv_bfloat16* sQw,
                                           const __nv_bfloat16* kt) {
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;  // k16 steps of Q K^T
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], sQw + (mt * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NK; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(s[mt][2 * jp], a[mt], b[0], b[1]);
        mma_bf16(s[mt][2 * jp + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

template <int MT>
__device__ __forceinline__ void zero_scores(float (&s)[MT][NS][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NS; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
}

// What a score modifier declares beyond ``tile`` and ``apply``: ``kStaged``,
// that it stages each key tile's data into shared memory beside K and V
// (``stage(k0)``, issued by every thread with the tile's K and V copies and
// waited for with them), and ``kEarlyTile``, that its ``tile(k0)`` is taken
// before the tile's Q K^T (it issues loads that the products then cover).
template <class Mod, class = void>
struct mod_traits {
  static constexpr bool staged = false, early = false;
};
template <class Mod>
struct mod_traits<Mod, std::void_t<decltype(Mod::kStaged)>> {
  static constexpr bool staged = Mod::kStaged, early = Mod::kEarlyTile;
};

// The rest of a key tile for one warp, given its raw scores s and the
// modifier's tile: the modifier, the online softmax, O += P V over the
// first NK k16 steps.
template <int DP, int MT, int NK, class Mod>
__device__ __forceinline__ void softmax_pv(float (&acc)[MT][DP / 8][4], float (&m)[MT][2],
                                           float (&l)[MT][2], float (&s)[MT][NS][4],
                                           const __nv_bfloat16* vt, const typename Mod::Tile& cols,
                                           int wrow, float scale, const Mod& mod) {
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;   // n8 tiles of an output row
  const int lane = threadIdx.x & 31;
  // the online softmax of each m16 tile; P in bf16 as the A fragments of
  // P V (k16 step kk takes n8 tiles 2 kk and 2 kk + 1 of the scores)
  uint32_t pa[MT][NS / 2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float shift[2];
    mod.template apply<2 * NK>(s[mt], cols, wrow + mt * 16 + lane / 4, scale, shift);
    float mx[2] = {kInitMax, kInitMax};
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2)) + shift[h];
    }
    // raise the running max only where a row outgrows it by kLazyMax
    if (__any_sync(0xffffffffu, mx[0] > m[mt][0] + kLazyMax || mx[1] > m[mt][1] + kLazyMax)) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[mt][h], mx[h]);
        const float corr = exp2_approx((m[mt][h] - m_new) * kLog2e);
        m[mt][h] = m_new;
        l[mt][h] *= corr;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[mt][n][2 * h] *= corr;
          acc[mt][n][2 * h + 1] *= corr;
        }
      }
    }
    // p = 2^((s - (m - shift)) log2(e)): one FMA and one ex2
    const float b0 = (shift[0] - m[mt][0]) * kLog2e, b1 = (shift[1] - m[mt][1]) * kLog2e;
#pragma unroll
    for (int j = 0; j < 2 * NK; ++j) {
      const float p0 = exp2_approx(fmaf(s[mt][j][0], kLog2e, b0));
      const float p1 = exp2_approx(fmaf(s[mt][j][1], kLog2e, b0));
      const float p2 = exp2_approx(fmaf(s[mt][j][2], kLog2e, b1));
      const float p3 = exp2_approx(fmaf(s[mt][j][3], kLog2e, b1));
      l[mt][0] += p0 + p1;
      l[mt][1] += p2 + p3;
      pa[mt][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[mt][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
  }

  // O += P V: each V fragment feeds all MT m16 tiles
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, vt + (kk * 16 + (lane & 15)) * LD + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], pa[mt][kk], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], pa[mt][kk], b[2], b[3]);
      }
    }
  }
}

// One key tile for one warp: S = Q K^T, the modifier, the online softmax,
// O += P V, over the tile's first NK k16 steps (16 keys each) only: the
// last tile of a ragged S runs the steps that hold keys (SAM's windows, S =
// 196: one step of four). Scores past them stay 0 and the modifier masks
// them (the modifier touches only the first 2 NK n8 tiles); their P is 0.
// NK is a template argument so that no branch stands between the ldmatrix
// and mma of the loops: guards there, tried first, made K5 slower than
// computing the padding (PERF.md). Likewise a warp computes all its MT m16
// tiles; only a warp whose rows all lie past S skips the tile.
template <int DP, int MT, int NK, class Mod>
__device__ __forceinline__ void tile_step(float (&acc)[MT][DP / 8][4], float (&m)[MT][2],
                                          float (&l)[MT][2], const __nv_bfloat16* sQw,
                                          const __nv_bfloat16* kt, const __nv_bfloat16* vt,
                                          int k0, int wrow, float scale, const Mod& mod) {
  float s[MT][NS][4];
  zero_scores<MT>(s);
  if constexpr (mod_traits<Mod>::early) {
    const typename Mod::Tile cols = mod.tile(k0);
    add_scores<DP, MT, NK>(s, sQw, kt);
    softmax_pv<DP, MT, NK>(acc, m, l, s, vt, cols, wrow, scale, mod);
  } else {
    add_scores<DP, MT, NK>(s, sQw, kt);
    softmax_pv<DP, MT, NK>(acc, m, l, s, vt, mod.tile(k0), wrow, scale, mod);
  }
}

// A key tile holding kn keys (from k0 on) by the tile_step instance that
// runs its k16 steps.
template <int DP, int MT, class Mod>
__device__ __forceinline__ void key_tile(float (&acc)[MT][DP / 8][4], float (&m)[MT][2],
                                         float (&l)[MT][2], const __nv_bfloat16* sQw,
                                         const __nv_bfloat16* kt, const __nv_bfloat16* vt,
                                         int k0, int kn, int wrow, float scale,
                                         const Mod& mod) {
  switch (kn >= kBK ? NS / 2 : (kn + 15) / 16) {
    case 1:
      tile_step<DP, MT, 1>(acc, m, l, sQw, kt, vt, k0, wrow, scale, mod);
      break;
    case 2:
      tile_step<DP, MT, 2>(acc, m, l, sQw, kt, vt, k0, wrow, scale, mod);
      break;
    case 3:
      tile_step<DP, MT, 3>(acc, m, l, sQw, kt, vt, k0, wrow, scale, mod);
      break;
    default:
      tile_step<DP, MT, NS / 2>(acc, m, l, sQw, kt, vt, k0, wrow, scale, mod);
  }
}

// The 16 * WARPS * MT query rows [q0, q0 + ROWS) of one (S, D) head attend
// to the key tiles [0, n_tiles) of k and v; out rows >= S are not written.
// Every thread of the block calls it. The block synchronises before the
// first ``mod.apply``, so the caller may fill shared memory the modifier
// reads (after the first smem_bytes<DP, ROWS>() bytes) with plain stores or
// cp.async copies just before (the copies join the first group). A staged
// modifier (mod_traits) stages tile t + 1 into its ring slot with K and V.
template <int DP, int WARPS, int MT, class Mod>
__device__ __forceinline__ void attend_block(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             __nv_bfloat16* __restrict__ o, int q0, int S, int D,
                                             int n_tiles, float scale, const Mod& mod,
                                             __nv_bfloat16* smem) {
  static_assert(DP % 16 == 0 && DP <= 128, "head dim bound: a multiple of 16 up to 128");
  constexpr int LD = DP + 8;
  constexpr int NO = DP / 8;   // n8 tiles of an output row
  constexpr int ROWS = 16 * WARPS * MT;
  constexpr int kThreads = 32 * WARPS;
  constexpr int kTile = kBK * LD;
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = smem + ROWS * LD;  // K(t) at sK + (t & 1) kTile
  __nv_bfloat16* sV = sK + 2 * kTile;    // V(t) at sV + (t & 1) kTile
  const int wrow = (threadIdx.x / 32) * 16 * MT;  // the warp's first row
  const __nv_bfloat16* sQw = sQ + wrow * LD;

  load_tile<DP, ROWS, kThreads>(sQ, q, q0, S, D);
  load_tile<DP, kBK, kThreads>(sK, k, 0, S, D);
  load_tile<DP, kBK, kThreads>(sV, v, 0, S, D);
  cp_async_commit();

  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];  // running max; this lane's share of the denominator
  init_rows<DP, MT>(acc, m, l);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // K(t) and V(t) landed; every warp is past tile t - 1
    if (t + 1 < n_tiles) {
      load_tile<DP, kBK, kThreads>(sK + ((t + 1) & 1) * kTile, k, (t + 1) * kBK, S, D);
      load_tile<DP, kBK, kThreads>(sV + ((t + 1) & 1) * kTile, v, (t + 1) * kBK, S, D);
      if constexpr (mod_traits<Mod>::staged) mod.stage((t + 1) * kBK);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = sK + (t & 1) * kTile;
    const __nv_bfloat16* vt = sV + (t & 1) * kTile;

    if (q0 + wrow < S)  // a warp whose rows all lie past S computes nothing
      key_tile<DP, MT>(acc, m, l, sQw, kt, vt, t * kBK, S - t * kBK, wrow, scale, mod);
  }

  store_rows<DP, MT>(acc, l, o, q0 + wrow, S, D);
}

// Head dims past 128: the block's rows attend over the whole head dim and
// write the 128 output features [c0, c0 + 128) (blockIdx.z of the callers'
// grids: ceil(D / 128) blocks a query tile, each recomputing the scores).
// Per key tile the scores sum Q K^T over the head dim's 128-feature slices,
// each slice of Q and K staged in turn through the one Q and K tile (V's
// slice [c0, c0 + 128) with the first), then the modifier, the online
// softmax and P V as tile_step does them: P rounded to bf16 before P V, so
// bf16_error_bound holds as it does for attend_block. Loads are not
// pipelined (each slice waits on its copies): a repair for shapes that no
// configured model reaches, not a tuned path. Every tile runs its four k16
// steps; keys past S are zero and the modifier masks them. Shared memory:
// (ROWS + 2 x 64) x 136 x 2 bytes, plus what the caller appends after it.
template <int WARPS, int MT>
__host__ __device__ constexpr int sliced_smem_bytes() {
  return (16 * WARPS * MT + 2 * kBK) * (128 + 8) * (int)sizeof(__nv_bfloat16);
}

template <int WARPS, int MT, class Mod>
__device__ __forceinline__ void attend_block_sliced(const __nv_bfloat16* __restrict__ q,
                                                    const __nv_bfloat16* __restrict__ k,
                                                    const __nv_bfloat16* __restrict__ v,
                                                    __nv_bfloat16* __restrict__ o, int q0, int S,
                                                    int D, int c0, int n_tiles, float scale,
                                                    const Mod& mod, __nv_bfloat16* smem) {
  constexpr int DP = 128, LD = DP + 8;
  constexpr int ROWS = 16 * WARPS * MT;
  constexpr int kThreads = 32 * WARPS;
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = smem + ROWS * LD;
  __nv_bfloat16* sV = sK + kBK * LD;
  const int wrow = (threadIdx.x / 32) * 16 * MT;  // the warp's first row
  const __nv_bfloat16* sQw = sQ + wrow * LD;
  const bool live = q0 + wrow < S;  // a warp whose rows all lie past S computes nothing

  float acc[MT][DP / 8][4];
  float m[MT][2], l[MT][2];
  init_rows<DP, MT>(acc, m, l);
  for (int t = 0; t < n_tiles; ++t) {
    float s[MT][NS][4];
    zero_scores<MT>(s);
    for (int f0 = 0; f0 < D; f0 += DP) {
      __syncthreads();  // every warp is past its reads of the last slice (and tile)
      load_tile<DP, ROWS, kThreads>(sQ, q, q0, S, D, f0);
      load_tile<DP, kBK, kThreads>(sK, k, t * kBK, S, D, f0);
      if (f0 == 0) load_tile<DP, kBK, kThreads>(sV, v, t * kBK, S, D, c0);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (live) add_scores<DP, MT, NS / 2>(s, sQw, sK);
    }
    if (live) softmax_pv<DP, MT, NS / 2>(acc, m, l, s, sV, mod.tile(t * kBK), wrow, scale, mod);
  }
  store_rows<DP, MT>(acc, l, o, q0 + wrow, S, D, c0);
}

// A score modifier has a ``Tile`` (what a lane knows of a key tile's
// columns, computed once per tile by ``tile(k0)`` and shared by all the
// warp's rows and m16 tiles) and ``apply(s, tile, r0, scale, shift)``.

// K2/K3: keys >= valid_len are masked (only the last tile holds any).
struct KeyMask {
  int valid_len;
  using Tile = int;  // the tile's first key
  __device__ __forceinline__ Tile tile(int k0) const { return k0; }
  template <int NJ>
  __device__ __forceinline__ void apply(float (&s)[NS][4], int k0, int, float scale,
                                        float (&shift)[2]) const {
    shift[0] = shift[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    if (k0 + kBK <= valid_len) return;
    const int c = k0 + col0();
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + 8 * j + (e & 1) >= valid_len) s[j][e] = masked_score();
  }
};

// The block's rel-pos factors, one bf16 table row per query row in shared
// memory: bias_h (S, kh) at columns [0, kh), bias_w (S, kw) at
// [table_w0(kh), table_w0(kh) + kw), rows table_ld(kh, kw) elements apart.
// Both are even, so a lane reads its pairs of bias_w as one 4-byte word,
// and the row stride is the least that holds a row and is 4 words past a
// multiple of 8 words: the eight rows of a warp's reads (lane / 4) start in
// eight distinct groups of 4 banks. SAM's 64 x 64 grid: 136 elements a
// row; a 14 x 14 window: 40.
__host__ __device__ constexpr int table_w0(int kh) { return (kh + 1) & ~1; }
__host__ __device__ constexpr int table_ld(int kh, int kw) {
  return (table_w0(kh) + kw + 7) / 16 * 16 + 8;
}

// Fills the table of query rows [q0, q0 + ROWS) from THREADS threads; rows
// >= S read as zero. Even kh and kw with 4-byte aligned factors (SAM's)
// copy by 4-byte cp.async, which joins attend_block's first group of
// copies, so a short block (K5: 4 key tiles) does not wait on a chain of
// scalar loads; others take plain loads. attend_block waits for its copies
// and synchronises before the modifiers read the table.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_factor_table(__nv_bfloat16* dst,
                                                  const __nv_bfloat16* __restrict__ bh,
                                                  const __nv_bfloat16* __restrict__ bw, int q0,
                                                  int S, int kh, int kw) {
  const int w0 = table_w0(kh), ld = table_ld(kh, kw);
  const bool words = ((kh | kw) & 1) == 0 &&
                     ((reinterpret_cast<uintptr_t>(bh) | reinterpret_cast<uintptr_t>(bw)) & 3) == 0;
  if (words) {
    const int wh = kh / 2, ww = kw / 2;  // words of a row of each factor
    for (int i = threadIdx.x; i < ROWS * (wh + ww); i += THREADS) {
      const int r = i / (wh + ww), c = 2 * (i % (wh + ww)), gr = q0 + r;
      const bool in = gr < S;
      const __nv_bfloat16* src = c < kh ? bh + (long long)gr * kh + c
                                        : bw + (long long)gr * kw + c - kh;
      cp_async4(dst + r * ld + (c < kh ? c : w0 + c - kh), in ? src : bh, in ? 4 : 0);
    }
    return;
  }
  for (int r = threadIdx.x / 32; r < ROWS; r += THREADS / 32) {
    const int gr = q0 + r;
    for (int c = threadIdx.x & 31; c < kh + kw; c += 32)
      dst[r * ld + (c < kh ? c : w0 + c - kh)] =
          gr >= S ? __float2bfloat16(0.f)
                  : (c < kh ? bh[(long long)gr * kh + c] : bw[(long long)gr * kw + c - kh]);
  }
}

// K4 on a grid whose rows are whole key tiles (kw % 64 == 0; SAM's 64 x 64
// grid is one grid row per tile): bias[q, k] = bias_h[q, ky] + bias_w[q, kx]
// with one ky per tile. The lane reads its 2 rows x 16 columns of bias_w as
// bf16 pairs; bias_h[q, ky] is constant over the tile's row and goes to
// ``shift``. No divide, one FMA a score.
struct GridRowBias {
  const __nv_bfloat16* table;
  int kh, kw;
  using Tile = int;  // the tile's first key
  __device__ __forceinline__ Tile tile(int k0) const { return k0; }

  template <int NJ>
  __device__ __forceinline__ void apply(float (&s)[NS][4], int k0, int r0, float scale,
                                        float (&shift)[2]) const {
    const int ky = k0 / kw, ld = table_ld(kh, kw);
    const __nv_bfloat16* f0 = table + r0 * ld;
    const __nv_bfloat16* f1 = f0 + 8 * ld;
    shift[0] = __bfloat162float(f0[ky]);
    shift[1] = __bfloat162float(f1[ky]);
    const __nv_bfloat16* w0 = f0 + table_w0(kh) + (k0 - ky * kw) + col0();
    const __nv_bfloat16* w1 = w0 + 8 * ld;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w0 + 8 * j));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w1 + 8 * j));
      s[j][0] = fmaf(s[j][0], scale, a.x);
      s[j][1] = fmaf(s[j][1], scale, a.y);
      s[j][2] = fmaf(s[j][2], scale, b.x);
      s[j][3] = fmaf(s[j][3], scale, b.y);
    }
  }
};

// Scores of block rows r0 and r0 + 8 plus their bias from a bf16 table in
// shared memory with row stride ld: off[col] (off[pair] with kPairs: the
// two columns' bias_h is one entry, their bias_w one 4-byte pair) holds the
// column's bias_h entry in its low 16 bits and its bias_w entry in the high
// ones, or kMaskedOff for a key past S. Masked columns read the row's
// first entry and are set to -inf after: no branch, so the table reads of
// all columns issue together.
constexpr uint32_t kMaskedOff = 0xffffffffu;

template <bool kPairs, int NJ, int NC>
__device__ __forceinline__ void table_bias(float (&s)[NS][4], const uint32_t (&off)[NC],
                                           const __nv_bfloat16* table, int ld, int r0,
                                           float scale, float (&shift)[2]) {
  shift[0] = shift[1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const __nv_bfloat16* f = table + (r0 + 8 * h) * ld;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (kPairs) {
        const uint32_t u = off[j] == kMaskedOff ? 0u : off[j];
        const float bh = __bfloat162float(f[u & 0xffffu]);
        const float2 bw =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(f + (u >> 16)));
        const float x0 = fmaf(s[j][2 * h], scale, bh + bw.x);
        const float x1 = fmaf(s[j][2 * h + 1], scale, bh + bw.y);
        s[j][2 * h] = off[j] == kMaskedOff ? masked_score() : x0;
        s[j][2 * h + 1] = off[j] == kMaskedOff ? masked_score() : x1;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint32_t u = off[2 * j + e] == kMaskedOff ? 0u : off[2 * j + e];
          const float x = fmaf(s[j][2 * h + e], scale,
                               __bfloat162float(f[u & 0xffffu]) + __bfloat162float(f[u >> 16]));
          s[j][2 * h + e] = off[2 * j + e] == kMaskedOff ? masked_score() : x;
        }
      }
    }
  }
}

// K5's windows and K4 on any other grid (kw % 64 != 0): the factor table
// read through each key's grid coordinates. ``tile`` takes the lane's 16
// columns of the key tile (8 j + col0() + {0, 1}) to their (ky, kx) once,
// by steps of 8 from one divide (kw >= 8), and every row and m16 tile of the warp
// reuses them: a score costs two table reads and one FMA. Where kw is even
// (SAM's 14 x 14 windows) the two keys of a lane's pair lie in one grid row
// (the first has an even kx), so one read of bias_h and one 4-byte read of
// the bias_w pair serve both. Keys >= S are masked.
template <bool kPairs>
struct WindowBias {
  static constexpr int kCols = kPairs ? NS : 2 * NS;
  static constexpr uint32_t kMasked = kMaskedOff;
  const __nv_bfloat16* table;
  int kh, kw, S;
  // per column (pair): ky | (table_w0(kh) + kx) << 16, or kMasked
  struct Tile {
    uint32_t off[kCols];
  };

  __device__ __forceinline__ Tile tile(int k0) const {
    Tile c;
    const int w0 = table_w0(kh);
    int key = k0 + col0();
    int ky = key / kw, kx = key - ky * kw;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < (kPairs ? 1 : 2); ++e) {
        const bool wrap = kx + e == kw;
        const uint32_t y = ky + wrap, x = wrap ? 0 : kx + e;
        c.off[kPairs ? j : 2 * j + e] = key + e < S ? (y | (w0 + x) << 16) : kMasked;
      }
      key += 8;
      if (kw >= 8) {  // one wrap at most
        kx += 8;
        const bool wrap = kx >= kw;
        kx -= wrap ? kw : 0;
        ky += wrap;
      } else {
        ky = key / kw;
        kx = key - ky * kw;
      }
    }
    return c;
  }

  template <int NJ>
  __device__ __forceinline__ void apply(float (&s)[NS][4], const Tile& c, int r0, float scale,
                                        float (&shift)[2]) const {
    table_bias<kPairs, NJ>(s, c.off, table, table_ld(kh, kw), r0, scale, shift);
  }
};

// K4 on grids whose factor table would not fit (kh + kw past
// csrc/relpos_attention.cu's kMaxTableCols), and K5's windows that run K4's
// kernels there: the factors a key tile needs are staged into a ring slot
// of shared memory beside the tile's K and V, in the same cp.async group,
// and read from there as WindowBias reads its table. A tile starting at key
// k0 touches grid rows y0 = k0 / kw .. (k0 + 63) / kw, at most 62 / kw + 2
// columns of bias_h, and min(kw, 64) columns of bias_w. Up to
// kStreamFixedW columns every bias_w column of the block's rows is staged
// once, into a fixed table after the two slots, and only bias_h's columns
// stream (two a row a tile for kw >= 64); past it bias_w streams too: one
// run of 64 from x0 = k0 % kw that wraps at most once (piece A, x0 .. kw -
// 1, then piece B, 0 ..). A piece of a factor row starts at any element, so
// it is copied as the 4-byte words that hold it (the factor bases are
// 4-byte aligned), its first element at parity p = its flat index & 1 within
// its first word; the word past the end of an array is read as 2 bytes.
// Four threads copy a row's words, eight rows a warp at a time. Table row r
// (block row r, flat factor row R = head * S + q0 + r) holds, in words:
// slot 0 (H words of bias_h, then, past kStreamFixedW, 34 words of bias_w:
// piece A, piece B from the next word), slot 1 alike, then the fixed table
// (up to kStreamFixedW: (kw + 2) / 2 words), rows ld elements apart. A
// lane's rows (lane / 4 + 8 h + 16 mt of its warp's 32) share R's parity,
// so its per-tile column offsets hold for all of them; with an even kw
// every parity of bias_w is 0 and a key pair shares one bias_h entry and
// one 4-byte bias_w pair, as in WindowBias. kernels/flash_attention.py
// relpos_stream_layout / relpos_stream_stage / relpos_stream_offsets mirror
// this plan.
// The same plan serves csrc/relpos_attention_wide_wgmma.cu with another
// fixed-table width (fixed_w) and ring depth (slots).
constexpr int kStreamFixedW = 160;  // at DP 80 two blocks still share an SM
__host__ __device__ constexpr int stream_h_words(int kw) { return (62 / kw + 4) / 2; }
__host__ __device__ constexpr int stream_slot_words(int kw, int fixed_w = kStreamFixedW) {
  return stream_h_words(kw) + (kw > fixed_w ? 34 : 0);
}
__host__ __device__ constexpr int stream_fixed_words(int kw, int fixed_w = kStreamFixedW) {
  return kw > fixed_w ? 0 : (kw + 2) / 2;
}
__host__ __device__ constexpr int stream_ld(int kw, int fixed_w = kStreamFixedW, int slots = 2) {
  return (2 * (slots * stream_slot_words(kw, fixed_w) + stream_fixed_words(kw, fixed_w)) + 15) /
             16 * 16 + 8;
}

// The piece of ``cnt`` elements from flat index e of ``src`` (``total``
// elements) into the words from dst on, this thread taking words sub,
// sub + 4, ... (four threads a row); zero-filled when ``live`` is false
// (rows past S).
__device__ __forceinline__ void stream_piece(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             long long total, long long e, int cnt, int sub,
                                             bool live) {
  const int nw = cnt > 0 ? (static_cast<int>(e & 1) + cnt + 1) >> 1 : 0;
  const __nv_bfloat16* s0 = src + 2 * (e >> 1);
  const bool short_end = 2 * ((e >> 1) + nw) > total;  // the last word's second element
  for (int u = sub; u < nw; u += 4)
    cp_async4(dst + 2 * u, live ? s0 + 2 * u : src, !live ? 0 : u == nw - 1 && short_end ? 2 : 4);
}

// ROWS query rows a block, THREADS threads. kFromL2 (a measured
// alternative, tools/kernel_variants.py): nothing is staged; each score's
// factors are read from device memory, the tile's factor lines prefetched
// into L1 before its Q K^T (tile() runs first: kEarlyTile).
template <int ROWS, int THREADS, bool kPairs, bool kFromL2 = false>
struct StreamedBias {
  static constexpr bool kStaged = !kFromL2, kEarlyTile = kFromL2;
  static constexpr int kCols = kPairs ? NS : 2 * NS;
  __nv_bfloat16* table;       // ROWS x stream_ld(kw) bf16 in shared memory
  const __nv_bfloat16* bh;    // bias_h (rows, kh), the whole array, 4-byte aligned
  const __nv_bfloat16* bw;    // bias_w (rows, kw)
  long long rows;             // BH * S, the factor rows of every head
  long long row0;             // the block's first flat row, head * S + q0
  int kh, kw, S, q0;
  // per column (pair): bias_h entry | bias_w entry << 16 of the table row
  // (kFromL2: ky | kx << 16), or kMaskedOff
  struct Tile {
    uint32_t off[kCols];
  };

  // The fixed table (every bias_w column of the block's rows, up to
  // kStreamFixedW columns), by cp.async; called once before attend_block.
  __device__ __forceinline__ void stage_fixed() const {
    if (kFromL2 || kw > kStreamFixedW) return;
    const int ld = stream_ld(kw), f0 = 4 * stream_slot_words(kw);
    for (int r = threadIdx.x / 4; r < ROWS; r += THREADS / 4)
      stream_piece(table + r * ld + f0, bw, rows * kw, (row0 + r) * kw, kw, threadIdx.x & 3,
                 q0 + r < S);
  }

  // Tile k0's factor columns into slot (k0 / 64) & 1, by every thread.
  __device__ __forceinline__ void stage(int k0) const {
    if (kFromL2) return;
    const int hw = stream_h_words(kw), sw = stream_slot_words(kw), ld = stream_ld(kw);
    const int y0 = k0 / kw, x0 = k0 - y0 * kw, n = min(kBK, S - k0);
    const int nh = (k0 + n - 1) / kw - y0 + 1;
    const int na = min(n, kw - x0), nb = n - na;
    const long long th = rows * kh, tw = rows * kw;
    __nv_bfloat16* slot = table + ((k0 / kBK) & 1) * 2 * sw;
    const int sub = threadIdx.x & 3;
    for (int r = threadIdx.x / 4; r < ROWS; r += THREADS / 4) {
      const long long R = row0 + r;
      const bool live = q0 + r < S;
      __nv_bfloat16* dst = slot + r * ld;
      stream_piece(dst, bh, th, R * kh + y0, nh, sub, live);
      if (kw > kStreamFixedW) {
        const long long ea = R * kw + x0;
        const int wa = (static_cast<int>(ea & 1) + na + 1) >> 1;
        stream_piece(dst + 2 * hw, bw, tw, ea, na, sub, live);
        stream_piece(dst + 2 * (hw + wa), bw, tw, R * kw, nb, sub, live);
      }
    }
  }

  __device__ __forceinline__ Tile tile(int k0) const {
    Tile c;
    const int y0 = k0 / kw, x0 = k0 - y0 * kw, n = min(kBK, S - k0);
    const int lane = threadIdx.x & 31;
    int hbase = 0, abase = 0, bbase = 0, xa = 0;
    if constexpr (kFromL2) {
      // the lane's rows' factor lines into L1 while Q K^T runs
      constexpr int kWarpRows = ROWS / (THREADS / 32);
      const int last = x0 + n - 1;  // the run's last column, past kw when it wraps
#pragma unroll
      for (int i = 0; i < kWarpRows / 8; ++i) {
        const int gr = min(q0 + (threadIdx.x / 32) * kWarpRows + 8 * i + lane / 4, S - 1);
        const __nv_bfloat16* fh = bh + (row0 - q0 + gr) * kh;
        const __nv_bfloat16* fw = bw + (row0 - q0 + gr) * kw;
        const int xs[4] = {kw < kBK ? 0 : x0, min(last, kw - 1), last >= kw ? 0 : x0,
                           last >= kw ? last - kw : x0};
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(fh + y0));
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(fh + (k0 + n - 1) / kw));
#pragma unroll
        for (int p = 0; p < 4; ++p) asm volatile("prefetch.global.L1 [%0];\n" ::"l"(fw + xs[p]));
      }
    } else {
      const int hw = stream_h_words(kw), sw = stream_slot_words(kw);
      const int rho = static_cast<int>((row0 + lane / 4) & 1);  // the lane's rows' parity
      const int s0 = ((k0 / kBK) & 1) * 2 * sw;
      hbase = s0 + ((rho * kh + y0) & 1) - y0;
      if (kw > kStreamFixedW) {
        const int pa = (rho * kw + x0) & 1, na = min(n, kw - x0);
        xa = x0;
        abase = s0 + 2 * hw + pa - x0;
        bbase = s0 + 2 * hw + 2 * ((pa + na + 1) >> 1) + ((rho * kw) & 1);
      } else {
        abase = 4 * sw + ((rho * kw) & 1);  // the fixed table
      }
    }
    int key = k0 + col0();
    int ky = key / kw, kx = key - ky * kw;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < (kPairs ? 1 : 2); ++e) {
        const bool wrap = kx + e == kw;
        const int y = ky + wrap, x = wrap ? 0 : kx + e;
        const uint32_t off =
            kFromL2 ? (static_cast<uint32_t>(y) | static_cast<uint32_t>(x) << 16)
                    : (static_cast<uint32_t>(hbase + y) |
                       static_cast<uint32_t>(x >= xa ? abase + x : bbase + x) << 16);
        c.off[kPairs ? j : 2 * j + e] = key + e < S ? off : kMaskedOff;
      }
      key += 8;
      if (kw >= 8) {  // one wrap at most
        kx += 8;
        const bool wrap = kx >= kw;
        kx -= wrap ? kw : 0;
        ky += wrap;
      } else {
        ky = key / kw;
        kx = key - ky * kw;
      }
    }
    return c;
  }

  template <int NJ>
  __device__ __forceinline__ void apply(float (&s)[NS][4], const Tile& c, int r0, float scale,
                                        float (&shift)[2]) const {
    if constexpr (!kFromL2) {
      table_bias<kPairs, NJ>(s, c.off, table, stream_ld(kw), r0, scale, shift);
    } else {
      shift[0] = shift[1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long R = row0 + min(r0 + 8 * h, S - 1 - q0);  // rows past S: any row
        const __nv_bfloat16* fh = bh + R * kh;
        const __nv_bfloat16* fw = bw + R * kw;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t o = c.off[kPairs ? j : 2 * j + e];
            const uint32_t u = o == kMaskedOff ? 0u : o;
            const float x = fmaf(s[j][2 * h + e], scale,
                                 __bfloat162float(__ldg(fh + (u & 0xffffu))) +
                                     __bfloat162float(__ldg(fw + (u >> 16) + (kPairs ? e : 0))));
            s[j][2 * h + e] = o == kMaskedOff ? masked_score() : x;
          }
      }
    }
  }
};

// Whether bf16 inputs can take the tensor-core tile: whole 16-byte rows and
// 16-byte aligned bases.
__host__ __forceinline__ bool tile_takes(int D, const void* q, const void* k, const void* v,
                                         const void* o) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return D % 8 == 0 && (any & 15) == 0;
}

// Raises a kernel's dynamic shared memory limit to at least ``bytes`` once
// per kernel (``configured`` is that kernel's own static counter).
template <typename K>
__host__ cudaError_t allow_smem(K kernel, int bytes, int* configured) {
  if (bytes <= *configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

}  // namespace bff_tc
