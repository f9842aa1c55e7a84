// One flash-attention block for bf16 inputs on Hopper's tensor cores
// (sm_90a), shared by bff_flash_attention (csrc/flash_attention.cu: K2/K3,
// a key mask) and bff_flash_attention_relpos (csrc/relpos_attention.cu: K4,
// SAM's decomposed rel-pos bias). The two differ only in a score modifier
// passed as a functor: ``mod.apply(s, k0, r0, scale, shift)`` turns the raw
// Q K^T fragment of block rows r0 (+ 8) and the key tile at k0 into logits
// in place, scaled and biased or masked; a per-row constant of the tile may
// stay out of the scores and come back in ``shift`` (it moves the row's
// max, not its softmax).
//
// Design (a block of WARPS warps, each warp MT m16 tiles = 16 MT query rows):
// * Both products on the tensor cores: mma.sync.m16n8k16.row.col, bf16 in,
//   f32 accumulate. Fragments come from shared memory by ldmatrix (.trans
//   for V). mma.sync and not wgmma: the head dims are 80 (SAM ViT-H) and 32
//   (Grounding-DINO), whole k16 steps but not the 64-element rows that
//   wgmma's swizzled shared-memory descriptors want.
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

// Rows [r0, r0 + ROWS) of a row-major (S, D) bf16 matrix into a tile with
// row stride DP + 8, by cp.async from THREADS threads; rows >= S and
// features >= D are zero-filled.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int S, int D) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks of a row
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + THREADS - 1) / THREADS; ++it) {
    const int i = it * THREADS + threadIdx.x;
    if (kTotal % THREADS == 0 || i < kTotal) {
      const int r = i / kChunks, c = (i % kChunks) * 8, gr = r0 + r;
      const bool in = gr < S && c < D;
      cp_async16(dst + r * (DP + 8) + c, in ? src + (long long)gr * D + c : src, in);
    }
  }
}

// The 16 * WARPS * MT query rows [q0, q0 + ROWS) of one (S, D) head attend
// to the key tiles [0, n_tiles) of k and v; out rows >= S are not written.
// Every thread of the block calls it. The block synchronises before the
// first ``mod.apply``, so the caller may fill shared memory the modifier
// reads (after the first smem_bytes<DP, ROWS>() bytes) with plain stores
// just before.
template <int DP, int WARPS, int MT, class Mod>
__device__ __forceinline__ void attend_block(const __nv_bfloat16* __restrict__ q,
                                             const __nv_bfloat16* __restrict__ k,
                                             const __nv_bfloat16* __restrict__ v,
                                             __nv_bfloat16* __restrict__ o, int q0, int S, int D,
                                             int n_tiles, float scale, const Mod& mod,
                                             __nv_bfloat16* smem) {
  static_assert(DP % 16 == 0 && DP <= 128, "head dim bound: a multiple of 16 up to 128");
  constexpr int LD = DP + 8;
  constexpr int KS = DP / 16;  // k16 steps of Q K^T
  constexpr int NO = DP / 8;   // n8 tiles of an output row
  constexpr int ROWS = 16 * WARPS * MT;
  constexpr int kThreads = 32 * WARPS;
  constexpr int kTile = kBK * LD;
  __nv_bfloat16* sQ = smem;
  __nv_bfloat16* sK = smem + ROWS * LD;  // K(t) at sK + (t & 1) kTile
  __nv_bfloat16* sV = sK + 2 * kTile;    // V(t) at sV + (t & 1) kTile
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x / 32) * 16 * MT;  // the warp's first row
  const __nv_bfloat16* sQw = sQ + wrow * LD;

  load_tile<DP, ROWS, kThreads>(sQ, q, q0, S, D);
  load_tile<DP, kBK, kThreads>(sK, k, 0, S, D);
  load_tile<DP, kBK, kThreads>(sV, v, 0, S, D);
  cp_async_commit();

  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];  // running max; this lane's share of the denominator
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = kInitMax;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // K(t) and V(t) landed; every warp is past tile t - 1
    if (t + 1 < n_tiles) {
      load_tile<DP, kBK, kThreads>(sK + ((t + 1) & 1) * kTile, k, (t + 1) * kBK, S, D);
      load_tile<DP, kBK, kThreads>(sV + ((t + 1) & 1) * kTile, v, (t + 1) * kBK, S, D);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = sK + (t & 1) * kTile;
    const __nv_bfloat16* vt = sV + (t & 1) * kTile;

    // S = Q K^T: each K fragment feeds all MT m16 tiles
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt], sQw + (mt * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
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

    // the online softmax of each m16 tile; P in bf16 as the A fragments of
    // P V (k16 step kk takes n8 tiles 2 kk and 2 kk + 1 of the scores)
    uint32_t pa[MT][NS / 2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float shift[2];
      mod.apply(s[mt], t * kBK, wrow + mt * 16 + lane / 4, scale, shift);
      float mx[2] = {kInitMax, kInitMax};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
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
      for (int j = 0; j < NS; ++j) {
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
    for (int kk = 0; kk < NS / 2; ++kk) {
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

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lsum = l[mt][h];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const int row = q0 + wrow + mt * 16 + lane / 4 + 8 * h;
      if (row < S) {
        __nv_bfloat16* orow = o + (long long)row * D;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const int c = 8 * n + col0();
          if (c < D)
            *reinterpret_cast<uint32_t*>(orow + c) =
                pack_bf16(acc[mt][n][2 * h] / lsum, acc[mt][n][2 * h + 1] / lsum);
        }
      }
    }
}

// K2/K3: keys >= valid_len are masked (only the last tile holds any).
struct KeyMask {
  int valid_len;
  __device__ __forceinline__ void apply(float (&s)[NS][4], int k0, int, float scale,
                                        float (&shift)[2]) const {
    shift[0] = shift[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    if (k0 + kBK <= valid_len) return;
    const int c = k0 + col0();
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + 8 * j + (e & 1) >= valid_len) s[j][e] = masked_score();
  }
};

// The block's rel-pos factors, one bf16 table row per query row in shared
// memory: bias_h (S, kh) at columns [0, kh), bias_w (S, kw) at
// [table_w0(kh), table_w0(kh) + kw), rows table_ld(kh, kw) elements apart.
// Both are even, so a lane reads its pairs of bias_w as one 4-byte word,
// and the row stride is 4 words past a multiple of 32: the eight rows of a
// warp's reads fall in eight distinct groups of 4 banks.
__host__ __device__ constexpr int table_w0(int kh) { return (kh + 1) & ~1; }
__host__ __device__ constexpr int table_ld(int kh, int kw) {
  return (table_w0(kh) + kw + 55) / 64 * 64 + 8;
}

// Fills the table of query rows [q0, q0 + ROWS) from THREADS threads; rows
// >= S read as zero. Plain loads: attend_block synchronises before the
// modifiers read it.
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_factor_table(__nv_bfloat16* dst,
                                                  const __nv_bfloat16* __restrict__ bh,
                                                  const __nv_bfloat16* __restrict__ bw, int q0,
                                                  int S, int kh, int kw) {
  const int w0 = table_w0(kh), ld = table_ld(kh, kw);
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
    for (int j = 0; j < NS; ++j) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w0 + 8 * j));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w1 + 8 * j));
      s[j][0] = fmaf(s[j][0], scale, a.x);
      s[j][1] = fmaf(s[j][1], scale, a.y);
      s[j][2] = fmaf(s[j][2], scale, b.x);
      s[j][3] = fmaf(s[j][3], scale, b.y);
    }
  }
};

// K4 on any other grid (kw % 64 != 0, S not a multiple of 64): the factor
// table looked up per score, keys >= S masked.
struct FactorBias {
  const __nv_bfloat16* table;
  int kh, kw, S;

  __device__ __forceinline__ void apply(float (&s)[NS][4], int k0, int r0, float scale,
                                        float (&shift)[2]) const {
    shift[0] = shift[1] = 0.f;
    const int ld = table_ld(kh, kw), w0 = table_w0(kh);
    const __nv_bfloat16* f0 = table + r0 * ld;
    const __nv_bfloat16* f1 = f0 + 8 * ld;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + col0() + (e & 1);
        if (key >= S) {
          s[j][e] = masked_score();
        } else {
          const __nv_bfloat16* f = e < 2 ? f0 : f1;
          const int ky = key / kw;
          s[j][e] = fmaf(s[j][e], scale,
                         __bfloat162float(f[ky]) + __bfloat162float(f[w0 + key - ky * kw]));
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
