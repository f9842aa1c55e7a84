// What the bf16 wgmma kernels that hold a whole head dim of 144 to 256 in
// one block share: csrc/flash_attention_wide_wgmma.cu (flash attention, K2
// and K3) and csrc/relpos_attention_wide_wgmma.cu (K4 with SAM's decomposed
// rel-pos bias). The plan, which flash_attention_wide_wgmma.cu sets out:
// the head dim rounded up to DP, a multiple of 32, cut into 64-column TMA
// boxes in the 128-byte swizzle and, where DP % 64 is 32, one 32-column box
// in the 64-byte swizzle (the tensor maps hold the true D, so the TMA
// zero-fills the rest); blocks of two consumer warpgroups of 64 query rows
// and no producer (256 threads, 255 registers a thread); 64-key K and V
// tiles in a ring of two stages; S = Q K^T by wgmma.m64n64k16 from shared
// memory, P in bf16 as the register A operand of O += P V.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "wgmma.cuh"

namespace bff_wide {

using namespace bff_wg;

constexpr int kMinD = 144, kMaxD = 256;  // the head dims the kernels take, in steps of 16
constexpr int kDStep = 32;               // DP: D rounded up to this
constexpr int kBN = 64;                  // keys of a tile
constexpr int kStages = 2;               // K and V tiles in flight
constexpr int kConsumers = 2;            // consumer warpgroups of 64 query rows each
constexpr int kBM = 64 * kConsumers;     // query rows of a block
constexpr int kThreads = 128 * kConsumers;  // no producer: the consumers issue the loads
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr float kLazy = 8.f;      // log2(2^8): the largest p is 2^8

// The padded head dim's boxes: N64 of 64 columns (128-byte swizzle), then
// one of 32 (64-byte swizzle) where DP % 64 has it. Byte offsets within a
// 64-row tile.
template <int DP>
struct Boxes {
  static_assert(DP % kDStep == 0, "DP is a multiple of 32");
  static constexpr int N64 = DP / 64;
  static constexpr bool H32 = DP % 64 == 32;
  static constexpr int kOff32 = N64 * 64 * 128;  // the 32-column box
  static constexpr int kTile = 64 * DP * 2;      // a 64-row tile of all boxes
  // Q's two tiles and the K and V rings, then 128 bytes of barriers, and
  // the 1024 bytes the base may need to reach a swizzle atom's boundary
  static constexpr int kSmemBytes = (kConsumers + 2 * kStages) * kTile + 128 + 1024;
};

// One tensor map per box width (64, 32 columns) for each of q, k, v.
struct Maps {
  CUtensorMap q[2], k[2], v[2];
};

struct Barriers {
  uint64_t q_full;
  uint64_t k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
};

// Rows [r0, r0 + 64) of head bh, every box, into the tile at dst.
template <int DP>
__device__ __forceinline__ void load_rows(unsigned char* dst, const CUtensorMap (&m)[2],
                                          uint64_t* bar, int r0, int bh) {
  using B = Boxes<DP>;
#pragma unroll
  for (int b = 0; b < B::N64; ++b) tma_load_3d(dst + b * 64 * 128, &m[0], bar, 64 * b, r0, bh);
  if (B::H32) tma_load_3d(dst + B::kOff32, &m[1], bar, 64 * B::N64, r0, bh);
}

// S = Q K^T for the warpgroup's 64 rows (q_wg) and the 64 keys of k_tile:
// four k16 steps a 64-column box, two for the 32-column box.
template <int DP>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t q_wg, uint32_t k_tile) {
  using B = Boxes<DP>;
#pragma unroll
  for (int b = 0; b < B::N64; ++b)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t off = b * 64 * 128 + kk * 32;
      const uint64_t da = sw128_desc(q_wg + off, 16), db = sw128_desc(k_tile + off, 16);
      if (b == 0 && kk == 0)
        wgmma_m64n64k16_ss_first(s, da, db);
      else
        wgmma_m64n64k16_ss(s, da, db, 1);
    }
  if (B::H32)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_m64n64k16_ss(s, sw64_desc(q_wg + B::kOff32 + kk * 32, 16),
                         sw64_desc(k_tile + B::kOff32 + kk * 32, 16), 1);
}

// The output accumulators: one m64n64 chain per 64-column box, m64n32 for
// the 32-column box (an array of one where it is absent, never touched).
template <int DP>
struct Acc {
  float o64[Boxes<DP>::N64][32];
  float o32[Boxes<DP>::H32 ? 16 : 1];
};

template <int DP>
__device__ __forceinline__ void zero_acc(Acc<DP>& acc) {
#pragma unroll
  for (int b = 0; b < Boxes<DP>::N64; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc.o64[b][i] = 0.f;
#pragma unroll
  for (int i = 0; i < (Boxes<DP>::H32 ? 16 : 1); ++i) acc.o32[i] = 0.f;
}

// O += P V for the 64 keys of v_tile (k-step kk: keys 16 kk .. 16 kk + 15).
template <int DP>
__device__ __forceinline__ void issue_pv(Acc<DP>& o, const uint32_t (&p)[4][4], uint32_t v_tile) {
  using B = Boxes<DP>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int b = 0; b < B::N64; ++b)
      wgmma_m64n64k16_rs(o.o64[b], p[kk], sw128_desc(v_tile + b * 64 * 128 + kk * 2048, 1024));
    if constexpr (B::H32)
      wgmma_m64n32k16_rs(o.o32, p[kk], sw64_desc(v_tile + B::kOff32 + kk * 1024, 512));
  }
}

template <int DP>
__device__ __forceinline__ void fence_acc(Acc<DP>& o) {
#pragma unroll
  for (int b = 0; b < Boxes<DP>::N64; ++b) fence_regs(o.o64[b]);
  if constexpr (Boxes<DP>::H32) fence_regs(o.o32);
}

template <int N>
__device__ __forceinline__ void rescale_rows(float (&o)[N], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

template <int DP>
__device__ __forceinline__ void rescale(Acc<DP>& o, const float (&corr)[2]) {
#pragma unroll
  for (int b = 0; b < Boxes<DP>::N64; ++b) rescale_rows(o.o64[b], corr);
  if constexpr (Boxes<DP>::H32) rescale_rows(o.o32, corr);
}

// Where lane's accumulator values lie: s[4 j + e] holds row lane / 4 + 8 (e
// / 2) of the warp's 16 rows and column 8 j + 2 (lane % 4) + e % 2.

// The largest (kMax) or the sum of the values v[2 h + 4 j + e], e in {0, 1},
// over the tile's column tiles j: a tree, not a chain.
template <bool kMax>
__device__ __forceinline__ float row_reduce(const float (&v)[32], int h) {
  float t[kBN / 8];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
    t[j] = kMax ? fmaxf(v[4 * j + 2 * h], v[4 * j + 2 * h + 1])
                : v[4 * j + 2 * h] + v[4 * j + 2 * h + 1];
#pragma unroll
  for (int w = kBN / 16; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = kMax ? fmaxf(t[j], t[j + w]) : t[j] + t[j + w];
  return t[0];
}

// The online softmax of one score tile in place, as in
// csrc/flash_masked_wgmma.cu: when ``ragged`` (the last tile, valid_len
// inside it; only read when kMayMask), keys >= valid_len masked and the
// column tiles wholly past it set to p = 0; the running max m (log2 units)
// raised where a row outgrows it by kLazy, l rescaled and summed, s turned
// into p. Returns whether a max was raised (the same in every lane of the
// warp), with the output rows' factors in corr (1 where the max stayed).
template <bool kMayMask>
__device__ __forceinline__ bool softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2, bool ragged, int k0,
                                             int valid_len) {
  ragged = kMayMask && ragged;
  if (ragged) {
    const int c = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + 8 * j + (e & 1) >= valid_len) s[4 * j + e] = bff_tc::masked_score();
  }
  float mx[2] = {row_reduce<true>(s, 0), row_reduce<true>(s, 1)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2)) * sl2;
  }
  corr[0] = corr[1] = 1.f;
  const bool raised = __any_sync(0xffffffffu, mx[0] > m[0] + kLazy || mx[1] > m[1] + kLazy);
  if (raised) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = bff_tc::exp2_approx(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    if (ragged && k0 + 8 * j >= valid_len) {  // uniform: no key of the column tile is valid
      s[4 * j] = s[4 * j + 1] = s[4 * j + 2] = s[4 * j + 3] = 0.f;
      continue;
    }
    s[4 * j] = bff_tc::exp2_approx(fmaf(s[4 * j], sl2, -m[0]));
    s[4 * j + 1] = bff_tc::exp2_approx(fmaf(s[4 * j + 1], sl2, -m[0]));
    s[4 * j + 2] = bff_tc::exp2_approx(fmaf(s[4 * j + 2], sl2, -m[1]));
    s[4 * j + 3] = bff_tc::exp2_approx(fmaf(s[4 * j + 3], sl2, -m[1]));
  }
  l[0] += row_reduce<false>(s, 0);
  l[1] += row_reduce<false>(s, 1);
  return raised;
}

// P in bf16 as the A fragments of the four k-steps of P V: step kk takes the
// accumulator's n8 tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&p)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = bff_tc::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// A box's n8 column tiles of the warp's 16 rows, divided by their
// denominators, into the output from column c0 on; tiles at or past D (the
// padding, a whole n8 tile each: D is a multiple of 16) are not written.
template <int N>
__device__ __forceinline__ void store_box(const float (&o)[N], const float (&l)[2],
                                          __nv_bfloat16* ob, int D, int c0, bool (&live)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    __nv_bfloat16* orow = ob + 8 * h * D + c0;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      if (c0 + 8 * j < D)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            bff_tc::pack_bf16(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
  }
}

// The warp's 16 rows of the output (lane's rows row0 and row0 + 8 of the
// (S, D) head at o, row0 = the warp's first row + lane / 4), divided by the
// quad's summed denominators; rows >= S are not written.
template <int DP>
__device__ __forceinline__ void store_rows(const Acc<DP>& acc, float (&l)[2],
                                           __nv_bfloat16* __restrict__ o, int row0, int S,
                                           int D) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  bool live[2] = {row0 < S, row0 + 8 < S};
  __nv_bfloat16* ob = o + static_cast<long long>(row0) * D + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int b = 0; b < Boxes<DP>::N64; ++b) store_box(acc.o64[b], l, ob, D, 64 * b, live);
  if constexpr (Boxes<DP>::H32) store_box(acc.o32, l, ob, D, 64 * Boxes<DP>::N64, live);
}

// The tensor maps of one call: q, k, v viewed as (BH, S, D) bf16, one map
// per box width. 0, or encode_3d's negative codes (-2: no
// cuTensorMapEncodeTiled).
inline int encode_maps(Maps& maps, const void* q, const void* k, const void* v, int BH, int S,
                       int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  const void* base[3] = {q, k, v};
  CUtensorMap* dst[3] = {maps.q, maps.k, maps.v};
  const int widths[2] = {64, 32};
  const CUtensorMapSwizzle swizzle[2] = {CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_SWIZZLE_64B};
  for (int t = 0; t < 3; ++t)
    for (int w = 0; w < 2; ++w) {
      const int rc = encode_3d(fn, &dst[t][w], base[t], D, S, BH, widths[w], 64, swizzle[w]);
      if (rc != 0) return rc;
    }
  return 0;
}

}  // namespace bff_wide
