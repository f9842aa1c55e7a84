// Flash attention with head dim 32 and a key mask for Hopper (sm_90a):
// wgmma and TMA, K and V of a head whole in shared memory.
//
// Replaces the TPU kernel beyondff_tpu/kernels/flash_attention.py
// _flash_masked (:270, pallas_call :313), reached through attend (:101):
// softmax(Q K^T * scale) V over (BH, S, D) with keys >= valid_len masked,
// an online max and denominator, P rounded to bf16 before P V (:302), the
// denominator summed from the f32 probabilities and the output divided once
// in f32. On the port's main path it is the Grounding-DINO decoder's
// self-attention over its 900 queries, (8 B, 900, 32) bf16 for B frames:
// (32, 900, 32) at the batch of 4, with valid_len = S (attend pads
// nothing). bff_flash_attention (csrc/flash_attention.cu) routes here
// exactly the calls bff_flash_masked_wgmma_takes accepts: bf16, D = 32,
// 1 <= valid_len <= S, valid_len <= kMaxKeys (the keys read sit whole in
// shared memory), a positive finite scale and 16-byte aligned q, k, v and
// o. Every other call keeps K3's kernel, the mma.sync tile or the FMA kernel.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at (32, 900, 32) the
// function does 4 * 32 * 900^2 * 32 = 3.3 GFLOP (3.35 us on the tensor
// cores) and moves 4 * 32 * 900 * 32 * 2 = 7.4 MB (2.2 us). At head dim 32
// the special-function unit is the tighter limit: one exponential per score
// against 128 tensor-core operations, and 16 ex2 a clock per SM against
// 4096 bf16 operations a clock, so the exponentials take twice as long as
// both products: 32 * 900^2 = 25.9 M ex2 over 132 SMs at 16 a clock is
// 6.2 us at 1.98 GHz. The whole call is under one wave, so the critical path
// is one SM's four 64-row tiles. Measured on an H100 SXM at 700 W
// (tools/kernel_variants.py, device time): 0.0173 ms against 0.0247 ms for
// the mma.sync tile this kernel replaced and 0.0265 ms for
// scaled_dot_product_attention; 0.0104 ms at one frame's (8, 900, 32).
// The gap to the exponential bound is a tile's latency chain (scores, row
// max, exponentials, sums) that four warpgroups an SM do not hide.
//
// Design (a block of C consumer warpgroups, 64 query rows each, over a
// 64C-query tile of one head; grid (ceil(S / 64C), BH); no producer):
// * One thread issues every load by TMA at the start (3-D tensor maps over
//   (BH, S, 32), 64-byte swizzle: a 32-bf16 row is the 64 bytes that
//   CU_TENSOR_MAP_SWIZZLE_64B lays out and the descriptors' swizzle mode
//   reads): Q's C boxes of 64 rows, then every 64-key tile of K and V up to
//   valid_len, each tile with its own full mbarrier. The keys of one head
//   (at most kMaxKeys, 115 KB at 900) stay whole in shared memory, so no
//   stage is refilled and no empty barrier exists; the first tiles' products
//   start while the later tiles are still in flight. Rows past S of a head
//   are zero-filled by the TMA and never read from the next head.
// * S = Q K^T is wgmma.m64n64k16 with both operands in shared memory,
//   K-major, 2 k-steps; the online softmax runs on the f32 accumulators (the
//   row max by quad shuffles, scale * log2(e) folded into one FMA before the
//   exponential, the running max raised only when a row outgrows it by 2^8,
//   as in csrc/flash_attention_wgmma.cu); P in bf16 is the register A
//   operand of O += P V by wgmma.m64n32k16 (V as B, MN-major through the
//   transpose bit), 4 k-steps per tile. The scores' first k-step writes its
//   accumulators without reading them (kFreshScores); with the last tile
//   peeled (below) ptxas keeps the kernel at 93 registers where the draft
//   took 128 and moved the scores between registers at every tile.
// * Every 2^x runs on the special-function unit. Taking a share of them on
//   the FMA units as a polynomial made the kernel slower on the card (an
//   eighth: 3%, a quarter: 9%), so the exponential unit is not what bounds
//   it; tools/kernel_variants.py keeps that design as the k2_poly_* variants
//   (PERF.md §6).
// * Within a consumer, tile t's Q K^T is issued before tile t - 1's P V
//   (kOverlap); across consumers, pingpong (kPingpong): they take turns, by
//   named barriers, to issue their products, so one's products run on the
//   tensor cores while the others take their exponentials. Each saves
//   8-9% at (32, 900, 32), both 14% (PERF.md §6). No branch may
//   stand between an issue and its wait (ptxas then serializes every wgmma,
//   warning C7520).
// * valid_len: key tiles wholly past it are never loaded nor computed; in
//   the last tile the keys >= valid_len are set to -inf before the row max,
//   and its n8 column tiles wholly past valid_len take p = 0 with no
//   exponential, so a ragged 900 costs 904 exponentials a row, not 960.
//   The last tile, the only one that can be ragged, runs after the loop
//   (kPeelLast), so the loop holds no masking code. Query rows >= S are not
//   written.
// * Precision as the TPU kernel: P rounded to bf16 before P V, the
//   denominator summed from the f32 probabilities, the output divided by it
//   in f32 and rounded once.
//
// Grid: C in {4, 2, 1} is chosen per call (choose_consumers) by a cost of
// waves times C + 2. At (32, 900, 32): C = 4, 4 x 32 = 128 blocks of 512
// threads, one wave, each SM four 64-row tiles; at one frame's (8, 900,
// 32): C = 1, 120 blocks of one warpgroup.
//
// Host: the three CUtensorMaps are encoded on every call through
// cuTensorMapEncodeTiled (looked up with cudaGetDriverEntryPoint, no
// -lcuda) and passed as __grid_constant__ parameters. A failed lookup,
// encode or launch returns non-zero and the wrapper raises.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace bff_wg;

constexpr int kD = 32;          // head dim: one 64-byte row of bf16
constexpr int kBN = 64;         // keys of a tile (128 took 194-212 registers or spilled)
constexpr int kMaxKeys = 1536;  // keys held in shared memory
constexpr int kMaxTiles = kMaxKeys / kBN;
constexpr bool kOverlap = true;   // issue Q K^T of tile t before P V of tile t - 1
constexpr bool kPingpong = true;  // the consumers take turns to issue their products
constexpr bool kLazyRescale = true;  // rescale the output rows only when a max was raised
constexpr bool kPeelLast = true;  // the last tile, the only ragged one, outside the loop
constexpr bool kFreshScores = true;  // the scores' first k-step writes them without reading
constexpr int kRowBytes = kD * 2;
constexpr int kTileBytes = kBN * kRowBytes;  // one K or V tile: 4 KB
constexpr int kQSlice = 64 * kRowBytes;      // one consumer's rows of Q: 4 KB
constexpr float kLazy = 8.f;  // log2(2^8): the largest p is 2^8

struct Barriers {
  uint64_t q_full;
  uint64_t k_full[kMaxTiles], v_full[kMaxTiles];
};

// Q, K and V tiles, the barriers, and room to align the start to 1024 bytes.
__host__ __device__ constexpr int smem_bytes(int consumers, int n_tiles) {
  return consumers * kQSlice + 2 * n_tiles * kTileBytes + (int)sizeof(Barriers) + 1024;
}

// S = Q K^T for the warpgroup's 64 rows (q_wg) and the 64 keys of k_tile.
__device__ __forceinline__ void issue_scores(float (&s)[kBN / 2], uint32_t q_wg,
                                             uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint64_t da = sw64_desc(q_wg + kk * 32, 16), db = sw64_desc(k_tile + kk * 32, 16);
    if (kFreshScores && kk == 0)
      wgmma_m64n64k16_ss_first(s, da, db);
    else
      wgmma_m64n64k16_ss(s, da, db, kk);
  }
}

// O += P V for the kBN keys of v_tile (k-step kk: keys 16 kk .. 16 kk + 15,
// 1024 bytes on).
__device__ __forceinline__ void issue_pv(float (&o)[16], const uint32_t (&p)[kBN / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_m64n32k16_rs(o, p[kk], sw64_desc(v_tile + kk * 1024, 512));
}

// Where lane's accumulator values lie: s[4 j + e] holds row lane / 4 + 8 (e
// / 2) of the warp's 16 rows and column 8 j + 2 (lane % 4) + e % 2.

// The largest (kMax) or the sum of the values v[2 h + 4 j + e], e in {0, 1},
// over the tile's column tiles j: a tree, not a chain.
template <bool kMax>
__device__ __forceinline__ float row_reduce(const float (&v)[kBN / 2], int h) {
  float t[kBN / 8];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
    t[j] = kMax ? fmaxf(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]) : v[4 * j + 2 * h] + v[4 * j + 2 * h + 1];
#pragma unroll
  for (int w = kBN / 16; w >= 1; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = kMax ? fmaxf(t[j], t[j + w]) : t[j] + t[j + w];
  return t[0];
}

// The online softmax of one score tile in place: when ``ragged`` (the last
// tile, valid_len inside it; only read when kMayMask), keys >= valid_len
// masked and the column tiles wholly past it set to p = 0; the running max
// m (log2 units) raised where a row outgrows it by kLazy, l rescaled and
// summed, s turned into p. Returns whether a max was raised (the same in
// every lane of the warp), with the factors the output rows must be
// rescaled by in corr (1 where the max stayed).
template <bool kMayMask>
__device__ __forceinline__ bool softmax_tile(float (&s)[kBN / 2], float (&m)[2], float (&l)[2],
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

// P in bf16 as the A fragments of the kBN / 16 k-steps of P V: step kk
// takes the accumulator's n8 tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&p)[kBN / 16][4], const float (&s)[kBN / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = bff_tc::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[16], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

template <int C>
__global__ void __launch_bounds__(128 * C, 1) flash_masked_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S,
    int valid_len, float sl2) {
  constexpr bool kTurns = kPingpong && C > 1;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  // the swizzle atoms must start on 512-byte boundaries of shared memory
  unsigned char* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  const int n_tiles = (valid_len + kBN - 1) / kBN;
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + C * kQSlice;           // tile t at sK + t * kTileBytes
  unsigned char* sV = sK + n_tiles * kTileBytes;  // tile t at sV + t * kTileBytes
  Barriers* bars = reinterpret_cast<Barriers*>(sV + n_tiles * kTileBytes);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * 64 * C;
  if (threadIdx.x == 0) {
    bar_init(&bars->q_full, 1);
    for (int t = 0; t < n_tiles; ++t) {
      bar_init(&bars->k_full[t], 1);
      bar_init(&bars->v_full[t], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bar_expect_tx(&bars->q_full, C * kQSlice);
#pragma unroll
    for (int c = 0; c < C; ++c) tma_load_3d(sQ + c * kQSlice, &tq, &bars->q_full, 0, q0 + 64 * c, bh);
    for (int t = 0; t < n_tiles; ++t) {
      bar_expect_tx(&bars->k_full[t], kTileBytes);
      tma_load_3d(sK + t * kTileBytes, &tk, &bars->k_full[t], 0, t * kBN, bh);
      bar_expect_tx(&bars->v_full[t], kTileBytes);
      tma_load_3d(sV + t * kTileBytes, &tv, &bars->v_full[t], 0, t * kBN, bh);
    }
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const uint32_t q_wg = smem_u32(sQ) + wg * kQSlice;
  const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
  const bool ragged = valid_len % kBN != 0;

  float s[kBN / 2] = {}, acc[16] = {};
  uint32_t p[kBN / 16][4] = {};
  float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, l[2] = {0.f, 0.f}, corr[2];

  // Pingpong as in csrc/flash_attention_wgmma.cu: consumer w issues its
  // round's products after turn_sync(1 + w) and hands the turn to the next
  // one by turn_arrive; consumer 0 takes the first turn and, after its loop,
  // the surplus one.
  const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % C;
  if (kTurns && wg == C - 1) turn_arrive(next_turn);
  auto fence_for_issue = [&]() {
    fence_regs(acc);
    fence_regs(p);
    fence_regs(s);
    wgmma_fence();
  };
  auto hand_on = [&]() {
    if (kTurns) turn_arrive(next_turn);
  };

  bar_wait(&bars->q_full, 0);
  // tile 0: scores, softmax, P
  bar_wait(&bars->k_full[0], 0);
  if (kTurns) turn_sync(my_turn);
  fence_for_issue();
  issue_scores(s, q_wg, k_base);
  wgmma_commit();
  hand_on();
  wgmma_wait<0>();
  fence_regs(s);
  softmax_tile<true>(s, m, l, corr, sl2, ragged && n_tiles == 1, 0, valid_len);
  pack_p(p, s);  // the output is 0 so far: no rescale

  // tile t's scores and softmax, tile t - 1's P V; kLast: t may be the
  // last tile, whose keys past valid_len are masked
  auto step = [&](int t, auto last) {
    constexpr bool kLast = decltype(last)::value;
    if constexpr (kOverlap) {
      bar_wait(&bars->k_full[t], 0);
      bar_wait(&bars->v_full[t - 1], 0);
      if (kTurns) turn_sync(my_turn);
      fence_for_issue();
      issue_scores(s, q_wg, k_base + t * kTileBytes);
      wgmma_commit();
      issue_pv(acc, p, v_base + (t - 1) * kTileBytes);
      wgmma_commit();
      hand_on();
      wgmma_wait<1>();  // the scores are in
      fence_regs(s);
      const bool raised = softmax_tile<kLast>(s, m, l, corr, sl2, ragged && t == n_tiles - 1,
                                              t * kBN, valid_len);
      wgmma_wait<0>();  // P V of tile t - 1 is in
      fence_regs(acc);
      fence_regs(p);
      fence_regs(s);
      if (raised || !kLazyRescale) rescale(acc, corr);
      pack_p(p, s);
    } else {
      bar_wait(&bars->v_full[t - 1], 0);
      fence_for_issue();
      issue_pv(acc, p, v_base + (t - 1) * kTileBytes);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      bar_wait(&bars->k_full[t], 0);
      if (kTurns) turn_sync(my_turn);
      fence_for_issue();
      issue_scores(s, q_wg, k_base + t * kTileBytes);
      wgmma_commit();
      hand_on();
      wgmma_wait<0>();
      fence_regs(s);
      const bool raised = softmax_tile<kLast>(s, m, l, corr, sl2, ragged && t == n_tiles - 1,
                                              t * kBN, valid_len);
      if (raised || !kLazyRescale) rescale(acc, corr);
      pack_p(p, s);
    }
  };
  for (int t = 1; t < n_tiles - (kPeelLast ? 1 : 0); ++t)
    step(t, std::integral_constant<bool, !kPeelLast>{});
  if (kPeelLast && n_tiles > 1) step(n_tiles - 1, std::true_type{});
  if (kTurns && wg == 0) turn_sync(my_turn);  // the last consumer's last turn
  // P V of the last tile
  bar_wait(&bars->v_full[n_tiles - 1], 0);
  fence_for_issue();
  issue_pv(acc, p, v_base + (n_tiles - 1) * kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  // the warp's 16 rows, divided by their denominators in f32, rounded once
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const int row0 = q0 + wg * 64 + ((threadIdx.x / 32) & 3) * 16 + lane / 4;
  __nv_bfloat16* ob = o + (static_cast<long long>(bh) * S + row0) * kD + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row0 + 8 * h < S) {
      __nv_bfloat16* orow = ob + 8 * h * kD;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            bff_tc::pack_bf16(acc[4 * j + 2 * h] / l[h], acc[4 * j + 2 * h + 1] / l[h]);
    }
  }
}

// Consumer warpgroups per block for (BH, S) on ``sms`` SMs: the C in {4, 2,
// 1} of the least cost, the waves of blocks (one block an SM: the keys fill
// its shared memory) times C + 2, a block's time in units of one
// warpgroup's exponentials plus the latency no other warpgroup hides (two
// units, measured at (8, 900, 32)); ties go to the larger C (fewer blocks
// load the same keys). kernels/flash_attention.py masked_wgmma_schedule
// mirrors it.
int choose_consumers(int BH, int S, int sms) {
  int best = 4;
  long long best_cost = -1;
  for (int c = 4; c >= 1; c /= 2) {
    const long long blocks = (long long)BH * ((S + 64 * c - 1) / (64 * c));
    const long long cost = (blocks + sms - 1) / sms * (c + 2);
    if (best_cost < 0 || cost < best_cost) {
      best = c;
      best_cost = cost;
    }
  }
  return best;
}

template <int C>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o, int BH,
           int S, int valid_len, float sl2, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash_masked_wgmma_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(C, kMaxTiles));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_tiles = (valid_len + kBN - 1) / kBN;
  dim3 grid((S + 64 * C - 1) / (64 * C), BH);
  flash_masked_wgmma_kernel<C><<<grid, 128 * C, smem_bytes(C, n_tiles), stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, valid_len, sl2);
  return (int)cudaGetLastError();
}

}  // namespace

// The routing predicate (kernels/flash_attention.py masked_wgmma_route
// mirrors it): 1 when bff_flash_attention takes this kernel for the call.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int bff_flash_masked_wgmma_takes(int dtype, int D, int S, int valid_len, float scale,
                                            const void* q, const void* k, const void* v,
                                            const void* o) {
  return dtype == 1 && D == kD && S >= 1 && valid_len >= 1 && valid_len <= S &&
         valid_len <= kMaxKeys && scale > 0.f && scale <= FLT_MAX && aligned16(q) &&
         aligned16(k) && aligned16(v) && aligned16(o);
}

// q, k, v, o: contiguous (BH, S, 32) bf16. Returns cudaGetLastError() after
// the launch, -1 for arguments outside the predicate, -2 when the driver's
// cuTensorMapEncodeTiled is not found, -3 for a misaligned base or stride,
// -1000 - CUresult for a failed encode.
extern "C" int bff_flash_masked_wgmma(const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int valid_len, float scale, void* stream) {
  if (BH < 1 || !bff_flash_masked_wgmma_takes(1, kD, S, valid_len, scale, q, k, v, o)) return -1;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  CUtensorMap tq, tk, tv;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_64B;
  int rc = encode_3d(fn, &tq, q, kD, S, BH, kD, 64, sw);
  if (rc == 0) rc = encode_3d(fn, &tk, k, kD, S, BH, kD, kBN, sw);
  if (rc == 0) rc = encode_3d(fn, &tv, v, kD, S, BH, kD, kBN, sw);
  if (rc != 0) return rc;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const float sl2 = scale * bff_tc::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (choose_consumers(BH, S, sms)) {
    case 4:
      return launch<4>(tq, tk, tv, o, BH, S, valid_len, sl2, st);
    case 2:
      return launch<2>(tq, tk, tv, o, BH, S, valid_len, sl2, st);
    default:
      return launch<1>(tq, tk, tv, o, BH, S, valid_len, sl2, st);
  }
}
