// Attention with SAM's decomposed relative-position bias at head dims 144 to
// 256 for Hopper (sm_90a): wgmma and TMA, each block holding the whole head
// dim, each 64-key tile's factor columns streamed into shared memory.
//
// Replaces, for bf16 at head dims past 128, the TPU kernel
// beyondff_tpu/kernels/flash_attention.py flash_attention_relpos (:193,
// pallas_call :214, body _relpos_kernel :128, wrapper attend_relpos :253):
// softmax(Q K^T * scale + bias) V over a raster-ordered (kh, kw) key grid,
// bias[q, k] = bias_h[q, k / kw] + bias_w[q, k % kw] added in f32 to the
// unscaled products' scaled logits (:153-170), an online max and
// denominator, P rounded to bf16 before P V (:180-182), the output divided
// once by the f32 denominator. No configured model calls a head dim past
// 128 (SAM's rel-pos heads are 64 and 80); attend_relpos takes any.
// bff_flash_attention_relpos and bff_window_attention_relpos
// (csrc/relpos_attention.cu, K5's windows that run K4's kernels as heads)
// route here exactly the calls that bff_relpos_wide_wgmma_takes accepts:
// bf16, D % 16 == 0 with 128 < D <= 256, kh * kw = S on any grid (inside
// or past the factor table), a positive finite scale, q, k, v and o on 16
// bytes and both factors on 4. Before this kernel such calls ran on the
// mma.sync tile's 128-feature slices or, past kh + kw = 256, the FMA
// kernel's, each recomputing the scores once a slice.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at (16, 1024, 160) on
// 32 x 32 the function does 4 * 16 * 1024^2 * 160 = 10.7 GFLOP (0.0109 ms)
// and moves 4 * 16 * 1024 * 160 * 2 + 16 * 1024 * 64 * 2 bytes (23 MB, 0.0069
// ms); at (16, 1024, 256) 17.2 GFLOP (0.0174 ms): bound by operations. At
// 16 heads of a 2 x 255 grid, D 160: 2.7 GFLOP (0.0027 ms) against 10.4 MB
// of q, k, v, o and 4.2 MB of factors (0.0044 ms): bound by bytes.
//
// Design: csrc/flash_attention_wide_wgmma.cu's block (wide_wgmma.cuh: the
// head dim rounded up to DP in 64- and 32-column TMA boxes, two consumer
// warpgroups of 64 query rows and no producer, K and V in a two-stage ring,
// Q K^T issued before the last tile's P V, the warpgroups taking turns;
// four instances, DP 160, 192, 224 and 256) with the bias between the
// products and the online softmax:
// * Each warp stages its own 16 rows' factors into its part of a table in
//   shared memory beside the operands, by 4-byte cp.async (the factor
//   bases need only be on 4 bytes, and a row's piece starts at any
//   element): for each 64-key tile, bias_h's columns y0 .. (k0 + 63) / kw
//   (at most 62 / kw + 2), and, past kFixedW = 64 grid columns, bias_w's
//   run of 64 columns from k0 % kw, which wraps at most once; up to 64 grid
//   columns bias_w sits whole in a fixed part staged once. That is
//   attention_tc.cuh's streamed plan (StreamedBias, route A of the mma.sync
//   tile) with the fixed part cut from 160 to 64 columns and one slot: the
//   operands take 768 DP bytes (196 608 at DP 256), and a slot with the
//   fixed part is at most 36 words a row (stream_ld: 88 elements, 22 528
//   bytes for 128 rows), so DP 256 still fits the 232 448-byte limit (two
//   slots would not; at DP 160-224 a second slot measured 2.5-3.0% slower,
//   PERF.md). The lane's rows are lane / 4 and lane / 4 + 8 of its
//   warp's 16, the rows its copies write: the warp waits for its own
//   copies (cp.async.wait_group, __syncwarp) and no barrier of the block is
//   needed. A tile's copies are issued right after the previous tile's
//   bias is read and have a whole step (both warpgroups' products) to land.
// * The bias is added where the scores are in: the lane's 16 keys of the
//   tile (columns 8 j + 2 (lane % 4) + e, the accumulator layout) are taken
//   to their grid cells once a tile by one division and steps of 8 keys,
//   each cell to its two table entries, and each logit is one FMA,
//   s * scale + bias_h + bias_w in f32; keys past S are -inf. The online
//   softmax then runs in log2 units with log2(e) as its scale.
// * Registers: the factors' column map is formed and used key by key (no
//   array of offsets stays live); ptxas reports the instances' registers
//   (tools/kernel_variants.py writes the report; PERF.md has the numbers).
//
// Host: the tensor maps of a call are encoded on every call; a failed
// lookup, encode or launch returns non-zero and the wrapper raises: nothing
// falls back to another kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "wide_wgmma.cuh"

namespace {

using namespace bff_wide;

constexpr bool kPingpong = true;  // the consumers take turns to issue their products
constexpr int kFixedW = 64;       // bias_w whole in a fixed part up to this many grid columns
constexpr int kWarpRows = 16;

// What staging and reading the factors takes, the same for every block of a
// call: a kernel parameter, so these stay in the parameter bank and hold no
// registers across the loop.
struct FactorArgs {
  const __nv_bfloat16* bh;  // bias_h (rows, kh), every head's
  const __nv_bfloat16* bw;  // bias_w (rows, kw)
  long long rows;           // BH * S
  int kh, kw, S, ld, hw, sw;  // ld, hw, sw: bff_tc's stream_ld, stream_h_words, stream_slot_words
};

// A warp's 16 rows of the factor table (row r: block row 16 warp + r, flat
// factor row row0 + r; rows at or past S zero-filled) and what staging and
// reading them takes; kernels/flash_attention.py relpos_stream_layout,
// relpos_stream_stage and relpos_stream_offsets (fixed_w = 64, slots = 1)
// mirror it.
struct WarpFactors {
  const FactorArgs& a;
  __nv_bfloat16* table;  // the warp's rows, a.ld elements apart
  long long row0;        // head * S + r0
  int r0;                // the warp's first row of its head

  // bias_w whole, up to kFixedW columns, after the slot; once.
  __device__ __forceinline__ void stage_fixed() const {
    if (a.kw > kFixedW) return;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane / 4 + 8 * i;
      bff_tc::stream_piece(table + r * a.ld + 2 * a.sw, a.bw, a.rows * a.kw,
                           (row0 + r) * a.kw, a.kw, lane & 3, r0 + r < a.S);
    }
  }

  // Key tile k0's factor columns into the slot, four lanes a row: bias_h's
  // piece and, past kFixedW columns, bias_w's pieces A (x0 .. kw - 1) and B
  // (0 ..) from the word after A's.
  __device__ __forceinline__ void stage(int k0) const {
    const int lane = threadIdx.x & 31, kh = a.kh, kw = a.kw;
    const int y0 = k0 / kw, x0 = k0 - y0 * kw, n = min(kBN, a.S - k0);
    const int nh = (k0 + n - 1) / kw - y0 + 1;
    const int na = min(n, kw - x0), nb = n - na;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane / 4 + 8 * i;
      const long long R = row0 + r;
      const bool live = r0 + r < a.S;
      __nv_bfloat16* dst = table + r * a.ld;
      bff_tc::stream_piece(dst, a.bh, a.rows * kh, R * kh + y0, nh, lane & 3, live);
      if (kw > kFixedW) {
        const long long ea = R * kw + x0;
        const int wa = (static_cast<int>(ea & 1) + na + 1) >> 1;
        bff_tc::stream_piece(dst + 2 * a.hw, a.bw, a.rows * kw, ea, na, lane & 3, live);
        bff_tc::stream_piece(dst + 2 * (a.hw + wa), a.bw, a.rows * kw, R * kw, nb, lane & 3,
                             live);
      }
    }
  }

  // The raw scores of key tile k0 (the lane's rows lane / 4 and + 8 of the
  // warp) into logits in natural units: s * scale + bias_h[q, ky] +
  // bias_w[q, kx] in f32, keys >= S at -inf. The lane's rows share the
  // parity of their flat row, so one column map serves both; each key's
  // cell is advanced by 8 keys from one division (one wrap at kw >= 8, a
  // division below). Reading a key pair's factors together where kw is
  // even was measured and lost (PERF.md, PR 26).
  __device__ __forceinline__ void apply(float (&s)[32], int k0, float scale) const {
    const int lane = threadIdx.x & 31, kh = a.kh, kw = a.kw, S = a.S, hw = a.hw, sw = a.sw;
    const int y0 = k0 / kw, x0 = k0 - y0 * kw, n = min(kBN, S - k0);
    const int rho = static_cast<int>((row0 + lane / 4) & 1);
    const int hbase = ((rho * kh + y0) & 1) - y0;
    int xa = 0, abase, bbase = 0;
    if (kw > kFixedW) {
      const int pa = (rho * kw + x0) & 1, na = min(n, kw - x0);
      xa = x0;
      abase = 2 * hw + pa - x0;
      bbase = 2 * hw + 2 * ((pa + na + 1) >> 1) + ((rho * kw) & 1);
    } else {
      abase = 2 * sw + ((rho * kw) & 1);  // the fixed part
    }
    const __nv_bfloat16* f0 = table + (lane / 4) * a.ld;
    const __nv_bfloat16* f1 = f0 + 8 * a.ld;
    int key = k0 + 2 * (lane & 3);
    int ky = key / kw, kx = key - ky * kw;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool wrap = kx + e == kw;
        const int y = ky + wrap, x = wrap ? 0 : kx + e;
        const bool in = key + e < S;
        const int ho = in ? hbase + y : 0, wo = in ? (x >= xa ? abase + x : bbase + x) : 0;
        const float b0 = __bfloat162float(f0[ho]) + __bfloat162float(f0[wo]);
        const float b1 = __bfloat162float(f1[ho]) + __bfloat162float(f1[wo]);
        s[4 * j + e] = in ? fmaf(s[4 * j + e], scale, b0) : bff_tc::masked_score();
        s[4 * j + 2 + e] = in ? fmaf(s[4 * j + 2 + e], scale, b1) : bff_tc::masked_score();
      }
      key += 8;
      if (kw >= 8) {
        kx += 8;
        const bool wrap = kx >= kw;
        kx -= wrap ? kw : 0;
        ky += wrap;
      } else {
        ky = key / kw;
        kx = key - ky * kw;
      }
    }
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) relpos_wide_wgmma_kernel(
    const __grid_constant__ Maps maps, const __grid_constant__ FactorArgs fargs,
    __nv_bfloat16* __restrict__ o, int S, int D, float scale) {
  using B = Boxes<DP>;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  // the swizzle atoms must start on 1024-byte boundaries of shared memory
  unsigned char* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                          // consumer c's rows at sQ + c * kTile
  unsigned char* sK = sQ + kConsumers * B::kTile;    // stage st at sK + st * kTile
  unsigned char* sV = sK + kStages * B::kTile;       // stage st at sV + st * kTile
  Barriers* bars = reinterpret_cast<Barriers*>(sV + kStages * B::kTile);
  __nv_bfloat16* sF = reinterpret_cast<__nv_bfloat16*>(sV + kStages * B::kTile + 128);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (S + kBN - 1) / kBN;
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
    bar_expect_tx(&bars->q_full, kConsumers * B::kTile);
#pragma unroll
    for (int c = 0; c < kConsumers; ++c)
      load_rows<DP>(sQ + c * B::kTile, maps.q, &bars->q_full, q0 + 64 * c, bh);
    for (int t = 0; t < kStages && t < n_tiles; ++t) {
      bar_expect_tx(&bars->k_full[t], B::kTile);
      load_rows<DP>(sK + t * B::kTile, maps.k, &bars->k_full[t], t * kBN, bh);
      bar_expect_tx(&bars->v_full[t], B::kTile);
      load_rows<DP>(sV + t * B::kTile, maps.v, &bars->v_full[t], t * kBN, bh);
    }
  }
  // the warp's rows of the factors: the fixed part and the first tile's
  const int warp = threadIdx.x / 32;  // block rows 16 warp .. 16 warp + 15
  const WarpFactors fac{fargs, sF + kWarpRows * warp * fargs.ld,
                        static_cast<long long>(bh) * S + q0 + kWarpRows * warp,
                        q0 + kWarpRows * warp};
  fac.stage_fixed();
  fac.stage(0);
  bff_tc::cp_async_commit();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // after step t: K(t + 2) into K(t)'s stage once both warpgroups' Q K^T of
  // tile t are done, V(t + 1) into V(t - 1)'s stage once both P V of tile
  // t - 1 are (flash_attention_wide_wgmma.cu's refill)
  const bool refills = threadIdx.x == 128 * (kConsumers - 1);
  auto refill = [&](int t) {
    if (!refills) return;
    if (t + kStages < n_tiles) {
      const int st = t % kStages;
      bar_wait_or_trap(&bars->k_empty[st], (t / kStages) & 1);
      bar_expect_tx(&bars->k_full[st], B::kTile);
      load_rows<DP>(sK + st * B::kTile, maps.k, &bars->k_full[st], (t + kStages) * kBN, bh);
    }
    if (t >= 1 && t + 1 < n_tiles) {
      const int st = (t - 1) % kStages;
      bar_wait_or_trap(&bars->v_empty[st], ((t - 1) / kStages) & 1);
      bar_expect_tx(&bars->v_full[st], B::kTile);
      load_rows<DP>(sV + st * B::kTile, maps.v, &bars->v_full[st], (t + 1) * kBN, bh);
    }
  };
  // tile t's scores into logits (its factors in the warp's slot), then the
  // copies of tile t + 1's factors into the slot
  auto add_bias = [&](float (&s)[32], int t) {
    bff_tc::cp_async_wait<0>();
    __syncwarp();
    fac.apply(s, t * kBN, scale);
    __syncwarp();  // every lane has read the slot
    if (t + 1 < n_tiles) fac.stage((t + 1) * kBN);
    bff_tc::cp_async_commit();
  };

  const int lane = threadIdx.x & 31;
  const bool signals = lane == 0;  // one arrival per consumer warp
  const uint32_t q_wg = smem_u32(sQ) + wg * B::kTile;
  const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
  const bool ragged = S % kBN != 0;

  float s[32] = {};
  Acc<DP> acc;
  zero_acc<DP>(acc);
  uint32_t p[4][4] = {};
  float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, l[2] = {0.f, 0.f}, corr[2];

  // pingpong as in csrc/flash_attention_wide_wgmma.cu
  const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
  if (kPingpong && wg == kConsumers - 1) turn_arrive(next_turn);
  auto fence_for_issue = [&]() {
    fence_acc(acc);
    fence_regs(p);
    fence_regs(s);
    wgmma_fence();
  };
  auto hand_on = [&]() {
    if (kPingpong) turn_arrive(next_turn);
  };

  bar_wait_or_trap(&bars->q_full, 0);
  // tile 0: scores, bias, softmax, P
  bar_wait_or_trap(&bars->k_full[0], 0);
  if (kPingpong) turn_sync(my_turn);
  fence_for_issue();
  issue_scores<DP>(s, q_wg, k_base);
  wgmma_commit();
  hand_on();
  wgmma_wait<0>();
  fence_regs(s);
  if (signals) bar_arrive(&bars->k_empty[0]);
  add_bias(s, 0);
  softmax_tile<true>(s, m, l, corr, bff_tc::kLog2e, ragged && n_tiles == 1, 0, S);
  pack_p(p, s);  // the output is 0 so far: no rescale
  refill(0);

  // tile t's scores, bias and softmax, tile t - 1's P V; kLast: t is the
  // last tile, whose keys past S are masked
  auto step = [&](int t, auto last) {
    constexpr bool kLast = decltype(last)::value;
    const int st = t % kStages, parity = (t / kStages) & 1;
    const int pst = (t - 1) % kStages, pparity = ((t - 1) / kStages) & 1;
    bar_wait_or_trap(&bars->k_full[st], parity);
    bar_wait_or_trap(&bars->v_full[pst], pparity);
    if (kPingpong) turn_sync(my_turn);
    fence_for_issue();
    // the stages' addresses made opaque once a step: their descriptors are
    // formed here, not hoisted into registers (DP 256 spilled)
    issue_scores<DP>(s, opaque(q_wg), opaque(k_base) + st * B::kTile);
    wgmma_commit();
    issue_pv<DP>(acc, p, opaque(v_base) + pst * B::kTile);
    wgmma_commit();
    hand_on();
    wgmma_wait<1>();  // the scores are in
    fence_regs(s);
    if (signals) bar_arrive(&bars->k_empty[st]);
    add_bias(s, t);
    const bool raised =
        softmax_tile<kLast>(s, m, l, corr, bff_tc::kLog2e, ragged && kLast, t * kBN, S);
    wgmma_wait<0>();  // P V of tile t - 1 is in
    fence_acc(acc);
    fence_regs(p);
    fence_regs(s);
    if (signals) bar_arrive(&bars->v_empty[pst]);
    if (raised) rescale<DP>(acc, corr);
    pack_p(p, s);
    refill(t);
  };
  for (int t = 1; t < n_tiles - 1; ++t) step(t, std::false_type{});
  if (n_tiles > 1) step(n_tiles - 1, std::true_type{});
  if (kPingpong && wg == 0) turn_sync(my_turn);  // the other consumer's last turn
  // P V of the last tile
  const int lst = (n_tiles - 1) % kStages, lparity = ((n_tiles - 1) / kStages) & 1;
  bar_wait_or_trap(&bars->v_full[lst], lparity);
  fence_for_issue();
  issue_pv<DP>(acc, p, v_base + lst * B::kTile);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);

  // the warp's 16 rows, divided by their denominators in f32, rounded once
  store_rows<DP>(acc, l, o + static_cast<long long>(bh) * S * D,
                 q0 + kWarpRows * warp + lane / 4, S, D);
}

// The dynamic shared memory of a call: the operands and barriers, then the
// factor table of the block's 128 rows.
template <int DP>
int smem_bytes(int kw) {
  return Boxes<DP>::kSmemBytes + kBM * bff_tc::stream_ld(kw, kFixedW, 1) * 2;
}

template <int DP>
int launch(const Maps& maps, const void* bias_h, const void* bias_w, void* o, int BH, int S,
           int D, int kh, int kw, float scale, cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int bytes = smem_bytes<DP>(kw);
  const cudaError_t err = bff_tc::allow_smem(relpos_wide_wgmma_kernel<DP>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  const FactorArgs fargs{static_cast<const __nv_bfloat16*>(bias_h),
                         static_cast<const __nv_bfloat16*>(bias_w),
                         static_cast<long long>(BH) * S,
                         kh,
                         kw,
                         S,
                         bff_tc::stream_ld(kw, kFixedW, 1),
                         bff_tc::stream_h_words(kw),
                         bff_tc::stream_slot_words(kw, kFixedW)};
  dim3 grid((S + kBM - 1) / kBM, BH);
  relpos_wide_wgmma_kernel<DP><<<grid, kThreads, bytes, stream>>>(
      maps, fargs, static_cast<__nv_bfloat16*>(o), S, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The routing predicate (kernels/flash_attention.py relpos_wide_wgmma_route
// mirrors it): 1 when the rel-pos entries of csrc/relpos_attention.cu take
// this kernel for K4 (kind 0, a rows x cols = kh x kw grid) or for K5's
// windows that run K4's kernels (kind 1): bf16, D % 16 == 0 with 128 < D
// <= 256, rows * cols = S, a positive finite scale, q, k, v and o on 16
// bytes, both factors on 4. dtype: 0 = float32, 1 = bfloat16.
extern "C" int bff_relpos_wide_wgmma_takes(int kind, int dtype, int D, int S, int rows, int cols,
                                           float scale, const void* q, const void* k,
                                           const void* v, const void* o, const void* bias_h,
                                           const void* bias_w) {
  const bool shape = (kind == 0 || kind == 1) && rows >= 1 && cols >= 1 &&
                     static_cast<long long>(rows) * cols == S;
  const uintptr_t factors =
      reinterpret_cast<uintptr_t>(bias_h) | reinterpret_cast<uintptr_t>(bias_w);
  return shape && dtype == 1 && D % 16 == 0 && D >= kMinD && D <= kMaxD && scale > 0.f &&
         scale <= FLT_MAX && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
         (factors & 3) == 0;
}

// q, k, v, o: contiguous (BH, S, D) bf16 with S = kh * kw; bias_h (BH, S,
// kh), bias_w (BH, S, kw) bf16. Returns cudaGetLastError() after the
// launch, -1 for arguments outside the predicate, -2 when the driver's
// cuTensorMapEncodeTiled is not found, -3 for a misaligned base or stride,
// -1000 - CUresult for a failed encode.
extern "C" int bff_flash_relpos_wide_wgmma(const void* q, const void* k, const void* v,
                                           const void* bias_h, const void* bias_w, void* o,
                                           int BH, int S, int D, int kh, int kw, float scale,
                                           void* stream) {
  if (BH < 1 || !bff_relpos_wide_wgmma_takes(0, 1, D, S, kh, kw, scale, q, k, v, o, bias_h,
                                             bias_w))
    return -1;
  Maps maps = {};
  const int rc = encode_maps(maps, q, k, v, BH, S, D);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + kDStep - 1) / kDStep * kDStep) {
    case 160: return launch<160>(maps, bias_h, bias_w, o, BH, S, D, kh, kw, scale, st);
    case 192: return launch<192>(maps, bias_h, bias_w, o, BH, S, D, kh, kw, scale, st);
    case 224: return launch<224>(maps, bias_h, bias_w, o, BH, S, D, kh, kw, scale, st);
    default: return launch<256>(maps, bias_h, bias_w, o, BH, S, D, kh, kw, scale, st);
  }
}
