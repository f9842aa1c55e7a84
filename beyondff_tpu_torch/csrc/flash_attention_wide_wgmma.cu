// Flash attention at head dims 144 to 256 for Hopper (sm_90a): wgmma, TMA
// and a warp-specialised pipeline, each block holding the whole head dim.
//
// Replaces, for bf16 at head dims past 128, the TPU kernels
// beyondff_tpu/kernels/flash_attention.py flash_attention (:68, pallas_call
// :78; every key valid, K3) and _flash_masked (:270, pallas_call :313,
// reached through attend :101; keys >= valid_len masked, K2): softmax(Q K^T
// * scale) V over (BH, S, D), an online max and denominator, P rounded to
// bf16 before P V (:55-57, :302-305), the denominator summed from the f32
// probabilities and the output divided once in f32. No configured model
// calls a head dim past 128; the JAX functions take any. bff_flash_attention
// (csrc/flash_attention.cu) routes here exactly the calls that
// bff_flash_wide_wgmma_takes accepts: bf16, D % 16 == 0 with 128 < D <= 256,
// S >= 1, 1 <= valid_len <= S, a positive finite scale and 16-byte aligned
// q, k, v and o. Other bf16 calls past head dim 128 keep the mma.sync
// tile's 128-feature slices (attention_tc.cuh, attend_block_sliced) or,
// off 16 bytes, the FMA kernel; those recompute the scores once a slice.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at (16, 1024, 256)
// the function does 4 * 16 * 1024^2 * 256 = 17.2 GFLOP (0.0174 ms) and
// moves 4 * 16 * 1024 * 256 * 2 = 33.6 MB (0.0100 ms); at (16, 4096, 256)
// 275 GFLOP (0.278 ms) against 134 MB: bound by operations.
//
// Design (a block of two warpgroups over a 128-query tile of one head; grid
// (ceil(S / 128), BH), one block an SM):
// * Every load is a TMA copy: Q's 128 rows and the first two 64-key K and V
//   tiles from the first thread at the start, then each later K and V tile
//   into a ring of two stages with full and empty mbarriers, issued by the
//   first thread of the second warpgroup (which takes its turn at the
//   tensor cores after the first, so its waits on the empty barriers
//   seldom stall) once its own step on the stage's previous tile is done:
//   K(t + 2) after step t, V(t + 1) after step t, with no wgmma in flight.
//   Key tiles wholly past valid_len are never loaded. The tensor maps are
//   3-D over (BH, S, D), so rows past S of a head are zero-filled. A wait
//   that never ends traps (bar_wait_or_trap): the launch fails and the
//   wrapper raises instead of the card hanging.
// * The head dim in TMA boxes: the kernel is built for DP, D rounded up to
//   a multiple of 32 (160, 192, 224, 256: four instances, not eight), in
//   DP / 64 boxes of 64 columns in the 128-byte swizzle and, where DP % 64
//   is 32, one of 32 columns in the 64-byte swizzle (D 160: 64 + 64 + 32),
//   the way relpos_attention_wgmma.cu splits D 80. The tensor maps hold the
//   true D, so the TMA zero-fills columns D .. DP - 1 (16 of them at D 144,
//   176, 208 and 240, up to 11% more products); they add nothing to the
//   scores and their output columns are not written. A 64-row tile of Q, K
//   or V is its boxes one after another (8 and 4 KB, each on a multiple of
//   4 KB). kernels/flash_attention.py wide_wgmma_boxes mirrors the plan.
// * Each consumer warpgroup takes 64 query rows. S = Q K^T is
//   wgmma.m64n64k16 with both operands in shared memory, K-major, D / 16
//   k-steps across the boxes (the first writes the scores without reading
//   them); P in bf16 is the register A operand of O += P V, one wgmma chain
//   of four k-steps per box of V (m64n64k16, m64n32k16, m64n16k16; MN-major
//   through the transpose bit). Every score is computed once, where the
//   sliced tile computed it ceil(D / 128) times.
// * Registers: O at m64nDP is DP / 2 f32 a thread (128 at D 256), the scores
//   32, P 16. ptxas holds a block with three warps on one of the SM's four
//   register partitions (384 threads; 288, a producer warp beside two
//   warpgroups, measured too) to 168 registers a thread whatever setmaxnreg
//   asks (csrc/flash_attention_tf32.cu): at D 176 and up that spilled
//   (24 bytes at D 176, 1 264 at D 256). So there is no producer: a block
//   of 256 threads, two warps a partition, gets 255 registers (238 used at
//   D 256, none spilled). No branch
//   stands between a wgmma issue and its wait (ptxas then serializes every
//   wgmma, warning C7520).
// * Shared memory: Q 128 x DP, two K and two V stages of 64 x DP, all
//   bf16: 768 DP bytes, 196 608 at D 256, one block an SM.
// * Within a consumer, tile t's Q K^T is issued before tile t - 1's P V
//   (kOverlap); across the two consumers, pingpong (kPingpong): they take
//   turns, by named barriers, to issue their products, as in K2's and K3's
//   kernels. The running max is raised only when a row outgrows it by 2^8
//   (every lane of the warp agreeing), scale * log2(e) folded into one FMA
//   before ex2.approx.
// * valid_len: the last key tile, the only one that can be ragged, runs
//   after the loop with keys >= valid_len at -inf and its column tiles wholly
//   past valid_len at p = 0 (csrc/flash_masked_wgmma.cu's kPeelLast). Query
//   rows >= S are not written.
//
// Host: the tensor maps of a call (one per box width for each of q, k and
// v) are encoded on every call through bff_wg::encode_tiled and passed as
// one __grid_constant__ parameter. A failed lookup, encode or launch
// returns non-zero and the wrapper raises: nothing falls back to another
// kernel.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "wide_wgmma.cuh"

namespace {

using namespace bff_wide;

constexpr bool kOverlap = true;   // issue Q K^T of tile t before P V of tile t - 1
constexpr bool kPingpong = true;  // the consumers take turns to issue their products

template <int DP>
__global__ void __launch_bounds__(kThreads, 1) flash_wide_wgmma_kernel(
    const __grid_constant__ Maps maps, __nv_bfloat16* __restrict__ o, int S, int D,
    int valid_len, float sl2) {
  using B = Boxes<DP>;
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  // the swizzle atoms must start on 1024-byte boundaries of shared memory
  unsigned char* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;                          // consumer c's rows at sQ + c * kTile
  unsigned char* sK = sQ + kConsumers * B::kTile;    // stage st at sK + st * kTile
  unsigned char* sV = sK + kStages * B::kTile;       // stage st at sV + st * kTile
  Barriers* bars = reinterpret_cast<Barriers*>(sV + kStages * B::kTile);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (valid_len + kBN - 1) / kBN;
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
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // after step t (this thread's warpgroup's products of tile t done): K(t +
  // 2) into K(t)'s stage once both warpgroups' Q K^T of tile t are done,
  // V(t + 1) into V(t - 1)'s stage once both P V of tile t - 1 are
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

  const int lane = threadIdx.x & 31;
  const bool signals = lane == 0;  // one arrival per consumer warp
  const uint32_t q_wg = smem_u32(sQ) + wg * B::kTile;
  const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
  const bool ragged = valid_len % kBN != 0;

  float s[32] = {};
  Acc<DP> acc;
  zero_acc<DP>(acc);
  uint32_t p[4][4] = {};
  float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, l[2] = {0.f, 0.f}, corr[2];

  // Pingpong as in csrc/flash_attention_wgmma.cu: consumer w issues its
  // round's products after turn_sync(1 + w) and hands the turn to the other
  // by turn_arrive; consumer 0 takes the first turn and, after its loop,
  // the surplus one.
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
  // tile 0: scores, softmax, P
  bar_wait_or_trap(&bars->k_full[0], 0);
  if (kPingpong) turn_sync(my_turn);
  fence_for_issue();
  issue_scores<DP>(s, q_wg, k_base);
  wgmma_commit();
  hand_on();
  wgmma_wait<0>();
  fence_regs(s);
  if (signals) bar_arrive(&bars->k_empty[0]);
  softmax_tile<true>(s, m, l, corr, sl2, ragged && n_tiles == 1, 0, valid_len);
  pack_p(p, s);  // the output is 0 so far: no rescale
  refill(0);

  // tile t's scores and softmax, tile t - 1's P V; kLast: t is the last
  // tile, whose keys past valid_len are masked
  auto step = [&](int t, auto last) {
    constexpr bool kLast = decltype(last)::value;
    const int st = t % kStages, parity = (t / kStages) & 1;
    const int pst = (t - 1) % kStages, pparity = ((t - 1) / kStages) & 1;
    if constexpr (kOverlap) {
      bar_wait_or_trap(&bars->k_full[st], parity);
      bar_wait_or_trap(&bars->v_full[pst], pparity);
      if (kPingpong) turn_sync(my_turn);
      fence_for_issue();
      issue_scores<DP>(s, q_wg, k_base + st * B::kTile);
      wgmma_commit();
      issue_pv<DP>(acc, p, v_base + pst * B::kTile);
      wgmma_commit();
      hand_on();
      wgmma_wait<1>();  // the scores are in
      fence_regs(s);
      if (signals) bar_arrive(&bars->k_empty[st]);
      const bool raised = softmax_tile<kLast>(s, m, l, corr, sl2, ragged && kLast, t * kBN,
                                              valid_len);
      wgmma_wait<0>();  // P V of tile t - 1 is in
      fence_acc(acc);
      fence_regs(p);
      fence_regs(s);
      if (signals) bar_arrive(&bars->v_empty[pst]);
      if (raised) rescale<DP>(acc, corr);
      pack_p(p, s);
      refill(t);
    } else {
      bar_wait_or_trap(&bars->v_full[pst], pparity);
      fence_for_issue();
      issue_pv<DP>(acc, p, v_base + pst * B::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc);
      if (signals) bar_arrive(&bars->v_empty[pst]);
      bar_wait_or_trap(&bars->k_full[st], parity);
      if (kPingpong) turn_sync(my_turn);
      fence_for_issue();
      issue_scores<DP>(s, q_wg, k_base + st * B::kTile);
      wgmma_commit();
      hand_on();
      wgmma_wait<0>();
      fence_regs(s);
      if (signals) bar_arrive(&bars->k_empty[st]);
      const bool raised = softmax_tile<kLast>(s, m, l, corr, sl2, ragged && kLast, t * kBN,
                                              valid_len);
      if (raised) rescale<DP>(acc, corr);
      pack_p(p, s);
      refill(t);
    }
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
                 q0 + wg * 64 + ((threadIdx.x / 32) & 3) * 16 + lane / 4, S, D);
}

template <int DP>
int launch(const Maps& maps, void* o, int BH, int S, int D, int valid_len, float sl2,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wide_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Boxes<DP>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + kBM - 1) / kBM, BH);
  flash_wide_wgmma_kernel<DP><<<grid, kThreads, Boxes<DP>::kSmemBytes, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), S, D, valid_len, sl2);
  return (int)cudaGetLastError();
}

}  // namespace

// The routing predicate (kernels/flash_attention.py wide_wgmma_route
// mirrors it): 1 when bff_flash_attention takes this kernel for the call.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int bff_flash_wide_wgmma_takes(int dtype, int D, int S, int valid_len, float scale,
                                          const void* q, const void* k, const void* v,
                                          const void* o) {
  return dtype == 1 && D % 16 == 0 && D >= kMinD && D <= kMaxD && S >= 1 && valid_len >= 1 &&
         valid_len <= S && scale > 0.f && scale <= FLT_MAX && aligned16(q) && aligned16(k) &&
         aligned16(v) && aligned16(o);
}

// q, k, v, o: contiguous (BH, S, D) bf16. Returns cudaGetLastError() after
// the launch, -1 for arguments outside the predicate, -2 when the driver's
// cuTensorMapEncodeTiled is not found, -3 for a misaligned base or stride,
// -1000 - CUresult for a failed encode.
extern "C" int bff_flash_wide_wgmma(const void* q, const void* k, const void* v, void* o, int BH,
                                    int S, int D, int valid_len, float scale, void* stream) {
  if (BH < 1 || !bff_flash_wide_wgmma_takes(1, D, S, valid_len, scale, q, k, v, o)) return -1;
  Maps maps = {};
  const int rc = encode_maps(maps, q, k, v, BH, S, D);
  if (rc != 0) return rc;
  const float sl2 = scale * bff_tc::kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + kDStep - 1) / kDStep * kDStep) {
    case 160: return launch<160>(maps, o, BH, S, D, valid_len, sl2, st);
    case 192: return launch<192>(maps, o, BH, S, D, valid_len, sl2, st);
    case 224: return launch<224>(maps, o, BH, S, D, valid_len, sl2, st);
    default: return launch<256>(maps, o, BH, S, D, valid_len, sl2, st);
  }
}
