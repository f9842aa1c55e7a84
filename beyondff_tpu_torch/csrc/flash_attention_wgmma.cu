// Flash attention with head dim 64 for Hopper (sm_90a): wgmma, TMA and a
// warp-specialised pipeline.
//
// Replaces the TPU kernel beyondff_tpu/kernels/flash_attention.py
// flash_attention (:68, pallas_call :78, body _flash_kernel :30), reached
// through attend (:101): softmax(Q K^T * scale) V over (BH, S, D) with every
// key valid, an online max and denominator, P rounded to bf16 before P V
// (:55-57) and the output divided once in f32. On the port's main path it
// is EfficientSAM-S's 12 global blocks, (6 B, 4096, 64) bf16 for B frames
// (24 heads at the batch of 4), and (6 B, 3072, 64) on the rect grid.
// bff_flash_attention (csrc/flash_attention.cu) routes here exactly the
// calls that bff_flash_wgmma_takes accepts: bf16, D = 64, every key valid
// (valid_len == S), a positive finite scale and 16-byte aligned q, k, v and
// o. Every other call keeps the mma.sync tile or the FMA kernel.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at (24, 4096, 64) the
// function does 4 * 24 * 4096^2 * 64 = 103 GFLOP (0.104 ms on the tensor
// cores) and moves 4 * 24 * 4096 * 64 * 2 = 50 MB (0.015 ms), so it is
// bound by operations. At head dim 64 the special-function unit is the
// second limit: one exponential per score against 256 tensor-core
// operations, and 16 ex2 a clock per SM against 4096 bf16 operations a
// clock, so the exponentials alone take as long as both products. The
// design keeps both units busy at once.
//
// Design (one block of four warpgroups per 192-query tile, grid (S / 192,
// BH), one block per SM):
// * Warpgroup 3 is the producer. It gives up registers (setmaxnreg 32) and
//   one of its threads issues every load by TMA (cp.async.bulk.tensor.3d):
//   Q's 192 x 64 tile once, then 128-key K and V tiles (16 KB each) into a
//   ring of kStages stages with a full and an empty mbarrier per tile, so
//   the loads of the next tiles are in flight while the consumers work. The
//   tensor maps view q, k and v as (BH, S, 64), so rows past S of a head
//   are zero-filled by the TMA and never read from the next head.
// * Warpgroups 0 to 2 are the consumers (setmaxnreg 160), 64 query rows
//   each. S = Q K^T is wgmma.m64n128k16 with both operands in shared memory
//   (K-major, 128-byte swizzle: the rows of 64 bf16 are exactly the 128
//   bytes that CU_TENSOR_MAP_SWIZZLE_128B lays out and the descriptors'
//   swizzle mode reads), 4 k-steps. The online softmax runs on the f32
//   accumulator registers: the row max by quad shuffles, scale * log2(e)
//   folded into one FMA before ex2.approx; the running max is raised only
//   when a row outgrows it by 2^8 (every lane of the warp agreeing), as in
//   csrc/attention_tc.cuh. P is converted to bf16 in registers and is the
//   register A operand of O += P V by wgmma.m64n64k16 (V as B, MN-major
//   through the transpose bit), 8 k-steps per tile. The m64n128
//   accumulator layout pairs up into the A layout with no data movement.
// * Within a consumer, tile t's Q K^T is issued before tile t - 1's P V, so
//   the tensor cores compute both while the warpgroup waits for the scores
//   and then takes their exponentials while P V finishes (kOverlap).
// * Across consumers, pingpong (kPingpong): they take turns, by named
//   barriers, to issue their products, so one's products run on the tensor
//   cores while the others take their exponentials. Left alone, consumers
//   fed by the same tiles stay in step and take their exponentials at the
//   same time. No branch may stand between an issue and its wait: ptxas
//   then serializes every wgmma (warning C7520).
// * Ragged S: the last key tile sets keys >= S to -inf before the row max,
//   and query rows >= S are not written.
// * Precision as the TPU kernel: P rounded to bf16 before P V, the
//   denominator summed from the f32 probabilities, the output divided by it
//   in f32 and rounded once.
//
// Host: the three CUtensorMaps are encoded on every call (q, k and v move
// from call to call) through cuTensorMapEncodeTiled, which is looked up
// with cudaGetDriverEntryPoint, so the library needs no -lcuda; they are
// passed as __grid_constant__ kernel parameters. A failed lookup, encode or
// launch returns non-zero and the wrapper raises: nothing falls back to
// another kernel.
//
// Grid: 192-query tiles always. At (24, 4096, 64) that is 22 x 24 = 528
// blocks over 132 SMs, four waves (the last tile of a head is a third
// full); at one frame's (6, 4096, 64), 132 blocks, one wave; at the rect
// grid's (24, 3072, 64), 384 blocks, 2.9 waves. A persistent grid would
// not shorten the critical path of equal tiles.
//
// Measured on an H100 SXM at 700 W (tools/kernel_variants.py, device
// time, one process): at (24, 4096, 64) 0.196 ms (525 TFLOP/s) against
// 0.221 ms with two consumers, 0.224 ms without pingpong, 0.214 ms
// without the overlap inside a consumer, 0.411 ms for the mma.sync tile
// this kernel replaced, and 0.231 ms for scaled_dot_product_attention.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace bff_wg;

constexpr int kD = 64;         // head dim: one 128-byte row of bf16
constexpr int kConsumers = 3;  // consumer warpgroups of 64 query rows each
constexpr int kBM = 64 * kConsumers;  // query rows of a block
constexpr int kBN = 128;       // keys of a tile
constexpr int kStages = 2;     // K and V tiles in flight
constexpr bool kOverlap = true;   // issue Q K^T of tile t before P V of tile t - 1
constexpr bool kPingpong = true;  // the consumers take turns to issue their products
constexpr int kThreads = 128 * (kConsumers + 1);  // the producer is the last warpgroup
// setmaxnreg: what the producer gives up goes to the consumers (65 536 a SM)
constexpr int kProducerRegs = kConsumers == 2 ? 24 : 32;
constexpr int kConsumerRegs = kConsumers == 2 ? 240 : 160;
constexpr int kTileBytes = kBN * kD * 2;
constexpr int kQBytes = kBM * kD * 2;
constexpr int kQSlice = 64 * kD * 2;  // one consumer's rows of Q
constexpr int kConsumerWarps = 4 * kConsumers;
// Q, the K and V rings, the barriers, and room to align the start to 1024 bytes
constexpr int kSmemBytes = kQBytes + 2 * kStages * kTileBytes + 128 + 1024;
constexpr float kLazy = 8.f;  // log2(2^8): the largest p is 2^8

struct Barriers {
  uint64_t q_full;
  uint64_t k_full[kStages], v_full[kStages], k_empty[kStages], v_empty[kStages];
};

// S = Q K^T for the warpgroup's 64 rows (q_wg) and the 128 keys of k_tile.
__device__ __forceinline__ void issue_scores(float (&s)[64], uint32_t q_wg, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_m64n128k16_ss(s, sw128_desc(q_wg + kk * 32, 16), sw128_desc(k_tile + kk * 32, 16),
                        kk);
}

// O += P V for the 128 keys of v_tile (k-step kk: keys 16 kk .. 16 kk + 15,
// 2048 bytes on).
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[8][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_m64n64k16_rs(o, p[kk], sw128_desc(v_tile + kk * 2048, 1024));
}

// Where lane's accumulator values lie: s[4 j + e] holds row lane / 4 + 8 (e
// / 2) of the warp's 16 rows and column 8 j + 2 (lane % 4) + e % 2.

// The online softmax of one score tile in place: keys >= S (from k0 on)
// masked when ``ragged``, the running max m (log2 units) raised where a row
// outgrows it by kLazy, l rescaled and summed, s turned into p. Returns the
// factors the output rows must be rescaled by (1 where the max stayed).
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2, bool ragged, int k0,
                                             int S) {
  if (ragged) {
    const int c = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c + 8 * j + (e & 1) >= S) s[4 * j + e] = bff_tc::masked_score();
  }
  float mx[2] = {bff_tc::masked_score(), bff_tc::masked_score()};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2)) * sl2;
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
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    s[4 * j] = bff_tc::exp2_approx(fmaf(s[4 * j], sl2, -m[0]));
    s[4 * j + 1] = bff_tc::exp2_approx(fmaf(s[4 * j + 1], sl2, -m[0]));
    s[4 * j + 2] = bff_tc::exp2_approx(fmaf(s[4 * j + 2], sl2, -m[1]));
    s[4 * j + 3] = bff_tc::exp2_approx(fmaf(s[4 * j + 3], sl2, -m[1]));
    l[0] += s[4 * j] + s[4 * j + 1];
    l[1] += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P in bf16 as the A fragments of the 8 k-steps of P V: step kk takes the
// accumulator's n8 tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[kk][i] = bff_tc::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

__global__ void __launch_bounds__(kThreads, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int S, float sl2) {
  static_assert(kConsumers == 2 || kConsumers == 3, "two or three consumer warpgroups");
  extern __shared__ __align__(1024) unsigned char wg_smem_raw[];
  // the swizzle atoms must start on 1024-byte boundaries of shared memory
  unsigned char* smem = wg_smem_raw + ((1024 - (smem_u32(wg_smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = sQ + kQBytes;                 // stage st at sK + st * kTileBytes
  unsigned char* sV = sK + kStages * kTileBytes;    // stage st at sV + st * kTileBytes
  Barriers* bars = reinterpret_cast<Barriers*>(sV + kStages * kTileBytes);

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
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (threadIdx.x == 128 * kConsumers) {
      bar_expect_tx(&bars->q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < kConsumers; ++c)
        tma_load_3d(sQ + c * kQSlice, &tq, &bars->q_full, 0, q0 + 64 * c, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages, parity = ((t / kStages) & 1) ^ 1;
        bar_wait(&bars->k_empty[st], parity);
        bar_expect_tx(&bars->k_full[st], kTileBytes);
        tma_load_3d(sK + st * kTileBytes, &tk, &bars->k_full[st], 0, t * kBN, bh);
        bar_wait(&bars->v_empty[st], parity);
        bar_expect_tx(&bars->v_full[st], kTileBytes);
        tma_load_3d(sV + st * kTileBytes, &tv, &bars->v_full[st], 0, t * kBN, bh);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
    const int lane = threadIdx.x & 31;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const uint32_t q_wg = smem_u32(sQ) + wg * kQSlice;
    const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
    const bool ragged = S % kBN != 0;

    float s[64] = {}, acc[32] = {};
    uint32_t p[8][4] = {};
    float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, l[2] = {0.f, 0.f}, corr[2];

    // Pingpong: consumer w issues its round's products after turn_sync(1 +
    // w) and then hands the turn to the next one by turn_arrive, so one's
    // products run on the tensor cores while the others take their
    // exponentials. Consumer 0 takes the first turn; every consumer hands on
    // a turn after each of its n_tiles rounds, and consumer 0 takes the last
    // one after its loop. No branch stands between an issue and its wait
    // (ptxas serializes the wgmmas around one).
    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
    if (kPingpong && wg == kConsumers - 1) turn_arrive(next_turn);
    // the registers an issue reads are written before its wgmma.fence
    auto fence_for_issue = [&]() {
      fence_regs(acc);
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
    issue_scores(s, q_wg, k_base);
    wgmma_commit();
    hand_on();
    wgmma_wait<0>();
    fence_regs(s);
    if (signals) bar_arrive(&bars->k_empty[0]);
    softmax_tile(s, m, l, corr, sl2, ragged && n_tiles == 1, 0, S);
    pack_p(p, s);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % kStages, parity = (t / kStages) & 1;
      const int pst = (t - 1) % kStages, pparity = ((t - 1) / kStages) & 1;
      if constexpr (kOverlap) {
        bar_wait(&bars->k_full[st], parity);
        bar_wait(&bars->v_full[pst], pparity);
        if (kPingpong) turn_sync(my_turn);
        fence_for_issue();
        issue_scores(s, q_wg, k_base + st * kTileBytes);
        wgmma_commit();
        issue_pv(acc, p, v_base + pst * kTileBytes);
        wgmma_commit();
        hand_on();
        wgmma_wait<1>();  // the scores are in
        fence_regs(s);
        if (signals) bar_arrive(&bars->k_empty[st]);
        softmax_tile(s, m, l, corr, sl2, ragged && t == n_tiles - 1, t * kBN, S);
        wgmma_wait<0>();  // P V of tile t - 1 is in
        fence_regs(acc);
        fence_regs(p);
        fence_regs(s);
        if (signals) bar_arrive(&bars->v_empty[pst]);
        rescale(acc, corr);
        pack_p(p, s);
      } else {
        bar_wait(&bars->v_full[pst], pparity);
        fence_for_issue();
        issue_pv(acc, p, v_base + pst * kTileBytes);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (signals) bar_arrive(&bars->v_empty[pst]);
        bar_wait(&bars->k_full[st], parity);
        if (kPingpong) turn_sync(my_turn);
        fence_for_issue();
        issue_scores(s, q_wg, k_base + st * kTileBytes);
        wgmma_commit();
        hand_on();
        wgmma_wait<0>();
        fence_regs(s);
        if (signals) bar_arrive(&bars->k_empty[st]);
        softmax_tile(s, m, l, corr, sl2, ragged && t == n_tiles - 1, t * kBN, S);
        rescale(acc, corr);
        pack_p(p, s);
      }
    }
    if (kPingpong && wg == 0) turn_sync(my_turn);  // the last consumer's last turn
    // P V of the last tile
    const int lst = (n_tiles - 1) % kStages, lparity = ((n_tiles - 1) / kStages) & 1;
    bar_wait(&bars->v_full[lst], lparity);
    fence_for_issue();
    issue_pv(acc, p, v_base + lst * kTileBytes);
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
}

}  // namespace

// The routing predicate (kernels/flash_attention.py wgmma_route mirrors it):
// 1 when bff_flash_attention takes this kernel for the call. dtype: 0 =
// float32, 1 = bfloat16.
extern "C" int bff_flash_wgmma_takes(int dtype, int D, int S, int valid_len, float scale,
                                     const void* q, const void* k, const void* v,
                                     const void* o) {
  return dtype == 1 && D == kD && S >= 1 && valid_len == S && scale > 0.f && scale <= FLT_MAX &&
         aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
}

// q, k, v, o: contiguous (BH, S, 64) bf16. Returns cudaGetLastError() after
// the launch, -1 for arguments outside the predicate, -2 when the driver's
// cuTensorMapEncodeTiled is not found, -3 for a misaligned base or stride,
// -1000 - CUresult for a failed encode.
extern "C" int bff_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                         int BH, int S, float scale, void* stream) {
  if (BH < 1 || !bff_flash_wgmma_takes(1, kD, S, S, scale, q, k, v, o)) return -1;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  CUtensorMap tq, tk, tv;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int rc = encode_3d(fn, &tq, q, kD, S, BH, kD, 64, sw);
  if (rc == 0) rc = encode_3d(fn, &tk, k, kD, S, BH, kD, kBN, sw);
  if (rc == 0) rc = encode_3d(fn, &tv, v, kD, S, BH, kD, kBN, sw);
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + kBM - 1) / kBM, BH);
  flash_wgmma_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, scale * bff_tc::kLog2e);
  return (int)cudaGetLastError();
}
