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

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of rows from ``row`` on of head bh into dst (64 x 128 for K and
// V, 64 x 64 for a consumer's slice of Q).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(bh)
      : "memory");
}

// A shared-memory matrix descriptor in the 128-byte swizzle mode: 8-row
// groups of 128-byte rows, 1024 bytes apart (SBO); the leading offset is
// what the K-major layouts ignore and the MN-major V (one 64-element block
// along N) never steps.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Named barriers 1 .. kConsumers (0 is __syncthreads): consumer w issues
// its products after turn_sync(1 + w), then hands the turn on by
// turn_arrive; two warpgroups meet at each.
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait that hands them back.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define BFF_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define BFF_F16(a, i) BFF_F4(a, i), BFF_F4(a, i + 4), BFF_F4(a, i + 8), BFF_F4(a, i + 12)

// d (+)= A B for A 64 x 16 and B 16 x 128, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : BFF_F16(d, 0), BFF_F16(d, 16), BFF_F16(d, 32), BFF_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B for A 64 x 16 in registers (the mma.sync m16n8k16 A layout, one
// 16-row slice per warp) and B 16 x 64 from shared memory, MN-major.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BFF_F16(d, 0), BFF_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef BFF_F16
#undef BFF_F4

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
        tma_load(sQ + c * kQSlice, &tq, &bars->q_full, q0 + 64 * c, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages, parity = ((t / kStages) & 1) ^ 1;
        bar_wait(&bars->k_empty[st], parity);
        bar_expect_tx(&bars->k_full[st], kTileBytes);
        tma_load(sK + st * kTileBytes, &tk, &bars->k_full[st], t * kBN, bh);
        bar_wait(&bars->v_empty[st], parity);
        bar_expect_tx(&bars->v_full[st], kTileBytes);
        tma_load(sV + st * kTileBytes, &tv, &bars->v_full[st], t * kBN, bh);
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

// cuTensorMapEncodeTiled's signature (cuda.h), looked up at run time.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// base viewed as (BH, S, 64) bf16, boxes of box_rows rows x 64, 128-byte swizzle,
// rows past S zero-filled. 0, or a negative code.
int encode(EncodeTiled fn, CUtensorMap* map, const void* base, int BH, int S, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)kD, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)kD * 2, (cuuint64_t)S * kD * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || strides[0] % 16 != 0 ||
      strides[1] % 16 != 0)
    return -3;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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
  int rc = encode(fn, &tq, q, BH, S, 64);
  if (rc == 0) rc = encode(fn, &tk, k, BH, S, kBN);
  if (rc == 0) rc = encode(fn, &tv, v, BH, S, kBN);
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
