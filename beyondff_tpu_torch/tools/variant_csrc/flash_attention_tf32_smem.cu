// Variant of csrc/flash_attention_tf32.cu (3xTF32 flash attention in f32
// for Hopper) that splits K and V in shared memory instead of in a
// pre-pass: the producer warpgroup TMA-loads the raw f32 K and V tiles of
// the inputs (no scratch) into kRawSlots slots, and its 128 threads write
// K's hi and lo (the same swizzled layout) and V^T's hi and lo (transposed,
// each 8-key group in the order 0 2 4 6 1 3 5 7) into a stage before they
// release it to the consumers, whose code is the shipped kernel's (no setmaxnreg:
// every warpgroup keeps the 168 registers ptxas gives the block). Every
// query block splits every key tile again. Built only by
// tools/kernel_variants.py (variant tf32_smem_split), on its own entry
// bff_flash_attention_tf32_smem.

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace bff_wg;

constexpr int kBN = 64;               // keys of a tile
constexpr int kConsumers = 2;         // consumer warpgroups of 64 query rows each
constexpr int kBM = 64 * kConsumers;  // query rows of a block
constexpr bool kOverlap = true;       // issue Q K^T of tile t before P V of tile t - 1
constexpr bool kPingpong = true;      // the consumers take turns to issue their products
constexpr int kThreads = 128 * (kConsumers + 1);  // the producer is the last warpgroup
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kRow = 128;             // bytes of a swizzled row: 32 floats

template <int D>
struct Cfg {
  static constexpr int kStages = D == 32 ? 4 : 2;
  static constexpr int kKBytes = kBN * D * 4;  // K hi or K lo of a tile: D / 32 boxes of kBN rows
  static constexpr int kVBytes = D * kBN * 4;  // V^T hi or lo of a tile: 2 boxes of D rows
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kVBytes;
  static constexpr int kQBytes = 64 * D * 4;   // a consumer's Q hi or Q lo: D / 32 boxes of 64 rows
  // slots of raw K and V as loaded, which only the producer reads
  static constexpr int kRawSlots = D == 32 ? 2 : 1;
  static constexpr int kRawBytes = 2 * kKBytes;
  // the stages, both consumers' Q hi and lo, the raw slots, the barriers,
  // and room to align the start to 1024 bytes
  static constexpr int kSmemBytes = kStages * kStageBytes + 2 * kConsumers * kQBytes +
                                    kRawSlots * kRawBytes + 256 + 1024;
};

template <int D>
struct Barriers {
  uint64_t raw_full[Cfg<D>::kRawSlots];
  uint64_t k_full[Cfg<D>::kStages], v_full[Cfg<D>::kStages];
  uint64_t k_empty[Cfg<D>::kStages], v_empty[Cfg<D>::kStages];
};

#define BFF_T4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define BFF_T16(a, i) BFF_T4(a, i), BFF_T4(a, i + 4), BFF_T4(a, i + 8), BFF_T4(a, i + 12)

// d (+)= A B for A 64 x 8 TF32 in registers (a lane holds rows g, g + 8 of
// its warp's 16 and columns t, t + 4: a0 (g, t), a1 (g + 8, t), a2 (g, t +
// 4), a3 (g + 8, t + 4)) and B 8 x N TF32 from shared memory, K-major.
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

// d (+)= A B for A 64 x 8 and B 8 x 64 TF32, both from shared memory, K-major.
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

#undef BFF_T16
#undef BFF_T4

// The descriptor of k-step kk (8 columns, 32 bytes) of a K-major operand
// stored as boxes of ``rows`` 128-byte rows (32 columns a box).
template <int rows>
__device__ __forceinline__ uint64_t kstep_desc(uint32_t base, int kk) {
  return sw128_desc(base + (kk / 4) * rows * kRow + (kk % 4) * 32, 16);
}

// The byte offset of element (row, col) of a box of 32-float rows in the
// 128-byte swizzle, as TMA writes it: the 16-byte chunk col / 4 of row r
// lies at chunk (col / 4) ^ (r % 8).
__device__ __forceinline__ int swizzled(int row, int col) {
  return row * kRow + ((((col >> 2) ^ row) & 7) << 4) + ((col & 3) << 2);
}

// S = Q K^T for the warpgroup's 64 rows (Q hi and lo in shared memory) and
// the 64 keys of a tile: the small terms over every k-step first, then hi hi.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t qhi, uint32_t qlo,
                                             uint32_t khi, uint32_t klo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    wgmma_tf32(s, kstep_desc<64>(qlo, kk), kstep_desc<kBN>(khi, kk), kk);
    wgmma_tf32(s, kstep_desc<64>(qhi, kk), kstep_desc<kBN>(klo, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
    wgmma_tf32(s, kstep_desc<64>(qhi, kk), kstep_desc<kBN>(khi, kk), 1);
}

// O += P V for the 64 keys of a tile (k-step kk: stored keys 8 kk .. 8 kk + 7).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&ph)[kBN / 8][4],
                                         const uint32_t (&pl)[kBN / 8][4], uint32_t vhi,
                                         uint32_t vlo) {
#pragma unroll
  for (int kk = 0; kk < kBN / 8; ++kk) {
    wgmma_tf32(o, pl[kk], kstep_desc<D>(vhi, kk), 1);
    wgmma_tf32(o, ph[kk], kstep_desc<D>(vlo, kk), 1);
  }
#pragma unroll
  for (int kk = 0; kk < kBN / 8; ++kk) wgmma_tf32(o, ph[kk], kstep_desc<D>(vhi, kk), 1);
}

// Where lane's accumulator values lie: s[4 j + e] holds row lane / 4 + 8 (e
// / 2) of the warp's 16 rows and column 8 j + 2 (lane % 4) + e % 2.

// The online softmax of one score tile in place: keys >= valid_len (from k0
// on) at -inf, the running max m (log2 units) raised, l rescaled and summed,
// s turned into p. corr: the factors the output rows are rescaled by.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2, int k0,
                                             int valid_len) {
  const int c = k0 + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = c + 8 * j + (e & 1) < valid_len ? s[4 * j + e] : bff_tc::masked_score();
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
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = bff_tc::exp2_approx(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
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

// P split into the A fragments of the 8 k-steps of P V: k-step kk takes the
// accumulator's n8 tile kk, column t of the fragment from key 2 t and column
// t + 4 from key 2 t + 1 (V^T's keys are stored in that order).
__device__ __forceinline__ void split_p(uint32_t (&ph)[kBN / 8][4], uint32_t (&pl)[kBN / 8][4],
                                        const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 8; ++kk) {
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


// The producer warpgroup's split of one tile: K's raw boxes into hi and lo
// at the same offsets, V's raw (keys, D) into V^T hi and lo (D, keys).
template <int D>
__device__ __forceinline__ void split_stage(const unsigned char* raw_k,
                                            const unsigned char* raw_v, unsigned char* khi,
                                            unsigned char* klo, unsigned char* vhi,
                                            unsigned char* vlo, int tid) {
  for (int b = tid * 16; b < kBN * D * 4; b += 128 * 16) {
    const float4 x = *reinterpret_cast<const float4*>(raw_k + b);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(khi + b) = h;
    *reinterpret_cast<uint4*>(klo + b) = l;
  }
  for (int i = tid; i < D * kBN; i += 128) {
    const int d = i / kBN, pos = i % kBN, kap = pos & 7;
    const int key = (pos & ~7) + (kap < 4 ? 2 * kap : 2 * kap - 7);
    const float x = *reinterpret_cast<const float*>(
        raw_v + (d / 32) * kBN * kRow + swizzled(key, d % 32));
    uint32_t h, l;
    split_tf32(x, h, l);
    const int at = (pos / 32) * D * kRow + swizzled(d, pos % 32);
    *reinterpret_cast<uint32_t*>(vhi + at) = h;
    *reinterpret_cast<uint32_t*>(vlo + at) = l;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_tf32_smem_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ q, float* __restrict__ o, int S, int valid_len, float sl2) {
  using C = Cfg<D>;
  constexpr int kStages = C::kStages, kRawSlots = C::kRawSlots;
  extern __shared__ __align__(1024) unsigned char tf32_smem_raw[];
  unsigned char* smem = tf32_smem_raw + ((1024 - (smem_u32(tf32_smem_raw) & 1023)) & 1023);
  auto khi_at = [&](int st) { return smem + st * C::kStageBytes; };
  unsigned char* raw = smem + kStages * C::kStageBytes + 2 * kConsumers * C::kQBytes;
  auto rawk_at = [&](int r) { return raw + r * C::kRawBytes; };
  auto rawv_at = [&](int r) { return rawk_at(r) + C::kKBytes; };
  Barriers<D>* bars = reinterpret_cast<Barriers<D>*>(raw + kRawSlots * C::kRawBytes);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (valid_len + kBN - 1) / kBN;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < kRawSlots; ++r) bar_init(&bars->raw_full[r], 1);
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
    const int tid = threadIdx.x - 128 * kConsumers;
    // one thread: the raw tiles of tile t into raw slot t % kRawSlots
    auto issue = [&](int t) {
      const int r = t % kRawSlots;
      bar_expect_tx(&bars->raw_full[r], C::kRawBytes);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        tma_load_3d(rawk_at(r) + c * kBN * kRow, &tk, &bars->raw_full[r], 32 * c, t * kBN, bh);
        tma_load_3d(rawv_at(r) + c * kBN * kRow, &tv, &bars->raw_full[r], 32 * c, t * kBN, bh);
      }
    };
    if (tid == 0)
      for (int t = 0; t < kRawSlots && t < n_tiles; ++t) issue(t);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages, parity = ((t / kStages) & 1) ^ 1, r = t % kRawSlots;
      bar_wait_or_trap(&bars->raw_full[r], (t / kRawSlots) & 1);
      // the stage's split tiles of tile t - kStages are consumed
      bar_wait_or_trap(&bars->k_empty[st], parity);
      bar_wait_or_trap(&bars->v_empty[st], parity);
      unsigned char* khi = khi_at(st);
      split_stage<D>(rawk_at(r), rawv_at(r), khi, khi + C::kKBytes, khi + 2 * C::kKBytes,
                     khi + 2 * C::kKBytes + C::kVBytes, tid);
      // the split tiles are read by wgmma (the async proxy), the raw slot
      // is written by the next TMA load
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 5, 128;\n" ::: "memory");
      if (tid == 0) {
        bar_arrive(&bars->k_full[st]);
        bar_arrive(&bars->v_full[st]);
        if (t + kRawSlots < n_tiles) issue(t + kRawSlots);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    const int lane = threadIdx.x & 31;
    const bool signals = lane == 0;  // one arrival per consumer warp
    const int g = lane / 4, tq = lane & 3;
    const int row0 = q0 + wg * 64 + ((threadIdx.x / 32) & 3) * 16 + g;  // and row0 + 8

    // the warpgroup's 64 rows of Q, split into hi and lo in shared memory in
    // the layout the K tiles have (rows >= S as 0), once; then made visible
    // to wgmma (the async proxy) and to the warpgroup
    unsigned char* q_hi = smem + kStages * C::kStageBytes + 2 * wg * C::kQBytes;
    unsigned char* q_lo = q_hi + C::kQBytes;
    {
      const float* qb = q + ((long long)bh * S + q0 + wg * 64) * D;
      const int wt = threadIdx.x & 127;
      for (int i = wt; i < 64 * D; i += 128) {
        const int r = i / D, c = i % D;
        uint32_t hi, lo;
        split_tf32(q0 + wg * 64 + r < S ? qb[(long long)r * D + c] : 0.f, hi, lo);
        const int at = (c / 32) * 64 * kRow + swizzled(r, c % 32);
        *reinterpret_cast<uint32_t*>(q_hi + at) = hi;
        *reinterpret_cast<uint32_t*>(q_lo + at) = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
    }
    const uint32_t qhi = smem_u32(q_hi), qlo = smem_u32(q_lo);

    float s[32] = {}, acc[D / 2] = {};
    uint32_t ph[kBN / 8][4] = {}, pl[kBN / 8][4] = {};
    float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, l[2] = {0.f, 0.f}, corr[2];

    // Pingpong as in csrc/flash_attention_wgmma.cu: consumer w issues its
    // round's products after turn_sync(1 + w) and hands the turn on by
    // turn_arrive; consumer 1 hands consumer 0 the first turn, consumer 0
    // takes the last one after its loop.
    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kConsumers;
    if (kPingpong && wg == kConsumers - 1) turn_arrive(next_turn);
    auto fence_for_issue = [&]() {
      fence_regs(acc);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(s);
      wgmma_fence();
    };
    auto hand_on = [&]() {
      if (kPingpong) turn_arrive(next_turn);
    };
    const uint32_t base = smem_u32(smem);
    auto k_hi = [&](int st) { return base + st * C::kStageBytes; };
    auto k_lo = [&](int st) { return k_hi(st) + C::kKBytes; };
    auto v_hi = [&](int st) { return k_hi(st) + 2 * C::kKBytes; };
    auto v_lo = [&](int st) { return v_hi(st) + C::kVBytes; };

    // tile 0: scores, softmax, P
    bar_wait_or_trap(&bars->k_full[0], 0);
    if (kPingpong) turn_sync(my_turn);
    fence_for_issue();
    issue_scores<D>(s, qhi, qlo, k_hi(0), k_lo(0));
    wgmma_commit();
    hand_on();
    wgmma_wait<0>();
    fence_regs(s);
    if (signals) bar_arrive(&bars->k_empty[0]);
    softmax_tile(s, m, l, corr, sl2, 0, valid_len);
    split_p(ph, pl, s);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % kStages, parity = (t / kStages) & 1;
      const int pst = (t - 1) % kStages, pparity = ((t - 1) / kStages) & 1;
      if constexpr (kOverlap) {
        bar_wait_or_trap(&bars->k_full[st], parity);
        bar_wait_or_trap(&bars->v_full[pst], pparity);
        if (kPingpong) turn_sync(my_turn);
        fence_for_issue();
        issue_scores<D>(s, qhi, qlo, k_hi(st), k_lo(st));
        wgmma_commit();
        issue_pv<D>(acc, ph, pl, v_hi(pst), v_lo(pst));
        wgmma_commit();
        hand_on();
        wgmma_wait<1>();  // the scores are in
        fence_regs(s);
        if (signals) bar_arrive(&bars->k_empty[st]);
        softmax_tile(s, m, l, corr, sl2, t * kBN, valid_len);
        wgmma_wait<0>();  // P V of tile t - 1 is in
        fence_regs(acc);
        fence_regs(ph);
        fence_regs(pl);
        fence_regs(s);
        if (signals) bar_arrive(&bars->v_empty[pst]);
        rescale<D>(acc, corr);
        split_p(ph, pl, s);
      } else {
        bar_wait_or_trap(&bars->v_full[pst], pparity);
        if (kPingpong) turn_sync(my_turn);
        fence_for_issue();
        issue_pv<D>(acc, ph, pl, v_hi(pst), v_lo(pst));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        if (signals) bar_arrive(&bars->v_empty[pst]);
        bar_wait_or_trap(&bars->k_full[st], parity);
        fence_for_issue();
        issue_scores<D>(s, qhi, qlo, k_hi(st), k_lo(st));
        wgmma_commit();
        hand_on();
        wgmma_wait<0>();
        fence_regs(s);
        if (signals) bar_arrive(&bars->k_empty[st]);
        softmax_tile(s, m, l, corr, sl2, t * kBN, valid_len);
        rescale<D>(acc, corr);
        split_p(ph, pl, s);
      }
    }
    if (kPingpong && wg == 0) turn_sync(my_turn);  // the last consumer's last turn
    // P V of the last tile
    const int lst = (n_tiles - 1) % kStages, lparity = ((n_tiles - 1) / kStages) & 1;
    bar_wait_or_trap(&bars->v_full[lst], lparity);
    fence_for_issue();
    issue_pv<D>(acc, ph, pl, v_hi(lst), v_lo(lst));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

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
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int valid_len,
           float scale, cudaStream_t stream) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  CUtensorMap tk, tv;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 4, (cuuint64_t)S * D * 4};
  const cuuint32_t box[3] = {32, kBN, 1};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int rc = encode_map(fn, &tk, f32, 3, k, dims, strides, box, sw);
  if (rc == 0) rc = encode_map(fn, &tv, f32, 3, v, dims, strides, box, sw);
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tf32_smem_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<D>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  flash_tf32_smem_kernel<D>
      <<<dim3((S + kBM - 1) / kBM, BH), kThreads, Cfg<D>::kSmemBytes, stream>>>(
          tk, tv, static_cast<const float*>(q), static_cast<float*>(o), S, valid_len,
          scale * bff_tc::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// As bff_flash_attention_tf32 with no scratch: q, k, v, o contiguous (BH,
// S, D) f32, D in {32, 64}, 16-byte aligned. -1 for other arguments.
extern "C" int bff_flash_attention_tf32_smem(const void* q, const void* k, const void* v,
                                             void* o, int BH, int S, int D, int valid_len,
                                             float scale, void* stream) {
  if (BH < 1 || (D != 32 && D != 64) || S < 1 || valid_len < 1 || valid_len > S ||
      !(scale > 0.f && scale <= FLT_MAX) || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(o))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch<32>(q, k, v, o, BH, S, valid_len, scale, s);
  return launch<64>(q, k, v, o, BH, S, valid_len, scale, s);
}
