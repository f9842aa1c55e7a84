// Attention in f32 at head dims 144 to 256 for Hopper (sm_90a): 3xTF32 on
// wgmma, the whole head dim in one block, K and V split into TF32 halves on
// the chip or by a pre-pass. One kernel body serves two functions, told
// apart by its score modifier (kKeyMask): SAM's decomposed relative-position
// bias, or a key mask.
//
// Replaces, for float32 inputs at head dims past 128, the TPU kernel
// beyondff_tpu/kernels/flash_attention.py flash_attention_relpos (:193,
// pallas_call :214, body _relpos_kernel :128, wrapper attend_relpos :253):
// softmax(Q K^T * scale + bias) V over a raster-ordered (kh, kw) key grid,
// bias[q, k] = bias_h[q, k / kw] + bias_w[q, k % kw], an online max and
// denominator, the output divided once. No configured model calls a head
// dim past 128; attend_relpos takes any. bff_flash_attention_relpos and
// bff_window_attention_relpos (csrc/relpos_attention.cu, K5's windows that
// run K4's kernels as heads) route here exactly the calls that
// bff_relpos_wide_tf32_takes accepts: f32, D % 16 == 0 with 128 < D <= 256,
// kh * kw = S on any grid (each score's factors are read from device
// memory, so kh + kw past 256 needs no table), a positive finite scale and
// every pointer on 16 bytes. Before this kernel such calls ran on the FMA
// kernel's 128-feature slices, each recomputing the scores.
//
// With the key mask it replaces, for the same inputs, the TPU kernels
// beyondff_tpu/kernels/flash_attention.py _flash_masked (:270, pallas_call
// :313; keys >= valid_len masked, reached through attend :101) and
// flash_attention (:68, pallas_call :78; every key valid): softmax(Q K^T *
// scale) V. bff_flash_attention (csrc/flash_attention.cu) routes here
// exactly the calls that bff_flash_wide_tf32_takes accepts: f32, D % 16 ==
// 0 with 128 < D <= 256, any S, 1 <= valid_len <= S, a positive finite
// scale and q, k, v and o on 16 bytes. Every score of a key >= valid_len
// is -inf, and no tile that lies wholly past valid_len is read. It needs
// scratch from the caller (bff_flash_wide_tf32_scratch_floats).
// Before this kernel such calls ran on the FMA kernel's 128-feature slices
// too (at (16, 1024, 160) with 900 valid keys 1.3747 ms against SDPA-f32's
// 0.403, PERF.md).
//
// Precision, as csrc/relpos_attention_tf32.cu: each f32 operand x is split
// into TF32 words hi = rna(x), lo = rna(x - hi) and each product summed as
// lo hi + hi lo + hi hi in f32 accumulators; Q is multiplied by the scale
// before its split; the scores' products are summed from zero and each
// score's whole bias added in f32 once they are in (the bias as the
// accumulators' start lay 1.07-1.33e-4 from plain at factor scale 3 at head
// dims 80 and 96); each tile's P V is a fresh wgmma sum added to the output
// rows by the FMA units (kFold), in column parts.
//
// Bound on an H100 SXM (3xTF32: 495 / 3 = 165 TFLOP/s of f32-grade work;
// 3.35 TB/s): at (16, 1024, 160) on 32 x 32 the function does 10.7 GFLOP
// (0.0651 ms) against 46 MB (0.0137 ms); at (16, 1024, 256) 17.2 GFLOP
// (0.1041 ms): bound by operations. With the key mask at (16, 1024, 160)
// and 900 valid keys 9.4 GFLOP (0.0572 ms) against 42 MB (0.0125 ms).
//
// Why the design differs from csrc/relpos_attention_tf32.cu's. Every f32
// operand doubles in its hi and lo images: Q's for 64 rows at DP 256 take
// 128 KB, a 64-key K tile's 128 KB, so two 64-row warpgroups' Q beside K
// and V tiles do not fit the 227 KB a block may hold, nor does one
// warpgroup's with 64-key tiles. So:
// * A block is one consumer warpgroup of 64 query rows and one producer
//   warpgroup: 256 threads, 255 registers a thread (a block with three
//   warps on a register partition is held to 168). Grid (ceil(S / 64), BH).
// * The head dim is padded to DP, a multiple of 32 (160, 192, 224, 256:
//   four instances), the columns D .. DP - 1 zero; the key tiles are 32
//   keys (16 at DP 256), so Q's images (64 DP 8 bytes), one K stage and one
//   V stage (N DP 8 bytes each) fit: 160 KB at DP 160, 224 KB at DP 224,
//   192 KB at DP 256.
// * With the bias, no pre-pass and no scratch: the producer's 128 threads
//   read each tile of K and V from device memory (f32, 4 bytes an element,
//   half what the split images would take), split them and write their
//   images into the stages (keys past S and columns past D as zero), then
//   fence.proxy.async and arrive on the stage's full barrier; they read the
//   next tile while the consumer computes (K5's producer,
//   csrc/relpos_attention_tf32.cu).
// * With the key mask (kPreSplit), a pre-pass (wide_split_kernel, one
//   block a tile of a head) splits K and V^T into the same images, keys
//   from valid_len on as zero, laid out in scratch as the producer's
//   chunks, and the producer copies each tile's images (16 bytes a chunk)
//   into the stages. It reads twice the bytes and splits nothing: at (16,
//   1024, 160) with 900 valid keys 0.1710 ms against 0.2311 for the split
//   on the chip (0.3250 against 0.4205 at D 256, 4.894 against 6.919 at
//   (16, 4096, 256)); below S 128 the pre-pass's launch costs more than it
//   saves (0.0174 against 0.0124 at (16, 64, 160)), yet the kernel stays
//   ahead of the FMA kernel's slices (0.0339) (tools/kernel_variants.py,
//   variant wide_tf32_split_on_chip, NVIDIA H100 80GB HBM3, 700.00 W).
// * The consumer scales, splits and writes its Q images once, then per
//   tile: the P V of the last tile in kParts column parts (each a fresh
//   wgmma sum, waited for and added in f32), then Q K^T (the small terms
//   over every k-step first, then hi hi), each score's bias read from
//   device memory (the lane's 2 rows x N / 2 keys, their cells stepped by 8
//   keys from one division) while the products run and added once they are
//   in (with the key mask: the scores of keys >= valid_len set to -inf),
//   the online softmax in log2 units, P split in registers.
// * Operand layout, as csrc/relpos_attention_tf32.cu's: images of 32-byte
//   rows in the 32-byte swizzle (K-like: DP / 8 regions of rows x 32
//   bytes; V^T: one region of DP x 32 bytes per 8-key group with its keys
//   in the order 0 2 4 6 1 3 5 7, so P's accumulator registers are its A
//   fragments as they stand).
//
// Host: a failed launch returns non-zero and the wrapper raises: nothing
// falls back to another kernel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "tf32_images.cuh"

namespace {

using namespace bff_tf32;

constexpr int kMinD = 144, kMaxD = 256;  // the head dims taken, in steps of 16
constexpr bool kPreSplit = true;         // the key mask's K and V^T split by a pre-pass
constexpr int kDStep = 32;               // DP: D rounded up to this
constexpr int kBM = 64;                  // query rows of a block: one consumer warpgroup
constexpr int kThreads = 256;            // the consumer warpgroup, then the producer's
constexpr int kConsumerWarps = 4;
constexpr float kL2e = bff_tc::kLog2e;

// At DP: the keys of a tile, the columns of a fold part, the images' bytes
// and offsets (from a 1024-byte boundary): Q hi, Q lo, K hi, K lo, V^T hi,
// V^T lo, the barriers.
template <int DP>
struct Cfg {
  static_assert(DP % kDStep == 0 && DP >= 160 && DP <= kMaxD, "DP");
  static constexpr int kN = DP == 256 ? 16 : 32;
  static constexpr int kKS = kN / 8;                      // 8-key groups of a tile
  // output columns of a fold part: registers against waits (parts of 112
  // columns spilled 40 bytes at DP 224, of 64 at DP 256, for the same time)
  static constexpr int kFoldW = DP == 256 ? 32 : DP == 224 ? 56 : DP / 2;
  static constexpr int kParts = DP / kFoldW;
  static constexpr int kQImg = kBM * DP * 4;
  static constexpr int kImg = kN * DP * 4;
  static constexpr int kKOff = 2 * kQImg;
  static constexpr int kVOff = kKOff + 2 * kImg;
  static constexpr int kBarOff = kVOff + 2 * kImg;
  static constexpr int kSmemBytes = kBarOff + 64 + 1024;
  static_assert(kSmemBytes <= 232448, "the block's shared memory");
  static_assert(kQImg % 1024 == 0 && kImg % 1024 == 0, "images on the swizzle's period");
};

struct Barriers {
  uint64_t k_full, k_empty, v_full, v_empty;
};

// An image's descriptor, its address made opaque (wgmma.cuh) once a tile as
// are the producer's chunk coordinates and the lanes' factor rows: hoisted
// out of the loop, the descriptors of every k-step and those values spilled
// 448-1 152 bytes. ``at`` moves a descriptor ``bytes`` on: the
// start-address field (address / 16, bits 0-13) never carries below 256 KB
// of shared memory, so one 32-bit add moves it.
__device__ __forceinline__ uint64_t desc(uint32_t addr) { return sw32_desc(opaque(addr), 16); }
__device__ __forceinline__ uint64_t at(uint64_t d, uint32_t bytes) {
  const uint32_t lo = static_cast<uint32_t>(d) + (bytes >> 4);
  return (d >> 32 << 32) | lo;
}

// S += Q K^T for the warpgroup's 64 rows (Q's images at qhi, qlo) and the N
// keys of a tile (K's images at khi, klo): the small terms over every
// k-step first, then hi hi.
template <int N, int DP>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2], uint64_t qhi, uint64_t qlo,
                                             uint64_t khi, uint64_t klo) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    mma_ss(s, at(qlo, kk * kBM * 32), at(khi, kk * N * 32));
    mma_ss(s, at(qhi, kk * kBM * 32), at(klo, kk * N * 32));
  }
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) mma_ss(s, at(qhi, kk * kBM * 32), at(khi, kk * N * 32));
}

// pv = P V for the KS 8-key groups of a tile (V^T's images at vhi, vlo, a
// region of DP x 32 bytes a group) and the 2 R columns of V^T's rows from
// vhi, vlo on: a fresh sum.
template <int KS, int DP, int R>
__device__ __forceinline__ void issue_pv(float (&pv)[R], const uint32_t (&ph)[KS][4],
                                         const uint32_t (&pl)[KS][4], uint64_t vhi,
                                         uint64_t vlo) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    mma_rs(pv, pl[kk], at(vhi, kk * DP * 32), kk == 0 ? 0 : 1);
    mma_rs(pv, ph[kk], at(vlo, kk * DP * 32), 1);
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) mma_rs(pv, ph[kk], at(vhi, kk * DP * 32), 1);
}

// The online softmax of one score tile of logits in natural units (masked
// keys at -inf), in place: the running max m (log2 units) raised, l
// rescaled and summed, s turned into p; corr: the output rows' factors.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  float mx[2] = {bff_tc::masked_score(), bff_tc::masked_score()};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * kL2e);
    corr[h] = bff_tc::exp2_approx(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    s[4 * j] = bff_tc::exp2_approx(fmaf(s[4 * j], kL2e, -m[0]));
    s[4 * j + 1] = bff_tc::exp2_approx(fmaf(s[4 * j + 1], kL2e, -m[0]));
    s[4 * j + 2] = bff_tc::exp2_approx(fmaf(s[4 * j + 2], kL2e, -m[1]));
    s[4 * j + 3] = bff_tc::exp2_approx(fmaf(s[4 * j + 3], kL2e, -m[1]));
    l[0] += s[4 * j] + s[4 * j + 1];
    l[1] += s[4 * j + 2] + s[4 * j + 3];
  }
}

// P split into the A fragments of the k-steps of P V: k-step kk takes the
// accumulator's n8 tile kk, column t of the fragment from key 2 t and
// column t + 4 from key 2 t + 1 (V^T's keys are stored in that order).
template <int KS>
__device__ __forceinline__ void split_p(uint32_t (&ph)[KS][4], uint32_t (&pl)[KS][4],
                                        const float (&s)[4 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    split_tf32(s[4 * kk], ph[kk][0], pl[kk][0]);
    split_tf32(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
    split_tf32(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
    split_tf32(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

// The keys visited are 0 .. keys - 1: S with the bias (kh, kw its grid),
// valid_len with the key mask (kKeyMask; bias_h, bias_w, kh and kw unread;
// with kPreSplit, img holds K's and V^T's images from wide_split_kernel).
template <int DP, bool kKeyMask>
__global__ void __launch_bounds__(kThreads, 1) wide_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias_h, const float* __restrict__ bias_w,
    const uint4* __restrict__ img, float* __restrict__ o, int S, int D, int kh, int kw, int keys,
    float scale) {
  using C = Cfg<DP>;
  constexpr int N = C::kN, KS = C::kKS, R = C::kFoldW / 2;
  extern __shared__ __align__(1024) unsigned char rw_smem_raw[];
  unsigned char* smem = rw_smem_raw + ((1024 - (smem_u32(rw_smem_raw) & 1023)) & 1023);
  Barriers* bars = reinterpret_cast<Barriers*>(smem + C::kBarOff);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (keys + N - 1) / N;
  const long long head = static_cast<long long>(bh) * S;  // the head's first row
  if (threadIdx.x == 0) {
    bar_init(&bars->k_full, 128);
    bar_init(&bars->v_full, 128);
    bar_init(&bars->k_empty, kConsumerWarps);
    bar_init(&bars->v_empty, kConsumerWarps);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---------------------------------------------------------- producer
    const int pt = threadIdx.x - 128;
    constexpr int kChunks = 2 * (DP / 8) * N;  // 16-byte chunks of each image
    constexpr int kPer = kChunks / 128;
    static_assert(kChunks % 128 == 0, "whole chunks a thread");
    if constexpr (kKeyMask && kPreSplit) {
      // tile t's four images (K hi, K lo, V^T hi, V^T lo) in the pre-pass's
      // order, each read into registers before its stage is free
      constexpr int kI = C::kImg / 16;
      const uint4* head_img = img + static_cast<long long>(bh) * n_tiles * 4 * kI;
      auto copy = [&](const uint4* src, unsigned char* stage, uint64_t* empty, uint64_t* full,
                      int parity) {
        uint4 hi[kPer], lo[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          hi[j] = __ldg(src + pt + 128 * j);
          lo[j] = __ldg(src + kI + pt + 128 * j);
        }
        bar_wait_or_trap(empty, parity);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          *reinterpret_cast<uint4*>(stage + 16 * (pt + 128 * j)) = hi[j];
          *reinterpret_cast<uint4*>(stage + C::kImg + 16 * (pt + 128 * j)) = lo[j];
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_arrive(full);
      };
      for (int t = 0; t < n_tiles; ++t) {
        const uint4* ti = head_img + static_cast<long long>(t) * 4 * kI;
        const int parity = (t & 1) ^ 1;
        copy(ti, smem + C::kKOff, &bars->k_empty, &bars->k_full, parity);
        copy(ti + 2 * kI, smem + C::kVOff, &bars->v_empty, &bars->v_full, parity);
      }
      return;
    }
    const float* kb = k + head * D;
    const float* vb = v + head * D;
    // tile t of K, or of V^T, from device memory: keys from ``keys`` on and
    // columns from D on as zero (D is a multiple of 16: a chunk's four
    // columns are all in or out)
    auto load_k = [&](int t, float4 (&x)[kPer]) {
      const int me = opaque(pt);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int r;
        const int c = kimg_chunk(me + 128 * j, N, r);
        const int key = t * N + r;
        x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (key < keys && c < D)
          x[j] = __ldg(reinterpret_cast<const float4*>(kb + static_cast<long long>(key) * D + c));
      }
    };
    // V^T: each chunk the values of one feature for four keys of a group
    auto load_v = [&](int t, float4 (&x)[kPer]) {
      const int me = opaque(pt);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        int d;
        const int key = t * N + vimg_chunk<DP>(me + 128 * j, d);
        const float* src = vb + static_cast<long long>(key) * D + d;
        x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (d < D) {
          if (key < keys) x[j].x = __ldg(src);
          if (key + 2 < keys) x[j].y = __ldg(src + 2 * D);
          if (key + 4 < keys) x[j].z = __ldg(src + 4 * D);
          if (key + 6 < keys) x[j].w = __ldg(src + 6 * D);
        }
      }
    };
    auto store = [&](unsigned char* img, const float4 (&x)[kPer]) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = pt + 128 * j;
        uint4 hi, lo;
        split4(x[j], hi, lo);
        *reinterpret_cast<uint4*>(img + 16 * i) = hi;
        *reinterpret_cast<uint4*>(img + C::kImg + 16 * i) = lo;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    // V(t) is read from device memory while the consumer's Q K^T of tile t
    // runs, K(t + 1) while its Q K^T and P V of tile t do
    float4 x[kPer];
    load_k(0, x);
    for (int t = 0; t < n_tiles; ++t) {
      const int parity = (t & 1) ^ 1;
      bar_wait_or_trap(&bars->k_empty, parity);
      store(smem + C::kKOff, x);
      bar_arrive(&bars->k_full);
      load_v(t, x);
      bar_wait_or_trap(&bars->v_empty, parity);
      store(smem + C::kVOff, x);
      bar_arrive(&bars->v_full);
      if (t + 1 < n_tiles) load_k(t + 1, x);
    }
    return;
  }

  // ---------------------------------------------------------- consumer
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const int rb = (threadIdx.x / 32) * 16 + lane / 4;  // the lane's rows rb and rb + 8 of 64
  const bool signals = lane == 0;                     // one arrival per consumer warp
  unsigned char* q_hi = smem;
  unsigned char* q_lo = smem + C::kQImg;
  {
    // the block's 64 rows of Q times the scale, split into its images (rows
    // >= S and columns >= D as zero), a quarter of a thread's chunks at a time
    constexpr int kPer = 2 * (DP / 8) * kBM / 128;
    constexpr int kRound = kPer / 4;
    const float* qb = q + (head + q0) * D;
#pragma unroll
    for (int j0 = 0; j0 < kPer; j0 += kRound) {
      float4 x[kRound];
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        int r;
        const int c = kimg_chunk(threadIdx.x + 128 * (j0 + j), kBM, r);
        x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q0 + r < S && c < D)
          x[j] = __ldg(reinterpret_cast<const float4*>(qb + static_cast<long long>(r) * D + c));
      }
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        const int i = threadIdx.x + 128 * (j0 + j);
        uint4 hi, lo;
        split4(make_float4(x[j].x * scale, x[j].y * scale, x[j].z * scale, x[j].w * scale), hi,
               lo);
        *reinterpret_cast<uint4*>(q_hi + 16 * i) = hi;
        *reinterpret_cast<uint4*>(q_lo + 16 * i) = lo;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup only
  }
  const uint32_t qh = smem_u32(q_hi), ql = smem_u32(q_lo);
  const uint32_t kh_img = smem_u32(smem + C::kKOff), vh_img = smem_u32(smem + C::kVOff);

  // tile t's whole bias, bias_h[q, ky] + bias_w[q, kx] of each of the
  // lane's keys 8 j + 2 tq + e (keys >= S at -inf): (ky, kx) of its e = 0
  // key from one division a tile, advanced by 8 keys a group (one wrap at
  // kw >= 8, a division below); the e = 1 key the next column or the next
  // row's first
  auto load_bias = [&](int t, float (&b)[N / 2]) {
    // the lane's rows' factor rows (nullptr past S: bias 0)
    const float* bh_row[2];
    const float* bw_row[2];
    const int row = q0 + opaque(rb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = row + 8 * h < S;
      bh_row[h] = live ? bias_h + (head + row + 8 * h) * kh : nullptr;
      bw_row[h] = live ? bias_w + (head + row + 8 * h) * kw : nullptr;
    }
    int key = t * N + 2 * tq;
    int ky = key / kw, kx = key - ky * kw;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool wrap = e == 1 && kx + 1 == kw;
        const int y = ky + wrap, x = e == 0 ? kx : wrap ? 0 : kx + 1;
        const bool in = key + e < keys;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float f = in && bh_row[h] != nullptr ? __ldg(bh_row[h] + y) + __ldg(bw_row[h] + x)
                                                     : 0.f;
          b[4 * j + 2 * h + e] = in ? f : bff_tc::masked_score();
        }
      }
      key += 8;
      if (kw >= 8) {
        kx += 8;
        if (kx >= kw) {
          kx -= kw;
          ++ky;
        }
      } else {
        ky = key / kw;
        kx = key - ky * kw;
      }
    }
  };

  float acc[DP / 2], pv[R], s[N / 2], b[N / 2];
  uint32_t ph[KS][4] = {}, pl[KS][4] = {};
  float m[2] = {bff_tc::kInitMax, bff_tc::kInitMax}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) pv[i] = 0.f;
  // the registers a product owns, fenced before it is issued (the output
  // rows take no product: the FMA units add each part to them)
  auto fence_pv = [&]() {
    fence_regs(pv);
    fence_regs(ph);
    fence_regs(pl);
  };
  // tile t's scores in s (the products from zero, the bias added once they
  // are in, or the keys >= valid_len set to -inf), then its softmax
  auto scores = [&](int t) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
    bar_wait_or_trap(&bars->k_full, t & 1);
    fence_regs(s);
    wgmma_fence();
    issue_scores<N, DP>(s, desc(qh), desc(ql), desc(kh_img), desc(kh_img + C::kImg));
    wgmma_commit();
    if constexpr (!kKeyMask) load_bias(t, b);
    wgmma_wait<0>();
    fence_regs(s);
    if (signals) bar_arrive(&bars->k_empty);
    if constexpr (kKeyMask) {
      const int c = t * N + 2 * tq;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = c + 8 * j + (e & 1) < keys ? s[4 * j + e] : bff_tc::masked_score();
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) s[i] += b[i];
    }
    softmax_tile<N>(s, m, l, corr);
  };
  // the P V of the tile in the V stage (parity of tile u), part by part: a
  // fresh sum each, added to the output rows in f32
  auto pv_fold = [&](int u) {
    bar_wait_or_trap(&bars->v_full, u & 1);
#pragma unroll
    for (int part = 0; part < C::kParts; ++part) {
      fence_pv();
      wgmma_fence();
      const uint32_t vh = vh_img + part * C::kFoldW * 32;
      issue_pv<KS, DP>(pv, ph, pl, desc(vh), desc(vh + C::kImg));
      wgmma_commit();
      wgmma_wait<0>();
      fence_pv();
#pragma unroll
      for (int i = 0; i < R; ++i) acc[part * R + i] += pv[i];
    }
    if (signals) bar_arrive(&bars->v_empty);
  };

  scores(0);
  split_p<KS>(ph, pl, s);
  for (int t = 1; t < n_tiles; ++t) {
    pv_fold(t - 1);
    scores(t);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      acc[4 * j] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }
    split_p<KS>(ph, pl, s);
  }
  pv_fold(n_tiles - 1);

  // the warp's two rows, divided by their denominators; columns >= D (the
  // padding, whole n8 groups) and rows >= S are not written
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + rb + 8 * h;
    if (row >= S) continue;
    float* orow = o + (head + row) * D + 2 * tq;
    const float inv = 1.f / l[h];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
  }
}

// The pre-pass of the key mask (kPreSplit): tile blockIdx.x of head
// blockIdx.y, K's and V^T's hi and lo images in the producer's chunk order
// (the kernel's load_k and load_v, then split4), keys from ``keys`` on as
// zero. img: (BH, tiles, 4 images) of C::kImg bytes.
template <int DP>
__global__ void __launch_bounds__(128) wide_split_kernel(const float* __restrict__ k,
                                                         const float* __restrict__ v,
                                                         uint4* __restrict__ img, int S, int D,
                                                         int keys) {
  using C = Cfg<DP>;
  constexpr int N = C::kN, kI = C::kImg / 16;
  const int t = blockIdx.x, bh = blockIdx.y;
  const float* kb = k + static_cast<long long>(bh) * S * D;
  const float* vb = v + static_cast<long long>(bh) * S * D;
  uint4* ti = img + (static_cast<long long>(bh) * gridDim.x + t) * 4 * kI;
  for (int i = threadIdx.x; i < kI; i += 128) {
    int r, d;
    const int c = kimg_chunk(i, N, r);
    const int key = t * N + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (key < keys && c < D)
      x = __ldg(reinterpret_cast<const float4*>(kb + static_cast<long long>(key) * D + c));
    uint4 hi, lo;
    split4(x, hi, lo);
    ti[i] = hi;
    ti[kI + i] = lo;
    const int vk = t * N + vimg_chunk<DP>(i, d);
    const float* src = vb + static_cast<long long>(vk) * D + d;
    x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (d < D) {
      if (vk < keys) x.x = __ldg(src);
      if (vk + 2 < keys) x.y = __ldg(src + 2 * D);
      if (vk + 4 < keys) x.z = __ldg(src + 4 * D);
      if (vk + 6 < keys) x.w = __ldg(src + 6 * D);
    }
    split4(x, hi, lo);
    ti[2 * kI + i] = hi;
    ti[3 * kI + i] = lo;
  }
}

// The tiles of keys 0 .. keys - 1 at head dim D.
inline int tiles(int D, int keys) {
  const int n = (D + kDStep - 1) / kDStep * kDStep == 256 ? Cfg<256>::kN : Cfg<160>::kN;
  return (keys + n - 1) / n;
}

template <int DP, bool kKeyMask>
int launch(const void* q, const void* k, const void* v, const void* bias_h, const void* bias_w,
           void* img, void* o, int BH, int S, int D, int kh, int kw, int keys, float scale,
           cudaStream_t stream) {
  static int configured = 48 * 1024;
  const cudaError_t err =
      bff_tc::allow_smem(wide_tf32_kernel<DP, kKeyMask>, Cfg<DP>::kSmemBytes, &configured);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kKeyMask && kPreSplit) {
    wide_split_kernel<DP><<<dim3(tiles(D, keys), BH), 128, 0, stream>>>(
        static_cast<const float*>(k), static_cast<const float*>(v), static_cast<uint4*>(img), S,
        D, keys);
    const cudaError_t split_err = cudaGetLastError();
    if (split_err != cudaSuccess) return (int)split_err;
  }
  wide_tf32_kernel<DP, kKeyMask><<<dim3((S + kBM - 1) / kBM, BH), kThreads, Cfg<DP>::kSmemBytes,
                                   stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias_h), static_cast<const float*>(bias_w),
      static_cast<const uint4*>(img), static_cast<float*>(o), S, D, kh, kw, keys, scale);
  return (int)cudaGetLastError();
}

// The instance of D rounded up to kDStep.
template <bool kKeyMask>
int dispatch(const void* q, const void* k, const void* v, const void* bias_h, const void* bias_w,
             void* img, void* o, int BH, int S, int D, int kh, int kw, int keys, float scale,
             cudaStream_t st) {
  switch ((D + kDStep - 1) / kDStep * kDStep) {
    case 160:
      return launch<160, kKeyMask>(q, k, v, bias_h, bias_w, img, o, BH, S, D, kh, kw, keys, scale,
                                   st);
    case 192:
      return launch<192, kKeyMask>(q, k, v, bias_h, bias_w, img, o, BH, S, D, kh, kw, keys, scale,
                                   st);
    case 224:
      return launch<224, kKeyMask>(q, k, v, bias_h, bias_w, img, o, BH, S, D, kh, kw, keys, scale,
                                   st);
    default:
      return launch<256, kKeyMask>(q, k, v, bias_h, bias_w, img, o, BH, S, D, kh, kw, keys, scale,
                                   st);
  }
}

}  // namespace

// The routing predicate (kernels/flash_attention.py relpos_wide_tf32_route
// mirrors it): 1 when the rel-pos entries of csrc/relpos_attention.cu take
// this kernel for K4 (kind 0, a rows x cols = kh x kw grid) or for K5's
// windows that run K4's kernels (kind 1): f32, D % 16 == 0 with 128 < D <=
// 256, rows * cols = S on any grid, a positive finite scale and every
// pointer on 16 bytes. dtype: 0 = float32, 1 = bfloat16.
extern "C" int bff_relpos_wide_tf32_takes(int kind, int dtype, int D, int S, int rows, int cols,
                                          float scale, const void* q, const void* k,
                                          const void* v, const void* o, const void* bias_h,
                                          const void* bias_w) {
  const bool shape = (kind == 0 || kind == 1) && rows >= 1 && cols >= 1 &&
                     static_cast<long long>(rows) * cols == S;
  return shape && dtype == 0 && D % 16 == 0 && D >= kMinD && D <= kMaxD && scale > 0.f &&
         scale <= FLT_MAX && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o) &&
         aligned16(bias_h) && aligned16(bias_w);
}

// q, k, v, o: contiguous (BH, S, D) f32 with S = kh * kw; bias_h (BH, S,
// kh), bias_w (BH, S, kw) f32. Returns cudaGetLastError() after the launch,
// -1 for arguments outside the predicate.
extern "C" int bff_flash_relpos_wide_tf32(const void* q, const void* k, const void* v,
                                          const void* bias_h, const void* bias_w, void* o,
                                          int BH, int S, int D, int kh, int kw, float scale,
                                          void* stream) {
  if (BH < 1 ||
      !bff_relpos_wide_tf32_takes(0, 0, D, S, kh, kw, scale, q, k, v, o, bias_h, bias_w))
    return -1;
  return dispatch<false>(q, k, v, bias_h, bias_w, nullptr, o, BH, S, D, kh, kw, S, scale,
                         static_cast<cudaStream_t>(stream));
}

// The routing predicate of the key-mask function (kernels/flash_attention.py
// wide_tf32_route mirrors it): 1 when bff_flash_attention takes this kernel
// for the call: f32, D % 16 == 0 with 128 < D <= 256, any S, 1 <= valid_len
// <= S, a positive finite scale and q, k, v and o on 16 bytes (it beat the
// FMA kernel's slices from S = 64 on: 0.0174 against 0.0339 ms at (16, 64,
// 160), 0.0229 against 0.0340 at (16, 64, 256)). dtype: 0 = float32, 1 =
// bfloat16.
extern "C" int bff_flash_wide_tf32_takes(int dtype, int D, int S, int valid_len, float scale,
                                         const void* q, const void* k, const void* v,
                                         const void* o) {
  return dtype == 0 && D % 16 == 0 && D >= kMinD && D <= kMaxD && valid_len >= 1 &&
         valid_len <= S && scale > 0.f && scale <= FLT_MAX && aligned16(q) && aligned16(k) &&
         aligned16(v) && aligned16(o);
}

// The scratch a key-mask call needs, in floats: K hi and lo, V^T hi and lo
// of every tile up to valid_len, each tile N x DP (DP = D rounded up to 32).
extern "C" long long bff_flash_wide_tf32_scratch_floats(int BH, int D, int valid_len) {
  const int dp = (D + kDStep - 1) / kDStep * kDStep;
  return 4LL * BH * tiles(D, valid_len) * (dp == 256 ? Cfg<256>::kN : Cfg<160>::kN) * dp;
}

// q, k, v, o: contiguous (BH, S, D) f32; keys >= valid_len masked; scratch:
// 16-byte aligned, at least bff_flash_wide_tf32_scratch_floats floats, on
// the same stream. Returns cudaGetLastError() after the launches, -1 for
// arguments outside the predicate or no scratch.
extern "C" int bff_flash_wide_tf32(const void* q, const void* k, const void* v, void* o,
                                   void* scratch, int BH, int S, int D, int valid_len,
                                   float scale, void* stream) {
  if (BH < 1 || scratch == nullptr || !aligned16(scratch) ||
      !bff_flash_wide_tf32_takes(0, D, S, valid_len, scale, q, k, v, o))
    return -1;
  return dispatch<true>(q, k, v, nullptr, nullptr, scratch, o, BH, S, D, 0, 0, valid_len, scale,
                        static_cast<cudaStream_t>(stream));
}
