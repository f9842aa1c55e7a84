// Class-agnostic greedy NMS with a fixed output size: a thread-block cluster
// per frame, each block holding a slice of the frame's sorted boxes.
//
// Replaces the JAX package's `nms_fixed` (beyondff_tpu/models/yolo_world.py:313),
// a `lax.fori_loop` over every anchor that XLA runs as one sequential loop;
// it is no Pallas kernel, but in eager PyTorch the same loop would launch
// tens of thousands of small kernels a frame (YOLO-World-L: 8 400 anchors).
//
// Input: each frame's boxes already sorted by descending score (the caller's
// `torch.sort(-scores, stable=True)`, the counterpart of `jnp.argsort`) and
// that sort's indices. A box's fate depends only on the kept boxes before
// it, so the scan walks the sorted boxes in order and stops once `top_k`
// boxes are kept: the first `top_k` kept indices are exactly the JAX
// loop's.
//
// Bound: the scan is serial in the kept boxes (at most top_k), and the work
// between two of them, one IoU test per later box (~12 flops, 20 bytes), is
// tiny, so the time is the latency of the rounds, not bytes or operations.
//
// Design (the earlier one ran a frame on one block of one SM, read the
// later boxes from L1/L2 for every kept box behind two __syncthreads, and
// divided on every pair):
// * A cluster of kCluster blocks per frame, on as many SMs. Block r holds
//   sorted boxes [r * slice, (r + 1) * slice), slice a multiple of 32,
//   staged once into shared memory by one bulk async copy (cp.async.bulk
//   with an mbarrier), their areas computed there, and the suppression
//   bits of its slice (one bit a box; bits past the frame set).
// * A round resolves up to kLook boxes. Every block tests the boxes the
//   last round kept against its slice's free boxes after the last resolved
//   position, a warp per 32-box word, skipping words whose boxes are all
//   suppressed and lanes whose box is, and ORs each warp's ballot into the
//   word. After a __syncthreads its warp 0 finds the slice's first kLook
//   free boxes and writes them (index, box and area) into every block's
//   shared memory (distributed shared memory, two buffers by round
//   parity). One cluster barrier later every warp takes the kLook smallest
//   of the kCluster * kLook offers: they are the frame's first kLook free
//   boxes, since each slice offered its own first kLook. It keeps them in
//   order, each unless a box kept before it in this round suppresses it,
//   which is greedy NMS over them exactly. A round costs one __syncthreads
//   and one cluster barrier, about 4 us; 100 kept boxes of clustered
//   anchors take 26 rounds, where one box a round took 101.
// * The IoU test decides inter / denom > thr without the division wherever
//   the answer is certain: inter == 0 with thr > 0, or inter beyond
//   thr * denom by a relative margin of 2^-20 on either side (the quotient
//   then rounds to a float on that side of thr). Near the threshold, and for
//   a threshold that is not a positive normal float, it divides
//   (__fdiv_rn) as the JAX expression does, so the decision equals the f32
//   division on every pair.
// Measured on an H100 SXM at 700 W (tools/kernel_variants.py, 4 x 8 400
// clustered anchors, top_k 100): the scan 0.104 ms against 0.603 ms for the
// earlier kernel; one box a round 0.189, every pair divided 0.131, one
// block a frame 0.323, and the pairwise-bitmask design
// (tools/variant_csrc/nms_bitmask.cu) 0.350.
//
// * Frames above kCluster * kMaxSlice = 90 112 boxes take the same kernel in
//   its large mode (nms_fixed_kernel<false>, bff_nms_fixed_large): the
//   boxes stay in device memory, read through L1/L2 (__ldg) by every round
//   that tests them, and each area is recomputed from its box where the
//   staged mode reads it from shared memory (area_of is deterministic, so
//   the decisions are the same). Only the suppression bits sit in shared
//   memory: one bit a box, kMaskSmemWords words (224 KB) a block, which
//   holds slices of 1 835 008 boxes, 14 680 064 a frame. Larger frames keep
//   the bits in device memory (scratch from the wrapper, one word run a
//   block; a block touches only its own words, so __syncthreads orders
//   them), up to kMaxBoxes, where positions stop fitting an int. The rounds,
//   the offers and the kept boxes are the staged mode's, so both give the
//   plain greedy scan's index sequence.
//   Each warp tests kLargeUnroll words at once, their boxes' loads in
//   flight together. Measured as above (top_k 100, the call with its sort
//   and gather): 2 x 90 113 boxes 0.480 ms, 2 x 393 216 1.574, 1 x 1 048 576
//   4.357 (the scan 3.63; one word a warp at a time 4.50, eight 3.50), and
//   at 4 x 8 400 0.183 against the staged mode's 0.174. The scan walks
//   every free box of a slice every round from L2 on the cluster's 8 SMs.
//
// The IoU is the JAX expression in its order,
//   inter / (area[i] + area[j] - inter + 1e-9), compared `> iou_thres` in f32,
// written with round-to-nearest intrinsics so that nvcc cannot contract any
// product and sum into an FMA: a contracted `a + b - x*y` rounds once less
// and flips boxes that sit on the threshold.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks (SMs) per frame
constexpr int kThreads = 512;  // threads per block
constexpr int kMaxSlice = 11264;  // boxes a block holds: 220 KB of boxes and areas
constexpr int kLook = 4;         // free boxes a block offers a round
constexpr int kNone = INT_MAX;   // no free box in a slice
// the large mode: suppression words a block keeps in shared memory (224 KB:
// slices of 1 835 008 boxes), and the most boxes a frame (positions and
// slice ends stay below INT_MAX)
constexpr int kMaskSmemWords = 57344;
constexpr int kLargeUnroll = 4;  // the large mode: suppression words a warp tests at once
constexpr int kMaxBoxes = INT_MAX - 32 * kCluster;

// A block's candidate for the next kept box, written into every block.
struct alignas(16) Candidate {
  int idx;
  float area;
  int pad[2];
  float4 box;
};

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// inter / (area_i + area_j - inter + 1e-9) > thr, as the f32 division
// decides it; ``exact_free`` says thr is a positive normal float, for which
// the division is skipped where its result is certain.
__device__ __forceinline__ bool suppresses(float4 bi, float ai, float4 bj, float aj, float thr,
                                           bool exact_free) {
  const float x1 = fmaxf(bi.x, bj.x), y1 = fmaxf(bi.y, bj.y);
  const float x2 = fminf(bi.z, bj.z), y2 = fminf(bi.w, bj.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
  if (exact_free && inter == 0.f) return false;  // 0 / denom is +0 or nan: not > thr
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-9f);
  if (exact_free) {
    const float lim = __fmul_rn(thr, denom);
    if (lim >= 0x1p-100f && lim <= 0x1p100f) {
      if (inter > __fmul_rn(lim, 1.f + 0x1p-20f)) return true;
      if (inter < __fmul_rn(lim, 1.f - 0x1p-20f)) return false;
    }
  }
  return __fdiv_rn(inter, denom) > thr;
}

// kStaged: the slice's boxes and areas in shared memory (frames up to
// kCluster * kMaxSlice boxes); otherwise the large mode, boxes read from
// device memory and the suppression bits in shared memory, or at gmask
// (words_pad words a block) when it is not null.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
nms_fixed_kernel(const float4* __restrict__ boxes, const int64_t* __restrict__ order, int a,
                 int slice, int top_k, float thr, unsigned* __restrict__ gmask,
                 int* __restrict__ keep_idx, bool* __restrict__ valid) {
  static_assert(kCluster * kLook <= 32, "one offer a lane");
  constexpr int kOffers = kCluster * kLook;
  extern __shared__ __align__(16) unsigned char nms_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int frame = blockIdx.x / kCluster;
  const int words = slice / 32, words_pad = (words + 3) & ~3;
  float4* sbox = reinterpret_cast<float4*>(nms_smem);               // slice boxes (staged)
  float* sarea = reinterpret_cast<float*>(sbox + (kStaged ? slice : 0));  // their areas
  unsigned* smask = reinterpret_cast<unsigned*>(sarea + (kStaged ? slice : 0));
  const bool bits_in_smem = kStaged || gmask == nullptr;
  unsigned* mask =  // bit: suppressed
      bits_in_smem ? smask : gmask + ((size_t)frame * kCluster + rank) * words_pad;
  Candidate* cand = reinterpret_cast<Candidate*>(smask + (bits_in_smem ? words_pad : 0));
  uint64_t* bar = reinterpret_cast<uint64_t*>(cand + 2 * kOffers);  // [2][kOffers] before it
  int* offer = reinterpret_cast<int*>(bar + 1);                      // [kLook]

  const int lo = rank * slice;
  const int n_in = max(0, min(slice, a - lo));  // boxes of the frame in this slice
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = kThreads / 32;
  const bool exact_free = thr >= FLT_MIN && thr <= FLT_MAX;
  const float4* gbox = boxes + (size_t)frame * a + lo;  // the slice in device memory
  // box li of the slice and its area: from shared memory (staged) or from
  // device memory, the area recomputed
  auto box_at = [&](int li) {
    if constexpr (kStaged) return sbox[li];
    else return __ldg(gbox + li);
  };
  auto area_at = [&](int li, float4 b) {
    if constexpr (kStaged) return sarea[li];
    else return area_of(b);
  };

  if (kStaged && threadIdx.x == 0 && n_in > 0) {
    bff_wg::bar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bff_wg::bar_expect_tx(bar, n_in * 16);
    bff_wg::bulk_load(sbox, gbox, n_in * 16, bar);
  }
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int first = 32 * w;  // bits of boxes past the frame start suppressed
    mask[w] = first >= n_in ? 0xffffffffu : (n_in - first >= 32 ? 0u : ~0u << (n_in - first));
  }
  __syncthreads();  // the barrier is initialised
  if (kStaged && n_in > 0) {
    bff_wg::bar_wait(bar, 0);
    for (int j = threadIdx.x; j < n_in; j += kThreads) sarea[j] = area_of(sbox[j]);
  }
  cluster.sync();  // every block of the cluster runs and has its slice

  int* keep = keep_idx + (size_t)frame * top_k;
  // pos: the last sorted position resolved; kb, ka: the boxes the last round
  // kept (nk of them), which the slices test next
  int pos = -1, kept = 0, parity = 0, nk = 0;
  float4 kb[kLook];
  float ka[kLook];
#pragma unroll
  for (int q = 0; q < kLook; ++q) {
    kb[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    ka[q] = 0.f;
  }
  while (true) {
    if (nk > 0 && lo + n_in > pos + 1) {
      // test the kept boxes against this slice's free boxes after pos
      const int first_w = max(pos + 1 - lo, 0) >> 5;
      if constexpr (kStaged) {
        for (int w = first_w + warp; w < words; w += n_warps) {
          const unsigned word = mask[w];
          if (word == 0xffffffffu) continue;  // every box of the word is suppressed
          const int j = lo + 32 * w + lane;
          bool hit = false;
          if (j > pos && !((word >> lane) & 1u)) {
            const float4 bj = box_at(j - lo);
            const float aj = area_at(j - lo, bj);
#pragma unroll
            for (int q = 0; q < kLook; ++q)
              if (q < nk && !hit) hit = suppresses(kb[q], ka[q], bj, aj, thr, exact_free);
          }
          const unsigned ballot = __ballot_sync(0xffffffffu, hit);
          if (lane == 0 && ballot) mask[w] = word | ballot;
        }
      } else {
        // kLargeUnroll consecutive words a warp at once, their boxes' loads
        // from device memory in flight together (one word at a time, each
        // warp waits out an L2 round trip per word)
        for (int w0 = first_w + warp * kLargeUnroll; w0 < words;
             w0 += n_warps * kLargeUnroll) {
          unsigned word[kLargeUnroll];
          bool live[kLargeUnroll];
          float4 bj[kLargeUnroll];
#pragma unroll
          for (int u = 0; u < kLargeUnroll; ++u) {
            const int w = w0 + u, j = lo + 32 * w + lane;
            word[u] = w < words ? mask[w] : 0xffffffffu;
            live[u] = j > pos && !((word[u] >> lane) & 1u);
            bj[u] = live[u] ? box_at(j - lo) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kLargeUnroll; ++u) {
            bool hit = false;
            if (live[u]) {
              const float aj = area_at(0, bj[u]);
#pragma unroll
              for (int q = 0; q < kLook; ++q)
                if (q < nk && !hit) hit = suppresses(kb[q], ka[q], bj[u], aj, thr, exact_free);
            }
            const unsigned ballot = __ballot_sync(0xffffffffu, hit);
            if (lane == 0 && ballot) mask[w0 + u] = word[u] | ballot;
          }
        }
      }
    }
    __syncthreads();  // this slice's bits are final for the round
    if (warp == 0) {
      // the slice's first kLook free boxes after pos, offered to every block
      const int start = max(pos + 1 - lo, 0);
      int found = 0;
      for (int w0 = start >> 5; w0 < words && found < kLook; w0 += 32) {
        const int w = w0 + lane;
        unsigned free_bits = 0u;
        if (w < words) {
          free_bits = ~mask[w];
          if (w == start >> 5) free_bits &= ~0u << (start & 31);
        }
        const int n = __popc(free_bits);
        int incl = n;  // free boxes in this lane's word and the words before it
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += v;
        }
        for (int slot = found + incl - n; free_bits && slot < kLook; ++slot) {
          offer[slot] = 32 * w + __ffs(free_bits) - 1;
          free_bits &= free_bits - 1;
        }
        found += __shfl_sync(0xffffffffu, incl, 31);
      }
      __syncwarp();
      if (lane < kOffers) {
        const int q = lane % kLook, li = q < found ? offer[q] : -1;
        Candidate c;
        c.idx = li < 0 ? kNone : lo + li;
        c.box = li < 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : box_at(li);
        c.area = li < 0 ? 0.f : area_at(li, c.box);
        c.pad[0] = c.pad[1] = 0;
        *cluster.map_shared_rank(cand + parity * kOffers + rank * kLook + q, lane / kLook) = c;
      }
    }
    cluster.sync();  // every block's offers are in (release / acquire)
    // Every warp takes the kLook smallest offers, the frame's first free
    // boxes after pos in order, and keeps them greedily: each unless a box
    // kept before it in this round suppresses it.
    const Candidate* round = cand + parity * kOffers;
    int mine = lane < kOffers ? round[lane].idx : kNone;
    parity ^= 1;
    nk = 0;
    bool done = false;
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      const int m = __reduce_min_sync(0xffffffffu, mine);
      if (m == kNone || done) break;
      const int src = __ffs(__ballot_sync(0xffffffffu, mine == m)) - 1;
      if (lane == src) mine = kNone;
      const float4 bq = round[src].box;
      const float aq = round[src].area;
      bool free_q = true;
#pragma unroll
      for (int p = 0; p < kLook; ++p)
        if (p < nk && free_q && suppresses(kb[p], ka[p], bq, aq, thr, exact_free)) free_q = false;
      pos = m;
      if (free_q) {
#pragma unroll
        for (int p = 0; p < kLook; ++p)
          if (p == nk) {
            kb[p] = bq;
            ka[p] = aq;
          }
        ++nk;
        if (rank == 0 && threadIdx.x == 0) keep[kept] = m;  // the sorted position, for now
        done = ++kept == top_k;
      }
    }
    if (nk == 0 || done) break;  // no free box left, or top_k kept
  }
  if (rank == 0) {
    __syncthreads();  // thread 0's positions are visible to the block
    // positions to the input's indices; padding as `nms_fixed` pads: index 0, not valid
    const int64_t* ord = order + (size_t)frame * a;
    bool* ok = valid + (size_t)frame * top_k;
    for (int r = threadIdx.x; r < top_k; r += kThreads) {
      keep[r] = r < kept ? (int)ord[keep[r]] : 0;
      ok[r] = r < kept;
    }
  }
  // no block touches another's shared memory after the last cluster barrier,
  // so the blocks exit without another one
}

// Boxes per block for ``a`` boxes a frame: a multiple of 32.
int slice_of(int a) { return ((a + kCluster - 1) / kCluster + 31) / 32 * 32; }

int words_of(int slice) { return (slice / 32 + 3) & ~3; }

int smem_of(int slice) {
  return slice * 20 + words_of(slice) * 4 + 2 * kCluster * kLook * (int)sizeof(Candidate) + 8 +
         4 * kLook;
}

// the large mode's shared memory: the suppression bits when they fit, the
// offers, the barrier's room, the offer slots
int large_smem_of(int slice) {
  const int words = words_of(slice);
  return (words <= kMaskSmemWords ? words * 4 : 0) +
         2 * kCluster * kLook * (int)sizeof(Candidate) + 8 + 4 * kLook;
}

template <bool kStaged>
int launch(const void* boxes_sorted, const void* order, int b, int a, int top_k, float thr,
           unsigned* gmask, void* keep_idx, void* valid, int smem, int max_smem,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_fixed_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, nms_fixed_kernel<kStaged>, static_cast<const float4*>(boxes_sorted),
      static_cast<const int64_t*>(order), a, slice_of(a), top_k, thr, gmask,
      static_cast<int*>(keep_idx), static_cast<bool*>(valid));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// Frames of up to kCluster * kMaxSlice boxes (the staged mode).
extern "C" int bff_nms_fixed(const void* boxes_sorted, const void* order, int b, int a,
                             int top_k, float iou_thres, void* keep_idx, void* valid,
                             void* stream) {
  if (b <= 0 || top_k <= 0) return 0;
  if (a < 0 || slice_of(a) > kMaxSlice) return (int)cudaErrorInvalidValue;
  return launch<true>(boxes_sorted, order, b, a, top_k, iou_thres, nullptr, keep_idx, valid,
                      smem_of(slice_of(a)), smem_of(kMaxSlice),
                      static_cast<cudaStream_t>(stream));
}

// The words of device memory the large mode's suppression bits need for b
// frames of a boxes: 0 where a block's bits fit in shared memory (slices of
// up to 32 kMaskSmemWords boxes), else b kCluster runs of a block's words
// (kernels/nms.py large_scratch_words mirrors it).
extern "C" long long bff_nms_large_scratch_words(int b, int a) {
  if (b <= 0 || a <= 0 || a > kMaxBoxes) return 0;
  const int words = words_of(slice_of(a));
  return words <= kMaskSmemWords ? 0 : (long long)b * kCluster * words;
}

// The large mode, for frames of 1 to kMaxBoxes boxes (the wrapper sends it
// those above kCluster * kMaxSlice). scratch: bff_nms_large_scratch_words
// words of device memory where that is not 0, else unread. Returns -1 for a
// frame outside that range or missing scratch.
extern "C" int bff_nms_fixed_large(const void* boxes_sorted, const void* order, int b, int a,
                                   int top_k, float iou_thres, void* scratch, void* keep_idx,
                                   void* valid, void* stream) {
  if (b <= 0 || top_k <= 0) return 0;
  if (a < 1 || a > kMaxBoxes) return -1;
  unsigned* gmask = nullptr;
  if (bff_nms_large_scratch_words(b, a) > 0) {
    if (scratch == nullptr) return -1;
    gmask = static_cast<unsigned*>(scratch);
  }
  return launch<false>(boxes_sorted, order, b, a, top_k, iou_thres, gmask, keep_idx, valid,
                       large_smem_of(slice_of(a)), large_smem_of(32 * kMaskSmemWords),
                       static_cast<cudaStream_t>(stream));
}
