// Class-agnostic greedy NMS from a pairwise suppression bitmask: a variant
// of csrc/nms_fixed.cu that tools/kernel_variants.py builds and times
// beside it (variant ``nms_bitmask``); it is on no path.
//
// The same function as bff_nms_fixed (sorted boxes and the sort's indices
// in; keep_idx and valid out, padded with index 0 and false), in two
// kernels:
// * nms_mask_kernel, over the whole card: for every frame and every pair
//   i < j of its sorted boxes, bit j of row i is set when box i suppresses
//   box j (the JAX expression in f32, decided by csrc/nms_fixed.cu's
//   division-free test). A block of 128 threads takes 128 rows against a
//   tile of 256 columns staged in shared memory; tiles wholly at or below
//   the diagonal are skipped, so the pass makes A^2 / 2 tests a frame
//   whatever the data, where the scan of csrc/nms_fixed.cu tests only the
//   kept boxes' rows.
// * nms_scan_kernel, one warp a frame: the removed set held in registers
//   (kRegWords words a lane), the sorted boxes walked a word at a time; each
//   kept box ORs its row of the bitmask (from L2) into the set.
// ws: B * A * ceil(A / 32) words of scratch, written before read.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;      // rows of a mask block (one a thread)
constexpr int kColWords = 8;    // 32-box words of a column tile
constexpr int kRegWords = 16;   // removed words a lane holds: A <= 16 384
constexpr float kMargin = 0x1p-20f;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ bool suppresses(float4 bi, float ai, float4 bj, float aj, float thr,
                                           bool exact_free) {
  const float x1 = fmaxf(bi.x, bj.x), y1 = fmaxf(bi.y, bj.y);
  const float x2 = fminf(bi.z, bj.z), y2 = fminf(bi.w, bj.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
  if (exact_free && inter == 0.f) return false;
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(ai, aj), inter), 1e-9f);
  if (exact_free) {
    const float lim = __fmul_rn(thr, denom);
    if (lim >= 0x1p-100f && lim <= 0x1p100f) {
      if (inter > __fmul_rn(lim, 1.f + kMargin)) return true;
      if (inter < __fmul_rn(lim, 1.f - kMargin)) return false;
    }
  }
  return __fdiv_rn(inter, denom) > thr;
}

__global__ void __launch_bounds__(kRows)
nms_mask_kernel(const float4* __restrict__ boxes, int a, int words, float thr,
                unsigned* __restrict__ ws) {
  __shared__ float4 cbox[32 * kColWords];
  __shared__ float carea[32 * kColWords];
  const int frame = blockIdx.z;
  const int r0 = blockIdx.y * kRows, c0 = blockIdx.x * 32 * kColWords;
  if (c0 + 32 * kColWords <= r0 + 1) return;  // no pair i < j in the tile
  const float4* bx = boxes + (size_t)frame * a;
  for (int c = threadIdx.x; c < 32 * kColWords; c += kRows) {
    const float4 b = c0 + c < a ? bx[c0 + c] : make_float4(0.f, 0.f, 0.f, 0.f);
    cbox[c] = b;
    carea[c] = area_of(b);
  }
  __syncthreads();
  const int i = r0 + threadIdx.x;
  if (i >= a) return;
  const bool exact_free = thr >= FLT_MIN && thr <= FLT_MAX;
  const float4 bi = bx[i];
  const float ai = area_of(bi);
  unsigned* row = ws + ((size_t)frame * a + i) * words + c0 / 32;
  for (int w = 0; w < kColWords && c0 / 32 + w < words; ++w) {
    unsigned bits = 0u;
    for (int l = 0; l < 32; ++l) {
      const int j = c0 + 32 * w + l;
      if (j > i && j < a && suppresses(bi, ai, cbox[32 * w + l], carea[32 * w + l], thr,
                                       exact_free))
        bits |= 1u << l;
    }
    row[w] = bits;
  }
}

__global__ void __launch_bounds__(32)
nms_scan_kernel(const unsigned* __restrict__ ws, const int64_t* __restrict__ order, int a,
                int words, int top_k, int* __restrict__ keep_idx, bool* __restrict__ valid) {
  const int frame = blockIdx.x, lane = threadIdx.x;
  const unsigned* mask = ws + (size_t)frame * a * words;
  const int64_t* ord = order + (size_t)frame * a;
  int* keep = keep_idx + (size_t)frame * top_k;
  bool* ok = valid + (size_t)frame * top_k;
  unsigned removed[kRegWords];  // word 32 k + lane of the removed set
#pragma unroll
  for (int k = 0; k < kRegWords; ++k) {
    const int w = 32 * k + lane, first = 32 * w;
    removed[k] = first >= a ? 0xffffffffu : (a - first >= 32 ? 0u : ~0u << (a - first));
  }
  int kept = 0;
  for (int w = 0; w < words && kept < top_k; ++w) {
    const int k = w >> 5, src = w & 31;
    unsigned mine = 0u;
#pragma unroll
    for (int kk = 0; kk < kRegWords; ++kk)
      if (kk == k) mine = removed[kk];
    unsigned free_bits = ~__shfl_sync(0xffffffffu, mine, src);
    while (free_bits && kept < top_k) {
      const int bit = __ffs(free_bits) - 1;
      const int i = 32 * w + bit;
      if (lane == 0) {
        keep[kept] = (int)ord[i];
        ok[kept] = true;
      }
      ++kept;
      // OR row i (words w .. words - 1) into the removed set
      const unsigned* row = mask + (size_t)i * words;
#pragma unroll
      for (int kk = 0; kk < kRegWords; ++kk) {
        const int ww = 32 * kk + lane;
        if (ww >= w && ww < words) removed[kk] |= row[ww];
      }
      mine = 0u;
#pragma unroll
      for (int kk = 0; kk < kRegWords; ++kk)
        if (kk == k) mine = removed[kk];
      free_bits = ~__shfl_sync(0xffffffffu, mine, src) & (~0u << bit) & ~(1u << bit);
    }
  }
  for (int r = kept + lane; r < top_k; r += 32) {
    keep[r] = 0;
    ok[r] = false;
  }
}

}  // namespace

extern "C" int bff_nms_bitmask(const void* boxes_sorted, const void* order, int b, int a,
                               int top_k, float iou_thres, void* ws, void* keep_idx,
                               void* valid, void* stream) {
  if (b <= 0 || top_k <= 0) return 0;
  if (a < 1 || a > 32 * 32 * kRegWords) return (int)cudaErrorInvalidValue;
  const int words = (a + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((a + 32 * kColWords - 1) / (32 * kColWords), (a + kRows - 1) / kRows, b);
  nms_mask_kernel<<<grid, kRows, 0, s>>>(static_cast<const float4*>(boxes_sorted), a, words,
                                         iou_thres, static_cast<unsigned*>(ws));
  nms_scan_kernel<<<b, 32, 0, s>>>(static_cast<const unsigned*>(ws),
                                   static_cast<const int64_t*>(order), a, words, top_k,
                                   static_cast<int*>(keep_idx), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
