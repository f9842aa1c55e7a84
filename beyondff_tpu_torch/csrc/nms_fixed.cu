// Class-agnostic greedy NMS with a fixed output size, one block per frame.
//
// Replaces the JAX package's `nms_fixed` (beyondff_tpu/models/yolo_world.py:313),
// a `lax.fori_loop` over every anchor that XLA runs as one sequential loop;
// it is no Pallas kernel, but in eager PyTorch the same loop would launch
// tens of thousands of small kernels a frame (YOLO-World-L: 8 400 anchors).
//
// Input: each frame's boxes already sorted by descending score (the caller's
// `torch.sort(-scores, stable=True)`, the counterpart of `jnp.argsort`) and
// that sort's indices. The block walks the sorted boxes in order, keeping
// the suppression state as a bitmask in shared memory (one bit a box): the
// next unsuppressed box is found a 32-bit word at a time, written out as
// kept, and every warp then tests 32 later boxes per step against it and
// ORs the ballot of those that overlap into the mask. A box's fate depends
// only on the kept boxes before it, so the scan stops once `top_k` boxes
// are kept: the first `top_k` kept indices are exactly the JAX loop's.
//
// Bound: the scan is serial in the kept boxes (at most top_k passes, each a
// __syncthreads-separated sweep over the later boxes), so the time is
// latency, not bytes (20 B an anchor) or operations (~12 flops an IoU).
//
// The IoU is the JAX expression in its order,
//   inter / (area[i] + area[j] - inter + 1e-9), compared `> iou_thres` in f32,
// written with round-to-nearest intrinsics so that nvcc cannot contract any
// product and sum into an FMA: a contracted `a + b - x*y` rounds once less
// and flips boxes that sit on the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__global__ void __launch_bounds__(kThreads)
nms_fixed_kernel(const float4* __restrict__ boxes, const int64_t* __restrict__ order, int a,
                 int top_k, float thr, int* __restrict__ keep_idx, bool* __restrict__ valid) {
  extern __shared__ unsigned mask[];  // bit j: sorted box j is suppressed
  const int frame = blockIdx.x;
  const float4* bx = boxes + (size_t)frame * a;
  const int64_t* ord = order + (size_t)frame * a;
  int* keep = keep_idx + (size_t)frame * top_k;
  bool* ok = valid + (size_t)frame * top_k;
  const int words = (a + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  for (int w = threadIdx.x; w < words; w += blockDim.x) mask[w] = 0u;
  __syncthreads();

  int kept = 0;
  int i = 0;
  while (kept < top_k) {
    // the next box at or after i that no kept box suppressed (same in every
    // thread: the mask was last written before the barrier below)
    while (i < a) {
      unsigned free_bits = ~mask[i >> 5] & (0xffffffffu << (i & 31));
      if (free_bits) {
        i = (i & ~31) + __ffs(free_bits) - 1;
        break;
      }
      i = (i | 31) + 1;
    }
    if (i >= a) break;
    __syncthreads();  // every thread has read the mask before it changes
    if (threadIdx.x == 0) {
      keep[kept] = (int)ord[i];
      ok[kept] = true;
    }
    ++kept;
    const float4 bi = bx[i];
    const float area_i = area_of(bi);
    for (int w = ((i + 1) >> 5) + warp; w < words; w += n_warps) {
      const int j = (w << 5) + lane;
      bool hit = false;
      if (j > i && j < a) {
        const float4 bj = __ldg(bx + j);
        const float x1 = fmaxf(bi.x, bj.x), y1 = fmaxf(bi.y, bj.y);
        const float x2 = fminf(bi.z, bj.z), y2 = fminf(bi.w, bj.w);
        const float inter =
            __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f), fmaxf(__fsub_rn(y2, y1), 0.f));
        const float denom =
            __fadd_rn(__fsub_rn(__fadd_rn(area_i, area_of(bj)), inter), 1e-9f);
        hit = __fdiv_rn(inter, denom) > thr;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0 && ballot) mask[w] |= ballot;
    }
    __syncthreads();
    ++i;
  }
  // padding as `nms_fixed` pads: index 0, not valid
  for (int r = kept + threadIdx.x; r < top_k; r += blockDim.x) {
    keep[r] = 0;
    ok[r] = false;
  }
}

}  // namespace

extern "C" int bff_nms_fixed(const void* boxes_sorted, const void* order, int b, int a,
                             int top_k, float iou_thres, void* keep_idx, void* valid,
                             void* stream) {
  if (b <= 0 || top_k <= 0) return 0;
  const size_t smem = (size_t)((a + 31) / 32) * sizeof(unsigned);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  nms_fixed_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)boxes_sorted, (const int64_t*)order, a, top_k, iou_thres,
      (int*)keep_idx, (bool*)valid);
  return (int)cudaGetLastError();
}
