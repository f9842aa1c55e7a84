// Multi-scale deformable sampling on Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel beyondff_tpu/kernels/deform_window.py
// (sample_level_windowed, the Pallas body _kernel) and the exact gather path
// of beyondff_tpu/models/gdino/deformable.py (ms_deform_attn). One launch
// covers every level and point of one MSDeformAttn call:
//
//   out[b, q, h, :] = sum_{l, p} aw[b, q, h, l, p] * bilinear(value_l[b, :, h, :], loc[b, q, h, l, p])
//
// Design: the original Deformable-DETR op's, not the TPU's tile-window
// matmul (that formulation existed only because Mosaic has no gather). One
// warp per (batch, query, head); lane c owns channel c of the head (head dim
// 32 = one warp; a wider head loops over channels in steps of 32). For each
// level and point the warp computes the four bilinear corners and reads each
// corner's channel row of `value` as one coalesced 64-byte (bf16) row, and
// accumulates in f32.
//
// Per level, `w3` selects the mode:
//   w3 == 0  exact: zero padding outside the map (the reference op);
//   w3 > 0   clamp: the TPU kernel's semantics. The query's window origin
//            (tile_origin - radius, from build_assignment) comes in
//            `origin`; the sample clamps to [origin, origin + w3 - 2] in
//            window coordinates, contributes 0 unless -1 < g < size on both
//            axes, and corners outside the map read 0.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): bytes. Unique bytes
// are the value map, the locations, the weights and the output, about 41 MB
// for the 800x1072 encoder raster in bf16 (~12 us); the work is 16 samples x
// 4 corners x 32 channels of FMAs per (query, head), far below the compute
// roof. What the design does about it: every corner read is one coalesced
// row, the value map (9 MB) stays in the 50 MB L2 across the call, and the
// locations and weights of a (query, head) are read once by the warp.
// Nothing is staged in shared memory yet; that and a wider vector load per
// lane are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxChannelsPerLane = 4;  // head dim <= 128

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
  int w3[kMaxLevels];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(256) ms_deform_sample_kernel(
    const T* __restrict__ value, const float* __restrict__ locs,
    const T* __restrict__ aw, const int* __restrict__ origin, T* __restrict__ out,
    int B, int S, int Q, int H, int D, int L, int P, Levels lv) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * Q * H) return;
  const int h = (int)(warp % H);
  const int q = (int)((warp / H) % Q);
  const int b = (int)(warp / ((long long)H * Q));
  const float* loc = locs + warp * L * P * 2;
  const T* a = aw + warp * L * P;
  const long long row_stride = (long long)H * D;
  const T* vb = value + (long long)b * S * row_stride + (long long)h * D;

  float acc[kMaxChannelsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxChannelsPerLane; ++i) acc[i] = 0.f;

  for (int l = 0; l < L; ++l) {
    const int hh = lv.h[l], ww = lv.w[l], w3 = lv.w3[l];
    const T* vl = vb + (long long)lv.start[l] * row_stride;
    for (int p = 0; p < P; ++p) {
      const float lx = loc[(l * P + p) * 2];
      const float ly = loc[(l * P + p) * 2 + 1];
      const float wgt = to_f(a[l * P + p]);
      // align_corners=False cell coordinates, rounded as the plain version
      const float gx = __fsub_rn(__fmul_rn(lx, (float)ww), 0.5f);
      const float gy = __fsub_rn(__fmul_rn(ly, (float)hh), 0.5f);
      int x0, y0;
      float fx, fy;
      if (w3 > 0) {
        if (!(gy > -1.f && gy < (float)hh && gx > -1.f && gx < (float)ww)) continue;
        const int oy = origin[((long long)l * Q + q) * 2];
        const int ox = origin[((long long)l * Q + q) * 2 + 1];
        const float ry = fminf(fmaxf(__fsub_rn(gy, (float)oy), 0.f), (float)(w3 - 2));
        const float rx = fminf(fmaxf(__fsub_rn(gx, (float)ox), 0.f), (float)(w3 - 2));
        const float ry0 = floorf(ry), rx0 = floorf(rx);
        fy = __fsub_rn(ry, ry0);
        fx = __fsub_rn(rx, rx0);
        y0 = (int)ry0 + oy;
        x0 = (int)rx0 + ox;
      } else {
        const float y0f = floorf(gy), x0f = floorf(gx);
        fy = __fsub_rn(gy, y0f);
        fx = __fsub_rn(gx, x0f);
        y0 = (int)fminf(fmaxf(y0f, -2.f), (float)(hh + 1));
        x0 = (int)fminf(fmaxf(x0f, -2.f), (float)(ww + 1));
      }
#pragma unroll
      for (int corner = 0; corner < 4; ++corner) {
        const int dy = corner >> 1, dx = corner & 1;
        const int yy = y0 + dy, xx = x0 + dx;
        if (yy < 0 || yy >= hh || xx < 0 || xx >= ww) continue;
        const float cw = (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx) * wgt;
        const T* src = vl + ((long long)yy * ww + xx) * row_stride;
#pragma unroll
        for (int i = 0; i < kMaxChannelsPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < D) acc[i] = fmaf(cw, to_f(src[c]), acc[i]);
        }
      }
    }
  }
  T* o = out + warp * D;
#pragma unroll
  for (int i = 0; i < kMaxChannelsPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < D) o[c] = from_f<T>(acc[i]);
  }
}

template <typename T>
int launch(const void* value, const void* locs, const void* aw, const void* origin,
           void* out, int B, int S, int Q, int H, int D, int L, int P, const Levels& lv,
           cudaStream_t stream) {
  const long long warps = (long long)B * Q * H;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  ms_deform_sample_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(locs),
      static_cast<const T*>(aw), static_cast<const int*>(origin), static_cast<T*>(out),
      B, S, Q, H, D, L, P, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (value, aw and out share it; locs are f32).
// levels: host array of L rows (h, w, start, w3). origin: device int32
// (L, Q, 2) window origins, read only for levels with w3 > 0 (may be null
// when every level is exact). Returns cudaGetLastError() after the launch,
// or -1 for arguments the kernel does not take.
extern "C" int bff_ms_deform_sample(int dtype, const void* value, const void* locs,
                                    const void* aw, const void* origin, void* out,
                                    int B, int S, int Q, int H, int D, int L, int P,
                                    const int* levels, void* stream) {
  if (L < 1 || L > kMaxLevels || D < 1 || D > 32 * kMaxChannelsPerLane) return -1;
  Levels lv;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[4 * l];
    lv.w[l] = levels[4 * l + 1];
    lv.start[l] = levels[4 * l + 2];
    lv.w3[l] = levels[4 * l + 3];
    if (lv.w3[l] > 0 && origin == nullptr) return -1;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(value, locs, aw, origin, out, B, S, Q, H, D, L, P, lv, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(value, locs, aw, origin, out, B, S, Q, H, D, L, P, lv, s);
  return -1;
}
