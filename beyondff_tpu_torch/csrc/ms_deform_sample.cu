// Multi-scale deformable sampling on Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel beyondff_tpu/kernels/deform_window.py
// (sample_level_windowed, the Pallas body _kernel) and the exact gather path
// of beyondff_tpu/models/gdino/deformable.py (ms_deform_attn). One launch
// covers every level and point of one MSDeformAttn call. Every call of the
// port takes this gather; a kernel that samples the encoder's windowed call
// from TMA-staged windows lost to it at the encoder raster and is kept only
// as a variant (tools/variant_csrc/ms_deform_window_tma.cu; PERF.md
// section 6):
//
//   out[b, q, h, :] = sum_{l, p} aw[b, q, h, l, p] * bilinear(value_l[b, :, h, :], loc[b, q, h, l, p])
//
// Per level, `w3` selects the mode:
//   w3 == 0  exact: zero padding outside the map (the reference op);
//   w3 > 0   clamp: the TPU kernel's semantics. The query's window origin
//            (tile_origin - radius, from build_assignment) comes in
//            `origin`; a sample beyond [origin, origin + w3 - 2] clamps to
//            that edge, one inside it samples exactly (as the exact mode
//            does, bit for bit), it contributes 0 unless -1 < g < size on
//            both axes, and corners outside the map read 0.
//
// A gather, not the TPU kernel's tile-window matmul: Mosaic has no gather,
// so the TPU builds a dense (window cells x queries) weight matrix, of which
// a level-0 query-head row holds at most 16 non-zeros in 1 024 cells; on the
// tensor cores that would be ~64x the FMAs.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. Unique bytes at the 800x1072
// encoder raster, batch 4, bf16: value 36.5 MB, locations 73.0 MB, weights
// 18.2 MB, output 36.5 MB, 0.049 ms. The FMAs (16 samples x 4 corners x head
// dim per query-head) are far below the f32 roof. What the kernel really
// moves is the corner rows: 36.5 M rows of 64 bytes (bf16, head dim 32),
// 2.3 GB through L2 unless L1 catches a repeat; the value map (36.5 MB)
// stays in the 50 MB L2. So the limit is how many corner loads are in
// flight against L2's latency and rate.
//
// Design:
// - Wide loads. A lane owns one 16-byte chunk of a head's row (8 bf16 or 4
//   f32 channels), so a (query, head) row takes D * size / 16 lanes (4 in
//   bf16 at head dim 32) and a warp serves 8 rows at once. Shapes whose row
//   or base is not a multiple of 16 bytes take 8-, 4- or 2-byte chunks in
//   the same kernel, a lane then owning up to 4 chunks.
// - Samples in flight. For (L, P) = (4, 4) and (3, 4), template
//   parameters, everything unrolls: a level's 8 location floats come as two
//   16-byte loads and its 4 weights as one, the clamp origin once per
//   (level, query), then all 16 corner addresses and bilinear weights of the
//   level, then the 16 corner loads together, then the f32 FMAs. Other
//   (L, P) loop at run time, one point's 4 corners in flight.
// - Occupancy. __launch_bounds__(256, 3): ptxas (-Xptxas -v) gives the
//   (4, 4) kernels 80 registers with 12 (bf16) or 8 (f32) bytes of spill,
//   24 warps an SM. At 2 blocks they take 128 registers, no spill, 16
//   warps, and run ~10% slower; at 4 (64 registers) bf16 loses ~6%.
// - Order. Rows walk the raster, row (b * Q + q) * H + h, so a warp holds
//   one query's 8 heads. Eight queries of one head a warp, and the level-0
//   tile order of build_assignment, ran within 1.3% of it
//   (tools/kernel_variants.py keeps both as variants).
//
// What limits it now: at the encoder raster, batch 4, bf16, 63% of the
// corners lie in the map, 1.48 GB of corner rows, which stream at ~5.3 TB/s
// (tools/kernel_variants.py, corner_gbps). The time moves with occupancy
// but hardly with the loads in flight (4 or 16 a lane) or the query order.
// That suggested, with no counter to confirm it, that the rate at which L1
// and L2 return 64-byte rows sets it. Staging each level's window in
// shared memory by TMA, as the TPU kernel keeps it in VMEM, cut the rows
// taken from L2 by two thirds and ran slower (the k1_staged variant):
// L2's row rate is not what limits this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;  // blocks per SM the registers must allow

struct Levels {
  int h[kMaxLevels];
  int w[kMaxLevels];
  int start[kMaxLevels];
  int w3[kMaxLevels];
};

// A lane's chunk of a row: BYTES bytes = BYTES / sizeof(T) channels.
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <typename T, int BYTES> struct Chunk;

template <> struct Chunk<float, 16> {
  static constexpr int N = 4;
  static __device__ void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z); f[3] = __uint_as_float(r.w);
  }
  static __device__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Chunk<float, 8> {
  static constexpr int N = 2;
  static __device__ void unpack(uint2 r, float* f) {
    f[0] = __uint_as_float(r.x); f[1] = __uint_as_float(r.y);
  }
  static __device__ uint2 pack(const float* f) {
    return make_uint2(__float_as_uint(f[0]), __float_as_uint(f[1]));
  }
};
template <> struct Chunk<float, 4> {
  static constexpr int N = 1;
  static __device__ void unpack(unsigned r, float* f) { f[0] = __uint_as_float(r); }
  static __device__ unsigned pack(const float* f) { return __float_as_uint(f[0]); }
};
template <> struct Chunk<__nv_bfloat16, 16> {
  static constexpr int N = 8;
  static __device__ void unpack(uint4 r, float* f) {
    f[0] = lo_bf16(r.x); f[1] = hi_bf16(r.x); f[2] = lo_bf16(r.y); f[3] = hi_bf16(r.y);
    f[4] = lo_bf16(r.z); f[5] = hi_bf16(r.z); f[6] = lo_bf16(r.w); f[7] = hi_bf16(r.w);
  }
  static __device__ uint4 pack(const float* f) {
    return make_uint4(bf16_bits(f[0]) | bf16_bits(f[1]) << 16,
                      bf16_bits(f[2]) | bf16_bits(f[3]) << 16,
                      bf16_bits(f[4]) | bf16_bits(f[5]) << 16,
                      bf16_bits(f[6]) | bf16_bits(f[7]) << 16);
  }
};
template <> struct Chunk<__nv_bfloat16, 8> {
  static constexpr int N = 4;
  static __device__ void unpack(uint2 r, float* f) {
    f[0] = lo_bf16(r.x); f[1] = hi_bf16(r.x); f[2] = lo_bf16(r.y); f[3] = hi_bf16(r.y);
  }
  static __device__ uint2 pack(const float* f) {
    return make_uint2(bf16_bits(f[0]) | bf16_bits(f[1]) << 16,
                      bf16_bits(f[2]) | bf16_bits(f[3]) << 16);
  }
};
template <> struct Chunk<__nv_bfloat16, 4> {
  static constexpr int N = 2;
  static __device__ void unpack(unsigned r, float* f) { f[0] = lo_bf16(r); f[1] = hi_bf16(r); }
  static __device__ unsigned pack(const float* f) {
    return bf16_bits(f[0]) | bf16_bits(f[1]) << 16;
  }
};
template <> struct Chunk<__nv_bfloat16, 2> {
  static constexpr int N = 1;
  static __device__ void unpack(unsigned short r, float* f) {
    f[0] = __uint_as_float((unsigned)r << 16);
  }
  static __device__ unsigned short pack(const float* f) { return (unsigned short)bf16_bits(f[0]); }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// PB consecutive points' locations (x, y) and weights. PB == 4 takes vector
// loads (the launcher checks their alignment); otherwise scalars.
template <typename T, int PB>
__device__ __forceinline__ void load_points(const float* loc, const T* a, float* lx, float* ly,
                                            float* wt) {
  if constexpr (PB == 4) {
    const float4 l0 = __ldg(reinterpret_cast<const float4*>(loc));
    const float4 l1 = __ldg(reinterpret_cast<const float4*>(loc) + 1);
    lx[0] = l0.x; ly[0] = l0.y; lx[1] = l0.z; ly[1] = l0.w;
    lx[2] = l1.x; ly[2] = l1.y; lx[3] = l1.z; ly[3] = l1.w;
    if constexpr (sizeof(T) == 4) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(a));
      wt[0] = w.x; wt[1] = w.y; wt[2] = w.z; wt[3] = w.w;
    } else {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(a));
      wt[0] = lo_bf16(w.x); wt[1] = hi_bf16(w.x); wt[2] = lo_bf16(w.y); wt[3] = hi_bf16(w.y);
    }
  } else {
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      lx[p] = __ldg(loc + 2 * p);
      ly[p] = __ldg(loc + 2 * p + 1);
      wt[p] = to_f(a[p]);
    }
  }
}

// One point's four corners: element offsets of their rows from the level's
// base (-1 where the corner reads 0) and weights (bilinear x attention),
// rounded as the plain version rounds the cell coordinates. In clamp mode
// the sample is first clamped into its window [origin, origin + w3 - 2]:
// clamping picks one of its operands, so a sample inside keeps its
// coordinates and the two modes agree bit for bit where nothing clamps,
// and one beyond lands on the edge, a whole cell.
__device__ __forceinline__ void corners(float lx, float ly, float wgt, int hh, int ww, int w3,
                                        int oy, int ox, int row_stride, int* off, float* cw) {
  const float gx = __fsub_rn(__fmul_rn(lx, (float)ww), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(ly, (float)hh), 0.5f);
  int x0, y0;
  float fx, fy;
  bool live = true;
  if (w3 > 0) {
    live = gy > -1.f && gy < (float)hh && gx > -1.f && gx < (float)ww;
    const float cy = fminf(fmaxf(gy, (float)oy), (float)(oy + w3 - 2));
    const float cx = fminf(fmaxf(gx, (float)ox), (float)(ox + w3 - 2));
    const float y0f = floorf(cy), x0f = floorf(cx);
    fy = __fsub_rn(cy, y0f);
    fx = __fsub_rn(cx, x0f);
    y0 = (int)y0f;
    x0 = (int)x0f;
  } else {
    const float y0f = floorf(gy), x0f = floorf(gx);
    fy = __fsub_rn(gy, y0f);
    fx = __fsub_rn(gx, x0f);
    y0 = (int)fminf(fmaxf(y0f, -2.f), (float)(hh + 1));
    x0 = (int)fminf(fmaxf(x0f, -2.f), (float)(ww + 1));
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int dy = c >> 1, dx = c & 1;
    const int yy = y0 + dy, xx = x0 + dx;
    const bool in = live && yy >= 0 && yy < hh && xx >= 0 && xx < ww;
    off[c] = in ? (yy * ww + xx) * row_stride : -1;
    cw[c] = in ? (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx) * wgt : 0.f;
  }
}

// T: value type; BYTES: chunk size; NCH: chunks a lane owns; LT, PT: levels
// and points (0: given at run time).
template <typename T, int BYTES, int NCH, int LT, int PT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) ms_deform_sample_kernel(
    const T* __restrict__ value, const float* __restrict__ locs, const T* __restrict__ aw,
    const int* __restrict__ origin, T* __restrict__ out, int B, int S, int Q, int H, int D,
    int L, int P, int lanes, int chunks, Levels lv) {
  using C = Chunk<T, BYTES>;
  using R = typename Raw<BYTES>::type;
  constexpr int E = C::N;
  constexpr int PB = PT > 0 ? PT : 1;  // points in flight
  const int NL = LT > 0 ? LT : L, NP = PT > 0 ? PT : P;

  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = t / lanes;
  const int lane = (int)(t - r * lanes);
  if (r >= (long long)B * Q * H) return;
  const int h = (int)(r % H);
  const int q = (int)(r / H % Q);
  const int b = (int)(r / H / Q);
  const long long row = r;  // (b * Q + q) * H + h
  const float* loc = locs + row * NL * NP * 2;
  const T* a = aw + row * NL * NP;
  const int row_stride = H * D;
  const T* vb = value + (long long)b * S * row_stride + h * D;

  int ch[NCH];  // element offset of each owned chunk in the row, -1 if none
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    const int c = lane + lanes * k;
    ch[k] = c < chunks ? c * E : -1;
  }
  float acc[NCH][E];
#pragma unroll
  for (int k = 0; k < NCH; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[k][e] = 0.f;

#pragma unroll
  for (int l = 0; l < (LT > 0 ? LT : kMaxLevels); ++l) {
    if (LT == 0 && l >= NL) break;
    const int hh = lv.h[l], ww = lv.w[l], w3 = lv.w3[l];
    int oy = 0, ox = 0;
    if (w3 > 0) {
      const int2 o = __ldg(reinterpret_cast<const int2*>(origin) + (long long)l * Q + q);
      oy = o.x;
      ox = o.y;
    }
    const T* vl = vb + (long long)lv.start[l] * row_stride;
#pragma unroll 1
    for (int p0 = 0; p0 < NP; p0 += PB) {
      float lx[PB], ly[PB], wt[PB];
      load_points<T, PB>(loc + (l * NP + p0) * 2, a + l * NP + p0, lx, ly, wt);
      int off[PB][4];
      float cw[PB][4];
#pragma unroll
      for (int p = 0; p < PB; ++p)
        corners(lx[p], ly[p], wt[p], hh, ww, w3, oy, ox, row_stride, off[p], cw[p]);
      R raw[PB][4][NCH];
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            raw[p][c][k] = R{};
            if (off[p][c] >= 0 && ch[k] >= 0)
              raw[p][c][k] = __ldg(reinterpret_cast<const R*>(vl + off[p][c] + ch[k]));
          }
#pragma unroll
      for (int p = 0; p < PB; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < NCH; ++k) {
            float f[E];
            C::unpack(raw[p][c][k], f);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[k][e] = fmaf(cw[p][c], f[e], acc[k][e]);
          }
    }
  }
  T* o = out + row * D;
#pragma unroll
  for (int k = 0; k < NCH; ++k)
    if (ch[k] >= 0) *reinterpret_cast<R*>(o + ch[k]) = C::pack(acc[k]);
}

struct Args {
  const void *value, *locs, *aw, *origin;
  void* out;
  int B, S, Q, H, D, L, P;
  Levels lv;
  cudaStream_t stream;
};

template <typename T, int BYTES, int NCH, int LT, int PT>
int launch(const Args& g) {
  const int chunks = g.D * (int)sizeof(T) / BYTES;
  const int lanes = chunks < 32 ? chunks : 32;
  const long long rows = (long long)g.B * g.Q * g.H;
  const long long blocks = (rows * lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  ms_deform_sample_kernel<T, BYTES, NCH, LT, PT><<<(unsigned)blocks, kThreads, 0, g.stream>>>(
      static_cast<const T*>(g.value), static_cast<const float*>(g.locs),
      static_cast<const T*>(g.aw), static_cast<const int*>(g.origin), static_cast<T*>(g.out),
      g.B, g.S, g.Q, g.H, g.D, g.L, g.P, lanes, chunks, g.lv);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& g) {
  const int es = (int)sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(g.value) | reinterpret_cast<uintptr_t>(g.out);
  int bytes = 16;
  while (bytes > es && ((g.D * es) % bytes != 0 || base % bytes != 0)) bytes /= 2;
  if (bytes == 16) {
    // the unrolled (L, P) read a level's points as vectors: 16-byte aligned
    // locations, 4 * size-aligned weights
    const bool vec = reinterpret_cast<uintptr_t>(g.locs) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(g.aw) % (4 * es) == 0;
    if (vec && g.L == 4 && g.P == 4) return launch<T, 16, 1, 4, 4>(g);
    if (vec && g.L == 3 && g.P == 4) return launch<T, 16, 1, 3, 4>(g);
    return launch<T, 16, 1, 0, 0>(g);
  }
  if (bytes == 8) return launch<T, 8, 4, 0, 0>(g);
  if (bytes == 4) return launch<T, 4, 4, 0, 0>(g);
  if constexpr (sizeof(T) == 2) return launch<T, 2, 4, 0, 0>(g);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (value, aw and out share it; locs are f32).
// levels: host array of L rows (h, w, start, w3). origin: device int32
// (L, Q, 2) window origins, read only for levels with w3 > 0 (may be null
// when every level is exact). Returns cudaGetLastError() after the launch,
// or -1 for arguments the kernel does not take.
extern "C" int bff_ms_deform_sample(int dtype, const void* value, const void* locs,
                                    const void* aw, const void* origin, void* out, int B, int S,
                                    int Q, int H, int D, int L, int P, const int* levels,
                                    void* stream) {
  if (L < 1 || L > kMaxLevels || P < 0 || D < 1 || D > 128 ||
      (long long)S * H * D >= (1LL << 31))
    return -1;
  Args g{value, locs, aw, origin, out, B, S, Q, H, D, L, P, {},
         static_cast<cudaStream_t>(stream)};
  for (int l = 0; l < L; ++l) {
    g.lv.h[l] = levels[4 * l];
    g.lv.w[l] = levels[4 * l + 1];
    g.lv.start[l] = levels[4 * l + 2];
    g.lv.w3[l] = levels[4 * l + 3];
    if (g.lv.w3[l] > 0 && origin == nullptr) return -1;
  }
  if ((long long)B * Q * H == 0) return 0;
  if (dtype == 0) return dispatch<float>(g);
  if (dtype == 1) return dispatch<__nv_bfloat16>(g);
  return -1;
}
