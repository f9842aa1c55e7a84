// Attention with SAM's decomposed relative-position bias on Hopper (sm_90a),
// CUDA C++. Two kernels share the score tile and the bias lookup:
//
// * bff_flash_attention_relpos replaces the TPU kernel
//   beyondff_tpu/kernels/flash_attention.py flash_attention_relpos (body
//   _relpos_kernel, wrapper attend_relpos): softmax(Q K^T * scale + bias) V
//   over a raster-ordered (kh, kw) key grid with an online max and
//   denominator, the (S, S) scores never in device memory. SAM ViT-H's global
//   blocks: (16 B, 4096, 80).
// * bff_window_attention_relpos replaces the TPU kernel
//   beyondff_tpu/kernels/window_attention.py window_attention_relpos: the
//   same function over G independent windows of S = wh * ww tokens, with a
//   plain (not online) softmax over each window's keys. SAM ViT-H's windowed
//   blocks: (25 * 16 B, 196, 80).
//
// bias[q, k] = bias_h[q, k / kw] + bias_w[q, k % kw]. The TPU kernels rebuild
// the (BQ, BKV) bias with a one-hot selector matmul because Mosaic has no
// gather; here each block loads its query tile's thin factors (64 x (kh + kw))
// into shared memory once and indexes them per score. Factors arrive in the
// inputs' dtype and are added in f32, as the TPU kernels' f32-accumulated
// selector products add them.
//
// Layout: one block of 256 threads per (bh or window, 64-query tile); K and V
// go through shared memory in 64-key tiles as f32 (rows padded by one against
// bank conflicts). The flash kernel keeps each row's running max and
// denominator in registers (K2's scheme, csrc/flash_attention.cu); the window
// kernel keeps the whole (64, S) score tile of its window in shared memory
// and normalises it in one pass. Ragged query rows and keys are masked; the
// head dim is a template bound DP in {32, 64, 80, 128} (80 is SAM ViT-H's),
// features D..DP read as zero.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the global blocks at
// B = 4, (64, 4096, 80) bf16, do 4 * 64 * 4096^2 * 80 = 3.4e11 operations
// (0.35 ms) and move about 235 MB (0.07 ms): bound by operations. The
// windowed blocks at B = 4, (1600, 196, 80), do 2.0e10 operations (0.02 ms)
// and move about 218 MB (0.065 ms): bound by bytes. This first version
// computes both products with f32 FMAs from shared memory (67 TFLOP/s f32
// peak), no tensor cores; mma.sync / wgmma on bf16 tiles is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [r0, r0 + 64) of a row-major (S, D) matrix into shared memory as f32
// with row stride ld; rows >= S and features >= D read as zero.
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* __restrict__ src,
                                          int r0, int S, int D) {
  for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP, gr = r0 + r;
    dst[r * ld + c] = (gr < S && c < D) ? to_f(src[(long long)gr * D + c]) : 0.f;
  }
}

// The query tile's factors as one (64, kh + kw) f32 table: columns [0, kh)
// from bias_h (S, kh), [kh, kh + kw) from bias_w (S, kw).
template <typename T>
__device__ __forceinline__ void load_factors(float* dst, const T* __restrict__ bh,
                                             const T* __restrict__ bw, int q0, int S,
                                             int kh, int kw) {
  const int nf = kh + kw;
  for (int i = threadIdx.x; i < kBQ * nf; i += kThreads) {
    const int r = i / nf, c = i % nf, gr = q0 + r;
    float x = 0.f;
    if (gr < S) x = c < kh ? to_f(bh[(long long)gr * kh + c]) : to_f(bw[(long long)gr * kw + c - kh]);
    dst[i] = x;
  }
}

__device__ __forceinline__ float bias_at(const float* sF, int row, int key, int kh, int kw) {
  const int ky = key / kw;
  const float* f = sF + row * (kh + kw);
  return f[ky] + f[kh + key - ky * kw];
}

// s[i][j] = Q[ty * 4 + i] . K[tx + 16 j] over DP features (both tiles f32
// in shared memory with row stride ld).
template <int DP>
__device__ __forceinline__ void score_tile(const float* sQ, const float* sK, int ld, int ty,
                                           int tx, float s[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

// ------------------------------------------------------------ K4: flash
template <int DP>
int flash_smem_bytes(int nf) {
  return (kBQ * (DP + 1) + kBK * (DP + 1) + kBK * DP + kBQ * (kBK + 1) + kBQ * nf) *
         (int)sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_relpos_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bh, const T* __restrict__ bw, T* __restrict__ o, int S, int D,
    int kh, int kw, float scale) {
  constexpr int LD = DP + 1;
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * DP;
  float* sF = sP + kBQ * LP;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const long long base = (long long)blockIdx.y * S * D;
  const T* kb = k + base;
  const T* vb = v + base;
  load_rows<T, DP>(sQ, LD, q + base, q0, S, D);
  load_factors<T>(sF, bh + (long long)blockIdx.y * S * kh, bw + (long long)blockIdx.y * S * kw,
                  q0, S, kh, kw);

  const int ty = tid / 16, tx = tid % 16;
  const int row = tid / 4, part = tid % 4;
  float m = kNegInf, l = 0.f;
  float acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;

  const int n_tiles = (S + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's sK, sV and sP are no longer read
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int r = i / DP, c = i % DP, gr = k0 + r;
      const bool in = gr < S && c < D;
      sK[r * LD + c] = in ? to_f(kb[(long long)gr * D + c]) : 0.f;
      sV[r * DP + c] = in ? to_f(vb[(long long)gr * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
    score_tile<DP>(sQ, sK, LD, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, col = tx + 16 * j, key = k0 + col;
        sP[r * LP + col] = key < S ? s[i][j] * scale + bias_at(sF, r, key, kh, kw) : kNegInf;
      }
    __syncthreads();

    float* prow = sP + row * LP + part * (kBK / 4);
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) mx = fmaxf(mx, prow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int c = 0; c < kBK / 4; ++c) {
      const float p = expf(prow[c] - m_new);
      prow[c] = p;
      ls += p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * corr + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) acc[i] *= corr;
    __syncthreads();  // whole rows of P are written

    const float* pr = sP + row * LP;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = pr[kk];
      const float* vr = sV + kk * DP + part;
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
    }
  }

  const int gr = q0 + row;
  if (gr < S) {
    const float inv = 1.f / l;
    T* orow = o + base + (long long)gr * D;
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int c = part + 4 * i;
      if (c < D) orow[c] = from_f<T>(acc[i] * inv);
    }
  }
}

// ------------------------------------------------------------ K5: windows
template <int DP>
int window_smem_bytes(int S, int nf) {
  const int ls = (S + kBK - 1) / kBK * kBK + 1;
  return (kBQ * (DP + 1) + kBK * (DP + 1) + kBQ * nf + kBQ * ls) * (int)sizeof(float);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) window_relpos_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ bh, const T* __restrict__ bw, T* __restrict__ o, int S, int D,
    int wh, int ww, float scale) {
  constexpr int LD = DP + 1;
  const int n_tiles = (S + kBK - 1) / kBK;
  const int LS = n_tiles * kBK + 1;
  const int nf = wh + ww;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sKV = sQ + kBQ * LD;  // a K tile, later a V tile
  float* sF = sKV + kBK * LD;
  float* sS = sF + kBQ * nf;   // the (64, S) scores, then probabilities

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const long long base = (long long)blockIdx.y * S * D;
  load_rows<T, DP>(sQ, LD, q + base, q0, S, D);
  load_factors<T>(sF, bh + (long long)blockIdx.y * S * wh, bw + (long long)blockIdx.y * S * ww,
                  q0, S, wh, ww);

  const int ty = tid / 16, tx = tid % 16;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // sQ and sF are written; the previous K tile is no longer read
    load_rows<T, DP>(sKV, LD, k + base, k0, S, D);
    __syncthreads();
    float s[4][4];
    score_tile<DP>(sQ, sKV, LD, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty * 4 + i, key = k0 + tx + 16 * j;
        if (key < S) sS[r * LS + key] = s[i][j] * scale + bias_at(sF, r, key, wh, ww);
      }
  }
  __syncthreads();

  // a plain softmax of each row over the window's S keys; the four threads
  // of a row are adjacent lanes of one warp
  const int row = tid / 4, part = tid % 4;
  float* srow = sS + row * LS;
  float mx = kNegInf;
  for (int c = part; c < S; c += 4) mx = fmaxf(mx, srow[c]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float l = 0.f;
  for (int c = part; c < S; c += 4) {
    const float p = expf(srow[c] - mx);
    srow[c] = p;
    l += p;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  float acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // P is whole; the previous V tile is no longer read
    load_rows<T, DP>(sKV, LD, v + base, k0, S, D);
    __syncthreads();
    const int kn = min(kBK, S - k0);
    for (int kk = 0; kk < kn; ++kk) {
      const float p = srow[k0 + kk];
      const float* vr = sKV + kk * LD + part;
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
    }
  }

  const int gr = q0 + row;
  if (gr < S) {
    const float inv = 1.f / l;
    T* orow = o + base + (long long)gr * D;
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int c = part + 4 * i;
      if (c < D) orow[c] = from_f<T>(acc[i] * inv);
    }
  }
}

// Raises a kernel's dynamic shared memory limit to at least ``bytes`` once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int* configured) {
  if (bytes <= *configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *configured = bytes;
  return err;
}

template <typename T, int DP>
int launch_flash(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                 void* o, int BH, int S, int D, int kh, int kw, float scale,
                 cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int bytes = flash_smem_bytes<DP>(kh + kw);
  cudaError_t err = allow_smem(flash_relpos_kernel<T, DP>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_relpos_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bh), static_cast<const T*>(bw), static_cast<T*>(o), S, D, kh, kw,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_window(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                  void* o, int G, int S, int D, int wh, int ww, float scale,
                  cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int bytes = window_smem_bytes<DP>(S, wh + ww);
  cudaError_t err = allow_smem(window_relpos_kernel<T, DP>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, G);
  window_relpos_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bh), static_cast<const T*>(bw), static_cast<T*>(o), S, D, wh, ww,
      scale);
  return (int)cudaGetLastError();
}

#define BFF_BY_HEAD_DIM(FN, T, ...)                                 \
  (D <= 32 ? FN<T, 32>(__VA_ARGS__)                                 \
   : D <= 64 ? FN<T, 64>(__VA_ARGS__)                               \
   : D <= 80 ? FN<T, 80>(__VA_ARGS__)                               \
             : FN<T, 128>(__VA_ARGS__))

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous (BH, S, D) with
// S = kh * kw and kh + kw <= 256; bias_h: (BH, S, kh), bias_w: (BH, S, kw),
// in q's dtype.
// Returns cudaGetLastError() after the launch, or -1 for arguments the
// kernel does not take.
extern "C" int bff_flash_attention_relpos(int dtype, const void* q, const void* k, const void* v,
                                          const void* bias_h, const void* bias_w, void* o,
                                          int BH, int S, int D, int kh, int kw, float scale,
                                          void* stream) {
  if (BH < 1 || S < 1 || D < 1 || D > 128 || kh < 1 || kw < 1 || kh * kw != S ||
      kh + kw > 256)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return BFF_BY_HEAD_DIM(launch_flash, float, q, k, v, bias_h, bias_w, o, BH, S, D, kh, kw,
                           scale, s);
  if (dtype == 1)
    return BFF_BY_HEAD_DIM(launch_flash, __nv_bfloat16, q, k, v, bias_h, bias_w, o, BH, S, D,
                           kh, kw, scale, s);
  return -1;
}

// dtype as above. q, k, v, o: contiguous (G, S, D) with S = wh * ww <= 256;
// bias_h: (G, S, wh), bias_w: (G, S, ww), in q's dtype.
extern "C" int bff_window_attention_relpos(int dtype, const void* q, const void* k,
                                           const void* v, const void* bias_h,
                                           const void* bias_w, void* o, int G, int S, int D,
                                           int wh, int ww, float scale, void* stream) {
  if (G < 1 || S < 1 || S > 256 || D < 1 || D > 128 || wh < 1 || ww < 1 || wh * ww != S)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return BFF_BY_HEAD_DIM(launch_window, float, q, k, v, bias_h, bias_w, o, G, S, D, wh, ww,
                           scale, s);
  if (dtype == 1)
    return BFF_BY_HEAD_DIM(launch_window, __nv_bfloat16, q, k, v, bias_h, bias_w, o, G, S, D,
                           wh, ww, scale, s);
  return -1;
}
