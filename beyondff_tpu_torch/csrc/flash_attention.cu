// Flash attention on Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels beyondff_tpu/kernels/flash_attention.py
// _flash_masked (keys >= valid_len masked, reached through attend) and
// flash_attention (the same function with valid_len = S): softmax(Q K^T *
// scale) V with an online max and denominator, the (S, S) score matrix never
// written to device memory.
//
// Layout: one block of 256 threads per (bh, 64-query tile). The block walks
// 64-key tiles of K and V through shared memory (f32, rows padded by one to
// keep the Q K^T reads free of bank conflicts), keeps the running max and
// denominator of each query row in f32 registers, and masks keys >= valid_len
// (tiles wholly past valid_len are skipped). Unlike the TPU kernel it pads
// neither the head dim to 128 (a TPU lane constraint) nor S beyond the 64-row
// tiling: ragged rows and keys are masked in the kernel. The head dim is a
// template bound DP in {32, 64, 128}; features D..DP read as zero. The scale
// is the caller's, d ** -0.5 of the true head dim.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the Grounding-DINO
// decoder's shape (8 x 900 x 32, bf16) the function moves 1.8 MB (~0.6 us)
// and does 4*8*900*900*32 = 0.83 GFLOP (~0.8 us on the tensor cores), so it
// is bound by operations. This first version computes both products with
// plain f32 FMAs from shared memory (67 TFLOP/s f32 peak, ~12 us floor), no
// tensor cores; mma.sync / wgmma and a K/V double buffer are later work.

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

template <int DP>
constexpr int smem_floats() {
  return kBQ * (DP + 1) + kBK * (DP + 1) + kBK * DP + kBQ * (kBK + 1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int D, int valid_len, float scale) {
  constexpr int LD = DP + 1;
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * DP;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const long long base = (long long)blockIdx.y * S * D;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, c = i % DP, gr = q0 + r;
    sQ[r * LD + c] = (gr < S && c < D) ? to_f(qb[(long long)gr * D + c]) : 0.f;
  }

  // Q K^T tile: thread (ty, tx) owns rows ty*4 + i and columns tx + 16*j.
  const int ty = tid / 16, tx = tid % 16;
  // softmax and P V: thread (row, part) owns columns part + 4*i of its row;
  // the four threads of a row are adjacent lanes of one warp.
  const int row = tid / 4, part = tid % 4;
  float m = kNegInf, l = 0.f;
  float acc[DP / 4];
#pragma unroll
  for (int i = 0; i < DP / 4; ++i) acc[i] = 0.f;

  const int n_tiles = (valid_len + kBK - 1) / kBK;
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        sP[(ty * 4 + i) * LP + col] = (k0 + col < valid_len) ? s[i][j] * scale : kNegInf;
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

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
           int valid_len, float scale, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DP>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, DP><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, D, valid_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
             int valid_len, float scale, cudaStream_t stream) {
  if (D <= 32) return launch<T, 32>(q, k, v, o, BH, S, D, valid_len, scale, stream);
  if (D <= 64) return launch<T, 64>(q, k, v, o, BH, S, D, valid_len, scale, stream);
  return launch<T, 128>(q, k, v, o, BH, S, D, valid_len, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous (BH, S, D).
// Returns cudaGetLastError() after the launch, or -1 for arguments the
// kernel does not take.
extern "C" int bff_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int BH, int S, int D, int valid_len, float scale,
                                   void* stream) {
  if (BH < 1 || S < 1 || D < 1 || D > 128 || valid_len < 1 || valid_len > S) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, BH, S, D, valid_len, scale, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, BH, S, D, valid_len, scale, s);
  return -1;
}
