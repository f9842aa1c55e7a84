// Flash attention on Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels beyondff_tpu/kernels/flash_attention.py
// _flash_masked (keys >= valid_len masked, reached through attend) and
// flash_attention (the same function with valid_len = S): softmax(Q K^T *
// scale) V with an online max and denominator, the (S, S) score matrix never
// written to device memory. The scale is the caller's, d ** -0.5 of the true
// head dim. Unlike the TPU kernel it pads neither the head dim to 128 (a TPU
// lane constraint) nor S beyond the 64-row tiling: ragged rows and keys are
// masked in the kernel, and key tiles wholly past valid_len are skipped.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): at the Grounding-DINO
// decoder's shape (8 B x 900 x 32, bf16) the function moves 1.8 MB per frame
// (~0.6 us) and does 4*8*900*900*32 = 0.83 GFLOP (~0.8 us on the tensor
// cores), so it is bound by operations.
//
// Five kernels, chosen inside bff_flash_attention:
// * bf16 at head dim 64 with every key valid (K3 on the main path:
//   EfficientSAM-S's global blocks), exactly where bff_flash_wgmma_takes
//   says so: the wgmma/TMA kernel of csrc/flash_attention_wgmma.cu.
// * bf16 at head dim 32 with up to 1536 valid keys (K2 on the main path: the
//   Grounding-DINO decoder's self-attention, (32, 900, 32) at the batch of
//   4), exactly where bff_flash_masked_wgmma_takes says so: the wgmma/TMA
//   kernel of csrc/flash_masked_wgmma.cu.
// * other bf16: flash_tc_kernel, the tensor-core block of
//   csrc/attention_tc.cuh (mma.sync m16n8k16 bf16 -> f32 for Q K^T and P V,
//   scores and P in registers, K/V tiles bf16 in a 2-stage cp.async ring)
//   with a key mask as its score modifier. D is padded to DP in {32, 64,
//   80, 128} in shared memory only. 4 warps of 16 query rows a block (a
//   64-query tile): 25 600 B of shared memory at DP = 32 and about 100
//   registers a thread, so four blocks share an SM. It ran K2 until the
//   wgmma kernel took it: at (32, 900, 32) its grid is 15 x 32 = 480 blocks
//   walking 15 key tiles each, under one wave, so the time is the latency of
//   one block's 15 steps, not a bandwidth. bf16 inputs with D % 8 != 0 or
//   bases off 16 bytes (no 16-byte cp.async rows) take the f32-FMA kernel
//   below.
// * f32 at head dim 32 or 64 (K2 and K3 in detector.dtype float32), and at 96
//   and 128, which no configured model calls, exactly
//   where bff_flash_tf32_takes says so: the 3xTF32 wgmma/TMA kernel of
//   csrc/flash_attention_tf32.cu. One TF32 product would not hold the 1e-4
//   the f32 calls are held to; three (hi hi + hi lo + lo hi, each operand
//   split into two TF32 words) keep about 22 bits at 165 TFLOP/s of
//   f32-grade work against the 67 TFLOP/s of f32 FMAs. It needs scratch
//   from the caller (bff_flash_tf32_scratch_floats).
// * other f32: flash_fwd_kernel, one block of 256 threads per (bh, 64-query
//   tile), K and V through shared memory as f32 (rows padded by one against
//   bank conflicts), both products as plain f32 FMAs (67 TFLOP/s f32 peak).
//   Head dim bound DP in {32, 64, 128}; features D..DP read as zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"

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

constexpr int kTcWarps = 4, kTcMT = 1;  // 4 warps x 1 m16 tile: a 64-query tile
constexpr int kTcRows = 16 * kTcWarps * kTcMT;

template <int DP>
__global__ void __launch_bounds__(32 * kTcWarps) flash_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S, int D,
    int valid_len, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const long long base = (long long)blockIdx.y * S * D;
  bff_tc::KeyMask mod{valid_len};
  bff_tc::attend_block<DP, kTcWarps, kTcMT>(q + base, k + base, v + base, o + base,
                                            blockIdx.x * kTcRows, S, D,
                                            (valid_len + bff_tc::kBK - 1) / bff_tc::kBK, scale,
                                            mod, reinterpret_cast<__nv_bfloat16*>(tc_smem));
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
              int valid_len, float scale, cudaStream_t stream) {
  static int configured = 48 * 1024;
  constexpr int bytes = bff_tc::smem_bytes<DP, kTcRows>();
  cudaError_t err = bff_tc::allow_smem(flash_tc_kernel<DP>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTcRows - 1) / kTcRows, BH);
  flash_tc_kernel<DP><<<grid, 32 * kTcWarps, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, D, valid_len,
      scale);
  return (int)cudaGetLastError();
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o, int BH, int S, int D,
                int valid_len, float scale, cudaStream_t stream) {
  if (D <= 32) return launch_tc<32>(q, k, v, o, BH, S, D, valid_len, scale, stream);
  if (D <= 64) return launch_tc<64>(q, k, v, o, BH, S, D, valid_len, scale, stream);
  if (D <= 80) return launch_tc<80>(q, k, v, o, BH, S, D, valid_len, scale, stream);
  return launch_tc<128>(q, k, v, o, BH, S, D, valid_len, scale, stream);
}

}  // namespace

// csrc/flash_attention_wgmma.cu
extern "C" int bff_flash_wgmma_takes(int dtype, int D, int S, int valid_len, float scale,
                                     const void* q, const void* k, const void* v, const void* o);
extern "C" int bff_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                         int BH, int S, float scale, void* stream);
// csrc/flash_masked_wgmma.cu
extern "C" int bff_flash_masked_wgmma_takes(int dtype, int D, int S, int valid_len, float scale,
                                            const void* q, const void* k, const void* v,
                                            const void* o);
extern "C" int bff_flash_masked_wgmma(const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int valid_len, float scale, void* stream);
// csrc/flash_attention_tf32.cu
extern "C" int bff_flash_tf32_takes(int dtype, int D, int S, int valid_len, float scale,
                                    const void* q, const void* k, const void* v, const void* o);
extern "C" int bff_flash_attention_tf32(const void* q, const void* k, const void* v, void* o,
                                        void* scratch, int BH, int S, int D, int valid_len,
                                        float scale, void* stream);

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous (BH, S, D);
// scratch: what the 3xTF32 kernel needs where bff_flash_tf32_takes the call
// (bff_flash_tf32_scratch_floats floats), else unread. Returns
// cudaGetLastError() after the launch, or -1 for arguments the kernel does
// not take.
extern "C" int bff_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* o, int BH, int S, int D, int valid_len, float scale,
                                   void* stream, void* scratch) {
  if (BH < 1 || S < 1 || D < 1 || D > 128 || valid_len < 1 || valid_len > S) return -1;
  if (bff_flash_wgmma_takes(dtype, D, S, valid_len, scale, q, k, v, o))
    return bff_flash_attention_wgmma(q, k, v, o, BH, S, scale, stream);
  if (bff_flash_masked_wgmma_takes(dtype, D, S, valid_len, scale, q, k, v, o))
    return bff_flash_masked_wgmma(q, k, v, o, BH, S, valid_len, scale, stream);
  if (bff_flash_tf32_takes(dtype, D, S, valid_len, scale, q, k, v, o))
    return bff_flash_attention_tf32(q, k, v, o, scratch, BH, S, D, valid_len, scale, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, BH, S, D, valid_len, scale, s);
  if (dtype == 1) {
    if (bff_tc::tile_takes(D, q, k, v, o))
      return dispatch_tc(q, k, v, o, BH, S, D, valid_len, scale, s);
    return dispatch<__nv_bfloat16>(q, k, v, o, BH, S, D, valid_len, scale, s);
  }
  return -1;
}

// f32 on the FMA kernel (flash_fwd_kernel<float>) whatever
// bff_flash_tf32_takes says: the yardstick that chip_smoke.py and
// tools/kernel_variants.py time beside the 3xTF32 kernel on the same call.
// No wrapper calls it. Arguments and return codes as bff_flash_attention's,
// f32 only.
extern "C" int bff_flash_attention_f32_fma(const void* q, const void* k, const void* v, void* o,
                                           int BH, int S, int D, int valid_len, float scale,
                                           void* stream) {
  if (BH < 1 || S < 1 || D < 1 || D > 128 || valid_len < 1 || valid_len > S) return -1;
  return dispatch<float>(q, k, v, o, BH, S, D, valid_len, scale,
                         static_cast<cudaStream_t>(stream));
}
