// Attention with SAM's decomposed relative-position bias on Hopper (sm_90a),
// CUDA C++. Two functions:
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
// into shared memory once. Factors arrive in the inputs' dtype and are added
// in f32, as the TPU kernels' f32-accumulated selector products add them.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): the global blocks at
// B = 4, (64, 4096, 80) bf16, do 4 * 64 * 4096^2 * 80 = 3.4e11 operations
// (0.35 ms) and move about 235 MB (0.07 ms): bound by operations. The
// windowed blocks at B = 4, (1600, 196, 80), do 2.0e10 operations (0.02 ms)
// and move about 218 MB (0.065 ms): bound by bytes.
//
// Routes. bf16 calls at SAM ViT-H's head dim 80 that bff_relpos_wgmma_takes
// accepts go to csrc/relpos_attention_wgmma.cu; f32 calls that
// bff_relpos_tf32_takes accepts (K4 at head dim 64 or 80 with kw = 64, K5
// at 80 on 14 x 14 windows) to the 3xTF32 wgmma kernels of
// csrc/relpos_attention_tf32.cu; the rest to the kernels below.
//
// K4 in bf16 (the SAM path): flash_relpos_tc_kernel, the tensor-core block
// of csrc/attention_tc.cuh (mma.sync m16n8k16 bf16 -> f32 for both
// products, scores and P in registers, K/V bf16 in a 2-stage cp.async
// ring) with the bias as its score modifier, from a bf16 factor table
// appended to the block's shared memory. 4 warps of 2 m16 tiles each (a
// 128-query tile): each K and V fragment a warp reads from shared memory
// feeds 32 query rows, and each K/V tile a block loads serves 128: half
// the shared-memory and L2 bytes per operation of 16-row warps, which is
// what bounds this tile. Where kw % 64 == 0 (SAM's 64 x 64 grid) every key
// tile lies in one grid row: a lane reads its 2 rows x 16 columns of
// bias_w as bf16 pairs and bias_h[q, ky], constant over the tile, shifts
// the row's max instead of every score (GridRowBias: one FMA a score, no
// divide); other grids take WindowBias (below). At DP = 80 and kh + kw =
// 128 a block holds 67 584 + 34 816 = 102 400 B of shared memory and about
// 240 registers a thread, so two blocks share an SM; (64, 4096, 80) is
// 32 x 64 = 2048 blocks of 64 key tiles each. bf16 inputs with D % 8 != 0
// or bases off 16 bytes take the FMA kernels below.
//
// K5 in bf16: window_relpos_tc_kernel, the same tensor-core tile over G
// windows, one (wh, ww) grid each: a window's online softmax over its few
// key tiles equals its plain softmax up to rounding, and the bf16 error
// bound the port holds K4 to (kernels/flash_attention.bf16_error_bound)
// covers both. What bounds it is bytes (SAM ViT-H at B = 4, (1600, 196,
// 80): 218 MB against 2.0e10 operations). The design:
// * WindowBias (attention_tc.cuh) maps each lane's 16 key columns of a
//   tile to (ky, kx) once per tile, shared by its rows and both m16 tiles;
//   with an even ww (SAM's 14) a lane's column pair shares one bias_h read
//   and one 4-byte bias_w read. No divide and no branch per score.
// * S = 196 is three whole key tiles and one of 4 keys: the last runs one
//   k16 step of four in Q K^T and in P V (key_tile's NK = 1 instance). The
//   196 rows are two 128-row items; in the second, the last warp (rows 224
//   on) skips its tiles and the third computes one m16 tile past S, so 224
//   rows of 256 reach the tensor cores: skipping single m16 tiles by
//   branches inside the products, tried first, cost more than the work.
// * Persistent blocks, two per SM, each walking items b, b + grid, ...: the
//   two row blocks of a window are neighbours and run side by side, so the
//   second reads the window's K and V from L2; and at an item's last key
//   tile the block already loads the next item's Q, factor table and first
//   K/V tile (Q and the table double-buffered), so a 4-tile window does not
//   wait on its own prologue. This item loop drives the tile's cp.async ring
//   itself, beside attend_block, which K2/K3 and K4 keep: their items are
//   15-64 key tiles long, where one prologue an item weighs little, and
//   the second Q buffer and table would take the shared memory that lets
//   K4 keep two blocks on an SM. A change to the ring's protocol (slots,
//   waits, barriers) is made in both.
// * Shared memory: 2 Q buffers and the K/V ring, 90 112 B, and 2 factor
//   tables with the least conflict-free stride (40 elements for a 14 x 14
//   window), 20 480 B: 110 592 B a block. 255 registers a thread, no
//   spills (ptxas, DP = 80, even ww): two blocks per SM.
//
// f32 inputs outside bff_relpos_tf32_takes (another head dim or grid, a
// base off 16 bytes), and K5 in bf16 off the tile's alignment: one block of
// 256 threads per (bh or window, 64-query tile); K and V go through shared
// memory in 64-key tiles as f32 (rows padded by one against bank
// conflicts), both products as f32 FMAs (67 TFLOP/s f32 peak; one TF32
// product a product would not hold the 1e-4 bar, three do: the route
// above), the bias looked up per score from an f32 factor table. The flash kernel keeps
// each row's running max and denominator in registers (K2's scheme,
// csrc/flash_attention.cu); the window kernel keeps the whole (64, S) score
// tile of its window in shared memory and normalises it in one pass. Ragged
// query rows and keys are masked; the head dim is a template bound DP in
// {32, 64, 80, 128} (80 is SAM ViT-H's), features D..DP read as zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

using bff_tc::allow_smem;

// ------------------------------------------------------ K4: tensor cores
constexpr int kTcWarps = 4, kTcMT = 2;  // 4 warps x 2 m16 tiles: a 128-query tile
constexpr int kTcRows = 16 * kTcWarps * kTcMT;

// The bias modifier: kw % 64 == 0 (SAM's global grid) takes GridRowBias,
// other grids and K5's windows WindowBias, by pairs where kw is even.
enum BiasKind { kGridRows, kPairs, kSingles };

template <int DP, int kBias>
__global__ void __launch_bounds__(32 * kTcWarps) flash_relpos_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bh,
    const __nv_bfloat16* __restrict__ bw, __nv_bfloat16* __restrict__ o, int S, int D, int kh,
    int kw, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* table =
      reinterpret_cast<__nv_bfloat16*>(tc_smem + bff_tc::smem_bytes<DP, kTcRows>());
  const int q0 = blockIdx.x * kTcRows;
  const long long base = (long long)blockIdx.y * S * D;
  bff_tc::load_factor_table<kTcRows, 32 * kTcWarps>(
      table, bh + (long long)blockIdx.y * S * kh, bw + (long long)blockIdx.y * S * kw, q0, S, kh,
      kw);
  const int n_tiles = (S + bff_tc::kBK - 1) / bff_tc::kBK;
  if constexpr (kBias == kGridRows) {
    const bff_tc::GridRowBias mod{table, kh, kw};
    bff_tc::attend_block<DP, kTcWarps, kTcMT>(q + base, k + base, v + base, o + base, q0, S, D,
                                              n_tiles, scale, mod, smem);
  } else {
    const bff_tc::WindowBias<kBias == kPairs> mod{table, kh, kw, S};
    bff_tc::attend_block<DP, kTcWarps, kTcMT>(q + base, k + base, v + base, o + base, q0, S, D,
                                              n_tiles, scale, mod, smem);
  }
}

template <int DP, int kBias>
int launch_flash_tc(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                    void* o, int BH, int S, int D, int kh, int kw, float scale,
                    cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int bytes = bff_tc::smem_bytes<DP, kTcRows>() +
                    kTcRows * bff_tc::table_ld(kh, kw) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = allow_smem(flash_relpos_tc_kernel<DP, kBias>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTcRows - 1) / kTcRows, BH);
  flash_relpos_tc_kernel<DP, kBias><<<grid, 32 * kTcWarps, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(bh),
      static_cast<const __nv_bfloat16*>(bw), static_cast<__nv_bfloat16*>(o), S, D, kh, kw, scale);
  return (int)cudaGetLastError();
}

// bf16 only; the type parameter fits BFF_BY_HEAD_DIM's shape.
template <typename, int DP>
int launch_flash_tc_grid(const void* q, const void* k, const void* v, const void* bh,
                         const void* bw, void* o, int BH, int S, int D, int kh, int kw,
                         float scale, cudaStream_t stream) {
  if (kw % bff_tc::kBK == 0)
    return launch_flash_tc<DP, kGridRows>(q, k, v, bh, bw, o, BH, S, D, kh, kw, scale, stream);
  if (kw % 2 == 0)
    return launch_flash_tc<DP, kPairs>(q, k, v, bh, bw, o, BH, S, D, kh, kw, scale, stream);
  return launch_flash_tc<DP, kSingles>(q, k, v, bh, bw, o, BH, S, D, kh, kw, scale, stream);
}

// ------------------------------------------------------ K5: tensor cores
template <int DP>
constexpr int window_tc_smem_bytes(int table_elems) {
  return (2 * kTcRows + 4 * bff_tc::kBK) * (DP + 8) * (int)sizeof(__nv_bfloat16) +
         2 * table_elems * (int)sizeof(__nv_bfloat16);
}

template <int DP, bool kPairsW>
__global__ void __launch_bounds__(32 * kTcWarps) window_relpos_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bh,
    const __nv_bfloat16* __restrict__ bw, __nv_bfloat16* __restrict__ o, int G, int S, int D,
    int wh, int ww, float scale) {
  constexpr int LD = DP + 8, kQ = kTcRows * LD, kKV = bff_tc::kBK * LD;
  constexpr int kThreads = 32 * kTcWarps, kBK = bff_tc::kBK;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // 2 Q buffers
  __nv_bfloat16* sK = sQ + 2 * kQ;                                 // K ring of 2
  __nv_bfloat16* sV = sK + 2 * kKV;                                // V ring of 2
  __nv_bfloat16* sT = sV + 2 * kKV;                                // 2 factor tables
  const int tsz = kTcRows * bff_tc::table_ld(wh, ww);
  const int n_rb = (S + kTcRows - 1) / kTcRows, n_items = G * n_rb;
  const int n_tiles = (S + kBK - 1) / kBK;
  const int wrow = (threadIdx.x / 32) * 16 * kTcMT;
  const long long SD = (long long)S * D;

  // item i's Q rows and factor table into buffer b, and its K/V tile 0
  // into ring slot ``slot``
  auto issue_item = [&](int i, int b, int slot) {
    const int g = i / n_rb, q0 = (i % n_rb) * kTcRows;
    bff_tc::load_tile<DP, kTcRows, kThreads>(sQ + b * kQ, q + g * SD, q0, S, D);
    bff_tc::load_factor_table<kTcRows, kThreads>(sT + b * tsz, bh + (long long)g * S * wh,
                                                 bw + (long long)g * S * ww, q0, S, wh, ww);
    bff_tc::load_tile<DP, kBK, kThreads>(sK + slot * kKV, k + g * SD, 0, S, D);
    bff_tc::load_tile<DP, kBK, kThreads>(sV + slot * kKV, v + g * SD, 0, S, D);
  };

  int i = blockIdx.x;
  if (i >= n_items) return;
  issue_item(i, 0, 0);
  bff_tc::cp_async_commit();
  int u = 0;  // key tiles done by the block: ring slot u & 1
  for (int b = 0; i < n_items; i += gridDim.x, b ^= 1) {
    const int g = i / n_rb, q0 = (i % n_rb) * kTcRows, nxt = i + gridDim.x;
    const bff_tc::WindowBias<kPairsW> mod{sT + b * tsz, wh, ww, S};
    const __nv_bfloat16* sQw = sQ + b * kQ + wrow * LD;
    float acc[kTcMT][DP / 8][4];
    float m[kTcMT][2], l[kTcMT][2];
    bff_tc::init_rows<DP, kTcMT>(acc, m, l);
    for (int t = 0; t < n_tiles; ++t, ++u) {
      bff_tc::cp_async_wait<0>();
      __syncthreads();  // tile t landed; every warp is past the step before
      const int slot = (u + 1) & 1;
      if (t + 1 < n_tiles) {
        bff_tc::load_tile<DP, kBK, kThreads>(sK + slot * kKV, k + g * SD, (t + 1) * kBK, S, D);
        bff_tc::load_tile<DP, kBK, kThreads>(sV + slot * kKV, v + g * SD, (t + 1) * kBK, S, D);
      } else if (nxt < n_items) {
        issue_item(nxt, b ^ 1, slot);
      }
      bff_tc::cp_async_commit();
      const __nv_bfloat16* kt = sK + (u & 1) * kKV;
      const __nv_bfloat16* vt = sV + (u & 1) * kKV;
      if (q0 + wrow < S)  // a warp whose rows all lie past S computes nothing
        bff_tc::key_tile<DP, kTcMT>(acc, m, l, sQw, kt, vt, t * kBK, S - t * kBK, wrow, scale,
                                    mod);
    }
    bff_tc::store_rows<DP, kTcMT>(acc, l, o + g * SD, q0 + wrow, S, D);
  }
}

template <int DP, bool kPairsW>
int launch_window_tc_kind(const void* q, const void* k, const void* v, const void* bh,
                          const void* bw, void* o, int G, int S, int D, int wh, int ww,
                          float scale, cudaStream_t stream) {
  static int configured = 48 * 1024, sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int bytes = window_tc_smem_bytes<DP>(kTcRows * bff_tc::table_ld(wh, ww));
  cudaError_t err = allow_smem(window_relpos_tc_kernel<DP, kPairsW>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  const int items = G * ((S + kTcRows - 1) / kTcRows);
  window_relpos_tc_kernel<DP, kPairsW><<<std::min(items, 2 * sms), 32 * kTcWarps, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(bh),
      static_cast<const __nv_bfloat16*>(bw), static_cast<__nv_bfloat16*>(o), G, S, D, wh, ww,
      scale);
  return (int)cudaGetLastError();
}

// bf16 only; the type parameter fits BFF_BY_HEAD_DIM's shape. Two blocks
// per SM, each walking its share of the items.
template <typename, int DP>
int launch_window_tc(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                     void* o, int G, int S, int D, int wh, int ww, float scale,
                     cudaStream_t stream) {
  if (ww % 2 == 0)
    return launch_window_tc_kind<DP, true>(q, k, v, bh, bw, o, G, S, D, wh, ww, scale, stream);
  return launch_window_tc_kind<DP, false>(q, k, v, bh, bw, o, G, S, D, wh, ww, scale, stream);
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

}  // namespace

// csrc/relpos_attention_wgmma.cu: SAM ViT-H's head-dim-80 calls on wgmma and TMA
extern "C" int bff_relpos_wgmma_takes(int kind, int dtype, int D, int S, int rows, int cols,
                                      float scale, const void* q, const void* k, const void* v,
                                      const void* o, const void* bias_h, const void* bias_w);
extern "C" int bff_flash_relpos_wgmma(const void* q, const void* k, const void* v,
                                      const void* bias_h, const void* bias_w, void* o, int BH,
                                      int S, int kh, float scale, void* stream);
extern "C" int bff_window_relpos_wgmma(const void* q, const void* k, const void* v,
                                       const void* bias_h, const void* bias_w, void* o, int G,
                                       float scale, void* stream);
// csrc/relpos_attention_tf32.cu: the f32 calls of K4 at head dim 64 or 80 and of
// K5 at 80 on 3xTF32 wgmma
extern "C" int bff_relpos_tf32_takes(int kind, int dtype, int D, int S, int rows, int cols,
                                     float scale, const void* q, const void* k, const void* v,
                                     const void* o, const void* bias_h, const void* bias_w);
extern "C" int bff_flash_relpos_tf32(const void* q, const void* k, const void* v,
                                     const void* bias_h, const void* bias_w, void* o,
                                     void* scratch, int BH, int S, int D, int kh, int kw,
                                     float scale, void* stream);
extern "C" int bff_window_relpos_tf32(const void* q, const void* k, const void* v,
                                      const void* bias_h, const void* bias_w, void* o, int G,
                                      float scale, void* stream);

namespace {

#define BFF_BY_HEAD_DIM(FN, T, ...)                                 \
  (D <= 32 ? FN<T, 32>(__VA_ARGS__)                                 \
   : D <= 64 ? FN<T, 64>(__VA_ARGS__)                               \
   : D <= 80 ? FN<T, 80>(__VA_ARGS__)                               \
             : FN<T, 128>(__VA_ARGS__))

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous (BH, S, D) with
// S = kh * kw and kh + kw <= 256; bias_h: (BH, S, kh), bias_w: (BH, S, kw),
// in q's dtype; scratch: what the 3xTF32 kernel needs where
// bff_relpos_tf32_takes the call (bff_relpos_tf32_scratch_floats floats),
// else unread.
// Returns cudaGetLastError() after the launch, or -1 for arguments the
// kernel does not take.
extern "C" int bff_flash_attention_relpos(int dtype, const void* q, const void* k, const void* v,
                                          const void* bias_h, const void* bias_w, void* o,
                                          int BH, int S, int D, int kh, int kw, float scale,
                                          void* stream, void* scratch) {
  if (BH < 1 || S < 1 || D < 1 || D > 128 || kh < 1 || kw < 1 || kh * kw != S ||
      kh + kw > 256)
    return -1;
  if (bff_relpos_wgmma_takes(0, dtype, D, S, kh, kw, scale, q, k, v, o, bias_h, bias_w))
    return bff_flash_relpos_wgmma(q, k, v, bias_h, bias_w, o, BH, S, kh, scale, stream);
  if (bff_relpos_tf32_takes(0, dtype, D, S, kh, kw, scale, q, k, v, o, bias_h, bias_w))
    return bff_flash_relpos_tf32(q, k, v, bias_h, bias_w, o, scratch, BH, S, D, kh, kw,
                                 scale, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return BFF_BY_HEAD_DIM(launch_flash, float, q, k, v, bias_h, bias_w, o, BH, S, D, kh, kw,
                           scale, s);
  if (dtype == 1 && bff_tc::tile_takes(D, q, k, v, o))
    return BFF_BY_HEAD_DIM(launch_flash_tc_grid, __nv_bfloat16, q, k, v, bias_h, bias_w, o, BH,
                           S, D, kh, kw, scale, s);
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
  if (bff_relpos_wgmma_takes(1, dtype, D, S, wh, ww, scale, q, k, v, o, bias_h, bias_w))
    return bff_window_relpos_wgmma(q, k, v, bias_h, bias_w, o, G, scale, stream);
  if (bff_relpos_tf32_takes(1, dtype, D, S, wh, ww, scale, q, k, v, o, bias_h, bias_w))
    return bff_window_relpos_tf32(q, k, v, bias_h, bias_w, o, G, scale, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return BFF_BY_HEAD_DIM(launch_window, float, q, k, v, bias_h, bias_w, o, G, S, D, wh, ww,
                           scale, s);
  if (dtype == 1 && bff_tc::tile_takes(D, q, k, v, o))
    return BFF_BY_HEAD_DIM(launch_window_tc, __nv_bfloat16, q, k, v, bias_h, bias_w, o, G, S, D,
                           wh, ww, scale, s);
  if (dtype == 1)
    return BFF_BY_HEAD_DIM(launch_window, __nv_bfloat16, q, k, v, bias_h, bias_w, o, G, S, D,
                           wh, ww, scale, s);
  return -1;
}

// K4 in f32 on the FMA kernel above whatever bff_relpos_tf32_takes says: the
// yardstick that chip_smoke.py and tools/kernel_variants.py time beside the
// 3xTF32 kernel on the same call. No wrapper calls it. Arguments and return
// codes as bff_flash_attention_relpos's, f32 only.
extern "C" int bff_flash_attention_relpos_f32_fma(const void* q, const void* k, const void* v,
                                                  const void* bias_h, const void* bias_w,
                                                  void* o, int BH, int S, int D, int kh, int kw,
                                                  float scale, void* stream) {
  if (BH < 1 || S < 1 || D < 1 || D > 128 || kh < 1 || kw < 1 || kh * kw != S ||
      kh + kw > 256)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return BFF_BY_HEAD_DIM(launch_flash, float, q, k, v, bias_h, bias_w, o, BH, S, D, kh, kw,
                         scale, s);
}
