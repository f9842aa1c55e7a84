// Attention with SAM's decomposed relative-position bias on grids whose
// factor table does not fit a block, for Hopper (sm_90a): the bf16
// tensor-core tile with each key tile's factors streamed into shared memory.
//
// Replaces, for bf16 calls with kh + kw past 256, the TPU kernel
// beyondff_tpu/kernels/flash_attention.py flash_attention_relpos (:193,
// pallas_call :214, wrapper attend_relpos :253): softmax(Q K^T * scale +
// bias) V with bias[q, k] = bias_h[q, k / kw] + bias_w[q, k % kw], an online
// max and denominator, P rounded to bf16 before P V, the output divided once
// by the f32 denominator. The TPU kernel's factor block is (bq, kh + kw);
// here the tile's per-block factor table (csrc/relpos_attention.cu, up to
// kh + kw = 256) would crowd out the K/V ring, so each 64-key tile's factor
// columns are staged instead. No configured model reaches these grids (SAM
// ViT-H's 64 x 64 stays inside the table); SAM's global attention past a
// 2048-pixel frame does (136 x 136 at 2 176 pixels). bff_flash_attention_relpos
// and bff_window_attention_relpos (csrc/relpos_attention.cu, K5's windows
// past 256 tokens as heads) route here exactly the calls that
// bff_relpos_streamed_takes accepts: bf16, head dim <= 128 with D % 8 == 0,
// q, k, v, o on 16 bytes, both factors on 4 bytes, a positive finite scale.
//
// Bound on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s): at (4, 18 496, 80) on
// 136 x 136 the function does 4 * 4 * 18 496^2 * 80 = 4.4e11 operations
// (0.443 ms) and moves 4 * 4 * 18 496 * 80 * 2 + 4 * 18 496 * 272 * 2 bytes
// (47 + 40 MB, 0.026 ms): bound by operations.
//
// Design: flash_relpos_tc_kernel's tile (csrc/attention_tc.cuh, 4 warps of
// 2 m16 tiles, a 128-query block, mma.sync m16n8k16 for both products, K/V
// in a 2-stage cp.async ring) with StreamedBias as its score modifier: each
// key tile's bias_h columns (and, past kStreamFixedW = 160 grid columns,
// bias_w's run of 64) are copied by 4-byte cp.async into a ring slot beside
// the tile's K and V, in the same group; up to 160 columns every bias_w
// column of the block's rows is staged once into a fixed table. A score
// then costs the two table reads and one FMA that WindowBias costs. The
// slots and the fixed table are appended to the tile's shared memory:
// stream_ld(kw) is at most 184 elements a row (kw = 160), 47 104 B, so at
// DP = 80 a block holds at most 67 584 + 47 104 = 114 688 B and two blocks
// share an SM, as on the table route (136 x 136: 168 elements, 110 592 B;
// past 160 columns 152). The first design staged both factors every tile,
// 36 words a row in a flat loop with its index arithmetic per word: 3.5x
// slower at 136 x 136 than this one, and slower than reading the factors
// from device memory (PERF.md).
//
// kStreamFromL2: the alternative tools/kernel_variants.py measures (no
// staging; each score's factors from device memory, the tile's factor lines
// prefetched into L1 before its Q K^T).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int kTcWarps = 4, kTcMT = 2;  // 4 warps x 2 m16 tiles: a 128-query tile
constexpr int kTcRows = 16 * kTcWarps * kTcMT;
constexpr bool kStreamFromL2 = false;

template <int DP, bool kPairs>
__global__ void __launch_bounds__(32 * kTcWarps) flash_relpos_streamed_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bh,
    const __nv_bfloat16* __restrict__ bw, __nv_bfloat16* __restrict__ o, int S, int D, int kh,
    int kw, long long rows, float scale) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int q0 = blockIdx.x * kTcRows;
  const long long base = (long long)blockIdx.y * S * D;
  const bff_tc::StreamedBias<kTcRows, 32 * kTcWarps, kPairs, kStreamFromL2> mod{
      reinterpret_cast<__nv_bfloat16*>(tc_smem + bff_tc::smem_bytes<DP, kTcRows>()),
      bh, bw, rows, (long long)blockIdx.y * S + q0, kh, kw, S, q0};
  mod.stage_fixed();
  mod.stage(0);  // joins attend_block's first group of copies
  bff_tc::attend_block<DP, kTcWarps, kTcMT>(q + base, k + base, v + base, o + base, q0, S, D,
                                            (S + bff_tc::kBK - 1) / bff_tc::kBK, scale, mod,
                                            reinterpret_cast<__nv_bfloat16*>(tc_smem));
}

// An even kw reads the factors by key pairs.
template <int DP, bool kPairs>
int launch(const void* q, const void* k, const void* v, const void* bh, const void* bw, void* o,
           int BH, int S, int D, int kh, int kw, float scale, cudaStream_t stream) {
  static int configured = 48 * 1024;
  const int bytes = bff_tc::smem_bytes<DP, kTcRows>() +
                    kTcRows * bff_tc::stream_ld(kw) * (int)sizeof(__nv_bfloat16);
  cudaError_t err =
      bff_tc::allow_smem(flash_relpos_streamed_kernel<DP, kPairs>, bytes, &configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kTcRows - 1) / kTcRows, BH);
  flash_relpos_streamed_kernel<DP, kPairs><<<grid, 32 * kTcWarps, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(bh),
      static_cast<const __nv_bfloat16*>(bw), static_cast<__nv_bfloat16*>(o), S, D, kh, kw,
      (long long)BH * S, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_pairs(const void* q, const void* k, const void* v, const void* bh, const void* bw,
                 void* o, int BH, int S, int D, int kh, int kw, float scale,
                 cudaStream_t stream) {
  if (kw % 2 == 0) return launch<DP, true>(q, k, v, bh, bw, o, BH, S, D, kh, kw, scale, stream);
  return launch<DP, false>(q, k, v, bh, bw, o, BH, S, D, kh, kw, scale, stream);
}

}  // namespace

// q, k, v, o: contiguous (BH, S, D) bf16 with S = kh * kw and D <= 128 (the
// tile's bound DP in {32, 64, 80, 128}, features D .. DP zero in shared
// memory only); bias_h (BH, S, kh), bias_w (BH, S, kw) bf16. The caller
// (csrc/relpos_attention.cu) has checked bff_relpos_streamed_takes. Returns
// cudaGetLastError() after the launch, or -1 for a head dim past 128.
extern "C" int bff_flash_relpos_streamed(const void* q, const void* k, const void* v,
                                         const void* bias_h, const void* bias_w, void* o, int BH,
                                         int S, int D, int kh, int kw, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 32) return launch_pairs<32>(q, k, v, bias_h, bias_w, o, BH, S, D, kh, kw, scale, s);
  if (D <= 64) return launch_pairs<64>(q, k, v, bias_h, bias_w, o, BH, S, D, kh, kw, scale, s);
  if (D <= 80) return launch_pairs<80>(q, k, v, bias_h, bias_w, o, BH, S, D, kh, kw, scale, s);
  if (D <= 128)
    return launch_pairs<128>(q, k, v, bias_h, bias_w, o, BH, S, D, kh, kw, scale, s);
  return -1;
}
