// What the port's Hopper (sm_90a) attention kernels built on wgmma and TMA
// share: mbarriers, TMA loads (tensor and plain bulk), shared-memory matrix
// descriptors, wgmma issue and wait, named-barrier turns, and the run-time
// lookup of cuTensorMapEncodeTiled. Used by csrc/flash_attention_wgmma.cu
// (K3), csrc/flash_masked_wgmma.cu (K2: head dim 32, 64-byte swizzle),
// csrc/relpos_attention_wgmma.cu (K4 and K5), csrc/mask_iou_wgmma.cu (K6:
// the s8 product, 2-D maps over byte rows, cluster multicast) and the
// 3xTF32 kernels (csrc/flash_attention_tf32.cu, csrc/relpos_attention_tf32.cu:
// the TF32 split); also by
// tools/variant_csrc/ms_deform_window_tma.cu, a K1 variant that
// tools/kernel_variants.py builds.
//
// The wide kernels of head dims 144 to 256 use it through wide_wgmma.cuh
// (bf16) and tf32_images.cuh (3xTF32).
//
// Descriptors. A TMA box written with CU_TENSOR_MAP_SWIZZLE_128B (rows of
// 128 bytes), _64B (rows of 64 bytes) or _32B (rows of 32 bytes) is read by
// a descriptor of the same swizzle mode; tiles start on 1024-byte
// boundaries. For a K-major operand the stride byte offset (SBO) is the
// distance between 8-row groups and the leading offset is not read (one k16
// step never leaves a swizzle row); a k-step moves the start address by 32
// bytes. For the MN-major V (keys down, head dims along the row; the
// transpose bit set) the SBO is the distance between 8-key groups and the
// leading offset the distance between the swizzle-wide blocks (64, 32 or 16
// elements) along N, which the callers' N never leaves: they pass the SBO
// for it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bff_wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Returns once the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// The same, giving up with a trap (the launch then fails and the wrapper
// raises) once the barrier has been polled 2^26 times, far beyond any wait
// of a working pipeline: a protocol fault shows as an error, not a hang.
__device__ __forceinline__ void bar_wait_or_trap(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// Arrival on the barrier at the same shared-memory offset in block ``cta``
// of the cluster (this block included).
__device__ __forceinline__ void bar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// Every thread of every block of the cluster meets here (release/acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The box of ``map`` at (c0, c1) into dst, reported to ``bar``.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same box written at dst (and reported to the barrier at bar's offset)
// in every block of the cluster that ``mask`` names.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map,
                                                      uint64_t* bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// The box of ``map`` at coordinates (c0, c1, c2) into dst; completion (its
// bytes) is reported to ``bar``.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ``bytes`` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// into dst, reported to ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptors: 128-byte swizzle (8-row groups of
// 128-byte rows, 1024 bytes apart), 64-byte swizzle (8-row groups of
// 64-byte rows, 512 bytes apart) and 32-byte swizzle (8-row groups of
// 32-byte rows, 256 bytes apart).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo_bytes >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

// Named barriers (0 is __syncthreads): two warpgroups meet at each.
__device__ __forceinline__ void turn_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// x, opaque to the compiler from here on: a kernel passes an address or an
// index through it once a loop step, so what is computed from it (wgmma
// descriptors, chunk coordinates) is computed there instead of hoisted out
// of the loop into registers that the accumulators need.
template <typename T>
__device__ __forceinline__ T opaque(T x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait that hands them back.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define BFF_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define BFF_F16(a, i) BFF_F4(a, i), BFF_F4(a, i + 4), BFF_F4(a, i + 8), BFF_F4(a, i + 12)
#define BFF_W4(a, i) "=f"(a[i]), "=f"(a[i + 1]), "=f"(a[i + 2]), "=f"(a[i + 3])
#define BFF_W16(a, i) BFF_W4(a, i), BFF_W4(a, i + 4), BFF_W4(a, i + 8), BFF_W4(a, i + 12)

// d (+)= A B for A 64 x 16 and B 16 x 128, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : BFF_F16(d, 0), BFF_F16(d, 16), BFF_F16(d, 32), BFF_F16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B for A 64 x 16 and B 16 x 64, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : BFF_F16(d, 0), BFF_F16(d, 16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d = A B, the same shapes: d is written, not read (the first k-step of a
// product), so the compiler need not keep its old values.
__device__ __forceinline__ void wgmma_m64n64k16_ss_first(float (&d)[32], uint64_t da,
                                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : BFF_W16(d, 0), BFF_W16(d, 16)
      : "l"(da), "l"(db), "r"(0));
}

// d (+)= A B for A 64 x 16 in registers (the mma.sync m16n8k16 A layout, one
// 16-row slice per warp) and B 16 x 32 from shared memory, MN-major.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : BFF_F16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A B for A 64 x 16 in registers (the mma.sync m16n8k16 A layout, one
// 16-row slice per warp) and B 16 x 64 from shared memory, MN-major.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : BFF_F16(d, 0), BFF_F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// The same with B 16 x 16, MN-major.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : BFF_F4(d, 0), BFF_F4(d, 4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A B for A 64 x 16 and B 16 x 200, both from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n200k16_ss(float (&d)[100], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %102, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n200k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99}, "
      "%100, %101, p, 1, 1, 0, 0;\n}\n"
      : BFF_F16(d, 0), BFF_F16(d, 16), BFF_F16(d, 32), BFF_F16(d, 48), BFF_F16(d, 64),
        BFF_F16(d, 80), BFF_F4(d, 96)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define BFF_R4(a, i) "+r"(a[i]), "+r"(a[i + 1]), "+r"(a[i + 2]), "+r"(a[i + 3])
#define BFF_R16(a, i) BFF_R4(a, i), BFF_R4(a, i + 4), BFF_R4(a, i + 8), BFF_R4(a, i + 12)

// d (+)= A B for A 64 x 32 and B 32 x 128 signed bytes, both from shared
// memory, K-major (the only layout wgmma takes for 8-bit types), counts in
// s32. The accumulator layout is the f32 one of m64n128k16.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : BFF_R16(d, 0), BFF_R16(d, 16), BFF_R16(d, 32), BFF_R16(d, 48)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef BFF_R16
#undef BFF_R4
#undef BFF_W16
#undef BFF_W4
#undef BFF_F16
#undef BFF_F4

// cuTensorMapEncodeTiled's signature (cuda.h), looked up at run time, so
// the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// base viewed as (n, S, d) bf16, boxes of box_rows rows x box_cols columns
// in the given swizzle mode, rows past S of a head (or window) zero-filled.
// 0, or a negative code: -3 for a base or stride off 16 bytes, -1000 -
// CUresult for a failed encode.
inline int encode_3d(EncodeTiled fn, CUtensorMap* map, const void* base, int d, int S, int n,
                     int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)n};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || strides[0] % 16 != 0 ||
      strides[1] % 16 != 0)
    return -3;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

// Any tiled map: ``rank`` dimensions (innermost first), byte strides of
// dimensions 1 .. rank - 1, the box, no interleave, zero fill out of
// bounds. Return codes as encode_3d's.
inline int encode_map(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type, int rank,
                      const void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0) return -3;
  for (int i = 0; i + 1 < rank; ++i)
    if (strides[i] % 16 != 0) return -3;
  const CUresult r = fn(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(r);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The 3xTF32 kernels' rounding: x to a TF32 word, rounded to nearest with
// ties away (cvt.rna; the low 13 bits 0), and x = hi + lo to about 22 bits,
// both TF32 words (x - hi is exact in f32).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

}  // namespace bff_wg
