// What the 3xTF32 kernels of K4 and K5 (csrc/relpos_attention_tf32.cu,
// csrc/relpos_attention_wide_tf32.cu) share: the split of four floats into
// TF32 hi and lo words, the chunk maps of the operand images (32-byte rows
// in the 32-byte swizzle; csrc/relpos_attention_tf32.cu sets out the
// layout), and wgmma on TF32 operands.

#pragma once

#include <cuda.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace bff_tf32 {

using namespace bff_wg;

__device__ __forceinline__ void split4(float4 x, uint4& hi, uint4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// A K-like image of ``rows`` rows is D / 8 regions x rows x 2 halves of 16
// bytes; chunk i (16 bytes at byte 16 i) is (region i / (2 rows), row (i /
// 2) % rows, stored half i % 2), holding the columns 8 region + 4 half, half
// = stored half ^ ((row / 4) % 2). Returns that first column; ``row`` is
// set.
__device__ __forceinline__ int kimg_chunk(int i, int rows, int& row) {
  const int region = i / (2 * rows);
  row = (i >> 1) % rows;
  return region * 8 + (((i ^ (row >> 2)) & 1) << 2);
}

// A V^T image is keys / 8 regions x D rows x 2 halves; chunk i is (group
// i / 2 D, row d = (i / 2) % D, stored half i % 2) and holds the keys of
// parity e = stored half ^ ((d / 4) % 2) of the group, 8 group + e + 2 u at
// stored position 4 e + u (the order 0 2 4 6 1 3 5 7). Returns the group's
// first key plus e; ``d`` is set.
template <int D>
__device__ __forceinline__ int vimg_chunk(int i, int& d) {
  d = (i >> 1) % D;
  return (i / (2 * D)) * 8 + ((i ^ (d >> 2)) & 1);
}

// ------------------------------------------------------------ wgmma, TF32
#define BFF_T4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define BFF_T8(a, i) BFF_T4(a, i), BFF_T4(a, i + 4)

// d += A B for A 64 x 8 and B 8 x N TF32, both from shared memory, K-major:
// N 64 (32 registers of d), 40 (20), 32 (16) or 16 (8).
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_ss(float (&d)[20], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "%20, %21, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T4(d, 16)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_ss(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : BFF_T8(d, 0)
      : "l"(da), "l"(db), "r"(1));
}

// d (+)= A B for A 64 x 8 TF32 in registers (a lane holds rows g, g + 8 of
// its warp's 16 and columns t, t + 4: a0 (g, t), a1 (g + 8, t), a2 (g, t +
// 4), a3 (g + 8, t + 4)) and B 8 x N TF32 from shared memory, K-major: N 32,
// 48, 56, 64, 80, 96 or 112 (N / 2 registers of d).
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[40], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T8(d, 24), BFF_T8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T8(d, 24), BFF_T8(d, 32), BFF_T8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[56], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T8(d, 24), BFF_T8(d, 32), BFF_T8(d, 40),
        BFF_T8(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma_rs(float (&d)[24], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void mma_rs(float (&d)[28], const uint32_t (&a)[4], uint64_t db,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
      "{%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
      : BFF_T8(d, 0), BFF_T8(d, 8), BFF_T8(d, 16), BFF_T4(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

#undef BFF_T8
#undef BFF_T4

}  // namespace bff_tf32
