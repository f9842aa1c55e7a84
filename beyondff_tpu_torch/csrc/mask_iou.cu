// Pairwise IoU of boolean point masks on Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel beyondff_tpu/kernels/mask_iou.py
// (pairwise_iou_pallas, body _iou_kernel, wrapper pad_and_iou):
//
//   out[i, j] = |a_i & b_j| / (|a_i| + |b_j| - |a_i & b_j|),   0 / 0 = nan
//
// for (Ia, N) x (Ib, N) masks stored as torch.bool, one byte per point, each
// byte 0 or 1. The kernel reads those bytes as they are: no float or int8
// copy of the masks is made (the TPU kernel's docstring is about avoiding
// exactly that copy). Counts are integers, accumulated in int32, so the
// result is exact and bit-equal to any float32 formulation whose sums stay
// below 2^24: the quotient of two exact integers, correctly rounded.
//
// Design (a simple first version): one block of 256 threads owns a 64 x 64
// tile of the output and one slice of N (split-K, so that a few hundred rows
// still fill the card's 132 SMs). It streams its slice through shared memory
// in chunks of 128 bytes per row; each thread keeps a 4 x 4 sub-tile of counts
// in registers and adds four points per `__dp4a` on 32-bit words (the bytes
// are 0/1, so the byte dot product is the count of common points). The row
// areas accumulate in the same pass, in the blocks of the first tile column
// (of the diagonal for a self-IoU). Partial counts of the slices meet with
// int32 atomics in a workspace (order-free: integers); a second small kernel
// turns counts into IoU. For a self-IoU (b absent) only the tiles on and above
// the diagonal are counted and the epilogue fills both triangles. Ragged Ia,
// Ib and N are masked in the kernel: no padding to tile multiples. Rows are
// read with aligned 16-byte loads whatever N and the base address are: a row
// that starts off a 16-byte boundary is cut from the aligned words around it
// in registers.
//
// Bound on an H100 SXM (3.35 TB/s; 1,979 TOP/s dense int8 on the tensor
// cores): at the aggregation's self-IoU, Ia = 600 and N = 250,000, the
// function reads 150 MB (~45 us) and, counting each distinct pair once, does
// 600*601*250,000 = 9.0e10 integer operations (~46 us at the int8
// tensor-core rate), so operations bound it, barely. This version counts on
// the integer ALUs with __dp4a, far below the tensor-core rate; int8
// mma.sync / wgmma with s32 accumulation and TMA loads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTile = 64;          // output rows and columns per block
constexpr int kChunk = 128;        // bytes of N per row per step
constexpr int kWords = kChunk / 4;
constexpr int kStride = kWords + 1;  // shared row stride in words (bank-conflict pad)
constexpr int kThreads = 256;

// The 16 bytes from byte `off` (0..15) of the aligned 16 at `base` on, as four
// words, where only the first `valid` (> 0) belong to the range and the rest
// read as 0. They are cut out of a 32-byte window (word selects and a funnel
// shift, in registers); the second aligned 16 is read only where the range
// reaches it.
__device__ __forceinline__ void cut_segment(const uint4* base, unsigned off, long long valid,
                                            uint32_t* w) {
  const uint4 lo = base[0];
  uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, 0u, 0u, 0u, 0u};
  if (valid > 16 - (long long)off) {
    const uint4 hi = base[1];
    v[4] = hi.x;
    v[5] = hi.y;
    v[6] = hi.z;
    v[7] = hi.w;
  }
  // move the window down by off / 4 words (as 2 + 1), then by off % 4 bytes
  const bool by2 = off & 8u, by1 = off & 4u;
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = by2 ? v[k + 2] : v[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) v[k] = by1 ? v[k + 1] : v[k];
  const unsigned sh = (off & 3u) * 8u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = __funnelshift_r(v[k], v[k + 1], sh);
    const long long left = valid - 4 * k;  // bytes of word k inside the range
    w[k] = left >= 4 ? x : left <= 0 ? 0u : x & ((1u << (8 * left)) - 1u);
  }
}

// Rows [row0, row0 + 64) x bytes [n0, n0 + 128) of a (rows, N) byte matrix
// into shared memory; rows >= rows and bytes >= n_end read as 0. Each thread
// takes 16-byte segments: one aligned 16-byte load where the segment is
// aligned and wholly inside the range (the cut would cost about a tenth of
// the kernel's time there), else cut_segment. So every N and base address
// read through aligned 16-byte loads, and no load leaves the 16-byte granules
// that hold the tensor.
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ m, uint32_t* s, int rows,
                                          long long N, int row0, long long n0,
                                          long long n_end) {
#pragma unroll
  for (int q = 0; q < kTile * kChunk / 16 / kThreads; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int r = idx / (kChunk / 16), seg = idx % (kChunk / 16);
    const long long n = n0 + seg * 16;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row0 + r < rows && n < n_end) {
      const uint8_t* p = m + (long long)(row0 + r) * N + n;
      const long long valid = n_end - n;
      const unsigned off = (unsigned)(reinterpret_cast<uintptr_t>(p) & 15u);
      if (off == 0 && valid >= 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
      } else {
        cut_segment(reinterpret_cast<const uint4*>(p - off), off, valid, w);
      }
    }
    uint32_t* d = s + r * kStride + seg * 4;
    d[0] = w[0];
    d[1] = w[1];
    d[2] = w[2];
    d[3] = w[3];
  }
}

// Sum of the four 0/1 bytes of each word of one shared row segment.
__device__ __forceinline__ unsigned row_part(const uint32_t* s, int r, int w0) {
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) acc = __dp4a(s[r * kStride + w0 + k], 0x01010101u, acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
iou_count_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b, int Ia, int Ib,
                 long long N, int self, long long split_len, int* __restrict__ inter,
                 int* __restrict__ area_a, int* __restrict__ area_b) {
  const int ti = blockIdx.x, tj = blockIdx.y;
  if (self && tj < ti) return;
  __shared__ uint32_t As[kTile * kStride];
  __shared__ uint32_t Bs[kTile * kStride];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = ti * kTile, col0 = tj * kTile;
  const long long n_begin = (long long)blockIdx.z * split_len;
  const long long n_end = min(N, n_begin + split_len);
  // areas: a's rows in the first tile column (the diagonal for a self-IoU),
  // b's rows in the first tile row; one (row, quarter) per thread
  const bool do_a = self ? (ti == tj) : (tj == 0);
  const bool do_b = !self && ti == 0;
  const int ar = threadIdx.x / 4, aq = (threadIdx.x % 4) * (kWords / 4);
  unsigned part_a = 0, part_b = 0;

  unsigned acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0u;

  for (long long n0 = n_begin; n0 < n_end; n0 += kChunk) {
    load_tile(a, As, Ia, N, row0, n0, n_end);
    load_tile(b, Bs, Ib, N, col0, n0, n_end);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kWords; ++k) {
      uint32_t av[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = As[(ty + 16 * r) * kStride + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = Bs[(tx + 16 * c) * kStride + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(av[r], bv[c], acc[r][c]);
    }
    if (do_a) part_a += row_part(As, ar, aq);
    if (do_b) part_b += row_part(Bs, ar, aq);
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + ty + 16 * r;
    if (i >= Ia) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = col0 + tx + 16 * c;
      if (j < Ib && acc[r][c]) atomicAdd(inter + (long long)i * Ib + j, (int)acc[r][c]);
    }
  }
  // the four threads of one row are neighbouring lanes of one warp
  if (do_a) {
    part_a += __shfl_xor_sync(0xffffffffu, part_a, 1);
    part_a += __shfl_xor_sync(0xffffffffu, part_a, 2);
    if (threadIdx.x % 4 == 0 && row0 + ar < Ia && part_a) atomicAdd(area_a + row0 + ar, (int)part_a);
  }
  if (do_b) {
    part_b += __shfl_xor_sync(0xffffffffu, part_b, 1);
    part_b += __shfl_xor_sync(0xffffffffu, part_b, 2);
    if (threadIdx.x % 4 == 0 && col0 + ar < Ib && part_b) atomicAdd(area_b + col0 + ar, (int)part_b);
  }
}

__global__ void iou_finish_kernel(const int* __restrict__ inter, const int* __restrict__ area_a,
                                  const int* __restrict__ area_b, int Ia, int Ib, int self,
                                  float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)Ia * Ib) return;
  const int i = (int)(idx / Ib), j = (int)(idx % Ib);
  // a self-IoU counted only the tiles on and above the diagonal
  const int n = (self && j / kTile < i / kTile) ? inter[(long long)j * Ib + i] : inter[idx];
  const int u = area_a[i] + (self ? area_a[j] : area_b[j]) - n;
  out[idx] = (float)n / (float)u;  // IEEE division: 0 / 0 = nan
}

}  // namespace

// a: (Ia, N) bytes, b: (Ib, N) bytes or null for a self-IoU (Ib = Ia); both
// contiguous, each byte 0 or 1. workspace: Ia*Ib + Ia + Ib int32. out: (Ia,
// Ib) float32. Returns cudaGetLastError() after the launches, or -1 for
// arguments the kernel does not take.
extern "C" int bff_mask_iou(const void* a, const void* b, int Ia, int Ib, long long N,
                            void* workspace, void* out, void* stream) {
  if (Ia < 1 || Ib < 1 || N < 0 || (b == nullptr && Ib != Ia)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int self = b == nullptr;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = self ? pa : static_cast<const uint8_t*>(b);
  int* inter = static_cast<int*>(workspace);
  int* area_a = inter + (long long)Ia * Ib;
  int* area_b = area_a + Ia;
  cudaError_t err = cudaMemsetAsync(workspace, 0, sizeof(int) * ((long long)Ia * Ib + Ia + Ib), s);
  if (err != cudaSuccess) return (int)err;

  const int tiles_i = (Ia + kTile - 1) / kTile, tiles_j = (Ib + kTile - 1) / kTile;
  const long long tiles = self ? (long long)tiles_i * (tiles_i + 1) / 2 : (long long)tiles_i * tiles_j;
  const long long chunks = (N + kChunk - 1) / kChunk;
  // split N until about 8 blocks per SM are in flight, keeping >= 8 chunks a slice
  long long splits = (8LL * 132 + tiles - 1) / tiles;
  splits = std::max(1LL, std::min(splits, (chunks + 7) / 8));
  splits = std::min(splits, 65535LL);
  const long long split_len = ((chunks + splits - 1) / splits) * kChunk;
  splits = std::max(1LL, (N + split_len - 1) / split_len);
  if (N > 0) {
    dim3 grid(tiles_i, self ? tiles_i : tiles_j, (unsigned)splits);
    iou_count_kernel<<<grid, kThreads, 0, s>>>(pa, pb, Ia, Ib, N, self, split_len, inter,
                                                area_a, area_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)Ia * Ib;
  iou_finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      inter, area_a, area_b, Ia, Ib, self, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
