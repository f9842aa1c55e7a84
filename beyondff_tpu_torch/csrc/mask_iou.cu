// Pairwise IoU of boolean point masks on Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel beyondff_tpu/kernels/mask_iou.py
// (pairwise_iou_pallas, body _iou_kernel, wrapper pad_and_iou), together with
// csrc/mask_iou_wgmma.cu, to which bff_mask_iou routes every call whose rows
// lie on 16-byte boundaries (bff_mask_iou_wgmma_takes); the count kernel
// below keeps every other call, and the finish kernel serves both:
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
// Bound on an H100 SXM (3.35 TB/s; 1,979 TOP/s dense int8 on the tensor
// cores): at the aggregation's self-IoU, Ia = 600 and N = 250,000, the
// function reads 150 MB (~45 us) and, counting each distinct pair once, does
// 600*601*250,000 = 9.0e10 integer operations (~46 us), so operations bound
// it, barely. Refinement's cross IoU, (20 x 150, 250,000), reads 42.5 MB
// (~13 us) for 1.5e9 operations: bound by bytes.
//
// Design of the mma.sync count kernel (rows at any address; row strides
// need not be multiples of 16): the intersections are a product over N of
// 0/1 bytes, so they go to the int8 tensor cores,
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, on the bool bytes themselves:
// A = a (Ia, N) row-major is the row operand, B = b (Ib, N) row-major is
// the col operand (as K^T is in attention_tc.cuh's Q K^T), counts in s32
// (exact). Fragments come by ldmatrix from shared tiles whose row stride,
// 80 bytes (5 granules of 16), puts the eight rows of an ldmatrix phase on
// eight distinct groups of banks.
// * A block of 8 warps owns a 128 x 128 output tile (each warp 64 x 32: 4 x
//   4 m16n8 tiles, 16 mma for 4 A and 2 B fragments per k32 step) and one
//   slice of N (split-K). For a self-IoU only the tiles on and above the
//   diagonal are counted: 15 tiles at Ia = 600. N is split until the grid
//   is one wave of two blocks per SM (255 blocks for the self-IoU, 264 for
//   the cross IoU), and partial counts meet in int32 atomics (order-free:
//   integers). A warp whose rows or columns all lie past Ia or Ib skips its
//   mma; the others run every tile, with no branch between ldmatrix and
//   mma (rows past the end are zeros).
// * Rows off 16-byte boundaries, which contiguous masks of a real scene
//   have (any N), cannot take cp.async or TMA at their own addresses. Each
//   thread owns one stage row: it loads the 5 aligned 16-byte granules
//   around the row's 64-byte chunk from global memory into registers, cuts
//   the chunk out of them there (a funnel shift, bytes past the slice
//   zeroed) and stores the 4 cut granules into a ring of 2 stages. The
//   loads of chunk c + 1 are issued before the mma of chunk c and cut after
//   it, with one barrier a step; no load leaves the granules that hold the
//   tensor. It takes 1.7-1.8x the time that a cp.async ring took over
//   aligned rows (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6); loads
//   after the mma, four lanes a row side by side, and L1 prefetches were
//   each measured slower.
// * Areas: a self-IoU's |a_i| is its diagonal count inter[i, i]; there is
//   no area pass. A cross IoU counts row areas from the shared tile with
//   __dp4a (the blocks of the first tile column for a, of the first tile
//   row for b).
// * A second small kernel turns counts into IoU: the quotient of exact
//   integers, correctly rounded, nan at 0 / 0; for a self-IoU it fills the
//   lower triangle from the upper.
// Shared memory: 2 x 256 x 80 = 40,960 bytes a block; at most 128 registers
// a thread (__launch_bounds__(256, 2)): two blocks per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "attention_tc.cuh"

namespace {

constexpr int kTile = 128;            // output rows and columns per block
constexpr int kChunk = 128;           // bytes of N a slice of the split is a multiple of
constexpr int kRows = 2 * kTile;      // a stage: A's 128 rows, then B's 128
constexpr int kCut = 64;              // bytes of a row per step
constexpr int kLd = kCut + 16;        // shared row stride: 5 granules
constexpr int kGran = kCut / 16 + 1;  // aligned granules around a cut chunk
constexpr int kStage = kRows * kLd;
constexpr int kSmem = 2 * kStage;     // 2 stages of 256 rows x 80 bytes: 40,960
constexpr int kThreads = 256;
constexpr int kMT = 4, kNT = 4;       // a warp's m16 and n8 tiles: 64 x 32

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint8_t* p) {
  bff_tc::ldsm_x4(r, reinterpret_cast<const __nv_bfloat16*>(p));
}

// c += a b for one m16n8k32 tile of 0/1 bytes.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sum of the 16 0/1 bytes of a granule.
__device__ __forceinline__ unsigned count16(uint4 v, unsigned acc) {
  acc = __dp4a(v.x, 0x01010101u, acc);
  acc = __dp4a(v.y, 0x01010101u, acc);
  acc = __dp4a(v.z, 0x01010101u, acc);
  return __dp4a(v.w, 0x01010101u, acc);
}

// The 16 bytes from byte ``off`` (0..15) of lo on, lo's tail followed by
// hi's head, where only the first ``valid`` belong to the slice and the rest
// read as 0: word selects and a funnel shift, in registers.
__device__ __forceinline__ uint4 cut16(uint4 lo, uint4 hi, unsigned off, int valid) {
  uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const bool by2 = off & 8u, by1 = off & 4u;
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = by2 ? v[k + 2] : v[k];
#pragma unroll
  for (int k = 0; k < 5; ++k) v[k] = by1 ? v[k + 1] : v[k];
  const unsigned sh = (off & 3u) * 8u;
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = __funnelshift_r(v[k], v[k + 1], sh);
    const int left = valid - 4 * k;  // bytes of word k inside the slice
    w[k] = left >= 4 ? x : left <= 0 ? 0u : x & ((1u << (8 * left)) - 1u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct Slice {
  const uint8_t* a;
  const uint8_t* b;
  int Ia, Ib, row0, col0;
  long long lda, ldb, n_end;

  // Row r of a stage: A's row row0 + r (r < 128) or B's row col0 + r - 128;
  // null past Ia or Ib.
  __device__ __forceinline__ const uint8_t* row(int r) const {
    if (r < kTile) return row0 + r < Ia ? a + (long long)(row0 + r) * lda : nullptr;
    return col0 + r - kTile < Ib ? b + (long long)(col0 + r - kTile) * ldb : nullptr;
  }
};

// One thread's stage row of an unaligned slice: the row's aligned granules
// from the slice's start on (``gp``, null past Ia or Ib), the row's offset
// in its first granule and the slice's bytes.
struct CutRow {
  const uint4* gp;
  unsigned off;
  long long len;

  // The granules around chunk c, [c kCut, (c + 1) kCut) of the slice, by
  // 16-byte global loads into registers; granules that hold no byte of the
  // slice read as zero.
  __device__ __forceinline__ void load(uint4 (&g)[kGran], int c) const {
    const long long rem = len - (long long)c * kCut;  // slice bytes from the chunk on
#pragma unroll
    for (int k = 0; k < kGran; ++k)
      g[k] = gp != nullptr && 16 * k < (long long)off + rem ? __ldg(gp + c * (kCut / 16) + k)
                                                             : make_uint4(0u, 0u, 0u, 0u);
  }

  // Chunk c cut out of its granules into the stage row ``dst``, bytes past
  // the slice zeroed.
  __device__ __forceinline__ void cut(const uint4 (&g)[kGran], int c, uint8_t* dst) const {
    const int valid = (int)min((long long)kCut, len - (long long)c * kCut);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int seg = 0; seg < kCut / 16; ++seg)
      d[seg] = cut16(g[seg], g[seg + 1], off, valid - 16 * seg);
  }
};

// Rows stream in chunks of 64 bytes through registers into a ring of 2
// stages: in step c the block loads chunk c + 1, multiplies chunk c, then
// cuts chunk c + 1 into the other stage, with one barrier a step.
__global__ void __launch_bounds__(kThreads, 2)
iou_count_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b, int Ia, int Ib,
                 long long N, long long lda, long long ldb, int self, int tiles_j,
                 long long split_len, int* __restrict__ inter, int* __restrict__ area_a,
                 int* __restrict__ area_b) {
  extern __shared__ __align__(16) uint8_t smem[];
  // the output tile: the upper triangle by rows for a self-IoU
  int ti = 0, tj = blockIdx.x;
  if (self) {
    for (int len = tiles_j; tj >= len; --len) {
      tj -= len;
      ++ti;
    }
    tj += ti;
  } else {
    ti = blockIdx.x / tiles_j;
    tj = blockIdx.x % tiles_j;
  }
  const long long n_begin = (long long)blockIdx.y * split_len;
  const Slice sl{a, b, Ia, Ib, ti * kTile, tj * kTile, lda, ldb, min(N, n_begin + split_len)};
  const int chunks = (int)((sl.n_end - n_begin + kCut - 1) / kCut);

  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int wr = warp / 4, wc = warp % 4;  // rows wr * 64, columns wc * 32
  // a warp whose rows or columns all lie past Ia or Ib skips its mma (the
  // cross IoU's 20 rows leave warp row 1 idle); the others run all their
  // m16 and n8 tiles (rows past the end are zeros), with no branch between
  // ldmatrix and mma
  const bool live = sl.row0 + wr * 64 < Ia && sl.col0 + wc * 32 < Ib;
  // cross-IoU areas: a's rows in the first tile column, b's in the first
  // tile row; thread t counts stage row t
  const bool do_area = !self && (threadIdx.x < kTile ? tj == 0 : ti == 0);
  unsigned area = 0;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  // thread t owns stage row t
  CutRow cr{nullptr, 0u, sl.n_end - n_begin};
  uint4 g[kGran];
  const uint8_t* src = sl.row(threadIdx.x);
  if (src != nullptr) {
    cr.off = (unsigned)(reinterpret_cast<uintptr_t>(src + n_begin) & 15u);
    cr.gp = reinterpret_cast<const uint4*>(src + n_begin - cr.off);
  }
  cr.load(g, 0);
  cr.cut(g, 0, smem + threadIdx.x * kLd);
  __syncthreads();  // cut chunk 0 is whole

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) cr.load(g, c + 1);  // in flight during the mma
    const uint8_t* st = smem + (c & 1) * kStage;
    if (do_area) {
      const uint4* row = reinterpret_cast<const uint4*>(st + threadIdx.x * kLd);
#pragma unroll
      for (int seg = 0; seg < kCut / 16; ++seg) area = count16(row[seg], area);
    }

    const uint8_t* sA = st + (wr * 64) * kLd;
    const uint8_t* sB = st + (kTile + wc * 32) * kLd;
    if (live) {
      // one k32 step at a time: with the 64 accumulators, the fragments of
      // one step are what 128 registers hold
#pragma unroll 1
      for (int kk = 0; kk < kCut / 32; ++kk) {
        uint32_t af[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldsm_x4(af[mt], sA + (mt * 16 + (lane & 15)) * kLd + kk * 32 + (lane >> 4) * 16);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, sB + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 32 +
                          ((lane >> 3) & 1) * 16);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_s8(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_s8(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
    }

    // stage (c + 1) & 1 was last read in step c - 1, behind its barrier
    if (c + 1 < chunks) cr.cut(g, c + 1, smem + ((c + 1) & 1) * kStage + threadIdx.x * kLd);
    __syncthreads();  // cut chunk c + 1 is whole; every warp is past chunk c
  }

  // partial counts of the slice: c0, c1 at (lane / 4, 2 (lane % 4) + {0, 1})
  // of the m16n8 tile, c2, c3 eight rows down
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = sl.row0 + wr * 64 + mt * 16 + lane / 4 + 8 * h;
      if (i >= Ia) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = sl.col0 + wc * 32 + nt * 8 + 2 * (lane & 3) + e;
          const int x = acc[mt][nt][2 * h + e];
          if (j < Ib && x) atomicAdd(inter + (long long)i * Ib + j, x);
        }
    }
  if (do_area && area) {
    const int r = threadIdx.x;
    if (r < kTile) {
      if (sl.row0 + r < Ia) atomicAdd(area_a + sl.row0 + r, (int)area);
    } else if (sl.col0 + r - kTile < Ib) {
      atomicAdd(area_b + sl.col0 + r - kTile, (int)area);
    }
  }
}

__global__ void iou_finish_kernel(const int* __restrict__ inter, const int* __restrict__ area_a,
                                  const int* __restrict__ area_b, int Ia, int Ib, int self,
                                  float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)Ia * Ib) return;
  const int i = (int)(idx / Ib), j = (int)(idx % Ib);
  int n, u;
  if (self) {
    // only the tiles on and above the diagonal were counted; |a_i| is the
    // diagonal count
    n = j / kTile < i / kTile ? inter[(long long)j * Ib + i] : inter[idx];
    u = inter[(long long)i * Ib + i] + inter[(long long)j * Ib + j] - n;
  } else {
    n = inter[idx];
    u = area_a[i] + area_b[j] - n;
  }
  out[idx] = (float)n / (float)u;  // IEEE division: 0 / 0 = nan
}

}  // namespace

// csrc/mask_iou_wgmma.cu: rows on 16-byte boundaries, on int8 wgmma and TMA
extern "C" int bff_mask_iou_wgmma_takes(int Ia, int Ib, long long N, long long lda,
                                        long long ldb, const void* a, const void* b);
extern "C" int bff_mask_iou_wgmma_count(const void* a, const void* b, int Ia, int Ib,
                                        long long N, long long lda, long long ldb, int* inter,
                                        int* area_a, int* area_b, void* stream);

// a: (Ia, N) bytes with rows lda bytes apart, b: (Ib, N) bytes with rows ldb
// apart, or null for a self-IoU (Ib = Ia, ldb ignored); each byte 0 or 1.
// workspace: Ia*Ib + Ia + Ib int32. out: (Ia, Ib) float32. Returns
// cudaGetLastError() after the launches, or a non-zero code for arguments
// the kernels do not take (-1) or a refused tensor map (see
// bff_mask_iou_wgmma_count).
extern "C" int bff_mask_iou(const void* a, const void* b, int Ia, int Ib, long long N,
                            long long lda, long long ldb, void* workspace, void* out,
                            void* stream) {
  if (b == nullptr) ldb = lda;
  if (Ia < 1 || Ib < 1 || N < 0 || lda < N || ldb < N || (b == nullptr && Ib != Ia)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int self = b == nullptr;
  const uint8_t* pa = static_cast<const uint8_t*>(a);
  const uint8_t* pb = self ? pa : static_cast<const uint8_t*>(b);
  int* inter = static_cast<int*>(workspace);
  int* area_a = inter + (long long)Ia * Ib;
  int* area_b = area_a + Ia;
  cudaError_t err = cudaMemsetAsync(workspace, 0, sizeof(int) * ((long long)Ia * Ib + Ia + Ib), s);
  if (err != cudaSuccess) return (int)err;

  if (N > 0 && bff_mask_iou_wgmma_takes(Ia, Ib, N, lda, ldb, a, b)) {
    const int rc = bff_mask_iou_wgmma_count(a, b, Ia, Ib, N, lda, ldb, inter, area_a, area_b,
                                            stream);
    if (rc != 0) return rc;
  } else if (N > 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int tiles_i = (Ia + kTile - 1) / kTile, tiles_j = (Ib + kTile - 1) / kTile;
    const long long tiles =
        self ? (long long)tiles_i * (tiles_i + 1) / 2 : (long long)tiles_i * tiles_j;
    const long long chunks = (N + kChunk - 1) / kChunk;
    // split N into one wave of two blocks per SM, at least 4 chunks a slice
    long long splits = std::max(1LL, 2LL * sms / tiles);
    splits = std::max(1LL, std::min({splits, chunks / 4, 65535LL}));
    const long long split_len = ((chunks + splits - 1) / splits) * kChunk;
    splits = (N + split_len - 1) / split_len;
    static int configured = 48 * 1024;
    err = bff_tc::allow_smem(iou_count_kernel, kSmem, &configured);
    if (err != cudaSuccess) return (int)err;
    iou_count_kernel<<<dim3((unsigned)tiles, (unsigned)splits), kThreads, kSmem, s>>>(
        pa, pb, Ia, Ib, N, lda, ldb, self, tiles_j, split_len, inter, area_a, area_b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)Ia * Ib;
  iou_finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      inter, area_a, area_b, Ia, Ib, self, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
