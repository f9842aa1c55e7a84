// Pairwise IoU counts of boolean point masks on Hopper (sm_90a): int8 wgmma
// fed by TMA, thread-block clusters sharing A rows by multicast.
//
// Replaces the TPU kernel beyondff_tpu/kernels/mask_iou.py
// pairwise_iou_pallas (:55, pallas_call :66, body _iou_kernel :29, wrapper
// pad_and_iou :88) for rows on 16-byte boundaries: it counts the
// intersections |a_i & b_j| (and, for a cross IoU, the row areas) of (Ia,
// N) x (Ib, N) masks of 0/1 bytes in int32; csrc/mask_iou.cu's
// iou_finish_kernel turns the counts into IoU (nan at 0 / 0), exactly as
// for its mma.sync kernel. bff_mask_iou (csrc/mask_iou.cu) routes here the
// calls that bff_mask_iou_wgmma_takes accepts: row strides (bytes) that are
// multiples of 16 and at least N, 16-byte aligned bases. Callers on the
// main path allocate mask rows that way (core/masks.py aligned_rows); other
// rows keep the mma.sync kernel and its cut path.
//
// Bound on an H100 SXM (1,979 TOP/s dense int8, 3.35 TB/s): the self-IoU of
// aggregation at (600, 250,000) does 600 * 601 * 250,000 = 9.0e10
// operations counting each distinct pair once (0.0456 ms) and reads 150 MB
// (0.045 ms); refinement's cross IoU (20 x 150, 250,000) reads 42.5 MB
// (0.0127 ms, bound by bytes).
//
// Design:
// * Products. wgmma.mma_async m64n128k32.s32.s8.s8 on the bool bytes as
//   they are, both operands K-major from shared memory (the masks are (rows,
//   N) row-major, and K-major is the only layout wgmma takes for 8-bit
//   types). A block has two consumer warpgroups, 64 rows of A each, and
//   owns a 128 x 128 output tile and one slice of N (split-K, int32 atomics
//   at the end: the sums are integers, so their order does not matter).
// * Copies. A producer warp keeps kStages stages in flight, each 128 bytes
//   of N of A's 128 rows and of B's 128 rows (16 KB each), loaded by TMA
//   through 2-D tensor maps over (N, rows) with the 128-byte swizzle that
//   the descriptors read; full and empty mbarriers per stage. The maps'
//   inner extent is N and their outer one Ia or Ib: TMA zero-fills the box
//   past N and past the last row, so no padding byte is ever read.
// * Re-reads. At Ia = 600 a row slice is read once per output tile of its
//   tile row or column (15 tiles of the upper triangle: 6.4 reads a byte),
//   and L2 serves them. The blocks of a cluster of kCluster share one tile
//   row and take adjacent tile columns; each loads 1/kCluster of A's rows
//   and multicasts it to all, so A crosses from L2 once per cluster. The
//   empty barriers count every consumer warp of the cluster (remote
//   arrivals), since a stage of A is written by every producer of the
//   cluster. A tile row's last cluster may hold blocks past the last tile
//   column: they load their share of A, skip B and store nothing; a share
//   of A that starts past the last row is not loaded (every box a block
//   loads starts inside the tensor).
// * Self-IoU: only tiles on and above the diagonal (the finish kernel
//   mirrors them); areas are the diagonal counts. Cross IoU: the blocks of
//   the first tile column count A's row areas and those of the first tile
//   row B's, from the same shared tiles (the swizzle permutes bytes within a
//   row, which a row sum does not see).
// * A wait that never ends traps (bar_wait_or_trap): the launch fails and
//   the wrapper raises.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

using namespace bff_wg;

constexpr int kTile = 128;       // output rows and columns of a block
constexpr int kChunk = 128;      // bytes of N a stage holds per row: one swizzle row
constexpr int kStages = 4;       // stages in flight
constexpr int kCluster = 2;      // blocks of a cluster (adjacent tile columns) sharing A
constexpr int kConsumers = 2;    // consumer warpgroups, 64 rows of A each
// keep a chunk's products in flight while the next chunk's issue (false: wait
// for them at the end of each chunk)
constexpr bool kOverlap = false;
constexpr int kThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kTileBytes = kTile * kChunk;       // 16 KB
constexpr int kStageBytes = 2 * kTileBytes;      // A, then B
constexpr int kSmemBytes = kStages * kStageBytes + 128 + 1024;

struct Barriers {
  uint64_t full[kStages], empty[kStages];
};

// Sum of the 16 0/1 bytes of a granule.
__device__ __forceinline__ unsigned count16(uint4 v, unsigned acc) {
  acc = __dp4a(v.x, 0x01010101u, acc);
  acc = __dp4a(v.y, 0x01010101u, acc);
  acc = __dp4a(v.z, 0x01010101u, acc);
  return __dp4a(v.w, 0x01010101u, acc);
}

// Half a 128-byte shared row: 64 bytes from p on.
__device__ __forceinline__ unsigned count64(const unsigned char* p, unsigned acc) {
  const uint4* g = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) acc = count16(g[k], acc);
  return acc;
}

// The output tile of cluster ``group``: its tile row and first tile column.
// A self-IoU walks the upper triangle (tile columns j >= i), a cross IoU
// every tile column.
__device__ __forceinline__ void group_tile(int group, int self, int tiles_i, int tiles_j,
                                           int* ti, int* tj0) {
  if (self) {
    int i = 0;
    for (;; ++i) {
      const int n = (tiles_j - i + kCluster - 1) / kCluster;
      if (group < n) break;
      group -= n;
    }
    *ti = i;
    *tj0 = i + group * kCluster;
  } else {
    const int per = (tiles_j + kCluster - 1) / kCluster;
    *ti = group / per;
    *tj0 = (group % per) * kCluster;
  }
  (void)tiles_i;
}

__global__ void __launch_bounds__(kThreads, 1)
iou_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                 int Ia, int Ib, long long N, int self, int tiles_i, int tiles_j,
                 long long split_len, int* __restrict__ inter, int* __restrict__ area_a,
                 int* __restrict__ area_b) {
  extern __shared__ __align__(1024) unsigned char iou_smem_raw[];
  unsigned char* smem = iou_smem_raw + ((1024 - (smem_u32(iou_smem_raw) & 1023)) & 1023);
  Barriers* bars = reinterpret_cast<Barriers*>(smem + kStages * kStageBytes);

  const uint32_t rank = kCluster > 1 ? cluster_rank() : 0;
  int ti, tj0;
  group_tile(blockIdx.x / kCluster, self, tiles_i, tiles_j, &ti, &tj0);
  const int tj = tj0 + (int)rank;
  const bool past = tj >= tiles_j;  // a block past the last tile column
  const int row0 = ti * kTile, col0 = tj * kTile;
  const long long k0 = (long long)blockIdx.y * split_len;
  const int chunks = (int)((min(N, k0 + split_len) - k0 + kChunk - 1) / kChunk);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      bar_init(&bars->full[st], 1);
      bar_init(&bars->empty[st], 4 * kConsumers * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (kCluster > 1)
    cluster_sync();  // every barrier of the cluster is initialised
  else
    __syncthreads();

  if (threadIdx.x >= 128 * kConsumers) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 128 * kConsumers) {
      constexpr int share = kTile / kCluster;  // rows of A this block loads
      const uint16_t mask = (uint16_t)((1u << kCluster) - 1u);
      // shares that start past the last row are not loaded (their rows are
      // never stored), nor is B in a block past the last tile column
      int a_bytes = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        if (row0 + r * share < Ia) a_bytes += share * kChunk;
      const bool load_a = row0 + (int)rank * share < Ia;
      const int b_bytes = past ? 0 : kTileBytes;
      for (int c = 0; c < chunks; ++c) {
        const int st = c % kStages, parity = ((c / kStages) & 1) ^ 1;
        bar_wait_or_trap(&bars->empty[st], parity);
        bar_expect_tx(&bars->full[st], a_bytes + b_bytes);
        unsigned char* sa = smem + st * kStageBytes;
        const int k = (int)(k0 + (long long)c * kChunk);
        if (kCluster > 1 && load_a)
          tma_load_2d_multicast(sa + rank * share * kChunk, &ta, &bars->full[st], k,
                                row0 + (int)rank * share, mask);
        else if (kCluster == 1)
          tma_load_2d(sa, &ta, &bars->full[st], k, row0);
        if (!past) tma_load_2d(sa + kTileBytes, &tb, &bars->full[st], k, col0);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    const int wg = threadIdx.x / 128, lane = threadIdx.x & 31;
    const bool signals = lane == 0;  // one arrival per consumer warp and block
    const bool count_a = !self && tj == 0, count_b = !self && ti == 0 && !past;
    const int crow = threadIdx.x >> 1, chalf = (threadIdx.x & 1) * 64;
    unsigned na = 0, nb = 0;
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;

    auto release = [&](int st) {
      if (signals) {
        if (kCluster > 1) {
#pragma unroll
          for (int r = 0; r < kCluster; ++r) bar_arrive_cluster(&bars->empty[st], r);
        } else {
          bar_arrive(&bars->empty[st]);
        }
      }
    };

    for (int c = 0; c < chunks; ++c) {
      const int st = c % kStages, parity = (c / kStages) & 1;
      bar_wait_or_trap(&bars->full[st], parity);
      const unsigned char* sa = smem + st * kStageBytes;
      if (count_a) na = count64(sa + crow * kChunk + chalf, na);
      if (count_b) nb = count64(sa + kTileBytes + crow * kChunk + chalf, nb);
      const uint32_t a_wg = smem_u32(sa) + wg * 64 * kChunk, b_t = smem_u32(sa) + kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 32; ++kk)
        wgmma_m64n128k32_s8(acc, sw128_desc(a_wg + kk * 32, 16), sw128_desc(b_t + kk * 32, 16),
                            1);
      wgmma_commit();
      if constexpr (kOverlap) {
        // ptxas serializes every wgmma of this form (C7515: the accumulators
        // stay in flight across the loop's back edge)
        wgmma_wait<1>();  // the products of chunk c - 1 are done
        if (c > 0) release((c - 1) % kStages);
      } else {
        // the other warpgroup's products keep the tensor cores busy meanwhile
        wgmma_wait<0>();
        fence_regs(acc);
        release(st);
      }
    }
    if constexpr (kOverlap) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (chunks > 0) release((chunks - 1) % kStages);
    }

    // partial counts of the slice: acc[4 j + e] at row lane / 4 + 8 (e / 2)
    // of the warp's 16 and column 8 j + 2 (lane % 4) + e % 2
    const int rbase = row0 + wg * 64 + ((threadIdx.x / 32) & 3) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rbase + 8 * (e >> 1), col = col0 + 8 * j + 2 * (lane & 3) + (e & 1);
        if (i < Ia && col < Ib && acc[4 * j + e])
          atomicAdd(inter + (long long)i * Ib + col, acc[4 * j + e]);
      }
    na += __shfl_xor_sync(0xffffffffu, na, 1);
    nb += __shfl_xor_sync(0xffffffffu, nb, 1);
    if ((threadIdx.x & 1) == 0) {
      if (count_a && na && row0 + crow < Ia) atomicAdd(area_a + row0 + crow, (int)na);
      if (count_b && nb && col0 + crow < Ib) atomicAdd(area_b + col0 + crow, (int)nb);
    }
  }
  // no block leaves while a peer may still arrive on its barriers or write
  // into its stages
  if (kCluster > 1) cluster_sync();
}

int encode_rows(EncodeTiled fn, CUtensorMap* map, const void* base, long long N, int rows,
                long long ld, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)box_rows};
  return encode_map(fn, map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// The routing predicate (kernels/mask_iou.py wgmma_route mirrors it): 1 when
// bff_mask_iou counts with this kernel. lda, ldb: row strides in bytes (b
// null: a self-IoU, ldb ignored).
extern "C" int bff_mask_iou_wgmma_takes(int Ia, int Ib, long long N, long long lda,
                                        long long ldb, const void* a, const void* b) {
  if (b == nullptr) ldb = lda;
  return Ia >= 1 && Ib >= 1 && N >= 1 && N < (1LL << 31) && lda >= N && ldb >= N &&
         lda % 16 == 0 && ldb % 16 == 0 && lda < (1LL << 39) && ldb < (1LL << 39) &&
         aligned16(a) && (b == nullptr || aligned16(b));
}

// Adds the intersection counts of every pair that a self-IoU's upper
// triangle of 128 x 128 tiles (or a cross IoU's every tile) holds to inter
// (Ia x Ib int32, zeroed by the caller), and a cross IoU's row areas to
// area_a and area_b. Returns cudaGetLastError() after the launch, -1 for
// arguments outside the predicate, -2 when cuTensorMapEncodeTiled is not
// found, -3 / -1000 - CUresult for a refused map.
extern "C" int bff_mask_iou_wgmma_count(const void* a, const void* b, int Ia, int Ib,
                                        long long N, long long lda, long long ldb, int* inter,
                                        int* area_a, int* area_b, void* stream) {
  if (!bff_mask_iou_wgmma_takes(Ia, Ib, N, lda, ldb, a, b) || (b == nullptr && Ib != Ia))
    return -1;
  const int self = b == nullptr;
  if (self) {
    b = a;
    ldb = lda;
  }
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  CUtensorMap ta, tb;
  int rc = encode_rows(fn, &ta, a, N, Ia, lda, kTile / kCluster);
  if (rc == 0) rc = encode_rows(fn, &tb, b, N, Ib, ldb, kTile);
  if (rc != 0) return rc;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        iou_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles_i = (Ia + kTile - 1) / kTile, tiles_j = (Ib + kTile - 1) / kTile;
  long long groups = 0;
  if (self) {
    for (int i = 0; i < tiles_i; ++i) groups += (tiles_j - i + kCluster - 1) / kCluster;
  } else {
    groups = (long long)tiles_i * ((tiles_j + kCluster - 1) / kCluster);
  }
  const long long blocks = groups * kCluster;
  // split N into one wave of one block per SM, at least 4 chunks a slice
  const long long chunks = (N + kChunk - 1) / kChunk;
  long long splits = std::max(1LL, (long long)sms / blocks);
  splits = std::max(1LL, std::min({splits, chunks / 4, 65535LL}));
  const long long split_len = ((chunks + splits - 1) / splits) * kChunk;
  splits = (N + split_len - 1) / split_len;
  if (blocks > 0x7fffffffLL) return -1;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)splits, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, iou_wgmma_kernel, ta, tb, Ia, Ib, N, self, tiles_i, tiles_j,
                         split_len, inter, area_a, area_b);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
