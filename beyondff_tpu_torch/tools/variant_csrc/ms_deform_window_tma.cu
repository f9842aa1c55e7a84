// The Grounding-DINO encoder's windowed deformable sampling on Hopper
// (sm_90a): every level's window staged in shared memory by TMA.
//
// Replaces the TPU kernel beyondff_tpu/kernels/deform_window.py
// sample_level_windowed (:170, pallas_call :240, body _kernel): the clamp
// semantics of csrc/ms_deform_sample.cu (each query of the all-level raster
// owns the window of its tile in each level, tile_origin - radius and w3 =
// tile + 2 radius wide; samples clamp into it, contribute 0 unless -1 < g <
// size on both axes, and corners outside the map read 0). The TPU kernel
// keeps a tile's window in VMEM and serves every sample of the tile from
// it; this kernel does the same with shared memory. It takes the calls that
// bff_ms_deform_staged_takes accepts: the all-level raster queries (Q = S)
// with every level in clamp mode, head dim 32, 4 points, at most 4 levels,
// bf16, 16-byte aligned tensors, and a staging plan
// (tools/deform_staged.device_plan) whose boxes fit. It loses to the gather
// kernel of csrc/ms_deform_sample.cu at the encoder raster (PERF.md section
// 6), so it is not part of the port's library: it lives here, outside
// csrc/, and only tools/kernel_variants.py builds it (the k1_staged*
// variants, with csrc/'s headers), holds its entry bff_ms_deform_staged
// against the plain version and times it.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. At the 800x1072 encoder raster,
// batch 4, bf16: value 36.5 MB, locations 73.0 MB, weights 18.2 MB, output
// 36.5 MB: 0.049 ms. The gather kernel loads 1.48 GB of 64-byte corner rows
// (2.33 GB counting the corners off the map) through L1 and L2, and issues
// one unpack and one FMA per channel of every corner.
//
// Design:
// * Blocks. A work item is one (batch, level-0 tile, head); its queries are
//   the raster queries of every level whose centre falls in that level-0
//   tile (build_assignment's buckets at level 0). A persistent grid, one
//   block per SM, walks the items; the producer warp runs ahead of the
//   consumers across item boundaries.
// * What a block stages. Windows do not nest across levels (level-0 row 16k
//   has level-1 centre 8k - 0.25, in level-1 tile k - 1), so at levels 1-3
//   an item's queries have up to 2 x 2 window origins. Per level, the item
//   stages the bounding box of its queries' windows: a host table, built
//   once per (shapes, modes) and kept on the device, gives each item's box
//   origin per level and each level's box size (the largest over items: at
//   Swin-B's four levels 32 x 32 cells everywhere, staged 32 x 36 wide, 72
//   KB a head in bf16).
// * Copies. The producer warp loads each box by TMA through a 5-D tensor map
//   over (channels, heads, W_l, H_l, batch) of the level's slice of value;
//   TMA zero-fills cells outside the map, which is the clamp semantics'
//   "corners outside the map read 0" for free. Two stages on full and empty
//   mbarriers: the next level's (or item's) box loads while the consumers
//   sample this one.
// * Sampling on the tensor cores, as the TPU kernel samples on its MXU: a
//   query's level is a 32-channel sum over its 16 corner rows (4 points x 4
//   corners), out = A w with A the (channels x corners) gathered rows and w
//   the bilinear x attention weights, which is one bf16 mma.sync
//   m16n8k16 per 16 channels with the weights in column 0 of B (rounded to
//   bf16 as the TPU kernel's one-hot weight matrix is; products summed in
//   f32). A's fragments come by ldmatrix.x4.trans straight from the staged
//   box, each lane pointing at one corner row; B's by ldmatrix.x2 from a
//   small per-warp table of weights. Per pass a warp takes 8 queries: each
//   lane first does the clamp arithmetic of one point (that of the gather
//   kernel, the same roundings), then the warp runs 2 mma per query.
// * Bank conflicts. An ldmatrix phase reads 8 corner rows of two points at
//   one 16-byte chunk. In a dense box of 64-byte cells those fall on 2 of the
//   8 bank groups (4 wavefronts); the maps write the box with the 64-byte
//   swizzle and a width that is 4 mod 8 cells (36 for the 32-cell windows),
//   which puts each point's 4 corners on 4 distinct groups (1.75 wavefronts
//   on average, counted for random points).
// * Levels meet in a shared f32 row per query (channels permuted to the
//   mma's output lanes); the last level writes the output.
// * Streamed inputs. Locations, weights and window origins are read once,
//   by 8-byte loads issued one task ahead (the query index two ahead), so
//   their latency overlaps the sampling of the task before.
// * A query whose window falls outside its item's box (none at the main
//   path's shapes; the CPU tests count them) reads its corners from global
//   memory in the same kernel, lane by channel in f32. A wait that never
//   ends traps.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "wgmma.cuh"

namespace {

using namespace bff_wg;

// The box of a 5-D map at (c0, ..., c4) into dst, reported to ``bar``.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

constexpr int kD = 32;              // head dim: a cell is 64 bytes of bf16
constexpr int kRow = kD * 2;
constexpr int kP = 4;               // points a level
constexpr int kMaxL = 4;            // levels
constexpr int kConsumerWarps = 16;
constexpr int kThreads = 32 * (kConsumerWarps + 1);  // the producer is the last warp
constexpr int kStages = 2;
constexpr int kQpw = 8;                          // queries a warp takes per pass
constexpr int kQpp = kQpw * kConsumerWarps;      // queries a pass
constexpr int kWBytes = kQpw * 16 * 2;           // a warp's weight table: 8 x 16 bf16
constexpr int kSmemLimit = 227 * 1024;

struct Maps {
  CUtensorMap m[kMaxL];
};

struct Plan {
  int T, s_pad, L, Q, H, B, S;
  int hh[kMaxL], ww[kMaxL], start[kMaxL], w3[kMaxL];
  int by[kMaxL], bx[kMaxL], box_bytes[kMaxL];
  int stage_bytes;  // the largest box, rounded up to 1024
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

// The byte of a 64-byte-swizzled box (CU_TENSOR_MAP_SWIZZLE_64B) that holds
// dense byte ``off``: the 16-byte chunk index XOR bits 7-8.
__device__ __forceinline__ uint32_t swz64(uint32_t off) { return off ^ (((off >> 7) & 3u) << 4); }

// A consumer's place in the flat sequence of tasks: (item, level, pass),
// items with no query skipped. The producer walks the same items.
struct Cursor {
  int item, l, pass, tile, b, h, count, npass;
};

__device__ __forceinline__ void begin_item(Cursor& c, int item, int items, const Plan& pl,
                                           const int* counts) {
  for (; item < items; item += gridDim.x) {
    const int tile = (item / pl.H) % pl.T;
    const int n = __ldg(counts + tile);
    if (n > 0) {
      c = Cursor{item, 0, 0, tile, item / (pl.H * pl.T), item % pl.H, n, (n + kQpp - 1) / kQpp};
      return;
    }
  }
  c.item = items;
}

__device__ __forceinline__ void advance(Cursor& c, int items, const Plan& pl, const int* counts) {
  if (c.item >= items) return;
  if (++c.pass < c.npass) return;
  c.pass = 0;
  if (++c.l < pl.L) return;
  begin_item(c, c.item + gridDim.x, items, pl, counts);
}

// What a lane reads ahead for a task: its point's location and weight and
// the query's window origin at the task's level.
struct Ahead {
  float lx, ly, a;
  int oy, ox;
};

__device__ __forceinline__ Ahead load_ahead(const Cursor& c, int q, int items, int pt,
                                            const Plan& pl, const float* locs,
                                            const __nv_bfloat16* aw, const int* origin) {
  Ahead r{0.f, 0.f, 0.f, 0, 0};
  if (c.item >= items || q < 0) return r;
  const long long row = ((long long)c.b * pl.Q + q) * pl.H + c.h;
  const float2 xy = __ldg(reinterpret_cast<const float2*>(locs + (row * pl.L + c.l) * kP * 2) + pt);
  const int2 o = __ldg(reinterpret_cast<const int2*>(origin) + (long long)c.l * pl.Q + q);
  r.lx = xy.x;
  r.ly = xy.y;
  r.a = __bfloat162float(aw[(row * pl.L + c.l) * kP + pt]);
  r.oy = o.x;
  r.ox = o.y;
  return r;
}

__global__ void __launch_bounds__(kThreads, 1)
staged_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Plan pl,
              const __nv_bfloat16* __restrict__ value, const float* __restrict__ locs,
              const __nv_bfloat16* __restrict__ aw, const int* __restrict__ origin,
              const int* __restrict__ plan, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char msd_smem_raw[];
  unsigned char* smem = msd_smem_raw + ((1024 - (smem_u32(msd_smem_raw) & 1023)) & 1023);
  float* sacc = reinterpret_cast<float*>(smem + kStages * pl.stage_bytes);  // (s_pad, 32) f32
  unsigned char* wtab = reinterpret_cast<unsigned char*>(sacc + pl.s_pad * kD);
  unsigned char* zero = wtab + kConsumerWarps * kWBytes;  // 64 zero bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + 64);
  uint64_t* empty = full + kStages;
  const int* qidx = plan;                          // (T, s_pad) raster query of each slot
  const int* boxorg = plan + pl.T * pl.s_pad;      // (T, L, 2) box origin (row, col) per level
  const int* counts = boxorg + pl.T * pl.L * 2;    // (T,) queries of each level-0 tile
  const int items = pl.B * pl.T * pl.H;

  if (threadIdx.x < 16) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 32 * kConsumerWarps) {
    // ------------------------------------------------------------ producer
    if (threadIdx.x == 32 * kConsumerWarps) {
      int uses = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int tile = (item / pl.H) % pl.T;
        if (__ldg(counts + tile) == 0) continue;
        const int b = item / (pl.H * pl.T), h = item % pl.H;
        for (int l = 0; l < pl.L; ++l, ++uses) {
          const int s = uses % kStages;
          bar_wait_or_trap(&empty[s], ((uses / kStages) & 1) ^ 1);
          const int2 o = __ldg(reinterpret_cast<const int2*>(boxorg) + tile * pl.L + l);
          bar_expect_tx(&full[s], pl.box_bytes[l]);
          tma_load_5d(smem + s * pl.stage_bytes, &maps.m[l], &full[s], 0, h, o.y, o.x, b);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // step 1: lane = 4 query + point
  const int qj = lane >> 2, pt = lane & 3;
  // step 2: the corner row this lane points ldmatrix at (A: rows k = corners
  // 4 point + 2 dy + dx, 16-byte chunk 0 or 1 of each 16-channel half), its
  // row of B (weights of query j in row 0, zeros elsewhere), and the lanes
  // that hold results (column 0 of the mma: channel g and g + 8)
  const int ka = (lane & 7) + 8 * (lane >> 4);
  const int src_p = ka >> 2, dy_a = (ka >> 1) & 1, dx_a = ka & 1;
  const uint32_t chunk_a = 16u * ((lane >> 3) & 1);
  const uint32_t wtab_w = smem_u32(wtab) + warp * kWBytes, zero_u = smem_u32(zero);
  const bool b_row0 = lane == 0 || lane == 8;
  const uint32_t b_addr = b_row0 ? wtab_w + (lane >> 3) * 16 : zero_u;
  const int g = lane >> 2;
  const bool holds = (lane & 3) == 0;

  auto slot_q = [&](const Cursor& c) {
    const int slot = c.pass * kQpp + warp * kQpw + qj;
    return c.item < items && slot < c.count ? __ldg(qidx + c.tile * pl.s_pad + slot) : -1;
  };

  Cursor t;
  begin_item(t, blockIdx.x, items, pl, counts);
  int q = slot_q(t);
  Ahead ld = load_ahead(t, q, items, pt, pl, locs, aw, origin);
  Cursor t1 = t;
  advance(t1, items, pl, counts);
  int q1 = slot_q(t1);
  int uses = 0, s = 0, boy = 0, box = 0;

  while (t.item < items) {
    const int l = t.l;
    if (t.pass == 0) {
      s = uses % kStages;
      bar_wait_or_trap(&full[s], (uses / kStages) & 1);
      ++uses;
      const int2 o = __ldg(reinterpret_cast<const int2*>(boxorg) + t.tile * pl.L + l);
      boy = o.x;
      box = o.y;
    }
    // the next task's loads, and the query of the one after it
    Cursor t2 = t1;
    advance(t2, items, pl, counts);
    const int q2 = slot_q(t2);
    const Ahead ld1 = load_ahead(t1, q1, items, pt, pl, locs, aw, origin);

    // ---- step 1: this lane's point, the gather kernel's clamp arithmetic
    const int hh = pl.hh[l], ww = pl.ww[l], w3 = pl.w3[l], by = pl.by[l], bx = pl.bx[l];
    const float gx = __fsub_rn(__fmul_rn(ld.lx, (float)ww), 0.5f);
    const float gy = __fsub_rn(__fmul_rn(ld.ly, (float)hh), 0.5f);
    const bool live = q >= 0 && gy > -1.f && gy < (float)hh && gx > -1.f && gx < (float)ww;
    const float ry = fminf(fmaxf(__fsub_rn(gy, (float)ld.oy), 0.f), (float)(w3 - 2));
    const float rx = fminf(fmaxf(__fsub_rn(gx, (float)ld.ox), 0.f), (float)(w3 - 2));
    const float ry0 = floorf(ry), rx0 = floorf(rx);
    const float fy = __fsub_rn(ry, ry0), fx = __fsub_rn(rx, rx0);
    const int y0 = (int)ry0 + ld.oy, x0 = (int)rx0 + ld.ox;
    const float wa = live ? ld.a : 0.f;
    float wc[4];  // corners (dy, dx) = (0, 0), (0, 1), (1, 0), (1, 1)
    wc[0] = (1.f - fy) * (1.f - fx) * wa;
    wc[1] = (1.f - fy) * fx * wa;
    wc[2] = fy * (1.f - fx) * wa;
    wc[3] = fy * fx * wa;
    // the window lies in the item's box (the same on the query's 4 lanes):
    // the corner (0, 0)'s cell in the box; else -1 (read from global memory)
    const bool inbox = q >= 0 && ld.oy >= boy && ld.oy + w3 <= boy + by && ld.ox >= box &&
                       ld.ox + w3 <= box + bx;
    const int cell = inbox ? (y0 - boy) * bx + (x0 - box) : -1;
    *reinterpret_cast<uint2*>(wtab + warp * kWBytes + qj * 32 + pt * 8) =
        make_uint2(bff_tc::pack_bf16(wc[0], wc[1]), bff_tc::pack_bf16(wc[2], wc[3]));
    __syncwarp();
    const unsigned far = __ballot_sync(0xffffffffu, q >= 0 && !inbox);
    const uint32_t stage = smem_u32(smem) + s * pl.stage_bytes;
    const __nv_bfloat16* vl =
        value + ((long long)t.b * pl.S + pl.start[l]) * pl.H * kD + t.h * kD;

    // ---- step 2: two mma per query
#pragma unroll
    for (int j = 0; j < kQpw; ++j) {
      const int cb = __shfl_sync(0xffffffffu, cell, 4 * j + src_p);
      const int qq = __shfl_sync(0xffffffffu, q, 4 * j);
      uint32_t a_lo = zero_u, a_hi = zero_u;
      if (cb >= 0) {
        a_lo = stage + swz64((uint32_t)(cb + dy_a * bx + dx_a) * kRow + chunk_a);
        a_hi = a_lo ^ 32u;  // channels 16-31: chunk + 2, the same swizzle key
      }
      uint32_t alo[4], ahi[4], bw[2];
      ldsm_x4_trans(alo, a_lo);
      ldsm_x4_trans(ahi, a_hi);
      ldsm_x2(bw, b_row0 ? b_addr + j * 32 : zero_u);
      float dlo[4] = {0.f, 0.f, 0.f, 0.f}, dhi[4] = {0.f, 0.f, 0.f, 0.f};
      bff_tc::mma_bf16(dlo, alo, bw[0], bw[1]);
      bff_tc::mma_bf16(dhi, ahi, bw[0], bw[1]);
      if (far & (1u << (4 * j))) {
        // a window outside the box: lane = channel, the corners from global
        // memory in f32 (zero off the map), then to the mma's result lanes
        float r = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int sl = 4 * j + (k >> 2), dy = (k >> 1) & 1, dx = k & 1;
          const int yy = __shfl_sync(0xffffffffu, y0, sl) + dy;
          const int xx = __shfl_sync(0xffffffffu, x0, sl) + dx;
          const float w = __shfl_sync(0xffffffffu, wc[k & 3], sl);
          if (yy >= 0 && yy < hh && xx >= 0 && xx < ww)
            r = fmaf(w, __bfloat162float(vl[((long long)yy * ww + xx) * pl.H * kD + lane]), r);
        }
        dlo[0] += __shfl_sync(0xffffffffu, r, g);
        dlo[2] += __shfl_sync(0xffffffffu, r, g + 8);
        dhi[0] += __shfl_sync(0xffffffffu, r, g + 16);
        dhi[2] += __shfl_sync(0xffffffffu, r, g + 24);
      }
      if (holds && qq >= 0) {
        // channels g, g + 8, g + 16, g + 24 of query j, kept at 4 g .. 4 g + 3
        float4* a = reinterpret_cast<float4*>(sacc + (t.pass * kQpp + warp * kQpw + j) * kD +
                                              4 * g);
        float4 v = make_float4(dlo[0], dlo[2], dhi[0], dhi[2]);
        if (l > 0) {
          const float4 p = *a;
          v.x += p.x;
          v.y += p.y;
          v.z += p.z;
          v.w += p.w;
        }
        if (l < pl.L - 1) {
          *a = v;
        } else {
          __nv_bfloat16* o = out + (((long long)t.b * pl.Q + qq) * pl.H + t.h) * kD + g;
          o[0] = __float2bfloat16_rn(v.x);
          o[8] = __float2bfloat16_rn(v.y);
          o[16] = __float2bfloat16_rn(v.z);
          o[24] = __float2bfloat16_rn(v.w);
        }
      }
    }
    if (t.pass == t.npass - 1) {
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with the stage
    }
    __syncwarp();  // the weight table is read before the next task writes it
    t = t1;
    q = q1;
    ld = ld1;
    t1 = t2;
    q1 = q2;
  }
}

int smem_bytes(const Plan& pl) {
  return kStages * pl.stage_bytes + pl.s_pad * kD * 4 + kConsumerWarps * kWBytes + 64 +
         2 * kStages * 8 + 1024;
}

// The plan from the host rows: levels (h, w, start, w3) per level, meta (T,
// s_pad, then (by, bx) per level). False for what the kernel does not take.
bool make_plan(Plan* pl, int B, int S, int Q, int H, int L, const int* levels, const int* meta) {
  if (L < 1 || L > kMaxL || meta == nullptr || B < 1 || H < 1 || Q != S) return false;
  *pl = Plan{};
  pl->T = meta[0];
  pl->s_pad = meta[1];
  pl->L = L;
  pl->Q = Q;
  pl->H = H;
  pl->B = B;
  pl->S = S;
  if (pl->T < 1 || pl->s_pad < 1 || pl->s_pad % 32 != 0) return false;
  int largest = 0;
  for (int l = 0; l < L; ++l) {
    pl->hh[l] = levels[4 * l];
    pl->ww[l] = levels[4 * l + 1];
    pl->start[l] = levels[4 * l + 2];
    pl->w3[l] = levels[4 * l + 3];
    pl->by[l] = meta[2 + 2 * l];
    pl->bx[l] = meta[3 + 2 * l];
    if (pl->w3[l] < 2 || pl->by[l] < 1 || pl->by[l] > 256 || pl->bx[l] < 1 || pl->bx[l] > 256)
      return false;
    pl->box_bytes[l] = pl->by[l] * pl->bx[l] * kRow;
    largest = largest > pl->box_bytes[l] ? largest : pl->box_bytes[l];
  }
  pl->stage_bytes = (largest + 1023) / 1024 * 1024;
  return smem_bytes(*pl) <= kSmemLimit && (long long)S * H * kD < (1LL << 31) &&
         (long long)B * pl->T * H < (1LL << 31);
}

}  // namespace

// What the kernel takes: 1 when bff_ms_deform_staged runs the call.
// dtype: 0 = float32, 1 = bfloat16; levels: L rows (h, w, start, w3); meta:
// the plan's host rows (T, s_pad, then (by, bx) per level), null when the
// caller has none.
extern "C" int bff_ms_deform_staged_takes(int dtype, int B, int S, int Q, int H, int D, int L,
                                          int P, const int* levels, const int* meta,
                                          const void* value, const void* locs, const void* aw,
                                          const void* out) {
  if (dtype != 1 || D != kD || P != kP || L < 1 || L > kMaxL) return 0;
  for (int l = 0; l < L; ++l)
    if (levels[4 * l + 3] <= 0) return 0;
  if (!aligned16(value) || !aligned16(locs) || !aligned16(aw) || !aligned16(out)) return 0;
  Plan pl;
  return make_plan(&pl, B, S, Q, H, L, levels, meta);
}

// value (B, S, H, 32), aw (B, Q, H, L, 4) and out (B, Q, H * 32) bf16; locs
// (B, Q, H, L, 4, 2) f32; origin (L, Q, 2) int32 window origins; plan: the
// device table (qidx (T, s_pad), box origins (T, L, 2), counts (T)).
// Returns cudaGetLastError() after the launch, -1 outside the predicate, -2
// when cuTensorMapEncodeTiled is not found, -3 / -1000 - CUresult for a
// refused map.
extern "C" int bff_ms_deform_staged(int dtype, const void* value, const void* locs,
                                    const void* aw, const void* origin, const void* plan,
                                    void* out, int B, int S, int Q, int H, int L,
                                    const int* levels, const int* meta, void* stream) {
  if (!bff_ms_deform_staged_takes(dtype, B, S, Q, H, kD, L, kP, levels, meta, value, locs, aw,
                                  out) ||
      origin == nullptr || plan == nullptr)
    return -1;
  Plan pl;
  make_plan(&pl, B, S, Q, H, L, levels, meta);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -2;
  Maps maps;
  for (int l = 0; l < L; ++l) {
    const cuuint64_t dims[5] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)pl.ww[l],
                                (cuuint64_t)pl.hh[l], (cuuint64_t)B};
    const cuuint64_t strides[4] = {(cuuint64_t)kRow, (cuuint64_t)H * kRow,
                                   (cuuint64_t)pl.ww[l] * H * kRow, (cuuint64_t)S * H * kRow};
    const cuuint32_t box[5] = {(cuuint32_t)kD, 1, (cuuint32_t)pl.bx[l], (cuuint32_t)pl.by[l], 1};
    const __nv_bfloat16* base =
        static_cast<const __nv_bfloat16*>(value) + (long long)pl.start[l] * H * kD;
    const int rc = encode_map(fn, &maps.m[l], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims,
                              strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
    if (rc != 0) return rc;
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int items = B * pl.T * H;
  const int grid = items < sms ? items : sms;
  staged_kernel<<<grid, kThreads, smem_bytes(pl), static_cast<cudaStream_t>(stream)>>>(
      maps, pl, static_cast<const __nv_bfloat16*>(value), static_cast<const float*>(locs),
      static_cast<const __nv_bfloat16*>(aw), static_cast<const int*>(origin),
      static_cast<const int*>(plan), static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}
