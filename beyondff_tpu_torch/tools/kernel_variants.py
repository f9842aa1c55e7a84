"""Times variants of the port's CUDA kernels against the shipped sources on
one card, in one process, in alternating order.

    python -m beyondff_tpu_torch.tools.kernel_variants [--parent-csrc DIR] [--variants a,b]
        [--cases k1,k2,nms] [--out DIR]

A variant is the ``csrc`` tree with textual edits (each edit must match its
file exactly once), built from the sources it names; ``--parent-csrc`` adds
the variant ``parent``, built from another ``csrc`` tree (an earlier
commit's, unpacked with ``git archive``). Every source of every variant
compiles at once, one nvcc each (the port's flags plus ``-Xptxas -v``), into
a library under ``beyondff_tpu_torch/_build/variants``; each ptxas report is
written beside it. At every case a variant's output is held against the
plain version (mask IoU bit for bit with nan at the same places, bf16
attention within ``flash_attention.bf16_error_bound``, deformable sampling
(K1) within 1e-4 in f32 and 3e-2 in bf16) and its launches are timed with
CUDA events over a loop of calls, once in each of three rounds, the order of
the variants reversed every other round (the best round is reported); K1's
cases also take the device time per call from ``torch.profiler``
(``profiling.device_ms``), the rate of unique bytes it gives, the rate of
the corner rows it loads (``corner_gbps``: value rows of in-map corners,
each load counted) and the byte bound. K1's ``tile_order`` variant walks
the encoder raster's queries in the order :func:`tile_order` gives. K3's
cases (EfficientSAM-S's global blocks through ``bff_flash_attention``: the
wgmma kernel in this tree, the mma.sync tile in a tree from before it) and
K4's and K5's (SAM ViT-H's global and windowed blocks through the rel-pos
entries: the wgmma kernels of ``relpos_attention_wgmma.cu`` in this tree,
the mma.sync tile in a tree from before them) run
``scaled_dot_product_attention`` (with the rel-pos bias as a dense float
mask for K4 and K5) on the same inputs as one more entry of the same rounds
(``library``), and take device time, TFLOP/s and GB/s, the bound (the
larger of operations and bytes) and the host microseconds per call (the
enqueue, tensor maps included). K6's cases (aggregation's self-IoU and
refinement's cross IoU, rows padded to the main path's strides or not)
take ``torch._int_mm`` on int8 copies as their ``library`` entry and the
int8 peak for their bound. K1's variants ``k1_staged*`` add
``variant_csrc/ms_deform_window_tma.cu`` (the encoder's clamp call sampled
from TMA-staged windows, which lost to the gather and is in no path) and
time it at the bf16 encoder clamp cases on its own entry, with the plan of
``deform_staged.device_plan``. K2's cases (Grounding-DINO's decoder
self-attention at head dim 32 through ``bff_flash_attention``: the wgmma
kernel of ``flash_masked_wgmma.cu`` in this tree, the mma.sync tile in a
tree from before it) take SDPA, with a key mask where keys are masked, as
their ``library`` entry. The f32 cases (``--cases f32``: K2 and K3 in f32
at their main-path shapes, ``f32 small``, S 64 to 512, f32 at head dims 80,
96, 112 and 128, ``f32 wide`` at 144 to 256 (the wide 3xTF32 kernel with its
key mask), and ``f32 d48``, a shape both 3xTF32 routes refuse) go through
``bff_flash_attention`` (the 3xTF32 kernels in this tree, the FMA kernel in
a tree from before them, and as the entry ``fma`` of the same rounds through
``bff_flash_attention_f32_fma``), are held within 1e-4,
take SDPA in f32 and the plain version as yardsticks, ``bound_ms`` at
3xTF32 beside ``bound_fma_ms`` at the f32 FMA peak, and the pre-pass's
device time a call (``prepass_ms``); each output's digest beside it
(``digest``: a route that shares a kernel body stays bit for bit); the
``tf32_smem_split`` variant
builds ``variant_csrc/flash_attention_tf32_smem.cu`` (the split in shared
memory, no pre-pass) and runs on its own entry. The NMS case times the
call as the wrapper makes it (stable sort, gather, ``bff_nms_fixed``; ``bff_nms_bitmask`` for the
``nms_bitmask`` variant, ``variant_csrc/nms_bitmask.cu``), holds it index
for index against ``nms.nms_fixed_plain`` and splits its device time into
the sort, the gather and the scan (``nms.split_spans``), with the bound of the
IoU tests these boxes need at the f32 peak; the large-mode cases time
``bff_nms_fixed_large`` at 4 x 8 400 boxes and past the staged kernel's
90 112 a frame.
Prints one JSON line per (case, variant) with the card's name and power
limit; the lines also go to
``kernel_variants.json`` in ``--out`` (the build directory by default),
beside each variant's ptxas report.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from beyondff_tpu_torch.kernels import _build
from beyondff_tpu_torch.kernels import deform_window as dw
from beyondff_tpu_torch.kernels import flash_attention as fa
from beyondff_tpu_torch.kernels import mask_iou as kiou
from beyondff_tpu_torch.kernels import nms
from beyondff_tpu_torch.models import sam as sam_mod
from beyondff_tpu_torch.models.gdino import deformable
from beyondff_tpu_torch.tools import deform_staged
from beyondff_tpu_torch.utils.profiling import (HBM_BYTES_PER_S, PEAK_FLOPS, PEAK_TF32_FLOPS,
                                                device_ms, device_spans, f32_attention_bounds)

OUT = os.path.join(_build.BUILD_DIR, "variants")
RELPOS, IOU, MSD = "relpos_attention.cu", "mask_iou.cu", "ms_deform_sample.cu"
FLASH, WGMMA = "flash_attention.cu", "flash_attention_wgmma.cu"
FMW, NMS = "flash_masked_wgmma.cu", "nms_fixed.cu"
TF32 = "flash_attention_tf32.cu"
WIDE = "flash_attention_wide_wgmma.cu"
RWG = "relpos_attention_wgmma.cu"
RST = "relpos_attention_streamed.cu"
RT32 = "relpos_attention_tf32.cu"
RWW, RWT = "relpos_attention_wide_wgmma.cu", "relpos_attention_wide_tf32.cu"
IWG, MSW = "mask_iou_wgmma.cu", "ms_deform_window_tma.cu"
NMB = "nms_bitmask.cu"
TF32_SMEM = "flash_attention_tf32_smem.cu"
SOURCES = (RELPOS, IOU, MSD, FLASH, WGMMA, FMW, TF32, WIDE, RWG, RST, RT32, RWW, RWT, IWG, NMS)
# sources only variants build, copied beside csrc's (whose headers they use)
VARIANT_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "variant_csrc")
K1, K6 = (MSD,), (IOU, IWG)  # what a K1 or K6 variant builds
# what a K2 or K3 variant builds (one C entry routes all)
K3 = (FLASH, WGMMA, FMW, TF32, WIDE, RWT)
# what a K4 or K5 variant builds (the rel-pos entries route all)
K45 = (RELPOS, RWG, RST, RT32, RWW, RWT)
NMS_V = (NMS,)
K1_STAGED = (MSD, MSW)
ROUNDS = 3
F32_TOL = 1e-4  # f32 attention against its plain version
SET_ORDER = "bff_ms_deform_set_order"

# K1's row walk, which the query-order variants replace
_RASTER_ROWS = """  if (r >= (long long)B * Q * H) return;
  const int h = (int)(r % H);
  const int q = (int)(r / H % Q);
  const int b = (int)(r / H / Q);
  const long long row = r;  // (b * Q + q) * H + h
"""


def _head_run(warps):
    """K1's rows walk ``warps`` warps' worth of queries of one head before
    the next head (the last run padded past Q)."""
    run = f"const int run = ({warps} * 32 + lanes - 1) / lanes;"
    return (K1, (
        (MSD, _RASTER_ROWS, f"""  {run}
  const int runs = (Q + run - 1) / run;
  if (r >= (long long)B * runs * run * H) return;
  const int h = (int)(r / run % H);
  const int q = (int)(r / run / H % runs) * run + (int)(r % run);
  const int b = (int)(r / run / H / runs);
  if (q >= Q) return;
  const long long row = ((long long)b * Q + q) * H + h;
"""),
        (MSD, "  const long long rows = (long long)g.B * g.Q * g.H;\n",
         f"  {run}\n  const long long rows = "
         "(long long)g.B * ((g.Q + run - 1) / run) * run * g.H;\n")))


def _k5_pingpong():
    """K5's consumers take turns to issue each product: a turn before the
    scores and before P V, handed on after each commit."""
    scores = "                            sw32_desc(base + kWKHi, 16), 1);\n        wgmma_commit();\n"
    pv = ("          wgmma_m64n16k16_rs(o_hi, p[kk], sw32_desc(base + kWVHi + kk * 512, 256), kk);"
          "\n        }\n        wgmma_commit();\n")
    hand_on = "        turn_arrive(next_turn);\n"
    take = "        turn_sync(my_turn);\n"
    row = ("    const int wrow = ((threadIdx.x / 32) & 3) * 16 + lane / 4;"
           "  // the lane's row of an m-tile\n")
    done = ("      if (lane == 0) bar_arrive(&bars->empty[st]);"
            "  // one arrival per consumer warp\n    }\n")
    return (
        (RWG, row, row + "    const int my_turn = 1 + wg, next_turn = 1 + (wg + 1) % kWConsumers;\n"
                         "    if (wg == 1) turn_arrive(next_turn);\n"),
        (RWG, "        float s[kWKeys / 2];\n", "        float s[kWKeys / 2];\n" + take),
        (RWG, scores, scores + hand_on),
        (RWG, "        float o_lo[32], o_hi[8];\n", "        float o_lo[32], o_hi[8];\n" + take),
        (RWG, pv, pv + hand_on),
        (RWG, done, done + "    if (wg == 0) turn_sync(my_turn);\n"))


# K2's exponentials of one n8 column tile j of a score tile
_K2_EXP = """    s[4 * j] = bff_tc::exp2_approx(fmaf(s[4 * j], sl2, -m[0]));
    s[4 * j + 1] = bff_tc::exp2_approx(fmaf(s[4 * j + 1], sl2, -m[0]));
    s[4 * j + 2] = bff_tc::exp2_approx(fmaf(s[4 * j + 2], sl2, -m[1]));
    s[4 * j + 3] = bff_tc::exp2_approx(fmaf(s[4 * j + 3], sl2, -m[1]));
"""

# 2^x on the FMA and integer units: x = n + f with n = rint(x) (the 1.5 *
# 2^23 shift) and f in [-1/2, 1/2]; 2^f by a degree-3 minimax (relative
# error 7.5e-5 on the interval); n added to the exponent field (the shifted
# float's low bits hold n, and its other bits shift out of the word). x is
# clamped at -125 so that 2^n stays normal; below that the result is 0, as
# ex2.approx.ftz gives, and -inf (a masked key) gives 0.
_K2_EXP2_POLY = """__device__ __forceinline__ float exp2_poly(float x) {
  const float xc = fmaxf(x, -125.f);
  const float t = __fadd_rn(xc, 12582912.f);
  const float f = __fsub_rn(xc, __fsub_rn(t, 12582912.f));
  float p = fmaf(0x1.c3f76p-5f, f, 0x1.f0de1ap-3f);
  p = fmaf(p, f, 0x1.62f31ap-1f);
  p = fmaf(p, f, 0x1.fff692p-1f);
  const float r = __uint_as_float(__float_as_uint(p) + (__float_as_uint(t) << 23));
  return x < -125.f ? 0.f : r;
}

__device__ __forceinline__ float exp2_tile(float x, int j) {
  return j < kPolyTiles ? exp2_poly(x) : bff_tc::exp2_approx(x);
}

"""


def _k2_poly(tiles):
    """K2 with the 2^x of the first ``tiles`` n8 column tiles (of 8) of each
    score tile as a polynomial on the FMA units, the rest on the
    special-function unit (shipped: every one there)."""
    scores = "// S = Q K^T for the warpgroup's 64 rows"
    return (K3, (
        (FMW, scores, f"constexpr int kPolyTiles = {tiles};\n\n" + _K2_EXP2_POLY + scores),
        (FMW, _K2_EXP, _K2_EXP.replace("bff_tc::exp2_approx(fmaf(", "exp2_tile(fmaf(")
         .replace("));", "), j);"))))


# the NMS entry's first launch attribute, after which a cluster above the
# portable 8 blocks must be allowed
_NMS_SMEM_ATTR = """    const cudaError_t err = cudaFuncSetAttribute(
        nms_fixed_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
"""


# name -> (sources to build, edits as (file, old, new))
VARIANTS = {
    # the tree as it stands, every source: the shipped kernels beside the
    # variants that edit them
    "shipped": (SOURCES, ()),
    # K1: a warp's rows are 8 queries of one head (not one query's 8 heads)
    "head_run_warp": _head_run(1),
    # K1: a block's rows are 64 queries of one head
    "head_run_block": _head_run(8),
    # K1: the rows walk a query permutation set by bff_ms_deform_set_order
    # (null: the raster), each output at its query's own index
    "tile_order": (K1, (
        (MSD, "constexpr int kThreads = 256;\n",
         "constexpr int kThreads = 256;\n__device__ const int* g_order;\n"),
        (MSD, _RASTER_ROWS, _RASTER_ROWS.replace(
            "const int q = (int)(r / H % Q);",
            "const int q = g_order ? __ldg(g_order + r / H % Q) : (int)(r / H % Q);").replace(
            "const long long row = r;  // (b * Q + q) * H + h",
            "const long long row = ((long long)b * Q + q) * H + h;")),
        (MSD, 'extern "C" int bff_ms_deform_sample(',
         'extern "C" int ' + SET_ORDER + '(const void* order) {\n'
         '  const int* p = static_cast<const int*>(order);\n'
         '  return (int)cudaMemcpyToSymbol(g_order, &p, sizeof(p));\n}\n\n'
         'extern "C" int bff_ms_deform_sample('))),
    # K1: registers for 2 or 4 blocks of 256 threads per SM (shipped: 3)
    **{f"min_blocks_{n}": (K1, ((MSD, "constexpr int kMinBlocks = 3;",
                                     f"constexpr int kMinBlocks = {n};"),)) for n in (2, 4)},
    # K1: one point's four corners in flight instead of a level's sixteen, or two points'
    "point_at_a_time": (K1, ((MSD, "constexpr int PB = PT > 0 ? PT : 1;",
                                  "constexpr int PB = 1;"),)),
    "two_points": (K1, ((MSD, "constexpr int PB = PT > 0 ? PT : 1;",
                             "constexpr int PB = PT > 0 ? 2 : 1;"),)),
    # K1 from TMA-staged windows (timed on its own entry at the bf16 encoder
    # clamp cases); then with dense boxes (no swizzle: ldmatrix meets 4-way
    # bank conflicts), 8 consumer warps (64 queries a pass) or one box stage
    # (no load ahead of the consumers)
    "k1_staged": (K1_STAGED, ()),
    "k1_staged_dense": (K1_STAGED, (
        (MSW, "uint32_t swz64(uint32_t off) { return off ^ (((off >> 7) & 3u) << 4); }",
         "uint32_t swz64(uint32_t off) { return off; }"),
        (MSW, "box, CU_TENSOR_MAP_SWIZZLE_64B);", "box, CU_TENSOR_MAP_SWIZZLE_NONE);"))),
    "k1_staged_warps_8": (K1_STAGED, ((MSW, "constexpr int kConsumerWarps = 16;",
                                "constexpr int kConsumerWarps = 8;"),)),
    "k1_staged_stages_1": (K1_STAGED, ((MSW, "constexpr int kStages = 2;",
                                 "constexpr int kStages = 1;"),)),
    # K6 on wgmma: no cluster (every block loads its own A), or clusters of 4
    "k6_no_multicast": (K6, ((IWG, "constexpr int kCluster = 2;", "constexpr int kCluster = 1;"),)),
    "k6_cluster_4": (K6, ((IWG, "constexpr int kCluster = 2;", "constexpr int kCluster = 4;"),)),
    # K6 on wgmma: a chunk's products kept in flight while the next chunk's
    # issue (ptxas serializes them, C7515)
    "k6_overlap": (K6, ((IWG, "constexpr bool kOverlap = false;",
                         "constexpr bool kOverlap = true;"),)),
    # K6 on wgmma: 3 or 6 stages in flight (shipped: 4)
    **{f"k6_stages_{n}": (K6, ((IWG, "constexpr int kStages = 4;",
                                f"constexpr int kStages = {n};"),)) for n in (3, 6)},
    # K6's unaligned rows loaded after the mma instead of before it
    "load_after_mma": (K6, (
        (IOU, "    if (c + 1 < chunks) cr.load(g, c + 1);  // in flight during the mma\n", ""),
        (IOU, "    if (c + 1 < chunks) cr.cut(",
         "    if (c + 1 < chunks) cr.load(g, c + 1);\n    if (c + 1 < chunks) cr.cut("))),
    # K6's unaligned rows cut 128 bytes a step
    "cut128": (K6, ((IOU, "constexpr int kCut = 64;", "constexpr int kCut = 128;"),)),
    # K3: tile t's Q K^T after tile t - 1's P V has finished, not before it
    "k3_serial": (K3, ((WGMMA, "constexpr bool kOverlap = true;",
                                    "constexpr bool kOverlap = false;"),)),
    # K3: three K and V tiles in flight
    "k3_stages_3": (K3, ((WGMMA, "constexpr int kStages = 2;",
                                      "constexpr int kStages = 3;"),)),
    # K3: the consumers issue their products whenever they are ready
    "k3_no_pingpong": (K3, ((WGMMA, "constexpr bool kPingpong = true;",
                                         "constexpr bool kPingpong = false;"),)),
    # K3: two consumer warpgroups, a 128-query tile
    "k3_two_consumers": (K3, ((WGMMA, "constexpr int kConsumers = 3;",
                                           "constexpr int kConsumers = 2;"),)),
    # K2: 1, 2 or 4 n8 column tiles (of 8) of each score tile take 2^x as a
    # polynomial on the FMA units
    **{f"k2_poly_{n}": _k2_poly(n) for n in (1, 2, 4)},
    # K2: the last tile in the loop, the masking behind a run-time test
    "k2_no_peel": (K3, ((FMW, "constexpr bool kPeelLast = true;",
                         "constexpr bool kPeelLast = false;"),)),
    # K2: the scores' first k-step reads its accumulators (as the others do)
    "k2_scores_read": (K3, ((FMW, "constexpr bool kFreshScores = true;",
                             "constexpr bool kFreshScores = false;"),)),
    # K2: the output rows rescaled at every tile, whether a max was raised or not
    "k2_rescale_always": (K3, ((FMW, "constexpr bool kLazyRescale = true;",
                                "constexpr bool kLazyRescale = false;"),)),
    # K2: tile t's Q K^T after tile t - 1's P V has finished, not before it
    "k2_serial": (K3, ((FMW, "constexpr bool kOverlap = true;",
                        "constexpr bool kOverlap = false;"),)),
    # K2: the consumers issue their products whenever they are ready
    "k2_no_pingpong": (K3, ((FMW, "constexpr bool kPingpong = true;",
                             "constexpr bool kPingpong = false;"),)),
    # K2: both: each consumer issues when ready, the scores after P V
    "k2_serial_no_pingpong": (K3, ((FMW, "constexpr bool kOverlap = true;",
                                    "constexpr bool kOverlap = false;"),
                                   (FMW, "constexpr bool kPingpong = true;",
                                    "constexpr bool kPingpong = false;"))),
    # K2: four, two or one consumer warpgroups a block whatever the shape
    "k2_consumers_4": (K3, ((FMW, "  int best = 4;\n", "  return 4;\n  int best = 4;\n"),)),
    "k2_consumers_2": (K3, ((FMW, "  int best = 4;\n", "  return 2;\n  int best = 4;\n"),)),
    "k2_consumers_1": (K3, ((FMW, "  int best = 4;\n", "  return 1;\n  int best = 4;\n"),)),
    # 3xTF32: tile t's Q K^T after tile t - 1's P V has finished
    "tf32_serial": (K3, ((TF32, "constexpr bool kOverlap = true;",
                          "constexpr bool kOverlap = false;"),)),
    # 3xTF32: the consumers issue their products whenever they are ready
    "tf32_no_pingpong": (K3, ((TF32, "constexpr bool kPingpong = true;",
                               "constexpr bool kPingpong = false;"),)),
    # 3xTF32 with K and V split in shared memory by the producer warpgroup
    # (no pre-pass, no scratch), timed on its own entry at the f32 cases
    "tf32_smem_split": (K3 + (TF32_SMEM,), ()),
    # 3xTF32: two stages at head dim 32 too (shipped: 4 at D 32, 2 at D 64)
    "tf32_stages_2": (K3, ((TF32, "static constexpr int kStages = D == 32 ? 4 : 2;",
                            "static constexpr int kStages = 2;"),)),
    # 3xTF32 at head dim 128 (shipped: each tile's products in turn, P V
    # accumulated across the key tiles by the tensor cores, two K stages and
    # one V stage): each tile's P V summed apart in two 64-column halves and
    # added in f32
    "tf32_d128_fold": (K3, ((TF32, "constexpr bool kFold128 = false;",
                             "constexpr bool kFold128 = true;"),)),
    # tile t's Q K^T issued before tile t - 1's P V
    "tf32_d128_overlap": (K3, ((TF32, "constexpr bool kOverlap128 = false;",
                                "constexpr bool kOverlap128 = true;"),)),
    # one K stage and two V stages, or one of each
    **{f"tf32_d128_stages_{k}_{v}": (K3, ((TF32, "constexpr int kKStages128 = 2, kVStages128 = 1;",
                                           f"constexpr int kKStages128 = {k}, "
                                           f"kVStages128 = {v};"),))
       for k, v in ((1, 2), (1, 1))},
    # 3xTF32 at head dim 96 (shipped: 64-key tiles, one K and one V stage,
    # each tile's products in turn): 32-key tiles with two K and two V
    # stages, overlapped (the first design) or in turn, or three K stages;
    # 64-key tiles overlapped (scores and P's halves live at once)
    **{f"tf32_d96_tile32{sfx}": (K3, (
        (TF32, "constexpr int kBN96 = 64;", "constexpr int kBN96 = 32;"),
        (TF32, "constexpr int kKStages96 = 1, kVStages96 = 1;",
         f"constexpr int kKStages96 = {k}, kVStages96 = 2;"),
        *(((TF32, "constexpr bool kOverlap96 = false;", "constexpr bool kOverlap96 = true;"),)
          if overlap else ())))
       for sfx, overlap, k in (("", True, 2), ("_serial", False, 2), ("_stages_3_2", True, 3))},
    "tf32_d96_overlap": (K3, ((TF32, "constexpr bool kOverlap96 = false;",
                               "constexpr bool kOverlap96 = true;"),)),
    # 3xTF32 at head dim 80 (shipped: two K stages and one V stage, each
    # tile's products in turn): tile t's Q K^T issued before tile t - 1's
    # P V; one K and one V stage; one K stage and two V stages
    "tf32_d80_overlap": (K3, ((TF32, "constexpr bool kOverlap80 = false;",
                               "constexpr bool kOverlap80 = true;"),)),
    **{f"tf32_d80_stages_{k}_{v}": (K3, ((TF32, "constexpr int kKStages80 = 2, kVStages80 = 1;",
                                          f"constexpr int kKStages80 = {k}, "
                                          f"kVStages80 = {v};"),))
       for k, v in ((1, 1), (1, 2))},
    # NMS: clusters of 4 or 16 blocks a frame (shipped: 8; 16 offer 2 boxes
    # each), or one block a frame (the staged boxes, the look-ahead and the
    # division-free test on one SM)
    **{f"nms_cluster_{n}": (NMS_V, ((NMS, "constexpr int kCluster = 8;",
                                     f"constexpr int kCluster = {n};"),)) for n in (1, 4)},
    "nms_cluster_16": (NMS_V, ((NMS, "constexpr int kCluster = 8;", "constexpr int kCluster = 16;"),
                               (NMS, "constexpr int kLook = 4;", "constexpr int kLook = 2;"),
                               (NMS, _NMS_SMEM_ATTR, _NMS_SMEM_ATTR.replace("const ", "") + (
                                   "    if (err == cudaSuccess)\n      err = cudaFuncSetAttribute("
                                   "nms_fixed_kernel<kStaged>,\n          "
                                   "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")))),
    # NMS: each block offers its first 1 or 2 free boxes a round (shipped: 4);
    # with 1 a round resolves one box, as the first cluster design did
    **{f"nms_look_{n}": (NMS_V, ((NMS, "constexpr int kLook = 4;",
                                  f"constexpr int kLook = {n};"),)) for n in (1, 2)},
    # NMS: 256 or 1024 threads a block (shipped: 512)
    **{f"nms_threads_{n}": (NMS_V, ((NMS, "constexpr int kThreads = 512;",
                                     f"constexpr int kThreads = {n};"),)) for n in (256, 1024)},
    # NMS's large mode: 1 or 8 suppression words a warp at once (shipped: 4)
    **{f"nms_large_unroll_{n}": (NMS_V, ((NMS, "constexpr int kLargeUnroll = 4;",
                                          f"constexpr int kLargeUnroll = {n};"),))
       for n in (1, 8)},
    # NMS: every pair divided (the division-free test off)
    "nms_divide": (NMS_V, ((NMS, "const bool exact_free = thr >= FLT_MIN && thr <= FLT_MAX;",
                            "const bool exact_free = false;"),)),
    # NMS from the pairwise suppression bitmask over the card, then a warp a
    # frame scans it (timed through its own entry, bff_nms_bitmask)
    "nms_bitmask": ((NMS, NMB), ()),
    # K4: two consumer warpgroups (240 registers each), a 128-query tile, tile
    # t's Q K^T issued before tile t - 1's P V
    "k4_two_consumers": (K45, (
        (RWG, "constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;"),
        (RWG, "constexpr bool kOverlap = false;", "constexpr bool kOverlap = true;"))),
    # K4: two consumers, each tile's products in turn
    "k4_two_serial": (K45, ((RWG, "constexpr int kConsumers = 3;",
                                        "constexpr int kConsumers = 2;"),)),
    # K4: three consumers with the overlap (scores and P live at once: spills)
    "k4_overlap": (K45, ((RWG, "constexpr bool kOverlap = false;",
                                     "constexpr bool kOverlap = true;"),)),
    # K4: the consumers issue their products whenever they are ready
    "k4_no_pingpong": (K45, ((RWG, "constexpr bool kPingpong = true;",
                                         "constexpr bool kPingpong = false;"),)),
    # K4: three K and V tiles in flight
    "k4_stages_3": (K45, ((RWG, "constexpr int kStages = 2;",
                                      "constexpr int kStages = 3;"),)),
    # K5: the two consumers take turns to issue their products, as K4's do
    # (consumer 1 hands consumer 0 the first turn; consumer 0 takes the
    # surplus one after its loop)
    "k5_pingpong": (K45, _k5_pingpong()),
    # K5: one consumer warpgroup walking the four m-tiles
    "k5_one_consumer": (K45, ((RWG, "constexpr int kWConsumers = 2;",
                                          "constexpr int kWConsumers = 1;"),)),
    # K5: two blocks an SM, each one consumer and one window in flight
    # K4 and K5 in f32 on the FMA kernels of relpos_attention.cu (the 3xTF32
    # routes off): the kernels before the redesign
    "relpos_f32_fma": (K45, (
        (RELPOS, "  if (bff_relpos_tf32_takes(0, dtype, D, S, kh, kw, scale, q, k, v, o, bh, "
                 "bw) ||\n      bff_relpos_tf32_streamed_takes(0, dtype, D, S, kh, kw, scale, "
                 "q, k, v, o, bh, bw))\n", "  if (false)\n"),
        (RELPOS, "  if (bff_relpos_tf32_takes(1, dtype, D, S, wh, ww, scale, q, k, v, o, bias_h, "
                 "bias_w))\n", "  if (false)\n"))),
    # 3xTF32 K4 and K5: tile t's Q K^T issued before tile t - 1's P V
    # (shipped: after it; with the overlap the consumers spill)
    "k4_tf32_overlap": (K45, ((RT32, "constexpr bool kOverlap = false;",
                               "constexpr bool kOverlap = true;"),)),
    "k5_tf32_overlap": (K45, ((RT32, "constexpr bool kWOverlap = false;",
                               "constexpr bool kWOverlap = true;"),)),
    # 3xTF32 K5: the producer reads tile u + 1 before it writes tile u
    # (shipped: after; the registers of both tiles spill)
    "k5_tf32_prefetch": (K45, ((RT32, "constexpr bool kWPrefetch = false;",
                                "constexpr bool kWPrefetch = true;"),)),
    # 3xTF32 K4 and K5: P V accumulated across every key tile by the tensor
    # cores (shipped: each tile's P V summed apart, then added in f32)
    "relpos_tf32_no_fold": (K45, ((RT32, "constexpr bool kFold = true;",
                                   "constexpr bool kFold = false;"),)),
    # 3xTF32 K4 and K5: the consumers issue their products whenever they are ready
    "relpos_tf32_no_pingpong": (K45, ((RT32, "constexpr bool kPingpong = true;",
                                       "constexpr bool kPingpong = false;"),)),
    # 3xTF32 K4 at head dim 64: one K and one V stage (shipped: two K stages
    # and one V stage)
    "k4_tf32_d64_stages_1_1": (K45, ((RT32, "constexpr int kKStages64 = 2, kVStages64 = 1;",
                                      "constexpr int kKStages64 = 1, kVStages64 = 1;"),)),
    # 3xTF32 K4 at head dim 96 (shipped: each tile's P V summed apart in two
    # 48-column halves): P V accumulated across every key tile by the tensor
    # cores (no fold), or the fold in one piece (48 more registers live)
    "k4_tf32_d96_no_fold": (K45, ((RT32, "constexpr bool kFold96 = true;",
                                   "constexpr bool kFold96 = false;"),)),
    "k4_tf32_d96_fold_whole": (K45, ((RT32, "constexpr int kFoldParts96 = 2;",
                                      "constexpr int kFoldParts96 = 1;"),)),
    # 3xTF32 K4 past 64 grid columns (the streamed mode): each score reads its
    # bias_w from device memory (shipped: each warp stages its rows' run of
    # the tile into a shared-memory slot by cp.async)
    "k4_tf32_bw_from_l2": (K45, ((RT32, "constexpr bool kBwStreamed = true;",
                                  "constexpr bool kBwStreamed = false;"),)),
    # 3xTF32 K4 at head dim 96: the scores' accumulators start at bias_w
    # (shipped: the products from zero, the bias added after them)
    "k4_tf32_d96_bias_start": (K45, ((RT32, "constexpr bool kBiasAfter96 = true;",
                                      "constexpr bool kBiasAfter96 = false;"),)),
    # bf16 flash attention at head dims 144-256: each tile's products in turn;
    # the two warpgroups issuing their products when they are ready
    "wide_serial": (K3, ((WIDE, "constexpr bool kOverlap = true;",
                          "constexpr bool kOverlap = false;"),)),
    "wide_no_pingpong": (K3, ((WIDE, "constexpr bool kPingpong = true;",
                               "constexpr bool kPingpong = false;"),)),
    # K4 past the factor table: each score's factors read from device memory
    # (the tile's lines prefetched into L1 before its Q K^T) instead of
    # staged beside K and V
    "relpos_stream_l2": (K45, ((RST, "constexpr bool kStreamFromL2 = false;",
                                "constexpr bool kStreamFromL2 = true;"),)),
    # K4 at head dims 144-256, f32: each tile's P V folded in two 112-column
    # halves at DP 224 (shipped: four 56-column parts)
    "relpos_wide_tf32_fold_halves": (K45, ((RWT, "DP == 256 ? 32 : DP == 224 ? 56 : DP / 2;",
                                            "DP == 256 ? 32 : DP / 2;"),)),
    # f32 flash attention at head dim 112: 64-key tiles, one K and one V
    # stage (shipped: 32-key tiles, two K stages and one V stage)
    "tf32_d112_keys_64": (K3, ((TF32, "constexpr int kBN112 = 32;\n"
                                      "constexpr int kKStages112 = 2, kVStages112 = 1;",
                                "constexpr int kBN112 = 64;\n"
                                "constexpr int kKStages112 = 1, kVStages112 = 1;"),)),
    # and with Q's addresses made opaque once a tile, so that the Q K^T
    # descriptors are computed there instead of hoisted into registers
    "tf32_d112_keys_64_opaque": (K3, (
        (TF32, "constexpr int kBN112 = 32;\nconstexpr int kKStages112 = 2, kVStages112 = 1;",
         "constexpr int kBN112 = 64;\nconstexpr int kKStages112 = 1, kVStages112 = 1;"),
        (TF32, "                                             uint32_t khi, uint32_t klo) {\n"
               "#pragma unroll\n  for (int kk = 0; kk < D / 8; ++kk) {\n"
               "    wgmma_tf32(s, qk_desc<D, 64>(qlo, kk)",
         "                                             uint32_t khi, uint32_t klo) {\n"
         "  qhi = opaque(qhi);\n  qlo = opaque(qlo);\n"
         "#pragma unroll\n  for (int kk = 0; kk < D / 8; ++kk) {\n"
         "    wgmma_tf32(s, qk_desc<D, 64>(qlo, kk)"))),
    # f32 flash attention at head dims 144-256 with K and V split by the
    # producer on the chip, as K4's bias mode does (shipped: split by a
    # pre-pass into scratch, the producer copying the images)
    "wide_tf32_split_on_chip": (K3, ((RWT, "constexpr bool kPreSplit = true;",
                                      "constexpr bool kPreSplit = false;"),)),
    # and at DP 256 in four 64-column parts (shipped: eight of 32)
    "relpos_wide_tf32_fold_64": (K45, ((RWT, "DP == 256 ? 32 : DP == 224 ? 56 : DP / 2;",
                                        "DP == 256 ? 64 : DP == 224 ? 56 : DP / 2;"),)),
    # 3xTF32 K4 at head dims 112 and 128, plan (b): the wide 3xTF32 kernel
    # of relpos_attention_wide_tf32.cu at a padded DP of 128 (one 64-row
    # consumer, 255 registers, K and V split on the chip) instead of
    # K4Cfg<112> and <128> (shipped: 32-key tiles, two 64-row consumers)
    "k4_tf32_plan_b": (K45, (
        (RT32, "constexpr int kMinK4D = 32, kMaxK4D = 128;",
         "constexpr int kMinK4D = 32, kMaxK4D = 96;"),
        (RWT, "constexpr int kMinD = 144, kMaxD = 256;", "constexpr int kMinD = 112, kMaxD = 256;"),
        (RWT, "DP % kDStep == 0 && DP >= 160 && DP <= kMaxD",
         "DP % kDStep == 0 && DP >= 128 && DP <= kMaxD"),
        (RWT, "    case 160:\n",
         "    case 128:\n      return launch<128, kKeyMask>(q, k, v, bias_h, bias_w, img, o, "
         "BH, S, D, kh, kw, keys, scale, st);\n    case 160:\n"))),
    # 3xTF32 K4 at head dims 112 and 128: the scores' accumulators start at
    # bias_w (shipped: the products from zero, the bias added after them)
    "k4_tf32_d128_bias_start": (K45, ((RT32, "constexpr bool kBiasAfter128 = true;",
                                       "constexpr bool kBiasAfter128 = false;"),)),
    # 3xTF32 K4 at head dim 128: each tile's P V folded in two 64-column
    # parts (shipped: four of 32; two spill 16-48 bytes more)
    "k4_tf32_d128_fold_2": (K45, (
        (RT32, "constexpr int kFoldParts112 = 2, kFoldParts128 = 4;",
         "constexpr int kFoldParts112 = 2, kFoldParts128 = 2;"),)),
    # 3xTF32 K4 at head dims 32 and 48: two K stages and one V stage, or one
    # of each (shipped: two of each)
    "k4_tf32_d32_stages_2_1": (K45, ((RT32, "constexpr int kKStages32 = 2, kVStages32 = 2;",
                                      "constexpr int kKStages32 = 2, kVStages32 = 1;"),)),
    "k4_tf32_d32_stages_1_1": (K45, ((RT32, "constexpr int kKStages32 = 2, kVStages32 = 2;",
                                      "constexpr int kKStages32 = 1, kVStages32 = 1;"),)),
    "k5_two_blocks": (K45, (
        (RWG, "constexpr int kWConsumers = 2;", "constexpr int kWConsumers = 1;"),
        (RWG, "constexpr int kWStages = 2;", "constexpr int kWStages = 1;"),
        (RWG, "constexpr int kWBlocksPerSM = 1;", "constexpr int kWBlocksPerSM = 2;"),
        (RWG, "constexpr int kWConsumerRegs = 240;", "constexpr int kWConsumerRegs = 232;"))),
}


def tile_order(shapes, tile, device):
    """(Q,) int32 permutation of the all-level raster's queries that walks
    them tile by tile of level 0 (``build_assignment``'s buckets, the
    queries of a tile in raster order), on ``device``."""
    a = dw.build_assignment(shapes, 0, tile)
    return torch.from_numpy(a.idx[a.valid].astype(np.int32)).to(device)


def build_all(parent_csrc, names=None):
    """Compile the variants (all, or ``names``) at once; returns {name:
    ctypes library}."""
    shutil.rmtree(OUT, ignore_errors=True)
    specs = {n: v for n, v in VARIANTS.items() if names is None or n in names}
    if parent_csrc:
        specs["parent"] = (tuple(x for x in SOURCES
                                 if os.path.exists(os.path.join(parent_csrc, x))), ())
    procs = {}
    for name, (sources, edits) in specs.items():
        src_dir = os.path.join(OUT, name, "csrc")
        shutil.copytree(parent_csrc if name == "parent" else _build.CSRC, src_dir)
        if name != "parent":
            for fname in os.listdir(VARIANT_CSRC):
                shutil.copy(os.path.join(VARIANT_CSRC, fname), src_dir)
        for fname, old, new in edits:
            path = os.path.join(src_dir, fname)
            with open(path) as f:
                text = f.read()
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: edit of {fname} matches {text.count(old)} times")
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        for src in sources:
            obj = os.path.join(OUT, name, src[:-3] + ".o")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", src_dir, "-c",
                   os.path.join(src_dir, src), "-o", obj]
            procs[(name, src)] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True))
    objs = {}
    for (name, src), (obj, proc) in procs.items():
        out, _ = proc.communicate()
        with open(os.path.join(OUT, name, src[:-3] + ".ptxas.txt"), "w") as f:
            f.write(out)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}/{src}:\n{out[-4000:]}")
        objs.setdefault(name, []).append(obj)
    libs = {}
    for name, names in objs.items():
        lib = os.path.join(OUT, name, "lib.so")
        subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                        "-o", lib, *names], check=True)
        libs[name] = ctypes.CDLL(lib)
    return libs


def has(lib, fn):
    try:
        getattr(lib, fn)
    except AttributeError:
        return False
    return True


def attention_case(g, grid, window, d=80):
    """K4 or K5 in bf16 at SAM's factors, as ``chip_smoke.py`` builds them,
    through the rel-pos entries, at head dim ``d`` (SAM ViT-H's 80); after
    (name, launch, check) come SDPA with the bias as a dense float mask on
    the same inputs, the operations and the bytes of one call. The plain
    version is timed beside them (``launch.plain``)."""
    import torch.nn.functional as F

    hh, ww = grid
    s = hh * ww
    gen = torch.Generator(device="cuda").manual_seed(s + g)
    q, k, v = (torch.randn(g, s, d, device="cuda", generator=gen).bfloat16() for _ in range(3))
    rel_h = (0.1 * torch.randn(2 * hh - 1, d, device="cuda", generator=gen)).bfloat16()
    rel_w = (0.1 * torch.randn(2 * ww - 1, d, device="cuda", generator=gen)).bfloat16()
    bias_h, bias_w = (t.bfloat16().contiguous() for t in
                      sam_mod._rel_pos_factors((hh, ww), (hh, ww), rel_h, rel_w, q))
    want = fa.attend_relpos_plain(q, k, v, bias_h, bias_w, ww)
    bound = fa.bf16_error_bound(q, k, v, want, bias_h=bias_h, bias_w=bias_w)
    out = torch.empty_like(q)
    fn = "bff_window_attention_relpos" if window else "bff_flash_attention_relpos"
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        f = getattr(lib, fn)
        # the flash entry's scratch, unread for bf16 (a tree from before it
        # ignores the argument)
        rc = f(ctypes.c_int(1), *(ctypes.c_void_p(t.data_ptr()) for t in
                                  (q, k, v, bias_h, bias_w, out)),
               g, s, d, hh, ww, ctypes.c_float(d ** -0.5), ctypes.c_void_p(stream),
               ctypes.c_void_p(None))
        if rc != 0:
            raise RuntimeError(f"{fn} failed (code {rc})")
        return out

    def check(got):
        return float(((got.float() - want.float()).abs() - bound).max())

    mask = fa.relpos_bias(bias_h, bias_w, torch.bfloat16).bfloat16()[None]
    q4, k4, v4 = (t[None] for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)[0]
    launch.plain = lambda: fa.attend_relpos_plain(q, k, v, bias_h, bias_w, ww)
    nbytes = (4 * g * s * d + g * s * (hh + ww)) * 2
    return fn, launch, check, library, 4 * g * s * s * d, nbytes


def relpos_f32_case(g, grid, window, d=80, spread=1.0, factor_scale=0.1):
    """K4 or K5 in f32 at head dim ``d`` (SAM ViT-H's 80; K4 also at SAM
    ViT-L's 64 and at 96), q and k scaled by ``spread``, the rel-pos tables
    drawn at ``factor_scale`` (peaked by the factors at 3), through the rel-pos
    entries (the 3xTF32 kernels of ``relpos_attention_tf32.cu`` in this tree,
    the FMA kernels in the ``relpos_f32_fma`` variant or a tree from before
    them), the factors as ``chip_smoke.py`` builds them, held within 1e-4 of
    the plain version; after (name, launch, check) come SDPA in f32 with the
    bias as a dense float mask on the same inputs, the operations and bytes
    of one call, the peak that gives ``bound_ms`` (3xTF32: a third of the
    TF32 rate) and the plain version, timed as one more yardstick."""
    import torch.nn.functional as F

    hh, ww = grid
    s = hh * ww
    gen = torch.Generator(device="cuda").manual_seed(s + g)
    q, k, v = (torch.randn(g, s, d, device="cuda", generator=gen) for _ in range(3))
    q, k = q * spread, k * spread
    rel_h = factor_scale * torch.randn(2 * hh - 1, d, device="cuda", generator=gen)
    rel_w = factor_scale * torch.randn(2 * ww - 1, d, device="cuda", generator=gen)
    bias_h, bias_w = (t.contiguous() for t in
                      sam_mod._rel_pos_factors((hh, ww), (hh, ww), rel_h, rel_w, q))
    plain = lambda: fa.attend_relpos_plain(q, k, v, bias_h, bias_w, ww)
    want = plain()
    out = torch.empty_like(q)
    # K4's 3xTF32 scratch (K5's windows past 256 tokens run K4's kernel; a
    # tree from before that ignores the window entry's last argument)
    scratch = torch.empty(fa.relpos_tf32_scratch_floats(g, s, d), device="cuda")
    fn = "bff_window_attention_relpos" if window else "bff_flash_attention_relpos"
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib):
        rc = getattr(lib, fn)(ctypes.c_int(0), *(ctypes.c_void_p(t.data_ptr()) for t in
                                                 (q, k, v, bias_h, bias_w, out)),
                              g, s, d, hh, ww, ctypes.c_float(d ** -0.5),
                              ctypes.c_void_p(stream), ctypes.c_void_p(scratch.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"{fn} failed (code {rc})")
        return out

    def check(got):
        return float((got - want).abs().max()) - F32_TOL

    mask = fa.relpos_bias(bias_h, bias_w, torch.float32)[None]
    q4, k4, v4 = (t[None] for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)[0]
    launch.plain = plain

    def fma(lib):  # K4's FMA kernel on the same call (this tree's measurement entry)
        rc = lib.bff_flash_attention_relpos_f32_fma(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, bias_h, bias_w, out)), g, s, d,
            hh, ww, ctypes.c_float(d ** -0.5), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"bff_flash_attention_relpos_f32_fma failed (code {rc})")
        return out

    if not window or fa.window_on_flash(s, d):  # K4's function (windows as heads)
        launch.fma = ("bff_flash_attention_relpos_f32_fma", fma)
    nbytes = (4 * g * s * d + g * s * (hh + ww)) * 4
    return fn, launch, check, library, 4 * g * s * s * d, nbytes, PEAK_TF32_FLOPS / 3


def k3_case(bh, s):
    """K3 in bf16 at head dim 64, every key valid, through
    ``bff_flash_attention``; after (name, launch, check) come SDPA on the
    same inputs and the operations of one call."""
    import torch.nn.functional as F

    d = 64
    gen = torch.Generator(device="cuda").manual_seed(bh * s)
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).bfloat16() for _ in range(3))
    want = fa.flash_attention_plain(q, k, v)
    bound = fa.bf16_error_bound(q, k, v, want)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    fn = "bff_flash_attention"
    q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))

    def launch(lib):
        rc = lib.bff_flash_attention(ctypes.c_int(1), *(ctypes.c_void_p(t.data_ptr()) for t in
                                                        (q, k, v, out)),
                                     bh, s, d, s, ctypes.c_float(d ** -0.5),
                                     ctypes.c_void_p(stream), ctypes.c_void_p(None))
        if rc != 0:
            raise RuntimeError(f"{fn} failed (code {rc})")
        return out

    def check(got):
        return float(((got.float() - want.float()).abs() - bound).max())

    library = lambda: F.scaled_dot_product_attention(q4, k4, v4).view(bh, s, d)
    return fn, launch, check, library, 4 * bh * s * s * d, 4 * bh * s * d * 2


def k2_case(bh, s, valid_len, d=32):
    """K2 in bf16 at Grounding-DINO's decoder head dim 32 (or ``d``) through
    ``bff_flash_attention`` with keys >= ``valid_len`` masked (the main
    path's ``attend`` passes ``valid_len = S``): the wgmma kernel of
    ``flash_masked_wgmma.cu`` in this tree, the mma.sync tile in a tree from
    before it (past head dim 128: the wide kernel of
    ``flash_attention_wide_wgmma.cu``, the tile's slices before it). After
    (name, launch, check) come SDPA on the same inputs (a boolean key mask
    where ``valid_len < S``) and the operations and bytes of one call; past
    head dim 128 the plain version is timed beside them."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(bh * s + valid_len)
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen).bfloat16() for _ in range(3))
    want = fa.flash_attention_plain(q, k, v, valid_len)
    bound = fa.bf16_error_bound(q, k, v, want, valid_len)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    fn = "bff_flash_attention"
    q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
    mask = None
    if valid_len < s:
        mask = torch.arange(s, device="cuda")[None, :] < valid_len

    def launch(lib):
        rc = lib.bff_flash_attention(ctypes.c_int(1), *(ctypes.c_void_p(t.data_ptr()) for t in
                                                        (q, k, v, out)),
                                     bh, s, d, valid_len, ctypes.c_float(d ** -0.5),
                                     ctypes.c_void_p(stream), ctypes.c_void_p(None))
        if rc != 0:
            raise RuntimeError(f"{fn} failed (code {rc})")
        return out

    def check(got):
        return float(((got.float() - want.float()).abs() - bound).max())

    library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask).view(bh, s, d)
    if d > fa.HEAD_DIM_SLICE:
        launch.plain = lambda: fa.flash_attention_plain(q, k, v, valid_len)
    return fn, launch, check, library, 4 * bh * s * valid_len * d, 4 * bh * s * d * 2


def f32_case(bh, s, d, valid_len, spread=1.0):
    """K2 (head dim 32, keys >= ``valid_len`` masked) or K3 (head dim 64,
    every key valid) in f32 through ``bff_flash_attention``, held within
    1e-4 of the plain version; after (name, launch, check) come SDPA in f32
    on the same inputs (a boolean key mask where keys are masked), the
    operations and bytes of one call, the peak that gives ``bound_ms``
    (3xTF32: a third of the TF32 rate) and the plain version, timed as one
    more yardstick. ``spread`` scales q and k (peaked rows at 3)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(bh * s + valid_len + d)
    q, k, v = (torch.randn(bh, s, d, device="cuda", generator=gen) for _ in range(3))
    q, k = q * spread, k * spread
    want = fa.flash_attention_plain(q, k, v, valid_len)
    out = torch.empty_like(q)
    # the 3xTF32 kernels' scratch (a tree from before them ignores the
    # argument)
    scratch = torch.empty(max(fa.tf32_scratch_floats(bh, d, valid_len),
                              fa.wide_tf32_scratch_floats(bh, d, valid_len)), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    fn = "bff_flash_attention"
    q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
    mask = None
    if valid_len < s:
        mask = torch.arange(s, device="cuda")[None, :] < valid_len

    def launch(lib):
        rc = lib.bff_flash_attention(ctypes.c_int(0), *(ctypes.c_void_p(t.data_ptr()) for t in
                                                        (q, k, v, out)),
                                     bh, s, d, valid_len, ctypes.c_float(d ** -0.5),
                                     ctypes.c_void_p(stream), ctypes.c_void_p(scratch.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"{fn} failed (code {rc})")
        return out

    def check(got):
        return float((got - want).abs().max()) - F32_TOL

    library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask).view(bh, s, d)
    launch.plain = lambda: fa.flash_attention_plain(q, k, v, valid_len)

    def fma(lib):  # the FMA kernel on the same call (this tree's measurement entry)
        rc = lib.bff_flash_attention_f32_fma(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)), bh, s, d, valid_len,
            ctypes.c_float(d ** -0.5), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"bff_flash_attention_f32_fma failed (code {rc})")
        return out

    launch.fma = ("bff_flash_attention_f32_fma", fma)

    def smem_split(lib):
        rc = lib.bff_flash_attention_tf32_smem(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)), bh, s, d, valid_len,
            ctypes.c_float(d ** -0.5), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"bff_flash_attention_tf32_smem failed (code {rc})")
        return out

    launch.smem_split = smem_split
    return (fn, launch, check, library, 4 * bh * s * valid_len * d, 4 * bh * s * d * 4,
            PEAK_TF32_FLOPS / 3)


def nms_case(b, a, top_k=100, thr=0.5, large=False):
    """NMS over ``b`` frames of ``a`` clustered boxes as the wrapper runs it:
    the stable sort of the negated scores and the gather (in PyTorch), then
    ``bff_nms_fixed`` (this tree's or the parent's) or, for the ``nms_bitmask``
    variant, ``bff_nms_bitmask`` (``variant_csrc/nms_bitmask.cu``: the
    pairwise suppression bitmask over the card, then a warp a frame scans
    it); with ``large`` (frames past ``nms.MAX_ANCHORS`` boxes, or the
    large mode timed at a frame the staged kernel takes)
    ``bff_nms_fixed_large``. Held index for index against
    ``nms.nms_fixed_plain``. After (name, launch, check) comes a dict: the
    IoU tests this data needs and the bytes read once, for the bound, and
    ``split``, the device ms of the sort, the gather and the scan of a
    call."""
    boxes, scores = nms.clustered_boxes(torch.Generator(device="cuda").manual_seed(0), b, a)
    want = nms.nms_fixed_plain(boxes, scores, thr, top_k)
    keep = torch.empty(b, top_k, dtype=torch.int32, device="cuda")
    valid = torch.empty(b, top_k, dtype=torch.bool, device="cuda")
    words = (a + 31) // 32
    ws = torch.empty(nms.large_scratch_words(b, a) if large else b * a * words,
                     dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())

    def launch(lib):
        order = torch.sort(scores.neg(), dim=-1, stable=True).indices
        boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
        if large:
            rc = lib.bff_nms_fixed_large(ptr(boxes_s), ptr(order), b, a, top_k,
                                         ctypes.c_float(thr), ptr(ws), ptr(keep), ptr(valid),
                                         ctypes.c_void_p(stream))
        elif has(lib, "bff_nms_bitmask"):
            rc = lib.bff_nms_bitmask(ptr(boxes_s), ptr(order), b, a, top_k, ctypes.c_float(thr),
                                     ptr(ws), ptr(keep), ptr(valid), ctypes.c_void_p(stream))
        else:
            rc = lib.bff_nms_fixed(ptr(boxes_s), ptr(order), b, a, top_k, ctypes.c_float(thr),
                                   ptr(keep), ptr(valid), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"nms failed (code {rc})")
        return keep, valid

    def check(got):
        return 0.0 if all(bool(torch.equal(x, y)) for x, y in zip(got, want)) else 1.0

    extra = {"iou_tests": nms.iou_tests(*want, scores), "kept": int(want[1].sum()),
             "bytes": b * a * (16 + 4) + b * top_k * (4 + 1),
             "split": lambda call: nms.split_spans(device_spans(lambda: [call() for _ in range(5)]),
                                                   5)}
    return "bff_nms_fixed_large" if large else "bff_nms_fixed", launch, check, extra


def host_us(fn, iters=50):
    """Host microseconds per call of ``fn``, the launches enqueued back to
    back (the device runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def iou_case(ia, ib, n, padded):
    """K6 at (ia, n) x (ib, n) (``ib`` None: a self-IoU) through
    ``bff_mask_iou``, rows ``padded`` to 16-byte strides as the main path
    allocates them (``mask_iou.aligned_rows``) or contiguous; a library from
    before the strided entry (no ``bff_mask_iou_wgmma_takes``) gets the
    contiguous rows. After (name, launch, check) come ``torch._int_mm`` on
    int8 copies (intersections only) on the same masks, the operations (each
    distinct pair once), the bytes and the int8 peak."""
    from beyondff_tpu_torch.utils.profiling import PEAK_INT8_OPS

    gen = torch.Generator(device="cuda").manual_seed(ia + n)

    def rows(r, dens):
        m = torch.rand(r, n, device="cuda", generator=gen) < dens
        if not padded:
            return m
        v = kiou.aligned_rows(r, n, "cuda")
        v.copy_(m)
        return v

    dens = torch.rand(ia, 1, device="cuda", generator=gen) * 0.3
    dens[::17] = 0.0
    a = rows(ia, dens)
    b = None if ib is None else rows(ib, torch.rand(ib, 1, device="cuda", generator=gen) * 0.3)
    a_c, b_c = a.contiguous(), None if b is None else b.contiguous()
    want = kiou.pairwise_iou_plain(a, b)
    ib_n = ia if b is None else ib
    out = torch.empty(ia, ib_n, dtype=torch.float32, device="cuda")
    ws = torch.empty(ia * ib_n + ia + ib_n, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())

    def launch(lib):
        if has(lib, "bff_mask_iou_wgmma_takes"):
            rc = lib.bff_mask_iou(ptr(a), ptr(b), ia, ib_n, ctypes.c_longlong(n),
                                  ctypes.c_longlong(a.stride(0)),
                                  ctypes.c_longlong(a.stride(0) if b is None else b.stride(0)),
                                  ptr(ws), ptr(out), ctypes.c_void_p(stream))
        else:
            rc = lib.bff_mask_iou(ptr(a_c), ptr(b_c), ia, ib_n, ctypes.c_longlong(n), ptr(ws),
                                  ptr(out), ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"bff_mask_iou failed (code {rc})")
        return out

    def check(got):
        if got.dtype != torch.float32 or got.shape != want.shape:
            return 1.0  # the library call's counts are not IoU (it is not gated)
        same_nan = torch.equal(torch.isnan(got), torch.isnan(want))
        fin = ~torch.isnan(want)
        same = torch.equal(got[fin].view(torch.int32), want[fin].view(torch.int32))
        return 0.0 if same_nan and same else 1.0

    a8 = torch.nn.functional.pad(a_c.to(torch.int8), (0, -n % 8))
    b8 = a8 if b is None else torch.nn.functional.pad(b_c.to(torch.int8), (0, -n % 8, 0, -ib_n % 8))
    library = lambda: torch._int_mm(a8, b8.t())
    ops = ia * (ia + 1) * n if b is None else 2 * ia * ib_n * n
    nbytes = ia * n + (0 if b is None else ib_n * n) + 4 * ia * ib_n
    return "bff_mask_iou", launch, check, library, ops, nbytes, PEAK_INT8_OPS


def corner_rows(shapes, locs, modes):
    """How many (query, head, level, point, corner) rows of ``value`` the
    kernel loads for these locations: the corners that lie in the map of a
    sample that counts (clamp mode drops samples off the map)."""
    q = locs.shape[1]
    origins = dw.window_origins(shapes, modes, locs.device) if modes[0] is not None else None
    n = 0
    for li, (h, w) in enumerate(shapes):
        gx = locs[:, :, :, li, :, 0] * w - 0.5
        gy = locs[:, :, :, li, :, 1] * h - 0.5
        if modes[li] is None:
            live, y0, x0 = torch.ones_like(gx, dtype=torch.bool), gy.floor(), gx.floor()
        else:
            w3 = modes[li][0] + 2 * modes[li][1]
            oy = origins[li, :, 0].view(1, q, 1, 1).float()
            ox = origins[li, :, 1].view(1, q, 1, 1).float()
            live = (gy > -1) & (gy < h) & (gx > -1) & (gx < w)
            y0 = (gy - oy).clamp(0, w3 - 2).floor() + oy
            x0 = (gx - ox).clamp(0, w3 - 2).floor() + ox
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                n += int((live & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)).sum())
    return n


def deform_case(which, b, dtype):
    """K1 at the 800x1072 encoder raster (``encoder_clamp``,
    ``encoder_exact``) or for 900 decoder queries (``decoder_exact``), on
    ``dw.sample_inputs`` as ``chip_smoke.py`` makes them. A library with
    ``bff_ms_deform_set_order`` walks the encoder raster in level-0 tile
    order. For the bf16 encoder clamp call, ``launch.staged`` runs the same
    call on a library's staged kernel (``bff_ms_deform_staged``, the
    ``k1_staged*`` variants)."""
    rng = np.random.default_rng(b + 2 * (dtype == torch.float32))
    shapes = dw.ENC_SHAPES
    anchors = (rng.uniform(0.0, 1.0, (900, 2)).astype(np.float32) if which == "decoder_exact"
               else dw.raster_centers(shapes))
    value, tl, ta = dw.sample_inputs(rng, anchors, b, dtype, "cuda")
    _b, q, heads, n_levels, p = ta.shape
    s, hd = value.shape[1], value.shape[3]
    modes = (deformable.level_modes(shapes) if which == "encoder_clamp" else (None,) * 4)
    want = dw.ms_deform_sample_plain(value, shapes, tl, ta, modes).float()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    origins = dw.window_origins(shapes, modes, tl.device) if modes[0] is not None else None
    order = tile_order(shapes, dw.TILE, tl.device) if which != "decoder_exact" else None
    levels = dw.level_table(shapes, modes)
    plan, meta = (deform_staged.device_plan(shapes, modes, tl.device)
                  if which == "encoder_clamp" and dtype == torch.bfloat16 else (None, None))
    out = torch.empty(b, q, heads * hd, dtype=dtype, device="cuda")
    fn = "bff_ms_deform_sample"
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    ordered = set()  # libraries whose order is set for this case

    def launch(lib):
        if has(lib, SET_ORDER) and id(lib) not in ordered:
            if getattr(lib, SET_ORDER)(ptr(order)) != 0:
                raise RuntimeError(f"{SET_ORDER} failed")
            ordered.add(id(lib))
        # the device level table (read past 8 levels; a tree from before it
        # ignores the argument)
        rc = getattr(lib, fn)(int(dtype == torch.bfloat16), ptr(value), ptr(tl), ptr(ta),
                              ptr(origins), ptr(out), b, s, q, heads, hd, n_levels, p, levels,
                              ctypes.c_void_p(stream), ctypes.c_void_p(None))
        if rc != 0:
            raise RuntimeError(f"{fn} failed (code {rc})")
        return out

    def staged(lib):
        rc = lib.bff_ms_deform_staged(1, ptr(value), ptr(tl), ptr(ta), ptr(origins), ptr(plan),
                                      ptr(out), b, s, q, heads, n_levels, levels, meta,
                                      ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"bff_ms_deform_staged failed (code {rc})")
        return out

    if which == "encoder_clamp" and dtype == torch.bfloat16:
        launch.staged = staged

    def check(got):
        return float((got.float() - want).abs().max()) - tol

    es = value.element_size()
    return (fn, launch, check, dw.sample_bytes(value, tl, ta),
            corner_rows(shapes, tl, modes) * hd * es)


def event_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", default=None,
                    help="a csrc tree to build as the variant 'parent'")
    ap.add_argument("--variants", default=None,
                    help="comma-separated names to build (default: all)")
    ap.add_argument("--cases", default=None,
                    help="comma-separated prefixes of the cases to run (default: all)")
    ap.add_argument("--out", default=OUT, help="where the results and ptxas reports go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 yardsticks in full f32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs = build_all(args.parent_csrc, args.variants and args.variants.split(","))
    cases = {}
    for which in ("encoder_clamp", "encoder_exact", "decoder_exact"):
        for b in (1, 4):
            for dtype in (torch.bfloat16, torch.float32):
                name = f"k1 {which} b{b} {str(dtype)[6:]}"
                cases[name] = lambda w=which, b=b, d=dtype: deform_case(w, b, d)
    cases.update({
        # SAM ViT-H's global blocks at the batch of 4 (square and rect grid)
        # and at one frame; its windowed blocks at 4 and 1 frames
        "k4 (64, 4096, 80)": lambda: attention_case(64, (64, 64), False),
        "k4 (64, 3072, 80)": lambda: attention_case(64, (48, 64), False),
        "k4 (16, 4096, 80)": lambda: attention_case(16, (64, 64), False),
        "k5 (1600, 196, 80)": lambda: attention_case(1600, (14, 14), True),
        "k5 (400, 196, 80)": lambda: attention_case(400, (14, 14), True),
        # K6 at aggregation's self-IoU and refinement's cross IoU: rows
        # padded to 16-byte strides as the main path holds them, and at
        # 250 007 points also contiguous (off 16-byte boundaries)
        "k6 self (600, 250000)": lambda: iou_case(600, None, 250_000, True),
        "k6 self (600, 250007 padded)": lambda: iou_case(600, None, 250_007, True),
        "k6 self (600, 250007 unpadded)": lambda: iou_case(600, None, 250_007, False),
        "k6 cross (20 x 150, 250000)": lambda: iou_case(20, 150, 250_000, True),
        "k6 cross (20 x 150, 250007 padded)": lambda: iou_case(20, 150, 250_007, True),
        "k6 cross (20 x 150, 250007 unpadded)": lambda: iou_case(20, 150, 250_007, False),
        # EfficientSAM-S's global blocks at the batch of 4 (square and rect
        # grid) and at one frame
        "k3 (24, 4096, 64)": lambda: k3_case(24, 4096),
        "k3 (24, 3072, 64)": lambda: k3_case(24, 3072),
        "k3 (6, 4096, 64)": lambda: k3_case(6, 4096),
        # Grounding-DINO's decoder self-attention at the batch of 4 and at one
        # frame (every key valid, as attend calls it), and with keys masked
        "k2 (32, 900, 32)": lambda: k2_case(32, 900, 900),
        "k2 (8, 900, 32)": lambda: k2_case(8, 900, 900),
        "k2 (32, 1024, 32) valid 900": lambda: k2_case(32, 1024, 900),
        # past the old limits in bf16 (no configured model calls them): flash
        # attention at head dims 160 and 256 on the wide wgmma kernel (the
        # tile's 128-feature slices in a tree from before it), every key
        # valid and 900 of 1024, and at S 4096; K4 past the factor table on
        # the tile with streamed factors (the FMA kernel before it, the
        # relpos_stream_l2 variant reading the factors from device memory)
        **{f"past flash d{d_} ({bh_}, {s_}, {d_}){'' if v_ == s_ else f' valid {v_}'}":
           (lambda bh_=bh_, s_=s_, v_=v_, d_=d_: k2_case(bh_, s_, v_, d_))
           for bh_, s_, v_, d_ in ((16, 1024, 1024, 160), (16, 1024, 900, 160),
                                   (16, 1024, 1024, 256), (16, 1024, 900, 256),
                                   (16, 4096, 4096, 256))},
        "past k4 streamed 1x300 (16, 300, 64)": lambda: attention_case(16, (1, 300), False, 64),
        "past k4 streamed 2x255 (16, 510, 64)": lambda: attention_case(16, (2, 255), False, 64),
        "past k4 streamed 136x136 (4, 18496, 80)":
            lambda: attention_case(4, (136, 136), False, 80),
        "past k4 d160 32x32 (16, 1024, 160)": lambda: attention_case(16, (32, 32), False, 160),
        # K4 at head dims 144-256 on the wide kernels (the tile's or the FMA
        # kernel's slices in a tree from before them): bf16 inside and past
        # the factor table; f32 on any grid ("relpos_f32 wide", beside the FMA
        # kernel's slices through the entry ``fma``)
        "past k4 d160 2x255 (16, 510, 160)": lambda: attention_case(16, (2, 255), False, 160),
        "past k4 d256 32x32 (16, 1024, 256)": lambda: attention_case(16, (32, 32), False, 256),
        "past k4 d160 136x136 (4, 18496, 160)":
            lambda: attention_case(4, (136, 136), False, 160),
        "relpos_f32 wide d160 32x32 (16, 1024, 160)":
            lambda: relpos_f32_case(16, (32, 32), False, 160),
        "relpos_f32 wide d256 32x32 (16, 1024, 256)":
            lambda: relpos_f32_case(16, (32, 32), False, 256),
        "relpos_f32 wide d160 2x255 (16, 510, 160)":
            lambda: relpos_f32_case(16, (2, 255), False, 160),
        "relpos_f32 wide d160 32x36 (16, 1152, 160)":
            lambda: relpos_f32_case(16, (32, 36), False, 160),
        "relpos_f32 wide d224 32x32 (16, 1024, 224)":
            lambda: relpos_f32_case(16, (32, 32), False, 224),
        "relpos_f32 wide d160 factors 3 (16, 1024, 160)":
            lambda: relpos_f32_case(16, (32, 32), False, 160, 1.0, 3.0),
        # the factor table's route just inside its limit (kh + kw = 240), the
        # streamed route's yardstick at a similar grid
        "past k4 table 120x120 (4, 14400, 80)": lambda: attention_case(4, (120, 120), False, 80),
        # K2 and K3 in f32 (detector.dtype: float32) at the same shapes, and
        # K3 at the ragged S = 4095
        "f32 k2 (8, 900, 32)": lambda: f32_case(8, 900, 32, 900),
        "f32 k2 (32, 900, 32)": lambda: f32_case(32, 900, 32, 900),
        "f32 k2 (32, 1024, 32) valid 900": lambda: f32_case(32, 1024, 32, 900),
        "f32 k3 (6, 4096, 64)": lambda: f32_case(6, 4096, 64, 4096),
        "f32 k3 (24, 4096, 64)": lambda: f32_case(24, 4096, 64, 4096),
        "f32 k3 (24, 3072, 64)": lambda: f32_case(24, 3072, 64, 3072),
        "f32 k3 (24, 4095, 64)": lambda: f32_case(24, 4095, 64, 4095),
        # f32 at short sequences, where the 3xTF32 kernel's pre-pass and
        # latency weigh most (the main path's attend calls a kernel from
        # S = 256 on, its models from 512)
        **{f"f32 small ({bh}, {s_}, {d})": (lambda bh=bh, s_=s_, d=d: f32_case(bh, s_, d, s_))
           for d, bh in ((32, 8), (64, 6), (128, 8)) for s_ in (64, 256, 512)},
        # f32 at head dim 128 (the public entries take it; no model calls it)
        # with keys past 900 of 1024 masked, at 32 and 8 heads
        "f32 d128 (32, 1024, 128) valid 900": lambda: f32_case(32, 1024, 128, 900),
        "f32 d128 (8, 1024, 128) valid 900": lambda: f32_case(8, 1024, 128, 900),
        "f32 d128 spread 3 (32, 1024, 128) valid 900": lambda: f32_case(32, 1024, 128, 900, 3.0),
        # f32 at head dim 96 (the public entries take it; no model calls it),
        # 900 of 1024 keys valid, at 32 and 8 heads and on peaked rows; and
        # the shortest S the route takes
        "f32 d96 (32, 1024, 96) valid 900": lambda: f32_case(32, 1024, 96, 900),
        "f32 d96 (8, 1024, 96) valid 900": lambda: f32_case(8, 1024, 96, 900),
        "f32 d96 spread 3 (32, 1024, 96) valid 900": lambda: f32_case(32, 1024, 96, 900, 3.0),
        "f32 d96 small (8, 256, 96)": lambda: f32_case(8, 256, 96, 256),
        # f32 at head dim 80 (the public entries take it; SAM ViT-H's head
        # dim, which reaches flash attention only through the rel-pos
        # entries), 900 of 1024 keys valid, at 32 and 8 heads and on peaked
        # rows; and the shortest S the route takes
        "f32 d80 (32, 1024, 80) valid 900": lambda: f32_case(32, 1024, 80, 900),
        "f32 d80 (8, 1024, 80) valid 900": lambda: f32_case(8, 1024, 80, 900),
        "f32 d80 spread 3 (32, 1024, 80) valid 900": lambda: f32_case(32, 1024, 80, 900, 3.0),
        "f32 d80 small (8, 256, 80)": lambda: f32_case(8, 256, 80, 256),
        # f32 at head dim 112 (the public entries take it; no model calls it)
        # on the 3xTF32 kernel's Cfg<112>, 900 of 1024 keys valid, at 32 and 8
        # heads and on peaked rows; and the shortest S the route takes
        "f32 d112 (32, 1024, 112) valid 900": lambda: f32_case(32, 1024, 112, 900),
        "f32 d112 (8, 1024, 112) valid 900": lambda: f32_case(8, 1024, 112, 900),
        "f32 d112 spread 3 (32, 1024, 112) valid 900": lambda: f32_case(32, 1024, 112, 900, 3.0),
        "f32 d112 small (8, 256, 112)": lambda: f32_case(8, 256, 112, 256),
        # outside the 3xTF32 routes (head dim 48): the FMA kernel, with SDPA
        # in f32 beside it
        "f32 d48 (32, 1024, 48) valid 900": lambda: f32_case(32, 1024, 48, 900),
        # f32 at head dims 144-256 on the wide 3xTF32 kernel with the key mask
        # (the FMA kernel's 128-feature slices in a tree from before it, and
        # as the entry ``fma``): every key valid and 900 of 1024, on peaked
        # rows, at S 4096, a ragged S at the smallest instance's padded
        # columns, and short sequences (the route takes every S: it beat the
        # slices there too)
        **{f"f32 wide d{d_} ({bh_}, {s_}, {d_}){'' if v_ == s_ else f' valid {v_}'}"
           f"{'' if sp_ == 1.0 else ' spread 3'}":
           (lambda bh_=bh_, s_=s_, v_=v_, d_=d_, sp_=sp_: f32_case(bh_, s_, d_, v_, sp_))
           for bh_, s_, v_, d_, sp_ in ((16, 1024, 1024, 160, 1.0), (16, 1024, 900, 160, 1.0),
                                        (16, 1024, 1024, 256, 1.0), (16, 1024, 900, 256, 1.0),
                                        (16, 1024, 900, 160, 3.0), (16, 1024, 900, 256, 3.0),
                                        (16, 4096, 4096, 256, 1.0), (16, 1000, 999, 144, 1.0),
                                        (16, 1024, 900, 224, 1.0))},
        **{f"f32 wide small d{d_} (16, {s_}, {d_})":
           (lambda s_=s_, d_=d_: f32_case(16, s_, d_, s_))
           for d_ in (160, 256) for s_ in (64, 128, 255)},
        # K4 and K5 in f32 (detector.dtype: float32, BFF_SAM_RELPOS_FLASH=1)
        # at SAM ViT-H's batch of 4 (square and rect grid) and one frame;
        # then K4 on short grids, where the 3xTF32 kernel's pre-pass and
        # latency weigh most (the route's kMinGridH)
        "relpos_f32 k4 (64, 4096, 80)": lambda: relpos_f32_case(64, (64, 64), False),
        "relpos_f32 k4 (16, 4096, 80)": lambda: relpos_f32_case(16, (64, 64), False),
        "relpos_f32 k4 rect (64, 3072, 80)": lambda: relpos_f32_case(64, (48, 64), False),
        "relpos_f32 k5 (1600, 196, 80)": lambda: relpos_f32_case(1600, (14, 14), True),
        "relpos_f32 k5 (400, 196, 80)": lambda: relpos_f32_case(400, (14, 14), True),
        **{f"relpos_f32 small k4 (16, {64 * kh}, 80)":
           (lambda kh=kh: relpos_f32_case(16, (kh, 64), False)) for kh in (1, 2, 4, 8)},
        # K4 in f32 at SAM ViT-L's (and ViT-B's) head dim 64 on the 64 x 64
        # grid, four frames and one
        "relpos_f32 k4 d64 (64, 4096, 64)": lambda: relpos_f32_case(64, (64, 64), False, 64),
        "relpos_f32 k4 d64 (16, 4096, 64)": lambda: relpos_f32_case(16, (64, 64), False, 64),
        "relpos_f32 k4 d64 spread 3 (64, 4096, 64)":
            lambda: relpos_f32_case(64, (64, 64), False, 64, 3.0),
        # K4 in f32 on grids narrower than 64 (portrait frames under
        # BFF_SAM_RECT=1) at head dims 64 and 80, and on peaked rows
        "relpos_f32 k4 kw32 (64, 2048, 64)": lambda: relpos_f32_case(64, (64, 32), False, 64),
        "relpos_f32 k4 kw48 (64, 3072, 64)": lambda: relpos_f32_case(64, (64, 48), False, 64),
        "relpos_f32 k4 kw32 d80 (64, 2048, 80)": lambda: relpos_f32_case(64, (64, 32), False),
        "relpos_f32 k4 kw48 d80 (64, 3072, 80)": lambda: relpos_f32_case(64, (64, 48), False),
        "relpos_f32 k4 kw32 spread 3 (64, 2048, 64)":
            lambda: relpos_f32_case(64, (64, 32), False, 64, 3.0),
        # K4 in f32 at head dim 96 (no configured model calls it) on the
        # 64 x 32, 64 x 48 and 64 x 64 grids, on peaked rows (scores and
        # factors) and at one tile of the narrowest grid
        "relpos_f32 k4 kw32 d96 (64, 2048, 96)": lambda: relpos_f32_case(64, (64, 32), False, 96),
        "relpos_f32 k4 kw48 d96 (64, 3072, 96)": lambda: relpos_f32_case(64, (64, 48), False, 96),
        "relpos_f32 k4 d96 (64, 4096, 96)": lambda: relpos_f32_case(64, (64, 64), False, 96),
        "relpos_f32 k4 kw32 d96 spread 3 (64, 2048, 96)":
            lambda: relpos_f32_case(64, (64, 32), False, 96, 3.0),
        "relpos_f32 k4 kw32 d96 factors 3 (64, 2048, 96)":
            lambda: relpos_f32_case(64, (64, 32), False, 96, 1.0, 3.0),
        "relpos_f32 k4 d96 spread 3 (64, 4096, 96)":
            lambda: relpos_f32_case(64, (64, 64), False, 96, 3.0),
        "relpos_f32 k4 d96 factors 3 (64, 4096, 96)":
            lambda: relpos_f32_case(64, (64, 64), False, 96, 1.0, 3.0),
        "relpos_f32 narrow small k4 kw8 d96 (16, 8, 96)":
            lambda: relpos_f32_case(16, (1, 8), False, 96),
        # kw 36, not a multiple of 8: the straddling mode (each score's whole
        # bias added after the products), beside the FMA kernel and SDPA in
        # f32; at head dims 64 and 96 too
        "relpos_f32 k4 kw36 d80 (64, 2304, 80)": lambda: relpos_f32_case(64, (64, 36), False),
        "relpos_f32 straddle k4 kw36 d64 (64, 2304, 64)":
            lambda: relpos_f32_case(64, (64, 36), False, 64),
        "relpos_f32 straddle k4 kw36 d96 (64, 2304, 96)":
            lambda: relpos_f32_case(64, (64, 36), False, 96),
        "relpos_f32 straddle k4 kw36 d80 factors 3 (64, 2304, 80)":
            lambda: relpos_f32_case(64, (64, 36), False, 80, 1.0, 3.0),
        # the straddling mode across widths (16 heads of 64 grid rows) at
        # head dim 80 beside the FMA kernel: which widths it wins
        **{f"relpos_f32 straddle k4 kw{kw} (16, {64 * kw}, 80)":
           (lambda kw=kw: relpos_f32_case(16, (64, kw), False))
           for kw in (1, 2, 3, 4, 5, 6, 7, 9, 12, 20, 28, 44, 52, 60, 63)},
        # and the narrow mode's widths beside them, at equal S: what the
        # straddle's per-score bias costs
        **{f"relpos_f32 straddle ref k4 kw{kw} (16, {64 * kw}, 80)":
           (lambda kw=kw: relpos_f32_case(16, (64, kw), False))
           for kw in (8, 16, 24, 32, 40, 48, 56)},
        # the narrow mode at its smallest widths and heights, where the
        # pre-pass, a padded tile and the latency weigh most (its kMinGridW)
        **{f"relpos_f32 narrow small k4 kw{kw} ({16}, {kh * kw}, 64)":
           (lambda kh=kh, kw=kw: relpos_f32_case(16, (kh, kw), False, 64))
           for kh, kw in ((1, 8), (8, 8), (64, 8), (4, 16), (1, 24), (2, 40))},
        # K4 in f32 on grids past 64 x 64 (no configured model calls them),
        # beside the FMA kernel they displace (the entry ``fma``; a tree from
        # before them runs it through the entry) and SDPA in f32: kh past 64
        # on the wide, narrow and straddling modes (route 1), kw past 64 on
        # the streamed mode (route 2; ``k4_tf32_bw_from_l2`` its other plan),
        # peaked rows, and 17 x 17 windows (K4's kernel, windows as heads)
        **{f"relpos_f32 grids {kh}x{kw}{'' if d == 80 else f' d{d}'} ({g}, {kh * kw}, {d})":
           (lambda g=g, kh=kh, kw=kw, d=d: relpos_f32_case(g, (kh, kw), False, d))
           for g, kh, kw, d in ((16, 72, 36, 80), (16, 80, 64, 80), (16, 255, 2, 64),
                                (16, 72, 36, 96), (16, 257, 1, 80), (16, 2, 255, 64),
                                (16, 1, 300, 64), (16, 64, 128, 80), (16, 72, 72, 80),
                                (4, 136, 136, 80), (16, 72, 72, 96), (16, 1, 65, 64),
                                (16, 8, 100, 80))},
        "relpos_f32 grids 2x255 spread 3 (16, 510, 64)":
            lambda: relpos_f32_case(16, (2, 255), False, 64, 3.0),
        "relpos_f32 grids 72x72 factors 3 (16, 5184, 80)":
            lambda: relpos_f32_case(16, (72, 72), False, 80, 1.0, 3.0),
        "relpos_f32 grids window 17x17 (256, 289, 80)":
            lambda: relpos_f32_case(256, (17, 17), True),
        # K4 in f32 at head dims 32, 48, 112 and 128 (no configured model
        # calls them) on the 3xTF32 kernel's four modes, beside the FMA kernel
        # they displace (the entry ``fma``; a tree from before them runs it
        # through the entry) and SDPA in f32; ``k4_tf32_plan_b`` the other
        # plan at 112 and 128; peaked rows and large factors
        **{f"relpos_f32 dims {kh}x{kw} d{d} ({g}, {kh * kw}, {d})":
           (lambda g=g, kh=kh, kw=kw, d=d: relpos_f32_case(g, (kh, kw), False, d))
           for d in (128, 112, 48, 32)
           for g, kh, kw in ((16, 64, 64), (16, 64, 36), (16, 64, 32), (16, 64, 128),
                             (16, 2, 255))},
        **{f"relpos_f32 dims {what} d{d} (16, 4096, {d})":
           (lambda d=d, sp=sp, fs=fs: relpos_f32_case(16, (64, 64), False, d, sp, fs))
           for d in (128, 112, 48, 32)
           for what, sp, fs in (("spread 3", 3.0, 0.1), ("factors 3", 1.0, 3.0))},
        # and at those head dims where the pre-pass and latency weigh most,
        # beside the FMA kernel (the entry ``fma``): the lines of K4's
        # predicates (kMinGridH, kMinGridW, kMinStraddleW) on short wide
        # grids, the narrowest widths of the narrow and straddling modes and
        # one streamed row
        **{f"relpos_f32 small dims {kh}x{kw} d{d} (16, {kh * kw}, {d})":
           (lambda kh=kh, kw=kw, d=d: relpos_f32_case(16, (kh, kw), False, d))
           for d in (128, 112, 48, 32)
           for kh, kw in ((1, 64), (2, 64), (4, 64), (8, 64), (1, 8), (8, 8), (1, 65),
                          *((64, w) for w in range(1, 8)))},
        # YOLO-World-L's NMS over the batch of 4: 8 400 anchors, top_k 100;
        # the large mode at the same frames (what staging the boxes buys) and
        # at frames past the staged kernel's 90 112 boxes
        "nms (4, 8400)": lambda: nms_case(4, 8400),
        "nms large-mode (4, 8400)": lambda: nms_case(4, 8400, large=True),
        "nms large (2, 90113)": lambda: nms_case(2, 90113, large=True),
        "nms large (2, 393216)": lambda: nms_case(2, 393216, large=True),
        "nms large (1, 1048576)": lambda: nms_case(1, 1048576, large=True),
    })
    if args.cases:
        cases = {k: v for k, v in cases.items()
                 if any(k.startswith(c) for c in args.cases.split(","))}
    os.makedirs(args.out, exist_ok=True)
    lines = []
    for case, make in cases.items():
        # K1: (unique bytes, corner-row bytes); K3-K6: (library call,
        # operations, bytes[, peak operations a second])
        fn, launch, check, *nbytes = make()
        nms_extra = nbytes.pop() if nbytes and isinstance(nbytes[0], dict) else None
        library, flops, io_bytes, *peak = (nbytes if nbytes and callable(nbytes[0])
                                           else (None, None, None))
        peak = peak[0] if peak else PEAK_FLOPS["bfloat16"]
        if library:
            nbytes = []
        calls = {n: (lambda lib=lib: launch(lib)) for n, lib in libs.items() if has(lib, fn)}
        shipped = libs.get("shipped")
        if getattr(launch, "fma", None) and shipped is not None and has(shipped, launch.fma[0]):
            # the FMA kernel on the same call, one more entry of the rounds
            calls["fma"] = lambda: launch.fma[1](shipped)
        if getattr(launch, "smem_split", None):
            # the tf32_smem_split variant on its own entry, in place of the
            # (unedited) pre-pass kernel
            for n, lib in libs.items():
                if n.startswith("tf32_smem"):
                    calls[n] = lambda lib=lib: launch.smem_split(lib)
        if getattr(launch, "staged", None):
            # the k1_staged* variants on the staged kernel's own entry, in
            # place of their (unedited) gather
            for n, lib in libs.items():
                if n.startswith("k1_staged"):
                    calls[n] = lambda lib=lib: launch.staged(lib)
        excess, digest = {}, {}
        for n in list(calls):
            try:
                got = calls[n]()
                excess[n] = check(got)
                if isinstance(got, torch.Tensor):  # bit-for-bit comparisons across variants
                    digest[n] = hashlib.sha256(got.contiguous().view(torch.uint8)
                                               .cpu().numpy().tobytes()).hexdigest()[:16]
            except RuntimeError as err:  # a failed launch: recorded, not timed
                rec = {"case": case, "variant": n, "right": False, "error": str(err),
                       "card": card}
                lines.append(rec)
                print(json.dumps(rec), flush=True)
                del calls[n]
        if library:
            calls["library"] = library
            excess["library"] = check(library())
        if getattr(launch, "plain", None):  # f32: the plain version, one more yardstick
            calls["plain"] = launch.plain
            excess["plain"] = check(launch.plain())
        times = {n: [] for n in calls}
        for r in range(ROUNDS):
            for n in list(calls) if r % 2 == 0 else list(calls)[::-1]:
                times[n].append(event_ms(calls[n], 20))
        f32 = case.startswith(("f32", "relpos_f32"))
        for n in calls:
            rec = {"case": case, "variant": n, "ms": min(times[n]), "ms_rounds": times[n],
                   "right": excess[n] <= 0.0, "excess": excess[n], "card": card}
            if n in digest:
                rec["digest"] = digest[n]
            if library:  # K3-K6 and their yardstick: device time, rates, bound, host time
                rec["device_ms"] = device_ms(calls[n])
                rec["tflops"] = flops / rec["device_ms"] / 1e9
                rec["gbps"] = io_bytes / rec["device_ms"] / 1e6
                ops_ms = flops / peak * 1e3
                bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
                rec["bound_ms"] = max(ops_ms, bytes_ms)
                rec["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
                if f32:  # 3xTF32 above, f32 FMAs here
                    rec["bound_ms"], rec["bound_fma_ms"], rec["bound_by"] = (
                        f32_attention_bounds(flops, io_bytes))
                rec["host_us"] = host_us(calls[n])
                if f32 and n not in ("library", "plain", "fma"):
                    # the 3xTF32 call's pre-pass (split_kv_kernel, K4's
                    # split_kv_relpos_kernel, the wide kernel's
                    # wide_split_kernel) a call
                    spans = device_spans(lambda: [calls[n]() for _ in range(5)])
                    rec["prepass_ms"] = sum(e - s_ for s_, e, name in spans
                                            if "split_kv" in name
                                            or "wide_split" in name) / 5e3
                if n in ("library", "plain"):
                    rec["right"] = None  # a yardstick, not a variant: not gated
            if nms_extra:  # NMS: device time, its split, the bound (IoU tests at the f32 peak)
                rec["device_ms"] = device_ms(calls[n])
                rec.update(nms_extra["split"](calls[n]))
                ops_ms = nms.IOU_OPS * nms_extra["iou_tests"] / PEAK_FLOPS["float32"] * 1e3
                bytes_ms = nms_extra["bytes"] / HBM_BYTES_PER_S * 1e3
                rec["bound_ms"] = max(ops_ms, bytes_ms)
                rec["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
                rec["kept"] = nms_extra["kept"]
            if nbytes:  # K1: device time, the rates of unique and corner bytes, the bound
                rec["device_ms"] = device_ms(calls[n])
                rec["gbps"] = nbytes[0] / rec["device_ms"] / 1e6
                rec["corner_gbps"] = nbytes[1] / rec["device_ms"] / 1e6
                rec["bound_ms"] = nbytes[0] / HBM_BYTES_PER_S * 1e3
            lines.append(rec)
            print(json.dumps(rec), flush=True)
        del launch, check
        torch.cuda.empty_cache()
    with open(os.path.join(args.out, "kernel_variants.json"), "w") as f:
        f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    for name in libs:
        for rep in sorted(os.listdir(os.path.join(OUT, name))):
            if rep.endswith(".ptxas.txt"):
                shutil.copy(os.path.join(OUT, name, rep),
                            os.path.join(args.out, f"ptxas_{name}_{rep}"))
    if not all(x["right"] for x in lines if x["right"] is not None):
        raise SystemExit("a variant disagrees with the plain version")


if __name__ == "__main__":
    main()
