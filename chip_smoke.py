"""Smoke run of the PyTorch/CUDA port (beyondff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each one's failure ends the run with a non-zero exit):

1. read the card's name and power limit (``nvidia-smi``) and build the
   CUDA kernels from ``beyondff_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (the 800x1072 Grounding-DINO encoder raster and the 900-query
   decoder, for one frame and for the main path's batch of 4), in bf16 and
   f32, and time kernel, plain version and, for attention,
   ``scaled_dot_product_attention`` as a yardstick (CUDA events around a
   loop of calls, ``ms``); for every kernel (bf16 attention) and its
   yardstick also the device time per call from ``torch.profiler``
   (``device_ms``, which leaves out the wrapper's host work) and the rate
   it gives (``tflops``, ``tops`` for mask IoU, ``gbps`` for deformable
   sampling); K5 also beside the SAM encoder's own dense windowed
   attention (``dense_path_ms``), which it does not replace on any path;
   every record names its kernel's ``design``;
3. check the port on a small input against its own plain CPU path (the path
   the CPU tests hold against the JAX package);
4. write Grounding-DINO Swin-B, CLIP ViT-L/14 and SAM ViT-H (seeded
   random weights, built in bf16) to their official checkpoint layouts in a
   temporary directory (``{"model": {"module." + key}}`` f32 with the
   ignored extra keys, a plain f32 dict with the mask-prompt stack, an fp16
   TorchScript archive with OpenAI's scalars), plus a BERT ``vocab.txt``
   and a CLIP merges file; build ``Segmentor2D(cfg)`` from those paths with
   no model injected, check every loaded tensor against the written one
   after the same cast, bit for bit, and print each model's load seconds,
   the GB read and the peak device memory during the load; then drive the
   2D stage's ``run()`` on the loaded models, in bf16, on one 8-frame
   968x1296 scene, with launch counts reset just before it: K2, the
   decoder's self-attention, must run once a decoder layer a detect batch,
   all through its wgmma kernel (``flash_masked_wgmma``; ``flash_attention``,
   the mma.sync tile's counter, stays 0); reload and check the written
   ``.pth``;
5. run the scene once more under ``torch.profiler`` for the device's busy
   share and the kernels that take its time;
6. drive the class sweep at full width with the phase-4 (loaded) models:
   ``SweepRunner.run(amortize_segmentation=True)`` over three classes of a
   ray-cast scene (50 000 points, 16 frames at 968x1296, 640x480 depth),
   fused captions, ``BFF_SAM_RELPOS_FLASH=1``, after three timed 2D passes
   (per-class ``run()``, ``run_classes`` unfused and fused, whose banked
   records must equal the per-class ones); launch counts are set to 0 just
   before the sweep and read after it, and every K4 launch must count as
   its wgmma kernel (``flash_attention_relpos_wgmma``); then the
   ``sam_encode`` span with the rel-pos flash kernel off, on, on, off;
7. drive the 3D half — ``projection.run`` -> ``refinement.run`` ->
   ``evaluate.run`` — at full width for one (class, scene): 250 000 points,
   300 frames with 640x480 depth, 600 lifted 968x1296 masks, 150 stage-1
   masks, CLIP ViT-L/14 text similarity from ``build_text_similarity``
   over phase 4's archive; the scene is ray-cast from a seed
   (a room with twelve boxes, four of the query class) and written to disk
   before the timed run. Launch counts are set to 0 before each stage and
   read after it; the outputs are reloaded and checked, and the projection
   runs once more under ``torch.profiler``;
8. drive the fast variant at full width: write YOLO-World-L (the
   ultralytics layout, f32, with the batch-norm counters and the DFL conv)
   and EfficientSAM-S (``{"model": ...}`` f32, a class-token slot in its
   position embedding) from seeded random weights, build
   ``Segmentor2D(cfg)`` with ``detector.kind: yolo_world`` from those paths
   and phase 4's CLIP archive with no model injected, check every loaded
   tensor bit for bit, run ``run()`` on the 8-frame 968x1296 scene in the
   hit regime (two-tier uploads, YOLO-World in f32, EfficientSAM in bf16,
   hash guide embeddings) with launch counts set to 0 just before it: K3
   must run 12 times per SAM encode batch, all through its wgmma kernel
   (``flash_attention_wgmma``; ``flash_attention`` and K2's
   ``flash_masked_wgmma`` stay 0), and the NMS kernel once per detection
   batch; then a profiled pass
   and banked ``run_classes`` over three classes against per-class
   ``run()``;
9. drive the training path and the parallel layer on a one-rank NCCL group
   and a 1 x 1 mesh, launch counts set to 0 just before and read after
   (no kernel lies on this path: all must stay 0): ``attend`` on CUDA
   inputs that require grad must raise (line ``autograd_guard``); CLIP
   ViT-L/14 contrastive steps in f32 at batch 32, 224 px, context 77
   through ``make_sharded_train_step`` (a warm-up step counted by
   ``mfu.program_cost``, three steps timed with CUDA events; losses, step
   ms, ``mfu.summarize`` of the median step, the f32 and bf16 bounds, peak
   memory); the state
   through ``training.checkpoint`` and back, the next step bit-equal with
   and without the round trip; SAM ViT-H decoder fine-tuning on 64 x 64 x
   256 embeddings of 8 synthetic 1024 x 1024 frames from the port's f32
   encoder, one box a frame with its rectangle as the target, five steps
   (the first counted by ``mfu.program_cost``, four timed): the loss falls, image-encoder leaves move only by AdamW's decay (the
   JAX step's behaviour), every decoder-transformer leaf moves beyond it;
   the sharded RLE and packed lifts over phase 7's 250 000-point,
   300-frame fixture, equal to ``core.geometry``'s;
10. the native runtime against numpy / OpenCV, each transport against its
   dense path, and the fast variant's ``run()`` with the JAX package's
   transport defaults against every transport off (hit and miss, one
   round), and projection with ``BFF_DEPTH_PACK`` 1 and 0;
11. the rect encode (``tools/measure_sam_rect.py`` on SAM ViT-H with
   ``BFF_SAM_RELPOS_FLASH=1`` and on EfficientSAM-S, bf16, a batch of 4
   968x1296 frames: encoder ms square against rect, embedding deviation,
   mask IoU, launch counts, K4 all through ``flash_attention_relpos_wgmma``;
   K3 at (24, 3072, 64) against its plain version and SDPA; K4 at (64,
   3072, 80) is phase 2's); YOLO-World-L with the v1 head
   from a v1-layout file, card against CPU, NMS index for index; the
   fast variant's hit regime with the frame prefetch off, on with one
   loader thread and with four (records byte-equal); the port's
   ``make_synthetic_scene`` and ``single_scene`` on the card at full width
   from phase 4's checkpoint files, under ``utils/profiling.trace`` (the
   PLYs and the viewer parse, K1, K2 and K6 launch, and the trace names
   every kernel launched); projection, ``predict_batch`` and
   ``encode_frames`` inside ``shard_frames`` over a one-rank NCCL group
   against no group.
12. the deferred seg2d pipeline at full width on 24 frames (``frame_batch``
   4, six batches): phase 4's loaded classic models in the hit regime
   under (``BFF_SEG2D_INFLIGHT``, ``BFF_SEG2D_DEFER``,
   ``BFF_SEG2D_EAGER_SAM``) = (1, 0, 1), the serial order, and (2, 1, 1),
   the JAX default, one round each; phase 8's fast variant on 24
   baseline JPEGs (JXT) in the hit and miss regimes under (1, 0, 1),
   (2, 1, 1), (2, 1, 0) and (3, 2, 1); launch counts set to 0 before each
   timed run; every run of a regime writes byte-equal records; one more
   pass of each setting under ``torch.profiler`` and
   ``torch.cuda.set_sync_debug_mode("warn")`` gives the device's busy
   share and the synchronizing calls per batch with their call sites. Then
   the five profiling CLIs at full width (``tools/profile_models``,
   ``profile_sam`` with ``BFF_SAM_ABLATE`` and the global blocks' branch,
   ``profile_gdino_blocks``, ``profile_enhancer``,
   ``measure_depth_decimation``), a few iterations each.
13. the windowed clamp of K1 against exact sampling
   (``tools/measure_deform_window``, bf16): at the encoder raster (8 heads
   x 32, 4 points), N(0, sigma) offsets of 1, 2, 3, 4 and 8 cells, each
   level in the main path's mode and L0 / L1 at PARITY.md's (16, 16) /
   (8, 8); then Grounding-DINO Swin-B at full width on one 800x1072 input,
   windowed against exact, the encoder's sampling offsets scaled by 0.05,
   0.25, 1 and 4 (launch counts: K1 and K2 on their kernels). At sigma 1
   and the main path's modes no sample clamps and clamp equals exact bit
   for bit; every error is finite; alpha 0.05 moves no box by more than
   1e-3. A ``deform_window_cost`` line puts phase 2's clamp and exact K1
   times at the main path's batch beside the rows.
14. the float32 configuration (``detector.dtype: float32``): both variants
   loaded by ``Segmentor2D(cfg)`` in f32 from phases 4's and 8's
   official-layout files (Grounding-DINO Swin-B, CLIP ViT-L/14, SAM ViT-H;
   YOLO-World-L, EfficientSAM-S, CLIP), one ``frame_batch`` of 4 hit
   frames of the 968x1296 scene each, after a warm-up: frames/s, the
   device's busy share (a profiled pass) and the launches by counter. K2
   in f32 must launch 6 times and K3 12, all on the 3xTF32 kernel
   (``flash_attention_tf32``), the FMA kernel's ``flash_attention_f32`` 0;
   each pass must equal the same pass with ``fa.flash_attention`` swapped
   for ``fa.flash_attention_plain`` inside the phase: the same detections,
   confidences within 1e-4, masks at IoU >= 0.999. Then the classic
   variant once more under ``BFF_SAM_RELPOS_FLASH=1`` (timed, profiled,
   and against its plain-attention pass, which swaps
   ``fa.flash_attention_relpos`` for ``fa.attend_relpos_plain`` too): K4 in
   f32 must launch 4 times (4 global blocks, one SAM encode batch), all on
   the 3xTF32 kernel (``flash_attention_relpos_tf32``), the FMA kernel's
   ``flash_attention_relpos`` 0.

Phase 2 also holds the mask-IoU kernel bit for bit against its plain version
at the aggregation's (600, 250 000) self-IoU and refinement's (20 x 150,
250 000) cross IoU, and at 250 007 points (rows off 16-byte boundaries), and
the rel-pos attention kernels at SAM ViT-H's global (16 B, 4096, 80) and
windowed (400 B, 196, 80) shapes and at the rect grid's (64, 3072, 80)
(bf16 takes the wgmma kernels of ``csrc/relpos_attention_wgmma.cu``, each
call counted under the counter ``flash_attention.relpos_wgmma_route``
names, with its host microseconds a call), the mma.sync tile of
``csrc/attention_tc.cuh``, which keeps every other bf16 call, at SAM
ViT-L's global (64, 4096, 64) and windowed (1600, 196, 64) shapes, K3 at
EfficientSAM-S's global blocks
(6 B, 4096, 64) in bf16, at the rect grid's (24, 3072, 64) and at a ragged
(24, 4095, 64) (each call must count under the counter
``flash_attention.flash_counter`` names), K2 at the decoder's (8 B, 900,
32) for one frame and the batch of 4, unmasked at S = 1024 and with keys
past 900 of 1024 masked, all on its wgmma kernel (``flash_masked_wgmma``),
K2 and K3 in f32 at the same shapes on the 3xTF32 kernel
(``flash_attention_tf32``; each f32 attention record carries ``bound_ms``
at 3xTF32, three TF32 products a product at 495 TFLOP/s, and
``bound_fma_ms`` at the 67 TFLOP/s f32 peak), f32 at head dims 128 and 96
((32, 1024, D) with 900 valid keys) on the same kernel, the D 96 call
beside the FMA kernel on the same inputs (``fma_ms``, through
``bff_flash_attention_f32_fma``, which no wrapper calls), and an f32 call
at head dim 80 on the FMA kernel (``flash_attention_f32``), K4 and K5 in
f32 at SAM ViT-H's shapes (and K4 at the rect grid's and at SAM ViT-L's
head dim 64, (64, 4096, 64), and on the 64 x 32 and 64 x 48 grids of
portrait frames at head dims 64 and 80, the narrow mode, each beside the
FMA kernel through ``bff_flash_attention_relpos_f32_fma``) on the 3xTF32
kernels of ``csrc/relpos_attention_tf32.cu``
(``flash_attention_relpos_tf32``, ``window_attention_relpos_tf32``), K4
at head dim 80 on the 64 x 36 grid (a width no multiple of 8: the
straddling mode) on the same kernel beside the FMA kernel, K4 on grids past
64 x 64 (16 heads: 72 x 36, 80 x 64, 255 x 2 and, at head dim 96, 72 x 36
on the same kernel, ``flash_attention_relpos_tf32``; 64 x 128, 72 x 72 and,
at head dim 96, 72 x 72 on its streamed mode,
``flash_attention_relpos_tf32_streamed``), each beside the FMA kernel it
displaced, which it must beat, and at spread 3 within 1e-4, SAM ViT-H's
global-attention block in f32 (dim 1280, 16 heads, batch 1) on 80 x 64 and
64 x 128 grids under ``BFF_SAM_RELPOS_FLASH=1`` on those two routes within
1e-4 of the output's largest magnitude of the same block on plain
attention, K4 at head dims 32, 48, 112 and 128 (16 heads of 64 x 64, and
64 x 128 at 128 on the streamed mode) on the 3xTF32 kernel's new instances,
each beside the FMA kernel it displaced, which it must beat, and at spread 3
within 1e-4, K4 at head dim 72 and K5 at SAM ViT-L's head dim 64 on the FMA
kernels (``flash_attention_relpos``,
``window_attention_relpos``), the mma.sync tile at (32, 1024, 64) with keys
masked, the shapes past the port's old limits (``past_limits``: K2/K3 at
head dims 160 and 256, bf16 on the wide wgmma kernel
(``flash_attention_wide_wgmma``; at (16, 4096, 256) too) and at 264 on the
tile's slices, K4 at head dim 160 and at kh + kw past 256, bf16 on the tile
with streamed factors (``flash_attention_relpos_streamed``; SAM's global
attention on a 136 x 136 grid too), f32 on the 3xTF32 kernel's streamed
mode, and at head dim 160 on the FMA kernel, K5 on 17 x 17 windows (f32 on
the 3xTF32 kernel), K1 at 9 levels and at head dim 160), and the NMS kernel
index for index at YOLO-World-L's 8 400 anchors for a batch of 4 (top_k
100; its device time split into the sort, the gather and the scan), at
thresholds set to pairs' exact IoUs, and past the staged kernel's 90 112
boxes a frame on its large mode (``nms_fixed_large``: 2 x 90 113, 2 x
393 216, 1 x 1 048 576). Tolerances:
f32 within 1e-4; bf16 K2/K3,
K4 and K5, whose tensor-core tile rounds P to bf16 before P V as the TPU
kernels do, within 2^-8 |P|@|V| + 2^-7 |plain| + 1e-4
(``flash_attention.bf16_error_bound``; K2 also within 1.6e-2); K1 within
3e-2. Phase 3 also runs the 3D half
on a small scene on the card and on the CPU and requires equal outputs and
an equal AP row, the class sweep at the "test" presets on both, with
equal 3D outputs and results rows, and the fast variant at the "test"
presets on both (f32, cuDNN TF32 off) with two-tier uploads on auto and
forced on: confidences within 1e-4, masks at IoU >= 0.99.

A ``phase_seconds`` line gives each phase's host seconds. The last three
lines are the card's name and power limit, the kernel table (its f32 rows
count the float32 configuration's launches, K4's those of the pass under
``BFF_SAM_RELPOS_FLASH=1``) and
``{"ok": true, "device": ...}``;
every JSON line also goes to ``chiprun_out/chip_smoke.json``. Exits non-zero
without a result when no CUDA device is present.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
N_FRAMES = 8
FRAME_BATCH = 4  # detector.frame_batch, the config default
FRAME_HW = (968, 1296)
REPO = os.path.dirname(os.path.abspath(__file__))


_LINES = []


def check(ok, what):
    """A check of the run's results that holds under ``python -O`` too."""
    if not ok:
        raise AssertionError(what)


def emit(obj):
    _LINES.append(obj)
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


TC_DESIGN = "bf16 mma.sync m16n8k16 + ldmatrix, cp.async 2-stage ring, S and P in registers"
WGMMA_DESIGN = ("bf16 wgmma: S = Q K^T m64n128k16 from shared memory, O += P V m64n64k16 with P "
                "in registers; TMA loads (128-byte swizzle) of 128-key K/V tiles into a 2-stage "
                "mbarrier ring by a producer warpgroup; three consumer warpgroups of 64 rows "
                "(setmaxnreg 32/160) taking turns (pingpong) to issue their products, Q K^T of "
                "tile t issued before P V of tile t - 1")
MASKED_WGMMA_DESIGN = ("bf16 wgmma at head dim 32: the valid keys' 64-key K/V tiles whole in "
                       "shared memory, loaded once by TMA (64-byte swizzle) with a barrier a "
                       "tile, no producer; C in {4, 2, 1} consumer warpgroups of 64 rows "
                       "taking turns (pingpong), S = Q K^T m64n64k16, O += P V m64n32k16 with "
                       "P in registers, Q K^T of tile t before P V of tile t - 1; the output "
                       "rescaled only when a max was raised; the ragged last tile peeled out "
                       "of the loop, its column tiles past valid_len skipping their "
                       "exponentials")
FMA_DESIGN = "f32 FMA from shared memory"
TF32_DESIGN = ("3xTF32 wgmma (hi lo + lo hi + hi hi, each f32 operand split into two rna-rounded "
               "TF32 words): a pre-pass writes K hi/lo and V^T hi/lo (keys of each 8-key group "
               "in the A fragment's order) to scratch; a producer warpgroup TMA-loads 64-key "
               "tiles (128-byte swizzle) into a 2-stage (D 64) or 4-stage (D 32) mbarrier ring; "
               "two consumer warpgroups of 64 rows, Q split once into shared memory, P split "
               "in registers, S = Q K^T m64n64k8, O += P V m64nDk8, taking turns, Q K^T of "
               "tile t before P V of t - 1")
# csrc/relpos_attention_wgmma.cu: K4 (False) and K5 (True)
RELPOS_WGMMA_DESIGN = {
    False: ("bf16 wgmma at head dim 80: each tile two TMA boxes (columns 0-63 in the 128-byte "
            "swizzle, 64-79 in the 32-byte one), S = Q K^T m64n128k16 (4 + 1 k-steps), O += P V "
            "m64n64k16 + m64n16k16 with P in registers; 128-key K/V tiles in a 2-stage mbarrier "
            "ring by a producer warpgroup; three consumer warpgroups of 64 rows (setmaxnreg "
            "32/160) taking turns, each tile's products in turn; bias_w in registers, bias_h "
            "per half-row from shared memory"),
    True: ("bf16 wgmma at head dim 80: a persistent grid, a producer warpgroup keeping two "
           "14 x 14 windows in flight (Q, K, V by TMA in two boxes each, the factor tables by "
           "bulk copies), two consumer warpgroups of two 64-row m-tiles each; S = Q K^T one "
           "m64n200k16 chain, the window's whole softmax in registers, O += P V over 13 k16 "
           "steps (m64n64k16 + m64n16k16)"),
}


# csrc/relpos_attention_tf32.cu: K4 (False) and K5 (True) in f32
RELPOS_TF32_DESIGN = {
    False: ("3xTF32 wgmma at head dim 80: a pre-pass writes each 64-key tile's K hi/lo and V^T "
            "hi/lo (keys of each 8-key group in the A fragment's order) as 32-byte-swizzle "
            "images to scratch; a producer thread bulk-copies them into one K and one V stage; "
            "two consumer warpgroups of 64 rows, Q scaled and split once into shared memory, "
            "the scores' accumulators starting at bias_w from a shared-memory table, bias_h a "
            "row shift, S = Q K^T m64n64k8 (taking turns) after P V of tile t - 1, "
            "P V m64n80k8 with P split in registers, each tile's P V added in f32"),
    True: ("3xTF32 wgmma at head dim 80: a persistent grid over (window, 128-row round) items; "
           "a producer warpgroup reads, splits and writes each 40-key tile of K and V^T into a "
           "2-stage ring (no pre-pass); two consumer warpgroups of 64 rows, Q scaled and split "
           "once a round, the scores' accumulators starting at the bias from the window's "
           "factor tables (keys past 196 at -inf), an online softmax over five tiles, "
           "S = Q K^T m64n40k8 (taking turns), P V m64n80k8, each tile's P V added in f32"),
}


# csrc/relpos_attention_tf32.cu: K4 in f32 on a grid narrower than 64
RELPOS_TF32_NARROW_DESIGN = (
    "3xTF32 wgmma, K4's narrow mode (kw < 64, a multiple of 8): 64-key tiles across grid rows "
    "(the last padded with zero keys by the pre-pass), each score's accumulator starting at "
    "bias_h[q, k / kw] + bias_w[q, k % kw] (bias_w from a shared-memory table, bias_h from "
    "device memory, the group's grid cell advanced without a division, keys past S at -inf); "
    "otherwise the kw = 64 kernel: one K and one V stage (two K stages at D 64), two consumer "
    "warpgroups taking turns, S = Q K^T m64n64k8, P V m64nDk8, each tile's P V added in f32")


# csrc/relpos_attention_tf32.cu: K4 in f32 on a grid whose width is no
# multiple of 8
RELPOS_TF32_STRADDLE_DESIGN = (
    "3xTF32 wgmma, K4's straddling mode (kw < 64, no multiple of 8): 64-key tiles across grid "
    "rows (the last padded with zero keys by the pre-pass), the scores' products summed from "
    "zero and each score's whole bias, bias_h[q, k / kw] + bias_w[q, k % kw], added in f32 "
    "once they are in (bias_w from a shared-memory table at a stride 3 mod 16, bias_h from "
    "device memory, both read while the products run, each key's grid cell advanced without "
    "a division); otherwise the narrow mode's kernel")


# csrc/relpos_attention_tf32.cu: K4 in f32 on a grid wider than 64
RELPOS_TF32_STREAMED_DESIGN = (
    "3xTF32 wgmma, K4's streamed mode (kw > 64): 64-key tiles across at most two grid rows "
    "(the last padded with zero keys by the pre-pass), no block-wide bias_w table: each warp "
    "copies its 16 rows' run of 64 bias_w columns of the next tile into its part of a "
    "shared-memory slot by 4-byte cp.async once it has read the current one, bias_h two reads "
    "a row a tile; the scores' products summed from zero and each score's whole bias added in "
    "f32 once they are in; otherwise the narrow mode's kernel")
# csrc/relpos_attention_tf32.cu: what K4's instances at head dims 112 and
# 128 change in every mode
RELPOS_TF32_32_KEY_DESIGN = (
    ", at head dims 112 and 128 32-key tiles (S = Q K^T m64n32k8; Q's images, a 64-key K and "
    "V stage and the table would pass the block's shared memory), each tile's P V summed "
    "in column parts (two at 112, four at 128), the scores' products from zero and the bias added in f32 after "
    "them")
# csrc/flash_attention.cu, csrc/relpos_attention.cu: head dims past 128
WIDE_WGMMA_DESIGN = ("bf16 wgmma holding the whole head dim (144-256, rounded up to 32, the "
                     "TMA zero-filling the rest): TMA boxes of 64 columns (128-byte swizzle) "
                     "plus 32 (64-byte), 64-key K/V tiles "
                     "in a 2-stage mbarrier ring refilled by the second warpgroup's first "
                     "thread (no producer: 256 threads, 255 registers); two warpgroups of 64 "
                     "rows, S = Q K^T m64n64k16 over D / 16 k-steps, O += P V one chain a box "
                     "with P in registers, pingpong, Q K^T of tile t before P V of tile t - 1, "
                     "the last tile masked")
STREAMED_DESIGN = (TC_DESIGN + ", 4 warps x 32 rows, each 64-key tile's bias_h columns (and, "
                   "past 160 grid columns, bias_w's run of 64) staged by 4-byte cp.async into "
                   "a ring slot beside its K and V, up to 160 columns bias_w whole in a fixed "
                   "table")
RELPOS_WIDE_WGMMA_DESIGN = (WIDE_WGMMA_DESIGN.replace(", the last tile masked", "")
                            + ", the bias added to the scores in f32 before the softmax "
                            "(one FMA with the scale), each 64-key tile's factor columns "
                            "staged by each warp for its own 16 rows by 4-byte cp.async into "
                            "one slot (bias_w whole up to 64 grid columns), keys past S "
                            "masked")
RELPOS_WIDE_TF32_DESIGN = ("3xTF32 wgmma holding the whole head dim (144-256, padded to 32 "
                           "with zeros): one 64-row consumer warpgroup and a producer "
                           "warpgroup that reads each K and V tile (32 keys, 16 at DP 256) "
                           "from device memory and writes its TF32 hi/lo images (no "
                           "pre-pass), Q's images in shared memory, the products from zero "
                           "and each score's whole bias added in f32 after them, each tile's "
                           "P V summed apart in column parts and added in f32")
# csrc/relpos_attention_wide_tf32.cu with the key mask: K2/K3 in f32 at
# head dims 144-256
FLASH_WIDE_TF32_DESIGN = ("3xTF32 wgmma holding the whole head dim (144-256, padded to 32 with "
                          "zeros), K4 f32's wide kernel with a key mask for its score "
                          "modifier: a pre-pass splits each K and V tile up to valid_len "
                          "(32 keys, 16 at DP 256) into TF32 hi/lo images in scratch; one "
                          "64-row consumer warpgroup and a producer warpgroup copying each "
                          "tile's images into one K and one V stage, Q scaled and split into "
                          "shared memory once, the keys past valid_len at -inf, each tile's "
                          "P V summed apart in column parts and added in f32")
SLICED_DESIGN = (", head dims past 128 on a grid axis of 128-feature output slices: each "
                 "block sums its scores over every slice of Q and K, staged in turn, and "
                 "accumulates P V for its own slice of V")


def host_us(torch, fn, iters=50):
    """Host microseconds a call of ``fn``, the launches enqueued back to
    back (the device runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def deform_case(torch, dw, name, q_locs, dtype, modes, dev, rng, b, shapes=None, heads=8, hd=32):
    """One ms_deform_sample comparison + timing at the encoder's levels (or
    ``shapes``, ``heads`` heads of ``hd``); q_locs (Q, 2) query anchors,
    ``b`` frames in the batch (inputs from ``dw.sample_inputs``: offsets
    within 12 cells, every 17th query shifted off the map)."""
    from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS, device_ms

    from beyondff_tpu_torch.kernels import dispatch

    shapes = dw.ENC_SHAPES if shapes is None else shapes
    value, tl, ta = dw.sample_inputs(rng, q_locs, b, dtype, dev, shapes, heads, hd)
    q, heads, lv, p = ta.shape[1:]
    hd = value.shape[-1]
    before = dict(dispatch.launch_counts)
    got = dw.ms_deform_sample(value, shapes, tl, ta, modes)
    went = [key for key, n in dispatch.launch_counts.items() if n != before[key]]
    check(went == ["ms_deform_sample"], f"ms_deform_sample {name}: launched {went}")
    want = dw.ms_deform_sample_plain(value, shapes, tl, ta, modes)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    nbytes = dw.sample_bytes(value, tl, ta)
    flops = b * q * heads * lv * p * 4 * hd * 2  # four corners, one FMA per channel
    dname = str(dtype).split(".")[-1]
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS["float32"] * 1e3  # interpolation runs on the f32 units
    kernel = lambda: dw.ms_deform_sample(value, shapes, tl, ta, modes)
    dev_ms = device_ms(kernel)
    rec = {
        "case": name, "kernel": "ms_deform_sample", "dtype": dname, "batch": b, "queries": q,
        "max_abs_err": err, "tol": tol,
        "ms": cuda_ms(torch, kernel, 20), "device_ms": dev_ms,
        "gbps": nbytes / dev_ms / 1e6,
        "plain_ms": cuda_ms(torch, lambda: dw.ms_deform_sample_plain(value, shapes, tl, ta,
                                                                      modes), 3),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
        "design": "bilinear gather, a lane per 16-byte chunk of a head row (4 lanes a bf16 "
                  "row of 32), a level's 16 corner loads in flight, L and P unrolled, "
                  "f32 FMAs, all levels in one launch" + (
                      ", head dims past 128 on a grid axis of 128-channel slices"
                      if hd > dw.SLICE_CHANNELS else "") + (
                      ", the level table in device memory, levels looped at run time"
                      if dw.device_levels(lv) else ""),
        "levels": lv, "heads": heads, "head_dim": hd,
    }
    emit(rec)
    check(err <= tol, f"ms_deform_sample {name} {dname}: max abs err {err} > {tol}")
    return rec


def fma_yardstick(torch, call, want):
    """The f32-FMA kernel on a call the 3xTF32 route takes, through its
    measurement entry (``call``, which moves no counter): its max abs error
    against the plain version ``want``, its ms (CUDA events) and device ms,
    as ``fma_*`` keys of the 3xTF32 call's record."""
    from beyondff_tpu_torch.utils.profiling import device_ms

    err = float((call().float() - want.float()).abs().max())
    check(err <= 1e-4, f"the f32-FMA yardstick: max abs err {err} > 1e-4")
    return {"fma_max_abs_err": err, "fma_ms": cuda_ms(torch, call, 5),
            "fma_device_ms": device_ms(call)}


def flash_case(torch, fa, name, shape, valid_len, dtype, dev, fma=False, spread=1.0):
    """One K2/K3 comparison + timing. bf16 is held within 1.6e-2 and within
    ``fa.bf16_error_bound`` (P rounded to bf16 before P V, as the TPU kernel
    does, plus one output rounding); f32 within 1e-4. The record names the
    counter the call went through (``flash_attention_wgmma`` for K3's bf16
    head-dim-64 calls, ``flash_masked_wgmma`` for K2's bf16 head-dim-32
    calls), which must be the one ``fa.flash_counter`` names. ``fma``: also
    time the f32-FMA kernel on the same inputs (``fma_yardstick``).
    ``spread`` scales q and k (peaked rows at 3)."""
    import torch.nn.functional as F

    from beyondff_tpu_torch.kernels import dispatch
    from beyondff_tpu_torch.utils.profiling import (HBM_BYTES_PER_S, PEAK_FLOPS, device_ms,
                                                    f32_attention_bounds)

    bh, s, d = shape
    q, k, v = (torch.randn(bh, s, d, device=dev, dtype=torch.float32).to(dtype)
               for _ in range(3))
    if spread != 1.0:
        q, k = q * spread, k * spread
    before = dict(dispatch.launch_counts)
    got = fa.flash_attention(q, k, v, valid_len=valid_len)
    went = [key for key, n in dispatch.launch_counts.items() if n != before[key]]
    routed = fa.flash_counter(int(dtype == torch.bfloat16), d, s, valid_len, d ** -0.5,
                              *(t.data_ptr() for t in (q, k, v, got)))
    check(went == [routed], f"flash_attention {name}: launched {went}, the route says {routed}")
    want = fa.flash_attention_plain(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    bf16 = dtype == torch.bfloat16
    tol = 1.6e-2 if bf16 else 1e-4
    bound = fa.bf16_error_bound(q, k, v, want, valid_len) if bf16 else tol
    excess = float(((got.float() - want.float()).abs() - bound).max())
    dname = str(dtype).split(".")[-1]
    nbytes = 4 * bh * s * d * q.element_size()
    flops = 4 * bh * s * valid_len * d
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dname] * 1e3
    q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
    kernel = lambda: fa.flash_attention(q, k, v, valid_len=valid_len)
    extra = {}
    if fma:
        from beyondff_tpu_torch.kernels import _build

        out_fma = torch.empty_like(q)

        def fma_call():
            rc = _build.library().bff_flash_attention_f32_fma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out_fma.data_ptr(), bh, s, d,
                valid_len, d ** -0.5, torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"bff_flash_attention_f32_fma {name}: code {rc}")
            return out_fma

        extra = fma_yardstick(torch, fma_call, want)
    # the yardstick: SDPA, with a boolean key mask where keys are masked
    mask = (torch.arange(s, device=dev)[None, :] < valid_len) if valid_len < s else None
    library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    dev_ms = device_ms(kernel)
    rec = {
        "case": name, "kernel": routed, "dtype": dname, "shape": list(shape),
        "valid_len": valid_len, "spread": spread, "max_abs_err": err, "tol": tol,
        "tol_excess": excess,
        "bound_tol": "2^-8 |P|@|V| + 2^-7 |plain| + 1e-4" if bf16 else None,
        "ms": cuda_ms(torch, kernel, 50),
        "device_ms": dev_ms, "tflops": flops / dev_ms / 1e9,
        "design": (WGMMA_DESIGN if routed == "flash_attention_wgmma" else
                   MASKED_WGMMA_DESIGN if routed == "flash_masked_wgmma" else
                   WIDE_WGMMA_DESIGN if routed == "flash_attention_wide_wgmma" else
                   FLASH_WIDE_TF32_DESIGN if routed == "flash_attention_wide_tf32" else
                   TF32_DESIGN if routed == "flash_attention_tf32" else
                   TC_DESIGN + ", 4 warps x 16 rows" if bf16 else FMA_DESIGN)
                  + (SLICED_DESIGN if d > fa.HEAD_DIM_SLICE
                     and not routed.startswith("flash_attention_wide") else ""),
        "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, valid_len), 20),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": cuda_ms(torch, library, 50),
        "library_device_ms": device_ms(library), **extra,
    }
    if not bf16:
        # f32-grade work: bound_ms at 3xTF32 on the tensor cores (the fastest
        # way to f32 accuracy), bound_fma_ms at the f32 FMA peak
        rec["bound_ms"], rec["bound_fma_ms"], rec["bound_by"] = f32_attention_bounds(
            flops, nbytes)
        rec["share_of_bound"] = rec["bound_ms"] / dev_ms
        rec["share_of_fma_bound"] = rec["bound_fma_ms"] / dev_ms
    emit(rec)
    check(err <= tol and excess <= 0.0,
          f"flash_attention {name} {dname}: max abs err {err} beyond tolerance")
    check(rec.get("share_of_bound", 0.0) <= 1.0,
          f"flash_attention {name} {dname}: faster than its bound ({rec.get('share_of_bound')})")
    return rec


def relpos_case(torch, fa, wa, sam_mod, name, g, grid, dtype, dev, d=80, fma=False,
                spread=1.0, spread3=False):
    """One rel-pos attention comparison + timing: K4 (``flash_attention_relpos``)
    over a global grid, K5 (``window_attention_relpos``) when ``name`` is a
    window case, at head dim ``d``. q, k, v from a seeded generator; the factors are real q . R
    products (``sam._rel_pos_factors``) of rel-pos tables at 0.1 scale, so
    the bias moves the softmax as a trained table does. The record names the
    counter the call went through (``..._wgmma`` for SAM ViT-H's bf16 calls,
    the kernels of ``csrc/relpos_attention_wgmma.cu``; ``..._tf32`` for its
    f32 calls, the kernels of ``csrc/relpos_attention_tf32.cu``), which must
    be the one ``fa.relpos_counter`` names, and the host microseconds a call
    (``host_us``: the enqueue, tensor maps included; on the wide routes
    ``entry_us`` too, the C entry alone). ``fma``: also time K4's
    f32-FMA kernel on the same inputs (``fma_yardstick``). ``spread`` scales
    q and k (peaked rows at 3; the factors follow q); ``spread3``: also the
    error of the same call on inputs at spread 3 (``max_abs_err_spread3``,
    held within 1e-4)."""
    import torch.nn.functional as F

    from beyondff_tpu_torch.kernels import dispatch
    from beyondff_tpu_torch.utils.profiling import (HBM_BYTES_PER_S, PEAK_FLOPS, device_ms,
                                                    f32_attention_bounds)

    hh, ww = grid
    s = hh * ww
    window = name.startswith("window")
    gen = torch.Generator(device=dev).manual_seed(SEED + g + s)
    q, k, v = (torch.randn(g, s, d, device=dev, generator=gen).to(dtype) for _ in range(3))
    if spread != 1.0:
        q, k = q * spread, k * spread
    rel_h = (0.1 * torch.randn(2 * hh - 1, d, device=dev, generator=gen)).to(dtype)
    rel_w = (0.1 * torch.randn(2 * ww - 1, d, device=dev, generator=gen)).to(dtype)
    bias_h, bias_w = (t.to(dtype).contiguous() for t in
                      sam_mod._rel_pos_factors((hh, ww), (hh, ww), rel_h, rel_w, q))
    if window:
        kernel = lambda: wa.window_attention_relpos(q, k, v, bias_h, bias_w, hh, ww)
        plain = lambda: wa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, hh, ww)
    else:
        kernel = lambda: fa.attend_relpos(q, k, v, bias_h, bias_w, ww)
        plain = lambda: fa.attend_relpos_plain(q, k, v, bias_h, bias_w, ww)
    before = dict(dispatch.launch_counts)
    got = kernel()
    went = [key for key, n in dispatch.launch_counts.items() if n != before[key]]
    routed = fa.relpos_counter(int(window), int(dtype == torch.bfloat16), d, s, hh, ww,
                               d ** -0.5, *(t.data_ptr() for t in (q, k, v, got, bias_h, bias_w)))
    check(went == [routed], f"rel-pos {name}: launched {went}, the route says {routed}")
    want = plain()
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    bf16 = dtype == torch.bfloat16
    if bf16:
        # K4 and K5 in bf16 round P before P V, as the TPU kernels do: the
        # derived bound 2^-8 |P|@|V| + 2^-7 |plain| + 1e-4
        tol = "2^-8 |P|@|V| + 2^-7 |plain| + 1e-4"
        bound = fa.bf16_error_bound(q, k, v, want, bias_h=bias_h, bias_w=bias_w)
    else:
        tol = "1e-4"
        bound = torch.full_like(diff, 1e-4)
    excess = float((diff - bound).max())
    err = float(diff.max())
    fma_rec = {}
    if fma:
        from beyondff_tpu_torch.kernels import _build

        out_fma = torch.empty_like(q)

        def fma_call():
            rc = _build.library().bff_flash_attention_relpos_f32_fma(
                *(t.data_ptr() for t in (q, k, v, bias_h, bias_w, out_fma)), g, s, d, hh, ww,
                d ** -0.5, torch.cuda.current_stream().cuda_stream)
            check(rc == 0, f"bff_flash_attention_relpos_f32_fma {name}: code {rc}")
            return out_fma

        fma_rec = fma_yardstick(torch, fma_call, want)
        del out_fma
    if routed.endswith(("_wide_wgmma", "_wide_tf32")) and not window:
        # the wide route's C entry alone (its tensor maps and launch, no
        # Python wrapper; it moves no counter): host microseconds a call
        import ctypes

        from beyondff_tpu_torch.kernels import _build

        out_entry = torch.empty_like(q)
        entry = getattr(_build.library(),
                        "bff_flash_relpos" + routed[len("flash_attention_relpos"):])

        def entry_call():
            rc = entry(*(ctypes.c_void_p(t.data_ptr()) for t in
                         (q, k, v, bias_h, bias_w, out_entry)), g, s, d, hh, ww,
                       ctypes.c_float(d ** -0.5),
                       ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            check(rc == 0, f"{routed} entry {name}: code {rc}")

        fma_rec["entry_us"] = host_us(torch, entry_call)
        del out_entry
    del got, want, diff, bound
    dname = str(dtype).split(".")[-1]
    es = q.element_size()
    nbytes = (4 * g * s * d + g * s * (hh + ww)) * es
    flops = 4 * g * s * s * d
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dname] * 1e3
    # the yardstick: SDPA with the bias as a dense float mask, built outside
    # the timing
    mask = fa.relpos_bias(bias_h, bias_w, dtype).to(dtype)[None]
    q4, k4, v4 = (t[None] for t in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)
    library_ms = cuda_ms(torch, library, 5)
    # what the shape adds to a route's design: K4's kernels for a large
    # window, head-dim slices, factors from device memory, the straddling mode
    on_flash = window and fa.window_on_flash(s, d)
    k4_call = not window or on_flash  # K4's kernels
    wide = routed.endswith(("_wide_wgmma", "_wide_tf32"))
    suffix = ((", K4's kernel with the windows as heads" if on_flash else "")
              + (SLICED_DESIGN if d > fa.HEAD_DIM_SLICE and not wide else "")
              + ("" if fa.relpos_factor_table(hh, ww)
                 or routed.endswith(("_tf32", "_wgmma", "_streamed"))
                 else ", each score's factors read from device memory (kh + kw past 256)")
              + (RELPOS_TF32_32_KEY_DESIGN if routed.startswith("flash_attention_relpos_tf32")
                 and fa.relpos_tf32_tile(d) != fa.RELPOS_TF32_TILE else ""))
    extra = {"design": (RELPOS_WIDE_TF32_DESIGN if wide else
                        RELPOS_TF32_STREAMED_DESIGN if routed.endswith("_tf32_streamed") else
                        (RELPOS_TF32_STRADDLE_DESIGN if k4_call and ww % 8 else
                         RELPOS_TF32_NARROW_DESIGN if k4_call and ww != 64 else
                         RELPOS_TF32_DESIGN[not k4_call]) if routed.endswith("_tf32") else
                        FMA_DESIGN + (", whole-window softmax" if window and not on_flash
                                      else "")) + suffix}
    if not bf16:
        dev_ms = device_ms(kernel)
        bound_ms, bound_fma_ms, bound_by = f32_attention_bounds(flops, nbytes)
        extra.update({"device_ms": dev_ms, "tflops": flops / dev_ms / 1e9,
                      "bound_fma_ms": bound_fma_ms, "share_of_bound": bound_ms / dev_ms,
                      "share_of_fma_bound": bound_fma_ms / dev_ms})
    if bf16:
        # device time per launch of the kernel and of its yardstick
        dev_ms = device_ms(kernel)
        extra = {"device_ms": dev_ms, "tflops": flops / dev_ms / 1e9,
                 "gbps": nbytes / dev_ms / 1e6, "library_device_ms": device_ms(library),
                 "design": (RELPOS_WIDE_WGMMA_DESIGN if wide else
                            RELPOS_WGMMA_DESIGN[window] if routed.endswith("_wgmma") else
                            STREAMED_DESIGN if routed.endswith("_streamed") else
                            (FMA_DESIGN if not fa.relpos_factor_table(hh, ww) else
                             TC_DESIGN + ", 4 warps x 32 rows, " + (
                                 "bias_h as a row shift" if ww % 64 == 0 else
                                 "key coordinates once per tile, the last tile's k16 steps only"))
                            + (", persistent blocks loading the next window ahead"
                               if window and not on_flash else "")) + suffix}
    if window:
        # the SAM encoder's own dense windowed attention (models/sam.py,
        # ViTAttention.forward without a kernel): logits, the dense bias,
        # f32 softmax, P V; a yardstick for wiring K5, not a path of it
        def dense():
            logits = (q * d ** -0.5) @ k.transpose(1, 2)
            logits = logits + sam_mod._rel_pos_bias((hh, ww), (hh, ww), rel_h, rel_w, q)
            return torch.softmax(logits.float(), dim=-1).to(dtype) @ v
        extra["dense_path_ms"] = cuda_ms(torch, dense, 5)
        if bf16:
            extra["dense_path_device_ms"] = device_ms(dense)
    del mask
    rec = {"case": name, "kernel": routed, "dtype": dname, "shape": [g, s, d],
           "grid": [hh, ww], "spread": spread, "max_abs_err": err, "tol_excess": excess,
           "tol": tol,
           "ms": cuda_ms(torch, kernel, 5 if s > 1024 else 20), **extra,
           "host_us": host_us(torch, kernel),
           "plain_ms": cuda_ms(torch, plain, 3),
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "library_ms": library_ms,
           "library_call": "scaled_dot_product_attention with the bias as a float mask",
           **fma_rec}
    if not bf16:  # f32-grade work: 3xTF32 in bound_ms, f32 FMAs in bound_fma_ms
        rec["bound_ms"], rec["bound_by"] = bound_ms, bound_by
    del q, k, v, bias_h, bias_w, q4, k4, v4
    if spread3:
        rec["max_abs_err_spread3"] = relpos_err(torch, fa, wa, sam_mod, window, g, grid, dtype,
                                                dev, d, 3.0, routed)
    emit(rec)
    torch.cuda.empty_cache()
    check(excess <= 0.0, f"{rec['kernel']} {name} {dname}: max abs err {err} beyond tolerance")
    check(rec.get("max_abs_err_spread3", 0.0) <= 1e-4,
          f"{rec['kernel']} {name}: max abs err {rec.get('max_abs_err_spread3')} at spread 3")
    return rec


def relpos_err(torch, fa, wa, sam_mod, window, g, grid, dtype, dev, d, spread, routed):
    """The max abs error against the plain version of one f32 rel-pos call
    as ``relpos_case`` makes it, q and k at ``spread`` (the factors follow
    q), which must move the counter ``routed``."""
    from beyondff_tpu_torch.kernels import dispatch

    hh, ww = grid
    s = hh * ww
    gen = torch.Generator(device=dev).manual_seed(SEED + g + s + 1)
    q, k, v = (torch.randn(g, s, d, device=dev, generator=gen).to(dtype) for _ in range(3))
    q, k = q * spread, k * spread
    rel_h = (0.1 * torch.randn(2 * hh - 1, d, device=dev, generator=gen)).to(dtype)
    rel_w = (0.1 * torch.randn(2 * ww - 1, d, device=dev, generator=gen)).to(dtype)
    bias_h, bias_w = (t.contiguous() for t in
                      sam_mod._rel_pos_factors((hh, ww), (hh, ww), rel_h, rel_w, q))
    before = dict(dispatch.launch_counts)
    if window:
        got = wa.window_attention_relpos(q, k, v, bias_h, bias_w, hh, ww)
        want = wa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, hh, ww)
    else:
        got = fa.attend_relpos(q, k, v, bias_h, bias_w, ww)
        want = fa.attend_relpos_plain(q, k, v, bias_h, bias_w, ww)
    went = [key for key, n in dispatch.launch_counts.items() if n != before[key]]
    check(went == [routed], f"rel-pos {grid} at spread {spread}: launched {went}, not {routed}")
    torch.cuda.synchronize()
    return float((got.float() - want.float()).abs().max())


def sam_block_case(torch, mods, dev, grid, want):
    """SAM ViT-H's global-attention block (``models/sam.py``'s
    ``ViTAttention``: dim 1280, 16 heads of head dim 80, its rel-pos tables
    sized for ``grid``) in f32 at batch 1 on a patch grid past 64 x 64 (80 x
    64 for a 1280 x 1024 input, 64 x 128 for 1024 x 2048), seeded weights
    (rel-pos tables at 0.1, the rest at 0.02): the block under
    ``BFF_SAM_RELPOS_FLASH=1`` (its rel-pos flash branch, which
    ``fa.relpos_shapes_ok`` admits on both grids) must move the counter
    ``want`` once and come within 1e-4 of the output's largest magnitude
    of the same block without the flag (plain attention: the dense bias and
    an f32 softmax), which moves no counter. Both timed (CUDA events)."""
    sam_mod, fa, dispatch = mods
    h, w = grid
    check(fa.relpos_shapes_ok(h, w), f"SAM block {grid}: relpos_shapes_ok refuses it")
    gen = torch.Generator(device=dev).manual_seed(SEED + h * w)
    attn = sam_mod.ViTAttention(1280, 16, True, grid, softmax_f32=True).to(dev)
    with torch.no_grad():
        for pname, p in attn.named_parameters():
            p.copy_((0.1 if "rel_pos" in pname else 0.02)
                    * torch.randn(p.shape, device=dev, generator=gen))
    x = torch.randn(1, h, w, 1280, device=dev, generator=gen)
    flag = "BFF_SAM_RELPOS_FLASH"
    old = os.environ.pop(flag, None)
    try:
        with torch.no_grad():
            plain = lambda: attn(x)
            before = dict(dispatch.launch_counts)
            ref = plain()
            check(dispatch.launch_counts == before, f"SAM block {grid}: the plain pass launched")
            plain_ms = cuda_ms(torch, plain, 3)
            os.environ[flag] = "1"
            before = dict(dispatch.launch_counts)
            got = attn(x)
            moved = {k: n - before[k] for k, n in dispatch.launch_counts.items() if n != before[k]}
            flash_ms = cuda_ms(torch, lambda: attn(x), 5)
    finally:
        os.environ.pop(flag, None)
        if old is not None:
            os.environ[flag] = old
    torch.cuda.synchronize()
    diff = float((got - ref).abs().max())
    peak = float(ref.abs().max())
    rec = {"phase": "sam_global_block_f32", "grid": [h, w], "input_hw": [16 * h, 16 * w],
           "dim": 1280, "heads": 16, "head_dim": 80, "launches": moved,
           "max_abs_diff": diff, "max_abs_out": peak, "tol": 1e-4 * peak,
           "ms_flash": flash_ms, "ms_plain": plain_ms}
    emit(rec)
    del attn, x, got, ref
    torch.cuda.empty_cache()
    check(moved == {want: 1}, f"SAM block {grid}: launched {moved}, not {want} once")
    check(diff <= 1e-4 * peak, f"SAM block {grid}: {diff} from plain attention > 1e-4 x {peak}")
    return rec


# K1 past the by-value table's 8 levels: the encoder's four and five more
# below them (as a deeper feature pyramid would add)
NINE_LEVELS = ((100, 134), (50, 67), (25, 34), (13, 17), (7, 9), (4, 5), (2, 3), (1, 2), (1, 1))


def past_limits(torch, mods, cases, dev, rng):
    """The shapes the JAX kernels take past the port's old limits, each on a
    hand-written kernel whose counter the case checks (the routes the CPU
    mirrors name) and within tolerance of its plain version: K2/K3 at head
    dims 160 and 256, every key valid and keys masked (bf16 on the wide
    wgmma kernel, f32 on the wide 3xTF32 kernel with its key mask, timed
    beside the FMA kernel's head-dim slices it displaced), bf16 at (16,
    4096, 256), and at head dims the wide kernels leave on the slices they
    displaced: bf16 at 264 (the tile's), f32 at 168 (the FMA kernel's);
    K4 at head dim 160 and on grids with kh + kw past 256 (1 x 300, 2 x
    255 and SAM's global attention on a 136 x 136 grid: the tile with
    streamed factors in bf16, the 3xTF32 kernel's streamed mode in f32,
    beside the FMA kernel it displaced and at spread 3); K4 at
    head dims 160 and 256 on 32 x 32 and at 160 on 2 x 255 on the wide
    kernels (bf16 the wgmma kernel with streamed factors, f32 the 3xTF32
    one, timed beside the FMA kernel's slices it displaced), and at head
    dim 168 on the kernels they displaced (bf16 the tile's slices on 32 x
    32 and the FMA kernel's past the table on 2 x 255, f32 the FMA
    kernel's slices); K5 on 17 x 17 windows (K4's kernels: f32 on the
    3xTF32 kernel's straddling mode); K1 at 9 levels (the level table in
    device memory) and at head dim 160 (the channel slices), clamp and
    exact. No configured model
    reaches any of them, and the run's time limit is shared."""
    fa, wa, dw, sam_mod, deformable = mods
    for d in (160, 256):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            for valid, tag in ((1024, "unmasked"), (900, "masked")):
                # f32 beside the FMA kernel's slices it displaced
                cases[(f"flash_d{d}_{tag}", dname, 1)] = rec = flash_case(
                    torch, fa, f"d{d}_1024_{valid}", (16, 1024, d), valid, dtype, dev,
                    fma=dtype == torch.float32)
                check(rec["kernel"] == ("flash_attention_wide_wgmma" if dtype == torch.bfloat16
                                        else "flash_attention_wide_tf32"),
                      f"flash d{d} {tag} {dname}: on {rec['kernel']}")
    for key, name, shape, valid, dtype, want in (
            ("flash_d256_4096", "d256_4096_4096", (16, 4096, 256), 4096, torch.bfloat16,
             "flash_attention_wide_wgmma"),
            ("flash_d264_tile", "d264_1024_900", (16, 1024, 264), 900, torch.bfloat16,
             "flash_attention"),
            ("flash_d168_fma", "d168_1024_900", (16, 1024, 168), 900, torch.float32,
             "flash_attention_f32")):
        dname = str(dtype).split(".")[-1]
        cases[(key, dname, 1)] = rec = flash_case(torch, fa, name, shape, valid, dtype, dev)
        check(rec["kernel"] == want, f"flash {name} {dname}: on {rec['kernel']}, not {want}")
    for key, name, g, grid, d, dtypes in (
            ("relpos_d160", "d160_global", 16, (32, 32), 160, (torch.bfloat16, torch.float32)),
            ("relpos_d256", "d256_global", 16, (32, 32), 256, (torch.bfloat16, torch.float32)),
            ("relpos_kh_kw_300", "grid_1x300_global", 16, (1, 300), 64,
             (torch.bfloat16, torch.float32)),
            ("relpos_kh_kw_257", "grid_2x255_global", 16, (2, 255), 64,
             (torch.bfloat16, torch.float32)),
            ("relpos_136", "grid_136x136_global", 4, (136, 136), 80,
             (torch.bfloat16, torch.float32)),
            ("relpos_past_table_d160", "grid_2x255_d160_global", 16, (2, 255), 160,
             (torch.bfloat16, torch.float32)),
            ("relpos_d168", "d168_global", 16, (32, 32), 168, (torch.bfloat16, torch.float32)),
            ("relpos_past_table_d168", "grid_2x255_d168_global", 16, (2, 255), 168,
             (torch.bfloat16,)),
            ("relpos_window_17", "window_17x17", 256, (17, 17), 80,
             (torch.bfloat16, torch.float32))):
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            bf16, table = dtype == torch.bfloat16, fa.relpos_factor_table(*grid)
            wide = d in fa.WIDE_WGMMA_HEAD_DIMS
            # the wide routes at head dims 144-256, timed beside the kernels
            # they displaced: the FMA kernel's f32 slices here, the bf16
            # ones through tools/kernel_variants.py with the parent's csrc/;
            # head dim 168 keeps the displaced kernels (the tile's slices,
            # past the table the FMA kernel's; the FMA kernel's in f32);
            # f32 at head dims 64-96 on the 3xTF32 kernel (2 x 255, 1 x 300
            # and 136 x 136 on its streamed mode, the 17 x 17 windows on its
            # straddling mode), beside the FMA kernel it displaced, and at
            # spread 3
            tf32 = not bf16 and d in fa.RELPOS_TF32_HEAD_DIMS[0]
            cases[(key, dname, 1)] = rec = relpos_case(
                torch, fa, wa, sam_mod, name, g, grid, dtype, dev, d=d,
                fma=not bf16 and (wide or tf32), spread3=tf32)
            want = ("flash_attention_relpos_wide_wgmma" if bf16 and wide else
                    "flash_attention_relpos_wide_tf32" if wide else
                    "flash_attention_relpos_tf32_streamed" if tf32 and grid[1] > 64 else
                    "flash_attention_relpos_tf32" if tf32 else
                    "flash_attention_relpos_streamed" if bf16 and d <= 128 and not table else
                    "flash_attention_relpos")
            check(rec["kernel"] == want,
                  f"rel-pos {name} {dname}: on {rec['kernel']}, not {want}")
            check(not tf32 or rec["device_ms"] < rec["fma_device_ms"],
                  f"rel-pos {name}: the 3xTF32 kernel ({rec.get('device_ms')} ms) loses to the "
                  f"FMA kernel ({rec.get('fma_device_ms')} ms)")
    anchors9 = dw.raster_centers(NINE_LEVELS)
    anchors = dw.raster_centers(dw.ENC_SHAPES)
    for key, shapes, q_locs, heads, hd in (("deform_9_levels", NINE_LEVELS, anchors9, 8, 32),
                                           ("deform_d160", dw.ENC_SHAPES, anchors, 2, 160)):
        for mode, modes in (("clamp", deformable.level_modes(shapes)),
                            ("exact", (None,) * len(shapes))):
            for dtype in (torch.bfloat16, torch.float32):
                cases[(f"{key}_{mode}", str(dtype).split(".")[-1], 1)] = deform_case(
                    torch, dw, f"{key}_{mode}", q_locs, dtype, modes, dev, rng, 1, shapes,
                    heads, hd)


def synthetic_frame(path, size, noise=12):
    """Deterministic 'photo' for a frame file: smooth shading, a few flat
    boxes and +-``noise`` levels of uniform sensor noise, from the seed and
    the frame number (the frame files themselves are empty markers: no
    image codec is needed)."""
    idx = int(os.path.basename(path).split(".")[0])
    rng = np.random.default_rng(SEED * 1000 + idx)
    w, h = size
    ys = np.cos(np.arange(h, dtype=np.float32) / 70)
    xs = np.arange(w, dtype=np.float32)
    base = np.stack([128 + 60 * np.outer(ys, np.sin(xs / (90 + 10 * c) + idx + c))
                     for c in range(3)], -1)
    for _ in range(6):
        y0, x0 = rng.integers(0, h - 200), rng.integers(0, w - 200)
        dh, dw = rng.integers(60, 200, 2)
        base[y0:y0 + dh, x0:x0 + dw] = rng.uniform(0, 255, 3)
    base += rng.integers(-noise, noise + 1, base.shape, dtype=np.int16)
    return np.clip(base, 0, 255).astype(np.uint8)


def check_records(torch, cfg, cls, scene_id, n_frames):
    """The 2D stage's ``.pth`` contract, read with plain ``torch.load``: one
    record per frame (the hit regime), float32 confidences, string labels,
    one full-frame RLE mask per box."""
    recs = torch.load(os.path.join(cfg.paths.mask_2d_dir, cls, f"{scene_id}.pth"),
                      map_location="cpu", weights_only=False)
    check(len(recs) == n_frames, f"{cls}: {len(recs)} records for {n_frames} frames")
    n = cfg.frames.height_2d * cfg.frames.width_2d
    for r in recs:
        fid = r["frame_id"]
        check(isinstance(fid, str) and fid.endswith(".jpg"), f"frame id {fid!r}")
        conf = r["confidences"]
        check(conf.dtype == torch.float32 and conf.ndim == 1 and len(conf) > 0,
              f"{fid}: confidences {conf.dtype} {tuple(conf.shape)}")
        check(bool(torch.isfinite(conf).all()) and float(conf.abs().max()) <= 1.0 + 1e-3,
              f"{fid}: confidences outside [-1, 1]")
        check(len(r["labels"]) == len(conf) and all(isinstance(x, str) for x in r["labels"]),
              f"{fid}: labels")
        masks = r["segmented_frame_masks"]
        check(len(masks) == len(conf), f"{fid}: {len(masks)} masks for {len(conf)} boxes")
        for m in masks:
            check(m["length"] == n and m["counts"].dtype == np.int64
                  and m["counts"].size % 2 == 0, f"{fid}: malformed RLE")
    return recs


def make_scene(root, scene_id, n):
    color = os.path.join(root, scene_id, "color")
    os.makedirs(color, exist_ok=True)
    for i in range(n):
        open(os.path.join(color, f"{i}.jpg"), "wb").close()


def stage_config(Config, work, tag, hw, frame_batch, dtype, detector=None):
    return Config.from_dict({
        "paths": {"scene_2d_dir": os.path.join(work, "scenes"),
                  "mask_2d_dir": os.path.join(work, f"masks_{tag}"),
                  "checkpoint_dir": os.path.join(work, f"ckpt_{tag}")},
        "frames": {"height_2d": hw[0], "width_2d": hw[1], "downsample_ratio": 1},
        "detector": {"box_threshold": 0.0, "must_match_query": False,
                     "similarity_threshold": -1.0, "frame_batch": frame_batch,
                     "dtype": dtype, **(detector or {})},
    })


def small_reference(torch, mods, work):
    """Port on CUDA vs port on the CPU (plain versions) at the "test" presets,
    f32, one 4-frame 48x64 scene, encoder in clamp mode on both sides."""
    Config, seg2d, gd, sam_mod, clip_mod, io, rle = mods
    make_scene(os.path.join(work, "scenes"), "small", 4)

    def loader(path, size):
        rng = np.random.default_rng(int(os.path.basename(path).split(".")[0]))
        return rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)

    cpu_models = (gd.GroundingDINO.create("test", seed=1, device="cpu"),
                  sam_mod.SAM.create("test", seed=2, device="cpu"),
                  clip_mod.CLIP.create("test", seed=3, device="cpu"))
    gpu_models = (gd.GroundingDINO.create("test", device="cuda"),
                  sam_mod.SAM.create("test", device="cuda"),
                  clip_mod.CLIP.create("test", device="cuda"))
    for a, b in zip(cpu_models, gpu_models):
        b.module.load_state_dict(a.module.state_dict())
    os.environ["BFF_DEFORM_WINDOWED"] = "1"
    try:
        cfgs = {}
        for dev, (det, sam, clip) in (("cpu", cpu_models), ("cuda", gpu_models)):
            cfg = cfgs[dev] = stage_config(Config, work, f"small_{dev}", (48, 64), 2, "float32")
            seg = seg2d.Segmentor2D(cfg, detector=det, sam=sam, clip_model=clip,
                                    frame_loader=loader)
            seg2d.run(cfg, "clothes", scenes=["small"], segmentor=seg, resume=False)
    finally:
        del os.environ["BFF_DEFORM_WINDOWED"]
    worst_conf, worst_iou, n = records_diff(io, rle, cfgs["cpu"], cfgs["cuda"], ["clothes"],
                                            "small")
    rec = {"phase": "small_reference", "masks": n, "max_conf_diff": worst_conf,
           "min_mask_iou": worst_iou, "conf_tol": 1e-4, "iou_min": 0.99}
    emit(rec)
    check(n > 0 and worst_conf <= 1e-4 and worst_iou >= 0.99,
          f"CUDA path disagrees with the CPU path: {rec}")


PORT_KERNELS = ("ms_deform_sample_kernel", "flash_fwd_kernel", "flash_tc_kernel",
                "flash_wgmma_kernel", "flash_masked_wgmma_kernel", "flash_relpos_wgmma_kernel",
                "flash_tf32_kernel", "split_kv_kernel", "flash_relpos_tf32_kernel",
                "split_kv_relpos_kernel", "window_relpos_tf32_kernel", "nms_fixed_kernel")


def profile_scene(torch, seg2d, seg, cfg, scene, timed_scene_s, phase="device_profile"):
    """The same scene once more under ``torch.profiler`` (device activity
    only): the device's busy share of the ``scene`` span and the kernels
    that take the device's time. The timed run above stays unprofiled."""
    from beyondff_tpu_torch.utils.profiling import StageProfiler

    prof = StageProfiler("segmentation_2d")
    busy_us, events, by_name = device_activity(torch, lambda: seg2d.run(
        cfg, "clothes", scenes=[scene], segmentor=seg, resume=False, profiler=prof))
    scene_s = prof.durations["scene"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    ours = {k: v for k, v in by_name.items() if any(n in k for n in PORT_KERNELS)}
    emit({"phase": phase, "scene_seconds_profiled": scene_s,
          "scene_seconds_timed": timed_scene_s, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / scene_s, "device_events": events,
          "top_device_ms": [[name[:120], n, us / 1e3] for name, (n, us) in top],
          "port_kernels_ms": {name[:120]: [n, us / 1e3] for name, (n, us) in ours.items()}})



# ------------------------------------------------------- official checkpoints
VOCAB_WORDS = ("a", "photo", "of", "which", "has", "is", "clothes", "chair", "table")


def write_vocabularies(root):
    """A BERT ``vocab.txt`` and a CLIP merges file that cover the queries and
    the descriptor sentences: whole words, single characters and, for BERT,
    ``##`` continuations and ``[UNK]`` for the rest. CLIP's byte-level BPE
    spells any other word out in bytes; both keep their ids far below the
    full-width vocabularies (30 522 and 49 408)."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    bert = os.path.join(root, "vocab.txt")
    with open(bert, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *VOCAB_WORDS,
                           *".,!?'-", *letters, *("##" + c for c in letters)]) + "\n")
    merges = []
    for w in VOCAB_WORDS:
        syms = list(w[:-1]) + [w[-1] + "</w>"]
        for i in range(1, len(syms)):
            merges.append(f"{''.join(syms[:i])} {syms[i]}")
    bpe = os.path.join(root, "merges.txt")
    with open(bpe, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(dict.fromkeys(merges)) + "\n")
    return bert, bpe


def mask_prompt_stack(torch, g):
    """SAM's mask-prompt downscaling stack (256-d prompts), which the
    box-prompted stage's loaders ignore."""
    return {"prompt_encoder.mask_downscaling.0.weight": torch.randn(4, 1, 2, 2, generator=g),
            "prompt_encoder.mask_downscaling.0.bias": torch.randn(4, generator=g),
            "prompt_encoder.mask_downscaling.1.weight": torch.ones(4),
            "prompt_encoder.mask_downscaling.1.bias": torch.zeros(4),
            "prompt_encoder.mask_downscaling.3.weight": torch.randn(16, 4, 2, 2, generator=g),
            "prompt_encoder.mask_downscaling.3.bias": torch.randn(16, generator=g),
            "prompt_encoder.mask_downscaling.4.weight": torch.ones(16),
            "prompt_encoder.mask_downscaling.4.bias": torch.zeros(16),
            "prompt_encoder.mask_downscaling.6.weight": torch.randn(256, 16, 1, 1, generator=g),
            "prompt_encoder.mask_downscaling.6.bias": torch.randn(256, generator=g)}


def write_checkpoints(torch, clip_mod, root, models):
    """The phase-4 models in the official file layouts, with the keys the
    loaders ignore: Grounding-DINO Swin-B as ``{"model": {"module." + key:
    f32}}`` plus the BERT pooler, the duplicate ``bbox_embed`` heads and
    ``position_ids``; SAM ViT-H as a plain f32 dict plus the mask-prompt
    stack; CLIP ViT-L/14 as an fp16 TorchScript archive with OpenAI's three
    scalars. Returns the paths and the state dicts as written (host)."""
    det, clip, sam = models
    g = torch.Generator().manual_seed(SEED)
    paths, written = {}, {}

    sd = {k: v.float().cpu() for k, v in det.module.state_dict().items()}
    extra = {"bert.pooler.dense.weight": torch.randn(768, 768, generator=g),
             "bert.pooler.dense.bias": torch.randn(768, generator=g),
             "bert.embeddings.position_ids": torch.arange(512)[None]}
    head = {k[len("bbox_embed.0."):]: v for k, v in sd.items() if k.startswith("bbox_embed.0.")}
    for i in range(det.cfg.dec_layers):
        for k, v in head.items():
            if i:
                extra[f"bbox_embed.{i}.{k}"] = v.clone()
            extra[f"transformer.decoder.bbox_embed.{i}.{k}"] = v.clone()
    paths["gdino"] = os.path.join(root, "groundingdino_swinb_cogcoor.pth")
    torch.save({"model": {"module." + k: v for k, v in {**sd, **extra}.items()}},
               paths["gdino"])
    written["gdino"] = sd

    sd = {k: v.float().cpu() for k, v in sam.module.state_dict().items()}
    paths["sam"] = os.path.join(root, "sam_vit_h_4b8939.pth")
    torch.save({**sd, **mask_prompt_stack(torch, g)}, paths["sam"])
    written["sam"] = sd

    sd = {k: v.half().cpu() for k, v in clip.module.state_dict().items()}
    c = clip.cfg
    extra = {"input_resolution": torch.tensor(c.image_resolution),
             "context_length": torch.tensor(c.context_length),
             "vocab_size": torch.tensor(c.vocab_size)}
    paths["clip"] = os.path.join(root, "ViT-L-14.pt")
    clip_mod.save_torchscript_archive({**sd, **extra}, paths["clip"])
    written["clip"] = sd
    return paths, written


def check_loaded(torch, module, written):
    """Every parameter and buffer of a loaded module equals the written
    tensor after the same cast (widened to f32, then the module's dtype),
    bit for bit. Returns the tensors compared."""
    state = module.state_dict()
    unwritten = sorted(set(state) - set(written))
    check(not unwritten, f"loaded keys that were not written: {unwritten[:5]}")
    for key, t in state.items():
        ref = written[key].to(t.device).float().to(t.dtype)
        check(torch.equal(t, ref), f"{key}: the loaded weights differ from the written ones")
    return len(state)


def load_from_checkpoints(torch, mods, Config, work, models):
    """Phase 4's models through the checkpoint files: written in the official
    layouts to a temporary directory, loaded by ``Segmentor2D(cfg)`` with no
    model injected, and checked bit for bit. Returns the segmentor's
    config, the segmentor, and the directory holding the files."""
    seg2d, clip_mod = mods
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t0 = time.perf_counter()
    bert_vocab, clip_bpe = write_vocabularies(root)
    paths, written = write_checkpoints(torch, clip_mod, root, models)
    emit({"phase": "write_checkpoints", "seconds": time.perf_counter() - t0,
          "bytes": {k: os.path.getsize(v) for k, v in paths.items()}})
    cfg = stage_config(Config, work, "full", FRAME_HW, FRAME_BATCH, "bfloat16", {
        "gdino_checkpoint": paths["gdino"], "sam_checkpoint": paths["sam"],
        "clip_checkpoint": paths["clip"], "bert_vocab_path": bert_vocab,
        "clip_bpe_path": clip_bpe})
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seg = seg2d.Segmentor2D(cfg, frame_loader=synthetic_frame)
    total_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    resident = torch.cuda.memory_allocated() - base
    tensors = {name: check_loaded(torch, m.module, written[name])
               for name, m in (("gdino", seg.detector), ("sam", seg.sam), ("clip", seg.clip))}
    for name, m in (("gdino", seg.detector), ("sam", seg.sam), ("clip", seg.clip)):
        check(m.device.type == "cuda" and m.dtype == torch.bfloat16,
              f"{name} loaded on {m.device} in {m.dtype}")
    check(type(seg.detector.tokenizer).__name__ == "BertTokenizer"
          and type(seg.clip_tokenizer).__name__ == "ClipTokenizer", "tokenizers")
    emit({"phase": "checkpoint_load", "dtype": "bfloat16", "seconds": total_s,
          "load_seconds": seg.load_seconds,
          "gb_read": {k: os.path.getsize(v) / 1e9 for k, v in paths.items()},
          "tensors_checked": tensors, "bit_exact": True,
          "peak_memory_during_load_bytes": peak, "resident_bytes_after_load": resident})
    return cfg, seg, root


# ------------------------------------------------------------ the 3D half
ROOM = np.array([6.0, 5.0, 3.0])  # a bedroom-living room, metres
OBJECTS = (  # (ScanNet200 class, box centre, box size): four of the query class
    ("clothes", (0.8, 0.9, 0.25), (0.7, 0.5, 0.5)),
    ("chair", (1.9, 0.7, 0.45), (0.5, 0.5, 0.9)),
    ("table", (3.2, 0.8, 0.4), (1.2, 0.7, 0.8)),
    ("clothes", (4.6, 0.6, 0.15), (0.6, 0.6, 0.3)),
    ("cabinet", (5.5, 1.8, 0.6), (0.7, 0.9, 1.2)),
    ("bed", (5.0, 3.6, 0.3), (1.6, 1.4, 0.6)),
    ("clothes", (4.9, 3.6, 0.7), (0.6, 0.5, 0.2)),
    ("desk", (3.0, 4.5, 0.4), (1.2, 0.6, 0.8)),
    ("shelf", (1.2, 4.7, 1.0), (1.0, 0.4, 2.0)),
    ("couch", (0.5, 2.8, 0.4), (0.8, 1.8, 0.8)),
    ("clothes", (0.5, 2.8, 0.9), (0.5, 0.6, 0.2)),
    ("lamp", (2.4, 3.9, 0.5), (0.3, 0.3, 1.0)),
)
QUERY = "clothes"
# ScanNet's color camera (968x1296); the depth camera is the same one at 480x640
COLOR_K = np.array([[1169.6, 0.0, 646.3], [0.0, 1167.1, 489.9], [0.0, 0.0, 1.0]])
STAGE1_CLASSES = ("chair", "table", "door", "cabinet", "shelf", "desk", "bed", "pillow",
                  "window", "picture", "lamp", "towel", "box", "bag", "clothes", "trash can")


def box_surface(rng, lo, hi, n):
    """``n`` points uniform on the surface of the box [lo, hi]."""
    s = hi - lo
    areas = np.array([s[1] * s[2]] * 2 + [s[0] * s[2]] * 2 + [s[0] * s[1]] * 2)
    face = rng.choice(6, n, p=areas / areas.sum())
    p = lo + rng.random((n, 3)) * s
    axis = face // 2
    p[np.arange(n), axis] = np.where(face % 2 == 1, hi[axis], lo[axis])
    return p


def camera_poses(n, yaw_span):
    """Camera-to-world poses on a loop around the room's centre, looking out
    and 20 degrees down, turning by ``yaw_span`` radians over ``n`` frames."""
    poses = []
    for k in range(n):
        a = yaw_span * k / n
        c = np.array([3.0 + 0.6 * np.cos(a), 2.5 + 0.5 * np.sin(a), 1.4 + 0.1 * np.sin(3 * a)])
        pitch = -0.35
        f = np.array([np.cos(a) * np.cos(pitch), np.sin(a) * np.cos(pitch), np.sin(pitch)])
        r = np.cross(f, [0.0, 0.0, 1.0])
        r /= np.linalg.norm(r)
        pose = np.eye(4)
        pose[:3, :3] = np.column_stack([r, np.cross(f, r), f])
        pose[:3, 3] = c
        poses.append(pose)
    return poses


def ray_cast(torch, dev, pose, k, hw):
    """Dense (depth along the optical axis, hit object id; -1 = room) of
    the room and its boxes, seen by a pinhole camera at pixel centres."""
    h, w = hw
    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float64),
                          torch.arange(w, device=dev, dtype=torch.float64), indexing="ij")
    d_cam = torch.stack([(u - k[0, 2]) / k[0, 0], (v - k[1, 2]) / k[1, 1],
                         torch.ones_like(u)], -1)
    rot = torch.as_tensor(pose[:3, :3], device=dev)
    c = torch.as_tensor(pose[:3, 3], device=dev)
    d = d_cam @ rot.T  # t along d is the camera-space depth

    def slab(lo, hi):
        t1 = (torch.as_tensor(lo, device=dev) - c) / d
        t2 = (torch.as_tensor(hi, device=dev) - c) / d
        return torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)

    depth = slab(np.zeros(3), ROOM)[1]  # inside the room: its far wall
    hit = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    for i, (_, centre, size) in enumerate(OBJECTS):
        c0, s0 = np.asarray(centre), np.asarray(size)
        near, far = slab(c0 - s0 / 2, c0 + s0 / 2)
        closer = (near <= far) & (near > 0) & (near < depth)
        depth = torch.where(closer, near, depth)
        hit = torch.where(closer, i, hit)
    return depth, hit


def make_3d_scene(torch, dev, root, scene_id, n_points, n_frames, yaw_span, color_hw,
                  depth_hw, det_every, masks_per_frame, n_stage1, seed):
    """A ScanNet200-layout scene for projection -> refinement -> evaluation:
    points on a room's surfaces and on twelve boxes (the GT instances),
    depth PNGs and 2D-stage RLE records ray-cast from posed frames, a
    stage-1 file and the GT tuple. Returns the config dict."""
    from beyondff_tpu_torch.core import rle
    from beyondff_tpu_torch.data import scannet200
    from beyondff_tpu_torch.utils import io

    import cv2

    rng = np.random.default_rng(seed)
    n_obj = int(0.4 * n_points) // len(OBJECTS)
    pts, sem, inst = [], [], []
    for i, (cls, centre, size) in enumerate(OBJECTS):
        c0, s0 = np.asarray(centre), np.asarray(size)
        pts.append(box_surface(rng, c0 - s0 / 2, c0 + s0 / 2, n_obj))
        sem.append(np.full(n_obj, scannet200.raw_semantic_id(cls)))
        inst.append(np.full(n_obj, i))
    n_room = n_points - n_obj * len(OBJECTS)
    pts.append(box_surface(rng, np.zeros(3), ROOM, n_room))
    sem.append(np.zeros(n_room))
    inst.append(np.full(n_room, -100))
    pts = np.concatenate(pts).astype(np.float32)
    sem, inst = np.concatenate(sem), np.concatenate(inst)

    d2 = os.path.join(root, "2D", scene_id)
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(os.path.join(d2, sub), exist_ok=True)
    ch, cw = color_hw
    kc = COLOR_K * np.array([[cw / 1296], [ch / 968], [1.0]])
    kc[:2, 2] = (COLOR_K[:2, 2] + 0.5) * [cw / 1296, ch / 968] - 0.5
    kd = kc * np.array([[depth_hw[1] / cw], [depth_hw[0] / ch], [1.0]])
    kd[:2, 2] = (kc[:2, 2] + 0.5) * [depth_hw[1] / cw, depth_hw[0] / ch] - 0.5
    k4 = np.eye(4)
    k4[:3, :3] = kc
    np.savetxt(os.path.join(d2, "intrinsic", "intrinsic_color.txt"), k4)
    records = []
    for i, pose in enumerate(camera_poses(n_frames, yaw_span)):
        open(os.path.join(d2, "color", f"{i}.jpg"), "wb").close()
        np.savetxt(os.path.join(d2, "pose", f"{i}.txt"), pose)
        depth, _ = ray_cast(torch, dev, pose, kd, depth_hw)
        cv2.imwrite(os.path.join(d2, "depth", f"{i}.png"),
                    torch.round(depth * 1000).clamp(0, 65535).cpu().numpy().astype(np.uint16))
        if i % det_every:
            continue
        _, hit = ray_cast(torch, dev, pose, kc, color_hw)
        ids, area = torch.unique(hit[hit >= 0], return_counts=True)
        order = ids[torch.argsort(area, descending=True)].tolist()
        masks = [hit == j for j in order[:masks_per_frame]]
        while len(masks) < masks_per_frame:  # false positives: boxes on whatever is there
            y0, x0 = rng.integers(0, ch // 2), rng.integers(0, cw // 2)
            m = torch.zeros(color_hw, dtype=torch.bool, device=dev)
            m[y0:y0 + rng.integers(ch // 10, ch // 3), x0:x0 + rng.integers(cw // 10, cw // 3)] = True
            masks.append(m)
        flat = torch.stack(masks).reshape(len(masks), -1).cpu().numpy()
        records.append({"frame_id": f"{i}.jpg",
                        "segmented_frame_masks": rle.rle_encode_batch(flat),
                        "confidences": rng.uniform(0.35, 0.95, len(masks)).tolist(),
                        "labels": [QUERY] * len(masks)})
    io.save_frame_records(os.path.join(root, "mask_2d", QUERY, f"{scene_id}.pth"), records)

    d3 = os.path.join(root, "3D")
    for sub in ("npy", "gt", "stage1"):
        os.makedirs(os.path.join(d3, sub), exist_ok=True)
    np.save(os.path.join(d3, "npy", f"{scene_id}.npy"),
            np.concatenate([pts, np.zeros_like(pts)], 1))
    torch.save((pts, np.zeros_like(pts), sem.astype(np.float64), inst.astype(np.float64)),
               os.path.join(d3, "gt", f"{scene_id}.pth"))
    # stage 1: the GT instances with 6% of their points dropped, and segments
    # of the room's surfaces with random labels
    s1_masks, s1_labels = [], []
    for i, (cls, _, _) in enumerate(OBJECTS):
        m = inst == i
        on = np.flatnonzero(m)
        m[on[rng.random(on.size) < 0.06]] = False
        s1_masks.append(m)
        s1_labels.append(scannet200.instance_index(cls))
    room = np.flatnonzero(inst == -100)
    tp = torch.as_tensor(pts, device=dev)
    for _ in range(n_stage1 - len(OBJECTS)):
        centre = tp[rng.choice(room)]
        s1_masks.append(((tp - centre).norm(dim=1) < rng.uniform(0.2, 0.6)).cpu().numpy())
        s1_labels.append(scannet200.instance_index(STAGE1_CLASSES[rng.integers(
            len(STAGE1_CLASSES))]))
    torch.save({"ins": rle.rle_encode_batch(np.stack(s1_masks)),
                "conf": torch.from_numpy(rng.uniform(0.3, 0.9, len(s1_masks)).astype(np.float32)),
                "final_class": s1_labels},
               os.path.join(d3, "stage1", f"{scene_id}.pth"))
    return {
        "paths": {"dataset": "scannet200", "root_dir": root,
                  "scene_npy_dir": os.path.join(d3, "npy"),
                  "scene_2d_dir": os.path.join(root, "2D"),
                  "gt_dir": os.path.join(d3, "gt"),
                  "mask_2d_dir": os.path.join(root, "mask_2d"),
                  "stage_1_results_dir": os.path.join(d3, "stage1")},
        "frames": {"height_2d": ch, "width_2d": cw, "downsample_ratio": 1},
        "base_prompt": QUERY,
    }


def config_3d(Config, fixture, out):
    d = {**fixture, "paths": {**fixture["paths"],
                              "mask_3d_dir": os.path.join(out, "mask_3d"),
                              "final_output_dir": os.path.join(out, "final"),
                              "checkpoint_dir": os.path.join(out, "ckpt"),
                              "results_dir": os.path.join(out, "results")}}
    return Config.from_dict(d)


def run_3d(mods, cfg, dev, sim=None, prof=None):
    """projection.run -> refinement.run -> evaluate.run for the query on one
    device; per stage: host seconds and mask-IoU launches, both kernels'
    (``mask_iou_launches``) and the wgmma kernel's (counts set to 0 just
    before each stage, read just after)."""
    torch, dispatch, projection, refinement, evaluate = mods
    out = {"seconds": {}, "mask_iou_launches": {}, "mask_iou_wgmma_launches": {}}
    for name, call in (
            ("projection", lambda: projection.run(cfg, QUERY, resume=False, device=dev,
                                                  profiler=prof)),
            ("refinement", lambda: refinement.run(cfg, QUERY, sim=sim, device=dev)),
            ("evaluation", lambda: evaluate.run(cfg, QUERY, verbose=False,
                                                plot_pr_curves=False))):
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        result = call()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        out["mask_iou_launches"][name] = (dispatch.launch_counts["mask_iou"]
                                          + dispatch.launch_counts["mask_iou_wgmma"])
        out["mask_iou_wgmma_launches"][name] = dispatch.launch_counts["mask_iou_wgmma"]
        out[name] = result
    return out


def same_ap(a, b):
    """AP dicts equal, nan where the other has nan."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_ap(a[k], b[k]) for k in a)
    if isinstance(a, float) and np.isnan(a):
        return isinstance(b, float) and np.isnan(b)
    return a == b


def stage_outputs(torch, cfg, scene_id):
    return [torch.load(os.path.join(d, QUERY, f"{scene_id}.pth"), map_location="cpu",
                       weights_only=False)
            for d in (cfg.paths.mask_3d_dir, cfg.paths.final_output_dir)]


def small_reference_3d(torch, mods, Config, work, dev):
    """The 3D half on the card against the port's CPU path (the path the CPU
    tests hold against the JAX package): a 5 000-point scene, 6 frames at
    242x324 with 121x162 depth (so the device resize runs), equal stage
    outputs and an equal AP row."""
    fixture = make_3d_scene(torch, dev, os.path.join(work, "small3d"), "scene0000_00", 5000,
                            6, 1.2, (242, 324), (121, 162), 1, 4, 20, SEED)
    runs, outputs, rows = {}, {}, {}
    for name, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        cfg = config_3d(Config, fixture, os.path.join(work, "small3d", name))
        runs[name] = run_3d(mods, cfg, d)
        outputs[name] = stage_outputs(torch, cfg, "scene0000_00")
        with open(os.path.join(cfg.paths.results_dir, "overall_results.txt")) as f:
            rows[name] = [ln for ln in f if ln.startswith(f"{QUERY},")]
    for a, b in zip(outputs["cpu"], outputs["cuda"]):
        check(torch.equal(a["ins"], b["ins"]) and torch.equal(a["conf"], b["conf"])
              and a["final_class"] == b["final_class"], "small 3D scene: stage outputs differ")
    ap_cpu, ap_gpu = runs["cpu"]["evaluation"], runs["cuda"]["evaluation"]
    check(same_ap(ap_cpu, ap_gpu) and rows["cpu"] == rows["cuda"],
          "small 3D scene: AP differs between CUDA and CPU")
    emit({"phase": "small_reference_3d", "instances": [int(o["ins"].shape[0])
                                                       for o in outputs["cuda"]],
          "ap": ap_gpu["classes"][QUERY], "mask_iou_launches": runs["cuda"]["mask_iou_launches"],
          "equal": True})
    check(runs["cuda"]["mask_iou_launches"]["projection"] > 0,
          "small 3D scene: the mask-IoU kernel was not launched")


def device_activity(torch, fn):
    """Run ``fn`` under ``torch.profiler`` (device activity only); returns
    (busy microseconds: the union of kernel, copy and set intervals; number
    of device events; {name: (count, microseconds)})."""
    from beyondff_tpu_torch.utils.profiling import device_spans

    spans = device_spans(fn)
    check(spans, "torch.profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + e - s)
    return busy_us, len(spans), by_name


K6_DESIGN = {
    "mask_iou": "int8 mma.sync m16n8k32 -> s32 on the bool bytes, 128 x 128 tiles (self: "
                "upper triangle, areas from the diagonal), split N, rows at any address cut "
                "from aligned 16-byte loads in registers into a 2-stage ring, int32 atomics",
    "mask_iou_wgmma": "int8 wgmma m64n128k32 -> s32 on the bool bytes (K-major), a producer "
                      "warp keeping 4 stages of 128-byte TMA boxes (2-D maps over (N, rows), "
                      "128-byte swizzle, zero fill past N and the last row) on mbarriers, two "
                      "consumer warpgroups a 128 x 128 tile, clusters of 2 adjacent tiles "
                      "sharing A by multicast, split N, int32 atomics",
}


def mask_iou_case(torch, kiou, name, ia, ib, n, dev, padded=True, timed=True, empty=False):
    """One mask-IoU comparison (bit for bit, nan at the same places) and,
    when ``timed``, its timing against the plain version and
    ``torch._int_mm``; ``ib`` None is a self-IoU. A share of rows is empty
    (nan against empty rows; ``empty``: every row). Rows ``padded`` lie on
    16-byte boundaries in wider storage, as the main path allocates them
    (``kiou.aligned_rows``); the call must move the counter
    ``kiou.wgmma_route`` names."""
    from beyondff_tpu_torch.kernels import dispatch
    from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_INT8_OPS, device_ms

    g = torch.Generator(device=dev).manual_seed(SEED)

    def rows(r, dens):
        m = torch.rand(r, n, device=dev, generator=g) < dens
        if empty:
            m[:] = False
        if not padded:
            return m
        v = kiou.aligned_rows(r, n, dev)
        v.copy_(m)
        return v

    dens = torch.rand(ia, 1, device=dev, generator=g) * 0.3
    dens[::17] = 0.0
    a = rows(ia, dens)
    b = None
    if ib is not None:
        dens_b = torch.rand(ib, 1, device=dev, generator=g) * 0.3
        dens_b[::13] = 0.0
        b = rows(ib, dens_b)
    ib_n = ia if ib is None else ib
    stride = lambda t: t.stride(0) if t.shape[0] > 1 else max(n, t.stride(0))
    routed = ("mask_iou_wgmma" if kiou.wgmma_route(
        ia, ib_n, n, stride(a), stride(a if b is None else b), a.data_ptr(),
        None if b is None else b.data_ptr()) else "mask_iou")
    before = dict(dispatch.launch_counts)
    got = kiou.pairwise_iou(a, b)
    went = [key for key, c in dispatch.launch_counts.items() if c != before[key]]
    check(went == [routed], f"mask_iou {name}: launched {went}, the route says {routed}")
    want = kiou.pairwise_iou_plain(a, b)
    torch.cuda.synchronize()
    nan_eq = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = ~torch.isnan(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    bits_eq = bool(torch.equal(got[fin].view(torch.int32), want[fin].view(torch.int32)))
    if not timed:
        rec = {"case": name, "kernel": routed, "shape": [ia, ib_n, n], "self": b is None,
               "padded": padded, "max_abs_err": err, "bit_equal": bits_eq,
               "nan_positions_equal": nan_eq, "nan_share": float(torch.isnan(want).float().mean())}
        emit(rec)
        check(nan_eq and bits_eq and err == 0.0, f"mask_iou {name}: differs from the plain version")
        return rec
    # intersections only, as torch._int_mm takes them: int8 copies made
    # outside the timing, rows and points padded with zeros to its multiples
    # of 8
    a8 = torch.nn.functional.pad(a.contiguous().to(torch.int8), (0, -n % 8))
    b8 = a8 if b is None else torch.nn.functional.pad(b.contiguous().to(torch.int8),
                                                      (0, -n % 8, 0, -ib_n % 8))
    nbytes = ia * n + (0 if b is None else ib_n * n) + 4 * ia * ib_n
    # a self-IoU needs each distinct pair once: ia (ia + 1) / 2 intersections
    ops = ia * (ia + 1) * n if b is None else 2 * ia * ib_n * n
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / PEAK_INT8_OPS * 1e3
    kernel = lambda: kiou.pairwise_iou(a, b)
    library = lambda: torch._int_mm(a8, b8.t())
    dev_ms = device_ms(kernel)
    lib_dev_ms = device_ms(library)
    lib_ops = 2 * a8.shape[0] * b8.shape[0] * a8.shape[1]  # _int_mm counts every pair
    rec = {"case": name, "kernel": routed, "shape": [ia, ib_n, n], "self": b is None,
           "padded": padded,
           "max_abs_err": err, "bit_equal": bits_eq, "nan_positions_equal": nan_eq,
           "nan_share": float(torch.isnan(want).float().mean()), "tol": 0.0,
           "ms": cuda_ms(torch, kernel, 20), "device_ms": dev_ms,
           # the function's operations (each distinct pair once) per device second
           "tops": ops / dev_ms / 1e9,
           "plain_ms": cuda_ms(torch, lambda: kiou.pairwise_iou_plain(a, b), 5),
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "library_ms": cuda_ms(torch, library, 20), "library_device_ms": lib_dev_ms,
           "library_tops": lib_ops / lib_dev_ms / 1e9,
           "library_call": "torch._int_mm on int8 copies (intersections only)",
           "design": K6_DESIGN[routed]}
    emit(rec)
    check(nan_eq and bits_eq and err == 0.0, f"mask_iou {name}: differs from the plain version")
    return rec


def full_width_3d(torch, mods, Config, work, dev, detector):
    """The 3D half at full width through its entry points, one (class, scene):
    250 000 points, 300 frames (a ScanNet scene's ~3000 at the default
    downsample ratio of 10, run at ratio 1), 640x480 depth PNGs, every 4th
    frame with 8 RLE masks at 968x1296 (600 lifted rows), 150 stage-1
    masks, text similarity from ``build_text_similarity`` over phase 4's
    CLIP ViT-L/14 archive and merges file (``detector``: their config)."""
    from beyondff_tpu_torch.pipeline import text_sim
    from beyondff_tpu_torch.utils.profiling import StageProfiler

    t0 = time.perf_counter()
    fixture = make_3d_scene(torch, dev, os.path.join(work, "full3d"), "scene0000_00", 250_000,
                            300, 2 * np.pi, FRAME_HW, (480, 640), 4, 8, 150, SEED)
    emit({"phase": "fixture_3d", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    loaded = text_sim.build_text_similarity(Config.from_dict({"detector": {
        "clip_checkpoint": detector.clip_checkpoint, "clip_bpe_path": detector.clip_bpe_path}}))
    torch.cuda.synchronize()
    check(isinstance(loaded, text_sim.ClipTextSimilarity)
          and loaded.model.device.type == "cuda", "build_text_similarity did not load CLIP")
    emit({"phase": "text_similarity_load", "seconds": time.perf_counter() - t0,
          "dtype": str(loaded.model.dtype), "tokenizer": type(loaded.tokenizer).__name__})

    def similarity():  # a fresh per-string cache for each run
        return text_sim.ClipTextSimilarity(loaded.model, loaded.tokenizer)

    cfg = config_3d(Config, fixture, os.path.join(work, "full3d", "out"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # cold: the scene's first visit decodes the depth PNGs and fills the
    # depth cache; warm: the visit of every later class of a sweep
    prof = StageProfiler("projection")
    run = run_3d(mods, cfg, dev, sim=similarity(), prof=prof)
    peak = torch.cuda.max_memory_allocated()
    prof_warm = StageProfiler("projection")
    warm = run_3d(mods, cfg, dev, sim=similarity(), prof=prof_warm)
    launches = run["mask_iou_launches"]
    for r in (run, warm):
        for stage in ("projection", "refinement"):
            check(r["mask_iou_launches"][stage] > 0, f"mask_iou was not launched in the {stage}")
        # every mask row is allocated on 16-byte boundaries: the wgmma kernel
        # takes each call (aggregation once, refinement three times)
        check(r["mask_iou_wgmma_launches"] == r["mask_iou_launches"]
              and sum(r["mask_iou_wgmma_launches"].values()) == 4,
              f"mask IoU off the wgmma kernel: {r['mask_iou_launches']} "
              f"{r['mask_iou_wgmma_launches']}")

    outs = stage_outputs(torch, cfg, "scene0000_00")
    for d in outs:
        check(d["ins"].dtype == torch.bool and d["ins"].dim() == 2
              and d["ins"].shape[1] == 250_000, f"ins {d['ins'].dtype} {tuple(d['ins'].shape)}")
        check(d["conf"].dtype == torch.float32 and len(d["conf"]) == d["ins"].shape[0],
              "conf is not float32 of one value per mask")
        check(isinstance(d["final_class"], list)
              and all(isinstance(c, str) for c in d["final_class"]), "final_class")
    ap = run["evaluation"]["classes"][QUERY]
    check(all(np.isfinite(ap[k]) for k in ("ap", "ap50%", "ap25%")), f"AP not finite: {ap}")
    check(same_ap(ap, warm["evaluation"]["classes"][QUERY]), "the warm run's AP differs")
    check(outs[1]["ins"].shape[0] > 0, "refinement wrote no masks")

    # the same projection once more under the profiler: the device's busy
    # share of the projection span
    span = {}

    def project():
        t = time.perf_counter()
        mods[2].run(cfg, QUERY, resume=False, device=dev)
        torch.cuda.synchronize()
        span["s"] = time.perf_counter() - t

    busy_us, events, by_name = device_activity(torch, project)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    emit({"phase": "stage3d_full_width", "points": 250_000, "frames": 300,
          "lifted_masks": int(prof.items["aggregate.instances"]),
          "seconds_per_class_scene": {"cold": sum(run["seconds"].values()),
                                      "warm": sum(warm["seconds"].values())},
          "scenes_per_min": {k: 60.0 / sum(r["seconds"].values())
                             for k, r in (("cold", run), ("warm", warm))},
          "stage_seconds": {"cold": run["seconds"], "warm": warm["seconds"]},
          "projection_spans_s": {"cold": dict(prof.durations), "warm": dict(prof_warm.durations)},
          "mask_iou_launches": launches,
          "mask_iou_wgmma_launches": run["mask_iou_wgmma_launches"],
          "max_memory_allocated_bytes": peak,
          "instances": {"projection": int(outs[0]["ins"].shape[0]),
                        "refinement": int(outs[1]["ins"].shape[0])},
          "ap_row": {k: ap[k] for k in ("ap", "ap50%", "ap25%", "rc", "rc50%", "rc25%")}})
    emit({"phase": "device_profile_projection", "projection_seconds_profiled": span["s"],
          "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e6 / span["s"],
          "device_events": events,
          "top_device_ms": [[name[:120], n, us / 1e3] for name, (n, us) in top]})
    wgmma = sum(run["mask_iou_wgmma_launches"][k] for k in ("projection", "refinement"))
    return ({"mask_iou": launches["projection"] + launches["refinement"] - wgmma,
             "mask_iou_wgmma": wgmma}, fixture)


# ------------------------------------------------------------ the class sweep
SWEEP_CLASSES = ("clothes", "chair", "table")  # all three in the room's ground truth
SWEEP_FRAMES = 16
SWEEP_POINTS = 50_000


def sweep_config(Config, fixture, out, frame_batch, dtype, fused):
    """The fixture's scene with every output under ``out`` (a fresh 2D mask
    directory too: the 2D masks come from the sweep's own 2D stage), in the
    hit regime."""
    outs = ("mask_2d_dir", "mask_3d_dir", "final_output_dir", "checkpoint_dir", "results_dir")
    return Config.from_dict({
        **fixture,
        "paths": {**fixture["paths"], **{k: os.path.join(out, k) for k in outs}},
        "detector": {"box_threshold": 0.0, "must_match_query": False,
                     "similarity_threshold": -1.0, "frame_batch": frame_batch,
                     "dtype": dtype, "fused_captions": fused}})


def records_diff(io, rle, cfg_a, cfg_b, classes, scene_id="scene0000_00"):
    """Largest confidence difference and smallest mask IoU between two runs'
    2D records of ``classes`` (frame ids and labels must be equal)."""
    worst_conf, worst_iou, n = 0.0, 1.0, 0
    for c in classes:
        a, b = (io.load_frame_records(os.path.join(cfg.paths.mask_2d_dir, c, f"{scene_id}.pth"))
                for cfg in (cfg_a, cfg_b))
        check([r["frame_id"] for r in a] == [r["frame_id"] for r in b], f"{c}: frame ids differ")
        for ra, rb in zip(a, b):
            check(list(ra["labels"]) == list(rb["labels"]), f"{c} {ra['frame_id']}: labels")
            worst_conf = max(worst_conf, float(np.abs(np.asarray(ra["confidences"])
                                                      - np.asarray(rb["confidences"])).max()))
            for ma, mb in zip(ra["segmented_frame_masks"], rb["segmented_frame_masks"]):
                n += 1
                if np.array_equal(ma["counts"], mb["counts"]):
                    continue
                da, db = rle.rle_decode(ma).astype(bool), rle.rle_decode(mb).astype(bool)
                union = (da | db).sum()
                worst_iou = min(worst_iou, 1.0 if union == 0 else (da & db).sum() / union)
    return worst_conf, worst_iou, n


def sweep_outputs(torch, cfg, classes, scene_id="scene0000_00"):
    """Per class: the 3D stage dicts (projection, refinement) and the
    class's row of the results table."""
    with open(os.path.join(cfg.paths.results_dir, "overall_results.txt")) as f:
        rows = {ln.split(",")[0]: ln for ln in f if "," in ln}
    out = {}
    for c in classes:
        dicts = [torch.load(os.path.join(d, c, f"{scene_id}.pth"), map_location="cpu",
                            weights_only=False)
                 for d in (cfg.paths.mask_3d_dir, cfg.paths.final_output_dir)]
        for d in dicts:
            check(d["ins"].dtype == torch.bool and d["ins"].dim() == 2
                  and d["conf"].dtype == torch.float32 and len(d["conf"]) == d["ins"].shape[0]
                  and all(isinstance(x, str) for x in d["final_class"]),
                  f"{c}: malformed 3D stage output")
        check(not rows[c].startswith(f"{c},-"), f"{c}: results table row not written")
        out[c] = (dicts, rows[c])
    return out


def small_sweep(torch, mods, Config, work, dev):
    """The class sweep (``SweepRunner.run(amortize_segmentation=True)`` with
    fused captions) at the "test" presets on the card against the same sweep
    on the CPU: a 5 000-point scene, 6 frames at 242x324, three classes. The
    2D records agree within the phase's tolerances and the results table
    rows are equal. A few mask pixels may flip between the two devices' f32
    sums, and the lift carries a flip into the 3D outputs, so the 3D stages
    run once more on the CPU from the card's 2D masks (``skip_segmentation``)
    and those outputs must equal the card's."""
    Config, seg2d, gd, sam_mod, clip_mod, io, sweep, rle = mods
    root = os.path.join(work, "sweep_small")
    fixture = make_3d_scene(torch, dev, root, "scene0000_00", 5000, 6, 1.2, (242, 324),
                            (121, 162), 6, 1, 20, SEED)
    cpu_models = (gd.GroundingDINO.create("test", seed=1, device="cpu"),
                  sam_mod.SAM.create("test", seed=2, device="cpu"),
                  clip_mod.CLIP.create("test", seed=3, device="cpu"))
    gpu_models = (gd.GroundingDINO.create("test", device="cuda"),
                  sam_mod.SAM.create("test", device="cuda"),
                  clip_mod.CLIP.create("test", device="cuda"))
    for a, b in zip(cpu_models, gpu_models):
        b.module.load_state_dict(a.module.state_dict())
    classes = list(SWEEP_CLASSES)
    cpu = torch.device("cpu")
    cfgs, outs = {}, {}

    def drive(name, d, cfg, models, skip_segmentation=False):
        det, sam, clip = models
        seg = seg2d.Segmentor2D(cfg, detector=det, sam=sam, clip_model=clip,
                                frame_loader=synthetic_frame)
        runner = sweep.SweepRunner(cfg, checkpoint_path=os.path.join(root, name, "sweep.yaml"),
                                   device=d, segmentor=seg, plot_pr_curves=False,
                                   skip_segmentation=skip_segmentation)
        status = runner.run(classes, skip=(), amortize_segmentation=True)
        check(all(all(st.values()) for st in status.values()), f"small sweep {name}: {status}")
        want = {"segmentation": [] if skip_segmentation else classes, "projection": classes}
        check(runner.amortized == want, f"small sweep {name}: amortized {runner.amortized}")
        cfgs[name], outs[name] = cfg, sweep_outputs(torch, cfg, classes)

    def same(a, b):
        return {c: all(torch.equal(x["ins"], y["ins"]) and torch.equal(x["conf"], y["conf"])
                       and x["final_class"] == y["final_class"]
                       for x, y in zip(outs[a][c][0], outs[b][c][0]))
                and outs[a][c][1] == outs[b][c][1] for c in classes}

    os.environ["BFF_DEFORM_WINDOWED"] = "1"
    try:
        for name, d, models in (("cpu", cpu, cpu_models), ("cuda", dev, gpu_models)):
            drive(name, d, sweep_config(Config, fixture, os.path.join(root, name), 2, "float32",
                                        True), models)
        cfg = sweep_config(Config, fixture, os.path.join(root, "cpu_3d"), 2, "float32", True)
        cfg = cfg.override(**{"paths.mask_2d_dir": cfgs["cuda"].paths.mask_2d_dir})
        drive("cpu_3d", cpu, cfg, cpu_models, skip_segmentation=True)
    finally:
        del os.environ["BFF_DEFORM_WINDOWED"]
    worst_conf, worst_iou, n = records_diff(io, rle, cfgs["cpu"], cfgs["cuda"], classes)
    rows_equal = all(outs["cpu"][c][1] == outs["cuda"][c][1] for c in classes)
    rec = {"phase": "small_sweep", "classes": classes, "masks_2d": n,
           "max_conf_diff": worst_conf, "min_mask_iou": worst_iou, "conf_tol": 1e-4,
           "iou_min": 0.99, "table_rows_equal": rows_equal,
           "outputs_equal_from_the_same_2d_masks": same("cpu_3d", "cuda"),
           "outputs_equal_end_to_end": same("cpu", "cuda"),
           "rows": {c: outs["cuda"][c][1].strip() for c in classes}}
    emit(rec)
    check(n > 0 and worst_conf <= 1e-4 and worst_iou >= 0.99 and rows_equal
          and all(rec["outputs_equal_from_the_same_2d_masks"].values()),
          f"the sweep on the card disagrees with the CPU sweep: {rec}")


def counting_runner(sweep, dispatch, torch):
    class CountingRunner(sweep.SweepRunner):
        """The port's runner, logging each stage call's seconds and kernel
        launches (the amortized passes and the per-class stages)."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.log = []

        def _logged(self, name, fn, *args):
            before = dict(dispatch.launch_counts)
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                torch.cuda.synchronize()
                self.log.append({"call": name, "seconds": time.perf_counter() - t0,
                                 "launches": {k: v - before[k] for k, v in
                                              dispatch.launch_counts.items() if v > before[k]}})

        def _amortized_segmentation(self, classes):
            return self._logged("segmentation (amortized)", super()._amortized_segmentation,
                                classes)

        def _amortized_projection(self, classes):
            return self._logged("projection (amortized)", super()._amortized_projection,
                                classes)

        def _run_stage(self, stage, class_name):
            return self._logged(f"{stage} / {class_name}", super()._run_stage, stage,
                                class_name)

    return CountingRunner


def full_width_sweep(torch, mods, Config, work, dev, models):
    """The class sweep at full width: Grounding-DINO Swin-B, CLIP ViT-L/14,
    SAM ViT-H in bf16 (the phase-4 models) on a ray-cast scene of 50 000
    points and 16 frames at 968x1296 with 640x480 depth, three classes of its
    ground truth, hit regime, fused captions, ``BFF_SAM_RELPOS_FLASH=1``.
    First three timed 2D passes on clean checkpoints (per-class ``run()``,
    ``run_classes`` unfused, ``run_classes`` fused); the banked records must
    equal the per-class ones. Then ``SweepRunner.run(amortize_segmentation=
    True)`` with launch counts set to 0 just before it, and the
    ``sam_encode`` span with the flag off, on, on, off. Returns the sweep's
    launch counts."""
    seg2d, sweep, projection, dispatch, io, rle, StageProfiler = mods
    det, clip, sam, clip_tokenizer = models
    t0 = time.perf_counter()
    root = os.path.join(work, "sweep")
    fixture = make_3d_scene(torch, dev, root, "scene0000_00", SWEEP_POINTS, SWEEP_FRAMES,
                            2 * np.pi, FRAME_HW, (480, 640), SWEEP_FRAMES, 1, 40, SEED)
    emit({"phase": "fixture_sweep", "seconds": time.perf_counter() - t0})
    classes = list(SWEEP_CLASSES)
    class_frames = SWEEP_FRAMES * len(classes)

    def segmentor(cfg):
        return seg2d.Segmentor2D(cfg, detector=det, sam=sam, clip_model=clip,
                                 clip_tokenizer=clip_tokenizer, frame_loader=synthetic_frame)

    def timed(fn):
        prof = StageProfiler("segmentation_2d")
        dispatch.reset_launch_counts()
        t = time.perf_counter()
        fn(prof)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        return {"seconds": secs, "class_frames_per_sec": class_frames / secs,
                "launches": dict(dispatch.launch_counts),
                "spans_s": dict(prof.durations), "items": dict(prof.items)}

    os.environ["BFF_SAM_RELPOS_FLASH"] = "1"
    try:
        cfgs = {name: sweep_config(Config, fixture, os.path.join(root, name), FRAME_BATCH,
                                   "bfloat16", name in ("run_classes_fused", "sweep"))
                for name in ("run_per_class", "run_classes", "run_classes_fused", "sweep")}
        passes = {}
        cfg = cfgs["run_per_class"]
        seg = segmentor(cfg)
        passes["run_per_class"] = timed(lambda prof: [
            seg2d.run(cfg, c, segmentor=seg, profiler=prof) for c in classes])
        for name, fused in (("run_classes", "0"), ("run_classes_fused", "1")):
            os.environ["BFF_SEG2D_FUSED"] = fused
            c_cfg = cfgs[name]
            passes[name] = timed(lambda prof: seg2d.run_classes(
                c_cfg, classes, segmentor=segmentor(c_cfg), profiler=prof))
        del os.environ["BFF_SEG2D_FUSED"]
        for name, p in passes.items():
            check(p["launches"]["flash_attention_relpos_wgmma"] > 0
                  and p["launches"]["flash_attention_relpos"] == 0,
                  f"{name}: K4 was not launched, or off its wgmma kernel: {p['launches']}")
        worst_conf, worst_iou, n = records_diff(io, rle, cfgs["run_per_class"],
                                                cfgs["run_classes"], classes)
        emit({"phase": "sweep_2d_passes", "classes": classes, "frames": SWEEP_FRAMES,
              "class_frames": class_frames, "passes": passes,
              "banked_vs_run": {"masks": n, "max_conf_diff": worst_conf,
                                "min_mask_iou": worst_iou, "conf_tol": 1e-4,
                                "iou_min": 0.999}})
        check(n > 0 and worst_conf <= 1e-4 and worst_iou >= 0.999,
              f"banked run_classes records differ from per-class run(): {worst_conf} {worst_iou}")

        cfg = cfgs["sweep"]
        runner = counting_runner(sweep, dispatch, torch)(
            cfg, checkpoint_path=os.path.join(root, "sweep", "sweep.yaml"), device=dev,
            segmentor=segmentor(cfg), plot_pr_curves=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launch_counts()
        t = time.perf_counter()
        status = runner.run(classes, skip=(), amortize_segmentation=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        launches = dict(dispatch.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        check(all(all(st.values()) for st in status.values()), f"sweep stages: {status}")
        check(runner.amortized == {"segmentation": classes, "projection": classes},
              f"amortized passes did not run for every class: {runner.amortized}")
        for name in ("flash_attention_relpos_wgmma", "ms_deform_sample", "flash_masked_wgmma",
                     "mask_iou_wgmma"):
            check(launches[name] > 0, f"{name} was not launched in the sweep")
        check(launches["flash_attention"] == 0,
              f"a decoder self-attention call stayed on the mma.sync tile: {launches}")
        check(launches["mask_iou"] == 0, f"mask IoU off the wgmma kernel: {launches}")
        check(launches["flash_attention_relpos"] == 0,
              f"K4 launched off its wgmma kernel in the sweep: {launches}")
        masks_2d = 0
        for c in classes:
            masks_2d += sum(len(r["segmented_frame_masks"])
                            for r in check_records(torch, cfg, c, "scene0000_00", SWEEP_FRAMES))
        outs = sweep_outputs(torch, cfg, classes)
        emit({"phase": "sweep_full_width", "classes": classes, "frames": SWEEP_FRAMES,
              "points": SWEEP_POINTS, "seconds": secs, "seconds_per_class": secs / len(classes),
              "status": status, "amortized": runner.amortized, "launches": launches,
              "stage_calls": runner.log, "masks_2d": masks_2d,
              "instances": {c: [int(d["ins"].shape[0]) for d in outs[c][0]] for c in classes},
              "rows": {c: outs[c][1].strip() for c in classes},
              "max_memory_allocated_bytes": peak})

        # one class's projection once more under the profiler: the device's
        # busy share of the sweep's slowest stage
        span = {}

        def project():
            t = time.perf_counter()
            projection.run(cfg, classes[0], resume=False, device=dev)
            torch.cuda.synchronize()
            span["s"] = time.perf_counter() - t

        busy_us, events, by_name = device_activity(torch, project)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        emit({"phase": "device_profile_sweep_projection", "class": classes[0],
              "projection_seconds_profiled": span["s"], "device_busy_ms": busy_us / 1e3,
              "device_busy_share": busy_us / 1e6 / span["s"], "device_events": events,
              "top_device_ms": [[name[:120], n, us / 1e3] for name, (n, us) in top]})

        # the SAM encode with the rel-pos flash kernel off and on, in turns:
        # the scene for the launches, the encoder on a batch of FRAME_BATCH
        # of its frames for the time (CUDA events; the stage's spans hold
        # host time only)
        cfg = cfgs["run_per_class"]
        seg = segmentor(cfg)
        batch, _hw = sam.scale_frames(torch.as_tensor(np.stack(
            [synthetic_frame(f"{i}.jpg", FRAME_HW[::-1]) for i in range(FRAME_BATCH)]),
            device=dev))
        ab = []
        for flag in ("0", "1", "1", "0"):
            if flag == "1":
                os.environ["BFF_SAM_RELPOS_FLASH"] = "1"
            else:
                os.environ.pop("BFF_SAM_RELPOS_FLASH", None)
            prof = StageProfiler("segmentation_2d")
            seg.profiler = prof
            dispatch.reset_launch_counts()
            try:
                seg.process_scene("scene0000_00", "clothes")
            finally:
                seg.profiler = None
            check(dispatch.launch_counts["flash_attention_relpos"] == 0,
                  f"K4 launched off its wgmma kernel: {dispatch.launch_counts}")
            ab.append({"BFF_SAM_RELPOS_FLASH": flag, "frames": prof.items["sam_encode.frames"],
                       "relpos_launches":
                           dispatch.launch_counts["flash_attention_relpos_wgmma"],
                       "encode_ms_batch": cuda_ms(torch, lambda: sam.encode_frames(batch), 3),
                       "batch": FRAME_BATCH})
            check((ab[-1]["relpos_launches"] > 0) == (flag == "1"),
                  f"rel-pos launches {ab[-1]['relpos_launches']} with the flag {flag}")
        emit({"phase": "sam_encode_ab", "runs": ab})
    finally:
        os.environ.pop("BFF_SAM_RELPOS_FLASH", None)
        os.environ.pop("BFF_SEG2D_FUSED", None)
    return launches


# ------------------------------------------------------------ the fast variant
NMS_ANCHORS = 80 * 80 + 40 * 40 + 20 * 20  # YOLO-World-L's anchors at 640x640
NMS_TOP_K = 100  # YOLO-World-L's max_dets


NMS_STAGED_DESIGN = (
    "a cluster of 8 blocks per frame, each a slice of the sorted boxes staged by one bulk copy "
    "with its suppression bits in shared memory; a round tests the boxes the last round kept "
    "against the slice (warp ballots, suppressed words skipped, the division only near the "
    "threshold), each block offers its first 4 free boxes to all through distributed shared "
    "memory, one cluster barrier, then the 4 smallest offers are kept greedily; stops at top_k; "
    "ms and device_ms include the wrapper's stable sort and gather (sort_ms, gather_ms, "
    "scan_ms)")
NMS_LARGE_DESIGN = (
    "the same kernel's large mode for frames above 90 112 boxes: the same cluster rounds with "
    "the sorted boxes read from device memory (L2) every round, areas recomputed, only the "
    "suppression bits in shared memory (slices up to 1 835 008 boxes; device memory past "
    "that); ms and device_ms include the wrapper's stable sort and gather")


def nms_case(torch, nms, dev, b=FRAME_BATCH, a=NMS_ANCHORS, name="yolo_world_l_batch"):
    """The NMS kernel against its plain version, index for index, at the
    main path's batch: 4 frames of 8 400 clustered boxes (as the detector's
    output), top_k 100, IoU 0.5; or ``b`` frames of ``a`` boxes, above
    ``nms.MAX_ANCHORS`` on the large mode (``nms_fixed_large``). The call
    must count under the counter ``nms.route`` names. The bound counts the
    IoU tests this data needs (each kept box against every box after it) at
    the f32 peak, and the boxes and scores read once."""
    from beyondff_tpu_torch.kernels import dispatch
    from beyondff_tpu_torch.utils.profiling import (HBM_BYTES_PER_S, PEAK_FLOPS, device_ms,
                                                    device_spans)

    seed = SEED if a == NMS_ANCHORS else SEED + a
    boxes, scores = nms.clustered_boxes(torch.Generator(device=dev).manual_seed(seed), b, a)
    before = dict(dispatch.launch_counts)
    keep, valid = nms.nms_fixed(boxes, scores, 0.5, NMS_TOP_K)
    went = [key for key, n in dispatch.launch_counts.items() if n != before[key]]
    check(went == [nms.route(a)], f"nms_fixed {name}: launched {went}")
    want_keep, want_valid = nms.nms_fixed_plain(boxes, scores, 0.5, NMS_TOP_K)
    torch.cuda.synchronize()
    err = float((keep.long() - want_keep.long()).abs().max())
    equal = bool(torch.equal(keep, want_keep) and torch.equal(valid, want_valid))
    n_iou = nms.iou_tests(keep, valid, scores)
    nbytes = b * a * (16 + 4) + b * NMS_TOP_K * (4 + 1)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = nms.IOU_OPS * n_iou / PEAK_FLOPS["float32"] * 1e3
    kernel = lambda: nms.nms_fixed(boxes, scores, 0.5, NMS_TOP_K)
    # the call's device time by part: the scan (the kernel), the gather, and
    # the sort with the negation of the scores (the wrapper's)
    split = nms.split_spans(device_spans(lambda: [kernel() for _ in range(5)]), 5)
    rec = {"case": name, "kernel": nms.route(a), "shape": [b, a],
           "top_k": NMS_TOP_K, "kept": int(valid.sum()), "iou_evaluations": n_iou,
           "max_abs_err": err, "index_equal": equal, "tol": "indices equal",
           "ms": cuda_ms(torch, kernel, 50), "device_ms": device_ms(kernel), **split,
           "plain_ms": cuda_ms(torch, lambda: nms.nms_fixed_plain(boxes, scores, 0.5,
                                                                   NMS_TOP_K), 3),
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "library_ms": None,
           "design": NMS_STAGED_DESIGN if a <= nms.MAX_ANCHORS else NMS_LARGE_DESIGN}
    emit(rec)
    check(equal, f"nms_fixed kernel disagrees with its plain version: {rec}")
    del boxes, scores
    torch.cuda.empty_cache()
    return rec


def nms_threshold_case(torch, nms, dev):
    """The NMS kernel index for index against its plain version with the
    threshold set to IoUs the plain version computes for pairs of the input
    (``>`` keeps those pairs: the division-free test must fall back to the
    division there), tied scores in the mix, at 2 frames of 2 000 boxes."""
    boxes, scores = nms.clustered_boxes(torch.Generator(device=dev).manual_seed(SEED + 7), 2,
                                        2000, centres=40, spread=3.0, half_min=5.0)
    scores = torch.round(scores * 8) / 8
    bs = boxes[0]
    area = (bs[:, 2] - bs[:, 0]).clamp_min(0) * (bs[:, 3] - bs[:, 1]).clamp_min(0)
    inter = ((torch.minimum(bs[0, 2], bs[1:, 2]) - torch.maximum(bs[0, 0], bs[1:, 0]))
             .clamp_min(0) * (torch.minimum(bs[0, 3], bs[1:, 3])
                              - torch.maximum(bs[0, 1], bs[1:, 1])).clamp_min(0))
    iou = inter / (area[0] + area[1:] - inter + 1e-9)
    thresholds = iou[(iou > 0.2) & (iou < 0.8)][:6].tolist()
    equal = []
    for thr in thresholds:
        got = nms.nms_fixed(boxes, scores, thr, 300)
        want = nms.nms_fixed_plain(boxes, scores, thr, 300)
        equal.append(all(bool(torch.equal(x, y)) for x, y in zip(got, want)))
    torch.cuda.synchronize()
    rec = {"case": "nms_on_the_threshold", "kernel": "nms_fixed", "thresholds": thresholds,
           "index_equal": equal}
    emit(rec)
    check(len(thresholds) == 6 and all(equal), f"nms_fixed on the threshold: {rec}")
    return rec


def spread_weights(torch, module, seed):
    """Seeded non-degenerate weights for a random YOLO-World: batch-norm
    scales and variances in [0.5, 1.5], means and biases N(0, 0.1), the
    contrastive heads' logit scale e^2. With the default random init the
    class logits barely leave 0, so scores tie to the last f32 unit and the
    NMS order turns on rounding that differs between devices."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "logit_scale":
                vals = np.full(t.shape, 2.0)
            elif leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
                vals = rng.uniform(0.5, 1.5, t.shape)
            elif leaf in ("running_mean", "bias"):
                vals = rng.normal(0.0, 0.1, t.shape)
            else:
                continue
            t.copy_(torch.as_tensor(vals, dtype=t.dtype))


def small_reference_fast(torch, mods, work):
    """The fast variant (YOLO-World with spread weights, EfficientSAM and
    CLIP at the "test" presets, f32) on the card against the port's CPU
    path on one 4-frame 48x64 scene, with two-tier uploads on auto (off at
    this size) and forced on:

    1. the detector's boxes (over the 64-px input) and class logits on the
       frames as each upload mode feeds them, within 1e-4 (f32; cuDNN's
       TF32 is off, phase 1);
    2. the NMS kernel on the card's own detector outputs against its plain
       version, index for index;
    3. the stage from the same detections (the CPU run's, replayed with
       ``detections_override``: frames, crops, CLIP filter, SAM): confidences
       within 1e-4, masks at IoU >= 0.99;
    4. ``run()`` end to end on both, recorded but not required to agree:
       random weights leave scores a few f32 units apart, so the two
       devices' roundings may order the NMS differently."""
    Config, seg2d, yw, esam, clip_mod, nms, io, rle = mods
    make_scene(os.path.join(work, "scenes"), "small_fast", 4)

    def loader(path, size):
        rng = np.random.default_rng(10 + int(os.path.basename(path).split(".")[0]))
        return rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)

    cpu_models = (yw.YOLOWorld.create("test", seed=1, device="cpu"),
                  esam.EfficientSAM.create("test", seed=2, device="cpu"),
                  clip_mod.CLIP.create("test", seed=3, device="cpu"))
    spread_weights(torch, cpu_models[0].module, SEED + 1)
    gpu_models = (yw.YOLOWorld.create("test", device="cuda"),
                  esam.EfficientSAM.create("test", device="cuda"),
                  clip_mod.CLIP.create("test", device="cuda"))
    for a, b in zip(cpu_models, gpu_models):
        b.module.load_state_dict(a.module.state_dict())
    frames = torch.as_tensor(np.stack([loader(f"{i}.jpg", (64, 48)) for i in range(4)]))
    fids = io.list_scene_frames(os.path.join(work, "scenes"), "small_fast", 1)
    out = {}
    for mode in ("auto", "1"):
        os.environ["BFF_SEG2D_TWO_TIER"] = mode
        try:
            segs, cfgs = {}, {}
            for dev, (det, sam, clip) in (("cpu", cpu_models), ("cuda", gpu_models)):
                cfgs[dev] = stage_config(Config, work, f"small_fast_{mode}_{dev}", (48, 64), 2,
                                         "float32", {"kind": "yolo_world"})
                segs[dev] = seg2d.Segmentor2D(cfgs[dev], detector=det, sam=sam,
                                              clip_model=clip, frame_loader=loader)
                check(segs[dev]._two_tier((48, 64)) == (mode == "1"), "two-tier switch")
            txt = torch.as_tensor(cpu_models[0].class_embeddings(["clothes"]))
            raw = {}
            for dev, seg in segs.items():
                t = frames.to(seg.device)
                x = seg._detector_input(t) if mode == "1" else seg.sam.scale_frames(t)[0]
                det = seg.detector
                with torch.inference_mode():
                    raw[dev] = det.module.detect(*det.module.backbone(det._detector_input(x)),
                                                 txt.to(seg.device))
            box_err = float((raw["cuda"][0].cpu() - raw["cpu"][0]).abs().max()) / 64
            logit_err = float((raw["cuda"][1].cpu() - raw["cpu"][1]).abs().max())
            scores = torch.sigmoid(raw["cuda"][1].float()).amax(-1)
            got = nms.nms_fixed(raw["cuda"][0], scores, 0.5, cpu_models[0].cfg.max_dets)
            want = nms.nms_fixed_plain(raw["cuda"][0], scores, 0.5, cpu_models[0].cfg.max_dets)
            nms_equal = all(bool(torch.equal(a, b)) for a, b in zip(got, want))

            # the CPU run's detections, replayed through both devices' stage
            captured = []
            det = segs["cpu"].detector
            finalize = det.predict_finalize

            def capture(*a, finalize=finalize, **k):
                dets = finalize(*a, **k)
                captured.extend(dets)
                return dets

            det.predict_finalize = capture
            try:
                segs["cpu"].process_scene("small_fast", "clothes")
            finally:
                del det.predict_finalize
            table = dict(zip(fids, captured))
            replay = {dev: seg.process_scene("small_fast", "clothes", detections_override=table)
                      for dev, seg in segs.items()}
            conf, iou, n = 0.0, 1.0, 0
            check([r["frame_id"] for r in replay["cpu"]] == [r["frame_id"] for r in replay["cuda"]],
                  "replayed frame ids")
            for a, b in zip(replay["cpu"], replay["cuda"]):
                check(a["labels"] == b["labels"], "replayed labels")
                conf = max(conf, float(np.abs(np.subtract(a["confidences"],
                                                          b["confidences"])).max()))
                for ma, mb in zip(a["segmented_frame_masks"], b["segmented_frame_masks"]):
                    union = (ma | mb).sum()
                    iou = min(iou, 1.0 if union == 0 else float((ma & mb).sum() / union))
                    n += 1
            for dev, seg in segs.items():
                seg2d.run(cfgs[dev], "clothes", scenes=["small_fast"], segmentor=seg,
                          resume=False)
            recs = [io.load_frame_records(os.path.join(cfgs[d].paths.mask_2d_dir, "clothes",
                                                       "small_fast.pth")) for d in segs]
            same_boxes = [(r["frame_id"], len(r["labels"])) for r in recs[0]] == \
                [(r["frame_id"], len(r["labels"])) for r in recs[1]]
            e2e = records_diff(io, rle, cfgs["cpu"], cfgs["cuda"], ["clothes"],
                               "small_fast") if same_boxes else None
        finally:
            del os.environ["BFF_SEG2D_TWO_TIER"]
        out[mode] = {"box_err_over_64px": box_err, "logit_err": logit_err,
                     "nms_kernel_equal_plain": nms_equal,
                     "replayed": {"masks": n, "max_conf_diff": conf, "min_mask_iou": iou},
                     "run_end_to_end": None if e2e is None else
                     {"max_conf_diff": e2e[0], "min_mask_iou": e2e[1], "masks": e2e[2]}}
    rec = {"phase": "small_reference_fast", "two_tier": out, "detector_tol": 1e-4,
           "conf_tol": 1e-4, "iou_min": 0.99, "cudnn_tf32": False}
    emit(rec)
    check(all(o["box_err_over_64px"] <= 1e-4 and o["logit_err"] <= 1e-4
              and o["nms_kernel_equal_plain"] and o["replayed"]["masks"] > 0
              and o["replayed"]["max_conf_diff"] <= 1e-4
              and o["replayed"]["min_mask_iou"] >= 0.99 for o in out.values()),
          f"the fast variant on the card disagrees with the CPU path: {rec}")


def write_fast_checkpoints(torch, yw, esam, root, dev):
    """YOLO-World-L (a full YOLO wrapper's ``{"model": {"model.model.N...":
    f32}}`` with the batch-norm counters and the DFL arange conv) and
    EfficientSAM-S (``{"model": ...}`` f32, its position embedding with a
    class-token slot, the mask-prompt stack) from seeded random weights.
    Returns the paths and the state dicts in the modules' form (host)."""
    g = torch.Generator().manual_seed(SEED + 5)
    det = yw.YOLOWorld.create("l", seed=SEED + 3, device=dev)
    ysd = {k: v.float().cpu() for k, v in det.module.state_dict().items()}
    del det
    extra = {k[:-len("weight")] + "num_batches_tracked": torch.tensor(1000)
             for k in ysd if k.endswith(".bn.weight")}
    reg_max = yw.PRESETS["l"].reg_max
    extra["model.22.dfl.conv.weight"] = torch.arange(reg_max, dtype=torch.float32).reshape(
        1, reg_max, 1, 1)
    paths = {"yolo_world": os.path.join(root, "yolov8l-worldv2.pt"),
             "efficientsam": os.path.join(root, "efficient_sam_vits.pt")}
    torch.save({"model": {"model." + k: v for k, v in {**ysd, **extra}.items()}},
               paths["yolo_world"])
    sam = esam.EfficientSAM.create("vits", seed=SEED + 4, device=dev)
    ssd = {k: v.float().cpu() for k, v in sam.module.state_dict().items()}
    del sam
    pos = ssd["image_encoder.pos_embed"]
    pos = torch.cat([torch.randn(1, 1, pos.shape[-1], generator=g),
                     pos.reshape(1, -1, pos.shape[-1])], 1)
    torch.save({"model": {**ssd, "image_encoder.pos_embed": pos, **mask_prompt_stack(torch, g)}},
               paths["efficientsam"])
    torch.cuda.empty_cache()
    return paths, {"yolo_world": ysd, "efficientsam": ssd}


def fast_variant(torch, mods, Config, work, dev, clip_files):
    """The fast variant at full width through ``Segmentor2D(cfg)`` with no
    model injected: YOLO-World-L (float32, as loaded), EfficientSAM-S in
    bf16 and phase 4's CLIP ViT-L/14 archive (768-d, so YOLO-World guides on
    hash embeddings), from their official files. ``run()`` on the 8-frame
    968x1296 scene in the hit regime with launch counts set to 0 just before
    it, a profiled pass, and banked ``run_classes`` over three classes
    against per-class ``run()``. Returns the run's launch counts, the
    segmentor (phase 10 runs it again), its config and the directory
    holding the files (phase 14 loads them again, in f32)."""
    seg2d, yw, esam, dispatch, io, rle, StageProfiler = mods
    root = tempfile.mkdtemp(prefix="chip_smoke_fast_")
    try:
        t0 = time.perf_counter()
        paths, written = write_fast_checkpoints(torch, yw, esam, root, dev)
        emit({"phase": "write_checkpoints_fast", "seconds": time.perf_counter() - t0,
              "bytes": {k: os.path.getsize(v) for k, v in paths.items()}})
        detector = {"kind": "yolo_world", "yolo_world_checkpoint": paths["yolo_world"],
                    "efficientsam_checkpoint": paths["efficientsam"],
                    "clip_checkpoint": clip_files[0], "clip_bpe_path": clip_files[1]}
        cfg = stage_config(Config, work, "fast", FRAME_HW, FRAME_BATCH, "bfloat16", detector)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        seg = seg2d.Segmentor2D(cfg, frame_loader=synthetic_frame)
        total_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        tensors = {name: check_loaded(torch, m.module, written[name])
                   for name, m in (("yolo_world", seg.detector), ("efficientsam", seg.sam))}
        check(seg.detector.dtype == torch.float32 and seg.sam.dtype == torch.bfloat16
              and seg.clip.dtype == torch.bfloat16, "fast variant dtypes")
        check(seg.detector.clip is None, "a 768-d CLIP tower was attached to YOLO-World")
        two_tier = seg._two_tier(FRAME_HW)
        check(two_tier, "two-tier uploads are off at 968x1296")
        from torch.utils.flop_counter import FlopCounterMode

        h, w = seg.detector.cfg.img_size
        with FlopCounterMode(display=False) as flops, torch.inference_mode():
            seg.detector.module(torch.zeros(1, h, w, 3, device=dev),
                                torch.zeros(1, seg.detector.cfg.text_dim, device=dev))
        emit({"phase": "checkpoint_load_fast", "seconds": total_s,
              "parameters": {name: sum(p.numel() for p in m.module.parameters())
                             for name, m in (("yolo_world", seg.detector),
                                             ("efficientsam", seg.sam))},
              "detector_gflop_per_frame": flops.get_total_flops() / 1e9,
              "load_seconds": seg.load_seconds,
              "gb_read": {k: os.path.getsize(v) / 1e9
                          for k, v in {**paths, "clip": clip_files[0]}.items()},
              "tensors_checked": tensors, "bit_exact": True,
              "detector_dtype": "float32", "sam_dtype": "bfloat16",
              "guide_embeddings": "hash (CLIP ViT-L/14 is 768-d, YOLO-World's text_dim 512)",
              "peak_memory_during_load_bytes": peak,
              "resident_bytes_after_load": torch.cuda.memory_allocated() - base})

        scenes = os.path.join(work, "scenes")
        make_scene(scenes, "warmup_fast", 2)
        make_scene(scenes, "scene_fast", N_FRAMES)
        t0 = time.perf_counter()
        seg2d.run(cfg, "clothes", scenes=["warmup_fast"], segmentor=seg)
        torch.cuda.synchronize()
        emit({"phase": "warmup_fast", "frames": 2, "seconds": time.perf_counter() - t0})

        torch.cuda.reset_peak_memory_stats()
        prof = StageProfiler("segmentation_2d")
        dispatch.reset_launch_counts()
        results = seg2d.run(cfg, "clothes", scenes=["scene_fast"], segmentor=seg, profiler=prof)
        torch.cuda.synchronize()
        launches = dict(dispatch.launch_counts)
        scene_s = prof.durations["scene"]
        encodes = prof.counts["sam_encode"]
        emit({"phase": "seg2d_fast_full_width", "frames": N_FRAMES,
              "frames_per_sec": N_FRAMES / scene_s, "scene_seconds": scene_s,
              "stage_ms": {k: v * 1e3 for k, v in prof.durations.items()},
              "stage_counts": dict(prof.counts), "stage_items": dict(prof.items),
              "two_tier": two_tier, "launches": launches,
              "flash_attention_wgmma_per_encode_batch":
                  launches["flash_attention_wgmma"] / max(encodes, 1),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "frames_with_boxes": results[0]["frames_with_boxes"]})
        blocks = len(seg.sam.cfg.global_attn_indexes)  # 12: every block is global
        check(encodes > 0 and launches["flash_attention_wgmma"] == blocks * encodes
              and launches["flash_attention"] == 0 and launches["flash_masked_wgmma"] == 0,
              f"K3: {launches['flash_attention_wgmma']} wgmma launches (and "
              f"{launches['flash_attention']} on the mma.sync tile) for {encodes} encode batches")
        check(launches["nms_fixed"] == prof.counts["detect"] and launches["nms_fixed"] > 0,
              f"nms_fixed: {launches['nms_fixed']} launches for {prof.counts['detect']} batches")
        recs = check_records(torch, cfg, "clothes", "scene_fast", N_FRAMES)
        emit({"phase": "output_check_fast", "records": len(recs),
              "masks": sum(len(r["segmented_frame_masks"]) for r in recs)})

        profile_scene(torch, seg2d, seg, cfg, "scene_fast", scene_s, "device_profile_fast")

        # banked run_classes against per-class run(), three classes
        classes = list(SWEEP_CLASSES)
        cfgs = {name: cfg.override(**{
            "paths.mask_2d_dir": os.path.join(work, f"masks_fast_{name}"),
            "paths.checkpoint_dir": os.path.join(work, f"ckpt_fast_{name}")})
            for name in ("run_per_class", "run_classes")}
        passes = {}
        for name in cfgs:
            c_cfg = cfgs[name]
            p = StageProfiler("segmentation_2d")
            dispatch.reset_launch_counts()
            t = time.perf_counter()
            if name == "run_per_class":
                for c in classes:
                    seg2d.run(c_cfg, c, scenes=["scene_fast"], segmentor=seg, profiler=p)
            else:
                os.environ["BFF_SEG2D_FUSED"] = "0"
                try:
                    seg2d.run_classes(c_cfg, classes, scenes=["scene_fast"], segmentor=seg,
                                      profiler=p)
                finally:
                    del os.environ["BFF_SEG2D_FUSED"]
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            passes[name] = {"seconds": secs, "class_frames_per_sec": N_FRAMES * len(classes) / secs,
                            "launches": dict(dispatch.launch_counts),
                            "spans_s": dict(p.durations)}
        worst_conf, worst_iou, n = records_diff(io, rle, cfgs["run_per_class"],
                                                cfgs["run_classes"], classes, "scene_fast")
        emit({"phase": "fast_run_classes", "classes": classes, "frames": N_FRAMES,
              "passes": passes, "banked_vs_run": {
                  "masks": n, "max_conf_diff": worst_conf, "min_mask_iou": worst_iou,
                  "conf_tol": 1e-4, "iou_min": 0.999}})
        check(n > 0 and worst_conf <= 1e-4 and worst_iou >= 0.999,
              f"fast variant: banked run_classes differs from run(): {worst_conf} {worst_iou}")
        check(passes["run_classes"]["launches"]["nms_fixed"] > 0, "run_classes: no NMS launch")
        return launches, seg, cfg, root
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


# ------------------------------------------ the training path and parallel layer
TRAIN_BATCH = 32  # CLIP (image, text) pairs a contrastive step
SAM_TRAIN_FRAMES = 8


def local(torch, t):
    """A parameter's own tensor (the local shard of a tensor-parallel one)."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def process_group(torch):
    """A one-rank NCCL group on a free port of this host."""
    import socket
    import datetime

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    torch.distributed.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                         world_size=1, rank=0,
                                         timeout=datetime.timedelta(seconds=120))


def autograd_guard(torch, fa, dispatch, dev):
    """``attend`` on CUDA inputs that require grad must raise before it
    launches (the kernels have no backward); under ``no_grad`` it launches."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(8, 512, 64, device=dev, generator=g).requires_grad_(True)
    key = "flash_attention_tf32"  # f32 at head dim 64: the 3xTF32 kernel
    before = dispatch.launch_counts[key]
    raised = None
    try:
        fa.attend(q, q, q)
    except RuntimeError as e:
        raised = str(e)
    check(raised is not None and "no backward" in raised,
          "attend on inputs that require grad did not raise")
    check(dispatch.launch_counts[key] == before, "the refused call launched")
    with torch.no_grad():
        fa.attend(q, q, q)
    torch.cuda.synchronize()
    check(dispatch.launch_counts[key] == before + 1, "attend under no_grad")
    dispatch.launch_counts[key] = before  # a check, not a path launch
    emit({"phase": "autograd_guard", "raised": raised})


def clip_step_flops(cfg, b):
    """FLOPs of a contrastive step by the shapes: each tower's matmuls
    (weights and attention), the patch embedding, both projections and the
    (B, B) logits forward, x 3 for the backward (x 2 for the patch
    embedding, whose input needs no gradient)."""
    def tower(tokens, width, layers):
        return layers * (2 * tokens * 12 * width * width + 4 * tokens * tokens * width)

    grid = (cfg.image_resolution // cfg.vision_patch) ** 2
    patch = 2 * grid * 3 * cfg.vision_patch ** 2 * cfg.vision_width
    pair = (tower(grid + 1, cfg.vision_width, cfg.vision_layers)
            + tower(cfg.context_length, cfg.text_width, cfg.text_layers)
            + 2 * cfg.embed_dim * (cfg.vision_width + cfg.text_width))
    return 3 * (b * pair + 2 * b * b * cfg.embed_dim) + 2 * b * patch


def train_clip_full_width(torch, mods, mesh, dev, work):
    """CLIP ViT-L/14 contrastive steps in f32 (TF32 off, phase 1) at 224 px
    and context 77 through ``make_sharded_train_step`` on the 1 x 1 mesh:
    a warm-up step counted by ``mfu.program_cost``, three timed steps, then
    the checkpoint round trip of the state."""
    from beyondff_tpu_torch.utils.profiling import PEAK_FLOPS

    clip_mod, layers, trainer, ckpt, mfu = mods
    cfg = clip_mod.PRESETS["ViT-L/14"]
    t0 = time.perf_counter()
    module = layers.build(lambda: clip_mod.CLIPModule(cfg), dev, torch.float32, SEED + 6)
    init_state, step = trainer.make_sharded_train_step(module, mesh, lr=1e-5)
    state = init_state()
    n_params = sum(p.numel() for p in module.parameters())
    del module
    g = torch.Generator(device=dev).manual_seed(SEED)
    b, n = TRAIN_BATCH, cfg.image_resolution
    images = torch.randn(b, n, n, 3, device=dev, generator=g)
    tokens = torch.randint(1, cfg.vocab_size - 1, (b, cfg.context_length), device=dev,
                           generator=g)
    tokens[:, cfg.context_length // 4] = cfg.vocab_size - 1  # EOT
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    first = {}

    def warm():
        _, first["loss"] = step(state, images, tokens)
        torch.cuda.synchronize()

    cost = mfu.program_cost(warm)
    losses, step_ms = [float(first["loss"])], []
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, loss = step(state, images, tokens)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    # allocations that had to free the allocator's cache and try again
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    median_s = float(np.median(step_ms)) / 1e3
    analytic = clip_step_flops(cfg, b)
    check(cost is not None and all(np.isfinite(losses)), f"CLIP step: losses {losses}")
    check(state.step == 4, "CLIP step count")
    emit({"phase": "train_clip_full_width", "model": "ViT-L/14", "dtype": "float32",
          "tf32": False, "batch": b, "image": n, "context": cfg.context_length,
          "parameters": n_params, "mesh": list(mesh.shape), "build_s": build_s,
          "losses": losses, "step_ms": step_ms,
          "mfu": mfu.summarize("clip_train_step", cost, median_s, dev),  # the median step
          "counted_tflop": cost.flops / 1e12, "analytic_tflop": analytic / 1e12,
          "bound_f32_ms": cost.flops / PEAK_FLOPS["float32"] * 1e3,
          "bound_bf16_ms": cost.flops / PEAK_FLOPS["bfloat16"] * 1e3,
          "share_of_f32_peak": cost.flops / median_s / PEAK_FLOPS["float32"],
          "share_of_bf16_peak": cost.flops / median_s / PEAK_FLOPS["bfloat16"],
          "max_memory_allocated_bytes": peak, "alloc_retries_in_timed_steps": retries})
    check(abs(cost.flops / analytic - 1) < 0.05,
          f"counted {cost.flops:.4g} FLOPs against {analytic:.4g} by the shapes")

    # the state (module, AdamW moments, step) through a file and back; the
    # next step must be bit-equal with and without the round trip
    path = os.path.join(work, "clip_state.pt")
    t0 = time.perf_counter()
    ckpt.save_params(path, state)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    like = init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded = ckpt.load_params(path, like)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    os.remove(path)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, la = step(state, images, tokens)
        _, lb = step(loaded, images, tokens)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize()
    sa, sb = state.module.state_dict(), loaded.module.state_dict()
    differ = [k for k in sa if not torch.equal(local(torch, sa[k]), local(torch, sb[k]))]
    moments = all(torch.equal(local(torch, x[k]), local(torch, y[k]))
                  for x, y in zip(state.optimizer.state.values(), loaded.optimizer.state.values())
                  for k in ("exp_avg", "exp_avg_sq"))
    emit({"phase": "checkpoint_roundtrip", "bytes": size, "save_s": save_s, "load_s": load_s,
          "step": loaded.step, "loss_equal": bool(torch.equal(la, lb)),
          "params_differing": len(differ), "moments_equal": moments})
    check(not differ and moments and torch.equal(la, lb) and loaded.step == state.step == 5,
          f"the step after the checkpoint round trip differs: {differ[:5]}")


def train_sam_decoder_full_width(torch, mods, mesh, dev):
    """SAM ViT-H decoder fine-tuning in f32: 8 synthetic 1024 x 1024 frames
    encoded by the port's ViT-H (``SAM.encode_frames``; its inference
    tensors cloned for autograd), one box a frame, the box's rectangle on
    the 256 x 256 grid as the target, five ``make_sam_finetune_step`` steps."""
    sam_mod, layers, ft, mfu = mods
    cfg = sam_mod.PRESETS["vit_h"]
    lr, wd = 1e-4, 0.01
    os.environ.pop("BFF_SAM_RELPOS_FLASH", None)  # the JAX default: no kernel on the encoder
    module = layers.build(lambda: sam_mod.SAMModule(cfg), dev, torch.float32, SEED + 7)
    sam = sam_mod.SAM(cfg, module)
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    s = cfg.img_size
    frames = torch.randint(0, 256, (SAM_TRAIN_FRAMES, s, s, 3), dtype=torch.uint8, device=dev,
                           generator=g)
    t0 = time.perf_counter()
    embs = torch.cat([sam.encode_frames(frames[i:i + 4]) for i in range(0, len(frames), 4)])
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    embs = embs.clone()  # out of inference mode, so autograd may save it
    lo = torch.rand(SAM_TRAIN_FRAMES, 2, device=dev, generator=g) * 600
    wh = 128 + torch.rand(SAM_TRAIN_FRAMES, 2, device=dev, generator=g) * 296
    boxes = torch.cat([lo, lo + wh], 1)
    grid = 4 * embs.shape[1]
    centre = (torch.arange(grid, device=dev, dtype=torch.float32) + 0.5) * (s / grid)
    inside_x = (centre >= boxes[:, None, 0:1]) & (centre < boxes[:, None, 2:3])
    inside_y = (centre >= boxes[:, None, 1:2]) & (centre < boxes[:, None, 3:4])
    targets = (inside_y.transpose(1, 2) & inside_x).float()  # (B, grid, grid)
    init_state, step = ft.make_sam_finetune_step(module, mesh, lr=lr)
    state = init_state()
    start = {k: v.clone() for k, v in module.state_dict().items()}
    del sam
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = {}

    def counted():
        _, first["loss"] = step(state, embs, boxes, targets)
        torch.cuda.synchronize()

    cost = mfu.program_cost(counted)  # the first of the five steps, not timed
    losses, step_ms = [float(first["loss"])], []
    for _ in range(4):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        _, loss = step(state, embs, boxes, targets)
        z.record()
        torch.cuda.synchronize()
        step_ms.append(a.elapsed_time(z))
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    decay = (1 - lr * wd) ** 5
    enc_dev, enc_moved, dec_leaves, dec_moved, dec_move = 0.0, 0, 0, 0, 0.0
    for k, v in state.module.state_dict().items():
        want = start[k] * decay
        dev_k = float((v - want).abs().max())
        scale = float(want.abs().max())
        if ft.frozen(k):
            enc_dev = max(enc_dev, dev_k / max(scale, 1e-30))
            enc_moved += not torch.equal(v, start[k])
        elif k.startswith("mask_decoder.transformer."):
            # moved beyond the decay and its float rounding
            dec_leaves += 1
            dec_moved += dev_k > 1e-6 * scale
            dec_move = max(dec_move, dev_k)
    n_enc = sum(ft.frozen(k) for k in start)
    emit({"phase": "train_sam_decoder_full_width", "model": "vit_h", "dtype": "float32",
          "frames": SAM_TRAIN_FRAMES, "embedding": list(embs.shape[1:]), "encode_s": encode_s,
          "parameters": sum(v.numel() for v in start.values()), "lr": lr, "losses": losses,
          "step_ms": step_ms,
          "mfu": mfu.summarize("sam_decoder_step", cost, float(np.median(step_ms)) / 1e3, dev),
          "encoder_leaves": n_enc, "encoder_leaves_moved": enc_moved,
          "encoder_max_rel_dev_from_decay": enc_dev,
          "decoder_transformer_leaves": dec_leaves, "decoder_transformer_leaves_moved": dec_moved,
          "decoder_max_abs_move": dec_move, "max_memory_allocated_bytes": peak})
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"SAM losses {losses}")
    check(enc_dev <= 1e-6, f"encoder leaves moved beyond the decay: {enc_dev}")
    check(enc_moved > 0, "no encoder leaf decayed (the JAX step decays them)")
    check(dec_leaves and dec_moved == dec_leaves,
          f"{dec_leaves - dec_moved} of the decoder transformer's {dec_leaves} leaves did not move")


def lift_fixture(torch, dispatch_mods, root, dev):
    """The full-width 3D fixture's lift inputs on the card: its 250 000
    points, the 300 frames' fused projections and depth (prepared to
    968 x 1296 as the projection stage prepares it) and every frame's RLE
    run bounds (frames without records: pad runs only)."""
    geometry, rle, io, readers = dispatch_mods
    scene = os.path.join(root, "2D", "scene0000_00")
    reader = readers.build_dataset("scannet200", scene)
    intr = reader.intrinsic()
    pts = np.load(os.path.join(root, "3D", "npy", "scene0000_00.npy"))[:, :3]
    records = io.load_frame_records(os.path.join(root, "mask_2d", QUERY, "scene0000_00.pth"))
    by_frame = {str(r["frame_id"]).rsplit(".", 1)[0]: r for r in records}
    ids = reader.frame_ids
    hw = FRAME_HW[0] * FRAME_HW[1]
    m = max(len(r["segmented_frame_masks"]) for r in records)
    bounds = [[rle.rle_bounds(x) for x in by_frame[f]["segmented_frame_masks"]]
              if f in by_frame else [] for f in ids]
    r = max(len(s0) for fr in bounds for s0, _ in fr)
    st = np.full((len(ids), m, r), hw + 1, np.int64)
    en = np.zeros((len(ids), m, r), np.int64)
    for i, fr in enumerate(bounds):
        for j, (s0, e0) in enumerate(fr):
            st[i, j, :len(s0)] = s0
            en[i, j, :len(e0)] = e0
    raw = torch.from_numpy(np.stack([reader.depth_raw(f) for f in ids]).view(np.int16)).to(dev)
    return (torch.from_numpy(geometry.homogenize(pts)).to(dev),
            torch.from_numpy(np.stack([geometry.fuse_projection(intr, reader.pose(f))
                                       .astype(np.float32) for f in ids])).to(dev),
            geometry.prepare_depth(raw, FRAME_HW, 1000.0),
            torch.from_numpy(st).to(dev), torch.from_numpy(en).to(dev), m)


def sharded_lift_full_width(torch, mods, mesh, root, dev):
    """The sharded RLE and packed lifts over the full-width 3D fixture on
    the one-rank mesh, against ``core.geometry``'s, exactly."""
    geometry, plift, fixture_mods = mods
    t0 = time.perf_counter()
    pcd_h, projs, depths, st, en, m = lift_fixture(torch, fixture_mods, root, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    packed = geometry.rle_runs_to_packed(st, en, FRAME_HW[0] * FRAME_HW[1])
    rec = {"phase": "sharded_lift_full_width", "points": pcd_h.shape[1],
           "frames": projs.shape[0], "masks_per_frame": m, "runs_per_mask": st.shape[2],
           "mesh": list(mesh.shape), "fixture_load_s": load_s}
    for name, sharded, plain, args in (
            ("rle", plift.make_sharded_lift_rle(mesh), geometry.lift_frames_rle, (st, en)),
            ("packed", plift.make_sharded_lift_packed(mesh, n_masks=m),
             lambda *a: geometry.lift_frames_packed(*a, n_masks=m), (packed,))):
        t0 = time.perf_counter()
        got = sharded(pcd_h, projs, depths, *args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = plain(pcd_h, projs, depths, *args)
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        rec[name] = {"equal": equal, "ms": ms, "members": int(got[0].sum()),
                     "viewed": int(got[2].sum())}
        check(equal and int(got[2].sum()) > 0 and int(got[0].sum()) > 0,
              f"sharded {name} lift differs from core.geometry's")
    emit(rec)


def training_and_parallel(torch, mods, work, root3d, dev):
    """Phase 9: the training path and the parallel layer on a one-rank NCCL
    group and a 1 x 1 mesh, with every kernel's launch count held at 0."""
    (fa, dispatch, clip_mod, sam_mod, layers, trainer, ft, ckpt, mfu, mesh_lib, plift,
     geometry, fixture_mods) = mods
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    dispatch.reset_launch_counts()
    autograd_guard(torch, fa, dispatch, dev)
    process_group(torch)
    try:
        mesh = mesh_lib.make_mesh(data=1, model=1)
        train_clip_full_width(torch, (clip_mod, layers, trainer, ckpt, mfu), mesh, dev, work)
        torch.cuda.empty_cache()
        train_sam_decoder_full_width(torch, (sam_mod, layers, ft, mfu), mesh, dev)
        torch.cuda.empty_cache()
        sharded_lift_full_width(torch, (geometry, plift, fixture_mods), mesh, root3d, dev)
    finally:
        torch.distributed.destroy_process_group()
    torch.cuda.empty_cache()
    launches = dict(dispatch.launch_counts)
    emit({"phase": "training_launches", "launches": launches,
          "phase_seconds": time.perf_counter() - t0})
    check(not any(launches.values()), f"a kernel was launched on the training path: {launches}")


# ------------------------------------------------------------ the transports
TRANSPORTS_OFF = {"BFF_SEG2D_YUV": "0", "BFF_CLIP_DEVICE_CROPS": "0", "BFF_SEG2D_JXT": "0",
                  "BFF_SEG2D_BATCH_UPLOAD": "0"}
# the transports' A/B and the prefetch rounds: one each, to keep the run's
# time with phase 12
SEG2D_AB_ROUNDS = 1
PREFETCH_ROUNDS = 1
JPEG_NOISE = 4  # levels of noise in phase 10's JPEG frames (JXT's guard takes them)
N_CROPS = 512


def with_env(env, fn):
    """``fn()`` with the environment variables ``env`` set, then restored."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def timed(torch, fn, warm=False):
    """(result, seconds) of ``fn()`` with the card synchronized after it;
    ``warm``: after one untimed call (allocations, first launches)."""
    if warm:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def native_checks(torch, native, rle, io, fixture):
    """The native runtime: a cold build into an empty directory, then each
    entry point against the numpy / OpenCV path on phase 7's fixture, bit
    for bit: the RLE batch decode and the encode of its 2D masks, the depth
    decode (single and batched) of its 300 PNGs at their own size; at the
    stage's 968x1296 the runtime's own bilinear (single against batched bit
    for bit, against OpenCV's INTER_LINEAR within 1e-3 m)."""
    import cv2

    tmp = tempfile.mkdtemp(prefix="chip_smoke_native_")
    old, native.BUILD_DIR = native.BUILD_DIR, tmp
    try:
        t0 = time.perf_counter()
        path = native.build()
        cold_s = time.perf_counter() - t0
    finally:
        native.BUILD_DIR = old
        shutil.rmtree(tmp)
    recs = io.load_frame_records(os.path.join(fixture["paths"]["mask_2d_dir"], QUERY,
                                              "scene0000_00.pth"))
    rles = [m for r in recs for m in r["segmented_frame_masks"]]
    t0 = time.perf_counter()
    got = native.rle_decode_batch_native(rles)
    nat_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = np.stack([rle.rle_decode(r) for r in rles])
    np_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(got, want), "native RLE batch decode differs from numpy")
    t0 = time.perf_counter()
    enc = [native.rle_encode_native(m) for m in got]
    enc_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    enc_np = [rle.rle_encode(m) for m in got]
    enc_np_ms = (time.perf_counter() - t0) * 1e3
    check(all(a["length"] == b["length"] and np.array_equal(a["counts"], b["counts"])
              for a, b in zip(enc, enc_np)), "native RLE encode differs from numpy")
    del got, want
    depth_dir = os.path.join(fixture["paths"]["scene_2d_dir"], "scene0000_00", "depth")
    pngs = sorted((os.path.join(depth_dir, f) for f in os.listdir(depth_dir)),
                  key=lambda p: int(os.path.basename(p).split(".")[0]))
    t0 = time.perf_counter()
    cv = np.stack([cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0
                   for p in pngs])
    cv_ms = (time.perf_counter() - t0) * 1e3
    hw = cv.shape[1:]
    t0 = time.perf_counter()
    single = np.stack([native.decode_depth_native(p, 1000.0, hw) for p in pngs])
    single_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = native.decode_depth_batch_native(pngs, 1000.0, hw)
    batch_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(single, cv) and np.array_equal(batch, cv),
          "native depth decode differs from OpenCV")
    big_single = np.stack([native.decode_depth_native(p, 1000.0, FRAME_HW) for p in pngs[:8]])
    big_batch = native.decode_depth_batch_native(pngs[:8], 1000.0, FRAME_HW)
    big_cv = np.stack([cv2.resize(d, FRAME_HW[::-1]) for d in cv[:8]])
    resize_err = float(np.abs(big_single - big_cv).max())
    check(np.array_equal(big_single, big_batch) and resize_err <= 1e-3,
          f"native depth resize: batch differs or {resize_err} m from OpenCV")
    return {"library": path, "cold_build_s": cold_s,
            "rle": {"masks": len(rles), "decode_ms": {"native": nat_ms, "numpy": np_ms},
                    "encode_ms": {"native": enc_ms, "numpy": enc_np_ms}, "bit_equal": True},
            "depth": {"frames": len(pngs), "hw": list(hw),
                      "decode_ms": {"opencv": cv_ms, "native": single_ms,
                                    "native_batch": batch_ms},
                      "bit_equal": True, "resize_968x1296_max_err_m": resize_err}}


def jpeg_scene(root, scene_id, n, quality=95):
    """``n`` of ``synthetic_frame``'s frames at 968x1296 with +-JPEG_NOISE
    levels of noise, written as baseline JPEGs (OpenCV, quality 95).
    Returns the RGB frames and the files' bytes."""
    import cv2

    color = os.path.join(root, scene_id, "color")
    os.makedirs(color, exist_ok=True)
    frames, blobs = [], []
    for i in range(n):
        path = os.path.join(color, f"{i}.jpg")
        img = synthetic_frame(path, FRAME_HW[::-1], noise=JPEG_NOISE)
        check(cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality]),
              f"writing {path}")
        frames.append(img)
        with open(path, "rb") as f:
            blobs.append(f.read())
    return frames, blobs


def host_crops(frame, boxes, mode, frame_hw, det_hw, mean, std, n=224):
    """The host lookup-table chain (``Segmentor2D._clip_crops`` and
    ``CLIP.preprocess``) in OpenCV with its own arithmetic (IPP off):
    INTER_LINEAR to the detector size and the normalise table (gdino), or
    the ``* 255`` wrap (yolo), the crop, INTER_CUBIC short side to n and the
    centre crop."""
    import cv2

    if mode == "gdino":
        src = cv2.resize(frame, det_hw[::-1], interpolation=cv2.INTER_LINEAR)
        lut = (((np.arange(256, dtype=np.float32)[:, None] / 255.0 - mean) / std)
               * 255).astype(np.uint8).reshape(1, 256, 3)
    else:
        src = frame
        lut = (np.arange(256, dtype=np.uint8) * 255).astype(np.uint8)
    sh, sw = src.shape[:2]
    sx, sy = sw / frame_hw[1], sh / frame_hw[0]
    out = []
    for bx0, by0, bx1, by1 in boxes:
        x0, y0 = max(0, int(bx0 * sx)), max(0, int(by0 * sy))
        x1, y1 = min(sw, int(bx1 * sx)), min(sh, int(by1 * sy))
        c = cv2.LUT(np.ascontiguousarray(src[y0:y1, x0:x1]), lut)
        h, w = c.shape[:2]
        scale = n / min(h, w)
        nh, nw = round(h * scale), round(w * scale)
        r = cv2.resize(c, (nw, nh), interpolation=cv2.INTER_CUBIC)
        top, left = (nh - n) // 2, (nw - n) // 2
        out.append(r[top:top + n, left:left + n])
    return np.stack(out)


def transport_checks(torch, mods, fixture, dev, seg, frames, blobs):
    """Each transport against its dense path on the card, with the wire
    bytes a pixel and the ms of each side (host clock, card synchronized):
    YCrCb against ``roundtrip_host`` (within one level), JXT against
    ``cv2.imdecode`` of the same files (the JAX package's bar: at most 5
    levels, mean about 0.4), device crops against the host chain at 512
    crops in both modes, and depth-pack over phase 7's 300 depth frames
    against the raw upload (bit for bit, spills counted)."""
    import cv2

    color, jxt, crop_resize, depth_pack, readers = mods
    from beyondff_tpu_torch.models.gdino.model import IMAGE_MEAN, IMAGE_STD, PRESETS

    out = {}
    n_px = FRAME_HW[0] * FRAME_HW[1]
    # YCrCb
    dense, dense_s = timed(torch, lambda: torch.from_numpy(np.stack(frames)).to(dev), warm=True)
    packed, pack_s = timed(torch, lambda: np.stack([color.pack_ycrcb420(f) for f in frames]))
    ycc, up_s = timed(torch, lambda: color.unpack(torch.from_numpy(packed).to(dev), *FRAME_HW),
                      warm=True)
    err = max(int(np.abs(ycc[i].cpu().numpy().astype(int)
                         - color.roundtrip_host(f).astype(int)).max())
              for i, f in enumerate(frames))
    check(err <= 1, f"YCrCb device unpack {err} levels from roundtrip_host")
    out["ycrcb"] = {"frames": len(frames), "bytes_per_px": packed.shape[1] / n_px,
                    "max_err_vs_roundtrip_host": err,
                    "ms": {"dense_upload": dense_s * 1e3, "host_pack": pack_s * 1e3,
                           "upload_unpack": up_s * 1e3}}
    # JXT
    t0 = time.perf_counter()
    packs = [jxt.pack_file(b) for b in blobs]
    jpack_s = time.perf_counter() - t0
    spills = sum(p is None for p in packs)
    check(spills == 0, f"JXT spilled {spills} of {len(blobs)} JPEG frames")
    t0 = time.perf_counter()
    ref = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)[..., ::-1] for b in blobs]
    imdecode_s = time.perf_counter() - t0
    native_frames, dec_s = timed(torch, lambda: jxt.upload_frames(packs, dev), warm=True)
    diff = np.abs(native_frames.cpu().numpy().astype(int) - np.stack(ref).astype(int))
    check(diff.max() <= 5 and diff.mean() < 1.0,
          f"JXT decode vs cv2.imdecode: max {diff.max()}, mean {diff.mean()}")
    out["jxt"] = {"frames": len(blobs), "spills": spills, "quality": 95, "noise": JPEG_NOISE,
                  "bytes_per_px": jxt.wire_bytes(packs) / len(packs) / n_px,
                  "file_bytes_per_px": float(np.mean([len(b) for b in blobs])) / n_px,
                  "max_err_vs_imdecode": int(diff.max()), "mean_err_vs_imdecode": float(diff.mean()),
                  "ms_per_frame": {"host_pack": jpack_s * 1e3 / len(blobs),
                                   "cv2_imdecode": imdecode_s * 1e3 / len(blobs),
                                   "upload_decode": dec_s * 1e3 / len(blobs)}}
    # device crops, both modes, from the SAM-scale buffers JXT gives
    sam_hw = seg.sam.scaled_hw(FRAME_HW)
    bufs = jxt.resize_frames(native_frames, sam_hw)
    host = bufs.cpu().numpy()
    rng = np.random.default_rng(SEED + 10)
    fpos = np.repeat(np.arange(len(frames)), N_CROPS // len(frames))
    xy0 = rng.uniform(0, 1, (N_CROPS, 2)) * [FRAME_HW[1] - 40, FRAME_HW[0] - 40]
    wh = rng.uniform(40, 600, (N_CROPS, 2))
    boxes = np.concatenate([xy0, np.minimum(xy0 + wh, FRAME_HW[::-1])], 1).astype(np.float32)
    det_hw = tuple(PRESETS["swinb"].image_size)
    crops = {}
    cv2.ipp.setUseIPP(False)
    try:
        for mode in ("yolo", "gdino"):
            kw = {"det_hw": det_hw, "mean": IMAGE_MEAN, "std": IMAGE_STD}
            got, dev_s = timed(torch, lambda: crop_resize.clip_crop_batch(
                bufs, fpos, boxes, np.ones(N_CROPS, bool), mode, FRAME_HW, **kw), warm=True)
            t0 = time.perf_counter()
            want = np.concatenate([host_crops(host[f], boxes[fpos == f], mode, FRAME_HW,
                                              **kw) for f in range(len(frames))])
            host_s = time.perf_counter() - t0
            d = np.abs(got.cpu().numpy() - want)
            if mode == "gdino":
                d = np.minimum(d, 256 - d)  # the normalise table wraps
            crops[mode] = {"max_diff": float(d.max()), "mean_diff": float(d.mean()),
                           "share_within_1": float((d <= 1).mean()),
                           "p95": float(np.percentile(d, 95)),
                           "ms": {"device": dev_s * 1e3, "host_chain": host_s * 1e3},
                           "bytes": {"device": boxes.nbytes, "host": want.nbytes}}
            # the JAX package's bars (tests/test_crop_resize.py)
            bar = (1.0, 2.0) if mode == "yolo" else (1.5, 6.0)
            check(d.mean() < bar[0] and np.percentile(d, 95) <= bar[1],
                  f"device crops ({mode}) vs the host chain: {crops[mode]}")
            del got
    finally:
        cv2.ipp.setUseIPP(True)
    out["device_crops"] = {"crops": N_CROPS, "source_hw": list(sam_hw), **crops}
    # depth-pack over phase 7's 300 frames
    reader = readers.build_dataset("scannet200", os.path.join(fixture["paths"]["scene_2d_dir"],
                                                              "scene0000_00"))
    raws = [reader.depth_raw(f) for f in reader.frame_ids]
    depth_pack._PACK_CACHE.clear()
    t0 = time.perf_counter()
    dpk = [depth_pack.pack_cached(r) for r in raws]
    dpack_s = time.perf_counter() - t0
    d_spills = sum(p is None for p in dpk)
    ok = [i for i, p in enumerate(dpk) if p is not None]
    packed_dev, dpk_up_s = timed(torch, lambda: torch.cat([
        depth_pack.upload_frames([dpk[i] for i in ok[j:j + 8]], dev) for j in range(0, len(ok), 8)]),
        warm=True)
    raw_dev, raw_up_s = timed(torch, lambda: torch.cat([
        torch.from_numpy(np.stack([raws[i] for i in ok[j:j + 8]]).view(np.int16)).to(dev)
        for j in range(0, len(ok), 8)]), warm=True)
    check(bool(torch.equal(packed_dev, raw_dev)), "depth-pack decode differs from the raw upload")
    wire = sum(dpk[i].nbytes for i in ok)
    out["depth_pack"] = {"frames": len(raws), "spills": d_spills,
                         "bytes_per_px": wire / sum(raws[i].size for i in ok),
                         "bit_equal": True,
                         "ms_per_frame": {"host_pack": dpack_s * 1e3 / len(raws),
                                          "upload_decode": dpk_up_s * 1e3 / max(len(ok), 1),
                                          "raw_upload": raw_up_s * 1e3 / max(len(ok), 1)}}
    return out


def seg2d_ab(torch, mods, dev, seg, cfg, work):
    """The fast variant's ``run()`` on the JPEG scene with the JAX package's
    defaults against every transport off, hit and miss regimes
    (``box_threshold`` 0 and 1.01), alternating over two rounds after one
    warm-up of each; each round's seconds are printed. Launch counts are
    summed over the defaults' runs."""
    seg2d, dispatch, io, StageProfiler = mods
    seg.frame_loader = io.load_image  # the JPEG files themselves
    variants = {"defaults": {}, "all_off": TRANSPORTS_OFF}
    regimes = {"hit": 0.0, "miss": 1.01}
    runs = {f"{v}_{r}": [] for v in variants for r in regimes}
    launches = {}

    def one(variant, regime):
        c = cfg.override(**{"detector.box_threshold": regimes[regime],
                            "paths.mask_2d_dir": os.path.join(work, f"masks_ab_{variant}"),
                            "paths.checkpoint_dir": os.path.join(work, f"ckpt_ab_{variant}")})
        seg.upload_stats.clear()
        prof = StageProfiler("segmentation_2d")
        dispatch.reset_launch_counts()
        old, seg.cfg = seg.cfg, c  # the segmentor reads its thresholds from its config
        try:
            res = with_env(variants[variant], lambda: seg2d.run(
                c, "clothes", scenes=["scene_jpeg"], segmentor=seg, profiler=prof, resume=False))
        finally:
            seg.cfg = old
        torch.cuda.synchronize()
        if variant == "defaults":
            for k, v in dispatch.launch_counts.items():
                launches[k] = launches.get(k, 0) + v
        scene_s = prof.durations["scene"]
        return {"frames_per_sec": N_FRAMES / scene_s, "scene_seconds": scene_s,
                "spans_s": {k: prof.durations.get(k, 0.0)
                            for k in ("load", "upload", "clip_crops", "clip", "detect",
                                      "sam_encode", "sam_decode", "encode_write")},
                "upload_bytes": seg.upload_stats["bytes"],
                "frames": {k: seg.upload_stats[k] for k in ("jxt", "ycrcb", "rgb", "jxt_spill")},
                "frames_with_boxes": res[0]["frames_with_boxes"] if res else 0}

    for v in variants:  # warm-up
        one(v, "hit")
    launches.clear()
    round_s = []
    for rnd in range(SEG2D_AB_ROUNDS):
        t_round = time.perf_counter()
        order = list(variants) if rnd == 0 else list(variants)[::-1]
        for regime in regimes:
            for v in order:
                runs[f"{v}_{regime}"].append(one(v, regime))
        round_s.append(time.perf_counter() - t_round)
    emit({"phase": "seg2d_ab_rounds", "seconds": round_s})
    for r in runs["defaults_hit"] + runs["defaults_miss"]:
        check(r["frames"]["jxt"] >= N_FRAMES and r["frames"]["jxt_spill"] == 0
              and r["frames"]["ycrcb"] == 0, f"the defaults did not run JXT: {r['frames']}")
    for r in runs["all_off_hit"] + runs["all_off_miss"]:
        check(r["frames"]["rgb"] == N_FRAMES and r["frames"]["jxt"] == 0,
              f"all-off ran a transport: {r['frames']}")
    for v in variants:
        for r in runs[f"{v}_hit"] + runs[f"{v}_miss"]:
            want = N_FRAMES if r in runs[f"{v}_hit"] else 0
            check(r["frames_with_boxes"] == want, f"{v}: {r['frames_with_boxes']} frames with "
                  f"boxes, {want} expected")
    return runs, launches


def projection_ab(torch, mods, Config, fixture, dev, work):
    """``projection.run`` at phase 7's fixture with ``BFF_DEPTH_PACK=1``
    against ``0``: cold (empty depth and pack caches) then warm, outputs
    bit-equal. Returns the times and the launch counts of the
    ``BFF_DEPTH_PACK=1`` (default) runs."""
    projection, depth_pack, dispatch, io, StageProfiler = mods
    out, dicts, launches = {}, {}, {}
    for v in ("1", "0"):
        cfg = config_3d(Config, fixture, os.path.join(work, f"dpack_{v}"))
        depth_pack._PACK_CACHE.clear()
        for temp in ("cold", "warm"):
            prof = StageProfiler("projection")
            dispatch.reset_launch_counts()
            _res, secs = timed(torch, lambda: with_env({"BFF_DEPTH_PACK": v}, lambda: projection.run(
                cfg, QUERY, resume=False, device=dev, profiler=prof)))
            if v == "1":
                for k, n in dispatch.launch_counts.items():
                    launches[k] = launches.get(k, 0) + n
            out[f"dpack_{v}_{temp}"] = {"seconds": secs, "lift_s": prof.durations["lift"]}
        dicts[v] = io.load_stage_dict(os.path.join(cfg.paths.mask_3d_dir, QUERY,
                                                   "scene0000_00.pth"))
    same = all(np.array_equal(np.asarray(dicts["1"][k]), np.asarray(dicts["0"][k]))
               for k in ("ins", "conf")) and \
        list(dicts["1"]["final_class"]) == list(dicts["0"]["final_class"])
    check(same and np.asarray(dicts["1"]["ins"]).shape[0] > 0,
          "projection outputs differ between BFF_DEPTH_PACK=1 and 0")
    return out, launches


def transports(torch, mods, Config, work, fixture, dev, seg, cfg, card):
    """Phase 10: the native runtime and the JAX package's transports on the
    card with the fast variant's full-width models (phase 8, with phase 4's
    CLIP archive) and phase 7's fixture. The JPEG scene's 8 frames carry
    +-4 levels of noise (``JPEG_NOISE``; ``synthetic_frame``'s +-12 sits at
    the edge of JXT's spill guard). The last line of the phase holds the
    paired seg2d and projection A/Bs with the card's name and power
    limit."""
    from beyondff_tpu_torch.core import color, crop_resize, depth_pack, jxt
    from beyondff_tpu_torch.data import readers
    from beyondff_tpu_torch.utils import native

    seg2d, projection, dispatch, io, rle, StageProfiler = mods
    t_phase = time.perf_counter()
    emit({"phase": "native_runtime", **native_checks(torch, native, rle, io, fixture)})
    frames, blobs = jpeg_scene(os.path.join(work, "scenes"), "scene_jpeg", N_FRAMES)
    emit({"phase": "transports_vs_dense", "card": card, **transport_checks(
        torch, (color, jxt, crop_resize, depth_pack, readers), fixture, dev, seg, frames,
        blobs)})
    runs, launches = seg2d_ab(torch, (seg2d, dispatch, io, StageProfiler), dev, seg, cfg, work)
    proj, proj_launches = projection_ab(
        torch, (projection, depth_pack, dispatch, io, StageProfiler), Config, fixture, dev, work)
    emit({"phase": "transports_ab", "card": card, "frames": N_FRAMES, "env_off": TRANSPORTS_OFF,
          "seg2d": runs, "projection": proj,
          "launches_over_defaults": {"seg2d": launches, "projection": proj_launches},
          "seconds": time.perf_counter() - t_phase})
    check(launches["flash_attention_wgmma"] > 0 and launches["flash_attention"] == 0
          and launches.get("flash_masked_wgmma", 0) == 0
          and launches["nms_fixed"] > 0 and proj_launches["mask_iou_wgmma"] > 0,
          f"phase 10 launched no kernel, or K3 off the wgmma kernel: {launches}")


# ------------------------------------------------------------ phase 11
RECT_GRID = (48, 64)  # SAM's patch grid of a 968x1296 frame under BFF_SAM_RECT=1
# the CUDA functions behind each launch counter, for reading a profiler trace
KERNEL_SYMBOLS = {"ms_deform_sample": ("ms_deform_sample_kernel",),
                  "flash_attention": ("flash_tc_kernel", "flash_fwd_kernel"),
                  "flash_attention_f32": ("flash_fwd_kernel",),
                  "flash_attention_tf32": ("flash_tf32_kernel", "split_kv_kernel"),
                  "flash_attention_wgmma": ("flash_wgmma_kernel",),
                  "flash_masked_wgmma": ("flash_masked_wgmma_kernel",),
                  "flash_attention_relpos": ("flash_relpos_tc_kernel", "flash_relpos_kernel"),
                  "flash_attention_relpos_wgmma": ("flash_relpos_wgmma_kernel",),
                  "flash_attention_relpos_tf32": ("flash_relpos_tf32_kernel",
                                                  "split_kv_relpos_kernel"),
                  "window_attention_relpos": ("window_relpos_tc_kernel", "window_relpos_kernel"),
                  "window_attention_relpos_wgmma": ("window_relpos_wgmma_kernel",),
                  "window_attention_relpos_tf32": ("window_relpos_tf32_kernel",),
                  "mask_iou": ("iou_count_kernel",), "mask_iou_wgmma": ("iou_wgmma_kernel",),
                  "nms_fixed": ("nms_fixed_kernel",)}


def rect_phase(torch, mods, dev, card):
    """``measure_sam_rect`` on SAM ViT-H (bf16, ``BFF_SAM_RELPOS_FLASH=1``)
    and EfficientSAM-S (bf16) for the main path's batch of 968x1296 frames,
    launch counts set to 0 before each; then K3 at the rect grid's shape
    against its plain version (phase 2 holds K4 there). Returns SAM ViT-H
    (the one-rank part encodes with it)."""
    fa, sam_mod, esam, dispatch, measure = mods
    out = {}
    for name, build in (("sam_vit_h", lambda: sam_mod.SAM.create(
            "vit_h", seed=SEED + 2, dtype=torch.bfloat16, device=dev)),
                        ("efficientsam_s", lambda: esam.EfficientSAM.create(
                            "vits", seed=SEED + 4, dtype=torch.bfloat16, device=dev))):
        model = build()
        nh, nw = model.scaled_hw(FRAME_HW)
        frames = torch.from_numpy(np.stack([synthetic_frame(f"{i}.jpg", (nw, nh))
                                            for i in range(FRAME_BATCH)])).to(dev)
        dispatch.reset_launch_counts()
        rec = with_env({"BFF_SAM_RELPOS_FLASH": "1"}, lambda: measure.measure(
            model, frames, measure.BOXES_1024, FRAME_HW, iters=8))
        rec["launches"] = dict(dispatch.launch_counts)
        emit({"phase": "sam_rect", "model": name, "card": card, **rec})
        check(rec["grid_rect"] == list(RECT_GRID) and rec["grid_square"] == [64, 64],
              f"{name}: rect grid {rec['grid_rect']}")
        kernel = ("flash_attention_relpos_wgmma" if name == "sam_vit_h"
                  else "flash_attention_wgmma")
        check(rec["launches"].get(kernel, 0) > 0, f"{name}: {kernel} not launched")
        check(rec["launches"].get("flash_attention", 0) == 0
              and rec["launches"].get("flash_masked_wgmma", 0) == 0
              and rec["launches"].get("flash_attention_relpos", 0) == 0
              and (name == "efficientsam_s" or rec["launches"]["flash_attention_wgmma"] == 0),
              f"{name}: attention off its kernel: {rec['launches']}")
        check(np.isfinite(rec["emb_rel_l2"]) and min(rec["mask_iou"]) > 0.0,
              f"{name}: rect outputs {rec['emb_rel_l2']} {rec['mask_iou']}")
        out[name] = model if name == "sam_vit_h" else None
        del model, frames
        torch.cuda.empty_cache()
    s = RECT_GRID[0] * RECT_GRID[1]
    flash_case(torch, fa, "efficientsam_global_rect", (6 * FRAME_BATCH, s, 64), s,
               torch.bfloat16, dev)
    return out["sam_vit_h"]


def v1_head_phase(torch, mods, dev, work):
    """YOLO-World-L with the v1 head (``bn_head=False``, the L2 contrastive
    head) from an official-layout file written here: loaded on the card and
    on the CPU, every tensor as written; its boxes and class logits on two
    968x1296 frames on the card against the CPU path (f32, TF32 off; within
    1e-3 of the logits' range and 1e-2 px); then NMS on the card's own
    boxes and scores, the kernel against the plain version on the CPU, index
    for index."""
    import dataclasses

    yw, nms, resize = mods
    cfg = dataclasses.replace(yw.PRESETS["l"], bn_head=False)
    det = yw.YOLOWorld.create(cfg, seed=SEED + 7, device=dev)
    spread_weights(torch, det.module, SEED + 7)
    sd = {k: v.float().cpu() for k, v in det.module.state_dict().items()}
    del det
    check(not any(".cv4." in k and ".norm." in k for k in sd), "a v1 head has no norm")
    reg_max = cfg.reg_max
    extra = {"model.22.dfl.conv.weight": torch.arange(reg_max, dtype=torch.float32).reshape(
        1, reg_max, 1, 1)}
    path = os.path.join(work, "yolov8l-world.pt")
    torch.save({"model": {"model." + k: v for k, v in {**sd, **extra}.items()}}, path)
    card_m = yw.load_torch_checkpoint(path, cfg, torch.float32, dev)
    cpu_m = yw.load_torch_checkpoint(path, cfg, torch.float32, "cpu")
    for m in (card_m, cpu_m):
        for k, v in m.state_dict().items():
            check(torch.equal(v.cpu(), sd[k]), f"v1 head: {k} not as written")
    frames = np.stack([synthetic_frame(f"{i}.jpg", FRAME_HW[::-1]) for i in range(2)])
    txt = np.random.default_rng(SEED).normal(size=(3, cfg.text_dim)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    outs = {}
    for name, m, d in (("card", card_m, dev), ("cpu", cpu_m, torch.device("cpu"))):
        x = resize.resize_linear(torch.from_numpy(frames).to(d), cfg.img_size).float() / 255.0
        with torch.inference_mode():
            t0 = time.perf_counter()
            boxes, logits = m.detect(*m.backbone(x), torch.from_numpy(txt).to(d))
            if d.type == "cuda":
                torch.cuda.synchronize()
            outs[name] = (boxes.cpu(), logits.cpu(), time.perf_counter() - t0)
    (cb, cl, card_s), (pb, pl, cpu_s) = outs["card"], outs["cpu"]
    logit_err = float((cl - pl).abs().max())
    logit_range = float(pl.abs().max())
    box_err = float((cb - pb).abs().max())
    scores_card = torch.sigmoid(cl).max(-1).values
    keep_k, valid_k = nms.nms_fixed(cb.to(dev), scores_card.to(dev), 0.5, cfg.max_dets)
    keep_p, valid_p = nms.nms_fixed_plain(cb, scores_card, 0.5, cfg.max_dets)
    same = torch.equal(keep_k.cpu(), keep_p) and torch.equal(valid_k.cpu(), valid_p)
    rec = {"phase": "yolo_world_v1_head", "anchors": int(cl.shape[1]), "frames": 2,
           "logit_max_abs_err": logit_err, "logit_range": logit_range,
           "box_max_abs_err_px": box_err, "kept": int(valid_p.sum()),
           "nms_index_for_index": same, "card_s": card_s, "cpu_s": cpu_s}
    emit(rec)
    check(logit_err <= 1e-3 * max(1.0, logit_range) and box_err <= 1e-2,
          f"v1 head card vs CPU: logits {logit_err}, boxes {box_err}")
    check(same and rec["kept"] > 0, "v1 head: NMS kernel and plain version disagree")


def prefetch_phase(torch, mods, seg, cfg, work, card):
    """The fast variant's ``run()`` in the hit regime on phase 10's JPEG
    scene with the frame prefetch off (``prefetch_map`` replaced by in-order
    loads in the scene loop's thread), on with one loader thread and on with
    four (``BFF_SEG2D_WORKERS``), ``PREFETCH_ROUNDS`` rounds in turns after a
    warm-up: the ``.pth`` bytes equal across every run, frames/s each."""
    seg2d, dispatch, StageProfiler = mods
    runs, blobs = {"off": [], "1": [], "4": []}, set()
    prefetch_map = seg2d.prefetch_map

    def one(workers):
        c = cfg.override(**{"detector.box_threshold": 0.0,
                            "paths.mask_2d_dir": os.path.join(work, f"masks_pf_{workers}"),
                            "paths.checkpoint_dir": os.path.join(work, f"ckpt_pf_{workers}")})
        prof = StageProfiler("segmentation_2d")
        old, seg.cfg = seg.cfg, c
        if workers == "off":
            seg2d.prefetch_map = lambda fn, items, depth, workers: (fn(x) for x in items)
        try:
            with_env({"BFF_SEG2D_WORKERS": "1" if workers == "off" else workers},
                     lambda: seg2d.run(c, "clothes", scenes=["scene_jpeg"], segmentor=seg,
                                       profiler=prof, resume=False))
        finally:
            seg.cfg, seg2d.prefetch_map = old, prefetch_map
        torch.cuda.synchronize()
        with open(os.path.join(c.paths.mask_2d_dir, "clothes", "scene_jpeg.pth"), "rb") as f:
            blobs.add(f.read())
        return {"frames_per_sec": prof.rate("scene", "frames"),
                "load_s": prof.durations.get("load", 0.0),
                "upload_s": prof.durations.get("upload", 0.0)}

    one("1")
    for order in (("off", "1", "4"), ("4", "1", "off"))[:PREFETCH_ROUNDS]:
        for w in order:
            runs[w].append(one(w))
    emit({"phase": "seg2d_prefetch", "card": card, "frames": N_FRAMES,
          "workers": runs, "records_byte_equal": len(blobs) == 1})
    check(len(blobs) == 1, f"the records differ with the prefetch: {len(blobs)} versions")


def single_scene_phase(torch, mods, work, tmp, dev, card, detector):
    """The port's ``make_synthetic_scene``, then ``single_scene`` on the card
    at full width: Grounding-DINO Swin-B, SAM ViT-H and CLIP ViT-L/14 in
    bf16 from phase 4's official-layout files (``detector``'s paths;
    thresholds at their floor and no phrase match, so every frame has
    boxes), under ``profiling.trace`` (the Chrome trace goes to ``tmp``),
    with launch counts set to 0 just before it. Its PLY and HTML files must
    parse, K1, K2 and K6 must have launched, and the trace must name every
    kernel the loop launched. Returns the scene's config path."""
    gen, single, ply, profiling, dispatch = mods
    root = os.path.join(work, "single")
    cfg_path = gen.generate(root, query="clothes", seed=SEED + 9)
    out = os.path.join(work, "single_viz")
    sets = {"detector.dtype": "bfloat16", "detector.box_threshold": 0.0,
            "detector.similarity_threshold": -1.0, "detector.must_match_query": "false",
            **{f"detector.{k}": getattr(detector, k) for k in (
                "gdino_checkpoint", "sam_checkpoint", "clip_checkpoint", "bert_vocab_path",
                "clip_bpe_path")}}
    argv = ["--config", cfg_path, "--cls", "clothes", "--scene", "scene0000_00",
            "--device", "cuda", "--out", out]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    trace_dir = os.path.join(tmp, "single_trace")
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        single.main(argv)
    secs = time.perf_counter() - t0
    launches = dict(dispatch.launch_counts)
    n_points = len(np.load(os.path.join(root, "Scannet200_3D", "original_npy_files",
                                        "scene0000_00.npy")))
    for name in ("mask3d_clothes", "refined_clothes"):
        v = ply.read_ply_vertices(os.path.join(out, "scene0000_00", f"{name}.ply"))
        check(len(v["x"]) == n_points, f"{name}.ply: {len(v['x'])} vertices")
    with open(os.path.join(out, "scene0000_00", "web", "index.html")) as f:
        html = f.read()
    import re

    layers = json.loads(re.search(r"const LAYERS = (\[.*?\]);", html, re.S).group(1))
    check(len(layers) >= 3, f"viewer layers {[x['name'] for x in layers]}")
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"trace files {files}")
    trace_bytes = os.path.getsize(os.path.join(trace_dir, files[0]))
    with open(os.path.join(trace_dir, files[0])) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    shutil.rmtree(trace_dir)
    named = {k: any(sym in n for n in names for sym in KERNEL_SYMBOLS[k])
             for k, v in launches.items() if v}
    emit({"phase": "single_scene", "card": card, "seconds_traced": secs,
          "launches": launches, "ply_vertices": n_points,
          "viewer_layers": [x["name"] for x in layers], "trace_names_kernels": named,
          "trace_kernel_names": len(names), "trace_bytes": trace_bytes})
    for k in ("ms_deform_sample", "flash_masked_wgmma", "mask_iou_wgmma"):
        check(launches.get(k, 0) > 0, f"single_scene launched no {k}: {launches}")
    check(all(named.values()), f"the trace misses a launched kernel: {named}")
    return cfg_path


def one_rank_phase(torch, mods, sam, cfg_path, work, dev):
    """``projection.run``, Grounding-DINO's ``predict_batch`` and SAM
    ViT-H's ``encode_frames`` inside ``shard_frames`` over a one-rank NCCL
    group against the same calls with no group: equal outputs (a group of
    one rank shards nothing)."""
    Config, projection, gd, io, shard_frames = mods
    frames = np.random.default_rng(SEED + 8).integers(0, 255, (FRAME_BATCH, 48, 64, 3),
                                                       dtype=np.uint8)
    det = gd.GroundingDINO.create("test", seed=SEED + 8, device=dev)
    nh, nw = sam.scaled_hw(FRAME_HW)
    sam_frames = torch.from_numpy(np.stack([synthetic_frame(f"{i}.jpg", (nw, nh))
                                            for i in range(FRAME_BATCH)])).to(dev)

    def calls(tag):
        cfg = Config.from_yaml(cfg_path).override(**{
            "paths.mask_3d_dir": os.path.join(work, f"m3d_{tag}"),
            "paths.checkpoint_dir": os.path.join(work, f"ck_{tag}")})
        projection.run(cfg, "clothes", resume=False, device=dev)
        d = io.load_stage_dict(os.path.join(cfg.paths.mask_3d_dir, "clothes",
                                            "scene0000_00.pth"))
        dets = det.predict_batch(list(frames), "chair . towel", box_threshold=0.0,
                                 text_threshold=0.0)
        return d, dets, sam.encode_frames(sam_frames).float().cpu()

    solo = calls("solo")
    process_group(torch)
    try:
        with shard_frames():
            grouped = calls("group")
            sharded = projection.sharded_lifts(dev, 0.08) is not None
    finally:
        torch.distributed.destroy_process_group()
    same_proj = all(np.array_equal(np.asarray(solo[0][k]), np.asarray(grouped[0][k]))
                    for k in ("ins", "conf"))
    same_det = all(a[2] == b[2] and np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(solo[1], grouped[1]))
    same_emb = torch.equal(solo[2], grouped[2])
    emit({"phase": "one_rank", "world_size": 1, "sharded": sharded,
          "projection_equal": same_proj, "predict_batch_equal": same_det,
          "encode_frames_equal": same_emb,
          "instances": int(np.asarray(solo[0]["ins"]).shape[0]),
          "detections": sum(len(x[2]) for x in solo[1])})
    check(same_proj and same_det and same_emb and not sharded,
          "a call differs with a one-rank group up")


def phase11(torch, mods, Config, work, tmp, dev, fast_seg, fast_cfg, card, detector):
    """Phase 11: the rect encode (SAM ViT-H and EfficientSAM-S, K3 at the
    rect shape), the YOLO-World v1 head, the seg2d frame prefetch, the
    full-width single-scene loop under a trace (phase 4's checkpoint files,
    ``detector``), and the one-rank branches."""
    (fa, sam_mod, esam, yw, nms, resize, gd, dispatch, seg2d, projection, io,
     StageProfiler) = mods
    from beyondff_tpu_torch.parallel.frames import shard_frames
    from beyondff_tpu_torch.tools import make_synthetic_scene, measure_sam_rect, single_scene
    from beyondff_tpu_torch.utils import ply, profiling

    t0 = time.perf_counter()
    sam = rect_phase(torch, (fa, sam_mod, esam, dispatch, measure_sam_rect), dev, card)
    v1_head_phase(torch, (yw, nms, resize), dev, work)
    prefetch_phase(torch, (seg2d, dispatch, StageProfiler), fast_seg, fast_cfg, work, card)
    cfg_path = single_scene_phase(
        torch, (make_synthetic_scene, single_scene, ply, profiling, dispatch), work, tmp, dev,
        card, detector)
    one_rank_phase(torch, (Config, projection, gd, io, shard_frames), sam, cfg_path, work,
                   dev)
    del sam
    torch.cuda.empty_cache()
    emit({"phase": "phase11", "seconds": time.perf_counter() - t0})


# ------------------------------------------ phase 12: the deferred seg2d pipeline
SCHED_VARS = ("BFF_SEG2D_INFLIGHT", "BFF_SEG2D_DEFER", "BFF_SEG2D_EAGER_SAM")
P12_FRAMES = 24  # six batches of FRAME_BATCH: the pipeline reaches a steady state
CLASSIC_SETTINGS = ((1, 0, 1), (2, 1, 1))  # the serial order, the JAX default
FAST_SETTINGS = ((1, 0, 1), (2, 1, 1), (2, 1, 0), (3, 2, 1))


def sync_counted(torch, fn):
    """(result, synchronizing calls, their top call sites) of ``fn()`` under
    ``torch.cuda.set_sync_debug_mode("warn")``, which warns at every call
    that waits for a stream (blocking copies, ``.item()``, ``nonzero``);
    an event wait is not one."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    sites = {}
    for w in syncs:
        key = f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
        sites[key] = sites.get(key, 0) + 1
    return out, len(syncs), sorted(sites.items(), key=lambda kv: -kv[1])[:8]


def records_digest(records):
    """A digest of a scene's records: frame ids, labels, the confidences'
    and the bit-packed masks' bytes."""
    import hashlib

    h = hashlib.sha256()
    for r in records:
        h.update(r["frame_id"].encode())
        h.update("\0".join(r["labels"]).encode())
        h.update(np.asarray(r["confidences"], np.float64).tobytes())
        masks = np.asarray(r["segmented_frame_masks"], bool)
        h.update(str(masks.shape).encode())
        h.update(np.packbits(masks).tobytes())
    return h.hexdigest()


def scheduler_ab(torch, dispatch, seg, cfg, scene, variant, settings, regimes, rounds):
    """``Segmentor2D.process_scene`` on ``scene`` (``run()``'s ``scene``
    span: it ends synchronized) under each (``BFF_SEG2D_INFLIGHT``,
    ``BFF_SEG2D_DEFER``, ``BFF_SEG2D_EAGER_SAM``) setting and regime
    (``box_threshold``), alternating the settings' order over ``rounds``
    after one warm-up, launch counts set to 0 just before each timed run;
    then one pass of each under ``torch.profiler``, the sync debug mode and
    ``BFF_SEG2D_TRACE`` for the device's busy share, the synchronizing calls
    per batch and the host's blocking milliseconds per phase. The records
    must be byte-equal across every unprofiled run of a regime."""
    n_batches = -(-P12_FRAMES // cfg.detector.frame_batch)
    digests = {}

    def one(setting, regime, profiled=False):
        c = cfg.override(**{"detector.box_threshold": regimes[regime]})
        old, seg.cfg = seg.cfg, c  # the segmentor reads its thresholds from its config
        try:
            env = dict(zip(SCHED_VARS, map(str, setting)))

            def fn():
                return with_env(env, lambda: timed(
                    torch, lambda: seg.process_scene(scene, "clothes")))
            if profiled:
                import contextlib
                import io as pyio

                box, buf = {}, pyio.StringIO()
                env["BFF_SEG2D_TRACE"] = "1"  # the host-blocking seconds per phase
                with contextlib.redirect_stdout(buf):
                    busy_us, events, _ = device_activity(
                        torch, lambda: box.update(zip(("res", "n", "sites"),
                                                      sync_counted(torch, fn))))
                records, scene_s = box["res"]
                trace = [ln.split("frames): ", 1)[1] for ln in buf.getvalue().splitlines()
                         if ln.startswith("# seg2d host trace")]
                check(len(trace) == 1, "no seg2d host trace line")
                host_ms = {k: float(v[:-2]) for k, v in
                           (kv.split("=") for kv in trace[0].split())}
            else:
                dispatch.reset_launch_counts()
                records, scene_s = fn()
                launches = {k: v for k, v in dispatch.launch_counts.items() if v}
        finally:
            seg.cfg = old
        if not profiled:
            digests.setdefault(regime, set()).add(records_digest(records))
        out = {"scene_seconds": scene_s, "frames_per_sec": P12_FRAMES / scene_s,
               "frames_with_boxes": len(records)}
        if profiled:
            out.update({"device_busy_share": busy_us / 1e6 / scene_s,
                        "device_busy_ms": busy_us / 1e3, "device_events": events,
                        "sync_calls": box["n"], "sync_calls_per_batch": box["n"] / n_batches,
                        "sync_sites": box["sites"], "host_trace_ms": host_ms})
        else:
            out["launches"] = launches
        return out

    runs = {(r, st): [] for r in regimes for st in settings}
    one(settings[-1], next(iter(regimes)))  # warm-up
    for rnd in range(rounds):
        for regime in regimes:
            for st in (settings if rnd % 2 == 0 else settings[::-1]):
                runs[(regime, st)].append(one(st, regime))
    profiled = {(r, st): one(st, r, profiled=True) for r in regimes for st in settings}
    for regime in regimes:
        check(len(digests[regime]) == 1,
              f"{variant} {regime}: records differ across scheduler settings or runs")
    rows = []
    for (regime, st), timed_runs in runs.items():
        rows.append({"regime": regime, **dict(zip(SCHED_VARS, st)),
                     "frames_per_sec": [r["frames_per_sec"] for r in timed_runs],
                     "scene_seconds": [r["scene_seconds"] for r in timed_runs],
                     "frames_with_boxes": timed_runs[0]["frames_with_boxes"],
                     "launches": timed_runs[0]["launches"],
                     "profiled": profiled[(regime, st)]})
    emit({"phase": f"p12_scheduler_{variant}", "frames": P12_FRAMES,
          "frame_batch": cfg.detector.frame_batch, "batches": n_batches, "rounds": rounds,
          "records_byte_equal": True, "runs": rows})
    return rows


def phase12(torch, mods, dev, classic, classic_cfg, fast_seg, fast_cfg):
    """Phase 12: the deferred seg2d pipeline at full width on 24 frames
    (phase 4's loaded classic models, synthetic frames; phase 8's fast
    variant on baseline JPEGs, its JXT default), then the five profiling
    CLIs at full width."""
    dispatch, io = mods
    import contextlib
    import io as pyio

    from beyondff_tpu_torch.tools import (measure_depth_decimation, profile_enhancer,
                                          profile_gdino_blocks, profile_models, profile_sam)

    t0 = time.perf_counter()
    # the scenes (~20 MB of JPEGs) go to a temporary directory, not to
    # chiprun_out
    scenes = tempfile.mkdtemp(prefix="chip_smoke_p12_")
    classic_cfg = classic_cfg.override(**{"paths.scene_2d_dir": scenes})
    fast_cfg = fast_cfg.override(**{"paths.scene_2d_dir": scenes})
    make_scene(scenes, "scene_p12", P12_FRAMES)
    # one round, as the fast variant's (two until phase 14 took the time)
    rows = scheduler_ab(torch, dispatch, classic, classic_cfg, "scene_p12",
                        "classic", CLASSIC_SETTINGS, {"hit": 0.0}, 1)
    for r in rows:
        check(r["launches"].get("ms_deform_sample", 0) > 0
              and r["launches"].get("flash_masked_wgmma", 0) > 0
              and r["launches"].get("flash_attention", 0) == 0
              and r["launches"].get("flash_attention_wgmma", 0) == 0,
              f"classic {r}: K1 or K2 (on its wgmma kernel) was not launched, or K3 or the "
              "mma.sync tile was")
    jpeg_scene(scenes, "scene_p12_jpeg", P12_FRAMES)
    fast_seg.frame_loader = io.load_image  # the JPEG files themselves (JXT)
    rows = scheduler_ab(torch, dispatch, fast_seg, fast_cfg, "scene_p12_jpeg",
                        "fast", FAST_SETTINGS, {"hit": 0.0, "miss": 1.01}, 1)
    for r in rows:
        if r["regime"] == "hit":
            blocks = len(fast_seg.sam.cfg.global_attn_indexes)
            check(r["launches"].get("flash_attention_wgmma", 0)
                  == blocks * -(-P12_FRAMES // fast_cfg.detector.frame_batch)
                  and r["launches"].get("flash_attention", 0) == 0
                  and r["launches"].get("flash_masked_wgmma", 0) == 0
                  and r["launches"].get("nms_fixed", 0) > 0, f"fast {r}: K3 or NMS missing")
    shutil.rmtree(scenes)
    scheduler_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cli = {}
    argv = ["--device", "cuda", "--scale", "full", "--iters", "3"]
    dec_root = tempfile.mkdtemp(prefix="chip_smoke_dec_")
    try:
        for name, fn in (("profile_models", lambda: profile_models.main(argv)),
                         ("profile_sam", lambda: profile_sam.main(argv)),
                         ("profile_gdino_blocks", lambda: profile_gdino_blocks.main(argv)),
                         ("profile_enhancer", lambda: profile_enhancer.main(argv)),
                         ("measure_depth_decimation",
                          lambda: measure_depth_decimation.measure(dec_root, dev))):
            t_cli = time.perf_counter()
            buf = pyio.StringIO()
            with contextlib.redirect_stdout(buf):
                out = fn()
            lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
            cli[name] = time.perf_counter() - t_cli
            for row in lines:
                emit({"phase": "p12_cli", **row})
            if name == "measure_depth_decimation":
                emit({"phase": "p12_cli", "tool": name, "rows": out})
                check(out[1]["mean_final_mask_iou_vs_dec1"] == 1.0, "depth decimation: dec 1")
            else:
                check(lines and lines[-1]["variant"] in ("attribution", "summary"),
                      f"{name}: no summary line")
    finally:
        shutil.rmtree(dec_root, ignore_errors=True)
    by = {r["variant"]: r for r in _LINES if r.get("tool") == "profile_sam"}
    check(by["full_relpos_flash"]["global_branch"] == "relpos_flash"
          and by["norelpos_relpos_flash"]["global_relpos"] == "kept"
          and by["norelpos"]["global_relpos"] == "dropped",
          "profile_sam: the global blocks' branches")
    emit({"phase": "phase12", "scheduler_seconds": scheduler_s,
          "cli_seconds": cli, "seconds": scheduler_s + time.perf_counter() - t0})


# ------------------------------------ phase 13: the windowed clamp against exact

DEFORM_SIGMAS = (1.0, 2.0, 3.0, 4.0, 8.0)  # offsets, cells of the sampled level
DEFORM_ALPHAS = (0.05, 0.25, 1.0, 4.0)  # the encoder's sampling offsets scaled by alpha


def deform_window_phase(torch, mods, dev, card, cases):
    """Phase 13: ``tools/measure_deform_window`` on the card in bf16. K1 at
    the encoder raster (8 heads x 32, 4 points) in clamp and exact mode at
    the main path's modes and at PARITY.md's geometry (L0 (16, 16), L1
    (8, 8)), sigma 1 to 8 cells; then Grounding-DINO Swin-B at full width on
    one seeded 800x1072 input, windowed against exact, the encoder's
    offsets scaled by 0.05 to 4. At sigma 1 and the main path's modes
    nothing clamps and clamp equals exact bit for bit; every error is
    finite; alpha 0.05 moves no box by more than 1e-3."""
    dw, deformable, gd, dispatch = mods
    from beyondff_tpu_torch.tools import measure_deform_window as mdw

    t0 = time.perf_counter()
    geometries = (("main_path", deformable.level_modes(dw.ENC_SHAPES)),
                  ("parity_geometry", mdw.tile_modes(dw.ENC_SHAPES, (16, 8))))
    rows = {}
    for tag, modes in geometries:
        dispatch.reset_launch_counts()
        rows[tag] = mdw.kernel_level(np.random.default_rng(SEED), DEFORM_SIGMAS, modes,
                                     device=dev)
        launched = {k: n for k, n in dispatch.launch_counts.items() if n}
        # every row one launch in clamp mode and one in exact mode
        check(launched == {"ms_deform_sample": 2 * len(rows[tag])},
              f"deform_window {tag}: launched {launched}")
        for row in rows[tag]:
            emit({"phase": "deform_window", "geometry": tag, **row, "card": card})
            check(all(np.isfinite(row[k]) for k in ("mean_abs_err", "max_abs_err", "rel_l2")),
                  f"deform_window {tag}: an error is not finite: {row}")
    sigma1 = [r for r in rows["main_path"] if r["sigma_cells"] == 1.0]
    check(len(sigma1) == len(dw.ENC_SHAPES)
          and all(r["clamped"] == 0 and r["mismatched"] == 0 for r in sigma1),
          "deform_window: at sigma 1 a sample clamped or clamp and exact differ: "
          + str([(r["level"], r["clamped"], r["mismatched"]) for r in sigma1]))

    module = gd.GroundingDINO.create("swinb", seed=SEED, dtype=torch.bfloat16,
                                     device=dev).module
    dispatch.reset_launch_counts()
    full = mdw.full_model(np.random.default_rng(SEED), DEFORM_ALPHAS, module=module,
                          device=dev)
    launches = dict(dispatch.launch_counts)
    del module
    torch.cuda.empty_cache()
    cfg = gd.PRESETS["swinb"]
    forwards = 2 * len(DEFORM_ALPHAS)
    check(launches["ms_deform_sample"] == forwards * (cfg.enc_layers + cfg.dec_layers)
          and launches["flash_masked_wgmma"] == forwards * cfg.dec_layers
          and launches["flash_attention"] == 0,
          f"deform_window full model: launches {launches}")
    for row in full:
        emit({"phase": "deform_window", "geometry": "full_model",
              **{k: v for k, v in row.items() if k != "outputs"}, "card": card})
        check(all(np.isfinite(row[k]) for k in ("max_dbox", "max_dlogit", "memory_rel_l2")),
              f"deform_window full model: a delta is not finite at alpha {row['alpha']}")
    check(full[0]["alpha"] == 0.05 and full[0]["max_dbox"] <= 1e-3,
          f"deform_window: alpha 0.05 moved a box by {full[0]['max_dbox']}")
    # what exact sampling costs at the main path's batch: phase 2's K1 times
    clamp, exact = cases[("deform_clamp", "bfloat16", FRAME_BATCH)], \
        cases[("deform_exact", "bfloat16", FRAME_BATCH)]
    emit({"phase": "deform_window_cost", "batch": FRAME_BATCH, "dtype": "bfloat16",
          "clamp_ms": clamp["ms"], "exact_ms": exact["ms"],
          "clamp_device_ms": clamp["device_ms"], "exact_device_ms": exact["device_ms"],
          "launches": {k: v for k, v in launches.items() if v}, "card": card,
          "seconds": time.perf_counter() - t0})


# ------------------------------------------ phase 14: the float32 configuration
F32_SCENE = "scene_f32"  # one frame_batch of hit frames


def float32_phase(torch, mods, work, variants):
    """Both variants at ``detector.dtype: float32``, loaded by
    ``Segmentor2D(cfg)`` from phases 4's and 8's official-layout files (the
    classic Grounding-DINO Swin-B, CLIP ViT-L/14 and SAM ViT-H; the fast
    YOLO-World-L, EfficientSAM-S and CLIP), each on one frame_batch of 4
    hit frames of the 968x1296 synthetic scene: a warm-up on phase 4's
    2-frame scene, a timed pass (frames/s, launches), a profiled pass (busy
    share), and the same pass with ``fa.flash_attention`` and
    ``fa.flash_attention_relpos`` swapped for their plain versions (test
    code here, not a switch of the package). ``variants``: (name, config,
    passes), each pass (tag, environment) on the same loaded models; the
    classic variant runs once as it is and once under
    ``BFF_SAM_RELPOS_FLASH=1``. K2 in f32 must launch 6 times (6 decoder
    layers, one detect batch) and K3 12 times (12 global blocks, one encode
    batch), all on ``flash_attention_tf32``, ``flash_attention_f32`` 0; under
    the flag K4 in f32 4 times (4 global blocks, one encode batch), all on
    ``flash_attention_relpos_tf32``, ``flash_attention_relpos`` 0; each pass
    must equal its plain-attention pass: the same detections and labels,
    confidences within 1e-4, masks at IoU >= 0.999. Returns each pass's
    launch counts by tag."""
    seg2d, fa, dispatch, io, rle, StageProfiler = mods
    make_scene(os.path.join(work, "scenes"), F32_SCENE, FRAME_BATCH)
    out = {}
    for variant, base_cfg, passes in variants:
        cfg0 = base_cfg.override(**{"detector.dtype": "float32"})
        t0 = time.perf_counter()
        seg = seg2d.Segmentor2D(cfg0, frame_loader=synthetic_frame)
        load_s = time.perf_counter() - t0
        check(all(m.dtype == torch.float32 for m in (seg.detector, seg.sam, seg.clip)),
              f"{variant}: a model not in float32")
        for tag, env in passes:
            cfgs = {p: cfg0.override(**{
                "paths.mask_2d_dir": os.path.join(work, f"masks_f32_{tag}_{p}"),
                "paths.checkpoint_dir": os.path.join(work, f"ckpt_f32_{tag}_{p}")})
                for p in ("kernel", "plain")}
            rec, launches, plain_launches = with_env(env, lambda: float32_pass(
                torch, mods, seg, cfgs))
            relpos = env.get("BFF_SAM_RELPOS_FLASH") == "1"
            want = {"flash_attention_tf32": (6 if variant == "classic" else 12),
                    "flash_attention_f32": 0}
            if relpos:
                want.update({"flash_attention_relpos_tf32": 4, "flash_attention_relpos": 0,
                             "flash_attention_relpos_tf32_streamed": 0})
            rec.update({"phase": "float32_configuration", "variant": variant, "pass": tag,
                        "environment": env, "load_seconds": load_s, "launches_expected": want})
            emit(rec)
            for key, n_want in want.items():
                check(launches[key] == n_want, f"f32 {tag}: {key} launched {launches[key]} "
                                               f"times, not {n_want}")
            check(launches["flash_attention"] == 0 and launches["flash_attention_wgmma"] == 0
                  and launches["flash_masked_wgmma"] == 0
                  and launches["flash_attention_relpos_wgmma"] == 0,
                  f"f32 {tag}: a bf16 kernel ran")
            check(plain_launches["flash_attention_tf32"] == 0
                  and plain_launches["flash_attention_relpos_tf32"] == 0,
                  f"f32 {tag}: the plain pass launched an attention kernel")
            if variant == "classic":
                check(launches["ms_deform_sample"] > 0, f"f32 {tag}: K1 not launched")
            else:
                check(launches["nms_fixed"] > 0, f"f32 {tag}: the NMS kernel not launched")
            cmp = rec["vs_plain_attention"]
            check(cmp["masks"] > 0 and cmp["max_conf_diff"] <= 1e-4
                  and cmp["min_mask_iou"] >= 0.999,
                  f"f32 {tag}: kernel pass against plain attention: {cmp}")
            out[tag] = launches
        del seg
        torch.cuda.empty_cache()
    return out


def float32_pass(torch, mods, seg, cfgs):
    """One float32 pass of ``float32_phase`` on the loaded ``seg``: the
    warm-up, the timed pass (launch counts set to 0 just before it), the
    profiled pass and the plain-attention pass, compared. Returns (record,
    launches, the plain pass's launches)."""
    seg2d, fa, dispatch, io, rle, StageProfiler = mods
    t0 = time.perf_counter()
    seg2d.run(cfgs["kernel"], "clothes", scenes=["warmup"], segmentor=seg)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    # the timed pass, launch counts set to 0 just before it, then the same
    # pass under torch.profiler for the device's busy share
    prof = StageProfiler("segmentation_2d")
    dispatch.reset_launch_counts()
    seg2d.run(cfgs["kernel"], "clothes", scenes=[F32_SCENE], segmentor=seg, resume=False,
              profiler=prof)
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    profiled = StageProfiler("segmentation_2d")
    busy_us, _events, by_name = device_activity(torch, lambda: seg2d.run(
        cfgs["kernel"], "clothes", scenes=[F32_SCENE], segmentor=seg, resume=False,
        profiler=profiled))
    kernel_fns = fa.flash_attention, fa.flash_attention_relpos
    fa.flash_attention = fa.flash_attention_plain
    fa.flash_attention_relpos = fa.attend_relpos_plain
    try:
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        seg2d.run(cfgs["plain"], "clothes", scenes=[F32_SCENE], segmentor=seg)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_launches = dict(dispatch.launch_counts)
    finally:
        fa.flash_attention, fa.flash_attention_relpos = kernel_fns
    worst_conf, worst_iou, n = records_diff(io, rle, cfgs["kernel"], cfgs["plain"],
                                            ["clothes"], F32_SCENE)
    recs = check_records(torch, cfgs["kernel"], "clothes", F32_SCENE, FRAME_BATCH)
    rec = {"frames": FRAME_BATCH, "frames_per_sec": FRAME_BATCH / prof.durations["scene"],
           "device_busy_share": busy_us / 1e6 / profiled.durations["scene"],
           "warmup_seconds": warmup_s, "plain_attention_seconds": plain_s,
           "launches": launches, "stage_counts": dict(prof.counts),
           "port_kernels_ms": {name[:60]: [calls, us / 1e3]
                               for name, (calls, us) in by_name.items()
                               if any(k in name for k in PORT_KERNELS)},
           "plain_pass_launches": {k: v for k, v in plain_launches.items() if v},
           "vs_plain_attention": {"masks": n, "max_conf_diff": worst_conf,
                                  "min_mask_iou": worst_iou, "conf_tol": 1e-4, "iou_min": 0.999},
           "boxes": sum(len(r["confidences"]) for r in recs)}
    return rec, launches, plain_launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from beyondff_tpu_torch.config import Config
    from beyondff_tpu_torch.kernels import _build, dispatch
    from beyondff_tpu_torch.kernels import deform_window as dw
    from beyondff_tpu_torch.kernels import flash_attention as fa
    from beyondff_tpu_torch.kernels import mask_iou as kiou
    from beyondff_tpu_torch.kernels import nms
    from beyondff_tpu_torch.kernels import window_attention as wa
    from beyondff_tpu_torch.models import clip as clip_mod
    from beyondff_tpu_torch.models import efficientsam as esam
    from beyondff_tpu_torch.models import sam as sam_mod
    from beyondff_tpu_torch.models import yolo_world as yw
    from beyondff_tpu_torch.core import rle
    from beyondff_tpu_torch.models.gdino import deformable, model as gd
    from beyondff_tpu_torch.orchestration import sweep
    from beyondff_tpu_torch.pipeline import evaluate, projection, refinement
    from beyondff_tpu_torch.pipeline import segmentation_2d as seg2d
    from beyondff_tpu_torch.utils import io, mfu
    from beyondff_tpu_torch.utils.profiling import StageProfiler
    from beyondff_tpu_torch.core import geometry
    from beyondff_tpu_torch.data import readers
    from beyondff_tpu_torch.models import layers
    from beyondff_tpu_torch.parallel import lift as plift, mesh as mesh_lib
    from beyondff_tpu_torch.training import checkpoint as ckpt, sam_finetune, trainer
    from beyondff_tpu_torch.utils import native

    dev = torch.device("cuda")
    marks = []  # (phase, start on the host clock)
    # ---------------------------------------------------------------- 1
    marks.append((1, time.perf_counter()))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_lib = native.build()
    native.load_library()
    emit({"phase": "build", "seconds": build_s, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0), "card": card,
          "native_seconds": time.perf_counter() - t0, "native_library": native_lib})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 2
    marks.append((2, time.perf_counter()))
    rng = np.random.default_rng(SEED)
    enc_modes = deformable.level_modes(dw.ENC_SHAPES)
    dec_anchor = rng.uniform(0.0, 1.0, (900, 2)).astype(np.float32)
    cases = {}
    f32_one_frame_s = 0.0  # the f32 cases at one frame (PERF.md: the run's budget)
    # one frame, and the main path's batch of FRAME_BATCH frames
    for b in (1, FRAME_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
            t_case = time.perf_counter()
            dname = str(dtype).split(".")[-1]
            cases[("deform_clamp", dname, b)] = deform_case(
                torch, dw, "encoder_clamp", dw.raster_centers(dw.ENC_SHAPES), dtype,
                enc_modes, dev, rng, b)
            cases[("deform_exact", dname, b)] = deform_case(
                torch, dw, "encoder_exact", dw.raster_centers(dw.ENC_SHAPES), dtype,
                (None,) * 4, dev, rng, b)
            cases[("deform_dec", dname, b)] = deform_case(
                torch, dw, "decoder_exact", dec_anchor, dtype, (None,) * 4, dev,
                rng, b)
            cases[("flash_900", dname, b)] = flash_case(torch, fa, "decoder_self_attn",
                                                        (8 * b, 900, 32), 900, dtype, dev)
            cases[("flash_1024", dname, b)] = flash_case(torch, fa, "unmasked_1024",
                                                         (8 * b, 1024, 32), 1024, dtype, dev)
            # keys masked: valid_len < S, the last valid tile ragged
            cases[("flash_masked", dname, b)] = flash_case(torch, fa, "masked_1024_900",
                                                           (8 * b, 1024, 32), 900, dtype, dev)
            if b == 1 and dtype == torch.float32:
                f32_one_frame_s += time.perf_counter() - t_case
    # SAM ViT-H's global blocks (K4: 16 heads x B of the 64 x 64 grid) and
    # windowed blocks (K5: 25 windows of 14 x 14 x 16 heads x B), for one
    # frame and the main path's batch of FRAME_BATCH frames
    for b in (1, FRAME_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
            t_case = time.perf_counter()
            dname = str(dtype).split(".")[-1]
            cases[("relpos_global", dname, b)] = relpos_case(
                torch, fa, wa, sam_mod, "sam_global", 16 * b, (64, 64), dtype, dev)
            cases[("relpos_window", dname, b)] = relpos_case(
                torch, fa, wa, sam_mod, "window_sam", 400 * b, (14, 14), dtype, dev)
            if b == 1 and dtype == torch.float32:
                f32_one_frame_s += time.perf_counter() - t_case
    # K4 on the rect grid's 48 x 64 tokens at the main path's batch
    for dtype in (torch.bfloat16, torch.float32):
        cases[("relpos_global_rect", str(dtype).split(".")[-1], FRAME_BATCH)] = relpos_case(
            torch, fa, wa, sam_mod, "sam_global_rect", 16 * FRAME_BATCH, RECT_GRID, dtype, dev)
    # f32 K4 and K5 at head dim 80 on the 3xTF32 kernels, and K4 at SAM
    # ViT-L's head dim 64 too; K5 at head dim 64 and K4 on a 32-wide grid,
    # outside their predicate, on the FMA kernels
    for b in (1, FRAME_BATCH):
        for key, want in (("relpos_global", "flash_attention_relpos_tf32"),
                          ("relpos_window", "window_attention_relpos_tf32")):
            rec = cases[(key, "float32", b)]
            check(rec["kernel"] == want, f"f32 {key} at batch {b}: on {rec['kernel']}")
    check(cases[("relpos_global_rect", "float32", FRAME_BATCH)]["kernel"]
          == "flash_attention_relpos_tf32", "f32 rect K4 off the 3xTF32 kernel")
    cases[("relpos_global_d64", "float32", FRAME_BATCH)] = rec = relpos_case(
        torch, fa, wa, sam_mod, "sam_vit_l_global", 16 * FRAME_BATCH, (64, 64), torch.float32,
        dev, d=64)
    check(rec["kernel"] == "flash_attention_relpos_tf32",
          f"f32 K4 at head dim 64: went through {rec['kernel']}, not the 3xTF32 kernel")
    # K4 in f32 on grids narrower than 64 (portrait frames under
    # BFF_SAM_RECT=1: 64 x 32 for 2:1, 64 x 48 for 4:3) at head dims 64 and
    # 80 on the 3xTF32 kernel's narrow mode, each beside the FMA kernel on
    # the same inputs
    for kw in (32, 48):
        for d in (64, 80):
            cases[(f"relpos_narrow_kw{kw}_d{d}", "float32", FRAME_BATCH)] = rec = relpos_case(
                torch, fa, wa, sam_mod, f"portrait_kw{kw}_d{d}_global", 16 * FRAME_BATCH,
                (64, kw), torch.float32, dev, d=d, fma=True)
            check(rec["kernel"] == "flash_attention_relpos_tf32",
                  f"f32 K4 on 64 x {kw} at head dim {d}: on {rec['kernel']}")
    # K4 in f32 at head dim 96 on the 3xTF32 kernel: the narrow mode on the
    # 64 x 32 and 64 x 48 grids, the wide mode on 64 x 64 (its swizzled
    # bias_w table), each beside the FMA kernel on the same inputs, and on
    # peaked rows
    for key, name, grid, spread in (("relpos_d96_kw32", "kw32_d96_global", (64, 32), 1.0),
                                    ("relpos_d96_kw32_spread3", "kw32_d96_global_spread3",
                                     (64, 32), 3.0),
                                    ("relpos_d96_kw48", "kw48_d96_global", (64, 48), 1.0),
                                    ("relpos_d96", "d96_global", (64, 64), 1.0),
                                    ("relpos_d96_spread3", "d96_global_spread3", (64, 64), 3.0)):
        cases[(key, "float32", FRAME_BATCH)] = rec = relpos_case(
            torch, fa, wa, sam_mod, name, 16 * FRAME_BATCH, grid, torch.float32, dev, d=96,
            fma=spread == 1.0, spread=spread)
        check(rec["kernel"] == "flash_attention_relpos_tf32",
              f"f32 K4 {name} at head dim 96: on {rec['kernel']}")
    # K4 at head dim 80 on the 64 x 36 grid (kw not a multiple of 8) on the
    # 3xTF32 kernel's straddling mode, beside the FMA kernel on the same
    # inputs (and on a 64 x 3 grid, where an n8 group spans three grid
    # rows): each width is admitted only where it beats the FMA kernel
    for key, name, g, grid in (("relpos_straddle", "kw36_d80_global", 16 * FRAME_BATCH, (64, 36)),
                               ("relpos_straddle_kw3", "kw3_d80_global", 16, (64, 3))):
        cases[(key, "float32", FRAME_BATCH)] = rec = relpos_case(
            torch, fa, wa, sam_mod, name, g, grid, torch.float32, dev, fma=True)
        check(rec["kernel"] == "flash_attention_relpos_tf32",
              f"f32 K4 {name}: went through {rec['kernel']}, not the 3xTF32 kernel")
        check(rec["device_ms"] < rec["fma_device_ms"],
              f"f32 K4 {name}: the 3xTF32 kernel ({rec['device_ms']} ms) loses to the FMA "
              f"kernel ({rec['fma_device_ms']} ms)")
    # K4 in f32 on grids past 64 x 64 (no configured model calls them: SAM
    # past a 1024-pixel side), 16 heads: kh past 64 on the 3xTF32 kernel's
    # wide, narrow and straddling modes (flash_attention_relpos_tf32), kw
    # past 64 on its streamed mode (flash_attention_relpos_tf32_streamed;
    # past_limits has 2 x 255, 1 x 300, 136 x 136 and 17 x 17 windows), each
    # beside the FMA kernel it displaced, which it must beat, and at spread 3
    for key, name, grid, d in (("relpos_kh72", "kh72_kw36_d80_global", (72, 36), 80),
                               ("relpos_kh80", "kh80_kw64_d80_global", (80, 64), 80),
                               ("relpos_kh255", "kh255_kw2_d64_global", (255, 2), 64),
                               ("relpos_kh72_d96", "kh72_kw36_d96_global", (72, 36), 96),
                               ("relpos_kw128", "kh64_kw128_d80_global", (64, 128), 80),
                               ("relpos_kw72", "kh72_kw72_d80_global", (72, 72), 80),
                               ("relpos_kw72_d96", "kh72_kw72_d96_global", (72, 72), 96)):
        cases[(key, "float32", 1)] = rec = relpos_case(
            torch, fa, wa, sam_mod, name, 16, grid, torch.float32, dev, d=d, fma=True,
            spread3=True)
        want = ("flash_attention_relpos_tf32_streamed" if grid[1] > 64
                else "flash_attention_relpos_tf32")
        check(rec["kernel"] == want, f"f32 K4 {name}: on {rec['kernel']}, not {want}")
        check(rec["device_ms"] < rec["fma_device_ms"],
              f"f32 K4 {name}: the 3xTF32 kernel ({rec['device_ms']} ms) loses to the FMA "
              f"kernel ({rec['fma_device_ms']} ms)")
    # SAM ViT-H's global block in f32 on those grids: 80 x 64 (a 1280 x 1024
    # input) on the first route, 64 x 128 (1024 x 2048) on the second
    for grid, want in (((80, 64), "flash_attention_relpos_tf32"),
                       ((64, 128), "flash_attention_relpos_tf32_streamed")):
        sam_block_case(torch, (sam_mod, fa, dispatch), dev, grid, want)
    # K4 in f32 at head dims 32, 48, 112 and 128 (no configured model calls
    # them), 16 heads: the 3xTF32 kernel's new instances on 64 x 64 (the wide
    # mode) and at 128 on 64 x 128 (the streamed mode), each beside the FMA
    # kernel it displaced, which it must beat, and at spread 3
    for key, name, batch, grid, d in (("relpos_d128", "d128_global", FRAME_BATCH, (64, 64), 128),
                                      ("relpos_d112", "d112_global", 1, (64, 64), 112),
                                      ("relpos_d48", "d48_global", 1, (64, 64), 48),
                                      ("relpos_d32", "d32_global", 1, (64, 64), 32),
                                      ("relpos_kw128_d128", "kh64_kw128_d128_global", 1,
                                       (64, 128), 128)):
        cases[(key, "float32", batch)] = rec = relpos_case(
            torch, fa, wa, sam_mod, name, 16, grid, torch.float32, dev, d=d, fma=True,
            spread3=True)
        want = ("flash_attention_relpos_tf32_streamed" if grid[1] > 64
                else "flash_attention_relpos_tf32")
        check(rec["kernel"] == want, f"f32 K4 {name}: on {rec['kernel']}, not {want}")
        check(rec["device_ms"] < rec["fma_device_ms"],
              f"f32 K4 {name}: the 3xTF32 kernel ({rec['device_ms']} ms) loses to the FMA "
              f"kernel ({rec['fma_device_ms']} ms)")
    # outside every f32 route, on the FMA kernels: K4 at head dim 72 (the
    # 3xTF32 kernel takes the multiples of 16 from 32 to 128) and K5 at SAM
    # ViT-L's head dim 64
    for key, name, g, grid, d in (("relpos_global_fma", "d72_global", 4, (64, 64), 72),
                                  ("relpos_window_fma", "window_sam_vit_l", 400, (14, 14), 64)):
        cases[(key, "float32", FRAME_BATCH)] = rec = relpos_case(
            torch, fa, wa, sam_mod, name, g * FRAME_BATCH, grid, torch.float32, dev, d=d)
        check(rec["kernel"] in ("flash_attention_relpos", "window_attention_relpos"),
              f"f32 rel-pos {name}: went through {rec['kernel']}, not the FMA kernel")
    # the mma.sync tile of csrc/attention_tc.cuh keeps every bf16 call outside
    # bff_relpos_wgmma_takes: SAM ViT-L's global blocks (16 heads x B of the
    # 64 x 64 grid at head dim 64, K4 under BFF_SAM_RELPOS_FLASH=1) and its
    # 14 x 14 windows (K5's shape for ViT-L and ViT-B)
    for key, name, g, grid in (("relpos_global_tile", "sam_vit_l_global", 16, (64, 64)),
                               ("relpos_window_tile", "window_sam_vit_l", 400, (14, 14))):
        cases[(key, "bfloat16", FRAME_BATCH)] = rec = relpos_case(
            torch, fa, wa, sam_mod, name, g * FRAME_BATCH, grid, torch.bfloat16, dev, d=64)
        check(rec["kernel"] in ("flash_attention_relpos", "window_attention_relpos"),
              f"rel-pos {name}: went through {rec['kernel']}, not the mma.sync tile")
    for b in (1, FRAME_BATCH):
        for key in ("flash_900", "flash_1024", "flash_masked"):
            check(cases[(key, "bfloat16", b)]["kernel"] == "flash_masked_wgmma",
                  f"K2 {key} at batch {b} off its wgmma kernel")
    # the mma.sync tile of csrc/attention_tc.cuh keeps every bf16 call outside
    # both wgmma predicates: here head dim 64 with keys masked
    cases[("flash_tile", "bfloat16", FRAME_BATCH)] = rec = flash_case(
        torch, fa, "masked_d64_1024_900", (8 * FRAME_BATCH, 1024, 64), 900, torch.bfloat16, dev)
    check(rec["kernel"] == "flash_attention", "flash_tile: off the mma.sync tile")
    emit({"phase": "kernel_cases", "f32_one_frame_seconds": f32_one_frame_s})
    # the aggregation's self-IoU and refinement's stage-2 x stage-1 IoU, rows
    # on 16-byte boundaries as the main path allocates them (the wgmma
    # kernel), at 250 000 points and at a scene's arbitrary 250 007
    cases["iou_self"] = mask_iou_case(torch, kiou, "aggregation_self", 600, None, 250_000, dev)
    cases["iou_cross"] = mask_iou_case(torch, kiou, "refinement_cross", 20, 150, 250_000, dev)
    cases["iou_self_padded"] = mask_iou_case(torch, kiou, "aggregation_self_padded", 600, None,
                                             250_007, dev)
    cases["iou_cross_padded"] = mask_iou_case(torch, kiou, "refinement_cross_padded", 20, 150,
                                              250_007, dev)
    # the wgmma kernel's edges: one row, a partial cluster and tile, empty rows
    for key, ia, ib, n, empty in (("iou_one_row", 1, None, 1000, False),
                                  ("iou_65", 65, None, 4099, False),
                                  ("iou_65x7", 65, 7, 4099, False),
                                  ("iou_empty_rows", 40, None, 3001, True)):
        cases[key] = mask_iou_case(torch, kiou, key, ia, ib, n, dev, timed=False, empty=empty)
    # rows off 16-byte boundaries keep the mma.sync kernel and its cut path
    cases["iou_self_ragged"] = mask_iou_case(torch, kiou, "aggregation_self_ragged", 600, None,
                                             250_007, dev, padded=False)
    cases["iou_cross_ragged"] = mask_iou_case(torch, kiou, "refinement_cross_ragged", 20, 150,
                                              250_007, dev, padded=False)
    for key in ("iou_self", "iou_cross", "iou_self_padded", "iou_cross_padded", "iou_one_row",
                "iou_65", "iou_65x7", "iou_empty_rows"):
        check(cases[key]["kernel"] == "mask_iou_wgmma", f"{key} off the wgmma kernel")
    for key in ("iou_self_ragged", "iou_cross_ragged"):
        check(cases[key]["kernel"] == "mask_iou", f"{key} off the mma.sync kernel")
    # the fast variant: EfficientSAM-S's global blocks (K3: 6 heads x B of
    # the 64 x 64 grid, head dim 64, every key valid) for one frame and the
    # main path's batch, and YOLO-World-L's NMS over the batch
    for b in (1, FRAME_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
            cases[("k3_efficientsam", str(dtype).split(".")[-1], b)] = flash_case(
                torch, fa, "efficientsam_global", (6 * b, 4096, 64), 4096, dtype, dev)
    # the rect grid's 48 x 64 tokens at the main path's batch, and a ragged S
    # (the last key tile and the last query tile part-filled), bf16 and f32
    for s_k3 in (RECT_GRID[0] * RECT_GRID[1], 4095):
        for dtype in (torch.bfloat16, torch.float32):
            key = ("k3_efficientsam", s_k3) + (("float32",) if dtype == torch.float32 else ())
            cases[key] = flash_case(
                torch, fa, "efficientsam_global_rect" if s_k3 == 3072 else "ragged_4095",
                (6 * FRAME_BATCH, s_k3, 64), s_k3, dtype, dev)
    # f32 K2 and K3 on the 3xTF32 kernel (detector.dtype: float32), and f32
    # at head dims 128, 112, 96 and 80 too; an f32 call outside its
    # predicate (head dim 48) keeps the FMA kernel
    f32_flash = [(key, "float32", b) for key in ("flash_900", "flash_1024", "flash_masked",
                                                 "k3_efficientsam") for b in (1, FRAME_BATCH)]
    for key in f32_flash + [("k3_efficientsam", s_k3, "float32") for s_k3 in (3072, 4095)]:
        check(cases[key]["kernel"] == "flash_attention_tf32",
              f"f32 {key}: on {cases[key]['kernel']}")
    cases[("flash_d128", "float32", FRAME_BATCH)] = rec = flash_case(
        torch, fa, "d128_1024_900", (8 * FRAME_BATCH, 1024, 128), 900, torch.float32, dev)
    check(rec["kernel"] == "flash_attention_tf32", "flash_d128: off the 3xTF32 kernel")
    cases[("flash_d96", "float32", FRAME_BATCH)] = rec = flash_case(
        torch, fa, "d96_1024_900", (8 * FRAME_BATCH, 1024, 96), 900, torch.float32, dev,
        fma=True)
    check(rec["kernel"] == "flash_attention_tf32", "flash_d96: off the 3xTF32 kernel")
    for key, name, spread in (("flash_d80", "d80_1024_900", 1.0),
                              ("flash_d80_spread3", "d80_1024_900_spread3", 3.0)):
        cases[(key, "float32", FRAME_BATCH)] = rec = flash_case(
            torch, fa, name, (8 * FRAME_BATCH, 1024, 80), 900, torch.float32, dev,
            fma=spread == 1.0, spread=spread)
        check(rec["kernel"] == "flash_attention_tf32", f"{key}: off the 3xTF32 kernel")
    for key, name, spread in (("flash_d112", "d112_1024_900", 1.0),
                              ("flash_d112_spread3", "d112_1024_900_spread3", 3.0)):
        cases[(key, "float32", FRAME_BATCH)] = rec = flash_case(
            torch, fa, name, (8 * FRAME_BATCH, 1024, 112), 900, torch.float32, dev,
            fma=True, spread=spread)
        check(rec["kernel"] == "flash_attention_tf32", f"{key}: off the 3xTF32 kernel")
    cases[("flash_fma", "float32", FRAME_BATCH)] = rec = flash_case(
        torch, fa, "d48_1024_900", (8 * FRAME_BATCH, 1024, 48), 900, torch.float32, dev)
    check(rec["kernel"] == "flash_attention_f32", "flash_fma: off the f32-FMA kernel")
    past_limits(torch, (fa, wa, dw, sam_mod, deformable), cases, dev, rng)
    cases["nms"] = nms_case(torch, nms, dev)
    cases["nms_threshold"] = nms_threshold_case(torch, nms, dev)
    # frames past the staged kernel's 90 112 boxes, on its large mode
    for b_nms, a_nms in ((2, nms.MAX_ANCHORS + 1), (2, 393_216), (1, 1_048_576)):
        cases[("nms_large", a_nms)] = nms_case(torch, nms, dev, b_nms, a_nms,
                                               f"large_{b_nms}x{a_nms}")

    work = os.path.join(REPO, "chiprun_out", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # ---------------------------------------------------------------- 3
    marks.append((3, time.perf_counter()))
    small_reference(torch, (Config, seg2d, gd, sam_mod, clip_mod, io, rle), work)
    mods3d = (torch, dispatch, projection, refinement, evaluate)
    # the 3D scenes (~200 MB at full width) go to a temporary directory, not
    # to chiprun_out
    work3d = tempfile.mkdtemp(prefix="chip_smoke_3d_")
    small_reference_3d(torch, mods3d, Config, work3d, dev)
    small_sweep(torch, (Config, seg2d, gd, sam_mod, clip_mod, io, sweep, rle), Config, work3d,
                dev)
    small_reference_fast(torch, (Config, seg2d, yw, esam, clip_mod, nms, io, rle), work)

    # ---------------------------------------------------------------- 4
    marks.append((4, time.perf_counter()))
    t0 = time.perf_counter()
    det = gd.GroundingDINO.create("swinb", seed=SEED, dtype=torch.bfloat16, device=dev)
    clip = clip_mod.CLIP.create("ViT-L/14", seed=SEED + 1, dtype=torch.bfloat16, device=dev)
    sam = sam_mod.SAM.create("vit_h", seed=SEED + 2, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (det, clip, sam) for p in m.module.parameters())
    emit({"phase": "create_models", "seconds": time.perf_counter() - t0,
          "parameters": n_params})
    scenes = os.path.join(work, "scenes")
    make_scene(scenes, "warmup", 2)
    make_scene(scenes, "scene0000_00", N_FRAMES)
    # the models go through their official checkpoint files: from here on
    # every phase runs the loaded ones
    cfg, seg, ckpt_dir = load_from_checkpoints(torch, (seg2d, clip_mod), Config, work,
                                               (det, clip, sam))
    del det, clip, sam
    torch.cuda.empty_cache()
    det, clip, sam = seg.detector, seg.clip, seg.sam
    t0 = time.perf_counter()
    seg2d.run(cfg, "clothes", scenes=["warmup"], segmentor=seg)
    torch.cuda.synchronize()
    emit({"phase": "warmup", "frames": 2, "seconds": time.perf_counter() - t0})

    torch.cuda.reset_peak_memory_stats()
    prof = StageProfiler("segmentation_2d")
    dispatch.reset_launch_counts()
    results = seg2d.run(cfg, "clothes", scenes=["scene0000_00"], segmentor=seg, profiler=prof)
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    scene_s = prof.durations["scene"]
    emit({"phase": "seg2d_full_width", "frames": N_FRAMES, "frames_per_sec": N_FRAMES / scene_s,
          "scene_seconds": scene_s,
          "stage_ms": {k: v * 1e3 for k, v in prof.durations.items()},
          "stage_counts": dict(prof.counts), "launches": launches,
          "launches_per_frame": {k: v / N_FRAMES for k, v in launches.items()},
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "frames_with_boxes": results[0]["frames_with_boxes"]})
    check(launches["ms_deform_sample"] > 0, "ms_deform_sample was not launched on the main path")
    # K2: the decoder's self-attention, one launch a decoder layer a detect
    # batch, all on its wgmma kernel; none left on the mma.sync tile
    dec_layers = seg.detector.cfg.dec_layers
    check(launches["flash_masked_wgmma"] == dec_layers * prof.counts["detect"] > 0
          and launches["flash_attention"] == 0,
          f"K2: {launches['flash_masked_wgmma']} wgmma launches (and "
          f"{launches['flash_attention']} on the mma.sync tile) for "
          f"{prof.counts['detect']} detect batches of {dec_layers} decoder layers")
    check(launches["flash_attention_wgmma"] == 0, "the classic path launched K3")

    recs = check_records(torch, cfg, "clothes", "scene0000_00", N_FRAMES)
    emit({"phase": "output_check", "records": len(recs),
          "masks": sum(len(r["segmented_frame_masks"]) for r in recs)})

    # ---------------------------------------------------------------- 5
    marks.append((5, time.perf_counter()))
    profile_scene(torch, seg2d, seg, cfg, "scene0000_00", scene_s)

    # ---------------------------------------------------------------- 6
    marks.append((6, time.perf_counter()))
    sweep_launches = full_width_sweep(
        torch, (seg2d, sweep, projection, dispatch, io, rle, StageProfiler), Config, work3d, dev,
        (det, clip, sam, seg.clip_tokenizer))

    # ---------------------------------------------------------------- 7
    marks.append((7, time.perf_counter()))
    classic_seg = seg  # phase 12 runs it again
    del seg, det, clip, sam
    torch.cuda.empty_cache()
    # the 2D stage's launches, the sweep's rel-pos launches (K5 is wired into
    # no path: 0) and the 3D half's mask-IoU launches
    iou_launches, fixture3d = full_width_3d(torch, mods3d, Config, work3d, dev, cfg.detector)
    launches = {**launches, **iou_launches,
                **{key: sweep_launches[key] for key in (
                    "flash_attention_relpos", "flash_attention_relpos_wgmma",
                    "window_attention_relpos", "window_attention_relpos_wgmma")}}

    # ---------------------------------------------------------------- 8
    marks.append((8, time.perf_counter()))
    fast_launches, fast_seg, fast_cfg, fast_ckpt_dir = fast_variant(
        torch, (seg2d, yw, esam, dispatch, io, rle, StageProfiler), Config, work, dev,
        (cfg.detector.clip_checkpoint, cfg.detector.clip_bpe_path))
    launches = {**launches, "flash_attention_wgmma": fast_launches["flash_attention_wgmma"],
                "nms_fixed": fast_launches["nms_fixed"],
                "nms_fixed_large": fast_launches["nms_fixed_large"]}

    # ---------------------------------------------------------------- 9
    marks.append((9, time.perf_counter()))
    training_and_parallel(torch, (fa, dispatch, clip_mod, sam_mod, layers, trainer, sam_finetune,
                                  ckpt, mfu, mesh_lib, plift, geometry,
                                  (geometry, rle, io, readers)),
                          work3d, os.path.join(work3d, "full3d"), dev)

    # ---------------------------------------------------------------- 10
    marks.append((10, time.perf_counter()))
    transports(torch, (seg2d, projection, dispatch, io, rle, StageProfiler), Config, work,
               fixture3d, dev, fast_seg, fast_cfg, card)

    # ---------------------------------------------------------------- 11
    marks.append((11, time.perf_counter()))
    from beyondff_tpu_torch.core import resize as core_resize

    phase11(torch, (fa, sam_mod, esam, yw, nms, core_resize, gd, dispatch, seg2d,
                    projection, io, StageProfiler), Config, work, work3d, dev, fast_seg, fast_cfg,
            card, cfg.detector)

    # ---------------------------------------------------------------- 12
    marks.append((12, time.perf_counter()))
    phase12(torch, (dispatch, io), dev, classic_seg, cfg, fast_seg, fast_cfg)
    del fast_seg, classic_seg
    torch.cuda.empty_cache()
    shutil.rmtree(work3d)

    # ---------------------------------------------------------------- 13
    marks.append((13, time.perf_counter()))
    deform_window_phase(torch, (dw, deformable, gd, dispatch), dev, card, cases)

    # ---------------------------------------------------------------- 14
    marks.append((14, time.perf_counter()))
    f32_launches = float32_phase(
        torch, (seg2d, fa, dispatch, io, rle, StageProfiler), work,
        (("classic", cfg, (("classic", {}),
                           ("classic_relpos_flash", {"BFF_SAM_RELPOS_FLASH": "1"}))),
         ("fast", fast_cfg, (("fast", {}),))))
    shutil.rmtree(ckpt_dir)
    shutil.rmtree(fast_ckpt_dir)

    table = []
    bf16_b = ("bfloat16", FRAME_BATCH)
    for key, src, replaces in (
            (("deform_clamp", *bf16_b), "beyondff_tpu_torch/csrc/ms_deform_sample.cu",
             "beyondff_tpu/kernels/deform_window.py:170"),
            (("flash_900", *bf16_b), "beyondff_tpu_torch/csrc/flash_masked_wgmma.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            # bf16 calls outside both wgmma predicates keep the mma.sync tile
            (("flash_tile", *bf16_b), "beyondff_tpu_torch/csrc/flash_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            # K4 and K5 in bf16 at head dim 80 take the wgmma kernels; other
            # bf16 shapes keep the mma.sync tile of relpos_attention.cu
            (("relpos_global_tile", *bf16_b), "beyondff_tpu_torch/csrc/relpos_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            (("relpos_window_tile", *bf16_b), "beyondff_tpu_torch/csrc/relpos_attention.cu",
             "beyondff_tpu/kernels/window_attention.py:51"),
            (("relpos_global", *bf16_b), "beyondff_tpu_torch/csrc/relpos_attention_wgmma.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            (("relpos_window", *bf16_b), "beyondff_tpu_torch/csrc/relpos_attention_wgmma.cu",
             "beyondff_tpu/kernels/window_attention.py:51"),
            # rows on 16-byte boundaries (the main path's) on the wgmma
            # kernel, other rows on the mma.sync kernel
            ("iou_self_padded", "beyondff_tpu_torch/csrc/mask_iou_wgmma.cu",
             "beyondff_tpu/kernels/mask_iou.py:55"),
            ("iou_self_ragged", "beyondff_tpu_torch/csrc/mask_iou.cu",
             "beyondff_tpu/kernels/mask_iou.py:55"),
            (("k3_efficientsam", *bf16_b), "beyondff_tpu_torch/csrc/flash_attention_wgmma.cu",
             "beyondff_tpu/kernels/flash_attention.py:68"),
            ("nms", "beyondff_tpu_torch/csrc/nms_fixed.cu",
             "beyondff_tpu/models/yolo_world.py:313"),
            # frames above 90 112 boxes: the large mode (no configured
            # detector reaches it: 0 launches on the path)
            (("nms_large", 1_048_576), "beyondff_tpu_torch/csrc/nms_fixed.cu",
             "beyondff_tpu/models/yolo_world.py:313"),
            # detector.dtype float32 (phase 14): K2 and K3 on the 3xTF32
            # kernel, the other f32 calls on the FMA kernels
            (("flash_900", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/flash_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            (("k3_efficientsam", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/flash_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:68"),
            (("flash_d128", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/flash_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            (("flash_d96", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/flash_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            (("flash_d80", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/flash_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            (("flash_d112", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/flash_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            (("flash_fma", "float32", FRAME_BATCH), "beyondff_tpu_torch/csrc/flash_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            # K4 and K5 in f32 at head dim 80 (and K4 at 64 and 96) on the
            # 3xTF32 kernels, other f32 rel-pos calls (K4 on a 36-wide grid,
            # K5 at head dim 64) on the FMA kernels
            (("relpos_global", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            (("relpos_global_d64", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            *((("relpos_narrow_kw%d_d%d" % (kw, d), "float32", FRAME_BATCH),
               "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
               "beyondff_tpu/kernels/flash_attention.py:193")
              for kw in (32, 48) for d in (64, 80)),
            *(((key, "float32", FRAME_BATCH), "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
               "beyondff_tpu/kernels/flash_attention.py:193")
              for key in ("relpos_d96_kw32", "relpos_d96_kw48", "relpos_d96")),
            (("relpos_window", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
             "beyondff_tpu/kernels/window_attention.py:51"),
            (("relpos_straddle", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            # K4 f32 on grids past 64 x 64: kh past 64 on the 3xTF32
            # kernel's modes, kw past 64 on its streamed mode (no configured
            # model reaches them: 0 launches on the path)
            (("relpos_kh72", "float32", 1), "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            (("relpos_kw128", "float32", 1), "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            # K4 f32 at head dims 32, 48, 112 and 128 on the 3xTF32 kernel
            # (no configured model reaches them)
            (("relpos_d128", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            *(((key, "float32", 1), "beyondff_tpu_torch/csrc/relpos_attention_tf32.cu",
               "beyondff_tpu/kernels/flash_attention.py:193")
              for key in ("relpos_d112", "relpos_d48", "relpos_d32", "relpos_kw128_d128")),
            (("relpos_global_fma", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/relpos_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            (("relpos_window_fma", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/relpos_attention.cu",
             "beyondff_tpu/kernels/window_attention.py:51"),
            (("deform_clamp", "float32", FRAME_BATCH),
             "beyondff_tpu_torch/csrc/ms_deform_sample.cu",
             "beyondff_tpu/kernels/deform_window.py:170"),
            # the shapes past the old limits (past_limits; no configured
            # model reaches them): head dims past 128 on the wide kernels
            # (144-256: wgmma in bf16, 3xTF32 in f32), the slices of the
            # tile (bf16 264) and of the FMA kernel (f32 168); kh + kw past
            # 256 on the tile with
            # streamed factors (bf16 up to head dim 128) and the FMA kernel
            # (f32); K4 at head dims 160 and 256 on the wide kernels (both
            # dtypes on any grid), at 168 on the slices they leave; 17 x 17
            # windows on K4's kernels, K1 at 9 levels and head dim 160
            *(((f"flash_d{d}_{tag}", dname, 1),
               "beyondff_tpu_torch/csrc/" + ("flash_attention_wide_wgmma.cu"
                                             if dname == "bfloat16"
                                             else "relpos_attention_wide_tf32.cu"),
               "beyondff_tpu/kernels/flash_attention.py:" + ("270" if tag == "masked" else "68"))
              for d in (160, 256) for tag in ("unmasked", "masked")
              for dname in ("bfloat16", "float32")),
            (("flash_d256_4096", "bfloat16", 1),
             "beyondff_tpu_torch/csrc/flash_attention_wide_wgmma.cu",
             "beyondff_tpu/kernels/flash_attention.py:68"),
            (("flash_d264_tile", "bfloat16", 1), "beyondff_tpu_torch/csrc/flash_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            (("flash_d168_fma", "float32", 1), "beyondff_tpu_torch/csrc/flash_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            *(((key, dname, 1), "beyondff_tpu_torch/csrc/" + (
                ("relpos_attention_streamed.cu" if dname == "bfloat16"
                 else "relpos_attention_tf32.cu")
                if key in ("relpos_kh_kw_300", "relpos_kh_kw_257", "relpos_136")
                else ("relpos_attention_wide_wgmma.cu" if dname == "bfloat16"
                      else "relpos_attention_wide_tf32.cu")
                if key in ("relpos_d160", "relpos_d256", "relpos_past_table_d160")
                else "relpos_attention_tf32.cu"
                if key == "relpos_window_17" and dname == "float32"
                else "relpos_attention.cu"),
               "beyondff_tpu/kernels/" + ("window_attention.py:51" if key == "relpos_window_17"
                                          else "flash_attention.py:193"))
              for key, dnames in (("relpos_d160", ("bfloat16", "float32")),
                                  ("relpos_d256", ("bfloat16", "float32")),
                                  ("relpos_kh_kw_300", ("bfloat16", "float32")),
                                  ("relpos_kh_kw_257", ("bfloat16", "float32")),
                                  ("relpos_window_17", ("bfloat16", "float32")),
                                  ("relpos_136", ("bfloat16", "float32")),
                                  ("relpos_past_table_d160", ("bfloat16", "float32")),
                                  ("relpos_d168", ("bfloat16", "float32")),
                                  ("relpos_past_table_d168", ("bfloat16",)))
              for dname in dnames),
            *(((f"{key}_{mode}", dname, 1), "beyondff_tpu_torch/csrc/ms_deform_sample.cu",
               "beyondff_tpu/kernels/deform_window.py:170")
              for key in ("deform_9_levels", "deform_d160") for mode in ("clamp", "exact")
              for dname in ("bfloat16", "float32"))):
        c = cases[key]
        # K3's row counts the fast variant's launches (EfficientSAM's global
        # blocks), K2's the classic path's, K4's the sweep's; an f32 row the
        # float32 configuration's (phase 14: classic, fast for K3, the
        # classic pass under BFF_SAM_RELPOS_FLASH=1 for K4 and K5)
        name = c["kernel"]
        if isinstance(key, tuple) and key[0] == "nms_large":
            n_launches = launches.get(name, 0)
        elif isinstance(key, tuple) and "float32" in key:
            n_launches = f32_launches["fast" if key[0] == "k3_efficientsam" else
                                      "classic_relpos_flash" if key[0].startswith("relpos")
                                      else "classic"][name]
        else:
            n_launches = launches[name]
        table.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                      "launches": n_launches, "max_abs_err": c["max_abs_err"],
                      "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                      # device time per launch (and of the library call), rates,
                      # and for f32 attention the f32-FMA bound beside bound_ms
                      **{key: c.get(key) for key in ("device_ms", "library_device_ms",
                                                     "tflops", "tops", "gbps", "dense_path_ms",
                                                     "dense_path_device_ms", "host_us",
                                                     "sort_ms", "gather_ms", "scan_ms",
                                                     "bound_fma_ms", "share_of_bound",
                                                     "fma_ms", "fma_device_ms", "entry_us",
                                                     "dtype", "shape", "grid", "valid_len",
                                                     "levels", "head_dim", "design")
                         if key in c}})
    shutil.rmtree(work)
    marks.append((None, time.perf_counter()))
    emit({"phase": "phase_seconds", "seconds": {
        str(n): t1 - t0 for (n, t0), (_, t1) in zip(marks, marks[1:])},
        "total": marks[-1][1] - marks[0][1]})
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(_LINES + [{"kernels": table}], f, indent=1)
    print(card, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
