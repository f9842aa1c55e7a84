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
   968x1296 scene, with launch counts reset just before it; reload and
   check the written ``.pth``;
5. run the scene once more under ``torch.profiler`` for the device's busy
   share and the kernels that take its time;
6. drive the class sweep at full width with the phase-4 (loaded) models:
   ``SweepRunner.run(amortize_segmentation=True)`` over three classes of a
   ray-cast scene (50 000 points, 16 frames at 968x1296, 640x480 depth),
   fused captions, ``BFF_SAM_RELPOS_FLASH=1``, after three timed 2D passes
   (per-class ``run()``, ``run_classes`` unfused and fused, whose banked
   records must equal the per-class ones); launch counts are set to 0 just
   before the sweep and read after it; then the ``sam_encode`` span with
   the rel-pos flash kernel off, on, on, off;
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
   must run 12 times per SAM encode batch and the NMS kernel once per
   detection batch; then a profiled pass and banked ``run_classes`` over
   three classes against per-class ``run()``;
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
   300-frame fixture, equal to ``core.geometry``'s.

Phase 2 also holds the mask-IoU kernel bit for bit against its plain version
at the aggregation's (600, 250 000) self-IoU and refinement's (20 x 150,
250 000) cross IoU, and at 250 007 points (rows off 16-byte boundaries), and
the rel-pos attention kernels at SAM ViT-H's global (16 B, 4096, 80) and
windowed (400 B, 196, 80) shapes, K3 at EfficientSAM-S's global blocks
(6 B, 4096, 64) in bf16, and the NMS kernel index for index at YOLO-World-L's
8 400 anchors for a batch of 4 (top_k 100). Tolerances: f32 within 1e-4; bf16 K2/K3,
K4 and K5, whose tensor-core tile rounds P to bf16 before P V as the TPU
kernels do, within 2^-8 |P|@|V| + 2^-7 |plain| + 1e-4
(``flash_attention.bf16_error_bound``; K2 also within 1.6e-2); K1 within
3e-2. Phase 3 also runs the 3D half
on a small scene on the card and on the CPU and requires equal outputs and
an equal AP row, the class sweep at the "test" presets on both, with
equal 3D outputs and results rows, and the fast variant at the "test"
presets on both (f32, cuDNN TF32 off) with two-tier uploads on auto and
forced on: confidences within 1e-4, masks at IoU >= 0.99.

The last three lines are the card's name and power limit, the kernel table
and ``{"ok": true, "device": ...}``;
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
FMA_DESIGN = "f32 FMA from shared memory"


def deform_case(torch, dw, name, q_locs, dtype, modes, dev, rng, b):
    """One ms_deform_sample comparison + timing at the encoder's levels;
    q_locs (Q, 2) query anchors, ``b`` frames in the batch (inputs from
    ``dw.sample_inputs``: offsets within 12 cells, every 17th query shifted
    off the map)."""
    from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS, device_ms

    shapes = dw.ENC_SHAPES
    value, tl, ta = dw.sample_inputs(rng, q_locs, b, dtype, dev)
    q, heads, lv, p = ta.shape[1:]
    hd = value.shape[-1]
    got = dw.ms_deform_sample(value, shapes, tl, ta, modes)
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
                  "f32 FMAs, all levels in one launch",
    }
    emit(rec)
    check(err <= tol, f"ms_deform_sample {name} {dname}: max abs err {err} > {tol}")
    return rec


def flash_case(torch, fa, name, shape, valid_len, dtype, dev):
    """One K2/K3 comparison + timing. bf16 is held within 1.6e-2 and within
    ``fa.bf16_error_bound`` (P rounded to bf16 before P V, as the TPU kernel
    does, plus one output rounding); f32 within 1e-4."""
    import torch.nn.functional as F

    from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS, device_ms

    bh, s, d = shape
    q, k, v = (torch.randn(bh, s, d, device=dev, dtype=torch.float32).to(dtype)
               for _ in range(3))
    got = fa.flash_attention(q, k, v, valid_len=valid_len)
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
    library = lambda: F.scaled_dot_product_attention(q4, k4, v4)
    dev_ms = device_ms(kernel)
    rec = {
        "case": name, "kernel": "flash_attention", "dtype": dname, "shape": list(shape),
        "valid_len": valid_len, "max_abs_err": err, "tol": tol, "tol_excess": excess,
        "bound_tol": "2^-8 |P|@|V| + 2^-7 |plain| + 1e-4" if bf16 else None,
        "ms": cuda_ms(torch, kernel, 50),
        "device_ms": dev_ms, "tflops": flops / dev_ms / 1e9,
        "design": TC_DESIGN + ", 4 warps x 16 rows" if bf16 else FMA_DESIGN,
        "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, valid_len), 20),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": cuda_ms(torch, library, 50),
        "library_device_ms": device_ms(library),
    }
    emit(rec)
    check(err <= tol and excess <= 0.0,
          f"flash_attention {name} {dname}: max abs err {err} beyond tolerance")
    return rec


def relpos_case(torch, fa, wa, sam_mod, name, g, grid, dtype, dev):
    """One rel-pos attention comparison + timing: K4 (``flash_attention_relpos``)
    over a global grid, K5 (``window_attention_relpos``) when ``name`` is a
    window case. q, k, v from a seeded generator; the factors are real q . R
    products (``sam._rel_pos_factors``) of rel-pos tables at 0.1 scale, so
    the bias moves the softmax as a trained table does."""
    import torch.nn.functional as F

    from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS, device_ms

    hh, ww = grid
    s, d = hh * ww, 80
    window = name.startswith("window")
    gen = torch.Generator(device=dev).manual_seed(SEED + g + s)
    q, k, v = (torch.randn(g, s, d, device=dev, generator=gen).to(dtype) for _ in range(3))
    rel_h = (0.1 * torch.randn(2 * hh - 1, d, device=dev, generator=gen)).to(dtype)
    rel_w = (0.1 * torch.randn(2 * ww - 1, d, device=dev, generator=gen)).to(dtype)
    bias_h, bias_w = sam_mod._rel_pos_factors((hh, ww), (hh, ww), rel_h, rel_w, q)
    if window:
        kernel = lambda: wa.window_attention_relpos(q, k, v, bias_h, bias_w, hh, ww)
        plain = lambda: wa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, hh, ww)
    else:
        kernel = lambda: fa.attend_relpos(q, k, v, bias_h, bias_w, ww)
        plain = lambda: fa.attend_relpos_plain(q, k, v, bias_h, bias_w, ww)
    got, want = kernel(), plain()
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
    extra = {"design": FMA_DESIGN + (", whole-window softmax" if window else "")}
    if bf16:
        # device time per launch of the kernel and of its yardstick
        dev_ms = device_ms(kernel)
        extra = {"device_ms": dev_ms, "tflops": flops / dev_ms / 1e9,
                 "library_device_ms": device_ms(library),
                 "design": TC_DESIGN + ", 4 warps x 32 rows, " + (
                     "bias_h as a row shift" if ww % 64 == 0 else
                     "key coordinates once per tile, the last tile's k16 steps only")
                     + (", persistent blocks loading the next window ahead" if window else "")}
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
    rec = {"case": name, "kernel": "window_attention_relpos" if window
           else "flash_attention_relpos", "dtype": dname, "shape": [g, s, d],
           "grid": [hh, ww], "max_abs_err": err, "tol_excess": excess, "tol": tol,
           "ms": cuda_ms(torch, kernel, 5 if s > 1024 else 20), **extra,
           "plain_ms": cuda_ms(torch, plain, 3),
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "library_ms": library_ms,
           "library_call": "scaled_dot_product_attention with the bias as a float mask"}
    emit(rec)
    torch.cuda.empty_cache()
    check(excess <= 0.0, f"{rec['kernel']} {name} {dname}: max abs err {err} beyond tolerance")
    return rec


def synthetic_frame(path, size):
    """Deterministic 'photo' for a frame file: smooth shading, a few flat
    boxes and sensor noise, from the seed and the frame number (the frame
    files themselves are empty markers: no image codec is needed)."""
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
    base += rng.integers(-12, 13, base.shape, dtype=np.int16)
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
                "nms_fixed_kernel")


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
    device; per stage: host seconds and mask-IoU launches (counts set to 0
    just before each stage, read just after)."""
    torch, dispatch, projection, refinement, evaluate = mods
    out = {"seconds": {}, "mask_iou_launches": {}}
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
        out["mask_iou_launches"][name] = dispatch.launch_counts["mask_iou"]
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


def mask_iou_case(torch, kiou, name, ia, ib, n, dev):
    """One mask-IoU comparison and timing at the main path's shapes; ``ib``
    None is a self-IoU. A share of rows is empty (nan against empty rows)."""
    from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_INT8_OPS, device_ms

    g = torch.Generator(device=dev).manual_seed(SEED)
    dens = torch.rand(ia, 1, device=dev, generator=g) * 0.3
    dens[::17] = 0.0
    a = torch.rand(ia, n, device=dev, generator=g) < dens
    b = None
    if ib is not None:
        dens_b = torch.rand(ib, 1, device=dev, generator=g) * 0.3
        dens_b[::13] = 0.0
        b = torch.rand(ib, n, device=dev, generator=g) < dens_b
    got = kiou.pairwise_iou(a, b)
    want = kiou.pairwise_iou_plain(a, b)
    torch.cuda.synchronize()
    nan_eq = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    fin = ~torch.isnan(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    bits_eq = bool(torch.equal(got[fin].view(torch.int32), want[fin].view(torch.int32)))
    ib_n = ia if ib is None else ib
    # intersections only, as torch._int_mm takes them: int8 copies made
    # outside the timing, rows and points padded with zeros to its multiples
    # of 8
    a8 = torch.nn.functional.pad(a.to(torch.int8), (0, -n % 8))
    b8 = a8 if b is None else torch.nn.functional.pad(b.to(torch.int8), (0, -n % 8, 0, -ib_n % 8))
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
    rec = {"case": name, "kernel": "mask_iou", "shape": [ia, ib_n, n], "self": b is None,
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
           "design": "int8 mma.sync m16n8k32 -> s32 on the bool bytes, 128 x 128 tiles "
                     "(self: upper triangle, areas from the diagonal), split N, "
                     + ("cp.async 3-stage ring" if n % 16 == 0 else
                        "aligned 16-byte loads into registers, cut there into a 2-stage ring")
                     + ", int32 atomics"}
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
          "mask_iou_launches": launches, "max_memory_allocated_bytes": peak,
          "instances": {"projection": int(outs[0]["ins"].shape[0]),
                        "refinement": int(outs[1]["ins"].shape[0])},
          "ap_row": {k: ap[k] for k in ("ap", "ap50%", "ap25%", "rc", "rc50%", "rc25%")}})
    emit({"phase": "device_profile_projection", "projection_seconds_profiled": span["s"],
          "device_busy_ms": busy_us / 1e3, "device_busy_share": busy_us / 1e6 / span["s"],
          "device_events": events,
          "top_device_ms": [[name[:120], n, us / 1e3] for name, (n, us) in top]})
    return launches["projection"] + launches["refinement"]


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
            check(p["launches"]["flash_attention_relpos"] > 0,
                  f"{name}: the rel-pos flash kernel was not launched")
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
        for name in ("flash_attention_relpos", "ms_deform_sample", "flash_attention",
                     "mask_iou"):
            check(launches[name] > 0, f"{name} was not launched in the sweep")
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

        # the SAM encode with the rel-pos flash kernel off and on, in turns
        cfg = cfgs["run_per_class"]
        seg = segmentor(cfg)
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
            ab.append({"BFF_SAM_RELPOS_FLASH": flag, "sam_encode_s": prof.durations["sam_encode"],
                       "frames": prof.items["sam_encode.frames"],
                       "relpos_launches": dispatch.launch_counts["flash_attention_relpos"]})
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
IOU_OPS = 16  # f32 operations of one IoU test (4 min/max, 2 clamps, 2 products, 8 +-/)


def iou_tests(torch, keep, valid, scores):
    """The IoU tests the greedy scan makes for these results: each kept box
    against every box after it in score order (what this run's data needs,
    for the bound)."""
    order = torch.sort(scores.neg(), dim=-1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    pos = torch.gather(rank, 1, keep.long())
    return int(((scores.shape[1] - 1 - pos) * valid).sum())


def nms_case(torch, nms, dev):
    """The NMS kernel against its plain version, index for index, at the
    main path's batch: 4 frames of 8 400 clustered boxes (as the detector's
    output), top_k 100, IoU 0.5. The bound counts the IoU tests this data
    needs (each kept box against every box after it) at the f32 peak, and
    the boxes and scores read once."""
    from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS, device_ms

    gen = torch.Generator(device=dev).manual_seed(SEED)
    b, a = FRAME_BATCH, NMS_ANCHORS
    centers = torch.rand(b, 60, 2, generator=gen, device=dev) * 640
    pick = torch.randint(0, 60, (b, a), generator=gen, device=dev)
    c = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    c = c + torch.randn(b, a, 2, generator=gen, device=dev) * 10
    half = torch.rand(b, a, 2, generator=gen, device=dev) * 60 + 8
    boxes = torch.cat([c - half, c + half], -1)
    scores = torch.rand(b, a, generator=gen, device=dev)
    keep, valid = nms.nms_fixed(boxes, scores, 0.5, NMS_TOP_K)
    want_keep, want_valid = nms.nms_fixed_plain(boxes, scores, 0.5, NMS_TOP_K)
    torch.cuda.synchronize()
    err = float((keep.long() - want_keep.long()).abs().max())
    equal = bool(torch.equal(keep, want_keep) and torch.equal(valid, want_valid))
    n_iou = iou_tests(torch, keep, valid, scores)
    nbytes = b * a * (16 + 4) + b * NMS_TOP_K * (4 + 1)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = IOU_OPS * n_iou / PEAK_FLOPS["float32"] * 1e3
    kernel = lambda: nms.nms_fixed(boxes, scores, 0.5, NMS_TOP_K)
    rec = {"case": "yolo_world_l_batch", "kernel": "nms_fixed", "shape": [b, a],
           "top_k": NMS_TOP_K, "kept": int(valid.sum()), "iou_evaluations": n_iou,
           "max_abs_err": err, "index_equal": equal, "tol": "indices equal",
           "ms": cuda_ms(torch, kernel, 50), "device_ms": device_ms(kernel),
           "plain_ms": cuda_ms(torch, lambda: nms.nms_fixed_plain(boxes, scores, 0.5,
                                                                   NMS_TOP_K), 3),
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "library_ms": None,
           "design": "a block per frame, the suppression bitmask in shared memory, the next "
                     "survivor found a word at a time, warp ballots over 32 later boxes, "
                     "stops at top_k; ms includes the wrapper's stable sort and gather"}
    emit(rec)
    check(equal, f"nms_fixed kernel disagrees with its plain version: {rec}")
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
    against per-class ``run()``. Returns the run's launch counts."""
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
              "flash_attention_per_encode_batch": launches["flash_attention"] / max(encodes, 1),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "frames_with_boxes": results[0]["frames_with_boxes"]})
        blocks = len(seg.sam.cfg.global_attn_indexes)  # 12: every block is global
        check(encodes > 0 and launches["flash_attention"] == blocks * encodes,
              f"K3: {launches['flash_attention']} launches for {encodes} encode batches")
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
        del seg
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    before = dispatch.launch_counts["flash_attention"]
    raised = None
    try:
        fa.attend(q, q, q)
    except RuntimeError as e:
        raised = str(e)
    check(raised is not None and "no backward" in raised,
          "attend on inputs that require grad did not raise")
    check(dispatch.launch_counts["flash_attention"] == before, "the refused call launched")
    with torch.no_grad():
        fa.attend(q, q, q)
    torch.cuda.synchronize()
    check(dispatch.launch_counts["flash_attention"] == before + 1, "attend under no_grad")
    dispatch.launch_counts["flash_attention"] = before  # a check, not a path launch
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

    dev = torch.device("cuda")
    # ---------------------------------------------------------------- 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0), "card": card})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 2
    rng = np.random.default_rng(SEED)
    enc_modes = deformable.level_modes(dw.ENC_SHAPES)
    dec_anchor = rng.uniform(0.0, 1.0, (900, 2)).astype(np.float32)
    cases = {}
    # one frame, and the main path's batch of FRAME_BATCH frames
    for b in (1, FRAME_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
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
    # SAM ViT-H's global blocks (K4: 16 heads x B of the 64 x 64 grid) and
    # windowed blocks (K5: 25 windows of 14 x 14 x 16 heads x B), for one
    # frame and the main path's batch of FRAME_BATCH frames
    for b in (1, FRAME_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            cases[("relpos_global", dname, b)] = relpos_case(
                torch, fa, wa, sam_mod, "sam_global", 16 * b, (64, 64), dtype, dev)
            cases[("relpos_window", dname, b)] = relpos_case(
                torch, fa, wa, sam_mod, "window_sam", 400 * b, (14, 14), dtype, dev)
    # the aggregation's self-IoU and refinement's stage-2 x stage-1 IoU
    cases["iou_self"] = mask_iou_case(torch, kiou, "aggregation_self", 600, None, 250_000, dev)
    cases["iou_cross"] = mask_iou_case(torch, kiou, "refinement_cross", 20, 150, 250_000, dev)
    # a scene's point count is arbitrary: rows that start off 16-byte boundaries
    cases["iou_self_ragged"] = mask_iou_case(torch, kiou, "aggregation_self_ragged", 600, None,
                                             250_007, dev)
    cases["iou_cross_ragged"] = mask_iou_case(torch, kiou, "refinement_cross_ragged", 20, 150,
                                              250_007, dev)
    # the fast variant: EfficientSAM-S's global blocks (K3: 6 heads x B of
    # the 64 x 64 grid, head dim 64, every key valid) for one frame and the
    # main path's batch, and YOLO-World-L's NMS over the batch
    for b in (1, FRAME_BATCH):
        cases[("k3_efficientsam", "bfloat16", b)] = flash_case(
            torch, fa, "efficientsam_global", (6 * b, 4096, 64), 4096, torch.bfloat16, dev)
    cases["nms"] = nms_case(torch, nms, dev)

    work = os.path.join(REPO, "chiprun_out", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # ---------------------------------------------------------------- 3
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
    for name in ("ms_deform_sample", "flash_attention"):
        check(launches[name] > 0, f"{name} was not launched on the main path")

    recs = check_records(torch, cfg, "clothes", "scene0000_00", N_FRAMES)
    emit({"phase": "output_check", "records": len(recs),
          "masks": sum(len(r["segmented_frame_masks"]) for r in recs)})

    # ---------------------------------------------------------------- 5
    profile_scene(torch, seg2d, seg, cfg, "scene0000_00", scene_s)

    # ---------------------------------------------------------------- 6
    sweep_launches = full_width_sweep(
        torch, (seg2d, sweep, projection, dispatch, io, rle, StageProfiler), Config, work3d, dev,
        (det, clip, sam, seg.clip_tokenizer))

    # ---------------------------------------------------------------- 7
    del seg, det, clip, sam
    torch.cuda.empty_cache()
    # the 2D stage's launches, the sweep's rel-pos launches (K5 is wired into
    # no path: 0) and the 3D half's mask-IoU launches
    launches = {**launches,
                "mask_iou": full_width_3d(torch, mods3d, Config, work3d, dev, cfg.detector),
                "flash_attention_relpos": sweep_launches["flash_attention_relpos"],
                "window_attention_relpos": sweep_launches["window_attention_relpos"]}

    # ---------------------------------------------------------------- 8
    fast_launches = fast_variant(
        torch, (seg2d, yw, esam, dispatch, io, rle, StageProfiler), Config, work, dev,
        (cfg.detector.clip_checkpoint, cfg.detector.clip_bpe_path))
    shutil.rmtree(ckpt_dir)
    launches = {**launches, "flash_attention_unmasked": fast_launches["flash_attention"],
                "nms_fixed": fast_launches["nms_fixed"]}

    # ---------------------------------------------------------------- 9
    training_and_parallel(torch, (fa, dispatch, clip_mod, sam_mod, layers, trainer, sam_finetune,
                                  ckpt, mfu, mesh_lib, plift, geometry,
                                  (geometry, rle, io, readers)),
                          work3d, os.path.join(work3d, "full3d"), dev)
    shutil.rmtree(work3d)

    table = []
    for key, src, replaces in (
            ("deform_clamp", "beyondff_tpu_torch/csrc/ms_deform_sample.cu",
             "beyondff_tpu/kernels/deform_window.py:170"),
            ("flash_900", "beyondff_tpu_torch/csrc/flash_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:270"),
            ("relpos_global", "beyondff_tpu_torch/csrc/relpos_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:193"),
            ("relpos_window", "beyondff_tpu_torch/csrc/relpos_attention.cu",
             "beyondff_tpu/kernels/window_attention.py:51"),
            ("iou_self", "beyondff_tpu_torch/csrc/mask_iou.cu",
             "beyondff_tpu/kernels/mask_iou.py:55"),
            ("k3_efficientsam", "beyondff_tpu_torch/csrc/flash_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:68"),
            ("nms", "beyondff_tpu_torch/csrc/nms_fixed.cu",
             "beyondff_tpu/models/yolo_world.py:313")):
        c = cases[key] if key in ("iou_self", "nms") else cases[(key, "bfloat16", FRAME_BATCH)]
        # K3 is K2's kernel with every key valid; its row counts the fast
        # variant's launches (EfficientSAM's global blocks)
        name = "flash_attention_unmasked" if key == "k3_efficientsam" else c["kernel"]
        table.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                      "launches": launches[name], "max_abs_err": c["max_abs_err"],
                      "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                      # device time per launch (and of the library call), and rates
                      **{key: c.get(key) for key in ("device_ms", "library_device_ms",
                                                     "tflops", "tops", "gbps", "dense_path_ms",
                                                     "dense_path_device_ms", "design")
                         if key in c}})
    shutil.rmtree(work)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(_LINES + [{"kernels": table}], f, indent=1)
    print(card, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
