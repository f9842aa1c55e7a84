"""Smoke run of the PyTorch/CUDA port (beyondff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each one's failure ends the run with a non-zero exit):

1. build the CUDA kernels from ``beyondff_tpu_torch/csrc`` (nvcc, sm_90a)
   and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (the 800x1072 Grounding-DINO encoder raster and the 900-query
   decoder, for one frame and for the main path's batch of 4), in bf16 and
   f32, and time kernel, plain version and, for attention,
   ``scaled_dot_product_attention`` as a yardstick;
3. check the port on a small input against its own plain CPU path (the path
   the CPU tests hold against the JAX package);
4. drive the 2D stage's ``run()`` at full width — Grounding-DINO Swin-B,
   CLIP ViT-L/14, SAM ViT-H in bf16 with seeded random weights — on one
   8-frame 968x1296 scene, with launch counts reset just before it; reload
   and check the written ``.pth``;
5. run the scene once more under ``torch.profiler`` for the device's busy
   share and the kernels that take its time.

The last two lines are the kernel table and ``{"ok": true, "device": ...}``;
every JSON line also goes to ``chiprun_out/chip_smoke.json``. Exits non-zero
without a result when no CUDA device is present.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor; f32 non-tensor
SEED = 0
N_FRAMES = 8
FRAME_BATCH = 4  # detector.frame_batch, the config default
FRAME_HW = (968, 1296)
ENC_SHAPES = ((100, 134), (50, 67), (25, 34), (13, 17))  # 800x1072 input, Swin-B
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


def raster_centers(shapes):
    cs = []
    for h, w in shapes:
        ys = (np.arange(h) + 0.5) / h
        xs = (np.arange(w) + 0.5) / w
        cs.append(np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2))
    return np.concatenate(cs, 0).astype(np.float32)


def deform_case(torch, dw, name, shapes, q_locs, dtype, modes, dev, rng, b):
    """One ms_deform_sample comparison + timing; q_locs (Q, 2) query anchors,
    ``b`` frames in the batch."""
    heads, hd, p = 8, 32, 4
    s = sum(h * w for h, w in shapes)
    q = q_locs.shape[0]
    lv = len(shapes)
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    off = rng.uniform(-12.0, 12.0, (b, q, heads, lv, p, 2)).astype(np.float32) / wh[:, None, :]
    locs = q_locs[None, :, None, None, None, :] + off
    locs[:, ::17] += 1.5  # a share of samples wholly outside the map
    logits = rng.normal(size=(b, q, heads, lv * p)).astype(np.float32)
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value = torch.randn(b, s, heads, hd, device=dev, dtype=torch.float32).to(dtype)
    tl = torch.from_numpy(locs).to(dev)
    ta = torch.from_numpy(aw.reshape(b, q, heads, lv, p)).to(dev, dtype)
    got = dw.ms_deform_sample(value, shapes, tl, ta, modes)
    want = dw.ms_deform_sample_plain(value, shapes, tl, ta, modes)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    es = value.element_size()
    nbytes = value.numel() * es + tl.numel() * 4 + ta.numel() * es + got.numel() * es
    flops = b * q * heads * lv * p * 4 * hd * 2  # four corners, one FMA per channel
    dname = str(dtype).split(".")[-1]
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS["float32"] * 1e3  # interpolation runs on the f32 units
    rec = {
        "case": name, "kernel": "ms_deform_sample", "dtype": dname, "batch": b, "queries": q,
        "max_abs_err": err, "tol": tol,
        "ms": cuda_ms(torch, lambda: dw.ms_deform_sample(value, shapes, tl, ta, modes), 20),
        "plain_ms": cuda_ms(torch, lambda: dw.ms_deform_sample_plain(value, shapes, tl, ta,
                                                                      modes), 3),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": None,
    }
    emit(rec)
    check(err <= tol, f"ms_deform_sample {name} {dname}: max abs err {err} > {tol}")
    return rec


def flash_case(torch, fa, name, shape, valid_len, dtype, dev):
    import torch.nn.functional as F

    bh, s, d = shape
    q, k, v = (torch.randn(bh, s, d, device=dev, dtype=torch.float32).to(dtype)
               for _ in range(3))
    got = fa.flash_attention(q, k, v, valid_len=valid_len)
    want = fa.flash_attention_plain(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 1e-4 if dtype == torch.float32 else 1.6e-2
    dname = str(dtype).split(".")[-1]
    nbytes = 4 * bh * s * d * q.element_size()
    flops = 4 * bh * s * valid_len * d
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[dname] * 1e3
    q4, k4, v4 = (t.view(1, bh, s, d) for t in (q, k, v))
    rec = {
        "case": name, "kernel": "flash_attention", "dtype": dname, "shape": list(shape),
        "valid_len": valid_len, "max_abs_err": err, "tol": tol,
        "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v, valid_len=valid_len), 50),
        "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, valid_len), 20),
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(q4, k4, v4), 50),
    }
    emit(rec)
    check(err <= tol, f"flash_attention {name} {dname}: max abs err {err} > {tol}")
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


def make_scene(root, scene_id, n):
    color = os.path.join(root, scene_id, "color")
    os.makedirs(color, exist_ok=True)
    for i in range(n):
        open(os.path.join(color, f"{i}.jpg"), "wb").close()


def stage_config(Config, work, tag, hw, frame_batch, dtype):
    return Config.from_dict({
        "paths": {"scene_2d_dir": os.path.join(work, "scenes"),
                  "mask_2d_dir": os.path.join(work, f"masks_{tag}"),
                  "checkpoint_dir": os.path.join(work, f"ckpt_{tag}")},
        "frames": {"height_2d": hw[0], "width_2d": hw[1], "downsample_ratio": 1},
        "detector": {"box_threshold": 0.0, "must_match_query": False,
                     "similarity_threshold": -1.0, "frame_batch": frame_batch,
                     "dtype": dtype},
    })


def small_reference(torch, mods, work):
    """Port on CUDA vs port on the CPU (plain versions) at the "test" presets,
    f32, one 4-frame 48x64 scene, encoder in clamp mode on both sides."""
    Config, seg2d, gd, sam_mod, clip_mod, io = mods
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
        out = {}
        for dev, (det, sam, clip) in (("cpu", cpu_models), ("cuda", gpu_models)):
            cfg = stage_config(Config, work, f"small_{dev}", (48, 64), 2, "float32")
            seg = seg2d.Segmentor2D(cfg, detector=det, sam=sam, clip_model=clip,
                                    frame_loader=loader)
            seg2d.run(cfg, "clothes", scenes=["small"], segmentor=seg, resume=False)
            out[dev] = io.load_frame_records(
                os.path.join(cfg.paths.mask_2d_dir, "clothes", "small.pth"))
    finally:
        del os.environ["BFF_DEFORM_WINDOWED"]
    cpu, gpu = out["cpu"], out["cuda"]
    check(bool(cpu) and [r["frame_id"] for r in cpu] == [r["frame_id"] for r in gpu],
          "small scene: frame ids differ")
    worst_conf, worst_iou = 0.0, 1.0
    from beyondff_tpu_torch.core import rle

    for a, b in zip(cpu, gpu):
        check(a["labels"] == b["labels"], f"small scene {a['frame_id']}: labels differ")
        worst_conf = max(worst_conf, float(np.abs(np.asarray(a["confidences"])
                                                  - np.asarray(b["confidences"])).max()))
        for ra, rb in zip(a["segmented_frame_masks"], b["segmented_frame_masks"]):
            ma, mb = rle.rle_decode(ra).astype(bool), rle.rle_decode(rb).astype(bool)
            union = (ma | mb).sum()
            worst_iou = min(worst_iou, 1.0 if union == 0 else (ma & mb).sum() / union)
    rec = {"phase": "small_reference", "frames": len(gpu), "max_conf_diff": worst_conf,
           "min_mask_iou": worst_iou, "conf_tol": 1e-4, "iou_min": 0.99}
    emit(rec)
    check(worst_conf <= 1e-4 and worst_iou >= 0.99, f"CUDA path disagrees with the CPU path: {rec}")


def profile_scene(torch, seg2d, seg, cfg, scene, timed_scene_s):
    """The same scene once more under ``torch.profiler`` (device activity
    only): the device's busy share of the ``scene`` span (union of kernel,
    copy and set intervals over the span) and the kernels that take the
    device's time. The timed run above stays unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from beyondff_tpu_torch.utils.profiling import StageProfiler

    prof = StageProfiler("segmentation_2d")
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        seg2d.run(cfg, "clothes", scenes=[scene], segmentor=seg, resume=False, profiler=prof)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in p.events()
                   if e.device_type == DeviceType.CUDA)
    check(spans, "torch.profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + e - s)
    scene_s = prof.durations["scene"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    ours = {k: v for k, v in by_name.items()
            if "ms_deform_sample_kernel" in k or "flash_fwd_kernel" in k}
    emit({"phase": "device_profile", "scene_seconds_profiled": scene_s,
          "scene_seconds_timed": timed_scene_s, "device_busy_ms": busy_us / 1e3,
          "device_busy_share": busy_us / 1e6 / scene_s, "device_events": len(spans),
          "top_device_ms": [[name[:120], n, us / 1e3] for name, (n, us) in top],
          "port_kernels_ms": {name[:120]: [n, us / 1e3] for name, (n, us) in ours.items()}})


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
    from beyondff_tpu_torch.models import clip as clip_mod
    from beyondff_tpu_torch.models import sam as sam_mod
    from beyondff_tpu_torch.models.gdino import deformable, model as gd
    from beyondff_tpu_torch.pipeline import segmentation_2d as seg2d
    from beyondff_tpu_torch.utils import io
    from beyondff_tpu_torch.utils.profiling import StageProfiler

    dev = torch.device("cuda")
    # ---------------------------------------------------------------- 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- 2
    rng = np.random.default_rng(SEED)
    enc_modes = deformable.level_modes(ENC_SHAPES)
    dec_anchor = rng.uniform(0.0, 1.0, (900, 2)).astype(np.float32)
    cases = {}
    # one frame, and the main path's batch of FRAME_BATCH frames
    for b in (1, FRAME_BATCH):
        for dtype in (torch.bfloat16, torch.float32):
            dname = str(dtype).split(".")[-1]
            cases[("deform_clamp", dname, b)] = deform_case(
                torch, dw, "encoder_clamp", ENC_SHAPES, raster_centers(ENC_SHAPES), dtype,
                enc_modes, dev, rng, b)
            cases[("deform_exact", dname, b)] = deform_case(
                torch, dw, "encoder_exact", ENC_SHAPES, raster_centers(ENC_SHAPES), dtype,
                (None,) * 4, dev, rng, b)
            cases[("deform_dec", dname, b)] = deform_case(
                torch, dw, "decoder_exact", ENC_SHAPES, dec_anchor, dtype, (None,) * 4, dev,
                rng, b)
            cases[("flash_900", dname, b)] = flash_case(torch, fa, "decoder_self_attn",
                                                        (8 * b, 900, 32), 900, dtype, dev)
            cases[("flash_1024", dname, b)] = flash_case(torch, fa, "unmasked_1024",
                                                         (8 * b, 1024, 32), 1024, dtype, dev)

    work = os.path.join(REPO, "chiprun_out", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    # ---------------------------------------------------------------- 3
    small_reference(torch, (Config, seg2d, gd, sam_mod, clip_mod, io), work)

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
    cfg = stage_config(Config, work, "full", FRAME_HW, FRAME_BATCH, "bfloat16")
    seg = seg2d.Segmentor2D(cfg, detector=det, sam=sam, clip_model=clip,
                            frame_loader=synthetic_frame)
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

    # the .pth contract: plain torch.load
    recs = torch.load(os.path.join(cfg.paths.mask_2d_dir, "clothes", "scene0000_00.pth"),
                      map_location="cpu", weights_only=False)
    check(len(recs) == N_FRAMES, f"{len(recs)} records for {N_FRAMES} frames")
    n = FRAME_HW[0] * FRAME_HW[1]
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
    emit({"phase": "output_check", "records": len(recs),
          "masks": sum(len(r["segmented_frame_masks"]) for r in recs)})

    # ---------------------------------------------------------------- 5
    profile_scene(torch, seg2d, seg, cfg, "scene0000_00", scene_s)

    table = []
    for key, src, replaces in (
            ("deform_clamp", "beyondff_tpu_torch/csrc/ms_deform_sample.cu",
             "beyondff_tpu/kernels/deform_window.py:170"),
            ("flash_900", "beyondff_tpu_torch/csrc/flash_attention.cu",
             "beyondff_tpu/kernels/flash_attention.py:270")):
        c = cases[(key, "bfloat16", FRAME_BATCH)]
        table.append({"name": c["kernel"], "route": "cuda", "source": src, "replaces": replaces,
                      "launches": launches[c["kernel"]], "max_abs_err": c["max_abs_err"],
                      "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                      "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    shutil.rmtree(work)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(_LINES + [{"kernels": table}], f, indent=1)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
