"""Trace the fast variant's (YOLO-World + EfficientSAM) host blocks.

The port's counterpart of tools/trace_fast_pipeline.py: the fast variant's
models at full width with seeded random weights (YOLO-World-L in float32 as
the stage loads it, EfficientSAM-S and CLIP ViT-L/14 in ``--dtype``), one
scene of ``--frames`` 968 x 1296 JPEGs in the hit regime (every frame has
boxes), ``run()`` once to warm up, then once more with
``BFF_SEG2D_TRACE=1``, which prints the scene's host-blocking seconds per
phase. Prints one JSON line with the traced run's frames/s and stage spans.

    python -m beyondff_tpu_torch.tools.trace_fast_pipeline [--frames 8] [--out DIR]
    python -m beyondff_tpu_torch.tools.trace_fast_pipeline --device cpu --preset test
"""

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from beyondff_tpu_torch.kernels.dispatch import resolve_device

FRAME_HW = (968, 1296)


def write_scene(root: str, scene_id: str, n: int, hw=FRAME_HW, seed: int = 0) -> None:
    """``n`` baseline JPEGs (quality 95) of smooth seeded content with a few
    levels of noise under ``root/<scene_id>/color``."""
    import cv2

    rng = np.random.default_rng(seed)
    color = os.path.join(root, scene_id, "color")
    os.makedirs(color, exist_ok=True)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for i in range(n):
        a = rng.uniform(0.002, 0.02, 3)
        img = 127 + 100 * np.sin(xx[..., None] * a + yy[..., None] * a[::-1] + i)
        img += rng.normal(0, 4, img.shape)
        cv2.imwrite(os.path.join(color, f"{i}.jpg"), np.clip(img, 0, 255).astype(np.uint8),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])


def build_segmentor(cfg, preset: str, dtype: torch.dtype, dev: torch.device):
    """The fast variant's models at ``preset`` ("full": YOLO-World-L,
    EfficientSAM-S, CLIP ViT-L/14; "test": the test presets), seeded."""
    from beyondff_tpu_torch.models import clip as clip_mod
    from beyondff_tpu_torch.models import efficientsam, yolo_world
    from beyondff_tpu_torch.models.tokenizers import HashTokenizer
    from beyondff_tpu_torch.pipeline.segmentation_2d import Segmentor2D

    full = preset == "full"
    clip = clip_mod.CLIP.create("ViT-L/14" if full else "test", seed=1, dtype=dtype, device=dev)
    yw = yolo_world.YOLOWorld.create("l" if full else "test", seed=2, dtype=torch.float32,
                                     device=dev)
    esam = efficientsam.EfficientSAM.create("vits" if full else "test", seed=3, dtype=dtype,
                                            device=dev)
    return Segmentor2D(cfg, detector=yw, sam=esam, clip_model=clip,
                       clip_tokenizer=HashTokenizer(clip.cfg.vocab_size,
                                                    clip.cfg.context_length))


def main(argv=None):
    ap = argparse.ArgumentParser(description="trace the fast variant's host blocks")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--preset", choices=("full", "test"), default="full")
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--out", default=None, help="scene directory (a temporary one by default)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from beyondff_tpu_torch.config import Config
    from beyondff_tpu_torch.pipeline import segmentation_2d
    from beyondff_tpu_torch.utils.profiling import StageProfiler

    root = args.out or tempfile.mkdtemp(prefix="trace_fast_")
    try:
        hw = FRAME_HW if args.preset == "full" else (48, 64)
        for scene, n in (("warmup", 2), ("scene0000_00", args.frames)):
            write_scene(root, scene, n, hw)
        cfg = Config.from_dict({
            "paths": {"scene_2d_dir": root, "mask_2d_dir": os.path.join(root, "out"),
                      "checkpoint_dir": os.path.join(root, "ckpt")},
            "frames": {"width_2d": hw[1], "height_2d": hw[0], "downsample_ratio": 1},
            "detector": {"kind": "yolo_world", "box_threshold": 0.0,
                         "similarity_threshold": -1.0, "must_match_query": False,
                         "dtype": args.dtype}})
        t0 = time.perf_counter()
        seg = build_segmentor(cfg, args.preset, getattr(torch, args.dtype), dev)
        print(f"# models built in {time.perf_counter() - t0:.1f}s", flush=True)
        segmentation_2d.run(cfg, "clothes", scenes=["warmup"], segmentor=seg)
        prof = StageProfiler("segmentation_2d")
        old = os.environ.get("BFF_SEG2D_TRACE")
        os.environ["BFF_SEG2D_TRACE"] = "1"
        try:
            segmentation_2d.run(cfg, "clothes", scenes=["scene0000_00"], segmentor=seg,
                                profiler=prof)
        finally:
            if old is None:
                os.environ.pop("BFF_SEG2D_TRACE")
            else:
                os.environ["BFF_SEG2D_TRACE"] = old
        print(json.dumps({"tool": "trace_fast_pipeline", "device": str(dev),
                          "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
                          else None, "frames": args.frames,
                          "frames_per_sec": prof.rate("scene", "frames"),
                          "spans": json.loads(prof.to_json())}), flush=True)
    finally:
        if args.out is None:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
