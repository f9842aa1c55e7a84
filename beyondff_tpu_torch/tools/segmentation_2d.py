"""Stage 1 CLI: open-vocab 2D detection + segmentation over a class's scenes.

    python -m beyondff_tpu_torch.tools.segmentation_2d --config configs/config.yaml --cls clothes
    python -m beyondff_tpu_torch.tools.segmentation_2d --config ... --cls clothes,towel --device cpu
"""

import argparse
import time

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.pipeline import segmentation_2d


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF 2D segmentation stage (PyTorch)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--cls", required=True,
                    help="text query / class name; comma-separate several to load, upload "
                         "and encode each scene's frames once for all classes "
                         "(segmentation_2d.run_classes)")
    ap.add_argument("--scene", default=None, help="restrict to one scene id")
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    scenes = [args.scene] if args.scene else None
    classes = [c.strip() for c in args.cls.split(",") if c.strip()]
    if not classes:
        ap.error("--cls must name at least one class")
    seg = segmentation_2d.Segmentor2D(cfg, device=args.device)
    t0 = time.time()
    if len(classes) > 1:
        by_class = segmentation_2d.run_classes(cfg, classes, scenes=scenes,
                                               resume=not args.no_resume, segmentor=seg)
    else:
        by_class = {classes[0]: segmentation_2d.run(cfg, classes[0], scenes=scenes,
                                                    resume=not args.no_resume, segmentor=seg)}
    dt = time.time() - t0
    total = sum(len(r) for r in by_class.values())
    print(f"[segmentation_2d] {len(by_class)} class(es), {total} class-scenes, time={dt:.1f}s")
    for cls_name, results in by_class.items():
        print(f"[segmentation_2d] class={cls_name!r} scenes={len(results)}")
        for r in results:
            print(f"  {r['scene_id']}: {r['frames_with_boxes']} frames with detections")


if __name__ == "__main__":
    main()
