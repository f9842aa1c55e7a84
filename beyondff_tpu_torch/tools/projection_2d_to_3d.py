"""Stage 2 CLI: project per-frame 2D masks onto the 3D point cloud.

    python -m beyondff_tpu_torch.tools.projection_2d_to_3d --config configs/config.yaml --cls clothes
"""

import argparse
import time

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.pipeline import projection


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF 2D->3D projection stage (PyTorch)")
    ap.add_argument("--config", required=True, help="path to config YAML")
    ap.add_argument("--cls", required=True,
                    help="text query / class name; comma-separate several to share each "
                         "scene's depth upload across classes (projection.run_classes)")
    ap.add_argument("--scene", default=None, help="restrict to one scene id")
    ap.add_argument("--no-resume", action="store_true", help="ignore scene checkpoints")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    scenes = [args.scene] if args.scene else None
    classes = [c.strip() for c in args.cls.split(",") if c.strip()]
    if not classes:
        ap.error("--cls must name at least one class")
    t0 = time.time()
    if len(classes) > 1:
        by_class = projection.run_classes(cfg, classes, scenes=scenes,
                                          resume=not args.no_resume, device=args.device)
    else:
        by_class = {classes[0]: projection.run(cfg, classes[0], scenes=scenes,
                                               resume=not args.no_resume, device=args.device)}
    dt = time.time() - t0
    total = sum(len(r) for r in by_class.values())
    print(f"[projection] {len(by_class)} class(es), {total} class-scenes, time={dt:.2f}s"
          + (f" ({dt / total:.2f}s/class-scene)" if total else ""))
    for cls_name, results in by_class.items():
        print(f"[projection] class={cls_name!r} scenes={len(results)}")
        for r in results:
            print(f"  {r['scene_id']}: {r['instances']} instances")


if __name__ == "__main__":
    main()
