"""Stage 3 CLI: refine stage-1 masks with stage-2 (query-aware) masks.

    python -m beyondff_tpu_torch.tools.refinement --config configs/config.yaml --cls clothes
"""

import argparse
import time

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.pipeline import refinement


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF refinement stage (PyTorch)")
    ap.add_argument("--config", required=True, help="path to config YAML")
    ap.add_argument("--cls", required=True,
                    help="text query / class name (comma list = batched multi-query)")
    ap.add_argument("--scene", default=None, help="restrict to one scene id")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    classes = [c.strip() for c in args.cls.split(",")]
    t0 = time.time()
    if len(classes) > 1:
        multi = refinement.run_multi(cfg, classes, device=args.device)
        dt = time.time() - t0
        for cls, results in multi.items():
            print(f"[refinement] class={cls!r} scenes={len(results)}")
        print(f"[refinement] {len(classes)} queries batched in {dt:.2f}s")
        return
    scenes = [args.scene] if args.scene else None
    results = refinement.run(cfg, classes[0], scenes=scenes, device=args.device)
    dt = time.time() - t0
    print(f"[refinement] class={classes[0]!r} scenes={len(results)} time={dt:.2f}s"
          + (f" sim_thres={results[0]['sim_thres']:.4f}" if results else ""))
    for r in results:
        print(f"  {r['scene_id']}: {r['instances']} final instances")


if __name__ == "__main__":
    main()
