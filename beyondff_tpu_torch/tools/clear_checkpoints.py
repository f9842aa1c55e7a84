"""Reset resume checkpoints (reference: clear_checkpoint.ipynb).

    python -m beyondff_tpu_torch.tools.clear_checkpoints --config config.yaml [--cls clothes]
        [--stages segmentation_2d,projection_2d_to_3d,refinement] [--sweep]
"""

import argparse
import os

from beyondff_tpu_torch.config import Config

ALL_STAGES = ("segmentation_2d", "projection_2d_to_3d", "refinement")


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF resume-checkpoint reset (PyTorch)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--cls", default=None, help="only this class (default: all)")
    ap.add_argument("--stages", default=",".join(ALL_STAGES))
    ap.add_argument("--sweep", action="store_true",
                    help="also remove the sweep-level process_checkpoint.txt")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    ckpt_dir = cfg.paths.checkpoint_dir
    stages = [s.strip() for s in args.stages.split(",")]
    removed = 0
    if os.path.isdir(ckpt_dir):
        for f in os.listdir(ckpt_dir):
            if not f.endswith(".yaml"):
                continue
            if not any(f.startswith(f"{s}_checkpoint_") for s in stages):
                continue
            if args.cls and not f.endswith(f"_{args.cls}.yaml"):
                continue
            os.remove(os.path.join(ckpt_dir, f))
            removed += 1
    if args.sweep and os.path.exists("process_checkpoint.txt"):
        os.remove("process_checkpoint.txt")
        removed += 1
    print(f"removed {removed} checkpoint file(s)")


if __name__ == "__main__":
    main()
