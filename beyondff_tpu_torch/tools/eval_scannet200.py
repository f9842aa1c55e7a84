"""Per-class evaluation CLI: final outputs + GT -> ScanNet200 AP.

    python -m beyondff_tpu_torch.tools.eval_scannet200 --config configs/config.yaml --cls clothes

``--table`` names the results table to patch (a multi-host sweep's per-host
table); ``--no-pr-curves`` skips the PR-curve PNGs (they need matplotlib).
"""

import argparse

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.pipeline import evaluate


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF ScanNet200 evaluation (PyTorch)")
    ap.add_argument("--config", required=True, help="path to config YAML")
    ap.add_argument("--cls", required=True, help="class to evaluate")
    ap.add_argument("--table", default="overall_results.txt",
                    help="results table under paths.results_dir")
    ap.add_argument("--no-pr-curves", action="store_true", help="skip the PR-curve PNGs")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    avgs = evaluate.run(cfg, args.cls, table_name=args.table,
                        plot_pr_curves=not args.no_pr_curves)
    c = avgs["classes"][args.cls]
    print(f"[eval] {args.cls}: AP={c['ap']:.4f} AP50={c['ap50%']:.4f} AP25={c['ap25%']:.4f}")


if __name__ == "__main__":
    main()
