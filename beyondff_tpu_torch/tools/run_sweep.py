"""Full class-sweep CLI: seg2d -> projection -> refinement -> eval per class.

    python -m beyondff_tpu_torch.tools.run_sweep --config configs/config.yaml
    python -m beyondff_tpu_torch.tools.run_sweep --config c.yaml --classes "clothes,towel" --device cpu
    python -m beyondff_tpu_torch.tools.run_sweep --config c.yaml --find-parameters

Multi-host: each host runs its deterministic class partition, then any one
host merges the per-host tables and checkpoints:

    python -m beyondff_tpu_torch.tools.run_sweep --config c.yaml --hosts N --host i
    python -m beyondff_tpu_torch.tools.run_sweep --config c.yaml --merge-hosts N

Without ``--hosts``, an initialized ``torch.distributed`` group of several
processes gives the partition; ``--host`` alone is an error.
"""

import argparse

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.orchestration import (SweepRunner, default_class_list,
                                              merge_host_results, resolve_hosts)


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF class sweep (PyTorch)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--classes", default=None, help="comma-separated override")
    ap.add_argument("--per-group", type=int, default=40,
                    help="classes per head/common/tail group")
    ap.add_argument("--checkpoint", default="process_checkpoint.txt")
    ap.add_argument("--find-parameters", action="store_true",
                    help="skip seg2d; reuse cached 2D masks for threshold tuning")
    ap.add_argument("--retries", type=int, default=0, help="per-stage retry budget")
    ap.add_argument("--subprocess", action="store_true",
                    help="run stages as the port's CLIs in subprocesses for crash isolation")
    ap.add_argument("--amortize-segmentation", action="store_true",
                    help="run the 2D stage for ALL classes scene-outer first (per-scene "
                         "frame bank)")
    ap.add_argument("--hosts", type=int, default=None,
                    help="total hosts in a multi-host sweep (default: the torch.distributed "
                         "world size when initialized with several processes, else 1)")
    ap.add_argument("--host", type=int, default=None, help="this host's index")
    ap.add_argument("--merge-hosts", type=int, default=None, metavar="N",
                    help="merge N hosts' results tables + checkpoints into the canonical "
                         "files, then exit")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--no-pr-curves", action="store_true",
                    help="skip the evaluation's PR-curve PNGs (they need matplotlib)")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    if args.merge_hosts:
        merge_host_results(cfg, args.merge_hosts, checkpoint_path=args.checkpoint)
        print(f"[sweep] merged {args.merge_hosts} hosts' results into overall_results.txt")
        return
    hosts, host = resolve_hosts(args.hosts, args.host)
    runner = SweepRunner(cfg, config_path=args.config, checkpoint_path=args.checkpoint,
                         skip_segmentation=args.find_parameters,
                         use_subprocess=args.subprocess, retries=args.retries,
                         hosts=hosts, host=host, device=args.device,
                         plot_pr_curves=not args.no_pr_curves)
    classes = args.classes.split(",") if args.classes else default_class_list(args.per_group)
    results = runner.run(classes, amortize_segmentation=args.amortize_segmentation)
    failed = [c for c, st in results.items() if not all(st.values())]
    print(f"[sweep] {len(results) - len(failed)}/{len(results)} classes complete"
          + (f"; failed: {failed}" if failed else ""))


if __name__ == "__main__":
    main()
