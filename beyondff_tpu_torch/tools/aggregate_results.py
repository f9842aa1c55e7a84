"""Aggregate per-class AP rows into head/common/tail and base/novel mAP.

Equivalent of the reference's aggregation notebook
(reference: evaluation/eval_results/cal.ipynb, SURVEY.md C24): reads the
cumulative ``overall_results.txt`` the per-class evaluator patches, and prints
the Table-1-style summary, optionally writing a CSV.

    python -m beyondff_tpu_torch.tools.aggregate_results evaluation/eval_results/overall_results.txt
"""

import argparse

import numpy as np

from beyondff_tpu_torch.data import scannet200 as s2


def parse_results(path: str):
    rows = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 4 or parts[1] == "class id" or parts[1] == "-":
                continue
            name = parts[0]
            try:
                vals = [float(x) for x in parts[1:7]]
            except ValueError:
                continue
            rows[name] = vals  # ap, ap50, ap25, rc, rc50, rc25
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF results aggregation (PyTorch)")
    ap.add_argument("results", help="overall_results.txt path")
    ap.add_argument("--csv", default=None, help="write the summary as CSV")
    args = ap.parse_args(argv)

    rows = parse_results(args.results)
    groups = {
        "Head": s2.HEAD_CATS_SCANNET_200,
        "Common": s2.COMMON_CATS_SCANNET_200,
        "Tail": s2.TAIL_CATS_SCANNET_200,
        "Base": s2.BASE_CLASSES_SCANNET200,
        "Novel": s2.NOVEL_CLASSES_SCANNET200,
    }

    lines = [f"{'group':<10}{'n':>5}{'AP':>9}{'AP50':>9}{'AP25':>9}"]
    summary = {}
    for gname, members in groups.items():
        vals = np.array([rows[m][:3] for m in members if m in rows])
        if len(vals) == 0:
            continue
        mean = np.nanmean(vals, axis=0)
        summary[gname] = mean
        lines.append(f"{gname:<10}{len(vals):>5}{mean[0]:>9.4f}{mean[1]:>9.4f}{mean[2]:>9.4f}")
    hct = [rows[m][:3] for g in ("Head", "Common", "Tail")
           for m in groups[g] if m in rows]
    if hct:
        mean = np.nanmean(np.array(hct), axis=0)
        summary["Overall"] = mean
        lines.append(f"{'Overall':<10}{len(hct):>5}{mean[0]:>9.4f}{mean[1]:>9.4f}{mean[2]:>9.4f}")
    print("\n".join(lines))

    if args.csv:
        with open(args.csv, "w") as f:
            f.write("group,ap,ap50,ap25\n")
            for g, m in summary.items():
                f.write(f"{g},{m[0]},{m[1]},{m[2]}\n")
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
