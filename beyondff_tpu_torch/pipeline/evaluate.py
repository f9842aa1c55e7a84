"""Per-class evaluation: final outputs + GT -> ScanNet200 AP rows.

Rebuild of the reference CLI (reference: evaluation/eval/eval_scannet200.py):
GT ``.pth`` tuples are ``[coords, colors, sem, inst]``; raw semantic ids are
remapped through the benchmark id table; prediction confidence is forced to
1.0 (matching the Open3DIS protocol, paper Sec. 4); the class's row is patched
into a cumulative ``overall_results.txt``. The port's copy of
beyondff_tpu/pipeline/evaluate.py; evaluation is numpy on the host.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.core import rle
from beyondff_tpu_torch.data import scannet200
from beyondff_tpu_torch.eval import ScanNetEval
from beyondff_tpu_torch.utils import io as bio


def load_gt_scene(gt_path: str, dataset: str = "scannet200") -> Dict:
    """GT tuple -> (sem, inst) int32 arrays. ScanNet raw semantic ids are
    remapped through the benchmark table (eval_scannet200.py:86-98); other
    datasets' GT semantics are already class indices."""
    import torch

    loader = torch.load(gt_path, map_location="cpu", weights_only=False)
    sem_raw, inst = np.asarray(loader[2]), np.asarray(loader[3])
    if dataset.lower() in ("scannet200", "scannet"):
        sem = np.array([scannet200.benchmark_index(int(s)) for s in sem_raw], dtype=np.int32)
    else:
        sem = sem_raw.astype(np.int32)
    return {"sem": sem, "inst": inst.astype(np.int32)}


def class_table(dataset: str):
    """(labels, eval dataset_name) per supported dataset."""
    d = dataset.lower()
    if d in ("scannet200", "scannet"):
        return scannet200.INSTANCE_CAT_SCANNET_200, "scannet200"
    if d == "scannetpp":
        from beyondff_tpu_torch.data import scannetpp

        return scannetpp.INSTANCE_CAT_SCANNET_PP, "scannetpp"
    if d == "replica":
        from beyondff_tpu_torch.data import replica

        return replica.INSTANCE_CAT_REPLICA, "replica"
    if d == "s3dis":
        from beyondff_tpu_torch.data import s3dis

        return s3dis.INSTANCE_CAT_S3DIS, "s3dis"
    raise ValueError(f"unknown dataset {dataset!r}")


def predictions_for_scene(final_path: str, scene_id: str,
                          labels_table=None) -> List[Dict]:
    """Final stage output -> evaluator records; conf forced to 1.0
    (eval_scannet200.py:120-133)."""
    labels_table = labels_table or scannet200.INSTANCE_CAT_SCANNET_200
    d = bio.load_stage_dict(final_path)
    masks = np.asarray(d["ins"])
    labels = d["final_class"]
    preds = []
    for k in range(len(labels)):
        mask = masks[k]
        if isinstance(mask, dict):
            mask = rle.rle_decode(mask)
        preds.append(
            {
                "scan_id": scene_id,
                "label_id": labels_table.index(str(labels[k]).lower()) + 1,
                "conf": 1.0,
                "pred_mask": np.asarray(mask).astype(np.uint8),
            }
        )
    return preds


def run(cfg: Config, class_name: str, scenes: Optional[Sequence[str]] = None, verbose: bool = True,
        table_name: str = "overall_results.txt", plot_pr_curves: bool = True) -> Dict:
    """Evaluate one class over its final outputs; patch the results table.

    ``table_name`` lets multi-host sweeps patch per-host tables
    (``overall_results.host<i>of<n>.txt``) that a final merge folds into the
    canonical file — concurrent hosts would otherwise race the shared
    read-modify-write. ``plot_pr_curves`` writes the per-class PR curve PNGs
    (needs matplotlib); ``False`` skips them and changes no number."""
    data_dir = os.path.join(cfg.paths.final_output_dir, class_name)
    if scenes is None:
        scenes = sorted(f.rsplit(".", 1)[0] for f in os.listdir(data_dir) if f.endswith((".pth", ".npz")))

    labels_table, dataset_name = class_table(cfg.paths.dataset)
    gtsem, gtinst, res = [], [], []
    for scene_id in scenes:
        gt = load_gt_scene(os.path.join(cfg.paths.gt_dir, f"{scene_id}.pth"), cfg.paths.dataset)
        gtsem.append(gt["sem"])
        gtinst.append(gt["inst"])
        for ext in (".pth", ".npz"):
            path = os.path.join(data_dir, scene_id + ext)
            if os.path.exists(path):
                break
        res.append(predictions_for_scene(path, scene_id, labels_table))

    ev = ScanNetEval(class_labels=labels_table, dataset_name=dataset_name)
    avgs = ev.evaluate(res, gtsem, gtinst, exp_path=cfg.paths.results_dir, verbose=verbose)
    if dataset_name == "scannet200":
        update_results_table(
            os.path.join(cfg.paths.results_dir, table_name), class_name, avgs
        )
    # per-class PR curves, like the reference's checked-in pr_curves/ pngs
    curves = {k: v for k, v in ev.pr_curves.items() if k[0] == class_name}
    if curves and plot_pr_curves:
        from beyondff_tpu_torch.eval.instance_eval import plot_pr_curves as plot

        plot(curves, os.path.join(cfg.paths.results_dir, "pr_curves"))
    return avgs


# ------------------------------------------------------------- results table
def _results_template() -> List[str]:
    """Header + one placeholder row per class, grouped head/common/tail
    (eval_scannet200.py:34-48)."""
    lines = ["class,class id,ap,ap50,ap25,rc,rc50,rc25\n"]
    for title, cats in [
        ("Head", scannet200.HEAD_CATS_SCANNET_200),
        ("Common", scannet200.COMMON_CATS_SCANNET_200),
        ("Tail", scannet200.TAIL_CATS_SCANNET_200),
    ]:
        lines.append(f"\n {title} Classes: \n")
        lines.extend(f"{c},-,-,-\n" for c in cats)
    return lines


def merge_results_tables(host_paths: Sequence[str], out_path: str) -> None:
    """Fold per-host results tables into one canonical table.

    Each host patches only its own (disjoint) classes' rows, so the merge —
    template + every host's patched rows, verbatim — is byte-identical to
    the table a single host would have produced over the union of classes."""
    lines = _results_template()
    for hp in host_paths:
        if not os.path.exists(hp):
            continue
        with open(hp) as f:
            for ln in f:
                parts = ln.rstrip("\n").split(",")
                # patched rows carry 6 metric fields; placeholders are "c,-,-,-"
                if len(parts) >= 7 and parts[1] != "-":
                    lines = [ln if l.startswith(f"{parts[0]},") else l for l in lines]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.writelines(lines)


def update_results_table(path: str, class_name: str, avgs: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if os.path.exists(path):
        with open(path) as f:
            lines = f.readlines()
    else:
        lines = _results_template()
    c = avgs["classes"][class_name]
    row = ",".join(
        [class_name] + [str(c[k]) for k in ("ap", "ap50%", "ap25%", "rc", "rc50%", "rc25%")] + ["\n"]
    )
    lines = [row if ln.startswith(f"{class_name},") else ln for ln in lines]
    with open(path, "w") as f:
        f.writelines(lines)
