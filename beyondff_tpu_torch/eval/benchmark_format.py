"""ScanNet benchmark-format export / import of instance predictions.

The official ScanNet evaluation server consumes per-scene txt files listing
``<relative mask path> <label id> <confidence>`` plus 0/1 mask files
(reference: evaluation/eval/instance_eval_util.py:20-29,45-65,125-156).
The port's copy of beyondff_tpu/eval/benchmark_format.py.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def export_ids(path: str, ids: np.ndarray) -> None:
    np.savetxt(path, np.asarray(ids, np.int64), fmt="%d")


def load_ids(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int64).reshape(-1)


def export_instances(
    out_txt: str,
    masks: np.ndarray,  # (K, N) bool
    label_ids: Sequence[int],  # benchmark label id per instance
    confidences: Sequence[float],
    mask_dir_name: str = "pred_mask",
) -> None:
    """Write one scene's predictions in server format."""
    base = os.path.splitext(os.path.basename(out_txt))[0]
    mask_dir = os.path.join(os.path.dirname(out_txt) or ".", mask_dir_name)
    os.makedirs(mask_dir, exist_ok=True)
    with open(out_txt, "w") as f:
        for k in range(len(label_ids)):
            rel = os.path.join(mask_dir_name, f"{base}_{k}.txt")
            export_ids(os.path.join(os.path.dirname(out_txt) or ".", rel),
                       np.asarray(masks[k], np.uint8))
            f.write(f"{rel} {int(label_ids[k])} {float(confidences[k]):f}\n")


def read_instances(txt_path: str) -> List[Dict]:
    """Read a server-format prediction file back into evaluator records."""
    out = []
    root = os.path.dirname(txt_path) or "."
    with open(txt_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                raise ValueError(f"malformed benchmark line: {line!r}")
            rel, label_id, conf = parts
            if os.path.isabs(rel):
                raise ValueError("benchmark format requires relative mask paths")
            mask = load_ids(os.path.join(root, rel)).astype(np.uint8)
            out.append({"pred_mask": mask, "label_id": int(float(label_id)),
                        "conf": float(conf)})
    return out
