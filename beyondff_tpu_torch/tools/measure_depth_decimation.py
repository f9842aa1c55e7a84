"""Label the depth-decimation knob with its accuracy cost.

The port's counterpart of tools/measure_depth_decimation.py.
``frames.depth_decimation=k`` subsamples depth k-fold before the lift's
visibility test. This runs projection and refinement at k = 1, 2, 4 on the
port's synthetic scene (``tools/make_synthetic_scene``, two scenes, seed 7)
and reports (a) the ScanNet200-protocol AP against the scene's ground truth
(``pipeline/evaluate``, the engine of the real evaluation) and (b) the mean
final-mask IoU against the k = 1 outputs (rows matched greedily by IoU).
The projection's and refinement's mask IoUs run through the mask-IoU
kernel on the card.

    python -m beyondff_tpu_torch.tools.measure_depth_decimation [--device cpu]

Prints one JSON line per k and the JAX tool's table.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Dict, Sequence

import numpy as np

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.pipeline import evaluate, projection, refinement
from beyondff_tpu_torch.tools import make_synthetic_scene
from beyondff_tpu_torch.utils import io as bio

QUERY = "clothes"


def mean_iou_vs(base_masks: Dict, masks: Dict) -> float:
    """Mean over base files of each row's best IoU against the base rows
    (the JAX tool's matching, empty cases included)."""
    ious = []
    for f, m1 in base_masks.items():
        m = masks.get(f)
        if m is None or m.shape[0] == 0 or m1.shape[0] == 0:
            ious.append(0.0 if (m is None or m.shape[0] != m1.shape[0]) else 1.0)
            continue
        inter = (m[:, None] & m1[None]).sum(-1)
        union = (m[:, None] | m1[None]).sum(-1)
        ious.append(float((inter / np.maximum(union, 1)).max(axis=1).mean()))
    return float(np.mean(ious))


def measure(root: str, device, decimations: Sequence[int] = (1, 2, 4), scenes: int = 2,
            seed: int = 7) -> Dict[int, Dict]:
    """Generate the scene under ``root`` and run each decimation; returns
    {k: {"all_ap", "all_ap_50%", "all_ap_25%", "mean_final_mask_iou_vs_dec1"}}."""
    dev = resolve_device(device)
    base = Config.from_yaml(make_synthetic_scene.generate(root, QUERY, scenes=scenes,
                                                          seed=seed))
    results = {}
    for dec in decimations:
        cfg = base.override(**{"frames.depth_decimation": dec})
        for sub in ("mask_3d", "final_output", "checkpoints", "eval_results"):
            shutil.rmtree(os.path.join(root, sub), ignore_errors=True)
        projection.run(cfg, QUERY, resume=False, device=dev)
        refinement.run_multi(cfg, [QUERY], device=dev)
        ev = evaluate.run(cfg, QUERY, verbose=False, plot_pr_curves=False)
        out_dir = os.path.join(root, "final_output", QUERY)
        masks = {f: np.asarray(bio.load_stage_dict(os.path.join(out_dir, f))["ins"], bool)
                 for f in sorted(os.listdir(out_dir))}
        results[dec] = (ev if isinstance(ev, dict) else {}, masks)
    base_masks = results[decimations[0]][1]
    return {dec: {"all_ap": ev.get("all_ap", float("nan")),
                  "all_ap_50%": ev.get("all_ap_50%", float("nan")),
                  "all_ap_25%": ev.get("all_ap_25%", float("nan")),
                  "mean_final_mask_iou_vs_dec1": mean_iou_vs(base_masks, masks)}
            for dec, (ev, masks) in results.items()}


def main(argv=None) -> Dict[int, Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    root = tempfile.mkdtemp(prefix="bff_dec_")
    try:
        rows = measure(root, args.device, seed=args.seed)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for dec, r in rows.items():
        print(json.dumps({"tool": "measure_depth_decimation", "depth_decimation": dec, **r}),
              flush=True)
    print("dec  AP      AP50    AP25    mean_final_mask_IoU_vs_dec1")
    for dec, r in rows.items():
        print(f"{dec}    {r['all_ap']:.4f}  {r['all_ap_50%']:.4f}  {r['all_ap_25%']:.4f}  "
              f"{r['mean_final_mask_iou_vs_dec1']:.4f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
