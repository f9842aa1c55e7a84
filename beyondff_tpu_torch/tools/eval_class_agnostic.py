"""Class-agnostic evaluation over final outputs (reference: evaluation/eval/
eval_class_agnostic_scannet200.py): all labels collapse to one class and AP
measures pure mask quality.

    python -m beyondff_tpu_torch.tools.eval_class_agnostic --config configs/config.yaml --cls clothes
"""

import argparse
import os

import numpy as np

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.core import rle
from beyondff_tpu_torch.data import scannet200
from beyondff_tpu_torch.eval import ScanNetEval
from beyondff_tpu_torch.pipeline import evaluate as eval_pipeline
from beyondff_tpu_torch.utils import io as bio


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF class-agnostic evaluation (PyTorch)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--cls", required=True)
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    data_dir = os.path.join(cfg.paths.final_output_dir, args.cls)
    scenes = sorted(f.rsplit(".", 1)[0] for f in os.listdir(data_dir)
                    if f.endswith((".pth", ".npz")))

    gtsem, gtinst, res = [], [], []
    for scene_id in scenes:
        gt = eval_pipeline.load_gt_scene(os.path.join(cfg.paths.gt_dir, f"{scene_id}.pth"))
        gtsem.append(gt["sem"])
        gtinst.append(gt["inst"])
        for ext in (".pth", ".npz"):
            path = os.path.join(data_dir, scene_id + ext)
            if os.path.exists(path):
                break
        d = bio.load_stage_dict(path)
        masks = np.asarray(d["ins"])
        preds = []
        for k in range(len(d["final_class"])):
            mask = masks[k]
            if isinstance(mask, dict):
                mask = rle.rle_decode(mask)
            # label forced to 0 -> class agnostic (reference :35-100)
            preds.append({"scan_id": scene_id, "label_id": 0, "conf": 1.0,
                          "pred_mask": np.asarray(mask).astype(np.uint8)})
        res.append(preds)

    ev = ScanNetEval(class_labels=scannet200.INSTANCE_CAT_SCANNET_200, use_label=False)
    avgs = ev.evaluate(res, gtsem, gtinst, verbose=True)
    print(f"[class-agnostic] AP={avgs['all_ap']:.4f} AP50={avgs['all_ap_50%']:.4f} "
          f"AP25={avgs['all_ap_25%']:.4f}")


if __name__ == "__main__":
    main()
