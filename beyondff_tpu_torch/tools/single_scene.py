"""Single-scene qualitative loop: run the pipeline for one (class, scene) and
export visualizations — the threshold-tuning workflow of the reference's
``*_single`` variants + singlevis_automation (reference: tools/
segmentation_2d_single.py, tools/refinement_single.py,
tools/singlevis_automation.py:24-46). The port's copy of
tools/single_scene.py: seg2d -> projection -> refinement on the card (or the
CPU with ``--device cpu``), then the lifted and refined PLYs (PNG snapshots
with ``--png``, which needs matplotlib), and beyond the JAX CLI the
annotated 2D frame (``*_2d.png``, OpenCV) and the interactive viewer
(``<scene>/web/index.html``).

    python -m beyondff_tpu_torch.tools.single_scene --config config.yaml --cls clothes \
        --scene scene0435_00 [--skip-seg2d] [--png] [--device cpu]

Threshold overrides sweep without editing the config:
    --set refinement.iou_thres=0.5 --set aggregation.iou_thres=0.25
"""

import argparse
import os

import yaml

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.pipeline import projection, refinement, segmentation_2d
from beyondff_tpu_torch.utils import io as bio
from beyondff_tpu_torch.visualization import SceneVisualizer
from beyondff_tpu_torch.visualization.webviz import export_scene


def parse_overrides(items):
    """``key=value`` strings -> {dotted key: YAML-parsed value} (the raw
    string where it is not YAML)."""
    overrides = {}
    for item in items:
        key, _, value = item.partition("=")
        try:
            overrides[key] = yaml.safe_load(value)
        except yaml.YAMLError:
            overrides[key] = value
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF single-scene loop (PyTorch port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--cls", required=True)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--skip-seg2d", action="store_true",
                    help="reuse cached 2D masks (tuning loop)")
    ap.add_argument("--set", action="append", default=[],
                    help="dotted config override, e.g. refinement.iou_thres=0.5")
    ap.add_argument("--png", action="store_true")
    ap.add_argument("--out", default="visualization_out")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    overrides = parse_overrides(args.set)
    if overrides:
        cfg = cfg.override(**overrides)

    if not args.skip_seg2d:
        seg = segmentation_2d.Segmentor2D(cfg, device=args.device)
        segmentation_2d.run(cfg, args.cls, scenes=[args.scene], resume=False, segmentor=seg)
    projection.run(cfg, args.cls, scenes=[args.scene], resume=False, device=args.device)
    results = refinement.run(cfg, args.cls, scenes=[args.scene], device=args.device)
    print(f"[single] {args.scene}: {results[0]['instances']} final instances "
          f"(sim_thres={results[0]['sim_thres']:.4f})")

    viz = SceneVisualizer(cfg, args.scene, out_dir=args.out)
    for path in (viz.lifted_masks(args.cls), viz.refined_masks(args.cls)):
        print(path)
        if args.png:
            print(viz.snapshot_png(path))
    records = bio.load_frame_records(os.path.join(
        cfg.paths.mask_2d_dir, args.cls, f"{args.scene}.{cfg.output_format}"))
    if records:
        print(viz.frame_overlay(args.cls))
    print(export_scene(cfg, args.scene, class_names=[args.cls], out_dir=args.out))


if __name__ == "__main__":
    main()
