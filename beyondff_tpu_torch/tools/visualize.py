"""Visualization CLI: export any pipeline intermediate of a scene as colored
PLY (+ optional PNG snapshots), the annotated 2D frame, or the interactive
HTML viewer. The port's copy of tools/visualize.py, with the same arguments
and outputs (reference: visualization/visualize_scannet200.py:651-722). It
reads stage files and runs nothing on a device.

    python -m beyondff_tpu_torch.tools.visualize --config config.yaml \
        --scene scene0435_00 --cls clothes --modes gt,stage1,mask3d,refined,frame2d,web

``--png`` needs matplotlib.
"""

import argparse

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.visualization import SceneVisualizer


def main(argv=None):
    ap = argparse.ArgumentParser(description="BeyondFF scene visualization (PyTorch port)")
    ap.add_argument("--config", required=True)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--cls", default=None, help="class for mask3d/mask2d/refined modes")
    ap.add_argument("--modes", default="gt,stage1",
                    help="comma list: gt,stage1,mask3d,mask2d,refined,frame2d,web")
    ap.add_argument("--out", default="visualization_out")
    ap.add_argument("--png", action="store_true", help="also render PNG snapshots")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    viz = SceneVisualizer(cfg, args.scene, out_dir=args.out)
    outputs = []
    for mode in args.modes.split(","):
        mode = mode.strip()
        if mode == "web":
            # interactive single-file viewer with per-mode toggles (the
            # reference's pyviz3d web export, visualize_scannet200.py:651-722)
            from beyondff_tpu_torch.visualization.webviz import export_scene

            path = export_scene(cfg, args.scene,
                                class_names=[args.cls] if args.cls else [],
                                out_dir=args.out)
            outputs.append(path)
            print(f"open in a browser: {path}")
            continue
        if mode == "gt":
            outputs.append(viz.gt_instances())
        elif mode == "stage1":
            outputs.append(viz.stage1_masks())
        elif mode == "mask3d":
            outputs.append(viz.lifted_masks(args.cls))
        elif mode == "mask2d":
            outputs.append(viz.lifted_2d_frame(args.cls))
        elif mode == "frame2d":
            # annotated RGB frame: boxes + alpha-blended masks (the
            # reference single-scene variant's draw=True output)
            path = viz.frame_overlay(args.cls)
            outputs.append(path)
            print(f"wrote {path}")
            continue
        elif mode == "refined":
            outputs.append(viz.refined_masks(args.cls))
        else:
            raise SystemExit(f"unknown mode {mode!r}")
    for p in outputs:
        print(p)
        if args.png:
            print(viz.snapshot_png(p))


if __name__ == "__main__":
    main()
