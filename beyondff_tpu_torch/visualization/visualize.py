"""Scene visualization: colored point-cloud exports of every pipeline stage.

Rebuild of the reference visualizer's capabilities (reference: visualization/
visualize_scannet200.py:452-640 — gtviz / vizmask3d / vizmask2d / finalviz /
singleviz / refinedviz). The reference renders through pyviz3d's web export;
this build writes standard colored ``.ply`` files (openable in MeshLab /
CloudCompare / any viewer) plus optional matplotlib projection snapshots —
dependency-free and scriptable.

Each mode colors instance masks with a stable per-instance palette over a
grey base cloud. The port's copy of beyondff_tpu/visualization/visualize.py:
numpy and OpenCV, with matplotlib only for :meth:`SceneVisualizer.snapshot_png`;
the same inputs give the same PLY, PNG and label files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from beyondff_tpu_torch.core import rle
from beyondff_tpu_torch.data import scannet200
from beyondff_tpu_torch.utils import io as bio


def _palette(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    hues = (np.arange(n) / max(n, 1) + rng.random()) % 1.0
    # hsv -> rgb with s=0.85, v=0.95
    h6 = hues * 6
    i = h6.astype(int) % 6
    f = h6 - np.floor(h6)
    v, s = 0.95, 0.85
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    choices = [
        np.stack([np.full_like(f, v), t, np.full_like(f, p)], -1),
        np.stack([q, np.full_like(f, v), np.full_like(f, p)], -1),
        np.stack([np.full_like(f, p), np.full_like(f, v), t], -1),
        np.stack([np.full_like(f, p), q, np.full_like(f, v)], -1),
        np.stack([t, np.full_like(f, p), np.full_like(f, v)], -1),
        np.stack([np.full_like(f, v), np.full_like(f, p), q], -1),
    ]
    lut = np.select([(i == k)[:, None] for k in range(6)], choices)
    return (lut * 255).astype(np.uint8)


def write_colored_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Binary little-endian PLY with uchar colors."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = xyz.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("r", "u1"), ("g", "u1"), ("b", "u1")])
    rec["x"], rec["y"], rec["z"] = xyz.T.astype(np.float32)
    rec["r"], rec["g"], rec["b"] = rgb.T.astype(np.uint8)
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


class SceneVisualizer:
    def __init__(self, cfg, scene_id: str, out_dir: str = "visualization_out"):
        self.cfg = cfg
        self.scene_id = scene_id
        self.out_dir = out_dir
        self.xyz = bio.load_point_cloud(cfg.paths.scene_npy_dir, scene_id)

    def _masks_to_ply(self, name: str, masks: np.ndarray,
                      labels: Optional[Sequence[str]] = None) -> str:
        base = np.full((self.xyz.shape[0], 3), 160, np.uint8)  # grey background
        colors = _palette(max(len(masks), 1))
        for i, m in enumerate(np.asarray(masks).astype(bool)):
            base[m] = colors[i]
        path = os.path.join(self.out_dir, self.scene_id, f"{name}.ply")
        write_colored_ply(path, self.xyz, base)
        if labels is not None:
            with open(path[:-4] + "_labels.txt", "w") as f:
                for i, lab in enumerate(labels):
                    r, g, b = colors[i]
                    f.write(f"{i}\t{lab}\trgb({r},{g},{b})\n")
        return path

    # ------------------------------------------------------ stage exports
    def gt_instances(self) -> str:
        """GT instance masks (reference gtviz :478-509)."""
        from beyondff_tpu_torch.pipeline.evaluate import load_gt_scene

        gt = load_gt_scene(os.path.join(self.cfg.paths.gt_dir, f"{self.scene_id}.pth"))
        ids = np.unique(gt["inst"])
        ids = ids[ids >= 0]
        masks = np.stack([gt["inst"] == i for i in ids]) if len(ids) else np.zeros((0, len(gt["inst"])), bool)
        labels = [str(scannet200.CLASS_LABELS_200[scannet200_bench(gt, i)])
                  if 0 <= scannet200_bench(gt, i) < 200 else "?" for i in ids]
        return self._masks_to_ply("gt", masks, labels)

    def stage1_masks(self) -> str:
        """Stage-1 backbone masks (reference vizmask3d :511-528)."""
        from beyondff_tpu_torch.pipeline.refinement import decode_stage1

        raw = bio.load_stage_dict(
            os.path.join(self.cfg.paths.stage_1_results_dir, f"{self.scene_id}.pth"))
        d = decode_stage1(raw)
        return self._masks_to_ply("stage1", d["ins"], d["final_class"])

    def lifted_masks(self, class_name: str) -> str:
        """Per-class lifted stage-2 3D masks (reference singleviz :580-609)."""
        d = bio.load_stage_dict(
            os.path.join(self.cfg.paths.mask_3d_dir, class_name, f"{self.scene_id}.pth"))
        return self._masks_to_ply(f"mask3d_{class_name}", np.asarray(d["ins"]), d["final_class"])

    def refined_masks(self, class_name: str) -> str:
        """Refined final masks (reference refinedviz :611-640)."""
        d = bio.load_stage_dict(
            os.path.join(self.cfg.paths.final_output_dir, class_name, f"{self.scene_id}.pth"))
        return self._masks_to_ply(f"refined_{class_name}", np.asarray(d["ins"]), d["final_class"])

    def lifted_2d_frame(self, class_name: str, frame_index: int = 0) -> str:
        """One frame's 2D masks lifted (reference vizmask2d :530-548)."""
        recs = bio.load_frame_records(
            os.path.join(self.cfg.paths.mask_2d_dir, class_name, f"{self.scene_id}.pth"))
        rle.decode_frame_masks(
            recs, image_shape=(self.cfg.frames.height_2d, self.cfg.frames.width_2d))
        rec = recs[frame_index]
        from beyondff_tpu_torch.core import geometry
        from beyondff_tpu_torch.data.readers import build_dataset

        reader = build_dataset(self.cfg.paths.dataset,
                               os.path.join(self.cfg.paths.scene_2d_dir, self.scene_id))
        fid = str(rec["frame_id"]).rsplit(".", 1)[0]
        size = (self.cfg.frames.width_2d, self.cfg.frames.height_2d)
        member, _ = geometry.lift_frame_np(
            geometry.homogenize(self.xyz), reader.intrinsic(), reader.pose(fid),
            reader.depth(fid, size=size),
            np.asarray(rec["segmented_frame_masks"])[:, 0].astype(bool),
            self.cfg.frames.depth_thresh,
        )
        return self._masks_to_ply(f"mask2d_{class_name}_f{fid}", member, rec["labels"])

    def frame_overlay(self, class_name: str, frame_index: int = 0) -> str:
        """Annotated 2D frame: boxes (when recorded) and alpha-blended masks
        drawn on the RGB frame (reference: segmentation_2d_single.py:199-230
        draw_mask + supervision annotate; the reference's draw=True output).
        Returns the written PNG path."""
        import cv2

        recs = bio.load_frame_records(
            os.path.join(self.cfg.paths.mask_2d_dir, class_name, f"{self.scene_id}.pth"))
        rle.decode_frame_masks(
            recs, image_shape=(self.cfg.frames.height_2d, self.cfg.frames.width_2d))
        rec = recs[frame_index]
        from beyondff_tpu_torch.data.readers import build_dataset

        reader = build_dataset(self.cfg.paths.dataset,
                               os.path.join(self.cfg.paths.scene_2d_dir, self.scene_id))
        fid = str(rec["frame_id"]).rsplit(".", 1)[0]
        img = reader.image(fid)
        h, w = img.shape[:2]
        masks = np.asarray(rec["segmented_frame_masks"])[:, 0].astype(bool)
        if masks.shape[-2:] != (h, w):
            masks = np.stack([
                cv2.resize(m.astype(np.uint8), (w, h),
                           interpolation=cv2.INTER_NEAREST).astype(bool) for m in masks])
        out = img.astype(np.float32)
        colors = _palette(max(len(masks), 1), seed=1).astype(np.float32)
        for i, m in enumerate(masks):
            out[m] = 0.4 * out[m] + 0.6 * colors[i][None, :]
        out = out.astype(np.uint8)
        for i, m in enumerate(masks):
            ys, xs = np.nonzero(m)
            if not len(ys):
                continue
            c = tuple(int(v) for v in colors[i])
            cv2.rectangle(out, (xs.min(), ys.min()), (xs.max(), ys.max()), c, 2)
            label = str(rec["labels"][i]) if i < len(rec.get("labels", [])) else ""
            conf = rec.get("confidences")
            if conf is not None and i < len(conf):
                label = f"{label} {float(conf[i]):.2f}"
            cv2.putText(out, label, (int(xs.min()), max(12, int(ys.min()) - 4)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, c, 1, cv2.LINE_AA)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"{self.scene_id}_{class_name}_f{fid}_2d.png")
        if not cv2.imwrite(path, out[..., ::-1]):  # RGB -> BGR for imwrite
            raise IOError(f"failed to write {path}")
        return path

    def snapshot_png(self, ply_path: str) -> str:
        """Orthographic top + front scatter snapshot of an exported ply."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from beyondff_tpu_torch.utils.ply import read_ply_vertices

        v = read_ply_vertices(ply_path)
        xyz = np.stack([v["x"], v["y"], v["z"]], 1)
        rgb = np.stack([v["red"], v["green"], v["blue"]], 1) / 255.0
        fig, axes = plt.subplots(1, 2, figsize=(12, 6))
        step = max(1, len(xyz) // 60000)
        for ax, (a, b2), title in zip(axes, [(0, 1), (0, 2)], ["top (x-y)", "front (x-z)"]):
            ax.scatter(xyz[::step, a], xyz[::step, b2], c=rgb[::step], s=1)
            ax.set_title(title)
            ax.set_aspect("equal")
        out = ply_path[:-4] + ".png"
        fig.savefig(out, dpi=110, bbox_inches="tight")
        plt.close(fig)
        return out


def scannet200_bench(gt: Dict, inst_id: int) -> int:
    sel = gt["inst"] == inst_id
    if not sel.any():
        return -1
    return int(np.bincount(gt["sem"][sel][gt["sem"][sel] >= 0].astype(int)).argmax()) if (gt["sem"][sel] >= 0).any() else -1
