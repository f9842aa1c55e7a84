"""Generate a synthetic ScanNet200-layout dataset for end-to-end pipeline tests.

Creates a small room (floor + wall + object blobs), renders posed RGB-D frames
with a z-buffer point splatter, derives ground-truth-perfect 2D masks, stage-1
RLE masks, and GT files — the full on-disk layout the three stage CLIs expect
(BASELINE.json config[0]: precomputed 2D masks -> projection -> refinement).

The port's copy of scripts/make_synthetic_scene.py, with the same arguments:
on the same seed it writes the same files (PNG and JPEG bytes; ``.pth``,
``.npy``, ``.txt`` and ``.yaml`` contents, the YAML's
``detector.waffle_word_list_path`` naming this package's word list). It
imports nothing of JAX, so it runs where only PyTorch is installed.

    python -m beyondff_tpu_torch.tools.make_synthetic_scene /tmp/bffscene [--cls clothes]
"""

import argparse
import os

import numpy as np

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.core import geometry, rle
from beyondff_tpu_torch.data import scannet200
from beyondff_tpu_torch.utils import io as bio

W2D, H2D = 324, 242  # quarter of the real 1296x968; keeps tests fast
DEPTH_W, DEPTH_H = 160, 120


def build_scene(rng, query, replica_labels: bool = False):
    """Point cloud with 2 query-class objects, 1 distractor, background."""
    pts, sem, inst = [], [], []

    def add_blob(center, size, n, sem_id, inst_id):
        # thin along z (< depth tolerance) so the whole object passes the
        # visibility test — keeps the fixture far from decision boundaries
        p = rng.uniform(-1.0, 1.0, (n, 3)) * np.asarray(size) + np.asarray(center)
        pts.append(p)
        sem.append(np.full(n, sem_id))
        inst.append(np.full(n, inst_id))

    if replica_labels:
        from beyondff_tpu_torch.data import replica as replica_mod

        # replica eval: sem' = sem + 0; pred label = index+1 -> sem = index+1
        q_sem = replica_mod.INSTANCE_CAT_REPLICA.index(query) + 1
        t_sem = replica_mod.INSTANCE_CAT_REPLICA.index("table") + 1
    else:
        q_sem = scannet200.raw_semantic_id(query)
        t_sem = scannet200.raw_semantic_id("table")
    add_blob([-0.8, 0.0, 2.2], [0.25, 0.25, 0.02], 900, q_sem, 0)
    add_blob([0.8, 0.2, 2.6], [0.25, 0.25, 0.02], 900, q_sem, 1)
    add_blob([0.0, -0.8, 2.4], [0.25, 0.25, 0.02], 900, t_sem, 2)
    # background wall (z=3.4) and floor (y=1.2)
    wall = np.column_stack([rng.uniform(-2, 2, 2500), rng.uniform(-1.5, 1.5, 2500), rng.uniform(3.3, 3.5, 2500)])
    floor = np.column_stack([rng.uniform(-2, 2, 2500), rng.uniform(1.1, 1.3, 2500), rng.uniform(1.0, 3.5, 2500)])
    for bg in (wall, floor):
        pts.append(bg)
        sem.append(np.zeros(len(bg)))
        inst.append(np.full(len(bg), -100))
    return (
        np.concatenate(pts).astype(np.float32),
        np.concatenate(sem).astype(np.int32),
        np.concatenate(inst).astype(np.int32),
    )


def camera_poses(n_frames=6):
    poses = []
    for k in range(n_frames):
        th = 0.12 * (k - n_frames / 2)
        c, s = np.cos(th), np.sin(th)
        pose = np.eye(4)
        pose[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        pose[:3, 3] = [0.4 * np.sin(th), 0.0, 0.0]
        poses.append(pose)
    return poses


def render_depth(pts_world, pose, intr, h, w):
    """Min-z z-buffer splat of the cloud into a (h, w) depth map."""
    pcd_h = geometry.homogenize(pts_world)
    cam = (np.linalg.inv(pose) @ pcd_h.astype(np.float64)).T[:, :3]
    uvw = intr @ cam.T
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = np.round(uvw[:2] / cam[:, 2]).astype(np.int64)
    z = cam[:, 2]
    ok = (z > 0.1) & (uv[0] >= 0) & (uv[0] < w) & (uv[1] >= 0) & (uv[1] < h)
    depth = np.full((h, w), np.inf)
    flat = uv[1, ok] * w + uv[0, ok]
    np.minimum.at(depth.ravel(), flat, z[ok])
    depth[np.isinf(depth)] = 0.0
    return depth.astype(np.float32)


def generate(root: str, query: str = "clothes", scenes: int = 1, seed: int = 7,
             dataset: str = "Scannet200") -> str:
    """Create the dataset under ``root``; returns the config path.

    ``dataset="replica"`` writes the Replica layout (scene-root intrinsic.txt,
    depth scale 6553.5, GT semantics as direct class indices)."""
    rng = np.random.default_rng(seed)
    replica = dataset.lower() == "replica"
    depth_scale = 6553.5 if replica else 1000.0

    import cv2
    import torch

    intr_color = np.array([[160.0, 0, W2D / 2], [0, 160.0, H2D / 2], [0, 0, 1.0]])

    for si in range(scenes):
        scene_id = f"scene{si:04d}_00"
        pts, sem, inst = build_scene(rng, query, replica_labels=replica)
        d2 = os.path.join(root, "Scannet200_2D", scene_id)
        for sub in ("color", "depth", "pose", "intrinsic"):
            os.makedirs(os.path.join(d2, sub), exist_ok=True)
        intr4 = np.eye(4)
        intr4[:3, :3] = intr_color
        if replica:
            np.savetxt(os.path.join(d2, "intrinsic.txt"), intr4)
        else:
            np.savetxt(os.path.join(d2, "intrinsic", "intrinsic_color.txt"), intr4)

        records = []
        for fi, pose in enumerate(camera_poses()):
            fid = str(fi)
            np.savetxt(os.path.join(d2, "pose", f"{fid}.txt"), pose)
            # depth rendered directly at color resolution (no resize aliasing)
            depth = render_depth(pts, pose, intr_color, H2D, W2D)
            cv2.imwrite(os.path.join(d2, "depth", f"{fid}.png"),
                        (depth * depth_scale).astype(np.uint16))
            img = rng.integers(0, 255, (H2D, W2D, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(d2, "color", f"{fid}.jpg"), img)

            # GT-perfect 2D masks at color resolution from the visibility model
            depth_color = depth
            pcd_h = geometry.homogenize(pts)
            masks = []
            for iid in (0, 1):  # the query objects
                obj = inst == iid
                member, _ = geometry.lift_frame_np(
                    pcd_h[:, obj], intr_color, pose, depth_color, np.ones((1, H2D, W2D), bool)
                )
                cam = (np.linalg.inv(pose) @ pcd_h[:, obj].astype(np.float64)).T[:, :3]
                uvw = intr_color @ cam.T
                uv = np.round(uvw[:2] / cam[:, 2]).astype(np.int64)
                m2 = np.zeros((H2D, W2D), bool)
                vis = member[0]
                m2[uv[1, vis], uv[0, vis]] = True
                m2 = cv2.dilate(m2.astype(np.uint8), np.ones((3, 3), np.uint8)).astype(bool)
                if m2.sum() > 40:
                    masks.append(m2)
            if masks:
                records.append(
                    {
                        "frame_id": f"{fid}.jpg",
                        "segmented_frame_masks": np.stack(masks)[:, None],
                        "confidences": [0.9] * len(masks),
                        "labels": [query] * len(masks),
                    }
                )

        d3 = os.path.join(root, "Scannet200_3D")
        os.makedirs(os.path.join(d3, "original_npy_files"), exist_ok=True)
        os.makedirs(os.path.join(d3, "groundtruth"), exist_ok=True)
        np.save(os.path.join(d3, "original_npy_files", f"{scene_id}.npy"),
                np.concatenate([pts, np.zeros_like(pts)], axis=1))
        torch.save(
            (pts, np.zeros_like(pts), sem.astype(np.float64), inst.astype(np.float64)),
            os.path.join(d3, "groundtruth", f"{scene_id}.pth"),
        )

        # stage-1: slightly degraded GT masks for objects 0 and 2, RLE + int labels
        s1_dir = os.path.join(root, "stage1")
        os.makedirs(s1_dir, exist_ok=True)
        s1_masks, s1_labels = [], []
        if replica:
            from beyondff_tpu_torch.data import replica as replica_mod

            label_index = replica_mod.INSTANCE_CAT_REPLICA.index
        else:
            label_index = scannet200.instance_index
        for iid, lab in [(0, query), (1, query), (2, "table")]:
            m = (inst == iid).copy()
            on = np.flatnonzero(m)
            m[on[rng.random(on.size) < 0.06]] = False  # drop 6% of points
            s1_masks.append(rle.rle_encode(m))
            s1_labels.append(label_index(lab))
        torch.save(
            {"ins": s1_masks, "conf": torch.ones(len(s1_masks)) * 0.7,
             "final_class": s1_labels},
            os.path.join(s1_dir, f"{scene_id}.pth"),
        )

        # 2D-stage output (RLE) — normally produced by segmentation_2d
        rle.encode_frame_masks(records)
        bio.save_frame_records(os.path.join(root, "mask_2d", query, f"{scene_id}.pth"), records)

    cfg = Config.from_dict(
        {
            "paths": {
                "dataset": dataset,
                "root_dir": root,
                "scene_npy_dir": os.path.join(root, "Scannet200_3D", "original_npy_files"),
                "scene_2d_dir": os.path.join(root, "Scannet200_2D"),
                "gt_dir": os.path.join(root, "Scannet200_3D", "groundtruth"),
                "mask_2d_dir": os.path.join(root, "mask_2d"),
                "mask_3d_dir": os.path.join(root, "mask_3d"),
                "stage_1_results_dir": os.path.join(root, "stage1"),
                "final_output_dir": os.path.join(root, "final_output"),
                "checkpoint_dir": os.path.join(root, "checkpoints"),
                "results_dir": os.path.join(root, "eval_results"),
            },
            "frames": {"width_2d": W2D, "height_2d": H2D, "downsample_ratio": 1,
                       "depth_scale": depth_scale},
            "aggregation": {"min_aggregated_masks": 2},
            "base_prompt": query,
        }
    )
    cfg_path = os.path.join(root, "config.yaml")
    cfg.to_yaml(cfg_path)
    return cfg_path


def main(argv=None):
    ap = argparse.ArgumentParser(description="synthetic ScanNet200-layout scene")
    ap.add_argument("root")
    ap.add_argument("--cls", default="clothes")
    ap.add_argument("--scenes", type=int, default=1)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--dataset", default="Scannet200")
    args = ap.parse_args(argv)
    generate(args.root, args.cls, args.scenes, args.seed, dataset=args.dataset)
    print(f"synthetic dataset at {args.root}: {args.scenes} scene(s), query={args.cls!r}")


if __name__ == "__main__":
    main()
