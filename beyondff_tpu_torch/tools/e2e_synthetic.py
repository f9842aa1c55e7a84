"""Synthetic end-to-end verification slice: 2D masks -> RLE .pth -> lift ->
aggregate -> filter -> 3D .pth.

The port's copy of scripts/e2e_synthetic.py: the same scene from the same
seed through the port's stage contracts and its lift on the card (or on the
CPU with ``--device cpu``). It writes ``mask2d/`` and ``mask3d/`` under the
working directory and imports nothing of JAX.

    python -m beyondff_tpu_torch.tools.e2e_synthetic [--device cpu]
"""

import argparse

import numpy as np
import torch

import beyondff_tpu_torch
from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.core import aggregation, filtering, geometry, rle
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.utils import io as bio


def main(argv=None):
    ap = argparse.ArgumentParser(description="synthetic end-to-end slice (PyTorch)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("package:", beyondff_tpu_torch.__name__, "device:", dev)
    cfg = Config.from_dict({"frames": {"width_2d": 64, "height_2d": 48}})
    rng = np.random.default_rng(1)
    h, w = 48, 64
    n_pts = 2000
    pts = rng.uniform([-1.5, -1.1, 2.45], [1.5, 1.1, 2.55], (n_pts, 3))
    obj_idx = np.arange(300)
    pts[obj_idx] = rng.uniform([-0.3, -0.3, 1.95], [0.3, 0.3, 2.05], (300, 3))
    pcd_h = geometry.homogenize(pts)
    intr = np.array([[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1.0]])
    poses = [np.eye(4) for _ in range(3)]
    poses[1][:3, 3] = [0.05, 0, 0]
    poses[2][:3, 3] = [-0.05, 0, 0]

    records, depths, projs, frame_masks = [], [], [], []
    for fi, pose in enumerate(poses):
        pts_cam = (np.linalg.inv(pose) @ pcd_h.astype(np.float64)).T[:, :3]
        uvw = intr @ pts_cam.T
        uv = np.round(uvw[:2] / pts_cam[:, 2]).astype(int)
        depth = np.zeros((h, w), np.float32)
        inb = (uv[0] >= 0) & (uv[0] < w) & (uv[1] >= 0) & (uv[1] < h)
        depth[uv[1, inb], uv[0, inb]] = pts_cam[inb, 2]
        mask2d = np.zeros((h, w), bool)
        obj_in = inb[obj_idx]
        mask2d[uv[1, obj_idx[obj_in]], uv[0, obj_idx[obj_in]]] = True
        depths.append(depth)
        projs.append(geometry.fuse_projection(intr, pose).astype(np.float32))
        frame_masks.append(mask2d)
        records.append({"frame_id": f"{fi}.jpg", "segmented_frame_masks": mask2d[None, None].copy(),
                        "confidences": [0.9], "labels": ["clothes"]})

    rle.encode_frame_masks(records)
    bio.save_frame_records("mask2d/clothes/scene_test.pth", records)
    loaded = bio.load_frame_records("mask2d/clothes/scene_test.pth")
    rle.decode_frame_masks(loaded, image_shape=(h, w))
    assert np.array_equal(loaded[0]["segmented_frame_masks"][0, 0].astype(bool), frame_masks[0])
    print("2D stage contract: save->load->decode OK")

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    membership, masked_counts, viewed_counts = geometry.lift_frames(
        on_dev(pcd_h), on_dev(np.stack(projs)), on_dev(np.stack(depths)),
        on_dev(np.stack([m.reshape(1, h * w) for m in frame_masks])),
        torch.ones((3, 1), dtype=torch.bool, device=dev), 0.08)
    member = membership.cpu().numpy().reshape(3, -1)
    print("lifted per-frame point counts:", member.sum(1), "| object size:", 300)

    agg = aggregation.aggregate(member, np.array([0.9, 0.9, 0.9]), ["clothes"] * 3,
                                iou_thres=0.2, min_aggregated_masks=2, device=dev)
    print("aggregated groups:", agg.groups, "label:", agg.labels)
    out = filtering.filter_masks(agg, masked_counts.cpu().numpy(), viewed_counts.cpu().numpy(),
                                 cfg.filtering)
    print("final masks:", out.ins.shape, "conf:", out.conf, "labels:", out.labels)
    assert out.ins.shape[0] == 1
    bio.save_stage_dict("mask3d/clothes/scene_test.pth", out.ins, out.conf, out.labels)
    back = bio.load_stage_dict("mask3d/clothes/scene_test.pth")
    assert np.array_equal(np.asarray(back["ins"]), out.ins) and back["final_class"] == ["clothes"]
    print("3D stage contract: save->load OK")
    print("END-TO-END SLICE: PASS")


if __name__ == "__main__":
    main()
