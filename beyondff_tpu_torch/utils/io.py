"""On-disk stage contracts and frame IO.

The port's copy of beyondff_tpu/utils/io.py. Stage outputs are per-scene:
  * 2D stage:   list of {frame_id, segmented_frame_masks (RLE), confidences, labels}
  * 3D stages:  {"ins": (I, N) bool | list[RLE], "conf": (I,), "final_class": list[str]}
serialized as ``.pth`` (torch pickle, byte-compatible with the reference) or
``.npz``. Frame IO (depth PNGs, poses, intrinsics, point clouds) matches the
reference's loaders; a depth map resized on the host decodes through the
native runtime (utils/native.py), as in the JAX package, and through OpenCV
without a size or under ``BFF_NO_NATIVE``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _tree_to_numpy(obj):
    if isinstance(obj, dict):
        return {k: _tree_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_tree_to_numpy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def load_stage_dict(path: str) -> Dict:
    """Load a 3D-stage output ({"ins","conf","final_class"}) from .pth or .npz."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=True) as z:
            return {"ins": z["ins"], "conf": z["conf"], "final_class": list(z["final_class"])}
    return _tree_to_numpy(torch.load(path, map_location="cpu", weights_only=False))


def save_stage_dict(path: str, ins, conf, final_class: Sequence[str]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npz"):
        np.savez_compressed(path, ins=np.asarray(ins), conf=np.asarray(conf, dtype=np.float32),
                            final_class=np.asarray(list(final_class), dtype=object))
        return
    torch.save({"ins": torch.from_numpy(np.ascontiguousarray(np.asarray(ins))),
                "conf": torch.from_numpy(np.asarray(conf, dtype=np.float32)),
                "final_class": list(final_class)}, path)


def load_frame_records(path: str) -> List[Dict]:
    """Load a 2D-stage output (list of per-frame records, masks RLE-encoded)."""
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=True) as z:
            return list(z["records"])
    return _tree_to_numpy(torch.load(path, map_location="cpu", weights_only=False))


def save_frame_records(path: str, records: List[Dict]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".npz"):
        np.savez_compressed(path, records=np.asarray(records, dtype=object))
        return
    out = []
    for rec in records:
        r = dict(rec)
        r["confidences"] = torch.from_numpy(
            np.asarray(r.get("confidences", []), dtype=np.float32))
        out.append(r)
    torch.save(out, path)


def load_pose(path: str) -> np.ndarray:
    return np.loadtxt(path).astype(np.float64)


def load_intrinsic(path: str) -> np.ndarray:
    return np.loadtxt(path)[:3, :3].astype(np.float64)


def load_depth(path: str, depth_scale: float = 1000.0, size: Optional[tuple] = None) -> np.ndarray:
    """Metric depth map; optionally resized to (width, height) with OpenCV's
    bilinear convention (reference: projection_2d_to_3d.py:431-436), by the
    native decoder when it runs."""
    if size is not None:
        from beyondff_tpu_torch.utils import native

        out = native.decode_depth_native(path, depth_scale, (size[1], size[0]))
        if out is not None:
            return out
    import cv2

    depth = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if depth is None:
        raise FileNotFoundError(path)
    depth = depth.astype(np.float32) / depth_scale
    if size is not None and (depth.shape[1], depth.shape[0]) != size:
        depth = cv2.resize(depth, size)  # INTER_LINEAR, like the reference
    return depth


def load_image(path: str, size: Optional[tuple] = None) -> np.ndarray:
    """RGB uint8 (H, W, 3); optionally resized to (width, height). Decodes
    with OpenCV (and resizes with PIL, as the reference does); a caller
    without them hands frames in through ``Segmentor2D(frame_loader=...)``."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if size is not None and (img.shape[1], img.shape[0]) != size:
        from PIL import Image

        # the reference resizes RGB with PIL (tools/segmentation_2d.py:250-254)
        img = np.array(Image.fromarray(img).resize(size))
    return img


def list_scene_frames(scene_2d_dir: str, scene_id: str, downsample_ratio: int = 1) -> List[str]:
    """Numerically-sorted frame ids (no extension), strided by downsample_ratio
    (reference: tools/segmentation_2d.py:469-478)."""
    color_dir = os.path.join(scene_2d_dir, scene_id, "color")
    files = [f for f in os.listdir(color_dir) if f.endswith(".jpg")]
    files.sort(key=lambda x: int(x.split(".")[0]))
    return [f[:-4] for f in files[::downsample_ratio]]


def load_point_cloud(scene_npy_dir: str, scene_id: str) -> np.ndarray:
    """(N, 3) xyz from the preprocessed per-scene .npy
    (reference: projection_2d_to_3d.py:385-387)."""
    return np.load(os.path.join(scene_npy_dir, f"{scene_id}.npy"))[:, :3]
