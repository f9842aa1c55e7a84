"""On-disk stage contracts and frame IO for the 2D stage.

The port's copy of the parts of beyondff_tpu/utils/io.py that the 2D stage
uses. The 2D-stage output is a per-scene list of records
{frame_id, segmented_frame_masks (RLE), confidences, labels}, serialized as
``.pth`` (torch pickle, byte-compatible with the reference) or ``.npz``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

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
