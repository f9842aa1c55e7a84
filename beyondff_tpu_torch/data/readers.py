"""Per-dataset frame readers: frame ids, intrinsics, poses, depth/RGB paths.

Rebuilds the reference's reader layer (reference: evaluation/dataset/
scannet_loader.py, replica_loader.py, s3dis_loader.py) with one shared base
class. Unlike the reference — where the stage tools re-implement file IO
inline and the readers only serve the Replica/S3DIS generalization path —
the pipeline stages here consume these readers directly. The port's copy of
beyondff_tpu/data/readers.py; depth PNGs decode with OpenCV.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from beyondff_tpu_torch.utils import io as bio


class FrameReader:
    """Posed RGB-D frame access for one scene."""

    depth_scale: float = 1000.0

    def __init__(self, scene_dir: str):
        self.scene_dir = scene_dir
        self.scene_id = os.path.basename(os.path.normpath(scene_dir))
        self.frame_ids = self._list_frames()

    # -------------------------------------------------------------- listing
    def _list_frames(self) -> List[str]:
        depth_dir = os.path.join(self.scene_dir, "depth")
        if not os.path.isdir(depth_dir):
            return []
        ids = [f.split(".")[0] for f in os.listdir(depth_dir)]
        try:
            ids.sort(key=int)
        except ValueError:
            ids.sort()
        return ids

    def __len__(self) -> int:
        return len(self.frame_ids)

    # --------------------------------------------------------------- access
    def intrinsic(self) -> np.ndarray:
        """(3,3) color-camera intrinsics."""
        raise NotImplementedError

    def pose(self, frame_id: str) -> np.ndarray:
        return bio.load_pose(os.path.join(self.scene_dir, "pose", f"{frame_id}.txt"))

    def depth(self, frame_id: str, size: Optional[tuple] = None) -> np.ndarray:
        return bio.load_depth(
            os.path.join(self.scene_dir, "depth", f"{frame_id}.png"),
            depth_scale=self.depth_scale,
            size=size,
        )

    def depth_raw(self, frame_id: str) -> np.ndarray:
        """Native-resolution raw uint16 depth (device-side scaling/resize)."""
        import cv2

        path = os.path.join(self.scene_dir, "depth", f"{frame_id}.png")
        d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if d is None:
            raise FileNotFoundError(path)
        return d

    def image(self, frame_id: str, size: Optional[tuple] = None) -> np.ndarray:
        return bio.load_image(
            os.path.join(self.scene_dir, "color", f"{frame_id}.jpg"), size=size
        )

    def image_path(self, frame_id: str) -> str:
        return os.path.join(self.scene_dir, "color", f"{frame_id}.jpg")

    def depth_path(self, frame_id: str) -> str:
        return os.path.join(self.scene_dir, "depth", f"{frame_id}.png")

    def frame(self, frame_id: str) -> Dict:
        return {
            "frame_id": frame_id,
            "pose": self.pose(frame_id),
            "intrinsics": self.intrinsic(),
            "depth_path": os.path.join(self.scene_dir, "depth", f"{frame_id}.png"),
            "image_path": self.image_path(frame_id),
        }


class ScanNetReader(FrameReader):
    """ScanNet(200/++) scenes (reference: scannet_loader.py:23-156)."""

    depth_scale = 1000.0
    GLOBAL_INTRINSIC = np.array(
        [[571.623718, 0.0, 319.5], [0.0, 571.623718, 239.5], [0.0, 0.0, 1.0]]
    )
    DEPTH_INTRINSIC = np.array(
        [[577.870605, 0.0, 319.5], [0.0, 577.870605, 239.5], [0.0, 0.0, 1.0]]
    )

    def intrinsic(self) -> np.ndarray:
        # per-scene color intrinsics (projection_2d_to_3d.py:370-376)
        path = os.path.join(self.scene_dir, "intrinsic", "intrinsic_color.txt")
        if os.path.exists(path):
            return bio.load_intrinsic(path)
        path = os.path.join(self.scene_dir, "intrinsic.txt")
        if os.path.exists(path):
            return bio.load_intrinsic(path)
        return self.GLOBAL_INTRINSIC


class ReplicaReader(FrameReader):
    """Replica scenes (reference: replica_loader.py:54-108)."""

    depth_scale = 6553.5

    def intrinsic(self) -> np.ndarray:
        path = os.path.join(self.scene_dir, "intrinsic.txt")
        if os.path.exists(path):
            return bio.load_intrinsic(path)
        raise FileNotFoundError(f"no intrinsic.txt in {self.scene_dir}")


class S3DISReader(FrameReader):
    """S3DIS areas (reference: s3dis_loader.py:21-275); npz pose files."""

    depth_scale = 512.0

    def pose(self, frame_id: str) -> np.ndarray:
        path = os.path.join(self.scene_dir, "pose", f"{frame_id}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                return z[z.files[0]].astype(np.float64)
        return super().pose(frame_id)

    def intrinsic(self) -> np.ndarray:
        path = os.path.join(self.scene_dir, "intrinsic.txt")
        return bio.load_intrinsic(path)


_READERS = {
    "scannet200": ScanNetReader,
    "scannet": ScanNetReader,
    "scannetpp": ScanNetReader,
    "replica": ReplicaReader,
    "s3dis": S3DISReader,
}


def build_dataset(dataset: str, scene_dir: str) -> FrameReader:
    """Reader factory (reference: evaluation/dataset/__init__.py:10-18)."""
    key = dataset.lower()
    if key not in _READERS:
        raise ValueError(f"unknown dataset {dataset!r}; known: {sorted(_READERS)}")
    return _READERS[key](scene_dir)
