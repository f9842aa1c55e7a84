"""Resume checkpoints: per-class x per-scene booleans.

Same YAML format and granularity as the reference
(reference: tools/segmentation_2d.py:411-425), so an interrupted reference
run can be resumed by this framework and vice versa. The port's copy of
``SceneCheckpoint`` from beyondff_tpu/utils/checkpoint.py.
"""

from __future__ import annotations

import os
from typing import Dict

import yaml


class SceneCheckpoint:
    """Per-(stage, class) map of scene_id -> done flag."""

    def __init__(self, checkpoint_dir: str, stage: str, class_name: str):
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.path = os.path.join(checkpoint_dir, f"{stage}_checkpoint_{class_name}.yaml")
        self._state: Dict[str, bool] = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self._state = yaml.safe_load(f) or {}

    def done(self, scene_id: str) -> bool:
        return bool(self._state.get(scene_id, False))

    def mark(self, scene_id: str) -> None:
        self._state[scene_id] = True
        with open(self.path, "w") as f:
            yaml.safe_dump(self._state, f)
