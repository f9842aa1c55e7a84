"""Resume checkpoints: per-class x per-scene and per-class x per-stage booleans.

Same YAML formats and granularities as the reference
(reference: tools/segmentation_2d.py:411-425, evaluation/eval/run_evl.py:28-54),
so an interrupted reference run can be resumed by this framework and vice
versa. The port's copy of beyondff_tpu/utils/checkpoint.py.
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


class SweepCheckpoint:
    """Per-class map of stage -> done flag (reference: run_evl.py:28-54)."""

    STAGES = ("segmentation", "projection", "refinement", "evaluation")

    def __init__(self, path: str = "process_checkpoint.txt"):
        self.path = path
        self._state: Dict[str, Dict[str, bool]] = {}
        if os.path.exists(path):
            with open(path) as f:
                self._state = yaml.safe_load(f) or {}

    def stage_done(self, class_name: str, stage: str) -> bool:
        return bool(self._state.get(class_name, {}).get(stage, False))

    def mark(self, class_name: str, stage: str, ok: bool = True) -> None:
        self._state.setdefault(class_name, {})[stage] = ok
        self.flush()

    def flush(self) -> None:
        """Write the current state once (bulk updates mutate ``_state`` then
        flush, avoiding one full-file rewrite per mark)."""
        with open(self.path, "w") as f:
            yaml.safe_dump(self._state, f)
