"""Checkpoints of training states.

Port of beyondff_tpu/training/checkpoint.py, which writes orbax
checkpoints. Here a state is one ``torch.save`` file: the module's
``state_dict``, the optimizer's ``state_dict`` and the step, read back with
``torch.load(weights_only=True)``. A tensor-parallel state saves each
rank's shards under its own path.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from beyondff_tpu_torch.training.trainer import TrainState


def save_params(path: str, state: TrainState) -> None:
    """Write ``state`` to ``path`` (its directory is created)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"module": state.module.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, path)


def load_params(path: str, like: Optional[TrainState] = None):
    """Read a saved state. With ``like`` (a state of the same module and
    optimizer, e.g. a fresh ``init_state``), load into it in place and
    return it; without, return the saved dict. The file is memory-mapped
    on the host and each tensor copied to its parameter's device (the
    optimizer's step counts stay on the host, where ``AdamW`` keeps them)."""
    saved = torch.load(os.path.abspath(path), map_location="cpu", mmap=True, weights_only=True)
    if like is None:
        return saved
    like.module.load_state_dict(saved["module"])
    like.optimizer.load_state_dict(saved["optimizer"])
    like.step = int(saved["step"])
    return like
