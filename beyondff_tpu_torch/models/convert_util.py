"""Checkpoint loading with full key accounting.

The port's counterpart of beyondff_tpu/models/convert_util.py: every key of
a checkpoint is either loaded into the module or matched by a documented
ignore pattern, and leftovers raise with the list of keys.
:func:`load_module` is what the port's loaders share: a module built on
``meta``, checked key by key and shape by shape against the (normalised)
checkpoint, then materialised on its device and filled from the file's
tensors, so a full-width model is never built twice or initialised at random
first. It reports leftover, missing and mis-shaped keys in one error, where
the JAX package's ``assert_all_consumed`` reports leftovers alone.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Iterable, Mapping

import torch
from torch import nn


class ConversionError(RuntimeError):
    pass


class RecordingDict:
    """Dict wrapper recording which keys a converter consumed."""

    def __init__(self, data: dict):
        self.data = dict(data)
        self.consumed = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return self.data[key]

    def __contains__(self, key):
        return key in self.data

    def unconsumed(self, ignore: Iterable[str] = ()) -> list:
        pats = [re.compile(p) for p in ignore]
        return sorted(
            k for k in self.data
            if k not in self.consumed and not any(p.search(k) for p in pats)
        )


def require_file(path: str, what: str) -> str:
    """``path`` if it names a file; else ``FileNotFoundError``. A configured
    checkpoint that is missing is an error, never a reason to build a model
    with random weights."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{what} checkpoint not found: {path!r}")
    return path


def load_module(module_fn: Callable[[], nn.Module], state: Mapping[str, torch.Tensor],
                ignore: Iterable[str], device, dtype=torch.float32,
                context: str = "checkpoint") -> nn.Module:
    """Build ``module_fn()`` on ``device`` in ``dtype`` from a normalised
    checkpoint state dict.

    Raises :class:`ConversionError` in one pass, naming (first 20 of each)
    the checkpoint keys neither loaded nor matched by ``ignore``, the keys
    the module needs that the checkpoint lacks, and the shape mismatches.
    Each tensor is widened to float32 and then cast to ``dtype`` (the cast
    ``build(..., dtype=...)`` applies to initialised weights), one tensor at
    a time on the device. The returned module is in eval mode with gradients
    off, as :func:`layers.build` returns it."""
    with torch.device("meta"):
        module = module_fn()
    rd = RecordingDict(state)
    missing, shapes = [], []
    wanted = module.state_dict(keep_vars=True)
    for key, t in wanted.items():
        if key not in rd:
            missing.append(key)
            continue
        src = rd[key]
        if tuple(src.shape) != tuple(t.shape):
            shapes.append(f"{key}: checkpoint {tuple(src.shape)}, module {tuple(t.shape)}")
    left = rd.unconsumed(ignore)
    problems = []
    if left:
        problems.append(f"{len(left)} keys not consumed by the module (first 20): {left[:20]}")
    if missing:
        problems.append(f"{len(missing)} keys missing from the checkpoint (first 20): "
                        f"{missing[:20]}")
    if shapes:
        problems.append(f"{len(shapes)} shape mismatches (first 20): {shapes[:20]}")
    if problems:
        raise ConversionError(f"{context}: " + "; ".join(problems))
    module = module.to(dtype).to_empty(device=device)
    with torch.no_grad():
        for key, t in module.state_dict(keep_vars=True).items():
            t.copy_(state[key].to(device).float())
    return module.eval().requires_grad_(False)
