"""Loader for the public ``groundingdino_swin{b,t}_*.pth`` checkpoints.

The port's counterpart of beyondff_tpu/models/gdino/convert.py. The port's
:class:`GDINOModule` carries the upstream module names (``backbone.0`` Swin,
``bert`` HF BertModel, ``feat_map``, ``input_proj``,
``transformer.encoder.{layers,text_layers,fusion_layers}``,
``transformer.decoder.layers``, one shared ``bbox_embed``), so loading is
unwrapping and key accounting, not a re-mapping: every checkpoint key is
loaded or matched by :data:`IGNORED_CHECKPOINT_KEYS`, and leftover, missing
or mis-shaped keys raise together.
"""

from __future__ import annotations

from typing import Dict

import torch

from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.models.convert_util import load_module, require_file
from beyondff_tpu_torch.models.gdino.model import GDINOConfig, GDINOModule

# checkpoint keys that are legitimately not part of the inference graph:
# the BERT pooler head (unused by Grounding-DINO), HF position-id buffers,
# and the duplicated names that module sharing produces in the state dict
# (decoder bbox_embed is one shared MLP registered under every layer index
# and again under transformer.decoder, upstream groundingdino.models)
IGNORED_CHECKPOINT_KEYS = (
    r"bert\.pooler\.",
    r"position_ids$",
    r"^bbox_embed\.[1-9]\d*\.",
    r"^transformer\.decoder\.bbox_embed\.",
    r"^label_enc\.",
    r"num_batches_tracked$",
    # Swin registers these as persistent buffers; they are pure index tables
    # that the port's Swin recomputes from the window size
    r"relative_position_index$",
    r"attn_mask$",
)


def normalise(ckpt: Dict) -> Dict[str, torch.Tensor]:
    """``{"model": state}`` wrappers unwrapped and ``module.`` (from
    ``DataParallel`` saves) stripped, as the JAX converter reads the file."""
    sd = ckpt.get("model", ckpt)
    return {k.replace("module.", ""): v for k, v in sd.items()}


def load_torch_checkpoint(path: str, cfg: GDINOConfig, dtype=torch.float32,
                          device=None) -> GDINOModule:
    """An official Grounding-DINO checkpoint file -> :class:`GDINOModule` on
    ``device`` (``cuda`` unless named) in ``dtype``."""
    ckpt = torch.load(require_file(path, "Grounding-DINO"), map_location="cpu",
                      weights_only=False)
    return load_module(lambda: GDINOModule(cfg), normalise(ckpt), IGNORED_CHECKPOINT_KEYS,
                       resolve_device(device), dtype, context="Grounding-DINO checkpoint")
