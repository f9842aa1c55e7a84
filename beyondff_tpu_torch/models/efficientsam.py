"""EfficientSAM in PyTorch: a windowless plain-ViT encoder with SAM's prompt
encoder and mask decoder.

Port of beyondff_tpu/models/efficientsam.py, the fast variant's segmenter.
The module is the port's :class:`models.sam.SAMModule` with every encoder
block global and no relative-position tables, so on the card each block's
attention (4 096 tokens at 1024 px) runs the flash kernel with every key
valid. Box prompts take the best of the decoder's mask outputs by predicted
IoU, as the reference's EfficientSAM-S does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.models import sam as sam_mod
from beyondff_tpu_torch.models.convert_util import load_module, require_file
from beyondff_tpu_torch.models.layers import build
from beyondff_tpu_torch.models.sam import SAM, SAMConfig, SAMModule
from beyondff_tpu_torch.utils.host_copy import to_device

PRESETS = {
    # ViT-S (EfficientSAM-S) and ViT-T (EfficientSAM-Ti)
    "vits": SAMConfig(encoder_dim=384, encoder_depth=12, encoder_heads=6,
                      global_attn_indexes=tuple(range(12)), use_rel_pos=False),
    "vitt": SAMConfig(encoder_dim=192, encoder_depth=12, encoder_heads=3,
                      global_attn_indexes=tuple(range(12)), use_rel_pos=False),
    "test": SAMConfig(img_size=64, patch_size=8, encoder_dim=32, encoder_depth=2,
                      encoder_heads=2, global_attn_indexes=(0, 1), use_rel_pos=False,
                      prompt_dim=32, decoder_mlp_dim=64),
}


def best_of_multimask(module: SAMModule, embs: torch.Tensor, boxes: torch.Tensor):
    """Decode every prompt's masks and keep, per prompt, the one whose
    predicted IoU is highest over all the decoder's outputs (the first on
    ties). embs (N, g, g, d); boxes (N, 4) -> (N, 4g, 4g) logits, (N,) IoU."""
    sparse = module.prompt_encoder.encode_boxes(boxes)
    dense_pe = module.prompt_encoder.dense_pe(embs.shape[1], embs.shape[2], embs.device)
    no_mask = module.prompt_encoder.no_mask_embed.weight[0].to(embs.dtype)
    masks, iou = module.mask_decoder(embs + no_mask, dense_pe, sparse)
    best = torch.argmax(iou, dim=1)
    rows = torch.arange(masks.shape[0], device=masks.device)
    return masks[rows, best], iou[rows, best]


class EfficientSAM(SAM):
    """SAM wrapper whose box decode, the packed batch decode included, takes
    the best of the multimask outputs."""

    @classmethod
    def create(cls, name_or_cfg="vits", seed: int = 0, dtype=torch.float32,
               device=None) -> "EfficientSAM":
        cfg = PRESETS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
        return cls(cfg, build(lambda: SAMModule(cfg), resolve_device(device), dtype, seed))

    def _box_decode(self, embs: torch.Tensor, boxes: torch.Tensor):
        return best_of_multimask(self.module, embs, boxes)

    @torch.inference_mode()
    def decode_boxes_best(self, embedding: torch.Tensor, boxes) -> Tuple[torch.Tensor,
                                                                          torch.Tensor]:
        """embedding (g, g, d); boxes (B, 4) padded-square pixels -> the best
        mask's low-res logits (B, 4g, 4g) and its predicted IoU (B,)."""
        bx = to_device(boxes, self.device, torch.float32)
        return self._box_decode(embedding[None].expand(bx.shape[0], -1, -1, -1), bx)


def _grid_pos_embed(pos: torch.Tensor, cfg: SAMConfig) -> torch.Tensor:
    """A (1, tokens, d) position embedding -> the (1, g, g, d) grid, its
    class-token slot dropped when it has one (the JAX converter's rule)."""
    g = cfg.img_size // cfg.patch_size
    if pos.dim() == 3:
        if pos.shape[1] == g * g + 1:
            pos = pos[:, 1:]
        return pos.reshape(1, g, g, -1)
    return pos


def load_torch_checkpoint(path: str, cfg: SAMConfig, dtype=torch.float32,
                          device=None) -> SAMModule:
    """A public EfficientSAM checkpoint (``efficient_sam_vits.pt``, plain or
    wrapped in ``{"model": ...}``) -> :class:`SAMModule` on ``device``
    (``cuda`` unless named) in ``dtype``; every key loaded or ignored (the
    batch-norm counters and the mask-prompt stack, as for SAM)."""
    sd = torch.load(require_file(path, "EfficientSAM"), map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]
    sd = dict(sd)
    sd["image_encoder.pos_embed"] = _grid_pos_embed(sd["image_encoder.pos_embed"], cfg)
    return load_module(lambda: SAMModule(cfg), sd, sam_mod.IGNORED_CHECKPOINT_KEYS,
                       resolve_device(device), dtype, context="EfficientSAM checkpoint")
