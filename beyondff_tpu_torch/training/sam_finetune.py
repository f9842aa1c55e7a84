"""SAM mask-decoder fine-tuning on lifted pseudo-labels.

Port of beyondff_tpu/training/sam_finetune.py. The pipeline's
multi-view-consistent 3D masks, re-projected into frames, can serve as
pseudo-ground-truth to adapt SAM's prompt decoder to the deployment domain.
The step takes precomputed image embeddings and optimizes the prompt
encoder and mask decoder with dice + sigmoid-BCE, the batch split over the
``data`` axis and the gradients averaged over it.

The JAX step calls its encoder frozen: it zeroes the encoder's gradients.
But its AdamW runs over the whole tree, and decoupled weight decay still
scales every encoder leaf by (1 - lr * wd) each step, so every non-zero
encoder leaf moves. The port keeps that behaviour: the encoder's
parameters get zero gradients (not ``None``, which ``AdamW`` would skip)
inside the same AdamW.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from beyondff_tpu_torch.training.trainer import TrainState, local_batch, new_state, reduce_grads


def mask_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """dice + BCE over low-res mask logits, in float32. logits/target: (B, H, W)."""
    target = target.float()
    logits = logits.float()
    bce = F.binary_cross_entropy_with_logits(logits, target)
    probs = torch.sigmoid(logits)
    inter = (probs * target).sum(dim=(1, 2))
    denom = probs.sum(dim=(1, 2)) + target.sum(dim=(1, 2))
    dice = 1.0 - (2 * inter + 1.0) / (denom + 1.0)
    return bce + dice.mean()


def decoder_loss(module, embeddings, boxes, targets) -> torch.Tensor:
    """embeddings (B, g, g, d), one a prompt; boxes (B, 4); targets (B, 4g,
    4g) binary. One ``decode_boxes`` call takes the whole batch (the JAX
    package's ``vmap`` over single-prompt decodes)."""
    masks, _iou = module.decode_boxes(embeddings, boxes)
    return mask_loss(masks, targets)


def frozen(name: str) -> bool:
    """The JAX tree's ``encoder`` subtree, the port's ``image_encoder``
    (the prompt encoder is the JAX tree's ``prompt`` and trains)."""
    return name.startswith("image_encoder.")


def make_sam_finetune_step(module, mesh, lr: float = 1e-4,
                           data_axis: str = "data") -> Tuple[Callable, Callable]:
    """Returns ``(init_state, train_step)``: data-parallel decoder
    fine-tuning. ``init_state(module)`` copies the module and builds its
    AdamW over every parameter; ``train_step(state, embeddings, boxes,
    targets)`` takes the global batch, runs this rank's slice, zeroes the
    image encoder's gradients, averages the gradients over ``data``, steps,
    and returns ``(state, loss)`` with the global mean loss. Embeddings from
    ``SAM.encode_frames`` are inference tensors: clone them outside
    ``torch.inference_mode`` first, or encode with ``module.encode`` under
    ``torch.no_grad``."""
    group = mesh.get_group(data_axis)
    n = mesh[data_axis].size()

    def init_state(src=module) -> TrainState:
        return new_state(src, lr)

    def train_step(state: TrainState, embeddings, boxes, targets):
        embeddings, boxes, targets = local_batch(mesh, (embeddings, boxes, targets), data_axis)
        state.optimizer.zero_grad(set_to_none=True)
        loss = decoder_loss(state.module, embeddings, boxes, targets)
        loss.backward()
        reduce_grads(state.module, group, frozen)
        state.optimizer.step()
        state.step += 1
        loss = loss.detach()
        if n > 1:
            torch.distributed.all_reduce(loss, group=group)
            loss /= n
        return state, loss

    return init_state, train_step
