"""Data- and tensor-parallel training steps on torch.distributed.

Port of beyondff_tpu/training/trainer.py. The canonical task is CLIP-style
contrastive tuning: batches of (box crop, prompt) pairs align the image and
text towers to the deployment vocabulary. Where the JAX package jits one
program over a mesh and lets XLA place the collectives, each rank here runs
its own step: the Linears are tensor-parallel over ``model``
(``parallel.mesh.shard_params``), every rank takes its contiguous slice of
the batch over ``data``, and the gradients are averaged over ``data``.

The contrastive loss is over the global batch, one (B, B) matrix as in the
JAX step, not an average of per-shard losses over (B/n, B/n) blocks (what a
``DistributedDataParallel`` wrapper would compute). So both towers' features
are gathered over ``data`` with gradients, every rank computes the same
global loss, and the gather's backward sums each rank's rows over the n
ranks: each rank's parameter gradients come out n times its share, and the
average over ``data`` of their sum is the gradient of the global loss.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from beyondff_tpu_torch.parallel import mesh as mesh_lib


@dataclass
class TrainState:
    module: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


class _GatherRows(torch.autograd.Function):
    """``all_gather`` along dim 0 over ``group``, equal rows a rank; the
    backward gives each rank the sum over ranks of its rows' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        ctx.start = dist.get_rank(group) * x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.start:ctx.start + ctx.rows], None


def clip_contrastive_loss(module, images, tokens, group=None) -> torch.Tensor:
    """Symmetric InfoNCE over the in-batch similarity matrix. With a
    ``group`` of more than one rank, ``images``/``tokens`` are this rank's
    slice and the matrix spans the group's whole batch (gathered features,
    the same loss on every rank)."""
    img, txt = module.embed(images, tokens)
    if group is not None and dist.get_world_size(group) > 1:
        img, txt = _GatherRows.apply(img, group), _GatherRows.apply(txt, group)
    logits = module.logits(img, txt)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def make_optimizer(params, lr: float = 1e-5, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """optax.adamw's defaults: betas (0.9, 0.999), eps 1e-8, and the same
    settings for every parameter, so biases and norms decay too. The
    tensor-parallel shards (``DTensor``s) and the plain tensors go into two
    groups of those settings: AdamW's multi-tensor kernels take one kind
    of tensor at a time."""
    params = list(params)
    kinds = ([p for p in params if isinstance(p, DTensor)],
             [p for p in params if not isinstance(p, DTensor)])
    return torch.optim.AdamW([{"params": group} for group in kinds if group], lr=lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def new_state(module: nn.Module, lr: float, mesh=None) -> TrainState:
    """A trainable copy of ``module`` (the caller's inference weights stay
    as they are, as the JAX step donates only its own copy), in train mode
    with gradients on, tensor-parallel over ``mesh``'s model axis when a
    mesh is given, and its AdamW."""
    module = copy.deepcopy(module).train().requires_grad_(True)
    if mesh is not None:
        mesh_lib.shard_params(module, mesh)
    return TrainState(module, make_optimizer(module.parameters(), lr))


def local_batch(mesh, arrays: Sequence[torch.Tensor],
                data_axis: str = "data") -> Tuple[torch.Tensor, ...]:
    """This rank's contiguous slice along dim 0 of each global array."""
    n = mesh[data_axis].size()
    b = arrays[0].shape[0]
    if b % n or any(a.shape[0] != b for a in arrays):
        raise ValueError(f"batch {[a.shape[0] for a in arrays]} does not split over "
                         f"{n} data ranks")
    r, k = mesh.get_local_rank(data_axis), b // n
    return tuple(a[r * k:(r + 1) * k] for a in arrays)


@torch.no_grad()
def reduce_grads(module: nn.Module, group, frozen: Optional[Callable[[str], bool]] = None):
    """Every parameter gets a gradient, as every leaf does under
    ``jax.grad``: one the loss never reached gets zeros (``AdamW`` skips a
    ``None`` gradient, and would then skip its decay, which optax applies),
    and so does one that ``frozen(name)`` names. Then the gradients are
    averaged over ``group`` (the local shards of tensor-parallel ones)."""
    n = dist.get_world_size(group) if group is not None else 1
    for name, p in module.named_parameters():
        if p.grad is None or (frozen is not None and frozen(name)):
            p.grad = torch.zeros_like(p)
        if n > 1:
            g = p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
            dist.all_reduce(g, group=group)
            g.div_(n)


def make_sharded_train_step(module: nn.Module, mesh, loss_fn: Callable = clip_contrastive_loss,
                            lr: float = 1e-5,
                            data_axis: str = "data") -> Tuple[Callable, Callable]:
    """Returns ``(init_state, train_step)`` over ``mesh``.

    * ``init_state(module)``: a trainable copy, its Linears tensor-parallel
      over ``model``, and its AdamW;
    * ``train_step(state, images, tokens)``: the global batch in, this
      rank's slice over ``data`` through ``loss_fn(module, images, tokens,
      group)``, gradients averaged over ``data``, one AdamW step; returns
      ``(state, loss)`` with the global loss.
    """
    group = mesh.get_group(data_axis)

    def init_state(src: nn.Module = module) -> TrainState:
        return new_state(src, lr, mesh)

    def train_step(state: TrainState, images, tokens):
        images, tokens = local_batch(mesh, (images, tokens), data_axis)
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.module, images, tokens, group)
        loss.backward()
        reduce_grads(state.module, group)
        state.optimizer.step()
        state.step += 1
        return state, loss.detach()

    return init_state, train_step
