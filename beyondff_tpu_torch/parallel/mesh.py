"""Device mesh, placements and the tensor-parallel rule on torch.distributed.

Port of beyondff_tpu/parallel/mesh.py. The mesh is a ``DeviceMesh`` over the
ranks of the default process group, shaped (model, data) with ``data``
innermost, as the JAX package lays out its ``Mesh``; ``Shard`` / ``Replicate``
placements stand where the JAX package builds ``NamedSharding``s. The
tensor-parallel rule is a ``parallelize_module`` plan over the port's
``nn.Linear``s: column-parallel up-projections with their output gathered,
row-parallel down-projections with their input split from a replicated
activation, so every other layer runs on plain tensors.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.parallel import (ColwiseParallel, ParallelStyle, RowwiseParallel,
                                               parallelize_module)

from beyondff_tpu_torch.kernels.dispatch import resolve_device


def make_mesh(data: int = -1, model: int = 1, device_type: Optional[str] = None,
              data_axis: str = "data", model_axis: str = "model") -> DeviceMesh:
    """(model, data) mesh over the ranks of the default process group.

    ``data=-1`` takes every rank not claimed by ``model``; a size that does
    not factor the world raises ``ValueError``. The data axis is innermost,
    so the ranks of one data group are consecutive. ``device_type``
    defaults to ``cuda`` and raises without a card; pass ``"cpu"`` for
    gloo. The caller initializes the process group
    (``torch.distributed.init_process_group``) with its own address."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(torch.distributed.init_process_group)")
    dev = resolve_device(device_type)
    n = dist.get_world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return init_device_mesh(dev.type, (model, data), mesh_dim_names=(model_axis, data_axis))


def data_sharding(mesh: DeviceMesh, ndim: int, axis: int = 0,
                  data_axis: str = "data") -> Tuple:
    """Placements sharding dimension ``axis`` of an ``ndim``-d tensor over
    the data axis and replicating it over the others."""
    if not -ndim <= axis < ndim:
        raise ValueError(f"axis {axis} out of range for {ndim} dimensions")
    return tuple(Shard(axis % ndim) if name == data_axis else Replicate()
                 for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(),) * mesh.ndim


# ------------------------------------------------------------ TP param rules
# The JAX rule shards dense kernels by their flax parent name: q, k, v, qkv,
# fc1, mlp_fc1 and value_proj by column, proj, fc2, mlp_fc2, attn_out,
# output_proj and out_proj by row. The port's modules keep the official
# checkpoints' names, so the same layers match these patterns of their
# dotted module names (the JAX name each one carries in brackets).
_COLUMN = tuple(re.compile(p) for p in (
    r"(^|\.)attn\.qkv$",                                         # SAM, Swin [qkv]
    r"(^|\.)mlp\.(c_fc|lin1|fc1)$",                              # CLIP, SAM, Swin [fc1, mlp_fc1]
    r"(^|\.)(self_attn|cross_attn_\w+|final_attn_\w+)\.[qkv]_proj$",  # SAM decoder [q, k, v]
    r"\.attention\.self\.(query|key|value)$",                    # BERT [q, k, v]
    r"\.intermediate\.dense$",                                   # BERT [fc1]
    r"\.value_proj$",                                            # deformable attn [value_proj]
    r"\.decoder\.layers\.\d+\.linear1$",                         # GDINO decoder [fc1]
    r"bbox_embed(\.\d+)?\.layers\.1$",                           # GDINO box heads [fc1]
))
_ROW = tuple(re.compile(p) for p in (
    r"(^|\.)attn\.proj$",                                        # SAM, Swin [proj]
    r"\.out_proj$",                                              # attention outputs [proj]
    r"(^|\.)mlp\.(c_proj|lin2|fc2)$",                            # CLIP, SAM, Swin [fc2, mlp_fc2]
    r"\.attention\.output\.dense$",                              # BERT [attn_out]
    r"\.layer\.\d+\.output\.dense$",                             # BERT [fc2]
    r"\.output_proj$",                                           # deformable attn [output_proj]
    r"\.decoder\.layers\.\d+\.linear2$",                         # GDINO decoder [fc2]
    r"bbox_embed(\.\d+)?\.layers\.2$",                           # GDINO box heads [fc2]
))


def tensor_parallel_spec(name: str, module: nn.Module) -> Optional[ParallelStyle]:
    """The parallel style of the submodule ``name``: column-parallel
    (weight ``Shard(0)``, the JAX ``P(None, model)`` of an (in, out) kernel;
    bias ``Shard(0)``; output gathered) for the up-projections, row-parallel
    (weight ``Shard(1)``; bias replicated; input split from a replicated
    activation, output all-reduced) for the down-projections, ``None``
    (replicated) for everything else. Only ``nn.Linear``s are sharded: a
    convolution or a bare parameter, such as ``layers.Attention``'s packed
    ``in_proj_weight``, stays replicated."""
    if not isinstance(module, nn.Linear):
        return None
    if any(p.search(name) for p in _COLUMN):
        return ColwiseParallel(output_layouts=Replicate())
    if any(p.search(name) for p in _ROW):
        return RowwiseParallel(input_layouts=Replicate())
    return None


def shard_params(module: nn.Module, mesh: DeviceMesh, rule=tensor_parallel_spec,
                 model_axis: str = "model") -> nn.Module:
    """Shard ``module``'s matching Linears over the model axis, in place,
    each parameter keeping its ``requires_grad``; returns the module."""
    plan = {}
    for name, sub in module.named_modules():
        style = rule(name, sub)
        if style is not None:
            plan[name] = style
    if plan:
        wants_grad = {name: p.requires_grad for name, p in module.named_parameters()}
        parallelize_module(module, mesh[model_axis], plan)
        for name, p in module.named_parameters():
            p.requires_grad_(wants_grad[name])
    return module
