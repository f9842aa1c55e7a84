"""Data-parallel frame batches over a process group, entered by the caller.

The JAX package shards a frame batch over every device of its one process
when the batch size divides by the device count
(``GroundingDINO.predict_batch``, ``SAM.encode_image``, the projection's
lifts); each device computes its own frames and the result is one global
array. Here the ranks are processes, and a group being up does not say
that they make the same calls (a multi-host ``SweepRunner`` gives each rank
its own classes). So the sharding is opt-in: inside :func:`shard_frames`
each rank of the default process group takes its contiguous slice of a batch
(:func:`data_parallel_slice`) and the per-rank results are gathered in rank
order (:func:`gather_frames`), so every rank returns what one rank
computing the whole batch would. Every rank of the group must then make
the same calls in the same order.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.distributed as dist

_DEPTH = [0]  # how many shard_frames blocks are open


@contextlib.contextmanager
def shard_frames() -> Iterator[None]:
    """Shard the stages' frame batches over the default process group
    inside the block. Raises ``RuntimeError`` with no initialized group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("shard_frames needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    _DEPTH[0] += 1
    try:
        yield
    finally:
        _DEPTH[0] -= 1


def frame_group():
    """The default group inside :func:`shard_frames` when it has more than
    one rank, else ``None``."""
    if not _DEPTH[0] or dist.get_world_size() <= 1:
        return None
    return dist.group.WORLD


def data_parallel_slice(n_frames: int) -> Optional[slice]:
    """This rank's contiguous slice of an ``n_frames`` batch, or ``None``
    outside :func:`shard_frames`, under a group of one rank, or when the
    batch does not divide by the group's size (the whole batch then runs on
    every rank)."""
    group = frame_group()
    if group is None:
        return None
    n = dist.get_world_size(group)
    if n_frames % n:
        return None
    k = n_frames // n
    r = dist.get_rank(group)
    return slice(r * k, (r + 1) * k)


def gather_frames(local: torch.Tensor) -> torch.Tensor:
    """Every rank's equal-shaped slice, concatenated in rank order along the
    first axis, over the group of :func:`frame_group`."""
    group = frame_group()
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)
