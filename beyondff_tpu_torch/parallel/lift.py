"""Frame-sharded 2D->3D lifting over the mesh's ``data`` axis.

Port of beyondff_tpu/parallel/lift.py. Frames are the batch axis: every
rank is given the whole chunk, lifts its contiguous slice of frames against
the replicated point cloud with ``core.geometry``, and the per-point
``masked_counts`` / ``viewed_counts`` are summed over ``data`` with one
``all_reduce`` each (the JAX package's ``psum`` under ``shard_map``). The
counts are integers, so the sums equal the one-device lift exactly.
``membership`` stays local: each rank returns its slice's (F/n, M, N).
The frame count must divide by the data size.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from beyondff_tpu_torch.core import geometry


def _shard(mesh, data_axis: str, n_frames: int) -> slice:
    n = mesh[data_axis].size()
    if n_frames % n:
        raise ValueError(f"{n_frames} frames do not split over {n} data ranks")
    k = n_frames // n
    r = mesh.get_local_rank(data_axis)
    return slice(r * k, (r + 1) * k)


def _sum(mesh, data_axis: str, *counts: torch.Tensor) -> None:
    group = mesh.get_group(data_axis)
    for c in counts:
        dist.all_reduce(c, group=group)


def make_sharded_lift(mesh, depth_thresh: float = 0.08, data_axis: str = "data"):
    """A function with :func:`geometry.lift_frames`'s signature (no
    ``depth_thresh``) lifting this rank's frames; counts summed over data."""

    def lift(pcd_h, projs, depths, masks, mask_valid):
        s = _shard(mesh, data_axis, projs.shape[0])
        membership, masked, viewed = geometry.lift_frames(
            pcd_h, projs[s], depths[s], masks[s], mask_valid[s], depth_thresh)
        _sum(mesh, data_axis, masked, viewed)
        return membership, masked, viewed

    return lift


def make_sharded_lift_packed(mesh, n_masks: int = 32, depth_thresh: float = 0.08,
                             data_axis: str = "data"):
    """Frame-sharded bit-packed lift (:func:`geometry.lift_frames_packed`):
    ``(pcd_h, projs, depths, masks_packed)``."""

    def lift(pcd_h, projs, depths, masks_packed):
        s = _shard(mesh, data_axis, projs.shape[0])
        membership, masked, viewed = geometry.lift_frames_packed(
            pcd_h, projs[s], depths[s], masks_packed[s], depth_thresh, n_masks=n_masks)
        _sum(mesh, data_axis, masked, viewed)
        return membership, masked, viewed

    return lift


def make_sharded_lift_rle(mesh, depth_thresh: float = 0.08, data_axis: str = "data"):
    """Frame-sharded RLE lift (:func:`geometry.lift_frames_rle`): per-mask
    run bounds shard with their frames. ``(pcd_h, projs, depths,
    run_starts, run_ends)``."""

    def lift(pcd_h, projs, depths, run_starts, run_ends):
        s = _shard(mesh, data_axis, projs.shape[0])
        membership, masked, viewed = geometry.lift_frames_rle(
            pcd_h, projs[s], depths[s], run_starts[s], run_ends[s], depth_thresh)
        _sum(mesh, data_axis, masked, viewed)
        return membership, masked, viewed

    return lift


def make_sharded_view_counts(mesh, depth_thresh: float = 0.08, data_axis: str = "data"):
    """Frame-sharded visibility counts (:func:`geometry.view_counts`),
    summed over data: ``(pcd_h, projs, depths) -> (N,)``."""

    def counts(pcd_h, projs, depths):
        s = _shard(mesh, data_axis, projs.shape[0])
        viewed = geometry.view_counts(pcd_h, projs[s], depths[s], depth_thresh)
        _sum(mesh, data_axis, viewed)
        return viewed

    return counts
