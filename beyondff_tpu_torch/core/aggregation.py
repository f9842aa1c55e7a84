"""Multi-view 3D mask aggregation: vote merge + overlap resolution.

The port's copy of beyondff_tpu/core/aggregation.py, after the reference's
``aggregate``/``merge_masks``/``solve_overlapping`` (reference:
tools/projection_2d_to_3d.py:100-301). The (I, I) IoU matrix runs through the
mask-IoU kernel and the connected components through matmul squarings on the
masks' device; the small group bookkeeping and the order-dependent overlap
resolution stay on the host.

Parity-relevant semantics preserved:
  * merge graph = (IoU > iou_thres) AND exact-label-equality
    (projection_2d_to_3d.py:120-122); empty rows give nan IoU, and
    ``nan > thres`` is false;
  * components with fewer than ``min_aggregated_masks`` members are dropped
    entirely (projection_2d_to_3d.py:203);
  * merged confidence = mean of members, label = first member's label
    (projection_2d_to_3d.py:214-226);
  * components emitted in order of their smallest member index
    (projection_2d_to_3d.py:265-272);
  * overlap resolution walks pairs (i, j), i<j, in order and mutates masks
    as it goes — the mask aggregated from more views keeps disputed points
    (projection_2d_to_3d.py:277-301).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from beyondff_tpu_torch.core import masks as mask_ops
from beyondff_tpu_torch.kernels import mask_iou as kiou


@dataclass
class AggregatedMasks:
    ins: np.ndarray  # (C, N) bool
    conf: np.ndarray  # (C,) float32
    labels: List[str]
    groups: List[List[int]]  # member indices of each kept component

    @property
    def empty(self) -> bool:
        return self.ins.shape[0] == 0


def _empty(n_points: int) -> AggregatedMasks:
    return AggregatedMasks(ins=np.zeros((0, n_points), bool), conf=np.zeros((0,), np.float32),
                           labels=[], groups=[])


def aggregate(
    membership,  # (I, N) bool lifted per-(frame,mask) point masks, host or device
    confidences: np.ndarray,  # (I,) float
    labels: Sequence[str],
    iou_thres: float = 0.2,
    min_aggregated_masks: int = 2,
    device=None,
) -> AggregatedMasks:
    """Merge per-view masks that agree (IoU + label) into 3D instances, on
    ``device`` (``cuda`` unless the caller names another; a device tensor
    stays on its own device)."""
    if isinstance(membership, torch.Tensor):
        mem = membership.bool().contiguous()
    else:
        mem = mask_ops.as_mask(membership, mask_ops.resolve_device(device))
    n_ins = mem.shape[0]
    n_points = mem.shape[1] if mem.dim() == 2 else 0
    if n_ins == 0:
        return _empty(n_points)
    assert n_ins == len(labels) == len(np.asarray(confidences)), \
        f"{n_ins} lifted rows vs {len(labels)} labels"

    iou = kiou.pairwise_iou(mem).cpu().numpy()  # union 0 -> nan, never adjacent
    label_ids = _label_ids(labels)
    same_label = label_ids[:, None] == label_ids[None, :]
    with np.errstate(invalid="ignore"):
        adj = same_label & (iou > iou_thres)
    comp = mask_ops.connected_components(torch.as_tensor(adj, device=mem.device)).cpu().numpy()

    # components in order of smallest member index, filtered by size
    groups: List[List[int]] = []
    for rep in np.unique(comp):  # unique() is sorted -> first-member order
        members = np.flatnonzero(comp == rep)
        if members.size >= min_aggregated_masks:
            groups.append(members.tolist())
    if not groups:
        return _empty(n_points)

    onehot = np.zeros((len(groups), n_ins), bool)
    for c, members in enumerate(groups):
        onehot[c, members] = True
    merged, mean_conf = mask_ops.group_or_and_mean(mem, np.asarray(confidences, np.float32), onehot)
    return AggregatedMasks(
        ins=merged.cpu().numpy().astype(bool),
        conf=mean_conf.astype(np.float32),
        labels=[labels[g[0]] for g in groups],
        groups=groups,
    )


def aggregate_chunks(
    chunks,  # list of (device (F, m, N) bool, row_sizes) lift chunks
    n_points: int,
    confidences: np.ndarray,
    labels: Sequence[str],
    iou_thres: float = 0.2,
    min_aggregated_masks: int = 2,
) -> AggregatedMasks:
    """:func:`aggregate` over device-resident lift chunks.

    The per-view membership (I x N, hundreds of MB at full scene scale) never
    leaves the device: valid rows gather per chunk into one (I, N) matrix,
    the IoU matrix comes from the mask-IoU kernel, and only the (I, I) IoU
    plus the merged (C, N) masks come down to the host."""
    parts = []
    for dev, sizes in chunks:
        m = int(dev.shape[1])
        idx = [torch.arange(i * m, i * m + m_i) for i, m_i in enumerate(sizes) if m_i]
        if idx:
            flat = dev.reshape(-1, dev.shape[-1])
            parts.append(flat.index_select(0, torch.cat(idx).to(dev.device)))
    if not parts:
        return _empty(n_points)
    mem = torch.cat(parts)  # (I, N) bool, rows in frame-then-mask order
    return aggregate(mem, confidences, labels, iou_thres, min_aggregated_masks)


def solve_overlapping(agg: AggregatedMasks) -> AggregatedMasks:
    """Give disputed points to the mask aggregated from more views.

    Order-dependent sequential resolution; the overlap pair list is computed
    on the original masks, then applied with mutation in (i, j) order — exactly
    the reference's behaviour (projection_2d_to_3d.py:277-301).
    """
    ins = agg.ins.copy()
    num = [len(g) for g in agg.groups]
    c = ins.shape[0]
    pairs = [
        (i, j)
        for i in range(c)
        for j in range(i + 1, c)
        if np.any(agg.ins[i] & agg.ins[j])
    ]
    for i, j in pairs:
        if num[i] > num[j]:
            ins[j] &= ~ins[i]
        else:
            ins[i] &= ~ins[j]
    return AggregatedMasks(ins=ins, conf=agg.conf, labels=agg.labels, groups=agg.groups)


def _label_ids(labels: Sequence[str]) -> np.ndarray:
    table = {}
    ids = np.empty(len(labels), dtype=np.int32)
    for i, lab in enumerate(labels):
        ids[i] = table.setdefault(lab, len(table))
    return ids
