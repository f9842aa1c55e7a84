"""Boolean-mask algebra: pairwise IoU through the mask-IoU kernel, connected
components by log-step matmul squaring.

The port's copy of beyondff_tpu/core/masks.py. The reference computes mask
IoU as a dense float matmul (reference: tools/projection_2d_to_3d.py:149-166,
tools/refinement.py:69-90) and connected components by O(n) repeated matmuls
(projection_2d_to_3d.py:250-274). Here IoU goes to the hand-written kernel
(``kernels/mask_iou.py``) on a CUDA device and to its plain version on the
CPU, and components converge in ceil(log2(I)) boolean matmul squarings.
Unlike the JAX package, which sends small problems to numpy and pads device
shapes to row buckets (both only to spare XLA recompiles), :func:`mask_iou`
routes by device alone: on the card every call launches the kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from beyondff_tpu_torch.kernels import mask_iou as kiou
from beyondff_tpu_torch.kernels.dispatch import resolve_device

Device = Union[str, torch.device, None]


def as_mask(x, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
    return t.to(device=device, dtype=torch.bool).contiguous()


# --------------------------------------------------------------- pairwise IoU
def mask_iou(a, b=None, device: Device = None) -> np.ndarray:
    """(Ia, Ib) float32 IoU of host or device masks, computed on ``device``
    (``cuda`` unless the caller names another), returned on the host."""
    dev = resolve_device(device)
    at = as_mask(a, dev)
    bt = None if b is None else as_mask(b, dev)
    return kiou.pairwise_iou(at, bt).cpu().numpy()


def pairwise_iou_np(a: np.ndarray, b: Optional[np.ndarray] = None) -> np.ndarray:
    """NumPy oracle with identical semantics (float64 accumulate)."""
    a = np.asarray(a, dtype=np.float64)
    b = a if b is None else np.asarray(b, dtype=np.float64)
    inter = a @ b.T
    union = a.sum(1)[:, None] + b.sum(1)[None, :] - inter
    with np.errstate(invalid="ignore", divide="ignore"):
        return inter / union


# ------------------------------------------------------- connected components
def connected_components(adj: torch.Tensor) -> torch.Tensor:
    """Component id (= min member index) per node of an undirected graph.

    ``adj`` is a (I, I) bool adjacency matrix on any device; self-loops are
    added here. Reachability closes in ceil(log2(I)) squarings R <- R | R@R
    (float32 products of 0/1 matrices: exact below 2^24 nodes).
    """
    n = adj.shape[0]
    r = adj.bool() | torch.eye(n, dtype=torch.bool, device=adj.device)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        rf = r.float()
        r = (rf @ rf > 0) | r
    idx = torch.arange(n, device=adj.device)
    return torch.where(r, idx[None, :], n).min(dim=1).values


def connected_components_np(adj: np.ndarray) -> np.ndarray:
    """NumPy oracle: BFS labelling with min-member-index component ids."""
    n = adj.shape[0]
    adj = np.asarray(adj, dtype=bool) | np.eye(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        if comp[i] >= 0:
            continue
        frontier = {i}
        seen = {i}
        while frontier:
            nxt = set()
            for u in frontier:
                nxt |= set(np.flatnonzero(adj[u]))
            nxt -= seen
            seen |= nxt
            frontier = nxt
        comp[list(seen)] = i
    return comp


# ----------------------------------------------------------- grouped reduce
def group_or_and_mean(
    masks: torch.Tensor,  # (I, N) bool
    confs: np.ndarray,  # (I,) float32
    group_onehot: np.ndarray,  # (C, I) bool: group c contains node i
) -> Tuple[torch.Tensor, np.ndarray]:
    """Per group: OR of member masks (on the masks' device) and mean of member
    confidences (float32, on the host)."""
    onehot = np.asarray(group_onehot, bool)
    merged = torch.stack([masks[torch.as_tensor(np.flatnonzero(row), device=masks.device)]
                          .any(dim=0) for row in onehot])
    g = onehot.astype(np.float32)
    mean_conf = (g @ np.asarray(confs, np.float32)) / np.maximum(g.sum(1), np.float32(1))
    return merged, mean_conf.astype(np.float32)
