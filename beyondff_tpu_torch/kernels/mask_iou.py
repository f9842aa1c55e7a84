"""Pairwise IoU of boolean masks: the hand-written Hopper kernel and its plain
version.

Port of beyondff_tpu/kernels/mask_iou.py (``pairwise_iou_pallas`` and
``pad_and_iou``). (Ia, N) x (Ib, N) ``torch.bool`` masks -> (Ia, Ib) float32
``inter / (area_a + area_b - inter)``, 0/0 = nan. The CUDA kernel
(``csrc/mask_iou.cu``) counts intersections on the int8 tensor cores from
the bool bytes as they are, with ragged Ia, Ib and N and rows at any
address; counts are exact integers, so kernel, plain version and the JAX
package agree bit for bit. The wrapper launches the kernel for CUDA tensors
and raises on what it does not take; CPU tensors take
:func:`pairwise_iou_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from beyondff_tpu_torch.kernels import dispatch


def pairwise_iou_plain(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch: a float32 product over N and f32
    row sums (exact below 2^24 points)."""
    af = a.float()
    bf = af if b is None else b.float()
    inter = af @ bf.T
    union = af.sum(1)[:, None] + bf.sum(1)[None, :] - inter
    return inter / union


def pairwise_iou(a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Ia, N) x (Ib, N) bool -> (Ia, Ib) float32 IoU; ``b`` None is a vs a."""
    if not dispatch.kernel_device(*((a,) if b is None else (a, b))):
        return pairwise_iou_plain(a, b)
    dispatch.refuse_autograd("mask_iou", a, b)
    for t in (a,) if b is None else (a, b):
        if t.dtype != torch.bool or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"pairwise_iou takes contiguous 2-D bool masks, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if b is not None and (b.shape[1] != a.shape[1] or b.device != a.device):
        raise ValueError(f"masks disagree: {tuple(a.shape)} on {a.device} vs "
                         f"{tuple(b.shape)} on {b.device}")
    ia, n = a.shape
    ib = ia if b is None else b.shape[0]
    out = torch.empty(ia, ib, dtype=torch.float32, device=a.device)
    if ia == 0 or ib == 0:
        return out
    from beyondff_tpu_torch.kernels import _build

    workspace = torch.empty(ia * ib + ia + ib, dtype=torch.int32, device=a.device)
    rc = _build.library().bff_mask_iou(
        a.data_ptr(), None if b is None else b.data_ptr(), ia, ib, n,
        workspace.data_ptr(), out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mask_iou kernel launch failed (code {rc})")
    dispatch.launch_counts["mask_iou"] += 1
    return out
