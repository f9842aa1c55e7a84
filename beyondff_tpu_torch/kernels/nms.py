"""Fixed-shape class-agnostic NMS: the hand-written CUDA kernel and its plain
version.

Port of ``nms_fixed`` in beyondff_tpu/models/yolo_world.py, which the JAX
package runs as a ``lax.fori_loop`` (no Pallas kernel). Boxes (B, A, 4)
xyxy and scores (B, A) -> (keep_idx (B, top_k) int32, valid (B, top_k)
bool): the indices of the boxes greedy NMS keeps, in descending score
order (ties in index order), padded with index 0 and ``valid`` false. A
box j is suppressed by a kept box i before it when
``inter / (area[i] + area[j] - inter + 1e-9) > iou_thres`` in float32.

The CUDA kernel (``csrc/nms_fixed.cu``) scans one frame a block with the
suppression state as a bitmask in shared memory; the plain version walks
the same greedy order in PyTorch. Both stop once ``top_k`` boxes are kept,
which leaves the first ``top_k`` kept indices unchanged, and both give the
JAX function's result index for index. The wrapper launches the kernel for
CUDA tensors and raises on what it does not take; CPU tensors take
:func:`nms_fixed_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from beyondff_tpu_torch.kernels import dispatch


def _sorted(boxes: torch.Tensor, scores: torch.Tensor):
    """Boxes in descending score order (stable: ties in index order, as
    ``jnp.argsort(-scores)``) and the order."""
    order = torch.sort(scores.neg(), dim=-1, stable=True).indices
    return torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)), order


def nms_fixed_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, top_k: int):
    """The same function in plain PyTorch: the greedy scan over each frame's
    sorted boxes, one vectorized IoU pass per kept box."""
    b, a = scores.shape
    boxes_s, order = _sorted(boxes.float(), scores.float())
    keep = torch.zeros(b, top_k, dtype=torch.int32, device=boxes.device)
    valid = torch.zeros(b, top_k, dtype=torch.bool, device=boxes.device)
    for f in range(b):
        bs = boxes_s[f]
        area = (bs[:, 2] - bs[:, 0]).clamp_min(0) * (bs[:, 3] - bs[:, 1]).clamp_min(0)
        suppressed = torch.zeros(a, dtype=torch.bool, device=boxes.device)
        kept, i = 0, 0
        while kept < top_k and i < a:
            free = torch.nonzero(~suppressed[i:])
            if free.numel() == 0:
                break
            i += int(free[0])
            keep[f, kept] = order[f, i]
            valid[f, kept] = True
            kept += 1
            rest = bs[i + 1:]
            x1 = torch.maximum(bs[i, 0], rest[:, 0])
            y1 = torch.maximum(bs[i, 1], rest[:, 1])
            x2 = torch.minimum(bs[i, 2], rest[:, 2])
            y2 = torch.minimum(bs[i, 3], rest[:, 3])
            inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
            iou = inter / (area[i] + area[i + 1:] - inter + 1e-9)
            suppressed[i + 1:] |= iou > iou_thres
            i += 1
    return keep, valid


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float, top_k: int):
    """(B, A, 4) boxes, (B, A) scores -> (keep_idx (B, top_k) int32, valid
    (B, top_k) bool)."""
    if not dispatch.kernel_device(boxes, scores):
        return nms_fixed_plain(boxes, scores, iou_thres, top_k)
    dispatch.refuse_autograd("nms_fixed", boxes, scores)
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError(f"nms_fixed takes (B, A, 4) boxes and (B, A) scores, got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"nms_fixed takes float32, got {boxes.dtype} and {scores.dtype}")
    b, a = scores.shape
    if (a + 31) // 32 * 4 > 48 * 1024:
        raise ValueError(f"nms_fixed: {a} boxes exceed the kernel's shared-memory mask")
    if top_k < 1:
        raise ValueError(f"nms_fixed: top_k {top_k} < 1")
    from beyondff_tpu_torch.kernels import _build

    boxes_s, order = _sorted(boxes, scores)
    boxes_s = boxes_s.contiguous()
    keep = torch.empty(b, top_k, dtype=torch.int32, device=boxes.device)
    valid = torch.empty(b, top_k, dtype=torch.bool, device=boxes.device)
    rc = _build.library().bff_nms_fixed(
        boxes_s.data_ptr(), order.data_ptr(), b, a, top_k, ctypes.c_float(iou_thres),
        keep.data_ptr(), valid.data_ptr(), torch.cuda.current_stream(boxes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nms_fixed kernel launch failed (code {rc})")
    dispatch.launch_counts["nms_fixed"] += 1
    return keep, valid
