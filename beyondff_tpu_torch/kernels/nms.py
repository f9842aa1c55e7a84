"""Fixed-shape class-agnostic NMS: the hand-written CUDA kernel and its plain
version.

Port of ``nms_fixed`` in beyondff_tpu/models/yolo_world.py, which the JAX
package runs as a ``lax.fori_loop`` (no Pallas kernel). Boxes (B, A, 4)
xyxy and scores (B, A) -> (keep_idx (B, top_k) int32, valid (B, top_k)
bool): the indices of the boxes greedy NMS keeps, in descending score
order (ties in index order), padded with index 0 and ``valid`` false. A
box j is suppressed by a kept box i before it when
``inter / (area[i] + area[j] - inter + 1e-9) > iou_thres`` in float32.

The CUDA kernel (``csrc/nms_fixed.cu``) scans a frame on a cluster of
``CLUSTER`` blocks, each holding a slice of the sorted boxes and its
suppression bits in shared memory, resolves up to ``LOOK`` boxes a round
and decides most pairs without the division (:func:`iou_exceeds`);
:func:`cluster_scan_mirror` walks its rounds on the CPU. The plain version
walks the same greedy order in PyTorch. All stop once ``top_k`` boxes are
kept, which leaves the first ``top_k`` kept indices unchanged, and all give
the JAX function's result index for index. The wrapper launches the kernel
for CUDA tensors and raises on what it does not take; CPU tensors take
:func:`nms_fixed_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from beyondff_tpu_torch.kernels import dispatch

# csrc/nms_fixed.cu: blocks a frame, boxes a block holds at most, free
# boxes a block offers a round
CLUSTER = 8
MAX_SLICE = 11264
LOOK = 4
MAX_ANCHORS = CLUSTER * MAX_SLICE
# the relative margin around thr * denom beyond which the quotient's side of
# thr is certain
MARGIN = 2.0 ** -20
# f32 operations of one IoU test (4 min/max, 2 clamps, 2 products, 8 +-/)
IOU_OPS = 16


def _sorted(boxes: torch.Tensor, scores: torch.Tensor):
    """Boxes in descending score order (stable: ties in index order, as
    ``jnp.argsort(-scores)``) and the order."""
    order = torch.sort(scores.neg(), dim=-1, stable=True).indices
    return torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)), order


def iou_exceeds(inter: np.ndarray, denom: np.ndarray, thr: float) -> np.ndarray:
    """``inter / denom > thr`` in float32 as ``csrc/nms_fixed.cu`` decides it:
    without the division where the answer is certain (inter == 0 with thr a
    positive normal float; inter beyond f32(thr * denom) scaled by 1 +- 2^-20,
    with that product between 2^-100 and 2^100), with it elsewhere. Equal to
    the f32 division on every pair; numpy's float32 products and quotients
    round once, as the kernel's ``__fmul_rn`` and ``__fdiv_rn`` do."""
    inter = np.asarray(inter, np.float32)
    denom = np.asarray(denom, np.float32)
    t = np.float32(thr)
    with np.errstate(all="ignore"):
        divided = (inter / denom) > t
        if not np.finfo(np.float32).tiny <= t <= np.finfo(np.float32).max:
            return divided
        lim = t * denom
        usable = (lim >= np.float32(2.0 ** -100)) & (lim <= np.float32(2.0 ** 100))
        above = usable & (inter > lim * np.float32(1 + MARGIN))
        below = usable & (inter < lim * np.float32(1 - MARGIN))
    out = np.where(above, True, np.where(below, False, divided))
    return np.where(inter == 0, False, out)


def _iou_terms(box_i: np.ndarray, area_i, boxes: np.ndarray, areas: np.ndarray):
    """The kernel's (inter, denom) of box i against ``boxes``, float32."""
    x1 = np.maximum(box_i[0], boxes[:, 0])
    y1 = np.maximum(box_i[1], boxes[:, 1])
    x2 = np.minimum(box_i[2], boxes[:, 2])
    y2 = np.minimum(box_i[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, np.float32(0)) * np.maximum(y2 - y1, np.float32(0))
    return inter, (area_i + areas - inter) + np.float32(1e-9)


def cluster_slices(a: int, cluster: int = CLUSTER):
    """The kernel's partition of a frame's ``a`` sorted boxes: ``cluster``
    slices [r * slice, (r + 1) * slice) clipped to ``a``, slice the
    multiple of 32 at or above a / cluster."""
    slice_ = -(-(-(-a // cluster)) // 32) * 32
    return [(r * slice_, min((r + 1) * slice_, a)) for r in range(cluster)]


def cluster_scan_mirror(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float,
                        top_k: int, cluster: int = CLUSTER, look: int = LOOK):
    """The rounds of ``csrc/nms_fixed.cu`` on the CPU: per frame, the
    stable descending sort, the slices of :func:`cluster_slices`, the
    suppression bits. A round: each slice offers its first ``look`` free
    boxes after the last resolved position; the ``look`` smallest offers
    (the frame's first free boxes) are kept in order unless a box kept
    before them in the round suppresses them (:func:`iou_exceeds`), and the
    free boxes after them are tested against the boxes the round kept.
    Returns (keep_idx (B, top_k) int32, valid (B, top_k) bool), padded with
    index 0 and ``valid`` false, and the rounds each frame took."""
    b, a = scores.shape
    order = torch.sort(scores.float().neg(), dim=-1, stable=True).indices.numpy()
    keep = np.zeros((b, top_k), np.int32)
    valid = np.zeros((b, top_k), bool)
    rounds = []
    slices = cluster_slices(a, cluster)
    for f in range(b):
        bs = boxes[f].float().numpy()[order[f]]
        area = (np.maximum(bs[:, 2] - bs[:, 0], np.float32(0))
                * np.maximum(bs[:, 3] - bs[:, 1], np.float32(0)))
        suppressed = np.zeros(a, bool)
        pos, kept, n_rounds, new = -1, 0, 0, []
        while True:
            n_rounds += 1
            free = np.nonzero(~suppressed[pos + 1:])[0] + pos + 1
            for i in new:
                inter, denom = _iou_terms(bs[i], area[i], bs[free], area[free])
                hit = iou_exceeds(inter, denom, iou_thres)
                suppressed[free[hit]] = True
                free = free[~hit]
            offers = []
            for lo, hi in slices:
                live = np.nonzero(~suppressed[max(lo, pos + 1):hi])[0]
                offers += [max(lo, pos + 1) + int(x) for x in live[:look]]
            new = []
            for g in sorted(offers)[:look]:
                pos = g
                if not any(iou_exceeds(*_iou_terms(bs[i], area[i], bs[g:g + 1], area[g:g + 1]),
                                       iou_thres)[0] for i in new):
                    new.append(g)
                    keep[f, kept] = order[f, g]
                    valid[f, kept] = True
                    kept += 1
                    if kept == top_k:
                        break
            if not new or kept == top_k:
                break
        rounds.append(n_rounds)
    return torch.from_numpy(keep), torch.from_numpy(valid), rounds


def clustered_boxes(gen: torch.Generator, b: int, a: int, centres: int = 60,
                    spread: float = 10.0, half_min: float = 8.0):
    """A detector-like input drawn from ``gen`` on its device: ``b`` frames
    of ``a`` xyxy boxes around ``centres`` centres in a 640-pixel frame
    (offsets N(0, spread), half sizes in [half_min, half_min + 60)) and
    uniform scores. The NMS measurements and card tests draw from it."""
    dev = gen.device
    c = torch.rand(b, centres, 2, generator=gen, device=dev) * 640
    pick = torch.randint(0, centres, (b, a), generator=gen, device=dev)
    c = torch.gather(c, 1, pick[..., None].expand(-1, -1, 2))
    c = c + torch.randn(b, a, 2, generator=gen, device=dev) * spread
    half = torch.rand(b, a, 2, generator=gen, device=dev) * 60 + half_min
    return torch.cat([c - half, c + half], -1), torch.rand(b, a, generator=gen, device=dev)


def iou_tests(keep: torch.Tensor, valid: torch.Tensor, scores: torch.Tensor) -> int:
    """The IoU tests the greedy scan makes for this result: each kept box
    against every box after it in score order (what the data needs, for the
    bound)."""
    order = torch.sort(scores.neg(), dim=-1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    pos = torch.gather(rank, 1, keep.long())
    return int(((scores.shape[1] - 1 - pos) * valid).sum())


def split_spans(spans, calls: int) -> dict:
    """Device ms per call of :func:`nms_fixed`'s parts from
    ``profiling.device_spans`` over ``calls`` calls: the scan (kernels named
    ``nms``), the gather (``gather``) and the sort (the rest: the negation
    and the sort's own kernels)."""
    parts = {"sort_ms": 0.0, "gather_ms": 0.0, "scan_ms": 0.0}
    for start, end, name in spans:
        key = ("scan_ms" if "nms" in name else "gather_ms" if "gather" in name.lower()
               else "sort_ms")
        parts[key] += (end - start) / 1e3 / calls
    return parts


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
    if a > MAX_ANCHORS:
        raise ValueError(f"nms_fixed: {a} boxes exceed the kernel's {MAX_ANCHORS} "
                         f"({CLUSTER} slices of {MAX_SLICE} in shared memory)")
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
