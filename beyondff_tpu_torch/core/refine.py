"""Stage-1 <-> stage-2 mask fusion ("refinement") core.

The port's copy of beyondff_tpu/core/refine.py, a pure-function rebuild of
the reference's two-pass refinement (reference: tools/refinement.py:158-428,
paper Algorithm 1). The cross-stage IoU matrices run through the mask-IoU
kernel on the device (exact counts, float32 quotients like the reference's
``.float()`` casts); the small order-dependent merge loops stay on the host
with the reference's exact mutation semantics:

  * per stage-2 mask, the argmax-IoU stage-1 mask is its match
    (refinement.py:208-213);
  * stage-1 masks whose *matched* pair IoU exceeds ``stage1_iou_thres`` are
    unioned in place while walking i in order; a stage-2 mask whose match was
    absorbed re-points to the absorbing index (refinement.py:230-258);
  * stage-2 masks sharing a final match are unioned with mean confidence and
    re-appended at the end (refinement.py:259-281);
  * IoU and matches are recomputed on the mutated masks (refinement.py:284-290);
  * the similarity threshold is the ``sim_percentile`` element of the sorted
    set of all scenes' query<->matched-label CLIP similarities
    (refinement.py:316-324) — a global barrier between pass 1 and pass 2;
  * pass 2 keeps the stage-1 mask when matched IoU > ``iou_thres`` (gated by
    the similarity threshold, below which the pair is dropped), else the
    stage-2 mask; unmatched same-label stage-1 masks are prepended with
    confidence 0.5 (refinement.py:330-392).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from beyondff_tpu_torch.core import masks as mask_ops


def cross_stage_iou(stage1: np.ndarray, stage2: np.ndarray, device=None) -> np.ndarray:
    """(m, n) float32 IoU: rows = stage-2 masks, cols = stage-1 masks
    (the reference's transposed convention, refinement.py:69-90), on
    ``device`` (``cuda`` unless the caller names another)."""
    return mask_ops.mask_iou(stage2, stage1, device=device)


@dataclass
class SceneMatch:
    """Pass-1 result for one scene."""

    ious: np.ndarray  # (m,) matched IoU per (merged) stage-2 mask
    matched_labels: List[str]  # stage-1 label of each match
    matched_stage1: np.ndarray  # (m, N) matched (possibly unioned) stage-1 masks
    stage2: np.ndarray  # (m, N) merged stage-2 masks
    stage2_conf: np.ndarray  # (m,)
    other_stage1: np.ndarray  # (k, N) unmatched same-label stage-1 masks
    similarities: List[float] = field(default_factory=list)  # filled by refinement.run (CLIP)


def match_scene(
    stage1_masks: np.ndarray,  # (n, N) bool
    stage1_labels: Sequence[str],  # underscore-form class names
    stage2_masks: np.ndarray,  # (m, N) bool
    stage2_conf: np.ndarray,  # (m,)
    query_label: str,  # underscore-form query
    stage1_iou_thres: float = 0.1,
    device=None,
) -> SceneMatch:
    """Pass-1 matching/merging for one scene."""
    n_points = stage1_masks.shape[1] if stage1_masks.ndim == 2 else 0
    if stage2_masks.shape[0] == 0:
        other = [i for i, lab in enumerate(stage1_labels) if lab == query_label]
        return SceneMatch(
            ious=np.zeros((0,), np.float32),
            matched_labels=[],
            matched_stage1=np.zeros((0, n_points), bool),
            stage2=np.zeros((0, n_points), bool),
            stage2_conf=np.zeros((0,), np.float32),
            other_stage1=stage1_masks[other] if other else np.zeros((0, n_points), bool),
        )

    s1 = stage1_masks.astype(bool).copy()
    s2 = stage2_masks.astype(bool).copy()
    conf = np.asarray(stage2_conf, np.float32).copy()

    iou = cross_stage_iou(s1, s2, device)  # (m, n)
    match = np.argmax(iou, axis=1)  # (m,) stage-1 index per stage-2 mask

    # --- union stage-1 masks whose matched pair overlaps -------------------
    m = match.shape[0]
    pair_iou = np.array(cross_stage_iou(s1[match], s1[match], device))  # (m, m)
    np.fill_diagonal(pair_iou, 0.0)
    overlap = pair_iou > stage1_iou_thres

    final_match = np.empty(m, dtype=np.int64)
    absorbed_by = np.full(m, -1, dtype=np.int64)
    for i in range(m):
        if absorbed_by[i] != -1:
            final_match[i] = match[absorbed_by[i]]
            continue
        final_match[i] = match[i]
        if overlap[i].any():
            for j in np.flatnonzero(overlap[i]):
                absorbed_by[j] = i
                s1[match[i]] |= s1[match[j]]

    # --- merge stage-2 masks sharing one final match ------------------------
    uniques, counts = np.unique(final_match, return_counts=True)
    for idx, count in zip(uniques, counts):
        if count <= 1:
            continue
        sel = final_match == idx
        merged_mask = s2[sel].any(axis=0)
        merged_conf = conf[sel].mean()
        s2 = np.concatenate([s2[~sel], merged_mask[None]])
        conf = np.concatenate([conf[~sel], [merged_conf]])
        final_match = np.concatenate([final_match[~sel], [idx]])

    # --- rematch on the mutated masks ---------------------------------------
    iou2 = cross_stage_iou(s1, s2, device)  # (m', n)
    match2 = np.argmax(iou2, axis=1)
    matched_iou = iou2[np.arange(match2.shape[0]), match2]

    other = [
        i
        for i, lab in enumerate(stage1_labels)
        if lab == query_label and i not in set(match2.tolist())
    ]
    return SceneMatch(
        ious=matched_iou.astype(np.float32),
        matched_labels=[stage1_labels[i] for i in match2],
        matched_stage1=s1[match2],
        stage2=s2,
        stage2_conf=conf,
        other_stage1=s1[other] if other else np.zeros((0, s1.shape[1]), bool),
    )


def select_sim_threshold(all_similarities: Sequence[Sequence[float]], percentile: float) -> float:
    """Percentile over the sorted set of all scenes' similarities
    (reference: refinement.py:316-324). Returns -inf if no pairs exist."""
    uniq = sorted({float(s) for sims in all_similarities for s in sims})
    if not uniq:
        return float("-inf")
    return uniq[int(len(uniq) * percentile)]


def fuse_scene(
    scene: SceneMatch,
    query: str,  # space-form query; becomes every output label
    sim_thres: float,
    iou_thres: float = 0.45,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """Pass-2 assembly for one scene -> (ins, conf, labels)."""
    ins: List[np.ndarray] = []
    conf: List[float] = []
    for mask in scene.other_stage1:
        ins.append(mask.astype(bool))
        conf.append(0.5)

    for k, iou in enumerate(np.asarray(scene.ious)):
        if iou > iou_thres:
            # high overlap: trust stage-1 geometry, if the label agrees with the query
            if scene.similarities[k] < sim_thres:
                continue
            ins.append(scene.matched_stage1[k].astype(bool))
        else:
            ins.append(scene.stage2[k].astype(bool))
        conf.append(float(scene.stage2_conf[k]))

    if not ins:
        n = scene.stage2.shape[1] if scene.stage2.ndim == 2 else 0
        return np.zeros((0, n), bool), np.zeros((0,), np.float32), []
    return np.stack(ins), np.asarray(conf, np.float32), [query] * len(ins)
