"""Point- and mask-level filtering of lifted 3D masks.

Reimplements the reference's filtering cascade
(reference: tools/projection_2d_to_3d.py:511-626). All thresholds are
"percentile over the *unique* values" — a load-bearing quirk kept intact:
the cut value is ``unique(x)[floor(p * len(unique(x)))]`` and points strictly
below it are zeroed. Ratios are computed in float32 to match the reference's
torch defaults, so the unique-value set (and therefore the threshold) agrees.
The port's copy of beyondff_tpu/core/filtering.py (numpy on the host: the
counts are one (N,) vector per scene).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from beyondff_tpu_torch.config import FilteringConfig
from beyondff_tpu_torch.core.aggregation import AggregatedMasks, solve_overlapping


def occurrence_filter(masked_counts: np.ndarray, threshold: float) -> np.ndarray:
    """Zero points whose view-vote count falls below the unique-value percentile
    (reference: projection_2d_to_3d.py:512-522)."""
    counts = np.asarray(masked_counts, dtype=np.float32).copy()
    uniq = np.unique(counts)
    cut = uniq[math.floor(threshold * uniq.shape[0])]
    counts[counts < cut] = 0
    return counts


def detected_ratio_filter(
    masked_counts: np.ndarray, viewed_counts: np.ndarray, threshold: float
) -> Tuple[np.ndarray, float]:
    """Zero points seen in many frames but detected in few
    (reference: projection_2d_to_3d.py:524-578). Returns (counts, cut_value)."""
    counts = np.asarray(masked_counts, dtype=np.float32).copy()
    viewed = np.asarray(viewed_counts, dtype=np.float32)
    ratio = counts / (viewed + 1.0)  # +1 avoids /0, as in the reference
    uniq = np.unique(ratio)
    cut = uniq[math.floor(threshold * uniq.shape[0])]
    counts[ratio < cut] = 0
    return counts, float(cut)


@dataclass
class FilteredMasks:
    ins: np.ndarray  # (K, N) bool
    conf: np.ndarray  # (K,) float32
    labels: List[str]


def filter_masks(
    agg: AggregatedMasks,
    masked_counts: np.ndarray,
    viewed_counts: np.ndarray,
    cfg: FilteringConfig,
) -> FilteredMasks:
    """Full post-aggregation cascade: point filter -> overlap resolution ->
    point AND -> size/retention mask pruning (projection_2d_to_3d.py:583-623).

    Order preserved from the reference: pre-filter sizes are measured *before*
    overlap resolution; the retention test compares post-resolution+filter
    sizes against them.
    """
    if cfg.use_occurrence_threshold:
        counts = occurrence_filter(masked_counts, cfg.occurrence_threshold)
    elif cfg.use_detected_ratio_threshold:
        counts, _ = detected_ratio_filter(masked_counts, viewed_counts, cfg.detected_ratio_threshold)
    else:
        counts = np.asarray(masked_counts, dtype=np.float32)

    keep_points = counts > 0  # (N,)

    size_before = agg.ins.sum(axis=1)  # (C,) pre-resolution sizes
    resolved = solve_overlapping(agg)
    ins = resolved.ins & keep_points[None, :]
    size_after = ins.sum(axis=1)

    keep = (size_after > cfg.remove_small_masks) & (
        size_after > cfg.remove_filtered_masks * size_before
    )
    return FilteredMasks(
        ins=ins[keep],
        conf=np.asarray(agg.conf)[keep].astype(np.float32),
        labels=[lab for lab, k in zip(agg.labels, keep) if k],
    )
