"""Run-length codec for binary masks.

Wire format is identical to the reference so stage outputs interoperate
(reference: tools/utils/rle_encode_decode.py:10-61): an RLE is
``{"length": int, "counts": int array}`` where ``counts`` alternates
1-based run starts and run lengths over the flattened mask.

Unlike the reference (python loop per run), both directions are vectorized:
encode via a single diff/flatnonzero, decode via cumsum over a delta array.
The port's copy of beyondff_tpu/core/rle.py (byte-identical output).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def rle_encode(mask: np.ndarray) -> Dict:
    """Encode a 1D binary mask. Returns {"length", "counts"} (1-based starts)."""
    mask = np.asarray(mask).astype(bool).ravel()
    length = mask.shape[0]
    if length == 0:
        return {"length": 0, "counts": np.empty(0, dtype=np.int64)}
    padded = np.concatenate([[False], mask, [False]])
    # 0-based positions where runs start (0->1 edge) and end (1->0 edge)
    bounds = np.flatnonzero(padded[1:] != padded[:-1]).astype(np.int64)
    starts = bounds[0::2] + 1  # 1-based, wire-compatible
    runs = bounds[1::2] - bounds[0::2]
    counts = np.empty(starts.size * 2, dtype=np.int64)
    counts[0::2] = starts
    counts[1::2] = runs
    return {"length": int(length), "counts": counts}


def rle_decode(rle: Dict) -> np.ndarray:
    """Decode to a 1D uint8 mask. Accepts counts as array, list, or str."""
    counts = rle["counts"]
    if isinstance(counts, str):
        # space-separated variant (reference: eval_class_agnostic_scannet200.py:13-26)
        counts = np.array(counts.split(), dtype=np.int64) if counts.strip() else np.empty(0, np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size % 2:
        raise ValueError(f"malformed RLE: odd counts length {counts.size}")
    length = int(rle["length"])
    starts = counts[0::2] - 1
    ends = starts + counts[1::2]
    # delta trick: +1 at each start, -1 at each end, cumsum
    delta = np.zeros(length + 1, dtype=np.int8)
    np.add.at(delta, starts, 1)
    np.add.at(delta, ends, -1)
    return (np.cumsum(delta[:-1]) > 0).astype(np.uint8)


def rle_bounds(rle: Dict) -> "tuple":
    """0-based half-open run bounds (starts, ends) of an RLE dict — the
    device lift consumes these directly (geometry.lift_frames_rle) so dense
    bitmaps never have to be materialized or uploaded."""
    counts = np.asarray(rle["counts"], dtype=np.int64)
    if counts.size % 2:
        raise ValueError(f"malformed RLE: odd counts length {counts.size}")
    starts = counts[0::2] - 1
    return starts, starts + counts[1::2]


def rle_encode_batch(masks: np.ndarray) -> List[Dict]:
    """Encode (M, L) binary masks to a list of RLE dicts."""
    masks = np.asarray(masks)
    return [rle_encode(masks[i]) for i in range(masks.shape[0])]


def rle_decode_batch(rles: Sequence[Dict]) -> np.ndarray:
    """Decode a list of RLE dicts to an (M, L) uint8 array: the native batch
    decoder (utils/native.py) for same-length masks with array counts, numpy
    otherwise and under ``BFF_NO_NATIVE``."""
    if not rles:
        return np.zeros((0, 0), dtype=np.uint8)
    if not any(isinstance(r["counts"], str) for r in rles):
        from beyondff_tpu_torch.utils import native

        out = native.rle_decode_batch_native(rles)
        if out is not None:
            return out
    return np.stack([rle_decode(r) for r in rles])


def encode_frame_masks(results: List[Dict]) -> List[Dict]:
    """RLE-encode the ``segmented_frame_masks`` of each per-frame record in place.

    Matches the on-disk 2D-mask contract (reference: rle_encode_decode.py:63-80):
    (M, 1, H, W) bool -> list of RLEs over the flattened (H*W) mask.
    """
    for rec in results:
        raw = rec["segmented_frame_masks"]
        if isinstance(raw, (list, tuple)) and raw and isinstance(raw[0], dict):
            continue  # already RLE-encoded
        masks = np.asarray(raw)
        flat = masks.reshape(masks.shape[0], -1)
        rec["segmented_frame_masks"] = rle_encode_batch(flat)
    return results


def decode_frame_masks(results: List[Dict], image_shape=(968, 1296)) -> List[Dict]:
    """Inverse of :func:`encode_frame_masks`: RLEs -> (M, 1, H, W) uint8.

    Also accepts records whose masks are already dense arrays/tensors: the
    reference's YOLO-World stage saves raw (M, 1, H, W) bool tensors without
    RLE-encoding them (segmentation_2d_yolo_world.py:634-638), and those
    files must remain consumable here."""
    for rec in results:
        raw = rec["segmented_frame_masks"]
        if not (isinstance(raw, (list, tuple)) and raw and isinstance(raw[0], dict)) \
                and not isinstance(raw, dict):
            masks = np.asarray(raw, dtype=np.uint8)  # torch tensors coerce too
            rec["segmented_frame_masks"] = masks.reshape(masks.shape[0], 1, *image_shape)
            continue
        masks = rle_decode_batch(raw)
        rec["segmented_frame_masks"] = masks.reshape(masks.shape[0], 1, *image_shape)
    return results
