"""Device CLIP crops: box crops cut and resized on the device from frame
buffers already there, so the CLIP filter uploads box coordinates instead of
pixel crops.

The port's copy of beyondff_tpu/core/crop_resize.py. The chain reproduced,
per crop:

  YOLO-World mode (segmentation_2d_yolo_world.py:505-515): crop the uint8
  frame, multiply by 255 in uint8 (wraps to (-x) mod 256), then the CLIP
  transform: bicubic short-side resize to 224 and a centre crop.

  Grounding-DINO mode (segmentation_2d.py:345-380): resize the frame to the
  detector input with INTER_LINEAR, ImageNet-normalise, crop the box,
  ``* 255 -> uint8`` (a sawtooth wrap), then the same CLIP transform.

The host path (``Segmentor2D._clip_crops`` and ``CLIP.preprocess``) runs
this chain with OpenCV's arithmetic. Here a resize is a weight matrix per
axis built from the box scalars, and each crop is two contractions,
(n, H) x (H, W, 3) x (n, W), in float32: ``torch.einsum`` on the card, as
the JAX package computes them outside any Pallas kernel. Deviations from the
host chain are the JAX package's: the crop source is the device frame buffer
(SAM-scale, YCrCb round-tripped when ``BFF_SEG2D_YUV`` is on); float32
weights and round-half-even where OpenCV has 11-bit fixed point and
round-half-up (within one level); the normalise table evaluated as
arithmetic (truncation, then mod 256). The weights are built with the JAX
package's float32 operations, multiply-adds fused where XLA:CPU fuses them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from beyondff_tpu_torch.core.resize import fma, taps_axis
from beyondff_tpu_torch.utils.host_copy import to_device

_CUBIC_A = -0.75  # OpenCV's interpolateCubic
_CROP_CHUNK = 64  # crops whose (n, W, 3) row passes are live at once


def _cubic_coeffs(f: torch.Tensor):
    """OpenCV's 4-tap bicubic coefficients at fractional offset ``f``."""
    a = _CUBIC_A
    f1 = f + 1.0
    c0 = fma(fma(fma(a, f1, -5 * a), f1, 8 * a), f1, -4 * a)
    c1 = fma(fma(a + 2, f, -(a + 3)) * f, f, 1.0)
    g = 1.0 - f
    c2 = fma(fma(a + 2, g, -(a + 3)) * g, g, 1.0)
    c3 = 1.0 - c0 - c1 - c2
    return c0, c1, c2, c3


def _resize_weights(n_out: int, out_lo, crop_lo, crop_len, n_mid, full_len: int,
                    cubic: bool) -> torch.Tensor:
    """(K, n_out, full_len) weights of ``cv2.resize(src[crop_lo:crop_lo +
    crop_len], n_mid)[out_lo:out_lo + n_out]`` along one axis, one row block
    per crop. ``out_lo``, ``crop_len``, ``n_mid``: (K,) float32;
    ``crop_lo``: (K,) int32. Taps clamp to the crop's own bounds (a resize
    of the sliced array)."""
    dev = crop_len.device
    i = torch.arange(n_out, dtype=torch.float32, device=dev)
    pos = fma(out_lo[:, None] + i + 0.5, (crop_len / n_mid)[:, None], -0.5)
    base = torch.floor(pos)
    frac = pos - base
    coeffs = _cubic_coeffs(frac) if cubic else (1.0 - frac, frac)
    first = -1 if cubic else 0
    cols = torch.arange(full_len, dtype=torch.int32, device=dev)
    hi = torch.clamp(crop_len.to(torch.int32) - 1, min=0)[:, None]
    base = base.to(torch.int32)
    w = torch.zeros(crop_len.shape[0], n_out, full_len, dtype=torch.float32, device=dev)
    for t, c in enumerate(coeffs):
        p = torch.minimum(torch.clamp(base + (first + t), min=0), hi) + crop_lo[:, None]
        w = w + c[..., None] * (cols == p[..., None])
    return w


def _taps(w: torch.Tensor):
    """A dense (n_out, n_in) weight matrix of at most two nonzero entries a
    row -> (2, n_out) indices and weights in ascending input order."""
    w = w.cpu().numpy()
    nz = w != 0
    ar = np.arange(w.shape[0])
    first = nz.argmax(1)
    last = w.shape[1] - 1 - nz[:, ::-1].argmax(1)
    wt = np.stack([w[ar, first], np.where(last != first, w[ar, last], 0)]).astype(np.float32)
    return np.stack([first, last]), wt


def _clip_transform_weights(y0, y1, x0, x1, full_h: int, full_w: int, n: int):
    """Row and column weights of the CLIP transform of ``src[y0:y1, x0:x1]``:
    bicubic short-side resize to ``n``, centre crop (CLIP.preprocess)."""
    ch = (y1 - y0).to(torch.float32)
    cw = (x1 - x0).to(torch.float32)
    scale = n / torch.minimum(ch, cw)
    nh = torch.round(ch * scale)  # Python's round(): half to even
    nw = torch.round(cw * scale)
    top = torch.floor((nh - n) / 2)
    left = torch.floor((nw - n) / 2)
    return (_resize_weights(n, top, y0, ch, nh, full_h, cubic=True),
            _resize_weights(n, left, x0, cw, nw, full_w, cubic=True))


def _crop_rect(boxes: torch.Tensor, sx: float, sy: float, w_lim: int, h_lim: int):
    """The host's integer crop rectangles (truncate, clamp), as (K,) int32
    x0, y0, x1, y1 and a validity flag. An empty rectangle keeps one pixel
    so shapes stay finite; its output is zeroed, as the host's 2x2 zero
    placeholder resizes to zeros."""
    sx, sy = np.float32(sx), np.float32(sy)
    x0 = torch.clamp(torch.trunc(boxes[:, 0] * sx), min=0).to(torch.int32)
    y0 = torch.clamp(torch.trunc(boxes[:, 1] * sy), min=0).to(torch.int32)
    x1 = torch.clamp(torch.trunc(boxes[:, 2] * sx), max=w_lim).to(torch.int32)
    y1 = torch.clamp(torch.trunc(boxes[:, 3] * sy), max=h_lim).to(torch.int32)
    valid = (x1 > x0) & (y1 > y0)
    return x0, y0, torch.maximum(x1, x0 + 1), torch.maximum(y1, y0 + 1), valid


def _sat_round(v: torch.Tensor) -> torch.Tensor:
    """OpenCV's saturate_cast<uchar>: round (half to even here, half up
    there: the one-level deviation class) and clamp."""
    return torch.clamp(torch.round(v), 0.0, 255.0)


def _crops(src: torch.Tensor, frame_of: np.ndarray, y0, y1, x0, x1, n: int) -> torch.Tensor:
    """CLIP-transformed crops of float (B, H, W, 3) ``src``: crop k is cut
    from frame ``frame_of[k]``. (n, H) x (H, W, 3) then (n, W), per frame and
    at most ``_CROP_CHUNK`` crops at a time."""
    _, h, w, _ = src.shape
    out = torch.empty(len(frame_of), n, n, 3, dtype=torch.float32, device=src.device)
    for f in np.unique(frame_of):
        ks = np.flatnonzero(frame_of == f)
        for lo in range(0, ks.size, _CROP_CHUNK):
            k = to_device(ks[lo:lo + _CROP_CHUNK], src.device)
            wr, wc = _clip_transform_weights(y0[k], y1[k], x0[k], x1[k], h, w, n)
            rows = torch.einsum("koy,yxc->koxc", wr, src[f])
            out[k] = _sat_round(torch.einsum("kpx,koxc->kopc", wc, rows))
    return out


def _crop_source_yolo(frames_u8: torch.Tensor) -> torch.Tensor:
    """YOLO-World mode's crop source: uint8 * 255 wraps to (-x) mod 256, the
    reference's cast quirk, as float32."""
    return torch.remainder(256 - frames_u8.to(torch.int32), 256).to(torch.float32)


# (h, w, det_h, det_w, device) -> the detector resize's row and column taps
_GDINO_TAPS = {}


def _crop_source_gdino(frames_u8: torch.Tensor, det_hw: Tuple[int, int], mean,
                       std) -> torch.Tensor:
    """Grounding-DINO mode's crop source: INTER_LINEAR to the detector input
    ``det_hw``, ImageNet-normalised, ``* 255`` cast to uint8 (truncate toward
    zero, then mod 256, numpy's cast), as float32."""
    dev = frames_u8.device
    _, h, w, _ = frames_u8.shape
    gh, gw = det_hw
    key = (h, w, gh, gw, str(dev))
    if key not in _GDINO_TAPS:
        # the weights depend on the shapes only: read back once per shape,
        # not once per batch (a read-back waits for the whole stream)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        f32 = (lambda v: torch.full((1,), float(v), dtype=torch.float32, device=dev))
        _GDINO_TAPS[key] = (
            _taps(_resize_weights(gh, f32(0), zero, f32(h), f32(gh), h, cubic=False)[0]),
            _taps(_resize_weights(gw, f32(0), zero, f32(w), f32(gw), w, cubic=False)[0]))
    taps_r, taps_c = _GDINO_TAPS[key]
    # two taps a row: the rows accumulate fused, the columns round each
    # product, as XLA:CPU's two dots do
    rows = taps_axis(frames_u8.to(torch.float32), *taps_r, 1, fused=True)
    v = _sat_round(taps_axis(rows, *taps_c, 2, fused=False))
    mean = to_device(np.asarray(mean, np.float32), dev)
    std = to_device(np.asarray(std, np.float32), dev)
    # (v / 255 - mean) / std * 255 with XLA:CPU's rewrites: division by a
    # constant becomes a multiply by its reciprocal, fused with the sub
    t = fma(v, np.float32(1 / 255.0), -mean) * (1.0 / std) * 255.0
    return torch.remainder(torch.trunc(t).to(torch.int32), 256).to(torch.float32)


def _clip_crops_of(src: torch.Tensor, frame_of, boxes, valid, frame_hw, n: int):
    """The CLIP transform of each box's crop of the float crop source ``src``
    (B, h, w, 3); boxes in ``frame_hw`` coordinates."""
    dev = src.device
    _, h, w, _ = src.shape
    boxes = to_device(np.asarray(boxes, np.float32), dev)
    valid = to_device(np.asarray(valid, bool), dev)
    x0, y0, x1, y1, ok = _crop_rect(boxes, w / frame_hw[1], h / frame_hw[0], w, h)
    out = _crops(src, np.asarray(frame_of, np.int64), y0, y1, x0, x1, n)
    return torch.where((ok & valid)[:, None, None, None], out, 0.0)


def clip_crop_yolo(frames_u8: torch.Tensor, frame_of, boxes, valid,
                   frame_hw: Tuple[int, int], n: int = 224) -> torch.Tensor:
    """Device CLIP crops, YOLO-World mode: the ``* 255`` wrap of the uint8
    frames, then the crop and the CLIP transform. See
    :func:`clip_crop_batch`."""
    return _clip_crops_of(_crop_source_yolo(frames_u8), frame_of, boxes, valid, frame_hw, n)


def clip_crop_gdino(frames_u8: torch.Tensor, frame_of, boxes, valid,
                    frame_hw: Tuple[int, int], det_hw: Tuple[int, int], mean, std,
                    n: int = 224) -> torch.Tensor:
    """Device CLIP crops, Grounding-DINO mode: the detector-scale
    INTER_LINEAR, the ImageNet normalise and its wrap, then the crop and the
    CLIP transform. See :func:`clip_crop_batch`."""
    return _clip_crops_of(_crop_source_gdino(frames_u8, det_hw, mean, std), frame_of, boxes,
                          valid, frame_hw, n)


def clip_crop_batch(frames_u8: torch.Tensor, frame_of, boxes, valid, mode: str,
                    frame_hw: Tuple[int, int], det_hw: Optional[Tuple[int, int]] = None,
                    mean=None, std=None, n: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 device frames, the (K,) frame of each crop and
    (K, 4) float32 xyxy boxes in ``frame_hw`` coordinates -> (K, n, n, 3)
    float32 holding the uint8-valued crops the host path would have
    uploaded; crops whose ``valid`` is False, or whose rectangle is empty,
    are zeros. ``mode``: ``"yolo"`` (:func:`clip_crop_yolo`) or ``"gdino"``
    (:func:`clip_crop_gdino`, with ``det_hw``, ``mean`` and ``std``)."""
    if mode == "yolo":
        return clip_crop_yolo(frames_u8, frame_of, boxes, valid, frame_hw, n)
    if mode == "gdino":
        return clip_crop_gdino(frames_u8, frame_of, boxes, valid, frame_hw, det_hw, mean, std, n)
    raise ValueError(f"unknown crop mode {mode!r}")
