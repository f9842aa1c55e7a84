"""uint8 image resizes that reproduce OpenCV's ``cv2.resize``, in torch.

The JAX package resizes frames and crops on the host with ``cv2.resize``
(SAM scale, the detector-size crop source, the CLIP crop transform). The
port does the same arithmetic in torch, so it runs where the frames are —
on the card in the 2D stage, on the CPU in the tests — with no OpenCV:

* ``resize_linear`` is bit-exact to ``INTER_LINEAR`` on uint8: coefficients
  in float32 at ``(dx + 0.5) * scale - 0.5`` rounded to 11-bit fixed point,
  out-of-range columns pinned to the edge pixel, out-of-range rows keeping
  their fractional weights over clamped row indices, an exact integer
  horizontal pass and OpenCV's vector vertical pass (``>> 4``, high-half
  multiply, ``(x + 2) >> 2``);
* ``resize_cubic`` is bit-exact to OpenCV's own ``INTER_CUBIC`` (Keys,
  A = -0.75): the same 11-bit coefficients and exact integer horizontal
  pass, then OpenCV's vector vertical pass in float32
  (``S0*b0 + (S1*b1 + (S2*b2 + S3*b3))``, each product and sum rounded on
  its own, then rounded half to even). OpenCV builds that hand
  ``INTER_CUBIC`` to Intel IPP (the pip wheels, through their IPP HAL)
  compute it in float and differ from this by one level on about 5% of the
  values; ``cv2.ipp.setUseIPP(False)`` restores OpenCV's own arithmetic
  there. ``INTER_LINEAR`` takes OpenCV's own path either way.

All arithmetic is integer except the cubic vertical pass, whose float32
multiplies and adds run as separate elementwise ops (no fused multiply-add),
so CPU and CUDA give the same bytes. Both are pinned against ``cv2.resize``
in tests/test_torch_seg2d.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _saturate_short(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x), -32768, 32767).astype(np.int64)


def _src_pos(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    scale = src / dst  # float64, as OpenCV's 1 / inv_scale
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(np.float32)).astype(np.float32)


def _linear_taps(src: int, dst: int, clamp: bool):
    """``clamp``: OpenCV pins out-of-range COLUMN positions to the edge
    pixel with weight 1; out-of-range ROWS keep their fractional weights
    over the clamped row indices."""
    s, f = _src_pos(src, dst)
    if clamp:
        low = s < 0
        high = s >= src - 1
        f = np.where(low | high, np.float32(0), f).astype(np.float32)
        s = np.where(low, 0, np.where(high, src - 1, s))
    one = np.float32(1)
    coef = np.stack([one - f, f], -1) * np.float32(_COEF_SCALE)
    idx = np.clip(np.stack([s, s + 1], -1), 0, src - 1)
    return idx, _saturate_short(coef.astype(np.float32))


def _cubic_taps(src: int, dst: int):
    s, x = _src_pos(src, dst)
    a = np.float32(-0.75)
    one = np.float32(1)
    x1 = x + one
    c0 = ((a * x1 - np.float32(5) * a) * x1 + np.float32(8) * a) * x1 - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    x2 = one - x
    c2 = ((a + np.float32(2)) * x2 - (a + np.float32(3))) * x2 * x2 + one
    c3 = one - c0 - c1 - c2
    coef = np.stack([c0, c1, c2, c3], -1).astype(np.float32) * np.float32(_COEF_SCALE)
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, _saturate_short(coef.astype(np.float32))


def _taps(src: int, dst: int, kind: str, device):
    idx, coef = _TAPS[kind](src, dst)
    return (torch.as_tensor(idx, device=device),
            torch.as_tensor(coef.astype(np.int32), device=device))


def _resize(img, size_hw: Tuple[int, int], cubic: bool):
    """img: uint8 (H, W, C) or (B, H, W, C), numpy or torch; returns the
    same kind (a tensor stays on its device)."""
    as_numpy = isinstance(img, np.ndarray)
    x = torch.from_numpy(np.ascontiguousarray(img)) if as_numpy else img
    if x.dtype != torch.uint8 or x.dim() not in (3, 4):
        raise TypeError(f"resize takes uint8 (H, W, C) or (B, H, W, C), got "
                        f"{x.dtype} {tuple(x.shape)}")
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, sh, sw, _ = x.shape
    dh, dw = int(size_hw[0]), int(size_hw[1])
    if (dh, dw) == (sh, sw):
        out = x.clone()
    else:
        dev = x.device
        s = x.to(torch.int32)
        if cubic:
            xi, xa = _taps(sw, dw, "cubic", dev)
            yi, ya = _taps(sh, dh, "cubic", dev)
        else:
            xi, xa = _taps(sw, dw, "linear_cols", dev)
            yi, ya = _taps(sh, dh, "linear_rows", dev)
        k = xi.shape[1]
        h = s.index_select(2, xi[:, 0]) * xa[:, 0, None]
        for j in range(1, k):
            h = h + s.index_select(2, xi[:, j]) * xa[:, j, None]  # exact int32
        rows = [h.index_select(1, yi[:, j]) for j in range(k)]  # (B, dh, dw, C)
        if cubic:
            scale = torch.tensor(1.0 / (_COEF_SCALE * _COEF_SCALE), dtype=torch.float32)
            b = (ya.to(torch.float32) * scale.to(dev))[:, :, None, None]
            acc = torch.mul(rows[3].to(torch.float32), b[:, 3])
            for j in (2, 1, 0):
                acc = torch.add(torch.mul(rows[j].to(torch.float32), b[:, j]), acc)
            out = torch.round(acc)
        else:
            b = ya[:, :, None, None]
            out = ((((rows[0] >> 4) * b[:, 0]) >> 16) + (((rows[1] >> 4) * b[:, 1]) >> 16)
                   + 2) >> 2
        out = out.clamp(0, 255).to(torch.uint8)
    if squeeze:
        out = out[0]
    return out.numpy() if as_numpy else out


_TAPS = {
    "cubic": functools.lru_cache(maxsize=64)(_cubic_taps),
    "linear_cols": functools.lru_cache(maxsize=64)(lambda s, d: _linear_taps(s, d, True)),
    "linear_rows": functools.lru_cache(maxsize=64)(lambda s, d: _linear_taps(s, d, False)),
}


def resize_linear(img, size_hw: Tuple[int, int]):
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` for uint8."""
    return _resize(img, size_hw, cubic=False)


def resize_cubic(img, size_hw: Tuple[int, int]):
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)`` for uint8."""
    return _resize(img, size_hw, cubic=True)
