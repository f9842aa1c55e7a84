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

from beyondff_tpu_torch.utils.host_copy import to_device

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
    return to_device(idx, device), to_device(coef.astype(np.int32), device)


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
            # a 0-d CPU tensor enters the product as a scalar: no upload
            b = (ya.to(torch.float32) * scale)[:, :, None, None]
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



# ------------------------------------------------ the JAX package's device resize
@functools.lru_cache(maxsize=64)
def linear_taps(n_in: int, n_out: int, antialias: bool = True):
    """``jax.image.resize(..., "linear", antialias=antialias)`` weights along
    one axis, as XLA computes them: the sample position ``(i + 0.5) *
    inv_scale - 0.5`` is one fused multiply-add, the triangle (widened by
    the downscale factor under ``antialias``) weights are normalised
    by their column sum in float32 (so the edge rows of an exact 2x
    upsample equal the edge pixel), samples outside the input are zeroed.
    Returns (index, weight) of shape (taps, n_out) each, the taps of every
    output in ascending input order (zero-weight padded)."""
    inv = np.float32(1.0 / (n_out / n_in))
    ar = np.arange(n_out, dtype=np.float32) + np.float32(0.5)
    s = (ar.astype(np.float64) * np.float64(inv) - 0.5).astype(np.float32)
    kernel_scale = np.float32(max(1.0 / (n_out / n_in), 1.0) if antialias else 1.0)
    x = np.abs(s[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    wts = np.maximum(np.float32(0), np.float32(1) - x).astype(np.float32)
    tot = wts.sum(0, keepdims=True, dtype=np.float32)
    wts = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                   wts / np.where(tot != 0, tot, np.float32(1)), np.float32(0)).astype(np.float32)
    inside = (s >= -0.5) & (s <= n_in - 0.5)
    wts = np.where(inside[None, :], wts, np.float32(0)).astype(np.float32)
    nz = wts != 0
    taps = max(1, int(nz.sum(0).max()))
    first = np.where(nz.any(0), nz.argmax(0), 0)
    idx = np.minimum(first[None, :] + np.arange(taps)[:, None], n_in - 1)
    wt = np.take_along_axis(wts, idx, 0)
    wt[first[None, :] + np.arange(taps)[:, None] > n_in - 1] = 0  # past the edge
    return idx, wt


def taps_axis(x: torch.Tensor, idx, wt, axis: int, fused: bool) -> torch.Tensor:
    """Contract one axis of float32 ``x`` with (taps, n_out) ``idx`` and
    ``wt``, summing taps in their order; ``fused``: each step after the
    first is a fused multiply-add (XLA:CPU's GEMM accumulation), else the
    products round on their own before the sum."""
    idx = to_device(idx, x.device)
    wt = to_device(wt, x.device)
    shape = [1] * x.dim()
    shape[axis] = idx.shape[1]
    acc = None
    for t in range(idx.shape[0]):
        term_w = wt[t].view(shape)
        tap = x.index_select(axis, idx[t])
        if acc is None:
            acc = term_w * tap
        elif fused:
            acc = fma(term_w, tap, acc)
        else:
            acc = acc + term_w * tap
    return acc


def linear_axis(x: torch.Tensor, n_out: int, axis: int, fused: bool,
                antialias: bool = True) -> torch.Tensor:
    """One axis of ``jax.image.resize(..., "linear")``: :func:`taps_axis`
    with :func:`linear_taps`."""
    idx, wt = linear_taps(x.shape[axis], n_out, antialias)
    return taps_axis(x, idx, wt, axis, fused)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int], h_dim: int) -> torch.Tensor:
    """float32 ``x`` resized along dims ``h_dim`` and ``h_dim + 1`` to
    ``out_hw`` as ``jax.image.resize(..., "bilinear", antialias=False)``
    computes it on XLA:CPU: one einsum over both axes, whose contraction
    order takes the cheaper axis first, each a fused multiply-add
    accumulation. An axis whose size does not change is left alone."""
    (h, w), (oh, ow) = x.shape[h_dim:h_dim + 2], out_hw
    axes = [(n, d) for n, d in ((oh, h_dim), (ow, h_dim + 1)) if x.shape[d] != n]
    if len(axes) == 2 and h * ow * (w + oh) < oh * w * (h + ow):
        axes.reverse()  # the width axis first costs fewer operations
    for n, d in axes:
        x = linear_axis(x, n, d, fused=True, antialias=False)
    return x


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA:CPU's fused multiply-add
    computes it (the product of two float32 values is exact in float64)."""
    a, b, c = (torch.as_tensor(v).double() for v in (a, b, c))
    return (a * b + c).float()
