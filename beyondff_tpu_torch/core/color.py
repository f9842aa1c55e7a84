"""YCrCb 4:2:0 frame transport: frames cross to the device at 1.5 bytes a
pixel instead of 3.

The port's copy of beyondff_tpu/core/color.py. The source frames are JPEGs,
which already store chroma at 4:2:0, so shipping full-range YCrCb with 2x2
subsampled chroma keeps nearly all of the file's information at half the
bytes of dense RGB. The host packs with OpenCV's JPEG-convention YCrCb
(``COLOR_RGB2YCrCb``) and INTER_AREA 2x2 chroma averaging, the same bytes as
the JAX package; the device upsamples the chroma bilinearly (the JAX
package's ``jax.image.resize``, core/resize.linear_axis) and inverts the
conversion (R = Y + 1.403 (Cr - 128), ...) with the multiply-adds fused as
XLA:CPU fuses them, then rounds half to even and clips, into the uint8 RGB
buffer the detectors and SAM read. ``BFF_SEG2D_YUV=0`` restores dense RGB
uploads (pipeline/segmentation_2d.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from beyondff_tpu_torch.core.resize import fma, linear_axis
from beyondff_tpu_torch.utils.host_copy import to_device


def pack_ycrcb420(img: np.ndarray) -> np.ndarray:
    """uint8 RGB (H, W, 3) -> one flat uint8 buffer [Y | Cr/2x2 | Cb/2x2].

    Odd dimensions pad by edge replication to even before the chroma
    subsampling (the device slices the pad away). Length He*We +
    2*(He/2)*(We/2) = 1.5*He*We bytes."""
    import cv2

    h, w = img.shape[:2]
    he, we = h + (h & 1), w + (w & 1)
    if (he, we) != (h, w):
        img = np.pad(img, ((0, he - h), (0, we - w), (0, 0)), mode="edge")
    ycrcb = cv2.cvtColor(np.ascontiguousarray(img), cv2.COLOR_RGB2YCrCb)
    # INTER_AREA at exactly 2x downscale is the 2x2 box average
    cr = cv2.resize(ycrcb[:, :, 1], (we // 2, he // 2), interpolation=cv2.INTER_AREA)
    cb = cv2.resize(ycrcb[:, :, 2], (we // 2, he // 2), interpolation=cv2.INTER_AREA)
    return np.concatenate([ycrcb[:, :, 0].reshape(-1), cr.reshape(-1), cb.reshape(-1)])


def unpack(buf: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, 1.5*He*We) uint8 packed buffers -> (B, h, w, 3) uint8 RGB on
    their device."""
    b = buf.shape[0]
    he, we = h + (h & 1), w + (w & 1)
    y = buf[:, :he * we].reshape(b, he, we).float()
    chroma = buf[:, he * we:].reshape(b, 2, he // 2, we // 2).float()
    # bilinear chroma upsampling (exact in float32: integer planes, weights
    # 1/4, 3/4 and 1), pairs with the 2x2 box average
    up = linear_axis(linear_axis(chroma, we, 3, fused=True), he, 2, fused=True)
    cr, cb = (up - 128.0).unbind(1)
    # exact inverse of OpenCV's COLOR_RGB2YCrCb (JPEG full-range constants)
    r = fma(1.403, cr, y)
    g = fma(-0.344, cb, fma(-0.714, cr, y))
    bl = fma(1.773, cb, y)
    rgb = torch.stack([r, g, bl], -1).round().clamp(0.0, 255.0).to(torch.uint8)
    return rgb[:, :h, :w]


def upload_frame(img: np.ndarray, device, yuv: bool = True) -> torch.Tensor:
    """uint8 RGB host frame -> uint8 RGB (H, W, 3) on ``device``, crossing
    as YCrCb 4:2:0 (``yuv=False``: dense RGB)."""
    return upload_frames([img], device, yuv)[0]


def upload_frames(imgs: Sequence[np.ndarray], device, yuv: bool = True) -> torch.Tensor:
    """Same-size uint8 RGB host frames -> one (B, H, W, 3) uint8 RGB batch on
    ``device`` in a single host-to-device copy."""
    if not yuv:
        return to_device(np.stack(list(imgs)), device)
    h, w = imgs[0].shape[:2]
    packed = to_device(np.stack([pack_ycrcb420(im) for im in imgs]), device)
    return unpack(packed, h, w)


def wire_bytes(h: int, w: int, yuv: bool = True) -> int:
    """Bytes one (h, w) frame puts on the host-to-device copy."""
    he, we = h + (h & 1), w + (w & 1)
    return he * we + 2 * (he // 2) * (we // 2) if yuv else 3 * h * w


def roundtrip_host(img: np.ndarray) -> np.ndarray:
    """numpy oracle of ``upload_frame(img, yuv=True)`` (tests and A/B): the
    same pack and a float64 mirror of the device unpack."""
    h, w = img.shape[:2]
    he, we = h + (h & 1), w + (w & 1)
    buf = pack_ycrcb420(img)
    y = buf[:he * we].reshape(he, we).astype(np.float32)
    n = (he // 2) * (we // 2)
    cr = buf[he * we:he * we + n].reshape(he // 2, we // 2).astype(np.float32)
    cb = buf[he * we + n:].reshape(he // 2, we // 2).astype(np.float32)
    cr = _bilinear_x2(cr, he, we) - 128.0
    cb = _bilinear_x2(cb, he, we) - 128.0
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    b = y + 1.773 * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)[:h, :w]


def _bilinear_x2(p: np.ndarray, he: int, we: int) -> np.ndarray:
    """numpy bilinear at exact 2x, half-pixel centres, edge clamped."""
    hh, ww = p.shape
    ys = (np.arange(he) + 0.5) / 2.0 - 0.5
    xs = (np.arange(we) + 0.5) / 2.0 - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, hh - 1)
    y1 = np.clip(y0 + 1, 0, hh - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, ww - 1)
    x1 = np.clip(x0 + 1, 0, ww - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = p[y0][:, x0] * (1 - fx) + p[y0][:, x1] * fx
    bot = p[y1][:, x0] * (1 - fx) + p[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy
