"""JXT, the JPEG coefficient transport: a frame crosses to the device as its
file's quantized DCT coefficients, and the device finishes the decode.

The port's copy of beyondff_tpu/core/jxt.py. The seg2d frames are JPEG
files (ScanNet ``color/*.jpg``), and their quantized coefficients are far
sparser than pixels for natural images:

  host    the native runtime's entropy decode (utils/native.py, Huffman
          only, no IDCT), then a sparse pack of the nonzero coefficients
          into one uint8 wire buffer;
  device  unpack, dequantize, 8x8 inverse DCT (``C^T F C``, two batched
          matmuls), plane assembly, bilinear chroma upsampling, YCbCr to RGB.

Wire format, per frame (Ncap and Ecap are the frame's bucket caps):
  [ delta:u8 x Ncap | val:i8 x Ncap | esc_lo:u8 x Ecap | esc_hi:u8 x Ecap ]
  - positions are flat indices into the concatenated per-component dense
    coefficient tensors ([Y blocks | Cb blocks | Cr blocks] x 64, natural
    order within a block); ``delta`` holds consecutive differences, and
    gaps over 255 are bridged by zero-valued skip entries;
  - values are int8 with -128 an escape: the int16 value is read from the
    escape channel in order of appearance;
  - padding entries are (delta=0, val=0) and add 0 at the last position.
  A spill guard returns ``None`` where the packed frame would not beat the
  1.5 bytes a pixel of YCrCb (noise-like content, very high quality);
  callers then take core/color. The wire is byte-identical to the JAX
  package's, bucket caps included.

One native-resolution upload serves every consumer: the detector-scale and
SAM-scale buffers derive on the device (:func:`resize_frames`, the JAX
package's ``jax.image.resize``). The device arithmetic is float32 with the
JAX package's operations; where XLA:CPU fuses a multiply-add, so does this
(core/resize.fma). Accuracy against the file: within a few levels of
``cv2.imdecode`` (libjpeg's integer IDCT against a float IDCT).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from beyondff_tpu_torch.core.resize import fma, resize_bilinear
from beyondff_tpu_torch.utils.host_copy import to_device

# geometric wire-size buckets; the caps are part of the wire format
_BUCKET_BASE = 2048
_BUCKET_RATIO = 1.25


def _bucket(n: int, base: int = _BUCKET_BASE) -> int:
    if n <= base:
        return base
    k = math.ceil(math.log(n / base) / math.log(_BUCKET_RATIO))
    return int(math.ceil(base * _BUCKET_RATIO ** k))


def _bucket_small(n: int) -> int:
    return _bucket(n, base=256)


@dataclass(frozen=True)
class JxtGeometry:
    """A frame's block geometry (hashable)."""

    h: int
    w: int
    # per component: (block-grid h, block-grid w, samp_h, samp_v)
    comps: Tuple[Tuple[int, int, int, int], ...]

    @property
    def total_coeffs(self) -> int:
        return sum(bh * bw * 64 for bh, bw, _, _ in self.comps)


@dataclass
class JxtPacked:
    """One packed frame: the wire buffer and what the device decode needs."""

    geometry: JxtGeometry
    wire: np.ndarray          # uint8 (2*ncap + 2*ecap,)
    ncap: int
    ecap: int
    qsteps: np.ndarray        # float32 (ncomp, 64), natural order

    @property
    def nbytes(self) -> int:
        return self.wire.nbytes + self.qsteps.nbytes


def parse_file(blob: bytes):
    """Entropy-decode a JPEG with the native runtime; ``None`` (the caller
    takes a full host decode and YCrCb) for a file it does not take or
    under ``BFF_NO_NATIVE``."""
    from beyondff_tpu_torch.utils import native

    return native.jpeg_coeffs_native(blob)


def pack(dec: dict, max_bytes: Optional[int] = None) -> Optional[JxtPacked]:
    """Sparse-pack an entropy-decoded frame (``parse_file``'s output);
    ``None`` when the wire would reach ``max_bytes`` (default: the 1.5 bytes
    a pixel of YCrCb)."""
    h, w = dec["hw"]
    if max_bytes is None:
        max_bytes = int(1.5 * h * w)
    comps = dec["comps"]
    geometry = JxtGeometry(h=h, w=w, comps=tuple(
        (c["grid"][0], c["grid"][1], c["samp"][0], c["samp"][1]) for c in comps))
    flat = np.concatenate([c["coeffs"].reshape(-1) for c in comps])
    from beyondff_tpu_torch.utils import native

    scan = native.jxt_scan_native(flat)
    if scan is not None:
        total, n_nonzero, out_delta, out_val, esc = scan
        if 2 * n_nonzero >= max_bytes:  # at least 2 bytes a nonzero
            return None
        out_delta = out_delta[:total]
        out_val = out_val[:total]
    else:
        pos = np.flatnonzero(flat)
        vals = flat[pos]
        if 2 * pos.size >= max_bytes:
            return None
        # delta encode; gaps over 255 bridged by zero-valued skip entries
        deltas = np.diff(pos, prepend=0)
        nskip = np.maximum(deltas - 1, 0) // 255
        total = pos.size + int(nskip.sum())
        out_delta = np.full(total, 255, np.uint8)
        out_val = np.zeros(total, np.int8)
        slots = np.arange(pos.size) + np.cumsum(nskip)  # each nonzero's slot
        out_delta[slots] = (deltas - 255 * nskip).astype(np.uint8)
        esc_mask = (vals > 127) | (vals < -127)
        out_val[slots] = np.where(esc_mask, -128, vals).astype(np.int8)
        esc = vals[esc_mask].astype(np.int16)

    ncap, ecap = _bucket(total), _bucket_small(int(esc.size))
    if 2 * ncap + 2 * ecap >= max_bytes:
        return None
    wire = np.zeros(2 * ncap + 2 * ecap, np.uint8)
    wire[:total] = out_delta
    wire[ncap:ncap + total] = out_val.view(np.uint8)
    eu = esc.view(np.uint8).reshape(-1, 2)  # little-endian pairs
    wire[2 * ncap:2 * ncap + esc.size] = eu[:, 0]
    wire[2 * ncap + ecap:2 * ncap + ecap + esc.size] = eu[:, 1]
    qsteps = np.stack([c["qtab"].astype(np.float32) for c in comps])
    return JxtPacked(geometry=geometry, wire=wire, ncap=ncap, ecap=ecap, qsteps=qsteps)


def pack_file(blob: bytes, max_bytes: Optional[int] = None) -> Optional[JxtPacked]:
    dec = parse_file(blob)
    if dec is None:
        return None
    return pack(dec, max_bytes=max_bytes)


def rebucket(packed: JxtPacked, ncap: int, ecap: int) -> JxtPacked:
    """Grow a packed frame's caps (frames batched into one bucket)."""
    if (ncap, ecap) == (packed.ncap, packed.ecap):
        return packed
    wire = np.zeros(2 * ncap + 2 * ecap, np.uint8)
    o, n, e = packed.wire, packed.ncap, packed.ecap
    wire[:n] = o[:n]
    wire[ncap:ncap + n] = o[n:2 * n]
    wire[2 * ncap:2 * ncap + e] = o[2 * n:2 * n + e]
    wire[2 * ncap + ecap:2 * ncap + ecap + e] = o[2 * n + e:]
    return JxtPacked(geometry=packed.geometry, wire=wire, ncap=ncap, ecap=ecap,
                     qsteps=packed.qsteps)


# --------------------------------------------------------------- device side
def _idct_mat() -> np.ndarray:
    k = np.arange(8)
    u = np.arange(8)[:, None]
    c = np.cos((2 * k + 1) * u * np.pi / 16) * 0.5
    c[0] *= 1.0 / np.sqrt(2.0)
    return c.astype(np.float32)  # orthonormal: X = C^T F C


def _decode(wire: torch.Tensor, qsteps: torch.Tensor, geometry: JxtGeometry, ncap: int,
            ecap: int) -> torch.Tensor:
    """(B, 2*ncap + 2*ecap) uint8 wires and (B or 1, ncomp, 64) float32
    qsteps -> (B, h, w, 3) uint8 RGB on their device."""
    dev = wire.device
    b = wire.shape[0]
    delta = wire[:, :ncap].to(torch.int64)
    val = wire[:, ncap:2 * ncap].view(torch.int8).to(torch.int32)
    esc = (wire[:, 2 * ncap:2 * ncap + ecap].to(torch.int32)
           + 256 * wire[:, 2 * ncap + ecap:].to(torch.int32))
    esc = torch.where(esc >= 32768, esc - 65536, esc)

    pos = torch.cumsum(delta, dim=1)
    is_esc = val == -128
    eidx = torch.clamp(torch.cumsum(is_esc.to(torch.int64), dim=1) - 1, 0, ecap - 1)
    v = torch.where(is_esc, torch.gather(esc, 1, eidx), val).to(torch.float32)

    # dequantize: the step of (the block's component, index within the block)
    block_id = pos // 64
    comp_id = torch.zeros_like(block_id)
    acc = 0
    for bh, bw, _, _ in geometry.comps[:-1]:
        acc += bh * bw
        comp_id += (block_id >= acc).to(torch.int64)
    q = qsteps.expand(b, -1, -1).reshape(b, -1)
    v = v * torch.gather(q, 1, comp_id * 64 + pos % 64)

    # positions repeat only for the zero-valued skip and pad entries, and
    # x + 0 == x: the atomic adds on the card give the same bytes in any order
    dense = torch.zeros(b, geometry.total_coeffs, dtype=torch.float32, device=dev)
    dense.scatter_add_(1, pos, v)

    c = to_device(_idct_mat(), dev)
    planes, off = [], 0
    for bh, bw, _, _ in geometry.comps:
        nb = bh * bw
        f = dense[:, off * 64:(off + nb) * 64].reshape(b, nb, 8, 8)
        off += nb
        sp = torch.matmul(torch.matmul(c.T, f), c)
        planes.append(sp.reshape(b, bh, bw, 8, 8).transpose(2, 3).reshape(b, bh * 8, bw * 8)
                      + 128.0)

    h, w = geometry.h, geometry.w
    if len(planes) == 1:
        y = planes[0][:, :h, :w].round().clamp(0.0, 255.0).to(torch.uint8)
        return torch.stack([y, y, y], -1)
    hmax = max(sh for _, _, sh, _ in geometry.comps)
    vmax = max(sv for _, _, _, sv in geometry.comps)
    outs = []
    for (bh, bw, sh, sv), p in zip(geometry.comps, planes):
        ch = -(-h * sv // vmax)
        cw = -(-w * sh // hmax)
        fy, fx = vmax // sv, hmax // sh
        p = p[:, :ch, :cw]
        if (fy, fx) != (1, 1):
            # upsample at the exact integer sampling factor, then crop:
            # libjpeg's "fancy" upsampling works on the full subsampled grid
            p = resize_bilinear(p, (ch * fy, cw * fx), 1)[:, :h, :w]
        outs.append(p)
    y, cb, cr = outs[0], outs[1] - 128.0, outs[2] - 128.0
    # libjpeg's (ITU-R BT.601 full-range) constants, the file's colorspace
    r = fma(1.402, cr, y)
    g = fma(-0.714136, cr, fma(-0.344136, cb, y))
    bl = fma(1.772, cb, y)
    return torch.stack([r, g, bl], -1).round().clamp(0.0, 255.0).to(torch.uint8)


def upload_frame(packed: JxtPacked, device) -> torch.Tensor:
    """A packed frame -> uint8 RGB (H, W, 3) on ``device``; only the wire
    bytes (and the quantization steps) cross."""
    return upload_frames([packed], device)[0]


def upload_frames(packs: List[JxtPacked], device) -> torch.Tensor:
    """Packed frames -> one (B, H, W, 3) uint8 batch on ``device`` from one
    copy of the stacked wires (frames rebucket to the largest caps).

    Frames need not share a JPEG quality or a block geometry: quantization
    steps go per frame when they differ, and a batch mixing geometries (a
    grayscale or 4:4:4 frame among 4:2:0 ones) decodes frame by frame and
    stacks. All frames must share (h, w)."""
    geo = packs[0].geometry
    if any(p.geometry != geo for p in packs):
        if any((p.geometry.h, p.geometry.w) != (geo.h, geo.w) for p in packs):
            raise ValueError("upload_frames: mixed frame pixel dims")
        return torch.cat([upload_frames([p], device) for p in packs])
    ncap = max(p.ncap for p in packs)
    ecap = max(p.ecap for p in packs)
    packs = [rebucket(p, ncap, ecap) for p in packs]
    wire = to_device(np.stack([p.wire for p in packs]), device)
    if all(np.array_equal(p.qsteps, packs[0].qsteps) for p in packs[1:]):
        q = packs[0].qsteps[None]
    else:
        q = np.stack([p.qsteps for p in packs])
    return _decode(wire, to_device(q, device), geo, ncap, ecap)


def wire_bytes(packs: List[JxtPacked]) -> int:
    """Bytes :func:`upload_frames` copies to the device for ``packs``."""
    if any(p.geometry != packs[0].geometry for p in packs):
        return sum(wire_bytes([p]) for p in packs)
    n = 2 * max(p.ncap for p in packs) + 2 * max(p.ecap for p in packs)
    same_q = all(np.array_equal(p.qsteps, packs[0].qsteps) for p in packs[1:])
    return len(packs) * n + (1 if same_q else len(packs)) * packs[0].qsteps.nbytes


# ------------------------------------------------------------- device resize
def resize_frames(frames: torch.Tensor, dst_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, th, tw, 3) on the same device: bilinear
    with half-pixel centres and no antialias (``jax.image.resize``, the JAX
    package's device resize; within one level of OpenCV's INTER_LINEAR).
    Derives the detector- and SAM-scale buffers from one native-resolution
    upload."""
    x = resize_bilinear(frames.to(torch.float32), tuple(dst_hw), 1)
    return x.round().clamp(0.0, 255.0).to(torch.uint8)


def resize_frame(frame: torch.Tensor, dst_hw: Tuple[int, int]) -> torch.Tensor:
    """:func:`resize_frames` of one (H, W, 3) frame."""
    return resize_frames(frame[None], dst_hw)[0]


# ------------------------------------------------------------------- oracle
def _np_bilinear(p: np.ndarray, he: int, we: int) -> np.ndarray:
    """numpy bilinear upsampling, half-pixel centres at the true scale,
    edges clamped."""
    hh, ww = p.shape
    ys = (np.arange(he) + 0.5) * (hh / he) - 0.5
    xs = (np.arange(we) + 0.5) * (ww / we) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, hh - 1)
    y1 = np.clip(y0 + 1, 0, hh - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, ww - 1)
    x1 = np.clip(x0 + 1, 0, ww - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = p[y0][:, x0] * (1 - fx) + p[y0][:, x1] * fx
    bot = p[y1][:, x0] * (1 - fx) + p[y1][:, x1] * fx
    return top * (1 - fy) + bot * fy


def roundtrip_host(blob: bytes) -> Optional[np.ndarray]:
    """float64 numpy mirror of pack and device decode (tests and A/B): the
    uint8 RGB frame the device would build, or ``None`` where the native
    runtime does not take the file."""
    dec = parse_file(blob)
    if dec is None:
        return None
    h, w = dec["hw"]
    c = _idct_mat().astype(np.float64)
    planes = []
    for comp in dec["comps"]:
        bh, bw = comp["grid"]
        f = comp["coeffs"].astype(np.float64) * comp["qtab"].astype(np.float64)
        sp = np.einsum("ux,buv,vy->bxy", c, f.reshape(-1, 8, 8), c)
        planes.append(sp.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3)
                      .reshape(bh * 8, bw * 8) + 128.0)
    if len(planes) == 1:
        y = np.clip(np.round(planes[0][:h, :w]), 0, 255).astype(np.uint8)
        return np.stack([y, y, y], axis=-1)
    hmax = max(comp["samp"][0] for comp in dec["comps"])
    vmax = max(comp["samp"][1] for comp in dec["comps"])
    outs = []
    for comp, p in zip(dec["comps"], planes):
        ch = -(-h * comp["samp"][1] // vmax)
        cw = -(-w * comp["samp"][0] // hmax)
        fy, fx = vmax // comp["samp"][1], hmax // comp["samp"][0]
        p = p[:ch, :cw]
        if (fy, fx) != (1, 1):
            p = _np_bilinear(p, ch * fy, cw * fx)[:h, :w]
        outs.append(p)
    y, cb, cr = outs[0], outs[1] - 128.0, outs[2] - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.round(np.stack([r, g, b], axis=-1)), 0, 255).astype(np.uint8)
