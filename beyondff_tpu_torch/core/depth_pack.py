"""Depth-pack, a lossless block transport for uint16 depth maps.

The port's copy of beyondff_tpu/core/depth_pack.py. Indoor depth maps are
piecewise smooth, so neighbour deltas are small; frames cross to the device
packed and the device rebuilds the exact uint16 frame:

  host    the native runtime's single pass (utils/native.py,
          ``bff_depth_pack``; numpy under ``BFF_NO_NATIVE``): 64-pixel
          blocks, per block the first pixel as a uint16 base, an int8 slope
          predictor (the block's median neighbour delta) and zigzag-coded
          residuals at a width class k in {0, 2, 4, 8, 16} bits; residuals
          that do not fit store 0 and escape to a (position, int32
          correction) side channel;
  device  one word-granular gather per block, the class-conditional
          unzigzag, the escape corrections added to the deltas before the
          per-block prefix sum, and the bases: the uint16 (H, W) frame, as
          the int16 bit pattern that ``geometry.prepare_depth`` reads.

Wire layout per frame (caps bucketed; byte-identical to the JAX package's):
  [ classes:u8 x nb | preds:i8 x nb | bases:u16LE x nb | stream:u8 x scap
    | esc_pos:i32LE x ecap | esc_corr:i32LE x ecap ]
A spill guard returns ``None`` where packing would not beat the raw 2 bytes
a pixel (noise-like content); callers upload the raw frame.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

BLOCK = 64
_KS = (0, 2, 4, 8, 16)
_KBYTES = (0, 16, 32, 64, 128)  # payload bytes of a 64-pixel block per class
_LIMS = (1, 4, 16, 256, 65536)  # first zigzag value that escapes, per class


def _bucket(n: int, base: int) -> int:
    if n <= base:
        return base
    k = math.ceil(math.log(n / base) / math.log(1.25))
    return int(math.ceil(base * 1.25 ** k))


@dataclass
class DepthPacked:
    """One packed frame: the wire buffer and its decode geometry."""

    hw: Tuple[int, int]
    wire: np.ndarray  # uint8 (4*nb + scap + 8*ecap,)
    scap: int
    ecap: int

    @property
    def n_blocks(self) -> int:
        h, w = self.hw
        return -(-h * w // BLOCK)

    @property
    def nbytes(self) -> int:
        return self.wire.nbytes


def _zigzag_costs(flat: np.ndarray):
    px = flat.reshape(-1, BLOCK).astype(np.int64)
    d = np.diff(px, axis=1, prepend=px[:, :1])  # d[:, 0] == 0
    pred = np.clip(np.median(d[:, 1:], axis=1), -127, 127).astype(np.int64)
    r = d - pred[:, None]
    z = np.where(r >= 0, 2 * r, -2 * r - 1)
    z[:, 0] = 0  # pixel 0 stays out of the predicted chain
    costs = np.stack([_KBYTES[c] + 8 * (z >= _LIMS[c]).sum(1) for c in range(len(_KS))])
    return px, pred, r, z, costs


def _pack_arrays_numpy(flat: np.ndarray):
    """numpy mirror of the native packer (``BFF_NO_NATIVE`` and tests).
    ``flat``: uint16 of a length that is a multiple of ``BLOCK``. Returns
    (classes u8, preds i8, bases u16, stream u8, esc_pos i32, esc_corr
    i32)."""
    nb = flat.size // BLOCK
    px, pred, r, z, costs = _zigzag_costs(flat)
    best_c = np.argmin(costs, axis=0).astype(np.uint8)  # ties: the smaller k
    lim = np.array(_LIMS, np.int64)[best_c]
    escm = z >= lim[:, None]
    zz = np.where(escm, 0, z)
    esc_pos = np.flatnonzero(escm).astype(np.int32)
    esc_corr = r.reshape(-1)[esc_pos].astype(np.int32)
    parts = []
    for b in range(nb):
        k = _KS[best_c[b]]
        zb = zz[b]
        if k == 2:
            parts.append((zb[0::4] | (zb[1::4] << 2) | (zb[2::4] << 4)
                          | (zb[3::4] << 6)).astype(np.uint8))
        elif k == 4:
            parts.append((zb[0::2] | (zb[1::2] << 4)).astype(np.uint8))
        elif k == 8:
            parts.append(zb.astype(np.uint8))
        elif k == 16:
            parts.append(zb.astype("<u2").view(np.uint8))
    stream = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return (best_c, pred.astype(np.int8), px[:, 0].astype(np.uint16), stream,
            esc_pos, esc_corr)


def _pack_arrays(flat: np.ndarray):
    """The native packer, numpy under ``BFF_NO_NATIVE``."""
    from beyondff_tpu_torch.utils import native

    out = native.depth_pack_native(flat)
    return out if out is not None else _pack_arrays_numpy(flat)


def estimate_wire_ratio(flat: np.ndarray, stride: int = 16) -> float:
    """Estimated wire/raw ratio from every ``stride``-th block's class costs,
    without building the stream: the pre-check that lets noise frames skip
    the full pack."""
    nb = flat.size // BLOCK
    costs = _zigzag_costs(flat.reshape(nb, BLOCK)[::stride].reshape(-1))[4]
    per_block = costs.min(axis=0).mean() + 4  # + the header bytes of a block
    return float(per_block * nb / (2 * flat.size))


def pack(depth: np.ndarray, max_bytes: Optional[int] = None) -> Optional[DepthPacked]:
    """Pack one uint16 depth map; ``None`` when the wire would not beat the
    raw 2 bytes a pixel (the spill guard)."""
    h, w = depth.shape
    if max_bytes is None:
        max_bytes = 2 * h * w
    flat = np.ascontiguousarray(depth.reshape(-1), np.uint16)
    pad = (-flat.size) % BLOCK
    if pad:
        flat = np.concatenate([flat, np.full(pad, flat[-1], np.uint16)])
    if estimate_wire_ratio(flat) * 2 * flat.size >= 0.98 * max_bytes:
        return None  # clearly incompressible: skip the full scan
    classes, preds, bases, stream, esc_pos, esc_corr = _pack_arrays(flat)
    nb = classes.size
    if 4 * nb + stream.size + 8 * esc_pos.size >= max_bytes:
        return None
    # scap stays a multiple of 4: every class payload is, so block offsets
    # are word-aligned and the device reads the stream as 32-bit words
    scap = -(-_bucket(max(int(stream.size), 1), 4096) // 4) * 4
    ecap = _bucket(max(int(esc_pos.size), 1), 256)
    if 4 * nb + scap + 8 * ecap >= max_bytes:
        return None
    wire = np.zeros(4 * nb + scap + 8 * ecap, np.uint8)
    wire[:nb] = classes
    wire[nb:2 * nb] = preds.view(np.uint8)
    wire[2 * nb:4 * nb] = bases.astype("<u2").view(np.uint8)
    wire[4 * nb:4 * nb + stream.size] = stream
    o = 4 * nb + scap
    # padding escapes point one past the padded pixel range
    pos = np.full(ecap, nb * BLOCK, np.int32)
    pos[:esc_pos.size] = esc_pos
    wire[o:o + 4 * ecap] = pos.astype("<i4").view(np.uint8)
    corr = np.zeros(ecap, np.int32)
    corr[:esc_corr.size] = esc_corr
    wire[o + 4 * ecap:] = corr.astype("<i4").view(np.uint8)
    return DepthPacked(hw=(h, w), wire=wire, scap=scap, ecap=ecap)


# content-addressed pack cache: a sweep reads the same depth frames once per
# (class, scene); keyed on the frame's bytes, a repeat costs a hash. Spills
# cache as None.
_PACK_CACHE: "OrderedDict[bytes, Optional[DepthPacked]]" = OrderedDict()
_PACK_CACHE_CAP = 512


def pack_cached(depth: np.ndarray, max_bytes: Optional[int] = None) -> Optional[DepthPacked]:
    """:func:`pack` behind a content-addressed LRU (blake2b of the bytes)."""
    key = (hashlib.blake2b(depth.tobytes(), digest_size=16).digest()
           + str(depth.shape).encode() + str(max_bytes).encode())
    if key in _PACK_CACHE:
        _PACK_CACHE.move_to_end(key)
        return _PACK_CACHE[key]
    out = pack(depth, max_bytes=max_bytes)
    _PACK_CACHE[key] = out
    if len(_PACK_CACHE) > _PACK_CACHE_CAP:
        _PACK_CACHE.popitem(last=False)
    return out


# --------------------------------------------------------------- device side
def _le32(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) little-endian bytes as int32, two's complement: assembled in
    int64, then wrapped as the JAX package's int32 shifts wrap."""
    b = b.to(torch.int64)
    v = b[..., 0] + (b[..., 1] << 8) + (b[..., 2] << 16) + (b[..., 3] << 24)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _decode(wire: torch.Tensor, hw: Tuple[int, int], scap: int, ecap: int) -> torch.Tensor:
    """(B, 4*nb + scap + 8*ecap) uint8 wires -> (B, H, W) int16 holding the
    uint16 frames' bit patterns, on their device. Integer arithmetic in
    int32 (torch's uint16 has few operations)."""
    dev = wire.device
    b = wire.shape[0]
    h, w = hw
    n_px = h * w
    nb = -(-n_px // BLOCK)
    cls = wire[:, :nb].to(torch.int32)
    preds = wire[:, nb:2 * nb].view(torch.int8).to(torch.int32)
    bases = (wire[:, 2 * nb:4 * nb:2].to(torch.int32)
             + 256 * wire[:, 2 * nb + 1:4 * nb:2].to(torch.int32))
    o = 4 * nb + scap
    esc_pos = _le32(wire[:, o:o + 4 * ecap].reshape(b, ecap, 4)).to(torch.int64)
    esc_corr = _le32(wire[:, o + 4 * ecap:].reshape(b, ecap, 4))

    nbytes = torch.as_tensor(_KBYTES, dtype=torch.int32, device=dev)[cls.long()]
    offs = torch.cumsum(nbytes, dim=1, dtype=torch.int32) - nbytes  # exclusive
    j = torch.arange(BLOCK, dtype=torch.int32, device=dev)
    # one word-granular gather per block: class payloads are 4-byte
    # multiples, so block offsets are word-aligned; the 32-word (128-byte,
    # k=16) window of every block, the class's bytes sliced out of it
    words = wire[:, 4 * nb:o].reshape(b, scap // 4, 4).to(torch.int64)
    words = words[..., 0] | (words[..., 1] << 8) | (words[..., 2] << 16) | (words[..., 3] << 24)
    widx = torch.clamp(offs[:, :, None] // 4 + torch.arange(32, dtype=torch.int32, device=dev),
                       0, scap // 4 - 1).long()
    wv = torch.gather(words, 1, widx.reshape(b, -1)).reshape(b, nb, 32)

    def byte(i):  # per-block byte indices -> (B, nb, len(i)) values
        return ((wv[:, :, (i // 4).long()] >> (8 * (i % 4)).long()) & 255).to(torch.int32)

    z2 = (byte(j // 4) >> (2 * (j % 4))) & 3
    b4 = byte(j // 2)
    z4 = torch.where(j % 2 == 0, b4 & 15, b4 >> 4)
    z8 = byte(j)
    z16 = byte(2 * j) + 256 * byte(2 * j + 1)
    c = cls[:, :, None]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    z = torch.where(c == 0, zero, torch.where(c == 1, z2, torch.where(
        c == 2, z4, torch.where(c == 3, z8, z16))))
    resid = torch.where(z % 2 == 0, z // 2, -((z + 1) // 2))
    delta = torch.where(j == 0, zero, resid + preds[:, :, None])
    # the escape corrections land in the deltas before the prefix sum, so
    # the chain after an escape stays exact; padding escapes point at the
    # extra slot nb*BLOCK, dropped after the adds (escapes are unique, so the
    # integer adds are exact in any order)
    flat = torch.cat([delta.reshape(b, -1), torch.zeros(b, 1, dtype=torch.int32, device=dev)], 1)
    flat.scatter_add_(1, esc_pos, esc_corr)
    vals = bases[:, :, None] + torch.cumsum(flat[:, :nb * BLOCK].reshape(b, nb, BLOCK), dim=2,
                                            dtype=torch.int32)
    vals = vals.reshape(b, -1)[:, :n_px]
    return torch.where(vals >= 32768, vals - 65536, vals).to(torch.int16).reshape(b, h, w)


def upload_frame(packed: DepthPacked, device) -> torch.Tensor:
    """A packed depth frame -> (H, W) int16 (uint16 bits) on ``device``;
    only the wire bytes cross."""
    return upload_frames([packed], device)[0]


def rebucket(packed: DepthPacked, scap: int, ecap: int) -> DepthPacked:
    """Grow a packed frame's caps (frames batched into one bucket)."""
    if (scap, ecap) == (packed.scap, packed.ecap):
        return packed
    nb = packed.n_blocks
    wire = np.zeros(4 * nb + scap + 8 * ecap, np.uint8)
    o, os_, oe = packed.wire, packed.scap, packed.ecap
    wire[:4 * nb + os_] = o[:4 * nb + os_]
    # padding escapes keep pointing one past the pixel range
    pos = np.full(ecap, nb * BLOCK, np.int32)
    pos.view(np.uint8)[:4 * oe] = o[4 * nb + os_:4 * nb + os_ + 4 * oe]
    wire[4 * nb + scap:4 * nb + scap + 4 * ecap] = pos.astype("<i4").view(np.uint8)
    wire[4 * nb + scap + 4 * ecap:4 * nb + scap + 4 * ecap + 4 * oe] = (
        o[4 * nb + os_ + 4 * oe:])
    return DepthPacked(hw=packed.hw, wire=wire, scap=scap, ecap=ecap)


def upload_frames(packs: List[DepthPacked], device) -> torch.Tensor:
    """Same-size packed frames -> one (B, H, W) int16 batch on ``device``
    from one copy of the stacked wires (frames rebucket to the largest
    caps)."""
    hw = packs[0].hw
    if any(p.hw != hw for p in packs):
        raise ValueError("upload_frames: mixed depth dims")
    scap = max(p.scap for p in packs)
    ecap = max(p.ecap for p in packs)
    wire = np.stack([rebucket(p, scap, ecap).wire for p in packs])
    return _decode(torch.from_numpy(wire).to(device), hw, scap, ecap)


# ------------------------------------------------------------------- oracle
def roundtrip_host(packed: DepthPacked) -> np.ndarray:
    """numpy mirror of the device decode (tests): the uint16 frame."""
    h, w = packed.hw
    nb = packed.n_blocks
    wire = packed.wire
    cls = wire[:nb].astype(np.int64)
    preds = wire[nb:2 * nb].view(np.int8).astype(np.int64)
    bases = wire[2 * nb:4 * nb].view("<u2").astype(np.int64)
    stream = wire[4 * nb:4 * nb + packed.scap].astype(np.int64)
    o = 4 * nb + packed.scap
    esc_pos = wire[o:o + 4 * packed.ecap].view("<i4")
    esc_corr = wire[o + 4 * packed.ecap:].view("<i4")
    nbytes = np.asarray(_KBYTES)[cls]
    offs = np.cumsum(nbytes) - nbytes
    j = np.arange(BLOCK)

    def at(i):
        return stream[np.clip(offs[:, None] + i, 0, packed.scap - 1)]

    z2 = (at(j // 4) >> (2 * (j % 4))) & 3
    b4 = at(j // 2)
    z4 = np.where(j % 2 == 0, b4 & 15, b4 >> 4)
    z8 = at(j)
    z16 = at(2 * j) + 256 * at(2 * j + 1)
    c = cls[:, None]
    z = np.where(c == 0, 0, np.where(c == 1, z2, np.where(c == 2, z4,
                                                          np.where(c == 3, z8, z16))))
    resid = np.where(z % 2 == 0, z // 2, -((z + 1) // 2))
    flat_d = np.where(j == 0, 0, resid + preds[:, None]).reshape(-1)
    keep = esc_pos < nb * BLOCK
    np.add.at(flat_d, esc_pos[keep], esc_corr[keep])
    vals = bases[:, None] + np.cumsum(flat_d.reshape(nb, BLOCK), axis=1)
    return vals.reshape(-1)[:h * w].astype(np.uint16).reshape(h, w)
