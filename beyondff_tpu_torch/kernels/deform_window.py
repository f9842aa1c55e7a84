"""Multi-scale deformable sampling: the hand-written Hopper kernel and its
plain version.

Port of beyondff_tpu/kernels/deform_window.py (``build_assignment`` and
``sample_level_windowed``) together with the exact sampling of
beyondff_tpu/models/gdino/deformable.py. One CUDA kernel
(``csrc/ms_deform_sample.cu``, ``ms_deform_sample``) samples every level and
point of one deformable-attention call. Each level runs in one of two modes:

* exact (``None``): bilinear with zero padding outside the map, the
  reference op and ``ms_deform_attn(windowed=False)``;
* clamp (``(tile, radius)``): the TPU kernel's windowed semantics. Each
  query of the all-level raster owns the tile of its centre cell in that
  level (``build_assignment``); its samples clamp into the window
  ``[origin, origin + w3 - 2]`` with ``origin = tile_origin - radius`` and
  ``w3 = tile + 2 * radius``, contribute 0 unless ``-1 < g < size`` on both
  axes, and corners outside the map read 0.

The wrapper launches the kernel for CUDA tensors and raises on what it does
not take; CPU tensors take :func:`ms_deform_sample_plain`, a gather version
of both modes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from beyondff_tpu_torch.kernels import dispatch

TILE = 16  # default target-level cells per tile side, as in the JAX package
# Grounding-DINO's four levels (h, w) at its 800x1072 input (Swin-B): the
# main path's raster of 17 821 queries
ENC_SHAPES = ((100, 134), (50, 67), (25, 34), (13, 17))

Mode = Optional[Tuple[int, int]]  # None = exact, (tile, radius) = clamp
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class TileAssign:
    """Static bucketing of the all-level query raster into target-level tiles."""

    def __init__(self, idx, valid, inv, nty, ntx, s_pad, tile):
        self.idx = idx          # (tiles, S) query index per slot
        self.valid = valid      # (tiles, S) slot is a real query
        self.inv = inv          # (Q,) flat (tile*S + slot) per query
        self.nty, self.ntx = nty, ntx
        self.s_pad = s_pad
        self.tile = tile        # T: target-level cells per tile side

    def tile_yx(self) -> np.ndarray:
        """(Q, 2) int64 tile row and column of every query."""
        tid = self.inv // self.s_pad
        return np.stack([tid // self.ntx, tid % self.ntx], axis=-1)


def build_assignment(shapes: Tuple[Tuple[int, int], ...], level: int,
                     tile: int = TILE) -> TileAssign:
    """Bucket the concatenated all-level raster queries (the encoder token
    order) by their centre cell in level ``level``."""
    return _build_assignment_cached(tuple((int(h), int(w)) for h, w in shapes),
                                    int(level), int(tile))


@functools.lru_cache(maxsize=32)
def _build_assignment_cached(shapes, level, tile):
    h, w = shapes[level]
    cys, cxs = [], []
    for hh, ww in shapes:
        ys = (np.arange(hh) + 0.5) / hh
        xs = (np.arange(ww) + 0.5) / ww
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        cys.append(gy.reshape(-1))
        cxs.append(gx.reshape(-1))
    cy = np.concatenate(cys) * h - 0.5
    cx = np.concatenate(cxs) * w - 0.5
    q = cy.shape[0]
    nty, ntx = -(-h // tile), -(-w // tile)
    ty = np.clip((cy // tile).astype(np.int64), 0, nty - 1)
    tx = np.clip((cx // tile).astype(np.int64), 0, ntx - 1)
    tid = ty * ntx + tx
    n_tiles = nty * ntx
    order = np.argsort(tid, kind="stable")
    counts = np.bincount(tid, minlength=n_tiles)
    mx = int(counts.max())
    s_pad = 32 if mx <= 32 else -(-mx // 128) * 128
    idx = np.zeros((n_tiles, s_pad), np.int32)
    valid = np.zeros((n_tiles, s_pad), bool)
    off = 0
    for t in range(n_tiles):
        c = int(counts[t])
        idx[t, :c] = order[off:off + c]
        valid[t, :c] = True
        off += c
    inv = np.zeros(q, np.int64)
    inv[idx[valid]] = np.arange(n_tiles * s_pad).reshape(n_tiles, s_pad)[valid]
    return TileAssign(idx, valid, inv, nty, ntx, s_pad, tile)


@functools.lru_cache(maxsize=32)
def window_origins(shapes: Tuple[Tuple[int, int], ...], modes: Tuple[Mode, ...],
                   device: torch.device) -> torch.Tensor:
    """(L, Q, 2) int32 window origins (row, col) = tile_origin - radius for
    clamp levels, zeros for exact ones; built once per (shapes, modes,
    device) and kept on ``device``."""
    q = sum(h * w for h, w in shapes)
    out = np.zeros((len(shapes), q, 2), np.int32)
    for li, mode in enumerate(modes):
        if mode is None:
            continue
        tile, radius = mode
        out[li] = build_assignment(shapes, li, tile).tile_yx() * tile - radius
    return torch.from_numpy(out).to(device)


def raster_centers(shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """(Q, 2) float32 (x, y) centres in [0, 1] of the all-level raster's
    cells, level after level: the encoder's reference points."""
    cs = []
    for h, w in shapes:
        ys = (np.arange(h) + 0.5) / h
        xs = (np.arange(w) + 0.5) / w
        cs.append(np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2))
    return np.concatenate(cs, 0).astype(np.float32)


def sample_inputs(rng: np.random.Generator, anchors: np.ndarray, b: int, dtype: torch.dtype,
                  device, shapes: Sequence[Tuple[int, int]] = ENC_SHAPES, heads: int = 8,
                  hd: int = 32, p: int = 4):
    """Inputs of one call at the main path's widths, as the card checks and
    the A/B tool make them: locations at ``anchors`` ((Q, 2) x, y in [0, 1])
    plus offsets uniform within 12 cells of each level, every 17th query
    shifted by 1.5 (off the map at the large levels), and softmax weights
    over (level, point),
    all from ``rng``; ``value`` standard normal from torch's generator.
    Returns (value (b, S, heads, hd), locs (b, Q, heads, L, p, 2) f32,
    aw (b, Q, heads, L, p)) on ``device``, value and aw in ``dtype``."""
    s = sum(h * w for h, w in shapes)
    q, lv = anchors.shape[0], len(shapes)
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    off = rng.uniform(-12.0, 12.0, (b, q, heads, lv, p, 2)).astype(np.float32) / wh[:, None, :]
    locs = anchors[None, :, None, None, None, :] + off
    locs[:, ::17] += 1.5
    logits = rng.normal(size=(b, q, heads, lv * p)).astype(np.float32)
    aw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    value = torch.randn(b, s, heads, hd, device=device, dtype=torch.float32).to(dtype)
    return (value, torch.from_numpy(locs).to(device),
            torch.from_numpy(aw.reshape(b, q, heads, lv, p)).to(device, dtype))


def sample_bytes(value: torch.Tensor, locs: torch.Tensor, aw: torch.Tensor) -> int:
    """Bytes one call must move: each input read once and the (B, Q, H * D)
    output, in value's type, written once."""
    b, q, heads = locs.shape[:3]
    es = value.element_size()
    return (value.numel() * es + locs.numel() * locs.element_size() + aw.numel() * es
            + b * q * heads * value.shape[-1] * es)


def level_table(shapes: Tuple[Tuple[int, int], ...], modes: Tuple[Mode, ...]) -> ctypes.Array:
    """The kernel's per-level rows (h, w, start, w3): ``start`` is the
    level's first row of ``value``, ``w3`` 0 for an exact level and
    ``tile + 2 * radius`` for a clamp one."""
    levels = (ctypes.c_int * (4 * len(shapes)))()
    start = 0
    for li, (h, w) in enumerate(shapes):
        w3 = 0 if modes[li] is None else modes[li][0] + 2 * modes[li][1]
        levels[4 * li:4 * li + 4] = [h, w, start, w3]
        start += h * w
    return levels


def _check_modes(shapes, modes, q):
    modes = tuple(None if m is None else (int(m[0]), int(m[1])) for m in modes)
    if len(modes) != len(shapes):
        raise ValueError(f"{len(modes)} modes for {len(shapes)} levels")
    if any(m is not None for m in modes) and q != sum(h * w for h, w in shapes):
        raise ValueError("clamp mode needs the all-level query raster (Q = sum H*W)")
    return modes


def window_corner(gy: torch.Tensor, gx: torch.Tensor, ylo, yhi, xlo, xhi):
    """Corner (0, 0) cell (y0, x0) and fractions (fy, fx) of samples at cell
    coordinates (gy, gx), as the kernel computes them: each sample clamped
    into [ylo, yhi] x [xlo, xhi] (a clamp level's window
    ``[origin, origin + w3 - 2]``, an exact level's [-2, size + 1]), then
    floor and remainder. Clamping picks one of its operands, so a sample
    inside keeps its coordinates (the two modes agree bit for bit where
    nothing clamps) and one beyond lands on the edge, a whole cell."""
    cy, cx = torch.clamp(gy, ylo, yhi), torch.clamp(gx, xlo, xhi)
    y0f, x0f = torch.floor(cy), torch.floor(cx)
    return y0f.long(), x0f.long(), cy - y0f, cx - x0f


def clamped_samples(locs: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                    modes: Sequence[Mode]):
    """Per level, the (clamped, in map) masks (B, Q, heads, P) of ``locs``
    (B, Q, heads, L, P, 2) in [0, 1] over the all-level raster: a sample is
    in the map when -1 < g < size on both axes (g = loc * size - 0.5) and
    clamps when it is in the map and beyond its window
    ``[origin, origin + w3 - 2]`` on either axis; exact levels clamp none."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    modes = _check_modes(shapes, modes, locs.shape[1])
    origins = (window_origins(shapes, modes, locs.device).float()
               if any(m is not None for m in modes) else None)
    out = []
    for li, (h, w) in enumerate(shapes):
        gx = locs[:, :, :, li, :, 0].float() * w - 0.5
        gy = locs[:, :, :, li, :, 1].float() * h - 0.5
        inmap = (gy > -1.0) & (gy < float(h)) & (gx > -1.0) & (gx < float(w))
        clamped = torch.zeros_like(inmap)
        if modes[li] is not None:
            edge = float(modes[li][0] + 2 * modes[li][1] - 2)
            oy = origins[li, :, 0].view(1, -1, 1, 1)
            ox = origins[li, :, 1].view(1, -1, 1, 1)
            clamped = inmap & ((gy < oy) | (gy > oy + edge) | (gx < ox) | (gx > ox + edge))
        out.append((clamped, inmap))
    return out


def ms_deform_sample_plain(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                           locs: torch.Tensor, aw: torch.Tensor,
                           modes: Optional[Sequence[Mode]] = None) -> torch.Tensor:
    """Gather version of both modes, accumulated in f32.

    value (B, sum HW, heads, hd); locs (B, Q, heads, L, P, 2) in [0, 1];
    aw (B, Q, heads, L, P). Returns (B, Q, heads * hd) in value's dtype."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    b, _, heads, hd = value.shape
    q, p_pts = locs.shape[1], locs.shape[4]
    modes = _check_modes(shapes, modes or (None,) * len(shapes), q)
    origins = (window_origins(shapes, modes, value.device)
               if any(m is not None for m in modes) else None)
    out = torch.zeros(b, q, heads, hd, dtype=torch.float32, device=value.device)
    start = 0
    for li, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].permute(0, 2, 1, 3).reshape(b * heads, h * w, hd)
        v = v.float()
        start += h * w
        gx = locs[:, :, :, li, :, 0].float() * w - 0.5
        gy = locs[:, :, :, li, :, 1].float() * h - 0.5
        a = aw[:, :, :, li].float()
        if modes[li] is not None:
            edge = modes[li][0] + 2 * modes[li][1] - 2
            oy = origins[li, :, 0].view(1, q, 1, 1).float()
            ox = origins[li, :, 1].view(1, q, 1, 1).float()
            inmap = (gy > -1.0) & (gy < float(h)) & (gx > -1.0) & (gx < float(w))
            a = a * inmap
            y0, x0, fy, fx = window_corner(gy, gx, oy, oy + edge, ox, ox + edge)
        else:
            y0, x0, fy, fx = window_corner(gy, gx, -2.0, h + 1.0, -2.0, w + 1.0)
        for dy in (0, 1):
            for dx in (0, 1):
                yy, xx = y0 + dy, x0 + dx
                inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                wgt = (fy if dy else 1 - fy) * (fx if dx else 1 - fx) * inside * a
                flat = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)  # (B, Q, heads, P)
                flat = flat.permute(0, 2, 1, 3).reshape(b * heads, q * p_pts)
                g = torch.gather(v, 1, flat[..., None].expand(-1, -1, hd))
                g = g.reshape(b, heads, q, p_pts, hd).permute(0, 2, 1, 3, 4)
                out += (g * wgt[..., None]).sum(3)
    return out.reshape(b, q, heads * hd).to(value.dtype)


def ms_deform_sample(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                     locs: torch.Tensor, aw: torch.Tensor,
                     modes: Optional[Sequence[Mode]] = None) -> torch.Tensor:
    """Deformable sampling of every level and point in one call; see the
    module docstring for the modes. Same arguments as the plain version."""
    if not dispatch.kernel_device(value, locs, aw):
        return ms_deform_sample_plain(value, shapes, locs, aw, modes)
    dispatch.refuse_autograd("ms_deform_sample", value, locs, aw)
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    if value.dim() != 4 or locs.dim() != 6 or aw.dim() != 5:
        raise ValueError("value (B, S, heads, hd), locs (B, Q, heads, L, P, 2) and "
                         "aw (B, Q, heads, L, P) expected")
    b, s, heads, hd = value.shape
    _, q, _, n_levels, p_pts, two = locs.shape
    if (two != 2 or locs.shape[0] != b or locs.shape[2] != heads
            or n_levels != len(shapes) or tuple(aw.shape) != (b, q, heads, n_levels, p_pts)
            or s != sum(h * w for h, w in shapes)):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, locs "
                         f"{tuple(locs.shape)}, aw {tuple(aw.shape)}, levels {shapes}")
    if value.dtype not in _DTYPES or aw.dtype != value.dtype or locs.dtype != torch.float32:
        raise TypeError(f"value and aw must share float32 or bfloat16 and locs be float32, "
                        f"got {value.dtype}, {aw.dtype}, {locs.dtype}")
    if not (value.is_contiguous() and locs.is_contiguous() and aw.is_contiguous()):
        raise ValueError("ms_deform_sample takes contiguous tensors")
    if hd > 128 or n_levels > 8:
        raise ValueError(f"head dim {hd} > 128 or {n_levels} levels > 8")
    modes = _check_modes(shapes, modes or (None,) * n_levels, q)
    levels = level_table(shapes, modes)
    origins = (window_origins(shapes, modes, value.device)
               if any(m is not None for m in modes) else None)
    from beyondff_tpu_torch.kernels import _build

    out = torch.empty(b, q, heads * hd, dtype=value.dtype, device=value.device)
    rc = _build.library().bff_ms_deform_sample(
        _DTYPES[value.dtype], value.data_ptr(), locs.data_ptr(), aw.data_ptr(),
        None if origins is None else origins.data_ptr(), out.data_ptr(),
        b, s, q, heads, hd, n_levels, p_pts, levels,
        torch.cuda.current_stream(value.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_sample kernel launch failed (code {rc})")
    dispatch.launch_counts["ms_deform_sample"] += 1
    return out
