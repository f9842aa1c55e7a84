"""The staging plan of K1's TMA-staged variant and its index arithmetic in
plain PyTorch.

``variant_csrc/ms_deform_window_tma.cu`` samples the Grounding-DINO
encoder's windowed call (bf16, every level in clamp mode over the all-level
raster, head dim 32, 4 points) from each (batch, level-0 tile, head)'s
windows staged in shared memory by TMA, as the TPU kernel
(beyondff_tpu/kernels/deform_window.py ``sample_level_windowed``) keeps a
tile's window in VMEM. It lost to the gather kernel that the port ships
(``csrc/ms_deform_sample.cu``), so no path calls it: only
``tools/kernel_variants.py`` builds it (the ``k1_staged*`` variants) and
times it, with the device table of :func:`device_plan`. The CPU tests hold
the plan (:func:`staged_plan_host`) and the kernel's arithmetic
(:func:`staged_sample_mirror`) against the plain gather and the Pallas
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from beyondff_tpu_torch.kernels.deform_window import Mode, build_assignment, window_corner

STAGED_HEAD_DIM = 32      # the head dim the kernel takes
STAGED_SMEM = 227 * 1024  # bytes of shared memory a block may use
STAGED_WARPS = 16         # consumer warps, each with a 256-byte weight table


def _staged_smem(s_pad: int, box_cells: int) -> int:
    """Shared memory of the staged kernel (bf16): two box stages (the
    largest box, rounded up to 1 KB), the f32 accumulator rows, the weight
    tables, a zero row, barriers and alignment."""
    stage = -(-box_cells * STAGED_HEAD_DIM * 2 // 1024) * 1024
    return 2 * stage + s_pad * STAGED_HEAD_DIM * 4 + STAGED_WARPS * 256 + 64 + 32 + 1024


class StagedPlan:
    """Where the staged kernel's work items (batch, level-0 tile, head) read:
    the queries of each level-0 tile (``build_assignment``'s buckets), and
    per level the box of cells it stages, ``box`` (L, 2) (rows, cols) the
    same for every tile and ``box_org`` (tiles, L, 2) each tile's origin:
    the bounding box of its queries' windows, cut to what shared memory
    holds. ``outside`` counts the (query, level) windows that leave their
    tile's box (served from global memory by the kernel)."""

    def __init__(self, qidx, counts, box, box_org, outside, windows):
        self.qidx, self.counts, self.box, self.box_org = qidx, counts, box, box_org
        self.outside = outside
        self.windows = windows  # (L, Q, 2) window origins
        self.n_tiles, self.s_pad = qidx.shape

    def meta(self) -> ctypes.Array:
        """The host rows the kernel takes: (tiles, s_pad, then (rows, cols) of
        the box per level)."""
        rows = [self.n_tiles, self.s_pad] + [int(v) for v in self.box.reshape(-1)]
        return (ctypes.c_int * len(rows))(*rows)

    def table(self) -> np.ndarray:
        """The device table as int32: qidx (tiles, s_pad), box origins
        (tiles, L, 2), counts (tiles,)."""
        return np.concatenate([self.qidx.reshape(-1), self.box_org.reshape(-1),
                               self.counts]).astype(np.int32)


def staged_plan_host(shapes: Tuple[Tuple[int, int], ...],
                     modes: Tuple[Mode, ...]) -> StagedPlan:
    """The staging plan of an all-clamp call (built once per shapes and
    modes)."""
    return _staged_plan_cached(tuple((int(h), int(w)) for h, w in shapes),
                               tuple((int(m[0]), int(m[1])) for m in modes))


@functools.lru_cache(maxsize=32)
def _staged_plan_cached(shapes, modes):
    a0 = build_assignment(shapes, 0, modes[0][0])
    n_tiles, s_pad = a0.idx.shape
    counts = a0.valid.sum(1).astype(np.int64)
    windows = np.stack([build_assignment(shapes, li, t).tile_yx() * t - r
                        for li, (t, r) in enumerate(modes)])  # (L, Q, 2)
    w3 = np.array([t + 2 * r for t, r in modes])[:, None]
    box_org = np.zeros((n_tiles, len(shapes), 2), np.int64)
    extent = np.zeros((n_tiles, len(shapes), 2), np.int64)
    for t in range(n_tiles):
        o = windows[:, a0.idx[t, :counts[t]]]  # (L, n, 2)
        if o.shape[1]:
            box_org[t] = o.min(1)
            extent[t] = o.max(1) + w3 - box_org[t]
    box = np.maximum(extent.max(0), 1)
    # boxes 4 mod 8 cells wide (the kernel's ldmatrix then meets fewer bank
    # conflicts in the 64-byte swizzle), cut to what shared memory holds
    cap = 1
    while _staged_smem(s_pad, cap + 1) <= STAGED_SMEM:
        cap += 1
    for li in range(len(shapes)):
        by, bx = int(box[li, 0]), int(box[li, 1]) + (4 - int(box[li, 1])) % 8
        if by * bx > cap:
            by = min(by, int(np.sqrt(cap)))
            bx = max(4, min(bx, cap // by) - (min(bx, cap // by) - 4) % 8)
        box[li] = (min(by, 256), min(bx, 252))
    outside = 0
    for t in range(n_tiles):
        o = windows[:, a0.idx[t, :counts[t]]]
        lo, hi = box_org[t][:, None], (box_org[t] + box)[:, None]
        outside += int((~((o >= lo) & (o + w3[:, :, None] <= hi)).all(-1)).sum())
    return StagedPlan(a0.idx.astype(np.int64), counts, box, box_org, outside, windows)


def device_plan(shapes: Tuple[Tuple[int, int], ...], modes: Tuple[Mode, ...],
                device) -> Tuple[torch.Tensor, ctypes.Array]:
    """The plan's device table (int32, on ``device``) and host rows, as
    ``bff_ms_deform_staged`` takes them."""
    plan = staged_plan_host(shapes, modes)
    return torch.from_numpy(plan.table()).to(device), plan.meta()


def swizzle64(off: torch.Tensor) -> torch.Tensor:
    """The byte of a box written with TMA's 64-byte swizzle that holds dense
    byte ``off``: its 16-byte chunk index XOR bits 7-8 (the kernel's
    ``swz64``)."""
    return off ^ (((off >> 7) & 3) << 4)


def staged_sample_mirror(value: torch.Tensor, shapes: Sequence[Tuple[int, int]],
                         locs: torch.Tensor, aw: torch.Tensor,
                         modes: Sequence[Mode]) -> torch.Tensor:
    """The staged kernel's index arithmetic in plain PyTorch (f32): every
    work item's queries sample the boxes of :func:`staged_plan_host`, cut
    from the value map with zeros outside it as TMA fills them and laid out
    in 16-byte chunks under the 64-byte swizzle, read at the kernel's
    box-relative, swizzled offsets; windows outside their box read the map.
    Weights stay f32 (the kernel rounds them to bf16 for the tensor cores).
    Returns (B, Q, heads * hd) f32."""
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    plan = staged_plan_host(shapes, tuple(modes))
    b, _, heads, hd = value.shape
    q_all = locs.shape[1]
    chunks = hd // 8  # 16-byte chunks of a bf16 cell
    out = torch.zeros(b, q_all, heads, hd, dtype=torch.float32)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    maps = [value[:, starts[li]:starts[li + 1]].float().reshape(b, h, w, heads, hd)
            for li, (h, w) in enumerate(shapes)]
    for t in range(plan.n_tiles):
        qs = torch.from_numpy(plan.qidx[t, :plan.counts[t]])
        if not len(qs):
            continue
        acc = torch.zeros(b, len(qs), heads, hd)
        for li, (h, w) in enumerate(shapes):
            tile, radius = modes[li]
            w3 = tile + 2 * radius
            by, bx = (int(v) for v in plan.box[li])
            boy, box_ = (int(v) for v in plan.box_org[t, li])
            # the box as TMA stages it: zeros outside the map, chunks swizzled
            dense = torch.zeros(b, by, bx, heads, hd)
            ys, xs = slice(max(boy, 0), min(boy + by, h)), slice(max(box_, 0), min(box_ + bx, w))
            if ys.start < ys.stop and xs.start < xs.stop:
                dense[:, ys.start - boy:ys.stop - boy, xs.start - box_:xs.stop - box_] = \
                    maps[li][:, ys, xs]
            cells = torch.arange(by * bx)
            dense_off = cells[:, None] * (hd * 2) + 16 * torch.arange(chunks)[None, :]
            phys = torch.zeros(b, by * bx * chunks, heads, 8)
            phys[:, (swizzle64(dense_off) // 16).reshape(-1)] = (
                dense.reshape(b, by * bx, heads, chunks, 8).permute(0, 1, 3, 2, 4)
                .reshape(b, by * bx * chunks, heads, 8))
            flat_map = maps[li].reshape(b, h * w, heads, hd)
            org = torch.from_numpy(plan.windows[li][qs.numpy()]).long()  # (n, 2)
            oy, ox = org[:, 0].view(1, -1, 1, 1), org[:, 1].view(1, -1, 1, 1)
            inbox = ((oy >= boy) & (oy + w3 <= boy + by) & (ox >= box_)
                     & (ox + w3 <= box_ + bx))
            gx = locs[:, qs, :, li, :, 0].float() * w - 0.5
            gy = locs[:, qs, :, li, :, 1].float() * h - 0.5
            a = aw[:, qs, :, li].float()
            live = (gy > -1.0) & (gy < float(h)) & (gx > -1.0) & (gx < float(w))
            y0, x0, fy, fx = window_corner(gy, gx, oy.float(), oy.float() + (w3 - 2),
                                           ox.float(), ox.float() + (w3 - 2))
            cell0 = (y0 - boy) * bx + (x0 - box_)  # the kernel's corner (0, 0) cell
            for dy in (0, 1):
                for dx in (0, 1):
                    wgt = torch.where(live, (fy if dy else 1.0 - fy) * (fx if dx else 1.0 - fx)
                                      * a, 0.0)
                    cell = (cell0 + dy * bx + dx).clamp(0, by * bx - 1)
                    vb = torch.cat([_take(phys, swizzle64(cell * (hd * 2) + 16 * k) // 16)
                                    for k in range(chunks)], -1)
                    yy, xx = y0 + dy, x0 + dx
                    in_map = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                    vm = _take(flat_map, yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1))
                    v = torch.where(inbox.expand_as(cell)[..., None], vb, vm * in_map[..., None])
                    acc += (v * wgt[..., None]).sum(3)
        out[:, qs] = acc
    return out.reshape(b, q_all, heads * hd)


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (B, rows, heads, c) at idx (B, n, heads, P) -> (B, n, heads, P, c)."""
    b, n, heads, p = idx.shape
    c = flat.shape[-1]
    g = flat.permute(0, 2, 1, 3)  # (B, heads, rows, c)
    i = idx.permute(0, 2, 1, 3).reshape(b, heads, n * p, 1).expand(-1, -1, -1, c)
    return torch.gather(g, 2, i).reshape(b, heads, n, p, c).permute(0, 2, 1, 3, 4)
