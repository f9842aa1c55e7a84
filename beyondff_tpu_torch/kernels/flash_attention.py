"""Flash attention: the hand-written Hopper kernels and their plain versions.

Port of beyondff_tpu/kernels/flash_attention.py. One C entry
(``csrc/flash_attention.cu``) computes softmax(Q K^T * scale) V over
(BH, S, D) with keys >= ``valid_len`` masked, so the TPU's padded-and-masked
``_flash_masked`` and its unpadded ``flash_attention`` are the same call
here. It routes bf16 at head dim 64 with every key valid (K3, EfficientSAM's
global blocks; :func:`wgmma_route`) to the wgmma/TMA kernel of
``csrc/flash_attention_wgmma.cu``, counted as ``flash_attention_wgmma``;
bf16 at head dim 32 with at most ``MASKED_WGMMA_MAX_KEYS`` valid keys (K2,
the Grounding-DINO decoder's self-attention; :func:`masked_wgmma_route`) to
the wgmma/TMA kernel of ``csrc/flash_masked_wgmma.cu``, counted as
``flash_masked_wgmma``; bf16 at head dims 144 to 256 in steps of 16
(:func:`wide_wgmma_route`) to the wgmma/TMA kernel of
``csrc/flash_attention_wide_wgmma.cu``, counted as
``flash_attention_wide_wgmma``; f32 at head dims 144 to 256 in steps of 16
(:func:`wide_tf32_route`) to the 3xTF32 wgmma kernel of
``csrc/relpos_attention_wide_tf32.cu`` with a key mask for its score
modifier, the whole head dim a block, counted as
``flash_attention_wide_tf32``; f32 at head dim 32 or 64 (K2 and K3 in
``detector.dtype: float32``) or 80, 96, 112 or 128 (:func:`tf32_route`) to
the 3xTF32 wgmma/TMA kernel of ``csrc/flash_attention_tf32.cu``, counted as
``flash_attention_tf32``; every other f32 call to the f32-FMA kernel,
counted as ``flash_attention_f32``; and every other bf16 call to the
mma.sync tile, counted as ``flash_attention`` (:func:`flash_counter` names
the counter of a call). A second entry (``csrc/relpos_attention.cu``) adds SAM's
decomposed relative-position bias from its thin factors (``flash_attention_relpos``,
reached through ``attend_relpos``); it routes SAM ViT-H's bf16 head-dim-80
calls on its 64-wide grids (K4; :func:`relpos_wgmma_route`) to the
wgmma/TMA kernel of ``csrc/relpos_attention_wgmma.cu``, counted as
``flash_attention_relpos_wgmma``; its f32 head-dim-80 calls on those grids
(K4 in ``detector.dtype: float32`` under ``BFF_SAM_RELPOS_FLASH=1``), its
f32 calls at the other multiples of 16 from 32 to 128 on them (SAM
ViT-L's and ViT-B's global blocks at 64) and its f32 calls at those head
dims on grids narrower than 64 whose width is a multiple of 8 (portrait
frames under ``BFF_SAM_RECT=1``;
:func:`relpos_tf32_route`) to the 3xTF32 wgmma kernel of
``csrc/relpos_attention_tf32.cu``, counted as
``flash_attention_relpos_tf32``; its bf16 calls at head dims 144 to 256 in
steps of 16 on any grid (:func:`relpos_wide_wgmma_route`) to the wgmma/TMA
kernel of ``csrc/relpos_attention_wide_wgmma.cu``, the whole head dim a
block with each key tile's factors streamed into shared memory, counted as
``flash_attention_relpos_wide_wgmma``, and its f32 calls there on any grid
(:func:`relpos_wide_tf32_route`) to the 3xTF32 wgmma kernel of
``csrc/relpos_attention_wide_tf32.cu``, counted as
``flash_attention_relpos_wide_tf32``; and the rest to the mma.sync tile or
the f32-FMA kernel, counted as ``flash_attention_relpos``
(:func:`relpos_counter` names the counter of a call). The wrappers launch
them for CUDA tensors and raise on what they do not take; CPU tensors take
the plain versions.

Every shape the JAX functions take runs on a kernel: head dims past 128
outside the wide routes on the FMA kernel or the mma.sync tile with a grid
axis over the head dim's 128-feature output slices (:func:`head_dim_slices`;
each block sums its scores over every slice and accumulates P V for its
own; :func:`sliced_mirror`), rel-pos grids with kh + kw past 256 on the FMA
kernel reading the factors from device memory (:func:`relpos_factor_table`;
bf16 at head dims up to 128 on the mma.sync tile with each key tile's
factors streamed into shared memory, :func:`relpos_streamed_route`, counted
as ``flash_attention_relpos_streamed``), and K5's windows past 256 tokens
or head dim 128 on K4's kernels (:func:`window_on_flash`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from beyondff_tpu_torch.kernels import dispatch

# below this many tokens ``attend`` takes plain dense attention (the JAX
# package's BLOCK_Q cutoff, where its dense XLA path was the fast one)
BLOCK_Q = 256
# the JAX package's kv block, kept for ``relpos_shapes_ok``'s routing decision
BLOCK_KV = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FLT_MAX = 3.4028234663852886e38
# csrc/flash_masked_wgmma.cu: 64-key tiles, at most 24 of them held in
# shared memory
MASKED_WGMMA_TILE = 64
MASKED_WGMMA_MAX_KEYS = 24 * MASKED_WGMMA_TILE


# csrc/flash_attention.cu and csrc/relpos_attention.cu: head dims past 128
# take a grid axis over slices of this many output features
HEAD_DIM_SLICE = 128
# csrc/relpos_attention.cu: the widest factor table (kh + kw columns) a K4
# block holds in shared memory (kMaxTableCols), and the largest window K5's
# own kernels take, in tokens and head dim (kMaxWindow, kSliceD)
RELPOS_TABLE_COLS = 256
WINDOW_MAX_TOKENS = 256


def head_dim_slices(d: int) -> int:
    """The grid's slices of ``HEAD_DIM_SLICE`` output features a call at head
    dim ``d`` takes on the FMA kernels and the mma.sync tile (their grid z):
    1 up to 128, ceil(d / 128) past it, where each block recomputes the
    scores over the whole head dim."""
    return max(1, -(-d // HEAD_DIM_SLICE))


def relpos_factor_table(kh: int, kw: int) -> bool:
    """The mirror of ``csrc/relpos_attention.cu``'s table rule: whether a K4
    block of the FMA kernel or the mma.sync tile holds its rows' factors in a
    shared-memory table (kh + kw <= ``RELPOS_TABLE_COLS``). Past it the FMA
    kernel reads each score's two factors from device memory, and bf16 calls
    leave the tile for the FMA kernel."""
    return kh + kw <= RELPOS_TABLE_COLS


# csrc/relpos_attention.cu's streamed route: the tile's 128 query rows a
# block, its 64-key tiles, and the widest grid whose bias_w columns sit
# whole in a fixed table (``attention_tc.cuh``'s kStreamFixedW)
STREAM_ROWS = 128
STREAM_TILE = 64
STREAM_FIXED_W = 160


def relpos_streamed_route(kind: int, dtype: int, d: int, s: int, rows: int, cols: int,
                          scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_relpos_streamed_takes``: whether K4's kernels (kind
    0, a ``rows`` x ``cols`` = kh x kw grid) or K5's windows that run on them
    (kind 1, windows past ``WINDOW_MAX_TOKENS`` tokens) take the mma.sync
    tile with each key tile's factors staged beside its K and V (counted as
    ``flash_attention_relpos_streamed``): bf16, head dim <= 128 with d % 8 ==
    0, kh + kw past ``RELPOS_TABLE_COLS``, a positive finite scale (rounded
    to f32 as the call passes it), q, k, v and the output on 16 bytes and
    both factors (``ptrs``' last two) on 4."""
    f32 = ctypes.c_float(scale).value
    shape = (rows >= 1 and cols >= 1 and rows * cols == s and not relpos_factor_table(rows, cols)
             and (kind == 0 or (kind == 1 and s > WINDOW_MAX_TOKENS)))
    return (shape and dtype == 1 and 1 <= d <= HEAD_DIM_SLICE and d % 8 == 0
            and 0.0 < f32 <= _FLT_MAX and all(p % 16 == 0 for p in ptrs[:4])
            and all(p % 4 == 0 for p in ptrs[4:]))


def relpos_stream_layout(kw: int, fixed_w: int = STREAM_FIXED_W, slots: int = 2) -> dict:
    """The mirror of ``attention_tc.cuh``'s streamed table for a grid ``kw``
    wide, in 4-byte words a row: ``h_words`` of bias_h and ``w_words`` of
    bias_w (past ``fixed_w`` columns: pieces A and B) in each of the
    ``slots`` ring slots (``slot_words``), then ``fixed_words`` of every
    bias_w column (up to ``fixed_w``), rows ``ld`` bf16 elements apart (the
    least multiple of 16 that holds a row, plus 8). The tile's streamed route
    has ``STREAM_FIXED_W`` and two slots, the wide wgmma kernel
    ``RELPOS_WIDE_FIXED_W`` and ``RELPOS_WIDE_SLOTS``."""
    h = (62 // kw + 4) // 2
    w = 34 if kw > fixed_w else 0
    fixed = 0 if kw > fixed_w else (kw + 2) // 2
    return {"h_words": h, "w_words": w, "slot_words": h + w, "fixed_words": fixed,
            "ld": (2 * (slots * (h + w) + fixed) + 15) // 16 * 16 + 8}


def _stream_piece(table, col, flat, e, cnt, live):
    """The words that hold ``cnt`` elements from flat index ``e`` (arrays over
    the block's rows) of ``flat`` into ``table`` from element column ``col``
    on, as the kernel's 4-byte copies move them: a word's second element
    past the array's end, and every word of a row off the grid, zero."""
    nw = np.where(cnt > 0, ((e & 1) + cnt + 1) // 2, 0)
    total = flat.shape[0]
    rows = np.arange(table.shape[0])
    for u in range(int(nw.max(initial=0))):
        gw = (e >> 1) + u
        put = u < nw
        first = np.where(live, flat[np.clip(2 * gw, 0, total - 1)], 0)
        second = np.where(live & (2 * gw + 1 < total), flat[np.clip(2 * gw + 1, 0, total - 1)], 0)
        c = col + 2 * u
        table[rows[put], c[put]] = first[put]
        table[rows[put], c[put] + 1] = second[put]


def relpos_stream_stage(table, bias_h_flat, bias_w_flat, kh: int, kw: int, s: int, row0: int,
                        q0: int, k0: int, fixed_w: int = STREAM_FIXED_W, slots: int = 2) -> None:
    """The mirror of ``StreamedBias::stage`` (and of the wide wgmma kernel's
    ``WarpFactors::stage``, whose warps' 16-row parts stack into the same
    table): the factor columns of the key tile at ``k0`` into ring slot (k0
    / 64) % ``slots`` of ``table`` (numpy, 128 rows x ``ld``) for the block
    whose first flat factor row is ``row0`` (head * S + ``q0``): bias_h's
    piece, and past ``fixed_w`` columns bias_w's pieces A and B from the
    word after A's; rows at or past S zero-filled."""
    lay = relpos_stream_layout(kw, fixed_w, slots)
    hw, sw = lay["h_words"], lay["slot_words"]
    y0, x0 = divmod(k0, kw)
    n = min(STREAM_TILE, s - k0)
    nh = (k0 + n - 1) // kw - y0 + 1
    na = min(n, kw - x0)
    big_r = row0 + np.arange(STREAM_ROWS)
    live = q0 + np.arange(STREAM_ROWS) < s
    base = ((k0 // STREAM_TILE) % slots) * 2 * sw
    col = np.full(STREAM_ROWS, base)
    _stream_piece(table, col, bias_h_flat, big_r * kh + y0, np.full(STREAM_ROWS, nh), live)
    if kw > fixed_w:
        ea = big_r * kw + x0
        wa = ((ea & 1) + na + 1) // 2
        _stream_piece(table, col + 2 * hw, bias_w_flat, ea, np.full(STREAM_ROWS, na), live)
        _stream_piece(table, col + 2 * (hw + wa), bias_w_flat, big_r * kw,
                      np.full(STREAM_ROWS, n - na), live)


def relpos_stream_fixed(table, bias_w_flat, kw: int, s: int, row0: int, q0: int,
                        fixed_w: int = STREAM_FIXED_W, slots: int = 2) -> None:
    """The mirror of ``StreamedBias::stage_fixed`` (``WarpFactors::
    stage_fixed``): up to ``fixed_w`` columns every bias_w column of the
    block's rows sits in the fixed table after the ``slots`` slots."""
    if kw > fixed_w:
        return
    lay = relpos_stream_layout(kw, fixed_w, slots)
    big_r = row0 + np.arange(STREAM_ROWS)
    _stream_piece(table, np.full(STREAM_ROWS, 2 * slots * lay["slot_words"]), bias_w_flat,
                  big_r * kw, np.full(STREAM_ROWS, kw), q0 + np.arange(STREAM_ROWS) < s)


def relpos_stream_offsets(kh: int, kw: int, s: int, k0: int, rho: int,
                          fixed_w: int = STREAM_FIXED_W, slots: int = 2):
    """The mirror of ``StreamedBias::tile`` (``WarpFactors::apply``): for the
    64 columns of the key tile at ``k0`` and a lane whose rows' flat factor
    rows have parity ``rho``, (hoff, woff, live): the table elements of each
    key's bias_h and bias_w entry in those rows, and whether the key lies
    before S."""
    lay = relpos_stream_layout(kw, fixed_w, slots)
    hw, sw = lay["h_words"], lay["slot_words"]
    y0, x0 = divmod(k0, kw)
    n = min(STREAM_TILE, s - k0)
    s0 = ((k0 // STREAM_TILE) % slots) * 2 * sw
    hbase = s0 + ((rho * kh + y0) & 1) - y0
    if kw > fixed_w:
        pa = (rho * kw + x0) & 1
        na = min(n, kw - x0)
        xa, abase = x0, s0 + 2 * hw + pa - x0
        bbase = s0 + 2 * hw + 2 * ((pa + na + 1) // 2) + ((rho * kw) & 1)
    else:
        xa, abase, bbase = 0, 2 * slots * sw + ((rho * kw) & 1), 0
    key = k0 + np.arange(STREAM_TILE)
    ky, kx = key // kw, key % kw
    return hbase + ky, np.where(kx >= xa, abase + kx, bbase + kx), key < s


def relpos_streamed_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of the streamed route in PyTorch on the CPU, block by
    block of 128 query rows: per 64-key tile, the factors staged into the
    ring slot (:func:`relpos_stream_stage`, the fixed table for kw < 64)
    and each score's bias read back through :func:`relpos_stream_offsets`
    (the parity of each row's flat factor row), the scores in f32 plus the
    bias (bf16 factors added in f32), keys past S at -inf, the online
    softmax, P rounded to the inputs' dtype before P V, the denominator from
    the f32 probabilities, the output divided once."""
    g, s, d = q.shape
    kh = bias_h.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    qf, kf, vf = q.float(), k.float(), v.float()
    fh = bias_h.to(q.dtype).float().reshape(-1).numpy()
    fw = bias_w.to(q.dtype).float().reshape(-1).numpy()
    lay = relpos_stream_layout(kw)
    out = torch.zeros(g, s, d)
    for h in range(g):
        for q0 in range(0, s, STREAM_ROWS):
            row0 = h * s + q0
            rows = torch.arange(q0, min(q0 + STREAM_ROWS, s))
            nr = len(rows)
            table = np.zeros((STREAM_ROWS, lay["ld"]), np.float32)
            relpos_stream_fixed(table, fw, kw, s, row0, q0)
            parity = (row0 + np.arange(nr)) & 1
            m = torch.full((nr,), -1e30)
            l = torch.zeros(nr)
            acc = torch.zeros(nr, d)
            for k0 in range(0, s, STREAM_TILE):
                relpos_stream_stage(table, fh, fw, kh, kw, s, row0, q0, k0)
                keys = torch.arange(k0, min(k0 + STREAM_TILE, s))
                bias = np.zeros((nr, STREAM_TILE), np.float32)
                for rho in (0, 1):
                    hoff, woff, _live = relpos_stream_offsets(kh, kw, s, k0, rho)
                    sel = np.nonzero(parity == rho)[0]
                    bias[sel] = (table[sel][:, hoff] + table[sel][:, woff])
                sc = qf[h, rows] @ kf[h, keys].T * scale + torch.from_numpy(
                    bias[:, :len(keys)])
                m_new = torch.maximum(m, sc.max(dim=1).values)
                corr = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[:, None])
                l = l * corr + p.sum(dim=1)
                acc = acc * corr[:, None] + p.to(q.dtype).float() @ vf[h, keys]
                m = m_new
            out[h, rows] = acc / l[:, None]
    return out.to(q.dtype)


def window_on_flash(s: int, d: int) -> bool:
    """The mirror of ``bff_window_attention_relpos``'s first rule: windows of
    more than ``WINDOW_MAX_TOKENS`` tokens or head dims past 128 run K4's
    kernels (the FMA kernel or the mma.sync tile, G windows as BH), counted
    as ``flash_attention_relpos``."""
    return s > WINDOW_MAX_TOKENS or d > HEAD_DIM_SLICE


def sliced_schedule(bh: int, s: int, d: int, rows: int = 64):
    """The mirror of the sliced grids of ``csrc/flash_attention.cu`` and
    ``csrc/relpos_attention.cu``: (grid, blocks), the grid (ceil(S / rows),
    BH, :func:`head_dim_slices`) with ``rows`` query rows a block (64 on the
    FMA kernels and K2/K3's tile, 128 on K4's), and for each block (x, head,
    z) its query rows and output features [128 z, min(128 z + 128, d))."""
    n = head_dim_slices(d)
    grid = (-(-s // rows), bh, n)
    blocks = {(x, h, z): (range(rows * x, min(rows * x + rows, s)),
                          range(HEAD_DIM_SLICE * z, min(HEAD_DIM_SLICE * z + HEAD_DIM_SLICE, d)))
              for h in range(bh) for x in range(grid[0]) for z in range(n)}
    return grid, blocks


def sliced_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  valid_len: Optional[int] = None, scale: Optional[float] = None,
                  bias_h: Optional[torch.Tensor] = None, bias_w: Optional[torch.Tensor] = None,
                  rows: int = 64) -> torch.Tensor:
    """The arithmetic of the FMA kernels' head-dim slices in PyTorch on the
    CPU, block by block of :func:`sliced_schedule`, in f32: per 64-key tile
    (keys >= ``valid_len`` at -inf; the tiles up to ``valid_len``), the
    scores summed over the head dim's 128-feature slices of Q and K in turn
    (slice after slice), scaled, plus the rel-pos bias
    bias_h[q, k / kw] + bias_w[q, k % kw] where factors are given; the
    online softmax (the running max raised at every tile, the output
    rescaled); P V over the block's own 128 features of V; the output
    divided once. Every (head, row, feature) is written by one block. The
    kernels' f32 sums run in another order; this holds their schedule, not
    their rounding."""
    bh, s, d = q.shape
    valid = s if valid_len is None else int(valid_len)
    scale = d ** -0.5 if scale is None else scale
    qf, kf, vf = q.float(), k.float(), v.float()
    bias = None if bias_h is None else relpos_bias(bias_h, bias_w, q.dtype)
    out = torch.zeros(bh, s, d, dtype=torch.float32)
    written = torch.zeros(bh, s, d, dtype=torch.int32)
    _grid, blocks = sliced_schedule(bh, s, d, rows)
    tile = 64
    for (_x, h, _z), (rr, cc) in blocks.items():
        r = torch.tensor(list(rr))
        c = torch.tensor(list(cc))
        m = torch.full((len(r),), -1e30)
        l = torch.zeros(len(r))
        acc = torch.zeros(len(r), len(c))
        for k0 in range(0, valid, tile):
            keys = torch.arange(k0, min(k0 + tile, s))
            sc = torch.zeros(len(r), len(keys))
            for f0 in range(0, d, HEAD_DIM_SLICE):
                fs = slice(f0, f0 + HEAD_DIM_SLICE)
                sc = sc + qf[h, r, fs] @ kf[h, keys, fs].T
            sc = sc * scale
            if bias is not None:
                sc = sc + bias[h][r][:, keys]
            sc = torch.where(keys[None, :] < valid, sc, torch.tensor(float("-inf")))
            m_new = torch.maximum(m, sc.max(dim=1).values)
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[:, None])
            l = l * corr + p.sum(dim=1)
            acc = acc * corr[:, None] + p @ vf[h, keys][:, c]
            m = m_new
        out[h, r[:, None], c[None, :]] = acc / l[:, None]
        written[h, r[:, None], c[None, :]] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the schedule does not write every (head, row, feature) once")
    return out.to(q.dtype)


def wgmma_route(dtype: int, d: int, s: int, valid_len: int, scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_flash_wgmma_takes``: whether ``bff_flash_attention``
    runs the wgmma/TMA kernel for a call (dtype 0 = float32, 1 = bfloat16;
    ``ptrs`` the data pointers of q, k, v and the output): bf16, head dim
    64, every key valid, a positive finite scale (rounded to f32 as the call
    passes it) and 16-byte aligned pointers."""
    f32 = ctypes.c_float(scale).value
    return (dtype == 1 and d == 64 and s >= 1 and valid_len == s and 0.0 < f32 <= _FLT_MAX
            and all(p % 16 == 0 for p in ptrs))


def masked_wgmma_route(dtype: int, d: int, s: int, valid_len: int, scale: float,
                       *ptrs: int) -> bool:
    """The mirror of ``bff_flash_masked_wgmma_takes``: whether
    ``bff_flash_attention`` runs the wgmma/TMA kernel of
    ``csrc/flash_masked_wgmma.cu`` for a call that :func:`wgmma_route`
    leaves (dtype 0 = float32, 1 = bfloat16; ``ptrs`` the data pointers of
    q, k, v and the output): bf16, head dim 32, 1 <= ``valid_len`` <= S and
    at most ``MASKED_WGMMA_MAX_KEYS`` (the valid keys sit whole in shared
    memory), a positive finite scale (rounded to f32 as the call passes it)
    and 16-byte aligned pointers."""
    f32 = ctypes.c_float(scale).value
    return (dtype == 1 and d == 32 and s >= 1 and 1 <= valid_len <= s
            and valid_len <= MASKED_WGMMA_MAX_KEYS and 0.0 < f32 <= _FLT_MAX
            and all(p % 16 == 0 for p in ptrs))


# csrc/flash_attention_tf32.cu: the pre-pass's 64-key padding, blocks of two
# 64-row warpgroups, the head dims it takes and the shortest sequence
# (shorter ones keep the FMA kernel, faster there)
TF32_TILE = 64
TF32_BLOCK_Q = 128
TF32_HEAD_DIMS = (32, 64, 80, 96, 112, 128)
TF32_MIN_S = 256
# the order of the keys of each 8-key group in the kernel's V^T (a lane's
# accumulator columns 2 t, 2 t + 1 are the A fragment's columns t, t + 4)
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_route(dtype: int, d: int, s: int, valid_len: int, scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_flash_tf32_takes``: whether ``bff_flash_attention``
    runs the 3xTF32 wgmma/TMA kernel of ``csrc/flash_attention_tf32.cu``
    for a call (dtype 0 = float32, 1 = bfloat16; ``ptrs`` the data pointers
    of q, k, v and the output): f32, head dim 32, 64, 80, 96, 112 or 128, S >=
    ``TF32_MIN_S``, 1 <= ``valid_len`` <= S, a positive finite scale
    (rounded to f32 as the call passes it) and 16-byte aligned pointers."""
    f32 = ctypes.c_float(scale).value
    return (dtype == 0 and d in TF32_HEAD_DIMS and s >= TF32_MIN_S and 1 <= valid_len <= s
            and 0.0 < f32 <= _FLT_MAX and all(p % 16 == 0 for p in ptrs))


def tf32_key_tile(d: int) -> int:
    """The keys of a tile of ``csrc/flash_attention_tf32.cu``'s online
    softmax at head dim ``d`` (``Cfg<D>::kBN``): 64, or 32 at head dim 128,
    where a 64-key stage beside both consumers' Q halves would not fit (at
    96 one 64-key stage of each fits, at 80 two K stages and one V stage),
    and at 112, where one 64-key stage of each fits but spilled 80 bytes
    (a 384-thread block is held to 168 registers)."""
    return 32 if d in (112, 128) else 64


def tf32_scratch_floats(bh: int, d: int, valid_len: int) -> int:
    """The mirror of ``bff_flash_tf32_scratch_floats``: the floats of scratch a
    3xTF32 call needs, K's hi and lo and V^T's hi and lo, each (BH, Kp, D)
    with Kp = ``valid_len`` rounded up to 64 keys."""
    return 4 * bh * (-(-valid_len // TF32_TILE) * TF32_TILE) * d


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values: the 10-bit mantissa rounded to
    nearest, ties away from zero (half an ulp added to the magnitude, the
    low 13 bits cleared), as an f32 tensor."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)
    return bits.view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo) = (rna(x), rna(x - hi)) in TF32, as the kernel splits each f32
    operand (x - hi is exact in f32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32_schedule(bh: int, s: int):
    """The mirror of ``csrc/flash_attention_tf32.cu``'s grid: (grid, tiles),
    the grid (ceil(S / 128), BH) and for each block (x, head) the first query
    rows of its two consumer warpgroups, 64 rows each (rows >= S are
    computed on zero Q and not written)."""
    grid = (-(-s // TF32_BLOCK_Q), bh)
    tiles = {(x, h): [TF32_BLOCK_Q * x, TF32_BLOCK_Q * x + 64]
             for h in range(bh) for x in range(grid[0])}
    return grid, tiles


def flash_tf32_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of ``csrc/flash_attention_tf32.cu`` in PyTorch on the
    CPU, block by block of :func:`tf32_schedule`. The pre-pass: keys >=
    ``valid_len`` zeroed up to a multiple of 64, K split into TF32 hi and
    lo (:func:`tf32_split`), V split and stored as V^T with each 8-key group
    in ``TF32_KEY_ORDER``. Per 64-row warpgroup tile, Q split; per 64-key
    tile, S = (lo(Q) hi(K)^T + hi(Q) lo(K)^T) + hi(Q) hi(K)^T in f32, keys
    >= ``valid_len`` at -inf, the running max in log2 units raised at every
    tile, p = 2^(s * scale * log2 e - m) with one rounding (exact, standing
    in for ex2.approx), the denominator summed from the f32 p, the output
    rescaled, P split in the fragment order and O += (lo(P) hi(V) + hi(P)
    lo(V)) + hi(P) hi(V); the output divided once; rows >= S not written
    (left 0). The softmax's key tiles are :func:`tf32_key_tile` keys (32
    at head dims 112 and 128). Every word handed to the products is
    rna-rounded TF32, so the hardware's truncation of the low 13 bits is the
    identity and is not modelled."""
    bh, s, d = q.shape
    valid = s if valid_len is None else int(valid_len)
    scale = d ** -0.5 if scale is None else scale
    sl2 = float(torch.tensor(scale * 1.4426950408889634, dtype=torch.float32))
    kp = -(-valid // TF32_TILE) * TF32_TILE
    tile = tf32_key_tile(d)
    kz = torch.zeros(bh, kp, d)
    vz = torch.zeros(bh, kp, d)
    kz[:, :valid] = k[:, :valid].float()
    vz[:, :valid] = v[:, :valid].float()
    k_hi, k_lo = tf32_split(kz)
    order = torch.tensor([8 * (j // 8) + TF32_KEY_ORDER[j % 8] for j in range(kp)])
    vt_hi, vt_lo = (t[:, order].transpose(1, 2) for t in tf32_split(vz))  # (BH, D, Kp)
    out = torch.zeros(bh, s, d, dtype=torch.float32)
    written = torch.zeros(bh, s, dtype=torch.int32)
    _grid, tiles = tf32_schedule(bh, s)
    col = torch.arange(tile)
    for (_x, h), row0s in tiles.items():
        for r0 in row0s:
            rows = torch.arange(r0, r0 + 64)
            live = rows < s
            qt = torch.zeros(64, d)
            qt[live] = q[h, rows[live]].float()
            q_hi, q_lo = tf32_split(qt)
            m = torch.full((64,), -1e30)
            l = torch.zeros(64)
            acc = torch.zeros(64, d)
            for t in range(kp // tile):
                ks = slice(t * tile, (t + 1) * tile)
                sc = (q_lo @ k_hi[h, ks].T + q_hi @ k_lo[h, ks].T) + q_hi @ k_hi[h, ks].T
                keys = t * tile + col
                sc = torch.where(keys[None, :] < valid, sc, torch.tensor(float("-inf")))
                mx = sc.max(dim=1).values * sl2
                m_new = torch.maximum(m, mx)
                corr = torch.exp2(m - m_new)
                m = m_new
                l = l * corr
                p = torch.exp2((sc.double() * sl2 - m[:, None].double()).float())
                l = l + p.sum(dim=1)
                acc = acc * corr[:, None]
                p_hi, p_lo = tf32_split(p[:, order[:tile]])  # the A fragments' column order
                acc = acc + ((p_lo @ vt_hi[h, :, ks].T + p_hi @ vt_lo[h, :, ks].T)
                             + p_hi @ vt_hi[h, :, ks].T)
            o = acc / l[:, None]
            out[h, rows[live]] = o[live]
            written[h, rows[live]] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the schedule does not write every (head, row) once")
    return out


def masked_wgmma_schedule(bh: int, s: int, sms: int = 132):
    """The mirror of ``csrc/flash_masked_wgmma.cu``'s ``choose_consumers`` and
    grid: (C, grid, tiles), C consumer warpgroups a block, the grid (ceil(S /
    64 C), BH), and for each block (x, head) the query rows [r0, r0 + 64) of
    each of its warpgroups (rows >= S are computed on zero-filled Q and not
    written). C in (4, 2, 1) costs the least: ceil(blocks / ``sms``) waves
    times C + 2; ties go to the larger C."""
    best, best_cost = 4, None
    for c in (4, 2, 1):
        blocks = bh * -(-s // (64 * c))
        cost = -(-blocks // sms) * (c + 2)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    grid = (-(-s // (64 * best)), bh)
    tiles = {(x, h): [64 * best * x + 64 * w for w in range(best)]
             for h in range(bh) for x in range(grid[0])}
    return best, grid, tiles


def masked_wgmma_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        valid_len: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of ``csrc/flash_masked_wgmma.cu`` in PyTorch on the
    CPU, block by block of :func:`masked_wgmma_schedule`: per 64-row tile,
    64-key tiles up to ``valid_len`` (keys >= ``valid_len`` of the last one
    at -inf, its column tiles wholly past it at p = 0); scores in f32 from
    the inputs' values, the running max in log2 units raised for a warp's 16
    rows only where one of them outgrows it by 2^8, p = 2^(s * scale * log2 e
    - m) (exact, standing in for ex2.approx), the output rescaled only
    when a max was raised, the denominator summed from the
    f32 p, P rounded to the inputs' dtype before P V, the output divided once
    in f32 and rounded to the inputs' dtype; rows >= S not written (left 0)."""
    bh, s, _d = q.shape
    return _wgmma_rows_mirror(q, k, v, valid_len, scale, masked_wgmma_schedule(bh, s)[2])


def _wgmma_rows_mirror(q, k, v, valid_len, scale, tiles, bias=None):
    """The arithmetic the wgmma kernels of K2 and of head dims past 128
    share, over the 64-row tiles of ``tiles`` ({block: first rows}); see
    :func:`masked_wgmma_mirror`. With ``bias`` (a (BH, rows, keys) f32
    tensor, rows and keys padded past S with zeros) each logit is first s *
    scale + bias in natural units, and log2(e) is the softmax's scale."""
    bh, s, d = q.shape
    valid = s if valid_len is None else int(valid_len)
    scale = d ** -0.5 if scale is None else scale
    sl2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    if bias is not None:
        sl2 = torch.tensor(1.4426950408889634, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(bh, s, d, dtype=torch.float32)
    written = torch.zeros(bh, s, dtype=torch.int32)
    tile = MASKED_WGMMA_TILE
    n_tiles = -(-valid // tile)
    col = torch.arange(tile)
    for (_x, h), row0s in tiles.items():
        for r0 in row0s:
            rows = torch.arange(r0, r0 + 64)
            live = rows < s
            qt = torch.zeros(64, d)
            qt[live] = qf[h, rows[live]]
            m = torch.full((64,), -1e30)
            l = torch.zeros(64)
            acc = torch.zeros(64, d)
            for t in range(n_tiles):
                keys = t * tile + col
                kt = torch.zeros(tile, d)
                vt = torch.zeros(tile, d)
                inside = keys < s
                kt[inside] = kf[h, keys[inside]]
                vt[inside] = vf[h, keys[inside]]
                sc = qt @ kt.T
                if bias is not None:
                    sc = sc * scale + bias[h, r0:r0 + 64, t * tile:(t + 1) * tile]
                sc = torch.where(keys[None, :] < valid, sc, torch.tensor(float("-inf")))
                mx = sc.max(dim=1).values * sl2
                # a warp's 16 rows raise their max together, when any needs it
                grow = (mx > m + 8.0).view(4, 16).any(dim=1).repeat_interleave(16)
                m_new = torch.where(grow, torch.maximum(m, mx), m)
                corr = torch.where(grow, torch.exp2(m - m_new), torch.ones(64))
                m = m_new
                l = l * corr
                p = torch.exp2(sc * sl2 - m[:, None])
                dead = (keys - keys % 8) >= valid  # column tiles wholly past valid_len
                p = torch.where(dead[None, :], torch.zeros_like(p), p)
                l = l + p.sum(dim=1)
                acc = acc * corr[:, None] + p.to(q.dtype).float() @ vt
            o = (acc / l[:, None]).to(q.dtype).float()
            out[h, rows[live]] = o[live]
            written[h, rows[live]] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the schedule does not write every (head, row) once")
    return out.to(q.dtype)


# csrc/flash_attention_wide_wgmma.cu: the head dims it takes and its blocks
# of two 64-row consumer warpgroups
WIDE_WGMMA_HEAD_DIMS = tuple(range(144, 257, 16))
WIDE_WGMMA_BLOCK_Q = 128


def wide_wgmma_route(dtype: int, d: int, s: int, valid_len: int, scale: float,
                     *ptrs: int) -> bool:
    """The mirror of ``bff_flash_wide_wgmma_takes``: whether
    ``bff_flash_attention`` runs the wgmma/TMA kernel of
    ``csrc/flash_attention_wide_wgmma.cu`` for a call (dtype 0 = float32, 1
    = bfloat16; ``ptrs`` the data pointers of q, k, v and the output):
    bf16, head dim a multiple of 16 from 144 to 256, 1 <= ``valid_len`` <=
    S, a positive finite scale (rounded to f32 as the call passes it) and
    16-byte aligned pointers."""
    f32 = ctypes.c_float(scale).value
    return (dtype == 1 and d in WIDE_WGMMA_HEAD_DIMS and s >= 1 and 1 <= valid_len <= s
            and 0.0 < f32 <= _FLT_MAX and all(p % 16 == 0 for p in ptrs))


def wide_wgmma_boxes(d: int):
    """The mirror of the wide kernel's ``Boxes<DP>``: the TMA boxes a row of
    head dim ``d`` is cut into, as (first column, columns, swizzle bytes,
    byte offset in a 64-row tile), over DP = ``d`` rounded up to 32 (the
    TMA zero-fills the columns from ``d`` on): 64-column boxes in the
    128-byte swizzle, then a 32-column box in the 64-byte swizzle where DP
    % 64 holds one."""
    dp = -(-d // 32) * 32
    boxes = [(64 * b, 64, 128, 64 * b * 128) for b in range(dp // 64)]
    if dp % 64:
        boxes.append((dp - 32, 32, 64, (dp // 64) * 64 * 128))
    return boxes


def wide_wgmma_schedule(bh: int, s: int):
    """The mirror of the wide kernel's grid: (grid, tiles), the grid
    (ceil(S / 128), BH) and for each block (x, head) the first query rows of
    its two consumer warpgroups."""
    grid = (-(-s // WIDE_WGMMA_BLOCK_Q), bh)
    tiles = {(x, h): [WIDE_WGMMA_BLOCK_Q * x, WIDE_WGMMA_BLOCK_Q * x + 64]
             for h in range(bh) for x in range(grid[0])}
    return grid, tiles


def wide_wgmma_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len: Optional[int] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of ``csrc/flash_attention_wide_wgmma.cu`` in PyTorch on
    the CPU, block by block of :func:`wide_wgmma_schedule`: the whole head
    dim at once, then :func:`masked_wgmma_mirror`'s tile walk (64-key tiles
    up to ``valid_len``, the last one masked, the lazy running max, P
    rounded before P V, the output divided once)."""
    bh, s, _d = q.shape
    return _wgmma_rows_mirror(q, k, v, valid_len, scale, wide_wgmma_schedule(bh, s)[1])


def wide_tf32_route(dtype: int, d: int, s: int, valid_len: int, scale: float,
                    *ptrs: int) -> bool:
    """The mirror of ``bff_flash_wide_tf32_takes``: whether
    ``bff_flash_attention`` runs the 3xTF32 wgmma kernel of
    ``csrc/relpos_attention_wide_tf32.cu`` with its key mask for a call that
    :func:`wide_wgmma_route` leaves (dtype 0 = float32, 1 = bfloat16;
    ``ptrs`` the data pointers of q, k, v and the output): f32, head dim a
    multiple of 16 from 144 to 256, any S (the kernel beat the FMA kernel's
    slices from S = 64 on), 1 <= ``valid_len`` <= S, a positive finite scale
    (rounded to f32 as the call passes it) and 16-byte aligned pointers."""
    f32 = ctypes.c_float(scale).value
    return (dtype == 0 and d in WIDE_WGMMA_HEAD_DIMS and 1 <= valid_len <= s
            and 0.0 < f32 <= _FLT_MAX and all(p % 16 == 0 for p in ptrs))


def wide_tf32_scratch_floats(bh: int, d: int, valid_len: int) -> int:
    """The mirror of ``bff_flash_wide_tf32_scratch_floats``: the floats of
    scratch a :func:`wide_tf32_route` call needs, the pre-pass's K hi and lo
    and V^T hi and lo images of every tile up to ``valid_len``
    (:func:`relpos_wide_tf32_plan`'s keys a tile, DP columns)."""
    plan = relpos_wide_tf32_plan(d)
    return 4 * bh * -(-valid_len // plan["keys"]) * plan["keys"] * plan["dp"]


# csrc/relpos_attention_wide_wgmma.cu (bf16) and
# csrc/relpos_attention_wide_tf32.cu (f32): K4 at the wide kernel's head dims
# (``WIDE_WGMMA_HEAD_DIMS``); the wgmma kernel's factor table (the streamed
# plan with bias_w whole up to 64 grid columns and one slot) and the 3xTF32
# kernel's blocks of one 64-row consumer warpgroup
RELPOS_WIDE_FIXED_W = 64
RELPOS_WIDE_SLOTS = 1
RELPOS_WIDE_TF32_BLOCK_Q = 64


def relpos_wide_wgmma_route(kind: int, dtype: int, d: int, s: int, rows: int, cols: int,
                            scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_relpos_wide_wgmma_takes``: whether K4's kernels
    (kind 0, a ``rows`` x ``cols`` = kh x kw grid) or K5's windows that run
    on them (kind 1) take the wgmma/TMA kernel of
    ``csrc/relpos_attention_wide_wgmma.cu`` (counted as
    ``flash_attention_relpos_wide_wgmma``): bf16, head dim a multiple of 16
    from 144 to 256, any grid (inside or past the factor table), a positive
    finite scale (rounded to f32 as the call passes it), q, k, v and the
    output on 16 bytes and both factors (``ptrs``' last two) on 4."""
    f32 = ctypes.c_float(scale).value
    shape = kind in (0, 1) and rows >= 1 and cols >= 1 and rows * cols == s
    return (shape and dtype == 1 and d in WIDE_WGMMA_HEAD_DIMS and 0.0 < f32 <= _FLT_MAX
            and all(p % 16 == 0 for p in ptrs[:4]) and all(p % 4 == 0 for p in ptrs[4:]))


def relpos_wide_tf32_route(kind: int, dtype: int, d: int, s: int, rows: int, cols: int,
                           scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_relpos_wide_tf32_takes``: whether K4's kernels
    (kind 0) or K5's windows that run on them (kind 1) take the 3xTF32
    wgmma kernel of ``csrc/relpos_attention_wide_tf32.cu`` (counted as
    ``flash_attention_relpos_wide_tf32``): f32, head dim a multiple of 16
    from 144 to 256, any grid (the kernel reads each score's factors from
    device memory, so it needs no factor table), a positive finite scale and
    every pointer on 16 bytes."""
    f32 = ctypes.c_float(scale).value
    shape = kind in (0, 1) and rows >= 1 and cols >= 1 and rows * cols == s
    return (shape and dtype == 0 and d in WIDE_WGMMA_HEAD_DIMS and 0.0 < f32 <= _FLT_MAX
            and all(p % 16 == 0 for p in ptrs))


def relpos_wide_tf32_plan(d: int) -> dict:
    """The mirror of ``csrc/relpos_attention_wide_tf32.cu``'s ``Cfg<DP>`` at
    head dim ``d``, which both of its functions (the rel-pos bias and the
    key mask, :func:`wide_tf32_route`) share: the padded head dim ``dp``
    (``d`` rounded up to 32), the keys of a tile (32; 16 at DP 256, where
    Q's images take 128 KB), the output columns of a fold part (32 at DP
    256 and 56 at DP 224, where wider parts spilled) and the parts, and the
    bytes of shared memory a block asks (Q's hi and lo images for 64 rows,
    one K and one V^T stage of hi and lo, the barriers and the 1024 bytes of
    alignment)."""
    dp = -(-d // 32) * 32
    n = 16 if dp == 256 else 32
    fold = {256: 32, 224: 56}.get(dp, dp // 2)
    return {"dp": dp, "keys": n, "fold": fold, "parts": dp // fold,
            "smem": 2 * RELPOS_WIDE_TF32_BLOCK_Q * dp * 4 + 4 * n * dp * 4 + 64 + 1024}


def relpos_staged_bias(bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                       fixed_w: int = RELPOS_WIDE_FIXED_W,
                       slots: int = RELPOS_WIDE_SLOTS) -> torch.Tensor:
    """The bias each score reads through the streamed table (blocks of 128
    rows, 64-key tiles; :func:`relpos_stream_stage`, the fixed part and
    :func:`relpos_stream_offsets` at ``fixed_w`` and ``slots``; the wide
    wgmma kernel's plan by default) as a dense (BH, rows, keys) f32 tensor,
    both padded to whole blocks and tiles with zeros: the factors in their
    dtype, summed in f32."""
    g, s, kh = bias_h.shape
    fh = bias_h.float().reshape(-1).numpy()
    fw = bias_w.float().reshape(-1).numpy()
    lay = relpos_stream_layout(kw, fixed_w, slots)
    n_tiles = -(-s // STREAM_TILE)
    out = np.zeros((g, -(-s // STREAM_ROWS) * STREAM_ROWS, n_tiles * STREAM_TILE), np.float32)
    for h in range(g):
        for q0 in range(0, s, STREAM_ROWS):
            row0 = h * s + q0
            table = np.zeros((STREAM_ROWS, lay["ld"]), np.float32)
            relpos_stream_fixed(table, fw, kw, s, row0, q0, fixed_w, slots)
            parity = (row0 + np.arange(STREAM_ROWS)) & 1
            for k0 in range(0, s, STREAM_TILE):
                relpos_stream_stage(table, fh, fw, kh, kw, s, row0, q0, k0, fixed_w, slots)
                for rho in (0, 1):
                    hoff, woff, live = relpos_stream_offsets(kh, kw, s, k0, rho, fixed_w, slots)
                    sel = np.nonzero(parity == rho)[0]
                    got = table[sel][:, hoff] + table[sel][:, woff]
                    out[h, q0 + sel, k0:k0 + STREAM_TILE] = np.where(live[None], got, 0.0)
    return torch.from_numpy(out)


def relpos_wide_wgmma_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of ``csrc/relpos_attention_wide_wgmma.cu`` in PyTorch
    on the CPU, block by block of :func:`wide_wgmma_schedule`: each score's
    bias as the kernel reads it from its staged table
    (:func:`relpos_staged_bias`: bias_w whole up to 64 grid columns, each
    tile's columns streamed past them, one slot), each logit s * scale +
    bias_h + bias_w in f32 (the factors rounded to the inputs' dtype), keys
    past S at -inf, then :func:`masked_wgmma_mirror`'s tile walk in log2
    units (the lazy running max, column tiles wholly past S at p = 0, P
    rounded before P V, the output divided once)."""
    g, s, _d = q.shape
    bias = relpos_staged_bias(bias_h.to(q.dtype), bias_w.to(q.dtype), kw)
    return _wgmma_rows_mirror(q, k, v, None, scale, wide_wgmma_schedule(g, s)[1], bias)


def relpos_wide_tf32_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                            scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of ``csrc/relpos_attention_wide_tf32.cu`` with the
    rel-pos bias, in PyTorch on the CPU: :func:`_wide_tf32_rows` over every
    key, each score's bias_h + bias_w (in f32) its modifier."""
    s = q.shape[1]
    return _wide_tf32_rows(q, k, v, s, scale, relpos_bias(bias_h, bias_w, torch.float32))


def wide_tf32_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of ``csrc/relpos_attention_wide_tf32.cu`` with the key
    mask (:func:`wide_tf32_route`), in PyTorch on the CPU:
    :func:`_wide_tf32_rows` over the keys up to ``valid_len``, the scores of
    the keys past it in the last tile at -inf (the kernel's pre-pass splits
    K and V as its producer does with the bias: the same words)."""
    s = q.shape[1]
    return _wide_tf32_rows(q, k, v, s if valid_len is None else int(valid_len), scale)


def _wide_tf32_rows(q, k, v, keys, scale, bias=None):
    """The wide 3xTF32 kernel's arithmetic in f32, block by block of
    ``RELPOS_WIDE_TF32_BLOCK_Q`` rows, over the keys 0 .. ``keys`` - 1: Q
    times the scale, split (:func:`tf32_split`); per tile of
    :func:`relpos_wide_tf32_plan`'s keys (keys past ``keys`` zero), K and V
    split (V^T with each 8-key group in ``TF32_KEY_ORDER``), the scores
    ((lo(Q) hi(K)^T + hi(Q) lo(K)^T) + hi(Q) hi(K)^T) from zero, then the
    modifier: each score's ``bias`` (a dense (BH, S, keys) f32 tensor) added
    in f32, or with no ``bias`` nothing (keys past ``keys`` at -inf either
    way); the running max (log2 units) raised at every tile; p = 2^(s log2
    e - m) (one rounding); the denominator summed from the f32 p; the output
    rescaled and the tile's (lo(P) hi(V) + hi(P) lo(V)) + hi(P) hi(V) summed
    apart and added to it (the kernel adds it in column parts: the same sums
    column by column; the zero columns of the padded head dim add nothing);
    the output divided once. Every word handed to the products is
    rna-rounded TF32, so the hardware's truncation is not modelled."""
    g, s, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    l2e = float(torch.tensor(1.4426950408889634, dtype=torch.float32))
    sc_f32 = float(torch.tensor(scale, dtype=torch.float32))
    tile = relpos_wide_tf32_plan(d)["keys"]
    n_tiles = -(-keys // tile)
    kp = tile * n_tiles
    kz = torch.zeros(g, kp, d)
    vz = torch.zeros(g, kp, d)
    kz[:, :keys] = k[:, :keys].float()
    vz[:, :keys] = v[:, :keys].float()
    k_hi, k_lo = tf32_split(kz)
    order = torch.tensor([8 * (j // 8) + TF32_KEY_ORDER[j % 8] for j in range(kp)])
    vt_hi, vt_lo = (t[:, order].transpose(1, 2) for t in tf32_split(vz))  # (g, D, Kp)
    full = torch.full((g, s, kp), float("-inf"))
    full[:, :, :keys] = 0.0 if bias is None else bias
    bm = RELPOS_WIDE_TF32_BLOCK_Q
    out = torch.zeros(g, s, d)
    for h in range(g):
        for r0 in range(0, s, bm):
            rows = torch.arange(r0, min(r0 + bm, s))
            qt = torch.zeros(bm, d)
            qt[:len(rows)] = q[h, rows].float() * sc_f32
            q_hi, q_lo = tf32_split(qt)
            b = torch.zeros(bm, kp)
            b[:len(rows)] = full[h, rows]
            b[len(rows):, keys:] = float("-inf")
            m = torch.full((bm,), -1e30)
            l = torch.zeros(bm)
            acc = torch.zeros(bm, d)
            for t in range(n_tiles):
                ks = slice(t * tile, (t + 1) * tile)
                sco = ((q_lo @ k_hi[h, ks].T + q_hi @ k_lo[h, ks].T)
                       + q_hi @ k_hi[h, ks].T) + b[:, ks]
                m_new = torch.maximum(m, sco.max(dim=1).values * l2e)
                corr = torch.exp2(m - m_new)
                m = m_new
                l = l * corr
                x = (sco.double() * l2e - m[:, None].double()).float()  # the FMA's rounding
                p = torch.exp2(x.double()).float()  # exact, standing in for ex2.approx
                l = l + p.sum(dim=1)
                acc = acc * corr[:, None]
                p_hi, p_lo = tf32_split(p[:, order[:tile]])  # the A fragments' column order
                acc = acc + ((p_lo @ vt_hi[h, :, ks].T + p_hi @ vt_lo[h, :, ks].T)
                             + p_hi @ vt_hi[h, :, ks].T)
            out[h, rows] = (acc / l[:, None])[:len(rows)]
    return out


def relpos_wgmma_route(kind: int, dtype: int, d: int, s: int, rows: int, cols: int,
                       scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_relpos_wgmma_takes``: whether the rel-pos entries
    run the wgmma/TMA kernels of ``csrc/relpos_attention_wgmma.cu`` for a
    call. ``kind`` 0 is ``bff_flash_attention_relpos`` (K4, a ``rows`` x
    ``cols`` = kh x kw key grid), 1 is ``bff_window_attention_relpos`` (K5,
    wh x ww windows); dtype 0 = float32, 1 = bfloat16; ``ptrs`` the data
    pointers of q, k, v, the output, bias_h and bias_w. Taken: bf16, head
    dim 80, kw = 64 with 1 <= kh <= 64 (K4) or 14 x 14 windows (K5), a
    positive finite scale (rounded to f32 as the call passes it) and every
    pointer 16-byte aligned."""
    f32 = ctypes.c_float(scale).value
    if kind == 0:
        shape = cols == 64 and 1 <= rows <= 64 and s == rows * cols
    elif kind == 1:
        shape = rows == 14 and cols == 14 and s == 196
    else:
        shape = False
    return (shape and dtype == 1 and d == 80 and 0.0 < f32 <= _FLT_MAX
            and all(p % 16 == 0 for p in ptrs))


def relpos_wgmma_fragment(kind: int, warp: int, lane: int, tile: int, s: int = 196):
    """The mirror of ``csrc/relpos_attention_wgmma.cu``'s index arithmetic:
    for lane ``lane`` of warp ``warp`` (0..3) of a consumer warpgroup, one
    tuple per score register i, (i, row, key, ky, kx, table_row): the
    warpgroup row and the key its accumulator value holds, the grid cell
    (ky, kx) whose factors the kernel adds to it, and the row of the factor
    table it reads them from (None where the key is masked). Register 4 j + e
    holds row 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e %
    2 of the m64nN tile.

    K4 (kind 0): ``tile`` is the 128-key tile t of a 64-wide grid (grid rows
    2 t and 2 t + 1); ky = 2 t + j / 8, kx = 8 (j % 8) + 2 (lane % 4) + e %
    2 (bias_w held in registers, bias_h by half-row); rows are the
    warpgroup's, the table row the same. K5 (kind 1): ``tile`` is the m-tile
    of a 14 x 14 window of ``s`` = 196 tokens; key = column of the n200 tile;
    the pair c = 8 j + 2 (lane % 4) gives ky = c / 14, kx = c % 14 + e % 2;
    keys >= s are masked; the table row is min(row, s - 1)."""
    quad = lane % 4
    out = []
    for i in range(64 if kind == 0 else 100):
        j, e = divmod(i, 4)
        row = 16 * warp + lane // 4 + 8 * (e // 2)
        col = 8 * j + 2 * quad + e % 2
        if kind == 0:
            out.append((i, row, 128 * tile + col, 2 * tile + j // 8,
                        8 * (j % 8) + 2 * quad + e % 2, row))
        else:
            row += 64 * tile
            c = 8 * j + 2 * quad
            if c < s:
                out.append((i, row, col, c // 14, c % 14 + e % 2, min(row, s - 1)))
            else:
                out.append((i, row, col, None, None, None))
    return out


# csrc/relpos_attention_tf32.cu: K4's 64-key tiles (one grid row of kw =
# 64; in the narrow and straddling modes, kw < 64, and the streamed mode,
# kw > 64, 64 keys across grid rows; 32 keys at head dims 112 and 128,
# RELPOS_TF32_TILE_LARGE), K5's 40-key tiles over a 14 x 14
# window's 196 keys (200 with the masked ones), 128-row blocks (K4) and
# rounds (K5) of two 64-row consumer warpgroups, the smallest grid height K4
# takes (and any larger one), the narrow mode's smallest width (its widths
# are multiples of 8) and the straddling mode's (every other width below
# 64)
RELPOS_TF32_TILE = 64
RELPOS_TF32_TILE_LARGE = 32
RELPOS_TF32_WINDOW_TILE = 40
RELPOS_TF32_BLOCK_Q = 128
RELPOS_TF32_MIN_GRID_H = 1
RELPOS_TF32_MIN_GRID_W = 8
RELPOS_TF32_MIN_STRADDLE_W = 1
# the head dims each takes: K4 (kind 0) the multiples of 16 from 32 to 128
# (SAM ViT-L/B's 64, ViT-H's 80), K5 80
RELPOS_TF32_HEAD_DIMS = {0: (32, 48, 64, 80, 96, 112, 128), 1: (80,)}
# K4's head dims whose scores are summed from zero, bias_w added in f32
# after the products (kBiasAfter96, kBiasAfter128): from 96 on the tensor
# cores' sums would carry the factors' magnitude through 36 to 48 k-steps
RELPOS_TF32_BIAS_AFTER = (96, 112, 128)
_WIN, _WIN_S = 14, 196


def relpos_tf32_route(kind: int, dtype: int, d: int, s: int, rows: int, cols: int,
                      scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_relpos_tf32_takes``: whether the rel-pos entries
    run the 3xTF32 wgmma kernels of ``csrc/relpos_attention_tf32.cu`` for a
    call. ``kind`` 0 is ``bff_flash_attention_relpos`` (K4, a ``rows`` x
    ``cols`` = kh x kw key grid), 1 is ``bff_window_attention_relpos`` (K5,
    wh x ww windows); dtype 0 = float32, 1 = bfloat16; ``ptrs`` the data
    pointers of q, k, v, the output, bias_h and bias_w. Taken: f32, any kh
    from ``RELPOS_TF32_MIN_GRID_H`` with kw = 64, kw a multiple of 8 from
    ``RELPOS_TF32_MIN_GRID_W`` to 56 (the narrow mode) or any other kw from
    ``RELPOS_TF32_MIN_STRADDLE_W`` to 63 (the straddling mode) at head dims
    32 to 128 in steps of 16 (K4; the window entry asks so, kind 0, for its
    windows past 256 tokens), or 14 x 14 windows at head dim 80 (K5), a positive finite
    scale (rounded to f32 as the call passes it) and every pointer 16-byte
    aligned. Grids wider than 64 are :func:`relpos_tf32_streamed_route`'s."""
    f32 = ctypes.c_float(scale).value
    if kind == 0:
        least = RELPOS_TF32_MIN_GRID_W if cols % 8 == 0 else RELPOS_TF32_MIN_STRADDLE_W
        width = cols == 64 or least <= cols < 64
        shape = width and RELPOS_TF32_MIN_GRID_H <= rows and s == rows * cols
    elif kind == 1:
        shape = rows == _WIN and cols == _WIN and s == _WIN_S
    else:
        shape = False
    return (shape and dtype == 0 and d in RELPOS_TF32_HEAD_DIMS[kind] and 0.0 < f32 <= _FLT_MAX
            and all(p % 16 == 0 for p in ptrs))


def relpos_tf32_streamed_route(kind: int, dtype: int, d: int, s: int, rows: int, cols: int,
                               scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_relpos_tf32_streamed_takes``: whether K4's kernels
    (kind 0, a ``rows`` x ``cols`` = kh x kw grid; the window entry asks so
    for its windows past 256 tokens) take ``csrc/relpos_attention_tf32.cu``'s
    3xTF32 kernel in its streamed mode (counted as
    ``flash_attention_relpos_tf32_streamed``): f32 at head dims 32 to 128 in
    steps of 16, any kh >= 1 and kw past 64, a positive finite scale (rounded to f32 as
    the call passes it) and every pointer 16-byte aligned."""
    f32 = ctypes.c_float(scale).value
    shape = kind == 0 and rows >= 1 and cols > 64 and s == rows * cols
    return (shape and dtype == 0 and d in RELPOS_TF32_HEAD_DIMS[0] and 0.0 < f32 <= _FLT_MAX
            and all(p % 16 == 0 for p in ptrs))


def relpos_tf32_mode(kw: int) -> str:
    """The mode ``csrc/relpos_attention_tf32.cu``'s K4 kernel runs a grid
    ``kw`` wide in (within the routes): ``wide`` (kw = 64, a tile one grid
    row), ``narrow`` (a multiple of 8 below 64: an n8 group of keys in one
    grid row, bias_w the scores' start and bias_h the group's shift),
    ``straddle`` (any other width below 64: groups straddle grid rows, each
    score's whole bias added in f32 once the products are in) or
    ``streamed`` (past 64: a tile in at most two grid rows, its bias_w run of
    64 columns staged a tile at a time, each score's whole bias added in f32
    once the products are in)."""
    if kw > 64:
        return "streamed"
    return "wide" if kw == 64 else "narrow" if kw % 8 == 0 else "straddle"


def relpos_tf32_straddle_ld(kw: int) -> int:
    """The straddling mode's bias_w table stride (``straddle_ld``): the least
    stride >= kw that is 3 mod 16 floats."""
    return kw + (19 - kw % 16) % 16


def relpos_tf32_tile(d: int) -> int:
    """The keys of a K4 tile at head dim ``d`` on the 3xTF32 kernel
    (``K4Cfg<D>::kBN``): 64, and 32 at head dims 112 and 128, where a 64-key
    stage's images beside Q's pass the block's shared memory."""
    return RELPOS_TF32_TILE_LARGE if d > 96 else RELPOS_TF32_TILE


def relpos_tf32_scratch_floats(bh: int, s: int, d: int) -> int:
    """The mirror of ``bff_relpos_tf32_scratch_floats``: the floats of scratch
    a K4 call at head dim ``d`` on the 3xTF32 kernel needs, each tile's
    (:func:`relpos_tf32_tile`) K hi, K lo, V^T hi and V^T lo images, 4 BH Sp
    D with Sp = S rounded up to the tile (S = 64 kh is whole tiles; a narrow
    grid's last tile is padded)."""
    tile = relpos_tf32_tile(d)
    return 4 * bh * (-(-s // tile) * tile) * d


def relpos_counter(kind: int, dtype: int, d: int, s: int, rows: int, cols: int, scale: float,
                   *ptrs: int) -> str:
    """The launch counter a rel-pos call counts under, as the entries' routes
    decide: ``..._wgmma`` (:func:`relpos_wgmma_route`), ``..._tf32``
    (:func:`relpos_tf32_route`) or the entry's own (the mma.sync tile and the
    FMA kernels) after ``flash_attention_relpos`` (kind 0) or
    ``window_attention_relpos`` (kind 1); K5's windows that
    :func:`window_on_flash` sends to K4's kernels count as
    ``flash_attention_relpos``, or as K4's 3xTF32 kernel where it takes them
    (f32 at head dims 32 to 128 in steps of 16: ``flash_attention_relpos_tf32``,
    and past 64 grid columns ``flash_attention_relpos_tf32_streamed``,
    :func:`relpos_tf32_streamed_route`, as K4's own calls there); past the
    factor table, the tile with
    streamed factors (:func:`relpos_streamed_route`) as
    ``flash_attention_relpos_streamed``; at head dims 144 to 256 the wide
    kernels (K5's windows there too) as ``flash_attention_relpos_wide_wgmma``
    (:func:`relpos_wide_wgmma_route`) and ``flash_attention_relpos_wide_tf32``
    (:func:`relpos_wide_tf32_route`)."""
    if relpos_streamed_route(kind, dtype, d, s, rows, cols, scale, *ptrs):
        return "flash_attention_relpos_streamed"
    if relpos_wide_wgmma_route(kind, dtype, d, s, rows, cols, scale, *ptrs):
        return "flash_attention_relpos_wide_wgmma"
    if relpos_wide_tf32_route(kind, dtype, d, s, rows, cols, scale, *ptrs):
        return "flash_attention_relpos_wide_tf32"
    on_flash = kind == 1 and window_on_flash(s, d)  # K4's kernels, windows as heads
    name = "window_attention_relpos" if kind == 1 and not on_flash else "flash_attention_relpos"
    if not on_flash and relpos_wgmma_route(kind, dtype, d, s, rows, cols, scale, *ptrs):
        return name + "_wgmma"
    if relpos_tf32_route(0 if on_flash else kind, dtype, d, s, rows, cols, scale, *ptrs):
        return name + "_tf32"
    if relpos_tf32_streamed_route(0 if on_flash else kind, dtype, d, s, rows, cols, scale,
                                  *ptrs):
        return "flash_attention_relpos_tf32_streamed"
    return name


def relpos_tf32_schedule(kind: int, n: int, s: int, sms: int = 132):
    """The mirror of ``csrc/relpos_attention_tf32.cu``'s grids: (grid,
    tiles). K4 (kind 0, ``n`` heads of S = ``s`` tokens): the grid (ceil(S /
    128), n), block (x, head) -> the first rows of its two consumer
    warpgroups, [(head, 128 x), (head, 128 x + 64)]. K5 (kind 1, ``n``
    windows of ``s`` = 196): a persistent grid of min(2 n, ``sms``) blocks,
    block b walking items b, b + grid, ... (item i: window i / 2, rows 128
    (i % 2) ..), block b -> [(window, first row) for each item and
    consumer]. Rows past S (or 196) are computed and not written."""
    if kind == 0:
        grid = (-(-s // RELPOS_TF32_BLOCK_Q), n)
        tiles = {(x, h): [(h, RELPOS_TF32_BLOCK_Q * x), (h, RELPOS_TF32_BLOCK_Q * x + 64)]
                 for h in range(n) for x in range(grid[0])}
        return grid, tiles
    items = 2 * n
    grid = (min(items, sms),)
    tiles = {(b,): [(i // 2, RELPOS_TF32_BLOCK_Q * (i % 2) + 64 * w)
                    for i in range(b, items, grid[0]) for w in range(2)]
             for b in range(grid[0])}
    return grid, tiles


def relpos_tf32_fragment(kind: int, warp: int, lane: int, tile: int, s: int = 196,
                         kw: int = 64, d: int = 80):
    """The mirror of ``csrc/relpos_attention_tf32.cu``'s score index
    arithmetic: for lane ``lane`` of warp ``warp`` (0..3) of a consumer
    warpgroup and key tile ``tile``, one tuple per score register i, (i,
    row, key, ky, kx): the warpgroup row and the key the accumulator value
    holds and the grid cell whose factors start it (None where the key is
    masked). Register 4 j + e holds row 16 warp + lane / 4 + 8 (e / 2),
    column 8 j + 2 (lane % 4) + e % 2 of the m64nN tile.

    K4 (kind 0, n-key tiles of a grid ``kw`` wide at head dim ``d``, n =
    :func:`relpos_tf32_tile`, ``s`` keys; 64 in what follows): key 64 tile +
    column. At kw = 64, ky = tile (bias_h, a row shift), kx = the column
    (bias_w, the initial value, from the table row of the warpgroup row);
    at 32-key tiles ky = tile / 2 and kx = 32 (tile % 2) + the column. In
    the narrow mode (kw < 64, a multiple of 8) n8 group j's keys lie in one
    grid row: ky = (64 tile + 8 j) / kw (bias_h, the group's
    shift), kx = (64 tile + 8 j) % kw + 2 (lane % 4) + e % 2 (bias_w, the
    initial value), the kernel's running (ky, kx) advanced by 8 keys a
    group without a division; keys >= ``s`` are masked. In the straddling
    mode (kw < 64, not a multiple of 8) each score's own key: (ky, kx) of
    the lane's first key 64 tile + 2 (lane % 4) from one division, advanced
    by 8 keys a group (one wrap at kw >= 8, a division below), the second
    key of the pair the next column or the next row's first (bias_h and
    bias_w both added after the products); keys >= ``s`` are masked. In the
    streamed mode (kw > 64) the tile's first key gives (ky, kx0) by one
    division, and column c lies at (ky, kx0 + c) below ``split`` = kw - kx0,
    else at (ky + 1, kx0 + c - kw): bias_h two reads a row, bias_w the
    column of :func:`relpos_tf32_bw_slot`'s run (both added after the
    products); keys >= ``s`` are masked. K5
    (kind 1, 40-key tiles of a 14 x 14 window): key 40 tile + column; the
    pair c = key - e % 2 gives ky = c / 14 and kx = c % 14 + e % 2 (one
    bias_h read and one 8-byte bias_w read a pair); keys >= ``s`` are
    masked."""
    n = relpos_tf32_tile(d) if kind == 0 else RELPOS_TF32_WINDOW_TILE
    quad = lane % 4
    out = []
    if kind == 0 and relpos_tf32_mode(kw) == "streamed":
        ky, kx0 = divmod(n * tile, kw)
        split = kw - kx0
        for i in range(n // 2):
            j, e = divmod(i, 4)
            row = 16 * warp + lane // 4 + 8 * (e // 2)
            col = 8 * j + 2 * quad + e % 2
            key = n * tile + col
            cell = (ky, kx0 + col) if col < split else (ky + 1, kx0 + col - kw)
            out.append((i, row, key, *cell) if key < s else (i, row, key, None, None))
        return out
    if kind == 0 and relpos_tf32_mode(kw) == "straddle":
        key = n * tile + 2 * quad
        ky, kx = divmod(key, kw)
        cells = []
        for _j in range(n // 8):
            wrap = kx + 1 == kw
            cells.append(((ky, kx), (ky + wrap, 0 if wrap else kx + 1)))
            key += 8
            if kw >= 8:
                kx += 8
                if kx >= kw:
                    kx, ky = kx - kw, ky + 1
            else:
                ky, kx = divmod(key, kw)
        for i in range(n // 2):
            j, e = divmod(i, 4)
            row = 16 * warp + lane // 4 + 8 * (e // 2)
            col = 8 * j + 2 * quad + e % 2
            key = n * tile + col
            gy, gx = cells[j][e % 2]
            out.append((i, row, key, gy, gx) if key < s else (i, row, key, None, None))
        return out
    if kind == 0 and kw != 64:
        ky, kx = divmod(n * tile, kw)
        starts = []
        for _j in range(n // 8):
            starts.append((ky, kx))
            kx += 8
            if kx >= kw:
                kx, ky = kx - kw, ky + 1
    for i in range(n // 2):
        j, e = divmod(i, 4)
        row = 16 * warp + lane // 4 + 8 * (e // 2)
        col = 8 * j + 2 * quad + e % 2
        key = n * tile + col
        if kind == 0 and kw != 64:
            gy, gx = starts[j]
            out.append((i, row, key, gy, gx + 2 * quad + e % 2) if n * tile + 8 * j < s
                       else (i, row, key, None, None))
        elif kind == 0:
            out.append((i, row, key, *divmod(key, 64)))
        else:
            c = key - e % 2
            out.append((i, row, key, c // _WIN, c % _WIN + e % 2) if c < s
                       else (i, row, key, None, None))
    return out


def relpos_tf32_bw_slot(r: int, c: int, n: int = 64) -> int:
    """The mirror of the streamed mode's bias_w slot in
    ``csrc/relpos_attention_tf32.cu`` (one a K stage, filled by the
    producer warpgroup's other three warps): the float at which it holds
    column ``c`` (0..n - 1) of the tile's run for the block's row ``r``
    (0..127), at ``n``-key tiles (:func:`relpos_tf32_tile`): n floats a row,
    8-column group g stored at g ^ (r % (n / 8))."""
    return r * n + ((c // 8) ^ (r % (n // 8))) * 8 + c % 8


def relpos_tf32_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias_h: torch.Tensor, bias_w: torch.Tensor, kind: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of ``csrc/relpos_attention_tf32.cu`` in PyTorch on the
    CPU, block by block of :func:`relpos_tf32_schedule`, in f32. K4 (kind 0;
    q, k, v (BH, S, D) with D 32 to 128 in steps of 16, S = kh kw, bias_h (BH, S, kh),
    bias_w (BH, S, kw), kw = 64 or, in the narrow mode, a multiple of 8
    below it, or in the straddling mode any other width below it, or in the
    streamed mode any width past it) or K5
    (kind 1; (G, 196, 80), both factors (G, 196, 14)).
    K and V split into TF32 hi and lo (:func:`tf32_split`; V^T with each
    8-key group in ``TF32_KEY_ORDER``); per 64-row warpgroup tile, Q
    multiplied by the scale and split; per key tile (64 keys, one grid row,
    for K4 at kw = 64, half a row at head dims 112 and 128's 32-key tiles;
    64 (32) keys across rows in the narrow mode and 40 for K5, keys past S
    zero), the scores' accumulators start at the bias (K4:
    bias_w; K5: bias_h + bias_w; -inf for keys past S) and take lo(Q)
    hi(K)^T + hi(Q) lo(K)^T, then hi(Q) hi(K)^T (K4 at the head dims of
    ``RELPOS_TF32_BIAS_AFTER``: the products from zero, the bias added
    after them); the running max (log2
    units, K4's keys shifted by bias_h log2 e: of the tile's grid row at
    kw = 64, of each key's in the narrow mode; in the straddling and
    streamed modes the products from zero and the whole bias, bias_h +
    bias_w, added after them, no shift) raised at every tile; p =
    2^(s log2 e + shift - m) (one rounding); the denominator summed from
    the f32 p; the output rescaled, P split in the fragment order, the
    tile's (lo(P) hi(V) + hi(P) lo(V)) + hi(P) hi(V) summed apart and added
    to O in f32 (the kernels' kFold; K4 at head dims 96, 112 and 128 sums
    and adds it in column parts, the same sums column by column); the output
    divided once; rows past S not written (left 0). Every word handed to
    the products is rna-rounded TF32, so the hardware's truncation is not
    modelled."""
    n, s, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    l2e = float(torch.tensor(1.4426950408889634, dtype=torch.float32))
    sc = float(torch.tensor(scale, dtype=torch.float32))
    tile = relpos_tf32_tile(d) if kind == 0 else RELPOS_TF32_WINDOW_TILE
    kw = bias_w.shape[-1] if kind == 0 else _WIN
    # the straddling and streamed modes: the whole bias after the products
    straddle = kind == 0 and relpos_tf32_mode(kw) in ("straddle", "streamed")
    n_tiles = -(-s // tile)
    kp = tile * n_tiles
    kz = torch.zeros(n, kp, d)
    vz = torch.zeros(n, kp, d)
    kz[:, :s] = k.float()
    vz[:, :s] = v.float()
    k_hi, k_lo = tf32_split(kz)
    order = torch.tensor([8 * (j // 8) + TF32_KEY_ORDER[j % 8] for j in range(kp)])
    vt_hi, vt_lo = (t[:, order].transpose(1, 2) for t in tf32_split(vz))  # (n, D, Kp)
    bh_f, bw_f = bias_h.float(), bias_w.float()
    out = torch.zeros(n, s, d, dtype=torch.float32)
    written = torch.zeros(n, s, dtype=torch.int32)
    _grid, blocks = relpos_tf32_schedule(kind, n, s)
    for rows0 in blocks.values():
        for h, r0 in rows0:
            rows = torch.arange(r0, r0 + 64)
            live = rows < s
            qt = torch.zeros(64, d)
            qt[live] = q[h, rows[live]].float() * sc
            q_hi, q_lo = tf32_split(qt)
            m = torch.full((64,), -1e30)
            l = torch.zeros(64)
            acc = torch.zeros(64, d)
            for t in range(n_tiles):
                ks = slice(t * tile, (t + 1) * tile)
                keys = torch.arange(t * tile, (t + 1) * tile)
                init = torch.zeros(64, tile)
                shift = torch.zeros(64, tile)  # log2 units, a row's (or a key's) shift
                if kind == 0 and kw == RELPOS_TF32_TILE:
                    ky, kx0 = divmod(t * tile, kw)
                    init[live] = bw_f[h, rows[live], kx0:kx0 + tile]
                    shift[live] = (bh_f[h, rows[live], ky] * l2e)[:, None]
                else:
                    inside = keys < s
                    ky, kx = keys[inside] // kw, keys[inside] % kw
                    init[:, ~inside] = float("-inf")
                    r = rows[live]
                    at = (live.nonzero()[:, 0][:, None], inside.nonzero()[:, 0][None, :])
                    if kind == 0 and not straddle:  # narrow: bias_w starts, bias_h shifts
                        init[at] = bw_f[h, r][:, kx]
                        shift[at] = bh_f[h, r][:, ky] * l2e
                    else:  # K5, the straddling and streamed modes: the whole bias
                        init[at] = bh_f[h, r][:, ky] + bw_f[h, r][:, kx]
                if kind == 0 and (d in RELPOS_TF32_BIAS_AFTER or straddle):
                    sco = ((q_lo @ k_hi[h, ks].T + q_hi @ k_lo[h, ks].T)
                           + q_hi @ k_hi[h, ks].T) + init
                else:
                    sco = (((init + q_lo @ k_hi[h, ks].T) + q_hi @ k_lo[h, ks].T)
                           + q_hi @ k_hi[h, ks].T)
                mx = (sco.double() * l2e + shift.double()).max(dim=1).values.float()
                m_new = torch.maximum(m, mx)
                corr = torch.exp2(m - m_new)
                m = m_new
                l = l * corr
                c = shift - m[:, None]
                x = (sco.double() * l2e + c.double()).float()  # the FMA's rounding
                p = torch.exp2(x.double()).float()  # exact, standing in for ex2.approx
                l = l + p.sum(dim=1)
                acc = acc * corr[:, None]
                p_hi, p_lo = tf32_split(p[:, order[:tile]])  # the A fragments' column order
                acc = acc + ((p_lo @ vt_hi[h, :, ks].T + p_hi @ vt_lo[h, :, ks].T)
                             + p_hi @ vt_hi[h, :, ks].T)
            o = acc / l[:, None]
            out[h, rows[live]] = o[live]
            written[h, rows[live]] += 1
    if not bool((written == 1).all()):
        raise AssertionError("the schedule does not write every (head, row) once")
    return out


def _plain_probs(q: torch.Tensor, k: torch.Tensor, scale: float,
                 valid_len: Optional[int] = None,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain versions' f32 softmax probabilities (BH, S, S)."""
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    if valid_len is not None and valid_len < k.shape[1]:
        logits[..., valid_len:] = float("-inf")
    return torch.softmax(logits, dim=-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid_len: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Explicit-softmax attention with keys >= ``valid_len`` masked, in f32;
    the same function as the kernel. q, k, v: (BH, S, D)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    w = _plain_probs(q, k, scale, valid_len)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def bf16_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plain: torch.Tensor,
                     valid_len: Optional[int] = None, scale: Optional[float] = None,
                     bias_h: Optional[torch.Tensor] = None,
                     bias_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How far a bf16 flash kernel (the TPU's or the port's) may lie from the
    plain version ``plain`` of the same inputs, element by element:
    2^-8 (|P| @ |V|) + 2^-7 |plain| + 1e-4. The kernels round P to bf16
    before P V (``p.astype(v.dtype)`` in the TPU kernels), one bf16 unit of
    each term, and round the output once; |P| @ |V| comes from the plain
    version's f32 probabilities. For tests and ``chip_smoke.py``: rel-pos
    attention passes its factors, plain attention ``valid_len``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    bias = None if bias_h is None else relpos_bias(bias_h, bias_w, q.dtype)
    pv = torch.einsum("bqk,bkd->bqd", _plain_probs(q, k, scale, valid_len, bias),
                      v.float().abs())
    return 2.0 ** -8 * pv + 2.0 ** -7 * plain.float().abs() + 1e-4


def flash_counter(dtype: int, d: int, s: int, valid_len: int, scale: float, *ptrs: int) -> str:
    """The launch counter a ``bff_flash_attention`` call counts under, as its
    routes decide: ``flash_attention_wgmma`` (K3's bf16 kernel),
    ``flash_masked_wgmma`` (K2's), ``flash_attention_wide_wgmma`` (bf16 at
    head dims 144 to 256), ``flash_attention_wide_tf32`` (f32 there),
    ``flash_attention_tf32`` (the 3xTF32
    kernel of K2 and K3 in f32), ``flash_attention_f32`` (the f32-FMA kernel,
    every other f32 call) or ``flash_attention`` (every other bf16 call: the
    mma.sync tile)."""
    if wgmma_route(dtype, d, s, valid_len, scale, *ptrs):
        return "flash_attention_wgmma"
    if masked_wgmma_route(dtype, d, s, valid_len, scale, *ptrs):
        return "flash_masked_wgmma"
    if wide_wgmma_route(dtype, d, s, valid_len, scale, *ptrs):
        return "flash_attention_wide_wgmma"
    if wide_tf32_route(dtype, d, s, valid_len, scale, *ptrs):
        return "flash_attention_wide_tf32"
    if tf32_route(dtype, d, s, valid_len, scale, *ptrs):
        return "flash_attention_tf32"
    return "flash_attention_f32" if dtype == 0 else "flash_attention"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(BH, S, D) -> (BH, S, D) at any head dim; scale defaults to D ** -0.5."""
    if not dispatch.kernel_device(q, k, v):
        return flash_attention_plain(q, k, v, valid_len, scale)
    dispatch.refuse_autograd("flash_attention", q, k, v)
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    bh, s, d = q.shape
    if d < 1:
        raise ValueError(f"head dim {d} < 1")
    valid = s if valid_len is None else int(valid_len)
    if not 1 <= valid <= s:
        raise ValueError(f"valid_len {valid} outside [1, {s}]")
    scale = d ** -0.5 if scale is None else float(scale)
    from beyondff_tpu_torch.kernels import _build

    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    key = flash_counter(_DTYPES[q.dtype], d, s, valid, scale, *ptrs)
    scratch = None
    if key in ("flash_attention_tf32", "flash_attention_wide_tf32"):
        floats = (tf32_scratch_floats if key == "flash_attention_tf32"
                  else wide_tf32_scratch_floats)(bh, d, valid)
        scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
    rc = _build.library().bff_flash_attention(
        _DTYPES[q.dtype], *ptrs, bh, s, d, valid, ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
        None if scratch is None else scratch.data_ptr())
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed (code {rc})")
    dispatch.launch_counts[key] += 1
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (BH, S, D): plain dense for S < ``BLOCK_Q``, else the
    flash kernel with every key valid. The scale is d ** -0.5 of the true
    head dim, as in the JAX ``attend``."""
    bh, s, d = q.shape
    scale = d ** -0.5
    if s < BLOCK_Q:
        logits = torch.einsum("bqd,bkd->bqk", q * scale, k)
        w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        return torch.einsum("bqk,bkd->bqd", w, v)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           valid_len=s, scale=scale)


def relpos_bias(bias_h: torch.Tensor, bias_w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The dense (B, S, kh * kw) bias of the thin factors, rounded to
    ``dtype`` and added in f32: bias[q, ky * kw + kx] = bias_h[q, ky] +
    bias_w[q, kx]."""
    bh = bias_h.to(dtype).float()
    bw = bias_w.to(dtype).float()
    return (bh[..., :, None] + bw[..., None, :]).reshape(*bh.shape[:-1], -1)


def attend_relpos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(Q K^T * scale + bias) V with the dense bias and an f32
    softmax; the same function as the rel-pos kernel. q, k, v: (BH, S, D)
    with S = kh * kw raster-ordered; bias_h (BH, S, kh), bias_w (BH, S, kw)."""
    if bias_w.shape[-1] != kw:
        raise ValueError(f"bias_w has {bias_w.shape[-1]} columns for kw={kw}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    w = _plain_probs(q, k, scale, bias=relpos_bias(bias_h, bias_w, q.dtype))
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def _check_relpos(name, q, k, v, bias_h, bias_w, rows, cols):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    bh, s, d = q.shape
    if rows * cols != s:
        raise ValueError(f"{name}: a {rows} x {cols} grid for {s} tokens")
    if tuple(bias_h.shape) != (bh, s, rows) or tuple(bias_w.shape) != (bh, s, cols):
        raise ValueError(f"{name}: factors {tuple(bias_h.shape)}, {tuple(bias_w.shape)} for "
                         f"({bh}, {s}, {rows}) and ({bh}, {s}, {cols})")
    if d < 1:
        raise ValueError(f"{name}: head dim {d} < 1")


def _launch_relpos(fn_name, kind, q, k, v, bias_h, bias_w, rows, cols, scale):
    """Launch ``fn_name`` and count the launch under the counter
    :func:`relpos_counter` names; K4's 3xTF32 kernel (K5's windows past 256
    tokens on it too) gets its scratch."""
    from beyondff_tpu_torch.kernels import _build

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # the factors round to the inputs' dtype, as the JAX wrapper casts them
    bias_h = bias_h.to(q.dtype).contiguous()
    bias_w = bias_w.to(q.dtype).contiguous()
    bh, s, d = q.shape
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bias_h.data_ptr(),
            bias_w.data_ptr())
    counter = relpos_counter(kind, _DTYPES[q.dtype], d, s, rows, cols, scale, *ptrs)
    qp, kp, vp, op, hp, wp = ptrs
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch = None
    if counter in ("flash_attention_relpos_tf32", "flash_attention_relpos_tf32_streamed"):
        scratch = torch.empty(relpos_tf32_scratch_floats(bh, s, d), dtype=torch.float32,
                              device=q.device)
    rc = getattr(_build.library(), fn_name)(
        _DTYPES[q.dtype], qp, kp, vp, hp, wp, op, bh, s, d, rows, cols, ctypes.c_float(scale),
        stream, None if scratch is None else scratch.data_ptr())
    if rc != 0:
        raise RuntimeError(f"{counter} kernel launch failed (code {rc})")
    dispatch.launch_counts[counter] += 1
    return out


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over a raster-ordered (kh, kw) token grid with SAM's
    decomposed rel-pos bias from its thin factors: (BH, S, D) -> (BH, S, D),
    S = kh * kw, any grid and head dim; scale defaults to D ** -0.5."""
    if not dispatch.kernel_device(q, k, v, bias_h, bias_w):
        return attend_relpos_plain(q, k, v, bias_h, bias_w, kw, scale)
    dispatch.refuse_autograd("flash_attention_relpos", q, k, v, bias_h, bias_w)
    kh = bias_h.shape[-1]
    _check_relpos("flash_attention_relpos", q, k, v, bias_h, bias_w, kh, kw)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    return _launch_relpos("bff_flash_attention_relpos", 0, q, k, v, bias_h, bias_w, kh, kw,
                          scale)


def relpos_shapes_ok(kh: int, kw: int) -> bool:
    """The JAX package's routing predicate for its rel-pos kernel (whole grid
    rows per kv block, S divisible by both blocks), kept as it is so that the
    port takes its kernel exactly where the JAX package takes its Pallas
    kernel. The CUDA kernel itself has no block constraint."""
    s = kh * kw
    if s < BLOCK_Q:
        return False
    bq = min(BLOCK_Q, s)
    bkv = min(BLOCK_KV, s)
    bkv = max(kw, (bkv // kw) * kw)
    return s % bq == 0 and s % bkv == 0 and kw <= bkv


def attend_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int) -> torch.Tensor:
    """Rel-pos attention with the scale d ** -0.5 of the true head dim, as the
    JAX ``attend_relpos`` (which pads the head dim to 128 lanes; the kernel
    here needs no padding)."""
    return flash_attention_relpos(q, k, v, bias_h, bias_w, kw, scale=q.shape[-1] ** -0.5)
