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
``flash_masked_wgmma``; f32 at head dim 32 or 64 (K2 and K3 in
``detector.dtype: float32``) or 96 or 128 (:func:`tf32_route`) to the 3xTF32 wgmma/TMA
kernel of ``csrc/flash_attention_tf32.cu``, counted as
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
f32 head-dim-64 calls on them (SAM ViT-L's and ViT-B's global blocks) and
its f32 head-dim-64 and -80 calls on grids narrower than 64 whose width is a
multiple of 8 (portrait frames under ``BFF_SAM_RECT=1``;
:func:`relpos_tf32_route`) to the 3xTF32 wgmma kernel of
``csrc/relpos_attention_tf32.cu``, counted as
``flash_attention_relpos_tf32``; and the rest to the mma.sync tile or the
f32-FMA kernel, counted as ``flash_attention_relpos`` (:func:`relpos_counter`
names the counter of a call). The wrappers launch them for CUDA tensors and
raise on what they do not take; CPU tensors take the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
TF32_HEAD_DIMS = (32, 64, 96, 128)
TF32_MIN_S = 256
# the order of the keys of each 8-key group in the kernel's V^T (a lane's
# accumulator columns 2 t, 2 t + 1 are the A fragment's columns t, t + 4)
TF32_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_route(dtype: int, d: int, s: int, valid_len: int, scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_flash_tf32_takes``: whether ``bff_flash_attention``
    runs the 3xTF32 wgmma/TMA kernel of ``csrc/flash_attention_tf32.cu``
    for a call (dtype 0 = float32, 1 = bfloat16; ``ptrs`` the data pointers
    of q, k, v and the output): f32, head dim 32, 64, 96 or 128, S >=
    ``TF32_MIN_S``, 1 <= ``valid_len`` <= S, a positive finite scale
    (rounded to f32 as the call passes it) and 16-byte aligned pointers."""
    f32 = ctypes.c_float(scale).value
    return (dtype == 0 and d in TF32_HEAD_DIMS and s >= TF32_MIN_S and 1 <= valid_len <= s
            and 0.0 < f32 <= _FLT_MAX and all(p % 16 == 0 for p in ptrs))


def tf32_key_tile(d: int) -> int:
    """The keys of a tile of ``csrc/flash_attention_tf32.cu``'s online
    softmax at head dim ``d`` (``Cfg<D>::kBN``): 64, or 32 at head dim 128,
    where a 64-key stage beside both consumers' Q halves would not fit (at
    96 one 64-key stage of each fits)."""
    return 32 if d == 128 else 64


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
    at head dim 128). Every word handed to the products is rna-rounded
    TF32, so the hardware's truncation of the low 13 bits is the identity
    and is not modelled."""
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
    bh, s, d = q.shape
    valid = s if valid_len is None else int(valid_len)
    scale = d ** -0.5 if scale is None else scale
    sl2 = torch.tensor(scale * 1.4426950408889634, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros(bh, s, d, dtype=torch.float32)
    written = torch.zeros(bh, s, dtype=torch.int32)
    _c, _grid, tiles = masked_wgmma_schedule(bh, s)
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
# 64; in the narrow mode, kw < 64, 64 keys across grid rows), K5's 40-key
# tiles over a 14 x 14 window's 196 keys (200 with the masked ones), 128-row
# blocks (K4) and rounds (K5) of two 64-row consumer warpgroups, the
# smallest grid height K4 takes, and the narrow mode's smallest width (its
# widths are multiples of 8)
RELPOS_TF32_TILE = 64
RELPOS_TF32_WINDOW_TILE = 40
RELPOS_TF32_BLOCK_Q = 128
RELPOS_TF32_MIN_GRID_H = 1
RELPOS_TF32_MIN_GRID_W = 8
# the head dims each takes: K4 (kind 0) SAM ViT-L/B's 64 and ViT-H's 80, K5 80
RELPOS_TF32_HEAD_DIMS = {0: (64, 80), 1: (80,)}
_WIN, _WIN_S = 14, 196


def relpos_tf32_route(kind: int, dtype: int, d: int, s: int, rows: int, cols: int,
                      scale: float, *ptrs: int) -> bool:
    """The mirror of ``bff_relpos_tf32_takes``: whether the rel-pos entries
    run the 3xTF32 wgmma kernels of ``csrc/relpos_attention_tf32.cu`` for a
    call. ``kind`` 0 is ``bff_flash_attention_relpos`` (K4, a ``rows`` x
    ``cols`` = kh x kw key grid), 1 is ``bff_window_attention_relpos`` (K5,
    wh x ww windows); dtype 0 = float32, 1 = bfloat16; ``ptrs`` the data
    pointers of q, k, v, the output, bias_h and bias_w. Taken: f32,
    ``RELPOS_TF32_MIN_GRID_H`` <= kh <= 64 with kw = 64 or kw a multiple of 8
    from ``RELPOS_TF32_MIN_GRID_W`` to 56 (the narrow mode) at head dim 64 or
    80 (K4), or 14 x 14 windows at head dim 80 (K5), a positive finite scale
    (rounded to f32 as the call passes it) and every pointer 16-byte
    aligned."""
    f32 = ctypes.c_float(scale).value
    if kind == 0:
        width = cols == 64 or (cols % 8 == 0 and RELPOS_TF32_MIN_GRID_W <= cols < 64)
        shape = width and RELPOS_TF32_MIN_GRID_H <= rows <= 64 and s == rows * cols
    elif kind == 1:
        shape = rows == _WIN and cols == _WIN and s == _WIN_S
    else:
        shape = False
    return (shape and dtype == 0 and d in RELPOS_TF32_HEAD_DIMS[kind] and 0.0 < f32 <= _FLT_MAX
            and all(p % 16 == 0 for p in ptrs))


def relpos_tf32_scratch_floats(bh: int, s: int, d: int) -> int:
    """The mirror of ``bff_relpos_tf32_scratch_floats``: the floats of scratch
    a K4 call at head dim ``d`` on the 3xTF32 kernel needs, each 64-key
    tile's K hi, K lo, V^T hi and V^T lo images, 4 BH Sp D with Sp = S
    rounded up to 64 keys (S = 64 kh is whole tiles; a narrow grid's last
    tile is padded)."""
    return 4 * bh * (-(-s // RELPOS_TF32_TILE) * RELPOS_TF32_TILE) * d


def relpos_counter(kind: int, dtype: int, d: int, s: int, rows: int, cols: int, scale: float,
                   *ptrs: int) -> str:
    """The launch counter a rel-pos call counts under, as the entries' routes
    decide: ``..._wgmma`` (:func:`relpos_wgmma_route`), ``..._tf32``
    (:func:`relpos_tf32_route`) or the entry's own (the mma.sync tile and the
    FMA kernels) after ``flash_attention_relpos`` (kind 0) or
    ``window_attention_relpos`` (kind 1)."""
    name = "window_attention_relpos" if kind == 1 else "flash_attention_relpos"
    if relpos_wgmma_route(kind, dtype, d, s, rows, cols, scale, *ptrs):
        return name + "_wgmma"
    if relpos_tf32_route(kind, dtype, d, s, rows, cols, scale, *ptrs):
        return name + "_tf32"
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
                         kw: int = 64):
    """The mirror of ``csrc/relpos_attention_tf32.cu``'s score index
    arithmetic: for lane ``lane`` of warp ``warp`` (0..3) of a consumer
    warpgroup and key tile ``tile``, one tuple per score register i, (i,
    row, key, ky, kx): the warpgroup row and the key the accumulator value
    holds and the grid cell whose factors start it (None where the key is
    masked). Register 4 j + e holds row 16 warp + lane / 4 + 8 (e / 2),
    column 8 j + 2 (lane % 4) + e % 2 of the m64nN tile.

    K4 (kind 0, 64-key tiles of a grid ``kw`` wide, ``s`` keys): key 64
    tile + column. At kw = 64, ky = tile (bias_h, a row shift), kx = the
    column (bias_w, the initial value, from the table row of the warpgroup
    row). In the narrow mode (kw < 64, a multiple of 8) n8 group j's keys
    lie in one grid row: ky = (64 tile + 8 j) / kw (bias_h, the group's
    shift), kx = (64 tile + 8 j) % kw + 2 (lane % 4) + e % 2 (bias_w, the
    initial value), the kernel's running (ky, kx) advanced by 8 keys a
    group without a division; keys >= ``s`` are masked. K5 (kind 1,
    40-key tiles of a 14 x 14 window): key 40 tile + column; the pair c =
    key - e % 2 gives ky = c / 14 and kx = c % 14 + e % 2 (one bias_h read
    and one 8-byte bias_w read a pair); keys >= ``s`` are masked."""
    n = RELPOS_TF32_TILE if kind == 0 else RELPOS_TF32_WINDOW_TILE
    quad = lane % 4
    out = []
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
            out.append((i, row, key, tile, col))
        else:
            c = key - e % 2
            out.append((i, row, key, c // _WIN, c % _WIN + e % 2) if c < s
                       else (i, row, key, None, None))
    return out


def relpos_tf32_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias_h: torch.Tensor, bias_w: torch.Tensor, kind: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The arithmetic of ``csrc/relpos_attention_tf32.cu`` in PyTorch on the
    CPU, block by block of :func:`relpos_tf32_schedule`, in f32. K4 (kind 0;
    q, k, v (BH, S, D) with D 64 or 80, S = kh kw, bias_h (BH, S, kh),
    bias_w (BH, S, kw), kw = 64 or, in the narrow mode, a multiple of 8
    below it) or K5 (kind 1; (G, 196, 80), both factors (G, 196, 14)).
    K and V split into TF32 hi and lo (:func:`tf32_split`; V^T with each
    8-key group in ``TF32_KEY_ORDER``); per 64-row warpgroup tile, Q
    multiplied by the scale and split; per key tile (64 keys, one grid row,
    for K4 at kw = 64; 64 keys across rows in the narrow mode and 40 for K5,
    keys past S zero), the scores' accumulators start at the bias (K4:
    bias_w; K5: bias_h + bias_w; -inf for keys past S) and take lo(Q)
    hi(K)^T + hi(Q) lo(K)^T, then hi(Q) hi(K)^T; the running max (log2
    units, K4's keys shifted by bias_h log2 e: of the tile's grid row at
    kw = 64, of each key's in the narrow mode) raised at every tile; p =
    2^(s log2 e + shift - m) (one rounding); the denominator summed from
    the f32 p; the output rescaled, P split in the fragment order, the
    tile's (lo(P) hi(V) + hi(P) lo(V)) + hi(P) hi(V) summed apart and added
    to O in f32 (the kernels' kFold); the output divided once; rows past S
    not written (left 0). Every word handed to the products is rna-rounded
    TF32, so the hardware's truncation is not modelled."""
    n, s, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    l2e = float(torch.tensor(1.4426950408889634, dtype=torch.float32))
    sc = float(torch.tensor(scale, dtype=torch.float32))
    tile = RELPOS_TF32_TILE if kind == 0 else RELPOS_TF32_WINDOW_TILE
    kw = bias_w.shape[-1] if kind == 0 else _WIN
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
                    init[live] = bw_f[h, rows[live]]
                    shift[live] = (bh_f[h, rows[live], t] * l2e)[:, None]
                else:
                    inside = keys < s
                    ky, kx = keys[inside] // kw, keys[inside] % kw
                    init[:, ~inside] = float("-inf")
                    r = rows[live]
                    at = (live.nonzero()[:, 0][:, None], inside.nonzero()[:, 0][None, :])
                    if kind == 0:  # the narrow mode: bias_w starts, bias_h shifts the key
                        init[at] = bw_f[h, r][:, kx]
                        shift[at] = bh_f[h, r][:, ky] * l2e
                    else:
                        init[at] = bh_f[h, r][:, ky] + bw_f[h, r][:, kx]
                sco = ((init + q_lo @ k_hi[h, ks].T) + q_hi @ k_lo[h, ks].T) + q_hi @ k_hi[h, ks].T
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
    ``flash_masked_wgmma`` (K2's), ``flash_attention_tf32`` (the 3xTF32
    kernel of K2 and K3 in f32), ``flash_attention_f32`` (the f32-FMA kernel,
    every other f32 call) or ``flash_attention`` (every other bf16 call: the
    mma.sync tile)."""
    if wgmma_route(dtype, d, s, valid_len, scale, *ptrs):
        return "flash_attention_wgmma"
    if masked_wgmma_route(dtype, d, s, valid_len, scale, *ptrs):
        return "flash_masked_wgmma"
    if tf32_route(dtype, d, s, valid_len, scale, *ptrs):
        return "flash_attention_tf32"
    return "flash_attention_f32" if dtype == 0 else "flash_attention"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(BH, S, D) -> (BH, S, D); scale defaults to D ** -0.5."""
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
    if d > 128:
        raise ValueError(f"head dim {d} > 128")
    valid = s if valid_len is None else int(valid_len)
    if not 1 <= valid <= s:
        raise ValueError(f"valid_len {valid} outside [1, {s}]")
    scale = d ** -0.5 if scale is None else float(scale)
    from beyondff_tpu_torch.kernels import _build

    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    key = flash_counter(_DTYPES[q.dtype], d, s, valid, scale, *ptrs)
    scratch = None
    if key == "flash_attention_tf32":
        scratch = torch.empty(tf32_scratch_floats(bh, d, valid), dtype=torch.float32,
                              device=q.device)
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
    if d > 128:
        raise ValueError(f"{name}: head dim {d} > 128")


def _launch_relpos(fn_name, kind, q, k, v, bias_h, bias_w, rows, cols, scale):
    """Launch ``fn_name`` and count the launch under the counter
    :func:`relpos_counter` names; K4 on the 3xTF32 kernel gets its scratch."""
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
    args = (_DTYPES[q.dtype], qp, kp, vp, hp, wp, op, bh, s, d, rows, cols,
            ctypes.c_float(scale), stream)
    if kind == 0:
        scratch = None
        if counter == "flash_attention_relpos_tf32":
            scratch = torch.empty(relpos_tf32_scratch_floats(bh, s, d), dtype=torch.float32,
                                  device=q.device)
        args += (None if scratch is None else scratch.data_ptr(),)
    rc = getattr(_build.library(), fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{counter} kernel launch failed (code {rc})")
    dispatch.launch_counts[counter] += 1
    return out


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over a raster-ordered (kh, kw) token grid with SAM's
    decomposed rel-pos bias from its thin factors: (BH, S, D) -> (BH, S, D),
    S = kh * kw, kh + kw <= 256, D <= 128; scale defaults to D ** -0.5."""
    if not dispatch.kernel_device(q, k, v, bias_h, bias_w):
        return attend_relpos_plain(q, k, v, bias_h, bias_w, kw, scale)
    dispatch.refuse_autograd("flash_attention_relpos", q, k, v, bias_h, bias_w)
    kh = bias_h.shape[-1]
    _check_relpos("flash_attention_relpos", q, k, v, bias_h, bias_w, kh, kw)
    if kh + kw > 256:
        raise ValueError(f"flash_attention_relpos: kh + kw = {kh + kw} > 256")
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
