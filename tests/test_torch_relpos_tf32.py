"""K4 and K5 in f32 (SAM ViT-H's head-dim-80 rel-pos attention, and K4 at
SAM ViT-L's and ViT-B's head dim 64 and at head dim 96, and on grids
narrower than 64: the narrow and straddling modes; the straddling mode's
own cases are in tests/test_torch_any_shape.py) on the 3xTF32 wgmma kernels of
``csrc/relpos_attention_tf32.cu``.

On the CPU: the routing rule (``relpos_tf32_route``, the mirror of the C
predicate ``bff_relpos_tf32_takes``) and the counter a call moves, K4's
scratch size, the kernels' grids (``relpos_tf32_schedule``), their score
index arithmetic (``relpos_tf32_fragment``) against ``relpos_bias``, and
their arithmetic (``relpos_tf32_mirror``) against the plain versions and
against the JAX ``attend_relpos`` / ``window_attention_relpos`` in
interpret mode, in f32 at head dim 80 (and K4 at 64 and 96), within 1e-4 (the f32
calls' tolerance everywhere in the repository). Tests that need the card carry
the ``cuda`` marker and import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_relpos_tf32.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels import flash_attention as tfa
from beyondff_tpu_torch.kernels import window_attention as twa

torch.set_num_threads(2)

TOL = 1e-4  # f32 attention against its plain version
_S80 = 80 ** -0.5
_A = (0, 256, 512, 1024, 2048, 4096)  # q, k, v, o, bias_h, bias_w: 16-byte aligned
_COUNTERS = ("flash_attention_relpos_tf32", "window_attention_relpos_tf32")


@pytest.fixture
def jx():
    import types

    pytest.importorskip("jax")
    import jax.numpy as jnp

    import jax

    from beyondff_tpu.kernels import flash_attention as jfa
    from beyondff_tpu.kernels import window_attention as jwa
    from beyondff_tpu.models import sam as jsam

    return types.SimpleNamespace(jax=jax, jnp=jnp, fa=jfa, wa=jwa, sam=jsam)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_relpos_tf32.py")
    return torch.device("cuda")


def _inputs(seed, g, rows, cols, d=80, spread=1.0, bias_scale=0.5):
    """q, k, v (q and k scaled by ``spread``, the score scale) and the two
    factors from a seeded numpy generator, as CPU f32 tensors."""
    rng = np.random.default_rng(seed)
    s = rows * cols
    q, k, v = (rng.standard_normal((g, s, d)).astype(np.float32) for _ in range(3))
    bias_h = (rng.standard_normal((g, s, rows)) * bias_scale).astype(np.float32)
    bias_w = (rng.standard_normal((g, s, cols)) * bias_scale).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q * spread, k * spread, v, bias_h, bias_w)]
    return tuple(t)


def _rel_tables(rows, cols, d, scale=0.1):
    """Seeded rel-pos tables for a rows x cols grid, as SAM holds them."""
    rng = np.random.default_rng(rows * 100 + cols + d)
    return ((rng.standard_normal((2 * rows - 1, d)) * scale).astype(np.float32),
            (rng.standard_normal((2 * cols - 1, d)) * scale).astype(np.float32))


def _sam_factors(jx, rows, cols, g, d, spread):
    """q, k, v from a seeded numpy generator (q and k scaled by ``spread``)
    and the factors the JAX package's SAM builds from them
    (``_rel_pos_factors`` of q and the tables), as CPU f32 tensors."""
    rng = np.random.default_rng(g * rows * cols + d)
    s = rows * cols
    q, k, v = (rng.standard_normal((g, s, d)).astype(np.float32) for _ in range(3))
    q, k = q * spread, k * spread
    rel_h, rel_w = _rel_tables(rows, cols, d)
    bias_h, bias_w = jx.sam._rel_pos_factors((rows, cols), (rows, cols), jx.jnp.asarray(rel_h),
                                             jx.jnp.asarray(rel_w), jx.jnp.asarray(q))
    return tuple(torch.from_numpy(np.array(t, np.float32)) for t in (q, k, v, bias_h, bias_w))


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("args,takes", [
    ((0, 0, 80, 4096, 64, 64, _S80, *_A), True),  # K4: SAM ViT-H's global grid
    ((0, 0, 80, 3072, 48, 64, _S80, *_A), True),  # the rect grid
    ((0, 0, 80, 64, 1, 64, 2.0, *_A), True),  # one grid row, any positive scale
    ((0, 0, 80, 320, 5, 64, _S80, *_A), True),  # an odd kh: a ragged last query block
    ((1, 0, 80, 196, 14, 14, _S80, *_A), True),  # K5: SAM ViT-H's 14 x 14 windows
    ((0, 1, 80, 4096, 64, 64, _S80, *_A), False),  # bf16: the wgmma kernel
    ((1, 1, 80, 196, 14, 14, _S80, *_A), False),
    ((0, 0, 64, 4096, 64, 64, 0.125, *_A), True),  # K4: SAM ViT-L's and ViT-B's head dim
    ((0, 0, 64, 64, 1, 64, 0.125, *_A), True),  # head dim 64, one grid row
    ((0, 1, 64, 4096, 64, 64, 0.125, *_A), False),  # bf16 at head dim 64: the tile
    ((0, 0, 64, 2048, 64, 32, 0.125, *_A), True),  # head dim 64 on a 32-wide grid: narrow
    ((0, 0, 80, 2048, 64, 32, _S80, *_A), True),  # a 2:1 portrait frame's 64 x 32 grid
    ((0, 0, 80, 3072, 64, 48, _S80, *_A), True),  # a 4:3 portrait frame's 64 x 48 grid
    ((0, 0, 64, 3072, 64, 48, 0.125, *_A), True),
    ((0, 0, 64, 1024, 64, 16, 0.125, *_A), True),  # kw 16
    ((0, 0, 80, 8, 1, 8, _S80, *_A), True),  # the narrowest and shortest grid: one tile
    ((0, 0, 80, 3584, 64, 56, _S80, *_A), True),  # the widest narrow grid
    ((0, 0, 80, 120, 5, 24, _S80, *_A), True),  # kw 24: tiles straddle grid rows
    ((0, 0, 80, 260, 65, 4, _S80, *_A), True),  # kw 4 (straddling) with kh past 64
    ((0, 0, 80, 780, 65, 12, _S80, *_A), True),  # kw 12 (straddling) with kh past 64
    ((0, 0, 80, 2305, 64, 36, _S80, *_A), False),  # kw 36 (straddling), S off the grid
    ((0, 0, 80, 4608, 64, 72, _S80, *_A), False),  # wider than 64: the streamed mode's
    ((0, 0, 80, 2080, 65, 32, _S80, *_A), True),  # kh 65 on a 32-wide grid
    ((0, 0, 96, 2048, 64, 32, 96 ** -0.5, *_A), True),  # head dim 96 on a 32-wide grid
    ((0, 1, 80, 2048, 64, 32, _S80, *_A), False),  # bf16 on a 32-wide grid: the tile
    ((0, 0, 80, 2048, 64, 32, _S80, 0, 0, 0, 0, 4, 0), False),  # narrow, bias_h off 16 bytes
    ((0, 0, 64, 4096, 64, 64, 0.125, 0, 0, 0, 0, 0, 4), False),  # bias_w off 16 bytes
    ((1, 0, 64, 196, 14, 14, 0.125, *_A), False),  # K5 at head dim 64: the FMA kernel
    ((0, 0, 96, 4096, 64, 64, 96 ** -0.5, *_A), True),  # head dim 96: a swizzled table
    ((0, 0, 136, 4096, 64, 64, 136 ** -0.5, *_A), False),  # head dim 136: the FMA kernel
    ((0, 0, 80, 4096, 128, 32, _S80, *_A), True),  # kw 32 with kh past 64
    ((0, 0, 80, 8192, 128, 64, _S80, *_A), True),  # kh past 64
    ((0, 0, 80, 4095, 64, 64, _S80, *_A), False),  # S off the grid
    ((1, 0, 80, 256, 16, 16, _S80, *_A), False),  # 16 x 16 windows
    ((1, 0, 80, 196, 14, 14, _S80, 0, 0, 0, 0, 0, 8), False),  # bias_w off 16 bytes
    ((0, 0, 80, 4096, 64, 64, _S80, 0, 0, 0, 0, 4, 0), False),  # bias_h off 16 bytes
    ((0, 0, 80, 4096, 64, 64, _S80, 0, 8, 0, 0, 0, 0), False),  # k off 16 bytes
    ((1, 0, 80, 196, 14, 14, _S80, 0, 0, 0, 4, 0, 0), False),  # the output off 16 bytes
    ((0, 0, 80, 4096, 64, 64, 0.0, *_A), False),
    ((1, 0, 80, 196, 14, 14, -_S80, *_A), False),
    ((0, 0, 80, 4096, 64, 64, float("inf"), *_A), False),
    ((0, 0, 80, 4096, 64, 64, float("nan"), *_A), False),
    ((0, 0, 80, 4096, 64, 64, 1e39, *_A), False),  # inf once rounded to f32
    ((2, 0, 80, 196, 14, 14, _S80, *_A), False),  # no such entry
    ((0, 0, 96, 64, 8, 8, 96 ** -0.5, *_A), True),  # head dim 96 at kw 8: one tile
    ((0, 0, 96, 3072, 64, 48, 96 ** -0.5, *_A), True),  # head dim 96 on a 48-wide grid
    ((0, 0, 96, 3584, 64, 56, 96 ** -0.5, *_A), True),  # head dim 96, the widest narrow grid
    ((0, 0, 96, 64, 1, 64, 96 ** -0.5, *_A), True),  # head dim 96, one grid row
    ((0, 0, 96, 32, 1, 32, 96 ** -0.5, *_A), True),  # head dim 96, kh 1 on a 32-wide grid
    ((0, 0, 96, 2340, 65, 36, 96 ** -0.5, *_A), True),  # head dim 96, kw 36 with kh past 64
    ((0, 0, 96, 4096, 64, 64, 96 ** -0.5, 0, 0, 0, 0, 0, 4), False),  # bias_w off 16 bytes
    ((0, 0, 96, 2048, 64, 32, 96 ** -0.5, 4, 0, 0, 0, 0, 0), False),  # narrow, q off 16 bytes
    ((0, 1, 96, 4096, 64, 64, 96 ** -0.5, *_A), False),  # bf16 at head dim 96: the tile
    ((1, 0, 96, 196, 14, 14, 96 ** -0.5, *_A), False),  # K5 at head dim 96: the FMA kernel
    ((0, 0, 72, 4096, 64, 64, 72 ** -0.5, *_A), False),  # head dim 72: no multiple of 16
    ((0, 0, 40, 2048, 64, 32, 40 ** -0.5, *_A), False),
    # the straddling mode: widths below 64 that are no multiple of 8
    ((0, 0, 80, 256, 64, 4, _S80, *_A), True),  # kw 4: an n8 group spans two grid rows
    ((0, 0, 80, 768, 64, 12, _S80, *_A), True),  # kw 12
    ((0, 0, 80, 2304, 64, 36, _S80, *_A), True),  # kw 36: the 64 x 36 witness's grid
    ((0, 0, 96, 2304, 64, 36, 96 ** -0.5, *_A), True),  # head dim 96, kw 36
    ((0, 0, 64, 64, 64, 1, 0.125, *_A), True),  # kw 1: every key its own grid row
    ((0, 0, 80, 4032, 64, 63, _S80, *_A), True),  # kw 63, the widest
    ((0, 0, 80, 7, 1, 7, _S80, *_A), True),  # one grid row of 7: one padded tile
    ((0, 1, 80, 2304, 64, 36, _S80, *_A), False),  # bf16 at kw 36: the tile
    ((0, 0, 120, 2304, 64, 36, 120 ** -0.5, *_A), False),  # head dim 120 at kw 36
    ((0, 0, 80, 2304, 64, 36, _S80, 0, 0, 0, 0, 0, 4), False),  # kw 36, bias_w off 16 bytes
])
def test_relpos_tf32_route_pins_the_predicate(args, takes):
    """The Python mirror of ``bff_relpos_tf32_takes``: f32, any kh with kw =
    64, a multiple of 8 from 8 to 56 (the narrow mode) or any other width
    below 64 (the straddling mode) at head dim 64, 80 or 96 (K4) or 14 x 14
    windows at 80 (K5), a positive finite f32
    scale, six 16-byte aligned pointers; and the counter a call moves:
    ``..._tf32`` where it takes the call, else the bf16 wgmma kernels'
    ``..._wgmma``, the streamed mode's past 64 grid columns
    (``relpos_tf32_streamed_route``) or the entry's own (the mma.sync tile,
    the FMA kernels)."""
    assert tfa.relpos_tf32_route(*args) is takes
    kind = args[0]
    key = tfa.relpos_counter(*args)
    name = "window_attention_relpos" if kind == 1 else "flash_attention_relpos"
    if takes:
        assert key == name + "_tf32"
    elif tfa.relpos_wgmma_route(*args):
        assert key == name + "_wgmma"
    elif tfa.relpos_tf32_streamed_route(*args):
        assert key == "flash_attention_relpos_tf32_streamed"
    else:
        assert key == name


def test_relpos_tf32_counters_are_registered_and_reset():
    """Both new counters exist beside the FMA kernels' and reset with the
    rest."""
    for key in _COUNTERS + ("flash_attention_relpos", "window_attention_relpos"):
        assert key in dispatch.launch_counts
        dispatch.launch_counts[key] += 3
    dispatch.reset_launch_counts()
    assert all(n == 0 for n in dispatch.launch_counts.values())


@pytest.mark.parametrize("bh,s,want", [
    (64, 4096, 4 * 64 * 4096 * 80), (16, 4096, 4 * 16 * 4096 * 80),
    (64, 3072, 4 * 64 * 3072 * 80), (1, 64, 4 * 64 * 80), (3, 320, 4 * 3 * 320 * 80)])
def test_relpos_tf32_scratch_holds_every_tiles_images(bh, s, want):
    """K4's scratch at head dim 80: the K hi, K lo, V^T hi and V^T lo images
    of every 64-key tile of every head, 4 BH S 80 floats (S = 64 kh is whole
    tiles)."""
    assert tfa.relpos_tf32_scratch_floats(bh, s, 80) == want


@pytest.mark.parametrize("bh,s,d,want", [
    (64, 2048, 64, 4 * 64 * 2048 * 64), (64, 3072, 80, 4 * 64 * 3072 * 80),
    (2, 8, 80, 4 * 2 * 64 * 80), (3, 120, 64, 4 * 3 * 128 * 64), (2, 3584, 80, 4 * 2 * 3584 * 80),
    (1, 2 * 40, 80, 4 * 128 * 80), (2, 8, 96, 4 * 2 * 64 * 96), (3, 120, 96, 4 * 3 * 128 * 96)])
def test_relpos_tf32_scratch_pads_a_narrow_grids_last_tile(bh, s, d, want):
    """The narrow mode's scratch: the images of every 64-key tile, the last
    padded with zero keys, 4 BH Sp D floats with Sp = S rounded up to 64."""
    assert tfa.relpos_tf32_scratch_floats(bh, s, d) == want


@pytest.mark.parametrize("bh,s,d", [(64, 4096, 64), (16, 4096, 64), (1, 64, 64), (3, 320, 64),
                                    (64, 4096, 80), (64, 4096, 96), (1, 64, 96), (64, 2048, 96)])
def test_relpos_tf32_scratch_follows_the_head_dim(bh, s, d):
    """K4's scratch holds four images of 64 keys by D for every tile: 4 BH S
    D floats at head dim 64 and 96 as at 80."""
    assert tfa.relpos_tf32_scratch_floats(bh, s, d) == 4 * bh * s * d


@pytest.mark.parametrize("d,k_stages,v_stages,table_ld", [(64, 2, 1, 72), (80, 1, 1, 72),
                                                          (96, 1, 1, 64)])
def test_k4_tf32_shared_memory_fits_a_block(d, k_stages, v_stages, table_ld):
    """K4Cfg's shared memory at each head dim: both consumers' Q hi and lo
    images (2 x 2 x 64 x D floats), the K and V^T stages (hi and lo of 64
    keys by D), the 128 rows of the bias_w table, the barriers (eight
    64-bit words) and the 1024-byte alignment fit the 232 448 bytes a block
    may have. At head dim 96 the table's 72-float rows would not: it is 64
    floats a row there (its 8-column groups swizzled), which still holds
    the narrow mode's widest row (kw 56 at a stride of 56). At 64, 80 and 96
    a second V stage (or, at 80 and 96, a second K stage) would not fit."""
    img = 64 * d * 4
    smem = lambda ks, vs, ld: 2 * 2 * img + 2 * (ks + vs) * img + 128 * ld * 4 + 64 + 1024
    assert smem(k_stages, v_stages, table_ld) <= 232_448
    assert smem(k_stages, v_stages + 1, table_ld) > 232_448
    assert d == 64 or smem(k_stages + 1, v_stages, table_ld) > 232_448
    assert d != 96 or smem(k_stages, v_stages, 72) > 232_448
    narrow_ld = lambda kw: kw + 8 if kw % 16 == 0 else kw
    assert max(narrow_ld(kw) for kw in range(8, 64, 8)) <= table_ld
    # the swizzled table: row r's 8-column groups at j ^ (r % 8); the 8 rows
    # of a warp's 8-byte reads of group j (8 floats a row) fill each of the
    # 32 banks exactly twice, the least two wavefronts can do (unswizzled,
    # 64-float rows would put all 8 rows in the same 8 banks)
    for j in range(64 // 8 if d == 96 else 0):
        banks = [(r * 64 + 8 * (j ^ r) + c) % 32 for r in range(8) for c in range(8)]
        assert all(banks.count(b) == 2 for b in range(32))
        flat = [(r * 64 + 8 * j + c) % 32 for r in range(8) for c in range(8)]
        assert max(flat.count(b) for b in range(32)) == 8


# --------------------------------------------------------------- schedule
@pytest.mark.parametrize("kind,n,s,sms", [
    (0, 64, 4096, 132), (0, 16, 4096, 132), (0, 64, 3072, 132), (0, 3, 320, 132),
    (0, 2, 64, 132), (1, 1600, 196, 132), (1, 400, 196, 132), (1, 3, 196, 132),
    (1, 133, 196, 132), (1, 66, 196, 132), (1, 7, 196, 4)])
def test_relpos_tf32_schedule_covers_each_row_once(kind, n, s, sms):
    """K4's grid (ceil(S / 128), BH) and K5's persistent grid of min(2 G,
    SMs) blocks walking (window, round) items put every (head or window,
    row) in exactly one consumer warpgroup's 64 rows."""
    grid, tiles = tfa.relpos_tf32_schedule(kind, n, s, sms)
    if kind == 0:
        assert grid == (-(-s // 128), n)
    else:
        assert grid == (min(2 * n, sms),)
    seen = np.zeros((n, s), np.int64)
    for rows in tiles.values():
        for h, r0 in rows:
            seen[h, r0:min(r0 + 64, s)] += 1
    assert (seen == 1).all()


# ---------------------------------------------------- the fragment arithmetic
@pytest.mark.parametrize("kind,tile", [(0, 0), (0, 1), (0, 63), (1, 0), (1, 2), (1, 4)])
def test_relpos_tf32_fragment_covers_each_score_once(kind, tile):
    """The 128 lanes of a warpgroup hold each (row, key) of the m64n64 tile
    (K4) or the m64n40 tile (K5) of key tile ``tile`` exactly once."""
    n = 64 if kind == 0 else 40
    seen = {}
    for warp in range(4):
        for lane in range(32):
            regs = tfa.relpos_tf32_fragment(kind, warp, lane, tile)
            assert [r[0] for r in regs] == list(range(n // 2))
            for _i, row, key, *_ in regs:
                seen[(row, key)] = seen.get((row, key), 0) + 1
    assert seen == {(r, n * tile + c): 1 for r in range(64) for c in range(n)}


@pytest.mark.parametrize("kind,rows,cols", [(0, 64, 64), (0, 48, 64), (0, 5, 64), (1, 14, 14),
                                            (0, 64, 32), (0, 64, 48), (0, 7, 24), (0, 3, 8),
                                            (0, 2, 56), (0, 5, 40), (0, 1, 16)])
def test_relpos_tf32_fragment_gathers_relpos_bias(kind, rows, cols):
    """The factors gathered through the fragment arithmetic (bias_h at (row,
    ky) plus bias_w at (row, kx), in f32) equal ``relpos_bias`` at every
    score of every key tile of SAM ViT-H's 64 x 64 and 48 x 64 grids, a
    5 x 64 grid (K4), a 14 x 14 window (K5) and narrow grids (K4's narrow
    mode: 64-key tiles across grid rows, widths that divide 64 and widths
    that do not), for every 64-row slice of the queries; the masked keys are
    exactly those past S in the last tile."""
    s = rows * cols
    gen = torch.Generator().manual_seed(rows)
    bias_h = torch.randn(1, s, rows, generator=gen)
    bias_w = torch.randn(1, s, cols, generator=gen)
    dense = tfa.relpos_bias(bias_h, bias_w, torch.float32)[0]
    fh, fw = bias_h[0], bias_w[0]
    n = 64 if kind == 0 else 40
    q0s = torch.arange(0, s - s % 64, 64)
    masked = 0
    for t in range(-(-s // n)):
        regs = [r for warp in range(4) for lane in range(32)
                for r in tfa.relpos_tf32_fragment(kind, warp, lane, t, s, cols)]
        masked += sum(r[3] is None for r in regs)
        assert all(r[2] >= s for r in regs if r[3] is None)
        row, key, ky, kx = (torch.tensor([r[i] for r in regs if r[3] is not None])
                            for i in range(1, 5))
        q = q0s[:, None] + row
        got = fh[q, ky] + fw[q, kx]
        assert torch.equal(got, dense[q, key.expand_as(q)])
    assert masked == 64 * (-(-s // n) * n - s)


# -------------------------------------------------------------- arithmetic
@pytest.mark.parametrize("kind,g,rows,cols,spread,bias_scale", [
    (0, 2, 3, 64, 1.0, 0.5),  # K4: three grid rows, a ragged last query block
    (0, 2, 4, 64, 3.0, 0.5),  # sharp rows, many raised maxima
    (0, 1, 1, 64, 1.0, 0.5),  # one grid row, one key tile
    (0, 2, 2, 64, 0.25, 3.0),  # a flat score, large factors
    (1, 3, 14, 14, 1.0, 0.5),  # K5: three windows
    (1, 2, 14, 14, 3.0, 0.5),
    (1, 2, 14, 14, 0.25, 3.0)])
def test_relpos_tf32_mirror_matches_plain(kind, g, rows, cols, spread, bias_scale):
    """The kernels' arithmetic against the plain versions within 1e-4, over
    score and factor scales."""
    q, k, v, bias_h, bias_w = _inputs(g * rows + cols, g, rows, cols, spread=spread,
                                      bias_scale=bias_scale)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, kind)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("g,rows,spread,bias_scale", [
    (2, 3, 1.0, 0.5),  # three grid rows, a ragged last query block
    (2, 4, 3.0, 0.5),  # sharp rows
    (1, 1, 1.0, 0.5),  # one grid row
    (2, 2, 0.25, 3.0)])  # a flat score, large factors
def test_k4_tf32_mirror_matches_plain_at_head_dim_64(g, rows, spread, bias_scale):
    """K4's arithmetic at SAM ViT-L's head dim 64 against the plain version
    within 1e-4."""
    q, k, v, bias_h, bias_w = _inputs(g * rows + 64, g, rows, 64, d=64, spread=spread,
                                      bias_scale=bias_scale)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 64)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("d,g,rows,cols,spread,bias_scale", [
    (80, 2, 3, 32, 1.0, 0.5),  # a 32-wide grid: two grid rows a tile
    (64, 2, 5, 48, 3.0, 0.5),  # kw 48: tiles straddle grid rows, sharp rows
    (80, 1, 7, 16, 1.0, 0.5),  # kw 16, a padded last tile
    (64, 2, 2, 8, 0.25, 3.0),  # the narrowest grid, one padded tile, large factors
    (80, 2, 5, 40, 1.0, 0.5),
    (64, 1, 3, 56, 1.0, 0.5)])
def test_k4_tf32_narrow_mirror_matches_plain(d, g, rows, cols, spread, bias_scale):
    """K4's narrow mode (grids narrower than 64) against the plain version
    within 1e-4, at head dims 64 and 80, over widths, score and factor
    scales."""
    q, k, v, bias_h, bias_w = _inputs(g * rows + cols + d, g, rows, cols, d=d, spread=spread,
                                      bias_scale=bias_scale)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("g,rows,cols,spread,bias_scale", [
    (2, 3, 64, 1.0, 0.5),  # the wide mode, a ragged last query block
    (2, 4, 64, 3.0, 0.5),  # sharp rows
    (2, 2, 64, 1.0, 3.0),  # large factors
    (2, 3, 32, 1.0, 0.5),  # the narrow mode: two grid rows a tile
    (2, 5, 48, 3.0, 0.5),  # kw 48: tiles straddle grid rows, sharp rows
    (2, 4, 32, 1.0, 3.0),  # large factors on the narrow mode
    (2, 2, 8, 1.0, 0.5),  # the narrowest grid, one padded tile
    (1, 3, 56, 1.0, 0.5)])
def test_k4_tf32_d96_mirror_matches_plain(g, rows, cols, spread, bias_scale):
    """K4 at head dim 96 in both modes (the fold in two 48-column halves)
    against the plain version within 1e-4, over widths, score and factor
    scales."""
    q, k, v, bias_h, bias_w = _inputs(g * rows + cols + 96, g, rows, cols, d=96, spread=spread,
                                      bias_scale=bias_scale)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("kind,rows,cols", [(0, 4, 64), (1, 14, 14)])
def test_relpos_tf32_mirror_beats_one_tf32_product(kind, rows, cols):
    """What the split buys: one TF32 product (hi only) misses 1e-4 where the
    three products hold it."""
    q, k, v, bias_h, bias_w = _inputs(7, 2, rows, cols, spread=2.0)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    one = tfa.attend_relpos_plain(tfa.tf32_round(q), tfa.tf32_round(k), tfa.tf32_round(v),
                                  bias_h, bias_w, cols)
    assert float((one - want).abs().max()) > TOL
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, kind)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("g,rows,spread", [(2, 4, 1.0), (1, 4, 3.0)])
def test_k4_tf32_mirror_matches_attend_relpos(jx, g, rows, spread):
    """K4: the mirror against the JAX ``attend_relpos`` in interpret mode in
    f32 at head dim 80 on a 4 x 64 grid, within 1e-4, both within 1e-4 of
    the plain version."""
    q, k, v, bias_h, bias_w = _inputs(rows + g, g, rows, 64, spread=spread)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = torch.from_numpy(np.array(jx.fa.attend_relpos(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v, bias_h, bias_w)), 64, interpret=True)))
    plain = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 64)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("g,rows,spread", [(2, 4, 1.0), (1, 4, 3.0), (2, 3, 1.0)])
def test_k4_tf32_d64_mirror_matches_attend_relpos(jx, g, rows, spread):
    """K4 at head dim 64: the mirror against the JAX ``attend_relpos`` in
    interpret mode in f32 (its head dim padded to 128 lanes) within 1e-4,
    at unit scale and on peaked rows, both within 1e-4 of the plain
    version."""
    q, k, v, bias_h, bias_w = _inputs(rows + g + 64, g, rows, 64, d=64, spread=spread)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = torch.from_numpy(np.array(jx.fa.attend_relpos(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v, bias_h, bias_w)), 64, interpret=True)))
    plain = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 64)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("d,g,rows,cols,spread", [
    (80, 2, 8, 32, 1.0), (64, 1, 8, 32, 3.0),  # 8 x 32: 256 tokens, the JAX kernel's grid
    (80, 2, 16, 16, 1.0), (64, 1, 16, 16, 3.0)])
def test_k4_tf32_narrow_mirror_matches_attend_relpos(jx, d, g, rows, cols, spread):
    """The narrow mode against the JAX ``attend_relpos`` in interpret mode in
    f32 on grids its routing admits (``relpos_shapes_ok``: kw 32 and 16),
    with the factors SAM builds (``_rel_pos_factors`` of the JAX package),
    within 1e-4, both within 1e-4 of the plain version."""
    assert tfa.relpos_shapes_ok(rows, cols)
    q, k, v, bias_h, bias_w = _sam_factors(jx, rows, cols, g, d, spread)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = torch.from_numpy(np.array(jx.fa.attend_relpos(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v, bias_h, bias_w)), cols, interpret=True)))
    plain = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("rows,cols,g,spread,bias_scale", [
    (4, 64, 2, 1.0, None), (4, 64, 1, 3.0, None),  # the wide mode, SAM's factors
    (4, 64, 1, 1.0, 3.0),  # large factors
    (8, 32, 2, 1.0, None), (8, 32, 1, 3.0, None),  # the narrow mode, SAM's factors
    (8, 32, 1, 1.0, 3.0)])
def test_k4_tf32_d96_mirror_matches_attend_relpos(jx, rows, cols, g, spread, bias_scale):
    """K4 at head dim 96 in both modes against the JAX ``attend_relpos`` in
    interpret mode in f32 (its head dim padded to 128 lanes), on the factors
    SAM builds (``bias_scale`` None) or on seeded factors of that standard
    deviation, unit scores and peaked rows: within 1e-4, both within 1e-4 of
    the plain version."""
    assert tfa.relpos_shapes_ok(rows, cols)
    if bias_scale is None:
        q, k, v, bias_h, bias_w = _sam_factors(jx, rows, cols, g, 96, spread)
    else:
        q, k, v, bias_h, bias_w = _inputs(rows + cols + g, g, rows, cols, d=96, spread=spread,
                                          bias_scale=bias_scale)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = torch.from_numpy(np.array(jx.fa.attend_relpos(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v, bias_h, bias_w)), cols, interpret=True)))
    plain = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("d,g,rows,cols,spread", [
    (80, 2, 6, 48, 1.0), (64, 1, 6, 48, 3.0),  # kw 48: the JAX kernel never takes it
    (80, 1, 5, 32, 1.0),  # 160 tokens: below the JAX kernel's 256
    (64, 2, 3, 24, 1.0)])
def test_k4_tf32_narrow_mirror_matches_sam_xla_attention(jx, d, g, rows, cols, spread):
    """Where ``relpos_shapes_ok`` refuses the grid (kw 48, or fewer than 256
    tokens), the JAX package runs SAM's attention as XLA: the dense bias
    ``_rel_pos_bias`` added to the scaled logits, an f32 softmax and P V.
    The narrow mode's mirror against that expression within 1e-4, both
    within 1e-4 of the plain version."""
    jnp = jx.jnp
    q, k, v, bias_h, bias_w = _sam_factors(jx, rows, cols, g, d, spread)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    rel_h, rel_w = _rel_tables(rows, cols, d)
    bias = jx.sam._rel_pos_bias((rows, cols), (rows, cols), jnp.asarray(rel_h),
                                jnp.asarray(rel_w), jq)
    logits = jnp.einsum("bqd,bkd->bqk", jq * d ** -0.5, jk) + bias
    want = torch.from_numpy(np.array(jnp.einsum(
        "bqk,bkd->bqd", jx.jax.nn.softmax(logits.astype(jnp.float32), axis=-1), jv)))
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    plain = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("g,spread", [(3, 1.0), (2, 3.0)])
def test_k5_tf32_mirror_matches_window_attention_relpos(jx, g, spread):
    """K5: the mirror against the JAX ``window_attention_relpos`` in
    interpret mode in f32 at head dim 80 over 14 x 14 windows, within 1e-4,
    both within 1e-4 of the plain version."""
    q, k, v, bias_h, bias_w = _inputs(14 + g, g, 14, 14, spread=spread)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 1)
    want = torch.from_numpy(np.array(jx.wa.window_attention_relpos(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v, bias_h, bias_w)), 14, 14,
        interpret=True)))
    plain = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, 14, 14)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


def test_relpos_tf32_wrappers_on_cpu_take_the_plain_versions():
    """On CPU tensors both wrappers are the plain versions at the shapes the
    3xTF32 route takes, and move no counter."""
    q, k, v, bias_h, bias_w = _inputs(3, 2, 2, 64)
    wq, wk, wv, wh, ww = _inputs(4, 2, 14, 14)
    lq, lk, lv, lh, lw = _inputs(5, 2, 2, 64, d=64)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, 64)
    got_w = twa.window_attention_relpos(wq, wk, wv, wh, ww, 14, 14)
    got_l = tfa.attend_relpos(lq, lk, lv, lh, lw, 64)
    assert dispatch.launch_counts == before
    assert torch.equal(got, tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 64))
    assert torch.equal(got_l, tfa.attend_relpos_plain(lq, lk, lv, lh, lw, 64))
    assert torch.equal(got_w, twa.window_attention_relpos_plain(wq, wk, wv, wh, ww, 14, 14))


# -------------------------------------------------------------- on the card
def _moved(before):
    return [k for k, n in dispatch.launch_counts.items() if n != before[k]]


def _card_inputs(dev, g, rows, cols, d=80, scale=0.1, spread=1.0):
    """q, k, v from a seeded generator; the factors as SAM builds them, q .
    R products of rel-pos tables at ``scale`` (``sam._rel_pos_factors``)."""
    from beyondff_tpu_torch.models import sam as sam_mod

    gen = torch.Generator(device=dev).manual_seed(g * rows * cols + d)
    q, k, v = (torch.randn(g, rows * cols, d, device=dev, generator=gen) for _ in range(3))
    q, k = q * spread, k * spread
    rel_h = scale * torch.randn(2 * rows - 1, d, device=dev, generator=gen)
    rel_w = scale * torch.randn(2 * cols - 1, d, device=dev, generator=gen)
    bias_h, bias_w = sam_mod._rel_pos_factors((rows, cols), (rows, cols), rel_h, rel_w, q)
    return q, k, v, bias_h.contiguous(), bias_w.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows,scale,spread", [
    (64, 64, 0.1, 1.0), (16, 64, 0.1, 1.0), (64, 48, 0.1, 1.0),  # SAM ViT-H: B 4, B 1, rect
    (2, 64, 3.0, 1.0), (2, 64, 0.1, 3.0),  # peaked by the factors, by the scores
    (2, 64, 0.1, 0.25),  # a flat softmax
    (3, 5, 0.1, 1.0), (2, 1, 0.1, 1.0), (1, 63, 0.1, 1.0)])  # odd kh: a ragged query block
def test_k4_tf32_matches_plain_on_card(cuda_device, g, rows, scale, spread):
    """K4's 3xTF32 kernel against the plain version within 1e-4 over SAM
    ViT-H's shapes, score and factor scales and odd grid heights, one launch
    counted as ``flash_attention_relpos_tf32`` only."""
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, g, rows, 64, scale=scale, spread=spread)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, 64)
    assert _moved(before) == ["flash_attention_relpos_tf32"]
    assert dispatch.launch_counts["flash_attention_relpos_tf32"] == (
        before["flash_attention_relpos_tf32"] + 1)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 64)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows,scale,spread", [
    (64, 64, 0.1, 1.0), (16, 64, 0.1, 1.0),  # SAM ViT-L's global blocks: B 4, B 1
    (64, 64, 0.1, 3.0), (2, 64, 3.0, 1.0), (2, 64, 0.1, 0.25),  # peaked, flat
    (3, 5, 0.1, 1.0), (2, 1, 0.1, 1.0), (1, 63, 0.1, 1.0)])  # odd kh: a ragged query block
def test_k4_tf32_d64_matches_plain_on_card(cuda_device, g, rows, scale, spread):
    """K4's 3xTF32 kernel at head dim 64 (two K stages and one V stage)
    against the plain version within 1e-4, one launch
    counted as ``flash_attention_relpos_tf32`` only."""
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, g, rows, 64, d=64, scale=scale,
                                           spread=spread)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, 64)
    assert _moved(before) == ["flash_attention_relpos_tf32"]
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 64)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,rows,cols,scale,spread", [
    (64, 64, 64, 32, 0.1, 1.0), (80, 64, 64, 32, 0.1, 1.0),  # 2:1 portrait, batch of 4
    (64, 64, 64, 48, 0.1, 1.0), (80, 64, 64, 48, 0.1, 1.0),  # 4:3 portrait, batch of 4
    (80, 16, 64, 32, 0.1, 3.0), (64, 2, 64, 48, 3.0, 1.0),  # peaked by the scores, the factors
    (80, 2, 64, 16, 0.1, 0.25),  # a flat softmax, kw 16
    (80, 2, 1, 8, 0.1, 1.0), (64, 3, 3, 8, 0.1, 1.0),  # the narrowest grids: one tile
    (80, 3, 7, 24, 0.1, 1.0), (64, 2, 5, 40, 0.1, 1.0),  # tiles straddle grid rows
    (80, 4, 64, 56, 0.1, 1.0), (80, 1, 63, 32, 0.1, 1.0)])  # the widest; a ragged query block
def test_k4_tf32_narrow_matches_plain_on_card(cuda_device, d, g, rows, cols, scale, spread):
    """K4's narrow mode (grids narrower than 64) against the plain version
    within 1e-4 over portrait grids at the batch of 4, widths from 8 to 56,
    score and factor scales, one launch counted as
    ``flash_attention_relpos_tf32`` only."""
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, g, rows, cols, d=d, scale=scale,
                                           spread=spread)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert _moved(before) == ["flash_attention_relpos_tf32"]
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows,cols,scale,spread", [
    (64, 64, 32, 0.1, 1.0), (64, 64, 48, 0.1, 1.0),  # portrait grids at the batch of 4
    (64, 64, 64, 0.1, 1.0), (16, 64, 64, 0.1, 1.0),  # the wide mode: 64 x 64
    (16, 64, 32, 0.1, 3.0), (16, 64, 32, 3.0, 1.0),  # peaked by the scores, the factors
    (16, 64, 64, 0.1, 3.0), (16, 64, 64, 3.0, 1.0),
    (2, 64, 16, 0.1, 0.25), (2, 1, 8, 0.1, 1.0),  # a flat softmax; one tile of kw 8
    (3, 7, 24, 0.1, 1.0), (4, 64, 56, 0.1, 1.0),  # tiles straddle grid rows; the widest
    (3, 5, 64, 0.1, 1.0), (2, 1, 64, 0.1, 1.0),  # odd kh, one grid row
    (1, 63, 32, 0.1, 1.0)])  # a ragged query block
def test_k4_tf32_d96_matches_plain_on_card(cuda_device, g, rows, cols, scale, spread):
    """K4's 3xTF32 kernel at head dim 96 (the swizzled bias_w table at kw =
    64, the fold in two 48-column halves) against the plain version within
    1e-4 over both modes, widths from 8 to 64, score and factor scales and
    odd grid heights, one launch counted as ``flash_attention_relpos_tf32``
    only."""
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, g, rows, cols, d=96, scale=scale,
                                           spread=spread)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert _moved(before) == ["flash_attention_relpos_tf32"]
    assert dispatch.launch_counts["flash_attention_relpos_tf32"] == (
        before["flash_attention_relpos_tf32"] + 1)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [32, 64])
def test_k4_fma_yardstick_entry_matches_plain_on_card(cuda_device, cols):
    """``bff_flash_attention_relpos_f32_fma``, K4's FMA kernel that the
    measurements time beside the 3xTF32 one on the same call, computes the
    same function within 1e-4 and moves no counter."""
    from beyondff_tpu_torch.kernels import _build

    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, 2, 8, cols)
    out = torch.empty_like(q)
    before = dict(dispatch.launch_counts)
    rc = _build.library().bff_flash_attention_relpos_f32_fma(
        *(t.data_ptr() for t in (q, k, v, bias_h, bias_w, out)), 2, 8 * cols, 80, 8, cols,
        _S80, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0 and dispatch.launch_counts == before
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert float((out - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("g,scale,spread", [
    (1600, 0.1, 1.0), (400, 0.1, 1.0), (1, 0.1, 1.0), (3, 3.0, 1.0), (3, 0.1, 3.0),
    (133, 0.1, 1.0), (265, 0.1, 1.0)])
def test_k5_tf32_matches_plain_on_card(cuda_device, g, scale, spread):
    """K5's 3xTF32 kernel against the plain version within 1e-4: SAM
    ViT-H's windows at the batch of 4 and at one frame, one window, peaked
    softmaxes, and window counts that leave some blocks of the persistent
    grid an item more than others; counted as
    ``window_attention_relpos_tf32`` only."""
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, g, 14, 14, scale=scale, spread=spread)
    before = dict(dispatch.launch_counts)
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, 14, 14)
    assert _moved(before) == ["window_attention_relpos_tf32"]
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, 14, 14)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d72", "kw36_d136", "kw36_d40", "kw4_d16", "kw36_d120",
                                  "misaligned", "window_d64", "window_16"])
def test_other_f32_relpos_calls_keep_the_fma_kernels_on_card(cuda_device, case):
    """f32 calls outside the predicates (head dim 72 on a 64-wide grid, a
    36-wide grid 65 rows tall at head dims 136, 40 and 120 and a 4-wide one
    at 16 (at the multiples of 16 from 32 to 128 the straddling mode takes
    these grids at any height), an input off 16 bytes, head-dim-64 and 16 x 16 windows) stay
    on the FMA kernels, counted as ``flash_attention_relpos`` or
    ``window_attention_relpos``, within 1e-4."""
    window = case.startswith("window")
    rows, cols = ((16, 16) if case == "window_16" else (14, 14)) if window else (
        (65, 36) if case.startswith("kw36") else (65, 4) if case == "kw4_d16" else (16, 64))
    d = {"d72": 72, "kw36_d136": 136, "kw36_d120": 120, "kw36_d40": 40, "kw4_d16": 16,
         "window_d64": 64}.get(case, 80)
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, 3, rows, cols, d=d)
    if case == "misaligned":
        buf = torch.empty(q.numel() + 1, device=cuda_device)
        q = buf[1:].view(q.shape).copy_(q)  # 4 bytes past an aligned base
    before = dict(dispatch.launch_counts)
    if window:
        got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, rows, cols)
        want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, rows, cols)
    else:
        got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
        want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert _moved(before) == ["window_attention_relpos" if window else "flash_attention_relpos"]
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_relpos_tf32_route_and_scratch_match_the_c_side_on_card(cuda_device):
    """``relpos_tf32_route`` says what ``bff_relpos_tf32_takes`` says over the
    kinds, dtypes, head dims, grids, scales and alignments around the
    predicate's edges, and ``relpos_tf32_scratch_floats`` what
    ``bff_relpos_tf32_scratch_floats`` says."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    grids = ((64, 64), (48, 64), (1, 64), (5, 64), (65, 64), (0, 64), (64, 32), (14, 14),
             (16, 16), (7, 28), (64, 48), (1, 8), (64, 56), (64, 36), (64, 4), (65, 32),
             (3, 24), (64, 72))
    for kind in (0, 1, 2):
        for dtype in (0, 1):
            for d in (64, 80, 96, 112, 128):
                for rows, cols in grids:
                    for s in (rows * cols, rows * cols - 1):
                        for scale in (d ** -0.5, 0.0, -1.0, float("inf"), 1e39):
                            for slot, off in ((0, 0), (1, 8), (3, 4), (4, 4), (5, 16)):
                                ptrs = [4096 * (i + 1) for i in range(6)]
                                ptrs[slot] += off
                                want = tfa.relpos_tf32_route(kind, dtype, d, s, rows, cols,
                                                             scale, *ptrs)
                                got = lib.bff_relpos_tf32_takes(kind, dtype, d, s, rows, cols,
                                                                ctypes.c_float(scale), *ptrs)
                                assert bool(got) is want, (kind, dtype, d, s, rows, cols,
                                                           scale, slot, off)
    for bh, s in ((64, 4096), (16, 3072), (1, 64), (3, 320), (64, 2048), (2, 8), (3, 120)):
        for d in (64, 80, 96):
            assert lib.bff_relpos_tf32_scratch_floats(bh, s, d) == (
                tfa.relpos_tf32_scratch_floats(bh, s, d))


@pytest.mark.cuda
def test_k4_tf32_entry_refuses_a_missing_scratch_on_card(cuda_device):
    """A K4 call the predicate takes with no scratch returns -1 and launches
    nothing: the kernel needs its split keys and never falls back."""
    from beyondff_tpu_torch.kernels import _build

    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, 2, 2, 64)
    out = torch.empty_like(q)
    rc = _build.library().bff_flash_attention_relpos(
        0, *(t.data_ptr() for t in (q, k, v, bias_h, bias_w, out)), 2, 128, 80, 2, 64,
        ctypes.c_float(_S80), torch.cuda.current_stream().cuda_stream, None)
    assert rc == -1


@pytest.mark.cuda
@pytest.mark.parametrize("window,d", [pytest.param(False, 80, id="False"),
                                      pytest.param(True, 80, id="True"),
                                      pytest.param(False, 96, id="d96")])
def test_relpos_tf32_raises_on_a_failed_launch_on_card(cuda_device, monkeypatch, window, d):
    """A code from the C entry raises, naming the route; nothing falls back
    and nothing is counted (K4 at head dims 80 and 96, K5)."""
    from beyondff_tpu_torch.kernels import _build

    rows, cols = (14, 14) if window else (2, 64)
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, 2, rows, cols, d=d)

    class Failing:
        def __getattr__(self, name):
            return lambda *a: -1000 - 1

    monkeypatch.setattr(_build, "library", lambda: Failing())
    before = dict(dispatch.launch_counts)
    with pytest.raises(RuntimeError, match=_COUNTERS[int(window)]):
        if window:
            twa.window_attention_relpos(q, k, v, bias_h, bias_w, rows, cols)
        else:
            tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert dispatch.launch_counts == before


@pytest.mark.parametrize("name", ["relpos_f32_fma", "k4_tf32_overlap", "k5_tf32_overlap",
                                  "k5_tf32_prefetch", "relpos_tf32_no_pingpong",
                                  "relpos_tf32_no_fold", "k4_tf32_d64_stages_1_1",
                                  "k4_tf32_d96_no_fold", "k4_tf32_d96_fold_whole",
                                  "k4_tf32_d96_bias_start", "k4_tf32_bw_from_l2"])
def test_relpos_tf32_variant_edits_match_the_sources(name):
    """Each of ``tools/kernel_variants.py``'s variants of the f32 rel-pos
    routes is a set of edits that must each match its source once; they
    build the six sources the rel-pos entries route between."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    sources, edits = kv.VARIANTS[name]
    assert set(sources) == {"relpos_attention.cu", "relpos_attention_wgmma.cu",
                            "relpos_attention_streamed.cu", "relpos_attention_tf32.cu",
                            "relpos_attention_wide_wgmma.cu",
                            "relpos_attention_wide_tf32.cu"} and edits
    for fname, old, new in edits:
        with open(os.path.join(_build.CSRC, fname)) as f:
            assert f.read().count(old) == 1, (fname, old)
        assert new != old
