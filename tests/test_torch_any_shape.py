"""The shapes the JAX kernels take past the port's old limits, and K4 in f32
on grids whose width is not a multiple of 8.

The JAX functions take any head dim (``attend`` and ``attend_relpos`` pad it
to 128 lanes), any rel-pos grid (the factor block is (bq, kh + kw)), any
window (padded to 128 lanes) and any number of levels (one level a call).
The port runs each of these shapes on a hand-written kernel: head dims past
128 on a grid axis over 128-feature output slices (``head_dim_slices``,
``sliced_mirror``), K4 grids with kh + kw past 256 on the FMA kernel reading
the factors from device memory (``relpos_factor_table``), K5 windows past
256 tokens or head dim 128 on K4's kernels (``window_on_flash``), K1 head
dims past 128 on 128-channel slices (``channel_slices``) and more than 8
levels with the level table in device memory (``device_levels``). K4 in f32
at head dims 64, 80 and 96 on grids narrower than 64 whose width is no
multiple of 8 takes the 3xTF32 kernel's straddling mode
(``relpos_tf32_mode``), each score's whole bias added in f32 after the
products.

On the CPU: the plain versions at the new shapes against the JAX functions
run as the JAX tests run them (``interpret=True``), the mirrors of the new
schedules against the plain versions, and the route tables (every old shape
keeps its counter). The ``cuda`` cases hold each new route on the card
against its plain version and its counter, and import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_any_shape.py``.
Tolerances: f32 1e-4, bf16 ``flash_attention.bf16_error_bound``, K1 3e-2 in
bf16.
"""

import ctypes

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.kernels import deform_window as tdw
from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels import flash_attention as tfa
from beyondff_tpu_torch.kernels import window_attention as twa

torch.set_num_threads(2)

TOL = 1e-4  # f32 attention against its plain version
K1_BF16_TOL = 3e-2
_A = (0, 256, 512, 1024, 2048, 4096)  # six 16-byte aligned pointers


@pytest.fixture
def jx():
    import types

    pytest.importorskip("jax")
    import jax.numpy as jnp

    from beyondff_tpu.kernels import deform_window as jdw
    from beyondff_tpu.kernels import flash_attention as jfa
    from beyondff_tpu.kernels import window_attention as jwa
    from beyondff_tpu.models.gdino import deformable as jdeform

    return types.SimpleNamespace(jnp=jnp, fa=jfa, wa=jwa, dw=jdw, deform=jdeform)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_any_shape.py")
    return torch.device("cuda")


def _qkv(seed, shape, spread=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    return q * spread, k * spread, v


def _factors(seed, g, rows, cols, scale=0.5):
    rng = np.random.default_rng(seed + 1)
    s = rows * cols
    return ((rng.standard_normal((g, s, rows)) * scale).astype(np.float32),
            (rng.standard_normal((g, s, cols)) * scale).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ----------------------------------------- the plain versions against JAX
@pytest.mark.parametrize("d,s", [(160, 256), (160, 300), (256, 256), (256, 300)])
def test_attend_plain_matches_jax_past_head_dim_128(jx, d, s):
    """``attend`` at head dims 160 and 256 (the JAX wrapper pads them to 256
    lanes), S 256 (``flash_attention``) and S 300 (padded to 512 with the
    keys past 300 masked, ``_flash_masked``): the port's CPU path within
    1e-4 in f32."""
    q, k, v = _qkv(d + s, (2, s, d))
    want = np.asarray(jx.fa.attend(*map(jx.jnp.asarray, (q, k, v)), interpret=True))
    got = tfa.attend(*_t(q, k, v)).numpy()
    assert float(np.abs(got - want).max()) <= TOL


def test_attend_bf16_plain_within_bound_of_jax_past_head_dim_128(jx):
    """bf16 at head dim 160 with masked keys: the JAX kernel (P rounded to
    bf16 before P V) within ``bf16_error_bound`` of the port's plain version
    of the same bf16 inputs."""
    q, k, v = (t.bfloat16() for t in _t(*_qkv(7, (2, 300, 160))))
    want = tfa.flash_attention_plain(q, k, v)
    jq, jk, jv = (jx.jnp.asarray(t.float().numpy()).astype(jx.jnp.bfloat16) for t in (q, k, v))
    got = torch.from_numpy(np.array(jx.fa.attend(jq, jk, jv, interpret=True)
                                      .astype(jx.jnp.float32)))
    bound = tfa.bf16_error_bound(q, k, v, want)
    assert float(((got - want.float()).abs() - bound).max()) <= 0.0


@pytest.mark.parametrize("rows,cols,d", [(16, 16, 160), (1, 300, 32), (2, 255, 32)])
def test_attend_relpos_plain_matches_jax_past_the_limits(jx, rows, cols, d):
    """``attend_relpos`` at head dim 160 on a 16 x 16 grid and with kh + kw
    past 256 (1 x 300, 2 x 255): the port's CPU path against the JAX
    function in interpret mode within 1e-4."""
    q, k, v = _qkv(rows * cols + d, (2, rows * cols, d))
    bias_h, bias_w = _factors(d, 2, rows, cols)
    want = np.asarray(jx.fa.attend_relpos(*map(jx.jnp.asarray, (q, k, v, bias_h, bias_w)),
                                          cols, interpret=True))
    got = tfa.attend_relpos(*_t(q, k, v, bias_h, bias_w), cols).numpy()
    assert float(np.abs(got - want).max()) <= TOL


@pytest.mark.parametrize("d", [32, 160])
def test_window_relpos_plain_matches_jax_past_256_tokens(jx, d):
    """``window_attention_relpos`` on 17 x 17 windows (289 tokens) at head
    dims 32 and 160: the port's CPU path against the JAX kernel in interpret
    mode within 1e-4."""
    q, k, v = _qkv(289 + d, (3, 289, d))
    bias_h, bias_w = _factors(d, 3, 17, 17)
    want = np.asarray(jx.wa.window_attention_relpos(
        *map(jx.jnp.asarray, (q, k, v, bias_h, bias_w)), 17, 17, interpret=True))
    got = twa.window_attention_relpos(*_t(q, k, v, bias_h, bias_w), 17, 17).numpy()
    assert float(np.abs(got - want).max()) <= TOL


# nine levels (the JAX package samples one level a call)
SHAPES9 = ((24, 30), (12, 15), (6, 8), (3, 4), (20, 10), (10, 5), (5, 3), (2, 2), (1, 1))
SHAPES2 = ((20, 30), (10, 15))


def _deform_inputs(seed, shapes, b=1, heads=2, hd=16, p=3, max_off=6.0):
    """value (B, S, heads, hd), locations around the all-level raster's
    centres (offsets up to ``max_off`` cells, a few past the map) and weights,
    as numpy f32."""
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    value = rng.standard_normal((b, s, heads, hd)).astype(np.float32)
    centers = tdw.raster_centers(shapes)
    q = centers.shape[0]
    locs = np.zeros((b, q, heads, len(shapes), p, 2), np.float32)
    for li, (h, w) in enumerate(shapes):
        off = rng.uniform(-max_off, max_off, (b, q, heads, p, 2))
        locs[:, :, :, li, :, 0] = centers[None, :, None, None, 0] + off[..., 0] / w
        locs[:, :, :, li, :, 1] = centers[None, :, None, None, 1] + off[..., 1] / h
    locs[:, ::11] += 1.3  # off the map
    aw = rng.uniform(0.1, 1.0, (b, q, heads, len(shapes), p)).astype(np.float32)
    return value, locs, aw


def _clamp_modes(shapes, tile=4, radius=3):
    return tuple((tile, radius) for _ in shapes)


@pytest.mark.parametrize("shapes,hd,clamp", [(SHAPES9, 16, True), (SHAPES9, 16, False),
                                             (SHAPES2, 160, True), (SHAPES2, 160, False)])
def test_deform_plain_matches_jax_per_level_sum(jx, shapes, hd, clamp):
    """``ms_deform_sample_plain`` at 9 levels and at head dim 160, in clamp
    and exact mode, against the JAX package's per-level sampler summed over
    the levels: ``sample_level_windowed`` in interpret mode (clamp) or
    ``ms_deform_attn``'s exact gather (exact), within 1e-4 in f32."""
    value, locs, aw = _deform_inputs(len(shapes) + hd, shapes, hd=hd)
    b, q, heads = aw.shape[:3]
    if clamp:
        modes = _clamp_modes(shapes)
        want = np.zeros((b, q, heads, hd), np.float32)
        start = 0
        for li, (h, w) in enumerate(shapes):
            gx = locs[:, :, :, li, :, 0] * w - 0.5
            gy = locs[:, :, :, li, :, 1] * h - 0.5
            assign = jx.dw.build_assignment(shapes, li, modes[li][0])
            want += np.asarray(jx.dw.sample_level_windowed(
                *map(jx.jnp.asarray, (value[:, start:start + h * w], gx, gy, aw[:, :, :, li])),
                assign, h, w, radius=modes[li][1], interpret=True)).reshape(want.shape)
            start += h * w
        want = want.reshape(b, q, heads * hd)
    else:
        modes = None
        want = np.asarray(jx.deform.ms_deform_attn(
            jx.jnp.asarray(value), shapes, jx.jnp.asarray(locs), jx.jnp.asarray(aw)))
    got = tdw.ms_deform_sample(*_t(value), shapes, *_t(locs, aw), modes).numpy()
    assert float(np.abs(got - want.reshape(got.shape)).max()) <= TOL
    assert np.abs(want).max() > 0


# ------------------------------------------------------ routes and mirrors
@pytest.mark.parametrize("d,want", [(1, 1), (32, 1), (80, 1), (128, 1), (129, 2), (160, 2),
                                    (256, 2), (257, 3), (1000, 8)])
def test_head_dim_slices(d, want):
    """One 128-feature slice up to head dim 128 (the kernels' old grids), one
    more per 128 features past it."""
    assert tfa.head_dim_slices(d) == want


@pytest.mark.parametrize("bh,s,d,rows", [(2, 300, 160, 64), (1, 256, 256, 64), (3, 70, 300, 128),
                                         (1, 64, 128, 64), (2, 200, 130, 128)])
def test_sliced_schedule_writes_each_output_once(bh, s, d, rows):
    """The sliced grid (ceil(S / rows), BH, slices) puts every (head, row,
    feature) in exactly one block, the last slice narrower where D is no
    multiple of 128."""
    grid, blocks = tfa.sliced_schedule(bh, s, d, rows)
    assert grid == (-(-s // rows), bh, tfa.head_dim_slices(d))
    seen = np.zeros((bh, s, d), np.int64)
    for (_x, h, _z), (rr, cc) in blocks.items():
        for r in rr:
            seen[h, r, list(cc)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("bh,s,valid,d,spread", [
    (2, 300, 300, 160, 1.0), (2, 300, 251, 160, 1.0), (1, 130, 130, 256, 3.0),
    (2, 200, 77, 300, 1.0), (1, 64, 64, 129, 1.0)])
def test_sliced_mirror_matches_flash_plain(bh, s, valid, d, spread):
    """K2/K3 past head dim 128: the column-slice schedule's arithmetic
    (scores summed over the head dim's slices, the online softmax, P V over
    each block's own slice of V) against the plain version within 1e-4, keys
    past ``valid_len`` masked."""
    q, k, v = _t(*_qkv(s + d, (bh, s, d), spread))
    got = tfa.sliced_mirror(q, k, v, valid)
    want = tfa.flash_attention_plain(q, k, v, valid)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("g,rows,cols,d", [(2, 16, 16, 160), (1, 1, 300, 32), (1, 2, 255, 64),
                                           (2, 9, 17, 256)])
def test_sliced_mirror_matches_relpos_plain(g, rows, cols, d):
    """K4 past head dim 128 (and at kh + kw past 256, where the factors come
    from device memory: the same sums): the schedule's arithmetic with the
    rel-pos bias against ``attend_relpos_plain`` within 1e-4, at the FMA
    kernel's 64-row blocks and the tile's 128."""
    q, k, v = _t(*_qkv(rows * cols + d, (g, rows * cols, d)))
    bias_h, bias_w = _t(*_factors(d, g, rows, cols))
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    for block_rows in (64, 128):
        got = tfa.sliced_mirror(q, k, v, bias_h=bias_h, bias_w=bias_w, rows=block_rows)
        assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("kh,kw,table", [(64, 64, True), (16, 16, True), (128, 128, True),
                                         (1, 255, True), (1, 256, False), (2, 255, False),
                                         (1, 300, False), (200, 200, False), (14, 14, True)])
def test_relpos_factor_table_rule(kh, kw, table):
    """The factor table holds kh + kw <= 256 columns; past it the FMA kernel
    reads the factors from device memory."""
    assert tfa.relpos_factor_table(kh, kw) is table


@pytest.mark.parametrize("s,d,flash", [(196, 80, False), (196, 64, False), (256, 128, False),
                                       (20, 16, False), (289, 80, True), (257, 32, True),
                                       (196, 160, True), (256, 129, True)])
def test_window_on_flash_rule(s, d, flash):
    """K5 keeps its own kernels up to 256 tokens and head dim 128; past
    either the window entry runs K4's kernels."""
    assert tfa.window_on_flash(s, d) is flash


# (kind, dtype, d, s, rows, cols): the counter every old shape keeps
_OLD_RELPOS = [
    ((0, 1, 80, 4096, 64, 64), "flash_attention_relpos_wgmma"),
    ((1, 1, 80, 196, 14, 14), "window_attention_relpos_wgmma"),
    ((0, 0, 80, 4096, 64, 64), "flash_attention_relpos_tf32"),
    ((0, 0, 64, 2048, 64, 32), "flash_attention_relpos_tf32"),
    ((0, 0, 96, 3072, 64, 48), "flash_attention_relpos_tf32"),
    ((1, 0, 80, 196, 14, 14), "window_attention_relpos_tf32"),
    ((0, 1, 64, 4096, 64, 64), "flash_attention_relpos"),
    ((1, 1, 64, 196, 14, 14), "window_attention_relpos"),
    ((1, 0, 64, 196, 14, 14), "window_attention_relpos"),
    ((0, 0, 112, 4096, 64, 64), "flash_attention_relpos_tf32"),
    ((0, 0, 80, 8192, 128, 64), "flash_attention_relpos_tf32"),
    ((1, 0, 80, 256, 16, 16), "window_attention_relpos"),
    ((1, 1, 16, 20, 4, 5), "window_attention_relpos"),
]
# and the new shapes' counters
_NEW_RELPOS = [
    ((0, 0, 160, 256, 16, 16), "flash_attention_relpos_wide_tf32"),
    ((0, 1, 160, 256, 16, 16), "flash_attention_relpos_wide_wgmma"),
    ((0, 1, 32, 300, 1, 300), "flash_attention_relpos_streamed"),
    ((0, 1, 64, 510, 2, 255), "flash_attention_relpos_streamed"),
    ((1, 1, 32, 257, 1, 257), "flash_attention_relpos_streamed"),
    ((0, 1, 160, 510, 2, 255), "flash_attention_relpos_wide_wgmma"),
    ((0, 0, 32, 510, 2, 255), "flash_attention_relpos_tf32_streamed"),
    ((1, 0, 80, 289, 17, 17), "flash_attention_relpos_tf32"),
    ((1, 1, 80, 289, 17, 17), "flash_attention_relpos"),
    ((1, 1, 160, 196, 14, 14), "flash_attention_relpos_wide_wgmma"),
    ((0, 0, 80, 2304, 64, 36), "flash_attention_relpos_tf32"),
    ((0, 0, 96, 2304, 64, 36), "flash_attention_relpos_tf32"),
    ((0, 0, 64, 1300, 65, 20), "flash_attention_relpos_tf32"),
    ((0, 0, 64, 510, 2, 255), "flash_attention_relpos_tf32_streamed"),
]


@pytest.mark.parametrize("args,counter", _OLD_RELPOS + _NEW_RELPOS)
def test_relpos_counter_table(args, counter):
    """Which counter a rel-pos call moves: the old shapes keep theirs (the
    wgmma and 3xTF32 routes at their shapes, the tile and the FMA kernels
    elsewhere); the new shapes take K4's tile or FMA kernel (K5's large
    windows too), or the 3xTF32 kernel (its straddling mode, any grid
    height, and past 64 grid columns its streamed mode; K5's f32 windows past
    256 tokens too); bf16 past the
    factor table at head dims up to 128 takes the tile with streamed factors
    (K5's windows there too); at head dim 160 bf16 takes the wide wgmma
    kernel on any grid and f32 the wide 3xTF32 kernel inside the table (K5's
    wide heads too; tests/test_torch_relpos_wide.py holds the rest)."""
    kind, dtype, d, s, rows, cols = args
    assert tfa.relpos_counter(kind, dtype, d, s, rows, cols, d ** -0.5, *_A) == counter


@pytest.mark.parametrize("dtype,d,s,valid,counter", [
    (1, 64, 4096, 4096, "flash_attention_wgmma"), (1, 32, 900, 900, "flash_masked_wgmma"),
    (0, 32, 900, 900, "flash_attention_tf32"), (0, 128, 1024, 900, "flash_attention_tf32"),
    (0, 112, 1024, 900, "flash_attention_tf32"), (1, 64, 1024, 900, "flash_attention"),
    (0, 160, 1024, 900, "flash_attention_wide_tf32"),
    (0, 256, 300, 300, "flash_attention_wide_tf32"),
    (1, 160, 1024, 900, "flash_attention_wide_wgmma"),
    (1, 256, 300, 300, "flash_attention_wide_wgmma"), (1, 264, 300, 300, "flash_attention"),
    (1, 168, 300, 300, "flash_attention"), (1, 136, 300, 300, "flash_attention")])
def test_flash_counter_table(dtype, d, s, valid, counter):
    """Head dims past 128 count under the wide kernels' counters (multiples
    of 16 from 144 to 256: the wgmma kernel's in bf16, the 3xTF32 kernel's in
    f32) and the tile's (other bf16); f32 at head dim 112 under the 3xTF32
    kernel's; the old shapes keep theirs."""
    assert tfa.flash_counter(dtype, d, s, valid, d ** -0.5, *_A[:4]) == counter


@pytest.mark.parametrize("hd,want", [(16, 1), (128, 1), (129, 2), (160, 2), (256, 2), (300, 3)])
def test_deform_channel_slices(hd, want):
    """K1's grid y: one 128-channel slice a head up to 128, one more per 128
    channels past it."""
    assert tdw.channel_slices(hd) == want


def test_deform_device_levels_and_table():
    """Up to 8 levels the kernel reads its by-value table (the encoder's 4
    keep their launch parameters); past 8, the same rows from device
    memory."""
    assert not tdw.device_levels(4) and not tdw.device_levels(8) and tdw.device_levels(9)
    modes = _clamp_modes(SHAPES9)[:4] + (None,) * 5
    table = tdw.device_level_table(SHAPES9, modes, torch.device("cpu"))
    assert table.dtype == torch.int32 and tuple(table.shape) == (9, 4)
    assert table.flatten().tolist() == list(tdw.level_table(SHAPES9, modes))
    assert table[1, 2] == 24 * 30 and table[0, 3] == 4 + 2 * 3 and table[8, 3] == 0


# ------------------------------------- the straddling mode (3xTF32, K4 f32)
@pytest.mark.parametrize("kw,mode", [(64, "wide"), (8, "narrow"), (32, "narrow"), (56, "narrow"),
                                     (1, "straddle"), (7, "straddle"), (36, "straddle"),
                                     (63, "straddle")])
def test_relpos_tf32_mode(kw, mode):
    assert tfa.relpos_tf32_mode(kw) == mode


def test_relpos_tf32_straddle_table_stride():
    """The straddling mode's bias_w stride: the least >= kw that is 3 mod 16;
    a warp's 32 reads of 8 rows x 4 keys meet at most two to a bank at every
    width below 64 (at the stride kw, up to four), and the widest (67) fits
    the table's room at head dims 64 and 80 (72 floats) and at 96, where the
    room grows from 64 to 67 floats and the block still fits 232 448 bytes."""
    def ways(kw, ld):
        worst = 0
        for t in range(4):
            for j in range(8):
                for e in range(2):
                    banks = {}
                    for lane in range(32):
                        g, tq = divmod(lane, 4)
                        addr = g * ld + (64 * t + 8 * j + 2 * tq + e) % kw
                        banks.setdefault(addr % 32, set()).add(addr)
                    worst = max(worst, max(len(v) for v in banks.values()))
        return worst

    widths = [kw for kw in range(1, 64) if kw % 8]
    lds = {kw: tfa.relpos_tf32_straddle_ld(kw) for kw in widths}
    assert all(ld >= kw and ld % 16 == 3 for kw, ld in lds.items())
    assert max(ways(kw, lds[kw]) for kw in widths) <= 2
    assert max(ways(kw, kw) for kw in widths) == 4
    assert max(lds.values()) == 67 <= 72
    img = 64 * 96 * 4
    assert 2 * 2 * img + 2 * 2 * img + 128 * 67 * 4 + 64 + 1024 <= 232_448


@pytest.mark.parametrize("rows,cols", [(3, 36), (5, 12), (2, 1), (9, 3), (4, 7), (2, 63),
                                       (7, 20), (1, 5)])
def test_relpos_tf32_straddle_fragment_gathers_relpos_bias(rows, cols):
    """The straddling mode's index arithmetic: each score's (ky, kx), from
    one division a tile and 8-key steps (a wrap at kw >= 8, a division
    below), the pair's second key the next column or the next row's first,
    gathers ``relpos_bias`` at every score of every key tile; the masked
    keys are exactly those past S."""
    s = rows * cols
    gen = torch.Generator().manual_seed(cols)
    bias_h = torch.randn(1, s, rows, generator=gen)
    bias_w = torch.randn(1, s, cols, generator=gen)
    dense = tfa.relpos_bias(bias_h, bias_w, torch.float32)[0]
    fh, fw = bias_h[0], bias_w[0]
    q0s = torch.arange(0, max(s - s % 64, 1), 64)
    q0s = q0s[q0s + 64 <= s] if s >= 64 else torch.zeros(0, dtype=torch.long)
    masked = 0
    for t in range(-(-s // 64)):
        regs = [r for warp in range(4) for lane in range(32)
                for r in tfa.relpos_tf32_fragment(0, warp, lane, t, s, cols)]
        assert sorted((r[1], r[2]) for r in regs) == [(r, 64 * t + c) for r in range(64)
                                                      for c in range(64)]
        masked += sum(r[3] is None for r in regs)
        assert all(r[2] >= s for r in regs if r[3] is None)
        row, key, ky, kx = (torch.tensor([r[i] for r in regs if r[3] is not None])
                            for i in range(1, 5))
        assert bool((ky * cols + kx == key).all())
        q = (q0s[:, None] + row) if len(q0s) else row[None] % s
        got = fh[q, ky] + fw[q, kx]
        assert torch.equal(got, dense[q, key.expand_as(q)])
    assert masked == 64 * (-(-s // 64) * 64 - s)


@pytest.mark.parametrize("d,g,rows,cols,spread,bias_scale", [
    (80, 2, 5, 36, 1.0, 0.5),  # the 64 x 36 witness's width
    (64, 2, 7, 12, 3.0, 0.5),  # sharp rows
    (96, 1, 4, 20, 1.0, 3.0),  # head dim 96, large factors
    (80, 2, 9, 3, 1.0, 0.5),  # kw 3: a group spans several grid rows
    (64, 1, 6, 1, 1.0, 0.5),  # kw 1: every key its own grid row
    (80, 1, 3, 63, 0.25, 3.0)])  # the widest, a flat score
def test_relpos_tf32_straddle_mirror_matches_plain(d, g, rows, cols, spread, bias_scale):
    """The straddling mode's arithmetic (the products from zero, the whole
    bias added in f32 after them, no row shift) against the plain version
    within 1e-4."""
    q, k, v = _t(*_qkv(rows * cols + d, (g, rows * cols, d), spread))
    bias_h, bias_w = _t(*_factors(d + cols, g, rows, cols, bias_scale))
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


def test_relpos_tf32_straddle_mirror_matches_attend_relpos(jx):
    """The straddling mode's mirror on a 8 x 36 grid at head dim 80 against
    the JAX ``attend_relpos`` in interpret mode within 1e-4."""
    q, k, v = _qkv(836, (2, 288, 80))
    bias_h, bias_w = _factors(36, 2, 8, 36)
    want = torch.from_numpy(np.asarray(jx.fa.attend_relpos(
        *map(jx.jnp.asarray, (q, k, v, bias_h, bias_w)), 36, interpret=True)))
    got = tfa.relpos_tf32_mirror(*_t(q, k, v, bias_h, bias_w), 0)
    assert float((got - want).abs().max()) <= TOL


def test_new_shapes_on_cpu_take_the_plain_versions():
    """On CPU tensors the wrappers take every new shape to the plain versions
    and move no counter."""
    q, k, v = _t(*_qkv(1, (1, 300, 160)))
    bh, bw = _t(*_factors(2, 1, 1, 300))
    wq, wk, wv = _t(*_qkv(3, (1, 289, 32)))
    wh, ww = _t(*_factors(4, 1, 17, 17))
    value, locs, aw = _t(*_deform_inputs(5, SHAPES9))
    before = dict(dispatch.launch_counts)
    assert torch.equal(tfa.flash_attention(q, k, v, 250), tfa.flash_attention_plain(q, k, v, 250))
    assert torch.equal(tfa.attend_relpos(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                         v[..., :32].contiguous(), bh, bw, 300),
                       tfa.attend_relpos_plain(q[..., :32], k[..., :32], v[..., :32], bh, bw,
                                               300))
    assert torch.equal(twa.window_attention_relpos(wq, wk, wv, wh, ww, 17, 17),
                       twa.window_attention_relpos_plain(wq, wk, wv, wh, ww, 17, 17))
    assert torch.equal(tdw.ms_deform_sample(value, SHAPES9, locs, aw),
                       tdw.ms_deform_sample_plain(value, SHAPES9, locs, aw))
    assert dispatch.launch_counts == before


# ------------------------------------------------------------ on the card
def _moved(before):
    return [k for k, n in dispatch.launch_counts.items() if n != before[k]]


def _one_launch(before, key):
    """The call moved ``key``'s counter by one and no other."""
    assert _moved(before) == [key]
    assert dispatch.launch_counts[key] == before[key] + 1


def _within(got, want, q, k, v, valid=None, bias_h=None, bias_w=None):
    """f32 within 1e-4; bf16 within ``bf16_error_bound``."""
    if got.dtype == torch.float32:
        return float((got - want).abs().max()) <= TOL
    bound = tfa.bf16_error_bound(q, k, v, want, valid, bias_h=bias_h, bias_w=bias_w)
    return float(((got.float() - want.float()).abs() - bound).max()) <= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,valid,d", [(2, 300, 300, 160), (2, 300, 251, 160),
                                          (2, 256, 256, 256), (2, 1024, 900, 256),
                                          (1, 200, 77, 300), (2, 64, 64, 136)])
def test_flash_past_head_dim_128_on_card(cuda_device, dtype, bh, s, valid, d):
    """K2/K3 at head dims past 128, masked and unmasked: one launch on the
    wide kernels at head dims 144 to 256 (bf16 ``flash_attention_wide_wgmma``,
    f32 ``flash_attention_wide_tf32``), elsewhere the FMA kernel (f32,
    ``flash_attention_f32``) or the tile (bf16, ``flash_attention``), with
    their head-dim slices, within tolerance of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    key = tfa.flash_counter(int(dtype == torch.bfloat16), d, s, valid, d ** -0.5,
                            *(t.data_ptr() for t in (q, k, v, got)))
    wide = d in tfa.WIDE_WGMMA_HEAD_DIMS
    if dtype == torch.float32:
        assert key == ("flash_attention_wide_tf32" if wide else "flash_attention_f32")
    else:
        assert key == ("flash_attention_wide_wgmma" if wide else "flash_attention")
    _one_launch(before, key)
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _within(got, want, q, k, v, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attend_past_head_dim_128_on_card(cuda_device, dtype):
    """``attend`` at head dim 160 (the entry a model calls) takes the kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(4, 300, 160, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = dict(dispatch.launch_counts)
    got = tfa.attend(q, k, v)
    _one_launch(before, "flash_attention_wide_wgmma" if dtype == torch.bfloat16
                else "flash_attention_wide_tf32")
    want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v)


@pytest.mark.cuda
def test_flash_bf16_past_head_dim_128_off_16_bytes_on_card(cuda_device):
    """bf16 at head dim 160 off 16-byte boundaries: the FMA kernel's slices
    (``flash_attention``)."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v = (torch.randn(2, 200, 160, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    q = buf[1:].view(q.shape).copy_(q)
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=180)
    _one_launch(before, "flash_attention")
    want = tfa.flash_attention_plain(q, k, v, valid_len=180)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, 180)


def _relpos_card(dev, g, rows, cols, d, dtype, scale=0.5):
    gen = torch.Generator(device=dev).manual_seed(g * rows * cols + d)
    s = rows * cols
    q, k, v = (torch.randn(g, s, d, generator=gen, device=dev).to(dtype) for _ in range(3))
    bias_h = (scale * torch.randn(g, s, rows, generator=gen, device=dev)).to(dtype)
    bias_w = (scale * torch.randn(g, s, cols, generator=gen, device=dev)).to(dtype)
    return q, k, v, bias_h, bias_w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,rows,cols,d", [(2, 16, 16, 160), (2, 64, 64, 160), (1, 9, 17, 256),
                                           (2, 1, 300, 32), (2, 2, 255, 32), (1, 3, 301, 80),
                                           (1, 2, 255, 160), (1, 200, 100, 16)])
def test_relpos_past_the_limits_on_card(cuda_device, dtype, g, rows, cols, d):
    """K4 at head dims past 128 (the slice axis, on the tile in bf16 and the
    FMA kernel in f32) and at kh + kw past 256 (the FMA kernel reading the
    factors from device memory; bf16 at head dims up to 128 the tile with
    streamed factors, ``flash_attention_relpos_streamed``): one launch
    counted as ``flash_attention_relpos`` where no other route takes it,
    within tolerance of the plain version."""
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, g, rows, cols, d, dtype)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    _one_launch(before, tfa.relpos_counter(
        0, int(dtype == torch.bfloat16), d, rows * cols, rows, cols, d ** -0.5,
        *(t.data_ptr() for t in (q, k, v, got, bias_h, bias_w))))
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _within(got, want, q, k, v, bias_h=bias_h, bias_w=bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,wh,ww,d", [(6, 17, 17, 80), (3, 17, 17, 160), (2, 14, 14, 160),
                                       (2, 20, 30, 64), (4, 1, 257, 32)])
def test_window_past_256_tokens_on_card(cuda_device, dtype, g, wh, ww, d):
    """K5 on windows past 256 tokens or head dim 128: K4's kernels with G
    windows as BH, counted as ``flash_attention_relpos`` (past the factor
    table in bf16: ``flash_attention_relpos_streamed``), within tolerance of
    the window's plain version."""
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, g, wh, ww, d, dtype)
    before = dict(dispatch.launch_counts)
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, wh, ww)
    _one_launch(before, tfa.relpos_counter(
        1, int(dtype == torch.bfloat16), d, wh * ww, wh, ww, d ** -0.5,
        *(t.data_ptr() for t in (q, k, v, got, bias_h, bias_w))))
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, wh, ww)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, bias_h=bias_h, bias_w=bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,heads,hd,p", [(SHAPES9, 2, 16, 3), (SHAPES9, 3, 32, 4),
                                               (SHAPES2, 2, 160, 4), (SHAPES2, 1, 256, 2),
                                               (SHAPES2, 2, 136, 3), (SHAPES9, 2, 160, 4)])
def test_deform_past_8_levels_or_128_channels_on_card(cuda_device, dtype, shapes, heads, hd, p):
    """K1 at 9 levels (the level table in device memory) and at head dims
    past 128 (the channel slices), in clamp and exact mode: one launch
    counted as ``ms_deform_sample`` each, f32 within 1e-4 and bf16 within
    3e-2 of the plain version."""
    value, locs, aw = _deform_inputs(hd + p, shapes, b=2, heads=heads, hd=hd, p=p)
    aw /= aw.sum((-2, -1), keepdims=True)
    tv = torch.from_numpy(value).to(cuda_device, dtype)
    tl = torch.from_numpy(locs).to(cuda_device)
    ta = torch.from_numpy(aw).to(cuda_device, dtype)
    tol = TOL if dtype == torch.float32 else K1_BF16_TOL
    for modes in (_clamp_modes(shapes), None):
        before = dict(dispatch.launch_counts)
        got = tdw.ms_deform_sample(tv, shapes, tl, ta, modes)
        _one_launch(before, "ms_deform_sample")
        want = tdw.ms_deform_sample_plain(tv, shapes, tl, ta, modes)
        torch.cuda.synchronize()
        assert float((got.float() - want.float()).abs().max()) <= tol
        assert float(want.float().abs().max()) > 0


@pytest.mark.cuda
def test_deform_entry_refuses_many_levels_without_a_device_table_on_card(cuda_device):
    """Past 8 levels the C entry needs the device level table: without it it
    returns -1 and launches nothing."""
    from beyondff_tpu_torch.kernels import _build

    value, locs, aw = _deform_inputs(1, SHAPES9)
    tv, tl, ta = (torch.from_numpy(a).to(cuda_device) for a in (value, locs, aw))
    out = torch.empty(1, locs.shape[1], 2 * 16, device=cuda_device)
    rc = _build.library().bff_ms_deform_sample(
        0, tv.data_ptr(), tl.data_ptr(), ta.data_ptr(), None, out.data_ptr(), 1,
        value.shape[1], locs.shape[1], 2, 16, 9, 3, tdw.level_table(SHAPES9, (None,) * 9),
        torch.cuda.current_stream().cuda_stream, None)
    assert rc == -1


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,rows,cols,scale", [
    (80, 64, 64, 36, 0.1), (64, 16, 64, 36, 0.1), (96, 16, 64, 36, 0.1),  # the witness's width
    (80, 4, 64, 12, 3.0), (64, 4, 64, 20, 0.1), (80, 3, 7, 63, 0.1), (96, 2, 13, 44, 3.0),
    (80, 2, 5, 7, 0.1), (64, 3, 64, 3, 0.1), (80, 2, 3, 1, 0.1), (96, 1, 63, 9, 0.1)])
def test_k4_tf32_straddle_matches_plain_on_card(cuda_device, d, g, rows, cols, scale):
    """K4 in f32 on grids whose width is no multiple of 8 (the 3xTF32
    kernel's straddling mode) at head dims 64, 80 and 96, over widths from 1
    to 63 and factor scales: one launch counted as
    ``flash_attention_relpos_tf32``, within 1e-4 of the plain version."""
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, g, rows, cols, d, torch.float32, scale)
    assert tfa.relpos_tf32_route(0, 0, d, rows * cols, rows, cols, d ** -0.5,
                                 *(t.data_ptr() for t in (q, k, v, q, bias_h, bias_w)))
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    _one_launch(before, "flash_attention_relpos_tf32")
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_new_routes_match_the_c_side_on_card(cuda_device):
    """The C entries take every new shape (no -1) where the mirrors say a
    kernel runs, and ``bff_relpos_tf32_takes`` answers as
    ``relpos_tf32_route`` at every width below 64."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    for d in (64, 80, 96):
        for kw in range(1, 65):
            for kh in (1, 7, 64, 65):
                s = kh * kw
                ptrs = [4096 * (i + 1) for i in range(6)]
                want = tfa.relpos_tf32_route(0, 0, d, s, kh, kw, d ** -0.5, *ptrs)
                got = lib.bff_relpos_tf32_takes(0, 0, d, s, kh, kw, ctypes.c_float(d ** -0.5),
                                                *ptrs)
                assert bool(got) is want, (d, kh, kw)
