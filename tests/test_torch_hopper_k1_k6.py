"""K6 (mask IoU on int8 wgmma) and K1's TMA-staged variant (the encoder's
deformable sampling from staged windows): the host side of the Hopper
kernels, against the JAX package.

On the CPU the wrappers take their plain versions; these tests hold what the
kernels' host code decides (row strides, the route, the wgmma kernel's tile
and split schedule, the staging plan) and the staged variant's index
arithmetic, mirrored in plain PyTorch, against the JAX package's Pallas
kernels in interpret mode. The K6 kernels are held against their plain
version on the card (``tests/test_torch_kernels.py``, ``cuda`` marker); the
staged K1, which no path calls, by ``tools/kernel_variants.py``.
"""

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.core import masks as tmasks
from beyondff_tpu_torch.kernels import deform_window as tdw
from beyondff_tpu_torch.kernels import mask_iou as tiou
from beyondff_tpu_torch.models.gdino import deformable as tdeform
from beyondff_tpu_torch.models.gdino import model as tgdino
from beyondff_tpu_torch.tools import deform_staged as tds

torch.set_num_threads(2)

SWIN_B = tdw.ENC_SHAPES


@pytest.fixture
def jx():
    import types

    pytest.importorskip("jax")
    import jax.numpy as jnp

    from beyondff_tpu.kernels import deform_window as jdw
    from beyondff_tpu.kernels import mask_iou as jiou
    from beyondff_tpu.models.gdino import deformable as jdeform

    return types.SimpleNamespace(jnp=jnp, dw=jdw, iou=jiou, deform=jdeform)


def _test_preset_shapes():
    """The encoder's level shapes of the "test" Grounding-DINO preset."""
    cfg = tgdino.PRESETS["test"]
    with torch.no_grad():
        srcs = tgdino.GDINOModule(cfg).backbone_forward(torch.zeros(1, *cfg.image_size, 3))
    return tuple((int(x.shape[1]), int(x.shape[2])) for x in srcs)


# ---------------------------------------------------------------- K6 mask IoU
def _masks(rng, rows, n):
    m = rng.random((rows, n)) < rng.uniform(0.05, 0.6, (rows, 1))
    m[::5] = False  # empty rows: nan against every empty row
    return m


def _assert_bit_equal(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got.view(np.int32)[~np.isnan(got)],
                                  want.view(np.int32)[~np.isnan(want)])


@pytest.mark.parametrize("n", [1000, 1007, 4099])
def test_pairwise_iou_on_padded_rows_matches_pad_and_iou(jx, n):
    """(a) Masks as the main path holds them, rows 128 bytes apart in
    wider storage: ``as_mask`` keeps the values and pads the stride, and the
    IoU of such views equals the Pallas kernel's bit for bit, nan
    included."""
    rng = np.random.default_rng(n)
    a, b = _masks(rng, 37, n), _masks(rng, 11, n)
    b[3] = a[2]  # a pair with IoU exactly 1
    ta, tb = tmasks.as_mask(a, "cpu"), tmasks.as_mask(b, "cpu")
    for t, m in ((ta, a), (tb, b)):
        assert t.dtype == torch.bool and t.stride(1) == 1 and t.stride(0) % 16 == 0
        assert t.stride(0) == -(-n // 128) * 128 and t.data_ptr() % 16 == 0
        assert tiou.is_aligned(t)
        np.testing.assert_array_equal(t.numpy(), m)
    assert not ta.is_contiguous()
    for got_b, np_b in ((tb, b), (None, None)):
        got = tiou.pairwise_iou(ta, got_b).numpy()
        _assert_bit_equal(got, np.asarray(jx.iou.pad_and_iou(a, np_b, interpret=True)))
        assert np.isnan(got).any()
    assert tmasks.as_mask(ta, "cpu") is ta  # already aligned: no copy
    np.testing.assert_array_equal(tmasks.mask_iou(a, b, device="cpu"),
                                  tiou.pairwise_iou(ta, tb).numpy())


def _strided(kind, rows, n):
    """A (rows, n) bool tensor laid out as ``kind`` says."""
    if kind == "contiguous":
        return torch.zeros(rows, n, dtype=torch.bool)
    if kind == "stride_16_mod_128":  # 16-byte rows, not 128-byte ones
        return torch.zeros(rows, 144, dtype=torch.bool)[:, :n]
    if kind == "expanded":  # stride 0: every row the same storage
        return torch.zeros(1, n, dtype=torch.bool).expand(rows, n)
    if kind == "base_off_16":  # 128-byte rows starting 8 bytes in
        return torch.zeros(rows, 256, dtype=torch.bool)[:, 8:8 + n]
    if kind == "padded":
        return tiou.aligned_rows(rows, n, "cpu").zero_()
    raise ValueError(kind)


@pytest.mark.parametrize("kind,kept", [("contiguous", False), ("stride_16_mod_128", False),
                                       ("expanded", False), ("base_off_16", False),
                                       ("padded", True)])
def test_as_mask_keeps_only_the_128_byte_layout(kind, kept):
    """``as_mask`` returns a mask as it is only when its rows are a multiple
    of 128 bytes and at least N bytes apart from a 16-byte base
    (``is_aligned``); any other layout, a stride of 16 mod 128 and an
    expanded (stride-0) view among them, is copied into ``aligned_rows``
    with its values."""
    n = 100
    t = _strided(kind, 5, n)
    if kind != "expanded":
        t[2, 7] = t[4, n - 1] = True
    assert tiou.is_aligned(t) is kept
    got = tmasks.as_mask(t, "cpu")
    assert (got is t) is kept
    assert tiou.is_aligned(got) and got.stride(0) % tiou.ROW_PAD == 0
    assert torch.equal(got, t)


def test_aggregate_chunks_gathers_into_aligned_rows():
    """(a) The device membership aggregation takes: gathered per chunk
    straight into 16-byte rows, equal to the concatenated rows."""
    from beyondff_tpu_torch.core import aggregation

    rng = np.random.default_rng(3)
    n = 1003
    chunks = [(torch.from_numpy(rng.random((2, 3, n)) < 0.3), [2, 1]),
              (torch.from_numpy(rng.random((1, 4, n)) < 0.3), [3])]
    seen = {}
    real = aggregation.aggregate

    def spy(mem, *args):
        seen["mem"] = mem
        return real(mem, *args)

    aggregation.aggregate = spy
    try:
        aggregation.aggregate_chunks(chunks, n, np.ones(6, np.float32), ["x"] * 6)
    finally:
        aggregation.aggregate = real
    want = torch.cat([chunks[0][0][0, :2], chunks[0][0][1, :1], chunks[1][0][0, :3]])
    assert tiou.is_aligned(seen["mem"]) and seen["mem"].stride(0) == 1024
    assert torch.equal(seen["mem"], want)


def _covered(blocks, ia, ib, n, self_iou):
    """Counts of every (tile row, tile column, chunk) the schedule's live
    blocks multiply, and of every A share a cluster loads per chunk."""
    tile, chunk = tiou.WGMMA_TILE, tiou.WGMMA_CHUNK
    pairs, shares = {}, {}
    for ti, tj, r, past, k0, k1, boxes in blocks:
        chunks = list(range(k0, k1, chunk))
        for kind, k, row in boxes:
            assert 0 <= k < n, "a box starts past N"
            assert 0 <= row < (ia if kind == "a" else ib), "a box starts past the last row"
            assert k in chunks
            if kind == "a":
                key = (ti, tj - r, k, row)
                shares[key] = shares.get(key, 0) + 1
        if past:
            assert not any(kind == "b" for kind, _k, _r in boxes)
            continue
        assert not self_iou or tj >= ti
        for k in chunks:
            pairs[(ti, tj, k)] = pairs.get((ti, tj, k), 0) + 1
    return pairs, shares


@pytest.mark.parametrize("ia,ib,n,self_iou", [
    (600, 600, 250_000, True), (600, 600, 250_007, True), (20, 150, 250_000, False),
    (20, 150, 250_007, False), (1, 1, 1, True), (65, 65, 4099, True), (130, 129, 2049, False),
    (300, 700, 5000, False)])
def test_wgmma_schedule_counts_each_pair_and_chunk_once(ia, ib, n, self_iou):
    """(b) The wgmma kernel's grid (a mirror of bff_mask_iou_wgmma_count):
    every tile pair of the upper triangle (self) or of the whole product
    (cross) and every 128-point chunk is multiplied exactly once, every A
    share once per cluster and chunk, and every TMA box starts inside the
    tensor."""
    tile, chunk = tiou.WGMMA_TILE, tiou.WGMMA_CHUNK
    blocks = tiou.wgmma_schedule(ia, ib, n, self_iou)
    pairs, shares = _covered(blocks, ia, ib, n, self_iou)
    tiles_i, tiles_j = -(-ia // tile), -(-ib // tile)
    want = {(i, j, k) for i in range(tiles_i) for j in range(tiles_j)
            for k in range(0, -(-n // chunk) * chunk, chunk) if not self_iou or j >= i}
    assert set(pairs) == want and set(pairs.values()) == {1}
    assert set(shares.values()) == {1}
    # the splits tile N: consecutive, no gaps, no overlap
    spans = sorted({(k0, k1) for *_x, k0, k1, _b in blocks})
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert len(blocks) <= 132 or len(spans) == 1


@pytest.mark.parametrize("args,takes", [
    ((600, 600, 250_000, 250_000, 250_000, 0, None), True),
    ((600, 600, 250_007, 250_016, 250_016, 256, None), True),
    ((600, 600, 250_007, 250_007, 250_007, 256, None), False),  # rows off 16 bytes
    ((20, 150, 250_007, 250_016, 250_016, 256, 512), True),
    ((20, 150, 250_007, 250_016, 250_007, 256, 512), False),  # b's rows off 16 bytes
    ((20, 150, 1000, 1008, 1008, 256, 520), False),  # b's base off 16 bytes
    ((20, 150, 1000, 1008, 1008, 8, 512), False),  # a's base off 16 bytes
    ((1, 1, 1, 16, 16, 0, None), True),
    ((0, 1, 16, 16, 16, 0, None), False),
    ((4, 4, 0, 16, 16, 0, None), False),  # no points: only the finish kernel
    ((4, 4, 32, 16, 16, 0, None), False),  # a stride shorter than a row
    ((4, 4, 2 ** 31, 2 ** 31, 2 ** 31, 0, None), False),
    ((4, 9, 64, 64, 48, 0, None), True),  # a self-IoU ignores ldb
])
def test_wgmma_route_pins_the_predicate(args, takes):
    """(c) The mirror of bff_mask_iou_wgmma_takes (the card holds the C
    predicate to it, tests/test_torch_kernels.py)."""
    assert tiou.wgmma_route(*args) is takes


def test_wrapper_takes_strided_views_on_cpu():
    """Views with contiguous rows further apart than N are taken; rows
    closer than N or with strided points are refused on the card (here the
    plain version answers)."""
    storage = torch.zeros(4, 48, dtype=torch.bool)
    view = storage[:, :37]
    view[1, :5] = True
    got = tiou.pairwise_iou(view)
    assert got.shape == (4, 4) and float(got[1, 1]) == 1.0 and torch.isnan(got[0, 0])


# ------------------------------------------------- K1 staged deformable sampling
def _assert_plan(shapes, modes):
    """(d) Every raster query in exactly one block, every query's window
    inside its block's staged box, the box within shared memory, widths 4
    mod 8."""
    plan = tds.staged_plan_host(shapes, modes)
    q = sum(h * w for h, w in shapes)
    got = np.concatenate([plan.qidx[t, :plan.counts[t]] for t in range(plan.n_tiles)])
    np.testing.assert_array_equal(np.sort(got), np.arange(q))
    windows = np.stack([tdw.window_origins(shapes, modes, torch.device("cpu"))[li].numpy()
                        for li in range(len(shapes))])
    np.testing.assert_array_equal(plan.windows, windows)
    outside = 0
    for t in range(plan.n_tiles):
        qs = plan.qidx[t, :plan.counts[t]]
        for li, (tile, radius) in enumerate(modes):
            o = windows[li, qs]
            lo, box = plan.box_org[t, li], plan.box[li]
            inside = (o >= lo) & (o + tile + 2 * radius <= lo + box)
            outside += int((~inside.all(-1)).sum())
    assert outside == plan.outside
    cells = int(plan.box.prod(1).max())
    assert tds._staged_smem(plan.s_pad, cells) <= tds.STAGED_SMEM
    assert all(bx % 8 == 4 for bx in plan.box[:, 1])
    meta = list(plan.meta())
    assert meta[:2] == [plan.n_tiles, plan.s_pad] and meta[2:] == plan.box.reshape(-1).tolist()
    return plan


def test_staged_plan_at_swin_b():
    """(d) Swin-B's four levels at 800x1072: 63 level-0 tiles, one 32 x 32
    window at level 0 and up to 2 x 2 windows of 24 x 24 at levels 1-3,
    whose union is 32 x 32 (staged 36 wide), no query outside its box."""
    modes = tdeform.level_modes(SWIN_B)
    assert modes == ((16, 8), (8, 8), (8, 8), (8, 8))
    plan = _assert_plan(SWIN_B, modes)
    assert plan.n_tiles == 63 and plan.s_pad == 384 and plan.outside == 0
    assert plan.box.tolist() == [[32, 36]] * 4
    windows = plan.windows
    for t in range(plan.n_tiles):
        qs = plan.qidx[t, :plan.counts[t]]
        assert len(np.unique(windows[0, qs], axis=0)) == 1  # level 0: one window
        for li in (1, 2, 3):
            o = windows[li, qs]
            assert len(np.unique(o[:, 0])) <= 2 and len(np.unique(o[:, 1])) <= 2
            assert (o.max(0) + 24 - o.min(0) <= 32).all()
    # 64 KB of cells a head in bf16 (72 KB staged), two stages fit
    assert 32 * 32 * 64 == 65536 and 32 * 36 * 64 == 73728


def test_staged_plan_at_the_test_preset():
    """(d) The "test" preset's levels, and a mode whose windows outgrow the
    shared memory (they are counted, and served from global memory)."""
    shapes = _test_preset_shapes()
    assert len(shapes) == 3
    plan = _assert_plan(shapes, tdeform.level_modes(shapes))
    assert plan.outside == 0
    wide = _assert_plan(((40, 44), (20, 22)), ((32, 32), (8, 8)))
    assert wide.outside > 0


def test_build_assignment_matches_jax_at_swin_b(jx):
    """(d) The port's level-0 buckets, which the plan's blocks are, equal
    the JAX package's."""
    for level, tile in ((0, 16), (1, 8), (3, 8)):
        a = jx.dw.build_assignment(SWIN_B, level, tile)
        b = tdw.build_assignment(SWIN_B, level, tile)
        for name in ("idx", "valid", "inv"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert (a.nty, a.ntx, a.s_pad) == (b.nty, b.ntx, b.s_pad)


def test_device_plan_is_the_table_the_kernel_reads():
    """The staged variant's device table: query slots (tiles, s_pad), box
    origins (tiles, L, 2) and counts (tiles,), int32, beside the host rows
    (tiles, s_pad, then the box per level)."""
    modes = tdeform.level_modes(SWIN_B)
    table, meta = tds.device_plan(SWIN_B, modes, torch.device("cpu"))
    plan = tds.staged_plan_host(SWIN_B, modes)
    t, s_pad = plan.n_tiles, plan.s_pad
    assert table.dtype == torch.int32 and table.numel() == t * s_pad + t * 4 * 2 + t
    np.testing.assert_array_equal(table[:t * s_pad].numpy().reshape(t, s_pad), plan.qidx)
    np.testing.assert_array_equal(table[t * s_pad:t * s_pad + t * 8].numpy().reshape(t, 4, 2),
                                  plan.box_org)
    np.testing.assert_array_equal(table[-t:].numpy(), plan.counts)
    assert list(meta) == [t, s_pad] + [32, 36] * 4


@pytest.mark.parametrize("shapes,modes,hd", [
    (((24, 30), (12, 15), (6, 8), (3, 4)), None, 32),
    (((40, 44), (20, 22)), ((32, 32), (8, 8)), 32),
    ("test", None, 16),
])
def test_staged_arithmetic_matches_plain_and_pallas(jx, shapes, modes, hd):
    """(e) The staged kernel's index arithmetic (boxes cut from the map with
    zero fill, 64-byte swizzled chunks, box-relative corners, windows off
    their box read from the map) equals the plain gather and, level by
    level, the JAX package within f32 1e-5: the Pallas kernel in interpret
    mode where a (query, head) clamps a sample, the exact op where none
    clamps (the port keeps the exact arithmetic inside the window, where
    the Pallas kernel rounds g - origin)."""
    shapes = _test_preset_shapes() if shapes == "test" else shapes
    modes = tdeform.level_modes(shapes) if modes is None else modes
    rng = np.random.default_rng(hd)
    torch.manual_seed(hd)
    value, locs, aw = tdw.sample_inputs(rng, tdw.raster_centers(shapes), 2, torch.float32, "cpu",
                                        shapes=shapes, heads=2, hd=hd)
    got = tds.staged_sample_mirror(value, shapes, locs, aw, modes)
    want = tdw.ms_deform_sample_plain(value, shapes, locs, aw, modes)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    # level by level against the Pallas kernel: the other levels' weights 0
    start = 0
    for li, (h, w) in enumerate(shapes):
        tile, radius = modes[li]
        only = torch.zeros_like(aw)
        only[:, :, :, li] = aw[:, :, :, li]
        mine = tds.staged_sample_mirror(value, shapes, locs, only, modes).numpy()
        v = value[:, start:start + h * w].numpy()
        gx = locs[:, :, :, li, :, 0].numpy() * w - 0.5
        gy = locs[:, :, :, li, :, 1].numpy() * h - 0.5
        assign = jx.dw.build_assignment(shapes, li, tile)
        pallas = np.asarray(jx.dw.sample_level_windowed(
            *map(jx.jnp.asarray, (v, gx, gy, aw[:, :, :, li].numpy())), assign, h, w,
            radius=radius, interpret=True))
        exact = np.asarray(jx.deform.ms_deform_attn(
            jx.jnp.asarray(v), [(h, w)], jx.jnp.asarray(locs[:, :, :, li:li + 1].numpy()),
            jx.jnp.asarray(aw[:, :, :, li:li + 1].numpy())))
        clamps = tdw.clamped_samples(locs, shapes, modes)[li][0].any(-1).numpy()
        mine = mine.reshape(clamps.shape + (hd,))
        np.testing.assert_allclose(mine[clamps], pallas.reshape(mine.shape)[clamps],
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(mine[~clamps], exact.reshape(mine.shape)[~clamps],
                                   atol=1e-5, rtol=0)
        start += h * w
