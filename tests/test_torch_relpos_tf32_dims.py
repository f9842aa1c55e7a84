"""K4 in f32 at head dims 32, 48, 112 and 128 on the 3xTF32 kernel of
``csrc/relpos_attention_tf32.cu`` (``K4Cfg<32>``, ``<48>``, ``<112>`` and
``<128>``) in all four of its modes: the wide (kw = 64), narrow (kw a
multiple of 8 below 64) and straddling (any other kw below 64) modes,
counted as ``flash_attention_relpos_tf32``, and the streamed mode (kw past
64), counted as ``flash_attention_relpos_tf32_streamed``. At 112 and 128
the tiles are 32 keys (``relpos_tf32_tile``), each tile's P V is folded in
column parts and the scores' bias is added after the products
(``RELPOS_TF32_BIAS_AFTER``); at 32 and 48 the tiles are 64 keys and the
bias is the scores' start.

On the CPU: both predicates and the counters at the new head dims in each
mode, and their refusals (head dims 16, 40 and 72, a pointer off 16
bytes); the scratch size and tile, the grid's rows, the score index
arithmetic at 32-key tiles against ``relpos_bias``, the streamed slot at
32 keys, the shared memory of each new instance; the kernel's arithmetic
(``relpos_tf32_mirror``) against the plain version at unit scale, spread 3
and factor scale 3, within 1e-4 (the f32 calls' tolerance everywhere in
the repository); the mirror against the JAX ``attend_relpos`` in interpret
mode on one grid per mode; and SAM's global attention block at head dim
128 (``BFF_SAM_RELPOS_FLASH=1``) on the mirror against the JAX block with
its Pallas branch in interpret mode, within rtol 2e-4 and atol 2e-5 (the
repository's other SAM attention-branch tests' tolerance). Tests that need
the card carry the ``cuda`` marker and import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_relpos_tf32_dims.py``.
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
_A = (0, 256, 512, 1024, 2048, 4096)  # q, k, v, o, bias_h, bias_w: 16-byte aligned
ROUTE1, ROUTE2 = "flash_attention_relpos_tf32", "flash_attention_relpos_tf32_streamed"
FMA = "flash_attention_relpos"
NEW_DIMS = (32, 48, 112, 128)
# one grid per mode: wide, narrow, straddling, streamed
MODES = {"wide": (64, 64), "narrow": (64, 32), "straddle": (64, 36), "streamed": (64, 128)}


@pytest.fixture
def jx():
    import types

    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from beyondff_tpu.kernels import flash_attention as jfa
    from beyondff_tpu.models import sam as jsam

    return types.SimpleNamespace(jax=jax, jnp=jnp, fa=jfa, sam=jsam)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run python -m pytest --noconftest "
                    "-m cuda tests/test_torch_relpos_tf32_dims.py")
    return torch.device("cuda")


def _inputs(seed, g, rows, cols, d, spread=1.0, bias_scale=0.5):
    """q, k, v (q and k scaled by ``spread``) and the two factors (standard
    deviation ``bias_scale``) from a seeded numpy generator, CPU f32."""
    rng = np.random.default_rng(seed)
    s = rows * cols
    q, k, v = (rng.standard_normal((g, s, d)).astype(np.float32) for _ in range(3))
    bias_h = (rng.standard_normal((g, s, rows)) * bias_scale).astype(np.float32)
    bias_w = (rng.standard_normal((g, s, cols)) * bias_scale).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (q * spread, k * spread, v, bias_h, bias_w))


# ------------------------------------------------------------------ routes
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d", NEW_DIMS)
def test_new_head_dims_take_the_3xtf32_kernel(d, mode):
    """At head dims 32, 48, 112 and 128 f32 K4 takes route 1 (the wide,
    narrow and straddling modes) or route 2 (the streamed mode), and the
    call counts under that route's counter, not the FMA kernel's."""
    rows, cols = MODES[mode]
    call = (0, 0, d, rows * cols, rows, cols, d ** -0.5, *_A)
    assert tfa.relpos_tf32_mode(cols) == mode
    assert tfa.relpos_tf32_route(*call) is (mode != "streamed")
    assert tfa.relpos_tf32_streamed_route(*call) is (mode == "streamed")
    assert tfa.relpos_counter(*call) == (ROUTE2 if mode == "streamed" else ROUTE1)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("d", [16, 40, 72, 120, 136])
def test_other_head_dims_keep_the_fma_kernel(d, mode):
    """Head dim 16, those that are no multiple of 16 (40, 72, 120) and 136
    (past 128, below the wide kernels' 144) stay on the FMA kernel in every
    mode."""
    rows, cols = MODES[mode]
    call = (0, 0, d, rows * cols, rows, cols, d ** -0.5, *_A)
    assert not tfa.relpos_tf32_route(*call) and not tfa.relpos_tf32_streamed_route(*call)
    assert tfa.relpos_counter(*call) == FMA


@pytest.mark.parametrize("ptrs", [(4, 0, 0, 0, 0, 0), (0, 8, 0, 0, 0, 0), (0, 0, 0, 12, 0, 0),
                                  (0, 0, 0, 0, 0, 4)])
@pytest.mark.parametrize("d", NEW_DIMS)
def test_new_head_dims_need_every_pointer_on_16_bytes(d, ptrs):
    """A pointer off 16 bytes keeps both routes off at the new head dims."""
    for rows, cols in MODES.values():
        call = (0, 0, d, rows * cols, rows, cols, d ** -0.5, *ptrs)
        assert not tfa.relpos_tf32_route(*call) and not tfa.relpos_tf32_streamed_route(*call)
        assert tfa.relpos_counter(*call) == FMA


@pytest.mark.parametrize("d,wh,ww,counter", [
    (32, 17, 17, ROUTE1), (48, 20, 30, ROUTE1), (112, 17, 17, ROUTE1), (128, 32, 64, ROUTE1),
    (32, 1, 257, ROUTE2), (128, 2, 129, ROUTE2), (16, 17, 17, FMA), (40, 2, 129, FMA),
    (32, 14, 14, "window_attention_relpos"), (128, 16, 16, "window_attention_relpos")])
def test_windows_past_256_tokens_at_the_new_head_dims(d, wh, ww, counter):
    """K5's f32 windows past 256 tokens (K4's kernels, G windows as heads)
    follow K4's routes at the new head dims; windows up to 256 tokens keep
    K5's FMA kernel."""
    assert tfa.relpos_counter(1, 0, d, wh * ww, wh, ww, d ** -0.5, *_A) == counter


@pytest.mark.parametrize("d,tile", [(32, 64), (48, 64), (64, 64), (80, 64), (96, 64),
                                    (112, 32), (128, 32)])
def test_tile_follows_the_head_dim(d, tile):
    assert tfa.relpos_tf32_tile(d) == tile
    assert (d in tfa.RELPOS_TF32_BIAS_AFTER) is (d >= 96)
    assert d in tfa.RELPOS_TF32_HEAD_DIMS[0]


@pytest.mark.parametrize("bh,s,d,want", [
    (16, 4096, 128, 4 * 16 * 4096 * 128), (16, 2304, 112, 4 * 16 * 2304 * 112),
    (2, 510, 128, 4 * 2 * 512 * 128),  # 2 x 255: 16 tiles of 32, the last padded by 2
    (3, 100, 112, 4 * 3 * 128 * 112), (1, 65, 128, 4 * 96 * 128),
    (2, 510, 32, 4 * 2 * 512 * 32), (1, 65, 48, 4 * 128 * 48),
    (16, 4096, 32, 4 * 16 * 4096 * 32), (3, 100, 48, 4 * 3 * 128 * 48)])
def test_scratch_rounds_up_to_the_tile(bh, s, d, want):
    """The scratch holds every tile's four images, 4 BH Sp D floats with Sp
    = S rounded up to the tile: 32 keys at 112 and 128, 64 at 32 and 48."""
    assert tfa.relpos_tf32_scratch_floats(bh, s, d) == want


@pytest.mark.parametrize("n,s", [(16, 4096), (3, 510), (2, 65), (1, 2304)])
def test_schedule_is_the_head_dims_own(n, s):
    """The grid (ceil(S / 128), BH) of two 64-row consumers is the same at
    every head dim: 32-key tiles keep 128-row blocks, so a block's re-reads
    of the K and V images per query row do not grow; every (head, row) is in
    one consumer's rows once."""
    grid, tiles = tfa.relpos_tf32_schedule(0, n, s)
    assert grid == (-(-s // 128), n)
    seen = np.zeros((n, s), np.int64)
    for rows in tiles.values():
        for h, r0 in rows:
            seen[h, r0:min(r0 + 64, s)] += 1
    assert (seen == 1).all()


# --------------------------------------------------- the 32-key tile's indices
@pytest.mark.parametrize("rows,cols", [(3, 64), (4, 32), (5, 40), (6, 36), (2, 255),
                                       (1, 100), (3, 72), (2, 65), (8, 9)])
def test_32_key_fragment_gathers_relpos_bias(rows, cols):
    """At head dim 128 (32-key tiles, m64n32 scores) the score index
    arithmetic of every mode gathers ``relpos_bias`` at every score of every
    tile, each (row, key) of the tile once: at kw = 64 the tile is half a
    grid row (one bias_h shift), in the narrow mode an n8 group lies in one
    grid row, in the straddling mode each score has its own cell, in the
    streamed mode the tile lies in at most two grid rows; the masked keys
    are exactly those past S in the last tile."""
    s = rows * cols
    gen = torch.Generator().manual_seed(rows * 1000 + cols)
    bias_h = torch.randn(1, s, rows, generator=gen)
    bias_w = torch.randn(1, s, cols, generator=gen)
    dense = tfa.relpos_bias(bias_h, bias_w, torch.float32)[0]
    n_tiles = -(-s // 32)
    masked = 0
    for t in range(n_tiles):
        regs = [r for warp in range(4) for lane in range(32)
                for r in tfa.relpos_tf32_fragment(0, warp, lane, t, s, cols, d=128)]
        assert sorted((r[1], r[2]) for r in regs) == [(w, 32 * t + c) for w in range(64)
                                                      for c in range(32)]
        masked += sum(r[3] is None for r in regs)
        assert all(r[2] >= s for r in regs if r[3] is None)
        live = [r for r in regs if r[3] is not None]
        row, key, ky, kx = (torch.tensor([r[i] for r in live]) for i in range(1, 5))
        if cols == 64:
            assert int(ky.max()) == int(ky.min()) == t // 2
        q = torch.arange(0, max(s - 63, 1), 64)[:, None] + row
        q = q[(q < s).all(dim=1)]
        assert torch.equal(bias_h[0][q, ky] + bias_w[0][q, kx], dense[q, key.expand_as(q)])
    assert masked == 64 * (n_tiles * 32 - s)


def test_32_key_streamed_slot_is_conflict_free():
    """The streamed mode's bias_w slot at 32-key tiles (the block's 128 rows
    x 32 floats, 8-column group g of row r at g ^ (r % 4)): every (row,
    column) has its own float; a copy step (one row, 32 columns, a float a
    lane) meets each bank once; a read step (a quad's 8-byte pairs of one
    group for a warp's 8 rows) fills each bank twice, where 32-float rows
    unswizzled would put the 8 rows in the same 8 banks."""
    slots = [tfa.relpos_tf32_bw_slot(r, c, 32) for r in range(128) for c in range(32)]
    assert sorted(slots) == list(range(128 * 32))
    for r in range(128):
        banks = [tfa.relpos_tf32_bw_slot(r, lane, 32) % 32 for lane in range(32)]
        assert sorted(banks) == list(range(32))
    for j in range(4):
        for rows in (range(r0, r0 + 8) for r0 in range(0, 128, 8)):
            banks = [(tfa.relpos_tf32_bw_slot(r, 8 * j + 2 * quad, 32) + e) % 32
                     for r in rows for quad in range(4) for e in range(2)]
            assert all(banks.count(b) == 2 for b in range(32))
        flat = [(r * 32 + 8 * j + c) % 32 for r in range(8) for c in range(8)]
        assert max(flat.count(b) for b in range(32)) == 8
    # the 64-key slot is unchanged
    assert [tfa.relpos_tf32_bw_slot(r, c) for r in range(16) for c in range(64)] == [
        r * 64 + ((c // 8) ^ (r % 8)) * 8 + c % 8 for r in range(16) for c in range(64)]


@pytest.mark.parametrize("d,tile,k_stages,v_stages,table_ld", [
    (32, 64, 2, 2, 72), (48, 64, 2, 2, 72), (112, 32, 1, 1, 72), (128, 32, 1, 1, 64)])
def test_new_instances_fit_a_block(d, tile, k_stages, v_stages, table_ld):
    """K4Cfg's shared memory at the new head dims: both consumers' Q hi and
    lo images (2 x 2 x 64 x D floats), the K and V^T stages (hi and lo of a
    tile by D), the table's room (the widest of the wide mode's stride and
    the straddling mode's 67 floats, for 128 rows; in the streamed mode a
    slot of 128 x tile floats a K stage where that is more), the barriers and
    the 1024-byte alignment fit the 232 448 bytes a block may have. At 128
    the wide table is 64 floats a row (swizzled, as at 96) and the
    straddling mode's 67 leave 448 bytes; 64-key tiles there, or at 112,
    would not fit, nor a second stage at 32-key tiles."""
    room = max(table_ld, tfa.relpos_tf32_straddle_ld(63))
    img = tile * d * 4
    smem = lambda ks, vs, t=tile, rm=room: (2 * 2 * 64 * d * 4 + 2 * (ks + vs) * t * d * 4
                                            + 128 * rm * 4 + 64 + 1024)
    assert tfa.relpos_tf32_tile(d) == tile and img % 256 == 0
    assert smem(k_stages, v_stages) <= 232_448
    stream = smem(k_stages, v_stages, rm=max(room, k_stages * tile))
    assert stream <= 232_448
    if d > 96:
        assert smem(k_stages + 1, v_stages) > 232_448
        assert smem(1, 1, t=64) > 232_448
    if d == 128:
        assert smem(1, 1) == 232_000 and smem(1, 1, rm=72) > 232_448


# -------------------------------------------------------------- arithmetic
@pytest.mark.parametrize("d,g,rows,cols,spread,bias_scale", [
    (128, 1, 3, 64, 1.0, 0.5), (128, 1, 3, 64, 3.0, 0.5), (128, 1, 3, 64, 1.0, 3.0),
    (112, 2, 2, 64, 1.0, 0.5), (112, 1, 3, 64, 3.0, 3.0),
    (128, 1, 6, 40, 1.0, 0.5), (112, 1, 5, 32, 3.0, 0.5), (128, 1, 4, 24, 1.0, 3.0),
    (128, 1, 7, 36, 1.0, 0.5), (112, 1, 6, 9, 3.0, 0.5), (128, 1, 5, 63, 1.0, 3.0),
    (128, 1, 2, 72, 1.0, 0.5), (112, 1, 1, 130, 3.0, 0.5), (128, 1, 2, 100, 1.0, 3.0),
    (32, 1, 3, 64, 1.0, 0.5), (48, 2, 2, 64, 3.0, 0.5), (32, 1, 3, 64, 1.0, 3.0),
    (48, 1, 6, 40, 1.0, 3.0), (32, 1, 5, 32, 3.0, 0.5), (48, 1, 7, 36, 1.0, 0.5),
    (32, 1, 8, 9, 1.0, 3.0), (48, 1, 2, 72, 3.0, 0.5), (32, 1, 1, 130, 1.0, 0.5),
    (48, 1, 2, 100, 1.0, 3.0)])
def test_mirror_matches_plain_at_the_new_head_dims(d, g, rows, cols, spread, bias_scale):
    """The kernel's arithmetic at head dims 32, 48, 112 and 128 in the wide,
    narrow, straddling and streamed modes against the plain version within
    1e-4, at unit scale, spread 3 (peaked rows) and factor scale 3."""
    q, k, v, bias_h, bias_w = _inputs(rows * 1000 + cols + d, g, rows, cols, d, spread,
                                      bias_scale)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("d", [32, 48, 112, 128])
def test_mirror_beats_one_tf32_product(d):
    """The 3xTF32 split matters at the new head dims: one TF32 product of
    the scaled q and k (no lo terms) lies further from the plain version
    than the mirror does."""
    q, k, v, bias_h, bias_w = _inputs(d, 1, 4, 64, d, 3.0)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 64)
    sc = d ** -0.5
    one = torch.softmax(tfa.tf32_round(q * sc) @ tfa.tf32_round(k).transpose(1, 2)
                        + tfa.relpos_bias(bias_h, bias_w, torch.float32), dim=-1) @ v
    assert float((got - want).abs().max()) < float((one - want).abs().max())


@pytest.mark.parametrize("d,rows,cols,spread", [
    (128, 4, 64, 1.0), (112, 8, 32, 3.0), (128, 7, 36, 1.0), (112, 2, 255, 1.0),
    (32, 4, 64, 3.0), (48, 8, 32, 1.0), (32, 7, 36, 1.0), (48, 2, 255, 3.0)])
def test_mirror_matches_jax_attend_relpos(jx, d, rows, cols, spread):
    """The mirror against the JAX ``attend_relpos`` in interpret mode in f32
    (its head dim padded to 128 lanes below 128; at most 512 tokens, one
    block of the JAX kernel), one grid per mode at each new head dim: within
    1e-4, both within 1e-4 of the plain version."""
    q, k, v, bias_h, bias_w = _inputs(rows + cols + d, 1, rows, cols, d, spread)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = torch.from_numpy(np.array(jx.fa.attend_relpos(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v, bias_h, bias_w)), cols, interpret=True)))
    plain = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


def test_sam_global_block_at_head_dim_128_matches_jax(jx, monkeypatch):
    """SAM's global attention block (``ViTAttention``, 2 heads of head dim
    128 on an 8 x 64 grid, which ``relpos_shapes_ok`` admits) under
    ``BFF_SAM_RELPOS_FLASH=1``, its kernel branch forced and the rel-pos call
    on the 3xTF32 kernel's arithmetic (``relpos_tf32_mirror``, the wide mode
    at 32-key tiles), against the JAX block with its Pallas branch forced in
    interpret mode: within rtol 2e-4, atol 2e-5."""
    from beyondff_tpu.kernels import dispatch as jdispatch

    from beyondff_tpu_torch.models import sam as tsam
    from beyondff_tpu_torch.models.convert import _Writer

    jax, jnp = jx.jax, jx.jnp
    hw = (8, 64)
    assert tfa.relpos_shapes_ok(*hw)
    dim, heads = 256, 2
    rng = np.random.default_rng(128)
    jattn = jx.sam.ViTAttention(num_heads=heads, use_rel_pos=True, input_hw=hw,
                                dtype=jnp.float32)
    x = rng.normal(size=(1, *hw, dim)).astype(np.float32)
    params = jattn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape, scale=0.1).astype(np.float32)), params)
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    w = _Writer()
    w.dense("qkv", p["qkv"])
    w.dense("proj", p["proj"])
    w.raw("rel_pos_h", p["rel_pos_h"])
    w.raw("rel_pos_w", p["rel_pos_w"])
    tattn = tsam.ViTAttention(dim, heads, True, hw, softmax_f32=True)
    tattn.load_state_dict(w.sd)
    monkeypatch.setenv("BFF_SAM_RELPOS_FLASH", "1")
    monkeypatch.setattr(jdispatch, "on_tpu", lambda: True)
    real = jx.fa.attend_relpos
    monkeypatch.setattr(jx.fa, "attend_relpos", lambda *a, **k: real(*a, interpret=True, **k))
    calls = []

    def on_the_route(q, k, v, bias_h, bias_w, kw):
        calls.append(tfa.relpos_counter(0, 0, q.shape[-1], q.shape[1], bias_h.shape[-1], kw,
                                        q.shape[-1] ** -0.5, *_A))
        return tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0, q.shape[-1] ** -0.5)

    monkeypatch.setattr(tsam.fa, "attend_relpos", on_the_route)
    monkeypatch.setattr(tsam, "_kernel_path", lambda t: True)
    want = np.asarray(jattn.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = tattn(torch.from_numpy(x)).numpy()
    assert calls == [ROUTE1]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


# -------------------------------------------------------------- on the card
def _card(dev, g, rows, cols, d, spread=1.0, factor_scale=0.1):
    """q, k, v from a seeded generator (q and k scaled by ``spread``) and the
    factors as SAM builds them, q . R products of rel-pos tables at
    ``factor_scale``."""
    from beyondff_tpu_torch.models import sam as sam_mod

    gen = torch.Generator(device=dev).manual_seed(g * rows * cols + d)
    q, k, v = (torch.randn(g, rows * cols, d, device=dev, generator=gen) for _ in range(3))
    q, k = q * spread, k * spread
    rel_h = factor_scale * torch.randn(2 * rows - 1, d, device=dev, generator=gen)
    rel_w = factor_scale * torch.randn(2 * cols - 1, d, device=dev, generator=gen)
    bias_h, bias_w = sam_mod._rel_pos_factors((rows, cols), (rows, cols), rel_h, rel_w, q)
    return q, k, v, bias_h.contiguous(), bias_w.contiguous()


def _moved(before):
    return [k for k, n in dispatch.launch_counts.items() if n != before[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(64, 64), (65, 64), (64, 32), (3, 8), (64, 36), (7, 63),
                                  (5, 1), (64, 128), (2, 255), (1, 65)])
@pytest.mark.parametrize("d", NEW_DIMS)
def test_new_instances_match_plain_on_card(cuda_device, d, grid):
    """Each new instance (head dims 32, 48, 112 and 128 in the wide, narrow,
    straddling and streamed modes) against the plain version within 1e-4,
    one launch counted under its route's counter."""
    rows, cols = grid
    q, k, v, bias_h, bias_w = _card(cuda_device, 4, rows, cols, d)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert _moved(before) == [ROUTE2 if cols > 64 else ROUTE1]
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,rows,cols,spread,factor_scale", [
    (128, 64, 64, 3.0, 0.1), (128, 64, 64, 1.0, 3.0), (112, 64, 36, 3.0, 0.1),
    (112, 64, 32, 1.0, 3.0), (128, 2, 255, 3.0, 3.0), (32, 64, 64, 3.0, 0.1),
    (32, 64, 64, 1.0, 3.0), (48, 64, 36, 1.0, 3.0), (48, 64, 128, 3.0, 0.1),
    (32, 72, 36, 1.0, 0.1), (128, 72, 36, 1.0, 0.1), (48, 80, 64, 1.0, 0.1),
    (32, 2, 255, 1.0, 0.1)])
def test_new_instances_at_spread_and_factor_scale_on_card(cuda_device, d, rows, cols, spread,
                                                          factor_scale):
    """Peaked rows (spread 3) and large factors (factor scale 3) at the new
    head dims, and the grids that left the FMA kernel (72 x 36 at 32 and
    128, 80 x 64 at 48, 2 x 255 at 32): within 1e-4 of plain."""
    q, k, v, bias_h, bias_w = _card(cuda_device, 4, rows, cols, d, spread, factor_scale)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert _moved(before) == [ROUTE2 if cols > 64 else ROUTE1]
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,wh,ww", [(32, 17, 17), (128, 17, 17), (48, 2, 129)])
def test_new_head_dims_windows_past_256_tokens_on_card(cuda_device, d, wh, ww):
    """K5's f32 windows past 256 tokens at the new head dims take K4's
    3xTF32 routes, within 1e-4 of the window's plain version."""
    q, k, v, bias_h, bias_w = _card(cuda_device, 8, wh, ww, d)
    before = dict(dispatch.launch_counts)
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, wh, ww)
    assert _moved(before) == [ROUTE2 if ww > 64 else ROUTE1]
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, wh, ww)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_new_head_dims_predicates_and_scratch_match_the_c_side_on_card(cuda_device):
    """Both mirrors say what ``bff_relpos_tf32_takes`` and
    ``bff_relpos_tf32_streamed_takes`` say at head dims 16 to 144 over the
    modes, alignments and scales, and ``relpos_tf32_scratch_floats`` what
    ``bff_relpos_tf32_scratch_floats`` says."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    for d in range(16, 145, 8):
        for rows, cols in (*MODES.values(), (2, 255), (7, 9), (1, 8)):
            for scale in (d ** -0.5, 0.0):
                for slot, off in ((0, 0), (2, 8), (4, 4)):
                    ptrs = [4096 * (i + 1) for i in range(6)]
                    ptrs[slot] += off
                    call = (0, 0, d, rows * cols, rows, cols)
                    for mirror, fn in ((tfa.relpos_tf32_route, lib.bff_relpos_tf32_takes),
                                       (tfa.relpos_tf32_streamed_route,
                                        lib.bff_relpos_tf32_streamed_takes)):
                        want = mirror(*call, scale, *ptrs)
                        assert bool(fn(*call, ctypes.c_float(scale), *ptrs)) is want, (fn, call)
        for bh, s in ((16, 4096), (2, 510), (3, 100), (1, 65)):
            assert lib.bff_relpos_tf32_scratch_floats(bh, s, d) == (
                tfa.relpos_tf32_scratch_floats(bh, s, d))


@pytest.mark.cuda
@pytest.mark.parametrize("d,grid,counter", [(128, (2, 64), ROUTE1), (32, (2, 255), ROUTE2),
                                            (112, (64, 36), ROUTE1), (48, (1, 65), ROUTE2)])
def test_new_head_dims_raise_on_a_failed_launch_on_card(cuda_device, monkeypatch, d, grid,
                                                        counter):
    """A code from the C entry raises, naming the route's counter; nothing
    falls back and nothing is counted."""
    from beyondff_tpu_torch.kernels import _build

    rows, cols = grid
    q, k, v, bias_h, bias_w = _card(cuda_device, 2, rows, cols, d)

    class Failing:
        def __getattr__(self, name):
            return lambda *a: -1

    monkeypatch.setattr(_build, "library", lambda: Failing())
    before = dict(dispatch.launch_counts)
    with pytest.raises(RuntimeError, match=counter):
        tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert dispatch.launch_counts == before


@pytest.mark.parametrize("name", ["k4_tf32_plan_b", "k4_tf32_d128_bias_start",
                                  "k4_tf32_d128_fold_2", "k4_tf32_d32_stages_2_1",
                                  "k4_tf32_d32_stages_1_1"])
def test_dims_variant_edits_match_the_sources(name):
    """``tools/kernel_variants.py``'s variants of the new head dims (plan (b)
    on the wide 3xTF32 kernel, the bias as the scores' start at 112 and 128,
    the ring depths at 32 and 48) are edits that each match their source
    once, over the six sources the rel-pos entries route between."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    sources, edits = kv.VARIANTS[name]
    assert "relpos_attention_tf32.cu" in sources and "relpos_attention_wide_tf32.cu" in sources
    for fname, old, new in edits:
        with open(os.path.join(_build.CSRC, fname)) as f:
            assert f.read().count(old) == 1, (fname, old)
        assert new != old
