"""K4 in f32 on grids past 64 x 64 on the 3xTF32 kernel of
``csrc/relpos_attention_tf32.cu``: grid heights past 64 on its wide, narrow
and straddling modes (``relpos_tf32_route``, counted as
``flash_attention_relpos_tf32``), and grid widths past 64, past kh + kw =
256 too, on its streamed mode (``relpos_tf32_streamed_route``, counted as
``flash_attention_relpos_tf32_streamed``): a tile's bias_w run of 64
columns staged a tile at a time instead of the block's table, each
score's whole bias added in f32 after the products. K5's f32 windows past
256 tokens take the same routes (G windows as heads).

On the CPU: both predicates and the counters case by case, the streamed
mode's fragment and slot arithmetic against ``relpos_bias``, the kernel's
arithmetic (``relpos_tf32_mirror``) against the plain version at kh 65 to
257 and kw 65 to 300, and against the JAX ``attend_relpos`` in interpret
mode on grids of at most 512 tokens (where the JAX kernel runs one
block), in f32 within 1e-4 (the f32 calls' tolerance everywhere in the
repository); and the port's SAM attention block with its rel-pos flash
branch on the mirror against the JAX block with its Pallas branch in
interpret mode, within rtol 2e-4 and atol 2e-5 (the tolerance of the
repository's other SAM attention-branch tests: a projection on each side of
the attention). Tests that need the card carry the ``cuda`` marker and
import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_relpos_tf32_grids.py``.
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
                    "-m cuda tests/test_torch_relpos_tf32_grids.py")
    return torch.device("cuda")


def _inputs(seed, g, rows, cols, d=80, spread=1.0, bias_scale=0.5):
    """q, k, v (q and k scaled by ``spread``) and the two factors (standard
    deviation ``bias_scale``) from a seeded numpy generator, CPU f32."""
    rng = np.random.default_rng(seed)
    s = rows * cols
    q, k, v = (rng.standard_normal((g, s, d)).astype(np.float32) for _ in range(3))
    bias_h = (rng.standard_normal((g, s, rows)) * bias_scale).astype(np.float32)
    bias_w = (rng.standard_normal((g, s, cols)) * bias_scale).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (q * spread, k * spread, v, bias_h, bias_w))


# ------------------------------------------------------------------ routes
@pytest.mark.parametrize("args,route1,route2", [
    # route 1: kh past 64 on the wide, narrow and straddling modes
    ((0, 0, 80, 4608, 72, 64), True, False),  # the wide mode, 72 rows
    ((0, 0, 80, 5120, 80, 64), True, False),  # 80 x 64: SAM at a 1280 x 1024 input
    ((0, 0, 80, 8192, 128, 64), True, False),
    ((0, 0, 80, 2592, 72, 36), True, False),  # the 72 x 36 witness: straddling
    ((0, 0, 64, 510, 255, 2), True, False),  # 255 x 2: past kh + kw = 256, a narrow width
    ((0, 0, 80, 257, 257, 1), True, False),  # one key a grid row
    ((0, 0, 96, 260, 65, 4), True, False),
    ((0, 0, 64, 2080, 65, 32), True, False),  # the narrow mode, 65 rows
    ((0, 0, 96, 4160, 65, 64), True, False),  # head dim 96, the swizzled table
    ((0, 0, 80, 300, 300, 1), True, False),  # 300 x 1: past kh + kw = 256
    # route 2: kw past 64, any kh
    ((0, 0, 64, 510, 2, 255), False, True),  # 2 x 255: past kh + kw = 256
    ((0, 0, 64, 300, 1, 300), False, True),
    ((0, 0, 80, 8192, 64, 128), False, True),  # 64 x 128: a tile in one grid row
    ((0, 0, 80, 5184, 72, 72), False, True),
    ((0, 0, 80, 18496, 136, 136), False, True),  # SAM at a 2176-pixel side
    ((0, 0, 96, 384, 3, 128), False, True),
    ((0, 0, 80, 65, 1, 65), False, True),  # the narrowest streamed width: one padded tile
    # neither: another dtype, head dim, scale, alignment, S off the grid
    ((0, 1, 80, 510, 2, 255), False, False),  # bf16: the tile with streamed factors
    ((0, 0, 16, 510, 2, 255), False, False),  # head dim 16: the FMA kernel
    ((0, 0, 136, 4608, 72, 64), False, False),  # head dim 136
    ((0, 0, 40, 8192, 64, 128), False, False),
    ((0, 0, 160, 510, 2, 255), False, False),  # the wide 3xTF32 kernel's head dim
    ((0, 0, 80, 8191, 64, 128), False, False),  # S off the grid
    ((0, 0, 80, 4607, 72, 64), False, False),
    ((2, 0, 80, 8192, 64, 128), False, False),  # no such entry
    ((0, 0, 80, 8192, 64, 128, 0.0), False, False),  # no positive scale
    ((0, 0, 80, 8192, 64, 128, float("inf")), False, False),
    ((0, 0, 80, 0, 0, 128), False, False),  # no grid
])
def test_route_predicates_pin_both_routes(args, route1, route2):
    """``relpos_tf32_route`` (route 1: kh any height from 1 at kw <= 64) and
    ``relpos_tf32_streamed_route`` (route 2: kw past 64) case by case, and
    the counter each call moves: route 1's, route 2's or, where neither
    takes it, the one the other routes name."""
    kind, dtype, d, s, rows, cols, *scale = args
    scale = scale[0] if scale else d ** -0.5
    call = (kind, dtype, d, s, rows, cols, scale, *_A)
    assert tfa.relpos_tf32_route(*call) is route1
    assert tfa.relpos_tf32_streamed_route(*call) is route2
    counter = tfa.relpos_counter(*call)
    assert (counter == ROUTE1) is route1 and (counter == ROUTE2) is route2


@pytest.mark.parametrize("ptrs", [(0, 0, 0, 0, 0, 4), (0, 0, 0, 0, 8, 0), (4, 0, 0, 0, 0, 0),
                                  (0, 0, 0, 12, 0, 0)])
@pytest.mark.parametrize("grid", [(2, 255), (72, 36)])
def test_routes_need_every_pointer_on_16_bytes(ptrs, grid):
    """A pointer off 16 bytes keeps either route off: the FMA kernel."""
    rows, cols = grid
    call = (0, 0, 80, rows * cols, rows, cols, 80 ** -0.5, *ptrs)
    assert not tfa.relpos_tf32_route(*call) and not tfa.relpos_tf32_streamed_route(*call)
    assert tfa.relpos_counter(*call) == "flash_attention_relpos"


@pytest.mark.parametrize("dtype,d,wh,ww,counter", [
    (0, 80, 17, 17, ROUTE1),  # 17 x 17 windows past 256 tokens: route 1 (straddling)
    (0, 64, 20, 30, ROUTE1),
    (0, 96, 32, 64, ROUTE1),
    (0, 64, 2, 129, ROUTE2),  # a window wider than 64: route 2
    (0, 80, 1, 257, ROUTE2),
    (0, 16, 1, 257, "flash_attention_relpos"),  # head dim 16: the FMA kernel
    (1, 80, 17, 17, "flash_attention_relpos"),  # bf16: the tile
    (1, 64, 2, 129, "flash_attention_relpos"),
    (0, 80, 14, 14, "window_attention_relpos_tf32"),  # 196 tokens: K5's own kernels
    (0, 80, 16, 16, "window_attention_relpos"),
    (0, 160, 14, 14, "flash_attention_relpos_wide_tf32"),
])
def test_windows_past_256_tokens_take_k4s_f32_routes(dtype, d, wh, ww, counter):
    """K5's f32 windows past 256 tokens (K4's kernels, windows as heads) take
    K4's 3xTF32 routes where they take K4's calls; windows up to 256 tokens
    keep K5's kernels."""
    assert tfa.relpos_counter(1, dtype, d, wh * ww, wh, ww, d ** -0.5, *_A) == counter


@pytest.mark.parametrize("kw,mode", [(64, "wide"), (63, "straddle"), (56, "narrow"),
                                     (65, "streamed"), (128, "streamed"), (300, "streamed")])
def test_relpos_tf32_mode_past_64(kw, mode):
    assert tfa.relpos_tf32_mode(kw) == mode


def test_streamed_counter_is_registered_and_resets():
    dispatch.launch_counts[ROUTE2] += 3
    dispatch.reset_launch_counts()
    assert dispatch.launch_counts[ROUTE2] == 0


@pytest.mark.parametrize("bh,s,d", [(16, 510, 64), (16, 300, 64), (4, 18496, 80), (16, 5184, 80),
                                    (16, 16320, 96), (3, 65, 80), (16, 2592, 80)])
def test_scratch_pads_the_last_tile(bh, s, d):
    """Both routes share the scratch of every 64-key tile's K and V^T images,
    4 BH Sp D floats with Sp = S rounded up to 64 (the pre-pass zeroes the
    last tile's keys past S): 94.7 MB at (4, 18 496, 80)."""
    assert tfa.relpos_tf32_scratch_floats(bh, s, d) == 4 * bh * (-(-s // 64) * 64) * d
    assert tfa.relpos_tf32_scratch_floats(4, 18496, 80) * 4 == 94_699_520


# ------------------------------------------------- the streamed mode's indices
@pytest.mark.parametrize("rows,cols", [(2, 255), (1, 300), (3, 128), (4, 72), (2, 65), (5, 97)])
def test_streamed_fragment_gathers_relpos_bias(rows, cols):
    """The streamed mode's score index arithmetic (two bias_h reads a row:
    grid rows ky and ky + 1; bias_w from the tile's run of 64 columns from
    (64 t) % kw) gathers ``relpos_bias`` at every score of every 64-key tile,
    each (row, key) of the m64n64 tile once; the masked keys are exactly
    those past S in the last tile."""
    s = rows * cols
    gen = torch.Generator().manual_seed(cols)
    bias_h = torch.randn(1, s, rows, generator=gen)
    bias_w = torch.randn(1, s, cols, generator=gen)
    dense = tfa.relpos_bias(bias_h, bias_w, torch.float32)[0]
    n_tiles = -(-s // 64)
    masked = 0
    for t in range(n_tiles):
        regs = [r for warp in range(4) for lane in range(32)
                for r in tfa.relpos_tf32_fragment(0, warp, lane, t, s, cols)]
        assert sorted((r[1], r[2]) for r in regs) == [(w, 64 * t + c) for w in range(64)
                                                      for c in range(64)]
        masked += sum(r[3] is None for r in regs)
        assert all(r[2] >= s for r in regs if r[3] is None)
        live = [r for r in regs if r[3] is not None]
        row, key, ky, kx = (torch.tensor([r[i] for r in live]) for i in range(1, 5))
        assert int(ky.max()) - int(ky.min()) <= 1 and int(kx.max()) < cols
        q = torch.arange(0, s - s % 64, 64)[:, None] + row
        assert torch.equal(bias_h[0][q, ky] + bias_w[0][q, kx], dense[q, key.expand_as(q)])
    assert masked == 64 * (n_tiles * 64 - s)


def test_streamed_slot_is_conflict_free():
    """The bias_w slot of a K stage (the block's 128 rows x 64 floats,
    8-column group g of row r at g ^ (r % 8)): every (row, column) has its
    own float; a copy step (one row, 32 consecutive columns, a float a lane)
    meets each bank once; a read step (a quad's 8-byte pairs of one 8-column
    group for a warp's 8 rows) fills each bank twice, the least 256 bytes
    can, where 64-float rows unswizzled would put all 8 rows in the same 8
    banks."""
    slots = [tfa.relpos_tf32_bw_slot(r, c) for r in range(128) for c in range(64)]
    assert sorted(slots) == list(range(128 * 64))
    for r in range(128):
        for half in (0, 32):
            banks = [tfa.relpos_tf32_bw_slot(r, half + lane) % 32 for lane in range(32)]
            assert sorted(banks) == list(range(32))
    for j in range(8):
        for rows in (range(r0, r0 + 8) for r0 in range(0, 128, 8)):
            banks = [(tfa.relpos_tf32_bw_slot(r, 8 * j + 2 * quad) + e) % 32
                     for r in rows for quad in range(4) for e in range(2)]
            assert all(banks.count(b) == 2 for b in range(32))
        flat = [(r * 64 + 8 * j + c) % 32 for r in range(8) for c in range(8)]
        assert max(flat.count(b) for b in range(32)) == 8


# -------------------------------------------------------------- arithmetic
@pytest.mark.parametrize("d,g,rows,cols,spread,bias_scale", [
    # route 1: kh past 64
    (80, 1, 65, 4, 1.0, 0.5), (96, 1, 65, 4, 3.0, 0.5), (64, 1, 128, 4, 1.0, 3.0),
    (80, 1, 257, 1, 1.0, 0.5), (64, 1, 255, 2, 3.0, 0.5), (80, 1, 66, 8, 1.0, 3.0),
    (96, 1, 65, 16, 1.0, 0.5), (80, 1, 72, 12, 3.0, 3.0),
    # route 2: kw past 64
    (80, 1, 1, 300, 1.0, 0.5), (64, 2, 2, 255, 3.0, 0.5), (96, 1, 2, 255, 1.0, 3.0),
    (80, 1, 4, 72, 3.0, 3.0), (64, 1, 3, 128, 1.0, 0.5), (96, 1, 3, 128, 3.0, 0.5),
    (80, 2, 2, 65, 1.0, 0.5), (64, 1, 5, 97, 1.0, 3.0), (80, 1, 1, 65, 3.0, 0.5)])
def test_mirror_matches_plain_past_64(d, g, rows, cols, spread, bias_scale):
    """The kernel's arithmetic on both routes against the plain version
    within 1e-4, at kh 65 to 257 and kw 65 to 300, at head dims 64, 80 and
    96, at unit scale, spread 3 (peaked rows) and factor scale 3."""
    q, k, v, bias_h, bias_w = _inputs(rows * 1000 + cols + d, g, rows, cols, d, spread,
                                      bias_scale)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("rows,cols,d,spread", [
    (65, 4, 80, 1.0), (128, 4, 64, 3.0), (257, 1, 96, 1.0),  # route 1
    (1, 300, 80, 1.0), (2, 255, 64, 3.0), (4, 72, 96, 1.0), (3, 128, 80, 3.0)])  # route 2
def test_mirror_matches_jax_attend_relpos(jx, rows, cols, d, spread):
    """The mirror against the JAX ``attend_relpos`` in interpret mode in f32
    (its head dim padded to 128 lanes; at most 512 tokens, one block of the
    JAX kernel) within 1e-4, both within 1e-4 of the plain version."""
    q, k, v, bias_h, bias_w = _inputs(rows + cols + d, 1, rows, cols, d, spread)
    got = tfa.relpos_tf32_mirror(q, k, v, bias_h, bias_w, 0)
    want = torch.from_numpy(np.array(jx.fa.attend_relpos(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v, bias_h, bias_w)), cols, interpret=True)))
    plain = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("hw,mode", [((128, 4), "straddle"), ((4, 128), "streamed")])
def test_sam_block_on_the_routes_matches_jax(jx, monkeypatch, hw, mode):
    """The port's SAM attention block (``ViTAttention``, 2 heads of head dim
    80) under ``BFF_SAM_RELPOS_FLASH`` on a route-1 grid (128 x 4) and a
    route-2 grid (4 x 128), both of which ``relpos_shapes_ok`` admits, its
    kernel branch forced and the rel-pos call on the 3xTF32 kernel's
    arithmetic (``relpos_tf32_mirror``), against the JAX block with its
    Pallas branch forced in interpret mode: within rtol 2e-4, atol 2e-5."""
    from beyondff_tpu.kernels import dispatch as jdispatch

    from beyondff_tpu_torch.models import sam as tsam
    from beyondff_tpu_torch.models.convert import _Writer

    jax, jnp = jx.jax, jx.jnp
    assert tfa.relpos_shapes_ok(*hw) and tfa.relpos_tf32_mode(hw[1]) == mode
    dim, heads = 160, 2
    rng = np.random.default_rng(hw[0] * 7 + hw[1])
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
    assert calls == [ROUTE1 if mode == "straddle" else ROUTE2]
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
@pytest.mark.parametrize("d,g,rows,cols,spread,factor_scale", [
    (80, 16, 72, 36, 1.0, 0.1), (80, 4, 80, 64, 1.0, 0.1), (64, 16, 255, 2, 1.0, 0.1),
    (96, 4, 72, 36, 1.0, 0.1), (80, 2, 65, 64, 3.0, 0.1), (96, 2, 65, 64, 1.0, 3.0),
    (64, 2, 130, 32, 1.0, 0.1), (80, 2, 257, 1, 1.0, 0.1), (96, 2, 300, 1, 3.0, 0.1),
    (80, 3, 67, 20, 1.0, 3.0), (64, 1, 129, 63, 1.0, 0.1)])
def test_route1_matches_plain_on_card(cuda_device, d, g, rows, cols, spread, factor_scale):
    """Route 1 (kh past 64 on the wide, narrow and straddling modes) against
    the plain version within 1e-4, one launch counted as
    ``flash_attention_relpos_tf32``."""
    q, k, v, bias_h, bias_w = _card(cuda_device, g, rows, cols, d, spread, factor_scale)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert _moved(before) == [ROUTE1]
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,rows,cols,spread,factor_scale", [
    (64, 16, 2, 255, 1.0, 0.1), (64, 16, 1, 300, 1.0, 0.1), (80, 2, 64, 128, 1.0, 0.1),
    (80, 2, 72, 72, 1.0, 0.1), (96, 4, 3, 128, 1.0, 0.1), (96, 2, 40, 100, 3.0, 0.1),
    (80, 2, 2, 255, 3.0, 0.1), (80, 2, 2, 255, 1.0, 3.0), (64, 3, 1, 65, 1.0, 0.1),
    (80, 1, 7, 333, 1.0, 0.1), (64, 2, 33, 129, 3.0, 3.0)])
def test_route2_matches_plain_on_card(cuda_device, d, g, rows, cols, spread, factor_scale):
    """Route 2 (kw past 64, the streamed mode) against the plain version
    within 1e-4, one launch counted as
    ``flash_attention_relpos_tf32_streamed``."""
    q, k, v, bias_h, bias_w = _card(cuda_device, g, rows, cols, d, spread, factor_scale)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert _moved(before) == [ROUTE2]
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,g,wh,ww,counter", [(80, 16, 17, 17, ROUTE1), (64, 4, 20, 30, ROUTE1),
                                               (64, 4, 2, 129, ROUTE2),
                                               (16, 4, 17, 17, "flash_attention_relpos")])
def test_f32_windows_past_256_tokens_on_card(cuda_device, d, g, wh, ww, counter):
    """K5's f32 windows past 256 tokens on K4's 3xTF32 routes (head dim 16
    on the FMA kernel), within 1e-4 of the window's plain version."""
    q, k, v, bias_h, bias_w = _card(cuda_device, g, wh, ww, d)
    before = dict(dispatch.launch_counts)
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, wh, ww)
    assert _moved(before) == [counter]
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, wh, ww)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("d,rows,cols", [(16, 2, 255), (72, 72, 36), (40, 80, 64)])
def test_other_f32_grids_keep_the_fma_kernel_on_card(cuda_device, d, rows, cols):
    """f32 grids past 64 at head dims neither route takes stay on the FMA
    kernel, counted as ``flash_attention_relpos``, within 1e-4."""
    q, k, v, bias_h, bias_w = _card(cuda_device, 2, rows, cols, d)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    assert _moved(before) == ["flash_attention_relpos"]
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_predicates_match_the_c_side_on_card(cuda_device):
    """Both mirrors say what ``bff_relpos_tf32_takes`` and
    ``bff_relpos_tf32_streamed_takes`` say over kinds, dtypes, head dims,
    grids past 64, scales and alignments."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    grids = ((65, 64), (300, 1), (255, 2), (72, 36), (1, 65), (2, 255), (64, 128), (136, 136),
             (1, 300), (0, 128), (64, 64), (64, 63))
    for kind in (0, 1):
        for dtype in (0, 1):
            for d in (32, 64, 80, 96, 128):
                for rows, cols in grids:
                    for s in (rows * cols, rows * cols + 1):
                        for scale in (d ** -0.5, 0.0, float("inf")):
                            for slot, off in ((0, 0), (1, 8), (5, 4)):
                                ptrs = [4096 * (i + 1) for i in range(6)]
                                ptrs[slot] += off
                                call = (kind, dtype, d, s, rows, cols)
                                for mirror, fn in ((tfa.relpos_tf32_route,
                                                    lib.bff_relpos_tf32_takes),
                                                   (tfa.relpos_tf32_streamed_route,
                                                    lib.bff_relpos_tf32_streamed_takes)):
                                    want = mirror(*call, scale, *ptrs)
                                    got = fn(*call, ctypes.c_float(scale), *ptrs)
                                    assert bool(got) is want, (fn, call, scale, slot)


@pytest.mark.cuda
def test_streamed_route_raises_on_a_failed_launch_on_card(cuda_device, monkeypatch):
    """A code from the C entry raises, naming route 2's counter; nothing
    falls back and nothing is counted."""
    from beyondff_tpu_torch.kernels import _build

    q, k, v, bias_h, bias_w = _card(cuda_device, 2, 2, 255, 64)

    class Failing:
        def __getattr__(self, name):
            return lambda *a: -1

    monkeypatch.setattr(_build, "library", lambda: Failing())
    before = dict(dispatch.launch_counts)
    with pytest.raises(RuntimeError, match=ROUTE2):
        tfa.attend_relpos(q, k, v, bias_h, bias_w, 255)
    assert dispatch.launch_counts == before
