"""K4 at head dims 144 to 256 on the wide kernels, one block holding the
whole head dim.

bf16 takes the wgmma/TMA kernel of ``csrc/relpos_attention_wide_wgmma.cu``
on any grid, each 64-key tile's factor columns streamed into shared memory
by each warp for its own rows (``relpos_wide_wgmma_route``; counter
``flash_attention_relpos_wide_wgmma``); f32, on any grid too, takes the
3xTF32 wgmma kernel of
``csrc/relpos_attention_wide_tf32.cu`` (``relpos_wide_tf32_route``; counter
``flash_attention_relpos_wide_tf32``). K5's windows that run K4's kernels
take them too.

On the CPU: the wgmma kernel's factor plan (``relpos_stream_layout`` /
``relpos_stream_stage`` / ``relpos_stream_offsets`` with bias_w whole up to
64 grid columns and one slot: every key of every tile finds its own two
factors), both kernels' arithmetic (``relpos_wide_wgmma_mirror``,
``relpos_wide_tf32_mirror``) against ``attend_relpos_plain`` and the JAX
``attend_relpos`` run as the JAX tests run it (``interpret=True``), the
3xTF32 kernel's plan, and the route rules against the counter. The ``cuda``
cases hold each route on the card against its plain version and its counter,
each C predicate against its mirror, and the displaced kernels at the shapes
they keep; they import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_relpos_wide.py``.
Tolerances: f32 1e-4, bf16 ``flash_attention.bf16_error_bound``.
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
_A = (0, 256, 512, 1024, 2048, 4096)  # six 16-byte aligned pointers
WIDE_WGMMA = "flash_attention_relpos_wide_wgmma"
WIDE_TF32 = "flash_attention_relpos_wide_tf32"
_FIXED, _SLOTS = tfa.RELPOS_WIDE_FIXED_W, tfa.RELPOS_WIDE_SLOTS


@pytest.fixture
def jx():
    import types

    pytest.importorskip("jax")
    import jax.numpy as jnp

    from beyondff_tpu.kernels import flash_attention as jfa

    return types.SimpleNamespace(jnp=jnp, fa=jfa)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_relpos_wide.py")
    return torch.device("cuda")


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(3))


def _factors(seed, g, rows, cols, scale=0.5):
    rng = np.random.default_rng(seed + 1)
    s = rows * cols
    return (torch.from_numpy((rng.standard_normal((g, s, rows)) * scale).astype(np.float32)),
            torch.from_numpy((rng.standard_normal((g, s, cols)) * scale).astype(np.float32)))


def _within(got, want, q, k, v, bias_h=None, bias_w=None):
    """f32 within 1e-4; bf16 within ``bf16_error_bound``."""
    if got.dtype == torch.float32:
        return float((got.float() - want.float()).abs().max()) <= TOL
    bound = tfa.bf16_error_bound(q, k, v, want, bias_h=bias_h, bias_w=bias_w)
    return float(((got.float() - want.float()).abs() - bound).max()) <= 0.0


# ------------------------------------------ the wgmma kernel's factor plan
@pytest.mark.parametrize("kw", [1, 2, 7, 31, 32, 36, 63, 64, 65, 127, 136, 160, 255, 300, 4096])
def test_wide_layout_fits_beside_the_operands(kw):
    """A warp's table row holds one slot (bias_h's columns of a tile, 62 / kw
    + 2 at most with a word for the parity; past 64 grid columns bias_w's 64
    in two pieces, 34 words) and, up to 64 columns, bias_w whole; its stride
    is 8 past a multiple of 16 and at most 88 elements, so the block's 128
    rows (22 528 bytes) fit beside the operands at DP 256: 768 DP bytes, the
    barriers and the 1024 bytes of alignment within 232 448."""
    lay = tfa.relpos_stream_layout(kw, _FIXED, _SLOTS)
    assert 2 * lay["h_words"] >= 62 // kw + 3
    assert lay["w_words"] == (34 if kw > _FIXED else 0)
    assert 2 * lay["fixed_words"] >= (kw + 1 if kw <= _FIXED else 0)
    assert lay["ld"] >= 2 * (_SLOTS * lay["slot_words"] + lay["fixed_words"])
    assert lay["ld"] % 16 == 8 and lay["ld"] <= 88
    assert 768 * 256 + 128 + 1024 + 128 * lay["ld"] * 2 <= 232448


# grids inside and past the factor table, widths below, at and past 64
_PLAN_GRIDS = [(8, 8), (32, 32), (32, 36), (5, 7), (1, 255), (2, 255), (1, 300), (3, 97),
               (300, 1), (130, 65), (64, 64), (16, 17), (7, 300), (97, 161)]


@pytest.mark.parametrize("kh,kw", _PLAN_GRIDS)
def test_wide_plan_finds_every_factor(kh, kw):
    """Every key of every tile finds its own two factors through the wide
    kernel's plan (bias_w whole up to 64 grid columns, one slot): the flat
    indices of both factor arrays (bias_h positive, bias_w negative) staged
    word by word, read back through the offsets of each row's parity, in
    the first and last blocks of two heads and, past 128 rows, the second
    block of the second head; rows past S zero."""
    g, s = 2, kh * kw
    lay = tfa.relpos_stream_layout(kw, _FIXED, _SLOTS)
    fh = np.arange(g * s * kh, dtype=np.int64) + 1
    fw = -(np.arange(g * s * kw, dtype=np.int64) + 1)
    blocks = {(0, 0), (g - 1, (s - 1) // 128 * 128)}
    if s > 128:
        blocks.add((1, 128))
    for h, q0 in sorted(blocks):
        row0 = h * s + q0
        table = np.zeros((128, lay["ld"]), np.int64)
        tfa.relpos_stream_fixed(table, fw, kw, s, row0, q0, _FIXED, _SLOTS)
        nr = min(128, s - q0)
        big_r = row0 + np.arange(128)
        for k0 in range(0, s, 64):
            tfa.relpos_stream_stage(table, fh, fw, kh, kw, s, row0, q0, k0, _FIXED, _SLOTS)
            assert (table[nr:] == 0).all()
            keys = k0 + np.arange(64)
            for rho in (0, 1):
                hoff, woff, live = tfa.relpos_stream_offsets(kh, kw, s, k0, rho, _FIXED, _SLOTS)
                assert (live == (keys < s)).all()
                sel = np.nonzero((big_r[:nr] & 1) == rho)[0]
                ky, kx = keys[live] // kw, keys[live] % kw
                assert (table[sel][:, hoff[live]] == big_r[sel, None] * kh + ky[None] + 1).all()
                assert (table[sel][:, woff[live]] == -(big_r[sel, None] * kw + kx[None] + 1)).all()


@pytest.mark.parametrize("kh,kw", [(8, 8), (2, 255), (3, 97), (32, 36), (130, 3)])
def test_staged_bias_is_the_dense_bias(kh, kw):
    """The bias the kernel reads through its table equals the dense
    ``relpos_bias`` of the bf16 factors at every row and key before S, and
    the padding past S is zero."""
    bias_h, bias_w = _factors(kh + kw, 2, kh, kw)
    bh, bw = bias_h.bfloat16(), bias_w.bfloat16()
    got = tfa.relpos_staged_bias(bh, bw, kw)
    s = kh * kw
    assert torch.equal(got[:, :s, :s], tfa.relpos_bias(bh, bw, torch.bfloat16))
    assert not got[:, s:].any() and not got[:, :, s:].any()


# --------------------------------------------------------------- arithmetic
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,kw,d", [(8, 8, 160), (8, 8, 256), (2, 255, 160), (1, 300, 256),
                                     (3, 97, 176), (5, 7, 144)])
def test_wide_wgmma_mirror_matches_plain(dtype, kh, kw, d):
    """The wgmma kernel's arithmetic (staged factors, the lazy max, P rounded
    before P V) against ``attend_relpos_plain``: within ``bf16_error_bound``
    in bf16, 1e-4 in f32."""
    q, k, v = (t.to(dtype) for t in _qkv(kh * kw + d, (2, kh * kw, d)))
    bias_h, bias_w = _factors(d, 2, kh, kw)
    got = tfa.relpos_wide_wgmma_mirror(q, k, v, bias_h, bias_w, kw)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, kw)
    assert _within(got, want, q, k, v, bias_h, bias_w)


@pytest.mark.parametrize("kh,kw,d,spread,bias_scale", [
    (8, 8, 160, 1.0, 0.5), (8, 8, 256, 1.0, 0.5), (16, 16, 192, 1.0, 0.5), (5, 36, 160, 1.0, 0.5),
    (1, 255, 240, 1.0, 0.5), (5, 7, 224, 1.0, 0.5), (8, 8, 160, 3.0, 0.5), (9, 17, 256, 1.0, 3.0)])
def test_wide_tf32_mirror_matches_plain(kh, kw, d, spread, bias_scale):
    """The 3xTF32 kernel's arithmetic (Q, K, V and P split, the products from
    zero and the bias added after them, each tile's P V summed apart) within
    1e-4 of ``attend_relpos_plain`` in f32, on peaked rows (q and k at 3x)
    and at factor scale 3 too."""
    q, k, v = _qkv(kh * kw + d, (2, kh * kw, d))
    q, k = q * spread, k * spread
    bias_h, bias_w = _factors(d, 2, kh, kw, bias_scale)
    got = tfa.relpos_wide_tf32_mirror(q, k, v, bias_h, bias_w, kw)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, kw)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("kh,kw,d", [(8, 8, 160), (16, 16, 256), (1, 300, 160)])
def test_wide_mirrors_match_jax(jx, kh, kw, d):
    """Both mirrors against the JAX ``attend_relpos`` (interpret mode): the
    3xTF32 one in f32 within 1e-4 (inside the factor table, where it is
    routed), the wgmma one's f32 arithmetic within 1e-4, and in bf16 the
    JAX kernel and the wgmma mirror each within ``bf16_error_bound`` of the
    port's plain version."""
    q, k, v = _qkv(kh * kw + d, (2, kh * kw, d))
    bias_h, bias_w = _factors(d, 2, kh, kw)
    want = np.asarray(jx.fa.attend_relpos(*(jx.jnp.asarray(t.numpy())
                                            for t in (q, k, v, bias_h, bias_w)),
                                          kw, interpret=True))
    if tfa.relpos_factor_table(kh, kw):
        got = tfa.relpos_wide_tf32_mirror(q, k, v, bias_h, bias_w, kw).numpy()
        assert float(np.abs(got - want).max()) <= TOL
    got = tfa.relpos_wide_wgmma_mirror(q, k, v, bias_h, bias_w, kw).numpy()
    assert float(np.abs(got - want).max()) <= TOL
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    jb = [jx.jnp.asarray(t.float().numpy()).astype(jx.jnp.bfloat16) for t in (qb, kb, vb)]
    jbias = [jx.jnp.asarray(t.numpy()).astype(jx.jnp.bfloat16) for t in (bias_h, bias_w)]
    got_jax = torch.from_numpy(np.array(jx.fa.attend_relpos(*jb, *jbias, kw, interpret=True)
                                        .astype(jx.jnp.float32)))
    plain = tfa.attend_relpos_plain(qb, kb, vb, bias_h, bias_w, kw)
    mirror = tfa.relpos_wide_wgmma_mirror(qb, kb, vb, bias_h, bias_w, kw)
    bound = tfa.bf16_error_bound(qb, kb, vb, plain, bias_h=bias_h, bias_w=bias_w)
    assert float(((got_jax - plain.float()).abs() - bound).max()) <= 0.0
    assert float(((mirror.float() - plain.float()).abs() - bound).max()) <= 0.0


@pytest.mark.parametrize("d", tfa.WIDE_WGMMA_HEAD_DIMS)
def test_wide_tf32_plan_fits(d):
    """The 3xTF32 kernel's plan at each head dim: D rounded up to 32, 32-key
    tiles (16 at DP 256), fold parts that cover DP, and Q's images for 64
    rows with one K and one V^T stage within the 232 448 bytes a block may
    hold; 64-key tiles would not fit at any DP, nor 32-key tiles at DP 256."""
    plan = tfa.relpos_wide_tf32_plan(d)
    dp = plan["dp"]
    assert dp - d in (0, 16) and plan["fold"] * plan["parts"] == dp
    assert plan["fold"] % 8 == 0 and plan["fold"] <= 112
    assert plan["smem"] <= 232448
    assert 2 * 64 * dp * 4 + 4 * 64 * dp * 4 > 232448
    if dp == 256:
        assert plan["keys"] == 16 and 2 * 64 * dp * 4 + 4 * 32 * dp * 4 > 232448
    else:
        assert plan["keys"] == 32


# ------------------------------------------------------------------ routes
_BAD_FAC = _A[:4] + (2050, 4096)  # bias_h on 2 bytes
_FAC4 = _A[:4] + (2052, 4100)     # both factors on 4 bytes, not 16


@pytest.mark.parametrize("kind,dtype,d,rows,cols,ptrs,taken", [
    (0, 1, 160, 32, 32, _A, True), (0, 1, 256, 32, 32, _A, True), (0, 1, 160, 2, 255, _A, True),
    (0, 1, 144, 1, 300, _A, True), (0, 1, 240, 136, 136, _A, True), (1, 1, 160, 14, 14, _A, True),
    (1, 1, 208, 17, 17, _A, True), (0, 1, 160, 2, 255, _FAC4, True),
    (0, 1, 160, 2, 255, _BAD_FAC, False), (0, 1, 160, 32, 32, (8,) + _A[1:], False),
    (0, 1, 168, 32, 32, _A, False), (0, 1, 128, 32, 32, _A, False), (0, 1, 272, 32, 32, _A, False),
    (0, 0, 160, 32, 32, _A, False), (2, 1, 160, 32, 32, _A, False)])
def test_relpos_wide_wgmma_route(kind, dtype, d, rows, cols, ptrs, taken):
    """The wgmma route takes bf16 K4 (and K5's windows on K4's kernels) at
    head dims 144 to 256 in steps of 16 on any grid, q, k, v and o on 16
    bytes and the factors on 4; f32, other head dims and off-alignment calls
    keep their kernels."""
    s = rows * cols
    assert tfa.relpos_wide_wgmma_route(kind, dtype, d, s, rows, cols, d ** -0.5, *ptrs) is taken


@pytest.mark.parametrize("kind,dtype,d,rows,cols,ptrs,taken", [
    (0, 0, 160, 32, 32, _A, True), (0, 0, 256, 32, 32, _A, True), (0, 0, 160, 32, 36, _A, True),
    (0, 0, 144, 1, 255, _A, True), (0, 0, 224, 5, 7, _A, True), (1, 0, 160, 14, 14, _A, True),
    (0, 0, 160, 2, 255, _A, True), (0, 0, 160, 1, 300, _A, True),
    (0, 0, 160, 32, 32, _FAC4, False), (0, 0, 176, 32, 32, _A[:3] + (8, 2048, 4096), False),
    (0, 0, 168, 32, 32, _A, False), (0, 0, 128, 32, 32, _A, False), (0, 1, 160, 32, 32, _A, False),
    (2, 0, 160, 32, 32, _A, False), (0, 0, 256, 136, 136, _A, True),
    (0, 0, 160, 300, 1, _A, True), (0, 0, 160, 2, 255, _FAC4, False)])
def test_relpos_wide_tf32_route(kind, dtype, d, rows, cols, ptrs, taken):
    """The 3xTF32 route takes f32 K4 (and K5's windows on K4's kernels) at
    head dims 144 to 256 in steps of 16 on any grid (inside and past kh + kw
    = 256: the kernel reads the factors from device memory) with every
    pointer on 16 bytes; off 16 bytes and at other head dims the FMA kernel
    stays."""
    s = rows * cols
    assert tfa.relpos_wide_tf32_route(kind, dtype, d, s, rows, cols, d ** -0.5, *ptrs) is taken


@pytest.mark.parametrize("args,counter", [
    ((0, 1, 160, 1024, 32, 32), WIDE_WGMMA), ((0, 1, 256, 1024, 32, 32), WIDE_WGMMA),
    ((0, 1, 160, 510, 2, 255), WIDE_WGMMA), ((1, 1, 160, 196, 14, 14), WIDE_WGMMA),
    ((1, 1, 160, 289, 17, 17), WIDE_WGMMA), ((0, 0, 160, 1024, 32, 32), WIDE_TF32),
    ((0, 0, 256, 1024, 32, 32), WIDE_TF32), ((0, 0, 160, 1152, 32, 36), WIDE_TF32),
    ((1, 0, 160, 196, 14, 14), WIDE_TF32),
    ((0, 0, 160, 510, 2, 255), WIDE_TF32),
    ((0, 1, 168, 1024, 32, 32), "flash_attention_relpos"),
    ((0, 0, 264, 1024, 32, 32), "flash_attention_relpos"),
    ((0, 1, 128, 510, 2, 255), "flash_attention_relpos_streamed"),
    ((0, 1, 80, 4096, 64, 64), "flash_attention_relpos_wgmma"),
    ((0, 0, 96, 3072, 64, 48), "flash_attention_relpos_tf32")])
def test_wide_counter_table(args, counter):
    """Which counter a rel-pos call moves: the two wide routes at their
    shapes (K5's windows at those head dims too, f32 past the table as
    well), the slices for head dims outside the routes, and the older
    routes at theirs."""
    kind, dtype, d, s, rows, cols = args
    assert tfa.relpos_counter(kind, dtype, d, s, rows, cols, d ** -0.5, *_A) == counter


@pytest.mark.parametrize("name,source", [
    ("relpos_wide_tf32_fold_halves", "relpos_attention_wide_tf32.cu"),
    ("relpos_wide_tf32_fold_64", "relpos_attention_wide_tf32.cu")])
def test_wide_variant_edits_match_the_sources(name, source):
    """``tools/kernel_variants.py``'s variants of the 3xTF32 route (its P V
    folded in other column parts) are one edit each that matches its source once, and both sources are built
    with every K4/K5 variant (the rel-pos entries call them)."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    sources, edits = kv.VARIANTS[name]
    assert source in sources and len(edits) == 1
    for fname, old, new in edits:
        assert fname == source
        with open(os.path.join(_build.CSRC, fname)) as f:
            assert f.read().count(old) == 1
        assert new != old
    assert {kv.RWW, kv.RWT} <= set(kv.K45) and {kv.RWW, kv.RWT} <= set(kv.SOURCES)


def test_wide_counters_are_registered():
    """Both routes count under launch counters of their own."""
    for name in (WIDE_WGMMA, WIDE_TF32):
        assert name in dispatch.launch_counts


def test_wide_shapes_on_cpu_take_the_plain_version():
    """CPU tensors at the routes' shapes take ``attend_relpos_plain`` and
    move no counter."""
    q, k, v = _qkv(3, (1, 64, 160))
    bias_h, bias_w = _factors(3, 1, 8, 8)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, 8)
    assert dispatch.launch_counts == before
    assert torch.equal(got, tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 8,
                                                    scale=160 ** -0.5))


# ------------------------------------------------------------------ the card
def _one_launch(before, key):
    moved = [n for n, c in dispatch.launch_counts.items() if c != before[n]]
    assert moved == [key], moved
    assert dispatch.launch_counts[key] == before[key] + 1


def _relpos_card(dev, g, rows, cols, d, dtype, scale=0.5, spread=1.0):
    gen = torch.Generator(device=dev).manual_seed(g * rows * cols + d)
    s = rows * cols
    q, k, v = (torch.randn(g, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (q * spread).to(dtype), (k * spread).to(dtype), v.to(dtype)
    bias_h = (scale * torch.randn(g, s, rows, generator=gen, device=dev)).to(dtype)
    bias_w = (scale * torch.randn(g, s, cols, generator=gen, device=dev)).to(dtype)
    return q, k, v, bias_h, bias_w


def _run(dev, key, g, rows, cols, d, dtype, **kw):
    q, k, v, bias_h, bias_w = _relpos_card(dev, g, rows, cols, d, dtype, **kw)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    _one_launch(before, key)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _within(got, want, q, k, v, bias_h, bias_w), float((got.float() - want.float())
                                                             .abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows,cols,d", [
    (16, 32, 32, 160), (16, 2, 255, 160), (16, 32, 32, 256), (2, 1, 300, 144), (2, 3, 97, 176),
    (2, 17, 17, 208), (1, 1, 8, 224), (2, 5, 7, 240), (2, 130, 65, 192), (1, 64, 64, 256),
    (3, 36, 32, 160), (1, 300, 1, 160)])
def test_wide_wgmma_matches_plain_on_card(cuda_device, g, rows, cols, d):
    """bf16 K4 at head dims 144 to 256 inside and past the factor table: one
    launch counted as ``flash_attention_relpos_wide_wgmma``, within
    ``bf16_error_bound``: grids of one row and one column, widths below, at
    and past 64 (the fixed part and the streamed pieces), S below one tile
    and ragged."""
    _run(cuda_device, WIDE_WGMMA, g, rows, cols, d, torch.bfloat16)


@pytest.mark.cuda
def test_wide_wgmma_peaked_rows_and_odd_factor_words_on_card(cuda_device):
    """Peaked rows (q and k at 4x, the running max raised often) with the
    factor bases 4 bytes past a 16-byte boundary (the route asks 4): within
    the bound."""
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, 4, 3, 301, 160, torch.bfloat16,
                                           spread=4.0)
    bufs = [torch.empty(t.numel() + 2, dtype=torch.bfloat16, device=cuda_device)
            for t in (bias_h, bias_w)]
    bias_h, bias_w = (b[2:].view(t.shape).copy_(t) for b, t in zip(bufs, (bias_h, bias_w)))
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, 301)
    _one_launch(before, WIDE_WGMMA)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 301)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, bias_h, bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows,cols,d,scale,spread", [
    (16, 32, 32, 160, 0.5, 1.0), (16, 32, 32, 256, 0.5, 1.0), (8, 32, 36, 160, 0.5, 1.0),
    (2, 8, 8, 144, 0.5, 1.0), (2, 16, 16, 192, 0.5, 1.0), (3, 5, 7, 224, 0.5, 1.0),
    (1, 1, 255, 240, 0.5, 1.0), (2, 9, 17, 176, 0.5, 1.0), (4, 32, 32, 160, 3.0, 1.0),
    (4, 24, 24, 256, 0.5, 3.0), (1, 100, 100, 208, 0.5, 1.0), (16, 2, 255, 160, 0.5, 1.0),
    (2, 1, 300, 144, 0.5, 1.0), (2, 300, 1, 256, 0.5, 1.0)])
def test_wide_tf32_matches_plain_on_card(cuda_device, g, rows, cols, d, scale, spread):
    """f32 K4 at head dims 144 to 256 inside and past the factor table: one
    launch counted as ``flash_attention_relpos_wide_tf32``, within 1e-4 of
    the plain version: square grids, a width no multiple of 8 (32 x 36), S
    below one tile and ragged, factor scale 3, peaked rows (q and k at 3x),
    and grids past kh + kw = 256 (2 x 255, one row, one column)."""
    _run(cuda_device, WIDE_TF32, g, rows, cols, d, torch.float32, scale=scale, spread=spread)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,g,wh,ww,d,key", [
    (torch.bfloat16, 6, 14, 14, 160, WIDE_WGMMA), (torch.bfloat16, 3, 17, 17, 256, WIDE_WGMMA),
    (torch.float32, 6, 14, 14, 160, WIDE_TF32), (torch.float32, 3, 17, 17, 224, WIDE_TF32)])
def test_wide_routes_take_windows_on_card(cuda_device, dtype, g, wh, ww, d, key):
    """K5's windows at head dims past 128 run K4's kernels: at 144 to 256
    the wide routes, within tolerance of the window's plain version."""
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, g, wh, ww, d, dtype)
    before = dict(dispatch.launch_counts)
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, wh, ww)
    _one_launch(before, key)
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, wh, ww)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, bias_h, bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bf16_d168", "bf16_d264", "bf16_q_off_16_bytes",
                                  "f32_d264_past_table", "f32_d168", "f32_factors_off_16_bytes"])
def test_displaced_kernels_keep_their_shapes_on_card(cuda_device, case):
    """The calls the wide routes leave keep the tile's slices (bf16 at head
    dims 168 and 264) or the FMA kernel (bf16 off 16 bytes; f32 at head dims
    264 past the factor table and 168, and with a factor off 16 bytes),
    counted as ``flash_attention_relpos``, within tolerance."""
    dtype = torch.bfloat16 if case.startswith("bf16") else torch.float32
    d = {"bf16_d168": 168, "bf16_d264": 264, "f32_d168": 168, "f32_d264_past_table": 264}.get(
        case, 160)
    rows, cols = (2, 255) if case == "f32_d264_past_table" else (16, 16)
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, 2, rows, cols, d, dtype)
    if case == "bf16_q_off_16_bytes":
        buf = torch.empty(q.numel() + 4, dtype=dtype, device=cuda_device)
        q = buf[4:].view(q.shape).copy_(q)
    if case == "f32_factors_off_16_bytes":
        buf = torch.empty(bias_w.numel() + 1, dtype=dtype, device=cuda_device)
        bias_w = buf[1:].view(bias_w.shape).copy_(bias_w)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    _one_launch(before, "flash_attention_relpos")
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, bias_h, bias_w)


@pytest.mark.cuda
def test_wide_predicates_match_the_c_side_on_card(cuda_device):
    """``bff_relpos_wide_wgmma_takes`` answers as ``relpos_wide_wgmma_route``
    and ``bff_relpos_wide_tf32_takes`` as ``relpos_wide_tf32_route`` over
    kinds, dtypes, head dims, grids and alignments."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    aligned = [4096 * (i + 1) for i in range(6)]
    offsets = ((0, 0, 0), (8, 0, 0), (0, 2, 0), (0, 4, 12), (0, 16, 0))
    for kind in (0, 1, 2):
        for dtype in (0, 1):
            for d in (128, 136, 144, 160, 168, 176, 240, 256, 264, 272):
                for kh, kw in ((32, 32), (2, 255), (1, 300), (1, 255), (128, 128), (129, 128),
                               (14, 14), (5, 7)):
                    for off_q, off_h, off_w in offsets:
                        ptrs = aligned[:4] + [aligned[4] + off_h, aligned[5] + off_w]
                        ptrs[0] += off_q
                        args = (kind, dtype, d, kh * kw, kh, kw)
                        for mirror, cfn in (
                                (tfa.relpos_wide_wgmma_route, lib.bff_relpos_wide_wgmma_takes),
                                (tfa.relpos_wide_tf32_route, lib.bff_relpos_wide_tf32_takes)):
                            want = mirror(*args, d ** -0.5, *ptrs)
                            got = cfn(*args, ctypes.c_float(d ** -0.5), *ptrs)
                            assert bool(got) is want, (mirror.__name__, args, ptrs)
