"""The two bf16 routes that keep shapes past the old limits on tensor cores.

K4 with kh + kw past 256 (and K5's windows that run K4's kernels there)
takes the mma.sync tile with each 64-key tile's factor columns staged into
a ring slot beside its K and V (``relpos_streamed_route``; counter
``flash_attention_relpos_streamed``); bf16 flash attention at head dims 144
to 256 takes the wgmma/TMA kernel of ``csrc/flash_attention_wide_wgmma.cu``,
each block holding the whole head dim (``wide_wgmma_route``; counter
``flash_attention_wide_wgmma``).

On the CPU: the streamed slice plan (``relpos_stream_stage`` /
``relpos_stream_offsets``: every key of every tile finds its own two
factors), its softmax mirror against ``attend_relpos_plain`` and the JAX
``attend_relpos`` run as the JAX tests run it (``interpret=True``), the wide
kernel's box plan and its tile walk (``wide_wgmma_mirror``) against
``flash_attention_plain`` and the JAX ``attend`` / ``_flash_masked``, and
the route rules. The ``cuda`` cases hold each route on the card against its
plain version and its counter, the displaced kernels at their remaining
shapes, and each C predicate against its mirror; they import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_tc_past_limits.py``.
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
                    "python -m pytest --noconftest -m cuda tests/test_torch_tc_past_limits.py")
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


def _within(got, want, q, k, v, valid=None, bias_h=None, bias_w=None):
    """f32 within 1e-4; bf16 within ``bf16_error_bound``."""
    if got.dtype == torch.float32:
        return float((got - want).abs().max()) <= TOL
    bound = tfa.bf16_error_bound(q, k, v, want, valid, bias_h=bias_h, bias_w=bias_w)
    return float(((got.float() - want.float()).abs() - bound).max()) <= 0.0


# ------------------------------------------------- route A: streamed factors
@pytest.mark.parametrize("kw", [1, 2, 7, 31, 63, 64, 65, 127, 128, 136, 160, 161, 300, 4096])
def test_stream_layout_holds_a_tile(kw):
    """A slot holds the tile's bias_h columns (62 / kw + 2 at most, one word
    more for the parity) and, past 160 columns, bias_w's 64 columns in two
    pieces (34 words); up to 160 the fixed table holds all kw columns; the
    row stride holds both slots and the table, is 8 past a multiple of 16
    and keeps the table within 184 elements a row (two blocks an SM at head
    dim 80)."""
    lay = tfa.relpos_stream_layout(kw)
    nh = 62 // kw + 2
    assert nh <= 64
    assert 2 * lay["h_words"] >= nh + 1
    assert lay["w_words"] == (34 if kw > tfa.STREAM_FIXED_W else 0)
    assert 2 * lay["fixed_words"] >= (kw + 1 if kw <= tfa.STREAM_FIXED_W else 0)
    assert lay["ld"] >= 2 * (2 * lay["slot_words"] + lay["fixed_words"])
    assert lay["ld"] % 16 == 8 and lay["ld"] <= 184


# grids past the table and a few inside it (the plan holds for any grid)
_PLAN_GRIDS = [(300, 1), (257, 1), (256, 2), (250, 7), (194, 63), (200, 63), (193, 64),
               (192, 65), (130, 127), (129, 128), (136, 136), (100, 160), (96, 161),
               (1, 300), (2, 255), (3, 301), (7, 300), (97, 300), (16, 16), (3, 97)]


@pytest.mark.parametrize("kh,kw", _PLAN_GRIDS)
def test_stream_plan_finds_every_factor(kh, kw):
    """Every key of every tile finds its own two factors: the slice plan
    stages the flat indices of both factor arrays (bias_h positive, bias_w
    negative) word by word into the table, and each row reads back, through
    the offsets of its parity, bias_h[R, ky] and bias_w[R, kx] for every
    key before S: in the first and last blocks of two heads (S odd or even,
    so the heads' rows start at both parities; rows past S zero) and, for
    kh * kw past 128, the second block of the second head."""
    g, s = 2, kh * kw
    lay = tfa.relpos_stream_layout(kw)
    fh = np.arange(g * s * kh, dtype=np.int64) + 1
    fw = -(np.arange(g * s * kw, dtype=np.int64) + 1)
    blocks = {(0, 0), (g - 1, (s - 1) // 128 * 128)}
    if s > 128:
        blocks.add((1, 128))
    for h, q0 in sorted(blocks):
        row0 = h * s + q0
        table = np.zeros((128, lay["ld"]), np.int64)
        tfa.relpos_stream_fixed(table, fw, kw, s, row0, q0)
        nr = min(128, s - q0)
        big_r = row0 + np.arange(128)
        for k0 in range(0, s, 64):
            tfa.relpos_stream_stage(table, fh, fw, kh, kw, s, row0, q0, k0)
            assert (table[nr:] == 0).all()
            keys = k0 + np.arange(64)
            for rho in (0, 1):
                hoff, woff, live = tfa.relpos_stream_offsets(kh, kw, s, k0, rho)
                assert (live == (keys < s)).all()
                sel = np.nonzero((big_r[:nr] & 1) == rho)[0]
                got_h = table[sel][:, hoff[live]]
                got_w = table[sel][:, woff[live]]
                ky, kx = keys[live] // kw, keys[live] % kw
                assert (got_h == big_r[sel, None] * kh + ky[None] + 1).all(), (h, q0, k0, rho)
                assert (got_w == -(big_r[sel, None] * kw + kx[None] + 1)).all(), (h, q0, k0, rho)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kh,kw,d", [(1, 300, 32), (1, 300, 64), (2, 255, 32), (2, 255, 64),
                                     (3, 97, 32), (3, 97, 64)])
def test_streamed_mirror_matches_plain(dtype, kh, kw, d):
    """The streamed route's arithmetic (factors through the slots, P rounded
    before P V per tile) against ``attend_relpos_plain`` of the same inputs:
    within ``bf16_error_bound`` in bf16, 1e-4 in f32."""
    q, k, v = (t.to(dtype) for t in _qkv(kh * kw + d, (2, kh * kw, d)))
    bias_h, bias_w = _factors(d, 2, kh, kw)
    got = tfa.relpos_streamed_mirror(q, k, v, bias_h, bias_w, kw)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, kw)
    assert _within(got, want, q, k, v, bias_h=bias_h, bias_w=bias_w)


@pytest.mark.parametrize("kh,kw,d", [(1, 300, 32), (2, 255, 64), (3, 97, 32)])
def test_streamed_mirror_matches_jax(jx, kh, kw, d):
    """The same mirror against the JAX ``attend_relpos`` (interpret mode):
    in f32 within 1e-4, and in bf16 within ``bf16_error_bound`` of the
    port's plain version, as the JAX kernel (P rounded to bf16 too) is."""
    q, k, v = _qkv(kh * kw + d, (2, kh * kw, d))
    bias_h, bias_w = _factors(d, 2, kh, kw)
    want = np.asarray(jx.fa.attend_relpos(*(jx.jnp.asarray(t.numpy())
                                            for t in (q, k, v, bias_h, bias_w)),
                                          kw, interpret=True))
    got = tfa.relpos_streamed_mirror(q, k, v, bias_h, bias_w, kw).numpy()
    assert float(np.abs(got - want).max()) <= TOL
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    jb = [jx.jnp.asarray(t.float().numpy()).astype(jx.jnp.bfloat16) for t in (qb, kb, vb)]
    jbias = [jx.jnp.asarray(t.numpy()).astype(jx.jnp.bfloat16) for t in (bias_h, bias_w)]
    got_jax = torch.from_numpy(np.array(jx.fa.attend_relpos(*jb, *jbias, kw, interpret=True)
                                        .astype(jx.jnp.float32)))
    plain = tfa.attend_relpos_plain(qb, kb, vb, bias_h, bias_w, kw)
    mirror = tfa.relpos_streamed_mirror(qb, kb, vb, bias_h, bias_w, kw)
    bound = tfa.bf16_error_bound(qb, kb, vb, plain, bias_h=bias_h, bias_w=bias_w)
    assert float(((got_jax - plain.float()).abs() - bound).max()) <= 0.0
    assert float(((mirror.float() - plain.float()).abs() - bound).max()) <= 0.0


@pytest.mark.parametrize("kind,dtype,d,rows,cols,ptrs,taken", [
    (0, 1, 64, 1, 300, _A, True), (0, 1, 64, 2, 255, _A, True), (0, 1, 80, 136, 136, _A, True),
    (0, 1, 128, 300, 1, _A, True), (0, 1, 8, 257, 1, _A, True), (0, 1, 64, 128, 128, _A, False),
    (0, 0, 64, 1, 300, _A, False), (0, 1, 160, 1, 300, _A, False), (0, 1, 60, 1, 300, _A, False),
    (0, 1, 64, 1, 300, _A[:4] + (2050, 4096), False), (0, 1, 64, 1, 300, (8,) + _A[1:], False),
    (0, 1, 64, 1, 300, _A[:4] + (2052, 4100), True), (1, 1, 32, 1, 257, _A, True),
    (1, 1, 32, 1, 256, _A, False), (1, 1, 80, 17, 17, _A, False), (2, 1, 64, 1, 300, _A, False)])
def test_relpos_streamed_route(kind, dtype, d, rows, cols, ptrs, taken):
    """The streamed route takes bf16 K4 past the table at head dims up to 128
    on the tile's alignment (d % 8, q, k, v, o on 16 bytes) with factors on 4
    bytes, and K5's windows past 256 tokens there; f32, head dims past 128,
    off-alignment calls and grids inside the table keep their kernels."""
    s = rows * cols
    assert tfa.relpos_streamed_route(kind, dtype, d, s, rows, cols, d ** -0.5, *ptrs) is taken


# ---------------------------------------------- route B: the whole head dim
@pytest.mark.parametrize("d", tfa.WIDE_WGMMA_HEAD_DIMS)
def test_wide_boxes_cover_each_feature_once(d):
    """The wide kernel's TMA boxes cover every feature of the head dim rounded
    up to 32 exactly once (the 16 columns past a head dim of 144, 176, 208 or
    240 zero-filled by the TMA): 64-column boxes in the 128-byte swizzle,
    then at most one 32-column box (64-byte swizzle), each starting on a
    multiple of 4 KB of its 64-row tile, the tile 128 bytes a padded column."""
    boxes = tfa.wide_wgmma_boxes(d)
    dp = -(-d // 32) * 32
    assert dp - d in (0, 16)
    seen = np.zeros(dp, np.int64)
    for col, width, swizzle, off in boxes:
        seen[col:col + width] += 1
        assert swizzle == 2 * width and off % 4096 == 0
    assert (seen == 1).all()
    assert [w for _c, w, _s, _o in boxes if w != 64] == ([32] if dp % 64 else [])
    assert sum(64 * w * 2 for _c, w, _s, _o in boxes) == 128 * dp


@pytest.mark.parametrize("dtype,d,s,valid,ptrs,taken", [
    (1, 160, 1024, 1024, _A[:4], True), (1, 256, 300, 300, _A[:4], True),
    (1, 144, 1, 1, _A[:4], True), (1, 240, 1024, 900, _A[:4], True),
    (1, 264, 300, 300, _A[:4], False), (1, 168, 300, 300, _A[:4], False),
    (1, 128, 300, 300, _A[:4], False), (0, 160, 300, 300, _A[:4], False),
    (1, 160, 300, 0, _A[:4], False), (1, 160, 300, 301, _A[:4], False),
    (1, 160, 300, 300, (2,) + _A[1:4], False)])
def test_wide_wgmma_route(dtype, d, s, valid, ptrs, taken):
    """The wide route: bf16 at head dims 144 to 256 in steps of 16, any valid
    length, 16-byte aligned pointers."""
    assert tfa.wide_wgmma_route(dtype, d, s, valid, d ** -0.5, *ptrs) is taken


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,valid,d", [(2, 300, 300, 160), (2, 300, 251, 160),
                                          (1, 256, 256, 256), (2, 300, 190, 256),
                                          (1, 130, 130, 176), (1, 200, 1, 144)])
def test_wide_mirror_matches_plain(dtype, bh, s, valid, d):
    """The wide kernel's tile walk (two 64-row warpgroups a block, the whole
    head dim, 64-key tiles up to ``valid_len``) against
    ``flash_attention_plain``: 1e-4 in f32, ``bf16_error_bound`` in bf16."""
    q, k, v = (t.to(dtype) for t in _qkv(s + d + valid, (bh, s, d)))
    got = tfa.wide_wgmma_mirror(q, k, v, valid)
    want = tfa.flash_attention_plain(q, k, v, valid)
    assert _within(got, want, q, k, v, valid)


@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("valid", [256, 200])
def test_wide_mirror_matches_jax(jx, d, valid):
    """Against the JAX kernels in interpret mode at S 256: ``attend`` (every
    key valid, ``flash_attention``) and ``_flash_masked`` (keys past 200
    masked), within 1e-4 in f32."""
    q, k, v = _qkv(d + valid, (2, 256, d))
    jq, jk, jv = (jx.jnp.asarray(t.numpy()) for t in (q, k, v))
    if valid == 256:
        want = np.asarray(jx.fa.attend(jq, jk, jv, interpret=True))
    else:
        want = np.asarray(jx.fa._flash_masked(jq, jk, jv, valid, True, d ** -0.5))
    got = tfa.wide_wgmma_mirror(q, k, v, valid).numpy()
    assert float(np.abs(got - want).max()) <= TOL


@pytest.mark.parametrize("name,source", [("relpos_stream_l2", "relpos_attention_streamed.cu"),
                                         ("wide_serial", "flash_attention_wide_wgmma.cu"),
                                         ("wide_no_pingpong", "flash_attention_wide_wgmma.cu")])
def test_variant_edits_match_the_sources(name, source):
    """``tools/kernel_variants.py``'s variants of the two routes
    (``relpos_stream_l2``: the factors read from device memory instead of
    staged; ``wide_serial``, ``wide_no_pingpong``: the wide kernel without
    its overlap or its pingpong) are one edit each that matches its source
    once, and the wide kernel's source is built with the K2/K3 variants and
    the parent tree."""
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
    assert kv.WIDE in kv.K3 and kv.WIDE in kv.SOURCES


def test_new_counters_are_registered():
    """Both new routes count under their own launch counters."""
    for name in ("flash_attention_relpos_streamed", "flash_attention_wide_wgmma"):
        assert name in dispatch.launch_counts


# ------------------------------------------------------------------ the card
def _one_launch(before, key):
    moved = [n for n, c in dispatch.launch_counts.items() if c != before[n]]
    assert moved == [key], moved
    assert dispatch.launch_counts[key] == before[key] + 1


def _relpos_card(dev, g, rows, cols, d, dtype, scale=0.5):
    gen = torch.Generator(device=dev).manual_seed(g * rows * cols + d)
    s = rows * cols
    q, k, v = (torch.randn(g, s, d, generator=gen, device=dev).to(dtype) for _ in range(3))
    bias_h = (scale * torch.randn(g, s, rows, generator=gen, device=dev)).to(dtype)
    bias_w = (scale * torch.randn(g, s, cols, generator=gen, device=dev)).to(dtype)
    return q, k, v, bias_h, bias_w


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows,cols,d", [
    (2, 1, 300, 32), (2, 2, 255, 64), (1, 3, 301, 80), (1, 200, 100, 16), (3, 1, 257, 8),
    (1, 300, 1, 64), (1, 250, 7, 64), (1, 194, 63, 128), (1, 129, 128, 80), (2, 130, 127, 72),
    (1, 136, 136, 80), (2, 7, 300, 128)])
def test_streamed_route_matches_plain_on_card(cuda_device, g, rows, cols, d):
    """bf16 K4 past the factor table on the tile with streamed factors: one
    launch counted as ``flash_attention_relpos_streamed``, within
    ``bf16_error_bound`` of the plain version, over wide and narrow grids,
    odd and even widths and head dims 8 to 128."""
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, g, rows, cols, d, torch.bfloat16)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    _one_launch(before, "flash_attention_relpos_streamed")
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _within(got, want, q, k, v, bias_h=bias_h, bias_w=bias_w)


@pytest.mark.cuda
def test_streamed_route_factors_at_odd_words_on_card(cuda_device):
    """Factor bases 4 bytes past a 16-byte boundary (the route asks 4): the
    streamed route, within the bound."""
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, 2, 3, 301, 64, torch.bfloat16)
    bufs = [torch.empty(t.numel() + 2, dtype=torch.bfloat16, device=cuda_device)
            for t in (bias_h, bias_w)]
    bias_h, bias_w = (b[2:].view(t.shape).copy_(t) for b, t in zip(bufs, (bias_h, bias_w)))
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, 301)
    _one_launch(before, "flash_attention_relpos_streamed")
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 301)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, bias_h=bias_h, bias_w=bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("g,wh,ww,d,key", [
    (4, 1, 257, 32, "flash_attention_relpos_streamed"),
    (2, 1, 300, 64, "flash_attention_relpos_streamed"),
    (3, 17, 17, 80, "flash_attention_relpos")])
def test_streamed_route_windows_on_card(cuda_device, g, wh, ww, d, key):
    """K5's windows past 256 tokens run K4's kernels: past the table on the
    streamed route, inside it on the tile."""
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, g, wh, ww, d, torch.bfloat16)
    before = dict(dispatch.launch_counts)
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, wh, ww)
    _one_launch(before, key)
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, wh, ww)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, bias_h=bias_h, bias_w=bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d168", "factors_off_4_bytes", "f32"])
def test_past_the_table_outside_the_route_keeps_fma_on_card(cuda_device, case):
    """Calls past the table that the streamed route leaves keep the FMA
    kernel reading the factors from device memory (``flash_attention_relpos``):
    bf16 at head dim 168 (160 takes the wide wgmma kernel,
    tests/test_torch_relpos_wide.py), bf16 factors off 4 bytes, f32 at head
    dim 16 (at the multiples of 16 from 32 to 128 the 3xTF32 kernel's
    streamed mode takes it, tests/test_torch_relpos_tf32_grids.py and
    tests/test_torch_relpos_tf32_dims.py)."""
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    d = 168 if case == "d168" else 16 if case == "f32" else 64
    q, k, v, bias_h, bias_w = _relpos_card(cuda_device, 1, 2, 255, d, dtype)
    if case == "factors_off_4_bytes":
        buf = torch.empty(bias_h.numel() + 1, dtype=dtype, device=cuda_device)
        bias_h = buf[1:].view(bias_h.shape).copy_(bias_h)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, 255)
    _one_launch(before, "flash_attention_relpos")
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 255)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, bias_h=bias_h, bias_w=bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,valid,d", [
    (2, 300, 300, 160), (2, 300, 251, 160), (2, 256, 256, 256), (2, 1024, 900, 256),
    (1, 200, 77, 144), (2, 130, 130, 176), (1, 64, 1, 208), (3, 1000, 999, 224),
    (1, 129, 64, 240), (2, 1, 1, 192), (1, 4096, 4096, 256), (4, 333, 200, 160)])
def test_wide_wgmma_matches_plain_on_card(cuda_device, bh, s, valid, d):
    """bf16 at head dims 144 to 256: one launch of the wide kernel
    (``flash_attention_wide_wgmma``), masked and unmasked, ragged S, within
    ``bf16_error_bound`` of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(s + d + valid)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    _one_launch(before, "flash_attention_wide_wgmma")
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _within(got, want, q, k, v, valid)


@pytest.mark.cuda
def test_wide_wgmma_peaked_rows_on_card(cuda_device):
    """Peaked rows (q and k at 4x), where the running max is raised often:
    within the bound."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = (torch.randn(4, 700, 192, generator=g, device=cuda_device) for _ in range(3))
    q, k, v = (q * 4).bfloat16(), (k * 4).bfloat16(), v.bfloat16()
    got = tfa.flash_attention(q, k, v, valid_len=650)
    want = tfa.flash_attention_plain(q, k, v, valid_len=650)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, 650)


@pytest.mark.cuda
@pytest.mark.parametrize("d,offset", [(264, 0), (168, 0), (136, 0), (160, 1)])
def test_wide_leaves_keep_their_kernels_on_card(cuda_device, d, offset):
    """bf16 past head dim 128 outside the wide route: D 264, 168 and 136 on
    the tile's slices, q off 16 bytes on the FMA kernel's, both counted as
    ``flash_attention``, within the bound."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = (torch.randn(2, 300, d, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    if offset:
        buf = torch.empty(q.numel() + offset, dtype=torch.bfloat16, device=cuda_device)
        q = buf[offset:].view(q.shape).copy_(q)
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=280)
    _one_launch(before, "flash_attention")
    want = tfa.flash_attention_plain(q, k, v, valid_len=280)
    torch.cuda.synchronize()
    assert _within(got, want, q, k, v, 280)


@pytest.mark.cuda
def test_new_predicates_match_the_c_side_on_card(cuda_device):
    """``bff_flash_wide_wgmma_takes`` answers as ``wide_wgmma_route`` and
    ``bff_relpos_streamed_takes`` as ``relpos_streamed_route`` over dtypes,
    head dims, lengths, grids and alignments."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    aligned = [4096 * (i + 1) for i in range(6)]
    for dtype in (0, 1):
        for d in range(120, 272, 8):
            for s, valid in ((1, 1), (300, 300), (300, 200), (300, 0), (300, 301)):
                for ptrs in (aligned[:4], [aligned[0] + 8] + aligned[1:4]):
                    want = tfa.wide_wgmma_route(dtype, d, s, valid, d ** -0.5, *ptrs)
                    got = lib.bff_flash_wide_wgmma_takes(dtype, d, s, valid,
                                                         ctypes.c_float(d ** -0.5), *ptrs)
                    assert bool(got) is want, (dtype, d, s, valid, ptrs)
    for kind in (0, 1, 2):
        for dtype in (0, 1):
            for d in (8, 60, 64, 128, 136):
                for kh, kw in ((1, 300), (1, 256), (1, 255), (2, 255), (300, 1), (128, 128),
                               (129, 128), (16, 17)):
                    for fac in ((aligned[4], aligned[5]), (aligned[4] + 2, aligned[5]),
                                (aligned[4] + 4, aligned[5] + 12)):
                        ptrs = aligned[:4] + list(fac)
                        want = tfa.relpos_streamed_route(kind, dtype, d, kh * kw, kh, kw,
                                                         d ** -0.5, *ptrs)
                        got = lib.bff_relpos_streamed_takes(kind, dtype, d, kh * kw, kh, kw,
                                                            ctypes.c_float(d ** -0.5), *ptrs)
                        assert bool(got) is want, (kind, dtype, d, kh, kw, fac)
