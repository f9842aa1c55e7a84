"""Port kernels (beyondff_tpu_torch.kernels) vs the JAX package's kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode, as tests/test_kernels.py and
tests/test_deform_window.py do. The same numpy inputs feed both. Tests that
need the card carry the ``cuda`` marker and compare each Hopper kernel with
its plain version there; they import nothing of JAX, so on a machine with a
card and no JAX they run with
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.kernels import deform_window as tdw
from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels import flash_attention as tfa
from beyondff_tpu_torch.kernels import mask_iou as tiou
from beyondff_tpu_torch.kernels import window_attention as twa
from beyondff_tpu_torch.models.gdino import deformable as tdeform

torch.set_num_threads(2)


@pytest.fixture
def jx():
    """The JAX package's kernels, imported only by the tests that compare
    against them."""
    import types

    pytest.importorskip("jax")
    import jax.numpy as jnp

    from beyondff_tpu.kernels import deform_window as jdw
    from beyondff_tpu.core import masks as jmasks
    from beyondff_tpu.kernels import flash_attention as jfa
    from beyondff_tpu.kernels import mask_iou as jiou
    from beyondff_tpu.kernels import window_attention as jwa
    from beyondff_tpu.models.gdino import deformable as jdeform

    return types.SimpleNamespace(jnp=jnp, dw=jdw, fa=jfa, deform=jdeform, iou=jiou,
                                 masks=jmasks, wa=jwa)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_kernels.py")
    return torch.device("cuda")


def _qkv(rng, shape):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


# ------------------------------------------------------------------ flash
def test_flash_plain_matches_attend_padded_masked(rng, jx):
    """(2, 600, 32): the JAX attend pads S to 1024 and masks keys >= 600."""
    q, k, v = _qkv(rng, (2, 600, 32))
    want = np.asarray(jx.fa.attend(*map(jx.jnp.asarray, (q, k, v)), interpret=True))
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              valid_len=600, scale=32 ** -0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    got_attend = tfa.attend(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got_attend, want, rtol=2e-4, atol=2e-5)


def test_flash_plain_matches_flash_attention(rng, jx):
    q, k, v = _qkv(rng, (2, 512, 64))
    want = np.asarray(jx.fa.flash_attention(*map(jx.jnp.asarray, (q, k, v)), interpret=True))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_flash_plain_mask_drops_keys(rng):
    """Keys >= valid_len change nothing: same output as attention over the
    valid prefix alone."""
    q, k, v = map(torch.from_numpy, _qkv(rng, (1, 300, 16)))
    full = tfa.flash_attention(q, k, v, valid_len=200)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:] = 1e3
    v2[:, 200:] = -1e3
    np.testing.assert_allclose(tfa.flash_attention(q, k2, v2, valid_len=200).numpy(),
                               full.numpy(), rtol=1e-6, atol=1e-6)


def test_attend_dense_path_matches_jax(rng, jx):
    q, k, v = _qkv(rng, (3, 100, 16))
    want = np.asarray(jx.fa.attend(*map(jx.jnp.asarray, (q, k, v))))
    got = tfa.attend(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


# ---------------------------------------------------- rel-pos attention
def _relpos_inputs(rng, g, rows, cols, d, scale=1.0):
    q, k, v = _qkv(rng, (g, rows * cols, d))
    bias_h = (rng.normal(size=(g, rows * cols, rows)) * scale).astype(np.float32)
    bias_w = (rng.normal(size=(g, rows * cols, cols)) * scale).astype(np.float32)
    return q, k, v, bias_h, bias_w


@pytest.mark.parametrize("bh,rows,cols,d", [(3, 8, 64, 32), (2, 8, 64, 80)])
def test_relpos_plain_matches_attend_relpos(rng, jx, bh, rows, cols, d):
    """K4: the plain version and the CPU wrapper against the JAX
    ``attend_relpos`` in interpret mode, at tests/test_kernels.py's grid and
    at SAM ViT-H's head dim 80 (the JAX wrapper pads it to 128)."""
    q, k, v, bias_h, bias_w = _relpos_inputs(rng, bh, rows, cols, d)
    want = np.asarray(jx.fa.attend_relpos(*map(jx.jnp.asarray, (q, k, v, bias_h, bias_w)),
                                          cols, interpret=True))
    args = list(map(torch.from_numpy, (q, k, v, bias_h, bias_w)))
    before = dispatch.launch_counts["flash_attention_relpos"]
    for got in (tfa.attend_relpos_plain(*args, cols), tfa.attend_relpos(*args, cols)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    assert dispatch.launch_counts["flash_attention_relpos"] == before


@pytest.mark.parametrize("g,wh,ww,d", [(3, 4, 5, 16), (2, 14, 14, 80)])
def test_window_relpos_plain_matches_pallas(rng, jx, g, wh, ww, d):
    """K5: the plain version and the CPU wrapper against the JAX
    ``window_attention_relpos`` in interpret mode, at tests/test_kernels.py's
    (3, 4 x 5, 16) and at SAM ViT-H's 14 x 14 window with head dim 80."""
    q, k, v, bias_h, bias_w = _relpos_inputs(rng, g, wh, ww, d, scale=0.5)
    want = np.asarray(jx.wa.window_attention_relpos(
        *map(jx.jnp.asarray, (q, k, v, bias_h, bias_w)), wh, ww, interpret=True))
    args = list(map(torch.from_numpy, (q, k, v, bias_h, bias_w)))
    for got in (twa.window_attention_relpos_plain(*args, wh, ww),
                twa.window_attention_relpos(*args, wh, ww)):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_relpos_shapes_ok_matches_jax(jx):
    grids = [(h, w) for h in (1, 4, 8, 14, 16, 24, 32, 48, 64, 70, 96)
             for w in (1, 8, 14, 16, 24, 32, 48, 64, 70, 128, 512)]
    assert [tfa.relpos_shapes_ok(h, w) for h, w in grids] == \
        [jx.fa.relpos_shapes_ok(h, w) for h, w in grids]
    assert tfa.relpos_shapes_ok(64, 64) and not tfa.relpos_shapes_ok(14, 14)


def test_relpos_plain_rounds_factors_to_the_inputs_dtype(rng):
    """bf16 inputs: the factors round to bf16 and add in f32, as the JAX
    wrapper casts them to the inputs' dtype before its f32 selector dot."""
    q, k, v, bias_h, bias_w = (torch.from_numpy(a) for a in _relpos_inputs(rng, 1, 4, 8, 16))
    lo = [t.bfloat16() for t in (q, k, v)]
    got = tfa.attend_relpos_plain(*lo, bias_h, bias_w, 8)
    want = tfa.attend_relpos_plain(*lo, bias_h.bfloat16(), bias_w.bfloat16(), 8)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_relpos_wrappers_check_on_cpu():
    meta = torch.empty(1, 16, 8, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention_relpos(meta, meta, meta, meta[..., :4], meta[..., :4], 4)
    with pytest.raises(ValueError):
        twa.window_attention_relpos_plain(*(torch.zeros(1, 15, 8),) * 3,
                                          torch.zeros(1, 15, 4), torch.zeros(1, 15, 4), 4, 4)


# ------------------------------------------------------------- deformable
SHAPES3 = ((12, 16), (6, 8), (3, 4))


def _raster(shapes):
    cs = []
    for h, w in shapes:
        ys = (np.arange(h) + 0.5) / h
        xs = (np.arange(w) + 0.5) / w
        cs.append(np.stack(np.meshgrid(xs, ys, indexing="xy"), -1).reshape(-1, 2))
    return np.concatenate(cs, 0)


def _deform_inputs(rng, shapes, b=1, heads=2, hd=8, p=3, max_off=3.0):
    q = sum(h * w for h, w in shapes)
    centers = _raster(shapes)
    value = rng.normal(size=(b, q, heads, hd)).astype(np.float32)
    locs = np.zeros((b, q, heads, len(shapes), p, 2), np.float32)
    for li, (h, w) in enumerate(shapes):
        off = rng.uniform(-max_off, max_off, (b, q, heads, p, 2))
        locs[:, :, :, li, :, 0] = centers[None, :, None, None, 0] + off[..., 0] / w
        locs[:, :, :, li, :, 1] = centers[None, :, None, None, 1] + off[..., 1] / h
    aw = rng.uniform(0.1, 1.0, (b, q, heads, len(shapes), p)).astype(np.float32)
    return value, locs, aw


def test_deform_exact_matches_ms_deform_attn(rng, jx):
    """3-level raster with samples inside, on the edge of and outside the map."""
    value, locs, aw = _deform_inputs(rng, SHAPES3)
    locs[:, ::7, :, :, 0] = 0.0                       # on the left edge
    locs[:, 1::7, :, :, 1] = 1.0                      # on the bottom edge
    locs[:, 2::7, :, :, 0] = -0.3                     # outside
    locs[:, 3::7, :, :, 1] = 1.7                      # outside
    locs[:, 4::7, :, :, 0] = -1.0 / 32                # half a cell outside
    want = np.asarray(jx.deform.ms_deform_attn(
        jx.jnp.asarray(value), SHAPES3, jx.jnp.asarray(locs), jx.jnp.asarray(aw)))
    got = tdw.ms_deform_sample(torch.from_numpy(value), SHAPES3, torch.from_numpy(locs),
                               torch.from_numpy(aw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


SHAPES4 = ((20, 30), (10, 15), (5, 8), (3, 4))


@pytest.mark.parametrize("tile,radius", [(8, 8), (16, 8)])
def test_deform_clamp_matches_sample_level_windowed(rng, jx, tile, radius):
    """One level in clamp mode vs the Pallas kernel in interpret mode, with
    samples beyond the window and outside the map."""
    level = 0
    value, locs, aw = _deform_inputs(rng, SHAPES4, max_off=2.5 * radius)
    locs[:, ::5, :, level, :, 0] += 3.0                # far outside the map
    h, w = SHAPES4[level]
    v = value[:, :h * w]
    gx = locs[:, :, :, level, :, 0] * w - 0.5
    gy = locs[:, :, :, level, :, 1] * h - 0.5
    assign = jx.dw.build_assignment(SHAPES4, level, tile)
    want = np.asarray(jx.dw.sample_level_windowed(
        *map(jx.jnp.asarray, (v, gx, gy, aw[:, :, :, level])),
        assign, h, w, radius=radius, interpret=True))
    only = np.zeros_like(aw)
    only[:, :, :, level] = aw[:, :, :, level]
    modes = [(tile, radius)] + [None] * (len(SHAPES4) - 1)
    got = tdw.ms_deform_sample(torch.from_numpy(value), SHAPES4, torch.from_numpy(locs),
                               torch.from_numpy(only), modes).numpy()
    np.testing.assert_allclose(got, want.reshape(got.shape), atol=1e-5, rtol=1e-4)
    assert np.abs(want).max() > 0


def test_build_assignment_matches_jax(jx):
    for level, tile in [(0, 16), (1, 8), (2, 8)]:
        a = jx.dw.build_assignment(SHAPES4, level, tile)
        b = tdw.build_assignment(SHAPES4, level, tile)
        for name in ("idx", "valid", "inv"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert (a.nty, a.ntx, a.s_pad) == (b.nty, b.ntx, b.s_pad)


def test_ms_deform_attn_windowed_matches_jax(rng, jx, monkeypatch):
    """The per-level tile/radius selection: the full windowed call on a
    raster whose largest level exceeds the small-level threshold, JAX
    (Pallas interpret) vs port (plain clamp), and decoder-style queries
    staying exact."""
    shapes = ((36, 40), (18, 20), (9, 10))
    value, locs, aw = _deform_inputs(rng, shapes, p=2, max_off=12.0)
    monkeypatch.setenv("BFF_DEFORM_WINDOWED", "1")
    want = np.asarray(jx.deform.ms_deform_attn(
        jx.jnp.asarray(value), shapes, jx.jnp.asarray(locs), jx.jnp.asarray(aw), windowed=True))
    assert tdeform.level_modes(shapes) == ((16, 8), (8, 8), (8, 8))
    tv, tl, ta = map(torch.from_numpy, (value, locs, aw))
    got = tdeform.ms_deform_attn(tv, shapes, tl, ta, windowed=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    exact = tdeform.ms_deform_attn(tv, shapes, tl, ta, windowed=False).numpy()
    assert np.abs(got - exact).max() > 1e-3  # clamp mode really engaged
    dec = tdeform.ms_deform_attn(tv, shapes, tl[:, :32], ta[:, :32], windowed=True).numpy()
    np.testing.assert_allclose(dec, exact[:, :32], rtol=1e-6, atol=1e-7)


def test_windowing_off_cpu_needs_the_env(monkeypatch):
    v = torch.zeros(1, 4, 1, 1)
    monkeypatch.delenv("BFF_DEFORM_WINDOWED", raising=False)
    assert not tdeform._use_windowed(True, v)
    monkeypatch.setenv("BFF_DEFORM_WINDOWED", "1")
    assert tdeform._use_windowed(True, v) and not tdeform._use_windowed(False, v)
    monkeypatch.setenv("BFF_DEFORM_WINDOWED", "0")
    assert not tdeform._use_windowed(True, v)


# ---------------------------------------------------------------- mask IoU
def _iou_masks(rng, ia, ib, n):
    a = rng.random((ia, n)) < rng.uniform(0.05, 0.6, (ia, 1))
    b = rng.random((ib, n)) < rng.uniform(0.05, 0.6, (ib, 1))
    a[::6] = False  # empty rows: 0/0 = nan against empty rows of b
    b[1::4] = False
    b[min(2, ib - 1)] = a[min(1, ia - 1)]  # a pair with IoU exactly 1
    return a, b


def _assert_bit_equal(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got.view(np.int32)[~np.isnan(got)],
                                  want.view(np.int32)[~np.isnan(want)])


@pytest.mark.parametrize("ia,ib,n", [(37, 5, 3001), (130, 129, 2049), (1, 1, 1)])
def test_mask_iou_plain_matches_pallas_bit_for_bit(rng, jx, ia, ib, n):
    """Ragged shapes, empty rows: the plain version against the Pallas kernel
    in interpret mode and the JAX package's XLA version, cross and self."""
    a, b = _iou_masks(rng, ia, ib, n)
    for bb in (b, None):
        got = tiou.pairwise_iou(torch.from_numpy(a),
                                None if bb is None else torch.from_numpy(bb)).numpy()
        _assert_bit_equal(got, np.asarray(jx.iou.pad_and_iou(a, bb, interpret=True)))
        _assert_bit_equal(got, np.asarray(jx.masks.pairwise_iou(
            jx.jnp.asarray(a), None if bb is None else jx.jnp.asarray(bb))))
        _assert_bit_equal(tiou.pairwise_iou_plain(
            torch.from_numpy(a), None if bb is None else torch.from_numpy(bb)).numpy(), got)
    assert np.isnan(got).any()


def test_mask_iou_wrapper_checks_on_cpu():
    a = torch.zeros(3, 10, dtype=torch.bool)
    before = dispatch.launch_counts["mask_iou"]
    assert tiou.pairwise_iou(a, torch.zeros(0, 10, dtype=torch.bool)).shape == (3, 0)
    assert torch.isnan(tiou.pairwise_iou(a)).all()
    assert dispatch.launch_counts["mask_iou"] == before  # the plain version counts nothing
    with pytest.raises(ValueError):
        tiou.pairwise_iou(a.to("meta"))


def test_wrappers_reject_other_devices():
    meta = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError):
        dispatch.kernel_device(torch.zeros(1), meta)


# --------------------------------------------------------------- on the card
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(8, 900, 32, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    got = tfa.flash_attention(q, k, v, valid_len=900)
    want = tfa.flash_attention_plain(q, k, v, valid_len=900)
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_kernel_matches_plain_on_card(cuda_device, dtype):
    rng = np.random.default_rng(0)
    value, locs, aw = _deform_inputs(rng, SHAPES4, heads=8, hd=32, p=4, max_off=12.0)
    tv = torch.from_numpy(value).to(cuda_device, dtype)
    tl = torch.from_numpy(locs).to(cuda_device)
    ta = torch.from_numpy(aw).to(cuda_device, dtype)
    modes = tdeform.level_modes(SHAPES4)
    for m in (modes, (None,) * len(SHAPES4)):
        got = tdw.ms_deform_sample(tv, SHAPES4, tl, ta, m)
        want = tdw.ms_deform_sample_plain(tv, SHAPES4, tl, ta, m)
        tol = 1e-4 if dtype == torch.float32 else 3e-2
        assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("ia,ib,n", [(37, 5, 3001), (600, None, 250_000), (20, 150, 250_000),
                                     (65, 130, 4096), (200, None, 10_007)])
def test_mask_iou_kernel_matches_plain_on_card(cuda_device, ia, ib, n):
    """Bit for bit, nan where the plain version puts it; ``ib`` None is a
    self-IoU. With N not a multiple of 16, rows start off 16-byte
    boundaries and the kernel cuts them out of aligned loads."""
    rng = np.random.default_rng(0)
    a, b = _iou_masks(rng, ia, ib or 8, n)
    ta = torch.from_numpy(a).to(cuda_device)
    tb = None if ib is None else torch.from_numpy(b).to(cuda_device)
    before = dispatch.launch_counts["mask_iou"]
    got = tiou.pairwise_iou(ta, tb)
    want = tiou.pairwise_iou_plain(ta, tb)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["mask_iou"] == before + 1
    _assert_bit_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [1, 3, 8, 13])
def test_mask_iou_kernel_takes_masks_at_any_address(cuda_device, shift):
    """Masks that start ``shift`` bytes into their storage (a contiguous
    view), so no row lies on a 16-byte boundary of its own."""
    rng = np.random.default_rng(shift)
    a, b = _iou_masks(rng, 70, 9, 4099)
    ta = torch.zeros(shift + a.size, dtype=torch.bool, device=cuda_device)
    ta[shift:] = torch.from_numpy(a.reshape(-1)).to(cuda_device)
    ta = ta[shift:].view(a.shape)
    tb = torch.from_numpy(b).to(cuda_device)
    for other in (None, tb):
        got = tiou.pairwise_iou(ta, other)
        want = tiou.pairwise_iou_plain(ta, other)
        _assert_bit_equal(got.cpu().numpy(), want.cpu().numpy())


def _assert_within_one_rounding(got, want):
    """f32: within 1e-4. bf16: within one bf16 rounding of the plain value
    (2 ** -7 of its magnitude), plus the f32 tolerance for values near 0."""
    diff = (got.float() - want.float()).abs()
    rel = 0.0 if got.dtype == torch.float32 else 2.0 ** -7
    assert bool((diff <= rel * want.float().abs() + 1e-4).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,rows,cols,d", [(2, 64, 64, 80), (3, 10, 37, 48), (1, 16, 32, 128)])
def test_flash_relpos_kernel_matches_plain_on_card(cuda_device, dtype, bh, rows, cols, d):
    """K4 against its plain version: SAM ViT-H's 64 x 64 global grid, a
    ragged grid (S = 370, not a multiple of the 64-row tiles) and head dim
    128. f32 within 1e-4, bf16 within one output rounding."""
    q, k, v, bias_h, bias_w = (torch.from_numpy(a).to(cuda_device) for a in
                               _relpos_inputs(np.random.default_rng(rows), bh, rows, cols, d))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = dispatch.launch_counts["flash_attention_relpos"]
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["flash_attention_relpos"] == before + 1
    _assert_within_one_rounding(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,wh,ww,d", [(6, 14, 14, 80), (5, 4, 5, 16), (2, 16, 16, 64)])
def test_window_relpos_kernel_matches_plain_on_card(cuda_device, dtype, g, wh, ww, d):
    q, k, v, bias_h, bias_w = (torch.from_numpy(a).to(cuda_device) for a in
                               _relpos_inputs(np.random.default_rng(wh), g, wh, ww, d))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    before = dispatch.launch_counts["window_attention_relpos"]
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, wh, ww)
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, wh, ww)
    torch.cuda.synchronize()
    assert dispatch.launch_counts["window_attention_relpos"] == before + 1
    _assert_within_one_rounding(got, want)
