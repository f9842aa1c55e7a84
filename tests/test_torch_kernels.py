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
from beyondff_tpu_torch.kernels import nms as tnms
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


@pytest.mark.parametrize("s", [512, 1000])
def test_flash_plain_matches_attend_at_head_dim_64(rng, jx, s):
    """K3's function at EfficientSAM's head dim: the JAX ``attend`` (the
    Pallas kernel in interpret mode; S = 1000 padded to 1024 with keys
    masked) against the port's plain version, every key valid."""
    q, k, v = _qkv(rng, (2, s, 64))
    want = np.asarray(jx.fa.attend(*map(jx.jnp.asarray, (q, k, v)), interpret=True))
    got = tfa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), valid_len=s).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tfa.attend(*map(torch.from_numpy, (q, k, v))).numpy(), want,
                               rtol=2e-4, atol=2e-5)


_SCALE = 64 ** -0.5


@pytest.mark.parametrize("args,takes", [
    ((1, 64, 4096, 4096, _SCALE, 0, 256, 512, 1024), True),  # EfficientSAM-S's global blocks
    ((1, 64, 3072, 3072, _SCALE, 0, 16, 32, 48), True),  # the rect grid, 16-byte bases
    ((1, 64, 1, 1, 1.0, 0, 0, 0, 0), True),  # any S >= 1
    ((1, 64, 4095, 4095, 2.0, 0, 0, 0, 0), True),  # a ragged S, any positive scale
    ((1, 64, 4096, 4095, _SCALE, 0, 0, 0, 0), False),  # keys masked: K2's tile
    ((0, 64, 4096, 4096, _SCALE, 0, 0, 0, 0), False),  # f32: the FMA kernel
    ((1, 32, 900, 900, 32 ** -0.5, 0, 0, 0, 0), False),  # Grounding-DINO's head dim
    ((1, 80, 4096, 4096, 80 ** -0.5, 0, 0, 0, 0), False),  # SAM ViT-H's head dim
    ((1, 128, 1024, 1024, 128 ** -0.5, 0, 0, 0, 0), False),
    ((1, 64, 4096, 4096, _SCALE, 0, 8, 0, 0), False),  # k off 16 bytes
    ((1, 64, 4096, 4096, _SCALE, 0, 0, 0, 2), False),  # the output off 16 bytes
    ((1, 64, 4096, 4096, 0.0, 0, 0, 0, 0), False),
    ((1, 64, 4096, 4096, -_SCALE, 0, 0, 0, 0), False),
    ((1, 64, 4096, 4096, float("inf"), 0, 0, 0, 0), False),
    ((1, 64, 4096, 4096, float("nan"), 0, 0, 0, 0), False),
    ((1, 64, 4096, 4096, 1e39, 0, 0, 0, 0), False),  # inf once rounded to f32
])
def test_wgmma_route_pins_the_predicate(args, takes):
    """The Python mirror of ``bff_flash_wgmma_takes`` (which decides, in
    ``bff_flash_attention``, the calls the wgmma kernel takes and the
    counter they count under): bf16, head dim 64, every key valid, a
    positive finite f32 scale, 16-byte aligned q, k, v and output."""
    assert tfa.wgmma_route(*args) is takes


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


def _bf16_excess(got, want, bound):
    """The largest amount by which |got - want| exceeds ``bound`` (<= 0 when
    every element is within it)."""
    return float(((got.float() - want.float()).abs() - bound).max())


def test_relpos_bf16_pallas_within_derived_bound(rng, jx):
    """The JAX ``attend_relpos`` in bf16 (interpret mode) rounds P to bf16
    before P V, as the Hopper kernel does; it lies within the derived bound
    2^-8 (|P| @ |V|) + 2^-7 |plain| + 1e-4 of the port's plain version in
    bf16, the bound the card holds the CUDA kernel to."""
    q, k, v, bias_h, bias_w = _relpos_inputs(rng, 2, 8, 64, 80)
    jb = jx.jnp.bfloat16
    want = jx.fa.attend_relpos(*(jx.jnp.asarray(a, jb) for a in (q, k, v)),
                               jx.jnp.asarray(bias_h), jx.jnp.asarray(bias_w), 64,
                               interpret=True)
    jax_out = torch.from_numpy(np.array(want.astype(jx.jnp.float32)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    th, tw = torch.from_numpy(bias_h), torch.from_numpy(bias_w)
    plain = tfa.attend_relpos_plain(tq, tk, tv, th, tw, 64)
    bound = tfa.bf16_error_bound(tq, tk, tv, plain, bias_h=th, bias_w=tw)
    assert _bf16_excess(jax_out, plain, bound) <= 0.0
    # P's rounding is what the bound's first term covers: the output
    # rounding alone (2^-7 |plain| + 1e-4) does not hold the TPU kernel
    assert _bf16_excess(jax_out, plain, 2.0 ** -7 * plain.float().abs() + 1e-4) > 0.0


@pytest.mark.parametrize("g,wh,ww,d", [(4, 14, 14, 80), (3, 5, 7, 16)])
def test_window_relpos_bf16_pallas_within_derived_bound(rng, jx, g, wh, ww, d):
    """K5: the JAX ``window_attention_relpos`` in bf16 (interpret mode)
    rounds its softmax to bf16 before P V, so it lies within the derived
    bound 2^-8 (|P| @ |V|) + 2^-7 |plain| + 1e-4 of the port's plain
    version, the bound the card holds the bf16 Hopper kernel to; at SAM
    ViT-H's 14 x 14 x 80 window and at a ragged 5 x 7 x 16 one."""
    q, k, v, bias_h, bias_w = _relpos_inputs(rng, g, wh, ww, d, scale=0.5)
    jb = jx.jnp.bfloat16
    want = jx.wa.window_attention_relpos(*(jx.jnp.asarray(a, jb) for a in (q, k, v)),
                                         jx.jnp.asarray(bias_h), jx.jnp.asarray(bias_w), wh, ww,
                                         interpret=True)
    jax_out = torch.from_numpy(np.array(want.astype(jx.jnp.float32)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    th, tw = torch.from_numpy(bias_h), torch.from_numpy(bias_w)
    plain = twa.window_attention_relpos_plain(tq, tk, tv, th, tw, wh, ww)
    bound = tfa.bf16_error_bound(tq, tk, tv, plain, bias_h=th, bias_w=tw)
    assert _bf16_excess(jax_out, plain, bound) <= 0.0


def test_flash_bf16_pallas_within_derived_bound(rng, jx):
    """K2: the JAX ``attend`` in bf16 (interpret mode; S = 600 padded to
    1024, keys >= 600 masked) within the derived bound of the port's plain
    version, and within K2's 1.6e-2."""
    q, k, v = _qkv(rng, (2, 600, 32))
    want = jx.fa.attend(*(jx.jnp.asarray(a, jx.jnp.bfloat16) for a in (q, k, v)),
                        interpret=True)
    jax_out = torch.from_numpy(np.array(want.astype(jx.jnp.float32)))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    plain = tfa.flash_attention_plain(tq, tk, tv, valid_len=600)
    assert _bf16_excess(jax_out, plain, tfa.bf16_error_bound(tq, tk, tv, plain, 600)) <= 0.0
    assert _bf16_excess(jax_out, plain, 2.0 ** -7 * plain.float().abs() + 1e-4) > 0.0
    assert float((jax_out - plain.float()).abs().max()) <= 1.6e-2


@pytest.mark.parametrize("change", ["edit", "add"])
def test_build_digest_covers_headers(tmp_path, monkeypatch, change):
    """The library's hash covers every file under csrc: editing a shared
    header, or adding one, names a new library (no stale build loads)."""
    import shutil

    from beyondff_tpu_torch.kernels import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    assert "attention_tc.cuh" in _build._files()
    before = _build._digest()
    if change == "edit":
        header = csrc / "attention_tc.cuh"
        header.write_bytes(header.read_bytes() + b"\n")
    else:
        (csrc / "extra.h").write_text("#pragma once\n")
    assert _build._digest() != before


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


@pytest.mark.parametrize("shapes,tile", [(tdw.ENC_SHAPES, 16), (SHAPES3, 16), (SHAPES4, 8)])
def test_query_order_is_a_permutation(shapes, tile):
    """The level-0 tile order the A/B tool's ``tile_order`` variant walks the
    raster in: every query once, in level-0 tiles, raster order inside a
    tile."""
    from beyondff_tpu_torch.tools import kernel_variants as kv

    order = kv.tile_order(shapes, tile, torch.device("cpu")).numpy()
    q = sum(h * w for h, w in shapes)
    assert order.dtype == np.int32 and order.shape == (q,)
    np.testing.assert_array_equal(np.sort(order), np.arange(q))
    tile_yx = tdw.build_assignment(shapes, 0, tile).tile_yx()[order]
    tid = tile_yx[:, 0] * 1000 + tile_yx[:, 1]
    assert np.all(np.diff(tid) >= 0)
    for t_ in np.unique(tid):
        assert np.all(np.diff(order[tid == t_]) > 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("decoder", [False, True])
def test_sample_inputs_and_bytes(dtype, decoder):
    """The inputs the card checks and the A/B tool share: the main path's
    widths, weights summing to 1 over (level, point), offsets within 12
    cells, every 17th query shifted by 1.5 (off the map at the large
    levels); and the bytes a call moves. Small shapes here."""
    shapes = SHAPES3
    rng = np.random.default_rng(7)
    anchors = (rng.uniform(0.0, 1.0, (40, 2)).astype(np.float32) if decoder
               else tdw.raster_centers(shapes))
    value, locs, aw = tdw.sample_inputs(rng, anchors, 2, dtype, "cpu", shapes=shapes, heads=3,
                                        hd=8, p=4)
    q, s = anchors.shape[0], sum(h * w for h, w in shapes)
    assert value.shape == (2, s, 3, 8) and value.dtype == dtype
    assert locs.shape == (2, q, 3, 3, 4, 2) and locs.dtype == torch.float32
    assert aw.shape == (2, q, 3, 3, 4) and aw.dtype == dtype
    np.testing.assert_allclose(aw.float().sum((-2, -1)).numpy(), 1.0, atol=1e-2)
    wh = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32).view(1, 1, 1, 3, 1, 2)
    shift = torch.zeros(1, q, 1, 1, 1, 1)
    shift[:, ::17] = 1.5
    off = (locs - torch.from_numpy(anchors).view(1, q, 1, 1, 1, 2) - shift) * wh
    assert float(off.abs().max()) <= 12.0 + 1e-3 and float(off.abs().max()) > 6.0
    es = value.element_size()
    out = tdw.ms_deform_sample(value, shapes, locs, aw)
    assert tdw.sample_bytes(value, locs, aw) == (value.numel() * es + locs.numel() * 4
                                                  + aw.numel() * es + out.numel() * es)


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


@pytest.mark.parametrize("name", ["load_after_mma", "cut128", "k1_staged_dense",
                                  "k1_staged_warps_8", "k1_staged_stages_1", "k6_no_multicast",
                                  "k6_cluster_4", "k6_overlap", "k6_stages_3", "k6_stages_6",
                                  "head_run_warp", "head_run_block",
                                  "tile_order", "min_blocks_2", "min_blocks_4",
                                  "point_at_a_time", "two_points", "k3_serial", "k3_stages_3",
                                  "k3_no_pingpong", "k3_two_consumers", "k4_two_consumers",
                                  "k4_two_serial", "k4_overlap", "k4_no_pingpong",
                                  "k4_stages_3", "k5_one_consumer",
                                  "k5_two_blocks", "k5_pingpong", "tf32_serial",
                                  "tf32_no_pingpong", "tf32_stages_2", "tf32_d128_fold",
                                  "tf32_d128_overlap", "tf32_d128_stages_1_2",
                                  "tf32_d128_stages_1_1", "tf32_d96_tile32",
                                  "tf32_d96_tile32_serial", "tf32_d96_tile32_stages_3_2",
                                  "tf32_d96_overlap", "tf32_d80_overlap",
                                  "tf32_d80_stages_1_1", "tf32_d80_stages_1_2"])
def test_kernel_variant_edits_match_the_sources(name):
    """Each variant ``tools/kernel_variants.py`` builds is a set of edits
    that must each match its source once: they go stale with the kernels."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    sources, edits = kv.VARIANTS[name]
    extra = set(os.listdir(kv.VARIANT_CSRC))
    assert edits and set(sources) <= set(kv.SOURCES) | extra
    for fname, old, new in edits:
        with open(os.path.join(kv.VARIANT_CSRC if fname in extra else _build.CSRC, fname)) as f:
            assert f.read().count(old) == 1, (fname, old)
        assert new != old


def test_staged_k1_is_built_only_as_a_variant():
    """K1's TMA-staged kernel lost to the gather and is on no path: its
    source lies outside ``csrc`` (the port's library does not build it) and
    only the ``k1_staged*`` variants build it; no K6 variant closes the
    wgmma route."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    assert kv.MSW not in _build._files() and kv.MSW not in kv.SOURCES
    assert kv.MSW in os.listdir(kv.VARIANT_CSRC)
    staged = {n for n, (sources, _e) in kv.VARIANTS.items() if kv.MSW in sources}
    assert staged == {"k1_staged", "k1_staged_dense", "k1_staged_warps_8", "k1_staged_stages_1"}
    assert not any(dispatch_key.startswith("ms_deform_sample_")
                   for dispatch_key in dispatch.launch_counts)


def test_wrappers_reject_other_devices():
    meta = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError):
        dispatch.kernel_device(torch.zeros(1), meta)


# --------------------------------------------------------------- on the card
def _moved(before):
    """The counters that moved since ``before``."""
    return [k for k, n in dispatch.launch_counts.items() if n != before[k]]


def _k6_counter(ta, tb):
    """The counter a K6 call moves, as ``wgmma_route`` decides."""
    stride = lambda t: t.stride(0) if t.shape[0] > 1 else max(t.shape[1], t.stride(0))
    ia, n = ta.shape
    takes = tiou.wgmma_route(ia, ia if tb is None else tb.shape[0], n, stride(ta),
                             stride(ta if tb is None else tb), ta.data_ptr(),
                             None if tb is None else tb.data_ptr())
    return "mask_iou_wgmma" if takes else "mask_iou"


def _assert_within_bound(got, want, bound):
    """f32: within 1e-4. bf16: within ``bound`` (``tfa.bf16_error_bound``)."""
    if got.dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4
    else:
        excess = _bf16_excess(got, want, bound)
        assert excess <= 0.0, float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,valid,d", [
    (8, 900, 900, 32), (2, 600, 517, 32), (2, 1000, 900, 32), (2, 1023, 1000, 32),
    (2, 300, 300, 16), (2, 300, 251, 64), (2, 300, 300, 80), (2, 300, 290, 128),
    (2, 300, 280, 20)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, bh, s, valid, d):
    """K2/K3 against the plain version: the decoder's (8, 900, 32), keys
    masked in the last partial tile at S = 600, 1000 and 1023, and head dims
    16 to 128 (bf16 pads them to whole k16 steps in shared memory; D = 20 is
    no whole 16-byte row and takes the FMA kernel). f32 within 1e-4; bf16
    within the derived bound and K2's 1.6e-2. Each call counts once, under
    the counter ``tfa.flash_counter`` names: bf16 at head dim 32 goes to
    K2's wgmma kernel (``flash_masked_wgmma``), other bf16 to the mma.sync
    tile or the FMA kernel (``flash_attention``), f32 at head dim 32, 64, 80,
    96 or 128 from S = 256 on to the 3xTF32 kernel (``flash_attention_tf32``)
    and other f32 to the FMA kernel (``flash_attention_f32``)."""
    g = torch.Generator(device=cuda_device).manual_seed(s + d)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    key = tfa.flash_counter(int(dtype == torch.bfloat16), d, s, valid, d ** -0.5,
                            *(t.data_ptr() for t in (q, k, v, got)))
    assert _moved(before) == [key]
    if dtype == torch.bfloat16:
        assert key == ("flash_masked_wgmma" if d == 32 else "flash_attention")
    else:
        assert key == ("flash_attention_tf32" if d in tfa.TF32_HEAD_DIMS and s >= tfa.TF32_MIN_S
                       else "flash_attention_f32")
    _assert_within_bound(got, want, tfa.bf16_error_bound(q, k, v, want, valid))
    if dtype == torch.bfloat16:
        assert float((got.float() - want.float()).abs().max()) <= 1.6e-2


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


def _clamp_against_exact(dev, dtype, sigma):
    """Clamp mode (the main path's modes) and exact mode on one call's
    inputs at the encoder raster, 2 heads of 16: N(0, sigma cells) offsets
    around every query's centre. Returns (clamp, exact, rows whose samples
    clamp)."""
    shapes = tdw.ENC_SHAPES
    rng = np.random.default_rng(3)
    q = sum(h * w for h, w in shapes)
    wh = np.array([[w, h] for h, w in shapes], np.float32)
    off = rng.normal(0, sigma, (1, q, 2, len(shapes), 4, 2)).astype(np.float32)
    locs = tdw.raster_centers(shapes)[None, :, None, None, None, :] + off / wh[:, None, :]
    aw = rng.uniform(0.1, 1.0, (1, q, 2, len(shapes), 4)).astype(np.float32)
    tv = torch.from_numpy(rng.normal(size=(1, q, 2, 16)).astype(np.float32)).to(dev, dtype)
    tl = torch.from_numpy(locs).to(dev)
    ta = torch.from_numpy(aw).to(dev, dtype)
    modes = tdeform.level_modes(shapes)
    clamps = sum(c.any(-1) for c, _ in tdw.clamped_samples(tl, shapes, modes))
    return (tdw.ms_deform_sample(tv, shapes, tl, ta, modes),
            tdw.ms_deform_sample(tv, shapes, tl, ta, (None,) * len(shapes)), clamps > 0)


def _assert_equal_where_nothing_clamps(clamp, exact, clamps, sigma):
    clamp, exact = clamp.view(*clamps.shape, -1), exact.view(*clamps.shape, -1)
    assert torch.equal(clamp[~clamps], exact[~clamps])
    if sigma < 2:
        assert not clamps.any()
    else:
        assert clamps.any() and not torch.equal(clamp[clamps], exact[clamps])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sigma", [1.0, 4.0])
def test_deform_clamp_equals_exact_where_nothing_clamps(dtype, sigma):
    """A (query, head) none of whose samples leaves its window samples with
    the exact mode's arithmetic, bit for bit, at the main path's modes."""
    _assert_equal_where_nothing_clamps(*_clamp_against_exact("cpu", dtype, sigma), sigma)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sigma", [1.0, 4.0])
def test_deform_clamp_equals_exact_where_nothing_clamps_on_card(cuda_device, dtype, sigma):
    _assert_equal_where_nothing_clamps(*_clamp_against_exact(cuda_device, dtype, sigma), sigma)


def _edge_locs(locs, shapes):
    """Samples on every map edge, half a cell beyond it and wholly outside."""
    locs[:, ::9, :, :, :, 0] = 0.0                      # left edge
    locs[:, 1::9, :, :, :, 0] = 1.0                     # right edge
    locs[:, 2::9, :, :, :, 1] = 0.0                     # top edge
    locs[:, 3::9, :, :, :, 1] = 1.0                     # bottom edge
    locs[:, 4::9, :, :, :, 0] = -0.3                    # outside
    locs[:, 5::9, :, :, :, 1] = 1.7                     # outside
    for li, (h, w) in enumerate(shapes):
        locs[:, 6::9, :, li, :, 0] = -0.5 / w           # half a cell outside
        locs[:, 7::9, :, li, :, 1] = 1.0 + 0.5 / h
    return locs


def _deform_on_card(dev, dtype, shapes, value, locs, aw, shift=0):
    """The kernel against the plain version in clamp and exact mode; value
    ``shift`` elements past an aligned address. f32 within 1e-4, bf16 3e-2.
    Each call moves the gather's counter and no other."""
    buf = torch.empty(value.size + shift, dtype=dtype, device=dev)
    tv = buf[shift:].view(value.shape)
    tv.copy_(torch.from_numpy(value))
    tl = torch.from_numpy(locs).to(dev)
    ta = torch.from_numpy(aw).to(dev, dtype)
    q, raster = locs.shape[1], sum(h * w for h, w in shapes)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    for modes in ((tdeform.level_modes(shapes),) if q == raster else ()) + ((None,) * len(shapes),):
        before = dict(dispatch.launch_counts)
        got = tdw.ms_deform_sample(tv, shapes, tl, ta, modes)
        assert _moved(before) == ["ms_deform_sample"]
        want = tdw.ms_deform_sample_plain(tv, shapes, tl, ta, modes)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol, (modes, err)
        assert want.float().abs().max().item() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,heads,hd,p,q", [
    (SHAPES3, 2, 16, 4, None),      # the "test" preset: 3 levels, 2 heads of 16
    (SHAPES4, 8, 8, 4, None), (SHAPES4, 8, 16, 4, None), (SHAPES4, 2, 64, 4, None),
    (SHAPES4, 2, 128, 4, None),     # head dims 8 to 128 in 16-byte chunks
    (SHAPES4, 3, 32, 1, None), (SHAPES4, 3, 32, 3, None),   # P 1 and 3: run-time loops
    (SHAPES3, 3, 32, 4, 37),        # 111 rows: the last warp not filled
    (SHAPES3, 2, 20, 4, None),      # 40- or 80-byte rows: 8- or 16-byte chunks
    (SHAPES3, 2, 13, 3, None),      # 26- or 52-byte rows: 2- or 4-byte chunks
    (((7, 9), (4, 5)), 5, 24, 2, None)])
def test_deform_kernel_shapes_on_card(cuda_device, dtype, shapes, heads, hd, p, q):
    """K1 at the test preset's shapes, head dims 8 to 128, P in {1, 3, 4},
    a ragged last warp and rows that take narrow loads, with samples on
    every edge of the map and outside it."""
    rng = np.random.default_rng(hd * 10 + p)
    value, locs, aw = _deform_inputs(rng, shapes, b=2, heads=heads, hd=hd, p=p, max_off=12.0)
    if q is not None:
        locs, aw = locs[:, :q].copy(), aw[:, :q].copy()
    _deform_on_card(cuda_device, dtype, shapes, value, _edge_locs(locs, shapes), aw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shift", [1, 2, 4])
def test_deform_kernel_takes_misaligned_values(cuda_device, dtype, shift):
    """A value tensor off a 16-byte boundary takes the narrow loads."""
    rng = np.random.default_rng(shift)
    value, locs, aw = _deform_inputs(rng, SHAPES4, heads=8, hd=32, p=4, max_off=12.0)
    _deform_on_card(cuda_device, dtype, SHAPES4, value, locs, aw, shift=shift)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deform_kernel_main_path_shapes_on_card(cuda_device, dtype):
    """The main path's encoder raster at batch 4 (8 heads of 32, 4 levels,
    4 points) and 900 decoder queries.
    The weights sum to 1 over (level, point), as the model's softmax gives
    them, so outputs stay within a few units where 3e-2 exceeds a bf16
    rounding step."""
    rng = np.random.default_rng(4)
    value, locs, aw = _deform_inputs(rng, tdw.ENC_SHAPES, b=4, heads=8, hd=32, p=4, max_off=12.0)
    aw /= aw.sum((-2, -1), keepdims=True)
    locs[:, ::17] += 1.5
    _deform_on_card(cuda_device, dtype, tdw.ENC_SHAPES, value, locs, aw)
    dec = rng.uniform(0.0, 1.0, (4, 900, 8, 4, 4, 2)).astype(np.float32)
    _deform_on_card(cuda_device, dtype, tdw.ENC_SHAPES, value, dec, aw[:, :900].copy())


@pytest.mark.cuda
@pytest.mark.parametrize("ia,ib,n", [(37, 5, 3001), (600, None, 250_000), (20, 150, 250_000),
                                     (65, 130, 4096), (200, None, 10_007), (5, 3, 17),
                                     (33, None, 31), (17, 15, 4112), (129, 127, 1000),
                                     (127, None, 4112), (129, None, 250_007)])
def test_mask_iou_kernel_matches_plain_on_card(cuda_device, ia, ib, n):
    """Bit for bit, nan where the plain version puts it; ``ib`` None is a
    self-IoU. With N not a multiple of 16, rows start off 16-byte
    boundaries and the kernel cuts them out of aligned granules; N below
    32 and N % 32 != 0 leave part of a k32 step, and Ia, Ib of 16 k +- 1
    part of an m16 tile and of a 128-row block."""
    rng = np.random.default_rng(0)
    a, b = _iou_masks(rng, ia, ib or 8, n)
    ta = torch.from_numpy(a).to(cuda_device)
    tb = None if ib is None else torch.from_numpy(b).to(cuda_device)
    before = dict(dispatch.launch_counts)
    got = tiou.pairwise_iou(ta, tb)
    want = tiou.pairwise_iou_plain(ta, tb)
    torch.cuda.synchronize()
    # contiguous rows of N % 16 == 0 points lie on 16-byte boundaries: the
    # wgmma kernel; the others the mma.sync kernel
    assert _moved(before) == [_k6_counter(ta, tb)]
    _assert_bit_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4099, 4096])
def test_mask_iou_kernel_self_empty_and_full_rows(cuda_device, n):
    """A self-IoU takes |a_i| from its diagonal count: an all-empty row is
    nan against itself and against other empty rows and 0 against the rest;
    an all-full row's IoU with row j is |a_j| / N."""
    rng = np.random.default_rng(n)
    a, _ = _iou_masks(rng, 140, 1, n)
    a[3] = False
    a[130] = True
    ta = torch.from_numpy(a).to(cuda_device)
    got = tiou.pairwise_iou(ta)
    want = tiou.pairwise_iou_plain(ta)
    torch.cuda.synchronize()
    _assert_bit_equal(got.cpu().numpy(), want.cpu().numpy())
    assert bool(torch.isnan(got[3, 3])) and float(got[130, 130]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4099, 4096])
@pytest.mark.parametrize("shift", [1, 3, 8, 13])
def test_mask_iou_kernel_takes_masks_at_any_address(cuda_device, shift, n):
    """Masks that start ``shift`` bytes into their storage (a contiguous
    view), so no row lies on a 16-byte boundary of its own (at N = 4096
    every row is off by the same ``shift``), self and cross."""
    rng = np.random.default_rng(shift)
    a, b = _iou_masks(rng, 70, 9, n)
    ta = torch.zeros(shift + a.size, dtype=torch.bool, device=cuda_device)
    ta[shift:] = torch.from_numpy(a.reshape(-1)).to(cuda_device)
    ta = ta[shift:].view(a.shape)
    tb = torch.from_numpy(b).to(cuda_device)
    for other in (None, tb):
        got = tiou.pairwise_iou(ta, other)
        want = tiou.pairwise_iou_plain(ta, other)
        _assert_bit_equal(got.cpu().numpy(), want.cpu().numpy())


def _aligned_masks(dev, m):
    """Host masks as the main path holds them on the card: rows on 128-byte
    boundaries in wider storage (``core.masks.as_mask``)."""
    from beyondff_tpu_torch.core import masks as tmasks

    t = tmasks.as_mask(m, dev)
    assert tiou.is_aligned(t)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("ia,ib,n", [(600, None, 250_000), (600, None, 250_007),
                                     (20, 150, 250_007), (1, None, 1000), (65, None, 4099),
                                     (65, 7, 4099), (127, 129, 1007), (129, None, 16),
                                     (257, 255, 3001), (300, 700, 5000)])
def test_mask_iou_wgmma_matches_plain_on_card(cuda_device, ia, ib, n):
    """K6's wgmma kernel on padded rows, bit for bit: the main path's
    self-IoU and cross IoU at 250 000 and 250 007 points, one row, 16 k +- 1
    rows (a partial cluster, a partial 128-row tile), N below one 128-byte
    chunk and off 16, with empty rows (nan) and an IoU-1 pair."""
    rng = np.random.default_rng(n + ia)
    a, b = _iou_masks(rng, ia, ib or 8, n)
    ta = _aligned_masks(cuda_device, a)
    tb = None if ib is None else _aligned_masks(cuda_device, b)
    before = dict(dispatch.launch_counts)
    got = tiou.pairwise_iou(ta, tb)
    want = tiou.pairwise_iou_plain(ta, tb)
    torch.cuda.synchronize()
    assert _moved(before) == ["mask_iou_wgmma"]
    _assert_bit_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_mask_iou_wgmma_empty_full_rows_and_route_on_card(cuda_device):
    """Empty and full rows through the wgmma kernel (areas from the
    diagonal), and the route: ``wgmma_route`` equals the C predicate
    ``bff_mask_iou_wgmma_takes``, and an unpadded 250 007-point call keeps the
    mma.sync kernel."""
    from beyondff_tpu_torch.kernels import _build

    rng = np.random.default_rng(5)
    a, _ = _iou_masks(rng, 140, 1, 4099)
    a[3] = False
    a[130] = True
    ta = _aligned_masks(cuda_device, a)
    got = tiou.pairwise_iou(ta)
    _assert_bit_equal(got.cpu().numpy(), tiou.pairwise_iou_plain(ta).cpu().numpy())
    assert bool(torch.isnan(got[3, 3])) and float(got[130, 130]) == 1.0
    lib = _build.library()
    for args in [(600, 600, 250_007, 250_016, 250_016, 256, None),
                 (600, 600, 250_007, 250_007, 250_007, 256, None),
                 (20, 150, 1000, 1008, 1008, 256, 520), (1, 1, 1, 16, 16, 0, None),
                 (4, 4, 0, 16, 16, 0, None), (4, 4, 32, 16, 16, 0, None)]:
        ia, ib, n, lda, ldb, pa, pb = args
        c = lib.bff_mask_iou_wgmma_takes(ia, ib, n, lda, ldb, pa + 4096,
                                         None if pb is None else pb + 4096)
        assert bool(c) == tiou.wgmma_route(ia, ib, n, lda, ldb, pa + 4096,
                                           None if pb is None else pb + 4096), args
    m = torch.from_numpy(_iou_masks(rng, 33, 1, 250_007)[0]).to(cuda_device)
    before = dict(dispatch.launch_counts)
    _assert_bit_equal(tiou.pairwise_iou(m).cpu().numpy(),
                      tiou.pairwise_iou_plain(m).cpu().numpy())
    assert _moved(before) == ["mask_iou"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,rows,cols,d,scale", [
    (2, 64, 64, 80, 1.0), (3, 10, 37, 48, 1.0), (1, 16, 32, 128, 1.0), (1, 32, 128, 64, 1.0),
    (2, 64, 64, 80, 3.0)])
def test_flash_relpos_kernel_matches_plain_on_card(cuda_device, dtype, bh, rows, cols, d, scale):
    """K4 against its plain version: SAM ViT-H's 64 x 64 global grid (one
    grid row per key tile: bias_h as a row shift), a ragged grid (S = 370, not
    a multiple of the 64-row tiles), head dim 128, a 32 x 128 grid (two key
    tiles per grid row) and the 64 x 64 grid with factors at scale 3 (a
    peaked softmax). f32 within 1e-4, bf16 within the derived bound. bf16
    at head dim 80 on a 64-wide grid counts as the wgmma kernel
    (``flash_attention_relpos_wgmma``), f32 there as the 3xTF32 kernel
    (``flash_attention_relpos_tf32``), f32 at head dim 64 on the 32 x 128
    grid as the 3xTF32 kernel's streamed mode
    (``flash_attention_relpos_tf32_streamed``), every other call as
    ``flash_attention_relpos``."""
    q, k, v, bias_h, bias_w = (torch.from_numpy(a).to(cuda_device) for a in _relpos_inputs(
        np.random.default_rng(rows), bh, rows, cols, d, scale))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    key = "flash_attention_relpos"
    if d == 80 and cols == 64:
        key += "_wgmma" if dtype == torch.bfloat16 else "_tf32"
    elif dtype == torch.float32 and d == 64 and cols > 64:
        key += "_tf32_streamed"
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    torch.cuda.synchronize()
    assert _launched(before) == [key]
    _assert_within_bound(got, want, tfa.bf16_error_bound(q, k, v, want, bias_h=bias_h,
                                                         bias_w=bias_w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,wh,ww,d", [(6, 14, 14, 80), (5, 4, 5, 16), (2, 16, 16, 64),
                                       (64, 14, 14, 80), (3, 5, 7, 16)])
def test_window_relpos_kernel_matches_plain_on_card(cuda_device, dtype, g, wh, ww, d):
    """K5 against its plain version: SAM ViT-H's 14 x 14 x 80 window (S =
    196: a last key tile of 4 keys, m16 tiles past S), odd window widths (no
    bias_w pairs), a whole 16 x 16 window. f32 within 1e-4, on the FMA
    kernel or (14 x 14 x 80, counted as ``window_attention_relpos_tf32``) the
    3xTF32 kernel; bf16, on the tensor-core tile or (14 x 14 x 80, counted
    as ``window_attention_relpos_wgmma``) the wgmma kernel, within the
    derived bound."""
    q, k, v, bias_h, bias_w = (torch.from_numpy(a).to(cuda_device) for a in
                               _relpos_inputs(np.random.default_rng(wh), g, wh, ww, d))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    key = "window_attention_relpos"
    if d == 80 and wh == 14 and ww == 14:
        key += "_wgmma" if dtype == torch.bfloat16 else "_tf32"
    before = dict(dispatch.launch_counts)
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, wh, ww)
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, wh, ww)
    torch.cuda.synchronize()
    assert _launched(before) == [key]
    _assert_within_bound(got, want, tfa.bf16_error_bound(q, k, v, want, bias_h=bias_h,
                                                         bias_w=bias_w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh", [6, 24])
def test_flash_kernel_at_efficientsam_global_blocks_on_card(cuda_device, dtype, bh):
    """K3 at EfficientSAM-S's global blocks: head dim 64 over the 64 x 64
    grid (S 4096, every key valid), 6 heads for one frame and 24 for the
    main path's batch of 4; f32 within 1e-4 (the 3xTF32 kernel), bf16 within
    the derived bound (the wgmma kernel)."""
    g = torch.Generator(device=cuda_device).manual_seed(bh)
    q, k, v = (torch.randn(bh, 4096, 64, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    key = "flash_attention_wgmma" if dtype == torch.bfloat16 else "flash_attention_tf32"
    before = dict(dispatch.launch_counts)
    got = tfa.attend(q, k, v)
    assert _launched(before) == [key]  # bf16: the wgmma kernel; f32: the 3xTF32 kernel
    want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _assert_within_bound(got, want, tfa.bf16_error_bound(q, k, v, want))


def _launched(before):
    """The counters that moved since ``before``."""
    return [k for k, n in dispatch.launch_counts.items() if n != before[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("bh", [1, 6, 24])
@pytest.mark.parametrize("s", [128, 600, 1000, 3072, 4095, 4096])
def test_flash_wgmma_kernel_matches_plain_on_card(cuda_device, bh, s):
    """K3's wgmma/TMA kernel (bf16, head dim 64, every key valid) against
    the plain version within the derived bound: whole 128-key tiles (128,
    3072, 4096) and ragged ones, whose last key tile is masked and whose
    last query rows are not written, at one head, one frame's 6 and the
    batch's 24; counted as ``flash_attention_wgmma`` only."""
    g = torch.Generator(device=cuda_device).manual_seed(bh * s)
    q, k, v = (torch.randn(bh, s, 64, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v)
    assert _launched(before) == ["flash_attention_wgmma"]
    want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _assert_within_bound(got, want, tfa.bf16_error_bound(q, k, v, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["masked", "d32", "d80", "f32", "misaligned"])
def test_flash_other_shapes_keep_their_kernels_on_card(cuda_device, case):
    """Calls outside K3's wgmma predicate keep their routes: keys masked at
    head dim 64 and head dim 80 on the mma.sync tile and a bf16 head-dim-64
    input off 16 bytes (the FMA kernel), counted as ``flash_attention``;
    bf16 at head dim 32 on K2's wgmma kernel, counted as
    ``flash_masked_wgmma``; f32 at head dim 64 on the 3xTF32 kernel, counted
    as ``flash_attention_tf32``; each within its bound of the plain version."""
    d = {"d32": 32, "d80": 80}.get(case, 64)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = (torch.randn(2, 1000, d, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    if case == "misaligned":
        q = torch.randn(2 * 1000 * 64 + 4, generator=g, device=cuda_device).bfloat16()
        q = q[4:].view(2, 1000, 64)  # 8 bytes past an aligned base
    valid = 900 if case == "masked" else 1000
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    assert _launched(before) == [{"d32": "flash_masked_wgmma", "f32": "flash_attention_tf32"}
                                 .get(case, "flash_attention")]
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    _assert_within_bound(got, want, tfa.bf16_error_bound(q, k, v, want, valid))


@pytest.mark.cuda
def test_wgmma_route_matches_the_c_predicate_on_card(cuda_device):
    """``wgmma_route`` says what ``bff_flash_wgmma_takes`` says, over the
    dtypes, head dims, valid lengths, scales and alignments around the
    predicate's edges."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    for dtype in (0, 1):
        for d in (32, 64, 80, 128):
            for s, valid in ((1, 1), (4096, 4096), (4096, 4095), (3072, 3072)):
                for scale in (d ** -0.5, 0.0, -1.0, float("inf")):
                    for off in (0, 2, 8, 16, 4096):
                        ptrs = (4096, 4096 + off, 8192, 12288)
                        want = tfa.wgmma_route(dtype, d, s, valid, scale, *ptrs)
                        assert bool(lib.bff_flash_wgmma_takes(dtype, d, s, valid, scale,
                                                              *ptrs)) is want


def _nms_frames(gen, dev, b, a, spread):
    """Clustered boxes (8 400 anchors a frame at YOLO-World-L's input) with
    uniform scores, as the detector's NMS input."""
    centers = torch.rand(b, 40, 2, generator=gen, device=dev) * 640
    pick = torch.randint(0, 40, (b, a), generator=gen, device=dev)
    c = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    c = c + torch.randn(b, a, 2, generator=gen, device=dev) * spread
    half = torch.rand(b, a, 2, generator=gen, device=dev) * 60 + 5
    return torch.cat([c - half, c + half], -1), torch.rand(b, a, generator=gen, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [1, 5, 100, 9000])
def test_nms_kernel_matches_plain_on_card(cuda_device, top_k):
    """The NMS kernel against its plain version, index for index: four
    frames of 8 400 anchors, the scan stopping early at top_k 1, 5 and 100,
    and every survivor with the padding at top_k 9 000."""
    gen = torch.Generator(device=cuda_device).manual_seed(top_k)
    boxes, scores = _nms_frames(gen, cuda_device, 4, 8400, 8.0)
    before = dispatch.launch_counts["nms_fixed"]
    keep, valid = tnms.nms_fixed(boxes, scores, 0.5, top_k)
    assert dispatch.launch_counts["nms_fixed"] == before + 1
    want_keep, want_valid = tnms.nms_fixed_plain(boxes, scores, 0.5, top_k)
    torch.cuda.synchronize()
    assert torch.equal(keep, want_keep) and torch.equal(valid, want_valid)
    assert int(valid.sum()) > 0
    if top_k == 9000:
        assert not bool(valid.all())  # padding rows: index 0, not valid
        assert int(keep[~valid].abs().sum()) == 0


@pytest.mark.cuda
def test_nms_kernel_on_the_threshold_on_card(cuda_device):
    """Thresholds set to IoUs the plain version computes for pairs of the
    input, so those pairs sit exactly on the threshold (``>`` keeps them):
    the kernel's unfused f32 arithmetic decides every one as the plain
    version does, at several thresholds, with tied scores in the mix."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    boxes, scores = _nms_frames(gen, cuda_device, 2, 2000, 3.0)
    scores = torch.round(scores * 8) / 8  # ties, kept in index order
    bs = boxes[0]
    area = (bs[:, 2] - bs[:, 0]).clamp_min(0) * (bs[:, 3] - bs[:, 1]).clamp_min(0)
    x1 = torch.maximum(bs[0, 0], bs[1:, 0])
    y1 = torch.maximum(bs[0, 1], bs[1:, 1])
    x2 = torch.minimum(bs[0, 2], bs[1:, 2])
    y2 = torch.minimum(bs[0, 3], bs[1:, 3])
    inter = (x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0)
    iou = inter / (area[0] + area[1:] - inter + 1e-9)
    on = iou[(iou > 0.2) & (iou < 0.8)][:6].tolist()
    assert len(on) == 6
    for thr in on:
        keep, valid = tnms.nms_fixed(boxes, scores, thr, 300)
        want_keep, want_valid = tnms.nms_fixed_plain(boxes, scores, thr, 300)
        torch.cuda.synchronize()
        assert torch.equal(keep, want_keep) and torch.equal(valid, want_valid), thr


# ---------------------------------------------------------------- autograd
@pytest.mark.cuda
def test_kernels_refuse_autograd_on_card(cuda_device):
    """No kernel has a backward, so a wrapper given a CUDA input that
    requires grad, with grad mode on, raises before it launches (the JAX
    package raises when it differentiates a ``pallas_call`` without a VJP);
    under ``no_grad`` the same call launches."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def leaf(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).requires_grad_(True)

    q = leaf(2, 512, 32)
    bias_h, bias_w = leaf(2, 512, 16), leaf(2, 512, 32)
    shapes = ((8, 8),)
    value, locs, aw = leaf(1, 64, 2, 16), leaf(1, 4, 2, 1, 4, 2).detach(), leaf(1, 4, 2, 1, 4)
    boxes, scores = leaf(1, 40, 4), leaf(1, 40)
    calls = {"flash_attention": lambda: tfa.attend(q, q, q),
             "flash_attention_relpos": lambda: tfa.attend_relpos(q, q, q, bias_h, bias_w, 32),
             "window_attention_relpos": lambda: twa.window_attention_relpos(
                 q[:, :64], q[:, :64], q[:, :64], bias_h[:, :64, :8], bias_w[:, :64, :8], 8, 8),
             "ms_deform_sample": lambda: tdw.ms_deform_sample(value, shapes, locs, aw),
             "nms_fixed": lambda: tnms.nms_fixed(boxes, scores, 0.5, 5)}
    dispatch.reset_launch_counts()
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert dispatch.launch_counts[name] == 0, name
    with torch.no_grad():
        out = tfa.attend(q, q, q)
    torch.cuda.synchronize()
    # f32 at head dim 32: the 3xTF32 kernel
    assert dispatch.launch_counts["flash_attention_tf32"] == 1 and out.requires_grad is False
