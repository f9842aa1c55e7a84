"""K2 and K3 in f32 (``detector.dtype: float32``), and f32 attention at head
dims 80, 96, 112 and 128, on the 3xTF32 wgmma kernel (``csrc/flash_attention_tf32.cu``).

On the CPU: the kernel's rounding (``tf32_round``: ``cvt.rna.tf32.f32``)
and split (``tf32_split``), its routing rule (``tf32_route``, the mirror of
the C predicate ``bff_flash_tf32_takes``) and the counter a call moves,
its scratch size, its grid (``tf32_schedule``) and key tile
(``tf32_key_tile``), the key order of its V^T
against the wgmma fragment layouts, and its arithmetic
(``flash_tf32_mirror``) against the plain version and against the JAX
``_flash_masked`` / ``flash_attention`` / ``attend`` in interpret mode, in
f32, within 1e-4 (the f32 calls' tolerance everywhere in the repository).
Tests that need the card carry the ``cuda`` marker and import nothing of
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_tf32_attention.py``.
"""

import ctypes

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels import flash_attention as tfa

torch.set_num_threads(2)

TOL = 1e-4  # f32 attention against its plain version
_A = (0, 256, 512, 1024)  # q, k, v, o: 16-byte aligned
_S32, _S64 = 32 ** -0.5, 64 ** -0.5


@pytest.fixture
def jx():
    import types

    pytest.importorskip("jax")
    import jax.numpy as jnp

    from beyondff_tpu.kernels import flash_attention as jfa

    return types.SimpleNamespace(jnp=jnp, fa=jfa)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_tf32_attention.py")
    return torch.device("cuda")


def _inputs(rng, shape, spread=1.0):
    """q, k, v from ``rng``; q and k scaled by ``spread`` (the score scale)."""
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return torch.from_numpy(q * spread), torch.from_numpy(k * spread), torch.from_numpy(v)


def _f32(bits):
    return torch.tensor(np.array(bits, np.uint32).view(np.float32))


# ---------------------------------------------------------------- rounding
@pytest.mark.parametrize("x_bits,want_bits", [
    (0x3F800000, 0x3F800000),  # 1.0 is a TF32 word
    (0x3F800FFF, 0x3F800000),  # below half an ulp: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0x3F803000, 0x3F804000),  # a tie above an odd word: away, not to even
    (0x3FFFF000, 0x40000000),  # the carry into the exponent
    (0x00000000, 0x00000000),
    (0x80000000, 0x80000000),
    (0x7F7FE000, 0x7F7FE000),  # the largest TF32 word below FLT_MAX
])
def test_tf32_round_is_round_to_nearest_ties_away(x_bits, want_bits):
    """``tf32_round`` is ``cvt.rna.tf32.f32``: 10 mantissa bits, half an ulp
    rounds away from zero, the low 13 bits cleared."""
    got = tfa.tf32_round(_f32([x_bits])).numpy().view(np.uint32)[0]
    assert got == want_bits


def test_tf32_split_keeps_about_22_bits(rng):
    """hi + lo lies within 2^-21 of x (relative) over six decades of
    magnitudes; hi and lo are TF32 words (low 13 bits 0) and lo is at most
    half an ulp of hi."""
    x = torch.from_numpy((rng.normal(size=1 << 16) * 10.0 ** rng.uniform(-3, 3, 1 << 16))
                         .astype(np.float32))
    hi, lo = tfa.tf32_split(x)
    for t in (hi, lo):
        assert (t.numpy().view(np.uint32) & 0x1FFF == 0).all()
    err = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(err.max()) <= 2.0 ** -21
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


# ------------------------------------------------------------------ route
@pytest.mark.parametrize("args,takes", [
    ((0, 32, 900, 900, _S32, *_A), True),  # K2: the decoder's self-attention
    ((0, 32, 1024, 900, _S32, *_A), True),  # keys masked
    ((0, 64, 4096, 4096, _S64, *_A), True),  # K3: EfficientSAM-S's global blocks
    ((0, 64, 3072, 3072, _S64, *_A), True),  # K3 on the rect grid
    ((0, 64, 4095, 4095, _S64, *_A), True),  # ragged S
    ((0, 64, 1024, 900, _S64, *_A), True),  # head dim 64, keys masked
    ((0, 32, 256, 1, 1.0, *_A), True),  # the shortest S taken, one valid key
    ((0, 64, 255, 255, _S64, *_A), False),  # shorter: the FMA kernel is faster
    ((0, 32, 64, 64, _S32, *_A), False),
    ((0, 32, 8192, 8192, _S32, *_A), True),  # no key limit (the keys stream)
    ((1, 32, 900, 900, _S32, *_A), False),  # bf16: K2's bf16 kernel
    ((1, 64, 4096, 4096, _S64, *_A), False),  # bf16: K3's bf16 kernel
    ((0, 128, 900, 900, 128 ** -0.5, *_A), True),  # head dim 128: 32-key tiles
    ((0, 128, 1024, 900, 128 ** -0.5, *_A), True),  # head dim 128, keys masked
    ((0, 128, 256, 1, 1.0, *_A), True),  # head dim 128, the shortest S, one valid key
    ((0, 128, 255, 255, 128 ** -0.5, *_A), False),  # shorter: the FMA kernel
    ((0, 128, 900, 900, 128 ** -0.5, 0, 0, 4, 0), False),  # head dim 128, v off 16 bytes
    ((1, 128, 900, 900, 128 ** -0.5, *_A), False),  # bf16 at head dim 128: the tile
    ((0, 16, 900, 900, 0.25, *_A), False),
    ((0, 80, 900, 900, 80 ** -0.5, *_A), True),  # head dim 80: 16-float boxes, 64-byte swizzle
    ((0, 96, 900, 900, 96 ** -0.5, *_A), True),  # head dim 96: one 64-key stage each
    ((0, 96, 1024, 900, 96 ** -0.5, *_A), True),  # head dim 96, keys masked
    ((0, 96, 256, 1, 1.0, *_A), True),  # head dim 96, the shortest S, one valid key
    ((0, 96, 255, 255, 96 ** -0.5, *_A), False),  # shorter: the FMA kernel
    ((0, 96, 900, 900, 96 ** -0.5, 4, 0, 0, 0), False),  # head dim 96, q off 16 bytes
    ((1, 96, 900, 900, 96 ** -0.5, *_A), False),  # bf16 at head dim 96: the tile
    ((0, 112, 900, 900, 112 ** -0.5, *_A), True),  # head dim 112: seven 16-float boxes
    ((0, 32, 900, 0, _S32, *_A), False),  # no valid key
    ((0, 32, 900, 901, _S32, *_A), False),  # valid_len past S
    ((0, 32, 900, 900, _S32, 0, 4, 0, 0), False),  # k off 16 bytes
    ((0, 64, 900, 900, _S64, 0, 0, 0, 8), False),  # the output off 16 bytes
    ((0, 32, 900, 900, 0.0, *_A), False),
    ((0, 32, 900, 900, -_S32, *_A), False),
    ((0, 32, 900, 900, float("inf"), *_A), False),
    ((0, 32, 900, 900, float("nan"), *_A), False),
    ((0, 32, 900, 900, 1e39, *_A), False),  # inf once rounded to f32
    ((0, 80, 1024, 900, 80 ** -0.5, *_A), True),  # head dim 80, keys masked
    ((0, 80, 256, 256, 80 ** -0.5, *_A), True),  # head dim 80, the shortest S
    ((0, 80, 255, 255, 80 ** -0.5, *_A), False),  # shorter: the FMA kernel
    ((0, 80, 900, 900, 80 ** -0.5, 0, 0, 0, 4), False),  # head dim 80, the output off 16 bytes
    ((1, 80, 900, 900, 80 ** -0.5, *_A), False),  # bf16 at head dim 80: the tile
    ((0, 112, 1024, 900, 112 ** -0.5, *_A), True),  # head dim 112, keys masked
])
def test_tf32_route_pins_the_predicate(args, takes):
    """The Python mirror of ``bff_flash_tf32_takes``: f32, head dim 32, 64, 80,
    96, 112 or 128, S >= 256, 1 <= valid_len <= S, a positive finite f32
    scale, 16-byte aligned q, k, v and output; and the counter a call
    moves: ``flash_attention_tf32`` where it takes the call, else
    ``flash_attention_f32`` for f32 (the FMA kernel) and the bf16 kernels'
    own counters for bf16."""
    assert tfa.tf32_route(*args) is takes
    key = tfa.flash_counter(*args)
    if takes:
        assert key == "flash_attention_tf32"
    elif args[0] == 0:
        assert key == "flash_attention_f32"
    else:
        assert key in ("flash_attention_wgmma", "flash_masked_wgmma", "flash_attention")


def test_tf32_counters_are_registered():
    """Both f32 counters exist beside the bf16 tile's ``flash_attention``
    and reset with the rest."""
    for key in ("flash_attention_tf32", "flash_attention_f32", "flash_attention"):
        assert key in dispatch.launch_counts
        dispatch.launch_counts[key] = 2
    dispatch.reset_launch_counts()
    assert all(n == 0 for n in dispatch.launch_counts.values())


@pytest.mark.parametrize("bh,d,valid,want", [
    (32, 32, 900, 4 * 32 * 960 * 32), (24, 64, 4096, 4 * 24 * 4096 * 64),
    (24, 64, 4095, 4 * 24 * 4096 * 64), (1, 32, 1, 4 * 64 * 32), (2, 64, 64, 4 * 2 * 64 * 64),
    (2, 64, 65, 4 * 2 * 128 * 64), (32, 128, 900, 4 * 32 * 960 * 128),
    (8, 128, 1024, 4 * 8 * 1024 * 128), (1, 128, 33, 4 * 64 * 128),
    (32, 96, 900, 4 * 32 * 960 * 96), (1, 96, 1, 4 * 64 * 96),
    (32, 80, 900, 4 * 32 * 960 * 80), (8, 80, 256, 4 * 8 * 256 * 80)])
def test_tf32_scratch_holds_the_split_keys(bh, d, valid, want):
    """Scratch for K hi, K lo, V^T hi and V^T lo, each (BH, Kp, D) with Kp =
    valid_len rounded up to the pre-pass's 64 keys (at head dim 128 too,
    whose kernel walks 32-key tiles, and at 96 and 80)."""
    assert tfa.tf32_scratch_floats(bh, d, valid) == want


# --------------------------------------------------------------- schedule
@pytest.mark.parametrize("bh,s", [(32, 900), (8, 900), (24, 4096), (24, 4095), (6, 3072),
                                  (1, 1), (3, 65), (2, 128), (2, 129), (32, 1024), (8, 1024)])
def test_tf32_schedule_covers_each_row_once(bh, s):
    """The grid (ceil(S / 128), BH) puts every (head, row) in exactly one
    consumer warpgroup's 64 rows."""
    grid, tiles = tfa.tf32_schedule(bh, s)
    assert grid == (-(-s // 128), bh) and len(tiles) == grid[0] * bh
    seen = np.zeros((bh, s), np.int64)
    for (x, h), row0s in tiles.items():
        assert row0s == [128 * x, 128 * x + 64]
        for r0 in row0s:
            seen[h, r0:min(r0 + 64, s)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("d,tile,k_stages,v_stages", [(32, 64, 4, 4), (64, 64, 2, 2),
                                                      (80, 64, 2, 1), (96, 64, 1, 1),
                                                      (128, 32, 2, 1)])
def test_tf32_key_tile_fits_a_block(d, tile, k_stages, v_stages):
    """The kernel's key tile (``tf32_key_tile``) at each head dim, and why:
    its K and V^T stages (hi and lo of ``tile`` keys by D, four bytes each)
    beside both consumers' Q halves (2 x 2 x 64 x D) fit the 232 448 bytes
    a block may have, with the barriers and the 1024-byte alignment; 64-key
    tiles at head dim 128, even with one stage each, would not, and at head
    dim 96 only one stage of each fits, at head dim 80 two K stages and one
    V stage but not two of each. At head dim 80 K's and Q's rows are five
    16-float boxes (64 bytes, the 64-byte swizzle), which cover its 320-byte
    rows exactly, so the stages are the same bytes as at any other head dim.
    The tile also divides the pre-pass's 64-key padding."""
    assert tfa.tf32_key_tile(d) == tile and tfa.TF32_TILE % tile == 0
    smem = lambda t, ks, vs: (ks + vs) * 2 * t * d * 4 + 2 * 2 * 64 * d * 4 + 256 + 1024
    assert smem(tile, k_stages, v_stages) <= 232_448
    assert smem(64, 1, 1) > 232_448 or d != 128
    assert smem(64, 2, 1) > 232_448 >= smem(64, 1, 1) or d != 96
    assert smem(64, 2, 2) > 232_448 >= smem(64, 1, 2) or d != 80
    box = 16 if d == 80 else 32  # floats of a TMA box of K's and Q's rows
    assert d % box == 0 and 4 * box in (64, 128)


def test_tf32_key_order_turns_accumulators_into_a_fragments():
    """The m64nN f32 accumulator gives lane t (of a quad) columns 2 t and 2 t
    + 1 of each 8-column group; the m64k8 TF32 A fragment takes columns t
    and t + 4 (a0 (g, t), a2 (g, t + 4)). Handing the accumulator registers
    over as they are, fragment column j holds key TF32_KEY_ORDER[j], so V^T
    stores its keys in that order, a permutation of the group."""
    order = tfa.TF32_KEY_ORDER
    assert sorted(order) == list(range(8))
    for t in range(4):
        assert order[t] == 2 * t and order[t + 4] == 2 * t + 1


# -------------------------------------------------------------- arithmetic
@pytest.mark.parametrize("bh,s,valid,d,spread", [
    (4, 900, 900, 32, 1.0),  # the decoder's self-attention, 4 heads
    (2, 1024, 900, 32, 1.0),  # keys masked
    (2, 300, 300, 64, 1.0),  # ragged S at head dim 64
    (2, 257, 1, 32, 1.0),  # one valid key
    (3, 65, 65, 64, 1.0),  # one full and one ragged tile, 3 heads
    (2, 512, 449, 64, 3.0),  # sharp rows, many raised maxima
    (2, 600, 517, 32, 0.25),  # a flat softmax
    (2, 400, 400, 64, 2.0),
    (2, 1024, 900, 128, 1.0),  # head dim 128: 32-key tiles, keys masked
    (2, 1024, 900, 128, 3.0),  # sharp rows at head dim 128
    (3, 257, 33, 128, 1.0),  # head dim 128, the second tile's first key valid
    (2, 300, 300, 128, 0.25),
    (2, 1024, 900, 96, 1.0),  # head dim 96, keys masked
    (2, 1024, 900, 96, 3.0),  # sharp rows at head dim 96
    (3, 257, 33, 96, 1.0),  # head dim 96, the second tile's first key valid
    (2, 300, 300, 96, 0.25),
    (2, 1024, 900, 80, 1.0),  # head dim 80, keys masked
    (2, 1024, 900, 80, 3.0),  # sharp rows at head dim 80
    (3, 257, 33, 80, 1.0),  # head dim 80, the second tile's first key valid
    (2, 300, 300, 80, 0.25)])
def test_tf32_mirror_matches_plain(rng, bh, s, valid, d, spread):
    """The kernel's arithmetic against the plain version within 1e-4, over
    the four head dims, ragged S, keys masked and a spread of score
    scales."""
    q, k, v = _inputs(rng, (bh, s, d), spread)
    got = tfa.flash_tf32_mirror(q, k, v, valid)
    want = tfa.flash_attention_plain(q, k, v, valid)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


def test_tf32_mirror_beats_one_tf32_product(rng):
    """What the split buys: one TF32 product (hi only) misses 1e-4 on the
    decoder's shape where the three products hold it."""
    q, k, v = _inputs(rng, (2, 900, 32), 2.0)
    want = tfa.flash_attention_plain(q, k, v)
    one = tfa.flash_attention_plain(tfa.tf32_round(q), tfa.tf32_round(k), tfa.tf32_round(v))
    assert float((one - want).abs().max()) > TOL
    assert float((tfa.flash_tf32_mirror(q, k, v) - want).abs().max()) <= TOL


@pytest.mark.parametrize("bh,s,valid,d,spread", [
    (2, 1024, 900, 32, 1.0), (2, 512, 300, 64, 1.0), (2, 512, 512, 32, 3.0),
    (2, 256, 1, 64, 1.0), (2, 512, 449, 128, 1.0), (2, 512, 449, 128, 3.0),
    (2, 512, 449, 96, 1.0), (2, 512, 449, 96, 3.0), (2, 512, 449, 80, 1.0),
    (2, 512, 449, 80, 3.0)])
def test_tf32_mirror_matches_flash_masked(rng, jx, bh, s, valid, d, spread):
    """Keys >= valid_len masked: the mirror against the JAX ``_flash_masked``
    in interpret mode in f32, both within 1e-4 of the plain version."""
    q, k, v = _inputs(rng, (bh, s, d), spread)
    got = tfa.flash_tf32_mirror(q, k, v, valid)
    want = torch.from_numpy(np.array(jx.fa._flash_masked(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), valid, True)))
    plain = tfa.flash_attention_plain(q, k, v, valid)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("bh,s,d", [(2, 512, 64), (3, 1024, 32), (2, 512, 128), (2, 512, 96),
                                    (2, 512, 80)])
def test_tf32_mirror_matches_flash_attention(rng, jx, bh, s, d):
    """Every key valid: the mirror against the JAX ``flash_attention`` in
    interpret mode in f32 within 1e-4."""
    q, k, v = _inputs(rng, (bh, s, d))
    got = tfa.flash_tf32_mirror(q, k, v)
    want = torch.from_numpy(np.array(jx.fa.flash_attention(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), interpret=True)))
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("bh,s,d", [(2, 900, 32), (2, 300, 64), (2, 300, 128), (2, 300, 96),
                                    (2, 300, 80)])
def test_tf32_mirror_matches_attend(rng, jx, bh, s, d):
    """Through the JAX ``attend`` (S padded to 512 with the pad keys masked,
    the head dim padded to 128 lanes) in interpret mode, as the main path
    calls K2 and K3: the mirror with every key valid within 1e-4."""
    q, k, v = _inputs(rng, (bh, s, d))
    got = tfa.flash_tf32_mirror(q, k, v)
    want = torch.from_numpy(np.array(jx.fa.attend(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), interpret=True)))
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("spread", [1.0, 3.0])
def test_tf32_d96_mirror_matches_jax_over_score_scales(rng, jx, spread):
    """Head dim 96 with 900 of 1024 keys valid, unit scores and peaked rows:
    the mirror against the JAX ``_flash_masked`` in interpret mode and the
    plain version, each within 1e-4."""
    q, k, v = _inputs(rng, (2, 1024, 96), spread)
    got = tfa.flash_tf32_mirror(q, k, v, 900)
    want = torch.from_numpy(np.array(jx.fa._flash_masked(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), 900, True)))
    plain = tfa.flash_attention_plain(q, k, v, 900)
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("s,spread", [(300, 1.0), (300, 3.0), (512, 1.0), (512, 3.0)])
def test_tf32_d80_mirror_matches_attend(rng, jx, s, spread):
    """Head dim 80 through the JAX ``attend`` in interpret mode (its head dim
    padded to 128 lanes): at S 300 its pad keys masked (``_flash_masked``),
    at S 512 unmasked (``flash_attention``), unit scores and peaked rows.
    The mirror within 1e-4 of it and of the plain version."""
    q, k, v = _inputs(rng, (2, s, 80), spread)
    got = tfa.flash_tf32_mirror(q, k, v)
    want = torch.from_numpy(np.array(jx.fa.attend(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), interpret=True)))
    plain = tfa.flash_attention_plain(q, k, v)
    assert float((want - plain).abs().max()) <= TOL
    assert float((got - plain).abs().max()) <= TOL
    assert float((got - want).abs().max()) <= TOL


def test_tf32_wrapper_on_cpu_takes_the_plain_version(rng):
    """On CPU tensors ``flash_attention`` is the plain version and moves no
    counter."""
    q, k, v = _inputs(rng, (2, 300, 32))
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=250)
    assert dispatch.launch_counts == before
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v, 250))


def test_tf32_smem_split_is_built_only_as_a_variant():
    """The design that splits K and V in shared memory (no pre-pass) lies
    outside ``csrc`` (the port's library does not build it); only the
    ``tf32_smem_split`` variant builds it."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    assert kv.TF32_SMEM not in _build._files()
    assert kv.TF32_SMEM in os.listdir(kv.VARIANT_CSRC)
    assert {n for n, (src, _e) in kv.VARIANTS.items() if kv.TF32_SMEM in src} == {
        "tf32_smem_split"}


# -------------------------------------------------------------- on the card
def _moved(before):
    return [k for k, n in dispatch.launch_counts.items() if n != before[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,valid,d", [
    (8, 900, 900, 32), (32, 900, 900, 32), (32, 1024, 1024, 32), (32, 1024, 900, 32),
    (6, 4096, 4096, 64), (24, 4096, 4096, 64), (24, 3072, 3072, 64), (24, 4095, 4095, 64),
    (1, 256, 256, 32), (2, 257, 257, 64), (2, 319, 319, 32), (3, 300, 70, 64),
    (2, 257, 1, 64), (32, 1024, 900, 128), (8, 1024, 900, 128), (8, 4096, 4096, 128),
    (2, 257, 257, 128), (3, 300, 33, 128), (2, 256, 1, 128), (32, 1024, 900, 96),
    (8, 1024, 900, 96), (8, 4096, 4096, 96), (2, 257, 257, 96), (3, 300, 33, 96),
    (2, 256, 1, 96), (32, 1024, 900, 80), (8, 1024, 900, 80), (8, 4096, 4096, 80),
    (2, 257, 257, 80), (3, 300, 33, 80), (2, 256, 1, 80), (8, 256, 256, 80)])
def test_tf32_kernel_matches_plain_on_card(cuda_device, bh, s, valid, d):
    """The 3xTF32 kernel at K2's f32 shapes (one frame, the batch of 4,
    unmasked 1024, 900 of 1024 valid), K3's (one frame, the batch of 4, the
    rect grid, ragged 4095), head dims 128, 96 and 80 (900 of 1024 valid at 32
    and 8 heads, a long sequence) and edges (the shortest S it takes, ragged rows
    and tiles, keys masked inside the second tile, one valid key): within
    1e-4 of the plain version, one launch counted as
    ``flash_attention_tf32``."""
    g = torch.Generator(device=cuda_device).manual_seed(bh * s + valid + d)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device) for _ in range(3))
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    assert _moved(before) == ["flash_attention_tf32"]
    assert dispatch.launch_counts["flash_attention_tf32"] == before["flash_attention_tf32"] + 1
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [0.25, 3.0])
def test_tf32_kernel_over_score_scales_on_card(cuda_device, spread):
    """A flat and a sharp softmax at K3's one-frame shape within 1e-4."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn(6, 4096, 64, generator=g, device=cuda_device) for _ in range(3))
    q, k = q * spread, k * spread
    got = tfa.attend(q, k, v)
    want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1.0, 3.0])
def test_tf32_d128_over_score_scales_on_card(cuda_device, spread):
    """Head dim 128 at (32, 1024, 128) with 900 valid keys, unit scores and
    peaked rows: within 1e-4 of the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = (torch.randn(32, 1024, 128, generator=g, device=cuda_device) for _ in range(3))
    q, k = q * spread, k * spread
    got = tfa.flash_attention(q, k, v, valid_len=900)
    want = tfa.flash_attention_plain(q, k, v, valid_len=900)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1.0, 3.0])
def test_tf32_d96_over_score_scales_on_card(cuda_device, spread):
    """Head dim 96 at (32, 1024, 96) with 900 valid keys, unit scores and
    peaked rows: within 1e-4 of the plain version, on the 3xTF32 kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(13)
    q, k, v = (torch.randn(32, 1024, 96, generator=g, device=cuda_device) for _ in range(3))
    q, k = q * spread, k * spread
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=900)
    assert _moved(before) == ["flash_attention_tf32"]
    want = tfa.flash_attention_plain(q, k, v, valid_len=900)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1.0, 3.0])
def test_tf32_d80_over_score_scales_on_card(cuda_device, spread):
    """Head dim 80 at (32, 1024, 80) with 900 valid keys, unit scores and
    peaked rows: within 1e-4 of the plain version, on the 3xTF32 kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    q, k, v = (torch.randn(32, 1024, 80, generator=g, device=cuda_device) for _ in range(3))
    q, k = q * spread, k * spread
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=900)
    assert _moved(before) == ["flash_attention_tf32"]
    want = tfa.flash_attention_plain(q, k, v, valid_len=900)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d48", "d16", "misaligned", "short", "d128_short",
                                  "d96_short"])
def test_tf32_other_f32_calls_keep_the_fma_kernel_on_card(cuda_device, case):
    """f32 calls outside the predicate (head dim 48 or 16, an input off 16
    bytes, S below 256, at head dim 64, 96 and 128) stay on the FMA kernel,
    counted as ``flash_attention_f32``, within 1e-4."""
    d = {"d48": 48, "d16": 16, "d128_short": 128, "d96_short": 96}.get(case, 64)
    s, valid = (255, 200) if case.endswith("short") else (700, 650)
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = (torch.randn(2, s, d, generator=g, device=cuda_device) for _ in range(3))
    if case == "misaligned":
        q = torch.randn(2 * s * d + 1, generator=g, device=cuda_device)[1:].view(2, s, d)
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    assert _moved(before) == ["flash_attention_f32"]
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_tf32_route_and_scratch_match_the_c_side_on_card(cuda_device):
    """``tf32_route`` says what ``bff_flash_tf32_takes`` says, and
    ``tf32_scratch_floats`` what ``bff_flash_tf32_scratch_floats`` says."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    for dtype in (0, 1):
        for d in (16, 32, 64, 80, 96, 112, 128):
            for s, valid in ((900, 900), (1024, 900), (256, 1), (255, 255), (1, 1), (900, 0),
                             (900, 901)):
                for scale in (d ** -0.5, 0.0, -1.0, float("inf"), float("nan"), 1e39):
                    for ptrs in (_A, (0, 4, 0, 0), (0, 0, 0, 8)):
                        want = bool(lib.bff_flash_tf32_takes(
                            dtype, d, s, valid, ctypes.c_float(scale),
                            *(ctypes.c_void_p(p) for p in ptrs)))
                        assert tfa.tf32_route(dtype, d, s, valid, scale, *ptrs) is want
    for bh, d, valid in ((32, 32, 900), (24, 64, 4095), (1, 32, 1), (2, 64, 65), (32, 128, 900),
                         (1, 128, 33), (32, 80, 900), (1, 96, 1)):
        assert lib.bff_flash_tf32_scratch_floats(bh, d, valid) == tfa.tf32_scratch_floats(
            bh, d, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [80, 96, 128])
def test_tf32_fma_yardstick_entry_matches_plain_on_card(cuda_device, d):
    """``bff_flash_attention_f32_fma``, the FMA kernel that the measurements
    time beside the 3xTF32 one on the same call, computes the same function
    within 1e-4 and moves no counter."""
    from beyondff_tpu_torch.kernels import _build

    g = torch.Generator(device=cuda_device).manual_seed(d)
    q, k, v = (torch.randn(4, 512, d, generator=g, device=cuda_device) for _ in range(3))
    out = torch.empty_like(q)
    before = dict(dispatch.launch_counts)
    rc = _build.library().bff_flash_attention_f32_fma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 4, 512, d, 450, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0 and dispatch.launch_counts == before
    assert float((out - tfa.flash_attention_plain(q, k, v, 450)).abs().max()) <= TOL


@pytest.mark.cuda
def test_tf32_entry_refuses_a_missing_scratch_on_card(cuda_device):
    """A call the predicate takes with no scratch returns -1 and launches
    nothing: the kernel needs its split keys and never falls back."""
    from beyondff_tpu_torch.kernels import _build

    q = torch.randn(2, 300, 32, device=cuda_device)
    out = torch.empty_like(q)
    rc = _build.library().bff_flash_attention(
        0, q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), 2, 300, 32, 300,
        ctypes.c_float(_S32), torch.cuda.current_stream().cuda_stream, None)
    assert rc == -1
