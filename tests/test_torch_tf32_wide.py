"""f32 flash attention off the FMA kernel: head dims 144 to 256 on the wide
3xTF32 kernel and head dim 112 on the 3xTF32 kernel's ``Cfg<112>``.

Route 1: f32 at head dims 144 to 256 in steps of 16 takes K4 f32's wide
kernel (``csrc/relpos_attention_wide_tf32.cu``) with a key mask for its
score modifier (``wide_tf32_route``, the mirror of
``bff_flash_wide_tf32_takes``; counter ``flash_attention_wide_tf32``).
Route 2: f32 at head dim 112 takes ``csrc/flash_attention_tf32.cu``
(``tf32_route``; counter ``flash_attention_tf32``).

On the CPU: each kernel's arithmetic (``wide_tf32_mirror``,
``flash_tf32_mirror``) against ``flash_attention_plain`` and against the
JAX ``attend`` / ``_flash_masked`` in interpret mode, both routes'
predicates and the counter a call moves, route 1's plan against a block's
shared memory and its scratch, and the ``kernel_variants`` edits of both
routes' losers. The
``cuda`` cases hold each route on the card against its plain version and
its counter, each C predicate against its mirror, and the FMA kernel at the
shapes it keeps; they import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_tf32_wide.py``.
Tolerance: 1e-4, the f32 calls' everywhere in the repository.
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
WIDE_TF32 = "flash_attention_wide_tf32"


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
                    "python -m pytest --noconftest -m cuda tests/test_torch_tf32_wide.py")
    return torch.device("cuda")


def _qkv(seed, shape, spread=1.0):
    """q, k, v from a numpy seed; q and k scaled by ``spread``."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    return torch.from_numpy(q * spread), torch.from_numpy(k * spread), torch.from_numpy(v)


# ------------------------------------------------------------- the mirrors
@pytest.mark.parametrize("spread", [1.0, 3.0])
@pytest.mark.parametrize("bh,s,valid,d", [(2, 300, 251, 160), (1, 256, 256, 256),
                                          (2, 200, 77, 144), (1, 64, 64, 256),
                                          (2, 130, 129, 224), (1, 200, 1, 192),
                                          (1, 100, 99, 176)])
def test_wide_tf32_mirror_matches_plain(bh, s, valid, d, spread):
    """Route 1's arithmetic (blocks of 64 rows, Q scaled and split, 32-key
    tiles (16 at DP 256) up to ``valid_len``, the keys past it in the last
    tile at -inf, each tile's P V summed apart) against
    ``flash_attention_plain`` within 1e-4, at unit scale and on peaked
    rows."""
    q, k, v = _qkv(s + d + valid, (bh, s, d), spread)
    got = tfa.wide_tf32_mirror(q, k, v, valid)
    want = tfa.flash_attention_plain(q, k, v, valid)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("spread", [1.0, 3.0])
@pytest.mark.parametrize("bh,s,valid", [(2, 300, 251), (1, 256, 256), (2, 64, 50)])
def test_d112_mirror_matches_plain(bh, s, valid, spread):
    """Route 2's arithmetic (``flash_tf32_mirror`` at head dim 112: the
    pre-pass, 32-key tiles, P V accumulated across them) against
    ``flash_attention_plain`` within 1e-4, at unit scale and on peaked
    rows."""
    assert tfa.tf32_key_tile(112) == 32
    q, k, v = _qkv(s + valid, (bh, s, 112), spread)
    got = tfa.flash_tf32_mirror(q, k, v, valid)
    want = tfa.flash_attention_plain(q, k, v, valid)
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("d", [112, 160, 256])
@pytest.mark.parametrize("valid", [256, 200])
def test_mirrors_match_jax(jx, d, valid):
    """Against the JAX kernels in interpret mode at S 256: ``attend`` (every
    key valid, ``flash_attention``) and ``_flash_masked`` (keys past 200
    masked), within 1e-4: route 2's mirror at head dim 112, route 1's at 160
    and 256."""
    q, k, v = _qkv(d + valid, (2, 256, d))
    jq, jk, jv = (jx.jnp.asarray(t.numpy()) for t in (q, k, v))
    if valid == 256:
        want = np.asarray(jx.fa.attend(jq, jk, jv, interpret=True))
    else:
        want = np.asarray(jx.fa._flash_masked(jq, jk, jv, valid, True, d ** -0.5))
    mirror = tfa.flash_tf32_mirror if d == 112 else tfa.wide_tf32_mirror
    got = mirror(q, k, v, valid).numpy()
    assert float(np.abs(got - want).max()) <= TOL


def test_wide_tf32_mirror_with_the_bias_is_the_relpos_mirror():
    """The rel-pos mirror is the same row walk with the bias as its modifier:
    a zero bias gives the key-mask mirror's output with every key valid, bit
    for bit."""
    q, k, v = _qkv(7, (1, 96, 160))
    zeros_h, zeros_w = torch.zeros(1, 96, 8), torch.zeros(1, 96, 12)
    got = tfa.relpos_wide_tf32_mirror(q, k, v, zeros_h, zeros_w, 12)
    assert torch.equal(got, tfa.wide_tf32_mirror(q, k, v))


# ------------------------------------------------------- the routes' rules
_WIDE_CASES = [
    ((0, 160, 1024, 1024, 160 ** -0.5, *_A), True),  # every key valid
    ((0, 160, 1024, 900, 160 ** -0.5, *_A), True),  # keys masked
    ((0, 256, 1024, 900, 256 ** -0.5, *_A), True),
    ((0, 144, 1000, 999, 144 ** -0.5, *_A), True),  # the smallest instance's padded columns
    ((0, 176, 300, 300, 176 ** -0.5, *_A), True),
    ((0, 256, 64, 64, 256 ** -0.5, *_A), True),  # short sequences: no lower bound
    ((0, 160, 1, 1, 1.0, *_A), True),  # the shortest S, one valid key
    ((0, 160, 1024, 0, 160 ** -0.5, *_A), False),  # no valid key
    ((0, 160, 1024, 1025, 160 ** -0.5, *_A), False),  # valid_len past S
    ((0, 160, 1024, 900, 0.0, *_A), False),
    ((0, 160, 1024, 900, -1.0, *_A), False),
    ((0, 160, 1024, 900, float("inf"), *_A), False),
    ((0, 160, 1024, 900, float("nan"), *_A), False),
    ((0, 160, 1024, 900, 1e39, *_A), False),  # inf once rounded to f32
    ((0, 160, 1024, 900, 160 ** -0.5, 4, 256, 512, 1024), False),  # q off 16 bytes
    ((0, 160, 1024, 900, 160 ** -0.5, 0, 260, 512, 1024), False),  # k off 16 bytes
    ((0, 160, 1024, 900, 160 ** -0.5, 0, 256, 520, 1024), False),  # v off 16 bytes
    ((0, 160, 1024, 900, 160 ** -0.5, 0, 256, 512, 1028), False),  # the output off 16 bytes
    ((0, 168, 1024, 900, 168 ** -0.5, *_A), False),  # no multiple of 16: the FMA slices
    ((0, 264, 1024, 900, 264 ** -0.5, *_A), False),  # past 256: the FMA slices
    ((0, 128, 1024, 900, 128 ** -0.5, *_A), False),  # not past 128
    ((1, 160, 1024, 900, 160 ** -0.5, *_A), False),  # bf16: the wide wgmma kernel
]


@pytest.mark.parametrize("args,takes", _WIDE_CASES)
def test_wide_tf32_route(args, takes):
    """The mirror of ``bff_flash_wide_tf32_takes``: f32, head dim a multiple
    of 16 from 144 to 256, any S (the kernel beat the FMA slices at every S
    measured, from 64 on), 1 <= valid_len <= S, a positive finite f32
    scale, q, k, v and the output on 16 bytes."""
    assert tfa.wide_tf32_route(*args) is takes


_D112_CASES = [
    ((0, 112, 1024, 900, 112 ** -0.5, *_A), True),
    ((0, 112, 900, 900, 112 ** -0.5, *_A), True),
    ((0, 112, 256, 1, 1.0, *_A), True),  # the shortest S, one valid key
    ((0, 112, 255, 255, 112 ** -0.5, *_A), False),  # shorter: the FMA kernel
    ((0, 112, 1024, 0, 112 ** -0.5, *_A), False),
    ((0, 112, 1024, 1025, 112 ** -0.5, *_A), False),
    ((0, 112, 1024, 900, 0.0, *_A), False),
    ((0, 112, 1024, 900, -1.0, *_A), False),
    ((0, 112, 1024, 900, float("inf"), *_A), False),
    ((0, 112, 1024, 900, float("nan"), *_A), False),
    ((0, 112, 1024, 900, 1e39, *_A), False),
    ((0, 112, 1024, 900, 112 ** -0.5, 4, 256, 512, 1024), False),
    ((0, 112, 1024, 900, 112 ** -0.5, 0, 260, 512, 1024), False),
    ((0, 112, 1024, 900, 112 ** -0.5, 0, 256, 520, 1024), False),
    ((0, 112, 1024, 900, 112 ** -0.5, 0, 256, 512, 1028), False),
    ((1, 112, 1024, 900, 112 ** -0.5, *_A), False),  # bf16: the tile
    ((0, 48, 1024, 900, 48 ** -0.5, *_A), False),  # head dim 48 keeps the FMA kernel
    ((0, 16, 1024, 900, 0.25, *_A), False),  # and 16
]


@pytest.mark.parametrize("args,takes", _D112_CASES)
def test_tf32_route_takes_d112(args, takes):
    """``tf32_route`` takes head dim 112 under the rules of the other head
    dims (S >= 256, 1 <= valid_len <= S, a positive finite f32 scale, every
    pointer on 16 bytes); head dims 16 and 48 stay on the FMA kernel."""
    assert 112 in tfa.TF32_HEAD_DIMS and 48 not in tfa.TF32_HEAD_DIMS
    assert tfa.tf32_route(*args) is takes


@pytest.mark.parametrize("dtype,d,s,valid,ptrs,counter", [
    (0, 160, 1024, 1024, _A, WIDE_TF32), (0, 160, 1024, 900, _A, WIDE_TF32),
    (0, 256, 1024, 900, _A, WIDE_TF32), (0, 256, 4096, 4096, _A, WIDE_TF32),
    (0, 144, 1000, 999, _A, WIDE_TF32), (0, 256, 64, 64, _A, WIDE_TF32),
    (0, 168, 1024, 900, _A, "flash_attention_f32"),
    (0, 264, 1024, 900, _A, "flash_attention_f32"),
    (0, 160, 1024, 900, (4, 256, 512, 1024), "flash_attention_f32"),
    (1, 160, 1024, 900, _A, "flash_attention_wide_wgmma"),
    (0, 112, 1024, 900, _A, "flash_attention_tf32"),
    (0, 112, 256, 256, _A, "flash_attention_tf32"),
    (0, 112, 255, 255, _A, "flash_attention_f32"),
    (0, 112, 1024, 900, (0, 256, 516, 1024), "flash_attention_f32"),
    (0, 48, 1024, 900, _A, "flash_attention_f32"),
    (1, 112, 1024, 900, _A, "flash_attention")])
def test_flash_counter_takes_the_new_routes(dtype, d, s, valid, ptrs, counter):
    """The counter a call moves, in the order ``bff_flash_attention`` takes
    its routes: the wide wgmma kernel (bf16), then the wide 3xTF32 kernel
    (f32 at 144-256), then the 3xTF32 kernel (f32 at 112 among its head
    dims), then the FMA kernel or the tile."""
    assert tfa.flash_counter(dtype, d, s, valid, d ** -0.5, *ptrs) == counter


@pytest.mark.parametrize("d", tfa.WIDE_WGMMA_HEAD_DIMS)
def test_wide_tf32_plan_fits(d):
    """Route 1's plan (the kernel's ``Cfg<DP>``, shared with K4 f32): DP = D
    rounded up to 32, 32-key tiles (16 at DP 256), fold parts that cover DP,
    and Q's images for 64 rows beside one K and one V^T stage within the
    232 448 bytes a block may hold."""
    plan = tfa.relpos_wide_tf32_plan(d)
    dp = plan["dp"]
    assert dp % 32 == 0 and 0 <= dp - d < 32
    assert plan["keys"] == (16 if dp == 256 else 32)
    assert plan["fold"] * plan["parts"] == dp
    assert plan["smem"] == 2 * 64 * dp * 4 + 4 * plan["keys"] * dp * 4 + 64 + 1024
    assert plan["smem"] <= 232448


@pytest.mark.parametrize("bh,d,valid,want", [
    (16, 160, 900, 4 * 16 * 29 * 32 * 160), (16, 144, 999, 4 * 16 * 32 * 32 * 160),
    (16, 256, 900, 4 * 16 * 57 * 16 * 256), (1, 224, 1, 4 * 1 * 1 * 32 * 224),
    (2, 192, 64, 4 * 2 * 2 * 32 * 192)])
def test_wide_tf32_scratch_floats(bh, d, valid, want):
    """Route 1's scratch: the pre-pass's four images (K hi, K lo, V^T hi,
    V^T lo) of every tile up to ``valid_len``, each tile N keys x DP
    columns."""
    assert tfa.wide_tf32_scratch_floats(bh, d, valid) == want


def test_d112_stages_fit():
    """Route 2's stages at head dim 112 (``Cfg<112>``: 32-key tiles, two K
    stages and one V stage) beside both consumers' Q halves within a block's
    232 448 bytes; the measured loser (64-key tiles, one stage each) fits
    with under 2 KB to spare."""
    q = 2 * 2 * 64 * 112 * 4  # two consumers' Q hi and lo
    stage = lambda keys: 2 * keys * 112 * 4  # hi and lo
    shipped = q + 2 * stage(32) + stage(32) + 256 + 1024
    loser = q + stage(64) + stage(64) + 256 + 1024
    assert shipped <= 232448 and 0 < 232448 - loser < 2048


def test_wide_tf32_counter_is_registered_and_cpu_takes_plain():
    """The route counts under its own counter; CPU tensors at its shapes take
    the plain version and move no counter."""
    assert WIDE_TF32 in dispatch.launch_counts
    q, k, v = _qkv(3, (1, 80, 160))
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=70)
    assert dispatch.launch_counts == before
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v, 70))


@pytest.mark.parametrize("name,source,n_edits", [
    ("tf32_d112_keys_64", "flash_attention_tf32.cu", 1),
    ("tf32_d112_keys_64_opaque", "flash_attention_tf32.cu", 2),
    ("wide_tf32_split_on_chip", "relpos_attention_wide_tf32.cu", 1)])
def test_variant_edits_match_the_sources(name, source, n_edits):
    """``kernel_variants``' losers of both routes (route 2: 64-key tiles, one
    K and one V stage, also with Q's addresses opaque; route 1: K and V
    split by the producer on the chip) are edits that each match their
    source once; the K2/K3 variants build the wide 3xTF32 kernel's source,
    which ``bff_flash_attention`` calls."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    sources, edits = kv.VARIANTS[name]
    assert source in sources and len(edits) == n_edits
    for fname, old, new in edits:
        assert fname == source and new != old
        with open(os.path.join(_build.CSRC, fname)) as f:
            assert f.read().count(old) == 1
    assert kv.RWT in kv.K3


# -------------------------------------------------------------- on the card
def _moved(before):
    return [key for key, n in dispatch.launch_counts.items() if n != before[key]]


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1.0, 3.0])
@pytest.mark.parametrize("bh,s,valid,d", [(16, 1024, 1024, 160), (16, 1024, 900, 160),
                                          (16, 1024, 900, 256), (4, 1000, 999, 144),
                                          (2, 300, 77, 224), (2, 64, 64, 256), (3, 1, 1, 192)])
def test_wide_tf32_matches_plain_on_card(cuda_device, bh, s, valid, d, spread):
    """Route 1 on the card: one launch counted as
    ``flash_attention_wide_tf32``, within 1e-4 of the plain version at unit
    scale and on peaked rows."""
    g = torch.Generator(device=cuda_device).manual_seed(s + d + valid)
    q, k, v = (torch.randn(bh, s, d, generator=g, device=cuda_device) for _ in range(3))
    q, k = q * spread, k * spread
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    assert _moved(before) == [WIDE_TF32]
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [1.0, 3.0])
@pytest.mark.parametrize("bh,s,valid", [(32, 1024, 900), (8, 1024, 900), (8, 256, 256),
                                        (2, 700, 650)])
def test_d112_matches_plain_on_card(cuda_device, bh, s, valid, spread):
    """Route 2 on the card: one launch counted as ``flash_attention_tf32``,
    within 1e-4 of the plain version at unit scale and on peaked rows."""
    g = torch.Generator(device=cuda_device).manual_seed(s + valid)
    q, k, v = (torch.randn(bh, s, 112, generator=g, device=cuda_device) for _ in range(3))
    q, k = q * spread, k * spread
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    assert _moved(before) == ["flash_attention_tf32"]
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_attend_at_head_dim_160_takes_route_1_on_card(cuda_device):
    """``attend`` (the entry a model calls) at head dim 160 in f32."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(4, 300, 160, generator=g, device=cuda_device) for _ in range(3))
    before = dict(dispatch.launch_counts)
    got = tfa.attend(q, k, v)
    assert _moved(before) == [WIDE_TF32]
    want = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.cuda
def test_predicates_match_the_c_side_on_card(cuda_device):
    """``wide_tf32_route`` says what ``bff_flash_wide_tf32_takes`` says and
    ``tf32_route`` what ``bff_flash_tf32_takes`` says, over both tables."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    for args, _takes in _WIDE_CASES + _D112_CASES:
        dtype, d, s, valid, scale, *ptrs = args
        c_args = (dtype, d, s, valid, ctypes.c_float(scale), *(ctypes.c_void_p(p) for p in ptrs))
        assert bool(lib.bff_flash_wide_tf32_takes(*c_args)) is tfa.wide_tf32_route(*args), args
        assert bool(lib.bff_flash_tf32_takes(*c_args)) is tfa.tf32_route(*args), args
    for bh, d, valid in ((16, 160, 900), (16, 144, 999), (16, 256, 900), (1, 224, 1),
                         (2, 192, 64), (16, 256, 4096)):
        assert lib.bff_flash_wide_tf32_scratch_floats(bh, d, valid) == (
            tfa.wide_tf32_scratch_floats(bh, d, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d168", "d264", "d48", "misaligned_d160", "misaligned_d112",
                                  "short_d112"])
def test_fma_kernel_keeps_its_shapes_on_card(cuda_device, case):
    """f32 calls outside both routes (head dims 168, 264 and 48, an input off
    16 bytes at 160 and 112, head dim 112 below S 256) stay on the FMA
    kernel, counted as ``flash_attention_f32``, within 1e-4."""
    d = {"d168": 168, "d264": 264, "d48": 48, "misaligned_d160": 160}.get(case, 112)
    s, valid = (255, 200) if case == "short_d112" else (700, 650)
    g = torch.Generator(device=cuda_device).manual_seed(d + s)
    q, k, v = (torch.randn(2, s, d, generator=g, device=cuda_device) for _ in range(3))
    if case.startswith("misaligned"):
        k = torch.randn(2 * s * d + 1, generator=g, device=cuda_device)[1:].view(2, s, d)
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    assert _moved(before) == ["flash_attention_f32"]
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL
