"""SAM ViT-H's head-dim-80 rel-pos attention on wgmma and TMA (K4 and K5 in
``csrc/relpos_attention_wgmma.cu``).

On the CPU: the routing rule (``relpos_wgmma_route``, the mirror of the C
predicate ``bff_relpos_wgmma_takes``), the kernels' fragment index
arithmetic (``relpos_wgmma_fragment``, the mirror the ``.cu`` file names)
against ``relpos_bias``, and the plain versions against the JAX kernels in
interpret mode at head dim 80 on the rect grid. Tests that need the card
carry the ``cuda`` marker and import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_relpos_wgmma.py``.
"""

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels import flash_attention as tfa
from beyondff_tpu_torch.kernels import window_attention as twa

torch.set_num_threads(2)

_S80 = 80 ** -0.5
_A = (0, 256, 512, 1024, 2048, 4096)  # q, k, v, o, bias_h, bias_w: 16-byte aligned


@pytest.fixture
def jx():
    import types

    pytest.importorskip("jax")
    import jax.numpy as jnp

    from beyondff_tpu.kernels import flash_attention as jfa
    from beyondff_tpu.kernels import window_attention as jwa

    return types.SimpleNamespace(jnp=jnp, fa=jfa, wa=jwa)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_relpos_wgmma.py")
    return torch.device("cuda")


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("args,takes", [
    ((0, 1, 80, 4096, 64, 64, _S80, *_A), True),  # SAM ViT-H's global grid
    ((0, 1, 80, 3072, 48, 64, _S80, *_A), True),  # the rect grid
    ((0, 1, 80, 64, 1, 64, 2.0, *_A), True),  # one grid row, any positive scale
    ((0, 1, 80, 320, 5, 64, _S80, *_A), True),  # an odd kh: a ragged last key tile
    ((1, 1, 80, 196, 14, 14, _S80, *_A), True),  # SAM ViT-H's 14 x 14 windows
    ((0, 0, 80, 4096, 64, 64, _S80, *_A), False),  # f32: the FMA kernel
    ((1, 0, 80, 196, 14, 14, _S80, *_A), False),
    ((0, 1, 64, 4096, 64, 64, 0.125, *_A), False),  # another head dim: the mma.sync tile
    ((1, 1, 32, 196, 14, 14, _S80, *_A), False),
    ((0, 1, 80, 4096, 128, 32, _S80, *_A), False),  # kw 32
    ((0, 1, 80, 8192, 128, 64, _S80, *_A), False),  # kh past 64
    ((0, 1, 80, 4095, 64, 64, _S80, *_A), False),  # S off the grid
    ((1, 1, 80, 256, 16, 16, _S80, *_A), False),  # 16 x 16 windows
    ((1, 1, 80, 196, 14, 14, _S80, 0, 0, 0, 0, 0, 8), False),  # bias_w off 16 bytes
    ((0, 1, 80, 4096, 64, 64, _S80, 0, 0, 0, 0, 4, 0), False),  # bias_h off 16 bytes
    ((0, 1, 80, 4096, 64, 64, _S80, 0, 8, 0, 0, 0, 0), False),  # k off 16 bytes
    ((0, 1, 80, 4096, 64, 64, _S80, 0, 0, 0, 2, 0, 0), False),  # the output off 16 bytes
    ((0, 1, 80, 4096, 64, 64, 0.0, *_A), False),
    ((1, 1, 80, 196, 14, 14, -_S80, *_A), False),
    ((0, 1, 80, 4096, 64, 64, float("inf"), *_A), False),
    ((0, 1, 80, 4096, 64, 64, float("nan"), *_A), False),
    ((0, 1, 80, 4096, 64, 64, 1e39, *_A), False),  # inf once rounded to f32
    ((2, 1, 80, 196, 14, 14, _S80, *_A), False),  # no such entry
])
def test_relpos_wgmma_route_pins_the_predicate(args, takes):
    """The Python mirror of ``bff_relpos_wgmma_takes``, which decides in the
    rel-pos entries the calls the wgmma kernels take and the counters they
    count under: bf16, head dim 80, kw = 64 with kh <= 64 (K4) or 14 x 14
    windows (K5), a positive finite f32 scale, six 16-byte aligned pointers."""
    assert tfa.relpos_wgmma_route(*args) is takes


# -------------------------------------------------- the fragment arithmetic
@pytest.mark.parametrize("kind,tile,keys", [(0, 0, 128), (0, 1, 128), (0, 31, 128),
                                            (1, 0, 200), (1, 1, 200), (1, 3, 200)])
def test_relpos_wgmma_fragment_covers_each_score_once(kind, tile, keys):
    """The 128 lanes of a warpgroup hold each (row, key) of the m64n128 tile
    (K4, key tile ``tile``) or the m64n200 tile (K5, m-tile ``tile``) exactly
    once, as the wgmma accumulator layout places them."""
    seen = {}
    for warp in range(4):
        for lane in range(32):
            regs = tfa.relpos_wgmma_fragment(kind, warp, lane, tile)
            assert [r[0] for r in regs] == list(range(len(regs)))
            for _i, row, key, *_ in regs:
                seen[(row, key)] = seen.get((row, key), 0) + 1
    row0 = 64 * tile if kind == 1 else 0
    key0 = 128 * tile if kind == 0 else 0
    assert seen == {(row0 + r, key0 + c): 1 for r in range(64) for c in range(keys)}


@pytest.mark.parametrize("kind,rows,cols", [(0, 64, 64), (0, 48, 64), (1, 14, 14)])
def test_relpos_wgmma_fragment_gathers_relpos_bias(kind, rows, cols):
    """The factors gathered through the fragment arithmetic, bias_h at
    (table row, ky) plus bias_w at (table row, kx) in f32 from bf16, equal
    ``relpos_bias`` at every score of every tile of SAM ViT-H's 64 x 64 and
    48 x 64 grids (K4) and of a 14 x 14 window (K5); K5's masked keys lie
    past S and its padded rows read the last row's factors."""
    s = rows * cols
    gen = torch.Generator().manual_seed(rows)
    bias_h = torch.randn(1, s, rows, generator=gen).bfloat16()
    bias_w = torch.randn(1, s, cols, generator=gen).bfloat16()
    dense = tfa.relpos_bias(bias_h, bias_w, torch.bfloat16)[0]
    fh, fw = bias_h[0].float(), bias_w[0].float()
    # K4: every key tile, for every 64-row slice of the queries (the
    # arithmetic is the same for each slice); K5: the four m-tiles
    q0s = torch.arange(0, s, 64) if kind == 0 else torch.zeros(1, dtype=torch.long)
    masked = 0
    for t in range(s // 128) if kind == 0 else range(4):
        regs = [r for warp in range(4) for lane in range(32)
                for r in tfa.relpos_wgmma_fragment(kind, warp, lane, t, s)]
        masked += sum(r[3] is None for r in regs)
        assert all(r[2] >= s for r in regs if r[3] is None)
        row, key, ky, kx, trow = (torch.tensor([r[i] for r in regs if r[3] is not None])
                                  for i in range(1, 6))
        q, tr = q0s[:, None] + row, q0s[:, None] + trow
        got = fh[tr, ky] + fw[tr, kx]
        assert torch.equal(got, dense[tr, key.expand_as(tr)])
        real = q < s
        assert torch.equal(tr[real], q[real]) and bool((tr[~real] == s - 1).all())
    assert masked == (4 * 64 * (200 - s) if kind == 1 else 0)


# -------------------------------------------- plain twins against the JAX kernels
def _inputs(rng, g, rows, cols, d, scale=0.5):
    s = rows * cols
    q, k, v = (rng.standard_normal((g, s, d)).astype(np.float32) for _ in range(3))
    bias_h = (rng.standard_normal((g, s, rows)) * scale).astype(np.float32)
    bias_w = (rng.standard_normal((g, s, cols)) * scale).astype(np.float32)
    return q, k, v, bias_h, bias_w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_plain_matches_pallas_on_the_rect_grid(jx, dtype):
    """K4's plain version and the CPU wrapper against the JAX
    ``attend_relpos`` in interpret mode at SAM ViT-H's head dim 80 on the
    rect 48 x 64 grid: f32 within 2e-4 / 2e-5, bf16 within the derived
    bound 2^-8 |P|@|V| + 2^-7 |plain| + 1e-4 (the bound the card holds the
    wgmma kernel to)."""
    q, k, v, bias_h, bias_w = _inputs(np.random.default_rng(48), 1, 48, 64, 80)
    jt = jx.jnp.bfloat16 if dtype == "bfloat16" else jx.jnp.float32
    want = jx.fa.attend_relpos(*(jx.jnp.asarray(a, jt) for a in (q, k, v)),
                               jx.jnp.asarray(bias_h), jx.jnp.asarray(bias_w), 64, interpret=True)
    want = torch.from_numpy(np.array(want.astype(jx.jnp.float32)))
    tt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tt) for a in (q, k, v))
    th, tw = torch.from_numpy(bias_h), torch.from_numpy(bias_w)
    before = dict(dispatch.launch_counts)
    for got in (tfa.attend_relpos_plain(tq, tk, tv, th, tw, 64),
                tfa.attend_relpos(tq, tk, tv, th, tw, 64)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)
        else:
            bound = tfa.bf16_error_bound(tq, tk, tv, got, bias_h=th, bias_w=tw)
            assert float(((got.float() - want).abs() - bound).max()) <= 0.0
    assert dispatch.launch_counts == before  # the plain version counts nothing


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_pallas_on_the_rect_grids_windows(jx, dtype):
    """K5's plain version and the CPU wrapper against the JAX
    ``window_attention_relpos`` in interpret mode at head dim 80 on the 20
    windows of 14 x 14 that tile the rect grid (48 x 64 padded to 56 x 70):
    f32 within 2e-4 / 2e-5, bf16 within the derived bound."""
    q, k, v, bias_h, bias_w = _inputs(np.random.default_rng(20), 20, 14, 14, 80)
    jt = jx.jnp.bfloat16 if dtype == "bfloat16" else jx.jnp.float32
    want = jx.wa.window_attention_relpos(*(jx.jnp.asarray(a, jt) for a in (q, k, v)),
                                         jx.jnp.asarray(bias_h), jx.jnp.asarray(bias_w), 14, 14,
                                         interpret=True)
    want = torch.from_numpy(np.array(want.astype(jx.jnp.float32)))
    tt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tt) for a in (q, k, v))
    th, tw = torch.from_numpy(bias_h), torch.from_numpy(bias_w)
    before = dict(dispatch.launch_counts)
    for got in (twa.window_attention_relpos_plain(tq, tk, tv, th, tw, 14, 14),
                twa.window_attention_relpos(tq, tk, tv, th, tw, 14, 14)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-5)
        else:
            bound = tfa.bf16_error_bound(tq, tk, tv, got, bias_h=th, bias_w=tw)
            assert float(((got.float() - want).abs() - bound).max()) <= 0.0
    assert dispatch.launch_counts == before


def test_new_counters_are_registered_and_reset():
    for key in ("flash_attention_relpos_wgmma", "window_attention_relpos_wgmma"):
        dispatch.launch_counts[key] += 3
    dispatch.reset_launch_counts()
    assert dispatch.launch_counts["flash_attention_relpos_wgmma"] == 0
    assert dispatch.launch_counts["window_attention_relpos_wgmma"] == 0


# ----------------------------------------------------------------- the card
def _launched(before):
    return [k for k, n in dispatch.launch_counts.items() if n != before[k]]


def _card_inputs(dev, g, rows, cols, dtype=torch.bfloat16, d=80, scale=0.1):
    """q, k, v from a seeded generator; the factors as SAM builds them, q .
    R products of rel-pos tables at ``scale`` (``sam._rel_pos_factors``)."""
    from beyondff_tpu_torch.models import sam as sam_mod

    gen = torch.Generator(device=dev).manual_seed(g * rows * cols)
    q, k, v = (torch.randn(g, rows * cols, d, device=dev, generator=gen).to(dtype)
               for _ in range(3))
    rel_h = (scale * torch.randn(2 * rows - 1, d, device=dev, generator=gen)).to(dtype)
    rel_w = (scale * torch.randn(2 * cols - 1, d, device=dev, generator=gen)).to(dtype)
    bias_h, bias_w = sam_mod._rel_pos_factors((rows, cols), (rows, cols), rel_h, rel_w, q)
    return q, k, v, bias_h.to(dtype).contiguous(), bias_w.to(dtype).contiguous()


def _check(got, want, q, k, v, bias_h, bias_w):
    bound = tfa.bf16_error_bound(q, k, v, want, bias_h=bias_h, bias_w=bias_w)
    assert torch.isfinite(got.float()).all()
    excess = float(((got.float() - want.float()).abs() - bound).max())
    assert excess <= 0.0, float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("g,rows,scale", [
    (64, 64, 0.1), (16, 64, 0.1), (64, 48, 0.1),  # SAM ViT-H: B 4, one frame, rect B 4
    (2, 64, 3.0),  # factors at scale 3: a peaked softmax, the running max raised often
    (3, 5, 0.1), (2, 1, 0.1), (1, 63, 0.1)])  # odd kh: a ragged last key and query tile
def test_k4_wgmma_matches_plain_on_card(cuda_device, g, rows, scale):
    """K4's wgmma/TMA kernel against the plain version within the derived
    bf16 bound, counted as ``flash_attention_relpos_wgmma`` only."""
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, g, rows, 64, scale=scale)
    before = dict(dispatch.launch_counts)
    got = tfa.attend_relpos(q, k, v, bias_h, bias_w, 64)
    assert _launched(before) == ["flash_attention_relpos_wgmma"]
    want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, 64)
    torch.cuda.synchronize()
    _check(got, want, q, k, v, bias_h, bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("g,scale", [(1600, 0.1), (400, 0.1), (1, 0.1), (3, 3.0), (133, 0.1),
                                     (265, 0.1)])
def test_k5_wgmma_matches_plain_on_card(cuda_device, g, scale):
    """K5's wgmma/TMA kernel against the plain version within the derived
    bf16 bound: SAM ViT-H's windows at the batch of 4 and at one frame, one
    window, peaked factors, and window counts that leave some blocks of the
    persistent grid one window more than others; counted as
    ``window_attention_relpos_wgmma`` only."""
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, g, 14, 14, scale=scale)
    before = dict(dispatch.launch_counts)
    got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, 14, 14)
    assert _launched(before) == ["window_attention_relpos_wgmma"]
    want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, 14, 14)
    torch.cuda.synchronize()
    _check(got, want, q, k, v, bias_h, bias_w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "d64", "kw32", "misaligned", "window_16", "window_f32"])
def test_other_relpos_calls_keep_their_routes_on_card(cuda_device, case):
    """Calls outside the predicate keep the mma.sync tile or the FMA kernels
    and their counters: f32 (at head dim 96: f32 at 64 and 80 takes the
    3xTF32 kernels), head dim 64, a 32-wide grid, a bf16 input off 16 bytes,
    16 x 16 windows and f32 windows (head dim 64); each within its bound."""
    window = case.startswith("window")
    rows, cols = ((16, 16) if case == "window_16" else (14, 14)) if window else (
        (64, 32) if case == "kw32" else (16, 64))
    dtype = torch.float32 if case in ("f32", "window_f32") else torch.bfloat16
    d = {"f32": 96, "d64": 64, "window_f32": 64}.get(case, 80)
    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, 3, rows, cols, dtype, d=d)
    if case == "misaligned":
        buf = torch.empty(q.numel() + 4, dtype=q.dtype, device=cuda_device)
        q = buf[4:].view(q.shape).copy_(q)  # 8 bytes past an aligned base
    key = "window_attention_relpos" if window else "flash_attention_relpos"
    before = dict(dispatch.launch_counts)
    if window:
        got = twa.window_attention_relpos(q, k, v, bias_h, bias_w, rows, cols)
        want = twa.window_attention_relpos_plain(q, k, v, bias_h, bias_w, rows, cols)
    else:
        got = tfa.attend_relpos(q, k, v, bias_h, bias_w, cols)
        want = tfa.attend_relpos_plain(q, k, v, bias_h, bias_w, cols)
    assert _launched(before) == [key]
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4
    else:
        _check(got, want, q, k, v, bias_h, bias_w)


@pytest.mark.cuda
def test_relpos_wgmma_route_matches_the_c_predicate_on_card(cuda_device):
    """``relpos_wgmma_route`` says what ``bff_relpos_wgmma_takes`` says, over
    the kinds, dtypes, head dims, grids, scales and alignments around the
    predicate's edges."""
    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    grids = ((64, 64), (48, 64), (1, 64), (5, 64), (65, 64), (64, 32), (14, 14), (16, 16),
             (7, 28))
    for kind in (0, 1, 2):
        for dtype in (0, 1):
            for d in (64, 80, 128):
                for rows, cols in grids:
                    for s in (rows * cols, rows * cols - 1):
                        for scale in (d ** -0.5, 0.0, -1.0, float("inf")):
                            for slot, off in ((0, 0), (1, 8), (3, 2), (4, 4), (5, 16)):
                                ptrs = [4096 * (i + 1) for i in range(6)]
                                ptrs[slot] += off
                                want = tfa.relpos_wgmma_route(kind, dtype, d, s, rows, cols,
                                                              scale, *ptrs)
                                got = lib.bff_relpos_wgmma_takes(kind, dtype, d, s, rows, cols,
                                                                 scale, *ptrs)
                                assert bool(got) is want, (kind, dtype, d, s, rows, cols,
                                                           scale, slot, off)


@pytest.mark.cuda
def test_relpos_wgmma_raises_on_a_failed_launch_on_card(cuda_device, monkeypatch):
    """A code from the C entry raises, naming the route; nothing falls back
    and nothing is counted."""
    from beyondff_tpu_torch.kernels import _build

    q, k, v, bias_h, bias_w = _card_inputs(cuda_device, 2, 64, 64)

    class Failing:
        def __getattr__(self, name):
            return lambda *a: -1000 - 1

    monkeypatch.setattr(_build, "library", lambda: Failing())
    before = dict(dispatch.launch_counts)
    with pytest.raises(RuntimeError, match="flash_attention_relpos_wgmma"):
        tfa.attend_relpos(q, k, v, bias_h, bias_w, 64)
    assert dispatch.launch_counts == before
