"""K2 (Grounding-DINO's head-dim-32 self-attention) on wgmma and TMA
(``csrc/flash_masked_wgmma.cu``) and the NMS scan on a cluster per frame
(``csrc/nms_fixed.cu``).

On the CPU: K2's routing rule (``masked_wgmma_route``, the mirror of the C
predicate ``bff_flash_masked_wgmma_takes``), its grid
(``masked_wgmma_schedule``), its arithmetic (``masked_wgmma_mirror``: the
tile walk, the key mask, the lazily raised max) against the JAX kernels in
interpret mode; the NMS kernel's rounds (``nms.cluster_scan_mirror``) index
for index against the JAX ``nms_fixed``, its division-free decision
(``nms.iou_exceeds``) against the f32 division, and the helpers that draw
and measure the NMS input (``clustered_boxes``, ``iou_tests``,
``split_spans``). Tests that need the card carry the ``cuda``
marker and import nothing of JAX:
``python -m pytest --noconftest -m cuda tests/test_torch_hopper_k2_nms.py``.
"""

import numpy as np
import pytest
import torch

from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels import flash_attention as tfa
from beyondff_tpu_torch.kernels import nms as tnms

torch.set_num_threads(2)

_S32 = 32 ** -0.5
_A = (0, 256, 512, 1024)  # q, k, v, o: 16-byte aligned


@pytest.fixture
def jx():
    import types

    pytest.importorskip("jax")
    import jax.numpy as jnp

    from beyondff_tpu.kernels import flash_attention as jfa
    from beyondff_tpu.models import yolo_world as jyw

    return types.SimpleNamespace(jnp=jnp, fa=jfa, yw=jyw)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest --noconftest -m cuda tests/test_torch_hopper_k2_nms.py")
    return torch.device("cuda")


# ------------------------------------------------------------------ K2 route
@pytest.mark.parametrize("args,takes", [
    ((1, 32, 900, 900, _S32, *_A), True),  # the decoder's self-attention
    ((1, 32, 1024, 900, _S32, *_A), True),  # keys masked
    ((1, 32, 1, 1, 1.0, *_A), True),  # one key, any positive scale
    ((1, 32, 4096, 1536, _S32, *_A), True),  # the most keys shared memory holds
    ((1, 32, 4096, 1537, _S32, *_A), False),  # one more: the mma.sync tile
    ((1, 32, 900, 0, _S32, *_A), False),  # no valid key
    ((1, 32, 900, 901, _S32, *_A), False),  # valid_len past S
    ((0, 32, 900, 900, _S32, *_A), False),  # f32: the 3xTF32 kernel
    ((1, 64, 1024, 900, 0.125, *_A), False),  # head dim 64, keys masked: the tile
    ((1, 16, 900, 900, 0.25, *_A), False),
    ((1, 80, 900, 900, 80 ** -0.5, *_A), False),
    ((1, 32, 900, 900, _S32, 0, 8, 0, 0), False),  # k off 16 bytes
    ((1, 32, 900, 900, _S32, 0, 0, 0, 4), False),  # the output off 16 bytes
    ((1, 32, 900, 900, 0.0, *_A), False),
    ((1, 32, 900, 900, -_S32, *_A), False),
    ((1, 32, 900, 900, float("inf"), *_A), False),
    ((1, 32, 900, 900, float("nan"), *_A), False),
    ((1, 32, 900, 900, 1e39, *_A), False),  # inf once rounded to f32
])
def test_masked_wgmma_route_pins_the_predicate(args, takes):
    """The Python mirror of ``bff_flash_masked_wgmma_takes``: bf16, head dim
    32, 1 <= valid_len <= S and at most 1536 valid keys, a positive finite
    f32 scale, 16-byte aligned q, k, v and output; and the counter a call
    moves (K3's predicate is asked first and takes none of these)."""
    assert tfa.masked_wgmma_route(*args) is takes
    other = "flash_attention_tf32" if args[0] == 0 else "flash_attention"  # f32: D 32, aligned
    assert tfa.flash_counter(*args) == ("flash_masked_wgmma" if takes else other)


def test_masked_wgmma_counter_is_registered():
    assert "flash_masked_wgmma" in dispatch.launch_counts
    dispatch.launch_counts["flash_masked_wgmma"] = 3
    dispatch.reset_launch_counts()
    assert dispatch.launch_counts["flash_masked_wgmma"] == 0


# --------------------------------------------------------------- K2 schedule
@pytest.mark.parametrize("bh,s,c", [(32, 900, 4), (8, 900, 1), (24, 900, 4), (1, 1, 1),
                                    (3, 65, 1), (200, 1024, 4), (64, 100, 1), (16, 900, 2)])
def test_masked_wgmma_schedule_covers_each_row_once(bh, s, c):
    """The grid of ``csrc/flash_masked_wgmma.cu`` puts every (head, row) in
    exactly one warpgroup's 64-row tile, with the consumers a block its
    rule picks: four at the batch of 4's (32, 900), one at one frame's."""
    got_c, grid, tiles = tfa.masked_wgmma_schedule(bh, s)
    assert got_c == c and grid == (-(-s // (64 * c)), bh) and len(tiles) == grid[0] * bh
    seen = np.zeros((bh, s), np.int64)
    for (x, h), row0s in tiles.items():
        assert len(row0s) == c and row0s[0] == 64 * c * x
        for r0 in row0s:
            seen[h, r0:min(r0 + 64, s)] += 1
    assert (seen == 1).all()


# ------------------------------------------------------------ K2 arithmetic
def _bf16_inputs(rng, shape):
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).bfloat16()
            for _ in range(3)]


@pytest.mark.parametrize("spread", [1.0, 0.25, 4.0])
def test_masked_wgmma_mirror_matches_attend(rng, jx, spread):
    """The kernel's arithmetic at the batch-of-4 frame's decoder shape cut
    to 4 heads, (4, 900, 32) bf16, against the JAX ``attend`` (S padded to
    1024, keys >= 900 masked, ``_flash_masked`` in interpret mode): within
    ``bf16_error_bound`` of the plain version, as the JAX kernel is, with Q
    and K scaled by ``spread`` (a flat softmax, or sharp rows whose running
    max is raised past the lazy 2^8 on many tiles)."""
    q, k, v = _bf16_inputs(rng, (4, 900, 32))
    q, k = (q.float() * spread).bfloat16(), (k.float() * spread).bfloat16()
    got = tfa.masked_wgmma_mirror(q, k, v)
    want = np.asarray(jx.fa.attend(*(jx.jnp.asarray(t.float().numpy(), jx.jnp.bfloat16)
                                     for t in (q, k, v)), interpret=True).astype(np.float32))
    plain = tfa.flash_attention_plain(q, k, v)
    bound = tfa.bf16_error_bound(q, k, v, plain)
    assert float(((got.float() - plain.float()).abs() - bound).max()) <= 0.0
    assert float(((torch.from_numpy(want) - plain.float()).abs() - bound).max()) <= 0.0
    assert float((got.float() - torch.from_numpy(want)).abs().max()) <= 1.6e-2


@pytest.mark.parametrize("bh,s,valid", [(4, 1024, 900), (2, 512, 300), (2, 256, 1),
                                        (2, 512, 449)])
def test_masked_wgmma_mirror_masks_keys_as_flash_masked(rng, jx, bh, s, valid):
    """Keys >= valid_len masked (the last valid tile ragged, or one key):
    the mirror against the JAX ``_flash_masked`` in interpret mode, both
    within ``bf16_error_bound`` of the plain version."""
    q, k, v = _bf16_inputs(rng, (bh, s, 32))
    got = tfa.masked_wgmma_mirror(q, k, v, valid)
    want = np.asarray(jx.fa._flash_masked(
        *(jx.jnp.asarray(t.float().numpy(), jx.jnp.bfloat16) for t in (q, k, v)), valid,
        True).astype(np.float32))
    plain = tfa.flash_attention_plain(q, k, v, valid)
    bound = tfa.bf16_error_bound(q, k, v, plain, valid)
    assert float(((got.float() - plain.float()).abs() - bound).max()) <= 0.0
    assert float(((torch.from_numpy(want) - plain.float()).abs() - bound).max()) <= 0.0


@pytest.mark.parametrize("s", [1, 63, 64, 65, 130])
def test_masked_wgmma_mirror_ragged_rows(rng, s):
    """A ragged S (rows past S computed on zero-filled Q and not written):
    within the bound of the plain version."""
    q, k, v = _bf16_inputs(rng, (3, s, 32))
    got = tfa.masked_wgmma_mirror(q, k, v)
    plain = tfa.flash_attention_plain(q, k, v)
    bound = tfa.bf16_error_bound(q, k, v, plain)
    assert float(((got.float() - plain.float()).abs() - bound).max()) <= 0.0


# ------------------------------------------------------------ NMS decision
def _thresholds():
    tiny = np.finfo(np.float32).tiny
    return [0.5, 0.45, 0.7, 0.3333333, 1.0, tiny, tiny / 4, 0.0, -0.25, 2.0]


@pytest.mark.parametrize("thr", _thresholds())
def test_iou_decision_equals_the_division(thr):
    """The division-free decision against ``inter / denom > thr`` in f32
    over 2^20 random pairs (IoU-like and arbitrary magnitudes) and 2^20
    adversarial ones: inter stepped by single ulps around f32(thr * denom),
    zero intersections, zero and huge denominators, nan and inf."""
    rng = np.random.default_rng(int(abs(thr) * 1e6) + 1)
    n = 1 << 20
    area = rng.uniform(0, 5000, (2, n)).astype(np.float32)
    inter = (np.minimum(area[0], area[1]) * rng.uniform(0, 1, n)).astype(np.float32)
    inter[::7] = 0
    denom = ((area[0] + area[1]) - inter) + np.float32(1e-9)
    mags = np.exp2(rng.uniform(-140, 120, (2, n))).astype(np.float32)
    rand_inter = np.concatenate([inter, mags[0]])
    rand_denom = np.concatenate([denom, mags[1]])
    # around the threshold: inter within +-64 ulps of f32(thr * denom)
    d = np.exp2(rng.uniform(-30, 30, n)).astype(np.float32)
    steps = rng.integers(-64, 65, n).astype(np.int32)
    base = (np.float32(thr) * d).astype(np.float32)
    near = (base.view(np.int32) + steps).view(np.float32) if thr > 0 else base
    near = np.abs(near)
    special = np.array([0, 1e-9, np.inf, np.nan, 1e-45, 3e38], np.float32)
    adv_inter = np.concatenate([near, np.repeat(special, len(special)), np.zeros(16, np.float32)])
    adv_denom = np.concatenate([d, np.tile(special, len(special)),
                                np.full(16, 1e-9, np.float32)])
    t = np.float32(thr)
    for i_, d_ in ((rand_inter, rand_denom), (adv_inter, adv_denom)):
        with np.errstate(all="ignore"):
            want = (i_ / d_) > t
        assert np.array_equal(tnms.iou_exceeds(i_, d_, thr), want)


# -------------------------------------------------------------- NMS rounds
def _clustered(rng, b, a, spread=10.0, n_centers=60):
    centers = rng.uniform(0, 640, (b, n_centers, 2))
    pick = rng.integers(0, n_centers, (b, a))
    c = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(size=(b, a, 2)) * spread
    half = rng.uniform(8, 68, (b, a, 2))
    return (np.concatenate([c - half, c + half], -1).astype(np.float32),
            rng.uniform(0, 1, (b, a)).astype(np.float32))


def _jax_nms(jx, boxes, scores, thr, top_k):
    out = [jx.yw.nms_fixed(jx.jnp.asarray(b), jx.jnp.asarray(s), thr, top_k)
           for b, s in zip(boxes, scores)]
    return (np.stack([np.asarray(k) for k, _v in out]).astype(np.int32),
            np.stack([np.asarray(v) for _k, v in out]))


def _assert_nms_equal(got, want):
    assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("top_k,cluster,look", [(100, 8, 4), (5, 8, 4), (3000, 8, 4),
                                                (100, 1, 4), (100, 16, 2), (100, 8, 1),
                                                (7, 8, 2)])
def test_cluster_scan_mirror_matches_jax_nms(rng, jx, top_k, cluster, look):
    """The kernel's rounds over its slices index for index against the JAX
    ``nms_fixed`` on clustered boxes (2 frames of 2 000): top_k below the
    kept count, inside a round's look-ahead, and above the kept count
    (padding with index 0, not valid); also with one block and with 16 a
    frame, and offering 1, 2 or 4 boxes a block a round."""
    boxes, scores = _clustered(rng, 2, 2000)
    want = _jax_nms(jx, boxes, scores, 0.5, top_k)
    got = tnms.cluster_scan_mirror(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                                   top_k, cluster, look)
    _assert_nms_equal(got[:2], want)
    assert want[1].sum(1).min() >= min(top_k, 5)


def test_look_ahead_cuts_the_rounds(rng):
    """Offering 4 free boxes a block a round resolves the main path's 100
    kept boxes a frame (8 400 clustered anchors) in under half the rounds of
    one box a round, which takes one round a kept box; the results agree."""
    boxes, scores = (torch.from_numpy(x) for x in _clustered(rng, 2, 8400))
    one = tnms.cluster_scan_mirror(boxes, scores, 0.5, 100, look=1)
    four = tnms.cluster_scan_mirror(boxes, scores, 0.5, 100, look=4)
    assert torch.equal(one[0], four[0]) and torch.equal(one[1], four[1])
    assert one[2] == [101, 101] or one[2] == [100, 100]
    assert max(four[2]) < min(one[2]) / 2


def test_cluster_scan_mirror_zero_area_and_ties(rng, jx):
    """Zero-area and inverted boxes (area 0: they suppress nothing and are
    suppressed by nothing at a positive threshold) and tied scores (kept in
    index order), index for index against the JAX ``nms_fixed``."""
    boxes, scores = _clustered(rng, 2, 1500)
    boxes[:, ::5, 2] = boxes[:, ::5, 0]  # zero width
    boxes[:, 1::9, 3] = boxes[:, 1::9, 1] - 4  # inverted
    scores = np.round(scores * 6) / 6
    want = _jax_nms(jx, boxes, scores.astype(np.float32), 0.5, 2000)
    got = tnms.cluster_scan_mirror(torch.from_numpy(boxes),
                                   torch.from_numpy(scores.astype(np.float32)), 0.5, 2000)
    _assert_nms_equal(got[:2], want)


def test_cluster_scan_mirror_on_the_threshold(rng, jx):
    """Thresholds set to IoUs of pairs of the input and to the floats one
    ulp either side of them, so pairs sit on the threshold to within one
    ulp: index for index against the JAX ``nms_fixed``."""
    boxes, scores = _clustered(rng, 1, 800, spread=3.0)
    bs = boxes[0]
    area = (np.maximum(bs[:, 2] - bs[:, 0], 0) * np.maximum(bs[:, 3] - bs[:, 1], 0))
    inter = (np.maximum(np.minimum(bs[0, 2], bs[1:, 2]) - np.maximum(bs[0, 0], bs[1:, 0]), 0)
             * np.maximum(np.minimum(bs[0, 3], bs[1:, 3]) - np.maximum(bs[0, 1], bs[1:, 1]), 0))
    iou = (inter / ((area[0] + area[1:] - inter) + np.float32(1e-9))).astype(np.float32)
    on = iou[(iou > 0.2) & (iou < 0.8)][:3]
    assert len(on) == 3
    for t in on:
        for thr in (np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1))):
            want = _jax_nms(jx, boxes, scores, float(thr), 400)
            got = tnms.cluster_scan_mirror(torch.from_numpy(boxes), torch.from_numpy(scores),
                                           float(thr), 400)
            _assert_nms_equal(got[:2], want)


@pytest.mark.parametrize("a,cluster", [(8400, 8), (2000, 8), (33, 8), (1, 8), (90112, 8),
                                       (8400, 16), (8400, 1)])
def test_cluster_slices_partition_the_frame(a, cluster):
    """The kernel's slices: ``cluster`` runs of a multiple of 32 boxes that
    cover [0, a) once, in order, none past what a block holds."""
    sl = tnms.cluster_slices(a, cluster)
    assert len(sl) == cluster and sl[0][0] == 0
    width = sl[0][1] - sl[0][0] if a > sl[0][1] else -(-(-(-a // cluster)) // 32) * 32
    assert width % 32 == 0 and width <= tnms.MAX_SLICE
    covered = np.zeros(a, np.int64)
    for lo, hi in sl:
        covered[lo:max(lo, hi)] += 1
    assert (covered == 1).all()


def test_clustered_boxes_are_seeded_and_well_formed():
    """The NMS input the measurements draw: the same generator seed gives
    the same boxes and scores, another seed others; every box has x2 > x1
    and y2 > y1, scores lie in [0, 1)."""
    draw = lambda seed, **kw: tnms.clustered_boxes(torch.Generator().manual_seed(seed), 3, 500,
                                                   **kw)
    boxes, scores = draw(4)
    again = draw(4)
    assert boxes.shape == (3, 500, 4) and scores.shape == (3, 500)
    assert torch.equal(boxes, again[0]) and torch.equal(scores, again[1])
    assert not torch.equal(boxes, draw(5)[0])
    assert bool((boxes[..., 2:] > boxes[..., :2]).all())
    assert bool(((scores >= 0) & (scores < 1)).all())
    tight = draw(4, centres=40, spread=3.0, half_min=5.0)[0]
    half = (tight[..., 2:] - tight[..., :2]) / 2
    assert bool((half >= 5.0).all()) and bool((half < 65.0 + 1e-3).all())


@pytest.mark.parametrize("top_k", [1, 20, 500])
def test_iou_tests_count_each_kept_box_against_the_later_ones(top_k):
    """The bound's count: for each kept box, the boxes after it in the
    stable descending score order, as a loop over the plain result counts
    them."""
    boxes, scores = tnms.clustered_boxes(torch.Generator().manual_seed(top_k), 2, 300)
    scores = torch.round(scores * 16) / 16  # ties in the mix
    keep, valid = tnms.nms_fixed_plain(boxes, scores, 0.5, top_k)
    want = 0
    for f in range(2):
        order = torch.sort(scores[f].neg(), stable=True).indices.tolist()
        for idx, ok in zip(keep[f].tolist(), valid[f].tolist()):
            if ok:
                want += 300 - 1 - order.index(idx)
    assert tnms.iou_tests(keep, valid, scores) == want


def test_split_spans_sorts_the_kernels_into_sort_gather_scan():
    """Device spans (start and end in microseconds, kernel name) over two
    calls: kernels named ``nms`` are the scan, ``gather`` the gather, every
    other one (the negation, the sort's own kernels) the sort; ms a call."""
    spans = [(0.0, 10.0, "void at::native::neg_kernel"), (10.0, 40.0, "cub::DeviceRadixSort"),
             (40.0, 44.0, "void at::native::_scatter_gather_elementwise_kernel"),
             (44.0, 244.0, "nms_fixed_kernel"), (300.0, 340.0, "cub::DeviceRadixSort"),
             (340.0, 344.0, "Gather"), (344.0, 544.0, "nms_fixed_kernel")]
    got = tnms.split_spans(spans, 2)
    assert got == pytest.approx({"sort_ms": 0.04, "gather_ms": 0.004, "scan_ms": 0.2})


def test_nms_anchor_limit_follows_the_slices():
    assert tnms.MAX_ANCHORS == tnms.CLUSTER * tnms.MAX_SLICE == 90112


# ---------------------------------------------------------------- variants
@pytest.mark.parametrize("name", ["k2_poly_1", "k2_poly_2", "k2_poly_4",
                                  "k2_rescale_always", "k2_no_peel",
                                  "k2_scores_read",
                                  "k2_serial", "k2_no_pingpong", "k2_serial_no_pingpong",
                                  "k2_consumers_4",
                                  "k2_consumers_2", "k2_consumers_1", "nms_cluster_1", "nms_cluster_4",
                                  "nms_cluster_16", "nms_look_1", "nms_look_2",
                                  "nms_threads_256", "nms_threads_1024", "nms_divide"])
def test_k2_nms_variant_edits_match_the_sources(name):
    """Each K2 or NMS variant of ``tools/kernel_variants.py`` is a set of
    edits that must each match its source once."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    sources, edits = kv.VARIANTS[name]
    assert edits and set(sources) <= set(kv.SOURCES)
    for fname, old, new in edits:
        with open(os.path.join(_build.CSRC, fname)) as f:
            assert f.read().count(old) == 1, (fname, old)
        assert new != old


@pytest.mark.parametrize("tiles", [1, 2, 4])
def test_k2_polynomial_is_only_a_variant(tiles):
    """The polynomial 2^x lost on the card, so the shipped K2 source holds
    none of it; the ``k2_poly_*`` variants insert the helper and route the
    first ``tiles`` column tiles' exponentials through it."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    with open(os.path.join(_build.CSRC, kv.FMW)) as f:
        text = f.read()
    assert "exp2_poly" not in text and "kPolyTiles" not in text
    for _fname, old, new in kv.VARIANTS[f"k2_poly_{tiles}"][1]:
        text = text.replace(old, new)
    assert f"constexpr int kPolyTiles = {tiles};" in text
    assert text.count("exp2_tile(fmaf(") == 4 and "bff_tc::exp2_approx(fmaf(s" not in text


def test_nms_cluster_16_alone_allows_a_non_portable_cluster():
    """Clusters above 8 blocks need the non-portable attribute: only the
    ``nms_cluster_16`` variant sets it, the shipped entry (8 blocks) does
    not."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    attr = "cudaFuncAttributeNonPortableClusterSizeAllowed"
    with open(os.path.join(_build.CSRC, kv.NMS)) as f:
        assert attr not in f.read()
    assert {n for n, (_s, edits) in kv.VARIANTS.items()
            if any(attr in new for _f, _o, new in edits)} == {"nms_cluster_16"}


def test_nms_bitmask_is_built_only_as_a_variant():
    """The bitmask design (b) lies outside ``csrc`` (the port's library does
    not build it); only the ``nms_bitmask`` variant builds it."""
    import os

    from beyondff_tpu_torch.kernels import _build
    from beyondff_tpu_torch.tools import kernel_variants as kv

    assert kv.NMB not in _build._files() and kv.NMB in os.listdir(kv.VARIANT_CSRC)
    assert {n for n, (src, _e) in kv.VARIANTS.items() if kv.NMB in src} == {"nms_bitmask"}


# --------------------------------------------------------------- on the card
def _moved(before):
    return [k for k, n in dispatch.launch_counts.items() if n != before[k]]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,valid", [(32, 900, 900), (8, 900, 900), (32, 1024, 900),
                                        (2, 1, 1), (2, 63, 63), (2, 64, 64), (2, 65, 65),
                                        (3, 1024, 1024), (2, 1536, 1536), (2, 1000, 129),
                                        (2, 600, 1)])
def test_k2_wgmma_matches_plain_on_card(cuda_device, bh, s, valid):
    """K2's wgmma kernel against the plain version within
    ``bf16_error_bound`` and 1.6e-2: the decoder's shapes at 4 frames and
    one, keys masked, and ragged S (1, 63, 64, 65, 1024) with rows past S
    not written; counted as ``flash_masked_wgmma`` only."""
    g = torch.Generator(device=cuda_device).manual_seed(bh * s + valid)
    q, k, v = (torch.randn(bh, s, 32, generator=g, device=cuda_device).bfloat16()
               for _ in range(3))
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    assert _moved(before) == ["flash_masked_wgmma"]
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    bound = tfa.bf16_error_bound(q, k, v, want, valid)
    assert float(((got.float() - want.float()).abs() - bound).max()) <= 0.0
    assert float((got.float() - want.float()).abs().max()) <= 1.6e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["past_keys", "misaligned", "f32", "d64_masked"])
def test_k2_other_calls_keep_their_kernels_on_card(cuda_device, case):
    """Calls outside K2's predicate keep their kernels, counted as
    ``flash_attention``: more valid keys than shared memory holds, an input
    off 16 bytes, and head dim 64 with keys masked; f32 takes the 3xTF32
    kernel, counted as ``flash_attention_tf32``."""
    d = 64 if case == "d64_masked" else 32
    s, valid = {"past_keys": (2048, 1600), "d64_masked": (1024, 900)}.get(case, (900, 900))
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(2, s, d, generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    if case == "misaligned":
        q = torch.randn(2 * s * d + 4, generator=g, device=cuda_device).bfloat16()[4:]
        q = q.view(2, s, d)
    before = dict(dispatch.launch_counts)
    got = tfa.flash_attention(q, k, v, valid_len=valid)
    assert _moved(before) == ["flash_attention_tf32" if case == "f32" else "flash_attention"]
    want = tfa.flash_attention_plain(q, k, v, valid_len=valid)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-4
    else:
        bound = tfa.bf16_error_bound(q, k, v, want, valid)
        assert float(((got.float() - want.float()).abs() - bound).max()) <= 0.0


@pytest.mark.cuda
def test_k2_route_matches_the_c_predicate_on_card(cuda_device):
    """``masked_wgmma_route`` says what ``bff_flash_masked_wgmma_takes`` says."""
    import ctypes

    from beyondff_tpu_torch.kernels import _build

    lib = _build.library()
    cases = [(1, 32, 900, 900, _S32, *_A), (1, 32, 4096, 1537, _S32, *_A),
             (1, 32, 900, 900, _S32, 0, 8, 0, 0), (0, 32, 900, 900, _S32, *_A),
             (1, 64, 900, 900, _S32, *_A), (1, 32, 900, 0, _S32, *_A)]
    for dtype, d, s, valid, scale, *ptrs in cases:
        c = lib.bff_flash_masked_wgmma_takes(dtype, d, s, valid, ctypes.c_float(scale),
                                             *(ctypes.c_void_p(p or 16) for p in ptrs))
        assert bool(c) is tfa.masked_wgmma_route(dtype, d, s, valid, scale,
                                                  *(p or 16 for p in ptrs))


@pytest.mark.cuda
@pytest.mark.parametrize("b,a,top_k", [(4, 8400, 100), (1, 8400, 100), (4, 8400, 9000),
                                       (2, 33, 10), (2, 1, 5), (3, 2000, 1), (1, 90112, 300)])
def test_nms_cluster_matches_plain_on_card(cuda_device, b, a, top_k):
    """The cluster kernel index for index against the plain version and the
    mirror of its rounds: the main path's 4 x 8 400, one frame, top_k above
    the kept count, a frame smaller than the cluster's slices, one box,
    top_k 1 and the most anchors the kernel takes; one launch a call."""
    gen = torch.Generator(device=cuda_device).manual_seed(a + top_k)
    boxes, scores = tnms.clustered_boxes(gen, b, a)
    before = dict(dispatch.launch_counts)
    keep, valid = tnms.nms_fixed(boxes, scores, 0.5, top_k)
    assert _moved(before) == ["nms_fixed"] and dispatch.launch_counts["nms_fixed"] == (
        before["nms_fixed"] + 1)
    want = tnms.nms_fixed_plain(boxes, scores, 0.5, top_k)
    torch.cuda.synchronize()
    assert torch.equal(keep, want[0]) and torch.equal(valid, want[1])
    if a <= 10000:
        mirror = tnms.cluster_scan_mirror(boxes.cpu(), scores.cpu(), 0.5, top_k)
        assert torch.equal(keep.cpu(), mirror[0]) and torch.equal(valid.cpu(), mirror[1])


@pytest.mark.cuda
def test_nms_cluster_on_the_threshold_on_card(cuda_device):
    """Thresholds on IoUs of pairs of the input and one ulp either side, tied
    scores: index for index against the plain version (the division-free
    test falls back to the division there)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    boxes, scores = tnms.clustered_boxes(gen, 2, 2000, spread=3.0)
    scores = torch.round(scores * 8) / 8
    bs = boxes[0]
    area = (bs[:, 2] - bs[:, 0]).clamp_min(0) * (bs[:, 3] - bs[:, 1]).clamp_min(0)
    inter = ((torch.minimum(bs[0, 2], bs[1:, 2]) - torch.maximum(bs[0, 0], bs[1:, 0]))
             .clamp_min(0) * (torch.minimum(bs[0, 3], bs[1:, 3])
                              - torch.maximum(bs[0, 1], bs[1:, 1])).clamp_min(0))
    iou = (inter / (area[0] + area[1:] - inter + 1e-9)).cpu().numpy()
    on = iou[(iou > 0.2) & (iou < 0.8)][:4]
    assert len(on) == 4
    for t in on:
        for thr in (np.nextafter(t, np.float32(0)), t, np.nextafter(t, np.float32(1))):
            keep, valid = tnms.nms_fixed(boxes, scores, float(thr), 300)
            want = tnms.nms_fixed_plain(boxes, scores, float(thr), 300)
            torch.cuda.synchronize()
            assert torch.equal(keep, want[0]) and torch.equal(valid, want[1]), float(thr)


@pytest.mark.cuda
def test_nms_rejects_more_anchors_than_the_slices_hold_on_card(cuda_device):
    boxes = torch.zeros(1, tnms.MAX_ANCHORS + 1, 4, device=cuda_device)
    scores = torch.zeros(1, tnms.MAX_ANCHORS + 1, device=cuda_device)
    with pytest.raises(ValueError, match="exceed"):
        tnms.nms_fixed(boxes, scores, 0.5, 10)
