"""The port's 3D half (projection -> refinement -> evaluation) vs the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in beyondff_tpu_torch. Masks, labels, groups, counts, pixel ids
and depths must be equal; merged confidences, whose float32 sums may be
taken in another order, agree within 1e-6. The JAX side runs as its own tests
run it (8 virtual CPU devices, so its projection takes the sharded lift,
whose psum-reduced counts are exact).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.config import FilteringConfig as JFilteringConfig
from beyondff_tpu.core import aggregation as jagg
from beyondff_tpu.core import filtering as jfilt
from beyondff_tpu.core import geometry as jgeo
from beyondff_tpu.core import masks as jmasks
from beyondff_tpu.core import refine as jref
from beyondff_tpu.core import rle as jrle
from beyondff_tpu.eval import ScanNetEval as JScanNetEval
from beyondff_tpu.models import clip as jclip
from beyondff_tpu.models.tokenizers import HashTokenizer as JHashTokenizer
from beyondff_tpu.pipeline import evaluate as jevaluate
from beyondff_tpu.pipeline import projection as jprojection
from beyondff_tpu.pipeline import refinement as jrefinement
from beyondff_tpu.pipeline import text_sim as jtext_sim
from beyondff_tpu.utils import io as jio
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.config import FilteringConfig as TFilteringConfig
from beyondff_tpu_torch.core import aggregation as tagg
from beyondff_tpu_torch.core import filtering as tfilt
from beyondff_tpu_torch.core import geometry as tgeo
from beyondff_tpu_torch.core import masks as tmasks
from beyondff_tpu_torch.core import refine as tref
from beyondff_tpu_torch.core import rle as trle
from beyondff_tpu_torch.eval import ScanNetEval as TScanNetEval
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models.tokenizers import HashTokenizer as THashTokenizer
from beyondff_tpu_torch.pipeline import evaluate as tevaluate
from beyondff_tpu_torch.pipeline import projection as tprojection
from beyondff_tpu_torch.pipeline import refinement as trefinement
from beyondff_tpu_torch.pipeline import text_sim as ttext_sim
from beyondff_tpu_torch.utils import io as tio

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
torch.set_num_threads(2)
CPU = "cpu"


# ----------------------------------------------------------------- geometry
def _scene(rng, n_pts=6000, frames=3, h=60, w=80, focal=70.0):
    """Posed frames over a cloud, with depth rendered from the points (so
    most points sit near the visibility threshold's decision) plus noise and
    invalid pixels."""
    intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1.0]])
    pts = rng.uniform([-1.5, -1.2, 1.5], [1.5, 1.2, 4.0], (n_pts, 3))
    pcd_h = jgeo.homogenize(pts)
    projs, depths = [], []
    for k in range(frames):
        th = 0.15 * (k - frames / 2)
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
        pose[:3, 3] = [0.3 * np.sin(th), 0.05 * k, -0.1]
        proj = jgeo.fuse_projection(intr, pose).astype(np.float32)
        cam = proj.astype(np.float64) @ pcd_h.astype(np.float64)
        uv = np.round(cam[:2] / cam[2]).astype(np.int64)
        ok = (uv[0] >= 0) & (uv[0] < w) & (uv[1] >= 0) & (uv[1] < h)
        depth = np.full(h * w, np.inf)
        np.minimum.at(depth, uv[1, ok] * w + uv[0, ok], cam[2, ok])
        depth[np.isinf(depth)] = 0.0
        depth = (depth + rng.normal(0, 0.04, depth.shape) * (depth > 0)).reshape(h, w)
        depth[rng.random((h, w)) < 0.05] = 0.0
        projs.append(proj)
        depths.append(depth.astype(np.float32))
    return pcd_h, np.stack(projs), np.stack(depths)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_lift_equal(jout, tout):
    for a, b, name in zip(jout, tout, ("membership", "masked_counts", "viewed_counts")):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_project_and_test_pixel_ids_match_jax(rng):
    """Pixel ids and visibility of 200k points in three 968x1296 ScanNet-like
    frames, point for point: through a 32-mask packed lift whose random
    bitmaps make membership depend on the exact pixel id."""
    pcd_h, projs, depth = _scene(rng, n_pts=200_000, frames=3, h=968, w=1296, focal=1170.0)
    packed = rng.integers(0, 2 ** 32, (3, 968 * 1296), dtype=np.uint64).astype(np.uint32)
    jout = jgeo.lift_frames_packed(jnp.asarray(pcd_h), jnp.asarray(projs), jnp.asarray(depth),
                                   jnp.asarray(packed), 0.08, n_masks=32)
    tout = tgeo.lift_frames_packed(_t(pcd_h), _t(projs), _t(depth),
                                   _t(packed.astype(np.int64)), 0.08, n_masks=32)
    _assert_lift_equal(jout, tout)
    assert int(np.asarray(jout[2]).sum()) > 200_000  # most points are visible


@pytest.mark.parametrize("n_masks", [1, 5, 32])
def test_lift_packed_matches_jax(rng, n_masks):
    pcd_h, projs, depths = _scene(rng)
    f, h, w = depths.shape
    masks = rng.random((f, n_masks, h * w)) < 0.4
    packed = np.stack([jgeo.pack_masks(m) for m in masks])
    np.testing.assert_array_equal(packed, np.stack([tgeo.pack_masks(m) for m in masks]))
    jout = jgeo.lift_frames_packed(jnp.asarray(pcd_h), jnp.asarray(projs), jnp.asarray(depths),
                                   jnp.asarray(packed), 0.08, n_masks=n_masks)
    tout = tgeo.lift_frames_packed(_t(pcd_h), _t(projs), _t(depths),
                                   _t(packed.astype(np.int64)), 0.08, n_masks=n_masks)
    _assert_lift_equal(jout, tout)
    assert np.asarray(jout[1]).sum() > 0


def _rle_tables(rng, f, m, hw, pad_masks=0):
    """Run bounds of random masks, padded like projection pads them: pad runs
    start at HW+1 and end at 0; ``pad_masks`` all-pad masks at the end."""
    dense = rng.random((f, m, hw)) < 0.3
    dense[:, :, 1::3] |= rng.random((f, m, 1)) < 0.5  # long runs in some masks
    dense[:, 0] = False  # one empty mask per frame
    runs = [[jrle.rle_bounds(jrle.rle_encode(dense[i, j])) for j in range(m)] for i in range(f)]
    r = max(len(s) for row in runs for s, _ in row) + 3
    st = np.full((f, m + pad_masks, r), hw + 1, np.int32)
    en = np.zeros((f, m + pad_masks, r), np.int32)
    for i in range(f):
        for j in range(m):
            s, e = runs[i][j]
            st[i, j, :len(s)] = s
            en[i, j, :len(e)] = e
    return dense, st, en


@pytest.mark.parametrize("m", [7, 40])
def test_lift_rle_matches_jax_and_dense(rng, m):
    """Both branches of the RLE lift: <=32 masks through the packed bitmap,
    more through searchsorted; each equal to JAX and to the dense lift."""
    pcd_h, projs, depths = _scene(rng)
    f, h, w = depths.shape
    dense, st, en = _rle_tables(rng, f, m, h * w, pad_masks=1)
    jout = jgeo.lift_frames_rle(jnp.asarray(pcd_h), jnp.asarray(projs), jnp.asarray(depths),
                                jnp.asarray(st), jnp.asarray(en), 0.08)
    tout = tgeo.lift_frames_rle(_t(pcd_h), _t(projs), _t(depths), _t(st), _t(en), 0.08)
    _assert_lift_equal(jout, tout)
    valid = np.ones((f, m + 1), bool)
    valid[:, -1] = False
    full = np.concatenate([dense, np.zeros((f, 1, h * w), bool)], 1)
    tdense = tgeo.lift_frames(_t(pcd_h), _t(projs), _t(depths), _t(full), _t(valid), 0.08)
    _assert_lift_equal(tout, tdense)


def test_lift_dense_and_view_counts_match_jax(rng):
    pcd_h, projs, depths = _scene(rng)
    f, h, w = depths.shape
    masks = rng.random((f, 4, h * w)) < 0.5
    valid = np.ones((f, 4), bool)
    valid[1, 3] = False
    jout = jgeo.lift_frames(jnp.asarray(pcd_h), jnp.asarray(projs), jnp.asarray(depths),
                            jnp.asarray(masks), jnp.asarray(valid), 0.08)
    tout = tgeo.lift_frames(_t(pcd_h), _t(projs), _t(depths), _t(masks), _t(valid), 0.08)
    _assert_lift_equal(jout, tout)
    np.testing.assert_array_equal(
        np.asarray(jgeo.view_counts(jnp.asarray(pcd_h), jnp.asarray(projs), jnp.asarray(depths))),
        tgeo.view_counts(_t(pcd_h), _t(projs), _t(depths)).numpy())
    # the float64 oracle is a verbatim copy
    intr = np.array([[70.0, 0, w / 2], [0, 70.0, h / 2], [0, 0, 1.0]])
    pose = np.eye(4)
    pose[:3, 3] = [0.1, 0.0, -0.2]
    m3 = masks[0, :3].reshape(3, h, w)
    for a, b in zip(jgeo.lift_frame_np(pcd_h, intr, pose, depths[0], m3),
                    tgeo.lift_frame_np(pcd_h, intr, pose, depths[0], m3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape_in,shape_out,max_share", [
    ((480, 640), (968, 1296), 3e-4),  # ScanNet depth -> color resolution
    ((240, 320), (968, 1296), 0.0),
    ((30, 40), (30, 40), 0.0),        # no resize
    ((37, 53), (24, 90), 1.0),        # down in one axis, up in the other
])
def test_prepare_depth_matches_jax(rng, shape_in, shape_out, max_share):
    """Raw uint16 depth -> metric float32 at the color resolution.

    The port sums each output's two taps per axis in one fixed order (width
    with fused multiply-adds, then height), the order XLA:CPU takes inside a
    GEMM block for ScanNet's shapes. XLA:CPU's own rounding changes with the
    shape (where its GEMM splits the contraction, and whether it fuses), so
    a share of values differs by a few float32 ulps: at 480x640 -> 968x1296,
    the columns whose taps straddle its block boundary. The largest
    difference anywhere is 2e-5 m, against the 0.08 m visibility tolerance."""
    raw = rng.integers(0, 65536, (2, *shape_in), dtype=np.int64).astype(np.uint16)
    raw[:, ::7, ::5] = 0
    raw[0, :3] = 65535
    want = np.asarray(jgeo.prepare_depth(jnp.asarray(raw), shape_out, 1000.0))
    got = tgeo.prepare_depth(_t(raw.view(np.int16)), shape_out, 1000.0).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5
    assert np.mean(got != want) <= max_share


def test_lift_after_scannet_depth_resize_matches_jax(rng):
    """What the resize's few-ulp differences do to membership: 200k points
    on a tilted wall, seen by three frames whose 480x640 uint16 depth of the
    same wall (noise 4 cm, so many points sit near the 8 cm visibility
    threshold) goes through each package's prepare_depth to 968x1296, then
    through a 32-mask packed lift. Membership and counts must be equal."""
    h, w, hd, wd = 968, 1296, 480, 640
    kc = np.array([[1170.0, 0, 648.0], [0, 1170.0, 484.0], [0, 0, 1.0]])
    kd = kc * np.array([[wd / w], [hd / h], [1.0]])
    kd[:2, 2] = (kc[:2, 2] + 0.5) * [wd / w, hd / h] - 0.5
    normal, offset = np.array([-0.3, -0.2, 1.0]), 2.5  # the wall: normal . x = offset
    xy = rng.uniform([-1.6, -1.2], [1.6, 1.2], (200_000, 2))
    pts = np.column_stack([xy, offset - normal[:2] @ xy.T])
    pcd_h = jgeo.homogenize(pts)
    v, u = np.mgrid[:hd, :wd].astype(np.float64)
    ray = np.stack([(u - kd[0, 2]) / kd[0, 0], (v - kd[1, 2]) / kd[1, 1], np.ones_like(u)], -1)
    projs, raw = [], []
    for k in range(3):
        th = 0.05 * (k - 1)
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]]
        pose[:3, 3] = [0.2 * k, 0.0, -0.3]
        projs.append(jgeo.fuse_projection(kc, pose).astype(np.float32))
        depth = (offset - normal @ pose[:3, 3]) / (ray @ pose[:3, :3].T @ normal)
        depth = depth + rng.normal(0, 0.04, depth.shape)
        raw.append(np.round(depth * 1000).clip(0, 65535).astype(np.uint16))
    projs, raw = np.stack(projs), np.stack(raw)
    jdepth = jgeo.prepare_depth(jnp.asarray(raw), (h, w), 1000.0)
    tdepth = tgeo.prepare_depth(_t(raw.view(np.int16)), (h, w), 1000.0)
    assert np.any(np.asarray(jdepth) != tdepth.numpy())  # the deviation is present
    packed = rng.integers(0, 2 ** 32, (3, h * w), dtype=np.uint64).astype(np.uint32)
    jout = jgeo.lift_frames_packed(jnp.asarray(pcd_h), jnp.asarray(projs), jdepth,
                                   jnp.asarray(packed), 0.08, n_masks=32)
    tout = tgeo.lift_frames_packed(_t(pcd_h), _t(projs), tdepth,
                                   _t(packed.astype(np.int64)), 0.08, n_masks=32)
    _assert_lift_equal(jout, tout)
    viewed = int(np.asarray(jout[2]).sum())
    assert 200_000 < viewed < 3 * 200_000  # most points seen, not all through the noise


# ----------------------------------------------------------- rle and masks
def test_rle_bounds_and_decode_frame_masks_match_jax(rng):
    masks = rng.random((3, 12 * 16)) < 0.3
    for m in masks:
        r = jrle.rle_encode(m)
        for a, b in zip(jrle.rle_bounds(r), trle.rle_bounds(r)):
            np.testing.assert_array_equal(a, b)
    recs = [{"frame_id": "0.jpg", "segmented_frame_masks": jrle.rle_encode_batch(masks)},
            {"frame_id": "1.jpg", "segmented_frame_masks": masks.reshape(3, 1, 12, 16)}]
    want = jrle.decode_frame_masks([dict(r) for r in recs], (12, 16))
    got = trle.decode_frame_masks([dict(r) for r in recs], (12, 16))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a["segmented_frame_masks"], b["segmented_frame_masks"])


def test_connected_components_and_group_reduce_match_jax(rng):
    n = 70
    adj = rng.random((n, n)) < 0.02
    adj = adj | adj.T
    want = np.asarray(jmasks.connected_components(jnp.asarray(adj)))
    np.testing.assert_array_equal(tmasks.connected_components(_t(adj)).numpy(), want)
    np.testing.assert_array_equal(tmasks.connected_components_np(adj),
                                  jmasks.connected_components_np(adj))
    masks = rng.random((n, 300)) < 0.2
    confs = rng.random(n).astype(np.float32)
    onehot = np.zeros((5, n), bool)
    for c in range(5):
        onehot[c, rng.choice(n, 4 + c, replace=False)] = True
    jm, jc = jmasks.group_or_and_mean(jnp.asarray(masks), jnp.asarray(confs), jnp.asarray(onehot))
    tm, tc = tmasks.group_or_and_mean(_t(masks), confs, onehot)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=0, atol=1e-6)


def test_mask_iou_matches_jax_both_routes(rng):
    a = rng.random((30, 700)) < 0.3
    b = rng.random((9, 700)) < 0.5
    a[3] = False
    for bb in (None, b):
        got = tmasks.mask_iou(a, bb, device=CPU)
        for use_device in (False, True):
            want = jmasks.mask_iou(a, bb, use_device=use_device)
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tmasks.pairwise_iou_np(a, b), jmasks.pairwise_iou_np(a, b))
    assert tmasks.mask_iou(np.zeros((0, 5), bool), device=CPU).shape == (0, 0)
    assert tmasks.mask_iou(a, np.zeros((0, 700), bool), device=CPU).shape == (30, 0)


def test_prefetch_map_keeps_order_and_raises():
    from beyondff_tpu_torch.utils.prefetch import prefetch_map

    assert list(prefetch_map(lambda x: x * x, range(50), depth=3)) == [x * x for x in range(50)]

    def bad(x):
        if x == 7:
            raise KeyError(x)
        return x

    with pytest.raises(KeyError):
        list(prefetch_map(bad, range(20)))


# -------------------------------------------------------------- aggregation
def _votes(rng, n_ins=60, n=2500, n_obj=6):
    objs = rng.random((n_obj, n)) < 0.15
    which = rng.integers(0, n_obj, n_ins)
    mem = objs[which] ^ (rng.random((n_ins, n)) < 0.01)
    mem[::11] = False  # empty rows: nan IoU, never adjacent
    labels = [["clothes", "towel"][int(w % 2)] for w in which]
    confs = rng.uniform(0.3, 1.0, n_ins).astype(np.float32)
    return mem, confs, labels


def _assert_agg_equal(a, b):
    assert a.groups == b.groups and a.labels == b.labels
    np.testing.assert_array_equal(a.ins, b.ins)
    np.testing.assert_allclose(a.conf, b.conf, rtol=0, atol=1e-6)
    assert b.conf.dtype == np.float32


@pytest.mark.parametrize("n_ins", [60, 300])  # a small and a large vote graph
def test_aggregate_matches_jax(rng, n_ins):
    mem, confs, labels = _votes(rng, n_ins=n_ins)
    got = tagg.aggregate(mem, confs, labels, 0.2, 2, device=CPU)
    assert len(got.groups) >= 2
    for use_device in (False, True):
        _assert_agg_equal(jagg.aggregate(mem, confs, labels, 0.2, 2, use_device=use_device), got)


def test_aggregate_chunks_matches_jax(rng):
    """Per-frame rows in (F, m, N) chunks: the JAX chunks padded to its
    buckets (masks and points), the port's chunks as they are."""
    mem, confs, labels = _votes(rng, n_ins=37)
    sizes_all = [5, 3, 0, 8, 6, 4, 7, 4]
    assert sum(sizes_all) == 37
    jchunks, tchunks, row = [], [], 0
    for sizes in (sizes_all[:3], sizes_all[3:]):
        m = max(sizes)
        jarr = np.zeros((8, 8, mem.shape[1] + 500), bool)
        tarr = np.zeros((len(sizes), m, mem.shape[1]), bool)
        for i, k in enumerate(sizes):
            jarr[i, :k, :mem.shape[1]] = mem[row:row + k]
            tarr[i, :k] = mem[row:row + k]
            row += k
        jchunks.append((jnp.asarray(jarr), sizes))
        tchunks.append((_t(tarr), sizes))
    want = jagg.aggregate_chunks(jchunks, mem.shape[1], confs, labels, 0.2, 2)
    got = tagg.aggregate_chunks(tchunks, mem.shape[1], confs, labels, 0.2, 2)
    _assert_agg_equal(want, got)
    assert tagg.aggregate_chunks([], 10, np.zeros(0), [], 0.2, 2).empty


@pytest.mark.parametrize("mode", ["ratio", "occurrence", "none"])
def test_filter_masks_matches_jax(rng, mode):
    mem, confs, labels = _votes(rng)
    agg_j = jagg.aggregate(mem, confs, labels, 0.2, 2, use_device=False)
    agg_t = tagg.aggregate(mem, confs, labels, 0.2, 2, device=CPU)
    masked = rng.integers(0, 6, mem.shape[1])
    viewed = masked + rng.integers(0, 9, mem.shape[1])
    kw = {"ratio": {}, "occurrence": {"use_occurrence_threshold": True},
          "none": {"use_detected_ratio_threshold": False}}[mode]
    want = jfilt.filter_masks(agg_j, masked, viewed, JFilteringConfig(**kw))
    got = tfilt.filter_masks(agg_t, masked, viewed, TFilteringConfig(**kw))
    np.testing.assert_array_equal(got.ins, want.ins)
    np.testing.assert_allclose(got.conf, want.conf, rtol=0, atol=1e-6)
    assert got.labels == want.labels
    assert jfilt.detected_ratio_filter(masked, viewed, 0.3)[1] == \
        tfilt.detected_ratio_filter(masked, viewed, 0.3)[1]


# --------------------------------------------------------------- refinement
def test_match_and_fuse_scene_match_jax(rng):
    """Random trials with engineered overlaps (as tests/test_refine.py)."""
    for trial in range(15):
        n1, n2, npts = int(rng.integers(2, 9)), int(rng.integers(1, 7)), 150
        base = rng.random((4, npts)) < 0.35
        s1 = np.stack([base[rng.integers(0, 4)] | (rng.random(npts) < 0.1) for _ in range(n1)])
        s2 = np.stack([base[rng.integers(0, 4)] & (rng.random(npts) < 0.9) for _ in range(n2)])
        s2[:, :5] = True
        conf = rng.random(n2).astype(np.float32)
        labels = [["clothes", "chair"][int(rng.integers(0, 2))] for _ in range(n1)]
        want = jref.match_scene(s1, labels, s2, conf, "clothes", 0.1)
        got = tref.match_scene(s1, labels, s2, conf, "clothes", 0.1, device=CPU)
        for name in ("ious", "matched_stage1", "stage2", "stage2_conf", "other_stage1"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                          err_msg=f"trial {trial}: {name}")
        assert got.matched_labels == want.matched_labels
        sims = rng.random(len(want.ious)).tolist()
        want.similarities, got.similarities = sims, list(sims)
        thres = jref.select_sim_threshold([sims], 0.5)
        assert tref.select_sim_threshold([sims], 0.5) == thres
        for a, b in zip(jref.fuse_scene(want, "clothes", thres, 0.45),
                        tref.fuse_scene(got, "clothes", thres, 0.45)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_clip_text_similarity_matches_jax():
    jm = jclip.CLIP.create("test", seed=4)
    module = tlayers.build(lambda: tclip.CLIPModule(tclip.PRESETS["test"]),
                           torch.device(CPU), seed=3)
    module.load_state_dict(convert.clip_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params), module.cfg))
    tm = tclip.CLIP(jm.cfg, module)
    v, c = jm.cfg.vocab_size, jm.cfg.context_length
    jsim = jtext_sim.ClipTextSimilarity(jm, JHashTokenizer(v, c))
    tsim = ttext_sim.ClipTextSimilarity(tm, THashTokenizer(v, c))
    for a, b in [("clothes", "clothes"), ("clothes", "towel"), ("office chair", "chair"),
                 ("kitchen cabinet", "trash can")]:
        assert abs(tsim(a, b) - jsim(a, b)) <= 1e-5
    assert tsim("clothes", "clothes") == pytest.approx(1.0, abs=1e-6)


def test_build_text_similarity(tmp_path):
    cfg = TConfig.from_dict({})
    assert isinstance(ttext_sim.build_text_similarity(cfg), ttext_sim.ExactMatchSimilarity)
    assert ttext_sim.ExactMatchSimilarity()("Office_Chair", "office chair") == 1.0
    missing = str(tmp_path / "ViT-L-14.pt")
    with pytest.raises(FileNotFoundError, match="ViT-L-14.pt"):
        ttext_sim.build_text_similarity(cfg.override(**{"detector.clip_checkpoint": missing}),
                                        device=CPU)


# --------------------------------------------------------------- evaluation
def test_scannet_eval_matches_jax(rng):
    labels = ["chair", "table", "clothes", "towel", "lamp"]
    preds, sems, insts = [], [], []
    for s in range(3):
        n = 2000
        sems.append(rng.integers(0, 7, n).astype(np.int32))
        insts.append(rng.integers(-2, 6, n).astype(np.int32))
        preds.append([{"scan_id": f"scene{s}", "label_id": int(rng.integers(1, 6)),
                       "conf": float(np.round(rng.random(), 3)),
                       "pred_mask": (rng.random(n) < rng.uniform(0.05, 0.3)).astype(np.uint8)}
                      for _ in range(int(rng.integers(2, 7)))])
    want = JScanNetEval(labels).evaluate(preds, sems, insts, verbose=False)
    got = TScanNetEval(labels).evaluate(preds, sems, insts, verbose=False)
    np.testing.assert_equal(got, want)


# ------------------------------------------------------- the slice as a whole
def _outputs(cfg, d, cls):
    return tio.load_stage_dict(os.path.join(d, cls, "scene0000_00.pth"))


def test_slice_projection_refinement_evaluation_match_jax(tmp_path):
    """JAX and the port run projection -> refinement -> evaluation on the same
    synthetic scene into separate directories: equal stage dicts, AP and
    results-table row."""
    import make_synthetic_scene

    cfg_path = make_synthetic_scene.generate(str(tmp_path / "scene"), query="clothes",
                                             scenes=1, seed=7)
    cfgs = {}
    for side, Config in (("jax", JConfig), ("torch", TConfig)):
        out = tmp_path / side
        cfgs[side] = Config.from_yaml(cfg_path).override(**{
            "paths.mask_3d_dir": str(out / "mask_3d"),
            "paths.final_output_dir": str(out / "final"),
            "paths.checkpoint_dir": str(out / "ckpt"),
            "paths.results_dir": str(out / "results")})
    jc, tc = cfgs["jax"], cfgs["torch"]
    assert jprojection.run(jc, "clothes", resume=False) == \
        tprojection.run(tc, "clothes", resume=False, device=CPU)
    assert jrefinement.run(jc, "clothes") == trefinement.run(tc, "clothes", device=CPU)
    for stage in ("mask_3d_dir", "final_output_dir"):
        want = jio.load_stage_dict(os.path.join(getattr(jc.paths, stage), "clothes",
                                                "scene0000_00.pth"))
        got = torch.load(os.path.join(getattr(tc.paths, stage), "clothes", "scene0000_00.pth"),
                         weights_only=False)
        assert got["ins"].dtype == torch.bool and got["conf"].dtype == torch.float32
        np.testing.assert_array_equal(got["ins"].numpy(), want["ins"], err_msg=stage)
        np.testing.assert_allclose(got["conf"].numpy(), want["conf"], rtol=0, atol=1e-6)
        assert got["final_class"] == list(want["final_class"])
        assert got["ins"].shape[0] == 2 and got["ins"].sum(1).min() > 100
    want = jevaluate.run(jc, "clothes", verbose=False)
    got = tevaluate.run(tc, "clothes", verbose=False, plot_pr_curves=False)
    np.testing.assert_equal(got, want)
    assert want["classes"]["clothes"]["ap50%"] == pytest.approx(1.0)
    row = {}
    for side, c in cfgs.items():
        with open(os.path.join(c.paths.results_dir, "overall_results.txt")) as f:
            row[side] = [ln for ln in f if ln.startswith("clothes,")]
    assert row["torch"] == row["jax"] and "clothes,-" not in row["jax"][0]


def test_port_entry_points_agree_with_run(tmp_path, monkeypatch):
    """The port's other ways through the stage write what ``run`` writes:
    dense (non-RLE) 2D records, host depth (``device_depth_resize: false``,
    also against JAX), scene-outer ``run_classes`` (the second class reuses
    the first one's visibility totals) and ``refinement.run_multi``."""
    import shutil

    import make_synthetic_scene

    cfg = TConfig.from_yaml(make_synthetic_scene.generate(str(tmp_path), query="clothes",
                                                          seed=11))
    mask_dir = os.path.join(cfg.paths.mask_2d_dir, "clothes")
    shutil.copytree(mask_dir, os.path.join(cfg.paths.mask_2d_dir, "towel"))

    def out(c, stage="mask_3d_dir"):
        return tio.load_stage_dict(os.path.join(getattr(cfg.paths, stage), c,
                                                "scene0000_00.pth"))

    def same(a, b):
        np.testing.assert_array_equal(a["ins"], b["ins"])
        np.testing.assert_array_equal(a["conf"], b["conf"])
        assert list(a["final_class"]) == list(b["final_class"])

    tprojection.run(cfg, "clothes", resume=False, device=CPU)
    ref = out("clothes")
    assert ref["ins"].shape[0] == 2

    host = cfg.override(**{"frames.device_depth_resize": False})
    tprojection.run(host, "clothes", resume=False, device=CPU)
    same(out("clothes"), ref)
    jhost = JConfig.from_yaml(os.path.join(str(tmp_path), "config.yaml")).override(**{
        "frames.device_depth_resize": False, "paths.mask_3d_dir": str(tmp_path / "jax3d")})
    jprojection.run(jhost, "clothes", resume=False)
    same(jio.load_stage_dict(str(tmp_path / "jax3d" / "clothes" / "scene0000_00.pth")), ref)

    rec_path = os.path.join(mask_dir, "scene0000_00.pth")
    records = trle.decode_frame_masks(tio.load_frame_records(rec_path),
                                      (cfg.frames.height_2d, cfg.frames.width_2d))
    for r in records:
        r["segmented_frame_masks"] = torch.from_numpy(r["segmented_frame_masks"].astype(bool))
    torch.save(records, rec_path)
    tprojection.run(cfg, "clothes", resume=False, device=CPU)
    same(out("clothes"), ref)

    calls = []
    orig = tprojection.lift_scene_streamed

    def spy(*args, **kwargs):
        calls.append(kwargs["need_viewed"])
        return orig(*args, **kwargs)

    monkeypatch.setattr(tprojection, "lift_scene_streamed", spy)
    res = tprojection.run_classes(cfg, ["clothes", "towel"], resume=False, device=CPU)
    monkeypatch.undo()
    assert calls == [True, False] and len(res["clothes"]) == len(res["towel"]) == 1
    same(out("clothes"), ref)
    same(out("towel"), ref)

    single = trefinement.run(cfg, "clothes", device=CPU)
    ref_final = out("clothes", "final_output_dir")
    multi = trefinement.run_multi(cfg, ["clothes"], device=CPU)
    same(out("clothes", "final_output_dir"), ref_final)
    assert multi["clothes"][0]["instances"] == single[0]["instances"] == 2
