"""The port's fast variant (YOLO-World + EfficientSAM) against the JAX package.

Both packages run the ``"test"`` presets with the same weights (JAX
variables carried into the port through ``convert.*_from_jax``) on the same
seeded numpy inputs. Tolerances: YOLO-World's pyramid and logits within
1e-4 and its boxes within 1e-4 of the 64-px input (float32 on both sides);
NMS keep lists equal; EfficientSAM's packed masks bit for bit; the 2D stage's
records at the seg2d bars (CLIP confidences within 1e-4, mask IoU >= 0.999),
with the JAX side on the port's transport (``BFF_SEG2D_YUV=0``,
``BFF_CLIP_DEVICE_CROPS=0``, ``BFF_SEG2D_JXT=0``, OpenCV's own cubic resize)
and two-tier uploads left on auto (off at these sizes) or forced on.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.models import clip as jclip
from beyondff_tpu.models import efficientsam as jesam
from beyondff_tpu.models import yolo_world as jyw
from beyondff_tpu.models.tokenizers import HashTokenizer as JHashTokenizer
from beyondff_tpu.orchestration import SweepRunner as JSweepRunner
from beyondff_tpu.pipeline import segmentation_2d as jseg2d
from beyondff_tpu.utils import io as jio
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.core import rle as trle
from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels import nms as tnms
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import efficientsam as tesam
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.models import yolo_world as tyw
from beyondff_tpu_torch.models.tokenizers import HashTokenizer as THashTokenizer
from beyondff_tpu_torch.orchestration import sweep as tsweep
from beyondff_tpu_torch.pipeline import segmentation_2d as tseg2d

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_synthetic_scene  # noqa: E402

ATOL = 1e-4
CLASSES = ["towel", "clothes", "chair"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomized(variables, seed):
    """A JAX YOLO-World's variables with non-degenerate seeded values: conv
    and dense kernels N(0, 1/fan_in), norm scales and variances in
    [0.5, 1.5], means and biases N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name == "kernel":
            return rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, _np(variables))


def _port_yolo(jm, clip=None, tok=None):
    module = tlayers.build(lambda: tyw.YOLOWorldModule(jm.cfg), torch.device("cpu"))
    module.load_state_dict(convert.yolo_world_from_jax(_np(jm.params), jm.cfg))
    return tyw.YOLOWorld(jm.cfg, module, clip, tok)


def _port_esam(jm):
    module = tlayers.build(lambda: tsam.SAMModule(jm.cfg), torch.device("cpu"))
    module.load_state_dict(convert.efficientsam_from_jax(_np(jm.params), jm.cfg))
    return tesam.EfficientSAM(jm.cfg, module)


def _port_clip(jm):
    module = tlayers.build(lambda: tclip.CLIPModule(jm.cfg), torch.device("cpu"))
    module.load_state_dict(convert.clip_from_jax(_np(jm.params), jm.cfg))
    return tclip.CLIP(jm.cfg, module)


@pytest.fixture(scope="module")
def yolo():
    jm = jyw.YOLOWorld.create("test", seed=3)
    jm.params = _randomized(jm.params, 3)
    return jm, _port_yolo(jm)


# ----------------------------------------------------------------- YOLO-World
def test_backbone_and_detect_match_jax(yolo):
    jm, tm = yolo
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    txt = rng.normal(size=(3, 32)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    jfeats = jm.module.apply(jm.params, jnp.asarray(img), method=jyw.YOLOWorldModule.backbone)
    with torch.inference_mode():
        tfeats = tm.module.backbone(torch.from_numpy(img))
    for j, t in zip(jfeats, tfeats):
        np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), np.asarray(j), atol=ATOL,
                                   rtol=0)
    jbox, jlog = jm.module.apply(jm.params, *jfeats, jnp.asarray(txt),
                                 method=jyw.YOLOWorldModule.detect)
    with torch.inference_mode():
        tbox, tlog = tm.module.detect(*tfeats, torch.from_numpy(txt))
    assert tbox.shape == (2, 84, 4) and tlog.shape == (2, 84, 3)
    np.testing.assert_allclose(tbox.numpy() / 64, np.asarray(jbox) / 64, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    assert np.ptp(np.asarray(jlog)) > 0.1  # the comparison is not of constants


def _nms_case(kind, rng, a=300):
    if kind == "overlap":  # clusters of heavily overlapping boxes
        centers = rng.uniform(50, 550, (12, 2))[rng.integers(0, 12, a)]
        centers += rng.normal(0, 6, (a, 2))
        half = rng.uniform(20, 60, (a, 2))
        boxes = np.concatenate([centers - half, centers + half], 1)
        scores = rng.uniform(0, 1, a)
    elif kind == "disjoint":  # a grid of boxes that never touch
        g = np.stack(np.meshgrid(np.arange(20), np.arange(15)), -1).reshape(-1, 2)[:a] * 30.0
        boxes = np.concatenate([g, g + 20.0], 1)
        scores = rng.uniform(0, 1, a)
    else:  # tied scores: few distinct values, ties kept in index order
        centers = rng.uniform(50, 300, (a, 2))
        boxes = np.concatenate([centers - 25, centers + 25], 1)
        scores = rng.integers(0, 4, a) / 4.0
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("top_k", [20, 400])
@pytest.mark.parametrize("kind", ["overlap", "disjoint", "ties"])
def test_nms_plain_matches_jax(kind, top_k):
    """Keep lists equal, index for index and padding included (top_k 400
    exceeds every case's survivors); the CPU path counts no launch."""
    rng = np.random.default_rng({"overlap": 1, "disjoint": 2, "ties": 3}[kind])
    frames = [_nms_case(kind, rng) for _ in range(3)]
    before = dispatch.launch_counts["nms_fixed"]
    keep, valid = tnms.nms_fixed(torch.from_numpy(np.stack([f[0] for f in frames])),
                                 torch.from_numpy(np.stack([f[1] for f in frames])), 0.5, top_k)
    assert dispatch.launch_counts["nms_fixed"] == before
    n_kept = []
    for i, (boxes, scores) in enumerate(frames):
        jk, jv = jyw.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.5, top_k)
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(valid[i].numpy(), np.asarray(jv))
        n_kept.append(int(np.asarray(jv).sum()))
    if kind == "disjoint":
        assert n_kept == [min(top_k, 300)] * 3
    else:
        assert all(0 < n < min(top_k, 300) or n == top_k for n in n_kept)


def test_wrapper_predict_and_finalize_match_jax(yolo):
    """``predict`` (host resize), the frame-batch path with
    ``predict_finalize``, ``caption_spans`` and the argmax demux."""
    jm, tm = yolo
    rng = np.random.default_rng(4)
    image = rng.integers(0, 255, (48, 80, 3), dtype=np.uint8)
    for caption in ("towel", "towel . chair . a red cup"):
        jb, js, jp = jm.predict(image, caption, box_threshold=0.3)
        tb, ts, tp = tm.predict(image, caption, box_threshold=0.3)
        assert tp == jp and len(tp) > 0
        np.testing.assert_allclose(tb, jb, atol=ATOL, rtol=0)
        np.testing.assert_allclose(ts, js, atol=ATOL, rtol=0)
    classes = ["towel", "chair", "a red cup"]
    jcap, jspans = jm.caption_spans(classes)
    tcap, tspans = tm.caption_spans(classes)
    assert (tcap, tspans) == (jcap, jspans)
    frames = rng.integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    jh = jm.predict_batch_frames_async(jnp.asarray(frames), tcap)
    th = tm.predict_batch_frames_async(torch.from_numpy(frames), tcap)
    jp, tp = np.asarray(jh[0]), th[0].numpy()
    assert tp.shape == jp.shape == (2, jm.cfg.max_dets, 6)
    np.testing.assert_array_equal(tp[..., 0] < 0, jp[..., 0] < 0)
    np.testing.assert_allclose(tp[..., 0], jp[..., 0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tp[..., 1:5] / 64, jp[..., 1:5] / 64, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tp[..., 5], jp[..., 5])
    for thr in (0.3, [0.2, 0.5, 0.0]):
        jd = jm.predict_finalize_demux(jh, tspans, box_threshold=thr)
        td = tm.predict_finalize_demux(th, tspans, box_threshold=thr)
        for jf, tf in zip(jd, td):
            for (jbx, jsc, jph), (tbx, tsc, tph) in zip(jf, tf):
                assert tph == jph
                np.testing.assert_allclose(tbx, jbx, atol=ATOL, rtol=0)
                np.testing.assert_allclose(tsc, jsc, atol=ATOL, rtol=0)
    for (jbx, jsc, jph), (tbx, tsc, tph) in zip(jm.predict_finalize(jh, 0.3),
                                                tm.predict_finalize(th, 0.3)):
        assert tph == jph and len(tph) > 0
        np.testing.assert_allclose(tbx, jbx, atol=ATOL, rtol=0)
        np.testing.assert_allclose(tsc, jsc, atol=ATOL, rtol=0)
    with pytest.raises(ValueError):
        tm.predict_finalize_demux(th, tspans, box_threshold=[0.1, 0.2])


def test_class_embeddings_match_jax(yolo):
    """Hash embeddings equal in-process (``hash()`` of the same interpreter);
    CLIP-tower embeddings within 1e-5; a tower of another width raises."""
    jm, tm = yolo
    classes = ["towel", "chair"]
    jm._text_cache.clear()
    tm._text_cache.clear()
    np.testing.assert_array_equal(tm.class_embeddings(classes), jm.class_embeddings(classes))
    jc = jclip.CLIP.create("test", seed=6)
    tc = _port_clip(jc)
    jw = jyw.YOLOWorld(jm.cfg, jm.params, clip_model=jc,
                       clip_tokenizer=JHashTokenizer(jc.cfg.vocab_size, jc.cfg.context_length))
    tw = tyw.YOLOWorld(jm.cfg, tm.module, tc,
                       THashTokenizer(tc.cfg.vocab_size, tc.cfg.context_length))
    np.testing.assert_allclose(tw.class_embeddings(classes), jw.class_embeddings(classes),
                               atol=1e-5, rtol=0)
    wide = tclip.CLIP.create(dataclasses.replace(tclip.PRESETS["test"], embed_dim=48),
                             device="cpu")
    bad = tyw.YOLOWorld(jm.cfg, tm.module, wide,
                        THashTokenizer(wide.cfg.vocab_size, wide.cfg.context_length))
    with pytest.raises(ValueError, match="32-d"):
        bad.class_embeddings(classes)


# ---------------------------------------------------------------- EfficientSAM
def test_efficientsam_encode_and_best_decode_match_jax():
    """Encode within 1e-4, the best-of-multimask decode (argmax over every
    mask the decoder returns) within 1e-4 and ``decode_boxes_packed`` bit
    for bit."""
    jm = jesam.EfficientSAM.create("test", seed=4)
    tm = _port_esam(jm)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    je = np.asarray(jm.encode_frames(jnp.asarray(frames)))
    te = tm.encode_frames(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(te, je, atol=ATOL, rtol=0)
    boxes = np.array([[3, 4, 40, 50], [10, 0, 63, 30], [0, 0, 64, 64], [20, 10, 60, 47]],
                     np.float32)
    jmask, jiou = jm.decode_boxes_best(jnp.asarray(je[1]), boxes)
    tmask, tiou = tm.decode_boxes_best(torch.from_numpy(je[1].copy()), boxes)
    np.testing.assert_allclose(tmask.numpy(), np.asarray(jmask), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou), atol=ATOL, rtol=0)
    _all_masks, all_iou = jm.decode_boxes(jnp.asarray(je[1]), boxes)
    assert np.all(tiou.numpy() >= np.asarray(all_iou) - 1e-6)
    orig_hw = (40, 56)
    input_hw = (46, 64)
    embs = np.asarray(jm.encode_frames(jnp.asarray(frames[:, :46])))
    jpacked, jpiou = jm.decode_boxes_packed(jnp.asarray(embs), np.stack([boxes, boxes[::-1]]),
                                            input_hw, orig_hw)
    tpacked, tpiou = tm.decode_boxes_packed(torch.from_numpy(embs.copy()), [0] * 4 + [1] * 4,
                                            np.concatenate([boxes, boxes[::-1]]), input_hw,
                                            orig_hw)
    n = orig_hw[0] * orig_hw[1]
    jbits = np.unpackbits(np.asarray(jpacked).reshape(8, -1), axis=-1, bitorder="little")
    tbits = np.unpackbits(tpacked.numpy(), axis=-1, bitorder="little")
    assert 0 < jbits[:, :n].sum() < jbits[:, :n].size
    np.testing.assert_array_equal(tbits, jbits)
    np.testing.assert_allclose(tpiou.numpy(), np.asarray(jpiou).reshape(-1), atol=ATOL, rtol=0)


# ------------------------------------------------------------------ the stage
@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic scene (6 frames at 242 x 324; two through the stage)
    with ``detector.kind: yolo_world``, and a JAX segmentor (its YOLO-World
    weights randomized) with the port's copy of its models."""
    root = str(tmp_path_factory.mktemp("fast") / "root")
    cfg_path = make_synthetic_scene.generate(root, query="towel", seed=2)
    raw = yaml.safe_load(open(cfg_path))
    raw["frames"]["downsample_ratio"] = 3
    raw["detector"].update({"kind": "yolo_world", "box_threshold": 0.0,
                            "must_match_query": False, "similarity_threshold": -10.0,
                            "max_detections": 4, "dtype": "float32", "frame_batch": 2,
                            "fused_group": 8})
    jseg = jseg2d.Segmentor2D(JConfig.from_dict(raw))
    jseg.detector.params = _randomized(jseg.detector.params, 9)
    assert jseg.detector.clip is jseg.clip  # 32-d "test" CLIP: attached
    tclip_m = _port_clip(jseg.clip)
    tseg = tseg2d.Segmentor2D(TConfig.from_dict(raw), detector=_port_yolo(jseg.detector),
                              sam=_port_esam(jseg.sam), clip_model=tclip_m, device="cpu")
    assert tseg.detector.clip is tseg.clip
    return {"root": root, "raw": raw, "jseg": jseg, "tseg": tseg}


@pytest.fixture
def jax_transport(monkeypatch):
    monkeypatch.setenv("BFF_SEG2D_YUV", "0")
    monkeypatch.setenv("BFF_CLIP_DEVICE_CROPS", "0")
    monkeypatch.setenv("BFF_SEG2D_JXT", "0")
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


def _configs(scene, tag, **detector):
    raw = {**scene["raw"], "detector": {**scene["raw"]["detector"], **detector}}
    out = {}
    for side, cls in (("jax", JConfig), ("torch", TConfig)):
        r = {**raw, "paths": {**raw["paths"],
                              "mask_2d_dir": os.path.join(scene["root"], f"m2d_{tag}_{side}"),
                              "checkpoint_dir": os.path.join(scene["root"], f"ck_{tag}_{side}")}}
        out[side] = cls.from_dict(r)
    return out["jax"], out["torch"]


def _records(cfg, cls):
    return jio.load_frame_records(os.path.join(cfg.paths.mask_2d_dir, cls, "scene0000_00.pth"))


def _iou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


def _assert_records_close(got, want, conf_atol=1e-4, iou_min=0.999):
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want]
    n = 0
    for t, j in zip(got, want):
        assert list(t["labels"]) == list(j["labels"])
        np.testing.assert_allclose(t["confidences"], j["confidences"], atol=conf_atol, rtol=0)
        for a, b in zip(trle.rle_decode_batch(t["segmented_frame_masks"]).astype(bool),
                        trle.rle_decode_batch(j["segmented_frame_masks"]).astype(bool)):
            assert _iou(a, b) >= iou_min
            n += 1
    return n


def _with_cfg(seg, cfg, fn):
    old = seg.cfg
    seg.cfg = cfg
    try:
        return fn()
    finally:
        seg.cfg = old


@pytest.mark.parametrize("mode", ["auto", "two_tier", "host"])
def test_run_matches_jax(scene, jax_transport, monkeypatch, mode):
    """``run()``: device frames with two-tier uploads on auto (off here: the
    64x64 detector input is larger than the 48x64 SAM-scaled frame) and
    forced on (the full-width default), and the host path."""
    detector = {"device_frames": mode != "host"}
    if mode == "two_tier":
        monkeypatch.setenv("BFF_SEG2D_TWO_TIER", "1")
    jcfg, tcfg = _configs(scene, f"run_{mode}", **detector)
    assert scene["tseg"]._two_tier((242, 324)) == (mode == "two_tier")
    jres = _with_cfg(scene["jseg"], jcfg, lambda: jseg2d.run(
        jcfg, "towel", segmentor=scene["jseg"]))
    tres = _with_cfg(scene["tseg"], tcfg, lambda: tseg2d.run(
        tcfg, "towel", segmentor=scene["tseg"]))
    assert tres == jres and tres[0]["frames_with_boxes"] == 2
    assert _assert_records_close(_records(tcfg, "towel"), _records(jcfg, "towel")) > 0


def test_run_classes_banked_matches_jax_and_run(scene, jax_transport):
    """Per-class ``run_classes`` (frame, pyramid and embedding banks, one
    class with its own threshold) against the JAX package's and the port's
    ``run()``; the second and third classes rerun no backbone."""
    jcfg, tcfg = _configs(scene, "percls", fused_captions=False)
    thr = {"clothes": 0.3}
    seg = scene["tseg"]
    backbones = []
    real = seg.detector.module.backbone
    seg.detector.module.backbone = lambda x: backbones.append(x.shape[0]) or real(x)
    try:
        tres = _with_cfg(seg, tcfg, lambda: tseg2d.run_classes(
            tcfg, CLASSES, segmentor=seg, class_thresholds=thr))
    finally:
        del seg.detector.module.backbone
    assert backbones == [2]
    jres = _with_cfg(scene["jseg"], jcfg, lambda: jseg2d.run_classes(
        jcfg, CLASSES, segmentor=scene["jseg"], class_thresholds=thr))
    assert tres == jres and all(tres[c] for c in CLASSES)
    assert sum(_assert_records_close(_records(tcfg, c), _records(jcfg, c)) for c in CLASSES)
    _j, rcfg = _configs(scene, "run1")
    for c in CLASSES:
        ccfg = rcfg.override(**{"detector.box_threshold": thr.get(c, 0.0)})
        _with_cfg(seg, ccfg, lambda: tseg2d.run(ccfg, c, segmentor=seg))
        _assert_records_close(_records(rcfg, c), _records(tcfg, c), conf_atol=1e-6, iou_min=1.0)


def test_run_classes_fused_matches_jax(scene, jax_transport):
    """Fused captions: one detection pass over the class set split by argmax
    class, then one combined replay; against the JAX package's fused path."""
    jcfg, tcfg = _configs(scene, "fused", fused_captions=True)
    calls = []
    det = scene["tseg"].detector
    real = det.predict_finalize_demux
    det.predict_finalize_demux = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        tres = _with_cfg(scene["tseg"], tcfg, lambda: tseg2d.run_classes(
            tcfg, CLASSES, segmentor=scene["tseg"]))
    finally:
        del det.predict_finalize_demux
    jres = _with_cfg(scene["jseg"], jcfg, lambda: jseg2d.run_classes(
        jcfg, CLASSES, segmentor=scene["jseg"]))
    assert calls and tres == jres
    assert sum(_assert_records_close(_records(tcfg, c), _records(jcfg, c)) for c in CLASSES)


def test_sweep_runner_matches_jax(scene, jax_transport, tmp_path):
    """``SweepRunner`` over two classes with the amortized 2D stage: the
    results table byte-identical and the sweep checkpoints equal."""
    out = {}
    for side in ("jax", "torch"):
        raw = {**scene["raw"], "paths": {
            **scene["raw"]["paths"],
            **{k: str(tmp_path / side / k) for k in ("mask_2d_dir", "mask_3d_dir",
                                                      "final_output_dir", "checkpoint_dir",
                                                      "results_dir")}}}
        ckpt = str(tmp_path / f"proc_{side}.txt")
        seg = scene["jseg" if side == "jax" else "tseg"]
        if side == "jax":
            runner = JSweepRunner(JConfig.from_dict(raw), checkpoint_path=ckpt)
            runner._segmentor = seg
        else:
            runner = tsweep.SweepRunner(TConfig.from_dict(raw), checkpoint_path=ckpt,
                                        device="cpu", segmentor=seg, plot_pr_curves=False)
        status = _with_cfg(seg, seg.cfg.__class__.from_dict(raw),
                           lambda: runner.run(CLASSES[:2], amortize_segmentation=True))
        assert all(all(s.values()) for s in status.values()), status
        out[side] = (open(os.path.join(raw["paths"]["results_dir"],
                                       "overall_results.txt")).read(),
                     yaml.safe_load(open(ckpt)))
    assert out["torch"] == out["jax"]


# --------------------------------------------------------------- checkpoints
def _small_presets(monkeypatch):
    """The full-width presets the stage loads (YOLO-World-L, EfficientSAM-S)
    replaced by the "test" ones in both packages."""
    for yw in (jyw, tyw):
        monkeypatch.setitem(yw.PRESETS, "l", yw.PRESETS["test"])
    for es in (jesam, tesam):
        monkeypatch.setitem(es.PRESETS, "vits", es.PRESETS["test"])


def _write_official(tmp_path, rng):
    """Seeded test-preset modules in the released layouts: YOLO-World as a
    full YOLO wrapper's ``{"model": {"model.model.N...": f32}}`` with the
    batch-norm counters and the DFL arange conv; EfficientSAM as
    ``{"model": ...}`` with a class-token slot in its position embedding and
    the mask-prompt stack. Returns the paths and the state dicts."""
    ycfg, scfg = tyw.PRESETS["test"], tesam.PRESETS["test"]
    ysd = {k: torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
           if k.endswith("running_var") else
           torch.from_numpy(rng.normal(0, 0.2, v.shape).astype(np.float32))
           for k, v in tyw.YOLOWorld.create(ycfg, device="cpu").module.state_dict().items()}
    extra = {"model.22.dfl.conv.weight": torch.arange(ycfg.reg_max, dtype=torch.float32)
             .reshape(1, ycfg.reg_max, 1, 1),
             "model.0.bn.num_batches_tracked": torch.tensor(7)}
    ypath = str(tmp_path / "yolov8l-worldv2.pt")
    torch.save({"model": {"model." + k: v for k, v in {**ysd, **extra}.items()}}, ypath)
    ssd = {k: torch.from_numpy(rng.normal(0, 0.2, v.shape).astype(np.float32))
           for k, v in tesam.EfficientSAM.create(scfg, device="cpu").module.state_dict().items()}
    g = scfg.img_size // scfg.patch_size
    pos = ssd["image_encoder.pos_embed"].reshape(1, g * g, -1)
    written = dict(ssd, **{"image_encoder.pos_embed": torch.cat([pos[:, :1] * 0 + 3, pos], 1),
                           "prompt_encoder.mask_downscaling.0.weight": torch.ones(4, 1, 2, 2)})
    spath = str(tmp_path / "efficient_sam_vits.pt")
    torch.save({"model": written}, spath)
    return ypath, spath, ysd, ssd


def test_stage_loads_official_layout_files_and_matches_jax(tmp_path, monkeypatch,
                                                           jax_transport):
    """``Segmentor2D(cfg)`` builds YOLO-World (float32 whatever
    ``detector.dtype``) and EfficientSAM from the configured files: every
    tensor as written, equal to the JAX converters' output carried back;
    then both packages' stages, CLIP injected alike, write the same records."""
    _small_presets(monkeypatch)
    ypath, spath, ysd, ssd = _write_official(tmp_path, np.random.default_rng(12))
    ycfg, scfg = tyw.PRESETS["test"], tesam.PRESETS["test"]
    jy = convert.yolo_world_from_jax(_np(jyw.convert_torch_checkpoint(ypath, ycfg)), ycfg)
    js = convert.efficientsam_from_jax(_np(jesam.convert_torch_checkpoint(spath, scfg)), scfg)
    h, w = 48, 64
    rng = np.random.default_rng(6)
    color = tmp_path / "scene0000_00" / "color"
    color.mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(color / f"{i}.jpg"), rng.integers(0, 255, (h, w, 3), dtype=np.uint8))

    def cfg_dict(tag, dtype="float32"):
        return {"paths": {"scene_2d_dir": str(tmp_path),
                          "mask_2d_dir": str(tmp_path / f"out_{tag}"),
                          "checkpoint_dir": str(tmp_path / f"ckpt_{tag}")},
                "frames": {"width_2d": w, "height_2d": h, "downsample_ratio": 1},
                "detector": {"kind": "yolo_world", "box_threshold": 0.0,
                             "must_match_query": False, "similarity_threshold": -10.0,
                             "dtype": dtype, "frame_batch": 2, "max_detections": 4,
                             "yolo_world_checkpoint": ypath, "efficientsam_checkpoint": spath}}

    jc = jclip.CLIP.create("test", seed=2)
    tseg = tseg2d.Segmentor2D(TConfig.from_dict(cfg_dict("torch")), clip_model=_port_clip(jc),
                              device="cpu")
    assert sorted(tseg.load_seconds) == ["efficientsam", "yolo_world"]
    for module, written, via_jax in ((tseg.detector.module, ysd, jy),
                                     (tseg.sam.module, ssd, js)):
        state = module.state_dict()
        assert set(state) == set(written) == set(via_jax)
        for k, v in state.items():
            assert torch.equal(v, written[k]) and torch.equal(v, via_jax[k]), k
    bf = tseg2d.Segmentor2D(TConfig.from_dict(cfg_dict("bf", "bfloat16")), device="cpu")
    assert bf.detector.dtype == torch.float32 and bf.sam.dtype == torch.bfloat16
    jcfg = JConfig.from_dict(cfg_dict("jax"))
    jseg = jseg2d.Segmentor2D(jcfg, clip_model=jc, clip_tokenizer=JHashTokenizer(
        jc.cfg.vocab_size, jc.cfg.context_length))
    jseg2d.run(jcfg, "towel", scenes=["scene0000_00"], segmentor=jseg)
    tseg2d.run(tseg.cfg, "towel", scenes=["scene0000_00"], segmentor=tseg)
    trec = jio.load_frame_records(str(tmp_path / "out_torch" / "towel" / "scene0000_00.pth"))
    jrec = jio.load_frame_records(str(tmp_path / "out_jax" / "towel" / "scene0000_00.pth"))
    assert len(jrec) == 4 and _assert_records_close(trec, jrec) > 0


@pytest.mark.parametrize("which", ["yolo_world", "efficientsam"])
def test_missing_configured_file_raises(tmp_path, which):
    path = str(tmp_path / "absent.pt")
    cfg = TConfig.from_dict({"detector": {"kind": "yolo_world", "dtype": "float32",
                                          f"{which}_checkpoint": path}})
    with pytest.raises(FileNotFoundError, match="absent.pt"):
        tseg2d.Segmentor2D(cfg, device="cpu")


def test_unported_detector_kind_raises():
    with pytest.raises(NotImplementedError, match="owlvit"):
        tseg2d.Segmentor2D(TConfig.from_dict({"detector": {"kind": "owlvit"}}), device="cpu")
