"""The port's deferred seg2d pipeline against itself and the JAX package.

``Segmentor2D.process_scene`` runs the JAX package's three-stage deferred
completion under ``BFF_SEG2D_INFLIGHT``, ``BFF_SEG2D_DEFER`` and
``BFF_SEG2D_EAGER_SAM``. On a 5-frame scene (``frame_batch`` 2, so the last
batch is partial; frame 3 is noise, which JXT spills) with the CLIP filter's
threshold calibrated at the median similarity, so it keeps some boxes and
drops others, the port's written ``.pth`` files are byte-equal under every
setting, and they agree with the JAX package's default run at the seg2d
bars (CLIP confidences within 1e-4, mask IoU >= 0.999). Both detectors run
on both packages' default transports (no transport switch set); the fast
variant with two-tier uploads forced on (JXT frames, device crops), and the
class sweep with fused captions (the demux pass, then the group replay).
"""

import os

import numpy as np
import pytest
import torch

import jax

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.pipeline import segmentation_2d as jseg2d
from beyondff_tpu.utils import io as jio
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.core import rle as trle
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import efficientsam as tesam
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.models import yolo_world as tyw
from beyondff_tpu_torch.models.gdino import model as tgdino
from beyondff_tpu_torch.pipeline import segmentation_2d as tseg2d
from transport_inputs import structured

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")
CPU = torch.device("cpu")
HW = (96, 128)
SCENE = "scene0000_00"
# (BFF_SEG2D_INFLIGHT, BFF_SEG2D_DEFER, BFF_SEG2D_EAGER_SAM); (2, 1, 1) is the default
SETTINGS = ((1, 0, 0), (1, 0, 1), (2, 1, 1), (2, 1, 0), (3, 2, 1))
SWITCHES = ("BFF_SEG2D_YUV", "BFF_SEG2D_TWO_TIER", "BFF_SEG2D_BATCH_UPLOAD",
            "BFF_CLIP_DEVICE_CROPS", "BFF_CLIP_YUV", "BFF_SEG2D_JXT", "BFF_SEG2D_INFLIGHT",
            "BFF_SEG2D_DEFER", "BFF_SEG2D_EAGER_SAM", "BFF_SEG2D_FUSED")


def _carry(make, params, fn, cfg):
    module = tlayers.build(make, CPU)
    module.load_state_dict(fn(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module


def _port_segmentor(jseg, cfg):
    ccfg, dcfg, scfg = jseg.clip.cfg, jseg.detector.cfg, jseg.sam.cfg
    clip = tclip.CLIP(ccfg, _carry(lambda: tclip.CLIPModule(ccfg), jseg.clip.params,
                                   convert.clip_from_jax, ccfg))
    if cfg.detector.kind == "yolo_world":
        det = tyw.YOLOWorld(dcfg, _carry(lambda: tyw.YOLOWorldModule(dcfg), jseg.detector.params,
                                         convert.yolo_world_from_jax, dcfg))
        sam = tesam.EfficientSAM(scfg, _carry(lambda: tsam.SAMModule(scfg), jseg.sam.params,
                                              convert.efficientsam_from_jax, scfg))
    else:
        det = tgdino.GroundingDINO(dcfg, _carry(lambda: tgdino.GDINOModule(dcfg),
                                                jseg.detector.params, convert.gdino_from_jax,
                                                dcfg))
        sam = tsam.SAM(scfg, _carry(lambda: tsam.SAMModule(scfg), jseg.sam.params,
                                    convert.sam_from_jax, scfg))
    return tseg2d.Segmentor2D(cfg, detector=det, sam=sam, clip_model=clip, device=CPU)


def _spread(variables, seed):
    """Non-degenerate seeded YOLO-World variables."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = str(getattr(path[-1], "key", path[-1]))
        shape = np.shape(x)
        if name == "kernel":
            return rng.normal(0, np.prod(shape[:-1]) ** -0.5, shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture
def defaults(monkeypatch):
    """Neither package sees a transport or scheduler switch."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    cv2.ipp.setUseIPP(False)  # OpenCV's own INTER_CUBIC for the host crops
    yield monkeypatch
    cv2.ipp.setUseIPP(True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Five frames (the fourth noise), both detectors' JAX segmentors and the
    port's copies, each with the CLIP threshold at the median similarity
    of the port's unfiltered run."""
    root = tmp_path_factory.mktemp("deferred")
    color = root / "2d" / SCENE / "color"
    color.mkdir(parents=True)
    for i in range(5):
        img = structured(*HW, seed=20 + i)
        if i == 3:
            img = np.random.default_rng(i).integers(0, 255, img.shape, dtype=np.uint8)
        cv2.imwrite(str(color / f"{i}.jpg"), img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
    out = {"root": root}
    for kind in ("grounding_dino", "yolo_world"):
        raw = {"paths": {"scene_2d_dir": str(root / "2d")},
               "frames": {"width_2d": HW[1], "height_2d": HW[0], "downsample_ratio": 1},
               "detector": {"kind": kind, "box_threshold": -1.0 if kind == "grounding_dino"
                            else 0.0, "must_match_query": False,
                            "similarity_threshold": -10.0, "max_detections": 4,
                            "dtype": "float32", "frame_batch": 2, "fused_group": 8}}
        jseg = jseg2d.Segmentor2D(JConfig.from_dict(raw))
        if kind == "yolo_world":
            jseg.detector.params = _spread(jseg.detector.params, 9)
        tseg = _port_segmentor(jseg, TConfig.from_dict(raw))
        probe = tseg.process_scene(SCENE, "towel")
        sims = np.concatenate([r["confidences"] for r in probe])
        assert sims.size >= 4
        raw["detector"]["similarity_threshold"] = float(np.median(sims))
        jseg.cfg, tseg.cfg = JConfig.from_dict(raw), TConfig.from_dict(raw)
        out[kind] = (raw, jseg, tseg, sims.size)
    return out


def _configs(scene, kind, tag):
    raw = scene[kind][0]
    out = []
    for side, cls in (("jax", JConfig), ("torch", TConfig)):
        paths = {**raw["paths"], "mask_2d_dir": str(scene["root"] / f"m2d_{tag}_{side}"),
                 "checkpoint_dir": str(scene["root"] / f"ck_{tag}_{side}")}
        out.append(cls.from_dict({**raw, "paths": paths}))
    return out


def _set(env, setting):
    for name, value in zip(("BFF_SEG2D_INFLIGHT", "BFF_SEG2D_DEFER", "BFF_SEG2D_EAGER_SAM"),
                           setting):
        env.setenv(name, str(value))


def _with_cfg(seg, cfg, fn):
    old, seg.cfg = seg.cfg, cfg
    try:
        return fn()
    finally:
        seg.cfg = old


def _pth(cfg, cls):
    return os.path.join(cfg.paths.mask_2d_dir, cls, f"{SCENE}.pth")


def _iou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


def _assert_close_to_jax(tcfg, jcfg, cls):
    got, want = jio.load_frame_records(_pth(tcfg, cls)), jio.load_frame_records(_pth(jcfg, cls))
    assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want]
    n = 0
    for t, j in zip(got, want):
        assert list(t["labels"]) == list(j["labels"])
        np.testing.assert_allclose(t["confidences"], j["confidences"], atol=1e-4, rtol=0)
        for a, b in zip(trle.rle_decode_batch(t["segmented_frame_masks"]).astype(bool),
                        trle.rle_decode_batch(j["segmented_frame_masks"]).astype(bool)):
            assert _iou(a, b) >= 0.999
            n += 1
    return n


@pytest.mark.parametrize("kind", ["grounding_dino", "yolo_world"])
def test_run_byte_equal_across_settings_and_matches_jax(scene, defaults, kind):
    """``run()`` under every scheduler setting: the same ``.pth`` bytes;
    the JAX package's default run agrees; the filter kept some boxes and
    dropped others."""
    if kind == "yolo_world":
        defaults.setenv("BFF_SEG2D_TWO_TIER", "1")
    _raw, jseg, tseg, n_unfiltered = scene[kind]
    files = {}
    for setting in SETTINGS:
        _set(defaults, setting)
        _j, tcfg = _configs(scene, kind, f"run_{kind}_{''.join(map(str, setting))}")
        _with_cfg(tseg, tcfg, lambda: tseg2d.run(tcfg, "towel", scenes=[SCENE], segmentor=tseg,
                                                 resume=False))
        with open(_pth(tcfg, "towel"), "rb") as f:
            files[setting] = f.read()
    assert len(set(files.values())) == 1
    for name in ("BFF_SEG2D_INFLIGHT", "BFF_SEG2D_DEFER", "BFF_SEG2D_EAGER_SAM"):
        defaults.delenv(name)
    jcfg, tcfg = _configs(scene, kind, f"run_{kind}_default")
    _with_cfg(jseg, jcfg, lambda: jseg2d.run(jcfg, "towel", scenes=[SCENE], segmentor=jseg))
    _with_cfg(tseg, tcfg, lambda: tseg2d.run(tcfg, "towel", scenes=[SCENE], segmentor=tseg))
    assert open(_pth(tcfg, "towel"), "rb").read() == files[(2, 1, 1)]
    n_kept = _assert_close_to_jax(tcfg, jcfg, "towel")
    assert 0 < n_kept < n_unfiltered


@pytest.mark.parametrize("kind", ["grounding_dino", "yolo_world"])
def test_fused_run_classes_byte_equal_across_settings_and_matches_jax(scene, defaults, kind):
    """Fused ``run_classes``: the demux pass and the group replay (frame-
    major entries, one class per crop query) through the same stages; every
    class's file is byte-equal across settings and agrees with the JAX
    package's fused run."""
    classes = ["towel", "clothes"]
    _raw, jseg, tseg, _n = scene[kind]
    defaults.setenv("BFF_SEG2D_FUSED", "1")
    files = {}
    for setting in SETTINGS:
        _set(defaults, setting)
        _j, tcfg = _configs(scene, kind, f"fused_{kind}_{''.join(map(str, setting))}")
        _with_cfg(tseg, tcfg, lambda: tseg2d.run_classes(tcfg, classes, scenes=[SCENE],
                                                         segmentor=tseg, resume=False))
        files[setting] = tuple(open(_pth(tcfg, c), "rb").read() for c in classes)
    assert len(set(files.values())) == 1
    for name in ("BFF_SEG2D_INFLIGHT", "BFF_SEG2D_DEFER", "BFF_SEG2D_EAGER_SAM"):
        defaults.delenv(name)
    jcfg, tcfg = _configs(scene, kind, f"fused_{kind}_default")
    _with_cfg(jseg, jcfg, lambda: jseg2d.run_classes(jcfg, classes, scenes=[SCENE],
                                                     segmentor=jseg))
    _with_cfg(tseg, tcfg, lambda: tseg2d.run_classes(tcfg, classes, scenes=[SCENE],
                                                     segmentor=tseg))
    assert sum(_assert_close_to_jax(tcfg, jcfg, c) for c in classes) > 0


def test_eager_off_encodes_only_kept_frames(scene, defaults):
    """``BFF_SEG2D_EAGER_SAM=0`` encodes only frames that keep a box after
    the CLIP filter; the default encodes every frame with phrase-filtered
    boxes first. With the threshold just above one frame's best similarity,
    that frame loses every box: the records are the same, the encodes
    differ."""
    _raw, _jseg, tseg, _n = scene["grounding_dino"]
    probe = _with_cfg(tseg, tseg.cfg.override(**{"detector.similarity_threshold": -10.0}),
                      lambda: tseg.process_scene(SCENE, "towel"))
    best = sorted(max(r["confidences"]) for r in probe)
    assert len(best) == 5 and best[0] < best[1]
    cfg = tseg.cfg.override(**{"detector.similarity_threshold": (best[0] + best[1]) / 2})
    encoded, records = {}, {}
    real = tseg.sam.encode_frames
    for eager in ("1", "0"):
        defaults.setenv("BFF_SEG2D_EAGER_SAM", eager)
        frames = []
        tseg.sam.encode_frames = lambda x: frames.append(x.shape[0]) or real(x)
        try:
            records[eager] = _with_cfg(tseg, cfg, lambda: tseg.process_scene(SCENE, "towel"))
        finally:
            del tseg.sam.encode_frames
        encoded[eager] = sum(frames)
    assert [r["frame_id"] for r in records["0"]] == [r["frame_id"] for r in records["1"]]
    for a, b in zip(records["0"], records["1"]):
        assert a["confidences"] == b["confidences"]
        np.testing.assert_array_equal(a["segmented_frame_masks"], b["segmented_frame_masks"])
    assert encoded["0"] == len(records["0"]) == 4 and encoded["1"] == 5
