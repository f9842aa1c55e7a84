"""The port's class sweep against the JAX package's: Grounding-DINO's
backbone/detect split, fused captions and their demux, the multi-class 2D
stage (``run_classes``, per class and fused) and ``SweepRunner``.

Both packages run the ``"test"`` presets with the same weights (JAX
parameters carried into the port) on ``scripts/make_synthetic_scene.py``'s
scene. The JAX side uploads dense RGB frames (``BFF_SEG2D_YUV=0``) and cuts
CLIP crops on the host (``BFF_CLIP_DEVICE_CROPS=0``), the port's only
transport, and resizes them with OpenCV's own arithmetic (IPP off, see
tests/test_torch_seg2d.py). Records are held to the seg2d tolerances: CLIP
confidences within 1e-4, mask IoU >= 0.999.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.orchestration import SweepRunner as JSweepRunner
from beyondff_tpu.pipeline import segmentation_2d as jseg2d
from beyondff_tpu.utils import io as jio
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.core import rle as trle
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.models.gdino import model as tgdino
from beyondff_tpu_torch.orchestration import sweep as tsweep
from beyondff_tpu_torch.pipeline import segmentation_2d as tseg2d

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_synthetic_scene  # noqa: E402

CLASSES = ["towel", "clothes"]


def _carry(make, params, fn, cfg):
    module = tlayers.build(make, torch.device("cpu"))
    module.load_state_dict(fn(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module


def _port_segmentor(jseg, cfg):
    det_cfg, sam_cfg, clip_cfg = jseg.detector.cfg, jseg.sam.cfg, jseg.clip.cfg
    det = tgdino.GroundingDINO(det_cfg, _carry(lambda: tgdino.GDINOModule(det_cfg),
                                               jseg.detector.params, convert.gdino_from_jax,
                                               det_cfg))
    sam = tsam.SAM(sam_cfg, _carry(lambda: tsam.SAMModule(sam_cfg), jseg.sam.params,
                                   convert.sam_from_jax, sam_cfg))
    clip = tclip.CLIP(clip_cfg, _carry(lambda: tclip.CLIPModule(clip_cfg), jseg.clip.params,
                                       convert.clip_from_jax, clip_cfg))
    return tseg2d.Segmentor2D(cfg, detector=det, sam=sam, clip_model=clip, device="cpu")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic scene (6 frames at 242 x 324; two frames run through
    the 2D stage) and a JAX segmentor with the port's copy of its models."""
    root = str(tmp_path_factory.mktemp("sweep") / "root")
    cfg_path = make_synthetic_scene.generate(root, query="towel", seed=2)
    raw = yaml.safe_load(open(cfg_path))
    raw["frames"]["downsample_ratio"] = 3
    raw["detector"].update({"box_threshold": 0.0, "must_match_query": False,
                            "similarity_threshold": -10.0, "max_detections": 4,
                            "dtype": "float32", "frame_batch": 2, "fused_group": 8})
    jseg = jseg2d.Segmentor2D(JConfig.from_dict(raw))
    tseg = _port_segmentor(jseg, TConfig.from_dict(raw))
    return {"root": root, "raw": raw, "jseg": jseg, "tseg": tseg}


@pytest.fixture
def jax_transport(monkeypatch):
    """The JAX side on the port's transport: dense RGB uploads, host crops,
    OpenCV's own cubic resize."""
    monkeypatch.setenv("BFF_SEG2D_YUV", "0")
    monkeypatch.setenv("BFF_CLIP_DEVICE_CROPS", "0")
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


# ------------------------------------------------------------ Grounding-DINO
def test_gdino_split_path_equals_full_forward(scene):
    """Banked pyramid + ``detect`` equals the full forward, for the caption
    that fills the bank and for a later caption that reuses it."""
    det = scene["tseg"].detector
    frames = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (2, 48, 64, 3),
                                                                dtype=np.uint8))
    bank, key = {}, ("det_feats", ("0", "3"))
    for caption in ("towel", "clothes . towel"):
        full, ids, b = det.predict_batch_frames_async(frames, caption)
        split, ids2, b2 = det.predict_batch_frames_async(frames, caption, feats_cache=(bank, key))
        assert key in bank and len(bank) == 1
        assert torch.equal(full.tensor, split.tensor) and b == b2 == 2
        np.testing.assert_array_equal(ids, ids2)


def test_caption_spans_and_fused_groups_match_jax(scene):
    jdet, tdet = scene["jseg"].detector, scene["tseg"].detector
    for classes in (["towel"], ["towel", "clothes"], ["trash can", "office chair", "cup"]):
        assert tdet.caption_spans(classes) == jdet.caption_spans(classes)
    many = [f"thing{i}" for i in range(9)]  # "test" preset: 16 text tokens
    for det in (jdet, tdet):
        with pytest.raises(ValueError):
            det.caption_spans(many)
    for size in (9, 3):
        got = tseg2d._fused_groups(tdet, many, size)
        assert got == jseg2d._fused_groups(jdet, many, size)
        assert [c for g, _cap, _sp in got for c in g] == many
    # one greedy chunk of 9 overflows and is bisected
    assert [g for g, _cap, _sp in tseg2d._fused_groups(tdet, many, 9)] == [many[:4], many[4:]]
    with pytest.raises(ValueError):  # a lone class that tokenizes into two phrases
        tseg2d._fused_groups(tdet, ["towel", "shelf . rack"], 8)


def test_predict_finalize_demux_matches_jax(scene):
    jdet, tdet = scene["jseg"].detector, scene["tseg"].detector
    caption, spans = tdet.caption_spans(CLASSES)
    ids = tdet.tokenizer([caption])["input_ids"]
    t = ids.shape[1]
    packed = np.random.default_rng(1).random((2, 7, 5 + t)).astype(np.float32)
    packed[..., 0] = packed[..., 5:].max(-1)
    jh, th = (packed, ids, 2), (torch.from_numpy(packed), ids, 2)
    for thr in (0.5, [0.3, 0.8]):
        want = jdet.predict_finalize_demux(jh, spans, box_threshold=thr, text_threshold=0.4)
        got = tdet.predict_finalize_demux(th, spans, box_threshold=thr, text_threshold=0.4)
        for gf, wf in zip(got, want):
            for (gb, gs, gp), (wb, ws, wp) in zip(gf, wf):
                np.testing.assert_array_equal(gb, wb)
                np.testing.assert_array_equal(gs, ws)
                assert gp == wp
    whole = tdet.predict_finalize_demux(th, [(0, t)], box_threshold=0.5, text_threshold=0.4)
    plain = tdet.predict_finalize(th, box_threshold=0.5, text_threshold=0.4)
    for (wb, ws, wp), (pb, ps, pp) in zip([f[0] for f in whole], plain):
        np.testing.assert_array_equal(wb, pb)
        np.testing.assert_array_equal(ws, ps)
        assert wp == pp
    with pytest.raises(ValueError):
        tdet.predict_finalize_demux(th, spans, box_threshold=[0.5])


# ---------------------------------------------------------------- run_classes
def test_run_classes_per_class_matches_jax_and_run(scene, jax_transport):
    """Per-class ``run_classes`` (frame, pyramid and embedding banks, one
    class with its own box threshold) against the JAX package's, and against
    the port's per-class ``run()``; resume then does nothing."""
    jcfg, tcfg = _configs(scene, "percls", fused_captions=False)
    thr = {"clothes": 0.3}
    jres = jseg2d.run_classes(jcfg, CLASSES, segmentor=scene["jseg"], class_thresholds=thr)
    tres = tseg2d.run_classes(tcfg, CLASSES, segmentor=scene["tseg"], class_thresholds=thr)
    assert tres == jres and all(tres[c] for c in CLASSES)
    n = sum(_assert_records_close(_records(tcfg, c), _records(jcfg, c)) for c in CLASSES)
    assert n > 0
    assert tseg2d.run_classes(tcfg, CLASSES, segmentor=scene["tseg"]) == {c: [] for c in CLASSES}

    _j, rcfg = _configs(scene, "run")
    for c in CLASSES:
        seg = scene["tseg"]
        seg.cfg = rcfg.override(**{"detector.box_threshold": thr.get(c, 0.0)})
        try:
            tseg2d.run(seg.cfg, c, segmentor=seg)
        finally:
            seg.cfg = tcfg
        _assert_records_close(_records(rcfg, c), _records(tcfg, c), conf_atol=1e-6, iou_min=1.0)


def test_run_classes_fused_matches_jax(scene, jax_transport):
    """Fused captions: one detection pass per group split by token span, one
    combined replay; the port against the JAX package's fused path (fused
    detections are not per-class detections, so no per-class reference)."""
    jcfg, tcfg = _configs(scene, "fused", fused_captions=True)
    calls = []
    det = scene["tseg"].detector
    real = det.predict_finalize_demux
    det.predict_finalize_demux = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        tres = tseg2d.run_classes(tcfg, CLASSES, segmentor=scene["tseg"])
    finally:
        del det.predict_finalize_demux
    jres = jseg2d.run_classes(jcfg, CLASSES, segmentor=scene["jseg"])
    assert calls and tres == jres
    assert sum(_assert_records_close(_records(tcfg, c), _records(jcfg, c)) for c in CLASSES)


def test_banks_fill_once_and_respect_their_caps(scene, monkeypatch):
    """A second class re-encodes no frame and reruns no backbone; the caps
    and switches stop banking without changing records."""
    seg = scene["tseg"]
    encoded = []
    real = seg.sam.encode_frames
    monkeypatch.setattr(seg.sam, "encode_frames",
                        lambda f: encoded.append(int(f.shape[0])) or real(f))
    bank = {}
    one = seg.process_scene("scene0000_00", "towel", frame_bank=bank)
    sizes = tseg2d.bank_sizes(bank)
    assert sizes["frames"] == 2 and sizes["det_feats_frames"] == 2 and sizes["sam_emb"] > 0
    encoded.clear()
    seg.process_scene("scene0000_00", "clothes", frame_bank=bank)
    assert encoded == [] and tseg2d.bank_sizes(bank) == sizes
    monkeypatch.setenv("BFF_SEG2D_BANK_FEATS_CAP", "0")
    monkeypatch.setenv("BFF_SEG2D_BANK_EMB", "0")
    bank2 = {}
    capped = seg.process_scene("scene0000_00", "towel", frame_bank=bank2)
    assert tseg2d.bank_sizes(bank2)["det_feats_frames"] == 0
    assert tseg2d.bank_sizes(bank2)["sam_emb"] == 0
    assert [r["frame_id"] for r in capped] == [r["frame_id"] for r in one]
    for a, b in zip(capped, one):
        np.testing.assert_array_equal(a["segmented_frame_masks"], b["segmented_frame_masks"])
    with pytest.raises(ValueError):
        seg.process_scene("scene0000_00", "towel", override_groups={"towel": {}})


# ------------------------------------------------------------------ sweeps
def test_sweep_runner_matches_jax(scene, jax_transport, tmp_path):
    """``SweepRunner`` over two classes with the amortized 2D stage, port
    (on the CPU) against the JAX package: the results table byte-identical,
    the sweep checkpoint equal, and both amortized passes on record."""
    out = {}
    for side in ("jax", "torch"):
        raw = {**scene["raw"], "paths": {
            **scene["raw"]["paths"],
            **{k: str(tmp_path / side / k) for k in ("mask_2d_dir", "mask_3d_dir",
                                                      "final_output_dir", "checkpoint_dir",
                                                      "results_dir")}}}
        ckpt = str(tmp_path / f"proc_{side}.txt")
        if side == "jax":
            runner = JSweepRunner(JConfig.from_dict(raw), checkpoint_path=ckpt)
            runner._segmentor = scene["jseg"]
        else:
            seg = scene["tseg"]
            seg.cfg = TConfig.from_dict(raw)
            runner = tsweep.SweepRunner(seg.cfg, checkpoint_path=ckpt, device="cpu",
                                        segmentor=seg, plot_pr_curves=False)
        try:
            status = runner.run(CLASSES, amortize_segmentation=True)
        finally:
            scene["tseg"].cfg = TConfig.from_dict(scene["raw"])
        assert all(all(s.values()) for s in status.values()), status
        out[side] = (open(os.path.join(raw["paths"]["results_dir"],
                                       "overall_results.txt")).read(),
                     yaml.safe_load(open(ckpt)), runner)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    assert out["torch"][2].amortized == {"segmentation": CLASSES, "projection": CLASSES}
    for c in CLASSES:
        assert f"\n{c}," in out["torch"][0]


def _find_parameters_cfg(root, tag, classes):
    base = TConfig.from_yaml(os.path.join(root, "config.yaml"))
    cfg = base.override(**{"paths.results_dir": os.path.join(root, f"eval_{tag}"),
                           "paths.checkpoint_dir": os.path.join(root, f"ckpt_{tag}"),
                           "paths.mask_3d_dir": os.path.join(root, f"m3d_{tag}"),
                           "paths.final_output_dir": os.path.join(root, f"final_{tag}")})
    for c in classes[1:]:
        dst = os.path.join(base.paths.mask_2d_dir, c)
        if not os.path.isdir(dst):
            shutil.copytree(os.path.join(base.paths.mask_2d_dir, "towel"), dst)
    return cfg


def test_two_hosts_merge_equals_single_host(tmp_path):
    """Two hosts over the class partition (find-parameters mode), then the
    merge: the table byte-identical to one host's, every stage marked."""
    root = str(tmp_path / "root")
    make_synthetic_scene.generate(root, query="towel", seed=2)
    classes = ["towel", "pillow", "blanket"]
    mh = _find_parameters_cfg(root, "mh", classes)
    ckpt = str(tmp_path / "proc_mh.txt")
    for host in range(2):
        r = tsweep.SweepRunner(mh, checkpoint_path=ckpt, skip_segmentation=True,
                               amortize_projection=False, hosts=2, host=host, device="cpu",
                               plot_pr_curves=False)
        assert all(all(v.values()) for v in r.run(classes, skip=()).values())
    assert not os.path.exists(os.path.join(mh.paths.results_dir, "overall_results.txt"))
    tsweep.merge_host_results(mh, 2, checkpoint_path=ckpt)
    sh = _find_parameters_cfg(root, "sh", classes)
    r = tsweep.SweepRunner(sh, checkpoint_path=str(tmp_path / "proc_sh.txt"),
                           skip_segmentation=True, device="cpu", plot_pr_curves=False)
    r.run(classes, skip=())
    assert r.amortized["projection"] == classes
    merged = open(os.path.join(mh.paths.results_dir, "overall_results.txt")).read()
    assert merged == open(os.path.join(sh.paths.results_dir, "overall_results.txt")).read()
    merged_ckpt = yaml.safe_load(open(ckpt))
    for c in classes:
        assert f"\n{c}," in merged
        assert all(merged_ckpt[c][s] for s in ("projection", "refinement", "evaluation"))


def test_subprocess_stages_run_the_port_clis(tmp_path):
    """``use_subprocess`` runs ``python -m beyondff_tpu_torch.tools.*`` (never
    the JAX tools); a second host's evaluation patches its own table."""
    root = str(tmp_path / "root")
    make_synthetic_scene.generate(root, query="towel", seed=2)
    cfg = _find_parameters_cfg(root, "sub", ["towel", "pillow"])
    cfg_path = str(tmp_path / "sub.yaml")
    cfg.to_yaml(cfg_path)
    r = tsweep.SweepRunner(cfg, config_path=cfg_path, checkpoint_path=str(tmp_path / "p.txt"),
                           skip_segmentation=True, use_subprocess=True, hosts=2, host=1,
                           device="cpu", plot_pr_curves=False)
    seen = []
    real = subprocess.run

    def spy(cmd, **kw):
        seen.append(cmd)
        return real(cmd, **kw)

    tsweep.subprocess.run = spy
    try:
        status = r.run(["towel", "pillow"], skip=())
    finally:
        tsweep.subprocess.run = real
    assert status == {"pillow": {"segmentation": True, "projection": True,
                                 "refinement": True, "evaluation": True}}
    assert [c[2] for c in seen] == [f"beyondff_tpu_torch.tools.{m}" for m in
                                    ("projection_2d_to_3d", "refinement", "eval_scannet200")]
    assert seen[-1][-3:] == ["--table", "overall_results.host1of2.txt", "--no-pr-curves"]
    table = open(os.path.join(cfg.paths.results_dir, "overall_results.host1of2.txt")).read()
    assert "\npillow," in table and "\npillow,-" not in table and "\ntowel,-" in table


def test_advice_deviations_raise(tmp_path, monkeypatch):
    """The JAX package's faults the port leaves out: a host index without the
    host count, and a merge with no per-host table, raise."""
    with pytest.raises(ValueError):
        tsweep.resolve_hosts(None, 1)
    assert tsweep.resolve_hosts(None, None) == (1, 0)
    assert tsweep.resolve_hosts(4, 2) == (4, 2)
    cfg = TConfig.from_dict({"paths": {"results_dir": str(tmp_path / "none")}})
    with pytest.raises(FileNotFoundError):
        tsweep.merge_host_results(cfg, 2, checkpoint_path=str(tmp_path / "c.txt"))
    with pytest.raises(ValueError):
        tsweep.host_partition(["a"], 2, 2)
    parts = [tsweep.host_partition([f"c{i}" for i in range(11)], 3, i) for i in range(3)]
    assert sorted(c for p in parts for c in p) == sorted(f"c{i}" for i in range(11))
    from beyondff_tpu.orchestration import default_class_list as jclasses

    assert tsweep.default_class_list() == jclasses() and tsweep.default_class_list(3) == jclasses(3)
    assert len(tsweep.default_class_list()) == 120


def test_amortized_pass_failure_falls_back_and_is_not_recorded(tmp_path, monkeypatch):
    """As in the JAX package, a failing amortized 2D pass leaves the classes
    to the per-class stage; ``amortized`` then does not list them."""
    r = tsweep.SweepRunner(TConfig(), checkpoint_path=str(tmp_path / "s.txt"), device="cpu",
                           segmentor=object())
    monkeypatch.setattr(tseg2d, "run_classes",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("x")))
    calls = []
    monkeypatch.setattr(r, "_run_stage", lambda s, c: calls.append((s, c)))
    r.run(["towel", "clothes"], amortize_segmentation=True)
    assert ("segmentation", "towel") in calls and r.amortized["segmentation"] == []
