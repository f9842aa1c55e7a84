"""The port's 2D stage (beyondff_tpu_torch.pipeline.segmentation_2d) vs the
JAX package's, plus the host-side pieces the stage carries across.

The slice tests run both packages' ``run()`` on one 4-frame scene (48x64,
and 30x40, below SAM's input size) at the ``"test"`` presets with the same
weights (JAX parameters carried into the port), the JAX side with dense
RGB frame uploads (``BFF_SEG2D_YUV=0``), and compare the written ``.pth``
records through the JAX package's loader.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.core import rle as jrle
from beyondff_tpu.models import tokenizers as jtok
from beyondff_tpu.models.gdino import model as jgdino
from beyondff_tpu.pipeline import descriptors as jdesc
from beyondff_tpu.pipeline import segmentation_2d as jseg2d
from beyondff_tpu.utils import io as jio
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.core import resize as tresize
from beyondff_tpu_torch.core import rle as trle
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.models import tokenizers as ttok
from beyondff_tpu_torch.models.gdino import model as tgdino
from beyondff_tpu_torch.pipeline import descriptors as tdesc
from beyondff_tpu_torch.pipeline import segmentation_2d as tseg2d

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture
def opencv_own_cubic():
    """OpenCV's own INTER_CUBIC arithmetic for the JAX side's host resizes:
    pip builds hand it to Intel IPP, which rounds differently on ~5% of the
    values (core/resize.py); the port reproduces OpenCV's own."""
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


def _iou(a, b):
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else inter / union


def _run_both(tmp_path, monkeypatch, hw):
    """Both packages' ``run()`` on one 4-frame scene of ``hw`` frames; the
    records compared through the JAX package's loader."""
    h, w = hw
    rng = np.random.default_rng(6)
    scene = tmp_path / "scene0000_00" / "color"
    scene.mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(scene / f"{i}.jpg"), rng.integers(0, 255, (h, w, 3), dtype=np.uint8))

    def cfg_dict(tag):
        return {
            "paths": {"scene_2d_dir": str(tmp_path), "mask_2d_dir": str(tmp_path / f"out_{tag}"),
                      "checkpoint_dir": str(tmp_path / f"ckpt_{tag}")},
            "frames": {"width_2d": w, "height_2d": h, "downsample_ratio": 1},
            "detector": {"box_threshold": -1.0, "must_match_query": False,
                         "similarity_threshold": -10.0, "dtype": "float32",
                         "frame_batch": 2},
        }

    monkeypatch.setenv("BFF_SEG2D_YUV", "0")
    jcfg = JConfig.from_dict(cfg_dict("jax"))
    jseg = jseg2d.Segmentor2D(jcfg)
    tcfg = TConfig.from_dict(cfg_dict("torch"))
    tseg = _port_segmentor(jseg, tcfg)
    jres = jseg2d.run(jcfg, "clothes", scenes=["scene0000_00"], segmentor=jseg)
    tres = tseg2d.run(tcfg, "clothes", scenes=["scene0000_00"], segmentor=tseg)
    assert tres == jres

    jrec = jio.load_frame_records(str(tmp_path / "out_jax" / "clothes" / "scene0000_00.pth"))
    trec = jio.load_frame_records(str(tmp_path / "out_torch" / "clothes" / "scene0000_00.pth"))
    assert [r["frame_id"] for r in trec] == [r["frame_id"] for r in jrec]
    for t, j in zip(trec, jrec):
        assert t["labels"] == j["labels"]
        assert t["confidences"].dtype == np.float32
        np.testing.assert_allclose(t["confidences"], j["confidences"], atol=1e-4, rtol=0)
    tdec = jrle.decode_frame_masks(trec, image_shape=(h, w))
    jdec = jrle.decode_frame_masks(jrec, image_shape=(h, w))
    n_masks = 0
    for t, j in zip(tdec, jdec):
        tm, jm = t["segmented_frame_masks"], j["segmented_frame_masks"]
        assert tm.shape == jm.shape
        for a, b in zip(tm.astype(bool), jm.astype(bool)):
            flipped = int((a != b).sum())
            assert _iou(a, b) >= 0.999, f"{flipped} flipped pixels"
            n_masks += 1
    assert n_masks > 0


def test_run_matches_jax_run(tmp_path, monkeypatch, opencv_own_cubic):
    _run_both(tmp_path, monkeypatch, (48, 64))


def test_run_matches_jax_run_frames_below_sam_size(tmp_path, monkeypatch, opencv_own_cubic):
    """Frames whose long side (40) is below SAM's ``img_size`` (64): the
    masks shrink from SAM's input to the frame, where the JAX package's
    resize antialiases."""
    _run_both(tmp_path, monkeypatch, (30, 40))


def test_process_frame_host_path_matches_jax(opencv_own_cubic):
    """``process_frame``: host resize to the detector input, CLIP filter,
    SAM decode — the same records as the JAX package."""
    cfg = {"detector": {"box_threshold": 0.0, "must_match_query": False,
                        "similarity_threshold": -10.0, "dtype": "float32"}}
    jseg = jseg2d.Segmentor2D(JConfig.from_dict(cfg))
    tseg = _port_segmentor(jseg, TConfig.from_dict(cfg))
    img = np.random.default_rng(1).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    j = jseg.process_frame(img, "chair")
    t = tseg.process_frame(img, "chair")
    assert t["labels"] == j["labels"]
    np.testing.assert_allclose(t["confidences"], j["confidences"], atol=1e-4)
    for a, b in zip(t["segmented_frame_masks"][:, 0], j["segmented_frame_masks"][:, 0]):
        assert _iou(a, b) >= 0.999, f"{int((a != b).sum())} flipped pixels"


# ------------------------------------------------------------------- imports
def _port_modules():
    out = []
    pkg = os.path.join(REPO, "beyondff_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3].replace(os.sep, ".")
                out.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(out)


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "flax") or root == "beyondff_tpu"


def test_port_imports_no_jax_at_run_time():
    mods = _port_modules() + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'beyondff_tpu'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_import_no_jax():
    files = [os.path.join(REPO, m.replace(".", os.sep)) for m in _port_modules()]
    files = [f + ".py" if os.path.exists(f + ".py") else os.path.join(f, "__init__.py")
             for f in files] + [os.path.join(REPO, "chip_smoke.py")]
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


# ------------------------------------------------------------------- resizes
@pytest.mark.parametrize("src,dst", [((968, 1296), (766, 1024)), ((968, 1296), (765, 1024)),
                                     ((765, 1024), (800, 1072)), ((48, 64), (64, 96)),
                                     ((37, 53), (120, 77))])
def test_resize_linear_bit_exact_to_cv2(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(tresize.resize_linear(img, dst), want)


@pytest.mark.parametrize("src,dst", [((300, 400), (224, 298)), ((20, 31), (224, 347)),
                                     ((48, 64), (28, 37)), ((968, 1296), (765, 1024))])
def test_resize_cubic_bit_exact_to_cv2(src, dst, opencv_own_cubic):
    img = np.random.default_rng(sum(dst)).integers(0, 256, (*src, 3), dtype=np.uint8)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_array_equal(tresize.resize_cubic(img, dst), want)


def test_resize_cubic_within_one_level_of_ipp():
    """With OpenCV's IPP HAL on (its default in pip builds): one level at most."""
    cv2.ipp.setUseIPP(True)
    img = np.random.default_rng(3).integers(0, 256, (300, 400, 3), dtype=np.uint8)
    want = cv2.resize(img, (298, 224), interpolation=cv2.INTER_CUBIC).astype(int)
    diff = np.abs(tresize.resize_cubic(img, (224, 298)).astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.1


@pytest.mark.parametrize("size", [(64, 96), (800, 1072), (30, 41)])
def test_device_bilinear_matches_jax_image_resize(size):
    """The detector's on-device resize: F.interpolate(bilinear,
    align_corners=False, antialias=False) == jax.image.resize(bilinear,
    antialias=False), up and down."""
    import torch.nn.functional as F

    x = np.random.default_rng(0).uniform(0, 255, (1, 48, 64, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *size, 3), "bilinear",
                                       antialias=False))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=size, mode="bilinear",
                        align_corners=False, antialias=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)


# -------------------------------------------------------- carried-over bits
def test_rle_byte_identical(rng):
    masks = rng.random((5, 48 * 64)) < 0.3
    masks[0] = False
    masks[1] = True
    for m in masks:
        a, b = jrle.rle_encode(m), trle.rle_encode(m)
        assert a["length"] == b["length"] and a["counts"].dtype == b["counts"].dtype
        np.testing.assert_array_equal(a["counts"], b["counts"])
        np.testing.assert_array_equal(jrle.rle_decode(b), trle.rle_decode(a))
    np.testing.assert_array_equal(trle.rle_decode_batch(trle.rle_encode_batch(masks)),
                                  masks.astype(np.uint8))


def test_tokenizers_and_descriptors_match_jax():
    texts = ["A photo of a chair, which has foot loud.", "clothes . a red chair ."]
    np.testing.assert_array_equal(ttok.HashTokenizer(512, 16)(texts),
                                  jtok.HashTokenizer(512, 16)(texts))
    a, b = tgdino._HashBert(64)(texts), jgdino._HashBert(64)(texts)
    for k in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(a[k], b[k])
    for method in ("toy", "waffle"):
        assert tdesc.generate("clothes", method, seed=3) == jdesc.generate("clothes", method,
                                                                            seed=3)


def test_config_reads_the_same_files(tmp_path):
    flat = {"dataset": "Scannet200", "dino_box_threshold": 0.3, "CLIP_model_size": "ViT-L/14",
            "min_aggragated_masks": 3, "refiment_iou_thres": 0.5, "must_match_base_prompt": False,
            "ckpt_repo_id": "ignored"}
    structured = {"detector": {"frame_batch": 2, "dtype": "float32"}, "seed": 4}
    for raw in (flat, structured):
        a, b = JConfig.from_dict(raw).to_dict(), TConfig.from_dict(raw).to_dict()
        a["detector"].pop("waffle_word_list_path")
        b["detector"].pop("waffle_word_list_path")
        assert a == b
    path = str(tmp_path / "c.yaml")
    TConfig.from_dict(structured).to_yaml(path)
    assert JConfig.from_yaml(path).detector.frame_batch == 2
