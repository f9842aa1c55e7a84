"""The port's transports and native host runtime against the JAX package's.

Same seeded inputs through both packages (CPU, "test" presets, 2 torch
threads):

* ``utils/native``: every entry point byte for byte against the JAX binding
  (both built from ``native/bff_native.cpp``); builds that race in spawned
  processes; a failed build raising; ``BFF_NO_NATIVE``;
* the host wires byte for byte: ``pack_ycrcb420``, JXT (natural-like frames,
  noise that spills, grayscale, 4:4:4, mixed quantization tables) and
  depth-pack (escapes, odd sizes, spills);
* the device decodes: depth-pack bit-exact; the YCrCb unpack, the JXT
  decode and resize and the device CLIP crops within one level on at most
  1e-4 of the values of the JAX package's jitted ones (float32 arithmetic
  in which XLA:CPU's summation order inside a contraction can round a .5
  the other way; measured: YCrCb and resize 0 values, crops 0 at 56 px and
  1 of 18 816 at the test preset's 28, the JXT decode 10 of 3.8 M at
  968x1296), and the CLIP features over them within 1e-4 (1e-5 for the
  YCrCb crops);
* the stages with no transport switch set in either package: ``run()`` for
  both detectors, fused ``run_classes`` and ``projection.run`` on
  ``scripts/make_synthetic_scene.py``'s scene (its JPEGs and PNGs; its noise
  frames spill JXT, so a copy with natural-like frames takes it), at the
  seg2d bars (CLIP confidences within 1e-4, mask IoU >= 0.999) and, for
  projection, exactly; one forced setting each of ``BFF_SEG2D_JXT=1`` and
  ``BFF_DEPTH_PACK=0``.

tests/test_torch_transports_card.py holds each device decode on the card
against its CPU result.
"""

import multiprocessing
import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.core import color as jcolor
from beyondff_tpu.core import crop_resize as jcrop
from beyondff_tpu.core import depth_pack as jdpack
from beyondff_tpu.core import jxt as jjxt
from beyondff_tpu.core import rle as jrle
from beyondff_tpu.models import clip as jclip
from beyondff_tpu.models.gdino.model import IMAGE_MEAN, IMAGE_STD
from beyondff_tpu.pipeline import projection as jprojection
from beyondff_tpu.pipeline import segmentation_2d as jseg2d
from beyondff_tpu.utils import io as jio
from beyondff_tpu.utils import native as jnative
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.core import color as tcolor
from beyondff_tpu_torch.core import crop_resize as tcrop
from beyondff_tpu_torch.core import depth_pack as tdpack
from beyondff_tpu_torch.core import jxt as tjxt
from beyondff_tpu_torch.core import rle as trle
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import efficientsam as tesam
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.models import yolo_world as tyw
from beyondff_tpu_torch.models.gdino import model as tgdino
from beyondff_tpu_torch.pipeline import projection as tprojection
from beyondff_tpu_torch.pipeline import segmentation_2d as tseg2d
from beyondff_tpu_torch.utils import io as tio
from beyondff_tpu_torch.utils import native as tnative

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_synthetic_scene  # noqa: E402
from transport_inputs import (crop_inputs, depth_cases, jpeg, jxt_cases,  # noqa: E402
                              smooth_depth, structured)

CPU = torch.device("cpu")
SWITCHES = ("BFF_SEG2D_YUV", "BFF_CLIP_YUV", "BFF_SEG2D_BATCH_UPLOAD", "BFF_CLIP_DEVICE_CROPS",
            "BFF_SEG2D_JXT", "BFF_DEPTH_PACK", "BFF_NO_NATIVE", "BFF_SEG2D_TWO_TIER")
LEVEL_SHARE = 1e-4  # share of values that may differ by one level


def _levels_close(got, want):
    d = np.abs(np.asarray(got, np.int64) - np.asarray(want, np.int64))
    assert d.max(initial=0) <= 1, d.max()
    assert (d > 0).mean() <= LEVEL_SHARE, (d > 0).mean()
    return int((d > 0).sum())


@pytest.fixture
def no_switches(monkeypatch):
    """Neither package sees a transport switch: both run their defaults."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    cv2.ipp.setUseIPP(False)  # OpenCV's own INTER_CUBIC for the host crops
    yield monkeypatch
    cv2.ipp.setUseIPP(True)


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX binding's library, which every JAX-side transport here needs.
    That binding compiles straight to its output file the first time each
    process loads it, so processes that start together can see a
    half-written library and fall back for good (ROADMAP Queue C). Where
    that happened in this process, build the same file the way the port
    builds its own (a temporary name renamed into place) and load again."""
    if not jnative.available():
        import subprocess

        tmp = f"{jnative._SO}.tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", jnative._SRC,
                        "-o", tmp, "-lz", "-lpthread"], check=True, capture_output=True)
        os.replace(tmp, jnative._SO)
        jnative.load_library.cache_clear()
    assert jnative.available()


# ------------------------------------------------------------------ native
def test_native_entry_points_match_jax_binding(tmp_path):
    """Every entry point of the port's binding against the JAX binding of the
    same source, byte for byte."""
    assert tnative.available() and jnative.available()
    rng = np.random.default_rng(0)
    masks = rng.random((5, 777)) < 0.3
    rles = [jrle.rle_encode(m) for m in masks]
    np.testing.assert_array_equal(tnative.rle_decode_batch_native(rles),
                                  jnative.rle_decode_batch_native(rles))
    for m in masks:
        t, j = tnative.rle_encode_native(m), jnative.rle_encode_native(m)
        assert t["length"] == j["length"] and np.array_equal(t["counts"], j["counts"])
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], smooth_depth(60, 80, seed=i))
    for hw in ((60, 80), (90, 100)):
        np.testing.assert_array_equal(tnative.decode_depth_native(paths[0], 1000.0, hw),
                                      jnative.decode_depth_native(paths[0], 1000.0, hw))
        np.testing.assert_array_equal(
            tnative.decode_depth_batch_native(paths, 1000.0, hw, n_threads=2),
            jnative.decode_depth_batch_native(paths, 1000.0, hw, n_threads=2))
    blob = jpeg(structured(97, 131), 90)
    t, j = tnative.jpeg_coeffs_native(blob), jnative.jpeg_coeffs_native(blob)
    assert t["hw"] == j["hw"] and len(t["comps"]) == len(j["comps"]) == 3
    for a, b in zip(t["comps"], j["comps"]):
        assert a["samp"] == b["samp"] and a["grid"] == b["grid"]
        assert np.array_equal(a["coeffs"], b["coeffs"]) and np.array_equal(a["qtab"], b["qtab"])
    flat = np.concatenate([c["coeffs"].reshape(-1) for c in t["comps"]])
    ts, js = tnative.jxt_scan_native(flat), jnative.jxt_scan_native(flat)
    assert ts[:2] == js[:2]
    for a, b in zip(ts[2:], js[2:]):
        np.testing.assert_array_equal(a[:ts[0]] if a.size > ts[0] else a,
                                      b[:js[0]] if b.size > js[0] else b)
    depth = smooth_depth(67, 96, seed=4).reshape(-1)
    depth = np.concatenate([depth, np.full((-depth.size) % 64, depth[-1], np.uint16)])
    for a, b in zip(tnative.depth_pack_native(depth), jnative.depth_pack_native(depth)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tnative.jpeg_coeffs_native(b"not a jpeg") is None


def test_rle_and_load_depth_match_jax_bytes(tmp_path, monkeypatch):
    """``rle_decode_batch`` and ``load_depth`` through the runtime and under
    ``BFF_NO_NATIVE`` give the JAX package's bytes."""
    rng = np.random.default_rng(1)
    rles = [jrle.rle_encode(m) for m in rng.random((4, 500)) < 0.4]
    path = str(tmp_path / "d.png")
    cv2.imwrite(path, smooth_depth(60, 80))
    for no_native in ("", "1"):
        monkeypatch.setenv("BFF_NO_NATIVE", no_native)
        jnative.load_library.cache_clear()  # the JAX binding caches its choice
        try:
            np.testing.assert_array_equal(trle.rle_decode_batch(rles), jrle.rle_decode_batch(rles))
            for size in (None, (100, 90)):
                t, j = tio.load_depth(path, 1000.0, size), jio.load_depth(path, 1000.0, size)
                assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
        finally:
            jnative.load_library.cache_clear()
    monkeypatch.delenv("BFF_NO_NATIVE")
    assert tnative.load_library() is not None
    monkeypatch.setenv("BFF_NO_NATIVE", "1")
    assert tnative.load_library() is None and tjxt.parse_file(jpeg(structured(32, 32))) is None


def _build_in(build_dir):
    """A spawned child: build the runtime into ``build_dir`` and load it."""
    from beyondff_tpu_torch.utils import native

    native.BUILD_DIR = build_dir
    lib = native.load_library()
    return native.library_path(), lib.bff_rle_encode is not None


def test_native_builds_in_parallel_processes(tmp_path):
    """Four processes building at once into an empty directory all load the
    library; one file is left, and no temporary ones."""
    build = str(tmp_path / "build")
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        out = pool.map(_build_in, [build] * 4)
    assert all(ok for _p, ok in out) and len({p for p, _ok in out}) == 1
    assert os.listdir(build) == [os.path.basename(out[0][0])]


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails raises with its output; nothing falls back."""
    fake = tmp_path / "bin" / "g++"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'fake compiler: no such target' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}:{os.environ['PATH']}")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    tnative._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="fake compiler: no such target"):
            tnative.load_library()
        with pytest.raises(RuntimeError):
            trle.rle_decode_batch([{"length": 4, "counts": np.array([1, 2])}])
    finally:
        tnative._library.cache_clear()


# ------------------------------------------------------------------ YCrCb
@pytest.mark.parametrize("hw", [(48, 64), (31, 47), (242, 324)])
def test_ycrcb_pack_bytes_and_unpack_match_jax(hw):
    rng = np.random.default_rng(hw[0])
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8), structured(*hw, seed=1)]
    for img in imgs:
        np.testing.assert_array_equal(tcolor.pack_ycrcb420(img), jcolor.pack_ycrcb420(img))
    got = tcolor.upload_frames(imgs, CPU).numpy()
    _levels_close(got, np.asarray(jcolor.upload_frames(imgs)))
    assert np.abs(got[1].astype(int) - tcolor.roundtrip_host(imgs[1]).astype(int)).max() <= 1
    np.testing.assert_array_equal(tcolor.upload_frames(imgs, CPU, yuv=False).numpy(),
                                  np.stack(imgs))
    assert tcolor.wire_bytes(*hw) == tcolor.pack_ycrcb420(imgs[0]).size


# ------------------------------------------------------------------ JXT
@pytest.mark.parametrize("name", ["420_q90", "420_odd_q95", "444", "gray"])
def test_jxt_wire_bytes_and_decode_match_jax(name):
    blob = jxt_cases()[name]
    t, j = tjxt.pack_file(blob), jjxt.pack_file(blob)
    assert t is not None and j is not None
    assert (t.geometry.h, t.geometry.w, t.geometry.comps) == \
        (j.geometry.h, j.geometry.w, j.geometry.comps)
    assert (t.ncap, t.ecap) == (j.ncap, j.ecap) and t.wire.tobytes() == j.wire.tobytes()
    np.testing.assert_array_equal(t.qsteps, j.qsteps)
    got = tjxt.upload_frame(t, CPU).numpy()
    _levels_close(got, np.asarray(jjxt.upload_frame(j)))
    assert np.abs(got.astype(int) - tjxt.roundtrip_host(blob).astype(int)).max() <= 1
    ref = cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]
    assert np.abs(got.astype(int) - ref).max() <= 6  # the file, libjpeg's integer IDCT
    for hw in ((48, 64), (130, 170)):
        _levels_close(tjxt.resize_frame(torch.from_numpy(got), hw).numpy(),
                      np.asarray(jjxt.resize_frame(jnp.asarray(got), hw)))


def test_jxt_noise_spills_and_mixed_batches_match_jax():
    """Noise spills in both; one ``upload_frames`` over mixed quality tables
    (per-frame steps) and over mixed geometries (per-frame decode), and a
    rebucketed batch, against the JAX package's."""
    noise = np.random.default_rng(0).integers(0, 255, (96, 128, 3), np.uint8)
    assert tjxt.pack_file(jpeg(noise, 95)) is None and jjxt.pack_file(jpeg(noise, 95)) is None
    img = structured(96, 128, seed=7)
    for blobs in ([jpeg(img, 80), jpeg(img, 95), jpeg(structured(96, 128, seed=8), 90)],
                  [jpeg(img, 90), jxt_cases()["444"], jxt_cases()["gray"]]):
        tp = [tjxt.pack_file(b) for b in blobs]
        jp = [jjxt.pack_file(b) for b in blobs]
        assert [p.wire.tobytes() for p in tp] == [p.wire.tobytes() for p in jp]
        got = tjxt.upload_frames(tp, CPU).numpy()
        _levels_close(got, np.asarray(jjxt.upload_frames(jp)))
        for g, p in zip(got, tp):
            np.testing.assert_array_equal(g, tjxt.upload_frame(p, CPU).numpy())
    big = tjxt.rebucket(tp[0], tp[0].ncap * 2, tp[0].ecap * 2)
    assert big.wire.tobytes() == jjxt.rebucket(jp[0], jp[0].ncap * 2, jp[0].ecap * 2).wire.tobytes()
    np.testing.assert_array_equal(tjxt.upload_frame(big, CPU).numpy(),
                                  tjxt.upload_frame(tp[0], CPU).numpy())
    assert tjxt.wire_bytes(tp[:1]) == tp[0].nbytes


# ------------------------------------------------------------------ depth-pack
@pytest.mark.parametrize("name", ["smooth", "odd_size", "edges_escapes", "constant", "gradient"])
def test_depth_pack_wire_and_exact_decode_match_jax(name):
    depth = depth_cases()[name]
    t, j = tdpack.pack(depth), jdpack.pack(depth)
    assert t is not None and j is not None
    assert (t.hw, t.scap, t.ecap) == (j.hw, j.scap, j.ecap) and t.wire.tobytes() == j.wire.tobytes()
    got = tdpack.upload_frame(t, CPU)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy().view(np.uint16), depth)
    np.testing.assert_array_equal(tdpack.roundtrip_host(t), depth)
    if name == "edges_escapes":
        assert tdpack._pack_arrays(np.ascontiguousarray(depth.reshape(-1)))[4].size > 0


def test_depth_pack_batches_spills_and_numpy_packer(monkeypatch):
    frames = [smooth_depth(120, 160, seed=s) for s in range(3)]
    packs = [tdpack.pack(f) for f in frames]
    assert len({(p.scap, p.ecap) for p in packs}) > 1  # rebucketed into one batch
    np.testing.assert_array_equal(tdpack.upload_frames(packs, CPU).numpy().view(np.uint16),
                                  np.stack(frames))
    big = tdpack.rebucket(packs[0], packs[0].scap * 2, packs[0].ecap * 2)
    assert big.wire.tobytes() == jdpack.rebucket(jdpack.pack(frames[0]), big.scap,
                                                 big.ecap).wire.tobytes()
    noise = np.random.default_rng(0).integers(0, 65535, (64, 96)).astype(np.uint16)
    assert tdpack.pack(noise) is None and jdpack.pack(noise) is None
    assert tdpack.estimate_wire_ratio(noise.reshape(-1)) == \
        jdpack.estimate_wire_ratio(noise.reshape(-1))
    with pytest.raises(ValueError):
        tdpack.upload_frames([packs[0], tdpack.pack(smooth_depth(64, 96))], CPU)
    monkeypatch.setenv("BFF_NO_NATIVE", "1")
    for f in frames + [depth_cases()["edges_escapes"]]:
        assert tdpack.pack(f).wire.tobytes() == jdpack.pack(f).wire.tobytes()
    assert tdpack.pack_cached(frames[0]) is tdpack.pack_cached(frames[0].copy())


# ------------------------------------------------------------------ crops, CLIP
@pytest.mark.parametrize("mode", ["yolo", "gdino"])
def test_clip_crop_batch_matches_jax(mode):
    frames, frame_of, boxes, valid, frame_hw = crop_inputs(np.random.default_rng(0))
    kw = dict(det_hw=(80, 100), mean=IMAGE_MEAN, std=IMAGE_STD) if mode == "gdino" else {}
    jfn = jax.jit(lambda f, b, v: jcrop.clip_crop_batch(f, b, v, mode, frame_hw, n=56, **kw))
    want = np.asarray(jfn(jnp.asarray(frames[frame_of]), jnp.asarray(boxes), jnp.asarray(valid)))
    got = tcrop.clip_crop_batch(torch.from_numpy(frames), frame_of, boxes, valid, mode, frame_hw,
                                n=56, **kw).numpy()
    assert (got[~valid] == 0).all() and got.max() > 200
    _levels_close(got, want)
    per_mode = tcrop.clip_crop_yolo if mode == "yolo" else tcrop.clip_crop_gdino
    np.testing.assert_array_equal(per_mode(torch.from_numpy(frames), frame_of, boxes, valid,
                                           frame_hw, *kw.values(), n=56).numpy(), got)


@pytest.fixture(scope="module")
def clips():
    jm = jclip.CLIP.create("test", seed=4)
    module = tlayers.build(lambda: tclip.CLIPModule(jm.cfg), CPU)
    module.load_state_dict(convert.clip_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                                 jm.cfg))
    return jm, tclip.CLIP(jm.cfg, module)


@pytest.mark.parametrize("mode", ["yolo", "gdino"])
def test_encode_image_boxes_matches_jax(clips, mode):
    """Device crops through CLIP, crop counts padded to a power of two (5
    boxes -> 8 rows, the padding zero crops)."""
    jm, tm = clips
    frames, frame_of, boxes, _valid, frame_hw = crop_inputs(np.random.default_rng(2), k=5)
    kw = dict(det_hw=(80, 100), det_mean=IMAGE_MEAN, det_std=IMAGE_STD) if mode == "gdino" else {}
    jf, jn = jm.encode_image_boxes(jnp.asarray(frames), frame_of, boxes, mode, frame_hw, **kw)
    tf, tn = tm.encode_image_boxes(torch.from_numpy(frames), frame_of, boxes, mode, frame_hw, **kw)
    assert tn == jn == 5 and tf.shape[0] == np.asarray(jf).shape[0] == 8
    # one crop value a level apart (measured) moves a feature by ~1e-4
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4, rtol=0)


def test_encode_image_packed_yuv_matches_jax(clips):
    jm, tm = clips
    n = jm.cfg.image_resolution
    crops = np.random.default_rng(3).integers(0, 256, (3, n, n, 3), dtype=np.uint8)
    packed = np.stack([tcolor.pack_ycrcb420(c) for c in crops])
    want = np.asarray(jm.encode_image_packed_yuv(packed))
    np.testing.assert_allclose(tm.encode_image_packed_yuv(packed).numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.encode_image(tcolor.upload_frames(list(crops), CPU)).numpy(),
                               want, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ the stages
def _carry(make, params, fn, cfg):
    module = tlayers.build(make, CPU)
    module.load_state_dict(fn(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module


def _port_segmentor(jseg, cfg):
    """The port's Segmentor2D on the JAX segmentor's weights."""
    ccfg = jseg.clip.cfg
    clip = tclip.CLIP(ccfg, _carry(lambda: tclip.CLIPModule(ccfg), jseg.clip.params,
                                   convert.clip_from_jax, ccfg))
    dcfg, scfg = jseg.detector.cfg, jseg.sam.cfg
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
    """Non-degenerate seeded YOLO-World variables (random-init boxes are
    otherwise all alike)."""
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


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """``make_synthetic_scene``'s scene (6 frames of noise JPEGs at 242x324,
    rendered depth PNGs; every other frame through the stage), a copy whose
    frames are natural-like JPEGs (the second of each pair noise, so batches
    mix JXT and spilled frames), and JAX segmentors for both detectors with
    the port's copies."""
    root = str(tmp_path_factory.mktemp("transports") / "root")
    cfg_path = make_synthetic_scene.generate(root, query="towel", seed=2)
    raw = yaml.safe_load(open(cfg_path))
    raw["frames"]["downsample_ratio"] = 2
    raw["detector"].update({"box_threshold": 0.0, "must_match_query": False,
                            "similarity_threshold": -10.0, "max_detections": 4,
                            "dtype": "float32", "frame_batch": 2, "fused_group": 8})
    scenes = raw["paths"]["scene_2d_dir"]
    natural = os.path.join(root, "natural_2d")
    shutil.copytree(scenes, natural)
    color = os.path.join(natural, "scene0000_00", "color")
    for i in range(6):
        img = structured(242, 324, seed=10 + i)
        if i == 2:
            img = np.random.default_rng(i).integers(0, 255, img.shape, dtype=np.uint8)
        cv2.imwrite(os.path.join(color, f"{i}.jpg"), img[..., ::-1],
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
    out = {"root": root, "raw": raw, "natural": natural}
    for kind in ("grounding_dino", "yolo_world"):
        r = {**raw, "detector": {**raw["detector"], "kind": kind}}
        jseg = jseg2d.Segmentor2D(JConfig.from_dict(r))
        if kind == "yolo_world":
            jseg.detector.params = _spread(jseg.detector.params, 9)
        out[kind] = (jseg, _port_segmentor(jseg, TConfig.from_dict(r)))
    return out


def _configs(stage, kind, tag, natural=False, **detector):
    raw = stage["raw"]
    out = {}
    for side, cls in (("jax", JConfig), ("torch", TConfig)):
        paths = {**raw["paths"],
                 "mask_2d_dir": os.path.join(stage["root"], f"m2d_{tag}_{side}"),
                 "checkpoint_dir": os.path.join(stage["root"], f"ck_{tag}_{side}")}
        if natural:
            paths["scene_2d_dir"] = stage["natural"]
        out[side] = cls.from_dict({**raw, "paths": paths,
                                   "detector": {**raw["detector"], "kind": kind, **detector}})
    return out["jax"], out["torch"]


def _iou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


def _assert_records_close(cfgs, classes):
    n = 0
    for c in classes:
        got, want = (jio.load_frame_records(os.path.join(cfg.paths.mask_2d_dir, c,
                                                         "scene0000_00.pth"))
                     for cfg in (cfgs[1], cfgs[0]))
        assert [r["frame_id"] for r in got] == [r["frame_id"] for r in want]
        for t, j in zip(got, want):
            assert list(t["labels"]) == list(j["labels"])
            np.testing.assert_allclose(t["confidences"], j["confidences"], atol=1e-4, rtol=0)
            for a, b in zip(trle.rle_decode_batch(t["segmented_frame_masks"]).astype(bool),
                            trle.rle_decode_batch(j["segmented_frame_masks"]).astype(bool)):
                assert _iou(a, b) >= 0.999
                n += 1
    assert n > 0
    return n


def _run_both(stage, kind, cfgs, cls="towel"):
    jseg, tseg = stage[kind]
    tseg.upload_stats.clear()
    for seg, mod, cfg in ((jseg, jseg2d, cfgs[0]), (tseg, tseg2d, cfgs[1])):
        old, seg.cfg = seg.cfg, cfg
        try:
            res = mod.run(cfg, cls, scenes=["scene0000_00"], segmentor=seg)
        finally:
            seg.cfg = old
        assert res[0]["frames_with_boxes"] == 3
    _assert_records_close(cfgs, [cls])
    return dict(tseg.upload_stats)


@pytest.mark.parametrize("kind", ["grounding_dino", "yolo_world"])
@pytest.mark.parametrize("frames", ["noise", "natural"])
def test_run_matches_jax_with_no_switch_set(stage, no_switches, kind, frames):
    """``run()`` with both packages on their defaults: Grounding-DINO takes
    YCrCb frames and host crops; YOLO-World adds device crops and JXT,
    which the noise frames spill and the natural ones take."""
    stats = _run_both(stage, kind, _configs(stage, kind, f"run_{kind}_{frames}",
                                            natural=frames == "natural"))
    assert stats.get("rgb", 0) == 0 and stats["bytes"] > 0
    if kind == "yolo_world":
        assert stats.get("jxt", 0) == (2 if frames == "natural" else 0)
        assert stats["jxt_spill"] == (1 if frames == "natural" else 3)
    else:
        assert stats["ycrcb"] == 3 and "jxt" not in stats


def test_run_two_tier_batched_jxt_matches_jax(stage, no_switches):
    """Two-tier forced on (the full-width default): detector-scale buffers,
    one copy per batch, a batch with a spilled frame goes YCrCb whole, and
    hit frames derive their SAM-scale buffers from the JXT upload."""
    no_switches.setenv("BFF_SEG2D_TWO_TIER", "1")
    stats = _run_both(stage, "yolo_world", _configs(stage, "yolo_world", "two_tier",
                                                    natural=True))
    # frames 0 and 2 share a batch and 2 spills, so both go YCrCb; frame 4
    # takes JXT. SAM scale: 4 from its native frame, 0 re-packed, 2 YCrCb
    assert stats["jxt"] == 2 and stats["jxt_spill"] == 3 and stats["ycrcb"] == 3


def test_run_without_native_runtime_matches_jax(stage, no_switches):
    """``BFF_NO_NATIVE=1``: neither package parses the JPEG files, so every
    frame spills JXT to YCrCb, and the records still agree."""
    no_switches.setenv("BFF_NO_NATIVE", "1")
    jnative.load_library.cache_clear()  # the JAX binding caches its choice
    try:
        stats = _run_both(stage, "yolo_world", _configs(stage, "yolo_world", "no_native",
                                                        natural=True))
    finally:
        jnative.load_library.cache_clear()
    assert "jxt" not in stats and stats["jxt_spill"] == 3 and stats["ycrcb"] == 3


def test_forced_jxt_on_grounding_dino_matches_jax(stage, no_switches, capsys):
    """``BFF_SEG2D_JXT=1``: without device crops it warns and changes
    nothing; with ``BFF_CLIP_DEVICE_CROPS=1`` Grounding-DINO takes JXT."""
    no_switches.setenv("BFF_SEG2D_JXT", "1")
    monkey = no_switches
    monkey.setattr(tseg2d.Segmentor2D, "_jxt_forced_warned", False)
    monkey.setattr(jseg2d.Segmentor2D, "_jxt_forced_warned", False, raising=False)
    stats = _run_both(stage, "grounding_dino", _configs(stage, "grounding_dino", "jxt_warn",
                                                        natural=True))
    assert "jxt" not in stats and "BFF_SEG2D_JXT=1 has no effect" in capsys.readouterr().out
    monkey.setenv("BFF_CLIP_DEVICE_CROPS", "1")
    stats = _run_both(stage, "grounding_dino", _configs(stage, "grounding_dino", "jxt_forced",
                                                        natural=True))
    assert stats["jxt"] == 2 and stats["jxt_spill"] == 1


def test_run_classes_fused_matches_jax_with_no_switch_set(stage, no_switches):
    """Fused captions (replays take device crops on auto) for both
    detectors, with the frame bank's transport keys."""
    for kind in ("grounding_dino", "yolo_world"):
        cfgs = _configs(stage, kind, f"fused_{kind}", natural=True, fused_captions=True)
        jseg, tseg = stage[kind]
        for seg, mod, cfg in ((jseg, jseg2d, cfgs[0]), (tseg, tseg2d, cfgs[1])):
            old, seg.cfg = seg.cfg, cfg
            try:
                res = mod.run_classes(cfg, ["towel", "clothes"], segmentor=seg)
            finally:
                seg.cfg = old
            assert all(res[c] for c in ("towel", "clothes"))
        _assert_records_close(cfgs, ["towel", "clothes"])


@pytest.mark.parametrize("dpack", [None, "0"])
def test_projection_matches_jax_with_depth_pack(stage, no_switches, dpack):
    """``projection.run`` on the scene's 2D records and depth PNGs, both
    packages with no switch set (depth-pack on) and with
    ``BFF_DEPTH_PACK=0``: equal outputs, and the port's depth crossed packed
    exactly when the switch is on."""
    if dpack is not None:
        no_switches.setenv("BFF_DEPTH_PACK", dpack)
    raw = stage["raw"]
    calls = []
    real = tdpack.upload_frame
    no_switches.setattr(tdpack, "upload_frame", lambda *a: calls.append(1) or real(*a))
    outs = {}
    for side, cls, mod in (("jax", JConfig, jprojection), ("torch", TConfig, tprojection)):
        tag = f"{side}_{dpack}"
        cfg = cls.from_dict({**raw, "paths": {
            **raw["paths"], "mask_3d_dir": os.path.join(stage["root"], f"m3d_{tag}"),
            "checkpoint_dir": os.path.join(stage["root"], f"ck3_{tag}")}})
        kw = {"device": CPU} if side == "torch" else {}
        outs[side] = (mod.run(cfg, "towel", resume=False, **kw), jio.load_stage_dict(
            os.path.join(cfg.paths.mask_3d_dir, "towel", "scene0000_00.pth")))
    assert outs["torch"][0] == outs["jax"][0]
    for key in ("ins", "conf"):
        np.testing.assert_array_equal(outs["torch"][1][key], outs["jax"][1][key])
    assert list(outs["torch"][1]["final_class"]) == list(outs["jax"][1]["final_class"])
    assert outs["torch"][1]["ins"].shape[0] > 0
    assert (len(calls) > 0) == (dpack is None)


# ------------------------------------------------------------ frame prefetch
def _inline_loads(fn, items, depth=2, workers=1):
    """``prefetch_map`` with the prefetch off: each batch loads in the scene
    loop's own thread when the loop asks for it."""
    return (fn(x) for x in items)


@pytest.mark.parametrize("kind,two_tier", [("grounding_dino", None), ("yolo_world", "1")])
def test_prefetch_records_byte_equal_and_match_jax(stage, no_switches, kind, two_tier):
    """The prefetch off (``prefetch_map`` replaced by in-order loads in the
    scene loop's thread), then ``BFF_SEG2D_WORKERS`` 1 and 4 with
    ``BFF_SEG2D_PREFETCH`` at its default and at one frame: the port's
    ``.pth`` bytes are equal across all four, and its records agree with
    the JAX package's (both on their defaults; YOLO-World two-tier with
    JXT, so each loaded batch keeps its own native frames) at the seg2d
    bars."""
    if two_tier:
        no_switches.setenv("BFF_SEG2D_TWO_TIER", two_tier)
    runs = {}
    for workers, depth in (("off", None), ("1", None), ("4", None), ("4", "1")):
        if depth:
            no_switches.setenv("BFF_SEG2D_PREFETCH", depth)
        tag = f"prefetch_{kind}_{workers}_{depth}"
        cfgs = _configs(stage, kind, tag, natural=True)
        with pytest.MonkeyPatch.context() as mp:
            if workers == "off":
                mp.setattr(tseg2d, "prefetch_map", _inline_loads)
            else:
                mp.setenv("BFF_SEG2D_WORKERS", workers)
            if workers == "1" and depth is None:
                _run_both(stage, kind, cfgs)
            else:
                _jseg, tseg = stage[kind]
                old, tseg.cfg = tseg.cfg, cfgs[1]
                try:
                    tseg2d.run(cfgs[1], "towel", scenes=["scene0000_00"], segmentor=tseg)
                finally:
                    tseg.cfg = old
        with open(os.path.join(cfgs[1].paths.mask_2d_dir, "towel", "scene0000_00.pth"),
                  "rb") as f:
            runs[(workers, depth)] = f.read()
    first = runs[("off", None)]
    assert all(b == first for b in runs.values())


def test_seg2d_trace_phases_match_jax(stage, no_switches, capsys):
    """``BFF_SEG2D_TRACE=1``: one line per scene in the JAX package's
    format; the port's phases are the JAX package's names (the two-tier
    fast variant's run reaches all but the deferred-flush ones)."""
    no_switches.setenv("BFF_SEG2D_TRACE", "1")
    no_switches.setenv("BFF_SEG2D_TWO_TIER", "1")
    _run_both(stage, "yolo_world", _configs(stage, "yolo_world", "trace", natural=True))
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("# seg2d host trace [scene0000_00]")]
    assert len(lines) == 2  # the JAX package's, then the port's

    def phases(line):
        head, _, body = line.partition("frames): ")
        assert "total=" in head and "(3 frames)" in line
        return {kv.split("=")[0] for kv in body.split()}

    jax_phases, port_phases = phases(lines[0]), phases(lines[1])
    assert port_phases <= jax_phases | {"crop_build", "clip_dispatch", "clip_wait"}
    assert {"prefetch_wait", "det_dispatch", "det_finalize", "phrase_filter",
            "sam_encode_dispatch", "sam_upload", "crop_build", "clip_dispatch",
            "clip_wait", "filter_apply", "decode_dispatch", "decode_wait",
            "emit"} == port_phases
    assert port_phases <= jax_phases
