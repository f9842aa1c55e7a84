"""The port's visualization exports and the two CLIs that use them against
the JAX package's, on the same inputs.

Every case of tests/test_visualization.py, run on both packages: the PLY,
PNG, label and HTML files must be byte-equal (no tolerance: both write from
the same numpy arrays through the same numpy, OpenCV and matplotlib calls).
Then ``single_scene`` on the synthetic scene with ``--device cpu``: with
``--skip-seg2d`` on the scene's own 2D masks both CLIs write byte-equal PLYs
(and PNG snapshots with ``--png``), and the port's extra outputs equal the
JAX package's ``frame_overlay`` and ``export_scene`` on the same stage files;
a full run (the port's random ``"test"`` models) completes with files that
parse.
"""

import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.utils import ply as jply
from beyondff_tpu.visualization import visualize as jviz
from beyondff_tpu.visualization import webviz as jweb
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.tools import make_synthetic_scene as tgen
from beyondff_tpu_torch.tools import single_scene as tsingle
from beyondff_tpu_torch.tools import visualize as tvis_cli
from beyondff_tpu_torch.utils import ply as tply
from beyondff_tpu_torch.visualization import visualize as tviz
from beyondff_tpu_torch.visualization import webviz as tweb

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = "scene0000_00"


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic scene (the port's generator) and its config in each
    package."""
    root = str(tmp_path_factory.mktemp("viz") / "scene")
    path = tgen.generate(root, query="clothes", seed=5)
    return root, path, JConfig.from_yaml(path), TConfig.from_yaml(path)


def test_colored_ply_round_trip_and_bytes(tmp_path):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(100, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (100, 3)).astype(np.uint8)
    tviz.write_colored_ply(str(tmp_path / "t" / "scene.ply"), xyz, rgb)
    jviz.write_colored_ply(str(tmp_path / "j" / "scene.ply"), xyz, rgb)
    assert _bytes(tmp_path / "t" / "scene.ply") == _bytes(tmp_path / "j" / "scene.ply")
    back_xyz, back_rgb = tply.read_point_cloud_with_colors(str(tmp_path / "t" / "scene.ply"))
    np.testing.assert_allclose(back_xyz, xyz, rtol=1e-6)
    np.testing.assert_allclose(back_rgb * 255, rgb, atol=0.5)


@pytest.mark.parametrize("n", [1, 10, 37])
def test_palette_distinct_and_equal(n):
    p = tviz._palette(n)
    assert p.shape == (n, 3) and len({tuple(c) for c in p}) == n
    np.testing.assert_array_equal(p, jviz._palette(n))
    np.testing.assert_array_equal(tviz._palette(n, seed=1), jviz._palette(n, seed=1))


def test_ply_vertex_reader_ascii(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\n"
        "property float x\nproperty float y\nproperty float z\nend_header\n"
        "1.0 2.0 3.0\n4.0 5.0 6.0\n")
    t, j = tply.read_ply_vertices(str(path)), jply.read_ply_vertices(str(path))
    np.testing.assert_allclose(t["x"], [1.0, 4.0])
    np.testing.assert_allclose(t["z"], [3.0, 6.0])
    assert set(t) == set(j) and all(np.array_equal(t[k], j[k]) for k in t)


def test_snapshot_png(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(200, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (200, 3)).astype(np.uint8)
    outs = []
    for mod, tag in ((tviz, "t"), (jviz, "j")):
        ply = str(tmp_path / tag / "scene.ply")
        mod.write_colored_ply(ply, xyz, rgb)
        viz = mod.SceneVisualizer.__new__(mod.SceneVisualizer)  # skip heavy init
        outs.append(viz.snapshot_png(ply))
    assert os.path.getsize(outs[0]) > 1000
    assert _bytes(outs[0]) == _bytes(outs[1])


def test_frame_overlay(tmp_path, scene):
    """The annotated 2D frame: masks blend into the RGB frame, boxes and
    labels drawn; the PNG bytes equal the JAX package's."""
    _root, _path, jcfg, tcfg = scene
    tpath = tviz.SceneVisualizer(tcfg, SCENE, out_dir=str(tmp_path / "t")).frame_overlay(
        "clothes")
    jpath = jviz.SceneVisualizer(jcfg, SCENE, out_dir=str(tmp_path / "j")).frame_overlay(
        "clothes")
    assert tpath.endswith("_2d.png") and os.path.basename(tpath) == os.path.basename(jpath)
    assert _bytes(tpath) == _bytes(jpath)
    out = cv2.imread(tpath)
    raw = cv2.imread(os.path.join(tcfg.paths.scene_2d_dir, SCENE, "color", "0.jpg"))
    assert out.shape == raw.shape and (out != raw).any()


@pytest.mark.parametrize("method", ["gt_instances", "stage1_masks", "lifted_2d_frame"])
def test_stage_plys_equal(tmp_path, scene, method):
    """The GT, stage-1 and lifted-2D-frame exports: PLY and label bytes."""
    _root, _path, jcfg, tcfg = scene
    args = ("clothes",) if method == "lifted_2d_frame" else ()
    tpath = getattr(tviz.SceneVisualizer(tcfg, SCENE, out_dir=str(tmp_path / "t")), method)(*args)
    jpath = getattr(jviz.SceneVisualizer(jcfg, SCENE, out_dir=str(tmp_path / "j")), method)(*args)
    assert os.path.basename(tpath) == os.path.basename(jpath)
    assert _bytes(tpath) == _bytes(jpath)
    assert _bytes(tpath[:-4] + "_labels.txt") == _bytes(jpath[:-4] + "_labels.txt")
    v = tply.read_ply_vertices(tpath)
    assert len(v["x"]) > 0 and (v["red"] != 160).any()  # some instance colored


def test_web_export(tmp_path, scene):
    """The self-contained viewer: byte-equal HTML with the RGB, GT and
    stage-1 layers, a GT legend, and no external resource."""
    _root, _path, jcfg, tcfg = scene
    path = tweb.export_scene(tcfg, SCENE, class_names=["clothes"],
                             out_dir=str(tmp_path / "t"), max_points=5000)
    jpath = jweb.export_scene(jcfg, SCENE, class_names=["clothes"],
                              out_dir=str(tmp_path / "j"), max_points=5000)
    assert _bytes(path) == _bytes(jpath)
    html = open(path).read()
    n = int(re.search(r"const N = (\d+);", html).group(1))
    assert 0 < n <= 5000
    layers = json.loads(re.search(r"const LAYERS = (\[.*?\]);", html, re.S).group(1))
    names = [layer["name"] for layer in layers]
    assert "gt instances" in names and "stage-1 masks" in names
    assert "http://" not in html and "https://" not in html


def test_web_scene_downsample_and_validation():
    rng = np.random.default_rng(2)
    xyz = rng.normal(size=(1000, 3)).astype(np.float32)
    scene = tweb.WebScene(xyz, max_points=100)
    assert scene.xyz.shape == (100, 3)
    np.testing.assert_array_equal(scene.xyz, jweb.WebScene(xyz, max_points=100).xyz)
    scene.add_layer("ok", np.zeros((1000, 3), np.uint8))  # pre-downsample length
    with pytest.raises(ValueError):
        scene.add_layer("bad", np.zeros((50, 3), np.uint8))


# ------------------------------------------------------------------- CLIs
def _jax_cli(monkeypatch, name, argv):
    """Run the JAX package's ``tools/<name>.py`` as its ``__main__``."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"), run_name="__main__")


def test_visualize_cli_matches_jax(tmp_path, scene, monkeypatch, capsys):
    _root, path, _jcfg, _tcfg = scene
    modes = "gt,stage1,mask2d,frame2d,web"
    argv = ["--config", path, "--scene", SCENE, "--cls", "clothes", "--modes", modes]
    _jax_cli(monkeypatch, "visualize", argv + ["--out", str(tmp_path / "j")])
    jout = capsys.readouterr().out
    tvis_cli.main(argv + ["--out", str(tmp_path / "t")])
    tout = capsys.readouterr().out
    assert tout.replace(str(tmp_path / "t"), "") == jout.replace(str(tmp_path / "j"), "")
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "t")
                   for d, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert len(files) >= 6
    for f in files:
        assert _bytes(tmp_path / "t" / f) == _bytes(tmp_path / "j" / f), f


def test_single_scene_matches_jax_cli(tmp_path, scene, monkeypatch):
    """``--skip-seg2d`` on the scene's 2D masks, both CLIs with the same
    ``--set`` overrides: the JAX CLI's PLYs and label files byte for byte;
    the port's 2D overlay and viewer equal the JAX package's functions on
    the same stage files."""
    root, path, jcfg, tcfg = scene
    for tag in ("j", "t"):
        d = tmp_path / tag
        cfg_path = str(d / "config.yaml")
        d.mkdir()
        raw = tcfg.to_dict()
        for key in ("mask_3d_dir", "final_output_dir", "checkpoint_dir"):
            raw["paths"][key] = str(d / key)
        TConfig.from_dict(raw).to_yaml(cfg_path)
        argv = ["--config", cfg_path, "--cls", "clothes", "--scene", SCENE, "--skip-seg2d",
                "--set", "refinement.iou_thres=0.5", "--out", str(d / "viz")]
        if tag == "j":
            _jax_cli(monkeypatch, "single_scene", argv)
        else:
            tsingle.main(argv + ["--device", "cpu"])
    for name in ("mask3d_clothes", "refined_clothes"):
        for ext in (".ply", "_labels.txt"):
            f = os.path.join("viz", SCENE, name + ext)
            assert _bytes(tmp_path / "t" / f) == _bytes(tmp_path / "j" / f), f
    jc = JConfig.from_yaml(str(tmp_path / "j" / "config.yaml"))
    jdir = str(tmp_path / "j" / "viz")
    overlay = jviz.SceneVisualizer(jc, SCENE, out_dir=jdir).frame_overlay("clothes")
    assert _bytes(tmp_path / "t" / "viz" / os.path.basename(overlay)) == _bytes(overlay)
    html = jweb.export_scene(jc, SCENE, class_names=["clothes"], out_dir=jdir)
    assert _bytes(tmp_path / "t" / "viz" / SCENE / "web" / "index.html") == _bytes(html)


def test_single_scene_full_run_on_cpu(tmp_path):
    """The whole loop with the 2D stage (the ``"test"`` models, random
    weights, thresholds at their floor) on a scene of its own: it completes,
    and its PLYs, 2D overlay and viewer parse."""
    root = str(tmp_path / "scene")
    path = tgen.generate(root, query="clothes", seed=9)
    out = str(tmp_path / "viz")
    tsingle.main(["--config", path, "--cls", "clothes", "--scene", SCENE, "--device", "cpu",
                  "--set", "detector.box_threshold=0.0", "--set",
                  "detector.similarity_threshold=-1.0", "--set",
                  "detector.must_match_query=false", "--out", out])
    n_points = len(np.load(os.path.join(root, "Scannet200_3D", "original_npy_files",
                                        f"{SCENE}.npy")))
    for name in ("mask3d_clothes", "refined_clothes"):
        v = tply.read_ply_vertices(os.path.join(out, SCENE, f"{name}.ply"))
        assert len(v["x"]) == n_points
    overlay = cv2.imread(os.path.join(out, f"{SCENE}_clothes_f0_2d.png"))
    assert overlay is not None and overlay.shape == (242, 324, 3)
    html = open(os.path.join(out, SCENE, "web", "index.html")).read()
    assert json.loads(re.search(r"const LAYERS = (\[.*?\]);", html, re.S).group(1))
