"""The port's host-side leftovers vs the JAX package's: the chat-completions
client and the ``gpt`` descriptor backends (against a local HTTP server on
the loopback address), the ScanNet benchmark export, the PLY reader, and
the ``ply2npy``, class-agnostic evaluation, results aggregation and
checkpoint-reset CLIs, each run by both packages on the same inputs."""

import http.server
import json
import os
import runpy
import shutil
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.eval import benchmark_format as jbench
from beyondff_tpu.pipeline import descriptors as jdesc
from beyondff_tpu.pipeline import llm_client as jllm
from beyondff_tpu.pipeline import segmentation_2d as jseg2d
from beyondff_tpu.utils import ply as jply
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.eval import benchmark_format as tbench
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.pipeline import descriptors as tdesc
from beyondff_tpu_torch.pipeline import llm_client as tllm
from beyondff_tpu_torch.pipeline import projection as tprojection
from beyondff_tpu_torch.pipeline import refinement as trefinement
from beyondff_tpu_torch.pipeline import segmentation_2d as tseg2d
from beyondff_tpu_torch.tools import aggregate_results as tagg
from beyondff_tpu_torch.tools import clear_checkpoints as tclear
from beyondff_tpu_torch.tools import eval_class_agnostic as tagnostic
from beyondff_tpu_torch.tools import ply2npy as tply2npy
from beyondff_tpu_torch.utils import ply as tply

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPLETION = "- four legs\n- a cushioned seat\nnot a bullet\n- a backrest"


class _ChatServer:
    """An OpenAI-compatible ``/v1/chat/completions`` endpoint on the
    loopback address that records each request and answers with
    :data:`COMPLETION`, in the ``message.content`` or the legacy ``text``
    field."""

    def __init__(self, legacy=False):
        self.requests = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                outer.requests.append({"path": self.path, "body": body,
                                       "auth": self.headers.get("Authorization")})
                choice = {"text": COMPLETION} if legacy else \
                    {"message": {"role": "assistant", "content": COMPLETION}}
                data = json.dumps({"choices": [choice]}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.httpd = http.server.HTTPServer(("127.0.0.1", 0), Handler)
        self.endpoint = f"http://127.0.0.1:{self.httpd.server_address[1]}/v1"

    def __enter__(self):
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.mark.parametrize("legacy", [False, True], ids=["message", "text"])
def test_chat_client_sends_and_parses_like_jax(monkeypatch, legacy):
    monkeypatch.setenv("OPENAI_API_KEY", "sk-test-123")
    with _ChatServer(legacy) as srv:
        got = tllm.ChatCompletionClient(srv.endpoint)("Q: chair?")
        want = jllm.ChatCompletionClient(srv.endpoint)("Q: chair?")
    assert got == want == COMPLETION
    assert srv.requests[0] == srv.requests[1]
    req = srv.requests[0]
    assert req["path"] == "/v1/chat/completions" and req["auth"] == "Bearer sk-test-123"
    assert req["body"] == {"model": "gpt-3.5-turbo", "temperature": 0.5, "max_tokens": 100,
                           "messages": [{"role": "user", "content": "Q: chair?"}]}


@pytest.mark.parametrize("method", ["gpt", "waffle_and_gpt"])
def test_gpt_descriptors_match_jax(method):
    cfg = {"detector": {"llm_model": "llama-3-8b", "descriptor_generator": method}}
    assert tllm.from_config(TConfig.from_dict(cfg).detector) is None
    with _ChatServer() as srv:
        cfg["detector"]["llm_endpoint"] = srv.endpoint
        tclient = tllm.from_config(TConfig.from_dict(cfg).detector)
        jclient = jllm.from_config(JConfig.from_dict(cfg).detector)
        got = tdesc.generate("chair", method, seed=3, llm=tclient)
        want = jdesc.generate("chair", method, seed=3, llm=jclient)
    assert got == want
    assert got["chair"][:3] == ["A photo of a chair, which has four legs.",
                                "A photo of a chair, which is a cushioned seat.",
                                "A photo of a chair, which is a backrest."]
    assert len(got["chair"]) == 3 + (30 if method == "waffle_and_gpt" else 0)
    assert srv.requests[0]["body"]["model"] == "llama-3-8b"
    with pytest.raises(ValueError, match="llm"):
        tdesc.generate("chair", method)


def test_stage_query_embedding_with_gpt_descriptors_matches_jax(monkeypatch):
    """``Segmentor2D.query_embedding`` with ``descriptor_generator: gpt``
    asks the configured endpoint, as the JAX stage does, and averages the
    same CLIP text embeddings."""
    monkeypatch.setenv("BFF_SEG2D_YUV", "0")
    with _ChatServer() as srv:
        d = {"detector": {"descriptor_generator": "gpt", "llm_endpoint": srv.endpoint,
                          "dtype": "float32"}}
        jseg = jseg2d.Segmentor2D(JConfig.from_dict(d))
        module = tlayers.build(lambda: tclip.CLIPModule(jseg.clip.cfg), torch.device("cpu"))
        module.load_state_dict(convert.clip_from_jax(
            jax.tree_util.tree_map(np.asarray, jseg.clip.params), jseg.clip.cfg))
        tseg = tseg2d.Segmentor2D(TConfig.from_dict(d), device="cpu",
                                  clip_model=tclip.CLIP(jseg.clip.cfg, module))
        want = jseg.query_embedding("chair")
        got = tseg.query_embedding("chair")
    assert len(srv.requests) == 2
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------- benchmark format
def test_benchmark_export_is_byte_equal_and_reads_back(tmp_path, rng):
    masks = rng.random((4, 500)) < 0.3
    labels = [3, 5, 5, 1169]
    confs = [0.91, 0.5, 0.123456789, 1.0]
    for side, mod in (("jax", jbench), ("torch", tbench)):
        mod.export_instances(str(tmp_path / side / "scene0011_00.txt"), masks, labels, confs)
        mod.export_ids(str(tmp_path / side / "ids.txt"), np.arange(7) * 3)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 2 + 4
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    got = tbench.read_instances(str(tmp_path / "torch" / "scene0011_00.txt"))
    want = jbench.read_instances(str(tmp_path / "torch" / "scene0011_00.txt"))
    np.testing.assert_equal(got, want)
    np.testing.assert_array_equal(got[2]["pred_mask"], masks[2].astype(np.uint8))
    np.testing.assert_array_equal(tbench.load_ids(str(tmp_path / "torch" / "ids.txt")),
                                  np.arange(7) * 3)
    (tmp_path / "bad.txt").write_text("pred_mask/x.txt 3\n")
    with pytest.raises(ValueError, match="malformed"):
        tbench.read_instances(str(tmp_path / "bad.txt"))


# ------------------------------------------------------------------- PLY
def _write_ply(path, fmt, xyz, rgb):
    props = [("x", "float", "<f4"), ("y", "float", "<f4"), ("z", "double", "<f8"),
             ("red", "uchar", "u1"), ("green", "uchar", "u1"), ("blue", "uchar", "u1")]
    header = (f"ply\nformat {fmt} 1.0\ncomment written by the test\n"
              f"element vertex {len(xyz)}\n"
              + "".join(f"property {t} {n}\n" for n, t, _ in props)
              + "element face 0\nproperty list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if fmt == "ascii":
            for p, c in zip(xyz, rgb):
                f.write((" ".join(f"{v:.6f}" for v in p) + " "
                         + " ".join(str(int(v)) for v in c) + "\n").encode())
        else:
            rows = np.zeros(len(xyz), np.dtype([(n, d) for n, _, d in props]))
            for i, n in enumerate("xyz"):
                rows[n] = xyz[:, i]
            for i, n in enumerate(("red", "green", "blue")):
                rows[n] = rgb[:, i]
            f.write(rows.tobytes())


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian"])
def test_ply_reader_matches_jax(tmp_path, rng, fmt):
    xyz = rng.normal(size=(50, 3)).round(4)
    rgb = rng.integers(0, 256, (50, 3))
    path = str(tmp_path / "scene.ply")
    _write_ply(path, fmt, xyz, rgb)
    np.testing.assert_equal(tply.read_ply_vertices(path), jply.read_ply_vertices(path))
    np.testing.assert_array_equal(tply.read_point_cloud(path), jply.read_point_cloud(path))
    got = tply.read_point_cloud_with_colors(path)
    want = jply.read_point_cloud_with_colors(path)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[0], xyz, atol=1e-4)
    np.testing.assert_allclose(got[1], rgb / 255.0)


def _jax_cli(monkeypatch, name, argv):
    """Run the JAX package's ``tools/<name>.py`` as its ``__main__``."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"), run_name="__main__")


def test_ply2npy_cli_matches_jax(tmp_path, rng, monkeypatch, capsys):
    plys = tmp_path / "ply"
    plys.mkdir()
    for i, fmt in enumerate(("ascii", "binary_little_endian")):
        _write_ply(str(plys / f"scene000{i}_00.ply"), fmt, rng.normal(size=(20 + i, 3)),
                   rng.integers(0, 256, (20 + i, 3)))
    (plys / "notes.txt").write_text("not a cloud")
    _jax_cli(monkeypatch, "ply2npy", [str(plys), str(tmp_path / "jax")])
    want_out = capsys.readouterr().out
    tply2npy.main([str(plys), str(tmp_path / "torch")])
    assert capsys.readouterr().out == want_out
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax")) == \
        ["scene0000_00.npy", "scene0001_00.npy"]
    for f in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


# ------------------------------------------------------- evaluation CLIs
@pytest.fixture
def final_outputs(tmp_path):
    """The synthetic scene through the port's projection and refinement on
    the CPU: final outputs for the query class beside the GT."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_synthetic_scene

    cfg_path = make_synthetic_scene.generate(str(tmp_path / "scene"), query="clothes", seed=7)
    cfg = TConfig.from_yaml(cfg_path)
    tprojection.run(cfg, "clothes", resume=False, device="cpu")
    trefinement.run(cfg, "clothes", device="cpu")
    return cfg_path


def test_eval_class_agnostic_cli_matches_jax(final_outputs, monkeypatch, capsys):
    _jax_cli(monkeypatch, "eval_class_agnostic", ["--config", final_outputs, "--cls", "clothes"])
    want = capsys.readouterr().out
    tagnostic.main(["--config", final_outputs, "--cls", "clothes"])
    got = capsys.readouterr().out
    assert got == want
    assert "[class-agnostic] AP=" in got and "class_agnostic" in got


def test_aggregate_results_cli_matches_jax(tmp_path, monkeypatch, capsys):
    from beyondff_tpu_torch.data import scannet200 as s2

    rng = np.random.default_rng(2)
    names = (list(s2.HEAD_CATS_SCANNET_200[:5]) + list(s2.COMMON_CATS_SCANNET_200[:4])
             + list(s2.TAIL_CATS_SCANNET_200[:3]))
    lines = ["class,class id,ap,ap50,ap25,rc,rc50,rc25"]
    for i, n in enumerate(names):
        vals = ["nan" if i == 4 else f"{v:.4f}" for v in rng.random(6)]
        lines.append(",".join([n, *vals]))
    lines.append("wall,-,-,-,-,-,-")
    table = tmp_path / "overall_results.txt"
    table.write_text("\n".join(lines) + "\n")
    _jax_cli(monkeypatch, "aggregate_results", [str(table), "--csv", str(tmp_path / "j.csv")])
    want = capsys.readouterr().out
    tagg.main([str(table), "--csv", str(tmp_path / "t.csv")])
    got = capsys.readouterr().out
    assert got.replace("t.csv", "j.csv") == want
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert "Head" in got and "Overall" in got


# ---------------------------------------------------- checkpoint reset
@pytest.mark.parametrize("argv", [[], ["--cls", "towel", "--stages", "refinement,segmentation_2d",
                                       "--sweep"]], ids=["all", "one-class"])
def test_clear_checkpoints_cli_removes_what_jax_removes(tmp_path, monkeypatch, capsys, argv):
    names = [f"{s}_checkpoint_{c}.yaml" for s in
             ("segmentation_2d", "projection_2d_to_3d", "refinement") for c in ("towel", "chair")]
    names += ["notes.yaml", "segmentation_2d_checkpoint_towel.txt"]
    left = {}
    for side, run in (("jax", lambda a: _jax_cli(monkeypatch, "clear_checkpoints", a)),
                      ("torch", tclear.main)):
        work = tmp_path / side
        (work / "ckpt").mkdir(parents=True)
        for n in names:
            (work / "ckpt" / n).write_text("done: []\n")
        (work / "process_checkpoint.txt").write_text("towel\n")
        cfg = work / "config.yaml"
        TConfig.from_dict({"paths": {"checkpoint_dir": str(work / "ckpt")}}).to_yaml(str(cfg))
        monkeypatch.chdir(work)
        run(["--config", str(cfg), *argv])
        left[side] = (sorted(os.listdir(work / "ckpt")), os.path.exists("process_checkpoint.txt"),
                      capsys.readouterr().out)
    assert left["torch"] == left["jax"]
    assert "notes.yaml" in left["torch"][0] and len(left["torch"][0]) < len(names)
    shutil.rmtree(tmp_path / "jax")
