"""The port's tooling against the JAX package's: the synthetic scene
generator, ``utils/prefetch``'s ``prefetch_map``, ``utils/profiling``'s
``StageProfiler.rate``/``to_json``, ``trace`` and ``annotate``, and the
``measure_sam_rect``, ``trace_fast_pipeline`` and ``e2e_synthetic`` CLIs.

Tolerances: the generator's PNG, JPEG and text files byte for byte and its
``.pth``/``.npy``/``.yaml`` contents equal once loaded (the YAML's
``detector.waffle_word_list_path`` names each package's own word list);
the profiler's numbers exactly; ``measure_sam_rect``'s embedding deviation
within 1e-4 of the JAX package's on the same weights and its masks at IoU
>= 0.999 against the JAX package's.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from beyondff_tpu.models import sam as jsam
from beyondff_tpu.utils import prefetch as jprefetch
from beyondff_tpu.utils import profiling as jprofiling
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.tools import e2e_synthetic as te2e
from beyondff_tpu_torch.tools import make_synthetic_scene as tgen
from beyondff_tpu_torch.tools import measure_sam_rect as tmeasure
from beyondff_tpu_torch.tools import trace_fast_pipeline as ttrace
from beyondff_tpu_torch.utils import prefetch as tprefetch
from beyondff_tpu_torch.utils import profiling as tprofiling

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import make_synthetic_scene as jgen  # noqa: E402


# -------------------------------------------------------------- generator
def _equal_trees(a, b, where):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        assert isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor), where
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            _equal_trees(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("dataset,seed,query", [("Scannet200", 7, "towel"),
                                                ("replica", 3, "chair")])
def test_generator_matches_the_jax_script(tmp_path, dataset, seed, query):
    paths = {}
    for tag, gen in (("j", jgen), ("t", tgen)):
        gen.generate(str(tmp_path / tag), query=query, scenes=2, seed=seed, dataset=dataset)
        paths[tag] = sorted(os.path.relpath(os.path.join(d, f), tmp_path / tag)
                            for d, _, fs in os.walk(tmp_path / tag) for f in fs)
    assert paths["t"] == paths["j"] and len(paths["t"]) > 40
    for rel in paths["t"]:
        t, j = str(tmp_path / "t" / rel), str(tmp_path / "j" / rel)
        ext = os.path.splitext(rel)[1]
        if ext in (".png", ".jpg", ".txt"):
            assert open(t, "rb").read() == open(j, "rb").read(), rel
        elif ext == ".npy":
            _equal_trees(np.load(t), np.load(j), rel)
        elif ext == ".pth":
            _equal_trees(torch.load(t, weights_only=False), torch.load(j, weights_only=False),
                         rel)
        else:
            assert ext == ".yaml", rel
            ty, jy = (yaml.safe_load(open(p)) for p in (t, j))
            tw, jw = ty["detector"].pop("waffle_word_list_path"), \
                jy["detector"].pop("waffle_word_list_path")
            assert (tw, jw) == ("./beyondff_tpu_torch/pipeline/waffle_words.json",
                                "./beyondff_tpu/pipeline/waffle_words.json")
            _equal_trees(json.loads(json.dumps(ty).replace(str(tmp_path / "t"), "ROOT")),
                         json.loads(json.dumps(jy).replace(str(tmp_path / "j"), "ROOT")), rel)


def test_generator_cli(tmp_path, capsys):
    tgen.main([str(tmp_path / "s"), "--cls", "chair", "--seed", "2"])
    assert "query='chair'" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "s" / "config.yaml")


def test_e2e_synthetic_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    te2e.main(["--device", "cpu"])
    assert capsys.readouterr().out.rstrip().endswith("END-TO-END SLICE: PASS")


# --------------------------------------------------------------- prefetch
def _slow_square(x):
    time.sleep(0.002 * ((x * 7) % 5))  # out-of-order completion
    return x * x


@pytest.mark.parametrize("workers", [1, 4])
def test_prefetch_map_keeps_order_like_jax(workers):
    items = list(range(40))
    want = list(jprefetch.prefetch_map(_slow_square, items, depth=3, workers=workers))
    assert list(tprefetch.prefetch_map(_slow_square, items, depth=3, workers=workers)) == want
    assert want == [x * x for x in items]


def _fails_at_5(x):
    if x == 5:
        raise KeyError("item 5")
    return x


@pytest.mark.parametrize("workers", [1, 4])
def test_prefetch_map_raises_at_the_consumer(workers):
    got = []
    with pytest.raises(KeyError, match="item 5"):
        for x in tprefetch.prefetch_map(_fails_at_5, range(20), depth=2, workers=workers):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def test_prefetch_stops_its_thread_when_closed():
    made = []

    def source():
        for i in range(1000):
            made.append(i)
            yield i

    before = threading.active_count()
    it = tprefetch.prefetch(source(), depth=2)
    assert next(it) == 0
    it.close()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before and len(made) < 10


def test_prefetch_map_many_workers_under_a_short_switch_interval():
    """More loader threads than cores, the interpreter switching threads
    every microsecond: the order and every item survive."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = list(tprefetch.prefetch_map(lambda x: (x, threading.get_ident()), range(500),
                                          depth=4, workers=(os.cpu_count() or 1) + 4))
    finally:
        sys.setswitchinterval(old)
    assert [x for x, _ in out] == list(range(500))


# -------------------------------------------------------------- profiling
def _fill(prof):
    prof.durations.update({"lift": 2.0, "scene": 0.5})
    prof.counts.update({"lift": 3, "scene": 1})
    prof.items.update({"lift.frames": 30, "scene.frames": 8})


def test_stage_profiler_rate_and_to_json_match_jax():
    t, j = tprofiling.StageProfiler("projection"), jprofiling.StageProfiler("projection")
    for prof in (t, j):
        _fill(prof)
        with prof.span("emit", records=4):
            pass
    for name, item in (("lift", "frames"), ("scene", "frames"), ("lift", "points"),
                       ("absent", "frames")):
        assert t.rate(name, item) == j.rate(name, item)
    assert t.rate("lift", "frames") == 15.0 and t.rate("absent", "frames") is None
    tj, jj = json.loads(t.to_json()), json.loads(j.to_json())
    tj["durations_s"].pop("emit"), jj["durations_s"].pop("emit")  # host time
    assert tj == jj


def test_stage_profiler_spans_from_threads():
    prof = tprofiling.StageProfiler("seg")
    threads = [threading.Thread(target=lambda: [_one_span(prof) for _ in range(200)])
               for _ in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert prof.counts["load"] == 1600 and prof.items["load.frames"] == 1600


def _one_span(prof):
    with prof.span("load", frames=1):
        pass


def test_trace_writes_a_chrome_trace_naming_the_annotation(tmp_path):
    with tprofiling.trace(str(tmp_path)):
        with tprofiling.annotate("bff_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "bff_region" in names and any("mm" in str(n) for n in names)


# ---------------------------------------------------------- measure tools
def test_measure_sam_rect_matches_jax_on_the_test_preset():
    """The tool's deviation numbers on the port's copy of a JAX SAM against
    the JAX package's own square and rect encodes and packed decodes."""
    jm = jsam.SAM.create("test", seed=3)
    module = tlayers.build(lambda: tsam.SAMModule(jm.cfg), torch.device("cpu"))
    module.load_state_dict(convert.sam_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                                jm.cfg))
    tm = tsam.SAM(jm.cfg, module)
    nh, nw = tm.scaled_hw(tmeasure.FRAME_HW)
    frames = np.random.default_rng(0).integers(0, 255, (1, nh, nw, 3), dtype=np.uint8)
    boxes = tmeasure.BOXES_1024 * (jm.cfg.img_size / 1024)
    out = tmeasure.measure(tm, torch.from_numpy(frames), boxes, tmeasure.FRAME_HW, iters=1)
    assert out["grid_square"] == [8, 8] and out["grid_rect"] == [6, 8]
    ref = {}
    n = tmeasure.FRAME_HW[0] * tmeasure.FRAME_HW[1]
    for rect in (False, True):
        with tmeasure.rect_mode(rect):
            j = jsam.SAM(jm.cfg, jm.params)  # traces under the variable
            emb = j.encode_frames(jnp.asarray(frames))
            packed, iou = j.decode_boxes_packed(emb, boxes[None], (nh, nw), tmeasure.FRAME_HW)
            ref[rect] = (np.asarray(emb), np.unpackbits(np.asarray(packed)[0], axis=-1,
                                                        bitorder="little")[:, :n].astype(bool))
    gh, gw = ref[True][0].shape[1:3]
    valid = ref[False][0][:, :gh, :gw]
    rel = np.linalg.norm(ref[True][0] - valid) / np.linalg.norm(valid)
    assert abs(out["emb_rel_l2"] - rel) <= 1e-4 and rel > 0
    inter = np.logical_and(ref[False][1], ref[True][1]).sum(-1)
    union = np.logical_or(ref[False][1], ref[True][1]).sum(-1)
    np.testing.assert_allclose(out["mask_iou"], inter / np.maximum(union, 1), atol=1e-3)
    assert out["encode_ms_square"] > 0 and out["encode_ms_rect"] > 0


def test_measure_sam_rect_cli_on_cpu(capsys):
    tmeasure.main(["--device", "cpu", "--preset", "test", "--dtype", "float32", "--iters", "1",
                   "--model", "efficientsam", "--temp-sweep"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["grid_rect"] == [6, 8]
    assert len(out["mask_iou_temp8"]) == 4 and 0 <= out["emb_rel_l2_temp2"]


def test_trace_fast_pipeline_prints_the_jax_phase_names(capsys):
    ttrace.main(["--device", "cpu", "--preset", "test", "--frames", "4", "--dtype", "float32"])
    lines = capsys.readouterr().out.splitlines()
    trace = [ln for ln in lines if ln.startswith("# seg2d host trace [scene0000_00]")]
    assert len(trace) == 1 and "(4 frames)" in trace[0]
    out = json.loads(lines[-1])
    assert out["frames_per_sec"] > 0 and out["spans"]["items"]["scene.frames"] == 4
