"""The port's tools/measure_deform_window.py against the JAX package's tool.

The same seeded inputs go through the port's ``kernel_level`` and
``full_model`` (plain PyTorch sampling on the CPU) and through the JAX
computation the JAX tool runs (the Pallas kernel in interpret mode, the
windowed encoder under ``BFF_DEFORM_WINDOWED=1``), at small shapes.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyondff_tpu.kernels import deform_window as jdw
from beyondff_tpu.models.gdino import GroundingDINO as JGroundingDINO
from beyondff_tpu.models.gdino import bert as jbert
from beyondff_tpu.models.gdino import deformable as jdeform
from beyondff_tpu.models.gdino import model as jmodel
from beyondff_tpu.models.gdino import swin as jswin
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models.gdino import model as tgdino
from beyondff_tpu_torch.tools import measure_deform_window as mdw

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = mdw.TEST_SHAPES
HEADS, HD, P = 2, 8, 4
TILES = (8, 4)  # the JAX tool's --tiles: radius = tile, so R = 7 and 3


def _jax_kernel_level(rng, sigmas, tiles):
    """The JAX tool's ``kernel_level`` body at ``SHAPES``: (frac_beyond_R,
    mean_abs_err, max_abs_err, rel_l2) a row."""
    centers = mdw._centers(SHAPES)
    q = centers.shape[0]
    value = rng.normal(size=(1, q, HEADS, HD)).astype(np.float32)
    rows = []
    for level, tile in [(0, tiles[0]), (1, tiles[1])]:
        h, w = SHAPES[level]
        assign = jdw.build_assignment(SHAPES, level, tile)
        radius = tile - 1
        v = value[:, sum(hh * ww for hh, ww in SHAPES[:level]):][:, : h * w]
        for sigma in sigmas:
            off = rng.normal(0, sigma, (1, q, HEADS, P, 2)).astype(np.float32)
            locs1 = np.zeros((1, q, HEADS, 1, P, 2), np.float32)
            locs1[:, :, :, 0, :, 0] = centers[None, :, None, None, 0] + off[..., 0] / w
            locs1[:, :, :, 0, :, 1] = centers[None, :, None, None, 1] + off[..., 1] / h
            aw = rng.uniform(0.1, 1.0, (1, q, HEADS, 1, P)).astype(np.float32)
            aw /= aw.sum((-1, -2), keepdims=True)
            gx = locs1[:, :, :, 0, :, 0] * w - 0.5
            gy = locs1[:, :, :, 0, :, 1] * h - 0.5
            got = np.asarray(jdw.sample_level_windowed(
                jnp.asarray(v), jnp.asarray(gx), jnp.asarray(gy),
                jnp.asarray(aw[:, :, :, 0]), assign, h, w, interpret=True))
            want = np.asarray(jdeform.ms_deform_attn(
                jnp.asarray(v), [(h, w)], jnp.asarray(locs1),
                jnp.asarray(aw))).reshape(got.shape)
            err = np.abs(got - want)
            rows.append((float((np.abs(off) > radius).any(-1).mean()), err.mean(), err.max(),
                         float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12))))
    return rows


def test_kernel_level_matches_jax():
    """Two levels x three sigmas at radius = tile: ``frac_beyond_R`` equal,
    the errors within 1e-5 absolute or 1e-4 relative."""
    sigmas = [1.0, 2.0, 4.0]
    want = _jax_kernel_level(np.random.default_rng(0), sigmas, TILES)
    rows = mdw.kernel_level(np.random.default_rng(0), sigmas, mdw.tile_modes(SHAPES, TILES),
                            SHAPES, HEADS, HD, P, torch.float32, "cpu")
    assert [(r["level"], r["tile"], r["radius"], r["sigma_cells"]) for r in rows] == [
        (level, t, t, s) for level, t in enumerate(TILES) for s in sigmas]
    for row, (beyond, mean, mx, rel) in zip(rows, want):
        assert row["frac_beyond_R"] == beyond
        np.testing.assert_allclose([row["mean_abs_err"], row["max_abs_err"], row["rel_l2"]],
                                   [mean, mx, rel], atol=1e-5, rtol=1e-4)
    assert max(r["rel_l2"] for r in rows) > 1e-2  # some rows do clamp


def test_clamped_share_zero_inside_window_and_rises_with_sigma():
    """The main path's modes: no offset beyond R - 1 cells clamps and leaves
    clamp and exact equal bit for bit; the clamped share rises with sigma."""
    sigmas = [0.5, 3.0, 8.0]
    rows = mdw.kernel_level(np.random.default_rng(0), sigmas, None, SHAPES, HEADS, HD, P,
                            torch.float32, "cpu")
    assert [(r["tile"], r["radius"]) for r in rows[::len(sigmas)]] == [(16, 8)] + [(8, 8)] * 3
    for row in rows:
        if row["frac_beyond_R"] == 0.0:
            assert row["clamped"] == 0 and row["mismatched"] == 0 and row["max_abs_err"] == 0.0
        assert row["clamped_share"] <= row["frac_beyond_R"]
    assert rows[0]["frac_beyond_R"] == 0.0
    for level in (0, 1):
        shares = [r["clamped_share"] for r in rows[level * len(sigmas):(level + 1) * len(sigmas)]]
        assert shares[0] == 0.0 and all(a < b for a, b in zip(shares, shares[1:])), shares


def test_clamp_counts_follow_the_window():
    """Offsets within R - 1 = radius - 2 cells of the raster centres never
    clamp; a sample pushed past its window's edge clamps unless it leaves
    the map."""
    modes = ((16, 8), (8, 8), (8, 8), (8, 8))
    rng = np.random.default_rng(1)
    q = sum(h * w for h, w in SHAPES)
    centers = mdw._centers(SHAPES).astype(np.float32)
    wh = np.array([[w, h] for h, w in SHAPES], np.float32)
    off = rng.uniform(-6.0, 6.0, (1, q, HEADS, len(SHAPES), P, 2)).astype(np.float32)
    locs = centers[None, :, None, None, None, :] + off / wh[:, None, :]
    counts = mdw.clamp_counts(torch.from_numpy(locs), SHAPES, modes)
    assert [c for c, _ in counts] == [0, 0, 0, 0] and all(m > 0 for _, m in counts)
    # query 0 (cell (0, 0) of L0, window rows and columns -8..22): 23.5 cells
    # to the right clamps, 1.5 cells to the left leaves the map
    locs[0, 0, 0, 0, 0] = [centers[0, 0] + 23.5 / 48, centers[0, 1]]
    locs[0, 0, 0, 0, 1] = [centers[0, 0] - 1.5 / 48, centers[0, 1]]
    counts = mdw.clamp_counts(torch.from_numpy(locs), SHAPES, modes)
    assert counts[0][0] == 1 and all(c == 0 for c, _ in counts[1:])


def _jax_config():
    return jmodel.GDINOConfig(
        swin=jswin.PRESETS["test"], bert=jbert.PRESETS["test"], hidden=32, heads=4,
        levels=3, enc_layers=2, dec_layers=2, ffn_dim=64, num_queries=32, max_text_len=16,
        image_size=(256, 384))


def _jax_full_model(jm, applies, rng, alpha):
    """The JAX tool's ``full_model`` for one alpha: (exact, windowed) as
    (logits, boxes) numpy pairs."""
    cfg = jm.cfg
    gh, gw = cfg.image_size
    img = jnp.asarray(rng.normal(size=(1, gh, gw, 3)), jnp.float32)
    ids = jnp.asarray(rng.integers(1, cfg.bert.vocab_size, (1, mdw.TEXT_LEN)), jnp.int32)
    t = mdw.TEXT_LEN
    text = (jnp.ones((1, t, t), bool), jnp.ones((1, t), bool), jnp.zeros((1, t), jnp.int32))
    params = jax.tree_util.tree_map(lambda x: x, jm.params)
    for li in range(cfg.enc_layers):
        so = params["params"][f"enc{li}"]["deform"]["sampling_offsets"]
        so["kernel"] = so["kernel"] * alpha
        so["bias"] = so["bias"] * alpha
    return [tuple(np.asarray(x) for x in applies[w](params, img, ids, *text))
            for w in ("0", "1")]


@pytest.fixture(scope="module")
def models():
    """The JAX tool's model (seed 0), its forward jitted once with windowed
    sampling off and once on (the switch is read while tracing), and the
    port's model with its weights."""
    jm = JGroundingDINO.create(_jax_config(), seed=0)
    applies = {}
    old = os.environ.get("BFF_DEFORM_WINDOWED")
    try:
        for windowed in ("0", "1"):
            os.environ["BFF_DEFORM_WINDOWED"] = windowed
            applies[windowed] = jax.jit(lambda *a: jm.module.apply(*a)).lower(
                jm.params, *_example_inputs(jm.cfg)).compile()
    finally:
        if old is None:
            os.environ.pop("BFF_DEFORM_WINDOWED", None)
        else:
            os.environ["BFF_DEFORM_WINDOWED"] = old
    tm = tlayers.build(lambda: tgdino.GDINOModule(mdw.SMALL_CONFIG), torch.device("cpu"),
                       seed=3)
    tm.load_state_dict(convert.gdino_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                              tm.cfg))
    return jm, applies, tm


def _example_inputs(cfg):
    gh, gw = cfg.image_size
    t = mdw.TEXT_LEN
    return (jnp.zeros((1, gh, gw, 3), jnp.float32), jnp.zeros((1, t), jnp.int32),
            jnp.ones((1, t, t), bool), jnp.ones((1, t), bool), jnp.zeros((1, t), jnp.int32))


@pytest.mark.parametrize("alpha", [0.25, 4.0])
def test_full_model_matches_jax(models, alpha):
    """Windowed and exact logits and boxes within 5e-4 of the JAX package's;
    max|dbox| and max|dlogit| within 1e-4 of the JAX tool's; the top-8
    overlap equal."""
    jm, applies, tm = models
    exact, windowed = _jax_full_model(jm, applies, np.random.default_rng(0), alpha)
    (row,) = mdw.full_model(np.random.default_rng(0), [alpha], module=tm, device="cpu")
    assert os.environ.get("BFF_DEFORM_WINDOWED") is None
    for tag, (jl, jb) in (("exact", exact), ("windowed", windowed)):
        tl, tb = row["outputs"][tag]
        np.testing.assert_allclose(tl, jl, atol=5e-4, rtol=0)
        np.testing.assert_allclose(tb, jb, atol=5e-4, rtol=0)
    np.testing.assert_allclose(row["max_dbox"], np.abs(windowed[1] - exact[1]).max(), atol=1e-4)
    np.testing.assert_allclose(row["max_dlogit"], np.abs(windowed[0] - exact[0]).max(),
                               atol=1e-4)
    top = [set(np.argsort(np.asarray(jax.nn.sigmoid(lg).max(-1))[0])[-8:].tolist())
           for lg in (exact[0], windowed[0])]
    assert row["topk_overlap"] == len(top[0] & top[1]) / 8.0
    assert row["modes"] == [[16, 8], [8, 8], [8, 8]]
    if alpha == 4.0:
        assert row["clamped"] > 0 and row["memory_rel_l2"] > 0 and row["max_dbox"] > 1e-3
    else:
        assert row["clamped"] == 0 and row["max_dbox"] == 0.0 and row["memory_rel_l2"] == 0.0


def test_full_model_leaves_weights_unscaled():
    module = tlayers.build(lambda: tgdino.GDINOModule(mdw.SMALL_CONFIG), torch.device("cpu"),
                           seed=5)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    scaled = mdw.scaled_offsets(module, 4.0)
    assert len(scaled) == 2 * mdw.SMALL_CONFIG.enc_layers
    (row,) = mdw.full_model(np.random.default_rng(2), [4.0], module=module, device="cpu")
    assert row["clamped"] > 0
    after = module.state_dict()
    assert after.keys() == before.keys()
    for key, val in before.items():
        assert torch.equal(after[key], val), key
    for key, val in scaled.items():
        assert torch.equal(val, before[key] * 4.0), key
        assert key.endswith(".bias") or not torch.equal(val, before[key]), key


def test_import_leaves_jax_out():
    code = ("import sys\nimport beyondff_tpu_torch.tools.measure_deform_window\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'beyondff_tpu' or m.startswith('beyondff_tpu.')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr


def test_main_on_cpu_prints_a_line_a_row(capsys):
    rows = mdw.main(["--device", "cpu", "--sigmas", "1,3", "--alphas", "0.25",
                     "--dtype", "float32"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == len(lines) == 4 * 2 + 1
    assert [(r["part"], r.get("sigma_cells"), r.get("alpha")) for r in lines] == (
        [("kernel_level", s, None) for _ in range(4) for s in (1.0, 3.0)]
        + [("full_model", None, 0.25)])
    assert all(r["device"] == "cpu" and r["shapes"][0] == [32, 48] for r in lines[:8])
    assert all(np.isfinite(r["rel_l2"]) for r in lines[:8])


def test_main_defaults_to_cuda(monkeypatch):
    """No ``--device``: the card, which raises here rather than falling back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mdw.main(["--skip-full"])
