"""The port's profiling switches and CLIs against the JAX package.

``BFF_SAM_ABLATE`` (each value, SAM's encoder against the JAX encoder under
the same value, within 5e-4), ``BFF_CLIP_MAP`` (one crop at a time against
the batched tower and JAX's ``lax.map``, within 1e-5),
``BFF_PROJ_BANK_VIEWED`` (0 against 1 and the JAX package: equal outputs),
the ``ops`` namespace, ``measure_depth_decimation`` against the JAX tool on
the same seed, and each profiling CLI on the CPU at ``--scale test``.
"""

import importlib
import io
import json
import os
import runpy
import shutil
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import beyondff_tpu.ops as jops
from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.models import clip as jclip
from beyondff_tpu.models import sam as jsam
from beyondff_tpu.pipeline import projection as jprojection
from beyondff_tpu.utils import io as jio
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.pipeline import projection as tprojection
from beyondff_tpu_torch.tools import measure_depth_decimation as tmdd

torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


def _carry(make, params, fn, cfg):
    module = tlayers.build(make, CPU)
    module.load_state_dict(fn(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module


@pytest.mark.parametrize("ablate", ["", "norelpos", "noattn", "nomlp", "noattn,nomlp"])
def test_sam_ablate_matches_jax(monkeypatch, ablate):
    """The encoder under each ``BFF_SAM_ABLATE`` value; a fresh JAX wrapper
    per value, since the JAX package reads the variable when it traces."""
    monkeypatch.delenv("BFF_SAM_ABLATE", raising=False)
    jm = jsam.SAM.create("test", seed=5)
    tm = tsam.SAM(jm.cfg, _carry(lambda: tsam.SAMModule(jm.cfg), jm.params,
                                 convert.sam_from_jax, jm.cfg))
    monkeypatch.setenv("BFF_SAM_ABLATE", ablate)
    jm = jsam.SAM(jm.cfg, jm.params)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jm.encode_image(x))
    with torch.inference_mode():
        got = tm.module.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    monkeypatch.setenv("BFF_SAM_ABLATE", "")
    with torch.inference_mode():
        full = tm.module.encode(torch.from_numpy(x)).numpy()
    assert (np.abs(full - got).max() > 1e-3) == bool(ablate)


def test_clip_map_matches_batched_and_jax(monkeypatch):
    """``BFF_CLIP_MAP=1``: a uint8 crop batch encodes one crop at a time,
    equal to the batched tower and to JAX's mapped tower within 1e-5."""
    jm = jclip.CLIP.create("test", seed=4)
    tm = tclip.CLIP(jm.cfg, _carry(lambda: tclip.CLIPModule(jm.cfg), jm.params,
                                   convert.clip_from_jax, jm.cfg))
    n = jm.cfg.image_resolution
    crops = np.random.default_rng(0).integers(0, 255, (5, n, n, 3), dtype=np.uint8)
    monkeypatch.delenv("BFF_CLIP_MAP", raising=False)
    batched = tm.encode_image(crops).numpy()
    calls = []
    real = tm.module.encode_image
    tm.module.encode_image = lambda x: calls.append(x.shape[0]) or real(x)
    monkeypatch.setenv("BFF_CLIP_MAP", "1")
    try:
        mapped = tm.encode_image(crops).numpy()
    finally:
        del tm.module.encode_image
    assert calls == [1] * 5
    want = np.asarray(jm.encode_image(crops))
    np.testing.assert_allclose(mapped, batched, atol=1e-5, rtol=0)
    np.testing.assert_allclose(mapped, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("bank_viewed", ["1", "0"])
def test_proj_bank_viewed_matches_jax(tmp_path, monkeypatch, bank_viewed):
    """``BFF_PROJ_BANK_VIEWED``: with the bank (default) the second class
    reuses the first one's visibility totals, without it each class counts
    its own; the outputs are equal to each other and to the JAX package's
    ``run_classes`` under the same value."""
    import make_synthetic_scene

    monkeypatch.setenv("BFF_PROJ_BANK_VIEWED", bank_viewed)
    cfg_path = make_synthetic_scene.generate(str(tmp_path), query="clothes", seed=11)
    tcfg = TConfig.from_yaml(cfg_path)
    shutil.copytree(os.path.join(tcfg.paths.mask_2d_dir, "clothes"),
                    os.path.join(tcfg.paths.mask_2d_dir, "towel"))
    calls = []
    orig = tprojection.lift_scene_streamed

    def spy(*args, **kwargs):
        calls.append(kwargs["need_viewed"])
        return orig(*args, **kwargs)

    monkeypatch.setattr(tprojection, "lift_scene_streamed", spy)
    tres = tprojection.run_classes(tcfg, ["clothes", "towel"], resume=False, device=CPU)
    monkeypatch.undo()
    monkeypatch.setenv("BFF_PROJ_BANK_VIEWED", bank_viewed)
    assert calls == ([True, False] if bank_viewed == "1" else [True, True])
    jcfg = JConfig.from_yaml(cfg_path).override(**{
        "paths.mask_3d_dir": str(tmp_path / "jax3d"),
        "paths.checkpoint_dir": str(tmp_path / "jaxckpt")})
    jres = jprojection.run_classes(jcfg, ["clothes", "towel"], resume=False)
    assert tres == jres
    for c in ("clothes", "towel"):
        got = jio.load_stage_dict(os.path.join(tcfg.paths.mask_3d_dir, c, "scene0000_00.pth"))
        want = jio.load_stage_dict(str(tmp_path / "jax3d" / c / "scene0000_00.pth"))
        np.testing.assert_array_equal(got["ins"], want["ins"])
        np.testing.assert_array_equal(got["conf"], want["conf"])
        assert got["ins"].shape[0] == 2


def test_ops_names_resolve():
    """Every public name of the JAX ``ops`` namespace has its counterpart."""
    tops = importlib.import_module("beyondff_tpu_torch.ops")
    names = [n for n in dir(jops) if not n.startswith("_") and callable(getattr(jops, n))]
    assert len(names) == 13
    for n in names:
        assert callable(getattr(tops, n)), n
    from beyondff_tpu_torch.kernels import mask_iou

    assert tops.pairwise_iou is mask_iou.pairwise_iou is tops.pairwise_iou_pallas
    a = torch.rand(4, 300) < 0.4
    np.testing.assert_allclose(tops.pairwise_iou(a).numpy(),
                               np.asarray(jops.pairwise_iou(jnp.asarray(a.numpy()))), atol=1e-6)


def test_measure_depth_decimation_matches_jax_tool(tmp_path, monkeypatch):
    """The port's tool and the JAX tool on the same seed print the same
    AP and IoU table."""
    got = tmdd.measure(str(tmp_path / "port"), CPU)
    monkeypatch.setattr(sys, "argv", ["measure_depth_decimation.py"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(os.path.join(REPO, "tools", "measure_depth_decimation.py"),
                       run_name="__main__")
    table = buf.getvalue().split("mean_final_mask_IoU_vs_dec1\n")[1].split("\n")
    rows = {int(ln.split()[0]): [float(v) for v in ln.split()[1:]] for ln in table if ln.strip()}
    assert sorted(rows) == sorted(got) == [1, 2, 4]
    for dec, r in got.items():
        mine = [r["all_ap"], r["all_ap_50%"], r["all_ap_25%"], r["mean_final_mask_iou_vs_dec1"]]
        assert [f"{v:.4f}" for v in mine] == [f"{v:.4f}" for v in rows[dec]]
    assert got[1]["mean_final_mask_iou_vs_dec1"] == 1.0 and got[1]["all_ap"] > 0


@pytest.mark.parametrize("tool,variants", [
    ("profile_models", {"gdino_full", "gdino_swin_backbone", "sam_encode_full",
                        "sam_encode_all_windowed", "attribution"}),
    ("profile_sam", {"full", "norelpos", "noattn", "nomlp", "noglobal", "full_relpos_flash",
                     "norelpos_relpos_flash", "attribution"}),
    ("profile_gdino_blocks", {"enc1_dec1", "enc0_dec1", "enc1_dec0", "enc0_dec0",
                              "attribution"}),
    ("profile_enhancer", {"enhancer_layer", "msdeform_windowed", "msdeform_exact",
                          "ms_deform_sample", "biattention_fusion", "text_enhancer",
                          "image_ffn_ln", "sine_pe_per_forward", "summary"}),
])
def test_profiling_cli_runs_on_cpu(capsys, tool, variants):
    """Each CLI at ``--scale test`` on the CPU: one JSON line per variant,
    a host time for each, no device time (not measured off the card)."""
    mod = importlib.import_module(f"beyondff_tpu_torch.tools.{tool}")
    mod.main(["--device", "cpu", "--scale", "test", "--iters", "1", "--dtype", "float32"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert {r["tool"] for r in rows} == {tool}
    assert {r["variant"] for r in rows} == variants
    timed = [r for r in rows if r["variant"] not in ("attribution", "summary")]
    assert all(r.get("ms", r.get("ms_per_frame")) > 0 for r in timed)
    assert all(r.get("device_ms", r.get("device_ms_per_frame")) is None for r in timed)
    if tool == "profile_sam":
        by = {r["variant"]: r for r in rows}
        assert by["full"]["global_relpos"] == "kept"
        assert by["norelpos"]["global_relpos"] == "dropped"
        assert by["noglobal"]["global_branch"] is None
        assert {by[v]["global_branch"] for v in ("full", "norelpos")} == {"plain"}
