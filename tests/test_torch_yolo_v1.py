"""YOLO-World v1 checkpoints (``bn_head=False``, the L2 ``ContrastiveHead``)
in the port against the JAX package.

The ``"test"`` preset with ``bn_head=False`` in both packages, seeded numpy
inputs. Tolerances as in ``tests/test_torch_fast_variant.py``: logits within
1e-4 and boxes within 1e-4 of the 64-px input (float32 on both sides); the
converters' round trip and the official-layout load bit for bit; the NMS'd
detections index for index.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from beyondff_tpu.models import yolo_world as jyw
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import yolo_world as tyw

torch.set_num_threads(2)
ATOL = 1e-4
V1 = dataclasses.replace(tyw.PRESETS["test"], bn_head=False)
JV1 = dataclasses.replace(jyw.PRESETS["test"], bn_head=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _official_v1(seed):
    """A v1 state dict in the ultralytics layout: seeded values for every
    key of the port's v1 module (no ``cv4.{i}.norm``)."""
    rng = np.random.default_rng(seed)
    module = tlayers.build(lambda: tyw.YOLOWorldModule(V1), torch.device("cpu"))
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith("running_var"):
            x = rng.uniform(0.5, 1.5, v.shape)
        elif k.endswith("logit_scale"):
            x = np.full(v.shape, np.log(1 / 0.07))
        else:
            x = rng.normal(0, 0.2, v.shape)
        sd[k] = torch.from_numpy(np.asarray(x, np.float32))
    return sd


@pytest.fixture(scope="module")
def v1():
    sd = _official_v1(21)
    jvars = jyw.convert_torch_checkpoint(dict(sd), JV1)
    jm = jyw.YOLOWorld(JV1, jvars)
    tm = tyw.YOLOWorld(V1, tyw.load_torch_checkpoint(dict(sd), V1, device="cpu"))
    return sd, jvars, jm, tm


def test_v1_layout_has_no_head_norm_and_round_trips(v1):
    """The v1 module's keys are the official ones (``cv4.{i}.logit_scale``
    and ``bias``, no ``norm``); the JAX converter's output carried back by
    ``yolo_world_from_jax`` equals the file, and the port's loader reads it
    bit for bit."""
    sd, jvars, _jm, tm = v1
    heads = sorted(k for k in sd if ".cv4." in k)
    assert heads == sorted(f"model.22.cv4.{i}.{n}" for i in range(3)
                           for n in ("bias", "logit_scale"))
    back = convert.yolo_world_from_jax(_np(jvars), V1)
    assert set(back) == set(sd)
    for k, v in tm.module.state_dict().items():
        assert torch.equal(back[k], sd[k]) and torch.equal(v, sd[k]), k
    with pytest.raises(Exception, match="norm"):
        # a v2 module does not take the v1 file: its head norms are missing
        tyw.load_torch_checkpoint(dict(sd), tyw.PRESETS["test"], device="cpu")


def test_v1_logits_match_jax(v1):
    _sd, jvars, _jm, tm = v1
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    txt = rng.normal(size=(3, 32)).astype(np.float32)
    txt /= np.linalg.norm(txt, axis=-1, keepdims=True)
    module = jyw.YOLOWorldModule(JV1)
    jbox, jlog = module.apply(jvars, jnp.asarray(img), jnp.asarray(txt))
    with torch.inference_mode():
        tbox, tlog = tm.module(torch.from_numpy(img), torch.from_numpy(txt))
    np.testing.assert_allclose(tbox.numpy() / 64, np.asarray(jbox) / 64, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=ATOL, rtol=0)
    assert np.ptp(np.asarray(jlog)) > 0.1  # the comparison is not of constants


def test_v1_detections_match_jax(v1):
    """``predict_batch_frames_async`` + ``predict_finalize`` through the
    plain NMS: the packed top-k rows index for index, then the thresholded
    detections."""
    _sd, _jvars, jm, tm = v1
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    caption = "towel . chair"
    jh = jm.predict_batch_frames_async(jnp.asarray(frames), caption)
    th = tm.predict_batch_frames_async(torch.from_numpy(frames), caption)
    jp, tp = np.asarray(jh[0]), th[0].numpy()
    np.testing.assert_array_equal(tp[..., 0] < 0, jp[..., 0] < 0)
    np.testing.assert_array_equal(tp[..., 5], jp[..., 5])
    np.testing.assert_allclose(tp[..., 0], jp[..., 0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(tp[..., 1:5] / 64, jp[..., 1:5] / 64, atol=ATOL, rtol=0)
    thr = float(np.median(jp[..., 0][jp[..., 0] >= 0]))
    kept = 0
    for (jbx, jsc, jph), (tbx, tsc, tph) in zip(jm.predict_finalize(jh, thr),
                                                tm.predict_finalize(th, thr)):
        assert tph == jph
        kept += len(tph)
        np.testing.assert_allclose(tbx, jbx, atol=ATOL, rtol=0)
        np.testing.assert_allclose(tsc, jsc, atol=ATOL, rtol=0)
    assert kept > 0
