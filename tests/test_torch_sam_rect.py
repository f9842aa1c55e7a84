"""``BFF_SAM_RECT=1`` (rect encode: frames padded only to the patch multiple)
in the port against the JAX package.

SAM and EfficientSAM at their ``"test"`` presets with the same weights (JAX
parameters carried into the port), inputs from a numpy seed. Tolerances:
embeddings f32 within 1e-4; packed masks at IoU >= 0.999 per box; the 2D
stage's records at the seg2d bars (confidences within 1e-4, mask IoU >=
0.999). A full-square input gives the square path's embeddings bit for bit.

The JAX EfficientSAM's packed decode takes a full-square ``dense_pe()``
(``beyondff_tpu/models/efficientsam.py`` ``_decode_boxes_multi``) and raises
on a rect embedding; the port's follows the embedding grid as SAM's decode
does, so its EfficientSAM masks are held against the JAX modules' own
decode run with the grid's ``dense_pe``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.core import rle as jrle
from beyondff_tpu.models import efficientsam as jesam
from beyondff_tpu.models import sam as jsam
from beyondff_tpu.pipeline import segmentation_2d as jseg2d
from beyondff_tpu.utils import io as jio
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import efficientsam as tesam
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.models.gdino import model as tgdino
from beyondff_tpu_torch.pipeline import segmentation_2d as tseg2d

torch.set_num_threads(2)
cv2 = pytest.importorskip("cv2")
ATOL = 1e-4
BOXES = np.array([[2, 3, 30, 40], [10, 0, 63, 30], [0, 0, 64, 46], [20, 10, 60, 44]],
                 np.float32)


def _carry(make, params, fn, cfg):
    module = tlayers.build(make, torch.device("cpu"))
    module.load_state_dict(fn(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module


def _port(jm, kind):
    if kind == "sam":
        return tsam.SAM(jm.cfg, _carry(lambda: tsam.SAMModule(jm.cfg), jm.params,
                                       convert.sam_from_jax, jm.cfg))
    return tesam.EfficientSAM(jm.cfg, _carry(lambda: tsam.SAMModule(jm.cfg), jm.params,
                                             convert.efficientsam_from_jax, jm.cfg))


def _create(kind):
    """A fresh JAX model (it reads ``BFF_SAM_RECT`` when it first traces its
    encoder) and the port's copy."""
    jm = (jsam.SAM.create("test", seed=3) if kind == "sam"
          else jesam.EfficientSAM.create("test", seed=4))
    return jm, _port(jm, kind)


def _mask_ious(a, b):
    inter = np.logical_and(a, b).sum(-1)
    union = np.logical_or(a, b).sum(-1)
    return np.where(union == 0, 1.0, inter / np.maximum(union, 1))


def _jax_esam_rect_packed(jm, emb, boxes, input_hw, orig_hw):
    """The JAX package's packed decode steps (``SAM.decode_boxes_packed``)
    around EfficientSAM's best-of-multimask decode, with the dense PE of the
    embedding's grid (``dense_pe(gh, gw)``, as ``SAMModule.decode_boxes``)."""
    def decode(module, e, b):
        sparse = module.prompt.encode_boxes(b)
        dense_pe = module.prompt.dense_pe(e.shape[0], e.shape[1])
        no_mask = module.prompt.no_mask_embedding().astype(module.dtype)
        masks, iou = module.decoder(e + no_mask[None, None, :], dense_pe, sparse)
        best = jnp.argmax(iou, axis=1)
        rows = jnp.arange(masks.shape[0])
        return masks[rows, best], iou[rows, best]

    low, _iou = jm.module.apply(jm.params, emb, jnp.asarray(boxes), method=decode)
    k = low.shape[0]
    sh, sw = emb.shape[0] * jm.cfg.patch_size, emb.shape[1] * jm.cfg.patch_size
    x = jax.image.resize(low, (k, sh, sw), "bilinear")[:, :input_hw[0], :input_hw[1]]
    x = jax.image.resize(x, (k, *orig_hw), "bilinear")
    return np.asarray(x > 0).reshape(k, -1)


@pytest.mark.parametrize("kind", ["sam", "efficientsam"])
def test_full_square_input_rect_equals_square(kind, monkeypatch):
    """A frame that fills the square takes the same program: bit-equal."""
    _jm, tm = _create(kind)
    s = tm.cfg.img_size
    frames = torch.from_numpy(np.random.default_rng(1).integers(0, 255, (2, s, s, 3),
                                                                dtype=np.uint8))
    square = tm.encode_frames(frames)
    monkeypatch.setenv("BFF_SAM_RECT", "1")
    assert tm.padded_hw((s, s)) == (s, s)
    assert torch.equal(tm.encode_frames(frames), square)


@pytest.mark.parametrize("kind", ["sam", "efficientsam"])
def test_rect_embeddings_and_masks_match_jax(kind, monkeypatch):
    """A 30 x 41 frame scales to 47 x 64 for the 64-px presets: the rect
    grid is 6 x 8 patches. Embeddings within 1e-4 of the JAX package's; the
    packed masks of four boxes at IoU >= 0.999; unset, the square grid."""
    monkeypatch.setenv("BFF_SAM_RECT", "1")
    jm, tm = _create(kind)
    frame = np.random.default_rng(7).integers(0, 255, (30, 41, 3), dtype=np.uint8)
    small, input_hw = jm.scale_frame(frame)
    assert input_hw == (47, 64)
    je = np.asarray(jm.encode_frames(jnp.asarray(small[None])))
    te = tm.encode_frames(torch.from_numpy(small[None].copy()))
    assert je.shape[1:3] == te.shape[1:3] == (6, 8)
    np.testing.assert_allclose(te.numpy(), je, atol=ATOL, rtol=0)
    orig_hw = (30, 41)
    tpacked, _ = tm.decode_boxes_packed(torch.from_numpy(je.copy()), [0] * len(BOXES), BOXES,
                                        input_hw, orig_hw)
    n = orig_hw[0] * orig_hw[1]
    tbits = np.unpackbits(tpacked.numpy(), axis=-1, bitorder="little")[:, :n].astype(bool)
    if kind == "sam":
        jpacked, _ = jm.decode_boxes_packed(jnp.asarray(je), BOXES[None], input_hw, orig_hw)
        jbits = np.unpackbits(np.asarray(jpacked)[0], axis=-1,
                              bitorder="little")[:, :n].astype(bool)
    else:
        with pytest.raises(TypeError):  # the JAX package's full-square dense PE
            jm.decode_boxes_packed(jnp.asarray(je), BOXES[None], input_hw, orig_hw)
        jbits = _jax_esam_rect_packed(jm, jnp.asarray(je[0]), BOXES, input_hw, orig_hw)
    assert 0 < jbits.sum() < jbits.size
    assert _mask_ious(tbits, jbits).min() >= 0.999
    monkeypatch.delenv("BFF_SAM_RECT")
    assert tm.encode_frames(torch.from_numpy(small[None].copy())).shape[1:3] == (8, 8)


def test_run_writes_the_jax_records_under_rect(tmp_path, monkeypatch):
    """Both packages' ``run()`` on a 4-frame scene of 30 x 41 frames with
    ``BFF_SAM_RECT=1`` (SAM's 6 x 8 grid) write the same records."""
    h, w = 30, 41
    rng = np.random.default_rng(6)
    color = tmp_path / "scene0000_00" / "color"
    color.mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(color / f"{i}.jpg"), rng.integers(0, 255, (h, w, 3), dtype=np.uint8))

    def cfg_dict(tag):
        return {"paths": {"scene_2d_dir": str(tmp_path),
                          "mask_2d_dir": str(tmp_path / f"out_{tag}"),
                          "checkpoint_dir": str(tmp_path / f"ckpt_{tag}")},
                "frames": {"width_2d": w, "height_2d": h, "downsample_ratio": 1},
                "detector": {"box_threshold": -1.0, "must_match_query": False,
                             "similarity_threshold": -10.0, "dtype": "float32",
                             "frame_batch": 2}}

    monkeypatch.setenv("BFF_SAM_RECT", "1")
    monkeypatch.setenv("BFF_SEG2D_YUV", "0")
    jcfg = JConfig.from_dict(cfg_dict("jax"))
    jseg = jseg2d.Segmentor2D(jcfg)
    det_cfg, clip_cfg = jseg.detector.cfg, jseg.clip.cfg
    det = tgdino.GroundingDINO(det_cfg, _carry(lambda: tgdino.GDINOModule(det_cfg),
                                               jseg.detector.params, convert.gdino_from_jax,
                                               det_cfg))
    clip = tclip.CLIP(clip_cfg, _carry(lambda: tclip.CLIPModule(clip_cfg), jseg.clip.params,
                                       convert.clip_from_jax, clip_cfg))
    tcfg = TConfig.from_dict(cfg_dict("torch"))
    tseg = tseg2d.Segmentor2D(tcfg, detector=det, sam=_port(jseg.sam, "sam"), clip_model=clip,
                              device="cpu")
    cv2.ipp.setUseIPP(False)
    try:
        jseg2d.run(jcfg, "clothes", scenes=["scene0000_00"], segmentor=jseg)
    finally:
        cv2.ipp.setUseIPP(True)
    tseg2d.run(tcfg, "clothes", scenes=["scene0000_00"], segmentor=tseg)
    assert tseg.sam.padded_hw(tseg.sam.scaled_hw((h, w))) == (48, 64)
    jrec = jio.load_frame_records(os.path.join(tmp_path, "out_jax", "clothes",
                                               "scene0000_00.pth"))
    trec = jio.load_frame_records(os.path.join(tmp_path, "out_torch", "clothes",
                                               "scene0000_00.pth"))
    assert [r["frame_id"] for r in trec] == [r["frame_id"] for r in jrec] and len(jrec) == 4
    for t, j in zip(trec, jrec):
        assert t["labels"] == j["labels"]
        np.testing.assert_allclose(t["confidences"], j["confidences"], atol=1e-4, rtol=0)
    n_masks = 0
    for t, j in zip(jrle.decode_frame_masks(trec, image_shape=(h, w)),
                    jrle.decode_frame_masks(jrec, image_shape=(h, w))):
        tm = np.asarray(t["segmented_frame_masks"])[:, 0].reshape(-1, h * w).astype(bool)
        jm = np.asarray(j["segmented_frame_masks"])[:, 0].reshape(-1, h * w).astype(bool)
        assert _mask_ious(tm, jm).min() >= 0.999
        n_masks += len(tm)
    assert n_masks > 0
