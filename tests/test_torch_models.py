"""Port models (beyondff_tpu_torch.models) vs the JAX package's models.

Weights cross in both directions: a port module's ``state_dict`` saved with
``torch.save`` goes through the JAX package's checkpoint converter and comes
back through ``*_from_jax`` unchanged; a JAX model's parameters load into the
port module, and the two forwards agree at float32 within atol 5e-4, rtol
1e-3 (the bar of tests/test_full_model_parity.py). The full presets are
checked on ``meta`` against the official checkpoints' key listings.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyondff_tpu.models import clip as jclip
from beyondff_tpu.models import efficientsam as jesam
from beyondff_tpu.models import sam as jsam
from beyondff_tpu.models import yolo_world as jyw
from beyondff_tpu.models.gdino import GroundingDINO as JGroundingDINO
from beyondff_tpu.models.gdino import convert as jgconvert
from beyondff_tpu.models.layers import Attention as JAttention
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import efficientsam as tesam
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.models import yolo_world as tyw
from beyondff_tpu_torch.models.gdino import model as tgdino

torch.set_num_threads(2)
ATOL, RTOL = 5e-4, 1e-3
_FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _make(kind, preset):
    return {"gdino": lambda: tgdino.GDINOModule(tgdino.PRESETS[preset]),
            "sam": lambda: tsam.SAMModule(tsam.PRESETS[preset]),
            "clip": lambda: tclip.CLIPModule(tclip.PRESETS[preset]),
            "yolo_world": lambda: tyw.YOLOWorldModule(tyw.PRESETS[preset]),
            "efficientsam": lambda: tsam.SAMModule(tesam.PRESETS[preset])}[kind]


def _port(kind, preset, device="cpu"):
    return tlayers.build(_make(kind, preset), torch.device(device), seed=3)


def _jax_convert(kind, path, cfg):
    if kind == "gdino":
        return jgconvert.convert_torch_checkpoint(path, cfg)
    return {"sam": jsam, "clip": jclip, "yolo_world": jyw,
            "efficientsam": jesam}[kind].convert_torch_checkpoint(path, cfg)


_FROM_JAX = {"gdino": convert.gdino_from_jax, "sam": convert.sam_from_jax,
             "clip": convert.clip_from_jax, "yolo_world": convert.yolo_world_from_jax,
             "efficientsam": convert.efficientsam_from_jax}
KINDS = ["gdino", "sam", "clip", "yolo_world", "efficientsam"]


@pytest.mark.parametrize("kind", KINDS)
def test_weights_round_trip_through_jax_converter(tmp_path, kind):
    module = _port(kind, "test")
    sd = module.state_dict()
    path = str(tmp_path / f"{kind}.pth")
    torch.save({k: v.clone() for k, v in sd.items()}, path)
    params = _jax_convert(kind, path, module.cfg)
    back = _FROM_JAX[kind](_np_tree(params), module.cfg)
    assert set(back) == set(sd)
    for key, val in sd.items():
        assert torch.equal(back[key], val), key
    module.load_state_dict(back)


_IGNORE = {
    "gdino": jgconvert.IGNORED_CHECKPOINT_KEYS,
    "sam": (r"^prompt_encoder\.mask_downscaling\.", r"num_batches_tracked$"),
    "clip": (r"^input_resolution$", r"^context_length$", r"^vocab_size$"),
    "yolo_world": tyw.IGNORED_CHECKPOINT_KEYS,
    "efficientsam": (r"^prompt_encoder\.mask_downscaling\.", r"num_batches_tracked$"),
}
_FULL = {"gdino": ("swinb", "gdino_swinb"), "sam": ("vit_h", "sam_vit_h"),
         "clip": ("ViT-L/14", "clip_vit_l14"), "yolo_world": ("l", "yolo_world_l"),
         "efficientsam": ("vits", "efficientsam_vits")}


@pytest.mark.parametrize("kind", KINDS)
def test_full_preset_keys_match_official_checkpoint(kind):
    preset, fixture = _FULL[kind]
    with torch.device("meta"):
        keys = set(_make(kind, preset)().state_dict())
    with open(os.path.join(_FIX, f"{fixture}_keys.txt")) as f:
        official = {k for k in f.read().splitlines() if k}
    pats = [re.compile(p) for p in _IGNORE[kind]]
    official = {k for k in official if not any(p.search(k) for p in pats)}
    assert keys == official, (sorted(keys - official)[:10], sorted(official - keys)[:10])


def _loaded(kind, jmodel):
    module = _port(kind, "test")
    module.load_state_dict(_FROM_JAX[kind](_np_tree(jmodel.params), module.cfg))
    return module


@pytest.mark.parametrize("windowed", ["0", "1"])
def test_gdino_forward_matches_jax(rng, monkeypatch, windowed):
    """Logits and boxes of the ``"test"`` preset, with the encoder's
    deformable sampling exact and (BFF_DEFORM_WINDOWED=1) in clamp mode."""
    monkeypatch.setenv("BFF_DEFORM_WINDOWED", windowed)
    jm = JGroundingDINO.create("test", seed=7)
    tm = _loaded("gdino", jm)
    gh, gw = jm.cfg.image_size
    img = rng.normal(size=(2, gh, gw, 3)).astype(np.float32)
    t = 7
    ids = rng.integers(5, jm.cfg.bert.vocab_size, (2, t)).astype(np.int32)
    ids[:, 0], ids[:, 3], ids[:, -1] = 2, 4, 3
    pad = np.ones((2, t), bool)
    pad[1, -2:] = False
    from beyondff_tpu.models.gdino import bert as jbert

    sm, pos = jbert.subsentence_masks(ids, [4], 2, 3)
    jl, jb = jm.module.apply(jm.params, jnp.asarray(img), jnp.asarray(ids), jnp.asarray(sm),
                             jnp.asarray(pad), jnp.asarray(pos))
    with torch.inference_mode():
        tl, tb = tm(torch.from_numpy(img), torch.from_numpy(ids).long(), torch.from_numpy(sm),
                    torch.from_numpy(pad), torch.from_numpy(pos).long())
    jl, tl = np.asarray(jl), tl.numpy()
    valid = np.broadcast_to(pad[:, None, :], jl.shape)
    np.testing.assert_allclose(tl[valid], jl[valid], atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tl[~valid], jl[~valid])
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=ATOL, rtol=RTOL)


def test_gdino_wrapper_predict_matches_jax(rng):
    """The device-frames entry (on-device bilinear resize, normalize, forward,
    top-K packing) against the JAX wrapper's same path."""
    jm = JGroundingDINO.create("test", seed=5)
    tm = tgdino.GroundingDINO(jm.cfg, _loaded("gdino", jm))
    frames = rng.integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    jh = jm.predict_batch_frames_async(jnp.asarray(frames), "a red chair . clothes")
    th = tm.predict_batch_frames_async(torch.from_numpy(frames), "a red chair . clothes")
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jh[0]), atol=ATOL, rtol=RTOL)
    for (jb, js, jp), (tb, ts, tp) in zip(jm.predict_finalize(jh, 0.0, 0.5),
                                          tm.predict_finalize(th, 0.0, 0.5)):
        np.testing.assert_allclose(tb, jb, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(ts, js, atol=ATOL, rtol=RTOL)
        assert tp == jp


def test_stable_topk_orders_ties_like_lax_top_k():
    scores = np.array([[0.5, 0.9, 0.5, 0.1, 0.9, 0.5, 0.9]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(scores), 5)
    tv, ti = tgdino.stable_topk(torch.from_numpy(scores), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sam_encode_and_decode_match_jax(rng):
    jm = jsam.SAM.create("test", seed=5)
    tm = tsam.SAM(jm.cfg, _loaded("sam", jm))
    s = jm.cfg.img_size
    x = rng.normal(size=(2, s, s, 3)).astype(np.float32)
    je = np.asarray(jm.encode_image(x))
    with torch.inference_mode():
        te = tm.module.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(te, je, atol=ATOL, rtol=RTOL)
    boxes = np.array([[3, 4, 40, 50], [10, 0, 63, 30], [0, 0, 64, 64]], np.float32)
    jmask, jiou = jm.decode_boxes(jnp.asarray(je[1]), boxes)
    tmask, tiou = tm.decode_boxes(torch.from_numpy(je[1].copy()), boxes)
    np.testing.assert_allclose(tmask.numpy(), np.asarray(jmask), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou), atol=ATOL, rtol=RTOL)


def test_sam_encode_frames_matches_jax(rng):
    """uint8 frames smaller than the square: pad + normalize + mask on device."""
    jm = jsam.SAM.create("test", seed=2)
    tm = tsam.SAM(jm.cfg, _loaded("sam", jm))
    frames = rng.integers(0, 255, (2, 48, 64, 3), dtype=np.uint8)
    je = np.asarray(jm.encode_frames(jnp.asarray(frames)))
    te = tm.encode_frames(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(te, je, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("orig_hw", [(40, 56), (24, 30), (30, 24), (48, 64), (80, 100)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_sam_decode_boxes_packed_matches_jax(rng, orig_hw):
    """The packed masks of a frame batch, bit for bit. A frame whose long
    side is below ``img_size`` (64) shrinks in the second resize, where
    ``jax.image.resize`` antialiases; 48x64 keeps its size, 80x100 grows."""
    jm = jsam.SAM.create("test", seed=5)
    tm = tsam.SAM(jm.cfg, _loaded("sam", jm))
    h, w = orig_hw
    s = jm.cfg.img_size
    input_hw = (int(h * s / max(h, w) + 0.5), int(w * s / max(h, w) + 0.5))
    frames = rng.integers(0, 255, (2, *input_hw, 3), dtype=np.uint8)
    embs = np.asarray(jm.encode_frames(jnp.asarray(frames)))
    boxes = np.array([[3, 4, 40, 50], [10, 0, 63, 30], [0, 0, 64, 64]], np.float32)
    jpacked, jiou = jm.decode_boxes_packed(jnp.asarray(embs), np.stack([boxes, boxes[::-1]]),
                                           input_hw, orig_hw)
    tpacked, tiou = tm.decode_boxes_packed(torch.from_numpy(embs), [0, 0, 0, 1, 1, 1],
                                           np.concatenate([boxes, boxes[::-1]]), input_hw,
                                           orig_hw)
    jbits = np.unpackbits(np.asarray(jpacked).reshape(6, -1), axis=-1, bitorder="little")
    tbits = np.unpackbits(tpacked.numpy(), axis=-1, bitorder="little")
    assert 0 < jbits[:, :h * w].sum() < jbits[:, :h * w].size
    np.testing.assert_array_equal(tbits, jbits)
    np.testing.assert_allclose(tiou.numpy(), np.asarray(jiou).reshape(-1), atol=ATOL, rtol=RTOL)


def test_clip_image_and_text_features_match_jax(rng):
    jm = jclip.CLIP.create("test", seed=4)
    tm = tclip.CLIP(jm.cfg, _loaded("clip", jm))
    n = jm.cfg.image_resolution
    crops = rng.integers(0, 255, (3, n, n, 3), dtype=np.uint8)
    np.testing.assert_allclose(tm.encode_image(crops).numpy(),
                               np.asarray(jm.encode_image(crops)), atol=ATOL, rtol=RTOL)
    toks = rng.integers(1, jm.cfg.vocab_size - 1, (4, jm.cfg.context_length)).astype(np.int32)
    toks[:, 5] = jm.cfg.vocab_size - 1  # EOT
    np.testing.assert_allclose(tm.encode_text(toks).numpy(),
                               np.asarray(jm.encode_text(toks)), atol=ATOL, rtol=RTOL)


def test_attention_long_sequence_matches_jax(rng):
    """layers.Attention at S = 600 (the length class that routes to the
    flash kernel on the card), separate query/key/value inputs."""
    dim, heads = 32, 4
    q = rng.normal(size=(2, 600, dim)).astype(np.float32)
    v = rng.normal(size=(2, 600, dim)).astype(np.float32)
    jmod = JAttention(heads)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(q), kv=jnp.asarray(q),
                       v=jnp.asarray(v))
    want = np.asarray(jmod.apply(params, jnp.asarray(q), kv=jnp.asarray(q), v=jnp.asarray(v)))
    w = convert._Writer()
    w.mha("attn", _np_tree(params)["params"])
    tmod = tlayers.Attention(dim, heads)
    tmod.load_state_dict({k[len("attn."):]: val for k, val in w.sd.items()})
    with torch.inference_mode():
        got = tmod(torch.from_numpy(q), kv=torch.from_numpy(q), v=torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# ------------------------------------------------ SAM attention kernel branches
def _vit_attention_pair(rng, use_rel_pos, hw, dim=64, heads=2):
    """A JAX ``ViTAttention`` with random parameters (rel-pos tables too:
    zeros would hide bias errors) and the port's, carrying the same weights."""
    jattn = jsam.ViTAttention(num_heads=heads, use_rel_pos=use_rel_pos, input_hw=hw,
                              dtype=jnp.float32)
    x = rng.normal(size=(1, *hw, dim)).astype(np.float32)
    params = jattn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape, scale=0.1).astype(np.float32)), params)
    p = _np_tree(params)["params"]
    w = convert._Writer()
    w.dense("qkv", p["qkv"])
    w.dense("proj", p["proj"])
    if use_rel_pos:
        w.raw("rel_pos_h", p["rel_pos_h"])
        w.raw("rel_pos_w", p["rel_pos_w"])
    tattn = tsam.ViTAttention(dim, heads, use_rel_pos, hw, softmax_f32=True)
    tattn.load_state_dict(w.sd)
    return jattn, params, tattn, x


def _force_kernel_branches(monkeypatch, calls):
    """Both packages take their kernel branches on the CPU: the JAX side with
    ``on_tpu`` forced and its Pallas kernels in interpret mode, the port with
    its card test forced (its wrappers then take the plain versions)."""
    from beyondff_tpu.kernels import dispatch as jdispatch
    from beyondff_tpu.kernels import flash_attention as jfa

    monkeypatch.setattr(jdispatch, "on_tpu", lambda: True)
    for name in ("attend", "attend_relpos"):
        real = getattr(jfa, name)
        monkeypatch.setattr(jfa, name, lambda *a, _f=real, **k: _f(*a, interpret=True, **k))
        port = getattr(tsam.fa, name)
        monkeypatch.setattr(tsam.fa, name,
                            lambda *a, _f=port, _n=name, **k: calls.append(_n) or _f(*a, **k))
    monkeypatch.setattr(tsam, "_kernel_path", lambda t: True)


@pytest.mark.parametrize("use_rel_pos", [True, False])
def test_sam_attention_kernel_branches_match_jax(rng, monkeypatch, use_rel_pos):
    """The port's ``ViTAttention`` kernel branches, forced on the CPU,
    against the JAX branches forced in interpret mode on a 16 x 32 global
    grid (512 tokens): with rel-pos and ``BFF_SAM_RELPOS_FLASH`` the
    rel-pos flash kernel (K4), without rel-pos the flash kernel (K2/K3)."""
    monkeypatch.setenv("BFF_SAM_RELPOS_FLASH", "1")
    jattn, params, tattn, x = _vit_attention_pair(rng, use_rel_pos, (16, 32))
    calls = []
    _force_kernel_branches(monkeypatch, calls)
    want = np.asarray(jattn.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = tattn(torch.from_numpy(x)).numpy()
    assert calls == ["attend_relpos" if use_rel_pos else "attend"]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_sam_attention_takes_no_kernel_branch_by_default(rng, monkeypatch):
    """On the CPU (no forcing) and, on the card, without
    ``BFF_SAM_RELPOS_FLASH``, rel-pos attention stays dense."""
    monkeypatch.delenv("BFF_SAM_RELPOS_FLASH", raising=False)
    jattn, params, tattn, x = _vit_attention_pair(rng, True, (16, 32))
    calls = []
    monkeypatch.setattr(tsam.fa, "attend_relpos", lambda *a, **k: calls.append(1))
    with torch.inference_mode():
        got = tattn(torch.from_numpy(x)).numpy()
    monkeypatch.setattr(tsam, "_kernel_path", lambda t: True)
    with torch.inference_mode():
        tattn(torch.from_numpy(x))
    assert calls == []
    np.testing.assert_allclose(got, np.asarray(jattn.apply(params, jnp.asarray(x))),
                               rtol=2e-4, atol=2e-5)


def test_sam_encoder_with_relpos_flash_matches_jax(rng, monkeypatch):
    """A small SAM whose global block runs a 32 x 32 grid (1024 tokens, where
    ``relpos_shapes_ok`` holds) with ``BFF_SAM_RELPOS_FLASH`` set: the port's
    encoder with its kernel branches forced against the JAX encoder with its
    Pallas branch forced in interpret mode."""
    cfg = jsam.SAMConfig(img_size=256, patch_size=8, encoder_dim=32, encoder_depth=2,
                         encoder_heads=2, window_size=8, global_attn_indexes=(1,),
                         prompt_dim=32, decoder_mlp_dim=64)
    jm = jsam.SAM.create(cfg, seed=9)
    jm.params = jax.tree_util.tree_map_with_path(
        lambda path, p: (jnp.asarray(rng.normal(size=p.shape, scale=0.1).astype(np.float32))
                         if "rel_pos" in jax.tree_util.keystr(path) else p), jm.params)
    module = tlayers.build(lambda: tsam.SAMModule(tsam.SAMConfig(**vars(cfg))),
                           torch.device("cpu"))
    module.load_state_dict(convert.sam_from_jax(_np_tree(jm.params), module.cfg))
    monkeypatch.setenv("BFF_SAM_RELPOS_FLASH", "1")
    calls = []
    _force_kernel_branches(monkeypatch, calls)
    x = rng.normal(size=(1, 256, 256, 3)).astype(np.float32)
    want = np.asarray(jm.encode_image(x))
    with torch.inference_mode():
        got = module.encode(torch.from_numpy(x)).numpy()
    assert calls == ["attend_relpos"]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
