"""The port's checkpoint loaders and tokenizers vs the JAX package's.

Files are written by the tests in the official layouts: Grounding-DINO as
``{"model": {"module." + key: tensor}}`` with the keys the converters ignore
(BERT pooler, duplicate ``bbox_embed`` heads, ``position_ids``, Swin index
tables), SAM as a plain state dict with the mask-prompt stack, CLIP as an
fp16 TorchScript archive with OpenAI's three scalars. Each is read by the
port's loader and by the JAX package's converter; the loaded port module
agrees with the JAX model at float32 within atol 5e-4, rtol 1e-3. The
official transformers architectures, randomized at small configs, cross
through both packages' ``hf_compat`` renamers. The 2D stage runs from
configured checkpoint files in both packages, with the full-width presets
replaced by small ones in this test only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from beyondff_tpu.config import Config as JConfig
from beyondff_tpu.core import rle as jrle
from beyondff_tpu.models import clip as jclip
from beyondff_tpu.models import hf_compat as jhf
from beyondff_tpu.models import sam as jsam
from beyondff_tpu.models import tokenizers as jtok
from beyondff_tpu.models.gdino import convert as jgconvert
from beyondff_tpu.models.gdino import model as jgdino
from beyondff_tpu.pipeline import segmentation_2d as jseg2d
from beyondff_tpu.pipeline import text_sim as jtext_sim
from beyondff_tpu.utils import io as jio
from beyondff_tpu_torch.config import Config as TConfig
from beyondff_tpu_torch.models import clip as tclip
from beyondff_tpu_torch.models import convert
from beyondff_tpu_torch.models import hf_compat as thf
from beyondff_tpu_torch.models import layers as tlayers
from beyondff_tpu_torch.models import sam as tsam
from beyondff_tpu_torch.models import tokenizers as ttok
from beyondff_tpu_torch.models.convert_util import ConversionError
from beyondff_tpu_torch.models.gdino import bert as tbert
from beyondff_tpu_torch.models.gdino import convert as tgconvert
from beyondff_tpu_torch.models.gdino import model as tgdino
from beyondff_tpu_torch.models.gdino import swin as tswin
from beyondff_tpu_torch.pipeline import segmentation_2d as tseg2d
from beyondff_tpu_torch.pipeline import text_sim as ttext_sim
from beyondff_tpu_torch.tools import segmentation_2d as tseg2d_cli

torch.set_num_threads(2)
ATOL, RTOL = 5e-4, 1e-3
CPU = torch.device("cpu")
KINDS = ["gdino", "sam", "clip"]


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _module(kind, cfg, seed=3):
    make = {"gdino": lambda: tgdino.GDINOModule(cfg), "sam": lambda: tsam.SAMModule(cfg),
            "clip": lambda: tclip.CLIPModule(cfg)}[kind]
    return tlayers.build(make, CPU, seed=seed)


def _preset(kind):
    return {"gdino": tgdino.PRESETS, "sam": tsam.PRESETS, "clip": tclip.PRESETS}[kind]["test"]


def _extras(kind, sd, cfg):
    """Keys the official files carry beside the module's, all ignored."""
    g = torch.Generator().manual_seed(1)
    if kind == "gdino":
        h = cfg.bert.hidden
        out = {"bert.pooler.dense.weight": torch.randn(h, h, generator=g),
               "bert.pooler.dense.bias": torch.randn(h, generator=g),
               "bert.embeddings.position_ids": torch.arange(cfg.bert.max_position)[None],
               "backbone.0.layers.0.blocks.0.attn.relative_position_index":
                   torch.zeros(cfg.swin.window_size ** 2, cfg.swin.window_size ** 2,
                               dtype=torch.long)}
        head = {k[len("bbox_embed.0."):]: v for k, v in sd.items()
                if k.startswith("bbox_embed.0.")}
        for i in range(cfg.dec_layers + 1):
            for k, v in head.items():
                if i:
                    out[f"bbox_embed.{i}.{k}"] = v.clone()
                out[f"transformer.decoder.bbox_embed.{i}.{k}"] = v.clone()
        return out
    if kind == "sam":
        d = cfg.prompt_dim
        return {"prompt_encoder.mask_downscaling.0.weight": torch.randn(4, 1, 2, 2, generator=g),
                "prompt_encoder.mask_downscaling.0.bias": torch.randn(4, generator=g),
                "prompt_encoder.mask_downscaling.6.weight": torch.randn(d, 16, 1, 1, generator=g)}
    return {"input_resolution": torch.tensor(cfg.image_resolution),
            "context_length": torch.tensor(cfg.context_length),
            "vocab_size": torch.tensor(cfg.vocab_size)}


def _write(kind, state, path, cfg):
    """``state`` in the official file layout of ``kind``, with its extras."""
    sd = {k: v.clone() for k, v in state.items()}
    sd.update(_extras(kind, sd, cfg))
    if kind == "gdino":
        torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)
    elif kind == "sam":
        torch.save(sd, path)
    else:
        tclip.save_torchscript_archive({k: v.half() if v.is_floating_point() else v
                                        for k, v in sd.items()}, path)
    return path


def _load(kind, path, cfg, dtype=torch.float32):
    if kind == "gdino":
        return tgconvert.load_torch_checkpoint(path, cfg, dtype, CPU)
    if kind == "sam":
        return tsam.load_torch_checkpoint(path, cfg, dtype, CPU)
    return tclip.load(_clip_preset(cfg), path, dtype=dtype, device=CPU)[0].module


def _clip_preset(cfg):
    return next(k for k, v in tclip.PRESETS.items() if v == cfg)


def _jax_convert(kind, path, cfg):
    if kind == "gdino":
        return jgconvert.convert_torch_checkpoint(path, cfg)
    if kind == "sam":
        return jsam.convert_torch_checkpoint(path, cfg)
    return jclip.convert_torch_checkpoint(path, cfg)


_FROM_JAX = {"gdino": convert.gdino_from_jax, "sam": convert.sam_from_jax,
             "clip": convert.clip_from_jax}


def _official_file(kind, tmp_path):
    """(source state dict, file) in the official layout; CLIP's source is
    fp16-rounded, as its archive stores it."""
    cfg = _preset(kind)
    sd = _module(kind, cfg).state_dict()
    if kind == "clip":
        sd = {k: v.half().float() for k, v in sd.items()}
    return sd, _write(kind, sd, str(tmp_path / f"{kind}.pth"), cfg)


@pytest.mark.parametrize("kind", KINDS)
def test_loader_gives_the_written_state_dict(tmp_path, kind):
    """Wrapper, ``module.`` prefix and ignored extras included: the loaded
    module's state dict is the written one exactly, and it has the buffers
    a built module has."""
    sd, path = _official_file(kind, tmp_path)
    module = _load(kind, path, _preset(kind))
    got = module.state_dict()
    assert set(got) == set(sd)
    for key, val in sd.items():
        assert torch.equal(got[key], val), key
    built = _module(kind, _preset(kind))
    assert [n for n, _ in module.named_buffers()] == [n for n, _ in built.named_buffers()]
    for (_, a), (_, b) in zip(module.named_buffers(), built.named_buffers()):
        assert torch.equal(a, b)
    assert not module.training and not any(p.requires_grad for p in module.parameters())


@pytest.mark.parametrize("kind", KINDS)
def test_loader_agrees_with_jax_converter(tmp_path, kind):
    """The JAX converter reads the same file; its tree carried back through
    ``*_from_jax`` is the loaded module's state dict, key for key."""
    cfg = _preset(kind)
    _, path = _official_file(kind, tmp_path)
    got = _load(kind, path, cfg).state_dict()
    back = _FROM_JAX[kind](_np_tree(_jax_convert(kind, path, cfg)), cfg)
    assert set(back) == set(got)
    for key, val in got.items():
        assert torch.equal(back[key], val), key


def _gdino_forward_pair(jm, tm, rng):
    gh, gw = jm.cfg.image_size
    img = rng.normal(size=(2, gh, gw, 3)).astype(np.float32)
    ids = rng.integers(5, jm.cfg.bert.vocab_size, (2, 7)).astype(np.int32)
    ids[:, 0], ids[:, 3], ids[:, -1] = 2, 4, 3
    pad = np.ones((2, 7), bool)
    pad[1, -2:] = False
    sm, pos = tbert.subsentence_masks(ids, [4], 2, 3)
    jl, jb = jm.module.apply(jm.params, jnp.asarray(img), jnp.asarray(ids), jnp.asarray(sm),
                             jnp.asarray(pad), jnp.asarray(pos))
    with torch.inference_mode():
        tl, tb = tm(torch.from_numpy(img), torch.from_numpy(ids).long(), torch.from_numpy(sm),
                    torch.from_numpy(pad), torch.from_numpy(pos).long())
    valid = np.broadcast_to(pad[:, None, :], np.shape(jl))
    return [(tl.numpy()[valid], np.asarray(jl)[valid]), (tb.numpy(), np.asarray(jb))]


def _sam_forward_pair(jm, tm, rng):
    s = jm.cfg.img_size
    x = rng.normal(size=(2, s, s, 3)).astype(np.float32)
    je = np.asarray(jm.encode_image(x))
    with torch.inference_mode():
        te = tm.encode(torch.from_numpy(x)).numpy()
    boxes = np.array([[3, 4, 40, 50], [10, 0, 63, 30]], np.float32)
    jmask, jiou = jm.decode_boxes(jnp.asarray(je[1]), boxes)
    tmask, tiou = tsam.SAM(tm.cfg, tm).decode_boxes(torch.from_numpy(je[1].copy()), boxes)
    return [(te, je), (tmask.numpy(), np.asarray(jmask)), (tiou.numpy(), np.asarray(jiou))]


def _clip_forward_pair(jm, tm, rng):
    n = jm.cfg.image_resolution
    crops = rng.integers(0, 255, (3, n, n, 3), dtype=np.uint8)
    toks = rng.integers(1, jm.cfg.vocab_size - 1, (2, jm.cfg.context_length)).astype(np.int32)
    toks[:, 5] = jm.cfg.vocab_size - 1
    wrapper = tclip.CLIP(tm.cfg, tm)
    return [(wrapper.encode_image(crops).numpy(), np.asarray(jm.encode_image(crops))),
            (wrapper.encode_text(toks).numpy(), np.asarray(jm.encode_text(toks)))]


@pytest.mark.parametrize("kind", KINDS)
def test_loaded_forward_matches_jax(tmp_path, monkeypatch, rng, kind):
    monkeypatch.setenv("BFF_DEFORM_WINDOWED", "0")
    _, path = _official_file(kind, tmp_path)
    tm = _load(kind, path, _preset(kind))
    params = _jax_convert(kind, path, _preset(kind))
    if kind == "gdino":
        pairs = _gdino_forward_pair(jgdino.GroundingDINO(jgdino.PRESETS["test"], params, None),
                                    tm, rng)
    elif kind == "sam":
        pairs = _sam_forward_pair(jsam.SAM(jsam.PRESETS["test"], params), tm, rng)
    else:
        pairs = _clip_forward_pair(jclip.CLIP(jclip.PRESETS["test"], params), tm, rng)
    for got, want in pairs:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


_CORRUPT = {"gdino": ("transformer.encoder.layers.0.bogus.weight",
                      "transformer.enc_output.bias", "feat_map.weight"),
            "sam": ("image_encoder.blocks.0.attn.bogus",
                    "mask_decoder.iou_token.weight", "image_encoder.pos_embed"),
            "clip": ("visual.bogus", "ln_final.bias", "token_embedding.weight")}


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
@pytest.mark.parametrize("kind", KINDS)
def test_bad_checkpoint_raises_naming_the_key(tmp_path, kind, fault):
    """A leftover key no ignore pattern covers, a key the module needs, and
    a wrong shape each raise ``ConversionError`` naming the key."""
    cfg = _preset(kind)
    sd = dict(_module(kind, cfg).state_dict())
    key = _CORRUPT[kind][("extra", "missing", "shape").index(fault)]
    if fault == "extra":
        sd[key] = torch.zeros(3)
    elif fault == "missing":
        del sd[key]
    else:
        sd[key] = torch.zeros(*sd[key].shape[:-1], sd[key].shape[-1] + 1)
    path = _write(kind, sd, str(tmp_path / f"{kind}.pth"), cfg)
    with pytest.raises(ConversionError, match=key.replace(".", r"\.")):
        _load(kind, path, cfg)


def test_clip_fp16_archive_loads_the_rounded_source(tmp_path):
    """An fp16 TorchScript archive of float32 weights loads as their fp16
    rounding, at float32 and after the bfloat16 cast (fp16 -> f32 -> bf16),
    as the JAX converter reads it; a plain ``torch.save`` file also loads."""
    cfg = tclip.PRESETS["test"]
    sd = _module("clip", cfg, seed=9).state_dict()
    path = _write("clip", sd, str(tmp_path / "ViT-test.pt"), cfg)
    assert torch.jit.load(path).state_dict()["visual.proj"].dtype == torch.float16
    for dtype in (torch.float32, torch.bfloat16):
        got = _load("clip", path, cfg, dtype).state_dict()
        for key, val in sd.items():
            assert torch.equal(got[key], val.half().float().to(dtype)), key
    jparams = _np_tree(jclip.convert_torch_checkpoint(path, cfg))
    np.testing.assert_array_equal(jparams["params"]["visual"]["proj"],
                                  sd["visual.proj"].half().float().numpy())
    plain = str(tmp_path / "plain.pth")
    torch.save({**sd, **_extras("clip", sd, cfg)}, plain)
    got = _load("clip", plain, cfg).state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())


@pytest.mark.parametrize("kind", KINDS)
def test_missing_checkpoint_file_raises(tmp_path, kind):
    """A configured path that does not exist raises in every loader and in
    the stage (the JAX stage builds a random SAM instead)."""
    path = str(tmp_path / "absent.pth")
    with pytest.raises(FileNotFoundError, match="absent.pth"):
        _load(kind, path, _preset(kind))
    cfg = TConfig.from_dict({"detector": {f"{kind}_checkpoint": path, "dtype": "float32"}})
    with pytest.raises(FileNotFoundError, match="absent.pth"):
        tseg2d.Segmentor2D(cfg, device="cpu")


# ------------------------------------------------------------ HF layouts
def _randomize(model, rng, std=0.15):
    """tests/test_full_model_parity.py's fill: non-degenerate random
    parameters, norm scales near 1."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            vals = rng.normal(0.0, std, p.shape).astype(np.float32)
            if name.endswith(".weight") and p.ndim == 1:
                vals = 1.0 + 0.1 * vals
            p.copy_(torch.from_numpy(vals))
    return model


def _renamed_alike(hf_sd, port_fn, jax_fn):
    """The port's renamer output equals the JAX package's, key for key."""
    got = port_fn({k: v.clone() for k, v in hf_sd.items()})
    want = jax_fn({k: v.clone() for k, v in hf_sd.items()})
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    return got


def test_clip_hf_layout_loads_and_matches_official(rng, tmp_path, monkeypatch):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.CLIPConfig(
        projection_dim=32,
        text_config={"vocab_size": 64, "hidden_size": 32, "num_hidden_layers": 2,
                     "num_attention_heads": 2, "intermediate_size": 128,
                     "max_position_embeddings": 16, "eos_token_id": 63,
                     "hidden_act": "quick_gelu"},
        vision_config={"hidden_size": 32, "num_hidden_layers": 2, "num_attention_heads": 2,
                       "intermediate_size": 128, "image_size": 28, "patch_size": 14,
                       "hidden_act": "quick_gelu"},
    )
    hf = _randomize(transformers.CLIPModel(hf_cfg).eval(), rng)
    sd = _renamed_alike(hf.state_dict(), thf.clip_hf_to_original, jhf.clip_hf_to_original)
    path = str(tmp_path / "clip.pth")
    torch.save(sd, path)
    monkeypatch.setitem(tclip.PRESETS, "hf-test", tclip.CLIPConfig(
        embed_dim=32, image_resolution=28, vision_layers=2, vision_width=32, vision_heads=2,
        vision_patch=14, context_length=16, vocab_size=64, text_width=32, text_heads=2,
        text_layers=2))
    module = tclip.load("hf-test", path, device="cpu")[0].module
    imgs = rng.normal(size=(2, 28, 28, 3)).astype(np.float32)
    toks = np.array([[5, 9, 12, 30, 63, 0, 0, 0], [5, 21, 63, 0, 0, 0, 0, 0]], np.int64)
    with torch.no_grad():
        want_img = hf.get_image_features(pixel_values=torch.from_numpy(
            imgs.transpose(0, 3, 1, 2))).numpy()
        want_txt = hf.get_text_features(input_ids=torch.from_numpy(toks)).numpy()
        got_img = module.encode_image(torch.from_numpy(imgs)).numpy()
        got_txt = module.encode_text(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got_img, want_img, atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(got_txt, want_txt, atol=1e-4, rtol=1e-3)


def test_sam_hf_layout_loads_and_matches_official(rng, tmp_path):
    transformers = pytest.importorskip("transformers")
    img_size, patch = 64, 8
    hf_cfg = transformers.SamConfig(
        vision_config={"hidden_size": 32, "num_hidden_layers": 3, "num_attention_heads": 2,
                       "image_size": img_size, "patch_size": patch, "window_size": 4,
                       "global_attn_indexes": [1], "output_channels": 32,
                       "num_pos_feats": 16, "mlp_dim": 128, "use_abs_pos": True,
                       "use_rel_pos": True},
        prompt_encoder_config={"hidden_size": 32, "image_size": img_size, "patch_size": patch,
                               "mask_input_channels": 4,
                               "image_embedding_size": img_size // patch},
        mask_decoder_config={"hidden_size": 32, "num_attention_heads": 2, "mlp_dim": 64,
                             "iou_head_hidden_dim": 32},
    )
    hf = _randomize(transformers.SamModel(hf_cfg).eval(), rng)
    sd = _renamed_alike(hf.state_dict(), thf.sam_hf_to_original, jhf.sam_hf_to_original)
    path = str(tmp_path / "sam.pth")
    torch.save(sd, path)
    cfg = tsam.SAMConfig(img_size=img_size, patch_size=patch, encoder_dim=32, encoder_depth=3,
                         encoder_heads=2, window_size=4, global_attn_indexes=(1,),
                         prompt_dim=32, decoder_heads=2, decoder_mlp_dim=64)
    module = tsam.load_torch_checkpoint(path, cfg, device="cpu")

    imgs = rng.normal(size=(1, img_size, img_size, 3)).astype(np.float32)
    boxes = np.array([[4.0, 6.0, 40.0, 50.0], [10.0, 2.0, 30.0, 60.0]], np.float32)
    with torch.no_grad():
        want_emb = hf.vision_encoder(torch.from_numpy(imgs.transpose(0, 3, 1, 2))
                                     ).last_hidden_state
        out = hf(image_embeddings=want_emb, input_boxes=torch.from_numpy(boxes[None]),
                 multimask_output=False)
        got_emb = module.encode(torch.from_numpy(imgs))
    np.testing.assert_allclose(got_emb.numpy().transpose(0, 3, 1, 2), want_emb.numpy(),
                               atol=1e-4, rtol=1e-3)
    got_masks, got_iou = tsam.SAM(cfg, module).decode_boxes(got_emb[0], boxes)
    np.testing.assert_allclose(got_iou.numpy(), out.iou_scores[0, :, 0].numpy(),
                               atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got_masks.numpy(), out.pred_masks[0, :, 0].numpy(),
                               atol=2e-4, rtol=1e-3)


def test_gdino_hf_layout_loads_and_matches_official(rng, tmp_path):
    """The whole Grounding-DINO forward against the official architecture at
    tests/test_full_model_parity.py's config, weights renamed by both
    packages' ``hf_compat`` and read by the port's loader."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.grounding_dino.modeling_grounding_dino import (
        GroundingDinoForObjectDetection,
    )

    hf_swin = transformers.SwinConfig(image_size=128, patch_size=4, embed_dim=16,
                                      depths=[1, 1, 2, 1], num_heads=[2, 2, 2, 2],
                                      window_size=4, drop_path_rate=0.0,
                                      out_features=["stage2", "stage3", "stage4"])
    hf_text = transformers.BertConfig(vocab_size=2000, hidden_size=32, num_hidden_layers=2,
                                      num_attention_heads=2, intermediate_size=64,
                                      max_position_embeddings=32, hidden_dropout_prob=0.0,
                                      attention_probs_dropout_prob=0.0)
    hf_cfg = transformers.GroundingDinoConfig(
        backbone_config=hf_swin, text_config=hf_text, d_model=32, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_queries=20, max_text_len=16,
        num_feature_levels=4, encoder_n_points=4, decoder_n_points=4, dropout=0.0,
        fusion_dropout=0.0, fusion_droppath=0.0, text_enhancer_dropout=0.0,
        attention_dropout=0.0, activation_dropout=0.0)
    torch.manual_seed(0)
    hf = _randomize(GroundingDinoForObjectDetection(hf_cfg).eval(), rng)
    sd = _renamed_alike(hf.state_dict(), thf.gdino_hf_to_original, jhf.gdino_hf_to_original)
    path = str(tmp_path / "gdino.pth")
    torch.save(sd, path)
    cfg = tgdino.GDINOConfig(
        swin=tswin.SwinConfig(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(2, 2, 2, 2),
                              window_size=4, patch_size=4, out_indices=(1, 2, 3)),
        bert=tbert.BertConfig(vocab_size=2000, hidden=32, layers=2, heads=2, intermediate=64,
                              max_position=32),
        hidden=32, heads=4, levels=4, enc_points=4, dec_points=4, enc_layers=2, dec_layers=2,
        ffn_dim=64, num_queries=20, max_text_len=16, image_size=(128, 160),
        enc_windowed_deform=False)
    module = tgconvert.load_torch_checkpoint(path, cfg, device="cpu")

    h, w = cfg.image_size
    imgs = rng.normal(size=(1, h, w, 3)).astype(np.float32)
    ids = np.array([[101, 1200, 1305, 1012, 1400, 1501, 1602, 1012, 102]], np.int64)
    self_mask, pos_ids = tbert.subsentence_masks(ids, [1012, 1029], 101, 102)
    pad = np.ones_like(ids, bool)
    with torch.no_grad():
        out = hf(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2)),
                 input_ids=torch.from_numpy(ids),
                 attention_mask=torch.from_numpy(pad.astype(np.int64)))
        got_logits, got_boxes = module(torch.from_numpy(imgs), torch.from_numpy(ids),
                                       torch.from_numpy(self_mask), torch.from_numpy(pad),
                                       torch.from_numpy(np.asarray(pos_ids)).long())
    t = ids.shape[1]
    np.testing.assert_allclose(got_boxes.numpy(), out.pred_boxes.numpy(), atol=5e-4,
                               rtol=1e-3)
    np.testing.assert_allclose(got_logits.numpy()[..., :t], out.logits.numpy()[..., :t],
                               atol=5e-4, rtol=1e-3)


# ------------------------------------------------------------ tokenizers
BERT_STRINGS = [
    "sofa, chair.",
    "a photo of the clothes, which has sleeves.",
    "trash can . paper towel dispenser . ceiling",
    "naive Cafe coffee",
    "naïve café résumé",
    "under_score and-hyphen and/slash",
    "don't stop-me now!!",
    "3.14 100% (a) [b] {c}",
    "x" * 120 + " ok",
    "  weird   spacing\tand\nnewlines  ",
    "中文 mixed words 汉",
    "[CLS] not special here?",
    "",
    "unknownblah qwzzk",
]

CLIP_STRINGS = [
    "a photo of a chair, which has legs.",
    "hello-world it's 3.14!",
    "N/A (50%) [x]?",
    "don't you've we're i'll he'd",
    "  spaced    out  ",
    "under_score",
    "zzzqqq unknown",
]


def _bert_vocab(tmp_path):
    """tests/test_tokenizers_official.py's vocabulary."""
    pieces = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words = ("sofa chair a photo of the clothes which has sleeves trash can paper "
             "towel dispenser ceiling naive cafe coffee resume and under score "
             "hyphen slash don stop me now ok weird spacing newlines mixed words "
             "not special here t s").split()
    pieces += sorted(set(words))
    pieces += list(".,!?()[]{}%/-_'\"")
    pieces += list("0123456789")
    pieces += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    pieces += ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    pieces += ["##ing", "##ed", "##er", "##es", "##s", "14", "##14", "100", "50"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(dict.fromkeys(pieces)) + "\n", encoding="utf-8")
    return str(path)


def _clip_merges(tmp_path):
    """tests/test_tokenizers_official.py's merges file and the vocab.json
    transformers reads beside it, built the way OpenAI builds its vocabulary."""
    import json

    merges = [
        "t h", "th e</w>", "a</w> ", "c h", "ch a", "i r</w>", "cha ir</w>",
        "p h", "ph o", "pho t", "phot o</w>", "o f</w>", "h a", "ha s</w>",
        "l e", "le g", "leg s</w>", "w h", "wh i", "whi ch</w>", "' s</w>",
        "h e", "he l", "hel l", "hell o</w>", "w o", "wo r", "wor l",
        "worl d</w>", "d o", "do n</w>", "' t</w>", "1 4</w>", "5 0</w>",
        "1 0", "10 0</w>", "y o", "yo u</w>", "' v", "'v e</w>", "w e</w>",
        "' r", "'r e</w>", "i</w> ", "' l", "'l l</w>", "' d</w>",
        "s p", "sp a", "spa c", "spac e", "space d</w>", "o u", "ou t</w>",
        "u n", "un d", "und e", "unde r</w>", "s c", "sc o", "sco r",
        "scor e</w>", "_ _", "- -",
    ]
    merges = [m for m in merges if " " in m.strip()]
    bpe = tmp_path / "merges.txt"
    bpe.write_text("#version: 0.2\n" + "\n".join(merges) + "\n", encoding="utf-8")
    byte_vocab = list(ttok._bytes_to_unicode().values())
    vocab = byte_vocab + [v + "</w>" for v in byte_vocab]
    vocab += ["".join(m.split()) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    vj = tmp_path / "vocab.json"
    vj.write_text(json.dumps({v: i for i, v in enumerate(vocab)}), encoding="utf-8")
    return str(bpe), str(vj)


def test_bert_tokenizer_matches_jax_and_official(tmp_path):
    transformers = pytest.importorskip("transformers")
    vocab = _bert_vocab(tmp_path)
    ours, theirs = ttok.BertTokenizer(vocab), jtok.BertTokenizer(vocab)
    hf = transformers.BertTokenizer(vocab, do_lower_case=True)
    for s in BERT_STRINGS:
        got = [ours.cls] + ours.encode(s) + [ours.sep]
        assert got == hf.encode(s), s
        assert ours.encode(s) == theirs.encode(s), s
    batch = ["sofa, chair.", "coffee", "trash can . ceiling"]
    for key, val in theirs(batch).items():
        np.testing.assert_array_equal(ours(batch)[key], val)
    assert (ours.cls, ours.sep, ours.vocab) == (theirs.cls, theirs.sep, theirs.vocab)
    assert [ours.decode_token(i) for i in range(len(ours.vocab) + 1)] == \
        [theirs.decode_token(i) for i in range(len(theirs.vocab) + 1)]


def test_clip_tokenizer_matches_jax_and_official(tmp_path):
    transformers = pytest.importorskip("transformers")
    bpe, vocab_json = _clip_merges(tmp_path)
    ours, theirs = ttok.ClipTokenizer(bpe), jtok.ClipTokenizer(bpe)
    hf = transformers.CLIPTokenizer(vocab_file=vocab_json, merges_file=bpe)
    for s in CLIP_STRINGS:
        assert ours.encode(s) == hf.encode(s, add_special_tokens=False), s
    np.testing.assert_array_equal(ours(CLIP_STRINGS), theirs(CLIP_STRINGS))
    short = ttok.ClipTokenizer(bpe, context_length=12)
    long = short(["hello world " * 30])
    assert long[0, 0] == short.sot and long[0, -1] == short.eot
    assert short.eot == max(short.encoder.values())
    np.testing.assert_array_equal(long, jtok.ClipTokenizer(bpe, context_length=12)(
        ["hello world " * 30]))


# ------------------------------------------------------------ the stage
def _small_presets(monkeypatch):
    """The full-width presets the stage loads replaced by small ones in both
    packages: Swin-B -> the "test" Grounding-DINO with a 200-word BERT
    vocabulary, ViT-H -> the "test" SAM, ViT-L/14 -> the "test" CLIP with a
    600-word vocabulary (the byte-level BPE alone has 512 symbols)."""
    for gd in (jgdino, tgdino):
        t = gd.PRESETS["test"]
        monkeypatch.setitem(gd.PRESETS, "swinb", dataclasses.replace(
            t, bert=dataclasses.replace(t.bert, vocab_size=200)))
    for sm in (jsam, tsam):
        monkeypatch.setitem(sm.PRESETS, "vit_h", sm.PRESETS["test"])
    for cl in (jclip, tclip):
        monkeypatch.setitem(cl.PRESETS, "ViT-L/14",
                            dataclasses.replace(cl.PRESETS["test"], vocab_size=600))


def _checkpoint_files(tmp_path):
    """Official-layout files of seeded port modules at the patched presets."""
    files = {}
    for kind, cfg in (("gdino", tgdino.PRESETS["swinb"]), ("sam", tsam.PRESETS["vit_h"]),
                      ("clip", tclip.PRESETS["ViT-L/14"])):
        sd = _module(kind, cfg, seed=11).state_dict()
        files[kind] = _write(kind, sd, str(tmp_path / f"{kind}.ckpt"), cfg)
    files["bert_vocab"] = _bert_vocab(tmp_path)
    files["clip_bpe"] = _clip_merges(tmp_path)[0]
    return files


@pytest.fixture
def opencv_own_cubic():
    """OpenCV's own INTER_CUBIC arithmetic for the JAX side's host resizes
    (tests/test_torch_seg2d.py)."""
    cv2 = pytest.importorskip("cv2")
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(True)


def _iou(a, b):
    union = np.logical_or(a, b).sum()
    return 1.0 if union == 0 else np.logical_and(a, b).sum() / union


def test_stage_from_configured_checkpoints_matches_jax(tmp_path, monkeypatch,
                                                        opencv_own_cubic):
    """The port's 2D CLI and the JAX package's ``Segmentor2D`` build their
    models from the same configured files (BERT WordPiece and CLIP BPE
    tokenizers included) and write the same records: confidences within
    1e-4, masks at IoU >= 0.999."""
    import cv2

    _small_presets(monkeypatch)
    monkeypatch.setenv("BFF_SEG2D_YUV", "0")
    files = _checkpoint_files(tmp_path)
    h, w = 48, 64
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
                         "similarity_threshold": -10.0, "dtype": "float32", "frame_batch": 2,
                         "gdino_checkpoint": files["gdino"], "sam_checkpoint": files["sam"],
                         "clip_checkpoint": files["clip"], "bert_vocab_path": files["bert_vocab"],
                         "clip_bpe_path": files["clip_bpe"]},
        }

    jcfg = JConfig.from_dict(cfg_dict("jax"))
    jseg = jseg2d.Segmentor2D(jcfg)
    jseg2d.run(jcfg, "clothes", scenes=["scene0000_00"], segmentor=jseg)
    tcfg_path = str(tmp_path / "torch.yaml")
    TConfig.from_dict(cfg_dict("torch")).to_yaml(tcfg_path)
    tseg2d_cli.main(["--config", tcfg_path, "--cls", "clothes", "--scene", "scene0000_00",
                     "--device", "cpu"])

    jrec = jio.load_frame_records(str(tmp_path / "out_jax" / "clothes" / "scene0000_00.pth"))
    trec = jio.load_frame_records(str(tmp_path / "out_torch" / "clothes" / "scene0000_00.pth"))
    assert [r["frame_id"] for r in trec] == [r["frame_id"] for r in jrec] and len(jrec) == 4
    for t, j in zip(trec, jrec):
        assert t["labels"] == j["labels"]
        np.testing.assert_allclose(t["confidences"], j["confidences"], atol=1e-4, rtol=0)
    n_masks = 0
    for t, j in zip(jrle.decode_frame_masks(trec, image_shape=(h, w)),
                    jrle.decode_frame_masks(jrec, image_shape=(h, w))):
        tm, jm = t["segmented_frame_masks"], j["segmented_frame_masks"]
        assert tm.shape == jm.shape
        for a, b in zip(tm.astype(bool), jm.astype(bool)):
            assert _iou(a, b) >= 0.999
            n_masks += 1
    assert n_masks > 0
    tseg = tseg2d.Segmentor2D(TConfig.from_dict(cfg_dict("torch")), device="cpu")
    assert isinstance(tseg.detector.tokenizer, ttok.BertTokenizer)
    assert isinstance(tseg.clip_tokenizer, ttok.ClipTokenizer)
    assert sorted(tseg.load_seconds) == ["clip", "gdino", "sam"]
    np.testing.assert_allclose(tseg.query_embedding("clothes"), jseg.query_embedding("clothes"),
                               atol=1e-5)


def test_build_text_similarity_from_checkpoint_matches_jax(tmp_path, monkeypatch):
    """``build_text_similarity`` loads CLIP (float32) and its BPE tokenizer
    from the configured files, as the JAX package's does."""
    _small_presets(monkeypatch)
    files = _checkpoint_files(tmp_path)
    d = {"detector": {"clip_checkpoint": files["clip"], "clip_bpe_path": files["clip_bpe"]}}
    tsim = ttext_sim.build_text_similarity(TConfig.from_dict(d), device="cpu")
    jsim = jtext_sim.build_text_similarity(JConfig.from_dict(d))
    assert isinstance(tsim, ttext_sim.ClipTextSimilarity)
    assert next(tsim.model.module.parameters()).dtype == torch.float32
    for a, b in [("clothes", "clothes"), ("clothes", "towel"), ("office chair", "chair")]:
        assert abs(tsim(a, b) - jsim(a, b)) <= 1e-5
