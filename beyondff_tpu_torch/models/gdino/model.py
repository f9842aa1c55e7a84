"""Grounding-DINO: open-vocabulary detection from (image, caption), in PyTorch.

Port of beyondff_tpu/models/gdino/model.py: Swin backbone, BERT text branch
with sub-sentence masking, a 6-layer feature enhancer (image-text
bi-attention, phrase-masked text self-attention, multi-scale deformable
image attention), language-guided top-K query selection and a 6-layer
cross-modality decoder with iterative box refinement and a contrastive
classification head. Module names are the official
``groundingdino_swinb_cogcoor.pth`` layout; the duplicated names that module
sharing leaves in that checkpoint (``bbox_embed.1-5``,
``transformer.decoder.bbox_embed``) are not registered here.

The decoder's 900-query self-attention routes to the flash kernel on the
card; the encoder's and decoder's deformable attention to the sampling
kernel (clamp mode in the encoder, exact in the decoder).
"""

from __future__ import annotations

import functools
import hashlib
import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from beyondff_tpu_torch.core import resize as _resize
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.models.gdino import bert as bert_mod
from beyondff_tpu_torch.models.gdino import swin as swin_mod
from beyondff_tpu_torch.models.gdino.deformable import MSDeformAttn
from beyondff_tpu_torch.models.layers import Attention, MLPHead, build
from beyondff_tpu_torch.parallel.frames import data_parallel_slice, gather_frames
from beyondff_tpu_torch.utils.host_copy import HostCopy, to_device

IMAGE_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGE_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class GDINOConfig:
    swin: swin_mod.SwinConfig = field(default_factory=lambda: swin_mod.PRESETS["swin_b"])
    bert: bert_mod.BertConfig = field(default_factory=lambda: bert_mod.PRESETS["bert-base"])
    hidden: int = 256
    heads: int = 8
    levels: int = 4
    enc_points: int = 4
    dec_points: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_dim: int = 2048
    num_queries: int = 900
    max_text_len: int = 256
    # fixed detector input for 1296x968 frames (aspect-preserving
    # shorter-side-800 is (800, 1071); 1072 keeps levels tileable)
    image_size: Tuple[int, int] = (800, 1072)
    pe_temperature: float = 20.0
    # windowed (clamp-mode) deformable sampling in the encoder on the card;
    # BFF_DEFORM_WINDOWED=0 restores exact sampling
    enc_windowed_deform: bool = True


PRESETS = {
    "swinb": GDINOConfig(),
    "swint": GDINOConfig(swin=swin_mod.PRESETS["swin_t"]),
    "test": GDINOConfig(
        swin=swin_mod.PRESETS["test"], bert=bert_mod.PRESETS["test"], hidden=32, heads=2,
        levels=3, enc_layers=1, dec_layers=1, ffn_dim=64, num_queries=20, max_text_len=16,
        image_size=(64, 96)),
}


def sine_position_embedding(coords: torch.Tensor, dim: int, temperature: float = 10000.0):
    """(..., n) normalized coords -> (..., dim) sine PE, per coordinate
    (sin, cos) interleaved, coordinates concatenated in order."""
    n = coords.shape[-1]
    d = dim // n
    t = temperature ** (2 * torch.arange(d // 2, dtype=torch.float32, device=coords.device) / d)
    parts = []
    for i in range(n):
        xt = (coords[..., i] * (2 * math.pi))[..., None] / t
        parts.append(torch.stack([torch.sin(xt), torch.cos(xt)], dim=-1).flatten(-2))
    return torch.cat(parts, dim=-1)


def _inverse_sigmoid(x, eps=1e-3):
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def stable_topk(scores: torch.Tensor, k: int):
    """Top-k along the last axis, ties in index order (``jax.lax.top_k``)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class BiMultiHeadAttention(nn.Module):
    def __init__(self, dim: int, text_dim: int, embed_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.v_proj = nn.Linear(dim, embed_dim)
        self.l_proj = nn.Linear(text_dim, embed_dim)
        self.values_v_proj = nn.Linear(dim, embed_dim)
        self.values_l_proj = nn.Linear(text_dim, embed_dim)
        self.out_v_proj = nn.Linear(embed_dim, dim)
        self.out_l_proj = nn.Linear(embed_dim, text_dim)


class BiAttentionBlock(nn.Module):
    """Bidirectional image<->text cross-attention with tanh-free gamma
    residuals on the PRE-normed features (the official BiAttentionBlock)."""

    def __init__(self, dim: int, text_dim: int, embed_dim: int, heads: int):
        super().__init__()
        self.attn = BiMultiHeadAttention(dim, text_dim, embed_dim, heads)
        self.gamma_v = nn.Parameter(torch.empty(dim))
        self.gamma_l = nn.Parameter(torch.empty(text_dim))
        self.layer_norm_v = nn.LayerNorm(dim, eps=1e-5)
        self.layer_norm_l = nn.LayerNorm(text_dim, eps=1e-5)

    def forward(self, img, txt, txt_mask=None):
        a = self.attn
        img = self.layer_norm_v(img)
        txt = self.layer_norm_l(txt)
        embed = a.v_proj.out_features
        hd = embed // a.heads

        def split(t):
            return t.unflatten(-1, (a.heads, hd))

        q = a.v_proj(img) * hd ** -0.5
        logits = torch.einsum("bihd,bthd->bhit", split(q), split(a.l_proj(txt)))
        logits = logits.clamp(-50000, 50000)
        logits_t = logits.transpose(2, 3)
        logits_t = (logits_t - logits_t.amax(dim=-1, keepdim=True)).clamp(-50000, 50000)
        if txt_mask is not None:
            logits = logits.masked_fill(~txt_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        attn_i = torch.softmax(logits.float(), dim=-1).to(img.dtype)
        attn_t = torch.softmax(logits_t.float(), dim=-1).to(img.dtype)
        img_out = torch.einsum("bhit,bthd->bihd", attn_i, split(a.values_l_proj(txt))).flatten(-2)
        txt_out = torch.einsum("bhti,bihd->bthd", attn_t, split(a.values_v_proj(img))).flatten(-2)
        img = img + self.gamma_v.to(img.dtype) * a.out_v_proj(img_out)
        txt = txt + self.gamma_l.to(txt.dtype) * a.out_l_proj(txt_out)
        return img, txt


class DeformableEncoderLayer(nn.Module):
    def __init__(self, c: GDINOConfig):
        super().__init__()
        self.self_attn = MSDeformAttn(c.hidden, c.heads, c.levels, c.enc_points,
                                      windowed=c.enc_windowed_deform)
        self.norm1 = nn.LayerNorm(c.hidden, eps=1e-5)
        self.linear1 = nn.Linear(c.hidden, c.ffn_dim)
        self.linear2 = nn.Linear(c.ffn_dim, c.hidden)
        self.norm2 = nn.LayerNorm(c.hidden, eps=1e-5)

    def forward(self, img, pos, ref_points, shapes):
        img = self.norm1(img + self.self_attn(img + pos, ref_points, img, shapes))
        return self.norm2(img + self.linear2(torch.relu(self.linear1(img))))


class TextEnhancerLayer(nn.Module):
    def __init__(self, c: GDINOConfig):
        super().__init__()
        self.self_attn = Attention(c.hidden, c.heads // 2)
        self.norm1 = nn.LayerNorm(c.hidden, eps=1e-5)
        self.linear1 = nn.Linear(c.hidden, c.ffn_dim // 2)
        self.linear2 = nn.Linear(c.ffn_dim // 2, c.hidden)
        self.norm2 = nn.LayerNorm(c.hidden, eps=1e-5)

    def forward(self, txt, pos_text, mask):
        tq = txt + pos_text.to(txt.dtype)
        txt = self.norm1(txt + self.self_attn(tq, kv=tq, v=txt, mask=mask))
        return self.norm2(txt + self.linear2(torch.relu(self.linear1(txt))))


class Encoder(nn.Module):
    def __init__(self, c: GDINOConfig):
        super().__init__()
        self.layers = nn.ModuleList(DeformableEncoderLayer(c) for _ in range(c.enc_layers))
        self.text_layers = nn.ModuleList(TextEnhancerLayer(c) for _ in range(c.enc_layers))
        # the official fusion projects into dim_feedforward // 2 with nhead // 2 heads
        self.fusion_layers = nn.ModuleList(
            BiAttentionBlock(c.hidden, c.hidden, c.ffn_dim // 2, c.heads // 2)
            for _ in range(c.enc_layers))


class DecoderLayer(nn.Module):
    def __init__(self, c: GDINOConfig):
        super().__init__()
        self.self_attn = Attention(c.hidden, c.heads)
        self.norm2 = nn.LayerNorm(c.hidden, eps=1e-5)
        self.ca_text = Attention(c.hidden, c.heads)
        self.catext_norm = nn.LayerNorm(c.hidden, eps=1e-5)
        self.cross_attn = MSDeformAttn(c.hidden, c.heads, c.levels, c.dec_points)
        self.norm1 = nn.LayerNorm(c.hidden, eps=1e-5)
        self.linear1 = nn.Linear(c.hidden, c.ffn_dim)
        self.linear2 = nn.Linear(c.ffn_dim, c.hidden)
        self.norm3 = nn.LayerNorm(c.hidden, eps=1e-5)

    def forward(self, tgt, query_pos, memory, txt, ref_points, shapes, txt_mask):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, kv=q, v=tgt))
        mask = txt_mask[:, None, None, :] if txt_mask is not None else None
        tgt = self.catext_norm(tgt + self.ca_text(tgt + query_pos, kv=txt, mask=mask))
        tgt = self.norm1(tgt + self.cross_attn(tgt + query_pos, ref_points, memory, shapes))
        return self.norm3(tgt + self.linear2(torch.relu(self.linear1(tgt))))


class Decoder(nn.Module):
    def __init__(self, c: GDINOConfig):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(c) for _ in range(c.dec_layers))
        self.norm = nn.LayerNorm(c.hidden, eps=1e-5)
        self.ref_point_head = MLPHead([2 * c.hidden, c.hidden, c.hidden])


class Transformer(nn.Module):
    def __init__(self, c: GDINOConfig, n_levels: int):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(n_levels, c.hidden))
        self.encoder = Encoder(c)
        self.decoder = Decoder(c)
        self.enc_output = nn.Linear(c.hidden, c.hidden)
        self.enc_output_norm = nn.LayerNorm(c.hidden, eps=1e-5)
        self.tgt_embed = nn.Embedding(c.num_queries, c.hidden)
        self.enc_out_bbox_embed = MLPHead([c.hidden] * 3 + [4])


@functools.lru_cache(maxsize=8)
def _raster_tables(shapes: Tuple[Tuple[int, int], ...]):
    """Static per-token tables of the all-level raster: own-cell centres
    (x, y), proposal validity and proposal anchor logits."""
    centers = []
    for h, w in shapes:
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w
        centers.append(np.stack(np.meshgrid(xs, ys, indexing="xy"), axis=-1).reshape(-1, 2))
    centers = np.concatenate(centers, axis=0)
    whs = np.concatenate([np.full((h * w, 2), 0.05 * (2.0 ** li), np.float32)
                          for li, (h, w) in enumerate(shapes)], axis=0)
    proposals = np.concatenate([centers, whs], axis=-1)
    valid = ((proposals > 0.01) & (proposals < 0.99)).all(-1)
    with np.errstate(divide="ignore"):
        anchor_logits = np.where(
            valid[:, None],
            np.log(np.clip(proposals, 1e-9, None) / np.clip(1 - proposals, 1e-9, None)),
            np.inf).astype(np.float32)
    return centers, valid, anchor_logits


class GDINOModule(nn.Module):
    """Text-independent :meth:`backbone_forward` (Swin + input projections)
    and text-conditioned :meth:`detect` (BERT + enhancer + query selection +
    decoder)."""

    def __init__(self, cfg: GDINOConfig):
        super().__init__()
        c = self.cfg = cfg
        self.backbone = nn.ModuleList([swin_mod.SwinBackbone(c.swin)])
        self.bert = bert_mod.BertModel(c.bert)
        self.feat_map = nn.Linear(c.bert.hidden, c.hidden)
        chans = self.backbone[0].out_channels()
        n_out = len(chans)
        self.n_used = c.levels - 1 if n_out >= c.levels else n_out
        used = chans[-self.n_used:]
        gn = 32 if c.hidden % 32 == 0 else 4
        projs = [nn.Sequential(nn.Conv2d(ch, c.hidden, 1), nn.GroupNorm(gn, c.hidden, eps=1e-5))
                 for ch in used]
        projs.append(nn.Sequential(nn.Conv2d(chans[-1], c.hidden, 3, 2, 1),
                                   nn.GroupNorm(gn, c.hidden, eps=1e-5)))
        self.input_proj = nn.ModuleList(projs)
        self.transformer = Transformer(c, self.n_used + 1)
        self.bbox_embed = nn.ModuleList([MLPHead([c.hidden] * 3 + [4])])
        self.init_overrides = {"transformer.level_embed": (0.0, 1.0),
                               "transformer.tgt_embed.weight": (0.0, 1.0)}

    def backbone_forward(self, images):
        """images (B, H, W, 3) normalized -> list of projected per-level maps
        (B, h_i, w_i, hidden)."""
        c = self.cfg
        feats = self.backbone[0](images)
        if len(feats) >= c.levels:
            feats = feats[-(c.levels - 1):]
        srcs = [self.input_proj[li](f.permute(0, 3, 1, 2)) for li, f in enumerate(feats)]
        srcs.append(self.input_proj[-1](feats[-1].permute(0, 3, 1, 2)))
        return [s.permute(0, 2, 3, 1) for s in srcs]

    def detect(self, srcs, input_ids, text_self_mask, text_pad_mask, position_ids):
        """Returns (pred_logits (B, Q, T) f32, pred_boxes (B, Q, 4) cxcywh in [0, 1])."""
        c = self.cfg
        tr = self.transformer
        dev = srcs[0].device
        dtype = srcs[0].dtype
        txt = self.feat_map(self.bert(input_ids, text_self_mask, position_ids))

        shapes = tuple((int(x.shape[1]), int(x.shape[2])) for x in srcs)
        b = srcs[0].shape[0]
        memory = torch.cat([x.reshape(b, -1, c.hidden) for x in srcs], dim=1)
        pos_parts = []
        for li, (h, w) in enumerate(shapes):
            # official backbone PE: (i+1)/(H+1e-6) normalization, temperature 20
            ys = (torch.arange(h, dtype=torch.float32, device=dev) + 1.0) / (h + 1e-6)
            xs = (torch.arange(w, dtype=torch.float32, device=dev) + 1.0) / (w + 1e-6)
            grid = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), dim=-1).reshape(-1, 2)
            pe = sine_position_embedding(grid, c.hidden, temperature=c.pe_temperature)
            pos_parts.append(pe + tr.level_embed[li].float())
        pos = torch.cat(pos_parts, dim=0)[None].to(dtype)

        centers_np, valid_np, anchors_np = _raster_tables(shapes)
        centers = to_device(centers_np, dev)
        ref_enc = centers[None, :, None, :].expand(b, -1, len(shapes), 2)

        pos_text = sine_position_embedding(position_ids[..., None].float(), c.hidden)
        t_mask = text_self_mask[:, None]
        enc = tr.encoder
        for li in range(c.enc_layers):
            memory, txt = enc.fusion_layers[li](memory, txt, text_pad_mask)
            txt = enc.text_layers[li](txt, pos_text, t_mask)
            memory = enc.layers[li](memory, pos, ref_enc, shapes)

        # language-guided query selection
        valid = to_device(valid_np, dev)
        masked_memory = memory * valid[None, :, None].to(memory.dtype)
        enc_out = tr.enc_output_norm(tr.enc_output(masked_memory))
        sim = torch.einsum("bic,btc->bit", enc_out, txt)
        sim = sim.masked_fill(~text_pad_mask[:, None, :], float("-inf"))
        _, topk = stable_topk(sim.amax(dim=-1).float(), c.num_queries)
        sel = torch.gather(enc_out, 1, topk[..., None].expand(-1, -1, c.hidden))
        anchors = to_device(anchors_np, dev)[topk]
        boxes = torch.sigmoid(tr.enc_out_bbox_embed(sel).float() + anchors)

        tgt = tr.tgt_embed.weight[None].expand(b, -1, -1).to(dtype)
        box_head = self.bbox_embed[0]
        dec = tr.decoder
        ref = ref_in = boxes
        for layer in dec.layers:
            # gen_sineembed_for_position order: (pos_y, pos_x, pos_w, pos_h)
            pe = sine_position_embedding(torch.stack(
                [ref[..., 1], ref[..., 0], ref[..., 2], ref[..., 3]], -1), 2 * c.hidden).to(dtype)
            query_pos = dec.ref_point_head(pe)
            ref_input = ref[:, :, None, :].expand(-1, -1, len(shapes), -1)
            tgt = layer(tgt, query_pos, memory, txt, ref_input, shapes, text_pad_mask)
            ref_in = ref
            ref = torch.sigmoid(box_head(tgt).float() + _inverse_sigmoid(ref))
        normed = dec.norm(tgt)
        out_boxes = torch.sigmoid(box_head(normed).float() + _inverse_sigmoid(ref_in))
        logits = torch.einsum("bqc,btc->bqt", normed, txt).float()
        logits = logits.masked_fill(~text_pad_mask[:, None, :], torch.finfo(torch.float32).min)
        return logits, out_boxes

    def forward(self, images, input_ids, text_self_mask, text_pad_mask, position_ids):
        return self.detect(self.backbone_forward(images), input_ids, text_self_mask,
                           text_pad_mask, position_ids)


def pack_topk(logits: torch.Tensor, boxes: torch.Tensor, k: int) -> torch.Tensor:
    """Top-K queries by max token probability, packed as one (B, K, 1+4+T)
    f32 array: score | box | per-token probs (ties in index order)."""
    probs = torch.sigmoid(logits.float())
    top_scores, top_idx = stable_topk(probs.amax(dim=-1), k)
    top_boxes = torch.gather(boxes.float(), 1, top_idx[..., None].expand(-1, -1, 4))
    top_probs = torch.gather(probs, 1, top_idx[..., None].expand(-1, -1, probs.shape[-1]))
    return torch.cat([top_scores[..., None], top_boxes, top_probs], dim=-1)


class GroundingDINO:
    """Inference wrapper: caption preprocessing, forward, phrase extraction."""

    TOP_K = 64  # detections surviving device-side top-K selection per frame

    def __init__(self, cfg: GDINOConfig, module: GDINOModule, tokenizer=None):
        self.cfg = cfg
        self.module = module
        self.tokenizer = tokenizer if tokenizer is not None else _HashBert(cfg.bert.vocab_size)
        p = next(module.parameters())
        self.device, self.dtype = p.device, p.dtype
        self._mean = torch.as_tensor(IMAGE_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGE_STD, device=self.device)

    @classmethod
    def create(cls, name_or_cfg="swinb", tokenizer=None, seed: int = 0,
               dtype=torch.float32, device=None) -> "GroundingDINO":
        cfg = PRESETS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
        dev = resolve_device(device)
        return cls(cfg, build(lambda: GDINOModule(cfg), dev, dtype, seed), tokenizer)

    @staticmethod
    def preprocess_caption(caption: str) -> str:
        """lowercase + ensure trailing '.' (groundingdino.util.inference)."""
        c = caption.lower().strip()
        return c if c.endswith(".") else c + "."

    def _text(self, caption: str):
        enc = self.tokenizer([self.preprocess_caption(caption)])
        ids = enc["input_ids"][:, :self.cfg.max_text_len]
        pad = enc["attention_mask"][:, :self.cfg.max_text_len]
        special = getattr(self.tokenizer, "special_ids", None) or self._special_ids()
        self_mask, pos_ids = bert_mod.subsentence_masks(ids, special, self._cls_id(),
                                                        self._sep_id())
        return ids, pad, self_mask, pos_ids

    def _normalize(self, images_u8: torch.Tensor, resize: bool) -> torch.Tensor:
        x = images_u8.permute(0, 3, 1, 2).float()
        if resize:
            # the JAX jax.image.resize(..., "bilinear", antialias=False)
            x = F.interpolate(x, size=self.cfg.image_size, mode="bilinear",
                              align_corners=False, antialias=False)
        return ((x.permute(0, 2, 3, 1) / 255.0 - self._mean) / self._std).to(self.dtype)

    @torch.inference_mode()
    def _forward_packed(self, images_u8: torch.Tensor, caption: str, resize: bool,
                        feats_cache=None):
        ids, pad, self_mask, pos_ids = self._text(caption)
        b = images_u8.shape[0]
        # data-parallel detection inside parallel.frames.shard_frames over a
        # group of more than one rank whose size divides the batch: each rank
        # runs its slice of the frames and the packed results are gathered
        # (the JAX package's frame sharding; like it, the banked split path
        # stays whole)
        sliced = data_parallel_slice(b) if feats_cache is None else None
        if sliced is not None:
            images_u8 = images_u8[sliced]
        n = images_u8.shape[0]

        def tile(a, dtype):
            return to_device(np.broadcast_to(a, (n, *a.shape[1:])).copy(), self.device, dtype)

        text = (tile(ids, torch.long), tile(self_mask, torch.bool), tile(pad, torch.bool),
                tile(pos_ids, torch.long))
        k = min(self.TOP_K, self.cfg.num_queries)
        if feats_cache is None:
            logits, boxes = self.module(self._normalize(images_u8, resize), *text)
            packed = pack_topk(logits, boxes, k)
            packed = packed if sliced is None else gather_frames(packed)
            return HostCopy(packed.float()), ids, b
        bank, key = feats_cache
        feats = bank.get(key)
        if feats is None:
            feats = self.module.backbone_forward(self._normalize(images_u8, resize))
            bank[key] = feats
        logits, boxes = self.module.detect(feats, *text)
        return HostCopy(pack_topk(logits, boxes, k).float()), ids, b

    # the seg2d stage may bank the text-independent backbone pyramid
    supports_feats_cache = True

    def predict_batch_frames_async(self, frames_dev: torch.Tensor, caption: str,
                                   feats_cache=None):
        """Detection on an uploaded uint8 frame buffer (B, h, w, 3) of any
        resolution, resized to the detector input on the device. Returns a
        handle for :meth:`predict_finalize`; the work is queued on the
        current stream, and the handle's packed result (a
        :class:`utils.host_copy.HostCopy`) starts its download there, behind
        the work, as the JAX package's ``copy_to_host_async`` at dispatch.

        ``feats_cache``: optional ``(bank, key)``, the multi-class sweep's
        per-scene bank. The text-independent half (resize, normalize, Swin,
        input projections) runs once and is stored under ``key``; every
        later caption on the same frames runs only :meth:`GDINOModule.detect`
        (the JAX package's ``backbone``/``detect`` split)."""
        return self._forward_packed(frames_dev, caption, resize=True, feats_cache=feats_cache)

    def caption_spans(self, classes):
        """Fused multi-phrase caption and each class's token span.

        The classes join with " . " into one caption, Grounding-DINO's own
        multi-phrase protocol; subsentence masks and per-phrase position ids
        keep each phrase's text features apart. Returns ``(caption, spans)``
        with ``spans[i] = (start, end)`` the half-open token range of
        ``classes[i]``; raises ``ValueError`` when the caption overflows
        ``max_text_len`` (fewer spans than classes)."""
        caption = self.preprocess_caption(
            " . ".join(c.lower().strip().strip(".").strip() for c in classes))
        enc = self.tokenizer([caption])
        ids = np.asarray(enc["input_ids"][0][:self.cfg.max_text_len]).tolist()
        seps = set(self._special_ids())
        cls_id, sep_id = self._cls_id(), self._sep_id()
        spans, start = [], None
        for i, t in enumerate(ids):
            if t == cls_id:
                continue
            if t in seps or t == sep_id or t == 0:
                if start is not None:
                    spans.append((start, i))
                    start = None
                if t == sep_id or t == 0:
                    break
            elif start is None:
                start = i
        if start is not None:
            spans.append((start, len(ids)))
        if len(spans) != len(classes):
            raise ValueError(
                f"fused caption tokenized into {len(spans)} spans for {len(classes)} classes "
                f"(max_text_len={self.cfg.max_text_len}: shrink the caption group)")
        return caption, spans

    def predict_finalize_demux(self, handle, spans, box_threshold=0.35,
                               text_threshold: float = 0.25):
        """Host half of a fused multi-class detection: the same packed download
        as :meth:`predict_finalize`, split per class by token span. A box's
        score for a class is its largest token probability inside the span;
        one span over the whole caption gives :meth:`predict_finalize`'s
        result. ``box_threshold`` is a scalar or one value per span.

        Returns, per frame, a list over classes of (boxes, scores, phrases)."""
        packed_d, ids, b = handle
        packed = packed_d.numpy()
        top_boxes, top_probs = packed[..., 1:5], packed[..., 5:]
        thresholds = (list(box_threshold) if np.ndim(box_threshold)
                      else [box_threshold] * len(spans))
        if len(thresholds) != len(spans):
            raise ValueError(f"{len(thresholds)} box thresholds for {len(spans)} spans")
        out = []
        for i in range(b):
            per_class = []
            for (s, e), thr in zip(spans, thresholds):
                sc = top_probs[i][:, s:e].max(axis=1)
                keep = sc > thr
                phrases = []
                for p in top_probs[i][keep]:
                    pos = np.zeros(p.shape, bool)
                    pos[s:e] = p[s:e] > text_threshold
                    phrases.append(self._phrase_from_posmap(pos, ids[0]))
                per_class.append((top_boxes[i][keep], sc[keep], phrases))
            out.append(per_class)
        return out

    def predict_batch(self, images, caption: str, box_threshold: float = 0.35,
                      text_threshold: float = 0.25):
        """Same-size uint8 RGB host frames, each resized straight to the
        detector input (OpenCV-exact INTER_LINEAR on the device, the JAX
        package's host cv2 resize), then one batched forward."""
        frames = torch.as_tensor(np.stack(images), device=self.device)
        img = _resize.resize_linear(frames, self.cfg.image_size)
        handle = self._forward_packed(img, caption, resize=False)
        return self.predict_finalize(handle, box_threshold, text_threshold)

    def predict(self, image: np.ndarray, caption: str, box_threshold: float = 0.35,
                text_threshold: float = 0.25):
        """Returns (boxes (K, 4) cxcywh normalized, scores (K,), phrases list)."""
        return self.predict_batch([image], caption, box_threshold, text_threshold)[0]

    def predict_finalize(self, handle, box_threshold: float = 0.35,
                         text_threshold: float = 0.25):
        """Host half: waits for the handle's download (its own event) +
        threshold + phrase extraction."""
        packed_d, ids, b = handle
        packed = packed_d.numpy()
        top_scores, top_boxes, top_probs = packed[..., 0], packed[..., 1:5], packed[..., 5:]
        out = []
        for i in range(b):
            keep = top_scores[i] > box_threshold
            phrases = [self._phrase_from_posmap(p > text_threshold, ids[0])
                       for p in top_probs[i][keep]]
            out.append((top_boxes[i][keep], top_scores[i][keep], phrases))
        return out

    def _phrase_from_posmap(self, posmap: np.ndarray, ids: np.ndarray) -> str:
        toks = [self.tokenizer.decode_token(i) for i in ids[np.flatnonzero(posmap)]]
        out = ""
        for w in (t for t in toks if not t.startswith("[")):
            out += w[2:] if w.startswith("##") else (" " if out else "") + w
        return out

    def _cls_id(self):
        return getattr(self.tokenizer, "cls", 101)

    def _sep_id(self):
        return getattr(self.tokenizer, "sep", 102)

    def _special_ids(self):
        vocab = getattr(self.tokenizer, "vocab", None)
        return [vocab["."]] if vocab and "." in vocab else []


class _HashBert:
    """BERT-interface md5-hash tokenizer for weightless runs and tests (the
    JAX package's ids, word for word)."""

    cls, sep = 2, 3

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self.vocab = {".": 4}

    def __call__(self, texts):
        rows = []
        for t in texts:
            ids = [self.cls]
            for w in t.lower().replace(".", " .").split():
                if w == ".":
                    ids.append(4)
                else:
                    ids.append(5 + int(hashlib.md5(w.encode()).hexdigest(), 16)
                               % (self.vocab_size - 5))
            ids.append(self.sep)
            rows.append(ids)
        width = max(len(r) for r in rows)
        out = np.zeros((len(rows), width), np.int32)
        mask = np.zeros((len(rows), width), bool)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
            mask[i, :len(r)] = True
        return {"input_ids": out, "attention_mask": mask}

    def decode_token(self, idx):
        return {2: "[CLS]", 3: "[SEP]", 4: "."}.get(int(idx), f"w{int(idx)}")

    @property
    def special_ids(self):
        return [4]
