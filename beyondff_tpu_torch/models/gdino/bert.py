"""BERT-base text encoder (PyTorch) for Grounding-DINO's language branch.

Port of beyondff_tpu/models/gdino/bert.py: post-LN BERT with the
sub-sentence attention mask Grounding-DINO applies between '.'-separated
phrases and restarting position ids. Module names are HuggingFace
``BertModel``'s, as embedded in the official checkpoint under ``bert.``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from torch import nn

from beyondff_tpu_torch.models.layers import attention_plain, gelu_exact


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    type_vocab: int = 2


PRESETS = {
    "bert-base": BertConfig(),
    "test": BertConfig(vocab_size=64, hidden=32, layers=2, heads=2, intermediate=64, max_position=32),
}


class _Dense(nn.Module):
    """``dense`` (+ ``LayerNorm``) pair, HF naming."""

    def __init__(self, d_in: int, d_out: int, norm: bool):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        if norm:
            self.LayerNorm = nn.LayerNorm(d_out, eps=1e-12)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.query = nn.Linear(cfg.hidden, cfg.hidden)
        self.key = nn.Linear(cfg.hidden, cfg.hidden)
        self.value = nn.Linear(cfg.hidden, cfg.hidden)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = _Dense(cfg.hidden, cfg.hidden, norm=True)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.heads
        self.attention = BertAttention(cfg)
        self.intermediate = _Dense(cfg.hidden, cfg.intermediate, norm=False)
        self.output = _Dense(cfg.intermediate, cfg.hidden, norm=True)

    def forward(self, x, attn_mask):  # post-LN; attn_mask (B, L, L) bool
        sa = self.attention.self

        def split(t):
            return t.unflatten(-1, (self.heads, -1))

        att = attention_plain(split(sa.query(x)), split(sa.key(x)), split(sa.value(x)),
                              mask=attn_mask[:, None]).flatten(-2)
        out = self.attention.output
        x = out.LayerNorm(x + out.dense(att))
        h = gelu_exact(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position_embeddings = nn.Embedding(cfg.max_position, cfg.hidden)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab, cfg.hidden)
        self.LayerNorm = nn.LayerNorm(cfg.hidden, eps=1e-12)


class BertEncoderLayers(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.layers))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoderLayers(cfg)

    def forward(self, input_ids, attn_mask, position_ids=None):
        """input_ids (B, L) long; attn_mask (B, L, L) or (B, L) bool;
        position_ids optional (B, L) long (phrase-local). Returns (B, L, hidden)."""
        if attn_mask.dim() == 2:
            attn_mask = attn_mask[:, None, :] & attn_mask[:, :, None]
        e = self.embeddings
        x = e.word_embeddings(input_ids)
        if position_ids is None:
            x = x + e.position_embeddings.weight[:input_ids.shape[1]]
        else:
            x = x + e.position_embeddings(position_ids)
        x = e.LayerNorm(x + e.token_type_embeddings.weight[0])
        for layer in self.encoder.layer:
            x = layer(x, attn_mask)
        return x


def subsentence_masks(input_ids: np.ndarray, special_ids, cls_id: int, sep_id: int):
    """Grounding-DINO's per-phrase text masking: tokens between
    '.'-separators attend only within their own phrase; special tokens attend
    only to themselves. Returns (self_attn_mask (B, L, L) bool, position_ids
    (B, L) int32), position ids restarting at each phrase."""
    b, l = input_ids.shape
    special = np.isin(input_ids, list(special_ids) + [cls_id, sep_id])
    mask = np.zeros((b, l, l), bool)
    pos = np.zeros((b, l), np.int64)
    idx = np.eye(l, dtype=bool)
    for bi in range(b):
        spots = np.flatnonzero(special[bi])
        mask[bi] |= idx
        prev = 0
        for s in spots:
            if s in (0, l - 1):
                prev = s + 1
                continue
            mask[bi, prev:s + 1, prev:s + 1] = True
            pos[bi, prev:s + 1] = np.arange(0, s + 1 - prev)
            prev = s + 1
    return mask, pos.astype(np.int32)
