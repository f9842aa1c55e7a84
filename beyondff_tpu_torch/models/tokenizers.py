"""Deterministic hash tokenizer for weightless runs and tests.

The port's copy of ``HashTokenizer`` from beyondff_tpu/models/tokenizers.py:
words map to md5-derived ids in the CLIP text tower's ``[0, vocab)`` space,
the same ids as the JAX package's, so model shapes are exercised without
vocabulary assets. The BPE and WordPiece tokenizers come with checkpoint
loading (ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np


class HashTokenizer:
    """Deterministic word -> id hashing: texts in, (N, context_length) int32
    ids out, start and end tokens at ``vocab_size - 2`` and ``- 1``."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def encode(self, text: str) -> List[int]:
        import hashlib

        ids = []
        for w in text.lower().split():
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            ids.append(h % (self.vocab_size - 2))
        return ids

    def __call__(self, texts: Iterable[str], truncate: bool = True) -> np.ndarray:
        texts = list(texts)
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t)[: self.context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out
