"""Text tokenizers: CLIP byte-pair encoding, BERT WordPiece and a hash stand-in.

The port's copy of beyondff_tpu/models/tokenizers.py. ``ClipTokenizer`` and
``BertTokenizer`` read the vocabulary files that ship with the upstream
checkpoints (``bpe_simple_vocab_16e6.txt.gz`` for CLIP, ``vocab.txt`` for
BERT) and use the standard library only (no ``regex`` or ``ftfy``).
:class:`HashTokenizer` maps words to md5-derived ids in the CLIP text
tower's ``[0, vocab)`` space, the same ids as the JAX package's, so model
shapes are exercised without vocabulary assets.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
from typing import Iterable, List, Sequence

import numpy as np


# ----------------------------------------------------------------- CLIP BPE
@functools.lru_cache()
def _bytes_to_unicode():
    """Reversible byte -> printable unicode map (standard GPT-2/CLIP table)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """CLIP's lower-cased BPE tokenizer over a 49152-merge vocabulary."""

    # python-re equivalent of CLIP's \p{L}/\p{N} pattern: words ([^\W\d_]+),
    # single digits, and runs of other non-space symbols (incl. underscore)
    PATTERN = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
        re.IGNORECASE | re.UNICODE,
    )

    def __init__(self, bpe_path: str, context_length: int = 77):
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m.strip()]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._bpe_cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: List[int] = []
        for token in re.findall(self.PATTERN, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str], truncate: bool = True) -> np.ndarray:
        """(B, context_length) int32 token array, CLIP layout [SOT, ..., EOT, 0...]."""
        out = np.zeros((len(texts), self.context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > self.context_length:
                if not truncate:
                    raise ValueError(f"text too long for context {self.context_length}: {text!r}")
                ids = ids[: self.context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out


# ------------------------------------------------------------ BERT WordPiece
def _is_cjk(cp: int) -> bool:
    """CJK unified ideograph ranges (the official BasicTokenizer table)."""
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _is_bert_punctuation(ch: str) -> bool:
    """The official ``_is_punctuation``: the four ASCII symbol ranges (which
    include '_', '$', '`'...) plus every unicode P* category."""
    import unicodedata

    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


class BertTokenizer:
    """Lower-cased WordPiece over a standard BERT ``vocab.txt``.

    Implements the official basic-tokenize algorithm (HF BertTokenizer /
    the original BERT repo, which the reference's groundingdino text stack
    runs): control-char cleanup, CJK spacing, NFD accent stripping under
    lowercasing, punctuation splitting with the ASCII-range + P* definition
    (so '_' splits), and the 100-char word cap that maps huge tokens to
    [UNK] wholesale. Held against transformers' tokenizer and the JAX
    package's in tests/test_torch_checkpoints.py."""

    MAX_WORD_CHARS = 100

    def __init__(self, vocab_path: str, max_len: int = 256):
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.max_len = max_len
        self.cls = self.vocab["[CLS]"]
        self.sep = self.vocab["[SEP]"]
        self.unk = self.vocab["[UNK]"]
        self.pad = self.vocab.get("[PAD]", 0)

    @staticmethod
    def _clean(text: str) -> str:
        import unicodedata

        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD:
                continue
            cat = unicodedata.category(ch)
            if cat.startswith("C") and ch not in ("\t", "\n", "\r"):
                continue
            if ch in ("\t", "\n", "\r") or cat == "Zs":
                out.append(" ")
            elif _is_cjk(cp):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        import unicodedata

        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    def _split(self, text: str) -> List[str]:
        text = self._strip_accents(self._clean(text).lower())
        words: List[str] = []
        for tok in text.split():
            cur = ""
            for ch in tok:
                if _is_bert_punctuation(ch):
                    if cur:
                        words.append(cur)
                        cur = ""
                    words.append(ch)
                else:
                    cur += ch
            if cur:
                words.append(cur)
        return words

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.MAX_WORD_CHARS:
            return [self.unk]
        if word in self.vocab:
            return [self.vocab[word]]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            ids.append(cur)
            start = end
        return ids

    SPECIAL = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

    def encode(self, text: str) -> List[int]:
        """Special-token literals in the text map directly to their ids
        (HF never-split behavior); everything else basic-tokenizes."""
        ids: List[int] = []
        pattern = "(" + "|".join(re.escape(s) for s in self.SPECIAL) + ")"
        for part in re.split(pattern, text):
            if part in self.SPECIAL:
                ids.append(self.vocab[part])
                continue
            for word in self._split(part):
                ids.extend(self._wordpiece(word))
        return ids

    def __call__(self, texts: Sequence[str]) -> dict:
        rows = [[self.cls] + self.encode(t)[: self.max_len - 2] + [self.sep] for t in texts]
        width = max(len(r) for r in rows)
        input_ids = np.full((len(rows), width), self.pad, np.int32)
        attn = np.zeros((len(rows), width), bool)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            attn[i, : len(r)] = True
        return {"input_ids": input_ids, "attention_mask": attn}

    def decode_token(self, idx: int) -> str:
        return self.inv_vocab.get(int(idx), "[UNK]")


# ----------------------------------------------------------------- test stub
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
