"""Query <-> label text similarity providers for refinement.

The reference scores CLIP text-text cosine similarity between the free-text
query and each matched stage-1 label (reference: tools/refinement.py:93-115,
297-302). Providers here implement that contract:

  * :class:`ClipTextSimilarity` — the port's CLIP text tower (on its device);
    encodes each unique string once and caches it, instead of re-encoding the
    query for every pair like the reference.
  * :class:`ExactMatchSimilarity` — deterministic fallback when no CLIP
    checkpoint is configured: 1.0 iff the normalized strings match, else 0.0.
    With the default ``sim_percentile`` this reproduces the reference's
    keep/drop decisions whenever the matched label *is* the query class, which
    is the dominant case; it exists so the pipeline runs without model weights.
"""

from __future__ import annotations

from typing import Dict, Protocol

from beyondff_tpu_torch.config import Config


class TextSimilarity(Protocol):
    def __call__(self, text_a: str, text_b: str) -> float: ...


class ExactMatchSimilarity:
    def __call__(self, text_a: str, text_b: str) -> float:
        norm = lambda s: s.replace("_", " ").strip().lower()
        return 1.0 if norm(text_a) == norm(text_b) else 0.0


class ClipTextSimilarity:
    """Cosine similarity of CLIP text embeddings, with per-string caching."""

    def __init__(self, clip_model, tokenizer):
        self.model = clip_model
        self.tokenizer = tokenizer
        self._cache: Dict[str, object] = {}

    def _encode(self, text: str):
        if text not in self._cache:
            import numpy as np

            tokens = self.tokenizer([text])
            feat = self.model.encode_text(tokens)[0].float().cpu().numpy()
            self._cache[text] = feat / np.linalg.norm(feat)
        return self._cache[text]

    def __call__(self, text_a: str, text_b: str) -> float:
        import numpy as np

        return float(np.dot(self._encode(text_a), self._encode(text_b)))


def build_text_similarity(cfg: Config, device=None) -> TextSimilarity:
    """CLIP over ``detector.clip_checkpoint`` (float32, on ``device``:
    ``cuda`` unless named) when one is configured, exact match otherwise
    (the JAX package's ``build_text_similarity``)."""
    if cfg.detector.clip_checkpoint:
        from beyondff_tpu_torch.models import clip as clip_mod

        model, tokenizer = clip_mod.load(
            cfg.detector.clip_model_size,
            cfg.detector.clip_checkpoint,
            bpe_path=cfg.detector.clip_bpe_path or None,
            device=device,
        )
        return ClipTextSimilarity(model, tokenizer)
    return ExactMatchSimilarity()
