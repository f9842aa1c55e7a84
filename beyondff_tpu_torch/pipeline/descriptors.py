"""Query descriptor generation (WaffleCLIP-style prompt ensembling).

Rebuild of the reference generator (reference: tools/descriptor_generator.py):
the free-text query is expanded into N prompt variants whose CLIP text
embeddings are averaged for robust box scoring. Methods: ``toy`` (fixed mock
descriptors), ``waffle`` (random word pairs + random character pairs from
the WaffleCLIP word list, the port's own copy of ``waffle_words.json``),
``gpt`` (descriptors from an LLM, through an injected ``prompt -> text``
callable such as :class:`pipeline.llm_client.ChatCompletionClient`) and
``waffle_and_gpt`` (both). The port's copy of
beyondff_tpu/pipeline/descriptors.py.

Unlike the reference (bare ``np.random`` calls, descriptor_generator.py:66-105)
all randomness flows through an explicit seeded generator so evaluation runs
are reproducible (SURVEY.md §7 hard part 6).
"""

from __future__ import annotations

import functools
import json
import os
import string
from typing import Callable, Dict, List, Optional

import numpy as np

METHODS = ("toy", "waffle", "gpt", "waffle_and_gpt")

_CHARSET = list(string.ascii_letters + string.digits + string.punctuation)


@functools.lru_cache(maxsize=None)
def _default_word_list() -> tuple:
    path = os.path.join(os.path.dirname(__file__), "waffle_words.json")
    with open(path) as f:
        return tuple(json.load(f))


def wordify(s: str) -> str:
    return s.replace("_", " ")


def make_descriptor_sentence(descriptor: str) -> str:
    """Grammatical glue (reference: descriptor_generator.py:30-38)."""
    if descriptor.startswith(("a", "an")):
        return f"which is {descriptor}"
    if descriptor.startswith(("has", "often", "typically", "may", "can")):
        return f"which {descriptor}"
    if descriptor.startswith("used"):
        return f"which is {descriptor}"
    return f"which has {descriptor}"


def build_prompt(descriptor: str, cls: str) -> str:
    return f"A photo of a {wordify(cls)}, {make_descriptor_sentence(descriptor)}."


def toy_descriptors(query: str) -> Dict[str, List[str]]:
    descriptors = [
        "aks@, pg2f", "foot loud", "w6y#, d4e^", "r1q$, m3b@", "r1q$, m3b@",
        "q4g/, h9m~", "s2t=, i1p-", " g8c, a3v+", " o9n_, f0h?", "k2x%, u5j&",
        "m3b@, l7z!",
    ]
    return {query: [build_prompt(d, query) for d in descriptors]}


def waffle_descriptors(
    query: str,
    seed: int = 0,
    num_pairs: int = 15,
    num_words: int = 2,
    word_length: int = 5,
    word_list: Optional[List[str]] = None,
) -> Dict[str, List[str]]:
    """Pairs of (random real words, random char strings)
    (reference: descriptor_generator.py:66-105)."""
    rng = np.random.default_rng(seed)
    words = [w[:word_length] for w in (word_list or _default_word_list())]
    descriptors = []
    for _ in range(num_pairs):
        descriptors.append(" ".join(rng.choice(words) for _ in range(num_words)))
        descriptors.append(
            " ".join("".join(rng.choice(_CHARSET, word_length)) for _ in range(num_words))
        )
    return {query: [build_prompt(d, query) for d in descriptors]}


def gpt_descriptors(query: str, llm: Optional[Callable[[str], str]] = None) -> Dict[str, List[str]]:
    """Visual descriptors from an LLM. ``llm`` maps prompt -> completion text;
    this build takes it as an injectable instead of a hard OpenAI dependency
    (reference: descriptor_generator.py:107-130)."""
    if llm is None:
        raise ValueError("gpt descriptor method needs an `llm` callable (prompt -> text)")
    prompt = (
        f"Q: What are useful visual features for distinguishing a {query} in a photo?\n"
        f"A: There are several useful visual features to tell there is a {query} in a photo:\n-"
    )
    text = llm(prompt)
    descriptors = [d[2:] for d in text.split("\n") if d.startswith("- ")]
    return {query: [build_prompt(d, query) for d in descriptors]}


def generate(query: str, method: str = "waffle", seed: int = 0,
             llm: Optional[Callable[[str], str]] = None) -> Dict[str, List[str]]:
    if method == "toy":
        return toy_descriptors(query)
    if method == "waffle":
        return waffle_descriptors(query, seed=seed)
    if method == "gpt":
        return gpt_descriptors(query, llm)
    if method == "waffle_and_gpt":
        out = gpt_descriptors(query, llm)
        out[query] = out[query] + waffle_descriptors(query, seed=seed)[query]
        return out
    raise ValueError(f"unknown descriptor method {method!r}; choose from {METHODS}")
